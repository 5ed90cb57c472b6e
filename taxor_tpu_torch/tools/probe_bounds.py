"""Bounds of the probe's per-hash work on one CUDA GPU: variants of the
probe/count that leave part of it out, timed beside K2 itself.

    python -m taxor_tpu_torch.tools.probe_bounds [--device cuda]

The port of the JAX package's bench_probe_bounds.py, at its sizes: R =
8,192 reads of H = 512 hash slots with nvalid = 173 valid, U = 8 hashes
an unrolled body (so 176 hashes a read are probed), a random table of
S1 = 2,419 slots x 512 bins whose last slot is 0, random p16 positions
below S1 - 1 and fingerprints.  The variants (device/diag.probe_bounds,
csrc/diag/probe_bounds.cu): p16 (the real count), load1, nosmem, lcg,
smem1; all but p16 count wrong on purpose.  Beside them K2
(device/probe.k2_counts) probes random hashes with the same count per
read against the same table, so each variant reads as a share of the
production kernel's time.  Times are tools/timing.rolled_ms; ns/hash
divides by R x nvalid, as the JAX tool did.  Before timing, every
variant is held bit-exact against its plain twin on the first 64 reads.
Each row names the route its timed calls took (``took``: the launches
by route, from probe_bounds.ROUTES and K2's VARIANTS; none on the CPU).
At this geometry the variants and K2 both take their slab routes (slabs
of 64 bins), so each share compares K2's slab route with the same
schedule less part of its work.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..device import diag, probe
from .bench import log
from .timing import rolled_ms

R_TOOL, H_TOOL, NVALID, S1_TOOL, B_TOOL = 8192, 512, 173, 2419, 512
U, RT = 8, 16


def tool_table(rng, S1: int = S1_TOOL, B: int = B_TOOL) -> np.ndarray:
    """uint8 [S1, B]: the JAX tool's random int32 [S1, B/4] table (4 bins
    a word, little-endian) with its last slot zeroed, as bytes."""
    fp = rng.integers(-2**31, 2**31, (S1, B // 4)).astype(np.int32)
    fp[-1] = 0
    return fp.view(np.uint8).reshape(S1, B)


def p16_words(pos: np.ndarray, f: np.ndarray) -> np.ndarray:
    """int32 [R, 2H] p16 words of positions [R, H, 3] and fingerprints
    [R, H]: p0 | p1 << 16, then p2 | f << 16."""
    R, H, _ = pos.shape
    w = np.empty((R, H, 2), dtype=np.int64)
    w[..., 0] = pos[..., 0] | (pos[..., 1] << 16)
    w[..., 1] = pos[..., 2] | (f << 16)
    return w.reshape(R, 2 * H).astype(np.uint32).view(np.int32)


def make_inputs(rng, R: int, H: int, S1: int) -> np.ndarray:
    """p16 words int32 [R, 2H] of random positions below S1 - 1 and random
    fingerprints, drawn in the JAX tool's order."""
    pos = rng.integers(0, S1 - 1, (R, H, 3)).astype(np.int64)
    f = rng.integers(0, 256, (R, H)).astype(np.int64)
    return p16_words(pos, f)


def n_probed(nvalid: int, u: int = U) -> int:
    """Hashes a read probes: whole unrolled bodies of u hashes."""
    return -(-nvalid // u) * u


def check(table, words, n_hash, modes=diag.PROBE_BOUNDS_MODES) -> None:
    """Each mode's kernel equals its twin (raises AssertionError)."""
    for mode in modes:
        got = diag.probe_bounds(table, words, n_hash, mode, U, RT)
        want = diag.probe_bounds_plain(table, words, n_hash, mode, U, RT)
        if not torch.equal(got, want):
            raise AssertionError(f"probe_bounds {mode}: kernel differs from "
                                 "its twin")


def took(counter: dict, fn) -> tuple:
    """(fn(), {route: launches that fn added to counter})."""
    before = dict(counter)
    ms = fn()
    return ms, {k: v - before.get(k, 0) for k, v in counter.items()
                if v != before.get(k, 0)}


def run(device="cuda", R: int = R_TOOL, H: int = H_TOOL,
        nvalid: int = NVALID, seed: int = 0) -> dict:
    """{label: {"ms", "ns_per_hash", "share_of_k2"}} of the variants and
    of K2 at the JAX tool's geometry."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    table_np = tool_table(rng)
    words_np = make_inputs(rng, R, H, table_np.shape[0])
    table = torch.from_numpy(table_np).to(dev)
    words = torch.from_numpy(words_np).to(dev)
    n = n_probed(nvalid)
    n_hash = torch.full((R,), n, dtype=torch.int32, device=dev)
    check(table, words[:64], n_hash[:64])
    log(f"probe_bounds: R={R} H={H} nvalid={nvalid} ({n} probed a read), "
        f"table {tuple(table.shape)} on {dev}; every variant == its twin")
    out = {}
    # K2 on random hashes, the same count per read, the same table
    keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
    hi = torch.from_numpy((keys >> np.uint64(32)).astype(np.uint32)
                          .view(np.int32)).to(dev)
    lo = torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                          .view(np.int32)).to(dev)
    valid = torch.zeros((R, H), dtype=torch.bool, device=dev)
    valid[:, :n] = True
    bl, seed_k2 = (table.shape[0] - 1) // 3, int(rng.integers(0, 2**63))
    tables = table[None]
    k2 = (probe.k2_counts if dev.type == "cuda"
          else probe.probe_counts_grouped_plain)
    ms, routes = took(probe.k2_counts.VARIANTS, lambda: rolled_ms(
        lambda h: k2(h, lo, valid, tables, None, seed_k2, bl), hi))
    out["K2"] = {"ms": ms, "took": routes}
    for mode in diag.PROBE_BOUNDS_MODES:
        ms, routes = took(diag.probe_bounds.ROUTES, lambda m=mode: rolled_ms(
            lambda w: diag.probe_bounds(table, w, n_hash, m, U, RT), words))
        out[mode] = {"ms": ms, "took": routes}
    for label, row in out.items():
        row["ns_per_hash"] = row["ms"] * 1e6 / (R * nvalid)
        row["share_of_k2"] = row["ms"] / out["K2"]["ms"]
        log(f"{label:8s} U={U} RT={RT}  {row['ms']:9.4f} ms "
            f"({row['ns_per_hash']:7.4f} ns/hash, "
            f"{100 * row['share_of_k2']:6.1f}% of K2; routes "
            f"{row['took'] or 'plain'})")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N, or cpu for the "
                         "plain twins)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    print(json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
