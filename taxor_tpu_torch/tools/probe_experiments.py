"""Probe experiments on one CUDA GPU: position layouts, interleaved reads,
extra ALU work under the probe, and a loop of position-word loads.

    python -m taxor_tpu_torch.tools.probe_experiments [--device cuda]
        [--list default|r1|r2]

The port of the JAX package's bench_probe_r4.py, at its sizes: R = 8,192
reads of H = 512 slots with nvalid = 173 valid, a random table of S1 =
2,419 slots (3 blocks of BL = 806 and a zero last slot) x 512 bins,
block-structured positions (p_i in block i) and random fingerprints, in
two layouts: p16 (two words a hash) and p10 (H/4 fingerprint words, then
one word o0 | o1 << 10 | o2 << 20 a hash).  p10 and p16 counts are held
equal before timing, and every experiment's kernel equals its plain twin
on the first 64 reads.  The questions, as the JAX tool put them:

  p10 vs p16   does reading 1.25 instead of 2 position words a hash pay?
  xN           do N reads interleaved per thread (N independent chains
               of loads) shorten the per-hash time?
  vpuxN        is there ALU slack under the probe: N*U/4 rounds of two
               dependent chains per hash (device/diag.probe_experiment)?
               If the time does not move, extraction could hide inside a
               fused extract+probe kernel.
  smemflood K  the cost of K position-word loads a hash alone, no gathers

The experiment lists are the JAX tool's runs under the same names: r1
(its --r1), r2 (its --r2) and default.  A label keeps the JAX mode name,
U (hashes an unrolled body, which sets the hashes probed a read) and RT
(its read tile, which has no meaning in the CUDA kernel and is kept for
the record).  vpuxN is N rounds-per-4-hashes of ALU work on the p16
layout with one read a thread: in the JAX tool the mode name's "xN" also
interleaved N reads.  ns/hash divides by R x nvalid (x K for smemflood:
ns per load), as the JAX tool did.  Each row names the route its timed
calls took (``took``, from probe_experiment.ROUTES: the slab route at
this geometry, "flood" for smemflood; none on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..device import diag
from .bench import log
from .probe_bounds import H_TOOL, NVALID, R_TOOL, S1_TOOL, tool_table
from .probe_bounds import p16_words, took
from .timing import rolled_ms

BL_TOOL = 806
# (JAX mode, U, RT, layout, nops) of bench_probe_r4.py's runs
LISTS = {
    "r1": [("p16", 8, 16, "p16", 0), ("p10", 8, 16, "p10", 0),
           ("p10", 8, 32, "p10", 0), ("x2", 8, 16, "p16", 0),
           ("vpux2", 8, 16, "p16", 2), ("vpux4", 8, 16, "p16", 4),
           ("vpux8", 8, 16, "p16", 8), ("smemflood", 2, 16, "p16", 0),
           ("smemflood", 4, 16, "p16", 0), ("smemflood", 8, 16, "p16", 0)],
    "r2": [("p10", 16, 16, "p10", 0), ("p10x2", 8, 16, "p10", 0),
           ("p10", 8, 16, "p10", 2)],
    "default": [("p10x2", 8, 16, "p10", 0), ("p10x4", 8, 16, "p10", 0),
                ("p10x2", 16, 16, "p10", 0), ("p10x2", 8, 16, "p10", 2),
                ("p10x2", 8, 16, "p10", 4), ("p16x2", 8, 16, "p16", 0)],
}


# the runs that chip_smoke.py and the GPU tests hold against the twin:
# both layouts at 1, 2 and 4 reads a thread, ALU rounds, rounds with
# interleaved reads, the word flood
CHECK_RUNS = (
    [dict(layout=lay, nr=nr) for lay in ("p16", "p10") for nr in (1, 2, 4)]
    + [dict(layout="p16", rounds=r) for r in (4, 8, 16)]
    + [dict(layout="p10", nr=2, rounds=4)]
    + [dict(flood_k=k) for k in (2, 4, 8)])


def experiment(mode: str, U: int, layout: str, nops: int,
               nvalid: int) -> dict:
    """The probe_experiment arguments of one JAX run, and its hashes a
    read: whole bodies of U / nr hashes (nvalid for smemflood)."""
    if mode == "smemflood":
        return dict(layout=layout, nr=1, rounds=0, flood_k=U, n=nvalid)
    nr = 1
    if not mode.startswith("vpu") and "x" in mode:
        nr = int(mode.rsplit("x", 1)[1])
    hb = U // nr
    return dict(layout=layout, nr=nr, rounds=nops * U // 4, flood_k=0,
                n=-(-nvalid // hb) * hb)


def make_inputs(rng, R: int, H: int, S1: int, bl: int):
    """(p16 words [R, 2H], p10 words [R, H + H/4]) of block-structured
    positions p_i = i*bl + o_i, o_i < min(bl, 1024), and random
    fingerprints."""
    off = rng.integers(0, min(bl, 1024), (R, H, 3)).astype(np.int64)
    pos = off + np.array([0, bl, 2 * bl], dtype=np.int64)
    f = rng.integers(0, 256, (R, H)).astype(np.int64)
    p10 = off[..., 0] | (off[..., 1] << 10) | (off[..., 2] << 20)
    fword = (f.reshape(R, H // 4, 4)
             << (8 * np.arange(4, dtype=np.int64))).sum(axis=2)
    w10 = np.concatenate([fword, p10], axis=1).astype(np.uint32)
    return p16_words(pos, f), w10.view(np.int32)


def zero_hit_inputs(rng, S1: int, B: int, bl: int, R: int, H: int):
    """(table uint8 [S1, B], p16 words [R, 2H], p10 words [R, H + H/4])
    where every hash hits every bin: the tool's table with rows 5,
    bl + 5, 2 bl + 5 and its last zero, p16 positions all at the last
    slot, p10 offsets all 5, fingerprints 0.  A read's count is then its
    number of hashes in every bin."""
    table = tool_table(rng, S1, B)
    table[[5, bl + 5, 2 * bl + 5]] = 0
    w16 = p16_words(np.full((R, H, 3), S1 - 1, dtype=np.int64),
                    np.zeros((R, H), dtype=np.int64))
    w10 = np.zeros((R, H + H // 4), dtype=np.int32)
    w10[:, H // 4:] = 5 | (5 << 10) | (5 << 20)
    return table, w16, w10


def run_one(table, words, n_hash, bl, spec):
    return diag.probe_experiment(table, words, n_hash, spec["layout"],
                                 spec["nr"], spec["rounds"],
                                 spec["flood_k"], bl)


def check(table, words, n_hash, bl, spec) -> None:
    """The experiment's kernel equals its twin (raises AssertionError)."""
    got = run_one(table, words, n_hash, bl, spec)
    want = diag.probe_experiment_plain(table, words, n_hash, spec["layout"],
                                       spec["nr"], spec["rounds"],
                                       spec["flood_k"], bl)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"probe_experiment {spec}: kernel differs from "
                             "its twin")


def run(list_name: str = "default", device="cuda", R: int = R_TOOL,
        H: int = H_TOOL, nvalid: int = NVALID, seed: int = 0) -> list[dict]:
    """One row per experiment of LISTS[list_name]: its label and ms."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(tool_table(rng, S1_TOOL)).to(dev)
    w16, w10 = (torch.from_numpy(x).to(dev)
                for x in make_inputs(rng, R, H, S1_TOOL, BL_TOOL))
    words = {"p16": w16, "p10": w10}
    n8 = torch.full((min(R, 64),), -(-nvalid // 8) * 8, dtype=torch.int32,
                    device=dev)
    c16, _ = diag.probe_experiment(table, w16[:64], n8, "p16")
    c10, _ = diag.probe_experiment(table, w10[:64], n8, "p10",
                                   block_length=BL_TOOL)
    if not torch.equal(c16, c10):
        raise AssertionError("p10 counts differ from p16 counts")
    log(f"probe_experiments: R={R} H={H} nvalid={nvalid}, table "
        f"{tuple(table.shape)}, BL={BL_TOOL} on {dev}; p10 == p16 counts")
    rows = []
    for mode, U, RT, layout, nops in LISTS[list_name]:
        spec = experiment(mode, U, layout, nops, nvalid)
        n_hash = torch.full((R,), spec["n"], dtype=torch.int32, device=dev)
        check(table, words[layout][:64], n_hash[:64], BL_TOOL, spec)
        ms, routes = took(diag.probe_experiment.ROUTES, lambda sp=spec,
                          nh=n_hash, w=words[layout]: rolled_ms(
            lambda wr: run_one(table, wr, nh, BL_TOOL, sp), w))
        per = spec["flood_k"] or 1
        ns = ms * 1e6 / (R * nvalid * per)
        unit = "ns/load" if spec["flood_k"] else "ns/hash"
        log(f"{mode:10s} U={U:2d} RT={RT:2d} nops={nops}  {ms:9.4f} ms "
            f"({ns:7.4f} {unit}; nr={spec['nr']} rounds={spec['rounds']} "
            f"n={spec['n']}; routes {routes or 'plain'})")
        rows.append(dict(mode=mode, U=U, RT=RT, nops=nops, ms=ms,
                         **{unit.replace("/", "_per_"): ns}, **spec,
                         took=routes))
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N, or cpu for the "
                         "plain twins)")
    ap.add_argument("--list", default="default", choices=sorted(LISTS),
                    help="experiment list (the JAX tool's --r1, --r2 or "
                         "default runs)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    print(json.dumps(run(args.list, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
