"""K2 alone on random hashes: each route held to the plain twin, then
timed.

    python -m taxor_tpu_torch.tools.bench_probe
        [--preset tool|flat|wide|kmer|tall] [--reads R] [--hashes H]
        [--valid N] [--slots S] [--bins B] [--widths W,...]
        [--device cuda]

The port of the JAX package's bench_probe.py (the probe kernel alone on
synthetic inputs shaped like a search batch).  Presets:

  tool  the JAX tool's geometry: R = 8,192 reads of H = 512 hash slots
        with 190 valid, a table of 2,418 slots (its 2,419 less the
        sentinel row the port does not use) x 512 bins
  flat  chip_smoke's phase 5: R = 512 reads of the L = 8,192 bucket, H =
        2,048 slots with 500 valid (an estimate of that batch's mean,
        whose count phase 5 logs), the flat cell's 3,609 x 4,096 table
  wide  a table shaped like tools.bench's flat_16384: 402 slots x 16,384
        bins, R = 2,048 reads of H = 512 slots with 173 valid
  kmer  chip_smoke's phase 13b: R = 512 reads of H = L = 8,192 slots with
        5,712 valid (2,924,851 over the batch in phase 13d), the plain
        k-mer flat table of 39,621 x 1,024 (a thin slab of 4 bins)
  tall  kmer's batch on a table past the L2: 120,000 slots x 1,024 bins
        (123 MB)

and every size can be set apart.  The first N slots of a read are valid
and hold uniform random keys; the table is uniform random bytes.  Every
variant of K2 that fits the shape (device/probe.k2_counts: the slab route
at the widest slab that fits a block, its "split" variant where a
cluster holds a 16-bin slab, and the rows route) is held bit-exact to
probe_counts_grouped_plain on the whole batch, then timed with
tools/timing.rolled_ms; ``--widths W,...`` adds the slab route at slabs
of W bins (labels "slab W").  One JSON line goes to stdout: nvidia-smi's
name and power limit, the geometry, the valid hashes, the row bytes
(valid hashes x 3 rows x Bpad: what the rows route reads from L2, and
the slab route from shared memory)
and per route its milliseconds and GB/s of row bytes; exit code 1 when a
route differs from the twin.  With ``--device cpu`` it times the twin (a
check of the tool, no device time).

To compare two checkouts, run this file from each in turns (parent,
change, change, parent) in one call to the card:
``PYTHONPATH=<checkout> python <this file> ...``.  It imports the package
by its absolute name, so the same file drives an older checkout, whose K2
has no variants: its one route is recorded as "rows".
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from taxor_tpu_torch.device import probe
from taxor_tpu_torch.tools.bench import card_line, log
from taxor_tpu_torch.tools.timing import rolled_ms

PRESETS = {  # R, H, valid, S, bins
    "tool": (8192, 512, 190, 2418, 512),
    "flat": (512, 2048, 500, 3609, 4096),
    "wide": (2048, 512, 173, 402, 16384),
    "kmer": (512, 8192, 5712, 39621, 1024),
    "tall": (512, 8192, 5712, 120000, 1024),
}


def inputs(rng, R: int, H: int, nvalid: int, S: int, bins: int,
           dev: torch.device):
    """(hi, lo, valid, tables [1, S, Bpad], seed, block_length)."""
    keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    valid = np.zeros((R, H), dtype=bool)
    valid[:, :nvalid] = True
    table = rng.integers(0, 256, (S, probe.pad_bins(bins)), dtype=np.uint8)
    seed = int(rng.integers(0, 2**63))
    return (*(torch.from_numpy(x).to(dev) for x in (hi, lo, valid)),
            torch.from_numpy(table).to(dev)[None], seed, S // 3)


def variants(slab: bool, split: bool = False) -> dict:
    """{label: k2_counts keyword arguments} of the routes to time."""
    if not hasattr(probe.k2_counts, "VARIANTS"):  # before the slab route
        return {"rows": {}}
    fits = {"slab": slab, "split": split}
    return {v: {"variant": v} for v, ok in fits.items() if ok} | {
        "rows": {"variant": "rows"}}


def run(args) -> dict:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    R, H, nvalid, S, bins = (getattr(args, k) or v for k, v in zip(
        ("reads", "hashes", "valid", "slots", "bins"),
        PRESETS[args.preset]))
    hi, lo, valid, tables, seed, bl = inputs(
        np.random.default_rng(args.seed), R, H, nvalid, S, bins, dev)
    Bp = tables.shape[2]
    n = int(valid.sum())
    out = {"device": card_line() if dev.type == "cuda" else "cpu",
           "preset": args.preset, "reads": R, "hashes": H,
           "table": [S, Bp], "valid_hashes": n, "row_bytes": 3 * n * Bp,
           "equal": True, "routes": {}}
    want = probe.probe_counts_grouped_plain(hi, lo, valid, tables, None,
                                            seed, bl)
    if dev.type == "cuda":
        fit = {}
        if hasattr(probe, "split_cluster"):  # since the thin slabs
            out["slab_bins"] = probe.slab_bins(S, Bp, H, dev)
            out["slab_fit"] = fit["slab"] = probe.slab_bins(S, Bp, H, dev,
                                                            fit=True)
            out["split_cluster"] = fit["split"] = probe.split_cluster(
                S, Bp, bl, dev)
        elif hasattr(probe, "slab_bins"):
            out["slab_bins"] = fit["slab"] = probe.slab_bins(S, Bp, dev)
        fns = {label: (lambda h, kw=kw: probe.k2_counts(
            h, lo, valid, tables, None, seed, bl, **kw))
            for label, kw in variants(**fit).items()}
        for W in (int(w) for w in filter(None, args.widths.split(","))):
            if W <= fit.get("slab", 0):  # narrower than the widest fit
                fns[f"slab {W}"] = (lambda h, W=W: probe._launch(
                    h, lo, valid, tables, None, seed, bl, W))
    else:
        fns = {"twin": lambda h: probe.probe_counts_grouped(
            h, lo, valid, tables, None, seed, bl)}
    for label, fn in fns.items():
        equal = torch.equal(fn(hi), want)
        ms = rolled_ms(fn, hi)
        out["routes"][label] = {"ms": ms, "equal": equal,
                                "rows_gbps": 3 * n * Bp / ms / 1e6}
        out["equal"] &= equal
        log(f"bench_probe {args.preset} {label:7s} {ms:9.4f} ms "
            f"({out['routes'][label]['rows_gbps']:9.1f} GB/s of rows; "
            f"== twin: {equal})")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="flat", choices=sorted(PRESETS))
    for name, what in (("reads", "reads R"), ("hashes", "hash slots H a "
                       "read"), ("valid", "valid slots a read"),
                       ("slots", "table slots S (3 x block length)"),
                       ("bins", "table bins")):
        ap.add_argument(f"--{name}", type=int, default=0,
                        help=f"{what} (default: the preset's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--widths", default="",
                    help="W,... the slab route at slabs of W bins (1 to "
                         "128, a power of two, where the slab fits a "
                         "block), timed beside the routes")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N, or cpu for the "
                         "plain twin)")
    out = run(ap.parse_args(argv))
    print(json.dumps(out), flush=True)
    return 0 if out["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
