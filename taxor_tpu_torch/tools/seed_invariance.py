"""Seed invariance: the control of the layout experiment.  The same layout
built twice with two XOR-filter seeds, against two different layouts
under one seed, each pair's classification rows diffed read by read.

    python -m taxor_tpu_torch.tools.seed_invariance [n_species n_reads]
        [--device cuda|cpu]

The port of the JAX package's tools/seed_invariance.py (DIVERGENCES.md
#6/#13).  The second build of the t_max 64 layout resumes from its
binning.out, so its bins hold the same hashes, and only the filters'
seed (``ixf/xor_filter.build_ixf``'s ``seed``: ``XOR_SEED0``, then
``XOR_SEED0`` times the golden ratio) changes the false-positive roll.
If the per-read flip rate between the two seeds matches the one between
the hierarchical and the flat layout, a layout changes classification no
more than false-positive noise does.  Reads are classified by
``layout_invariance.classify_rows`` (the port's device engine).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import sys
import tempfile

from .layout_invariance import classify_rows, flip_stats, make_problem


@contextlib.contextmanager
def filter_seed(seed: int):
    """Every IXF the build constructs while open takes ``seed``."""
    from ..hixf import build as hb
    from ..ixf.xor_filter import build_ixf

    hb.build_ixf = functools.partial(build_ixf, seed=seed)
    try:
        yield
    finally:
        hb.build_ixf = build_ixf


def run(n_species: int = 300, n_reads: int = 900, device: str = "cuda",
        tmp: str | None = None) -> list[tuple[str, int, int, int]]:
    """[(comparison, identical rows, identical top accession, reads)] of
    the seed control and the layout comparison; also prints the IXFs."""
    from ..apps.build import BuildConfig, run_build
    from ..ixf.xor_filter import XOR_SEED0

    tmp = tmp or tempfile.mkdtemp(prefix="seed_inv_")
    tsv, gdir, reads = make_problem(tmp, n_species, n_reads)

    def build(layout_file: str, mode: str, tmax: int, seed: int,
              resume: bool):
        with filter_seed(seed):
            return run_build(BuildConfig(
                input_file=tsv, input_sequence_dir=gdir, output_filename="",
                kmer_size=16, syncmer_size=8, use_syncmer=True,
                layout_mode=mode, tmax=tmax,
                layout_file=os.path.join(tmp, layout_file), resume=resume,
                threads=2))

    seed_b = (XOR_SEED0 * 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
    ix_a = build("t64.out", "auto", 64, XOR_SEED0, False)
    ix_b = build("t64.out", "auto", 64, seed_b, True)
    ix_c = build("flat.out", "flat", 0, XOR_SEED0, False)
    rows = [classify_rows(ix, reads, device) for ix in (ix_a, ix_b, ix_c)]
    print(f"index sizes: t64 {len(ix_a.hixf.ixfs)} IXFs, flat "
          f"{len(ix_c.hixf.ixfs)} IXF", flush=True)
    return [("same layout, seed A vs B (pure FP-noise control)",
             *flip_stats(rows[0], rows[1])),
            ("different layout (hier t64 vs flat), same seed",
             *flip_stats(rows[0], rows[2]))]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sizes", nargs="*", type=int,
                    help="n_species n_reads (default 300 900)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the search (cuda, cuda:N, cpu)")
    args = ap.parse_args(argv)
    for label, same, top, n in run(*args.sizes, device=args.device):
        print(f"{label}:\n  identical rows       {same}/{n}  "
              f"({100.0 * same / n:.2f}%)\n  identical top-accession "
              f"{top}/{n}  ({100.0 * top / n:.2f}%)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
