"""Layout invariance: the same references under different layouts, the
classification rows diffed read by read.

    python -m taxor_tpu_torch.tools.layout_invariance [n_species n_reads]
        [--device cuda|cpu]

The port of the JAX package's tools/layout_invariance.py (the evidence
for DIVERGENCES.md #6: the layout DP reimplements the published HIBF
algorithm, so layouts differ from the reference's, and a layout can
change classification only through filter false-positive noise and the
merged bins' descent thresholds).  It builds one synthetic reference set
(``tools/synth``: species of 3 kb, k = 16, s = 8 syncmers) as flat,
``--layout auto`` at t_max 64, 128 and 4,096, and ``device_model``
(``--layout auto --layout-cost device``, the H100 model of
``hixf/device_cost.py``, t_max 4,096), searches the reads with the port's
device engine (``search_single`` on ``--device``), and prints per layout
its IXFs and the reads whose rows, and whose top accession, equal the
flat layout's.  The device engine's TSV equals the host oracle's byte for
byte, so its rows are the JAX tool's (the host oracle's membership under
the 0.8 x max rule).
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import tempfile

import numpy as np

# (name, --layout, --tmax, --layout-cost) of the layouts compared
LAYOUTS = (("flat", "flat", 0, "cpu"), ("auto_t64", "auto", 64, "cpu"),
           ("auto_t128", "auto", 128, "cpu"),
           ("auto_t4096", "auto", 4096, "cpu"),
           ("device_model", "auto", 4096, "device"))


def classify_rows(index, reads_file: str, device: str = "cuda") -> dict:
    """read id -> frozenset of its (accession, count) rows: the port's
    search_single with the device engine on ``device`` (a no-hit read
    maps to the empty set)."""
    import torch

    from ..device.hixf_search import DeviceHIXF
    from ..search.pipeline import SearchConfig, search_single

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    out = io.StringIO()
    search_single(index, reads_file, out, SearchConfig(engine="device"),
                  DeviceHIXF.from_hixf(index.hixf, dev))
    rows: dict = {}
    for line in out.getvalue().splitlines():
        if line.startswith("#"):
            continue
        f = line.split("\t")
        got = rows.setdefault(f[0], set())
        if f[1] != "-":
            got.add((f[1], int(f[7])))
    return {r: frozenset(v) for r, v in rows.items()}


def flip_stats(a: dict, b: dict) -> tuple[int, int, int]:
    """(reads with identical rows, reads with the same top accession,
    reads) of b against a."""
    same = sum(a[r] == b[r] for r in a)
    top_same = 0
    for r in a:
        x = max(a[r], key=lambda t: t[1], default=None)
        y = max(b[r], key=lambda t: t[1], default=None)
        top_same += (x is None and y is None) or (
            x is not None and y is not None and x[0] == y[0])
    return same, top_same, len(a)


def make_problem(tmp: str, n_species: int, n_reads: int):
    """(taxonomy tsv, genome dir, reads fasta) of the JAX tool's recipe
    (seed 123, genomes of 3 kb, reads of 800 b at 3% substitutions)."""
    from . import synth

    rng = np.random.default_rng(123)
    tsv, gdir, genomes = synth.make_ref_set(tmp, rng, n_species=n_species,
                                            genome_len=3000)
    reads = synth.make_reads(tmp, rng, genomes,
                             n_reads_per_genome=max(1, n_reads // n_species),
                             read_len=800, error_rate=0.03)
    return tsv, gdir, reads


def run(n_species: int = 100, n_reads: int = 400, device: str = "cuda",
        tmp: str | None = None) -> dict:
    """{layout name: (rows, IXFs)} of every layout of LAYOUTS."""
    from ..apps.build import BuildConfig, run_build

    tmp = tmp or tempfile.mkdtemp(prefix="layout_inv_")
    tsv, gdir, reads = make_problem(tmp, n_species, n_reads)
    results = {}
    for name, mode, tmax, cost in LAYOUTS:
        index = run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir, output_filename="",
            kmer_size=16, syncmer_size=8, use_syncmer=True,
            layout_mode=mode, tmax=tmax, layout_cost=cost,
            layout_file=os.path.join(tmp, f"{name}.out")))
        results[name] = (classify_rows(index, reads, device),
                         len(index.hixf.ixfs))
    return results


def table(results: dict) -> str:
    """The printed comparison against the first layout."""
    base_name = next(iter(results))
    base, _ = results[base_name]
    lines = [f"{'layout':<14}{'IXFs':>5}  identical-rows  identical-argmax"
             f"  (vs {base_name})"]
    for name, (rows, n_ixfs) in results.items():
        same, top, n = flip_stats(base, rows)
        lines.append(f"{name:<14}{n_ixfs:>5}  {same}/{n}"
                     f"{'':<10}{top}/{n}")
        if name != base_name:
            lines += [f"  diff {r}: {sorted(base[r])} vs {sorted(rows[r])}"
                      for r in sorted(base) if rows[r] != base[r]]
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sizes", nargs="*", type=int,
                    help="n_species n_reads (default 100 400)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the search (cuda, cuda:N, cpu)")
    args = ap.parse_args(argv)
    print(table(run(*args.sizes, device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
