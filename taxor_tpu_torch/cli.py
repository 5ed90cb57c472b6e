"""taxor command line on PyTorch: build / search / profile with the
reference's flag names and defaults (src/main/main.cpp:54-77).

    python -m taxor_tpu_torch.cli build ...    # host index build
    python -m taxor_tpu_torch.cli search ...   # --engine device|host
    python -m taxor_tpu_torch.cli profile ...  # CAMI profile

``build`` and ``profile`` run this package's copy of the JAX package's
numpy host layer (apps/build.py, profile/profile.py), so both packages
write the same index and the same text.  ``search`` runs this package's
pipeline on ``--device`` (default cuda; with no CUDA device it fails
instead of running on the CPU).
"""

from __future__ import annotations

import argparse
import resource
import sys
import time


def _add_build(sub):
    p = sub.add_parser("build", help="Creates an HIXF index of a given set "
                                     "of fasta files")
    p.add_argument("--input-file", required=True,
                   help="tab-separated-value file containing taxonomy "
                        "information and reference file names")
    p.add_argument("--input-sequence-dir", default=".",
                   help="directory containing the fasta reference files")
    p.add_argument("--output-filename", default=".",
                   help="A file name for the resulting index.")
    p.add_argument("--kmer-size", type=int, default=20)
    p.add_argument("--syncmer-size", type=int, default=10)
    p.add_argument("--window-size", type=int, default=0,
                   help="window size of minimizer scheme (hidden flag)")
    p.add_argument("--scaling", type=int, default=1,
                   help="factor for scaling down syncmer/minimizer sketches")
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--use-syncmer", action="store_true")
    p.add_argument("--layout", default="auto", choices=["auto", "flat"],
                   help="layout algorithm (auto = hierarchical DP, flat = "
                        "one IXF)")
    p.add_argument("--tmax", type=int, default=4096)
    p.add_argument("--output-verbose-statistics", action="store_true",
                   help="Enable verbose statistics to be printed")
    return p


def _add_search(sub):
    p = sub.add_parser("search", help="Queries files of DNA sequences "
                                      "against a list of HIXF index files")
    p.add_argument("--index-file", required=True)
    p.add_argument("--query-file", required=True)
    p.add_argument("--output-file", required=True)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--percentage", type=float, default=-1.0,
                   help="if set, used instead of the k-mer/syncmer models")
    p.add_argument("--error-rate", type=float, default=0.04)
    p.add_argument("--engine", default="device", choices=["device", "host"])
    p.add_argument("--device", default="cuda",
                   help="torch device of the device engine (cuda, cuda:N "
                        "or cpu for the plain twins)")
    p.add_argument("--output-verbose-statistics", action="store_true",
                   help="accepted for parity; unused, as in the "
                        "reference's search path")
    p.add_argument("--write-time", action="store_true")
    return p


def _add_profile(sub):
    p = sub.add_parser("profile", help="Taxonomic profiling of a sample by "
                                       "given read matching results")
    p.add_argument("--search-file", required=True)
    p.add_argument("--cami-report-file", required=True)
    p.add_argument("--seq-abundance-file", default="")
    p.add_argument("--binning-file", required=True)
    p.add_argument("--sample-id", required=True)
    p.add_argument("--min-abundance", type=float, default=0.001)
    p.add_argument("--em-steps", type=int, default=100)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--output-verbose-statistics", action="store_true",
                   help="accepted for parity; unused, as in the "
                        "reference's profile path")
    return p


def _run(args) -> None:
    if args.command == "build":
        from .apps.build import BuildConfig, run_build

        run_build(BuildConfig(
            input_file=args.input_file,
            input_sequence_dir=args.input_sequence_dir,
            output_filename=args.output_filename,
            kmer_size=args.kmer_size,
            syncmer_size=args.syncmer_size,
            window_size=args.window_size,
            scaling=args.scaling,
            threads=args.threads,
            use_syncmer=args.use_syncmer,
            layout_mode=args.layout,
            tmax=args.tmax,
            verbose_stats=args.output_verbose_statistics,
        ))
    elif args.command == "search":
        from .search.pipeline import SearchConfig, run_search

        run_search(SearchConfig(
            index_file=args.index_file,
            query_file=args.query_file,
            report_file=args.output_file,
            threads=args.threads,
            percentage=args.percentage,
            error_rate=args.error_rate,
            engine=args.engine,
            write_time=args.write_time,
        ), device=args.device)
    elif args.command == "profile":
        from .profile.profile import ProfileConfig, run_profile

        run_profile(ProfileConfig(
            search_file=args.search_file,
            report_file=args.cami_report_file,
            sequence_abundance_file=args.seq_abundance_file,
            binning_file=args.binning_file,
            sample_id=args.sample_id,
            threshold=args.min_abundance,
            em_steps=args.em_steps,
            threads=args.threads,
        ))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="taxor",
        description="Taxonomic classification of long reads (PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_build(sub)
    _add_search(sub)
    _add_profile(sub)
    args = parser.parse_args(argv)

    t0 = time.process_time()
    try:
        _run(args)
    except Exception as e:  # [TAXOR * ERROR] style, then fail fast
        print(f"[TAXOR {args.command.upper()} ERROR] {e}", file=sys.stderr)
        return 1
    # CPU time + peak RSS, like main.cpp:79-84
    cpu = time.process_time() - t0
    peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    print(f"CPU time : {cpu:.2f} seconds")
    print(f"Peak RSS : {peak_mb:.1f} MByte")
    return 0


if __name__ == "__main__":
    sys.exit(main())
