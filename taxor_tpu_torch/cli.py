"""taxor command line on PyTorch: build / search / profile with the
reference's flag names and defaults (src/main/main.cpp:54-77).

    python -m taxor_tpu_torch.cli build ...    # host index build
    python -m taxor_tpu_torch.cli search ...   # --engine device|host
    python -m taxor_tpu_torch.cli profile ...  # CAMI profile
    python -m taxor_tpu_torch.cli prewarm ...  # build kernels, warm up

``build`` and ``profile`` run this package's copy of the JAX package's
numpy host layer (apps/build.py, profile/profile.py), so both packages
write the same index and the same text.  ``search`` and ``prewarm`` run
on ``--device`` (default cuda; with no CUDA device they fail instead of
running on the CPU).
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
    p.add_argument("--layout-cost", default="cpu",
                   choices=["cpu", "device"],
                   help="layout scoring model: cpu = reference-style "
                        "expected query cost; device = the JAX package's "
                        "TPU probe-pass model (hixf/binning.py), which may "
                        "choose a flat layout")
    p.add_argument("--tmax", type=int, default=4096)
    p.add_argument("--spill-dir", default="",
                   help="spill per-genome hash sets to this directory to "
                        "bound peak RAM (GTDB-scale builds)")
    p.add_argument("--output-verbose-statistics", action="store_true",
                   help="Enable verbose statistics to be printed")
    p.add_argument("--count-output-prefix", default="chopper",
                   help="prefix for the counting-stage artifacts "
                        "(<prefix>.count + <prefix>_sketches/); '' "
                        "disables them")
    p.add_argument("--resume", action="store_true",
                   help="reuse an existing layout file (binning.out) "
                        "instead of recounting and re-running the layout "
                        "DP")
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
    p.add_argument("--engine", default="device",
                   choices=["device", "host", "sharded"])
    p.add_argument("--mesh-reads", type=int, default=0,
                   help="reads-axis size of the sharded engine's mesh "
                        "(0 = the ranks left over by --mesh-bins)")
    p.add_argument("--mesh-bins", type=int, default=0,
                   help="bins-axis size of the sharded engine's mesh "
                        "(0 = one shard per rank)")
    p.add_argument("--distributed", action="store_true",
                   help="join a world of ranks (torch.distributed) before "
                        "searching, one process a device; every rank runs "
                        "the same command")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of rank 0 (defaults to the env:// "
                        "variables that torchrun sets)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the device engines (cuda, cuda:N "
                        "or cpu for the plain twins; with --distributed "
                        "each rank takes cuda:(rank %% device count))")
    p.add_argument("--output-verbose-statistics", action="store_true",
                   help="accepted for parity; unused, as in the "
                        "reference's search path")
    p.add_argument("--write-time", action="store_true")
    p.add_argument("--profile-trace", default="",
                   help="write a torch.profiler Chrome trace of the compute "
                        "phase to this directory")
    return p


def _add_prewarm(sub):
    p = sub.add_parser(
        "prewarm",
        help="Build and load the CUDA kernels, upload an index and drive "
             "one small batch per (length bucket, top-k rung) through the "
             "fused step, so that a later search in this process starts "
             "warm (framework extension, no reference equivalent)")
    p.add_argument("--index-file", required=True)
    p.add_argument("--lengths", default="1024,2048,4096",
                   help="comma-separated read-length buckets to drive")
    p.add_argument("--topk", default="",
                   help="comma-separated top-k rungs (default: the index's "
                        "suggested rung and the escalation ladder's start)")
    p.add_argument("--percentage", type=float, default=-1.0,
                   help="threshold mode of the later search (the "
                        "hierarchical descent depends on it)")
    p.add_argument("--error-rate", type=float, default=0.04)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu)")
    return p


def run_prewarm(index_file: str, lengths: str, topk: str,
                percentage: float = -1.0, error_rate: float = 0.04,
                device: str = "cuda") -> None:
    """Drive one 16-read batch through the fused step for every (length
    bucket, top-k) pair and print each one's milliseconds.  There is no
    compile cache to fill (the kernels are built once per source hash
    into _build/): what this warms is the nvcc build, the module load, the
    index upload and the CUDA caching allocator."""
    import numpy as np
    import torch

    from .device.hixf_search import DeviceHIXF
    from .hash import device_syncmer as dsync
    from .hixf.index import load_index
    from .search.thresholds import Thresholder

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(use --device cpu to run the plain twins)")
        from .device import cuda_build

        t0 = time.perf_counter()
        cuda_build.lib()
        print(f"prewarm: kernels built and loaded in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    index = load_index(index_file)
    scheme = index.scheme
    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   error_rate, percentage,
                                   scheme.use_syncmer)
    t0 = time.perf_counter()
    dhixf = DeviceHIXF.from_hixf(index.hixf, dev)
    print(f"prewarm: index uploaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # as search does: the thresholder's kind picks the hierarchy's descent
    # mode (the count table, or descend-all for length-dependent models)
    if not dhixf.e2e_capable(thresholder, scheme):
        print("prewarm: the index's scheme takes no fused step; nothing "
              "more to warm")
        return
    ks = ([int(x) for x in topk.split(",") if x]
          or sorted({16, int(getattr(index, "suggested_topk", 16))}))
    for L in (int(x) for x in lengths.split(",") if x):
        Lb = dsync.pad_len_bucket(L)
        packed, lens = dsync.pack_reads([b"ACGT" * (Lb // 4)] * 16, Lb)
        for kk in ks:
            t0 = time.perf_counter()
            dhixf.e2e_async(packed, lens, scheme, thresholder, k=kk)()
            print(f"prewarm: L={Lb} topk={kk} in "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)


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
            layout_cost=args.layout_cost,
            tmax=args.tmax,
            spill_dir=args.spill_dir,
            verbose_stats=args.output_verbose_statistics,
            count_output_prefix=args.count_output_prefix,
            resume=args.resume,
        ))
    elif args.command == "search":
        from .search.pipeline import SearchConfig, run_search

        device = args.device
        if args.distributed:
            from .device.distributed import initialize

            device = initialize(coordinator_address=args.coordinator_address,
                                num_processes=args.num_processes,
                                process_id=args.process_id,
                                device=args.device)
        run_search(SearchConfig(
            index_file=args.index_file,
            query_file=args.query_file,
            report_file=args.output_file,
            threads=args.threads,
            percentage=args.percentage,
            error_rate=args.error_rate,
            engine=args.engine,
            mesh_reads=args.mesh_reads,
            mesh_bins=args.mesh_bins,
            write_time=args.write_time,
            profile_trace=args.profile_trace,
        ), device=device)
    elif args.command == "prewarm":
        run_prewarm(args.index_file, args.lengths, args.topk,
                    args.percentage, args.error_rate, args.device)
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
    _add_prewarm(sub)
    parser.add_argument("--verbose", "-v", action="store_true",
                        help="accepted for parity with the JAX CLI; no "
                             "module of this package logs at debug level")
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
