"""Stage dumps of the syncmer extractor on one CUDA GPU: one intermediate
per launch, held against its plain twin.

    python -m taxor_tpu_torch.tools.debug_extract [--stage ys|all]
        [--device cuda]

The port of the JAX package's tools/debug_extract.py, which bisected the
TPU extractor by dumping one stage of it per run and comparing the
compiled kernel with its interpret-mode run.  Here the kernel is
``device/diag.extract_stage`` (csrc/diag/extract_stages.cu), which dumps
one stage in POSITION order and, for ``emit`` and ``pre``, applies the
reference tracker's step rule (csrc/tracker.cuh ``tracker_step``, the
rule K1 replays in its tied runs) to every window of a read on one
thread; it is compared with its plain twin.  The reads
are the JAX tool's: reads 1, 9, 11, 15, 0, 2, 3, 4 of
``synth.build_problem(32 genomes of 8 kb, 256 reads of 1 kb, seed 7)``,
with k=22, s=12, t=5.  Exit code 1 when a stage differs.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import torch

from ..device import diag
from ..hash import device_syncmer as dsync
from ..io.fastx import read_all
from . import synth

K, S, T = 22, 12, 5
READ_IDS = (1, 9, 11, 15, 0, 2, 3, 4)
# the JAX tool's stage names -> the port stage holding the same value
# (None: a value of the TPU's 16-phase word layout, which the GPU kernel
# does not have; tools/debug_min reproduces the funnel shift of shonly1)
JAX_STAGES = {
    "sflo": "sf", "srlo": "sr", "ys": "ys", "kflo": "kf", "krlo": "kr",
    "chi": "chi", "clo": "clo", "erm": "erm", "emit": "emit",
    "pre_hi": "pre", "pre_lo": "pre",
    # the s-mer window's funnel-shifted words before the mask and the
    # 2-bit field reversal: sr is the masked window complemented, sf its
    # field reversal
    "wlo": "sr", "whi": "sr", "frlo": "sf", "frhi": "sf",
    "rolls": None, "w0": None, "w1": None, "shonly": None, "shonly1": None,
}


def problem_reads():
    """(packed uint8 [8, L/4], lengths int32 [8]) of the JAX tool's reads."""
    with tempfile.TemporaryDirectory(prefix="taxor_dbg_") as tmp:
        _, _, _, reads = synth.build_problem(
            n_species=32, genome_len=8000, n_reads=256, read_len=1000,
            seed=7, root=tmp)
        seqs = [r.seq for r in read_all(reads)]
    sub = [seqs[i] for i in READ_IDS]
    return dsync.pack_reads(sub, dsync.pad_len_bucket(max(map(len, sub))))


def check_stage(packed: torch.Tensor, lengths: torch.Tensor, stage: str,
                k: int = K, s: int = S, t: int = T):
    """(kernel output, number of entries that differ, twin output)."""
    got = diag.extract_stage(packed, lengths, k, s, t, stage)
    want = diag.extract_stage_plain(packed, lengths, k, s, t, stage)
    return got, int((got != want).sum()), want


def _help_epilog() -> str:
    rows = [f"  {j:8s} -> {p or '(none: TPU word layout)'}"
            for j, p in JAX_STAGES.items()]
    return "JAX tool stage -> port stage:\n" + "\n".join(rows)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0], epilog=_help_epilog(),
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--stage", default="ys",
                    choices=[*diag.STAGES, *JAX_STAGES, "all"],
                    help="the stage to dump (a JAX tool's stage name maps "
                         "as below; all: every port stage)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N, or cpu for the "
                         "plain twins)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    if args.stage == "all":
        stages = list(diag.STAGES)
    elif JAX_STAGES.get(args.stage, args.stage) is None:
        print(f"stage {args.stage}: a value of the TPU's 16-phase word "
              "layout, which the GPU kernel does not have (see --help)")
        return 2
    else:
        stages = [JAX_STAGES.get(args.stage, args.stage)]
    packed, lengths = problem_reads()
    pk = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    bad = 0
    for stage in stages:
        got, ndiff, want = check_stage(pk, ln, stage)
        print(f"stage {stage}: kernel == twin: {ndiff == 0} ({got.shape[0]} "
              f"reads, L={got.shape[1]}, {str(got.dtype)[6:]})", flush=True)
        if ndiff:
            bad += 1
            d = (got != want).nonzero().tolist()
            print("first diffs (read, position):", d[:8])
            for r, c in d[:4]:
                print(f"  [{r},{c}]: kernel={int(got[r, c]):#x} "
                      f"twin={int(want[r, c]):#x}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
