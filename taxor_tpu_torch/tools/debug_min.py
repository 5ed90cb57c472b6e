"""Window-shift repro on one CUDA GPU: the funnel-shifted stream words of
the TPU extractor's 16 phases, kernel against plain twin.

    python -m taxor_tpu_torch.tools.debug_min [--phases 0,1,...]
        [--device cuda]

The port of the JAX package's tools/debug_min.py, the minimal repro of a
compiled-vs-interpret divergence of the TPU extractor's word rolls.  For
each phase c, off = 2c - 22 = 32 jb + sh: the row of stream words rolled
left by jb + 1 words and, if sh, shifted left by 32 - sh and masked to 24
bits (``device/diag.window_shift``, csrc/diag/extract_stages.cu).  The
words are those of tools/debug_extract's eight reads (the JAX tool read
them from a file one of its runs had saved).  Prints the total number of
differing words, the count per phase block and a sample; exit code 1
when any word differs.
"""

from __future__ import annotations

import argparse
import collections
import sys

import numpy as np
import torch

from ..device import diag
from .debug_extract import problem_reads


def stream_words(packed: np.ndarray) -> np.ndarray:
    """int32 [R, L/16] little-endian stream words of packed reads: base i
    at bits 2*(i%16) of word i//16."""
    return np.ascontiguousarray(packed).view("<u4").view(np.int32)


def diff_report(got: np.ndarray, want: np.ndarray, Wd: int, phases) -> int:
    """Prints the JAX tool's report of got against want; returns the
    number of differing words."""
    d = np.argwhere(got != want)
    print("phases", list(phases), "total diffs:", d.shape[0], flush=True)
    if d.shape[0]:
        cols = d[:, 1]
        print("per-block:", dict(collections.Counter((cols // Wd).tolist())))
        sel = d[(cols // Wd) == (cols[0] // Wd)]
        print("block words:", sorted(set((sel[:, 1] % Wd).tolist()))[:24])
        print("sample:", [(int(r), int(c), hex(got[r, c] & 0xFFFFFFFF),
                           hex(want[r, c] & 0xFFFFFFFF)) for r, c in d[:6]])
    return int(d.shape[0])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(map(str, range(16))),
                    help="comma-separated phases c (0..15)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N, or cpu for the "
                         "plain twins)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    phases = [int(x) for x in args.phases.split(",") if x]
    x = torch.from_numpy(stream_words(problem_reads()[0])).to(dev)
    got = diag.window_shift(x, phases).cpu().numpy()
    want = diag.window_shift_plain(x, phases).cpu().numpy()
    return 1 if diff_report(got, want, x.shape[1], phases) else 0


if __name__ == "__main__":
    sys.exit(main())
