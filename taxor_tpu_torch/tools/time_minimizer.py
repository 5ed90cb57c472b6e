"""K5 (minimiser and plain k-mer extraction) on one length bucket, held
bit-exact to its plain twin, then timed.

    python -m taxor_tpu_torch.tools.time_minimizer [--L 8192] [--reads 512]
        [--device cuda]

The batch: R random reads of the L bucket (``time_extract.random_reads``:
lengths uniform over (L/2, L]) at k = 20: ``w7`` (window 26, w' = 7),
``w1`` (window 20: plain k-mers) and ``w7_scaled`` (window 26 with the
FracMinHash keep of scaling 3).  ``measure`` holds each to its twin and
times it: ``<name>_ms``, a call as a caller sees it
(``time_extract.best_ms``), ``<name>_device_ms``, the kernel alone
(``time_sort.device_ms``; on the CPU the twin's ``best_ms``), and
``<name>_plain_ms``, the twin's call.  ``chip_smoke.py`` phase 13d times
K5 through it on its own reads.  One JSON line goes to stdout:
nvidia-smi's name and power limit, the emissions and the times; exit
code 1 when K5 differs from its twin.

To compare two checkouts, run this file from each in turns (parent,
change, change, parent) in one call to the card:
``PYTHONPATH=<checkout> python <this file>``.  A checkout whose K5 has
no keep (``minimizer_kmers`` returning (hi, lo, emit, n_emit)) times K5
followed by the keep as tensor ops, what its fused step ran.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from taxor_tpu_torch.device import extract
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.hash.schemes import scaling_threshold_u64
from taxor_tpu_torch.tools.bench import card_line, log
from taxor_tpu_torch.tools.time_extract import best_ms, random_reads
from taxor_tpu_torch.tools.time_sort import device_ms

K = 20
SEED = 20261018
CASES = (("w7", 26, 1), ("w1", 20, 1), ("w7_scaled", 26, 3))  # window, s


def scaling_keep():
    """The FracMinHash keep as tensor ops (an older checkout holds it in
    device/e2e.py)."""
    if hasattr(extract, "scaling_keep"):
        return extract.scaling_keep
    from taxor_tpu_torch.device.e2e import _scaling_keep

    return _scaling_keep


def k5_call(pk, ln, window: int, thresh: int):
    """A call of K5 as the fused step makes it: (hi, lo, valid, n_emit,
    n_unique); an older checkout's (hi, lo, valid)."""
    if hasattr(extract, "minimizer_hashes_plain"):
        return extract.minimizer_kmers(pk, ln, K, window, thresh)
    hi, lo, emit, _ = extract.minimizer_kmers(pk, ln, K, window)
    return hi, lo, emit & scaling_keep()(hi, lo, thresh) if thresh else emit


def twin(pk, ln, window: int, thresh: int):
    """K5's plain twin followed by the keep, as ``k5_call`` returns it."""
    if hasattr(extract, "minimizer_hashes_plain"):
        return extract.minimizer_hashes_plain(pk, ln, K, window, thresh)
    hi, lo, emit, _ = dsync.minimizer_kmers_plain(pk, ln, K, window)
    return hi, lo, emit & scaling_keep()(hi, lo, thresh) if thresh else emit


def measure(pk, ln, dev: torch.device) -> dict:
    """{equal, max_abs_err, emissions (valid slots), <name>_ms,
    <name>_device_ms, <name>_plain_ms} of each of CASES on the batch
    (packed pk, lengths ln), K5 held to its twin first."""
    out = {"equal": {}, "max_abs_err": 0.0, "emissions": {}}
    for name, window, scaling in CASES:
        thresh = scaling_threshold_u64(scaling) if scaling > 1 else 0
        fn = lambda: k5_call(pk, ln, window, thresh)  # noqa: E731
        plain = lambda: twin(pk, ln, window, thresh)  # noqa: E731
        got, want = fn(), plain()
        out["equal"][name] = all(torch.equal(a, b) for a, b in
                                 zip(got, want))
        out["max_abs_err"] = max([out["max_abs_err"], *(
            float((a.double() - b.double()).abs().max())
            for a, b in zip(got, want) if a.numel())])
        out["emissions"][name] = int(got[2].sum())
        out[f"{name}_ms"] = best_ms(fn, dev)
        out[f"{name}_device_ms"] = (device_ms(fn) if dev.type == "cuda"
                                    else best_ms(fn, dev))
        out[f"{name}_plain_ms"] = best_ms(plain, dev, 2)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--L", type=int, default=8192, help="length bucket")
    ap.add_argument("--reads", type=int, default=512,
                    help="reads a batch (512 fill the L=8192 bucket)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N, or cpu for the "
                         "plain twin)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    packed, lengths = dsync.pack_reads(
        random_reads(np.random.default_rng(SEED), args.L, args.reads),
        args.L)
    pk = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    out = {"device": card_line() if dev.type == "cuda" else "cpu",
           "L": args.L, "reads": args.reads, "k": K,
           **measure(pk, ln, dev)}
    log(f"time_minimizer: {out}")
    print(json.dumps(out))
    return 0 if all(out["equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
