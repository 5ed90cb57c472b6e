"""extract_stage and window_shift (csrc/diag/extract_stages.cu) on one
length bucket, each held bit-exact to its plain twin, then timed.

    python -m taxor_tpu_torch.tools.time_stages [--L 8192] [--reads 512]
        [--device cuda]

Two batches of R reads of the L bucket at k=22/s=12/t=5: random reads
(``time_extract.random_reads``, lengths uniform over (L/2, L]) and reads
tied in every window (``time_extract.all_tied_reads``: homopolymers and
tandem repeats, where the tracker's held minimum slides out most
often).  extract_stage is timed in stages sf, chi, erm, emit and pre on
the random batch, pre on the tied batch (``pre_tied``), and pre on the
random batch's longest read alone (``pre_one``: one block, so one read's
serial chain of tracker steps, the floor of emit and pre); window_shift
in 16 phases on the random batch's stream words, [R, L/16].  Each gets
``<name>_ms``, a call as a caller sees it (``time_extract.best_ms``),
and on the card ``<name>_device_ms``, the kernel alone
(``time_sort.device_ms``: the launches queued behind a sleep kernel),
beside ``bound_ms``: the bytes
each must move (packed reads and lengths in, 8 bytes a position out, 1
for emit; window_shift's words in once and 16 times out) at 3.35 TB/s.
``pre_one_clocks_per_base`` is pre_one_device_ms at the SM clock
nvidia-smi reports as its maximum, over that read's length.  One JSON
line goes to stdout; exit code 1 when a kernel differs from its twin.
With ``--device cpu`` it runs the twins (a check of the tool, no device
time).

To compare two checkouts, run this file from each in turns (parent,
change, change, parent) in one call to the card:
``PYTHONPATH=<checkout> python <this file>``.  It imports the package by
its absolute name, so the same file drives an older checkout.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from taxor_tpu_torch.device import diag
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.tools.bench import card_line, log
from taxor_tpu_torch.tools.time_extract import (all_tied_reads, best_ms,
                                                random_reads)
from taxor_tpu_torch.tools.time_sort import device_ms

K, S, T = 22, 12, 5
SEED = 20261018
HBM_BPS = 3.35e12  # H100 SXM device memory rate
STAGES = ("sf", "chi", "erm", "emit", "pre")


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.split()[0])


def to_device(seqs: list[bytes], L: int, dev: torch.device):
    packed, lengths = dsync.pack_reads(seqs, L)
    return (torch.from_numpy(packed).to(dev),
            torch.from_numpy(lengths).to(dev))


def measure(batches: dict, words: torch.Tensor, dev: torch.device) -> dict:
    """{equal, emissions, <name>_ms, <name>_device_ms (on the card)} of
    ``batches`` {suffix: (packed, lengths)} ("" the main batch, whose
    stages are STAGES; pre alone on the others, as pre<suffix>) and of
    window_shift on ``words``, each held to its twin first."""
    equal, emissions, calls = {}, {}, {}
    for b, (pk, ln) in batches.items():
        stages = STAGES if b == "" else ("pre",)
        want = diag.extract_stages_plain(pk, ln, K, S, T, ("emit", *stages))
        emissions[b or "_main"] = int(want["emit"].sum())
        for st in stages:
            calls[st + b] = (lambda st=st, pk=pk, ln=ln: diag.extract_stage(
                pk, ln, K, S, T, st))
            equal[st + b] = torch.equal(calls[st + b](), want[st])
    calls["window_shift"] = lambda: diag.window_shift(words)
    equal["window_shift"] = torch.equal(
        calls["window_shift"](), diag.window_shift_plain(words, range(16)))
    out = {"emissions": emissions, "equal": equal}
    for name, fn in calls.items():
        out[f"{name}_ms"] = best_ms(fn, dev)
        if dev.type == "cuda":
            out[f"{name}_device_ms"] = device_ms(fn)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--L", type=int, default=8192, help="length bucket")
    ap.add_argument("--reads", type=int, default=512,
                    help="reads a batch (512 fill the L=8192 bucket)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N, or cpu for the "
                         "plain twins)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    L, R = args.L, args.reads
    rng = np.random.default_rng(SEED)
    seqs = random_reads(rng, L, R)
    longest = max(seqs, key=len)
    pk, ln = to_device(seqs, L, dev)
    words = torch.from_numpy(np.ascontiguousarray(
        dsync.pack_reads(seqs, L)[0]).view(np.int32)).to(dev)
    out = {"device": card_line() if dev.type == "cuda" else "cpu", "L": L,
           "reads": R, "one_read_length": len(longest),
           "bound_ms": {
               "per_position": (pk.numel() + 4 * R + 8 * R * L)
               / HBM_BPS * 1e3,
               "emit": (pk.numel() + 4 * R + R * L) / HBM_BPS * 1e3,
               "window_shift": 4 * words.numel() * 17 / HBM_BPS * 1e3}}
    out.update(measure({"": (pk, ln),
                        "_tied": to_device(all_tied_reads(rng, L, R), L, dev),
                        "_one": to_device([longest], L, dev)}, words, dev))
    if dev.type == "cuda":
        mhz = max_sm_clock_mhz()
        out["max_sm_clock_mhz"] = mhz
        out["pre_one_clocks_per_base"] = (
            out["pre_one_device_ms"] * 1e3 * mhz / len(longest))
    log(f"time_stages: {out}")
    print(json.dumps(out))
    return 0 if all(out["equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
