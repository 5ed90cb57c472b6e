"""Per-pass timing of device functions for the benchmark and the
profiler.

Counterpart of ``profile_phases.timed`` and ``bench._rolled_timer`` of
the JAX package.  Those loop M passes inside one ``jit`` (a ``lax.scan``)
and feed each pass the first argument rolled by one row, for two
reasons: a constant carry let XLA hoist the whole body out of the loop
(loop-invariant code motion), and an output no one consumed let it drop
whole sub-computations (dead-code elimination), so every output was
reduced into the carried scalar.  Eager PyTorch has neither compiler
pass: every launch runs, so neither reason holds here, and no output is
reduced.

What still holds is the rolled first argument: pass m gets the first
argument rolled by m rows, a different buffer holding the same reads, so
every pass does the same work and no pass finds its input warm in the
50 MB L2 from the one before.  The M rolled copies are made before the
clock starts; a pass is M calls between two CUDA events (on the CPU,
``time.perf_counter``), and the result is the best of 3 means, as in the
JAX helpers.
"""

from __future__ import annotations

import time

import torch


def rolled_ms(fn, roll_arg: torch.Tensor, *const_args,
              M: int = 10) -> float:
    """Milliseconds per call of fn(roll_arg rolled by m rows,
    *const_args), the best of 3 means over M calls, after one warm-up
    call."""
    heads = [torch.roll(roll_arg, m, dims=0) for m in range(M)]
    fn(heads[0], *const_args)
    cuda = roll_arg.device.type == "cuda"
    best = float("inf")
    for _ in range(3):
        if cuda:
            torch.cuda.synchronize(roll_arg.device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for h in heads:
                fn(h, *const_args)
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b) / M
        else:
            t0 = time.perf_counter()
            for h in heads:
                fn(h, *const_args)
            ms = (time.perf_counter() - t0) * 1e3 / M
        best = min(best, ms)
    return best
