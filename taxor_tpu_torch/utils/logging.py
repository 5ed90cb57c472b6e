"""Profiler hook of the search.

Counterpart of ``taxor_tpu/utils/logging.maybe_profile``, which wraps the
search's compute phase in a ``jax.profiler`` trace: here a
``torch.profiler`` run over the host and, on a CUDA device, the card,
exported as a Chrome trace (open it in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import os

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None, device: str = "cuda"):
    """Profiles the body into ``trace_dir``/trace.json; a no-op when
    trace_dir is empty.  ``device``: the torch device the body runs on
    (CUDA activity is recorded for a CUDA device)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_NAME))
