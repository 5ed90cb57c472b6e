"""The port's tooling: the benchmark (``bench``), the phase profiler
(``profile_phases``), the probe diagnostics (``probe_bounds``,
``probe_experiments``), the extractor's bisecting tools
(``debug_extract``, ``debug_min``), their synthetic problems (``synth``)
and timing helper (``timing``).  Each tool is ``python -m
taxor_tpu_torch.tools.<name> [--device cuda|cpu]``."""
