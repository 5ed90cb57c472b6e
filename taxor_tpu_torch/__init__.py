"""taxor_tpu_torch — the taxor_tpu classifier on PyTorch and CUDA (Hopper).

A second package beside the JAX reference ``taxor_tpu``, which it
never imports.  It holds its own copy of the JAX package's numpy host
layer (``io/``, ``hash/`` oracles and schemes, ``ixf/``, ``hixf/``,
``search/thresholds.py``, ``apps/build.py``, ``profile/``, and the C++
of ``native/``, built into ``_build/native``) and everything that ran on
the TPU: the 64-bit hash math on device tensors, syncmer extraction
(CUDA kernel K1, ``csrc/extract.cu``, or the split engine: the tracker
``syncmer_track`` and the dedup kernel K3 ``csrc/dedup.cu``), the
pair sort K4 (``csrc/sort_pairs.cu``), the interleaved XOR filter
probe/count (K2 ``csrc/probe_slab.cu`` and ``csrc/probe.cu``; K2n
``csrc/probe_narrow.cu``, which also sums the descent's runs), the fused
search steps, the device index and the search pipeline and CLI.

Every kernel has a plain PyTorch twin in the same module, taken only for
tensors on the CPU.  This package never imports JAX.
"""

__version__ = "0.1.0"
