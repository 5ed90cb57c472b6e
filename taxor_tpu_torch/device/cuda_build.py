"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` compiles for ``sm_90a`` in its own ``nvcc`` process,
all started together, and one more ``nvcc`` call links the objects into a
shared library with a plain C interface, loaded with ctypes (``lib``).
The diagnostic kernels of the tools (``csrc/diag/*.cu``) build the same
way into a second library (``diag_lib``), so that a diagnostic kernel
that fails to compile never stops a search; it fails the tool that asked
for it.  They include the headers they share with the search kernels
from ``csrc/``, whose text is part of their hash.  The builds run at
first use (never at import) into ``taxor_tpu_torch/_build/``, which
.gitignore lists; a library's name carries a hash of its sources, so an
edited source rebuilds.  Each C launcher enqueues on the stream it is
given and returns ``cudaGetLastError()``; ``check`` turns a non-zero code
into an exception.  ``syncmer_extract_smem``, ``probe_slab_bins``,
``probe_slab_fit``, ``probe_cluster_split``, ``probe_narrow_mode``,
``diag_smem_per_block`` and ``extract_stage_smem`` are no launchers:
they return the shared memory K1 takes, the slab width of K2's slab
route (0 for its rows route) and the widest that fits, the cluster of
its split variant, K2n's mode (1 smem, 0 rows), the shared memory a
block may take (the diagnostics' slab route) and the dynamic shared
memory of an extract_stage launch, so that the wrappers never repeat a
kernel's layout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
DIAG_CSRC = os.path.join(CSRC, "diag")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIB = None
_DIAG_LOCK = threading.Lock()
_DIAG_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (packed, lengths, R, L, P, Lp, stride, k, s, t, hcap, W, scratch,
    #  out_hi, out_lo, out_valid, n_unique, n_emit, stream)
    "launch_syncmer_extract": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _P, _P, _P, _P, _P, _P, _P],
    # (Lp, s, W, in_smem) -> K1's dynamic shared-memory bytes
    "syncmer_extract_smem": [_I, _I, _I, _I],
    # (hi, lo, valid, R, H, tables, G, S, Bpad, active, seed,
    #  block_length, slab_bins, rec, nrec, out, stream)
    "launch_probe_count": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _P,
                           ctypes.c_uint64, ctypes.c_uint32, _I, _P, _P, _P,
                           _P],
    # (S, Bpad, H, device) -> K2's slab width in bins, 0: the rows route
    "probe_slab_bins": [_I, _I, _I, _I],
    # (S, Bpad, device) -> the widest slab that fits, 0: none
    "probe_slab_fit": [_I, _I, _I],
    # (hi, lo, valid, R, H, tables, G, S, Bpad, active, seed,
    #  block_length, C, rec, nrec, out, stream)
    "launch_probe_split": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _P,
                           ctypes.c_uint64, ctypes.c_uint32, _I, _P, _P, _P,
                           _P],
    # (S, Bpad, block_length, device) -> the split variant's cluster
    "probe_cluster_split": [_I, _I, _I, _I],
    # (hi, lo, valid, R, H, tables, G, S, Bpad, active, seed,
    #  block_length, run_off, run_s, run_e, n_runs, mode, out, stream)
    "launch_probe_narrow": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _P,
                            ctypes.c_uint64, ctypes.c_uint32, _P, _P, _P, _I,
                            _I, _P, _P],
    # (S, Bpad, device) -> K2n's mode: 1 smem, 0 rows
    "probe_narrow_mode": [_I, _I, _I],
    # (packed, lengths, R, L, P, Lp, stride, k, s, t, out_kmer, out_emit,
    #  stream)
    "launch_syncmer_track": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                             _P],
    # (kmer, emit, R, L, hcap, Wb, scratch, out_kmer, out_valid, n_unique,
    #  n_emit, stream)
    "launch_dedup": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # (hi, lo, R, W, Wp, scratch, out_hi, out_lo, stream)
    "launch_sort_pairs": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    # (hi, lo, n_valid, R, W, out_hi, out_lo, out_valid, n_unique, stream)
    "launch_unique_pairs": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    # (packed, lengths, R, L, k, wp, seed, thresh, out_hi, out_lo,
    #  out_valid, n_emit, n_unique, stream)
    "launch_minimizer": [_P, _P, _I, _I, _I, _I, ctypes.c_uint64,
                         ctypes.c_uint64, _P, _P, _P, _P, _P, _P],
}
_DIAG_SIGNATURES = {
    # (device) -> the shared memory a block may opt in to
    "diag_smem_per_block": [_I],
    # (table, S1, B, words, R, W, n_hash, mode, U, RT, slab_bins, out,
    #  stream)
    "launch_probe_bounds": [_P, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I, _P,
                            _P],
    # (table, S1, B, words, R, W, H, n_hash, layout, nr, rounds, flood_k,
    #  block_length, slab_bins, out, extra, stream)
    "launch_probe_experiment": [_P, _I, _I, _P, _I, _I, _I, _P, _I, _I, _I,
                                _I, ctypes.c_uint32, _I, _P, _P, _P],
    # (L, stage) -> extract_stage's dynamic shared-memory bytes
    "extract_stage_smem": [_I, _I],
    # (packed, lengths, R, L, k, s, t, stage, out, out_emit, stream)
    "launch_extract_stage": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # (x, R, Wd, phases: host int32 (d, sh) pairs, P, out, stream)
    "launch_window_shift": [_P, _I, _I, _P, _I, _P, _P],
    # (mode, C, clusters, rows_log2, iters, out, stream); clusters 0:
    # minus the clusters resident at once
    "launch_dsmem_rows": [_I, _I, _I, _I, _I, _P, _P],
}


def _sources(src_dir: str) -> list[str]:
    """The .cu and .cuh files at the top level of src_dir."""
    return sorted(os.path.join(src_dir, f) for f in os.listdir(src_dir)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of taxor_tpu_torch "
                       "build with the CUDA toolkit")


def build(src_dir: str = CSRC, name: str = "taxor_kernels") -> str:
    """Compile the .cu files of src_dir into lib<name>_<hash>.so if the
    library for the current sources is missing; returns its path.  The
    hash covers src_dir's sources and, for a subdirectory of csrc/, the
    headers of csrc/ it may include."""
    srcs = _sources(src_dir)
    deps = srcs if src_dir == CSRC else srcs + [
        p for p in _sources(CSRC) if p.endswith(".cuh")]
    h = hashlib.sha256()
    for path in deps:
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    objs, procs = [], []
    for src in (p for p in srcs if p.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [_nvcc(), *flags, "-c", "-o", obj, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    errs = [f"{p.args[-1]}:\n{p.communicate()[1]}" for p in procs]
    try:
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                e for e, p in zip(errs, procs) if p.returncode))
        res = subprocess.run([_nvcc(), *flags, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)  # atomic: a concurrent build never loads a part
    return out


def _load(path: str, signatures: dict) -> ctypes.CDLL:
    cdll = ctypes.CDLL(path)
    for name, argtypes in signatures.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return cdll


def lib() -> ctypes.CDLL:
    """The loaded kernel library of the search (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _load(build(), _SIGNATURES)
    return _LIB


def diag_lib() -> ctypes.CDLL:
    """The loaded library of the tools' diagnostic kernels (built on
    first call from csrc/diag/; a failed build raises)."""
    global _DIAG_LIB
    with _DIAG_LOCK:
        if _DIAG_LIB is None:
            _DIAG_LIB = _load(build(DIAG_CSRC, "taxor_diag"),
                              _DIAG_SIGNATURES)
    return _DIAG_LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_of(t) -> int:
    """The current stream of t's device, made the calling thread's
    current device first: a C launcher launches on the thread's current
    device, and a pipeline worker thread starts on device 0 (a rank of
    the sharded engine on cuda:r of a multi-card host)."""
    import torch

    if torch.cuda.current_device() != t.device.index:
        torch.cuda.set_device(t.device)
    return torch.cuda.current_stream(t.device).cuda_stream


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, route: str | None = None,
                 tally: dict | None = None,
                 variant: str | None = None) -> None:
    """wrapper.LAUNCHES += 1, wrapper.ROUTES[route] += 1 for a named
    route and tally[variant] += 1 for a kernel's tally of its variants
    (K2's VARIANTS, K2n's MODES), under a lock: pipeline workers launch
    from several threads."""
    with _COUNT_LOCK:
        wrapper.LAUNCHES += 1
        if route is not None:
            wrapper.ROUTES[route] = wrapper.ROUTES.get(route, 0) + 1
        if tally is not None:
            tally[variant] = tally.get(variant, 0) + 1
