"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` compiles for ``sm_90a`` in its own ``nvcc`` process,
all started together, and one more ``nvcc`` call links the objects into a
shared library with a plain C interface, loaded with ctypes.  The build
runs at first use (never at import) into ``taxor_tpu_torch/_build/``,
which .gitignore lists; the library's name carries a hash of the
sources, so an edited source rebuilds.  Each C launcher enqueues on the
stream it is given and returns ``cudaGetLastError()``; ``check`` turns a
non-zero code into an exception.
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
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (packed, lengths, R, L, k, s, t, hcap, W, scratch,
    #  out_hi, out_lo, out_valid, n_unique, n_emit, stream)
    "launch_syncmer_extract": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                               _P, _P, _P, _P, _P, _P],
    # (hi, lo, valid, R, H, tables, G, S, Bpad, active, seed,
    #  block_length, out, stream)
    "launch_probe_count": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _P,
                           ctypes.c_uint64, ctypes.c_uint32, _P, _P],
    "launch_probe_count_narrow": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _P,
                                  ctypes.c_uint64, ctypes.c_uint32, _P, _P],
    # (packed, lengths, R, L, k, s, t, out_kmer, out_emit, stream)
    "launch_syncmer_track": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # (kmer, emit, R, L, hcap, Wb, scratch, out_kmer, out_valid, n_unique,
    #  n_emit, stream)
    "launch_dedup": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # (hi, lo, R, W, Wp, scratch, out_hi, out_lo, stream)
    "launch_sort_pairs": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
}


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of taxor_tpu_torch "
                       "build with the CUDA toolkit")


def build() -> str:
    """Compile csrc/ if the library for its current sources is missing;
    returns the library path."""
    srcs = _sources()
    h = hashlib.sha256()
    for path in srcs:
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    out = os.path.join(BUILD_DIR, f"libtaxor_kernels_{h.hexdigest()[:16]}.so")
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


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            cdll = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = cdll
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, route: str | None = None) -> None:
    """wrapper.LAUNCHES += 1, and wrapper.ROUTES[route] += 1 for a named
    route, under a lock: pipeline workers launch from several threads."""
    with _COUNT_LOCK:
        wrapper.LAUNCHES += 1
        if route is not None:
            wrapper.ROUTES[route] = wrapper.ROUTES.get(route, 0) + 1
