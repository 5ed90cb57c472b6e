"""Native (C++) host components: the syncmer scanner and 2-bit read
packer (``syncmer_scan.cpp``), the XOR-filter peeling builder
(``xor_peel.cpp``), the layout DP (``layout_dp.cpp``) and the CPU proxy
of the reference's search worker that the benchmark measures against
(``ref_baseline.cpp``, wrapped by ``baseline.py``; its HIXF walk alone is
the host oracle's, ``hixf_membership``, and ``hixf_walk`` lists the IXFs
it visits).

The port's own copy of ``taxor_tpu/native``.  The shared library is compiled with g++ at
first use (never at import) into ``taxor_tpu_torch/_build/native/``,
which .gitignore lists; its name carries a hash of the sources.  Each
process compiles into a temporary file of its own and renames it into
place, so processes that build at the same moment (test workers on a
cold build) all end up with a complete library.  Without a working
compiler ``get_lib`` returns None and the callers use their numpy
implementations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")
_SOURCES = ("syncmer_scan.cpp", "xor_peel.cpp", "ref_baseline.cpp",
            "layout_dp.cpp")

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_L = ctypes.c_long
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "syncmer_scan": (_L, [_P, _L, _I, _I, _I, _P]),
    "pack_reads_2bit": (None, [_P, _P, _L, _L, _P]),
    "ixf_build_bins": (_L, [_P, _P, _L, ctypes.c_ulonglong, _L, _P, _L,
                            _I]),
    "ref_baseline_search": (_I, [_P, _P, _L, _I, _I, _I, _P, _P, _I, _P, _P,
                                 _P, _P, _P, _P, _P, _L, _P, _P, _P, _I]),
    "hixf_membership": (_L, [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _L,
                             ctypes.c_longlong, _I, _P, _P, _L]),
    "hixf_walk": (_L, [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _L,
                       ctypes.c_longlong, _I, _P, _L]),
    "syncmer_scan_batch": (None, [_P, _P, _L, _L, _I, _I, _I, _P, _P]),
    "hll_union_band": (None, [_P, _P, _L, _L, _L, _P, _I]),
    "layout_dp": (_L, [_P, _L, _P, _L, _L, _L, _P, _P, _P, _P, _P, _I]),
    "rearrange_chain": (None, [_P, _P, _L, _L, _L, _P, _I]),
}


def _compile() -> str | None:
    """Path of the library for the current sources, compiled if missing;
    None when g++ is absent or fails."""
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as fh:
            h.update(fh.read())
    out = os.path.join(BUILD_DIR, f"libtaxor_native_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
           "-std=c++17", *srcs, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    os.replace(tmp, out)  # atomic: another process never loads a part
    return out


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _compile()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
        return _LIB
