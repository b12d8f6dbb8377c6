"""ctypes bridge to the port's native edge-list parser (``csrc/edgeio.cpp``;
counterpart of ``pprx.graph.native_io``).

The parser is host C++, built with the machine's C++ compiler at first use
(``pprx_torch._ext.build_host``); ``available()`` says whether a compiler
exists. Where none does, ``pprx_torch.graph.io.load_edge_list`` parses in
Python (the same output, held against each other in the tests).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from pprx_torch import _ext


def available() -> bool:
    """Whether the native parser can be built here (a C++ compiler exists)."""
    return _ext.find_cxx() is not None


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _ext.load_host("edgeio")
    lib.pprx_parse_edgelist.restype = ctypes.c_int
    lib.pprx_parse_edgelist.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.pprx_free.restype = None
    lib.pprx_free.argtypes = [ctypes.c_void_p]
    return lib


def parse_edgelist_raw(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """Parse ``path`` with the native library (built here on first use).
    Returns (src, dst, ts, has_ts) in file order, not renumbered. Raises
    RuntimeError where the library cannot be built or the file not read."""
    lib = _lib()
    src_p = ctypes.POINTER(ctypes.c_int64)()
    dst_p = ctypes.POINTER(ctypes.c_int64)()
    ts_p = ctypes.POINTER(ctypes.c_double)()
    count = ctypes.c_int64()
    has_ts = ctypes.c_int()
    rc = lib.pprx_parse_edgelist(
        path.encode(), ctypes.byref(src_p), ctypes.byref(dst_p),
        ctypes.byref(ts_p), ctypes.byref(count), ctypes.byref(has_ts),
    )
    if rc != 0:
        raise RuntimeError(f"native edge parse failed (rc={rc}) for {path!r}")
    n = count.value
    if n == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float64),
                bool(has_ts.value))
    try:
        src = np.ctypeslib.as_array(src_p, shape=(n,)).copy()
        dst = np.ctypeslib.as_array(dst_p, shape=(n,)).copy()
        ts = np.ctypeslib.as_array(ts_p, shape=(n,)).copy()
    finally:
        lib.pprx_free(src_p)
        lib.pprx_free(dst_p)
        lib.pprx_free(ts_p)
    return src, dst, ts, bool(has_ts.value)
