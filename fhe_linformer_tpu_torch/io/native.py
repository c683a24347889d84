"""ctypes bindings of the host codec `csrc/fastio.cpp`: float parsing, the
centered CRT lift of the host decrypt, and the CRC-32 checked checkpoint
pages.

The library is built by g++ at first use (`ops/cuda_build.py`) into
`build/torch_kernels/`.  There is no fallback: a failed build or load
raises with the compiler's output, so no caller goes on in numpy without
saying so.  The plain versions the tests hold these functions to are
`ckks/encoding.crt_lift_center` (Python ints), `io/serialize.read_pages`
(numpy and zlib) and `io/weights.read_values`.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ..ops import cuda_build

_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_f64p = ctypes.POINTER(ctypes.c_double)


@functools.cache
def get_lib() -> ctypes.CDLL:
    lib = cuda_build.library("fastio")
    lib.fast_read_floats.restype = ctypes.c_long
    lib.fast_read_floats.argtypes = [ctypes.c_char_p, _f64p, ctypes.c_long]
    lib.crt_lift_center.restype = None
    lib.crt_lift_center.argtypes = [_u32p, ctypes.c_long, ctypes.c_long,
                                    _u64p, _u64p, ctypes.c_uint64,
                                    ctypes.c_uint64, _f64p]
    lib.write_blob_u32.restype = ctypes.c_int
    lib.write_blob_u32.argtypes = [ctypes.c_char_p, _u32p, ctypes.c_long]
    lib.read_blob_u32.restype = ctypes.c_long
    lib.read_blob_u32.argtypes = [ctypes.c_char_p, _u32p, ctypes.c_long]
    return lib


def read_floats(path: str) -> np.ndarray:
    """Comma / whitespace separated floats of a text file, as float64."""
    lib = get_lib()
    name = os.fsencode(path)
    n = lib.fast_read_floats(name, None, 0)
    if n < 0:
        raise FileNotFoundError(path)
    out = np.empty(n, np.float64)
    lib.fast_read_floats(name, out.ctypes.data_as(_f64p), n)
    return out


def crt_lift_center(residues: np.ndarray, primes) -> np.ndarray:
    """Centered CRT reconstruction of (L, n) residues -> float64: in C++
    with unsigned __int128 while Q = prod(primes) < 2^120 (at most four
    30-bit limbs), with exact Python ints above that.  The C++ conversion
    rounds hi * 2^64 + lo twice, so it equals the Python-int lift whenever
    the centered value is below 2^53 in magnitude."""
    residues = np.ascontiguousarray(residues, np.uint32)
    if residues.ndim != 2 or residues.shape[0] != len(primes):
        raise ValueError(f"residues of shape {residues.shape} for "
                         f"{len(primes)} primes")
    L, n = residues.shape
    Q = 1
    for q in primes:
        Q *= int(q)
    if Q >= 1 << 120:
        # imported here: the ckks package imports this module
        from ..ckks.encoding import crt_lift_center as exact
        return exact(residues, primes)
    whi = np.empty(L, np.uint64)
    wlo = np.empty(L, np.uint64)
    for i, q in enumerate(primes):
        qi = int(q)
        Qi = Q // qi
        w = (Qi * pow(Qi % qi, qi - 2, qi)) % Q
        whi[i] = w >> 64
        wlo[i] = w & ((1 << 64) - 1)
    out = np.empty(n, np.float64)
    get_lib().crt_lift_center(residues.ctypes.data_as(_u32p), L, n,
                              whi.ctypes.data_as(_u64p),
                              wlo.ctypes.data_as(_u64p),
                              Q >> 64, Q & ((1 << 64) - 1),
                              out.ctypes.data_as(_f64p))
    return out


def write_blob(path: str, arr: np.ndarray) -> bool:
    """A page file: a u64 count, the u32 values, their CRC-32.  True when
    written."""
    arr = np.ascontiguousarray(arr, np.uint32).reshape(-1)
    rc = get_lib().write_blob_u32(os.fsencode(path),
                                  arr.ctypes.data_as(_u32p), arr.size)
    return rc == 0


def read_blob(path: str) -> np.ndarray:
    """A page file's u32 values; IOError on a short file or a CRC
    mismatch."""
    lib = get_lib()
    name = os.fsencode(path)
    n = lib.read_blob_u32(name, None, 0)
    if n < 0:
        raise IOError(f"read_blob_u32({path}) -> {n}")
    if os.path.getsize(path) != 12 + 4 * n:    # before allocating n values
        raise IOError(f"page file {path}: {os.path.getsize(path)} bytes "
                      f"for {n} pages")
    out = np.empty(n, np.uint32)
    rc = lib.read_blob_u32(name, out.ctypes.data_as(_u32p), n)
    if rc == -3:
        raise IOError(f"crc mismatch in {path}")
    if rc < 0:
        raise IOError(f"read_blob_u32({path}) -> {rc}")
    return out
