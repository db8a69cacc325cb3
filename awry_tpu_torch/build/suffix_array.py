"""Host suffix-array construction and the native build helpers.

Binds ``native/sais.cpp`` (SA-IS, the BWT byte gather, the k-mer table
histogram/fill) through ctypes.  The library compiles with
``g++ -O3 -fopenmp`` at first use into ``awry_tpu_torch/_build/`` (named by
the source's content hash, so an edited source rebuilds).  A failed compile
raises: there is no slower stand-in.

The suffix array of a sentinel-terminated text is unique, so the BWT and
every query result are bit-exact whatever produced it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native", "sais.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

_lock = threading.Lock()
_lib_handle = None

_P_U8 = ctypes.POINTER(ctypes.c_uint8)
_P_U32 = ctypes.POINTER(ctypes.c_uint32)


def _lib():
    """Compile (once per source version) and load the native helpers."""
    global _lib_handle
    with _lock:
        if _lib_handle is not None:
            return _lib_handle
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        path = os.path.join(BUILD_DIR, f"libawrysais-{digest}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # Temp path + atomic rename: concurrent test workers may build
            # at once, and a half-written .so must never be loaded.
            tmp = f"{path}.tmp.{os.getpid()}"
            cmd = ["g++", "-O3", "-std=c++17", "-fopenmp", "-shared", "-fPIC", "-o", tmp, _SRC]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.awry_gather_u8.argtypes = [_P_U8, ctypes.POINTER(ctypes.c_int64), _P_U8, ctypes.c_int64]
        lib.awry_gather_u8_u32.argtypes = [_P_U8, _P_U32, _P_U8, ctypes.c_int64]
        lib.awry_kmer_hist_u32.argtypes = [_P_U32, ctypes.c_int64, _P_U32, ctypes.c_int64]
        lib.awry_kmer_fill_u32.argtypes = [_P_U32, _P_U32, ctypes.c_int64, _P_U32, ctypes.c_int64]
        lib.awry_sais_i32.argtypes = [_P_U8, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
        lib.awry_sais_u32.argtypes = [_P_U8, ctypes.c_uint32, _P_U32]
        lib.awry_sais_i64.argtypes = [_P_U8, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        _lib_handle = lib
        return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def build_suffix_array(text: np.ndarray | bytes) -> np.ndarray:
    """Suffix array of ``text + [0x00 sentinel]``, in the narrowest integer
    dtype that holds it (int32 below 2^31, uint32 below 2^32-1, else int64).
    ``text`` holds canonical bytes WITHOUT the sentinel; sa[0] == len(text)."""
    arr = np.frombuffer(text, dtype=np.uint8) if isinstance(text, (bytes, bytearray)) else np.asarray(text, dtype=np.uint8)
    if arr.ndim != 1:
        raise ValueError("text must be 1-D bytes")
    if arr.size and arr.min() == 0:
        raise ValueError("text must not contain the 0x00 sentinel byte")
    n = arr.size + 1
    buf = np.empty(n, dtype=np.uint8)
    buf[:-1] = arr
    buf[-1] = 0
    lib = _lib()
    if n <= np.iinfo(np.int32).max:
        sa = np.empty(n, dtype=np.int32)
        rc = lib.awry_sais_i32(_ptr(buf, ctypes.c_uint8), n, _ptr(sa, ctypes.c_int32))
    elif n < np.iinfo(np.uint32).max:
        sa = np.empty(n, dtype=np.uint32)
        rc = lib.awry_sais_u32(_ptr(buf, ctypes.c_uint8), n, _ptr(sa, ctypes.c_uint32))
    else:
        sa = np.empty(n, dtype=np.int64)
        rc = lib.awry_sais_i64(_ptr(buf, ctypes.c_uint8), n, _ptr(sa, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"native SA-IS failed with code {rc}")
    return sa


def gather_u8(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Parallel dst[i] = src[idx[i]] for uint8 src; int32/uint32 indices take
    the 4-byte path (no int64 widening temporary)."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    dst = np.empty(idx.shape[0], dtype=np.uint8)
    if idx.dtype in (np.int32, np.uint32):
        # int32 values are non-negative positions, bit-identical as uint32.
        idx = np.ascontiguousarray(idx).view(np.uint32)
        _lib().awry_gather_u8_u32(_ptr(src, ctypes.c_uint8), _ptr(idx, ctypes.c_uint32),
                                  _ptr(dst, ctypes.c_uint8), idx.shape[0])
    else:
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        _lib().awry_gather_u8(_ptr(src, ctypes.c_uint8), _ptr(idx, ctypes.c_int64),
                              _ptr(dst, ctypes.c_uint8), idx.shape[0])
    return dst


def kmer_hist_native(addr: np.ndarray, cnt: np.ndarray) -> None:
    """Accumulate the k-mer address histogram into caller-owned uint32 ``cnt``
    (one chunk of the address stream per call)."""
    addr = np.ascontiguousarray(addr, dtype=np.uint32)
    _lib().awry_kmer_hist_u32(_ptr(addr, ctypes.c_uint32), addr.shape[0],
                              _ptr(cnt, ctypes.c_uint32), cnt.shape[0])


def kmer_fill_native(cnt: np.ndarray, inserts: np.ndarray) -> np.ndarray:
    """Scan + seed-table fill from the accumulated histogram; ``inserts``
    must be SORTED ascending.  Returns uint32[total, 2]."""
    total = cnt.shape[0]
    inserts = np.ascontiguousarray(inserts, dtype=np.uint32)
    table = np.empty((total, 2), dtype=np.uint32)
    rc = _lib().awry_kmer_fill_u32(_ptr(cnt, ctypes.c_uint32), _ptr(inserts, ctypes.c_uint32),
                                   inserts.shape[0], _ptr(table, ctypes.c_uint32), total)
    if rc != 0:
        raise RuntimeError(f"native kmer fill failed with code {rc}")
    return table
