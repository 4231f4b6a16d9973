"""ctypes loader for the kthost native host runtime.

Builds ``libkthost.so`` from ``kthost.cpp`` on first use (g++ -O3, cached
by source mtime) and exposes the C ABI. Every consumer treats ``lib()``
returning ``None`` as "fall back to the pure-Python path", so the
framework stays fully functional without a toolchain.

Set KMERTOOLS_NO_NATIVE=1 to force the Python paths (used by tests to
cover both).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "kthost.cpp")
_SO = os.path.join(_HERE, "libkthost.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

c_i64 = ctypes.c_int64
c_i64_p = ctypes.POINTER(ctypes.c_int64)
c_i32_p = ctypes.POINTER(ctypes.c_int32)
c_u8_p = ctypes.POINTER(ctypes.c_uint8)
c_u64_p = ctypes.POINTER(ctypes.c_uint64)
c_char_pp = ctypes.POINTER(ctypes.c_char_p)


def out_buf(cap: int):
    """(array, c_char_p) uninitialised output buffer for the native
    text emitters. ctypes.create_string_buffer memsets its whole
    capacity — pure waste for buffers the native side overwrites (the
    zeroing alone cost ~0.5 s per cgr block). Callers slice the array
    to the emitter's returned length (``arr[:n].tobytes()`` or a
    memoryview)."""
    import numpy as np

    arr = np.empty(cap, dtype=np.uint8)
    return arr, arr.ctypes.data_as(ctypes.c_char_p)


def _build() -> bool:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return True
    # per-process temporary: concurrent first imports (test workers)
    # must not interleave writes into one half-built file
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(
            [
                "g++", "-O3", "-march=native", "-std=c++17", "-shared",
                "-fPIC", "-pthread", _SRC, "-o", tmp, "-lz",
            ],
            capture_output=True,
            text=True,
            timeout=300,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        r = None
        err = str(e)
    if r is not None and r.returncode == 0:
        os.replace(tmp, _SO)
        return True
    if r is not None:
        err = r.stderr
    try:
        os.unlink(tmp)
    except OSError:
        pass
    # say why once: a silent failure turns off every host fast path
    import sys

    print(
        f"kmertools_jax: native runtime build failed; using the Python "
        f"paths.\n{err.strip()[-4000:]}",
        file=sys.stderr,
    )
    # a wheel-shipped .so (setup.py build hook) is still usable even if
    # it looks stale by mtime
    return os.path.exists(_SO)


_ABI_VERSION = 7


def _bind(so: ctypes.CDLL) -> ctypes.CDLL:
    # probe first: a stale wheel-shipped .so without the symbol raises
    # AttributeError (caught by lib()); an older version is rejected
    # before any signature-mismatched call can happen
    so.kt_abi_version.restype = ctypes.c_int
    so.kt_abi_version.argtypes = []
    if so.kt_abi_version() != _ABI_VERSION:
        raise AttributeError("kthost ABI version mismatch")
    so.kt_batcher_open.restype = ctypes.c_void_p
    so.kt_batcher_open.argtypes = [
        ctypes.c_char_p, c_i64, c_i64_p, ctypes.c_int, c_i64, ctypes.c_int,
    ]
    so.kt_batcher_open_range.restype = ctypes.c_void_p
    so.kt_batcher_open_range.argtypes = [
        ctypes.c_char_p, c_i64, c_i64_p, ctypes.c_int, c_i64, ctypes.c_int,
        c_i64, c_i64,
    ]
    so.kt_batcher_close.argtypes = [ctypes.c_void_p]
    so.kt_batcher_next.restype = ctypes.c_int
    so.kt_batcher_next.argtypes = [ctypes.c_void_p]
    so.kt_bucket_shape.argtypes = [
        ctypes.c_void_p, ctypes.c_int, c_i64_p, c_i64_p, c_i64_p,
    ]
    so.kt_bucket_data.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(c_u8_p), ctypes.POINTER(c_i32_p),
        ctypes.POINTER(c_i64_p), ctypes.POINTER(c_i64_p),
        ctypes.POINTER(c_u8_p), ctypes.POINTER(ctypes.c_char_p),
        c_i64_p, ctypes.POINTER(c_i64_p), ctypes.POINTER(c_i64_p), c_i64_p,
    ]
    so.kt_merge_sum_kv.restype = c_i64
    so.kt_merge_sum_kv.argtypes = [
        ctypes.POINTER(c_u64_p), ctypes.POINTER(c_u64_p), c_i64_p, c_i64,
        c_u64_p, c_u64_p,
    ]
    so.kt_merge_sorted_kv.restype = ctypes.c_int
    so.kt_merge_sorted_kv.argtypes = [
        ctypes.POINTER(c_u64_p), ctypes.POINTER(c_u64_p), c_i64_p, c_i64,
        c_u64_p, c_u64_p,
    ]
    so.kt_radix_argsort_u64.restype = ctypes.c_int
    so.kt_radix_argsort_u64.argtypes = [
        c_u64_p, c_i64, ctypes.c_int, c_i64_p,
    ]
    so.kt_seq_stats.restype = ctypes.c_int
    so.kt_seq_stats.argtypes = [
        ctypes.c_char_p, c_i64_p, c_i64_p, ctypes.c_int,
    ]
    so.kt_format_fixed6.restype = c_i64
    so.kt_format_fixed6.argtypes = [
        ctypes.POINTER(ctypes.c_double), c_i64, c_i64, ctypes.c_char,
        ctypes.c_char_p,
    ]
    so.kt_format_counts.restype = c_i64
    so.kt_format_counts.argtypes = so.kt_format_fixed6.argtypes
    so.kt_emit_oligo_norm.restype = c_i64
    so.kt_emit_oligo_norm.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int32),
        c_i64, c_i64, ctypes.c_char, ctypes.c_char_p,
    ]
    so.kt_format_counts_i16.restype = c_i64
    so.kt_format_counts_i16.argtypes = [
        ctypes.POINTER(ctypes.c_int16), c_i64, c_i64, ctypes.c_char,
        ctypes.c_char_p,
    ]
    so.kt_format_u64_tsv.restype = c_i64
    so.kt_format_u64_tsv.argtypes = [c_u64_p, c_u64_p, c_i64, ctypes.c_char_p]
    so.kt_parse_u64_tsv.restype = c_i64
    so.kt_parse_u64_tsv.argtypes = [
        ctypes.c_char_p, c_i64, c_u64_p, c_u64_p,
    ]
    so.kt_format_acgt_tsv.restype = c_i64
    so.kt_format_acgt_tsv.argtypes = [
        c_u64_p, c_u64_p, c_i64, ctypes.c_int, ctypes.c_char_p,
    ]
    so.kt_format_cgr.restype = c_i64
    so.kt_format_cgr.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        c_i32_p, c_i64, c_i64, ctypes.c_char_p, c_i64,
    ]
    so.kt_format_s2m.restype = c_i64
    so.kt_format_s2m.argtypes = [
        c_u64_p, c_i64_p, c_i64_p, c_i64_p,
        ctypes.c_char_p, c_i64_p, c_i64, ctypes.c_int,
        ctypes.c_char_p, c_i64,
    ]
    so.kt_format_m2s.restype = c_i64
    so.kt_format_m2s.argtypes = [
        c_u64_p, c_i64_p, c_i64_p, c_i64_p, c_i64_p,
        ctypes.c_char_p, c_i64_p, c_i64, ctypes.c_int,
        ctypes.c_char_p, c_i64,
    ]
    so.kt_pack_planes.restype = c_i64
    so.kt_pack_planes.argtypes = [
        c_u8_p, c_i64, c_i64, c_i32_p, c_u8_p, c_u8_p,
    ]
    so.kt_oligo_hist.restype = ctypes.c_int
    so.kt_oligo_hist.argtypes = [
        c_u8_p, c_u8_p, c_i64, c_i64, ctypes.c_int32,
        c_i32_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int16), c_i32_p, ctypes.c_int32, c_i64,
    ]
    so.kt_cov_hist.restype = ctypes.c_int
    so.kt_cov_hist.argtypes = [
        c_u8_p, c_u8_p, c_i64, c_i64, ctypes.c_int32,
        c_u64_p, c_i32_p, c_i64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int16), c_i32_p, ctypes.c_int32,
    ]
    so.kt_cov_hist_idx.restype = ctypes.c_int
    so.kt_cov_hist_idx.argtypes = [
        c_u8_p, c_u8_p, c_i64, c_i64, ctypes.c_int32,
        c_u64_p, c_i32_p, c_i64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int16), c_i32_p, ctypes.c_int32, c_i64,
    ]
    so.kt_min_batch.restype = ctypes.c_int
    so.kt_min_batch.argtypes = [
        c_u8_p, c_u8_p, c_i64, c_i64, c_i32_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        c_i64_p, c_u64_p, c_i64_p, c_i64_p, c_i64_p,
    ]
    so.kt_ctr_new.restype = ctypes.c_void_p
    so.kt_ctr_new.argtypes = [ctypes.c_int32, c_i64, ctypes.c_int32]
    so.kt_ctr_free.argtypes = [ctypes.c_void_p]
    so.kt_ctr_add.restype = c_i64
    so.kt_ctr_add.argtypes = [ctypes.c_void_p, c_u8_p, c_u8_p, c_i64, c_i64]
    so.kt_ctr_freeze.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    so.kt_ctr_part_len.restype = c_i64
    so.kt_ctr_part_len.argtypes = [ctypes.c_void_p, c_i64]
    so.kt_ctr_drain_part.restype = c_i64
    so.kt_ctr_drain_part.argtypes = [
        ctypes.c_void_p, c_i64, c_u64_p, c_u64_p,
    ]
    so.kt_format_oligocgr.restype = c_i64
    so.kt_format_oligocgr.argtypes = [
        ctypes.c_char_p, c_i32_p, c_i64,
        ctypes.POINTER(ctypes.c_double), c_i64, ctypes.c_char_p, c_i64,
    ]
    return so


def lib() -> ctypes.CDLL | None:
    """The loaded native library, or None when unavailable/disabled."""
    global _lib, _tried
    if os.environ.get("KMERTOOLS_NO_NATIVE"):
        return None
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            if _build():
                try:
                    _lib = _bind(ctypes.CDLL(_SO))
                except (OSError, AttributeError):
                    # AttributeError: a stale wheel-shipped .so missing
                    # newer symbols (no toolchain to rebuild) — treat
                    # native as unavailable rather than crashing
                    _lib = None
            _tried = True
    return _lib
