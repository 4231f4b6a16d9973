"""Text formatting that byte-matches the reference CLI output.

The reference emits:
  * normalised vectors with Rust ``{:.6}``   (composition/src/oligo.rs:134)
  * raw counts / CGR points with Rust ``{}`` f64 Display
    (composition/src/oligo.rs:136, cgr.rs:99, oligocgr.rs:95)

Rust's f64 Display prints the shortest decimal that round-trips, always
in positional notation, and drops the ``.0`` on integral values.
Python's ``repr`` is also shortest-round-trip but switches to scientific
notation and keeps ``.0`` — `rust_f64_repr` bridges the two.

``{:.6}`` and Python's ``%.6f`` both produce the correctly-rounded
6-place decimal of the f64 value; exact ties are impossible (a tie
would require the value to be an odd multiple of 5e-7, which is not a
dyadic rational), so the outputs are byte-identical.
"""

from __future__ import annotations

import math
from decimal import Decimal

import numpy as np


def rust_f64_repr(x: float) -> str:
    """Format an f64 exactly like Rust's `{}` Display."""
    x = float(x)
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    if x == int(x):
        # integral: Rust drops the trailing ".0"; sign of -0.0 is kept
        if x == 0.0 and math.copysign(1.0, x) < 0:
            return "-0"
        return str(int(x))
    r = repr(x)
    if "e" in r or "E" in r:
        # expand scientific notation to positional, keeping the same digits
        r = format(Decimal(r), "f")
    return r


def format_fixed6(values: np.ndarray, delim: str) -> bytes:
    """Render a 2-D array of normalised f64 values as ``{:.6}`` lines.

    All values live in [0, 1] (count / max(1, total)), so each renders
    to exactly 8 characters ("d.dddddd"). We format each *unique* value
    once through the CPython correctly-rounded formatter, then assemble
    rows with fixed-width numpy views — C speed for arbitrarily many
    reads.
    """
    values = np.asarray(values, dtype=np.float64)
    nrows, ncols = values.shape
    if nrows == 0:
        return b""
    if len(delim) == 1:
        import ctypes

        from kmertools_jax import native

        so = native.lib()
        if so is not None:
            vals = np.ascontiguousarray(values)
            cap = nrows * ncols * 9
            arr, buf = native.out_buf(cap)
            n = so.kt_format_fixed6(
                vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                nrows, ncols, delim.encode(), buf,
            )
            if n == cap:
                return arr.tobytes()
            # n == -1: a value rendered wider than 8 chars — Python fallback
    uniq, inv = np.unique(values, return_inverse=True)
    lut = np.array([f"{v:.6f}".encode() for v in uniq], dtype="S8")
    cells = lut[inv.reshape(nrows, ncols)]
    width = 8 + len(delim)
    out = np.empty((nrows, ncols), dtype=f"S{width}")
    # numpy S-type assignment pads with NULs, so build via byte planes
    plane = out.view(np.uint8).reshape(nrows, ncols, width)
    plane[:, :, :8] = cells.view(np.uint8).reshape(nrows, ncols, 8)
    dbytes = np.frombuffer(delim.encode(), dtype=np.uint8)
    plane[:, :, 8:] = dbytes
    plane[:, -1, 8:] = np.frombuffer(b"\n", dtype=np.uint8)[: width - 8]
    if len(delim) != 1:  # pragma: no cover - presets are single-char
        raise ValueError("delimiters must be single characters")
    return plane.tobytes()


def emit_norm_slab(counts: np.ndarray, totals: np.ndarray, delim: str) -> bytes:
    """Normalised {:.6} rows from a completed-read slab.

    Fused native path when counts are still raw device int16 (no f64
    intermediates); otherwise divides in f64 and formats. Both produce
    the bytes of ``count / max(1, total)`` per cell.
    """
    if (
        len(delim) == 1
        and counts.dtype == np.int16
        and counts.size
    ):
        import ctypes

        from kmertools_jax import native

        so = native.lib()
        if so is not None:
            c = np.ascontiguousarray(counts)
            t = np.ascontiguousarray(totals, dtype=np.int32)
            nrows, ncols = c.shape
            cap = nrows * ncols * 9
            arr, buf = native.out_buf(cap)
            n = so.kt_emit_oligo_norm(
                c.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                nrows, ncols, delim.encode(), buf,
            )
            if n == cap:
                return arr.tobytes()
    vecs = counts.astype(np.float64) / np.maximum(
        1.0, totals.astype(np.float64)
    )[:, None]
    return format_fixed6(vecs, delim)


def emit_count_slab(counts: np.ndarray, delim: str) -> bytes:
    """Raw integer rows from a completed-read slab (unnormalised path)."""
    if len(delim) == 1 and counts.dtype == np.int16 and counts.size:
        import ctypes

        from kmertools_jax import native

        so = native.lib()
        if so is not None:
            c = np.ascontiguousarray(counts)
            nrows, ncols = c.shape
            arr, buf = native.out_buf(nrows * ncols * 8)
            n = so.kt_format_counts_i16(
                c.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                nrows, ncols, delim.encode(), buf,
            )
            return arr[:n].tobytes()
    return format_counts(counts, delim)


def format_counts(values: np.ndarray, delim: str) -> bytes:
    """Render raw integer count vectors like Rust `{}` on whole f64s."""
    values = np.asarray(values)
    if len(delim) == 1 and values.ndim == 2 and values.size:
        import ctypes

        from kmertools_jax import native

        so = native.lib()
        if so is not None:
            vals = np.ascontiguousarray(values, dtype=np.float64)
            nrows, ncols = vals.shape
            arr, buf = native.out_buf(nrows * ncols * 21)
            n = so.kt_format_counts(
                vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                nrows, ncols, delim.encode(), buf,
            )
            return arr[:n].tobytes()
    lines = []
    for row in values:
        lines.append(delim.join(str(int(v)) for v in row))
    return ("\n".join(lines) + "\n").encode() if lines else b""
