"""Minimiser kernels: vectorised sliding-window minima.

The reference scans each read with a monotone-buffer state machine
(kmer/src/minimiser.rs:61-175). Its emitted records are fully
determined by the *value* sequence of per-window canonical-m-mer
minima:

  * the "active minimiser" after any window equals that window's min
    value (ties never emit: minimiser.rs:129 equal-rescan and the
    else-branch at :150-151 keep the active value unchanged), so
  * records are maximal runs of equal window-min values within
    segments of N-free windows, with end = last_window_of_run + wsize
    (flush-at-N minimiser.rs:81-102 and end-of-seq :168-171 both land
    on the same formula), and
  * a run consisting solely of the final window of the read is dropped
    when its boundary was a value change (the early return at
    minimiser.rs:137/:149 skips the end-of-seq emission), and
  * a trailing N-free segment shorter than wsize but >= msize emits the
    u64::MAX sentinel (buffer never fills; :159 never initialises
    m_active; :168-171 emits it anyway), which prints as all-T.

On the device the window minimum is a log-doubling tournament over (hi, lo)
uint32 canonical m-mer pairs — O(log W) fused vector passes, no
sequential state. Run extraction happens on the host over flat numpy
arrays (ops at C speed, no per-window Python).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from kmertools_jax.ops.encode import canonical_ids_pair

_SENT = jnp.uint32(0xFFFFFFFF)


def _shift_left(x: jnp.ndarray, step: int, fill) -> jnp.ndarray:
    """x[:, i] <- x[:, i+step], tail filled."""
    pad = jnp.full((x.shape[0], step), fill, dtype=x.dtype)
    return jnp.concatenate([x[:, step:], pad], axis=1)


@functools.partial(jax.jit, static_argnames=("m", "wsize"))
def window_min(codes: jnp.ndarray, m: int, wsize: int):
    """Sliding canonical-m-mer minimum over windows of `wsize` bases.

    codes: (R, Wrow) uint8. Returns (wmin_hi, wmin_lo, wvalid) with
    J = Wrow - wsize + 1 columns; window j covers bases [j, j+wsize).
    wvalid[j] = all m-mers in the window valid (implies in-bounds,
    since padding bases are code 4).
    """
    assert wsize >= m
    W = wsize - m + 1  # m-mers per window
    hi, lo, valid = canonical_ids_pair(codes, m)  # invalid -> sentinel
    v = valid.astype(jnp.uint32)
    s = 1
    while s < W:
        step = min(s, W - s)
        h2 = _shift_left(hi, step, _SENT)
        l2 = _shift_left(lo, step, _SENT)
        v2 = _shift_left(v, step, jnp.uint32(0))
        take2 = (h2 < hi) | ((h2 == hi) & (l2 < lo))
        hi = jnp.where(take2, h2, hi)
        lo = jnp.where(take2, l2, lo)
        v = v & v2
        s += step
    J = codes.shape[1] - wsize + 1
    return hi[:, :J], lo[:, :J], (v[:, :J] != 0)


@functools.partial(jax.jit, static_argnames=("m", "wsize"))
def window_min_fused(codes: jnp.ndarray, m: int, wsize: int):
    """m <= 15 wire-size variant: one (R, J) uint32 plane carrying the
    window minimum with 0xFFFFFFFF for invalid windows (valid minima
    are < 4^15, so the sentinel is unambiguous). Halves the
    device->host transfer vs the (hi, lo, valid) triple."""
    assert m <= 15
    hi, lo, valid = window_min(codes, m, wsize)
    del hi  # all zeros for m <= 16
    return jnp.where(valid, lo, _SENT)


@functools.partial(jax.jit, static_argnames=("m",))
def whole_read_min(codes: jnp.ndarray, m: int):
    """Global canonical m-mer minimum per row (wsize==0 mode: one
    window spanning the whole read, misc/src/minimisers.rs:44-48).

    Returns (min_hi, min_lo): sentinel pair when no valid m-mer.
    """
    hi, lo, _ = canonical_ids_pair(codes, m)
    min_hi = jnp.min(hi, axis=1)
    lo_masked = jnp.where(hi == min_hi[:, None], lo, _SENT)
    min_lo = jnp.min(lo_masked, axis=1)
    return min_hi, min_lo


def _shift_right(x: jnp.ndarray, fill) -> jnp.ndarray:
    """x[:, i] <- x[:, i-1], column 0 filled."""
    pad = jnp.full((x.shape[0], 1), fill, dtype=x.dtype)
    return jnp.concatenate([pad, x[:, :-1]], axis=1)


@functools.partial(jax.jit, static_argnames=("m", "wsize"))
def window_records(codes: jnp.ndarray, lengths: jnp.ndarray, m: int,
                   wsize: int):
    """Device-side record extraction for complete single-row reads:
    window minima AND the run/boundary analysis of extract_records in
    one jitted program, so the host only gathers marked positions
    (np.nonzero + fancy index) instead of re-deriving runs in numpy
    (VERDICT r4 item 5).

    Returns row-aligned (R, J) arrays (J = W - wsize + 1):
      keep:  record starts (the reference's emission boundaries incl.
             the final-window drop rule, kmer/src/minimiser.rs:114-171)
      hi/lo: canonical window minima (the record value at kept cols);
             for m <= 16 the hi plane is identically zero and is
             returned as a (R, 1) placeholder (callers treat hi as 0)
      lastw: the run's final window column (record end = lastw +
             wsize), int16 (rows are <= 8192 windows wide)

    Everything is an axis-1 (row-local) scan/shift, so the program
    row-shards over the mesh unchanged (data_parallel_rows)."""
    hi, lo, wv = window_min(codes, m, wsize)
    R, J = hi.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (R, J), 1)
    j_row = jnp.maximum(0, lengths.astype(jnp.int32) - wsize + 1)
    v = wv & (col < j_row[:, None])
    pv = _shift_right(v, False)
    ph = _shift_right(hi, 0)
    pl_ = _shift_right(lo, 0)
    diff = (hi != ph) | (lo != pl_)
    boundary = v & (~pv | diff)
    change = v & pv & diff
    big = jnp.int32(J)
    inv_pos = jnp.where(~v, col, big)
    seg_last = (
        jax.lax.associative_scan(jnp.minimum, inv_pos, reverse=True, axis=1)
        - 1
    )
    bpos = jnp.where(boundary, col, big)
    nb_incl = jax.lax.associative_scan(jnp.minimum, bpos, reverse=True, axis=1)
    nb = _shift_left(nb_incl, 1, big)  # next boundary strictly after j
    lastw = jnp.minimum(nb - 1, seg_last)
    final_j = (j_row - 1)[:, None]
    drop = boundary & change & (col == final_j) & (lastw == col)
    keep = boundary & ~drop
    if m <= 16:  # hi plane is identically zero: don't materialise it
        hi = jnp.zeros((R, 1), jnp.uint32)
    return keep, hi, lo, lastw.astype(jnp.int16)


def extract_records(wmin_hi, wmin_lo, wvalid, lengths, wsize: int, m: int,
                    span: int | None = None):
    """Host-side run extraction over a flat batch.

    Inputs are per-read stitched numpy arrays flattened with one
    always-invalid separator window between reads:
      wmin_hi/lo: uint32 (T,), wvalid: bool (T,)
      lengths: (B,) read lengths; read b owns J_b = max(0, len_b-wsize+1)
      windows at flat offset off_b (with separators accounted).
      span: when given, every read occupies exactly `span` flat slots
      (a raveled fixed-width (B, span) layout with windows beyond J_b
      marked invalid) instead of the packed J_b+1 layout.

    Returns (read_of_record, value_u64, start, end) arrays, in read
    order then window order; the MAX-sentinel records are NOT included
    (callers add them from trailing-run info).
    """
    import numpy as np

    T = len(wvalid)
    if T == 0:
        return (np.empty(0, np.int64),) * 4
    prev_valid = np.empty_like(wvalid)
    prev_valid[0] = False
    prev_valid[1:] = wvalid[:-1]
    ph = np.empty_like(wmin_hi)
    ph[0] = 0
    ph[1:] = wmin_hi[:-1]
    pl = np.empty_like(wmin_lo)
    pl[0] = 0
    pl[1:] = wmin_lo[:-1]
    diff = (wmin_hi != ph) | (wmin_lo != pl)
    boundary = wvalid & (~prev_valid | diff)
    change_type = wvalid & prev_valid & diff
    starts = np.flatnonzero(boundary)
    if len(starts) == 0:
        return (np.empty(0, np.int64),) * 4

    idx = np.arange(T, dtype=np.int64)
    inv_pos = np.where(~wvalid, idx, T)
    nxt_inv = np.minimum.accumulate(inv_pos[::-1])[::-1]
    seg_last = nxt_inv - 1  # last valid window of the segment containing j
    next_boundary = np.append(starts[1:], T)
    run_last = np.minimum(next_boundary - 1, seg_last[starts])

    # map flat windows back to reads
    J = np.maximum(0, lengths.astype(np.int64) - wsize + 1)
    spans = (J + 1) if span is None else np.full(len(J), span, np.int64)
    offsets = np.concatenate([[0], np.cumsum(spans)])[:-1]
    read_of = np.searchsorted(offsets, starts, side="right") - 1
    local_start = starts - offsets[read_of]
    local_last = run_last - offsets[read_of]

    # drop rule: run == exactly the read's final window, change boundary
    final_j = J[read_of] - 1
    drop = (local_start == final_j) & (local_last == final_j) & change_type[starts]
    keep = ~drop

    nlo = min(m, 16)
    value = (wmin_hi[starts].astype(np.uint64) << np.uint64(2 * nlo)) | wmin_lo[
        starts
    ].astype(np.uint64)
    return (
        read_of[keep],
        value[keep],
        local_start[keep],
        (local_last + wsize)[keep],
    )
