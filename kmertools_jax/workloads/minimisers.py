"""Minimiser binning workloads (misc/src/minimisers.rs analog).

Two output modes (kmertools `min` subcommand, args.rs:177-205):
  * s2m (`seq_to_min`, minimisers.rs:87-160): one line per read,
    ``id\\tMIN:s-e\\tMIN:s-e\\t\\n`` (the reference joins a trailing
    "\\n" element with tabs, so a tab precedes the newline — we match
    those bytes exactly).
  * m2s (`bin_sequences`, minimisers.rs:11-85): reads grouped by
    minimiser, ``MIN\\t[("id", s, e), ...]\\n`` (Rust Debug format of
    Vec<(String, usize, usize)>). The reference's concurrent-map scan
    order is nondeterministic; we write sorted by minimiser, a
    deterministic member of the same equivalence class (its tests sort
    before comparing: minimisers.rs:169-187).

wsize == 0 means "window = whole read" (one minimiser per read,
minimisers.rs:44-48).
"""

from __future__ import annotations

import numpy as np

from kmertools_jax.io import batch as iob
from kmertools_jax.ops import minimiser as mops
from kmertools_jax.utils import codec
from kmertools_jax.workloads.common import OrderedEmitter

# device dispatches this process (observability for tests and the chip
# smoke asserting the device path ran): window-min / whole-read kernels,
# and device record extraction (ops/minimiser.py:window_records)
DEVICE_KERNEL_RUNS = 0
DEVICE_EXTRACT_RUNS = 0

def _row_trail(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Per row: length of the trailing run of valid bases in [0, len)."""
    R, W = codes.shape
    pos = np.arange(W, dtype=np.int64)
    bad = (codes >= 4) & (pos[None, :] < lengths[:, None])
    last_bad = np.where(bad, pos[None, :], -1).max(axis=1)
    return lengths.astype(np.int64) - 1 - last_bad


def _tuple_recs(recs: list) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(value, start, end) tuples -> flat array triple (emit contract)."""
    if not recs:
        z = np.empty(0, np.int64)
        return np.empty(0, np.uint64), z, z
    arr = np.array(recs, dtype=np.uint64)
    return arr[:, 0], arr[:, 1].astype(np.int64), arr[:, 2].astype(np.int64)


def _row_has_bad(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    pos = np.arange(codes.shape[1], dtype=np.int64)
    bad = (codes >= 4) & (pos[None, :] < lengths[:, None])
    return bad.any(axis=1)


class _ReadState:
    __slots__ = ("rows_h", "rows_l", "rows_v", "length", "trail", "has_bad",
                 "min_h", "min_l")

    def __init__(self):
        self.rows_h = []
        self.rows_l = []
        self.rows_v = []
        self.length = 0
        self.trail = 0
        self.has_bad = False
        self.min_h = 0xFFFFFFFF
        self.min_l = 0xFFFFFFFF


def _native_min_scanner(msize: int, wsize: int, threads: int = 0):
    """The native per-batch minimiser scanner (kthost.cpp:kt_min_batch)
    when the host engine should run the scan. Returns ``(scan,
    short_only)``: ``scan`` is a callable (planes, lens) -> (offs,
    counts, vals, starts, ends) or None; ``short_only`` is True on
    accelerator backends, where the scanner serves ONLY short-read
    buckets (row width < _NATIVE_MIN_WIDTH).

    Routing rationale: CPU-only backends route everything native (the
    XLA window kernels share silicon with and lose to the C++ state
    machine; measured 0.77 s on 500k x 150 bp on a host CPU). A device
    whose probed RTT exceeds _COALESCE_RTT_S also routes everything
    native: the device path ships the window-min u32 plane (~1 word per
    position vs ~0.07 records/position), so every round trip stalls
    it. A device below that RTT keeps the device path for contig
    buckets (rows >= _NATIVE_MIN_WIDTH); short buckets stay native
    (per-row fixed costs dominate them). On the GPU the split is not
    measured yet."""
    import os as _os

    import jax as _jax

    from kmertools_jax import native as _nat
    from kmertools_jax.workloads.common import (
        _COALESCE_RTT_S,
        probe_device_rtt,
    )

    if _os.environ.get("KMERTOOLS_NO_HETERO") == "1" or msize > 31:
        return None, False
    so = _nat.lib()
    if so is None:
        return None, False
    devs = _jax.local_devices()
    accel = bool(devs) and devs[0].platform != "cpu"
    short_only = accel and probe_device_rtt(devs[0]) <= _COALESCE_RTT_S
    nthreads = threads or (_os.cpu_count() or 1)

    # grow-only output buffers, reused across batches: fresh np.empty
    # per batch meant ~58 MB of new pages faulting per 2M-code batch
    # (measured ~0.9 s of the short-read s2m wall); consumers either
    # gather (_compact_ranges) or .copy() slices, never retain views
    buf: dict = {"cap": -1, "n": -1}

    def scan(planes, lens: np.ndarray):
        packed, vb, _ = planes
        n = len(lens)
        packed = np.ascontiguousarray(packed[:n])
        vb = np.ascontiguousarray(vb[:n])
        lens32 = np.ascontiguousarray(lens, dtype=np.int32)
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens32.astype(np.int64) + 2, out=offs[1:])
        N = int(offs[-1])
        if buf["cap"] < N:
            buf["vals"] = np.empty(N, np.uint64)
            buf["starts"] = np.empty(N, np.int64)
            buf["ends"] = np.empty(N, np.int64)
            buf["cap"] = N
        if buf["n"] < n:
            buf["counts"] = np.empty(n, np.int64)
            buf["n"] = n
        vals = buf["vals"]
        starts = buf["starts"]
        ends = buf["ends"]
        counts = buf["counts"][:n]
        rc = so.kt_min_batch(
            packed.ctypes.data_as(_nat.c_u8_p),
            vb.ctypes.data_as(_nat.c_u8_p),
            n, packed.shape[1] * 4,
            lens32.ctypes.data_as(_nat.c_i32_p),
            msize, wsize, nthreads,
            offs.ctypes.data_as(_nat.c_i64_p),
            vals.ctypes.data_as(_nat.c_u64_p),
            starts.ctypes.data_as(_nat.c_i64_p),
            ends.ctypes.data_as(_nat.c_i64_p),
            counts.ctypes.data_as(_nat.c_i64_p),
        )
        if rc != 0 or (counts < 0).any():
            raise RuntimeError("kt_min_batch failed")
        return offs, counts, vals, starts, ends

    return scan, short_only


# accelerator backends: row-width threshold below which the native
# scanner takes the bucket (see _native_min_scanner's rationale)
_NATIVE_MIN_WIDTH = 1024


class _BlobIds:
    """Read-id sequence over a NUL-separated blob (the native batcher's
    wire format), yielding bytes slices on demand — the slab paths never
    pay a per-read str decode/encode round trip."""

    __slots__ = ("blob", "offs")

    def __init__(self, blob: bytes, offs: np.ndarray):
        self.blob = blob
        self.offs = offs  # int64 (n+1,); id i = blob[offs[i]:offs[i+1]-1]

    def __len__(self) -> int:
        return len(self.offs) - 1

    def __getitem__(self, i) -> bytes:
        return self.blob[self.offs[i]:self.offs[i + 1] - 1]


def _batch_ids_bytes(b: iob.Batch, rids: np.ndarray, n: int):
    """ids (as bytes) for rows 0..n-1 of an all-single-row batch."""
    raw = b.ids_raw()
    if raw is not None:
        blob, offs, ridx, _ = raw
        if len(ridx) == n and np.array_equal(ridx, rids):
            return _BlobIds(blob, offs)
    d = b.ids
    return [d[int(r)].encode() for r in rids]


def _stable_argsort_u64(a: np.ndarray, bits: int) -> np.ndarray:
    """Stable argsort of u64 values that fit ``bits`` bits: native LSD
    radix (kthost.cpp:kt_radix_argsort_u64, memory-speed) when
    available, numpy stable argsort otherwise — identical permutations
    (both stable)."""
    from kmertools_jax import native

    so = native.lib()
    if so is not None and len(a) >= (1 << 15):
        a_c = np.ascontiguousarray(a, dtype=np.uint64)
        out = np.empty(len(a), dtype=np.int64)
        rc = so.kt_radix_argsort_u64(
            a_c.ctypes.data_as(native.c_u64_p), len(a), int(bits),
            out.ctypes.data_as(native.c_i64_p),
        )
        if rc == 0:
            return out
    return np.argsort(a, kind="stable")


def _compact_ranges(offs: np.ndarray, counts: np.ndarray,
                    arrays: tuple) -> tuple:
    """Gather the used per-read ranges [offs[i], offs[i]+counts[i]) of
    each array into compact form; returns (new_offs, compacted...).
    Vectorised (no per-read Python): the record plumbing must not cost
    more than the scan (measured 3x the native kernel on short reads).
    """
    n = len(counts)
    new_offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=new_offs[1:])
    tot = int(new_offs[-1])
    if tot == 0:
        return new_offs, tuple(a[:0] for a in arrays)
    idx = np.repeat(offs[:n] - new_offs[:-1], counts) + np.arange(
        tot, dtype=np.int64
    )
    return new_offs, tuple(a[idx] for a in arrays)


def _minimise_stream(in_path: str, wsize: int, msize: int, emit,
                     target_codes=None, shard=None, threads: int = 0,
                     emit_slab=None):
    """Drive the scan kernels over the file; call emit(read_idx, id,
    read_len, records) with records = an array triple
    (values uint64[], starts int64[], ends int64[]).

    ``emit_slab(rids, ids, lens, offs, vals, starts, ends)`` (optional)
    receives WHOLE batches of complete single-row reads as flat record
    arrays (offs delimits read i's records) — the common case on
    short-read corpora, where per-read Python emits dominate the wall
    clock. Reads on fallback paths (split rows, carried state) still
    arrive via per-read ``emit``; rids within a slab are increasing but
    gappy across slabs when length buckets interleave."""
    target = target_codes or iob.DEFAULT_TARGET_CODES
    overlap = (wsize - 1) if wsize > 0 else (msize - 1)
    max_val = (1 << (2 * msize)) - 1  # u64::MAX masked to 2m bits: all-T
    nlo = min(msize, 16)

    states: dict[int, _ReadState] = {}
    meta: dict[int, tuple[bytes, int]] = {}
    native_scan, native_short_only = _native_min_scanner(
        msize, wsize, threads
    )

    # DP-shard every device kernel over the mesh (the all-threads
    # design of misc/src/minimisers.rs:30-70 mapped to chips); on one
    # device these are plain jitted kernels. Codes travel 2-bit packed
    # (+ valid plane only when a batch has ambiguous bases) and unpack
    # on-device.
    import jax as _jax

    from kmertools_jax.ops import encode as _enc
    from kmertools_jax.workloads.common import data_parallel_rows

    def _packed_pair(kernel):
        planes = data_parallel_rows(
            _jax.jit(lambda p, v: kernel(_enc.unpack_planes(p, v)))
        )
        clean = data_parallel_rows(
            _jax.jit(lambda p, ln: kernel(_enc.unpack_packed(p, ln)))
        )

        def call(b: iob.Batch):
            global DEVICE_KERNEL_RUNS
            DEVICE_KERNEL_RUNS += 1
            packed, vb, n_ambig = b.planes()
            if n_ambig == 0:
                return clean(packed, b.lengths)
            return planes(packed, vb)

        return call

    dp_whole_min = _packed_pair(lambda c: mops.whole_read_min(c, msize))
    if wsize > 0:
        dp_win_fused = _packed_pair(
            lambda c: mops.window_min_fused(c, msize, wsize)
        )
        dp_win_full = _packed_pair(
            lambda c: mops.window_min(c, msize, wsize)
        )
        # device-side record extraction (ops/minimiser.py:window_records):
        # run/boundary analysis rides in the jitted program and the host
        # only gathers marked positions. Default where fetches are cheap
        # (host CPU, or a device whose probed RTT is at most
        # _COALESCE_RTT_S); on a high-RTT device the extra planes cost
        # more round trips than the host analysis saves, so the fused
        # u32 plane + host extract_records stays the default there.
        import os as _os

        from kmertools_jax.workloads.common import (
            _COALESCE_RTT_S,
            probe_device_rtt,
        )

        _devs = _jax.local_devices()
        _near = bool(_devs) and (
            _devs[0].platform == "cpu"
            or probe_device_rtt(_devs[0]) <= _COALESCE_RTT_S
        )
        use_devext = (
            _os.environ.get("KMERTOOLS_NO_DEVEXTRACT") != "1"
            and (_near or _os.environ.get("KMERTOOLS_DEVEXTRACT") == "1")
        )
        if use_devext:
            _recs_planes = data_parallel_rows(_jax.jit(
                lambda p, v, ln: mops.window_records(
                    _enc.unpack_planes(p, v), ln, msize, wsize
                )
            ))
            _recs_clean = data_parallel_rows(_jax.jit(
                lambda p, ln: mops.window_records(
                    _enc.unpack_packed(p, ln), ln, msize, wsize
                )
            ))

            def dp_win_recs(b: iob.Batch):
                global DEVICE_EXTRACT_RUNS
                DEVICE_EXTRACT_RUNS += 1
                packed, vb, n_ambig = b.planes()
                if n_ambig == 0:
                    return _recs_clean(packed, b.lengths)
                return _recs_planes(packed, vb, b.lengths)
    else:
        use_devext = False

    def handle_batch_fast(b: iob.Batch, lengths, trail, hasbad,
                          n: int) -> None:
        """Vectorised path for batches of complete single-row reads (the
        common case): no per-row state machine, one extract_records call
        over the raveled fixed-width window grid. ``n`` = fast_rows(b)
        (>= 0 when eligible)."""
        if n == 0:
            return
        lengths = lengths[:n]
        trail = trail[:n]
        hasbad = hasbad[:n]
        rids = b.read_idx[:n]

        if wsize == 0:
            mh, ml = dp_whole_min(b)
            mh = np.asarray(mh)[:n].astype(np.uint64)
            ml = np.asarray(ml)[:n].astype(np.uint64)
            wvals = (mh << np.uint64(2 * nlo)) | ml
            ok = (~hasbad) & (lengths >= msize)
            rof = np.flatnonzero(ok)
            val = wvals[rof]
            s = np.zeros(len(rof), dtype=np.int64)
            e = lengths[rof]
            sent_mask = hasbad & (trail >= msize)
        else:
            if b.codes.shape[1] < wsize:
                rof = np.empty(0, np.int64)
                val = np.empty(0, np.uint64)
                s = e = np.empty(0, np.int64)
            elif use_devext and b.codes.shape[1] >= 1024:
                # device extraction pays on contig-scale rows but loses on
                # short-read buckets, where the per-row fixed work is
                # small and the extra keep/lastw planes outweigh the
                # host analysis they replace — those keep the fused
                # u32-plane + extract_records path below
                keep, hh, ll, lastw = dp_win_recs(b)
                keep = np.asarray(keep)[:n]
                ll = np.asarray(ll)[:n]
                lastw = np.asarray(lastw)[:n]
                rr, cc = np.nonzero(keep)
                rof = rr.astype(np.int64)
                val = ll[rr, cc].astype(np.uint64)
                hh = np.asarray(hh)
                if hh.shape[1] > 1:  # m > 16; else hi is identically 0
                    val |= (
                        hh[:n][rr, cc].astype(np.uint64)
                        << np.uint64(2 * nlo)
                    )
                s = cc.astype(np.int64)
                e = lastw[rr, cc].astype(np.int64) + wsize
            else:
                J_row = np.maximum(0, lengths - wsize + 1)
                if msize <= 15:
                    lw = dp_win_fused(b)
                    lw = np.asarray(lw)[:n]
                    Jm = lw.shape[1]
                    col = np.arange(Jm, dtype=np.int64)
                    inrow = col[None, :] < J_row[:, None]
                    v2 = (lw != np.uint32(0xFFFFFFFF)) & inrow
                    zcol_u = np.zeros((n, 1), dtype=lw.dtype)
                    zcol_b = np.zeros((n, 1), dtype=bool)
                    fh = np.zeros(n * (Jm + 1), dtype=np.uint32)
                    fl = np.concatenate([lw, zcol_u], axis=1).ravel()
                    fv = np.concatenate([v2, zcol_b], axis=1).ravel()
                else:
                    h, l, v = dp_win_full(b)
                    h = np.asarray(h)[:n]
                    l = np.asarray(l)[:n]
                    v = np.asarray(v)[:n]
                    Jm = h.shape[1]
                    col = np.arange(Jm, dtype=np.int64)
                    v2 = v & (col[None, :] < J_row[:, None])
                    zcol_u = np.zeros((n, 1), dtype=h.dtype)
                    zcol_b = np.zeros((n, 1), dtype=bool)
                    fh = np.concatenate([h, zcol_u], axis=1).ravel()
                    fl = np.concatenate([l, zcol_u], axis=1).ravel()
                    fv = np.concatenate([v2, zcol_b], axis=1).ravel()
                rof, val, s, e = mops.extract_records(
                    fh, fl, fv, lengths, wsize, msize, span=Jm + 1
                )
            sent_mask = (trail >= msize) & (trail < wsize)

        # merge extract records + sentinel rows into one flat layout
        rec_counts = np.bincount(rof, minlength=n) if len(rof) else np.zeros(
            n, np.int64
        )
        tot = rec_counts + sent_mask
        offs = np.concatenate([[0], np.cumsum(tot)]).astype(np.int64)
        N = int(offs[-1])
        vals_f = np.empty(N, np.uint64)
        st_f = np.empty(N, np.int64)
        en_f = np.empty(N, np.int64)
        if len(rof):
            starts_of = np.concatenate([[0], np.cumsum(rec_counts)])[:-1]
            within = np.arange(len(rof), dtype=np.int64) - starts_of[rof]
            pos = offs[rof] + within
            vals_f[pos] = val
            st_f[pos] = s
            en_f[pos] = e
        si = np.flatnonzero(sent_mask)
        if len(si):
            spos = offs[si] + rec_counts[si]
            vals_f[spos] = max_val
            st_f[spos] = lengths[si] - trail[si]
            en_f[spos] = lengths[si]
        if emit_slab is not None:
            emit_slab(
                rids.astype(np.int64),
                [meta.pop(int(r))[0] for r in rids],
                lengths,
                offs, vals_f, st_f, en_f,
            )
            return
        for i in range(n):
            ridx = int(rids[i])
            rid, rlen = meta.pop(ridx)
            a, z = offs[i], offs[i + 1]
            emit(ridx, rid, rlen, (vals_f[a:z], st_f[a:z], en_f[a:z]))

    def fast_rows(b: iob.Batch) -> int:
        """Number of real rows when EVERY real row is a complete
        single-row read (and no carried state), else -1."""
        if states:
            return -1
        real = b.read_idx >= 0
        if not bool((b.last_row | ~real).all()) or bool(
            (b.row_start[real] != 0).any()
        ):
            return -1
        return int(real.sum())

    def handle_batch(b: iob.Batch):
        n = fast_rows(b)  # >= 0: every real row is a complete read
        use_native = native_scan is not None and (
            not native_short_only
            or b.planes()[0].shape[1] * 4 < _NATIVE_MIN_WIDTH
        )
        if use_native:
            # complete single-row reads (the common case): the native
            # state machine produces every record — window changes,
            # ambiguity flushes, sentinels — with no codes expansion.
            # Ids ride as blob slices straight off the batch; the meta
            # dict (str decode per read) never gets involved.
            if n >= 0:
                if n:
                    offs, counts, vals, sts, ens = native_scan(
                        b.planes(), b.lengths[:n]
                    )
                    rids = b.read_idx[:n]
                    ids_b = _batch_ids_bytes(b, rids, n)
                    if emit_slab is not None:
                        # compact gather drops the (len+2)-capacity
                        # spacing so the slab pins only real records
                        new_offs, (v, s, e) = _compact_ranges(
                            offs, counts, (vals, sts, ens)
                        )
                        emit_slab(
                            rids.astype(np.int64),
                            ids_b,
                            b.lengths[:n].astype(np.int64),
                            new_offs, v, s, e,
                        )
                        return []
                    for i in range(n):
                        ridx = int(rids[i])
                        o, c = int(offs[i]), int(counts[i])
                        # .copy(): consumers (m2s grouping) hold records
                        # until a spill ceiling measured in RECORDS —
                        # a view would pin the whole (len+2)-capacity
                        # batch arrays (~24 B/base, not ~24 B/record)
                        emit(
                            ridx, ids_b[i], int(b.lengths[i]),
                            (
                                vals[o:o + c].copy(),
                                sts[o:o + c].copy(),
                                ens[o:o + c].copy(),
                            ),
                        )
                return []
        # slow paths track ids per read; stored as BYTES (the emit
        # contract) so slab and per-read arrivals mix freely downstream
        meta.update({
            ridx: (rid.encode(), b.read_lengths[ridx])
            for ridx, rid in b.ids.items()
        })
        lengths = b.lengths.astype(np.int64)
        trail = _row_trail(b.codes, lengths)
        hasbad = _row_has_bad(b.codes, lengths)
        if n >= 0:
            handle_batch_fast(b, lengths, trail, hasbad, n)
            return []
        if wsize > 0 and b.codes.shape[1] >= wsize:
            h, l, v = dp_win_full(b)
            h, l, v = np.asarray(h), np.asarray(l), np.asarray(v)
        else:
            h = l = v = None
        if wsize == 0:
            mh, ml = dp_whole_min(b)
            mh, ml = np.asarray(mh), np.asarray(ml)

        done = []
        for i in range(len(b.read_idx)):
            ridx = int(b.read_idx[i])
            if ridx < 0:
                continue
            st = states.get(ridx)
            if st is None:
                st = states[ridx] = _ReadState()
            rowlen = int(lengths[i])
            first_row = st.length == 0 and int(b.row_start[i]) == 0
            if wsize > 0 and h is not None:
                J_row = max(0, rowlen - wsize + 1)
                if J_row > 0:
                    st.rows_h.append(h[i, :J_row])
                    st.rows_l.append(l[i, :J_row])
                    st.rows_v.append(v[i, :J_row])
            if wsize == 0:
                hh, ll = int(mh[i]), int(ml[i])
                if (hh, ll) < (st.min_h, st.min_l):
                    st.min_h, st.min_l = hh, ll
            t_row = int(trail[i])
            if first_row:
                st.trail = t_row
            else:
                st.trail = t_row if t_row < rowlen else st.trail + rowlen - overlap
            st.has_bad = st.has_bad or bool(hasbad[i])
            st.length = int(b.row_start[i]) + rowlen
            if b.last_row[i]:
                done.append(ridx)
        return done

    def flush(done: list[int]):
        if not done:
            return
        if wsize == 0:
            for ridx in done:
                st = states.pop(ridx)
                rid, rlen = meta.pop(ridx)
                recs = []
                if not st.has_bad and rlen >= msize:
                    val = (st.min_h << (2 * nlo)) | st.min_l
                    recs.append((val, 0, rlen))
                elif st.has_bad and msize <= st.trail:
                    recs.append((max_val, rlen - st.trail, rlen))
                emit(ridx, rid, rlen, _tuple_recs(recs))
            return
        # assemble flat arrays with one separator window per read
        group = [(ridx, states.pop(ridx)) for ridx in done]
        glens = np.array([meta[r][1] for r, _ in group], dtype=np.int64)
        parts_h, parts_l, parts_v = [], [], []
        sep_h = np.zeros(1, dtype=np.uint32)
        sep_v = np.zeros(1, dtype=bool)
        for (_, st), L in zip(group, glens):
            J = max(0, int(L) - wsize + 1)
            if J > 0:
                gh = np.concatenate(st.rows_h) if len(st.rows_h) != 1 else st.rows_h[0]
                gl = np.concatenate(st.rows_l) if len(st.rows_l) != 1 else st.rows_l[0]
                gv = np.concatenate(st.rows_v) if len(st.rows_v) != 1 else st.rows_v[0]
                assert len(gh) == J, (len(gh), J)
                parts_h.append(gh)
                parts_l.append(gl)
                parts_v.append(gv)
            parts_h.append(sep_h)
            parts_l.append(sep_h)
            parts_v.append(sep_v)
        fh = np.concatenate(parts_h)
        fl = np.concatenate(parts_l)
        fv = np.concatenate(parts_v)
        rof, val, s, e = mops.extract_records(fh, fl, fv, glens, wsize, msize)
        per_read: dict[int, list] = {i: [] for i in range(len(group))}
        for r, vv, ss, ee in zip(rof, val, s, e):
            per_read[int(r)].append((int(vv), int(ss), int(ee)))
        for gi, (ridx, st) in enumerate(group):
            rid, rlen = meta.pop(ridx)
            recs = per_read[gi]
            if st.trail < wsize and st.trail >= msize:
                recs.append((max_val, rlen - st.trail, rlen))
            emit(ridx, rid, rlen, _tuple_recs(recs))

    for b in iob.stream_path(
        in_path, overlap=overlap, target_codes=target, shard=shard
    ):
        flush(handle_batch(b))
    assert not states, "incomplete reads at EOF"


def seq_to_min(wsize: int, msize: int, in_path: str, out_path: str, threads: int = 0,
               target_codes=None, shard=None) -> None:
    """S2m mode (minimisers.rs:87-160)."""

    def write_flat(ids, offs, vals, starts, ends) -> None:
        """Format one ordered block of reads from flat record arrays
        (offs delimits read i's records). ``ids`` yields BYTES —
        a _BlobIds over the batcher's NUL-separated blob on the slab
        fast path (consumed whole, zero per-read work), or a list of
        bytes."""
        n_reads = len(ids)
        vals = np.ascontiguousarray(vals, dtype=np.uint64)
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        ends = np.ascontiguousarray(ends, dtype=np.int64)
        offs = np.ascontiguousarray(offs, dtype=np.int64)

        from kmertools_jax import native

        so = native.lib()
        if so is not None:
            if isinstance(ids, _BlobIds):
                # already the emitter's wire format: "id\0id\0..." +
                # per-read start offsets
                blob = ids.blob
                id_off = np.ascontiguousarray(ids.offs[:-1])
                pos = len(blob)
            else:
                blob_parts = []
                id_off = np.zeros(n_reads, dtype=np.int64)
                pos = 0
                for i, rid in enumerate(ids):
                    blob_parts.append(rid)
                    id_off[i] = pos
                    pos += len(rid) + 1
                blob = b"\0".join(blob_parts) + b"\0" if blob_parts else b""
            cap = int(pos + offs[-1] * (msize + 46) + n_reads * 4 + 64)
            arr, buf = native.out_buf(cap)
            n = so.kt_format_s2m(
                vals.ctypes.data_as(native.c_u64_p),
                starts.ctypes.data_as(native.c_i64_p),
                ends.ctypes.data_as(native.c_i64_p),
                offs.ctypes.data_as(native.c_i64_p),
                blob,
                id_off.ctypes.data_as(native.c_i64_p),
                n_reads, msize, buf, cap,
            )
            if n >= 0:
                out.write(arr[:n].tobytes())
                return
        acgt = codec.numeric_to_kmer_array(vals, msize) if len(vals) else []
        lines = []
        for i in range(n_reads):
            parts = [ids[i]]
            for j in range(offs[i], offs[i + 1]):
                parts.append(b"%s:%d-%d" % (acgt[j], starts[j], ends[j]))
            parts.append(b"\n")
            lines.append(b"\t".join(parts))
        out.write(b"".join(lines))

    def write_block(payloads: list) -> None:
        counts = np.array([len(r[1][0]) for r in payloads], dtype=np.int64)
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        z3 = (np.empty(0, np.uint64), np.empty(0, np.int64),
              np.empty(0, np.int64))
        vals, starts, ends = (
            tuple(
                np.concatenate([r[1][j] for r in payloads])
                for j in range(3)
            )
            if offs[-1] else z3
        )
        write_flat([rid for rid, _ in payloads], offs, vals, starts, ends)

    with open(out_path, "wb") as out:
        emitter = OrderedEmitter(write_block, block=4096)

        def emit(ridx, rid, rlen, recs):
            emitter.add(ridx, (rid, recs))

        def emit_slab(rids, ids, lens, offs, vals, starts, ends):
            n = len(rids)
            if (
                rids[-1] - rids[0] + 1 == n
                and emitter.bypass(int(rids[0]), n)
            ):
                # ordered pass-through: the slab is the next contiguous
                # block of reads (always, on uniform corpora) — write it
                # whole, no per-read buffering
                write_flat(ids, offs, vals, starts, ends)
                return
            for i in range(n):
                a, z = int(offs[i]), int(offs[i + 1])
                emitter.add(
                    int(rids[i]),
                    (ids[i], (vals[a:z], starts[a:z], ends[a:z])),
                )

        _minimise_stream(in_path, wsize, msize, emit, target_codes,
                         shard=shard, threads=threads, emit_slab=emit_slab)
        emitter.finish()


def _write_group_lines(out, msize: int, vals: np.ndarray, ss: np.ndarray,
                       ee: np.ndarray, rid_of: np.ndarray,
                       all_rid=None, blob3=None) -> None:
    """Format+write ``MIN\\t[(id, s, e), ...]`` lines for a val-sorted
    record chunk (every group fully contained in the chunk). Within a
    group the records must already be in read order.

    Ids come in one of two forms:
      * ``blob3 = (blob bytes, offs int64 (n_ids+1,))`` — ``rid_of``
        indexes slots of the NUL-separated blob directly (the no-spill
        fast path: zero per-id work here);
      * ``all_rid`` — indexable yielding BYTES (list or _RunIdStore;
        the merge path, where a chunk references a sparse subset and
        compaction pays for itself)."""
    if not len(vals):
        return
    firsts = np.empty(len(vals), dtype=bool)
    firsts[0] = True
    np.not_equal(vals[1:], vals[:-1], out=firsts[1:])
    bounds = np.append(np.flatnonzero(firsts), len(vals)).astype(np.int64)
    gvals = np.ascontiguousarray(vals[bounds[:-1]], dtype=np.uint64)

    from kmertools_jax import native

    so = native.lib()
    if so is not None:
        import ctypes

        if blob3 is not None:
            blob, o = blob3
            id_off = np.ascontiguousarray(o[:-1])
            idlens = np.diff(o) - 1
            rid64 = np.ascontiguousarray(rid_of, dtype=np.int64)
        else:
            # only the read ids actually referenced travel into the blob
            uniq, local = np.unique(rid_of, return_inverse=True)
            blob_parts = []
            id_off = np.zeros(len(uniq), dtype=np.int64)
            idlens = np.zeros(len(uniq), dtype=np.int64)
            pos = 0
            for i, g in enumerate(uniq):
                bb = all_rid[g] + b"\0"
                blob_parts.append(bb)
                id_off[i] = pos
                idlens[i] = len(bb) - 1
                pos += len(bb)
            blob = b"".join(blob_parts)
            rid64 = np.ascontiguousarray(local, dtype=np.int64)
        ss64 = np.ascontiguousarray(ss, dtype=np.int64)
        ee64 = np.ascontiguousarray(ee, dtype=np.int64)
        n_groups = len(bounds) - 1
        cap = int(
            idlens[rid64].sum() + 56 * len(vals)
            + (msize + 8) * n_groups + 64
        )
        arr, buf = native.out_buf(cap)
        n = so.kt_format_m2s(
            gvals.ctypes.data_as(native.c_u64_p),
            bounds.ctypes.data_as(native.c_i64_p),
            ss64.ctypes.data_as(native.c_i64_p),
            ee64.ctypes.data_as(native.c_i64_p),
            rid64.ctypes.data_as(native.c_i64_p),
            blob,
            id_off.ctypes.data_as(native.c_i64_p),
            n_groups, msize, buf, cap,
        )
        if n >= 0:
            out.write(arr[:n].tobytes())
            return

    if all_rid is None:
        all_rid = _BlobIds(blob3[0], blob3[1])
    acgts = codec.numeric_to_kmer_array(gvals, msize)
    for g in range(len(bounds) - 1):
        a, z = bounds[g], bounds[g + 1]
        body = ", ".join(
            f'("{all_rid[rid_of[j]].decode()}", {ss[j]}, {ee[j]})'
            for j in range(a, z)
        )
        out.write(b'%s\t[%s]\n' % (acgts[g], body.encode()))


def _merge_sorted_runs(runs: list, emit_chunk, chunk: int = 1 << 20) -> None:
    """K-way merge of val-sorted record runs; calls ``emit_chunk(vals,
    ss, ee, rid_of)`` with val-complete chunks (no group ever split
    across two calls). ``runs`` items are (vals, ss, ee, rid_of,
    rid_key, base) sextuples (arrays memory-mapped for spilled runs):
    ``rid_of`` is run-LOCAL and shifts by ``base`` into the id-store
    space; ``rid_key`` is the GLOBAL read-order key. Chunks sort
    explicitly by (val, rid_key, start) — the output order contract —
    so the merge is independent of run arrival order (slab emission
    interleaves length buckets, and multi-host runs arrive host-major
    regardless of read order)."""
    pos = [0] * len(runs)
    while True:
        live = [i for i in range(len(runs)) if pos[i] < len(runs[i][0])]
        if not live:
            return
        # pivot = smallest "last value within the next `chunk` records"
        # over live runs; gathering ALL records <= pivot from every run
        # keeps groups complete and guarantees progress
        pivot = min(
            runs[i][0][min(pos[i] + chunk, len(runs[i][0])) - 1] for i in live
        )
        parts = []
        for i in live:
            v, s, e, r, rk, base = runs[i]
            hi = int(np.searchsorted(v[pos[i]:], pivot, side="right")) + pos[i]
            if hi > pos[i]:
                parts.append((
                    np.asarray(v[pos[i]:hi]),
                    np.asarray(s[pos[i]:hi]),
                    np.asarray(e[pos[i]:hi]),
                    np.asarray(r[pos[i]:hi]) + base,
                    np.asarray(rk[pos[i]:hi]),
                ))
                pos[i] = hi
        vals = np.concatenate([p[0] for p in parts])
        ss = np.concatenate([p[1] for p in parts])
        ee = np.concatenate([p[2] for p in parts])
        rid_of = np.concatenate([p[3] for p in parts])
        rk = np.concatenate([p[4] for p in parts])
        order = np.lexsort((ss, rk, vals))
        emit_chunk(vals[order], ss[order], ee[order], rid_of[order])


class _RunIdStore:
    """Indexable read-id lookup over per-run spilled id blobs: global
    read index -> id string, decoding only the ids a chunk references.
    Spilling ids with their run bounds m2s RSS by the record ceiling
    alone — the id strings no longer accumulate in RAM."""

    def __init__(self):
        self._blobs: list = []  # uint8 memmaps: "id\\0id\\0..."
        self._offs: list = []   # int64 (n_ids + 1,)
        self._bases = [0]

    def add_run(self, blob, offs) -> int:
        """Register one run's ids; returns the run's global id base."""
        base = self._bases[-1]
        self._blobs.append(blob)
        self._offs.append(offs)
        self._bases.append(base + len(offs) - 1)
        return base

    @property
    def total(self) -> int:
        return self._bases[-1]

    def __getitem__(self, g) -> bytes:
        import bisect

        g = int(g)
        r = bisect.bisect_right(self._bases, g) - 1
        o = self._offs[r]
        local = g - self._bases[r]
        return bytes(
            self._blobs[r][int(o[local]):int(o[local + 1]) - 1]
        )


# Peak cost per record at the run sort (_sorted_arrays consumes the
# accumulation lists as it concatenates): 40 B resident columns
# (vals+starts+ends+rk+gs), +32 B radix-argsort (key, idx) double
# buffer, then +40 B for the gathered copies while the pre-sort arrays
# are still live -> ~88 B/record peak (worst stage, not a sum). The
# default ceiling mirrors the reference's 6 GB default memory budget
# (kmertools/src/args.rs:163-165) against that PEAK.
_M2S_DEFAULT_SPILL_RECORDS = (6 << 30) // 88


def bin_sequences(wsize: int, msize: int, in_path: str, out_path: str,
                  threads: int = 0, target_codes=None, mh_ctx=None) -> None:
    """M2s mode (minimisers.rs:11-85); deterministic minimiser-sorted
    output with read-ordered group entries (reference map/scan order is
    nondeterministic; its tests sort lines: minimisers.rs:169-187).

    Output order contract: records sort by (minimiser value, global
    read order, span start) — byte-identical to the former arrival-
    ordered stable sort, but computable with NO ordering bookkeeping:
    record slabs append in any arrival order (length buckets
    interleave) and every sort is explicit, including the k-way merge.
    The multi-host read-order key is (host_id << 40) | local_index —
    hosts don't know each other's read counts, byte-range shards are
    file-ordered.

    Out-of-core: past a memory ceiling (KMERTOOLS_M2S_SPILL_RECORDS,
    default = 6 GB worth of records) accumulated records spill to
    val-sorted runs beside the output file and the final pass k-way
    merges the runs — the reference's whole-map-in-RAM design
    (minimisers.rs:21) is its scalability cliff; this removes it. Read
    ids spill WITH their run (ids decode lazily at merge), so RSS is
    bounded by the record ceiling alone.

    Multi-host (``mh_ctx``): every host streams its input shard,
    spills privately, then moves its runs into a nonce-fresh shared
    dir; after a rendezvous host 0 k-way merges ALL hosts' runs —
    groups stay whole because the merge is the single-host merge."""
    import json
    import os as _os
    import shutil
    import tempfile

    spill_limit = int(
        _os.environ.get("KMERTOOLS_M2S_SPILL_RECORDS",
                        _M2S_DEFAULT_SPILL_RECORDS)
    )
    # flat record arrays, appended in ARRIVAL order (slabs from
    # interleaved buckets); rid_key carries the true read order
    all_vals: list[np.ndarray] = []
    all_s: list[np.ndarray] = []
    all_e: list[np.ndarray] = []
    all_rk: list[np.ndarray] = []  # per-record global read-order key
    all_gs: list[np.ndarray] = []  # per-record id-store slot (below)
    # id store: NUL-separated blobs exactly as the batcher hands them
    # over (whole slab blobs, no per-read splitting); a record points
    # at its read id by GLOBAL SLOT = arrival index. The former
    # rid->str dict cost two 500k-iteration Python loops per run
    # (inserts at emit, blob rebuild at write).
    id_blobs: list[bytes] = []
    id_offs: list[np.ndarray] = []  # per blob: int64 (n_ids + 1,)
    id_nslots = [0]
    pending = 0

    def _ids_finalize():
        """One (blob, offs) over the whole store; slot i = id i."""
        blob = b"".join(id_blobs)
        total = id_nslots[0]
        offs = np.zeros(total + 1, dtype=np.int64)
        pos = 0
        slot = 0
        for b_, o_ in zip(id_blobs, id_offs):
            k = len(o_) - 1
            offs[slot:slot + k] = o_[:-1] + pos
            slot += k
            pos += len(b_)
        offs[total] = pos
        return blob, offs
    spill_dir: list = [None]
    runs: list = []
    rid_base = (mh_ctx.host_id << 40) if mh_ctx is not None else 0
    run_prefix = f"run_h{mh_ctx.host_id}_" if mh_ctx is not None else "run_"
    # slabs from interleaved length buckets can arrive out of read
    # order; on uniform corpora (one bucket) arrival IS read order and
    # the sort below collapses to a single stable argsort
    arrival_sorted = [True]
    last_rk = [-1]

    def _note_order(first_rk: int, last: int) -> None:
        if first_rk < last_rk[0]:
            arrival_sorted[0] = False
        last_rk[0] = last

    def _sorted_arrays():
        """Records in (val, read order, start) order plus the id-store
        slot per record.

        Records of one read arrive contiguously in start order, so one
        stable argsort by val over read-ordered arrays realises the
        full (val, rid, start) contract; a prior stable sort by rid_key
        restores read order first when buckets interleaved. The sorts
        are the native stable radix argsort where available (numpy's
        introsort measured 1.6 s on 11M values; the radix ~0.2 s).

        CONSUMES the accumulation lists: each clears as soon as its
        concatenation exists, so peak memory holds one extra column
        (+8 B/record), never a second copy of all five."""
        vals = np.concatenate(all_vals)
        all_vals.clear()
        ss = np.concatenate(all_s)
        all_s.clear()
        ee = np.concatenate(all_e)
        all_e.clear()
        rk = np.concatenate(all_rk)
        all_rk.clear()
        gs = np.concatenate(all_gs)
        all_gs.clear()
        if not arrival_sorted[0]:
            o1 = _stable_argsort_u64(
                rk.view(np.uint64), int(rk.max()).bit_length() or 1
            )
            vals, ss, ee, rk, gs = (
                vals[o1], ss[o1], ee[o1], rk[o1], gs[o1]
            )
        order = _stable_argsort_u64(vals, 2 * msize)
        return vals[order], ss[order], ee[order], rk[order], gs[order]

    def _spill_run() -> None:
        nonlocal pending
        if not all_vals:
            return
        if spill_dir[0] is None:
            spill_dir[0] = tempfile.mkdtemp(
                prefix=_os.path.basename(out_path) + ".spill.",
                dir=_os.path.dirname(_os.path.abspath(out_path)),
            )
        vals, ss, ee, rk, gs = _sorted_arrays()
        base = _os.path.join(spill_dir[0], f"{run_prefix}{len(runs)}")
        # ids ride along (VERDICT r2 item 8): the store blob spills
        # whole; .r holds the blob slot per record, .rk the global
        # read-order key the merge sorts by
        np.save(base + ".v.npy", vals)
        np.save(base + ".s.npy", ss)
        np.save(base + ".e.npy", ee)
        np.save(base + ".r.npy", gs)
        np.save(base + ".rk.npy", rk)
        blob, offs = _ids_finalize()
        np.save(base + ".ib.npy", np.frombuffer(blob, dtype=np.uint8))
        np.save(base + ".io.npy", offs)
        runs.append(base)
        all_vals.clear(); all_s.clear(); all_e.clear(); all_rk.clear()
        all_gs.clear(); id_blobs.clear(); id_offs.clear()
        id_nslots[0] = 0
        arrival_sorted[0] = True
        last_rk[0] = -1
        pending = 0

    def emit(ridx, rid, rlen, recs):
        nonlocal pending
        v, s, e = recs
        if not len(v):
            return
        rk = rid_base + int(ridx)
        _note_order(rk, rk)
        gs = id_nslots[0]
        id_blobs.append(rid + b"\0")
        id_offs.append(np.array([0, len(rid) + 1], dtype=np.int64))
        id_nslots[0] = gs + 1
        all_gs.append(np.full(len(v), gs, dtype=np.int64))
        all_vals.append(np.asarray(v, dtype=np.uint64))
        all_s.append(np.asarray(s, dtype=np.int64))
        all_e.append(np.asarray(e, dtype=np.int64))
        all_rk.append(np.full(len(v), rk, dtype=np.int64))
        pending += len(v)
        if pending >= spill_limit:
            _spill_run()

    def emit_slab(rids, ids, lens, offs, vals, starts, ends):
        nonlocal pending
        if not len(vals):
            return
        counts = np.diff(offs)
        rk = rids + rid_base
        _note_order(int(rk[0]), int(rk[-1]))
        # the whole slab blob becomes one id-store part (slots for
        # recordless reads sit unreferenced — a few bytes each)
        n = len(rids)
        gs0 = id_nslots[0]
        if isinstance(ids, _BlobIds):
            id_blobs.append(ids.blob)
            id_offs.append(ids.offs)
        else:
            id_blobs.append(
                b"\0".join(ids) + b"\0" if n else b""
            )
            o = np.zeros(n + 1, dtype=np.int64)
            np.cumsum([len(x) + 1 for x in ids], out=o[1:])
            id_offs.append(o)
        id_nslots[0] = gs0 + n
        all_gs.append(
            np.repeat(np.arange(gs0, gs0 + n, dtype=np.int64), counts)
        )
        all_vals.append(vals)
        all_s.append(starts)
        all_e.append(ends)
        all_rk.append(np.repeat(rk, counts))
        pending += len(vals)
        if pending >= spill_limit:
            _spill_run()

    _minimise_stream(
        in_path, wsize, msize, emit, target_codes, threads=threads,
        shard=mh_ctx.shard_for(in_path) if mh_ctx else None,
        emit_slab=emit_slab,
    )

    def _merge_runs_to(out, run_bases: list) -> None:
        ids = _RunIdStore()
        sextets = []
        for base in run_bases:
            v, s, e, r, rk = (
                np.load(f"{base}.{t}.npy", mmap_mode="r")
                for t in ("v", "s", "e", "r", "rk")
            )
            blob = np.load(base + ".ib.npy", mmap_mode="r")
            offs = np.load(base + ".io.npy")
            sextets.append((v, s, e, r, rk, ids.add_run(blob, offs)))
        _merge_sorted_runs(
            sextets,
            lambda v, s, e, r: _write_group_lines(out, msize, v, s, e, r, ids),
        )

    if mh_ctx is not None:
        import time as _time

        from kmertools_jax.parallel import multihost

        _spill_run()  # all data becomes durable runs (private dir)
        # exchange protocol (parallel/multihost.py:_finalize_fs's nonce
        # pattern): the primary creates a FRESH shared rundir and
        # publishes its name atomically; every host moves its runs in,
        # acks inside the rundir (fresh by construction — stale acks
        # from a crashed run cannot satisfy this run's rendezvous), and
        # the primary merges + cleans up. A host that raced a stale
        # marker fails the rendezvous loudly instead of merging wrong
        # bytes.
        marker = f"{out_path}.m2s.mh"
        if mh_ctx.is_primary:
            nonce = f"{_os.getpid()}_{_time.time_ns()}"
            rundir = f"{out_path}.m2s_mh_{nonce}"
            _os.makedirs(rundir, exist_ok=True)
            tmp = marker + ".tmp"
            with open(tmp, "w") as f:
                f.write(nonce)
            _os.replace(tmp, marker)  # atomic publish
        else:
            deadline = _time.time() + multihost._TIMEOUT_S
            while not _os.path.exists(marker):
                if _time.time() > deadline:
                    raise TimeoutError(
                        "m2s exchange marker from host 0 never appeared"
                    )
                _time.sleep(multihost._POLL_S)
            with open(marker) as f:
                rundir = f"{out_path}.m2s_mh_{f.read().strip()}"
        moved = []
        for base in runs:
            dst = _os.path.join(rundir, _os.path.basename(base))
            for t in ("v", "s", "e", "r", "rk", "ib", "io"):
                _os.replace(f"{base}.{t}.npy", f"{dst}.{t}.npy")
            moved.append(dst)
        with open(
            _os.path.join(rundir, f"runs_h{mh_ctx.host_id}.json"), "w"
        ) as f:
            json.dump([_os.path.basename(b) for b in moved], f)
        if spill_dir[0] is not None:
            shutil.rmtree(spill_dir[0], ignore_errors=True)
        multihost.rendezvous(mh_ctx, rundir, "m2s_runs")
        if mh_ctx.is_primary:
            try:
                run_bases = []
                for h in range(mh_ctx.num_hosts):
                    with open(
                        _os.path.join(rundir, f"runs_h{h}.json")
                    ) as f:
                        run_bases.extend(
                            _os.path.join(rundir, name)
                            for name in json.load(f)
                        )
                with open(out_path, "wb") as out:
                    _merge_runs_to(out, run_bases)
            finally:
                shutil.rmtree(rundir, ignore_errors=True)
                try:
                    _os.unlink(marker)
                except OSError:
                    pass
        multihost.release(mh_ctx, "m2s_merge")
        return

    try:
        with open(out_path, "wb") as out:
            if not runs:
                if not all_vals:
                    return
                vals, ss, ee, _rk, gs = _sorted_arrays()
                _write_group_lines(
                    out, msize, vals, ss, ee, gs, blob3=_ids_finalize()
                )
                return
            _spill_run()  # leftover in-RAM segment becomes the last run
            _merge_runs_to(out, runs)
    finally:
        if spill_dir[0] is not None:
            shutil.rmtree(spill_dir[0], ignore_errors=True)
