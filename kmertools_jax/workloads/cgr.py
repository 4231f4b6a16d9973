"""CGR workloads: whole-sequence CGR and k-mer (oligo) CGR.

Reference behavior:
  * CgrComputer (composition/src/cgr.rs): one `(x,y)` point per base,
    lines of points joined by spaces, Rust `{}` f64 formatting; any
    base outside AaCcGgTtUu aborts with "Bad nucleotide".
  * OligoCgrComputer (composition/src/oligocgr.rs): for each canonical
    k-mer, the CGR endpoint of the k-mer string plus its (optionally
    normalised) per-read frequency as `(x,y,freq)`.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import jax.numpy as jnp

from kmertools_jax.io import batch as iob
from kmertools_jax.io import fastx
from kmertools_jax.ops import cgr as cgr_ops
from kmertools_jax.ops import encode, histogram
from kmertools_jax.utils import codec
from kmertools_jax.utils.fmt import rust_f64_repr
from kmertools_jax.workloads.common import OrderedEmitter, RowAggregator

_repr = functools.lru_cache(maxsize=1 << 16)(rust_f64_repr)

# whole reads up to this length run on-device; longer fall back to host
_CGR_ROW_WIDTHS = (128, 512, 2048, 8192, 32768)


# number of device cgr_scan dispatches this process (observability for
# tests asserting the device path actually ran)
DEVICE_SCAN_RUNS = 0


_F64_EXACT: bool | None = None


def _probe_exact() -> bool:
    """Run a 64-step cgr_scan on the default backend and compare
    bit-for-bit against the host f64 oracle.

    A dtype probe is NOT enough: a backend that emulates f64 can round
    the elementwise ops correctly yet drift in the last ulp inside the
    scan, so only a real kernel run decides (composition/src/cgr.rs:127-144
    per-step rounding is part of the reference's output bytes)."""
    try:
        codes = (np.arange(64) % 4).astype(np.uint8)[None, :]
        xs, ys = cgr_ops.cgr_scan(jnp.asarray(codes), 1.0, jnp.float64)
        xs = np.asarray(xs)[0]
        ys = np.asarray(ys)[0]
        cx = np.array([0.0, 0.0, 1.0, 1.0])
        cy = np.array([0.0, 1.0, 1.0, 0.0])
        hx = hy = 0.5
        for i, c in enumerate(codes[0]):
            hx = (hx + cx[c]) / 2.0
            hy = (hy + cy[c]) / 2.0
            if hx != xs[i] or hy != ys[i]:
                return False
        return True
    except Exception:
        return False


def _f64_supported() -> bool:
    """True iff the DEFAULT backend runs the CGR scan kernel BIT-
    EXACTLY in f64; ENABLES x64 if needed.

    The CGR walk needs exact IEEE f64, but JAX defaults to x64-off —
    so a plain CLI run would otherwise silently take the host loop
    forever. Set KMERTOOLS_NO_X64=1 to force the host path.
    """
    global _F64_EXACT
    if _F64_EXACT is not None:
        return _F64_EXACT
    import os

    import jax

    if os.environ.get("KMERTOOLS_NO_X64"):
        _F64_EXACT = False
        return False
    if not jax.config.read("jax_enable_x64"):
        try:
            jax.config.update("jax_enable_x64", True)
        except Exception:
            _F64_EXACT = False
            return False
    _F64_EXACT = _probe_exact()
    return _F64_EXACT


def _scan_on_device() -> bool:
    """True when the default backend runs the scan bit-exactly in f64
    (composition/src/cgr.rs:127-144 is the kernel being replaced).
    Otherwise CGR takes the host numpy walk, and an accelerator that
    failed the probe says so on stderr: its CGR runs on the host."""
    if _f64_supported():
        return True
    import sys

    import jax

    plat = jax.default_backend()
    if plat != "cpu" and not os.environ.get("KMERTOOLS_NO_X64"):
        print(
            f"kmertools_jax: the {plat} backend failed the bit-exact f64 "
            "CGR scan probe; CGR runs on the host, not on the device",
            file=sys.stderr,
        )
    return False


class CgrComputer:
    """Whole-sequence CGR (composition/src/cgr.rs:41-144)."""

    def __init__(self, in_path: str, out_path: str, vecsize: int):
        self.in_path = in_path
        self.out_path = out_path
        self.vecsize = vecsize
        self.threads = 0
        self.input_shard = None
        self.target_codes = iob.DEFAULT_TARGET_CODES

    def set_threads(self, threads: int) -> None:
        self.threads = threads

    def set_input_shard(self, shard) -> None:
        self.input_shard = shard

    def _points_host(self, codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Sequential f64 walk for reads longer than the widest bucket."""
        s = float(self.vecsize)
        cx_t = np.array([0.0, 0.0, s, s], dtype=np.float64)
        cy_t = np.array([0.0, s, s, 0.0], dtype=np.float64)
        xs = np.empty(len(codes))
        ys = np.empty(len(codes))
        x = y = s / 2.0
        for i, c in enumerate(codes):
            x = (x + cx_t[c]) / 2.0
            y = (y + cy_t[c]) / 2.0
            xs[i] = x
            ys[i] = y
        return xs, ys

    def vectorise(self) -> None:
        on_device = _scan_on_device()
        if self.input_shard is not None:
            from kmertools_jax.parallel import dataflow

            records = dataflow.shard_sequences(self.in_path, self.input_shard)
        else:
            records = fastx.sequences(self.in_path)

        def _format_native(payloads: list):
            """One chunk -> output bytes via kt_format_cgr (GIL-free),
            or None when the native runtime is unavailable."""
            from kmertools_jax import native

            so = native.lib()
            if so is None:
                return None
            import ctypes

            lens = np.array([len(xs) for xs, _ in payloads], dtype=np.int32)
            stride = int(lens.max()) if len(lens) else 0
            if not stride:
                # all-empty sequences render as empty lines; returning
                # None here would throw away the sibling chunks' native
                # output and push the whole block onto the Python path
                return np.frombuffer(b"\n" * len(payloads), dtype=np.uint8)
            fx = np.empty((len(payloads), stride), dtype=np.float64)
            fy = np.empty((len(payloads), stride), dtype=np.float64)
            for i, (xs, ys) in enumerate(payloads):
                fx[i, : len(xs)] = xs
                fy[i, : len(ys)] = ys
            cap = int(lens.sum()) * 64 + len(payloads) * 2 + 64
            while True:
                arr, buf = native.out_buf(cap)
                n = so.kt_format_cgr(
                    fx.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    fy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    lens.ctypes.data_as(native.c_i32_p),
                    len(payloads), stride, buf, cap,
                )
                if n >= 0:
                    return arr[:n]
                cap *= 4  # rare deep-walk denormal expansion

        import concurrent.futures as _cf

        pool = _cf.ThreadPoolExecutor(max_workers=min(4, os.cpu_count() or 1))

        def write_block(payloads: list) -> None:
            # the format kernel releases the GIL, so chunks of the
            # block format in parallel; writes stay in block order
            if payloads and len(payloads) >= 128:
                step = (len(payloads) + 3) // 4
                chunks = [
                    payloads[s : s + step]
                    for s in range(0, len(payloads), step)
                ]
                parts = list(pool.map(_format_native, chunks))
                if all(p is not None for p in parts):
                    for p in parts:
                        out.write(p.tobytes())
                    return
            elif payloads:
                p = _format_native(payloads)
                if p is not None:
                    out.write(p.tobytes())
                    return
            lines = []
            for xs, ys in payloads:
                lines.append(
                    " ".join(f"({_repr(x)},{_repr(y)})" for x, y in zip(xs, ys))
                )
            out.write(("\n".join(lines) + "\n").encode())

        import threading

        with pool, open(self.out_path, "wb") as out:
            emitter = OrderedEmitter(write_block, block=1024)
            # long-read host walks (producer thread) and device-scan
            # results (writer thread) both feed the emitter
            emit_lock = threading.Lock()
            max_w = _CGR_ROW_WIDTHS[-1]

            def records_filtered():
                for rec in records:
                    if len(rec.seq) > max_w:
                        codes = iob.encode_bases(rec.seq)
                        self._check_codes(codes, rec.id)
                        # walk BEFORE taking the lock: a multi-Mb host
                        # walk must not stall the consumer thread's
                        # device-result emission
                        pts = self._points_host(codes)
                        with emit_lock:
                            emitter.add(rec.n, pts)
                    else:
                        yield rec

            stream = iob.batch_stream(
                records_filtered(),
                overlap=0,
                row_widths=_CGR_ROW_WIDTHS,
                target_codes=self.target_codes,
            )

            def emit_points(b, xs: np.ndarray, ys: np.ndarray) -> None:
                lens = b.lengths
                with emit_lock:
                    for i in np.nonzero(b.read_idx >= 0)[0]:
                        n = int(lens[i])
                        emitter.add(
                            int(b.read_idx[i]), (xs[i, :n], ys[i, :n])
                        )

            if on_device:
                # device path: the scan kernel runs on the default
                # backend, which passed the exactness probe (the
                # producer thread computes no points)
                from kmertools_jax.workloads.common import (
                    data_parallel_rows,
                    run_pipelined,
                )

                vecsize = float(self.vecsize)
                fn = data_parallel_rows(
                    lambda c: cgr_ops.cgr_scan(c, vecsize, jnp.float64)
                )

                def dispatch(b):
                    global DEVICE_SCAN_RUNS
                    # bad-base abort stays on the producer (fail fast,
                    # before the batch is paid for)
                    for i in np.nonzero(b.read_idx >= 0)[0]:
                        self._check_codes(
                            b.codes[i, : b.lengths[i]],
                            b.ids.get(int(b.read_idx[i]), "?"),
                        )
                    DEVICE_SCAN_RUNS += 1
                    return fn(jnp.asarray(b.codes))

                def consume(b, xs, ys):
                    nrows = b.codes.shape[0]
                    emit_points(b, np.asarray(xs)[:nrows], np.asarray(ys)[:nrows])

                run_pipelined(stream, dispatch, consume)
            else:
                # host numpy walk (column-sweep over the batch)
                for b in stream:
                    for i in np.nonzero(b.read_idx >= 0)[0]:
                        self._check_codes(
                            b.codes[i, : b.lengths[i]],
                            b.ids.get(int(b.read_idx[i]), "?"),
                        )
                    full = np.empty(
                        (b.codes.shape[0], b.codes.shape[1], 2),
                        dtype=np.float64,
                    )
                    s = float(self.vecsize)
                    cx_t = np.array([0.0, 0.0, s, s, 0.0])
                    cy_t = np.array([0.0, s, s, 0.0, 0.0])
                    m = np.full((b.codes.shape[0], 2), s / 2.0)
                    for t in range(b.codes.shape[1]):
                        m = (m + np.stack(
                            [cx_t[b.codes[:, t]], cy_t[b.codes[:, t]]], axis=1
                        )) / 2.0
                        full[:, t] = m
                    emit_points(b, full[..., 0], full[..., 1])
            emitter.finish()

    @staticmethod
    def _check_codes(codes: np.ndarray, rid: str) -> None:
        if (codes >= 4).any():
            raise ValueError("Bad nucleotide, unable to proceed")


class OligoCgrComputer:
    """k-mer CGR (composition/src/oligocgr.rs:16-163)."""

    def __init__(self, in_path: str, out_path: str, ksize: int, vecsize: int):
        self.in_path = in_path
        self.out_path = out_path
        self.ksize = ksize
        self.vecsize = vecsize
        self.norm = True
        self.threads = 0
        self.input_shard = None
        self.target_codes = iob.DEFAULT_TARGET_CODES
        _, pos_kmer, self.kcount = codec.kmer_pos_maps(ksize)
        kmer_vals = np.array([pos_kmer[i] for i in range(self.kcount)], dtype=np.uint64)
        digits = np.empty((self.kcount, ksize), dtype=np.int64)
        for j in range(ksize):
            digits[:, j] = ((kmer_vals >> np.uint64(2 * (ksize - 1 - j))) & np.uint64(3)).astype(np.int64)
        self._xs, self._ys = cgr_ops.kmer_cgr_points(digits, float(vecsize))
        self._prefixes = [
            f"({rust_f64_repr(x)},{rust_f64_repr(y)}," for x, y in zip(self._xs, self._ys)
        ]

    def set_threads(self, threads: int) -> None:
        self.threads = threads

    def set_norm(self, norm: bool) -> None:
        self.norm = norm

    def set_input_shard(self, shard) -> None:
        self.input_shard = shard

    def _emit_slab(self, out, vecs: np.ndarray, tots: np.ndarray) -> None:
        freqs = vecs.astype(np.float64)
        if self.norm:
            freqs = freqs / np.maximum(1.0, tots.astype(np.float64))[:, None]
        from kmertools_jax import native

        so = native.lib()
        if so is not None:
            import ctypes

            if not hasattr(self, "_prefix_blob"):
                parts = [p.encode() + b"\0" for p in self._prefixes]
                off = np.zeros(len(parts), dtype=np.int32)
                pos = 0
                for i, part in enumerate(parts):
                    off[i] = pos
                    pos += len(part)
                self._prefix_blob = b"".join(parts)
                self._prefix_off = off
            freqs = np.ascontiguousarray(freqs)
            nrows, ncols = freqs.shape
            cap = nrows * (len(self._prefix_blob) + ncols * 32) + nrows * 2 + 64
            while True:
                arr, buf = native.out_buf(cap)
                n = so.kt_format_oligocgr(
                    self._prefix_blob,
                    self._prefix_off.ctypes.data_as(native.c_i32_p),
                    ncols,
                    freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    nrows, buf, cap,
                )
                if n >= 0:
                    out.write(arr[:n].tobytes())
                    return
                cap *= 4
        lines = []
        for row in freqs:
            lines.append(
                " ".join(
                    p + _repr(float(f)) + ")"
                    for p, f in zip(self._prefixes, row)
                )
            )
        out.write(("\n".join(lines) + "\n").encode())

    def vectorise(self) -> None:
        """Heterogeneous pipeline (oligo.py:vectorise structure): XLA
        device sets + the native kt_oligo_hist sink — the histogram is
        the same canonical per-read count oligo computes; only the
        emitter (CGR-point prefixes, oligocgr.rs:123-143) differs."""
        from kmertools_jax.workloads.common import (
            ArrayAggregator,
            AsyncWriter,
            OrderedArrayEmitter,
            batch_self_contained,
            data_parallel_step,
            estimate_stream_codes,
            oligo_hist_native_sink,
            plan_hetero_sinks,
            run_pipelined_hetero,
        )

        nbins = self.kcount
        slot_table = jnp.asarray(codec.canonical_slot_table(self.ksize))

        def _hist(codes):
            fwd, rc, valid = encode.kmer_ids_small(codes, self.ksize)
            return histogram.per_read_counts(
                jnp.minimum(fwd, rc), valid, nbins, slot_table
            )

        def _fuse_i16(counts, totals):
            # int16 [counts | total]: rows are <= 8192 wide so both fit
            return jnp.concatenate(
                [counts.astype(jnp.int16),
                 totals.astype(jnp.int16)[:, None]],
                axis=1,
            )

        def make_dispatch(devs):
            sp = data_parallel_step(
                lambda p, v: _fuse_i16(*_hist(encode.unpack_planes(p, v))),
                devices=devs,
            )
            sc = data_parallel_step(
                lambda p, ln: _fuse_i16(*_hist(encode.unpack_packed(p, ln))),
                devices=devs,
            )

            def dispatch(b):
                packed, vb, n_ambig = b.planes()
                if n_ambig == 0:
                    return sc(packed, b.lengths)
                return sp(packed, vb)

            return dispatch

        with open(self.out_path, "wb") as raw:
            out = AsyncWriter(raw)
            emitter = OrderedArrayEmitter(
                lambda vecs, tots: self._emit_slab(out, vecs, tots)
            )
            agg = ArrayAggregator(nbins)

            def consume(meta, fused) -> None:
                arr = np.asarray(fused)
                ridx, vecs, tots = agg.add_batch(
                    meta.read_idx, meta.last_row,
                    arr[:, :nbins], arr[:, nbins].astype(np.int32),
                )
                emitter.add(ridx, vecs, tots)

            # kt_oligo_hist canonical-table sink (oligocgr has no raw
            # mode) + the standard sink policy, shared with oligo.py
            native_sink = oligo_hist_native_sink(
                self.ksize, nbins, True, self.threads
            )
            dispatches, keys, stream_target, coalesce, rtts = (
                plan_hetero_sinks(
                    make_dispatch,
                    native_sink,
                    f"oligocgr{self.ksize}",
                    self.target_codes,
                )
            )
            try:
                run_pipelined_hetero(
                    iob.stream_path(
                        self.in_path,
                        overlap=self.ksize - 1,
                        target_codes=stream_target,
                        shard=self.input_shard,
                    ),
                    dispatches,
                    consume,
                    weight=lambda b: int(b.lengths.sum()),
                    keys=keys,
                    coalesce=coalesce,
                    rtts=rtts,
                    total_weight=estimate_stream_codes(
                        self.in_path, self.input_shard
                    ),
                    recompute=(
                        (lambda b: np.asarray(native_sink(b)))
                        if native_sink is not None else None
                    ),
                    unordered_ok=batch_self_contained,
                )
                agg.finish()
                emitter.finish()
            finally:
                out.close()
