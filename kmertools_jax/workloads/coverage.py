"""Coverage histogram computer (coverage/src/lib.rs analog).

Pipeline: build the global canonical k-mer count table via the counter
(lib.rs:69-77), then per read histogram each k-mer's global abundance
into `bin_count` bins of width `bin_size`, clamped to the last bin
(``bin = min(count / bin_size, bin_count - 1)``, lib.rs:172-173),
optionally normalised (``/ max(1, total)``), written like the oligo
vectors.

Device design: the count table is uploaded once (as pre-binned
direct-bucket rows, aligned blocks, or sorted (hi, lo, count) arrays);
each batch joins its canonical k-mers against it with gathers
(ops.count) and bins them with the per-read histogram — the
HashMap-per-k-mer lookup of the reference becomes a few fused
gathers.
"""

from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp

from kmertools_jax.io import batch as iob
from kmertools_jax.ops import count as cops
from kmertools_jax.ops import encode, histogram
from kmertools_jax.utils.fmt import emit_count_slab, emit_norm_slab
from kmertools_jax.workloads.common import (
    ArrayAggregator,
    AsyncWriter,
    OrderedArrayEmitter,
    data_parallel_step,
    native_hist_sink,
    run_pipelined_hetero,
)
from kmertools_jax.workloads.counter import CountComputer


def _merge_table_parts(parts: list):
    """K-way merge of per-partition sorted (keys, counts) pairs into
    one globally sorted pair (keys disjoint across partitions). Native
    single pass when available; argsort of the concatenation otherwise
    (identical output — keys are unique)."""
    import ctypes

    from kmertools_jax import native

    parts = [(k, c) for k, c in parts if len(k)]
    if not parts:
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    if len(parts) == 1:
        return parts[0]
    so = native.lib()
    if so is not None:
        ks = [np.ascontiguousarray(k, dtype=np.uint64) for k, _ in parts]
        cs = [np.ascontiguousarray(c, dtype=np.uint64) for _, c in parts]
        lens = np.array([len(k) for k in ks], dtype=np.int64)
        kp = (native.c_u64_p * len(ks))(
            *[k.ctypes.data_as(native.c_u64_p) for k in ks]
        )
        cp = (native.c_u64_p * len(cs))(
            *[c.ctypes.data_as(native.c_u64_p) for c in cs]
        )
        total = int(lens.sum())
        ok = np.empty(total, np.uint64)
        oc = np.empty(total, np.uint64)
        rc = so.kt_merge_sorted_kv(
            kp, cp, lens.ctypes.data_as(native.c_i64_p), len(ks),
            ok.ctypes.data_as(native.c_u64_p),
            oc.ctypes.data_as(native.c_u64_p),
        )
        if rc == 0:
            return ok, oc
    kmers = np.concatenate([k for k, _ in parts])
    counts = np.concatenate([c for _, c in parts])
    order = np.argsort(kmers)
    return kmers[order], counts[order]


class CovComputer:
    """coverage/src/lib.rs:14-184 equivalent."""

    def __init__(
        self,
        in_path: str,
        out_dir: str,
        ksize: int,
        bin_size: int,
        bin_count: int,
    ):
        self.in_path = in_path
        self.in_path_kmer = in_path
        self.out_dir = out_dir
        self.ksize = ksize
        self.bin_size = bin_size
        self.bin_count = bin_count
        self.threads = 0
        self.norm = True
        self.delim = " "
        self.memory_ceil_gb = 6.0
        self.mh_ctx = None  # parallel.multihost.HostContext
        self.target_codes = iob.DEFAULT_TARGET_CODES

    def set_threads(self, threads: int) -> None:
        self.threads = threads

    def set_norm(self, norm: bool) -> None:
        self.norm = norm

    def set_delim(self, delim: str) -> None:
        self.delim = delim

    def set_kmer_path(self, path: str) -> None:
        self.in_path_kmer = path

    def set_max_memory(self, memory_ceil_gb: float) -> None:
        self.memory_ceil_gb = memory_ceil_gb

    def set_multihost(self, ctx) -> None:
        """Multi-host: the count table builds via the counter's sharded
        multi-host path (complete global table on every host), then each
        host vectorises its read shard and host 0 concatenates the
        kmers.vectors parts."""
        self.mh_ctx = ctx

    def build_table(self) -> None:
        ctr = CountComputer(self.in_path_kmer, self.out_dir, self.ksize)
        if self.threads:
            ctr.set_threads(self.threads)
        ctr.set_max_memory(self.memory_ceil_gb)
        if self.target_codes != iob.DEFAULT_TARGET_CODES:
            # explicit caller override; otherwise the counter resolves
            # its own backend-dependent default (_resolved_target)
            ctr.target_codes = self.target_codes
        if self.mh_ctx:
            ctr.set_multihost(self.mh_ctx)
        ctr.count_and_merge(True)
        # single-chunk single-host counts hand the table over in memory
        # (coverage/src/lib.rs:82-91 re-reads the file; we skip that):
        # per-partition (keys, counts) pairs, each sorted ascending
        self._table_parts = getattr(ctr, "last_table_parts", None)

    def _load_table(self):
        """kmers.counts -> sorted host (keys u64, counts i32); device
        uploads split the keys into (hi, lo) u32 pairs."""
        parts = getattr(self, "_table_parts", None)
        if parts is not None:
            kmers, counts = _merge_table_parts(parts)
        else:
            from kmertools_jax.workloads.counter import _read_tsv

            kmers, counts = _read_tsv(
                os.path.join(self.out_dir, "kmers.counts")
            )
            order = np.argsort(kmers)
            kmers, counts = kmers[order], counts[order]
        counts = counts.astype(np.int64)
        tc = np.minimum(counts, np.int64(2**31 - 1)).astype(np.int32)
        return np.ascontiguousarray(kmers), np.ascontiguousarray(tc)

    def compute_coverages(self) -> None:
        tkeys, tcnts = self._load_table()
        nlo = min(self.ksize, 16)
        # bucket index shared by the device join and the native sink:
        # lower bound of every bb-bit key prefix (ops/count.py:
        # bucket_offsets); the device join probes (n, 2) key rows
        bb = min(2 * self.ksize, 18)
        boff_np, join_steps = cops.bucket_offsets(tkeys, self.ksize, bb)
        # device-side table state, built on FIRST XLA dispatch: the
        # (hi, lo) split + uploads move ~180 MB at 13M keys — pure
        # waste when the native sink runs alone (CPU-only backends).
        # Join layout preference (KMERTOOLS_COV_JOIN=auto|direct|
        # blocks|bsearch): 1) direct-bucket pre-binned rows — ONE
        # gather per query (ops/count.py:direct_table), taken when its
        # ~2x-table footprint fits _direct_cap_bytes(); 2) aligned
        # blocks — 3 gathers (lookup_counts_blocks);
        # 3) binary search, the unconditional fallback (pathological
        # prefix skew or KMERTOOLS_NO_BLOCKJOIN=1).
        _dev: dict = {}
        join_mode = os.environ.get("KMERTOOLS_COV_JOIN", "auto")
        use_blocks = (
            os.environ.get("KMERTOOLS_NO_BLOCKJOIN") != "1"
            and join_mode in ("auto", "blocks")
        )
        use_direct = join_mode in ("auto", "direct")

        def dev_tables():
            if not _dev:
                if use_direct:
                    cap = _direct_cap_bytes() if join_mode == "auto" else None
                    dt = cops.direct_table(
                        tkeys, tcnts, self.ksize, self.bin_size,
                        self.bin_count, mem_cap_bytes=cap,
                    )
                    if dt is not None:
                        rows, p_bits, bin_bits, planes = dt
                        _dev["direct"] = jnp.asarray(rows)
                        _dev["d_p"] = p_bits
                        _dev["d_bb"] = bin_bits
                        _dev["d_pl"] = planes
                        return
                blk = (
                    cops.block_table(tkeys, tcnts, self.ksize)
                    if use_blocks else None
                )
                if blk is not None:
                    blocks3, bboff, p_bits = blk
                    _dev["blocks"] = jnp.asarray(blocks3)
                    _dev["bboff"] = jnp.asarray(bboff)
                    _dev["p_bits"] = p_bits
                    _dev["S"] = blocks3.shape[1]
                    return
                th_np = (tkeys >> np.uint64(2 * nlo)).astype(np.uint32)
                tl_np = (
                    tkeys & np.uint64((1 << (2 * nlo)) - 1)
                ).astype(np.uint32)
                _dev["tkl"] = jnp.asarray(
                    np.ascontiguousarray(np.stack([th_np, tl_np], axis=1))
                )
                _dev["boff"] = jnp.asarray(boff_np)
                _dev["tc"] = jnp.asarray(tcnts)
        final_path = os.path.join(self.out_dir, "kmers.vectors")
        vec_path = (
            self.mh_ctx.part_path(final_path) if self.mh_ctx else final_path
        )

        with open(vec_path, "wb") as raw:
            # disk writes ride behind the fetch/format thread
            out = AsyncWriter(raw)
            if self.norm:
                def write_slab(vecs: np.ndarray, tots: np.ndarray) -> None:
                    out.write(emit_norm_slab(vecs, tots, self.delim))
            else:
                def write_slab(vecs: np.ndarray, tots: np.ndarray) -> None:
                    out.write(emit_count_slab(vecs, self.delim))

            emitter = OrderedArrayEmitter(write_slab)
            agg = ArrayAggregator(self.bin_count)

            nb = self.bin_count

            def consume(meta, fused) -> None:
                arr = np.asarray(fused)
                ridx, vecs, tots = agg.add_batch(
                    meta.read_idx, meta.last_row,
                    arr[:, :nb], arr[:, nb].astype(np.int32),
                )
                emitter.add(ridx, vecs, tots)

            # codes travel 2-bit packed and unpack on-device; results
            # return as ONE fused int16 [counts | total] array per
            # batch. Tables travel as runtime ARGUMENTS (the trailing
            # replicated args of data_parallel_step): closing over a
            # 100s-of-MB table embeds it as an XLA literal in every
            # batch-shape program and the persistent compile cache
            # stores it once per shape.
            def _make_steps():
                if "steps" in _dev:
                    return _dev["steps"]
                if "direct" in _dev:
                    tbls = (_dev["direct"],)
                    k, nb_, dp, dbb, dpl = (
                        self.ksize, self.bin_count, _dev["d_p"],
                        _dev["d_bb"], _dev["d_pl"],
                    )

                    def _stepx(codes, rows):
                        return _coverage_batch_direct(
                            codes, rows, k, nb_, dp, dbb, dpl
                        )
                elif "blocks" in _dev:
                    tbls = (_dev["blocks"], _dev["bboff"])
                    k, bs, nb_, pb, S = (
                        self.ksize, self.bin_size, self.bin_count,
                        _dev["p_bits"], _dev["S"],
                    )

                    def _stepx(codes, blocks3, boff2):
                        return _coverage_batch_blocks(
                            codes, blocks3, boff2, k, bs, nb_, pb, S
                        )
                else:
                    tbls = (_dev["tkl"], _dev["tc"], _dev["boff"])
                    k, bs, nb_ = self.ksize, self.bin_size, self.bin_count

                    def _stepx(codes, tkl, tc, boff):
                        return _coverage_batch(
                            codes, tkl, tc, boff, k, bs, nb_, bb, join_steps
                        )

                _dev["steps"] = (
                    data_parallel_step(
                        jax.jit(
                            lambda p, v, *t: _stepx(
                                encode.unpack_planes(p, v), *t
                            )
                        ),
                        n_repl=len(tbls),
                    ),
                    data_parallel_step(
                        jax.jit(
                            lambda p, ln, *t: _stepx(
                                encode.unpack_packed(p, ln), *t
                            )
                        ),
                        n_repl=len(tbls),
                    ),
                    tbls,
                )
                return _dev["steps"]

            def dispatch(b):
                dev_tables()  # materialise OUTSIDE any trace
                step_planes, step_clean, tbls = _make_steps()
                packed, vb, n_ambig = b.planes()
                if n_ambig == 0:
                    return step_clean(packed, b.lengths, *tbls)
                return step_planes(packed, vb, *tbls)

            def native_dispatch():
                """The join + binning hot loop as a host sink
                (kthost.cpp:kt_cov_hist): rolling canonical encode,
                lower-bound lookup against the sorted table, abundance
                binning — bit-equal to the device program, scheduled
                beside it by measured throughput."""
                import ctypes

                from kmertools_jax import native

                so = native.lib()
                if (
                    so is None
                    or self.ksize > 31
                    or os.environ.get("KMERTOOLS_NO_HETERO") == "1"
                ):
                    return None
                nthreads = self.threads or (os.cpu_count() or 1)
                ksize = self.ksize
                bin_size, nb_ = self.bin_size, self.bin_count
                tk_p = tkeys.ctypes.data_as(native.c_u64_p)
                tc_p = tcnts.ctypes.data_as(native.c_i32_p)
                nt = len(tkeys)
                i16_p = ctypes.POINTER(ctypes.c_int16)
                # bucket index shared with the device join (boff_np:
                # first table position with key >> shift >= b)
                if nt >= 1 << 32:  # u32 offsets (a >4B-unique table
                    return None    # is not a real input; XLA path runs)
                boff_p = boff_np.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint32)
                )

                def kernel(packed, vb):
                    R = packed.shape[0]
                    # fused [counts | total] written in place
                    # (cnt_stride = nb + 1; common.native_hist_sink)
                    fused = np.empty((R, nb_ + 1), np.int16)
                    totals = np.empty((R,), np.int32)
                    rc = so.kt_cov_hist_idx(
                        packed.ctypes.data_as(native.c_u8_p),
                        vb.ctypes.data_as(native.c_u8_p),
                        R, packed.shape[1] * 4, ksize,
                        tk_p, tc_p, nt,
                        boff_p, bb,
                        bin_size, nb_,
                        fused.ctypes.data_as(i16_p),
                        totals.ctypes.data_as(native.c_i32_p),
                        nthreads, nb_ + 1,
                    )
                    if rc != 0:
                        raise RuntimeError("kt_cov_hist_idx failed")
                    fused[:, nb_] = totals
                    return fused

                return native_hist_sink(kernel)

            # on a CPU-only backend the XLA program and the native
            # kernel share the same cores — splitting batches between
            # them just adds contention, and the native kernel wins
            # outright, so it runs alone (counter.py:_make_engines has
            # the same policy). On an accelerator both sinks run,
            # routed by measured throughput.
            nd = native_dispatch()
            backend_cpu = jax.local_devices()[0].platform == "cpu"
            xla_key = f"cov{self.ksize}:xla:" + jax.local_devices()[0].platform
            from kmertools_jax.workloads.common import (
                batch_self_contained,
                coalesce_for,
                estimate_stream_codes,
                probe_device_rtt,
            )

            xla_coal = coalesce_for(jax.local_devices())
            xla_rtt = (
                probe_device_rtt(jax.local_devices()[0])
                if jax.local_devices() else 0.0
            )
            # high-RTT pre-gate (the oligo scheduler's and counter's
            # rule): exploring an XLA sink on a device whose probed RTT
            # exceeds _COALESCE_RTT_S uploads the whole join table for
            # one throwaway batch before the router can price it out —
            # with a native kernel present such a backend runs
            # native-alone outright. Devices below that RTT keep the
            # device join; KMERTOOLS_NO_HETERO pins it.
            from kmertools_jax.workloads.common import _COALESCE_RTT_S

            if nd is not None and (
                backend_cpu or xla_rtt > _COALESCE_RTT_S
            ):
                dispatches = [nd]
                keys = [f"cov{self.ksize}:native"]
                coalesce = [1]
                rtts = [0.0]
            elif nd is not None:
                dispatches = [dispatch, nd]
                keys = [xla_key, f"cov{self.ksize}:native"]
                coalesce = [xla_coal, 1]
                rtts = [xla_rtt, 0.0]
            else:
                dispatches = [dispatch]
                keys = [xla_key]
                coalesce = [xla_coal]
                rtts = [xla_rtt]
            cov_shard = (
                self.mh_ctx.shard_for(self.in_path) if self.mh_ctx else None
            )
            try:
                run_pipelined_hetero(
                    iob.stream_path(
                        self.in_path,
                        overlap=self.ksize - 1,
                        target_codes=self.target_codes,
                        shard=cov_shard,
                    ),
                    dispatches,
                    consume,
                    weight=lambda b: int(b.lengths.sum()),
                    keys=keys,
                    coalesce=coalesce,
                    rtts=rtts,
                    total_weight=estimate_stream_codes(
                        self.in_path, cov_shard
                    ),
                    recompute=(
                        (lambda b: np.asarray(nd(b)))
                        if nd is not None else None
                    ),
                    unordered_ok=batch_self_contained,
                )
                agg.finish()
                emitter.finish()
            finally:
                out.close()
        if self.mh_ctx:
            from kmertools_jax.parallel import multihost

            multihost.finalize_parts(self.mh_ctx, final_path)


import functools
import jax


# share of the device's memory the direct-bucket join table may take in
# auto mode: the table is replicated on every device, and each batch's
# gathered rows and the pipeline's in-flight batches need the rest
_DIRECT_TABLE_SHARE = 0.25


def _direct_cap_bytes() -> int:
    """Footprint cap of the direct-bucket join table in auto mode:
    KMERTOOLS_COV_DIRECT_MB when set, else _DIRECT_TABLE_SHARE of what
    the first device can hold (``memory_stats()["bytes_limit"]``) — or
    of host memory, for devices that report no limit (host CPU)."""
    env = os.environ.get("KMERTOOLS_COV_DIRECT_MB")
    if env:
        return int(float(env) * 1e6)
    try:
        stats = jax.local_devices()[0].memory_stats() or {}
    except Exception:
        stats = {}
    limit = stats.get("bytes_limit") or (
        os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    )
    return int(limit * _DIRECT_TABLE_SHARE)


def _bin_and_fuse(cnt, valid, bin_size, bin_count):
    """Abundance binning (bin = min(count / bin_size, bins - 1),
    coverage/src/lib.rs:172-173) + per-read histogram, fused into ONE
    int16 [counts | total] result array: a single device->host fetch;
    counts and totals both fit int16 (row width <= 8192)."""
    bins = jnp.minimum(cnt // bin_size, bin_count - 1).astype(jnp.int32)
    return _hist_fuse(bins, valid, bin_count)


def _hist_fuse(bins, valid, bin_count):
    counts, totals = histogram.per_read_counts(bins, valid, bin_count)
    return jnp.concatenate(
        [counts.astype(jnp.int16), totals.astype(jnp.int16)[:, None]],
        axis=1,
    )


@functools.partial(
    jax.jit,
    static_argnames=("k", "bin_size", "bin_count", "bucket_bits", "steps"),
)
def _coverage_batch(codes, tkl, tc, boff, k, bin_size, bin_count,
                    bucket_bits, steps):
    """Binary-search join variant (fallback layout)."""
    qh, ql, valid = encode.canonical_ids_pair(codes, k)
    cnt = cops.lookup_counts_bucketed(
        qh, ql, tkl, tc, boff, k, bucket_bits, steps
    )
    return _bin_and_fuse(cnt, valid, bin_size, bin_count)


@functools.partial(
    jax.jit,
    static_argnames=("k", "bin_size", "bin_count", "p_bits", "S"),
)
def _coverage_batch_blocks(codes, blocks3, boff, k, bin_size, bin_count,
                           p_bits, S):
    """Aligned-block join variant (3 gathers per query,
    ops/count.py:lookup_counts_blocks)."""
    qh, ql, valid = encode.canonical_ids_pair(codes, k)
    cnt = cops.lookup_counts_blocks(qh, ql, blocks3, boff, k, p_bits, S)
    return _bin_and_fuse(cnt, valid, bin_size, bin_count)


@functools.partial(
    jax.jit,
    static_argnames=("k", "bin_count", "p_bits", "bin_bits", "planes"),
)
def _coverage_batch_direct(codes, rows, k, bin_count, p_bits, bin_bits,
                           planes):
    """Direct-bucket join variant (the fast path: ONE gather per
    query, pre-binned table values — ops/count.py:direct_table)."""
    qh, ql, valid = encode.canonical_ids_pair(codes, k)
    bins = cops.lookup_bins_direct(
        qh, ql, rows, k, p_bits, bin_bits, planes
    )
    return _hist_fuse(bins, valid, bin_count)
