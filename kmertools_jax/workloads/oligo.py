"""Oligonucleotide frequency vectors (composition/src/oligo.rs analog).

Per read: counts of canonical (136-dim for k=4) or raw forward-strand
(4^k-dim) k-mers, optionally normalised by the read's total k-mer count
(f64, ``/ max(1, total)``, oligo.rs:255-257), written as delimited
text, ``{:.6}`` when normalised.

Device pipeline: host packs padded code batches (io.batch), the device
computes k-mer ids (ops.encode) and per-read histograms
(ops.histogram); normalisation happens in f64 on the host so output
bytes match the reference exactly regardless of accelerator dtype
support.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from kmertools_jax.io import batch as iob
from kmertools_jax.ops import encode, histogram
from kmertools_jax.utils import codec
from kmertools_jax.utils.fmt import emit_count_slab, emit_norm_slab
from kmertools_jax.workloads.common import (
    ArrayAggregator,
    OrderedArrayEmitter,
    PartedOutput,
    batch_self_contained,
    data_parallel_step,
    estimate_stream_codes,
    oligo_hist_native_sink,
    plan_hetero_sinks,
    plan_producers,
    run_pipelined_hetero,
)


class OligoComputer:
    """File-to-file oligo vectoriser (composition/src/oligo.rs:15-259)."""

    def __init__(self, in_path: str, out_path: str, ksize: int, count_min: bool = True):
        self.in_path = in_path
        self.out_path = out_path
        self.ksize = ksize
        self.count_min = count_min
        _, self.pos_kmer, self.kcount = codec.kmer_pos_maps(ksize)
        self.norm = True
        self.delim = " "
        self.header = False
        self.threads = 0
        self.input_shard = None  # parallel.dataflow.Shard for multi-host
        self.target_codes = iob.DEFAULT_TARGET_CODES
        self.n_devices = None  # None = every device of the default backend

    # builder setters mirroring oligo.rs:49-67
    def set_threads(self, threads: int) -> None:
        self.threads = threads

    def set_norm(self, norm: bool) -> None:
        self.norm = norm

    def set_delim(self, delim: str) -> None:
        self.delim = delim

    def set_max_memory(self, memory: float) -> None:
        """Reference semantics: GB of buffered sequence (oligo.rs:61-63,
        composition batch threshold oligo.rs:13). Converted to a batch
        code budget at 1 base/code; device batches cap at 2^25 codes
        (~500 MB of device intermediates; beyond that the pipeline
        already overlaps, so bigger buffers only add latency)."""
        self.target_codes = int(max(1 << 14, min(memory * (1 << 30), 1 << 25)))

    def set_header(self, header: bool) -> None:
        self.header = header

    def set_input_shard(self, shard) -> None:
        """Restrict input to one host's byte range (multi-host mode)."""
        self.input_shard = shard

    def get_header(self) -> list[str]:
        """ACGT header row (oligo.rs:69-83)."""
        if self.count_min:
            return [
                codec.numeric_to_kmer(self.pos_kmer[i], self.ksize)
                for i in range(self.kcount)
            ]
        return [codec.numeric_to_kmer(v, self.ksize) for v in range(4**self.ksize)]

    @property
    def nbins(self) -> int:
        return self.kcount if self.count_min else 4**self.ksize

    def vectorise(self) -> None:
        nbins = self.nbins
        slot_table = (
            jnp.asarray(codec.canonical_slot_table(self.ksize))
            if self.count_min
            else None
        )

        def _hist(codes):
            fwd, rc, valid = encode.kmer_ids_small(codes, self.ksize)
            ids = jnp.minimum(fwd, rc) if self.count_min else fwd
            return histogram.per_read_counts(ids, valid, nbins, slot_table)

        def _fuse_u8(counts, totals):
            """ONE u8 result array [counts_u8 | tot_lo | tot_hi |
            max_lo | max_hi]: the per-batch payload ships as single
            bytes, a quarter of the fetch. Per-row true maxima ride
            along; any row whose max exceeds 255 is re-dispatched
            through the exact int16 program (host side below)."""
            t = totals.astype(jnp.int32)
            m = jnp.max(counts, axis=1).astype(jnp.int32)
            side = jnp.stack(
                [t & 255, t >> 8, m & 255, m >> 8], axis=1
            ).astype(jnp.uint8)
            return jnp.concatenate([counts.astype(jnp.uint8), side], axis=1)

        def _fuse_i16(counts, totals):
            """Exact path: int16 [counts | total] (row width <= 8192 so
            both halves fit int16)."""
            return jnp.concatenate(
                [counts.astype(jnp.int16),
                 totals.astype(jnp.int16)[:, None]],
                axis=1,
            )

        def step_planes_i16(packed, vb):
            return _fuse_i16(*_hist(encode.unpack_planes(packed, vb)))

        def step_clean_i16(packed, lengths):
            return _fuse_i16(*_hist(encode.unpack_packed(packed, lengths)))

        # multi-producer input: the file splits into record-aligned
        # byte ranges, each parsed by its own native batcher thread
        # (io.batch.multi_range_stream); per-range ordered emitters
        # write per-range parts that concatenate at close
        nprod = plan_producers(self.in_path, self.input_shard)

        with open(self.out_path, "wb") as raw:
            # third pipeline stage: disk writes happen behind the
            # fetch/format thread so writeback stalls never idle the
            # device (common.AsyncWriter, one per range part)
            parted = PartedOutput(raw, self.out_path, nprod)
            if self.header:
                parted.writers[0].write(
                    (self.delim.join(self.get_header()) + "\n").encode()
                )

            def make_write_slab(w):
                # chunks go to the AsyncWriter as CALLABLES: the text
                # formatting runs on the write-behind thread, so it
                # overlaps the next batch's histogram instead of
                # serialising with the fetch thread (~0.5 s of the
                # bench wall on the 4-core box)
                if self.norm:
                    return lambda vecs, tots: w.write(
                        lambda v=vecs, t=tots: emit_norm_slab(
                            v, t, self.delim
                        )
                    )
                return lambda vecs, tots: w.write(
                    lambda v=vecs: emit_count_slab(v, self.delim)
                )

            emitters = [
                OrderedArrayEmitter(make_write_slab(w))
                for w in parted.writers
            ]
            aggs = [ArrayAggregator(nbins) for _ in range(nprod)]

            # lazily DP-wrapped exact programs for the rare u8-overflow
            # re-dispatch (a row with some count > 255)
            exact: dict[str, object] = {}

            def consume(meta, fused) -> None:
                agg = aggs[meta.range_id]
                emitter = emitters[meta.range_id]
                arr = np.asarray(fused)
                if arr.dtype == np.int16:
                    # exact fused [counts | total] (native CPU sink)
                    ridx, vecs, tots = agg.add_batch(
                        meta.read_idx, meta.last_row,
                        arr[:, :nbins], arr[:, nbins].astype(np.int32),
                    )
                    emitter.add(ridx, vecs, tots)
                    return
                tot = (
                    arr[:, nbins].astype(np.int32)
                    | arr[:, nbins + 1].astype(np.int32) << 8
                )
                rmax = (
                    arr[:, nbins + 2].astype(np.int32)
                    | arr[:, nbins + 3].astype(np.int32) << 8
                )
                if bool((rmax > 255).any()):
                    # exact re-dispatch of the whole batch as int16
                    packed, vb, n_ambig = meta.planes()
                    if n_ambig == 0:
                        fn = exact.setdefault(
                            "clean", data_parallel_step(step_clean_i16)
                        )
                        arr16 = np.asarray(fn(packed, meta.lengths))
                    else:
                        fn = exact.setdefault(
                            "planes", data_parallel_step(step_planes_i16)
                        )
                        arr16 = np.asarray(fn(packed, vb))
                    counts = arr16[:, :nbins]
                    tot = arr16[:, nbins].astype(np.int32)
                else:
                    counts = arr[:, :nbins].astype(np.int16)
                ridx, vecs, tots = agg.add_batch(
                    meta.read_idx, meta.last_row, counts, tot,
                )
                emitter.add(ridx, vecs, tots)

            # pipeline: the main thread parses/packs/uploads/dispatches;
            # the writer thread fetches results and formats/writes —
            # device compute, host-device transfers, and disk writes all
            # overlap. Codes travel 2-bit packed; ambiguity-free
            # batches (the common case) skip the valid-bit plane and
            # ship row lengths instead — exactly 2 bits/base on the
            # wire, the upload entropy floor. With >1 device the step
            # row-shards over the mesh (DP); when the host-CPU backend
            # is also registered, CPU devices form a second sink and
            # batches route to whichever silicon is free (hetero).
            def make_dispatch(devs):
                sp = data_parallel_step(
                    lambda p, v: _fuse_u8(*_hist(encode.unpack_planes(p, v))),
                    devices=devs,
                )
                sc = data_parallel_step(
                    lambda p, ln: _fuse_u8(*_hist(encode.unpack_packed(p, ln))),
                    devices=devs,
                )

                def dispatch(b):
                    packed, vb, n_ambig = b.planes()
                    if n_ambig == 0:
                        return sc(packed, b.lengths)
                    return sp(packed, vb)

                return dispatch

            native_sink = oligo_hist_native_sink(
                self.ksize, nbins, self.count_min, self.threads
            )
            dispatches, keys, stream_target, coalesce, rtts = (
                plan_hetero_sinks(
                    make_dispatch,
                    native_sink,
                    f"oligo{self.ksize}",
                    self.target_codes,
                    self.n_devices,
                )
            )
            if nprod > 1:
                batches = iob.multi_range_stream(
                    self.in_path,
                    overlap=self.ksize - 1,
                    target_codes=stream_target,
                    nproducers=nprod,
                )
            else:
                batches = iob.stream_path(
                    self.in_path,
                    overlap=self.ksize - 1,
                    target_codes=stream_target,
                    shard=self.input_shard,
                )
            ok = False
            try:
                run_pipelined_hetero(
                    batches,
                    dispatches,
                    consume,
                    weight=lambda b: int(b.lengths.sum()),
                    keys=keys,
                    coalesce=coalesce,
                    rtts=rtts,
                    total_weight=estimate_stream_codes(
                        self.in_path, self.input_shard
                    ),
                    # stuck-remote-frontier fallback: the native kernel
                    # run synchronously (bit-identical int16 fused
                    # result; the consume path handles both layouts)
                    recompute=(
                        (lambda b: np.asarray(native_sink(b)))
                        if native_sink is not None else None
                    ),
                    unordered_ok=batch_self_contained,
                )
                for agg in aggs:
                    agg.finish()
                for emitter in emitters:
                    emitter.finish()
                ok = True
            finally:
                parted.close(success=ok)
