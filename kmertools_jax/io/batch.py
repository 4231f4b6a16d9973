"""Host-side batch assembly: streaming reads -> fixed-shape device batches.

The reference's concurrency model is N CPU threads pulling reads off a
shared mutex-guarded iterator (composition/src/oligo.rs:192-226). The
device equivalent is this module: the host packs reads into padded,
length-bucketed 2-bit-code batches of *static* shape, so every device
step hits the same compiled XLA program.

Key properties:
  * base codes (0..3, 4 = ambiguous/pad) via the shared 256-entry LUT
  * length bucketing: a read goes to the smallest row width that fits
  * long reads are split into multiple rows with `overlap` shared bases
    so windowed features (k-mers, minimiser windows) are computed
    exactly once across row boundaries
  * a bucket flushes when it reaches its fixed row count; EOF flushes
    padded partial batches — shapes never vary within a bucket
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator

import numpy as np

from kmertools_jax.io.fastx import Sequence
from kmertools_jax.utils.codec import SEQ_NT4_TABLE

import os

# Dense ladder (all multiples of 128): worst-case padding <= 1.5x and
# typically <= 1.33x, vs 4x for a pure power-of-two ladder. Padding is
# not just wasted device work — every padded code also crosses the
# host->device wire. Each width
# compiles each workload's step once per machine (persistent cache).
DEFAULT_ROW_WIDTHS = (
    128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096, 5120, 6144, 8192,
)
DEFAULT_TARGET_CODES = int(os.environ.get("KMERTOOLS_TARGET_CODES", 1 << 22))


class Batch:
    """One fixed-shape batch of encoded reads.

    Rows carry uint8 base codes (0..3, 4 = ambiguous or padding). The
    codes exist in two interchangeable representations, each built
    lazily from the other and cached:

      * ``codes``    — (R, W) u8, one byte per base (host compute)
      * ``planes()`` — ((R, W/4) 2-bit packed, (R, W/8) valid bits,
        n_ambig) — the upload wire format (ops/encode.py:unpack_planes)

    The native batcher produces planes directly (never materialising a
    Python-side codes array); the pure-Python batcher produces codes.
    Workloads ask for whichever side they need.
    """

    __slots__ = (
        "_codes", "_planes", "lengths", "read_idx", "row_start",
        "last_row", "_ids", "_read_lengths", "_ids_raw", "range_id",
    )

    def __init__(self, lengths, read_idx, row_start, last_row, ids=None,
                 read_lengths=None, codes=None, planes=None, ids_raw=None):
        assert codes is not None or planes is not None
        assert ids is not None or ids_raw is not None
        self._codes = codes
        self._planes = planes
        # input-range tag for multi-producer streams (multi_range_stream):
        # read_idx numbering is local to this range and per-range outputs
        # concatenate in range order. Single-producer streams leave it 0.
        self.range_id = 0
        self.lengths = lengths  # (R,) int32 valid codes per row
        self.read_idx = read_idx  # (R,) int64 global read index, -1 = pad row
        self.row_start = row_start  # (R,) int64 row's first-base offset
        self.last_row = last_row  # (R,) bool, row is its read's final row
        # ids of reads whose FIRST row is in this batch, in one of two
        # interchangeable forms (dicts built lazily from raw — decoding
        # half a million id strings per batch into dict entries was 30%
        # of the minimiser wall on short reads, and the histogram
        # workloads never look at ids at all):
        #   _ids/_read_lengths — read_idx -> id str / full read length
        #   _ids_raw — (blob bytes "id\0id\0...", offs int64 (n+1,),
        #               ridx int64 (n,), rlens int64 (n,)) in row order
        self._ids = ids
        self._read_lengths = read_lengths
        self._ids_raw = ids_raw

    @property
    def ids(self) -> dict:
        if self._ids is None:
            blob, offs, ridx, _ = self._ids_raw
            self._ids = {
                int(r): blob[offs[i]:offs[i + 1] - 1].decode()
                for i, r in enumerate(ridx)
            }
        return self._ids

    @property
    def read_lengths(self) -> dict:
        if self._read_lengths is None:
            _, _, ridx, rlens = self._ids_raw
            self._read_lengths = {
                int(r): int(l) for r, l in zip(ridx, rlens)
            }
        return self._read_lengths

    def ids_raw(self):
        """(blob, offs, ridx, rlens) or None (dict-built batches)."""
        return self._ids_raw

    @property
    def codes(self) -> np.ndarray:
        if self._codes is None:
            packed, vb, _ = self._planes
            R, Wq = packed.shape
            shifts = np.arange(4, dtype=np.uint8) * 2
            codes = (
                (packed[:, :, None] >> shifts[None, None, :]) & np.uint8(3)
            ).reshape(R, Wq * 4)
            valid = np.unpackbits(
                vb, axis=1, bitorder="little", count=Wq * 4
            )
            self._codes = np.where(valid == 1, codes, np.uint8(4))
        return self._codes

    def planes(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(packed, validbits, n_ambig) — see pack_planes."""
        if self._planes is None:
            self._planes = pack_planes(self._codes, self.lengths)
        return self._planes


@dataclass
class _Bucket:
    width: int
    rows: int
    codes: np.ndarray
    lengths: np.ndarray
    read_idx: np.ndarray
    row_start: np.ndarray
    last_row: np.ndarray
    fill: int = 0
    ids: dict = field(default_factory=dict)
    read_lengths: dict = field(default_factory=dict)

    def reset(self) -> None:
        self.fill = 0
        self.codes.fill(4)
        self.lengths.fill(0)
        self.read_idx.fill(-1)
        self.row_start.fill(0)
        self.last_row.fill(False)
        self.ids = {}
        self.read_lengths = {}

    def snapshot(self) -> Batch:
        return Batch(
            codes=self.codes.copy(),
            lengths=self.lengths.copy(),
            read_idx=self.read_idx.copy(),
            row_start=self.row_start.copy(),
            last_row=self.last_row.copy(),
            ids=self.ids,
            read_lengths=self.read_lengths,
        )


def pack_planes(
    codes: np.ndarray, lengths: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray, int]:
    """(R, W) u8 codes -> ((R, W/4) 2-bit packed, (R, W/8) valid bits,
    n_ambig).

    The host half of ops.encode.unpack_planes. ``n_ambig`` counts
    ambiguous codes inside the given row ``lengths``; when it is 0 the
    valid plane carries no information beyond the lengths, so callers
    can upload ``(packed, lengths)`` to ops.encode.unpack_packed —
    exactly 2 bits/base on the wire, the entropy floor for DNA — and
    skip the bit plane entirely. Without ``lengths`` n_ambig is -1
    (unknown; callers must use the plane). Bucket widths are multiples
    of 8. Native single-pass packer when available; vectorised numpy
    otherwise (identical output)."""
    from kmertools_jax import native

    so = native.lib()
    R, W = codes.shape
    if so is not None:
        codes = np.ascontiguousarray(codes)
        packed = np.empty((R, W // 4), dtype=np.uint8)
        vb = np.empty((R, W // 8), dtype=np.uint8)
        if lengths is not None:
            lengths = np.ascontiguousarray(lengths, dtype=np.int32)
            lens_p = lengths.ctypes.data_as(native.c_i32_p)
        else:
            lens_p = None
        n = so.kt_pack_planes(
            codes.ctypes.data_as(native.c_u8_p), R, W, lens_p,
            packed.ctypes.data_as(native.c_u8_p),
            vb.ctypes.data_as(native.c_u8_p),
        )
        if n >= 0:
            return packed, vb, (int(n) if lengths is not None else -1)
    valid = codes < 4
    c = np.where(valid, codes, 0).astype(np.uint8)
    packed = (
        c[:, 0::4]
        | (c[:, 1::4] << 2)
        | (c[:, 2::4] << 4)
        | (c[:, 3::4] << 6)
    )
    vb = np.packbits(valid, axis=1, bitorder="little")
    if lengths is None:
        return packed, vb, -1
    in_len = np.arange(W)[None, :] < np.asarray(lengths)[:, None]
    return packed, vb, int(np.count_nonzero(~valid & in_len))


def encode_bases(seq: bytes) -> np.ndarray:
    """ASCII bytes -> uint8 codes via the minimap2-style LUT
    (kmer/src/kmer.rs:6-15 semantics)."""
    return SEQ_NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)]


def batch_stream(
    records: Iterable[Sequence],
    overlap: int,
    row_widths: tuple[int, ...] = DEFAULT_ROW_WIDTHS,
    target_codes: int = DEFAULT_TARGET_CODES,
) -> Iterator[Batch]:
    """Pack a record stream into fixed-shape batches.

    `overlap` is the number of bases shared between consecutive rows of
    a split read (k-1 for k-mer features, w-1 for minimiser windows).
    """
    widths = tuple(sorted(row_widths))
    max_w = widths[-1]
    if overlap >= max_w:
        raise ValueError(f"overlap {overlap} must be < max row width {max_w}")
    buckets = {}
    for w in widths:
        # multiple of 8 so the mesh DP path can row-shard full buckets
        rows = max(8, (target_codes // w) & ~7)
        buckets[w] = _Bucket(
            width=w,
            rows=rows,
            codes=np.full((rows, w), 4, dtype=np.uint8),
            lengths=np.zeros(rows, dtype=np.int32),
            read_idx=np.full(rows, -1, dtype=np.int64),
            row_start=np.zeros(rows, dtype=np.int64),
            last_row=np.zeros(rows, dtype=bool),
        )

    def put_row(width: int, chunk: np.ndarray, ridx: int, start: int, last: bool,
                rid: str | None, rlen: int | None):
        b = buckets[width]
        i = b.fill
        b.codes[i, : len(chunk)] = chunk
        b.lengths[i] = len(chunk)
        b.read_idx[i] = ridx
        b.row_start[i] = start
        b.last_row[i] = last
        if rid is not None:
            b.ids[ridx] = rid
            b.read_lengths[ridx] = rlen
        b.fill += 1
        if b.fill == b.rows:
            out = b.snapshot()
            b.reset()
            return out
        return None

    stride = max_w - overlap
    for rec in records:
        codes = encode_bases(rec.seq)
        L = len(codes)
        first = True
        if L <= max_w:
            # single row: smallest width that fits
            for w in widths:
                if L <= w:
                    out = put_row(w, codes, rec.n, 0, True, rec.id, L)
                    if out is not None:
                        yield out
                    break
        else:
            start = 0
            while start < L:
                end = min(start + max_w, L)
                chunk = codes[start:end]
                last = end >= L
                out = put_row(
                    max_w, chunk, rec.n, start, last,
                    rec.id if first else None, L if first else None,
                )
                if out is not None:
                    yield out
                first = False
                if last:
                    break
                start += stride
    for b in buckets.values():
        if b.fill > 0:
            out = b.snapshot()
            b.reset()
            yield out


def _fmt_hint(path: str) -> int:
    """Extension-based format hint for the native parser (0 = sniff
    from the first line, 1 = FASTA, 2 = FASTQ) — the reference detects
    by extension (ktio/src/seq.rs:30-41) and only content-sniffs
    extension-less input."""
    from kmertools_jax.io.fastx import SeqFormat, sniff_format

    fmt = sniff_format(path)
    if fmt is SeqFormat.FASTA:
        return 1
    if fmt is SeqFormat.FASTQ:
        return 2
    return 0


def native_batch_stream(
    path: str,
    overlap: int,
    row_widths: tuple[int, ...] = DEFAULT_ROW_WIDTHS,
    target_codes: int = DEFAULT_TARGET_CODES,
    byte_range: tuple[int, int] | None = None,
) -> Iterator[Batch]:
    """batch_stream via the C++ host runtime (kmertools_jax.native).

    ``byte_range=(start, end)`` restricts the stream to a record-
    aligned byte range of a PLAIN file (a multi-host shard); read
    numbering is range-local."""
    import ctypes

    from kmertools_jax import native

    so = native.lib()
    assert so is not None
    widths = np.array(sorted(row_widths), dtype=np.int64)
    if byte_range is not None:
        h = so.kt_batcher_open_range(
            path.encode(),
            overlap,
            widths.ctypes.data_as(native.c_i64_p),
            len(widths),
            target_codes,
            _fmt_hint(path),
            byte_range[0],
            byte_range[1],
        )
    else:
        h = so.kt_batcher_open(
            path.encode(),
            overlap,
            widths.ctypes.data_as(native.c_i64_p),
            len(widths),
            target_codes,
            _fmt_hint(path),
        )
    if not h:
        raise FileNotFoundError(path)
    try:
        while True:
            bi = so.kt_batcher_next(h)
            if bi < 0:
                return
            rows = ctypes.c_int64()
            width = ctypes.c_int64()
            fill = ctypes.c_int64()
            so.kt_bucket_shape(h, bi, rows, width, fill)
            R, W = rows.value, width.value
            codes_p = native.c_u8_p()
            len_p = native.c_i32_p()
            ridx_p = native.c_i64_p()
            rstart_p = native.c_i64_p()
            last_p = native.c_u8_p()
            blob_p = ctypes.c_char_p()
            blob_len = ctypes.c_int64()
            idr_p = native.c_i64_p()
            idl_p = native.c_i64_p()
            n_ids = ctypes.c_int64()
            so.kt_bucket_data(
                h, bi, codes_p, len_p, ridx_p, rstart_p, last_p,
                blob_p, blob_len, idr_p, idl_p, n_ids,
            )
            # everything is copied out of the C++-owned bucket buffers:
            # consumers (pipelined workloads) hold Batch objects across
            # iterations, after which the buckets are reset and refilled.
            # Codes leave as 2-bit planes packed straight from the
            # bucket's buffer (kt_pack_planes releases the GIL) — the
            # wire format every device step uploads; a byte-per-base
            # copy is never made unless a host path asks for .codes.
            lengths = np.ctypeslib.as_array(len_p, shape=(R,)).copy()
            packed = np.empty((R, W // 4), dtype=np.uint8)
            vb = np.empty((R, W // 8), dtype=np.uint8)
            n_ambig = int(
                so.kt_pack_planes(
                    codes_p, R, W,
                    len_p,
                    packed.ctypes.data_as(native.c_u8_p),
                    vb.ctypes.data_as(native.c_u8_p),
                )
            )
            read_idx = np.ctypeslib.as_array(ridx_p, shape=(R,)).copy()
            row_start = np.ctypeslib.as_array(rstart_p, shape=(R,)).copy()
            last_row = np.ctypeslib.as_array(last_p, shape=(R,)).astype(bool)
            nid = n_ids.value
            if nid:
                blob = ctypes.string_at(blob_p, blob_len.value)
                idr = np.ctypeslib.as_array(idr_p, shape=(nid,)).copy()
                idl = np.ctypeslib.as_array(idl_p, shape=(nid,)).copy()
                # the blob is already "id\0id\0..." in row order; the
                # NUL positions delimit ids without materialising one
                # Python string per read
                offs = np.empty(nid + 1, dtype=np.int64)
                offs[0] = 0
                offs[1:] = (
                    np.flatnonzero(np.frombuffer(blob, np.uint8) == 0) + 1
                )
            else:
                blob = b""
                offs = np.zeros(1, dtype=np.int64)
                idr = idl = np.empty(0, dtype=np.int64)
            yield Batch(
                planes=(packed, vb, n_ambig),
                lengths=lengths,
                read_idx=read_idx,
                row_start=row_start,
                last_row=last_row,
                ids_raw=(blob, offs, idr, idl),
            )
    finally:
        so.kt_batcher_close(h)


def multi_range_stream(
    path: str,
    overlap: int,
    row_widths: tuple[int, ...] = DEFAULT_ROW_WIDTHS,
    target_codes: int = DEFAULT_TARGET_CODES,
    nproducers: int = 2,
) -> Iterator[Batch]:
    """Merge ``nproducers`` range-restricted native batch streams.

    The file splits into record-aligned byte ranges
    (parallel.dataflow.split_file); each range runs its own native
    batcher — and therefore its own C++ parse-ahead thread — so host
    parsing scales across cores instead of serialising on one stream.
    This is the single-node analog of the reference's N rayon threads
    all parsing from the shared iterator (composition/src/oligo.rs:
    192-226): there the parse work spreads across the pool implicitly;
    here each producer owns a disjoint slice of the file.

    Batches are tagged with ``range_id``; read numbering is range-local,
    so consumers keep one ordered emitter per range and concatenate
    per-range outputs in range order (exactly the multi-host part
    scheme, parallel/multihost.py, applied in-process).
    """
    import queue as _queue
    import threading

    from kmertools_jax.parallel import dataflow

    shards = dataflow.split_file(path, nproducers)
    out_q: _queue.Queue = _queue.Queue(maxsize=2 * len(shards))
    errs: list[BaseException] = []
    stop: list[int] = []

    def run(sh) -> None:
        try:
            for b in native_batch_stream(
                path, overlap, row_widths, target_codes,
                byte_range=(sh.start, sh.end),
            ):
                b.range_id = sh.index
                while not stop:
                    try:
                        out_q.put(b, timeout=0.25)
                        break
                    except _queue.Full:
                        continue
                if stop:
                    return
        except BaseException as e:  # re-raised on the consumer side
            errs.append(e)
        finally:
            # sentinel put must not deadlock when the consumer abandoned
            # the stream with the queue full
            while True:
                try:
                    out_q.put(None, timeout=0.25)
                    break
                except _queue.Full:
                    if stop:
                        break

    threads = [
        threading.Thread(target=run, args=(sh,), daemon=True)
        for sh in shards
    ]
    for t in threads:
        t.start()
    done = 0
    try:
        while done < len(threads):
            item = out_q.get()
            if item is None:
                done += 1
                continue
            yield item
    finally:
        stop.append(1)
        for t in threads:
            t.join()
    if errs:
        raise errs[0]


def stream_path(
    path: str,
    overlap: int,
    row_widths: tuple[int, ...] = DEFAULT_ROW_WIDTHS,
    target_codes: int = DEFAULT_TARGET_CODES,
    shard=None,
) -> Iterator[Batch]:
    """Batches from a file path ("-" = stdin): native C++ runtime when
    available, pure Python otherwise. Both yield identical Batch
    streams.

    `shard` (a parallel.dataflow.Shard) restricts the stream to one
    host's record-aligned byte range for multi-host runs; read
    numbering is shard-local so per-host outputs concatenate in shard
    order."""
    from kmertools_jax import native

    if shard is not None:
        # shards only exist for plain (non-gz, non-stdin) files
        # (parallel/dataflow.split_file rejects the rest), so the
        # native batcher reads the byte range directly — without this
        # every multi-host run lost the whole native parse path
        # (measured 3x on 2-host oligo)
        if native.lib() is not None:
            return native_batch_stream(
                path, overlap, row_widths, target_codes,
                byte_range=(shard.start, shard.end),
            )
        from kmertools_jax.parallel import dataflow

        return batch_stream(
            dataflow.shard_sequences(path, shard), overlap, row_widths,
            target_codes,
        )
    if native.lib() is not None:
        return native_batch_stream(path, overlap, row_widths, target_codes)
    from kmertools_jax.io import fastx

    return batch_stream(
        fastx.sequences(path), overlap, row_widths, target_codes
    )
