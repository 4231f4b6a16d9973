"""Out-of-core exact k-mer counter (counter/src/lib.rs analog).

Phases, matching the reference's layout on disk:
  * count: stream batches; device sorts+RLEs each batch's canonical
    k-mers (ops.count); the host merges batch runs into the chunk
    accumulator; when the chunk's base count passes the memory gate
    (1e9 * mem_gb / 8, counter/src/lib.rs:114-116) the chunk spills to
    ``{out}/temp_kmers.part_{p}_chunk_{c}`` TSVs, partitioned by
    ``kmer % n_parts`` (lib.rs:127).
  * merge: per partition, re-aggregate all chunk spills and append to
    ``{out}/kmers.counts`` as ``kmer\\tcount`` (numeric or ACGT keys),
    optionally deleting the temps (lib.rs:172-234).

The spill files are the durable intermediates (resume point): `merge`
runs standalone over pre-existing temps given `chunks`/`n_parts`, like
the reference's merge-only tests (lib.rs:279-293). A manifest.json
records both so a resume doesn't need to re-derive them.

Output row order is sorted by k-mer (deterministic); the reference's
map-scan order is nondeterministic and its tests sort before comparing
(lib.rs:271-275).
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import queue
import threading
import time

import numpy as np
import jax.numpy as jnp

from kmertools_jax.io import batch as iob
from kmertools_jax.io import fastx
from kmertools_jax.ops import count as cops
from kmertools_jax.utils import codec
from kmertools_jax.utils.fops import delete_file_if_exists
from kmertools_jax.utils.progress import Progress


def _aggregate(kmers: np.ndarray, counts: np.ndarray):
    """Sum counts of duplicate keys; returns sorted unique (k, c)."""
    order = np.argsort(kmers, kind="stable")
    k = kmers[order]
    c = counts[order]
    if len(k) == 0:
        return k, c
    firsts = np.empty(len(k), dtype=bool)
    firsts[0] = True
    firsts[1:] = k[1:] != k[:-1]
    starts = np.flatnonzero(firsts)
    # group sums via cumsum differences (np.add.reduceat is ~2x slower)
    csum = np.concatenate([[np.uint64(0)], np.cumsum(c, dtype=np.uint64)])
    ends = np.append(starts[1:], len(k))
    return k[starts], csum[ends] - csum[starts]


def _merge_chunk_tables(cur: list):
    """One partition's chunk tables -> sorted unique (keys, counts).

    CONSUMES ``cur``. Fast path: every chunk sorted ascending (all of
    this framework's spills are) -> native streaming k-way sum-merge
    (kthost.cpp:kt_merge_sum_kv), peak = inputs + output. Foreign
    spills (the reference writes map-scan order; its merge-only golden
    fixture is unsorted) fall back to concatenate + sort-aggregate,
    consuming the list as it concatenates. Measured before the fast
    path: a 2.4 Gbase merge (415M rows/partition) transiently held ~4x
    the partition and OOM-killed a 128 GB host."""
    from kmertools_jax import native

    so = native.lib()
    if so is not None and all(
        len(k) == 0 or bool(np.all(k[1:] >= k[:-1])) for k, _ in cur
    ):
        parts = [(k, c) for k, c in cur if len(k)]
        cur.clear()
        if not parts:
            return np.empty(0, np.uint64), np.empty(0, np.uint64)
        ks = [np.ascontiguousarray(k, dtype=np.uint64) for k, _ in parts]
        cs = [np.ascontiguousarray(c, dtype=np.uint64) for _, c in parts]
        del parts
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
        n = so.kt_merge_sum_kv(
            kp, cp, lens.ctypes.data_as(native.c_i64_p), len(ks),
            ok.ctypes.data_as(native.c_u64_p),
            oc.ctypes.data_as(native.c_u64_p),
        )
        if n >= 0:
            if n < total // 2:  # heavy dedup: don't pin the full cap
                return ok[:n].copy(), oc[:n].copy()
            return ok[:n], oc[:n]
    # fallback: consume the list while concatenating
    keys_parts = [k for k, _ in cur]
    cnts_parts = [c for _, c in cur]
    cur.clear()
    kmers = np.concatenate(keys_parts) if keys_parts else np.empty(
        0, np.uint64
    )
    keys_parts.clear()
    counts = np.concatenate(cnts_parts) if cnts_parts else np.empty(
        0, np.uint64
    )
    cnts_parts.clear()
    return _aggregate(kmers, counts)


_CHUNK_LINES = 1 << 20  # streaming format chunk: buffer stays cache-warm


def _write_tsv_stream(out, kmers: np.ndarray, counts: np.ndarray,
                      acgt_k: int | None = None) -> None:
    """Stream `key\\tcount` lines to `out` in bounded chunks.

    One reused ~45MB buffer instead of a whole-output allocation: a 13M
    line merge previously spent more time zeroing/copying a 550MB
    buffer than formatting into it."""
    n_total = len(kmers)
    if not n_total:
        return
    from kmertools_jax import native

    so = native.lib()
    if so is None:
        if acgt_k is not None:
            keys = codec.numeric_to_kmer_array(kmers, acgt_k)
            keys = np.char.decode(keys.astype(f"S{acgt_k}"))
        else:
            keys = np.char.mod("%d", kmers.astype(np.uint64))
        vals = np.char.mod("%d", counts.astype(np.uint64))
        out.write(
            ("\n".join(np.char.add(np.char.add(keys, "\t"), vals).tolist())
             + "\n").encode()
        )
        return
    per_line = (acgt_k + 22) if acgt_k is not None else 42
    arr, buf = native.out_buf(_CHUNK_LINES * per_line)
    view = memoryview(arr)
    for s in range(0, n_total, _CHUNK_LINES):
        e = min(s + _CHUNK_LINES, n_total)
        k = np.ascontiguousarray(kmers[s:e], dtype=np.uint64)
        c = np.ascontiguousarray(counts[s:e], dtype=np.uint64)
        if acgt_k is not None:
            n = so.kt_format_acgt_tsv(
                k.ctypes.data_as(native.c_u64_p),
                c.ctypes.data_as(native.c_u64_p),
                len(k), acgt_k, buf,
            )
        else:
            n = so.kt_format_u64_tsv(
                k.ctypes.data_as(native.c_u64_p),
                c.ctypes.data_as(native.c_u64_p),
                len(k), buf,
            )
        out.write(view[:n])


def _format_tsv(kmers: np.ndarray, counts: np.ndarray) -> bytes:
    """`kmer\\tcount` lines as bytes (spill files are small per part)."""
    import io as _io

    sink = _io.BytesIO()
    _write_tsv_stream(sink, kmers, counts)
    return sink.getvalue()


def _write_tsv(path: str, kmers: np.ndarray, counts: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(_format_tsv(kmers, counts))


def _read_tsv(path: str):
    with open(path, "rb") as f:
        data = f.read()
    from kmertools_jax import native

    so = native.lib()
    if so is not None and data:
        cap = data.count(b"\n") + 2
        kmers = np.empty(cap, dtype=np.uint64)
        counts = np.empty(cap, dtype=np.uint64)
        n = so.kt_parse_u64_tsv(
            data, len(data),
            kmers.ctypes.data_as(native.c_u64_p),
            counts.ctypes.data_as(native.c_u64_p),
        )
        return kmers[:n].copy(), counts[:n].copy()
    kmers = []
    counts = []
    for line in data.splitlines():
        line = line.strip()
        if not line:
            continue
        a, b = line.split(b"\t")
        kmers.append(int(a))
        counts.append(int(b))
    return np.array(kmers, dtype=np.uint64), np.array(counts, dtype=np.uint64)


def _pow2_at_least(n: int, floor: int = 1 << 10) -> int:
    return max(floor, 1 << max(0, (n - 1).bit_length()))


# Counter batch code budget. Each batch runs the bitonic merge network
# over the whole accumulator (ops/count.py:merge_sorted_batch), whose
# program grows with C + batch; 1<<18 keeps networks at the ~4M scale.
# Its cost on the GPU against larger batches is not measured yet.
# KMERTOOLS_CTR_TARGET overrides it.
_CTR_TARGET_CODES = int(os.environ.get("KMERTOOLS_CTR_TARGET", 0)) or None
# an env-set target is an explicit user choice: the host-path batch
# floor must not override it (only the construction default)
_CTR_TARGET_EXPLICIT = "KMERTOOLS_CTR_TARGET" in os.environ


def _default_ctr_target() -> int:
    return _CTR_TARGET_CODES or (1 << 18)


_DRAIN_PIECE_FLOOR = 1 << 16


def _prefix_pieces(n: int, cap: int) -> list:
    """Decompose a prefix fetch of n entries into a few power-of-two
    (offset, size) pieces (each size compiles one tiny dynamic_slice
    program, reused forever). Covers ceil(n / floor) * floor entries,
    so transfer overshoot is < 1 piece instead of the up-to-2x of a
    single pow2 bucket."""
    m = min(cap, -(-n // _DRAIN_PIECE_FLOOR) * _DRAIN_PIECE_FLOOR)
    pieces = []
    off = 0
    rem = m
    while rem:
        size = 1 << (rem.bit_length() - 1)
        size = max(size, _DRAIN_PIECE_FLOOR)
        size = min(size, cap - off)
        pieces.append((off, size))
        off += size
        rem = max(0, m - off)
    return pieces


@functools.lru_cache(maxsize=None)
def _slice_fn(size: int, narrow: int):
    """Prefix-piece fetch, optionally narrowed on-device before the
    wire: narrow=0 keeps u32, 16/8 cast to uint16/uint8, 4/2 BIT-PACK
    (2 or 4 values per byte, low value in the low bits) — exact either
    way, the caller proved the plane's max fits. Counts on all-distinct
    corpora are almost all 1, so the flagship count plane ships at 2
    bits/unique instead of 8 (round 5 drain wire)."""
    import jax
    from jax import lax as jlax

    def f(arr, off):
        s = jlax.dynamic_slice(arr, (off,), (size,))
        if narrow in (8, 16):
            return s.astype(jnp.uint16 if narrow == 16 else jnp.uint8)
        if narrow in (2, 4):
            per = 8 // narrow
            v = s.reshape(size // per, per).astype(jnp.uint32)
            sh = jnp.arange(per, dtype=jnp.uint32) * narrow
            return jnp.sum(v << sh[None, :], axis=1).astype(jnp.uint8)
        return s

    return jax.jit(f)


def _unpack_bits(packed: "np.ndarray", bits: int) -> "np.ndarray":
    """Host inverse of _slice_fn's 2/4-bit packing -> uint32."""
    per = 8 // bits
    sh = (np.arange(per, dtype=np.uint8) * bits)[None, :]
    vals = (packed[:, None] >> sh) & ((1 << bits) - 1)
    return vals.reshape(-1).astype(np.uint32)


# deltas >= 2^24 ship as (position, value) exceptions; canonical-key
# skew leaves the near-diagonal hi runs sparse, so a handful of giant
# gaps always exist even when the dense runs' gaps are tiny
_LO24_EXC_CAP = 1 << 14


def _intra_deltas(ah, al):
    """Per-position lo delta vs the previous element, zeroed at hi-run
    boundaries and index 0 (their absolutes ship separately)."""
    d = al - jnp.roll(al, 1)
    same = ah == jnp.roll(ah, 1)
    idx = jnp.arange(al.shape[0], dtype=jnp.int32)
    return jnp.where(same & (idx > 0), d, jnp.uint32(0))


@functools.lru_cache(maxsize=None)
def _wire_stats_fn():
    """One fetch deciding the drain wire: [max count, number of
    intra-run deltas >= 2^24 (the 24-bit wire's exception count)]."""
    import jax

    def f(ah, al, ac):
        intra = _intra_deltas(ah, al)
        n_big = jnp.sum(
            (intra >= jnp.uint32(1 << 24)).astype(jnp.int32)
        )
        # int32 wire: counts cap at u32 but the stats only pick a
        # bucket — clamp instead of widening (x64 is disabled)
        mc = jnp.minimum(jnp.max(ac), jnp.uint32(0x7FFFFFFF))
        return jnp.stack([mc.astype(jnp.int32), n_big])

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _lo_exc_fn(cap: int):
    """(positions, delta values) of the intra-run deltas >= 2^24,
    padded to `cap` with out-of-range positions (static shape; the host
    filters pos < n)."""
    import jax

    def f(ah, al):
        intra = _intra_deltas(ah, al)
        big = intra >= jnp.uint32(1 << 24)
        (pos,) = jnp.nonzero(big, size=cap, fill_value=al.shape[0])
        dv = jnp.take(intra, jnp.minimum(pos, al.shape[0] - 1), mode="clip")
        return pos.astype(jnp.int32), dv

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _lo24_fn(size: int, first: bool):
    """lo plane piece as 24-bit DELTAS (3 u8 planes): within a hi run
    the sorted lo plane's gaps are ~keyspace/uniques (< 2^24 whenever
    a run holds > ~2^8 uniques; _wire_stats_fn proves it) — 3 bytes per
    unique instead of 4. Boundary positions wrap; the host overwrites
    them from the separately-shipped absolute values. ``first`` (piece
    at offset 0): the predecessor of element 0 is a virtual 0 — a
    clamped off-1 slice would alias the piece itself and zero every
    delta."""
    import jax
    from jax import lax as jlax

    def f(al, off):
        s = jlax.dynamic_slice(al, (off,), (size,))
        if first:
            prev = jnp.where(
                jnp.arange(size) == 0, jnp.uint32(0), jnp.roll(s, 1)
            )
        else:
            prev = jlax.dynamic_slice(al, (off - 1,), (size,))
        d = s - prev
        return jnp.stack(
            [d & 0xFF, (d >> 8) & 0xFF, (d >> 16) & 0xFF]
        ).astype(jnp.uint8)

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _grow_fn(c_old: int, c_new: int):
    """Extend the accumulator state with a sentinel tail (donated
    in-place from the host's view). Runs on device: growth never moves
    the live prefix through the host."""
    import jax

    pad = c_new - c_old

    def f(ah, al, ac):
        s = jnp.uint32(0xFFFFFFFF)
        return (
            jnp.concatenate([ah, jnp.full((pad,), s, jnp.uint32)]),
            jnp.concatenate([al, jnp.full((pad,), s, jnp.uint32)]),
            jnp.concatenate([ac, jnp.zeros((pad,), jnp.uint32)]),
        )

    # no donation: the outputs are LARGER than the inputs, so XLA can
    # never reuse the buffers and warns; the old state frees when the
    # caller drops its references
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _max_fn():
    import jax

    return jax.jit(lambda a: jnp.max(a))


@functools.lru_cache(maxsize=None)
def _hi_bounds_fn(nh: int):
    """Positions where the sorted accumulator's hi plane first reaches
    each value v in [0, nh]: the hi halves are monotone (live prefix
    sorted, sentinel tail = max), so `nh+1` boundaries reconstruct the
    whole plane — the drain ships ~4(nh+1) bytes instead of 2 bytes per
    unique (compact drain wire, VERDICT r4 item 4)."""
    import jax

    def f(ah, al):
        v = jnp.arange(nh + 1, dtype=ah.dtype)
        b = jnp.searchsorted(ah, v, method="scan").astype(jnp.int32)
        # absolute lo at each boundary: the 24-bit delta wire's anchor
        # values (deltas wrap where lo resets; ~4 KB rides along)
        bl = jnp.take(al, jnp.minimum(b, al.shape[0] - 1), mode="clip")
        return b, bl

    return jax.jit(f)


class DeviceAccumulator:
    """Device-resident sorted-unique (hi, lo, count) accumulator.

    The count phase's working state LIVES ON DEVICE: every batch's
    canonical k-mers merge into it via sort + segmented RLE
    (ops/count.py:accum_merge), so device->host transfer happens only
    at drain time and is proportional to UNIQUE k-mers — never to
    occurrences (the reference's in-memory scc maps have the same
    property, counter/src/lib.rs:123-132).

    With >1 visible device the state shards over a 1-D mesh by k-mer
    partition (``lo % ndev``) and batches exchange partitions with an
    all_to_all (parallel/ops.py:sharded_accum_count) — the `min_mer % n_parts`
    scaling mechanism running on the mesh. Exchange-bucket overflow
    rolls the batch back on-device; the host retries it in halves.

    The host polls each batch's post-merge unique count with a fixed
    lag (keeping the dispatch queue deep enough to overlap transfers
    and compute) and drains to host before the accumulator can
    overflow: capacity C minus (lag+2) batches of worst-case growth.
    """

    _LAG = 2
    # single-device runs resolve pending batches in groups of this many
    # with ONE n-fetch (post-merge unique counts are monotone, so the
    # newest batch's n bounds the group): fewer host-device round trips
    _RESOLVE_EVERY = 4

    def __init__(self, ksize: int, target_codes: int,
                 out_capacity: int | None = None,
                 n_devices: int | None = None):
        import jax

        self.k = ksize
        self.ndev = n_devices or jax.local_device_count()
        nlo = min(ksize, 16)
        self.shift = np.uint64(2 * nlo)
        # worst-case flat k-mers per dispatched batch (incl. row padding)
        n_flat = target_codes + 8 * 8192
        growth = -(-n_flat // self.ndev) * (2 if self.ndev > 1 else 1)
        env_cap = os.environ.get("KMERTOOLS_ACC_CAP")
        if out_capacity is None and env_cap:
            out_capacity = int(env_cap)
        # the per-merge B side: the sorted batch (single device) or the
        # all_to_all exchange result (mesh)
        if self.ndev > 1:
            self._ex_cap = -(-2 * (n_flat // self.ndev) // self.ndev)
            m_dev = self.ndev * self._ex_cap
        else:
            m_dev = n_flat
        self._resolve_every = self._RESOLVE_EVERY
        # mesh runs resolve per batch (each carries an overflow flag);
        # single-device runs resolve lazily in groups
        self._unresolved_max = self._LAG + (
            0 if self.ndev > 1 else self._resolve_every - 1
        )
        margin = (self._unresolved_max + 2) * growth
        env_max = os.environ.get("KMERTOOLS_ACC_MAX")
        # capacity growth is opt-in (KMERTOOLS_ACC_MAX): every new
        # capacity compiles a new merge network
        _c_max = int(env_max) if env_max and out_capacity is None else 0
        if out_capacity is None:
            # merge_sorted_batch pads C + M to a power of two anyway;
            # claim the padding as usable capacity
            want = max(8 * growth, margin + growth)
            self.C_dev = _pow2_at_least(want + m_dev) - m_dev
        else:
            self.C_dev = max(
                -(-out_capacity // self.ndev),
                margin + 256,
            )
        self.spill_mark = self.C_dev - margin
        assert self.spill_mark > 0
        # GROW the device state instead of spilling while capacity is
        # below the growth cap: a mid-run spill writes the reference
        # TSV to disk and re-reads it in the merge phase, while a growth
        # step is one on-device concat plus a merge-program compile at
        # the new size. Explicit capacities (out_capacity /
        # KMERTOOLS_ACC_CAP) disable growth.
        self._growth = growth
        self._m_dev = m_dev
        self.C_max = _c_max
        self.used_mesh = self.ndev > 1
        if self.used_mesh:
            from kmertools_jax.parallel.mesh import make_mesh
            from kmertools_jax.parallel.ops import sharded_accum_count

            self.mesh = make_mesh(self.ndev)
            # one program per upload wire format, built on first use
            # (codes travel 2-bit packed; see io/batch.py:pack_planes)
            self._steps: dict = {}
            self._mk_step = lambda mode: sharded_accum_count(
                self.mesh, ksize, self.C_dev, self._ex_cap, mode
            )
        self._state = None
        self._pending: list = []  # (codes_np, n_runs_dev, ovf_dev | None)
        self._last_n = 0
        self.last_wire = None  # drain wire choice (observability/tests)

    # -- state plumbing -------------------------------------------------
    def _fresh_state(self):
        import jax

        sent = jnp.uint32(0xFFFFFFFF)
        if not self.used_mesh:
            mk = jax.jit(
                lambda: (
                    jnp.full((self.C_dev,), sent, jnp.uint32),
                    jnp.full((self.C_dev,), sent, jnp.uint32),
                    jnp.zeros((self.C_dev,), jnp.uint32),
                )
            )
            return mk()
        from jax.sharding import NamedSharding, PartitionSpec as P

        from kmertools_jax.parallel.mesh import DATA_AXIS

        sh = NamedSharding(self.mesh, P(DATA_AXIS, None))
        mk = jax.jit(
            lambda: (
                jnp.full((self.ndev, self.C_dev), sent, jnp.uint32),
                jnp.full((self.ndev, self.C_dev), sent, jnp.uint32),
                jnp.zeros((self.ndev, self.C_dev), jnp.uint32),
            ),
            out_shardings=(sh, sh, sh),
        )
        return mk()

    def _dispatch(self, planes, lengths_np: np.ndarray | None = None):
        if self._state is None:
            self._state = self._fresh_state()
        ah, al, ac = self._state
        packed, vb, n_ambig = planes
        if not self.used_mesh:
            if n_ambig == 0:
                ah, al, ac, n = cops.accum_merge_clean(
                    ah, al, ac, jnp.asarray(packed),
                    jnp.asarray(lengths_np), self.k,
                )
            else:
                ah, al, ac, n = cops.accum_merge_planes(
                    ah, al, ac, jnp.asarray(packed), jnp.asarray(vb), self.k
                )
            self._state = (ah, al, ac)
            return n, None
        from kmertools_jax.parallel.mesh import pad_rows_to_devices, shard_batch

        if n_ambig == 0:
            mode = "clean"
            aux_np = pad_rows_to_devices(
                np.asarray(lengths_np, np.int32), self.ndev, 0
            )
        else:
            mode = "planes"
            aux_np = pad_rows_to_devices(vb, self.ndev, 0)
        packed = pad_rows_to_devices(packed, self.ndev, 0)
        step = self._steps.get(mode)
        if step is None:
            step = self._steps[mode] = self._mk_step(mode)
        ah, al, ac, n, ovf = step(
            ah, al, ac,
            shard_batch(self.mesh, packed),
            shard_batch(self.mesh, aux_np),
        )
        self._state = (ah, al, ac)
        return n, ovf

    def _resolve(self, entry) -> int:
        """Block on one pending dispatch; handle overflow retries.
        Returns the post-merge unique count (max over devices)."""
        planes, lengths_np, n_dev, ovf_dev = entry
        if ovf_dev is not None and bool(np.asarray(ovf_dev).any()):
            self._retry_halves(planes, lengths_np, depth=0)
            n_dev = self._last_n_dev  # set by _retry_halves
        n = int(np.asarray(n_dev).max())
        if n > self.C_dev:
            raise RuntimeError(
                f"accumulator overflow: {n} runs > capacity {self.C_dev}; "
                "spill policy failed"
            )
        self._last_n = n
        return n

    def _retry_halves(self, planes, lengths_np: np.ndarray | None,
                      depth: int) -> None:
        """Re-dispatch a rolled-back batch in row halves (sync)."""
        if depth > 6:
            raise RuntimeError("partition bucket overflow persisted at row level")
        packed, vb, n_ambig = planes
        mid = max(1, packed.shape[0] // 2)
        for sl in (slice(None, mid), slice(mid, None)):
            if packed[sl].shape[0] == 0:
                continue
            half = (packed[sl], vb[sl], n_ambig)
            hlen = lengths_np[sl] if lengths_np is not None else None
            n_dev, ovf_dev = self._dispatch(half, hlen)
            if ovf_dev is not None and bool(np.asarray(ovf_dev).any()):
                self._retry_halves(half, hlen, depth + 1)
            else:
                self._last_n_dev = np.asarray(n_dev)

    # -- public API -----------------------------------------------------
    def add(self, codes_np: np.ndarray | None = None,
            lengths_np: np.ndarray | None = None,
            planes=None) -> int | None:
        """Dispatch one batch (async). Returns a resolved unique count
        lagging the latest dispatch, or None. Callers pass either raw
        ``codes_np`` (packed here) or prebuilt ``planes`` (the
        batcher's wire format — no byte-per-base array exists).

        Mesh runs resolve one batch per add (each carries an overflow
        flag that may trigger a rollback retry). Single-device runs
        resolve the oldest _RESOLVE_EVERY batches with ONE n-fetch of
        the newest of them — n is monotone nondecreasing across merges,
        so it bounds the whole group, and the capacity margin already
        covers `_unresolved_max` outstanding batches."""
        if planes is None:
            planes = iob.pack_planes(codes_np, lengths_np)
        entry = (planes, lengths_np, *self._dispatch(planes, lengths_np))
        self._pending.append(entry)
        if len(self._pending) <= self._unresolved_max:
            return None
        if self.used_mesh:
            return self._resolve(self._pending.pop(0))
        group = [
            self._pending.pop(0)
            for _ in range(min(self._resolve_every, len(self._pending)))
        ]
        return self._resolve(group[-1])

    def sync(self) -> int:
        """Resolve every outstanding dispatch and return the current
        unique count. Single-device paths pay ONE n-fetch (of the
        newest dispatch — its n bounds the chain, and fetching it
        blocks every queued merge); mesh paths resolve each entry (the
        per-batch overflow flags may trigger rollback retries)."""
        while self._pending:
            entry = self._pending.pop(0)
            if self.used_mesh or not self._pending:
                self._resolve(entry)
        return self._last_n

    def needs_drain(self, n_unique: int | None) -> bool:
        if n_unique is None or n_unique <= self.spill_mark:
            return False
        if not self.used_mesh and self._state is not None:
            # keep doubling while growth is still allowed: one growth
            # step may leave n_unique above the recomputed spill mark,
            # and a disk TSV spill costs far more than another pad
            # program (ADVICE r4)
            while n_unique > self.spill_mark and self.C_dev < self.C_max:
                before = self.C_dev
                self._grow()
                if self.C_dev == before:
                    break
            return n_unique > self.spill_mark
        return True

    def _grow(self) -> None:
        """Double the device capacity in place. Pending merges chain
        through `_state` as async device ops, so the pad program simply
        extends the chain — no synchronisation needed; the spill margin
        invariant (capacity minus unresolved worst-case growth) carries
        over to the new mark."""
        c2 = min(
            _pow2_at_least(2 * (self.C_dev + self._m_dev)) - self._m_dev,
            self.C_max,
        )
        if c2 <= self.C_dev:
            return
        self._state = _grow_fn(self.C_dev, c2)(*self._state)
        self.C_dev = c2
        self.spill_mark = c2 - (self._unresolved_max + 2) * self._growth

    def drain(self):
        """Fetch (keys u64, counts u64) sorted ascending; reset state.

        Transfer is a power-of-two bucketed prefix of the accumulator
        (few distinct shapes -> few compiles), with a compact wire
        format proportional to unique k-mers:

          * k <= 16: the hi plane is identically zero — not fetched;
          * 16 < k <= 23: the hi plane is monotone over the sorted
            prefix, so only its 4^(k-16)+1 value boundaries travel
            (searchsorted on device) and the plane rebuilds on host;
          * the lo plane ships as 24-bit intra-hi-run DELTAS when the
            accumulator's max intra-run gap fits (one stats fetch
            proves it; run-boundary absolutes ride the hib fetch) —
            3 bytes per unique instead of 4;
          * counts travel as u16/u8 or BIT-PACKED 4/2 bits per unique
            when the max count fits (all-distinct corpora are almost
            all count 1).

        Net: ~3.3 bytes per unique for the flagship k=21 all-distinct
        case, down from 6 in round 4 and 10 in round 3."""
        self.sync()
        if self._state is None:
            return np.empty(0, np.uint64), np.empty(0, np.uint64)
        ah, al, ac = self._state
        if not self.used_mesh:
            n_per_dev = np.array([self._last_n])
        else:
            # per-device live counts from the final merge
            n_per_dev = np.full(self.ndev, self._last_n)
        small_hi = self.k <= 23
        if not self.used_mesh:
            # exact-prefix fetch in a few pow2 pieces: transfer is
            # ~n entries (not pow2(n), up to 2x) and each piece size is
            # one tiny cached dynamic_slice program
            n_need = int(n_per_dev.max())
            no_hi = self.k <= 16
            bounded_hi = 16 < self.k <= 23
            stats = np.asarray(_wire_stats_fn()(ah, al, ac))
            max_ct = int(stats[0])
            n_big = int(stats[1])
            ct_narrow = (
                2 if max_ct < 4 else
                4 if max_ct < 16 else
                8 if max_ct < (1 << 8) else
                16 if max_ct < (1 << 16) else 0
            )
            hib = bl = None
            if bounded_hi:
                hib, bl = _hi_bounds_fn(1 << (2 * (self.k - 16)))(ah, al)
            lo24 = bounded_hi and n_big <= _LO24_EXC_CAP
            exc = (
                _lo_exc_fn(_LO24_EXC_CAP)(ah, al)
                if lo24 and n_big else None
            )
            self.last_wire = {
                "lo24": lo24, "ct_bits": ct_narrow or 32, "n_exc": n_big,
            }
            ph, plo, pct = [], [], []
            for off, size in _prefix_pieces(n_need, self.C_dev):
                o = np.int32(off)
                if not (no_hi or bounded_hi):
                    ph.append(_slice_fn(size, 16 if small_hi else 0)(ah, o))
                plo.append(
                    _lo24_fn(size, off == 0)(al, o) if lo24
                    else _slice_fn(size, 0)(al, o)
                )
                pct.append(_slice_fn(size, ct_narrow)(ac, o))
            # start every device->host copy before blocking on any:
            # piece fetches overlap instead of paying one round trip
            # each in sequence
            pends = [*ph, *plo, *pct]
            pends += [x for x in (hib, bl) if x is not None]
            if exc is not None:
                pends += list(exc)
            for r in pends:
                cast = getattr(r, "copy_to_host_async", None)
                if cast is not None:
                    try:
                        cast()
                    except Exception:
                        pass
            if lo24:
                if plo:
                    d = np.concatenate(
                        [np.asarray(r) for r in plo], axis=1
                    ).astype(np.int64)
                    delta = d[0] | (d[1] << 8) | (d[2] << 16)
                else:
                    delta = np.empty(0, np.int64)
            else:
                lo = (
                    np.concatenate([np.asarray(r) for r in plo])
                    if plo else np.empty(0, np.uint32)
                )
            if ct_narrow in (2, 4) and pct:
                ct = np.concatenate(
                    [_unpack_bits(np.asarray(r), ct_narrow) for r in pct]
                )
            else:
                ct = (
                    np.concatenate([np.asarray(r) for r in pct])
                    if pct else np.empty(0, np.uint32)
                )
            m = len(ct)
            if no_hi:
                hi = np.zeros(m, np.uint16)
            elif bounded_hi:
                # rebuild the hi plane from its value boundaries
                b = np.minimum(np.asarray(hib).astype(np.int64), m)
                hi = np.repeat(
                    np.arange(len(b) - 1, dtype=np.uint16), np.diff(b)
                )
                hi = np.concatenate(
                    [hi, np.full(m - len(hi), 0xFFFF, np.uint16)]
                )
            else:
                ph = [np.asarray(r) for r in ph]
                hi = np.concatenate(ph) if ph else np.empty(0, np.uint32)
            if lo24:
                # reconstruct lo: zero the boundary deltas, prefix-sum,
                # then re-anchor each hi-run segment at its absolute lo
                # (cumsum exact in int64; intra-run deltas are < 2^24
                # by the stats proof). Segment starts are the distinct
                # boundary positions; start[0] == 0 always (searchsorted
                # of hi value 0 over an unsigned plane).
                delta = delta[:m]
                if exc is not None:
                    # giant-gap exceptions: restore their full u32
                    # deltas BEFORE boundary zeroing (a boundary can
                    # also appear here with its wrapped delta — the
                    # zeroing below wins, which is correct)
                    epos = np.asarray(exc[0]).astype(np.int64)
                    edv = np.asarray(exc[1]).astype(np.int64)
                    evalid = epos < m
                    delta[epos[evalid]] = edv[evalid]
                bpos = np.minimum(np.asarray(hib).astype(np.int64), m)
                babs = np.asarray(bl).astype(np.int64)
                starts, first = np.unique(bpos, return_index=True)
                keep = starts < m
                starts, first = starts[keep], first[keep]
                delta[starts] = 0
                csum = np.cumsum(delta)
                seg_anchor = babs[first] - csum[starts]
                ends = np.append(starts[1:], m)
                anchor = np.repeat(seg_anchor, ends - starts)
                lo = ((csum + anchor) & 0xFFFFFFFF).astype(np.uint32)
            hi, lo, ct = hi[None], lo[None], ct[None]
        else:
            L = min(int(_pow2_at_least(int(n_per_dev.max()))), self.C_dev)
            hi = np.asarray(
                ah[:, :L].astype(jnp.uint16) if small_hi else ah[:, :L]
            )
            lo = np.asarray(al[:, :L])
            ct = np.asarray(ac[:, :L])
        keys_parts = []
        cnts_parts = []
        for d in range(hi.shape[0]):
            cd = ct[d]
            live = cd > 0
            n_d = int(live.sum())
            if n_d == 0:
                continue
            # live entries are the compacted prefix
            kd = (hi[d][:n_d].astype(np.uint64) << self.shift) | lo[d][
                :n_d
            ].astype(np.uint64)
            keys_parts.append(kd)
            cnts_parts.append(cd[:n_d].astype(np.uint64))
        self._state = None
        self._last_n = 0
        if not keys_parts:
            return np.empty(0, np.uint64), np.empty(0, np.uint64)
        keys = np.concatenate(keys_parts)
        cnts = np.concatenate(cnts_parts)
        if len(keys_parts) > 1:
            order = np.argsort(keys, kind="stable")
            keys, cnts = keys[order], cnts[order]
        return keys, cnts


class NativeCounter:
    """Host-CPU counting engine (kthost.cpp:kt_ctr_*): the reference's
    sharded-map count hot loop (counter/src/lib.rs:104-143) as a
    multithreaded native sink beside the device accumulator. ctypes
    releases the GIL, so its worker thread crunches on host cores while
    the producer parses and the accelerator runs its own batches.
    Consumes the batcher's packed planes directly; drains one sorted
    (keys, counts) pair per partition (``kmer % n_parts``) and resets.
    """

    def __init__(self, ksize: int, n_parts: int, threads: int):
        from kmertools_jax import native

        self._so = native.lib()
        self._native = native
        h = self._so.kt_ctr_new(ksize, n_parts, threads)
        if not h:
            raise RuntimeError("kt_ctr_new failed")
        self._h = ctypes.c_void_p(h)
        self.n_parts = n_parts
        self.uniques = 0

    def add(self, planes) -> int:
        """Count one batch; returns total unique k-mers held."""
        packed, vb, _ = planes
        packed = np.ascontiguousarray(packed)
        vb = np.ascontiguousarray(vb)
        n = self._so.kt_ctr_add(
            self._h,
            packed.ctypes.data_as(self._native.c_u8_p),
            vb.ctypes.data_as(self._native.c_u8_p),
            packed.shape[0],
            packed.shape[1] * 4,
        )
        if n < 0:
            raise RuntimeError("kt_ctr_add failed")
        self.uniques = n
        return n

    def drain_parts(self, threads: int = 0) -> list:
        """[(keys u64 sorted asc, counts u64)] per partition; resets."""
        out = []
        self._so.kt_ctr_freeze(self._h, threads)  # parallel per-part sort
        for p in range(self.n_parts):
            n = self._so.kt_ctr_part_len(self._h, p)
            keys = np.empty(max(n, 0), np.uint64)
            cnts = np.empty(max(n, 0), np.uint64)
            if n > 0:
                got = self._so.kt_ctr_drain_part(
                    self._h,
                    p,
                    keys.ctypes.data_as(self._native.c_u64_p),
                    cnts.ctypes.data_as(self._native.c_u64_p),
                )
                if got != n:
                    raise RuntimeError("kt_ctr_drain_part mismatch")
            out.append((keys, cnts))
        self.uniques = 0
        return out

    def close(self) -> None:
        if self._h:
            self._so.kt_ctr_free(self._h)
            self._h = None

    def __del__(self):  # best-effort; close() is the real path
        try:
            self.close()
        except Exception:
            pass


# Routing record of the most recent count loop: one dict per engine
# {"key": "device" | "native", "batches", "weight"} (observability for
# tests and the chip smoke, like common.LAST_RUN_STATS).
LAST_SINK_STATS: list[dict] = []


class _CtrSink:
    """One counting engine in the multi-sink count loop: a bounded FIFO
    and a worker thread feeding batches to ``add_fn``, spilling at the
    engine's own gate. Stateful engines can't share batches the way the
    stateless workloads' sinks do (workloads/common.py:_HeteroSink), but
    the routing contract is the same: EWMA bases/s, route each batch to
    the sink with the lowest estimated finish time. Spill files unify
    the engines downstream — merge() aggregates chunks no matter which
    engine produced them."""

    def __init__(self, idx: int, key: str, add_fn, should_spill, do_spill,
                 depth: int = 3):
        self.idx = idx
        self.key = key
        self.batches = 0  # batches counted (LAST_SINK_STATS)
        self.weight = 0
        self._add = add_fn
        self._should_spill = should_spill
        self._spill = do_spill
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.lock = threading.Lock()
        self.inflight = 0
        self.rate = 0.0  # EWMA bases/s; 0 = no sample yet
        self._last_done: float | None = None
        self.err: list[BaseException] = []
        self._chunk_bases = 0
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def eta(self, w: int) -> float:
        with self.lock:
            if self.rate > 0:
                return (self.inflight + w) / self.rate
            return 0.0 if self.inflight == 0 else float("inf")

    def put(self, b, w: int) -> None:
        with self.lock:
            self.inflight += w
        self.q.put((b, w, time.perf_counter()))

    def _worker(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            b, w, t_disp = item
            if self.err:
                with self.lock:
                    self.inflight -= w
                continue  # drain so the producer's bounded put never blocks
            try:
                n = self._add(b)
                now = time.perf_counter()
                t0 = t_disp if self._last_done is None else max(
                    self._last_done, t_disp
                )
                self._last_done = now
                sample = w / max(now - t0, 1e-6)
                with self.lock:
                    self.rate = (
                        sample if self.rate == 0
                        else 0.5 * self.rate + 0.5 * sample
                    )
                    self.inflight -= w
                self.batches += 1
                self.weight += w
                self._chunk_bases += w
                if self._should_spill(n, self._chunk_bases):
                    self._spill()
                    self._chunk_bases = 0
            except BaseException as e:  # re-raised by finish()
                self.err.append(e)
                with self.lock:
                    self.inflight -= w

    def finish(self) -> None:
        self.q.put(None)
        self.thread.join()
        if self.err:
            raise self.err[0]


class CountComputer:
    """counter/src/lib.rs:22-249 equivalent."""

    def __init__(self, in_path: str, out_dir: str, ksize: int):
        self.in_path = in_path
        self.out_dir = out_dir
        self.ksize = ksize
        self.threads = os.cpu_count() or 1
        self.chunks = 0
        self.n_parts = 0
        self.memory_ceil_gb = 6.0
        self.seq_count = 0
        self.total_bases = 0
        self.debug = False
        self.acgt = False
        self.used_mesh = False
        self.n_devices = None  # None = all visible devices
        self.mh_ctx = None  # parallel.multihost.HostContext
        self.chunk_ids: list[int] = []
        self._cid_lock = threading.Lock()
        # None = resolve lazily (_resolved_target)
        self.target_codes: int | None = None

    def set_threads(self, threads: int) -> None:
        if threads > 0:
            self.threads = threads

    def set_max_memory(self, memory_ceil_gb: float) -> None:
        self.memory_ceil_gb = memory_ceil_gb

    def set_acgt_output(self, acgt: bool) -> None:
        self.acgt = acgt

    def set_multihost(self, ctx) -> None:
        """Multi-host mode: this host counts its input byte-range shard
        into the SHARED out dir (chunk ids interleaved by host rank so
        spill names never collide), then host 0 merges every host's
        chunks. n_parts stays derived from whole-file stats, so all
        hosts agree on the partition space."""
        self.mh_ctx = ctx

    def init(self) -> None:
        """Pre-pass: seq stats -> partition count (lib.rs:236-249)."""
        if self.in_path == "-":
            # counting reads the input twice (stats pre-pass + count);
            # the reference refuses stdin with this exact panic
            # (ktio/src/seq.rs:137) — silently consuming stdin in the
            # pre-pass would emit an empty kmers.counts instead
            raise ValueError(
                "Count cannot be performed without always having a "
                "rewindable input stream, stdin is not!"
            )
        stats = fastx.seq_stats(self.in_path)
        data_gb = stats.total_length / float(1 << 30)
        self.n_parts = max(
            1 if self.debug else self.threads,
            int(np.ceil(8.0 * data_gb / (2.0 * self.memory_ceil_gb))),
        )
        self.seq_count = stats.seq_count
        self.total_bases = stats.total_length

    def _write_manifest(self) -> None:
        name = (
            f"manifest_h{self.mh_ctx.host_id}.json" if self.mh_ctx
            else "manifest.json"
        )
        with open(os.path.join(self.out_dir, name), "w") as f:
            json.dump(
                {
                    "ksize": self.ksize,
                    "chunks": self.chunks,
                    "n_parts": self.n_parts,
                    "chunk_ids": self.chunk_ids,
                },
                f,
            )

    def load_manifest(self) -> bool:
        """Restore chunks/n_parts/chunk_ids from out_dir/manifest.json —
        the durable resume point the count phase writes beside its
        spills (SURVEY §5 checkpoint/resume; the reference's merge-only
        flow needs the caller to re-derive both, lib.rs:279-293).
        Returns False when no manifest exists."""
        path = os.path.join(self.out_dir, "manifest.json")
        try:
            with open(path) as f:
                m = json.load(f)
        except OSError:
            return False
        if m.get("ksize") != self.ksize:
            raise ValueError(
                f"manifest ksize {m.get('ksize')} != requested {self.ksize}"
            )
        self.chunks = int(m["chunks"])
        self.n_parts = int(m["n_parts"])
        self.chunk_ids = list(m.get("chunk_ids", range(self.chunks)))
        return True

    def _alloc_chunk_id(self) -> int:
        """Next spill chunk id (thread-safe: engine sinks spill from
        their own worker threads). Ids interleave by host rank in
        multi-host runs so every host spills into the same dir without
        collisions."""
        with self._cid_lock:
            if self.mh_ctx:
                cid = self.mh_ctx.num_hosts * self.chunks + self.mh_ctx.host_id
            else:
                cid = self.chunks
            self.chunk_ids.append(cid)
            self.chunks += 1
            return cid

    def _spill_parts(self, parts: list) -> bool:
        """Write one chunk of per-partition (keys, counts) spill files.
        Returns False (and allocates no chunk id) when all empty."""
        if not any(len(k) for k, _ in parts):
            return False
        cid = self._alloc_chunk_id()
        for p, (k, c) in enumerate(parts):
            self._write_spill(p, cid, k, c)
        return True

    def _spill_from(self, acc: "DeviceAccumulator") -> bool:
        """Drain the device accumulator into per-partition spill files
        (one chunk). Returns False when the accumulator was empty."""
        kmers, counts = acc.drain()
        if not len(kmers):
            return False
        parts = (kmers % np.uint64(self.n_parts)).astype(np.int64)
        order = np.argsort(parts, kind="stable")
        kmers, counts, parts = kmers[order], counts[order], parts[order]
        bounds = np.searchsorted(parts, np.arange(self.n_parts + 1))
        return self._spill_parts(
            [
                (kmers[bounds[p]:bounds[p + 1]], counts[bounds[p]:bounds[p + 1]])
                for p in range(self.n_parts)
            ]
        )

    def _effective_target(self, device: bool = True) -> int:
        """Batch code budget clamped to the corpus size (pow2-bucketed
        so the compile-shape count stays small): a 2-read file must not
        dispatch multi-million-element padded sorts.

        ``device=False`` (native engine counts alone, CPU-only backend):
        the small device-path default exists to bound the DEVICE
        accumulator's per-batch merge program (compile-time cliff on
        the XLA-network path, CLAUDE.md) — the native engine has no
        such constraint and 256k batches halve its throughput on
        per-batch overhead (thread spawns, bucket clears; measured 17.9
        vs 32.5 Mcodes/s at 2M). Applied only while target_codes is the
        construction default: an explicit target (tests forcing many
        tiny chunks) stays authoritative."""
        need = 1 << max(16, (2 * max(1, self.total_bases) - 1).bit_length())
        tgt = self._resolved_target()
        if (
            not device
            and not _CTR_TARGET_EXPLICIT
            and self.target_codes is None
        ):
            tgt = max(tgt, 1 << 21)
        return min(tgt, need)

    def _resolved_target(self) -> int:
        if self.target_codes is not None:
            return self.target_codes
        return min(iob.DEFAULT_TARGET_CODES, _default_ctr_target())

    def _native_engine(self) -> "NativeCounter | None":
        """The host-CPU engine when it should join the count: native
        runtime present, heterogeneous execution not disabled."""
        from kmertools_jax import native

        if os.environ.get("KMERTOOLS_NO_HETERO") == "1":
            return None
        if native.lib() is None or not (1 <= self.ksize <= 31):
            return None
        return NativeCounter(self.ksize, self.n_parts, self.threads)

    def _make_engines(self):
        """(device accumulator | None, native engine | None).

        A non-CPU backend always gets the device path (the mesh-sharded
        flagship), with the native engine as a second sink when present.
        On a CPU-only backend the XLA programs would share silicon with
        — and lose badly to — the native engine, so the engine runs
        alone when present (the XLA path still covers KMERTOOLS_NO_*
        fallback modes)."""
        import jax

        from kmertools_jax.workloads.common import (
            _COALESCE_RTT_S,
            probe_device_rtt,
        )

        eng = self._native_engine()
        devs = jax.local_devices() if self.n_devices is None else (
            jax.local_devices()[: self.n_devices]
        )
        backend_cpu = bool(devs) and devs[0].platform == "cpu"
        # a device whose probed round trip exceeds _COALESCE_RTT_S pays
        # that latency on every resolve and drain, so beside the native
        # engine it yields the count to it (the oligo scheduler's
        # rule); KMERTOOLS_NO_HETERO=1 still pins the device engine
        # alone (eng is None then)
        remote_dev = (
            bool(devs)
            and devs[0].platform != "cpu"
            and probe_device_rtt(devs[0]) > _COALESCE_RTT_S
        )
        acc = None
        if eng is None or not (backend_cpu or remote_dev):
            acc = DeviceAccumulator(
                self.ksize, self._effective_target(),
                n_devices=self.n_devices,
            )
        return acc, eng

    def _count_loop(self, acc: "DeviceAccumulator | None",
                    eng: "NativeCounter | None") -> None:
        """Stream batches through the engine sinks. Each sink spills
        itself at its own high-water mark or at the memory gate
        (counter/src/lib.rs:114-116 analog); batches route to the sink
        with the lowest EWMA-estimated finish time."""
        pbar = Progress(self.seq_count, "counting")
        gate = 1_000_000_000.0 * self.memory_ceil_gb / 8.0
        # ~16B per unique in the engine's maps at max load; /32 leaves
        # headroom for growth doubling + transient bucket vectors
        umark = max(1 << 16, int(self.memory_ceil_gb * 1e9 / 32.0))
        sinks = []
        if acc is not None:
            sinks.append(
                _CtrSink(
                    len(sinks),
                    "device",
                    lambda b: acc.add(lengths_np=b.lengths, planes=b.planes()),
                    lambda n, cb: acc.needs_drain(n) or cb > gate,
                    lambda: self._spill_from(acc),
                )
            )
        if eng is not None:
            sinks.append(
                _CtrSink(
                    len(sinks),
                    "native",
                    lambda b: eng.add(b.planes()),
                    lambda n, cb: n > umark or cb > gate,
                    lambda: self._spill_parts(eng.drain_parts()),
                )
            )
        try:
            for b in iob.stream_path(
                self.in_path, overlap=self.ksize - 1,
                target_codes=self._effective_target(device=acc is not None),
                shard=self.mh_ctx.shard_for(self.in_path)
                if self.mh_ctx else None,
            ):
                if any(s.err for s in sinks):
                    break
                w = max(1, int(b.lengths.sum()))
                sink = min(sinks, key=lambda s: (s.eta(w), s.idx))
                sink.put(b, w)
                pbar.update(int((b.read_idx >= 0).sum()))
        finally:
            errs = []
            for s in sinks:
                try:
                    s.finish()
                except BaseException as e:
                    errs.append(e)
            LAST_SINK_STATS[:] = [
                {"key": s.key, "batches": s.batches, "weight": s.weight}
                for s in sinks
            ]
            if errs:
                raise errs[0]
        pbar.finish()

    def _final_spills(self, acc, eng) -> None:
        if acc is not None:
            self._spill_from(acc)
        if eng is not None:
            self._spill_parts(eng.drain_parts())
            eng.close()

    def count(self) -> None:
        """Count phase: engine-accumulated chunks -> durable partition
        spills (the resume point; merge() completes the pipeline)."""
        self.init()
        self.chunks = 0
        acc, eng = self._make_engines()
        self.used_mesh = acc.used_mesh if acc is not None else False
        self._count_loop(acc, eng)
        self._final_spills(acc, eng)
        self._write_manifest()

    def _spill_path(self, p: int, c: int) -> str:
        return os.path.join(self.out_dir, f"temp_kmers.part_{p}_chunk_{c}")

    def _write_spill(self, p: int, c: int, kmers, counts) -> None:
        """Spills keep the reference's TSV format byte-for-byte
        (temp_kmers.part_p_chunk_c, counter/src/lib.rs:151-167): the
        spill files are the durable resume point and a golden file
        (expected_counts.part_0_chunk_0) pins their format."""
        _write_tsv(self._spill_path(p, c), kmers, counts)

    def _read_spill(self, p: int, c: int, delete: bool):
        path = self._spill_path(p, c)
        k, v = _read_tsv(path)
        if delete:
            delete_file_if_exists(path)
        return k, v

    def count_and_merge(self, delete: bool = True) -> None:
        """count() + merge() with the spill round-trip elided when the
        whole run fits in one device-accumulator chunk (the common
        case below the memory gate). End state matches the reference
        CLI's count->merge(true): the out dir holds kmers.counts;
        multi-chunk runs take the durable spill/merge path (the resume
        point stays intact)."""
        from kmertools_jax import ensure_hugepage_tuning

        ensure_hugepage_tuning()
        if self.mh_ctx:
            self._count_and_merge_multihost(delete)
            return
        self.init()
        self.chunks = 0
        acc, eng = self._make_engines()
        self.used_mesh = acc.used_mesh if acc is not None else False
        self._count_loop(acc, eng)
        if self.chunks:
            # spills happened: finish the durable path
            self._final_spills(acc, eng)
            self._write_manifest()
            self.merge(delete)
            return
        # per-partition sources; a partition's key space is disjoint
        # from every other's, so cross-key aggregation is only ever
        # needed WITHIN a partition when both engines counted (the
        # accelerator-backend config) — never a global 13M-key sort
        np_parts = max(1, self.n_parts)
        part_srcs: list[list] = [[] for _ in range(np_parts)]
        if acc is not None:
            k, c = acc.drain()
            if len(k):
                # partition split by boolean mask, NOT argsort: masking
                # preserves the drain's ascending key order within each
                # partition, and np_parts passes over the arrays cost a
                # fraction of a 15M-key stable sort (~1.5 s saved on
                # the flagship on-chip run)
                pidx = k % np.uint64(np_parts)
                for p in range(np_parts):
                    m = pidx == p
                    if m.any():
                        part_srcs[p].append((k[m], c[m]))
        if eng is not None:
            for p, (k, c) in enumerate(eng.drain_parts(self.threads)):
                if len(k):
                    part_srcs[p].append((k, c))
            eng.close()
        out_path = os.path.join(self.out_dir, "kmers.counts")
        table_k, table_c = [], []
        with open(out_path, "wb") as out:
            for srcs in part_srcs:  # partition-major, merge()'s order
                if not srcs:
                    continue
                if len(srcs) == 1:
                    k, c = srcs[0]
                else:
                    k, c = _aggregate(
                        np.concatenate([s[0] for s in srcs]),
                        np.concatenate([s[1] for s in srcs]),
                    )
                _write_tsv_stream(
                    out, k, c, acgt_k=self.ksize if self.acgt else None
                )
                table_k.append(k)
                table_c.append(c)
        # in-memory handoff for composing workloads (coverage): saves
        # re-parsing the TSV we just wrote. Kept as PER-PARTITION
        # (keys, counts) pairs, each sorted ascending — the consumer
        # k-way merges at memory speed instead of re-sorting 15M keys
        # (partitions interleave by `kmer % n_parts`, so a global sort
        # from scratch costs ~10x the merge).
        self.last_table_parts = list(zip(table_k, table_c))
        self._write_manifest()

    def _count_and_merge_multihost(self, delete: bool) -> None:
        """Every host spills its shard's chunks into the shared out dir;
        after a rendezvous host 0 merges the union of chunks. The
        reference's thread-pool count phase (counter/src/lib.rs:104-143)
        scaled to hosts: reads shard across hosts, the k-mer partition
        space stays global."""
        from kmertools_jax.parallel import multihost

        ctx = self.mh_ctx
        self.count()  # spills + per-host manifest
        multihost.rendezvous(ctx, self.out_dir, "ctr_spills")
        if ctx.is_primary:
            ids: list[int] = []
            for h in range(ctx.num_hosts):
                mpath = os.path.join(self.out_dir, f"manifest_h{h}.json")
                with open(mpath) as f:
                    ids.extend(json.load(f)["chunk_ids"])
                os.unlink(mpath)
            self.chunk_ids = sorted(ids)
            self.chunks = len(ids)
            with open(os.path.join(self.out_dir, "manifest.json"), "w") as f:
                json.dump(
                    {
                        "ksize": self.ksize,
                        "chunks": self.chunks,
                        "n_parts": self.n_parts,
                        "chunk_ids": self.chunk_ids,
                    },
                    f,
                )
            self.merge(delete)
            multihost.gate_open(ctx, self.out_dir, "ctr_done")
        else:
            # table consumers (cov) need the merged kmers.counts on
            # every host before proceeding
            multihost.gate_wait(ctx, self.out_dir, "ctr_done")
        multihost.release(ctx, "ctr_merge")

    def merge(self, delete: bool) -> None:
        """Re-aggregate spills per partition into kmers.counts.

        Standalone resume: with neither chunks nor chunk_ids set (a
        fresh CountComputer pointed at a spilled-out dir), the manifest
        restores them.

        Parallel like the reference (counter/src/lib.rs:194-218): chunk
        spills within a partition read+parse concurrently (the TSV
        parser releases the GIL), and the next partition's reads
        prefetch while the current one aggregates and writes — so disk,
        parse, sort and format overlap. Output stays partition-ordered
        and deterministic."""
        import concurrent.futures as cf

        if not self.chunks and not self.chunk_ids:
            if not self.load_manifest():
                # refusing beats silently truncating kmers.counts to an
                # empty file when pointed at the wrong / already-merged
                # dir
                raise RuntimeError(
                    f"nothing to merge: no chunks set and no manifest.json "
                    f"in {self.out_dir}"
                )
        chunk_ids = self.chunk_ids or list(range(self.chunks))
        out_path = os.path.join(self.out_dir, "kmers.counts")
        pbar = Progress(self.n_parts * len(chunk_ids), "merging")
        nthreads = max(1, self.threads)
        # separate pools: chunk reads fan out on io_pool; pf_pool holds
        # at most one whole-partition prefetch, so waiting on io_pool
        # futures can never self-deadlock and memory stays bounded by
        # two partitions in flight
        with cf.ThreadPoolExecutor(nthreads) as io_pool, \
                cf.ThreadPoolExecutor(1) as pf_pool, \
                open(out_path, "wb") as out:

            def read_part(p: int) -> list:
                futs = [
                    io_pool.submit(self._read_spill, p, c, delete)
                    for c in chunk_ids
                ]
                return [f.result() for f in futs]

            nxt = pf_pool.submit(read_part, 0) if self.n_parts else None
            for p in range(self.n_parts):
                cur = nxt.result()
                nxt = (
                    pf_pool.submit(read_part, p + 1)
                    if p + 1 < self.n_parts else None
                )
                pbar.update(len(chunk_ids))
                if not cur:
                    continue
                kmers, counts = _merge_chunk_tables(cur)
                if not len(kmers):
                    continue
                _write_tsv_stream(
                    out, kmers, counts,
                    acgt_k=self.ksize if self.acgt else None,
                )
        pbar.finish()
