"""Multi-chip collective kernels (shard_map over a 1-D mesh).

Device equivalents of the reference's concurrency machinery
(SURVEY.md section 2 parallelism table):

  * work-stealing read loop  -> data-parallel row shards (shard_map)
  * scc::HashMap shard upsert -> psum of dense histograms (small k)
  * `min_mer % n_parts` k-mer-space sharding (counter/src/lib.rs:127)
     -> all_to_all exchange of hash-partitioned k-mer buckets, then a
        local sort/RLE per partition owner (large k)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from kmertools_jax.ops import encode, histogram
from kmertools_jax.parallel.mesh import DATA_AXIS

# numpy scalar on purpose: a module-level jnp constant would initialise
# the XLA backend at import time, which breaks jax.distributed.initialize
# (it must run before any backend init — parallel/multihost.py)
import numpy as _np

_SENT = _np.uint32(0xFFFFFFFF)


def distributed_oligo_step(mesh, slot_table, k: int, nbins: int):
    """Data-parallel per-read oligo histograms: codes sharded on rows,
    outputs sharded the same way. No collectives needed — the point is
    the sharding annotation so XLA partitions the histogram."""

    def step(codes, table):
        fwd, rc, valid = encode.kmer_ids_small(codes, k)
        ids = jnp.minimum(fwd, rc)
        return histogram.per_read_histogram_gathered(ids, valid, table, nbins)

    return jax.jit(
        shard_map(
            step,
            mesh=mesh,
            in_specs=(P(DATA_AXIS, None), P()),
            out_specs=(P(DATA_AXIS, None), P(DATA_AXIS)),
        )
    )


def distributed_dense_count(mesh, k: int):
    """Global dense canonical k-mer histogram (k <= 7): per-device
    histogram of its read shard + psum over the mesh — the collective
    replacement for the reference's shared concurrent count map."""
    from kmertools_jax.utils.codec import canonical_slot_table
    import numpy as np

    nbins = int(canonical_slot_table(k).max()) + 1

    def step(codes, table):
        fwd, rc, valid = encode.kmer_ids_small(codes, k)
        ids = jnp.minimum(fwd, rc)
        counts, _ = histogram.per_read_histogram_gathered(ids, valid, table, nbins)
        local = jnp.sum(counts, axis=0)
        return lax.psum(local, DATA_AXIS)

    table = jnp.asarray(canonical_slot_table(k))
    fn = jax.jit(
        shard_map(
            step,
            mesh=mesh,
            in_specs=(P(DATA_AXIS, None), P()),
            out_specs=P(),
        )
    )
    return lambda codes: fn(codes, table)


def _bucket_by_partition(fh, fl, ndev: int, cap: int):
    """Route canonical (hi, lo) pairs into fixed-capacity per-partition
    buckets by ``lo % ndev`` (the `min_mer % n_parts` analog,
    counter/src/lib.rs:127).

    One sort + one segmented-rank scan + one scatter — O(n log n)
    vectorised work, replacing the earlier O(ndev * n) python loop of
    dynamic_slices (VERDICT r1 weak#4). Sentinel pairs (invalid or
    padding k-mers) and bucket overflow spill past the scatter bound
    and are dropped (`mode="drop"`).

    Returns (bh, bl, overflow) with bh/bl shaped (ndev, cap), sentinel
    padded; overflow is True when any partition exceeded `cap` (its
    surplus was dropped, so the caller must discard the result and
    retry with a smaller batch).
    """
    n = fh.shape[0]
    is_sent = (fh == _SENT) & (fl == _SENT)
    part = jnp.where(is_sent, jnp.uint32(ndev), fl % jnp.uint32(ndev))
    sp, sh, sl = lax.sort((part, fh, fl), num_keys=3)
    idx = jnp.arange(n, dtype=jnp.int32)
    firstp = jnp.concatenate([jnp.ones((1,), bool), sp[1:] != sp[:-1]])
    seg_start = lax.associative_scan(jnp.maximum, jnp.where(firstp, idx, 0))
    rank = idx - seg_start
    spi = sp.astype(jnp.int32)
    ok = (spi < ndev) & (rank < cap)
    dest = jnp.where(ok, spi * cap + rank, ndev * cap)  # OOB -> dropped
    overflow = jnp.any((spi < ndev) & (rank >= cap))
    init = jnp.full((ndev * cap,), _SENT, jnp.uint32)
    bh = init.at[dest].set(sh, mode="drop")
    bl = init.at[dest].set(sl, mode="drop")
    return bh.reshape(ndev, cap), bl.reshape(ndev, cap), overflow


def sharded_accum_count(mesh, k: int, C_dev: int, cap: int,
                        mode: str = "codes"):
    """Mesh-sharded exact counting with a per-device resident
    accumulator — the production large-k path.

    Each device: canonical (hi, lo) extraction over its read shard ->
    bucket by ``lo % ndev`` -> all_to_all -> merge the owned
    partition into its sorted-unique accumulator (capacity C_dev).
    This is the device composition of the reference's two core
    mechanisms: k-mer-space sharding across workers
    (counter/src/lib.rs:100,123-132) and in-memory aggregation until a
    spill gate (lib.rs:114-116).

    Overflow protocol: if ANY device's send bucket exceeds `cap`, all
    devices agree via a pmax consensus and return their accumulators
    UNCHANGED (rollback), so the host can re-dispatch the batch in
    smaller slices. n_runs then reports the pre-batch live count.

    Returns fn(ah, al, ac, codes) -> (ah', al', ac', n_runs, overflow)
    with state shaped (ndev, C_dev) sharded over the mesh, codes
    row-sharded, n_runs/overflow per-device vectors.

    ``mode`` selects the upload wire format ("codes" = raw u8,
    "planes" = 2-bit packed + valid-bit plane, "clean" = 2-bit packed +
    row lengths, ambiguity-free): packed upload moves fewer bytes, and
    unpacking fuses into the same XLA program.
    """
    ndev = mesh.devices.size
    from kmertools_jax.ops.count import merge_sorted_batch

    def step(ah, al, ac, *data):
        ah, al, ac = ah[0], al[0], ac[0]
        if mode == "planes":
            codes = encode.unpack_planes(*data)
        elif mode == "clean":
            codes = encode.unpack_packed(*data)
        else:
            (codes,) = data
        hi, lo, _ = encode.canonical_ids_pair(codes, k)
        bh, bl, ovf_local = _bucket_by_partition(
            hi.reshape(-1), lo.reshape(-1), ndev, cap
        )
        # consensus BEFORE applying: a truncated exchange poisons every
        # device's partition, so all must roll back together
        ovf = lax.pmax(ovf_local.astype(jnp.int32), DATA_AXIS) > 0
        xh = lax.all_to_all(bh, DATA_AXIS, split_axis=0, concat_axis=0)
        xl = lax.all_to_all(bl, DATA_AXIS, split_axis=0, concat_axis=0)
        # sort the received partition at exchange size, then merge into
        # the resident accumulator with the bitonic network (the only
        # lax.sort in the program is exchange-sized)
        rh, rl = lax.sort(
            (xh.reshape(-1), xl.reshape(-1)), num_keys=2
        )
        uh, ul, uc, n_runs = merge_sorted_batch(ah, al, ac, rh, rl)
        C = ah.shape[0]
        live_old = jnp.sum(ac > 0, dtype=jnp.int32)
        nah = jnp.where(ovf, ah, uh[:C])
        nal = jnp.where(ovf, al, ul[:C])
        nac = jnp.where(ovf, ac, uc[:C])
        n_out = jnp.where(ovf, live_old, n_runs)
        return nah[None], nal[None], nac[None], n_out[None], ovf[None]

    if mode == "planes":
        data_specs = (P(DATA_AXIS, None), P(DATA_AXIS, None))
    elif mode == "clean":
        data_specs = (P(DATA_AXIS, None), P(DATA_AXIS))
    else:
        data_specs = (P(DATA_AXIS, None),)
    return jax.jit(
        shard_map(
            step,
            mesh=mesh,
            in_specs=(
                P(DATA_AXIS, None),
                P(DATA_AXIS, None),
                P(DATA_AXIS, None),
            ) + data_specs,
            out_specs=(
                P(DATA_AXIS, None),
                P(DATA_AXIS, None),
                P(DATA_AXIS, None),
                P(DATA_AXIS),
                P(DATA_AXIS),
            ),
        ),
        donate_argnums=(0, 1, 2),
    )
