"""Aligned-block count-table join (ops/count.py:lookup_counts_blocks).

The coverage workload's device ceiling was the binary-search join
(~12 row probes per query, VERDICT r3 weak#5); the block join gathers
the two aligned S-blocks covering a query's prefix bucket and compares
full-width. These tests pin exact agreement with the binary-search
join (itself golden-pinned) across key skews, absent keys, sentinel
queries, and the pathological-skew fallback.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from kmertools_jax.ops import count as cops
from kmertools_jax.ops.encode import canonical_ids_pair


def _split(keys, k):
    nlo = min(k, 16)
    hi = (keys >> np.uint64(2 * nlo)).astype(np.uint32)
    lo = (keys & np.uint64((1 << (2 * nlo)) - 1)).astype(np.uint32)
    return hi, lo


@pytest.mark.parametrize("k", [4, 15, 21, 31])
def test_block_join_matches_binary_search(k):
    rng = np.random.default_rng(k)
    n = 5000
    space = 1 << (2 * k)
    # canonical-style skew: min of two uniforms biases keys low
    a = rng.integers(0, space, n * 2, dtype=np.uint64)
    keys = np.unique(np.minimum(a[:n], a[n:]))
    cnts = rng.integers(1, 1000, len(keys)).astype(np.int32)

    blk = cops.block_table(keys, cnts, k, S=64)
    assert blk is not None
    blocks3, boff2, p_bits = blk

    # queries: half present, half random (mostly absent), some sentinel
    q = np.concatenate([
        rng.choice(keys, 700),
        rng.integers(0, space, 700, dtype=np.uint64),
    ])
    qh, ql = _split(q, k)
    qh = np.concatenate([qh, np.full(48, 0xFFFFFFFF, np.uint32)])
    ql = np.concatenate([ql, np.full(48, 0xFFFFFFFF, np.uint32)])
    qh = qh.reshape(2, -1)
    ql = ql.reshape(2, -1)

    got = np.asarray(cops.lookup_counts_blocks(
        jnp.asarray(qh), jnp.asarray(ql), jnp.asarray(blocks3),
        jnp.asarray(boff2), k, p_bits, blocks3.shape[1], chunk=256,
    ))

    th, tl = _split(keys, k)
    bb = min(2 * k, 18)
    boff, steps = cops.bucket_offsets(keys, k, bb)
    want = np.asarray(cops.lookup_counts_bucketed(
        jnp.asarray(qh), jnp.asarray(ql),
        jnp.asarray(np.stack([th, tl], axis=1)),
        jnp.asarray(cnts), jnp.asarray(boff), k, bb, steps,
    ))
    assert np.array_equal(got, want)


def test_block_table_skew_fallback():
    """All keys share a prefix deeper than any reachable bucket
    resolution: the builder must refuse (the caller keeps the
    binary-search join) instead of growing the index without bound."""
    k = 31
    keys = np.arange(3000, dtype=np.uint64)  # identical top 40 bits
    cnts = np.ones(3000, np.int32)
    assert cops.block_table(keys, cnts, k, S=64, p_cap=20) is None
    # the internal 26-bit bound holds even when the caller lifts p_cap
    assert cops.block_table(keys, cnts, k, S=64, p_cap=62) is None
    # dense low-k keys resolve fine (p can reach full key resolution)
    k4 = np.arange(200, dtype=np.uint64)
    assert cops.block_table(k4, cnts[:200], 4, S=64) is not None


def test_block_join_end_to_end_device_parity(tmp_path, test_data):
    """Coverage batch program: block-join variant == binary-search
    variant on real encoded reads (the device paths the workload
    routes between)."""
    from kmertools_jax.workloads.coverage import (
        _coverage_batch, _coverage_batch_blocks,
    )

    rng = np.random.default_rng(3)
    k = 15
    codes = rng.integers(0, 5, size=(16, 256)).astype(np.uint8)
    qh, ql, valid = canonical_ids_pair(jnp.asarray(codes), k)
    qh = np.asarray(qh)
    ql = np.asarray(ql)
    present = (np.asarray(qh).astype(np.uint64) << np.uint64(30)) | np.asarray(
        ql
    ).astype(np.uint64)
    keys = np.unique(present[np.asarray(valid)])[::2]  # half the k-mers
    cnts = rng.integers(1, 100, len(keys)).astype(np.int32)

    blocks3, boff2, p_bits = cops.block_table(keys, cnts, k)
    got = np.asarray(_coverage_batch_blocks(
        jnp.asarray(codes), jnp.asarray(blocks3), jnp.asarray(boff2),
        k, 5, 16, p_bits, blocks3.shape[1],
    ))

    th, tl = _split(keys, k)
    bb = min(2 * k, 18)
    boff, steps = cops.bucket_offsets(keys, k, bb)
    want = np.asarray(_coverage_batch(
        jnp.asarray(codes),
        jnp.asarray(np.stack([th, tl], axis=1)),
        jnp.asarray(cnts), jnp.asarray(boff),
        k, 5, 16, bb, steps,
    ))
    assert np.array_equal(got, want)
