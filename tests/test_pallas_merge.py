"""Accumulator merge (ops/count.py:merge_sorted_batch, the bitonic
network every backend runs) against a plain numpy oracle: the union of
the accumulator's (key, count) runs and the batch's keys (count 1
each), summed per key with np.unique."""

import jax
import numpy as np
import pytest
import jax.numpy as jnp

from kmertools_jax.ops import count as cops

SENT = np.uint32(0xFFFFFFFF)


def _acc(keys_hi, keys_lo, cnts, C):
    """Sentinel-tailed accumulator arrays of capacity C."""
    n = len(keys_hi)
    ah = np.full(C, SENT, np.uint32)
    al = np.full(C, SENT, np.uint32)
    ac = np.zeros(C, np.uint32)
    ah[:n] = keys_hi
    al[:n] = keys_lo
    ac[:n] = cnts
    return ah, al, ac


def _batch(keys_hi, keys_lo, M):
    bh = np.full(M, SENT, np.uint32)
    bl = np.full(M, SENT, np.uint32)
    bh[: len(keys_hi)] = keys_hi
    bl[: len(keys_lo)] = keys_lo
    return bh, bl


def _sorted_pairs(rng, n, hi_max, lo_max, dup_pool=None):
    if dup_pool is not None:
        hi = rng.choice(dup_pool[0], n)
        lo = rng.choice(dup_pool[1], n)
    else:
        hi = rng.integers(0, hi_max, n, dtype=np.uint32)
        lo = rng.integers(0, lo_max, n, dtype=np.uint32)
    key = hi.astype(np.uint64) << np.uint64(32) | lo
    order = np.argsort(key)
    return hi[order], lo[order]


_merge = jax.jit(cops.merge_sorted_batch)


def _oracle(ah, al, ac, bh, bl):
    """Sorted unique keys and summed counts, sentinel pairs dropped."""
    live_a = ~((ah == SENT) & (al == SENT))
    live_b = ~((bh == SENT) & (bl == SENT))
    keys = np.concatenate([
        (ah[live_a].astype(np.uint64) << np.uint64(32)) | al[live_a],
        (bh[live_b].astype(np.uint64) << np.uint64(32)) | bl[live_b],
    ])
    cnts = np.concatenate([
        ac[live_a].astype(np.uint64),
        np.ones(int(live_b.sum()), np.uint64),
    ])
    uk, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(uk), np.uint64)
    np.add.at(sums, inv, cnts)
    return uk, sums


def _check(ah, al, ac, bh, bl):
    got = _merge(
        jnp.asarray(ah), jnp.asarray(al), jnp.asarray(ac),
        jnp.asarray(bh), jnp.asarray(bl),
    )
    uk, sums = _oracle(*(np.asarray(x) for x in (ah, al, ac, bh, bl)))
    n_got = int(got[3])
    assert n_got == len(uk), f"n_runs {n_got} != {len(uk)}"
    oh, ol, oc = (np.asarray(g) for g in got[:3])
    assert len(oh) >= len(ah) + len(bh)
    keys = (oh[:n_got].astype(np.uint64) << np.uint64(32)) | ol[:n_got]
    assert np.array_equal(keys, uk), f"keys {keys[:10]} vs {uk[:10]}"
    assert np.array_equal(oc[:n_got].astype(np.uint64), sums)
    # tail contract: sentinels / zero counts
    assert (oh[n_got:] == SENT).all()
    assert (ol[n_got:] == SENT).all()
    assert (oc[n_got:] == 0).all()
    return n_got


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(256, 256), (512, 300), (300, 512)])
def test_merge_random(seed, shape):
    C, M = shape
    rng = np.random.default_rng(seed)
    na = rng.integers(0, C - 8)
    hi, lo = _sorted_pairs(rng, na, 50, 1 << 31)
    # accumulator keys must be unique
    key = hi.astype(np.uint64) << np.uint64(32) | lo
    _, idx = np.unique(key, return_index=True)
    hi, lo = hi[np.sort(idx)], lo[np.sort(idx)]
    cnts = rng.integers(1, 100, len(hi)).astype(np.uint32)
    ah, al, ac = _acc(hi, lo, cnts, C)
    nb = rng.integers(0, M)
    bhi, blo = _sorted_pairs(rng, nb, 50, 1 << 31)
    bh, bl = _batch(bhi, blo, M)
    _check(ah, al, ac, bh, bl)


def test_merge_heavy_duplicates_span_tiles():
    """One key repeated far more often than any other: its run spans
    many network blocks and must sum into one entry."""
    C, M = 512, 1024
    ah, al, ac = _acc(
        np.array([3], np.uint32), np.array([7], np.uint32),
        np.array([5], np.uint32), C,
    )
    bh, bl = _batch(
        np.full(900, 3, np.uint32), np.full(900, 7, np.uint32), M
    )
    n = _check(ah, al, ac, bh, bl)
    assert n == 1


def test_merge_empty_sides():
    C, M = 256, 256
    # empty accumulator
    ah, al, ac = _acc(
        np.empty(0, np.uint32), np.empty(0, np.uint32),
        np.empty(0, np.uint32), C,
    )
    bhi, blo = _sorted_pairs(np.random.default_rng(9), 100, 4, 1000)
    bh, bl = _batch(bhi, blo, M)
    _check(ah, al, ac, bh, bl)
    # empty batch
    hi, lo = _sorted_pairs(np.random.default_rng(10), 60, 4, 1000)
    key = hi.astype(np.uint64) << np.uint64(32) | lo
    _, idx = np.unique(key, return_index=True)
    hi, lo = hi[np.sort(idx)], lo[np.sort(idx)]
    ah, al, ac = _acc(hi, lo, np.full(len(hi), 2, np.uint32), C)
    bh, bl = _batch(np.empty(0, np.uint32), np.empty(0, np.uint32), M)
    _check(ah, al, ac, bh, bl)
    # both empty
    ah, al, ac = _acc(
        np.empty(0, np.uint32), np.empty(0, np.uint32),
        np.empty(0, np.uint32), C,
    )
    assert _check(ah, al, ac, bh, bl) == 0


def test_merge_extreme_lo_values():
    """lo = 0xFFFFFFFF is a REAL key half (poly-T 16-mer) and must not
    be confused with the sentinel pair."""
    C, M = 256, 128
    ah, al, ac = _acc(
        np.array([0, 1], np.uint32),
        np.array([0xFFFFFFFF, 0], np.uint32),
        np.array([9, 9], np.uint32), C,
    )
    bh, bl = _batch(
        np.array([0, 0, 1], np.uint32),
        np.array([5, 0xFFFFFFFF, 0], np.uint32), M,
    )
    _check(ah, al, ac, bh, bl)


def test_merge_exact_tile_boundaries():
    """C + M exactly a power of two (no network padding), every
    accumulator key hit once and new keys interleaved between them."""
    C, M = 256, 256
    hi = np.zeros(128, np.uint32)
    lo = (np.arange(128) * 2).astype(np.uint32)
    ah, al, ac = _acc(hi, lo, np.ones(128, np.uint32), C)
    # batch hits every accumulator key once and adds new odd keys
    bh, bl = _batch(
        np.zeros(256, np.uint32),
        np.sort(np.concatenate([lo, lo + 1]).astype(np.uint32)), M,
    )
    n = _check(ah, al, ac, bh, bl)
    assert n == 256


def test_accum_merge_pallas_path():
    """accum_merge (batch sort + network merge) over raw codes: the
    canonical k-mers of every window without an ambiguous base, counted
    by a plain Python loop, must equal the drained prefix."""
    from kmertools_jax.utils import codec

    rng = np.random.default_rng(4)
    codes = rng.integers(0, 5, size=(16, 64)).astype(np.uint8)
    k = 21
    C = 4096 - 16 * 64
    sentf = np.full(C, SENT, np.uint32)
    got = cops.accum_merge(
        jnp.asarray(sentf), jnp.asarray(sentf.copy()),
        jnp.asarray(np.zeros(C, np.uint32)), jnp.asarray(codes), k,
    )
    want: dict[int, int] = {}
    for row in codes:
        for i in range(len(row) - k + 1):
            w = row[i:i + k]
            if (w > 3).any():
                continue
            f, r = codec.kmer_to_numeric("".join("ACGT"[x] for x in w))
            want[min(f, r)] = want.get(min(f, r), 0) + 1
    n = int(got[3])
    assert n == len(want)
    oh, ol, oc = (np.asarray(g)[:n] for g in got[:3])
    keys = (oh.astype(np.uint64) << np.uint64(32)) | ol
    assert keys.tolist() == sorted(want)
    assert oc.tolist() == [want[x] for x in sorted(want)]


def test_merge_small_b_window_branch():
    """A small batch into a large accumulator (C + M padded up to the
    next power of two): sparse batch keys, a dense cluster inside one
    narrow key range, and duplicates across both sides."""
    rng = np.random.default_rng(21)
    C, M = 60_000, 2_500
    # sparse: ~2.5k batch keys spread over 30k accumulator keys
    hi, lo = _sorted_pairs(rng, C // 2, 1 << 8, 1 << 30)
    ah, al, ac = _acc(hi, lo, rng.integers(1, 9, len(hi)), C)
    bhs, bls_ = _sorted_pairs(rng, M - 64, 1 << 8, 1 << 30)
    bh, bl = _batch(bhs, bls_, M)
    _check(ah, al, ac, bh, bl)

    # dense cluster: all batch keys inside ONE narrow key range
    bh2 = np.full(M, 3, np.uint32)
    bl2 = np.sort(rng.integers(0, 1 << 12, M).astype(np.uint32))
    _check(ah, al, ac, bh2, bl2)

    # duplicates across A and B in the small-branch regime
    pool_hi = rng.integers(0, 4, 64, dtype=np.uint32)
    pool_lo = rng.integers(0, 1 << 10, 64, dtype=np.uint32)
    hi3, lo3 = _sorted_pairs(rng, 2_000, 0, 0, (pool_hi, pool_lo))
    # unique-ify A (accumulator holds unique keys)
    key3 = (hi3.astype(np.uint64) << np.uint64(32)) | lo3
    _, idx = np.unique(key3, return_index=True)
    ah3, al3, ac3 = _acc(
        hi3[idx], lo3[idx], rng.integers(1, 5, len(idx)), C
    )
    bh4, bl4 = _sorted_pairs(rng, 1_500, 0, 0, (pool_hi, pool_lo))
    bhp, blp = _batch(bh4, bl4, M)
    _check(ah3, al3, ac3, bhp, blp)
