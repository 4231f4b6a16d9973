"""Direct-bucket pre-binned count-table join (ops/count.py:
direct_table + lookup_bins_direct).

The block join issues 3 gathers per query; the direct layout indexes
a private padded row block per key prefix arithmetically and stores
pre-binned values, so a query resolves with ONE gather. These tests
pin exact bin agreement with the binary-search join + host binning
across key widths, bin widths, row layouts (2- and 3-plane), absent
keys, sentinel queries, and the skew/memory-cap fallbacks.
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


@pytest.mark.parametrize("k,bin_size,bin_count", [
    (4, 2, 3),      # the cov golden's config
    (15, 5, 16),    # CLI defaults, 32-bit keys
    (16, 5, 16),    # hi plane exactly empty
    (21, 1, 5),     # minimum bin_count
    (21, 3, 300),   # 9-bit bins (hi 10 + bin 9 still packs)
    (28, 5, 16),    # widest hi that still packs with 4-bit bins
    (31, 5, 16),    # 3-plane layout (hi 30 + bin 4 > 32)
])
def test_direct_join_matches_binary_search(k, bin_size, bin_count):
    rng = np.random.default_rng(k * 1000 + bin_count)
    n = 5000
    space = 1 << (2 * k)
    # canonical-style skew: min of two uniforms biases keys low
    a = rng.integers(0, space, n * 2, dtype=np.uint64)
    keys = np.unique(np.minimum(a[:n], a[n:]))
    cnts = rng.integers(1, 5000, len(keys)).astype(np.int32)

    dt = cops.direct_table(keys, cnts, k, bin_size, bin_count)
    assert dt is not None
    rows, p_bits, bin_bits, planes = dt
    # flat planar rows: width = planes * S; the quotient layout needs
    # 2k - p + bin_bits <= 32, the wide fallbacks pack by hi width
    assert planes in (1, 2, 3)
    assert rows.ndim == 2 and rows.shape[1] % (8 * planes) == 0
    if planes == 1:
        assert 2 * k - p_bits + bin_bits <= 32

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

    got = np.asarray(cops.lookup_bins_direct(
        jnp.asarray(qh), jnp.asarray(ql), jnp.asarray(rows),
        k, p_bits, bin_bits, planes, chunk=256,
    ))

    th, tl = _split(keys, k)
    bb = min(2 * k, 18)
    boff, steps = cops.bucket_offsets(keys, k, bb)
    want_cnt = np.asarray(cops.lookup_counts_bucketed(
        jnp.asarray(qh), jnp.asarray(ql),
        jnp.asarray(np.stack([th, tl], axis=1)),
        jnp.asarray(cnts), jnp.asarray(boff), k, bb, steps,
    ))
    want = np.minimum(want_cnt // bin_size, bin_count - 1)
    # sentinel queries: any layout may report 0; the workload masks
    # them via `valid` — but the direct join must still say 0
    assert np.array_equal(got, want)


def test_direct_table_fallbacks():
    """Skewed tables (shared deep prefix) and tight memory caps must
    return None so the caller keeps the block/binary-search joins."""
    k = 31
    keys = np.arange(3000, dtype=np.uint64)  # identical top 48 bits
    cnts = np.ones(3000, np.int32)
    assert cops.direct_table(keys, cnts, k, 5, 16, p_cap=20) is None
    # memory cap: a fitting layout exists but is refused
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(0, 1 << 42, 5000, dtype=np.uint64))
    ones = np.ones(len(keys), np.int32)
    assert cops.direct_table(
        keys, ones, 21, 5, 16, mem_cap_bytes=1024
    ) is None
    assert cops.direct_table(
        keys, ones, 21, 5, 16, mem_cap_bytes=1 << 30
    ) is not None
    # empty table
    assert cops.direct_table(
        np.empty(0, np.uint64), np.empty(0, np.int32), 21, 5, 16
    ) is None


def test_direct_join_end_to_end_device_parity():
    """Coverage batch program: direct-join variant == binary-search
    variant on real encoded reads (the device paths the workload
    routes between)."""
    from kmertools_jax.workloads.coverage import (
        _coverage_batch, _coverage_batch_direct,
    )

    rng = np.random.default_rng(7)
    k = 15
    codes = rng.integers(0, 5, size=(16, 256)).astype(np.uint8)
    qh, ql, valid = canonical_ids_pair(jnp.asarray(codes), k)
    qh = np.asarray(qh)
    ql = np.asarray(ql)
    present = (qh.astype(np.uint64) << np.uint64(30)) | ql.astype(np.uint64)
    keys = np.unique(present[np.asarray(valid)])[::2]  # half the k-mers
    cnts = rng.integers(1, 100, len(keys)).astype(np.int32)

    rows, p_bits, bin_bits, planes = cops.direct_table(keys, cnts, k, 5, 16)
    assert rows.ndim == 2
    got = np.asarray(_coverage_batch_direct(
        jnp.asarray(codes), jnp.asarray(rows), k, 16, p_bits, bin_bits,
        planes,
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


@pytest.mark.parametrize("mode", ["direct", "blocks", "bsearch"])
def test_coverage_golden_per_join_mode(tmp_path, test_data, monkeypatch,
                                       mode):
    """End-to-end golden with each join layout FORCED on the XLA path
    (native sink off): kmers.vectors byte-identical to the reference
    golden — the join layout must never change output bytes. (direct
    is the auto default when its footprint fits, so blocks/bsearch need
    the pin to stay covered.)"""
    from kmertools_jax.workloads.coverage import CovComputer

    monkeypatch.setenv("KMERTOOLS_NO_HETERO", "1")
    monkeypatch.setenv("KMERTOOLS_COV_JOIN", mode)
    cov = CovComputer(str(test_data / "reads.fq"), str(tmp_path), 4, 2, 3)
    cov.build_table()
    cov.compute_coverages()
    assert (tmp_path / "kmers.vectors").read_bytes() == (
        test_data / "expected_counts.vectors"
    ).read_bytes()


def test_direct_join_compact_quotient_layout():
    """Big-table scale picks the single-plane quotient layout (~6-8
    B/key, VERDICT r4 #4) and its bins agree exactly with the
    binary-search join — including absent keys whose remainder matches
    a pad slot (pads carry bin 0, so a false pad match adds nothing)."""
    rng = np.random.default_rng(42)
    k = 21
    n = 200_000
    space = 1 << (2 * k)
    a = rng.integers(0, space, n * 2, dtype=np.uint64)
    keys = np.unique(np.minimum(a[:n], a[n:]))
    cnts = rng.integers(1, 5000, len(keys)).astype(np.int32)
    dt = cops.direct_table(keys, cnts, k, 5, 16)
    assert dt is not None
    rows, p_bits, bin_bits, planes = dt
    assert planes == 1, "compact layout should win at this scale"
    # canonical-skew max/mean span ratio + the 64-lane row floor bound
    # the padding overhead: ~21 B/key at this small scale
    assert rows.nbytes / len(keys) <= 24.0  # bytes per key
    q = np.concatenate([
        rng.choice(keys, 2000),
        rng.integers(0, space, 2000, dtype=np.uint64),
    ])
    qh, ql = _split(q, k)
    got = np.asarray(cops.lookup_bins_direct(
        jnp.asarray(qh.reshape(4, -1)), jnp.asarray(ql.reshape(4, -1)),
        jnp.asarray(rows), k, p_bits, bin_bits, planes,
    ))
    th, tl = _split(keys, k)
    bb = min(2 * k, 18)
    boff, steps = cops.bucket_offsets(keys, k, bb)
    want_cnt = np.asarray(cops.lookup_counts_bucketed(
        jnp.asarray(qh.reshape(4, -1)), jnp.asarray(ql.reshape(4, -1)),
        jnp.asarray(np.stack([th, tl], axis=1)),
        jnp.asarray(cnts), jnp.asarray(boff), k, bb, steps,
    ))
    want = np.minimum(want_cnt // 5, 15)
    assert np.array_equal(got, want)
