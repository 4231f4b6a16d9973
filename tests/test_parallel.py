"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kmertools_jax.io.batch import encode_bases
from kmertools_jax.parallel import (
    distributed_dense_count,
    distributed_oligo_step,
    make_mesh,
    sharded_accum_count,
)
from kmertools_jax.parallel.mesh import shard_batch
from kmertools_jax.utils import codec


def _random_codes(rng, rows, width, n_frac=0.02):
    codes = rng.integers(0, 4, size=(rows, width)).astype(np.uint8)
    mask = rng.random((rows, width)) < n_frac
    codes[mask] = 4
    return codes


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(8)


def test_distributed_oligo_matches_single(mesh):
    rng = np.random.default_rng(0)
    codes = _random_codes(rng, 64, 128)
    table = jnp.asarray(codec.canonical_slot_table(4))
    fn = distributed_oligo_step(mesh, table, 4, 136)
    counts, totals = fn(shard_batch(mesh, codes), table)
    from kmertools_jax.ops import encode, histogram

    fwd, rc, valid = encode.kmer_ids_small(jnp.asarray(codes), 4)
    ids = jnp.minimum(fwd, rc)
    ref_counts, ref_totals = histogram.per_read_histogram_gathered(
        ids, valid, table, 136
    )
    assert np.array_equal(np.asarray(counts), np.asarray(ref_counts))
    assert np.array_equal(np.asarray(totals), np.asarray(ref_totals))


def test_distributed_dense_count(mesh):
    rng = np.random.default_rng(1)
    codes = _random_codes(rng, 64, 128)
    fn = distributed_dense_count(mesh, 5)
    global_counts = np.asarray(fn(shard_batch(mesh, codes)))
    # brute force
    pos_map, _, kcount = codec.kmer_pos_maps(5)
    want = np.zeros(kcount)
    for row in codes:
        for i in range(len(row) - 4):
            win = row[i : i + 5]
            if (win >= 4).any():
                continue
            f = 0
            for c in win:
                f = f * 4 + int(c)
            r = codec.rev_comp(f, 5)
            want[pos_map[min(f, r)]] += 1
    assert np.array_equal(global_counts, want)


def _brute_counts(codes, k):
    want = {}
    for row in codes:
        run = 0
        for i in range(len(row)):
            run = run + 1 if row[i] < 4 else 0
            if run >= k:
                f = 0
                for c in row[i - k + 1 : i + 1]:
                    f = f * 4 + int(c)
                key = min(f, codec.rev_comp(f, k))
                want[key] = want.get(key, 0) + 1
    return want


def _fresh_state(mesh, ndev, C_dev):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kmertools_jax.parallel.mesh import DATA_AXIS

    sent = np.uint32(0xFFFFFFFF)
    sh = NamedSharding(mesh, P(DATA_AXIS, None))
    mk = jax.jit(
        lambda: (
            jnp.full((ndev, C_dev), sent, jnp.uint32),
            jnp.full((ndev, C_dev), sent, jnp.uint32),
            jnp.zeros((ndev, C_dev), jnp.uint32),
        ),
        out_shardings=(sh, sh, sh),
    )
    return mk()


def _collect_state(ah, al, ac, k, check_owner=True):
    nlo = min(k, 16)
    got = {}
    ah, al, ac = np.asarray(ah), np.asarray(al), np.asarray(ac)
    for d in range(ah.shape[0]):
        live = ac[d] > 0
        for h, l, c in zip(ah[d][live], al[d][live], ac[d][live]):
            key = (int(h) << (2 * nlo)) | int(l)
            if check_owner:
                assert int(l) % ah.shape[0] == d  # partition ownership
            assert key not in got  # partitions are disjoint + unique
            got[key] = int(c)
    return got


def test_sharded_accum_count_exact(mesh):
    """Two batches merged into the mesh-sharded accumulator match a
    brute-force count; ownership is lo % ndev (counter lib.rs:127)."""
    rng = np.random.default_rng(2)
    k = 21
    state = list(_fresh_state(mesh, 8, 1024))
    fn = sharded_accum_count(mesh, k, 1024, cap=512)
    all_rows = []
    for _ in range(2):
        codes = _random_codes(rng, 32, 128)
        all_rows.append(codes)
        *state, n_runs, ovf = fn(*state, shard_batch(mesh, codes))
        assert not np.asarray(ovf).any()
    got = _collect_state(*state, k)
    want = _brute_counts(np.concatenate(all_rows), k)
    assert got == want


def test_sharded_accum_count_overflow_rolls_back(mesh):
    """A too-small exchange bucket must flag overflow and leave every
    device's accumulator unchanged (consensus rollback)."""
    rng = np.random.default_rng(3)
    k = 21
    state1 = list(_fresh_state(mesh, 8, 2048))
    fn_small = sharded_accum_count(mesh, k, 2048, cap=2)  # forced tiny
    codes = _random_codes(rng, 32, 128, n_frac=0.0)
    *state1, n_runs, ovf = fn_small(*state1, shard_batch(mesh, codes))
    assert np.asarray(ovf).all()
    assert _collect_state(*state1, k) == {}  # still empty: rolled back
    assert (np.asarray(n_runs) == 0).all()


def test_device_accumulator_retry_on_overflow(mesh):
    """DeviceAccumulator recovers exact counts by re-dispatching the
    rolled-back batch in halves (VERDICT r1 item 8)."""
    from kmertools_jax.parallel.ops import sharded_accum_count as sac
    from kmertools_jax.workloads.counter import DeviceAccumulator

    rng = np.random.default_rng(4)
    k = 21
    codes = _random_codes(rng, 64, 128, n_frac=0.0)
    acc = DeviceAccumulator(k, target_codes=1 << 16)
    assert acc.used_mesh
    # force a tiny exchange bucket so the full batch must overflow
    acc._mk_step = lambda mode: sac(acc.mesh, k, acc.C_dev, 64, mode)
    acc._steps = {}
    retried = []
    orig = acc._retry_halves

    def spy(*a, **kw):
        retried.append(1)
        return orig(*a, **kw)

    acc._retry_halves = spy
    acc.add(codes)
    keys, counts = acc.drain()
    want = _brute_counts(codes, k)
    got = dict(zip(keys.tolist(), counts.tolist()))
    assert got == want
    assert retried, "tiny exchange bucket never overflowed: test is inert"
