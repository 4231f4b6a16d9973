"""Card-only checks: the device kernels compiled for the GPU (no
interpret mode) against numpy. Marked ``gpu``; the ``gpu_device``
fixture skips them wherever JAX finds no GPU. Run on a machine with a
card: ``KMERTOOLS_TEST_GPU=1 python -m pytest -m gpu tests/``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kmertools_jax.ops import cgr as cgr_ops
from kmertools_jax.ops import count as cops
from kmertools_jax.ops import encode, histogram
from kmertools_jax.utils import codec

pytestmark = pytest.mark.gpu


def _codes(seed, R, W):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (R, W), dtype=np.uint8)
    codes[rng.random((R, W)) < 0.002] = 4
    return codes


def test_histogram_on_card(gpu_device):
    k = 4
    codes = _codes(1, 256, 4096)
    fwd, rc, valid = encode.kmer_ids_small(jnp.asarray(codes), k)
    ids = np.asarray(jnp.minimum(fwd, rc))
    table = np.asarray(codec.canonical_slot_table(k))
    nbins = codec.kmer_pos_maps(k)[2]
    v = np.asarray(valid)
    dense = table[np.where(v, ids, 0)]
    R = ids.shape[0]
    flat = dense.astype(np.int64) + np.arange(R)[:, None] * nbins
    want = np.bincount(flat[v], minlength=R * nbins).reshape(R, nbins)
    c, t = histogram.per_read_counts(
        jnp.asarray(ids), valid, nbins, jnp.asarray(table))
    assert np.array_equal(np.asarray(c).astype(np.int64), want)
    assert np.array_equal(np.asarray(t), v.sum(1))


def test_merge_network_on_card(gpu_device):
    rng = np.random.default_rng(3)
    C, M = 1 << 20, 1 << 18
    sent = np.uint32(0xFFFFFFFF)
    a = np.unique(rng.integers(0, 1 << 40, C // 2, dtype=np.uint64))
    b = np.sort(rng.integers(0, 1 << 40, M, dtype=np.uint64))
    ah = np.full(C, sent, np.uint32)
    al = np.full(C, sent, np.uint32)
    ac = np.zeros(C, np.uint32)
    ah[:len(a)] = (a >> np.uint64(32)).astype(np.uint32)
    al[:len(a)] = (a & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    ac[:len(a)] = 1
    bh = (b >> np.uint64(32)).astype(np.uint32)
    bl = (b & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    oh, ol, oc, n = jax.jit(cops.merge_sorted_batch)(
        *(jnp.asarray(x) for x in (ah, al, ac, bh, bl)))
    uk, cnt = np.unique(np.concatenate([a, b]), return_counts=True)
    n = int(n)
    keys = (np.asarray(oh)[:n].astype(np.uint64) << np.uint64(32)) | \
        np.asarray(ol)[:n]
    assert n == len(uk)
    assert np.array_equal(keys, uk)
    assert np.array_equal(np.asarray(oc)[:n], cnt)


def test_cgr_scan_f64_exact_on_card(gpu_device):
    from kmertools_jax.workloads import cgr as cgr_mod

    assert cgr_mod._f64_supported(), "device f64 CGR scan is not bit-exact"
    codes = np.random.default_rng(4).integers(0, 4, (8, 2048), np.uint8)
    xs, _ = cgr_ops.cgr_scan(jnp.asarray(codes), 1.0, jnp.float64)
    x = np.full(8, 0.5)
    want = np.empty((8, 2048))
    for t in range(2048):
        x = (x + np.array([0.0, 0.0, 1.0, 1.0])[codes[:, t]]) / 2.0
        want[:, t] = x
    assert np.array_equal(np.asarray(xs), want)
