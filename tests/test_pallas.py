"""Per-read histograms (ops/histogram.py, the scatter-add every backend
runs) against np.bincount: canonical and raw k-mer modes, all-ambiguous
and ragged batches, and bare bin ids."""

import numpy as np
import jax.numpy as jnp
import pytest

from kmertools_jax.ops import encode, histogram
from kmertools_jax.utils import codec


def _bincount_rows(ids, valid, nbins):
    ids, valid = np.asarray(ids), np.asarray(valid)
    return np.stack([
        np.bincount(ids[r][valid[r]], minlength=nbins)[:nbins]
        for r in range(ids.shape[0])
    ]).astype(np.int64)


def _ids(codes, k, mode):
    """(raw ids, dense ids, valid, nbins, slot table | None)."""
    fwd, rc, valid = encode.kmer_ids_small(jnp.asarray(codes), k)
    if mode == "canon":
        table = np.asarray(codec.canonical_slot_table(k))
        _, _, nbins = codec.kmer_pos_maps(k)
        raw = np.asarray(jnp.minimum(fwd, rc))
        dense = table[np.where(np.asarray(valid), raw, 0)]
        return raw, dense, valid, nbins, table
    nbins = 4**k
    raw = np.asarray(fwd)
    return raw, raw, valid, nbins, None


def _check(codes, k, mode):
    raw, dense, valid, nbins, table = _ids(codes, k, mode)
    c, t = histogram.per_read_counts(
        jnp.asarray(raw), valid, nbins,
        None if table is None else jnp.asarray(table),
    )
    np.testing.assert_array_equal(
        np.asarray(c).astype(np.int64), _bincount_rows(dense, valid, nbins)
    )
    np.testing.assert_array_equal(np.asarray(t), np.asarray(valid).sum(1))


@pytest.mark.parametrize("k,mode", [(4, "canon"), (3, "raw"), (7, "canon")])
def test_pallas_histogram_matches_xla(k, mode):
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 5, size=(128, 128)).astype(np.uint8)
    _check(codes, k, mode)


@pytest.mark.parametrize("nbins", [136, 256, 5])
def test_scatter_histogram_matches_onehot(nbins):
    """Bare bin ids (the coverage workload's abundance bins) with a
    random validity mask: counts equal np.bincount per row."""
    rng = np.random.default_rng(11)
    ids = rng.integers(0, nbins, size=(64, 93)).astype(np.int32)
    valid = rng.random((64, 93)) < 0.8
    c, t = histogram.per_read_histogram_scatter(
        jnp.asarray(ids), jnp.asarray(valid), nbins
    )
    np.testing.assert_array_equal(
        np.asarray(c).astype(np.int64), _bincount_rows(ids, valid, nbins)
    )
    np.testing.assert_array_equal(np.asarray(t), valid.sum(1))


def test_pallas_histogram_all_ambiguous():
    codes = np.full((128, 64), 4, dtype=np.uint8)
    fwd, rc, valid = encode.kmer_ids_small(jnp.asarray(codes), 4)
    c, t = histogram.per_read_counts(fwd, valid, 136)
    assert int(np.asarray(c).sum()) == 0
    assert int(np.asarray(t).sum()) == 0


def test_pallas_histogram_ragged_rows():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, size=(37, 64)).astype(np.uint8)  # odd R
    _check(codes, 4, "raw")
