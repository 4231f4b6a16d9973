"""Native C++ per-read histogram (kthost.cpp:kt_oligo_hist) vs the XLA
kernels — the heterogeneous CPU sink must be bit-equal to the device
path (the golden suite pins that path to the reference,
composition/src/oligo.rs:240-254)."""

import ctypes

import numpy as np
import jax.numpy as jnp
import pytest

from kmertools_jax import native
from kmertools_jax.io.batch import pack_planes
from kmertools_jax.ops import encode, histogram
from kmertools_jax.utils import codec


def _native_hist(codes, k, canonical):
    so = native.lib()
    R, W = codes.shape
    lengths = np.full((R,), W, np.int32)
    packed, vb, _ = pack_planes(codes, lengths)
    nbins = codec.kmer_pos_maps(k)[2] if canonical else 4**k
    table = (
        np.ascontiguousarray(codec.canonical_slot_table(k), dtype=np.int32)
        if canonical
        else None
    )
    counts = np.empty((R, nbins), np.int16)
    totals = np.empty((R,), np.int32)
    rc = so.kt_oligo_hist(
        np.ascontiguousarray(packed).ctypes.data_as(native.c_u8_p),
        np.ascontiguousarray(vb).ctypes.data_as(native.c_u8_p),
        R, W, k,
        table.ctypes.data_as(native.c_i32_p) if table is not None else None,
        nbins,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        totals.ctypes.data_as(native.c_i32_p),
        3, nbins,
    )
    assert rc == 0
    return counts, totals


@pytest.mark.parametrize("k", [3, 4, 7])
@pytest.mark.parametrize("canonical", [True, False])
def test_native_hist_matches_xla(k, canonical):
    so = native.lib()
    if so is None:
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=(37, 256)).astype(np.uint8)
    # sprinkle ambiguous bases (reset semantics, kmer/src/kmer.rs:96-99)
    amb = rng.random(codes.shape) < 0.03
    codes[amb] = 4
    # padded tail rows
    codes[5, 100:] = 4
    codes[6, :] = 4

    n_counts, n_totals = _native_hist(codes, k, canonical)

    fwd, rc, valid = encode.kmer_ids_small(jnp.asarray(codes), k)
    if canonical:
        table = jnp.asarray(codec.canonical_slot_table(k))
        x_counts, x_totals = histogram.per_read_histogram_gathered(
            jnp.minimum(fwd, rc), valid, table, n_counts.shape[1]
        )
    else:
        x_counts, x_totals = histogram.per_read_histogram_scatter(
            fwd, valid, 4**k
        )
    np.testing.assert_array_equal(
        n_counts.astype(np.int64), np.asarray(x_counts).astype(np.int64)
    )
    np.testing.assert_array_equal(n_totals, np.asarray(x_totals))


def test_native_sink_joins_oligo(tmp_path, test_data):
    """Oligo output is byte-identical with the native sink active
    (default) and disabled (KMERTOOLS_NO_HETERO) — scheduling must
    never change bytes."""
    import os

    from kmertools_jax.workloads.oligo import OligoComputer

    if native.lib() is None:
        pytest.skip("native runtime unavailable")
    a = tmp_path / "a.kmers"
    OligoComputer(str(test_data / "reads.fq"), str(a), 4, True).vectorise()
    os.environ["KMERTOOLS_NO_HETERO"] = "1"
    try:
        b = tmp_path / "b.kmers"
        OligoComputer(str(test_data / "reads.fq"), str(b), 4, True).vectorise()
    finally:
        del os.environ["KMERTOOLS_NO_HETERO"]
    assert a.read_bytes() == b.read_bytes()
    assert a.read_bytes() == (test_data / "expected_fa.kmers").read_bytes()


@pytest.mark.parametrize("k,width", [(3, 2048), (4, 2048), (4, 8192),
                                     (7, 2048)])
@pytest.mark.parametrize("canonical", [True, False])
def test_native_hist_striped_long_rows(k, width, canonical):
    """Contig-scale CLEAN rows cross kt_oligo_hist's striped-accumulator
    threshold (nk >= 8*nbins, kthost.cpp) — the short-row tests never
    execute that path (ADVICE r3). Includes a homopolymer row (the
    store-forwarding worst case the stripes exist for) and a clean
    shorter row (contiguous valid prefix)."""
    so = native.lib()
    if so is None:
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, size=(9, width)).astype(np.uint8)
    codes[3, :] = 1  # homopolymer
    codes[4, width // 2:] = 4  # clean row shorter than the bucket

    n_counts, n_totals = _native_hist(codes, k, canonical)

    fwd, rc, valid = encode.kmer_ids_small(jnp.asarray(codes), k)
    if canonical:
        table = jnp.asarray(codec.canonical_slot_table(k))
        x_counts, x_totals = histogram.per_read_histogram_gathered(
            jnp.minimum(fwd, rc), valid, table, n_counts.shape[1]
        )
    else:
        x_counts, x_totals = histogram.per_read_histogram_scatter(
            fwd, valid, 4**k
        )
    np.testing.assert_array_equal(
        n_counts.astype(np.int64), np.asarray(x_counts).astype(np.int64)
    )
    np.testing.assert_array_equal(n_totals, np.asarray(x_totals))
