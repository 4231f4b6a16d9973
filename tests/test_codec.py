"""Unit tests for codecs and canonical maps (ports of the reference's
exact-value tests: kmer/src/kmer.rs:113-176, kmer/src/lib.rs:56-71)."""

import numpy as np

from kmertools_jax.utils import codec


def test_numeric_to_kmer():
    assert codec.numeric_to_kmer(0b0001101111, 5) == "ACGTT"
    assert codec.numeric_to_kmer(0b0000011011, 5) == "AACGT"


def test_kmer_to_numeric():
    f, r = codec.kmer_to_numeric("ACGTT")
    assert f == 0b0001101111
    assert r == 0b0000011011


def test_rev_comp():
    assert codec.rev_comp(0b00011011, 4) == 0b00011011
    assert codec.rev_comp(0b001101101011, 6) == 0b000101100011


def test_pos_maps_k4():
    pos_map, pos_kmer, count = codec.kmer_pos_maps(4)
    assert count == 136
    assert len(pos_kmer) == 136
    assert (pos_map < 136).all()
    assert pos_map[0] == 0  # AAAA
    assert pos_map[0b11111111] == 0  # TTTT (canonical entries only)
    assert pos_map[0b11] == 0b11  # AAAT -> 11
    # exactly one zero among canonical slots besides AAAA
    assert int((pos_map > 0).sum()) == 135


def test_canonical_slot_table():
    tbl = codec.canonical_slot_table(4)
    pos_map, _, _ = codec.kmer_pos_maps(4)
    # every kmer maps to its canonical slot
    for kmer in [0, 3, 0b11111111, 0b10010011]:
        canon = min(kmer, codec.rev_comp(kmer, 4))
        assert tbl[kmer] == pos_map[canon]


def test_numeric_to_kmer_array():
    arr = codec.numeric_to_kmer_array(np.array([0b0001101111, 0b0000011011]), 5)
    assert arr[0] == b"ACGTT"
    assert arr[1] == b"AACGT"


def test_native_f64_matches_rust_repr():
    """kt_format_cgr's f64 formatter must byte-match rust_f64_repr."""
    import ctypes

    import numpy as np

    from kmertools_jax import native
    from kmertools_jax.utils.fmt import rust_f64_repr

    so = native.lib()
    if so is None:
        import pytest

        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.random(200),                       # typical CGR range
        rng.random(50) * 2.0**-40,             # deep positional expansion
        np.array([0.0, 1.0, 0.5, 0.3125, 123456.0, 2.0**-60, 1e-30]),
        (rng.integers(0, 100, 20)).astype(np.float64),  # integral
    ])
    xs = vals.reshape(1, -1)
    ys = xs.copy()
    lens = np.array([xs.shape[1]], dtype=np.int32)
    buf = ctypes.create_string_buffer(xs.size * 1500)
    n = so.kt_format_cgr(
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ys.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        lens.ctypes.data_as(native.c_i32_p),
        1, xs.shape[1], buf, len(buf),
    )
    assert n > 0
    got = buf.raw[:n].decode()
    want = " ".join(
        f"({rust_f64_repr(v)},{rust_f64_repr(v)})" for v in vals
    ) + "\n"
    assert got == want
