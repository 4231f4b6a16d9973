"""Device k-mer extraction vs the reference's exact-value expectations
(kmer/src/kmer.rs:113-145) and a brute-force oracle."""

import numpy as np


def test_pack_unpack_roundtrip():
    """pack_planes (host) + unpack_planes (device) reproduce the code
    plane exactly, including ambiguous/padding positions."""
    import jax.numpy as jnp

    from kmertools_jax.io.batch import pack_planes
    from kmertools_jax.ops.encode import unpack_planes

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 5, size=(16, 128)).astype(np.uint8)  # incl. 4s
    codes[3, :] = 4  # all-padding row
    packed, vb, n_ambig = pack_planes(codes)
    assert packed.shape == (16, 32) and vb.shape == (16, 16)
    assert n_ambig == -1  # no lengths given -> unknown
    out = np.asarray(unpack_planes(jnp.asarray(packed), jnp.asarray(vb)))
    assert np.array_equal(out, codes)


def test_pack_clean_path_equivalence():
    """For ambiguity-free rows the (packed, lengths) upload must decode
    to the identical code plane as the (packed, validbits) upload, and
    n_ambig must count exactly the in-length ambiguous codes."""
    import jax.numpy as jnp

    from kmertools_jax.io.batch import pack_planes
    from kmertools_jax.ops.encode import unpack_packed, unpack_planes

    rng = np.random.default_rng(11)
    lengths = np.array([128, 100, 57, 0, 8], dtype=np.int32)
    codes = np.full((5, 128), 4, dtype=np.uint8)
    for i, L in enumerate(lengths):
        codes[i, :L] = rng.integers(0, 4, size=L)
    packed, vb, n_ambig = pack_planes(codes, lengths)
    assert n_ambig == 0
    a = np.asarray(unpack_planes(jnp.asarray(packed), jnp.asarray(vb)))
    b = np.asarray(unpack_packed(jnp.asarray(packed), jnp.asarray(lengths)))
    assert np.array_equal(a, b) and np.array_equal(a, codes)

    # now poison two in-length codes and one padding position
    codes[1, 10] = 4
    codes[2, 56] = 4
    codes[0, 127] = 4
    lengths2 = np.array([127, 100, 57, 0, 8], dtype=np.int32)  # [0,127] pad
    _, _, n_ambig = pack_planes(codes, lengths2)
    assert n_ambig == 2
import pytest

from kmertools_jax.io.batch import encode_bases
from kmertools_jax.ops import encode
from kmertools_jax.utils import codec


def _pad(seq: bytes, w: int = 32) -> np.ndarray:
    codes = np.full((1, w), 4, dtype=np.uint8)
    arr = encode_bases(seq)
    codes[0, : len(arr)] = arr
    return codes


def _oracle_kmers(seq: bytes, k: int):
    """Sequential rolling encoder semantics (kmer/src/kmer.rs:80-106)."""
    out = []
    fval = rval = 0
    length = 0
    mask = (1 << (2 * k)) - 1
    shift = 2 * (k - 1)
    for ch in seq:
        f = int(codec.SEQ_NT4_TABLE[ch])
        if f < 4:
            fval = ((fval << 2) | f) & mask
            rval = (rval >> 2) | ((f ^ 3) << shift)
            length += 1
        else:
            length = 0
        if length == k:
            length -= 1
            out.append((fval, rval))
    return out


def test_kmers_acgt_k2():
    fwd, rc, valid = encode.kmer_ids_small(_pad(b"ACGT", 8), 2)
    fwd, rc, valid = np.asarray(fwd)[0], np.asarray(rc)[0], np.asarray(valid)[0]
    got = [(int(f), int(r)) for f, r, v in zip(fwd, rc, valid) if v]
    assert got == [(1, 11), (6, 6), (11, 1)]


def test_kmers_ambiguous():
    fwd, rc, valid = encode.kmer_ids_small(_pad(b"ACNGTT", 8), 2)
    fwd, rc, valid = np.asarray(fwd)[0], np.asarray(rc)[0], np.asarray(valid)[0]
    got = [(int(f), int(r)) for f, r, v in zip(fwd, rc, valid) if v]
    assert got == [(1, 11), (11, 1), (15, 0)]


@pytest.mark.parametrize("k", [3, 7, 11, 15])
def test_small_path_matches_oracle(k):
    rng = np.random.default_rng(42 + k)
    bases = b"ACGTN"
    seq = bytes(bases[i] for i in rng.integers(0, 5, size=200))
    fwd, rc, valid = encode.kmer_ids_small(_pad(seq, 256), k)
    fwd, rc, valid = np.asarray(fwd)[0], np.asarray(rc)[0], np.asarray(valid)[0]
    got = [(int(f), int(r)) for f, r, v in zip(fwd, rc, valid) if v]
    assert got == _oracle_kmers(seq, k)


@pytest.mark.parametrize("k", [16, 21, 27, 31])
def test_pair_path_matches_oracle(k):
    rng = np.random.default_rng(7 + k)
    bases = b"ACGTN"
    seq = bytes(bases[i] for i in rng.integers(0, 5, size=300))
    fh, fl, rh, rl, valid = encode.kmer_ids_pair(_pad(seq, 512), k)
    fh, fl = np.asarray(fh)[0].astype(np.uint64), np.asarray(fl)[0].astype(np.uint64)
    rh, rl = np.asarray(rh)[0].astype(np.uint64), np.asarray(rl)[0].astype(np.uint64)
    valid = np.asarray(valid)[0]
    nlo = min(k, 16)
    got = [
        (int((h << np.uint64(2 * nlo)) | l), int((h2 << np.uint64(2 * nlo)) | l2))
        for h, l, h2, l2, v in zip(fh, fl, rh, rl, valid)
        if v
    ]
    assert got == _oracle_kmers(seq, k)


@pytest.mark.parametrize("k", [13, 21])
def test_canonical_pair(k):
    rng = np.random.default_rng(1)
    seq = bytes(b"ACGT"[i] for i in rng.integers(0, 4, size=100))
    hi, lo, valid = encode.canonical_ids_pair(_pad(seq, 128), k)
    hi = np.asarray(hi)[0].astype(np.uint64)
    lo = np.asarray(lo)[0].astype(np.uint64)
    valid = np.asarray(valid)[0]
    nlo = min(k, 16)
    got = [int((h << np.uint64(2 * nlo)) | l) for h, l, v in zip(hi, lo, valid) if v]
    expect = [min(f, r) for f, r in _oracle_kmers(seq, k)]
    assert got == expect
