"""pykmertools.utils — numeric <-> ACGT codecs
(pybindings/src/kmer.rs:44-73 equivalents)."""

from __future__ import annotations

from kmertools_jax.utils import codec


def to_acgt(kmer: int, ksize: int) -> str:
    """Numeric k-mer -> ACGT string."""
    return codec.numeric_to_kmer(kmer, ksize)


def to_numeric(kmer: str):
    """ACGT k-mer -> (forward, reverse) numeric pair.

    Raises ValueError for k-mers longer than 32 bases
    (pybindings/src/kmer.rs:58-63).
    """
    if len(kmer) > 32:
        raise ValueError(f"Invalid k-mer length: {len(kmer)}, must be <= 32")
    return codec.kmer_to_numeric(kmer)
