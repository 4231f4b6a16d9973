from kmertools_jax.utils.codec import (
    SEQ_NT4_TABLE,
    kmer_pos_maps,
    kmer_to_numeric,
    numeric_to_kmer,
    numeric_to_kmer_array,
    rev_comp,
)
from kmertools_jax.utils.fmt import rust_f64_repr, format_fixed6

__all__ = [
    "SEQ_NT4_TABLE",
    "kmer_pos_maps",
    "kmer_to_numeric",
    "numeric_to_kmer",
    "numeric_to_kmer_array",
    "rev_comp",
    "rust_f64_repr",
    "format_fixed6",
]
