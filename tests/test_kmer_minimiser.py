"""Combined k-mer+minimiser scanner vs the reference's unit-test oracle
(expected tuples parsed from kmer/src/kmer_minimisers.rs:213-330)."""

import re

import pytest

from kmertools_jax.ops.kmer_minimiser import KmerMinimiserGenerator
from kmertools_jax.utils.codec import numeric_to_kmer

REF = "/root/reference/kmer/src/kmer_minimisers.rs"

SEQ = (
    "ATGCGATATCGTAGGCGTCGATGGAGAGCTAGATCGATCGATCTAAATCCCGATCGATTCCGAGCGCGAT"
    "CAAAGCGCGATAGGCTAGCTAAAGCTAGCA"
)
ERR_SEQ = "ATGCGATATCGNTAGGCGTCGATGGA"


def _flat_pairs(seq, w, m):
    pairs = []
    for mv, _s, _e, ks in KmerMinimiserGenerator(seq, w, m):
        for k in ks:
            pairs.append((numeric_to_kmer(k, w), numeric_to_kmer(mv, m)))
    return pairs


def _reference_expected(test_name: str, until: str):
    src = open(REF).read()
    body = src[src.index(test_name):]
    if until:
        body = body[: body.index(until)]
    return re.findall(r'\("([ACGT]+)", "([ACGT]+)"\)', body)


@pytest.mark.skipif(not __import__("os").path.exists(REF), reason="no reference")
def test_combined_scanner_blog_example():
    exp = _reference_expected(
        "minimisers_generated_test", "minimisers_generated_with_error_test"
    )
    assert len(exp) == 70
    assert _flat_pairs(SEQ, 31, 7) == exp


@pytest.mark.skipif(not __import__("os").path.exists(REF), reason="no reference")
def test_combined_scanner_with_ambiguity():
    exp = _reference_expected("minimisers_generated_with_error_test", "")
    assert len(exp) == 11
    assert _flat_pairs(ERR_SEQ, 8, 5) == exp


def test_combined_scanner_short_sequence():
    # shorter than the window: only the sentinel record, no k-mers
    recs = list(KmerMinimiserGenerator("ACGTACGTAC", 31, 7))
    assert len(recs) == 1
    mv, s, e, ks = recs[0]
    assert mv == (1 << 64) - 1 and (s, e) == (0, 10) and ks == []
