"""Ported reference Python golden tests (reference tests/test_*.py),
exercising the pykmertools drop-in API."""

import pykmertools as kt
from pykmertools import utils as ktutils

from kmertools_jax.io import fastx


def _read_seqs(path):
    return [rec.seq.decode() for rec in fastx.sequences(str(path))]


def test_oligo(test_data):
    """reference tests/test_oligo.py."""
    oligo_gen = kt.OligoComputer(4)
    seqs = _read_seqs(test_data / "reads.fq")
    generated = [
        [round(x, 6) for x in line] for line in oligo_gen.vectorise_batch(seqs)
    ]
    truth = [
        [float(v) for v in line.strip().split()]
        for line in (test_data / "expected_fa.kmers").read_text().splitlines()
    ]
    for g, t in zip(generated, truth):
        assert g == t


def test_oligo_header():
    oligo_gen = kt.OligoComputer(4)
    assert len(oligo_gen.get_header()) == 136
    assert len(oligo_gen.get_header(False)) == 256


def test_oligo_noncanonical_total_quirk():
    """pybindings/src/oligo.rs:61: non-canonical norm divides by 2x the
    k-mer count — reproduced for drop-in parity."""
    com = kt.OligoComputer(4)
    vec = com.vectorise_one("AAAANGAGA", norm=True, mins=False)
    # 1 AAAA k-mer + 1 GAGA k-mer; totals double to 4 => AAAA freq 0.25
    assert vec[0] == 0.25
    vec_canon = com.vectorise_one("AAAANGAGA", norm=True, mins=True)
    assert vec_canon[0] == 0.5  # CLI semantics (oligo.rs:286-295 test)


def test_oligo_unnorm_one():
    com = kt.OligoComputer(4)
    vec = com.vectorise_one("AAAANGAGA", norm=False, mins=True)
    assert vec[0] == 1.0
    assert sum(vec) == 2.0


def test_cgr(test_data):
    """reference tests/test_cgr.py."""
    cgr_gen = kt.CgrComputer(1)
    seqs = _read_seqs(test_data / "reads.fq")
    generated = cgr_gen.vectorise_batch(seqs)
    truth = [
        [eval(item) for item in line.split(" ")]
        for line in (test_data / "expected_reads.cgr").read_text().splitlines()
    ]
    for g, t in zip(generated, truth):
        assert g == t


def test_kmers():
    """reference tests/test_kmers.py."""
    kmer_gen = kt.KmerGenerator("ACGTCC", 3)
    kmers = list(kmer_gen)
    kmers_acgt = ["ACG", "CGT", "GTC", "TCC"]
    assert len(kmers) == 4
    for (fmer, _), acgt in zip(kmers, kmers_acgt):
        assert ktutils.to_acgt(fmer, len(acgt)) == acgt


def test_kmer_pos_maps_api():
    gen = kt.KmerGenerator("ACGT", 4)
    pos_map, pos_kmer, count = gen.kmer_pos_maps()
    assert count == 136
    assert len(pos_map) == 256
    assert pos_kmer[0] == 0


def test_min():
    """reference tests/test_min.py."""
    min_gen = kt.MinimiserGenerator(
        "ATGCGATATCGTAGGCGTCGATGGAGAGCTAGATCGATCGATCTAAATCCCGATCGATTC"
        "CGAGCGCGATCAAAGCGCGATAGGCTAGCTAAAGCTAGCA",
        31,
        7,
    )
    mins = ["ACGATAT", "ACGCCTA", "AGAGCTA", "AAATCCC", "AATCCCG", "AATCGAT", "AAAGCGC"]
    got = [min_gen.to_acgt(kmer) for kmer, _, _ in min_gen]
    assert got == mins


def test_minimiser_sentinel_is_u64max():
    """Trailing segment shorter than the window yields raw u64::MAX like
    the PyO3 binding (kmer/src/minimiser.rs:168-171 + pyo3 u64 passthrough)."""
    gen = kt.MinimiserGenerator("ACGTACGTAC", 31, 7)
    recs = list(gen)
    assert recs == [((1 << 64) - 1, 0, 10)]
    assert gen.to_acgt(recs[0][0]) == "TTTTTTT"


def test_to_acgt():
    """reference tests/test_utils.py."""
    assert ktutils.to_acgt(111, 5) == "ACGTT"
    assert ktutils.to_acgt(27, 5) == "AACGT"


def test_to_numeric():
    k1, k2 = ktutils.to_numeric("ACGTT")
    assert k1 == 111
    assert k2 == 27


def test_to_numeric_too_long():
    import pytest

    with pytest.raises(ValueError):
        ktutils.to_numeric("A" * 33)


def test_cgr_bad_base_valueerror():
    import pytest

    with pytest.raises(ValueError):
        kt.CgrComputer(1).vectorise_one("ACGTX")


def test_oligo_batch_native_matches_device(monkeypatch):
    """vectorise_batch must return identical floats whichever engine
    ran the counts (the native kernel joins on CPU backends by
    default; KMERTOOLS_NO_HETERO pins the device path)."""
    import pykmertools as kt

    oc = kt.OligoComputer(4)
    seqs = ["ACGTACGTGTCA", "GCNNGTATGTAT", "A" * 20, ""]
    cases = [(True, True), (False, True), (True, False), (False, False)]
    native = [oc.vectorise_batch(seqs, n, m) for n, m in cases]
    monkeypatch.setenv("KMERTOOLS_NO_HETERO", "1")
    device = [oc.vectorise_batch(seqs, n, m) for n, m in cases]
    assert native == device
