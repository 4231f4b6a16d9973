"""Coverage golden parity (coverage/src/lib.rs:187-242 equivalents).

Note: test_data/expected_fq_cov.kmers is referenced by no test or code
path in the reference repo (its totals imply an obsolete both-strands
rule), so the authoritative goldens are expected_counts{,_unnorm}.vectors.
"""

from kmertools_jax.workloads.coverage import CovComputer


def test_coverage_golden(tmp_path, test_data):
    cov = CovComputer(str(test_data / "reads.fq"), str(tmp_path), 4, 2, 3)
    cov.build_table()
    cov.compute_coverages()
    assert (tmp_path / "kmers.vectors").read_bytes() == (
        test_data / "expected_counts.vectors"
    ).read_bytes()


def test_coverage_unnorm_golden(tmp_path, test_data):
    cov = CovComputer(str(test_data / "reads.fq"), str(tmp_path), 4, 2, 3)
    cov.set_norm(False)
    cov.build_table()
    cov.compute_coverages()
    assert (tmp_path / "kmers.vectors").read_bytes() == (
        test_data / "expected_counts_unnorm.vectors"
    ).read_bytes()


def test_coverage_alt_input(tmp_path, test_data):
    """-a/--alt-input: count table from a different file
    (coverage/src/lib.rs:61-63, args.rs:311-313)."""
    cov = CovComputer(str(test_data / "reads.fq"), str(tmp_path), 4, 2, 3)
    cov.set_kmer_path(str(test_data / "reads.fa"))
    cov.build_table()
    cov.compute_coverages()
    assert (tmp_path / "kmers.vectors").read_bytes() == (
        test_data / "expected_counts.vectors"
    ).read_bytes()


def test_native_sink_joins_coverage(tmp_path, test_data):
    """kmers.vectors must be byte-identical with the native cov sink
    active (default) and disabled (KMERTOOLS_NO_HETERO) — scheduling
    must never change bytes."""
    import os

    import pytest

    from kmertools_jax import native
    from kmertools_jax.workloads.coverage import CovComputer

    if native.lib() is None:
        pytest.skip("native runtime unavailable")

    def run(sub):
        d = tmp_path / sub
        d.mkdir()
        cov = CovComputer(str(test_data / "reads.fq"), str(d), 4, 2, 3)
        cov.build_table()
        cov.compute_coverages()
        return (d / "kmers.vectors").read_bytes()

    a = run("hetero")
    os.environ["KMERTOOLS_NO_HETERO"] = "1"
    try:
        b = run("device")
    finally:
        del os.environ["KMERTOOLS_NO_HETERO"]
    assert a == b
    assert a == (test_data / "expected_counts.vectors").read_bytes()
