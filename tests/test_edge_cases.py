"""Degenerate inputs every workload must survive (the reference handles
these implicitly via its streaming iterators)."""

import numpy as np
import pytest

from kmertools_jax.workloads.coverage import CovComputer
from kmertools_jax.workloads.counter import CountComputer
from kmertools_jax.workloads.oligo import OligoComputer
from kmertools_jax.workloads import minimisers


def _fq(path, reads):
    with open(path, "w") as f:
        for i, s in enumerate(reads):
            f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")


def test_oligo_empty_file(tmp_path):
    src = tmp_path / "e.fq"
    src.write_text("")
    out = tmp_path / "e.kmers"
    OligoComputer(str(src), str(out), 4, True).vectorise()
    assert out.read_bytes() == b""


def test_oligo_reads_shorter_than_k(tmp_path):
    src = tmp_path / "s.fq"
    _fq(src, ["AC", "ACG", "ACGTACGT"])
    out = tmp_path / "s.kmers"
    OligoComputer(str(src), str(out), 4, True).vectorise()
    lines = out.read_bytes().splitlines()
    assert len(lines) == 3
    # short reads produce all-zero vectors (total clamps to 1)
    assert set(lines[0].split()) == {b"0.000000"}
    assert set(lines[1].split()) == {b"0.000000"}


def test_oligo_all_n_read(tmp_path):
    src = tmp_path / "n.fq"
    _fq(src, ["N" * 50, "ACGT" * 10])
    out = tmp_path / "n.kmers"
    OligoComputer(str(src), str(out), 4, True).vectorise()
    lines = out.read_bytes().splitlines()
    assert len(lines) == 2
    assert set(lines[0].split()) == {b"0.000000"}


def test_counter_empty_and_short(tmp_path):
    src = tmp_path / "s.fq"
    _fq(src, ["ACGT", "A" * 9])  # all shorter than k=10
    outd = tmp_path / "c"
    outd.mkdir()
    c = CountComputer(str(src), str(outd), 10)
    c.count_and_merge(True)
    assert (outd / "kmers.counts").read_bytes() == b""


def test_minimiser_single_base_reads(tmp_path):
    src = tmp_path / "one.fq"
    _fq(src, ["A", "C", "ACGTACGTACGTACGT"])
    out = tmp_path / "m"
    minimisers.seq_to_min(0, 7, str(src), str(out))
    lines = out.read_bytes().splitlines()
    assert len(lines) == 3
    # no records: ["id", "\n"].join("\t") => one trailing tab
    assert lines[0] == b"r0\t"
    assert lines[2].startswith(b"r2\t")


def test_coverage_empty_file(tmp_path):
    src = tmp_path / "e.fq"
    src.write_text("")
    outd = tmp_path / "c"
    outd.mkdir()
    cov = CovComputer(str(src), str(outd), 15, 16, 16)
    cov.build_table()
    cov.compute_coverages()
    assert (outd / "kmers.vectors").read_bytes() == b""


def test_ctr_refuses_stdin(tmp_path):
    """Counting reads the input twice (stats pre-pass + count pass);
    stdin is not rewindable and the reference refuses it with a panic
    (ktio/src/seq.rs:137). Before this guard the pre-pass silently
    consumed stdin and the run emitted an EMPTY kmers.counts."""
    import pytest

    from kmertools_jax.workloads.counter import CountComputer

    c = CountComputer("-", str(tmp_path), 15)
    with pytest.raises(ValueError, match="rewindable"):
        c.count_and_merge(True)
    # coverage composes the counter, so its build refuses too
    from kmertools_jax.workloads.coverage import CovComputer

    cov = CovComputer("-", str(tmp_path), 4, 2, 3)
    with pytest.raises(ValueError, match="rewindable"):
        cov.build_table()
