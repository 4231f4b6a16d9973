"""Golden-file parity for the oligo workload
(composition/src/oligo.rs:311-432 test suite equivalents)."""

import numpy as np

from kmertools_jax.workloads.oligo import OligoComputer


def test_oligo_norm_golden(tmp_path, test_data):
    out = tmp_path / "computed_fa.kmers"
    com = OligoComputer(str(test_data / "reads.fq"), str(out), 4, True)
    com.vectorise()
    assert out.read_bytes() == (test_data / "expected_fa.kmers").read_bytes()


def test_oligo_norm_golden_fasta(tmp_path, test_data):
    out = tmp_path / "computed_fa2.kmers"
    com = OligoComputer(str(test_data / "reads.fa"), str(out), 4, True)
    com.vectorise()
    assert out.read_bytes() == (test_data / "expected_fa.kmers").read_bytes()


def test_oligo_norm_golden_gz(tmp_path, test_data):
    out = tmp_path / "computed_gz.kmers"
    com = OligoComputer(str(test_data / "reads.fq.gz"), str(out), 4, True)
    com.vectorise()
    assert out.read_bytes() == (test_data / "expected_fa.kmers").read_bytes()


def test_oligo_unnorm_golden(tmp_path, test_data):
    out = tmp_path / "computed_unnorm.kmers"
    com = OligoComputer(str(test_data / "reads.fq"), str(out), 4, True)
    com.set_norm(False)
    com.vectorise()
    assert out.read_bytes() == (test_data / "expected_fa_batch_unnorm.kmers").read_bytes()


def test_oligo_header_golden(tmp_path, test_data):
    out = tmp_path / "computed_header.kmers"
    com = OligoComputer(str(test_data / "reads.fq"), str(out), 4, True)
    com.set_header(True)
    com.vectorise()
    assert out.read_bytes() == (test_data / "expected_fa_header.kmers").read_bytes()


def test_oligo_header_values():
    com = OligoComputer("x.fq", "y", 4, True)
    header = com.get_header()
    assert header[0] == "AAAA"
    assert header[135] == "TTAA"
    com_raw = OligoComputer("x.fq", "y", 4, False)
    raw = com_raw.get_header()
    assert raw[0] == "AAAA"
    assert raw[-1] == "TTTT"
    assert len(raw) == 256


def test_oligo_small_batches_match(tmp_path, test_data):
    """Splitting into tiny batches must not change output (determinism
    under 'parallelism', the analog of oligo.rs:326-342)."""
    ref = tmp_path / "ref.kmers"
    com = OligoComputer(str(test_data / "reads.fq"), str(ref), 4, True)
    com.vectorise()
    small = tmp_path / "small.kmers"
    com2 = OligoComputer(str(test_data / "reads.fq"), str(small), 4, True)
    com2.set_max_memory(1 << 14)
    com2.vectorise()
    assert ref.read_bytes() == small.read_bytes()


def test_oligo_long_read_split(tmp_path):
    """A read longer than the max row width must produce the same vector
    as the same read unsplit (row-overlap correctness)."""
    rng = np.random.default_rng(3)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, size=20000))
    fa = tmp_path / "long.fa"
    fa.write_text(f">r1\n{seq}\n")
    out = tmp_path / "long.kmers"
    com = OligoComputer(str(fa), str(out), 4, True)
    com.set_norm(False)
    com.vectorise()
    counts = np.array(out.read_text().split(), dtype=np.int64)
    # brute force
    from kmertools_jax.utils import codec

    pos_map, _, kcount = codec.kmer_pos_maps(4)
    expect = np.zeros(kcount, dtype=np.int64)
    s = seq.encode()
    for i in range(len(s) - 3):
        f, r = codec.kmer_to_numeric(s[i : i + 4].decode())
        expect[pos_map[min(f, r)]] += 1
    assert (counts == expect).all()


def test_mixed_length_bucket_ordering(tmp_path):
    """Reads spread across all width buckets must come out in input
    order byte-for-byte (OrderedArrayEmitter reorder path)."""
    import numpy as np

    from kmertools_jax.workloads.oligo import OligoComputer

    rng = np.random.default_rng(17)
    lens = [60, 200, 400, 1500, 5000, 60, 3000, 90, 700, 11000, 64, 150]
    reads = ["".join(rng.choice(list("ACGT"), size=L)) for L in lens]
    src = tmp_path / "mix.fa"
    src.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    out = tmp_path / "mix.kmers"
    OligoComputer(str(src), str(out), 4, True).vectorise()
    lines = out.read_bytes().splitlines()
    assert len(lines) == len(reads)
    # oracle: single-read runs must match row-for-row
    for i in (0, 4, 9, 11):
        one = tmp_path / f"one{i}.fa"
        one.write_text(f">x\n{reads[i]}\n")
        oneout = tmp_path / f"one{i}.kmers"
        OligoComputer(str(one), str(oneout), 4, True).vectorise()
        assert oneout.read_bytes().splitlines()[0] == lines[i], i


def test_repeated_pipelined_runs_identical(tmp_path, test_data):
    """The reference's concurrency smoke test (composition/src/
    oligo.rs:326-368): repeated threaded runs must produce identical
    bytes. Our writer-thread pipeline is the analogous race surface."""
    from kmertools_jax.workloads.oligo import OligoComputer

    outs = []
    for i in range(4):
        out = tmp_path / f"run{i}.kmers"
        OligoComputer(
            str(test_data / "reads.fq"), str(out), 4, True
        ).vectorise()
        outs.append(out.read_bytes())
    assert all(o == outs[0] for o in outs[1:])


def test_oligo_u8_overflow_exact(tmp_path):
    """A read where one k-mer count exceeds 255 must take the exact
    int16 re-dispatch path and still match the brute-force vector
    (the u8 fetch payload wraps mod 256 without it)."""
    inp = tmp_path / "poly.fa"
    # 1500 A's -> count(AAAA) = 1497 > 255; plus a normal read
    inp.write_text(">p\n" + "A" * 1500 + "\n>q\n" + "ACGTACGTACGT" + "\n")
    out = tmp_path / "poly.kmers"
    com = OligoComputer(str(inp), str(out), 4, True)
    com.set_norm(False)
    com.vectorise()
    rows = out.read_text().splitlines()
    assert rows[0].split()[0] == "1497"  # AAAA is canonical slot 0
    # normal read untouched by the overflow batch re-dispatch
    vals = np.array(rows[1].split(), dtype=float)
    assert vals.sum() == 9  # 12bp -> 9 k-mers


def test_oligo_multi_producer_parity(tmp_path, monkeypatch):
    """Range-sharded multi-producer input (io.batch.multi_range_stream,
    KMERTOOLS_PRODUCERS) must be byte-identical to the single-producer
    stream: record-aligned ranges cover the file exactly once and the
    per-range parts concatenate in range order (the in-process analog
    of the multi-host part scheme)."""
    import numpy as np
    import pytest

    from kmertools_jax import native
    from kmertools_jax.workloads.oligo import OligoComputer

    if native.lib() is None:
        pytest.skip("native runtime required for range streams")
    rng = np.random.default_rng(23)
    src = tmp_path / "mix.fa"
    with open(src, "wb") as f:
        for i in range(600):
            L = int(rng.integers(40, 12_000))
            s = rng.choice(list(b"ACGT"), size=L).astype(np.uint8)
            s[rng.random(L) < 0.003] = ord("N")  # ambiguity resets
            f.write(b">r%d\n%s\n" % (i, s.tobytes()))

    def run(nprod: int, tag: str) -> bytes:
        monkeypatch.setenv("KMERTOOLS_PRODUCERS", str(nprod))
        out = tmp_path / f"{tag}.kmers"
        c = OligoComputer(str(src), str(out), 4, True)
        c.set_header(True)
        c.vectorise()
        return out.read_bytes()

    ref = run(1, "p1")
    for p in (2, 3):
        assert run(p, f"p{p}") == ref, f"{p}-producer output differs"
    # part files must not survive
    assert not list(tmp_path.glob("*.range_*"))


def test_plan_producers_policy(tmp_path, monkeypatch):
    """Auto policy: never split gz/stdin/shards or tiny files; explicit
    KMERTOOLS_PRODUCERS wins but clamps to 1 without the native lib."""
    from kmertools_jax import native
    from kmertools_jax.parallel.dataflow import Shard
    from kmertools_jax.workloads.common import plan_producers

    small = tmp_path / "small.fa"
    small.write_text(">a\nACGT\n")
    assert plan_producers(str(small)) == 1  # below size threshold
    assert plan_producers("-") == 1
    assert plan_producers("x.fa.gz") == 1
    assert plan_producers(str(small), shard=Shard(0, 0, 4)) == 1
    monkeypatch.setenv("KMERTOOLS_PRODUCERS", "3")
    if native.lib() is not None:
        assert plan_producers(str(small)) == 3
        assert plan_producers(str(small), shard=Shard(0, 0, 4)) == 1
    monkeypatch.setenv("KMERTOOLS_NO_NATIVE", "1")
    assert plan_producers(str(small)) == 1  # native-only feature
