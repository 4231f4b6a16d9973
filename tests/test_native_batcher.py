"""Native batcher vs pure-Python batcher equivalence.

The C++ parser (kthost.cpp:FastxParser/Batcher) takes a zero-copy fast
path for single-line records and falls back to materialised records for
multi-line FASTA / buffer-spanning lines; the pure-Python stream
(io/batch.py:batch_stream over io/fastx.py) is the oracle. Both must
yield identical Batch streams on every input shape — these corpora pin
the parser's edge cases (ktio/src/seq.rs:100-131 semantics).
"""

import os

import numpy as np
import pytest

from kmertools_jax import native
from kmertools_jax.io import fastx
from kmertools_jax.io import batch
from kmertools_jax.io.batch import batch_stream, native_batch_stream

pytestmark = pytest.mark.skipif(
    native.lib() is None, reason="native runtime unavailable"
)


def _assert_streams_equal(path, overlap=3):
    nb = list(native_batch_stream(str(path), overlap=overlap))
    pb = list(batch_stream(fastx.sequences(str(path)), overlap=overlap))
    assert len(nb) == len(pb)
    for a, b in zip(nb, pb):
        assert np.array_equal(a.codes, b.codes)
        assert np.array_equal(a.lengths, b.lengths)
        assert np.array_equal(a.read_idx, b.read_idx)
        assert np.array_equal(a.row_start, b.row_start)
        assert np.array_equal(a.last_row, b.last_row)
        assert a.ids == b.ids
        assert a.read_lengths == b.read_lengths


def test_multiline_fasta(tmp_path):
    """Wrapped FASTA (60/7/1-col lines) exercises the multi-line
    reclaim path: the zero-copy row translate is undone and the record
    finishes via the materialised path."""
    p = tmp_path / "wrapped.fa"
    rng = np.random.default_rng(0)
    with open(p, "wb") as f:
        for i, wrap in enumerate((60, 7, 1, 133)):
            seq = rng.choice(list(b"ACGT"), size=500).astype(np.uint8)
            f.write(b">r%d some description\n" % i)
            for s in range(0, len(seq), wrap):
                f.write(seq[s : s + wrap].tobytes() + b"\n")
    _assert_streams_equal(p)


def test_crlf_line_endings(tmp_path):
    p = tmp_path / "crlf.fa"
    p.write_bytes(b">a desc\r\nACGTACGTAC\r\nGGTT\r\n>b\r\nacgtu\r\n")
    _assert_streams_equal(p)


def test_empty_fasta_records(tmp_path):
    """Headers with no sequence — mid-file and at EOF."""
    p = tmp_path / "empty.fa"
    p.write_bytes(b">a\n>b\nACGT\n>c\n")
    _assert_streams_equal(p)


def test_fasta_no_trailing_newline(tmp_path):
    p = tmp_path / "notrail.fa"
    p.write_bytes(b">a\nACGTAC\n>b\nGGTTAA")
    _assert_streams_equal(p)


def test_fasta_junk_preheader(tmp_path):
    p = tmp_path / "junk.fa"
    p.write_bytes(b"; comment line\n\n>a\nACGT\n")
    _assert_streams_equal(p)


def test_fastq_blank_lines_between_records(tmp_path):
    p = tmp_path / "blank.fq"
    p.write_bytes(
        b"@r1 d\nACGTN\n+\nIIIII\n\n\n@r2\nggttaa\n+\nIIIIII\n"
    )
    _assert_streams_equal(p)


def test_fastq_truncated_record_dropped(tmp_path):
    """A final record missing its quality line is dropped, matching
    Sequences::next (ktio/src/seq.rs:100-131 unwraps -> iteration end)."""
    p = tmp_path / "trunc.fq"
    p.write_bytes(b"@r1\nACGT\n+\nIIII\n@r2\nGGTT\n+\n")
    _assert_streams_equal(p)


def test_line_spanning_read_buffer(tmp_path):
    """A single-line read longer than the reader's 1 MB buffer takes the
    spill path AND the long-read row-splitting path."""
    p = tmp_path / "huge.fa"
    rng = np.random.default_rng(1)
    big = rng.choice(list(b"ACGTN"), size=(3 << 20) + 17).astype(np.uint8)
    with open(p, "wb") as f:
        f.write(b">big\n" + big.tobytes() + b"\n")
        f.write(b">tail\nACGT\n")
    _assert_streams_equal(p)


def test_mixed_case_and_ambiguity(tmp_path):
    p = tmp_path / "mixed.fa"
    p.write_bytes(b">a\nacgtACGTuUnNxX-129\n")
    _assert_streams_equal(p)


def test_gzip_path(tmp_path):
    import gzip

    p = tmp_path / "reads.fa.gz"
    with gzip.open(p, "wb") as f:
        f.write(b">a\nACGTACGT\nGGTT\n>b\nacgt\n")
    _assert_streams_equal(p)


def test_seq_stats_matches_python(tmp_path):
    """kt_seq_stats (translation-free stat_next path) vs the Python
    oracle on a mixed corpus."""
    p = tmp_path / "mix.fa"
    rng = np.random.default_rng(2)
    with open(p, "wb") as f:
        for i in range(50):
            L = int(rng.integers(0, 300))
            seq = rng.choice(list(b"ACGTN"), size=L).astype(np.uint8)
            f.write(b">r%d\n" % i)
            for s in range(0, L, 80):
                f.write(seq[s : s + 80].tobytes() + b"\n")
            if L == 0:
                f.write(b"\n")
    st = fastx.seq_stats(str(p))
    count = total = 0
    for rec in fastx.sequences(str(p)):
        count += 1
        total += len(rec.seq)
    assert (st.seq_count, st.total_length) == (count, total)


def test_radix_argsort_matches_numpy_stable():
    """kt_radix_argsort_u64 must produce EXACTLY numpy's stable argsort
    permutation (the m2s output contract relies on stability: records
    pre-ordered by (read, start) sort by value only)."""
    from kmertools_jax import native
    from kmertools_jax.workloads.minimisers import _stable_argsort_u64

    so = native.lib()
    if so is None:
        import pytest

        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(3)
    for n, bits in ((1 << 15, 20), (100_000, 20), (70_000, 62), (1 << 15, 1)):
        a = rng.integers(0, 1 << min(bits, 62), size=n).astype(np.uint64)
        # heavy duplication so stability is actually exercised
        a[: n // 2] = a[0]
        got = _stable_argsort_u64(a, bits)
        want = np.argsort(a, kind="stable")
        assert np.array_equal(got, want), (n, bits)


def test_translate_all_bytes_parity(tmp_path):
    """The AVX2 pshufb translate must match the Python NT4 table for
    every byte value that can appear on a sequence line (byte parity is
    the project's top invariant and the SIMD path only runs on AVX2
    hosts — this pins it wherever it runs)."""
    from kmertools_jax.utils.codec import SEQ_NT4_TABLE

    payload = bytes(
        b for b in range(1, 256) if b not in (10, 13, ord(">"), ord("@"))
    )
    seq = payload * 9 + b"ACGTUacgtu" * 13  # >2 SIMD blocks + remainder
    p = tmp_path / "bytes.fa"
    p.write_bytes(b">r1\n" + seq + b"\n")
    exp = SEQ_NT4_TABLE[np.frombuffer(seq, np.uint8)]
    for b in batch.stream_path(str(p), overlap=0):
        got = b.codes[0][: len(seq)]
        assert np.array_equal(got, exp), np.flatnonzero(got != exp)[:5]


def test_pack_planes_matches_numpy_fuzz():
    """Native (AVX2 + scalar-tail) pack_planes vs the numpy reference
    computation: packed planes, valid bits, and the within-length
    ambiguity count."""
    from kmertools_jax import native

    if native.lib() is None:
        import pytest

        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(11)
    for R, W in [(8, 128), (5, 256), (64, 8192), (3, 8), (7, 40)]:
        codes = np.minimum(rng.integers(0, 6, size=(R, W)), 4).astype(np.uint8)
        lens = rng.integers(0, W + 1, size=R).astype(np.int32)
        p1, v1, a1 = batch.pack_planes(codes, lens)
        valid = codes < 4
        c = np.where(valid, codes, 0).astype(np.uint8)
        p2 = (
            c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4)
            | (c[:, 3::4] << 6)
        )
        v2 = np.packbits(valid, axis=1, bitorder="little")
        in_len = np.arange(W)[None, :] < lens[:, None]
        a2 = int(np.count_nonzero(~valid & in_len))
        assert np.array_equal(p1, p2) and np.array_equal(v1, v2), (R, W)
        assert a1 == a2, (R, W)


def test_fifo_gzip_input(tmp_path, test_data):
    """gzip arriving on a FIFO (process substitution): the native
    ByteSource's magic-byte sniff must not close-and-reopen the pipe
    (that blocks forever waiting for a second writer) — non-seekable
    fds hand straight to zlib's transparent reader. Regression test for
    the round-3 raw-fd fast path."""
    import threading

    def stream_ids_codes(path):
        out = []
        for b in batch.stream_path(path, overlap=0):
            for i in range(len(b.read_idx)):
                r = int(b.read_idx[i])
                if r < 0:
                    continue
                out.append(
                    (r, b.ids.get(r), b.codes[i, : b.lengths[i]].tobytes())
                )
        return sorted(out)

    def feed(fifo, payload):
        def writer():
            with open(fifo, "wb") as f:
                f.write(payload)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        return t

    # gz bytes over a FIFO (named .fq.gz so the format hint matches the
    # reference's extension detection; zlib's magic check decompresses)
    fifo = str(tmp_path / "p.fq.gz")
    os.mkfifo(fifo)
    t = feed(fifo, (test_data / "reads.fq.gz").read_bytes())
    got = stream_ids_codes(fifo)
    t.join(timeout=10)
    assert got == stream_ids_codes(str(test_data / "reads.fq"))

    # plain bytes over a FIFO keep working too
    fifo2 = str(tmp_path / "q.fa")
    os.mkfifo(fifo2)
    t2 = feed(fifo2, (test_data / "reads.fa").read_bytes())
    got2 = stream_ids_codes(fifo2)
    t2.join(timeout=10)
    assert got2 == stream_ids_codes(str(test_data / "reads.fa"))
