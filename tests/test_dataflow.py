"""Multi-host byte-range input sharding (parallel/dataflow)."""

import numpy as np
import pytest

from kmertools_jax.io import fastx
from kmertools_jax.parallel import dataflow


def _write_fastq(path, rng, n):
    names = []
    with open(path, "w") as f:
        for i in range(n):
            L = int(rng.integers(30, 200))
            s = "".join(rng.choice(list("ACGT"), size=L))
            # qualities that start with '@' to stress boundary detection
            qual = "@" * L
            f.write(f"@read_{i} extra meta\n{s}\n+\n{qual}\n")
            names.append(f"read_{i}")
    return names


def _write_fasta(path, rng, n):
    names = []
    with open(path, "w") as f:
        for i in range(n):
            L = int(rng.integers(30, 300))
            s = "".join(rng.choice(list("ACGT"), size=L))
            # multi-line sequences
            f.write(f">seq{i}\n")
            for j in range(0, L, 60):
                f.write(s[j : j + 60] + "\n")
            names.append(f"seq{i}")
    return names


@pytest.mark.parametrize("n_shards", [1, 2, 3, 7])
def test_fastq_shards_cover_exactly(tmp_path, n_shards):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "r.fq")
    names = _write_fastq(path, rng, 53)
    shards = dataflow.split_file(path, n_shards)
    assert shards[0].start == 0
    for a, b in zip(shards, shards[1:]):
        assert a.end == b.start
    got = []
    for sh in shards:
        got.extend(rec.id for rec in dataflow.shard_sequences(path, sh))
    assert got == names


@pytest.mark.parametrize("n_shards", [2, 5])
def test_fasta_shards_cover_exactly(tmp_path, n_shards):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "r.fa")
    names = _write_fasta(path, rng, 31)
    shards = dataflow.split_file(path, n_shards)
    got = []
    total_bases = 0
    for sh in shards:
        for rec in dataflow.shard_sequences(path, sh):
            got.append(rec.id)
            total_bases += len(rec.seq)
    assert got == names
    assert total_bases == fastx.seq_stats(path).total_length


def test_gzip_not_splittable(tmp_path):
    with pytest.raises(ValueError):
        dataflow.split_file("reads.fq.gz", 2)


def test_sharded_oligo_concat_equals_whole(tmp_path):
    """Multi-host simulation: each host vectorises its byte-range shard
    independently; concatenating per-shard outputs in shard order must
    reproduce the whole-file output byte-for-byte."""
    from kmertools_jax.workloads.oligo import OligoComputer

    rng = np.random.default_rng(9)
    path = str(tmp_path / "r.fq")
    _write_fastq(path, rng, 41)
    whole = tmp_path / "whole.kmers"
    OligoComputer(path, str(whole), 4, True).vectorise()

    shards = dataflow.split_file(path, 3)
    parts = []
    for sh in shards:
        # write the shard's records to a temp file (each "host" sees a
        # plain FASTQ slice) and run the standard workload on it
        sub = tmp_path / f"shard{sh.index}.fq"
        with open(sub, "wb") as f:
            raw = open(path, "rb")
            raw.seek(sh.start)
            f.write(raw.read(sh.end - sh.start))
            raw.close()
        out = tmp_path / f"shard{sh.index}.kmers"
        OligoComputer(str(sub), str(out), 4, True).vectorise()
        parts.append(out.read_bytes())
    assert b"".join(parts) == whole.read_bytes()


def test_native_range_batcher_matches_python_shards(tmp_path):
    """kt_batcher_open_range over each shard's byte range must yield
    exactly the records the Python shard reader yields (ids, codes,
    shard-local numbering) — multihost byte parity rides on this."""
    import numpy as np

    from kmertools_jax import native
    from kmertools_jax.io import batch as iob
    from kmertools_jax.parallel import dataflow

    if native.lib() is None:
        import pytest

        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(5)
    p = tmp_path / "mix.fa"
    with open(p, "wb") as f:
        for i in range(300):
            L = int(rng.integers(1, 400))
            seq = rng.choice(list(b"ACGTN"), size=L).astype(np.uint8)
            f.write(b">r%d\n%s\n" % (i, seq.tobytes()))

    def collect(stream):
        out = []
        for b in stream:
            for i in range(len(b.read_idx)):
                r = int(b.read_idx[i])
                if r < 0:
                    continue
                out.append((
                    r, int(b.row_start[i]), b.ids.get(r),
                    b.codes[i, : b.lengths[i]].tobytes(),
                ))
        return sorted(out)

    for shard in dataflow.split_file(str(p), 3):
        want = collect(iob.batch_stream(
            dataflow.shard_sequences(str(p), shard), overlap=4,
        ))
        got = collect(iob.native_batch_stream(
            str(p), overlap=4, byte_range=(shard.start, shard.end),
        ))
        assert got == want, shard
