"""Multi-host input distribution (the DCN layer of SURVEY.md section 5).

The reference is single-process: its "input distribution" is N threads
sharing one mutex-guarded file iterator (counter/src/lib.rs:20,119). The
multi-host equivalent is static byte-range sharding: each host owns
a record-aligned slice of the input file, streams it through its local
devices (data-parallel via workloads' shard_map steps), and the
per-host outputs concatenate in shard order. Only host-level metadata
ever crosses the network between hosts.

Alignment rules:
  * FASTA: a shard starts at the next line beginning with '>'.
  * FASTQ: a shard starts at the next '@' header line that is followed
    by a '+' line two lines later (quality lines may begin with '@', so
    a bare '@' test is not enough).
  * gzip inputs are not splittable; callers shard by whole file instead.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from kmertools_jax.io import fastx


@dataclass
class Shard:
    index: int
    start: int  # byte offset, record-aligned
    end: int    # exclusive


def _align_forward(f, pos: int, size: int, is_fastq: bool) -> int:
    """Smallest record start >= pos."""
    if pos == 0:
        return 0
    f.seek(pos)
    f.readline()  # discard the (possibly partial) current line
    while True:
        line_start = f.tell()
        line = f.readline()
        if not line:
            return size
        if not is_fastq:
            if line.startswith(b">"):
                return line_start
            continue
        if line.startswith(b"@"):
            # confirm: two lines later must be the '+' separator
            here = f.tell()
            f.readline()
            plus = f.readline()
            f.seek(here)
            if plus.startswith(b"+"):
                return line_start


def split_file(path: str, n_shards: int) -> list[Shard]:
    """Record-aligned byte ranges covering the file exactly once.

    Raises ValueError for gzip/stdin inputs (not splittable).
    """
    if path == "-" or path.endswith(".gz"):
        raise ValueError("only plain FASTA/FASTQ files are byte-splittable")
    size = os.path.getsize(path)
    fmt = fastx.sniff_format(path)
    with open(path, "rb") as f:
        if fmt is None:
            first = f.read(1)
            f.seek(0)
            fmt = fastx.SeqFormat.FASTA if first == b">" else fastx.SeqFormat.FASTQ
        is_fastq = fmt is fastx.SeqFormat.FASTQ
        bounds = [0]
        for i in range(1, n_shards):
            target = size * i // n_shards
            aligned = _align_forward(f, target, size, is_fastq)
            bounds.append(max(aligned, bounds[-1]))
        bounds.append(size)
    return [
        Shard(index=i, start=bounds[i], end=bounds[i + 1])
        for i in range(n_shards)
    ]


class _RangeRaw:
    """Binary reader over [start, end) of a file."""

    def __init__(self, path: str, start: int, end: int):
        self._f = open(path, "rb")
        self._f.seek(start)
        self._left = end - start

    def read(self, n: int = -1) -> bytes:
        if self._left <= 0:
            return b""
        if n is None or n < 0 or n > self._left:
            n = self._left
        data = self._f.read(n)
        self._left -= len(data)
        return data

    def readline(self) -> bytes:
        if self._left <= 0:
            return b""
        line = self._f.readline(self._left)
        self._left -= len(line)
        return line

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        line = self.readline()
        if not line:
            raise StopIteration
        return line

    def close(self) -> None:
        self._f.close()


def shard_sequences(path: str, shard: Shard):
    """Iterate the Sequence records of one shard (record numbering is
    shard-local; outputs concatenate in shard order)."""
    fmt = fastx.sniff_format(path)
    reader = _RangeRaw(path, shard.start, shard.end)
    if fmt is None:
        fmt = (
            fastx.SeqFormat.FASTA
            if shard.start == 0 and _peek_gt(path)
            else None
        )
    return fastx.sequences(reader, fmt)


def _peek_gt(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(1) == b">"
