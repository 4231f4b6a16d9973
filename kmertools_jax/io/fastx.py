"""Streaming FASTA/FASTQ/gzip sequence reader (ktio/src/seq.rs analog).

Behavioural contract:
  * extension-based format detection incl. ``.gz`` (seq.rs:30-41)
  * ``-`` reads stdin (seq.rs:141-155)
  * record ids are the first whitespace token of the header line
  * multi-line FASTA sequences are concatenated
  * `seq_stats` pre-pass counting reads/bases (seq.rs:69-94)

This is the pure-Python fallback; the C++ host extension
(kmertools_jax.io.native) replaces the hot byte loops when built.
"""

from __future__ import annotations

import gzip
import io as _io
import sys
from dataclasses import dataclass
from enum import Enum
from typing import BinaryIO, Iterator


class SeqFormat(Enum):
    FASTA = "fasta"
    FASTQ = "fastq"


@dataclass
class Sequence:
    n: int
    id: str
    seq: bytes


@dataclass
class SeqStats:
    seq_count: int
    total_length: int


def sniff_format(path: str) -> SeqFormat | None:
    """Extension-based detection (ktio/src/seq.rs:30-41)."""
    p = path
    if p.endswith(".gz"):
        p = p[: -len(".gz")]
    if p.endswith((".fq", ".fastq")):
        return SeqFormat.FASTQ
    if p.endswith((".fasta", ".fa", ".fna")):
        return SeqFormat.FASTA
    return None


def get_reader(path: str) -> BinaryIO:
    """file / stdin(-) / gzip reader (ktio/src/seq.rs:141-155)."""
    if path == "-":
        return sys.stdin.buffer
    if path.endswith(".gz"):
        return _io.BufferedReader(gzip.open(path, "rb"), buffer_size=1 << 20)
    return open(path, "rb", buffering=1 << 20)


def sniff_stream_format(reader: BinaryIO) -> tuple[SeqFormat, BinaryIO]:
    """Detect format from the first byte ('>' => FASTA) like
    composition/src/oligo.rs:100-104, returning a rewound stream."""
    first = reader.peek(1)[:1] if hasattr(reader, "peek") else b""
    if not first:
        first = reader.read(1)
        reader = _io.BufferedReader(_ChainedReader(first, reader))
    fmt = SeqFormat.FASTA if first == b">" else SeqFormat.FASTQ
    return fmt, reader


class _ChainedReader(_io.RawIOBase):
    def __init__(self, head: bytes, rest: BinaryIO):
        self._head = head
        self._rest = rest

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        if self._head:
            n = min(len(b), len(self._head))
            b[:n] = self._head[:n]
            self._head = self._head[n:]
            return n
        data = self._rest.read(len(b))
        if not data:
            return 0
        b[: len(data)] = data
        return len(data)


def _fasta_records(reader: BinaryIO) -> Iterator[tuple[str, bytes]]:
    header: bytes | None = None
    chunks: list[bytes] = []
    for line in reader:
        line = line.rstrip(b"\r\n")
        if line.startswith(b">"):
            if header is not None:
                yield header.split(None, 1)[0].decode(), b"".join(chunks)
            header = line[1:]
            chunks = []
        elif header is not None:
            chunks.append(line)
    if header is not None:
        yield header.split(None, 1)[0].decode(), b"".join(chunks)


def _fastq_records(reader: BinaryIO) -> Iterator[tuple[str, bytes]]:
    while True:
        header = reader.readline()
        if not header:
            return
        header = header.rstrip(b"\r\n")
        if not header:
            continue
        seq = reader.readline().rstrip(b"\r\n")
        plus = reader.readline()
        qual = reader.readline()
        if not plus or not qual:
            return
        yield header[1:].split(None, 1)[0].decode(), seq


def sequences(path_or_reader, fmt: SeqFormat | None = None) -> Iterator[Sequence]:
    """Iterate Sequence records from a path or binary stream."""
    if isinstance(path_or_reader, str):
        if fmt is None:
            fmt = sniff_format(path_or_reader)
        reader = get_reader(path_or_reader)
        if fmt is None:
            fmt, reader = sniff_stream_format(reader)
    else:
        reader = path_or_reader
        if fmt is None:
            fmt, reader = sniff_stream_format(reader)
    it = _fasta_records(reader) if fmt is SeqFormat.FASTA else _fastq_records(reader)
    for n, (rid, seq) in enumerate(it):
        yield Sequence(n=n, id=rid, seq=seq)


def seq_stats(path: str, fmt: SeqFormat | None = None) -> SeqStats:
    """Pre-pass over the file counting records and bases (seq.rs:69-94)."""
    if fmt is None and path != "-":
        from kmertools_jax import native

        so = native.lib()
        if so is not None:
            import ctypes

            from kmertools_jax.io.batch import _fmt_hint

            reads = ctypes.c_int64()
            bases = ctypes.c_int64()
            if so.kt_seq_stats(
                path.encode(), reads, bases, _fmt_hint(path)
            ) == 0:
                return SeqStats(seq_count=reads.value, total_length=bases.value)
    count = 0
    total = 0
    for rec in sequences(path, fmt):
        count += 1
        total += len(rec.seq)
    return SeqStats(seq_count=count, total_length=total)
