from kmertools_jax.io.fastx import (
    SeqFormat,
    Sequence,
    SeqStats,
    sequences,
    seq_stats,
    sniff_format,
)
from kmertools_jax.io.batch import Batch, batch_stream

__all__ = [
    "SeqFormat",
    "Sequence",
    "SeqStats",
    "sequences",
    "seq_stats",
    "sniff_format",
    "Batch",
    "batch_stream",
]
