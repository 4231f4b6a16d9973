"""Per-read histograms: one row of bin counts per read.

The reference accumulates per-read k-mer counts with sequential
scatter-adds into a Vec (composition/src/oligo.rs:240-254). Here the
whole batch is one flat XLA scatter-add over (read, bin) slots, with
invalid positions routed to a sacrificial overflow bin so the scatter
stays dense and unconditional. Counts are exact int32.

On the H100 this form beat a one-hot matrix product (bf16 one-hots,
f32 accumulation) and a Triton-route compare-by-value Pallas kernel at
every batch shape the workloads use, and end to end in the oligo phase
(PERF.md, PR 1); both were removed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("nbins",))
def per_read_histogram_scatter(ids: jnp.ndarray, valid: jnp.ndarray, nbins: int):
    """ids (R, P) int32 in [0, nbins), valid (R, P) bool ->
    (counts int32 (R, nbins), totals int32 (R,))."""
    R, P = ids.shape
    row = nbins + 1
    flat = jnp.where(valid, ids, nbins).astype(jnp.int32)
    flat = flat + jnp.arange(R, dtype=jnp.int32)[:, None] * row
    counts = (
        jnp.zeros((R * row,), jnp.int32).at[flat.reshape(-1)].add(1)
    ).reshape(R, row)
    totals = jnp.sum(valid, axis=1, dtype=jnp.int32)
    return counts[:, :nbins], totals


def per_read_counts(ids, valid, nbins: int, slot_table=None):
    """(counts (R, nbins), totals (R,)) of `ids` — or of
    `slot_table[ids]` when a slot table is given (the dense canonical
    index (4^k,) int32, kmer/src/kmer.rs:54-73 analog)."""
    if slot_table is not None:
        ids = jnp.take(slot_table, jnp.where(valid, ids, 0), mode="clip")
    return per_read_histogram_scatter(ids.astype(jnp.int32), valid, nbins)


@functools.partial(jax.jit, static_argnames=("nbins",))
def per_read_histogram_gathered(
    ids: jnp.ndarray, valid: jnp.ndarray, slot_table: jnp.ndarray, nbins: int
):
    """per_read_counts with the canonical-slot remap, as one program."""
    return per_read_counts(ids, valid, nbins, slot_table)
