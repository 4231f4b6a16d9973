"""Combined k-mer + minimiser scanner (kmer/src/kmer_minimisers.rs:20-211
analog).

The reference's `KmerMinimiserGenerator` yields, per minimiser record,
the canonical window-sized k-mers accumulated since the previous
emission: `(minimiser, window_start, window_end, Vec<Kmer>)`. Its
emission rules are identical to `MinimiserGenerator` (same flush-on-
ambiguity full-buffer condition kmer_minimisers.rs:101 == minimiser.rs:84,
same change/end rules), so records come from the vectorised minimiser
engine and the k-mer lists attach by position:

  a canonical w-mer whose last base sits at index p belongs to the
  first record whose emission position >= p (the reference pushes the
  w-mer completing at `pos` into k_buff before any emission check,
  kmer_minimisers.rs:138-141).

Host-side, per-sequence API (the reference's is a per-slice iterator);
the heavy lifting is vectorised numpy / the jitted window-min kernel.
"""

from __future__ import annotations

import numpy as np

_U64MAX = (1 << 64) - 1


def _encode(seq) -> np.ndarray:
    from kmertools_jax.io.batch import encode_bases

    if isinstance(seq, str):
        seq = seq.encode()
    return encode_bases(seq)


def _trailing_valid(codes: np.ndarray) -> int:
    bad = np.flatnonzero(codes >= 4)
    return len(codes) if len(bad) == 0 else len(codes) - int(bad[-1]) - 1


def sequence_minimiser_records(seq, wsize: int, msize: int):
    """All (minimiser, start, end) records of one sequence, including
    the trailing u64::MAX sentinel (minimiser.rs:61-175 semantics)."""
    import jax.numpy as jnp

    from kmertools_jax.ops import minimiser as mops

    codes = _encode(seq)
    L = len(codes)
    width = max(L, wsize, 8)
    padded = np.full((1, width), 4, dtype=np.uint8)
    padded[0, :L] = codes
    recs: list[tuple[int, int, int]] = []
    J = max(0, L - wsize + 1)
    if J > 0:
        h, l, v = mops.window_min(jnp.asarray(padded), msize, wsize)
        h = np.asarray(h)[0][:J]
        l = np.asarray(l)[0][:J]
        v = np.asarray(v)[0][:J]
        fh = np.concatenate([h, np.zeros(1, np.uint32)])
        fl = np.concatenate([l, np.zeros(1, np.uint32)])
        fv = np.concatenate([v, np.zeros(1, bool)])
        _, val, s0, e0 = mops.extract_records(
            fh, fl, fv, np.array([L], dtype=np.int64), wsize, msize
        )
        recs = [(int(vv), int(ss), int(ee)) for vv, ss, ee in zip(val, s0, e0)]
    trail = _trailing_valid(codes[:L]) if L else 0
    if msize <= trail < wsize:
        recs.append((_U64MAX, L - trail, L))
    return recs


def _canonical_wmers(codes: np.ndarray, w: int):
    """(ends, values): last-base index and canonical value of every
    valid w-mer (2w <= 62 bits fits uint64)."""
    L = len(codes)
    P = L - w + 1
    if P <= 0:
        return np.empty(0, np.int64), np.empty(0, np.uint64)
    c = codes.astype(np.uint64)
    fwd = np.zeros(P, np.uint64)
    rc = np.zeros(P, np.uint64)
    for j in range(w):
        fwd = (fwd << np.uint64(2)) | c[j : j + P]
        rc = (rc << np.uint64(2)) | (np.uint64(3) - c[w - 1 - j : w - 1 - j + P])
    bad = (codes >= 4).astype(np.int64)
    inv = np.concatenate([[0], np.cumsum(bad)])
    valid = (inv[w:] - inv[:P]) == 0
    ends = np.arange(w - 1, L, dtype=np.int64)[valid]
    return ends, np.minimum(fwd, rc)[valid]


def kmer_minimiser_records(seq, wsize: int, msize: int):
    """[(minimiser, start, end, [canonical w-mers]), ...] for one
    sequence — kmer_minimisers.rs `Iterator::next` behaviour."""
    codes = _encode(seq)
    recs = sequence_minimiser_records(seq, wsize, msize)
    ends, wvals = _canonical_wmers(codes, wsize)
    out = []
    # emission position of a record: its exclusive end, except the
    # final-emission record whose end is the sequence length
    emit_pos = np.array([e for (_, _, e) in recs], dtype=np.int64)
    which = np.searchsorted(emit_pos, ends, side="left") if len(recs) else None
    lists: list[list[int]] = [[] for _ in recs]
    if which is not None:
        for idx, val in zip(which, wvals):
            if idx < len(lists):
                lists[int(idx)].append(int(val))
    for (v, s, e), ks in zip(recs, lists):
        out.append((v, s, e, ks))
    return out


class KmerMinimiserGenerator:
    """Iterator mirroring the reference's combined scanner
    (kmer/src/kmer_minimisers.rs:20-211, author-flagged experimental)."""

    def __init__(self, seq, wsize: int, msize: int):
        if wsize < msize:
            raise ValueError("window size must be >= minimiser size")
        self._msize = msize
        self._wsize = wsize
        self._records = kmer_minimiser_records(seq, wsize, msize)
        self._i = 0

    def to_acgt(self, kmer: int, size: int | None = None) -> str:
        from kmertools_jax.utils import codec

        return codec.numeric_to_kmer(kmer, size or self._msize)

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self._records):
            raise StopIteration
        self._i += 1
        return self._records[self._i - 1]
