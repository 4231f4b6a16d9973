"""Pykmertools: drop-in Python API compatible with the reference's PyO3
module (pybindings/pykmertools.pyi:1-244), backed by the JAX
kmertools_jax kernels.

Modules:
    OligoComputer      - oligonucleotide frequency vectors
    CgrComputer        - chaos game representations
    KmerGenerator      - (forward, reverse) numeric k-mer iterator
    MinimiserGenerator - (kmer, start, end) minimiser iterator
    utils              - numeric <-> ACGT codecs
    run_cli            - console entry point (pip/src/lib.rs:11-18)
"""

from __future__ import annotations

import numpy as np

from kmertools_jax.io.batch import encode_bases
from kmertools_jax.utils import codec
from pykmertools import utils

__all__ = [
    "CgrComputer",
    "KmerGenerator",
    "MinimiserGenerator",
    "OligoComputer",
    "utils",
    "run_cli",
]

_U64MAX = (1 << 64) - 1

# OligoComputer batches histogrammed on the JAX device path this process
# (observability: the native host kernel takes them on CPU-only backends)
DEVICE_BATCHES = 0


def _pad_codes(seq: str | bytes, width: int | None = None) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode()
    arr = encode_bases(seq)
    w = max(8, width or len(arr))
    out = np.full((1, w), 4, dtype=np.uint8)
    out[0, : len(arr)] = arr
    return out


class KmerGenerator:
    """(forward, reverse) k-mer iterator (pybindings/src/kmer.rs:7-42)."""

    def __init__(self, seq: str, ksize: int):
        self._seq = seq
        self._ksize = ksize
        s = seq.encode() if isinstance(seq, str) else seq
        codes = encode_bases(s).astype(np.int64)
        P = max(0, len(codes) - ksize + 1)
        if P > 0:
            fwd = np.zeros(P, dtype=np.uint64)
            rc = np.zeros(P, dtype=np.uint64)
            for j in range(ksize):
                c = codes[j : j + P].astype(np.uint64)
                fwd = fwd * np.uint64(4) + c
                c2 = codes[ksize - 1 - j : ksize - 1 - j + P].astype(np.uint64)
                rc = rc * np.uint64(4) + (np.uint64(3) - c2)
            bad = codes >= 4
            inv = np.concatenate([[0], np.cumsum(bad)])
            valid = (inv[ksize:] - inv[:-ksize]) == 0
            self._pairs = [
                (int(f), int(r)) for f, r, v in zip(fwd, rc, valid) if v
            ]
        else:
            self._pairs = []
        self._i = 0

    def kmer_pos_maps(self):
        pos_map, pos_kmer, count = codec.kmer_pos_maps(self._ksize)
        return list(int(x) for x in pos_map), dict(pos_kmer), count

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self._pairs):
            raise StopIteration
        self._i += 1
        return self._pairs[self._i - 1]


class MinimiserGenerator:
    """(kmer, start, end) minimiser iterator (pybindings/src/min.rs:7-48).

    Sentinel emissions (reference m_active == u64::MAX for a trailing
    segment shorter than the window) yield 2^64-1, exactly like the
    PyO3 binding returns the raw u64.
    """

    def __init__(self, seq: str, wsize: int, msize: int):
        if wsize < msize:
            raise ValueError("window size must be >= minimiser size")
        self._msize = msize
        s = seq.encode() if isinstance(seq, str) else seq
        self._records = _minimiser_records(s, wsize, msize)
        self._i = 0

    def to_acgt(self, mmer: int) -> str:
        return codec.numeric_to_kmer(mmer, self._msize)

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self._records):
            raise StopIteration
        self._i += 1
        return self._records[self._i - 1]


def _minimiser_records(seq: bytes, wsize: int, msize: int):
    from kmertools_jax.ops.kmer_minimiser import sequence_minimiser_records

    return sequence_minimiser_records(seq, wsize, msize)


class OligoComputer:
    """Oligo frequency vectors (pybindings/src/oligo.rs:7-100).

    Reproduces the binding's quirk: in non-canonical mode (mins=False)
    the normalisation total is incremented by 2 per k-mer
    (pybindings/src/oligo.rs:61), unlike the CLI kernel's 1
    (composition/src/oligo.rs:250).
    """

    def __init__(self, k: int):
        # arg named `k` per the reference stub (pykmertools.pyi:178)
        self._ksize = k
        self._pos_map, self._pos_kmer, self._kcount = codec.kmer_pos_maps(k)

    def vectorise_one(self, seq: str, norm: bool = True, mins: bool = True):
        return self.vectorise_batch([seq], norm, mins)[0]

    def vectorise_batch(self, seqs, norm: bool = True, mins: bool = True):
        k = self._ksize
        nbins = self._kcount if mins else 4**k
        width = max(max((len(s) for s in seqs), default=8), 8)
        width = (width + 127) // 128 * 128
        codes = np.full((len(seqs), width), 4, dtype=np.uint8)
        for i, s in enumerate(seqs):
            b = s.encode() if isinstance(s, str) else s
            codes[i, : len(b)] = encode_bases(b)
        native_ct = self._native_counts(codes, width, nbins, mins)
        if native_ct is not None:
            counts, totals = native_ct
            return self._postprocess(counts, totals, norm, mins)
        import jax.numpy as jnp

        from kmertools_jax.ops import encode, histogram

        global DEVICE_BATCHES
        DEVICE_BATCHES += 1
        fwd, rc, valid = encode.kmer_ids_small(jnp.asarray(codes), k)
        ids = jnp.minimum(fwd, rc) if mins else fwd
        slot_table = (
            jnp.asarray(codec.canonical_slot_table(k)) if mins else None
        )
        counts, totals = histogram.per_read_counts(
            ids, valid, nbins, slot_table
        )
        return self._postprocess(counts, totals, norm, mins)

    def _native_counts(self, codes, width, nbins, mins):
        """Per-read counts via the native host kernel (kt_oligo_hist)
        when the C++ engine should run the batch: CPU-only backend,
        native runtime present, hetero not disabled, k and width inside
        the kernel's int16/table bounds. Bit-equal to the device paths
        (tests/test_native_hist.py)."""
        import ctypes
        import os

        import jax

        from kmertools_jax import native

        k = self._ksize
        if (
            k > 7
            or width > 8192  # counts must fit int16
            or os.environ.get("KMERTOOLS_NO_HETERO") == "1"
        ):
            return None
        so = native.lib()
        if so is None:
            return None
        devs = jax.local_devices()
        if not devs or devs[0].platform != "cpu":
            return None
        from kmertools_jax.io.batch import pack_planes

        packed, vb, _ = pack_planes(
            codes, np.full(codes.shape[0], width, np.int32)
        )
        table = (
            np.ascontiguousarray(codec.canonical_slot_table(k), np.int32)
            if mins
            else None
        )
        R = codes.shape[0]
        counts = np.empty((R, nbins), np.int16)
        totals = np.empty((R,), np.int32)
        rc = so.kt_oligo_hist(
            np.ascontiguousarray(packed).ctypes.data_as(native.c_u8_p),
            np.ascontiguousarray(vb).ctypes.data_as(native.c_u8_p),
            R, width, k,
            table.ctypes.data_as(native.c_i32_p) if table is not None else None,
            nbins,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            totals.ctypes.data_as(native.c_i32_p),
            os.cpu_count() or 1, nbins,
        )
        if rc != 0:
            return None
        return counts, totals

    @staticmethod
    def _postprocess(counts, totals, norm, mins):
        counts = np.asarray(counts).astype(np.float64)
        totals = np.asarray(totals).astype(np.float64)
        if not mins:
            totals = totals * 2.0  # binding quirk, oligo.rs:61
        if norm:
            counts /= np.maximum(1.0, totals)[:, None]
        return [list(map(float, row)) for row in counts]

    def get_header(self, mins: bool = True):
        if mins:
            return [
                codec.numeric_to_kmer(self._pos_kmer[i], self._ksize)
                for i in range(self._kcount)
            ]
        return [codec.numeric_to_kmer(v, self._ksize) for v in range(4**self._ksize)]


class CgrComputer:
    """Chaos game representations (pybindings/src/cgr.rs)."""

    def __init__(self, vecsize: int):
        self._vecsize = float(vecsize)
        s = self._vecsize
        self._cx = np.array([0.0, 0.0, s, s], dtype=np.float64)
        self._cy = np.array([0.0, s, s, 0.0], dtype=np.float64)

    def vectorise_one(self, seq: str):
        b = seq.encode() if isinstance(seq, str) else seq
        codes = encode_bases(b)
        if (codes >= 4).any():
            raise ValueError("Bad nucleotide, unable to proceed")
        x = y = self._vecsize / 2.0
        out = []
        for c in codes:
            x = (x + self._cx[c]) / 2.0
            y = (y + self._cy[c]) / 2.0
            out.append((x, y))
        return out

    # padded-area cap per column-walk chunk (elements of one f64 work
    # array, ~512 MB x3): one long contig among short reads must not
    # inflate the whole batch's padding
    _WALK_AREA = 1 << 26

    def vectorise_batch(self, seqs):
        """Batch CGR (pybindings/src/cgr.rs vectorise_batch: rayon over
        seqs). Vectorised as a numpy column walk — sequential over
        positions, vectorised over reads; x=(x+cx)/2 is elementwise, so
        every point is IEEE-identical to vectorise_one's scalar loop
        (padding past a read's length cannot affect its prefix).
        Sequences process in length-sorted chunks of bounded padded
        area, so mixed corpora (contigs + short reads) never allocate
        R x max_len work arrays."""
        if len(seqs) < 8:  # tiny batches: the scalar loop wins
            return [self.vectorise_one(s) for s in seqs]
        bs = [s.encode() if isinstance(s, str) else s for s in seqs]
        lens = np.array([len(b) for b in bs], dtype=np.int64)
        R = len(bs)
        order = np.argsort(lens, kind="stable")
        results: list = [None] * R
        half = self._vecsize / 2.0
        cx, cy = self._cx, self._cy
        i = 0
        while i < R:
            # grow the chunk while its padded area stays bounded
            j = i + 1
            wmax = int(lens[order[i]])
            while j < R:
                w2 = max(wmax, int(lens[order[j]]))
                if (j - i + 1) * w2 > self._WALK_AREA:
                    break
                wmax = w2
                j += 1
            idx = order[i:j]
            n = len(idx)
            W = max(wmax, 1)
            codes = np.zeros((n, W), np.uint8)
            for t, g in enumerate(idx):
                c = encode_bases(bs[g])
                if (c >= 4).any():
                    raise ValueError("Bad nucleotide, unable to proceed")
                codes[t, : len(c)] = c
            xs = np.empty((n, W))
            ys = np.empty((n, W))
            x = np.full(n, half)
            y = np.full(n, half)
            for col_j in range(W):
                col = codes[:, col_j]
                x = (x + cx[col]) / 2.0
                y = (y + cy[col]) / 2.0
                xs[:, col_j] = x
                ys[:, col_j] = y
            for t, g in enumerate(idx):
                L = int(lens[g])
                results[g] = list(
                    zip(xs[t, :L].tolist(), ys[t, :L].tolist())
                )
            i = j
        return results


def run_cli(argv=None) -> int:
    """Console entry point, mirroring pip/src/lib.rs:11-18."""
    from kmertools_jax.cli import main

    return main(argv)
