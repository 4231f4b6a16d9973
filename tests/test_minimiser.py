"""Minimiser engine: exact-emission tests (kmer/src/minimiser.rs:178-305
ports), golden files, and property tests against a state-machine oracle.

The whole module runs twice: once with the default engine selection
(the native C++ state machine takes simple batches on the CPU test
backend) and once with KMERTOOLS_NO_HETERO pinning the device kernels —
both engines must match the oracle and the goldens."""

import os

import numpy as np
import pytest

from kmertools_jax.utils import codec
from kmertools_jax.utils.fops import load_lines_sorted
from kmertools_jax.workloads import minimisers as wmin


@pytest.fixture(autouse=True, params=["hetero", "device"])
def _engine(request, monkeypatch):
    if request.param == "device":
        monkeypatch.setenv("KMERTOOLS_NO_HETERO", "1")
    return request.param


# ---------------------------------------------------------------- oracle
def oracle_minimisers(seq: bytes, wsize: int, msize: int):
    """Reimplementation of the reference's sequential state machine
    (kmer/src/minimiser.rs:61-175) as a test oracle."""
    U64MAX = (1 << 64) - 1
    out = []
    pos = 0
    buff = []
    buff_pos = 0
    m_active = U64MAX
    m_mask = (1 << (2 * msize)) - 1
    m_shift = 2 * (msize - 1)
    m_val_f = m_val_r = 0
    m_val_l = 0
    m_window_start = 0
    n = len(seq)
    W = wsize - msize + 1
    while pos < n:
        f = int(codec.SEQ_NT4_TABLE[seq[pos]])
        r = f ^ 3
        if f < 4:
            m_val_f = ((m_val_f << 2) | f) & m_mask
            m_val_r = (m_val_r >> 2) | (r << m_shift)
            m_val_l += 1
        else:
            should_return = len(buff) == W
            prev = (m_active, m_window_start, pos)
            buff_pos = 0
            m_active = U64MAX
            m_val_f = m_val_r = 0
            m_val_l = 0
            m_window_start = pos + 1
            buff = []
            pos += 1
            if should_return:
                out.append(prev)
            continue
        if m_val_l < msize:
            pos += 1
            continue
        m_val_l -= 1
        mmin = min(m_val_f, m_val_r)
        if len(buff) == W:
            buff.pop(0)
            buff.append(mmin)
            if buff_pos == 0:
                new_min = U64MAX
                for j, v in enumerate(buff):
                    if v < new_min:
                        buff_pos = j
                        new_min = v
                if new_min != m_active:
                    prev = (m_active, m_window_start, pos)
                    m_active = new_min
                    m_window_start = pos - wsize + 1
                    pos += 1
                    out.append(prev)
                    continue
            elif mmin < m_active:
                prev = (m_active, m_window_start, pos)
                m_active = mmin
                buff_pos = len(buff) - 1
                m_window_start = pos - wsize + 1
                pos += 1
                out.append(prev)
                continue
            else:
                buff_pos -= 1
        else:
            buff.append(mmin)
        if m_active == U64MAX and len(buff) == W:
            for j, v in enumerate(buff):
                if v < m_active:
                    buff_pos = j
                    m_active = v
        if pos == n - 1:
            pos += 1
            out.append((m_active, m_window_start, n))
            continue
        pos += 1
    # mask sentinel values to 2m bits like numeric_to_kmer would print
    mask = (1 << (2 * msize)) - 1
    return [(v & mask, s, e) for v, s, e in out]


def run_framework(seq: str, wsize: int, msize: int, tmp_path):
    fa = tmp_path / "in.fa"
    fa.write_text(f">r\n{seq}\n")
    recs = []

    def emit(ridx, rid, rlen, r):
        vals, starts, ends = r
        recs.extend(
            (int(v), int(a), int(b)) for v, a, b in zip(vals, starts, ends)
        )

    wmin._minimise_stream(str(fa), wsize, msize, emit)
    return recs


# ------------------------------------------------------- reference tests
BLOG_SEQ = (
    "ATGCGATATCGTAGGCGTCGATGGAGAGCTAGATCGATCGATCTAAATCCCGATCGATTC"
    "CGAGCGCGATCAAAGCGCGATAGGCTAGCTAAAGCTAGCA"
)


def test_blog_example(tmp_path):
    """kmer/src/minimiser.rs:183-280: w=31 m=7 emission sequence."""
    recs = run_framework(BLOG_SEQ, 31, 7, tmp_path)
    expected = [
        ("ACGATAT", 0, 36),
        ("ACGCCTA", 7, 43),
        ("AGAGCTA", 13, 51),
        ("AAATCCC", 20, 75),
        ("AATCCCG", 44, 75),  # placeholder, fixed below
    ]
    # verify against the reference's published (kmer, window-string) pairs
    want = [
        ("ACGATAT", "ATGCGATATCGTAGGCGTCGATGGAGAGCTAGATCG"),
        ("ACGCCTA", "TATCGTAGGCGTCGATGGAGAGCTAGATCGATCGAT"),
        ("AGAGCTA", "AGGCGTCGATGGAGAGCTAGATCGATCGATCTAAATCC"),
        ("AAATCCC", "ATGGAGAGCTAGATCGATCGATCTAAATCCCGATCGATTCCGAGCGCGATCAAAG"),
        ("AATCCCG", "AATCCCGATCGATTCCGAGCGCGATCAAAGC"),
        ("AATCGAT", "ATCCCGATCGATTCCGAGCGCGATCAAAGCG"),
        ("AAAGCGC", "TCCCGATCGATTCCGAGCGCGATCAAAGCGCGATAGGCTAGCTAAAGCTAGCA"),
    ]
    assert len(recs) == len(want)
    for (v, s, e), (kstr, wstr) in zip(recs, want):
        assert codec.numeric_to_kmer(v, 7) == kstr
        assert BLOG_SEQ[s:e] == wstr


def test_ambiguous_example(tmp_path):
    """kmer/src/minimiser.rs:283-305: w=8 m=5 with an N."""
    seq = "ATGCGATATCGNTAGGCGTCGATGGA"
    recs = run_framework(seq, 8, 5, tmp_path)
    want = [
        ("ATGCGATA", "ATCGC"),
        ("TGCGATATCG", "ATATC"),
        ("TAGGCGTCGA", "ACGCC"),
        ("GCGTCGATGGA", "ATCGA"),
    ]
    assert len(recs) == len(want)
    for (v, s, e), (wstr, kstr) in zip(recs, want):
        assert seq[s:e] == wstr
        assert codec.numeric_to_kmer(v, 5) == kstr


# --------------------------------------------------------- property tests
@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("wsize,msize", [(8, 5), (31, 7), (12, 7), (10, 9)])
def test_matches_oracle_random(tmp_path, seed, wsize, msize):
    rng = np.random.default_rng(seed * 131 + wsize)
    n = int(rng.integers(5, 250))
    seq = "".join(
        rng.choice(list("ACGTN"), size=n, p=[0.24, 0.24, 0.24, 0.24, 0.04])
    )
    got = run_framework(seq, wsize, msize, tmp_path)
    want = oracle_minimisers(seq.encode(), wsize, msize)
    assert got == want, f"seq={seq}"


@pytest.mark.parametrize("seed", range(4))
def test_matches_oracle_long_split(tmp_path, seed):
    """Reads split across rows must stitch to identical records."""
    rng = np.random.default_rng(seed)
    seq = "".join(
        rng.choice(list("ACGTN"), size=12000, p=[0.248, 0.248, 0.248, 0.248, 0.008])
    )
    got = run_framework(seq, 31, 7, tmp_path)
    want = oracle_minimisers(seq.encode(), 31, 7)
    assert got == want


# ------------------------------------------------------------ golden files
def test_s2m_golden(tmp_path, test_data):
    from kmertools_jax.workloads import common

    before = common.MESH_DISPATCHES
    out = tmp_path / "seq_minimisers"
    wmin.seq_to_min(31, 7, str(test_data / "reads.fq"), str(out))
    assert load_lines_sorted(str(out)) == load_lines_sorted(
        str(test_data / "expected_seq_minimisers")
    )
    # with the device engine pinned, the window-min kernel must have
    # run DP-sharded over the test mesh
    if os.environ.get("KMERTOOLS_NO_HETERO") == "1":
        assert common.MESH_DISPATCHES > before


def test_m2s_golden(tmp_path, test_data):
    from kmertools_jax.workloads import common

    before = common.MESH_DISPATCHES
    out = tmp_path / "minimisers"
    wmin.bin_sequences(0, 10, str(test_data / "reads.fq"), str(out))
    assert load_lines_sorted(str(out)) == load_lines_sorted(
        str(test_data / "expected_minimisers")
    )
    # with the device engine pinned, the whole-read-min kernel must
    # have run DP-sharded over the mesh
    if os.environ.get("KMERTOOLS_NO_HETERO") == "1":
        assert common.MESH_DISPATCHES > before


@pytest.mark.parametrize("seed", range(3))
def test_matches_oracle_mixed_batch(tmp_path, seed):
    """Short (fast-path) and long split (slow-path) reads interleaved in
    one stream must each produce their oracle records."""
    rng = np.random.default_rng(100 + seed)
    reads = []
    for i in range(12):
        n = int(rng.integers(40, 200)) if i % 3 else int(rng.integers(9000, 12000))
        reads.append("".join(
            rng.choice(list("ACGTN"), size=n, p=[0.247, 0.247, 0.247, 0.247, 0.012])
        ))
    fa = tmp_path / "mixed.fa"
    fa.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    per_read = {}

    def emit(ridx, rid, rlen, recs):
        vals, starts, ends = recs
        # the emit contract carries ids as bytes (blob-slice fast path)
        per_read[rid.decode() if isinstance(rid, bytes) else rid] = [
            (int(v), int(a), int(b)) for v, a, b in zip(vals, starts, ends)
        ]

    wmin._minimise_stream(str(fa), 31, 7, emit)
    for i, s in enumerate(reads):
        assert per_read[f"r{i}"] == oracle_minimisers(s.encode(), 31, 7), f"r{i}"


def test_m2s_spill_mode_identical(tmp_path, test_data, monkeypatch):
    """Out-of-core m2s (tiny spill ceiling -> many sorted runs + k-way
    merge) must produce byte-identical output to the in-memory mode."""
    ref = tmp_path / "mem"
    wmin.bin_sequences(20, 10, str(test_data / "reads.fq"), str(ref))
    monkeypatch.setenv("KMERTOOLS_M2S_SPILL_RECORDS", "3")
    out = tmp_path / "spill"
    wmin.bin_sequences(20, 10, str(test_data / "reads.fq"), str(out))
    assert out.read_bytes() == ref.read_bytes()
    assert not list(tmp_path.glob("spill.spill.*"))  # temp runs cleaned

    # and the w=0 golden still holds under spilling
    out2 = tmp_path / "minimisers"
    wmin.bin_sequences(0, 10, str(test_data / "reads.fq"), str(out2))
    assert load_lines_sorted(str(out2)) == load_lines_sorted(
        str(test_data / "expected_minimisers")
    )


def test_m2s_spill_mode_synthetic_many_runs(tmp_path, monkeypatch):
    """Larger synthetic corpus: dozens of runs, groups spanning runs."""
    rng = np.random.default_rng(5)
    reads = [
        "".join(rng.choice(list("ACGT"), size=int(rng.integers(60, 160))))
        for _ in range(40)
    ]
    fa = tmp_path / "many.fa"
    fa.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    ref = tmp_path / "mem"
    wmin.bin_sequences(25, 9, str(fa), str(ref))
    monkeypatch.setenv("KMERTOOLS_M2S_SPILL_RECORDS", "7")
    out = tmp_path / "spill"
    wmin.bin_sequences(25, 9, str(fa), str(out))
    assert out.read_bytes() == ref.read_bytes()


def test_window_records_matches_extract_records():
    """Device-side record extraction (ops/minimiser.py:window_records)
    == the host analysis (extract_records) over random single-row
    batches with ambiguity flushes, ties, short reads, and final-window
    drops."""
    import jax.numpy as jnp

    from kmertools_jax.ops import minimiser as mops

    rng = np.random.default_rng(13)
    for m, wsize in ((3, 5), (7, 31), (17, 31)):
        W = 96
        codes = rng.integers(0, 5, size=(24, W)).astype(np.uint8)
        lengths = rng.integers(1, W + 1, size=24).astype(np.int32)
        col_mask = np.arange(W)[None, :] >= lengths[:, None]
        codes[col_mask] = 4
        keep, hh, ll, lastw = mops.window_records(
            jnp.asarray(codes), jnp.asarray(lengths), m, wsize
        )
        keep = np.asarray(keep)
        hh = np.asarray(hh)
        ll = np.asarray(ll)
        lastw = np.asarray(lastw)
        rr, cc = np.nonzero(keep)
        nlo = min(m, 16)
        vals = ll[rr, cc].astype(np.uint64)
        if hh.shape[1] > 1:  # m > 16 carries a real hi plane
            vals |= hh[rr, cc].astype(np.uint64) << np.uint64(2 * nlo)
        got = list(zip(
            rr.tolist(),
            vals.tolist(),
            cc.tolist(),
            (lastw[rr, cc].astype(np.int64) + wsize).tolist(),
        ))

        # host oracle: the fused-plane + extract_records path
        h, l, v = mops.window_min(jnp.asarray(codes), m, wsize)
        h = np.asarray(h)
        l = np.asarray(l)
        v = np.asarray(v)
        n, Jm = h.shape
        J_row = np.maximum(0, lengths.astype(np.int64) - wsize + 1)
        colv = np.arange(Jm, dtype=np.int64)
        v2 = v & (colv[None, :] < J_row[:, None])
        zu = np.zeros((n, 1), dtype=h.dtype)
        zb = np.zeros((n, 1), dtype=bool)
        fh = np.concatenate([h, zu], axis=1).ravel()
        fl = np.concatenate([l, zu], axis=1).ravel()
        fv = np.concatenate([v2, zb], axis=1).ravel()
        rof, val, s, e = mops.extract_records(
            fh, fl, fv, lengths.astype(np.int64), wsize, m, span=Jm + 1
        )
        want = list(zip(rof.tolist(), val.tolist(), s.tolist(), e.tolist()))
        assert got == want, f"m={m} w={wsize}"


def test_native_scanner_short_only_on_accelerator(monkeypatch):
    """Routing pin: on an accelerator backend whose probed RTT is below
    _COALESCE_RTT_S the native minimiser scanner must still be
    AVAILABLE but flagged short-only — short-read buckets ship ~14x the
    record payload in window-min planes, while contig buckets keep the
    device path. On CPU backends the scanner serves everything."""
    import jax

    from kmertools_jax.workloads import minimisers as mws

    import os

    scan, short_only = mws._native_min_scanner(10, 31)
    if scan is None:
        # NO_HETERO parametrisation or no native runtime: the scanner
        # is correctly absent — nothing to route
        assert (
            os.environ.get("KMERTOOLS_NO_HETERO") == "1"
            or __import__("kmertools_jax.native", fromlist=["lib"]).lib()
            is None
        )
        return
    assert short_only is False  # tests run on the CPU backend

    class _Dev:
        platform = "gpu"
        id = 0

    monkeypatch.setattr(jax, "local_devices", lambda backend=None: [_Dev()])
    scan, short_only = mws._native_min_scanner(10, 31)
    assert scan is not None and short_only is True
    # the width threshold separates 150 bp buckets from contig buckets
    assert 150 < mws._NATIVE_MIN_WIDTH <= 5000
