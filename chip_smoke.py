"""Smoke run of the five workloads on one GPU, checked byte for byte.

    python chip_smoke.py                 # one card: every phase below
    python chip_smoke.py --four-cards    # only ctr k=21 + oligo k=4 on 4 cards

Inputs are generated from --seed (nothing is downloaded): ~500 Mbases of
metagenome-assembly-like contigs (log-normal lengths, 1 kb cutoff, N runs
and soft-masked lowercase), and 150 bp reads at 30x over a 3 Mb genome
with 1% substitutions. Each workload runs through the CLI in this process
(`kmertools_jax.cli.main`) twice: with the device engine pinned
(KMERTOOLS_NO_HETERO=1; the phase fails unless the GPU did the work) and
in the default heterogeneous mode (each sink's share is printed). Output
bytes must equal a plain reference run in CPU-only child processes
(JAX_PLATFORMS=cpu), so this process is the only one on the card. A
`kernels` phase compiles every device kernel at the workloads' real
widths, compares it exactly with a numpy reference and times it.

The card's name and power limit print first; one line per phase follows;
the last stdout line is {"ok": true, "device": {...}} and prints only when
every phase passed. With no GPU the script exits non-zero without a
result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_LOWER = np.frombuffer(b"acgt", dtype=np.uint8)


# ---------------------------------------------------------------------------
# inputs (numpy only; generated in bulk from the seed)
# ---------------------------------------------------------------------------


def contig_lengths(rng, total: int, min_len: int = 1000,
                   mu: float = 8.3, sigma: float = 1.0) -> np.ndarray:
    """Log-normal contig lengths (median ~4 kb) with a `min_len` cutoff,
    summing to ~`total` bases (the last one is trimmed to fit)."""
    out = []
    have = 0
    while have < total:
        ln = np.exp(rng.normal(mu, sigma, 4096)).astype(np.int64)
        ln = ln[ln >= min_len]
        out.append(ln)
        have += int(ln.sum())
    lens = np.concatenate(out)
    cut = int(np.searchsorted(np.cumsum(lens), total)) + 1
    lens = lens[:cut]
    lens[-1] -= int(lens.sum()) - total
    if lens[-1] < min_len:
        lens = lens[:-1]
    return lens


def write_contigs(path: str, total: int, seed: int, with_n: bool = True,
                  wrap: int = 80) -> tuple[int, int]:
    """Multi-line FASTA of log-normal contigs; about 1 in 10 carries an
    N run and 1 in 5 a soft-masked (lowercase) stretch. Returns
    (records, bases)."""
    rng = np.random.default_rng(seed)
    lens = contig_lengths(rng, total)
    codes = rng.integers(0, 4, int(lens.sum()), dtype=np.uint8)
    bases = _ACGT[codes]
    offs = np.concatenate([[0], np.cumsum(lens)])
    with open(path, "wb") as f:
        for i, L in enumerate(lens.tolist()):
            s = bases[offs[i]:offs[i + 1]]
            if rng.random() < 0.2:
                a = int(rng.integers(0, L))
                b = min(L, a + int(rng.integers(50, 2000)))
                s[a:b] = _LOWER[codes[offs[i] + a:offs[i] + b]]
            if with_n and rng.random() < 0.1:
                a = int(rng.integers(0, L))
                s[a:a + int(rng.integers(1, 50))] = ord("N")
            full = L // wrap * wrap
            body = np.concatenate([
                s[:full].reshape(-1, wrap),
                np.full((full // wrap, 1), 10, np.uint8),
            ], axis=1).ravel()
            tail = s[full:].tobytes() + b"\n" if full < L else b""
            f.write(b">contig_%d len=%d\n" % (i, L))
            f.write(body.tobytes() + tail)
    return len(lens), int(lens.sum())


def write_reads(path: str, genome_len: int, coverage: float, read_len: int,
                err: float, seed: int) -> tuple[int, int]:
    """FASTQ of reads drawn uniformly from a random genome, half of them
    reverse-complemented, with `err` substitution errors. Returns
    (records, bases)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    n = int(genome_len * coverage / read_len)
    starts = rng.integers(0, genome_len - read_len + 1, n)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    rc = rng.random(n) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    hit = rng.random(reads.shape) < err
    reads[hit] = (reads[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    head = np.frombuffer(
        b"".join(b"@r%09d\n" % i for i in range(n)), np.uint8
    ).reshape(n, 12)
    rec = np.concatenate([
        head,
        _ACGT[reads],
        np.frombuffer(b"\n+\n", np.uint8)[None, :].repeat(n, 0),
        np.full((n, read_len), ord("I"), np.uint8),
        np.full((n, 1), 10, np.uint8),
    ], axis=1)
    with open(path, "wb") as f:
        f.write(rec.tobytes())
    return n, n * read_len


def head_records(src: str, dst: str, bases: int) -> int:
    """Copy whole FASTA records from `src` until `bases` sequence bytes
    are reached. Returns the bases copied."""
    got = 0
    with open(src, "rb") as fi, open(dst, "wb") as fo:
        for line in fi:
            if line.startswith(b">"):
                if got >= bases:
                    break
            else:
                got += len(line) - 1
            fo.write(line)
    return got


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def same_bytes(a: str, b: str, chunk: int = 1 << 24) -> bool:
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(chunk)
            if x != fb.read(chunk):
                return False
            if not x:
                return True


def same_sorted_lines(a: str, b: str) -> bool:
    """Equal as line multisets: for outputs whose row order the
    reference leaves unspecified (counter rows, m2s groups)."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return sorted(fa.read().splitlines()) == sorted(fb.read().splitlines())


def outputs_match(a: str, b: str, sort_ok: bool) -> bool:
    return same_bytes(a, b) or (sort_ok and same_sorted_lines(a, b))


# ---------------------------------------------------------------------------
# CPU-only reference children
# ---------------------------------------------------------------------------


def _cpu_env() -> dict:
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               KMERTOOLS_QUIET="1")
    env.pop("KMERTOOLS_NO_HETERO", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    return env


def cli_ref(args: list) -> list:
    """argv of a CPU-only CLI run (native engines take the work)."""
    return [sys.executable, "-m", "kmertools_jax", *args]


def oligo_ref(src: str, dst: str, k: int, canonical: bool, norm: bool) -> list:
    """argv of the plain numpy oligo reference (bench.py)."""
    prog = (
        "import sys, bench; "
        "bench._baseline_numpy_impl(sys.argv[1], sys.argv[2], "
        f"k={k}, canonical={canonical}, norm={norm})"
    )
    return [sys.executable, "-c", prog, src, dst]


def run_refs(jobs: dict, parallel: int = 4) -> dict:
    """Run {name: (argv, env)} CPU-only children, `parallel` at a time.
    Returns {name: (rc, seconds, stderr tail)}."""
    todo = list(jobs.items())
    res: dict = {}
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                if not todo:
                    return
                name, (argv, env) = todo.pop(0)
            t0 = time.perf_counter()
            r = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                               text=True, timeout=1500)
            with lock:
                res[name] = (r.returncode, time.perf_counter() - t0,
                             r.stderr[-800:])

    ts = [threading.Thread(target=worker) for _ in range(parallel)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return res


# ---------------------------------------------------------------------------
# device-side bookkeeping
# ---------------------------------------------------------------------------


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, from its
    monitoring events (summed across threads)."""

    _EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        from jax import monitoring

        self.total = 0.0
        self._lock = threading.Lock()
        monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name, secs, **_):
        if name in self._EVENTS:
            with self._lock:
                self.total += secs


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class Phases:
    """Runs named phases; each prints one line. A failed phase is
    recorded and the run goes on; `ok` is False if any failed."""

    def __init__(self, clock: CompileClock):
        self.clock = clock
        self.ok = True
        self.results: list[dict] = []

    def run(self, name: str, fn) -> dict:
        c0 = self.clock.total
        t0 = time.perf_counter()
        rec = {"phase": name}
        try:
            rec.update(fn() or {})
            rec.setdefault("ok", True)
        except Exception as e:  # recorded, printed, and fails the run
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {e}"[:600]
        wall = time.perf_counter() - t0
        comp = self.clock.total - c0
        rec["wall_s"] = round(wall, 3)
        rec["compile_s"] = round(comp, 3)
        # compile_s sums JAX's compile events over every thread, so it
        # can exceed the wall time of a phase that compiles in parallel
        rec["run_s"] = round(max(0.0, wall - comp), 3)
        rec["peak_bytes_in_use"] = peak_bytes()
        self.ok = self.ok and rec["ok"]
        self.results.append(rec)
        print("PHASE " + json.dumps(rec), flush=True)
        return rec


def _env(pinned: bool):
    if pinned:
        os.environ["KMERTOOLS_NO_HETERO"] = "1"
    else:
        os.environ.pop("KMERTOOLS_NO_HETERO", None)


def _cli(args: list) -> None:
    from kmertools_jax.cli import main

    rc = main(args)
    if rc:
        raise RuntimeError(f"CLI returned {rc}: {' '.join(args)}")


def _shares(stats: list) -> dict:
    tot = sum(s["batches"] for s in stats) or 1
    return {
        s["key"]: {"batches": s["batches"],
                   "share": round(s["batches"] / tot, 4)}
        for s in stats
    }


def _device_batches(stats: list) -> int:
    return sum(
        s["batches"] for s in stats
        if ":xla:" in s["key"] or s["key"] == "device"
    )


# ---------------------------------------------------------------------------
# kernels at real widths vs numpy
# ---------------------------------------------------------------------------


def _timed(fn, reps: int = 5):
    """(result, best seconds) of fn() after one warm-up call; every call
    ends in block_until_ready."""
    import jax

    out = jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, best


def _bincount_rows(ids, valid, nbins):
    R = ids.shape[0]
    flat = ids.astype(np.int64) + np.arange(R)[:, None] * nbins
    return np.bincount(flat[valid], minlength=R * nbins).reshape(R, nbins)


def _canon_np(codes: np.ndarray, k: int):
    """Canonical k-mer values (int64) and validity per position."""
    c = codes.astype(np.int64)
    P = codes.shape[1] - k + 1
    fwd = np.zeros((codes.shape[0], P), np.int64)
    rc = np.zeros_like(fwd)
    for j in range(k):
        fwd = fwd * 4 + np.where(c[:, j:j + P] < 4, c[:, j:j + P], 0)
        rc = rc + (3 - np.where(c[:, j:j + P] < 4, c[:, j:j + P], 3)) * 4**j
    bad = np.concatenate(
        [np.zeros((codes.shape[0], 1), np.int64), np.cumsum(codes >= 4, 1)], 1
    )
    valid = (bad[:, k:k + P] - bad[:, :P]) == 0
    return np.minimum(fwd, rc), valid


def _rand_codes(rng, R, W, n_rate=0.002):
    codes = rng.integers(0, 4, (R, W), dtype=np.uint8)
    codes[rng.random((R, W)) < n_rate] = 4
    return codes


def kernel_checks(seed: int) -> dict:
    """Every device kernel of the workloads, compiled at real widths,
    compared exactly with numpy, and timed (best of 5 after warm-up)."""
    import jax
    import jax.numpy as jnp

    from kmertools_jax.io.batch import DEFAULT_TARGET_CODES
    from kmertools_jax.ops import cgr as cgr_ops
    from kmertools_jax.ops import count as cops
    from kmertools_jax.ops import encode, histogram
    from kmertools_jax.ops import minimiser as mops
    from kmertools_jax.utils import codec
    from kmertools_jax.workloads.counter import (
        DeviceAccumulator,
        _default_ctr_target,
    )

    rng = np.random.default_rng(seed)
    out: dict = {}
    bad: list = []

    def check(name, ok):
        if not ok:
            bad.append(name)

    # -- per-read histograms at three batch shapes -----------------------
    shapes = {
        # contig batches (median contig ~4 kb), canonical k=4
        "oligo_k4": (4, "canon", DEFAULT_TARGET_CODES // 4096, 4096),
        # the same batches, raw k=7 (4^7 bins)
        "oligo_k7": (7, "raw", DEFAULT_TARGET_CODES // 4096, 4096),
        # 150 bp reads in the 256-wide bucket, 16 abundance bins
        "cov_bins": (None, "bins", DEFAULT_TARGET_CODES // 256, 256),
    }
    hist_ms: dict = {}
    for name, (k, mode, R, W) in shapes.items():
        if mode == "bins":
            nbins = 16
            raw = rng.integers(0, nbins, (R, W - 14)).astype(np.int32)
            valid = np.arange(W - 14)[None, :] < 136
            valid = np.broadcast_to(valid, raw.shape).copy()
            dense, table = raw, None
        else:
            codes = _rand_codes(rng, R, W)
            fwd, rcv, vj = encode.kmer_ids_small(jnp.asarray(codes), k)
            valid = np.asarray(vj)
            if mode == "canon":
                raw = np.asarray(jnp.minimum(fwd, rcv)).astype(np.int32)
                table = codec.canonical_slot_table(k)
                nbins = codec.kmer_pos_maps(k)[2]
                dense = np.asarray(table)[np.where(valid, raw, 0)]
            else:
                raw = np.asarray(fwd).astype(np.int32)
                table, nbins, dense = None, 4**k, raw
        want = _bincount_rows(dense, valid, nbins)
        d_raw, d_valid = jnp.asarray(raw), jnp.asarray(valid)
        d_table = None if table is None else jnp.asarray(table)
        (c, t), sec = _timed(lambda: histogram.per_read_counts(
            d_raw, d_valid, nbins, d_table))
        check(f"hist:{name}", np.array_equal(
            np.asarray(c).astype(np.int64), want)
            and np.array_equal(np.asarray(t), valid.sum(1)))
        hist_ms[name] = {"shape": [R, int(raw.shape[1])], "nbins": nbins,
                         "ms": round(sec * 1e3, 4)}
    out["histogram"] = hist_ms

    # -- accumulator merge network at the counter's batch size ---------
    tgt = _default_ctr_target()
    C = DeviceAccumulator(21, tgt, n_devices=1).C_dev
    M = tgt + 8 * 8192
    sent = np.uint32(0xFFFFFFFF)
    akeys = np.unique(rng.integers(0, 1 << 42, C // 2, dtype=np.uint64))
    ah = np.full(C, sent, np.uint32)
    al = np.full(C, sent, np.uint32)
    ac = np.zeros(C, np.uint32)
    ah[:len(akeys)] = (akeys >> np.uint64(32)).astype(np.uint32)
    al[:len(akeys)] = (akeys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    ac[:len(akeys)] = rng.integers(1, 50, len(akeys))
    bkeys = np.sort(np.concatenate([
        rng.choice(akeys, M // 4),
        rng.integers(0, 1 << 42, M - M // 4 - 1000, dtype=np.uint64),
    ]))
    bh = np.full(M, sent, np.uint32)
    bl = np.full(M, sent, np.uint32)
    bh[:len(bkeys)] = (bkeys >> np.uint64(32)).astype(np.uint32)
    bl[:len(bkeys)] = (bkeys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    merge = jax.jit(cops.merge_sorted_batch)
    args = [jnp.asarray(x) for x in (ah, al, ac, bh, bl)]
    t0 = time.perf_counter()
    merge.lower(*args).compile()
    out["merge_compile_s"] = round(time.perf_counter() - t0, 3)
    (oh, ol, oc, n), sec = _timed(lambda: merge(*args))
    keys = np.concatenate([akeys, bkeys])
    cnts = np.concatenate([ac[:len(akeys)].astype(np.uint64),
                           np.ones(len(bkeys), np.uint64)])
    uk, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(uk), np.uint64)
    np.add.at(sums, inv, cnts)
    n = int(n)
    got_k = (np.asarray(oh)[:n].astype(np.uint64) << np.uint64(32)) | \
        np.asarray(ol)[:n]
    check("merge", n == len(uk) and np.array_equal(got_k, uk)
          and np.array_equal(np.asarray(oc)[:n].astype(np.uint64), sums))
    out["merge"] = {"C": C, "M": M, "ms": round(sec * 1e3, 4)}

    # -- coverage joins: k=15 table, 150 bp read batch ------------------
    k = 15
    tkeys = np.unique(rng.integers(0, 4**k, 8_000_000, dtype=np.uint64))
    tcnts = rng.integers(1, 200, len(tkeys)).astype(np.int32)
    R, W = DEFAULT_TARGET_CODES // 256, 256
    codes = _rand_codes(rng, R, W)
    qh, ql, qv = encode.canonical_ids_pair(jnp.asarray(codes), k)
    q = (np.asarray(qh).astype(np.uint64) << np.uint64(30)) | \
        np.asarray(ql).astype(np.uint64)
    # half the queries hit the table; invalid (sentinel) positions are
    # masked by the workload's histogram, so they query table keys here
    hit = (rng.random(q.shape) < 0.5) | ~np.asarray(qv)
    q = np.where(hit, rng.choice(tkeys, q.shape), q)
    qh = jnp.asarray((q >> np.uint64(30)).astype(np.uint32))
    ql = jnp.asarray((q & np.uint64((1 << 30) - 1)).astype(np.uint32))
    pos = np.minimum(np.searchsorted(tkeys, q), len(tkeys) - 1)
    want = np.where(tkeys[pos] == q, tcnts[pos], 0)
    joins: dict = {}
    dt = cops.direct_table(tkeys, tcnts, k, 5, 16)
    rows = jnp.asarray(dt[0])
    got, sec = _timed(lambda: cops.lookup_bins_direct(
        qh, ql, rows, k, dt[1], dt[2], dt[3]))
    check("join:direct", np.array_equal(
        np.asarray(got), np.minimum(want // 5, 15)))
    joins["direct_ms"] = round(sec * 1e3, 4)
    blocks3, bboff, p_bits = cops.block_table(tkeys, tcnts, k)
    d_b3, d_bo = jnp.asarray(blocks3), jnp.asarray(bboff)
    got, sec = _timed(lambda: cops.lookup_counts_blocks(
        qh, ql, d_b3, d_bo, k, p_bits, blocks3.shape[1]))
    check("join:blocks", np.array_equal(np.asarray(got), want))
    joins["blocks_ms"] = round(sec * 1e3, 4)
    boff, steps = cops.bucket_offsets(tkeys, k, 18)
    tkl = jnp.asarray(np.stack([
        (tkeys >> np.uint64(30)).astype(np.uint32),
        (tkeys & np.uint64((1 << 30) - 1)).astype(np.uint32)], axis=1))
    d_tc, d_boff = jnp.asarray(tcnts), jnp.asarray(boff)
    got, sec = _timed(lambda: cops.lookup_counts_bucketed(
        qh, ql, tkl, d_tc, d_boff, k, 18, steps))
    check("join:bsearch", np.array_equal(np.asarray(got), want))
    joins["bsearch_ms"] = round(sec * 1e3, 4)
    joins["table_keys"] = int(len(tkeys))
    joins["queries"] = int(q.size)
    out["joins"] = joins

    # -- window minima (m=10, w=31) at read and contig widths -----------
    m, w = 10, 31
    mins: dict = {}
    for label, (R, W) in {"reads": (DEFAULT_TARGET_CODES // 256, 256),
                          "contigs": (DEFAULT_TARGET_CODES // 8192, 8192)
                          }.items():
        codes = _rand_codes(rng, R, W)
        cv, cvalid = _canon_np(codes, m)
        big = np.int64(0xFFFFFFFF)
        vals = np.where(cvalid, cv, big)
        nw = w - m + 1
        win = np.lib.stride_tricks.sliding_window_view(vals, nw, axis=1)
        wmin = win.min(-1)
        wok = np.lib.stride_tricks.sliding_window_view(
            cvalid, nw, axis=1).all(-1)
        want = np.where(wok, wmin, big).astype(np.uint32)
        d_codes = jnp.asarray(codes)
        got, sec = _timed(lambda: mops.window_min_fused(d_codes, m, w))
        check(f"winmin:{label}", np.array_equal(np.asarray(got), want))
        mins[f"{label}_fused_ms"] = round(sec * 1e3, 4)
        lengths = np.full(R, W, np.int32)
        (keep, _, lo, lastw), sec = _timed(lambda: mops.window_records(
            d_codes, jnp.asarray(lengths), m, w))
        keep = np.asarray(keep)
        rr, cc = np.nonzero(keep)
        J = want.shape[1]
        fv = np.concatenate([want != 0xFFFFFFFF, np.zeros((R, 1), bool)], 1)
        fl = np.concatenate([want, np.zeros((R, 1), np.uint32)], 1)
        rof, val, s, e = mops.extract_records(
            np.zeros(R * (J + 1), np.uint32), fl.ravel(), fv.ravel(),
            lengths.astype(np.int64), w, m, span=J + 1)
        got_recs = (rr.astype(np.int64),
                    np.asarray(lo)[rr, cc].astype(np.uint64),
                    cc.astype(np.int64),
                    np.asarray(lastw)[rr, cc].astype(np.int64) + w)
        want_recs = (np.asarray(rof, np.int64), np.asarray(val, np.uint64),
                     np.asarray(s, np.int64), np.asarray(e, np.int64))
        og = np.lexsort((got_recs[2], got_recs[0]))
        ow = np.lexsort((want_recs[2], want_recs[0]))
        check(f"records:{label}", all(
            np.array_equal(a[og], b[ow])
            for a, b in zip(got_recs, want_recs)))
        mins[f"{label}_records_ms"] = round(sec * 1e3, 4)
    out["minimiser"] = mins

    # -- CGR scan, f64, bit-exact vs the host walk -----------------------
    # the CGR workload's own probe: enables x64 (as the CLI does) and
    # runs a short scan on the device against the host oracle
    from kmertools_jax.workloads import cgr as cgr_mod

    out["cgr_f64_probe_exact"] = bool(cgr_mod._f64_supported())
    check("cgr_f64_probe", out["cgr_f64_probe_exact"])
    R, W = 64, 8192
    codes = rng.integers(0, 4, (R, W), dtype=np.uint8)
    (xs, ys), sec = _timed(
        lambda: cgr_ops.cgr_scan(jnp.asarray(codes), 1.0, jnp.float64))
    cx = np.array([0.0, 0.0, 1.0, 1.0])
    cy = np.array([0.0, 1.0, 1.0, 0.0])
    hx = np.full(R, 0.5)
    hy = np.full(R, 0.5)
    wx = np.empty((R, W))
    wy = np.empty((R, W))
    for t in range(W):
        hx = (hx + cx[codes[:, t]]) / 2.0
        hy = (hy + cy[codes[:, t]]) / 2.0
        wx[:, t] = hx
        wy[:, t] = hy
    check("cgr_scan", np.array_equal(np.asarray(xs), wx)
          and np.array_equal(np.asarray(ys), wy))
    out["cgr_scan_ms"] = round(sec * 1e3, 4)
    out["ok"] = not bad
    if bad:
        out["mismatch"] = bad
    return out


# ---------------------------------------------------------------------------
# the one-card run
# ---------------------------------------------------------------------------


def one_card(args, work: str, phases: Phases) -> None:
    import jax

    from kmertools_jax.workloads import cgr as cgr_mod
    from kmertools_jax.workloads import common, counter, minimisers
    from kmertools_jax.workloads.common import (
        _COALESCE_RTT_S,
        probe_device_rtt,
    )

    P = lambda *a: os.path.join(work, *a)  # noqa: E731
    t0 = time.perf_counter()
    n_ctg, b_ctg = write_contigs(P("contigs.fa"), args.contig_mb * 10**6,
                                 args.seed)
    b_slice = head_records(P("contigs.fa"), P("slice.fa"),
                           args.slice_mb * 10**6)
    n_cgr, b_cgr = write_contigs(P("cgr.fa"), args.cgr_mb * 10**6,
                                 args.seed + 1, with_n=False)
    n_rd, b_rd = write_reads(P("reads.fq"), args.genome_mb * 10**6,
                             args.coverage, 150, 0.01, args.seed + 2)
    print(f"inputs: contigs {n_ctg} records {b_ctg} bases; slice "
          f"{b_slice} bases (oligo k=7 and min on contigs); cgr {n_cgr} "
          f"records {b_cgr} bases; reads {n_rd} x 150 bp = {b_rd} bases "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    env = _cpu_env()
    ref = lambda *a: os.path.join(work, "ref", *a)  # noqa: E731
    os.makedirs(ref(), exist_ok=True)
    jobs = {
        "oligo_k4": (oligo_ref(P("contigs.fa"), ref("oligo_k4"), 4, True,
                               True), env),
        "oligo_k7": (oligo_ref(P("slice.fa"), ref("oligo_k7"), 7, False,
                               False), env),
        "ctr": (cli_ref(["ctr", "-i", P("reads.fq"), "-o", ref("ctr"),
                         "-k", "21"]), env),
        "cov": (cli_ref(["cov", "-i", P("reads.fq"), "-o", ref("cov"),
                         "-k", "15", "--bin-size", "5", "--bin-count",
                         "16"]), env),
        "cgr": (cli_ref(["comp", "cgr", "-i", P("cgr.fa"), "-o",
                         ref("cgr")]), dict(env, KMERTOOLS_NO_X64="1")),
    }
    for src in ("reads", "slice"):
        inp = P("reads.fq" if src == "reads" else "slice.fa")
        for mode in ("s2m", "m2s"):
            jobs[f"min_{mode}_{src}"] = (cli_ref(
                ["min", "-i", inp, "-o", ref(f"min_{mode}_{src}"), "-m", "10",
                 "-w", "31", "-p", mode]), env)
    refs: dict = {}
    ref_thread = threading.Thread(
        target=lambda: refs.update(run_refs(jobs)), daemon=True)
    ref_thread.start()

    # device-only kernel checks overlap the CPU references
    phases.run("kernels", lambda: kernel_checks(args.seed))
    ref_thread.join()
    print("references: " + json.dumps(
        {k: {"rc": v[0], "s": round(v[1], 1)} for k, v in refs.items()}),
        flush=True)
    for name, (rc, _, err) in refs.items():
        if rc:
            print(f"reference {name} failed: {err}", file=sys.stderr)

    def ref_ok(name):
        if refs.get(name, (1,))[0]:
            raise RuntimeError(f"reference {name} failed")

    dev0 = jax.devices()[0]
    rtt = probe_device_rtt(dev0)
    print(f"device_rtt_s {rtt:.6f} coalesce_rtt_s {_COALESCE_RTT_S} "
          f"({'below' if rtt <= _COALESCE_RTT_S else 'ABOVE'})", flush=True)

    def oligo(tag, k_args, src, refname, pinned):
        def fn():
            ref_ok(refname)
            _env(pinned)
            o = P(f"{tag}.{'pin' if pinned else 'het'}")
            _cli(["comp", "oligo", "-i", src, "-o", o, *k_args])
            st = [dict(s) for s in common.LAST_RUN_STATS]
            rec = {"match": same_bytes(o, ref(refname)),
                   "sinks": _shares(st)}
            rec["ok"] = rec["match"] and (not pinned or _device_batches(st) > 0)
            return rec
        return fn

    def ctr(pinned):
        def fn():
            ref_ok("ctr")
            _env(pinned)
            o = P(f"ctr.{'pin' if pinned else 'het'}")
            _cli(["ctr", "-i", P("reads.fq"), "-o", o, "-k", "21"])
            st = [dict(s) for s in counter.LAST_SINK_STATS]
            rec = {"match": outputs_match(os.path.join(o, "kmers.counts"),
                                          ref("ctr", "kmers.counts"), True),
                   "sinks": _shares(st)}
            rec["ok"] = rec["match"] and (not pinned or _device_batches(st) > 0)
            return rec
        return fn

    def cov(pinned):
        def fn():
            ref_ok("cov")
            _env(pinned)
            o = P(f"cov.{'pin' if pinned else 'het'}")
            _cli(["cov", "-i", P("reads.fq"), "-o", o, "-k", "15",
                  "--bin-size", "5", "--bin-count", "16"])
            st = [dict(s) for s in common.LAST_RUN_STATS]
            rec = {"match": same_bytes(os.path.join(o, "kmers.vectors"),
                                       ref("cov", "kmers.vectors")),
                   "sinks": _shares(st)}
            rec["ok"] = rec["match"] and (not pinned or _device_batches(st) > 0)
            return rec
        return fn

    def mins(mode, src, pinned):
        def fn():
            name = f"min_{mode}_{src}"
            ref_ok(name)
            _env(pinned)
            inp = P("reads.fq" if src == "reads" else "slice.fa")
            o = P(f"{name}.{'pin' if pinned else 'het'}")
            k0 = minimisers.DEVICE_KERNEL_RUNS
            e0 = minimisers.DEVICE_EXTRACT_RUNS
            _cli(["min", "-i", inp, "-o", o, "-m", "10", "-w", "31",
                  "-p", mode])
            rec = {"match": outputs_match(o, ref(name), mode == "m2s"),
                   "device_window_runs": minimisers.DEVICE_KERNEL_RUNS - k0,
                   "device_extract_runs": minimisers.DEVICE_EXTRACT_RUNS - e0}
            dev = rec["device_window_runs"] + rec["device_extract_runs"]
            rec["ok"] = rec["match"] and (not pinned or dev > 0)
            return rec
        return fn

    def cgr(pinned):
        def fn():
            ref_ok("cgr")
            _env(pinned)
            o = P(f"cgr.{'pin' if pinned else 'het'}")
            r0 = cgr_mod.DEVICE_SCAN_RUNS
            _cli(["comp", "cgr", "-i", P("cgr.fa"), "-o", o])
            rec = {"match": same_bytes(o, ref("cgr")),
                   "f64_exact_on_device": bool(cgr_mod._f64_supported()),
                   "device_scan_runs": cgr_mod.DEVICE_SCAN_RUNS - r0}
            rec["ok"] = rec["match"] and rec["device_scan_runs"] > 0
            return rec
        return fn

    def api():
        import pykmertools

        with open(P("reads.fq"), "rb") as f:
            seqs = [ln.rstrip(b"\n").decode()
                    for i, ln in enumerate(f) if i % 4 == 1][:args.api_reads]
        b0 = pykmertools.DEVICE_BATCHES
        got = pykmertools.OligoComputer(4).vectorise_batch(seqs)
        from kmertools_jax.io.batch import encode_bases
        from kmertools_jax.utils.codec import canonical_slot_table

        table = canonical_slot_table(4).astype(np.int64)
        codes = np.stack([encode_bases(s.encode()) for s in seqs])
        cv = np.zeros((len(seqs), 147), np.int64)
        for j in range(4):
            cv = cv * 4 + codes[:, j:j + 147].astype(np.int64)
        counts = _bincount_rows(table[cv], np.ones_like(cv, bool), 136)
        want = counts / np.maximum(1, 147)
        match = np.array_equal(np.asarray(got), want)
        return {"reads": len(seqs), "match": match,
                "device_batches": pykmertools.DEVICE_BATCHES - b0,
                "ok": match and pykmertools.DEVICE_BATCHES > b0}

    for pinned in (True, False):
        mode = "pinned" if pinned else "hetero"
        phases.run(f"oligo_k4.{mode}",
                   oligo("oligo_k4", ["-k", "4"], P("contigs.fa"),
                         "oligo_k4", pinned))
        phases.run(f"oligo_k7.{mode}",
                   oligo("oligo_k7", ["-k", "7", "-r", "-c"], P("slice.fa"),
                         "oligo_k7", pinned))
        phases.run(f"ctr.{mode}", ctr(pinned))
        phases.run(f"cov.{mode}", cov(pinned))
        for src in ("reads", "slice"):
            for m in ("s2m", "m2s"):
                phases.run(f"min_{m}_{src}.{mode}", mins(m, src, pinned))
        phases.run(f"cgr.{mode}", cgr(pinned))
    _env(True)
    phases.run("api.pinned", api)
    _env(False)


# ---------------------------------------------------------------------------
# four cards: mesh paths vs one card, same process
# ---------------------------------------------------------------------------


def four_cards(args, work: str, phases: Phases) -> None:
    import jax

    from kmertools_jax.workloads import common
    from kmertools_jax.workloads.counter import CountComputer
    from kmertools_jax.workloads.oligo import OligoComputer

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX sees "
                         f"{len(jax.devices())}")
    P = lambda *a: os.path.join(work, *a)  # noqa: E731
    write_contigs(P("contigs.fa"), args.contig_mb * 10**6, args.seed)
    write_reads(P("reads.fq"), args.genome_mb * 10**6, args.coverage, 150,
                0.01, args.seed + 2)
    _env(True)  # device engines only: the mesh does the work

    def ctr(ndev):
        def fn():
            o = P(f"ctr.{ndev}")
            os.makedirs(o, exist_ok=True)
            c = CountComputer(P("reads.fq"), o, 21)
            c.n_devices = ndev
            c.count_and_merge(True)
            return {"used_mesh": c.used_mesh, "ok": c.used_mesh == (ndev > 1)}
        return fn

    def oligo(ndev):
        def fn():
            m0 = common.MESH_DISPATCHES
            c = OligoComputer(P("contigs.fa"), P(f"oligo.{ndev}"), 4)
            c.n_devices = ndev
            c.vectorise()
            mesh = common.MESH_DISPATCHES - m0
            return {"mesh_dispatches": mesh, "ok": (mesh > 0) == (ndev > 1)}
        return fn

    for name, fn in (("ctr_k21", ctr), ("oligo_k4", oligo)):
        phases.run(f"{name}.4cards", fn(4))
        phases.run(f"{name}.1card", fn(1))
    phases.run("compare", lambda: {
        "ctr_k21": outputs_match(P("ctr.4", "kmers.counts"),
                                 P("ctr.1", "kmers.counts"), True),
        "oligo_k4": same_bytes(P("oligo.4"), P("oligo.1")),
        "ok": outputs_match(P("ctr.4", "kmers.counts"),
                            P("ctr.1", "kmers.counts"), True)
        and same_bytes(P("oligo.4"), P("oligo.1")),
    })


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only ctr k=21 and oligo k=4 over 4 cards "
                         "against a 1-card run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--contig-mb", type=int, default=500)
    ap.add_argument("--slice-mb", type=int, default=20)
    ap.add_argument("--cgr-mb", type=int, default=10)
    ap.add_argument("--genome-mb", type=int, default=3)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--api-reads", type=int, default=100_000)
    ap.add_argument("--work", default=os.path.join(REPO, ".smoke"),
                    help="scratch directory (removed at the end)")
    args = ap.parse_args(argv)

    from kmertools_jax.utils.device import card_facts

    print(f"card: {card_facts()}", flush=True)
    import jax

    print(f"jax {jax.__version__}", flush=True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's default backend is {dev.platform}",
              file=sys.stderr)
        return 1
    print(f"device_kind {dev.device_kind} count {len(jax.devices())}",
          flush=True)

    os.environ.setdefault("KMERTOOLS_QUIET", "1")
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work)
    phases = Phases(CompileClock())
    try:
        if args.four_cards:
            four_cards(args, args.work, phases)
        else:
            one_card(args, args.work, phases)
    finally:
        shutil.rmtree(args.work, ignore_errors=True)
    if not phases.ok:
        print("FAILED: " + ", ".join(
            r["phase"] for r in phases.results if not r["ok"]),
            file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
