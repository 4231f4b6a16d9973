"""Benchmark harness.

Headline: end-to-end oligo k=4 vectorisation throughput (bases/s),
FASTA file -> normalised vector file, on the GPU. With no GPU the bench
exits non-zero; it never measures the CPU in the GPU's place.

Corpus: contig-scale sequences (5 kb), the primary metagenomics use
case for composition vectors (binning assembled contigs). Contig reads
also make the measurement meaningful: per-read text output amortises
to ~0.25 B/base, so the recorded rate reflects parse + encode +
histogram throughput instead of the output disk's sequential write
speed (which a short-read corpus degenerates to — both sides just wait
on the same disk).

Baseline: the reference publishes no numbers (BASELINE.md) and its Rust
toolchain is unavailable here, so the recorded baseline is an optimised
single-process numpy implementation of the same workload measured on
this host (a stand-in for the Rust CLI; see BASELINE.md for the
methodology note). vs_baseline = ours / numpy-host.

Robustness: the persistent compile cache is enabled by
kmertools_jax/__init__; an untimed warmup run compiles + populates it
before any measurement, and both sides take best-of-N so one disk
hiccup doesn't decide the headline.

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", ...}.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# 480k x 5 kb = 2.4 Gbases: large enough that the headline measures
# steady-state throughput rather than the pipeline's start and tail
N_READS = int(os.environ.get("BENCH_READS", 480_000))
READ_LEN = int(os.environ.get("BENCH_READ_LEN", 5_000))
REPEATS = int(os.environ.get("BENCH_REPEATS", 4))
NUMPY_REPEATS = int(os.environ.get("BENCH_NUMPY_REPEATS", 2))
K = 4


def first_touch_gbps() -> float:
    """Fresh-page first-touch bandwidth probe (GB/s): one byte per 4 KB
    page of a fresh 32 MB MAP_PRIVATE anonymous map. This host's fault
    cost drifts 0.2-4.5 GB/s hour-to-hour (CLAUDE.md); recording it per
    timed run lets a reader tell a degraded-host phase from a real
    regression in the captured numbers."""
    import mmap

    sz = 32 << 20
    m = mmap.mmap(-1, sz, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    try:
        t0 = time.perf_counter()
        for off in range(0, sz, 4096):
            m[off] = 1
        return round(sz / (time.perf_counter() - t0) / 1e9, 2)
    finally:
        m.close()


def make_corpus(path: str) -> int:
    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    total = 0
    with open(path, "wb") as f:
        chunk = 2_000
        for start in range(0, N_READS, chunk):
            n = min(chunk, N_READS - start)
            seqs = bases[rng.integers(0, 4, size=(n, READ_LEN))]
            blocks = []
            for i in range(n):
                blocks.append(b">c%d\n%s\n" % (start + i, seqs[i].tobytes()))
            f.write(b"".join(blocks))
            total += n * READ_LEN
    return total


def baseline_numpy(in_path: str, out_path: str) -> float:
    """Single-process numpy oligo k=4: the host-CPU stand-in baseline.

    Runs with KMERTOOLS_NO_NATIVE so it measures the numpy/Python
    implementation — the shared parser/formatter modules otherwise pick
    up this framework's C++ fast paths and the baseline stops being a
    baseline."""
    os.environ["KMERTOOLS_NO_NATIVE"] = "1"
    try:
        return _baseline_numpy_impl(in_path, out_path)
    finally:
        os.environ.pop("KMERTOOLS_NO_NATIVE", None)


def _baseline_numpy_impl(in_path: str, out_path: str, k: int = K,
                         canonical: bool = True, norm: bool = True) -> float:
    """Plain numpy oligo vectoriser: canonical (or raw forward) k-mer
    counts per record, normalised to ``{:.6}`` frequencies or written
    as raw counts. The in-repo reference for `comp oligo` output bytes.
    Returns its wall seconds."""
    from kmertools_jax.io import fastx
    from kmertools_jax.io.batch import encode_bases
    from kmertools_jax.utils.codec import canonical_slot_table, kmer_pos_maps
    from kmertools_jax.utils.fmt import format_counts, format_fixed6

    if canonical:
        table = canonical_slot_table(k).astype(np.int64)
        nb = kmer_pos_maps(k)[2]
    else:
        table = np.arange(4**k, dtype=np.int64)
        nb = 4**k
    t0 = time.perf_counter()
    out_chunks = []
    rows = []
    lens = []

    def flush_rows() -> None:
        if not rows:
            return
        # records laid end to end with one ambiguous code after each, so
        # no k-mer spans two records and nothing pads to the longest
        n = len(rows)
        codes = np.concatenate(
            [np.append(r, np.uint8(4)) for r in rows]
        ).astype(np.int64)
        rid = np.repeat(np.arange(n), [len(r) + 1 for r in rows])
        P = len(codes) - k + 1
        fwd = np.zeros(P, dtype=np.int64)
        for j in range(k):
            fwd = fwd * 4 + codes[j : j + P]
        bad = np.concatenate([[0], np.cumsum(codes >= 4)])
        valid = (bad[k : k + P] - bad[:P]) == 0
        slots = table[np.where(valid, fwd, 0)]
        r = rid[:P][valid]
        counts = np.bincount(
            r * nb + slots[valid], minlength=n * nb
        ).reshape(n, nb)
        if norm:
            totals = np.bincount(r, minlength=n)
            vecs = counts / np.maximum(1, totals)[:, None]
            out_chunks.append(format_fixed6(vecs, " "))
        else:
            out_chunks.append(format_counts(counts, " "))
        rows.clear()
        lens.clear()

    batch_bases = 0
    for rec in fastx.sequences(in_path):
        rows.append(encode_bases(rec.seq))
        lens.append(len(rec.seq))
        batch_bases += len(rec.seq)
        if batch_bases >= 4 << 20:
            flush_rows()
            batch_bases = 0
    flush_rows()
    with open(out_path, "wb") as f:
        for chunk in out_chunks:
            f.write(chunk)
    return time.perf_counter() - t0


LAST_SINKS: list = []


def ours(in_path: str, out_path: str) -> float:
    from kmertools_jax.workloads import common
    from kmertools_jax.workloads.oligo import OligoComputer

    com = OligoComputer(in_path, out_path, K, True)
    # big device batches: fewer dispatches per base
    com.set_max_memory(6.0)
    t0 = time.perf_counter()
    com.vectorise()
    dt = time.perf_counter() - t0
    LAST_SINKS[:] = [dict(s) for s in common.LAST_RUN_STATS]
    return dt


def baseline_native_1t(in_path: str, out_path: str) -> float:
    """Second baseline (VERDICT r2 item 6): the in-repo native C++
    engine pinned to ONE counting thread on the CPU backend — the
    closest stand-in for one Rust-CLI core (same rolling-encode+count
    hot loop, counter/src/lib.rs:104-143 class). Run in a subprocess so
    the live process's accelerator backend stays untouched. Slightly
    generous to the baseline: the parse-ahead thread still overlaps
    parsing with counting, as the Rust CLI's iterator thread does."""
    import subprocess

    prog = (
        "import time, os\n"
        "os.environ['KMERTOOLS_QUIET'] = '1'\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "from kmertools_jax.workloads.oligo import OligoComputer\n"
        "for tag in ('COLD', 'WARM'):\n"
        f"    c = OligoComputer({in_path!r}, {out_path!r}, {K}, True)\n"
        "    c.set_threads(1)\n"
        # the 1-thread engine's own best batch size (2^21; the plan's
        # 2^22 default is tuned for 4 threads and costs 1t ~20% —
        # round-5 A/B). The baseline runs at ITS best, not ours.
        "    c.target_codes = 1 << 21\n"
        "    t0 = time.perf_counter()\n"
        "    c.vectorise()\n"
        "    print(tag, time.perf_counter() - t0)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", prog],
        capture_output=True, text=True, timeout=1800,
    )
    cold = warm = None
    for line in r.stdout.splitlines():
        if line.startswith("COLD"):
            cold = float(line.split()[1])
        elif line.startswith("WARM"):
            warm = float(line.split()[1])
    if cold is None or warm is None:
        raise RuntimeError("native-1t baseline failed: " + r.stderr[-500:])
    # cold = fresh-process run (the rounds-1..4 comparable figure, and
    # the CLI user experience); warm = second run in the same process
    # (page/buffer warmth) — reported separately so the asymmetry vs
    # the in-process framework runs is auditable
    return cold, warm


def main() -> None:
    import tempfile

    os.environ.setdefault("KMERTOOLS_QUIET", "1")
    # short verdict TTL for the bench: the host's THP fault cost drifts
    # on a ~minute scale, and the in-process pipeline re-validates via
    # ensure_hugepage_tuning() at every run entry — a stale "fast"
    # verdict measured 10-150 ms per fresh 2 MB numpy fault (round-4
    # driver-capture regression class)
    os.environ.setdefault("KMERTOOLS_HUGEPAGE_PROBE_TTL", "120")
    # force a FRESH hugepage-probe verdict in this process and every
    # timed subprocess: a verdict cached minutes ago can be stale on a
    # host whose THP fault cost drifts (round-3b regression class)
    probe_cache = os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "kmertools_jax", "hugepage_probe",
    )
    try:
        os.unlink(probe_cache)
    except OSError:
        pass
    from kmertools_jax.utils.device import card_facts, require_gpu

    print(f"card: {card_facts()}", file=sys.stderr)
    device = require_gpu()
    load0 = os.getloadavg()[0]
    # tmpfs when available: this box's disk writeback throttles in
    # bursts (26-440 MB/s swings run-to-run), which would decide the
    # headline instead of the pipeline under test. Both sides read and
    # write the same medium, so the comparison stays fair.
    shm = "/dev/shm"
    tmp = tempfile.mkdtemp(
        prefix="ktbench",
        dir=shm if os.path.isdir(shm) and os.access(shm, os.W_OK) else None,
    )
    corpus = os.path.join(tmp, "bench.fa")
    total_bases = make_corpus(corpus)

    # warmup FIRST (device init + compile-cache population are one-time
    # machine costs, not throughput); it also fails fast on any error
    ours(corpus, os.path.join(tmp, "warm.kmers"))

    # ours and native-1t run back-to-back inside each repeat: this
    # box's DRAM/THP behaviour drifts on a ~minute scale (CLAUDE.md),
    # and round 4's capture ran the two sides in different phases —
    # paired samples plus per-run phase probes make the ratio auditable
    ours_t = float("inf")
    nat1_t = float("inf")
    nat1_warm_t = float("inf")
    sinks: list = []
    t_ours: list = []
    t_nat1: list = []
    t_nat1_warm: list = []
    t_base: list = []
    touch: list = []
    for _ in range(REPEATS):
        touch.append(first_touch_gbps())
        t = ours(corpus, os.path.join(tmp, "ours.kmers"))
        t_ours.append(round(t, 3))
        if t < ours_t:
            ours_t = t
            sinks = [dict(s) for s in LAST_SINKS]
        cold, warm = baseline_native_1t(
            corpus, os.path.join(tmp, "nat1.kmers")
        )
        t_nat1.append(round(cold, 3))
        t_nat1_warm.append(round(warm, 3))
        nat1_t = min(nat1_t, cold)
        nat1_warm_t = min(nat1_warm_t, warm)
    base_t = float("inf")
    for _ in range(NUMPY_REPEATS):
        t = baseline_numpy(corpus, os.path.join(tmp, "base.kmers"))
        t_base.append(round(t, 1))
        base_t = min(base_t, t)

    # outputs must agree byte-for-byte (both baselines)
    with open(os.path.join(tmp, "ours.kmers"), "rb") as f:
        ours_bytes = f.read()
    for name in ("base.kmers", "nat1.kmers"):
        with open(os.path.join(tmp, name), "rb") as f:
            assert f.read() == ours_bytes, f"bench output mismatch vs {name}"

    ours_rate = total_bases / ours_t
    base_rate = total_bases / base_t
    nat1_rate = total_bases / nat1_t
    # phase verdict a reader can audit: the run spread and the
    # first-touch probes tell a throttled-DRAM window from a healthy one
    spread = max(t_ours) / min(t_ours) if t_ours else 1.0
    degraded = min(touch) < 1.0 or spread > 1.4
    print(
        json.dumps(
            {
                "metric": "oligo_k4_bases_per_sec",
                "value": round(ours_rate),
                "unit": "bases/s",
                # primary ratio: vs the optimised single-process numpy
                # stand-in (BASELINE.md methodology note)
                "vs_baseline": round(ours_rate / base_rate, 3),
                # honest second baseline: vs the in-repo native engine
                # pinned to ONE thread — the stand-in for one Rust-CLI
                # core (BASELINE.json's >=10x target class). _cold =
                # fresh process per run (comparable to rounds 1-4, and
                # the CLI UX); _warm = the baseline's second in-process
                # run, symmetric with the framework's warm in-process
                # runs — on this 4-core box warm-vs-warm is bounded
                # near ~1.2-1.3x by the histogram's 1.9 core-seconds
                "vs_native_1t": round(ours_rate / nat1_rate, 3),
                "vs_native_1t_warm": round(
                    ours_rate / (total_bases / nat1_warm_t), 3
                ),
                # what actually ran: the device and per-sink routing
                "device": device,
                "card": card_facts(),
                "sinks": {
                    s["key"]: {
                        "batches": s["batches"],
                        "weight": s["weight"],
                        "Mcodes_s": round(s["rate"] / 1e6, 1),
                        # coalescing group size + dispatched groups
                        # (VERDICT r4 item 1 observability)
                        "n_coal": s.get("n_coal", 1),
                        "groups": s.get("groups", 0),
                    }
                    for s in sinks
                },
                # host-phase telemetry (VERDICT r4 #1): every timed run
                # with the fresh-page fault bandwidth measured right
                # before it, so a degraded capture indicts the host,
                # not the framework
                "host": {
                    "first_touch_gbps": touch,
                    "thp_numpy_madvise_off": (
                        os.environ.get("NUMPY_MADVISE_HUGEPAGE") == "0"
                    ),
                    "load_avg_start_end": [
                        round(load0, 2), round(os.getloadavg()[0], 2)
                    ],
                    "t_ours": t_ours,
                    "t_native_1t": t_nat1,
                    "t_native_1t_warm": t_nat1_warm,
                    "t_numpy": t_base,
                    "phase": "degraded" if degraded else "healthy",
                },
            }
        )
    )


if __name__ == "__main__":
    main()
