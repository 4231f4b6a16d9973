"""Per-sink batch coalescing (workloads/common.py).

A device whose probed RTT exceeds _COALESCE_RTT_S pays a multi-RTT
fixed cost per dispatch, so the EWMA router starves
it when every producer batch is dispatched alone (VERDICT r3 weak#1).
Coalescing buffers N same-shape batches per high-RTT sink and dispatches
them as ONE padded super-batch whose fused result is sliced back per
original batch — output bytes must be identical to the uncoalesced run.
"""

import numpy as np
import pytest

from kmertools_jax.workloads import common


class _FakeBatch:
    """Minimal planes()/lengths batch (io.batch.Batch dispatch surface)."""

    def __init__(self, tag: int, rows: int, wq: int, n_ambig: int = 0):
        self.tag = tag
        packed = np.full((rows, wq), tag % 251, np.uint8)
        packed[:, 0] = np.arange(rows, dtype=np.uint8)
        vb = np.full((rows, wq // 2), 0xFF, np.uint8)
        self._planes = (packed, vb, n_ambig)
        self.lengths = np.full(rows, wq * 4, np.int32)

    def planes(self):
        return self._planes


def _row_aligned_dispatch(log=None):
    """Row-aligned result: per-row sums of the packed plane (computed
    lazily at fetch time like a device handle)."""

    def dispatch(b):
        if log is not None:
            log.append(len(b.lengths))

        class R:
            def __array__(self, dtype=None, copy=None):
                packed, _, _ = b.planes()
                return packed.astype(np.int64).sum(axis=1)

        return R()

    return dispatch


def test_coalesced_results_slice_back_per_batch():
    """Groups of 4 batches dispatch as one super-batch; consume still
    sees each original batch, in dispatch order, with its own rows."""
    batches = [_FakeBatch(i, rows=8, wq=16) for i in range(11)]
    got = []
    sizes = []
    # seed the rate prior: an UNMEASURED coalescing sink explore-
    # dispatches singletons until its first sample lands, which is
    # timing-dependent — a known rate makes grouping deterministic
    common._SINK_PRIORS["tc:sink"] = 1e9
    try:
        common.run_pipelined_hetero(
            batches,
            [_row_aligned_dispatch(sizes)],
            lambda meta, arr: got.append((meta.tag, arr.copy())),
            weight=lambda b: int(b.lengths.sum()),
            coalesce=[4],
            keys=["tc:sink"],
        )
    finally:
        common._SINK_PRIORS.pop("tc:sink", None)
    assert [t for t, _ in got] == list(range(11))
    for tag, arr in got:
        expect = np.full(8, tag % 251, np.int64) * 16
        expect += np.arange(8) - (tag % 251)
        assert arr.shape == (8,)
        assert np.array_equal(arr, expect)
    # 11 batches at n_coal=4 -> groups of 4, 4, and a tail (tail may
    # split further under token-pressure flushes; total rows conserved)
    assert sum(sizes) >= 11 * 8  # pow2 padding only ever adds rows
    assert len(sizes) <= 5
    (stats,) = common.LAST_RUN_STATS
    assert stats["batches"] == 11
    assert stats["n_coal"] == 4
    assert stats["groups"] >= 2


def test_coalesce_flushes_on_shape_change():
    """A width-bucket switch flushes the held group; bytes stay exact."""
    batches = [
        _FakeBatch(0, 8, 16), _FakeBatch(1, 8, 16),
        _FakeBatch(2, 8, 32),  # width change mid-group
        _FakeBatch(3, 8, 32), _FakeBatch(4, 8, 16),
    ]
    got = []
    common.run_pipelined_hetero(
        batches,
        [_row_aligned_dispatch()],
        lambda meta, arr: got.append((meta.tag, len(arr))),
        weight=lambda b: 1,
        coalesce=[8],
    )
    assert [t for t, _ in got] == [0, 1, 2, 3, 4]
    assert all(n == 8 for _, n in got)


def test_group_batch_padding_and_modes():
    """_GroupBatch pads to the requested group size with zero-length
    rows and derives the combined ambiguity mode correctly."""
    clean = [_FakeBatch(i, 8, 16, n_ambig=0) for i in range(3)]
    g = common._GroupBatch(clean, 4)
    packed, vb, n_ambig = g.planes()
    assert packed.shape == (32, 16) and vb.shape == (32, 8)
    assert n_ambig == 0
    assert len(g.lengths) == 32 and (g.lengths[24:] == 0).all()

    mixed = [_FakeBatch(0, 8, 16, n_ambig=0), _FakeBatch(1, 8, 16, n_ambig=3)]
    assert common._GroupBatch(mixed, 2).planes()[2] == 3
    unknown = [_FakeBatch(0, 8, 16, n_ambig=-1), _FakeBatch(1, 8, 16)]
    assert common._GroupBatch(unknown, 2).planes()[2] == -1


@pytest.mark.parametrize("force", ["1", "3"])
def test_oligo_coalesced_output_identical(tmp_path, test_data, monkeypatch,
                                          force):
    """End-to-end golden parity: oligo through the real XLA sink with
    coalescing forced (group=3 exercises pow2 padding) byte-equals the
    plain run — including N-containing reads (planes mode), short and
    split reads, and width-bucket switches."""
    rng = np.random.default_rng(11)
    corpus = tmp_path / "mix.fa"
    with open(corpus, "wb") as f:
        for i in range(120):
            L = int(rng.integers(40, 12_000))
            seq = rng.choice(list(b"ACGT"), size=L).astype(np.uint8)
            if i % 7 == 0:  # ambiguous bases -> planes wire mode
                seq[rng.integers(0, L, size=3)] = ord("N")
            f.write(b">r%d\n" % i + seq.tobytes() + b"\n")

    from kmertools_jax.workloads.oligo import OligoComputer

    ref_out = tmp_path / "plain.kmers"
    OligoComputer(str(corpus), str(ref_out), 4, True).vectorise()

    # drop the native sink so the XLA sink (the coalescing path) serves
    # every batch, and force a group size
    from kmertools_jax.workloads import oligo as oligo_mod

    monkeypatch.setattr(
        oligo_mod, "oligo_hist_native_sink", lambda *a, **k: None
    )
    monkeypatch.setenv("KMERTOOLS_COALESCE_FORCE", force)
    co_out = tmp_path / "coalesced.kmers"
    OligoComputer(str(corpus), str(co_out), 4, True).vectorise()
    assert co_out.read_bytes() == ref_out.read_bytes()
    if force != "1":
        stats = {s["key"]: s for s in common.LAST_RUN_STATS}
        xla = [s for k, s in stats.items() if ":xla:" in k]
        assert xla and sum(s["groups"] for s in xla) > 0


def test_deficit_routing_gives_slow_sink_its_share():
    """The deficit-share router must NOT structurally starve a sink
    that is merely slower: a 1:4 rate split earns the slow sink roughly
    a fifth of the work (the greedy earliest-finish rule gave it ~0)."""
    import time as _time

    def timed_sink(delay):
        def dispatch(b):
            class R:
                def __array__(self, dtype=None, copy=None):
                    _time.sleep(delay)
                    return np.asarray([b])

            return R()

        return dispatch

    for k in ("dz:slow", "dz:fast"):
        common._SINK_PRIORS.pop(k, None)
    common.run_pipelined_hetero(
        range(60),
        [timed_sink(0.008), timed_sink(0.002)],
        lambda m, a: None,
        weight=lambda b: 1,
        keys=["dz:slow", "dz:fast"],
    )
    stats = {s["key"]: s for s in common.LAST_RUN_STATS}
    slow = stats["dz:slow"]["batches"]
    assert slow >= 6, f"slow sink starved: {slow}/60 batches"
    assert stats["dz:fast"]["batches"] > slow
    for k in ("dz:slow", "dz:fast"):
        common._SINK_PRIORS.pop(k, None)


def test_plan_drops_cpu_xla_sink_when_native_present(monkeypatch):
    """With a native kernel present, the host-CPU XLA device set must
    NOT become a separate sink: it shares the same cores as the native
    engine and loses to it ~20x (BENCH r4), so scheduling both only
    adds contention. Accelerator sets stay; without a native sink the
    CPU set still serves."""

    class _Dev:
        def __init__(self, platform):
            self.platform = platform
            self.id = 0

    accel = [_Dev("gpu")]
    cpus = [_Dev("cpu")] * 4
    monkeypatch.setattr(
        common, "hetero_device_sets", lambda n=None: [accel, cpus]
    )
    import jax

    monkeypatch.setattr(jax, "local_devices", lambda backend=None: accel)
    made = []
    dispatches, keys, _, coalesce, _rtts = common.plan_hetero_sinks(
        lambda d: made.append(d) or (lambda b: None),
        native_sink=lambda b: None,
        key_prefix="t",
        target_codes=1 << 20,
    )
    assert keys == ["t:xla:0:gpux1", "t:native"]
    assert len(dispatches) == 2 and len(coalesce) == 2

    made.clear()
    dispatches, keys, _, coalesce, _rtts = common.plan_hetero_sinks(
        lambda d: made.append(d) or (lambda b: None),
        native_sink=None,
        key_prefix="t",
        target_codes=1 << 20,
    )
    assert keys == ["t:xla:0:gpux1", "t:xla:1:cpux4"]


def test_adaptive_group_size_resizes_from_rtt(monkeypatch):
    """With a measured RTT and no FORCE pin, the sink re-sizes its
    group so the per-group RTT stays <= ~20% of group compute
    (VERDICT r4 #5): n >= 5*rtt*rate/w, pow2, clamped to [2, 16].
    Output parity and ordering must hold across the resizes."""
    batches = [_FakeBatch(i, rows=8, wq=16) for i in range(40)]
    got = []
    # seed a fast prior so grouping starts immediately; w = 8*64 codes
    # per batch. rate=1e9, rtt=5e-3 -> n = 5*.005*1e9/512 ~ 9766 -> 16
    common._SINK_PRIORS["ad:sink"] = 1e9
    try:
        common.run_pipelined_hetero(
            batches,
            [_row_aligned_dispatch()],
            lambda meta, arr: got.append((meta.tag, arr.copy())),
            weight=lambda b: int(b.lengths.sum()),
            coalesce=[4],
            keys=["ad:sink"],
            rtts=[5e-3],
        )
    finally:
        common._SINK_PRIORS.pop("ad:sink", None)
    assert [t for t, _ in got] == list(range(40))
    for tag, arr in got:
        expect = np.full(8, tag % 251, np.int64) * 16
        expect += np.arange(8) - (tag % 251)
        assert np.array_equal(arr, expect)
    (stats,) = common.LAST_RUN_STATS
    assert stats["batches"] == 40
    # adapted away from the initial 4 and stayed in the clamp band
    assert 2 <= stats["n_coal"] <= 16
    assert stats["groups"] >= 1


def test_pick_sink_refuses_slow_sink_near_stream_end():
    """End-of-stream tail bound (VERDICT r4 #1): with a total-weight
    hint, a slow sink whose backlog + batch cannot finish before the
    rest of the stream drains is ineligible, so the last batches go to
    the fast
    sink even when deficit credit favours the slow one."""
    out_q = __import__("queue").Queue()
    err: list = []
    sinks = [
        common._HeteroSink(0, lambda b: None, out_q, err, 2, key=None),
        common._HeteroSink(1, lambda b: None, out_q, err, 2, key=None),
    ]
    try:
        slow, fast = sinks
        slow.rate = 10e6    # 10 Mcodes/s (~9% share: above min-share)
        fast.rate = 100e6   # 100 Mcodes/s
        slow.credit = 1e9   # deficit credit strongly favours slow
        w = 100_000         # slow needs 0.01 s for one batch
        # plenty of stream left (10 s worth): slow is eligible
        assert common._pick_sink(sinks, w, rem_w=10 * 110_000_000) is slow
        slow.credit = 1e9
        # ~0.008 s of stream left: slow (needs 0.01 s) must be refused
        pick = common._pick_sink(sinks, w, rem_w=1_000_000)
        assert pick is fast
        # no hint: the fixed backlog bound alone lets slow take it
        slow.credit = 1e9
        assert common._pick_sink(sinks, w, rem_w=None) is slow
    finally:
        for s in sinks:
            s.close_dispatch()
            s.q.put(None)
            s.thread.join()


def test_stuck_remote_frontier_recomputed_on_host():
    """A remote group whose fetch hangs must not head-of-line-block
    ordered consume: with a `recompute` fallback the consumer re-runs
    the stuck batch locally (bit-identical result) and drops the late
    original. All outputs stay correct and in order, and every batch
    routed to the hung sink is consumed well before its fetch returns."""
    import time as _time

    HANG = 2.0
    t0 = _time.perf_counter()

    def hung_remote(b):
        class R:
            def __array__(self, dtype=None, copy=None):
                _time.sleep(HANG)  # stalled link
                packed, _, _ = b.planes()
                return packed.astype(np.int64).sum(axis=1)

        return R()

    def recompute(b):
        packed, _, _ = b.planes()
        return packed.astype(np.int64).sum(axis=1)  # single array form

    batches = [_FakeBatch(i, rows=8, wq=16) for i in range(10)]
    got = []
    common._SINK_PRIORS["sr:remote"] = 5e8
    common._SINK_PRIORS["sr:fast"] = 1e9
    try:
        common.run_pipelined_hetero(
            batches,
            [hung_remote, _row_aligned_dispatch()],
            lambda meta, arr: got.append(
                (meta.tag, arr.copy(), _time.perf_counter() - t0)
            ),
            weight=lambda b: int(b.lengths.sum()),
            coalesce=[2, 1],
            keys=["sr:remote", "sr:fast"],
            rtts=[0.0, 0.0],
            recompute=recompute,
        )
    finally:
        for k in ("sr:remote", "sr:fast"):
            common._SINK_PRIORS.pop(k, None)
    assert [t for t, _, _ in got] == list(range(10))
    for tag, arr, _ in got:
        expect = np.full(8, tag % 251, np.int64) * 16
        expect += np.arange(8) - (tag % 251)
        assert np.array_equal(arr, expect)
    stats = {s["key"]: s for s in common.LAST_RUN_STATS}
    assert stats["sr:remote"]["batches"] >= 1, "remote sink never routed"
    # every consume landed before the hung fetch could have returned
    assert max(t for _, _, t in got) < HANG, [t for _, _, t in got]


def test_min_share_lockout_and_reprobe():
    """A sink whose EWMA falls below the min-share floor stops taking
    batches (its slow groups cost more frontier friction than their
    work is worth), but gets a singleton re-probe once idle for
    _REPROBE_S so a recovered phase can win its share back."""
    import time as _time

    out_q = __import__("queue").Queue()
    err: list = []
    sinks = [
        common._HeteroSink(0, lambda b: None, out_q, err, 2),
        common._HeteroSink(1, lambda b: None, out_q, err, 2),
    ]
    try:
        slow, fast = sinks
        slow.rate = 1e6    # ~1% share: below _SINK_MIN_SHARE
        fast.rate = 1e8
        slow.credit = 1e9
        w = 100_000
        slow.last_routed = _time.perf_counter()
        assert common._pick_sink(sinks, w, None) is fast
        # idle past the re-probe window: gets exactly one probe batch
        slow.last_routed = _time.perf_counter() - common._REPROBE_S - 1
        pick = common._pick_sink(sinks, w, None)
        assert pick is slow and slow._probe_next
    finally:
        for s in sinks:
            s.close_dispatch()
            s.q.put(None)
            s.thread.join()
