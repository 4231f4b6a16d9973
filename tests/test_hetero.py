"""Heterogeneous multi-sink execution (workloads/common.py).

The reference saturates every core with rayon work-stealing threads
(counter/src/lib.rs:104-143); the framework's analog routes device
batches across MULTIPLE device sets (accelerator mesh + host CPUs) by
live throughput estimates. These tests pin the scheduler's contracts:
in-dispatch-order consumption (split reads depend on it), byte-equal
output vs the single-sink path, and error propagation without hangs.
"""

import threading
import time

import numpy as np
import pytest

from kmertools_jax.workloads import common


def _sink(delay=0.0, log=None, name=""):
    def dispatch(b):
        if log is not None:
            log.append(name)
        # emulate an async device result: a zero-arg handle resolved at
        # fetch time (np.asarray in the sink drain thread)
        class R:
            def __array__(self, dtype=None, copy=None):
                if delay:
                    time.sleep(delay)
                return np.asarray([b], dtype=np.int64)

        return R()

    return dispatch


def test_hetero_consume_order_preserved():
    """Sinks complete out of order; consume still sees dispatch order."""
    got = []
    fast = _sink(0.0)
    slow = _sink(0.02)
    common.run_pipelined_hetero(
        range(40),
        [slow, fast],
        lambda meta, arr: got.append((meta, int(arr[0]))),
        weight=lambda b: 1,
    )
    assert [m for m, _ in got] == list(range(40))
    assert all(m == v for m, v in got)


def test_hetero_routes_to_both_sinks():
    log_a, log_b = [], []
    common.run_pipelined_hetero(
        range(64),
        [_sink(0.005, log_a, "a"), _sink(0.005, log_b, "b")],
        lambda meta, arr: None,
        weight=lambda b: 1,
    )
    assert len(log_a) + len(log_b) == 64
    assert log_a and log_b, "scheduler never used one of the sinks"


def test_hetero_consume_error_propagates():
    def consume(meta, arr):
        if meta == 5:
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        common.run_pipelined_hetero(
            range(100), [_sink(), _sink(0.001)], consume, weight=lambda b: 1
        )


def test_hetero_dispatch_error_propagates():
    def bad(b):
        raise ValueError("bad dispatch")

    with pytest.raises(ValueError, match="bad dispatch"):
        common.run_pipelined_hetero(
            range(10), [bad], lambda m, a: None, weight=lambda b: 1
        )


def test_hetero_fetch_error_propagates():
    class Bad:
        def __array__(self, dtype=None, copy=None):
            raise OSError("device lost")

    with pytest.raises(OSError, match="device lost"):
        common.run_pipelined_hetero(
            range(30),
            [_sink(), lambda b: Bad()],
            lambda m, a: None,
            weight=lambda b: 1,
        )


def test_hetero_bounded_inflight():
    """A stalled sink must not let the fast sink run unboundedly ahead
    (max_inflight bounds batches between dispatch and consumption)."""
    inflight_peak = [0]
    dispatched = [0]
    consumed = [0]
    lock = threading.Lock()

    gate = threading.Event()

    def stall_once(b):
        class R:
            def __array__(self, dtype=None, copy=None):
                if b == 0:
                    gate.wait(5.0)
                return np.asarray([b])

        with lock:
            dispatched[0] += 1
            inflight_peak[0] = max(
                inflight_peak[0], dispatched[0] - consumed[0]
            )
        return R()

    def consume(meta, arr):
        with lock:
            consumed[0] += 1
        if meta == 0:
            pass

    t = threading.Timer(0.3, gate.set)
    t.start()
    common.run_pipelined_hetero(
        range(50), [stall_once, stall_once], consume,
        weight=lambda b: 1, max_inflight=6,
    )
    t.cancel()
    assert inflight_peak[0] <= 6


def test_oligo_two_sink_output_identical(tmp_path, test_data, monkeypatch):
    """Oligo through two CPU sub-meshes (4+4 devices) byte-equals the
    single-mesh run — including split reads crossing batch boundaries."""
    import jax

    devs = jax.local_devices()
    assert len(devs) == 8
    rng = np.random.default_rng(7)
    corpus = tmp_path / "mix.fa"
    with open(corpus, "wb") as f:
        for i in range(300):
            # lengths straddling every bucket incl. >max_width splits
            L = int(rng.integers(50, 20_000))
            seq = rng.choice(list(b"ACGT"), size=L).astype(np.uint8)
            f.write(b">r%d\n" % i + seq.tobytes() + b"\n")

    from kmertools_jax.workloads.oligo import OligoComputer

    ref_out = tmp_path / "single.kmers"
    OligoComputer(str(corpus), str(ref_out), 4, True).vectorise()

    # plan_hetero_sinks (common.py) is the single consumer now
    monkeypatch.setattr(
        common, "hetero_device_sets", lambda n=None: [devs[:4], devs[4:]]
    )
    het_out = tmp_path / "hetero.kmers"
    OligoComputer(str(corpus), str(het_out), 4, True).vectorise()
    assert het_out.read_bytes() == ref_out.read_bytes()


def test_sink_rate_priors_persist_across_runs():
    """A sink's learned rate survives into the next run (keyed by name):
    the scheduler must NOT re-explore a known-slow sink with the opening
    batch — on a high-RTT device that explore batch is a stall at the
    head of the consume line."""
    for k in ("t:slow", "t:fast"):
        common._SINK_PRIORS.pop(k, None)
    routed1, routed2 = [], []
    try:
        common.run_pipelined_hetero(
            range(24),
            [_sink(0.05, routed1, "slow"), _sink(0.001, routed1, "fast")],
            lambda m, a: None,
            weight=lambda b: 1,
            keys=["t:slow", "t:fast"],
        )
        assert common._SINK_PRIORS["t:slow"] < common._SINK_PRIORS["t:fast"]
        # pin run 2's priors deterministically: run 1 proved they get
        # RECORDED; seeding directly proves they get USED without
        # depending on run-1 timing on a loaded CI host
        common._SINK_PRIORS["t:slow"] = 20.0
        common._SINK_PRIORS["t:fast"] = 1000.0
        common.run_pipelined_hetero(
            range(24),
            [_sink(0.05, routed2, "slow"), _sink(0.001, routed2, "fast")],
            lambda m, a: None,
            weight=lambda b: 1,
            keys=["t:slow", "t:fast"],
        )
        # without the prior the opening batch goes to sink 0 (idx
        # tiebreak); with it the scheduler starts on the known-fast sink
        assert routed2[0] == "fast"
        assert routed2.count("fast") > routed2.count("slow")
    finally:
        for k in ("t:slow", "t:fast"):
            common._SINK_PRIORS.pop(k, None)


def test_last_run_stats_recorded():
    """run_pipelined_hetero records per-sink routing stats (bench.py
    reports them in the driver JSON) — multi-sink and single-sink."""
    common.run_pipelined_hetero(
        range(16),
        [_sink(0.001), _sink(0.001)],
        lambda m, a: None,
        weight=lambda b: 2,
        keys=["t:a", "t:b"],
    )
    stats = {s["key"]: s for s in common.LAST_RUN_STATS}
    assert set(stats) == {"t:a", "t:b"}
    assert sum(s["batches"] for s in stats.values()) == 16
    assert sum(s["weight"] for s in stats.values()) == 32
    for k in ("t:a", "t:b"):
        common._SINK_PRIORS.pop(k, None)

    common.run_pipelined_hetero(
        range(5), [_sink()], lambda m, a: None,
        weight=lambda b: 3, keys=["t:solo"],
    )
    assert common.LAST_RUN_STATS == [
        {"key": "t:solo", "batches": 5, "weight": 15, "rate": 0.0}
    ]
