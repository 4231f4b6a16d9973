"""Shared host-side plumbing for the streaming workloads.

The reference restores output order either with an mmap of fixed-width
slots (ktio/src/mmap.rs) or by batching and joining in order
(composition/src/oligo.rs:119-161). Here order restoration is a single
OrderedEmitter: device batches may complete out of read order (length
buckets interleave), and the emitter flushes the contiguous prefix.
"""

from __future__ import annotations

import atexit
import os
import queue
import threading
import time
import weakref
from typing import Callable, Iterable

import numpy as np

# Sink drain threads that may outlive their pipeline run (the shutdown
# join uses a timeout so a slow high-RTT fetch can't stall the caller —
# the result was already recomputed locally). They MUST NOT outlive the
# interpreter with a jax fetch in flight: a fetch completing during
# finalization re-acquires the GIL from C++ frames and CPython's
# pthread_exit forced-unwind aborts the process ("FATAL: exception not
# rethrown", observed ~17% of short CLI runs). The atexit hook joins
# them while the interpreter is still alive; a genuinely hung transfer
# times out (a never-completing fetch can't trigger the race).
_LIVE_DRAINS: "weakref.WeakSet" = weakref.WeakSet()


def _join_straggler_drains() -> None:
    for t in list(_LIVE_DRAINS):
        if t.is_alive():
            t.join(timeout=30.0)


atexit.register(_join_straggler_drains)


def run_pipelined(batches: Iterable, dispatch: Callable, consume: Callable,
                  depth: int = 2) -> None:
    """Producer/consumer pipeline around the device.

    The calling thread iterates `batches` and calls `dispatch(batch)`
    (host->device upload + async device dispatch); a writer thread calls
    `consume(batch, *dispatch_result)` (device fetch + host
    post-processing). With JAX's async dispatch this overlaps host
    parsing, device compute, both host-device transfers, and output
    writing.
    `depth` bounds in-flight batches so device memory stays bounded.

    This is the device analog of the reference's N-thread shared-
    iterator work pool (composition/src/oligo.rs:192-226): one thread
    feeds the accelerator, one drains it, order is preserved by the
    queue.
    """
    from kmertools_jax import ensure_hugepage_tuning

    ensure_hugepage_tuning()
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []

    def worker() -> None:
        while True:
            item = q.get()
            if item is None:
                return
            if err:
                continue  # drain so the producer's bounded put never blocks
            try:
                consume(item[0], *item[1])
            except BaseException as e:  # propagated after join
                err.append(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        for b in batches:
            res = dispatch(b)
            if err:
                break
            res = res if isinstance(res, tuple) else (res,)
            # start the device->host copy NOW (it queues behind the
            # batch's compute): by the time the writer thread blocks in
            # np.asarray the bytes are already in flight, so fetches of
            # successive batches overlap each other and the compute
            for r in res:
                cast = getattr(r, "copy_to_host_async", None)
                if cast is not None:
                    try:
                        cast()
                    except Exception:
                        pass
            q.put((b, res))
    finally:
        q.put(None)
        t.join()
    if err:
        raise err[0]


def hetero_device_sets(n_devices: int | None = None) -> list[list]:
    """Device sets for heterogeneous execution: the default backend's
    devices, plus the host-CPU devices when the default backend is an
    accelerator and the CPU platform is also registered (e.g.
    ``jax_platforms="cuda,cpu"``).

    The reference saturates every core with rayon threads
    (counter/src/lib.rs:104-143); the device analog is feeding every
    piece of silicon on the node — accelerator batches ride the mesh,
    leftover host cores chew batches through the identical XLA program
    compiled for CPU. Integer histograms make the two paths bit-equal.
    Opt out with KMERTOOLS_NO_HETERO=1. ``n_devices`` keeps only the
    first n devices of the default backend.
    """
    import jax

    prim = list(jax.local_devices())[:n_devices]
    sets = [prim]
    if (
        prim
        and prim[0].platform != "cpu"
        and os.environ.get("KMERTOOLS_NO_HETERO") != "1"
    ):
        try:
            cpus = list(jax.local_devices(backend="cpu"))
        except RuntimeError:
            cpus = []
        if cpus:
            sets.append(cpus)
    return sets


# Learned sink rates survive across pipeline runs in this process
# (keyed by workload+platform, e.g. "oligo:xla:gpu"). Without a prior
# every run re-pays exploration of an unmeasured sink: on a high-RTT
# device one explore batch is a head-of-line stall that can decide
# short runs.
_SINK_PRIORS: dict[str, float] = {}
_SINK_PRIORS_LOCK = threading.Lock()

# last time a batch was routed to each sink KEY (process-wide): the
# min-share re-probe ages across pipeline runs — bench-scale runs are
# shorter than _REPROBE_S, so a per-run timestamp would never fire and
# a locked-out sink could stay locked out for the whole process
_SINK_LAST_ROUTED: dict[str, float] = {}

# Measured device round-trip times (seconds), keyed by device id. One
# probe per device per process: a tiny host->device->host bounce, the
# sink's own measured RTT.
_DEVICE_RTT: dict = {}
_DEVICE_RTT_LOCK = threading.Lock()


def probe_device_rtt(dev) -> float:
    """Measured seconds for one tiny host->device->host round trip on
    `dev` (min of 2 trials after a warmup). Cached per device."""
    import jax

    key = (dev.platform, getattr(dev, "id", 0))
    with _DEVICE_RTT_LOCK:
        if key in _DEVICE_RTT:
            return _DEVICE_RTT[key]
    x = np.zeros(8, np.float32)
    try:
        np.asarray(jax.device_put(x, dev))  # warm transfer path
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            np.asarray(jax.device_put(x, dev))
            best = min(best, time.perf_counter() - t0)
    except Exception:
        best = 0.0
    with _DEVICE_RTT_LOCK:
        _DEVICE_RTT[key] = best
    return best


# RTT above which a device set is treated as high-latency ("remote" in
# the scheduler below) and its sink coalesces producer batches into
# super-batches, amortising the per-dispatch round trips that would
# otherwise price it out of the EWMA router
_COALESCE_RTT_S = 0.005


def coalesce_for(devices) -> int:
    """Coalescing group size for an XLA sink on `devices` (1 = off).

    KMERTOOLS_COALESCE_FORCE=n forces n for every XLA sink (tests /
    experiments); otherwise sinks whose first device answers a probe
    round trip slower than 5 ms coalesce KMERTOOLS_COALESCE (default 8)
    producer batches per dispatch."""
    force = os.environ.get("KMERTOOLS_COALESCE_FORCE")
    if force:
        return max(1, int(force))
    if not devices:
        return 1
    if probe_device_rtt(devices[0]) > _COALESCE_RTT_S:
        return max(1, int(os.environ.get("KMERTOOLS_COALESCE", 8)))
    return 1


class _GroupBatch:
    """Concatenation of same-shape batches for one coalesced dispatch:
    exposes exactly the surface the workloads' dispatch closures use
    (``planes()`` and ``lengths``). Rows pad with zero-length dummy rows
    up to ``pad_batches`` x the per-batch row count so group programs
    compile at a handful of shapes (pow2 group sizes), never one per
    flush size."""

    __slots__ = ("_planes", "lengths")

    def __init__(self, metas: list, pad_batches: int):
        planes = [m.planes() for m in metas]
        packed = [p for p, _, _ in planes]
        vbs = [v for _, v, _ in planes]
        nams = [a for _, _, a in planes]
        R, Wq = packed[0].shape
        pad = pad_batches - len(metas)
        if pad > 0:
            packed.append(np.zeros((pad * R, Wq), np.uint8))
            vbs.append(np.zeros((pad * R, vbs[0].shape[1]), np.uint8))
        n_ambig = -1 if any(a < 0 for a in nams) else sum(nams)
        self._planes = (
            np.concatenate(packed, axis=0),
            np.concatenate(vbs, axis=0),
            n_ambig,
        )
        lens = [np.asarray(m.lengths, np.int32) for m in metas]
        if pad > 0:
            lens.append(np.zeros(pad * R, np.int32))
        self.lengths = np.concatenate(lens)

    def planes(self):
        return self._planes

# Routing record of the most recent run_pipelined_hetero call: one dict
# per sink {key, batches, weight, rate}. Observability for the bench
# (which sinks actually served batches) and for tests.
LAST_RUN_STATS: list[dict] = []


def _start_host_copies(res: tuple) -> None:
    """Kick off device->host copies for every result NOW: by the time
    the drain thread blocks in np.asarray the bytes are in flight, so
    fetches overlap each other and the compute."""
    for r in res:
        cast = getattr(r, "copy_to_host_async", None)
        if cast is not None:
            try:
                cast()
            except Exception:
                pass


class _HeteroSink:
    """One execution sink (a device set) in the multi-sink pipeline:
    its own bounded FIFO and drain thread. The drain thread blocks on
    the sink's device->host fetches (np.asarray) in dispatch order and
    forwards completed numpy results to the shared completion queue, so
    a slow sink never blocks a fast one.

    ``n_coal > 1`` turns on per-sink batch coalescing (sinks whose
    probed RTT exceeds _COALESCE_RTT_S): routed batches buffer until `n_coal` of one shape are held,
    then concatenate into ONE padded super-batch dispatch whose fused
    result is sliced back per batch at fetch time — amortising the
    per-dispatch round trips over the group. Requires the dispatch's
    result arrays to be row-aligned with its input rows (true for every
    fused-histogram workload) and batches to expose planes()/lengths.
    Output bytes are untouched: consume still runs per original batch
    in dispatch order (pinned by tests/test_coalesce.py)."""

    def __init__(self, idx: int, dispatch: Callable, out_q: queue.Queue,
                 err: list, depth: int, key: str | None = None,
                 n_coal: int = 1, rtt: float = 0.0):
        self.idx = idx
        self.dispatch = dispatch
        self.key = key
        self.n_coal = max(1, n_coal)
        # adaptive coalescing: fixed=True pins the
        # group size (KMERTOOLS_COALESCE_FORCE / non-coalescing sinks);
        # otherwise each group completion re-sizes n_coal from the
        # sink's measured RTT and EWMA rate so per-group dispatch
        # latency stays <= ~20% of group compute
        self.coal_fixed = (
            self.n_coal == 1
            or rtt <= 0.0  # no RTT measurement -> honour the caller's n
            or os.environ.get("KMERTOOLS_COALESCE_FORCE") is not None
        )
        self.rtt = rtt
        self.credit = 0.0  # deficit-share routing credit (codes)
        self.groups = 0  # coalesced dispatches issued
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._out_q = out_q
        self._err = err
        self.lock = threading.Lock()
        self.inflight = 0  # routed-but-unconsumed work units (codes)
        self.routed = 0  # batches routed here (KMERTOOLS_HETERO_STATS)
        self.routed_w = 0
        self._pending: list = []  # buffered (seq, meta, w) awaiting flush
        self._pend_w = 0
        self.rate = 0.0  # EWMA codes/s; 0 = no sample yet
        if key is not None:
            with _SINK_PRIORS_LOCK:
                self.rate = _SINK_PRIORS.get(key, 0.0)
        # a loaded prior may be stale (recorded under a different
        # contention regime / input); the first live sample outweighs it
        self._seeded = self.rate > 0
        self._last_done: float | None = None
        self.last_routed = (
            _SINK_LAST_ROUTED.get(key, time.perf_counter())
            if key is not None else time.perf_counter()
        )
        self._probe_next = False  # min-share re-probe flag (_pick_sink)
        # coalescing sinks dispatch from their own worker thread: the
        # group concatenate + device_put marshalling is a stall the
        # producer (parse) thread must not pay
        self._disp_q: queue.Queue | None = None
        if self.n_coal > 1:
            self._disp_q = queue.Queue()
            self._disp_thread = threading.Thread(
                target=self._disp_loop, daemon=True
            )
            self._disp_thread.start()
            # a worker can hold a jax dispatch in flight at process
            # exit — same finalization-abort class as the drains
            _LIVE_DRAINS.add(self._disp_thread)
        self.thread = threading.Thread(target=self._drain, daemon=True)
        self.thread.start()
        _LIVE_DRAINS.add(self.thread)

    def eta(self, w: int) -> float:
        """Estimated seconds to finish current backlog plus w codes."""
        with self.lock:
            if self.rate > 0:
                return (self.inflight + w) / self.rate
            # unmeasured: explore an idle sink, avoid stacking on a
            # busy one whose speed is still unknown
            return 0.0 if self.inflight == 0 else float("inf")

    # -- producer-thread entry points ---------------------------------
    def push(self, seq: int, meta, w: int) -> None:
        """Route one batch here (producer thread). Non-coalescing sinks
        dispatch immediately; coalescing sinks buffer until a full
        same-shape group is held."""
        with self.lock:
            self.inflight += w
            self.routed += 1
            self.routed_w += w
            infl = self.inflight
        self.last_routed = time.perf_counter()
        if self.key is not None:
            _SINK_LAST_ROUTED[self.key] = self.last_routed
        if self._probe_next:
            # min-share re-probe (_pick_sink): dispatch alone NOW so the
            # EWMA refreshes even though no full group will form — a
            # buffered probe could be reassigned away at end of stream
            # and the sink would stay locked out forever
            self._probe_next = False
            self._dispatch_group([(seq, meta, w)])
            return
        if self.n_coal <= 1 or (
            self.rate == 0 and not self._pending and infl == w
        ):
            # unmeasured coalescing sink: dispatch the exploration batch
            # NOW — buffered it would never complete a group, so the
            # sink would never earn a rate (and thus never a deficit
            # share); the singleton sample is pessimistic (full round
            # trip, no amortisation) and groups raise it from there.
            # `infl == w` (nothing else in flight) stops a stampede of
            # exploration singletons while the first sample is pending
            # — with the dispatch worker the producer no longer blocks
            # per dispatch, so the old check alone could drain the
            # whole stream as singletons before the rate ever landed
            self._dispatch_group([(seq, meta, w)])
            return
        if self._pending and not self._same_shape(self._pending[0][1], meta):
            self.flush()
        self._pending.append((seq, meta, w))
        self._pend_w += w
        if len(self._pending) >= self.n_coal:
            self.flush()

    def flush(self) -> None:
        """Dispatch any buffered batches as one group (producer thread)."""
        if self._pending:
            entries, self._pending = self._pending, []
            self._pend_w = 0
            self._dispatch_group(entries)

    def take_pending(self) -> list:
        """Surrender buffered batches WITHOUT dispatching (producer
        thread): the end-of-stream reassignment moves a held partial
        group to a faster sink so the stream's wall clock doesn't eat
        this sink's full round trip. Routing accounting transfers with
        the entries."""
        entries, self._pending = self._pending, []
        if not entries:
            return entries
        w = sum(e[2] for e in entries)
        self._pend_w = 0
        with self.lock:
            self.inflight -= w
            self.routed -= len(entries)
            self.routed_w -= w
        return entries

    @staticmethod
    def _same_shape(a, b) -> bool:
        try:
            return a.planes()[0].shape == b.planes()[0].shape
        except Exception:
            return False

    def _dispatch_group(self, entries: list) -> None:
        """Producer-thread entry: hand the group to the dispatch worker
        when one exists (coalescing sinks), else dispatch inline."""
        if self._disp_q is not None:
            self._disp_q.put(entries)
        else:
            self._do_dispatch(entries)

    def _disp_loop(self) -> None:
        while True:
            entries = self._disp_q.get()
            if entries is None:
                return
            self._do_dispatch(entries)

    def _do_dispatch(self, entries: list) -> None:
        w_total = sum(w for _, _, w in entries)
        try:
            if len(entries) == 1:
                batch = entries[0][1]
            else:
                # pad to a power-of-two group size: a handful of group
                # shapes per width bucket, not one compile per flush
                npad = 1 << (len(entries) - 1).bit_length()
                batch = _GroupBatch([m for _, m, _ in entries], npad)
                self.groups += 1
            res = self.dispatch(batch)
            res = res if isinstance(res, tuple) else (res,)
            _start_host_copies(res)
        except BaseException as e:  # surfaced by run_pipelined_hetero
            self._err.append(e)
            with self.lock:
                self.inflight -= w_total
            for seq, _, _ in entries:
                self._out_q.put(((seq, None, None), self.idx))
            return
        self.q.put((entries, res, w_total, time.perf_counter()))

    def close_dispatch(self, timeout: float | None = None) -> None:
        """Stop the dispatch worker (after the final flush); must run
        before the drain queue's end sentinel so no group is lost.

        ``timeout``: the worker can be BLOCKED inside a hung high-RTT
        dispatch; when the caller has a recompute fallback,
        it bounds the join and leaves the worker to finish as a daemon
        (the stranded batches were already recomputed locally; the
        atexit hook still drains it before interpreter teardown)."""
        if self._disp_q is not None:
            self._disp_q.put(None)
            self._disp_thread.join(timeout)

    # -- drain thread --------------------------------------------------
    def _emit_failed(self, entries: list) -> None:
        for seq, _, _ in entries:
            self._out_q.put(((seq, None, None), self.idx))

    def _drain(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                self._out_q.put((None, self.idx))
                return
            entries, res, w, t_disp = item
            if self._err:
                with self.lock:
                    self.inflight -= w
                self._emit_failed(entries)
                continue
            try:
                arrs = tuple(np.asarray(r) for r in res)
                now = time.perf_counter()
                # busy-interval throughput: time since the later of the
                # previous completion and this group's dispatch
                t0 = t_disp if self._last_done is None else max(
                    self._last_done, t_disp
                )
                self._last_done = now
                sample = w / max(now - t0, 1e-6)
                with self.lock:
                    if self.rate == 0:
                        self.rate = sample
                    elif self._seeded:
                        self.rate = 0.25 * self.rate + 0.75 * sample
                    else:
                        self.rate = 0.5 * self.rate + 0.5 * sample
                    self._seeded = False
                    self.inflight -= w
                if self.key is not None:
                    with _SINK_PRIORS_LOCK:
                        _SINK_PRIORS[self.key] = self.rate
                if not self.coal_fixed and len(entries) >= 1:
                    # adaptive group size: per-group latency floor (the
                    # RTT) should cost <= ~20% of the group's compute,
                    # i.e. n >= 5*RTT*rate/w. Recomputed per completion
                    # from the live EWMA, so a slowing link shrinks
                    # groups (less stranded work per flight) and a
                    # healthy one grows them (better amortisation).
                    w_avg = max(1, w // max(1, len(entries)))
                    n = 5.0 * self.rtt * self.rate / w_avg
                    n = 1 << max(1, int(np.ceil(n)) - 1).bit_length()
                    self.n_coal = int(min(16, max(2, n)))
                if len(entries) == 1:
                    seq, meta, _ = entries[0]
                    self._out_q.put(((seq, meta, arrs), self.idx))
                else:
                    # slice the fused group result back per batch: rows
                    # are row-aligned with the concatenation order; the
                    # pow2 padding tail is dropped
                    off = 0
                    for seq, meta, _ in entries:
                        rows = len(meta.lengths)
                        sl = tuple(a[off:off + rows] for a in arrs)
                        self._out_q.put(((seq, meta, sl), self.idx))
                        off += rows
            except BaseException as e:  # propagated by the caller
                self._err.append(e)
                with self.lock:
                    self.inflight -= w
                self._emit_failed(entries)


# backlog bound for deficit routing: a sink more than this many seconds
# behind (inflight / rate) stops receiving batches until it drains —
# this also bounds the end-of-stream tail a slow sink can add to the
# wall clock (its unfinished backlog is at most this much work), and
# the span of the ordered-consume frontier stall one slow high-RTT
# group can cause mid-stream
_SINK_BACKLOG_S = 0.4

# a measured sink whose EWMA rate falls below this share of the node's
# total stops receiving batches: its marginal contribution no longer
# covers the ordered-consume friction its slow groups cause.
_SINK_MIN_SHARE = 0.03

# how often an idle locked-out (below-min-share) sink gets one probe
# batch to refresh its EWMA — phases drift, lockouts must not be
# permanent. Cost per probe in a still-degraded phase: one singleton
# flight, bounded by the consumer's age-based unordered rescue.
_REPROBE_S = 10.0

# age past which an outstanding unordered remote batch is recomputed
# locally (see rescue_aged_unordered): bounds the read-index gap a
# slow remote fetch can open in the order-restoring emitters
_UNORDERED_RESCUE_S = 0.5

# a REMOTE (coalescing: probed RTT above _COALESCE_RTT_S) sink takes
# bulk work only when its EWMA rate is at least this fraction of the
# fastest local sink's. The output file is strictly read-ordered, so
# every code processed remotely delays its output slot by the link's
# latency; offload pays only when the remote device is at least
# comparable to the host engine. Locked-out remotes keep their EWMA
# fresh via the _REPROBE_S probes.
_REMOTE_WORTH_FRACTION = 0.5


def _pick_sink(sinks: list, w: int, rem_w: int | None = None):
    """Deficit-share routing: every measured sink earns credit in
    proportion to its EWMA throughput share and the highest-credit sink
    takes the batch — so each sink serves work proportional to what it
    can actually sustain. Unlike the earlier greedy earliest-finish
    rule this never structurally starves a slower-but-real sink: a
    device worth ~7% of the node's throughput gets ~7% of the batches
    instead of losing every single ETA comparison to the host engine.
    Throughput is unchanged when the
    producer is the bottleneck and strictly better when sinks are:
    proportional allocation is the max-throughput split of an
    oversubscribed stream.

    Unmeasured idle sinks are explored first (lowest index); sinks more
    than _SINK_BACKLOG_S behind are skipped until they drain (a dead
    link stops winning batches within one backlog window).

    ``rem_w`` (estimated codes still to come, from the caller's
    total-weight hint) tightens the backlog bound near end of stream: a
    sink only takes the batch if it can finish its backlog plus the
    batch before the rest of the stream drains through all sinks.
    Without this a slow remote sink's whole allowed backlog (up to
    _SINK_BACKLOG_S of work) turns into pure wall-clock tail after the
    last fast-sink batch completes."""
    for s in sinks:  # explore unmeasured idle sinks, in index order
        with s.lock:
            r, infl = s.rate, s.inflight
        if r == 0 and infl == 0:
            return s
    rates = []
    for s in sinks:
        with s.lock:
            rates.append((s.rate, s.inflight))
    total = sum(r for r, _ in rates if r > 0)
    if total <= 0:
        return min(sinks, key=lambda s: (s.eta(w), s.idx))
    backlog_cap = _SINK_BACKLOG_S
    if rem_w is not None:
        # time until the stream drains if every sink keeps serving its
        # proportional share; 0.9 leaves slack for estimate error
        backlog_cap = min(backlog_cap, 0.9 * rem_w / total)
    local_best = max(
        (r for s, (r, _) in zip(sinks, rates) if s._disp_q is None),
        default=0.0,
    )
    eligible = []
    now = time.perf_counter()
    for s, (r, infl) in zip(sinks, rates):
        if r <= 0:
            continue
        marginal = r / total < _SINK_MIN_SHARE and len(sinks) > 1
        if not marginal and s._disp_q is not None and local_best > 0:
            # remote sink beside a faster local engine: ordered output
            # serializes on every remote flight, so offload only pays
            # when the remote is at least comparable (see
            # _REMOTE_WORTH_FRACTION derivation)
            marginal = r < _REMOTE_WORTH_FRACTION * local_best
        if marginal:
            # marginal sink: friction outweighs contribution. But a
            # lockout must not be permanent — phases drift, and a
            # recovered link should win its share back: every
            # _REPROBE_S an idle locked-out sink gets ONE singleton
            # batch to refresh its EWMA (push dispatches it alone)
            if infl == 0 and now - s.last_routed > _REPROBE_S:
                s._probe_next = True
                return s
            continue
        cap = (2.0 * max(1, s.n_coal) + 2.0) * w
        s.credit = min(s.credit + w * (r / total), cap)
        if (infl + w) / r <= backlog_cap:
            eligible.append(s)
    if not eligible:
        return min(sinks, key=lambda s: (s.eta(w), s.idx))
    best = max(eligible, key=lambda s: (s.credit, -s.idx))
    best.credit -= w
    return best


def run_pipelined_hetero(
    batches: Iterable,
    dispatches: list,
    consume: Callable,
    weight: Callable,
    depth: int = 3,
    max_inflight: int = 8,
    keys: list | None = None,
    coalesce: list | None = None,
    rtts: list | None = None,
    total_weight: int | None = None,
    recompute: Callable | None = None,
    unordered_ok: Callable | None = None,
) -> None:
    """run_pipelined over MULTIPLE execution sinks (device sets).

    Batches are routed by deficit-share scheduling (see _pick_sink):
    every sink serves work in proportion to its live EWMA throughput.
    Sinks complete out of order; `consume` is still called in dispatch
    order (split reads spanning batch boundaries rely on it), buffered
    by a seq-number reorder. `max_inflight` bounds batches between
    dispatch and consumption so a stalled sink can't let a fast one
    fill RAM.

    `keys` (optional, parallel to `dispatches`) names each sink for the
    process-wide rate-prior table: a sink starts from the EWMA its key
    last converged to, so repeated runs skip the exploration batch that
    a slow remote sink turns into a multi-second head-of-line stall.

    `coalesce` (optional, parallel to `dispatches`) gives each sink a
    batch-coalescing group size (1 = off; see _HeteroSink). Sinks with
    group size > 1 require row-aligned dispatch results and
    planes()/lengths batches (io.batch.Batch). Buffered groups flush on
    shape change, on producer token pressure (so held batches can never
    deadlock the inflight bound), and at end of stream.

    `rtts` (optional, parallel to `dispatches`) carries each sink's
    probed device round-trip time for adaptive group sizing.

    `total_weight` (optional) estimates the stream's total weight
    (codes); when given, routing refuses to hand a slow sink work it
    cannot finish before the rest of the stream drains — bounding the
    end-of-stream tail a high-latency sink can add to the wall clock.

    `recompute` (optional): synchronous host fallback ``batch ->
    result arrays tuple`` with bit-identical semantics to the sinks.
    When the ordered-consume frontier sits on a REMOTE sink's batch and
    nothing arrives for a beat, the consumer recomputes that batch
    locally and drops the late original — a hung or slowed link costs
    a bounded hiccup instead of head-of-line-blocking the whole
    pipeline.

    `unordered_ok` (optional, requires `recompute`): predicate marking
    a batch SELF-CONTAINED — no read of it spans a batch boundary, so
    `consume` is commutative for it (the aggregator touches no carried
    partial state and the emitters reorder by read index anyway).
    Self-contained batches routed to a remote sink bypass the ordered
    seq chain entirely and consume on arrival: a slow remote result
    then never stalls the frontier — the ONLY cost of remote
    participation is its share of tokens. Stragglers at end of stream
    are recomputed locally, so a dead link still cannot lose output.
    """
    from kmertools_jax import ensure_hugepage_tuning

    ensure_hugepage_tuning()
    assert keys is None or len(keys) == len(dispatches), (
        f"keys ({len(keys)}) must parallel dispatches ({len(dispatches)})"
    )
    assert coalesce is None or len(coalesce) == len(dispatches)
    any_coal = coalesce is not None and max(coalesce) > 1
    if len(dispatches) == 1 and not any_coal:
        nb, nw = [0], [0]

        def counted(b):
            nb[0] += 1
            nw[0] += max(1, int(weight(b)))
            return dispatches[0](b)

        try:
            return run_pipelined(batches, counted, consume)
        finally:
            LAST_RUN_STATS[:] = [{
                "key": keys[0] if keys else "0",
                "batches": nb[0], "weight": nw[0], "rate": 0.0,
            }]

    if any_coal:
        # a coalescing sink exists because some device is a round trip
        # away. Ordered consume stalls on every in-flight remote group,
        # and tokens only recycle at consume — so the window must cover
        # the LATENCY x BANDWIDTH product of the fast sinks, or the
        # whole pipeline serialises on each remote round trip. Batches
        # are ~1-1.5 MB each; 256 in flight is ~350 MB.
        max_inflight = max(
            max_inflight,
            int(os.environ.get("KMERTOOLS_MAX_INFLIGHT", 384)),
        )
    out_q: queue.Queue = queue.Queue()
    err: list[BaseException] = []
    sinks = [
        _HeteroSink(i, d, out_q, err, depth,
                    key=keys[i] if keys else None,
                    n_coal=coalesce[i] if coalesce else 1,
                    rtt=rtts[i] if rtts else 0.0)
        for i, d in enumerate(dispatches)
    ]
    tokens = threading.Semaphore(max_inflight)

    # seq -> (meta, is_remote_sink, t_routed), kept until consumed: the
    # speculative-recompute path re-runs a stuck remote batch locally.
    # NEGATIVE seqs are unordered (self-contained) remote batches that
    # consume on arrival instead of through the ordered chain.
    routed_meta: dict[int, tuple] = {}
    routed_lock = threading.Lock()
    # total seq count, set by the producer at end of stream: the
    # consumer exits as soon as every seq is consumed, without waiting
    # for a drain thread still blocked on a slow remote fetch whose
    # result was already recomputed locally
    total_seqs = [None]
    unordered_left = [0]  # outstanding unordered batches (routed_lock)

    def consumer() -> None:
        pending: dict[int, tuple] = {}
        forced: set[int] = set()  # seqs consumed via recompute
        next_seq = 0
        done = 0
        last_advance = time.perf_counter()

        def drain_ready() -> None:
            nonlocal next_seq, last_advance
            while next_seq in pending:
                m, a = pending.pop(next_seq)
                try:
                    consume(m, *a)
                except BaseException as e:
                    err.append(e)
                with routed_lock:
                    routed_meta.pop(next_seq, None)
                tokens.release()
                next_seq += 1
                last_advance = time.perf_counter()

        def do_recompute(rseq: int, meta) -> None:
            try:
                arrs = recompute(meta)
                arrs = arrs if isinstance(arrs, tuple) else (arrs,)
                arrs = tuple(np.asarray(a) for a in arrs)
            except BaseException as e:
                err.append(e)
                return
            forced.add(rseq)
            if rseq >= 0:
                pending[rseq] = (meta, arrs)
                drain_ready()
            else:
                try:
                    consume(meta, *arrs)
                except BaseException as e:
                    err.append(e)
                with routed_lock:
                    routed_meta.pop(rseq, None)
                    unordered_left[0] -= 1
                tokens.release()

        def try_recompute() -> bool:
            """Recompute the stuck frontier batch on the host when it
            was routed to a remote sink. True if progress was made."""
            with routed_lock:
                ent = routed_meta.get(next_seq)
            if ent is None or not ent[1] or err:
                return False
            do_recompute(next_seq, ent[0])
            return True

        def finished() -> bool:
            if total_seqs[0] is None or next_seq < total_seqs[0]:
                return False
            with routed_lock:
                return unordered_left[0] == 0

        last_scan = [0.0]

        def rescue_aged_unordered() -> None:
            """Recompute unordered remote batches outstanding past
            _UNORDERED_RESCUE_S: the output FILE is read-ordered, so a
            multi-second remote fetch opens a read-index gap in the
            emitter and everything behind it formats/writes as a
            serial tail after the gap closes (measured 1.5-5 s of tax
            per slow reprobe batch). Age-based rescue bounds each
            incident at ~the threshold; the duplicated host work is
            ~15 ms per batch and the late original is dropped."""
            now = time.perf_counter()
            if now - last_scan[0] < 0.1 or err:
                return
            last_scan[0] = now
            with routed_lock:
                stuck = [
                    (s, m) for s, (m, _, t) in routed_meta.items()
                    if s < 0 and s not in forced
                    and now - t > _UNORDERED_RESCUE_S
                ]
            for s_neg, m in stuck:
                if err:
                    return
                do_recompute(s_neg, m)

        while done < len(sinks):
            if recompute is not None and finished():
                return  # everything consumed; don't wait on stragglers
            try:
                item, _idx = out_q.get(
                    timeout=0.1 if recompute is not None else None
                )
            except queue.Empty:
                while not err and try_recompute() and out_q.empty():
                    pass
                if recompute is not None:
                    rescue_aged_unordered()
                continue
            if item is None:
                done += 1
                continue
            seq, meta, arrs = item
            if seq in forced:
                forced.discard(seq)  # late original: already consumed
                continue
            if meta is None or err:  # dropped on error
                if seq < 0:
                    with routed_lock:
                        routed_meta.pop(seq, None)
                        unordered_left[0] -= 1
                tokens.release()
                continue
            if seq < 0:
                # unordered self-contained remote batch: consume NOW —
                # its rows touch no carried aggregator state and the
                # emitters reorder by read index
                try:
                    consume(meta, *arrs)
                except BaseException as e:
                    err.append(e)
                with routed_lock:
                    routed_meta.pop(seq, None)
                    unordered_left[0] -= 1
                tokens.release()
                continue
            pending[seq] = (meta, arrs)
            drain_ready()
            if recompute is not None:
                rescue_aged_unordered()

    ct = threading.Thread(target=consumer, daemon=True)
    ct.start()
    seq = 0
    nseq = -1  # unordered (self-contained remote) batches count down
    done_w = 0
    use_unordered = recompute is not None and unordered_ok is not None
    try:
        for b in batches:
            if err:
                break
            while not tokens.acquire(timeout=0.25):
                if err:
                    break
                # token pressure: batches held in coalescing buffers
                # account against max_inflight — flush them so their
                # tokens can cycle back through the consumer
                for s in sinks:
                    s.flush()
            if err:
                break
            w = max(1, int(weight(b)))
            rem_w = (
                max(0, total_weight - done_w)
                if total_weight is not None else None
            )
            sink = _pick_sink(sinks, w, rem_w)
            if sink._disp_q is not None and use_unordered:
                if unordered_ok(b):
                    # self-contained: bypass the ordered chain so a
                    # slow remote result can never stall the frontier
                    with routed_lock:
                        routed_meta[nseq] = (b, True, time.perf_counter())
                        unordered_left[0] += 1
                    sink.push(nseq, b, w)
                    nseq -= 1
                    done_w += w
                    continue
                # a boundary-spanning batch must consume in order —
                # keep it off the remote sink entirely (a stalled
                # frontier costs more than the remote's contribution)
                local = [s for s in sinks if s._disp_q is None]
                if local:
                    sink = min(local, key=lambda s: (s.eta(w), s.idx))
            if recompute is not None:
                with routed_lock:
                    routed_meta[seq] = (
                        b, sink._disp_q is not None, time.perf_counter()
                    )
            sink.push(seq, b, w)
            done_w += w
            seq += 1
    finally:
        # end of stream: move any UNDISPATCHED held groups to the
        # fastest measured sink — a partial group still waiting on a
        # high-latency sink would add that sink's whole round trip to
        # the wall clock for work a fast sink absorbs in milliseconds
        if any_coal:
            pend: list = []
            for s in sinks:
                pend.extend(s.take_pending())
            if pend:
                best = max(sinks, key=lambda s: (s.rate, -s.idx))
                if recompute is not None:
                    with routed_lock:
                        for seq_p, meta_p, _ in pend:
                            if seq_p in routed_meta:
                                routed_meta[seq_p] = (
                                    meta_p, best._disp_q is not None,
                                    time.perf_counter(),
                                )
                for seq_p, meta_p, w_p in sorted(pend, key=lambda e: e[0]):
                    best.push(seq_p, meta_p, w_p)
        for s in sinks:
            s.flush()
            # drain the dispatch worker first; with a recompute
            # fallback a worker stuck in a hung remote dispatch must
            # not stall the close (its batches were rescued locally)
            s.close_dispatch(
                timeout=None if recompute is None or err else 1.0
            )
            s.q.put(None)
        total_seqs[0] = seq  # consumer may now exit on full consumption
        ct.join()
        for s in sinks:
            # a drain thread can still be blocked on a slow remote
            # fetch whose batches were already recomputed locally —
            # don't make the caller wait for a result nobody needs
            # (daemon thread; its late EWMA update is still useful)
            s.thread.join(
                timeout=None if recompute is None or err else 0.25
            )
        LAST_RUN_STATS[:] = [
            {
                "key": keys[s.idx] if keys else str(s.idx),
                "batches": s.routed,
                "weight": s.routed_w,
                "rate": s.rate,
                "n_coal": s.n_coal,
                "groups": s.groups,
            }
            for s in sinks
        ]
        if os.environ.get("KMERTOOLS_HETERO_STATS") == "1":
            import sys

            for st in LAST_RUN_STATS:
                print(
                    f"[hetero] sink={st['key']} batches={st['batches']} "
                    f"weight={st['weight']} "
                    f"rate={st['rate'] / 1e6:.1f} Mcodes/s "
                    f"n_coal={st['n_coal']} groups={st['groups']}",
                    file=sys.stderr,
                )
    if err:
        raise err[0]


def oligo_hist_native_sink(ksize: int, nbins: int, count_min: bool,
                           threads: int):
    """The reference's oligo hot loop as a host sink: the multithreaded
    C++ rolling-encode+count kernel (kthost.cpp:kt_oligo_hist) joins
    the scheduler beside the XLA device programs. ctypes releases the
    GIL, so the sink's drain thread crunches on spare cores while the
    producer parses and the device computes. Shared by the oligo and
    oligo-CGR workloads (same histogram, different emitters). None when
    the native runtime is absent, k > 7, or hetero is disabled."""
    import ctypes

    import jax  # noqa: F401  (keep import ordering consistent)

    from kmertools_jax import native
    from kmertools_jax.utils import codec

    so = native.lib()
    if (
        so is None
        or ksize > 7
        or os.environ.get("KMERTOOLS_NO_HETERO") == "1"
    ):
        return None
    table = (
        np.ascontiguousarray(
            codec.canonical_slot_table(ksize), dtype=np.int32
        )
        if count_min
        else None
    )
    table_p = (
        table.ctypes.data_as(native.c_i32_p) if table is not None else None
    )
    nthreads = threads or (os.cpu_count() or 1)
    i16_p = ctypes.POINTER(ctypes.c_int16)

    def kernel(packed, vb):
        R = packed.shape[0]
        # the kernel writes counts straight into the fused
        # [counts | total] layout (cnt_stride = nbins + 1): no per-batch
        # concatenate copy, half the fresh-page faults
        fused = np.empty((R, nbins + 1), np.int16)
        totals = np.empty((R,), np.int32)
        rc = so.kt_oligo_hist(
            packed.ctypes.data_as(native.c_u8_p),
            vb.ctypes.data_as(native.c_u8_p),
            R, packed.shape[1] * 4, ksize,
            table_p, nbins,
            fused.ctypes.data_as(i16_p),
            totals.ctypes.data_as(native.c_i32_p),
            nthreads, nbins + 1,
        )
        if rc != 0:
            raise RuntimeError("kt_oligo_hist failed")
        fused[:, nbins] = totals  # row width <= 8192: fits int16
        return fused

    return native_hist_sink(kernel)


def plan_hetero_sinks(make_dispatch, native_sink, key_prefix: str,
                      target_codes: int, n_devices: int | None = None):
    """Standard sink assembly for the histogram workloads. Returns
    ``(dispatches, keys, stream_target, coalesce, rtts)``.

    Policy: on a CPU-only backend with a native kernel present the
    native engine runs alone — the XLA program would share (and lose)
    the same cores. Otherwise every hetero device set becomes an XLA
    sink (set index + device count in the key so same-platform sets
    keep separate rate priors) and the native kernel joins as one more
    sink; multi-sink runs cap the batch size for routing granularity —
    with a handful of mega-batches one slow-sink assignment decides the
    wall clock.

    ``coalesce`` (parallel to dispatches) carries each XLA sink's
    batch-coalescing group size from its device RTT probe (coalesce_for)
    — sinks whose probed RTT exceeds _COALESCE_RTT_S amortise their
    per-dispatch round trips
    over whole groups; local sinks and the native kernel stay at 1.
    ``rtts`` carries the probed RTTs for adaptive group sizing.
    ``n_devices`` limits the default backend's set to its first n
    devices (None = all)."""
    import jax

    device_sets = hetero_device_sets(n_devices)
    backend_cpu = (
        bool(jax.local_devices())
        and jax.local_devices()[0].platform == "cpu"
    )
    if native_sink is not None and backend_cpu and len(device_sets) == 1:
        # 2^22-code batches measured fastest for the engine-alone path
        # once formatting moved to the write-behind thread (round 5:
        # 1784 vs 1610 Mb/s at 2^21 — fewer per-batch Python turns)
        return (
            [native_sink],
            [f"{key_prefix}:native"],
            min(target_codes, 1 << 22),
            [1],
            [0.0],
        )
    if native_sink is not None:
        # the host-CPU XLA device set shares (and measured-loses on)
        # the same cores as the native kernel — scheduling both just
        # splits cache and steals threads (~10x slower than the native
        # kernel on the same cores). Keep accelerator sets only;
        # the CPU XLA set still serves KMERTOOLS_NO_NATIVE configs.
        device_sets = [
            d for d in device_sets
            if not (d and d[0].platform == "cpu")
        ] or device_sets
    dispatches = [
        make_dispatch(
            None if len(device_sets) == 1 and n_devices is None else d
        )
        for d in device_sets
    ]
    keys = [
        f"{key_prefix}:xla:{i}:"
        + (f"{d[0].platform}x{len(d)}" if d else "default")
        for i, d in enumerate(device_sets)
    ]
    coalesce = [coalesce_for(d) for d in device_sets]
    rtts = [
        probe_device_rtt(d[0]) if d else 0.0 for d in device_sets
    ]
    if native_sink is not None:
        dispatches.append(native_sink)
        keys.append(f"{key_prefix}:native")
        coalesce.append(1)
        rtts.append(0.0)
    stream_target = target_codes
    if len(dispatches) > 1 or max(coalesce) > 1:
        stream_target = min(stream_target, 1 << 22)
    return dispatches, keys, stream_target, coalesce, rtts


def batch_self_contained(b) -> bool:
    """True when no read of this batch spans a batch boundary: its
    first real row starts a read (row_start == 0) and its last real row
    ends one (last_row). For such batches the histogram consume path is
    commutative — the aggregator touches no carried partial state and
    the ordered emitters reorder by read index — so they may consume
    out of order (run_pipelined_hetero unordered_ok). Contig-scale
    corpora are almost entirely self-contained; only max-width-bucket
    splits ever produce boundary-spanning rows."""
    try:
        ri = np.asarray(b.read_idx)
        real = np.flatnonzero(ri >= 0)
        if len(real) == 0:
            return True
        return bool(
            b.row_start[real[0]] == 0 and b.last_row[real[-1]]
        )
    except (AttributeError, IndexError):
        return False


def estimate_stream_codes(path: str, shard=None) -> int | None:
    """Rough total-code (base-count) estimate for a stream, used only
    as the scheduler's end-of-stream hint (run_pipelined_hetero
    total_weight). Plain files only — gz/stdin return None (unknown).
    Deliberately conservative (an UNDER-estimate tightens the slow-sink
    cutoff earlier, which costs a little utilisation; an over-estimate
    would re-open the tail the hint exists to close)."""
    if path == "-" or path.endswith(".gz"):
        return None
    try:
        if shard is not None:
            size = max(0, int(shard.end) - int(shard.start))
        else:
            size = os.path.getsize(path)
    except (OSError, AttributeError, TypeError, ValueError):
        return None
    from kmertools_jax.io.fastx import SeqFormat, sniff_format

    fmt = sniff_format(path)
    # FASTA: bytes minus headers/newlines; FASTQ: ~half the record is
    # quality + plus-line
    factor = 0.45 if fmt is SeqFormat.FASTQ else 0.9
    return int(size * factor)


def native_hist_sink(kernel):
    """Host-sink wrapper shared by the native fused-histogram kernels
    (kt_oligo_hist, kt_cov_hist_idx): dispatch returns a lazy handle
    whose ``__array__`` runs ``kernel(packed, validbits) -> fused int16
    (R, nb + 1)`` (the device programs' ``[counts | total]`` layout,
    written in place by the kernel via its cnt_stride) on the batch's
    planes. The sink's drain thread triggers the compute via
    ``np.asarray``, so the kernel runs off the producer thread exactly
    like a device fetch."""

    class _H:
        __slots__ = ("b",)

        def __init__(self, b):
            self.b = b

        def __array__(self, dtype=None, copy=None):
            packed, vb, _ = self.b.planes()
            return kernel(packed, vb)

    return lambda b: _H(b)


def plan_producers(path: str, shard=None) -> int:
    """How many input-range producers to run (io.batch.
    multi_range_stream). Each producer owns a record-aligned byte range
    of the input and its own native parse-ahead thread, so host parsing
    scales across cores — the single-node analog of every rayon thread
    parsing from the reference's shared iterator
    (composition/src/oligo.rs:192-226).

    Policy: explicit KMERTOOLS_PRODUCERS wins (still clamped to 1
    without the native runtime — range streams are native-only). Auto:
    2 producers for a plain splittable file big enough for the split to
    matter (>=64 MB) on a host with >=4 cores; 1 otherwise. Multi-host
    shards keep a single producer (the host's range is already a
    split), as do stdin/gzip (not byte-splittable)."""
    from kmertools_jax import native

    if shard is not None or path == "-" or path.endswith(".gz"):
        return 1
    if native.lib() is None:
        return 1
    env = os.environ.get("KMERTOOLS_PRODUCERS")
    if env:
        return max(1, int(env))
    try:
        size = os.path.getsize(path)
    except OSError:
        return 1
    if size < (64 << 20) or (os.cpu_count() or 1) < 6:
        # measured on the 4-core dev box: the native histogram sink
        # already saturates every core, so extra parse threads only
        # thrash (1380 -> 1024 Mb/s at p=2). The single parse-ahead
        # thread tops out at ~2.1 GB/s; it becomes the wall — and this
        # split pays — once >=3 sink threads outrun it (6+ core hosts).
        return 1
    return 2


class PartedOutput:
    """Per-range output destinations for multi-producer runs.

    Range 0 writes straight into the final file (after any header the
    caller put there); ranges >0 write ``{out}.range_{r}`` part files
    that append in range order at close — the multi-host part/concat
    scheme (parallel/multihost.py:_concat_parts) applied in-process.
    ``writers[r]`` is the AsyncWriter for range ``r``. With one range
    this degenerates to a single AsyncWriter and no parts."""

    def __init__(self, raw, out_path: str, nparts: int):
        self._raw = raw
        self._out_path = out_path
        self._parts = [
            open(f"{out_path}.range_{r}", "wb") for r in range(1, nparts)
        ]
        self.writers = [AsyncWriter(raw)] + [
            AsyncWriter(f) for f in self._parts
        ]

    def close(self, success: bool) -> None:
        """Drain writers; on success append the parts to the final
        file. Part files are removed either way."""
        try:
            errs: list[BaseException] = []
            for w in self.writers:
                try:
                    w.close()
                except BaseException as e:
                    errs.append(e)
            for f in self._parts:
                f.close()
            if errs:
                raise errs[0]
            if success and self._parts:
                from kmertools_jax.parallel.multihost import _append_file

                for r in range(1, len(self._parts) + 1):
                    with open(f"{self._out_path}.range_{r}", "rb") as f:
                        _append_file(self._raw, f)
        finally:
            for r in range(1, len(self._parts) + 1):
                try:
                    os.unlink(f"{self._out_path}.range_{r}")
                except OSError:
                    pass


class AsyncWriter:
    """Write-behind wrapper for a binary file: ``write`` enqueues the
    chunk and returns; a drain thread performs the actual writes.

    This makes output a third pipeline stage: parse/upload (producer
    thread) | fetch/format (consumer thread) | disk (this thread). The
    box's disk writeback throttles in bursts (26-440 MB/s swings), and
    without this stage a stalled ``write`` blocks the fetch of the next
    batch even though the device is idle. The queue depth bounds
    buffered output chunks; errors surface on the next write/close.

    ``write`` also accepts a CALLABLE producing the chunk: it runs on
    the drain thread, so text formatting overlaps the next batch's
    compute instead of serialising with it on the fetch thread
    (measured ~0.5 s of the oligo bench wall, round 5). Queue order is
    preserved either way.
    """

    def __init__(self, f, depth: int = 8):
        self._f = f
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: list[BaseException] = []
        self._t = threading.Thread(target=self._drain, daemon=True)
        self._t.start()

    def _drain(self) -> None:
        while True:
            chunk = self._q.get()
            if chunk is None:
                return
            if self._err:
                continue  # drain so a bounded put never deadlocks
            try:
                if callable(chunk):
                    chunk = chunk()
                self._f.write(chunk)
            except BaseException as e:
                self._err.append(e)

    def write(self, data) -> None:
        if self._err:
            raise self._err[0]
        self._q.put(data)

    def close(self) -> None:
        """Drain and join; raises any deferred write error. Does NOT
        close the underlying file (callers own it)."""
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err[0]


class RowAggregator:
    """Aggregates per-row device outputs into per-read vectors.

    Rows of a split read arrive in order (same bucket); a read is
    complete when its `last_row` row has been seen. Completed reads are
    handed to `emit(read_idx, vector, total)`.
    """

    def __init__(self, emit: Callable[[int, np.ndarray, int], None]):
        self._emit = emit
        self._partial: dict[int, tuple[np.ndarray, int]] = {}

    def add_batch(
        self,
        read_idx: np.ndarray,
        last_row: np.ndarray,
        counts: np.ndarray,
        totals: np.ndarray,
    ) -> None:
        real = read_idx >= 0
        n = int(real.sum())
        if n == 0:
            return
        read_idx = read_idx[:n]
        last_row = last_row[:n]
        counts = counts[:n]
        totals = totals[:n]
        uniq, starts = np.unique(read_idx, return_index=True)
        grp_counts = np.add.reduceat(counts, starts, axis=0)
        grp_totals = np.add.reduceat(totals, starts)
        ends = np.append(starts[1:], n) - 1
        grp_done = last_row[ends]
        for ridx, vec, tot, done in zip(uniq, grp_counts, grp_totals, grp_done):
            ridx = int(ridx)
            if ridx in self._partial:
                pvec, ptot = self._partial.pop(ridx)
                vec = vec + pvec
                tot = tot + ptot
            if done:
                self._emit(ridx, vec, int(tot))
            else:
                self._partial[ridx] = (vec, int(tot))

    def finish(self) -> None:
        assert not self._partial, f"incomplete reads: {list(self._partial)[:5]}"


# number of shard_map (mesh) dispatches issued by DP-wrapped steps this
# process — observability for tests asserting the mesh path actually ran
MESH_DISPATCHES = 0


def data_parallel_rows(step, devices=None, n_repl=0):
    """Wrap a per-batch device step (one or more (R, ...) arrays ->
    pytree of row-aligned outputs) with shard_map over every visible
    device when more than one exists.

    The trailing `n_repl` arguments are REPLICATED (not row-sharded):
    lookup tables the whole mesh reads. They must be passed as runtime
    arguments, never closed over — a closure-captured concrete array
    becomes an XLA literal embedded in the program, which bloats every
    compile and the persistent compile cache by the table size per
    batch shape.

    This is the framework's DP axis: batch rows shard across the mesh
    (the device replacement for the reference's N work-stealing threads,
    composition/src/oligo.rs:192-226); each device runs the identical
    kernel on its row shard and outputs stay row-sharded, so the host
    sees one logical array. Output partition specs are derived from
    `jax.eval_shape`, so any output arity/rank works (histograms,
    window minima, whole-read minima...). Row counts that don't divide
    the device count (never the case for the power-of-two buckets) fall
    back to the single-device step.

    `devices` pins the step to an explicit device list (a heterogeneous
    sink: e.g. the accelerator mesh vs the host CPU devices); None uses
    every local device of the default backend. A single device gets the
    whole step as ONE jitted program placed on it — one dispatch per
    batch instead of one per op, which matters on high-RTT devices
    where every dispatch pays the round trip.
    """
    import jax

    ndev = len(devices) if devices is not None else jax.local_device_count()
    if ndev <= 1:
        jfn = jax.jit(step)
        if devices is None:
            return jfn
        dev = devices[0]

        def placed(*arrays):
            return jfn(*[jax.device_put(a, dev) for a in arrays])

        return placed

    from jax.sharding import PartitionSpec as P

    from jax import shard_map as _shard_map

    from kmertools_jax.parallel.mesh import DATA_AXIS, make_mesh, shard_batch

    mesh = make_mesh(devices=devices)
    cache: dict[tuple, Callable] = {}

    def wrapped(*arrays):
        global MESH_DISPATCHES
        nd = len(arrays) - n_repl
        data, repl = arrays[:nd], arrays[nd:]
        if any(a.shape[0] % ndev for a in data):
            return step(*arrays)
        key = tuple((a.shape, str(a.dtype)) for a in arrays)
        fn = cache.get(key)
        if fn is None:
            out_shapes = jax.eval_shape(
                step,
                *[jax.ShapeDtypeStruct(a.shape, a.dtype) for a in arrays],
            )
            specs = jax.tree.map(
                lambda s: P(DATA_AXIS, *([None] * (len(s.shape) - 1))),
                out_shapes,
            )
            fn = jax.jit(
                _shard_map(
                    step,
                    mesh=mesh,
                    in_specs=(
                        tuple(
                            P(DATA_AXIS, *([None] * (a.ndim - 1)))
                            for a in data
                        )
                        + tuple(P() for _ in repl)
                    ),
                    out_specs=specs,
                )
            )
            cache[key] = fn
        MESH_DISPATCHES += 1
        return fn(*[shard_batch(mesh, a) for a in data], *repl)

    return wrapped


# backwards-compatible name used by the histogram workloads
data_parallel_step = data_parallel_rows


class ArrayAggregator:
    """Vectorised RowAggregator: batches in, slabs of completed reads out.

    `add_batch` returns ``(ridx, vecs, tots)`` arrays covering every read
    completed by this batch (vecs float64 2-D, tots float64). Reads split
    across batch boundaries (rare: only max-width bucket splits) are
    carried in a small dict; everything else stays in numpy.
    """

    def __init__(self, ncols: int):
        self._ncols = ncols
        self._partial: dict[int, tuple[np.ndarray, float]] = {}

    def add_batch(self, read_idx, last_row, counts, totals):
        real = read_idx >= 0
        n = int(real.sum())
        if n == 0:
            return (
                np.empty(0, np.int64),
                np.empty((0, self._ncols), np.float64),
                np.empty(0, np.float64),
            )
        read_idx = read_idx[:n]
        last_row = last_row[:n]
        counts = counts[:n]
        totals = totals[:n]
        uniq, starts = np.unique(read_idx, return_index=True)
        if len(uniq) == n and bool(last_row.all()) and not self._partial:
            # fast path: every row is a complete single-row read — keep
            # the device dtypes (int16/int32) for the fused native emit
            return uniq, counts, totals
        counts = counts.astype(np.float64)
        totals = totals.astype(np.float64)
        grp_counts = np.add.reduceat(counts, starts, axis=0)
        grp_totals = np.add.reduceat(totals, starts)
        ends = np.append(starts[1:], n) - 1
        grp_done = last_row[ends]
        if self._partial:
            for i, ridx in enumerate(uniq):
                ridx = int(ridx)
                if ridx in self._partial:
                    pvec, ptot = self._partial.pop(ridx)
                    grp_counts[i] += pvec
                    grp_totals[i] += ptot
        done = np.asarray(grp_done, dtype=bool)
        for i in np.flatnonzero(~done):
            self._partial[int(uniq[i])] = (grp_counts[i], float(grp_totals[i]))
        return uniq[done], grp_counts[done], grp_totals[done]

    def finish(self) -> None:
        assert not self._partial, f"incomplete reads: {list(self._partial)[:5]}"


class OrderedArrayEmitter:
    """Vectorised OrderedEmitter: buffers out-of-order completed-read
    slabs and flushes the contiguous read-index prefix as one slab via
    ``write(vecs, tots)``.

    With a single active length bucket (uniform corpora) every incoming
    slab is already the contiguous prefix and passes straight through.
    """

    def __init__(self, write: Callable[[np.ndarray, np.ndarray], None],
                 flush_rows: int = 4096):
        self._write = write
        self._flush_rows = flush_rows
        self._next = 0
        self._ridx: list[np.ndarray] = []
        self._vecs: list[np.ndarray] = []
        self._tots: list[np.ndarray] = []
        self._buffered = 0
        self._min_pending = None  # smallest buffered ridx (gap sentinel)

    def add(self, ridx: np.ndarray, vecs: np.ndarray, tots: np.ndarray) -> None:
        if len(ridx) == 0:
            return
        if (
            not self._buffered
            and ridx[0] == self._next
            and len(ridx) == ridx[-1] - ridx[0] + 1
        ):
            # contiguous prefix: write through without buffering
            self._write(vecs, tots)
            self._next += len(ridx)
            return
        self._ridx.append(np.asarray(ridx))
        self._vecs.append(vecs)
        self._tots.append(tots)
        self._buffered += len(ridx)
        lo = int(np.min(ridx))
        if self._min_pending is None or lo < self._min_pending:
            self._min_pending = lo
        # only attempt a flush once the write frontier is actually
        # buffered: while a gap is open (an out-of-order batch still in
        # flight), sorting the buffer cannot emit anything — and doing
        # it on every threshold crossing re-concatenates + re-argsorts
        # an ever-growing buffer, measured as 30-44 s of consumer-thread
        # CPU when a slow remote batch opened a multi-second gap
        if (
            self._buffered >= self._flush_rows
            and self._min_pending == self._next
        ):
            self._flush()

    def _flush(self) -> None:
        ridx = np.concatenate(self._ridx)
        order = np.argsort(ridx, kind="stable")
        ridx = ridx[order]
        vecs = np.concatenate(self._vecs, axis=0)[order]
        tots = np.concatenate(self._tots)[order]
        # contiguous prefix starting at self._next
        run = np.flatnonzero(ridx != self._next + np.arange(len(ridx)))
        cut = int(run[0]) if len(run) else len(ridx)
        if cut:
            self._write(vecs[:cut], tots[:cut])
            self._next += cut
        if cut < len(ridx):
            self._ridx = [ridx[cut:]]
            self._vecs = [vecs[cut:]]
            self._tots = [tots[cut:]]
            self._buffered = len(ridx) - cut
            self._min_pending = int(ridx[cut])
        else:
            self._ridx, self._vecs, self._tots = [], [], []
            self._buffered = 0
            self._min_pending = None

    def finish(self) -> None:
        if self._buffered:
            self._flush()
        assert not self._buffered, "gap in read ordering at finish"


class OrderedEmitter:
    """Reorders (read_idx, payload) arrivals and flushes the contiguous
    prefix in blocks via `write(list_of_payloads)`."""

    def __init__(self, write: Callable[[list], None], block: int = 4096):
        self._write = write
        self._block = block
        self._next = 0
        self._pending: dict[int, object] = {}
        self._ready: list = []

    def bypass(self, start: int, count: int) -> bool:
        """True (and advance) iff [start, start+count) is exactly the
        next contiguous run and nothing is buffered: the caller may
        write that block itself, skipping per-item buffering (the slab
        fast path — on uniform corpora every slab qualifies)."""
        if self._pending or self._ready or start != self._next:
            return False
        self._next += count
        return True

    def add(self, read_idx: int, payload) -> None:
        self._pending[read_idx] = payload
        while self._next in self._pending:
            self._ready.append(self._pending.pop(self._next))
            self._next += 1
            if len(self._ready) >= self._block:
                self._write(self._ready)
                self._ready = []

    def finish(self) -> None:
        if self._ready:
            self._write(self._ready)
            self._ready = []
        assert not self._pending, "gap in read ordering at finish"
