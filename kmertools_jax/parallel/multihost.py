"""Multi-host execution runtime (SURVEY.md §5 "distributed comm
backend").

The reference is a single process; its scale-out axis is threads over a
shared iterator (counter/src/lib.rs:20,119). The multi-host equivalent
splits the INPUT over hosts at record-aligned byte ranges
(parallel/dataflow.py) — each host streams its shard through its local
devices (DP inside the workload) and writes an output part; host 0
concatenates parts in shard order. Only coordination metadata crosses
the network between hosts, as SURVEY.md §5 prescribes ("DCN only for
host-level read distribution and final gather").

One process per machine: a JAX process reserves most of each card's
memory when it starts, so a second process on the same card fails for
want of memory.

Two coordination modes:
  * ``coordinator`` given: `jax.distributed.initialize` connects every
    process to the JAX coordination service (the real multi-host
    runtime across machines; also works between CPU processes) and its
    key-value barrier gates the final concatenation.
  * no coordinator (shared filesystem): a marker + per-host ack-file
    protocol. Non-primary hosts write their part, drop an ack, and
    exit; host 0 waits for every ack, concatenates, and cleans up.
    Only host 0 ever deletes coordination files, so there is no
    delete-while-polling race.

Usage (every host runs the same command):

    kmertools comp oligo -i big.fq -o out.kmers -k 4 \
        --num-hosts 4 --host-id $RANK [--coordinator host0:8476]
"""

from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass

from kmertools_jax.parallel import dataflow

_POLL_S = 0.05
_TIMEOUT_S = float(os.environ.get("KMERTOOLS_MH_TIMEOUT", 600))


@dataclass
class HostContext:
    num_hosts: int
    host_id: int
    coordinator: str | None = None
    _client: object | None = None

    @property
    def is_primary(self) -> bool:
        return self.host_id == 0

    def shard_for(self, path: str) -> dataflow.Shard:
        return dataflow.split_file(path, self.num_hosts)[self.host_id]

    def part_path(self, out_path: str) -> str:
        return f"{out_path}.part_{self.host_id}"


def init(num_hosts: int, host_id: int, coordinator: str | None = None) -> HostContext:
    """Validate + (optionally) join the jax.distributed runtime."""
    if not (0 <= host_id < num_hosts):
        raise ValueError(f"host-id {host_id} outside [0, {num_hosts})")
    ctx = HostContext(num_hosts=num_hosts, host_id=host_id, coordinator=coordinator)
    if coordinator:
        import jax

        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_hosts,
            process_id=host_id,
        )
        from jax._src import distributed as _dist

        ctx._client = _dist.global_state.client
    return ctx


def _concat_parts(ctx: HostContext, out_path: str) -> None:
    # host 0's part becomes the output by rename (free — typically the
    # largest single copy saved); the rest append via sendfile (kernel
    # zero-copy; the final concat is the only serial stage of a
    # multi-host run, measured ~10% of 2-host oligo wall before this)
    os.replace(f"{out_path}.part_0", out_path)
    with open(out_path, "r+b") as out:
        out.seek(0, os.SEEK_END)
        for i in range(1, ctx.num_hosts):
            part = f"{out_path}.part_{i}"
            with open(part, "rb") as f:
                _append_file(out, f)
            os.unlink(part)


def _append_file(out, f) -> None:
    """Append f's full contents at out's current position (sendfile
    when the kernel allows, buffered copy otherwise)."""
    size = os.fstat(f.fileno()).st_size
    off = 0
    out.flush()
    try:
        while off < size:
            sent = os.sendfile(out.fileno(), f.fileno(), off, size - off)
            if sent == 0:
                break
            off += sent
        if off >= size:
            return
    except OSError:
        pass
    f.seek(off)
    shutil.copyfileobj(f, out, 1 << 22)


def _finalize_kv(ctx: HostContext, out_path: str) -> None:
    """Coordinator mode: kv-store barriers, no files."""
    ctx._client.wait_at_barrier(
        "kt_parts", timeout_in_ms=int(_TIMEOUT_S * 1000)
    )
    if ctx.is_primary:
        _concat_parts(ctx, out_path)
    # keep every client attached until the concat is done (a client
    # exiting early can fail the coordination service's heartbeats)
    ctx._client.wait_at_barrier(
        "kt_concat", timeout_in_ms=int(_TIMEOUT_S * 1000)
    )


def _finalize_fs(ctx: HostContext, out_path: str) -> None:
    """Shared-filesystem mode: marker + acks; only host 0 deletes."""
    marker = f"{out_path}.mh"
    if ctx.is_primary:
        nonce = f"{os.getpid()}_{time.time_ns()}"
        rundir = f"{out_path}.mh_{nonce}"
        os.makedirs(rundir, exist_ok=True)
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            f.write(nonce)
        os.replace(tmp, marker)  # atomic publish
    else:
        deadline = time.time() + _TIMEOUT_S
        while not os.path.exists(marker):
            if time.time() > deadline:
                raise TimeoutError("multihost marker from host 0 never appeared")
            time.sleep(_POLL_S)
        with open(marker) as f:
            nonce = f.read().strip()
        rundir = f"{out_path}.mh_{nonce}"
    # my part is already on disk: ack it
    with open(os.path.join(rundir, f"ack_{ctx.host_id}"), "w") as f:
        f.write("done")
    if not ctx.is_primary:
        return  # done; host 0 owns the gather + cleanup
    deadline = time.time() + _TIMEOUT_S
    want = [os.path.join(rundir, f"ack_{i}") for i in range(ctx.num_hosts)]
    while not all(os.path.exists(p) for p in want):
        if time.time() > deadline:
            missing = [p for p in want if not os.path.exists(p)]
            raise TimeoutError(f"multihost acks missing: {missing}")
        time.sleep(_POLL_S)
    _concat_parts(ctx, out_path)
    shutil.rmtree(rundir, ignore_errors=True)
    os.unlink(marker)


def finalize_parts(ctx: HostContext, out_path: str) -> None:
    """Gather barrier; host 0 concatenates parts in shard order into
    `out_path` and removes them."""
    if ctx._client is not None:
        _finalize_kv(ctx, out_path)
    else:
        _finalize_fs(ctx, out_path)


def rendezvous(ctx: HostContext, dirpath: str, name: str,
               timeout_s: float | None = None) -> None:
    """All hosts arrive at `name`; when this returns on the PRIMARY,
    every host has arrived (so their shared-dir writes are complete).

    fs mode: non-primary hosts drop an ack file and return immediately
    (their work is done; only host 0 continues to a gather step).
    kv mode: a true barrier — everyone blocks until all arrive.
    """
    t = timeout_s or _TIMEOUT_S
    if ctx._client is not None:
        ctx._client.wait_at_barrier(f"kt_{name}", timeout_in_ms=int(t * 1000))
        return
    with open(os.path.join(dirpath, f".kt_{name}_ack_{ctx.host_id}"), "w") as f:
        f.write("done")
    if not ctx.is_primary:
        return
    want = [
        os.path.join(dirpath, f".kt_{name}_ack_{i}")
        for i in range(ctx.num_hosts)
    ]
    deadline = time.time() + t
    while not all(os.path.exists(p) for p in want):
        if time.time() > deadline:
            missing = [p for p in want if not os.path.exists(p)]
            raise TimeoutError(f"rendezvous '{name}' missing acks: {missing}")
        time.sleep(_POLL_S)
    for p in want:  # only the primary ever deletes
        os.unlink(p)


def release(ctx: HostContext, name: str, timeout_s: float | None = None) -> None:
    """kv mode: hold every client attached until the primary finishes
    its post-rendezvous work (heartbeat safety). fs mode: no-op —
    non-primary hosts already returned from rendezvous()."""
    if ctx._client is not None:
        t = timeout_s or _TIMEOUT_S
        ctx._client.wait_at_barrier(f"kt_{name}_done", timeout_in_ms=int(t * 1000))


def gate_open(ctx: HostContext, dirpath: str, name: str) -> None:
    """Primary publishes 'name happened' (fs mode marker). Multi-host
    runs require a FRESH working dir — a stale marker from a previous
    run in the same dir would open the gate early."""
    if ctx._client is not None:
        return  # kv mode synchronises via release()
    with open(os.path.join(dirpath, f".kt_{name}_open"), "w") as f:
        f.write("open")


def gate_wait(ctx: HostContext, dirpath: str, name: str,
              timeout_s: float | None = None) -> None:
    """Block until the primary opened the gate (fs mode only; kv mode
    callers synchronise through release())."""
    if ctx._client is not None or ctx.is_primary:
        return
    marker = os.path.join(dirpath, f".kt_{name}_open")
    deadline = time.time() + (timeout_s or _TIMEOUT_S)
    while not os.path.exists(marker):
        if time.time() > deadline:
            raise TimeoutError(f"gate '{name}' never opened")
        time.sleep(_POLL_S)
