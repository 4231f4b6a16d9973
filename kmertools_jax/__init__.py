"""kmertools_jax — accelerator DNA vectorisation in JAX.

A from-scratch JAX/XLA re-design of the capabilities of `kmertools`
(a Rust CLI + PyO3 library).

Workloads (reference README.md:36-42):
  * Oligonucleotide frequency vectors  (k = 3..7)     -> workloads.oligo
  * Exact k-mer counting               (k = 10..31)   -> workloads.counter
  * Minimiser binning                                 -> workloads.minimisers
  * Chaos Game Representation (CGR) vectors           -> workloads.cgr
  * Coverage histograms                               -> workloads.coverage

Design: host I/O (io/) produces fixed-shape padded code batches; device
kernels (ops/) compute k-mer ids as static shift-add windows, per-read
histograms as scatter-adds or one-hot matrix products, minimisers as
vectorised sliding-window minima, CGR as a scanned linear recurrence
and counting as multi-key sort + run-length encoding; parallel/ scales
the same kernels over a `jax.sharding.Mesh` with shard_map +
collectives.
"""

import os as _os

from kmertools_jax.version import __version__

__all__ = ["__version__"]


# compile cache used when JAX_COMPILATION_CACHE_DIR is unset: one fixed
# path inside the checkout (listed in .gitignore), so every process of
# every run finds the programs an earlier one compiled
_DEFAULT_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)


def _configure_jax() -> None:
    """Enable JAX's persistent compilation cache (opt-out via
    KMERTOOLS_NO_JAX_CACHE).

    Where ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself and
    nothing is set here; otherwise the cache lives at `_DEFAULT_CACHE`.
    Every batch-bucket shape then compiles once and is reused by later
    runs (CLI invocations, bench, pipelines)."""
    if _os.environ.get("KMERTOOLS_NO_JAX_CACHE"):
        return
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def _tune_hugepages() -> None:
    """Disable numpy's MADV_HUGEPAGE on hosts where transparent-huge-
    page faults are pathological.

    numpy madvises THP for every allocation >= 4 MB. On lazily-paged
    VMs (snapshot-restored / ballooned microVMs) each 2 MB huge-page
    fault can cost 7-150 ms — measured here: first touch of a fresh
    240 MB numpy array 1.1-15.5 s with THP vs ~0.12 s without, which
    dominated the counter's drain phase in cold processes. Probe the
    madvised fault cost; if slow, flip numpy's runtime switch and
    export NUMPY_MADVISE_HUGEPAGE=0 for child processes.

    The probe maps FRESH anonymous pages via mmap each time — an
    allocation-based probe (used until round 3) can read a recycled
    arena whose pages are already populated and report "fast" on a
    host whose fresh faults run at 200 MB/s. And the pathology DRIFTS
    on this host (the same boot measured both 4.5 GB/s and 0.2 GB/s
    madvised fills hours apart), so the cached verdict carries a TTL
    instead of living for the whole boot. KMERTOOLS_HUGEPAGES=1 skips
    all of this.

    Long-lived processes must NOT trust the import-time verdict: call
    ``ensure_hugepage_tuning()`` at pipeline entry — it re-runs this
    probe when the TTL has lapsed. (Round-5 finding: a bench process
    whose "fast" verdict went stale mid-session crawled at 10-150 ms
    per fresh 2 MB numpy fault while subprocesses re-probed at import
    and ran fine — the round-4 driver-capture regression class.)
    """
    global _last_probe_ts
    if _os.environ.get("KMERTOOLS_HUGEPAGES") == "1":
        return
    _last_probe_ts = __import__("time").monotonic()
    if _os.environ.get("NUMPY_MADVISE_HUGEPAGE") == "0":
        return  # already off (env read by numpy at import)
    try:
        import numpy as _np
    except Exception:
        return
    _set = None
    for _mod in ("_core", "core"):
        _mu = getattr(getattr(_np, _mod, None), "multiarray", None)
        _set = getattr(_mu, "_set_madvise_hugepage", None)
        if _set is not None:
            break
    if _set is None:
        return
    cache_dir = _os.path.join(
        _os.environ.get("XDG_CACHE_HOME", _os.path.expanduser("~/.cache")),
        "kmertools_jax",
    )
    probe_file = _os.path.join(cache_dir, "hugepage_probe")
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot_id = f.read().strip()
    except OSError:
        boot_id = ""
    import time as _time

    ttl = float(_os.environ.get("KMERTOOLS_HUGEPAGE_PROBE_TTL", 600))
    verdict = None
    if boot_id:  # no boot id -> no way to validate a cached verdict
        try:
            with open(probe_file) as f:
                fields = f.read().split()
                b, v = fields[0], fields[1]
                ts = float(fields[2]) if len(fields) > 2 else 0.0
                if b == boot_id and _time.time() - ts < ttl:
                    verdict = v == "slow"
        except Exception:
            pass
    if verdict is None:
        import mmap as _mmap

        # Touch one byte per 4 KB page of a fresh 32 MB anonymous map,
        # madvised vs not. Fresh mappings can't be masked by a warm
        # allocator arena; 16 huge-region faults make a sick host
        # unmistakable (>= 100 ms) while a healthy one pays ~15 ms.
        # MAP_PRIVATE is load-bearing: python's mmap defaults to
        # MAP_SHARED = shmem, where MADV_HUGEPAGE is a no-op (shmem THP
        # has its own sysfs knob, usually off) and the probe would
        # always read "fast". The slow path being probed is the
        # kernel's direct compaction attempt per madvised 2 MB fault —
        # it can fail (fragmented balloon) yet still cost ~7 ms, which
        # is why AnonHugePages can read 0 while the fill runs 10x slow.
        def _fill(madv: bool) -> float:
            sz = 32 << 20
            m = _mmap.mmap(
                -1, sz, flags=_mmap.MAP_PRIVATE | _mmap.MAP_ANONYMOUS
            )
            try:
                if madv:
                    m.madvise(_mmap.MADV_HUGEPAGE)
                t0 = _time.perf_counter()
                for off in range(0, sz, 4096):
                    m[off] = 1
                return _time.perf_counter() - t0
            finally:
                m.close()

        try:
            t_on = _fill(True)
            t_off = _fill(False)
            verdict = t_on > 0.05 and t_on > 5 * t_off
        except Exception:
            return
        if boot_id:
            try:
                _os.makedirs(cache_dir, exist_ok=True)
                with open(probe_file, "w") as f:
                    f.write(
                        f"{boot_id} {'slow' if verdict else 'fast'} "
                        f"{_time.time():.0f}\n"
                    )
            except OSError:
                pass
    if not verdict:
        return
    _os.environ["NUMPY_MADVISE_HUGEPAGE"] = "0"  # child processes
    _set(False)


_last_probe_ts = 0.0


def ensure_hugepage_tuning() -> None:
    """Re-validate the hugepage verdict when its TTL has lapsed.

    The import-time probe's "fast" verdict can go stale inside a
    long-lived process (this host's THP fault cost drifts on a ~10-min
    scale); pipelines call this at entry so a degraded phase flips
    numpy's madvise off mid-process instead of paying 10-150 ms per
    fresh 2 MB fault for the rest of the run. No-ops (one dict lookup)
    while the verdict is fresh or already "slow"."""
    if _os.environ.get("NUMPY_MADVISE_HUGEPAGE") == "0":
        return
    import time as _time

    ttl = float(_os.environ.get("KMERTOOLS_HUGEPAGE_PROBE_TTL", 600))
    if _time.monotonic() - _last_probe_ts < ttl:
        return
    _tune_hugepages()


_configure_jax()
_tune_hugepages()
