"""The per-boot hugepage probe (kmertools_jax.__init__._tune_hugepages).

numpy madvises MADV_HUGEPAGE for allocations >= 4 MB; on lazily-paged
VMs each 2 MB huge-page fault can cost ~150 ms, so the package import
probes the cost once per boot and disables numpy's madvise when it is
pathological. These tests pin the control surface: the cached verdict
is honoured, and the opt-outs short-circuit the probe.
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, tmp_path, extra_env=None) -> str:
    env = dict(os.environ)
    env.pop("NUMPY_MADVISE_HUGEPAGE", None)
    env.pop("KMERTOOLS_HUGEPAGES", None)
    env["XDG_CACHE_HOME"] = str(tmp_path)  # isolate the probe cache
    parts = [_REPO] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p
    ]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
    if extra_env:
        env.update(extra_env)
    out = subprocess.run(
        [sys.executable, "-c", code], env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout


def _boot_id() -> str:
    with open("/proc/sys/kernel/random/boot_id") as f:
        return f.read().strip()


def _seed(tmp_path, verdict: str, age_s: float = 0.0) -> None:
    import time

    d = tmp_path / "kmertools_jax"
    d.mkdir(parents=True, exist_ok=True)
    (d / "hugepage_probe").write_text(
        f"{_boot_id()} {verdict} {time.time() - age_s:.0f}\n"
    )


def test_cached_slow_verdict_disables_numpy_madvise(tmp_path):
    _seed(tmp_path, "slow")
    out = _run(
        "import kmertools_jax, os;"
        "print(os.environ.get('NUMPY_MADVISE_HUGEPAGE'))",
        tmp_path,
    )
    assert out.strip() == "0"


def test_cached_fast_verdict_leaves_numpy_alone(tmp_path):
    _seed(tmp_path, "fast")
    out = _run(
        "import kmertools_jax, os;"
        "print(os.environ.get('NUMPY_MADVISE_HUGEPAGE'))",
        tmp_path,
    )
    assert out.strip() == "None"


def test_opt_out_skips_probe(tmp_path):
    out = _run(
        "import kmertools_jax, os;"
        "print(os.path.exists(os.path.join("
        "os.environ['XDG_CACHE_HOME'], 'kmertools_jax', 'hugepage_probe')))",
        tmp_path,
        extra_env={"KMERTOOLS_HUGEPAGES": "1"},
    )
    assert out.strip() == "False"


def test_probe_runs_and_caches_once(tmp_path):
    out = _run(
        "import kmertools_jax, os;"
        "p = os.path.join(os.environ['XDG_CACHE_HOME'],"
        " 'kmertools_jax', 'hugepage_probe');"
        "print(open(p).read().split()[1])",
        tmp_path,
    )
    assert out.strip() in ("slow", "fast")


def test_expired_verdict_reprobes(tmp_path):
    """The host pathology DRIFTS within a boot (direct compaction
    succeeds or fails with balloon fragmentation), so a cached verdict
    older than the TTL must be re-measured, not trusted."""
    _seed(tmp_path, "slow", age_s=10_000)
    out = _run(
        "import kmertools_jax, os;"
        "p = os.path.join(os.environ['XDG_CACHE_HOME'],"
        " 'kmertools_jax', 'hugepage_probe');"
        "f = open(p).read().split();"
        "import time; print(time.time() - float(f[2]) < 300)",
        tmp_path,
    )
    # the probe file was rewritten with a fresh timestamp
    assert out.strip() == "True"


def test_legacy_two_field_cache_is_stale(tmp_path):
    """Round-2 cache files (no timestamp) must not satisfy the TTL."""
    d = tmp_path / "kmertools_jax"
    d.mkdir(parents=True, exist_ok=True)
    (d / "hugepage_probe").write_text(f"{_boot_id()} fast\n")
    out = _run(
        "import kmertools_jax, os;"
        "p = os.path.join(os.environ['XDG_CACHE_HOME'],"
        " 'kmertools_jax', 'hugepage_probe');"
        "print(len(open(p).read().split()))",
        tmp_path,
    )
    assert out.strip() == "3"  # rewritten in the 3-field form
