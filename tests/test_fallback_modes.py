"""Enforce the dual-mode invariant (CLAUDE.md): every native/C++ fast
path has a pure-Python/XLA fallback behind KMERTOOLS_NO_NATIVE=1, and
golden parity must hold in both modes. These subprocess runs make a default `pytest`
fail if either fallback regresses.

Also covers the CGR x64 activation contract: a plain CLI process (no
x64 preset) must enable x64 itself and run the device scan kernel
(VERDICT r1 weak#2; composition/src/cgr.rs:127-144 exactness).
"""

import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pythonpath() -> str:
    parts = [_REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    return os.pathsep.join(dict.fromkeys(parts))


_BOOT = (
    "import jax; jax.config.update('jax_platforms','cpu'); "
    "import sys; from kmertools_jax.cli import main; "
    "sys.exit(main(sys.argv[1:]))"
)


def _run_cli(args, extra_env, cwd):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = _pythonpath()
    env.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    env["KMERTOOLS_QUIET"] = "1"
    env["KMERTOOLS_TARGET_CODES"] = str(1 << 16)
    env.update(extra_env)
    return subprocess.run(
        [sys.executable, "-c", _BOOT, *args],
        env=env, cwd=cwd, capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize(
    "mode", [{"KMERTOOLS_NO_NATIVE": "1"}], ids=["no-native"],
)
def test_oligo_golden_in_fallback_mode(tmp_path, test_data, mode):
    out = tmp_path / "out.kmers"
    r = _run_cli(
        ["comp", "oligo", "-i", str(test_data / "reads.fq"),
         "-o", str(out), "-k", "4"],
        mode, tmp_path,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.read_bytes() == (test_data / "expected_fa.kmers").read_bytes()


@pytest.mark.parametrize(
    "mode", [{"KMERTOOLS_NO_NATIVE": "1"}], ids=["no-native"],
)
def test_min_m2s_golden_in_fallback_mode(tmp_path, test_data, mode):
    from kmertools_jax.utils.fops import load_lines_sorted

    out = tmp_path / "mins"
    r = _run_cli(
        ["min", "-i", str(test_data / "reads.fq"), "-o", str(out),
         "-m", "10", "-p", "m2s"],
        mode, tmp_path,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert load_lines_sorted(str(out)) == load_lines_sorted(
        str(test_data / "expected_minimisers")
    )


def test_cgr_cli_enables_x64_and_runs_device_kernel(tmp_path, test_data):
    """A fresh process without x64 preset must still take the device
    cgr_scan path (and produce golden bytes)."""
    out = tmp_path / "out.cgr"
    code = (
        "import jax; jax.config.update('jax_platforms','cpu'); "
        "import sys; "
        "assert not jax.config.read('jax_enable_x64'); "
        "from kmertools_jax.workloads import cgr as m; "
        "c = m.CgrComputer(sys.argv[1], sys.argv[2], 1); "
        "c.vectorise(); "
        "assert m.DEVICE_SCAN_RUNS > 0, 'device scan never ran'; "
        "assert m._f64_supported()"
    )
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("JAX_ENABLE_X64", None)
    env["PYTHONPATH"] = _pythonpath()
    env.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    env["KMERTOOLS_QUIET"] = "1"
    r = subprocess.run(
        [sys.executable, "-c", code, str(test_data / "reads.fq"), str(out)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.read_bytes() == (test_data / "expected_reads.cgr").read_bytes()


def test_min_modes_agree_on_random_mixed_corpus(tmp_path):
    """Randomised cross-mode equality: the native engine path, the
    pure-Python/XLA fallback, and the hetero-disabled device path must
    produce byte-identical s2m AND m2s output on a corpus with
    ambiguous bases, empty reads, and lengths spanning the split-row
    threshold — the minimiser emission semantics are the hardest
    contract in the framework and the golden corpus is only 2 reads."""
    import numpy as np

    rng = np.random.default_rng(99)
    fa = tmp_path / "mix.fa"
    with open(fa, "wb") as f:
        for i in range(60):
            if i % 17 == 0:
                L = 0
            elif i % 5 == 0:
                L = int(rng.integers(9000, 11000))  # split rows
            else:
                L = int(rng.integers(1, 400))
            seq = rng.choice(
                list(b"ACGTN"), size=L, p=[0.245, 0.245, 0.245, 0.245, 0.02]
            ).astype(np.uint8)
            f.write(b">r%d\n%s\n" % (i, seq.tobytes()))
    outs: dict = {}
    for name, env in (
        ("default", {}),
        ("no-native", {"KMERTOOLS_NO_NATIVE": "1"}),
        ("no-hetero", {"KMERTOOLS_NO_HETERO": "1"}),
    ):
        for p in ("s2m", "m2s"):
            out = tmp_path / f"{name}.{p}"
            r = _run_cli(
                ["min", "-i", str(fa), "-o", str(out), "-m", "10",
                 "-w", "31", "-p", p],
                env, str(tmp_path),
            )
            assert r.returncode == 0, (name, p, r.stderr[-400:])
            outs[(name, p)] = out.read_bytes()
    for p in ("s2m", "m2s"):
        assert outs[("no-native", p)] == outs[("default", p)], p
        assert outs[("no-hetero", p)] == outs[("default", p)], p
