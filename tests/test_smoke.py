"""CPU checks of what surrounds the chip run: chip_smoke.py's input
generators and byte comparers, the plain numpy oligo reference it
compares against, the compile-cache placement rule, and the refusal of
chip_smoke.py and bench.py to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402
from kmertools_jax.io import fastx  # noqa: E402


def _env(**kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO
    env.update(kw)
    return env


@pytest.mark.parametrize("set_dir", [True, False], ids=["env-set", "env-unset"])
def test_compile_cache_dir_rule(tmp_path, set_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is one
    fixed path inside the checkout."""
    env = _env()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("KMERTOOLS_NO_JAX_CACHE", None)
    if set_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "x")
    r = subprocess.run(
        [sys.executable, "-c",
         "import kmertools_jax, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=120, cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr[-1000:]
    want = str(tmp_path / "x") if set_dir else os.path.join(_REPO, ".jax_cache")
    assert r.stdout.strip() == want


def test_contig_lengths_cutoff_and_total():
    lens = cs.contig_lengths(np.random.default_rng(1), 5_000_000)
    assert lens.min() >= 1000
    assert abs(int(lens.sum()) - 5_000_000) < 1000 + int(lens.max())
    assert 2000 < np.median(lens) < 8000  # log-normal, median ~4 kb


def test_write_contigs_shape(tmp_path):
    fa = tmp_path / "c.fa"
    n, bases = cs.write_contigs(str(fa), 2_000_000, seed=3)
    recs = list(fastx.sequences(str(fa)))
    assert len(recs) == n
    assert sum(len(r.seq) for r in recs) == bases
    assert min(len(r.seq) for r in recs) >= 1000
    seq = b"".join(r.seq for r in recs)
    assert b"N" in seq and any(c in seq for c in b"acgt")
    lines = fa.read_bytes().splitlines()
    assert max(len(x) for x in lines if not x.startswith(b">")) <= 80
    # same seed, same bytes
    fb = tmp_path / "d.fa"
    cs.write_contigs(str(fb), 2_000_000, seed=3)
    assert cs.same_bytes(str(fa), str(fb))
    # the CGR input carries no N (CGR aborts on one)
    fc = tmp_path / "e.fa"
    cs.write_contigs(str(fc), 500_000, seed=4, with_n=False)
    assert b"N" not in b"".join(r.seq for r in fastx.sequences(str(fc)))


def test_write_reads_fastq(tmp_path):
    fq = tmp_path / "r.fq"
    n, bases = cs.write_reads(str(fq), 20_000, 10.0, 150, 0.01, seed=5)
    recs = list(fastx.sequences(str(fq)))
    assert len(recs) == n == 20_000 * 10 // 150
    assert all(len(r.seq) == 150 for r in recs)
    assert bases == 150 * n
    assert set(b"".join(r.seq for r in recs)) <= set(b"ACGT")


def test_head_records(tmp_path):
    fa = tmp_path / "c.fa"
    cs.write_contigs(str(fa), 1_000_000, seed=6)
    got = cs.head_records(str(fa), str(tmp_path / "h.fa"), 200_000)
    recs = list(fastx.sequences(str(tmp_path / "h.fa")))
    assert sum(len(r.seq) for r in recs) == got >= 200_000
    full = list(fastx.sequences(str(fa)))
    assert [r.seq for r in recs] == [r.seq for r in full[:len(recs)]]


def test_byte_comparers(tmp_path):
    a, b, c = (tmp_path / x for x in "abc")
    a.write_bytes(b"1\t2\n3\t4\n")
    b.write_bytes(b"3\t4\n1\t2\n")
    c.write_bytes(b"1\t2\n3\t4\n")
    assert cs.same_bytes(str(a), str(c))
    assert not cs.same_bytes(str(a), str(b))
    assert cs.outputs_match(str(a), str(b), sort_ok=True)
    assert not cs.outputs_match(str(a), str(b), sort_ok=False)


@pytest.mark.parametrize(
    "k,flags,canonical,norm",
    [(4, [], True, True), (3, ["-r", "-c"], False, False)],
    ids=["k4-norm", "k3-raw-counts"],
)
def test_numpy_oligo_reference_matches_cli(tmp_path, k, flags, canonical,
                                           norm):
    """The chip run's oligo reference (bench._baseline_numpy_impl) gives
    the CLI's bytes on contigs with N runs and lowercase."""
    from kmertools_jax.cli import main

    fa = tmp_path / "c.fa"
    cs.write_contigs(str(fa), 300_000, seed=7)
    bench._baseline_numpy_impl(str(fa), str(tmp_path / "ref"), k=k,
                               canonical=canonical, norm=norm)
    assert main(["comp", "oligo", "-i", str(fa), "-o", str(tmp_path / "out"),
                 "-k", str(k), *flags]) == 0
    assert cs.same_bytes(str(tmp_path / "out"), str(tmp_path / "ref"))


def test_chip_smoke_refuses_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, os.path.join(_REPO, "chip_smoke.py")],
        env=_env(JAX_PLATFORMS="cpu"), capture_output=True, text=True,
        timeout=120, cwd=tmp_path,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py (no package beside
    it) the script fails and prints no result."""
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], env=env, capture_output=True,
        text=True, timeout=120, cwd=tmp_path,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_bench_refuses_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, os.path.join(_REPO, "bench.py")],
        env=_env(JAX_PLATFORMS="cpu", BENCH_READS="10"),
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"metric"' not in r.stdout
