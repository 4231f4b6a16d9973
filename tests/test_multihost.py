"""Multi-host runtime tests (parallel/multihost.py + CLI flags).

The scaling contract: N processes, each consuming one record-aligned
byte-range shard of the input, produce parts that concatenate to the
byte-exact whole-file output (SURVEY.md §5's DCN layer)."""

import os
import subprocess
import sys

import pytest

from kmertools_jax.cli import main

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pythonpath() -> str:
    parts = [_REPO] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p
    ]
    return os.pathsep.join(dict.fromkeys(parts))


_BOOT = (
    "import jax; jax.config.update('jax_platforms','cpu'); "
    "import sys; from kmertools_jax.cli import main; "
    "sys.exit(main(sys.argv[1:]))"
)


def _make_corpus(path, n_reads=48, lens=(40, 90, 150)):
    import numpy as np

    rng = np.random.default_rng(7)
    with open(path, "w") as f:
        for i in range(n_reads):
            L = int(lens[i % len(lens)])
            seq = "".join(rng.choice(list("ACGT"), size=L))
            f.write(f">read_{i} desc\n{seq}\n")


def _spawn(args, cwd):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = _pythonpath()
    env.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    env["KMERTOOLS_QUIET"] = "1"
    env["KMERTOOLS_TARGET_CODES"] = str(1 << 14)
    return subprocess.Popen(
        [sys.executable, "-c", _BOOT, *args],
        env=env, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )


def _run_hosts(base_args, n_hosts, cwd, coordinator=None):
    procs = []
    for h in range(n_hosts):
        args = list(base_args) + [
            "--num-hosts", str(n_hosts), "--host-id", str(h),
        ]
        if coordinator:
            args += ["--coordinator", coordinator]
        procs.append(_spawn(args, cwd))
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]


@pytest.mark.parametrize("coordinator", [None, "localhost:18477"],
                         ids=["fs-barrier", "jax-distributed"])
def test_two_host_oligo_equals_whole_file(tmp_path, coordinator):
    fa = tmp_path / "reads.fa"
    _make_corpus(fa)
    whole = tmp_path / "whole.kmers"
    rc = main(["comp", "oligo", "-i", str(fa), "-o", str(whole), "-k", "4", "-H"])
    assert rc == 0
    sharded = tmp_path / "sharded.kmers"
    _run_hosts(
        ["comp", "oligo", "-i", str(fa), "-o", str(sharded), "-k", "4", "-H"],
        2, tmp_path, coordinator,
    )
    assert sharded.read_bytes() == whole.read_bytes()
    # no parts or coordination files left behind
    assert not list(tmp_path.glob("*.part_*"))
    assert not list(tmp_path.glob("*.mh*"))


def test_two_host_min_s2m_equals_whole_file(tmp_path):
    fa = tmp_path / "reads.fa"
    _make_corpus(fa, n_reads=30)
    whole = tmp_path / "whole.mins"
    rc = main(["min", "-i", str(fa), "-o", str(whole), "-m", "8", "-w", "20"])
    assert rc == 0
    sharded = tmp_path / "sharded.mins"
    _run_hosts(
        ["min", "-i", str(fa), "-o", str(sharded), "-m", "8", "-w", "20"],
        2, tmp_path,
    )
    assert sharded.read_bytes() == whole.read_bytes()


def test_multihost_shard_library_level(tmp_path):
    """In-process shard runs (no subprocess) concatenate byte-exactly
    for cgr — the library-level contract behind the CLI."""
    from kmertools_jax.parallel import dataflow
    from kmertools_jax.workloads.cgr import CgrComputer

    fa = tmp_path / "reads.fa"
    _make_corpus(fa, n_reads=20)
    whole = tmp_path / "whole.cgr"
    CgrComputer(str(fa), str(whole), 1).vectorise()
    shards = dataflow.split_file(str(fa), 3)
    blobs = []
    for sh in shards:
        part = tmp_path / f"part{sh.index}.cgr"
        c = CgrComputer(str(fa), str(part), 1)
        c.set_input_shard(sh)
        c.vectorise()
        blobs.append(part.read_bytes())
    assert b"".join(blobs) == whole.read_bytes()


def test_two_host_ctr_equals_whole_file(tmp_path):
    """Sharded counting: every host spills its shard's chunks into the
    shared dir; host 0 merges. Counts must equal the whole-file run."""
    from kmertools_jax.utils.fops import load_lines_sorted

    fa = tmp_path / "reads.fa"
    _make_corpus(fa, n_reads=40, lens=(60, 120))
    whole = tmp_path / "whole"
    whole.mkdir()
    rc = main(["ctr", "-i", str(fa), "-o", str(whole), "-k", "15"])
    assert rc == 0
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    _run_hosts(
        ["ctr", "-i", str(fa), "-o", str(sharded), "-k", "15"], 2, tmp_path
    )
    assert load_lines_sorted(str(sharded / "kmers.counts")) == load_lines_sorted(
        str(whole / "kmers.counts")
    )
    assert not list(sharded.glob("temp_kmers.*"))


def test_two_host_cov_equals_whole_file(tmp_path):
    """cov composes multi-host counting (global table) with sharded
    read vectorisation; kmers.vectors must byte-match."""
    fa = tmp_path / "reads.fa"
    _make_corpus(fa, n_reads=30, lens=(80, 150))
    whole = tmp_path / "whole"
    whole.mkdir()
    rc = main(["cov", "-i", str(fa), "-o", str(whole), "-k", "15"])
    assert rc == 0
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    _run_hosts(
        ["cov", "-i", str(fa), "-o", str(sharded), "-k", "15"], 2, tmp_path
    )
    assert (sharded / "kmers.vectors").read_bytes() == (
        whole / "kmers.vectors"
    ).read_bytes()


@pytest.mark.parametrize("spill_records", [None, 5],
                         ids=["one-run-per-host", "multi-run-per-host"])
def test_two_host_min_m2s_equals_whole_file(tmp_path, monkeypatch,
                                            spill_records):
    """m2s multi-host: every host spills shard-local val-sorted runs
    (with their id blobs) into the shared dir; host 0 k-way merges all
    hosts' runs. Output is deterministic (minimiser-sorted groups,
    file-ordered entries) so bytes match the single-host run exactly
    (the reference's own m2s tests sort lines: minisers.rs:169-187 —
    byte equality is the stronger claim)."""
    if spill_records is not None:
        monkeypatch.setenv("KMERTOOLS_M2S_SPILL_RECORDS", str(spill_records))
    fa = tmp_path / "reads.fa"
    _make_corpus(fa, n_reads=30)
    whole = tmp_path / "whole.m2s"
    rc = main(["min", "-i", str(fa), "-o", str(whole), "-m", "8",
               "-w", "20", "-p", "m2s"])
    assert rc == 0
    sharded = tmp_path / "sharded.m2s"
    _run_hosts(
        ["min", "-i", str(fa), "-o", str(sharded), "-m", "8", "-w", "20",
         "-p", "m2s"],
        2, tmp_path,
    )
    assert sharded.read_bytes() == whole.read_bytes()
    leftovers = [
        p for p in tmp_path.iterdir()
        if ".m2s_mh" in p.name or p.name.endswith(".m2s.mh")
        or ".spill" in p.name
    ]
    assert not leftovers, f"m2s exchange left files behind: {leftovers}"
