"""Wheel packaging parity (reference: maturin wheels, pip/Cargo.toml:16-21,
.github/workflows/pypi.yml).

Builds the wheel with the local setuptools backend (offline) and checks
the native runtime, CLI entry point, and typed API stub ship inside —
the moving parts a drop-in `pip install` user needs.
"""

import pathlib
import subprocess
import sys
import zipfile

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.slow
def test_wheel_contains_native_and_stubs(tmp_path):
    r = subprocess.run(
        [
            sys.executable, "-m", "pip", "wheel",
            "--no-deps", "--no-build-isolation", "-w", str(tmp_path),
            str(REPO),
        ],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    wheels = list(tmp_path.glob("kmertools_jax-*.whl"))
    assert len(wheels) == 1
    names = set(zipfile.ZipFile(wheels[0]).namelist())
    # C++ host runtime: compiled into the wheel (and source for the
    # lazy -march=native rebuild, native/__init__.py)
    assert "kmertools_jax/native/libkthost.so" in names
    assert "kmertools_jax/native/kthost.cpp" in names
    # typed Python API contract (pybindings/pykmertools.pyi:1-244)
    assert "pykmertools/__init__.pyi" in names
    assert "pykmertools/py.typed" in names
    # console script metadata
    meta = [n for n in names if n.endswith("entry_points.txt")]
    assert meta, "entry_points.txt missing from wheel"
    txt = zipfile.ZipFile(wheels[0]).read(meta[0]).decode()
    assert "kmertools = kmertools_jax.cli:main" in txt
