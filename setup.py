"""Wheel build hook: compile the C++ host runtime into the wheel.

The reference ships native wheels via maturin (pip/Cargo.toml:16-21,
.github/workflows/pypi.yml); the equivalent here is a setuptools build
step that compiles ``kmertools_jax/native/kthost.cpp`` to
``libkthost.so`` inside the wheel. Compilation is best-effort: without
a toolchain the wheel is still produced and the runtime falls back to
building lazily on first use (native/__init__.py), or to the pure
Python paths.
"""

import os
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py


class build_py_with_native(build_py):
    def run(self):
        super().run()
        src = os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "kmertools_jax", "native", "kthost.cpp",
        )
        out_dir = os.path.join(self.build_lib, "kmertools_jax", "native")
        out = os.path.join(out_dir, "libkthost.so")
        os.makedirs(out_dir, exist_ok=True)
        try:
            # -march left at baseline so the wheel is portable; the
            # lazy rebuild on first use upgrades to -march=native
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                 src, "-o", out, "-lz"],
                check=True, capture_output=True, timeout=300,
            )
        except Exception:
            pass  # pure wheel; runtime builds lazily or falls back


setup(cmdclass={"build_py": build_py_with_native})
