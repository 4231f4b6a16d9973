"""CGR golden parity (composition/src/cgr.rs:147-199 and
oligocgr.rs:192-238 equivalents)."""

import numpy as np
import jax.numpy as jnp
import pytest

from kmertools_jax.io.batch import encode_bases
from kmertools_jax.ops import cgr as cgr_ops
from kmertools_jax.workloads.cgr import CgrComputer, OligoCgrComputer


def test_cgr_exact_points():
    """23 exact f64 points from cgr.rs:154-187."""
    seq = b"atgatgaaatagagagactttat"
    codes = np.full((1, 32), 4, dtype=np.uint8)
    codes[0, : len(seq)] = encode_bases(seq)
    xs, ys = cgr_ops.cgr_scan(jnp.asarray(codes), 1.0, jnp.float64)
    xs, ys = np.asarray(xs)[0], np.asarray(ys)[0]
    expected = [
        (0.25, 0.25), (0.625, 0.125), (0.8125, 0.5625), (0.40625, 0.28125),
        (0.703125, 0.140625), (0.8515625, 0.5703125), (0.42578125, 0.28515625),
        (0.212890625, 0.142578125), (0.1064453125, 0.0712890625),
        (0.55322265625, 0.03564453125), (0.276611328125, 0.017822265625),
        (0.6383056640625, 0.5089111328125), (0.31915283203125, 0.25445556640625),
        (0.659576416015625, 0.627227783203125),
        (0.3297882080078125, 0.3136138916015625),
        (0.6648941040039062, 0.6568069458007812),
        (0.3324470520019531, 0.3284034729003906),
        (0.16622352600097656, 0.6642017364501953),
        (0.5831117630004883, 0.33210086822509766),
        (0.7915558815002441, 0.16605043411254883),
        (0.8957779407501221, 0.08302521705627441),
        (0.44788897037506104, 0.04151260852813721),
        (0.7239444851875305, 0.020756304264068604),
    ]
    for i, (ex, ey) in enumerate(expected):
        assert xs[i] == ex and ys[i] == ey


def test_cgr_golden(tmp_path, test_data):
    out = tmp_path / "reads.cgr"
    cgr = CgrComputer(str(test_data / "reads.fq"), str(out), 1)
    cgr.vectorise()
    assert out.read_bytes() == (test_data / "expected_reads.cgr").read_bytes()


def test_cgr_bad_base(tmp_path):
    fa = tmp_path / "bad.fa"
    fa.write_text(">r\nACGTNACGT\n")
    out = tmp_path / "bad.cgr"
    cgr = CgrComputer(str(fa), str(out), 1)
    with pytest.raises(ValueError, match="Bad nucleotide"):
        cgr.vectorise()


def test_oligo_cgr_first_point():
    """oligocgr.rs:199-220: first canonical kmer AAAA at vecsize 16."""
    com = OligoCgrComputer.__new__(OligoCgrComputer)
    digits = np.zeros((1, 4), dtype=np.int64)
    xs, ys = cgr_ops.kmer_cgr_points(digits, 16.0)
    assert xs[0] == 0.5 and ys[0] == 0.5


def test_oligo_cgr_golden_unnorm(tmp_path, test_data):
    out = tmp_path / "reads.k4.cgr"
    cgr = OligoCgrComputer(str(test_data / "reads.fq"), str(out), 4, 16)
    cgr.set_norm(False)
    cgr.vectorise()
    assert out.read_bytes() == (test_data / "expected_reads.k4.cgr").read_bytes()


def test_cgr_long_read_host_fallback(tmp_path):
    """Reads longer than the widest bucket take the host path and must
    agree with the device scan."""
    rng = np.random.default_rng(5)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, size=40000))
    fa = tmp_path / "long.fa"
    fa.write_text(f">r\n{seq}\n")
    out = tmp_path / "long.cgr"
    CgrComputer(str(fa), str(out), 1).vectorise()
    first = out.read_text().split(" ")[0]
    assert first in ("(0.25,0.25)", "(0.75,0.25)", "(0.75,0.75)", "(0.25,0.75)")
    npoints = len(out.read_text().strip().split(" "))
    assert npoints == 40000


def test_cgr_no_sink_host_walk(tmp_path, test_data, monkeypatch):
    """When the backend fails the exactness probe the host walk still
    produces golden bytes."""
    from kmertools_jax.workloads import cgr as cgr_mod

    monkeypatch.setattr(cgr_mod, "_f64_supported", lambda: False)
    before = cgr_mod.DEVICE_SCAN_RUNS
    out = tmp_path / "reads.cgr"
    CgrComputer(str(test_data / "reads.fq"), str(out), 1).vectorise()
    assert cgr_mod.DEVICE_SCAN_RUNS == before
    assert out.read_bytes() == (test_data / "expected_reads.cgr").read_bytes()


def test_oligocgr_sink_on_off(tmp_path, test_data):
    """Oligo-CGR output is byte-identical with the native sink active
    (default) and disabled (KMERTOOLS_NO_HETERO) — scheduling must
    never change bytes (oligo.py's test_native_sink_joins_oligo
    pattern)."""
    import os

    from kmertools_jax import native

    if native.lib() is None:
        pytest.skip("native runtime unavailable")
    a = tmp_path / "a.cgr"
    com = OligoCgrComputer(str(test_data / "reads.fq"), str(a), 4, 16)
    com.set_norm(False)
    com.vectorise()
    os.environ["KMERTOOLS_NO_HETERO"] = "1"
    try:
        b = tmp_path / "b.cgr"
        com2 = OligoCgrComputer(str(test_data / "reads.fq"), str(b), 4, 16)
        com2.set_norm(False)
        com2.vectorise()
    finally:
        del os.environ["KMERTOOLS_NO_HETERO"]
    assert a.read_bytes() == b.read_bytes()
    assert a.read_bytes() == (test_data / "expected_reads.k4.cgr").read_bytes()


def test_oligocgr_norm_matches_reference_kernel(tmp_path, test_data):
    """Normalised oligocgr freq = count / max(1, total) in f64
    (oligocgr.rs:145-163) — spot-check one row against a hand
    computation through the Python API's oligo counts."""
    out = tmp_path / "n.cgr"
    com = OligoCgrComputer(str(test_data / "reads.fq"), str(out), 4, 16)
    com.vectorise()
    row = out.read_text().splitlines()[0]
    tokens = row.split(" ")
    assert len(tokens) == 136
    freqs = np.array([float(t.rsplit(",", 1)[1][:-1]) for t in tokens])
    assert abs(freqs.sum() - 1.0) < 1e-9  # 72bp read, no ambiguity
