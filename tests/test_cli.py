"""CLI surface tests (kmertools/src/args.rs:239-368 dispatcher)."""

import pytest

from kmertools_jax.cli import main
from kmertools_jax.utils.fops import load_lines_sorted


def test_cli_oligo(tmp_path, test_data):
    out = tmp_path / "out.kmers"
    rc = main(["comp", "oligo", "-i", str(test_data / "reads.fq"), "-o", str(out), "-k", "4"])
    assert rc == 0
    assert out.read_bytes() == (test_data / "expected_fa.kmers").read_bytes()


def test_cli_oligo_header_tsv(tmp_path, test_data):
    out = tmp_path / "out.kmers"
    rc = main(
        ["comp", "oligo", "-i", str(test_data / "reads.fq"), "-o", str(out),
         "-k", "4", "-p", "tsv", "-H"]
    )
    assert rc == 0
    first = out.read_text().splitlines()[0]
    assert first.split("\t")[0] == "AAAA"
    assert len(first.split("\t")) == 136


def test_cli_cgr(tmp_path, test_data):
    out = tmp_path / "out.cgr"
    rc = main(["comp", "cgr", "-i", str(test_data / "reads.fq"), "-o", str(out)])
    assert rc == 0
    assert out.read_bytes() == (test_data / "expected_reads.cgr").read_bytes()


def test_cli_oligocgr_default_vecsize(tmp_path, test_data):
    """cgr -k 4 defaults vecsize to k^2 = 16 (args.rs:266-269)."""
    out = tmp_path / "out.k4.cgr"
    rc = main(
        ["comp", "cgr", "-i", str(test_data / "reads.fq"), "-o", str(out),
         "-k", "4", "-c"]
    )
    assert rc == 0
    assert out.read_bytes() == (test_data / "expected_reads.k4.cgr").read_bytes()


def test_cli_cgr_counts_rejected(tmp_path, test_data, capsys):
    rc = main(["comp", "cgr", "-i", str(test_data / "reads.fq"),
               "-o", str(tmp_path / "x"), "-c"])
    assert rc == 1
    assert "cannot use counts" in capsys.readouterr().err


def test_cli_min_s2m(tmp_path, test_data):
    out = tmp_path / "mins"
    rc = main(["min", "-i", str(test_data / "reads.fq"), "-o", str(out),
               "-m", "7", "-w", "31", "-p", "s2m"])
    assert rc == 0
    assert load_lines_sorted(str(out)) == load_lines_sorted(
        str(test_data / "expected_seq_minimisers")
    )


def test_cli_min_m2s(tmp_path, test_data):
    out = tmp_path / "mins"
    rc = main(["min", "-i", str(test_data / "reads.fq"), "-o", str(out),
               "-m", "10", "-p", "m2s"])
    assert rc == 0
    assert load_lines_sorted(str(out)) == load_lines_sorted(
        str(test_data / "expected_minimisers")
    )


def test_cli_min_validation(tmp_path, test_data, capsys):
    rc = main(["min", "-i", str(test_data / "reads.fq"),
               "-o", str(tmp_path / "x"), "-m", "10", "-w", "8"])
    assert rc == 1
    assert "Window size must be longer" in capsys.readouterr().err


def test_cli_ctr(tmp_path, test_data):
    out = tmp_path / "ctrout"
    rc = main(["ctr", "-i", str(test_data / "reads.fq"), "-o", str(out), "-k", "15"])
    assert rc == 0
    assert (out / "kmers.counts").exists()
    assert not list(out.glob("temp_kmers.*"))


def test_cli_cov(tmp_path, test_data):
    out = tmp_path / "covout"
    rc = main(["cov", "-i", str(test_data / "reads.fq"), "-o", str(out), "-k", "15"])
    assert rc == 0
    lines = (out / "kmers.vectors").read_text().splitlines()
    assert len(lines) == 2
    assert len(lines[0].split(" ")) == 16  # default bin_count


def test_cli_range_validation():
    with pytest.raises(SystemExit):
        main(["comp", "oligo", "-i", "x", "-o", "y", "-k", "9"])
    with pytest.raises(SystemExit):
        main(["ctr", "-i", "x", "-o", "y", "-k", "8"])
    with pytest.raises(SystemExit):
        main(["cov", "-i", "x", "-o", "y", "-m", "200"])


def test_cli_version(capsys):
    """clap's version flag analog (args.rs:13-14)."""
    from kmertools_jax.version import __version__

    with pytest.raises(SystemExit) as e:
        main(["--version"])
    assert e.value.code == 0
    assert capsys.readouterr().out.strip() == f"kmertools {__version__}"


def test_api_stub_surface_matches_runtime():
    """The shipped .pyi stub names every public runtime symbol."""
    import ast
    import pathlib

    import pykmertools as kt

    stub = pathlib.Path(kt.__file__).with_name("__init__.pyi")
    tree = ast.parse(stub.read_text())
    stub_names = {
        n.name for n in tree.body
        if isinstance(n, (ast.ClassDef, ast.FunctionDef))
    }
    for name in ["CgrComputer", "KmerGenerator", "MinimiserGenerator",
                 "OligoComputer", "utils", "run_cli"]:
        assert name in stub_names
        assert hasattr(kt, name)
    # method surface of each stub class exists at runtime
    for cls in tree.body:
        if isinstance(cls, ast.ClassDef) and cls.name != "utils":
            rt = getattr(kt, cls.name)
            for meth in cls.body:
                if isinstance(meth, ast.FunctionDef):
                    assert hasattr(rt, meth.name), (cls.name, meth.name)


def test_oligo_set_max_memory_gb_semantics():
    """set_max_memory takes GB (reference oligo.rs:61-63) — a drop-in
    caller passing 6 (GB) must not get a tiny code batch."""
    from kmertools_jax.workloads.oligo import OligoComputer

    com = OligoComputer("/dev/null", "/dev/null", 4)
    com.set_max_memory(6)
    assert com.target_codes == 1 << 25  # capped device batch
    com.set_max_memory(0.00001)  # ~10 KB
    assert com.target_codes == 1 << 14  # floor


def test_run_cli_entry(tmp_path, test_data):
    """pykmertools.run_cli mirrors pip/src/lib.rs:11-18."""
    import pykmertools as kt

    out = tmp_path / "out.kmers"
    rc = kt.run_cli(["comp", "oligo", "-i", str(test_data / "reads.fq"),
                     "-o", str(out), "-k", "4"])
    assert rc == 0
    assert out.exists()


def test_help_renders_clap_layout(capsys):
    """-h/--help render the clap-v4 layout the reference binary uses
    (args.rs:13-21): about line, Usage:, Commands:/Options: sections,
    <UPPER_SNAKE> value names, [default:]/[possible values:] suffixes,
    short-vs-long help, and the `help` pseudo-subcommand. (Byte parity
    with the actual clap output is unverifiable here — no Rust
    toolchain — so the emulated layout's load-bearing features are
    pinned instead.)"""
    import pytest

    from kmertools_jax import cli

    with pytest.raises(SystemExit):
        cli.main(["-h"])
    top = capsys.readouterr().out
    assert top.startswith("kmertools: DNA vectorisation\n\n")
    assert "Usage: kmertools <COMMAND>" in top
    assert "Commands:" in top and "Options:" in top
    assert "  comp  Generate sequence composition based features" in top
    assert "  help  Print this message or the help of the given" in top
    assert "  -h, --help     Print help" in top
    assert "  -V, --version  Print version" in top
    # argparse's stock rendering must be gone
    assert "usage:" not in top and "positional arguments" not in top

    with pytest.raises(SystemExit):
        cli.main(["comp", "oligo", "-h"])
    oligo = capsys.readouterr().out
    assert (
        "Usage: kmertools comp oligo [OPTIONS] --input <INPUT> "
        "--output <OUTPUT>" in oligo
    )
    assert "-k, --k-size <K_SIZE>" in oligo
    assert "[default: 3]" in oligo
    assert "[default: spc] [possible values: csv, tsv, spc]" in oligo
    # reference options lead; the multi-host framework extensions trail
    assert oligo.index("--input") < oligo.index("--num-hosts")

    # short help truncates the multi-line w_size doc and points at
    # --help; long help shows the full paragraphs
    with pytest.raises(SystemExit):
        cli.main(["min", "-h"])
    short = capsys.readouterr().out
    assert "Print help (see more with '--help')" in short
    assert "emits one minimiser per sequence" not in short
    with pytest.raises(SystemExit):
        cli.main(["min", "--help"])
    long = capsys.readouterr().out
    assert "0 - emits one minimiser per sequence" in long
    assert "w_size must be longer than m_size" in long

    # the `help` pseudo-subcommand (clap adds it to Commands)
    assert cli.main(["help"]) == 0
    assert "Usage: kmertools <COMMAND>" in capsys.readouterr().out
    assert cli.main(["help", "ctr"]) == 0
    helped = capsys.readouterr().out
    assert "Usage: kmertools ctr [OPTIONS]" in helped
    assert "Output ACGT instead of numeric values" in helped
