"""kmertools CLI — same subcommands, flags, defaults and validation as
the reference clap CLI (kmertools/src/args.rs:13-368).

    kmertools comp oligo -i reads.fq -o out.kmers -k 4
    kmertools comp cgr   -i reads.fq -o out.cgr
    kmertools cov -i reads.fq -o outdir -k 15
    kmertools min -i reads.fq -o out -m 10 -w 0 -p s2m
    kmertools ctr -i reads.fq -o outdir -k 21
"""

from __future__ import annotations

import argparse
import sys

ABOUT = (
    "kmertools: DNA vectorisation\n\n"
    "k-mer based vectorisation for DNA sequences for\n"
    "metagenomics and AI/ML applications (JAX, GPU-accelerated)"
)
ABOUT_SHORT = "kmertools: DNA vectorisation"

_DELIMS = {"csv": ",", "tsv": "\t", "spc": " "}


def _ranged_int(lo: int, hi: int | None, name: str):
    def parse(s: str) -> int:
        v = int(s)
        if v < lo or (hi is not None and v > hi):
            hint = f"{lo}..={hi}" if hi is not None else f">= {lo}"
            raise argparse.ArgumentTypeError(f"{name} must be in range {hint}")
        return v

    return parse


def build_parser() -> argparse.ArgumentParser:
    from kmertools_jax import claphelp
    from kmertools_jax.version import __version__

    # clap-v4-layout help rendering (claphelp.py): every parser is
    # built add_help=False and gets the clap help action installed
    # AFTER its arguments, so -h/--help sit last in Options like clap
    p = argparse.ArgumentParser(
        prog="kmertools", description=ABOUT, add_help=False
    )
    claphelp.install(p, about=ABOUT_SHORT, long_about=ABOUT)
    # clap's `version` flag (kmertools/src/args.rs:13-14); clap prints
    # "<bin> <version>"
    p.add_argument(
        "-V", "--version", action="version", version=f"kmertools {__version__}"
    )
    sub = p.add_subparsers(dest="command", required=True)

    # multi-host flags (framework extension; the reference is single-
    # process). Every host runs the same command with its own --host-id;
    # outputs concatenate in shard order (parallel/multihost.py).
    # Added AFTER each leaf's own arguments so the reference's options
    # lead the clap-layout help, extensions trail.
    def _add_mh(q: argparse.ArgumentParser) -> None:
        q.add_argument(
            "--num-hosts", type=int, default=1,
            help="Total hosts sharing this run (input is byte-range "
                 "sharded)",
        )
        q.add_argument(
            "--host-id", type=int, default=0,
            help="This host's rank in [0, num-hosts)",
        )
        q.add_argument(
            "--coordinator", default=None,
            help="host:port of the jax.distributed coordinator (host 0); "
                 "omit for filesystem-barrier coordination",
        )

    comp = sub.add_parser(
        "comp", help="Generate sequence composition based features",
        add_help=False,
    )
    claphelp.install(comp, about="Generate sequence composition based features")
    compsub = comp.add_subparsers(dest="comp_command", required=True)

    oligo = compsub.add_parser(
        "oligo", help="Generate oligonucleotide frequency vectors",
        add_help=False,
    )
    oligo.add_argument("-i", "--input", required=True, help="Input file path")
    oligo.add_argument("-o", "--output", required=True, help="Output vectors path")
    oligo.add_argument(
        "-c", "--counts", action="store_true",
        help="Disable normalisation and output raw counts",
    )
    oligo.add_argument(
        "-k", "--k-size", type=_ranged_int(3, 7, "k_size"), default=3,
        help="Set k-mer size",
    )
    oligo.add_argument("-r", "--raw-count", action="store_true", help="Raw counts")
    oligo.add_argument(
        "-p", "--preset", choices=list(_DELIMS), default="spc",
        help="Output type to write",
    )
    oligo.add_argument(
        "-H", "--header", action="store_true",
        help="Include header (with k-mer in ACGT format)",
    )
    oligo.add_argument(
        "-t", "--threads", type=int, default=0,
        help="Thread count for computations 0=auto",
    )

    _add_mh(oligo)
    claphelp.install(
        oligo, about="Generate oligonucleotide frequency vectors"
    )

    cgr = compsub.add_parser(
        "cgr", help="Generates Chaos Game Representations",
        add_help=False,
    )
    cgr.add_argument("-i", "--input", required=True, help="Input file path")
    cgr.add_argument(
        "-o", "--output", required=True, help="Output vectors path"
    )
    cgr.add_argument(
        "-c", "--counts", action="store_true",
        help="Disable normalisation and output raw counts "
             "(only with k-mer mode)",
    )
    cgr.add_argument(
        "-k", "--k-size", type=_ranged_int(3, 7, "k_size"), default=None,
        help="Set k-mer size or default to full sequence CGR",
    )
    cgr.add_argument(
        "-v", "--vec-size", type=int, default=None,
        help="Set vector size (output will be a square matrix with "
             "N=vecsize)",
    )
    cgr.add_argument(
        "-t", "--threads", type=int, default=0,
        help="Thread count for computations 0=auto",
    )

    _add_mh(cgr)
    claphelp.install(cgr, about="Generates Chaos Game Representations")

    cov = sub.add_parser(
        "cov", help="Generates coverage histogram based on the reads",
        add_help=False,
    )
    cov.add_argument("-i", "--input", required=True, help="Input file path")
    cov.add_argument(
        "-a", "--alt-input", default=None,
        help="Input file path, for k-mer counting",
    )
    cov.add_argument(
        "-o", "--output", required=True, help="Output directory path"
    )
    cov.add_argument(
        "-k", "--k-size", type=_ranged_int(7, 31, "k_size"), default=15,
        help="K size for the coverage histogram",
    )
    cov.add_argument(
        "-p", "--preset", choices=list(_DELIMS), default="spc",
        help="Output type to write",
    )
    cov.add_argument(
        "-s", "--bin-size", type=_ranged_int(5, None, "bin_size"), default=16,
        help="Bin size for the coverage histogram",
    )
    cov.add_argument(
        "-c", "--bin-count", type=_ranged_int(5, None, "bin_count"), default=16,
        help="Number of bins for the coverage histogram",
    )
    cov.add_argument(
        "-m", "--memory", type=_ranged_int(6, 128, "memory"), default=6,
        help="Max memory in GB",
    )
    cov.add_argument(
        "--counts", action="store_true",
        help="Disable normalisation and output raw counts",
    )
    cov.add_argument(
        "-t", "--threads", type=int, default=0,
        help="Thread count for computations 0=auto",
    )

    _add_mh(cov)
    claphelp.install(
        cov, about="Generates coverage histogram based on the reads"
    )

    mn = sub.add_parser(
        "min", help="Bin reads using minimisers",
        add_help=False,
    )
    mn.add_argument("-i", "--input", required=True, help="Input file path")
    mn.add_argument(
        "-o", "--output", required=True, help="Output vectors path"
    )
    mn.add_argument(
        "-m", "--m-size", type=_ranged_int(7, 28, "m_size"), default=10,
        help="Minimiser size",
    )
    mn.add_argument(
        "-w", "--w-size", type=_ranged_int(0, None, "w_size"), default=0,
        help="Window size\n"
             "\n"
             "0 - emits one minimiser per sequence (useful for sequencing "
             "reads)\n"
             "w_size must be longer than m_size",
    )
    mn.add_argument(
        "-p", "--preset", choices=["s2m", "m2s"], default="s2m",
        help="Output type to write",
    )
    mn.add_argument(
        "-t", "--threads", type=int, default=0,
        help="Thread count for computations 0=auto",
    )

    _add_mh(mn)
    claphelp.install(mn, about="Bin reads using minimisers")

    ctr = sub.add_parser(
        "ctr", help="Count k-mers", add_help=False,
    )
    ctr.add_argument("-i", "--input", required=True, help="Input file path")
    ctr.add_argument(
        "-o", "--output", required=True, help="Output directory path"
    )
    ctr.add_argument(
        "-k", "--k-size", type=_ranged_int(10, 31, "k_size"), required=True,
        help="k size for counting",
    )
    ctr.add_argument(
        "-m", "--memory", type=_ranged_int(6, 128, "memory"), default=6,
        help="Max memory in GB",
    )
    ctr.add_argument(
        "-a", "--acgt", action="store_true",
        help="Output ACGT instead of numeric values\n"
             "\n"
             "This requires a larger space for the final result\n"
             "compared to the compact numeric representation",
    )
    ctr.add_argument(
        "-t", "--threads", type=int, default=0,
        help="Thread count for computations 0=auto",
    )

    _add_mh(ctr)
    claphelp.install(ctr, about="Count k-mers")

    return p


def main(argv: list[str] | None = None) -> int:
    from kmertools_jax import claphelp

    parser = build_parser()
    # clap's `help` pseudo-subcommand (kmertools help [cmd...])
    if claphelp.run_help_command(
        parser, list(sys.argv[1:] if argv is None else argv)
    ):
        return 0
    args = parser.parse_args(argv)
    from kmertools_jax.utils.profiling import maybe_trace

    with maybe_trace(args.command):
        return _dispatch(args)


def _multihost_ctx(args):
    """HostContext for --num-hosts > 1 runs, else None."""
    if getattr(args, "num_hosts", 1) <= 1:
        return None
    from kmertools_jax.parallel import multihost

    return multihost.init(args.num_hosts, args.host_id, args.coordinator)


def _dispatch(args) -> int:
    from kmertools_jax.utils.fops import create_directory

    try:
        ctx = _multihost_ctx(args)
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    if args.command == "comp" and args.comp_command == "oligo":
        from kmertools_jax.workloads.oligo import OligoComputer

        out = ctx.part_path(args.output) if ctx else args.output
        com = OligoComputer(args.input, out, args.k_size, not args.raw_count)
        if args.threads > 0:
            com.set_threads(args.threads)
        com.set_norm(not args.counts)
        # only shard 0's part carries the header row
        com.set_header(args.header and (ctx is None or ctx.is_primary))
        com.set_delim(_DELIMS[args.preset])
        try:
            if ctx:
                com.set_input_shard(ctx.shard_for(args.input))
            com.vectorise()
        except Exception as e:  # args.rs:260-262
            print(f"Error: {e}", file=sys.stderr)
            return 1
        if ctx:
            from kmertools_jax.parallel import multihost

            multihost.finalize_parts(ctx, args.output)

    elif args.command == "comp" and args.comp_command == "cgr":
        out = ctx.part_path(args.output) if ctx else args.output
        if args.k_size is not None:
            # oligo-CGR; default vecsize (k^4)^0.5 = k^2 (args.rs:266-269)
            vecsize = args.vec_size or int((float(args.k_size) ** 4.0) ** 0.5)
            from kmertools_jax.workloads.cgr import OligoCgrComputer

            cgr = OligoCgrComputer(args.input, out, args.k_size, vecsize)
            if args.threads > 0:
                cgr.set_threads(args.threads)
            cgr.set_norm(not args.counts)
            try:
                if ctx:
                    cgr.set_input_shard(ctx.shard_for(args.input))
                cgr.vectorise()
            except Exception as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
        else:
            if args.counts:
                print("Error: cannot use counts in whole sequence CGR!", file=sys.stderr)
                return 1
            from kmertools_jax.workloads.cgr import CgrComputer

            cgr = CgrComputer(args.input, out, args.vec_size or 1)
            if args.threads > 0:
                cgr.set_threads(args.threads)
            try:
                if ctx:
                    cgr.set_input_shard(ctx.shard_for(args.input))
                cgr.vectorise()
            except Exception as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
        if ctx:
            from kmertools_jax.parallel import multihost

            multihost.finalize_parts(ctx, args.output)

    elif args.command == "cov":
        from kmertools_jax.workloads.coverage import CovComputer

        create_directory(args.output)
        cov = CovComputer(
            args.input, args.output, args.k_size, args.bin_size, args.bin_count
        )
        if args.threads > 0:
            cov.set_threads(args.threads)
        if args.alt_input:
            cov.set_kmer_path(args.alt_input)
        if args.counts:
            cov.set_norm(False)
        cov.set_max_memory(float(args.memory))
        cov.set_delim(_DELIMS[args.preset])
        if ctx:
            cov.set_multihost(ctx)
        cov.build_table()
        cov.compute_coverages()

    elif args.command == "min":
        if 0 < args.w_size <= args.m_size:
            print("Window size must be longer than minimiser size!", file=sys.stderr)
            return 1
        if args.m_size >= 31:
            print("Minimisers longer than 30 bases not allowed!", file=sys.stderr)
            return 1
        from kmertools_jax.workloads import minimisers

        if args.preset == "m2s":
            # multi-host m2s: hosts spill shard-local val-sorted runs
            # into a shared dir; host 0 k-way merges them (groups stay
            # whole — the merge is the single-host merge)
            minimisers.bin_sequences(
                args.w_size, args.m_size, args.input, args.output,
                args.threads, mh_ctx=ctx,
            )
        else:
            out = ctx.part_path(args.output) if ctx else args.output
            minimisers.seq_to_min(
                args.w_size, args.m_size, args.input, out, args.threads,
                shard=ctx.shard_for(args.input) if ctx else None,
            )
            if ctx:
                from kmertools_jax.parallel import multihost

                multihost.finalize_parts(ctx, args.output)

    elif args.command == "ctr":
        from kmertools_jax.workloads.counter import CountComputer

        create_directory(args.output)
        ctr = CountComputer(args.input, args.output, args.k_size)
        if args.threads > 0:
            ctr.set_threads(args.threads)
        if args.acgt:
            ctr.set_acgt_output(True)
        ctr.set_max_memory(float(args.memory))
        if ctx:
            ctr.set_multihost(ctx)
        ctr.count_and_merge(True)

    return 0


if __name__ == "__main__":
    sys.exit(main())
