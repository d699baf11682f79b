"""Command-line interface.

Same surface as the reference binary (``/root/reference/src/app.cpp:26-107``):

    genome-downsampler INPUT_FILEPATH MAX_COVERAGE [-o OUT] [-a ALGO]
        [-b BED] [-t TSV] [-p FILTERED_OUT] [-l MIN_LEN] [-q MIN_MAPQ]
        [-@ THREADS] [-v]
    genome-downsampler test [-a ALGO...] [-t TESTER...] [-o DIR]

Deviations (documented): ``-v`` actually raises the log level (the
reference parses it but never uses it, SURVEY.md section 5.5); solver names
gain ``*-tpu`` entries (the device solvers, run on the GPU) and lose
``quasi-mcp-cuda``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import List, Optional

from genome_downsampler_tpu.config import AmpliconBehaviour, BamApiConfig
from genome_downsampler_tpu.solvers.registry import (
    DEFAULT_SOLVER_NAME,
    default_registry,
)
from genome_downsampler_tpu.utils.logging import get_logger, set_verbosity

_log = get_logger("cli")


def build_parser(registry) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="genome-downsampler",
        description="Genomic read downsampling to a maximum per-base "
        "coverage.",
    )
    p.add_argument("input", nargs="?", metavar="INPUT_FILEPATH",
                   help=".bam input file path. Required option.")
    p.add_argument("max_coverage", nargs="?", type=int, metavar="MAX_COVERAGE",
                   help="Maximum coverage per reference genome's base pair index.")
    p.add_argument("-o", "--output", type=Path,
                   help='.bam output file path. Default is "output.bam" in '
                        "input's directory.")
    p.add_argument("-a", "--algorithm", default=DEFAULT_SOLVER_NAME,
                   choices=registry.get_names(),
                   help=f'Algorithm to use. Default is "{DEFAULT_SOLVER_NAME}"')
    p.add_argument("-b", "--bed", type=Path,
                   help=".bed amplicon bounds specification.")
    p.add_argument("-t", "--tsv", type=Path,
                   help=".tsv pairing of .bed amplicon primers.")
    p.add_argument("-p", "--preprocessing-out", type=Path,
                   help=".bam output for reads filtered out during "
                        "preprocessing (debugging).")
    p.add_argument("-l", "--min-length", type=int, default=90,
                   help="Minimal sequence length. Default is 90.")
    p.add_argument("-q", "--min-mapq", type=int, default=30,
                   help="Minimal MAPQ value. Default is 30.")
    p.add_argument("-@", "--threads", type=int, default=2, dest="threads",
                   help="Thread count for BAM read/write.")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Execute with additional logging.")
    p.add_argument("--profile-dir", type=Path, default=None,
                   help="Capture a jax.profiler trace of the solve into "
                        "this directory (TensorBoard format).")
    p.add_argument("--windows", type=int, default=1,
                   help="Shard the genome into this many coordinate windows "
                        "solved in parallel on device (mcp-tpu/quasi-mcp-tpu "
                        "only; the result stays bit-identical to one window).")
    p.add_argument("--sharded", action="store_true",
                   help="Host-sharded pipeline: every process of the "
                        "jax.distributed job (GD_COORDINATOR / "
                        "GD_NUM_PROCESSES / GD_PROCESS_ID) reads only its "
                        "genome window from the (coordinate-sorted, "
                        "indexed) input, solves on the global device mesh, "
                        "and process 0 writes the merged output — "
                        "bit-identical to a single-process run.")
    p.add_argument("--halo", type=int, default=2000,
                   help="Sharded-mode window overlap; must be at least "
                        "(max read span + max mate start distance) or "
                        "boundary pairs are dropped. Default 2000.")
    return p


def build_test_parser(registry) -> argparse.ArgumentParser:
    t = argparse.ArgumentParser(
        prog="genome-downsampler test",
        description="Run solver correctness tests.",
    )
    t.add_argument("-a", "--algorithms", nargs="*", default=[],
                   choices=registry.get_names(),
                   help="Algorithms to test (default: all).")
    t.add_argument("-t", "--tests", nargs="*", default=[],
                   help="Testers to run (default: all).")
    t.add_argument("-o", "--outputs-dir", type=Path,
                   help="Directory for per-test .cov outputs.")
    t.add_argument("--scale", type=float, default=1.0,
                   help="Fixture size multiplier (1.0 = reference-size, 1M pairs).")
    t.add_argument("-v", "--verbose", action="store_true")
    return t


def run_downsample(args, registry) -> int:
    if not args.input or not args.max_coverage:
        _log.error("INPUT_FILEPATH and MAX_COVERAGE must be specified")
        return 1
    if args.max_coverage <= 0:
        _log.error("MAX_COVERAGE must be an integer bigger than 0")
        return 1
    input_path = Path(args.input)
    if not input_path.exists():
        _log.error("Input file does not exist: %s", input_path)
        return 1
    output_path = args.output or input_path.parent / "output.bam"

    # amplicon behaviour depends on the solver, app.cpp:120-128
    behaviour = AmpliconBehaviour.IGNORE
    if args.bed:
        behaviour = (
            AmpliconBehaviour.GRADE
            if registry.uses_quality_of_reads(args.algorithm)
            else AmpliconBehaviour.FILTER
        )
    config = BamApiConfig(
        min_seq_length=args.min_length,
        min_mapq=args.min_mapq,
        hts_thread_count=args.threads,
        amplicon_behaviour=behaviour,
        bed_path=args.bed,
        tsv_path=args.tsv,
    )

    if args.sharded:
        import jax

        from genome_downsampler_tpu.parallel.launch import initialize_distributed
        from genome_downsampler_tpu.parallel.sharded_io import run_sharded

        if args.preprocessing_out:
            _log.error("--preprocessing-out is not supported with --sharded")
            return 1
        from genome_downsampler_tpu.parallel.sharded_io import QUALITY_ALGOS

        if args.algorithm not in (
            "quasi-mcp-cpu", "mcp-cpu", "mcp-tpu", "quasi-mcp-tpu",
            "mcp-tpu-blocked", *QUALITY_ALGOS,
        ):
            _log.error(
                "algorithm %r is not supported in sharded mode (MCP names "
                "run the mesh sweep; QMCP names run the distributed-parse "
                "exact MCMF)", args.algorithm)
            return 1
        if args.windows > 1:
            _log.error("--windows is implied by --sharded; do not combine")
            return 1
        initialize_distributed()
        start = time.perf_counter()
        merged = run_sharded(
            input_path, args.max_coverage, config,
            output_path if jax.process_index() == 0 else None,
            halo=args.halo, algorithm=args.algorithm,
        )
        _log.info(
            "sharded solve+write: %d reads in %.3f s (rank %d/%d)",
            len(merged), time.perf_counter() - start,
            jax.process_index(), jax.process_count(),
        )
        return 0

    from genome_downsampler_tpu.io.bam import BamReader

    reader = BamReader(input_path, config)
    batch = reader.get_batch()
    if args.windows > 1:
        if args.algorithm not in ("mcp-tpu", "quasi-mcp-tpu"):
            _log.error(
                "--windows is only supported with mcp-tpu/quasi-mcp-tpu; "
                "algorithm %r would silently ignore it", args.algorithm)
            return 1
        from genome_downsampler_tpu.parallel.windows import WindowedMcpSolver
        from genome_downsampler_tpu.solvers.base import SpanGuard

        solver = SpanGuard(WindowedMcpSolver(n_windows=args.windows))
    else:
        solver = registry.get(args.algorithm)

    import numpy as np

    from genome_downsampler_tpu.utils.profiling import trace

    start = time.perf_counter()
    # multi-contig inputs are solved one contig at a time (each has its own
    # coordinate system); the reference instead applies its first contig's
    # length everywhere (bam_api.cpp:422) — documented deviation
    with trace(args.profile_dir):
        groups = batch.split_by_contig()
        if len(groups) > 1:
            _log.info("input has %d contigs with reads; solving per contig",
                      len(groups))
        parts = [
            idx[np.asarray(solver.solve(args.max_coverage, sub), np.int64)]
            for _, sub, idx in groups
        ]
        solution = (
            np.concatenate(parts) if parts else np.zeros(0, np.int64)
        )
    _log.debug("solve took %.6f seconds", time.perf_counter() - start)

    paired = batch.find_pairs(solution)
    _log.info("Writing solution of size %d reads to %s...",
              len(paired), output_path.name)
    reader.write_paired_reads(output_path, paired)

    if args.preprocessing_out:
        _log.info("Writing %d preprocessing filtered out reads to %s...",
                  len(reader.filtered_out), args.preprocessing_out)
        reader.write_filtered_out_reads(args.preprocessing_out)
    return 0


def run_test(args, registry) -> int:
    from genome_downsampler_tpu.testing.coverage_tester import (
        TESTER_NAMES,
        get_tester,
    )

    solvers = args.algorithms or registry.get_names()
    testers = args.tests or TESTER_NAMES
    outputs_dir = args.outputs_dir
    if outputs_dir and not outputs_dir.exists():
        _log.error("Directory: %s does not exist!", outputs_dir)
        return 1
    for tester_name in testers:
        tester = get_tester(tester_name, scale=args.scale)
        _log.info("Running test %s", tester_name)
        for solver_name in solvers:
            _log.info("\ton algorithm %s", solver_name)
            out = None
            if outputs_dir:
                out = outputs_dir / tester_name / solver_name
                out.mkdir(parents=True, exist_ok=True)
            tester.test(registry.get(solver_name), out)
            _log.info("\t\t PASSED")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    from genome_downsampler_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    registry = default_registry()
    if argv[:1] == ["test"]:
        args = build_test_parser(registry).parse_args(argv[1:])
        set_verbosity(args.verbose)
        return run_test(args, registry)
    args = build_parser(registry).parse_args(argv)
    set_verbosity(args.verbose)
    return run_downsample(args, registry)


if __name__ == "__main__":
    sys.exit(main())
