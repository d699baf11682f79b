"""Smoke test of exact MCP downsampling on an NVIDIA GPU.

    python chip_smoke.py           # one GPU: phases 0-4 below
    python chip_smoke.py --four    # four GPUs of one host: the sharded path

Phases (one GPU):

0. kernel: the blocked sweep kernel, compiled for the card, against the
   plain XLA reference (vmapped ``sweep_counts``) at L = 256, 64 windows;
   per-end counts and rounds must be equal.
1. config-1 (1M pairs / 30 kb / M=1000): the CLI with ``-a mcp-tpu``
   against ``-a mcp-cpu``; the output BAMs must be byte-identical.
2. config-4 (10M reads / 5 Mb / M=50): the same on the blocked path, plus
   the solver's relaxation rounds and phase laps.
3. headline shape (25M reads / 62.5 Mb / M=30): ``McpDeviceSweepSolver``
   against the host C++ greedy; the selected indices must be identical.
4. every device solver name through the ``test`` subcommand.

``--four`` runs only the sharded path: ``--sharded -a mcp-tpu`` over the
four cards on the config-4 BAM, against the one-card ``-a mcp-tpu``
output (byte-identical), and checks that the compiled mesh program
exchanges carries with collective-permutes and that every card holds
part of the result.

Inputs are synthesized from fixed seeds into ``.bench_cache/``. Everything
runs in this one process, so one JAX process holds the cards. The last
line of standard output is one JSON object; any failed phase raises, and
the script then exits non-zero without printing it.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".bench_cache")
SEED = 12345
READ_LEN = 150
TEST_SCALE = 0.01  # test-subcommand fixtures: 20k reads each


def log(**kw) -> None:
    print(json.dumps(kw), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def synth_bam(name: str, batch) -> str:
    from genome_downsampler_tpu.testing.bam_writer import write_test_bam_fast

    os.makedirs(CACHE, exist_ok=True)
    path = os.path.join(CACHE, name)
    if not os.path.exists(path):
        write_test_bam_fast(path + ".tmp", batch)
        os.replace(path + ".tmp", path)
    return path


def fixed_length_batch(starts, n):
    import numpy as np

    from genome_downsampler_tpu.core.readbatch import ReadBatch

    r = starts.shape[0]
    return ReadBatch(
        bam_id=np.arange(r, dtype=np.int64),
        start=starts,
        end=starts + READ_LEN - 1,
        quality=np.full(r, 60, np.int32),
        seq_length=np.full(r, READ_LEN, np.int32),
        is_first=np.tile([True, False], r // 2),
        ref_genome_length=n,
    )


def config1_bam() -> str:
    import numpy as np

    from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform

    batch = rand_reads_uniform(
        np.random.default_rng(SEED), 1_000_000, 30_000, READ_LEN
    )
    return synth_bam("smoke_config1.bam", batch)


def config4_bam() -> str:
    import numpy as np

    n, r = 5_000_000, 10_000_000
    rng = np.random.default_rng(SEED)
    starts = rng.integers(0, n - READ_LEN, r, dtype=np.int64)
    return synth_bam("smoke_config4.bam", fixed_length_batch(starts, n))


def cli(*argv: str) -> float:
    from genome_downsampler_tpu.cli.main import main

    t0 = time.perf_counter()
    rc = main(list(argv))
    if rc != 0:
        raise RuntimeError(f"CLI {' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0


def compare_cli(tag: str, bam: str, m: int) -> None:
    """mcp-tpu twice (cold, then warm) and mcp-cpu once; byte-identical."""
    base = os.path.join(CACHE, f"smoke_{tag}")
    opts = ("-l", "0", "-q", "0")
    dev, host_bam = base + "_device.bam", base + "_host.bam"
    cold = cli(bam, str(m), "-o", dev, "-a", "mcp-tpu", *opts)
    warm = cli(bam, str(m), "-o", dev, "-a", "mcp-tpu", *opts)
    host = cli(bam, str(m), "-o", host_bam, "-a", "mcp-cpu", *opts)
    same = filecmp.cmp(dev, host_bam, shallow=False)
    log(phase=tag, device_first_s=cold, device_warm_s=warm, host_s=host,
        bam_bytes=os.path.getsize(host_bam), byte_identical=same)
    if not same:
        raise AssertionError(f"{tag}: mcp-tpu output differs from mcp-cpu")


def phase_kernel() -> None:
    import jax.numpy as jnp
    import numpy as np

    from genome_downsampler_tpu.ops.pallas_blocked import (
        blocked_windowed_sweep,
        group_size,
        pack_blocked,
        window_length,
    )

    n, W, B, L, m = 1 << 21, 64, 256, 256, 30
    rng = np.random.default_rng(SEED)
    start = rng.integers(0, n - 200, 60 * n // READ_LEN)
    end = start + rng.integers(99, READ_LEN, start.shape[0])
    G = group_size(W, L, B, n // W)
    win = window_length(n, W, G)
    packed, _, _, _ = pack_blocked(start, end, W * win, W, B, L, 256)
    p = jnp.asarray(packed)
    kw = dict(block=B, max_span=L, group=G, max_coverage=m)
    res = {}
    for route in ("kernel", "xla"):
        t0 = time.perf_counter()
        sel, k = blocked_windowed_sweep(p, None, route=route, **kw)
        sel = np.asarray(sel)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        np.asarray(blocked_windowed_sweep(p, None, route=route, **kw)[0])
        res[route] = (sel, int(k), first, time.perf_counter() - t0)
    same = bool(np.array_equal(res["kernel"][0], res["xla"][0]))
    log(phase="kernel", n=n, windows=W, max_span=L, group=G,
        rounds=res["kernel"][1], kernel_first_s=res["kernel"][2],
        kernel_warm_s=res["kernel"][3], xla_first_s=res["xla"][2],
        xla_warm_s=res["xla"][3], equal_to_reference=same)
    if not same or res["kernel"][1] != res["xla"][1]:
        raise AssertionError("blocked sweep kernel differs from reference")


def phase_config4_stats(bam: str) -> None:
    from genome_downsampler_tpu.config import BamApiConfig
    from genome_downsampler_tpu.io.bam import BamReader
    from genome_downsampler_tpu.solvers.device_sweep import (
        McpDeviceSweepSolver,
    )

    batch = BamReader(bam, BamApiConfig(min_mapq=0, min_seq_length=0))
    batch = batch.get_batch()
    solver = McpDeviceSweepSolver()
    solver.solve(50, batch)
    log(phase="config4_solver", **solver.last_stats)


def phase_headline() -> None:
    import numpy as np

    from genome_downsampler_tpu.solvers.device_sweep import (
        McpDeviceSweepSolver,
    )
    from genome_downsampler_tpu.solvers.native_greedy import (
        NativeGreedyMcpSolver,
    )

    r, m = 25_000_000, 30
    n = r * READ_LEN // 60
    i = np.arange(r, dtype=np.uint32)
    starts = ((i * np.uint32(2654435761) + np.uint32(SEED))
              % np.uint32(n - READ_LEN + 1)).astype(np.int64)
    batch = fixed_length_batch(starts, n)
    t0 = time.perf_counter()
    host = NativeGreedyMcpSolver().solve(m, batch)
    host_s = time.perf_counter() - t0
    solver = McpDeviceSweepSolver()
    t0 = time.perf_counter()
    dev = solver.solve(m, batch)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = solver.solve(m, batch)
    warm = time.perf_counter() - t0
    same = bool(np.array_equal(dev, host))
    log(phase="headline", reads=r, genome=n, max_coverage=m,
        host_greedy_s=host_s, device_first_s=first, device_warm_s=warm,
        selected=int(len(host)), identical=same, **solver.last_stats)
    if not same:
        raise AssertionError("headline: device selection != host greedy")


def phase_solver_names() -> None:
    names = ["mcp-tpu", "qmcp-tpu", "qmcp-sweep-tpu", "quasi-mcp-flow-tpu",
             "mcp-tpu-blocked"]
    t0 = time.perf_counter()
    cli("test", "-a", *names, "--scale", str(TEST_SCALE))
    log(phase="solver_names", algorithms=names, scale=TEST_SCALE,
        seconds=time.perf_counter() - t0)


def phase_four() -> None:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from genome_downsampler_tpu.ops.pallas_blocked import (
        group_size,
        window_length,
    )
    from genome_downsampler_tpu.parallel.blocked_mesh import (
        make_blocked_mesh_solver,
    )

    devices = jax.devices()
    if len(devices) != 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {len(devices)}")
    bam = config4_bam()
    base = os.path.join(CACHE, "smoke_four")
    opts = ("-l", "0", "-q", "0")
    one = cli(bam, "50", "-o", base + "_one.bam", "-a", "mcp-tpu", *opts)
    shard = cli(bam, "50", "-o", base + "_sharded.bam", "-a", "mcp-tpu",
                "--sharded", *opts)
    peaks = [d.memory_stats().get("peak_bytes_in_use", 0) for d in devices]
    same = filecmp.cmp(base + "_one.bam", base + "_sharded.bam",
                       shallow=False)
    # the mesh program run_sharded builds for this genome (5 Mb, 8 windows
    # per card): its carries must cross cards as collective-permutes
    W_local, B, L = 8, 256, 256
    G = group_size(W_local, L, B, -(-5_000_000 // (4 * W_local)))
    win = window_length(5_000_000, 4 * W_local, G)
    mesh = Mesh(np.array(devices), ("x",))
    fn, _, _ = make_blocked_mesh_solver(
        mesh, block=B, max_span=L, group=G, route="kernel"
    )
    hlo = fn.lower(
        jax.ShapeDtypeStruct((win // B, 4 * W_local, 256), np.int32),
        jax.ShapeDtypeStruct((4 * W_local, win), np.int32),
    ).compile().as_text()
    permutes = hlo.count("collective-permute")
    log(phase="four", one_card_s=one, sharded_s=shard, byte_identical=same,
        collective_permutes_in_hlo=permutes, peak_bytes_per_card=peaks)
    if not same:
        raise AssertionError("--sharded output differs from one card")
    if permutes == 0 or min(peaks) == 0:
        raise AssertionError("carries not exchanged across all four cards")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path over four GPUs")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's device is {dev.platform}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from genome_downsampler_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    log(compile_cache=enable_compile_cache())
    print(card_line(), flush=True)
    phases = (
        [("four", phase_four)] if args.four else [
            ("kernel", phase_kernel),
            ("config1", lambda: compare_cli("config1", config1_bam(), 1000)),
            ("config4", lambda: compare_cli("config4", config4_bam(), 50)),
            ("config4_solver", lambda: phase_config4_stats(config4_bam())),
            ("headline", phase_headline),
            ("solver_names", phase_solver_names),
        ]
    )
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        log(phase_done=name, seconds=time.perf_counter() - t0)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
