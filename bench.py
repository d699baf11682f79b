"""Benchmark: exact downsampling throughput, device vs host C++.

Headline: **exact minimum-count MCP at quarter-chr1 scale** — 25M reads,
62.5 Mb genome (chr1 coverage shape: 60x capped to 30x), the production
``mcp-tpu`` path end-to-end from host arrays: host-side blocked packing,
host->device transfer, capped-coverage target + multi-window sweep with
carry relaxation and on-device reconstruction (one jit), device->host
readback of the selection bitmask, and the C bit test — ALL inside the
timed window. Compilation is warmed on a different seeded dataset of the
same shapes first (a production service compiles once per shape).

vs_baseline: the same selection computed by this framework's exact C++
host greedy (``io/csrc/greedy.cpp``) on the identical reads — the
conservative CPU yardstick (the reference publishes no numbers and its
OR-Tools min-cost-flow solvers are strictly slower than the greedy;
BASELINE.md). Both paths must select the same reads; the assert enforces
it.

detail carries BAM -> BAM wall times on synthesized coordinate-sorted
BAMs at config-1 (the reference's largest exercised workload, its
``src/tests/coverage_tester.cpp:120-135``), config-4
(10M reads / 5 Mb) and config-5 (100M reads / 250 Mb, when a cached
1.2 GB input exists) — parse, solve, pairing, and the re-stream write on
both device and host paths.

Needs a GPU: without one it prints a failure line and exits non-zero.
Prints ONE JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# headline: quarter-chr1 scale
HEAD_READS = 25_000_000
HEAD_M = 30
READ_LEN = 150
HEAD_GENOME = HEAD_READS * READ_LEN // 60  # 60x mean coverage
WEYL = np.uint32(2654435761)

# config-1 detail scale
PAIRS = 1_000_000
GENOME = 30_000
M = 1000
SEED = 12345

METRIC = "mcp_e2e_reads_per_s_25M_62Mb"


def _fail_json(msg: str) -> str:
    return json.dumps(
        {
            "metric": METRIC,
            "value": 0,
            "unit": "reads/s",
            "vs_baseline": 0.0,
            "detail": {"error": msg},
        }
    )


def _trace(msg: str) -> None:
    """Phase progress on stderr (never parsed)."""
    print(f"[bench +{time.perf_counter() - _T0:.1f}s] {msg}",
          file=sys.stderr, flush=True)


_T0 = time.perf_counter()


def _weyl_batch(r: int, n: int, shift: int):
    """Low-discrepancy read batch (60x of fixed-length reads), shifted by
    ``shift`` so the warm-up and the timed run see different data of the
    same shapes. Host and device consume the SAME arrays."""
    from genome_downsampler_tpu.core.readbatch import ReadBatch

    i = np.arange(r, dtype=np.uint32)
    s = (
        (i * WEYL + np.uint32(shift)) % np.uint32(n - READ_LEN + 1)
    ).astype(np.int64)
    return ReadBatch(
        bam_id=np.arange(r, dtype=np.int64),
        start=s,
        end=s + READ_LEN - 1,
        quality=np.full(r, 60, np.int64),
        seq_length=np.full(r, READ_LEN, np.int64),
        is_first=np.tile([True, False], r // 2),
        ref_genome_length=n,
    )


def _headline(use_device: bool) -> dict:
    from genome_downsampler_tpu.solvers.device_sweep import McpDeviceSweepSolver
    from genome_downsampler_tpu.solvers.native_greedy import NativeGreedyMcpSolver

    shift = SEED
    t0 = time.perf_counter()
    batch = _weyl_batch(HEAD_READS, HEAD_GENOME, shift)
    gen_s = time.perf_counter() - t0
    _trace(f"headline: generated {HEAD_READS} reads in {gen_s:.1f}s")

    # host baseline: cold AND warm runs; the ratio is taken against the
    # warm run, the conservative bar
    host = NativeGreedyMcpSolver()
    t0 = time.perf_counter()
    host_sel = host.solve(HEAD_M, batch)
    t_host_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_sel = host.solve(HEAD_M, batch)
    t_host = time.perf_counter() - t0
    _trace(f"headline: host greedy cold {t_host_cold:.1f}s warm {t_host:.1f}s")

    out = {
        "scale": f"{HEAD_READS/1e6:.0f}M reads / {HEAD_GENOME/1e6:.1f} Mb / "
                 f"M={HEAD_M} (60x -> {HEAD_M}x)",
        "host_cpp_greedy_cold_s": round(t_host_cold, 2),
        "host_cpp_greedy_s": round(t_host, 2),
        "selected": int(len(host_sel)),
        "gen_s": round(gen_s, 2),
    }
    if not use_device:
        return out

    solver = McpDeviceSweepSolver()
    # warm the compile on a different dataset of the same static shapes
    warm = _weyl_batch(HEAD_READS, HEAD_GENOME, (shift + 7919) & 0x3FFFFFFF)
    t0 = time.perf_counter()
    _ = solver.solve(HEAD_M, warm)
    out["device_warmup_incl_compile_s"] = round(time.perf_counter() - t0, 2)
    _trace(f"headline: device warmup {out['device_warmup_incl_compile_s']}s")

    # two timed device runs on two datasets; the batch-1 run carries the
    # ratio
    t0 = time.perf_counter()
    dev_sel = solver.solve(HEAD_M, batch)
    t_dev = time.perf_counter() - t0
    _trace(f"headline: device timed run {t_dev:.1f}s")
    assert np.array_equal(dev_sel, host_sel), (len(dev_sel), len(host_sel))
    batch2 = _weyl_batch(HEAD_READS, HEAD_GENOME, (shift + 104729) & 0x3FFFFFFF)
    t0 = time.perf_counter()
    dev_sel2 = solver.solve(HEAD_M, batch2)
    t_dev2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_sel2 = host.solve(HEAD_M, batch2)
    t_host2 = time.perf_counter() - t0
    assert np.array_equal(dev_sel2, host_sel2)
    _trace(f"headline: rep2 device {t_dev2:.1f}s host {t_host2:.1f}s")
    out["device_e2e_s"] = round(t_dev, 2)
    out["device_vs_host"] = round(t_host / t_dev, 3)
    out["rep2_device_e2e_s"] = round(t_dev2, 2)
    out["rep2_host_warm_s"] = round(t_host2, 2)
    out["rep2_device_vs_host"] = round(t_host2 / t_dev2, 3)
    stats = getattr(solver, "last_stats", None)
    if stats:
        out["relaxation_rounds"] = stats["rounds"]
        out["n_windows"] = stats["n_windows"]
        out["rounds_per_s"] = round(stats["rounds"] / t_dev2, 3)
    out["note"] = (
        "device window includes host-side packing, H2D transfer, the "
        "sweep + on-device reconstruction jit, bitmask readback, and the "
        "C bit test; ratio vs the warm host run"
    )
    return out


def _bam_to_bam(bam_path, out_path, solver, max_coverage, config):
    """The full CLI pipeline, timed per phase. Returns (total_s, phases)."""
    from genome_downsampler_tpu.io.bam import BamReader

    t0 = time.perf_counter()
    reader = BamReader(bam_path, config)
    batch = reader.get_batch()
    t1 = time.perf_counter()
    solution = np.asarray(solver.solve(max_coverage, batch), np.int64)
    t2 = time.perf_counter()
    paired = batch.find_pairs(solution)
    reader.write_paired_reads(out_path, paired)
    t3 = time.perf_counter()
    return t3 - t0, {
        "bam_read_s": round(t1 - t0, 3),
        "solve_s": round(t2 - t1, 3),
        "pair_write_s": round(t3 - t2, 3),
        "selected": int(len(paired)),
    }


def _config1_bam_detail(use_device: bool) -> dict:
    """Reference config-1 scale, honest BAM -> BAM on both paths."""
    from genome_downsampler_tpu.config import BamApiConfig
    from genome_downsampler_tpu.solvers.device_sweep import McpDeviceSweepSolver
    from genome_downsampler_tpu.solvers.native_greedy import NativeGreedyMcpSolver
    from genome_downsampler_tpu.testing.bam_writer import write_test_bam
    from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform

    rng = np.random.default_rng(SEED)
    batch = rand_reads_uniform(rng, PAIRS, GENOME, READ_LEN)
    cache_dir = os.path.join(os.path.dirname(__file__), ".bench_cache")
    os.makedirs(cache_dir, exist_ok=True)
    bam_in = os.path.join(cache_dir, "config1.bam")
    t0 = time.perf_counter()
    write_test_bam(bam_in, batch, coordinate_sorted=True, make_index=True)
    synth_s = time.perf_counter() - t0
    config = BamApiConfig(min_mapq=0, min_seq_length=0)

    host_total, host_phases = _bam_to_bam(
        bam_in, os.path.join(cache_dir, "c1_host.bam"),
        NativeGreedyMcpSolver(), M, config,
    )
    out = {
        "host_bam_to_bam_s": round(host_total, 3),
        "host_phases": host_phases,
        "bam_synth_s": round(synth_s, 1),
    }
    if use_device:
        dev_solver = McpDeviceSweepSolver()
        _ = dev_solver.solve(M, batch)  # warm compile
        dev_total, dev_phases = _bam_to_bam(
            bam_in, os.path.join(cache_dir, "c1_dev.bam"), dev_solver, M, config,
        )
        assert dev_phases["selected"] == host_phases["selected"]
        out["device_bam_to_bam_s"] = round(dev_total, 3)
        out["device_phases"] = dev_phases
    return out


# config-4: E. coli scale BAM -> BAM, between the I/O-bound config-1
# detail and the synthetic headline
C4_READS = 10_000_000
C4_GENOME = 5_000_000
C4_M = 50

# config-5: chr1 scale BAM -> BAM, the full pipeline at 100M reads /
# 250 Mb (60x -> 30x). The 1.2 GB input BAM is not generated here; the
# section is skipped when .bench_cache/ does not hold it.
C5_READS = 100_000_000
C5_GENOME = 250_000_000
C5_M = 30


def _config5_bam_detail(use_device: bool) -> dict:
    from genome_downsampler_tpu.config import BamApiConfig
    from genome_downsampler_tpu.solvers.device_sweep import McpDeviceSweepSolver
    from genome_downsampler_tpu.solvers.native_greedy import NativeGreedyMcpSolver

    cache_dir = os.path.join(os.path.dirname(__file__), ".bench_cache")
    bam_in = os.path.join(cache_dir, f"config5_{C5_READS}_{C5_GENOME}.bam")
    if not os.path.exists(bam_in):
        return {"skipped": "no cached config-5 BAM (synthesize out of band)"}
    config = BamApiConfig(min_mapq=0, min_seq_length=0)
    out = {
        "scale": f"{C5_READS/1e6:.0f}M reads / {C5_GENOME/1e6:.0f} Mb / "
                 f"M={C5_M} (BAM -> BAM)",
    }
    host_total, host_phases = _bam_to_bam(
        bam_in, os.path.join(cache_dir, "c5_host.bam"),
        NativeGreedyMcpSolver(), C5_M, config,
    )
    out.update(
        host_bam_to_bam_s=round(host_total, 3),
        host_phases=host_phases,
        host_reads_per_s=round(C5_READS / host_total),
    )
    if use_device:
        dev_solver = McpDeviceSweepSolver()
        # warm the jit on a synthetic batch of the same shapes: the cached
        # config-5 BAM pairs every read, so the post-pairing count is
        # exactly C5_READS and the packed shapes match without paying a
        # 100M-record parse just to warm the compile
        t0 = time.perf_counter()
        wb = _weyl_batch(C5_READS, C5_GENOME, 913)
        _ = dev_solver.solve(C5_M, wb)
        out["device_warmup_incl_compile_s"] = round(
            time.perf_counter() - t0, 2
        )
        del wb
        dev_total, dev_phases = _bam_to_bam(
            bam_in, os.path.join(cache_dir, "c5_dev.bam"), dev_solver, C5_M, config,
        )
        assert dev_phases["selected"] == host_phases["selected"]
        out["device_bam_to_bam_s"] = round(dev_total, 3)
        out["device_phases"] = dev_phases
        out["device_reads_per_s"] = round(C5_READS / dev_total)
        stats = getattr(dev_solver, "last_stats", None)
        if stats:
            out["relaxation_rounds"] = stats["rounds"]
            out["device_solve_detail"] = stats
    return out


def _config4_bam_detail(use_device: bool) -> dict:
    from genome_downsampler_tpu.config import BamApiConfig
    from genome_downsampler_tpu.core.readbatch import ReadBatch
    from genome_downsampler_tpu.solvers.device_sweep import McpDeviceSweepSolver
    from genome_downsampler_tpu.solvers.native_greedy import NativeGreedyMcpSolver
    from genome_downsampler_tpu.testing.bam_writer import write_test_bam_fast

    cache_dir = os.path.join(os.path.dirname(__file__), ".bench_cache")
    os.makedirs(cache_dir, exist_ok=True)
    bam_in = os.path.join(cache_dir, f"config4_{C4_READS}_{C4_GENOME}.bam")
    out = {}
    if not os.path.exists(bam_in):
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED)
        starts = rng.integers(0, C4_GENOME - READ_LEN, C4_READS,
                              dtype=np.int64)
        batch = ReadBatch(
            bam_id=np.arange(C4_READS, dtype=np.int64),
            start=starts,
            end=starts + READ_LEN - 1,
            quality=np.full(C4_READS, 60, np.int32),
            seq_length=np.full(C4_READS, READ_LEN, np.int32),
            is_first=np.tile([True, False], C4_READS // 2),
            ref_genome_length=C4_GENOME,
        )
        write_test_bam_fast(bam_in, batch)
        out["bam_synth_s"] = round(time.perf_counter() - t0, 1)
        del batch
    config = BamApiConfig(min_mapq=0, min_seq_length=0)

    host_total, host_phases = _bam_to_bam(
        bam_in, os.path.join(cache_dir, "c4_host.bam"),
        NativeGreedyMcpSolver(), C4_M, config,
    )
    out.update(
        scale=f"{C4_READS/1e6:.0f}M reads / {C4_GENOME/1e6:.0f} Mb / "
              f"M={C4_M} (BAM -> BAM)",
        host_bam_to_bam_s=round(host_total, 3),
        host_phases=host_phases,
        host_reads_per_s=round(C4_READS / host_total),
    )
    if use_device:
        from genome_downsampler_tpu.io.bam import BamReader

        dev_solver = McpDeviceSweepSolver()
        # warm the jit on a same-shape batch (one read's span perturbed:
        # identical static shapes, different data) so compiles of this
        # geometry do not land inside the timed solve phase
        t0 = time.perf_counter()
        wb = BamReader(bam_in, config).get_batch()
        wb.end[0] = max(int(wb.start[0]), int(wb.end[0]) - 1)
        _ = dev_solver.solve(C4_M, wb)
        out["device_warmup_incl_compile_s"] = round(
            time.perf_counter() - t0, 2
        )
        del wb
        dev_total, dev_phases = _bam_to_bam(
            bam_in, os.path.join(cache_dir, "c4_dev.bam"), dev_solver, C4_M, config,
        )
        assert dev_phases["selected"] == host_phases["selected"]
        out["device_bam_to_bam_s"] = round(dev_total, 3)
        out["device_phases"] = dev_phases
        out["device_reads_per_s"] = round(C4_READS / dev_total)
        stats = getattr(dev_solver, "last_stats", None)
        if stats:
            out["relaxation_rounds"] = stats["rounds"]
            out["device_solve_detail"] = stats
    return out


def main() -> int:
    import jax

    from genome_downsampler_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(_fail_json(f"no GPU: JAX's default device is {dev.platform}"))
        return 1
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    head = _headline(use_device=True)
    result = {
        "metric": METRIC,
        "value": round(HEAD_READS / head["device_e2e_s"]),
        "unit": "reads/s",
        "vs_baseline": round(head["host_cpp_greedy_s"] / head["device_e2e_s"], 3),
        "detail": {"device": device, "headline": head},
    }
    _trace("config4 BAM->BAM detail")
    result["detail"]["config4_bam_to_bam"] = _config4_bam_detail(True)
    _trace("config5 BAM->BAM detail")
    result["detail"]["config5_bam_to_bam"] = _config5_bam_detail(True)
    _trace("config1 BAM->BAM detail")
    result["detail"]["config1_bam_to_bam"] = _config1_bam_detail(True)
    _trace("done")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
