"""Batched multi-sample solving matches per-sample solving bit-for-bit."""

import numpy as np

from genome_downsampler_tpu.solvers.batched import solve_batch
from genome_downsampler_tpu.solvers.device_sweep import McpDeviceSweepSolver
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform


def test_batched_matches_individual():
    rng = np.random.default_rng(0)
    batches = [rand_reads_uniform(rng, 400 + 100 * i, 4096, 60) for i in range(4)]
    m = 6
    got = solve_batch(batches, m, max_span=64, pad_multiple=1024)
    solver = McpDeviceSweepSolver(max_span=64, pad_multiple=1024)
    for b, sel in zip(batches, got):
        np.testing.assert_array_equal(sel, solver.solve(m, b))


def test_batched_empty():
    assert solve_batch([], 5) == []
