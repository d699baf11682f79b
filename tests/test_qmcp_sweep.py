"""Quality-aware device QMCP: count-optimal, valid, quality-maximal within
the sweep's take structure."""

import numpy as np
import pytest

from genome_downsampler_tpu.solvers.device_sweep import (
    McpDeviceSweepSolver,
    QmcpDeviceSweepSolver,
)
from genome_downsampler_tpu.solvers.native_mcmf import NativeQmcpSolver
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform


def np_coverage(batch, n, sel=None):
    cov = np.zeros(n + 1, np.int64)
    s = batch.start if sel is None else batch.start[sel]
    e = batch.end if sel is None else batch.end[sel]
    np.add.at(cov, np.clip(s, 0, n), 1)
    np.add.at(cov, np.clip(e + 1, 0, n), -1)
    return np.cumsum(cov)[:n]


@pytest.mark.parametrize("seed,m", [(0, 3), (1, 6), (2, 2)])
def test_qmcp_sweep_valid_count_optimal_quality_better(seed, m):
    rng = np.random.default_rng(seed)
    batch = rand_reads_uniform(rng, 1500, 4096, 60)
    qmcp = QmcpDeviceSweepSolver(max_span=64, pad_multiple=1024)
    mcp = McpDeviceSweepSolver(max_span=64, pad_multiple=1024)
    sel_q = qmcp.solve(m, batch)
    sel_m = mcp.solve(m, batch)
    n = batch.ref_genome_length
    capped = np.minimum(np_coverage(batch, n), m)
    assert np.all(np_coverage(batch, n, sel_q) >= capped)
    assert len(sel_q) == len(sel_m), "count optimality must be preserved"
    q = np.asarray(batch.quality, np.int64)
    assert q[sel_q].sum() >= q[sel_m].sum(), (
        "quality-aware assignment must not lose quality vs earliest-start"
    )


def test_qmcp_sweep_cost_ordering():
    """exact <= quality-assigned sweep <= plain sweep in weighted cost.

    With a wide quality spread the exact optimum may spend MORE reads on
    better quality, so the min-count heuristic is not near-optimal in cost
    — that gap is why exact weighted device solving stays on the roadmap.
    """
    rng = np.random.default_rng(5)
    batch = rand_reads_uniform(rng, 800, 2048, 60)
    m = 4
    sel_sweep = QmcpDeviceSweepSolver(max_span=64, pad_multiple=1024).solve(m, batch)
    sel_plain = McpDeviceSweepSolver(
        max_span=64, pad_multiple=1024
    ).solve(m, batch)
    sel_exact = NativeQmcpSolver().solve(m, batch)
    q = np.asarray(batch.quality, np.int64)
    cost = q.max() - q + 1
    assert cost[sel_exact].sum() <= cost[sel_sweep].sum() <= cost[sel_plain].sum()


def test_qmcp_sweep_prefers_high_quality_duplicates():
    from genome_downsampler_tpu.core.readbatch import ReadBatch

    # 4 identical intervals, two high quality; M=2 must keep the two best
    batch = ReadBatch(
        bam_id=np.arange(4),
        start=[0, 0, 0, 0],
        end=[9, 9, 9, 9],
        quality=[5, 50, 7, 60],
        seq_length=[10] * 4,
        is_first=[True, False, True, False],
        ref_genome_length=10,
    )
    sel = QmcpDeviceSweepSolver(max_span=16, pad_multiple=32).solve(2, batch)
    assert sorted(sel.tolist()) == [1, 3]
