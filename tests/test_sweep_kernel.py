"""The blocked sweep kernel and its wrapper: interpret mode and the XLA
reference against ``sweep_counts`` on the CPU; the compiled kernel on the
GPU (marked ``gpu``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from genome_downsampler_tpu.ops.coverage import (
    capped_coverage,
    coverage_from_intervals,
)
from genome_downsampler_tpu.ops.pallas_blocked import (
    _suffix,
    _sweep_group_kernel,
    _unsuffix,
    blocked_windowed_sweep,
    capped_target,
    group_arrivals,
    group_size,
    pack_blocked,
    window_length,
)
from genome_downsampler_tpu.ops.route import kernel_route
from genome_downsampler_tpu.solvers.device_sweep import (
    build_start_rows,
    sweep_counts,
)
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform


def random_group(seed, W, G, L, m):
    rng = np.random.default_rng(seed)
    rows = np.zeros((W, G, L), np.int32)
    r = W * G // 2
    np.add.at(
        rows,
        (rng.integers(0, W, r), rng.integers(0, G, r),
         rng.integers(0, L - 1, r)),
        rng.integers(1, 4, r),
    )
    tgt = rng.integers(0, m + 1, (W, G)).astype(np.int32)
    return rows, tgt


def scan_reference(rows, tgt, a0, s0, L):
    outs = [
        sweep_counts(
            jnp.asarray(rows[w]), jnp.asarray(tgt[w]),
            jnp.asarray(a0[w]), jnp.asarray(s0[w]), L,
        )
        for w in range(rows.shape[0])
    ]
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(3)]


@pytest.mark.parametrize("seed,m,L", [(0, 3, 64), (1, 9, 128)])
def test_kernel_group_matches_scan(seed, m, L):
    W, G = 3, 2 * L
    rows, tgt = random_group(seed, W, G, L, m)
    z = np.zeros((W, L), np.int32)
    sel, F, S = _sweep_group_kernel(
        _suffix(jnp.asarray(rows)), jnp.asarray(tgt),
        jnp.asarray(z), jnp.asarray(z), interpret=True,
    )
    ref_sel, ref_a, ref_s = scan_reference(rows, tgt, z, z, L)
    np.testing.assert_array_equal(np.asarray(sel), ref_sel)
    np.testing.assert_array_equal(np.asarray(_unsuffix(F)), ref_a)
    np.testing.assert_array_equal(np.asarray(_unsuffix(S)), ref_s)


def test_kernel_group_carry_in_matches_scan():
    W, G, L = 2, 128, 64
    rows, tgt = random_group(5, W, G, L, 4)
    rng = np.random.default_rng(9)
    a0 = rng.integers(0, 3, (W, L)).astype(np.int32)
    s0 = rng.integers(0, 2, (W, L)).astype(np.int32)
    sel, F, S = _sweep_group_kernel(
        _suffix(jnp.asarray(rows)), jnp.asarray(tgt),
        _suffix(jnp.asarray(a0)), _suffix(jnp.asarray(s0)), interpret=True,
    )
    ref_sel, ref_a, ref_s = scan_reference(rows, tgt, a0, s0, L)
    np.testing.assert_array_equal(np.asarray(sel), ref_sel)
    np.testing.assert_array_equal(np.asarray(_unsuffix(F)), ref_a)
    np.testing.assert_array_equal(np.asarray(_unsuffix(S)), ref_s)


def test_kernel_route_on_cpu():
    assert kernel_route() == "xla"
    assert kernel_route(interpret=True) == "interpret"


@pytest.mark.parametrize(
    "platform,interpret,raises",
    [("gpu", False, None), ("gpu", True, ValueError), ("rocm", False, RuntimeError)],
)
def test_kernel_route_platforms(monkeypatch, platform, interpret, raises):
    class Dev:
        pass

    dev = Dev()
    dev.platform = platform
    monkeypatch.setattr(jax, "devices", lambda: [dev])
    if raises is None:
        assert kernel_route(interpret) == "kernel"
    else:
        with pytest.raises(raises):
            kernel_route(interpret)


def test_group_arrivals_match_start_rows():
    rng = np.random.default_rng(3)
    W, B, L, G = 4, 32, 32, 64
    n = 700
    start = rng.integers(0, n - 40, 900)
    end = start + rng.integers(0, L - 1, 900)
    packed, _, win, n_pad = pack_blocked(start, end, n, W, B, L, 16)
    assert win % G == 0
    rows = build_start_rows(
        jnp.asarray(start.astype(np.int32)),
        jnp.asarray((end - start + 1).astype(np.int32)),
        jnp.ones(start.shape[0], jnp.int32), n_pad, L,
    )
    rows = np.asarray(rows).reshape(W, win, L)
    for g in range(win // G):
        got = group_arrivals(jnp.asarray(packed), g, G, B, L)
        np.testing.assert_array_equal(
            np.asarray(got), rows[:, g * G : (g + 1) * G]
        )


def test_capped_target_matches_coverage():
    rng = np.random.default_rng(4)
    W, B, L = 4, 64, 64
    n = 1000
    start = rng.integers(0, n - 60, 1500)
    end = start + rng.integers(0, L - 1, 1500)
    packed, _, win, n_pad = pack_blocked(start, end, n, W, B, L, 16)
    got = capped_target(jnp.asarray(packed), B, L, 7)
    ref = capped_coverage(
        coverage_from_intervals(
            jnp.asarray(start.astype(np.int32)),
            jnp.asarray(end.astype(np.int32)), n_pad,
        ),
        7,
    )
    np.testing.assert_array_equal(
        np.asarray(got).reshape(-1), np.asarray(ref)
    )


@pytest.mark.parametrize(
    "W,L,B,win_min",
    [(1, 256, 256, 30_000), (128, 256, 256, 40_000), (8, 512, 128, 100),
     (256, 256, 256, 10**7)],
)
def test_group_size_and_window_length(W, L, B, win_min):
    G = group_size(W, L, B, win_min)
    assert G & (G - 1) == 0 and G % L == 0 and G % B == 0
    assert G >= win_min or W * 2 * G * L * 4 > 256 * 1024 * 1024
    win = window_length(win_min * W, W, G)
    assert win % G == 0 and win * W >= win_min * W


@pytest.mark.gpu
def test_compiled_kernel_matches_reference(gpu):
    """The Triton kernel, compiled for the card, against the plain XLA
    reference at a realistic width (L = 256, 64 windows)."""
    rng = np.random.default_rng(0)
    n, W, B, L = 1 << 21, 64, 256, 256
    start = rng.integers(0, n - 200, 4 * n // 150)
    end = start + rng.integers(99, 150, start.shape[0])
    G = group_size(W, L, B, n // W)
    win = window_length(n, W, G)
    packed, _, _, _ = pack_blocked(start, end, W * win, W, B, L, 256)
    p = jnp.asarray(packed)
    kw = dict(block=B, max_span=L, group=G, max_coverage=30)
    got, k1 = blocked_windowed_sweep(p, None, route="kernel", **kw)
    ref, k2 = blocked_windowed_sweep(p, None, route="xla", **kw)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert int(k1) == int(k2)


@pytest.mark.gpu
def test_solver_on_gpu_matches_host_greedy(gpu):
    from genome_downsampler_tpu.solvers.device_sweep import (
        McpDeviceSweepSolver,
    )
    from genome_downsampler_tpu.solvers.native_greedy import (
        NativeGreedyMcpSolver,
    )

    rng = np.random.default_rng(1)
    batch = rand_reads_uniform(rng, 200_000, 1_000_000, 150)
    dev = McpDeviceSweepSolver().solve(40, batch)
    host = NativeGreedyMcpSolver().solve(40, batch)
    np.testing.assert_array_equal(dev, host)
