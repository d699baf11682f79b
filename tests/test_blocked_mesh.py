"""Blocked mesh solver vs the global sweep on the virtual 8-device mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from genome_downsampler_tpu.ops.coverage import (
    capped_coverage,
    coverage_from_intervals,
)
from genome_downsampler_tpu.ops.pallas_blocked import pack_blocked
from genome_downsampler_tpu.parallel.blocked_mesh import make_blocked_mesh_solver
from genome_downsampler_tpu.solvers.device_sweep import (
    build_start_rows,
    sweep_counts,
)
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform


@pytest.mark.parametrize(
    "n_dev,w_local,m,route",
    [(2, 4, 5, "interpret"), (4, 2, 3, "interpret"), (8, 2, 9, "xla")],
)
def test_blocked_mesh_matches_global(n_dev, w_local, m, route):
    B, L = 32, 32
    n = 2048
    W_total = n_dev * w_local
    rng = np.random.default_rng(n_dev * 10 + w_local)
    batch = rand_reads_uniform(rng, 1500, n, 24)
    start = np.asarray(batch.start, np.int64)
    end = np.asarray(batch.end, np.int64)

    packed, _, win, n_pad = pack_blocked(
        start, end, n, W_total, B, L, cap_multiple=32
    )
    ones = jnp.ones(start.shape[0], jnp.int32)
    cov = coverage_from_intervals(
        jnp.asarray(start.astype(np.int32)),
        jnp.asarray(end.astype(np.int32)),
        n_pad,
        ones,
    )
    target = capped_coverage(cov, m).reshape(W_total, win)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("x",))
    fn, packed_sh, target_sh = make_blocked_mesh_solver(
        mesh, block=B, max_span=L, group=B, route=route,
    )
    packed_d = jax.device_put(jnp.asarray(packed), packed_sh)
    target_d = jax.device_put(target, target_sh)
    sel = np.asarray(fn(packed_d, target_d)).reshape(-1)

    # global reference
    arrays, valid = batch.padded(512)
    s_j = jnp.asarray(arrays["start"])
    e_j = jnp.asarray(arrays["end"])
    w_j = jnp.asarray(valid).astype(jnp.int32)
    rows = build_start_rows(s_j, e_j - s_j + 1, w_j, n_pad, L)
    tgt = capped_coverage(coverage_from_intervals(s_j, e_j, n_pad, w_j), m)
    z = jnp.zeros(L, jnp.int32)
    ref, _, _ = sweep_counts(rows, tgt, z, z, L)
    np.testing.assert_array_equal(sel, np.asarray(ref))
