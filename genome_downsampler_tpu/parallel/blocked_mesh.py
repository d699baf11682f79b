"""Multi-device blocked sweep: O(R/D + n/D) memory per device.

The chr1-scale path (BASELINE.md config 5). Combines the two scaling
mechanisms of this framework:

- ``ops/pallas_blocked``: packed per-(window, block) read codes, one
  kernel program per window, O(R) total memory instead of the dense
  (n, L) histogram;
- ``parallel/mesh``: genome-axis sharding over a 1-D device mesh with
  ``ppermute`` halo exchange of the sweep carry.

Global window chain: D devices x W_local windows = W_total windows over
the coordinate line. One Jacobi relaxation round = every window sweeps in
parallel seeded by its left neighbour's previous carry-out; the neighbour
shift is a within-device row shift for interior windows and a ppermute for
the device boundary. A psum-reduced stability flag ends the loop; the fixed
point is bit-identical to the global sequential sweep (argument in
``parallel/windows.py``).

Per-device memory: packed codes O(R/D), target/output O(n/D), carries
O(W_local * L). Cross-device traffic per round: one (avail, selend) pair
of L-vectors per device boundary — independent of genome length and read
count.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from genome_downsampler_tpu.ops.pallas_blocked import blocked_sweep_pass


def _blocked_relax_local(
    packed_local: jax.Array,   # int32[nbw, W_local, cap]
    target_local: jax.Array,   # int32[W_local, win]
    *,
    block: int,
    max_span: int,
    group: int,
    route: str,
    axis: str,
):
    """Per-device body (inside shard_map): joint relaxation of the global
    window chain, local windows advancing together each round."""
    W, L = packed_local.shape[1], max_span
    n_dev = jax.lax.axis_size(axis)
    total_rounds = n_dev * W
    right_perm = [(i, i + 1) for i in range(n_dev - 1)]

    def passes(a_in, s_in):
        return blocked_sweep_pass(
            packed_local, target_local, a_in, s_in, block=block,
            max_span=max_span, group=group, route=route,
        )

    def shift(c_out):
        # global chain shift: window w takes w-1's carry; window 0 of this
        # device takes the last window of the left neighbor (zeros at the
        # genome start, matching ppermute's edge behavior)
        from_left = jax.lax.ppermute(c_out[-1], axis, right_perm)
        return jnp.concatenate([from_left[None, :], c_out[:-1]], axis=0)

    zeros = jax.lax.pcast(
        jnp.zeros((W, L), jnp.int32), axis, to="varying"
    )
    sel, a_out, s_out = passes(zeros, zeros)

    def cond(state):
        k, a_in, s_in, sel, a_out, s_out = state
        a_next, s_next = shift(a_out), shift(s_out)
        local_stable = jnp.all(a_next == a_in) & jnp.all(s_next == s_in)
        all_stable = jax.lax.psum((~local_stable).astype(jnp.int32), axis) == 0
        return (~all_stable) & (k < total_rounds)

    def body(state):
        k, _, _, _, a_out, s_out = state
        a_in, s_in = shift(a_out), shift(s_out)
        sel, a_out2, s_out2 = passes(a_in, s_in)
        return (k + 1, a_in, s_in, sel, a_out2, s_out2)

    k, _, _, sel, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(1), zeros, zeros, sel, a_out, s_out)
    )
    return sel


def make_blocked_mesh_solver(
    mesh: Mesh,
    block: int = 256,
    max_span: int = 256,
    group: int = 256,
    route: str = "xla",
    axis: str = "x",
) -> Tuple[callable, NamedSharding, NamedSharding]:
    """Jitted multi-device blocked solver.

    Expects host packing from ``pack_blocked(start, end, n, W_total, block,
    max_span)`` with ``W_total = mesh_size * W_local`` and a window length
    that is a multiple of ``group``. Returns ``(fn, packed_sharding,
    target_sharding)``; ``fn(packed, target) -> sel (W_total, win)``
    sharded P(axis). ``route`` comes from ``ops.route.kernel_route``.
    """
    fn = jax.jit(
        jax.shard_map(
            functools.partial(
                _blocked_relax_local,
                block=block,
                max_span=max_span,
                group=group,
                route=route,
                axis=axis,
            ),
            mesh=mesh,
            in_specs=(P(None, axis, None), P(axis, None)),
            out_specs=P(axis, None),
            # pallas_call outputs carry no varying-mesh-axes metadata yet;
            # the kernel touches only per-device data, so vma checking is
            # safely disabled
            check_vma=False,
        )
    )
    return (
        fn,
        NamedSharding(mesh, P(None, axis, None)),
        NamedSharding(mesh, P(axis, None)),
    )
