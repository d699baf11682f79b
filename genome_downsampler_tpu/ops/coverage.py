"""Device coverage ops: scatter-diff + prefix-sum instead of per-base loops.

The reference computes per-base coverage with an O(reads x read_length)
nested loop (the b-function,
``/root/reference/libs/qmcp-solver/src/quasi_mcp_cpu_max_flow_solver.cpp:58-73``
and ``BamApi::find_input_cover``, the reference's
``libs/bam-api/src/bam_api.cpp:275-286``). On the device this
is a difference-array scatter-add (+w at ``start``, -w at ``end+1``) followed
by a ``cumsum`` — O(reads + genome) and fully vectorized; XLA lowers the
scatter to an atomic or sorted segment update and the cumsum to a scan.

Padding convention: invalid (padded) reads carry ``weight == 0`` so they
contribute nothing; their sentinel interval is ``start=0, end=-1``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def coverage_from_intervals(
    start: jax.Array,
    end: jax.Array,
    genome_length: int,
    weight: jax.Array | None = None,
) -> jax.Array:
    """Per-base coverage of inclusive intervals ``[start, end]``.

    Parity target: ``BamApi::find_input_cover`` (``bam_api.cpp:275-286``) /
    ``find_filtered_cover`` (``bam_api.cpp:288-300``) as int32[genome_length].

    ``weight`` defaults to 1 per interval; pass a 0/1 mask for padded batches
    or selection indicators.
    """
    n = int(genome_length)
    if weight is None:
        w = jnp.ones(start.shape, jnp.int32)
    else:
        w = weight.astype(jnp.int32)
    diff = jnp.zeros(n + 1, jnp.int32)
    s = jnp.clip(start, 0, n)
    e1 = jnp.clip(end + 1, 0, n)
    diff = diff.at[s].add(w, mode="drop")
    diff = diff.at[e1].add(-w, mode="drop")
    return jnp.cumsum(diff)[:n]


def capped_coverage(coverage: jax.Array, max_coverage) -> jax.Array:
    """``min(input_coverage, M)`` — the per-base selection target.

    This is the capped b-function of the reference
    (``quasi_mcp_cpu_max_flow_solver.cpp:62-71``) shifted to base indexing:
    reference ``b[j+1] == capped_coverage[j]``.
    """
    return jnp.minimum(coverage, jnp.asarray(max_coverage, coverage.dtype))


def demand_from_capped(capped: jax.Array) -> jax.Array:
    """Node demands of the interval-flow network from capped coverage.

    Reference semantics (``create_demand_function``,
    ``quasi_mcp_cpu_max_flow_solver.cpp:75-87``): with
    ``b[j+1] = capped[j]`` and ``b[0] = 0`` over nodes ``0..n``:

        d[0]  = -b[1]
        d[i]  =  b[i] - b[i+1]      (1 <= i <= n-1)
        d[n]  =  b[n]

    i.e. ``d = -diff(b_padded)`` where ``b_padded = [0, capped..., 0]`` —
    a pure elementwise shift/subtract; sums to zero.
    """
    n = capped.shape[0]
    b = jnp.concatenate([jnp.zeros(1, capped.dtype), capped, jnp.zeros(1, capped.dtype)])
    # d[i] = b[i] - b[i+1] for i in 0..n  (b[0]=0 gives d[0]=-b[1]; b[n+1]=0
    # gives d[n]=b[n])
    return b[:-1] - b[1:]


def coverage_is_valid(
    input_coverage: jax.Array, output_coverage: jax.Array, max_coverage
) -> jax.Array:
    """The coverage-validity property of the reference tester:
    ``min(input_cov, M) <= output_cov`` elementwise
    (``/root/reference/src/tests/coverage_tester.cpp:101-107``)."""
    capped = capped_coverage(input_coverage, max_coverage)
    return jnp.all(capped <= output_coverage)
