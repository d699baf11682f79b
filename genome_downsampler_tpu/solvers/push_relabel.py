"""Deterministic data-parallel push-relabel max-flow on the interval graph.

Device re-design (plain JAX) of the reference CUDA solver
(``/root/reference/libs/qmcp-solver/src/quasi_mcp_cuda_max_flow_solver.cu``):
same flow network (read arcs ``start -> end+1`` cap 1, backward chain arcs
``i+1 -> i`` with huge capacity, virtual source/sink arcs from the demand
function — ``create_graph``, ``.cu:157-259``), but the kernel is rebuilt for
XLA semantics instead of translated:

- **No atomics.** The CUDA kernel resolves concurrent pushes with
  ``atomicAdd/Sub`` (``.cu:63-77``), which makes the selected read set
  schedule-dependent (SURVEY section 3.3). Here each superstep is a
  *synchronous* wave: every eligible node pushes on its admissible arcs with
  amounts decided by a segmented prefix-sum over its arc list, and excess
  updates are aggregated with ``segment_sum`` — deterministic by
  construction.
- **Label-parity coloring.** A push goes from label ``l+1`` to ``l``. By
  alternating supersteps between even- and odd-labelled nodes, the two
  directions of an arc can never push in the same wave, so flow updates are
  conflict-free without locks.
- **Static shapes.** The residual graph is a fixed arc table (tails, heads,
  static per-solve) sorted by tail once; each superstep is dense vectorized
  VPU work over ``2R + 2n + 2(n+1)`` directed arc slots inside a
  ``lax.while_loop``.
- **Device-resident global relabel.** The CUDA host round-trips 3 arrays per
  iteration for a CPU BFS (``.cu:375-388``). Here the distance labeling is
  recomputed on device with min-plus sweeps that exploit the line structure:
  leftward chain residuals are always available, so one ``associative_scan``
  relaxes an entire chain run per round and the fixpoint converges in
  (max read-arc hops) rounds (see ``_global_relabel``). It runs once at
  start (exact initial distances) and every ``relabel_every`` supersteps,
  mirroring the reference's phase-1 cadence (``.cu:366-389``).
- **Loud failure.** The superstep budget is a hard error, not a silent
  return: ``solve`` raises if any line node still carries excess at exit
  (the round-1 silent-infeasible weakness, VERDICT.md).

Node map (parity with ``.cu:163-179`` minus the artificial node): genome
positions ``0..n``, source ``S = n+1``, sink ``T = n+2``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from genome_downsampler_tpu.core.readbatch import ReadBatch
from genome_downsampler_tpu.ops.coverage import (
    capped_coverage,
    coverage_from_intervals,
    demand_from_capped,
)
from genome_downsampler_tpu.solvers.base import Solution, Solver

BIG = jnp.int32(1 << 30)  # "infinite" chain capacity (reference uses INT64_MAX)


class ArcTable(NamedTuple):
    """Static residual-arc table, sorted by tail node.

    Arc slots (R = padded read count, n = genome length):
      read_fwd   R     start -> end+1
      read_bwd   R     end+1 -> start
      chain_fwd  n     i+1 -> i        (always huge residual)
      chain_bwd  n     i -> i+1
      src_bwd    n+1   i -> S          (residual of S->i)
      snk_bwd    n+1   T -> i          (residual of i->T)
      snk_fwd    n+1   i -> T

    ``S -> i`` forward arcs are saturated by the preflow and the source never
    pushes, so they have no table slots; their residuals live in ``f_src``
    and are reachable through ``src_bwd``.
    """

    tails: jax.Array  # int32[A] sorted
    heads: jax.Array  # int32[A]
    kind: jax.Array  # int32[A], see table above (0..6)
    slot: jax.Array  # int32[A] index into the kind's flow array
    seg_start: jax.Array  # int32[A] first arc index of this tail's segment


def _build_arc_table(start, end, n, R):
    """Assemble + sort the arc table (traced once per (n, R) shape)."""
    S = n + 1
    i = jnp.arange(n, dtype=jnp.int32)
    nodes = jnp.arange(n + 1, dtype=jnp.int32)

    T = n + 2
    tails = jnp.concatenate([
        start,                      # read_fwd
        end + 1,                    # read_bwd
        i + 1,                      # chain_fwd
        i,                          # chain_bwd
        nodes,                      # src_bwd: i -> S
        jnp.full(n + 1, T, jnp.int32),  # snk_bwd: T -> i
        nodes,                      # snk_fwd: i -> T
    ])
    heads = jnp.concatenate([
        end + 1,
        start,
        i,
        i + 1,
        jnp.full(n + 1, S, jnp.int32),
        nodes,
        jnp.full(n + 1, T, jnp.int32),
    ])
    kind = jnp.concatenate([
        jnp.zeros(R, jnp.int32),
        jnp.ones(R, jnp.int32),
        jnp.full(n, 2, jnp.int32),
        jnp.full(n, 3, jnp.int32),
        jnp.full(n + 1, 4, jnp.int32),
        jnp.full(n + 1, 5, jnp.int32),
        jnp.full(n + 1, 6, jnp.int32),
    ])
    slot = jnp.concatenate([
        jnp.arange(R, dtype=jnp.int32),
        jnp.arange(R, dtype=jnp.int32),
        i,
        i,
        nodes,
        nodes,
        nodes,
    ])

    order = jnp.argsort(tails, stable=True)
    tails, heads, kind, slot = tails[order], heads[order], kind[order], slot[order]

    # First arc index of each tail segment, broadcast per arc.
    a_idx = jnp.arange(tails.shape[0], dtype=jnp.int32)
    is_first = jnp.concatenate([jnp.ones(1, bool), tails[1:] != tails[:-1]])
    seg_start = jnp.maximum.accumulate(jnp.where(is_first, a_idx, 0))
    return ArcTable(tails, heads, kind, slot, seg_start)


class FlowState(NamedTuple):
    f_read: jax.Array   # int32[R]   flow on read arcs (0/1)
    f_chain: jax.Array  # int32[n]   flow on chain arcs i+1->i
    f_src: jax.Array    # int32[n+1] flow on S->i
    f_snk: jax.Array    # int32[n+1] flow on i->T
    excess: jax.Array   # int32[n+3]
    label: jax.Array    # int32[n+3]
    step: jax.Array     # int32 superstep counter


def _residuals(arcs: ArcTable, st: FlowState, cap_snk, read_valid):
    """Residual capacity per arc slot in the table."""
    res_by_kind = [
        jnp.where(read_valid, 1 - st.f_read, 0),  # read_fwd (padded reads: 0)
        st.f_read,                                # read_bwd
        BIG - st.f_chain,                         # chain_fwd
        st.f_chain,                               # chain_bwd
        st.f_src,                                 # src_bwd residual = pushed flow
        st.f_snk,                                 # snk_bwd
        cap_snk - st.f_snk,                       # snk_fwd
    ]
    gathered = [r[arcs.slot] for r in res_by_kind]
    res = gathered[0]
    for k in range(1, 7):
        res = jnp.where(arcs.kind == k, gathered[k], res)
    return res


def _apply_flow_deltas(st: FlowState, arcs: ArcTable, amt):
    """Scatter per-arc push amounts into the underlying flow variables."""
    f_read = st.f_read.at[arcs.slot].add(
        jnp.where(arcs.kind <= 1, jnp.where(arcs.kind == 0, amt, -amt), 0)
    )
    f_chain = st.f_chain.at[arcs.slot].add(
        jnp.where((arcs.kind == 2) | (arcs.kind == 3),
                  jnp.where(arcs.kind == 2, amt, -amt), 0)
    )
    f_src = st.f_src.at[arcs.slot].add(jnp.where(arcs.kind == 4, -amt, 0))
    f_snk = st.f_snk.at[arcs.slot].add(
        jnp.where((arcs.kind == 5) | (arcs.kind == 6),
                  jnp.where(arcs.kind == 6, amt, -amt), 0)
    )
    return f_read, f_chain, f_src, f_snk


def _seg_min(a, b):
    """Segmented-min combiner: flagged elements start a new segment."""
    af, av = a
    bf, bv = b
    return af | bf, jnp.where(bf, bv, jnp.minimum(av, bv))


def _dist_closure(d, start, end1, rf, rb, f_chain):
    """Fixpoint of min-plus relaxation over the residual line + read arcs.

    ``d`` is a distance-to-target seed over line nodes ``0..n``; returns the
    shortest residual distance where every chain arc costs 1 per position
    and read arcs cost 1 per hop. The always-residual downward chain arcs
    ``i+1 -> i`` close in ONE prefix scan of ``d(j) - j``; the upward arcs
    ``i -> i+1`` (residual iff ``f_chain[i] > 0``) close in one segmented
    scan of ``d(j) + j`` over positive-flow runs. Iteration count = max
    read-arc hops on any shortest path — the device replacement for the
    reference's host BFS (``quasi_mcp_cuda_max_flow_solver.cu:101-155``).
    """
    n1 = d.shape[0]
    idx = jnp.arange(n1, dtype=jnp.int32)
    # reversed-order segment flags for the upward closure (see below)
    flags_rev = jnp.concatenate(
        [jnp.ones(1, bool), (f_chain == 0)[::-1]]
    )

    def closure(d):
        # downward: d(i) <= min_{j<=i} d(j) + (i - j)
        a = jnp.where(d >= BIG, BIG, d - idx)
        pm = jax.lax.associative_scan(jnp.minimum, a)
        d = jnp.minimum(d, jnp.where(pm >= BIG, BIG, pm + idx))
        # upward within positive-chain-flow runs:
        # d(i) <= min_{j>=i in run} d(j) + (j - i)
        e_rev = jnp.where(d >= BIG, BIG, d + idx)[::-1]
        _, sm = jax.lax.associative_scan(_seg_min, (flags_rev, e_rev))
        cand = jnp.where(sm >= BIG, BIG, sm)[::-1] - idx
        return jnp.minimum(d, cand)

    def body(c):
        d0, _ = c
        d = closure(d0)
        # read arcs, both residual directions, one hop each
        cf = jnp.where(rf & (d[end1] < BIG), d[end1] + 1, BIG)
        d = d.at[start].min(cf)
        cb = jnp.where(rb & (d[start] < BIG), d[start] + 1, BIG)
        d = d.at[end1].min(cb)
        return d, jnp.any(d < d0)

    def cond(c):
        return c[1]

    d, _ = jax.lax.while_loop(cond, body, (closure(d), jnp.bool_(True)))
    return d


@functools.partial(jax.jit, static_argnames=("n", "max_supersteps", "relabel_every"))
def push_relabel_solve(
    start: jax.Array,
    end: jax.Array,
    read_valid: jax.Array,
    capped: jax.Array,
    n: int,
    max_supersteps: int = 200_000,
    relabel_every: int = 25,
):
    """Run push-relabel to a full feasible flow; returns (selected_mask,
    supersteps_used).

    ``capped`` is the per-base selection target ``min(cov, M)`` (int32[n]).
    Selected reads are those whose unit arc carries flow — the reference
    extracts them identically (``.cu:424-432``).
    """
    R = start.shape[0]
    num_nodes = n + 3
    S, T = n + 1, n + 2

    demand = demand_from_capped(capped)  # int32[n+1] over nodes 0..n
    cap_src = jnp.maximum(-demand, 0)
    cap_snk = jnp.maximum(demand, 0)

    arcs = _build_arc_table(start.astype(jnp.int32), end.astype(jnp.int32), n, R)
    A = arcs.tails.shape[0]

    # Preflow: saturate all source arcs (parity: create_preflow, .cu:261-291).
    excess = jnp.zeros(num_nodes, jnp.int32)
    excess = excess.at[:n + 1].add(cap_src)
    excess = excess.at[S].set(-jnp.sum(cap_src))
    label = jnp.zeros(num_nodes, jnp.int32).at[S].set(num_nodes)

    st = FlowState(
        f_read=jnp.zeros(R, jnp.int32),
        f_chain=jnp.zeros(n, jnp.int32),
        f_src=cap_src,
        f_snk=jnp.zeros(n + 1, jnp.int32),
        excess=excess,
        label=label,
        step=jnp.int32(0),
    )

    node_is_line = jnp.arange(num_nodes, dtype=jnp.int32) <= n
    end1 = end.astype(jnp.int32) + 1
    start32 = start.astype(jnp.int32)

    def active_mask(st):
        # T absorbs; S re-absorbs returned flow. Line nodes with excess push.
        return node_is_line & (st.excess > 0)

    def global_relabel(st):
        """Exact residual BFS distances via line scans (device-resident)."""
        rf = read_valid & (st.f_read == 0)
        rb = read_valid & (st.f_read > 0)
        # distance to T: seed = 1 where the i -> T arc has residual
        dT = jnp.where(cap_snk - st.f_snk > 0, jnp.int32(1), BIG)
        dT = _dist_closure(dT, start32, end1, rf, rb, st.f_chain)
        # nodes cut off from T route excess back to S (label n+3 + dist)
        dS = jnp.where(st.f_src > 0, jnp.int32(1), BIG)
        dS = _dist_closure(dS, start32, end1, rf, rb, st.f_chain)
        lab_line = jnp.where(
            dT < BIG,
            dT,
            jnp.where(dS < BIG, num_nodes + dS, 2 * num_nodes),
        ).astype(jnp.int32)
        label = jnp.concatenate(
            [lab_line,
             jnp.full(1, num_nodes, jnp.int32),
             jnp.zeros(1, jnp.int32)]
        )
        return st._replace(label=label)

    def cond(st):
        return jnp.any(active_mask(st)) & (st.step < max_supersteps)

    def body(st):
        lab_t = st.label[arcs.tails]
        lab_h = st.label[arcs.heads]
        res = _residuals(arcs, st, cap_snk, read_valid)

        parity = st.step % 2
        elig_node = active_mask(st) & ((st.label & 1) == parity)
        elig_t = elig_node[arcs.tails]

        admissible = elig_t & (res > 0) & (lab_t == lab_h + 1)
        want = jnp.where(admissible, res, 0)

        # Segmented exclusive prefix of `want` within each tail's arc run:
        # each node pushes on its admissible arcs in table order until its
        # excess is spent (a synchronous "discharge").
        g = jnp.cumsum(want)
        excl = g - want
        within = excl - excl[arcs.seg_start]
        ex_t = st.excess[arcs.tails]
        amt = jnp.clip(ex_t - within, 0, want)

        f_read, f_chain, f_src, f_snk = _apply_flow_deltas(st, arcs, amt)
        pushed_out = jax.ops.segment_sum(
            amt, arcs.tails, num_segments=num_nodes
        ).astype(jnp.int32)
        pushed_in = jax.ops.segment_sum(
            amt, arcs.heads, num_segments=num_nodes
        ).astype(jnp.int32)
        excess = st.excess - pushed_out + pushed_in

        # Relabel eligible nodes that pushed nothing: rise to 1 + min label
        # over *post-wave* residual arcs. Post-wave residuals matter because
        # an incoming cancellation creates a new residual arc whose head
        # label bounds the legal rise (label validity: l[u] <= l[w] + 1 for
        # every residual arc (u, w)).
        st_post = FlowState(f_read, f_chain, f_src, f_snk, excess, st.label, st.step)
        res_post = _residuals(arcs, st_post, cap_snk, read_valid)
        out_min = jax.ops.segment_min(
            jnp.where(res_post > 0, lab_h, jnp.int32(2 * num_nodes)),
            arcs.tails,
            num_segments=num_nodes,
        )
        new_label = jnp.minimum(out_min + 1, 2 * num_nodes)
        do_relabel = elig_node & (pushed_out == 0) & (excess > 0)
        label = jnp.where(do_relabel, new_label, st.label)

        return FlowState(f_read, f_chain, f_src, f_snk, excess, label, st.step + 1)

    def outer_body(st):
        # exact distances, then up to `relabel_every` synchronous waves
        st = global_relabel(st)
        budget = jnp.minimum(
            st.step + relabel_every, jnp.int32(max_supersteps)
        )

        def icond(s):
            return jnp.any(active_mask(s)) & (s.step < budget)

        return jax.lax.while_loop(icond, body, st)

    st = jax.lax.while_loop(cond, outer_body, st)
    selected = (st.f_read > 0) & read_valid
    excess_left = jnp.sum(jnp.where(active_mask(st), st.excess, 0))
    return selected, st.step, excess_left


class QuasiMcpPushRelabelSolver(Solver):
    """Feasible-selection solver on device (parity target: reference
    ``quasi-mcp-cuda``; deterministic unlike the CUDA original)."""

    uses_quality_of_reads = False

    def __init__(
        self,
        pad_multiple: int = 4096,
        max_supersteps: int = 200_000,
        relabel_every: int = 25,
    ):
        self.pad_multiple = pad_multiple
        self.max_supersteps = max_supersteps
        self.relabel_every = relabel_every

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        n = batch.ref_genome_length
        arrays, valid = batch.padded(self.pad_multiple)
        start = jnp.asarray(arrays["start"])
        end = jnp.asarray(arrays["end"])
        vmask = jnp.asarray(valid)
        cov = coverage_from_intervals(start, end, n, vmask.astype(jnp.int32))
        capped = capped_coverage(cov, int(max_coverage))
        selected, steps, excess_left = push_relabel_solve(
            start, end, vmask, capped, n,
            max_supersteps=self.max_supersteps,
            relabel_every=self.relabel_every,
        )
        if int(excess_left) != 0:
            raise RuntimeError(
                f"push-relabel did not converge: {int(excess_left)} excess "
                f"left after {int(steps)} supersteps "
                f"(cap {self.max_supersteps}); selection would be infeasible"
            )
        sel = np.nonzero(np.asarray(selected))[0]
        return sel.astype(np.int64)
