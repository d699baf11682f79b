"""Device-exact weighted QMCP: successive shortest paths, scan-based.

The reference ``qmcp-cpu`` minimizes ``sum(max_quality - quality + 1)``
exactly via OR-Tools min-cost flow
(``/root/reference/libs/qmcp-solver/src/qmcp_cpu_cost_scaling_solver.cpp:44-49``).
This module is the device-side exact solver for the same objective: the
convex-bucket interval-flow network (one arc per distinct ``(start, end)``
span, per-unit marginal costs = the bucket's read costs sorted ascending —
the formulation of ``io/csrc/mcmf.cpp``) solved by successive shortest
paths, with every shortest-path computation expressed as XLA scans instead
of a Dijkstra heap:

- **Chain-arc closure in one scan.** The network's chain arcs ``i+1 -> i``
  (zero cost, non-binding capacity) compose freely, so relaxing *all* of
  them — any distance, in one step — is a suffix-min scan of ``d + pi``.
  The reverse direction ``i -> i+1`` exists only where chain flow is
  positive; that is a *segmented* prefix-min scan (segments break at
  zero-flow arcs). This replaces both the host engine's Dijkstra and its
  hierarchical shortcut arcs.
- **Bucket arcs via scatter-min.** Forward residuals (``flow < cap``) and
  backward residuals (``flow > 0``) relax with a gather + ``.at[].min``
  scatter; parents are recovered deterministically (smallest bucket id
  among achievers) with a second masked scatter.
- **Bellman-Ford fixpoint.** Alternate (closure, bucket relax) until the
  bucket relax changes nothing; the iteration count is the maximum number
  of bucket hops on any shortest path. Strict-improvement updates make the
  parent pointers a forest (no zero-cost-cycle traps).
- **Augmentation.** Walk the parent pointers from the cheapest deficit
  (a ``while_loop`` of gathers — path steps are compressed runs/jumps, not
  nodes), bound the push by the equal-marginal run of each bucket hop and
  by net chain-arc usage, and apply with one vectorized update. Potentials
  ``pi += min(d, d_sink)`` keep reduced costs nonnegative (Johnson).

Exactness: identical optimum to the host C++ MCMF / LP oracle — asserted
in ``tests/test_device_mcmf.py`` on the reference's five fixture families
and the 2M-read workload.

Scale envelope: per-phase work is O(hops * (n + B)) where hops ~ n /
median_span, so the device path is dispatched for genomes up to
``DEVICE_GENOME_LIMIT`` (SARS/fixture/bench scale); larger inputs fall
back to the host C++ engine (``native_mcmf``), mirroring how ``mcp-tpu``
auto-dispatches dense/blocked. Long-line shortest paths are inherently
sequential in the hop count — see ROADMAP "QMCP engines".
"""

from __future__ import annotations

import numpy as np

from genome_downsampler_tpu.core.readbatch import ReadBatch
from genome_downsampler_tpu.solvers.base import Solution, Solver
from genome_downsampler_tpu.utils.logging import get_logger

_log = get_logger("solvers.device_mcmf")

INF = np.int32(1 << 30)
IMAX = np.int32(2**31 - 1)
# Augmenting-path step buffer (compressed runs + jumps); paths run
# ~2 * bucket-hops ~ 2n/median_span steps, so 4096 covers genomes to
# ~250 kb of 150 bp reads. Larger buffers and buffer-free walks were tried
# on an earlier accelerator and set aside there; on the GPU neither this
# value nor a larger one has been tried yet. A path that overflows falls
# back to the host engine loudly at runtime.
PMAX = 4096
PI_GUARD = np.int32(1 << 29)  # |pi| ceiling keeping all int32 adds safe

# n above which qmcp-tpu falls back to the host C++ MCMF. Two binding
# walls (measured r5): the fixpoint iteration count per phase ~ bucket
# hops ~ n/span (quadratic overall), and the PMAX step buffer — paths at
# 262 kb of 60x/150 bp data already exceed 4096 steps, so the r4 limit
# of 262_144 raised PATH_OVERFLOW at its own boundary. 131_072 holds
# ~2.6k-step paths with zigzag headroom; the runtime fallback covers
# adversarial cases beyond that.
DEVICE_GENOME_LIMIT = 131_072

# phase status codes
OK = 0
INFEASIBLE = 1
FIXPOINT_CAP = 2
PATH_OVERFLOW = 3
PI_OVERFLOW = 4
DEGENERATE = 5

_STATUS_MSG = {
    INFEASIBLE: "no augmenting path (infeasible network)",
    FIXPOINT_CAP: "distance fixpoint iteration cap hit",
    PATH_OVERFLOW: f"augmenting path exceeded {PMAX} compressed steps",
    PI_OVERFLOW: "potential magnitude exceeded int32 safety bound",
    DEGENERATE: "degenerate zero-delta augmentation (tie cycle)",
}


def build_convex_buckets(start, end, cost):
    """Group reads by (start, end) with per-bucket costs sorted ascending.

    Returns (bstart, bend, off, pool, order): ``pool[off[b]:off[b+1]]`` are
    bucket ``b``'s unit costs ascending; ``order[k]`` is the read index of
    pool entry ``k``. Same packing trick as ``native_mcmf``: one stable
    argsort of a composite key when ranges permit, else a lexsort.
    """
    s = np.asarray(start, np.int64)
    e = np.asarray(end, np.int64)
    c = np.asarray(cost, np.int64)
    r = s.shape[0]
    span = e - s + 1
    if (
        r
        and int(span.max()) < (1 << 12)
        and int(c.max()) < (1 << 10)
        and int(c.min()) >= 0
        and int(s.max()) < (1 << 41)
        and int(s.min()) >= 0
    ):
        key = (s << 22) | (span << 10) | c
        order = np.argsort(key, kind="stable")
        ks = key[order]
        gkey = ks >> 10
        first = np.empty(r, bool)
        first[0] = True
        np.not_equal(gkey[1:], gkey[:-1], out=first[1:])
        pool = ks & ((1 << 10) - 1)
        starts_idx = np.flatnonzero(first)
        gu = gkey[starts_idx]
        bs = gu >> 12
        be = bs + (gu & ((1 << 12) - 1)) - 1
    else:
        order = np.lexsort((np.arange(r), c, e, s))
        ss, ee = s[order], e[order]
        first = np.empty(max(r, 1), bool)
        first[0] = True
        if r:
            first[1:r] = (ss[1:] != ss[:-1]) | (ee[1:] != ee[:-1])
        first = first[:r]
        pool = c[order]
        starts_idx = np.flatnonzero(first)
        bs = ss[starts_idx]
        be = ee[starts_idx]
    off = np.append(starts_idx, r).astype(np.int64)
    return bs, be, off, np.ascontiguousarray(pool), order, first


def _run_tables(pool: np.ndarray, first: np.ndarray):
    """run_lo/run_hi[k]: first/last pool index of the equal-cost run
    containing k, within its bucket (pool is sorted per bucket)."""
    r = pool.shape[0]
    new_run = first.copy()
    if r > 1:
        new_run[1:] |= pool[1:] != pool[:-1]
    run_starts = np.flatnonzero(new_run)
    run_id = np.cumsum(new_run) - 1
    run_lo = run_starts[run_id]
    run_hi = np.append(run_starts[1:], r)[run_id] - 1
    return run_lo.astype(np.int32), run_hi.astype(np.int32)


def _node_excess(bstart, bend, caps, n: int, max_coverage: int) -> np.ndarray:
    """Supplies = -demand from the capped coverage difference, the
    ``create_demand_function`` semantics
    (``/root/reference/libs/qmcp-solver/src/quasi_mcp_cpu_max_flow_solver.cpp:58-87``,
    sign-inverted as in ``mcp_cpu_cost_scaling_solver.cpp:59-66``)."""
    bcov = np.zeros(n + 2, np.int64)
    np.add.at(bcov, bstart + 1, caps)
    np.add.at(bcov, bend + 2, -caps)
    bcov = np.minimum(np.cumsum(bcov), max_coverage)
    excess = np.zeros(n + 1, np.int64)
    excess[0] = bcov[1]
    excess[1:n] = bcov[2 : n + 1] - bcov[1:n]
    excess[n] = -bcov[n]
    return excess


# --- jitted phase ----------------------------------------------------------


def _lexmin(a, b):
    av, ai = a
    bv, bi = b
    ta = (av < bv) | ((av == bv) & (ai <= bi))
    return _where(ta, av, bv), _where(ta, ai, bi)


def _seg_lexmin(a, b):
    af, av, ai = a
    bf, bv, bi = b
    mv, mi = _lexmin((av, ai), (bv, bi))
    return af | bf, _where(bf, bv, mv), _where(bf, bi, mi)


def _where(c, x, y):
    import jax.numpy as jnp

    return jnp.where(c, x, y)


def _make_phase():
    import jax
    import jax.numpy as jnp

    def chain_closure(d, pk, pid, pi, chainflow):
        n1 = d.shape[0]
        idx = jnp.arange(n1, dtype=jnp.int32)
        # downward arcs j -> i (j > i), always residual, rc sums telescope
        # to pi[j] - pi[i]:  cand[i] = min_{j>i}(d[j] + pi[j]) - pi[i]
        big = jnp.where(d >= INF, INF, d + pi)
        sv, si = jax.lax.associative_scan(_lexmin, (big, idx), reverse=True)
        m1v = jnp.concatenate([sv[1:], jnp.full(1, INF, jnp.int32)])
        m1i = jnp.concatenate([si[1:], jnp.zeros(1, jnp.int32)])
        cand = jnp.where(m1v >= INF, INF, m1v - pi)
        upd = cand < d
        d = jnp.where(upd, cand, d)
        pk = jnp.where(upd, 1, pk)
        pid = jnp.where(upd, m1i, pid)
        # upward arcs u -> v (u < v), residual iff chainflow > 0 on [u, v):
        # segmented prefix-min of d + pi (segment breaks at zero chain flow)
        big = jnp.where(d >= INF, INF, d + pi)
        flag = jnp.concatenate([jnp.ones(1, bool), chainflow == 0])
        _, sv, si = jax.lax.associative_scan(_seg_lexmin, (flag, big, idx))
        m1v = jnp.concatenate([jnp.full(1, INF, jnp.int32), sv[:-1]])
        m1i = jnp.concatenate([jnp.zeros(1, jnp.int32), si[:-1]])
        m1v = jnp.where(flag, INF, m1v)
        cand = jnp.where(m1v >= INF, INF, m1v - pi)
        upd = cand < d
        d = jnp.where(upd, cand, d)
        pk = jnp.where(upd, 2, pk)
        pid = jnp.where(upd, m1i, pid)
        return d, pk, pid

    def bucket_relax(d, pk, pid, pi, flow, bstart, bend1, off0, cap, pool):
        B = bstart.shape[0]
        bidx = jnp.arange(B, dtype=jnp.int32)
        pi_s = pi[bstart]
        pi_t = pi[bend1]

        def one_side(d, pk, pid, src, dst, rc_arc, active, kind):
            cand = jnp.where(active & (d[src] < INF), d[src] + rc_arc, INF)
            d_after = d.at[dst].min(cand)
            impr = d_after < d
            win = active & (cand == d_after[dst]) & impr[dst]
            pid_stage = jnp.full(d.shape[0], IMAX, jnp.int32).at[dst].min(
                jnp.where(win, bidx, IMAX)
            )
            pk = jnp.where(impr, kind, pk)
            pid = jnp.where(impr, pid_stage, pid)
            return d_after, pk, pid

        # forward: next unit's marginal cost
        act_f = flow < cap
        mc_f = pool[off0 + jnp.minimum(flow, cap - 1)]
        d, pk, pid = one_side(
            d, pk, pid, bstart, bend1, mc_f + pi_s - pi_t, act_f, 3
        )
        # backward: refund the last pushed unit
        act_b = flow > 0
        mc_b = pool[off0 + jnp.maximum(flow - 1, 0)]
        d, pk, pid = one_side(
            d, pk, pid, bend1, bstart, -mc_b + pi_t - pi_s, act_b, 4
        )
        return d, pk, pid

    def phase(bstart, bend1, off0, cap, pool, run_lo, run_hi,
              flow, chainflow, pi, excess):
        n1 = pi.shape[0]
        n = n1 - 1
        it_cap = jnp.int32(min(int(bstart.shape[0]) + 3, 1 << 20))

        d0 = jnp.where(excess > 0, jnp.int32(0), INF)
        pk0 = jnp.zeros(n1, jnp.int32)
        pid0 = jnp.zeros(n1, jnp.int32)

        def fcond(c):
            _, _, _, changed, it = c
            return changed & (it < it_cap)

        def fbody(c):
            d, pk, pid, _, it = c
            d1, pk, pid = chain_closure(d, pk, pid, pi, chainflow)
            d2, pk, pid = bucket_relax(
                d1, pk, pid, pi, flow, bstart, bend1, off0, cap, pool
            )
            return d2, pk, pid, jnp.any(d2 < d1), it + 1

        d, pk, pid, changed, _ = jax.lax.while_loop(
            fcond, fbody, (d0, pk0, pid0, jnp.bool_(True), jnp.int32(0))
        )

        dsel = jnp.where(excess < 0, d, INF)
        d_sink = jnp.min(dsel)
        sink = jnp.argmin(dsel).astype(jnp.int32)
        infeasible = d_sink >= INF
        pi_new = pi + jnp.minimum(d, d_sink)

        def augment(_):
            # walk parent pointers from the sink, recording compressed steps
            ks0 = jnp.zeros(PMAX, jnp.int32)
            aa0 = jnp.zeros(PMAX, jnp.int32)
            bb0 = jnp.zeros(PMAX, jnp.int32)

            def wcond(c):
                v, bn, _, _, _, cnt, ok = c
                return ok & (pk[v] != 0)

            def wbody(c):
                v, bn, ks, aa, bb, cnt, ok = c
                x = pid[v]

                def down(_):  # run from x down to v: chainflow[v:x] += delta
                    return x, bn, jnp.int32(1), v, x

                def up(_):  # run from x up to v: chainflow[x:v] -= delta
                    return x, bn, jnp.int32(2), x, v

                def bfwd(_):
                    k = off0[x] + flow[x]
                    run = run_hi[k] + 1 - k
                    return bstart[x], jnp.minimum(bn, run), jnp.int32(3), x, jnp.int32(0)

                def bbwd(_):
                    k = off0[x] + flow[x] - 1
                    run = off0[x] + flow[x] - run_lo[k]
                    return bend1[x], jnp.minimum(bn, run), jnp.int32(4), x, jnp.int32(0)

                v2, bn2, kk, a2, b2 = jax.lax.switch(
                    pk[v] - 1, [down, up, bfwd, bbwd], None
                )
                ks = ks.at[cnt].set(kk)
                aa = aa.at[cnt].set(a2)
                bb = bb.at[cnt].set(b2)
                return v2, bn2, ks, aa, bb, cnt + 1, ok & (cnt + 1 < PMAX)

            src, bn, ks, aa, bb, cnt, walk_ok = jax.lax.while_loop(
                wcond,
                wbody,
                (sink, -excess[sink], ks0, aa0, bb0, jnp.int32(0),
                 jnp.bool_(True)),
            )

            # net chain coefficient per arc (down runs +1, up runs -1);
            # overlapping runs are legal walks — capacity is enforced on
            # the NET usage, loudly failing on the degenerate zero case
            ar = jnp.arange(n, dtype=jnp.int32)

            def cbody(i, coef):
                sgn = jnp.where(ks[i] == 1, 1, jnp.where(ks[i] == 2, -1, 0))
                mask = (ar >= aa[i]) & (ar < bb[i])
                return coef + sgn * mask.astype(jnp.int32)

            coef = jax.lax.fori_loop(
                0, cnt, cbody, jnp.zeros(n, jnp.int32)
            )
            head = jnp.where(
                coef < 0, chainflow // jnp.maximum(-coef, 1), IMAX
            )
            delta = jnp.minimum(jnp.minimum(bn, jnp.min(head)), excess[src])

            def abody(i, fc):
                fl, _ = fc
                is_b = ks[i] >= 3
                sgn = jnp.where((ks[i] == 1) | (ks[i] == 3), delta, -delta)
                fl = fl.at[jnp.where(is_b, aa[i], 0)].add(
                    jnp.where(is_b, sgn, 0)
                )
                return fl, None

            flow2, _ = jax.lax.fori_loop(0, cnt, abody, (flow, None))
            chainflow2 = chainflow + delta * coef
            excess2 = excess.at[src].add(-delta).at[sink].add(delta)
            status = jnp.where(
                ~walk_ok,
                jnp.int32(PATH_OVERFLOW),
                jnp.where(delta <= 0, jnp.int32(DEGENERATE), jnp.int32(OK)),
            )
            keep = status == OK
            return (
                jnp.where(keep, flow2, flow),
                jnp.where(keep, chainflow2, chainflow),
                jnp.where(keep, excess2, excess),
                status,
            )

        def skip(_):
            status = jnp.where(
                infeasible, jnp.int32(INFEASIBLE), jnp.int32(FIXPOINT_CAP)
            )
            return flow, chainflow, excess, status

        flow2, chainflow2, excess2, status = jax.lax.cond(
            infeasible | changed, skip, augment, None
        )
        status = jnp.where(
            (status == OK) & (jnp.max(pi_new) > PI_GUARD),
            jnp.int32(PI_OVERFLOW),
            status,
        )
        supply = jnp.sum(jnp.maximum(excess2, 0))
        return flow2, chainflow2, pi_new, excess2, supply, status

    def solve_loop(bstart, bend1, off0, cap, pool, run_lo, run_hi,
                   flow, chainflow, pi, excess, phase_cap):
        """Run SSP phases to completion on device: one dispatch total."""
        supply0 = jnp.sum(jnp.maximum(excess, 0))

        def cond(c):
            _, _, _, _, supply, status, phases = c
            return (status == OK) & (supply > 0) & (phases < phase_cap)

        def body(c):
            flow, chainflow, pi, excess, _, _, phases = c
            flow, chainflow, pi, excess, supply, status = phase(
                bstart, bend1, off0, cap, pool, run_lo, run_hi,
                flow, chainflow, pi, excess,
            )
            return flow, chainflow, pi, excess, supply, status, phases + 1

        flow, chainflow, pi, excess, supply, status, phases = (
            jax.lax.while_loop(
                cond, body,
                (flow, chainflow, pi, excess, supply0, jnp.int32(OK),
                 jnp.int32(0)),
            )
        )
        status = jnp.where(
            (status == OK) & (supply > 0), jnp.int32(DEGENERATE), status
        )
        return flow, supply, status, phases

    return jax.jit(solve_loop)


_phase_fn = None


def _phase():
    global _phase_fn
    if _phase_fn is None:
        _phase_fn = _make_phase()
    return _phase_fn


def ssp_device_flows(
    bstart: np.ndarray,
    bend: np.ndarray,
    off: np.ndarray,
    pool: np.ndarray,
    first: np.ndarray,
    n: int,
    max_coverage: int,
) -> np.ndarray:
    """Run the device SSP; returns per-bucket take counts (exact optimum)."""
    import jax.numpy as jnp

    B = bstart.shape[0]
    caps = np.diff(off)
    excess0 = _node_excess(bstart, bend, caps, n, max_coverage)
    supply0 = int(excess0[excess0 > 0].sum())
    if supply0 == 0 or B == 0:
        return np.zeros(B, np.int64)
    if abs(int(excess0.min())) >= int(INF) or supply0 >= int(INF):
        raise ValueError("supply exceeds int32 device budget")
    run_lo, run_hi = _run_tables(pool, first)

    dev = {
        "bstart": jnp.asarray(bstart.astype(np.int32)),
        "bend1": jnp.asarray((bend + 1).astype(np.int32)),
        "off0": jnp.asarray(off[:B].astype(np.int32)),
        "cap": jnp.asarray(caps.astype(np.int32)),
        "pool": jnp.asarray(pool.astype(np.int32)),
        "run_lo": jnp.asarray(run_lo),
        "run_hi": jnp.asarray(run_hi),
    }
    flow = jnp.zeros(B, jnp.int32)
    chainflow = jnp.zeros(n, jnp.int32)
    pi = jnp.zeros(n + 1, jnp.int32)
    excess = jnp.asarray(excess0.astype(np.int32))
    solve_loop = _phase()

    flow, supply, status, phases = solve_loop(
        dev["bstart"], dev["bend1"], dev["off0"], dev["cap"],
        dev["pool"], dev["run_lo"], dev["run_hi"],
        flow, chainflow, pi, excess, np.int32(supply0 + 16),
    )
    status = int(status)
    if status != OK:
        raise RuntimeError(
            f"device SSP failed after {int(phases)} phases "
            f"(supply {int(supply)}/{supply0}): {_STATUS_MSG[status]}"
        )
    _log.debug("device SSP: %d phases for supply %d", int(phases), supply0)
    return np.asarray(flow).astype(np.int64)


def ssp_device_select(
    start: np.ndarray,
    end: np.ndarray,
    cost: np.ndarray,
    n: int,
    max_coverage: int,
) -> np.ndarray:
    """Exact min-cost selection meeting the capped target; device compute."""
    r = len(start)
    if r == 0:
        return np.zeros(0, np.int64)
    if n >= int(INF):
        raise ValueError("genome length exceeds int32 device budget")
    bs, be, off, pool, order, first = build_convex_buckets(start, end, cost)
    flows = ssp_device_flows(bs, be, off, pool, first, n, max_coverage)
    counts = np.diff(off)
    rank = np.arange(r, dtype=np.int64) - np.repeat(off[:-1], counts)
    take = rank < np.repeat(flows, counts)
    return np.sort(order[take]).astype(np.int64)


class QmcpDeviceMcmfSolver(Solver):
    """Exact quality-weighted device solver (registered as ``qmcp-tpu``).

    Parity: optimal objective equals the reference ``qmcp-cpu``
    (``qmcp_cpu_cost_scaling_solver.cpp:44-49``) — verified bit-for-bit in
    cost against this framework's host C++ MCMF and the LP oracle. Genomes
    longer than ``DEVICE_GENOME_LIMIT`` dispatch to the host engine (whose
    Dijkstra is hop-count-insensitive); the device scan-SSP handles the
    fixture/benchmark scale entirely on chip.
    """

    uses_quality_of_reads = True

    def __init__(self, device_genome_limit: int = DEVICE_GENOME_LIMIT):
        self.device_genome_limit = device_genome_limit

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        q = np.asarray(batch.quality, np.int64)
        max_q = int(q.max(initial=0))
        cost = max_q - q + 1
        n = batch.ref_genome_length

        def host():
            from genome_downsampler_tpu.solvers.native_mcmf import (
                mcmf_select_convex,
            )

            return mcmf_select_convex(
                batch.start, batch.end, cost, n, max_coverage
            )

        if n > self.device_genome_limit:
            _log.info(
                "qmcp-tpu: genome %d > device limit %d; host MCMF engine",
                n, self.device_genome_limit,
            )
            return host()
        try:
            return ssp_device_select(
                np.asarray(batch.start, np.int64),
                np.asarray(batch.end, np.int64),
                cost,
                n,
                int(max_coverage),
            )
        except RuntimeError as e:
            # adversarial inputs can exceed the device walk buffer below
            # the genome-length limit; the result stays exact via the
            # host engine, and the dispatch decision is logged loudly
            _log.warning("qmcp-tpu device solve failed (%s); host engine", e)
            return host()
