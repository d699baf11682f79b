"""Exact MCP on device via a water-filling sweep compiled as ``lax.scan``.

This is the plain-JAX reference of the device solver: the blocked kernel
(``ops/pallas_blocked.py``) computes the same integers. It solves the
same problem the reference answers with OR-Tools min-cost flow / CUDA
push-relabel
(``/root/reference/libs/qmcp-solver/src/mcp_cpu_cost_scaling_solver.cpp``,
``quasi_mcp_cuda_max_flow_solver.cu``) but with an algorithm chosen for XLA
semantics instead of a translated flow kernel:

**Reformulated greedy.** The interval-flow LP is totally unimodular, and the
exact unit-cost optimum is produced by the classic left-to-right greedy
("when coverage at j falls short, select the available reads that reach
farthest right"; proof in ``greedy_mcp.py``). The greedy never cares about
read identity — only (start, end) counts — so its entire state compresses to
two small count vectors indexed by *relative end offset* ``k`` (``end ==
j + k``, ``k < L`` where ``L`` bounds the read span):

- ``avail[k]``  unselected reads covering ``j`` with end ``j + k``
- ``selend[k]`` selected reads covering ``j`` with end ``j + k``

One genome position per scan step: fold in the reads starting at ``j``
(a dense ``(n, L)`` histogram row), compute the deficit against the target,
take from the farthest slots first (a reversed cumulative sum + clip — no
heap), and emit ``selend[0]`` (the selected count whose reads end exactly at
``j``) before shifting both vectors left. The emitted stream *is* the
selected-count-per-end-position array.

**Identity reconstruction.** Within an end bucket the sweep may map its
takes to the earliest-starting reads: cumulative takes by position j never
exceed the number of bucket reads with ``start <= j``, so the first-k-by-
start reads were all available when counted. (Host numpy, O(R log R).)

Complexity: O(n * L) work, one compiled ``lax.scan`` — no data-dependent
convergence loop, bit-deterministic, and window-shardable (the carry at a
window boundary is exactly the two L-vectors, which is what the distributed
halo exchange ships between devices).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from genome_downsampler_tpu.core.readbatch import ReadBatch
from genome_downsampler_tpu.ops.coverage import capped_coverage, coverage_from_intervals
from genome_downsampler_tpu.solvers.base import Solution, Solver

DEFAULT_MAX_SPAN = 256  # static bound on read span (end - start + 1)


def build_start_rows(
    start: jax.Array, span: jax.Array, weight: jax.Array, n: int, max_span: int
) -> jax.Array:
    """Dense (n, L) histogram: rows[j, k] = # reads with start=j, span=k+1.

    ``weight`` is 0 for padded slots. Reads with span > L must have been
    rejected host-side.
    """
    flat = jnp.zeros(n * max_span, jnp.int32)
    idx = start * max_span + (span - 1)
    idx = jnp.clip(idx, 0, n * max_span - 1)
    flat = flat.at[idx].add(weight)
    return flat.reshape(n, max_span)


@functools.partial(jax.jit, static_argnames=("max_span",))
def sweep_counts(
    add_rows: jax.Array,  # int32[n, L]
    target: jax.Array,  # int32[n]
    avail0: jax.Array,  # int32[L] carry-in (window halo), zeros for genome start
    selend0: jax.Array,  # int32[L] carry-in
    max_span: int = DEFAULT_MAX_SPAN,
):
    """Run the sweep; returns (sel_per_end[n], avail_out[L], selend_out[L]).

    ``sel_per_end[e]`` = number of selected reads with end == e. The carry-out
    vectors describe reads still covering positions past the window end —
    the halo the next window to the right consumes.
    """
    L = max_span

    def step(carry, xs):
        avail, selend = carry
        add_row, tgt = xs
        avail = avail + add_row
        cur = jnp.sum(selend)
        deficit = jnp.maximum(tgt - cur, 0)
        # take from the farthest end slots first
        suffix_above = jnp.cumsum(avail[::-1])[::-1] - avail  # sum over k' > k
        take = jnp.clip(deficit - suffix_above, 0, avail)
        avail = avail - take
        selend = selend + take
        emitted = selend[0]
        # shift left: slot k at position j becomes slot k-1 at position j+1
        avail = jnp.concatenate([avail[1:], jnp.zeros(1, jnp.int32)])
        selend = jnp.concatenate([selend[1:], jnp.zeros(1, jnp.int32)])
        return (avail, selend), emitted

    (avail_out, selend_out), sel_per_end = jax.lax.scan(
        step, (avail0, selend0), (add_rows, target)
    )
    return sel_per_end, avail_out, selend_out


@functools.partial(jax.jit, static_argnames=("max_span",))
def sweep_counts_with_takes(
    add_rows: jax.Array,  # int32[n, L]
    target: jax.Array,  # int32[n]
    max_span: int = DEFAULT_MAX_SPAN,
):
    """Sweep variant that also emits the take matrix ``takes[j, k]`` =
    number of reads taken at position ``j`` from the bucket ending at
    ``j + k`` — the information a quality-aware identity assignment needs
    (memory O(n * L); used by the QMCP device solver)."""
    L = max_span

    def step(carry, xs):
        avail, selend = carry
        add_row, tgt = xs
        avail = avail + add_row
        cur = jnp.sum(selend)
        deficit = jnp.maximum(tgt - cur, 0)
        suffix_above = jnp.cumsum(avail[::-1])[::-1] - avail
        take = jnp.clip(deficit - suffix_above, 0, avail)
        avail = avail - take
        selend = selend + take
        avail = jnp.concatenate([avail[1:], jnp.zeros(1, jnp.int32)])
        selend = jnp.concatenate([selend[1:], jnp.zeros(1, jnp.int32)])
        return (avail, selend), take

    zeros = jnp.zeros(L, jnp.int32)
    _, takes = jax.lax.scan(step, (zeros, zeros), (add_rows, target))
    return takes


def reconstruct_selection(
    start: np.ndarray,
    end: np.ndarray,
    sel_per_end: np.ndarray,
    prefer_quality: np.ndarray | None = None,
) -> np.ndarray:
    """Map per-end selected counts back to concrete read indices.

    Within each end bucket, consume reads in increasing (start, index) order
    — the only order guaranteed consistent with availability at take time.
    ``prefer_quality`` is accepted for future quality-aware bucket interiors
    but is currently ignored (see QmcpDeviceSweepSolver notes).

    Large batches dispatch to the O(R + n) C counting-sort implementation
    (``io/csrc/greedy.cpp::gd_reconstruct``); the numpy lexsort below is the
    fallback and small-input path.
    """
    r = start.shape[0]
    if r >= 200_000:
        try:
            return _reconstruct_native(start, end, sel_per_end)
        except OSError:
            pass  # native lib unavailable: numpy path below
    order = np.lexsort((np.arange(r), start, end))
    e_sorted = end[order]
    # rank within each end group
    group_first = np.concatenate([[True], e_sorted[1:] != e_sorted[:-1]])
    idx = np.arange(r)
    first_idx = np.maximum.accumulate(np.where(group_first, idx, 0))
    rank = idx - first_idx
    take = sel_per_end[e_sorted] > rank
    return np.sort(order[take]).astype(np.int64)


def _reconstruct_native(
    start: np.ndarray, end: np.ndarray, sel_per_end: np.ndarray
) -> np.ndarray:
    import ctypes

    from genome_downsampler_tpu.io.build import build_bamio

    lib = ctypes.CDLL(str(build_bamio()))
    lib.gd_reconstruct.restype = ctypes.c_int64
    lib.gd_reconstruct.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    s = np.ascontiguousarray(start, np.int64)
    e = np.ascontiguousarray(end, np.int64)
    spe = np.ascontiguousarray(sel_per_end, np.int64)
    n = spe.shape[0]
    mask = np.empty(s.shape[0], np.uint8)
    total = lib.gd_reconstruct(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        s.shape[0],
        spe.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if total < 0:
        raise ValueError(
            "gd_reconstruct: invalid reads or per-end quota exceeds bucket"
        )
    return np.flatnonzero(mask).astype(np.int64)


class McpDeviceSweepSolver(Solver):
    """Exact minimum-read-count solver on the device (``mcp-tpu``).

    Parity: optimal objective equals the reference ``mcp-cpu`` OR-Tools
    solution (minimum selected-read count; optima are non-unique, so read
    sets are compared against this framework's own host oracle,
    ``greedy_mcp.py`` — see SURVEY.md section 7 "hard parts").

    One registry name covers every scale (like the reference's one name per
    algorithm, ``src/solver_manager.hpp:19-24``): every genome runs the
    O(R + n)-memory blocked multi-window sweep
    (``solvers/blocked_sweep.py``), which on the GPU also beats the
    single-window ``lax.scan`` at the smallest scale (config-1).
    """

    uses_quality_of_reads = False

    def __init__(
        self,
        max_span: int = DEFAULT_MAX_SPAN,
        pad_multiple: int = 4096,
    ):
        self.max_span = max_span
        self.pad_multiple = pad_multiple
        self.last_stats: dict | None = None

    def _check_spans(self, batch: ReadBatch) -> None:
        span_host = batch.end - batch.start + 1
        if int(span_host.max()) > self.max_span:
            raise ValueError(
                f"read span {int(span_host.max())} exceeds "
                f"max_span={self.max_span}; raise max_span (static) for "
                "this dataset"
            )

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        if batch.n_reads == 0:
            return np.zeros(0, np.int64)
        self._check_spans(batch)
        from genome_downsampler_tpu.solvers.blocked_sweep import (
            BlockedWindowedMcpSolver,
        )

        blocked = BlockedWindowedMcpSolver(max_span=self.max_span)
        out = blocked.solve(max_coverage, batch)
        self.last_stats = blocked.last_stats
        return out


@functools.partial(
    jax.jit, static_argnames=("n", "max_coverage", "max_span")
)
def _takes_pipeline(
    start: jax.Array,
    end: jax.Array,
    w: jax.Array,
    n: int,
    max_coverage: int,
    max_span: int,
):
    """Coverage -> target -> rows -> take-matrix sweep, one compiled program
    (one dispatch instead of one per operation)."""
    cov = coverage_from_intervals(start, end, n, w)
    target = capped_coverage(cov, max_coverage)
    span = end - start + 1
    rows = build_start_rows(start, span, w, n, max_span)
    return sweep_counts_with_takes(rows, target, max_span)


def quality_aware_assignment(
    start: np.ndarray,
    end: np.ndarray,
    quality: np.ndarray,
    takes_j: np.ndarray,  # int64[T] take positions (one entry per unit)
    takes_e: np.ndarray,  # int64[T] absolute end bucket per take
) -> np.ndarray:
    """Pick concrete reads for the sweep's take events, maximizing quality.

    Per end bucket, a take at position ``j`` may be served by any unused
    bucket read with ``start <= j`` — the classic unit-jobs-with-deadlines
    profit problem (reads sorted by quality descending, each assigned to the
    earliest free take slot whose position is >= its start) solved with a
    next-free-slot DSU. Selection counts (and therefore validity and the
    minimum-count optimum) are untouched; only identities change.
    """
    r = len(start)
    t = len(takes_j)
    if t == 0:
        return np.zeros(0, np.int64)
    # group take slots by bucket, positions ascending
    slot_order = np.lexsort((takes_j, takes_e))
    slot_e = takes_e[slot_order]
    slot_j = takes_j[slot_order]
    bucket_first = np.searchsorted(slot_e, np.arange(slot_e.max() + 2))

    # DSU "next free slot at or after index i" within each bucket
    parent = np.arange(t + 1, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    order = np.lexsort((np.arange(r), start, -quality))
    selected = np.zeros(r, bool)
    for i in order:
        e = end[i]
        if e >= len(bucket_first) - 1:
            continue
        lo, hi = bucket_first[e], bucket_first[e + 1]
        if lo == hi:
            continue
        # earliest slot in [lo, hi) with position >= start[i] that is free
        first_ok = lo + np.searchsorted(slot_j[lo:hi], start[i])
        s = find(first_ok)
        if s < hi:
            parent[s] = s + 1
            selected[i] = True
    return np.nonzero(selected)[0].astype(np.int64)


class QmcpDeviceSweepSolver(McpDeviceSweepSolver):
    """Quality-preferring device solver.

    The reference ``qmcp-cpu`` minimizes ``sum(max_q - q_i + 1)`` exactly via
    min-cost flow (``qmcp_cpu_cost_scaling_solver.cpp:44-49``). This device
    path keeps the sweep's minimum-*count* selection and assigns identities
    to maximize total quality within it (deadline-matching per end bucket) —
    always feasible and usually close in weighted cost; the exact weighted
    optimum is the host ``qmcp-cpu`` (C++ MCMF).
    """

    uses_quality_of_reads = True

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        n = batch.ref_genome_length
        if batch.n_reads == 0:
            return np.zeros(0, np.int64)
        self._check_spans(batch)
        arrays, valid = batch.padded(self.pad_multiple)
        start = jnp.asarray(arrays["start"])
        end = jnp.asarray(arrays["end"])
        w = jnp.asarray(valid).astype(jnp.int32)
        takes = np.asarray(
            _takes_pipeline(start, end, w, n, int(max_coverage), self.max_span)
        )
        jj, kk = np.nonzero(takes)
        counts = takes[jj, kk]
        takes_j = np.repeat(jj, counts).astype(np.int64)
        takes_e = np.repeat(jj + kk, counts).astype(np.int64)
        return quality_aware_assignment(
            np.asarray(batch.start, np.int64),
            np.asarray(batch.end, np.int64),
            np.asarray(batch.quality, np.int64),
            takes_j,
            takes_e,
        )
