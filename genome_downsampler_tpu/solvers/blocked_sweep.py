"""Exact MCP solver on the device: the blocked multi-window sweep.

Device memory is O(R + n): packed read codes, the capped-coverage target,
one group's arrival tile and the per-end output. See
``ops/pallas_blocked.py`` for the kernel design.

Selection semantics are identical to the host greedy's per-end counts
(exact minimum count; reference parity notes in ``device_sweep.py``)
because the relaxed windowed sweep is bit-identical to the global sweep
at its fixed point.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from genome_downsampler_tpu.core.readbatch import ReadBatch
from genome_downsampler_tpu.ops.pallas_blocked import (
    arena_generation,
    blocked_windowed_sweep,
    expand_flat_codes,
    group_size,
    mask_select,
    pack_blocked,
    pack_flat_direct,
    pack_flat_u16,
    window_length,
)
from genome_downsampler_tpu.ops.route import kernel_route
from genome_downsampler_tpu.solvers.base import Solution, Solver
from genome_downsampler_tpu.solvers.device_sweep import DEFAULT_MAX_SPAN
from genome_downsampler_tpu.utils.logging import get_logger

_log = get_logger("solvers.blocked_sweep")

# Window geometry: a window holds at least MIN_WINDOW positions, and there
# are at most MAX_WINDOWS of them (one warp each), or DEEP_MAX_WINDOWS at
# DEEP_COVERAGE and above, where carry corrections travel further and
# relaxation needs more rounds per window (PERF.md, Findings).
MIN_WINDOW = 16_384
MAX_WINDOWS = 128
DEEP_MAX_WINDOWS = 32
DEEP_COVERAGE = 150.0


class _Phase:
    """Wall-clock laps of the blocked solve, kept in ``laps`` and logged at
    DEBUG (or printed to stderr when GD_TRACE_PHASES is set)."""

    def __init__(self):
        import os
        import time

        self.force = bool(os.environ.get("GD_TRACE_PHASES"))
        self.t = time.perf_counter()
        self.clock = time.perf_counter
        self.laps: dict[str, float] = {}

    def lap(self, what: str):
        now = self.clock()
        dt = now - self.t
        self.t = now
        self.laps[what] = round(dt, 4)
        if self.force:
            import sys

            print(f"[blocked {what}] {dt:.3f}s", file=sys.stderr, flush=True)
        else:
            _log.debug("phase %s: %.3fs", what, dt)


def _selection_mask(p32, sel, n_windows, block, max_span, win):
    """Device-side identity reconstruction: per end bucket, the first
    ``sel[e]`` reads by (start, index) — identical rule to
    ``device_sweep.reconstruct_selection`` — computed as a bitmask over
    packed slots so the readback is ~R/8 bytes instead of ``n`` counts.

    Order: two stable argsorts (LSD radix: by start, then by end) give
    (end, start, slot) order; a slot tie-breaks identically to the original
    read index because equal (start, end) reads share a pack group, where
    slots are filled in index order. Rank-in-bucket = position minus the
    bucket's first position (a running max over bucket heads).
    """
    W, B, L = n_windows, block, max_span
    nbw, _, cap = p32.shape
    S = nbw * W * cap
    codes = p32.reshape(S)
    imax = jnp.int32(2**31 - 1)
    valid = codes >= 0
    sidx = jnp.arange(S, dtype=jnp.int32)
    t_idx = sidx // (W * cap)
    w_idx = (sidx // cap) % W
    start = w_idx * win + t_idx * B + codes // L
    end = start + codes % L
    start_key = jnp.where(valid, start, imax)
    end_key = jnp.where(valid, end, imax)
    o1 = jnp.argsort(start_key, stable=True)
    o = o1[jnp.argsort(end_key[o1], stable=True)]
    e_sorted = end_key[o]
    first = jnp.concatenate(
        [jnp.ones(1, bool), e_sorted[1:] != e_sorted[:-1]]
    )
    first_idx = jax.lax.cummax(jnp.where(first, sidx, 0))
    rank = sidx - first_idx
    c = sel[jnp.clip(e_sorted, 0, sel.shape[0] - 1)].astype(jnp.int32)
    take_sorted = (rank < c) & (e_sorted < imax)
    n_selected = jnp.sum(take_sorted.astype(jnp.int32))
    mask = jnp.zeros(S, bool).at[o].set(take_sorted)
    bits = jnp.sum(
        mask.reshape(S // 8, 8).astype(jnp.uint8)
        << jnp.arange(8, dtype=jnp.uint8),
        axis=1, dtype=jnp.uint8,
    )
    return bits, n_selected


def _restore_codes(packed, counts, n_windows, block, win, cap):
    """int32[nbw, W, cap] codes from the flat uint16 stream (1-D) or the
    padded int32 array as packed."""
    if packed.ndim == 1:
        return expand_flat_codes(packed, counts, win // block, n_windows, cap)
    return packed


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_windows", "block", "max_span", "group", "route", "win", "cap",
        "max_coverage",
    ),
)
def _blocked_pipeline_mask(
    packed, counts, *, n_windows, block, max_span, group, route, win, cap,
    max_coverage,
):
    """Solve and identity reconstruction in one program: returns
    ``(mask_bits[S//8] uint8, n_selected, rounds)``, so the readback is a
    bit per packed slot instead of ``n`` per-end counts."""
    p32 = _restore_codes(packed, counts, n_windows, block, win, cap)
    sel, rounds = blocked_windowed_sweep(
        p32, None, block=block, max_span=max_span, group=group, route=route,
        max_coverage=max_coverage,
    )
    bits, n_selected = _selection_mask(
        p32, sel, n_windows, block, max_span, win
    )
    return bits, n_selected, rounds


class BlockedWindowedMcpSolver(Solver):
    """Exact minimum-read-count solver, O(R + n) device memory, W windows
    in parallel.

    The identity assignment runs on the device too, so the readback is a
    per-slot bitmask (R/8 bytes) instead of ``n`` per-end counts.
    ``interpret=True`` runs the kernel in Pallas's interpret mode (CPU
    only, for tests); otherwise ``ops.route`` picks the kernel on the GPU
    and the XLA reference on the CPU.
    """

    uses_quality_of_reads = False

    def __init__(
        self,
        n_windows: int | None = None,
        block: int | None = None,
        max_span: int = DEFAULT_MAX_SPAN,
        interpret: bool = False,
    ):
        self.n_windows = n_windows
        self.block = block
        self.max_span = max_span
        self.interpret = interpret
        # filled by solve(): relaxation rounds actually used, geometry
        self.last_stats: dict | None = None

    def _geometry(self, n: int, span_max: int, coverage: float = 0.0):
        """(W, B, L, G) for this genome at this mean input coverage.

        - L, the slot count, is a power of two (the kernel's lane ring and
          Triton's block shapes need one) with ``span_max <= L - 1``.
        - B, the packing block, is ``65536 // L``: the largest block whose
          codes still fit the uint16 flat stream.
        - W doubles while every window keeps ``MIN_WINDOW`` positions, up
          to ``MAX_WINDOWS`` (``DEEP_MAX_WINDOWS`` at deep coverage): more
          windows mean fewer sequential positions per pass but a longer
          carry chain to relax.
        - G, the group, follows from the arrival-tile budget.
        """
        L = 1 << max(self.max_span - 1, 1).bit_length()
        while span_max > L - 1:
            L *= 2
        B = self.block or max(1, 65536 // L)
        W = self.n_windows
        if W is None:
            w_max = MAX_WINDOWS
            if coverage >= DEEP_COVERAGE:
                w_max = DEEP_MAX_WINDOWS
            W = 1
            while W < w_max and n // (2 * W) >= MIN_WINDOW:
                W *= 2
        G = group_size(W, L, B, -(-n // W))
        return W, B, L, G

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        n = batch.ref_genome_length
        if batch.n_reads == 0:
            return np.zeros(0, np.int64)

        ph = _Phase()
        start = np.asarray(batch.start, np.int64)
        end = np.asarray(batch.end, np.int64)
        span_max = int((end - start).max()) + 1
        coverage = float((end - start + 1).sum()) / max(n, 1)
        W, B, L, G = self._geometry(n, span_max, coverage)
        route = kernel_route(self.interpret)
        # pack as if the genome were W whole windows of whole groups
        n_eff = W * window_length(n, W, G)
        packed = None
        if B * L <= 1 << 16:
            try:
                # straight to the flat uint16 stream: no padded arena
                packed, counts, win, _, cap, slots = pack_flat_direct(
                    start, end, n_eff, W, B, L, cap_multiple=256,
                )
            except (OSError, AttributeError):
                # native lib unavailable, or a stale GD_BAMIO_SO override
                # without the symbol: two-step fallback below
                packed = None
        if packed is None:
            padded, counts, win, _, slots = pack_blocked(
                start, end, n_eff, W, B, L,
                cap_multiple=256, return_slots=True,
            )
            cap = padded.shape[2]
            # real codes are <= B*L - 2 (span cap is L-1), so the uint16
            # sentinel 0xFFFF never collides
            packed = (
                pack_flat_u16(padded, counts) if B * L <= 1 << 16 else padded
            )
        ph.lap("pack")
        # `slots` (and the packed/counts views) are zero-copy C-arena views:
        # snapshot the generation now and verify it before consuming slots
        # at the end of the solve, so any interleaved pack call (a second
        # solver instance, an overlapping warmup) fails loudly instead of
        # silently corrupting the selection
        arena_gen0 = arena_generation()
        geo = dict(
            n_windows=W, block=B, max_span=L, group=G, route=route, win=win,
            cap=cap, max_coverage=int(max_coverage),
        )
        packed_d = jnp.asarray(packed)
        counts_d = jnp.asarray(np.ascontiguousarray(counts))

        bits, n_selected, rounds = jax.block_until_ready(
            _blocked_pipeline_mask(packed_d, counts_d, **geo)
        )
        ph.lap("device solve")
        bits_np = np.asarray(bits)
        ph.lap("readback")
        if arena_generation() != arena_gen0:
            raise RuntimeError(
                "native pack arenas were overwritten mid-solve "
                "(interleaved pack call); slots view is stale"
            )
        out = mask_select(bits_np, slots)
        ph.lap("bit test")
        if len(out) != int(n_selected):
            raise RuntimeError(
                "device mask readback mismatch: "
                f"{len(out)} != {int(n_selected)}"
            )
        self.last_stats = {
            "rounds": int(rounds), "n_windows": W, "block": B, "group": G,
            "max_span": L, "positions_per_pass": win, "route": route,
            "phases_s": ph.laps,
        }
        return out
