"""Blocked multi-window sweep: the exact MCP device path.

The water-filling sweep (``solvers/device_sweep.sweep_counts``) is a
sequential chain over genome positions. This module runs it on the device
with O(R + n) memory and W-way parallelism:

- **Reads travel as packed codes.** Host packing buckets reads by
  (block, window) into padded code lists; a code packs
  ``start_rel * L + (span - 1)`` into one int32 and ``-1`` pads. No
  ``(n, L)`` histogram of the whole genome is ever built.
- **Windows are the parallel axis.** The genome splits into W windows.
  One kernel program (one warp) sweeps one window, its whole state in
  registers: two L-vectors in suffix form, ``F[k]`` = unselected reads
  covering the position whose end is k or more slots on, and ``S[k]`` =
  the same for selected reads.
- **Groups of positions bound the arrival memory.** Each window is swept
  group by group (G positions, a multiple of L). XLA scatters a group's
  codes into a dense ``(W, G, L)`` arrival tile, and the kernel walks its
  G positions.
- **Ring coordinates make the per-position shift free.** Slot k at
  position j lives in lane ``(j + k) mod L``, so moving one position on
  relabels the lanes and only the leaving lane is zeroed. Arrival rows are
  read rotated into ring order. On suffix form the farthest-first take is
  elementwise (``m = min(taken, F); F -= m; S += m``), and the per-step
  scalars are the lanes of slots 0 and 1.
- **Windows couple only through the boundary carry**, solved by Jacobi
  fixed-point relaxation as in ``parallel/windows.py``: each round seeds
  window w with window w-1's carry-out from the round before; window 0 is
  exact at once, so exactness moves on at least one window per round, and
  the loop stops when the carries are stable. At the fixed point the
  selection is bit-identical to the global sequential sweep.

``route`` (``ops/route.py``) picks the Triton kernel on the GPU, the same
kernel in Pallas's interpret mode (CPU tests), or the plain XLA reference,
``sweep_counts`` vmapped over the windows. All three give the same
integers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


_ARENA_GEN = 0


def arena_generation() -> int:
    """Monotone counter of native-arena pack calls.

    ``pack_blocked`` / ``pack_flat_u16`` / ``pack_to_u16`` return ZERO-COPY
    views of shared process-lifetime C arenas; any later pack call silently
    repurposes that memory. Consumers that hold a view across other work
    (e.g. ``slots`` held for the whole device dispatch and only consumed by
    ``mask_select`` at the end of a solve) snapshot this counter when the
    view is created and assert it is unchanged when the view is consumed,
    so stale-view reuse fails loudly instead of corrupting the selection.
    """
    return _ARENA_GEN


def _bump_arena_gen():
    global _ARENA_GEN
    _ARENA_GEN += 1


def pack_blocked(
    start: np.ndarray,
    end: np.ndarray,
    n: int,
    n_windows: int,
    block: int,
    max_span: int,
    cap_multiple: int = 256,
    use_native: bool = True,
    return_slots: bool = False,
    cap_floor: int = 0,
):
    """Bucket reads into per-(block, window) padded code lists (host side).

    Returns ``(packed[nbw, W, cap], counts[nbw, W], win, n_pad)`` where
    ``win = nbw * block`` is the per-window length and ``n_pad = W * win``.
    ``packed[t, w, s]`` holds ``start_rel * L + (span - 1)`` for the s-th
    read whose start lies in block ``t`` of window ``w``; ``-1`` pads.

    ``return_slots=True`` appends ``slots[R]`` — each read's flat index into
    ``packed`` — used to address the device-computed selection bitmask.
    """
    W, B, L = n_windows, block, max_span
    win = -(-n // W)
    win = -(-win // B) * B
    nbw = win // B
    n_pad = W * win

    start = np.asarray(start, np.int64)
    end = np.asarray(end, np.int64)
    span = end - start + 1
    # spans are capped at L-1 so that the largest code, B*L - 2, never
    # collides with the uint16 sentinel 0xFFFF of the flat stream
    if span.size and int(span.max()) > L - 1:
        raise ValueError(
            f"read span {int(span.max())} exceeds max_span-1={L - 1}; "
            "raise max_span"
        )

    if use_native and start.size:
        try:
            return _pack_blocked_native(
                start, end, n, W, B, L, cap_multiple, return_slots,
                cap_floor,
            )
        except OSError:  # native lib unavailable: numpy fallback below
            pass

    w_id = start // win
    t_id = (start % win) // B
    start_rel = start % B
    code = (start_rel * L + (span - 1)).astype(np.int32)

    group = t_id * W + w_id  # group key in (t, w) order
    # groups are code-sorted (stable by index) — the order contract of the
    # device reconstruction mask; see gd_pack_blocked
    order = np.argsort(group.astype(np.int64) * (B * L) + code, kind="stable")
    g_sorted = group[order]
    counts_flat = np.bincount(g_sorted, minlength=nbw * W).astype(np.int32)
    cap = int(counts_flat.max()) if counts_flat.size else 0
    cap = max(cap_multiple, cap_floor, -(-cap // cap_multiple) * cap_multiple)

    # rank of each read within its group
    group_starts = np.zeros(nbw * W + 1, np.int64)
    np.cumsum(counts_flat, out=group_starts[1:])
    rank = np.arange(start.size, dtype=np.int64) - group_starts[g_sorted]

    packed = np.full((nbw, W, cap), -1, np.int32)
    t_s = g_sorted // W
    w_s = g_sorted % W
    packed[t_s, w_s, rank] = code[order]
    counts = counts_flat.reshape(nbw, W)
    if return_slots:
        slots = np.empty(start.size, np.int64)
        slots[order] = g_sorted * cap + rank
        return packed, counts, win, n_pad, slots
    return packed, counts, win, n_pad


def _pack_blocked_native(start, end, n, W, B, L, cap_multiple,
                         return_slots=False, cap_floor=0):
    """C counting-sort packing (io/csrc/greedy.cpp gd_pack_blocked); the
    numpy argsort fallback is O(R log R) and slow at 10M+ reads.

    Returned arrays are ZERO-COPY VIEWS of process-lifetime C arenas:
    valid only until the next ``pack_blocked`` call. Every consumer either
    transfers them to device or finishes with them inside one solve, so a
    copy would only add first-touch page faults."""
    import ctypes

    from genome_downsampler_tpu.io.build import build_bamio

    lib = ctypes.CDLL(str(build_bamio()))
    lib.gd_pack_blocked.restype = ctypes.c_int64
    lib.gd_pack_blocked.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
    ]
    s = np.ascontiguousarray(start, np.int64)
    e = np.ascontiguousarray(end, np.int64)
    p_packed = ctypes.POINTER(ctypes.c_int32)()
    p_counts = ctypes.POINTER(ctypes.c_int32)()
    p_slots = ctypes.POINTER(ctypes.c_int64)()
    win = ctypes.c_int64()
    cap = ctypes.c_int64()
    rc = lib.gd_pack_blocked(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        s.shape[0], n, W, B, L, cap_multiple, cap_floor, 8,
        ctypes.byref(p_packed), ctypes.byref(p_counts),
        ctypes.byref(win), ctypes.byref(cap),
        ctypes.byref(p_slots) if return_slots else None,
    )
    if rc != 0:
        raise ValueError("gd_pack_blocked: invalid reads (span/start bounds)")
    _bump_arena_gen()
    nbw = win.value // B
    packed = np.ctypeslib.as_array(p_packed, shape=(nbw, W, cap.value))
    counts = np.ctypeslib.as_array(p_counts, shape=(nbw, W))
    if return_slots:
        slots = np.ctypeslib.as_array(p_slots, shape=(s.shape[0],))
        return packed, counts, win.value, W * win.value, slots
    return packed, counts, win.value, W * win.value


def pack_flat_direct(
    start: np.ndarray,
    end: np.ndarray,
    n: int,
    n_windows: int,
    block: int,
    max_span: int,
    cap_multiple: int = 256,
    cap_floor: int = 0,
):
    """Pack STRAIGHT to the flat uint16 valid-code stream (plus counts,
    cap, and padded-index slots) without materializing the padded int32
    arena — byte-identical outputs to ``pack_blocked`` + ``pack_flat_u16``
    but skipping the sentinel-padded arena entirely (about 2.5x the
    valid codes at typical skew, filled only to be discarded).

    Returns ``(flat_u16[R], counts[nbw, W], win, n_pad, cap, slots[R])``.
    Arrays are zero-copy C-arena views (see ``arena_generation``).
    Raises OSError when the native library is unavailable (callers fall
    back to the two-step path).
    """
    import ctypes

    from genome_downsampler_tpu.io.build import build_bamio

    W, B, L = n_windows, block, max_span
    if B * L > 1 << 16:
        raise ValueError("codes exceed uint16; use pack_blocked")
    lib = ctypes.CDLL(str(build_bamio()))
    lib.gd_pack_flat_direct.restype = ctypes.c_int64
    lib.gd_pack_flat_direct.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
    ]
    s = np.ascontiguousarray(start, np.int64)
    e = np.ascontiguousarray(end, np.int64)
    p_flat = ctypes.POINTER(ctypes.c_uint16)()
    p_counts = ctypes.POINTER(ctypes.c_int32)()
    p_slots = ctypes.POINTER(ctypes.c_int64)()
    win = ctypes.c_int64()
    cap = ctypes.c_int64()
    rc = lib.gd_pack_flat_direct(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        s.shape[0], n, W, B, L, cap_multiple, cap_floor, 8,
        ctypes.byref(p_flat), ctypes.byref(p_counts),
        ctypes.byref(win), ctypes.byref(cap), ctypes.byref(p_slots),
    )
    if rc != 0:
        raise ValueError(
            "gd_pack_flat_direct: invalid reads (span/start bounds)"
        )
    _bump_arena_gen()
    nbw = win.value // B
    flat = np.ctypeslib.as_array(p_flat, shape=(s.shape[0],))
    counts = np.ctypeslib.as_array(p_counts, shape=(nbw, W))
    slots = np.ctypeslib.as_array(p_slots, shape=(s.shape[0],))
    return flat, counts, win.value, W * win.value, cap.value, slots


def pack_flat_u16(packed: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Compact padded codes to the flat valid-codes stream (group order,
    uint16) through the C arena; numpy fallback. The padded device layout
    is rebuilt by ``expand_flat_codes`` after transfer, so H2D carries R
    codes instead of ``groups * cap`` slots (~2.5x less at typical skew).
    The view is valid until the next call."""
    import ctypes

    from genome_downsampler_tpu.io.build import build_bamio

    groups = packed.shape[0] * packed.shape[1]
    cap = packed.shape[2]
    try:
        lib = ctypes.CDLL(str(build_bamio()))
    except OSError:
        flat32 = packed.reshape(groups, cap)
        keep = (
            np.arange(cap)[None, :] < counts.reshape(groups, 1)
        )
        return flat32[keep].astype(np.uint16)
    lib.gd_pack_flat_u16.restype = ctypes.c_int64
    lib.gd_pack_flat_u16.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint16)),
    ]
    pk = np.ascontiguousarray(packed.reshape(-1), np.int32)
    ct = np.ascontiguousarray(counts.reshape(-1), np.int32)
    p16 = ctypes.POINTER(ctypes.c_uint16)()
    total = lib.gd_pack_flat_u16(
        pk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ct.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        groups, cap, ctypes.byref(p16),
    )
    _bump_arena_gen()
    return np.ctypeslib.as_array(p16, shape=(int(total),))


def expand_flat_codes(flat_u16, counts, nbw: int, W: int, cap: int):
    """Device-side inverse of ``pack_flat_u16``: scatter the flat stream
    back into the padded (nbw, W, cap) int32 layout with -1 sentinels.
    Runs inside the solve jit, so host-to-device carries R codes instead
    of the padded array."""
    G = nbw * W
    R = flat_u16.shape[0]
    c = counts.reshape(G).astype(jnp.int32)
    off = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(c, dtype=jnp.int32)[:-1]]
    )
    g = jnp.repeat(
        jnp.arange(G, dtype=jnp.int32), c, total_repeat_length=R
    )
    idx = jnp.arange(R, dtype=jnp.int32) - off[g] + g * cap
    codes32 = flat_u16.astype(jnp.int32)
    codes32 = jnp.where(codes32 == 0xFFFF, jnp.int32(-1), codes32)
    full = jnp.full(G * cap, jnp.int32(-1)).at[idx].set(codes32)
    return full.reshape(nbw, W, cap)


def mask_select(bits: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """Selected read indices from the device bitmask (threaded C bit test;
    numpy fallback)."""
    import ctypes

    from genome_downsampler_tpu.io.build import build_bamio

    r = slots.shape[0]
    try:
        lib = ctypes.CDLL(str(build_bamio()))
    except OSError:
        sel01 = (bits[slots >> 3] >> (slots & 7)) & 1
        return np.flatnonzero(sel01).astype(np.int64)
    lib.gd_mask_select.restype = ctypes.c_int64
    lib.gd_mask_select.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
    ]
    b = np.ascontiguousarray(bits, np.uint8)
    sl = np.ascontiguousarray(slots, np.int64)
    out01 = np.empty(r, np.uint8)
    lib.gd_mask_select(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sl.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        r, out01.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return np.flatnonzero(out01).astype(np.int64)


# Each group's dense (W, G, L) int32 arrival tile stays under this budget.
TILE_BUDGET_BYTES = 256 * 1024 * 1024


def _is_pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def group_size(n_windows: int, max_span: int, block: int, win_min: int) -> int:
    """Positions per group: the smallest power of two that covers
    ``win_min`` positions, or the largest whose (W, G, L) int32 arrival
    tile fits ``TILE_BUDGET_BYTES``, whichever is smaller. It is at least
    ``max(L, block)``, so it is a multiple of both (the kernel's ring needs
    groups to start at lane 0; the packer's blocks must not straddle)."""
    assert _is_pow2(max_span) and _is_pow2(block), (max_span, block)
    G = max(max_span, block)
    while (
        G < win_min
        and n_windows * 2 * G * max_span * 4 <= TILE_BUDGET_BYTES
    ):
        G *= 2
    return G


def window_length(n: int, n_windows: int, group: int) -> int:
    """Positions per window: ceil(n / W), rounded up to whole groups."""
    return -(-(-(-n // n_windows)) // group) * group


def _suffix(x: jax.Array) -> jax.Array:
    """Suffix sums along the last axis: out[..., k] = sum(x[..., k:])."""
    return jnp.cumsum(x[..., ::-1], axis=-1)[..., ::-1]


def _unsuffix(f: jax.Array) -> jax.Array:
    return f - jnp.concatenate(
        [f[..., 1:], jnp.zeros_like(f[..., :1])], axis=-1
    )


def group_arrivals(
    packed: jax.Array, g, group: int, block: int, max_span: int
) -> jax.Array:
    """Dense arrivals of positions ``[g*G, (g+1)*G)`` of every window:
    ``rows[w, i, k]`` = reads of window w starting at group position i
    with span ``k + 1``. A scatter-add of the group's codes."""
    L = max_span
    k = group // block
    codes = jax.lax.dynamic_slice_in_dim(packed, g * k, k, axis=0)
    _, W, _ = codes.shape
    t = jax.lax.broadcasted_iota(jnp.int32, codes.shape, 0)
    w = jax.lax.broadcasted_iota(jnp.int32, codes.shape, 1)
    idx = (w * group + t * block + codes // L) * L + codes % L
    idx = jnp.where(codes >= 0, idx, W * group * L)  # sentinels drop
    rows = jnp.zeros(W * group * L, jnp.int32)
    rows = rows.at[idx.reshape(-1)].add(1, mode="drop")
    return rows.reshape(W, group, L)


def capped_target(
    packed: jax.Array, block: int, max_span: int, max_coverage: int
) -> jax.Array:
    """``min(coverage, M)`` per position as int32[W, win], from the codes."""
    nbw, W, _ = packed.shape
    win = nbw * block
    n_pad = W * win
    t = jax.lax.broadcasted_iota(jnp.int32, packed.shape, 0)
    w = jax.lax.broadcasted_iota(jnp.int32, packed.shape, 1)
    start = w * win + t * block + packed // max_span
    end = start + packed % max_span
    valid = packed >= 0
    drop = n_pad + 1
    d = jnp.zeros(n_pad + 1, jnp.int32)
    d = d.at[jnp.where(valid, start, drop)].add(1, mode="drop")
    d = d.at[jnp.where(valid, end + 1, drop)].add(-1, mode="drop")
    cov = jnp.cumsum(d[:n_pad])
    return jnp.minimum(cov, max_coverage).reshape(W, win)


def _sweep_kernel(
    arr_ref,   # int32[G, L] suffix-form arrivals of this window's group
    tgt_ref,   # int32[G]    capped coverage target
    f0_ref,    # int32[L]    carry-in, suffix form of the unselected stock
    s0_ref,    # int32[L]    carry-in, suffix form of the selected reads
    sel_ref,   # int32[G]    out: selected reads ending at each position
    f_ref,     # int32[L]    carry-out
    s_ref,     # int32[L]
    *,
    depth: int,
):
    G, L = arr_ref.shape
    D = depth
    lane = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)

    def fetch(k):
        # rows and targets of positions k*D .. k*D + D - 1, each row read
        # rotated into ring order (lane r holds slot (r - i) mod L). They
        # are fetched one trip ahead of their use, so the loads overlap the
        # dependency chain of the trip before.
        rows, tgts = [], []
        for u in range(D):
            i = jnp.minimum(k * D + u, G - 1)
            rows.append(plgpu.load(arr_ref.at[i, (lane - i) & (L - 1)]))
            tgts.append(tgt_ref[i])
        return rows, tgts

    def step(i, arrive, tgt, F, S):
        # Farthest-first take on suffix state: taking `taken` reads from
        # the far end empties a suffix of the slots, so every suffix sum
        # drops by min(taken, F[k]).
        at0 = lane == (i & (L - 1))  # slot 0: reads ending here
        at1 = lane == ((i + 1) & (L - 1))
        F = F + arrive
        f0 = jnp.sum(jnp.where(at0, F, 0))
        f1 = jnp.sum(jnp.where(at1, F, 0))
        s0 = jnp.sum(jnp.where(at0, S, 0))  # selected reads covering i
        s1 = jnp.sum(jnp.where(at1, S, 0))
        taken = jnp.minimum(jnp.maximum(tgt - s0, 0), f0)
        m = jnp.minimum(taken, F)
        # selected reads ending at i: S'[0] - S'[1]
        sel_ref[i] = s0 + taken - s1 - jnp.minimum(taken, f1)
        # slot 0 leaves; its lane comes back as the empty slot L-1
        return jnp.where(at0, 0, F - m), jnp.where(at0, 0, S + m)

    def trip(k, carry):
        F, S, rows, tgts = carry
        nxt_rows, nxt_tgts = fetch(k + 1)
        for u in range(D):
            F, S = step(k * D + u, rows[u], tgts[u], F, S)
        return F, S, nxt_rows, nxt_tgts

    rows, tgts = fetch(0)
    F, S, _, _ = jax.lax.fori_loop(
        0, G // D, trip, (f0_ref[...], s0_ref[...], rows, tgts)
    )
    f_ref[...] = F
    s_ref[...] = S


def _sweep_group_kernel(arr_suffix, target, F, S, interpret: bool):
    """One group of every window through the Triton kernel: one program
    (one warp) per window. Returns ``(sel[W, G], F_out, S_out)``."""
    if interpret and jax.default_backend() != "cpu":
        raise ValueError("interpret mode is for CPU tests only")
    W, G, L = arr_suffix.shape
    depth = max(1, min(8, 2048 // L))
    assert _is_pow2(L) and G % L == 0 and G % depth == 0, (G, L, depth)
    row = pl.BlockSpec((None, L), lambda w: (w, 0))
    pos = pl.BlockSpec((None, G), lambda w: (w, 0))
    return pl.pallas_call(
        functools.partial(_sweep_kernel, depth=depth),
        grid=(W,),
        in_specs=[
            pl.BlockSpec((None, G, L), lambda w: (w, 0, 0)), pos, row, row,
        ],
        out_specs=[pos, row, row],
        out_shape=[
            jax.ShapeDtypeStruct((W, G), jnp.int32),
            jax.ShapeDtypeStruct((W, L), jnp.int32),
            jax.ShapeDtypeStruct((W, L), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="blocked_sweep",
    )(arr_suffix, target, F, S)


def blocked_sweep_pass(
    packed: jax.Array,   # int32[nbw, W, cap]
    target: jax.Array,   # int32[W, win]
    avail0: jax.Array,   # int32[W, L] carry-in
    selend0: jax.Array,  # int32[W, L]
    *,
    block: int,
    max_span: int,
    group: int,
    route: str,
    first_group: int = 0,
):
    """One relaxation round: sweep all W windows, each from its carry-in.
    Returns ``(sel[W, win], avail_out[W, L], selend_out[W, L])``; carries
    are in ``sweep_counts``'s form (slot k = reads ending k positions on).

    ``first_group=k`` sweeps only positions from ``k * group`` on, starting
    there from the given carry: the cheap boundary-local pre-pass that
    seeds the relaxation (see ``blocked_windowed_sweep``)."""
    from genome_downsampler_tpu.ops.route import INTERPRET, XLA
    from genome_downsampler_tpu.solvers.device_sweep import sweep_counts

    nbw, W, _ = packed.shape
    win = nbw * block
    assert win % group == 0 and target.shape == (W, win), (win, group)
    on_kernel = route != XLA
    sweep_xla = jax.vmap(functools.partial(sweep_counts, max_span=max_span))

    def body(g, state):
        x, y, sel = state
        rows = group_arrivals(packed, g, group, block, max_span)
        tgt = jax.lax.dynamic_slice_in_dim(target, g * group, group, axis=1)
        if on_kernel:
            out, x, y = _sweep_group_kernel(
                _suffix(rows), tgt, x, y, interpret=route == INTERPRET
            )
        else:
            out, x, y = sweep_xla(rows, tgt, x, y)
        sel = jax.lax.dynamic_update_slice_in_dim(sel, out, g * group, axis=1)
        return x, y, sel

    init = (avail0, selend0)
    if on_kernel:
        init = (_suffix(avail0), _suffix(selend0))
    x, y, sel = jax.lax.fori_loop(
        first_group, win // group, body,
        (*init, jnp.zeros((W, win), jnp.int32)),
    )
    if on_kernel:
        x, y = _unsuffix(x), _unsuffix(y)
    return sel, x, y


@functools.partial(
    jax.jit,
    static_argnames=(
        "block", "max_span", "group", "route", "max_coverage",
    ),
)
def blocked_windowed_sweep(
    packed: jax.Array,         # int32[nbw, W, cap]
    target: jax.Array | None,  # int32[W, win]; None derives it
    *,
    block: int,
    max_span: int,
    group: int,
    route: str,
    max_coverage: int = 0,
):
    """Exact global sweep via carry relaxation over the windows.

    Returns ``(sel_per_end[W * win], rounds_used)`` — bit-identical to the
    global sequential ``sweep_counts`` at the fixed point. Soundness does
    not depend on how rounds are seeded: at any state where every window's
    carry-in equals its left neighbour's carry-out (which is what the
    stability check asserts), window 0 ran from the true genome-start state
    (zeros), so by induction along the windows every carry — and therefore
    the whole selection — equals the global sequential sweep's.

    ``target=None`` derives the capped target ``min(coverage,
    max_coverage)`` from the codes on the device.

    With more than one window and group, a boundary-local pre-pass comes
    first: sweep only the last group of every window from a zero carry,
    and use those window-end carries as round-1 seeds. Any selected read
    crossing a window boundary starts within ``L`` of it, so a group of
    local history predicts the
    true carry closely; zero-seeded relaxation instead moves corrections
    one window per round.
    """
    nbw, W, _ = packed.shape
    L = max_span
    n_groups = nbw * block // group
    if target is None:
        target = capped_target(packed, block, max_span, max_coverage)

    def passes(a_in, s_in, first_group=0):
        return blocked_sweep_pass(
            packed, target, a_in, s_in, block=block, max_span=max_span,
            group=group, route=route, first_group=first_group,
        )

    def shift(c_out):
        return jnp.concatenate(
            [jnp.zeros((1, L), jnp.int32), c_out[:-1]], axis=0
        )

    zeros = jnp.zeros((W, L), jnp.int32)
    if W > 1 and n_groups > 1:
        _, a_t, s_t = passes(zeros, zeros, first_group=n_groups - 1)
        a_seed, s_seed = shift(a_t), shift(s_t)
    else:
        a_seed, s_seed = zeros, zeros
    sel, a_out, s_out = passes(a_seed, s_seed)

    def cond(state):
        k, a_in, s_in, _, a_out, s_out = state
        stable = jnp.all(shift(a_out) == a_in) & jnp.all(shift(s_out) == s_in)
        return (~stable) & (k < W + 1)

    def body(state):
        k, _, _, _, a_out, s_out = state
        a_in, s_in = shift(a_out), shift(s_out)
        sel, a_out2, s_out2 = passes(a_in, s_in)
        return (k + 1, a_in, s_in, sel, a_out2, s_out2)

    k, _, _, sel, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(1), a_seed, s_seed, sel, a_out, s_out)
    )
    return sel.reshape(-1), k
