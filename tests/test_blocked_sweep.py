"""Blocked multi-window sweep vs the global scan (CPU: kernel in interpret
mode, and the XLA reference)."""

import numpy as np
import jax.numpy as jnp
import pytest

from genome_downsampler_tpu.ops.coverage import (
    capped_coverage,
    coverage_from_intervals,
)
from genome_downsampler_tpu.ops.pallas_blocked import (
    blocked_windowed_sweep,
    pack_blocked,
)
from genome_downsampler_tpu.solvers.device_sweep import (
    build_start_rows,
    sweep_counts,
)
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform


def global_reference(batch, n_pad, m, L):
    arrays, valid = batch.padded(1024)
    start = jnp.asarray(arrays["start"])
    end = jnp.asarray(arrays["end"])
    w = jnp.asarray(valid).astype(jnp.int32)
    rows = build_start_rows(start, end - start + 1, w, n_pad, L)
    target = capped_coverage(coverage_from_intervals(start, end, n_pad, w), m)
    z = jnp.zeros(L, jnp.int32)
    sel, _, _ = sweep_counts(rows, target, z, z, L)
    return np.asarray(sel)


def run_blocked(batch, n, W, B, L, m, route="interpret"):
    start = np.asarray(batch.start, np.int64)
    end = np.asarray(batch.end, np.int64)
    packed, counts, win, n_pad = pack_blocked(
        start, end, n, W, B, L, cap_multiple=16
    )
    s_dev = jnp.asarray(start.astype(np.int32))
    e_dev = jnp.asarray(end.astype(np.int32))
    ones = jnp.ones(start.shape[0], jnp.int32)
    cov = coverage_from_intervals(s_dev, e_dev, n_pad, ones)
    target = capped_coverage(cov, m).reshape(W, win)
    sel, rounds = blocked_windowed_sweep(
        jnp.asarray(packed), target,
        block=B, max_span=L, group=B, route=route,
    )
    return np.asarray(sel), n_pad, int(rounds)


def test_pack_blocked_roundtrip():
    rng = np.random.default_rng(0)
    start = rng.integers(0, 1000, 500)
    span = rng.integers(10, 64, 500)
    end = start + span - 1
    W, B, L = 4, 32, 64
    packed, counts, win, n_pad = pack_blocked(start, end, 1000, W, B, L, 16)
    assert n_pad == W * win and win % B == 0
    total = int((packed >= 0).sum())
    assert total == 500 == int(counts.sum())
    # decode every code back and verify bucketing
    nbw = win // B
    for t in range(nbw):
        for w in range(W):
            codes = packed[t, w, : counts[t, w]]
            assert (codes >= 0).all()
            s_rel = codes // L
            sp = codes % L + 1
            s_abs = w * win + t * B + s_rel
            mask = (start // win == w) & ((start % win) // B == t)
            np.testing.assert_array_equal(
                np.sort(s_abs), np.sort(start[mask])
            )
            np.testing.assert_array_equal(
                np.sort(s_abs + sp - 1), np.sort(end[mask])
            )


@pytest.mark.parametrize(
    "seed,m,route", [(0, 3, "interpret"), (1, 7, "xla"), (2, 12, "interpret")]
)
def test_blocked_matches_global_sweep(seed, m, route):
    W, B, L = 4, 64, 64
    n = 900  # not a multiple of W*B: exercises padding
    rng = np.random.default_rng(seed)
    batch = rand_reads_uniform(rng, 800, n, 48)
    sel, n_pad, rounds = run_blocked(batch, n, W, B, L, m, route)
    ref = global_reference(batch, n_pad, m, L)
    np.testing.assert_array_equal(sel, ref)
    assert 1 <= rounds <= W


def test_blocked_sparse_blocks_and_empty_windows():
    # all reads clumped at the genome start: later windows see zero reads
    W, B, L = 4, 32, 32
    n = 512
    rng = np.random.default_rng(3)
    start = rng.integers(0, 40, 300)
    span = rng.integers(5, 32, 300)
    from genome_downsampler_tpu.core.readbatch import ReadBatch

    r = start.size
    batch = ReadBatch(
        bam_id=np.arange(r, dtype=np.int64),
        start=start.astype(np.int32),
        end=(start + span - 1).astype(np.int32),
        quality=np.full(r, 50, np.int32),
        seq_length=span.astype(np.int32),
        is_first=np.tile([True, False], r // 2),
        ref_genome_length=n,
    )
    sel, n_pad, _ = run_blocked(batch, n, W, B, L, m=4)
    ref = global_reference(batch, n_pad, 4, L)
    np.testing.assert_array_equal(sel, ref)


def test_blocked_solver_matches_host_oracle():
    from genome_downsampler_tpu.solvers.blocked_sweep import (
        BlockedWindowedMcpSolver,
    )
    from genome_downsampler_tpu.solvers.greedy_mcp import GreedyMcpSolver

    rng = np.random.default_rng(7)
    batch = rand_reads_uniform(rng, 1200, 2000, 50)
    sel = BlockedWindowedMcpSolver(
        n_windows=4, block=64, max_span=64, interpret=True
    ).solve(5, batch)
    oracle = GreedyMcpSolver().solve(5, batch)
    np.testing.assert_array_equal(sel, oracle)


def host_reconstruct(batch, m, L=64):
    """Per-end counts of the global sweep, mapped to reads by the host
    counting sort — the reference for the on-device reconstruction."""
    from genome_downsampler_tpu.solvers.device_sweep import (
        reconstruct_selection,
    )

    n = batch.ref_genome_length
    sel = global_reference(batch, n, m, L)
    return reconstruct_selection(
        np.asarray(batch.start, np.int64), np.asarray(batch.end, np.int64),
        sel,
    )


@pytest.mark.parametrize("seed,m", [(0, 4), (5, 9)])
def test_device_reconstruct_mask_equals_host_reconstruct(seed, m):
    """The on-device bitmask reconstruction selects the exact same reads as
    the host counting sort (same (end, start, index) bucket rule)."""
    from genome_downsampler_tpu.solvers.blocked_sweep import (
        BlockedWindowedMcpSolver,
    )

    rng = np.random.default_rng(seed)
    batch = rand_reads_uniform(rng, 1500, 2500, 60)
    sel_dev = BlockedWindowedMcpSolver(
        n_windows=4, block=64, max_span=64
    ).solve(m, batch)
    np.testing.assert_array_equal(sel_dev, host_reconstruct(batch, m))


def test_device_reconstruct_stress_duplicates_and_spill():
    """Adversarial mask-reconstruction data: heavy duplicate (start, end)
    cells (exercises intra-cell index ranks incl. runs longer than a
    block's share), and reads ending across window boundaries."""
    from genome_downsampler_tpu.core.readbatch import ReadBatch
    from genome_downsampler_tpu.solvers.blocked_sweep import (
        BlockedWindowedMcpSolver,
    )

    rng = np.random.default_rng(11)
    n, L = 2048, 64
    parts = []
    # clumps of identical reads (PCR-duplicate shape)
    for ci in range(60):
        s = int(rng.integers(0, n - L))
        sp = int(rng.integers(4, L - 1))
        k = 100 if ci == 0 else int(rng.integers(2, 24))
        parts.append(np.tile([[s, s + sp - 1]], (k, 1)))
    # plus uniform background, with mass near window boundaries
    s = rng.integers(0, n - L, 800)
    sp = rng.integers(1, L - 1, 800)
    parts.append(np.stack([s, s + sp - 1], axis=1))
    iv = np.concatenate(parts)
    rng.shuffle(iv)
    r = len(iv)
    batch = ReadBatch(
        bam_id=np.arange(r, dtype=np.int64),
        start=iv[:, 0].astype(np.int64),
        end=iv[:, 1].astype(np.int64),
        quality=np.full(r, 50, np.int64),
        seq_length=(iv[:, 1] - iv[:, 0] + 1).astype(np.int64),
        is_first=np.tile([True, False], r // 2 + 1)[:r],
        ref_genome_length=n,
    )
    for m in (3, 11):
        sel_dev = BlockedWindowedMcpSolver(
            n_windows=4, block=64, max_span=64, interpret=m == 3
        ).solve(m, batch)
        np.testing.assert_array_equal(sel_dev, host_reconstruct(batch, m))


def test_pack_blocked_slots_roundtrip():
    """slots[r] addresses read r's code in the packed array, on both the
    native and numpy packers."""
    rng = np.random.default_rng(4)
    start = rng.integers(0, 900, 400)
    span = rng.integers(5, 64, 400)
    end = start + span - 1
    for use_native in (True, False):
        packed, counts, win, n_pad, slots = pack_blocked(
            start, end, 1000, 4, 32, 64, 16,
            use_native=use_native, return_slots=True,
        )
        codes = packed.reshape(-1)[slots]
        np.testing.assert_array_equal(codes // 64, start % 32)
        np.testing.assert_array_equal(codes % 64, span - 1)
        assert len(np.unique(slots)) == 400


def test_geometry_caps_windows_at_deep_coverage():
    """Deep input coverage caps the window count at DEEP_MAX_WINDOWS;
    shallower data may use up to MAX_WINDOWS; every window keeps at least
    MIN_WINDOW positions."""
    from genome_downsampler_tpu.solvers.blocked_sweep import (
        DEEP_COVERAGE,
        DEEP_MAX_WINDOWS,
        MAX_WINDOWS,
        MIN_WINDOW,
        BlockedWindowedMcpSolver,
    )

    s = BlockedWindowedMcpSolver()
    n = 62_500_000
    assert s._geometry(n, 150, 60.0)[0] == MAX_WINDOWS
    assert s._geometry(n, 150, DEEP_COVERAGE)[0] == DEEP_MAX_WINDOWS
    assert s._geometry(30_000, 150, 10_000.0)[0] == 1
    W = s._geometry(2_000_000, 150, 60.0)[0]
    assert W < MAX_WINDOWS
    assert 2_000_000 // W >= MIN_WINDOW > 2_000_000 // (2 * W)


def test_uint16_code_path_bit_equal_to_int32():
    """The uint16 packed-code transfer path (sentinel 0xFFFF) restores to
    the identical selection as the int32 path, including max-code reads."""
    from genome_downsampler_tpu.core.readbatch import ReadBatch
    from genome_downsampler_tpu.solvers.blocked_sweep import (
        BlockedWindowedMcpSolver,
    )
    from genome_downsampler_tpu.solvers.greedy_mcp import GreedyMcpSolver

    rng = np.random.default_rng(9)
    n, L = 2048, 64
    r = 800
    start = rng.integers(0, n - L, r)
    span = rng.integers(1, L, r)  # spans up to L-1: code < B*L - 1
    # force a read at the top of the code space (start_rel = B-1)
    start[0] = 63
    span[0] = L - 1
    batch = ReadBatch(
        bam_id=np.arange(r, dtype=np.int64),
        start=start.astype(np.int64),
        end=(start + span - 1).astype(np.int64),
        quality=np.full(r, 50, np.int64),
        seq_length=span.astype(np.int64),
        is_first=np.tile([True, False], r // 2),
        ref_genome_length=n,
    )
    # block*max_span = 64*64 = 4096 <= 2^16: the uint16 path engages
    sel = BlockedWindowedMcpSolver(
        n_windows=4, block=64, max_span=64
    ).solve(3, batch)
    # identity tie-breaks differ legitimately from the Python greedy under
    # variable spans; the uint16/int8 transfer encodings must preserve the
    # exact per-end counts of the global sweep and the optimal count
    _, n_pad, _ = run_blocked(batch, n, 4, 64, 64, m=3, route="xla")
    ref_counts = global_reference(batch, n_pad, 3, 64)
    ce = np.bincount(
        np.asarray(batch.end)[np.asarray(sel)], minlength=n_pad
    )
    np.testing.assert_array_equal(ce, ref_counts)
    oracle = GreedyMcpSolver().solve(3, batch)
    assert len(sel) == len(oracle)


def test_selection_mask_matches_host_reconstruct():
    """The on-device bucket rule (``_selection_mask``: two stable argsorts
    over packed slots) picks the same reads as the host counting sort
    (``reconstruct_selection``) for the same per-end counts."""
    import jax.numpy as jnp

    from genome_downsampler_tpu.ops.pallas_blocked import mask_select
    from genome_downsampler_tpu.solvers.blocked_sweep import _selection_mask
    from genome_downsampler_tpu.solvers.device_sweep import (
        reconstruct_selection,
    )

    rng = np.random.default_rng(21)
    batch = rand_reads_uniform(rng, 1800, 2500, 60)
    start = np.asarray(batch.start, np.int64)
    end = np.asarray(batch.end, np.int64)
    W, B, L = 4, 64, 64
    packed, _, win, n_pad, slots = pack_blocked(
        start, end, 2500, W, B, L, 64, return_slots=True
    )
    p32 = jnp.asarray(np.ascontiguousarray(packed))
    sel, _ = blocked_windowed_sweep(
        p32, None, block=B, max_span=L, group=B, route="xla",
        max_coverage=6,
    )
    bits, n_sel = _selection_mask(p32, sel, W, B, L, win)
    dev = mask_select(np.asarray(bits), slots)
    host = reconstruct_selection(start, end, np.asarray(sel)[:2500])
    np.testing.assert_array_equal(dev, host)
    assert len(dev) == int(n_sel)


def test_fast_bam_writer_roundtrip():
    """write_test_bam_fast produces files the native reader parses with
    identical content to the slow per-record writer."""
    import tempfile

    from genome_downsampler_tpu.config import BamApiConfig
    from genome_downsampler_tpu.io.bam import read_bam
    from genome_downsampler_tpu.testing.bam_writer import (
        write_test_bam,
        write_test_bam_fast,
    )

    rng = np.random.default_rng(6)
    batch = rand_reads_uniform(rng, 4000, 50_000, 150)
    cfg = BamApiConfig(min_mapq=0, min_seq_length=0)
    with tempfile.TemporaryDirectory() as d:
        write_test_bam_fast(f"{d}/fast.bam", batch)
        write_test_bam(f"{d}/slow.bam", batch, coordinate_sorted=True)
        fast, _, _ = read_bam(f"{d}/fast.bam", cfg)
        slow, _, _ = read_bam(f"{d}/slow.bam", cfg)
        assert fast.n_reads == slow.n_reads == batch.n_reads

        def key(b):
            return sorted(
                zip(b.start.tolist(), b.end.tolist(), b.quality.tolist())
            )

        assert key(fast) == key(slow)


def test_geometry_span_upgrade_keeps_halo_tiling():
    """A span >= max_span upgrades L to the next power of two (the kernel's
    lane ring needs one); the block keeps B * L within the uint16 code
    stream, and the group is a whole number of both."""
    from genome_downsampler_tpu.solvers.blocked_sweep import (
        BlockedWindowedMcpSolver,
    )

    s = BlockedWindowedMcpSolver()
    for n in (8_192, 100_000, 4_000_000, 60_000_000):
        for span_max in (100, 255, 256, 300, 512, 513, 640):
            W, B, L, G = s._geometry(n, span_max)
            assert L & (L - 1) == 0 and span_max <= L - 1, (n, span_max, L)
            assert B * L <= 1 << 16, (n, span_max, B, L)
            assert G % L == 0 and G % B == 0, (n, span_max, B, L, G)
            assert W * G * L * 4 <= 256 * 1024 * 1024 or G == max(B, L)


def test_blocked_solver_span_at_default_max_span():
    """End-to-end device_reconstruct solve with one read of span exactly
    DEFAULT_MAX_SPAN: L upgrades to 512 and the block shrinks to 128."""
    from genome_downsampler_tpu.core.readbatch import ReadBatch
    from genome_downsampler_tpu.solvers.blocked_sweep import (
        BlockedWindowedMcpSolver,
    )
    from genome_downsampler_tpu.solvers.greedy_mcp import GreedyMcpSolver

    rng = np.random.default_rng(11)
    n = 8_192
    r = 400
    start = rng.integers(0, n - 700, r)
    span = rng.integers(30, 200, r)
    start[0], span[0] = 100, 256  # span == DEFAULT_MAX_SPAN
    end = start + span - 1
    batch = ReadBatch.from_reads(
        [
            (i, int(start[i]), int(end[i]), 60, int(span[i]), i % 2 == 0)
            for i in range(r)
        ],
        n,
    )
    solver = BlockedWindowedMcpSolver(interpret=True)
    W, B, L, _ = solver._geometry(n, 256)
    assert L == 512 and B == 128
    sel = solver.solve(4, batch)
    oracle = GreedyMcpSolver().solve(4, batch)
    np.testing.assert_array_equal(sel, oracle)


def test_pack_flat_direct_matches_two_step():
    """gd_pack_flat_direct must emit byte-identical (flat stream, counts,
    cap, slots) to pack_blocked + pack_flat_u16 — the contract that lets
    the solver skip the padded arena entirely."""
    from genome_downsampler_tpu.ops.pallas_blocked import (
        pack_blocked,
        pack_flat_direct,
        pack_flat_u16,
    )

    for seed, (W, B, L) in enumerate(
        [(8, 128, 256), (16, 256, 256), (4, 64, 128)]
    ):
        rng = np.random.default_rng(23 + seed)
        r = 20_000
        n = 50_000
        start = rng.integers(0, n - 300, r)
        end = start + rng.integers(1, min(250, L - 2), r)
        flat, counts, win, n_pad, cap, slots = pack_flat_direct(
            start, end, n, W, B, L, cap_multiple=128, cap_floor=256
        )
        flat = flat.copy()
        counts = counts.copy()
        slots = slots.copy()
        packed2, counts2, win2, n_pad2, slots2 = pack_blocked(
            start, end, n, W, B, L, cap_multiple=128, return_slots=True,
            cap_floor=256,
        )
        flat2 = pack_flat_u16(packed2, counts2)
        assert (win, n_pad, cap) == (win2, n_pad2, packed2.shape[2])
        np.testing.assert_array_equal(counts, counts2)
        np.testing.assert_array_equal(flat, flat2)
        np.testing.assert_array_equal(slots, slots2)
