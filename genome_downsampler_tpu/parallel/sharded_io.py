"""Host-sharded end-to-end downsampling: indexed BAM region reads per
process, global-mesh window solve, voffset-merged single-writer output.

The chr1-scale multi-host pipeline (BASELINE.md config 5). Per process:

1. **Read a region, not the file.** Each process looks up its genome
   window in the BAM index and reads ``[window_lo - halo, window_hi +
   halo]`` via ``io.bam.read_bam_region`` (record ids = BGZF virtual
   offsets). ``halo`` must be at least the maximum read span PLUS the
   maximum mate start distance: an end-owned read can start up to max_span
   left of the window and its mate up to the mate distance before that —
   both must fall in the scanned region or the boundary pair is dropped.
2. **Solve on the global device mesh.** Local windows' read-start rows and
   capped-coverage targets are placed shard-by-shard with
   ``jax.make_array_from_callback`` (no host ever holds the whole genome)
   and the ``parallel.mesh`` ppermute carry-relaxation solver runs SPMD —
   bit-identical to the global sequential sweep at its fixed point.
3. **Reconstruct by end ownership.** ``sel_per_end[e]`` counts are mapped
   to concrete reads with the earliest-start-per-end-bucket rule
   (``solvers.device_sweep.reconstruct_selection``); each end position
   belongs to exactly one window, so processes decide disjoint read sets
   with a deterministic global rule — the union equals the single-process
   selection bit for bit.
4. **Merge and write once.** Selected voffsets (plus mates, the reference's
   ``find_pairs`` semantics) are allgathered; process 0 re-streams the
   input BAM over the sorted union — identical output to a single-process
   run.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from genome_downsampler_tpu.config import BamApiConfig
from genome_downsampler_tpu.io.bam import read_bam_region, write_bam
from genome_downsampler_tpu.utils.logging import get_logger

_log = get_logger("parallel.sharded")


def bam_genome_length(path: Path | str) -> int:
    """First-contig length from the header only (hi = -1 stops the record
    scan immediately)."""
    cfg = BamApiConfig(min_mapq=0, min_seq_length=0)
    batch, _, _ = read_bam_region(path, cfg, 0, -1)
    return batch.ref_genome_length


def _solve_blocked_on_mesh(
    mesh,
    start_local: np.ndarray,  # starts relative to lo_w, within [0, local_n)
    end_local: np.ndarray,
    target_local: np.ndarray,  # int32[local_n]
    lo_w: int,
    local_n: int,
    win_b: int,
    w_local: int,
    block: int,
    max_span: int,
    group: int,
) -> np.ndarray:
    """Blocked-engine mesh solve for the sharded pipeline: O(R/D) packed
    codes per device. Returns sel_per_end for this process's positions."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    from genome_downsampler_tpu.ops.pallas_blocked import pack_blocked
    from genome_downsampler_tpu.ops.route import kernel_route
    from genome_downsampler_tpu.parallel.blocked_mesh import (
        make_blocked_mesh_solver,
    )

    n_dev = mesh.shape["x"]
    w_total = n_dev * w_local
    local_windows = local_n // win_b
    packed_l, _, win_chk, _ = pack_blocked(
        start_local, end_local, local_n, local_windows, block, max_span
    )
    assert win_chk == win_b, (win_chk, win_b)
    nbw = packed_l.shape[0]

    # capacities must agree across processes: allgather the max and pad
    cap_local = np.int32(packed_l.shape[2])
    caps = np.asarray(
        multihost_utils.process_allgather(jnp.asarray(cap_local))
    ).reshape(-1)
    cap = int(caps.max())
    if cap > packed_l.shape[2]:
        packed_l = np.pad(
            packed_l,
            ((0, 0), (0, 0), (0, cap - packed_l.shape[2])),
            constant_values=-1,
        )

    fn, packed_sh, target_sh = make_blocked_mesh_solver(
        mesh, block=block, max_span=max_span, group=group,
        route=kernel_route(),
    )
    w0 = (lo_w // win_b)  # first global window owned by this process

    def packed_cb(idx):
        ws = idx[1].start or 0
        return packed_l[:, ws - w0 : ws - w0 + w_local, :]

    def target_cb(idx):
        ws = idx[0].start or 0
        return target_local.reshape(local_windows, win_b)[
            ws - w0 : ws - w0 + w_local
        ]

    packed = jax.make_array_from_callback(
        (nbw, w_total, cap), packed_sh, packed_cb
    )
    target = jax.make_array_from_callback(
        (w_total, win_b), target_sh, target_cb
    )
    sel = fn(packed, target)

    sel_local = np.zeros(local_n, np.int64)
    for shard in sel.addressable_shards:
        ws = shard.index[0].start or 0
        data = np.asarray(shard.data).reshape(-1)
        off = (ws - w0) * win_b
        sel_local[off : off + data.shape[0]] = data
    return sel_local


def _allgather_varlen_i64(mat: np.ndarray) -> list:
    """Allgather a per-rank ``(c, m)`` int64 matrix with rank-dependent
    ``m``. Returns one ``(c, m_p)`` matrix per rank. jax arrays are int32
    without x64, so values ship as two uint32 planes."""
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    c, m = mat.shape
    lens = np.asarray(
        multihost_utils.process_allgather(jnp.asarray(np.int32(m)))
    ).reshape(-1)
    cap = int(lens.max()) if lens.size else 0
    if cap == 0:
        return [np.zeros((c, 0), np.int64) for _ in lens]
    u = mat.astype(np.uint64)
    pad = np.zeros((2 * c, cap), np.uint32)
    pad[:c, :m] = (u >> np.uint64(32)).astype(np.uint32)
    pad[c:, :m] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    gathered = np.asarray(
        multihost_utils.process_allgather(jnp.asarray(pad))
    ).reshape(-1, 2 * c, cap)
    out = []
    for p in range(gathered.shape[0]):
        hi = gathered[p, :c, : lens[p]].astype(np.uint64)
        lo = gathered[p, c:, : lens[p]].astype(np.uint64)
        out.append(((hi << np.uint64(32)) | lo).view(np.int64).reshape(c, -1))
    return out


QUALITY_ALGOS = ("qmcp-cpu", "qmcp-tpu", "qmcp-lp-cpu", "qmcp-sweep-tpu")


def run_sharded(
    path: Path | str,
    max_coverage: int,
    config: Optional[BamApiConfig] = None,
    out_path: Path | str | None = None,
    halo: int = 2_000,
    max_span: int = 256,
    engine: str = "auto",
    block: int = 256,
    windows_per_device: int = 8,
    algorithm: str = "mcp-tpu",
    allow_boundary_drops: bool = False,
) -> np.ndarray:
    """Sharded downsampling across all processes/devices of the jax job.

    Returns the merged selected+paired voffsets (all processes); process 0
    additionally writes ``out_path`` when given. Requires a
    coordinate-sorted input; uses ``<path>.bai`` when present. ``halo``
    must be at least max_span + the maximum mate start distance (see the
    module docstring) — and unlike round 1, a violation is now DETECTED:
    the region reader reports every read whose mapped same-contig mate
    fell outside the scanned region, and any such boundary drop that
    could touch this rank's owned window raises (``allow_boundary_drops``
    downgrades to a warning for deliberately lossy runs).

    ``algorithm``: an MCP name runs the exact sweep on the device mesh
    (``engine`` as below). A QMCP name (quality-weighted) shards the BAM
    parse and filtering across ranks, allreduces the GRADE MAPQ range so
    the quality remap is rank-invariant, allgathers the (start, end,
    cost, voffset) of owned reads in file order, and solves the exact
    convex-bucket MCMF identically on every rank — bit-equal output to a
    single-process ``qmcp-cpu`` run (the solve is replicated, the parse
    is distributed; read-count envelope documented in ARCHITECTURE.md).

    ``engine``: "dense" materializes per-device (win, L) rows (fast for
    small windows); "blocked" uses the O(R/D) packed-code kernel with
    ``windows_per_device`` windows per device (the only feasible engine
    for chr1-class windows); "auto" picks by window memory.
    """
    import jax

    from genome_downsampler_tpu.ops.pallas_blocked import (
        group_size,
        window_length,
    )
    from genome_downsampler_tpu.parallel.launch import global_window_mesh
    from genome_downsampler_tpu.parallel.mesh import make_mesh_solver
    from genome_downsampler_tpu.solvers.device_sweep import (
        reconstruct_selection,
    )

    config = config or BamApiConfig()
    if halo < 2 * max_span:
        # the true requirement is max_span + max mate start distance, which
        # is unknowable here; 2*max_span is the weakest sane lower bound
        raise ValueError(
            f"halo {halo} must be >= 2 * max_span = {2 * max_span} "
            "(and >= max_span + max mate start distance)"
        )

    n = bam_genome_length(path)
    mesh = global_window_mesh()
    n_dev = mesh.shape["x"]
    if engine == "auto":
        # dense rows for a device window cost win * L * 4 bytes
        engine = (
            "dense"
            if (-(-n // n_dev)) * max_span * 4 <= 256 * 1024 * 1024
            else "blocked"
        )
    if engine == "blocked":
        w_total = n_dev * windows_per_device
        group = group_size(
            windows_per_device, max_span, block, -(-n // w_total)
        )
        win_b = window_length(n, w_total, group)
        if win_b < max_span:
            raise ValueError(
                f"blocked window {win_b} < max_span {max_span}; lower "
                "windows_per_device"
            )
        win = windows_per_device * win_b  # per-device span
        n_pad = w_total * win_b
    else:
        win = max(-(-n // n_dev), max_span)
        n_pad = win * n_dev

    # this process's device windows form one contiguous range
    my_devs = [
        i for i, d in enumerate(mesh.devices.flat)
        if d.process_index == jax.process_index()
    ]
    lo_w, hi_w = min(my_devs) * win, (max(my_devs) + 1) * win  # [lo_w, hi_w)
    lo = max(0, lo_w - halo)
    hi = min(n_pad, hi_w + halo) - 1
    region = read_bam_region(path, config, lo, hi, defer_grade=True)
    batch = region.batch
    _log.debug(
        "rank %d: windows [%d, %d), region [%d, %d], %d reads",
        jax.process_index(), lo_w, hi_w, lo, hi, batch.n_reads,
    )

    # Halo-contract enforcement: a read whose mapped same-contig mate fell
    # outside [lo, hi] was silently dropped by the pairing scan. If either
    # record of such a pair could touch this rank's owned window, the
    # sharded output would diverge from a single-process run.
    if region.unmatched.shape[0]:
        us, ue, ump = (region.unmatched[:, k] for k in range(3))
        touches = ((ue >= lo_w) & (us < hi_w)) | (
            (ump >= lo_w - max_span) & (ump < hi_w)
        )
        n_bad = int(touches.sum())
        if n_bad:
            worst = int(
                np.max(np.abs(us[touches] - ump[touches])) + max_span
            )
            msg = (
                f"rank {jax.process_index()}: {n_bad} boundary pair(s) "
                f"dropped by the region read touch the owned window "
                f"[{lo_w}, {hi_w}); halo={halo} is too small — the widest "
                f"offending pair needs >= {worst}"
            )
            if not allow_boundary_drops:
                raise RuntimeError(msg)
            _log.warning("%s (allow_boundary_drops=True: continuing)", msg)

    # GRADE must be rank-invariant: allreduce the MAPQ range before the
    # quality remap (round-1 weakness: region-local min/max diverge).
    if config.amplicon_behaviour.name == "GRADE" and config.bed_path:
        stats = np.array(
            [
                -(region.min_mapq_seen if region.max_mapq_seen >= 0
                  else 2**31),
                region.max_mapq_seen,
            ],
            np.int64,
        )
        gathered = _allgather_varlen_i64(stats.reshape(2, 1))
        allv = np.concatenate([g.reshape(2, -1) for g in gathered], axis=1)
        gmin, gmax = int(-allv[0].max()), int(allv[1].max())
        if gmax >= 0 and gmin < 2**31:
            batch.quality = (
                batch.quality - gmin
                + np.where(region.in_single, gmax - gmin, 0)
            ).astype(np.int32)

    start = np.asarray(batch.start, np.int64)
    end = np.asarray(batch.end, np.int64)
    span = end - start + 1
    if span.size and int(span.max()) > max_span:
        raise ValueError(
            f"read span {int(span.max())} exceeds max_span={max_span}"
        )

    if algorithm in QUALITY_ALGOS:
        return _run_sharded_qmcp(
            batch, n, max_coverage, lo_w, hi_w, path, out_path, config
        )

    # local target covering this process's windows
    local_n = hi_w - lo_w
    in_win = (start >= lo_w) & (start < hi_w)
    cov = np.zeros(local_n + max_span + 1, np.int64)
    s_rel = np.clip(start - lo_w, -max_span, local_n)
    e_rel = np.clip(end - lo_w + 1, -max_span, local_n)
    valid = e_rel > s_rel  # overlaps [lo_w, hi_w) at all
    np.add.at(cov, np.maximum(s_rel[valid], 0), 1)
    np.add.at(cov, np.maximum(e_rel[valid], 0), -1)
    target_local = np.minimum(
        np.cumsum(cov)[:local_n], max_coverage
    ).astype(np.int32)

    if engine == "blocked":
        sel_local = _solve_blocked_on_mesh(
            mesh, start[in_win] - lo_w, end[in_win] - lo_w, target_local,
            lo_w, local_n, win_b, windows_per_device, block, max_span,
            group,
        )
    else:
        rows_local = np.zeros((local_n, max_span), np.int32)
        np.add.at(rows_local, (start[in_win] - lo_w, span[in_win] - 1), 1)

        fn, rows_sh, tgt_sh = make_mesh_solver(mesh, n_pad, max_span)

        def rows_cb(idx):
            g0 = idx[0].start or 0
            return rows_local[g0 - lo_w : g0 - lo_w + win]

        def tgt_cb(idx):
            g0 = idx[0].start or 0
            return target_local[g0 - lo_w : g0 - lo_w + win]

        rows = jax.make_array_from_callback(
            (n_pad, max_span), rows_sh, rows_cb
        )
        target = jax.make_array_from_callback((n_pad,), tgt_sh, tgt_cb)
        sel = fn(rows, target)

        # local shard of sel_per_end -> end-owned reconstruction
        sel_local = np.zeros(local_n, np.int64)
        for shard in sel.addressable_shards:
            g0 = shard.index[0].start or 0
            data = np.asarray(shard.data).reshape(-1)
            sel_local[g0 - lo_w : g0 - lo_w + data.shape[0]] = data

    # reconstruct over reads whose END lies in our windows; positions use
    # local coordinates (end - lo_w)
    own = (end >= lo_w) & (end < hi_w)
    idx_own = np.flatnonzero(own)
    picked = reconstruct_selection(
        start[idx_own] - lo_w, end[idx_own] - lo_w, sel_local
    )
    sel_reads = idx_own[picked]
    paired = batch.find_pairs(sel_reads)
    voffs_local = np.asarray(batch.bam_id[paired], np.int64)
    return _merge_and_write(voffs_local, path, out_path, config)


def _merge_voffsets(voffs_local: np.ndarray) -> np.ndarray:
    """Allgather every rank's selected voffsets and return the sorted
    union (voffsets are 48+ bit; shipped as two uint32 planes)."""
    parts = _allgather_varlen_i64(voffs_local.reshape(1, -1))
    if not parts:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate([p.reshape(-1) for p in parts]))


def _merge_and_write(voffs_local, path, out_path, config) -> np.ndarray:
    import jax

    merged = _merge_voffsets(np.asarray(voffs_local, np.int64))
    if out_path is not None and jax.process_index() == 0:
        write_bam(
            path, out_path, merged, config.hts_thread_count,
            ids_are_voffsets=True,
        )
    return merged


LAST_QMCP_STATS: dict = {}


def _run_sharded_qmcp(
    batch, n, max_coverage, lo_w, hi_w, path, out_path, config
) -> np.ndarray:
    """Exact weighted QMCP in sharded mode: distributed parse, PARTITIONED
    bucket build, truncated-pool gather, replicated bucket solve.

    Every read is owned by the rank whose window contains its START (a
    partition, so every convex bucket — a distinct (start, end) — lives
    wholly on one rank). Each rank builds its buckets locally in the
    whole-file emission order, truncates every pool to its cheapest
    ``min(count, M)`` units (exact: positive unit costs mean the optimum
    never flows more than M through one bucket — flowing M+1 would
    over-cover position `start` whose target is at most M, and dropping
    the dearest unit stays feasible and strictly cheaper), and allgathers
    only ``(bucket spans, truncated costs)`` — O(distinct_spans * min(dup,
    M)) per rank instead of r3's O(total_reads) 6-tuples. The bucket-level
    MCMF runs identically on every rank; each rank expands ONLY its own
    buckets' flows back to concrete reads (voffsets never leave the rank).

    Exactness contract: OBJECTIVE-exact vs a single-process ``qmcp-cpu``
    run (same optimal cost — pool truncation preserves the optimum because
    positive unit costs mean no optimum flows more than M through one
    bucket). The selected READ SET additionally matches in practice —
    bucket order, pool order and tie-breaks reproduce the whole-file
    import — but when equal-cost ties span *different buckets* the MCMF
    optimum is non-unique and the truncated network may admit a different
    equally-optimal flow vector, so read-set equality is not guaranteed in
    the adversarial-tie case (see
    ``tests/test_sharded_qmcp.py::test_truncation_objective_exact_on_ties``).
    """
    import jax

    from genome_downsampler_tpu.solvers.device_mcmf import (
        build_convex_buckets,
    )
    from genome_downsampler_tpu.solvers.native_mcmf import mcmf_flows_convex

    start = np.asarray(batch.start, np.int64)
    end = np.asarray(batch.end, np.int64)
    q = np.asarray(batch.quality, np.int64)
    voff = np.asarray(batch.bam_id, np.int64)
    # A whole-file import emits each pair at its SECOND mate's record
    # (pair-completion order), first mate first. Reproducing that exact
    # order for the owned reads makes every within-bucket tie break
    # identically to a single-process solve: key = (max voffset of the
    # pair, mate rank). Mates are locally adjacent (index ^ 1).
    pairmax = np.maximum(voff, voff[np.arange(voff.shape[0]) ^ 1])
    rank2 = (~np.asarray(batch.is_first, bool)).astype(np.int64)
    own = np.flatnonzero((start >= lo_w) & (start < hi_w))
    own = own[np.lexsort((rank2[own], pairmax[own]))]  # emission order

    # global max quality for the cost map (qmcp_cpu_cost_scaling_solver
    # .cpp:44-49 uses the whole file's max)
    q_max_local = np.array([[q[own].max() if len(own) else 0]], np.int64)
    q_max = max(int(p[0, 0]) for p in _allgather_varlen_i64(q_max_local))
    cost = q_max - q[own] + 1

    bs, be, off, pool, border, _first = build_convex_buckets(
        start[own], end[own], cost
    )
    nb = bs.shape[0]
    cnts = np.diff(off)
    keepn = np.minimum(cnts, int(max_coverage))
    rank_in = np.arange(len(pool), dtype=np.int64) - np.repeat(
        off[:-1], cnts
    )
    pool_t = pool[rank_in < np.repeat(keepn, cnts)]

    # 2 int64 columns per bucket: start, and (span << 20 | kept-units) —
    # keeps the worst-case (all-distinct spans) per-rank gather under 60%
    # of the r3 replicated 6-tuple footprint even before truncation helps.
    # Bit budget: keepn needs 20 bits, span the remaining 43 — validated
    # here because a silent overflow would corrupt spans/pool offsets on
    # the gathering ranks.
    if int(max_coverage) >= 1 << 20:
        raise ValueError(
            f"sharded qmcp: max_coverage {max_coverage} >= 2^20 overflows "
            "the packed bucket metadata; use single-process mode"
        )
    span_all = be - bs + 1
    if len(span_all) and int(span_all.max()) >= 1 << 42:
        raise ValueError("sharded qmcp: bucket span overflows metadata")
    packed_meta = (span_all << 20) | keepn.astype(np.int64)
    meta = np.concatenate(
        [np.array([nb], np.int64), bs, packed_meta]
    ).reshape(1, -1)
    mparts = _allgather_varlen_i64(meta)
    pparts = _allgather_varlen_i64(pool_t.reshape(1, -1))

    gbs, gbe, gkeep = [], [], []
    for p in mparts:
        row = p.reshape(-1)
        b_k = int(row[0])
        pbs = row[1 : 1 + b_k]
        pm = row[1 + b_k : 1 + 2 * b_k]
        gbs.append(pbs)
        gbe.append(pbs + (pm >> 20) - 1)
        gkeep.append(pm & ((1 << 20) - 1))
    my_rank = jax.process_index()
    my_b0 = int(sum(len(x) for x in gbs[:my_rank]))
    gbs_c = np.concatenate(gbs)
    gbe_c = np.concatenate(gbe)
    gkeep_c = np.concatenate(gkeep)
    goff = np.zeros(len(gbs_c) + 1, np.int64)
    np.cumsum(gkeep_c, out=goff[1:])
    gpool = np.concatenate([p.reshape(-1) for p in pparts])

    # ranks own ascending start windows, and each local bucket list is
    # (start, end)-sorted, so the concatenation is globally sorted — the
    # exact bucket sequence a whole-file build produces
    flows = mcmf_flows_convex(
        gbs_c, gbe_c, goff, gpool, int(n), int(max_coverage)
    )
    tot_reads = sum(
        int(p.reshape(-1)[0])
        for p in _allgather_varlen_i64(np.array([[len(own)]], np.int64))
    )
    global LAST_QMCP_STATS
    LAST_QMCP_STATS = {
        # what this rank now holds of remote data vs what the r3 scheme
        # replicated (6-column int64 tuples for every read)
        "gathered_bytes": int((2 * len(gbs_c) + len(gpool)) * 8),
        "replicated_tuple_bytes_r3": int(6 * 8 * tot_reads),
        "buckets": int(len(gbs_c)),
        "pool_units": int(len(gpool)),
        "total_reads": int(tot_reads),
    }

    my_flows = flows[my_b0 : my_b0 + nb]
    take = rank_in < np.repeat(my_flows, cnts)
    mine_idx = own[border[take]]
    paired = batch.find_pairs(np.sort(mine_idx))
    voffs_local = np.asarray(batch.bam_id[paired], np.int64)
    return _merge_and_write(voffs_local, path, out_path, config)
