"""chr1-scale single-device demo: 250 Mb genome, 100M reads, all on device.

BASELINE.md config 5's shape (human chr1 ~250 Mb, 100M reads, coverage
60x -> 30x) on ONE device. Reads come from a Weyl sequence (low-discrepancy
uint32 arithmetic) that host numpy reproduces bit-exactly for the C++
oracle, so no gigabyte input crosses to the device — it generates the
reads itself:

  starts_i = ((i * 2654435761) mod 2^32) mod (n - read_len + 1)

Device pipeline (all jit):
  generate -> pack by (window, block) via sort + scatter -> capped-coverage
  target -> blocked multi-window sweep with carry relaxation.

Validation: selected count equals the exact C++ host greedy on the
identical reads, and (fixed span) the selected coverage is checked >=
target at every base ON DEVICE via a windowed suffix sum.

Usage: timeout 1800 python -u scripts/bench_chr1.py [reads_millions] [M]
       timeout 1800 python -u scripts/bench_chr1.py --qmcp [reads_millions] [M]

``--qmcp`` benches the exact QUALITY-WEIGHTED solve (the reference
``qmcp-cpu`` objective ``sum(max_q - q + 1)``,
``/root/reference/libs/qmcp-solver/src/qmcp_cpu_cost_scaling_solver.cpp:44-49``)
at chromosome scale via the host convex-bucket SSP MCMF — host-only (the
Dijkstra engine is hop-count-insensitive; see solvers/device_mcmf.py for
the device dispatch rule). Validity is checked per base; optimality is the
engine's SSP invariant (every augmentation rides a shortest path under
Johnson potentials), cross-checked against the LP oracle at small scale in
tests/test_native_mcmf.py. SSP phase count scales with the capped target's
positive variation (~M + local dips), each phase a line Dijkstra — the
measured scaling law is recorded in BASELINE.md.
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

N = 250_000_000
READ_LEN = 150
M = 30
W, B, L, CAP = 64, 256, 256, 256
WEYL = np.uint32(2654435761)
WEYL_Q = np.uint32(2246822519)


def host_starts(r):
    i = np.arange(r, dtype=np.uint32)
    return ((i * WEYL) % np.uint32(N - READ_LEN + 1)).astype(np.int64)


def host_quality(r):
    """Pseudo-random MAPQ stream 0..60, reproducible like host_starts."""
    i = np.arange(r, dtype=np.uint32)
    h = i * WEYL_Q
    h ^= h >> 15
    h = h * np.uint32(2654435761)
    h ^= h >> 13
    return (h % np.uint32(61)).astype(np.int64)


def main_qmcp(r, m):
    """Exact weighted QMCP at chromosome scale (VERDICT round-1 item 10).

    The genome scales with the read count to hold mean coverage at 60x
    (chr1 shape: 100M reads -> 250 Mb), so the capped target — and with it
    the SSP supply, which drives the phase count — keeps the production
    shape at every ladder size."""
    from genome_downsampler_tpu.solvers.native_mcmf import mcmf_select_convex

    n = min(N, r * READ_LEN // 60)
    print(f"QMCP: n={n} reads={r} M={m} (~60x coverage)", flush=True)
    t0 = time.perf_counter()
    i = np.arange(r, dtype=np.uint32)
    s = ((i * WEYL) % np.uint32(n - READ_LEN + 1)).astype(np.int64)
    e = s + READ_LEN - 1
    q = host_quality(r)
    cost = 60 - q + 1
    print(f"host gen: {time.perf_counter()-t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    sel = mcmf_select_convex(s, e, cost, n, m)
    solve_t = time.perf_counter() - t0
    total_cost = int(cost[sel].sum())
    print(
        f"exact weighted QMCP (host SSP MCMF): {solve_t:.1f}s "
        f"selected={len(sel)} cost={total_cost}",
        flush=True,
    )

    t0 = time.perf_counter()
    d = np.bincount(s, minlength=n + 1)
    d[1:] -= np.bincount(e, minlength=n + 1)[: n]
    cov = np.cumsum(d[:n])
    ds = np.bincount(s[sel], minlength=n + 1)
    ds[1:] -= np.bincount(e[sel], minlength=n + 1)[: n]
    out = np.cumsum(ds[:n])
    ok = bool(np.all(np.minimum(cov, m) <= out))
    print(
        f"validity (coverage >= capped target everywhere): {ok} "
        f"(checked in {time.perf_counter()-t0:.1f}s)",
        flush=True,
    )
    assert ok
    print(
        f"OK exact weighted QMCP at {r/1e6:.0f}M reads / {n/1e6:.0f} Mb: "
        f"{solve_t:.1f}s, {r/solve_t/1e6:.2f}M reads/s",
        flush=True,
    )


def main():
    import jax
    import jax.numpy as jnp

    from genome_downsampler_tpu.ops.pallas_blocked import (
        blocked_windowed_sweep,
        group_size,
        window_length,
    )
    from genome_downsampler_tpu.ops.route import kernel_route
    from genome_downsampler_tpu.solvers.native_greedy import native_greedy_select

    r = int(float(sys.argv[1]) * 1e6) if len(sys.argv) > 1 else 100_000_000
    global M
    if len(sys.argv) > 2:
        M = int(sys.argv[2])
    G = group_size(W, L, B, -(-N // W))
    win = window_length(N, W, G)
    nbw = win // B
    n_pad = W * win
    print(f"n={N} reads={r} win={win} nbw={nbw} n_pad={n_pad}", flush=True)

    # ---- host oracle (identical reads via the Weyl construction) ----
    t0 = time.perf_counter()
    s_host = host_starts(r)
    e_host = s_host + READ_LEN - 1
    print(f"host gen: {time.perf_counter()-t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    oracle = native_greedy_select(s_host, e_host, N, M)
    oracle_count = len(oracle)
    print(
        f"host C++ greedy: {time.perf_counter()-t0:.1f}s "
        f"selected={oracle_count}",
        flush=True,
    )

    # ---- device: generate + pack + target (one jit) ----
    @jax.jit
    def build():
        i = jax.lax.iota(jnp.uint32, r)
        starts = (
            (i * WEYL) % jnp.uint32(N - READ_LEN + 1)
        ).astype(jnp.int32)
        code = (starts % B) * L + (READ_LEN - 1)
        group = ((starts % win) // B) * W + (starts // win)
        order = jnp.argsort(group)
        g_sorted = group[order]
        code_sorted = code[order]
        first = jnp.searchsorted(g_sorted, g_sorted, side="left")
        rank = jnp.arange(r, dtype=jnp.int32) - first.astype(jnp.int32)
        maxrank = jnp.max(rank)
        flat = g_sorted * CAP + rank
        packed = (
            jnp.full(nbw * W * CAP, -1, jnp.int32)
            .at[flat]
            .set(code_sorted)
            .reshape(nbw, W, CAP)
        )
        cov = (
            jnp.zeros(n_pad + 1, jnp.int32)
            .at[starts]
            .add(1)
            .at[starts + READ_LEN]
            .add(-1)
        )
        target = jnp.minimum(jnp.cumsum(cov)[:n_pad], M).reshape(W, win)
        return packed, target, maxrank

    t0 = time.perf_counter()
    packed, target, maxrank = build()
    maxrank = int(maxrank)
    print(
        f"device gen+pack+target: {time.perf_counter()-t0:.1f}s "
        f"max group fill={maxrank + 1} (cap {CAP})",
        flush=True,
    )
    assert maxrank < CAP, "bucket overflow: raise CAP"

    # ---- solve ----
    t0 = time.perf_counter()
    sel, rounds = blocked_windowed_sweep(
        packed, target, block=B, max_span=L, group=G, route=kernel_route(),
    )
    dev_count = int(jnp.sum(sel))
    solve_t = time.perf_counter() - t0
    print(
        f"device solve (compile+run): {solve_t:.1f}s rounds={int(rounds)} "
        f"selected={dev_count}",
        flush=True,
    )

    # ---- validate on device: fixed span => selected coverage at p is the
    # sum of sel_per_end over [p, p+READ_LEN-1] ----
    @jax.jit
    def valid(sel_flat, target_flat):
        cs = jnp.cumsum(sel_flat)
        upper = jnp.minimum(
            jnp.arange(n_pad) + READ_LEN - 1, n_pad - 1
        )
        win_sum = cs[upper] - jnp.where(
            jnp.arange(n_pad) > 0, cs[jnp.arange(n_pad) - 1], 0
        )
        return jnp.all(win_sum >= target_flat)

    ok = bool(valid(sel.reshape(-1), target.reshape(-1)))
    print(f"device validity (coverage >= target everywhere): {ok}", flush=True)
    assert ok
    assert dev_count == oracle_count, (dev_count, oracle_count)
    print(
        f"OK exact at chr1 scale: {dev_count} == host oracle; "
        f"{r/solve_t/1e6:.1f}M reads/s incl compile",
        flush=True,
    )


if __name__ == "__main__":
    if "--qmcp" in sys.argv:
        args = [a for a in sys.argv[1:] if a != "--qmcp"]
        r = int(float(args[0]) * 1e6) if args else 100_000_000
        m = int(args[1]) if len(args) > 1 else M
        main_qmcp(r, m)
    else:
        import jax

        print("backend:", jax.devices()[0].platform, flush=True)
        main()
