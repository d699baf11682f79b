"""Batched multi-sample solving: vmap the sweep across samples.

A production service downsamples many BAMs against the same reference; the
sweep's per-position state is a (L,) vector, so B samples stack into a
(B, L) carry and run in one scan: one step advances every sample, so the
per-step dispatch cost is shared B ways. This is a capability the reference (single-shot CLI) does not
have.
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from genome_downsampler_tpu.core.readbatch import ReadBatch
from genome_downsampler_tpu.ops.coverage import capped_coverage, coverage_from_intervals
from genome_downsampler_tpu.solvers.device_sweep import (
    DEFAULT_MAX_SPAN,
    build_start_rows,
    reconstruct_selection,
    sweep_counts,
)


def solve_batch(
    batches: Sequence[ReadBatch],
    max_coverage: int,
    max_span: int = DEFAULT_MAX_SPAN,
    pad_multiple: int = 4096,
) -> List[np.ndarray]:
    """Solve several samples (sharing one reference genome) in one vmapped
    sweep. Returns per-sample selected read indices (each exact)."""
    if not batches:
        return []
    n = max(b.ref_genome_length for b in batches)
    rows_all, targets = [], []
    for b in batches:
        if b.n_reads and int((b.end - b.start).max()) + 1 > max_span:
            raise ValueError("read span exceeds max_span")
        arrays, valid = b.padded(pad_multiple)
        start = jnp.asarray(arrays["start"])
        end = jnp.asarray(arrays["end"])
        w = jnp.asarray(valid).astype(jnp.int32)
        rows_all.append(build_start_rows(start, end - start + 1, w, n, max_span))
        targets.append(
            capped_coverage(coverage_from_intervals(start, end, n, w), max_coverage)
        )
    # samples may have different padded read counts; rows/targets are all
    # (n, L)/(n,) so they stack regardless
    rows = jnp.stack(rows_all)
    target = jnp.stack(targets)
    zeros = jnp.zeros((len(batches), max_span), jnp.int32)
    sel_counts, _, _ = jax.vmap(
        lambda r, t, a, s: sweep_counts(r, t, a, s, max_span)
    )(rows, target, zeros, zeros)
    sel_np = np.asarray(sel_counts)
    return [
        reconstruct_selection(
            np.asarray(b.start, np.int64), np.asarray(b.end, np.int64), sel_np[i]
        )
        for i, b in enumerate(batches)
    ]
