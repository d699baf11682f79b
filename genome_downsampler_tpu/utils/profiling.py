"""Profiling hooks: jax.profiler traces + per-phase wall timers.

The reference's tracing story is chrono timers at DEBUG plus a clang XRay
build preset (SURVEY.md section 5.1). The JAX equivalents: ``trace``
captures a TensorBoard-compatible device trace around any phase;
``annotate`` adds named regions; the per-phase timers live in
``utils.timer``.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator, Optional

from genome_downsampler_tpu.utils.logging import get_logger

_log = get_logger("profiling")


@contextlib.contextmanager
def trace(log_dir: Optional[Path | str]) -> Iterator[None]:
    """Capture a jax.profiler trace into ``log_dir`` (no-op when None)."""
    if log_dir is None:
        yield
        return
    import jax

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    _log.info("profiling to %s", log_dir)
    with jax.profiler.trace(str(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named trace region (shows up in the profiler timeline)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
