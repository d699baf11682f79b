"""Name -> solver registry.

Parity target: ``SolverManager``
(``/root/reference/src/solver_manager.hpp:16-42``), which registers
``quasi-mcp-cpu`` (default), ``mcp-cpu``, ``qmcp-cpu`` and (under CUDA)
``quasi-mcp-cuda``. Here the device solvers keep the names of the first
release (the CLI surface; they run on the GPU) and the CPU names are kept
for CLI compatibility. Factories are
lazy so importing the registry never pulls in JAX for host-only use.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from genome_downsampler_tpu.solvers.base import Solver

DEFAULT_SOLVER_NAME = "quasi-mcp-cpu"  # reference default, src/app.hpp:25


class SolverRegistry:
    def __init__(self) -> None:
        self._factories: Dict[str, Callable[[], Solver]] = {}
        self._uses_quality: Dict[str, bool] = {}

    def register(
        self, name: str, factory: Callable[[], Solver], uses_quality: bool
    ) -> None:
        self._factories[name] = factory
        self._uses_quality[name] = uses_quality

    def contains(self, name: str) -> bool:
        return name in self._factories

    def get(self, name: str) -> Solver:
        if name not in self._factories:
            raise KeyError(f"unknown solver: {name!r}; known: {self.get_names()}")
        from genome_downsampler_tpu.solvers.base import SpanGuard

        return SpanGuard(self._factories[name]())

    def uses_quality_of_reads(self, name: str) -> bool:
        """Static lookup (no instantiation) — the app layer needs this before
        constructing the solver, like ``src/app.cpp:120-128``."""
        return self._uses_quality[name]

    def get_names(self) -> List[str]:
        return sorted(self._factories)


def _make_greedy() -> Solver:
    from genome_downsampler_tpu.solvers.native_greedy import NativeGreedyMcpSolver

    return NativeGreedyMcpSolver()


def _make_py_greedy() -> Solver:
    from genome_downsampler_tpu.solvers.greedy_mcp import GreedyMcpSolver

    return GreedyMcpSolver()


def _make_qmcp_cpu() -> Solver:
    from genome_downsampler_tpu.solvers.native_mcmf import NativeQmcpSolver

    return NativeQmcpSolver()


def _make_qmcp_lp() -> Solver:
    from genome_downsampler_tpu.solvers.sequential_mcmf import QmcpSequentialSolver

    return QmcpSequentialSolver()


def _make_push_relabel() -> Solver:
    from genome_downsampler_tpu.solvers.push_relabel import QuasiMcpPushRelabelSolver

    return QuasiMcpPushRelabelSolver()


def _make_mcp_device() -> Solver:
    from genome_downsampler_tpu.solvers.device_sweep import McpDeviceSweepSolver

    return McpDeviceSweepSolver()


def _make_qmcp_device() -> Solver:
    from genome_downsampler_tpu.solvers.device_mcmf import QmcpDeviceMcmfSolver

    return QmcpDeviceMcmfSolver()


def _make_qmcp_sweep() -> Solver:
    from genome_downsampler_tpu.solvers.device_sweep import QmcpDeviceSweepSolver

    return QmcpDeviceSweepSolver()


def _make_blocked() -> Solver:
    from genome_downsampler_tpu.solvers.blocked_sweep import BlockedWindowedMcpSolver

    return BlockedWindowedMcpSolver()


def _make_test() -> Solver:
    from genome_downsampler_tpu.solvers.test_solver import TestSolver

    return TestSolver()


def default_registry() -> SolverRegistry:
    reg = SolverRegistry()
    # CPU-name compatibility: quasi-mcp-cpu in the reference returns *some*
    # feasible selection via OR-Tools max-flow; the exact C++ greedy
    # dominates it (feasible and minimum-size), so both CPU names map to it.
    reg.register("quasi-mcp-cpu", _make_greedy, uses_quality=False)
    reg.register("mcp-cpu", _make_greedy, uses_quality=False)
    reg.register("mcp-cpu-py", _make_py_greedy, uses_quality=False)
    reg.register("qmcp-cpu", _make_qmcp_cpu, uses_quality=True)
    reg.register("qmcp-lp-cpu", _make_qmcp_lp, uses_quality=True)
    # Device solvers (the reference's CUDA slot, re-designed for XLA). Their
    # names keep a historical suffix as the CLI surface; they run on the GPU.
    # quasi-mcp-tpu == mcp-tpu: the exact sweep is also the best feasible
    # selection; the push-relabel flow engine stays available by name.
    reg.register("quasi-mcp-tpu", _make_mcp_device, uses_quality=False)
    reg.register("quasi-mcp-flow-tpu", _make_push_relabel, uses_quality=False)
    reg.register("mcp-tpu", _make_mcp_device, uses_quality=False)
    # qmcp-tpu is EXACT in the reference's weighted objective (scan-SSP on
    # the convex-bucket network); the faster min-count-then-quality
    # heuristic sweep stays available under an explicit name.
    reg.register("qmcp-tpu", _make_qmcp_device, uses_quality=True)
    reg.register("qmcp-sweep-tpu", _make_qmcp_sweep, uses_quality=True)
    # the blocked multi-window sweep by name (mcp-tpu runs it too)
    reg.register("mcp-tpu-blocked", _make_blocked, uses_quality=False)
    reg.register("test", _make_test, uses_quality=False)
    return reg
