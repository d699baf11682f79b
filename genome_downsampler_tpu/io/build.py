"""On-demand build of the native bamio library.

Compiles ``csrc/bamio.cpp`` into a shared object next to this module the
first time it is needed (or when the source is newer than the cached .so).
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

_CSRC = Path(__file__).parent / "csrc"
_SRCS = sorted(_CSRC.glob("*.cpp"))
_SO = Path(__file__).parent / "_bamio.so"


class NativeBuildError(OSError):
    """Raised when the native library fails to compile.

    Subclasses OSError so that every ``except OSError`` numpy-fallback site
    (pack, reconstruction, capped target) engages both when the library is
    absent (dlopen OSError) and when g++ itself fails.
    """


def build_bamio(force: bool = False) -> Path:
    # escape hatch for instrumented builds (scripts/run_asan.sh)
    override = os.environ.get("GD_BAMIO_SO")
    if override:
        return Path(override)
    newest_src = max(s.stat().st_mtime for s in _SRCS)
    if not force and _SO.exists() and _SO.stat().st_mtime >= newest_src:
        return _SO
    # build beside the target and rename into place, so that processes
    # building at once (test workers in a fresh checkout) never load a
    # half-written library
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        *[str(s) for s in _SRCS], "-o", str(tmp), "-lz", "-lpthread",
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"bamio build failed:\n{proc.stderr}")
    os.replace(tmp, _SO)
    return _SO
