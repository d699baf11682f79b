"""Which implementation of a device kernel runs on the current backend.

Every caller that can run a hand-written kernel asks here, so the choice
is made in one place:

- ``gpu``: the kernel, compiled for the card;
- ``cpu``: the plain XLA reference, or the kernel in Pallas's interpret
  mode when the caller asks for it (the tests do);
- any other platform: an error.

Interpret mode is never reachable on the GPU.
"""

from __future__ import annotations

KERNEL = "kernel"
INTERPRET = "interpret"
XLA = "xla"


def kernel_route(interpret: bool = False) -> str:
    import jax

    platform = jax.devices()[0].platform
    if platform == "gpu":
        if interpret:
            raise ValueError("interpret mode is for CPU tests, not the GPU")
        return KERNEL
    if platform == "cpu":
        return INTERPRET if interpret else XLA
    raise RuntimeError(
        f"no kernel route for platform {platform!r} (supported: gpu, cpu)"
    )
