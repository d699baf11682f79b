"""Test configuration: the CPU, with an 8-device virtual mesh.

Sharding tests run over ``--xla_force_host_platform_device_count=8`` CPU
devices, which stand in for several cards (see also
``__graft_entry__.dryrun_multichip``). ``JAX_PLATFORMS`` is set through the
jax API as well, in case jax was imported before this file.

Tests marked ``gpu`` need an NVIDIA card. They take the ``gpu`` fixture,
which skips them unless the default backend is a GPU; to run them, leave
JAX its default backend on a GPU host:
``GD_TEST_GPU=1 python -m pytest tests/ -m gpu``.
"""

import os

import pytest

if not os.environ.get("GD_TEST_GPU"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (GD_TEST_GPU=1 on a GPU host)")
