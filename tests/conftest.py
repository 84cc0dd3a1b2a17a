"""Test harness: run all tests on a virtual 8-device CPU mesh.

Must set XLA flags *before* jax is imported anywhere — this is the standard
way to exercise pjit/shard_map collectives without accelerators
(SURVEY.md §4). Tests that need a GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them here.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
# entry points turn the persistent compile cache on; tests compile afresh
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu_device():
    """JAX's first device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
