"""Test harness platform setup.

Tests run on the JAX CPU backend with 8 virtual devices, so all
sharding/collective code paths (Mesh, jit shardings, shard_map) are
exercised deterministically without the GPU (SURVEY.md §4); the Pallas
kernel runs in interpret mode there.

``CARCA_TEST_PLATFORM=gpu`` leaves the platform alone, for running the
``gpu``-marked tests on the card:

    CARCA_TEST_PLATFORM=gpu python -m pytest -m gpu tests/
"""

import os

import pytest

if os.environ.get("CARCA_TEST_PLATFORM", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
# the entry points turn on the persistent compile cache; CPU test runs
# (many workers, throwaway shapes) keep nothing on disk
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on the GPU. Decided here, at run time — never
    at import or collection time, where workers could disagree on which
    tests exist."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs the GPU (backend is {jax.default_backend()!r})")


def skip_unless_devices(n: int) -> None:
    """Guard for tests that build an n-device mesh in-process. On the
    default CPU platform the conftest forces 8 virtual devices, so these
    always run; on a one-card suite run they skip with a justification
    instead of failing inside ``make_mesh``."""
    if jax.device_count() < n:
        pytest.skip(f"needs {n} devices, platform has {jax.device_count()} "
                    f"(sharding is validated on the 8-virtual-device CPU "
                    f"mesh)")
