"""Test harness: force CPU backend with 8 virtual devices + fp64.

Per SURVEY.md §4.4: multi-host code paths are exercised on a CPU-simulated
mesh (xla_force_host_platform_device_count=8) — the same shard_map code
path as a real multi-device mesh. fp64 is enabled so golden numerical
tests can use tight tolerances; tests of the device's fp32 path create
fp32 arrays explicitly.

The platform is pinned in the already-imported config as well as through
JAX_PLATFORMS, so the suite stays on the CPU wherever it runs. XLA_FLAGS
takes effect because the CPU backend initializes lazily. Checks that need
the GPU are phases of chip_smoke.py, not tests here.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
