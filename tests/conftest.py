"""Test configuration.

Tests run on a virtual 8-device CPU mesh (the reference simulates multi-node
with multi-rank single-node, ref: tests/CMakeLists.txt:159-178; we simulate
multi-chip with xla_force_host_platform_device_count).  Numerics run in f64
for iteration-count parity with the (f64) reference.
"""

import os

# Must be set before the CPU backend first initializes.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# force the CPU backend for tests — it honors the virtual device count
# above
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import subprocess
import sys

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where JAX finds none "
                   "(run on the card with `python -m pytest tests -m gpu`)")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def gpu_env():
    """Environment for a child process on the real backend (this process
    is pinned to the CPU); skips unless that backend is a GPU."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if r.returncode != 0 or r.stdout.split()[-1:] != ["gpu"]:
        pytest.skip("needs an NVIDIA GPU; JAX finds none here")
    return env
