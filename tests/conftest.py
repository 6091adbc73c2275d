"""Test config: run JAX on a virtual 8-device CPU mesh.

Bit-exactness of every op must hold on any backend (all statistics are
integer/fixed-point), so the suite always runs on the CPU, with 8 virtual
devices to also exercise the multi-device sharding paths.  The on-card
checks are the phases of ``chip_smoke.py``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (must configure before backend init)

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0102)


@pytest.fixture(scope="session")
def small_frame(rng):
    """Random RGBA frame with some alpha-0 pixels and value-boundary pixels."""
    f = rng.integers(0, 256, size=(48, 64, 4), dtype=np.uint8)
    f[..., 3] = np.where(rng.random((48, 64)) < 0.1, 0, f[..., 3])
    # plant boundary values
    f[0, 0] = (0, 0, 0, 255)
    f[0, 1] = (255, 255, 255, 255)
    f[0, 2] = (128, 128, 128, 255)
    f[0, 3] = (255, 0, 0, 0)  # alpha-0 saturated red
    return f


@pytest.fixture(scope="session")
def frame_1080p(rng):
    f = rng.integers(0, 256, size=(1080, 1920, 4), dtype=np.uint8)
    f[..., 3] = np.where(rng.random((1080, 1920)) < 0.05, 0, 255)
    return f
