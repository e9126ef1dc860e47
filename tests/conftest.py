"""Test configuration: the CPU backend with an 8-device virtual mesh.

Sharding correctness is validated on virtual CPU devices (multi-card
hardware is not needed for correctness); chip_smoke.py runs the main path on
the GPU.  Tests that need the card carry the registered ``gpu`` marker and
take the ``gpu_device`` fixture, which skips them when JAX finds no GPU.
They run on a GPU machine with MJPEG423_TESTS_ON_GPU=1, which keeps this
file from forcing the CPU backend:

    MJPEG423_TESTS_ON_GPU=1 python -m pytest tests -m gpu
"""
import os

ON_GPU = os.environ.get("MJPEG423_TESTS_ON_GPU") == "1"
if not ON_GPU:
    # A pytest plugin may import jax before this conftest, so the env var
    # alone can be too late — update the live jax config as well (backends
    # initialize lazily, so this holds as long as no device was touched).
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX finds none (decided here, at
    run time, never while test modules are imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(423)


def make_test_frames(rng, num_frames=6, h=48, w=64, motion=True):
    """Synthetic RGB frames: smooth gradients + moving square + noise.

    Exercises DC chains (gradients), P-frame deltas (motion), and the
    clamping paths (saturated patches).
    """
    frames = []
    yy, xx = np.mgrid[0:h, 0:w]
    for t in range(num_frames):
        base = np.zeros((h, w, 3), dtype=np.float64)
        base[..., 0] = (xx * 255 / w + t * 3) % 256
        base[..., 1] = (yy * 255 / h) % 256
        base[..., 2] = ((xx + yy) * 2 + t * 5) % 256
        if motion:
            x0 = (t * 7) % max(w - 16, 1)
            y0 = (t * 5) % max(h - 16, 1)
            base[y0:y0 + 16, x0:x0 + 16] = [255, 255, 255]
            base[:8, :8] = [0, 0, 0]
        noise = rng.integers(0, 12, size=(h, w, 3))
        frames.append(np.clip(base + noise, 0, 255).astype(np.uint8))
    return frames
