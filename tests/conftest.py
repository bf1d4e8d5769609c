"""Test configuration: run on CPU with 8 virtual devices so sharding tests
exercise the multi-device code paths without an accelerator (SURVEY.md §4:
"use CPU jax as the mock backend in CI"). What runs only on the GPU is a
phase of chip_smoke.py at the repository root."""
import os
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CBOX_SCENE = str(REPO / "scenes" / "cbox" / "scene.json")
MATBOX_SCENE = str(REPO / "scenes" / "matbox" / "scene.json")
CLASSROOM_SCENE = str(REPO / "scenes" / "classroom" / "scene.json")


@pytest.fixture
def rng_np():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def cbox_path():
    return CBOX_SCENE
