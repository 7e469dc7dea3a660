"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh (SURVEY.md §4 "multi-node testing"):
CPU gives native f64 (the reference's primary scalar type) and lets
distributed-parity tests exercise real multi-device shardings without
accelerator hardware. The platform is chosen through ``jax.config``
before any backend initialises, so the suite runs on the CPU even on a
machine with a GPU. Tests that need the GPU carry the ``gpu`` marker and
skip themselves on the CPU; on a GPU machine run them with
``SPALINALG_TEST_PLATFORM=gpu python -m pytest -m gpu tests/``.
"""

import os

import jax

if os.environ.get("SPALINALG_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def cpu_devices():
    return jax.devices("cpu")
