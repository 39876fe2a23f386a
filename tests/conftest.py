"""Test harness configuration.

Mirrors the reference's testing model (reference UnitTests/RunTest.sh +
CMakeLists.txt:42-52): every suite runs against a grid shape taken from the
PROCESS_ROWS/PROCESS_COLUMNS/PROCESS_SLICES environment (default sweeps are
parametrized per-file), on an 8-device CPU mesh.

Tests marked ``gpu`` need the card: run them with
``NTPOLY_TEST_GPU=1 python -m pytest tests/ -m gpu``, which leaves JAX on its
default (GPU) backend.  Without the variable they skip.
"""
import os

import jax

# Backend initialization is lazy, so this process can still be steered onto
# an 8-device CPU mesh before any array is created.
GPU_RUN = os.environ.get("NTPOLY_TEST_GPU", "") == "1"
if not GPU_RUN:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    jax.config.update("jax_platforms", "cpu")

# NTPOLY_TEST_F32=1 runs the suite at the GPU path's dtype (f32, x64 off)
# — the oracle tolerance (1e-4, reference UnitTests/helpers.py:13) must
# hold there too.
F32 = os.environ.get("NTPOLY_TEST_F32", "") == "1"
jax.config.update("jax_enable_x64", not F32)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

THRESHOLD = 1e-4
EXTRAP_THRESHOLD = 1e-1


def grid_shape_from_env(default=(2, 2, 1)):
    r = os.environ.get("PROCESS_ROWS")
    c = os.environ.get("PROCESS_COLUMNS")
    s = os.environ.get("PROCESS_SLICES")
    if r and c and s:
        return (int(r), int(c), int(s))
    return default


def solver_grid_sweep():
    """Grid shapes the solver suites sweep (env override picks one shape,
    the way the reference's RunTest.sh drives ctest)."""
    env = grid_shape_from_env(None)
    if env is not None:
        return [env]
    return [(1, 1, 1), (2, 2, 1), (2, 2, 2), (1, 2, 4)]


@pytest.fixture
def gpu_grid():
    """A one-device grid on the GPU; skips unless a GPU run was asked for
    (decided here, never at import time)."""
    if not GPU_RUN or jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: NTPOLY_TEST_GPU=1 pytest -m gpu")
    from ntpoly_tpu.parallel.grid import ProcessGrid
    return ProcessGrid(1, 1, 1)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def rel_error(result, check):
    denom = np.linalg.norm(np.asarray(check))
    return np.linalg.norm(np.asarray(result) - np.asarray(check)) \
        / max(denom, 1e-30)
