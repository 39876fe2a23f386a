"""Installable-packaging checks.

The reference ships an install/consumption story (CMake install +
pkg-config + SWIG module, exercised by Examples/CMakeLinkage and CI —
reference CMakeLists.txt, UnitTests/test_build.py); the analogue here
is a standard wheel.  This builds the wheel from the checkout,
installs it into a scratch target, and imports it from OUTSIDE the repo
so a missing package / missing package-data regression fails loudly.
"""
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.slow
def test_wheel_installs_and_imports(tmp_path):
    wheel_dir = tmp_path / "wheel"
    target = tmp_path / "site"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    build = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", str(REPO),
         "--no-build-isolation", "--no-deps", "--no-index",
         "-w", str(wheel_dir)],
        capture_output=True, text=True, env=env, timeout=300)
    assert build.returncode == 0, build.stderr
    wheels = list(wheel_dir.glob("ntpoly_tpu-*.whl"))
    assert len(wheels) == 1, list(wheel_dir.iterdir())
    inst = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-deps", "--no-index",
         "--target", str(target), str(wheels[0])],
        capture_output=True, text=True, env=env, timeout=300)
    assert inst.returncode == 0, inst.stderr
    # import from outside the checkout: only the installed tree on the path
    check = (
        "import os, ntpoly_tpu, ntpoly_tpu.native.build as b\n"
        f"assert ntpoly_tpu.__file__.startswith({str(target)!r}), "
        "ntpoly_tpu.__file__\n"
        "assert ntpoly_tpu.__version__\n"
        "for src in b._SRCS:\n"
        "    assert os.path.exists(src), f'missing package data: {src}'\n"
        "print('INSTALL_OK', ntpoly_tpu.__version__)\n")
    env_run = dict(env)
    env_run["PYTHONPATH"] = str(target)
    env_run["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run([sys.executable, "-c", check],
                         capture_output=True, text=True, env=env_run,
                         cwd=str(tmp_path), timeout=300)
    assert run.returncode == 0, run.stderr
    assert "INSTALL_OK" in run.stdout


def test_version_consistent():
    """pyproject version == package __version__ (one release number)."""
    import tomllib

    import ntpoly_tpu
    meta = tomllib.loads((REPO / "pyproject.toml").read_text())
    assert meta["project"]["version"] == ntpoly_tpu.__version__
