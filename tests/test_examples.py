"""Execute every example exactly as its ReadMe says to run it.

Mirrors the reference's example testing (reference UnitTests/test_build.py
:12-26 + check_examples.sh): the run commands are parsed out of each
ReadMe.md code fence and executed verbatim in a subprocess on the CPU
mesh.  A ReadMe whose commands do not work fails the suite.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
NAMES = sorted(p.name for p in EXAMPLES.iterdir() if p.is_dir())


def readme_commands(example_dir: Path):
    """Shell commands from the ReadMe's fenced code blocks (python lines
    only, continuation backslashes folded)."""
    text = (example_dir / "ReadMe.md").read_text()
    blocks = re.findall(r"```\n(.*?)```", text, flags=re.S)
    cmds = []
    for block in blocks:
        folded = block.replace("\\\n", " ")
        for line in folded.splitlines():
            line = line.strip()
            if line.startswith("python "):
                cmds.append(line)
    return cmds


def cpu_mesh_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    repo = str(EXAMPLES.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("name", NAMES)
def test_example_runs(tmp_path, name):
    src = EXAMPLES / name
    cmds = readme_commands(src)
    assert cmds, f"{name}/ReadMe.md has no runnable python commands"
    workdir = tmp_path / name
    workdir.mkdir()
    for f in src.iterdir():
        if f.suffix in (".py", ".mtx"):
            (workdir / f.name).write_bytes(f.read_bytes())
    env = cpu_mesh_env()
    for cmd in cmds:
        argv = [sys.executable] + cmd.split()[1:]
        res = subprocess.run(argv, cwd=workdir, env=env,
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, \
            f"{name}: `{cmd}` failed\n{res.stdout}\n{res.stderr}"


def test_premade_matrix_density_is_idempotent(tmp_path):
    """The density matrix a purification example writes must satisfy
    D*S*D = D (in the orthogonalized basis it is a projector)."""
    src = EXAMPLES / "PremadeMatrix"
    workdir = tmp_path / "pm"
    workdir.mkdir()
    for f in src.iterdir():
        if f.suffix == ".py":
            (workdir / f.name).write_bytes(f.read_bytes())
    env = cpu_mesh_env()
    for cmd in readme_commands(src):
        argv = [sys.executable] + cmd.split()[1:]
        res = subprocess.run(argv, cwd=workdir, env=env,
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr
    from scipy.io import mmread
    d = np.asarray(mmread(str(workdir / "Density.mtx")).todense())
    s = np.asarray(mmread(str(workdir / "Overlap.mtx")).todense())
    assert np.linalg.norm(d @ s @ d - d) / np.linalg.norm(d) < 1e-3
    assert abs(np.trace(d @ s) - 10.0) < 1e-3
