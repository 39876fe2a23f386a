"""Production-dtype (f32, x64 off) correctness coverage.

The full suite validates f64; the GPU path's dtype is f32 with HIGHEST
matmul precision.  This runs ISQ + TRS4 end-to-end in a subprocess with
x64 disabled and asserts the reference's oracle tolerance (1e-4,
reference UnitTests/helpers.py:13) holds on the f32 path.
"""
import os
import subprocess
import sys
from pathlib import Path

SCRIPT = r"""
import numpy as np
import jax
assert not jax.config.jax_enable_x64
import scipy.linalg as sla
from scipy.io import mmwrite
from scipy.sparse import csr_matrix
import ntpoly_tpu as nt

rng = np.random.default_rng(11)
DIM, NEL = 16, 5
h = rng.random((DIM, DIM)); h = 0.5 * (h + h.T)
w, v = np.linalg.eigh(h); w[NEL:] += (w[-1] - w[0])
h = (v * w) @ v.T
s = rng.random((DIM, DIM)); s = 0.1 * (s @ s.T) + np.eye(DIM)

isq_ref = np.asarray(sla.funm(s, lambda x: 1 / np.sqrt(x)))
worth = isq_ref @ h @ isq_ref
ww, vv = np.linalg.eigh(worth)
occ = vv[:, :NEL]
density_ref = isq_ref @ (occ @ occ.T) @ isq_ref

nt.ConstructGlobalProcessGrid(2, 2, 2)
import tempfile, os
d = tempfile.mkdtemp()
mmwrite(os.path.join(d, "h.mtx"), csr_matrix(h))
mmwrite(os.path.join(d, "s.mtx"), csr_matrix(s))
fock = nt.Matrix_ps(os.path.join(d, "h.mtx"))
overlap = nt.Matrix_ps(os.path.join(d, "s.mtx"))
assert fock._m.dtype == np.float32, fock._m.dtype

sp = nt.SolverParameters()
sp.SetConvergeDiff(1e-6)
isq = nt.Matrix_ps(DIM)
nt.SquareRootSolvers.InverseSquareRoot(overlap, isq, sp)
density = nt.Matrix_ps(DIM)
energy, mu = nt.DensityMatrixSolvers.TRS4(fock, isq, NEL, density, sp)

isq.WriteToMatrixMarket(os.path.join(d, "isq.mtx"))
density.WriteToMatrixMarket(os.path.join(d, "rho.mtx"))
from scipy.io import mmread
got_isq = np.asarray(mmread(os.path.join(d, "isq.mtx")).todense())
got_rho = np.asarray(mmread(os.path.join(d, "rho.mtx")).todense())

def rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)

assert rel(got_isq, isq_ref) <= 1e-4, rel(got_isq, isq_ref)
assert rel(got_rho, density_ref) <= 1e-4, rel(got_rho, density_ref)
assert abs(energy - ww[:NEL].sum()) <= 1e-3 * abs(ww[:NEL].sum())
print("F32-OK")
"""


def test_trs4_isq_f32_meets_oracle_tolerance():
    env = dict(os.environ)
    env["NTPOLY_TEST_F32"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "0"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    repo = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    assert "F32-OK" in res.stdout
