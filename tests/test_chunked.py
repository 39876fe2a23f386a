"""Chunked (scan-fused) solver iterations vs the eager reference path.

iters_per_sync > 1 fuses iterations into one compiled lax.scan per host
sync (the dispatch-amortization mode); results must agree with the
per-iteration path to solver tolerance.
"""
import numpy as np
import pytest

import ntpoly_tpu as nt
from ntpoly_tpu.parallel import pmatrix as PM
from ntpoly_tpu.parallel.grid import ProcessGrid
from ntpoly_tpu.solvers import density, inverse, sign, squareroot
from ntpoly_tpu.solvers.parameters import SolverParameters

from conftest import rel_error

DIM, BS = 96, 8


@pytest.fixture
def grid():
    return ProcessGrid(2, 2, 2)


def _system(rng, grid):
    h = rng.random((DIM, DIM))
    h = 0.5 * (h + h.T)
    w, v = np.linalg.eigh(h)
    w[DIM // 2:] += (w[-1] - w[0])
    h = (v * w) @ v.T
    s = rng.random((DIM, DIM))
    s = 0.05 * (s @ s.T) + np.eye(DIM)
    return (PM.from_dense(h, bs=BS, grid=grid),
            PM.from_dense(s, bs=BS, grid=grid), h, s)


def params(ips):
    return SolverParameters(converge_diff=1e-9, threshold=1e-11,
                            iters_per_sync=ips)


def test_cg_chunked_matches_eager(rng, grid):
    from ntpoly_tpu.solvers import linear
    _, sm, _, s = _system(rng, grid)
    b = PM.identity(DIM, bs=BS, dtype=sm.dtype, grid=grid)
    x1 = linear.cg_solver(sm, b, params(1))
    x2 = linear.cg_solver(sm, b, params(5))
    ref = np.linalg.inv(s)
    assert rel_error(np.asarray(PM.to_dense(x1)), ref) < 1e-7
    assert rel_error(np.asarray(PM.to_dense(x2)), ref) < 1e-7


def test_ns_taylor_chunked_matches_eager(rng, grid):
    import scipy.linalg as sla
    _, sm, _, s = _system(rng, grid)
    i1 = squareroot.inverse_square_root(sm, params(1), order=5)
    i2 = squareroot.inverse_square_root(sm, params(5), order=5)
    ref = sla.fractional_matrix_power(s, -0.5).real
    assert rel_error(np.asarray(PM.to_dense(i1)), ref) < 1e-8
    assert rel_error(np.asarray(PM.to_dense(i2)), ref) < 1e-8


@pytest.mark.parametrize("solver", ["trs2", "trs4", "pm", "hpcp"])
def test_purification_chunked_matches_eager(rng, grid, solver):
    hm, _, h, _ = _system(rng, grid)
    isq = PM.identity(DIM, bs=BS, dtype=hm.dtype, grid=grid)
    fn = getattr(density, solver)
    r1, e1, mu1 = fn(hm, isq, float(DIM // 2), params(1))
    r2, e2, mu2 = fn(hm, isq, float(DIM // 2), params(5))
    assert abs(float(e1) - float(e2)) < 1e-6 * abs(float(e1))
    assert rel_error(np.asarray(PM.to_dense(r2)),
                     np.asarray(PM.to_dense(r1))) < 1e-6
    # both chemical potentials must sit in the spectral gap
    w = np.linalg.eigh(h)[0]
    for mu in (mu1, mu2):
        assert w[DIM // 2 - 1] < mu < w[DIM // 2]


def test_hotelling_chunked_matches_eager(rng, grid):
    _, sm, _, s = _system(rng, grid)
    inv1 = inverse.invert(sm, params(1))
    inv2 = inverse.invert(sm, params(5))
    ref = np.linalg.inv(s)
    assert rel_error(np.asarray(PM.to_dense(inv1)), ref) < 1e-8
    assert rel_error(np.asarray(PM.to_dense(inv2)), ref) < 1e-8


def test_isq_chunked_matches_eager(rng, grid):
    import scipy.linalg as sla
    _, sm, _, s = _system(rng, grid)
    i1 = squareroot.inverse_square_root(sm, params(1), order=2)
    i2 = squareroot.inverse_square_root(sm, params(5), order=2)
    ref = sla.fractional_matrix_power(s, -0.5).real
    assert rel_error(np.asarray(PM.to_dense(i1)), ref) < 1e-8
    assert rel_error(np.asarray(PM.to_dense(i2)), ref) < 1e-8


def test_sign_chunked_matches_eager(rng, grid):
    import scipy.linalg as sla
    hm, _, h, _ = _system(rng, grid)
    hm = PM.from_dense(np.asarray(PM.to_dense(hm))
                       - np.eye(DIM) * np.mean(np.linalg.eigh(h)[0]),
                       bs=BS, grid=grid)
    hd = np.asarray(PM.to_dense(hm))
    s1 = sign.sign_function(hm, params(1))
    s2 = sign.sign_function(hm, params(5))
    ref = np.asarray(sla.signm(hd)).real
    assert rel_error(np.asarray(PM.to_dense(s1)), ref) < 1e-7
    assert rel_error(np.asarray(PM.to_dense(s2)), ref) < 1e-7


# ----------------------------------------------------------------------------
# overflow honesty: fill-in beyond the pinned capacity
# mid-solve must be DETECTED — warn, raise, or regrow — never silent.
# ----------------------------------------------------------------------------

def _overflow_system(rng, dim=48):
    """Banded (initially low-capacity) gapped Hamiltonian whose
    purification fill-in exceeds a tiny pinned capacity mid-solve."""
    h = np.zeros((dim, dim))
    i = np.arange(dim)
    h[i, i] = np.where(i % 2 == 0, 1.0, -1.0)   # large stagger: real gap
    for off in (1, 2, 3):
        j = np.arange(dim - off)
        h[j, j + off] = h[j + off, j] = 0.2 / off
    return h


def _run(params, rng, grid):
    from ntpoly_tpu.parallel import pmatrix as PM
    from ntpoly_tpu.solvers import density
    dim = 48
    h = _overflow_system(rng, dim)
    hm = PM.from_dense(h, bs=4, grid=grid, k=2)    # tight capacity
    isq = PM.identity(dim, bs=4, k=1, dtype=hm.dtype, grid=grid)
    return density.trs4(hm, isq, float(dim // 2), params)


def test_chunked_overflow_warns(rng):
    from ntpoly_tpu.parallel.grid import ProcessGrid
    from ntpoly_tpu.solvers.parameters import SolverParameters
    params = SolverParameters(converge_diff=1e-8, threshold=1e-10,
                              iters_per_sync=4, k_out=2,
                              on_overflow="warn")
    with pytest.warns(UserWarning, match="exceeds pinned capacity"):
        _run(params, rng, ProcessGrid(2, 2, 1))


def test_chunked_overflow_raises(rng):
    from ntpoly_tpu.parallel.grid import ProcessGrid
    from ntpoly_tpu.solvers.parameters import SolverParameters
    from ntpoly_tpu.utils.errors import NTPolyError
    params = SolverParameters(converge_diff=1e-8, threshold=1e-10,
                              iters_per_sync=4, k_out=2,
                              on_overflow="raise")
    with pytest.raises(NTPolyError, match="exceeds pinned capacity"):
        _run(params, rng, ProcessGrid(2, 2, 1))


def test_chunked_overflow_grows_to_correct_answer(rng):
    """Default 'grow' redoes the chunk at the needed capacity: the solve
    converges to the correct density despite the absurdly small pin."""
    from ntpoly_tpu.parallel import pmatrix as PM
    from ntpoly_tpu.parallel.grid import ProcessGrid
    from ntpoly_tpu.solvers.parameters import SolverParameters
    from conftest import rel_error
    dim = 48
    h = _overflow_system(rng, dim)
    w, v = np.linalg.eigh(h)
    occ = v[:, :dim // 2]
    rho_ref = occ @ occ.T
    params = SolverParameters(converge_diff=1e-10, threshold=1e-12,
                              iters_per_sync=4, k_out=2,
                              on_overflow="grow")
    rho, energy, mu = _run(params, rng, ProcessGrid(2, 2, 1))
    assert rel_error(np.asarray(PM.to_dense(rho)), rho_ref) < 1e-5
    assert abs(energy - w[:dim // 2].sum()) < 1e-5 * abs(w[:dim // 2].sum())


def test_precision_knob_plumbing(rng):
    """params.precision='high' threads through the solver policy; every
    tier multiplies at FP32 whichever name is set, so both settings must
    agree to f64."""
    from ntpoly_tpu.parallel.grid import ProcessGrid
    from ntpoly_tpu.solvers.parameters import SolverParameters
    grid = ProcessGrid(2, 2, 1)
    hm, _, h, _ = _system(rng, grid)
    isq = PM.identity(DIM, bs=BS, dtype=hm.dtype, grid=grid)
    p_hi = SolverParameters(converge_diff=1e-9, threshold=1e-11,
                            iters_per_sync=4)
    p_fast = SolverParameters(converge_diff=1e-9, threshold=1e-11,
                              iters_per_sync=4, precision="high")
    r1, e1, _ = density.trs4(hm, isq, float(DIM // 2), p_hi)
    r2, e2, _ = density.trs4(hm, isq, float(DIM // 2), p_fast)
    assert abs(float(e1) - float(e2)) < 1e-8 * abs(float(e1))


@pytest.mark.parametrize("solver", ["trs2", "trs4", "pm", "hpcp"])
@pytest.mark.parametrize("ips", [1, 5])
def test_idempotency_metric_converges(rng, grid, solver, ips):
    """the noise-robust idempotency convergence
    functional lands on the same density as the energy-diff monitor, in
    both eager and chunked modes."""
    hm, _, h, _ = _system(rng, grid)
    isq = PM.identity(DIM, bs=BS, dtype=hm.dtype, grid=grid)
    fn = getattr(density, solver)
    p_e = params(ips)
    p_i = params(ips)
    p_i.convergence_metric = "idempotency"
    r_e, e_e, _ = fn(hm, isq, float(DIM // 2), p_e)
    r_i, e_i, _ = fn(hm, isq, float(DIM // 2), p_i)
    assert abs(float(e_e) - float(e_i)) < 1e-6 * abs(float(e_e))
    assert rel_error(np.asarray(PM.to_dense(r_i)),
                     np.asarray(PM.to_dense(r_e))) < 1e-6
    # the density really is idempotent at convergence
    d = np.asarray(PM.to_dense(r_i))
    assert np.linalg.norm(d @ d - d) / np.linalg.norm(d) < 1e-5


@pytest.mark.parametrize("ips", [1, 5])
def test_compensated_scalars_solve(rng, grid, ips):
    """compensated (two-float) monitor scalars give
    the same converged result, with the energy combined in float64."""
    hm, _, h, _ = _system(rng, grid)
    isq = PM.identity(DIM, bs=BS, dtype=hm.dtype, grid=grid)
    p_c = params(ips)
    p_c.compensated_scalars = True
    r_c, e_c, mu_c = density.trs4(hm, isq, float(DIM // 2), p_c)
    r_p, e_p, _ = density.trs4(hm, isq, float(DIM // 2), params(ips))
    assert abs(float(e_c) - float(e_p)) < 1e-6 * abs(float(e_p))
    assert rel_error(np.asarray(PM.to_dense(r_c)),
                     np.asarray(PM.to_dense(r_p))) < 1e-8
    w = np.linalg.eigh(h)[0]
    assert abs(float(e_c) - w[:DIM // 2].sum()) < 1e-6 * abs(e_c)
