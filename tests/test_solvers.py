"""Solver tests vs scipy oracle
(reference UnitTests/test_solvers.py, 1213 LoC / 38 tests).

Pattern matches the reference: build a small random matrix with controlled
properties, compute the reference result with scipy, run the solver through
the NTPoly-compatible surface, compare relative Frobenius error <= 1e-4.
"""
import numpy as np
import pytest
import scipy.linalg as sla
from scipy.io import mmread, mmwrite
from scipy.sparse import csr_matrix

import ntpoly_tpu as nt
from conftest import (THRESHOLD, grid_shape_from_env, rel_error,
                      solver_grid_sweep)

DIM = 23


@pytest.fixture(scope="module", autouse=True, params=solver_grid_sweep(),
                ids=lambda s: "x".join(map(str, s)))
def grid(request):
    """Solver suite swept over grid shapes incl. slices>1, mirroring the
    reference's Regression111..611 ctest matrix
    (reference UnitTests/CMakeLists.txt:42-52)."""
    nt.ConstructGlobalProcessGrid(*request.param)
    yield
    nt.DestructGlobalProcessGrid()


@pytest.fixture(autouse=True)
def yaml_log(tmp_path):
    """Activate the YAML logger and re-parse its output after every test —
    malformed log output is a failure (reference UnitTests/test_solvers.py
    :58-70 does this in every tearDown)."""
    import yaml
    log_file = tmp_path / "log.yaml"
    nt.ActivateLogger(str(log_file))
    yield
    nt.DeactivateLogger()
    if log_file.exists() and log_file.stat().st_size:
        with open(log_file) as f:
            assert yaml.safe_load(f) is not None


@pytest.fixture
def isp():
    p = nt.SolverParameters()
    p.SetConvergeDiff(1e-8)
    p.SetMonitorConvergence(False)
    p.SetVerbosity(True)
    return p


def create_matrix(rng, SPD=False, scaled=False, diag_dom=False, rank=None,
                  add_gap=False, dim=DIM):
    m = rng.random((dim, dim))
    m = m + m.T
    if SPD:
        m = m.T @ m
    if diag_dom:
        m = m + dim * np.eye(dim)
    if scaled:
        m = m / dim
    if rank:
        m = m[rank:].T @ m[rank:]
    if add_gap:
        w, v = np.linalg.eigh(m)
        gap = (w[-1] - w[0]) / 2.0
        w[dim // 2:] += gap
        m = v @ np.diag(w) @ v.T
    return m


def to_nt(tmp_path, m, name="in"):
    path = tmp_path / f"{name}.mtx"
    mmwrite(str(path), csr_matrix(m))
    return nt.Matrix_ps(str(path))


def from_nt(tmp_path, a, name="res"):
    path = tmp_path / f"{name}.mtx"
    a.WriteToMatrixMarket(str(path))
    return np.asarray(mmread(str(path)).todense())


def check(tmp_path, out_mat, reference):
    assert rel_error(from_nt(tmp_path, out_mat), reference) <= THRESHOLD


# ----------------------------------------------------------------------------
# inverses / roots
# ----------------------------------------------------------------------------

def test_invert(tmp_path, rng, isp):
    m = create_matrix(rng, SPD=True, diag_dom=True)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    nt.InverseSolvers.Invert(a, out, isp)
    check(tmp_path, out, np.linalg.inv(m))


def test_dense_invert(tmp_path, rng, isp):
    m = create_matrix(rng, SPD=True, diag_dom=True)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    nt.InverseSolvers.DenseInvert(a, out, isp)
    check(tmp_path, out, np.linalg.inv(m))


def test_pseudo_inverse(tmp_path, rng, isp):
    # The reference's rank-parameter builds a smaller full-rank Gram matrix
    # (reference test_solvers.py create_matrix: mat[rank:] mat[rank:].T).
    m = create_matrix(rng)
    m = m[DIM // 2:] @ m[DIM // 2:].T
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(m.shape[0])
    nt.InverseSolvers.PseudoInverse(a, out, isp)
    check(tmp_path, out, np.linalg.pinv(m))


@pytest.mark.parametrize("inverse", [False, True], ids=["sqrt", "isqrt"])
@pytest.mark.parametrize("order", [2, 5])
def test_square_root(tmp_path, rng, isp, inverse, order):
    m = create_matrix(rng, SPD=True, diag_dom=True)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    if inverse:
        nt.SquareRootSolvers.InverseSquareRoot(a, out, isp, order)
        ref = sla.fractional_matrix_power(m, -0.5).real
    else:
        nt.SquareRootSolvers.SquareRoot(a, out, isp, order)
        ref = sla.sqrtm(m).real
    check(tmp_path, out, ref)


def test_dense_square_roots(tmp_path, rng, isp):
    m = create_matrix(rng, SPD=True, diag_dom=True)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    nt.SquareRootSolvers.DenseSquareRoot(a, out, isp)
    check(tmp_path, out, sla.sqrtm(m).real)
    nt.SquareRootSolvers.DenseInverseSquareRoot(a, out, isp)
    check(tmp_path, out, sla.fractional_matrix_power(m, -0.5).real)


@pytest.mark.parametrize("root", [1, 2, 3, 4, 5, 6, 7, 8])
def test_root(tmp_path, rng, isp, root):
    m = create_matrix(rng, diag_dom=True)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    nt.RootSolvers.ComputeRoot(a, out, root, isp)
    check(tmp_path, out, sla.fractional_matrix_power(m, 1.0 / root).real)


@pytest.mark.parametrize("root", [1, 2, 3, 4, 5, 6])
def test_inverse_root(tmp_path, rng, isp, root):
    m = create_matrix(rng, diag_dom=True)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    nt.RootSolvers.ComputeInverseRoot(a, out, root, isp)
    check(tmp_path, out, sla.fractional_matrix_power(m, -1.0 / root).real)


# ----------------------------------------------------------------------------
# sign / polar
# ----------------------------------------------------------------------------

def test_sign_function(tmp_path, rng, isp):
    m = create_matrix(rng)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    nt.SignSolvers.ComputeSign(a, out, isp)
    check(tmp_path, out, np.real(sla.signm(m)))


def test_dense_sign_function(tmp_path, rng, isp):
    m = create_matrix(rng)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    nt.SignSolvers.ComputeDenseSign(a, out, isp)
    check(tmp_path, out, np.real(sla.signm(m)))


def test_polar_decomposition(tmp_path, rng, isp):
    m = create_matrix(rng)
    a = to_nt(tmp_path, m)
    u_mat, h_mat = nt.Matrix_ps(DIM), nt.Matrix_ps(DIM)
    nt.SignSolvers.ComputePolarDecomposition(a, u_mat, h_mat, isp)
    u_ref, h_ref = sla.polar(m)
    check(tmp_path, h_mat, h_ref)
    check(tmp_path, u_mat, u_ref)


# ----------------------------------------------------------------------------
# exponentials / logarithms / trig
# ----------------------------------------------------------------------------

def test_exponential(tmp_path, rng, isp):
    m = create_matrix(rng, scaled=True)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    nt.ExponentialSolvers.ComputeExponential(a, out, isp)
    check(tmp_path, out, sla.expm(m))


def test_exponential_pade(tmp_path, rng, isp):
    m = create_matrix(rng, scaled=True)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    nt.ExponentialSolvers.ComputeExponentialPade(a, out, isp)
    check(tmp_path, out, sla.expm(m))


def test_dense_exponential(tmp_path, rng, isp):
    m = create_matrix(rng, scaled=True)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    nt.ExponentialSolvers.ComputeDenseExponential(a, out, isp)
    check(tmp_path, out, sla.expm(m))


def test_logarithm(tmp_path, rng, isp):
    m = create_matrix(rng, SPD=True, diag_dom=True, scaled=True)
    m = m + np.eye(DIM)        # keep spectrum well inside log's domain
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    nt.ExponentialSolvers.ComputeLogarithm(a, out, isp)
    check(tmp_path, out, np.real(sla.logm(m)))


def test_dense_logarithm(tmp_path, rng, isp):
    m = create_matrix(rng, SPD=True, diag_dom=True, scaled=True)
    m = m + np.eye(DIM)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    nt.ExponentialSolvers.ComputeDenseLogarithm(a, out, isp)
    check(tmp_path, out, np.real(sla.logm(m)))


def test_exponential_round_trip(tmp_path, rng, isp):
    """exp then log recovers the input (reference test_exponentialround)."""
    m = create_matrix(rng, scaled=True)
    m = 0.25 * m + np.eye(DIM)
    a = to_nt(tmp_path, m)
    mid, out = nt.Matrix_ps(DIM), nt.Matrix_ps(DIM)
    nt.ExponentialSolvers.ComputeExponential(a, mid, isp)
    nt.ExponentialSolvers.ComputeLogarithm(mid, out, isp)
    check(tmp_path, out, m)


@pytest.mark.parametrize("fn", ["sin", "cos"])
def test_trigonometry(tmp_path, rng, isp, fn):
    m = create_matrix(rng)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    if fn == "sin":
        nt.TrigonometrySolvers.Sine(a, out, isp)
        ref = np.real(sla.sinm(m))
    else:
        nt.TrigonometrySolvers.Cosine(a, out, isp)
        ref = np.real(sla.cosm(m))
    check(tmp_path, out, ref)


def test_trigonometry_taylor(tmp_path, rng, isp):
    """Taylor-series cosine (reference ScaleSquareTrigonometryTaylor,
    TrigonometrySolversModule.F90:157-262)."""
    m = create_matrix(rng)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    nt.TrigonometrySolvers.ScaleSquareTrigonometryTaylor(a, out, isp)
    check(tmp_path, out, np.real(sla.cosm(m)))


@pytest.mark.parametrize("fn", ["sin", "cos"])
def test_dense_trigonometry(tmp_path, rng, isp, fn):
    m = create_matrix(rng)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    if fn == "sin":
        nt.TrigonometrySolvers.DenseSine(a, out, isp)
        ref = np.real(sla.sinm(m))
    else:
        nt.TrigonometrySolvers.DenseCosine(a, out, isp)
        ref = np.real(sla.cosm(m))
    check(tmp_path, out, ref)


# ----------------------------------------------------------------------------
# polynomials
# ----------------------------------------------------------------------------

def test_horner(tmp_path, rng, isp):
    from numpy.polynomial.polynomial import polyval
    m = create_matrix(rng, scaled=True)
    coef = [1.0, -0.5, 0.25, -0.125, 0.0625]
    poly = nt.Polynomial(len(coef))
    for i, c in enumerate(coef):
        poly.SetCoefficient(i, c)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    poly.HornerCompute(a, out, isp)
    w, v = np.linalg.eigh(m)
    check(tmp_path, out, v @ np.diag(polyval(w, coef)) @ v.T)


def test_paterson_stockmeyer(tmp_path, rng, isp):
    from numpy.polynomial.polynomial import polyval
    m = create_matrix(rng, scaled=True)
    coef = [0.5, 0.25, 0.125, -0.06, 0.03, -0.015, 0.0075, 0.003, 0.001]
    poly = nt.Polynomial(len(coef))
    for i, c in enumerate(coef):
        poly.SetCoefficient(i, c)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    poly.PatersonStockmeyerCompute(a, out, isp)
    w, v = np.linalg.eigh(m)
    check(tmp_path, out, v @ np.diag(polyval(w, coef)) @ v.T)


@pytest.mark.parametrize("factorized", [False, True], ids=["std", "fact"])
def test_chebyshev(tmp_path, rng, isp, factorized):
    from numpy.polynomial.chebyshev import chebval
    m = create_matrix(rng, scaled=True)
    m = m / np.abs(np.linalg.eigvalsh(m)).max() * 0.9
    coef = [1.0, 0.5, 0.25, 0.125, 0.0625, 0.03, 0.015, 0.0075]
    poly = nt.ChebyshevPolynomial(len(coef))
    for i, c in enumerate(coef):
        poly.SetCoefficient(i, c)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    if factorized:
        poly.ComputeFactorized(a, out, isp)
    else:
        poly.Compute(a, out, isp)
    w, v = np.linalg.eigh(m)
    check(tmp_path, out, v @ np.diag(chebval(w, coef)) @ v.T)


def test_hermite(tmp_path, rng, isp):
    from numpy.polynomial.hermite import hermval
    m = create_matrix(rng, scaled=True)
    coef = [1.0, 0.5, 0.25, 0.125]
    poly = nt.HermitePolynomial(len(coef))
    for i, c in enumerate(coef):
        poly.SetCoefficient(i, c)
    a = to_nt(tmp_path, m)
    out = nt.Matrix_ps(DIM)
    poly.Compute(a, out, isp)
    w, v = np.linalg.eigh(m)
    check(tmp_path, out, v @ np.diag(hermval(w, coef)) @ v.T)


# ----------------------------------------------------------------------------
# linear solvers / eigensolvers
# ----------------------------------------------------------------------------

def test_cg_solve(tmp_path, rng, isp):
    amat = create_matrix(rng, SPD=True, diag_dom=True)
    bmat = create_matrix(rng)
    a = to_nt(tmp_path, amat, "a")
    b = to_nt(tmp_path, bmat, "b")
    x = nt.Matrix_ps(DIM)
    nt.LinearSolvers.CGSolver(a, x, b, isp)
    check(tmp_path, x, np.linalg.solve(amat, bmat))


def test_cholesky(tmp_path, rng, isp):
    m = create_matrix(rng, SPD=True, diag_dom=True)
    a = to_nt(tmp_path, m)
    ell = nt.Matrix_ps(DIM)
    nt.LinearSolvers.CholeskyDecomposition(a, ell, isp)
    check(tmp_path, ell, np.linalg.cholesky(m))


def test_pivoted_cholesky(tmp_path, rng, isp):
    rank = 5
    m = create_matrix(rng, rank=DIM - rank)   # rank-5 PSD
    a = to_nt(tmp_path, m)
    ell = nt.Matrix_ps(DIM)
    nt.Analysis.PivotedCholeskyDecomposition(a, ell, rank, isp)
    ld = from_nt(tmp_path, ell)
    assert rel_error(ld @ ld.T, m) <= THRESHOLD


def test_power_bounds(tmp_path, rng, isp):
    m = create_matrix(rng)
    a = to_nt(tmp_path, m)
    max_value = nt.EigenBounds.PowerBounds(a, isp)
    w = np.linalg.eigvalsh(m)
    assert abs(max_value - np.abs(w).max()) <= THRESHOLD * np.abs(w).max()


def test_eigen_decomposition(tmp_path, rng, isp):
    m = create_matrix(rng)
    a = to_nt(tmp_path, m)
    vals, vecs = nt.Matrix_ps(DIM), nt.Matrix_ps(DIM)
    nt.EigenSolvers.EigenDecomposition(a, vals, DIM, vecs, isp)
    w = np.linalg.eigvalsh(m)
    check(tmp_path, vals, np.diag(w))
    # vecs reconstruct the matrix
    vd = from_nt(tmp_path, vecs, "vecs")
    assert rel_error(vd @ np.diag(w) @ vd.T, m) <= THRESHOLD


def test_eigen_decomposition_partial(tmp_path, rng, isp):
    nvals = 5
    m = create_matrix(rng)
    a = to_nt(tmp_path, m)
    vals, vecs = nt.Matrix_ps(DIM), nt.Matrix_ps(DIM)
    nt.EigenSolvers.EigenDecomposition(a, vals, nvals, vecs, isp)
    w = np.linalg.eigvalsh(m)
    ref = np.zeros((DIM, DIM))
    ref[:nvals, :nvals] = np.diag(w[:nvals])
    check(tmp_path, vals, ref)


def test_eigen_decomposition_iterative(tmp_path, rng, isp):
    """Matrix-free LOBPCG path: lowest-nvals pairs without densifying."""
    nvals = 4
    m = create_matrix(rng, dim=64)
    a = to_nt(tmp_path, m)
    w, v = nt.EigenSolvers.IterativeEigenDecomposition(a, nvals, isp)
    w_ref = np.linalg.eigvalsh(m)[:nvals]
    assert rel_error(w, w_ref) <= THRESHOLD
    # residual check: A v ~= v diag(w)
    res = np.linalg.norm(m @ v - v * w[None, :]) / np.linalg.norm(m)
    assert res <= 10 * THRESHOLD


def test_eigen_values(tmp_path, rng, isp):
    m = create_matrix(rng)
    a = to_nt(tmp_path, m)
    vals = nt.Matrix_ps(DIM)
    nt.EigenSolvers.EigenValues(a, vals, DIM, isp)
    check(tmp_path, vals, np.diag(np.linalg.eigvalsh(m)))


def test_svd(tmp_path, rng, isp):
    m = create_matrix(rng)
    a = to_nt(tmp_path, m)
    left, right, vals = (nt.Matrix_ps(DIM) for _ in range(3))
    nt.EigenSolvers.SingularValueDecomposition(a, left, right, vals, isp)
    s = np.linalg.svd(m, compute_uv=False)
    check(tmp_path, vals, np.diag(sorted(s)))
    ld = from_nt(tmp_path, left, "l")
    rd = from_nt(tmp_path, right, "r")
    vd = from_nt(tmp_path, vals, "v")
    assert rel_error(ld @ vd @ rd.T, m) <= THRESHOLD


def test_estimate_gap(tmp_path, rng, isp):
    m = create_matrix(rng, add_gap=True, scaled=True)
    a = to_nt(tmp_path, m)
    isq = nt.Matrix_ps(DIM)
    isq.FillIdentity()
    k = nt.Matrix_ps(DIM)
    nel = DIM // 2
    _, cp = nt.DensityMatrixSolvers.TRS4(a, isq, nel, k, isp)
    gap = nt.EigenSolvers.EstimateGap(a, k, cp, isp)
    assert gap > 0        # reference checks only plausibility of the gap


def test_reduce_dimension(tmp_path, rng, isp):
    m = create_matrix(rng, add_gap=True)
    a = to_nt(tmp_path, m)
    small_dim = DIM // 2
    red = nt.Matrix_ps(DIM)
    nt.Analysis.ReduceDimension(a, small_dim, red, isp)
    rd = from_nt(tmp_path, red)[:small_dim, :small_dim]
    w_red = np.linalg.eigvalsh(rd)
    w = np.linalg.eigvalsh(m)
    assert rel_error(np.sort(w_red), np.sort(w[:small_dim])) <= 1e-2


def test_raise_on_nonconvergence(tmp_path, rng, isp):
    """opt-in ConvergenceError at max_iterations."""
    from ntpoly_tpu.utils.errors import ConvergenceError
    dim = 16
    h = rng.random((dim, dim))
    h = h @ h.T + np.eye(dim)          # SPD but iterations capped
    mmwrite(str(tmp_path / "h.mtx"), csr_matrix(h))
    H = nt.Matrix_ps(str(tmp_path / "h.mtx"))
    Inv = nt.Matrix_ps(dim)
    params = nt.SolverParameters()
    params.SetMaxIterations(2)
    params._p.raise_on_nonconvergence = True
    with pytest.raises(ConvergenceError) as ei:
        nt.InverseSolvers.Invert(H, Inv, params)
    assert ei.value.iterations >= 1   # 0/1-based varies


def test_iteration_trace_length_matches_total(tmp_path, rng, isp):
    """the converged iteration must be logged — the
    per-iteration Energy Value entries equal Total Iterations."""
    import yaml
    dim = 16
    h = rng.random((dim, dim))
    h = 0.5 * (h + h.T)
    w, v = np.linalg.eigh(h)
    w[dim // 2:] += (w[-1] - w[0]) + 1.0
    mmwrite(str(tmp_path / "h.mtx"), csr_matrix((v * w) @ v.T))
    H = nt.Matrix_ps(str(tmp_path / "h.mtx"))
    ISQ = nt.Matrix_ps(dim)
    ISQ.FillIdentity()
    K = nt.Matrix_ps(dim)
    params = nt.SolverParameters()
    params.SetThreshold(1e-12)
    params.SetVerbosity(True)
    log = tmp_path / "iters.yaml"
    nt.ActivateLogger(str(log))
    nt.DensityMatrixSolvers.TRS2(H, ISQ, dim // 2, K, params)
    nt.DeactivateLogger()
    docs = yaml.safe_load(log.read_text())
    blk = docs["Density Matrix Solver"]
    n_energy = sum(1 for item in blk["Iterations"]
                   if isinstance(item, dict) and "Energy Value" in item)
    assert n_energy == blk["Total Iterations"]


def test_cholesky_scales_without_densify(rng, monkeypatch):
    """the Cholesky family must exist at the
    library's target dimension — no N^2 dense materialization anywhere.
    A banded SPD system is factorized with gather-to-dense forcibly
    broken, and the factor is verified by its residual NORM computed
    sparsely (L L^H - A in the distributed format)."""
    from ntpoly_tpu.parallel import pmatrix as PM, algebra as alg
    from ntpoly_tpu.parallel.grid import ProcessGrid
    from ntpoly_tpu.solvers import linear, analysis
    from ntpoly_tpu.solvers.parameters import SolverParameters

    def forbidden(*a, **k):
        raise AssertionError("to_dense called — N^2 materialization")

    monkeypatch.setattr(PM, "to_dense", forbidden)
    grid = ProcessGrid(*grid_shape_from_env())
    dim = 1024
    import jax.numpy as jnp
    m = PM.banded(dim, 12,
                  lambda i, j: jnp.where(i == j, 4.0,
                                         0.5 / (1.0 + jnp.abs(i - j))),
                  bs=16, grid=grid)
    params = SolverParameters(threshold=1e-14)
    ell = linear.cholesky_decomposition(m, params)
    resid = alg.matmul(ell, alg.transpose(ell).conjugate(), alpha=-1.0,
                       beta=1.0, c=m)
    assert float(alg.norm(resid)) <= 1e-6 * float(alg.norm(m))
    # pivoted, rank-limited, same no-densify guarantee
    rank = 64
    lr = analysis.pivoted_cholesky_decomposition(m, rank, params)
    # rank-64 approximation of a banded SPD matrix won't be exact; the
    # residual must stay PSD-consistent (diagonal >= -tol) and its trace
    # must have dropped by the 64 pivots' worth (pivoted Cholesky greedily
    # removes the largest remaining diagonal each step)
    resid2 = alg.matmul(lr, alg.transpose(lr).conjugate(), alpha=-1.0,
                        beta=1.0, c=m)
    t_m = float(np.real(np.asarray(alg.trace(m))))
    t_r = float(np.real(np.asarray(alg.trace(resid2))))
    assert t_r <= t_m * (1.0 - rank / dim) + 1e-8
    assert t_r >= -1e-8
    r, c, v = PM.to_triplets(lr)
    assert c.max(initial=0) < rank
