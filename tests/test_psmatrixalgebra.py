"""Distributed algebra tests (reference UnitTests/test_psmatrixalgebra.py):
add/multiply/dot/pairwise across real/complex/mixed operands and grid
shapes, plus permutation-based load balancing.
"""
import numpy as np
import pytest
from scipy.io import mmread, mmwrite
from scipy.sparse import csr_matrix

import ntpoly_tpu as nt
from conftest import rel_error

GRID_SHAPES = [(1, 1, 1), (2, 2, 1), (2, 1, 2), (2, 2, 2)]


@pytest.fixture(params=GRID_SHAPES, ids=lambda g: "x".join(map(str, g)))
def grid(request):
    nt.ConstructGlobalProcessGrid(*request.param)
    yield request.param
    nt.DestructGlobalProcessGrid()


def make(rng, dim=15, is_complex=False, density=0.5):
    m = rng.random((dim, dim)) * (rng.random((dim, dim)) < density)
    if is_complex:
        m = m + 1j * (rng.random((dim, dim)) * (m != 0))
    return m


def to_nt(tmp_path, m, name):
    path = tmp_path / f"{name}.mtx"
    mmwrite(str(path), csr_matrix(m))
    return nt.Matrix_ps(str(path))


def from_nt(tmp_path, a, name="res"):
    path = tmp_path / f"{name}.mtx"
    a.WriteToMatrixMarket(str(path))
    return np.asarray(mmread(str(path)).todense())


CASES = [(False, False), (True, True), (False, True), (True, False)]


@pytest.mark.parametrize("ca,cb", CASES, ids=["rr", "cc", "rc", "cr"])
def test_increment(tmp_path, rng, grid, ca, cb):
    a, b = make(rng, is_complex=ca), make(rng, is_complex=cb)
    ma, mb = to_nt(tmp_path, a, "a"), to_nt(tmp_path, b, "b")
    mb.Increment(ma, 1.5)
    assert rel_error(from_nt(tmp_path, mb), b + 1.5 * a) < 1e-14


@pytest.mark.parametrize("ca,cb", CASES, ids=["rr", "cc", "rc", "cr"])
def test_gemm(tmp_path, rng, grid, ca, cb):
    a, b = make(rng, is_complex=ca), make(rng, is_complex=cb)
    ma, mb = to_nt(tmp_path, a, "a"), to_nt(tmp_path, b, "b")
    mc = nt.Matrix_ps(ma.GetActualDimension())
    pool = nt.PMatrixMemoryPool(ma)
    mc.Gemm(ma, mb, pool)
    assert rel_error(from_nt(tmp_path, mc), a @ b) < 1e-13


def test_gemm_alpha_beta(tmp_path, rng, grid):
    a, b, c = make(rng), make(rng), make(rng)
    ma, mb = to_nt(tmp_path, a, "a"), to_nt(tmp_path, b, "b")
    mc = to_nt(tmp_path, c, "c")
    mc.Gemm(ma, mb, nt.PMatrixMemoryPool(ma), alpha=2.0, beta=0.5)
    assert rel_error(from_nt(tmp_path, mc), 2.0 * a @ b + 0.5 * c) < 1e-13


@pytest.mark.parametrize("cc", [False, True], ids=["r", "c"])
def test_dot(tmp_path, rng, grid, cc):
    a, b = make(rng, is_complex=cc), make(rng, is_complex=cc)
    ma, mb = to_nt(tmp_path, a, "a"), to_nt(tmp_path, b, "b")
    if cc:
        got = ma.Dot_c(mb)
        ref = np.sum(np.conj(a) * b)
    else:
        got = ma.Dot(mb)
        ref = np.sum(a * b)
    assert abs(got - ref) < 1e-12


def test_pairwise(tmp_path, rng, grid):
    a, b = make(rng), make(rng)
    ma, mb = to_nt(tmp_path, a, "a"), to_nt(tmp_path, b, "b")
    mc = nt.Matrix_ps(ma.GetActualDimension())
    mc.PairwiseMultiply(ma, mb)
    assert rel_error(from_nt(tmp_path, mc), a * b) < 1e-14


def test_scale_norm_trace(tmp_path, rng, grid):
    a = make(rng)
    ma = to_nt(tmp_path, a, "a")
    ma.Scale(3.0)
    assert rel_error(from_nt(tmp_path, ma), 3 * a) < 1e-14
    assert abs(ma.Norm() - np.abs(3 * a).sum(axis=0).max()) < 1e-12
    assert abs(ma.Trace() - np.trace(3 * a)) < 1e-12


def test_diagonal_scale(tmp_path, rng, grid):
    a = make(rng, dim=11)
    ma = to_nt(tmp_path, a, "a")
    d = rng.random(11)
    tl = nt.TripletList_r(0)
    for i, v in enumerate(d):
        tl.Append(nt.Triplet_r(i + 1, i + 1, v))
    ma.DiagonalScale(tl)
    assert rel_error(from_nt(tmp_path, ma), a * d[None, :]) < 1e-14


def test_gemm_load_balanced(tmp_path, rng, grid):
    """Multiply with a random load-balancing permutation applied through a
    solver parameter round-trip (PermuteMatrix o UndoPermuteMatrix = id)."""
    from ntpoly_tpu.utils.permutation import (permute_matrix,
                                              undo_permute_matrix)
    a = make(rng)
    ma = to_nt(tmp_path, a, "a")
    perm = nt.Permutation(ma.GetLogicalDimension())
    perm.SetRandomPermutation()
    balanced = permute_matrix(ma._m, perm)
    restored = undo_permute_matrix(balanced, perm)
    ma._m = restored
    assert rel_error(from_nt(tmp_path, ma), a) < 1e-14


def test_gemm_threshold(tmp_path, rng, grid):
    a = make(rng) * 0.1
    ma = to_nt(tmp_path, a, "a")
    mc = nt.Matrix_ps(ma.GetActualDimension())
    mc.Gemm(ma, ma, nt.PMatrixMemoryPool(ma), threshold=0.01)
    got = from_nt(tmp_path, mc)
    ref = a @ a
    kept = np.abs(got) > 0
    assert np.all(np.abs(ref[~kept]) <= 0.01 + 1e-12)
    assert np.allclose(got[kept], ref[kept])


# ----------------------------------------------------------------------------
# capacity auto-grow and method dispatch (round-2 additions; the reference
# grows its memory pool instead of dropping entries,
# Source/Fortran/sparse_includes/GemmMatrix.f90:48-56)
# ----------------------------------------------------------------------------

def test_matmul_auto_grows_capacity(rng):
    """C = A@B whose fill-in exceeds max(a.k, b.k): no hand-passed k_out,
    no dropped above-threshold mass."""
    import jax.numpy as jnp
    from ntpoly_tpu.parallel import algebra as alg, pmatrix as PM
    from ntpoly_tpu.parallel.grid import ProcessGrid
    grid = ProcessGrid(2, 2, 1)
    dim, bs = 32, 4
    # tridiagonal block band: X@X has a 5-wide band (fill-in 5 > k=3)
    d = np.zeros((dim, dim))
    for off in (-4, 0, 4):
        d += np.diag(rng.random(dim - abs(off)) + 1.0, off)
    m = PM.from_dense(d, bs=bs, grid=grid, k=1)
    assert m.k == 3
    # without growth, the 4-per-panel fill-in would be truncated to 3
    c = alg.matmul(m, m)
    assert c.k > m.k
    assert rel_error(np.asarray(PM.to_dense(c)), d @ d) < 1e-13


def test_increment_auto_grows_capacity(rng):
    from ntpoly_tpu.parallel import algebra as alg, pmatrix as PM
    from ntpoly_tpu.parallel.grid import ProcessGrid
    grid = ProcessGrid(2, 2, 1)
    dim, bs = 32, 4
    a = np.diag(rng.random(dim))                       # k = 1
    b = np.zeros((dim, dim))
    b[:, :8] = rng.random((dim, 8))                    # k = 2, disjoint cols
    ma = PM.from_dense(a, bs=bs, grid=grid)
    mb = PM.from_dense(b, bs=bs, grid=grid)
    c = alg.increment(ma, mb)
    assert rel_error(np.asarray(PM.to_dense(c)), a + b) < 1e-14


def test_transpose_auto_grows_capacity(rng):
    from ntpoly_tpu.parallel import algebra as alg, pmatrix as PM
    from ntpoly_tpu.parallel.grid import ProcessGrid
    grid = ProcessGrid(2, 2, 1)
    dim, bs = 32, 4
    d = np.zeros((dim, dim))
    d[:, :4] = rng.random((dim, 4))                    # dense block-col
    m = PM.from_dense(d, bs=bs, grid=grid)
    t = alg.transpose(m)
    assert rel_error(np.asarray(PM.to_dense(t)), d.T) < 1e-14


@pytest.mark.parametrize("method", ["acc", "cand", "dense", "triton"])
def test_matmul_methods_agree(rng, method):
    from ntpoly_tpu.parallel import algebra as alg, pmatrix as PM
    from ntpoly_tpu.parallel.grid import ProcessGrid
    grid = ProcessGrid(2, 2, 1)
    dim, bs = 32, 8
    d = rng.random((dim, dim)) * (rng.random((dim, dim)) < 0.4)
    m = PM.from_dense(d.astype(np.float32), bs=bs, grid=grid)
    c = alg.matmul(m, m, threshold=1e-6, method=method)
    assert rel_error(np.asarray(PM.to_dense(c)), d @ d) < 1e-5


def test_dense_method_auto_selected(rng):
    """Dense-ish operands on a small matrix pick the dense branch
    (reference GemmMatrix.f90:58-61)."""
    from ntpoly_tpu.parallel import algebra as alg, pmatrix as PM
    from ntpoly_tpu.parallel.grid import ProcessGrid
    grid = ProcessGrid(1, 1, 1)
    dim, bs = 32, 4
    d = rng.random((dim, dim))                         # fully dense
    m = PM.from_dense(d, bs=bs, grid=grid)
    assert alg._pick_method(m, m) == "dense"
    c = alg.matmul(m, m)
    assert rel_error(np.asarray(PM.to_dense(c)), d @ d) < 1e-13
