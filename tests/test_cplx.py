"""Real 2x2 embedding of complex matrices (core/cplx.py) — the path for
complex data on backends without native complex.  f(E(C)) = E(f(C)) for
every solver built from multiplies and real-coefficient additions;
verified here against the
native complex path (CPU supports both)."""
import numpy as np
import pytest

from ntpoly_tpu.core import cplx
from ntpoly_tpu.parallel import pmatrix as PM
from ntpoly_tpu.parallel.grid import ProcessGrid
from ntpoly_tpu.solvers import exponential, sign, squareroot
from ntpoly_tpu.solvers.parameters import SolverParameters

from conftest import rel_error

DIM, BS = 24, 4


@pytest.fixture
def grid():
    return ProcessGrid(2, 2, 1)


def hermitian(rng, spd=False):
    h = rng.random((DIM, DIM)) + 1j * rng.random((DIM, DIM))
    h = 0.5 * (h + h.conj().T)
    if spd:
        h = h @ h.conj().T + np.eye(DIM)
    return h


def test_embed_extract_roundtrip(rng, grid):
    h = hermitian(rng)
    m = PM.from_dense(h, bs=BS, grid=grid)
    me = cplx.embed(m)
    assert me.dim == 2 * DIM
    # embedding structure: [[A, -B], [B, A]]
    d = np.asarray(PM.to_dense(me))
    assert rel_error(d[:DIM, :DIM], h.real) < 1e-14
    assert rel_error(d[DIM:, :DIM], h.imag) < 1e-14
    assert rel_error(d[:DIM, DIM:], -h.imag) < 1e-14
    back = cplx.extract(me)
    assert rel_error(np.asarray(PM.to_dense(back)), h) < 1e-14


def test_embedding_is_ring_homomorphism(rng, grid):
    from ntpoly_tpu.parallel import algebra as alg
    a = hermitian(rng)
    b = hermitian(rng)
    ma = PM.from_dense(a, bs=BS, grid=grid)
    mb = PM.from_dense(b, bs=BS, grid=grid)
    prod_then_embed = cplx.embed(alg.matmul(ma, mb))
    embed_then_prod = alg.matmul(cplx.embed(ma), cplx.embed(mb))
    assert rel_error(np.asarray(PM.to_dense(embed_then_prod)),
                     np.asarray(PM.to_dense(prod_then_embed))) < 1e-13


@pytest.mark.parametrize("solver", ["sign", "isq", "exp"])
def test_solver_commutes_with_embedding(rng, grid, solver):
    """f(E(C)) == E(f(C)): run the solver natively on the complex matrix
    and on its real embedding; extract and compare."""
    params = SolverParameters(converge_diff=1e-10, threshold=1e-12)
    if solver == "sign":
        h = hermitian(rng) - 0.7 * np.eye(DIM)
        fn = lambda m: sign.sign_function(m, params)
    elif solver == "isq":
        h = hermitian(rng, spd=True)
        fn = lambda m: squareroot.inverse_square_root(m, params)
    else:
        h = 0.1 * hermitian(rng)
        fn = lambda m: exponential.compute_exponential(m, params)
    m = PM.from_dense(h, bs=BS, grid=grid)
    native_result = np.asarray(PM.to_dense(fn(m)))
    embedded_result = cplx.extract(fn(cplx.embed(m)))
    assert rel_error(np.asarray(PM.to_dense(embedded_result)),
                     native_result) < 1e-6


# ----------------------------------------------------------------------------
# automatic embedding through the public api:
# complex input on a backend without native complex runs through the 2x2
# embedding with NO manual embed_triplets — forced on here via the
# embedding-policy override so CPU exercises the embedded code path.
# ----------------------------------------------------------------------------

@pytest.fixture
def force_embed():
    from ntpoly_tpu import config
    config.set_complex_embedding("always")
    yield
    config.set_complex_embedding("auto")


def _write_mm_complex(path, h):
    from scipy.io import mmwrite
    from scipy.sparse import csr_matrix
    mmwrite(str(path), csr_matrix(h))


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 1), (2, 2, 2)])
def test_api_auto_embedded_isq_sign(rng, tmp_path, force_embed, shape):
    """BASELINE config 3 through the public API: ISQ + sign of a complex
    Hermitian matrix with automatic embedding, swept over grids."""
    import ntpoly_tpu as nt
    import scipy.linalg as sla
    h = hermitian(rng, spd=True)
    _write_mm_complex(tmp_path / "h.mtx", h)
    nt.ConstructGlobalProcessGrid(*shape)
    try:
        H = nt.Matrix_ps(str(tmp_path / "h.mtx"))
        assert H._embedded and H.GetActualDimension() == DIM
        params = nt.SolverParameters()
        params.SetThreshold(1e-12)
        params.SetConvergeDiff(1e-10)
        ISQ = nt.Matrix_ps(DIM)
        nt.SquareRootSolvers.InverseSquareRoot(H, ISQ, params)
        ISQ.WriteToMatrixMarket(str(tmp_path / "isq.mtx"))
        SGN = nt.Matrix_ps(DIM)
        nt.SignSolvers.ComputeSign(H, SGN, params)
        SGN.WriteToMatrixMarket(str(tmp_path / "sgn.mtx"))
        from scipy.io import mmread
        isq = np.asarray(mmread(str(tmp_path / "isq.mtx")).todense())
        ref = np.linalg.inv(sla.sqrtm(h))
        assert rel_error(isq, ref) < 1e-5
        sgn = np.asarray(mmread(str(tmp_path / "sgn.mtx")).todense())
        assert rel_error(sgn, np.eye(DIM)) < 1e-5   # SPD -> sign == I
        # trace/dot semantics on the embedding
        assert abs(H.Trace() - np.trace(h).real) < 1e-8
    finally:
        nt.DestructGlobalProcessGrid()


def test_api_auto_embedded_trs2_energy(rng, tmp_path, force_embed):
    """Purification on an embedded complex Hamiltonian: doubled trace
    target, halved reported energy — matches the native complex solve."""
    import ntpoly_tpu as nt
    h = hermitian(rng)
    w, v = np.linalg.eigh(h)
    nel = DIM // 2
    e_ref = w[:nel].sum()
    _write_mm_complex(tmp_path / "h.mtx", h)
    nt.ConstructGlobalProcessGrid(2, 2, 1)
    try:
        H = nt.Matrix_ps(str(tmp_path / "h.mtx"))
        ISQ = nt.Matrix_ps(DIM)
        ISQ.FillIdentity()
        assert ISQ._embedded is False      # real identity needs no embed
        # build embedded identity the way a user would: via H's overlap
        ISQe = nt.Matrix_ps(H)
        ISQe.FillIdentity()
        K = nt.Matrix_ps(DIM)
        params = nt.SolverParameters()
        params.SetThreshold(1e-12)
        params.SetConvergeDiff(1e-10)
        energy, mu = nt.DensityMatrixSolvers.TRS2(H, ISQe, nel, K, params)
        assert abs(energy - e_ref) < 1e-5 * max(1.0, abs(e_ref))
        assert K._embedded
        # density trace = nel (complex trace via the halving rule)
        assert abs(K.Trace() - nel) < 1e-6
        # round-trip the density out as complex triplets
        tl = nt.TripletList_c()
        K.GetTripletList(tl)
        occ = v[:, :nel]
        rho_ref = occ @ occ.conj().T
        rho = np.zeros((DIM, DIM), np.complex128)
        rho[np.asarray(tl.rows) - 1,
            np.asarray(tl.columns) - 1] = tl.values    # 1-based API
        assert rel_error(rho, rho_ref) < 1e-5
    finally:
        nt.DestructGlobalProcessGrid()


def test_embedded_conjugate_transpose_with_padding(rng, force_embed):
    """Regression (r3 review): the conjugation sign boundary must be the
    COMPLEX dimension, not logical_dim//2 — they differ whenever the
    block/grid geometry pads the embedding (dim 18, bs 8 -> logical 40)."""
    import ntpoly_tpu as nt
    dim = 18
    a = rng.random((dim, dim)) + 1j * rng.random((dim, dim))
    from scipy.io import mmwrite
    from scipy.sparse import csr_matrix
    import tempfile, os
    d = tempfile.mkdtemp()
    mmwrite(os.path.join(d, "a.mtx"), csr_matrix(a))
    nt.ConstructGlobalProcessGrid(2, 2, 1)
    try:
        A = nt.Matrix_ps(os.path.join(d, "a.mtx"))
        assert A._embedded and A._m.logical_dim > 2 * dim
        A.Conjugate()
        tl = nt.TripletList_c()
        A.GetTripletList(tl)
        got = np.zeros((dim, dim), np.complex128)
        got[np.asarray(tl.rows) - 1, np.asarray(tl.columns) - 1] = tl.values
        assert rel_error(got, np.conj(a)) < 1e-12
        # plain (non-conjugate) transpose through the embedding
        B = nt.Matrix_ps(dim)
        A.Conjugate()                       # back to a
        B.Transpose(A)
        tl2 = nt.TripletList_c()
        B.GetTripletList(tl2)
        got2 = np.zeros((dim, dim), np.complex128)
        got2[np.asarray(tl2.rows) - 1,
             np.asarray(tl2.columns) - 1] = tl2.values
        assert rel_error(got2, a.T) < 1e-12
    finally:
        nt.DestructGlobalProcessGrid()


def test_embedded_eigendecomposition(rng, force_embed):
    """Regression (r3 review): the spectrum of E(C) has doubled
    multiplicity, so embedded eigendecomposition must NOT run on the
    embedding — the api routes it to a host complex eigh."""
    import ntpoly_tpu as nt
    from scipy.io import mmwrite
    from scipy.sparse import csr_matrix
    import tempfile, os
    dim = 16
    h = rng.random((dim, dim)) + 1j * rng.random((dim, dim))
    h = 0.5 * (h + h.conj().T)
    d = tempfile.mkdtemp()
    mmwrite(os.path.join(d, "h.mtx"), csr_matrix(h))
    nt.ConstructGlobalProcessGrid(1, 1, 1)
    try:
        H = nt.Matrix_ps(os.path.join(d, "h.mtx"))
        assert H._embedded
        W = nt.Matrix_ps(dim)
        nt.EigenSolvers.EigenValues(H, W)
        tl = nt.TripletList_c()
        W.GetTripletList(tl)
        got = np.zeros(dim)
        got[np.asarray(tl.rows) - 1] = np.real(tl.values)
        ref = np.linalg.eigh(h)[0]
        assert rel_error(np.sort(got), ref) < 1e-10
    finally:
        nt.DestructGlobalProcessGrid()


def test_mixed_embedding_raises(rng, force_embed):
    """Mixed embedded/plain operands raise a typed, actionable error."""
    import ntpoly_tpu as nt
    from ntpoly_tpu.utils.errors import ComplexSupportError
    from scipy.io import mmwrite
    from scipy.sparse import csr_matrix
    import tempfile, os
    dim = 12
    h = rng.random((dim, dim)) + 1j * rng.random((dim, dim))
    d = tempfile.mkdtemp()
    mmwrite(os.path.join(d, "h.mtx"), csr_matrix(h))
    nt.ConstructGlobalProcessGrid(1, 1, 1)
    try:
        H = nt.Matrix_ps(os.path.join(d, "h.mtx"))
        R = nt.Matrix_ps(dim)
        R.FillIdentity()
        C = nt.Matrix_ps(dim)
        with pytest.raises(ComplexSupportError, match="mix"):
            C.Gemm(H, R)
        with pytest.raises(TypeError, match="complex"):
            H.Scale(1j)
    finally:
        nt.DestructGlobalProcessGrid()


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 1), (1, 2, 4)])
def test_embedded_svd(rng, tmp_path, force_embed, shape):
    """embedded SVD via the host complex path
    (reference SingularValueSolversModule.F90:18-70 is complex-native);
    A = L S R^H with ascending singular values, swept over grids."""
    import ntpoly_tpu as nt
    dim = 16
    a = rng.random((dim, dim)) + 1j * rng.random((dim, dim))
    _write_mm_complex(tmp_path / "a.mtx", a)
    nt.ConstructGlobalProcessGrid(*shape)
    try:
        A = nt.Matrix_ps(str(tmp_path / "a.mtx"))
        assert A._embedded
        L, R, S = (nt.Matrix_ps(dim) for _ in range(3))
        nt.EigenSolvers.SingularValueDecomposition(A, L, R, S)

        def dense_of(M):
            tl = nt.TripletList_c()
            M.GetTripletList(tl)
            out = np.zeros((dim, dim), np.complex128)
            out[np.asarray(tl.rows) - 1,
                np.asarray(tl.columns) - 1] = tl.values
            return out

        ld, rd, sd = dense_of(L), dense_of(R), dense_of(S)
        s_ref = np.sort(np.linalg.svd(a, compute_uv=False))
        assert rel_error(np.diag(sd).real, s_ref) < 1e-10
        assert rel_error(ld @ sd @ np.conj(rd).T, a) < 1e-10
        # factors are unitary
        assert rel_error(np.conj(ld).T @ ld, np.eye(dim)) < 1e-10
        assert rel_error(np.conj(rd).T @ rd, np.eye(dim)) < 1e-10
    finally:
        nt.DestructGlobalProcessGrid()


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 1), (1, 2, 4)])
def test_embedded_reduce_dimension(rng, tmp_path, force_embed, shape):
    """embedded ReduceDimension via the host
    complex path (reference AnalysisModule.F90:222-279 is
    complex-native): the reduced matrix keeps the lowest eigenvalues."""
    import ntpoly_tpu as nt
    dim, small = 16, 8
    h = rng.random((dim, dim)) + 1j * rng.random((dim, dim))
    h = 0.5 * (h + h.conj().T)
    # a spectral gap keeps the subspace well separated (like the real test)
    w, v = np.linalg.eigh(h)
    w = w + np.where(np.arange(dim) >= small, 10.0, 0.0)
    h = (v * w[None, :]) @ np.conj(v).T
    _write_mm_complex(tmp_path / "h.mtx", h)
    nt.ConstructGlobalProcessGrid(*shape)
    try:
        H = nt.Matrix_ps(str(tmp_path / "h.mtx"))
        assert H._embedded
        Red = nt.Matrix_ps(dim)
        nt.Analysis.ReduceDimension(H, small, Red)
        tl = nt.TripletList_c()
        Red.GetTripletList(tl)
        rd = np.zeros((small, small), np.complex128)
        rd[np.asarray(tl.rows) - 1,
           np.asarray(tl.columns) - 1] = tl.values
        w_red = np.linalg.eigvalsh(rd)
        assert rel_error(np.sort(w_red), np.sort(w)[:small]) < 1e-8
    finally:
        nt.DestructGlobalProcessGrid()


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 1), (2, 2, 2)])
def test_embedded_iterative_eigensolver(rng, tmp_path, force_embed, shape):
    """the matrix-free LOBPCG runs on the
    2x2 real embedding (doubled multiplicities) and the complex pairs
    are reconstructed — the scalable eigen path is complex-capable, the
    role of the reference's complex-native EigenExa bridge
    (EigenExaModule.F90:24-58)."""
    import ntpoly_tpu as nt
    h = hermitian(rng)
    _write_mm_complex(tmp_path / "h.mtx", h)
    nt.ConstructGlobalProcessGrid(*shape)
    try:
        H = nt.Matrix_ps(str(tmp_path / "h.mtx"))
        assert H._embedded
        nvals = 4
        w, v = nt.EigenSolvers.IterativeEigenDecomposition(H, nvals)
        w_ref = np.linalg.eigvalsh(h)[:nvals]
        assert rel_error(np.asarray(w), w_ref) < 1e-4
        # residual and orthonormality of the reconstructed complex pairs
        res = np.linalg.norm(h @ v - v * np.asarray(w)[None, :])
        assert res / np.linalg.norm(h) < 1e-3
        gram = np.conj(v).T @ v
        assert rel_error(gram, np.eye(nvals)) < 1e-6
    finally:
        nt.DestructGlobalProcessGrid()


def test_native_complex_iterative_eigensolver(rng):
    """Native complex PSMatrix path (CPU): embedding + reconstruction
    happen inside eigen_decomposition_iterative."""
    from ntpoly_tpu.solvers import eigen
    grid = ProcessGrid(2, 2, 1)
    h = hermitian(rng)
    m = PM.from_dense(h, bs=BS, grid=grid)
    nvals = 3
    w, v = eigen.eigen_decomposition_iterative(m, nvals)
    w_ref = np.linalg.eigvalsh(h)[:nvals]
    assert rel_error(np.asarray(w), w_ref) < 1e-4
    res = np.linalg.norm(h @ v - v * np.asarray(w)[None, :])
    assert res / np.linalg.norm(h) < 1e-3
