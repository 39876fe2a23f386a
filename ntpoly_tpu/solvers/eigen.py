"""Eigendecomposition and dense matrix functions
(reference Source/Fortran/EigenSolversModule.F90, EigenExaModule.F90).

The reference's only distributed eigensolver is "gather the whole matrix on
every rank, run LAPACK, redistribute" (EigenSerial,
reference eigenexa_includes/EigenSerial.f90:1-42) with an optional EigenExa
bridge.  The equivalent here gathers to dense and runs
``jnp.linalg.eigh`` — a blocked factorization via XLA — then re-sparsifies
with the threshold.  ``dense_matrix_function`` (eigendecompose, map
eigenvalues through f, reassemble) is the universal dense fallback used by
every Dense* solver (reference EigenSolversModule.F90:88-150).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from .common import resolve, solver_log, real_scalar
from .parameters import SolverParameters


def _to_ps(dense, like, threshold=0.0):
    return PM.from_dense(np.asarray(dense), bs=like.bs, k=like.k,
                         grid=like.grid, dtype=like.dtype,
                         threshold=threshold)


def eigh(mat):
    """Dense Hermitian eigendecomposition of a PSMatrix -> (w, v) arrays."""
    d = PM.to_dense(mat)
    return jnp.linalg.eigh(d)


def eigen_decomposition(mat, nvals: int | None = None,
                        params: SolverParameters | None = None,
                        compute_vectors: bool = True):
    """reference EigenSolversModule.F90:36-84.  Returns (vals, vecs) as
    PSMatrices; vals is diagonal.  With nvals, only the lowest nvals pairs
    are kept (columns beyond nvals zeroed)."""
    params, _ = resolve(params)
    with solver_log(params, "Eigen Solver", "LAPACK"
                    if mat.grid.n_devices == 1 else "Dense Gathered"):
        w, v = eigh(mat)
        n = mat.dim
        if nvals is not None and nvals < n:
            w = jnp.where(jnp.arange(w.shape[0]) < nvals, w, 0.0)
            v = jnp.where(jnp.arange(v.shape[1])[None, :] < nvals, v, 0.0)
        vals = _to_ps(jnp.diag(w[:n]), like=mat)
        if not compute_vectors:
            return vals, None
        vecs = _to_ps(v, like=mat, threshold=params.threshold)
        return vals, vecs


def eigen_values(mat, nvals: int | None = None,
                 params: SolverParameters | None = None):
    vals, _ = eigen_decomposition(mat, nvals=nvals, params=params,
                                  compute_vectors=False)
    return vals


def dense_matrix_function(mat, func, params: SolverParameters | None = None):
    """V f(w) V^H (reference EigenSolversModule.F90:88-150).  ``func`` maps
    an eigenvalue array to transformed values (vectorized numpy/jnp)."""
    params, _ = resolve(params)
    w, v = eigh(mat)
    fw = func(w)
    out = (v * fw[None, :]) @ jnp.conj(v).T
    if params.threshold > 0:
        out = jnp.where(jnp.abs(out) > params.threshold, out, 0)
    return _to_ps(out, like=mat)


def eigen_decomposition_iterative(mat, nvals: int,
                                  params: SolverParameters | None = None,
                                  max_iters: int = 200,
                                  tol: float | None = None):
    """Lowest ``nvals`` eigenpairs WITHOUT densifying the matrix.

    The reference escapes its dense O(N^2) eigensolver only through the
    optional EigenExa bridge (reference EigenExaModule.F90:24-58); the
    escape here is matrix-free LOBPCG on the distributed block-sparse
    operator: per iteration one tall SpMM (``alg.spmm``, batched
    (bs, bs) x (bs, m) dots) plus small dense Rayleigh-Ritz problems.
    Memory is O(N * nvals) instead of O(N^2).

    LOBPCG converges to the LARGEST eigenvalues of an SPD operator, so the
    spectrum is flipped with a Gershgorin upper bound b: run on b*I - A,
    return w = b - theta.
    """
    import jax
    from jax.experimental.sparse.linalg import lobpcg_standard

    if jnp.issubdtype(mat.dtype, jnp.complexfloating):
        # jax's lobpcg_standard is real-only — run it on the 2x2 real
        # embedding (every complex eigenvalue arrives with doubled
        # multiplicity) and reconstruct the complex pairs (role of the
        # reference's complex-native EigenExa bridge,
        # EigenExaModule.F90:24-58)
        from ..core import cplx
        me = cplx.embed(mat)
        w2, v2 = eigen_decomposition_iterative(
            me, 2 * nvals, params=params, max_iters=max_iters, tol=tol)
        return dedup_embedded_pairs(np.asarray(w2), np.asarray(v2),
                                    mat.dim, nvals)
    params, _ = resolve(params)
    with solver_log(params, "Eigen Solver", "LOBPCG (matrix-free)",
                    extra={"Requested Values": nvals}):
        _, b = alg.gershgorin_bounds(mat)
        b = b + 1.0
        n = mat.logical_dim
        # The search stays confined to the actual (unpadded) dimension by
        # masking INSIDE the operator: any numeric leak into padded rows
        # would otherwise make them spurious eigen-directions at exactly
        # b.  Input must not be load-balanced (permuted into the padded
        # region) — data there would be silently zeroed.
        mask = (jnp.arange(n) < mat.dim)[:, None].astype(
            mat.blocks.real.dtype)

        def op(x):
            return (b * x - alg.spmm(mat, x)) * mask

        # deterministic start block (reproducible across grids)
        key = jax.random.PRNGKey(7)
        x0 = jax.random.normal(key, (n, nvals), dtype=mat.blocks.real.dtype)
        x0 = x0 * mask
        # tol=None -> jax's machine-eps stopping rule (tol=0.0 would
        # disable early exit entirely)
        theta, v, iters = lobpcg_standard(op, x0, m=max_iters, tol=tol)
        w = b - theta
        order = jnp.argsort(w)
        w = w[order]
        v = v[:, order] * mask
        if params.be_verbose:
            from ..utils.logging import logger
            logger.write_element("Iterations", int(iters))
        return w, v[:mat.dim, :]


def dedup_embedded_pairs(w2: np.ndarray, v2: np.ndarray, cdim: int,
                         nvals: int):
    """Complex eigenpairs from the 2x2 real embedding's output.

    The embedding E(C) = [[A, -B], [B, A]] doubles every multiplicity:
    the real 2D eigenspace for a complex eigenvector u is
    {[Re(alpha u); Im(alpha u)]} — ANY unit vector [x; y] in it maps to
    a unit complex eigenvector x + iy (up to phase).  Reconstruct a
    candidate from every embedded vector and keep the complex-linearly
    independent ones by modified Gram-Schmidt (robust to true complex
    degeneracies, where alternate-picking would fail).

    w2/v2: ascending eigenvalues [2*nvals] and embedded vectors
    [2*cdim, 2*nvals].  Returns (w [nvals], v [cdim, nvals] complex).
    """
    cands = v2[:cdim, :] + 1j * v2[cdim:, :]
    sel_w: list = []
    sel_v: list = []
    for k in range(cands.shape[1]):
        u = cands[:, k].astype(np.complex128)
        for uu in sel_v:
            u = u - uu * (np.conj(uu) @ u)
        nrm = np.linalg.norm(u)
        # a duplicate of an accepted pair projects to ~0; a fresh pair
        # keeps ~1/sqrt(2) of its mass even when LOBPCG mixed the
        # degenerate basis
        if nrm > 0.3:
            sel_v.append(u / nrm)
            sel_w.append(float(w2[k]))
        if len(sel_v) == nvals:
            break
    return (np.asarray(sel_w),
            np.stack(sel_v, axis=1) if sel_v
            else np.zeros((cdim, 0), np.complex128))


def estimate_gap(h, k, chemical_potential,
                 params: SolverParameters | None = None):
    """HOMO-LUMO gap estimate from the density matrix and mu
    (reference EigenSolversModule.F90:153-228)."""
    from .eigenbounds import power_bounds, gershgorin_bounds
    params, _ = resolve(params)
    with solver_log(params, "Gap Estimator"):
        kh = alg.matmul(k, h, threshold=params.threshold)
        e_min = power_bounds(kh, params)
        if e_min > 0:
            e_min, _ = gershgorin_bounds(h)
        from .common import identity_like
        shift_h = alg.increment(identity_like(h), h, -e_min, 1.0)
        kh = alg.matmul(k, shift_h, threshold=params.threshold)
        e_max = power_bounds(kh, params)
        e_max = e_max + e_min
        return 2.0 * (chemical_potential - e_max)


def singular_value_decomposition(mat, params: SolverParameters | None = None):
    """SVD via polar decomposition + eigendecomposition of H
    (reference SingularValueSolversModule.F90:18-70).
    Returns (left_vectors, right_vectors, singular_values)."""
    from .sign import polar_decomposition
    params, _ = resolve(params)
    with solver_log(params, "SVD Solver", "Polar + Eigen"):
        u, h = polar_decomposition(mat, params)
        singular_values, right = eigen_decomposition(h, params=params)
        left = alg.matmul(u, right, threshold=params.threshold)
        return left, right, singular_values
