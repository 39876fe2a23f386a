"""Linear solvers (reference Source/Fortran/LinearSolversModule.F90).

CGSolver (:33-183): matrix-RHS conjugate gradient with trace-ratio step
sizes.  CholeskyDecomposition (:185-321): the reference factorizes
column by column over the process mesh; a per-column chain leaves the
device's matrix units idle, so this design is a BLOCKED right-looking
factorization — a bs-multiple panel of columns is extracted with one tall
SpMM, its diagonal block factorized densely (one small Cholesky), the
subdiagonal block solved triangularly, and the trailing matrix updated
with one threshold-filtered distributed SpGEMM per panel.  Memory is
O(dim x panel) + the sparse operands — no N^2 materialization, so the
factorization exists at the library's target dimension.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from .common import (resolve, solver_log, iteration_log, finish_iterations,
                     maybe_permute, maybe_unpermute, identity_like,
                     real_scalar)
from .parameters import SolverParameters


def cg_solver(amat, bmat, params: SolverParameters | None = None):
    """Solve A X = B for SPD A (reference CGSolver)."""
    params, monitor = resolve(params)
    with solver_log(params, "Linear Solver", "CG"):
        imat = identity_like(amat)
        ab, bb, imat = maybe_permute(params, amat, bmat, imat)
        x = imat
        r = alg.increment(bb, alg.matmul(ab, x, threshold=params.threshold),
                          1.0, -1.0)
        p = r

        if params.iters_per_sync > 1:
            x, total = _cg_chunked(x, r, p, ab, params, monitor)
            finish_iterations(params, total + 1, x, monitor=monitor,
                          solver="Linear Solver")
            return maybe_unpermute(params, x)

        total = 0
        with iteration_log(params):
            for ii in range(params.max_iterations):
                q = alg.matmul(ab, p, threshold=params.threshold)
                top = real_scalar(alg.dot(r, r))
                bottom = real_scalar(alg.dot(p, q))
                step = top / bottom
                x = alg.increment(x, p, 1.0, step)
                norm_value = abs(step * real_scalar(alg.norm(p)))
                r = alg.increment(r, q, 1.0, -step)
                new_top = real_scalar(alg.dot(r, r))
                p = alg.increment(r, p, 1.0, new_top / top)
                total = ii
                monitor.append(norm_value)
                if monitor.check_converged(params.be_verbose):
                    break
        finish_iterations(params, total + 1, x, monitor=monitor,
                          solver="Linear Solver")
        return maybe_unpermute(params, x)


def _cg_chunked(x, r, p, ab, params, monitor):
    """CG fused iterations (see density._trs4_chunked): the x/r/p triple
    rides in the scan carry."""
    from .common import run_chunked
    from .density import _pin_capacity

    thr = params.threshold
    k_pin, (x, r, p, abp) = _pin_capacity(params, x, r, p, ab,
                                          n_carry=3)

    def step(carry, abc):
        xc, rc, pc = carry
        q = alg.matmul(abc, pc, threshold=thr)
        top = jnp.real(alg.dot(rc, rc))
        bottom = jnp.real(alg.dot(pc, q))
        step_sz = top / bottom
        x_new = alg.increment(xc, pc, 1.0, step_sz)
        norm_value = jnp.abs(step_sz * jnp.real(alg.norm(pc)))
        r_new = alg.increment(rc, q, 1.0, -step_sz)
        new_top = jnp.real(alg.dot(r_new, r_new))
        p_new = alg.increment(r_new, pc, 1.0, new_top / top)
        return (x_new, r_new, p_new), (norm_value,)

    with iteration_log(params) as ilog:
        (x, _, _), _, total = run_chunked(
            step, (x, r, p), (abp,), params, monitor, ilog,
            k_pin=k_pin, aux_names=("Convergence",), conv_mode="value",
            cache_key=("cg", thr))
    return x, total


@jax.jit
def _chol_panel_jit(a_rem: PM.PSMatrix, j0, dim_limit):
    """One panel step of the blocked right-looking Cholesky, fully on
    device; ``j0`` (first column of the panel) is traced so ONE compiled
    program serves every panel.

    Returns (panel_columns_dense [N, W], D_chol_is_bad flag) where the
    panel columns are the SOLVED Cholesky columns (rows above the panel
    masked, padded/out-of-range columns zeroed)."""
    n = a_rem.logical_dim
    w = _chol_panel_width(a_rem)
    cols = j0 + jnp.arange(w)
    sel = ((jnp.arange(n)[:, None] == cols[None, :])
           & (cols < dim_limit)[None, :]).astype(a_rem.blocks.real.dtype)
    p = alg.spmm(a_rem, sel.astype(a_rem.dtype))        # [N, W] = A[:, J]
    # rows above the panel are eliminated (zero up to threshold noise)
    p = p * (jnp.arange(n)[:, None] >= j0)
    d = jax.lax.dynamic_slice(p, (j0, jnp.zeros_like(j0)), (w, w))
    # unit diagonal on padded / out-of-range columns keeps the small
    # factorization nonsingular; those columns are zeroed afterwards
    live = cols < dim_limit
    eye = jnp.eye(w, dtype=d.dtype)
    d = jnp.where(live[None, :] & live[:, None], d, eye)
    ld = jnp.linalg.cholesky(d)
    bad = jnp.any(jnp.isnan(ld))
    # L[:, J] = P @ ld^{-H}  (triangular solve from the right)
    lcols = jax.scipy.linalg.solve_triangular(
        ld, jnp.conj(p).T, lower=True).T
    lcols = jnp.conj(lcols) * live[None, :]
    return lcols, bad


def _chol_panel_width(a: PM.PSMatrix) -> int:
    """Panel width in elements: a handful of block-columns, capped by the
    matrix itself."""
    return min(a.nb, max(1, 512 // a.bs)) * a.bs


def cholesky_decomposition(amat, params: SolverParameters | None = None):
    """A = L L^H (lower-triangular L), threshold-sparsified — blocked
    right-looking sparse factorization (reference
    LinearSolversModule.F90:185-321; see module docstring for the
    design).  O(dim x panel) dense scratch; the trailing
    matrix stays in the threshold-filtered sparse format throughout."""
    params, _ = resolve(params)
    with solver_log(params, "Linear Solver", "Cholesky"):
        n = amat.logical_dim
        w = _chol_panel_width(amat)
        thr = params.threshold
        a_rem = amat
        ell = None
        for j0 in range(0, n, w):
            lcols, bad = _chol_panel_jit(a_rem, jnp.int32(j0),
                                         jnp.int32(amat.dim))
            if bool(bad):
                from ..utils.errors import NTPolyError
                raise NTPolyError(
                    f"cholesky_decomposition: panel at column {j0} is "
                    "not positive definite (threshold-filtered trailing "
                    "updates can destabilize near-singular inputs; "
                    "lower params.threshold)")
            if thr > 0:
                lcols = jnp.where(jnp.abs(lcols) > thr, lcols, 0)
            lp = PM.from_tall_dense(lcols, amat.dim, j0 // amat.bs,
                                    bs=amat.bs, grid=amat.grid)
            ell = lp if ell is None else alg.increment(ell, lp)
            if j0 + w < n:
                # trailing update A <- A - Lp Lp^H, threshold-filtered
                a_rem = alg.matmul(lp, alg.transpose(lp).conjugate(),
                                   alpha=-1.0, beta=1.0, c=a_rem,
                                   threshold=thr)
        return ell
