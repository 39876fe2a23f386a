"""Matrix analysis tools (reference Source/Fortran/AnalysisModule.F90).

PivotedCholeskyDecomposition (:30-221, aquilante2006fast): rank-k partial
Cholesky with max-diagonal pivoting.  The reference hunts pivots with
allreduce-maxloc over a distributed panel; this design keeps the
matrix SPARSE and distributed throughout: the whole rank-k loop runs on
device as one compiled ``lax.fori_loop`` whose per-step work is a single
one-hot SpMV (column extraction via the distributed operator), a
[dim, rank] dense panel update, and the diagonal downdate — O(dim * rank)
memory, no N^2 materialization, so the factorization exists at the
library's target dimension.

ReduceDimension (:222-279): TRS4 with identity overlap -> rank-dim pivoted
Cholesky of the density -> similarity transform into that subspace ->
GetMatrixSlice.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from .common import resolve, solver_log, identity_like
from .parameters import SolverParameters


@functools.partial(jax.jit, static_argnames=("rank",))
def _pivoted_chol_jit(amat: PM.PSMatrix, diag0, threshold, *, rank: int):
    """Device-side rank-k pivoted Cholesky.

    carry: (ell [N, rank] dense panel, diag [N] remaining diagonal).
    Step jj: pivot p = argmax(diag); column A[:, p] arrives via a one-hot
    SpMV (the distributed operator application — the reference's
    per-column gather + bcast, CholeskySolversModule.F90:19-250);
    col = (A[:, p] - ell @ conj(ell[p, :])) / sqrt(diag[p]); breakdown
    (diag[p] <= 0) zeroes the column, which freezes the factorization
    exactly like the reference's early exit."""
    n = amat.logical_dim
    rdt = amat.blocks.real.dtype

    def body(jj, carry):
        ell, diag = carry
        p = jnp.argmax(diag)
        val = diag[p]
        ok = val > 0
        onehot = (jnp.arange(n) == p).astype(amat.dtype)
        acol = alg.spmv(amat, onehot)                     # A[:, p] (Herm.)
        ellp = jax.lax.dynamic_slice(ell, (p, 0), (1, rank))[0]
        live = jnp.arange(rank) < jj
        proj = ell @ jnp.where(live, jnp.conj(ellp), 0).astype(ell.dtype)
        denom = jnp.sqrt(jnp.where(ok, val, 1.0)).astype(ell.dtype)
        col = (acol - proj) / denom
        col = jnp.where(jnp.arange(n) == p, denom, col)
        col = jnp.where(jnp.abs(col) > threshold, col, 0)
        col = jnp.where(ok, col, 0)
        ell = jax.lax.dynamic_update_slice(ell, col[:, None],
                                           (jnp.zeros_like(p), jj))
        diag = diag - jnp.abs(col).astype(rdt) ** 2
        diag = diag.at[p].set(jnp.where(ok, 0.0, diag[p]))
        return ell, diag

    ell0 = jnp.zeros((n, rank), amat.dtype)
    ell, diag = jax.lax.fori_loop(0, rank, body, (ell0, diag0))
    return ell


def pivoted_cholesky_decomposition(amat, rank: int,
                                   params: SolverParameters | None = None):
    """Rank-``rank`` L with A ~= L L^H; returns L as a PSMatrix whose first
    ``rank`` columns are the pivoted Cholesky vectors."""
    params, _ = resolve(params)
    with solver_log(params, "Cholesky Solver", "Pivoted",
                    citations=("aquilante2006fast",),
                    extra={"Target_Rank": rank}):
        n = amat.logical_dim
        diag0 = jnp.real(alg.diagonal_values(amat))
        # padded rows carry zero diagonal and are never picked while a
        # positive pivot remains
        diag0 = jnp.where(jnp.arange(n) < amat.dim, diag0, 0.0)
        ell = _pivoted_chol_jit(amat, diag0,
                                jnp.asarray(params.threshold), rank=rank)
        # pad the dense panel to whole blocks for the device-side builder
        rpad = -rank % amat.bs
        if rpad:
            ell = jnp.pad(ell, ((0, 0), (0, rpad)))
        return PM.from_tall_dense(ell, amat.dim, 0, bs=amat.bs,
                                  grid=amat.grid)


def reduce_dimension(mat, dim: int, params: SolverParameters | None = None):
    """reference ReduceDimension (AnalysisModule.F90:222-279)."""
    from .density import trs4
    params, _ = resolve(params)
    with solver_log(params, "Dimension Reduction"):
        imat = identity_like(mat)
        pmat, _, _ = trs4(mat, imat, float(dim), params)
        pvec = pivoted_cholesky_decomposition(pmat, dim, params)
        pvec_t = alg.transpose(pvec).conjugate()
        vav = alg.similarity_transform(mat, pvec_t, pvec,
                                       threshold=params.threshold)
        return PM.get_slice(vav, 0, dim, 0, dim)
