"""Permutations and load-balancing by permutation.

reference Source/Fortran/PermutationModule.F90 (default / reverse / random /
limited-random lookups) and LoadBalancerModule.F90:16-92 (permute = two
SpGEMMs against one-entry-per-row permutation matrices).

On a device mesh the original motivation (MPI rank skew) becomes
block-occupancy balance across mesh shards, but the observable semantics
are identical:
solvers permute once up front, iterate on the balanced matrix, and undo the
permutation at the end.
"""
from __future__ import annotations

import numpy as np


class Permutation:
    """index_lookup maps destination index -> source index (0-based)."""

    def __init__(self, dim: int | None = None):
        self.index_lookup: np.ndarray | None = None
        self.reverse_lookup: np.ndarray | None = None
        if dim is not None:
            self.set_default_permutation(dim)

    def _finish(self, lookup: np.ndarray):
        self.index_lookup = lookup
        rev = np.empty_like(lookup)
        rev[lookup] = np.arange(len(lookup))
        self.reverse_lookup = rev

    def set_default_permutation(self, dim: int):
        self._finish(np.arange(dim))

    def set_reverse_permutation(self, dim: int):
        self._finish(np.arange(dim)[::-1].copy())

    def set_random_permutation(self, dim: int, seed: int | None = None):
        rng = np.random.default_rng(seed)
        self._finish(rng.permutation(dim))

    def set_limited_random_permutation(self, actual_dim: int,
                                       logical_dim: int | None = None,
                                       seed: int | None = None):
        """Shuffle only the first actual_dim indices (reference
        ConstructLimitedRandomPermutation, PermutationModule.F90:118-162)."""
        logical_dim = logical_dim or actual_dim
        rng = np.random.default_rng(seed)
        lookup = np.arange(logical_dim)
        lookup[:actual_dim] = rng.permutation(actual_dim)
        self._finish(lookup)


def permutation_matrices(perm: Permutation, like):
    """Build (P_rows, P_cols) PSMatrices for ``like``'s geometry.

    P_rows[i, perm[i]] = 1 and P_cols[perm[i], i] = 1, matching the
    reference FillMatrixPermutation convention
    (reference distributed_includes/FillMatrixPermutation.f90).
    """
    from ..parallel import pmatrix as PM
    n = min(len(perm.index_lookup), like.logical_dim)
    lookup = np.asarray(perm.index_lookup[:n])
    i = np.arange(n)
    base = PM.empty(like.dim, bs=like.bs, k=like.k, dtype=like.dtype,
                    grid=like.grid)
    p_rows = PM.fill_from_triplets(base, i, lookup, np.ones(n))
    p_cols = PM.fill_from_triplets(base, lookup, i, np.ones(n))
    return p_rows, p_cols


def permute_matrix(mat, perm: Permutation, threshold=0.0):
    """P_rows @ A @ P_cols (reference PermuteMatrix)."""
    from ..parallel import algebra as alg
    p_rows, p_cols = permutation_matrices(perm, mat)
    return alg.matmul(p_rows, alg.matmul(mat, p_cols, threshold=threshold),
                      threshold=threshold)


def undo_permute_matrix(mat, perm: Permutation, threshold=0.0):
    """P_cols @ A @ P_rows (reference UndoPermuteMatrix)."""
    from ..parallel import algebra as alg
    p_rows, p_cols = permutation_matrices(perm, mat)
    return alg.matmul(p_cols, alg.matmul(mat, p_rows, threshold=threshold),
                      threshold=threshold)
