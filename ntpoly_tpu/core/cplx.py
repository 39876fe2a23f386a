"""Complex matrices on real-only backends: the 2x2 real embedding.

On a backend without native complex arithmetic, a complex matrix
C = A + iB is represented as the real matrix of twice the dimension

    E(C) = [[A, -B],
            [B,  A]]

E is a ring homomorphism (E(C1 C2) = E(C1) E(C2), E(C1 + C2) = E(C1) +
E(C2), E(alpha C) = alpha E(C) for real alpha), so every matrix function
built from multiplies and real-coefficient additions — the entire solver
surface — satisfies f(E(C)) = E(f(C)).  A Hermitian C maps to a symmetric
E(C) whose spectrum is C's with doubled multiplicity; purification
therefore needs a doubled trace target, and energies come back doubled
(reference parity: NTPoly holds complex data natively,
DataTypesModule.F90:10-22 — native complex remains the default on
backends that support it, e.g. CPU).

Blockwise embedding keeps the block-ELL structure: each bs x bs complex
block becomes four bs x bs real blocks, so nnz(E) <= 4 nnz(C) and the
bandwidth structure (and threshold behavior, applied per component) is
preserved.
"""
from __future__ import annotations

import numpy as np

from ..parallel import pmatrix as PM


def embed_triplets(rows, cols, vals, dim: int):
    """(i, j, a+ib) -> the four real-embedding triplet groups.

    Returns (rows2, cols2, vals2, 2*dim) with exact zeros dropped."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    re = np.ascontiguousarray(vals.real)
    im = np.ascontiguousarray(vals.imag)
    i2 = np.concatenate([rows, rows, rows + dim, rows + dim])
    j2 = np.concatenate([cols, cols + dim, cols, cols + dim])
    v2 = np.concatenate([re, -im, im, re])
    keep = v2 != 0
    return i2[keep], j2[keep], v2[keep], 2 * dim


def extract_triplets(rows2, cols2, vals2, dim2: int):
    """Inverse of :func:`embed_triplets`: reads A from the upper-left and
    B from the lower-left block of the embedding."""
    rows2 = np.asarray(rows2, np.int64)
    cols2 = np.asarray(cols2, np.int64)
    vals2 = np.asarray(vals2)
    dim = dim2 // 2
    ul = (rows2 < dim) & (cols2 < dim)                 # A
    ll = (rows2 >= dim) & (cols2 < dim)                # B
    # vectorized duplicate-sum on packed (row, col) keys (row-major, so
    # np.unique's sort order IS lexicographic (i, j) order)
    keys = np.concatenate([rows2[ul] * dim + cols2[ul],
                           (rows2[ll] - dim) * dim + cols2[ll]])
    contrib = np.concatenate([vals2[ul].astype(np.complex128),
                              1j * vals2[ll].astype(np.complex128)])
    if not len(keys):
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.complex128), dim)
    uk, inv = np.unique(keys, return_inverse=True)
    v = np.zeros(len(uk), np.complex128)
    np.add.at(v, inv, contrib)
    return uk // dim, uk % dim, v, dim


def embed(m: PM.PSMatrix, real_dtype=None) -> PM.PSMatrix:
    """Complex PSMatrix -> its real embedding (dimension doubles)."""
    rows, cols, vals = PM.to_triplets(m)
    i2, j2, v2, dim2 = embed_triplets(rows, cols, vals, m.dim)
    real_dtype = real_dtype or np.real(np.zeros(0, m.dtype)).dtype
    out = PM.empty(dim2, bs=m.bs, dtype=real_dtype, grid=m.grid)
    return PM.fill_from_triplets(out, i2, j2, v2.astype(real_dtype))


def extract(me: PM.PSMatrix, complex_dtype=None) -> PM.PSMatrix:
    """Real embedding -> complex PSMatrix (dimension halves).  Only usable
    on backends with native complex arrays (CPU, GPU); elsewhere keep
    working in the embedded form and extract triplets instead."""
    r2, c2, v2 = PM.to_triplets(me)
    i, j, v, dim = extract_triplets(r2, c2, v2, me.dim)
    complex_dtype = complex_dtype or np.complex128
    out = PM.empty(dim, bs=me.bs, dtype=complex_dtype, grid=me.grid)
    return PM.fill_from_triplets(out, i, j, v.astype(complex_dtype))
