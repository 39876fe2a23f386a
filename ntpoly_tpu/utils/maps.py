"""Element-wise matrix maps and sparsity-pattern conversion
(reference Source/Fortran/MatrixMapsModule.F90:39-438 and
MatrixConversionModule.F90:21-63).

The reference routes every element through a user callback (SWIG directors
RealOperation/ComplexOperation, Source/CPlusPlus/MatrixMapper.h:13-45) with
slice-round-robin work division.  Here there are three tiers:

  * ``map_matrix`` — the callback-parity path: host loop over triplets
    (directors are inherently per-element host code in the reference too).
  * ``map_values`` — the device path: one fused XLA kernel applying
    fn(rows, cols, vals) -> (vals, keep) over every stored element
    in-place on the block-ELL arrays, never leaving the device.
  * ``map_triplets`` — vectorized host-array path that may also move
    entries (change indices), re-filling the matrix afterwards.

``snap_to_sparsity_pattern`` runs on device as a pattern-aligned gather.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EMPTY
from ..core import bell
from ..parallel import pmatrix as PM


class Triplet:
    __slots__ = ("index_row", "index_column", "point_value")

    def __init__(self, row=0, col=0, val=0.0):
        self.index_row = row
        self.index_column = col
        self.point_value = val


class RealOperation:
    """Subclass and override __call__(); ``self.data`` holds the current
    Triplet; return False to drop the element (reference MatrixMapper.h)."""

    def __init__(self):
        self.data = Triplet()

    def __call__(self) -> bool:
        return True


ComplexOperation = type("ComplexOperation", (RealOperation,), {})


def map_matrix(mat: PM.PSMatrix, op) -> PM.PSMatrix:
    """Apply op to every stored element (reference MapMatrix_psr/psc)."""
    rows, cols, vals = PM.to_triplets(mat)
    out_r, out_c, out_v = [], [], []
    for r, c, v in zip(rows, cols, vals):
        op.data.index_row = int(r) + 1       # reference indices are 1-based
        op.data.index_column = int(c) + 1
        op.data.point_value = v
        if op():
            out_r.append(op.data.index_row - 1)
            out_c.append(op.data.index_column - 1)
            out_v.append(op.data.point_value)
    out = PM.empty(mat.dim, bs=mat.bs, k=mat.k, dtype=mat.dtype,
                   grid=mat.grid)
    return PM.fill_from_triplets(
        out, np.asarray(out_r, np.int64), np.asarray(out_c, np.int64),
        np.asarray(out_v, mat.dtype))


@functools.partial(jax.jit, static_argnames=("fn",))
def _map_values_jit(mat: PM.PSMatrix, fn):
    P, NB, K, bs, _ = mat.blocks.shape
    pnb = mat.panel_nb
    # global scalar coordinates of every stored entry
    rr = jnp.arange(NB, dtype=jnp.int32)[None, :, None, None, None]
    ii = jnp.arange(bs, dtype=jnp.int32)[None, None, None, :, None]
    jj = jnp.arange(bs, dtype=jnp.int32)[None, None, None, None, :]
    bj = mat.col_ids[..., None, None]
    valid = bj != EMPTY
    rows = jnp.broadcast_to(rr * bs + ii, mat.blocks.shape)
    cols = jnp.where(valid, bj, 0) * bs + jj
    stored = valid & (mat.blocks != 0) & (rows < mat.dim) & (cols < mat.dim)
    result = fn(rows, cols, mat.blocks)
    if isinstance(result, tuple):
        vals, keep = result
    else:
        vals, keep = result, True
    new_blocks = jnp.where(stored & keep, vals.astype(mat.dtype), 0)
    return mat.with_data(mat.col_ids, new_blocks)


def map_values(mat: PM.PSMatrix, fn) -> PM.PSMatrix:
    """Device-side elementwise map over stored entries.

    fn(rows, cols, vals) -> vals or (vals, keep_mask), applied as one fused
    XLA kernel on the block-ELL arrays (rows/cols are global 0-based int32
    arrays of the same shape as vals).  Dropped entries become explicit
    zeros; the sparsity pattern is unchanged.  fn must be hashable (a
    module-level function or functools.partial) — it is a static jit arg.
    """
    return _map_values_jit(mat, fn)


def map_triplets(mat: PM.PSMatrix, fn) -> PM.PSMatrix:
    """Vectorized map over host triplet arrays: fn(rows, cols, vals) ->
    (rows, cols, vals) or (rows, cols, vals, keep_mask).  Use this form
    when the map moves entries; use :func:`map_values` when it only
    changes values (stays on device)."""
    rows, cols, vals = PM.to_triplets(mat)
    result = fn(rows, cols, vals)
    if len(result) == 4:
        r, c, v, keep = result
        r, c, v = r[keep], c[keep], v[keep]
    else:
        r, c, v = result
    out = PM.empty(mat.dim, bs=mat.bs, k=mat.k, dtype=mat.dtype,
                   grid=mat.grid)
    return PM.fill_from_triplets(out, r, c, v)


@jax.jit
def snap_to_sparsity_pattern(mat: PM.PSMatrix,
                             pattern: PM.PSMatrix) -> PM.PSMatrix:
    """Force ``mat`` onto ``pattern``'s sparsity (explicit zeros added,
    off-pattern entries dropped) — reference SnapMatrixToSparsityPattern
    (MatrixConversionModule.F90:21-63) for fixed-pattern interop.  Runs on
    device: a pattern-aligned gather of mat's blocks, one fused kernel."""
    aligned = bell.align(pattern.col_ids, mat.col_ids, mat.blocks)
    # scalar-granular: keep only positions where the pattern itself has an
    # entry (align is block-granular)
    aligned = jnp.where(pattern.blocks != 0, aligned, 0)
    return pattern.with_data(pattern.col_ids, aligned).astype(mat.dtype)
