"""The local block-sparse SpGEMM's numeric pass as a Pallas kernel on the
Triton route (GPU).

Same contract and semantics as ``bell.spgemm_candidates`` (explicit block
products, threshold prune, on overflow the lowest column ids are kept):

  A: [R, KA] slots, col ids index block-rows of B (global ids, EMPTY=unused).
  B: [NBK, KB] slots, col ids are global block-cols.
  C: [R, k_out] block-ELL, global col ids, ascending, unique.

Split into a structure pass in XLA and a numeric pass in the kernel:

  * structure pass (:func:`plan`): the candidate output id of every
    (A slot, B slot) pair is sorted per row, so the candidates of one
    output block are contiguous in sorted order; ``start``/``cnt`` give
    each output slot's run and ``order`` maps it back to (A slot, B slot).
    One sort per row, no [R, M, M] comparison tensor.
  * numeric pass (:func:`_kernel`): one program per (output block,
    tile x tile sub-tile).  It walks its run, gathers the A sub-tile and
    B's block row by index, accumulates ``pl.dot`` products in float32 at
    full precision (IEEE FP32, no TF32), and applies alpha and the
    threshold prune in the epilogue.  Only the candidates that land in a
    block are multiplied, and no candidate tensor or accumulator is ever
    written to device memory.

The XLA ``cand`` tier it replaces on the GPU gathers every candidate
block, writes all KA*KB products to memory and merges them with a one-hot
contraction; PERF.md records both on the card.  ``interpret=True`` runs
the same kernel on the CPU (tests).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..config import EMPTY

Array = jax.Array

# Sub-tile of a bs x bs output block per program, and the kernel's launch
# parameters: the best of the configurations timed on one H100 (PERF.md).
TILE = 64
NUM_WARPS = 8
NUM_STAGES = 2


def eligible(dtype, bs: int) -> bool:
    """The kernel handles real float32 blocks whose size is a power of
    two of at least 16 (Triton block shapes; pl.dot needs dims >= 16)."""
    return (jnp.dtype(dtype) == jnp.float32 and bs >= 16
            and bs & (bs - 1) == 0)


def plan(a_cols: Array, b_cols: Array, k_out: int
         ) -> Tuple[Array, Array, Array, Array]:
    """Structure pass from col ids alone.

    Returns
      occ    [R, k_out] int32 — ascending output col ids (EMPTY pad)
      order  [R, KA*KB] int32 — candidate index (s*KB + t) in sorted order
      start  [R, k_out] int32 — first sorted position of each output slot
      cnt    [R, k_out] int32 — number of candidates of each output slot
    Output slots beyond k_out (overflow) are dropped: the lowest ids win.
    """
    R, KA = a_cols.shape
    KB = b_cols.shape[-1]
    valid_a = a_cols != EMPTY
    ks = jnp.where(valid_a, a_cols, 0)
    ids = jnp.where(valid_a[:, :, None], b_cols[ks], EMPTY)
    ids = ids.reshape(R, KA * KB)
    order = jnp.argsort(ids, axis=-1, stable=True).astype(jnp.int32)
    sids = jnp.take_along_axis(ids, order, axis=-1)
    prev = jnp.concatenate(
        [jnp.full((R, 1), -1, sids.dtype), sids[:, :-1]], axis=-1)
    first = (sids != prev) & (sids != EMPTY)
    rank = jnp.cumsum(first.astype(jnp.int32), axis=-1) - 1
    rank = jnp.where(sids != EMPTY, rank, KA * KB)     # EMPTY sorts last
    slots = jnp.arange(k_out, dtype=jnp.int32)
    start = jax.vmap(lambda r: jnp.searchsorted(r, slots, side="left"))(
        rank).astype(jnp.int32)
    end = jax.vmap(lambda r: jnp.searchsorted(r, slots, side="right"))(
        rank).astype(jnp.int32)
    cnt = end - start
    occ = jnp.take_along_axis(sids, jnp.minimum(start, KA * KB - 1),
                              axis=-1)
    occ = jnp.where(cnt > 0, occ, EMPTY).astype(jnp.int32)
    return occ, order, start, cnt


def _kernel(order_ref, start_ref, cnt_ref, acols_ref, ablk_ref, bblk_ref,
            scal_ref, out_ref, *, kb: int, tile: int):
    r = pl.program_id(0)
    j = pl.program_id(1)
    mi = pl.program_id(2)
    ni = pl.program_id(3)
    p0 = start_ref[r, j]

    def body(p, acc):
        m = order_ref[r, p0 + p]
        s = m // kb
        krow = acols_ref[r, s]
        a = ablk_ref[r, s, pl.ds(mi * tile, tile), :]
        b = bblk_ref[krow, m % kb, :, pl.ds(ni * tile, tile)]
        return acc + pl.dot(a, b, precision=lax.Precision.HIGHEST)

    acc = lax.fori_loop(0, cnt_ref[r, j], body,
                        jnp.zeros((tile, tile), jnp.float32))
    acc = acc * scal_ref[0]
    out_ref[r, j, pl.ds(mi * tile, tile), pl.ds(ni * tile, tile)] = \
        jnp.where(jnp.abs(acc) > scal_ref[1], acc, 0.0)


@functools.partial(jax.jit, static_argnames=("k_out", "interpret"))
def spgemm_triton(a_cols: Array, a_blocks: Array, b_cols: Array,
                  b_blocks: Array, *, k_out: int, threshold=0.0, alpha=1.0,
                  interpret: bool = False) -> Tuple[Array, Array]:
    """C = alpha * A @ B, threshold-filtered, on one shard (float32)."""
    R = a_cols.shape[0]
    KB = b_cols.shape[-1]
    bs = a_blocks.shape[-1]
    tile = min(TILE, bs)
    occ, order, start, cnt = plan(a_cols, b_cols, k_out)
    acols = jnp.where(a_cols != EMPTY, a_cols, 0).astype(jnp.int32)
    scal = jnp.stack([jnp.asarray(alpha, jnp.float32),
                      jnp.asarray(threshold, jnp.float32)])
    out = pl.pallas_call(
        functools.partial(_kernel, kb=KB, tile=tile),
        out_shape=jax.ShapeDtypeStruct((R, k_out, bs, bs), jnp.float32),
        grid=(R, k_out, bs // tile, bs // tile),
        interpret=interpret,
        backend=None if interpret else "triton",
        compiler_params=None if interpret else plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        name="bell_spgemm_triton",
    )(order, start, cnt, acols, a_blocks.astype(jnp.float32),
      b_blocks.astype(jnp.float32), scal)
    # a block whose every entry flushed is EMPTY in place (a hole), as in
    # bell.merge
    keep = jnp.sum(jnp.abs(out), axis=(-1, -2)) > 0
    return jnp.where(keep, occ, EMPTY), out.astype(a_blocks.dtype)
