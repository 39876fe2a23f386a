"""Block-ELL sparse kernels (single shard).

The on-device sparse format is *block-ELL*: the matrix is tiled into bs x bs
blocks; each block-row stores up to K blocks as

    col_ids : int32[..., R, K]        global block-column ids, ascending,
                                      EMPTY (2**30) marks an unused slot
    blocks  : dtype[..., R, K, bs, bs]

Invariants: non-EMPTY col ids of a row are ascending and unique, and an
EMPTY slot's block is all-zero.  EMPTY slots usually pack last, but
:func:`merge` marks below-threshold slots EMPTY *in place* (holes), so no
consumer may assume a dense prefix — use :func:`used_slots`, not
:func:`occupancy`, for capacity trims, and :func:`compact` to re-pack.

This plays the role NTPoly's local CSR + memory-pool layer plays
(reference: Source/Fortran/SMatrixModule.F90:15-31,
Source/Fortran/MatrixMemoryPoolModule.F90:13-56) but is designed for XLA:
static shapes (capacity K instead of dynamic nnz), batched bs x bs matmuls
(cuBLAS batched GEMMs on the GPU), and truncation implemented as masking +
compaction.  Leading batch dimensions (e.g. a column-panel axis) are
supported by every slot-wise op.

All functions are pure and jit-safe.  Scalars (alpha, beta, threshold) may be
traced; structural parameters (K, bs, chunk sizes) are static.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import EMPTY

Array = jax.Array

# Every contraction in this layer runs at full precision: on the GPU,
# HIGHEST keeps float32 products in true FP32 (no TF32 and no bf16
# passes).  NTPoly's convergence tolerances (1e-6) need it.
PRECISION = lax.Precision.HIGHEST


# ----------------------------------------------------------------------------
# small helpers
# ----------------------------------------------------------------------------

def _take_slots(cols: Array, blocks: Array, order: Array
                ) -> Tuple[Array, Array]:
    """Reorder the slot axis (last of cols, -3 of blocks) by ``order``."""
    c = jnp.take_along_axis(cols, order, axis=-1)
    b = jnp.take_along_axis(blocks, order[..., None, None], axis=-3)
    return c, b


def block_norms(blocks: Array) -> Array:
    """L1 norm of each block: [..., M, bs, bs] -> [..., M] (real)."""
    return jnp.sum(jnp.abs(blocks), axis=(-1, -2))


def pad_slots(cols: Array, blocks: Array, k: int) -> Tuple[Array, Array]:
    """Grow the slot axis to capacity ``k`` (no-op if already >= k)."""
    m = cols.shape[-1]
    if m >= k:
        return cols, blocks
    pc = [(0, 0)] * (cols.ndim - 1) + [(0, k - m)]
    pb = [(0, 0)] * (blocks.ndim - 3) + [(0, k - m), (0, 0), (0, 0)]
    return (jnp.pad(cols, pc, constant_values=EMPTY), jnp.pad(blocks, pb))


# ----------------------------------------------------------------------------
# compaction / merging — the truncation primitive
# ----------------------------------------------------------------------------

def compact(cols: Array, blocks: Array, k_out: int, threshold=0.0
            ) -> Tuple[Array, Array]:
    """Threshold + select blocks, restoring the format invariants.

    Entries with |v| <= threshold are flushed to zero (NTPoly's pruning rule,
    reference Source/Fortran/sparse_includes/PruneList.f90), all-zero blocks
    are dropped, and if more than ``k_out`` blocks survive in a row the
    largest (by block L1 norm) are kept.  Output slots are sorted by col id.

    cols: [..., M]; blocks: [..., M, bs, bs]
    -> ([..., k_out], [..., k_out, bs, bs])
    """
    blocks = jnp.where(jnp.abs(blocks) > threshold, blocks, 0)
    cols, blocks = pad_slots(cols, blocks, k_out)
    norms = block_norms(blocks)
    occupied = (norms > 0) & (cols != EMPTY)
    inf = jnp.asarray(jnp.inf, norms.dtype)
    rank_key = jnp.where(occupied, -norms, inf)
    # Both reorders (keep-largest selection, then ascending col ids) are
    # composed on the cheap [..., K] metadata first so the big block tensor
    # is gathered exactly ONCE (HBM traffic, not FLOPs, prices this op).
    order = jnp.argsort(rank_key, axis=-1)[..., :k_out]
    c = jnp.take_along_axis(cols, order, axis=-1)
    occ = jnp.take_along_axis(occupied, order, axis=-1)
    c = jnp.where(occ, c, EMPTY)
    order2 = jnp.argsort(c, axis=-1)
    final = jnp.take_along_axis(order, order2, axis=-1)
    b = jnp.take_along_axis(blocks, final[..., None, None], axis=-3)
    occ2 = jnp.take_along_axis(occ, order2, axis=-1)
    c2 = jnp.sort(c, axis=-1)
    return c2, b * occ2[..., None, None].astype(b.dtype)


def merge(cols: Array, blocks: Array, k_out: int, threshold=0.0
          ) -> Tuple[Array, Array]:
    """Sum blocks sharing a col id into ascending output slots — the k-way
    merge NTPoly performs when summing gathered CSR contributions
    (reference Source/Fortran/comm_includes/
    ReduceAndSumMatrixCleanup.f90:10-35).

    Accepts arbitrary slot order and duplicate col ids.  Sort- and
    gather-free: the output slot of each candidate is its count of
    distinct smaller ids (pairwise comparisons), and the dedup-sum + slot
    placement is ONE one-hot contraction over the block tensor.  On
    overflow (more than k_out distinct ids) the lowest col ids are kept.
    Below-threshold values flush to zero; slots whose whole block flushes
    are EMPTY in place (holes, not re-packed).
    """
    m = cols.shape[-1]
    valid = cols != EMPTY
    eq = cols[..., :, None] == cols[..., None, :]              # [..., M, M]
    earlier = jnp.arange(m)[:, None] > jnp.arange(m)[None, :]
    first = valid & ~jnp.any(eq & earlier, axis=-1)
    lt = cols[..., None, :] < cols[..., :, None]
    rank = jnp.sum((first[..., None, :] & lt).astype(jnp.int32), axis=-1)
    slot = jnp.where(valid, rank, k_out)
    oh = slot[..., None] == jnp.arange(k_out)                  # [..., M, K]
    out = jnp.einsum('...mk,...mij->...kij', oh.astype(blocks.dtype),
                     blocks, precision=PRECISION)
    hit = (rank[..., None] == jnp.arange(k_out)) & first[..., None]
    oc = jnp.min(jnp.where(hit, cols[..., :, None], EMPTY), axis=-2)
    out = jnp.where(jnp.abs(out) > threshold, out, 0)
    nm = jnp.sum(jnp.abs(out), axis=(-1, -2))
    oc = jnp.where(nm > 0, oc, EMPTY)
    return oc, out


def _candidate_ids(a_cols: Array, b_cols: Array) -> Array:
    """[R, KA*KB] output block-col id of every candidate product of
    A @ B (EMPTY for unused A slots / B slots)."""
    R, KA = a_cols.shape
    valid_a = a_cols != EMPTY
    ks = jnp.where(valid_a, a_cols, 0)
    ids = jnp.where(valid_a[:, :, None], b_cols[ks], EMPTY)   # [R, KA, KB]
    return ids.reshape(R, KA * b_cols.shape[-1])


def _first_occurrence(ids: Array) -> Array:
    """first[..., m] — ids[m] is valid and has no duplicate at m' < m,
    from an [..., M, M] pairwise comparison (M = KA*KB, small in the
    threshold-sparse regime)."""
    M = ids.shape[-1]
    eq = ids[..., :, None] == ids[..., None, :]               # [., M, M]
    earlier = (jnp.arange(M)[:, None] > jnp.arange(M)[None, :])
    dup = jnp.any(eq & earlier, axis=-1)
    return (ids != EMPTY) & ~dup


def structural_fill(a_cols: Array, b_cols: Array) -> Array:
    """Exact per-row structural fill-in of C = A @ B from col ids alone.

    fill[r] = number of distinct output block-columns of row r (before any
    threshold pruning) — the capacity a lossless multiply needs, which
    sizes the output up front the way NTPoly grows its memory pool
    (reference sparse_includes/GemmMatrix.f90:48-56).
    """
    ids = _candidate_ids(a_cols, b_cols)
    return jnp.sum(_first_occurrence(ids).astype(jnp.int32), axis=-1)


def union_fill(a_cols: Array, b_cols: Array) -> Array:
    """Exact per-row structural fill of A + B: distinct non-EMPTY col ids
    in the union of the two slot sets.  [..., KA], [..., KB] -> [...]."""
    return union_fill_n([a_cols, b_cols])


def union_fill_n(cols_list) -> Array:
    """Exact per-row structural fill of an N-operand sum."""
    ids = jnp.concatenate(list(cols_list), axis=-1)
    sids = jnp.sort(ids, axis=-1)
    prev = jnp.concatenate(
        [jnp.full(sids.shape[:-1] + (1,), -1, sids.dtype), sids[..., :-1]],
        axis=-1)
    first = (sids != prev) & (sids != EMPTY)
    return jnp.sum(first.astype(jnp.int32), axis=-1)


def occupancy(cols: Array) -> Array:
    """Per-row count of occupied slots: [..., K] -> [...]."""
    return jnp.sum((cols != EMPTY).astype(jnp.int32), axis=-1)


def used_slots(cols: Array) -> Array:
    """Highest occupied slot index + 1: [..., K] -> [...].

    Equals :func:`occupancy` when slots are packed (EMPTY last), but stays
    correct for hole-bearing layouts (:func:`merge` marks flushed slots
    EMPTY in place) — capacity trims must use this, not occupancy."""
    k = cols.shape[-1]
    idx = jnp.where(cols != EMPTY, jnp.arange(1, k + 1, dtype=jnp.int32), 0)
    return jnp.max(idx, axis=-1) if k else jnp.zeros(cols.shape[:-1],
                                                     jnp.int32)


def add(a_cols: Array, a_blocks: Array, b_cols: Array, b_blocks: Array,
        alpha=1.0, beta=1.0, threshold=0.0, k_out: int | None = None
        ) -> Tuple[Array, Array]:
    """alpha*A + beta*B with threshold flush (NTPoly IncrementMatrix,
    reference Source/Fortran/sparse_includes/IncrementMatrix.f90)."""
    return add_n([a_cols, b_cols], [a_blocks, b_blocks], [alpha, beta],
                 threshold=threshold, k_out=k_out)


def add_n(cols_list, blocks_list, coeffs, threshold=0.0,
          k_out: int | None = None) -> Tuple[Array, Array]:
    """sum_i coeffs[i] * M_i over N operands in ONE k-way merge.

    A chain of two-operand :func:`add` calls materializes a full-capacity
    intermediate per link (e.g. TRS4's three-term polynomial and clamp
    combination each cost one extra ~k_out-wide matrix — 2.7 GB live at
    the 2^20-row bench shape); fusing the chain concatenates all operands'
    slots once and runs the same rank/one-hot merge.  Coefficients may be
    traced scalars (the chunked solvers' sigma-selected coefficients)."""
    if k_out is None:
        k_out = max(c.shape[-1] for c in cols_list)
    dt = jnp.result_type(*[b.dtype for b in blocks_list])
    cols = jnp.concatenate(list(cols_list), axis=-1)
    blocks = jnp.concatenate(
        [b.astype(dt) * jnp.asarray(a, dt)
         for b, a in zip(blocks_list, coeffs)], axis=-3)
    return merge(cols, blocks, k_out, threshold)


# ----------------------------------------------------------------------------
# SpGEMM — dense-accumulator Gustavson at block granularity
# ----------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.partial(
    jax.jit, static_argnames=("nbc_out", "k_out", "row_chunk"))
def spgemm(a_cols: Array, a_blocks: Array, b_cols: Array, b_blocks: Array,
           *, col_offset, nbc_out: int, k_out: int,
           threshold=0.0, alpha=1.0, row_chunk: int = 8
           ) -> Tuple[Array, Array]:
    """C = alpha * A @ B, threshold-filtered, on one shard.

    A: [R, KA] slots whose col ids index block-rows of B (global ids).
    B: [NBK, KB] slots whose col ids are global block-cols restricted to the
       output panel [col_offset, col_offset + nbc_out).
    Returns C as [R, k_out] block-ELL with global col ids.

    Redesign of NTPoly's Gustavson SpGEMM with pooled dense accumulator
    (reference Source/Fortran/sparse_includes/MultiplyBlock.f90:8-36
    + PruneList.f90): rows are processed in chunks, each chunk scattering
    bs x bs partial products into a dense (chunk, nbc_out) block accumulator
    via one-hot contractions, then the accumulator is thresholded and
    compacted back to block-ELL.  The accumulator holds
    ``row_chunk * nbc_out * bs * bs`` elements and the one-hot scatter
    costs FLOPs in proportion to ``nbc_out``, so this tier only suits
    narrow panels (see ``parallel/algebra._pick_method``).
    """
    R, KA = a_cols.shape
    bs = a_blocks.shape[-1]
    dt = jnp.result_type(a_blocks.dtype, b_blocks.dtype)
    alpha = jnp.asarray(alpha, dt)

    Rp = _round_up(max(R, 1), row_chunk)
    if Rp != R:
        a_cols = jnp.pad(a_cols, ((0, Rp - R), (0, 0)), constant_values=EMPTY)
        a_blocks = jnp.pad(a_blocks, ((0, Rp - R), (0, 0), (0, 0), (0, 0)))
    nchunks = Rp // row_chunk
    ac = a_cols.reshape(nchunks, row_chunk, KA)
    ab = a_blocks.reshape(nchunks, row_chunk, KA, bs, bs)

    col_range = jnp.arange(nbc_out, dtype=jnp.int32)

    def do_chunk(operands):
        acc_cols, acc_blocks = operands   # [C,KA], [C,KA,bs,bs]
        C = acc_cols.shape[0]

        def step(s, acc):
            k = acc_cols[:, s]
            valid = k != EMPTY
            ks = jnp.where(valid, k, 0)
            bc = b_cols[ks]                       # [C, KB]
            bb = b_blocks[ks]                     # [C, KB, bs, bs]
            part = jnp.einsum('cij,ctjk->ctik', acc_blocks[:, s].astype(dt),
                              bb.astype(dt), precision=PRECISION)
            tval = (bc != EMPTY) & valid[:, None]
            loc = jnp.where(tval, bc - col_offset, 0)
            oh = ((loc[..., None] == col_range) & tval[..., None]).astype(dt)
            return acc + jnp.einsum('ctn,ctik->cnik', oh, part,
                                    precision=PRECISION)

        acc = lax.fori_loop(
            0, KA, step, jnp.zeros((C, nbc_out, bs, bs), dt))
        acc = acc * alpha
        out_cols = jnp.broadcast_to(col_range + col_offset, (C, nbc_out))
        cc, cb = compact(out_cols, acc, k_out, threshold)
        return cc, cb

    cc, cb = lax.map(do_chunk, (ac, ab))
    cc = cc.reshape(Rp, k_out)[:R]
    cb = cb.reshape(Rp, k_out, bs, bs)[:R]
    return cc, cb


@functools.partial(
    jax.jit, static_argnames=("k_out", "row_chunk"))
def spgemm_candidates(a_cols: Array, a_blocks: Array, b_cols: Array,
                      b_blocks: Array, *, col_offset, k_out: int,
                      threshold=0.0, alpha=1.0, row_chunk: int = 16
                      ) -> Tuple[Array, Array]:
    """C = alpha * A @ B via explicit partial products + k-way merge.

    For each A slot (r, s) the full B block-row k = a_cols[r, s] is gathered
    and multiplied, giving KA*KB candidate blocks per row that
    :func:`merge` then combines.  Avoids the dense accumulator's wide
    one-hot scatter — the right trade when KA*KB is small (banded/threshold
    -sparse matrices), which is NTPoly's entire regime.  Same contract as
    :func:`spgemm`; ``col_offset`` only biases nothing here since candidate
    ids are taken from B directly (kept for signature parity).
    """
    R, KA = a_cols.shape
    KB = b_cols.shape[-1]
    bs = a_blocks.shape[-1]
    dt = jnp.result_type(a_blocks.dtype, b_blocks.dtype)
    alpha = jnp.asarray(alpha, dt)

    Rp = _round_up(max(R, 1), row_chunk)
    if Rp != R:
        a_cols = jnp.pad(a_cols, ((0, Rp - R), (0, 0)),
                         constant_values=EMPTY)
        a_blocks = jnp.pad(a_blocks, ((0, Rp - R), (0, 0), (0, 0), (0, 0)))
    nchunks = Rp // row_chunk
    ac = a_cols.reshape(nchunks, row_chunk, KA)
    ab = a_blocks.reshape(nchunks, row_chunk, KA, bs, bs)

    def do_chunk(operands):
        cc, cb = operands                     # [C,KA], [C,KA,bs,bs]
        valid = cc != EMPTY
        ks = jnp.where(valid, cc, 0)
        bc = b_cols[ks]                       # [C,KA,KB]
        bb = b_blocks[ks]                     # [C,KA,KB,bs,bs]
        parts = jnp.einsum('csij,cstjk->cstik', cb.astype(dt),
                           bb.astype(dt), precision=PRECISION) * alpha
        cand_cols = jnp.where(valid[..., None] & (bc != EMPTY), bc, EMPTY)
        C = cc.shape[0]
        cand_cols = cand_cols.reshape(C, KA * KB)
        parts = parts.reshape(C, KA * KB, bs, bs)
        return merge(cand_cols, parts, k_out, threshold)

    oc, ob = lax.map(do_chunk, (ac, ab))
    return (oc.reshape(Rp, k_out)[:R],
            ob.reshape(Rp, k_out, bs, bs)[:R])


def spgemm_dense(a_cols, a_blocks, b_cols, b_blocks, *, col_offset, nbc_out,
                 k_out, nbk, threshold=0.0, alpha=1.0):
    """Dense fast path: densify both operands, one big matmul, re-sparsify.

    Analogue of NTPoly's density-heuristic dense branch
    (reference Source/Fortran/sparse_includes/DenseBranch.f90).
    ``nbk`` is the contraction depth in blocks (B's block-row count).
    """
    dt = jnp.result_type(a_blocks.dtype, b_blocks.dtype)
    ad = to_dense(a_cols, a_blocks, nbc=nbk, col_offset=0)
    bd = to_dense(b_cols, b_blocks, nbc=nbc_out, col_offset=col_offset)
    cd = jnp.asarray(alpha, dt) * jnp.matmul(
        ad.astype(dt), bd.astype(dt), precision=PRECISION)
    cd = jnp.where(jnp.abs(cd) > threshold, cd, 0)
    bs = a_blocks.shape[-1]
    return from_dense(cd, bs=bs, k=k_out, col_offset=col_offset)


# ----------------------------------------------------------------------------
# dense <-> block-ELL
# ----------------------------------------------------------------------------

def to_dense(cols: Array, blocks: Array, nbc: int, col_offset: int = 0
             ) -> Array:
    """[R, K] block-ELL -> dense [R*bs, nbc*bs], cols shifted by
    col_offset."""
    R, K = cols.shape[-2:]
    bs = blocks.shape[-1]
    loc = cols - col_offset
    valid = (cols != EMPTY) & (loc >= 0) & (loc < nbc)
    oh = ((loc[..., None] == jnp.arange(nbc)) & valid[..., None])
    dense = jnp.einsum('...rkn,...rkij->...rinj', oh.astype(blocks.dtype),
                       blocks, precision=PRECISION)
    return dense.reshape(dense.shape[:-4] + (R * bs, nbc * bs))


def from_dense(dense: Array, bs: int, k: int, col_offset: int = 0,
               threshold=0.0) -> Tuple[Array, Array]:
    """Dense [M, N] (M, N multiples of bs) -> block-ELL [M/bs, k]."""
    M, N = dense.shape[-2:]
    assert M % bs == 0 and N % bs == 0, (M, N, bs)
    R, nbc = M // bs, N // bs
    blocks = dense.reshape(dense.shape[:-2] + (R, bs, nbc, bs))
    blocks = jnp.swapaxes(blocks, -3, -2)         # [..., R, nbc, bs, bs]
    cols = jnp.broadcast_to(jnp.arange(nbc, dtype=jnp.int32)
                            + col_offset,
                            blocks.shape[:-3] + (nbc,))
    return compact(cols, blocks, k, threshold)


# ----------------------------------------------------------------------------
# slot-wise algebra
# ----------------------------------------------------------------------------

def filter_small(cols, blocks, threshold, k_out=None):
    """Drop |v| <= threshold (NTPoly FilterMatrix,
    reference Source/Fortran/PSMatrixModule.F90:1318-1359)."""
    k_out = cols.shape[-1] if k_out is None else k_out
    return compact(cols, blocks, k_out, threshold)


def trace_blocks(cols: Array, blocks: Array, row_offset: int = 0) -> Array:
    """Extract diagonal blocks: [..., R, K] -> [..., R, bs, bs].

    Global block-row id of local row r is ``row_offset + r``.
    """
    R = cols.shape[-2]
    rows = jnp.arange(R) + row_offset
    hit = (cols == rows[..., :, None]).astype(blocks.dtype)
    return jnp.einsum('...rk,...rkij->...rij', hit, blocks,
                      precision=PRECISION)


def trace(cols, blocks, row_offset: int = 0) -> Array:
    d = trace_blocks(cols, blocks, row_offset)
    return jnp.trace(d, axis1=-2, axis2=-1).sum()


def align(a_cols, b_cols, b_blocks) -> Array:
    """B's blocks gathered onto A's slot structure: [..., KA, bs, bs] where
    slot s holds the B block with A's col id (0 if B has none).  The
    primitive behind snap-to-sparsity-pattern (reference
    MatrixConversionModule.F90:21-63)."""
    matchm = (a_cols[..., :, None] == b_cols[..., None, :]) \
        & (a_cols != EMPTY)[..., :, None]                     # [..., KA, KB]
    dt = b_blocks.dtype
    return jnp.einsum('...st,...tij->...sij', matchm.astype(dt),
                      b_blocks, precision=PRECISION)


def align_mul(a_cols, a_blocks, b_cols, b_blocks) -> Array:
    """Hadamard product on the intersection pattern.

    Returns blocks aligned to A's slots: [..., KA, bs, bs] where slot s holds
    A_s * B_t for the B slot t with the same col id (0 if none).
    (NTPoly PairwiseMultiplyMatrix, reference
    Source/Fortran/SMatrixAlgebraModule.F90:85-360.)
    """
    matchm = (a_cols[..., :, None] == b_cols[..., None, :]) \
        & (a_cols != EMPTY)[..., :, None]                     # [..., KA, KB]
    dt = jnp.result_type(a_blocks.dtype, b_blocks.dtype)
    b_at_a = jnp.einsum('...st,...tij->...sij', matchm.astype(dt),
                        b_blocks.astype(dt), precision=PRECISION)
    return a_blocks.astype(dt) * b_at_a


def dot(a_cols, a_blocks, b_cols, b_blocks) -> Array:
    """sum_ij conj(A_ij) * B_ij on one shard (NTPoly DotMatrix semantics,
    reference Source/Fortran/distributed_algebra_includes/DotMatrix.f90 —
    complex variant conjugates A)."""
    prod = align_mul(a_cols, jnp.conj(a_blocks), b_cols, b_blocks)
    return jnp.sum(prod)


def grand_sum(blocks: Array) -> Array:
    return jnp.sum(blocks)


def comp_sum(x: Array) -> Array:
    """Compensated sum of all elements -> [2] (hi, lo) two-float pair.

    Pairwise reduction where every level's rounding error is captured
    exactly by a two-sum (Knuth) and carried in a parallel lo array:
    hi + lo carries the sum to ~n*eps^2 instead of f32's n*eps.  All
    levels are full-width elementwise passes (log2(n) of them, total
    traffic ~4x one streaming pass) — no serial scan, so this prices at a
    few extra memory passes even at 10^8 elements.

    Purpose: f32 energy traces at the
    2^20-row scale quantize at ~eps*|E| (~0.01 absolute), so convergence
    below that is uncertifiable no matter how the sum is ordered.  The
    (hi, lo) pair resolves the value to ~eps^2*|E|; the host combines
    the pair in float64.  The matmul stream stays f32 — only the scalar
    reductions feeding the convergence monitor pay the extra passes.
    """
    hi = jnp.ravel(x)
    lo = jnp.zeros_like(hi)
    n = hi.shape[0]
    while n > 1:
        m = (n + 1) // 2
        if 2 * m != n:
            hi = jnp.pad(hi, (0, 2 * m - n))
            lo = jnp.pad(lo, (0, 2 * m - n))
        a, b = hi[:m], hi[m:]
        s = a + b
        bb = s - a
        err = (a - (s - bb)) + (b - bb)
        hi = s
        lo = lo[:m] + lo[m:] + err
        n = m
    return jnp.concatenate([hi, lo])


def col_abs_sums(cols: Array, blocks: Array, nbc: int) -> Array:
    """Per-column sums of |v|: -> [..., nbc, bs] (for 1-norms / Gershgorin)."""
    persl = jnp.sum(jnp.abs(blocks), axis=-2)     # [..., R, K, bs]
    valid = (cols != EMPTY)
    loc = jnp.where(valid, cols, 0)
    oh = ((loc[..., None] == jnp.arange(nbc)) & valid[..., None])
    out = jnp.einsum('...rkn,...rkj->...nj', oh.astype(persl.dtype),
                     persl, precision=PRECISION)
    return out


def diagonal_scale(cols, blocks, dvec_rows=None, dvec_cols=None):
    """Scale rows by dvec_rows[..., R, bs] and/or cols by dvec_cols[nbc, bs].

    (NTPoly MatrixDiagonalScale, reference
    Source/Fortran/SMatrixAlgebraModule.F90:536-559.)
    """
    out = blocks
    if dvec_rows is not None:
        out = out * dvec_rows[..., :, None, :, None]
    if dvec_cols is not None:
        valid = cols != EMPTY
        loc = jnp.where(valid, cols, 0)
        dc = dvec_cols[loc] * valid[..., None]     # [..., R, K, bs]
        out = out * dc[..., None, :]
    return out


# ----------------------------------------------------------------------------
# COO <-> block-ELL (transpose / construction machinery)
# ----------------------------------------------------------------------------

def to_block_coo(cols: Array, blocks: Array, row_offset: int = 0):
    """Flatten [R, K] slots to block-COO (rows, cols, blocks, valid)."""
    R, K = cols.shape
    bs = blocks.shape[-1]
    rows = jnp.broadcast_to((jnp.arange(R, dtype=jnp.int32)
                             + row_offset)[:, None], (R, K))
    valid = cols != EMPTY
    return (rows.reshape(-1), cols.reshape(-1),
            blocks.reshape(R * K, bs, bs), valid.reshape(-1))


def from_block_coo(rows: Array, cols: Array, blocks: Array, valid: Array,
                   *, nbr: int, k: int, panels: int = 1,
                   panel_nbc: int | None = None) -> Tuple[Array, Array]:
    """Build block-ELL [panels, nbr, k] from flat block-COO (1D arrays).

    Blocks must have unique (row, col); overflow beyond capacity ``k`` in a
    row is dropped (callers pick k large enough).  When ``panels > 1`` the
    output is split by column panel ``col // panel_nbc``.
    """
    bs = blocks.shape[-1]
    rows = jnp.where(valid, rows, nbr)            # out-of-range -> dropped
    if panels > 1:
        assert panel_nbc is not None
        p = jnp.where(valid, cols // panel_nbc, 0)
    else:
        p = jnp.zeros_like(rows)
    # Lexicographic (panel, row, col) order via two stable argsorts — avoids
    # wide integer keys (int64 is unavailable without jax_enable_x64).
    colkey = jnp.where(valid, cols, EMPTY)
    order1 = jnp.argsort(colkey, stable=True)
    grp = p * (nbr + 1) + rows
    order = order1[jnp.argsort(grp[order1], stable=True)]
    sp, sr, sc = p[order], rows[order], cols[order]
    sb = blocks[order]
    sv = valid[order]
    n = rows.shape[0]
    grp = sp * (nbr + 1) + sr
    prev = jnp.concatenate([jnp.full((1,), -1, grp.dtype), grp[:-1]])
    row_first = grp != prev
    idx = jnp.arange(n)
    start = lax.cummax(jnp.where(row_first, idx, 0))
    slot = idx - start
    slot = jnp.where(sv, slot, k)                 # invalid -> dropped
    out_cols = jnp.full((panels, nbr, k), EMPTY, jnp.int32)
    out_cols = out_cols.at[sp, sr, slot].set(sc.astype(jnp.int32),
                                             mode='drop')
    out_blocks = jnp.zeros((panels, nbr, k, bs, bs), blocks.dtype)
    out_blocks = out_blocks.at[sp, sr, slot].set(sb, mode='drop')
    return out_cols, out_blocks


def transpose_blocks(blocks: Array) -> Array:
    """Transpose within each block (no conjugation)."""
    return jnp.swapaxes(blocks, -1, -2)
