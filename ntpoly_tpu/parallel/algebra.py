"""Distributed algebra on PSMatrix.

JAX counterpart of NTPoly's distributed algebra layer
(reference Source/Fortran/PSMatrixAlgebraModule.F90 +
distributed_algebra_includes/).  The 3D SUMMA SpGEMM maps the reference's
MPI pipeline (reference distributed_algebra_includes/MatrixMultiply.f90) onto
mesh collectives under ``jax.shard_map``:

    IAllGather of A block-rows on row_comm    -> all_gather along 'cols'
    IAllGather of B block-cols on column_comm -> all_gather along 'rows'
    slice split-k + ReduceAndSumMatrix        -> slot masking (col % S == s),
                                                 all_gather along 'slices'
                                                 + k-way threshold merge
    OpenMP task/poll state machine            -> XLA async scheduling

The reference's working-threshold rule is preserved: with S slices the local
multiplies prune at threshold/(S*1000) and the full threshold is applied only
on the final slice sum (reference MatrixMultiply.f90:23-29,
comm_includes/ReduceAndSumMatrixCleanup.f90:26-31).
"""
from __future__ import annotations

import contextlib
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from ..config import EMPTY
from ..core import bell
from ..ops import spgemm_triton
from .pmatrix import PSMatrix, empty, identity
from .grid import ProcessGrid


def _concrete_int(x) -> int | None:
    """int(x) when x is concrete, None under a jit trace (so capacity-grow
    loops degrade to fixed-capacity behavior inside compiled code)."""
    if isinstance(x, jax.core.Tracer):
        return None
    return int(x)


# ----------------------------------------------------------------------------
# ambient capacity policy
# ----------------------------------------------------------------------------

_policy = threading.local()


def _policy_get(attr):
    return getattr(_policy, attr, None)


@contextlib.contextmanager
def capacity_policy(k_out: int | None = None, row_chunk: int | None = None,
                    on_overflow: str | None = None, collect=None,
                    precision: str | None = None,
                    method: str | None = None, defer: bool = False):
    """Ambient capacity defaults for matmul/increment/transpose.

    Solvers install this from SolverParameters.k_out / row_chunk: pinning
    the output capacity keeps iteration shapes static, so XLA compiles
    each op once instead of once per fill-in level (the role NTPoly's
    preallocated memory pool plays, GemmMatrix.f90:48-56 — there for
    allocation cost, here for compilation cost).

    ``collect``: a list that every capacity-bounded op appends its exact
    structural-fill requirement to (a traced scalar under jit).  The
    chunked solver driver threads the max through its scan carry so
    truncation is *detected*, never silent (the reference's pool never
    drops entries, GemmMatrix.f90:48-56).

    ``precision``: the solvers' precision knob, checked here
    (:func:`check_precision`).  It changes no arithmetic: every multiply
    tier runs float32 at FP32 (``bell.PRECISION``).

    ``defer``: overflow checks in non-growing modes are queued as DEVICE
    scalars instead of forcing a per-op host readback (each one stalls
    the eager dispatch pipeline) and materialized in ONE sync by
    :func:`drain_deferred_checks` when the policy exits — detection at
    solve granularity instead of op granularity.  Solvers install this
    for the duration of a solve (solver_log)."""
    if precision is not None:
        check_precision(precision)
    prev = (_policy_get("k_out"), _policy_get("row_chunk"),
            _policy_get("on_overflow"), _policy_get("collect"),
            _policy_get("method"), _policy_get("defer"))
    (_policy.k_out, _policy.row_chunk, _policy.on_overflow,
     _policy.collect, _policy.method, _policy.defer) = (
        k_out, row_chunk, on_overflow, collect, method, defer)
    try:
        yield
    finally:
        (_policy.k_out, _policy.row_chunk, _policy.on_overflow,
         _policy.collect, _policy.method, _policy.defer) = prev
        if defer and not _policy_get("defer"):
            drain_deferred_checks()


# deferred (device-side) overflow checks: entries are
# (device int32 need, capacity, op label)
_pending_checks: list = []


def _defer_check(need, cap_k, op: str):
    _pending_checks.append((need, cap_k, op))
    if len(_pending_checks) >= 512:       # backstop if never drained
        drain_deferred_checks()


def drain_deferred_checks():
    """Materialize every deferred overflow check in ONE host sync: one
    warning per truncating op whose exact structural fill exceeded its
    capacity."""
    import warnings
    global _pending_checks
    if not _pending_checks:
        return
    pend, _pending_checks = _pending_checks, []
    vals = np.asarray(jnp.stack(
        [jnp.asarray(p[0], jnp.int32) for p in pend]))     # ONE sync
    for (_, cap_k, op), v in zip(pend, vals):
        if v > cap_k:
            warnings.warn(f"{op}: structural fill {int(v)} exceeds "
                          f"capacity {cap_k} — result truncated")


# Precision names the solvers accept.  Every multiply tier runs float32
# at FP32 (lax.Precision.HIGHEST) whichever is named; the name only
# selects the convergence functional (solvers/density._metric).
PRECISIONS = ("high", "highest")


def check_precision(precision: str) -> str:
    """Validate a precision name; 'bf16' and unknown names raise."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision {precision!r} is not supported: every multiply "
            f"runs at FP32; choose one of {PRECISIONS}")
    return precision

__all__ = [
    "matmul", "increment", "scale", "trace", "dot",
    "norm", "grand_sum",
    "pairwise_multiply", "filter_small", "transpose", "conjugate",
    "diagonal_scale", "measure_asymmetry", "symmetrize",
    "similarity_transform", "column_sums", "gershgorin_bounds", "spmv",
    "spmm", "matrix_sigma", "load_balance", "capacity_policy", "fill_bound",
]


# ----------------------------------------------------------------------------
# SpGEMM
# ----------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("grid", "pnb", "k_out", "s_slices", "row_chunk",
                     "method", "want_fill"))
def _summa(a_cols, a_blocks, b_cols, b_blocks, alpha, working_thresh,
           final_thresh, *, grid: ProcessGrid, pnb: int, k_out: int,
           s_slices: int, row_chunk: int, method: str = "cand",
           want_fill: bool = True):
    bs = a_blocks.shape[-1]
    pc = grid.cols

    def local_fn(ac, ab, bc, bb):
        nbr_loc = ac.shape[1]
        ka, kb = ac.shape[-1], bc.shape[-1]
        # Row panel of A: gather my block-rows' column panels over 'cols'.
        agc = lax.all_gather(ac[0], "cols", axis=0)       # [Pc, nbr, KA]
        agb = lax.all_gather(ab[0], "cols", axis=0)
        agc = jnp.moveaxis(agc, 0, 1).reshape(nbr_loc, pc * ka)
        agb = jnp.moveaxis(agb, 0, 1).reshape(nbr_loc, pc * ka, bs, bs)
        # Column panel of B: gather all block-rows of my panel over 'rows'.
        bgc = lax.all_gather(bc[0], "rows", axis=0, tiled=True)  # [NB, KB]
        bgb = lax.all_gather(bb[0], "rows", axis=0, tiled=True)
        # Exact structural fill-in (pre split-k masking) — the capacity a
        # lossless multiply needs; max-reduced over the mesh so the caller
        # can regrow k_out instead of silently truncating.
        if want_fill:
            fill = jnp.max(bell.structural_fill(agc, bgc))
        else:
            fill = jnp.int32(0)
        if s_slices > 1:
            s = lax.axis_index("slices")
            keep = (agc != EMPTY) & (agc % s_slices == s)
            agc = jnp.where(keep, agc, EMPTY)
            agb = agb * keep[..., None, None].astype(agb.dtype)
        c0 = lax.axis_index("cols") * pnb
        if method == "dense":
            cc, cb = bell.spgemm_dense(
                agc, agb, bgc, bgb, col_offset=c0, nbc_out=pnb, k_out=k_out,
                nbk=bgc.shape[0], threshold=working_thresh, alpha=alpha)
        elif method == "cand":
            cc, cb = bell.spgemm_candidates(
                agc, agb, bgc, bgb, col_offset=c0, k_out=k_out,
                threshold=working_thresh, alpha=alpha, row_chunk=row_chunk)
        elif method == "triton":
            cc, cb = spgemm_triton.spgemm_triton(
                agc, agb, bgc, bgb, k_out=k_out, threshold=working_thresh,
                alpha=alpha, interpret=_platform(grid) == "cpu")
        elif method == "acc":
            cc, cb = bell.spgemm(
                agc, agb, bgc, bgb, col_offset=c0, nbc_out=pnb, k_out=k_out,
                threshold=working_thresh, alpha=alpha, row_chunk=row_chunk)
        else:
            raise ValueError(f"unknown matmul method {method!r}")
        if s_slices > 1:
            gc = lax.all_gather(cc, "slices", axis=0)     # [S, nbr, k]
            gb = lax.all_gather(cb, "slices", axis=0)
            gc = jnp.moveaxis(gc, 0, 1).reshape(nbr_loc, s_slices * k_out)
            gb = jnp.moveaxis(gb, 0, 1).reshape(
                nbr_loc, s_slices * k_out, bs, bs)
            cc, cb = bell.merge(gc, gb, k_out, final_thresh)
        # one int32[2] readback covers both the capacity check (structural
        # fill) and the trim decision (highest used slot — the slice merge
        # leaves holes, so occupancy would under-count)
        stats = jnp.stack([fill, jnp.max(bell.used_slots(cc))])
        stats = lax.pmax(stats, ("rows", "cols", "slices"))
        return cc[None], cb[None], stats

    spec_c = P("cols", "rows", None)
    spec_b = P("cols", "rows", None, None, None)
    return jax.shard_map(
        local_fn, mesh=grid.mesh,
        in_specs=(spec_c, spec_b, spec_c, spec_b),
        out_specs=(spec_c, spec_b, P(None)), check_vma=False,
    )(a_cols, a_blocks, b_cols, b_blocks)


def _platform(grid: ProcessGrid) -> str:
    return grid.mesh.devices.flat[0].platform


def _k_bucket(n: int, cap: int) -> int:
    """Round capacity up to a multiple of 4 to bound recompilation."""
    return min(-(-max(n, 1) // 4) * 4, cap)


# Dispatch gates of _pick_method, set from tier timings on one H100
# (PERF.md, "Bring-up on H100").
# dense: both operands fill at least this share of their block-columns
# (the densified GEMM crossed the XLA cand tier between 50% and 62.5%
# occupancy, and the GPU kernel between 75% and 100%).
DENSE_OCCUPANCY = 0.55
DENSE_OCCUPANCY_KERNEL = 0.8
# cand: bound on its per-chunk candidate tensor
# (row_chunk * KA*KB * bs * bs elements).
CAND_MAX_BYTES = 8 << 30
# acc: bound on its per-chunk dense accumulator
# (row_chunk * panel_nb * bs * bs elements).
ACC_MAX_BYTES = 256 << 20


def _default_row_chunk(a: PSMatrix) -> int:
    return max(1, min(8, a.nb // a.grid.rows))


def _pick_method(a: PSMatrix, b: PSMatrix,
                 row_chunk: int | None = None) -> str:
    """The density-heuristic dispatch (analogue of reference
    sparse_includes/GemmMatrix.f90:58-61 + DenseBranch.f90):

      * 'triton' on a GPU for float32 blocks (ops/spgemm_triton.py): the
        block products of each output block in one kernel, no candidate
        tensor in memory — 'dense' instead once both operands fill
        DENSE_OCCUPANCY_KERNEL of their block-columns;
      * 'dense' once both operands fill DENSE_OCCUPANCY of their
        block-columns: one large GEMM beats the batched block products;
      * 'cand' otherwise (CPU, complex, float64): explicit block products
        + k-way merge, whose merge costs FLOPs in proportion to k_out;
      * 'acc' only where cand's candidate tensor would exceed
        CAND_MAX_BYTES and acc's accumulator is both smaller and within
        ACC_MAX_BYTES.  acc never beat cand on the card; its one-hot
        scatter costs FLOPs in proportion to the panel width and its
        accumulator is row_chunk x panel_nb x bs x bs (4.3 GB at 2^20
        rows, bs=128), so a wide panel never goes there.
    """
    dt = jnp.result_type(a.dtype, b.dtype)
    kernel = (_platform(a.grid) == "gpu"
              and spgemm_triton.eligible(dt, a.bs))
    gate = DENSE_OCCUPANCY_KERNEL if kernel else DENSE_OCCUPANCY
    if min(a.k, b.k) >= gate * a.nb:
        return "dense"
    if kernel:
        return "triton"
    row_chunk = row_chunk or _default_row_chunk(a)
    blk = a.bs * a.bs * jnp.dtype(dt).itemsize
    cand_bytes = row_chunk * a.grid.cols * a.k * b.k * blk
    acc_bytes = row_chunk * a.panel_nb * blk
    if (cand_bytes > CAND_MAX_BYTES and acc_bytes < cand_bytes
            and acc_bytes <= ACC_MAX_BYTES):
        return "acc"
    return "cand"


@functools.partial(jax.jit, static_argnames=("grid",))
def _fill_bound_jit(a_cols, b_cols, *, grid: ProcessGrid):
    pc = grid.cols

    def local_fn(ac, bc):
        nbr_loc = ac.shape[1]
        ka = ac.shape[-1]
        agc = lax.all_gather(ac[0], "cols", axis=0)
        agc = jnp.moveaxis(agc, 0, 1).reshape(nbr_loc, pc * ka)
        bgc = lax.all_gather(bc[0], "rows", axis=0, tiled=True)
        fill = jnp.max(bell.structural_fill(agc, bgc))
        return lax.pmax(fill, ("rows", "cols", "slices"))

    spec_c = P("cols", "rows", None)
    return jax.shard_map(
        local_fn, mesh=grid.mesh, in_specs=(spec_c, spec_c),
        out_specs=P(), check_vma=False)(a_cols, b_cols)


def fill_bound(a: PSMatrix, b: PSMatrix) -> int:
    """Exact structural capacity A @ B needs (max per-panel-row fill-in) —
    the equivalent of sizing NTPoly's memory pool up front
    (reference sparse_includes/GemmMatrix.f90:48-56)."""
    return int(_fill_bound_jit(a.col_ids, b.col_ids, grid=a.grid))


def matmul(a: PSMatrix, b: PSMatrix, alpha=1.0, beta=0.0,
           c: PSMatrix | None = None, threshold=0.0,
           k_out: int | None = None, row_chunk: int | None = None,
           method: str = "auto",
           on_overflow: str | None = None,
           precision: str | None = None) -> PSMatrix:
    """C = alpha*A@B + beta*C, threshold-filtered 3D SUMMA.

    (reference PSMatrixAlgebraModule.F90:106-269.)

    method: 'triton' = the GPU kernel (ops/spgemm_triton.py; interpret
    mode on CPU), 'acc' = dense-accumulator Gustavson, 'cand' = explicit
    partial products + k-way merge, 'dense' = densify + one GEMM, 'auto'
    picks (:func:`_pick_method`) — the analogue of the reference's density
    heuristic (sparse_includes/GemmMatrix.f90:58-61).  Every tier
    multiplies at FP32 (``bell.PRECISION``); ``precision`` is validated
    (:func:`check_precision`) and changes no arithmetic.

    on_overflow: every multiply measures the exact structural fill-in; if
    it exceeds the output capacity ``k_out``, 'grow' (default) re-runs with
    enough capacity — the reference's memory pool never drops
    above-threshold entries either (GemmMatrix.f90:48-56).  'truncate'
    keeps the current capacity ('acc' and 'dense' keep the largest-norm
    blocks, 'cand' and 'triton' the lowest column ids) and stays
    trace-safe for use under jit.
    """
    assert a.grid == b.grid and a.nb == b.nb and a.bs == b.bs
    s = a.grid.slices
    cap = a.panel_nb
    k_out = min(k_out or _policy_get("k_out") or max(a.k, b.k), cap)
    on_overflow = on_overflow or _policy_get("on_overflow") or "grow"
    row_chunk = (row_chunk or _policy_get("row_chunk")
                 or _default_row_chunk(a))
    wt = threshold / (s * 1000.0) if s > 1 else threshold
    dt = jnp.result_type(a.dtype, b.dtype)
    if precision is not None:
        check_precision(precision)
    requested = method
    grow = on_overflow == "grow"
    collector = _policy_get("collect")
    while True:
        if requested == "auto":
            method = _policy_get("method") or _pick_method(a, b, row_chunk)
        cc, cb, stats = _summa(
            a.col_ids, a.blocks.astype(dt), b.col_ids, b.blocks.astype(dt),
            jnp.asarray(alpha, dt), wt, threshold,
            grid=a.grid, pnb=a.panel_nb, k_out=k_out, s_slices=s,
            row_chunk=row_chunk, method=method,
            want_fill=grow or collector is not None)
        if collector is not None:
            collector.append(stats[0])            # exact structural need
        if isinstance(stats, jax.core.Tracer):
            break
        growing = grow and k_out < cap
        if not growing and on_overflow != "warn":
            # nothing reads the stats host-side in this mode
            # ('truncate'/'ignore', or grow already at the cap): skip
            # the blocking readback, which would serialize the eager
            # dispatch pipeline (a collector got the device value)
            break
        if not growing and _policy_get("defer"):
            # warn-mode overflow checks ride a deferred device scalar,
            # materialized in ONE sync when the solve's policy exits
            # (drain_deferred_checks)
            _defer_check(stats[0], k_out, "matmul")
            break
        st = np.asarray(stats)                # ONE host sync per multiply
        need = int(st[0])                     # structural capacity check
        if on_overflow == "warn" and need > k_out:
            import warnings
            warnings.warn(f"matmul: structural fill {need} exceeds "
                          f"capacity {k_out} — result truncated")
        if not grow or k_out >= cap:
            break
        if need <= k_out:
            # trim grown-but-unused capacity (slots are sorted, EMPTY
            # last, so a slice suffices) — capacity bloat widens every
            # later multiply
            k_eff = _k_bucket(int(st[1]), cap)
            if k_eff < k_out:
                cc = cc[..., :k_eff]
                cb = cb[..., :k_eff, :, :]
            break
        k_out = _k_bucket(need, cap)
    out = PSMatrix(cc, cb, a.dim, a.bs, a.grid)
    if c is not None:
        out = increment(c, out, alpha=beta, beta=1.0, threshold=threshold)
    return out


# ----------------------------------------------------------------------------
# cheap (slot-wise / reduction) ops — rely on XLA sharding propagation
# ----------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k_out",))
def _increment_n_jit(mats: tuple, coeffs: tuple, threshold, k_out: int):
    a = mats[0]
    nbr = a.col_ids.shape[1]
    cols_l = [m.col_ids for m in mats]
    blocks_l = [m.blocks for m in mats]
    # Row-chunk the k-way merge on big single-device shards: its
    # [R, sum(K), bs, bs] concatenation and merge temporaries would
    # otherwise dominate device memory (several matrix-sized buffers per
    # increment at 2^20 rows); the scan bounds them to the chunk.
    # Multi-device meshes shard the row axis anyway.
    # smallest chunk count giving <=256-row chunks that divides nbr
    # (chunks no finer than 32 rows; non-divisible sizes fall back to
    # the one-shot merge, which is only reached at small nbr anyway)
    split = 1
    if a.grid.n_devices == 1 and nbr >= 512:
        split = next((s for s in range(nbr // 256, nbr // 32 + 1)
                      if s > 1 and nbr % s == 0), 1)
    if split > 1:
        # lax.scan over dynamic row slices: the body slices the operands
        # in place (a lax.map over pre-reshaped operands would
        # materialize a transposed copy of each input); only the stacked
        # output pays one reshape copy.
        rows = nbr // split

        def body(_, i):
            cs = [jax.lax.dynamic_slice_in_dim(c, i * rows, rows, axis=1)
                  for c in cols_l]
            bs_ = [jax.lax.dynamic_slice_in_dim(b, i * rows, rows, axis=1)
                   for b in blocks_l]
            return None, bell.add_n(cs, bs_, coeffs, threshold=threshold,
                                    k_out=k_out)

        _, (cc, cb) = jax.lax.scan(body, None,
                                   jnp.arange(split, dtype=jnp.int32))
        cc = jnp.moveaxis(cc, 0, 1).reshape(
            (a.col_ids.shape[0], nbr) + cc.shape[3:])
        cb = jnp.moveaxis(cb, 0, 1).reshape(
            (a.blocks.shape[0], nbr) + cb.shape[3:])
    else:
        cc, cb = bell.add_n(cols_l, blocks_l, coeffs,
                            threshold=threshold, k_out=k_out)
    fill = jnp.max(bell.union_fill_n(cols_l))
    used = jnp.max(bell.used_slots(cc))
    out = PSMatrix(cc, cb, a.dim, a.bs, a.grid).astype(
        jnp.result_type(*[m.dtype for m in mats]))
    # fill and used ride ONE stacked int so the eager caller pays one
    # readback, not two
    return out, jnp.stack([fill, used])


def increment(a: PSMatrix, b: PSMatrix, alpha=1.0, beta=1.0, threshold=0.0,
              k_out: int | None = None,
              on_overflow: str | None = None) -> PSMatrix:
    """alpha*A + beta*B (AXPY; reference IncrementMatrix).  Structural
    overflow of the output capacity grows it (see :func:`matmul`)."""
    return increment_n((a, b), (alpha, beta), threshold=threshold,
                       k_out=k_out, on_overflow=on_overflow)


def increment_n(mats, coeffs, threshold=0.0, k_out: int | None = None,
                on_overflow: str | None = None) -> PSMatrix:
    """sum_i coeffs[i] * M_i in ONE fused k-way merge.

    A chain of two-operand increments materializes a full-capacity
    intermediate per link; the fused form has none (2.7 GB per link at
    the 2^20-row bench shape) and pays one merge pass instead of N-1.
    Coefficients may be traced scalars.  Host-sync policy: the exact
    structural fill is read back only where something consumes it —
    'grow' below the cap (regrow decision + capacity trim) and
    non-deferred 'warn'; 'truncate'/'ignore' skip the readback (and the
    trim) entirely, and a deferring policy turns 'warn' into one
    end-of-solve sync (drain_deferred_checks)."""
    mats = tuple(mats)
    a = mats[0]
    cap = a.panel_nb
    k = min(k_out or _policy_get("k_out") or max(m.k for m in mats), cap)
    on_overflow = on_overflow or _policy_get("on_overflow") or "grow"
    collector = _policy_get("collect")
    while True:
        out, stats = _increment_n_jit(mats, tuple(coeffs), threshold,
                                      k_out=k)
        if collector is not None:
            collector.append(stats[0])
        if isinstance(stats, jax.core.Tracer):
            return out
        if on_overflow in ("truncate", "ignore"):
            return out                           # no host sync
        if on_overflow == "warn":
            if _policy_get("defer"):
                _defer_check(stats[0], k, "increment")
                return out
            need = int(np.asarray(stats)[0])
            if need > k:
                import warnings
                warnings.warn(f"increment: structural fill {need} "
                              f"exceeds capacity {k} — result truncated")
            return out
        st = np.asarray(stats)                   # ONE sync ('grow')
        need, ue = int(st[0]), int(st[1])
        if k >= cap or need <= k:
            # trim unused capacity exactly as matmul does (merge output
            # is rank-packed: sorted, EMPTY last) — a policy-pinned
            # capacity above the union fill would otherwise widen every
            # downstream buffer (the 2^20-row solve's X started one
            # bucket fat and the whole iteration inherited it)
            k_eff = _k_bucket(ue, cap)
            if k_eff < out.k:
                out = out.with_data(out.col_ids[..., :k_eff],
                                    out.blocks[..., :k_eff, :, :])
            return out
        k = _k_bucket(need, cap)


@jax.jit
def scale(a: PSMatrix, c) -> PSMatrix:
    return a.with_data(a.col_ids, a.blocks * jnp.asarray(c, a.dtype))


@jax.jit
def trace(a: PSMatrix):
    """MatrixTrace (reference distributed_algebra_includes/MatrixTrace.f90)."""
    return bell.trace(a.col_ids, a.blocks)


@jax.jit
def dot(a: PSMatrix, b: PSMatrix):
    """DotMatrix = sum_ij conj(A_ij) B_ij (reference DotMatrix.f90)."""
    return bell.dot(a.col_ids, a.blocks, b.col_ids, b.blocks)


@jax.jit
def grand_sum(a: PSMatrix):
    return bell.grand_sum(a.blocks)


# Compensated scalar reductions: the (hi, lo)
# two-float pair resolves trace/dot to ~eps^2 relative — combine on the
# host with float64 (host_pair) or keep the pair on device.  These are
# SEPARATE jitted entry points rather than a flag on trace/dot so a
# policy flip can never hit a stale jit cache.

@jax.jit
def trace_pair(a: PSMatrix) -> jax.Array:
    """Compensated real trace -> [2] (hi, lo)."""
    d = bell.trace_blocks(a.col_ids, a.blocks)
    diag = jnp.diagonal(d, axis1=-2, axis2=-1)
    return bell.comp_sum(jnp.real(diag))


@jax.jit
def dot_pair(a: PSMatrix, b: PSMatrix) -> jax.Array:
    """Compensated real part of DotMatrix -> [2] (hi, lo).

    ROW-CHUNKED: the aligned product plus the pairwise two-sum tree of
    a full-capacity 2^20-row operand materializes ~5 matrix-sized
    temporaries (~13 GB at 2^20 rows);
    a lax.scan over row chunks bounds the live set to ~4 chunk-sized
    arrays.  The error model is unchanged: each chunk's pairwise
    two-sum is exact, and chunks combine into the carry by another
    two-sum, so hi + lo still resolves the total to ~n*eps^2."""
    from jax import lax

    nb = int(a.col_ids.shape[-2])
    per_row = int(np.prod(a.blocks.shape[-3:]))     # k * bs * bs
    budget = 16 * 1024 * 1024                       # elements per chunk
    rows_budget = max(1, budget // max(per_row, 1))
    c = next((cand for cand in range(1, nb + 1)
              if nb % cand == 0 and nb // cand <= rows_budget), nb)
    if c == 1:
        prod = bell.align_mul(a.col_ids, jnp.conj(a.blocks),
                              b.col_ids, b.blocks)
        return bell.comp_sum(jnp.real(prod))
    rows = nb // c

    def step(carry, idx):
        sl_ac = lax.dynamic_slice_in_dim(a.col_ids, idx * rows, rows,
                                         axis=a.col_ids.ndim - 2)
        sl_ab = lax.dynamic_slice_in_dim(a.blocks, idx * rows, rows,
                                         axis=a.blocks.ndim - 4)
        sl_bc = lax.dynamic_slice_in_dim(b.col_ids, idx * rows, rows,
                                         axis=b.col_ids.ndim - 2)
        sl_bb = lax.dynamic_slice_in_dim(b.blocks, idx * rows, rows,
                                         axis=b.blocks.ndim - 4)
        prod = bell.align_mul(sl_ac, jnp.conj(sl_ab), sl_bc, sl_bb)
        p = bell.comp_sum(jnp.real(prod))
        s = carry[0] + p[0]
        t = s - carry[0]
        err = (carry[0] - (s - t)) + (p[0] - t)
        return jnp.stack([s, carry[1] + p[1] + err]), None

    init = jnp.zeros((2,), jnp.real(jnp.zeros((), a.blocks.dtype)).dtype)
    out, _ = lax.scan(step, init, jnp.arange(c))
    return out


def host_pair(p) -> float:
    """(hi, lo) pair -> float64 on the host (one readback)."""
    v = np.asarray(p, np.float64)
    return float(v[..., 0] + v[..., 1])


@jax.jit
def pairwise_multiply(a: PSMatrix, b: PSMatrix) -> PSMatrix:
    """Hadamard product (reference PairwiseMultiplyMatrix)."""
    prod = bell.align_mul(a.col_ids, a.blocks, b.col_ids, b.blocks)
    cc, cb = bell.compact(a.col_ids, prod, min(max(a.k, 1), a.panel_nb))
    return PSMatrix(cc, cb, a.dim, a.bs, a.grid)


@jax.jit
def filter_small(a: PSMatrix, threshold) -> PSMatrix:
    """FilterMatrix (reference PSMatrixModule.F90:1318-1359)."""
    cc, cb = bell.filter_small(a.col_ids, a.blocks, threshold)
    return a.with_data(cc, cb)


def conjugate(a: PSMatrix) -> PSMatrix:
    return a.conjugate()


@functools.partial(jax.jit, static_argnames=("k_out",))
def _transpose_jit(a: PSMatrix, k_out: int):
    pc, nb, k = a.col_ids.shape
    bs = a.bs
    rows = jnp.broadcast_to(
        jnp.arange(nb, dtype=jnp.int32)[None, :, None], (pc, nb, k))
    cols = a.col_ids.reshape(-1)
    rows = rows.reshape(-1)
    blocks = bell.transpose_blocks(a.blocks).reshape(-1, bs, bs)
    valid = cols != EMPTY
    # output fill per (new panel = old row's panel, new row = old col)
    pidx = rows // a.panel_nb
    fill = jnp.max(jnp.zeros((pc, nb), jnp.int32).at[
        pidx, jnp.where(valid, cols, nb)].add(1, mode='drop'))
    oc, ob = bell.from_block_coo(
        jnp.where(valid, cols, nb), rows, blocks, valid,
        nbr=nb, k=k_out, panels=pc, panel_nbc=a.panel_nb)
    sh = a.grid.matrix_sharding
    return a.with_data(jax.lax.with_sharding_constraint(oc, sh),
                       jax.lax.with_sharding_constraint(ob, sh)), fill


def transpose(a: PSMatrix, k_out: int | None = None,
              on_overflow: str | None = None) -> PSMatrix:
    """TransposeMatrix (reference distributed_includes/TransposeMatrix.f90):
    block-COO flip + rebuild (XLA emits the all-to-all redistribution).
    Structural overflow of the output capacity grows it."""
    cap = a.panel_nb
    k = min(k_out or _policy_get("k_out") or a.k, cap)
    on_overflow = on_overflow or _policy_get("on_overflow") or "grow"
    while True:
        out, fill = _transpose_jit(a, k_out=k)
        need = _concrete_int(fill)
        if (on_overflow != "grow" or k >= cap or need is None
                or need <= k):
            return out
        k = _k_bucket(need, cap)


@functools.partial(jax.jit, static_argnames=("side",))
def diagonal_scale(a: PSMatrix, dvals, side: str = "right") -> PSMatrix:
    """Scale columns ('right': A diag(d)) or rows ('left': diag(d) A)
    (reference MatrixDiagonalScale, PSMatrixAlgebraModule.F90)."""
    d = jnp.asarray(dvals, a.dtype)
    d = jnp.pad(d, (0, a.logical_dim - d.shape[0]))
    if side == "right":
        b = bell.diagonal_scale(a.col_ids, a.blocks,
                                dvec_cols=d.reshape(a.nb, a.bs))
    else:
        b = bell.diagonal_scale(a.col_ids, a.blocks,
                                dvec_rows=d.reshape(a.nb, a.bs))
    return a.with_data(a.col_ids, b)


@jax.jit
def column_sums(a: PSMatrix) -> jax.Array:
    """Per-column sums of |v| -> [logical_dim] (column 1-norms)."""
    off = jnp.asarray(a.panel_offsets(), jnp.int32)[:, None, None]
    valid = a.col_ids != EMPTY
    loc = jnp.where(valid, a.col_ids - off, EMPTY)
    cs = bell.col_abs_sums(loc, a.blocks, a.panel_nb)   # [Pc, pnb, bs]
    return cs.reshape(a.logical_dim)


@jax.jit
def norm(a: PSMatrix):
    """MatrixNorm: max column 1-norm (reference MatrixNorm.f90)."""
    return jnp.max(column_sums(a))


def measure_asymmetry(a: PSMatrix):
    """norm(A - A^T) (reference PSMatrixAlgebraModule.F90:569-583)."""
    return norm(increment(transpose(a), a, alpha=-1.0, beta=1.0))


def symmetrize(a: PSMatrix) -> PSMatrix:
    """A <- (A + A^T)/2 (reference PSMatrixAlgebraModule.F90:584-598)."""
    return increment(scale(a, 0.5), transpose(scale(a, 0.5)))


@functools.partial(jax.jit, static_argnames=("dim",))
def _is_identity_jit(col_ids, blocks, *, dim: int):
    """Total |A - I| in one fused pass: per slot, the expected block is
    eye (on the unpadded diagonal) where col == row, zero otherwise."""
    pc, nbr, k = col_ids.shape
    bs = blocks.shape[-1]
    rows = jnp.arange(nbr, dtype=jnp.int32)[None, :, None]
    eye = jnp.eye(bs, dtype=blocks.real.dtype)
    gi = rows[..., None, None] * bs + jnp.arange(bs)[:, None]
    want = (jnp.where((col_ids == rows)[..., None, None]
                      & (gi < dim), eye, 0).astype(blocks.dtype))
    return jnp.sum(jnp.abs(blocks - want))


def is_identity(a: PSMatrix) -> bool:
    """Exact identity check (reference IsIdentity,
    PSMatrixModule.F90:1810-1852) — ONE fused pass + one scalar readback
    instead of building an identity and running an increment chain and
    a norm; conservatively False under a jit trace."""
    nv = _is_identity_jit(a.col_ids, a.blocks, dim=a.dim)
    if isinstance(nv, jax.core.Tracer):
        return False
    return float(nv) == 0.0


def similarity_transform(a: PSMatrix, p: PSMatrix, pinv: PSMatrix,
                         threshold=0.0, k_out=None) -> PSMatrix:
    """P @ A @ Pinv with the identity short-circuit (reference
    SimilarityTransform, PSMatrixAlgebraModule.F90:603-654 skips the
    multiplies when P is the identity — two SpGEMMs saved per call, four
    per orthogonalize/deorthogonalize pair)."""
    if p.k <= 1 and pinv.k <= 1 and is_identity(p) and is_identity(pinv):
        return filter_small(a, threshold) if threshold > 0 else a
    tmp = matmul(a, pinv, threshold=threshold, k_out=k_out)
    return matmul(p, tmp, threshold=threshold, k_out=k_out)


@jax.jit
def diagonal_values(a: PSMatrix) -> jax.Array:
    """The matrix diagonal -> [logical_dim]."""
    dblocks = bell.trace_blocks(a.col_ids, a.blocks)       # [Pc, NB, bs, bs]
    dblocks = jnp.sum(dblocks, axis=0)                     # [NB, bs, bs]
    return jnp.diagonal(dblocks, axis1=-2, axis2=-1).reshape(-1)


@jax.jit
def gershgorin_bounds(a: PSMatrix):
    """Spectral bounds: min/max over columns of center +/- radius
    (reference EigenBoundsModule.F90:29-59).  Padded columns contribute a
    [0, 0] interval, matching the reference's per-logical-column loop —
    and load-balanced matrices may hold data in the padded region."""
    cs = column_sums(a)
    d = diagonal_values(a)
    dr = d.real if jnp.iscomplexobj(d) else d
    radius = cs - jnp.abs(d)
    return jnp.min(dr - radius), jnp.max(dr + radius)


@jax.jit
def spmv(a: PSMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x for a replicated dense vector x[logical_dim]."""
    xb = x.reshape(a.nb, a.bs)
    valid = a.col_ids != EMPTY
    loc = jnp.where(valid, a.col_ids, 0)
    xg = xb[loc] * valid[..., None].astype(x.dtype)        # [Pc, NB, K, bs]
    y = jnp.einsum('prkij,prkj->ri', a.blocks, xg.astype(a.dtype),
                   precision=lax.Precision.HIGHEST)
    return y.reshape(-1)


@jax.jit
def spmm(a: PSMatrix, x: jax.Array) -> jax.Array:
    """Y = A @ X for a replicated dense block of vectors X[logical_dim, m].

    The tall-operand product behind the iterative (matrix-free)
    eigensolver — each block-ELL slot contributes one (bs, bs) x (bs, m)
    dot, batched over all slots.
    """
    m = x.shape[-1]
    xb = x.reshape(a.nb, a.bs, m)
    valid = a.col_ids != EMPTY
    loc = jnp.where(valid, a.col_ids, 0)
    xg = xb[loc] * valid[..., None, None].astype(x.dtype)  # [Pc,NB,K,bs,m]
    y = jnp.einsum('prkij,prkjm->rim', a.blocks, xg.astype(a.dtype),
                   precision=lax.Precision.HIGHEST)
    return y.reshape(a.logical_dim, m)


@jax.jit
def matrix_sigma(a: PSMatrix):
    """Ozaki sigma for Hotelling init: 1 / (max column sum)^2-ish scaling
    (reference MatrixSigma, PSMatrixAlgebraModule.F90:80-104)."""
    cs = column_sums(a)
    return 1.0 / jnp.max(cs) ** 2


def load_balance(a: PSMatrix, perm: PSMatrix, perm_t: PSMatrix,
                 threshold=0.0) -> PSMatrix:
    """PermuteMatrix: P A P^T by two SpGEMMs (reference
    LoadBalancerModule.F90:16-92)."""
    return matmul(perm, matmul(a, perm_t, threshold=threshold),
                  threshold=threshold)
