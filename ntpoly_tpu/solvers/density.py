"""Density matrix solvers: purification methods.

JAX re-implementations of reference
Source/Fortran/DensityMatrixSolversModule.F90 (1,233 LoC): PM (:37-281),
TRS2 (:285-481), TRS4 (:485-718), HPCP (:720-952), ScaleAndFold (:953-1119),
DenseDensity (:1120-1163), EnergyDensityMatrix (:1165-1189) and McWeenyStep
(:1190-1233).  Each solver is a thin loop over the distributed SpGEMM /
AXPY / trace / dot primitives; the sigma-decision history is replayed on
scalars to recover the chemical potential by bisection, exactly as the
reference does.

All take the Hamiltonian H, the inverse square root ISQ of the overlap, and
the target trace (electron count); they return (K, energy, chemical
potential) where applicable.
"""
from __future__ import annotations

import jax as _jax
import jax.numpy as _jnp
import numpy as _np

from ..parallel import algebra as alg
from .common import (resolve, solver_log, iteration_log, finish_iterations,
                     orthogonalize, deorthogonalize, maybe_permute,
                     maybe_unpermute, identity_like, real_scalar,
                     prologue_scalars)
from .parameters import SolverParameters


@_jax.jit
def _trs4_scalars_jit(a, b):
    """[dot(A, B), dot(A, A), trace(A), trace(B)] stacked — ONE readback
    instead of four per eager TRS4 iteration.  trace(B) (= trace of the
    iterate) feeds the idempotency convergence metric."""
    return _jnp.stack([_jnp.real(alg.dot(a, b)),
                       _jnp.real(alg.dot(a, a)),
                       _jnp.real(alg.trace(a)),
                       _jnp.real(alg.trace(b))])


_FENCE_BYTES = 2 << 30


def _fence_large(m) -> None:
    """One-scalar completion fence for eager loops at huge shapes.

    Async dispatch claims every enqueued op's output buffer up front;
    without any per-op sync the transient live set of one purification
    iteration at 2^20 rows can exceed device memory (a consumed-but-
    pending input cannot free).  Reading back a single element bounds
    the run-ahead without streaming any matrix data."""
    if m.blocks.nbytes >= _FENCE_BYTES:
        _np.asarray(m.blocks[(0,) * m.blocks.ndim])


def _metric(params) -> str:
    """Resolve SolverParameters.convergence_metric ('auto': energy-diff
    reference parity when precision='highest', the noise-robust
    idempotency residual otherwise — see parameters.py).  The precision
    name changes no arithmetic (every multiply tier runs at FP32); this
    choice of functional is all it selects."""
    if params.convergence_metric == "auto":
        return "idempotency" if params.precision != "highest" else "energy"
    return params.convergence_metric


def _chunk_conv(params, row_transform_extra=None):
    """(conv_index, conv_mode, row_transform) for a purification chunked
    run whose RAW step rows are (energy, sigma, idem) or, compensated,
    (e_hi, e_lo, sigma, idem) — transformed rows are always
    (energy, sigma, idem)."""
    metric = _metric(params)
    if params.compensated_scalars:
        def row_transform(row):
            return (row[0] + row[1],) + tuple(row[2:])
    else:
        row_transform = None
    if metric == "idempotency":
        return 2, "value", row_transform
    return 0, "diff", row_transform


def _step_energy(x_new, whc, compensated):
    """Energy scalars of a purification step: a 1-tuple (plain f32) or
    an (hi, lo) 2-tuple resolved to ~eps^2 (host combines in float64)."""
    if compensated:
        pair = alg.dot_pair(x_new, whc)
        return (pair[0], pair[1])
    return (_jnp.real(alg.dot(x_new, whc)),)


def _bisect_chemical_potential(replay, total_iterations, params):
    """Bisection of the accumulated scalar polynomial recursion on [0, 1]
    (reference DensityMatrixSolversModule.F90:443-472)."""
    a, b = 0.0, 1.0
    midpoint = 0.0
    for _ in range(params.max_iterations):
        midpoint = (b - a) / 2.0 + a
        zero_value = midpoint
        for jj in range(total_iterations):
            zero_value = replay(jj, zero_value)
        if zero_value < 0.5:
            a = midpoint
        else:
            b = midpoint
        if abs(zero_value - 0.5) < params.converge_diff:
            break
    return midpoint


def pm(h, isq, trace, params: SolverParameters | None = None):
    """Palser-Manolopoulos canonical purification (palser1998canonical;
    reference DensityMatrixSolversModule.F90:37-281)."""
    params, monitor = resolve(params)
    monitor.plateau = _metric(params) == "idempotency"
    sigmas = []
    with solver_log(params, "Density Matrix Solver", "PM",
                    ("palser1998canonical",)):
        n = h.dim
        imat = identity_like(h)
        wh, isqt = orthogonalize(h, isq, params)
        wh, imat = maybe_permute(params, wh, imat)
        e_min, e_max, tr_wh = prologue_scalars(wh)
        lam = tr_wh / n
        alpha = min(trace / (e_max - lam), (n - trace) / (lam - e_min))
        x = alg.increment(wh, imat, alpha=-alpha / n,
                          beta=(alpha * lam + trace) / n)

        if params.iters_per_sync > 1:
            with iteration_log(params) as ilog:
                x, history, total_1b = _pm_chunked(
                    x, wh, imat, trace, params, monitor, ilog)
            energy = history[-1][0]
            sigmas = [row[1] for row in history]
            total = total_1b - 1
        else:
            energy = 0.0
            total = 0
            with iteration_log(params) as ilog:
                for ii in range(params.max_iterations):
                    x2 = alg.matmul(x, x, threshold=params.threshold)
                    x3 = alg.matmul(x, x2, threshold=params.threshold)
                    tmp = alg.increment(
                        x, x2, 1.0, -1.0,
                        threshold=params.threshold)       # X - X^2
                    tv = real_scalar(alg.trace(tmp))
                    tv2 = real_scalar(alg.dot(tmp, x))
                    sigma = 1.0 if tv <= 1e-300 else tv2 / tv
                    sigmas.append(sigma)
                    if sigma > 0.5:
                        a1, a2, a3 = 0.0, 1.0 + 1.0 / sigma, -1.0 / sigma
                    else:
                        a1 = (1.0 - 2.0 * sigma) / (1.0 - sigma)
                        a2 = (1.0 + sigma) / (1.0 - sigma)
                        a3 = -1.0 / (1.0 - sigma)
                    x = alg.increment_n(
                        (x, x2, x3), (a1, a2, a3),
                        threshold=params.threshold)
                    energy_old = energy
                    energy = real_scalar(alg.dot(x, wh))
                    total = ii
                    if _metric(params) == "idempotency":
                        monitor.append(abs(tv) / trace)
                    else:
                        monitor.append(energy - energy_old)
                    ilog.step(**{"Energy Value": energy})
                    if monitor.check_converged(params.be_verbose):
                        break
        finish_iterations(params, total + 1, x, monitor=monitor,
                          solver="Density Matrix Solver")

        x = maybe_unpermute(params, x)
        k = deorthogonalize(x, isq, isqt, params)

        def replay(jj, zv):
            s = sigmas[jj]
            if s > 0.5:
                return ((1.0 + s) * zv ** 2 - zv ** 3) / s
            return ((1.0 - 2.0 * s) * zv + (1.0 + s) * zv ** 2 - zv ** 3) \
                / (1.0 - s)

        midpoint = _bisect_chemical_potential(replay, total, params)
        mu = lam - (n * midpoint - trace) / alpha
    return k, energy, mu


def trs2(h, isq, trace, params: SolverParameters | None = None):
    """2nd-order trace-resetting purification (niklasson2002expansion;
    reference DensityMatrixSolversModule.F90:285-481)."""
    params, monitor = resolve(params)
    monitor.plateau = _metric(params) == "idempotency"
    sigmas = []
    with solver_log(params, "Density Matrix Solver", "TRS2",
                    ("niklasson2002expansion",)):
        imat = identity_like(h)
        wh, isqt = orthogonalize(h, isq, params)
        wh, imat = maybe_permute(params, wh, imat)
        e_min, e_max, _ = prologue_scalars(wh)

        # X0 = (e_max I - WH) / (e_max - e_min)
        x = alg.increment(wh, imat, alpha=-1.0 / (e_max - e_min),
                          beta=e_max / (e_max - e_min))

        if params.iters_per_sync > 1:
            with iteration_log(params) as ilog:
                x, history, total_1b = _trs2_chunked(
                    x, wh, imat, trace, params, monitor, ilog)
            energy = history[-1][0]
            sigmas = [row[1] for row in history]
            total = total_1b - 1
        else:
            energy = 0.0
            total = 0
            with iteration_log(params) as ilog:
                for ii in range(params.max_iterations):
                    tv = real_scalar(alg.trace(x))
                    sigma = -1.0 if trace - tv < 0.0 else 1.0
                    sigmas.append(sigma)
                    x2 = alg.matmul(x, x, threshold=params.threshold)
                    idem = None
                    if _metric(params) == "idempotency":
                        idem = (tv - real_scalar(alg.trace(x2))) / trace
                    if sigma > 0.0:
                        x = alg.increment(x, x2, 2.0, -1.0,
                                          threshold=params.threshold)
                    else:
                        x = x2
                    energy_old = energy
                    energy = real_scalar(alg.dot(x, wh))
                    total = ii
                    monitor.append(abs(idem) if idem is not None
                                   else energy - energy_old)
                    ilog.step(**{"Energy Value": energy})
                    if monitor.check_converged(params.be_verbose):
                        break
        finish_iterations(params, total + 1, x, monitor=monitor,
                          solver="Density Matrix Solver")

        x = maybe_unpermute(params, x)
        k = deorthogonalize(x, isq, isqt, params)

        def replay(jj, zv):
            return zv * zv if sigmas[jj] < 0.0 else 2.0 * zv - zv * zv

        midpoint = _bisect_chemical_potential(replay, total, params)
        mu = e_max + (e_min - e_max) * midpoint
    return k, energy, mu


def _pin_capacity(params, *mats, n_carry: int = 1):
    """Pinned capacity for a chunked solve: user knob, else 3x the
    structural fill of the first squaring (the peak of purification
    fill-in).  Only the first ``n_carry`` matrices — the scan carry,
    whose shapes must stay fixed across iterations — are padded to the
    pin; every bell op handles mixed slot counts, so padding the
    constant operands (working H, identity) would only multiply their
    HBM footprint (3 GB + 2.5 GB of zeros at the 2^20-row bench
    shape)."""
    from .common import pad_capacity
    x = mats[0]
    cap = x.panel_nb
    k_pin = params.k_out or min(cap, 3 * alg.fill_bound(x, x))
    k_pin = max(k_pin, *(m.k for m in mats[:n_carry]))
    return k_pin, tuple(pad_capacity(m, k_pin) for m in mats[:n_carry]
                        ) + mats[n_carry:]


def _pm_chunked(x, wh, imat, trace, params, monitor, ilog):
    """PM fused iterations (see _trs4_chunked): the sigma branch picks
    traced polynomial coefficients via jnp.where."""
    import jax.numpy as jnp
    from .common import run_chunked

    thr = params.threshold
    k_pin, (x, whp, imatp) = _pin_capacity(params, x, wh, imat)
    comp = params.compensated_scalars
    conv_index, conv_mode, row_transform = _chunk_conv(params)

    def step(xc, whc, imatc):
        x2 = alg.matmul(xc, xc, threshold=thr)
        x3 = alg.matmul(xc, x2, threshold=thr)
        tmp = alg.increment(xc, x2, 1.0, -1.0, threshold=thr)
        tv = jnp.real(alg.trace(tmp))
        tv2 = jnp.real(alg.dot(tmp, xc))
        sigma = jnp.where(tv <= 1e-300, 1.0, tv2 / jnp.where(
            tv <= 1e-300, 1.0, tv))
        hi = sigma > 0.5
        a1 = jnp.where(hi, 0.0, (1.0 - 2.0 * sigma) / (1.0 - sigma))
        a2 = jnp.where(hi, 1.0 + 1.0 / sigma,
                       (1.0 + sigma) / (1.0 - sigma))
        a3 = jnp.where(hi, -1.0 / sigma, -1.0 / (1.0 - sigma))
        x_new = alg.increment_n((xc, x2, x3), (a1, a2, a3),
                                threshold=thr)
        # tv IS tr(X - X^2): the idempotency residual of the incoming
        # iterate, already in hand
        idem = jnp.abs(tv) / trace
        return x_new, _step_energy(x_new, whc, comp) + (sigma, idem)

    return run_chunked(step, x, (whp, imatp), params, monitor, ilog,
                       k_pin=k_pin, aux_names=("Energy Value",),
                       conv_index=conv_index, conv_mode=conv_mode,
                       row_transform=row_transform,
                       cache_key=("pm", thr, float(trace), comp))


def _hpcp_chunked(d1, wh, imat, trace, params, monitor, ilog):
    """HPCP fused iterations (see _trs4_chunked)."""
    import jax.numpy as jnp
    from .common import run_chunked

    thr = params.threshold
    k_pin, (d1, whp, imatp) = _pin_capacity(params, d1, wh, imat)
    comp = params.compensated_scalars
    conv_index, conv_mode, row_transform = _chunk_conv(params)

    def step(dc, whc, imatc):
        dh = alg.increment(imatc, dc, 1.0, -1.0, threshold=thr)
        ddh = alg.matmul(dc, dh, threshold=thr)
        tv = jnp.real(alg.trace(ddh))
        d2dh = alg.matmul(dc, ddh, threshold=thr)
        s = jnp.where(tv == 0, 0.0,
                      jnp.real(alg.trace(d2dh))
                      / jnp.where(tv == 0, 1.0, tv))
        d_new = alg.increment_n((dc, d2dh, ddh), (1.0, 2.0, -2.0 * s),
                                threshold=thr)
        # tv IS tr(D(I - D)): the incoming iterate's idempotency residual
        idem = jnp.abs(tv) / trace
        return d_new, _step_energy(d_new, whc, comp) + (s, idem)

    return run_chunked(step, d1, (whp, imatp), params, monitor, ilog,
                       k_pin=k_pin, aux_names=("Energy Value",),
                       conv_index=conv_index, conv_mode=conv_mode,
                       row_transform=row_transform,
                       cache_key=("hpcp", thr, float(trace), comp))


def _trs2_chunked(x, wh, imat, trace, params, monitor, ilog):
    """TRS2 fused iterations (see _trs4_chunked)."""
    import jax.numpy as jnp
    from .common import run_chunked

    thr = params.threshold
    k_pin, (x, whp, imatp) = _pin_capacity(params, x, wh, imat)
    comp = params.compensated_scalars
    conv_index, conv_mode, row_transform = _chunk_conv(params)

    def step(xc, whc, imatc):
        tv = jnp.real(alg.trace(xc))
        sigma = jnp.where(trace - tv < 0.0, -1.0, 1.0)
        x2 = alg.matmul(xc, xc, threshold=thr)
        t2 = jnp.real(alg.trace(x2))
        # the sigma branch as scalar-selected coefficients in ONE fused
        # merge — x_hi is never materialized (see _trs4_chunked)
        ca = jnp.where(sigma > 0.0, 2.0, 0.0)
        cb = jnp.where(sigma > 0.0, -1.0, 1.0)
        x_new = alg.increment_n((xc, x2), (ca, cb), threshold=thr)
        idem = jnp.abs(tv - t2) / trace
        return x_new, _step_energy(x_new, whc, comp) + (sigma, idem)

    return run_chunked(step, x, (whp, imatp), params, monitor, ilog,
                       k_pin=k_pin, aux_names=("Energy Value",),
                       conv_index=conv_index, conv_mode=conv_mode,
                       row_transform=row_transform,
                       cache_key=("trs2", thr, float(trace), comp))


def _trs4_chunked(x, wh, imat, trace, params, monitor, ilog,
                  sigma_min, sigma_max):
    """TRS4 iterations fused params.iters_per_sync at a time into one
    compiled lax.scan (static shapes under a pinned capacity) — the
    reference's per-iteration Allreduce convergence check becomes one
    host sync per chunk.  The sigma clamp branches become whole-matrix
    selects on the traced sigma scalar."""
    import jax.numpy as jnp
    from .common import run_chunked

    thr = params.threshold
    k_pin, (x, whp, imatp) = _pin_capacity(params, x, wh, imat)
    comp = params.compensated_scalars
    conv_index, conv_mode, row_transform = _chunk_conv(params)

    def step(xc, whc, imatc):
        # fx = 4X - 3X^2 and gx = I - 2X + X^2 are never materialized:
        # poly = fx + sigma*gx = (4-2s)X + (s-3)X^2 + sI, and both trace
        # terms reduce to dot(X^2, X), dot(X^2, X^2), trace(X^2) — two
        # fewer full matrices live per iteration (6 GB at the 2^20-row
        # bench shape) and two fewer increments (the reference holds F
        # and G explicitly, DensityMatrixSolversModule.F90:587-625)
        x2 = alg.matmul(xc, xc, threshold=thr)
        d1, d2, t2, tx = _trs4_scalars_jit(x2, xc)
        trace_fx = 4.0 * d1 - 3.0 * d2
        trace_gx = t2 - 2.0 * d1 + d2
        sigma = jnp.where(jnp.abs(trace_gx) < 1e-14,
                          0.5 * (sigma_max - sigma_min),
                          (trace - trace_fx) / trace_gx)
        # x2's table is the widest (its candidates cover x's and the
        # diagonal), so it leads every aligned add.  Both three-term
        # combinations are SINGLE fused merges (increment_n): the
        # two-op chain materialized one extra full-capacity matrix per
        # link (2.7 GB each at the 2^20-row shape).
        poly = alg.increment_n(
            (x2, xc, imatc), (sigma - 3.0, 4.0 - 2.0 * sigma, sigma),
            threshold=thr)
        x_mid = alg.matmul(x2, poly, threshold=thr)
        # The sigma clamps as scalar-selected coefficients instead of
        # whole-matrix selects: x_new = a*X + b*X^2 + c*(X^2 poly) with
        # (a,b,c) = (2,-1,0) above sigma_max, (0,1,0) below sigma_min,
        # (0,0,1) in range — x_hi is never materialized (one less
        # 2.5 GB live matrix at the 2^20-row shape).
        hi = sigma > sigma_max
        lo = sigma < sigma_min
        ca = jnp.where(hi, 2.0, 0.0)
        cb = jnp.where(hi, -1.0, jnp.where(lo, 1.0, 0.0))
        cc = jnp.where(hi | lo, 0.0, 1.0)
        x_new = alg.increment_n((x2, xc, x_mid), (cb, ca, cc),
                                threshold=thr)
        # idempotency residual of the INCOMING iterate (tr X - tr X^2,
        # both already in hand), per electron — lags the new iterate by
        # one step, which only delays the plateau detection by one
        # iteration
        idem = jnp.abs(tx - t2) / trace
        return x_new, _step_energy(x_new, whc, comp) + (sigma, idem)

    return run_chunked(step, x, (whp, imatp), params, monitor, ilog,
                       k_pin=k_pin, aux_names=("Energy Value",),
                       conv_index=conv_index, conv_mode=conv_mode,
                       row_transform=row_transform,
                       cache_key=("trs4", thr, float(trace), sigma_min,
                                  sigma_max, comp))


def trs4(h, isq, trace, params: SolverParameters | None = None):
    """4th-order trace-resetting purification (niklasson2002expansion;
    reference DensityMatrixSolversModule.F90:485-718)."""
    params, monitor = resolve(params)
    monitor.plateau = _metric(params) == "idempotency"
    sigma_min, sigma_max = 0.0, 6.0
    sigmas = []
    with solver_log(params, "Density Matrix Solver", "TRS4",
                    ("niklasson2002expansion",)):
        imat = identity_like(h)
        wh, isqt = orthogonalize(h, isq, params)
        wh, imat = maybe_permute(params, wh, imat)
        e_min, e_max, _ = prologue_scalars(wh)

        x = alg.increment(wh, imat, alpha=-1.0 / (e_max - e_min),
                          beta=e_max / (e_max - e_min))

        if params.iters_per_sync > 1:
            with iteration_log(params) as ilog:
                x, history, total_1b = _trs4_chunked(
                    x, wh, imat, trace, params, monitor, ilog,
                    sigma_min, sigma_max)
            energy = history[-1][0]
            sigmas = [row[1] for row in history]
            total = total_1b - 1
        else:
            energy = 0.0
            total = 0
            metric = _metric(params)
            comp = params.compensated_scalars
            with iteration_log(params) as ilog:
                for ii in range(params.max_iterations):
                    # frugal form (see _trs4_chunked): fx/gx are never
                    # materialized; eager branching on concrete sigma
                    # additionally frees X before the polynomial
                    # multiply in the common branch, which lowers the
                    # peak device memory at the 2^20-row bench shape
                    x2 = alg.matmul(x, x, threshold=params.threshold)
                    d1, d2, t2, tx = [
                        float(v)
                        for v in _np.asarray(_trs4_scalars_jit(x2, x))]
                    trace_fx = 4.0 * d1 - 3.0 * d2
                    trace_gx = t2 - 2.0 * d1 + d2
                    if abs(trace_gx) < 1e-14:
                        sigma = 0.5 * (sigma_max - sigma_min)
                    else:
                        sigma = (trace - trace_fx) / trace_gx
                    sigmas.append(sigma)
                    if sigma > sigma_max:
                        x = alg.increment(x, x2, 2.0, -1.0,
                                          threshold=params.threshold)
                    elif sigma < sigma_min:
                        x = x2
                    else:
                        # ONE fused three-term merge (increment_n) for
                        # the polynomial; X freed before the multiply
                        poly = alg.increment_n(
                            (x2, x, imat),
                            (sigma - 3.0, 4.0 - 2.0 * sigma, sigma),
                            threshold=params.threshold)
                        del x                # free before the multiply
                        # r5's deferred checks removed every per-op
                        # sync, so the host runs ahead: the X2@poly
                        # buffers are claimed while the OLD X (poly's
                        # input) is still allocated — ~16 GB transient
                        # at the 2^20-row shape (observed OOM).  At
                        # large shapes a one-scalar fence lets the old
                        # X free before the multiply allocates.
                        _fence_large(poly)
                        x = alg.matmul(x2, poly,
                                       threshold=params.threshold)
                        del poly
                    del x2
                    energy_old = energy
                    if comp:
                        energy = alg.host_pair(alg.dot_pair(x, wh))
                    else:
                        energy = real_scalar(alg.dot(x, wh))
                    total = ii
                    if metric == "idempotency":
                        monitor.append(abs(tx - t2) / trace)
                    else:
                        monitor.append(energy - energy_old)
                    ilog.step(**{"Energy Value": energy})
                    if monitor.check_converged(params.be_verbose):
                        break
        finish_iterations(params, total + 1, x, monitor=monitor,
                          solver="Density Matrix Solver")

        x = maybe_unpermute(params, x)
        k = deorthogonalize(x, isq, isqt, params)

        def replay(jj, zv):
            s = sigmas[jj]
            if s > sigma_max:
                return 2.0 * zv - zv * zv
            if s < sigma_min:
                return zv * zv
            tempfx = zv * zv * (4.0 * zv - 3.0 * zv * zv)
            tempgx = zv * zv * (1.0 - zv) ** 2
            return tempfx + s * tempgx

        midpoint = _bisect_chemical_potential(replay, total, params)
        mu = e_max + (e_min - e_max) * midpoint
    return k, energy, mu


def hpcp(h, isq, trace, params: SolverParameters | None = None):
    """Hole-particle canonical purification (truflandier2016communication;
    reference DensityMatrixSolversModule.F90:720-952)."""
    params, monitor = resolve(params)
    monitor.plateau = _metric(params) == "idempotency"
    sigmas = []
    with solver_log(params, "Density Matrix Solver", "HPCP",
                    ("truflandier2016communication",)):
        n = h.dim
        imat = identity_like(h)
        wh, isqt = orthogonalize(h, isq, params)
        wh, imat = maybe_permute(params, wh, imat)
        e_min, e_max, tr_wh = prologue_scalars(wh)
        mu_bar = tr_wh / n
        sigma_bar = (n - trace) / n
        sigma = 1.0 - sigma_bar
        beta = sigma / (e_max - mu_bar)
        beta_bar = sigma_bar / (mu_bar - e_min)
        beta_1 = sigma
        beta_2 = min(beta, beta_bar)

        # D1 = beta_1 I + beta_2 (mu I - WH)
        d1 = alg.increment(imat, alg.increment(imat, wh, mu_bar, -1.0),
                           beta_1, beta_2)

        if params.iters_per_sync > 1:
            with iteration_log(params) as ilog:
                d1, history, total_1b = _hpcp_chunked(
                    d1, wh, imat, trace, params, monitor, ilog)
            energy = history[-1][0]
            sigmas = [row[1] for row in history]
            total = total_1b - 1
        else:
            energy = 0.0
            total = 0
            with iteration_log(params) as ilog:
                for ii in range(params.max_iterations):
                    dh = alg.increment(imat, d1, 1.0, -1.0,
                                       threshold=params.threshold)
                    ddh = alg.matmul(d1, dh, threshold=params.threshold)
                    tv = real_scalar(alg.trace(ddh))
                    d2dh = alg.matmul(d1, ddh, threshold=params.threshold)
                    s = real_scalar(alg.trace(d2dh)) / tv if tv != 0 \
                        else 0.0
                    sigmas.append(s)
                    d1 = alg.increment_n(
                        (d1, d2dh, ddh), (1.0, 2.0, -2.0 * s),
                        threshold=params.threshold)
                    energy_old = energy
                    energy = real_scalar(alg.dot(d1, wh))
                    total = ii
                    if _metric(params) == "idempotency":
                        monitor.append(abs(tv) / trace)
                    else:
                        monitor.append(energy - energy_old)
                    ilog.step(**{"Energy Value": energy})
                    if monitor.check_converged(params.be_verbose):
                        break
        finish_iterations(params, total + 1, d1, monitor=monitor,
                          solver="Density Matrix Solver")

        d1 = maybe_unpermute(params, d1)
        k = deorthogonalize(d1, isq, isqt, params)

        def replay(jj, zv):
            s = sigmas[jj]
            return zv + 2.0 * (zv ** 2 * (1.0 - zv)
                               - s * zv * (1.0 - zv))

        midpoint = _bisect_chemical_potential(replay, total, params)
        mu = mu_bar + (beta_1 - midpoint) / beta_2
    return k, energy, mu


def scale_and_fold(h, isq, trace, homo, lumo,
                   params: SolverParameters | None = None):
    """Accelerated scale-and-fold purification (rubensson2011nonmonotonic;
    reference DensityMatrixSolversModule.F90:953-1119).  Requires
    (conservative) homo/lumo estimates."""
    params, monitor = resolve(params)
    with solver_log(params, "Density Matrix Solver", "Scale and Fold",
                    ("rubensson2011nonmonotonic",)):
        imat = identity_like(h)
        wh, isqt = orthogonalize(h, isq, params)
        wh, imat = maybe_permute(params, wh, imat)
        e_min, e_max, _ = prologue_scalars(wh)

        x = alg.increment(wh, imat, alpha=-1.0 / (e_max - e_min),
                          beta=e_max / (e_max - e_min))
        beta = (e_max - lumo) / (e_max - e_min)
        beta_bar = (e_max - homo) / (e_max - e_min)

        energy = 0.0
        total = 0
        with iteration_log(params) as ilog:
            for ii in range(params.max_iterations):
                tv = real_scalar(alg.trace(x))
                if tv > trace:
                    a = 2.0 / (2.0 - beta)
                    x = alg.increment(x, imat, a, 1.0 - a)
                    x = alg.matmul(x, x, threshold=params.threshold)
                    beta = (a * beta + 1 - a) ** 2
                    beta_bar = (a * beta_bar + 1 - a) ** 2
                else:
                    a = 2.0 / (1.0 + beta_bar)
                    x2 = alg.matmul(x, x, threshold=params.threshold)
                    x = alg.increment(x, x2, 2 * a, -a * a,
                                      threshold=params.threshold)
                    beta = 2.0 * a * beta - a * a * beta * beta
                    beta_bar = 2.0 * a * beta_bar - a * a * beta_bar ** 2
                energy_old = energy
                energy = real_scalar(alg.dot(x, wh))
                total = ii
                monitor.append(energy - energy_old)
                ilog.step(**{"Energy Value": energy})
                if monitor.check_converged(params.be_verbose):
                    break
        finish_iterations(params, total + 1, x, monitor=monitor,
                          solver="Density Matrix Solver")

        x = maybe_unpermute(params, x)
        k = deorthogonalize(x, isq, isqt, params)
    return k, energy


def dense_density(h, isq, trace, params: SolverParameters | None = None):
    """Dense (eigendecomposition) density solver (reference
    DensityMatrixSolversModule.F90:1120-1163 -> ComputeDenseFOE)."""
    from .fermi import compute_dense_foe
    return compute_dense_foe(h, isq, trace, params=params)


def energy_density_matrix(h, d, threshold=0.0):
    """EDM = D H D (reference DensityMatrixSolversModule.F90:1165-1189)."""
    return alg.matmul(d, alg.matmul(h, d, threshold=threshold),
                      threshold=threshold)


def mcweeny_step(d, s=None, threshold=0.0):
    """D' = 3 DSD - 2 DSDSD (reference
    DensityMatrixSolversModule.F90:1190-1233); S defaults to identity."""
    if s is not None:
        ds = alg.matmul(d, s, threshold=threshold)
    else:
        ds = d
    dsd = alg.matmul(ds, d, threshold=threshold)
    dsdsd = alg.matmul(ds, dsd, threshold=threshold)
    return alg.increment(dsd, dsdsd, 3.0, -2.0, threshold=threshold)
