"""Benchmarks: the BASELINE.md config list on one device.

Usage: ``python bench.py`` runs every config, each in its own process
(one JAX process holds the card at a time), and exits non-zero if any
config failed; ``python bench.py --config NAME`` runs one.

Prints one JSON line per config, the headline (threshold-filtered SpGEMM
throughput, the inner loop of every solver) LAST.  Every line names the
device it ran on (platform, device_kind, count).  nnz/s counts nonzeros
processed per multiply (nnz(A) + nnz(B) + nnz(C)), the accounting NTPoly's
linear-scaling claims use.  The configs (BASELINE.md configs 1-4:
Hotelling inverse, TRS4 wall-time-to-tolerance on a ~10k hydrogen chain,
complex ISQ+sign, Chebyshev exp/log on a graph Laplacian) have no
published reference numbers (the reference repo ships none in-tree), so
vs_baseline is null.  Every multiply runs float32 at FP32
(lax.Precision.HIGHEST: no TF32).
"""
import io
import json
import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _device():
    import jax
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def _emit(metric, value, unit, vs_baseline=None, **extra):
    rec = {"metric": metric, "value": value, "unit": unit,
           "vs_baseline": vs_baseline}
    rec.update(extra)
    rec["device"] = _device()
    print(json.dumps(rec), flush=True)


class _SolveLog:
    """Capture a solver's YAML trace in memory (no files)."""

    def __enter__(self):
        from ntpoly_tpu.utils.logging import activate_logger
        self.text = io.StringIO()
        activate_logger(self.text)
        return self

    def __exit__(self, *exc):
        from ntpoly_tpu.utils.logging import deactivate_logger
        deactivate_logger()
        return False

    @property
    def iterations(self):
        return _solve_stats(self.text.getvalue())


def _solve_stats(log_text):
    """Iteration count of the last solve in a YAML solver trace."""
    hits = re.findall(r"Total Iterations: (\d+)", log_text)
    return int(hits[-1]) if hits else None


def _sync(mat):
    """Wait for the device to finish computing ``mat``."""
    mat.blocks.block_until_ready()


def _chain(dim, bandwidth, dtype=np.float32):
    from __graft_entry__ import _chain_hamiltonian
    i, j, v = _chain_hamiltonian(dim, bandwidth=bandwidth)
    return i, j, v.astype(dtype)


def _gapped_chain(dim, bandwidth, dtype=np.float32):
    """Insulating (gapped) chain: staggered +-1 on-site energies open a
    band gap at half filling — purification needs a gap to converge, and
    linear-scaling methods target insulators."""
    i, j, v = _chain(dim, bandwidth, dtype)
    stagger = np.where(i % 2 == 0, 0.15, -0.15).astype(dtype)
    v = np.where(i == j, stagger, 0.25 * v).astype(dtype)
    return i, j, v


def _fill(dim, bs, grid, i, j, v, k=1):
    from ntpoly_tpu.parallel import pmatrix as PM
    h = PM.empty(dim, bs=bs, dtype=v.dtype, grid=grid, k=k)
    return PM.fill_from_triplets(h, i, j, v)


def _chain_fn(dim):
    """Device-side value function of the tight-binding chain
    (_chain_hamiltonian's closed form, for PM.fill_banded)."""
    import jax.numpy as jnp

    def fn(i, j):
        off = jnp.abs(i - j).astype(jnp.float32)
        hop = 1.0 / (1.0 + off) ** 2
        diag = -1.0 + 2.0 * i.astype(jnp.float32) / (dim - 1)
        return jnp.where(off == 0, diag, hop)
    return fn


def _gapped_fn():
    """Device-side value function of the gapped (insulating) chain."""
    import jax.numpy as jnp

    def fn(i, j):
        off = jnp.abs(i - j).astype(jnp.float32)
        hop = 0.25 / (1.0 + off) ** 2
        stag = jnp.where(i % 2 == 0, 0.15, -0.15)
        return jnp.where(off == 0, stag, hop)
    return fn


def _slope(make_run, reps):
    """Seconds per step of a compiled n-step chain: the slope between an
    n-step and a 3n-step run (best of 3 each), which cancels the fixed
    dispatch and readback cost of one call."""
    t = {}
    for n in (reps, 3 * reps):
        fn = make_run(n)
        float(fn())                       # compile + settle
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            float(fn())
            times.append(time.perf_counter() - t0)
        t[n] = min(times)
    return (t[3 * reps] - t[reps]) / (2 * reps)


def _trs4_iteration_slope(h, imat, k_pin, threshold, reps=6):
    """Slope-timed COMPUTE seconds per TRS4 iteration at this shape: a
    full iteration body scanned n and 3n times.  This is the
    `compute_s_per_iteration` the wall number can be compared against."""
    import jax
    import jax.numpy as jnp
    from ntpoly_tpu.parallel import algebra as alg
    from ntpoly_tpu.solvers.common import pad_capacity

    x0 = pad_capacity(h, k_pin)
    trace_t = jnp.float32(h.dim // 2)

    def step_once(xc, imatc):
        with alg.capacity_policy(k_out=k_pin, on_overflow="truncate"):
            x2 = alg.matmul(xc, xc, threshold=threshold)
            d1 = jnp.real(alg.dot(x2, xc))
            d2 = jnp.real(alg.dot(x2, x2))
            t2 = jnp.real(alg.trace(x2))
            sigma = jnp.where(jnp.abs(t2 - 2 * d1 + d2) < 1e-14, 3.0,
                              (trace_t - (4 * d1 - 3 * d2))
                              / (t2 - 2 * d1 + d2))
            poly = alg.increment(
                alg.increment(x2, xc, sigma - 3.0, 4.0 - 2.0 * sigma,
                              threshold=threshold),
                imatc, 1.0, sigma, threshold=threshold)
            x_mid = alg.matmul(x2, poly, threshold=threshold)
        return x_mid

    def make_run(n):
        @jax.jit
        def run(x_in, imat_in):
            def body(carry, aa):
                # scale the OPERAND so no stage is loop-invariant
                xs = x_in.with_data(x_in.col_ids, x_in.blocks * aa)
                out = step_once(xs, imat_in)
                return carry + jnp.sum(jnp.abs(out.blocks)) * 1e-30, None
            tot, _ = jax.lax.scan(body, jnp.zeros((), jnp.float32),
                                  jnp.linspace(1., 2., n, jnp.float32))
            return tot
        return lambda: run(x0, imat)

    return _slope(make_run, reps)


def _oracle_rel_err(mat, ref_dense):
    """Relative Frobenius error of a device result vs a host f64 oracle —
    the reference's acceptance bar (UnitTests/helpers.py:13)."""
    from ntpoly_tpu.parallel import pmatrix as PM
    r, c, v = PM.to_triplets(mat)
    got = np.zeros(ref_dense.shape, ref_dense.dtype)
    got[r, c] = v.astype(ref_dense.dtype)
    return float(np.linalg.norm(got - ref_dense)
                 / np.linalg.norm(ref_dense))


def _multiply_chain(h, k_out, threshold, n):
    """A compiled chain of n multiplies — how every solver iteration runs
    (lax.scan around matmul).  The OPERAND is scaled by the per-step
    scalar so XLA's loop-invariant code motion cannot hoist any stage."""
    import jax
    import jax.numpy as jnp
    from ntpoly_tpu.parallel import algebra as alg

    @jax.jit
    def chain(x):
        def step(carry, aa):
            xs = x.with_data(x.col_ids, x.blocks * aa)
            c = alg.matmul(xs, x, threshold=threshold, k_out=k_out,
                           on_overflow="truncate")
            return carry + c.blocks[0, 0, 0, 0, 0], None
        tot, _ = jax.lax.scan(step, jnp.zeros((), jnp.float32),
                              jnp.linspace(1.0, 2.0, n, dtype=jnp.float32))
        return tot
    return lambda: chain(h)


def bench_spgemm(grid, on_cpu):
    """Headline: X @ X with threshold truncation on a banded Hamiltonian."""
    from ntpoly_tpu.parallel import algebra as alg

    dim = 4096 if on_cpu else 16384
    bs = 128
    h = _fill(dim, bs, grid, *_chain(dim, bandwidth=160))
    # Size the output capacity to the exact structural fill-in (NTPoly
    # sizes its memory pool the same way, GemmMatrix.f90:48-56).
    k_out = alg.fill_bound(h, h)
    threshold = 1e-6
    reps = 20 if on_cpu else 40
    method = alg._pick_method(h, h)
    c = alg.matmul(h, h, threshold=threshold, k_out=k_out,
                   on_overflow="truncate")
    dt = _slope(lambda n: _multiply_chain(h, k_out, threshold, n), reps)
    nnz = 2 * int(h.nnz) + int(c.nnz)
    _emit("spgemm_nnz_per_s", nnz / dt, "nnz/s", method=method,
          precision="fp32", ms_per_multiply=dt * 1e3)


def bench_hotelling(grid, on_cpu):
    """BASELINE config 1: Hotelling inverse of an overlap-like matrix."""
    from ntpoly_tpu.parallel import algebra as alg
    from ntpoly_tpu.solvers import inverse
    from ntpoly_tpu.solvers.parameters import SolverParameters

    dim = 1024 if on_cpu else 4096
    i, j, v = _chain(dim, bandwidth=8)
    # diagonally dominant SPD overlap
    v = np.where(i == j, 2.0 + v, 0.05 * v).astype(np.float32)
    s = _fill(dim, 128 if not on_cpu else 32, grid, i, j, v)
    # pin capacity: static shapes -> one compile per op for the whole solve
    params = SolverParameters(converge_diff=1e-6, threshold=1e-8,
                              k_out=min(s.panel_nb, 8 * s.k),
                              iters_per_sync=8, be_verbose=True)
    method = alg._pick_method(s, s)
    inverse.invert(s, params)            # warm caches
    with _SolveLog() as log:
        t0 = time.perf_counter()
        inv = inverse.invert(s, params)
        _sync(inv)
        wall = time.perf_counter() - t0
    iters = log.iterations
    s_dense = np.zeros((dim, dim))
    s_dense[i, j] = v.astype(np.float64)
    oracle = np.linalg.inv(s_dense)
    _emit("hotelling_invert_s", wall, "s", method=method,
          iterations=iters,
          s_per_iteration=(wall / iters) if iters else None,
          oracle_rel_err=_oracle_rel_err(inv, oracle))


def bench_trs4(grid, on_cpu):
    """BASELINE config 2: TRS4 wall-time-to-tolerance on a ~10k-row
    hydrogen-chain Hamiltonian (converge_diff 1e-6)."""
    from ntpoly_tpu.parallel import algebra as alg
    from ntpoly_tpu.parallel import pmatrix as PM
    from ntpoly_tpu.solvers import density
    from ntpoly_tpu.solvers.parameters import SolverParameters

    dim = 1024 if on_cpu else 10240
    bs = 32 if on_cpu else 128
    ti, tj, tv = _gapped_chain(dim, bandwidth=16)
    h = _fill(dim, bs, grid, ti, tj, tv)
    isq = PM.identity(dim, bs=bs, dtype=np.float32, grid=grid)
    nel = dim // 2                       # half filling: mu in the gap
    # k_out=8 pins just above the purification fill (~5-6 at this
    # threshold); on_overflow='grow' redoes a chunk in the rare case
    # fill spikes past the pin
    params = SolverParameters(converge_diff=1e-6, threshold=1e-7,
                              k_out=min(h.panel_nb, 8),
                              iters_per_sync=8, be_verbose=True)
    method = alg._pick_method(h, h)
    _sync(density.trs4(h, isq, float(nel), params)[0])   # warm compiles
    with _SolveLog() as log:
        t0 = time.perf_counter()
        rho, energy, mu = density.trs4(h, isq, float(nel), params)
        _sync(rho)
        wall = time.perf_counter() - t0
    iters = log.iterations
    # density vs host f64 eigendecomposition oracle (reference acceptance
    # bar, UnitTests/helpers.py:13)
    h_dense = np.zeros((dim, dim))
    h_dense[ti, tj] = tv.astype(np.float64)
    w, vec = np.linalg.eigh(h_dense)
    occ = vec[:, :nel]
    err = _oracle_rel_err(rho, occ @ occ.T)
    comp = None
    if not on_cpu:
        comp = _trs4_iteration_slope(h, isq, min(h.panel_nb, 8),
                                     params.threshold)
    _emit("trs4_10k_wall_s", wall, "s", method=method, iterations=iters,
          precision="fp32",
          s_per_iteration=(wall / iters) if iters else None,
          compute_s_per_iteration=comp,
          oracle_rel_err=err)


def bench_trs4_100k(grid, on_cpu):
    """Six-figure-dimension purification on one device: TRS4
    wall-time-to-tolerance on a 102,400-row gapped chain.

    Emits iterations, s/iteration, and the density's invariant
    certificates so a convergence regression is distinguishable from a
    kernel regression."""
    from ntpoly_tpu.parallel import pmatrix as PM
    from ntpoly_tpu.solvers import density
    from ntpoly_tpu.solvers.parameters import SolverParameters

    dim = 4096 if on_cpu else 102400
    bs = 32 if on_cpu else 128
    h = _fill(dim, bs, grid, *_gapped_chain(dim, bandwidth=16))
    isq = PM.identity(dim, bs=bs, dtype=np.float32, grid=grid)
    nel = dim // 2
    params = SolverParameters(converge_diff=1e-6, threshold=1e-7,
                              k_out=min(h.panel_nb, 8),
                              iters_per_sync=8, be_verbose=True)
    # warm: one chunk compiles the whole iteration graph at these shapes
    warm = params.copy()
    warm.be_verbose = False
    warm.max_iterations = warm.iters_per_sync
    _sync(density.trs4(h, isq, float(nel), warm)[0])
    with _SolveLog() as log:
        t0 = time.perf_counter()
        rho, energy, mu = density.trs4(h, isq, float(nel), params)
        _sync(rho)
        wall = time.perf_counter() - t0
    iters = log.iterations
    comp = None
    if not on_cpu:
        comp = _trs4_iteration_slope(h, isq, min(h.panel_nb, 8),
                                     params.threshold, reps=4)
    _emit("trs4_100k_wall_s", wall, "s", dim=dim, iterations=iters,
          s_per_iteration=(wall / iters) if iters else None,
          compute_s_per_iteration=comp, rho_nnz=int(rho.nnz),
          **_purity_invariants(rho, h, float(nel),
                               threshold=params.threshold))


def bench_fill_1m(grid, on_cpu):
    """Million-row construction + one threshold-filtered multiply on one
    device.

    Construction is DEVICE-SIDE (PM.fill_banded: analytic band structure
    + elementwise value function under jit).  The generic triplet path
    (backed by the threaded native/blockfill.cpp where it builds) is
    timed separately at a smaller dim so its regression is still
    visible."""
    from ntpoly_tpu.parallel import algebra as alg
    from ntpoly_tpu.parallel import pmatrix as PM

    dim = 131072 if on_cpu else 1048576
    bs = 128
    t0 = time.perf_counter()
    h = PM.banded(dim, 24, _chain_fn(dim), bs=bs, grid=grid,
                  dtype=np.float32)
    _sync(h)
    fill_s = time.perf_counter() - t0
    # generic triplet path (host parse + native block build + upload)
    tdim = 32768 if on_cpu else 262144
    t0 = time.perf_counter()
    ht = _fill(tdim, bs, grid, *_chain(tdim, bandwidth=24))
    _sync(ht)
    triplet_fill_s = time.perf_counter() - t0
    k_out = alg.fill_bound(h, h)
    c = alg.matmul(h, h, threshold=1e-6, k_out=k_out,
                   on_overflow="truncate")     # compile + run
    _sync(c)
    mult_s = _slope(lambda n: _multiply_chain(h, k_out, 1e-6, n),
                    4 if on_cpu else 8)
    nnz = 2 * int(h.nnz) + int(c.nnz)
    _emit("fill_1m_s", fill_s, "s", dim=dim, nnz=int(h.nnz),
          method="device_banded", triplet_fill_s=triplet_fill_s,
          triplet_fill_dim=tdim, multiply_s=mult_s,
          multiply_nnz_per_s=nnz / mult_s)


def _purity_invariants(rho, h, nel, threshold=1e-7):
    """On-device correctness certificates for a converged density matrix,
    computable with three extra multiplies:

      idempotency_rel = ||K^2 - K||_F / ||K||_F      (K a projector)
      trace_abs_err   = |tr K - nel|                 (electron count)
      commutator_rel  = ||KH - HK||_F / ||KH||_F     ([K, H] = 0)

    Residuals are formed EXPLICITLY before the norm dots (a difference
    of large dot products would cancel catastrophically in f32); the
    trace rides the compensated pair."""
    from ntpoly_tpu.parallel import algebra as alg

    k2 = alg.matmul(rho, rho, threshold=threshold)
    r = alg.increment(k2, rho, 1.0, -1.0)
    del k2
    idem = float(np.sqrt(max(np.real(np.asarray(alg.dot(r, r))), 0.0)
                         / np.real(np.asarray(alg.dot(rho, rho)))))
    del r
    tr = alg.host_pair(alg.trace_pair(rho))
    kh = alg.matmul(rho, h, threshold=threshold)
    hk = alg.matmul(h, rho, threshold=threshold)
    c = alg.increment(kh, hk, 1.0, -1.0)
    del hk
    comm = float(np.sqrt(max(np.real(np.asarray(alg.dot(c, c))), 0.0)
                         / np.real(np.asarray(alg.dot(kh, kh)))))
    return {"idempotency_rel": idem,
            "trace_abs_err": abs(tr - nel),
            "commutator_rel": comm}


def bench_trs4_1m(grid, on_cpu):
    """BASELINE config 5 (single-device leg): TRS4 purification on a
    2^20-row gapped chain.  Construction is device-side; capacity is
    pinned to keep the live set small."""
    from ntpoly_tpu.parallel import pmatrix as PM
    from ntpoly_tpu.solvers import density
    from ntpoly_tpu.solvers.parameters import SolverParameters

    dim = 8192 if on_cpu else 1048576
    bs = 32 if on_cpu else 128
    h = PM.banded(dim, 16, _gapped_fn(), bs=bs, grid=grid,
                  dtype=np.float32)
    isq = PM.identity(dim, bs=bs, dtype=np.float32, grid=grid)
    nel = dim // 2
    # k_out: at bs=128 the purification band spread (~100 elements at
    # this threshold) stays within +-1 block, so 5 slots cover it; the
    # CPU variant at bs=32 needs more.  'warn' (not 'grow') keeps carry
    # donation legal — the warning is the honesty signal.  Eager
    # iterations (iters_per_sync=1) free X before the polynomial
    # multiply, which keeps the peak device memory down.
    # Convergence: the idempotency VALUE metric (plateau-detected): the
    # residual decays quadratically to the f32 floor, after which an
    # energy-difference criterion only sees f32 noise.  The REPORTED
    # energy rides the compensated (hi, lo) pair (comp_sum, certified vs
    # a float64 oracle in tests/test_bell.py), and the converged state
    # carries invariant certificates (idempotency, trace, commutator).
    params = SolverParameters(converge_diff=1e-3, threshold=1e-7,
                              iters_per_sync=1,
                              compensated_scalars=True,
                              convergence_metric="idempotency",
                              k_out=10 if on_cpu else 5,
                              on_overflow="warn", be_verbose=True)
    warm = params.copy()
    warm.be_verbose = False
    warm.max_iterations = 2
    _sync(density.trs4(h, isq, float(nel), warm)[0])
    with _SolveLog() as log:
        t0 = time.perf_counter()
        rho, energy, mu = density.trs4(h, isq, float(nel), params)
        _sync(rho)
        wall = time.perf_counter() - t0
    iters = log.iterations
    rho_nnz = int(rho.nnz)
    # 2 SpGEMMs per TRS4 iteration; nnz/s counts processed nonzeros
    nnz_per_iter = 2 * (2 * int(h.nnz) + rho_nnz)
    _emit("trs4_1m_wall_s", wall, "s", dim=dim, iterations=iters,
          s_per_iteration=(wall / iters) if iters else None,
          rho_nnz=rho_nnz,
          nnz_per_s=(iters * nnz_per_iter / wall) if iters else None,
          convergence="idempotency plateau",
          **_purity_invariants(rho, h, float(nel),
                               threshold=params.threshold))


def _complex_overlap(dim):
    """Hermitian SPD complex overlap with condition number ~1e3 (graded
    diagonal), as triplets."""
    i, j, v = _chain(dim, bandwidth=6)
    diag = np.geomspace(1.0, 1e3, dim).astype(np.float32)
    vals = np.where(i == j, diag[i], 0.05 * v * (1.0 + 0.5j)
                    ).astype(np.complex64)
    vals = np.where(i < j, np.conj(vals), vals)
    return i, j, vals


def bench_complex_isq_sign(grid, on_cpu):
    """BASELINE config 3: inverse square root + sign function on an
    ill-conditioned complex Hermitian overlap, in native complex64."""
    from ntpoly_tpu.parallel import algebra as alg
    from ntpoly_tpu.solvers import squareroot, sign
    from ntpoly_tpu.solvers.parameters import SolverParameters

    dim = 512 if on_cpu else 2048
    bs = 32 if on_cpu else 128
    i, j, vals = _complex_overlap(dim)
    s = _fill(dim, bs, grid, i, j, vals)
    params = SolverParameters(converge_diff=1e-6, threshold=1e-9,
                              k_out=min(s.panel_nb, 8 * s.k),
                              iters_per_sync=8)
    method = alg._pick_method(s, s)
    _sync(squareroot.inverse_square_root(s, params))     # warm compiles
    _sync(sign.sign_function(s, params))
    t0 = time.perf_counter()
    isq = squareroot.inverse_square_root(s, params)
    _sync(isq)
    sg = sign.sign_function(s, params)
    _sync(sg)
    wall = time.perf_counter() - t0
    # host f64 complex oracle (eigendecomposition)
    s_dense = np.zeros((dim, dim), np.complex128)
    s_dense[i, j] = vals.astype(np.complex128)
    w, vec = np.linalg.eigh(s_dense)
    isq_ref = (vec / np.sqrt(w)[None, :]) @ np.conj(vec).T
    sgn_ref = (vec * np.sign(w)[None, :]) @ np.conj(vec).T
    _emit("complex_isq_sign_wall_s", wall, "s", method=method,
          isq_oracle_rel_err=_oracle_rel_err(isq, isq_ref),
          sign_oracle_rel_err=_oracle_rel_err(sg, sgn_ref))


def bench_cheby_exp_log(grid, on_cpu):
    """BASELINE config 4: Chebyshev exponential + logarithm on a graph
    Laplacian (Examples/GraphTheory workload)."""
    from ntpoly_tpu.parallel import algebra as alg
    from ntpoly_tpu.solvers import exponential
    from ntpoly_tpu.solvers.parameters import SolverParameters

    dim = 1024 if on_cpu else 4096
    bs = 32 if on_cpu else 128
    # ring Laplacian
    i = np.arange(dim)
    rows = np.concatenate([i, i, i])
    cols = np.concatenate([i, (i + 1) % dim, (i - 1) % dim])
    vals = np.concatenate([np.full(dim, 2.0), np.full(dim, -1.0),
                           np.full(dim, -1.0)])
    lap = _fill(dim, bs, grid, rows, cols,
                (-0.25 * vals).astype(np.float32))
    params = SolverParameters(threshold=1e-9,
                              k_out=min(lap.panel_nb, 16 * lap.k))
    method = alg._pick_method(lap, lap)
    emat = exponential.compute_exponential(lap, params)  # warm compiles
    _sync(emat)
    _sync(exponential.compute_logarithm(emat, params))
    t0 = time.perf_counter()
    emat = exponential.compute_exponential(lap, params)
    _sync(emat)
    lmat = exponential.compute_logarithm(emat, params)
    _sync(lmat)
    wall = time.perf_counter() - t0
    # host f64 eigendecomposition oracle for exp(L); log(exp(L)) must
    # recover L itself
    lap_dense = np.zeros((dim, dim))
    np.add.at(lap_dense, (rows, cols), -0.25 * vals)
    w, vec = np.linalg.eigh(lap_dense)
    exp_ref = (vec * np.exp(w)[None, :]) @ vec.T
    _emit("cheby_exp_log_wall_s", wall, "s", method=method,
          exp_oracle_rel_err=_oracle_rel_err(emat, exp_ref),
          log_oracle_rel_err=_oracle_rel_err(lmat, lap_dense))


CONFIGS = {
    "spgemm": bench_spgemm,
    "hotelling": bench_hotelling,
    "trs4": bench_trs4,
    "trs4_100k": bench_trs4_100k,
    "trs4_1m": bench_trs4_1m,
    "fill_1m": bench_fill_1m,
    "complex": bench_complex_isq_sign,
    "cheby": bench_cheby_exp_log,
}

# Printed order: headline LAST.
ORDER = ["hotelling", "trs4", "trs4_100k", "trs4_1m", "fill_1m", "complex",
         "cheby", "spgemm"]


def run_one(name):
    import jax
    from ntpoly_tpu.parallel.grid import ProcessGrid
    from ntpoly_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache(os.path.join(ROOT, ".jax_cache"))
    on_cpu = jax.devices()[0].platform == "cpu"
    grid = ProcessGrid(1, 1, 1, devices=jax.devices()[:1])
    CONFIGS[name](grid, on_cpu)


def main():
    """Run every config in its own process, one after another (one JAX
    process holds the card at a time); print their lines in ORDER and
    exit non-zero if any config failed."""
    import subprocess

    lines, failed = {}, []
    for name in ORDER:
        res = subprocess.run([sys.executable, __file__, "--config", name],
                             capture_output=True, text=True)
        got = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
        if res.returncode != 0 or not got:
            tail = (res.stderr or "").strip().splitlines()[-1:]
            print(f"# {name}: failed rc={res.returncode} {tail}",
                  file=sys.stderr)
            failed.append(name)
        lines[name] = got
    for name in ORDER:
        for ln in lines[name]:
            print(ln, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--config":
        run_one(sys.argv[2])
    else:
        sys.exit(main())
