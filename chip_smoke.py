"""Chip smoke test: the purification path on the GPU, checked.

    python chip_smoke.py                # phases A-C on one GPU
    python chip_smoke.py --four-cards   # phase-B TRS4 on three grids, 4 GPUs

Phases (one process; every multiply runs float32 at FP32, i.e.
lax.Precision.HIGHEST: no TF32 and no bf16 passes):

  A  the local multiply tiers (acc, cand, dense and the Triton-route
     kernel, compiled for the card) on one shard at bs=128, 64 block-rows,
     K=8, at two block densities, with a threshold and alpha != 1, against
     a float64 NumPy product; then the kernel against the plain XLA tier
     (cand) on the banded operand of the 102,400-row solve (800
     block-rows);
  B  TRS4 through the public API (ConstructGlobalProcessGrid, Matrix_ps,
     DensityMatrixSolvers.TRS4) on the 102,400-row gapped chain, with
     idempotency / commutator / trace certificates, and at 10,240 rows
     against a dense float64 eigh oracle;
  C  native complex64 inverse square root and sign of the 2,048-row
     complex Hermitian overlap against a float64 oracle.

``--four-cards`` runs only the phase-B solve, on grids (1,1,1), (2,2,1)
and (1,1,4); energies must agree and every grid must pass the
certificates.

Exits non-zero, with no result line, unless the first JAX device is a GPU
and every phase passed.  The last line on success is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Bars.  Phase A: FP32 products summed over 128 * K terms stay near
# 1e-6 relative (TF32 would be ~1e-3); the threshold (1e-3 against
# entries of order 10) flushes a few hundred entries, and a flush decision
# that differs at the threshold moves the error by at most 1e-3 each.
# Phase B: the reference's acceptance bar (UnitTests/helpers.py:13) for
# the oracle and the idempotency/commutator certificates; the trace is
# reset every TRS4 iteration.  Phase C: the reference bar.
BARS = {"tier_rel_fro": 1e-5, "oracle_rel": 1e-4, "idempotency_rel": 1e-4,
        "commutator_rel": 1e-4, "trace_rel": 1e-5, "energy_rel": 1e-4}
BIG_DIM, ORACLE_DIM, COMPLEX_DIM = 102400, 10240, 2048


class PhaseFailed(Exception):
    pass


def _check(name, value, bar):
    ok = bool(np.isfinite(value)) and value <= bar
    print(f"  {name} = {value:.3e} (bar {bar:.0e}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise PhaseFailed(f"{name} = {value} exceeds {bar}")


def _card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def _time(fn, reps=5):
    """Median wall seconds of fn() (fn waits for the device)."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ----------------------------------------------------------------------------
# phase A: local multiply tiers
# ----------------------------------------------------------------------------

def _random_bell(rng, nb, k, nblk, bs):
    """Block-ELL arrays [1, nb, k] with nblk random blocks per row."""
    from ntpoly_tpu.config import EMPTY
    cols = np.full((1, nb, k), EMPTY, np.int32)
    blocks = np.zeros((1, nb, k, bs, bs), np.float32)
    for r in range(nb):
        cols[0, r, :nblk] = np.sort(rng.choice(nb, nblk, replace=False))
        blocks[0, r, :nblk] = rng.standard_normal((nblk, bs, bs))
    return cols, blocks


def _dense(cols, blocks, nb, bs):
    out = np.zeros((nb * bs, nb * bs))
    for r, s in zip(*np.nonzero(cols[0] < nb)):
        c = cols[0, r, s]
        out[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = blocks[0, r, s]
    return out


TIERS = ("acc", "cand", "dense", "triton")


def _multiply(alg, a, b, tier, **kw):
    out = alg.matmul(a, b, method=tier, on_overflow="truncate", **kw)
    out.blocks.block_until_ready()
    return out


def phase_a(grid, nb=64, k=8, bs=128, seed=0):
    """Each tier against a float64 product; returns {(nblk, tier): ms}."""
    import jax
    from ntpoly_tpu.parallel import algebra as alg
    from ntpoly_tpu.parallel import pmatrix as PM

    rng = np.random.default_rng(seed)
    alpha, thr = 0.75, 1e-3
    sh = grid.matrix_sharding
    times = {}
    for nblk in (k // 2, k):
        mats = []
        for _ in range(2):
            c, b = _random_bell(rng, nb, k, nblk, bs)
            mats.append((PM.PSMatrix(jax.device_put(c, sh),
                                     jax.device_put(b, sh), nb * bs, bs,
                                     grid), _dense(c, b, nb, bs)))
        (a, ad), (b, bd) = mats
        ref = alpha * (ad @ bd)
        ref[np.abs(ref) <= thr] = 0.0
        print(f"phase A: {nb} block-rows, bs={bs}, K={k}, {nblk} blocks/row "
              f"(block density {nblk / nb:.4f}), alpha={alpha}, "
              f"threshold={thr}; FP32 (HIGHEST)", flush=True)
        for tier in TIERS:
            def run(tier=tier):
                return _multiply(alg, a, b, tier, alpha=alpha,
                                 threshold=thr, k_out=nb)
            got = np.asarray(PM.to_dense(run()), np.float64)
            err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            times[(nblk, tier)] = _time(run) * 1e3
            print(f"  {tier}: {times[(nblk, tier)]:.3f} ms/multiply",
                  flush=True)
            _check(f"{tier} rel_fro_err", err, BARS["tier_rel_fro"])
    return times


def _band_bell(rng, nb, k, bs):
    """Block-ELL [1, nb, k] with block cols r-1..r+1 (the shape of the
    purification iterate), the rest EMPTY."""
    from ntpoly_tpu.config import EMPTY
    cols = np.full((1, nb, k), EMPTY, np.int32)
    blocks = np.zeros((1, nb, k, bs, bs), np.float32)
    for r in range(nb):
        c = [x for x in (r - 1, r, r + 1) if 0 <= x < nb]
        cols[0, r, :len(c)] = c
        blocks[0, r, :len(c)] = 0.01 * rng.standard_normal((len(c), bs, bs))
    return cols, blocks


def phase_a_kernel(grid, nb=800, k=8, bs=128, seed=1):
    """The kernel against the plain XLA tier (cand) at the solve's width."""
    import jax
    from ntpoly_tpu.parallel import algebra as alg
    from ntpoly_tpu.parallel import pmatrix as PM

    c, b = _band_bell(np.random.default_rng(seed), nb, k, bs)
    sh = grid.matrix_sharding
    x = PM.PSMatrix(jax.device_put(c, sh), jax.device_put(b, sh), nb * bs,
                    bs, grid)
    print(f"phase A: kernel vs cand on the banded iterate, {nb} block-rows,"
          f" capacity {k}, bs={bs}, threshold 1e-7; FP32 (HIGHEST)",
          flush=True)
    out = {}
    for tier in ("cand", "triton"):
        def run(tier=tier):
            return _multiply(alg, x, x, tier, threshold=1e-7, k_out=k)
        out[tier] = run()
        print(f"  {tier}: {_time(run) * 1e3:.3f} ms/multiply", flush=True)
    ref, got = out["cand"], out["triton"]
    if not bool(np.array_equal(np.asarray(ref.col_ids),
                               np.asarray(got.col_ids))):
        raise PhaseFailed("kernel and cand disagree on the output pattern")
    res = alg.increment(got, ref, 1.0, -1.0)
    diff = float(np.sqrt(np.real(np.asarray(alg.dot(res, res)))
                         / np.real(np.asarray(alg.dot(ref, ref)))))
    _check("triton vs cand rel_fro_diff", diff, BARS["tier_rel_fro"])


# ----------------------------------------------------------------------------
# phase B: TRS4 through the public API
# ----------------------------------------------------------------------------

def _triplets(nt, i, j, v):
    """A TripletList (1-based, as the API takes it) from NumPy arrays."""
    tl = nt.TripletList_c() if np.iscomplexobj(v) else nt.TripletList_r()
    tl.rows = (np.asarray(i) + 1).tolist()
    tl.columns = (np.asarray(j) + 1).tolist()
    tl.values = np.asarray(v).tolist()
    return tl


def trs4_api(nt, dim, grid_shape):
    """TRS4 on the gapped chain through the public API.  Returns
    (density Matrix_ps, hamiltonian Matrix_ps, stats dict)."""
    import bench
    from ntpoly_tpu.parallel import algebra as alg

    nt.ConstructGlobalProcessGrid(*grid_shape)
    i, j, v = bench._gapped_chain(dim, bandwidth=16)
    ham = nt.Matrix_ps(dim)
    ham.FillFromTripletList(_triplets(nt, i, j, v))
    isq = nt.Matrix_ps(dim)
    isq.FillIdentity()
    nel = dim // 2
    params = nt.SolverParameters()
    params.SetConvergeDiff(1e-6)
    params.SetThreshold(1e-7)
    params.SetItersPerSync(8)
    rho = nt.Matrix_ps(dim)

    def solve():
        t0 = time.perf_counter()
        energy, _ = nt.DensityMatrixSolvers.TRS4(ham, isq, nel, rho, params)
        rho._m.blocks.block_until_ready()
        return energy, time.perf_counter() - t0

    _, first = solve()                                   # compiles
    energy, wall = solve()                               # timed, quiet
    params.SetVerbosity(True)
    with bench._SolveLog() as log:                       # iteration count
        solve()
    iters = log.iterations
    stats = {"dim": dim, "grid": grid_shape, "energy": float(energy),
             "first_solve_s": first, "wall_s": wall, "iterations": iters,
             "s_per_iteration": wall / iters if iters else None,
             "tier": alg._pick_method(rho._m, rho._m), "nel": nel}
    print(f"  TRS4 dim={dim} grid={grid_shape}: wall {wall:.3f} s, "
          f"{iters} iterations, {stats['s_per_iteration']:.4f} s/iteration"
          f" (first solve incl. compile {first:.1f} s), tier "
          f"{stats['tier']}, energy {energy:.6f}, FP32 (HIGHEST)",
          flush=True)
    return rho, ham, stats


def _certify(rho, ham, stats):
    import bench
    cert = bench._purity_invariants(rho._m, ham._m, float(stats["nel"]),
                                    threshold=1e-7)
    _check("idempotency_rel", cert["idempotency_rel"],
           BARS["idempotency_rel"])
    _check("commutator_rel", cert["commutator_rel"], BARS["commutator_rel"])
    _check("|tr K - N_el| / N_el", cert["trace_abs_err"] / stats["nel"],
           BARS["trace_rel"])
    return cert


def phase_b(nt):
    import bench
    print(f"phase B: TRS4 on the gapped chain, {BIG_DIM} rows, bs=128, "
          "float32", flush=True)
    rho, ham, stats = trs4_api(nt, BIG_DIM, (1, 1, 1))
    _certify(rho, ham, stats)
    del rho, ham
    print(f"phase B: TRS4 at {ORACLE_DIM} rows against a float64 eigh "
          "oracle", flush=True)
    rho, _, _ = trs4_api(nt, ORACLE_DIM, (1, 1, 1))
    i, j, v = bench._gapped_chain(ORACLE_DIM, bandwidth=16)
    h = np.zeros((ORACLE_DIM, ORACLE_DIM))
    h[i, j] = v.astype(np.float64)
    _, vec = np.linalg.eigh(h)
    occ = vec[:, :ORACLE_DIM // 2]
    _check("oracle_rel_err", bench._oracle_rel_err(rho._m, occ @ occ.T),
           BARS["oracle_rel"])
    return stats


# ----------------------------------------------------------------------------
# phase C: native complex
# ----------------------------------------------------------------------------

def phase_c(nt, dim=COMPLEX_DIM):
    import bench
    print(f"phase C: complex64 ISQ and sign, {dim} rows, native complex",
          flush=True)
    nt.ConstructGlobalProcessGrid(1, 1, 1)
    i, j, vals = bench._complex_overlap(dim)
    s = nt.Matrix_ps(dim)
    s.FillFromTripletList(_triplets(nt, i, j, vals))
    if s._embedded or not np.iscomplexobj(np.zeros(1, s._m.dtype)):
        raise PhaseFailed("complex matrix was not held natively")
    params = nt.SolverParameters()
    params.SetConvergeDiff(1e-6)
    params.SetThreshold(1e-9)
    params.SetItersPerSync(8)
    isq, sgn = nt.Matrix_ps(dim), nt.Matrix_ps(dim)
    t0 = time.perf_counter()
    nt.SquareRootSolvers.InverseSquareRoot(s, isq, params)
    nt.SignSolvers.ComputeSign(s, sgn, params)
    sgn._m.blocks.block_until_ready()
    print(f"  ISQ + sign (incl. compile): {time.perf_counter() - t0:.2f} s",
          flush=True)
    dense = np.zeros((dim, dim), np.complex128)
    dense[i, j] = vals.astype(np.complex128)
    w, vec = np.linalg.eigh(dense)
    isq_ref = (vec / np.sqrt(w)[None, :]) @ np.conj(vec).T
    sgn_ref = (vec * np.sign(w)[None, :]) @ np.conj(vec).T
    _check("isq oracle_rel_err", bench._oracle_rel_err(isq._m, isq_ref),
           BARS["oracle_rel"])
    _check("sign oracle_rel_err", bench._oracle_rel_err(sgn._m, sgn_ref),
           BARS["oracle_rel"])


def four_cards(nt):
    """Phase-B TRS4 on (1,1,1), (2,2,1) and (1,1,4): same energy, and
    each grid passes the certificates."""
    energies = {}
    for shape in ((1, 1, 1), (2, 2, 1), (1, 1, 4)):
        print(f"four cards: TRS4 {BIG_DIM} rows on grid {shape}",
              flush=True)
        rho, ham, stats = trs4_api(nt, BIG_DIM, shape)
        _certify(rho, ham, stats)
        energies[shape] = stats["energy"]
        del rho, ham
    e0 = energies[(1, 1, 1)]
    for shape, e in energies.items():
        _check(f"energy rel diff {shape} vs (1, 1, 1)",
               abs(e - e0) / abs(e0), BARS["energy_rel"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the phase-B TRS4 on three grids over "
                         "four GPUs")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from ntpoly_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache(os.path.join(ROOT, ".jax_cache"))
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    if args.four_cards and len(devs) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    print(_card_line(), flush=True)
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}",
          flush=True)
    import ntpoly_tpu as nt
    from ntpoly_tpu.parallel.grid import ProcessGrid

    phases = ([("four cards", lambda: four_cards(nt))] if args.four_cards
              else [("A", lambda: (phase_a(ProcessGrid(1, 1, 1)),
                                   phase_a_kernel(ProcessGrid(1, 1, 1)))),
                    ("B", lambda: phase_b(nt)),
                    ("C", lambda: phase_c(nt))])
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except PhaseFailed as e:
            print(f"phase {name} FAILED: {e}", file=sys.stderr)
            return 1
        print(f"phase {name} passed in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
