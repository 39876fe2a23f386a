"""The local multiply tiers and their dispatch.

Every tier ('acc', 'cand', 'dense' and the Triton-route kernel in
interpret mode) against a NumPy oracle on one shard, the way the reference
tests its local multiply against scipy (reference UnitTests/test_matrix.py);
the structural fill pass; the auto dispatch (``_pick_method``) on a
GPU-platform grid; the precision knob; and ``chip_smoke.py``'s refusal to
run without a GPU.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from ntpoly_tpu.config import EMPTY
from ntpoly_tpu.core import bell
from ntpoly_tpu.ops import spgemm_triton

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ("acc", "cand", "dense", "triton")


def rand_block_sparse(rng, nbr, nbc, bs, density=0.4):
    d = rng.standard_normal((nbr * bs, nbc * bs))
    mask = rng.random((nbr, nbc)) < density
    return d * np.kron(mask, np.ones((bs, bs)))


def to_bell(dense, bs, k):
    return bell.from_dense(jnp.asarray(dense, np.float32), bs=bs, k=k)


def local_multiply(method, ac, ab, bc, bb, *, nb, k_out, threshold=0.0,
                   alpha=1.0):
    """One shard's C = alpha * A @ B through the named tier."""
    if method == "acc":
        return bell.spgemm(ac, ab, bc, bb, col_offset=0, nbc_out=nb,
                           k_out=k_out, threshold=threshold, alpha=alpha,
                           row_chunk=4)
    if method == "cand":
        return bell.spgemm_candidates(ac, ab, bc, bb, col_offset=0,
                                      k_out=k_out, threshold=threshold,
                                      alpha=alpha, row_chunk=4)
    if method == "triton":
        return spgemm_triton.spgemm_triton(ac, ab, bc, bb, k_out=k_out,
                                           threshold=threshold, alpha=alpha,
                                           interpret=True)
    return bell.spgemm_dense(ac, ab, bc, bb, col_offset=0, nbc_out=nb,
                             k_out=k_out, nbk=nb, threshold=threshold,
                             alpha=alpha)


def block_pattern(dense, nb, bs):
    return (np.abs(dense) > 0).reshape(nb, bs, nb, bs).any((1, 3))


def ragged_operands(rng, nb, bs, k):
    """Rows with 1..k blocks at random columns; row 2 entirely empty."""
    ac = np.full((nb, k), EMPTY, np.int32)
    ab = np.zeros((nb, k, bs, bs), np.float32)
    for r in range(nb):
        if r == 2:
            continue
        cols = rng.choice(nb, size=rng.integers(1, k + 1), replace=False)
        for s, c in enumerate(sorted(cols)):
            ac[r, s] = c
            ab[r, s] = rng.standard_normal((bs, bs))
    dense = np.asarray(bell.to_dense(jnp.asarray(ac), jnp.asarray(ab),
                                     nbc=nb), np.float64)
    return jnp.asarray(ac), jnp.asarray(ab), dense


@pytest.mark.parametrize("case", ["density0.2", "density0.6",
                                  "threshold_alpha", "ragged_empty_row",
                                  "overflow"])
@pytest.mark.parametrize("method", METHODS)
def test_tier_matches_numpy(rng, method, case):
    nb, bs = 8, 8
    thr, alpha = 0.0, 1.0
    if case.startswith("density"):
        a = rand_block_sparse(rng, nb, nb, bs, float(case[7:]))
        b = rand_block_sparse(rng, nb, nb, bs, float(case[7:]))
        ac, ab = to_bell(a, bs, nb)
        bc, bb = to_bell(b, bs, nb)
    elif case == "threshold_alpha":
        a = b = rand_block_sparse(rng, nb, nb, bs, 0.5) * 0.1
        ac, ab = bc, bb = to_bell(a, bs, nb)
        thr, alpha = 0.05, 2.5
    elif case == "ragged_empty_row":
        ac, ab, a = ragged_operands(rng, nb, bs, 3)
        b = rand_block_sparse(rng, nb, nb, bs, 0.5)
        bc, bb = to_bell(b, bs, nb)
    else:                                  # overflow: k_out below the fill
        a = b = rand_block_sparse(rng, nb, nb, bs, 0.9)
        ac, ab = bc, bb = to_bell(a, bs, nb)
    want = alpha * (a @ b)
    want[np.abs(want) <= thr] = 0.0
    pattern = block_pattern(want, nb, bs)

    if case != "overflow":
        cc, cb = local_multiply(method, ac, ab, bc, bb, nb=nb, k_out=nb,
                                threshold=thr, alpha=alpha)
        got = np.asarray(bell.to_dense(cc, cb, nbc=nb), np.float64)
        assert np.allclose(got, want, atol=1e-4)
        ids = np.asarray(cc)
        assert [set(ids[r][ids[r] != EMPTY]) for r in range(nb)] == \
            [set(np.nonzero(pattern[r])[0]) for r in range(nb)]
        vals = np.asarray(cb)
        assert (np.abs(vals[vals != 0]) > thr).all()
        if case == "ragged_empty_row":
            assert (np.asarray(cc)[2] == EMPTY).all()
        return

    # overflow: exactly k_small blocks survive per row, each equal to the
    # full product's block at its column; cand and triton keep the lowest
    # column ids, acc and dense the largest-norm blocks
    k_small = 3
    assert int(np.max(np.asarray(bell.structural_fill(ac, bc)))) > k_small
    cc, cb = local_multiply(method, ac, ab, bc, bb, nb=nb, k_out=k_small)
    cc, cb = np.asarray(cc), np.asarray(cb)
    blocks = want.reshape(nb, bs, nb, bs).transpose(0, 2, 1, 3)
    norms = np.abs(blocks).sum((-1, -2))
    for r in range(nb):
        kept = cc[r][cc[r] != EMPTY]
        nz = np.nonzero(norms[r] > 0)[0]
        assert len(kept) == min(k_small, len(nz))
        for s, c in enumerate(cc[r]):
            if c != EMPTY:
                assert np.allclose(cb[r, s], blocks[r, c], atol=1e-4)
        if method in ("cand", "triton"):
            assert np.array_equal(kept, nz[:k_small])
        else:
            top = np.sort(np.argsort(-norms[r], kind="stable")[:k_small])
            assert np.array_equal(np.sort(kept), top)


def test_structure_plan_slots(rng):
    """structural_fill counts the distinct output block-columns of each
    row of A @ B from the col ids alone (EMPTY slots ignored)."""
    nb = 5
    ac = rng.integers(0, nb, (4, 3)).astype(np.int32)
    ac[1, 2] = EMPTY
    bc = np.sort(rng.integers(0, nb, (nb, 2)), axis=1).astype(np.int32)
    bc[3, 1] = EMPTY
    fill = np.asarray(bell.structural_fill(jnp.asarray(ac),
                                           jnp.asarray(bc)))
    for r in range(4):
        ids = bc[ac[r][ac[r] != EMPTY]].reshape(-1)
        assert int(fill[r]) == len(np.unique(ids[ids != EMPTY]))


# ----------------------------------------------------------------------------
# dispatch
# ----------------------------------------------------------------------------

def fake_pair(nb, k, bs=128, cols=1, rows=1, dtype=np.float32,
              platform="gpu"):
    """PSMatrix stand-ins carrying what _pick_method reads, on a grid
    whose devices report ``platform``."""
    dev = SimpleNamespace(platform=platform)
    grid = SimpleNamespace(rows=rows, cols=cols, slices=1,
                           mesh=SimpleNamespace(devices=np.array([dev])))
    m = SimpleNamespace(nb=nb, k=k, bs=bs, panel_nb=nb // cols,
                        dtype=np.dtype(dtype), grid=grid)
    return m, m


@pytest.mark.parametrize("nb,k", [(64, 8), (800, 8), (800, 15),
                                  (8192, 5), (64, 48), (64, 64),
                                  (256, 250)])
def test_pick_method_gpu(nb, k):
    """float32 on the GPU: the kernel for sparse operands, dense past the
    occupancy gate, never a removed or unknown method."""
    from ntpoly_tpu.parallel import algebra as alg
    a, b = fake_pair(nb, k)
    got = alg._pick_method(a, b)
    if k >= alg.DENSE_OCCUPANCY_KERNEL * nb:
        assert got == "dense"
    else:
        assert got == "triton"


@pytest.mark.parametrize("platform,dtype", [("cpu", np.float32),
                                            ("gpu", np.complex64),
                                            ("gpu", np.float64)])
def test_pick_method_xla_tiers(platform, dtype):
    """Off the GPU, or for dtypes the kernel does not take, sparse
    operands go to cand; a candidate tensor past its bound goes to acc
    only when acc's accumulator is smaller and within ACC_MAX_BYTES, so a
    wide panel never goes to acc."""
    from ntpoly_tpu.parallel import algebra as alg
    a, _ = fake_pair(nb=800, k=15, dtype=dtype, platform=platform)
    assert alg._pick_method(a, a) == "cand"
    narrow, _ = fake_pair(nb=240, k=130, dtype=dtype, platform=platform)
    assert alg._pick_method(narrow, narrow) == "acc"
    wide, _ = fake_pair(nb=8192, k=130, dtype=dtype, platform=platform)
    assert alg._pick_method(wide, wide) == "cand"
    dense, _ = fake_pair(nb=240, k=140, dtype=dtype, platform=platform)
    assert alg._pick_method(dense, dense) == "dense"


@pytest.mark.parametrize("dtype,bs,ok", [(np.float32, 128, True),
                                         (np.float32, 16, True),
                                         (np.float32, 8, False),
                                         (np.float32, 96, False),
                                         (np.float64, 128, False),
                                         (np.complex64, 128, False)])
def test_triton_eligible(dtype, bs, ok):
    assert spgemm_triton.eligible(dtype, bs) is ok


def test_triton_plan_runs(rng):
    """The structure pass: each output slot's run of sorted candidates
    holds exactly the (A slot, B slot) pairs whose product lands there."""
    nb, ka, kb, k_out = 9, 4, 3, 6
    ac = np.sort(rng.integers(0, nb, (5, ka)), axis=1).astype(np.int32)
    ac[2, 3] = EMPTY
    bc = np.sort(rng.integers(0, nb, (nb, kb)), axis=1).astype(np.int32)
    bc[4, 2] = EMPTY
    occ, order, start, cnt = [np.asarray(x) for x in spgemm_triton.plan(
        jnp.asarray(ac), jnp.asarray(bc), k_out)]
    for r in range(5):
        ids = np.where(ac[r][:, None] != EMPTY,
                       bc[np.where(ac[r] != EMPTY, ac[r], 0)], EMPTY)
        ids = ids.reshape(-1)
        uniq = np.unique(ids[ids != EMPTY])[:k_out]
        assert np.array_equal(occ[r][:len(uniq)], uniq)
        assert (occ[r][len(uniq):] == EMPTY).all()
        for j, c in enumerate(uniq):
            run = order[r, start[r, j]:start[r, j] + cnt[r, j]]
            assert sorted(run) == sorted(np.nonzero(ids == c)[0])


@pytest.mark.parametrize("platform,native", [("cpu", True), ("gpu", True),
                                             ("other", False)])
def test_backend_supports_complex(platform, native):
    from ntpoly_tpu import config
    grid = SimpleNamespace(mesh=SimpleNamespace(
        devices=np.array([SimpleNamespace(platform=platform)])))
    assert config.backend_supports_complex(grid) is native
    assert config.should_embed_complex(grid) is (not native)


# ----------------------------------------------------------------------------
# precision knob
# ----------------------------------------------------------------------------

def test_precision_bf16_raises():
    from ntpoly_tpu.parallel import algebra as alg, pmatrix as PM
    from ntpoly_tpu.parallel.grid import ProcessGrid
    m = PM.from_dense(np.eye(16), bs=4, grid=ProcessGrid(1, 1, 1))
    with pytest.raises(ValueError, match="bf16"):
        alg.matmul(m, m, precision="bf16")
    for ok in alg.PRECISIONS:
        alg.matmul(m, m, precision=ok)


def test_precision_bf16_raises_in_solver():
    from ntpoly_tpu.parallel import pmatrix as PM
    from ntpoly_tpu.parallel.grid import ProcessGrid
    from ntpoly_tpu.solvers import density
    from ntpoly_tpu.solvers.parameters import SolverParameters
    grid = ProcessGrid(1, 1, 1)
    h = PM.from_dense(np.diag(np.linspace(-1, 1, 16)), bs=4, grid=grid)
    isq = PM.identity(16, bs=4, grid=grid, dtype=h.dtype)
    with pytest.raises(ValueError, match="bf16"):
        density.trs4(h, isq, 8.0, SolverParameters(precision="bf16"))


# ----------------------------------------------------------------------------
# compile cache and chip smoke
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache(monkeypatch, tmp_path, env_set):
    import jax
    from ntpoly_tpu.utils import compile_cache
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    default = str(tmp_path / ".jax_cache")
    if env_set:
        monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "env"))
        assert compile_cache.enable_compile_cache(default) == \
            str(tmp_path / "env")
        assert calls == []                 # JAX reads the variable itself
    else:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
        assert compile_cache.enable_compile_cache(default) == default
        assert calls == [("jax_compilation_cache_dir", default)]


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "needs a GPU" in res.stderr


@pytest.mark.gpu
def test_tiers_on_gpu(gpu_grid):
    """The tiers as compiled for the card (chip_smoke.py phase A at a
    smaller width)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    times = chip_smoke.phase_a(gpu_grid, nb=16, k=4)
    assert {tier for _, tier in times} == set(METHODS)
