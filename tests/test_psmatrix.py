"""Distributed matrix construction / IO / manipulation tests.

Mirrors reference UnitTests/test_psmatrix.py (593 LoC): MM and binary
round-trips, fills, transpose, conjugate, resize, slice/block extraction,
maps, snap-to-pattern — swept over grid shapes including 2.5D slices.
"""
import os

import numpy as np
import pytest
from scipy.io import mmread, mmwrite
from scipy.sparse import csr_matrix

import ntpoly_tpu as nt
from conftest import THRESHOLD, rel_error

GRID_SHAPES = [(1, 1, 1), (2, 2, 1), (1, 2, 2), (2, 2, 2), (4, 1, 1),
               (1, 1, 3)]


@pytest.fixture(params=GRID_SHAPES, ids=lambda g: "x".join(map(str, g)))
def grid(request):
    nt.ConstructGlobalProcessGrid(*request.param)
    yield request.param
    nt.DestructGlobalProcessGrid()


def random_matrix(rng, dim=13, density=0.5, is_complex=False):
    m = rng.random((dim, dim)) * (rng.random((dim, dim)) < density)
    if is_complex:
        m = m + 1j * rng.random((dim, dim)) * (m != 0)
    return m


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_read_write_mm(tmp_path, rng, grid, is_complex):
    m = random_matrix(rng, is_complex=is_complex)
    path = tmp_path / "in.mtx"
    mmwrite(str(path), csr_matrix(m))
    a = nt.Matrix_ps(str(path))
    out = tmp_path / "out.mtx"
    a.WriteToMatrixMarket(str(out))
    assert rel_error(mmread(str(out)).todense(), m) < 1e-14


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_binary_roundtrip(tmp_path, rng, grid, is_complex):
    m = random_matrix(rng, is_complex=is_complex)
    mmwrite(str(tmp_path / "in.mtx"), csr_matrix(m))
    a = nt.Matrix_ps(str(tmp_path / "in.mtx"))
    a.WriteToBinary(str(tmp_path / "ckpt.ntx"))
    b = nt.Matrix_ps(str(tmp_path / "ckpt.ntx"), True)
    out = tmp_path / "out.mtx"
    b.WriteToMatrixMarket(str(out))
    assert rel_error(mmread(str(out)).todense(), m) < 1e-14


def test_read_symmetric(tmp_path, rng, grid):
    m = random_matrix(rng)
    m = m + m.T
    path = tmp_path / "sym.mtx"
    mmwrite(str(path), csr_matrix(m), symmetry="symmetric")
    a = nt.Matrix_ps(str(path))
    out = tmp_path / "out.mtx"
    a.WriteToMatrixMarket(str(out))
    assert rel_error(mmread(str(out)).todense(), m) < 1e-14


def test_fill_from_triplets(rng, grid):
    dim = 11
    m = random_matrix(rng, dim)
    tl = nt.TripletList_r(0)
    for i, j in zip(*np.nonzero(m)):
        t = nt.Triplet_r(int(i) + 1, int(j) + 1, m[i, j])
        tl.Append(t)
    a = nt.Matrix_ps(dim)
    a.FillFromTripletList(tl)
    tl2 = nt.TripletList_r(0)
    a.GetTripletList(tl2)
    assert tl2.GetSize() == np.count_nonzero(m)
    got = np.zeros((dim, dim))
    for k in range(tl2.GetSize()):
        t = tl2.GetTripletAt(k)
        got[t.index_row - 1, t.index_column - 1] = t.point_value
    assert rel_error(got, m) < 1e-14


def test_fill_identity(grid):
    a = nt.Matrix_ps(9)
    a.FillIdentity()
    assert a.IsIdentity()
    assert abs(a.Trace() - 9) < 1e-14


def test_fill_dense(grid):
    a = nt.Matrix_ps(7)
    a.FillDense()
    assert a.GetSize() == 49
    assert abs(a.Norm() - 7.0) < 1e-14


def test_transpose_conjugate(tmp_path, rng, grid):
    m = random_matrix(rng, is_complex=True)
    mmwrite(str(tmp_path / "in.mtx"), csr_matrix(m))
    a = nt.Matrix_ps(str(tmp_path / "in.mtx"))
    b = nt.Matrix_ps(a.GetActualDimension())
    b.Transpose(a)
    b.Conjugate()
    b.WriteToMatrixMarket(str(tmp_path / "out.mtx"))
    assert rel_error(mmread(str(tmp_path / "out.mtx")).todense(),
                     m.conj().T) < 1e-14


def test_resize(rng, grid):
    dim = 13
    m = random_matrix(rng, dim)
    tl = nt.TripletList_r(0)
    for i, j in zip(*np.nonzero(m)):
        tl.Append(nt.Triplet_r(int(i) + 1, int(j) + 1, m[i, j]))
    a = nt.Matrix_ps(dim)
    a.FillFromTripletList(tl)
    for new_dim in (7, 21):
        a2 = nt.Matrix_ps(a)
        a2.Resize(new_dim)
        assert a2.GetActualDimension() == new_dim
        tl2 = nt.TripletList_r(0)
        a2.GetTripletList(tl2)
        ref = np.zeros((new_dim, new_dim))
        upto = min(dim, new_dim)
        ref[:upto, :upto] = m[:upto, :upto]
        got = np.zeros((new_dim, new_dim))
        for k in range(tl2.GetSize()):
            t = tl2.GetTripletAt(k)
            got[t.index_row - 1, t.index_column - 1] = t.point_value
        assert rel_error(got, ref) < 1e-14


def test_get_matrix_slice(rng, grid):
    dim = 13
    m = random_matrix(rng, dim)
    tl = nt.TripletList_r(0)
    for i, j in zip(*np.nonzero(m)):
        tl.Append(nt.Triplet_r(int(i) + 1, int(j) + 1, m[i, j]))
    a = nt.Matrix_ps(dim)
    a.FillFromTripletList(tl)
    start_row, end_row, start_col, end_col = 2, 8, 1, 5
    sub = nt.Matrix_ps(dim)
    a.GetMatrixSlice(sub, start_row, end_row, start_col, end_col)
    new_dim = max(end_row - start_row + 1, end_col - start_col + 1)
    ref = np.zeros((new_dim, new_dim))
    ref[:end_row - start_row + 1, :end_col - start_col + 1] = \
        m[start_row:end_row + 1, start_col:end_col + 1]
    tl2 = nt.TripletList_r(0)
    sub.GetTripletList(tl2)
    got = np.zeros((new_dim, new_dim))
    for k in range(tl2.GetSize()):
        t = tl2.GetTripletAt(k)
        got[t.index_row - 1, t.index_column - 1] = t.point_value
    assert rel_error(got, ref) < 1e-14


def test_get_matrix_block(rng, grid):
    dim = 12
    m = random_matrix(rng, dim)
    tl = nt.TripletList_r(0)
    for i, j in zip(*np.nonzero(m)):
        tl.Append(nt.Triplet_r(int(i) + 1, int(j) + 1, m[i, j]))
    a = nt.Matrix_ps(dim)
    a.FillFromTripletList(tl)
    blk = nt.TripletList_r(0)
    a.GetMatrixBlock(blk, 3, 9, 2, 7)
    got = np.zeros((dim, dim))
    for k in range(blk.GetSize()):
        t = blk.GetTripletAt(k)
        got[t.index_row - 1, t.index_column - 1] = t.point_value
    ref = np.zeros((dim, dim))
    ref[3:9, 2:7] = m[3:9, 2:7]
    assert rel_error(got, ref) < 1e-14


def test_map(tmp_path, rng, grid):
    m = random_matrix(rng)
    mmwrite(str(tmp_path / "in.mtx"), csr_matrix(m))
    a = nt.Matrix_ps(str(tmp_path / "in.mtx"))

    class MatOp(nt.RealOperation):
        def __call__(self):
            return self.data.point_value < 0.5

    b = nt.Matrix_ps(a.GetActualDimension())
    nt.MatrixMapper.Map(a, b, MatOp())
    b.WriteToMatrixMarket(str(tmp_path / "out.mtx"))
    ref = np.where(m < 0.5, m, 0)
    assert rel_error(mmread(str(tmp_path / "out.mtx")).todense(), ref) \
        < 1e-14


def test_snap_to_sparsity_pattern(tmp_path, rng, grid):
    m = random_matrix(rng, density=0.8)
    pattern = random_matrix(rng, density=0.3)
    mmwrite(str(tmp_path / "m.mtx"), csr_matrix(m))
    mmwrite(str(tmp_path / "p.mtx"), csr_matrix(pattern))
    a = nt.Matrix_ps(str(tmp_path / "m.mtx"))
    p = nt.Matrix_ps(str(tmp_path / "p.mtx"))
    nt.MatrixConversion.SnapMatrixToSparsityPattern(a, p)
    a.WriteToMatrixMarket(str(tmp_path / "out.mtx"))
    ref = np.where(pattern != 0, m, 0)
    assert rel_error(np.asarray(mmread(str(tmp_path / "out.mtx")).todense()),
                     ref) < 1e-14


def _double_lower(r, c, v):
    return 2.0 * v, r >= c


def test_map_values_device_side(rng, grid):
    """Device-side elementwise map (no host round-trip): values change,
    pattern stays."""
    from ntpoly_tpu.parallel import pmatrix as PM
    from ntpoly_tpu.utils import maps
    m = random_matrix(rng, dim=17, density=0.5)
    a = PM.from_dense(m, bs=4)
    out = maps.map_values(a, _double_lower)
    ref = np.where(np.tril(np.ones_like(m)) > 0, 2.0 * m, 0)
    assert rel_error(np.asarray(PM.to_dense(out)), ref) < 1e-14


def test_local_matrix_sparse_construction(rng):
    """LocalMatrix.from_triplets must not densify and must match the
    dense construction (reference ConstructMatrixFromTripletList)."""
    from ntpoly_tpu.core.lmatrix import LocalMatrix
    m = random_matrix(rng, dim=19, density=0.2)
    i, j = np.nonzero(m)
    lm = LocalMatrix.from_triplets(i, j, m[i, j], 19, 19, bs=4)
    assert rel_error(lm.to_dense(), m) < 1e-14
    # duplicate coordinates are summed
    lm2 = LocalMatrix.from_triplets(
        np.concatenate([i, i]), np.concatenate([j, j]),
        np.concatenate([m[i, j], m[i, j]]), 19, 19, bs=4)
    assert rel_error(lm2.to_dense(), 2 * m) < 1e-14


def test_permutation_fill(rng, grid):
    dim = 10
    a = nt.Matrix_ps(dim)
    perm = nt.Permutation(a.GetLogicalDimension())
    perm.SetReversePermutation()
    a.FillDistributedPermutation(perm, True)
    assert a.GetSize() == a.GetLogicalDimension()


def test_measure_asymmetry_and_symmetrize(tmp_path, rng, grid):
    m = random_matrix(rng)
    mmwrite(str(tmp_path / "in.mtx"), csr_matrix(m))
    a = nt.Matrix_ps(str(tmp_path / "in.mtx"))
    asym = a.MeasureAsymmetry()
    ref = np.abs(m - m.T).sum(axis=0).max()
    assert abs(asym - ref) < 1e-12
    a.Symmetrize()
    a.WriteToMatrixMarket(str(tmp_path / "out.mtx"))
    assert rel_error(mmread(str(tmp_path / "out.mtx")).todense(),
                     0.5 * (m + m.T)) < 1e-14


def test_fill_host_allocation_is_shard_local(rng):
    """construction must be O(nnz/P) + O(shard) per
    host — the largest host-side allocation is one shard, never the
    global logical array."""
    from ntpoly_tpu.parallel import pmatrix as PM
    from ntpoly_tpu.parallel.grid import ProcessGrid
    grid = ProcessGrid(2, 2, 2)
    dim, bs = 256, 8
    i = np.arange(dim)
    m = PM.empty(dim, bs=bs, grid=grid, k=2)
    global_bytes = m.panels * m.nb * m.k * bs * bs * m.blocks.dtype.itemsize
    assert PM._build_stats["max_shard_bytes"] <= global_bytes // 4 + 1
    m = PM.fill_from_triplets(m, i, i, np.ones(dim, m.dtype))
    assert PM._build_stats["max_shard_bytes"] <= global_bytes // 4 + 1
    assert float(np.asarray(PM.to_dense(m)).trace()) == dim


def test_native_fill_matches_numpy(rng):
    """r4: the threaded C++ fill (native/blockfill.cpp) must be
    bit-identical to the numpy path it accelerates (the reference's
    sort + CSR build, triplet_includes/SortTripletList.f90)."""
    from ntpoly_tpu import native
    from ntpoly_tpu.parallel import pmatrix as PM
    from ntpoly_tpu.parallel.grid import ProcessGrid
    if not native.available():
        pytest.skip("native library unavailable")
    dim, bs, n = 1024, 16, 70_000       # above the native-path cutoff
    i = rng.integers(0, dim, n)
    j = rng.integers(0, dim, n)
    v = rng.random(n)
    grid = ProcessGrid(2, 2, 1)
    base = PM.empty(dim, bs=bs, grid=grid, dtype=np.float64)
    m_nat = PM.fill_from_triplets(base, i, j, v)
    orig = native.available
    native.available = lambda: False
    try:
        m_np = PM.fill_from_triplets(base, i, j, v)
    finally:
        native.available = orig
    assert m_nat.k == m_np.k
    assert np.abs(np.asarray(PM.to_dense(m_nat))
                  - np.asarray(PM.to_dense(m_np))).max() == 0


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2), (1, 2, 4)])
def test_fill_banded_device_side(shape):
    """r4: device-side banded generation (no host triplets, no upload)
    matches the dense reference, swept over grids."""
    import jax.numpy as jnp
    from ntpoly_tpu.parallel import pmatrix as PM
    from ntpoly_tpu.parallel.grid import ProcessGrid

    def fn(i, j):
        return jnp.where(i == j, 2.0, 0.3) * jnp.cos(0.01 * (i + j))

    for dim, bs, hb in [(100, 8, 5), (64, 16, 0), (50, 4, 3)]:
        m = PM.banded(dim, hb, fn, bs=bs, grid=ProcessGrid(*shape))
        d = np.asarray(PM.to_dense(m))
        i, j = np.meshgrid(np.arange(dim), np.arange(dim), indexing="ij")
        ref = (np.where(i == j, 2.0, 0.3) * np.cos(0.01 * (i + j))
               * (np.abs(i - j) <= hb))
        assert np.abs(d - ref).max() < 1e-14
        # the generated capacity is the analytic band capacity
        assert m.k <= min(2 * ((hb - 1) // bs + 1 if hb else 0) + 1,
                          m.panel_nb)


def test_native_fill_nb_bound():
    """blockfill.cpp's packed sort key overflows int64 at nb >= 2^21 —
    fill_blocks must refuse (callers fall back to numpy)."""
    from ntpoly_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    z = np.zeros(1, np.int64)
    with pytest.raises(ValueError, match="2\\^21"):
        native.fill_blocks(z, z, np.zeros(1, np.float32),
                           bs=128, nb=1 << 21, pnb=1 << 21)
