"""PSMatrix — the distributed block-sparse matrix.

JAX counterpart of NTPoly's ``Matrix_ps``
(reference Source/Fortran/PSMatrixModule.F90:33-51,188-252): a square matrix
tiled into bs x bs blocks, stored as block-ELL *column panels*:

    col_ids : int32[Pc, NB, K]         global block-col ids (EMPTY = unused)
    blocks  : dtype[Pc, NB, K, bs, bs]

Panel p owns global block-cols [p*panel_nb, (p+1)*panel_nb).  The leading
panel axis is sharded over the mesh 'cols' axis, the block-row axis over
'rows', and the whole thing is replicated over 'slices' (exactly the
reference's data distribution, where each slice holds a full copy and slices
split the k-dimension of multiplies).  The logical dimension is padded up so
blocks and panels divide evenly (reference CalculateScaledDimension,
PSMatrixModule.F90:1596-1618); padded rows/cols are kept identically zero.

The container is a pytree; all ops are functional (return new PSMatrix).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field, replace

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EMPTY, default_real_dtype
from ..core import bell
from .grid import ProcessGrid, global_grid


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PSMatrix:
    col_ids: jax.Array                    # i32[Pc, NB, K]
    blocks: jax.Array                     # dtype[Pc, NB, K, bs, bs]
    dim: int = field(metadata=dict(static=True), default=0)
    bs: int = field(metadata=dict(static=True), default=0)
    grid: ProcessGrid = field(metadata=dict(static=True), default=None)

    # -- geometry --------------------------------------------------------
    @property
    def nb(self) -> int:                  # logical block rows (= block cols)
        return self.col_ids.shape[1]

    @property
    def k(self) -> int:
        return self.col_ids.shape[2]

    @property
    def panels(self) -> int:
        return self.col_ids.shape[0]

    @property
    def panel_nb(self) -> int:
        return self.nb // self.panels

    @property
    def logical_dim(self) -> int:
        return self.nb * self.bs

    @property
    def dtype(self):
        return self.blocks.dtype

    def panel_offsets(self) -> np.ndarray:
        return np.arange(self.panels) * self.panel_nb

    # -- convenience -----------------------------------------------------
    def with_data(self, col_ids, blocks) -> "PSMatrix":
        return replace(self, col_ids=col_ids, blocks=blocks)

    def astype(self, dtype) -> "PSMatrix":
        return self.with_data(self.col_ids, self.blocks.astype(dtype))

    def conjugate(self) -> "PSMatrix":
        return self.with_data(self.col_ids, jnp.conj(self.blocks))

    @property
    def nnz(self) -> int:
        return int(jnp.sum(self.blocks != 0))


# ----------------------------------------------------------------------------
# geometry / construction
# ----------------------------------------------------------------------------

def geometry(dim: int, bs: int, grid: ProcessGrid):
    """Logical block count and panel size for a dim x dim matrix."""
    nb = _round_up(max(1, -(-dim // bs)), math.lcm(grid.rows, grid.cols))
    return nb, nb // grid.cols


def _shard(grid: ProcessGrid, col_ids, blocks):
    from . import dist
    sh = grid.matrix_sharding
    return (dist.shard_global(np.asarray(col_ids), sh),
            dist.shard_global(np.asarray(blocks), sh))


def _slice_bounds(sl: slice, extent: int) -> tuple[int, int]:
    return (sl.start or 0, extent if sl.stop is None else sl.stop)


# observability for tests: the largest single host allocation of the most
# recent _build_sharded call (must be O(shard), never O(global))
_build_stats = {"max_shard_bytes": 0}


def _build_sharded(grid: ProcessGrid, nb: int, k: int, bs: int, dtype,
                   sp, sr, slot, sc, sb):
    """Materialize the block-ELL arrays shard-by-shard from sorted
    unique-block data (sp=panel, sr=block-row, slot, sc=col id, sb=block).

    No host ever allocates the full logical array: each addressable shard
    is built independently (O(shard bytes + local nnz) host memory) — the
    O(nnz/P) construction the reference gets from alltoallv fill
    (reference distributed_includes/FillMatrixFromTripletList.f90:25-46).
    """
    sh = grid.matrix_sharding
    cache: dict = {}
    _build_stats["max_shard_bytes"] = 0

    def make(idx, kind):
        p0, p1 = _slice_bounds(idx[0], grid.cols)
        r0, r1 = _slice_bounds(idx[1], nb)
        key = (p0, p1, r0, r1, kind)
        if key not in cache:
            m = (sp >= p0) & (sp < p1) & (sr >= r0) & (sr < r1)
            lp, lr, ls = sp[m] - p0, sr[m] - r0, slot[m]
            if kind == "c":
                arr = np.full((p1 - p0, r1 - r0, k), EMPTY, np.int32)
                arr[lp, lr, ls] = sc[m]
            else:
                arr = np.zeros((p1 - p0, r1 - r0, k, bs, bs), dtype)
                arr[lp, lr, ls] = sb[m]
            cache[key] = arr
            _build_stats["max_shard_bytes"] = max(
                _build_stats["max_shard_bytes"], arr.nbytes)
        return cache[key]

    cids = jax.make_array_from_callback(
        (grid.cols, nb, k), sh, lambda idx: make(idx, "c"))
    blks = jax.make_array_from_callback(
        (grid.cols, nb, k, bs, bs), sh, lambda idx: make(idx, "b"))
    return cids, blks


def empty(dim: int, *, bs: int, k: int | None = None, dtype=None,
          grid: ProcessGrid | None = None) -> PSMatrix:
    grid = grid or global_grid()
    dtype = dtype or default_real_dtype()
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        from .. import config
        if not config.backend_supports_complex(grid):
            from ..utils.errors import ComplexSupportError
            raise ComplexSupportError(
                f"backend '{grid.mesh.devices.flat[0].platform}' has no "
                "native complex arithmetic; use ntpoly_tpu.Matrix_ps "
                "(automatic 2x2 real embedding) or core/cplx.py directly "
                "(reference holds complex natively, "
                "PSMatrixModule.F90:1673-1703)")
    nb, pnb = geometry(dim, bs, grid)
    # default capacity 1, NOT pnb: fills grow k to exactly what the data
    # needs, while a full-capacity default allocates nb*pnb blocks — 42 GB
    # for an (unfilled!) 100k-dim identity at bs=128
    k = min(k or 1, pnb)
    z = np.zeros(0, np.int64)
    col_ids, blocks = _build_sharded(
        grid, nb, k, bs, dtype, z, z, z, z,
        np.zeros((0, bs, bs), dtype))
    return PSMatrix(col_ids, blocks, dim, bs, grid)


def _eye_fn(i, j):
    """Module-level so its identity is stable: ``fill_banded`` keys the
    jit cache on the value function object — a fresh closure per call
    would re-trace and recompile every identity (one compile per solver
    invocation)."""
    return jnp.where(i == j, 1.0, 0.0)


def identity(dim: int, *, bs: int, k: int | None = None, dtype=None,
             grid: ProcessGrid | None = None, scale: float = 1.0) -> PSMatrix:
    """FillMatrixIdentity (reference PSMatrixModule.F90:864-979): ones on the
    actual (unpadded) diagonal.  Generated device-side (a band of width 0)
    — no host triplets, no upload (0.5 GB saved per identity at 2^20
    rows)."""
    m = empty(dim, bs=bs, dtype=dtype, grid=grid)
    out = fill_banded(m, 0, _eye_fn)
    if np.asarray(scale).item() != 1.0:
        out = out.with_data(out.col_ids,
                            out.blocks * jnp.asarray(scale, out.dtype))
    if k and k > out.k:                   # honor a requested capacity
        pads = min(k, out.panel_nb) - out.k
        cc = jnp.pad(out.col_ids, ((0, 0), (0, 0), (0, pads)),
                     constant_values=EMPTY)
        cb = jnp.pad(out.blocks,
                     ((0, 0), (0, 0), (0, pads), (0, 0), (0, 0)))
        sh = out.grid.matrix_sharding
        out = out.with_data(jax.lax.with_sharding_constraint(cc, sh),
                            jax.lax.with_sharding_constraint(cb, sh))
    if np.asarray(scale).item() == 1.0:
        # construction-time identity tag: solvers check identity-ness of
        # the overlap ISQ to short-circuit similarity transforms; the tag
        # makes that check free (the device check costs one fused pass +
        # one blocking readback).  Conservative: any with_data /
        # replace produces an untagged object.
        object.__setattr__(out, "_known_identity", True)
    return out


def fill_from_triplets(m: PSMatrix, rows, cols, vals,
                       mode: str = "replicated") -> PSMatrix:
    """Build the block-ELL panels from global (i, j, v) triplets.

    Replaces NTPoly's FillMatrixFromTripletList alltoallv redistribution
    (reference Source/Fortran/distributed_includes/
    FillMatrixFromTripletList.f90) with host-side construction sharded onto
    the mesh.  Duplicate coordinates are summed.

    Multi-process modes (single-process runs ignore ``mode``):
      'replicated'     — every process passes the SAME full triplet set
                         (each builds its own shards; no exchange).
      'distributed'    — processes pass disjoint subsets (e.g. from
                         byte-range file reads); exchanged host-side
                         first (reference alltoallv).
      'prepartitioned' — each process passes exactly the triplets its own
                         shards store; no exchange, O(nnz/P) per host
                         (reference prepartitioned flag,
                         FillMatrixFromTripletList.f90:14-24).
    """
    from . import dist
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    # Coordinates may address the padded (logical) region — the reference
    # stores permutation matrices there (PSMatrixModule.F90:864-979).
    if ((rows.size and rows.max(initial=0) >= m.logical_dim)
            or (cols.size and cols.max(initial=0) >= m.logical_dim)):
        raise ValueError("triplet coordinates beyond matrix dimension")
    bs, nb, pnb = m.bs, m.nb, m.panel_nb
    if mode == "distributed" and dist.is_multiprocess():
        # route each triplet to the process(es) owning its shard — the
        # alltoallv of the reference fill (O(nnz/P) per host, not the
        # O(nnz) allgather union); slice replicas each get a copy
        owners = _shard_owners(m)                 # [pc, rows, slices]
        pi = (cols // bs) // pnb
        ri = (rows // bs) // _rows_per(m)
        er, ec, ev, ed = [], [], [], []
        for s in range(owners.shape[-1]):
            dest = owners[pi, ri, s]
            keep = dest >= 0
            er.append(rows[keep])
            ec.append(cols[keep])
            ev.append(vals[keep])
            ed.append(dest[keep])
        rows, cols, vals = dist.exchange_triplets(
            np.concatenate(er), np.concatenate(ec), np.concatenate(ev),
            np.concatenate(ed))
    from .. import native
    np_dtype = np.dtype(m.dtype)
    if (native.available() and len(rows) >= 65536 and nb < (1 << 21)
            and np_dtype in (np.dtype(np.float32), np.dtype(np.float64))):
        # threaded C++ sort/dedup/scatter (native/blockfill.cpp) — the
        # numpy chain below is single-threaded
        sp, sr, slot, sc, sb, k_needed = native.fill_blocks(
            rows, cols, vals.astype(np_dtype), bs, nb, pnb)
    else:
        bi, bj = rows // bs, cols // bs
        bid = bi * nb + bj
        ub, inv = np.unique(bid, return_inverse=True)
        nub = len(ub)
        blocks = np.zeros((nub, bs, bs), m.dtype)
        np.add.at(blocks, (inv, rows % bs, cols % bs), vals.astype(m.dtype))
        ubi, ubj = ub // nb, ub % nb
        p = ubj // pnb
        order = np.lexsort((ubj, ubi, p))
        sp, sr, sc = p[order], ubi[order], ubj[order]
        sb = blocks[order]
        grp = sp * nb + sr
        first = np.ones(nub, bool)
        first[1:] = grp[1:] != grp[:-1]
        start = np.maximum.accumulate(np.where(first, np.arange(nub), 0))
        slot = np.arange(nub) - start
        k_needed = int(slot.max()) + 1 if nub else 1
    if mode in ("prepartitioned", "distributed") and dist.is_multiprocess():
        # capacity must agree across processes (it is a static shape)
        from jax.experimental import multihost_utils as mhu
        k_needed = int(np.max(mhu.process_allgather(
            np.asarray([k_needed], np.int64))))
    k = max(m.k, k_needed)
    col_ids, out_blocks = _build_sharded(
        m.grid, nb, k, bs, m.dtype, sp, sr, slot, sc, sb)
    return m.with_data(col_ids, out_blocks)


def _rows_per(m: PSMatrix) -> int:
    return m.nb // m.grid.rows


def _shard_owners(m: PSMatrix) -> np.ndarray:
    """owner[p, rblock, s] -> process id holding the slice-s replica of the
    (panel p, row-shard) tile; -1 marks a duplicate (same process already
    listed for a lower slice), so each owning process receives one copy."""
    devs = np.asarray(m.grid.mesh.devices)       # [rows, cols, slices]
    S = m.grid.slices
    owner = np.full((m.grid.cols, m.grid.rows, S), -1, np.int64)
    for p in range(m.grid.cols):
        for r in range(m.grid.rows):
            seen = set()
            for s in range(S):
                pid = devs[r, p, s].process_index
                if pid not in seen:
                    seen.add(pid)
                    owner[p, r, s] = pid
    return owner


@functools.partial(jax.jit, static_argnames=("dim", "bs", "nb", "pnb",
                                             "panels", "k", "bband", "hb",
                                             "fn", "dtype", "grid"))
def _banded_jit(*, dim, bs, nb, pnb, panels, k, bband, hb, fn, dtype, grid):
    p = jnp.arange(panels, dtype=jnp.int32)[:, None, None]
    r = jnp.arange(nb, dtype=jnp.int32)[None, :, None]
    s = jnp.arange(k, dtype=jnp.int32)[None, None, :]
    lo = jnp.maximum(r - bband, p * pnb)
    hi = jnp.minimum(r + bband, (p + 1) * pnb - 1)
    c = lo + s                                        # [Pc, NB, K]
    valid = c <= hi
    col_ids = jnp.where(valid, c, EMPTY)
    gi = (r[..., None, None] * bs
          + jnp.arange(bs, dtype=jnp.int32)[:, None])  # [Pc,NB,1,bs,1]
    gj = (c[..., None, None] * bs
          + jnp.arange(bs, dtype=jnp.int32)[None, :])  # [Pc,NB,K,1,bs]
    vals = jnp.asarray(fn(gi, gj), dtype)
    mask = ((jnp.abs(gi - gj) <= hb) & (gi < dim) & (gj < dim)
            & valid[..., None, None])
    blocks = jnp.where(mask, vals, 0)
    sh = grid.matrix_sharding
    return (jax.lax.with_sharding_constraint(col_ids, sh),
            jax.lax.with_sharding_constraint(blocks, sh))


def fill_banded(m: PSMatrix, halfwidth: int, fn,
                threshold: float = 0.0) -> PSMatrix:
    """Fill a banded matrix DEVICE-SIDE: entry (i, j) = fn(i, j) wherever
    |i - j| <= halfwidth (and |fn| > threshold), zero elsewhere.

    ``fn`` is a jax-traceable elementwise function of int32 index
    arrays; its OBJECT IDENTITY is part of the jit cache key, so pass a
    module-level function (not a fresh closure) from code that fills
    repeatedly.
    The block structure of a band is analytic, so both the col-id table
    and the block tensor are generated under jit straight into the
    sharded layout — no host triplet materialization and no
    host-to-device upload.  This is the construction path for >=10^6-row
    structured benchmark systems, where the triplet fill's host build and
    upload dominate (the role of the
    reference's FillMatrixFromTripletList + bench generator,
    distributed_includes/FillMatrixFromTripletList.f90:25-46,
    UnitTests/bench.f90:1-60)."""
    bs, nb, pnb = m.bs, m.nb, m.panel_nb
    bband = 0 if halfwidth < 1 else (halfwidth - 1) // bs + 1
    k = min(2 * bband + 1, pnb)
    if threshold > 0.0:
        inner = fn

        def fn(i, j, _inner=inner):
            v = _inner(i, j)
            return jnp.where(jnp.abs(v) > threshold, v, 0)
    col_ids, blocks = _banded_jit(
        dim=m.dim, bs=bs, nb=nb, pnb=pnb, panels=m.panels, k=k,
        bband=bband, hb=halfwidth, fn=fn, dtype=m.dtype, grid=m.grid)
    return m.with_data(col_ids, blocks)


def banded(dim: int, halfwidth: int, fn, *, bs: int, grid=None,
           dtype=None, threshold: float = 0.0) -> PSMatrix:
    """Convenience wrapper: empty + :func:`fill_banded`."""
    m = empty(dim, bs=bs, dtype=dtype, grid=grid)
    return fill_banded(m, halfwidth, fn, threshold=threshold)


def from_dense(dense: np.ndarray, *, bs: int, k: int | None = None,
               grid: ProcessGrid | None = None, dtype=None,
               threshold: float = 0.0) -> PSMatrix:
    """Host-side dense -> PSMatrix (test/IO utility)."""
    dense = np.asarray(dense)
    dim = dense.shape[0]
    i, j = np.nonzero(np.abs(dense) > threshold)
    m = empty(dim, bs=bs, k=k, dtype=dtype or dense.dtype, grid=grid)
    return fill_from_triplets(m, i, j, dense[i, j])


@functools.partial(jax.jit, static_argnames=("bs", "nb", "pnb", "panels",
                                             "wb", "grid"))
def _tall_dense_jit(x, jb0, *, bs, nb, pnb, panels, wb, grid):
    """Dense column block [nb*bs, wb*bs] -> block-ELL arrays with the
    columns placed at block-col offset ``jb0`` (traced ok)."""
    blocks = jnp.moveaxis(
        x.reshape(nb, bs, wb, bs), 2, 1)              # [nb, wb, bs, bs]
    cols = jb0 + jnp.arange(wb, dtype=jnp.int32)      # [wb]
    nz = jnp.sum(jnp.abs(blocks), axis=(-1, -2)) > 0  # [nb, wb]
    pidx = jnp.arange(panels, dtype=jnp.int32)[:, None, None]
    mine = (cols[None, None, :] // pnb) == pidx       # [Pc, 1, wb]
    keep = mine & nz[None]
    col_ids = jnp.where(keep, cols[None, None, :], EMPTY)
    out_blocks = jnp.where(keep[..., None, None], blocks[None], 0)
    sh = grid.matrix_sharding
    return (jax.lax.with_sharding_constraint(col_ids, sh),
            jax.lax.with_sharding_constraint(out_blocks, sh))


def from_tall_dense(x, dim: int, jb0, *, bs: int,
                    grid: ProcessGrid | None = None) -> PSMatrix:
    """A dim x dim PSMatrix whose block-columns [jb0, jb0 + wb) hold the
    dense column block ``x`` [logical_dim, wb*bs] (everything else zero).
    Device-side (no host triplets) — the panel container of the blocked
    Cholesky (reference factors column panels the same way,
    LinearSolversModule.F90:185-321); ``jb0`` may be a traced scalar."""
    grid = grid or global_grid()
    nb, pnb = geometry(dim, bs, grid)
    wb = x.shape[-1] // bs
    assert x.shape[-2] == nb * bs and x.shape[-1] % bs == 0, x.shape
    col_ids, blocks = _tall_dense_jit(
        x, jnp.asarray(jb0, jnp.int32), bs=bs, nb=nb, pnb=pnb,
        panels=grid.cols, wb=wb, grid=grid)
    return PSMatrix(col_ids, blocks, dim, bs, grid)


def to_dense(m: PSMatrix, actual: bool = True) -> jax.Array:
    """PSMatrix -> dense (gathered; test/IO utility)."""
    parts = [bell.to_dense(m.col_ids[p], m.blocks[p], nbc=m.panel_nb,
                           col_offset=p * m.panel_nb)
             for p in range(m.panels)]
    d = jnp.concatenate(parts, axis=-1)
    return d[:m.dim, :m.dim] if actual else d


def to_triplets(m: PSMatrix, local: bool = False):
    """PSMatrix -> (rows, cols, vals) numpy triplets of stored nonzeros.

    Multi-process: gathers each host's OWNED (slice-0 replica) shards,
    then the union over hosts — ownership filtering prevents slice
    replicas held by different processes from double-counting.
    ``local=True`` skips the union, returning only this host's owned
    triplets (each stored entry appears on exactly one host — the basis
    of the collective checkpoint write)."""
    from . import dist
    if dist.is_multiprocess():
        r, c, v = _local_shard_triplets(m)
        if local:
            return r, c, v
        return dist.allgather_triplets(r, c, v)
    cid = np.asarray(m.col_ids)
    blk = np.asarray(m.blocks)
    P, NB, K, bs, _ = blk.shape
    pp, rr, kk, ii, jj = np.nonzero(blk != 0)
    bj = cid[pp, rr, kk]
    rows = rr * bs + ii
    cols = bj * bs + jj
    vals = blk[pp, rr, kk, ii, jj]
    keep = (rows < m.dim) & (cols < m.dim)
    return rows[keep], cols[keep], vals[keep]


def _local_shard_triplets(m: PSMatrix):
    """Triplets stored in this process's OWNED shards: the slice-0
    replica, so that across processes every stored entry appears exactly
    once ('slices' replication can place copies of one logical shard on
    different processes)."""
    slice0 = {d.id for d in np.asarray(m.grid.mesh.devices)[:, :, 0].flat}
    seen = set()
    out_r, out_c, out_v = [], [], []
    for cid_sh, blk_sh in zip(m.col_ids.addressable_shards,
                              m.blocks.addressable_shards):
        if cid_sh.device.id not in slice0:
            continue
        key = (cid_sh.index[0].start, cid_sh.index[1].start)
        if key in seen:
            continue
        seen.add(key)
        cid = np.asarray(cid_sh.data)
        blk = np.asarray(blk_sh.data)
        r0 = (cid_sh.index[1].start or 0)
        bs = m.bs
        pp, rr, kk, ii, jj = np.nonzero(blk != 0)
        bj = cid[pp, rr, kk]
        rows = (rr + r0) * bs + ii
        cols = bj * bs + jj
        vals = blk[pp, rr, kk, ii, jj]
        keep = (rows < m.dim) & (cols < m.dim)
        out_r.append(rows[keep])
        out_c.append(cols[keep])
        out_v.append(vals[keep])
    return (np.concatenate(out_r) if out_r else np.zeros(0, np.int64),
            np.concatenate(out_c) if out_c else np.zeros(0, np.int64),
            np.concatenate(out_v) if out_v else np.zeros(0))


def _flat_block_coo(m: PSMatrix):
    """Device-side flatten to block-COO [Pc*NB*K] (rows, cols, blocks,
    valid)."""
    import jax.numpy as jnp
    pc, nbr, k = m.col_ids.shape
    rows = jnp.broadcast_to(
        jnp.arange(nbr, dtype=jnp.int32)[None, :, None], (pc, nbr, k))
    return (rows.reshape(-1), m.col_ids.reshape(-1),
            m.blocks.reshape(-1, m.bs, m.bs),
            (m.col_ids != EMPTY).reshape(-1))


@functools.partial(jax.jit, static_argnames=(
    "rlim", "clim", "bs", "nb2", "pnb2", "panels", "k2", "row_off",
    "col_off"))
def _reblock_jit(rows, cols, blocks, valid, *, rlim, clim, bs, nb2, pnb2,
                 panels, k2, row_off=0, col_off=0):
    """Crop/shift block-COO into a new (nb2, pnb2) geometry, masking
    elements beyond the row/col limits (block-aligned offsets)."""
    rows = rows - row_off
    cols = jnp.where(valid, cols - col_off, cols)
    keep = valid & (rows >= 0) & (cols >= 0) & (rows < nb2) & (cols < nb2)
    # element mask for blocks straddling the new boundary
    r_el = rows[:, None] * bs + jnp.arange(bs)[None, :]       # [N, bs]
    c_el = cols[:, None] * bs + jnp.arange(bs)[None, :]
    blocks = (blocks * (r_el < rlim)[:, :, None].astype(blocks.dtype)
              * (c_el < clim)[:, None, :].astype(blocks.dtype))
    cols = jnp.where(keep, cols, EMPTY)
    fill = jnp.max(jnp.zeros((panels, nb2), jnp.int32).at[
        jnp.where(keep, cols // pnb2, 0),
        jnp.where(keep, rows, 0)].add(keep.astype(jnp.int32), mode='drop'))
    oc, ob = bell.from_block_coo(rows, cols, blocks, keep, nbr=nb2, k=k2,
                                 panels=panels, panel_nbc=pnb2)
    return oc, ob, fill


@functools.partial(jax.jit, static_argnames=("ro", "co", "bs"))
def _shift_coo_jit(rows, cols, blocks, valid, *, ro: int, co: int,
                   bs: int):
    """Expand block-COO for an intra-block (element) offset: every input
    block contributes up to four candidate output blocks whose contents
    are STATIC sub-block shifts (ro/co are python ints), so the whole
    expansion is pad/slice — no per-element scatter.  Duplicate output
    (row, col) pairs are collapsed by the caller's merge."""
    out_r, out_c, out_b, out_v = [], [], [], []
    for dr in ((0, 1) if ro else (0,)):
        for dc in ((0, 1) if co else (0,)):
            b = blocks
            if ro:
                b = (jnp.pad(b[:, ro:, :], ((0, 0), (0, ro), (0, 0)))
                     if dr == 0 else
                     jnp.pad(b[:, :ro, :], ((0, 0), (bs - ro, 0), (0, 0))))
            if co:
                b = (jnp.pad(b[:, :, co:], ((0, 0), (0, 0), (0, co)))
                     if dc == 0 else
                     jnp.pad(b[:, :, :co], ((0, 0), (0, 0), (bs - co, 0))))
            out_r.append(rows - dr)
            out_c.append(jnp.where(valid, cols - dc, cols))
            out_b.append(b)
            out_v.append(valid)
    return (jnp.concatenate(out_r), jnp.concatenate(out_c),
            jnp.concatenate(out_b), jnp.concatenate(out_v))


def _rebuild_device(m: PSMatrix, new_dim: int, grid: ProcessGrid,
                    row_off: int = 0, col_off: int = 0,
                    rlim: int | None = None,
                    clim: int | None = None,
                    ro: int = 0, co: int = 0) -> PSMatrix:
    """Device-side regeometry: crop/shift/re-panel WITHOUT host triplet
    round-trips (the host path is O(global nnz) per host; this one is XLA
    gathers/sorts over the sharded arrays — reference does targeted sends,
    PSMatrixModule.F90:1036-1227).  ``ro``/``co`` carry an intra-block
    element offset for unaligned slices (block shifts handled by
    :func:`_shift_coo_jit`; duplicates merged after the rebuild)."""
    nb2, pnb2 = geometry(new_dim, m.bs, grid)
    rlim = new_dim if rlim is None else rlim
    clim = new_dim if clim is None else clim
    rows, cols, blocks, valid = _flat_block_coo(m)
    if ro or co:
        rows, cols, blocks, valid = _shift_coo_jit(
            rows, cols, blocks, valid, ro=ro, co=co, bs=m.bs)
    if grid != m.grid:
        sh = grid.sharding(("rows", "cols", "slices"))
        n = rows.shape[0]
        pad = -n % grid.n_devices
        if pad:
            rows = jnp.pad(rows, (0, pad))
            cols = jnp.pad(cols, (0, pad), constant_values=EMPTY)
            blocks = jnp.pad(blocks, ((0, pad), (0, 0), (0, 0)))
            valid = jnp.pad(valid, (0, pad))
        rows, cols, blocks, valid = (
            jax.device_put(rows, sh), jax.device_put(cols, sh),
            jax.device_put(blocks, sh), jax.device_put(valid, sh))
    # two passes: measure the exact per-(panel,row) fill, then build at
    # that capacity (from_block_coo drops overflow silently)
    _, _, fill = _reblock_jit(
        rows, cols, blocks, valid, rlim=rlim, clim=clim, bs=m.bs, nb2=nb2,
        pnb2=pnb2, panels=grid.cols, k2=1, row_off=row_off, col_off=col_off)
    # the unaligned expansion lands up to 4 duplicate entries per output
    # block, and `fill` counts them all — the BUILD capacity must hold
    # the duplicates (beyond panel_nb if need be); the merge collapses
    # them back under the panel_nb invariant
    cap2 = pnb2 * (4 if (ro or co) else 1)
    k2 = min(max(int(fill), 1), cap2)
    oc, ob, _ = _reblock_jit(
        rows, cols, blocks, valid, rlim=rlim, clim=clim, bs=m.bs, nb2=nb2,
        pnb2=pnb2, panels=grid.cols, k2=k2, row_off=row_off,
        col_off=col_off)
    if ro or co:
        # collapse duplicate (row, col) contributions (merge sums them)
        oc, ob = bell.merge(oc, ob, min(k2, pnb2), 0.0)
    sh = grid.matrix_sharding
    return PSMatrix(jax.lax.with_sharding_constraint(oc, sh),
                    jax.lax.with_sharding_constraint(ob, sh),
                    new_dim, m.bs, grid)


def resize(m: PSMatrix, new_dim: int) -> PSMatrix:
    """ResizeMatrix (reference PSMatrixModule.F90): crop or zero-pad.

    Device-side on the matrix's own mesh (O(shard) per device, XLA
    collectives route block crossings) in single- AND multi-process runs
    — no host ever materializes global triplets (the reference's
    in-place regrid, PSMatrixModule.F90:309-347)."""
    return _rebuild_device(m, new_dim, m.grid)


@functools.partial(jax.jit, static_argnames=("rows",))
def _shard_counts_jit(blocks, *, rows: int):
    pc, nbr = blocks.shape[0], blocks.shape[1]
    nz = jnp.sum((blocks != 0).reshape(pc, rows, nbr // rows, -1),
                 axis=(2, 3))
    return nz                                            # [Pc, rows]


def load_balance_stats(m: PSMatrix) -> tuple[int, int]:
    """(min, max) stored nonzeros per mesh shard (reference
    GetMatrixLoadBalance, PSMatrixModule.F90:1394-1427 — min/max nnz per
    rank; here a "rank" is one (rows, cols) mesh tile).  Counts are
    computed shard-locally on device; only the [cols, rows] int table
    comes back to the host."""
    counts = np.asarray(functools.partial(
        _shard_counts_jit, rows=m.grid.rows)(m.blocks))
    return int(counts.min()), int(counts.max())


def set_grid(m: PSMatrix, grid: ProcessGrid) -> PSMatrix:
    """Move a matrix onto a different process grid (reference
    SetMatrixProcessGrid, PSMatrixModule.F90:309-347).  Device-side
    reshard + re-panel (the cross-mesh device_put inside _rebuild_device
    reshards over the host network when the grids span different device
    sets); the host triplet path remains only as a fallback for
    multi-process configurations whose cross-mesh transfer the JAX
    runtime rejects."""
    from . import dist
    try:
        return _rebuild_device(m, m.dim, grid)
    except (ValueError, RuntimeError):
        if not dist.is_multiprocess():
            raise
    # owner-routed exchange of each host's OWNED triplets (O(nnz/P) per
    # host, not an allgathered union; reference does targeted sends,
    # PSMatrixModule.F90:309-347)
    r, c, v = _local_shard_triplets(m)
    out = empty(m.dim, bs=m.bs, k=m.k, dtype=m.dtype, grid=grid)
    return fill_from_triplets(out, r, c, v, mode="distributed")


def comm_split(m: PSMatrix):
    """Split the matrix's grid in half and re-home a copy on one half
    (reference CommSplitMatrix, PSMatrixModule.F90:1489-1545): enables
    running independent solves on sub-grids.  Returns
    (matrix_on_half_grid, color, split_slice) where color picks which half
    this copy landed on (always 0 under single-controller JAX, which drives
    both halves)."""
    half, _, split_slice = m.grid.split()
    return set_grid(m, half), 0, split_slice


def get_slice(m: PSMatrix, start_row: int, end_row: int, start_col: int,
              end_col: int) -> PSMatrix:
    """GetMatrixSlice (reference PSMatrixModule.F90:1153-1227): extract a
    sub-block as a new square PSMatrix (max of the two extents).

    Device-side for EVERY offset (single- and multi-process): unaligned
    starts ride the static sub-block shift expansion in
    :func:`_shift_coo_jit` (each block contributes up to four shifted
    candidates; duplicates merged) — no host triplet round trip anywhere
    (reference does targeted sends)."""
    new_dim = max(end_row - start_row, end_col - start_col)
    return _rebuild_device(m, new_dim, m.grid,
                           row_off=start_row // m.bs,
                           col_off=start_col // m.bs,
                           rlim=end_row - start_row,
                           clim=end_col - start_col,
                           ro=start_row % m.bs, co=start_col % m.bs)
