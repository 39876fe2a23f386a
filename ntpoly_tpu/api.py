"""NTPoly-compatible object API.

The reference's ultimate consumer surface is the SWIG Python module
(`import NTPolySwig as nt`, reference Source/Swig/NTPolySwig.i + the C++
classes in Source/CPlusPlus/).  This module mirrors that surface 1:1 —
class names, method names, output-matrix-argument conventions, and the
SWIG `%apply double& OUTPUT` pattern (out-doubles become return values) —
so reference users can switch with a one-line import change:

    import ntpoly_tpu as nt

Under the hood everything is the functional JAX core: PSMatrix pytrees on a
(rows, cols, slices) mesh.  Wrapper objects hold a handle (`._m`) and
"mutate" by handle replacement.
"""
from __future__ import annotations

import numpy as np

from .config import DEFAULT_BLOCK_SIZE, default_complex_dtype, \
    default_real_dtype
from .parallel import algebra as _alg
from .parallel import grid as _grid
from .parallel import pmatrix as _pm
from .io import matrix_market as _mm
from .io import binary as _bin
from .core import cplx as _cplx
from .solvers import (analysis as _analysis, chebyshev as _cheb,
                      density as _density, eigen as _eigen,
                      eigenbounds as _bounds, exponential as _exp,
                      fermi as _fermi, geometry as _geo, hermite as _herm,
                      inverse as _inv, linear as _linear,
                      polynomial as _poly, roots as _roots, sign as _sign,
                      squareroot as _sqrt, trigonometry as _trig)
from .solvers.parameters import SolverParameters as _Params
from .utils import maps as _maps
from .utils import permutation as _perm
from .utils.logging import activate_logger as _activate, \
    deactivate_logger as _deactivate, logger as _logger
from .utils import timer as _timer


# ----------------------------------------------------------------------------
# Process grid (reference ProcessGridModule wrapper surface)
# ----------------------------------------------------------------------------

def ConstructGlobalProcessGrid(process_rows=None, process_columns=None,
                               process_slices=1, *args):
    """reference ConstructProcessGrid (ProcessGridModule.F90:84-97).

    Accepts (rows, cols, slices) like the reference; with no arguments the
    grid is auto-sized to the available devices (ComputeGridSize,
    ProcessGridModule.F90:576-601).
    """
    _grid.construct_global_grid(process_rows, process_columns,
                                process_slices)


def DestructGlobalProcessGrid():
    _grid.destruct_global_grid()


def GetGlobalIsRoot() -> bool:
    return True        # single controller drives the whole mesh


def GetGlobalNumRows() -> int:
    return _grid.global_grid().rows


def GetGlobalNumColumns() -> int:
    return _grid.global_grid().cols


def GetGlobalNumSlices() -> int:
    return _grid.global_grid().slices


def GetGlobalMyRow() -> int:
    return 0


def GetGlobalMyColumn() -> int:
    return 0


def GetGlobalMySlice() -> int:
    return 0


def WriteGridInfo():
    """reference WriteGridInfo (Source/CPlusPlus/ProcessGrid.h:111)."""
    g = _grid.global_grid()
    _logger.write_header("Process Grid")
    _logger.enter_sub_log()
    _logger.write_element("Process Rows", g.rows)
    _logger.write_element("Process Columns", g.cols)
    _logger.write_element("Process Slices", g.slices)
    _logger.exit_sub_log()


class ProcessGrid(_grid.ProcessGrid):
    """Custom (non-global) grid; reference Source/CPlusPlus/ProcessGrid.h.

    Under single-controller JAX every "rank" is driven from this process,
    so My{Row,Column,Slice} are 0 (the controller's coordinates).
    """

    def GetMyRow(self) -> int:
        return 0

    def GetMyColumn(self) -> int:
        return 0

    def GetMySlice(self) -> int:
        return 0

    def GetNumRows(self) -> int:
        return self.rows

    def GetNumColumns(self) -> int:
        return self.cols

    def GetNumSlices(self) -> int:
        return self.slices

    def WriteInfo(self):
        _logger.write_header("Process Grid")
        _logger.enter_sub_log()
        _logger.write_element("Process Rows", self.rows)
        _logger.write_element("Process Columns", self.cols)
        _logger.write_element("Process Slices", self.slices)
        _logger.exit_sub_log()


# ----------------------------------------------------------------------------
# Logging / timers
# ----------------------------------------------------------------------------

def ActivateLogger(file_name=None, append=False):
    if isinstance(file_name, bool):      # ActivateLogger(True) -> stdout
        _activate(None)
    else:
        _activate(file_name, append)


def DeactivateLogger():
    _deactivate()


def EnterSubLog():
    _logger.enter_sub_log()


def ExitSubLog():
    _logger.exit_sub_log()


def WriteHeader(key):
    _logger.write_header(key)


def WriteElement(key, value=None):
    _logger.write_element(key, value)


def WriteListElement(key, value=None):
    _logger.write_list_element(key, value)


RegisterTimer = _timer.register_timer
StartTimer = _timer.start_timer
StopTimer = _timer.stop_timer
PrintAllTimers = _timer.print_all_timers
PrintAllTimersDistributed = _timer.print_all_timers_distributed


# ----------------------------------------------------------------------------
# Triplets (reference TripletModule / TripletListModule)
# ----------------------------------------------------------------------------

class Triplet_r:
    def __init__(self, index_row=0, index_column=0, point_value=0.0):
        self.index_row = index_row
        self.index_column = index_column
        self.point_value = point_value


class Triplet_c(Triplet_r):
    pass


class TripletList_r:
    """Growable COO list (reference TripletListModule.F90:14-27)."""
    _complex = False

    def __init__(self, size: int = 0):
        self.rows = [0] * size
        self.columns = [0] * size
        self.values = [0.0] * size

    # -- reference API ---------------------------------------------------
    def Append(self, triplet):
        self.rows.append(triplet.index_row)
        self.columns.append(triplet.index_column)
        self.values.append(triplet.point_value)

    def GetSize(self) -> int:
        return len(self.rows)

    def GetTripletAt(self, index: int):
        t = Triplet_c() if self._complex else Triplet_r()
        t.index_row = self.rows[index]
        t.index_column = self.columns[index]
        t.point_value = self.values[index]
        return t

    def SetTripletAt(self, index: int, triplet):
        self.rows[index] = triplet.index_row
        self.columns[index] = triplet.index_column
        self.values[index] = triplet.point_value

    def Resize(self, size: int):
        cur = len(self.rows)
        if size < cur:
            self.rows, self.columns, self.values = (
                self.rows[:size], self.columns[:size], self.values[:size])
        else:
            self.rows += [0] * (size - cur)
            self.columns += [0] * (size - cur)
            self.values += [0.0] * (size - cur)

    def SortTripletList(self, matrix_size: int | None = None):
        order = np.lexsort((np.asarray(self.rows), np.asarray(self.columns)))
        self.rows = [self.rows[i] for i in order]
        self.columns = [self.columns[i] for i in order]
        self.values = [self.values[i] for i in order]

    # -- internal --------------------------------------------------------
    def _arrays(self):
        dtype = default_complex_dtype() if self._complex \
            else default_real_dtype()
        return (np.asarray(self.rows, np.int64) - 1,
                np.asarray(self.columns, np.int64) - 1,
                np.asarray(self.values, dtype))

    @classmethod
    def _from_arrays(cls, rows, cols, vals):
        out = cls(0)
        out.rows = list(np.asarray(rows, np.int64) + 1)
        out.columns = list(np.asarray(cols, np.int64) + 1)
        out.values = list(vals)
        return out


class TripletList_c(TripletList_r):
    _complex = True


# ----------------------------------------------------------------------------
# SolverParameters / Permutation
# ----------------------------------------------------------------------------

class Permutation(_perm.Permutation):
    """reference Source/CPlusPlus/Permutation.h — stores the dimension at
    construction; Set*Permutation() then builds the lookup."""

    def __init__(self, matrix_dimension: int | None = None):
        super().__init__()
        self._dim = matrix_dimension

    def SetDefaultPermutation(self, dim=None):
        self.set_default_permutation(dim or self._dim)

    def SetReversePermutation(self, dim=None):
        self.set_reverse_permutation(dim or self._dim)

    def SetRandomPermutation(self, dim=None):
        self.set_random_permutation(dim or self._dim)

    def SetLimitedRandomPermutation(self, actual_dim=None, logical_dim=None):
        self.set_limited_random_permutation(actual_dim or self._dim,
                                            logical_dim or self._dim)


class SolverParameters:
    """reference Source/CPlusPlus/SolverParameters.h setters."""

    def __init__(self):
        self._p = _Params()

    def SetConvergeDiff(self, value):
        self._p.converge_diff = value

    def SetMaxIterations(self, value):
        self._p.max_iterations = int(value)

    def SetThreshold(self, value):
        self._p.threshold = value

    def SetVerbosity(self, value):
        self._p.be_verbose = bool(value)

    def SetLoadBalance(self, permutation):
        self._p.do_load_balancing = True
        self._p.balance_permutation = permutation

    def SetStepThreshold(self, value):
        self._p.step_thresh = value

    def SetItersPerSync(self, value):
        """Extension: iterations fused into one compiled scan between
        host convergence checks (1 = reference per-iteration semantics)."""
        self._p.iters_per_sync = int(value)

    def SetMonitorConvergence(self, value):
        self._p.monitor_convergence = bool(value)


def _params_of(sp: SolverParameters | None) -> _Params:
    return sp._p if sp is not None else _Params()


# ----------------------------------------------------------------------------
# Matrix_ps
# ----------------------------------------------------------------------------

def _auto_bs(dim: int) -> int:
    if dim >= 1024:
        return DEFAULT_BLOCK_SIZE
    if dim >= 256:
        return 32
    if dim >= 32:
        return 8
    return 4


def _require_same_embedding(*mats) -> None:
    """Mixed embedded/plain operands would fail deep in the stack with a
    bare shape assert (the embedding doubles the internal dimension);
    surface a typed, actionable error instead."""
    states = {m._embedded for m in mats}
    if len(states) > 1:
        from .utils.errors import ComplexSupportError
        raise ComplexSupportError(
            "operands mix an embedded complex matrix with a plain real "
            "one; build the real operand from the embedded container "
            "(e.g. M2 = Matrix_ps(M1); M2.FillIdentity()) so both share "
            "the embedding")


def _propagate(dst: "Matrix_ps", src: "Matrix_ps") -> None:
    """Copy complex-embedding metadata: f(E(C)) = E(f(C)) for every matrix
    function here, so outputs of embedded inputs are embedded."""
    dst._embedded, dst._cdim = src._embedded, src._cdim


class PMatrixMemoryPool:
    """Capacity pools are internal to the XLA kernels; kept for signature
    parity (reference PMatrixMemoryPoolModule.F90:12-18)."""

    def __init__(self, matrix=None):
        self.matrix = matrix


class Matrix_ps:
    """reference Source/CPlusPlus/PSMatrix.h:20-200.

    Complex data on a backend without native complex arithmetic
    is held as the 2x2 real embedding E(A+iB) = [[A,-B],[B,A]] of twice
    the dimension (core/cplx.py derives why every solver commutes with E).
    ``_embedded``/``_cdim`` track that state; accessors translate, density
    solvers double the trace target and halve reported energies.  The
    reference holds complex natively through every layer
    (PSMatrixModule.F90:1673-1703) — on CPU and GPU so do we.
    """

    _embedded = False                  # class-level defaults
    _cdim = None

    def __init__(self, arg, *extra):
        grid = None
        is_binary = False
        for e in extra:
            if isinstance(e, bool):
                is_binary = e
            elif isinstance(e, _grid.ProcessGrid):
                grid = e
        if isinstance(arg, Matrix_ps):                 # copy constructor
            self._m = arg._m
            self._embedded, self._cdim = arg._embedded, arg._cdim
        elif isinstance(arg, _pm.PSMatrix):
            self._m = arg
        elif isinstance(arg, str):
            if is_binary:
                i, j, v, dim = _bin.read_triplets(arg)
            else:
                i, j, v, dim = _mm.read_triplets(arg)
            self._fill_triplets(i, j, v, dim, grid=grid)
        else:
            dim = int(arg)
            self._m = _pm.empty(dim, bs=_auto_bs(dim),
                                dtype=default_real_dtype(), grid=grid)

    def _fill_triplets(self, i, j, v, dim, grid=None, bs=None, k=None):
        from .config import should_embed_complex
        grid = grid or (self._m.grid if hasattr(self, "_m") else None)
        if np.iscomplexobj(v) and should_embed_complex(grid):
            i, j, v, dim2 = _cplx.embed_triplets(i, j, v, dim)
            m = _pm.empty(dim2, bs=bs or _auto_bs(dim2),
                          dtype=default_real_dtype(), grid=grid)
            self._m = _pm.fill_from_triplets(m, i, j, v)
            self._embedded, self._cdim = True, dim
            return
        dtype = default_complex_dtype() if np.iscomplexobj(v) \
            else default_real_dtype()
        m = _pm.empty(dim, bs=bs or _auto_bs(dim), k=k, dtype=dtype,
                      grid=grid)
        self._m = _pm.fill_from_triplets(m, i, j, v)
        self._embedded, self._cdim = False, None

    def _triplets(self):
        """Stored triplets in USER coordinates (complex when embedded)."""
        r, c, v = _pm.to_triplets(self._m)
        if self._embedded:
            return _cplx.extract_triplets(r, c, v, self._m.dim)[:3]
        return r, c, v

    # -- IO --------------------------------------------------------------
    def WriteToMatrixMarket(self, file_name: str):
        if self._embedded:
            from .parallel import dist
            r, c, v = self._triplets()
            if not (dist.is_multiprocess() and dist.process_index() != 0):
                _mm.write_triplets(file_name, r, c, v, self._cdim)
            return
        _mm.write(self._m, file_name)

    def WriteToBinary(self, file_name: str):
        if self._embedded:
            from .parallel import dist
            r, c, v = self._triplets()
            if not (dist.is_multiprocess() and dist.process_index() != 0):
                _bin.write_triplets(file_name, r, c, v, self._cdim)
            return
        _bin.write(self._m, file_name)

    # -- fills -----------------------------------------------------------
    def FillFromTripletList(self, triplet_list):
        i, j, v = triplet_list._arrays()
        dim = self._cdim if self._embedded else self._m.dim
        self._fill_triplets(i, j, v, dim, grid=self._m.grid,
                            bs=self._m.bs, k=self._m.k)

    def FillIdentity(self):
        self._m = _pm.identity(self._m.dim, bs=self._m.bs, k=self._m.k,
                               dtype=self._m.dtype, grid=self._m.grid)

    def FillDense(self):
        base = _pm.empty(self._m.dim, bs=self._m.bs, dtype=self._m.dtype,
                         grid=self._m.grid)
        i, j = np.meshgrid(np.arange(self._m.dim), np.arange(self._m.dim),
                           indexing="ij")
        self._m = _pm.fill_from_triplets(
            base, i.ravel(), j.ravel(), np.ones(self._m.dim ** 2))

    def FillDistributedPermutation(self, lb, permuterows=True):
        p_rows, p_cols = _perm.permutation_matrices(lb, self._m)
        self._m = p_rows if permuterows else p_cols

    # -- accessors -------------------------------------------------------
    def GetActualDimension(self) -> int:
        return self._cdim if self._embedded else self._m.dim

    def GetLogicalDimension(self) -> int:
        return self._m.logical_dim

    def GetSize(self) -> int:
        """Stored nonzero count.  The embedded path is a collective host
        gather of the full triplet set (O(global nnz) per host)."""
        if self._embedded:
            return len(self._triplets()[2])
        return self._m.nnz

    def GetTripletList(self, triplet_list):
        r, c, v = self._triplets()
        order = np.lexsort((c, r))
        new = type(triplet_list)._from_arrays(r[order], c[order], v[order])
        triplet_list.rows = new.rows
        triplet_list.columns = new.columns
        triplet_list.values = new.values

    def GetMatrixBlock(self, triplet_list, start_row, end_row, start_column,
                       end_column):
        r, c, v = self._triplets()
        keep = ((r >= start_row) & (r < end_row)
                & (c >= start_column) & (c < end_column))
        new = type(triplet_list)._from_arrays(r[keep], c[keep], v[keep])
        triplet_list.rows = new.rows
        triplet_list.columns = new.columns
        triplet_list.values = new.values

    def GetMatrixSlice(self, submatrix, start_row, end_row, start_column,
                       end_column):
        if self._embedded:
            r, c, v = self._triplets()
            keep = ((r >= start_row) & (r <= end_row)
                    & (c >= start_column) & (c <= end_column))
            dim = max(end_row - start_row, end_column - start_column) + 1
            submatrix._fill_triplets(
                r[keep] - start_row, c[keep] - start_column, v[keep], dim,
                grid=self._m.grid, bs=self._m.bs)
            return
        submatrix._m = _pm.get_slice(self._m, start_row, end_row + 1,
                                     start_column, end_column + 1)

    def IsIdentity(self) -> bool:
        """reference PSMatrixModule.F90:1810-1852."""
        ident = _pm.identity(self._m.dim, bs=self._m.bs, k=self._m.k,
                             dtype=self._m.dtype, grid=self._m.grid)
        diff = _alg.increment(self._m, ident, 1.0, -1.0)
        return float(_alg.norm(diff)) == 0.0

    # -- structure -------------------------------------------------------
    @staticmethod
    def _embed_sign(m, cdim):
        """P = diag(+I_cdim, -I): E(conj C) = P E(C) P (conjugation flips
        the imaginary blocks' signs).  The boundary is the COMPLEX
        dimension cdim — NOT logical_dim//2, which drifts whenever the
        block/grid geometry pads the embedded matrix."""
        d = np.where(np.arange(m.logical_dim) < cdim, 1.0, -1.0)
        return _alg.diagonal_scale(
            _alg.diagonal_scale(m, d, side="left"), d, side="right")

    def Transpose(self, matA: "Matrix_ps"):
        t = _alg.transpose(matA._m)
        # embedded: E(A)^T = E(A^H); plain transpose needs the conjugation
        # fix-up P E(A)^T P = E(A^T)
        self._m = self._embed_sign(t, matA._cdim) if matA._embedded else t
        _propagate(self, matA)

    def Conjugate(self):
        if self._embedded:
            self._m = self._embed_sign(self._m, self._cdim)
        else:
            self._m = self._m.conjugate()

    def Resize(self, new_size: int):
        if self._embedded:
            r, c, v = self._triplets()
            keep = (r < new_size) & (c < new_size)
            self._fill_triplets(r[keep], c[keep], v[keep], new_size,
                                grid=self._m.grid, bs=self._m.bs)
            return
        self._m = _pm.resize(self._m, new_size)

    # -- algebra ---------------------------------------------------------
    def Dot(self, matB: "Matrix_ps"):
        _require_same_embedding(self, matB)
        result = complex(_alg.dot(self._m, matB._m))
        # <E(A), E(B)> = 2 Re<A, B> (real+imag parts each counted once
        # per diagonal block of the embedding)
        return result.real / 2.0 if self._embedded else result.real

    def Dot_c(self, matB: "Matrix_ps"):
        """Complex dot.  Embedded path is a collective host gather of BOTH
        operands' triplets (O(global nnz) per host) — the embedding loses
        the imaginary part of the device-side dot, so exactness costs a
        round trip; prefer Dot when only the real part is needed."""
        _require_same_embedding(self, matB)
        if self._embedded:
            # vectorized sorted-coordinate join on packed (row, col) keys
            ra, ca, va = self._triplets()
            rb, cb, vb = matB._triplets()
            dim = self._cdim
            ka, kb = ra * dim + ca, rb * dim + cb      # ka sorted
            pos = np.searchsorted(ka, kb)
            pos_c = np.minimum(pos, max(len(ka) - 1, 0))
            hit = (pos < len(ka)) & (len(ka) > 0)
            hit &= np.where(hit, ka[pos_c] == kb, False)
            return complex(np.sum(np.conj(va[pos_c[hit]]) * vb[hit]))
        return complex(_alg.dot(self._m, matB._m))

    def Increment(self, matB: "Matrix_ps", alpha=1.0, threshold=0.0):
        _require_same_embedding(self, matB)
        if np.iscomplexobj(alpha) and matB._embedded:
            raise TypeError("complex alpha requires native complex; "
                            "real alpha commutes with the embedding")
        self._m = _alg.increment(self._m, matB._m, beta=alpha,
                                 alpha=1.0, threshold=threshold)
        _propagate(self, matB)

    def PairwiseMultiply(self, matA: "Matrix_ps", matB: "Matrix_ps"):
        """Hadamard product.  The embedded path does NOT commute with the
        embedding, so it is a collective host gather of both operands'
        triplets (O(global nnz) per host) followed by a re-embed."""
        _require_same_embedding(matA, matB)
        if matA._embedded:
            # vectorized sorted-coordinate join on packed (row, col) keys
            ra, ca, va = matA._triplets()
            rb, cb, vb = matB._triplets()
            dim = matA._cdim
            ka, kb = ra * dim + ca, rb * dim + cb      # both sorted
            pos = np.searchsorted(kb, ka)
            pos_c = np.minimum(pos, max(len(kb) - 1, 0))
            hit = (pos < len(kb)) & (len(kb) > 0)
            hit &= np.where(hit, kb[pos_c] == ka, False)
            vv = np.zeros(len(va), np.complex128)
            vv[hit] = va[hit] * vb[pos_c[hit]]
            self._fill_triplets(ra, ca, vv, matA._cdim, grid=matA._m.grid,
                                bs=matA._m.bs)
            return
        self._m = _alg.pairwise_multiply(matA._m, matB._m)
        _propagate(self, matA)

    def Gemm(self, matA: "Matrix_ps", matB: "Matrix_ps", memory_pool=None,
             alpha=1.0, beta=0.0, threshold=0.0):
        _require_same_embedding(matA, matB)
        if beta != 0.0:
            # self is an operand too (the accumulate target)
            _require_same_embedding(self, matA)
        if np.iscomplexobj(alpha) and matA._embedded:
            raise TypeError("complex alpha requires native complex; "
                            "real alpha commutes with the embedding")
        self._m = _alg.matmul(matA._m, matB._m, alpha=alpha, beta=beta,
                              c=self._m if beta != 0.0 else None,
                              threshold=threshold)
        _propagate(self, matA)

    def Scale(self, constant):
        if np.iscomplexobj(constant) and self._embedded:
            raise TypeError("complex scale factors require native "
                            "complex; real factors commute with the "
                            "embedding")
        self._m = _alg.scale(self._m, constant)

    def Norm(self):
        """Max column 1-norm.  The embedded path is a collective host
        gather of the full triplet set (O(global nnz) per host): the
        embedding's column sums see |Re| + |Im|, not |v|."""
        if self._embedded:
            # exact complex column 1-norm from extracted triplets
            r, c, v = self._triplets()
            sums = np.zeros(self._cdim)
            np.add.at(sums, c.astype(np.int64), np.abs(v))
            return float(sums.max()) if len(v) else 0.0
        return float(_alg.norm(self._m))

    def MeasureAsymmetry(self):
        return float(_alg.measure_asymmetry(self._m))

    def Trace(self):
        t = complex(_alg.trace(self._m)).real
        return t / 2.0 if self._embedded else t

    def Symmetrize(self):
        self._m = _alg.symmetrize(self._m)

    def DiagonalScale(self, tlist):
        i, j, v = tlist._arrays()
        d = np.zeros(self._m.dim,
                     default_complex_dtype() if tlist._complex
                     else default_real_dtype())
        d[j] = v
        self._m = _alg.diagonal_scale(self._m.astype(d.dtype), d,
                                      side="right")


# ----------------------------------------------------------------------------
# Solver namespaces (reference Source/CPlusPlus/*Solvers.h static classes)
# ----------------------------------------------------------------------------

class DensityMatrixSolvers:
    @staticmethod
    def PM(Hamiltonian, InverseSquareRoot, nel, Density, sp=None):
        _require_same_embedding(Hamiltonian, InverseSquareRoot)
        emb = Hamiltonian._embedded
        k, e, mu = _density.pm(
            Hamiltonian._m, InverseSquareRoot._m,
            2 * nel if emb else nel, _params_of(sp))
        Density._m = k
        _propagate(Density, Hamiltonian)
        return (e / 2.0 if emb else e), mu

    @staticmethod
    def TRS2(Hamiltonian, InverseSquareRoot, nel, Density, sp=None):
        _require_same_embedding(Hamiltonian, InverseSquareRoot)
        emb = Hamiltonian._embedded
        k, e, mu = _density.trs2(
            Hamiltonian._m, InverseSquareRoot._m,
            2 * nel if emb else nel, _params_of(sp))
        Density._m = k
        _propagate(Density, Hamiltonian)
        return (e / 2.0 if emb else e), mu

    @staticmethod
    def TRS4(Hamiltonian, InverseSquareRoot, nel, Density, sp=None):
        _require_same_embedding(Hamiltonian, InverseSquareRoot)
        emb = Hamiltonian._embedded
        k, e, mu = _density.trs4(
            Hamiltonian._m, InverseSquareRoot._m,
            2 * nel if emb else nel, _params_of(sp))
        Density._m = k
        _propagate(Density, Hamiltonian)
        return (e / 2.0 if emb else e), mu

    @staticmethod
    def HPCP(Hamiltonian, InverseSquareRoot, nel, Density, sp=None):
        _require_same_embedding(Hamiltonian, InverseSquareRoot)
        emb = Hamiltonian._embedded
        k, e, mu = _density.hpcp(
            Hamiltonian._m, InverseSquareRoot._m,
            2 * nel if emb else nel, _params_of(sp))
        Density._m = k
        _propagate(Density, Hamiltonian)
        return (e / 2.0 if emb else e), mu

    @staticmethod
    def ScaleAndFold(Hamiltonian, InverseSquareRoot, nel, Density, homo,
                     lumo, sp=None):
        _require_same_embedding(Hamiltonian, InverseSquareRoot)
        emb = Hamiltonian._embedded
        k, e = _density.scale_and_fold(
            Hamiltonian._m, InverseSquareRoot._m,
            2 * nel if emb else nel, homo, lumo, _params_of(sp))
        Density._m = k
        _propagate(Density, Hamiltonian)
        return e / 2.0 if emb else e

    @staticmethod
    def DenseDensity(Hamiltonian, InverseSquareRoot, nel, Density, sp=None):
        _require_same_embedding(Hamiltonian, InverseSquareRoot)
        emb = Hamiltonian._embedded
        k, e, mu = _fermi.compute_dense_foe(
            Hamiltonian._m, InverseSquareRoot._m,
            2 * nel if emb else nel, params=_params_of(sp))
        Density._m = k
        _propagate(Density, Hamiltonian)
        return (e / 2.0 if emb else e), mu

    @staticmethod
    def EnergyDensityMatrix(Hamiltonian, Density, EnergyDensity,
                            threshold=0.0):
        _require_same_embedding(Hamiltonian, Density)
        EnergyDensity._m = _density.energy_density_matrix(
            Hamiltonian._m, Density._m, threshold)
        _propagate(EnergyDensity, Hamiltonian)

    @staticmethod
    def McWeenyStep(D, *args):
        # McWeenyStep(D, DOut) or McWeenyStep(D, S, DOut)
        if len(args) == 1:
            args[0]._m = _density.mcweeny_step(D._m)
            _propagate(args[0], D)
        else:
            s, dout = args
            dout._m = _density.mcweeny_step(D._m, s._m)
            _propagate(dout, D)


class FermiOperator:
    @staticmethod
    def ComputeDenseFOE(Hamiltonian, InverseSquareRoot, nel, Density,
                        inv_temp=None, sp=None):
        if isinstance(inv_temp, SolverParameters):
            sp, inv_temp = inv_temp, None
        _require_same_embedding(Hamiltonian, InverseSquareRoot)
        emb = Hamiltonian._embedded
        k, e, mu = _fermi.compute_dense_foe(
            Hamiltonian._m, InverseSquareRoot._m,
            2 * nel if emb else nel, inv_temp=inv_temp,
            params=_params_of(sp))
        Density._m = k
        _propagate(Density, Hamiltonian)
        return (e / 2.0 if emb else e), mu

    @staticmethod
    def WOM_GC(Hamiltonian, InverseSquareRoot, Density, chemical_potential,
               inv_temp, sp=None):
        _require_same_embedding(Hamiltonian, InverseSquareRoot)
        emb = Hamiltonian._embedded
        k, e = _fermi.wom_gc(Hamiltonian._m, InverseSquareRoot._m,
                             chemical_potential, inv_temp, _params_of(sp))
        Density._m = k
        _propagate(Density, Hamiltonian)
        return e / 2.0 if emb else e

    @staticmethod
    def WOM_C(Hamiltonian, InverseSquareRoot, Density, nel, inv_temp,
              sp=None):
        _require_same_embedding(Hamiltonian, InverseSquareRoot)
        emb = Hamiltonian._embedded
        k, e = _fermi.wom_c(Hamiltonian._m, InverseSquareRoot._m,
                            2 * nel if emb else nel, inv_temp,
                            _params_of(sp))
        Density._m = k
        _propagate(Density, Hamiltonian)
        return e / 2.0 if emb else e


class InverseSolvers:
    @staticmethod
    def Invert(InputMat, OutputMat, sp=None):
        OutputMat._m = _inv.invert(InputMat._m, _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def PseudoInverse(InputMat, OutputMat, sp=None):
        OutputMat._m = _inv.pseudo_inverse(InputMat._m, _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def DenseInvert(InputMat, OutputMat, sp=None):
        OutputMat._m = _inv.dense_invert(InputMat._m, _params_of(sp))
        _propagate(OutputMat, InputMat)


class SquareRootSolvers:
    @staticmethod
    def SquareRoot(InputMat, OutputMat, sp=None, order=5):
        OutputMat._m = _sqrt.square_root(InputMat._m, _params_of(sp), order)
        _propagate(OutputMat, InputMat)

    @staticmethod
    def InverseSquareRoot(InputMat, OutputMat, sp=None, order=5):
        OutputMat._m = _sqrt.inverse_square_root(InputMat._m,
                                                 _params_of(sp), order)
        _propagate(OutputMat, InputMat)

    @staticmethod
    def DenseSquareRoot(InputMat, OutputMat, sp=None):
        OutputMat._m = _sqrt.dense_square_root(InputMat._m, _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def DenseInverseSquareRoot(InputMat, OutputMat, sp=None):
        OutputMat._m = _sqrt.dense_inverse_square_root(InputMat._m,
                                                       _params_of(sp))
        _propagate(OutputMat, InputMat)


class SignSolvers:
    @staticmethod
    def ComputeSign(InputMat, OutputMat, sp=None):
        OutputMat._m = _sign.sign_function(InputMat._m, _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def ComputeDenseSign(InputMat, OutputMat, sp=None):
        OutputMat._m = _sign.dense_sign_function(InputMat._m,
                                                 _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def ComputePolarDecomposition(InputMat, UMat, HMat, sp=None):
        u, h = _sign.polar_decomposition(InputMat._m, _params_of(sp))
        UMat._m, HMat._m = u, h


class RootSolvers:
    @staticmethod
    def ComputeRoot(InputMat, OutputMat, root, sp=None):
        OutputMat._m = _roots.compute_root(InputMat._m, root,
                                           _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def ComputeInverseRoot(InputMat, OutputMat, root, sp=None):
        OutputMat._m = _roots.compute_inverse_root(InputMat._m, root,
                                                   _params_of(sp))
        _propagate(OutputMat, InputMat)


class ExponentialSolvers:
    @staticmethod
    def ComputeExponential(InputMat, OutputMat, sp=None):
        OutputMat._m = _exp.compute_exponential(InputMat._m, _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def ComputeExponentialPade(InputMat, OutputMat, sp=None):
        OutputMat._m = _exp.compute_exponential_pade(InputMat._m,
                                                     _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def ComputeExponentialTaylor(InputMat, OutputMat, sp=None):
        OutputMat._m = _exp.compute_exponential_taylor(InputMat._m,
                                                       _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def ComputeDenseExponential(InputMat, OutputMat, sp=None):
        OutputMat._m = _exp.compute_dense_exponential(InputMat._m,
                                                      _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def ComputeLogarithm(InputMat, OutputMat, sp=None):
        OutputMat._m = _exp.compute_logarithm(InputMat._m, _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def ComputeLogarithmTaylor(InputMat, OutputMat, sp=None):
        OutputMat._m = _exp.compute_logarithm_taylor(InputMat._m,
                                                     _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def ComputeDenseLogarithm(InputMat, OutputMat, sp=None):
        OutputMat._m = _exp.compute_dense_logarithm(InputMat._m,
                                                    _params_of(sp))
        _propagate(OutputMat, InputMat)


class TrigonometrySolvers:
    @staticmethod
    def Sine(InputMat, OutputMat, sp=None):
        OutputMat._m = _trig.sine(InputMat._m, _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def Cosine(InputMat, OutputMat, sp=None):
        OutputMat._m = _trig.cosine(InputMat._m, _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def DenseSine(InputMat, OutputMat, sp=None):
        OutputMat._m = _trig.dense_sine(InputMat._m, _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def DenseCosine(InputMat, OutputMat, sp=None):
        OutputMat._m = _trig.dense_cosine(InputMat._m, _params_of(sp))
        _propagate(OutputMat, InputMat)

    @staticmethod
    def ScaleSquareTrigonometryTaylor(InputMat, OutputMat, sp=None):
        OutputMat._m = _trig.scale_square_trigonometry_taylor(
            InputMat._m, _params_of(sp))
        _propagate(OutputMat, InputMat)


class LinearSolvers:
    @staticmethod
    def CGSolver(AMat, XMat, BMat, sp=None):
        XMat._m = _linear.cg_solver(AMat._m, BMat._m, _params_of(sp))

    @staticmethod
    def CholeskyDecomposition(AMat, LMat, sp=None):
        LMat._m = _linear.cholesky_decomposition(AMat._m, _params_of(sp))


class EigenBounds:
    @staticmethod
    def GershgorinBounds(InputMat):
        return _bounds.gershgorin_bounds(InputMat._m)

    @staticmethod
    def PowerBounds(InputMat, sp=None):
        return _bounds.power_bounds(InputMat._m, _params_of(sp))


def _embedded_dense(InputMat):
    """Gather an embedded matrix to a host dense complex array — the
    gather-to-LAPACK role of the reference's EigenSerial fallback
    (eigenexa_includes/EigenSerial.f90)."""
    r, c, v = InputMat._triplets()
    n = InputMat._cdim
    dense = np.zeros((n, n), np.complex128)
    dense[r.astype(np.int64), c.astype(np.int64)] = v
    return dense


def _embedded_eigh(InputMat):
    """Eigendecomposition does NOT commute with the 2x2 embedding (the
    spectrum of E(C) is C's with doubled multiplicity), so embedded
    matrices are decomposed on the host: extract complex triplets, dense
    np.linalg.eigh — exactly the role of the reference's EigenSerial
    gather-to-LAPACK fallback (eigenexa_includes/EigenSerial.f90)."""
    return np.linalg.eigh(_embedded_dense(InputMat))


def _host_pivoted_cholesky(a, rank: int):
    """Rank-``rank`` pivoted Cholesky L (n x rank) with A ~= L L^H — the
    host complex leg of the embedded ReduceDimension (same max-diagonal
    pivot rule as solvers/analysis.py; reference AnalysisModule.F90:30-221,
    aquilante2006fast)."""
    n = a.shape[0]
    ell = np.zeros((n, rank), dtype=a.dtype)
    diag = np.real(np.diag(a)).copy().astype(np.float64)
    for jj in range(rank):
        p = int(np.argmax(diag))
        val = diag[p]
        if val <= 0:
            break
        col = (a[:, p] - ell[:, :jj] @ np.conj(ell[p, :jj])) / np.sqrt(val)
        col[p] = np.sqrt(val)
        ell[:, jj] = col
        diag -= np.abs(col) ** 2
        diag[p] = 0.0
    return ell


class EigenSolvers:
    @staticmethod
    def EigenDecomposition(InputMat, EigenValues, nvals=None,
                           EigenVectors=None, sp=None):
        if InputMat._embedded:
            w, v = _embedded_eigh(InputMat)
            n = InputMat._cdim
            if nvals is not None and nvals < n:
                w = np.where(np.arange(n) < nvals, w, 0.0)
                v = v * (np.arange(n)[None, :] < nvals)
            i = np.arange(n)
            EigenValues._fill_triplets(i, i, w + 0j, n,
                                       grid=InputMat._m.grid,
                                       bs=InputMat._m.bs)
            if EigenVectors is not None:
                ii, jj = np.nonzero(np.abs(v) > 0)
                EigenVectors._fill_triplets(ii, jj, v[ii, jj], n,
                                            grid=InputMat._m.grid,
                                            bs=InputMat._m.bs)
            return
        vals, vecs = _eigen.eigen_decomposition(
            InputMat._m, nvals=nvals, params=_params_of(sp),
            compute_vectors=EigenVectors is not None)
        EigenValues._m = vals
        _propagate(EigenValues, InputMat)
        if EigenVectors is not None:
            EigenVectors._m = vecs
            _propagate(EigenVectors, InputMat)

    @staticmethod
    def EigenValues(InputMat, EigenValuesOut, nvals=None, sp=None):
        if InputMat._embedded:
            EigenSolvers.EigenDecomposition(InputMat, EigenValuesOut,
                                            nvals=nvals, sp=sp)
            return
        EigenValuesOut._m = _eigen.eigen_values(InputMat._m, nvals=nvals,
                                                params=_params_of(sp))
        _propagate(EigenValuesOut, InputMat)

    @staticmethod
    def IterativeEigenDecomposition(InputMat, nvals, sp=None):
        """Extension (no reference analogue short of the
        optional EigenExa bridge): lowest-nvals eigenpairs by matrix-free
        LOBPCG over the distributed sparse operator.  Returns
        (eigenvalues ndarray [nvals], eigenvectors ndarray [dim, nvals])."""
        if InputMat._embedded:
            # run the real LOBPCG directly on the stored embedding (its
            # spectrum is the complex matrix's with doubled multiplicity)
            # and reconstruct the complex pairs
            w2, v2 = _eigen.eigen_decomposition_iterative(
                InputMat._m, 2 * nvals, params=_params_of(sp))
            return _eigen.dedup_embedded_pairs(
                np.asarray(w2), np.asarray(v2), InputMat._cdim, nvals)
        w, v = _eigen.eigen_decomposition_iterative(
            InputMat._m, nvals, params=_params_of(sp))
        return np.asarray(w), np.asarray(v)

    @staticmethod
    def SingularValueDecomposition(InputMat, LeftVectors, RightVectors,
                                   SingularValues, sp=None):
        """reference SingularValueSolversModule.F90:18-70.  A = L S R^H
        with ascending singular values (eigh order, matching the
        reference's polar + eigendecomposition route).  SVD factors do
        not commute with the 2x2 embedding (doubled multiplicities), so
        the embedded path runs a host complex SVD on the gathered dense
        matrix — the same EigenSerial-style fallback as
        EigenDecomposition."""
        if InputMat._embedded:
            u, s, vh = np.linalg.svd(_embedded_dense(InputMat))
            idx = np.argsort(s)                   # ascending, eigh order
            left = u[:, idx]
            right = np.conj(vh).T[:, idx]
            n = InputMat._cdim
            grid, bs = InputMat._m.grid, InputMat._m.bs

            def fill(mat, dense):
                ii, jj = np.nonzero(np.abs(dense) > 0)
                mat._fill_triplets(ii, jj, dense[ii, jj] + 0j, n,
                                   grid=grid, bs=bs)

            fill(LeftVectors, left)
            fill(RightVectors, right)
            i = np.arange(n)
            SingularValues._fill_triplets(i, i, s[idx] + 0j, n,
                                          grid=grid, bs=bs)
            return
        left, right, vals = _eigen.singular_value_decomposition(
            InputMat._m, _params_of(sp))
        LeftVectors._m, RightVectors._m, SingularValues._m = left, right, \
            vals

    @staticmethod
    def EstimateGap(Hmat, Kmat, chemical_potential, sp=None):
        return _eigen.estimate_gap(Hmat._m, Kmat._m, chemical_potential,
                                   _params_of(sp))


class GeometryOptimization:
    @staticmethod
    def PurificationExtrapolate(PreviousDensity, Overlap, nel, NewDensity,
                                sp=None):
        NewDensity._m = _geo.purification_extrapolate(
            PreviousDensity._m, Overlap._m, nel, _params_of(sp))
        _propagate(NewDensity, PreviousDensity)

    @staticmethod
    def LowdinExtrapolate(PreviousDensity, OldOverlap, NewOverlap,
                          NewDensity, sp=None):
        NewDensity._m = _geo.lowdin_extrapolate(
            PreviousDensity._m, OldOverlap._m, NewOverlap._m,
            _params_of(sp))
        _propagate(NewDensity, PreviousDensity)


class Analysis:
    @staticmethod
    def PivotedCholeskyDecomposition(AMat, LMat, rank, sp=None):
        LMat._m = _analysis.pivoted_cholesky_decomposition(
            AMat._m, rank, _params_of(sp))

    @staticmethod
    def ReduceDimension(InputMat, dim, ReducedMat, sp=None):
        """reference AnalysisModule.F90:222-279.  The rank-dim subspace
        slice does not commute with the 2x2 embedding, so the embedded
        path replays the reference's algorithm host-side in native
        complex: projector onto the lowest ``dim`` eigenstates (the TRS4
        fixed point with trace target dim), rank-dim pivoted Cholesky of
        it, rotate, slice."""
        if InputMat._embedded:
            h = _embedded_dense(InputMat)
            w, v = np.linalg.eigh(h)
            occ = v[:, :dim]
            p = occ @ np.conj(occ).T              # TRS4(trace=dim) limit
            ell = _host_pivoted_cholesky(p, dim)
            vav = np.conj(ell).T @ h @ ell        # [dim, dim]
            ii, jj = np.nonzero(np.abs(vav) > 0)
            ReducedMat._fill_triplets(ii, jj, vav[ii, jj] + 0j, dim,
                                      grid=InputMat._m.grid,
                                      bs=InputMat._m.bs)
            return
        ReducedMat._m = _analysis.reduce_dimension(InputMat._m, dim,
                                                   _params_of(sp))
        _propagate(ReducedMat, InputMat)


class MatrixConversion:
    @staticmethod
    def SnapMatrixToSparsityPattern(Mat, Pattern):
        Mat._m = _maps.snap_to_sparsity_pattern(Mat._m, Pattern._m)


class ComplexEmbedding:
    """Extension: complex matrices as their real 2x2 embedding
    E(A + iB) = [[A, -B], [B, A]] (core/cplx.py).  E is a ring
    homomorphism, so f(E(C)) = E(f(C)) for every solver here — the
    supported route for complex data on real-only accelerator backends."""

    @staticmethod
    def Embed(InMat, OutMat):
        from .core import cplx
        OutMat._m = cplx.embed(InMat._m)

    @staticmethod
    def Extract(InMat, OutMat):
        from .core import cplx
        OutMat._m = cplx.extract(InMat._m)


# ----------------------------------------------------------------------------
# Polynomial objects (methods mirror the C++ member functions)
# ----------------------------------------------------------------------------

class Polynomial(_poly.Polynomial):
    def SetCoefficient(self, index, value):
        self.set_coefficient(index, value)

    def HornerCompute(self, InputMat, OutputMat, sp=None):
        OutputMat._m = _poly.horner_compute(InputMat._m, self,
                                            _params_of(sp))

    def PatersonStockmeyerCompute(self, InputMat, OutputMat, sp=None):
        OutputMat._m = _poly.paterson_stockmeyer_compute(
            InputMat._m, self, _params_of(sp))


class ChebyshevPolynomial(_cheb.ChebyshevPolynomial):
    def SetCoefficient(self, index, value):
        self.set_coefficient(index, value)

    def Compute(self, InputMat, OutputMat, sp=None):
        OutputMat._m = _cheb.compute(InputMat._m, self, _params_of(sp))

    def ComputeFactorized(self, InputMat, OutputMat, sp=None):
        OutputMat._m = _cheb.factorized_compute(InputMat._m, self,
                                                _params_of(sp))


class HermitePolynomial(_herm.HermitePolynomial):
    def SetCoefficient(self, index, value):
        self.set_coefficient(index, value)

    def Compute(self, InputMat, OutputMat, sp=None):
        OutputMat._m = _herm.compute(InputMat._m, self, _params_of(sp))


# ----------------------------------------------------------------------------
# Matrix maps (SWIG directors become plain Python callables)
# ----------------------------------------------------------------------------

RealOperation = _maps.RealOperation
ComplexOperation = _maps.ComplexOperation


class MatrixMapper:
    @staticmethod
    def Map(inmat, outmat, proc):
        outmat._m = _maps.map_matrix(inmat._m, proc)

    @staticmethod
    def MapVectorized(inmat, outmat, fn):
        """Vectorized fast path: fn(rows, cols, vals) -> (rows, cols, vals)
        or (rows, cols, vals, keep_mask) over whole triplet arrays — the
        device idiom for element maps (one fused kernel instead of a
        Python call per element)."""
        outmat._m = _maps.map_triplets(inmat._m, fn)

    @staticmethod
    def GetSliceInfo(mat):
        """(num_slices, my_slice) of the matrix's grid (reference
        Source/CPlusPlus/MatrixMapper.h:73-74; the slice-round-robin
        work split is internal here, so my_slice is the controller's 0)."""
        return mat._m.grid.slices, 0


class LoadBalancer:
    """Permutation-based load balancing (reference
    Source/CPlusPlus/LoadBalancer.h, LoadBalancerModule.F90:16-92)."""

    @staticmethod
    def PermuteMatrix(mat_in, mat_out, permutation, memorypool=None):
        mat_out._m = _perm.permute_matrix(mat_in._m, permutation)

    @staticmethod
    def UndoPermuteMatrix(mat_in, mat_out, permutation, memorypool=None):
        mat_out._m = _perm.undo_permute_matrix(mat_in._m, permutation)


# ----------------------------------------------------------------------------
# Local matrices (reference Source/CPlusPlus/SMatrix.h, test_matrix.py API)
# ----------------------------------------------------------------------------

class MatrixMemoryPool_r:
    """Scratch pools are internal to the XLA kernels; signature parity only
    (reference MatrixMemoryPoolModule.F90:13-56)."""

    def __init__(self, columns=0, rows=0):
        self.columns, self.rows = columns, rows


class MatrixMemoryPool_c(MatrixMemoryPool_r):
    pass


class Matrix_lsr:
    """Local sparse matrix (reference Matrix_lsr, SMatrix.h:21-103)."""
    _complex = False
    _TripletList = TripletList_r

    def __init__(self, arg, *extra):
        from .core.lmatrix import LocalMatrix
        dtype = default_complex_dtype() if self._complex \
            else default_real_dtype()
        if isinstance(arg, str):
            i, j, v, shape = _mm.read_triplets_shape(arg)
            self._m = LocalMatrix.from_triplets(i, j, v.astype(dtype),
                                                shape[0], shape[1])
        elif isinstance(arg, TripletList_r):
            i, j, v = arg._arrays()
            rows, columns = extra
            self._m = LocalMatrix.from_triplets(i, j, v.astype(dtype),
                                                rows, columns)
        elif isinstance(arg, Matrix_lsr):
            self._m = arg._m
        else:
            columns, rows = int(arg), int(extra[0])
            self._m = LocalMatrix(rows, columns, dtype=dtype)

    def GetRows(self) -> int:
        return self._m.rows

    def GetColumns(self) -> int:
        return self._m.cols

    def Scale(self, constant):
        self._m.scale(constant)

    def Increment(self, matB, alpha=1.0, threshold=0.0):
        self._m.increment(matB._m, alpha, threshold)

    def Dot(self, matB):
        result = complex(self._m.dot(matB._m))
        return result if self._complex else result.real

    def PairwiseMultiply(self, matA, matB):
        self._m.pairwise(matA._m, matB._m)

    def Gemm(self, matA, matB, isATransposed, isBTransposed, alpha, beta,
             threshold, memory_pool=None):
        self._m.gemm(matA._m, matB._m, isATransposed, isBTransposed,
                     alpha, beta, threshold)

    def DiagonalScale(self, tlist):
        i, j, v = tlist._arrays()
        d = np.zeros(self._m.cols, default_complex_dtype()
                     if tlist._complex else default_real_dtype())
        d[j] = v
        self._m.diagonal_scale(d)

    def Transpose(self, matA):
        self._m.transpose(matA._m)

    def Conjugate(self):
        self._m.conjugate()

    def ExtractRow(self, row_number, row_out):
        row_out._m = self._m.extract_row(row_number)

    def ExtractColumn(self, column_number, column_out):
        column_out._m = self._m.extract_column(column_number)

    def Print(self):
        print(self._m.to_dense())

    def WriteToMatrixMarket(self, file_name):
        i, j, v = self._m.to_triplets()
        is_complex = np.iscomplexobj(v)
        field = "complex" if is_complex else "real"
        with open(file_name, "w") as f:
            f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
            f.write(f"{self._m.rows} {self._m.cols} {len(v)}\n")
            for r, c, val in zip(i + 1, j + 1, v):
                if is_complex:
                    f.write(f"{r} {c} {val.real:.16g} {val.imag:.16g}\n")
                else:
                    f.write(f"{r} {c} {val:.16g}\n")

    def MatrixToTripletList(self, triplet_list):
        i, j, v = self._m.to_triplets()
        order = np.lexsort((i, j))
        new = type(triplet_list)._from_arrays(i[order], j[order], v[order])
        triplet_list.rows = new.rows
        triplet_list.columns = new.columns
        triplet_list.values = new.values


class Matrix_lsc(Matrix_lsr):
    _complex = True
    _TripletList = TripletList_c
