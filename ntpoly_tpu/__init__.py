"""ntpoly_tpu — sparse matrix-function library for JAX.

A from-scratch JAX/XLA re-design of the capabilities of NTPoly
(github.com/william-dawson/NTPoly): functions of large sparse Hermitian
matrices via threshold-filtered polynomial expansions, built on one
primitive — a distributed block-sparse SpGEMM over a 3-axis
(rows x cols x slices) device mesh.

Two surfaces:

* the functional core (``ntpoly_tpu.parallel``, ``ntpoly_tpu.solvers``) —
  pytrees + pure functions, jit/vmap-friendly;
* the NTPoly-compatible object API re-exported here (``import ntpoly_tpu
  as nt``) mirroring the reference's SWIG Python module
  (reference Source/Swig/NTPolySwig.i).
"""
from .api import *          # noqa: F401,F403
from . import config        # noqa: F401
from .utils.errors import (  # noqa: F401
    NTPolyError, GridError, IOFormatError, ConvergenceError)
from .api import (          # noqa: F401 — explicit for introspection
    ConstructGlobalProcessGrid, DestructGlobalProcessGrid, GetGlobalIsRoot,
    GetGlobalNumRows, GetGlobalNumColumns, GetGlobalNumSlices,
    GetGlobalMyRow, GetGlobalMyColumn, GetGlobalMySlice,
    ActivateLogger, DeactivateLogger, ProcessGrid,
    Triplet_r, Triplet_c, TripletList_r, TripletList_c,
    Matrix_ps, Matrix_lsr, Matrix_lsc,
    MatrixMemoryPool_r, MatrixMemoryPool_c, PMatrixMemoryPool,
    Permutation, SolverParameters,
    DensityMatrixSolvers, FermiOperator, InverseSolvers, SquareRootSolvers,
    SignSolvers, RootSolvers, ExponentialSolvers, TrigonometrySolvers,
    LinearSolvers, EigenBounds, EigenSolvers, GeometryOptimization,
    Analysis, MatrixConversion, Polynomial, ChebyshevPolynomial,
    HermitePolynomial, RealOperation, ComplexOperation, MatrixMapper,
)

__version__ = "0.5.0"
