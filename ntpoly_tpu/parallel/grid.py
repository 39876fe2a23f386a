"""Process grid: a 3-axis JAX device mesh (rows x cols x slices).

JAX replacement for NTPoly's MPI 3D process grid
(reference Source/Fortran/ProcessGridModule.F90:15-56,130-264).  Where the
reference derives row/column/slice communicators by MPI_COMM_SPLIT, here the
grid is a ``jax.sharding.Mesh`` — a plain reshape of ``jax.devices()``,
with no interconnect topology assumed — whose named axes XLA uses to route
collectives (NCCL between GPUs):

    'rows'   — block-row panels of the matrix (reference row_comm)
    'cols'   — block-column panels (reference column_comm)
    'slices' — split-k replicas for 2.5D multiplies (reference
               between_slice_comm); matrix data is replicated across slices.

Grid auto-sizing mirrors ComputeGridSize / ComputeNumSlices
(reference ProcessGridModule.F90:576-638): pick a near-square rows x cols
within each slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax
import numpy as np

from ..utils.errors import GridError
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXES = ("rows", "cols", "slices")


def _near_square(n: int) -> tuple[int, int]:
    r = int(np.sqrt(n))
    while n % r != 0:
        r -= 1
    return max(r, 1), n // max(r, 1)


class ProcessGrid:
    """A rows x cols x slices device grid.

    Constraints follow the reference (ProcessGridModule.F90:162-176):
    rows*cols*slices must equal the device count, and with slices > 1,
    max(rows, cols) must be a multiple of min(rows, cols).
    """

    def __init__(self, rows: int | None = None, cols: int | None = None,
                 slices: int = 1, devices=None):
        if devices is None:
            devices = jax.devices()
            if rows is not None and cols is not None:
                need = rows * cols * slices
                if need <= len(devices):
                    devices = devices[:need]
        n = len(devices)
        if rows is None or cols is None:
            if n % slices != 0:
                raise GridError(
                    f"slices={slices} does not divide device count {n}")
            rows, cols = _near_square(n // slices)
        if rows * cols * slices != n:
            raise GridError(
                f"grid {rows}x{cols}x{slices} != device count {n}")
        if slices > 1 and max(rows, cols) % min(rows, cols) != 0:
            raise GridError(
                "with slices > 1, max(rows, cols) must be a multiple of "
                f"min(rows, cols); got {rows}x{cols}")
        self.rows, self.cols, self.slices = rows, cols, slices
        devs = np.asarray(devices).reshape(rows, cols, slices)
        self.mesh = Mesh(devs, AXES)
        self._sig = (rows, cols, slices,
                     tuple(d.id for d in devs.reshape(-1)))

    # -- pytree-static protocol ------------------------------------------
    def __hash__(self):
        return hash(self._sig)

    def __eq__(self, other):
        return isinstance(other, ProcessGrid) and self._sig == other._sig

    def __repr__(self):
        return f"ProcessGrid({self.rows}x{self.cols}x{self.slices})"

    @property
    def n_devices(self) -> int:
        return self.rows * self.cols * self.slices

    def sharding(self, *spec) -> NamedSharding:
        return NamedSharding(self.mesh, P(*spec))

    @property
    def matrix_sharding(self) -> NamedSharding:
        """Sharding of PSMatrix arrays [Pc(panel), NBR, ...]: panels over
        'cols', block-rows over 'rows', replicated over 'slices'."""
        return self.sharding("cols", "rows")

    def split(self) -> tuple["ProcessGrid", "ProcessGrid", bool]:
        """Halve the grid for task parallelism (reference SplitProcessGrid,
        ProcessGridModule.F90:430-515): slices are split first, then the
        longer of rows/cols.  Returns (first_half, second_half,
        split_slice).  With a single device both halves are the grid itself
        (the reference requires >= 2 ranks; one chip can still run both
        tasks serially)."""
        devs = np.asarray(self.mesh.devices)       # [rows, cols, slices]
        if self.n_devices == 1:
            return self, self, False
        if self.slices > 1:
            h = self.slices // 2
            a, b = devs[:, :, :h], devs[:, :, h:]
        elif self.cols >= self.rows:
            h = self.cols // 2
            a, b = devs[:, :h], devs[:, h:]
        else:
            h = self.rows // 2
            a, b = devs[:h], devs[h:]
        def mk(d):
            return ProcessGrid(d.shape[0], d.shape[1], d.shape[2],
                               devices=list(d.reshape(-1)))
        return mk(a), mk(b), self.slices > 1


# ----------------------------------------------------------------------------
# global default grid (reference keeps `global_grid`,
# ProcessGridModule.F90:59)
# ----------------------------------------------------------------------------
_global_grid: ProcessGrid | None = None


def construct_global_grid(rows: int | None = None, cols: int | None = None,
                          slices: int = 1) -> ProcessGrid:
    global _global_grid
    _global_grid = ProcessGrid(rows, cols, slices)
    return _global_grid


def destruct_global_grid() -> None:
    global _global_grid
    _global_grid = None


def global_grid() -> ProcessGrid:
    global _global_grid
    if _global_grid is None:
        _global_grid = ProcessGrid()
    return _global_grid
