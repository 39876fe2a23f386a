"""Native host runtime (C++ via ctypes).

The reference's runtime outside the math kernels is compiled
Fortran/C++ (MPI-IO text parsing, triplet marshaling — reference
Source/Fortran/PSMatrixModule.F90:351-570, Source/Wrapper/*).  The
analogue here keeps JAX/XLA on the compute path and uses a
small C++ shared library for the host-side hot loops: multithreaded
MatrixMarket parse/format.  Built on demand with g++ (see build.py);
every entry point has a pure-numpy fallback so the package works without
a toolchain.
"""
from __future__ import annotations

import ctypes
import numpy as np

from .build import load_library

# field codes — must match mmio.cpp
FIELD_REAL, FIELD_COMPLEX, FIELD_PATTERN, FIELD_INTEGER = 0, 1, 2, 3

_lib = load_library()

if _lib is not None:
    _lib.ntx_mm_count.restype = ctypes.c_int64
    _lib.ntx_mm_count.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    _lib.ntx_mm_parse.restype = ctypes.c_int64
    _lib.ntx_mm_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    _lib.ntx_mm_format.restype = ctypes.c_int64
    _lib.ntx_mm_format.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
    _lib.ntx_fill_sort.restype = ctypes.c_int64
    _lib.ntx_fill_sort.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    _lib.ntx_fill_build.restype = ctypes.c_int64
    _lib.ntx_fill_build.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def available() -> bool:
    return _lib is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def mm_parse_body(body: bytes, field: int):
    """Parse an MM body (everything after the header line, size line first).

    Returns (rows, cols, vals) 0-based with the size line as entry 0
    stripped by the caller's contract here: we strip it and return
    (size_row, size_col, rows, cols, vals).
    """
    if _lib is None:
        raise RuntimeError("native library unavailable")
    n = _lib.ntx_mm_count(body, len(body))
    ri = np.empty(n, np.int64)
    ci = np.empty(n, np.int64)
    vre = np.empty(n, np.float64)
    vim = np.empty(n, np.float64) if field == FIELD_COMPLEX else None
    got = _lib.ntx_mm_parse(body, len(body), field, _ptr(ri), _ptr(ci),
                            _ptr(vre), _ptr(vim) if vim is not None else None)
    if got != n:
        raise RuntimeError(f"mm parse mismatch: counted {n}, parsed {got}")
    if n < 1:
        raise ValueError("MatrixMarket body missing size line")
    # entry 0 is the size line (parse_int applied -1; undo it).
    n_rows, n_cols = int(ri[0] + 1), int(ci[0] + 1)
    vals = vre[1:] + 1j * vim[1:] if field == FIELD_COMPLEX else vre[1:]
    return n_rows, n_cols, ri[1:], ci[1:], vals


def mm_parse_range(body: bytes, field: int):
    """Parse a byte range of MM data lines (no header/size line in the
    buffer) -> (rows, cols, vals) 0-based.  The multi-host per-rank read
    path (reference MPI_File_read_at_all + per-line parse,
    PSMatrixModule.F90:453-550)."""
    if _lib is None:
        raise RuntimeError("native library unavailable")
    n = _lib.ntx_mm_count(body, len(body))
    ri = np.empty(n, np.int64)
    ci = np.empty(n, np.int64)
    vre = np.empty(n, np.float64)
    vim = np.empty(n, np.float64) if field == FIELD_COMPLEX else None
    got = _lib.ntx_mm_parse(body, len(body), field, _ptr(ri), _ptr(ci),
                            _ptr(vre), _ptr(vim) if vim is not None else None)
    if got != n:
        raise RuntimeError(f"mm parse mismatch: counted {n}, parsed {got}")
    vals = vre + 1j * vim if field == FIELD_COMPLEX else vre
    if field == FIELD_PATTERN:
        vals = np.ones(n)
    return ri, ci, vals


def fill_blocks(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                bs: int, nb: int, pnb: int):
    """Triplets -> sorted unique-block arrays (sp, sr, slot, sc, blocks, k)
    for ``pmatrix._build_sharded`` — the threaded replacement of the
    numpy add.at/unique/lexsort chain (the host leg of the r3 fill wall:
    ~51 s -> seconds at 25.7M triplets).  Real f32/f64 only.

    Requires nb < 2^21: blockfill.cpp packs its sort key as
    ((bj/pnb)*nb + bi)*nb + bj, which overflows int64 beyond that —
    enforced here, callers fall back to the numpy path."""
    if _lib is None:
        raise RuntimeError("native library unavailable")
    if nb >= (1 << 21):
        raise ValueError(
            f"native fill_blocks: nb={nb} >= 2^21 would overflow the "
            "packed int64 sort key; use the numpy fill path")
    n = len(rows)
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals)
    dt = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}[vals.dtype]
    order = np.empty(n, np.int64)
    keys = np.empty(n, np.int64)
    nub = _lib.ntx_fill_sort(_ptr(rows), _ptr(cols), n, bs, nb, pnb,
                             _ptr(order), _ptr(keys))
    sp = np.empty(nub, np.int64)
    sr = np.empty(nub, np.int64)
    slot = np.empty(nub, np.int64)
    sc = np.empty(nub, np.int64)
    blocks = np.empty((nub, bs, bs), vals.dtype)
    k = _lib.ntx_fill_build(_ptr(rows), _ptr(cols), _ptr(vals), dt, n,
                            _ptr(order), _ptr(keys), bs, nb, pnb,
                            _ptr(sp), _ptr(sr), _ptr(slot), _ptr(sc),
                            _ptr(blocks))
    return sp, sr, slot, sc, blocks, int(k)


def mm_format(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> bytes:
    """Format 0-based triplets as 1-based MM coordinate lines."""
    if _lib is None:
        raise RuntimeError("native library unavailable")
    n = len(rows)
    ri = np.ascontiguousarray(rows, np.int64)
    ci = np.ascontiguousarray(cols, np.int64)
    if np.iscomplexobj(vals):
        field = FIELD_COMPLEX
        vre = np.ascontiguousarray(vals.real, np.float64)
        vim = np.ascontiguousarray(vals.imag, np.float64)
        vim_p = _ptr(vim)
    else:
        field = FIELD_REAL
        vre = np.ascontiguousarray(vals, np.float64)
        vim_p = None
    size = _lib.ntx_mm_format(_ptr(ri), _ptr(ci), _ptr(vre), vim_p, n, field,
                              None, 0)
    buf = ctypes.create_string_buffer(int(size))
    got = _lib.ntx_mm_format(_ptr(ri), _ptr(ci), _ptr(vre), vim_p, n, field,
                             buf, size)
    if got != size:
        raise RuntimeError("mm format size mismatch")
    return buf.raw[:size]
