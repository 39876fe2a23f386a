"""Global configuration for ntpoly_tpu.

The reference library (NTPoly) fixes NTREAL = C double and duplicates all code
for real/complex (Source/Fortran/DataTypesModule.F90:10-22).  Here precision is
a runtime choice: float32/complex64 by default (the GPU path), float64/
complex128 when ``jax_enable_x64`` is active (used by the scipy-oracle test
suite).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Sentinel marking an empty block slot in the block-ELL format.  Chosen so it
# sorts after every real block-column index (dims < 2**30 blocks).
EMPTY = 2**30

# Default block (tile) size: each block product is one bs x bs x bs GEMM of
# a batch, so larger blocks run the products at a higher rate and pad
# more.  Tests on CPU use small blocks (4/8) to exercise the sparse
# machinery on tiny matrices (reference tests use dims 7-31).
DEFAULT_BLOCK_SIZE = 128

# Default row-chunk of the chunked SpGEMM tiers (memory/parallelism
# trade-off: the dense accumulator is chunk * n_block_cols * bs * bs
# elements, the candidate tensor chunk * KA*KB * bs * bs).
DEFAULT_ROW_CHUNK = 8


def x64_enabled() -> bool:
    return bool(jax.config.read("jax_enable_x64"))


def default_real_dtype():
    return jnp.float64 if x64_enabled() else jnp.float32


def default_complex_dtype():
    return jnp.complex128 if x64_enabled() else jnp.complex64


def real_dtype_of(dtype) -> jnp.dtype:
    """The real dtype backing ``dtype`` (itself if already real)."""
    return jnp.finfo(dtype).dtype if jnp.issubdtype(dtype, jnp.floating) \
        else jnp.zeros((), dtype).real.dtype


def is_complex(dtype) -> bool:
    return jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating)


# ----------------------------------------------------------------------------
# complex support policy
# ----------------------------------------------------------------------------
# XLA on the CPU and on the GPU has native complex64/complex128.  The api
# layer routes complex data through the 2x2 real embedding (core/cplx.py)
# only when the backend lacks native complex.  Modes: 'auto' (embed iff
# the backend lacks it), 'always' (tests exercise the embedded path on
# CPU), 'never'.
_embed_mode = "auto"


def set_complex_embedding(mode: str) -> None:
    global _embed_mode
    assert mode in ("auto", "always", "never"), mode
    _embed_mode = mode


def backend_supports_complex(grid=None) -> bool:
    """Native complex arithmetic: XLA's CPU and GPU backends."""
    if grid is not None:
        platform = grid.mesh.devices.flat[0].platform
    else:
        platform = jax.devices()[0].platform
    return platform in ("cpu", "gpu")


def should_embed_complex(grid=None) -> bool:
    if _embed_mode == "always":
        return True
    if _embed_mode == "never":
        return False
    return not backend_supports_complex(grid)
