"""Shared skeleton of every iterative solver.

The reference repeats this pattern in all ~25 solver modules (see e.g.
reference Source/Fortran/DensityMatrixSolversModule.F90:285-481): resolve
params -> construct monitor -> verbose YAML header with citations ->
similarity-transform into the orthogonal basis -> optional load-balance
permutation -> iterate with monitor -> undo permutation -> transform back.
Here it is factored once.
"""
from __future__ import annotations

from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from ..utils.logging import logger, sub_log
from ..utils.permutation import permute_matrix, undo_permute_matrix
from .parameters import SolverParameters, Monitor


def resolve(params: SolverParameters | None
            ) -> tuple[SolverParameters, Monitor]:
    params = params.copy() if params is not None else SolverParameters()
    return params, params.monitor()


class solver_log:
    """Verbose YAML block: header, method, citations, parameters."""

    def __init__(self, params, header: str, method: str | None = None,
                 citations: tuple[str, ...] = (), extra: dict | None = None):
        self.params, self.header = params, header
        self.method, self.citations = method, citations
        self.extra = extra or {}
        self._policy = None

    def __enter__(self):
        if self.params.be_verbose:
            logger.write_header(self.header)
            logger.enter_sub_log()
            if self.method:
                logger.write_element("Method", self.method)
            for key, val in self.extra.items():
                logger.write_element(key, val)
            if self.citations:
                with sub_log("Citations"):
                    for c in self.citations:
                        logger.write_list_element(c)
            self.params.print()
        # Pin the block capacity for the whole solve when the user set
        # params.k_out: iteration shapes stay static, so XLA compiles each
        # op once instead of once per fill-in level.  Eager (outside-scan)
        # ops still GROW on measured overflow — never silently drop
        # (reference GemmMatrix.f90:48-56) — except under
        # params.on_overflow='warn', where eager ops stay at the pinned
        # capacity and every overflow check is DEFERRED to one
        # end-of-solve sync (a per-op readback would stall the eager
        # dispatch pipeline).  The chunked driver installs its
        # own truncate-with-detection policy inside the scan.
        eager_mode = {"ignore": "truncate", "warn": "warn"}.get(
            self.params.on_overflow, "grow")
        self._policy = alg.capacity_policy(
            k_out=self.params.k_out, row_chunk=self.params.row_chunk,
            on_overflow=eager_mode,
            precision=self.params.precision,
            method=self.params.matmul_method, defer=True)
        self._policy.__enter__()
        return self

    def __exit__(self, *exc):
        if self._policy is not None:
            self._policy.__exit__(*exc)
            self._policy = None
        if self.params.be_verbose:
            logger.exit_sub_log()
        return False


class iteration_log:
    def __init__(self, params):
        self.params = params

    def __enter__(self):
        if self.params.be_verbose:
            logger.write_header("Iterations")
            logger.enter_sub_log()
        return self

    def step(self, **kv):
        """One per-iteration list item: the first key starts the item, the
        rest (and any Convergence entry the monitor writes next) nest."""
        if self.params.be_verbose:
            items = list(kv.items())
            logger.write_list_element(key=items[0][0], value=items[0][1])
            with sub_log():
                for key, val in items[1:]:
                    logger.write_element(key, val)

    def __exit__(self, *exc):
        if self.params.be_verbose:
            logger.exit_sub_log()
        return False


def finish_iterations(params, total_iterations, mat=None, monitor=None,
                      solver: str = "Solver"):
    """Log totals; with params.raise_on_nonconvergence, raise
    ConvergenceError when the monitor never fired (reference logs totals
    only, ConvergenceMonitorModule.F90:122-191 leaves detection to the
    caller)."""
    if params.be_verbose:
        logger.write_element("Total Iterations", total_iterations)
        if mat is not None:
            print_matrix_information(mat)
    # the monitor never fired => the loop exhausted max_iterations
    # (solver conventions differ on 0/1-based totals, so don't compare)
    if (monitor is not None and params.raise_on_nonconvergence
            and not monitor.converged):
        from ..utils.errors import ConvergenceError
        raise ConvergenceError(solver, total_iterations,
                               monitor.win_short[-1])


def print_matrix_information(mat):
    """reference PSMatrixModule.F90:1248-1270."""
    with sub_log("Matrix Information"):
        logger.write_element("Dimension", mat.dim)
        nnz = mat.nnz
        logger.write_element("Nonzeros", nnz)
        logger.write_element("Sparsity", nnz / float(mat.dim) ** 2)


def known_identity(m) -> bool:
    """True when m is the identity — the construction-time tag
    (PM.identity marks its result) makes this free; otherwise one fused
    device check + readback (alg.is_identity); solvers check
    identity-ness twice per solve (orthogonalize + similarity
    short-circuits)."""
    if getattr(m, "_known_identity", False):
        return True
    return m.k <= 1 and alg.is_identity(m)


def prologue_scalars(wh):
    """(e_min, e_max, trace) of the working Hamiltonian in ONE dispatch
    and ONE readback, instead of one per quantity (Gershgorin bounds,
    then trace for the PM/HPCP centering)."""
    import numpy as _np
    v = _np.asarray(_prologue_scalars_jit(wh))
    return float(v[0]), float(v[1]), float(v[2])


import jax as _jax  # noqa: E402  (jit for the prologue fusion)
import jax.numpy as _jnp  # noqa: E402


@_jax.jit
def _prologue_scalars_jit(wh):
    lo, hi = alg.gershgorin_bounds(wh)
    tr = _jnp.real(alg.trace(wh))
    return _jnp.stack([_jnp.real(lo), _jnp.real(hi), tr])


def orthogonalize(h, isq, params):
    """WH = ISQ @ H @ ISQ^H (reference solvers' working-Hamiltonian step).

    The reference uses a plain transpose (e.g.
    DensityMatrixSolversModule.F90:355-357) but only ever pairs complex
    Hamiltonians with *real* overlaps (UnitTests/test_chemistry.py:32); the
    conjugate transpose is the Hermitian-correct generalization and is
    identical for real ISQ.

    Identity ISQ short-circuits BEFORE the transpose (similarity_transform
    has its own short-circuit, but the transpose it would feed still
    costs a full rebuild — a 0.5 GB flatten at 2^20 rows for a matrix
    equal to its own transpose).
    """
    if known_identity(isq):
        # the reference's identity path copies without filtering
        # (SimilarityTransform, PSMatrixAlgebraModule.F90:603-654);
        # aliasing instead of copying saves a full matrix (1.5 GB at
        # the 2^20-row bench shape) — all containers are immutable
        return h, isq
    isqt = alg.transpose(isq).conjugate()
    wh = alg.similarity_transform(h, isq, isqt, threshold=params.threshold)
    return wh, isqt


def deorthogonalize(x, isq, isqt, params):
    """K = ISQ^T @ X @ ISQ.  When orthogonalize short-circuited on an
    identity ISQ it returned isqt IS isq — reuse that decision instead
    of paying another eager identity check."""
    if isqt is isq:
        return x
    return alg.similarity_transform(x, isqt, isq, threshold=params.threshold)


def maybe_permute(params, *mats):
    if params.do_load_balancing and params.balance_permutation is not None:
        return tuple(permute_matrix(m, params.balance_permutation,
                                    params.threshold) for m in mats)
    return mats if len(mats) > 1 else mats


def maybe_unpermute(params, mat):
    if params.do_load_balancing and params.balance_permutation is not None:
        return undo_permute_matrix(mat, params.balance_permutation,
                                   params.threshold)
    return mat


def identity_like(mat) -> PM.PSMatrix:
    """Identity at capacity 1 — every op handles mixed slot counts, and
    matching ``mat.k`` would just store (k-1) zero slots per row
    (1 GB of zeros at the 2^20-row bench shape)."""
    return PM.identity(mat.dim, bs=mat.bs, dtype=mat.dtype,
                       grid=mat.grid)


def real_scalar(x) -> float:
    x = complex(x)
    return float(x.real)


# ----------------------------------------------------------------------------
# chunked (scan-fused) iteration machinery — dispatch amortization
# ----------------------------------------------------------------------------

def select_matrix(pred, a: PM.PSMatrix, b: PM.PSMatrix) -> PM.PSMatrix:
    """Whole-matrix select on a traced scalar predicate (both operands must
    share shapes — i.e. run under a pinned capacity)."""
    import jax.numpy as jnp
    return a.with_data(jnp.where(pred, a.col_ids, b.col_ids),
                       jnp.where(pred, a.blocks, b.blocks))


def pad_capacity(m: PM.PSMatrix, k: int) -> PM.PSMatrix:
    """Widen (or keep) the slot capacity to exactly k."""
    import jax.numpy as jnp
    from ..config import EMPTY
    if m.k == k:
        return m
    assert m.k < k, "pad_capacity cannot shrink"
    pads = k - m.k
    cc = jnp.pad(m.col_ids, ((0, 0), (0, 0), (0, pads)),
                 constant_values=EMPTY)
    cb = jnp.pad(m.blocks, ((0, 0), (0, 0), (0, pads), (0, 0), (0, 0)))
    return m.with_data(cc, cb)


# chunk-program cache across solves: a fresh jit closure per solve would
# otherwise re-trace and recompile an identical program on every warmed
# solve.  Keyed by the solver-declared identity
# (algorithm name + every closed-over scalar) plus everything else that
# shapes the traced graph; bounded FIFO.
_CHUNK_FN_CACHE: dict = {}
_CHUNK_FN_CACHE_MAX = 32


def run_chunked(step_fn, carry0, consts, params, monitor, ilog, *,
                k_pin: int, aux_names=("Energy Value",), conv_index=0,
                conv_mode: str = "diff", cache_key=None,
                row_transform=None):
    """Drive step_fn with params.iters_per_sync iterations fused into one
    compiled lax.scan per host sync (the answer to the reference's
    per-iteration MPI_Allreduce convergence checks: dispatch and readback
    latency is paid once per chunk, not per iteration).

    step_fn(carry, *consts) -> (carry_new, (scalar, ...)) — fully traced,
    static shapes (matrices in the carry must be pre-padded to the pinned
    capacity ``k_pin``).  conv_mode 'diff' feeds the monitor successive
    differences of scalar[conv_index]; 'value' feeds it directly.
    ``row_transform`` (optional) maps each raw per-iteration tuple of
    host floats to the processed row BEFORE history/monitor/logging —
    e.g. combining a compensated (hi, lo) energy pair into one float64.
    Returns (carry, scalars_history list-of-tuples, total_iters).

    Overflow honesty: every capacity-bounded op
    inside the scan reports its exact structural fill through the policy
    collector; the max rides the scan carry and is read back in the SAME
    host sync.  If it exceeds the pinned capacity, params.on_overflow
    picks the response: 'grow' (default — re-pad the carry to the needed
    capacity and recompile, the reference's never-drop pool growth,
    GemmMatrix.f90:48-56), 'warn', 'raise', or 'ignore'.
    """
    import functools
    import warnings

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    import ntpoly_tpu.parallel.algebra as alg
    from ..parallel import pmatrix as _PM
    from ..utils.errors import NTPolyError

    chunk = max(1, params.iters_per_sync)
    cap = jax.tree_util.tree_leaves(
        carry0, is_leaf=lambda x: isinstance(x, _PM.PSMatrix))
    cap = next((m.panel_nb for m in cap if isinstance(m, _PM.PSMatrix)),
               k_pin)

    def make_chunk_fn(k_now, donate=False):
        # Donate the carry (the iterate X and friends): XLA reuses its
        # buffers for the chunk's outputs — at the 2^20-row bench shape
        # that is ~2.5 GB of HBM handed back per matrix.  Donation is
        # only legal when this chunk can never be REDONE with the same
        # carry (no capacity regrow possible) AND the carry holds no
        # aliased leaves (e.g. CG starts with p = r, the same buffer —
        # donating it twice is a runtime error).

        @functools.partial(jax.jit, donate_argnums=(0,) if donate else ())
        def chunk_fn(carry, *cs):
            def body(c, _):
                uc, ovf = c
                coll = []
                with alg.capacity_policy(k_out=k_now,
                                         on_overflow="truncate",
                                         row_chunk=params.row_chunk,
                                         collect=coll,
                                         precision=params.precision,
                                         method=params.matmul_method):
                    uc2, scal = step_fn(uc, *cs)
                for f in coll:
                    ovf = jnp.maximum(ovf, jnp.asarray(f, jnp.int32))
                return (uc2, ovf), scal
            (carry, ovf), scal = lax.scan(
                body, (carry, jnp.int32(0)), None, length=chunk)
            return carry, ovf, scal
        return chunk_fn

    def repad(tree, k_new):
        return jax.tree_util.tree_map(
            lambda x: pad_capacity(x, k_new)
            if isinstance(x, _PM.PSMatrix) else x,
            tree, is_leaf=lambda x: isinstance(x, _PM.PSMatrix))

    mode = getattr(params, "on_overflow", "grow")

    def _unique_leaves(tree):
        seen = set()
        for leaf in jax.tree_util.tree_leaves(tree):
            if id(leaf) in seen:
                return False
            seen.add(id(leaf))
        return True

    chunk_fns = {}
    calls = [0]

    def get_chunk_fn(carry):
        # Never donate the FIRST chunk's carry: solvers may seed it with
        # caller-owned matrices (e.g. NS order 2 starts from the input
        # matrix itself, and pad_capacity returns the same object when
        # no padding is needed) — donating those deletes the user's
        # buffers.  Later carries are chunk outputs, owned here.
        donate = (calls[0] > 0
                  and (mode != "grow" or k_pin >= cap)
                  and _unique_leaves(carry))
        calls[0] += 1
        key = (k_pin, donate)
        if cache_key is not None:
            avals = tuple(
                (leaf.shape, str(leaf.dtype))
                for leaf in jax.tree_util.tree_leaves((carry0, consts)))
            gkey = (cache_key, key, chunk, avals, params.row_chunk,
                    params.precision, params.matmul_method, mode)
            if gkey not in _CHUNK_FN_CACHE:
                while len(_CHUNK_FN_CACHE) >= _CHUNK_FN_CACHE_MAX:
                    _CHUNK_FN_CACHE.pop(next(iter(_CHUNK_FN_CACHE)))
                _CHUNK_FN_CACHE[gkey] = make_chunk_fn(k_pin, donate)
            return _CHUNK_FN_CACHE[gkey]
        if key not in chunk_fns:
            chunk_fns[key] = make_chunk_fn(k_pin, donate)
        return chunk_fns[key]

    history = []
    prev = None
    total = 0
    while total < params.max_iterations:
        new_carry, ovf, scal = get_chunk_fn(carry0)(carry0, *consts)
        scal = [np.asarray(s) for s in scal]      # ONE sync per chunk
        need = int(ovf)                           # same sync (ovf is ready)
        if need > k_pin and mode != "ignore":
            msg = (f"chunked solve: structural fill {need} exceeds pinned "
                   f"capacity {k_pin} — results truncated this chunk")
            if mode == "raise":
                raise NTPolyError(msg)
            if mode == "grow" and k_pin < cap:
                # recompile at the needed capacity and REDO this chunk
                # (only the carry is padded — every bell op handles
                # mixed slot counts, so padding the constant operands
                # would just multiply their footprint)
                k_pin = min(alg._k_bucket(need, cap), cap)
                carry0 = repad(carry0, k_pin)
                if params.be_verbose:
                    from ..utils.logging import logger
                    logger.write_comment(
                        f"capacity regrown to {k_pin} (fill {need})")
                continue
            warnings.warn(msg)
            if ilog is not None and params.be_verbose:
                from ..utils.logging import logger
                logger.write_comment(msg)
        carry0 = new_carry
        converged = False
        for it in range(chunk):
            row = tuple(float(s[it]) for s in scal)
            if row_transform is not None:
                row = row_transform(row)
            history.append(row)
            total += 1
            if conv_mode == "diff":
                val = row[conv_index] if prev is None \
                    else row[conv_index] - prev
                prev = row[conv_index]
            else:
                val = row[conv_index]
            monitor.append(val)
            if ilog is not None:
                ilog.step(**{name: row[i]
                             for i, name in enumerate(aux_names)})
            if monitor.check_converged(params.be_verbose):
                converged = True
                break
        if converged:
            break
    return carry0, history, total
