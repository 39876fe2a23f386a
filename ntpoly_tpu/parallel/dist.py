"""Multi-process (multi-host) runtime support.

The reference scales across hosts with MPI: alltoallv triplet
redistribution on fill (reference distributed_includes/
FillMatrixFromTripletList.f90:25-46) and MPI-IO byte ranges on read
(reference PSMatrixModule.F90:351-570).  The JAX equivalents here:

  * :func:`initialize` — `jax.distributed` bootstrap (one controller per
    host; devices of all hosts form one global mesh).
  * triplet exchange — padded `process_allgather` over the host network
    (every host ends with the union; the 'prepartitioned' fill mode skips
    the exchange entirely when each host already owns its panel's data,
    which is the scalable path, matching the reference's prepartitioned
    flag FillMatrixFromTripletList.f90:14-24).
  * :func:`shard_global` — build a sharded device array where each process
    materializes only its addressable shards
    (`jax.make_array_from_callback`).
"""
from __future__ import annotations

import os

import jax
import numpy as np

__all__ = ["initialize", "process_count", "process_index",
           "is_multiprocess", "shard_global", "allgather_triplets",
           "exchange_triplets", "host_value"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bootstrap the multi-process runtime.  Pass all three arguments
    where no cluster environment describes the job (a plain GPU host):
    ``coordinator_address='localhost:<port>'``, ``num_processes`` and
    ``process_id``."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def shard_global(np_array: np.ndarray, sharding) -> jax.Array:
    """Place a (host-side) array under ``sharding``.

    Single-process: plain device_put.  Multi-process: each process
    materializes only its addressable shards via make_array_from_callback —
    the per-host array needs to be correct only in this host's regions."""
    if not is_multiprocess():
        return jax.device_put(np_array, sharding)
    return jax.make_array_from_callback(
        np_array.shape, sharding, lambda idx: np_array[idx])


def allgather_triplets(rows, cols, vals):
    """Union of every process's (rows, cols, vals) triplet arrays.

    The host-network exchange behind the 'distributed' fill mode: ragged
    per-process counts are padded to the max and gathered.  O(total nnz)
    per host — use the 'prepartitioned' fill mode for the O(nnz/P) path.
    """
    if not is_multiprocess():
        return rows, cols, vals
    from jax.experimental import multihost_utils as mhu

    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    counts = np.asarray(mhu.process_allgather(
        np.asarray([len(rows)], np.int64))).reshape(-1)
    maxn = int(counts.max())
    pad = maxn - len(rows)
    packed = np.zeros((maxn, 2), np.int64)
    packed[:len(rows), 0] = rows
    packed[:len(rows), 1] = cols
    vpad = np.pad(vals, (0, pad))
    gi = np.asarray(mhu.process_allgather(packed))      # [P, maxn, 2]
    gv = np.asarray(mhu.process_allgather(vpad))        # [P, maxn]
    keep = np.arange(maxn)[None, :] < counts[:, None]
    return (gi[..., 0][keep], gi[..., 1][keep], gv[keep])


_exchange_calls = iter(range(1 << 62))     # lockstep collective counter

# Each (src, dst) bucket is split into KV entries of at most this many
# bytes: a single monolithic set/get of a ~400 MB bucket (25.7M triplets
# at the repo's own bench scale) can exceed gRPC message limits and
# concentrates every payload in the coordinator's memory at once —
# bounded chunks keep any single KV operation small.
# Env-overridable so tests can force the multi-chunk path with tiny
# payloads; must agree across processes.
def _kv_chunk_bytes() -> int:
    return int(os.environ.get("NTX_KV_CHUNK_BYTES", 64 * 1024 * 1024))


def _kv_client():
    """The jax.distributed coordination-service KV client, or None.

    The client lives under a private module path (``jax._src.distributed``)
    that can move on any JAX upgrade, and the load-bearing multi-process
    fill rides it — so every access goes through this version-guarded
    probe and callers fall back to the public device ``all_to_all`` path
    when it returns None (the robustness role of the reference's
    NOIALLGATHER fallback build, reference MatrixReduceModule.F90:28-38).
    Probe order: current private path, then the documented public client
    accessor if one appears in a future JAX.
    """
    try:                                   # JAX <= 0.8 private path
        from jax._src import distributed
        client = distributed.global_state.client
    except Exception:
        client = None
    if client is None:
        return None
    # the exchange needs exactly these three methods; a client missing
    # any of them (API drift) routes to the fallback instead of failing
    # mid-collective
    for methname in ("key_value_set_bytes", "blocking_key_value_get_bytes",
                     "key_value_delete"):
        if not hasattr(client, methname):
            return None
    return client


def _exchange_kv(rows, cols, vals, dest, nproc: int, client):
    """Exact-sized alltoallv over the jax.distributed key-value store:
    every (src, dst) bucket travels as its own byte payload (split into
    <= _KV_CHUNK_BYTES entries), so each host's traffic is exactly
    sent + received bytes — the semantics of the reference's
    MPI_Alltoallv with per-pair counts (reference
    triplet_includes/RedistributeTripletLists.f90:32-35), with none of
    the O(P x max_bucket) padding a uniform-chunk device all_to_all
    pays under skewed ownership."""
    from jax.experimental import multihost_utils as mhu
    me = process_index()
    gen = next(_exchange_calls)            # identical on every process
    dt = np.dtype([("row", "<i4"), ("col", "<i4"),
                   ("val", vals.dtype.str)])
    order = np.argsort(dest, kind="stable")
    sr, sc, sv, sd = rows[order], cols[order], vals[order], dest[order]
    counts = np.bincount(sd, minlength=nproc)
    offs = np.zeros(nproc + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    recs = np.empty(len(sr), dt)
    recs["row"], recs["col"], recs["val"] = sr, sc, sv

    def key(s, d, c):
        return f"ntx/exchange/{gen}/{s}to{d}/{c}"

    nchunk_recs = max(1, _kv_chunk_bytes() // dt.itemsize)
    sent = []
    for d in range(nproc):
        if d == me:
            continue
        bucket = recs[offs[d]:offs[d + 1]]
        nchunks = max(1, -(-len(bucket) // nchunk_recs))
        # chunk count rides a tiny header entry so the receiver never
        # guesses; 1-byte prefix keeps empty chunks representable
        client.key_value_set_bytes(key(me, d, "n"),
                                   str(nchunks).encode())
        for c in range(nchunks):
            payload = bucket[c * nchunk_recs:(c + 1) * nchunk_recs]
            client.key_value_set_bytes(key(me, d, c),
                                       b"\x01" + payload.tobytes())
            sent.append(key(me, d, c))
        sent.append(key(me, d, "n"))
    parts = [recs[offs[me]:offs[me + 1]]]
    for s in range(nproc):
        if s == me:
            continue
        nchunks = int(client.blocking_key_value_get_bytes(
            key(s, me, "n"), 600_000).decode())
        for c in range(nchunks):
            data = client.blocking_key_value_get_bytes(
                key(s, me, c), 600_000)
            parts.append(np.frombuffer(data[1:], dt))
    # everyone has read before senders delete their keys
    mhu.sync_global_devices(f"ntx_exchange_{gen}")
    for k in sent:
        client.key_value_delete(k)
    out = np.concatenate(parts) if parts else np.empty(0, dt)
    return (out["row"].astype(np.int64), out["col"].astype(np.int64),
            out["val"].astype(vals.dtype))


def exchange_triplets(rows, cols, vals, dest):
    """Route each (i, j, v) triplet to the process ``dest`` — the
    alltoallv of the reference fill (reference distributed_includes/
    FillMatrixFromTripletList.f90:25-46).  The default transport is the
    exact-sized key-value-store exchange (:func:`_exchange_kv`); when the
    distributed client is unavailable, per-destination buckets ride a
    device ``lax.all_to_all`` over a one-device-per-process mesh (uniform
    chunks: each host pays O(nproc * max bucket) padding there).

    Returns this process's received (rows, cols, vals).
    """
    if not is_multiprocess():
        return rows, cols, vals
    import jax.numpy as jnp
    from jax import lax
    from jax.experimental import multihost_utils as mhu
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    nproc = jax.process_count()
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    dest = np.asarray(dest, np.int64)
    iscomplex = np.iscomplexobj(vals)
    # indices ride int32 (exact to 2^31 rows — a float payload would
    # silently round above 2^24 when jax x64 is off); values ride their
    # native real dtype.  int32 wraps silently in numpy, so the bound is
    # enforced, not assumed.
    if len(rows) and max(int(rows.max()), int(cols.max())) >= 2 ** 31:
        from ..utils.errors import MatrixDimensionError
        raise MatrixDimensionError(
            "exchange_triplets: coordinates >= 2^31 would wrap in the "
            "int32 exchange payload; matrices beyond 2^31 rows are not "
            "supported")
    client = _kv_client()
    if client is not None:
        return _exchange_kv(rows, cols, vals, dest, nproc, client)
    rdt = vals.real.dtype

    counts = np.bincount(dest, minlength=nproc)
    # bucket capacity must agree globally (lax.all_to_all needs uniform
    # chunks, so every (src, dst) pair pads to the global max — each host
    # pays O(nproc * max bucket), the price of a collective exchange
    # without point-to-point messaging)
    maxn = int(np.max(mhu.process_allgather(
        np.asarray([counts.max() if counts.size else 0], np.int64))))
    if maxn == 0:
        return rows[:0], cols[:0], vals[:0]
    order = np.argsort(dest, kind="stable")
    offs = np.zeros(nproc + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    vw = 2 if iscomplex else 1
    idx = np.full((nproc, maxn, 3), -1, np.int32)   # row, col, valid
    val = np.zeros((nproc, maxn, vw), rdt)
    sr, sc, sv = rows[order], cols[order], vals[order]
    for p in range(nproc):
        lo, hi = offs[p], offs[p + 1]
        n = hi - lo
        idx[p, :n, 0] = sr[lo:hi]
        idx[p, :n, 1] = sc[lo:hi]
        idx[p, :n, 2] = 1
        val[p, :n, 0] = sv[lo:hi].real
        if iscomplex:
            val[p, :n, 1] = sv[lo:hi].imag

    # one device per process, exchange over a 1-axis mesh
    per_proc = {}
    for d in jax.devices():
        per_proc.setdefault(d.process_index, d)
    devs = [per_proc[p] for p in range(nproc)]
    mesh = Mesh(np.asarray(devs), ("p",))
    sh = NamedSharding(mesh, P("p"))

    def place(arr):
        # global [nproc*nproc, ...]; this process's shard is its buckets
        return jax.make_array_from_callback(
            (nproc * nproc,) + arr.shape[1:], sh, lambda _: arr)

    def swap(x):                                  # x: [nproc, maxn, w]
        return lax.all_to_all(x, "p", split_axis=0, concat_axis=0)

    fn = jax.jit(jax.shard_map(swap, mesh=mesh, in_specs=P("p"),
                               out_specs=P("p")))
    gi = np.asarray(fn(place(idx)).addressable_shards[0].data
                    ).reshape(-1, 3)
    gv = np.asarray(fn(place(val)).addressable_shards[0].data
                    ).reshape(-1, vw)
    keep = gi[:, 2] == 1
    r = gi[keep, 0].astype(np.int64)
    c = gi[keep, 1].astype(np.int64)
    if iscomplex:
        v = (gv[keep, 0] + 1j * gv[keep, 1]).astype(vals.dtype)
    else:
        v = gv[keep, 0].astype(vals.dtype)
    return r, c, v


def host_value(x) -> np.ndarray:
    """Read a fully-replicated global array back to the host (works in
    single- and multi-process runs)."""
    return np.asarray(x)
