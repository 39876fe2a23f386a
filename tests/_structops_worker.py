"""Worker for the multi-process device-side structural-ops test.

Asserts that resize / block-aligned get_slice / set_grid on a
multi-process mesh stay on device: no host-triplet round trip fires
(the reference does targeted sends / in-place regrid,
PSMatrixModule.F90:309-347,1036-1227).

Usage: python _structops_worker.py <pid> <nproc> <workdir> <devs> <port>
"""
import os
import sys

pid, nproc, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
devs_per_proc = sys.argv[4]
port = sys.argv[5]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = \
    f"--xla_force_host_platform_device_count={devs_per_proc}"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from ntpoly_tpu.parallel import dist  # noqa: E402

dist.initialize(coordinator_address=f"127.0.0.1:{port}",
                num_processes=nproc, process_id=pid)
assert dist.is_multiprocess()

from ntpoly_tpu.parallel import pmatrix as PM  # noqa: E402
from ntpoly_tpu.parallel.grid import ProcessGrid  # noqa: E402

grid = ProcessGrid(2, 2, 1)
dim, bs = 64, 8
rng = np.random.default_rng(5)
dense = rng.random((dim, dim)) * (rng.random((dim, dim)) < 0.3)
i, j = np.nonzero(dense)
base = PM.empty(dim, bs=bs, dtype=np.float64, grid=grid)
m = PM.fill_from_triplets(base, i, j, dense[i, j])

# device-side ops must not fall back to host triplet round-trips
host_calls = []
real_to_triplets = PM.to_triplets
real_fill = PM.fill_from_triplets
PM.to_triplets = lambda *a, **k: (host_calls.append("to_triplets"),
                                  real_to_triplets(*a, **k))[1]
PM.fill_from_triplets = lambda *a, **k: (host_calls.append("fill"),
                                         real_fill(*a, **k))[1]

big = PM.resize(m, 96)
small = PM.resize(m, 40)
sl = PM.get_slice(m, 16, 48, 8, 40)
# UNALIGNED slice (r4 residual CLOSED): intra-block offsets ride the
# static sub-block shift expansion — still no host round trip
slu = PM.get_slice(m, 13, 47, 5, 39)
assert host_calls == [], f"host fallback fired: {host_calls}"

# set_grid MAY fall back (cross-mesh transfer support is runtime
# dependent) but must be correct either way
regrid = PM.set_grid(m, ProcessGrid(4, 1, 1))

PM.to_triplets = real_to_triplets
PM.fill_from_triplets = real_fill

from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def gathered(mat):
    """Replicate-and-read: multi-process global arrays span
    non-addressable devices, so verification replicates first."""
    rep = jax.jit(lambda a: a,
                  out_shardings=NamedSharding(mat.grid.mesh, P()))(
        PM.to_dense(mat))
    return np.asarray(rep.addressable_shards[0].data)


db = gathered(big)
ds = gathered(small)
dsl = gathered(sl)
dslu = gathered(slu)
dg = gathered(regrid)
ref_big = np.zeros((96, 96))
ref_big[:dim, :dim] = dense
assert np.abs(db - ref_big).max() < 1e-14, "resize-grow wrong"
assert np.abs(ds - dense[:40, :40]).max() < 1e-14, "resize-crop wrong"
assert np.abs(dsl - dense[16:48, 8:40]).max() < 1e-14, "slice wrong"
assert np.abs(dslu - dense[13:47, 5:39]).max() < 1e-14, \
    "unaligned slice wrong"
assert np.abs(dg - dense).max() < 1e-14, "set_grid wrong"

print(f"STRUCTOPS_OK {pid}", flush=True)
