"""Worker for the multi-process (multi-host emulation) test.

Each OS process drives 4 CPU devices; together they form one 8-device
global mesh.  The worker reads its byte range of a premade MM file,
fills distributedly, runs TRS4 to convergence, and prints the energy —
the parent asserts agreement with the single-process result.

Usage: python _multihost_worker.py <pid> <nproc> <workdir>
"""
import os
import sys

pid, nproc, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
devs_per_proc = sys.argv[4] if len(sys.argv) > 4 else "4"
grid_shape = tuple(int(x) for x in (sys.argv[5] if len(sys.argv) > 5
                                    else "2,2,2").split(","))
mode = sys.argv[6] if len(sys.argv) > 6 else "distributed"
port = sys.argv[7] if len(sys.argv) > 7 else "29517"
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

from ntpoly_tpu.io import matrix_market as mm  # noqa: E402
from ntpoly_tpu.parallel import pmatrix as PM  # noqa: E402
from ntpoly_tpu.parallel.grid import ProcessGrid  # noqa: E402
from ntpoly_tpu.solvers import density  # noqa: E402
from ntpoly_tpu.solvers.parameters import SolverParameters  # noqa: E402

grid = ProcessGrid(*grid_shape)       # all global devices
if mode == "stress":
    # a multi-process case big enough that capacity
    # regrow fires across a chunk boundary (k_out pinned below the
    # purification fill-in) and the exact-sized KV exchange carries a
    # six-figure triplet count.  Rank 0 logs the YAML trace; the parent
    # greps it for the regrow marker.
    from ntpoly_tpu.utils import logging as ntlog
    if pid == 0:
        ntlog.activate_logger(os.path.join(workdir, "stress_log.yaml"))
    h = mm.read(os.path.join(workdir, "h.mtx"), bs=32, grid=grid)
    isq = PM.identity(h.dim, bs=32, dtype=h.dtype, grid=grid)
    params = SolverParameters(converge_diff=1e-8, threshold=1e-9,
                              iters_per_sync=4, k_out=2, be_verbose=True)
    rho, energy, mu = density.trs4(h, isq, float(h.dim // 2), params)
    if pid == 0:
        ntlog.deactivate_logger()
    mm.write(rho, os.path.join(workdir, "rho_mh.mtx"))
    print(f"MHENERGY {pid} {float(energy):.12f} {float(mu):.8f}",
          flush=True)
    sys.exit(0)
if mode == "prepartitioned":
    # the O(nnz/P) scalable path end-to-end: every process reads the WHOLE
    # small file but keeps only the triplets its own shards store
    i, j, v, dim = mm.read_triplets(os.path.join(workdir, "h.mtx"))
    base = PM.empty(dim, bs=16, dtype=np.float64, grid=grid)
    bs, pnb = base.bs, base.panel_nb
    owners = PM._shard_owners(base)
    rows_per = PM._rows_per(base)
    me = dist.process_index()
    keep = np.zeros(len(i), bool)
    for s in range(owners.shape[-1]):
        keep |= owners[(j // bs) // pnb, (i // bs) // rows_per, s] == me
    h = PM.fill_from_triplets(base, i[keep], j[keep], v[keep],
                              mode="prepartitioned")
else:
    h = mm.read(os.path.join(workdir, "h.mtx"), bs=16, grid=grid)
isq = PM.identity(h.dim, bs=16, dtype=h.dtype, grid=grid)
params = SolverParameters(converge_diff=1e-9, threshold=1e-11,
                          iters_per_sync=4)
rho, energy, mu = density.trs4(h, isq, float(h.dim // 2), params)

# write-back exercises the route-to-root MM write AND the collective
# (every-rank pwrite) binary checkpoint
from ntpoly_tpu.io import binary  # noqa: E402

mm.write(rho, os.path.join(workdir, "rho_mh.mtx"))
binary.write(rho, os.path.join(workdir, "rho_mh.bin"))

print(f"MHENERGY {pid} {float(energy):.12f} {float(mu):.8f}", flush=True)
