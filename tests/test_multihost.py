"""Multi-process data path: byte-range IO + distributed fill + solve.

Two OS processes x 4 CPU devices form one 8-device global mesh (the
emulation of a 2-host cluster).  Each process parses only its byte
range of the Matrix Market file (reference MPI-IO read,
PSMatrixModule.F90:351-570), the triplets are exchanged (reference
alltoallv fill, distributed_includes/FillMatrixFromTripletList.f90), and
TRS4 runs to convergence over the global mesh.  The energy must match a
single-process solve of the same file.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _make_system(workdir, rng, dim=64):
    h = rng.random((dim, dim))
    h = 0.5 * (h + h.T)
    w, v = np.linalg.eigh(h)
    w[dim // 2:] += (w[-1] - w[0])
    h = (v * w) @ v.T
    from scipy.io import mmwrite
    from scipy.sparse import csr_matrix
    mmwrite(str(workdir / "h.mtx"), csr_matrix(h))
    occ = v[:, :dim // 2]
    return w[:dim // 2].sum(), occ @ occ.T


def _run_workers(tmp_path, nproc, devs, grid, mode, port):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devs}"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # tiny KV chunks force the multi-chunk exchange path (the production
    # default is 64 MB; the chunking exists so a single bucket can never
    # exceed gRPC message limits)
    env["NTX_KV_CHUNK_BYTES"] = "4096"
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_multihost_worker.py"),
             str(pid), str(nproc), str(tmp_path), str(devs), grid, mode,
             str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for pid in range(nproc)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=570)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)
    energies = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("MHENERGY"):
                _, pid, e, mu = line.split()
                energies[int(pid)] = float(e)
    assert len(energies) == nproc, outs
    return energies


@pytest.mark.parametrize("nproc,devs,grid,mode,port", [
    (2, 4, "2,2,2", "distributed", 29517),
    (4, 2, "2,2,2", "prepartitioned", 29531),
    (4, 2, "4,2,1", "distributed", 29547),
], ids=["2proc-distributed", "4proc-prepartitioned", "4proc-asym-grid"])
def test_multi_process_mesh_trs4(tmp_path, rng, nproc, devs, grid, mode,
                                 port):
    """OS processes x CPU devices form one global mesh (multi-host
    emulation): byte-range IO + owner-routed fill ('distributed') or the
    O(nnz/P) 'prepartitioned' path, TRS4 to convergence, root write-back
    (reference alltoallv fill + MPI-IO,
    distributed_includes/FillMatrixFromTripletList.f90)."""
    e_ref, rho_ref = _make_system(tmp_path, rng)
    energies = _run_workers(tmp_path, nproc, devs, grid, mode, port)
    vals = list(energies.values())
    assert max(vals) - min(vals) < 1e-9
    assert abs(vals[0] - e_ref) < 1e-6 * abs(e_ref)
    # the route-to-root MM write must carry the full density
    from scipy.io import mmread
    rho = np.asarray(mmread(str(tmp_path / "rho_mh.mtx")).todense())
    assert (np.linalg.norm(rho - rho_ref) / np.linalg.norm(rho_ref)) < 1e-6
    # ... and the collective binary write (every rank pwrites its own
    # byte range) must round-trip to the same matrix
    from ntpoly_tpu.io import binary
    i, j, v, dim = binary.read_triplets(str(tmp_path / "rho_mh.bin"))
    rho_b = np.zeros((dim, dim))
    np.add.at(rho_b, (i, j), v.real)
    assert (np.linalg.norm(rho_b - rho_ref)
            / np.linalg.norm(rho_ref)) < 1e-6


def test_byte_range_read_partitions_exactly(tmp_path, rng):
    """Union of all ranks' byte-range parses == the whole file, each line
    exactly once (single-process check of the range logic)."""
    from scipy.io import mmwrite
    from scipy.sparse import csr_matrix
    from ntpoly_tpu.io import matrix_market as mm
    dim = 37
    m = rng.random((dim, dim)) * (rng.random((dim, dim)) < 0.3)
    mmwrite(str(tmp_path / "m.mtx"), csr_matrix(m))
    whole = mm.read_triplets(str(tmp_path / "m.mtx"))
    for n_ranks in (1, 2, 3, 5):
        parts = [mm.read_triplets_range(str(tmp_path / "m.mtx"), r, n_ranks)
                 for r in range(n_ranks)]
        i = np.concatenate([p[0] for p in parts])
        j = np.concatenate([p[1] for p in parts])
        v = np.concatenate([p[2] for p in parts])
        assert len(i) == len(whole[0])
        got = sorted(zip(i.tolist(), j.tolist(), v.tolist()))
        ref = sorted(zip(whole[0].tolist(), whole[1].tolist(),
                         whole[2].tolist()))
        # native strtod vs numpy float parse may differ in the last ulp
        assert [(a, b) for a, b, _ in got] == [(a, b) for a, b, _ in ref]
        assert np.allclose([x for _, _, x in got],
                           [x for _, _, x in ref], rtol=1e-14)


def test_binary_range_read_partitions_exactly(tmp_path, rng):
    from ntpoly_tpu.io import binary
    from ntpoly_tpu.parallel import pmatrix as PM
    from ntpoly_tpu.parallel.grid import ProcessGrid
    dim = 29
    m = rng.random((dim, dim)) * (rng.random((dim, dim)) < 0.4)
    mat = PM.from_dense(m, bs=4, grid=ProcessGrid(1, 1, 1))
    binary.write(mat, str(tmp_path / "m.bin"))
    whole = binary.read_triplets(str(tmp_path / "m.bin"))
    for n_ranks in (2, 4):
        parts = [binary.read_triplets_range(str(tmp_path / "m.bin"),
                                            r, n_ranks)
                 for r in range(n_ranks)]
        i = np.concatenate([p[0] for p in parts])
        assert len(i) == len(whole[0])


def test_prepartitioned_fill_single_process(rng):
    """mode='prepartitioned' with the full set in one process equals the
    replicated fill (the multi-process path shares this code)."""
    from ntpoly_tpu.parallel import pmatrix as PM
    from ntpoly_tpu.parallel.grid import ProcessGrid
    from conftest import rel_error
    dim = 24
    m = rng.random((dim, dim)) * (rng.random((dim, dim)) < 0.4)
    i, j = np.nonzero(m)
    grid = ProcessGrid(2, 2, 1)
    base = PM.empty(dim, bs=4, grid=grid, k=1)
    a = PM.fill_from_triplets(base, i, j, m[i, j], mode="prepartitioned")
    b = PM.fill_from_triplets(base, i, j, m[i, j])
    assert rel_error(np.asarray(PM.to_dense(a)),
                     np.asarray(PM.to_dense(b))) == 0


def test_multi_process_structural_ops(tmp_path):
    """resize / aligned slice stay device-side on
    a multi-process mesh — no O(global nnz) host triplet round trip
    (reference in-place regrid / targeted sends,
    PSMatrixModule.F90:309-347,1036-1227)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # tiny KV chunks force the multi-chunk exchange path (the production
    # default is 64 MB; the chunking exists so a single bucket can never
    # exceed gRPC message limits)
    env["NTX_KV_CHUNK_BYTES"] = "4096"
    nproc = 2
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_structops_worker.py"),
             str(pid), str(nproc), str(tmp_path), "2", "29563"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for pid in range(nproc)
    ]
    oks = 0
    for p in procs:
        out, err = p.communicate(timeout=570)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        oks += sum(1 for line in out.splitlines()
                   if line.startswith("STRUCTOPS_OK"))
    assert oks == nproc


def test_multi_process_stress_regrow(tmp_path):
    """dim-1024 multi-process TRS4 with the capacity
    pinned below the purification fill-in — the chunked driver must
    detect the overflow, regrow across the chunk boundary, and still
    land on the oracle energy.  The 'distributed' fill rides the
    exact-sized KV exchange (reference alltoallv,
    triplet_includes/RedistributeTripletLists.f90:32-35)."""
    dim = 1024
    # gapped 1D chain: alternating on-site energies +- 1, hopping 0.2 —
    # banded, so the initial capacity is tiny and fill-in must regrow
    diag = np.where(np.arange(dim) % 2 == 0, -1.0, 1.0)
    from scipy.sparse import diags
    h = diags([np.full(dim - 1, 0.2), diag, np.full(dim - 1, 0.2)],
              [-1, 0, 1]).toarray()
    w = np.linalg.eigvalsh(h)
    e_ref = w[:dim // 2].sum()
    from scipy.io import mmwrite
    from scipy.sparse import csr_matrix
    mmwrite(str(tmp_path / "h.mtx"), csr_matrix(h))
    energies = _run_workers(tmp_path, 2, 4, "2,2,2", "stress", 29579)
    vals = list(energies.values())
    assert max(vals) - min(vals) < 1e-9
    assert abs(vals[0] - e_ref) < 1e-6 * abs(e_ref)
    log = (tmp_path / "stress_log.yaml").read_text()
    assert "capacity regrown" in log, \
        "regrow never fired — the stress case no longer stresses"
    import yaml
    yaml.safe_load(log)                   # the trace must stay parseable
