"""Docs subsystem: the API-reference generator
must run and cover the public surface (the role of the reference's
Ford/Doxygen/Sphinx pipeline, reference Documentation/Makefile)."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_gen_api_covers_public_surface(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "docs", "gen_api.py"),
         str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    index = (tmp_path / "index.md").read_text()
    # every solver namespace the tests drive must be documented
    for name in ("DensityMatrixSolvers", "FermiOperator", "EigenSolvers",
                 "ExponentialSolvers", "InverseSolvers", "LinearSolvers",
                 "SignSolvers", "SquareRootSolvers", "TrigonometrySolvers",
                 "RootSolvers", "Analysis", "GeometryOptimization",
                 "Matrix_ps", "SolverParameters", "ProcessGrid",
                 "TripletList_r", "MatrixMapper"):
        assert f"`{name}`" in index, f"{name} missing from API docs"
    # solver pages carry the implementation docstrings (citations etc.)
    es = (tmp_path / "electronic_solvers.md").read_text()
    assert "purification" in es.lower()
    assert "DensityMatrixSolversModule" in es   # reference citation


def test_docs_tree_complete():
    docs = os.path.join(REPO, "docs")
    for f in ("architecture.md", "guide.md", "gen_api.py",
              os.path.join("source", "conf.py"),
              os.path.join("source", "index.rst")):
        assert os.path.exists(os.path.join(docs, f)), f
