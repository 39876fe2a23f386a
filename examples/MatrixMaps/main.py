"""Mapping a function over every element of a distributed matrix.

Mirrors Examples/MatrixMaps of the reference (main.py + the SWIG director
RealOperation): double every lower-triangular element, drop the rest.
Two idioms are shown — the callback Operation class (reference
MatrixMapper.h:13-45 directors) and the vectorized fast path, which is how
the map should be written for a device (one fused XLA kernel over the triplet
arrays instead of a Python call per element).
"""
import argparse

import ntpoly_tpu as nt


class TestOperation(nt.RealOperation):
    """Double lower-triangular elements; drop the rest (returns False)."""

    def __call__(self):
        if self.data.index_row >= self.data.index_column:
            self.data.point_value *= 2
            return True
        return False


def generate_input(file_name, n=32, seed=3):
    import numpy as np
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3)
    i, j = np.nonzero(m)
    with open(file_name, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{n} {n} {len(i)}\n")
        for r, c in zip(i, j):
            f.write(f"{r + 1} {c + 1} {m[r, c]:.16e}\n")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--input_matrix", required=True)
    p.add_argument("--output_matrix", required=True)
    p.add_argument("--process_rows", type=int, default=1)
    p.add_argument("--process_columns", type=int, default=1)
    p.add_argument("--process_slices", type=int, default=1)
    args = p.parse_args()

    nt.ConstructGlobalProcessGrid(
        args.process_rows, args.process_columns, args.process_slices)
    if nt.GetGlobalIsRoot():
        nt.ActivateLogger()

    generate_input(args.input_matrix)
    inmat = nt.Matrix_ps(args.input_matrix)
    outmat = nt.Matrix_ps(inmat.GetActualDimension())

    # Idiom 1: the callback Operation class (director-style).
    nt.MatrixMapper.Map(inmat, outmat, TestOperation())
    outmat.WriteToMatrixMarket(args.output_matrix)

    # Idiom 2: the vectorized fast path — same semantics, one XLA kernel.
    vec = nt.Matrix_ps(inmat.GetActualDimension())
    nt.MatrixMapper.MapVectorized(
        inmat, vec, lambda i, j, v: (i, j, 2.0 * v, i >= j))

    if nt.GetGlobalIsRoot():
        nt.DeactivateLogger()
    nt.DestructGlobalProcessGrid()


if __name__ == "__main__":
    main()
