"""MatrixMarket reader.

Parity: mmio.c banner/size parsing + readDenseMatrix /
readSymmetricDenseMatrix (reference revised_perman/read_matrix.hpp:11-157,
driver checks at revised_perman/main.cpp:1522-1577): rejects complex and
non-square matrices, expands symmetric storage by mirroring, treats
``pattern`` and ``-b`` (binary) entries as 1, converts 1-based indices to
0-based.
"""

from __future__ import annotations

import numpy as np

from ..core.matrix import DenseMatrix


def read_matrix_market(path: str, binary_graph: bool = False,
                       storage_half: bool = False,
                       storage_quad: bool = False,
                       allow_rect: bool = False) -> DenseMatrix:
    with open(path) as f:
        banner = f.readline().strip().split()
        if len(banner) < 5 or banner[0] != "%%MatrixMarket":
            raise ValueError(f"{path}: not a MatrixMarket file")
        _, obj, fmt, field, symmetry = [s.lower() for s in banner[:5]]
        if obj != "matrix" or fmt != "coordinate":
            raise ValueError(f"{path}: only coordinate matrices are supported")
        if field == "complex":
            raise ValueError(f"{path}: complex matrices are not supported")
        symmetric = symmetry in ("symmetric", "skew-symmetric")
        # skew mirrors with NEGATED values (the reference lumps skew with
        # symmetric and mirrors the same value, main.cpp:1573 — a bug we
        # do not reproduce)
        skew = symmetry == "skew-symmetric"

        # skip comments
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        m, n, nnz = (int(t) for t in line.split()[:3])
        if m != n and not allow_rect:
            raise ValueError(f"{path}: matrix is not square ({m}x{n})")

        if field == "integer" and not binary_graph:
            type_name, dtype = "int", np.int64
        elif field == "pattern" or binary_graph:
            type_name, dtype = "int", np.int64
        elif storage_quad:
            # reference -v: __float128 storage; host long double captures
            # >53-bit literals and feeds the quad calc path losslessly
            type_name, dtype = "double", np.longdouble
        else:
            type_name, dtype = ("float", np.float32) if storage_half else (
                "double", np.float64)

        mat = np.zeros((m, n), dtype=dtype)
        pattern = field == "pattern"
        for _ in range(nnz):
            parts = f.readline().split()
            i, j = int(parts[0]) - 1, int(parts[1]) - 1
            if not (0 <= i < m and 0 <= j < n):
                # a 0-based entry in a (1-based) MatrixMarket file would
                # otherwise wrap to the LAST row via numpy's negative
                # indexing — a silently wrong matrix
                raise ValueError(
                    f"{path}: entry ({int(parts[0])}, {int(parts[1])}) "
                    f"outside the declared {m}x{n} (1-based) range")
            if pattern or binary_graph:
                v = 1
            elif field == "integer":
                v = int(parts[2])
            elif dtype is np.longdouble:
                # -v quad storage: parse at long-double precision (a
                # float() round-trip would quantize >53-bit literals
                # before the quad walk ever sees them)
                v = np.longdouble(parts[2])
            else:
                v = float(parts[2])
            mat[i, j] = v
            if symmetric:
                mat[j, i] = -v if skew else v
    return DenseMatrix(mat, type_name)


def read_any(path: str, binary_graph: bool = False,
             storage_half: bool = False,
             storage_quad: bool = False,
             allow_rect: bool = False) -> DenseMatrix:
    """Dispatch on content: MatrixMarket banner vs v1 triplet header."""
    with open(path) as f:
        first = f.readline()
    if first.startswith("%%MatrixMarket"):
        return read_matrix_market(path, binary_graph, storage_half,
                                  storage_quad, allow_rect)
    from .triplet import read_triplet
    dm = read_triplet(path, binary_graph)
    if storage_half and dm.type != "int":
        dm = dm.astype("float")
    return dm
