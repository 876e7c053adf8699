"""Reader/writer for the v1 triplet format.

Format (reference util.h:343-358 + main.cu:494-498): first line
``nov nnz type`` where type in {int, float, double}; then 0-based
``i j value`` triplets, one per line.  Duplicate entries overwrite
(reference assigns, does not accumulate).
"""

from __future__ import annotations

import numpy as np

from ..core.matrix import DenseMatrix, _TYPE_NAMES


def read_triplet(path: str, binary_graph: bool = False) -> DenseMatrix:
    with open(path) as f:
        header = f.readline().split()
        nov = int(header[0])
        type_name = header[2] if len(header) > 2 else "double"
        if type_name not in _TYPE_NAMES:
            raise ValueError(f"unknown matrix type {type_name!r} in {path}")
        dtype = _TYPE_NAMES[type_name]
        mat = np.zeros((nov, nov), dtype=dtype)
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue   # reference skips erroneous lines (util.h:351)
            i, j = int(parts[0]), int(parts[1])
            if not (0 <= i < nov and 0 <= j < nov):
                continue   # out-of-range = erroneous line (skip, as above);
                #            numpy would silently WRAP a negative index
            # `generic=false` (-b) stores 1 regardless of value
            mat[i, j] = 1 if binary_graph else dtype(
                float(parts[2]) if type_name != "int" else int(parts[2]))
    return DenseMatrix(mat, type_name)


def write_triplet(path: str, dense: DenseMatrix) -> None:
    a = dense.mat
    ri, ci = np.nonzero(a)
    with open(path, "w") as f:
        f.write(f"{a.shape[0]} {len(ri)} {dense.type}\n")
        for i, j in zip(ri, ci):
            v = a[i, j]
            f.write(f"{i} {j} {int(v) if dense.type == 'int' else v}\n")
