"""Matrix data model: dense n×n storage plus CCS/CRS compressed views.

Parity: ``DenseMatrix<T>`` / ``SparseMatrix<T>`` (reference
revised_perman/flags.h:146-236) and ``matrix2compressed``
(reference util.h:522-551).  Unlike the reference, the sparse view is
derived lazily from the dense array — at n<=64 the dense array is the
source of truth and conversions are cheap numpy ops.
"""

from __future__ import annotations

import dataclasses

import numpy as np


_TYPE_NAMES = {"int": np.int64, "float": np.float32, "double": np.float64}


@dataclasses.dataclass
class DenseMatrix:
    mat: np.ndarray          # (nov, nov), row-major
    type: str = "double"     # "int" | "float" | "double" (storage class tag)

    @property
    def nov(self) -> int:
        return self.mat.shape[0]

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.mat))

    def copy(self) -> "DenseMatrix":
        return DenseMatrix(self.mat.copy(), self.type)

    def astype(self, type_name: str) -> "DenseMatrix":
        """Parity: swap_types (revised_perman/util.h:1596-1610)."""
        return DenseMatrix(self.mat.astype(_TYPE_NAMES[type_name]), type_name)

    def binarized(self) -> "DenseMatrix":
        """-b / binary_graph: all nonzeros become 1 (reference ReadMatrix
        'generic=false' branch, util.h:352-356)."""
        return DenseMatrix((self.mat != 0).astype(self.mat.dtype), self.type)


def require_finite(a: np.ndarray, what: str = "matrix") -> None:
    """Raise ValueError naming the first NaN, +Inf or -Inf entry of `a`
    (row-major order), which `what` names.  The permanent of such a matrix
    is not a number the engines can give: the reference's row scales turn
    a NaN into INT64_MIN (superman_tpu/ops/ryser.py:60), which ends in a
    `nan` result below n=19 and an OverflowError from it."""
    a = np.asarray(a)
    if a.dtype.kind not in "fc":
        return                        # integers are finite
    bad = ~np.isfinite(a)
    if bad.any():
        idx = tuple(int(k) for k in np.argwhere(bad)[0])
        raise ValueError(f"{what}: entry {idx} is {a[idx]}; NaN and "
                         f"infinite entries are rejected")


@dataclasses.dataclass
class SparseMatrix:
    """CCS + CRS compressed views of a square matrix.

    cptrs/rows/cvals: column-compressed (per column j, the row indices and
    values of its nonzeros); rptrs/cols/rvals: row-compressed.  Matches the
    six-array layout every reference kernel consumes
    (revised_perman/flags.h:197-236).
    """
    nov: int
    cptrs: np.ndarray
    rows: np.ndarray
    cvals: np.ndarray
    rptrs: np.ndarray
    cols: np.ndarray
    rvals: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.cptrs[-1])

    def col_nnz(self) -> np.ndarray:
        return np.diff(self.cptrs)

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.rptrs)

    def to_dense(self, type_name: str = "double") -> "DenseMatrix":
        a = np.zeros((self.nov, self.nov),
                     dtype=_TYPE_NAMES.get(type_name, np.float64))
        for j in range(self.nov):
            sl = slice(self.cptrs[j], self.cptrs[j + 1])
            a[self.rows[sl], j] = self.cvals[sl]
        return DenseMatrix(a, type_name)


def matrix2compressed(dense: DenseMatrix) -> SparseMatrix:
    """Build CCS+CRS from the dense array (reference util.h:522-551).

    Note the reference treats entries ``> 0`` as nonzero (negative values
    never appear in its inputs); we use ``!= 0`` so signed matrices are
    handled correctly, which is a strict superset of reference behavior on
    its own data.
    """
    a = dense.mat
    nov = a.shape[0]
    ri, ci = np.nonzero(a)                     # row-major order: CRS direct
    rptrs = np.zeros(nov + 1, dtype=np.int32)
    np.add.at(rptrs, ri + 1, 1)
    rptrs = np.cumsum(rptrs).astype(np.int32)
    cols = ci.astype(np.int32)
    rvals = a[ri, ci]

    ci2, ri2 = np.nonzero(a.T)                 # column-major order: CCS
    cptrs = np.zeros(nov + 1, dtype=np.int32)
    np.add.at(cptrs, ci2 + 1, 1)
    cptrs = np.cumsum(cptrs).astype(np.int32)
    rows = ri2.astype(np.int32)
    cvals = a[ri2, ci2]

    return SparseMatrix(nov, cptrs, rows, cvals, rptrs, cols, rvals)
