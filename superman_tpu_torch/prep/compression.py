"""Exact-preserving matrix compressions.

Port of ``superman_tpu/prep/compression.py``, unchanged: the module is
pure numpy.

Parity: d1compress / d2compress / d34compress + getMinNnz / checkEmpty
(reference revised_perman/util.h:1138-1407).  Each reduction shrinks n by
one while preserving the permanent exactly:

* degree-1: a row (or column) with a single nonzero v in column c — every
  permutation must use it, so per(A) = v * per(A without that row/col).
* degree-2: a row with nonzeros v1@c1, v2@c2 — expanding along it,
  per(A) = v1*per(A-row-c1) + v2*per(A-row-c2); both minors differ only in
  one column, so they merge into ONE matrix whose c1-column entries become
  a[i,c1]*v2 + a[i,c2]*v1 (Laplace-style column combination).
* degree-3/4: the same expansion grouped in pairs yields TWO (n-1) matrices
  whose permanents sum to per(A) (the reference's branch-and-sum driver,
  revised_perman/main.cpp:1029-1046).

Column cases transpose first (per(A^T) = per(A)).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def row_degrees(a: np.ndarray) -> np.ndarray:
    return (a != 0).sum(axis=1)


def min_degree(a: np.ndarray) -> int:
    """getMinNnz parity: min over all row and column degrees."""
    return int(min((a != 0).sum(axis=1).min(), (a != 0).sum(axis=0).min()))


def has_empty_line(a: np.ndarray) -> bool:
    return bool(((a != 0).sum(axis=1) == 0).any() or
                ((a != 0).sum(axis=0) == 0).any())


def _find_degree(a: np.ndarray, deg: int) -> Optional[Tuple[np.ndarray, bool]]:
    """Matrix oriented so a degree-`deg` ROW exists (transposing if it was a
    column), or None.  Returns (oriented matrix, was_transposed)."""
    if (row_degrees(a) == deg).any():
        return a, False
    if ((a != 0).sum(axis=0) == deg).any():
        return a.T.copy(), True
    return None


def d1compress(a: np.ndarray) -> Optional[np.ndarray]:
    found = _find_degree(a, 1)
    if found is None:
        return None
    m, _ = found
    r = int(np.nonzero(row_degrees(m) == 1)[0][0])
    c = int(np.nonzero(m[r])[0][0])
    v = m[r, c]
    out = np.delete(np.delete(m, r, axis=0), c, axis=1)
    if out.size:
        out[0, :] = out[0, :] * v     # fold the forced factor into row 0
    return out


def d2compress(a: np.ndarray) -> Optional[np.ndarray]:
    found = _find_degree(a, 2)
    if found is None:
        return None
    m, _ = found
    r = int(np.nonzero(row_degrees(m) == 2)[0][0])
    c1, c2 = (int(j) for j in np.nonzero(m[r])[0][:2])
    v1, v2 = m[r, c1], m[r, c2]
    merged = m[:, c1] * v2 + m[:, c2] * v1
    out = m.copy()
    out[:, c1] = merged
    out = np.delete(np.delete(out, r, axis=0), c2, axis=1)
    return out


def d34compress(a: np.ndarray, deg: int):
    """Split along a degree-3/4 row into two (n-1) matrices whose permanents
    sum to per(a).  For degree 3 the second pair is (c3, any-zero-column),
    which degenerates to a plain single-column expansion."""
    found = _find_degree(a, deg)
    if found is None:
        return None
    m, _ = found
    r = int(np.nonzero(row_degrees(m) == deg)[0][0])
    nz = [int(j) for j in np.nonzero(m[r])[0]]
    if deg == 3:
        zero_cols = np.nonzero(m[r] == 0)[0]
        if len(zero_cols) == 0:
            return None               # n == 3 fully dense; not compressible
        nz = nz + [int(zero_cols[-1])]
    c0, c1, c2, c3 = nz[:4]

    def pair_matrix(ca, cb):
        out = m.copy()
        out[:, ca] = m[:, ca] * m[r, cb] + m[:, cb] * m[r, ca]
        return np.delete(np.delete(out, r, axis=0), cb, axis=1)

    return pair_matrix(c0, c1), pair_matrix(c2, c3)
