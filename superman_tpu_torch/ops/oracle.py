"""Host-side (numpy) reference implementations — the correctness oracle.

Parity targets: sequential ``perman64`` (reference algo.h:1031-1089) and the
brute-force matching enumerator ``brute_w`` (reference algo.h:1091-1151).
These are trusted, simple implementations every accelerated path is tested
against (the reference's own test strategy: cross-algorithm agreement,
SURVEY.md §4).

Math (Nijenhuis–Wilf Gray-code Ryser):
    x0[j] = a[j, n-1] - (sum_k a[j, k]) / 2
    x(g)  = x0 + sum_{k: g_k = 1} a[:, k]          for g over (n-1)-bit codes
    per(a) = 2 * (-1)^n * sum_{i=0}^{2^(n-1)-1} (-1)^i * prod_j x_j(gray(i))

The sum is evaluated lane-vectorized: the index space is split into aligned
chunks of 2**r; within a chunk all lanes flip the SAME column k = ctz(m) at
inner step m, so the walk vectorizes with no gather.  The per-lane sign only
diverges at the single step m = 2**(r-1) (where it is given by the chunk
index parity).  This identical structure is what the CUDA walk kernel uses
(csrc/ryser_walk.cu), one chunk per thread.
"""

from __future__ import annotations

import math

import numpy as np


def _ctz(m: int) -> int:
    return (m & -m).bit_length() - 1


def _lane_bits(l: np.ndarray, n: int, r: int, dtype) -> np.ndarray:
    """(L, n-1) bits of gray(l * 2^r) for the uint64 lane indices l: bits
    >= r are those of gray(l), bit r-1 is the parity of l, the rest 0."""
    gray_l = l ^ (l >> np.uint64(1))
    bits = np.zeros((len(l), n - 1), dtype=dtype)
    for b in range(n - 1):
        if b >= r:
            bits[:, b] = ((gray_l >> np.uint64(b - r)) & np.uint64(1))
        elif b == r - 1:
            bits[:, b] = (l & np.uint64(1))
    return bits


def gray_init_lanes(a: np.ndarray, bases_l: np.ndarray, r: int,
                    dtype=np.float64):
    """x-vectors and mid-step signs for aligned chunks [l*2^r, (l+1)*2^r).

    For base = l * 2**r (r >= 1): gray(base) has bits >= r equal to gray(l)
    and bit r-1 equal to l & 1 (bits < r-1 are zero).  Returns
    (X, sign_mid) with X[l] = x(gray(base_l)) of shape (L, n) and
    sign_mid[l] = +/-1, the sign of the x-update at inner step m = 2**(r-1).
    """
    n = a.shape[0]
    l = bases_l.astype(np.uint64)
    x0 = a[:, n - 1].astype(dtype) - a.sum(axis=1, dtype=dtype) / 2
    bits = _lane_bits(l, n, r, dtype)
    X = x0[None, :] + bits @ a[:, :n - 1].T.astype(dtype)
    sign_mid = 1.0 - 2.0 * (l & np.uint64(1)).astype(dtype)
    return X, sign_mid


def perman64(a: np.ndarray, dtype=np.float64, max_lanes: int = 1 << 16):
    """Exact permanent, lane-vectorized Nijenhuis–Wilf Ryser walk.

    Oracle parity: reference perman64 (algo.h:1031) — same formula, same
    iteration space, evaluated in float64 (or longdouble for quad parity).
    From n=2 the value is a scalar of `dtype` (np.float64 is a float), so
    a long-double walk's result is rounded only where its caller rounds it.
    """
    a = np.asarray(a)
    n = a.shape[0]
    if n == 0:
        return 1.0
    if n == 1:
        return float(a[0, 0])
    total = 1 << (n - 1)
    # pick r >= 1 so the lane count L = total >> r stays within max_lanes
    L = min(total >> 1, max_lanes)
    r = int(math.log2(total // L))
    bases_l = np.arange(L, dtype=np.uint64)
    X, sign_mid = gray_init_lanes(a, bases_l, r, dtype)
    cols = a[:, :n - 1].astype(dtype)          # cols[:, k] = column k

    acc = X.prod(axis=1).sum(dtype=dtype)      # m = 0 terms (sign +1)
    for m in range(1, 1 << r):
        k = _ctz(m)
        if k == r - 1:
            s = sign_mid[:, None]
        else:
            s = 1.0 - 2.0 * ((m >> (k + 1)) & 1)
        X += s * cols[None, :, k]
        acc += (1.0 - 2.0 * (m & 1)) * X.prod(axis=1).sum(dtype=dtype)
    return (4 * (n & 1) - 2) * acc


def perman_brute(a: np.ndarray):
    """Brute-force permanent by DFS over rows with column pruning.

    Parity: brute_w (reference algo.h:1091).  Uses Python ints for integer
    matrices (bit-exact at any magnitude); float accumulation otherwise.
    Practical for n <~ 14 dense, further for sparse.
    """
    a = np.asarray(a)
    n = a.shape[0]
    is_int = np.issubdtype(a.dtype, np.integer)
    rows = [[(j, int(a[i, j]) if is_int else float(a[i, j]))
             for j in range(n) if a[i, j] != 0] for i in range(n)]
    # process rows in ascending-degree order for pruning power
    order = sorted(range(n), key=lambda i: len(rows[i]))

    def rec(level: int, used: int):
        if level == n:
            return 1
        total = 0
        for j, v in rows[order[level]]:
            if not (used >> j) & 1:
                sub = rec(level + 1, used | (1 << j))
                if sub:
                    total += v * sub
        return total

    res = rec(0, 0)
    return res if is_int else float(res)


def glynn_init_lanes(a: np.ndarray, bases_l: np.ndarray, r: int,
                     dtype=np.float64):
    """Glynn's counterpart of gray_init_lanes: (X, sign_mid, flips) with
    X[l] = sum_i delta_i a_ij at delta = gray(base_l) (the column sums,
    -2 a[k, :] added for every set bit k), sign_mid as there, and the
    flip table flips[k] = -2 a[k, :], k < n-1."""
    a = np.asarray(a, dtype=dtype)
    n = a.shape[0]
    l = bases_l.astype(np.uint64)
    flips = -2.0 * a[: n - 1, :]               # flip vector for bit k
    X = a.sum(axis=0)[None, :] + _lane_bits(l, n, r, dtype) @ flips
    sign_mid = 1.0 - 2.0 * (l & np.uint64(1)).astype(dtype)
    return X, sign_mid, flips


def perman_glynn(a: np.ndarray, dtype=np.float64,
                 max_lanes: int = 1 << 14):
    """Exact permanent via the Glynn formula (host, lane-vectorized):

        per(A) = 2^(1-n) sum_{delta, delta_n=+1} (prod delta_i)
                 prod_j (sum_i delta_i a_ij)

    The Gray walk over delta has the same index mechanics as Ryser: state
    x_j = sum_i delta_i a_ij starts at the column sums and flipping
    delta_k adds -2 a[k, :]; the term sign (prod delta) telescopes to
    (-1)^m.  Independent of perman64 in formula and coefficients — used
    for cross-algorithm agreement.  From n=2 the value is a scalar of
    `dtype`, as perman64's."""
    a = np.asarray(a, dtype=dtype)
    n = a.shape[0]
    if n == 0:
        return 1.0
    if n == 1:
        return float(a[0, 0])
    total = 1 << (n - 1)
    L = min(total >> 1, max_lanes) or 1
    r = int(math.log2(total // L))
    X, sign_mid, flips = glynn_init_lanes(a, np.arange(L, dtype=np.uint64),
                                          r, dtype)

    acc = X.prod(axis=1).sum(dtype=dtype)      # m = 0 terms (sign +1)
    for m in range(1, 1 << r):
        k = _ctz(m)
        if k == r - 1:
            s = sign_mid[:, None]
        else:
            s = 1.0 - 2.0 * ((m >> (k + 1)) & 1)
        X += s * flips[None, k, :]
        acc += (1.0 - 2.0 * (m & 1)) * X.prod(axis=1).sum(dtype=dtype)
    return acc * 2.0 ** (1 - n)


