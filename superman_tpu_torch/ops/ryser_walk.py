"""Plain PyTorch Ryser walk, lane-vectorised, float64 by default.

Port of ``superman_tpu/ops/ryser_xla.py`` (an XLA walk in the reference,
no Pallas kernel).  Used for calc="f64" and for matrices below n=19,
where a kernel launch costs more than the walk: in float32 for
calc="f32", in float64 for every other tier, as the reference chooses.
The card's float64 is native IEEE double, so the walk runs on whatever
device it is given.

Unlike the reference's walk, which runs on the matrix as given (and so
returns NaN where a product overflows and -0.0 where every product
underflows, ryser_xla.py:45-73), each row is scaled by an exact power of
two first (walk_scales), as the kernel route scales its rows: a permanent
that a double holds comes back finite, one beyond its range as +-inf,
one below it as +0.0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.debug import check_nan
from .oracle import gray_init_lanes, perman_brute


#: lanes of the walk (the reference's ryser_xla default)
MAX_LANES = 1 << 13


def walk_lanes(X: torch.Tensor, sign_mid: torch.Tensor, cols: torch.Tensor,
               r: int) -> torch.Tensor:
    """Signed partial sums of lanes that each walk 2^r Gray steps.

    X: (..., C, n) lane x-vectors and sign_mid: (C,) from
    oracle.gray_init_lanes; cols: (..., n-1, n) matrix columns, one table
    per leading index of X.  Returns (..., C), checked for NaN under
    SUPERMAN_DEBUG_NANS (utils/debug.py) on the device it ran on."""
    acc = torch.prod(X, dim=-1)                # m = 0 terms, sign +1
    for m in range(1, 1 << r):
        k = (m & -m).bit_length() - 1
        if k == r - 1:
            s = sign_mid[:, None]          # mid step: the lane parity
        else:
            s = 1.0 - 2.0 * ((m >> (k + 1)) & 1)
        X = X + s * cols[..., k, None, :]
        acc = acc + (1.0 - 2.0 * (m & 1)) * torch.prod(X, dim=-1)
    check_nan(f"walk_lanes ({str(acc.dtype).removeprefix('torch.')})", acc)
    return acc


def walk_scales(a: np.ndarray, axis: int = -1, step: int = 1) -> np.ndarray:
    """Exponents s for the lane walks: 2^-s_j scales row j (Glynn, axis=-2:
    column j) of an (n, n) matrix, or of each matrix of a (B, n, n) stack,
    so that every |x_j| stays below 1 along the walk.  The bound of |x_j|
    is ryser._row_scales' (|a[j, n-1]| + abs row sum / 2), or for Glynn's
    columns glynn._col_scales' (abs column sum), but taken on the line
    times 2^-e_j, e_j the exponent of its largest |entry| (np.frexp), so
    that no sum overflows, and not clipped: ldexp takes any exponent.  A
    long-double matrix (the -v storage) is bounded in long double, any
    other in float64.  A non-finite entry leaves its line's exponent
    finite (frexp gives 0), so its NaN reaches the walk's sum, where
    SUPERMAN_DEBUG_NANS names the walk.

    step > 1 rounds each exponent to the nearest multiple of step (the
    estimators' 100: a line whose bound lies within 2^+-50 of 1 keeps its
    entries as given)."""
    a = np.asarray(a)
    ab = np.abs(a if a.dtype == np.longdouble
                else a.astype(np.float64, copy=False))
    e = np.frexp(ab.max(axis=axis, keepdims=True))[1]
    b = np.ldexp(ab, -e)
    xmax = b.sum(axis=axis)
    if axis == -1:
        xmax = b[..., -1] + xmax / 2
    s = (np.squeeze(e, axis) + np.frexp(xmax)[1]).astype(np.int64)
    return (s + step // 2) // step * step


def times_pow2(total, E):
    """total * 2^E (elementwise on arrays) as float64, the product taken in
    total's own type: a long double (a host walk's accumulator) is
    multiplied in long double and rounded to a double once, anything else
    in float64.  Exact where the result is a normal double: +-inf beyond a
    double's range, +0.0 (never -0.0) where it underflows or is zero."""
    t = np.asarray(total)
    if t.dtype != np.longdouble:
        t = t.astype(np.float64)
    with np.errstate(over="ignore", under="ignore"):
        return np.ldexp(t, E).astype(np.float64) + 0.0


def brute_scaled(a: np.ndarray) -> float:
    """The permanent of an order-1 or order-2 matrix by oracle.perman_brute,
    as the reference multiplies them out (ryser.py:251-253,
    ryser_xla.py:56-57, batch.py:37-38): an integer matrix as given
    (Python ints, exact), any other with its rows scaled by walk_scales
    and the product multiplied back by 2^E, so that [[1e200, 1e200],
    [1e200, -1e200]] gives +0.0 and not inf - inf."""
    a = np.asarray(a)
    if a.dtype.kind in "biu" or a.size == 0:
        return float(perman_brute(a))
    s = walk_scales(a)
    return float(times_pow2(perman_brute(np.ldexp(a, -s[:, None])),
                            int(s.sum())))


def ryser_walk(a: np.ndarray, device: torch.device,
               dtype: torch.dtype = torch.float64) -> float:
    """Exact permanent via the walk on `device`.  The rows are scaled by
    walk_scales, the lanes set up in float64 and walked in `dtype`; the
    lane sums are added in float64 on the host and multiplied back by
    2^E, E the sum of the row exponents."""
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    if n <= 2:
        return brute_scaled(a)
    s = walk_scales(a)
    a = np.ldexp(a, -s[:, None])
    total = 1 << (n - 1)
    C = min(total >> 1, MAX_LANES)
    r = (total // C).bit_length() - 1
    X, sign_mid = gray_init_lanes(a, np.arange(C, dtype=np.int64), r,
                                  dtype=np.float64)
    X = torch.as_tensor(X, device=device).to(dtype)
    sign_mid = torch.as_tensor(sign_mid, device=device).to(dtype)
    cols = torch.as_tensor(np.ascontiguousarray(a[:, : n - 1].T),
                           device=device).to(dtype)
    acc = walk_lanes(X, sign_mid, cols, r)
    total_sum = float(np.sum(acc.cpu().numpy().astype(np.float64)))
    return float(times_pow2((4 * (n & 1) - 2) * total_sum, int(s.sum())))
