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

`ryser_walk` records two leaf spans (utils/trace.timer): `lane_init`,
the row scales and the lanes' set-up on the host and their copies to the
device, and `lane_walk`, the walk, the lane sums' copy back, their host
sum and the scale multiplied back; and counts each walk in LANE_WALKS by
the dtype it walked in.

The lanes' start is oracle.gray_init_lanes' X, bit for bit, built with no
BLAS call (lane_x): numpy's product there wakes OpenBLAS's pool of
threads on every call, which on an H100's 8-core host stalled calls of
~2 ms for up to 27 ms.
"""

from __future__ import annotations

import collections
import functools
import threading

import numpy as np
import torch

from ..utils import trace
from ..utils.debug import check_nan
from .oracle import gray_init_lanes, perman_brute


#: lanes of the walk (the reference's ryser_xla default)
MAX_LANES = 1 << 13

#: ryser_walk's walks by the dtype they walked in, "float64" or "float32"
LANE_WALKS: collections.Counter = collections.Counter()


@functools.lru_cache(maxsize=None)
def _lane_rows(C: int) -> np.ndarray:
    """Row of each of C lanes in lane_x's table of subset sums: gray(l * 2^r)
    >> (r - 1), whose bit 0 is the parity of l and whose bits from 1 are
    those of gray(l) (oracle._lane_bits)."""
    l = np.arange(C, dtype=np.int64)
    return ((l ^ (l >> 1)) << 1) | (l & 1)


@functools.lru_cache(maxsize=None)
def _sign_mid(C: int, device: torch.device, dtype: torch.dtype):
    """gray_init_lanes' sign_mid of C lanes, on `device` in `dtype`."""
    l = np.arange(C, dtype=np.int64)
    return torch.as_tensor(1.0 - 2.0 * (l & 1), device=device).to(dtype)


#: this thread's host arrays of the newest order's lane walk
_ARRAYS = threading.local()


def _host_arrays(n: int, C: int):
    """(lane_x's table, the lanes and columns that go up to the device) of
    an order-n walk of C lanes, kept from call to call in each thread: a
    fresh array of a few MB faults its pages in on every call."""
    got = getattr(_ARRAYS, "got", None)
    if got is None or got[0] != (n, C):
        got = _ARRAYS.got = ((n, C), np.empty((2 * C, n)),
                             np.empty((C + n - 1, n)))
    return got[1], got[2]


def lane_x(a: np.ndarray, C: int, r: int, out: np.ndarray,
           t: np.ndarray) -> np.ndarray:
    """oracle.gray_init_lanes(a, arange(C), r)'s X, bit for bit, into out
    (C, n), for a finite float64 (n, n) matrix a with C * 2^r = 2^(n-1);
    t a (2C, n) array to build the sums in.

    Lane l's start is x0 plus the columns r-1 .. n-2 that gray(l * 2^r)
    sets.  The 2C sums of those columns' subsets are built by doubling,
    each column added in increasing order to the sums without it, which
    is the order a BLAS product sums them in (0/1 times a column is exact,
    and adding a zero to a sum changes nothing); each lane takes its row.
    A non-finite entry would make 0 times it NaN in the product and not
    here, so such a matrix is not passed."""
    n = a.shape[0]
    t[0] = 0.0
    for j in range(n - r):
        h = 1 << j
        np.add(t[:h], a[:, r - 1 + j], out=t[h:2 * h])
    np.take(t, _lane_rows(C), axis=0, out=out)
    out += a[:, n - 1] - a.sum(axis=1) / 2
    return out


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
               dtype: torch.dtype = torch.float64
               ) -> tuple[float, dict | None]:
    """Exact permanent via the walk on `device`: (the permanent, the
    walk's counter), the counter {"lanes": C, "r": r, "steps": 2^r - 1,
    "dtype": "float64" or "float32"} (None for orders 1-2, which
    brute_scaled multiplies out).  The rows are scaled by walk_scales, the
    lanes set up in float64 and walked in `dtype`; the lane sums are added
    in float64 on the host and multiplied back by 2^E, E the sum of the
    row exponents."""
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    if n <= 2:
        return brute_scaled(a), None
    total = 1 << (n - 1)
    C = min(total >> 1, MAX_LANES)
    r = (total // C).bit_length() - 1
    with trace.timer("lane_init"):
        s = walk_scales(a)
        a = np.ldexp(a, -s[:, None])
        # the lanes' X and the columns go up as one array
        t, host = _host_arrays(n, C)
        if np.isfinite(a).all():
            lane_x(a, C, r, host[:C], t)
        else:
            host[:C] = gray_init_lanes(a, np.arange(C, dtype=np.int64), r,
                                       dtype=np.float64)[0]
        host[C:] = a[:, : n - 1].T
        both = torch.as_tensor(host, device=device).to(dtype)
        X, cols = both[:C], both[C:]
        sign_mid = _sign_mid(C, device, dtype)
    with trace.timer("lane_walk"):
        acc = walk_lanes(X, sign_mid, cols, r)
        total_sum = float(np.sum(acc.cpu().numpy().astype(np.float64)))
        p = float(times_pow2((4 * (n & 1) - 2) * total_sum, int(s.sum())))
    name = str(dtype).removeprefix("torch.")
    LANE_WALKS[name] += 1
    return p, {"lanes": C, "r": r, "steps": (1 << r) - 1, "dtype": name}
