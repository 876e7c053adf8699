"""What the kernel engines decide alike around a scaled walk.

Ryser (ops/ryser.py), Glynn (ops/glynn.py) and the serving batch
(ops/batch.py) scale each line of the matrix (a row for Ryser and the
batch, a column for Glynn) by an exact power of two, so that every |x_j|
stays near 1 along the walk, and multiply the total back by 2^E, E the
sum of the exponents.  The rules they share are here, once:

* line_exponents: a line's exponent from its bound on |x_j|;
* exact_f32: whether the values and the x walk are exact in float32,
  which decides whether the tf96 tier may run;
* empty_line: a row or column of zeros (the permanent is 0, and the
  scales' bound is undefined);
* retry_scaled: the walk and its underflow retry, which shifts every
  line's exponent down and walks again while the scaled total is far
  below 1.

A line's entries run along `axis` of the matrix: -1 for rows, -2 for
columns.
"""

from __future__ import annotations

import numpy as np

from ..utils import trace


def line_exponents(bound: np.ndarray) -> np.ndarray:
    """Integer exponents s with 2^-s * bound <= 1: ceil(log2(bound)), an
    all-zero line's bound read as 1e-300, int64."""
    with np.errstate(divide="ignore"):
        s = np.ceil(np.log2(np.maximum(bound, 1e-300)))
    # wide clip: compression drivers can concentrate magnitude into lines
    # far beyond 2^+-60; the scale is applied with exact ldexp so any
    # exponent in double range is fine
    return np.clip(s, -980, 980).astype(np.int64)


def exact_f32(a: np.ndarray, axis: int = -1, declared_int: bool = False):
    """Whether the walk of `a` along lines of `axis` is exact in float32:
    integer values (taken as given under declared_int, the "int" storage
    class) and every line's abs sum below 2^22.  A bool for one matrix,
    a (B,) bool array for a (B, n, n) stack."""
    a = np.asarray(a, dtype=np.float64)
    ints = declared_int or np.all(a == np.round(a), axis=(-2, -1))
    return ints & (np.abs(a).sum(axis=axis).max(axis=-1, initial=0.0)
                   < 2 ** 22)


def empty_line(a: np.ndarray):
    """Whether some row or column of `a` is all zero: a bool for one
    matrix, a (B,) bool array for a (B, n, n) stack."""
    nz = np.asarray(a) != 0
    return ~nz.any(axis=-1).all(axis=-1) | ~nz.any(axis=-2).all(axis=-1)


def retry_scaled(a64: np.ndarray, scales: np.ndarray, axis: int, walk):
    """Walk the float64 matrix a64 scaled by 2^-scales along `axis` and
    return (total, E): walk's scaled total and the sum of the exponents
    it was walked at, so that the permanent is total * 2^E up to the
    formula's own factor.  walk(a_s) packs and walks the scaled matrix.

    A scaled sum far below 1 (2^-40) may have lost underflowed terms:
    every exponent then shifts down and the matrix is walked again, at
    most 3 walks in all (scaling is exact, so a rerun is a pure exponent
    adjustment).  The shifts are bounded cumulatively at max(1, 100 // n)
    a line, and a non-finite rerun falls back to the last finite attempt.
    """
    n = a64.shape[-1]
    best = None                 # (total, E) of the last FINITE attempt
    shifted = 0                 # cumulative per-line downshift (log2)
    shift_cap = max(1, 100 // n)   # total growth <= 2^100 across attempts
    for _ in range(3):
        # ldexp applies the exponent exactly even when 2**-s alone would
        # overflow double (lines at 2^-500 scale fine)
        with trace.timer("scales"):
            a_s = np.ldexp(a64, -np.expand_dims(scales, axis))
        total = walk(a_s)
        if not np.isfinite(total):
            break
        best = (total, int(scales.sum()))
        if total != 0.0 and abs(total) > 2.0 ** -40:
            break
        room = shift_cap - shifted
        if room <= 0:
            break
        bump = 120 if total == 0.0 else int(-np.log2(abs(total)) // n + 1)
        per_line = max(1, min(bump, room))
        scales = scales - per_line
        shifted += per_line
    return best if best is not None else (total, int(scales.sum()))
