"""The tf96 tier's arithmetic: double-double products and sums on float64.

The counterpart of ``superman_tpu/ops/tf96.py``.  The JAX package carries
the tier as f32 triples (~72 bits) because the TPU has no FP64; the card
has native double and a fused multiply-add, so here the tier is a
double-double: a pair (hi, lo) of float64 words, value hi + lo, ~104
bits.  It computes what the reference's tier computes (a Ryser term and
its running sum to better than 2^-70 on exact x) and is not the
reference's word layout.

These are the plain versions of what the CUDA walk does per thread in
its tf96 tier (csrc/walk.cuh: two_prod, dd_mul_unnorm, dd_mul,
tree_prod_dd, and acc_merge for the sum).  They take torch tensors, on
the CPU or a card, and repeat the kernel's operations one by one, so
kernel and plain version agree to the last bit:

* The kernel forms the error of a product with one fused multiply-add,
  e = fma(a, b, -p).  PyTorch has none on the CPU, so two_prod here
  splits both factors (Veltkamp) and sums Dekker's partial products;
  every step of that is exact, so it yields the same e, as long as
  nothing overflows (|a|, |b| < 2^996) and the error term does not
  underflow (|p| > 2^-960).  The engines scale rows (or columns) by
  powers of two so that |x| <~ 1 along the walk, far from either.
* Everything else is single multiplies and adds in a fixed order; the
  kernel writes them with __dmul_rn / __dadd_rn so the compiler cannot
  fuse a pair of them into an FMA that this file could not repeat.
"""

from __future__ import annotations

import numpy as np
import torch

from .df64 import quick_two_sum, two_sum

#: Veltkamp's splitter for float64: 2^27 + 1
SPLITTER = 134217729.0
#: whether np.longdouble carries more than a double (x87: 63 explicit
#: mantissa bits), so that a total keeps bits below a double until the
#: engine's last rounding
LONGDOUBLE_WIDE = np.finfo(np.longdouble).nmant > 52


def split(a):
    """Veltkamp split: a = hi + lo with hi, lo of at most 26 bits each."""
    t = a * SPLITTER
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """a * b = p + e exactly (Dekker); equals (a*b, fma(a, b, -a*b))."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_mul_unnorm(ahi, alo, bhi, blo):
    """(ahi, alo) * (bhi, blo) -> (hi, lo) left un-normalised, relative
    error a few 2^-106 on normalised or un-normalised operands: the exact
    product of the high words, the two cross terms rounded and added to
    its error, alo * blo dropped.  lo may exceed ulp(hi) / 2."""
    p, e = two_prod(ahi, bhi)
    return p, e + (ahi * blo + alo * bhi)


def dd_mul(ahi, alo, bhi, blo):
    """(ahi, alo) * (bhi, blo) -> (hi, lo), normalised: dd_mul_unnorm,
    then a FastTwoSum."""
    return quick_two_sum(*dd_mul_unnorm(ahi, alo, bhi, blo))


def dd_add(ahi, alo, bhi, blo):
    """(ahi, alo) + (bhi, blo) -> (hi, lo): TwoSum of the high words, the
    low words folded in, then a FastTwoSum.  The absolute error is ~2^-105
    of the larger operand, which is what a running sum of terms needs."""
    s, e = two_sum(ahi, bhi)
    return quick_two_sum(s, e + (alo + blo))


def tree_prod_dd(x: torch.Tensor):
    """Product over the last dim of exact float64 values as a (hi, lo)
    pair, in the kernel's order: fold the upper half onto the lower
    (p[i] *= p[i + ceil(s/2)]) until one is left.  The first level
    multiplies plain doubles, exactly (two_prod); the rest are
    dd_mul_unnorm, and the root is normalised once (FastTwoSum).  The
    last dim must be even (the packs' n_pad is a multiple of 8)."""
    s = x.shape[-1]
    if s % 2:
        raise ValueError(f"the last dim must be even, got {s}")
    s //= 2
    hi, lo = two_prod(x[..., :s], x[..., s:])
    while s > 1:
        ns, h = (s + 1) // 2, s // 2
        phi, plo = dd_mul_unnorm(hi[..., :h], lo[..., :h],
                                 hi[..., ns:s], lo[..., ns:s])
        if h != ns:                     # odd level: the middle one waits
            phi = torch.cat([phi, hi[..., h:ns]], dim=-1)
            plo = torch.cat([plo, lo[..., h:ns]], dim=-1)
        hi, lo, s = phi, plo, ns
    return quick_two_sum(hi[..., 0], lo[..., 0])


def sum_words(words: np.ndarray) -> np.ndarray:
    """Host reduction of the tier: words is (..., C, 2) float64, the
    (hi, lo) pairs of C partial sums; returns their total as np.longdouble
    of shape (...).  The pairs are added as double-doubles (dd_add) in a
    fixed halving order, which errs by ~log2(C) 2^-105 of the partials'
    magnitudes, and the last pair is joined in long double.  A long-double
    sum of the words (the reference's reduction) errs by ~2^-64 of them,
    which chip_smoke.py's cancelling matrix (partials ~7e7 above the
    permanent) shows: there it misses the exact integer by ~5e-13."""
    words = np.asarray(words, dtype=np.float64)
    hi, lo = words[..., 0], words[..., 1]
    if hi.shape[-1] == 0:
        return np.zeros(hi.shape[:-1], dtype=np.longdouble)
    while hi.shape[-1] > 1:
        c = hi.shape[-1]
        h = c // 2
        shi, slo = dd_add(hi[..., :h], lo[..., :h], hi[..., h:2 * h],
                          lo[..., h:2 * h])
        if c % 2:                       # odd count: the last one waits
            shi = np.concatenate([shi, hi[..., 2 * h:]], axis=-1)
            slo = np.concatenate([slo, lo[..., 2 * h:]], axis=-1)
        hi, lo = shi, slo
    return hi[..., 0].astype(np.longdouble) + lo[..., 0]
