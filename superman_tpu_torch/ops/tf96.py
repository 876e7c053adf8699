"""The tf96 tier's arithmetic: double-double products and sums on float64.

The counterpart of ``superman_tpu/ops/tf96.py``.  The JAX package carries
the tier as f32 triples (~72 bits) because the TPU has no FP64; the card
has native double and a fused multiply-add, so here the tier is a
double-double: a pair (hi, lo) of float64 words, value hi + lo, ~104
bits.  It computes what the reference's tier computes (a Ryser term and
its running sum to better than 2^-70 on exact x) and is not the
reference's word layout.

These are the plain versions of what the CUDA walk does per thread in
its tf96 tier (csrc/walk.cuh: two_prod, dd_mul, tree_prod_dd, and
acc_merge for the sum).  They take torch tensors, on the CPU or a card,
and repeat the kernel's operations one by one, so kernel and plain
version agree to the last bit:

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

import math

import numpy as np
import torch

from .df64 import quick_two_sum, two_sum

#: Veltkamp's splitter for float64: 2^27 + 1
SPLITTER = 134217729.0
#: whether np.longdouble carries more than a double (x87: 63 explicit
#: mantissa bits).  Where it does not, sum_words adds exactly instead.
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


def dd_mul(ahi, alo, bhi, blo):
    """(ahi, alo) * (bhi, blo) -> (hi, lo), relative error a few 2^-106:
    the exact product of the high words, the two cross terms rounded,
    alo * blo dropped, then a FastTwoSum."""
    p, e = two_prod(ahi, bhi)
    e = e + (ahi * blo + alo * bhi)
    return quick_two_sum(p, e)


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
    multiplies plain doubles, exactly (two_prod); the rest are dd_mul.
    The last dim must be even (the packs' n_pad is a multiple of 8)."""
    s = x.shape[-1]
    if s % 2:
        raise ValueError(f"the last dim must be even, got {s}")
    s //= 2
    hi, lo = two_prod(x[..., :s], x[..., s:])
    while s > 1:
        ns, h = (s + 1) // 2, s // 2
        phi, plo = dd_mul(hi[..., :h], lo[..., :h],
                          hi[..., ns:s], lo[..., ns:s])
        if h != ns:                     # odd level: the middle one waits
            phi = torch.cat([phi, hi[..., h:ns]], dim=-1)
            plo = torch.cat([plo, lo[..., h:ns]], dim=-1)
        hi, lo, s = phi, plo, ns
    return hi[..., 0], lo[..., 0]


def sum_words(words: np.ndarray) -> np.ndarray:
    """Host reduction of the tier: words is (..., C, 2) float64, the
    (hi, lo) pairs of C partial sums; returns their total as np.longdouble
    of shape (...).  Summed in long double where that is wider than a
    double (the reference's reduction); elsewhere every word is added
    exactly (math.fsum), so the tier does not quietly end at double."""
    words = np.asarray(words, dtype=np.float64)
    if LONGDOUBLE_WIDE:
        return words.astype(np.longdouble).sum(axis=(-2, -1))
    flat = words.reshape(-1, words.shape[-2] * 2)
    return np.array([math.fsum(row) for row in flat],
                    dtype=np.longdouble).reshape(words.shape[:-2])
