"""Compensated (double-double) arithmetic on float64 values.

The JAX package carries its df64 tier as f32 pairs because the TPU has no
FP64 (``superman_tpu/ops/df64.py``).  The card has native IEEE double, so
the port keeps x and each product in float64 and only the ACCUMULATOR as a
(hi, lo) float64 pair.  These helpers are the plain versions of what the
CUDA kernel does per thread (csrc/ryser_walk.cu); they work on tensors
and numpy arrays alike.  Add-only, so FMA contraction cannot change them.
"""

from __future__ import annotations

import numpy as np


def two_sum(a, b):
    """Knuth TwoSum: a + b = s + e exactly (6 flops)."""
    s = a + b
    z = s - a
    e = (a - (s - z)) + (b - z)
    return s, e


def quick_two_sum(a, b):
    """Dekker FastTwoSum, requires |a| >= |b| (3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def df_add_f64(ahi, alo, b):
    """(ahi, alo) + b for a double-double (ahi, alo) and a double b:
    the reference's ``df_add`` with a zero low word on b."""
    s, e = two_sum(ahi, b)
    e = e + alo
    return quick_two_sum(s, e)


def join_f64(hi, lo):
    """Recombine a (hi, lo) pair of float32 arrays into float64 (host)."""
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)
