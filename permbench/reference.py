"""The plain reference: permanents by Ryser's formula in plain PyTorch.

Independent of the program under test: nothing here imports it, and it
reads only the matrices the benchmark made.  Both functions use the
Nijenhuis-Wilf form of Ryser's formula over the subsets S of the first
n - 1 columns,

    per(A) = (-1)^(n-1) 2 sum_S (-1)^|S| prod_i (x_i + sum_{j in S} a_ij),
    x_i = a_{i,n-1} - (1/2) sum_j a_ij,

with the subsets split into a high and a low part: the low part's row
sums L (2^l subsets) are made once, the high part's H a block at a time,
and each block's terms are prod_i (H + L), so that every term is formed
from its own sums and no error carries from one term to the next.

* `perm_f64`: float64 sums and products, the terms added in a tree
  (_tree_sum) and the blocks' sums with math.fsum.  The yardstick of the
  float tiers.
* `perm_exact`: the exact integer of an integer matrix, by the same sum
  modulo primes below 2^52 and the Chinese remainder theorem.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: bits of the low part of the subsets
LOW_BITS = 20
#: terms a partial sum of perm_f64 adds one after another
FAN = 32
#: elements of the largest temporary a block makes
BLOCK_ELEMS = 1 << 28
#: primes of the exact reference lie below this; a residue times a term's
#: factor (|y| < 2^10) stays inside int64
PRIME_CEIL = 1 << 52


def _bits(start: int, stop: int, width: int, device) -> torch.Tensor:
    """(stop - start, width) float64 0/1 rows: the bits of start..stop-1."""
    s = torch.arange(start, stop, device=device, dtype=torch.int64)
    sh = torch.arange(width, device=device, dtype=torch.int64)
    return ((s[:, None] >> sh[None, :]) & 1).to(torch.float64)


def _parity_sign(bits: torch.Tensor) -> torch.Tensor:
    """(-1)^popcount of each row of a 0/1 float64 matrix."""
    return 1.0 - 2.0 * (bits.sum(dim=1) % 2)


def _split(n: int):
    """(low bits, high bits) of the n - 1 subset columns."""
    m = n - 1
    low = min(m, LOW_BITS)
    return low, m - low


def _tree_sum(x: torch.Tensor) -> float:
    """The sum of a float64 tensor by a tree of sums of FAN terms: each
    partial sums at most FAN numbers one after another, so rounding grows
    with the tree's depth, not with the count (a long dot product or
    reduction sums thousands in one chain)."""
    x = x.reshape(-1)
    while x.numel() > FAN:
        pad = -x.numel() % FAN
        if pad:
            x = torch.cat([x, x.new_zeros(pad)])
        x = x.view(-1, FAN).sum(dim=1)
    return math.fsum(x.tolist())


def perm_f64(a, device="cpu") -> float:
    """per(a) in float64 (a square matrix, n >= 1)."""
    a = torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
    n = a.shape[0]
    if n == 1:
        return float(a[0, 0])
    low, high = _split(n)
    x = a[:, n - 1] - a.sum(dim=1) / 2                       # (n,)
    bl = _bits(0, 1 << low, low, a.device)
    L = (bl @ a[:, :low].T).T.contiguous()                   # (n, 2^l)
    sign_l = _parity_sign(bl)
    per_block = max(1, BLOCK_ELEMS // ((1 << low) * n))
    parts = []
    for t0 in range(0, 1 << high, per_block):
        t1 = min(1 << high, t0 + per_block)
        bh = _bits(t0, t1, high, a.device)
        H = x[:, None] + a[:, low:n - 1] @ bh.T              # (n, B)
        # rows first in memory: the product runs down contiguous rows
        terms = (H[:, :, None] + L[:, None, :]).prod(dim=0)  # (B, 2^l)
        parts.append(_tree_sum(terms * _parity_sign(bh)[:, None]
                               * sign_l[None, :]))
    return (-1) ** (n - 1) * 2.0 * math.fsum(parts)


def _is_prime(p: int) -> bool:
    """Miller-Rabin with the first twelve primes as bases: exact below
    3.3e24."""
    if p < 2:
        return False
    bases = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
    for b in bases:
        if p % b == 0:
            return p == b
    d, s = p - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for b in bases:
        y = pow(b, d, p)
        if y in (1, p - 1):
            continue
        for _ in range(s - 1):
            y = y * y % p
            if y == p - 1:
                break
        else:
            return False
    return True


def primes_below(ceil: int, count: int) -> list:
    """The `count` largest primes below `ceil`."""
    out, c = [], ceil - 1
    while len(out) < count:
        if _is_prime(c):
            out.append(c)
        c -= 1
    return out


def _perm_mod(y_x: torch.Tensor, y_cols: torch.Tensor, p: int) -> int:
    """(-1)^(n-1) 2^(n-1) per(A) mod p, from y_x = 2x (n,) and the doubled
    columns y_cols = 2 a[:, :n-1] (n, n-1), both int64 on one device."""
    n = y_x.shape[0]
    low, high = _split(n)
    dev = y_x.device
    bl = _bits(0, 1 << low, low, dev)
    L = (bl @ y_cols[:, :low].T.to(torch.float64)).round().to(torch.int64)
    neg_l = _parity_sign(bl) < 0
    per_block = max(1, BLOCK_ELEMS // ((1 << low) * n))
    total = 0
    for t0 in range(0, 1 << high, per_block):
        t1 = min(1 << high, t0 + per_block)
        bh = _bits(t0, t1, high, dev)
        H = y_x + (bh @ y_cols[:, low:].T.to(torch.float64)
                   ).round().to(torch.int64)                 # (B, n)
        neg = (_parity_sign(bh) < 0)[:, None] ^ neg_l[None, :]
        acc = torch.remainder(H[:, None, 0] + L[None, :, 0], p)
        for i in range(1, n):
            acc = torch.remainder(acc * (H[:, None, i] + L[None, :, i]), p)
        acc = torch.where(neg, torch.remainder(-acc, p), acc)
        # sums of residues below 2^52 would pass 2^63: add 26-bit halves
        lo = int((acc & ((1 << 26) - 1)).sum())
        hi = int((acc >> 26).sum())
        total = (total + (hi << 26) + lo) % p
    return total


def perm_exact(a, device="cpu") -> int:
    """The exact permanent of an integer matrix, as a Python int."""
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.integer):
        raise ValueError("perm_exact takes integer matrices")
    n = a.shape[0]
    if n == 1:
        return int(a[0, 0])
    rows = np.abs(a).sum(axis=1)
    if (rows == 0).any():
        return 0
    if 2 * rows.max() >= 1 << 11:
        raise ValueError("perm_exact takes row sums below 2^10")
    bound_bits = sum(math.log2(int(r)) for r in rows)
    a64 = torch.as_tensor(a.astype(np.int64), device=device)
    y_x = 2 * a64[:, n - 1] - a64.sum(dim=1)
    y_cols = 2 * a64[:, : n - 1]
    primes, cover = [], 0.0
    # the product of the primes passes 2 |per| + 1
    while cover < bound_bits + 2:
        primes = primes_below(PRIME_CEIL, len(primes) + 1)
        cover = sum(math.log2(p) for p in primes)
    X, P = 0, 1
    for p in primes:
        r = _perm_mod(y_x, y_cols, p)
        # per = (-1)^(n-1) r / 2^(n-1) mod p
        r = r * pow(1 << (n - 1), -1, p) * (-1) ** (n - 1) % p
        X += P * ((r - X) * pow(P, -1, p) % p)
        P *= p
    return X - P if X > P // 2 else X
