"""Z_p Ryser walk: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas walk of ``superman_tpu/ops/modp.py``
(``_mod_partials_jit``'s ``pl.pallas_call``, bodies ``_walk_mod_scalar``
and ``_walk_mod_u16``, prologue ``chunk_init_mod``).  The kernel is
``csrc/modp_walk.cu``: one thread walks one aligned chunk of 2^r Gray
steps in Z_p and writes that chunk's signed sum as a canonical residue
in [0, p).

The TPU walked primes p <= 2039 as lazy f32 residues; the card walks
any odd p < 2^31 in 32-bit Montgomery arithmetic.  Every output is a
canonical residue, so kernel and plain version agree exactly, whatever
order either multiplies in.  Residues are integers and cannot be NaN, so
SUPERMAN_DEBUG_NANS (utils/debug.py) checks nothing here.
"""

from __future__ import annotations

import torch

from ..csrc.build import call, on_card
from . import gray

#: the kernel is instantiated for n_pad = 8, 16, ..., MAX_N_PAD
MAX_N_PAD = 64

#: moduli are odd and below this bound: residues and their sums x + c
#: stay below 2^32, and products of two residues below 2^62 (exact in
#: torch int64 for the plain version)
P_LIMIT = 1 << 31


def check_modulus(p: int) -> None:
    if not (3 <= p < P_LIMIT and p % 2 == 1):
        raise ValueError(f"modulus p={p} must be odd and in [3, 2^31)")


def montgomery_constants(p: int):
    """(-p^-1 mod 2^32, 2^64 mod p): the kernel's Montgomery constants
    for R = 2^32."""
    return (-pow(p, -1, 1 << 32)) % (1 << 32), (1 << 64) % p


def _check(ids, x0, cols, p: int, n: int, r: int) -> None:
    check_modulus(p)
    for name, t in (("ids", ids), ("x0", x0), ("cols", cols)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be torch.int64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != ids.device:
            raise ValueError(f"{name} is on {t.device}, ids on {ids.device}")
    if ids.dim() != 1 or x0.dim() != 1:
        raise ValueError("ids and x0 must be 1-D")
    n_pad = x0.shape[0]
    if n_pad % 8 or not 8 <= n_pad <= MAX_N_PAD:
        raise ValueError(f"n_pad={n_pad} must be a multiple of 8 in "
                         f"[8, {MAX_N_PAD}]")
    if not 2 <= n <= n_pad:
        raise ValueError(f"n={n} must lie in [2, n_pad={n_pad}]")
    if tuple(cols.shape) != (n - 1, n_pad):
        raise ValueError(f"cols must be ({n - 1}, {n_pad}), got "
                         f"{tuple(cols.shape)}")
    if not 1 <= r <= n - 1:
        raise ValueError(f"r={r} must lie in [1, n-1={n - 1}]")
    for name, t in (("x0", x0), ("cols", cols)):
        if bool(((t < 0) | (t >= p)).any()):
            raise ValueError(f"{name} must hold residues in [0, p={p})")


def mod_partials(ids: torch.Tensor, x0: torch.Tensor, cols: torch.Tensor,
                 p: int, *, n: int, r: int) -> torch.Tensor:
    """Per-chunk signed sums of the Gray walk in Z_p.

    ids:  (C,) int64 chunk ids in [0, 2^(n-1-r)); ids < 0 are sentinels
          whose sum is 0.
    x0:   (n_pad,) int64 initial x in [0, p), padding rows 1 (pack_mod).
    cols: (n-1, n_pad) int64 matrix columns in [0, p), padding 0.
    p:    odd modulus in [3, 2^31).
    Returns (C,) int64 residues in [0, p).

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU
    tensor runs the plain version.
    """
    _check(ids, x0, cols, p, n, r)
    if not on_card(ids):
        return mod_partials_ref(ids, x0, cols, p, n=n, r=r)
    out = torch.empty(ids.shape[0], dtype=torch.int64, device=ids.device)
    if ids.shape[0]:
        call("modp_walk", ids, ids.shape[0], x0, cols, n, x0.shape[0], r, p,
             *montgomery_constants(p), out, device=ids.device,
             count=("modp", None))
    return out


def tree_prod_mod(x: torch.Tensor, p: int) -> torch.Tensor:
    """Product over dim 1 mod p, folding the upper half onto the lower
    and reducing at every level (products stay below 2^62)."""
    s = x.shape[1]
    while s > 1:
        ns, h = (s + 1) // 2, s // 2
        x = torch.cat([torch.remainder(x[:, :h] * x[:, ns:s], p),
                       x[:, h:ns]], dim=1)
        s = ns
    return x[:, 0]


def mod_partials_ref(ids: torch.Tensor, x0: torch.Tensor,
                     cols: torch.Tensor, p: int, *, n: int,
                     r: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: int64, vectorised over
    chunks, one Python step per Gray index m, the same step rule."""
    dead = ids < 0
    l = torch.where(dead, 0, ids)
    bits = gray.chunk_gray_bits(l, n, r)                      # (C, n-1)
    x = x0.expand(l.shape[0], x0.shape[0])
    for k in range(n - 1):
        x = x + bits[:, k:k + 1] * cols[k]
    x = torch.remainder(x, p)
    sign_mid = (1 - 2 * (l & 1))[:, None]
    acc = tree_prod_mod(x, p)                    # m = 0 term, sign +1
    for m in range(1, 1 << r):
        k = (m & -m).bit_length() - 1
        if k == r - 1:
            s = sign_mid                   # mid step: the chunk parity
        else:
            s = -1 if (m >> (k + 1)) & 1 else 1
        x = torch.remainder(x + s * cols[k], p)
        t = tree_prod_mod(x, p)
        acc = torch.remainder(acc - t if m & 1 else acc + t, p)
    return torch.where(dead, 0, acc)
