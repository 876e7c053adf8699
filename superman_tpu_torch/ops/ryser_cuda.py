"""Ryser walk, df64 tier: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas walk of ``superman_tpu/ops/ryser_pallas.py``
(``_partials_jit``'s ``pl.pallas_call``, bodies ``_walk_scalar`` and
``_walk_u16``) for the df64 tier.  The kernel is ``csrc/ryser_walk.cu``:
one thread walks one aligned chunk of 2^r Gray steps and writes that
chunk's signed partial sum as a (hi, lo) float64 pair.

x and every product are native float64 on the card (the TPU carried them
as f32 pairs); the accumulator is a compensated double-double.  The
plain version below computes the same function with the same operation
order, so on a card the two agree to the last bit on any input where
nvcc keeps IEEE order (no fast-math; the only contractible multiply,
s * col with s = +-1, is exact).
"""

from __future__ import annotations

import torch

from . import gray
from .df64 import df_add_f64

#: kernel launches made by ryser_partials; a run reads it to show that the
#: main path went through the kernel
LAUNCHES = 0

#: the kernel is instantiated for n_pad = 8, 16, ..., MAX_N_PAD
MAX_N_PAD = 64


def _check(ids, x0, cols, n: int, r: int) -> None:
    for name, t, dt in (("ids", ids, torch.int64), ("x0", x0, torch.float64),
                        ("cols", cols, torch.float64)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
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
    if not 3 <= n <= n_pad:
        raise ValueError(f"n={n} must lie in [3, n_pad={n_pad}]")
    if tuple(cols.shape) != (n - 1, n_pad):
        raise ValueError(f"cols must be ({n - 1}, {n_pad}), got "
                         f"{tuple(cols.shape)}")
    if not 1 <= r <= n - 2:
        raise ValueError(f"r={r} must lie in [1, n-2={n - 2}]")


def ryser_partials(ids: torch.Tensor, x0: torch.Tensor, cols: torch.Tensor,
                   *, n: int, r: int) -> torch.Tensor:
    """Per-chunk signed partial sums of the Gray walk.

    ids:  (C,) int64 chunk ids in [0, 2^(n-1-r)); ids < 0 are sentinels
          whose partial is 0.
    x0:   (n_pad,) float64 initial x, padding rows 1 (gray.pack_matrix).
    cols: (n-1, n_pad) float64 matrix columns, padding 0.
    Returns (C, 2) float64: hi and lo of each chunk's partial sum.

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU
    tensor runs the plain version.
    """
    _check(ids, x0, cols, n, r)
    if ids.device.type == "cpu":
        return ryser_partials_ref(ids, x0, cols, n=n, r=r)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    return _launch(ids, x0, cols, n, r)


def _launch(ids, x0, cols, n: int, r: int) -> torch.Tensor:
    global LAUNCHES
    from ..csrc.build import load
    lib = load()
    out = torch.empty((ids.shape[0], 2), dtype=torch.float64,
                      device=ids.device)
    if ids.shape[0] == 0:
        return out
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    rc = lib.ryser_walk_df64(
        ids.data_ptr(), ids.shape[0], x0.data_ptr(), cols.data_ptr(),
        n, x0.shape[0], r, out.data_ptr(), ids.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"ryser_walk_df64 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def tree_prod(x: torch.Tensor) -> torch.Tensor:
    """Product over dim 1 in the kernel's order: fold the upper half onto
    the lower (p[i] *= p[i + ceil(s/2)]) until one row is left."""
    s = x.shape[1]
    while s > 1:
        ns, h = (s + 1) // 2, s // 2
        x = torch.cat([x[:, :h] * x[:, ns:s], x[:, h:ns]], dim=1)
        s = ns
    return x[:, 0]


def ryser_partials_ref(ids: torch.Tensor, x0: torch.Tensor,
                       cols: torch.Tensor, *, n: int, r: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: vectorised over chunks, one
    Python step per Gray index m, the same step rule and accumulator."""
    x, sign_mid = gray.chunk_init(ids, x0, cols, n, r)
    hi = tree_prod(x)
    lo = torch.zeros_like(hi)
    for m in range(1, 1 << r):
        k = (m & -m).bit_length() - 1
        if k == r - 1:
            s = sign_mid[:, None]          # mid step: the chunk parity
        else:
            s = -1.0 if (m >> (k + 1)) & 1 else 1.0
        x = x + s * cols[k]
        t = tree_prod(x)
        hi, lo = df_add_f64(hi, lo, -t if m & 1 else t)
    out = torch.stack([hi, lo], dim=1)
    return torch.where((ids < 0)[:, None], 0.0, out)
