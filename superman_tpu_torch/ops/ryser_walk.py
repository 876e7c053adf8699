"""Plain PyTorch Ryser walk, lane-vectorised, float64 by default.

Port of ``superman_tpu/ops/ryser_xla.py`` (an XLA walk in the reference,
no Pallas kernel).  Used for calc="f64" and for matrices below n=19,
where a kernel launch costs more than the walk: in float32 for
calc="f32", in float64 for every other tier, as the reference chooses.
The card's float64 is native IEEE double, so the walk runs on whatever
device it is given.
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


def ryser_walk(a: np.ndarray, device: torch.device,
               dtype: torch.dtype = torch.float64) -> float:
    """Exact permanent via the walk on `device`.  The lanes are set up
    in float64 and walked in `dtype`; the lane sums are added in float64
    on the host."""
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    if n <= 2:
        return float(perman_brute(a))
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
    return (4 * (n & 1) - 2) * total_sum
