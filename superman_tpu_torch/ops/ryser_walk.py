"""Plain PyTorch float64 Ryser walk, lane-vectorised.

Port of ``superman_tpu/ops/ryser_xla.py`` (an XLA walk in the reference,
no Pallas kernel).  Used for calc="f64" and for matrices below n=19,
where a kernel launch costs more than the walk.  The card's float64 is
native IEEE double, so the walk runs on whatever device it is given.
"""

from __future__ import annotations

import numpy as np
import torch

from .oracle import gray_init_lanes, perman_brute


#: lanes of the walk (the reference's ryser_xla default)
MAX_LANES = 1 << 13


def ryser_walk(a: np.ndarray, device: torch.device) -> float:
    """Exact permanent via the float64 walk on `device`."""
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    if n <= 2:
        return float(perman_brute(a))
    total = 1 << (n - 1)
    C = min(total >> 1, MAX_LANES)
    r = (total // C).bit_length() - 1
    X, sign_mid = gray_init_lanes(a, np.arange(C, dtype=np.int64), r,
                                  dtype=np.float64)
    X = torch.as_tensor(X, device=device)
    sign_mid = torch.as_tensor(sign_mid, device=device)
    cols = torch.as_tensor(np.ascontiguousarray(a[:, : n - 1].T),
                           device=device)
    acc = torch.prod(X, dim=1)                 # m = 0 terms, sign +1
    for m in range(1, 1 << r):
        k = (m & -m).bit_length() - 1
        if k == r - 1:
            s = sign_mid[:, None]          # mid step: the lane parity
        else:
            s = 1.0 - 2.0 * ((m >> (k + 1)) & 1)
        X = X + s * cols[k]
        acc = acc + (1.0 - 2.0 * (m & 1)) * torch.prod(X, dim=1)
    total_sum = float(np.sum(acc.cpu().numpy()))
    return (4 * (n & 1) - 2) * total_sum
