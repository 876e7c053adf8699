"""Chunk-id layout and the single-device partial-sum launch.

Port of the single-device branch of ``superman_tpu/parallel/sharding.py``.
Every chunk costs exactly 2^r Gray steps, so an equal split is balanced by
construction; the final, exactness-critical reduction happens on the host
in float64, and in long double for the tf96 tier.  Multi-device runs come
with the rest of the parallel layer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gray
from ..ops.ryser_cuda import ryser_partials
from ..ops.tf96 import sum_words


def pad_ids(ids: np.ndarray, lanes: int) -> np.ndarray:
    """Pad a 1-D chunk-id list with -1 sentinels (dead chunks) so it
    reshapes to (B, lanes)."""
    blocks = -(-len(ids) // lanes)
    padded = np.full(blocks * lanes, -1, dtype=np.int64)
    padded[: len(ids)] = ids
    return padded.reshape(blocks, lanes)


def _walk_words(ids_blocks: np.ndarray, x0: np.ndarray, cols: np.ndarray,
                plan: gray.RyserPlan, device: torch.device,
                tier: str) -> np.ndarray:
    """The (B * L, 2) float64 host array of the chunks' (hi, lo) words."""
    ids = torch.as_tensor(ids_blocks.reshape(-1), dtype=torch.int64)
    out = ryser_partials(ids.to(device),
                         torch.as_tensor(x0, dtype=torch.float64).to(device),
                         torch.as_tensor(cols, dtype=torch.float64).to(device),
                         n=plan.n, r=plan.r, tier=tier)
    return out.cpu().numpy().astype(np.float64)


def compute_partials(ids_blocks: np.ndarray, x0: np.ndarray, cols: np.ndarray,
                     plan: gray.RyserPlan, device: torch.device,
                     tier: str = "df64") -> np.ndarray:
    """Walk the (B, L) chunk ids on `device` in `tier` ("df64", "f32",
    "f32k" or "tf96") and return the per-chunk partial sums hi + lo as a
    (B, L) host array (0 for sentinel ids): float64, and np.longdouble for
    tf96, whose pair holds more bits than a double.

    x0 (n_pad,) and cols (n-1, n_pad) are the float64 pack
    (gray.pack_matrix)."""
    out = _walk_words(ids_blocks, x0, cols, plan, device, tier)
    if tier == "tf96":
        out = out.astype(np.longdouble)
    return (out[:, 0] + out[:, 1]).reshape(ids_blocks.shape)


def compute_total(ids_blocks: np.ndarray, x0: np.ndarray, cols: np.ndarray,
                  plan: gray.RyserPlan, device: torch.device,
                  tier: str = "df64"):
    """The scaled total of the walk: the sum of compute_partials over all
    chunks, a float, or for tf96 an np.longdouble summed from the words
    (tf96.sum_words: in long double, or exactly where long double is no
    wider than double)."""
    if tier == "tf96":
        return sum_words(_walk_words(ids_blocks, x0, cols, plan, device, tier))
    return float(compute_partials(ids_blocks, x0, cols, plan, device,
                                  tier).sum(dtype=np.float64))
