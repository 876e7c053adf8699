"""Chunk-id layout and the single-device partial-sum launch.

Port of the single-device branch of ``superman_tpu/parallel/sharding.py``.
Every chunk costs exactly 2^r Gray steps, so an equal split is balanced by
construction; the final, exactness-critical reduction happens on the host
in float64, and for the tf96 tier as a double-double (tf96.sum_words).
The sparse engine's pruned plan goes through the weighted, block-reduced
walk (compute_total with factors).  Multi-device runs come with the rest of
the parallel layer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gray
from ..ops.ryser_cuda import ryser_amp, ryser_partials, ryser_reduced
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


def _reduced_words(ids: np.ndarray, x0: np.ndarray, cols: np.ndarray,
                   factors, plan: gray.RyserPlan, device: torch.device,
                   tier: str, sms: int):
    """The (blocks, 2) float64 host array of the block pairs of a pruned,
    factored walk.  A list of fewer live chunks than the card has thread
    slots is split into aligned sub-chunks first (gray.split_chunks), on
    the device."""
    def dev(v):
        return torch.as_tensor(v, dtype=torch.float64).to(device)

    ids_t, r = gray.split_chunks(
        torch.as_tensor(ids, dtype=torch.int64).to(device), plan.r,
        sms * gray.SPLIT_CHUNKS_PER_SM)
    fx0, fcols = factors
    out = ryser_reduced(ids_t, dev(x0), dev(cols), dev(fx0),
                        dev(fcols).contiguous(), n=plan.n, r=r, tier=tier)
    return out.cpu().numpy()


def compute_total(ids_blocks: np.ndarray, x0: np.ndarray, cols: np.ndarray,
                  plan: gray.RyserPlan, device: torch.device,
                  tier: str = "df64", factors=None,
                  sms: int = gray.DEFAULT_SMS):
    """The scaled total of the walk: the sum of compute_partials over all
    chunks, a float, or for tf96 an np.longdouble summed from the words
    (tf96.sum_words: pairwise as double-doubles).

    factors: None for the dense walk.  For the sparse engine's pruned
    plan, the (fx0, fcols) pack of the factored rows ((0,) and (n-1, 0)
    when no row is factored): ids_blocks is then the 1-D list of live
    chunk ids, x0 and cols are the alive rows' pack, the walk goes
    through ryser_reduced, split to fill `sms` SMs."""
    if factors is not None:
        words = _reduced_words(ids_blocks, x0, cols, factors, plan, device,
                               tier, sms)
        if tier == "tf96":
            return sum_words(words)
        return float(words.sum(axis=1).sum(dtype=np.float64))
    if tier == "tf96":
        return sum_words(_walk_words(ids_blocks, x0, cols, plan, device, tier))
    return float(compute_partials(ids_blocks, x0, cols, plan, device,
                                  tier).sum(dtype=np.float64))


def compute_amp(ids_blocks: np.ndarray, x0: np.ndarray, cols: np.ndarray,
                plan: gray.RyserPlan, device: torch.device,
                cond: bool = True) -> np.ndarray:
    """The amp walk over the (B, L) chunk ids: a (1, B, L) float64 host
    array of each chunk's amplitude sum, or with cond (2, B, L) with its
    conditioned amplitude sum in [1] (hi + lo of ryser_amp's words), 0
    for sentinel ids."""
    ids = torch.as_tensor(ids_blocks.reshape(-1), dtype=torch.int64)
    out = ryser_amp(ids.to(device),
                    torch.as_tensor(x0, dtype=torch.float64).to(device),
                    torch.as_tensor(cols, dtype=torch.float64).to(device),
                    n=plan.n, r=plan.r, cond=cond).cpu().numpy()
    return (out[:, 0::2] + out[:, 1::2]).T.reshape(
        (out.shape[1] // 2,) + ids_blocks.shape)
