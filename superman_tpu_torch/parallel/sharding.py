"""Chunk-id layout and the walks' launches, on one device or a mesh.

Port of ``superman_tpu/parallel/sharding.py``.  Every chunk costs exactly
2^r Gray steps, so an equal split is balanced by construction.  A total
(compute_total) is summed on the card block by block and the blocks on
the host: the dense walk in df64, f32 and f32k goes through the
block-reduced entry (ryser_blocks), which makes its chunk ids on the card
from the block rows it is handed and returns one double-double (hi, lo)
pair a block of 128 chunks; the sparse engine's pruned plan goes through
the weighted, block-reduced walk (factors).  The host adds hi + lo per
block and sums the blocks in float64.  The tf96 tier keeps one pair a
chunk, all of whose words the host sums as double-doubles
(tf96.sum_words), and so do compute_partials and the hybrid scheduler,
whose callers need each chunk's value.

Over a mesh (parallel/mesh.py) the blocks are dealt round-robin: entry e
of k walks block rows e, e+k, e+2k, ... (the dense walk's (B, L) rows, or
the reduced walk's blocks of 128 chunks), on its own device and stream.
Every decision that shapes a block (the lane count, the split of a short
pruned list into sub-chunks, the padding to whole blocks) is made once,
before the blocks are dealt, and the per-chunk partials, the blocks'
pairs or the tf96 words come back into the single-device order before the
host sums them.  The result over any mesh is therefore BITWISE equal to
the single-device result, in every tier, dense and sparse.

Where its caller hands compute_total a `cards` list (mesh_cards), a
walk dealt over more than one entry has three spans (utils/trace.py) in
place of the caller's `walk` (walk_span): `mesh_launch`, every entry's
uploads, ids and launch queued on its stream; `mesh_wait`, the host
blocked until every entry's stream is done; `mesh_gather`, each entry's
words back and their interleave into the rows' order.  `cards` then
holds each entry's block rows and walk ms.  Without it (the hybrid
scheduler's device worker, several processes) the deal is unspanned,
inside the caller's `walk`.

Under SUPERMAN_DEBUG_NANS (utils/debug.py) the host array of every
walk's words is checked for NaN once they are all back, naming the
kernel and its tier: the host copy is made anyway, so the switch adds no
device work, and one check covers every mesh entry.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..ops import gray
from ..ops.ryser_cuda import (BLOCK, ryser_amp, ryser_blocks,
                              ryser_partials, ryser_reduced)
from ..ops.tf96 import sum_words
from ..utils import trace
from ..utils.debug import check_nan
from .mesh import Mesh
from .multihost import host_slice


def pad_ids(ids: np.ndarray, lanes: int) -> np.ndarray:
    """Pad a 1-D chunk-id list with -1 sentinels (dead chunks) so it
    reshapes to (B, lanes)."""
    blocks = -(-len(ids) // lanes)
    padded = np.full(blocks * lanes, -1, dtype=np.int64)
    padded[: len(ids)] = ids
    return padded.reshape(blocks, lanes)


def dealt(mesh: Optional[Mesh]) -> bool:
    """True where a walk over `mesh` is dealt over more than one entry."""
    return mesh is not None and len(mesh) > 1


def mesh_cards(mesh: Optional[Mesh]) -> Optional[list]:
    """The `cards` list a caller hands compute_total for a walk over
    `mesh`: empty where the walk is dealt, None on one device."""
    return [] if dealt(mesh) else None


def walk_span(cards: Optional[list]):
    """The span a caller opens around a walk: `walk`, or none where it
    hands the walk a `cards` list, whose deal opens its own (spans are
    leaves)."""
    return (contextlib.nullcontext() if cards is not None
            else trace.timer("walk"))


def _mark(stream):
    """A timing event recorded now on `stream`; None on the CPU."""
    if stream is None:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _deal(blocks, mesh: Optional[Mesh], device: torch.device,
          launch, cards: Optional[list] = None) -> np.ndarray:
    """Run launch(device, rows) -> (len(rows), ...) device tensor over the
    rows of `blocks` (an array of block rows of ids or of the indices of
    block rows, or a range of such indices): on `device` alone, or dealt
    round-robin over the mesh's entries, each on its own stream.  Returns
    the host array of the results in the rows' order.  A dealt walk
    handed `cards` runs under the mesh spans and adds each entry's rows
    and walk ms to cards[e] (made on the call's first deal)."""
    if not dealt(mesh):
        dev = device if mesh is None else mesh[0]
        return launch(dev, blocks).cpu().numpy()
    k = len(mesh)
    timed = cards is not None
    span = trace.timer if timed else lambda name: contextlib.nullcontext()
    mark = _mark if timed else lambda stream: None
    shares = [blocks[e::k] for e in range(k)]
    outs, marks = [], []
    with span("mesh_launch"):
        for e, share in enumerate(shares):
            with mesh.on(e):
                start = mark(mesh.streams[e])
                outs.append(launch(mesh[e], share))
                marks.append((start, mark(mesh.streams[e])))
    # the copies back run once every entry's walk is queued, so the
    # entries' walks overlap
    with span("mesh_wait"):
        mesh.synchronize()
    with span("mesh_gather"):
        parts = []
        for e in range(k):
            with mesh.on(e):
                parts.append(outs[e].cpu().numpy())
        full = np.empty((len(blocks),) + parts[0].shape[1:], parts[0].dtype)
        for e in range(k):
            full[e::k] = parts[e]
    if timed:
        if not cards:
            cards.extend({"rows": 0, "walk_ms": None if s is None else 0.0}
                         for s in mesh.streams)
        for card, share, (start, end) in zip(cards, shares, marks):
            card["rows"] += len(share)
            if start is not None:
                card["walk_ms"] += start.elapsed_time(end)
    return full


def _walk_words(ids_blocks: np.ndarray, x0: np.ndarray, cols: np.ndarray,
                plan: gray.RyserPlan, device: torch.device, tier: str,
                mesh: Optional[Mesh] = None,
                cards: Optional[list] = None) -> np.ndarray:
    """The (B * L, 2) float64 host array of the chunks' (hi, lo) words."""
    def launch(dev, rows):
        ids = torch.as_tensor(rows.reshape(-1), dtype=torch.int64)
        out = ryser_partials(
            ids.to(dev), torch.as_tensor(x0, dtype=torch.float64).to(dev),
            torch.as_tensor(cols, dtype=torch.float64).to(dev),
            n=plan.n, r=plan.r, tier=tier)
        return out.reshape(rows.shape + (2,))

    out = _deal(ids_blocks, mesh, device, launch, cards)
    check_nan(f"ryser_walk_{tier}", out)
    return out.reshape(-1, 2).astype(np.float64)


def compute_partials(ids_blocks: np.ndarray, x0: np.ndarray, cols: np.ndarray,
                     plan: gray.RyserPlan, device: torch.device,
                     tier: str = "df64", mesh: Optional[Mesh] = None
                     ) -> np.ndarray:
    """Walk the (B, L) chunk ids on `device`, or over `mesh`, in `tier`
    ("df64", "f32", "f32k" or "tf96") and return the per-chunk partial
    sums hi + lo as a (B, L) host array (0 for sentinel ids): float64, and
    np.longdouble for tf96, whose pair holds more bits than a double.

    x0 (n_pad,) and cols (n-1, n_pad) are the float64 pack
    (gray.pack_matrix)."""
    out = _walk_words(ids_blocks, x0, cols, plan, device, tier, mesh)
    if tier == "tf96":
        out = out.astype(np.longdouble)
    return (out[:, 0] + out[:, 1]).reshape(ids_blocks.shape)


def split_rows(live: torch.Tensor, shift: int, rows: torch.Tensor
               ) -> torch.Tensor:
    """The chunk ids of block rows `rows` of a pruned list split for the
    reduced walk: each live chunk cut into 2^shift aligned sub-chunks
    (what gray.split_chunks gives, in its order), the list padded with -1
    to whole blocks of BLOCK, row b holding its entries BLOCK*b ..
    BLOCK*(b+1)-1.  Made on the device of `live` from the live list alone,
    so that no split list crosses to the card.  live: (C,) int64; rows:
    1-D int64 on the same device.  Returns (len(rows) * BLOCK,) int64."""
    q = rows[:, None] * BLOCK + torch.arange(BLOCK, device=live.device)
    valid = q < live.numel() << shift
    q = torch.where(valid, q, 0)
    ids = (live[q >> shift] << shift) | (q & ((1 << shift) - 1))
    return torch.where(valid, ids, -1).reshape(-1)


def _dense_rows(plan: gray.RyserPlan, host: tuple) -> range:
    """This process's share of the dense walk's block rows: the rows of
    pad_ids(every chunk id, plan.lanes), dealt by multihost.host_slice.  A
    range, as is every share _deal makes of it, so a device makes its
    rows itself."""
    return host_slice(range(-(-plan.num_chunks // plan.lanes)), *host)


def _reduced_rows(live: int, r: int, want: int, host: tuple):
    """(shift, rows): the split of a pruned list of `live` chunks of 2^r
    steps into at least `want` chunks (gray.split_shift), and this
    process's share of its blocks of BLOCK."""
    shift = gray.split_shift(live, r, want)
    nblocks = -(-(live << shift) // BLOCK)
    return shift, host_slice(np.arange(nblocks, dtype=np.int64), *host)


def total_words(plan: gray.RyserPlan, tier: str = "df64",
                live: Optional[int] = None, sms: int = gray.DEFAULT_SMS,
                host: tuple = (0, 1)) -> int:
    """The (hi, lo) pairs that compute_total brings back to this process
    and sums: one a block of 128 chunks of the dense walk or, with `live`,
    of the split pruned list of that many chunks; one a chunk slot of the
    dense walk in tf96."""
    if live is not None:
        want = sms * gray.SPLIT_CHUNKS_PER_SM
        return len(_reduced_rows(live, plan.r, want, host)[1])
    per_row = plan.lanes if tier == "tf96" else -(-plan.lanes // BLOCK)
    return len(_dense_rows(plan, host)) * per_row


def _block_words(x0: np.ndarray, cols: np.ndarray, plan: gray.RyserPlan,
                 device: torch.device, tier: str,
                 mesh: Optional[Mesh] = None,
                 host: tuple = (0, 1),
                 cards: Optional[list] = None) -> np.ndarray:
    """The (blocks, 2) float64 host array of the dense walk's block pairs
    (ryser_blocks): this process's share of the block rows, in their
    order, ceil(lanes / 128) blocks a row."""
    rows = _dense_rows(plan, host)
    per_row = -(-plan.lanes // BLOCK)
    if not len(rows):
        return np.zeros((0, 2))

    # x0 and the columns go up in one copy
    pack = np.concatenate([x0[None], cols])

    def launch(dev, rows_e):
        packed = torch.as_tensor(pack).to(dev)
        rows_t = torch.arange(rows_e.start, rows_e.stop, rows_e.step,
                              dtype=torch.int64, device=dev)
        out = ryser_blocks(rows_t, packed[0], packed[1:], n=plan.n, r=plan.r,
                           lanes=plan.lanes, num_chunks=plan.num_chunks,
                           tier=tier)
        return out.reshape(len(rows_e), per_row, 2)

    words = _deal(rows, mesh, device, launch, cards).reshape(-1, 2)
    check_nan(f"ryser_walk_blocks ({tier})", words)
    return words


def _reduced_words(ids: np.ndarray, x0: np.ndarray, cols: np.ndarray,
                   factors, plan: gray.RyserPlan, device: torch.device,
                   tier: str, want: int, mesh: Optional[Mesh] = None,
                   host: tuple = (0, 1),
                   cards: Optional[list] = None) -> np.ndarray:
    """The (blocks, 2) float64 host array of the block pairs of a pruned,
    factored walk of the live ids, split to at least `want` chunks
    (gray.split_shift): this process's share of the blocks
    (multihost.host_slice), in their order."""
    shift, rows = _reduced_rows(len(ids), plan.r, want, host)
    if not len(rows):
        return np.zeros((0, 2))
    fx0, fcols = factors

    def launch(dev, rows_e):
        def on(v):
            return torch.as_tensor(v).to(dev)

        split = split_rows(on(ids), shift, on(rows_e))
        return ryser_reduced(split, on(x0), on(cols), on(fx0),
                             on(fcols).contiguous(), n=plan.n,
                             r=plan.r - shift, tier=tier)

    words = _deal(rows, mesh, device, launch, cards)
    check_nan(f"ryser_walk_reduced ({tier})", words)
    return words


def compute_total(x0: np.ndarray, cols: np.ndarray, plan: gray.RyserPlan,
                  device: torch.device, tier: str = "df64", *,
                  sparse: Optional[tuple] = None,
                  sms: int = gray.DEFAULT_SMS, mesh: Optional[Mesh] = None,
                  host: tuple = (0, 1), cards: Optional[list] = None):
    """The scaled total of the walk: the sum over all chunks of what
    compute_partials gives each, a float, or for tf96 an np.longdouble
    summed from the words (tf96.sum_words: pairwise as double-doubles).

    sparse: None for the dense walk of the whole plan: the chunk ids are
    made on the card from the block rows of pad_ids(every chunk id,
    plan.lanes), and in df64, f32 and f32k each block of 128 chunks comes
    back as one pair (ryser_blocks), summed on the host in float64 in the
    rows' order.  For the sparse engine's pruned plan, (ids, fx0, fcols):
    the 1-D list of live chunk ids and the pack of the factored rows ((0,)
    and (n-1, 0) when no row is factored); x0 and cols are then the alive
    rows' pack, and the walk goes through ryser_reduced, the list split to
    fill `sms` SMs.
    mesh: deal the blocks over these entries (bitwise the same total).
    cards: a list (mesh_cards) that takes a dealt walk's per-entry rows
    and walk ms, the deal then running under the mesh spans; None deals
    it unspanned.
    host: (index, count) of this process; it walks its interleaved share
    of the blocks (multihost.host_slice) and returns its part of the
    total.  total_words says how many pairs the host sums."""
    zero = np.longdouble(0.0) if tier == "tf96" else 0.0
    if sparse is not None:
        ids, *factors = sparse
        words = _reduced_words(np.asarray(ids, dtype=np.int64), x0, cols,
                               factors, plan, device, tier,
                               sms * gray.SPLIT_CHUNKS_PER_SM, mesh, host,
                               cards)
    elif tier == "tf96":
        ids_blocks = host_slice(
            pad_ids(np.arange(plan.num_chunks, dtype=np.int64), plan.lanes),
            *host)
        words = (_walk_words(ids_blocks, x0, cols, plan, device, tier, mesh,
                             cards)
                 if len(ids_blocks) else np.zeros((0, 2)))
    else:
        words = _block_words(x0, cols, plan, device, tier, mesh, host,
                             cards)
    if not len(words):
        return zero
    if tier == "tf96":
        return sum_words(words)
    return float(words.sum(axis=1).sum(dtype=np.float64))


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
    check_nan("ryser_walk_amp_cond" if cond else "ryser_walk_amp", out)
    return (out[:, 0::2] + out[:, 1::2]).T.reshape(
        (out.shape[1] // 2,) + ids_blocks.shape)
