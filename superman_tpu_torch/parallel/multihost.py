"""Multi-process work partitioning: interleaved block ownership.

Port of ``superman_tpu/parallel/multihost.py``.  There is no shared
counter across processes, so the work is split deterministically: process
p owns block rows p, p+P, p+2P, ... of the (B, L) chunk-id array.
Interleaving, not a contiguous split, balances the uneven density of live
chunks that pruning leaves.  Each process runs the one-process engine
(with its own mesh, where it has one) on its slice; the only traffic
between processes is one (hi, lo) float64 pair each, gathered over
torch.distributed (gloo) and summed in process order, so every process
returns the same value bit for bit.  Against one process the blocks are
regrouped: equal where the block sums add exactly (integer suites), within
the tier's tolerance otherwise.

Usage, in each process (torchrun sets the variables):
    WORLD_SIZE=2 RANK=p MASTER_ADDR=127.0.0.1 MASTER_PORT=... \\
        python -m superman_tpu_torch.cli -f matrix.txt
"""

from __future__ import annotations

import numpy as np

from .mesh import process_info


def host_slice(ids_blocks: np.ndarray, process_index: int,
               process_count: int) -> np.ndarray:
    """Block rows owned by this process (round-robin interleave)."""
    return ids_blocks[process_index::process_count]


def combine_host_totals(local_total):
    """Gather every process's total and sum them in process order; the
    identity for one process.

    The total travels as an (hi, lo) float64 pair, hi = f64(x) and
    lo = f64(x - hi), so a long-double tf96 total keeps its extra bits on
    the way; the sum is taken in long double on every process in the same
    order, so all agree bitwise.  Returns np.longdouble when given one."""
    was_ld = isinstance(local_total, np.longdouble)
    _, count = process_info()
    if count == 1:
        return local_total if was_ld else float(local_total)
    import torch
    import torch.distributed as dist
    ld = np.longdouble(local_total)
    hi = np.float64(ld)
    lo = np.float64(ld - np.longdouble(hi))
    mine = torch.tensor([hi, lo], dtype=torch.float64)
    parts = [torch.empty(2, dtype=torch.float64) for _ in range(count)]
    dist.all_gather(parts, mine)
    acc = np.longdouble(0.0)
    for pair in parts:
        h, l = pair.tolist()
        acc += np.longdouble(h) + np.longdouble(l)
    return acc if was_ld else float(acc)
