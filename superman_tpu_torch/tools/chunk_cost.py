"""Measure what a chunk costs the sparse walk on one CUDA card, beyond its
Gray steps: the figure the sparse planner prices chunks at
(ops/pruning.C_CHUNK_S).

    python -m superman_tpu_torch.tools.chunk_cost [--tier df64] [--n 36]

Plans the seeded sparse integer matrix of chip_smoke.py (order n, density
--density, seed --seed) with the port's planner, then walks the SAME live
index set at chunk lengths r, r-1, ..., each live chunk cut into 2^shift
aligned pieces: equal live steps, 2^shift times the chunks.  Every level
is timed two ways after a warm-up, --reps times each: the reduced kernel
alone by CUDA events, and the host's wall clock around the whole of what
a plan at that chunk length would pay per walk (the id list going up from
the host, the kernel, the block pairs coming down and their sum).  Over
the levels that fill the card (at least 512 chunks per SM) a straight
line time = a + c * chunks is fitted by least squares; c is the cost of a
chunk.  Prints one JSON line: the card's name and power limit, the levels
and both fits, and under "mask" the host seconds the
exact dead mask takes per gray-space entry at a few chunk lengths (the
planner's c_mask).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from superman_tpu_torch.tools.kernel_time import smi, sparse_int_matrix


def fit_line(xs, ys):
    """Least-squares (intercept, slope) of ys over xs."""
    slope, intercept = np.polyfit(np.asarray(xs, dtype=np.float64),
                                  np.asarray(ys, dtype=np.float64), 1)
    return float(intercept), float(slope)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier", default="df64")
    ap.add_argument("--n", type=int, default=36)
    ap.add_argument("--density", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=36)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--max-chunks", type=int, default=1 << 25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chunk_cost: CUDA is not available", file=sys.stderr)
        return 2
    from superman_tpu_torch.ops import gray, pruning, ryser_cuda
    from superman_tpu_torch.ops.ryser import (K1_GITERS, _center_scales,
                                              _row_scales)

    n = args.n
    a = sparse_int_matrix(args.seed, n, args.density)
    sp = pruning.plan_sparse(a, giters=K1_GITERS[args.tier])
    if sp is None:
        print("chunk_cost: the planner declined this matrix", file=sys.stderr)
        return 1
    a = np.ascontiguousarray(a[:, sp.col_perm]).astype(np.float64)
    a_s = np.ldexp(a, -_center_scales(a, _row_scales(a))[:, None])
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    full = sms * gray.RESIDENT_CHUNKS_PER_SM

    def on_card(v):
        return torch.as_tensor(v, dtype=torch.float64).to(dev).contiguous()

    x0, cols = (on_card(v) for v in gray.pack_matrix(
        a_s[sp.alive_rows], gray.pad_n(len(sp.alive_rows))))
    fx0, fcols = (on_card(v) for v in gray.pack_matrix(
        a_s[sp.factor_rows], len(sp.factor_rows)))

    levels = []
    shift = 0
    while sp.r - shift >= 1 and len(sp.ids) << shift <= args.max_chunks:
        r = sp.r - shift
        ids_host = ((sp.ids[:, None] << shift)
                    | np.arange(1 << shift, dtype=np.int64)).reshape(-1)

        def walk_wall():
            ids = torch.as_tensor(ids_host).to(dev)
            out = ryser_cuda.ryser_reduced(ids, x0, cols, fx0, fcols, n=n,
                                           r=r, tier=args.tier)
            return float(out.cpu().numpy().sum(axis=1).sum(dtype=np.float64))

        total = walk_wall()                               # build, warm-up
        ids_dev = torch.as_tensor(ids_host).to(dev)
        kernel_ms, wall_ms = [], []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ryser_cuda.ryser_reduced(ids_dev, x0, cols, fx0, fcols, n=n, r=r,
                                     tier=args.tier)
            end.record()
            torch.cuda.synchronize()
            kernel_ms.append(start.elapsed_time(end))
            t = time.perf_counter()
            walk_wall()
            wall_ms.append((time.perf_counter() - t) * 1e3)
        levels.append({"r": r, "chunks": len(ids_host), "total": total,
                       "kernel_ms": statistics.median(kernel_ms),
                       "wall_ms": statistics.median(wall_ms)})
        shift += 1

    # the planner's other figure: what the exact dead mask costs the host
    # per entry of the gray space (2^(n-1-r) entries), by the host's clock
    mask = []
    for r in range(sp.r, max(sp.r - 8, 6), -2):
        t = time.perf_counter()
        live = pruning._live_for(a, r)
        dt = time.perf_counter() - t
        entries = 1 << (n - 1 - r)
        mask.append({"r": r, "entries": entries,
                     "live": None if live is None else len(live),
                     "seconds": dt, "seconds_per_entry": dt / entries})

    filled = [lv for lv in levels if lv["chunks"] >= full]
    fits = {}
    if len(filled) >= 2:
        for key in ("kernel_ms", "wall_ms"):
            intercept, slope = fit_line([lv["chunks"] for lv in filled],
                                        [lv[key] for lv in filled])
            fits[key] = {"intercept_ms": intercept,
                         "seconds_per_chunk": slope * 1e-3}
    card = smi()
    print(json.dumps({
        "card": card, "tier": args.tier, "n": n, "density": args.density,
        "seed": args.seed, "plan_r": sp.r, "live_chunks": len(sp.ids),
        "live_steps": len(sp.ids) << sp.r, "alive_rows": len(sp.alive_rows),
        "factored_rows": len(sp.factor_rows), "dead_frac": sp.dead_frac,
        "card_filled_from_chunks": full, "levels": levels, "fits": fits,
        "mask": mask}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
