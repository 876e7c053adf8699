"""The Z_p walk's rate on the card (K3, csrc/modp_walk.cu), against its
operation ledger and the card's int32 peak.

The port of superman_tpu/tools/modp_rate.py.  It walks one seeded core
(entries 0..49, order --n) at the two largest 31-bit primes through
ops.modp.perman_core_mod, as the exact engine walks each prime: a cold
walk (the kernels' build and first launch), then --reps warm walks, each
timed by the host clock around the call (packing, launch, the residues'
copy back and their sum).  Then the kernel alone on the same pack and
plan, timed as tools/kernel_time.py times it.

The ledger is the port's 31-bit Montgomery step, not the TPU's lazy f32
step: a Z_p Gray step takes n modular adds to update x (an add and a
conditional subtract each), n - 1 Montgomery products for the product
tree (three multiplies and three more operations each) and one modular
add into the accumulator: 2n + 6(n - 1) + 2 int32 operations, the count
behind chip_smoke.py's K3 bound.  Prints one JSON line: the per-prime
wall and G Gray iters/s, the kernel's ms and G iters/s, its int32
operations per second and their share of the card's int32 peak
(kernel_time.PEAK; none on the CPU), and the CRT bits per second at
31-bit primes: the bits of a residue over the per-prime wall at order n.

    python -m superman_tpu_torch.tools.modp_rate [--n 32] [--r R]
        [--reps 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import platform
import statistics
import sys
import time

import numpy as np

from . import tool_device


def ledger_ops_per_step(n: int) -> dict:
    """int32 operations of one Gray step of the Z_p walk at order n."""
    x_update = 2 * n              # add + conditional subtract, per row
    tree = 6 * (n - 1)            # Montgomery product: 3 mul + 3 more
    acc = 2                       # the accumulator's modular add
    return {"x_update": x_update, "tree": tree, "acc": acc,
            "total": x_update + tree + acc}


def measure(n: int = 32, r: int = None, reps: int = 3, seed: int = 0,
            device=None, log=print) -> dict:
    """The walls, the kernel's time and the ledger's rates (module
    docstring) as one dict."""
    dev = tool_device(device)
    import torch

    from ..ops import exact, gray, modp, modp_cuda
    from ..ops.ryser import _sm_count
    from .kernel_time import PEAK, smi, time_launches

    on_card = dev.type == "cuda"
    rng = np.random.default_rng(seed)
    core = [[int(v) for v in row] for row in rng.integers(0, 50, (n, n))]
    primes = exact.primes_desc(2, start=modp.PRIME_CEIL)
    walls = []
    for i, q in enumerate([primes[0]] + [primes[i % 2]
                                         for i in range(reps)]):
        t0 = time.perf_counter()
        res = modp.perman_core_mod(core, q, dev, r=r)
        w = time.perf_counter() - t0
        if i == 0:
            log(f"cold walk (build, first launch): {w:.3f} s")
            continue
        walls.append(w)
        log(f"warm walk p={q}: {w:.4f} s res={res}")

    if r is None:
        r = gray.make_plan(n, sms=_sm_count(dev)).r
    p0 = primes[0]
    x0, cols = (t.to(dev) for t in modp.pack_mod(
        modp.reduce_core_mod(core, p0), p0, gray.pad_n(n)))
    ids = torch.arange(1 << max(0, n - 1 - r), device=dev)

    def launch():
        return modp_cuda.mod_partials(ids, x0, cols, p0, n=n, r=r)

    launch()                                              # warm-up
    if on_card:
        torch.cuda.synchronize()
    times, _ = time_launches(launch, max(3, reps), on_card)
    kernel_ms = statistics.median(times)

    steps = 1 << (n - 1)
    led = ledger_ops_per_step(n)
    rate = steps / min(walls)
    ops_s = steps * led["total"] / (kernel_ms * 1e-3)
    return {"metric": "modp_g_iters_per_sec", "value": rate / 1e9,
            "card": smi() if on_card else
            f"host {platform.processor() or platform.machine()}",
            "device": str(dev), "n": n, "r": r, "n_pad": gray.pad_n(n),
            "prime_wall_s": min(walls), "prime_walls_s": walls,
            "kernel_ms": kernel_ms,
            "kernel_g_iters_per_sec": steps / kernel_ms / 1e6,
            "ledger_int32_ops_per_step": led, "int32_tops": ops_s / 1e12,
            "int32_peak_share": ops_s / PEAK["int32"] if on_card else None,
            "crt_bits_per_sec": math.log2(p0) / min(walls)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="superman-torch-modp-rate",
                                description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--r", type=int, default=None,
                   help="log2 chunk length (default: the card planner's)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    args = p.parse_args(argv)
    print(json.dumps(measure(args.n, args.r, args.reps, args.seed,
                             args.device,
                             log=lambda s: print(s, flush=True))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
