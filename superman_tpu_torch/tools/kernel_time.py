"""Time one walk kernel alone on one CUDA card, or its plain version on
the CPU.

    python -m superman_tpu_torch.tools.kernel_time [--tier df64] [--n 32]
        [--device cuda|cpu]

Walks the whole default plan of a seeded integer matrix of order n
(entries 1-4, density 0.5, seed n: at n=32 the matrix of chip_smoke.py)
in one tier: K1's df64, f32, f32k or tf96 (ryser_walk_*), the amp walk
with the amplitude alone (amp) or with the conditioned term (amp_cond),
or the Z_p walk K3 at p = 2^31 - 1 (modp).  It times each of --reps
launches after a warm-up, by CUDA events on the card and by the host
clock on the CPU (the plain version; keep n small there, ~24), and
prints one JSON line: the card's name and power limit (or the host's
processor and torch's thread count), the median and the least time, the
rate in G Gray steps/s, and a checksum of the partials (their exact
sum), so that two checkouts can be compared in one run on one card:

    PYTHONPATH=<other checkout> python superman_tpu_torch/tools/kernel_time.py

imports the package of the other checkout and builds its kernels there.
A checkout whose ryser_amp has no `cond` argument has one amp walk, the
conditioned one: it is timed as amp_cond, and amp is refused.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import platform
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TIERS = ("df64", "f32", "f32k", "tf96", "amp", "amp_cond", "modp")
#: the prime of the modp tier, the largest the Z_p kernel takes
MODP_PRIME = (1 << 31) - 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier", default="df64", choices=TIERS)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("kernel_time: CUDA is not available", file=sys.stderr)
        return 2
    import superman_tpu_torch
    from superman_tpu_torch.ops import gray, modp, modp_cuda, ryser_cuda
    from superman_tpu_torch.ops.ryser import _center_scales, _row_scales

    n = args.n
    rng = np.random.default_rng(n)
    a = (rng.random((n, n)) < 0.5).astype(np.int64) * rng.integers(1, 5, (n, n))
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if on_card else gray.DEFAULT_SMS)
    plan = gray.make_plan(n, sms=sms)
    ids = torch.arange(plan.num_chunks, device=dev)
    if args.tier == "modp":
        x0, cols = (t.to(dev) for t in modp.pack_mod(
            modp.reduce_core_mod(a.tolist(), MODP_PRIME), MODP_PRIME,
            plan.n_pad))

        def launch():
            return modp_cuda.mod_partials(ids, x0, cols, MODP_PRIME, n=n,
                                          r=plan.r)
    else:
        a_s = np.ldexp(a.astype(np.float64),
                       -_center_scales(a, _row_scales(a))[:, None])
        x0, cols = (torch.as_tensor(v, device=dev)
                    for v in gray.pack_matrix(a_s, plan.n_pad))
        if args.tier in ("amp", "amp_cond"):
            kw = {"cond": args.tier == "amp_cond"}
            params = inspect.signature(ryser_cuda.ryser_amp).parameters
            if "cond" not in params:
                if args.tier == "amp":
                    print("kernel_time: this checkout has no amplitude-only "
                          "walk", file=sys.stderr)
                    return 2
                kw = {}

            def launch():
                return ryser_cuda.ryser_amp(ids, x0, cols, n=n, r=plan.r,
                                            **kw)
        else:
            def launch():
                return ryser_cuda.ryser_partials(ids, x0, cols, n=n,
                                                 r=plan.r, tier=args.tier)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    out = launch()                                        # build, warm-up
    sync()
    times = []
    for _ in range(args.reps):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = launch()
            end.record()
            sync()
            times.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            out = launch()
            times.append((time.perf_counter() - t) * 1e3)
    if on_card:
        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    else:
        where = (f"host {platform.processor() or platform.machine()}, "
                 f"{torch.get_num_threads()} torch threads")
    med = statistics.median(times)
    print(json.dumps({
        "package": superman_tpu_torch.__path__[0], "card": where,
        "device": args.device, "tier": args.tier, "n": n,
        "n_pad": plan.n_pad, "r": plan.r, "chunks": plan.num_chunks,
        "reps": args.reps, "median_ms": med, "min_ms": min(times),
        "g_steps_per_s": (1 << (n - 1)) / med / 1e6,
        "checksum": math.fsum(out.double().cpu().numpy().ravel().tolist())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
