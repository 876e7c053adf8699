"""Time the Ryser walk kernel (K1) alone on one CUDA card.

    python -m superman_tpu_torch.tools.kernel_time [--tier df64] [--n 32]

Walks the whole default plan of a seeded integer matrix of order n
(entries 1-4, density 0.5, seed n: at n=32 the matrix of chip_smoke.py),
times each of --reps launches by CUDA events after a warm-up, and prints
one JSON line: the card's name and power limit, the median and the least
time, and a checksum of the partials (their exact float64 sum), so that
two checkouts can be compared in one run on one card:

    PYTHONPATH=<other checkout> python superman_tpu_torch/tools/kernel_time.py

imports the package of the other checkout and builds its kernels there.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier", default="df64")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_time: CUDA is not available", file=sys.stderr)
        return 2
    import superman_tpu_torch
    from superman_tpu_torch.ops import gray, ryser_cuda
    from superman_tpu_torch.ops.ryser import _center_scales, _row_scales

    n = args.n
    rng = np.random.default_rng(n)
    a = (rng.random((n, n)) < 0.5).astype(np.int64) * rng.integers(1, 5, (n, n))
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = gray.make_plan(n, sms=sms)
    a_s = np.ldexp(a.astype(np.float64),
                   -_center_scales(a, _row_scales(a))[:, None])
    x0, cols = (torch.as_tensor(v, device=dev)
                for v in gray.pack_matrix(a_s, plan.n_pad))
    ids = torch.arange(plan.num_chunks, device=dev)

    def launch():
        return ryser_cuda.ryser_partials(ids, x0, cols, n=n, r=plan.r,
                                         tier=args.tier)

    out = launch()                                        # build, warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(args.reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({
        "package": superman_tpu_torch.__path__[0], "card": card,
        "tier": args.tier, "n": n, "n_pad": plan.n_pad, "r": plan.r,
        "chunks": plan.num_chunks, "reps": args.reps,
        "median_ms": statistics.median(times), "min_ms": min(times),
        "checksum": math.fsum(out.double().cpu().numpy().ravel().tolist())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
