"""The SMC flagship on the card: the 36 x 36 grid (n = 648) population
estimate against the Kasteleyn closed form.

The port of superman_tpu/tools/smc_flagship.py.  The grid is the
reference's own approximation headline (-i -m 36 -n 36); the truth is
prep/gridgraph.kasteleyn_log2.  A warm-up run (seed + 1), then the timed
run, then z = (log2 estimate - log2 exact) / sigma_log2 with sigma_log2
= stderr_rel / ln 2; the run fails past |z| > 3.  scale_intervals is not
passed unless asked for, so the run goes through the selector
(ops/approx._select_si).  One JSON row is appended to --out.

    python -m superman_tpu_torch.tools.smc_flagship [--grid 36]
        [--trials 100000] [--seed 11] [--out FILE] [--device cpu]

chip_smoke.py runs its grid estimates through `flagship`.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from . import out_path, tool_device

#: the limit on |z|
Z_LIMIT = 3.0


def flagship(grid: int = 36, trials: int = 100000, seed: int = 11,
             device=None, scale_intervals=None, warmup: bool = True) -> dict:
    """The SMC estimate of the grid x grid grid graph's perfect matchings
    against Kasteleyn's count: a row with the estimate, sigma, z and the
    timed run's wall (`warm_wall_s`; after a warm-up run when `warmup`)."""
    dev = tool_device(device)
    import superman_tpu_torch as spt
    from ..prep.gridgraph import kasteleyn_log2

    kw = dict(approximation=True, perman_algo="scaling", smc=1,
              number_of_times=trials)
    if scale_intervals is not None:
        kw["scale_intervals"] = scale_intervals
    if warmup:
        spt.grid_permanent(grid, grid, device=dev, seed=seed + 1, **kw)
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    r = spt.grid_permanent(grid, grid, device=dev, seed=seed, **kw)
    wall = time.perf_counter() - t0
    exact_l2 = float(kasteleyn_log2(grid, grid))
    est_l2 = float(r.meta["log2_estimate"])
    stderr_rel = float(r.meta["stderr_rel"])
    sig_l2 = stderr_rel / math.log(2.0)
    z = (est_l2 - exact_l2) / sig_l2 if sig_l2 > 0 else math.inf
    return {"grid": grid, "n": grid * grid // 2, "device": str(dev),
            "algo_name": r.algo_name, "trials": int(r.meta["trials"]),
            "populations": r.meta["populations"],
            "scale_intervals": r.meta["scale_intervals"],
            "si_auto": r.meta.get("si_auto"), "zeros": r.zeros,
            "est_log2": est_l2, "exact_log2": exact_l2,
            "sigma_log2": sig_l2, "z": z, "stderr_rel": stderr_rel,
            "warm_wall_s": wall, "seed": seed}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="superman-torch-smc-flagship",
                                description=__doc__.splitlines()[0])
    p.add_argument("--grid", type=int, default=36)
    p.add_argument("--trials", type=int, default=100000)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--out", default=None,
                   help="JSONL to append the row to (default "
                        "build/tools/torch_smc_flagship.jsonl)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    args = p.parse_args(argv)
    row = flagship(args.grid, args.trials, args.seed, args.device)
    with open(args.out or out_path("torch_smc_flagship.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row))
    ok = abs(row["z"]) <= Z_LIMIT
    print(f"flagship: est {row['est_log2']:.4f} vs exact "
          f"{row['exact_log2']:.4f} (z = {row['z']:.2f}, si = "
          f"{row['scale_intervals']}) [{'OK' if ok else 'FAIL'}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
