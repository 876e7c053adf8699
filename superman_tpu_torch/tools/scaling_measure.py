"""Measured multi-device scaling constants, and the efficiency bound
they give.

The port of superman_tpu/tools/scaling_measure.py.  What one card can
measure of the port's mesh (parallel/mesh.py: a list of devices, a
stream an entry, block rows dealt round-robin by parallel/sharding.py):

* the mesh's fixed overhead: the wall of `permanent(mesh_shape=(1,))`
  against the plain call on the same seeded dense matrices (n=30 and
  n=32, the int suite's {n}_0.50_0 of tools/corpus.py, read once;
  skip_pruning=False keeps the walk dense).  On one card a mesh of one
  entry is one device; so ops.ryser.ryser_exact is also timed over a
  mesh of STREAMS streams of the card against itself on the device,
  where the entries' walks overlap and the deal, the streams and the
  regrouping are paid.  The four calls take turns, --reps times after a
  warm-up, and must give one value;
* the per-run fixed costs from the trace spans (`pack`, `sparse_plan`);
* the sparse layout at 1, 8 and 64 entries: the reduced walk's live list
  split and padded to blocks of 128 once (gray.split_shift), the block
  rows dealt round-robin (sharding._deal, split_rows): each entry's live
  sub-chunks, and the useful fraction, live work over the slots of the
  most loaded entry times the entries.

Efficiency bound for N devices (every chunk costs 2^r steps):

    eff(N) = (T_walk / N) / (T_walk * quant(N) / N + T_fixed + T_overhead)

with T_walk the measured single-device wall, quant(N) the dense plan's
block rows rounded up to a multiple of N over themselves, T_fixed the
measured pack and plan spans and T_overhead the larger of the measured
mesh deltas.  Communication is one float64 per entry and run.

    python -m superman_tpu_torch.tools.scaling_measure [--reps 3] [--big]
        [--root DIR] [--out FILE] [--device cpu]

Writes --out (default build/tools/torch_scaling_measured.json) and prints
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

from . import out_path, tool_device

#: entries of the stream mesh on the one device (chip_smoke.py's mesh)
STREAMS = 4
#: the order of the sparse layout's seeded matrix (density 0.10)
LAYOUT_N = 36


def _time_cases(fns: dict, reps: int) -> dict:
    """name -> the walls of reps timed calls of fns[name]() -> Result
    after one warm-up, their spans' means and the last value; the calls
    of the cases take turns, so that drift hits them alike."""
    walls = {k: [] for k in fns}
    spans = {k: {} for k in fns}
    last = {}
    for i in range(reps + 1):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            last[name] = fn()
            w = time.perf_counter() - t0
            if i == 0:
                continue                  # warm-up
            walls[name].append(w)
            for sp, dt in last[name].meta.get("spans", []):
                spans[name].setdefault(sp, []).append(dt)
    return {k: {"wall_mean": float(np.mean(walls[k])),
                "wall_min": float(np.min(walls[k])), "walls": walls[k],
                "spans": {s_: float(np.mean(v))
                          for s_, v in spans[k].items()},
                "permanent": last[k].permanent} for k in fns}


def quantization_table(n: int, density: float, seed: int = 0,
                       shards=(1, 8, 64), plan=None, sms: int = None):
    """(meta, rows) of the sparse layout over 1, 8 and 64 entries, from
    the port's planner (or `plan`, a pruning.SparsePlan) and its
    round-robin deal of the reduced walk's block rows."""
    import torch

    from ..ops import gray, pruning, ryser
    from ..ops.ryser_cuda import BLOCK
    from ..parallel.sharding import split_rows

    rng = np.random.default_rng(seed)
    a = ((rng.random((n, n)) < density) * rng.integers(1, 9, (n, n))
         ).astype(np.float64)
    np.fill_diagonal(a, rng.integers(1, 9, n))
    sp = plan if plan is not None else pruning.plan_sparse(
        a, giters=ryser.K1_GITERS["df64"])
    if sp is None:
        return {"n": n, "density": density, "note": "planner declined"}, []
    live = len(sp.ids)
    shift = gray.split_shift(live, sp.r, (sms or gray.DEFAULT_SMS)
                             * gray.SPLIT_CHUNKS_PER_SM)
    work = live << shift
    nblocks = -(-work // BLOCK)
    live_t = torch.as_tensor(np.asarray(sp.ids, dtype=np.int64))
    rows = []
    for s in shards:
        per = [int((split_rows(live_t, shift, torch.arange(
            e, nblocks, s, dtype=torch.int64)) >= 0).sum())
            for e in range(s)]
        most = -(-nblocks // s)
        rows.append({"shards": s, "blocks": nblocks,
                     "blocks_per_shard_max": most,
                     "useful_frac": work / (s * most * BLOCK),
                     "live_lane_min": min(per), "live_lane_max": max(per)})
    return {"n": n, "density": density, "live_chunks": live, "r": int(sp.r),
            "split_shift": shift, "sub_chunks": work}, rows


def efficiency_bound(t_walk: float, t_fixed: float, overhead: float,
                     n: int, sms: int, chips=(8, 64)) -> dict:
    """eff(N) of the module docstring, quant(N) from the dense plan of
    order n (gray.make_plan: block rows of `lanes` chunk ids)."""
    from ..ops import gray
    plan = gray.make_plan(n, sms=sms)
    rows = -(-plan.num_chunks // plan.lanes)
    eff = {}
    for N in chips:
        quant = (math.ceil(rows / N) * N) / rows
        eff[f"chips_{N}"] = (t_walk / N) / ((t_walk * quant) / N + t_fixed
                                           + overhead)
    return eff


def measure(ns=(30, 32), reps: int = 3, root=None, device=None,
            log=print) -> dict:
    """The cases, the efficiency bound and the sparse layout (module
    docstring) as one dict."""
    dev = tool_device(device)
    import superman_tpu_torch as spt
    from ..core.flags import Flags
    from ..io.matrixmarket import read_any
    from ..ops.ryser import _sm_count, ryser_exact
    from ..parallel.mesh import make_mesh

    out = {"device": str(dev), "cases": {}}
    if dev.type == "cuda":
        from .kernel_time import smi
        out["card"] = smi()
    mesh = make_mesh(devices=[dev] * STREAMS)
    with tempfile.TemporaryDirectory() as tmp:
        if root is None:
            from .corpus import write_int_suite
            root = tmp
            write_int_suite(root, 0, ns, ("0.50",))
        for n in ns:
            dm = read_any(os.path.join(root, "int", f"{n}_0.50_0"))
            flags = Flags(skip_pruning=False)
            c = _time_cases({
                "plain": lambda: spt.permanent(dm, device=dev,
                                               skip_pruning=False),
                "mesh1": lambda: spt.permanent(dm, device=dev,
                                               skip_pruning=False,
                                               mesh_shape=(1,)),
                "one": lambda: ryser_exact(dm, flags, dev),
                "streams": lambda: ryser_exact(dm, flags, dev, mesh=mesh)},
                reps)
            if len({v["permanent"] for v in c.values()}) != 1:
                raise AssertionError(
                    f"n={n}: the values differ: "
                    f"{ {k: v['permanent'] for k, v in c.items()} }")
            # permanent() against itself, ryser_exact against itself
            d1 = c["mesh1"]["wall_mean"] - c["plain"]["wall_mean"]
            ds = c["streams"]["wall_mean"] - c["one"]["wall_mean"]
            out["cases"][f"n{n}"] = {**c, "mesh1_overhead_s": d1,
                                     "streams_overhead_s": ds}
            log(f"n={n}: permanent {c['plain']['wall_mean']:.4f} s, with "
                f"mesh_shape=(1,) {c['mesh1']['wall_mean']:.4f} s "
                f"({d1 * 1e3:+.2f} ms); ryser_exact "
                f"{c['one']['wall_mean']:.4f} s, over {STREAMS} streams "
                f"{c['streams']['wall_mean']:.4f} s ({ds * 1e3:+.2f} ms); "
                f"spans {c['plain']['spans']}")

    cases = out["cases"].values()
    t_fixed = max(sum(v for k, v in c["plain"]["spans"].items()
                      if k in ("pack", "sparse_plan")) for c in cases)
    ov = max(0.0, max(max(c["mesh1_overhead_s"], c["streams_overhead_s"])
                      for c in cases))
    nn = ns[-1]
    t_walk = out["cases"][f"n{nn}"]["plain"]["wall_mean"]
    eff = efficiency_bound(t_walk, t_fixed, ov, nn, _sm_count(dev))
    out["efficiency_bound"] = {"from_case": f"n{nn}", "t_walk_s": t_walk,
                               "t_fixed_s": t_fixed,
                               "mesh_overhead_s": ov, **eff}
    meta, rows = quantization_table(LAYOUT_N, 0.10, sms=_sm_count(dev))
    out["sparse_layout"] = {"meta": meta, "shards": rows}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="superman-torch-scaling-measure",
                                description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--n", type=int, nargs="+", default=[30, 32])
    p.add_argument("--big", action="store_true",
                   help="add the n=36 case")
    p.add_argument("--root", default=None,
                   help="directory holding int/{n}_0.50_0 (default: the "
                        "seeded suite, written to a temporary directory)")
    p.add_argument("--out", default=None,
                   help="default build/tools/torch_scaling_measured.json")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    args = p.parse_args(argv)
    out = measure(list(args.n) + ([36] if args.big else []), args.reps,
                  args.root, args.device, log=lambda s: print(s, flush=True))
    with open(args.out or out_path("torch_scaling_measured.json"), "w") as f:
        json.dump(out, f, indent=1)
    eff = out["efficiency_bound"]
    print(json.dumps({"metric": "mesh_overhead_ms",
                      "value": eff["mesh_overhead_s"] * 1e3,
                      "device": out["device"],
                      "efficiency_bound": {k: v for k, v in eff.items()
                                           if k.startswith("chips_")},
                      "sparse_layout": out["sparse_layout"]["shards"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
