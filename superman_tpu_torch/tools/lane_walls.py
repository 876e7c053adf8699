"""Time the float lane walks through the entry points a user calls: the
routes that permanent() and permanent_batch() take below the kernels'
orders, on one CUDA card.

    python -m superman_tpu_torch.tools.lane_walls [--against DIR] [--reps 21]
    python -m superman_tpu_torch.tools.lane_walls --host [--against DIR]

The routes: permanent(a) (the float64 lane walk; the card's default tier,
df64, takes it below n=19) and permanent(a, calc="f32") (the float32
walk) at n=12 and n=18, permanent(a, perman_algo="glynn") (Glynn's
float64 route) at n=12 and n=18, and permanent_batch of 64 matrices of
n=12 (the small-order batch walk); each matrix
np.random.default_rng(seed).integers(1, 5, (n, n)).  With --host the
host routes instead: permanent(a, calc="tf96") at n=18 (the long-double
host walk) and permanent(a, cpu=True, gpu=False, threads=8) on
chip_smoke.py's n=32 matrix (random_int_matrix(default_rng(32), 32,
0.5); the native engine's double walk, seconds a call, so --reps
defaults to 3 there).  Every route is called once to warm up, then
--reps times; the median host wall in ms, beside the route's lanes,
steps and dtype (Result.meta["lane_walk"]) where it records them.

--against DIR loads the superman_tpu_torch of another checkout (say an
unpacked `git archive` of an earlier commit) beside this one, under
another module name, and calls the two in turns in one process, each
first in every other turn: a before/after pair on one card with no
process-to-process spread.  Prints one JSON line: the card's name and
power limit, and for each route and tree the algo it took, its lanes
and its median.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

#: the small-order batch: matrices of order BATCH_N, seeds 0..BATCH_B-1
BATCH_B, BATCH_N = 64, 12
#: the native engine's threads on the host routes (the card's host has 8
#: cores)
NATIVE_THREADS = 8


def mat(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, 5, (n, n)) * 1.0


def routes(spt, device, host: bool = False) -> dict:
    """name -> a call of the route through the package `spt` on
    `device`, returning its Result (the batch: its first Result); with
    `host`, the host routes."""
    if host:
        from .kernel_time import random_int_matrix
        a18 = mat(18, 18)
        a32 = random_int_matrix(np.random.default_rng(32), 32, 0.5)
        return {"tf96 host walk n=18": lambda: spt.permanent(
                    a18, device=device, calc="tf96"),
                "native double walk n=32": lambda: spt.permanent(
                    a32, device=device, cpu=True, gpu=False,
                    threads=NATIVE_THREADS)}
    out = {}
    for n in (12, 18):
        a = mat(n, n)
        out[f"float64 walk n={n}"] = (
            lambda a=a: spt.permanent(a, device=device))
        out[f"float32 walk n={n}"] = (
            lambda a=a: spt.permanent(a, device=device, calc="f32"))
        out[f"glynn float64 n={n}"] = (
            lambda a=a: spt.permanent(a, device=device, perman_algo="glynn"))
    stack = [mat(BATCH_N, s) for s in range(BATCH_B)]
    out[f"batch walk {BATCH_B} x n={BATCH_N}"] = (
        lambda: spt.permanent_batch(stack, device=device)[0])
    return out


def load_tree(root: str, name: str = "superman_tpu_torch_against"):
    """The superman_tpu_torch package of the checkout at `root`, imported
    as the module `name` (its modules import each other relatively)."""
    pkg = os.path.join(os.path.abspath(root), "superman_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def walls(pkgs: dict, device, reps: int, host: bool = False) -> dict:
    """route -> {label: {"algo", "lanes", "ms"}} for each package of
    `pkgs` ({label: superman_tpu_torch module}): one warm-up call each,
    then `reps` turns in which every package is called once, the order
    turned round every other turn; "lanes" the warm-up's
    Result.meta["lane_walk"] (the lane walk's lanes, r, steps and dtype;
    None where the route or the package records none), "ms" the median
    wall.
    `host`: the host routes (routes())."""
    calls = {label: routes(spt, device, host) for label, spt in pkgs.items()}
    out = {}
    for name in calls[next(iter(pkgs))]:
        turn = [(label, calls[label][name]) for label in pkgs]
        res = {}
        for label, call in turn:
            warm = call()
            res[label] = {"algo": warm.algo_name,
                          "lanes": warm.meta.get("lane_walk")}
        times = {label: [] for label in pkgs}
        for i in range(reps):
            for label, call in turn[::1 - 2 * (i & 1)]:
                t = time.perf_counter()
                call()
                times[label].append(time.perf_counter() - t)
        for label in pkgs:
            res[label]["ms"] = statistics.median(times[label]) * 1e3
        out[name] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", default=None,
                    help="another checkout whose superman_tpu_torch is "
                         "timed in turns with this one")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed calls a route (default 21, --host 3)")
    ap.add_argument("--host", action="store_true",
                    help="time the host routes (the n=18 tf96 host walk, "
                         "the native n=32 double walk)")
    args = ap.parse_args(argv)
    if args.reps is None:
        args.reps = 3 if args.host else 21
    import torch
    import superman_tpu_torch as spt
    if not torch.cuda.is_available():
        raise SystemExit("lane_walls: no CUDA card")
    pkgs = {"this tree": spt}
    if args.against:
        pkgs[os.path.abspath(args.against)] = load_tree(args.against)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "reps": args.reps,
                      "walls": walls(pkgs, torch.device("cuda"),
                                     args.reps, args.host)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
