"""Sparse-engine evidence: the dense walk against the pruned walk, wall
clock and accuracy, on the card.

The port of superman_tpu/tools/sparse_report.py.  For each matrix of a
sparse int suite it times the dense df64 walk (skip_pruning=False, K1)
and the pruned, factored walk (sparse=True, K1's reduced entry), each
warmed once and then the best of two, and holds the pruned value to the
native C++ double engine's.  The native values come from --native-from
(a suite_check output: rows with "file" and "native_double") where it
has the file, else they are computed here on the native engine.

    python -m superman_tpu_torch.tools.sparse_report [--n 32]
        [--densities 0.10 0.15] [--seeds 0 1 2] [--root DIR]
        [--native-from FILE] [--out FILE] [--device cpu]

Without --root the seeded int suite of tools/corpus.py is written to a
temporary directory and read from there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from . import tool_device


def recorded_native(path) -> dict:
    """file -> native_double of a suite_check output."""
    vals = {}
    if path:
        with open(path) as f:
            for ln in f:
                d = json.loads(ln)
                if "file" in d and "native_double" in d:
                    vals[d["file"]] = d["native_double"]
    return vals


def _best_of_two(fn):
    fn()                                        # warm
    walls, res = [], None
    for _ in range(2):
        t0 = time.perf_counter()
        res = fn()
        walls.append(time.perf_counter() - t0)
    return min(walls), res


def run(files, out=None, device=None, native_from=None, log=print):
    """(rows, worst relative difference of the pruned walk)."""
    dev = tool_device(device)
    import superman_tpu_torch as spt
    from ..bindings.native import native_available

    native = recorded_native(native_from)
    rows = []
    worst = 0.0
    for path in files:
        name = os.path.basename(path)
        want = native.get(name)
        if want is None:
            if not native_available():
                log(f"skip {name}: no recorded or computable native value")
                continue
            want = spt.permanent(path, device=dev, calc="f64", cpu=True,
                                 gpu=False).permanent
        # skip_pruning=False forces the dense walk (the engine engages the
        # pruned walk by itself on these inputs otherwise)
        dense_wall, dres = _best_of_two(lambda: spt.permanent(
            path, device=dev, calc="df64", skip_pruning=False))
        sparse_wall, sres = _best_of_two(lambda: spt.permanent(
            path, device=dev, sparse=True, calc="df64"))
        rel = abs(sres.permanent - want) / max(abs(want), 1e-300)
        worst = max(worst, rel)
        rec = {"file": name, "device": str(dev), "native_double": want,
               "sparse": sres.permanent, "dense": dres.permanent,
               "rel_diff": rel, "sparse_wall_s": sparse_wall,
               "dense_wall_s": dense_wall,
               "speedup": dense_wall / sparse_wall,
               "plan": sres.meta.get("sparse")}
        rows.append(rec)
        log(json.dumps(rec))
    summary = {"matrices": len(rows), "worst_rel_diff": worst,
               "mean_speedup": (float(np.mean([r["speedup"] for r in rows]))
                                if rows else None)}
    log(json.dumps(summary))
    if out:
        with open(out, "w") as f:
            for rec in rows + [summary]:
                f.write(json.dumps(rec) + "\n")
    return rows, worst


def main(argv=None) -> int:
    from .suite_check import suite_files
    p = argparse.ArgumentParser(prog="superman-torch-sparse-report",
                                description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, nargs="+", default=[32])
    p.add_argument("--densities", nargs="+",
                   default=["0.10", "0.15", "0.20", "0.25"])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--root", default=None,
                   help="directory holding int/{n}_{d}_{s} (default: the "
                        "seeded suite, written to a temporary directory)")
    p.add_argument("--native-from", default=None,
                   help="a suite_check output holding the native values")
    p.add_argument("--out", default=None)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    args = p.parse_args(argv)
    dev = tool_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        root = args.root
        if root is None:
            from .corpus import write_int_suite
            root = tmp
            write_int_suite(root, 0, args.n, args.densities,
                            args.seeds)
        files = suite_files(root, args.n, args.densities, args.seeds,
                            log=lambda s: print(f"sparse_report: {s}",
                                                file=sys.stderr))
        _, worst = run(files, out=args.out, device=dev,
                       native_from=args.native_from)
    return 0 if worst <= args.tol else 1


if __name__ == "__main__":
    sys.exit(main())
