"""Cross-engine sweep over an Erdős–Rényi int suite: the card's walk
against the native C++ double engine.

The port of superman_tpu/tools/suite_check.py.  Each matrix runs through
`permanent(calc=...)` on the device (K1, df64 by default) and through the
port's native CPU engine in IEEE double (calc="f64", cpu=True,
gpu=False), and the relative difference of the two is reported.

    python -m superman_tpu_torch.tools.suite_check [--n 30 32]
        [--densities 0.50] [--root DIR] [--out FILE] [--device cpu]

--root names a directory holding int/{n}_{d}_{s} (the reference
layout); without it the seeded int suite of tools/corpus.py is written to
a temporary directory and read from there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from . import tool_device


def check(files, out=None, device=None, log=print, calc="df64"):
    """(rows, worst relative difference) of `files`."""
    dev = tool_device(device)
    import superman_tpu_torch as spt
    from ..bindings.native import native_available

    if not native_available():
        raise RuntimeError("the native CPU engine does not build here")
    rows = []
    worst = 0.0
    for path in files:
        t0 = time.perf_counter()
        card = spt.permanent(path, device=dev, calc=calc)
        nat = spt.permanent(path, device=dev, calc="f64", cpu=True,
                            gpu=False)
        rel = (abs(card.permanent - nat.permanent)
               / max(abs(nat.permanent), 1e-300))
        worst = max(worst, rel)
        rec = {"file": os.path.basename(path), "calc": calc,
               "device": str(dev), "card": card.permanent,
               "native_double": nat.permanent, "rel_diff": rel,
               "card_s": card.time, "native_s": nat.time,
               "wall_s": time.perf_counter() - t0}
        rows.append(rec)
        log(json.dumps(rec))
    summary = {"matrices": len(rows), "worst_rel_diff": worst}
    log(json.dumps(summary))
    if out:
        with open(out, "w") as f:
            for rec in rows + [summary]:
                f.write(json.dumps(rec) + "\n")
    return rows, worst


def suite_files(root, ns, densities, seeds, log=print):
    """The existing files {root}/int/{n}_{d}_{s}; the missing ones are
    reported and skipped."""
    cand = [os.path.join(root, "int", f"{n}_{d}_{s}")
            for n in ns for d in densities for s in seeds]
    files = [f for f in cand if os.path.exists(f)]
    for f in sorted(set(cand) - set(files)):
        log(f"skipping missing {f}")
    return files


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="superman-torch-suite-check",
                                description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, nargs="+", default=[30, 31, 32])
    p.add_argument("--densities", nargs="+",
                   default=["0.10", "0.20", "0.30", "0.50", "0.70", "0.90"])
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--root", default=None,
                   help="directory holding int/{n}_{d}_{s} (default: the "
                        "seeded suite, written to a temporary directory)")
    p.add_argument("--out", default=None)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--calc", default="df64")
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
                            log=lambda s: print(f"suite_check: {s}",
                                                file=sys.stderr))
        _, worst = check(files, out=args.out, device=dev, calc=args.calc)
    if worst > args.tol:
        print(f"SUITE CHECK FAILED: worst rel diff {worst:.3e} > {args.tol}",
              file=sys.stderr)
        return 1
    print(f"SUITE CHECK OK: worst rel diff {worst:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
