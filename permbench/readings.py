"""The readings that set a cell's limits: the program on a dozen seeds or
more and the control on three or more, short windows in one process.

    python3 -m permbench.readings --workload <cell> --seeds 1-12
        [--control-seeds 13-15] [--seconds 3]

Each seed is one run of harness.run_cell at the cell's own size and load
(its set-up, window and check), so the kernels' build and the process's
start are paid once.  One JSON line a run (seed, control, correct, the
checks, the end-to-end metrics), then one line with the largest of each
compared number over the program's runs (the lower reading) and the
smallest over the control's (the upper reading).
"""

from __future__ import annotations

import argparse
import json
import sys

from . import harness


def seed_list(text: str) -> list:
    """"1-3,7" -> [1, 2, 3, 7]."""
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m permbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seed_list, required=True)
    ap.add_argument("--control-seeds", type=seed_list, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.cache_env(harness.CHECKOUT)
    import torch
    if not torch.cuda.is_available():
        print("permbench.readings: needs a CUDA card", file=sys.stderr)
        return 2
    worst = {False: {}, True: {}}
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            line = harness.run_cell(cell, seed, args.seconds, False,
                                    device="cuda:0", control=control)
            print(json.dumps({"seed": seed, "control": control,
                              "correct": line["correct"],
                              "checks": line["checks"],
                              "metrics": {k: v["value"] for k, v in
                                          line["metrics"].items()}}),
                  flush=True)
            for name, (value, _) in line["checks"].items():
                pick = min if control else max
                prev = worst[control].get(name)
                worst[control][name] = value if prev is None else \
                    pick(prev, value)
    print(json.dumps({"workload": cell.name, "lower": worst[False],
                      "upper": worst[True]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
