"""Accuracy sweep: run a matrix of configs, check that they agree.

The port of superman_tpu/tools/accuracy.py, with the same SWEEP, QUICK
and ORACLE: every config computes the same scalar, so the most accurate
one (ORACLE) is the oracle and every other exact config must agree with
it to its tolerance; the estimators are recorded, not checked.

    python -m superman_tpu_torch.tools.accuracy -f FILE [-f FILE ...]
        [--out report.jsonl] [--quick] [--device cpu]

With no -f it sweeps the seeded corpus's int-suite file {--n}_0.50_0
(tools/corpus.py; n=30 by default).  Each line of the report: {"file",
"config", "permanent", "time", "algo_name", "device", "agrees",
"rel_err"}.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from . import tool_device

# (name, overrides, rel_tol vs oracle); None tol = estimator (recorded,
# not checked)
SWEEP = [
    ("exact_df64", dict(calc="df64"), 1e-9),
    ("exact_f32", dict(calc="f32"), 5e-2),
    ("exact_f64_host", dict(calc="f64"), 1e-9),
    ("exact_sparse_auto", dict(sparse=True, calc="df64"), 1e-9),
    ("exact_sparse_sort", dict(sparse=True, preprocessing=1,
                               calc="df64"), 1e-9),
    ("exact_sparse_skip", dict(sparse=True, preprocessing=2,
                               calc="df64"), 1e-9),
    ("exact_compressed", dict(compression=True, calc="df64"), 1e-9),
    ("exact_glynn", dict(perman_algo="glynn", calc="df64"), 1e-8),
    ("exact_tf96", dict(calc="tf96"), 1e-9),
    ("exact_scaled_u2", dict(scaling_threshold=2.0, calc="df64"), 1e-7),
    ("approx_rasmussen", dict(approximation=True,
                              perman_algo="rasmussen",
                              number_of_times=200000), None),
    ("approx_scaling", dict(approximation=True, perman_algo="scaling",
                            number_of_times=50000), None),
]

QUICK = {"exact_df64", "exact_f32", "exact_sparse_auto",
         "exact_scaled_u2", "approx_scaling"}

ORACLE = "exact_df64"


def run_sweep(files, quick=False, out=None, device=None, log=print):
    """(records, the records that disagree or raised)."""
    dev = tool_device(device)
    import superman_tpu_torch as spt

    records = []
    for path in files:
        oracle_val = None
        for name, overrides, tol in SWEEP:
            if quick and name not in QUICK:
                continue
            try:
                res = spt.permanent(path, device=dev, **overrides)
            except Exception as e:           # noqa: BLE001 -- recorded
                rec = {"file": path, "config": name, "error": str(e)}
                records.append(rec)
                log(json.dumps(rec))
                continue
            rec = {"file": path, "config": name,
                   "permanent": res.permanent, "time": res.time,
                   "algo_name": res.algo_name, "device": str(dev)}
            if name == ORACLE:
                oracle_val = res.permanent
            if tol is not None and oracle_val is not None:
                rel = (abs(res.permanent - oracle_val) /
                       max(abs(oracle_val), 1e-300))
                rec["rel_err"] = rel
                rec["agrees"] = rel <= tol
            records.append(rec)
            log(json.dumps(rec))
    if out:
        with open(out, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    bad = [r for r in records if r.get("agrees") is False or "error" in r]
    return records, bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="superman-torch-accuracy",
                                description=__doc__.splitlines()[0])
    p.add_argument("-f", "--file", action="append", default=None)
    p.add_argument("--n", type=int, default=30,
                   help="without -f: the order of the seeded file")
    p.add_argument("--out", default=None)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    args = p.parse_args(argv)
    dev = tool_device(args.device)
    with tempfile.TemporaryDirectory() as root:
        files = args.file
        if not files:
            from .corpus import write_int_suite
            files = write_int_suite(root, 0, ns=(args.n,),
                                    densities=("0.50",))
        records, bad = run_sweep(files, quick=args.quick, out=args.out,
                                 device=dev)
    if bad:
        print(f"ACCURACY SWEEP: {len(bad)} config(s) FAILED agreement",
              file=sys.stderr)
        return 1
    print(f"ACCURACY SWEEP: all {len(records)} records agree")
    return 0


if __name__ == "__main__":
    sys.exit(main())
