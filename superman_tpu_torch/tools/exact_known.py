"""Certified exact permanents of a corpus, on the card: the known answers
tools/real_suite.py arbitrates against.

The port of superman_tpu/tools/exact_known.py.  Each file of the corpus
(tools/corpus.py's `corpus`: the seeded one, or --root's) whose exact
price on the device (ops.exact.exact_cost_estimate) fits --budget is
computed by the modular CRT engine (ops.exact.perman_exact_fraction: the
Z_p walk K3 at 31-bit primes on the card, a held-out prime certifying the
reconstruction); a file over the budget gets a declined row that says
why (engine null).

    python -m superman_tpu_torch.tools.exact_known [--out FILE]
        [--budget SECONDS] [--files SUBSTR ...] [--merge] [--reverify]
        [--report FILE] [--algo2-card] [--root DIR] [--device cpu]

--merge keeps the certified rows of --out and computes only the missing
files; a declined row is retried, and it stays in the output until a new
row replaces it, also where that certification raises.

--reverify recomputes every certified row on the native CPU engine's CRT
pipeline (modp.crt_perman_core backend="native": primes below 2^61, or
2^50 with AVX-512 IFMA, disjoint from the card's 31-bit ones) and
compares numerators; and, where the core's 2^(n-1) Gray space fits
--algo2-iters, checks per(core) mod a ~2^49 prime against the native
Glynn walk (bindings.native.perman_glynn_mod), a second identity that a
systematic fault of the Nijenhuis-Wilf walk cannot reproduce.

--algo2-card checks each certified row with K3 under the Glynn identity
(modp.perman_core_glynn_mod) at a 31-bit prime below every prime the
certification's device run consumed (its nprimes and the verifier).

--report merges the per-file results of --reverify and --algo2-card into
a JSON summary.  Without --root the seeded corpus (seed 0; --small at
the CPU's orders) is written to a temporary directory; the default --out is
build/tools/torch_exact_known.jsonl.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from fractions import Fraction

import numpy as np

from . import out_path, tool_device


def _read(path) -> np.ndarray:
    from ..io.matrixmarket import read_any
    return np.asarray(read_any(path).mat, np.float64)


def _rows(path) -> dict:
    rows = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                d = json.loads(line)
                rows[d["file"]] = d
    return rows


def _wanted(name, files) -> bool:
    return not files or any(s in name for s in files)


def certify(paths, out, budget, device, files=None, merge=False,
            log=print) -> int:
    """Write the certified (and declined) rows of `paths` to `out`;
    return the number of certifications that raised."""
    from ..ops import exact

    done, declined = {}, {}
    if merge and os.path.exists(out):
        with open(out) as f:
            for line in f:
                if not line.strip():
                    continue
                row = json.loads(line)
                # a declined row never blocks a new attempt (a bigger
                # budget may certify it)
                (declined if row.get("declined") else done)[row["file"]] = \
                    line.rstrip("\n")
    failed = 0
    with open(out + ".partial", "w") as fh:
        for line in done.values():
            fh.write(line + "\n")
        for path in paths:
            name = os.path.basename(path)
            if name in done or not _wanted(name, files):
                continue
            a = _read(path)
            secs, npr, core_n = exact.exact_cost_estimate(a, device,
                                                          budget_s=budget)
            if secs > budget:
                declined[name] = json.dumps(
                    {"file": name, "n": int(a.shape[0]), "core_n": core_n,
                     "nprimes": npr, "value": None, "engine": None,
                     "declined": True, "est_secs": float(secs),
                     "budget_s": budget, "device": str(device)})
                log(f"{name}: declined (est {secs:.3g} s, core n={core_n})")
                continue
            ck = out + f".ck.{name}.jsonl"
            t0 = time.time()
            try:
                frac, meta = exact.perman_exact_fraction(
                    a, device, log=lambda s: log(f"  {name}: {s}"),
                    checkpoint_path=ck)
            except Exception:               # noqa: BLE001 -- reported
                # the file keeps whatever row it had (a declined one
                # stays declined); the failure is the tool's exit code
                failed += 1
                log(f"{name}: certification raised, earlier row kept\n"
                    f"{traceback.format_exc()}")
                continue
            val = exact._float_of_fraction(frac)
            sign, l2 = ((0.0, None) if frac == 0 else
                        (1.0 if frac > 0 else -1.0,
                         exact.log2_abs_fraction(frac)))
            num = str(frac.numerator)
            row = {"file": name, "n": int(a.shape[0]),
                   "core_n": meta["core_n"], "nprimes": meta.get("nprimes"),
                   "k": meta["k"], "value": val, "sign": sign,
                   "log2_abs": l2,
                   "numerator": num if len(num) <= 4000
                   else num[:40] + "...",
                   # the reduced fraction's denominator, so that
                   # numerator / 2^denominator_log2 is the permanent
                   "denominator_log2": frac.denominator.bit_length() - 1,
                   "wall_s": time.time() - t0,
                   "engine": meta.get("engine"), "device": str(device)}
            fh.write(json.dumps(row) + "\n")
            fh.flush()
            declined.pop(name, None)
            if os.path.exists(ck):
                os.remove(ck)           # certified; residues obsolete
            log(f"{name}: per = {val:.12e} (core n={meta['core_n']}, "
                f"{row['wall_s']:.2f} s)")
        for line in declined.values():
            fh.write(line + "\n")
    os.replace(out + ".partial", out)
    return failed


def _per_core(row, a):
    """(core, per(core)) of a certified row: the stored numerator lifted
    back through the dyadic scale and the folds' multiplier."""
    from ..ops import exact
    m, k = exact.dyadic_int_matrix(a)
    core, mult = exact._fold_lines(m)
    frac = Fraction(int(row["numerator"]), 1 << row["denominator_log2"])
    per_core = frac * (1 << (k * a.shape[0])) / mult
    if per_core.denominator != 1:
        raise ValueError(f"{row['file']}: the row's value is not the "
                         f"integer core permanent over {mult}")
    return core, per_core.numerator


def glynn_check_prime() -> int:
    """The ~2^49 prime of the native Glynn check: no certification pool
    meets it (the card's 31-bit primes, the native engine's below 2^50
    from 2^50 - 1 and below 2^61)."""
    from ..ops import exact
    c = (1 << 49) - 1
    while not exact._is_prime_u64(c):
        c -= 2
    return c


def merge_report(path, new_rows, extra=None) -> None:
    """Merge per-file rows into the JSON summary at `path`."""
    merged, base = {}, {}
    if os.path.exists(path):
        with open(path) as f:
            base = json.load(f)
        merged = {r["file"]: r for r in base.get("rows", [])}
    for r in new_rows:
        merged.setdefault(r["file"], {}).update(r)
    rows_out = [merged[k] for k in sorted(merged)]
    n_bad = sum(1 for r in rows_out
                if r.get("crt_match") is False
                or r.get("glynn_ok") is False
                or r.get("glynn_card_ok") is False)
    base.update(rows=rows_out, n_match=len(rows_out) - n_bad,
                n_mismatch=n_bad)
    if extra:
        base.update(extra)
    with open(path, "w") as f:
        json.dump(base, f, indent=1)


def _certified(rows, files):
    """The rows a check can take: certified by an engine, wanted."""
    for name, row in sorted(rows.items()):
        if row.get("engine") and row["engine"] != "fold_only" \
                and _wanted(name, files):
            yield name, row


def algo2_card(paths, out, device, files=None, report=None,
               log=print) -> int:
    """K3 under Glynn against each certified row; return the failures."""
    from ..ops import exact, modp

    by_name = {os.path.basename(p): p for p in paths}
    results, bad = [], 0
    for name, row in _certified(_rows(out), files):
        if row["numerator"].endswith("..."):
            log(f"{name}: numerator truncated in the row")
            continue
        a = _read(by_name[name])
        core, per_core = _per_core(row, a)
        if not core:
            continue
        # below every prime of the device certification (nprimes and its
        # verifier, descending from modp.PRIME_CEIL)
        pg = exact.primes_desc((row.get("nprimes") or 1) + 2,
                               start=modp.PRIME_CEIL)[-1]
        t0 = time.time()
        got = modp.perman_core_glynn_mod(core, pg, device)
        ok = bool(got == per_core % pg)
        bad += not ok
        log(f"{name}: glynn_card={'OK' if ok else 'FAIL'} (p={pg}, core "
            f"n={len(core)}, {time.time() - t0:.2f} s)")
        results.append({"file": name, "glynn_card_ok": ok,
                        "glynn_card_prime": pg,
                        "glynn_card_wall_s": time.time() - t0,
                        "device": str(device)})
    if report and results:
        merge_report(report, results)
    log(f"algo2-card: {len(results) - bad} OK, {bad} FAIL")
    return bad


def reverify(paths, out, budget, device, files=None, report=None,
             algo2_iters=None, log=print) -> int:
    """The native engine's CRT and Glynn checks of each certified row;
    return the mismatches."""
    from ..bindings.native import cpu_ifma, perman_glynn_mod
    from ..ops import exact, modp

    if algo2_iters is None:
        algo2_iters = float(1 << 27) if cpu_ifma() else float(1 << 23)
    pg = glynn_check_prime()
    by_name = {os.path.basename(p): p for p in paths}
    rows = _rows(out)
    ok = bad = 0
    results = []
    for name, row in _certified(rows, files):
        a = _read(by_name[name])
        secs, _, _ = exact.exact_cost_estimate(a, device, engine="native")
        if secs > budget:
            log(f"{name}: skipped (native est {secs:.3g} s)")
            continue
        m, k = exact.dyadic_int_matrix(a)
        core, mult = exact._fold_lines(m)
        t0 = time.time()
        per_core = (modp.crt_perman_core(core, device, backend="native")[0]
                    if core else 1)
        num = str(Fraction(mult * per_core, 1 << (k * a.shape[0])).numerator)
        want = row["numerator"]
        match = (num.startswith(want[:-3]) if want.endswith("...")
                 else num == want)
        algo2 = None
        if core and float(1 << (len(core) - 1)) <= algo2_iters:
            am = np.asarray([[int(v) % pg for v in r_] for r_ in core],
                            dtype=np.uint64)
            algo2 = bool(perman_glynn_mod(am, pg) == per_core % pg)
        log(f"{name}: {'MATCH' if match else 'MISMATCH'}"
            f"{'' if algo2 is None else ' algo2=' + ('OK' if algo2 else 'FAIL')}"
            f" ({time.time() - t0:.2f} s)")
        good = match and algo2 is not False
        ok += good
        bad += not good
        results.append({"file": name, "crt_match": bool(match),
                        "glynn_ok": algo2, "wall_s": time.time() - t0})
    skipped = len(rows) - len(results)
    log(f"reverify: {ok} match, {bad} MISMATCH, {skipped} skipped")
    if report:
        merge_report(report, results,
                     extra={"glynn_prime": pg, "algo2_iters": algo2_iters,
                            "n_skipped": skipped})
    return bad


def main(argv=None) -> int:
    from .corpus import corpus, real_root
    p = argparse.ArgumentParser(prog="superman-torch-exact-known",
                                description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="default build/tools/torch_exact_known.jsonl")
    p.add_argument("--budget", type=float, default=2000.0,
                   help="per-file price cap in seconds")
    p.add_argument("--files", nargs="*", default=None,
                   help="only files whose name contains one of these")
    p.add_argument("--merge", action="store_true",
                   help="keep certified rows; compute only missing files")
    p.add_argument("--reverify", action="store_true",
                   help="recheck every certified row on the native engine")
    p.add_argument("--algo2-iters", type=float, default=None,
                   help="largest 2^(core_n-1) of the native Glynn check "
                        "(default 2^27 with IFMA, 2^23 without)")
    p.add_argument("--algo2-card", action="store_true",
                   help="check certified rows with K3 under Glynn")
    p.add_argument("--report", default=None,
                   help="merge the checks' results into this JSON")
    p.add_argument("--root", default=None,
                   help="corpus root (default: the seeded corpus, written "
                        "to a temporary directory)")
    p.add_argument("--small", action="store_true",
                   help="the seeded corpus at the CPU's orders")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    args = p.parse_args(argv)
    dev = tool_device(args.device)
    out = args.out or out_path("torch_exact_known.jsonl")
    log = lambda s: print(s, flush=True)           # noqa: E731
    with real_root(args.root, small=args.small) as root:
        paths = corpus(root)
        if args.algo2_card:
            bad = algo2_card(paths, out, dev, args.files, args.report, log)
        elif args.reverify:
            bad = reverify(paths, out, args.budget, dev, args.files,
                           args.report, args.algo2_iters, log)
        else:
            bad = certify(paths, out, args.budget, dev, args.files,
                          args.merge, log)
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
