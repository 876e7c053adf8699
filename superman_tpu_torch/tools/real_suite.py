"""Known-answer validation suite over a corpus of real-like matrices, on
the card.

The port of superman_tpu/tools/real_suite.py.  The corpus has the
reference's layout (known_perman/*.mtx, real/*.mtxzero, matrices/*.mtx,
unknown_perman/*.mtx): --root names one, and without it the seeded
corpus of tools/corpus.py is written to a temporary directory.  Truth is
established by cross-engine arbitration, strongest first:

1. the exact modular-CRT permanent: a certified row of --known (the
   output of tools/exact_known.py), or computed inline where its price on
   the device is under 25 s;
2. the exact DFS on the degree-1/2-folded core (an independent exact
   algorithm; where both exist they must agree to f64 rounding);
3. the card's tf96 (integer matrices only), the native C++ double
   engine, the device's f64 walk.

A row that misses its tolerance is still "ok", flagged
`conditioning_limited`, where calc="auto" self-reported low confidence
and its bound covers the miss, or, for the native double tier, where the
suite's amplitude probe predicts the miss.

Classes:

* A (n <= exact_max_n): direct, sparse, compression and scaling configs
  under calc="auto" on the device, the native double engine (n <=
  native_max_n) and calc="exact" where exact is cheap;
* B (n above the bound, d1/d2 fixed-point core <= core_max_n):
  compression configs against the exact value or the core's DFS;
* B2 (a core above core_max_n and at most exact_max_n + 12 whose pruned
  walk the planner prices under 1200 s): compression configs under
  calc="auto", against the exact row of --known where there is one;
* C (the rest): the scaling SMC estimator at two seeds, which must agree
  within 3 sigma (or both self-report degeneracy);
* Z (no perfect matching): the engine must return 0;
* D (unknown_perman): the structural screen, SMC estimates of per(|A|)
  and, for signed files, Gurvits's signed estimates; rectangular files
  through the injection-sum permanent.

The bounds are priced on the device the suite runs on (`bounds_for`):
the JAX tool's EXACT_MAX_N = 39 and core bound 30 are what its dense walk
did in 2^38 / 4.5e9 and 2^29 / 4.5e9 seconds at 4.5 G steps/s; here the
same seconds at K1's rate on a card (ops.ryser.K1_GITERS) or the plain
version's on the CPU (PLAIN_K1_GITERS); NATIVE_MAX_N = 37 was a minute of
native walk, here a minute at the native engine's measured rate on this
host's threads.

    python -m superman_tpu_torch.tools.real_suite [--out PATH] [--quick]
        [--resume] [--root DIR] [--known FILE] [--device cpu]

--quick runs the 4 smallest orders and no class D.  Rows stream to
--out.partial, renamed to --out (default
build/tools/torch_real_suite.jsonl) at the end; --resume keeps the rows
of an interrupted run's .partial and skips their files.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np

from . import out_path, tool_device

#: seconds of dense walk that make the exact bound, and of core walk that
#: make class B's core bound: what the JAX tool's n = 39 and n = 30 cost
#: its walk at 4.5 G steps/s
EXACT_BUDGET_S = 2.0 ** 38 / 4.5e9
CORE_BUDGET_S = 2.0 ** 29 / 4.5e9
#: class B2: the pruned walk of the core, priced under this
B2_BUDGET_S = 1200.0
#: seconds of native double walk that make the native cross-check bound
NATIVE_BUDGET_S = 60.0
#: K1's plain version on the CPU, G Gray steps per second (df64):
#: tools/kernel_time.py --device cpu --n 24 --tier df64 (2^23 steps, 8
#: torch threads, median of 3) gave 0.018 and 0.020 on the x86_64 host of
#: an NVIDIA H100 80GB HBM3 machine
PLAIN_K1_GITERS = 0.02


@dataclasses.dataclass
class Bounds:
    exact_max_n: int
    core_max_n: int
    native_max_n: int
    #: the walk's rate that prices class B2, G Gray steps per second
    giters: float


def _max_n(budget_s: float, steps_per_s: float, per_step=lambda n: 1
           ) -> int:
    """The largest n with 2^(n-1) * per_step(n) steps in budget_s."""
    n = 1
    while (1 << n) * per_step(n + 1) / steps_per_s <= budget_s:
        n += 1
    return n


def bounds_for(device) -> Bounds:
    """The class bounds priced on `device` (module docstring)."""
    from ..ops.ryser import K1_GITERS
    from ..parallel.scheduler import NATIVE_ROW_STEPS_S
    giters = K1_GITERS["df64"] if device.type == "cuda" else PLAIN_K1_GITERS
    rate = giters * 1e9
    native = NATIVE_ROW_STEPS_S * (os.cpu_count() or 1)
    return Bounds(exact_max_n=_max_n(EXACT_BUDGET_S, rate),
                  core_max_n=_max_n(CORE_BUDGET_S, rate),
                  native_max_n=_max_n(NATIVE_BUDGET_S, native,
                                      lambda n: n),
                  giters=giters)


def _core_fixed_point(a: np.ndarray) -> np.ndarray:
    """Fold d1/d2 compressions to a fixed point (value-preserving)."""
    from ..prep.compression import (d1compress, d2compress, has_empty_line,
                                    min_degree)
    b = np.asarray(a, np.float64).copy()
    while b.shape[0] > 2 and not has_empty_line(b):
        md = min_degree(b)
        nb = d1compress(b) if md == 1 else (
            d2compress(b) if md == 2 else None)
        if nb is None:
            break
        b = nb
    return b


def _has_perfect_matching(a: np.ndarray) -> bool:
    from ..prep.dulmage_mendelsohn import max_bipartite_matching
    m = max_bipartite_matching((a != 0).astype(np.int8))
    return int(np.sum(np.asarray(m) >= 0)) == a.shape[0]


def _rel(x: float, ref: float) -> float:
    if ref == 0:
        return abs(x)
    return abs(x - ref) / abs(ref)


def load_exact_known(path) -> dict:
    """name -> certified row of tools/exact_known.py's output at `path`
    (none when there is no such file)."""
    out = {}
    if path and os.path.exists(path):
        with open(path) as fh:
            for ln in fh:
                if ln.strip():
                    d = json.loads(ln)
                    if d.get("engine") is not None or d["value"] == 0.0:
                        out[d["file"]] = d
    return out


def classify(a: np.ndarray, core_n: int, core: np.ndarray, bounds: Bounds,
             log=print, name="") -> str:
    """The class of a matrix that has a perfect matching."""
    n = a.shape[0]
    if n <= bounds.exact_max_n:
        return "A"
    if core_n <= bounds.core_max_n:
        return "B"
    if core_n <= bounds.exact_max_n + 12:
        # a sparse-feasible core: exact through the compression driver
        # and the pruned engine
        from ..ops.pruning import plan_sparse
        spn = plan_sparse(core, giters=bounds.giters)
        if spn is not None:
            est = ((1.0 - spn.dead_frac) * (1 << (core_n - 1))
                   / (bounds.giters * 1e9))
            if est < B2_BUDGET_S:
                log(f"{name}: sparse-feasible core (n={core_n}, "
                    f"dead={spn.dead_frac:.3f}, est {est:.3g} s)")
                return "B2"
    return "C"


def _seeds_agree(l1: float, s1: float, l2: float, s2: float) -> bool:
    """Two estimates (log2, stderr_rel) agree within 3 sigma in linear
    space, on the ratio of the smaller to the larger (so that permanents
    past the double range never materialise), or both seeds self-report
    degeneracy (stderr_rel >= 0.5); a non-finite estimate fails whatever
    the stderr says."""
    if not (np.isfinite(l1) and np.isfinite(l2)):
        return False
    hi, lo = (l1, l2) if l1 >= l2 else (l2, l1)
    shi = s1 if l1 >= l2 else s2
    slo = s2 if l1 >= l2 else s1
    d = float(np.exp2(lo - hi))
    sig = float(np.hypot(shi, slo * d))
    ok = (abs(1.0 - d) <= 3.0 * sig) if sig > 0 else (d == 1.0)
    return ok or min(s1, s2) >= 0.5


def _estimator_rows(target, base, cls, quick, emit, log, dev, extra=None,
                    name=None, rect=False) -> int:
    """The scaling SMC estimator's agreement across two seeds (classes C
    and D, _seeds_agree).  Returns the failures (0/1)."""
    import superman_tpu_torch as spt

    name = name or base["file"]
    trials = 20000 if quick else 100000
    ests = []
    for seed in (11, 12):
        t0 = time.perf_counter()
        r = spt.permanent(target, device=dev, approximation=True,
                          perman_algo="scaling", smc=1,
                          number_of_times=trials, seed=seed,
                          rectangular=rect)
        ests.append((float(r.meta["log2_estimate"]),
                     float(r.meta.get("stderr_rel") or 0.0),
                     time.perf_counter() - t0))
        log(f"{name}/est seed={seed}: log2 = {ests[-1][0]:.4f} "
            f"rel ± {ests[-1][1]:.3f} ({ests[-1][2]:.1f} s)")
    (l1, s1, w1), (l2, s2, w2) = ests
    ok = _seeds_agree(l1, s1, l2, s2)
    degenerate = bool(min(s1, s2) >= 0.5)
    row = {**base, "class": cls, "config": "estimator_x2",
           "log2_value": l1, "log2_value2": l2,
           "stderr_rel": s1, "stderr_rel2": s2, "wall_s": w1 + w2,
           "status": "ok" if ok else "FAIL", "trials": trials,
           "ref_source": "seed_agreement_3sigma_log2"}
    if degenerate:
        row["estimator_degenerate"] = True
    if extra:
        row.update(extra)
    emit(row)
    return int(not ok)


def _gurvits_rows(a, base, quick, emit, log, name, dev) -> int:
    """Gurvits's unbiased signed estimates of per(A) at two seeds (class
    D, signed files): equal nonzero signs and _seeds_agree, or both
    seeds degenerate."""
    import superman_tpu_torch as spt

    trials = 20000 if quick else 200000
    rect = a.shape[0] != a.shape[1]
    ests = []
    for seed in (31, 32):
        t0 = time.perf_counter()
        r = spt.permanent(a, device=dev, approximation=True,
                          perman_algo="gurvits", number_of_times=trials,
                          seed=seed, rectangular=rect)
        ests.append((float(r.meta["log2_estimate"]),
                     float(r.meta["sign"]),
                     float(r.meta.get("stderr_rel") or 0.0),
                     time.perf_counter() - t0))
        log(f"{name}/gurvits seed={seed}: sign={ests[-1][1]:+.0f} "
            f"log2|est| = {ests[-1][0]:.3f} rel ± {ests[-1][2]:.3g} "
            f"({ests[-1][3]:.1f} s)")
    (l1, g1, s1, w1), (l2, g2, s2, w2) = ests
    degenerate = bool(min(s1, s2) >= 0.5)
    ok = _seeds_agree(l1, s1, l2, s2) and (
        (g1 == g2 and g1 != 0.0) or degenerate)
    row = {**base, "class": "D", "config": "gurvits_signed_x2",
           "estimate_of": "per_rect" if rect else "per",
           "log2_abs_value": l1, "sign": g1,
           "log2_abs_value2": l2, "sign2": g2,
           "stderr_rel": s1, "stderr_rel2": s2,
           "wall_s": w1 + w2, "trials": trials,
           "status": "ok" if ok else "FAIL",
           "ref_source": "seed_agreement_signed"}
    if degenerate:
        row["estimator_degenerate"] = True
    emit(row)
    return int(not ok)


def _order(path) -> int:
    """The order in a file's size line (triplet or MatrixMarket)."""
    with open(path) as fh:
        for line in fh:
            if not line.startswith("%"):
                return int(line.split()[0])
    raise ValueError(f"{path}: no size line")


def _run_configs(path, configs, dev, log, name):
    """{config: (value or None, wall, meta["auto"])}; a raise is a row."""
    import superman_tpu_torch as spt
    vals = {}
    for cfg, kw in configs:
        t0 = time.perf_counter()
        try:
            r = spt.permanent(path, device=dev, **kw)
            vals[cfg] = (float(r.permanent), time.perf_counter() - t0,
                         r.meta.get("auto"))
        except Exception as e:     # noqa: BLE001 -- a crash is a finding
            vals[cfg] = (None, time.perf_counter() - t0, None)
            log(f"{name}/{cfg}: EXCEPTION {e!r}")
    return vals


def _low_confidence_covers(am, v, ref_val) -> bool:
    """calc="auto" flagged the value and its bound covers the miss."""
    return bool(am and am.get("low_confidence")
                and abs(v - ref_val) <= 1e3 * float(am["err_est"])
                * max(abs(v), 1e-300))


def run_suite(root: str, out_file: str, quick: bool = False,
              resume: bool = False, device=None, known=None,
              bounds: Bounds = None, log=print) -> int:
    """Run the suite over the corpus at `root`; return the failures."""
    dev = tool_device(device)
    import superman_tpu_torch as spt
    from ..drivers.runner import _amp_probe_log2
    from ..io.matrixmarket import read_any
    from ..ops.exact import (_float_of_fraction, exact_cost_estimate,
                             perman_exact_fraction)
    from ..ops.oracle import perman_brute
    from .corpus import corpus, corpus_unknown

    bounds = bounds or bounds_for(dev)
    log(f"bounds on {dev}: {dataclasses.asdict(bounds)}")
    exact_known = load_exact_known(known)
    failures = 0
    rows = []
    done_files = set()
    if resume and os.path.exists(out_file + ".partial"):
        with open(out_file + ".partial") as fh:
            rows = [json.loads(ln) for ln in fh if ln.strip()]
        done_files = {r["file"] for r in rows}
        failures = sum(r.get("status") not in ("ok", None) for r in rows)
        log(f"resuming: {len(rows)} rows / {len(done_files)} files kept, "
            f"{failures} prior failures")
    out_f = open(out_file + ".partial", "w")
    try:
        for r in rows:
            out_f.write(json.dumps(r) + "\n")
        out_f.flush()

        def emit(row):
            row = {**row, "device": str(dev)}
            rows.append(row)
            out_f.write(json.dumps(row) + "\n")
            out_f.flush()

        # exact classes first; the estimator-only files last
        files = sorted(corpus(root), key=_order)
        if quick:
            files = files[:4]          # the 4 smallest orders
        for path in files:
            name = os.path.basename(path)
            if name in done_files:
                continue
            a = np.asarray(read_any(path).mat, np.float64)
            n = a.shape[0]
            nnz = int((a != 0).sum())
            core = _core_fixed_point(a)
            core_n = int(core.shape[0])
            base = {"file": name, "n": n, "nnz": nnz,
                    "density": nnz / n ** 2, "core_n": core_n}
            if not _has_perfect_matching(a):
                # structurally singular: every engine must return 0
                r = spt.permanent(a, device=dev, compression=True)
                ok = r.permanent == 0.0
                emit({**base, "class": "Z", "config": "compression",
                      "value": r.permanent, "wall_s": r.time,
                      "status": "ok" if ok else "FAIL", "ref_value": 0.0,
                      "ref_source": "no_perfect_matching"})
                failures += not ok
                log(f"{name}: structurally singular, engine says "
                    f"{r.permanent}")
                continue
            cls = classify(a, core_n, core, bounds, log, name)

            if cls == "B2":
                # calc="auto" on the folded core: the ladder self-reports
                # where the walk is not to be trusted
                vals = _run_configs(
                    path, [("compression",
                            {"compression": True, "calc": "auto"}),
                           ("compression_scaling",
                            {"compression": True, "calc": "auto",
                             "scaling_threshold": 2.0})], dev, log, name)
                kn = exact_known.get(name)
                if kn is not None:
                    ref_val, ref_src = float(kn["value"]), "exact_crt_known"
                else:
                    ref_val, ref_src = (vals["compression"][0],
                                        "df64_vs_sinkhorn_cross")
                for cfg, (v, w, am) in vals.items():
                    cond = False
                    if v is None or ref_val is None:
                        status, rel = "EXCEPTION", None
                    else:
                        rel = _rel(v, ref_val)
                        status = "ok" if rel <= 1e-5 else "FAIL"
                        if status == "FAIL" and ref_val != 0 \
                                and _low_confidence_covers(am, v, ref_val):
                            status, cond = "ok", True
                    row = {**base, "class": cls, "config": cfg, "value": v,
                           "wall_s": w, "status": status,
                           "rel_err_vs_ref": rel, "ref_value": ref_val,
                           "ref_source": ref_src}
                    if cond:
                        row["conditioning_limited"] = True
                    if am:
                        row["auto"] = am
                    emit(row)
                    failures += status != "ok"
                    log(f"{name}/{cfg}: {v} rel={rel} [{status}]"
                        + (" (conditioning-limited)" if cond else "")
                        + f" {w:.1f}s")
                continue

            if cls == "C":
                failures += _estimator_rows(path, base, "C", quick, emit,
                                            log, dev)
                continue

            # classes A and B.  Arbiter #1: the exact CRT permanent, from
            # --known, else computed inline where it is cheap
            ref_val, ref_src = None, None
            exact_cheap = False
            kn = exact_known.get(name)
            if kn is not None:
                ref_val, ref_src = float(kn["value"]), "exact_crt_known"
                exact_cheap = kn["wall_s"] < 25.0
            else:
                try:
                    esecs, _, _ = exact_cost_estimate(a, dev, budget_s=25.0)
                except (OverflowError, ValueError):
                    esecs = math.inf
                if esecs < 25.0:
                    frac, emeta = perman_exact_fraction(a, dev)
                    ref_val = _float_of_fraction(frac)
                    ref_src, exact_cheap = "exact_crt", True
                    log(f"{name}: exact CRT per = {ref_val:.12e} "
                        f"({emeta['wall_s']:.2f} s)")
            # #2: exact DFS on the folded core, its own row where #1 is
            # there too
            if core_n <= 18:
                t0 = time.perf_counter()
                dfs = float(perman_brute(core))
                if ref_val is None:
                    ref_val = dfs
                    ref_src = f"dfs_core_n{core_n}"
                else:
                    xrel = _rel(dfs, ref_val)
                    emit({**base, "class": cls, "config": "exact_vs_dfs",
                          "value": dfs,
                          "wall_s": time.perf_counter() - t0,
                          "status": "ok" if xrel <= 1e-12 else "FAIL",
                          "rel_err_vs_ref": xrel, "ref_value": ref_val,
                          "ref_source": ref_src})
                    failures += xrel > 1e-12
                log(f"{name}: core DFS per = {dfs:.12e} "
                    f"({time.perf_counter() - t0:.2f} s)")
            # the device configs run calc="auto": real matrices carry real
            # cancellation, and the ladder's probes exist for it; the
            # exact rung may spend up to 240 s
            au = {"calc": "auto", "auto_exact_budget_s": 240.0}
            if cls == "A":
                configs = [("direct", dict(au)),
                           ("sparse", {"sparse": True, "preprocessing": 2,
                                       **au}),
                           ("compression", {"compression": True, **au}),
                           ("scaling", {"scaling_threshold": 2.0,
                                        "compression": True, **au})]
                if n <= bounds.native_max_n:
                    configs.append(("native_double",
                                    {"cpu": True, "gpu": False,
                                     "sparse": True, "preprocessing": 2}))
            else:
                configs = [("compression", {"compression": True, **au}),
                           ("compression_scaling",
                            {"compression": True, "scaling_threshold": 2.0,
                             **au}),
                           ("native_compression",
                            {"compression": True, "cpu": True,
                             "gpu": False})]
            if exact_cheap:
                # calc="exact" end to end must reproduce the arbiter
                configs.append(("exact", {"calc": "exact"}))
            vals = _run_configs(path, configs, dev, log, name)
            if ref_val is None:
                # #3: tf96 on integer matrices (on other storage it falls
                # back to df64, which would arbitrate itself), else the
                # native double engine, else the device's f64 walk
                ints = bool(np.all(a == np.round(a))
                            and np.abs(a).max() < 2 ** 22)
                t0 = time.perf_counter()
                if ints:
                    r = spt.permanent(path, device=dev, calc="tf96")
                    ref_val, ref_src = float(r.permanent), "card_tf96"
                elif vals.get("native_double", (None,))[0] is not None:
                    ref_val, ref_src = (vals["native_double"][0],
                                        "native_double")
                else:
                    r = spt.permanent(path, device=dev, calc="f64")
                    ref_val, ref_src = float(r.permanent), "device_f64"
                log(f"{name}: {ref_src} arbiter = {ref_val:.12e} "
                    f"({time.perf_counter() - t0:.2f} s)")
            # the Ryser sum's amplitude: the irreducible error scale of
            # every fixed-precision engine
            amp_abs_l2 = _amp_probe_log2(a)
            for cfg, (v, w, am) in vals.items():
                cond = False
                if v is None:
                    status, rel = "EXCEPTION", None
                else:
                    rel = _rel(v, ref_val)
                    # tier contracts against the arbiter, which carries
                    # its own limits: native double ~amp * 2^-53
                    if cfg == "exact":
                        tol = 1e-12      # the same integer, f64-rounded
                    elif cfg in ("direct", "sparse"):
                        tol = (1e-7 if ref_src == "card_tf96"
                               or ref_src.startswith("dfs_core")
                               or ref_src.startswith("exact_crt")
                               else 1e-6)
                    else:
                        tol = 1e-5       # transforms merge entries
                    status = "ok" if rel <= tol else "FAIL"
                    if status == "FAIL" and ref_val != 0:
                        if _low_confidence_covers(am, v, ref_val):
                            status, cond = "ok", True
                        elif (cfg == "native_double"
                              and np.isfinite(amp_abs_l2)):
                            pred = 2.0 ** (amp_abs_l2 - 53.0)
                            if (pred > tol * abs(ref_val)
                                    and abs(v - ref_val) <= 1e3 * pred):
                                status, cond = "ok", True
                row = {**base, "class": cls, "config": cfg, "value": v,
                       "wall_s": w, "status": status,
                       "rel_err_vs_ref": rel, "ref_value": ref_val,
                       "ref_source": ref_src}
                if cond:
                    row["conditioning_limited"] = True
                if am:
                    row["auto"] = am
                emit(row)
                failures += status != "ok"
                log(f"{name}/{cfg}: {v} rel={rel} [{status}]"
                    + (" (conditioning-limited)" if cond else ""))

        # class D: the unknown_perman corpus.  The structural screen
        # first (no perfect matching certifies per = 0); SMC estimates of
        # per(|A|) for the rest (the sampler needs nonnegative weights;
        # per(|A|) >= |per(A)| is the honest magnitude bound), and
        # Gurvits's signed estimates beside them on signed files
        for path in ([] if quick else corpus_unknown(root)):
            name = os.path.basename(path)
            if name in done_files:
                continue
            try:
                dm = read_any(path)
            except ValueError as e:
                # not square: the square permanent is undefined, the
                # rectangular (injection-sum) one is estimated
                emit({"file": name, "class": "D", "config": "screen",
                      "status": "ok", "note": "non_square_permanent_undefined",
                      "detail": str(e)[-60:]})
                log(f"{name}: non-square; running the rectangular "
                    f"estimators")
                a = np.asarray(read_any(path, allow_rect=True).mat,
                               np.float64)
                m_, n_ = (a.shape if a.shape[0] <= a.shape[1]
                          else (a.shape[1], a.shape[0]))
                base = {"file": name, "n": int(n_),
                        "nnz": int((a != 0).sum()),
                        "rect_shape": [int(m_), int(n_)],
                        "corpus": "unknown_perman"}
                failures += _estimator_rows(
                    np.abs(a), base, "D", quick, emit, log, dev,
                    extra={"estimate_of": "per_abs_rect"}, name=name,
                    rect=True)
                if not bool(np.all(a >= 0.0)):
                    failures += _gurvits_rows(a, base, quick, emit, log,
                                              name, dev)
                continue
            a = np.asarray(dm.mat, np.float64)
            n = a.shape[0]
            nnz = int((a != 0).sum())
            base = {"file": name, "n": n, "nnz": nnz,
                    "density": nnz / n ** 2, "corpus": "unknown_perman"}
            if not _has_perfect_matching(a):
                t0 = time.perf_counter()
                r = spt.permanent(a, device=dev, compression=True)
                ok = r.permanent == 0.0
                emit({**base, "class": "D", "config": "structural_zero",
                      "value": r.permanent,
                      "wall_s": time.perf_counter() - t0,
                      "status": "ok" if ok else "FAIL", "ref_value": 0.0,
                      "ref_source": "no_perfect_matching"})
                failures += not ok
                log(f"{name}: structurally singular (certified per = 0); "
                    f"engine says {r.permanent}")
                continue
            signless = bool(np.all(a >= 0.0))
            failures += _estimator_rows(
                a if signless else np.abs(a), base, "D", quick, emit, log,
                dev, extra={} if signless else {"estimate_of": "per_abs"},
                name=name)
            if not signless:
                failures += _gurvits_rows(a, base, quick, emit, log, name,
                                          dev)
    finally:
        out_f.close()
    os.replace(out_file + ".partial", out_file)
    log(f"real suite: {len(rows)} rows, {failures} failures -> {out_file}")
    return failures


def main(argv=None) -> int:
    from .corpus import real_root
    p = argparse.ArgumentParser(prog="superman-torch-real-suite",
                                description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="default build/tools/torch_real_suite.jsonl")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="keep the rows of an interrupted run's .partial "
                        "and skip their files")
    p.add_argument("--root", default=None,
                   help="corpus root (default: the seeded corpus, written "
                        "to a temporary directory)")
    p.add_argument("--small", action="store_true",
                   help="the seeded corpus at the CPU's orders")
    p.add_argument("--known", default=None,
                   help="exact_known's output (default "
                        "build/tools/torch_exact_known.jsonl where it "
                        "exists)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    args = p.parse_args(argv)
    dev = tool_device(args.device)
    known = args.known or out_path("torch_exact_known.jsonl")
    with real_root(args.root, small=args.small) as root:
        fails = run_suite(root, args.out or out_path("torch_real_suite.jsonl"),
                          quick=args.quick, resume=args.resume, device=dev,
                          known=known, log=lambda s: print(s, flush=True))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
