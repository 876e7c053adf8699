"""The port's headline bench: the n=32 dense exact permanent on the card in
Gray-code iterations a second, beside the other tiers and the sparse walk.

    python -m superman_tpu_torch.tools.bench [--root DIR] [--device cpu]
        [--reps K] [--n N] [--chunk-log2 R]

The counterpart of the JAX package's root bench.py, measured through the
port's public entry point (superman_tpu_torch.permanent) as bench.py
measures through superman_tpu.permanent:

* int/{n}_0.50_0 under calc="df64": one warm-up call (on a card the
  first call also builds the kernels with nvcc, outside every timed run),
  then the best of K (default 5) by Result.time.  The headline is
  Result.iterations / Result.time in G iters/s, and vs_baseline its ratio
  to BASELINE_ITERS_PER_SEC;
* the same matrix under f32 and f32k (warm-up, best of K) and tf96
  (warm-up, best of min(K, 3));
* int/{n}_0.20_0 under df64, once dense (skip_pruning=False: from n=28 at
  density < 0.30 the engine prunes by itself otherwise) and once with
  sparse=True, each warmed up and then the best of K; the speedup is the
  dense Result.time over the sparse one.

The matrices: with --root, {root}/int/32_0.50_0 and {root}/int/32_0.20_0
(io/triplet.read_triplet), held to the reference's native double values
NATIVE_DOUBLE_VALUE and SPARSE_VALID, which bench.py holds them to;
without it, the seeded stand-ins of the same names from tools/corpus.py
(seed 0), held to their exact permanents: pinned below at n=32, computed
by calc="exact" on the same device at another --n.

The output, printed last, is one JSON line with the keys of bench.py's
(metric, value, unit, vs_baseline and the detail keys that keep their
meaning; the error of the headline is named after its oracle,
rel_err_vs_exact or rel_err_vs_native_double) and beside them: each
tier's value and error, the card (nvidia-smi's name and power limit) and,
for every measured call under "runs", each run's Result.time and host
wall, their medians, the warm-up's host wall and each run's spans
(Result.meta["spans"]).  Result.time is the engine's own clock, from the
start of ops/ryser.ryser_exact to its value (the sparse planner
included); the host wall is perf_counter around the whole permanent()
call, the input's handling and the spans included.  The headline reads
Result.time, as bench.py does.

An error past its limit (LIMITS; under --root each is widened to the
reference double's own error, NATIVE_DOUBLE_REL) is printed on stderr,
no line is printed, and the exit code is 1.  The bench runs on the card
unless --device names another; without CUDA it raises, as every tool of
the port does.  tools/capture_bench.py records a run of it in a file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from fractions import Fraction

from . import tool_device

#: bench.py's baseline, kept so that vs_baseline means what it means
#: there: the reference project's estimate for its double-calc CUDA kernel
#: on two V100-class GPUs (2^31 iterations at n=32 in ~0.5 s), not a
#: measurement and no TPU figure
BASELINE_ITERS_PER_SEC = 4.3e9
#: the reference's oracles for its int/32_0.50_0 and int/32_0.20_0 (the
#: native C++ double engine, long-double accumulation), bench.py's
#: NATIVE_DOUBLE_VALUE and SPARSE_VALID
NATIVE_DOUBLE_VALUE = 1.6379790881209674e+41
SPARSE_VALID = 3.0796642024820435e+27
#: how far such a double may stand from the exact value: the native
#: engine's n=32 double walk is held to 1e-11 of the exact integer
NATIVE_DOUBLE_REL = 1e-11
#: per() of tools/corpus.suite_matrix(0, 32, "0.50", 0) and of
#: suite_matrix(0, 32, "0.20", 0), from the JAX package's modular CRT
#: engine: superman_tpu.ops.exact.perman_exact_fraction(a, engine="native")
EXACT_N32 = {"0.50": 251959323310566734628232464861609533729,
             "0.20": 303453267089038626127269552}
#: the reference's CPU SkipPer seconds on its own int/32_0.20_0
#: (BASELINE.md), bench.py's sparse_ref_cpu_skipper_s
SKIPPER_CPU_S = [0.563, 1.30]
#: relative error limits against an exact integer, by measured call
LIMITS = {"df64": 1e-9, "f32": 5e-2, "f32k": 1e-3, "tf96": 1e-15,
          "sparse_dense": 1e-9, "sparse": 1e-9}
TIERS = ("df64", "f32", "f32k", "tf96")
TF96_REPS = 3
DENSE, SPARSE = "0.50", "0.20"


def rel_err(got: float, want) -> float:
    """|got - want| / |want| in exact arithmetic (`want` may be an integer
    beyond 2^53)."""
    want = Fraction(want)
    return float(abs(Fraction(got) - want) / abs(want))


def matrices(n: int, root=None):
    """{density: (name, DenseMatrix, oracle value)} and the oracle's
    name; the oracle value is None where it must be computed."""
    from ..core.matrix import DenseMatrix
    from ..io.triplet import read_triplet
    from .corpus import suite_matrix
    out = {}
    for d in (DENSE, SPARSE):
        name = f"int/{n}_{d}_0"
        if root is not None:
            if n != 32:
                raise ValueError("--root holds the reference's n=32 files "
                                 "to its n=32 values: --n must be 32")
            want = NATIVE_DOUBLE_VALUE if d == DENSE else SPARSE_VALID
            out[d] = (name, read_triplet(os.path.join(root, name)), want)
        else:
            out[d] = (f"{name} (tools/corpus.py, seed 0)",
                      DenseMatrix(suite_matrix(0, n, d, 0), "int"),
                      EXACT_N32[d] if n == 32 else None)
    return out, ("native_double" if root is not None else "exact")


def _timed(fn):
    t = time.perf_counter()
    res = fn()
    return res, time.perf_counter() - t


def _runs(fn, k: int):
    """One warm-up call, then k: (the run of least Result.time, the
    record of every run)."""
    _, warm = _timed(fn)
    runs = [_timed(fn) for _ in range(k)]
    times = [r.time for r, _ in runs]
    walls = [w for _, w in runs]
    rec = {"warmup_s": warm, "result_time_s": times, "host_wall_s": walls,
           "median_result_time_s": statistics.median(times),
           "median_host_wall_s": statistics.median(walls),
           "spans": [r.meta.get("spans", []) for r, _ in runs]}
    return min((r for r, _ in runs), key=lambda r: r.time), rec


def measure(device=None, root=None, n: int = 32, reps: int = 5,
            chunk_log2=None, log=None) -> dict:
    """Run the bench on `device` (None: the card) and return its line."""
    dev = tool_device(device)
    import superman_tpu_torch as spt
    from .kernel_time import smi
    log = log or (lambda s: None)
    mats, oracle = matrices(n, root)
    wants = {}
    for d, (name, dm, want) in mats.items():
        if want is None:
            want = spt.permanent(dm, device=dev, calc="exact"
                                 ).meta["exact_fraction"]
        wants[d] = want
    extra = {} if chunk_log2 is None else {"chunk_log2": chunk_log2}
    calls = [(t, DENSE, dict(calc=t),
              min(reps, TF96_REPS) if t == "tf96" else reps) for t in TIERS]
    calls += [("sparse_dense", SPARSE, dict(calc="df64", skip_pruning=False),
               reps),
              ("sparse", SPARSE, dict(calc="df64", sparse=True), reps)]
    best, runs, errs = {}, {}, {}
    for tag, d, kw, k in calls:
        dm = mats[d][1]
        best[tag], runs[tag] = _runs(lambda: spt.permanent(
            dm, device=dev, **kw, **extra), k)
        errs[tag] = rel_err(best[tag].permanent, wants[d])
        log(f"{tag}: {best[tag].permanent!r} in {best[tag].time:.6f} s, "
            f"rel err {errs[tag]:.3e}")
    limits = {t: (max(v, NATIVE_DOUBLE_REL) if oracle == "native_double"
                  else v) for t, v in LIMITS.items()}

    def rate(tag):
        return best[tag].iterations / best[tag].time

    df = best["df64"]
    sname = f"sparse_n{n}_d020"
    detail = {
        "calc": "df64 (reference double-calc parity)",
        "policy": f"warm best-of-{reps} (tf96 best-of-{min(reps, TF96_REPS)})"
                  " by Result.time after a warm-up call",
        "wall_s": df.time,
        "permanent": df.permanent,
        f"rel_err_vs_{oracle}": errs["df64"],
        "matrix": mats[DENSE][0],
        "oracle": oracle,
        "device": str(dev),
        "card": smi() if dev.type == "cuda" else None,
    }
    for t in TIERS[1:]:
        detail.update({f"{t}_g_iters_per_sec": rate(t) / 1e9,
                       f"{t}_wall_s": best[t].time,
                       f"{t}_rel_err": errs[t],
                       f"{t}_permanent": best[t].permanent})
    detail.update({
        f"{sname}_wall_s": best["sparse"].time,
        f"{sname}_dense_wall_s": best["sparse_dense"].time,
        "sparse_vs_dense_speedup": (best["sparse_dense"].time
                                    / best["sparse"].time),
        "sparse_rel_err": errs["sparse"],
        "sparse_plan": best["sparse"].meta.get("sparse"),
        "sparse_permanent": best["sparse"].permanent,
        "sparse_dense_rel_err": errs["sparse_dense"],
        "sparse_dense_permanent": best["sparse_dense"].permanent,
        "sparse_matrix": mats[SPARSE][0],
    })
    if oracle == "native_double":
        detail["sparse_ref_cpu_skipper_s"] = SKIPPER_CPU_S
    detail["limits"] = limits
    detail["runs"] = runs
    return {"metric": f"n{n}_dense_exact_gray_iters_per_sec_per_chip",
            "value": rate("df64") / 1e9,
            "unit": "G iters/s",
            "vs_baseline": rate("df64") / BASELINE_ITERS_PER_SEC,
            "detail": detail}


def errors(line: dict) -> dict:
    """{measured call: relative error} of a bench line."""
    d = line["detail"]
    out = {"df64": d[f"rel_err_vs_{d['oracle']}"],
           "sparse_dense": d["sparse_dense_rel_err"],
           "sparse": d["sparse_rel_err"]}
    out.update({t: d[f"{t}_rel_err"] for t in TIERS[1:]})
    return out


def failures(line: dict) -> list:
    """The measured calls whose error passes its limit, as text."""
    lim = line["detail"]["limits"]
    return [f"{tag}: rel err {e:.3e} past its limit {lim[tag]:.0e}"
            for tag, e in errors(line).items() if not e <= lim[tag]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="superman-torch-bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="directory holding the reference's int/32_0.50_0 "
                        "and int/32_0.20_0 (default: the seeded stand-ins)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    p.add_argument("--reps", type=int, default=5,
                   help="timed runs a measured call (tf96: at most 3)")
    p.add_argument("--n", type=int, default=32,
                   help="order of the seeded matrices (--root: 32 only)")
    p.add_argument("--chunk-log2", type=int, default=None,
                   help="chunk length of the walks (default: the engine's)")
    args = p.parse_args(argv)
    line = measure(args.device, args.root, args.n, args.reps,
                   args.chunk_log2,
                   log=lambda s: print(f"bench: {s}", file=sys.stderr))
    bad = failures(line)
    for s in bad:
        print(f"bench: {s}", file=sys.stderr)
    if bad:
        return 1
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
