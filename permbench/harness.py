"""One run of one cell of the port's benchmark.

    python3 -m permbench --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--control]

A cell of BENCHMARK.json names a configuration (permbench/configs/, the
int suite's density and the guarantee of each tier) and a traffic mix
(permbench/traffic/<name>.json: the entry point, the order, the batch,
the tier, the pool and the size of the check); a per-layer metric is the
reader permbench/metrics/<name>.py.  The harness finds each by its name,
so a cell, a configuration or a metric is added by adding files.

A run makes the cell's pool of matrices from --seed, warms up the
program (the kernels' build, the cell's tier and N_PAD), then calls the
entry point in a closed loop, one caller, for --seconds: each call is
made when the last has returned, and the window ends with the first call
that returns past its end.  With --trace 0 the line holds the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read under
torch.profiler.  Once the window has closed the answers of a sample of
the pool's matrices, drawn from the seed with the slowest call's matrix
in it, are held to the plain reference (reference.py): every answer the
window gave for each of them.  --control runs the configuration's lower
tier in the program's place; the benchmark's own runs never do.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the checks,
each number beside its limit); the checks are also the last lines of
standard error.  No result is printed, and the exit code is not 0, where
CUDA is absent, the card count is short, or jax, jaxlib, flax or the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from fractions import Fraction
from pathlib import Path
from typing import Optional

import numpy as np

from . import gen
from .devtrace import CALL, WINDOW

#: the checkout this harness runs from
CHECKOUT = Path(__file__).resolve().parent.parent
#: top-level modules that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "superman_tpu")


def process_start(fallback: float) -> float:
    """perf_counter() at the start of this process (Linux), else
    `fallback`."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError):
        return fallback
    return time.perf_counter() - age if 0 <= age < 60 else fallback


def forbidden_modules(modules) -> list:
    """The top-level names of `modules` that FORBIDDEN holds."""
    return sorted({m.split(".", 1)[0] for m in modules} & set(FORBIDDEN))


def cache_env(checkout: Path) -> None:
    """Keep every build and kernel cache in fixed directories of the
    checkout (the program's own kernels build under build/ by
    themselves)."""
    base = checkout / "build" / "permbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda")


# ---- the registry: everything a cell needs, found by name

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(checkout: Path = CHECKOUT) -> dict:
    return load_json(checkout / "BENCHMARK.json")


def find(entries: list, name: str, kind: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {kind} named {name!r} in BENCHMARK.json")


def load_metric(checkout: Path, name: str):
    """The reader module permbench/metrics/<name>.py."""
    path = checkout / "permbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"permbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list          # [(entry, reader module)]


def load_cell(name: str, checkout: Path = CHECKOUT) -> Cell:
    bench = load_bench(checkout)
    w = find(bench["workloads"], name, "workload")
    cfg_entry = find(bench["configs"], w["config"], "config")
    config = load_json(checkout / cfg_entry["file"])
    traffic = load_json(checkout / "permbench" / "traffic"
                        / f"{w['traffic']}.json")

    def mine(m):
        return name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    per_layer = [(m, load_metric(checkout, m["name"]))
                 for m in bench["per_layer"] if mine(m)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


# ---- the window

@dataclasses.dataclass
class Call:
    """What a metric reads of one call of the window."""
    item: int                # the pool item it was given
    wall_s: float            # host clock from the call to its value
    perms: int               # permanents it returned
    spans: dict              # the program's spans, seconds by name
    calc: str = ""           # the tier the program ran
    iterations: int = 0      # Gray steps the program walked (a matrix)
    factored_rows: Optional[int] = None   # the reduced walk's; None: dense
    core_n: int = 0          # calc="exact": the order of the core walked
    primes: int = 0          # calc="exact": primes walked, verifier too


def _summarize(res) -> dict:
    """Call fields of one Result."""
    meta = res.meta
    out = {"calc": str(meta.get("calc", "")),
           "iterations": int(res.iterations)}
    sp = meta.get("sparse")
    if sp is not None:
        out["factored_rows"] = int(sp["factored_rows"])
    ex = meta.get("exact")
    if ex is not None:
        out["core_n"] = int(ex["core_n"])
        out["primes"] = int(ex["nprimes"] or 0) + 1
        out["calc"] = "exact"
    return out


def _span_sums(spans) -> dict:
    out = {}
    for name, dt in spans or ():
        out[name] = out.get(name, 0.0) + dt
    return out


def make_call(spt, traffic: dict, tier: Optional[str], device):
    """fn(item) -> (answers, permanents, a Result): one call of the entry
    point.  answers: one a matrix, (exact Fraction, float) under
    calc="exact", else the float."""
    kw = dict(traffic.get("flags", {}))
    if tier is not None:
        kw["calc"] = tier
    dev = None if device.type == "cuda" else str(device)
    entry = traffic["entry"]
    exact = tier == "exact"

    def answer(res):
        if exact:
            frac = res.meta.get("exact_fraction")
            return (frac, res.permanent)
        return res.permanent

    if entry == "permanent":
        def call(m):
            res = spt.permanent(m, device=dev, **kw)
            return [answer(res)], 1, res
    elif entry == "permanent_batch":
        def call(ms):
            rs = spt.permanent_batch(ms, device=dev, **kw)
            return [answer(r) for r in rs], len(rs), rs[0]
    else:
        raise ValueError(f"unknown entry {entry!r}")
    return call


@contextlib.contextmanager
def span_marks(torch):
    """While traced, put each span of the program (utils/trace.timer) on
    the profiler's timeline, so that idle gaps can be labelled by it."""
    from superman_tpu_torch.utils import trace
    from .devtrace import SPAN
    orig = trace.timer

    @contextlib.contextmanager
    def timer(name, level=2):
        with torch.profiler.record_function(SPAN + name), orig(name, level):
            yield
    trace.timer = timer
    try:
        yield
    finally:
        trace.timer = orig


def run_window(call, pool: list, seconds: float, log, mark=None):
    """The closed loop: (calls, answers by item, failed, t_start, t_end).
    mark(name): a context put around each call (the profiler's)."""
    mark = mark or (lambda name: contextlib.nullcontext())
    calls, answers = [], {}
    failed = 0
    k = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        item = k % len(pool)
        c0 = time.perf_counter()
        try:
            with mark(CALL):
                got, perms, res = call(pool[item])
        except Exception as e:         # a failed call is counted, not fatal
            c1 = time.perf_counter()
            failed += 1
            log(f"call {k} (item {item}) failed: {type(e).__name__}: {e}")
            calls.append(Call(item, c1 - c0, 0, {}))
        else:
            c1 = time.perf_counter()
            calls.append(Call(item, c1 - c0, perms,
                              _span_sums(res.meta.get("spans")),
                              **_summarize(res)))
            answers.setdefault(item, []).append(got)
        k += 1
        if c1 >= deadline:
            break
    return calls, answers, failed, t_start, time.perf_counter()


def tenths(calls: list, window_s: float) -> list:
    """Permanents a second in each tenth of the window (by when each call
    ended), to show a trend inside it."""
    out, t = [0] * 10, 0.0
    for c in calls:
        t += c.wall_s
        out[min(9, int(10 * t / window_s))] += c.perms
    return [round(10 * v / window_s, 1) for v in out]


# ---- the check

def sample_items(seed: int, calls: list, count: int) -> list:
    """`count` items drawn from the seed among those the window answered,
    and the slowest call's item."""
    done = sorted({c.item for c in calls if c.perms})
    if not done:
        return []
    rng = np.random.default_rng([seed % (1 << 64), 0x5EED])
    pick = set(rng.choice(done, size=min(count, len(done)),
                          replace=False).tolist())
    slow = max((c for c in calls if c.perms), key=lambda c: c.wall_s)
    pick.add(slow.item)
    return sorted(pick)


def check(kind: str, pool: list, answers: dict, items: list, ref_dev,
          log) -> dict:
    """The compared numbers of the sampled items' answers, against the
    plain reference: {"max_rel_err": x} for a float tier, {"mismatches":
    k} for calc="exact"; and how many answers were checked."""
    from . import reference
    worst, bad, checked = 0.0, 0, 0
    for item in items:
        mats = pool[item]
        mats = mats if isinstance(mats, list) else [mats]
        if kind == "exact":
            refs = [reference.perm_exact(m, ref_dev) for m in mats]
        else:
            refs = [reference.perm_f64(m, ref_dev) for m in mats]
        item_err, item_bad = 0.0, 0
        for got in answers.get(item, ()):
            for j, ref in enumerate(refs):
                checked += 1
                if kind == "exact":
                    frac, val = got[j] if isinstance(got[j], tuple) \
                        else (None, got[j])
                    if frac is None:
                        frac = Fraction(val) if math.isfinite(val) else None
                    item_bad += frac != ref or val != float(ref)
                else:
                    err = abs(got[j] - ref) / abs(ref) if ref else \
                        abs(got[j])
                    item_err = max(item_err, err if math.isfinite(err)
                                   else math.inf)
        worst, bad = max(worst, item_err), bad + item_bad
        log(f"item {item}: {len(answers.get(item, ()))} answers, "
            + (f"{item_bad} mismatched" if kind == "exact"
               else f"largest error {item_err!r}"))
    out = {"mismatches": bad} if kind == "exact" else {"max_rel_err": worst}
    out["checked"] = checked
    return out


# ---- one run

def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", control: bool = False,
             t0: Optional[float] = None, log=None) -> dict:
    """One run: the result line's object, checks last."""
    if t0 is None:
        t0 = time.perf_counter()
    if log is None:
        def log(msg):
            print(f"[permbench] {msg}", file=sys.stderr, flush=True)
    import torch
    import superman_tpu_torch as spt

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    tr, cfg = cell.traffic, cell.config
    tier = tr["control_calc"] if control else tr.get("calc")
    guarantee = cfg["guarantee"][tr.get("calc") or cfg["default_calc"]]
    kind = "exact" if (tr.get("calc") == "exact") else "float"
    n, batch = int(tr["order"]), int(tr.get("batch", 1))
    pool = gen.pool(seed, n, float(cfg["density"]), int(tr["pool"]), batch)
    if batch > 1:
        pool = [list(stack) for stack in pool]
    call = make_call(spt, tr, tier, dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    for k in range(int(tr["warmup_calls"])):
        call(pool[k % len(pool)])
    sync()
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)

        def profiler():
            return torch.profiler.profile(activities=acts)
        # the profiler's own start-up belongs to set-up
        with profiler(), span_marks(torch):
            call(pool[0])
            sync()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")

    if traced:
        with profiler() as prof, span_marks(torch):
            with torch.profiler.record_function(WINDOW):
                calls, answers, failed, t_start, t_end = run_window(
                    call, pool, seconds, log,
                    mark=torch.profiler.record_function)
    else:
        calls, answers, failed, t_start, t_end = run_window(
            call, pool, seconds, log)
    sync()
    window_s = t_end - t_start
    walls = np.array([c.wall_s for c in calls])
    perms = sum(c.perms for c in calls)
    q = np.percentile(walls, [0, 50, 95, 100]) * 1e3
    log(f"{len(calls)} calls, {perms} permanents, {failed} failed, "
        f"window {window_s:.3f} s; a call's ms: mean {walls.mean() * 1e3:.3f}"
        f", min {q[0]:.3f}, median {q[1]:.3f}, p95 {q[2]:.3f}, "
        f"max {q[3]:.3f}; permanents a second by tenth of the window: "
        f"{tenths(calls, window_s)}")
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(
                       dev)) if on_card else 0)}
    line = {"correct": False, "attempted": len(calls), "failed": failed}
    breakdown = None
    if traced:
        from .devtrace import summarize
        dtrace = summarize(prof, on_card)
        prof = None
        ctx = Context(cell=cell, calls=calls, window_s=window_s, n=n,
                      batch=batch, trace=dtrace, on_card=on_card)
        metrics = {}
        for entry, mod in cell.per_layer:
            v = mod.read(ctx)
            if v is not None:
                metrics[entry["name"]] = {"value": v, "unit": entry["unit"]}
        if on_card:
            device_info["busy_s"] = dtrace.busy_s
            device_info["window_s"] = dtrace.window_s
            breakdown = {"device_ops": dtrace.device_ops[:10],
                         "idle_gaps": dtrace.idle_gaps[:10]}
    else:
        values = {"setup_s": setup_s,
                  "perms_per_s": perms / window_s,
                  "p95_ms": float(np.percentile(walls, 95)) * 1e3}
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    line["metrics"] = metrics
    line["device"] = device_info
    if breakdown is not None:
        line["breakdown"] = breakdown

    # the program's state goes before the reference runs
    del call
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    items = sample_items(seed, calls, int(tr["check_sample"]))
    got = check(kind, pool, answers, items, dev, log)
    log(f"reference: {len(items)} items, {got['checked']} answers, "
        f"{time.perf_counter() - r0:.3f} s")
    checks = {name: [got[name], limit] for name, limit in guarantee.items()}
    checks["failed_calls"] = [failed, 0]
    line["correct"] = got["checked"] >= 1 and all(
        v <= lim for v, lim in checks.values())
    line["checks"] = checks
    return line


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader is given."""
    cell: Cell
    calls: list
    window_s: float
    n: int
    batch: int
    trace: object            # devtrace.Trace
    on_card: bool

    def span_ms(self, name: str) -> Optional[float]:
        """The span's window total over the calls, in ms a call; None where
        no call recorded it."""
        tot = [c.spans[name] for c in self.calls if name in c.spans]
        if not tot:
            return None
        return sum(tot) / len(self.calls) * 1e3


def check_lines(checks: dict) -> list:
    """Each compared number beside its limit, one line each."""
    return [f"check {name} {v!r} limit {lim!r}"
            for name, (v, lim) in checks.items()]


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="python3 -m permbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the configuration's lower tier in the "
                    "program's place (the control of the check)")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    cache_env(CHECKOUT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"permbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    device="cuda:0", control=args.control, t0=t0)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"permbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for text in check_lines(line["checks"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
