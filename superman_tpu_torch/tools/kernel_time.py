"""Time one walk kernel alone on one CUDA card, or its plain version on
the CPU.

    python -m superman_tpu_torch.tools.kernel_time [--path k1] [--tier df64]
        [--n 32] [--device cuda|cpu]

--path names the walk and its inputs, all seeded:

* k1 (default): K1 (ryser_walk_*) on the whole default plan of an
  integer matrix of order n (entries 1-4, density 0.5, seed n: at n=32
  the matrix of chip_smoke.py), in tier df64, f32, f32k or tf96; also the
  amp walk with the amplitude alone (amp) or with the conditioned term
  (amp_cond), and the Z_p walk K3 at p = 2^31 - 1 (modp); --r walks
  chunks of 2^r steps instead of the plan's (a comma-separated list
  sweeps them);
* reduced: K1's reduced entry (ryser_walk_reduced) on the sparse plan of
  chip_smoke.py's n=36 matrix (density 0.15, seed 36): the planner's plan
  at the tier's rate, the engine's scales and packs, the live list split
  as parallel/sharding.py splits it.  With --r it walks a factored pack
  of k1's matrix instead, its last FACTORED rows factored and the others
  alive (N_PAD = pad_n(n - FACTORED)), in chunks of 2^r steps: that
  reaches the entry's N_PAD past 40, where the planner's sparse plans
  are too long to time;
* batch: K2 (ryser_batch) on chip_smoke.py's stack of BATCH integer
  matrices of n=24 (seeds 24, 25, ...), at gray.batch_plan's r.

--chunks C walks only the first C chunk ids (k1, and reduced with --r,
where the default is the split's sms * SPLIT_CHUNKS_PER_SM): with --r it
times an order whose whole plan is hours of walk, at its N_PAD.

--tier takes a comma-separated list; each tier prints one JSON line.  The
script times each of --reps launches after a warm-up, by CUDA events on
the card and by the host clock on the CPU (the plain version; keep n
small there, ~24), and prints the card's name and power limit (or the
host's processor and torch's thread count), the median and the least
time, the rate in G Gray steps/s, and a checksum of the outputs (their
exact sum).  On the card it then keeps the kernel busy for about a second
more and samples the SM clock and the power draw (nvidia-smi) while it
runs.  So two checkouts can be compared in one run on one card:

    PYTHONPATH=<other checkout> python superman_tpu_torch/tools/kernel_time.py

imports the package of the other checkout and builds its kernels there;
the calls used are the same since the reduced entry and the batch kernel
came.  A checkout whose ryser_amp has no `cond` argument has one amp
walk, the conditioned one: it is timed as amp_cond, and amp is refused.
chip_smoke.py takes its seeded matrices and its nvidia-smi query from
here.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import platform
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

WALK_TIERS = ("df64", "f32", "f32k", "tf96")
TIERS = {"k1": WALK_TIERS + ("amp", "amp_cond", "modp"),
         "reduced": WALK_TIERS, "batch": WALK_TIERS}
#: order of each path's matrix when --n is not given
DEFAULT_N = {"k1": 32, "reduced": 36, "batch": 24}
#: the prime of the modp tier, the largest the Z_p kernel takes
MODP_PRIME = (1 << 31) - 1
#: the reduced path's matrix: chip_smoke.py's sparse n=36 one
SPARSE_DENSITY = 0.15
#: matrices of the batch path
BATCH = 256
#: factored rows of the reduced path's dense factored walk (--r)
FACTORED = 4
#: seconds of launches during which the clock and power are sampled
SAMPLE_S = 1.0
#: peak rates of one H100 SXM.  Memory (3.35 TB/s) and float32 (67
#: TFLOP/s, a fused multiply-add counted as two) are NVIDIA's data-sheet
#: figures; float64 outside the tensor cores runs on 64 of an SM's 128
#: lanes, half the float32 rate; int32 has 64 lanes an SM too and one
#: operation an instruction, a quarter of it.  chip_smoke.py's bounds
#: and tools/modp_rate.py's share divide by these
PEAK = {"bytes": 3.35e12, "fp32": 67e12, "fp64": 33.5e12, "int32": 16.75e12}


def smi(query: str = "name,power.limit") -> str:
    """nvidia-smi's answer to --query-gpu=query for the first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def random_int_matrix(rng, n: int, density: float, vmax: int = 4):
    """Entries 1..vmax at `density`, as tests/conftest.py makes its
    integer matrices."""
    a = (rng.random((n, n)) < density).astype(np.int64)
    return a * rng.integers(1, vmax + 1, (n, n))


def sparse_int_matrix(seed: int, n: int, density: float) -> np.ndarray:
    """The sparse engine's seeded matrices: entries 1..4 at `density`, a
    full diagonal of 1..3."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density) * rng.integers(1, 5, (n, n))
    np.fill_diagonal(a, rng.integers(1, 4, n))
    return a


def int_matrix(n: int, seed: int) -> np.ndarray:
    return random_int_matrix(np.random.default_rng(seed), n, 0.5)


def scaled(a: np.ndarray) -> np.ndarray:
    """a with the engine's power-of-two row scales applied."""
    from superman_tpu_torch.ops.ryser import _center_scales, _row_scales
    return np.ldexp(a.astype(np.float64),
                    -_center_scales(a, _row_scales(a))[:, None])


def k1_launch(tier, n, dev, sms, r=None, chunks=None):
    """(launch, Gray steps a launch walks, what walks) of --path k1, at
    the default plan or at chunks of 2^r steps, all or the first
    `chunks`."""
    from superman_tpu_torch.ops import gray, modp, modp_cuda, ryser_cuda
    a = int_matrix(n, n)
    plan = gray.make_plan(n, sms=sms, chunk_log2=r)
    count = min(plan.num_chunks, chunks or plan.num_chunks)
    ids = torch.arange(count, device=dev)
    steps = count << plan.r
    what = {"n": n, "n_pad": plan.n_pad, "r": plan.r, "chunks": count}
    if tier == "modp":
        x0, cols = (t.to(dev) for t in modp.pack_mod(
            modp.reduce_core_mod(a.tolist(), MODP_PRIME), MODP_PRIME,
            plan.n_pad))
        return (lambda: modp_cuda.mod_partials(ids, x0, cols, MODP_PRIME,
                                               n=n, r=plan.r), steps, what)
    x0, cols = (torch.as_tensor(v, device=dev)
                for v in gray.pack_matrix(scaled(a), plan.n_pad))
    if tier in ("amp", "amp_cond"):
        kw = {"cond": tier == "amp_cond"}
        if "cond" not in inspect.signature(ryser_cuda.ryser_amp).parameters:
            if tier == "amp":
                raise SystemExit("kernel_time: this checkout has no "
                                 "amplitude-only walk")
            kw = {}
        return (lambda: ryser_cuda.ryser_amp(ids, x0, cols, n=n, r=plan.r,
                                             **kw), steps, what)
    return (lambda: ryser_cuda.ryser_partials(ids, x0, cols, n=n, r=plan.r,
                                              tier=tier), steps, what)


def factored_launch(tier, n, dev, sms, r, chunks=None):
    """(launch, Gray steps a launch walks, what walks) of --path reduced
    with --r: k1's matrix of order n, scaled, its last FACTORED rows
    factored, chunk ids 0 .. chunks-1 of 2^r steps."""
    from superman_tpu_torch.ops import gray, ryser_cuda
    a = scaled(int_matrix(n, n))
    alive = n - FACTORED
    pack = [torch.as_tensor(v).to(dev).contiguous() for v in
            gray.pack_matrix(a[:alive], gray.pad_n(alive))
            + gray.pack_matrix(a[alive:], FACTORED)]
    count = min(1 << (n - 1 - r),
                chunks or sms * gray.SPLIT_CHUNKS_PER_SM)
    ids = torch.arange(count, device=dev)
    what = {"n": n, "n_pad": int(pack[0].shape[0]),
            "factored_rows": FACTORED, "r": r, "chunks": count}
    return (lambda: ryser_cuda.ryser_reduced(ids, *pack, n=n, r=r,
                                             tier=tier), count << r, what)


def reduced_launch(tier, n, dev, sms):
    """(launch, live Gray steps a launch walks, what walks) of --path
    reduced: the sparse path's plan, packs and split (ops/ryser.py,
    parallel/sharding.py _reduced_words)."""
    from superman_tpu_torch.ops import gray, pruning, ryser, ryser_cuda
    a = sparse_int_matrix(n, n, SPARSE_DENSITY)
    sp = pruning.plan_sparse(a, giters=ryser.K1_GITERS[tier])
    if sp is None:
        raise SystemExit(f"kernel_time: the planner declined n={n}")
    ap_s = scaled(np.ascontiguousarray(a[:, sp.col_perm]))
    alive, factor = sp.alive_rows, sp.factor_rows
    pack = [torch.as_tensor(v).to(dev).contiguous() for v in
            gray.pack_matrix(ap_s[alive], gray.pad_n(len(alive)))
            + gray.pack_matrix(ap_s[factor], len(factor))]
    ids, r = gray.split_chunks(torch.as_tensor(sp.ids).to(dev), sp.r,
                               sms * gray.SPLIT_CHUNKS_PER_SM)
    what = {"n": n, "n_pad": int(pack[0].shape[0]), "plan_r": int(sp.r),
            "live_chunks": len(sp.ids), "factored_rows": len(factor),
            "r": r, "chunks": int(ids.numel())}
    return (lambda: ryser_cuda.ryser_reduced(ids, *pack, n=n, r=r,
                                             tier=tier),
            int(ids.numel()) << r, what)


def batch_launch(tier, n, count, dev, sms):
    """(launch, Gray steps a launch walks, what walks) of --path batch."""
    from superman_tpu_torch.ops import batch, gray, ryser_cuda
    stack = np.stack([int_matrix(n, n + i) for i in range(count)])
    r = gray.batch_plan(n, count, sms=sms)
    x0p, colsT, _, _ = batch.pack_stack(stack.astype(np.float64))
    x0s, colss = torch.as_tensor(x0p).to(dev), torch.as_tensor(colsT).to(dev)
    what = {"n": n, "n_pad": int(x0s.shape[1]), "matrices": count, "r": r,
            "chunks": count << (n - 1 - r)}
    return (lambda: ryser_cuda.batch_partials(x0s, colss, n=n, r=r,
                                              tier=tier),
            count << (n - 1), what)


def time_launches(launch, reps: int, on_card: bool):
    """(ms of each of `reps` calls of launch(), the last output): by CUDA
    events on the card, by the host clock on the CPU."""
    times, out = [], None
    for _ in range(reps):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = launch()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            out = launch()
            times.append((time.perf_counter() - t) * 1e3)
    return times, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", default="k1", choices=tuple(TIERS))
    ap.add_argument("--tier", default="df64",
                    help="a tier, or a comma-separated list of them")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--r", default=None,
                    help="k1, reduced: log2 chunk length(s), "
                         "comma-separated")
    ap.add_argument("--chunks", type=int, default=None,
                    help="k1, reduced with --r: walk the first CHUNKS ids")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    tiers = args.tier.split(",")
    rs = [None] if args.r is None else [int(v) for v in args.r.split(",")]
    if args.r is not None and args.path == "batch":
        ap.error("--r goes with --path k1 or reduced")
    if args.chunks is not None and args.path != "k1" and args.r is None:
        ap.error("--chunks goes with --path k1, or reduced with --r")
    for tier in tiers:
        if tier not in TIERS[args.path]:
            ap.error(f"--path {args.path} takes the tiers "
                     f"{', '.join(TIERS[args.path])}, not {tier!r}")
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("kernel_time: CUDA is not available", file=sys.stderr)
        return 2
    import superman_tpu_torch
    from superman_tpu_torch.ops import gray

    n = args.n or DEFAULT_N[args.path]
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if on_card else gray.DEFAULT_SMS)
    if on_card:
        where = smi()
    else:
        where = (f"host {platform.processor() or platform.machine()}, "
                 f"{torch.get_num_threads()} torch threads")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for tier, r in ((t, r) for t in tiers for r in rs):
        if args.path == "k1":
            launch, steps, what = k1_launch(tier, n, dev, sms, r,
                                            args.chunks)
        elif args.path == "reduced" and r is not None:
            launch, steps, what = factored_launch(tier, n, dev, sms, r,
                                                  args.chunks)
        elif args.path == "reduced":
            launch, steps, what = reduced_launch(tier, n, dev, sms)
        else:
            launch, steps, what = batch_launch(tier, n, BATCH, dev, sms)
        launch()                                          # build, warm-up
        sync()
        times, out = time_launches(launch, args.reps, on_card)
        med = statistics.median(times)
        sample = {}
        if on_card:
            # queue about SAMPLE_S of launches, sample while they run
            for _ in range(max(1, math.ceil(SAMPLE_S * 1e3 / med))):
                launch()
            clock, power = (v.strip() for v in smi(
                "clocks.sm,power.draw").split(","))
            sync()
            sample = {"clocks_sm": clock, "power_draw": power}
        print(json.dumps({
            "package": superman_tpu_torch.__path__[0], "card": where,
            "device": args.device, "path": args.path, "tier": tier, **what,
            "reps": args.reps, "median_ms": med, "min_ms": min(times),
            "g_steps_per_s": steps / med / 1e6, **sample,
            "checksum": math.fsum(out.double().cpu().numpy().ravel()
                                  .tolist())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
