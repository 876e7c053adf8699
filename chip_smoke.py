"""Smoke test of superman_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --mesh     # the build and the mesh phase alone

Builds the port's CUDA kernels from this checkout, holds each against
its plain PyTorch version on the card at its path's shapes, and drives
the paths through the package's entry points: superman_tpu_torch.permanent
at n=32 with calc="df64", "f32", "f32k" and "tf96" (the Ryser walk,
csrc/ryser_walk.cu; the df64, f32 and f32k totals through its
block-reduced entry ryser_walk_blocks), with perman_algo="glynn" (the
same kernel under the Glynn packing) and with calc="exact" (the Z_p walk, csrc/modp_walk.cu,
under the modular CRT engine), and superman_tpu_torch.permanent_batch
(the serving batch, csrc/ryser_batch.cu) on 256 matrices of n=24, 16 of
n=32 and a mixed list; the sparse engine (the pruned, factored walk,
ryser_walk_reduced) through permanent() on seeded sparse matrices of n=36
and n=40; calc="tf96" on a matrix whose chunk partials stand 1e7 above
its permanent; and calc="auto" (the ladder, with the amp walk, the C
entry ryser_walk at tiers 4 and 5: the amplitude alone on integer matrices, with the
conditioned term beside it on real-valued ones) at n=32 and on a
real-valued n=24 matrix built to defeat the float tiers.  Then the
transform drivers and the estimators: compression=True on the sparse
n=36 and n=40 matrices (folded cores walked by the Ryser walk, dense or
pruned, and the value certified by the Z_p walk), scaling_threshold=1.0
at n=32 (both walks), dm_prune=True on a block-triangular n=36 matrix,
rectangular=True on a 24 x 32 matrix, the Rasmussen, scaling and Gurvits
estimators at the Flags default of 100000 trials, Gurvits again where its
stderr is informative (a diagonally dominant signed n=24 matrix under
Rademacher draws, the same form at n=6 under Gaussian draws) and its
trial against float64 on the same draws, and grid_permanent's
SMC estimate of the 36 x 36 grid (n=648) against the Kasteleyn closed
form, with the scale-interval selector on the 16 x 16 grid (both through
tools/smc_flagship.py).  Then the host layer (host_layer_phases): the
native CPU engine, built from this
checkout, at n=32 (its double walk, its exact CRT pipeline) and its Z_p
walk against K3; ryser_exact and glynn_exact over a mesh of 4 streams of
the card, bitwise against one device in every tier and on the sparse
n=36 matrix; the hybrid scheduler (card and native engine) with a
journal and a resumed run; two processes joined over gloo on the card;
Rasmussen over 2 streams, twice, and with the native trial worker.  Last
the tools (tools_phase), each through its function on the seeded corpus
of tools/corpus.py: the fuzzer's 40 trials at seed 0, the accuracy sweep
at n=30, suite_check at n=30 and 32, sparse_report at n=32, modp_rate at
n=32, scaling_measure at n=30 and 32, exact_known (a row declined by the
budget and certified by a merge, the native reverify, K3 under Glynn)
and real_suite --quick.  Then the NaN switch (nan_switch_phase):
with SUPERMAN_DEBUG_NANS set, the n=32 df64 permanent and the 256 x n=24
batch give their bits and launches, walls beside those without it; a NaN
x0 through every kernel entry at its path's shapes, the float64 walk and
each estimator's trial raises FloatingPointError naming it; a NaN entry
is a ValueError before any launch.  Then the bench (bench_phase):
tools/bench.py's measuring function once (the seeded n=32 matrices of
tools/corpus.py in df64, f32, f32k and tf96, and the d=0.20 one dense
beside sparse=True, each error within its limit), then
tools/capture_bench.py once in a subprocess, whose record must hold rc 0
and a parsed line within the same limits.  Last the range of every
route (walk_range_phase): seeded matrices whose permanents overflow,
underflow or lie far from 1 through the default entry points on the card
(the float64 and float32 lane walks below n=19 and under calc="f64", the
batch walk below n=13, Glynn's float64 route), then through the routes
on the host by design (the long-double walks of calc="tf96" below n=19,
dense and sparse, calc="auto", Glynn's tf96 and quad, calc="quad" with
the native engine hidden and through it, cpu=True dense, sparse and
SkipPer, read_calculate_return), orders 1 and 2, the scaling estimator
on the card and the native double walk on every lane-walk matrix, each
held to calc="exact" (no NaN, no -0.0), with the walls of the lane and
host routes (tools/lane_walls.py) and the host time of the row scales
alone.  Last SUPerman's multi-GPU deployment (mesh_cards_phase): its
walk's instantiation <40, 0, 1> bitwise its plain version and timed on
one card's share, then an n=38 df64 permanent through
permanent(perman_algo="multi") over every visible card, or over 4
streams of the one card, bitwise against one device, with each entry's
block rows and walk ms, their spread, the deal's spans and block
launches, the caller's current device unchanged.  It checks their values,
times kernels and plain versions, and prints:

  * the card's `name, power.limit` (nvidia-smi);
  * one JSON line {"kernels": [...]} with each kernel's launches on one
    path, read from the one counter (csrc/build.py LAUNCHES, keyed by
    entry and tier: K1's launches are its "walk" and "blocks" entries);
    the counts are set to 0 before every path and read after it;
    `driver_launches` holds them on the driver paths, `mesh_launches`,
    `mesh_glynn_launches`, `hybrid_launches` and `multihost_launches`
    on the host layer's, `tools_launches` over the tools' phase,
    `bench_launches` over the bench's measuring run, `range_launches`
    over the range phase),
    its largest difference from the plain version, both times, and its
    bound: the least time the card could take for the same work, the
    larger of bytes moved over the memory rate and operations over the
    peak rate of their type (kernel_time.PEAK); with the walks' registers at
    their path's N_PAD (cuobjdump -res-usage of the library) and every
    timed kernel's SM clock, sampled (nvidia-smi clocks.sm) while more of
    its launches run;
  * last, {"ok": true, "device": {...}}.

Any failure raises, so the exit code is not 0 and no last line is
printed.  Without CUDA it exits with code 2 before doing anything.
"""

from __future__ import annotations

import json
import math
import sys
import time
from fractions import Fraction

import numpy as np

from superman_tpu_torch.csrc.build import LAUNCHES, launches
from superman_tpu_torch.tools import modp_rate, smc_flagship
from superman_tpu_torch.tools.kernel_time import (PEAK, random_int_matrix,
                                                smi, sparse_int_matrix)

SEED = 32
#: per(A) of random_int_matrix(np.random.default_rng(32), 32, 0.5), the
#: n=32 main-path matrix, from the JAX package's native C++ double engine
#: (OpenMP, long-double accumulation):
#:   superman_tpu.bindings.native.load().sup_perman_dense(a, 32, 6, 0)
PINNED_N32 = 1.0672717524023244e+38
#: the same permanent exactly, from the JAX package's modular CRT engine:
#:   superman_tpu.ops.exact.perman_exact_fraction(a, engine="native")
#: (the native double value above is 5.5e-13 from it)
EXACT_N32 = 106727175240173945355163340903491553305
#: kernel vs plain version, per chunk: both take the same IEEE steps, so
#: they should agree bitwise; 2^-45 of the largest partial leaves room for
#: a reordering by the compiler and nothing more
KERNEL_TOL = 2.0 ** -45
MAIN_TOL = 1e-9          # n=32 df64 vs the pinned value
SMALL_TOL = 1e-10        # n=20, 24 vs the long-double oracle
#: limits of the f32 tiers against the df64 value (the reference holds
#: its f32k batch to 1e-3 and describes f32 as 1e-3..1e-2)
F32K_TOL = 1e-3
F32_TOL = 5e-2
BATCH_VS_SINGLE_TOL = 1e-12   # batched df64 vs permanent() one by one
#: tf96 against exact integers: what is left is the rounding of the final
#: double (2^-53 = 1.1e-16, twice that where the long-double total rounds
#: first) and the long-double host sum
TF96_TOL = 1e-15
#: per(J_n) = n!, the df64 tier's worst case, under tf96.  The products
#: and chunk sums are good to ~2^-100, so the limit is the host's: the
#: long-double sum of the partials errs by at most 2^-64 of their
#: magnitudes, which stand ~5e3 (n=24) and ~1e5 (n=32) above n!
ONES_TOL = {24: 1e-13, 32: 1e-14}
TIERS = ("df64", "f32", "f32k", "tf96")
#: the tiers of K1's block-reduced entry (ryser_cuda.ryser_blocks)
BLOCK_TIERS = ("df64", "f32", "f32k")
#: the sparse engine against exact integers: df64's accumulation over the
#: live steps, and tf96's last rounding with some room (its weights are
#: double-doubles, so nothing is lost before the final double)
SPARSE_TOL = {"df64": 1e-9, "f32": F32_TOL, "f32k": F32K_TOL, "tf96": 1e-13}
#: operations of the amp walk's TwoSum accumulator: 6 adds and the add
#: that gathers the compensation
AMP_ACC_OPS = 7
#: `bound_ms` divides by the card's peak rates (kernel_time.PEAK).  No
#: multiply or add of a Ryser walk can fuse (x += +-col is an add, the
#: product tree is multiplies, the accumulators are adds), so its
#: operations issue at best at half the floating-point peaks:
#: `issue_bound_ms` of the walk kernels divides by FMA_SLOTS of them
FMA_SLOTS = 0.5
#: operations of the tier's accumulator per term, counted whole as the
#: tier defines it (TwoSum is 6).  One add is what no accumulator could
#: avoid: counted so, the df64 bound at n=32 would be 64/73 of this one.
#: tf96 adds double-doubles: TwoSum 6, two adds, FastTwoSum 3
ACC_OPS = {"df64": 10, "f32": 1, "f32k": 7, "tf96": 11}
#: operations of the tf96 product, an FMA counted as two: TwoProd is a
#: multiply and an FMA; a double-double multiply of the tree is a
#: TwoProd, two multiplies and two adds for the cross terms (the tree
#: renormalises once, at its root: FAST_TWO_SUM_OPS)
TWO_PROD_OPS = 3
DD_MUL_OPS = TWO_PROD_OPS + 4
FAST_TWO_SUM_OPS = 3
#: the tf96 case whose chunk partials cancel: pairs of equal columns
#: among the chunk-level ones, +-CANCEL_C added to one row at each pair
CANCEL_PAIRS = 3
CANCEL_C = 1 << 12
#: the Z_p kernel is checked at the largest prime the TPU kernel took and
#: at the largest the card's takes; residues must agree exactly
MOD_PRIMES = (2039, (1 << 31) - 1)
#: a 31-bit prime outside the CRT pool of the n=32 run (which descends
#: from 2^31 - 1), for the Glynn vs Nijenhuis-Wilf cross-check
GLYNN_PRIME = 1073741789
#: the transform drivers against exact values: df64 on the folded,
#: scaled, pruned or padded matrix
DRIVER_TOL = 1e-9
#: a compression pipeline's own value, where the sanity net replaced it
#: with the exact one: the JAX package's certification band
#: (superman_tpu/drivers/runner.py:133).  d34 cores far above their
#: permanents lose more than DRIVER_TOL in df64, but a wrong core walk or
#: a wrong sum of the cores is off by far more than this
PIPELINE_TOL = 1e-6
#: an estimate against the exact value, in its own reported stderr
EST_SIGMAS = 4.0
#: the Gurvits cases built to be informative must also reach a
#: stderr/exact below this, so that EST_SIGMAS stderr is a real limit
GURVITS_INFO = 0.1
#: the native engine's double walk at n=32 against the exact integer: its
#: OpenMP threads add their partial sums in long double in another order
#: than the JAX package's pinned run (PINNED_N32, 5.5e-13 from it)
NATIVE_TOL = 1e-11
#: the hybrid scheduler's value (card units beside native-engine units)
#: against the exact integer, and a resumed run against the first
HYBRID_TOL = 1e-9
RESUME_TOL = 1e-12
#: several processes against one: the blocks are regrouped
MULTIHOST_TOL = 1e-12
#: the mesh of streams of one card that the multi-device code runs on
MESH_ENTRIES = 4
#: phase 6, the tools: the fuzzer's trials at seed 0 (every one must
#: pass); suite_check's and sparse_report's limit against the native
#: double engine; exact_known's two budgets, the first under the card's
#: price of the seeded corpus's B2 file (its core of 36, ~3.7 s) so that
#: it declines, the second over it so that --merge certifies it (the C
#: file, n=60 dense, declines at both); the native engine's price above
#: which --reverify skips a row
FUZZ_TRIALS = 40
SUITE_TOL = 1e-8
KNOWN_BUDGETS = (1.0, 600.0)
REVERIFY_BUDGET_S = 60.0
#: phase 8: how long tools/capture_bench.py gives its run of the bench,
#: whose kernels are built by then (the phase's own run takes seconds)
CAPTURE_TIMEOUT_S = 300
#: phase 9, the lane walks' range: (label, (n, seed, scale), overrides) on
#: np.random.default_rng(seed).integers(1, 5, (n, n)) * scale through the
#: port's default entry points, each held to calc="exact": f32 within
#: F32_TOL, every other tier within RANGE_TOL, inf where the exact value
#: is beyond a double, +0.0 where it is below one
RANGE_CASES = (("n18x30 f32", (18, 18, 30.0), dict(calc="f32")),
               ("n18x1e-5 f32", (18, 18, 1e-5), dict(calc="f32")),
               ("n18x1e-5 df64", (18, 18, 1e-5), {}),
               ("n18x1e-5 glynn", (18, 18, 1e-5), dict(perman_algo="glynn")),
               ("n12x1e25 df64", (12, 12, 1e25), {}),
               ("n12x1e25 glynn", (12, 12, 1e25), dict(perman_algo="glynn")),
               ("n12x1e-30 df64", (12, 12, 1e-30), {}),
               ("n22x1e14 f64", (22, 22, 1e14), dict(calc="f64")),
               ("n22x1e14 df64", (22, 22, 1e14), {}),
               ("n18x1e297 f32", (18, 18, 1e297), dict(calc="f32")),
               ("n24x2^1020 f64", (24, 24, 2.0 ** 1020), dict(calc="f64")),
               ("n12s11x1e-27 auto", (12, 11, 1e-27), dict(calc="auto")))
RANGE_BATCH = ((12, 12, 1e25), (14, 14, 1e25))
RANGE_TOL = 1e-10
#: the walls of the lane routes (tools/lane_walls.py) and the scales'
#: host time: median of RANGE_REPS calls
RANGE_REPS = 21
#: phase 9's host routes and estimators (the long-double host walks, the
#: native engine, orders 1-2, the scaling estimator): the seed-18 n=18
#: matrix of RANGE_CASES at these (label, scale, signed) — a random sign
#: on each entry from default_rng(19) — each route held to calc="exact",
#: within LONG_TOL on the long-double and __float128 walks, RANGE_TOL on
#: the double ones, 4 stderr for an estimate; "rows2^+-600" moves
#: alternate rows by 2^600 and 2^-600 (Glynn: columns), a permanent a
#: double holds whose unscaled products overflow
HOST_SCALES = (("1e300s", 1e300, True), ("1e25", 1e25, False),
               ("1e-30", 1e-30, False), ("1e-300", 1e-300, False),
               ("rows2^+-600", None, False))
LONG_TOL = 1e-14
#: the host routes' walls (lane_walls --host): median of this many calls
RANGE_HOST_REPS = 3

#: the grid flagship, the reference's default grid (-i -m 36 -n 36): the
#: SMC log2 estimate against the Kasteleyn count within
#: smc_flagship.Z_LIMIT = 3 of sigma_log2 = stderr_rel / ln 2
FLAGSHIP = dict(approximation=True, perman_algo="scaling", smc=1,
                number_of_times=32768, seed=11)


def k1_count() -> int:
    """K1's launches: its per-chunk and its block-reduced entry's."""
    return launches("walk", "blocks")


def tier_counts(*entries: str, tiers=TIERS) -> dict:
    """The launches of `entries`, tier by tier (csrc/build.py LAUNCHES)."""
    return {t: launches(*entries, tier=t) for t in tiers}


def within_line_landmine(lrng, n):
    """As tests/test_exact_dense.py makes it: a real-valued dyadic matrix
    (so the exact engine takes it) whose rows, large +-c pairs with
    near-zero sums, cross zero mid-walk: the walk's per-term error then
    exceeds what the plain amplitude predicts."""
    q = 1.0 / 256.0
    a = np.round(lrng.uniform(-2, 2, (n, n)) / q) * q
    a[np.abs(a) < 4 * q] = 4 * q
    for i in range(0, n, 3):
        c = float(1 << int(lrng.integers(8, 14)))
        j = int(lrng.integers(0, n - 2))
        a[i, :] = np.round(lrng.uniform(-1, 1, n) / q) * q
        a[i, j], a[i, j + 1] = c, -c + q * float(lrng.integers(1, 5))
    return a


def cancelling_matrix(seed, n, r, pairs=CANCEL_PAIRS, c=CANCEL_C):
    """(a, base): an integer matrix whose Ryser chunk partials stand far
    above its permanent, and the matrix with the same permanent it is
    built from.  base is random_int_matrix with columns j + 1 = j for the
    pairs j = n-3, n-5, ... (all >= r, so they toggle between chunks, not
    inside one); a adds c at (k, j) and -c at (k, j + 1) of row k of pair
    k.  Expanding per(a) along row k, the two c terms multiply minors
    with equal columns and cancel, so per(a) = per(base), while every
    chunk whose Gray bits differ at j and j + 1 walks a factor ~c."""
    base = random_int_matrix(np.random.default_rng(seed), n, 0.5)
    cols = [n - 3 - 2 * k for k in range(pairs)]
    if min(cols) < r:
        raise ValueError(f"the pairs reach column {min(cols)} < r={r}")
    for j in cols:
        base[:, j + 1] = base[:, j]
    a = base.copy()
    for k, j in enumerate(cols):
        a[k, j] += c
        a[k, j + 1] -= c
    return a, base


def amp_host_log2(a):
    """(log2 amp, log2 cond) of the whole walk by the exhaustive host
    formula in float64 (ops/ryser.amp_cond_walk_log2 below n=19, run here
    at any n): sum_m prod_i |x_i| and sum_m sum_i S_i prod_{j != i}
    max(|x_j|, S_j 2^-50), S_i the row's amplitude bound."""
    a = np.asarray(a, np.float64)
    n = a.shape[0]
    x0 = a[:, -1] - a.sum(axis=1) / 2.0
    cols = a[:, : n - 1]
    S = np.abs(x0) + np.abs(cols).sum(axis=1)
    m = np.arange(1 << (n - 1), dtype=np.uint64)
    g = m ^ (m >> np.uint64(1))
    bits = ((g[:, None] >> np.arange(n - 1, dtype=np.uint64))
            & np.uint64(1)).astype(np.float64)
    ax = np.abs(x0[None, :] + bits @ cols.T)
    axc = np.maximum(ax, S[None, :] * 2.0 ** -50)
    logc = np.log2(axc).sum(axis=1) + np.log2((S[None, :] / axc).sum(axis=1))
    mx = float(logc.max())
    return (math.log2(np.prod(ax, axis=1).sum()),
            mx + float(np.log2(np.exp2(logc - mx).sum())))


def sm_clock(fn, seconds: float = 0.5) -> int:
    """The SM clock in MHz (nvidia-smi clocks.sm) sampled while launches
    of fn queued for about `seconds` run."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    for _ in range(max(1, math.ceil(seconds * 1e3 / start.elapsed_time(end)))):
        fn()
    clock = smi("clocks.sm")                              # "1980 MHz"
    torch.cuda.synchronize()
    return int(clock.split()[0])


def cuda_ms(fn, reps: int):
    """(mean milliseconds per call by CUDA events, the last call's result)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def walk_bound(steps: int, n: int, tier: str, nbytes: int):
    """(bound_ms, bound_by, issue_bound_ms) of a Ryser walk of `steps`
    Gray steps of an order-n matrix: a step does n-1 multiplies, n adds
    and the tier's accumulator; nbytes is every input read and output
    written once.  In tf96 the first n // 2 multiplies are TwoProds, the
    others un-normalised double-double multiplies, and the product is
    normalised once.  issue_bound_ms is the same work at the rate its
    instructions issue: an unfusable multiply or add takes the slot of an
    FMA, so all of them at half the peak, the one FMA of each tf96
    multiply counted once."""
    if tier == "tf96":
        per_step = (n + TWO_PROD_OPS * (n // 2)
                    + DD_MUL_OPS * (n - 1 - n // 2) + FAST_TWO_SUM_OPS
                    + ACC_OPS[tier])
        instr = per_step - (n - 1)
    else:
        per_step = instr = 2 * n - 1 + ACC_OPS[tier]
    kind = "fp64" if tier in ("df64", "tf96") else "fp32"
    ms, by = bound(nbytes, steps * per_step, kind)
    return ms, by, max(ms, steps * instr / (PEAK[kind] * FMA_SLOTS) * 1e3)


def amp_bound(steps: int, n: int, nbytes: int, cond: bool):
    """(bound_ms, bound_by, issue_bound_ms) of an amp walk of `steps` Gray
    steps of an order-n matrix, all in float64: n adds to x, n-1
    multiplies and AMP_ACC_OPS a step for the amplitude; with cond, n
    clamps, the (P, C) fold (n // 2 pairs of leaves at a multiply and an
    add, ceil(n/2) - 1 combines at 3 multiplies and an add) and a second
    accumulator besides; nothing of it can fuse."""
    per_step = n + (n - 1) + AMP_ACC_OPS
    if cond:
        per_step += (n + 2 * (n // 2) + 4 * ((n + 1) // 2 - 1)
                     + AMP_ACC_OPS)
    ms, by = bound(nbytes, steps * per_step, "fp64")
    return ms, by, max(ms, steps * per_step / (PEAK["fp64"] * FMA_SLOTS) * 1e3)


def bound(nbytes: int, ops: int, kind: str):
    by_bytes = nbytes / PEAK["bytes"] * 1e3
    by_ops = ops / PEAK[kind] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes > by_ops else "operations"


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def register_report(report: str) -> str:
    """ptxas -v output as one line per kernel instantiation: name,
    template arguments, registers, spills."""
    import re
    lines = []
    name = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)I((?:Li\d+E)+)", m.group(1))
            name = (f"{k.group(1)}<{','.join(re.findall(r'Li(\d+)E', k.group(2)))}>"
                    if k else m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers")
            name = None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and (m.group(1) != "0" or m.group(2) != "0"):
            lines.append(f"  {name}: SPILLS {line.strip()}")
    return "\n".join(lines)


def compare(kern, plain, ids) -> float:
    """Largest |kernel - plain| of the partials hi + lo (per chunk, or per
    block of the batch kernel, where ids is None); raises past KERNEL_TOL
    of the largest partial or on a nonzero sentinel."""
    import torch
    if kern.shape != plain.shape or kern.dtype != plain.dtype:
        raise AssertionError(f"kernel {tuple(kern.shape)} {kern.dtype} vs "
                             f"plain {tuple(plain.shape)} {plain.dtype}")
    pk = kern[..., 0].double() + kern[..., 1].double()
    pp = plain[..., 0].double() + plain[..., 1].double()
    if not (torch.isfinite(pk).all() and torch.isfinite(pp).all()):
        raise AssertionError("non-finite partials")
    if ids is not None and bool((kern[ids < 0] != 0).any()):
        raise AssertionError("a sentinel chunk wrote a nonzero partial")
    err = float((pk - pp).abs().max())
    scale = float(pp.abs().max())
    if err > KERNEL_TOL * scale:
        raise AssertionError(f"kernel vs plain: max abs err {err:.3e} > "
                             f"{KERNEL_TOL:.1e} * {scale:.3e}")
    print(f"  max abs err {err:.3e} (tol {KERNEL_TOL * scale:.3e}), "
          f"bitwise equal: {bool(torch.equal(kern, plain))}")
    return err


def compare_amp(kern, plain, ids) -> float:
    """Largest |kernel - plain| of the amp walk's sums per chunk (amp
    hi + lo, and cond hi + lo where there are four words); raises past
    KERNEL_TOL of the largest sum or on a nonzero sentinel."""
    import torch
    if kern.shape != plain.shape or kern.dtype != plain.dtype:
        raise AssertionError(f"kernel {tuple(kern.shape)} {kern.dtype} vs "
                             f"plain {tuple(plain.shape)} {plain.dtype}")
    if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
        raise AssertionError("non-finite amp sums")
    if bool((kern[ids < 0] != 0).any()):
        raise AssertionError("a sentinel chunk wrote a nonzero amp sum")
    worst = 0.0
    for name, c in (("amp", 0), ("cond", 2))[:kern.shape[1] // 2]:
        pk, pp = kern[:, c] + kern[:, c + 1], plain[:, c] + plain[:, c + 1]
        err, scale = float((pk - pp).abs().max()), float(pp.abs().max())
        if err > KERNEL_TOL * scale:
            raise AssertionError(f"amp kernel vs plain, {name}: max abs err "
                                 f"{err:.3e} > {KERNEL_TOL:.1e} * {scale:.3e}")
        worst = max(worst, err)
    print(f"  max abs err {worst:.3e}, bitwise equal: "
          f"{bool(torch.equal(kern, plain))}")
    return worst


def compare_mod(kern, plain, ids, p) -> int:
    """Largest |kernel - plain| residue difference; raises unless the two
    are equal on every chunk, canonical, and 0 on the sentinels."""
    import torch
    if not bool(((kern >= 0) & (kern < p)).all()):
        raise AssertionError(f"p={p}: a residue outside [0, p)")
    if bool((kern[ids < 0] != 0).any()):
        raise AssertionError(f"p={p}: a sentinel chunk wrote a nonzero sum")
    err = int((kern - plain).abs().max())
    print(f"  p={p}: {ids.numel()} chunks, max residue difference {err}")
    if not torch.equal(kern, plain):
        raise AssertionError(f"p={p}: kernel and plain residues differ")
    return err


def batch_stacks():
    """The serving shapes: 256 seeded integer matrices of n=24, and 16 of
    n=32 (the batch's full width) whose first is the n=32 main-path
    matrix."""
    stack_a = np.stack([random_int_matrix(np.random.default_rng(24 + i), 24,
                                          0.5) for i in range(256)])
    stack_b = np.stack([random_int_matrix(np.random.default_rng(SEED + i), 32,
                                          0.5) for i in range(16)])
    return stack_a, stack_b


def mixed_list():
    """Orders 8..32, two integer matrices each, one real-valued matrix
    and one with an empty row: (kind, matrix) pairs."""
    out = []
    for n in (8, 12, 13, 16, 20, 24, 28, 32):
        for j in range(2):
            out.append(("int", random_int_matrix(
                np.random.default_rng(1000 + 10 * n + j), n, 0.5)))
    rng = np.random.default_rng(7)
    out.insert(5, ("real", (rng.random((16, 16)) < 0.6)
                   * rng.random((16, 16)) * 5.0))
    empty = random_int_matrix(np.random.default_rng(8), 20, 0.5)
    empty[3] = 0
    out.insert(11, ("empty", empty))
    return out


def block_triangular(seed, n):
    """(a, b1, b2): [[b1, x], [0, b2]] of order n, b1 and b2 seeded integer
    blocks of order n/2 at density 0.5 with a full diagonal, x filled with
    1..4.  No perfect matching uses x (b2's rows reach b2's columns only),
    so Dulmage-Mendelsohn zeroes it, and per(a) = per(b1) per(b2)."""
    rng = np.random.default_rng(seed)
    h = n // 2
    b1, b2 = (random_int_matrix(rng, h, 0.5) for _ in range(2))
    for b in (b1, b2):
        np.fill_diagonal(b, rng.integers(1, 5, h))
    a = np.zeros((n, n), dtype=np.int64)
    a[:h, :h], a[h:, h:] = b1, b2
    a[:h, h:] = rng.integers(1, 5, (h, h))
    return a, b1, b2


def diag_dominant(seed, n):
    """A signed integer matrix of order n with diagonal +-(8..15) and
    off-diagonal entries in {-1, 0, +1} at density 0.3: (Ax)_i x_i stays
    near a_ii for Rademacher x, so the Gurvits estimate has a small
    variance there (and at small n under Gaussian x)."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.3) * rng.choice([-1, 1], (n, n))
    np.fill_diagonal(a, rng.integers(8, 16, n) * rng.choice([-1, 1], n))
    return a.astype(np.int64)


def device_busy(fn):
    """(fn's result, host seconds, device-busy seconds or None, kernel
    count) over one call of fn that ends in a synchronise: the union of
    the CUDA activity intervals torch.profiler records in that window.
    None where the profiler recorded no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return out, wall, (busy / 1e6 if spans else None), len(spans)


def rel_err(got: float, want) -> float:
    """|got - want| / |want| in exact arithmetic: `want` may be an integer
    beyond 2^53, which a float subtraction would round first."""
    want = Fraction(want)
    return float(abs(Fraction(got) - want) / abs(want))


MULTIHOST_SCRIPT = r"""
import json
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from superman_tpu_torch.parallel.mesh import init_distributed, process_info
init_distributed()
import superman_tpu_torch as spt
from superman_tpu_torch.csrc.build import LAUNCHES, launches
from superman_tpu_torch.tools.kernel_time import random_int_matrix
a = random_int_matrix(np.random.default_rng({seed}), {n}, 0.5)
spt.permanent(a, device={device!r})                # warm-up
LAUNCHES.clear()
res = spt.permanent(a, device={device!r})
print("RESULT", json.dumps({{"value": res.permanent.hex(),
                            "launches": launches("walk", "blocks"),
                            "blocks": launches("blocks", tier="df64"),
                            "processes": process_info()[1],
                            "wall_s": res.time}}))
"""


def host_layer_phases(dev, a32, a36, bin32, zero_counts,
                      exact_value=EXACT_N32, seed=SEED) -> dict:
    """The native CPU engine, the mesh (MESH_ENTRIES streams of one card),
    the hybrid scheduler with its journal, two processes over gloo, and
    the estimators' sharded batch and hybrid CPU worker, on a32 (made by
    random_int_matrix from `seed`, permanent exact_value), the sparse a36
    and the 0/1 bin32.  Each raises on failure; returns the launches of
    K1 and its reduced entry on each path and the walls."""
    import os
    import socket
    import subprocess
    import tempfile

    import torch
    import superman_tpu_torch as spt
    from superman_tpu_torch.bindings import native
    from superman_tpu_torch.core.flags import Flags
    from superman_tpu_torch.core.matrix import DenseMatrix
    from superman_tpu_torch.native import build as native_build
    from superman_tpu_torch.ops import approx, exact, gray, modp
    from superman_tpu_torch.ops.glynn import glynn_exact
    from superman_tpu_torch.ops.ryser import (_center_scales, _row_scales,
                                              _sm_count, ryser_exact)
    from superman_tpu_torch.parallel.mesh import make_mesh
    from superman_tpu_torch.parallel.scheduler import compute_partials_hybrid
    from superman_tpu_torch.parallel.sharding import pad_ids

    out = {"walls": {}, "mesh": {}, "hybrid": {}, "multihost": {}}
    walls = out["walls"]
    threads = os.cpu_count()
    n32 = a32.shape[0]
    steps = 1 << (n32 - 1)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    # ---- 5a. the native engine: its build, the dense double walk at
    # n=32, its exact CRT pipeline, and its Z_p walk against K3
    lib_path, walls["native_build_s"] = timed(native_build.build)
    if not native.native_available():
        raise AssertionError("the native engine does not load")
    lib = native.load()
    a = np.ascontiguousarray(a32, dtype=np.float64)
    p_dense, wall = timed(lambda: lib.sup_perman_dense(a, n32, threads, 0))
    walls["native_dense_s"] = wall
    rel = rel_err(p_dense, exact_value)
    print(f"native engine: built in {walls['native_build_s']:.1f} s -> "
          f"{lib_path}; os.cpu_count() {threads}, IFMA {native.cpu_ifma()}; "
          f"sup_perman_dense n={n32}: {p_dense!r} in {wall:.3f} s "
          f"({steps / wall / 1e9:.3f} G steps/s on {threads} threads), "
          f"rel err {rel:.3e} vs the exact integer (limit {NATIVE_TOL})")
    if not rel <= NATIVE_TOL:
        raise AssertionError(f"native dense n={n32}: rel {rel:.3e}")
    (frac, meta), wall = timed(lambda: exact.perman_exact_fraction(
        a32, dev, engine="native", threads=threads))
    walls["native_exact_s"] = wall
    print(f"perman_exact_fraction(engine='native') n={n32}: "
          f"{meta['engine']}, {meta['nprimes']} primes + verifier, "
          f"{wall:.3f} s; equals the exact integer: {frac == exact_value}")
    if frac != exact_value:
        raise AssertionError(f"native exact n={n32}: {frac}")
    # the Z_p walk at n=24 (sup_perman_mod is one thread; at n=32 the
    # exact pipeline above walks the same residues over all threads)
    p = (1 << 31) - 1
    core = [[int(v) for v in row]
            for row in random_int_matrix(np.random.default_rng(24), 24, 0.5)]
    am = np.ascontiguousarray([[v % p for v in row] for row in core],
                              dtype=np.uint64)
    got, walls["native_mod_n24_s"] = timed(
        lambda: int(lib.sup_perman_mod(am, 24, p)))
    zero_counts()
    k3, k3_wall = timed(lambda: modp.perman_core_mod(core, p, dev))
    print(f"native sup_perman_mod n=24 mod {p}: {got} in "
          f"{walls['native_mod_n24_s']:.3f} s; K3 {k3} in {k3_wall:.4f} s "
          f"({launches('modp')} launch)")
    if got != k3 or launches("modp") != 1:
        raise AssertionError(f"native residue n=24: {got} != K3 {k3}")

    # ---- 5b. the mesh: ryser_exact and glynn_exact over MESH_ENTRIES
    # streams of the card, each tier, against one device, bit for bit
    mesh = make_mesh(devices=[dev] * MESH_ENTRIES)
    cases = [(tier, a32, "ryser", Flags(calc=tier)) for tier in TIERS]
    cases += [("sparse n=36 df64", a36, "ryser",
               Flags(calc="df64", sparse=True)),
              ("glynn df64", a32, "glynn",
               Flags(calc="df64", perman_algo="glynn"))]
    for tag, mat, algo, flags in cases:
        dm = DenseMatrix(mat, "int")
        fn = ryser_exact if algo == "ryser" else glynn_exact
        fn(dm, flags, dev)                                # warm-up
        one, one_wall = min((timed(lambda: fn(dm, flags, dev))
                             for _ in range(3)), key=lambda rw: rw[1])
        fn(dm, flags, dev, mesh=mesh)
        zero_counts()
        many, many_wall = timed(lambda: fn(dm, flags, dev, mesh=mesh))
        counts = {"k1": k1_count(),
                  "blocks": launches("blocks"),
                  "reduced": launches("reduced")}
        many_wall = min(many_wall, min(timed(lambda: fn(
            dm, flags, dev, mesh=mesh))[1] for _ in range(2)))
        out["mesh"][tag] = counts
        walls[f"mesh {tag}"] = {"one_device_s": one_wall,
                                "mesh_s": many_wall}
        print(f"mesh of {MESH_ENTRIES} streams, {tag}: {many.permanent!r} "
              f"({many.algo_name}, mesh {many.meta['mesh']}) in "
              f"{many_wall:.4f} s, one device {one.permanent!r} in "
              f"{one_wall:.4f} s (best of 3 each); launches {counts}")
        want_key = "reduced" if "sparse" in tag else "k1"
        if many.permanent != one.permanent \
                or many.meta["mesh"] != MESH_ENTRIES \
                or counts[want_key] != MESH_ENTRIES:
            raise AssertionError(f"mesh {tag}: {many.permanent!r} vs "
                                 f"{one.permanent!r}, launches {counts}")
    entry_res = spt.permanent(a32, mesh_shape=(MESH_ENTRIES,), device=dev)
    print(f"permanent(a32, mesh_shape=({MESH_ENTRIES},)) on "
          f"{torch.cuda.device_count()} card(s): mesh "
          f"{entry_res.meta['mesh']}, {entry_res.permanent!r}")
    if dev.type == "cuda" and torch.cuda.device_count() == 1 \
            and entry_res.meta["mesh"] is not None:
        raise AssertionError("mesh_shape on one card gave a mesh")

    # ---- 5c. the hybrid scheduler with its journal, through permanent(),
    # then resumed (the CPU worker may take no unit there: its unit
    # outlasts the card's walk); and compute_partials_hybrid at one block
    # a unit, where the card's remaining walk outlasts a CPU unit, so that
    # both workers take units
    with tempfile.TemporaryDirectory() as tmp:
        journal = os.path.join(tmp, "hybrid.jsonl")
        one, one_wall = timed(lambda: spt.permanent(a32, device=dev))
        zero_counts()
        res, wall = timed(lambda: spt.permanent(
            a32, hybrid=True, cpu=True, checkpoint_path=journal,
            threads=threads, device=dev))
        h = res.meta["hybrid"]
        out["hybrid"]["permanent"] = k1_count()
        rel = rel_err(res.permanent, exact_value)
        again, again_wall = timed(lambda: spt.permanent(
            a32, hybrid=True, cpu=True, checkpoint_path=journal,
            threads=threads, device=dev))
    print(f"hybrid permanent(a32, hybrid=True, cpu=True, checkpoint): "
          f"{res.permanent!r} ({res.algo_name}) in {wall:.4f} s, one device "
          f"{one_wall:.4f} s; units {h}, rel err {rel:.3e} vs the exact "
          f"integer; {k1_count()} K1 launches; resumed run "
          f"{again.permanent!r} in {again_wall:.4f} s, units "
          f"{again.meta['hybrid']}")
    # on a card no unit may fail over to the CPU: no retry, no hand-off
    if not rel <= HYBRID_TOL or h["device"] + h["cpu"] != h["units"] \
            or h["retries"] != 0 or h["handoffs"] != 0 \
            or again.meta["hybrid"]["resumed"] != h["units"] \
            or not rel_err(again.permanent, res.permanent) <= RESUME_TOL \
            or out["hybrid"]["permanent"] != h["device"]:
        raise AssertionError("hybrid through permanent()")
    walls["hybrid"] = {"permanent_s": wall, "resumed_s": again_wall,
                       "one_device_s": one_wall, "units": h,
                       "resumed_bitwise": again.permanent == res.permanent}
    sms = _sm_count(dev)
    plan = gray.make_plan(n32, sms=sms, min_blocks=32)
    scales = _center_scales(a32, _row_scales(a32))
    a_s = np.ldexp(a, -scales[:, None])
    x0, cols = gray.pack_matrix(a_s, plan.n_pad)
    ids_blocks = pad_ids(np.arange(plan.num_chunks, dtype=np.int64),
                         plan.lanes)
    zero_counts()
    (total, stats), wall = timed(lambda: compute_partials_hybrid(
        a_s, ids_blocks, x0, cols, plan, dev, threads=threads,
        unit_blocks=1))
    out["hybrid"]["unit_blocks=1"] = k1_count()
    value = float((4 * (n32 & 1) - 2)
                  * np.ldexp(np.float64(total), int(scales.sum())))
    rel = rel_err(value, exact_value)
    print(f"compute_partials_hybrid, unit_blocks=1 ({len(ids_blocks)} "
          f"blocks of {plan.lanes} chunks of 2^{plan.r}): {value!r} in "
          f"{wall:.4f} s, rel err {rel:.3e}; units {stats}; "
          f"{k1_count()} K1 launches")
    walls["hybrid"]["unit_blocks=1_s"] = wall
    walls["hybrid"]["unit_blocks=1_units"] = {
        "device": stats.units_device, "cpu": stats.units_cpu}
    if not rel <= HYBRID_TOL or stats.units_device < 1 \
            or stats.units_cpu < 1 or stats.retries != 0 \
            or stats.handoffs != 0 \
            or k1_count() != stats.units_device:
        raise AssertionError(f"hybrid unit_blocks=1: {stats}")

    # ---- 5d. two processes joined over gloo, each on this card
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.abspath(__file__))
    code = MULTIHOST_SCRIPT.format(repo=repo, seed=seed, n=n32,
                                   device=str(dev))
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=repo,
                              env=dict(env, RANK=str(i)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    results = []
    try:
        for proc in procs:
            so, se = proc.communicate(timeout=300)
            lines = [ln for ln in so.splitlines() if ln.startswith("RESULT")]
            if proc.returncode != 0 or not lines:
                raise AssertionError(
                    f"multi-process rank failed ({proc.returncode}):\n"
                    f"{so}\n{se[-3000:]}")
            results.append(json.loads(lines[-1][len("RESULT "):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    values = [float.fromhex(r["value"]) for r in results]
    one = spt.permanent(a32, device=dev).permanent
    print(f"two processes (gloo, WORLD_SIZE=2, each on {dev}): "
          f"{[repr(v) for v in values]}, {[r['launches'] for r in results]} "
          f"K1 launches, walls {[round(r['wall_s'], 4) for r in results]} s; "
          f"one process {one!r}")
    out["multihost"] = [r["launches"] for r in results]
    out["multihost_blocks"] = [r["blocks"] for r in results]
    walls["multihost_s"] = [r["wall_s"] for r in results]
    if values[0] != values[1] or any(r["processes"] != 2 for r in results) \
            or not rel_err(values[0], one) <= MULTIHOST_TOL \
            or min(out["multihost"]) < 1:
        raise AssertionError(f"multi-process: {values} vs {one}")

    # ---- 5e. the estimators: Rasmussen over a mesh of 2 streams, twice,
    # and with the hybrid CPU trial worker
    want = spt.permanent(bin32, calc="exact",
                         device=dev).meta["exact_fraction"]
    flags = Flags(approximation=True, perman_algo="rasmussen")
    mesh2 = make_mesh(devices=[dev] * 2)
    runs = [timed(lambda: approx.approximate(DenseMatrix(bin32, "int"),
                                             flags, dev, mesh=mesh2))
            for _ in range(2)]
    hyb, hyb_wall = timed(lambda: spt.permanent(
        bin32, approximation=True, perman_algo="rasmussen", hybrid=True,
        cpu=True, threads=threads, device=dev))
    for tag, (res, wall) in (("mesh of 2", runs[0]), ("mesh of 2 again",
                                                      runs[1]),
                             ("hybrid", (hyb, hyb_wall))):
        se = res.meta["stderr"]
        z = float((Fraction(res.permanent) - want) / Fraction(se)) \
            if se and math.isfinite(se) else math.inf
        walls[f"rasmussen {tag}"] = {"wall_s": wall, "z": z,
                                     "trials": res.meta["trials"],
                                     "cpu_trials": res.meta["cpu_trials"]}
        print(f"estimator rasmussen n={bin32.shape[0]}, {tag}: "
              f"{res.permanent!r} +- "
              f"{se!r}, {z:+.3f} stderr; {res.algo_name}, "
              f"{res.meta['trials']} trials ({res.meta['cpu_trials']} on "
              f"the native engine) in {wall:.3f} s")
        if res.meta["trials"] != 100000 or not abs(z) <= EST_SIGMAS:
            raise AssertionError(f"estimator {tag}: z {z}")
    if runs[0][0].permanent != runs[1][0].permanent \
            or hyb.algo_name != "approx_rasmussen_hybrid" \
            or hyb.meta["cpu_trials"] < 1:
        raise AssertionError("estimators: the mesh runs differ, or the "
                             "hybrid run took no native trials")
    return out


def tools_phase(dev, zero_counts) -> dict:
    """Phase 6: the tools of superman_tpu_torch/tools on the card, each
    through its own function, on the seeded corpus of tools/corpus.py in a
    temporary directory; each limit raises.  Returns the walls, what the
    tools measured and the launches of every kernel over the phase."""
    import os
    import tempfile

    from superman_tpu_torch.tools import (accuracy, corpus, exact_known,
                                          fuzz, real_suite, scaling_measure,
                                          sparse_report, suite_check)

    out = {"walls": {}}
    walls = out["walls"]

    def log(s):
        print(f"  {s}", flush=True)

    def timed(tag, fn):
        t = time.perf_counter()
        res = fn()
        walls[tag] = time.perf_counter() - t
        return res

    def jsonl(path):
        with open(path) as f:
            return {d["file"]: d for d in map(json.loads, f)}

    zero_counts()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 6a. the fuzzer: K1 in three tiers, the reduced entry, the amp
        # walks and K3 under random flags, against the f64 oracle
        fails = timed("fuzz", lambda: fuzz.run(FUZZ_TRIALS, 0, dev, log=log))
        out["fuzz_trials_per_s"] = FUZZ_TRIALS / walls["fuzz"]
        print(f"fuzz: {FUZZ_TRIALS - fails}/{FUZZ_TRIALS} ok at seed 0 in "
              f"{walls['fuzz']:.2f} s ({out['fuzz_trials_per_s']:.2f} "
              f"trials/s)")
        if fails:
            raise AssertionError(f"fuzz: {fails} failures")

        # ---- 6b. the accuracy sweep on the seeded n=30 file
        path30, path32 = corpus.write_int_suite(tmp, 0, ns=(30, 32),
                                                densities=("0.50",))
        recs, bad = timed("accuracy", lambda: accuracy.run_sweep(
            [path30], device=dev, log=lambda s: None))
        print("accuracy n=30: " + "; ".join(
            f"{r['config']} {r['time']:.3f} s"
            + (f" rel {r['rel_err']:.2e}" if "rel_err" in r else "")
            for r in recs) + f"; {walls['accuracy']:.2f} s")
        if bad or len(recs) != len(accuracy.SWEEP):
            raise AssertionError(f"accuracy: {bad}")

        # ---- 6c. suite_check: df64 against the native double engine
        rows, worst = timed("suite_check", lambda: suite_check.check(
            [path30, path32], device=dev, log=log))
        print(f"suite_check n=30, 32 d=0.50: worst {worst:.3e} (limit "
              f"{SUITE_TOL}); {walls['suite_check']:.2f} s")
        if not worst <= SUITE_TOL or len(rows) != 2:
            raise AssertionError(f"suite_check: worst {worst}")

        # ---- 6d. sparse_report: the pruned walk against the dense one
        sparse = corpus.write_int_suite(tmp, 0, ns=(32,),
                                        densities=("0.10", "0.15"))
        rows, worst = timed("sparse_report", lambda: sparse_report.run(
            sparse, device=dev, log=log))
        out["sparse_report"] = [{k: r[k] for k in (
            "file", "rel_diff", "sparse_wall_s", "dense_wall_s", "speedup",
            "plan")} for r in rows]
        print(f"sparse_report n=32 d=0.10, 0.15: worst {worst:.3e} (limit "
              f"{SUITE_TOL}); {walls['sparse_report']:.2f} s")
        if not worst <= SUITE_TOL or len(rows) != 2:
            raise AssertionError(f"sparse_report: worst {worst}")

        # ---- 6e. modp_rate at n=32
        out["modp_rate"] = timed("modp_rate", lambda: modp_rate.measure(
            32, device=dev, log=log))
        print(f"modp_rate: {json.dumps(out['modp_rate'])}")
        if not out["modp_rate"]["value"] > 0:
            raise AssertionError("modp_rate: no rate")

        # ---- 6f. scaling_measure at n=30 and 32 (the mesh's value must
        # be the one device's, bit for bit: the tool raises otherwise)
        sm = timed("scaling_measure", lambda: scaling_measure.measure(
            (30, 32), root=tmp, device=dev, log=log))
        out["scaling"] = {
            "overheads_s": {k: {"mesh1": c["mesh1_overhead_s"],
                                "streams": c["streams_overhead_s"],
                                "plain_s": c["plain"]["wall_mean"],
                                "one_s": c["one"]["wall_mean"]}
                            for k, c in sm["cases"].items()},
            "efficiency_bound": sm["efficiency_bound"],
            "sparse_layout": sm["sparse_layout"]}
        print(f"scaling_measure: {json.dumps(out['scaling'])}")

        # ---- 6g. exact_known on the seeded corpus: one row declined by
        # the budget, then certified by --merge; --reverify on the native
        # engine, --algo2-card (K3 under Glynn)
        root = os.path.join(tmp, "corpus")
        corpus.write_real_corpus(root, 0)
        paths = corpus.corpus(root)
        known = os.path.join(tmp, "known.jsonl")
        report = os.path.join(tmp, "report.json")

        def certify_twice():
            failed = exact_known.certify(paths, known, KNOWN_BUDGETS[0], dev,
                                         log=log)
            first = {k for k, r in jsonl(known).items() if r.get("declined")}
            failed += exact_known.certify(paths, known, KNOWN_BUDGETS[1],
                                          dev, merge=True, log=log)
            return failed, first

        failed, first = timed("exact_known", certify_twice)
        rows = jsonl(known)
        certified = sorted(k for k in first if rows[k].get("engine"))
        still = sorted(k for k, r in rows.items() if r.get("declined"))
        bad_rev = timed("exact_known_reverify", lambda: exact_known.reverify(
            paths, known, REVERIFY_BUDGET_S, dev, report=report, log=log))
        bad_alg = timed("exact_known_algo2_card",
                        lambda: exact_known.algo2_card(paths, known, dev,
                                                       report=report,
                                                       log=log))
        with open(report) as f:
            rep = json.load(f)["rows"]
        matched = sum(bool(r.get("crt_match")) for r in rep)
        glynn = sum(bool(r.get("glynn_card_ok")) for r in rep)
        out["exact_known"] = {
            "declined_then_certified": certified, "declined": still,
            "reverify_match": matched, "algo2_card_ok": glynn,
            "walls_s": {r["file"]: r["wall_s"] for r in rows.values()
                        if r.get("engine")}}
        print(f"exact_known: {json.dumps(out['exact_known'])}")
        if failed or bad_rev or bad_alg or not certified or not matched \
                or glynn < len(certified) or any(
                    not r.get("glynn_card_ok") for r in rep
                    if "glynn_card_ok" in r):
            raise AssertionError("exact_known: a certification raised, no "
                                 "row went from declined to certified, or "
                                 "a check failed")

        # ---- 6h. real_suite --quick, arbitrated by exact_known's rows
        suite_out = os.path.join(tmp, "real.jsonl")
        fails = timed("real_suite", lambda: real_suite.run_suite(
            root, suite_out, quick=True, device=dev, known=known, log=log))
        with open(suite_out) as f:
            srows = [json.loads(x) for x in f]
        classes = sorted({r["class"] for r in srows})
        print(f"real_suite --quick: {len(srows)} rows, classes {classes}, "
              f"{fails} FAIL; {walls['real_suite']:.2f} s")
        if fails or not srows:
            raise AssertionError(f"real_suite: {fails} failures")
    walls["phase"] = time.perf_counter() - t_phase
    out["launches"] = {
        "k1": tier_counts("walk", "blocks"),
        "blocks": tier_counts("blocks", tiers=BLOCK_TIERS),
        "batch": launches("batch"),
        "reduced": tier_counts("reduced"),
        "amp": launches("amp"),
        "cond": launches("amp_cond"), "modp": launches("modp")}
    print(f"tools phase: walls (s) {json.dumps(walls)}; launches "
          f"{json.dumps(out['launches'])}")
    return out


def nan_switch_phase(dev, a32, a36, stack_a, card) -> dict:
    """Phase 7, SUPERMAN_DEBUG_NANS (superman_tpu_torch/utils/debug.py) on
    the card.  With the variable set, the n=32 df64 permanent and the
    256 x n=24 df64 batch give the bits and the launches they give
    without it (walls best of 3, the two settings in turns); a NaN in the
    packed x0 of each kernel entry at its path's shapes (K1 in every
    tier, the reduced entry on the n=36 plan in every tier, both amp
    walks, K2 in every tier at 256 x n=24), in the float64 walk and in
    each estimator's trial raises FloatingPointError naming it, and the
    kernel was launched; a NaN entry given to permanent or
    permanent_batch is a ValueError before any launch.  The environment
    is restored in `finally`.  Returns the walls and what was checked."""
    import os

    import torch
    import superman_tpu_torch as spt
    from superman_tpu_torch.ops import approx, batch, gray, pruning
    from superman_tpu_torch.ops.ryser import (K1_GITERS, _center_scales,
                                              _row_scales, _sm_count)
    from superman_tpu_torch.ops.ryser_walk import ryser_walk
    from superman_tpu_torch.parallel import sharding
    from superman_tpu_torch.utils import debug

    def counts():
        """Every kernel's launch count, by kernel and tier."""
        return {**{f"k1 {t}": n
                   for t, n in tier_counts("walk", "blocks").items()},
                **{f"reduced {t}": n
                   for t, n in tier_counts("reduced").items()},
                "batch": launches("batch"),
                "amp": launches("amp", "amp_cond"),
                "amp cond": launches("amp_cond"),
                "modp": launches("modp")}

    def launched(before):
        """The launches since `before` (a counts()), those not 0."""
        return {k: n - before[k] for k, n in counts().items()
                if n != before[k]}

    def switch(on: bool):
        if on:
            os.environ[debug.ENV] = "1"
        else:
            os.environ.pop(debug.ENV, None)

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    def same_with_and_without(fn, values, words):
        """fn() three times under each setting, in turns (off first):
        the values' bits and the launches of every run must agree.
        Returns the walls in ms of each setting, their best, and the
        host time in ms of the check alone on `words`, the host array
        the path checks (median of 21)."""
        walls = {"off_ms": [], "on_ms": []}
        seen = set()
        for _ in range(3):
            for on in (False, True):
                switch(on)
                before = counts()
                res, dt = wall(fn)
                walls["on_ms" if on else "off_ms"].append(dt * 1e3)
                seen.add(json.dumps([values(res), launched(before)]))
        if len(seen) != 1:
            raise AssertionError(f"the values or launches differ between "
                                 f"runs or settings: {seen}")
        switch(True)
        check = []
        for _ in range(21):
            t = time.perf_counter()
            debug.check_nan("words", words)
            check.append((time.perf_counter() - t) * 1e3)
        switch(False)
        best = {k: min(v) for k, v in walls.items()}
        return {"best_off_ms": best["off_ms"], "best_on_ms": best["on_ms"],
                "overhead": best["on_ms"] / best["off_ms"] - 1, **walls,
                "check_ms": float(np.median(check)),
                "words": list(words.shape),
                "launches": json.loads(seen.pop())[1]}

    def raises(name, fn, kernel=None):
        """fn() under the switch must raise FloatingPointError naming
        `name`, after one launch of `kernel` (a key of counts()) where one
        is given."""
        before = counts()
        try:
            fn()
        except FloatingPointError as e:
            if not str(e).endswith(f"output of {name}"):
                raise AssertionError(f"{name}: the message names "
                                     f"something else: {e}") from e
        else:
            raise AssertionError(f"{name}: a NaN went through unreported")
        if kernel is not None and launched(before) != {kernel: 1}:
            raise AssertionError(f"{name}: launches {launched(before)}, "
                                 f"not one of {kernel}")
        return name

    out = {}
    t_phase = time.perf_counter()
    saved = os.environ.get(debug.ENV)
    try:
        # ---- 7a. clean input: bits, launches and walls with and without;
        # the check's own host time on the words each path checks (K1's
        # words at the n=32 plan, K2's at 256 x n=24)
        sms = _sm_count(dev)
        plan = gray.make_plan(len(a32), sms=sms)
        nb = stack_a.shape[1]
        rb = gray.batch_plan(nb, len(stack_a), sms=sms)
        out["n32_df64"] = same_with_and_without(
            lambda: spt.permanent(a32, calc="df64", device=dev),
            lambda res: res.permanent.hex(),
            np.zeros((plan.num_chunks, 2)))
        mats = list(stack_a)
        out["batch_256_n24_df64"] = same_with_and_without(
            lambda: spt.permanent_batch(mats, calc="df64", device=dev),
            lambda res: [r.permanent.hex() for r in res],
            np.zeros((len(stack_a), (1 << (nb - 1 - rb)) // 128, 2)))
        print(f"NaN switch, clean input, bit for bit and the same launches "
              f"with and without it (3 runs each in turns; {card}): "
              f"{json.dumps(out)}")

        # ---- 7b. a NaN x0 through each kernel entry at its path's shapes
        switch(True)
        checked = []
        a_s = np.ldexp(a32.astype(np.float64),
                       -_center_scales(a32, _row_scales(a32))[:, None])
        x0, cols = gray.pack_matrix(a_s, plan.n_pad)
        x0 = x0.copy()
        x0[0] = np.nan
        ids = sharding.pad_ids(np.arange(plan.num_chunks), plan.lanes)
        for tier in TIERS:
            checked.append(raises(
                f"ryser_walk_{tier}",
                lambda: sharding.compute_partials(ids, x0, cols, plan, dev,
                                                  tier), f"k1 {tier}"))
        checked.append(raises(
            "ryser_walk_amp",
            lambda: sharding.compute_amp(ids, x0, cols, plan, dev, False),
            "amp"))
        before = counts()
        checked.append(raises(
            "ryser_walk_amp_cond",
            lambda: sharding.compute_amp(ids, x0, cols, plan, dev, True)))
        if launched(before) != {"amp": 1, "amp cond": 1}:
            raise AssertionError(f"ryser_walk_amp_cond: launches "
                                 f"{launched(before)}")
        for tier in TIERS:
            sp36 = pruning.plan_sparse(a36, giters=K1_GITERS[tier])
            ap = np.ascontiguousarray(a36[:, sp36.col_perm]).astype(
                np.float64)
            ap_s = np.ldexp(ap, -_center_scales(ap, _row_scales(ap))[:, None])
            rx0, rcols = gray.pack_matrix(ap_s[sp36.alive_rows],
                                          gray.pad_n(len(sp36.alive_rows)))
            rx0 = rx0.copy()
            rx0[0] = np.nan
            factors = gray.pack_matrix(ap_s[sp36.factor_rows],
                                       len(sp36.factor_rows))
            rplan = gray.RyserPlan(n=len(a36), n_pad=len(rx0), r=sp36.r,
                                   lanes=512,
                                   num_chunks=1 << (len(a36) - 1 - sp36.r))
            checked.append(raises(
                f"ryser_walk_reduced ({tier})",
                lambda: sharding.compute_total(
                    rx0, rcols, rplan, dev, tier,
                    sparse=(sp36.ids, *factors), sms=sms),
                f"reduced {tier}"))
        x0p, colsT, _, _ = batch.pack_stack(np.asarray(stack_a, np.float64))
        x0p[len(x0p) // 2, 0] = np.nan
        for tier in TIERS:
            checked.append(raises(
                f"ryser_batch ({tier})",
                lambda: batch.walk_stack(x0p, colsT, n=nb, r=rb, calc=tier,
                                         device=dev), "batch"))
        # the float64 walk at the n < 19 route's widest order
        a18 = random_int_matrix(np.random.default_rng(18), 18, 0.5).astype(
            np.float64)
        a18[4, 7] = np.nan
        checked.append(raises("walk_lanes (float64)",
                              lambda: ryser_walk(a18, dev)))
        # the estimators' trials at the shapes of the phases that run them:
        # a batch of 2^14 (Rasmussen, scaling) or 2^13 (Gurvits) trials at
        # n=32 and n=24, one SMC population of 4096 at n=64; row 3 NaN
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)

        def nan_mats(n):
            a = (np.random.default_rng(n).random((n, n)) < 0.5) + np.eye(n)
            a[3] = np.nan
            return approx._device_matrices(a, dev)

        m32, m24, m64 = nan_mats(32), nan_mats(24), nan_mats(64)
        nz = m32[2].clone()
        nz[3] = float("nan")
        checked.append(raises("_rasmussen_trial",
                              lambda: approx._rasmussen_trial(nz, 1 << 14,
                                                              gen)))
        checked.append(raises("_gurvits_trial", lambda: approx._gurvits_trial(
            m24[0], torch.randn(1 << 13, 24, generator=gen, device=dev))))
        checked.append(raises("_scaling_trial", lambda: approx._scaling_trial(
            *m32, 1 << 14, gen, 4, 5)))
        ones = torch.ones(64, device=dev)
        checked.append(raises("_smc_population",
                              lambda: approx._smc_population(
                                  *m64, ones, ones, gen, scale_intervals=2,
                                  scale_times=5, B=4096)))
        out["raised"] = checked
        print(f"NaN switch, a NaN below the API: FloatingPointError from "
              f"each of {len(checked)} entries, naming it: {checked}")

        # ---- 7c. a NaN entry of the input: refused before any launch
        bad = a32.astype(np.float64)
        bad[5, 9] = np.nan
        before = counts()
        for call in (lambda: spt.permanent(bad, device=dev),
                     lambda: spt.permanent_batch(mats[:3] + [bad],
                                                 device=dev)):
            try:
                call()
            except ValueError as e:
                if "entry (5, 9) is nan" not in str(e):
                    raise AssertionError(f"the ValueError says: {e}") from e
            else:
                raise AssertionError("a NaN entry was not refused")
        if launched(before):
            raise AssertionError(f"a refused input launched "
                                 f"{launched(before)}")
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"NaN switch: a NaN entry given to permanent and "
              f"permanent_batch is a ValueError, 0 launches; phase "
              f"{out['phase_s']:.1f} s")
    finally:
        if saved is None:
            os.environ.pop(debug.ENV, None)
        else:
            os.environ[debug.ENV] = saved
    return out


def bench_phase(dev, zero_counts) -> dict:
    """Phase 8: the bench.  tools/bench.py's measuring function once on
    the card (the seeded n=32 matrices, every tier, the sparse walk beside
    the dense one), then tools/capture_bench.py once in a subprocess,
    recording its own run of the bench to a temporary path.  An error past
    its limit, a capture that fails or parses no line, or a kernel of the
    bench's path that was not launched raises.  Returns the measuring
    run's launches of K1 per tier and of the reduced entry, and the walls
    of the run and of the capture."""
    import os
    import subprocess
    import tempfile

    from superman_tpu_torch.tools import bench

    zero_counts()
    t = time.perf_counter()
    line = bench.measure(dev, log=lambda s: print(f"  bench: {s}",
                                                  flush=True))
    wall = time.perf_counter() - t
    counts = {"k1": tier_counts("walk", "blocks"),
              "blocks": tier_counts("blocks", tiers=BLOCK_TIERS),
              "reduced": tier_counts("reduced")}
    print("bench: " + json.dumps(line))
    bad = bench.failures(line)
    if bad:
        raise AssertionError(f"bench: {bad}")
    if not all(counts["k1"][t] for t in TIERS) \
            or not counts["reduced"]["df64"]:
        raise AssertionError(f"bench: a kernel of its path was not "
                             f"launched: {counts}")
    d = line["detail"]
    print(f"bench: {line['value']:.4f} G iters/s df64 (vs_baseline "
          f"{line['vs_baseline']:.3f}), f32 {d['f32_g_iters_per_sec']:.4f}, "
          f"f32k {d['f32k_g_iters_per_sec']:.4f}, tf96 "
          f"{d['tf96_g_iters_per_sec']:.4f}; sparse/dense speedup "
          f"{d['sparse_vs_dense_speedup']:.3f}; errors "
          f"{json.dumps(bench.errors(line))}; {wall:.1f} s; launches "
          f"{json.dumps(counts)}; {d['card']}")

    repo = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bench_torch_r00.json")
        proc = subprocess.run(
            [sys.executable, "-m", "superman_tpu_torch.tools.capture_bench",
             "--n", "0", "--out", out, "--timeout", str(CAPTURE_TIMEOUT_S)],
            cwd=repo, capture_output=True, text=True,
            timeout=CAPTURE_TIMEOUT_S + 60)
        with open(out) as f:
            rec = json.load(f)
    capture_wall = time.perf_counter() - t
    parsed = rec["parsed"]
    print(f"capture_bench: {proc.stdout.strip()}; rc {proc.returncode}, "
          f"record rc {rec['rc']}, {capture_wall:.1f} s")
    if proc.returncode != 0 or rec["rc"] != 0 or parsed is None:
        raise AssertionError(f"capture_bench: rc {proc.returncode}, record "
                             f"rc {rec['rc']}; tail {rec['tail'][-2000:]}")
    bad = bench.failures(parsed)
    if bad or parsed["metric"] != line["metric"]:
        raise AssertionError(f"capture_bench: {bad or parsed['metric']}")
    return {"launches": counts, "wall_s": wall,
            "capture_wall_s": capture_wall}


def walk_range_phase(dev, card, zero_counts) -> dict:
    """Phase 9: the range of every exact and estimating route, each row or
    column scaled by an exact power of two.  Every RANGE_CASES row and the
    RANGE_BATCH batch through the default entry points on the card (the
    float lane walks, ops/ryser_walk.py, the batch below n=13, Glynn's
    float64 route); then the routes on the host by design at HOST_SCALES
    (calc="tf96" below n=19 dense and sparse, calc="auto", Glynn's tf96,
    calc="quad" through the host walk with the native engine hidden and
    through the native engine, cpu=True dense, sparse and SkipPer,
    read_calculate_return on a triplet file in a temporary directory),
    orders 1 and 2 (the cancelling [[s, s], [s, -s]], also through
    permanent_batch), the scaling estimator on the card (its batch of
    trials and the SMC populations, n=16) and the native double walk on
    every RANGE_CASES matrix.  Each is held to calc="exact" (the modular
    engine, K3): a NaN, a -0.0 or a value past its limit raises, and so
    does a card route that did not run on the card; a route on the host
    by design says so by its algo_name.  The walls of the lane routes and
    of the host routes (tools/lane_walls.py) and the host time of the
    scales alone.  Returns the rows, the walls, the launches of every
    kernel over the phase and its wall."""
    import os
    import statistics
    import tempfile

    import superman_tpu_torch as spt
    from superman_tpu_torch.bindings import native as nat
    from superman_tpu_torch.core.matrix import DenseMatrix
    from superman_tpu_torch.io.triplet import write_triplet
    from superman_tpu_torch.ops import tf96
    from superman_tpu_torch.ops.ryser_walk import times_pow2, walk_scales
    from superman_tpu_torch.tools import lane_walls

    zero_counts()
    t_phase = time.perf_counter()

    def mat(n, seed, scale):
        return np.random.default_rng(seed).integers(1, 5, (n, n)) * scale

    def host_mat(scale, signed):
        a = mat(18, 18, 1.0)
        if scale is None:
            return np.ldexp(a, np.where(np.arange(18) % 2, -600,
                                        600)[:, None])
        if signed:
            a = a * np.where(np.random.default_rng(19).random((18, 18))
                             < 0.5, -1, 1)
        return a * scale

    def show(x) -> str:
        try:
            return repr(float(x))
        except OverflowError:
            return "inf" if x > 0 else "-inf"

    def held(got: float, exact, tol: float, stderr=None) -> bool:
        want = show(exact)
        if math.isnan(got):
            return False
        if want in ("inf", "-inf"):
            return got == float(want)
        if float(want) == 0.0:
            return got == 0.0 and math.copysign(1.0, got) > 0
        if stderr is not None:
            return abs(got - float(want)) <= 4 * stderr
        return rel_err(got, exact) <= tol

    exact = {}
    rows = []

    def exact_of(a):
        key = a.tobytes() + bytes(a.shape)
        if key not in exact:
            exact[key] = spt.permanent(a, calc="exact").meta[
                "exact_fraction"]
        return exact[key]

    def on_the_host(res) -> bool:
        """A route that runs on the host by design, by its name."""
        name = res.algo_name
        return (name in ("ryser_quad_host", "ryser_tf96_host",
                         "sparyser_tf96_host", "ryser_exact")
                or name.startswith("cpu_")
                or (name == "glynn_host"
                    and res.meta.get("calc") in ("tf96", "quad")))

    def hold(label, a, res, tol, stderr=None):
        """res: a Result, or the float of read_calculate_return."""
        got = res if isinstance(res, float) else res.permanent
        ok = held(got, exact_of(a), tol, stderr)
        if isinstance(res, float):
            algo, where = "read_calculate_return", "host"
        elif on_the_host(res):
            algo, where = res.algo_name, "host"
        else:
            algo = res.algo_name
            where = ("card" if algo.startswith(("ryser_cuda", "glynn_cuda",
                                                "approx_"))
                     or res.meta.get("device") == str(dev) else "not card")
        rows.append({"case": label, "algo": algo, "route": where,
                     "value": show(got), "exact": show(exact_of(a)),
                     "ok": ok})
        if not ok or where == "not card":
            raise AssertionError(f"walk range: {rows[-1]}")

    for label, shape, kw in RANGE_CASES:
        hold(label, mat(*shape), spt.permanent(mat(*shape), **kw),
             F32_TOL if kw.get("calc") == "f32" else RANGE_TOL)
    for shape, res in zip(RANGE_BATCH, spt.permanent_batch(
            [mat(*shape) for shape in RANGE_BATCH])):
        hold(f"batch n{shape[0]}x{shape[2]:g}", mat(*shape), res, RANGE_TOL)

    # the routes on the host by design, and calc="auto" beside them
    long_tol = LONG_TOL if tf96.LONGDOUBLE_WIDE else RANGE_TOL
    native_available = nat.native_available

    def without_native(fn):
        nat.native_available = lambda: False
        try:
            return fn()
        finally:
            nat.native_available = native_available

    host_routes = {
        "tf96": (lambda a: spt.permanent(a, calc="tf96"), long_tol),
        "tf96 sparse": (lambda a: spt.permanent(a, calc="tf96",
                                                sparse=True), long_tol),
        "auto": (lambda a: spt.permanent(a, calc="auto"), RANGE_TOL),
        "glynn tf96": (lambda a: spt.permanent(
            a.T.copy(), calc="tf96", perman_algo="glynn"), long_tol),
        "quad host walk": (lambda a: without_native(
            lambda: spt.permanent(a, calc="quad")), long_tol),
        "glynn quad host walk": (lambda a: without_native(
            lambda: spt.permanent(a.T.copy(), calc="quad",
                                  perman_algo="glynn")), long_tol),
        "quad native": (lambda a: spt.permanent(a, calc="quad", threads=8),
                        long_tol),
        "cpu dense": (lambda a: spt.permanent(a, cpu=True, gpu=False,
                                              threads=8), RANGE_TOL),
        "cpu sparse": (lambda a: spt.permanent(
            a, cpu=True, gpu=False, sparse=True, threads=8), RANGE_TOL),
        "cpu skipper": (lambda a: spt.permanent(
            a, cpu=True, gpu=False, sparse=True, preprocessing=2,
            threads=8), RANGE_TOL),
    }
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.txt")

        def from_file(a):
            write_triplet(path, DenseMatrix(a, "double"))
            return nat.read_calculate_return(path, 5, nt=8)

        host_routes["read_calculate_return"] = (from_file, RANGE_TOL)
        for tag, scale, signed in HOST_SCALES:
            a = host_mat(scale, signed)
            # Glynn's routes walk the transpose, the same permanent:
            # Glynn scales the lines it sums across, the columns
            for name, (call, tol) in host_routes.items():
                hold(f"n18x{tag} {name}", a, call(a), tol)

    # orders 1 and 2: the cancelling [[s, s], [s, -s]] (exact 0) and the
    # seeded n=1, through permanent, Glynn, tf96 and permanent_batch
    for tag, scale, _ in HOST_SCALES[:4]:
        for a in (np.array([[1.0, 1.0], [1.0, -1.0]]) * scale,
                  mat(1, 3, scale)):
            for name, call in (
                    ("ryser", lambda a: spt.permanent(a)),
                    ("glynn", lambda a: spt.permanent(
                        a, perman_algo="glynn")),
                    ("tf96", lambda a: spt.permanent(a, calc="tf96")),
                    ("permanent_batch",
                     lambda a: spt.permanent_batch([a, a])[1])):
                hold(f"n{a.shape[0]}x{tag} {name}", a, call(a), RANGE_TOL)

    # the scaling estimator on the card, n=16 (entries past a float32's
    # range at 1e300; rows 2^1200 apart), 10^4 trials
    est = np.random.default_rng(16).random((16, 16))
    for tag, a in (("1e300", est * 1e300), ("1e-300", est * 1e-300),
                   ("rows2^+-600", np.ldexp(est, np.where(
                       np.arange(16) % 2, -600, 600)[:, None]))):
        for name, kw in (("sis", {}), ("smc", dict(smc=1))):
            res = spt.permanent(a, approximation=True,
                                perman_algo="scaling", number_of_times=10000,
                                seed=1, **kw)
            hold(f"n16x{tag} {name}", a, res, 0.0, res.meta["stderr"])

    # the native engine's double walk on every lane-walk matrix, held
    native = []
    for shape in dict.fromkeys(s for _, s, _ in RANGE_CASES):
        res = spt.permanent(mat(*shape), cpu=True, gpu=False, threads=8)
        hold(f"native {shape}", mat(*shape), res, RANGE_TOL)
        native.append(rows[-1])
    counts = {"k1": tier_counts("walk", "blocks"),
              "blocks": tier_counts("blocks", tiers=BLOCK_TIERS),
              "batch": launches("batch"),
              "reduced": tier_counts("reduced"),
              "amp": launches("amp"),
              "cond": launches("amp_cond"),
              "modp": launches("modp")}

    # the lane routes through the entry points (their walls before the
    # scales: lane_walls.py --against the tree before them), the host
    # routes (lane_walls.py --host)
    walls = {name: w["this tree"] for name, w in
             lane_walls.walls({"this tree": spt}, dev, RANGE_REPS).items()}
    host_walls = {name: w["this tree"] for name, w in lane_walls.walls(
        {"this tree": spt}, dev, RANGE_HOST_REPS, host=True).items()}

    def scale_work(a):
        """The host work that the row scales add to a walk."""
        s = walk_scales(a)
        np.ldexp(a, -s[:, None])
        return times_pow2(1.0, int(s.sum()))

    scales_ms = {}
    for n in (12, 18, 32):
        a = mat(n, n, 1.0).astype(np.float64)
        times = []
        for _ in range(RANGE_REPS):
            t = time.perf_counter()
            scale_work(a)
            times.append(time.perf_counter() - t)
        scales_ms[f"n={n}"] = statistics.median(times) * 1e3

    out = {"rows": rows, "walls": walls, "host_walls": host_walls,
           "scales_ms": scales_ms, "native": native, "launches": counts,
           "card": card, "phase_s": time.perf_counter() - t_phase}
    print("walk range: " + json.dumps(out))
    on_host = sum(r["route"] == "host" for r in rows)
    print(f"walk range: {len(rows)} rows held ({on_host} on the host by "
          f"design); host walls (ms) "
          f"{json.dumps({k: v['ms'] for k, v in host_walls.items()})}; "
          f"scales alone (ms) {json.dumps(scales_ms)}; {card}")
    return out


def mesh_cards_phase(dev, regs: dict) -> dict:
    """SUPerman's multi-GPU deployment (the benchmark's cell
    erdos_int_dense_mesh4.n38_mesh4): an n=38 d=0.50 df64 permanent dealt
    over the visible cards through permanent(perman_algo="multi",
    gpu_num=cards), or on one card ryser_exact over MESH_ENTRIES streams of
    it, bitwise against one device.  Prints each entry's block rows and
    walk ms (Result.meta["mesh_cards"]), the spread of the walk ms, the
    deal's three spans, both walls and the dealt call's block launches;
    the caller's current device must be unchanged.  First the walk's
    instantiation ryser_walk_kernel<40, 0, 1> (regs: registers by
    instantiation): on the card bit for bit against ryser_blocks_ref on
    a few block rows of the plan cut to chunks of 2^6 steps (the plain
    version pays per step), then timed on one card's share of the
    one-card plan (every MESH_ENTRIES-th block row, as the deal gives
    it), beside its bound.  Raises on failure; returns what it printed
    and the kernel's entry ("blocks")."""
    import torch
    import superman_tpu_torch as spt
    from superman_tpu_torch.core.flags import Flags
    from superman_tpu_torch.core.matrix import DenseMatrix
    from superman_tpu_torch.ops import gray, ryser_cuda
    from superman_tpu_torch.ops.ryser import (_center_scales, _row_scales,
                                              ryser_exact)
    from superman_tpu_torch.parallel.mesh import make_mesh
    from superman_tpu_torch.utils import trace

    a38 = random_int_matrix(np.random.default_rng(38), 38, 0.5)
    np.fill_diagonal(a38, np.random.default_rng(380).integers(1, 5, 38))

    # K1's <40, 0, 1> against its plain version (the row past the last
    # all sentinels), then one card's share
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = gray.make_plan(38, sms=sms)
    a_s = np.ldexp(a38.astype(np.float64),
                   -_center_scales(a38, _row_scales(a38))[:, None])
    x0, cols = (torch.as_tensor(v, device=dev)
                for v in gray.pack_matrix(a_s, plan.n_pad))
    short = gray.make_plan(38, chunk_log2=6)
    last = -(-short.num_chunks // short.lanes) - 1
    rows = torch.tensor([0, 1, last // 2, last, last + 1], device=dev)
    kern = ryser_cuda.ryser_blocks(
        rows, x0, cols, n=38, r=short.r, lanes=short.lanes,
        num_chunks=short.num_chunks, tier="df64")
    plain_ms, plain = cuda_ms(lambda: ryser_cuda.ryser_blocks_ref(
        rows, x0, cols, n=38, r=short.r, lanes=short.lanes,
        num_chunks=short.num_chunks, tier="df64"), 1)
    err = compare(kern, plain, None)
    if not torch.equal(kern, plain):
        raise AssertionError("ryser_walk_blocks df64 at n=38: kernel and "
                             "plain version differ")
    entries_k = MESH_ENTRIES if torch.cuda.device_count() < 2 \
        else torch.cuda.device_count()
    share = torch.arange(0, -(-plan.num_chunks // plan.lanes), entries_k,
                         device=dev)

    def run_share():
        return ryser_cuda.ryser_blocks(
            share, x0, cols, n=38, r=plan.r, lanes=plan.lanes,
            num_chunks=plan.num_chunks, tier="df64")

    run_share()                                           # warm-up
    share_ms, share_out = cuda_ms(run_share, 3)
    steps = share.numel() * plan.lanes << plan.r
    reg = regs.get(f"ryser_walk_kernel<{plan.n_pad},0,1>")
    blocks = {"ms": share_ms, "plain_ms": plain_ms, "err": err,
              "registers": reg,
              "bound": walk_bound(steps, 38, "df64",
                                  nbytes_of(share, x0, cols, share_out)),
              "plain_rows": rows.numel(), "plain_r": short.r,
              "share_rows": share.numel(), "r": plan.r,
              "lanes": plan.lanes}
    print(f"ryser_walk_blocks df64 n=38 (<{plan.n_pad},0,1>, {reg} "
          f"registers): bitwise its plain version on {rows.numel()} block "
          f"rows of 2^{short.r}-step chunks ({plain_ms:.1f} ms); one card's "
          f"share, {share.numel()} block rows of {plan.lanes} chunks of "
          f"2^{plan.r}: {share_ms:.3f} ms, bound {blocks['bound'][0]:.3f} ms")

    cards = torch.cuda.device_count()
    if cards > 1:
        entries, where = cards, f"{cards} cards"

        def dealt():
            return spt.permanent(a38, perman_algo="multi", gpu_num=cards)
    else:
        mesh = make_mesh(devices=[dev] * MESH_ENTRIES)
        entries, where = MESH_ENTRIES, f"{MESH_ENTRIES} streams of one card"

        def dealt():
            with trace.entry("mesh_phase") as spans:
                res = ryser_exact(DenseMatrix(a38, "int"),
                                  Flags(calc="df64"), dev, mesh=mesh)
            res.meta["spans"] = spans
            return res

    spt.permanent(a38, device=dev)                      # warm-up
    t = time.perf_counter()
    one = spt.permanent(a38, device=dev)
    one_s = time.perf_counter() - t
    dealt()                       # every card's context and library
    current = torch.cuda.current_device()
    LAUNCHES.clear()
    t = time.perf_counter()
    many = dealt()
    many_s = time.perf_counter() - t
    blocks["launches"] = launches("blocks", tier="df64")
    cards_meta = many.meta["mesh_cards"]
    rows_dealt = [c["rows"] for c in cards_meta]
    ms = [c["walk_ms"] for c in cards_meta]
    spans = {}
    for name, dt in many.meta["spans"]:
        spans[name] = spans.get(name, 0.0) + dt * 1e3
    spread = (max(ms) - min(ms)) / float(np.median(ms))
    out = {"where": where, "value": many.permanent, "one_device_s": one_s,
           "mesh_s": many_s, "rows": rows_dealt, "walk_ms": ms,
           "walk_ms_spread": spread, "block_launches": blocks["launches"],
           "spans_ms": {k: v for k, v in spans.items()
                        if k.startswith("mesh_")}}
    print(f"mesh phase, n=38 df64 over {where}: {json.dumps(out)}")
    plan_rows = -(-many.meta["chunks"] // many.meta["lanes"])
    if many.permanent != one.permanent or many.meta["mesh"] != entries \
            or len(cards_meta) != entries or sum(rows_dealt) != plan_rows \
            or blocks["launches"] != entries \
            or "walk" in spans or set(out["spans_ms"]) != {
                "mesh_launch", "mesh_wait", "mesh_gather"} \
            or torch.cuda.current_device() != current:
        raise AssertionError(f"mesh phase: {many.permanent!r} vs one device "
                             f"{one.permanent!r}, {out}, current device "
                             f"{torch.cuda.current_device()} (was "
                             f"{current})")
    out["blocks"] = blocks
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--mesh"]):
        print("usage: python3 chip_smoke.py [--mesh]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import superman_tpu_torch as spt
    from superman_tpu_torch.csrc import build
    from superman_tpu_torch.ops import (batch, exact, gray, modp, modp_cuda,
                                        oracle, pruning, ryser_cuda, tf96)
    from superman_tpu_torch.ops.ryser import (K1_GITERS, _center_scales,
                                              _row_scales, amp_cond_walk_log2,
                                              amp_walk_log2)
    from superman_tpu_torch.tools import sass_count

    def zero_counts():
        LAUNCHES.clear()

    # ---- 1. probe and build
    t_script = time.perf_counter()
    card = smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}")
    print(f"np.longdouble mantissa bits: {np.finfo(np.longdouble).nmant}; "
          f"a tf96 total keeps bits below a double: {tf96.LONGDOUBLE_WIDE}")
    t = time.perf_counter()
    path, report = build.build()
    build.load()
    print(f"build: {time.perf_counter() - t:.1f} s -> {path}")
    print(register_report(report))
    dev = torch.device("cuda", 0)
    # registers of every instantiation, from the library itself (cuobjdump
    # -res-usage), so a cached build, whose ptxas report is empty, has them
    regs = sass_count.registers(path)
    if argv == ["--mesh"]:
        mesh_cards_phase(dev, regs)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # ---- 2. K1 vs its plain version on the card, main-path shapes
    a32 = random_int_matrix(np.random.default_rng(SEED), 32, 0.5)
    plan = gray.make_plan(32, sms=sms)
    print(f"plan n=32: r={plan.r} chunks={plan.num_chunks} "
          f"n_pad={plan.n_pad} sms={sms}")
    a_s = np.ldexp(a32.astype(np.float64),
                   -_center_scales(a32, _row_scales(a32))[:, None])
    x0, cols = (torch.as_tensor(v, device=dev)
                for v in gray.pack_matrix(a_s, plan.n_pad))
    ids = torch.cat([torch.arange(2048), torch.full((128,), -1),
                     torch.arange(plan.num_chunks - 2048, plan.num_chunks)]
                    ).to(dev)
    k1_err = {}
    k1_sampled = {}
    for tier in TIERS:
        kern = ryser_cuda.ryser_partials(ids, x0, cols, n=32, r=plan.r,
                                         tier=tier)
        torch.cuda.synchronize()
        plain_ms, plain = cuda_ms(lambda: ryser_cuda.ryser_partials_ref(
            ids, x0, cols, n=32, r=plan.r, tier=tier), 1)
        print(f"ryser_walk_{tier} vs plain, {ids.numel()} chunk ids "
              f"(start, sentinels, end), plain {plain_ms:.1f} ms:")
        k1_err[tier] = compare(kern, plain, ids)
        k1_sampled[tier] = (kern, plain_ms)
    sampled_ids = ids

    # ---- 2b. the Z_p kernel vs its plain version, same plan and ids
    core, mult = exact._fold_lines(exact.dyadic_int_matrix(a32)[0])
    if mult != 1 or len(core) != 32:
        raise AssertionError(f"n=32 matrix folded: mult {mult}, "
                             f"core n={len(core)}")
    mod_err = 0
    for p in MOD_PRIMES:
        mx0, mcols = (t.to(dev) for t in modp.pack_mod(
            modp.reduce_core_mod(core, p), p, plan.n_pad))
        kern = modp_cuda.mod_partials(ids, mx0, mcols, p, n=32, r=plan.r)
        torch.cuda.synchronize()
        plain = modp_cuda.mod_partials_ref(ids, mx0, mcols, p, n=32,
                                           r=plan.r)
        mod_err = max(mod_err, compare_mod(kern, plain, ids, p))

    # ---- 2c. K2 at the serving shapes, per tier: the kernel's time by
    # CUDA events at both, and the kernel against its plain version (run
    # and timed once) on all of 256 x n=24 and on the first 2 matrices of
    # n=32, which the plan cuts into chunks of 2^15 steps: the plain
    # version pays per step, and 16 matrices walk chunks of 2^18
    stack_a, stack_b = batch_stacks()
    if not np.array_equal(stack_b[0], a32):
        raise AssertionError("the n=32 stack does not start with a32")
    k2 = {tier: {"err": 0.0} for tier in TIERS}
    for tag, stack, reps, check in (("n24", stack_a, 5, True),
                                    ("n32", stack_b, 1, False),
                                    ("n32_2", stack_b[:2], 3, True)):
        B, n = stack.shape[:2]
        r = gray.batch_plan(n, B, sms=sms)
        x0p, colsT, _, _ = batch.pack_stack(stack.astype(np.float64))
        bx0, bcols = torch.as_tensor(x0p).to(dev), torch.as_tensor(colsT).to(dev)
        for tier in TIERS:
            def run_batch():
                return ryser_cuda.batch_partials(bx0, bcols, n=n, r=r,
                                                 tier=tier)
            run_batch()                                   # warm-up
            ms, kern = cuda_ms(run_batch, reps)
            if tag == "n24":
                k2[tier]["clock"] = sm_clock(run_batch)
            steps = B << (n - 1)
            line = (f"ryser_batch {tier}, {B} x n={n}, "
                    f"{1 << (n - 1 - r)} chunks of 2^{r} a matrix, "
                    f"{kern.shape[1]} block pairs each: kernel {ms:.3f} ms "
                    f"({steps / ms / 1e6:.1f} G steps/s)")
            plain_ms = None
            if check:
                plain_ms, plain = cuda_ms(
                    lambda: ryser_cuda.batch_partials_ref(
                        bx0, bcols, n=n, r=r, tier=tier), 1)
                print(f"{line}, plain {plain_ms:.1f} ms")
                k2[tier]["err"] = max(k2[tier]["err"],
                                      compare(kern, plain, None))
            else:
                if not bool(torch.isfinite(kern).all()):
                    raise AssertionError(f"{line}: non-finite partials")
                print(line)
            k2[tier][tag] = (ms, plain_ms, walk_bound(
                steps, n, tier, nbytes_of(bx0, bcols, kern)))

    # ---- 2d. the weighted, block-reduced walk vs its plain version, per
    # tier, on the sparse path's own plan: the n=36 matrix as the planner
    # orders and cuts it at the tier's rate, the alive rows' and the
    # factored rows' packs as the engine scales them, the live list split
    # as the engine splits it; compared on its first 2,048 and last 1,983
    # ids around 64 sentinels (a ragged last block), block pair by block
    # pair, bit for bit
    a36 = sparse_int_matrix(36, 36, 0.15)
    sparse36 = {}
    for tier in TIERS:
        sp36 = pruning.plan_sparse(a36, giters=K1_GITERS[tier])
        if sp36 is None or not len(sp36.factor_rows):
            raise AssertionError(f"n=36 {tier}: the planner gave {sp36}")
        ap = np.ascontiguousarray(a36[:, sp36.col_perm]).astype(np.float64)
        ap_s = np.ldexp(ap, -_center_scales(ap, _row_scales(ap))[:, None])
        pack = [torch.as_tensor(v).to(dev).contiguous() for v in
                gray.pack_matrix(ap_s[sp36.alive_rows],
                                 gray.pad_n(len(sp36.alive_rows)))
                + gray.pack_matrix(ap_s[sp36.factor_rows],
                                   len(sp36.factor_rows))]
        ids_all, r_w = gray.split_chunks(
            torch.as_tensor(sp36.ids).to(dev), sp36.r,
            sms * gray.SPLIT_CHUNKS_PER_SM)
        cmp_ids = torch.cat([ids_all[:2048], ids_all.new_full((64,), -1),
                             ids_all[-1983:]])
        kern = ryser_cuda.ryser_reduced(cmp_ids, *pack, n=36, r=r_w,
                                        tier=tier)
        torch.cuda.synchronize()
        plain_ms, plain = cuda_ms(lambda: ryser_cuda.ryser_reduced_ref(
            cmp_ids, *pack, n=36, r=r_w, tier=tier), 1)
        print(f"ryser_walk_reduced {tier} vs plain, n=36: plan r={sp36.r}, "
              f"{len(sp36.ids)} live chunks of {1 << (35 - sp36.r)}, "
              f"{len(sp36.alive_rows)} alive and {len(sp36.factor_rows)} "
              f"factored rows, walked as {ids_all.numel()} chunks of "
              f"2^{r_w}; {cmp_ids.numel()} ids (start, sentinels, end) in "
              f"{kern.shape[0]} blocks, plain {plain_ms:.1f} ms:")
        err = compare(kern, plain, None)
        if not torch.equal(kern, plain):
            raise AssertionError(f"ryser_walk_reduced {tier}: kernel and "
                                 f"plain version differ")
        sparse36[tier] = {"sp": sp36, "pack": pack, "ids": ids_all,
                          "r": r_w, "err": err, "plain_ms": plain_ms,
                          "plain_chunks": int(cmp_ids.numel())}

    # ---- 2e. the amp tier, both variants (the amplitude alone, and with
    # the conditioned term) vs their plain versions on the sampled ids of
    # the n=32 plan, and their sums over a whole n=20 walk against the
    # exhaustive host formula
    amp_variants = {"amp": False, "cond": True}
    amp_sampled = {}
    for variant, cond in amp_variants.items():
        kern = ryser_cuda.ryser_amp(sampled_ids, x0, cols, n=32, r=plan.r,
                                    cond=cond)
        torch.cuda.synchronize()
        plain_ms, plain = cuda_ms(lambda: ryser_cuda.ryser_amp_ref(
            sampled_ids, x0, cols, n=32, r=plan.r, cond=cond), 1)
        print(f"ryser_walk_amp ({variant}) vs plain, {sampled_ids.numel()} "
              f"chunk ids (start, sentinels, end), plain {plain_ms:.1f} ms:")
        err = compare_amp(kern, plain, sampled_ids)
        if not torch.equal(kern, plain):
            raise AssertionError(f"ryser_walk_amp ({variant}): kernel and "
                                 f"plain version differ")
        amp_sampled[variant] = {"kern": kern, "err": err,
                                "plain_ms": plain_ms}
    if not torch.equal(amp_sampled["amp"]["kern"],
                       amp_sampled["cond"]["kern"][:, :2]):
        raise AssertionError("the two amp variants' amplitude words differ")
    rng20 = np.random.default_rng(20)
    a20 = (rng20.random((20, 20)) < 0.6) * rng20.random((20, 20)) * 5.0 - 0.5
    amp20, cond20 = amp_cond_walk_log2(a20, dev)
    amp20_only = amp_walk_log2(a20, dev)
    host_amp20, host_cond20 = amp_host_log2(a20)
    print(f"amp walk n=20 (real-valued): log2 amp {amp20:.9f} (amplitude "
          f"alone {amp20_only:.9f}) vs the exhaustive host sum "
          f"{host_amp20:.9f}; log2 cond {cond20:.4f} vs the host formula "
          f"{host_cond20:.4f} (band -1 .. +2: the kernel weights rows by "
          f"their power-of-two scales, the host by S_i)")
    if not (abs(amp20 - host_amp20) <= 1e-9 and amp20_only == amp20
            and host_cond20 - 1.0 <= cond20 <= host_cond20 + 2.0):
        raise AssertionError("amp walk n=20 disagrees with the host formula")

    # ---- 3. the single-matrix paths: df64, then f32 and f32k
    small = []
    for n in (20, 24):
        a = random_int_matrix(np.random.default_rng(n), n, 0.5)
        small.append((n, a, float(oracle.perman64(a, dtype=np.longdouble))))
    zero_counts()
    spt.permanent(a32, calc="df64")                       # warm-up
    best = min((spt.permanent(a32, calc="df64") for _ in range(3)),
               key=lambda res: res.time)
    rel = rel_err(best.permanent, PINNED_N32)
    rel_exact = rel_err(best.permanent, EXACT_N32)
    print(f"main path n=32 df64: {best.permanent!r} in {best.time:.4f} s "
          f"(best of 3), {best.iterations / best.time / 1e9:.2f} G Gray "
          f"iters/s, rel err {rel:.3e} vs pinned {PINNED_N32!r}, "
          f"{rel_exact:.3e} vs the exact integer; {best.algo_name} "
          f"r={best.meta['r']} chunks={best.meta['chunks']}")
    if best.algo_name != "ryser_cuda_df64" or not rel <= MAIN_TOL:
        raise AssertionError(f"n=32: {best.algo_name} rel {rel:.3e}")
    k1_launches = {"df64": k1_count()}
    k1_blocks = {"df64": launches("blocks", tier="df64")}
    zero_counts()
    for n, a, want in small:
        res = spt.permanent(a, calc="df64")
        rel_n = rel_err(res.permanent, want)
        print(f"main path n={n} df64: {res.permanent!r} vs long-double "
              f"oracle {want!r}: rel err {rel_n:.3e}")
        if res.algo_name != "ryser_cuda_df64" or not rel_n <= SMALL_TOL:
            raise AssertionError(f"n={n}: {res.algo_name} rel {rel_n:.3e}")
    print(f"ryser_walk_df64 launches: {k1_launches['df64']} on the n=32 "
          f"path (4 calls), {k1_count()} on the n=20 and n=24 path "
          f"(2 calls)")
    if k1_count() <= 0:
        raise AssertionError("the n=20 and n=24 path did not launch K1")
    tier_vals = {"df64": best.permanent}
    for tier, tol in (("f32", F32_TOL), ("f32k", F32K_TOL),
                      ("tf96", TF96_TOL)):
        zero_counts()
        spt.permanent(a32, calc=tier)                     # warm-up
        res = min((spt.permanent(a32, calc=tier) for _ in range(3)),
                  key=lambda res: res.time)
        k1_launches[tier] = k1_count()
        k1_blocks[tier] = launches("blocks", tier=tier)
        rel_t = rel_err(res.permanent, EXACT_N32)
        print(f"main path n=32 {tier}: {res.permanent!r} in {res.time:.4f} s "
              f"(best of 3), rel err {rel_t:.3e} vs the exact integer "
              f"(limit {tol:.0e}); {res.algo_name}, "
              f"{k1_launches[tier]} launches; spans "
              f"{ {k: round(v * 1e3, 2) for k, v in res.meta['spans']} }")
        if res.algo_name != f"ryser_cuda_{tier}" or not rel_t <= tol:
            raise AssertionError(f"n=32 {tier}: {res.algo_name} "
                                 f"rel {rel_t:.3e}")
        tier_vals[tier] = res.permanent
    if min(k1_launches.values()) <= 0:
        raise AssertionError(f"a tier's path did not launch K1: {k1_launches}")
    # the totals go through the block-reduced entry alone; tf96 keeps its
    # per-chunk words
    print(f"n=32 path, K1 launches of the block-reduced entry (4 calls a "
          f"tier): {k1_blocks}")
    if k1_blocks != {t: k1_launches[t] if t in BLOCK_TIERS else 0
                     for t in TIERS}:
        raise AssertionError(f"n=32 path: block-reduced launches "
                             f"{k1_blocks} of the K1 launches {k1_launches}")

    # ---- 3a. the high-precision tier where df64 is weakest, and Glynn
    # per(J_n) = n!: all-ones matrices cancel hardest
    for n in (24, 32):
        ones = np.ones((n, n), dtype=np.int64)
        errs = {}
        for tier in ("df64", "tf96"):
            res = spt.permanent(ones, calc=tier)
            if res.algo_name != f"ryser_cuda_{tier}":
                raise AssertionError(f"all-ones n={n}: {res.algo_name}")
            errs[tier] = rel_err(res.permanent, math.factorial(n))
        print(f"all-ones n={n} vs {n}!: df64 rel err {errs['df64']:.3e}, "
              f"tf96 {errs['tf96']:.3e} (limit {ONES_TOL[n]:.0e})")
        if not errs["tf96"] <= ONES_TOL[n]:
            raise AssertionError(f"all-ones n={n} tf96: {errs['tf96']:.3e}")
    # the second formula through the same kernel: its own packing, scales
    # and host code
    glynn_launches = {}
    glynn_blocks = {}
    for tier, tol in (("df64", MAIN_TOL), ("tf96", TF96_TOL)):
        zero_counts()
        res = min((spt.permanent(a32, perman_algo="glynn", calc=tier)
                   for _ in range(2)), key=lambda res: res.time)
        glynn_launches[tier] = k1_count()
        glynn_blocks[tier] = launches("blocks", tier=tier)
        rel_g = rel_err(res.permanent, EXACT_N32)
        vs_ryser = rel_err(res.permanent, tier_vals[tier])
        print(f"Glynn n=32 {tier}: {res.permanent!r} in {res.time:.4f} s "
              f"(best of 2), rel err {rel_g:.3e} vs the exact integer "
              f"(limit {tol:.0e}), {vs_ryser:.3e} vs Ryser {tier}; "
              f"{res.algo_name}, {glynn_launches[tier]} launches")
        if res.algo_name != f"glynn_cuda_{tier}" or not rel_g <= tol \
                or not vs_ryser <= 2 * tol or glynn_launches[tier] <= 0:
            raise AssertionError(f"Glynn n=32 {tier}: {res.algo_name} rel "
                                 f"{rel_g:.3e}, vs Ryser {vs_ryser:.3e}, "
                                 f"{glynn_launches[tier]} launches")

    # ---- 3b. the exact path
    zero_counts()
    ex = []
    for _ in range(3):
        t = time.perf_counter()
        res = spt.permanent(a32, calc="exact")
        ex.append((time.perf_counter() - t, res))
    mod_launches = launches("modp")
    exact_s, res = min(ex, key=lambda e: e[0])
    meta = res.meta["exact"]
    print(f"exact path n=32: {res.meta['exact_fraction']} in {exact_s:.4f} s "
          f"(best of 3: {', '.join(f'{e[0]:.4f}' for e in ex)}); {meta}; "
          f"modp_walk launches {mod_launches}")
    for _, r_ in ex:
        if r_.meta["exact_fraction"] != EXACT_N32:
            raise AssertionError(f"exact path: {r_.meta['exact_fraction']} "
                                 f"!= {EXACT_N32}")
    if meta["engine"] != "cuda_mod" or mod_launches <= 0:
        raise AssertionError(f"exact path: engine {meta['engine']}, "
                             f"{mod_launches} modp_walk launches")
    rel_df = rel_err(best.permanent, EXACT_N32)
    print(f"df64 n=32 vs the exact path's integer: rel err {rel_df:.3e}")
    if not rel_df <= MAIN_TOL:
        raise AssertionError(f"df64 vs exact: rel {rel_df:.3e}")
    nw = modp.perman_core_mod(core, GLYNN_PRIME, dev)
    gl = modp.perman_core_glynn_mod(core, GLYNN_PRIME, dev)
    print(f"p={GLYNN_PRIME}: Nijenhuis-Wilf {nw}, Glynn {gl}, exact "
          f"integer mod p {EXACT_N32 % GLYNN_PRIME}")
    if not nw == gl == EXACT_N32 % GLYNN_PRIME:
        raise AssertionError("Glynn and Nijenhuis-Wilf residues disagree")

    # ---- 3c. the serving batch: permanent_batch per tier
    def run_batch_path(mats, calc):
        """permanent_batch on `mats`, every result from the batch kernel;
        returns (values, best wall seconds of 3, the last run's spans in
        ms)."""
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            out = spt.permanent_batch(list(mats), calc=calc)
            walls.append(time.perf_counter() - t)
        for res in out:
            if res.algo_name != f"ryser_cuda_batch_{calc}" or \
                    res.iterations != 1 << (len(mats[0]) - 1):
                raise AssertionError(f"batch {calc}: {res.algo_name}, "
                                     f"{res.iterations} iterations")
        vals = np.array([res.permanent for res in out])
        if not np.isfinite(vals).all():
            raise AssertionError(f"batch {calc}: non-finite values")
        spans = {k: round(v * 1e3, 2) for k, v in out[0].meta["spans"]}
        return vals, min(walls), spans

    k2_paths = {}
    zero_counts()
    vals_a, wall_a, spans = run_batch_path(stack_a, "df64")
    k2_paths["256 x n=24 df64, 3 calls"] = launches("batch")
    print(f"batch path 256 x n=24 df64: {wall_a * 1e3:.2f} ms wall (best of "
          f"3), {256 / wall_a:.0f} matrices/s; spans of the last run {spans}")
    zero_counts()
    vals_b, wall_b, _ = run_batch_path(stack_b, "df64")
    k2_paths["16 x n=32 df64, 3 calls"] = launches("batch")
    rel_b = rel_err(vals_b[0], EXACT_N32)
    print(f"batch path 16 x n=32 df64: {wall_b * 1e3:.2f} ms wall; matrix 0 "
          f"{float(vals_b[0])!r}, rel err {rel_b:.3e} vs the exact integer")
    if not rel_b <= MAIN_TOL:
        raise AssertionError(f"batch n=32 matrix 0: rel {rel_b:.3e}")
    mixed = mixed_list()
    zero_counts()
    out_c = spt.permanent_batch([m for _, m in mixed])
    groups_c = len({m.shape[0] for _, m in mixed if m.shape[0] >= 13})
    k2_paths[f"mixed list df64, 1 call, {groups_c} order groups from "
             f"n=13"] = launches("batch")
    if launches("batch") != groups_c:
        raise AssertionError(f"mixed list: {launches('batch')} "
                             f"launches for {groups_c} order groups")
    # the kernels line reports the path its times are taken at
    k2_launches = {"df64": k2_paths["256 x n=24 df64, 3 calls"]}
    worst = {"exact": 0.0, "oracle": 0.0}
    for (kind, m), res in zip(mixed, out_c):
        n = m.shape[0]
        want_name = "ryser_cuda_batch_df64" if n >= 13 else "ryser_walk_batch"
        if res.algo_name != want_name or res.iterations != 1 << (n - 1):
            raise AssertionError(f"mixed n={n}: {res.algo_name}")
        if kind == "empty":
            if res.permanent != 0.0:
                raise AssertionError(f"empty row: {res.permanent!r}")
            continue
        if kind == "int" and n >= 20:
            want = spt.permanent(m, calc="exact").meta["exact_fraction"]
            worst["exact"] = max(worst["exact"], rel_err(res.permanent, want))
        if n <= 24:
            want = float(oracle.perman64(m, dtype=np.longdouble))
            worst["oracle"] = max(worst["oracle"],
                                  rel_err(res.permanent, want))
    print(f"batch path, mixed list of {len(mixed)} (n=8..32, one real, one "
          f"empty row): worst rel err {worst['exact']:.3e} vs the exact "
          f"integers (n >= 20), {worst['oracle']:.3e} vs the long-double "
          f"oracle (n <= 24)")
    if not (worst["exact"] <= MAIN_TOL and worst["oracle"] <= SMALL_TOL):
        raise AssertionError(f"mixed list: {worst}")
    # batched against one by one (K1 launches; the counts are read above)
    t = time.perf_counter()
    single_a = np.array([spt.permanent(m, calc="df64").permanent
                         for m in stack_a])
    wall_single = time.perf_counter() - t
    singles = [(vals_a, single_a)]
    singles.append((vals_b, np.array([spt.permanent(m, calc="df64").permanent
                                      for m in stack_b])))
    big = [(res.permanent, m) for (kind, m), res in zip(mixed, out_c)
           if kind != "empty" and m.shape[0] >= 19]
    singles.append((np.array([v for v, _ in big]),
                    np.array([spt.permanent(m, calc="df64").permanent
                              for _, m in big])))
    vs_single = max(float(np.max(np.abs(got - one) / np.abs(one)))
                    for got, one in singles)
    print(f"the same 256 one by one through permanent(): "
          f"{wall_single * 1e3:.1f} ms wall, {256 / wall_single:.0f} "
          f"matrices/s ({wall_single / wall_a:.1f}x the batch); batched vs "
          f"one by one, n >= 19: worst rel diff {vs_single:.3e}")
    if not vs_single <= BATCH_VS_SINGLE_TOL:
        raise AssertionError(f"batched vs one by one: {vs_single:.3e}")
    tier_err = {}
    for tier, tol in (("f32", F32_TOL), ("f32k", F32K_TOL)):
        zero_counts()
        vals_t, wall_t, _ = run_batch_path(stack_a, tier)
        k2_launches[tier] = launches("batch")
        k2_paths[f"256 x n=24 {tier}, 3 calls"] = launches("batch")
        tier_err[tier] = float(np.max(np.abs(vals_t - vals_a)
                                      / np.abs(vals_a)))
        print(f"batch path 256 x n=24 {tier}: {wall_t * 1e3:.2f} ms wall, "
              f"worst rel err {tier_err[tier]:.3e} vs df64 (limit {tol:.0e})")
        if not tier_err[tier] <= tol:
            raise AssertionError(f"batch {tier}: {tier_err[tier]:.3e}")
    zero_counts()
    vals_t, wall_t, _ = run_batch_path(stack_a, "tf96")
    k2_launches["tf96"] = launches("batch")
    k2_paths["256 x n=24 tf96, 3 calls"] = launches("batch")
    exact_a = [spt.permanent(m, calc="exact").meta["exact_fraction"]
               for m in stack_a[:8]]
    tier_err["tf96"] = max(rel_err(v, want)
                           for v, want in zip(vals_t, exact_a))
    df_err = max(rel_err(v, want) for v, want in zip(vals_a, exact_a))
    print(f"batch path 256 x n=24 tf96: {wall_t * 1e3:.2f} ms wall, "
          f"{256 / wall_t:.0f} matrices/s; worst rel err vs the exact "
          f"integers of the first 8: {tier_err['tf96']:.3e} (limit "
          f"{TF96_TOL:.0e}; df64 on the same 8: {df_err:.3e})")
    if not tier_err["tf96"] <= TF96_TOL:
        raise AssertionError(f"batch tf96: {tier_err['tf96']:.3e}")
    print(f"ryser_batch launches, path by path: {k2_paths}")
    if min(k2_paths.values()) <= 0:
        raise AssertionError(f"a batch path did not launch K2: {k2_paths}")

    # ---- 3d. the sparse engine: permanent() engages the pruned, factored
    # walk by itself on a clearly sparse matrix
    t = time.perf_counter()
    exact36 = spt.permanent(a36, calc="exact").meta["exact_fraction"]
    print(f"sparse path n=36 (seed 36, density 0.15): exact integer "
          f"{exact36} in {time.perf_counter() - t:.3f} s")
    reduced_launches = {}
    for tier in TIERS:
        zero_counts()
        spt.permanent(a36, calc=tier)                     # warm-up
        res = min((spt.permanent(a36, calc=tier) for _ in range(3)),
                  key=lambda res: res.time)
        reduced_launches[tier] = launches("reduced", tier=tier)
        rel_s = rel_err(res.permanent, exact36)
        sp36 = sparse36[tier]["sp"]
        want_meta = {"dead_frac": round(sp36.dead_frac, 4),
                     "factored_rows": len(sp36.factor_rows), "r": sp36.r}
        line = (f"sparse path n=36 {tier}: {res.permanent!r} in "
                f"{res.time:.4f} s (best of 3), rel err {rel_s:.3e} vs the "
                f"exact integer (limit {SPARSE_TOL[tier]:.0e}); "
                f"{res.algo_name}, {res.meta['chunks']} live chunks of "
                f"2^{res.meta['r']} cut 2^{res.meta['split_log2']} ways, "
                f"sparse {res.meta.get('sparse')}, spans "
                f"{ {k: round(v * 1e3, 2) for k, v in res.meta['spans']} }, "
                f"{reduced_launches[tier]} reduced launches (4 calls), "
                f"{k1_count()} dense")
        if res.algo_name != f"ryser_cuda_{tier}" \
                or res.meta.get("sparse") != want_meta \
                or res.meta["chunks"] != len(sp36.ids) \
                or reduced_launches[tier] != 4 or k1_count() != 0 \
                or not rel_s <= SPARSE_TOL[tier]:
            raise AssertionError(line)
        if tier in ("df64", "tf96"):
            dense = spt.permanent(a36, calc=tier, skip_pruning=False)
            rel_d = rel_err(dense.permanent, exact36)
            vs_dense = rel_err(res.permanent, dense.permanent)
            line += (f"; unpruned {dense.permanent!r} in {dense.time:.4f} s "
                     f"({dense.time / res.time:.1f}x), rel err {rel_d:.3e}, "
                     f"pruned vs unpruned {vs_dense:.3e}")
            if "sparse" in dense.meta or k1_count() <= 0 \
                    or not rel_d <= SPARSE_TOL[tier] \
                    or not vs_dense <= 2 * SPARSE_TOL[tier]:
                raise AssertionError(line)
        print(line)
    pinned36 = {"df64": (16, 65098, 0.8758), "tf96": (16, 65098, 0.8758)}
    for tier, want in pinned36.items():
        sp36 = sparse36[tier]["sp"]
        got = (sp36.r, len(sp36.ids), round(sp36.dead_frac, 4))
        if got != want or len(sp36.factor_rows) != 4:
            raise AssertionError(f"n=36 {tier} plan {got}, pinned {want}")
    a40 = sparse_int_matrix(40, 40, 0.10)
    vals40 = {}
    for tier in ("df64", "tf96"):
        zero_counts()
        res = min((spt.permanent(a40, calc=tier) for _ in range(2)),
                  key=lambda res: res.time)
        vals40[tier] = res.permanent
        print(f"sparse path n=40 (seed 40, density 0.10) {tier}: "
              f"{res.permanent!r} in {res.time:.4f} s (best of 2); "
              f"{res.meta['chunks']} live chunks of 2^{res.meta['r']} cut "
              f"2^{res.meta['split_log2']} ways, sparse "
              f"{res.meta.get('sparse')}, "
              f"{launches('reduced', tier=tier)} reduced launches")
        if res.meta.get("sparse", {}).get("factored_rows") != 8 \
                or launches("reduced", tier=tier) != 2:
            raise AssertionError(f"n=40 {tier}: {res.meta}")
    rel40 = rel_err(vals40["df64"], vals40["tf96"])
    print(f"sparse path n=40: df64 vs tf96 rel diff {rel40:.3e} (limit "
          f"{SPARSE_TOL['df64']:.0e})")
    if not rel40 <= SPARSE_TOL["df64"]:
        raise AssertionError(f"n=40 df64 vs tf96: {rel40:.3e}")

    # ---- 3e. calc="auto": the ladder
    # (a) a benign matrix: the probe alone clears the target
    zero_counts()
    res = spt.permanent(a32, calc="auto")
    rel_a = rel_err(res.permanent, EXACT_N32)
    print(f"auto n=32: {res.permanent!r} in {res.time:.4f} s, rel err "
          f"{rel_a:.3e}; {res.algo_name}, auto {res.meta['auto']}, "
          f"{k1_count()} K1 launches, {launches('amp', 'amp_cond')} amp")
    if res.meta["auto"].get("probe_only") is not True \
            or res.algo_name != "ryser_cuda_df64" or k1_count() != 1 \
            or launches("amp", "amp_cond") != 0 or not rel_a <= MAIN_TOL:
        raise AssertionError("auto n=32: not the probe-only df64 result")
    # (b) an impossible target: f32k companion, the amp walk over all 2^31
    # indices, then the exact rung, or with no exact budget tf96, flagged
    # (the matrix is integer: the amp walk takes the amplitude alone)
    def amp_counts():
        return {"amp": launches("amp"),
                "cond": launches("amp_cond")}

    zero_counts()
    t = time.perf_counter()
    res = spt.permanent(a32, calc="auto", auto_target=1e-30)
    wall_b = time.perf_counter() - t
    amp_launches = amp_counts()
    print(f"auto n=32, auto_target=1e-30: {res.meta['exact_fraction']} in "
          f"{wall_b:.4f} s; {res.algo_name}, auto {res.meta['auto']}, "
          f"{k1_count()} K1 launches, amp walk launches "
          f"{amp_launches}, {launches('modp')} modp_walk")
    if res.meta["auto"]["escalated"] != "exact" \
            or res.meta["exact_fraction"] != EXACT_N32 \
            or k1_count() != 2 \
            or amp_launches != {"amp": 1, "cond": 0} \
            or launches("modp") <= 0:
        raise AssertionError("auto n=32, impossible target: not the exact "
                             "rung")
    zero_counts()
    t = time.perf_counter()
    res = spt.permanent(a32, calc="auto", auto_target=1e-30,
                        auto_exact_budget_s=0.0)
    wall_b0 = time.perf_counter() - t
    rel_b0 = rel_err(res.permanent, EXACT_N32)
    print(f"auto n=32, auto_target=1e-30, no exact budget: "
          f"{res.permanent!r} in {wall_b0:.4f} s, rel err {rel_b0:.3e} "
          f"(limit {TF96_TOL:.0e}); {res.algo_name}, auto "
          f"{res.meta['auto']}, {k1_count()} K1 launches, amp walk "
          f"launches {amp_counts()}")
    if res.meta["auto"]["escalated"] != "tf96" \
            or res.meta["auto"].get("low_confidence") is not True \
            or "amp_walk_l2" not in res.meta["auto"] \
            or k1_count() != 3 \
            or amp_counts() != {"amp": 1, "cond": 0} \
            or launches("modp") != 0 or not rel_b0 <= TF96_TOL:
        raise AssertionError("auto n=32, no exact budget: not the flagged "
                             "tf96 rung")
    walls = {}
    for name, fn in (("amp_walk_log2", amp_walk_log2),
                     ("amp_cond_walk_log2", amp_cond_walk_log2)):
        t = time.perf_counter()
        aw32 = fn(a32.astype(np.float64), dev)
        walls[name] = (time.perf_counter() - t, aw32)
    if walls["amp_walk_log2"][1] != walls["amp_cond_walk_log2"][1][0]:
        raise AssertionError("n=32: the two amp walks' log2 amp differ")
    print(f"amp walk n=32, 2^31 indices: log2 amp "
          f"{walls['amp_walk_log2'][1]:.4f} (amp_walk_l2 "
          f"{res.meta['auto']['amp_walk_l2']} above the permanent's log2); "
          f"wall {walls['amp_walk_log2'][0]:.4f} s amplitude alone, "
          f"{walls['amp_cond_walk_log2'][0]:.4f} s with the conditioned "
          f"term (log2 cond {walls['amp_cond_walk_log2'][1][1]:.4f})")
    # (c) a real-valued matrix whose lines cross zero mid-walk: no float
    # tier above df64 exists for it, and without an exact budget the
    # flagged bound must cover the true error
    land = within_line_landmine(np.random.default_rng(24), 24)
    truth = spt.permanent(land, calc="exact").meta["exact_fraction"]
    zero_counts()
    res = spt.permanent(land, calc="auto", auto_exact_budget_s=0.0)
    am = res.meta["auto"]
    rel_c = rel_err(res.permanent, truth)
    print(f"auto n=24, within-line landmine, no exact budget: "
          f"{res.permanent!r} vs the exact rational {float(truth)!r}: true "
          f"rel err {rel_c:.3e}, err_est {am['err_est']:.3e}; "
          f"{res.algo_name}, auto {am}, {k1_count()} K1 launches, "
          f"amp walk launches {amp_counts()}")
    if am["escalated"] is not None or am.get("ladder") != "df64_max" \
            or am.get("low_confidence") is not True \
            or "cond_walk_l2" not in am \
            or amp_counts() != {"amp": 0, "cond": 1} \
            or not 4.0 * float(am["err_est"]) >= rel_c:
        raise AssertionError("auto on the landmine matrix: the flagged df64 "
                             "bound does not hold")
    amp_launches["cond"] = amp_counts()["cond"]

    # ---- 3f. tf96 where the chunk partials stand far above the
    # permanent: the host sum of their words has to keep what they cancel
    canc, canc_base = cancelling_matrix(SEED, 32, plan.r)
    exact_c = spt.permanent(canc, calc="exact").meta["exact_fraction"]
    if spt.permanent(canc_base, calc="exact").meta["exact_fraction"] \
            != exact_c:
        raise AssertionError("the cancelling matrix changed the permanent")
    cs = _center_scales(canc, _row_scales(canc))
    cx0, ccols = (torch.as_tensor(v, device=dev) for v in gray.pack_matrix(
        np.ldexp(canc.astype(np.float64), -cs[:, None]), plan.n_pad))
    words = ryser_cuda.ryser_partials(
        torch.arange(plan.num_chunks, device=dev), cx0, ccols, n=32,
        r=plan.r, tier="tf96").cpu().numpy()
    t = time.perf_counter()
    total = tf96.sum_words(words)
    sum_ms = (time.perf_counter() - t) * 1e3
    ratio = float(np.abs(words.sum(axis=1)).sum() / abs(float(total)))
    # what a long-double sum of the same words (the reference's host
    # reduction) would return
    t = time.perf_counter()
    ld = words.astype(np.longdouble).sum()
    ld_ms = (time.perf_counter() - t) * 1e3
    ld = -2 * np.ldexp(ld, int(cs.sum()))
    zero_counts()
    res = spt.permanent(canc, calc="tf96")
    rel_t = rel_err(res.permanent, exact_c)
    print(f"tf96 n=32, partials {ratio:.3e} times the permanent "
          f"({CANCEL_PAIRS} row pairs of +-{CANCEL_C}): {res.permanent!r} vs "
          f"the exact integer {exact_c}: rel err {rel_t:.3e} (limit "
          f"{TF96_TOL:.0e}); a long-double sum of the same words: "
          f"{rel_err(float(ld), exact_c):.3e}; host sum of the "
          f"{words.shape[0]} pairs {sum_ms:.2f} ms (long double "
          f"{ld_ms:.2f}); {res.algo_name}, {k1_count()} launches")
    if not ratio >= 1e6 or res.algo_name != "ryser_cuda_tf96" \
            or k1_count() <= 0 or not rel_t <= TF96_TOL:
        raise AssertionError("tf96 on the cancelling matrix")

    # ---- 3g. the transform drivers.  Each hands a folded, scaled, pruned
    # or padded matrix to the engine, which walks it on K1 (dense, or the
    # reduced entry where the sparse gate engages); compression and scaling
    # end in the sanity net, whose certification walks K3 where the exact
    # engine's price on the card fits runner.CERT_BUDGET_S
    from superman_tpu_torch.drivers import runner
    from superman_tpu_torch.prep.dulmage_mendelsohn import dm_prune
    driver_launches = {"k1": {}, "blocks": {}, "reduced": {}, "modp": {}}
    walls = {}

    def driver_path(tag, fn):
        """fn() on a path of its own: the launches of K1 (df64), its
        reduced entry (df64) and K3 in it, the orders of the matrices the
        engine received (runner.run_algo, recorded around the call) and
        the wall."""
        orders, real = [], runner.run_algo

        def recorded(dense, flags, device):
            orders.append(int(dense.mat.shape[0]))
            return real(dense, flags, device)

        zero_counts()
        runner.run_algo = recorded
        try:
            t = time.perf_counter()
            res = fn()
            walls[tag] = time.perf_counter() - t
        finally:
            runner.run_algo = real
        if not orders:
            raise AssertionError(f"{tag}: runner.run_algo recorded no "
                                 f"matrix; the drivers no longer reach it "
                                 f"through the module attribute")
        got = {"k1": k1_count(),
               "blocks": launches("blocks", tier="df64"),
               "reduced": launches("reduced", tier="df64"),
               "modp": launches("modp")}
        for k, v in got.items():
            driver_launches[k][tag] = v
        cert = {k: res.meta[k] for k in ("exact_certified_rel",
                                         "compression_bailout", "scaled",
                                         "compression_suspect")
                if k in res.meta}
        print(f"{tag}: {res.permanent!r} in {walls[tag]:.4f} s; "
              f"{res.algo_name}, meta {cert}; orders walked "
              f"{sorted(set(orders))} ({len(orders)} matrices); launches "
              f"K1 {got['k1']}, reduced {got['reduced']}, K3 {got['modp']}")
        return res, orders, got

    def check_driver(tag, res, want, orders, got, certified):
        """Raises past DRIVER_TOL, where a value the sanity net replaced
        was further than PIPELINE_TOL from the exact one, where an order
        >= 19 was walked without K1, or where the sanity net should have
        certified (certified is True) or did certify or replace the value
        without K3."""
        rel_d = rel_err(res.permanent, want)
        replaced = res.meta.get("replaced")
        rel_p = rel_err(replaced["value"], want) if replaced else 0.0
        print(f"  rel err {rel_d:.3e} vs the exact value (limit "
              f"{DRIVER_TOL:.0e})" + (
                  f"; the pipeline's value {replaced['value']!r} "
                  f"({replaced['algo']}) was {rel_p:.3e} off (limit "
                  f"{PIPELINE_TOL:.0e}) and was replaced" if replaced
                  else ""))
        walked = got["k1"] + got["reduced"]
        did = ("exact_certified_rel" in res.meta
               or res.meta.get("compression_bailout") == "exact_crt")
        if not rel_d <= DRIVER_TOL or not rel_p <= PIPELINE_TOL \
                or (max(orders) >= 19 and walked <= 0) \
                or (certified and not did) or (did and got["modp"] <= 0):
            raise AssertionError(f"{tag}: rel {rel_d:.3e}, orders {orders}, "
                                 f"launches {got}, meta {res.meta}")

    # compression on the sparse matrices of phase 3d: d1/d2 folds, then
    # d34 splits down to the compression floor (order 30)
    t = time.perf_counter()
    exact40 = spt.permanent(a40, calc="exact").meta["exact_fraction"]
    print(f"sparse n=40 (seed 40, density 0.10): exact integer {exact40} in "
          f"{time.perf_counter() - t:.3f} s")
    for tag, a, want in (("compression n=36", a36, exact36),
                         ("compression n=40", a40, exact40)):
        res, orders, got = driver_path(
            tag, lambda: spt.permanent(a, compression=True))
        check_driver(tag, res, want, orders, got, certified=False)

    # Sinkhorn scaling of the n=32 main-path matrix: a real-valued walk,
    # certified by the exact engine
    res, orders, got = driver_path(
        "scaling n=32", lambda: spt.permanent(a32, scaling_threshold=1.0))
    check_driver("scaling n=32", res, EXACT_N32, orders, got, certified=True)
    if res.meta.get("scaled") is not True or got["k1"] <= 0:
        raise AssertionError(f"scaling n=32: {res.meta}, launches {got}")

    # Dulmage-Mendelsohn pruning: the filled off-diagonal block goes
    dm_a, dm_b1, dm_b2 = block_triangular(36, 36)
    t = time.perf_counter()
    exact_dm = spt.permanent(dm_a, calc="exact").meta["exact_fraction"]
    exact_dm_s = time.perf_counter() - t
    blocks = (spt.permanent(dm_b1, calc="exact").meta["exact_fraction"]
              * spt.permanent(dm_b2, calc="exact").meta["exact_fraction"])
    pruned = dm_prune(dm_a)
    print(f"dm_prune n=36 (block-triangular, seed 36): exact {exact_dm} in "
          f"{exact_dm_s:.3f} s, = per(b1) per(b2): {exact_dm == blocks}; "
          f"{int((dm_a != 0).sum())} nonzeros, {int((pruned != 0).sum())} "
          f"after pruning")
    if exact_dm != blocks or np.any(pruned[:18, 18:]):
        raise AssertionError("dm_prune n=36: the off-diagonal block stayed "
                             "or the exact values disagree")
    res, orders, got = driver_path(
        "dm_prune n=36", lambda: spt.permanent(dm_a, dm_prune=True))
    check_driver("dm_prune n=36", res, exact_dm, orders, got, certified=False)
    dm_zero = dm_a.copy()
    dm_zero[:2] = 0
    dm_zero[0, 5] = dm_zero[1, 5] = 1            # two rows, one column
    res = spt.permanent(dm_zero, dm_prune=True)
    print(f"dm_prune n=36, two rows on one column: {res.permanent!r}, "
          f"{res.algo_name}")
    if res.permanent != 0.0 or res.algo_name != "dm_structural_zero":
        raise AssertionError("dm_prune: the structural zero was missed")

    # rectangular: 24 x 32 padded with 8 rows of ones, the (n-m)! divided
    # out; then the same flags on a square matrix
    rrng = np.random.default_rng(2432)
    rect = (rrng.random((24, 32)) < 0.5) * rrng.integers(1, 5, (24, 32))
    ex_r = spt.permanent(rect, rectangular=True, calc="exact")
    want_r = Fraction(ex_r.meta["exact_fraction"], math.factorial(8))
    res, orders, got = driver_path(
        "rectangular 24x32", lambda: spt.permanent(rect, rectangular=True))
    check_driver("rectangular 24x32", res, want_r, orders, got,
                 certified=False)
    sq = spt.permanent(a32, rectangular=True)
    rel_sq = rel_err(sq.permanent, EXACT_N32)
    print(f"  exact path, rectangular: {ex_r.permanent!r} (rel "
          f"{rel_err(ex_r.permanent, want_r):.3e}); the same flags on the "
          f"n=32 square matrix: rel err {rel_sq:.3e}, meta "
          f"{ {k: sq.meta[k] for k in sq.meta if k != 'spans'} }")
    if res.meta.get("rect_shape") != [24, 32] or got["k1"] <= 0 \
            or "rect_shape" in sq.meta or not rel_sq <= MAIN_TOL:
        raise AssertionError("rectangular: wrong shape, no walk, or the "
                             "square matrix was divided")

    # ---- 3h. the estimators at the Flags default of 100000 trials: each
    # within EST_SIGMAS of its own stderr of the exact value
    erng = np.random.default_rng(320)
    bin32 = (erng.random((32, 32)) < 0.5).astype(np.int64)
    signed24 = np.random.default_rng(24).integers(-2, 3, (24, 24))
    estimates = {}
    for tag, a, kw in (("rasmussen n=32", bin32, {"perman_algo": "rasmussen"}),
                       ("scaling n=32", bin32, {"perman_algo": "scaling"}),
                       ("gurvits n=24", signed24,
                        {"perman_algo": "gurvits", "gurvits_dist": "auto"})):
        want = spt.permanent(a, calc="exact").meta["exact_fraction"]
        # twice: the first call also pays the process's first launch of
        # each of its kernels
        first = None
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = spt.permanent(a, approximation=True, **kw)
            wall = time.perf_counter() - t
            first = wall if first is None else first
        se = res.meta["stderr"]
        z = float((Fraction(res.permanent) - want) / Fraction(se)) \
            if se and math.isfinite(se) else math.inf
        estimates[tag] = {"wall_s": wall, "first_wall_s": first,
                          "trials": res.meta["trials"],
                          "trials_per_s": res.meta["trials"] / wall,
                          "z": z, "stderr_rel": se / float(want)}
        print(f"estimator {tag}: {res.permanent!r} +- {se!r} vs the exact "
              f"{float(want)!r}: {z:+.3f} stderr (limit {EST_SIGMAS}), "
              f"stderr/exact {se / float(want):.3e}; {res.algo_name}, "
              f"{res.meta['trials']} trials, {res.zeros} zeros, "
              f"{res.meta.get('dist', '')} in {wall:.3f} s "
              f"({res.meta['trials'] / wall:.0f} trials/s; the first call "
              f"{first:.3f} s)")
        if res.meta["trials"] != 100000 or not (se and se > 0) \
                or not abs(z) <= EST_SIGMAS:
            raise AssertionError(f"estimator {tag}: z {z}, stderr {se}")

    # Gurvits where its stderr says something: the signed n=24 matrix
    # above sits at stderr/exact ~1e3, where EST_SIGMAS stderr passes
    # almost any answer
    for tag, a, kw in (
            ("gurvits diagonal n=24", diag_dominant(124, 24),
             {"gurvits_dist": "auto", "number_of_times": 100000}),
            ("gurvits gaussian n=6", diag_dominant(106, 6),
             {"gurvits_dist": "gaussian", "number_of_times": 1000000})):
        want = spt.permanent(a, calc="exact").meta["exact_fraction"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = spt.permanent(a, approximation=True, perman_algo="gurvits",
                            **kw)
        wall = time.perf_counter() - t
        se = res.meta["stderr"]
        z = float((Fraction(res.permanent) - want) / Fraction(se)) \
            if se and math.isfinite(se) else math.inf
        srel = se / abs(float(want))
        estimates[tag] = {"wall_s": wall, "trials": res.meta["trials"],
                          "trials_per_s": res.meta["trials"] / wall,
                          "z": z, "stderr_rel": srel,
                          "dist": res.meta["dist"]}
        print(f"estimator {tag}: {res.permanent!r} +- {se!r} vs the exact "
              f"{float(want)!r}: {z:+.3f} stderr (limit {EST_SIGMAS}), "
              f"stderr/exact {srel:.3e} (limit {GURVITS_INFO}); "
              f"{res.meta['dist']}, {res.meta['trials']} trials in "
              f"{wall:.3f} s")
        if res.meta["trials"] != kw["number_of_times"] \
                or not abs(z) <= EST_SIGMAS or not srel < GURVITS_INFO:
            raise AssertionError(f"estimator {tag}: z {z}, stderr/exact "
                                 f"{srel}")
    # the Gurvits trial against float64 on the same float32 draws.  A
    # float32 dot product of length n is off by at most g_n sum|a_ij x_j|
    # with g_n = n u / (1 - n u), u = 2^-24 (any summation order, with or
    # without FMA); log2|y_i| so by at most -log2(1 - g_n k_i), k_i =
    # sum|a_ij x_j| / |y_i|.  A TF32 product (inputs rounded at 2^-11), a
    # lost factor or a wrong sign is far outside that
    from superman_tpu_torch.ops.approx import _full_fp32, _gurvits_trial
    ga = signed24.astype(np.float32)
    gx = np.random.default_rng(2401).standard_normal((8192, 24)) \
        .astype(np.float32)
    with _full_fp32():
        logm, sgn = _gurvits_trial(torch.as_tensor(ga, device=dev),
                                   torch.as_tensor(gx, device=dev))
    logm, sgn = logm.cpu().numpy(), sgn.cpu().numpy()
    a64, x64 = ga.astype(np.float64), gx.astype(np.float64)
    y64 = x64 @ a64.T
    kappa = (np.abs(x64) @ np.abs(a64).T) / np.abs(y64)
    u = 2.0 ** -24
    g_n = 24 * u / (1 - 24 * u)
    ok = np.all(g_n * kappa < 0.5, axis=1)     # rows far from a sign flip
    want_l = np.log2(np.abs(y64)).sum(1) + np.log2(np.abs(x64)).sum(1)
    want_s = np.sign(y64).prod(1) * np.sign(x64).prod(1)
    lim = -np.log2(1.0 - g_n * np.where(ok[:, None], kappa, 0.0)).sum(1)
    gerr = np.abs(logm - want_l)
    print(f"gurvits trial n=24, 8192 Gaussian draws on the card vs float64: "
          f"{int(ok.sum())} trials far from a sign flip, largest log2 "
          f"error {float(gerr[ok].max()):.3e}, largest error over its "
          f"limit {float((gerr[ok] / lim[ok]).max()):.3f}, signs equal: "
          f"{bool(np.all(sgn[ok] == want_s[ok]))}")
    if ok.sum() < 4096 or np.any(gerr[ok] > lim[ok]) \
            or np.any(sgn[ok] != want_s[ok]):
        raise AssertionError("gurvits trial: off float64 past the float32 "
                             "bound")

    # the grid flagship: SMC on the 36 x 36 grid (n = 648) against the
    # Kasteleyn closed form; then the selector (scale_intervals=-1) on the
    # 16 x 16 grid; both through tools/smc_flagship.py's function
    for g, si in ((36, 2), (16, -1)):
        tag = f"grid {g}x{g} si={si}"
        row = smc_flagship.flagship(g, FLAGSHIP["number_of_times"],
                                    FLAGSHIP["seed"], dev,
                                    scale_intervals=si, warmup=False)
        wall, z = row["warm_wall_s"], row["z"]
        # the selector runs both candidates in full: twice the particles
        run = row["trials"] * (2 if si < 0 else 1)
        estimates[tag] = {"wall_s": wall, "trials": row["trials"],
                          "particles_run": run, "trials_per_s": run / wall,
                          "z": z, "stderr_rel": row["stderr_rel"]}
        print(f"{tag} (n={row['n']}): log2 {row['est_log2']:.4f} vs "
              f"Kasteleyn {row['exact_log2']:.4f}, sigma_log2 "
              f"{row['sigma_log2']:.4f}, z {z:+.3f} (limit "
              f"{smc_flagship.Z_LIMIT}); "
              f"{row['algo_name']}, {row['trials']} particles in "
              f"{row['populations']} populations, si "
              f"{row['scale_intervals']}, zeros {row['zeros']}, si_auto "
              f"{row['si_auto']}; {wall:.3f} s")
        if not abs(z) <= smc_flagship.Z_LIMIT \
                or row["algo_name"] != "approx_scaling_smc":
            raise AssertionError(f"{tag}: z {z}")
    # the flagship's device-busy share: one population of it under the
    # profiler
    from superman_tpu_torch.core.flags import Flags
    from superman_tpu_torch.ops.approx import smc_estimate
    from superman_tpu_torch.prep.gridgraph import grid_graph_matrix
    g648 = grid_graph_matrix(36, 36).mat.astype(np.float64)
    _, pop_wall, busy, nkern = device_busy(lambda: smc_estimate(
        g648, Flags(**FLAGSHIP), dev, pops=1, si=2))
    estimates["flagship population"] = {
        "wall_s": pop_wall, "device_busy_s": busy, "kernels": nkern,
        "idle_share": None if busy is None else 1.0 - busy / pop_wall}
    print(f"grid 36x36, one SMC population under torch.profiler: "
          f"{pop_wall:.3f} s host, device busy "
          f"{'not measured' if busy is None else f'{busy:.3f} s'} "
          f"({nkern} device activities): idle share "
          f"{estimates['flagship population']['idle_share']}")
    print(f"driver and estimator walls (s): "
          f"{ {k: round(v, 4) for k, v in walls.items()} }; estimators "
          f"{json.dumps(estimates)}")

    # ---- 4. times at the full n=32 main-path plan
    # (the SM clock is sampled after each kernel's timing, while more of
    # its launches run)
    ids = torch.arange(plan.num_chunks, device=dev)
    k1 = {}
    clocks = {}
    for tier in TIERS:
        def run_kernel():
            return ryser_cuda.ryser_partials(ids, x0, cols, n=32, r=plan.r,
                                             tier=tier)
        run_kernel()                                      # warm-up
        kernel_ms, kern = cuda_ms(run_kernel, 5)
        clocks[f"k1_{tier}"] = sm_clock(run_kernel)
        line = (f"ryser_walk_{tier}, full plan ({plan.num_chunks} chunks of "
                f"2^{plan.r}): kernel {kernel_ms:.3f} ms "
                f"({(1 << 31) / kernel_ms / 1e6:.1f} G steps/s), "
                f"SM clock {clocks[f'k1_{tier}']} MHz, "
                f"{regs.get(f'ryser_walk_kernel<{plan.n_pad},{TIERS.index(tier)},0>')}"
                f" registers")
        if tier == "tf96":
            # its plain version takes ~130 launches a step: it ran once, on
            # the sampled ids of phase 2 (a plain walk pays per step, not
            # per chunk); here the full plan's chunks must repeat those
            was, plain_ms = k1_sampled[tier]
            live = sampled_ids >= 0
            if not torch.equal(kern[sampled_ids[live]], was[live]):
                raise AssertionError("tf96: the full plan's partials differ "
                                     "from the sampled run's")
            print(f"{line}; plain {plain_ms:.1f} ms on the "
                  f"{sampled_ids.numel()} sampled ids, whose partials the "
                  f"full plan repeats bit for bit")
        else:
            plain_ms, plain = cuda_ms(lambda: ryser_cuda.ryser_partials_ref(
                ids, x0, cols, n=32, r=plan.r, tier=tier), 1)
            print(f"{line}, plain {plain_ms:.1f} ms")
            k1_err[tier] = max(k1_err[tier], compare(kern, plain, ids))
        k1[tier] = (kernel_ms, plain_ms, walk_bound(
            1 << 31, 32, tier, nbytes_of(ids, x0, cols, kern)))

    # K1's block-reduced entry at the same plan, as the dense totals
    # launch it: every block row, the ids made on the card, each block of
    # 128 chunks summed there; against its plain version on every row, bit
    # for bit
    rows = torch.arange(-(-plan.num_chunks // plan.lanes), device=dev)
    block_walk = {}
    for tier in BLOCK_TIERS:
        def run_blocks():
            return ryser_cuda.ryser_blocks(
                rows, x0, cols, n=32, r=plan.r, lanes=plan.lanes,
                num_chunks=plan.num_chunks, tier=tier)
        run_blocks()                                      # warm-up
        blocks_ms, kern = cuda_ms(run_blocks, 5)
        clocks[f"blocks_{tier}"] = sm_clock(run_blocks)
        plain_ms, plain = cuda_ms(lambda: ryser_cuda.ryser_blocks_ref(
            rows, x0, cols, n=32, r=plan.r, lanes=plan.lanes,
            num_chunks=plan.num_chunks, tier=tier), 1)
        reg = regs.get(f"ryser_walk_kernel<{plan.n_pad},"
                       f"{TIERS.index(tier)},1>")
        print(f"ryser_walk_blocks {tier}, full plan ({rows.numel()} block "
              f"rows of {plan.lanes} chunks of 2^{plan.r}, {kern.shape[0]} "
              f"block pairs): kernel {blocks_ms:.3f} ms "
              f"({(1 << 31) / blocks_ms / 1e6:.1f} G steps/s), SM clock "
              f"{clocks[f'blocks_{tier}']} MHz, {reg} registers; plain "
              f"{plain_ms:.1f} ms:")
        err = compare(kern, plain, None)
        if not torch.equal(kern, plain):
            raise AssertionError(f"ryser_walk_blocks {tier}: kernel and "
                                 f"plain version differ")
        block_walk[tier] = {"err": err, "registers": reg, "times": (
            blocks_ms, plain_ms, walk_bound(
                1 << 31, 32, tier, nbytes_of(rows, x0, cols, kern)))}

    # the amp tier's variants at the same plan; their plain versions ran
    # on the sampled ids of phase 2e, whose sums the full plan must repeat
    live = sampled_ids >= 0
    for variant, cond in amp_variants.items():
        def run_amp():
            return ryser_cuda.ryser_amp(ids, x0, cols, n=32, r=plan.r,
                                        cond=cond)

        run_amp()                                         # warm-up
        amp_ms, kern = cuda_ms(run_amp, 3)
        clocks[f"amp_{variant}"] = sm_clock(run_amp)
        if not torch.equal(kern[sampled_ids[live]],
                           amp_sampled[variant]["kern"][live]):
            raise AssertionError(f"amp ({variant}): the full plan's sums "
                                 f"differ from the sampled run's")
        reg = regs.get(f"ryser_amp_kernel<{plan.n_pad},{4 + cond}>")
        print(f"ryser_walk_amp ({variant}), full plan: kernel {amp_ms:.3f} "
              f"ms ({(1 << 31) / amp_ms / 1e6:.1f} G steps/s), {reg} "
              f"registers; plain {amp_sampled[variant]['plain_ms']:.1f} ms on "
              f"the {sampled_ids.numel()} sampled ids, whose sums the full "
              f"plan repeats bit for bit")
        amp_sampled[variant].update(ms=amp_ms, registers=reg, bound=amp_bound(
            1 << 31, 32, nbytes_of(ids, x0, cols, kern), cond))

    # the reduced kernel on the whole n=36 plan of each tier, as the
    # sparse path walks it
    reduced = {}
    for tier in TIERS:
        s36 = sparse36[tier]

        def run_reduced():
            return ryser_cuda.ryser_reduced(s36["ids"], *s36["pack"], n=36,
                                            r=s36["r"], tier=tier)
        run_reduced()                                     # warm-up
        red_ms, kern = cuda_ms(run_reduced, 5)
        clocks[f"reduced_{tier}"] = sm_clock(run_reduced)
        steps = s36["ids"].numel() << s36["r"]
        n_alive = len(s36["sp"].alive_rows)
        s36["registers"] = regs.get(
            f"ryser_reduced_kernel<{s36['pack'][0].shape[0]},"
            f"{TIERS.index(tier)}>")
        print(f"ryser_walk_reduced {tier}, the n=36 plan "
              f"({s36['ids'].numel()} chunks of 2^{s36['r']}, {n_alive} "
              f"alive rows): kernel {red_ms:.3f} ms "
              f"({steps / red_ms / 1e6:.1f} G steps/s, {steps} live "
              f"steps), SM clock {clocks[f'reduced_{tier}']} MHz, "
              f"{s36['registers']} registers; plain "
              f"{s36['plain_ms']:.1f} ms on {s36['plain_chunks']} ids")
        reduced[tier] = (red_ms, s36["plain_ms"], walk_bound(
            steps, n_alive, tier,
            nbytes_of(s36["ids"], *s36["pack"], kern)))

    p = MOD_PRIMES[-1]
    mx0, mcols = (t.to(dev) for t in modp.pack_mod(
        modp.reduce_core_mod(core, p), p, plan.n_pad))

    def run_mod():
        return modp_cuda.mod_partials(ids, mx0, mcols, p, n=32, r=plan.r)

    run_mod()                                             # warm-up
    mod_ms, kern = cuda_ms(run_mod, 5)
    clocks["modp"] = sm_clock(run_mod)
    mod_plain_ms, plain = cuda_ms(lambda: modp_cuda.mod_partials_ref(
        ids, mx0, mcols, p, n=32, r=plan.r), 1)
    print(f"modp_walk vs plain, full plan, p={p}: kernel {mod_ms:.3f} ms "
          f"({(1 << 31) / mod_ms / 1e6:.2f} G steps/s), plain "
          f"{mod_plain_ms:.1f} ms")
    mod_err = max(mod_err, compare_mod(kern, plain, ids, p))
    # a Z_p step cannot avoid n modular adds (add, conditional subtract)
    # and n-1 Montgomery products (3 multiplies, 3 more) and the sum:
    # tools/modp_rate.py's ledger
    mod_bound = bound(nbytes_of(ids, mx0, mcols, kern), (1 << 31)
                      * modp_rate.ledger_ops_per_step(32)["total"], "int32")

    # ---- 5. the host layer: the native engine, the mesh, the hybrid
    # scheduler, several processes, the estimators' new paths
    host = host_layer_phases(dev, a32, a36, bin32, zero_counts)
    print(f"host layer walls (s): {json.dumps(host['walls'])}")

    # ---- 6. the tools: fuzz, accuracy, suite_check, sparse_report,
    # modp_rate, scaling_measure, exact_known, real_suite
    tools = tools_phase(dev, zero_counts)
    tl = tools["launches"]

    # ---- 7. the NaN switch (SUPERMAN_DEBUG_NANS)
    nans = nan_switch_phase(dev, a32, a36, stack_a, card)

    # ---- 8. the bench (tools/bench.py) and its capture
    bp = bench_phase(dev, zero_counts)
    bl = bp["launches"]

    # ---- 9. the lane walks' range (row and column scales)
    wr = walk_range_phase(dev, card, zero_counts)
    rl = wr["launches"]

    # ---- 10. SUPerman's multi-GPU deployment: n=38 over the cards
    mc = mesh_cards_phase(dev, regs)["blocks"]

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd,
              **more):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                **({"issue_bound_ms": bnd[2]} if len(bnd) > 2 else {}),
                **more}

    def chunks_only(k1, k1b):
        """K1's per-chunk launches: all of them less the block-reduced."""
        if isinstance(k1, dict):
            return {k: v - k1b.get(k, 0) for k, v in k1.items()}
        return k1 - k1b

    # every walk entry carries its instantiation's registers at the path's
    # N_PAD and the SM clock sampled beside its timing; ryser_walk_<tier>
    # (the C entry ryser_walk at that tier) is the per-chunk instantiation
    # <N_PAD, TIER, 0> and its launches, ryser_walk_blocks the
    # block-reduced <N_PAD, TIER, 1> and its launches
    kernels = [entry(f"ryser_walk_{tier}",
                     "superman_tpu_torch/csrc/ryser_walk.cu",
                     "superman_tpu/ops/ryser_pallas.py:541",
                     chunks_only(k1_launches[tier], k1_blocks[tier]),
                     k1_err[tier], *k1[tier],
                     registers=regs.get(f"ryser_walk_kernel<{plan.n_pad},"
                                        f"{TIERS.index(tier)},0>"),
                     clocks_sm_mhz=clocks[f"k1_{tier}"],
                     **({"plain_ms_chunks": int(sampled_ids.numel())}
                        if tier == "tf96" else {}),
                     **({"glynn_launches": chunks_only(
                         glynn_launches[tier], glynn_blocks[tier])}
                        if tier in glynn_launches else {}),
                     **({"driver_launches": chunks_only(
                         driver_launches["k1"], driver_launches["blocks"])}
                        if tier == "df64" else {}),
                     mesh_launches=chunks_only(host["mesh"][tier]["k1"],
                                               host["mesh"][tier]["blocks"]),
                     tools_launches=chunks_only(
                         tl["k1"][tier], tl["blocks"].get(tier, 0)),
                     bench_launches=chunks_only(
                         bl["k1"][tier], bl["blocks"].get(tier, 0)),
                     range_launches=chunks_only(
                         rl["k1"][tier], rl["blocks"].get(tier, 0)),
                     **({"hybrid_launches": host["hybrid"]}
                        if tier == "df64" else {}))
               for tier in TIERS]
    # the block-reduced entry at the n=32 full plan (launches: 4 calls of
    # permanent a tier); the widening and the block sum are a few hundred
    # operations a chunk and are left out of the bound
    kernels += [entry("ryser_walk_blocks",
                      "superman_tpu_torch/csrc/ryser_walk.cu",
                      "superman_tpu/ops/ryser_pallas.py:541",
                      k1_blocks[tier], block_walk[tier]["err"],
                      *block_walk[tier]["times"], tier=tier,
                      registers=block_walk[tier]["registers"],
                      clocks_sm_mhz=clocks[f"blocks_{tier}"],
                      **({"glynn_launches": glynn_blocks[tier]}
                         if tier in glynn_blocks else {}),
                      **({"driver_launches": driver_launches["blocks"]}
                         if tier == "df64" else {}),
                      mesh_launches=host["mesh"][tier]["blocks"],
                      tools_launches=tl["blocks"][tier],
                      bench_launches=bl["blocks"][tier],
                      range_launches=rl["blocks"][tier],
                      **({"mesh_glynn_launches":
                          host["mesh"]["glynn df64"]["blocks"],
                          "multihost_launches": host["multihost_blocks"]}
                         if tier == "df64" else {}))
                for tier in BLOCK_TIERS]
    # the block-reduced entry at n=38 (<40, 0, 1>), the walk of the mesh
    # phase: launches of its dealt call (one an entry), ms and bound_ms on
    # one card's share of the one-card plan, plain_ms on plain_rows block
    # rows of 2^plain_r-step chunks
    kernels.append(entry("ryser_walk_blocks",
                         "superman_tpu_torch/csrc/ryser_walk.cu",
                         "superman_tpu/ops/ryser_pallas.py:541",
                         mc["launches"], mc["err"], mc["ms"],
                         mc["plain_ms"], mc["bound"], tier="df64", n=38,
                         registers=mc["registers"],
                         **{k: mc[k] for k in ("share_rows", "r", "lanes",
                                               "plain_rows", "plain_r")}))
    # ms, plain_ms and bound_ms at 256 x n=24; beside them the kernel at
    # 16 x n=32 and kernel and plain version at the first 2 of those
    kernels += [entry("ryser_batch", "superman_tpu_torch/csrc/ryser_batch.cu",
                      "superman_tpu/ops/ryser_pallas.py:685",
                      k2_launches[tier], k2[tier]["err"], *k2[tier]["n24"],
                      tier=tier, tools_launches=tl["batch"],
                      range_launches=rl["batch"],
                      registers=regs.get(
                          f"ryser_batch_kernel<24,{TIERS.index(tier)}>"),
                      clocks_sm_mhz=k2[tier]["clock"],
                      ms_n32=k2[tier]["n32"][0],
                      bound_ms_n32=k2[tier]["n32"][2][0],
                      issue_bound_ms_n32=k2[tier]["n32"][2][2],
                      ms_n32_2=k2[tier]["n32_2"][0],
                      plain_ms_n32_2=k2[tier]["n32_2"][1],
                      bound_ms_n32_2=k2[tier]["n32_2"][2][0])
                for tier in TIERS]
    # the reduced entry point at the n=36 sparse plan (launches: 4 calls
    # of permanent); the weight and the block sum are a few hundred
    # operations a chunk and are left out of the bound
    kernels += [entry("ryser_walk_reduced",
                      "superman_tpu_torch/csrc/ryser_walk.cu",
                      "superman_tpu/ops/ryser_pallas.py:541",
                      reduced_launches[tier], sparse36[tier]["err"],
                      *reduced[tier], tier=tier,
                      tools_launches=tl["reduced"][tier],
                      bench_launches=bl["reduced"][tier],
                      range_launches=rl["reduced"][tier],
                      registers=sparse36[tier]["registers"],
                      clocks_sm_mhz=clocks[f"reduced_{tier}"],
                      plain_ms_chunks=sparse36[tier]["plain_chunks"],
                      **({"driver_launches": driver_launches["reduced"],
                          "mesh_launches":
                          host["mesh"]["sparse n=36 df64"]["reduced"]}
                         if tier == "df64" else {}))
                for tier in TIERS]
    # the amp walk once per variant: launches on the auto path that runs
    # it (the amplitude alone to the exact rung at n=32, the conditioned
    # one on the landmine matrix), times at the n=32 full plan
    kernels += [entry("ryser_walk_amp",
                      "superman_tpu_torch/csrc/ryser_walk.cu",
                      "superman_tpu/ops/ryser_pallas.py:541",
                      amp_launches[variant], v["err"], v["ms"], v["plain_ms"],
                      v["bound"], variant=variant,
                      tools_launches=tl[variant], range_launches=rl[variant],
                      registers=v["registers"],
                      clocks_sm_mhz=clocks[f"amp_{variant}"],
                      plain_ms_chunks=int(sampled_ids.numel()))
                for variant, v in amp_sampled.items()]
    kernels.append(entry("modp_walk", "superman_tpu_torch/csrc/modp_walk.cu",
                         "superman_tpu/ops/modp.py:413", mod_launches,
                         mod_err, mod_ms, mod_plain_ms, mod_bound,
                         clocks_sm_mhz=clocks["modp"],
                         driver_launches=driver_launches["modp"],
                         tools_launches=tl["modp"],
                         range_launches=rl["modp"]))
    total = time.perf_counter() - t_script
    print(f"chip_smoke: {total:.1f} s from the probe to here, of it the "
          f"tools' phase {tools['walls']['phase']:.1f} s "
          f"({tools['walls']['phase'] / total:.1%}), the NaN switch's "
          f"{nans['phase_s']:.1f} s, the bench's {bp['wall_s']:.1f} s and "
          f"its capture's {bp['capture_wall_s']:.1f} s, the lane walks' "
          f"range {wr['phase_s']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
