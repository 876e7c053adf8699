"""Exact-permanent engine: planning, dispatch, reduction (dense, tiers
df64, f32, f32k, tf96 and f64).

Port of the dense branch of ``superman_tpu/ops/ryser.py``.  The host
side (row scales, pack, underflow retry, sign and 2^E) is the
reference's; the walk is the CUDA kernel of ops/ryser_cuda.py, or its
plain version when the device is the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.matrix import DenseMatrix
from ..core.result import Result
from ..utils import trace
from . import gray


def _exact_storage(dense: DenseMatrix) -> bool:
    """True when matrix values and the half-integer x walk are exact in f32
    (the int suites): f32 updates are then error-free.

    Decided on the VALUES, not the declared storage class: a float64
    matrix holding small integers walks identically to an "int"-typed one.
    The port's df64 walk keeps x in float64 and its f32 tiers round the
    pack to float32 either way, so for them the flag is only reported in
    Result.meta.  The tf96 tier reads it: its double-double products are
    worth their cost only on x updates that are exact, so calc="tf96" on
    other storage falls back to df64 with a warning."""
    a = np.asarray(dense.mat)
    if a.dtype == np.longdouble:
        return False                  # -v storage keeps long-double bits
    a = a.astype(np.float64)
    if dense.type != "int" and not np.all(a == np.round(a)):
        return False
    return bool(np.max(np.abs(a).sum(axis=1), initial=0.0) < 2 ** 22)


def _row_scales(a: np.ndarray) -> np.ndarray:
    """Integer exponents s_j so that scaling row j by 2**-s_j bounds every
    |x_j| by ~1 along the whole walk (|x_j| <= |a[j,n-1]| + abs-rowsum/2).

    Power-of-two scaling is EXACT in binary floating point, so the walk
    keeps its exactness guarantees while every intermediate tree product
    stays <= 1 in magnitude — overflow becomes impossible.
    The permanent is recovered as result * 2**sum(s).
    """
    ab = np.abs(np.asarray(a, dtype=np.float64))
    xmax = ab[:, -1] + ab.sum(axis=1) / 2
    with np.errstate(divide="ignore"):
        s = np.ceil(np.log2(np.maximum(xmax, 1e-300)))
    # wide clip: compression drivers can concentrate magnitude into rows
    # far beyond 2^+-60; the scale is applied with exact ldexp so any
    # exponent in double range is fine
    return np.clip(s, -980, 980).astype(np.int64)


def _log2_perm_estimate(a: np.ndarray, trials: int = 6,
                        seed: int = 12345):
    """Crude host-side log2 |permanent| magnitude probe (Rasmussen's
    estimator in log space over |A|, reference algo.h:171 repurposed):
    a few n^2 greedy passes, median of the per-trial log estimates.

    Only used to CENTER the power-of-two row scaling so the scaled Gray
    total lands near 2^-12 on the first attempt: without it, matrices
    whose permanent is far below the row-scale bound need 1-2 full
    underflow-retry relaunches — each a complete engine pass.  A wrong
    estimate costs only a retry.  Returns None when every trial dies
    (permanent likely 0).
    """
    ab = np.abs(np.asarray(a, dtype=np.float64))
    n = ab.shape[0]
    rng = np.random.default_rng(seed)
    # process rows sparsest-first: fewer dead ends, lower variance
    order = np.argsort((ab > 0).sum(axis=1), kind="stable")
    ests = []
    for _ in range(trials):
        used = np.zeros(n, dtype=bool)
        lg = 0.0
        for i in order:
            nz = np.nonzero((ab[i] > 0) & ~used)[0]
            if len(nz) == 0:
                lg = None
                break
            j = nz[rng.integers(len(nz))]
            lg += np.log2(len(nz)) + np.log2(ab[i, j])
            used[j] = True
        if lg is not None:
            ests.append(lg)
    return float(np.median(ests)) if ests else None


def _center_scales(a: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Shift the per-row scales so the first attempt's scaled total is
    near 2^-12 instead of underflow-retrying its way there.  The shift
    is capped at 2^60 total term growth (the retry loop's non-finite
    fallback still guards mis-estimates)."""
    est = _log2_perm_estimate(a)
    if est is None or not np.isfinite(est):
        return scales
    n = a.shape[0]
    delta = min(60, max(0, int(scales.sum()) - (int(est) + 12)))
    if delta <= 0:
        return scales
    scales = scales.copy()
    per_row, rem = divmod(delta, n)
    scales -= per_row
    if rem:
        scales[:rem] -= 1
    return scales


def _sm_count(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return gray.DEFAULT_SMS


def ryser_exact(dense: DenseMatrix, flags, device: torch.device) -> Result:
    """Exact permanent of `dense` on `device`, calc "df64", "f32",
    "f32k", "tf96" or "f64"."""
    a = np.asarray(dense.mat)
    n = a.shape[0]
    calc = flags.resolved_calc()
    if calc not in ("df64", "f32", "f32k", "tf96", "f64"):
        raise ValueError(f"ryser_exact has no {calc!r} tier")
    t0 = time.perf_counter()

    if n <= 2:
        from .oracle import perman_brute
        p = perman_brute(a)
        return Result(float(p), time.perf_counter() - t0,
                      algo_name="ryser_exact", iterations=1)

    if calc == "tf96" and n < 19:
        # small n: the host long-double walk, which meets the tier's
        # contract; the float64 walk below would quietly degrade it
        from .oracle import perman64
        p = perman64(a, dtype=np.longdouble)
        return Result(float(p), time.perf_counter() - t0,
                      algo_name="ryser_tf96_host", iterations=1 << (n - 1),
                      meta={"calc": calc})

    if calc == "f64" or n < 19:
        from .ryser_walk import ryser_walk
        # the small-n route walks float32 for calc="f32" only
        p = ryser_walk(a, device,
                       torch.float32 if calc == "f32" else torch.float64)
        return Result(float(p), time.perf_counter() - t0,
                      algo_name=f"ryser_walk_{calc}",
                      iterations=1 << (n - 1),
                      meta={"calc": calc, "device": str(device)})

    exact_storage = _exact_storage(dense)
    if calc == "tf96" and not exact_storage:
        # tf96 needs x updates that are exact in f32 (the int suites); the
        # hybrid and checkpoint routes the reference also names here are
        # refused before this engine is reached
        import warnings
        warnings.warn("tf96 requires exact-f32 storage and the non-hybrid "
                      "path; falling back to df64")
        calc = "df64"
    tf = calc == "tf96"

    # the kernel on a card, its plain version on the CPU
    name = f"ryser_{'cuda' if device.type == 'cuda' else 'plain'}_{calc}"
    # trivial zero: an empty row or column makes the permanent 0 and also
    # breaks the row-scaling heuristic, so dispose of it here
    if (np.count_nonzero(a, axis=1) == 0).any() or \
       (np.count_nonzero(a, axis=0) == 0).any():
        return Result(0.0, time.perf_counter() - t0, algo_name=name,
                      iterations=0, meta={"reason": "empty row/col"})

    from ..parallel.sharding import compute_total, pad_ids
    plan = gray.make_plan(n, flags.lanes, flags.chunk_log2,
                          sms=_sm_count(device),
                          grid_multip=int(flags.grid_multip))
    ids_blocks = pad_ids(np.arange(plan.num_chunks, dtype=np.int64),
                         plan.lanes)
    trace.log(f"plan: n={n} n_pad={plan.n_pad} r={plan.r} "
              f"lanes={plan.lanes} chunks={plan.num_chunks} calc={calc} "
              f"device={device}", level=2)

    scales = _center_scales(a, _row_scales(a))
    best = None                 # (total, E) of the last FINITE attempt
    shifted = 0                 # cumulative per-row downshift (log2)
    shift_cap = max(1, 100 // n)   # total growth <= 2^100 across attempts
    for attempt in range(3):
        # ldexp applies the per-row exponent exactly even when 2**-s
        # alone would overflow double (rows at 2^-500 scale fine)
        a_s = np.ldexp(a.astype(np.float64), -scales[:, None])
        with trace.timer("pack"):
            x0, cols = gray.pack_matrix(a_s, plan.n_pad)
        with trace.timer("walk"):
            # a float; np.longdouble for tf96, kept until the last rounding
            total = compute_total(ids_blocks, x0, cols, plan, device,
                                  tier=calc)
        # scaled sums far below 1 may have lost underflowed terms; shift
        # the row scales to center the result near 2^0 and rerun (scaling
        # is exact, so a rerun is a pure exponent adjustment).  Shifts are
        # bounded CUMULATIVELY, and a non-finite rerun falls back to the
        # last finite attempt.
        if not np.isfinite(total):
            break
        best = (total, int(scales.sum()))
        if total != 0.0 and abs(total) > 2.0 ** -40:
            break
        room = shift_cap - shifted
        if room <= 0:
            break
        bump = 120 if total == 0.0 else int(-np.log2(abs(total)) // n + 1)
        per_row = max(1, min(bump, room))
        scales = scales - per_row
        shifted += per_row
    total, E = best if best is not None else (total, int(scales.sum()))
    # ldexp multiplies by 2**E exactly; out-of-range RESULTS become the
    # honest double inf/0 rather than raising
    with np.errstate(over="ignore"):
        acc = np.longdouble(total) if tf else np.float64(total)
        p = float((4 * (n & 1) - 2) * np.ldexp(acc, E)) + 0.0
    dt = time.perf_counter() - t0
    iters = plan.num_chunks << plan.r
    meta = {"calc": calc, "chunks": plan.num_chunks, "r": plan.r,
            "lanes": plan.lanes, "scale_log2": E,
            "iters_per_sec": iters / dt, "device": str(device),
            "exact_storage": exact_storage}
    # where the reference would engage its pruned sparse walk on its own
    # (n >= 28, density < 0.30), the port still walks dense: say so
    if n >= 28 and np.count_nonzero(a) / a.size < 0.30 and flags.skip_pruning:
        meta["sparse_pending"] = True
    return Result(p, dt, algo_name=name, iterations=iters, meta=meta)
