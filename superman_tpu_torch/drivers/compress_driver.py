"""Recursive exact-compression driver.

Port of ``superman_tpu/drivers/compress_driver.py``.  Parity:
compress_and_calculate_recursive + compress_singleton_and_then_recurse
(reference revised_perman/main.cpp:994-1094): strip degree-1/2 lines to a
fixed point, then while the minimum degree is < 5 and the matrix is
larger than the compression floor, apply d1/d2 (recurse on one matrix)
or d34 (recurse on TWO matrices and sum).  At the floor, dispatch to the
scaling driver or the engine on `device`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.matrix import DenseMatrix
from ..core.result import Result
from ..prep import compression as C
from ..utils import trace

# the reference stops compressing below 31 rows (main.cpp:1007)
COMPRESSION_FLOOR = 30


def compress_and_calculate_recursive(dense: DenseMatrix, flags,
                                     device: torch.device) -> Result:
    a = dense.mat
    min_deg = C.min_degree(a) if a.size else 0
    if min_deg < 5 and a.shape[0] > COMPRESSION_FLOOR:
        if min_deg == 0:
            return Result(0.0, 0.0, algo_name="compressed_zero")
        if min_deg == 1:
            out = C.d1compress(a)
            return compress_and_calculate_recursive(
                DenseMatrix(out, dense.type), flags, device)
        if min_deg == 2:
            out = C.d2compress(a)
            return compress_and_calculate_recursive(
                DenseMatrix(out, dense.type), flags, device)
        pair = C.d34compress(a, min_deg)
        if pair is not None:
            m1, m2 = pair
            return (compress_and_calculate_recursive(
                        DenseMatrix(m1, dense.type), flags, device) +
                    compress_and_calculate_recursive(
                        DenseMatrix(m2, dense.type), flags, device))

    from .scale_driver import scale_and_calculate
    if flags.scaling_threshold != -1.0:
        return scale_and_calculate(dense, flags, device, compressing=True)
    if _magnitude_imbalanced(dense.mat) and (dense.mat >= 0).all() \
            and flags.resolved_calc() not in ("f32", "f32k"):
        # Sinkhorn preconditioning restores the conditioning that d2
        # merges take away (they concentrate magnitude within a line,
        # which makes the Ryser sum cancellation-bound beyond any
        # double-class arithmetic).  Nonnegative matrices only: it cannot
        # fix signed cancellation.  Double-class tiers only: scaled to
        # unit line sums, a huge-entry matrix's permanent falls below the
        # f32 tiers' resolution and the exact unscale amplifies noise.
        # The threshold lands the scaled permanent near 2^-12.
        thr = _auto_threshold(dense.mat)
        trace.log("compressed matrix is magnitude-imbalanced; "
                  f"auto-applying Sinkhorn (threshold {thr:.3g})", level=1)
        return scale_and_calculate(
            dense, dataclasses.replace(flags, scaling_threshold=thr),
            device, compressing=True)
    from .runner import run_algo
    return run_algo(dense, flags, device)


def _magnitude_imbalanced(a: np.ndarray, ratio: float = 1e8) -> bool:
    """True when some row or column spans more than `ratio` in magnitude
    across its nonzeros (Ryser conditioning proxy)."""
    ab = np.abs(np.asarray(a, dtype=np.float64))
    for m in (ab, ab.T):
        for row in m:
            nz = row[row != 0]
            if len(nz) and nz.max() > ratio * nz.min():
                return True
    return False


def compress_singleton_and_then_recurse(dense: DenseMatrix, flags,
                                        device: torch.device) -> Result:
    """d1/d2 to a fixed point first (cheap, always wins), then recurse."""
    a = dense.mat
    changed = True
    folds = 0
    while changed and a.shape[0] > 1:
        changed = False
        out = C.d1compress(a)
        if out is None:
            out = C.d2compress(a)
        if out is not None:
            a = out
            changed = True
            folds += 1
            if a.size and C.has_empty_line(a):
                return Result(0.0, 0.0, algo_name="rank_deficient_zero")
    res = compress_and_calculate_recursive(DenseMatrix(a, dense.type), flags,
                                           device)
    # a calc="auto" err_est inside this pipeline covers the folded core's
    # walk only: the d2/d34 merges above round entries in f64, an input
    # perturbation the walk's bound cannot see (runner._compression_sanity
    # is the backstop)
    if folds and res.meta.get("auto") is not None:
        res.meta["auto"]["bound_scope"] = "folded_core_walk_only"
        res.meta["auto"]["folds"] = folds
    return res


def _auto_threshold(a: np.ndarray) -> float:
    """Sinkhorn threshold that centers the scaled permanent near 2^-12.

    log2 per(B(1)) ~ est(log2 per(A)) + log2 prod(r)prod(c) at threshold
    1; per(B(t)) = t^n per(B(1)), so t = 2^((target - that)/n).  The
    probe is crude (a few greedy trials): a miss costs only the engine's
    underflow retry.
    """
    from ..ops.ryser import _log2_perm_estimate
    from ..prep.scaling import scalesk

    n = a.shape[0]
    est = _log2_perm_estimate(a)
    if est is None or not np.isfinite(est):
        return 1.0
    lp1 = scalesk(np.asarray(a, dtype=np.float64), 1.0).log2_product()
    if not np.isfinite(lp1):
        return 1.0
    shift = (-12.0 - (est + lp1)) / max(1, n)
    return float(2.0 ** np.clip(shift, -40.0, 40.0))
