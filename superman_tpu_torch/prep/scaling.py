"""Sinkhorn scaling as an exact-preserving preconditioner.

Port of ``superman_tpu/prep/scaling.py``, unchanged: the module is pure
numpy, and the same matrix gives the same factors bit for bit.

Parity: scalesk + scaleMatrix (reference revised_perman/util.h:1445-1593)
and the result-correction step of scale_and_calculate
(revised_perman/main.cpp:1143-1150): the matrix is scaled as
B = diag(r) A diag(c); per(B) = per(A) * prod(r) * prod(c), so the driver
divides the computed permanent by prod(r)*prod(c).

DELIBERATE deviation from the reference: its stopping rule (mean scaled
line sum within a hard-coded 10 of the threshold, revised_perman/
util.h:1482) is vacuous for every threshold it is used with — the loop
exits after one sweep with the columns unbalanced.  This implementation
runs the true multiplicative Sinkhorn map (c_j *= t / colsum_j, then
r_i *= t / rowsum_i) to a real convergence test (max line-sum deviation
<= 1e-6 * t), which is what the preconditioning exists for: a
half-balanced scaling leaves the column-magnitude spread that makes
cancellation-bound walks (chesapeake-class) lose digits.  The exactness
contract is unchanged: per(B) = per(A) * prod(r) * prod(c) holds for
ANY factors, converged or not.  Signed matrices may oscillate (Sinkhorn
theory only covers nonnegative ones); the loop keeps the last finite
iterate and warns, same identity.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from ..core.matrix import DenseMatrix


@dataclasses.dataclass
class ScaleCompanion:
    """Parity: ScaleCompanion{r_v, c_v} (revised_perman/flags.h:8-26)."""
    r_v: np.ndarray
    c_v: np.ndarray

    def log2_product(self) -> float:
        """log2 |prod(r) * prod(c)|; signs are tracked separately
        (Sinkhorn on a SIGNED matrix yields negative factors — the
        per(B) = per(A) prod(r) prod(c) identity still holds, but
        log2 of a negative factor is NaN; found by fuzzing)."""
        return float(np.sum(np.log2(np.abs(self.r_v)))
                     + np.sum(np.log2(np.abs(self.c_v))))

    def sign_product(self) -> float:
        neg = int((self.r_v < 0).sum()) + int((self.c_v < 0).sum())
        return -1.0 if neg % 2 else 1.0


def scalesk(a: np.ndarray, scaling_threshold: float,
            max_iters: int = 500) -> ScaleCompanion:
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    rv = np.ones(n)
    cv = np.ones(n)
    thr = float(scaling_threshold)
    has_col = (a != 0).any(axis=0)
    has_row = (a != 0).any(axis=1)
    best = (np.inf, rv, cv)
    for _ in range(max_iters):
        colsum = (a * rv[:, None] * cv[None, :]).sum(axis=0)
        cv = np.where(has_col & (colsum != 0),
                      cv * thr / np.where(colsum != 0, colsum, 1.0), cv)
        rowsum = (a * rv[:, None] * cv[None, :]).sum(axis=1)
        rv = np.where(has_row & (rowsum != 0),
                      rv * thr / np.where(rowsum != 0, rowsum, 1.0), rv)
        scaled = a * rv[:, None] * cv[None, :]
        # after the row update every nonempty row sums to thr exactly;
        # convergence is the COLUMN residual (both checked for safety)
        cerr = (np.abs(scaled.sum(axis=0)[has_col] - thr).max()
                if has_col.any() else 0.0)
        rerr = (np.abs(scaled.sum(axis=1)[has_row] - thr).max()
                if has_row.any() else 0.0)
        err = float(max(cerr, rerr))
        if not np.isfinite(err) or not np.all(np.isfinite(rv)) \
                or not np.all(np.isfinite(cv)):
            break                    # signed/degenerate input diverged
        if err < best[0]:
            best = (err, rv.copy(), cv.copy())
        if err <= 1e-6 * abs(thr):
            return ScaleCompanion(rv, cv)
    warnings.warn("scalesk did not converge; using best iterate "
                  f"(line-sum residual {best[0]:.3g})")
    return ScaleCompanion(best[1], best[2])


def scale_matrix(dense: DenseMatrix, sc: ScaleCompanion) -> DenseMatrix:
    a = dense.mat.astype(np.float64) * sc.r_v[:, None] * sc.c_v[None, :]
    return DenseMatrix(a, "double")


def unscale_permanent(permanent: float, sc: ScaleCompanion) -> float:
    """per(A) = per(diag(r) A diag(c)) / (prod r * prod c).

    Computed in log2 space: the direct product of 2n scale factors
    under/overflows double for large-magnitude matrices (found by
    fuzzing), zeroing the divisor.  The exponent is applied exactly with
    ldexp; only the fractional factor (in [1, 2)) is divided normally."""
    lp = float(sc.log2_product())
    e = int(np.floor(lp))
    frac = np.exp2(np.float64(lp - e))          # in [1, 2)
    with np.errstate(over="ignore"):
        return float(np.ldexp(np.float64(permanent)
                              * sc.sign_product() / frac, -e))
