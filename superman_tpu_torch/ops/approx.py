"""Monte-Carlo permanent estimators, batched over trials on the device.

Port of ``superman_tpu/ops/approx.py``.  Parity: rasmussen /
rasmussen_sparse (reference algo.h:269/171) and approximation_perman64
(algo.h:471) plus their GPU kernels (gpu_approximation_dense.cu:155-369),
and the JAX package's additions: the Gurvits/Glynn estimator for signed
matrices, the most-constrained-entity scaling step, and the SMC
population estimator with its scale-interval selector.

The JAX package vmaps one trial over a lane and scans its steps; here B
trials advance together.  A trial's state is a row of (B, n) tensors on
the device (column and row masks, residual degrees, Sinkhorn factors),
and each of the n steps is a few batched ops over all B rows: the
degree and Sinkhorn sums are (B, n) @ (n, n) products at full float32
(no TF32: a near-zero sum that flips sign flips a trial), the picks are
argmin / argmax / gather, and a `lax.cond` of the reference becomes
both branches and a `torch.where`.  The step index k is shared by the
whole batch, so the Sinkhorn gate (k % scale_intervals) and the
resampling gate (k % _EVERY) are Python branches.  The trial state is
float32 and the host accumulates in float64 and log2 space, as in the
reference; random numbers come from one torch.Generator seeded from
flags.seed (over a mesh, one per entry, seeded from the seed and the
entry's index), so they differ from jax.random's and the tests compare
distributions.  Over a mesh each batch's trials are dealt over the
entries (parallel/mesh.py); with hybrid=True and cpu=True a thread of the
native CPU engine takes trials from the same budget.

Both the per-trial and the population estimators return the mean of an
unbiased estimator of per(A); dead trials (a line ran out of partners)
contribute 0 and are counted like the reference's "number of zeros"
(algo.h:166).  Scaling intervals gate Sinkhorn on the step index, as the
reference's GPU kernel does (gpu_approximation_dense.cu:281).  Under
SUPERMAN_DEBUG_NANS (utils/debug.py) each trial function checks its
float outputs for NaN on the device before it returns them.

The scaling estimator first moves each row by an exact power of two in
steps of 2^ESTIMATOR_STEP (ryser_walk.walk_scales) and multiplies the
estimate and its stderr back by 2^E: the float32 trials cannot hold an
entry past a float32's range, where the reference (approx.py:465-,
634-) gives NaN.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
import time as _time

import numpy as np
import torch

from ..core.matrix import DenseMatrix
from ..core.result import Result
from ..utils.debug import check_nan
from .ryser_walk import times_pow2, walk_scales

#: log2 weight of a dead particle, and the log2 mean of an epoch in which
#: every particle died: a float32 stand-in for -inf whose sum over the
#: epochs drives the population's estimate to an effective 0
_NEG_INF = -1e30
#: the degree given to a matched row or column so that argmin skips it
_MATCHED = 1e9
#: SMC steps between two resamplings of a population
_EVERY = 8
#: the scale_intervals candidates of the SMC auto-selector
_SI_CANDIDATES = (2, 4)
#: trials the hybrid CPU worker takes from the budget at a time (the
#: reference's cpu_chunk)
_CPU_CHUNK = 50000
#: the scaling estimator's row exponents are multiples of this: a row
#: within 2^+-50 of 1 keeps its entries, so a matrix the float32 trials
#: hold draws the numbers it drew without scales, bit for bit (scaling
#: every row to 1 would not: the first Sinkhorn sweep's column sums add
#: rows of other scales, and float32 log2 rounds at its argument's
#: magnitude); native/perman_cpu.cpp's estimator takes the same step
ESTIMATOR_STEP = 100


def _times_pow2_l2(f, l2: float, E: int) -> float:
    """f(l2) * 2^E for f(l) = 2^l times a factor: f(l2) and an exact
    ldexp where f(l2) is a normal double (so the estimate of a matrix
    whose rows move by multiples of ESTIMATOR_STEP moves by exactly their
    sum), else f(l2 + E), taken in log space; +0.0, never -0.0."""
    with np.errstate(over="ignore"):
        v = float(f(l2))
        if E == 0 or (math.isfinite(v)
                      and abs(v) >= np.finfo(np.float64).tiny):
            return float(times_pow2(v, E))
        return float(f(l2 + E)) + 0.0


@contextlib.contextmanager
def _full_fp32():
    """float32 products at full float32 inside the block (no TF32 on a
    card, no reduced-precision passes on the host); the caller's setting
    comes back after it."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def _uniform_choice(w: torch.Tensor, u: torch.Tensor):
    """Per row of the weights w (B, n) >= 0: the first index whose
    cumulative weight exceeds u * total, its probability, and the total
    (0 marks the trial dead).  u (B,) is uniform in [0, 1); total is the
    cumulative sum's last entry, so u * total lies below it and the index
    exists whenever total > 0."""
    cum = torch.cumsum(w, 1)
    total = cum[:, -1]
    idx = (cum <= (u * total)[:, None]).sum(1).clamp_(max=w.shape[1] - 1)
    pj = (w.gather(1, idx[:, None])[:, 0]
          / torch.where(total > 0, total, torch.ones_like(total)))
    return idx, pj, total


def _rasmussen_trial(nz: torch.Tensor, B: int, gen: torch.Generator):
    """B Rasmussen trials on the 0/1 support nz (n, n) float32.
    Returns (log2 estimate (B,) float32, dead (B,) bool)."""
    n = nz.shape[0]
    dev = nz.device
    rows = torch.arange(B, device=dev)
    nzT = nz.t().contiguous()
    colm = torch.ones(B, n, device=dev)
    rowm = torch.ones(B, n, dtype=torch.bool, device=dev)
    nnz = nz.sum(1).expand(B, n).clone()
    logp = torch.zeros(B, device=dev)
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(n):
        # the min-nnz unextracted row (ties -> lowest index, as the
        # reference's)
        row = torch.where(rowm, nnz, _MATCHED).argmin(1)
        rn = nnz[rows, row]
        dead |= rn < 0.5
        logp += torch.log2(rn.clamp(min=1.0))
        # a uniform choice among the row's free columns
        valid = nz[row] * colm
        u = torch.rand(B, n, generator=gen, device=dev)
        col = torch.where(valid > 0, u, -1.0).argmax(1)
        colm[rows, col] = 0.0
        rowm[rows, row] = False
        nnz -= nzT[col]
    check_nan("_rasmussen_trial", logp)
    return logp, dead


def _gurvits_trial(a: torch.Tensor, x: torch.Tensor):
    """Gurvits/Glynn trials on an ARBITRARY-SIGN matrix a (n, n) float32
    at the draws x (B, n) float32.

    X(x) = prod_i (Ax)_i * prod_j x_j with iid zero-mean unit-variance
    x_j is an unbiased estimator of per(A) for any real matrix (Glynn's
    identity / Gurvits 2005: every non-permutation term of prod_i (Ax)_i
    leaves some x_j at an odd power, whose expectation vanishes).  The
    reference has no estimator for sign-indefinite input.

    (Ax) is a (B, n) @ (n, n) product at full float32.  Magnitudes come
    back in log2 (|X| reaches ~n^n), taken in float64 of the true float32
    values, with the sign apart; only an exact zero (Ax)_i or x_j makes a
    zero trial (sign 0).  The JAX package clamps a nonzero |y| and |x|
    at 1e-37 and keeps the sign (superman_tpu/ops/approx.py:128-129,
    137), which inflates such trials: a bias in an estimator meant to be
    unbiased, not copied here.

    Returns (log2 |prod (Ax)_i * prod x_j| (B,) float64, sign (B,) in
    {-1, 0, +1})."""
    y = x @ a.t()
    sgn = torch.sign(y).prod(1) * torch.sign(x).prod(1)
    logm = (torch.log2(y.double().abs()).sum(1)
            + torch.log2(x.double().abs()).sum(1))
    check_nan("_gurvits_trial", logm)    # a NaN sign comes with a NaN logm
    return logm, sgn


def _gurvits_draws(B: int, n: int, gen: torch.Generator,
                   device: torch.device, gaussian: bool) -> torch.Tensor:
    """x (B, n) float32: Gaussian, or Rademacher in {-1, +1}."""
    if gaussian:
        return torch.randn(B, n, generator=gen, device=device)
    u = torch.rand(B, n, generator=gen, device=device)
    return torch.where(u < 0.5, 1.0, -1.0)


def _scaling_step(k: int, u, colm, rowm, dr, dc, dead, a, aT, nz, nzT,
                  scale_intervals: int, scale_times: int):
    """One SIS matching step of B trials (shared by the per-trial
    estimator and the SMC population estimator): serve the most
    constrained entity, sample its partner from the Sinkhorn-scaled
    weights.  u (B,) is the step's uniform draw; colm, rowm (B, n) are
    float32 masks of the unmatched lines.  Returns the updated (colm,
    rowm, dr, dc, dead) and this step's log2 weight increment (B,).

    Beyond the reference (which consumes rows in a fixed order,
    algo.h:512): each step serves the minimum-residual-degree row OR
    column, whichever is tighter.  Any adapted choice of what to match
    next keeps sequential importance sampling unbiased, and serving
    endangered columns is what keeps large sparse instances (the 36x36
    grid graph) alive."""
    B = u.shape[0]
    rows = torch.arange(B, device=u.device)
    live_r, live_c = rowm > 0, colm > 0
    # residual degrees: (B, n) @ (n, n)
    rowdeg = colm @ nzT
    coldeg = rowm @ nz
    rmask = torch.where(live_r, rowdeg, _MATCHED)
    cmask = torch.where(live_c, coldeg, _MATCHED)
    # an isolated unmatched row or column can never be matched
    dead = (dead | ((rowdeg < 0.5) & live_r).any(1)
            | ((coldeg < 0.5) & live_c).any(1))
    row = rmask.argmin(1)
    col0 = cmask.argmin(1)

    # periodic Sinkhorn on the unextracted submatrix (the reference
    # stages these sums as per-thread loops,
    # gpu_approximation_dense.cu:281-324)
    if k % scale_intervals == 0:
        for _ in range(scale_times):
            colsum = ((dr * rowm) @ a) * colm
            dead = dead | ((colsum == 0) & live_c).any(1)
            dc = torch.where(live_c, 1.0 / torch.where(colsum > 0, colsum,
                                                       1.0), dc)
            rowsum = ((dc * colm) @ aT) * rowm
            dead = dead | ((rowsum == 0) & live_r).any(1)
            dr = torch.where(live_r, 1.0 / torch.where(rowsum > 0, rowsum,
                                                       1.0), dr)

    # the tighter of (min-degree row, min-degree column) picks which side
    # samples its partner from the scaled weights d_r[i] a[i, j] d_c[j]:
    # both sides' weights, one draw
    serve_col = cmask.amin(1) < rmask.amin(1)
    arow = a[row]
    acol = aT[col0]
    w_row = dr[rows, row][:, None] * arow * dc * colm
    w_col = dc[rows, col0][:, None] * acol * dr * rowm
    pick, pj, total = _uniform_choice(
        torch.where(serve_col[:, None], w_col, w_row), u)
    a_rc = torch.where(serve_col, acol[rows, pick], arow[rows, pick])
    r = torch.where(serve_col, pick, row)
    c = torch.where(serve_col, col0, pick)
    dead = dead | (total == 0)
    # X *= a[row, col] / pj.  The reference divides by pj only
    # (algo.h:551 `Xa /= pj`), which estimates the 0/1-pattern permanent
    # of a weighted matrix; the a factor makes it unbiased for weights
    # and changes nothing on binary input.
    dlogx = torch.log2(a_rc.clamp(min=1e-37)) - torch.log2(pj.clamp(min=1e-37))
    colm[rows, c] = 0.0
    rowm[rows, r] = 0.0
    return colm, rowm, dr, dc, dead, dlogx


def _scaling_trial(a, aT, nz, nzT, B: int, gen: torch.Generator,
                   scale_intervals: int, scale_times: int):
    """B Sinkhorn-scaling-guided trials (reference algo.h:471-566).
    Returns (log2 estimate (B,) float32, dead (B,) bool)."""
    n = a.shape[0]
    dev = a.device
    colm, rowm, dr, dc = (torch.ones(B, n, device=dev) for _ in range(4))
    logx = torch.zeros(B, device=dev)
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    for k in range(n):
        u = torch.rand(B, generator=gen, device=dev)
        colm, rowm, dr, dc, dead, dlogx = _scaling_step(
            k, u, colm, rowm, dr, dc, dead, a, aT, nz, nzT,
            scale_intervals, scale_times)
        logx += dlogx
    check_nan("_scaling_trial", logx)
    return logx, dead


def _smc_population(a, aT, nz, nzT, dr0, dc0, gen: torch.Generator, *,
                    scale_intervals: int, scale_times: int, B: int):
    """One SMC (sequential Monte Carlo) population of B particles.

    Plain SIS dies by attrition on large instances (36x36 grid graph:
    ~92% of trials dead by step 648).  SMC keeps the population alive:
    the particles advance together, and every _EVERY steps the
    population is RESAMPLED from its weight distribution (dead particles
    drop out, heavy ones split).  The product over epochs of the mean
    incremental weight is an unbiased estimator of per(A) (the SMC
    identity with multinomial resampling; Del Moral 2004).  Resampling is
    torch.multinomial on 2^(logw - max) with replacement; a population
    with no live particle keeps its state, as the reference's
    lax.cond(alive, ...) does (multinomial refuses all-zero weights, so
    it draws from uniform weights there and the draw is discarded).

    Returns (epoch log2 means (n,) float32, final logw (B,), final dead
    (B,)), on the device: log2 of the estimate = sum(epoch means) +
    log2(mean over B of 2^final_logw).
    """
    n = a.shape[0]
    dev = a.device
    colm = torch.ones(B, n, device=dev)
    rowm = torch.ones(B, n, device=dev)
    dr = dr0.expand(B, n).clone()
    dc = dc0.expand(B, n).clone()
    logw = torch.zeros(B, device=dev)
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    lmeans = torch.zeros(n, device=dev)
    log2_b = math.log2(B)
    for k in range(n):
        u = torch.rand(B, generator=gen, device=dev)
        colm, rowm, dr, dc, dead, dlogx = _scaling_step(
            k, u, colm, rowm, dr, dc, dead, a, aT, nz, nzT,
            scale_intervals, scale_times)
        logw = torch.where(dead, _NEG_INF, logw + dlogx)
        # resample at epoch boundaries (never on the very last step: the
        # final weights feed the closing mean directly)
        if k % _EVERY == _EVERY - 1 and k < n - 1:
            mx = logw.max()
            w = torch.where(dead, 0.0, torch.exp2(logw - mx))
            tot = w.sum()
            alive = tot > 0
            lmeans[k] = torch.where(
                alive, mx + torch.log2(tot.clamp(min=1e-37)) - log2_b,
                _NEG_INF)
            idx = torch.multinomial(torch.where(alive, w, 1.0), B,
                                    replacement=True, generator=gen)
            colm = torch.where(alive, colm[idx], colm)
            rowm = torch.where(alive, rowm[idx], rowm)
            dr = torch.where(alive, dr[idx], dr)
            dc = torch.where(alive, dc[idx], dc)
            dead = torch.where(alive, dead[idx], dead)
            logw = torch.where(alive, 0.0, logw)
    check_nan("_smc_population", lmeans)
    check_nan("_smc_population", logw)
    return lmeans, logw, dead


def _device_matrices(a: np.ndarray, device: torch.device):
    """(a, a^T, support, support^T) as float32 tensors on `device`."""
    at = torch.as_tensor(a, dtype=torch.float32, device=device)
    nz = (at != 0).float()
    return at, at.t().contiguous(), nz, nz.t().contiguous()


def smc_estimate(a: np.ndarray, flags, device: torch.device, *,
                 pops: int = 8, si: int = None) -> tuple:
    """per(A) by `pops` independent SMC populations; returns
    (est_log2_values list, zeros_fraction, particles_total).
    si overrides flags.scale_intervals (the auto-selector's candidates)."""
    from ..prep.scaling import scalesk
    if si is None:
        si = _si(flags)
    trials = int(flags.number_of_times)
    B = max(256, min(1 << 12, -(-trials // pops)))
    mats = _device_matrices(a, device)
    # warm start: the converged doubly-stochastic Sinkhorn scaling of the
    # FULL matrix, shared by all particles
    sc = scalesk(np.abs(a), 1.0, max_iters=200)
    dr0 = torch.as_tensor(np.abs(sc.r_v), dtype=torch.float32, device=device)
    dc0 = torch.as_tensor(np.abs(sc.c_v), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(flags.seed))
    logzs, dead_frac = [], []
    with _full_fp32():
        for _ in range(pops):
            lmeans, logw, dead = _smc_population(
                *mats, dr0, dc0, gen, scale_intervals=int(si),
                scale_times=int(flags.scale_times), B=B)
            lmeans = lmeans.double().cpu().numpy()
            logw = logw.double().cpu().numpy()
            dead = dead.cpu().numpy()
            lw = np.where(dead, -np.inf, logw)
            mx = float(np.max(lw))
            closing = (mx + np.log2(np.mean(np.exp2(lw - mx)))
                       if np.isfinite(mx) else -np.inf)
            # extinct epochs carry _NEG_INF (-1e30): the sum drives the
            # population's estimate to an effective 0, which is correct
            logzs.append(float(np.sum(lmeans)) + closing)
            dead_frac.append(float(dead.mean()))
    return logzs, float(np.mean(dead_frac)), B * pops


def _pop_stats(logzs):
    """(est_log2, stderr_rel) across a population list (linear-space
    mean, log2 reported; the same math as _approximate_smc)."""
    lz = np.asarray(logzs, np.float64)
    mx = float(np.max(lz))
    if not np.isfinite(mx):
        return -np.inf, 0.0
    zs = np.exp2(lz - mx)
    est_l2 = mx + float(np.log2(np.mean(zs)))
    sr = float(np.std(zs, ddof=1) / (np.mean(zs) * np.sqrt(len(zs))))
    return est_l2, sr


def _select_si(a: np.ndarray, flags, device: torch.device, pops: int):
    """Auto-select scale_intervals: run EVERY candidate at full
    population strength and keep the higher estimate.

    SIS/SMC degeneracy biases the LOG estimate downward (E[log Z] <=
    log E[Z], and the gap grows with weight degeneracy), so between two
    candidates unbiased in linear space the higher log2 estimate is the
    less biased one.  Short probes and "smaller cross-population stderr"
    both picked the worse candidate on the 36x36 grid in the JAX
    package's measurements; argmax over full runs did not.  The
    selection bias of max-of-two is absorbed by the winner's own
    cross-population sigma, which the caller reports.  Cost:
    len(_SI_CANDIDATES) full runs.

    Returns (winner_si, winner_logzs, winner_dead_frac, winner_total,
    meta).
    """
    stats = {}
    for c in _SI_CANDIDATES:
        logzs, dead_frac, total = smc_estimate(a, flags, device, pops=pops,
                                               si=c)
        stats[c] = (_pop_stats(logzs), logzs, dead_frac, total)
    win = max(_SI_CANDIDATES, key=lambda c: (np.isfinite(stats[c][0][0]),
                                    stats[c][0][0]))
    meta = {"candidates": {str(c): {"log2": round(s[0][0], 3),
                                    "stderr_rel": round(s[0][1], 4)}
                           for c, s in stats.items()},
            "picked": win, "rule": "argmax_full_run_log2"}
    _, logzs, dead_frac, total = stats[win]
    return win, logzs, dead_frac, total, meta


def _approximate_smc(a: np.ndarray, flags, device: torch.device,
                     scale_log2: int = 0) -> Result:
    """Driver for the SMC population estimator: K independent
    populations give the estimate AND an honest stderr across
    populations (each population's Z is itself unbiased).  `a` is the
    row-scaled matrix and 2^scale_log2 its scale: the estimate, its
    stderr and the log2 values are the unscaled matrix's."""
    t0 = _time.perf_counter()
    pops = 8
    si = int(flags.scale_intervals)
    si_meta = None
    if si <= 0:
        si, logzs, dead_frac, total, si_meta = _select_si(a, flags, device,
                                                          pops)
    else:
        logzs, dead_frac, total = smc_estimate(a, flags, device, pops=pops,
                                               si=si)
    lz = np.asarray(logzs, np.float64)
    mx = float(np.max(lz))
    if not np.isfinite(mx):
        est_l2, est, stderr, stderr_rel = -np.inf, 0.0, 0.0, 0.0
    else:
        zs = np.exp2(lz - mx)                     # O(1) values
        est_l2 = mx + float(np.log2(np.mean(zs)))
        # relative stderr is finite even when the estimate overflows f64
        stderr_rel = float(np.std(zs, ddof=1)
                           / (np.mean(zs) * np.sqrt(pops)))
        est = _times_pow2_l2(np.exp2, est_l2, scale_log2)
        stderr = _times_pow2_l2(
            lambda l2: np.exp2(l2) * np.std(zs, ddof=1) / np.sqrt(pops),
            mx, scale_log2)
    est_l2 += scale_log2
    lz = lz + scale_log2
    return Result(est, _time.perf_counter() - t0,
                  algo_name="approx_scaling_smc",
                  zeros=int(dead_frac * total),
                  iterations=total,
                  meta={"trials": total, "populations": pops,
                        "scale_intervals": si,
                        "scale_times": flags.scale_times,
                        "stderr": stderr, "stderr_rel": stderr_rel,
                        "log2_estimate": est_l2,
                        "pop_log2": [float(v) for v in lz],
                        "cpu_trials": 0,
                        **({"si_auto": si_meta} if si_meta else {})})


def _lse2(x: np.ndarray) -> float:
    """log2 of sum(2^x)."""
    m = float(np.max(x))
    return m + float(np.log2(np.sum(np.exp2(x - m))))


class _Entries:
    """Where a per-trial estimator's batches run: `device` alone, or each
    batch split over the entries of a mesh (parallel/mesh.py), each on its
    own stream with its own torch.Generator seeded from (seed, entry
    index), so the same seed and the same device list give the same
    value.  One device keeps one generator seeded from the seed."""

    def __init__(self, flags, device: torch.device, make, mesh=None):
        from ..parallel.mesh import mesh_for_flags
        self.mesh = mesh if mesh is not None else mesh_for_flags(flags,
                                                                 device)
        devs = [device] if self.mesh is None else list(self.mesh)
        self.gens, self.state = [], []
        for e, d in enumerate(devs):
            with self._on(e):
                g = torch.Generator(device=d)
                g.manual_seed(int(flags.seed) if self.mesh is None else
                              int(np.random.SeedSequence(
                                  (int(flags.seed), e)).generate_state(
                                      1, np.uint64)[0] >> np.uint64(1)))
                self.gens.append(g)
                self.state.append(make(d))
        self.devices = devs

    def __len__(self) -> int:
        return len(self.devices)

    def _on(self, e: int):
        return (contextlib.nullcontext() if self.mesh is None
                else self.mesh.on(e))

    def run(self, b: int, fn) -> list:
        """fn(state, b_e, gen, device) -> tuple of device tensors, for b
        trials dealt as evenly as the entries allow (the first b % k
        entries take one more); returns the host arrays of each output,
        the entries' trials one after another."""
        k = len(self)
        sizes = [b // k + (e < b % k) for e in range(k)]
        outs = []
        for e, b_e in enumerate(sizes):
            if b_e:
                with self._on(e):
                    outs.append(fn(self.state[e], b_e, self.gens[e],
                                   self.devices[e]))
        if self.mesh is not None:
            self.mesh.synchronize()
        host = []
        for e, out in enumerate(outs):
            with self._on(e):
                host.append([t.cpu().numpy() for t in out])
        return [np.concatenate(parts) for parts in zip(*host)]


def _approximate_gurvits(a: np.ndarray, flags, device: torch.device,
                         mesh=None) -> Result:
    """Driver for the Gurvits/Glynn signed estimator (_gurvits_trial).

    Exact power-of-2 row scaling first (the exact walk's invariant):
    per(A) = 2^scale_l2 * per(D A), so the float32 product sees |entries|
    <= 1 and |y_i| <= n.  The host keeps three f64 log2 accumulators
    (positive mass, negative mass, sum of squares), so estimates beyond
    f64 range stay finite in log space; stderr / stderr_rel are the
    honest self-assessment (a degenerate stderr_rel >> 1 is the truthful
    outcome on a cancelling signed matrix, never hidden).
    """
    t0 = _time.perf_counter()
    n = a.shape[0]
    rowmax = np.max(np.abs(a), axis=1)
    if np.any(rowmax == 0.0):
        # a zero row forces per(A) = 0 exactly
        return Result(0.0, _time.perf_counter() - t0,
                      algo_name="approx_gurvits", zeros=0, iterations=0,
                      meta={"trials": 0, "stderr": 0.0, "stderr_rel": 0.0,
                            "log2_estimate": -np.inf, "sign": 0.0,
                            "zero_row": True, "cpu_trials": 0})
    shift = np.floor(np.log2(rowmax))
    scale_l2 = float(np.sum(shift))
    a_scaled = a * np.exp2(-shift)[:, None]
    trials = int(flags.number_of_times)
    batch = min(trials, 1 << 13)
    dist = str(flags.gurvits_dist)
    gauss = dist == "gaussian"
    if dist == "auto":
        # the zero-atom probe on the host, as the JAX package makes it (the
        # same numpy draws, so the same decision): sparse signed rows
        # cancel (Ax)_i to exactly 0 for a constant fraction of the
        # Rademacher sign vectors; Gaussian x has no zero atom
        hr = np.random.default_rng(int(flags.seed))
        xs = hr.choice([-1.0, 1.0], size=(64, n))
        frac0 = float(np.mean(np.any((xs @ a.T) == 0.0, axis=1)))
        gauss = frac0 > 0.5
    entries = _Entries(flags, device, lambda d: torch.as_tensor(
        a_scaled, dtype=torch.float32, device=d), mesh)

    def trial(at, b, gen, dev):
        logm, sgn = _gurvits_trial(at, _gurvits_draws(b, n, gen, dev, gauss))
        return logm, sgn.double()

    NEG = np.float64(-np.inf)
    pos_l2 = neg_l2 = ssq_l2 = NEG
    zeros = done = 0
    with _full_fp32():
        while done < trials:
            b = min(batch, trials - done)
            logm, sgn = entries.run(b, trial)
            pos, neg = logm[sgn > 0], logm[sgn < 0]
            live = logm[sgn != 0]
            if pos.size:
                pos_l2 = np.logaddexp2(pos_l2, _lse2(pos))
            if neg.size:
                neg_l2 = np.logaddexp2(neg_l2, _lse2(neg))
            if live.size:
                ssq_l2 = np.logaddexp2(ssq_l2, _lse2(2.0 * live))
            zeros += int(np.sum(sgn == 0))
            done += b
    # signed combination: sum = 2^pos_l2 - 2^neg_l2, kept in log space
    hi, lo = max(pos_l2, neg_l2), min(pos_l2, neg_l2)
    sign = (0.0 if pos_l2 == neg_l2 else
            (1.0 if pos_l2 > neg_l2 else -1.0))
    if np.isfinite(hi):
        d = float(np.exp2(lo - hi)) if np.isfinite(lo) else 0.0
        sum_l2 = hi + (float(np.log2(1.0 - d)) if d < 1.0 else -np.inf)
    else:
        sum_l2 = -np.inf
    mean_l2 = sum_l2 - np.log2(done)           # log2 |mean|, row-scaled
    est_l2 = mean_l2 + scale_l2                # log2 |estimate of per|
    # stderr: var = (SSQ - N*mean^2)/N (SSQ >= N*mean^2 by Cauchy-
    # Schwarz, so the log-space difference is safe); stderr = sqrt(var/N)
    stderr_l2, stderr_rel = -np.inf, 0.0
    if np.isfinite(ssq_l2):
        gap = (np.log2(done) + 2.0 * mean_l2 - ssq_l2
               if np.isfinite(mean_l2) else -np.inf)
        v_l2 = ssq_l2 + (float(np.log2(1.0 - np.exp2(gap)))
                         if gap < 0.0 else -np.inf)
        stderr_l2 = 0.5 * v_l2 - np.log2(done)
        stderr_rel = (float(np.exp2(min(stderr_l2 - mean_l2, 1024)))
                      if np.isfinite(mean_l2) else np.inf)
    zero_atom = bool(done > 0 and zeros == done)
    if zero_atom:
        # every sampled value was the exact-zero atom: "0 +- 0" would be
        # a lie (the unsampled nonzero atoms carry all the mass)
        stderr_rel = float(np.inf)
    with np.errstate(over="ignore"):
        est = sign * float(np.exp2(min(est_l2, 1100))) + 0.0
        stderr = float(np.exp2(min(stderr_l2 + scale_l2, 1100))) + 0.0
    return Result(est, _time.perf_counter() - t0,
                  algo_name="approx_gurvits", zeros=zeros,
                  iterations=done,
                  meta={"trials": done, "stderr": stderr,
                        "stderr_rel": stderr_rel,
                        "log2_estimate": est_l2, "sign": sign,
                        "scale_log2": scale_l2,
                        "dist": "gaussian" if gauss else "rademacher",
                        **({"zero_atom": True} if zero_atom else {}),
                        "cpu_trials": 0})


def _si(flags) -> int:
    """Resolve scale_intervals: -1 (auto) means the SMC selector for
    the population estimator; the per-trial path resolves it to the
    reference default 4 (flags.h -y)."""
    v = int(flags.scale_intervals)
    return v if v > 0 else 4


def _run_batch(algo: str, mats, B: int, gen: torch.Generator, *,
               scale_intervals: int, scale_times: int):
    """B trials of the per-trial estimator `algo` on the device matrices
    (a, a^T, support, support^T): (log2 values (B,), dead (B,))."""
    a, aT, nz, nzT = mats
    if algo == "rasmussen":
        return _rasmussen_trial(nz, B, gen)
    return _scaling_trial(a, aT, nz, nzT, B, gen, scale_intervals,
                          scale_times)


def approximate(dense: DenseMatrix, flags, device: torch.device,
                mesh=None) -> Result:
    """The Monte-Carlo estimate of per(dense) by flags.perman_algo on
    `device`, over `mesh` (a parallel.mesh.Mesh) where one is given, else
    over the mesh the flags ask for (mesh_for_flags)."""
    a = np.asarray(dense.mat, dtype=np.float64)
    n = a.shape[0]
    algo = str(flags.perman_algo)
    algo = {"1": "rasmussen", "2": "scaling", "3": "rasmussen",
            "4": "scaling", "auto": "scaling"}.get(algo, algo)
    if algo not in ("rasmussen", "scaling", "gurvits"):
        raise ValueError(f"unknown approximation algorithm {flags.perman_algo}")
    if algo == "gurvits":
        # the signed-matrix estimator: its own driver, log-space signed
        # accumulation
        return _approximate_gurvits(a, flags, device, mesh)
    if algo == "rasmussen" and not np.all(np.isin(a[a != 0], [1])):
        # reference: "This algorithm only works for binary matrices"
        a = (a != 0).astype(np.float64)
    E = 0
    if algo == "scaling":
        s = walk_scales(a, step=ESTIMATOR_STEP)
        a, E = np.ldexp(a, -s[:, None]), int(s.sum())

    # SMC population estimator for large instances (smc: -1 engages at
    # n >= 64, where SIS attrition wastes most trials; 1 always; 0 never)
    smc_mode = int(flags.smc)
    if algo == "scaling" and (smc_mode == 1 or (smc_mode == -1 and n >= 64)):
        return _approximate_smc(a, flags, device, E)

    t0 = _time.perf_counter()
    trials = int(flags.number_of_times)
    batch = min(trials, 1 << 14)
    entries = _Entries(flags, device, lambda d: _device_matrices(a, d),
                       mesh)
    si, st = _si(flags), int(flags.scale_times)

    def trial(mats, b, gen, dev):
        return _run_batch(algo, mats, b, gen, scale_intervals=si,
                          scale_times=st)

    # the hybrid CPU worker (reference _multigpucpu_chunks estimators,
    # gpu_approximation_dense.cu:411-524, cpu_chunk = 50000): a thread of
    # native-engine trials and the device loop below take their trials
    # from ONE shared budget, so exactly `trials` trials run in all
    budget = {"left": trials}
    budget_lock = threading.Lock()

    def take(k: int) -> int:
        with budget_lock:
            t = min(k, budget["left"])
            budget["left"] -= t
            return t

    cpu_state = {"sum": 0.0, "trials": 0, "zeros": 0}
    cpu_thread = None
    if flags.hybrid and flags.cpu:
        from ..bindings.native import load, native_available
        if native_available():
            lib = load()
            an = np.ascontiguousarray(a)

            def cpu_worker():
                seed = int(flags.seed) + 777
                while True:
                    t = take(_CPU_CHUNK)
                    if t == 0:
                        return
                    z = ctypes.c_double(0.0)
                    if algo == "rasmussen":
                        m = lib.sup_rasmussen(an, n, t, int(flags.threads),
                                              seed, ctypes.byref(z))
                    else:
                        m = lib.sup_approx_scaling(
                            an, n, t, si, st, int(flags.threads), seed,
                            ctypes.byref(z))
                    cpu_state["sum"] += m * t
                    cpu_state["trials"] += t
                    cpu_state["zeros"] += int(z.value)
                    seed += 1

            cpu_thread = threading.Thread(target=cpu_worker,
                                          name="approx-cpu")
            cpu_thread.start()
    # log2-space accumulation: grid-scale estimates (36x36 -> counts
    # ~2^530) overflow float64 sums of squares; the reference's double
    # accumulators simply overflow there
    NEG = np.float64(-np.inf)
    total_l2 = NEG            # log2 of the sum of trial values
    ssq_l2 = NEG              # log2 of the sum of squared trial values
    zeros = done = 0
    try:
        with _full_fp32():
            while True:
                b = take(batch)
                if b == 0:
                    break
                logs, dead = entries.run(b, trial)
                alive = logs[~dead].astype(np.float64)
                if alive.size:
                    total_l2 = np.logaddexp2(total_l2, _lse2(alive))
                    ssq_l2 = np.logaddexp2(ssq_l2, _lse2(2.0 * alive))
                zeros += int(dead.sum())
                done += b
    except BaseException:
        # a failed device batch fails the run: the CPU worker stops at its
        # next chunk instead of finishing the budget on the host
        take(trials)
        if cpu_thread is not None:
            cpu_thread.join()
        raise
    n_dev, dev_total_l2 = done, total_l2    # the stderr's basis
    if cpu_thread is not None:
        cpu_thread.join()
        if cpu_state["sum"] > 0:
            total_l2 = np.logaddexp2(total_l2, np.log2(cpu_state["sum"]))
        done += cpu_state["trials"]
        zeros += cpu_state["zeros"]
    # est = 2^total_l2 / done; beyond-f64 results become the honest inf
    est = _times_pow2_l2(np.exp2, total_l2 - np.log2(done), E) \
        if done else 0.0
    # standard error of the MC mean (the reference reports only the
    # mean; X_i are iid, so stderr = sqrt(var/N)).  The CPU worker's
    # chunks report only their means, so the stderr covers the device's
    # trials
    stderr = None
    if n_dev > 1 and np.isfinite(dev_total_l2):
        mean_l2 = dev_total_l2 - np.log2(n_dev)
        # S2/mean^2 = 2^(ssq_l2 - 2 mean_l2); var = (S2 - N mean^2)/N
        ratio = float(np.exp2(min(ssq_l2 - 2.0 * mean_l2, 1024)))
        rel_var = max(ratio - n_dev, 0.0) / n_dev
        stderr = _times_pow2_l2(
            lambda l2: np.exp2(l2) * np.sqrt(rel_var / n_dev), mean_l2, E)
    name = f"approx_{algo}" + ("_hybrid" if cpu_thread is not None else "")
    return Result(est, _time.perf_counter() - t0,
                  algo_name=name, zeros=zeros,
                  iterations=done,
                  meta={"trials": done, "scale_intervals": si,
                        "scale_times": flags.scale_times,
                        "stderr": stderr,
                        "cpu_trials": cpu_state["trials"]})
