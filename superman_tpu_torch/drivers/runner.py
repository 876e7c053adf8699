"""Orchestration: dispatch a (matrix, flags) pair to an engine.

Port of ``superman_tpu/drivers/runner.py``: the exact engine
(ops/ryser.py), dense and sparse (sparse=True, a SkipPer id, or by itself
on clearly sparse matrices), in the df64, f32, f32k, tf96 and f64 tiers
and the host's quad; the Glynn engine (ops/glynn.py,
perman_algo="glynn") in the same tiers; the modular CRT exact engine
(ops/exact.py, calc="exact"); the accuracy-adaptive ladder over them
(calc="auto"); the transform drivers around them (Sinkhorn scaling,
compression, Dulmage-Mendelsohn pruning) with the sanity net that
certifies a transformed pipeline's value with the exact engine; and the
Monte-Carlo estimators (ops/approx.py).  Every engine runs on one device
or over a mesh (parallel/mesh.py: mesh_shape, or a multi-device algorithm
id), and the exact walk also through the hybrid scheduler with a
checkpoint journal (parallel/scheduler.py); cpu=True and calc="quad" go to
the native CPU engine (bindings/native.py) wherever it builds, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.flags import Flags, id_behavior
from ..core.matrix import DenseMatrix
from ..core.result import Result
from ..utils import trace


def run(dense: DenseMatrix, flags: Flags, device: torch.device) -> Result:
    # resolve the reference algorithm id up front (the same table as the
    # CLI); unknown ids raise here
    beh = id_behavior(flags.perman_algo, flags.sparse, flags.approximation)
    # never mutate the caller's Flags: resolve into a private copy
    upd = {}
    if beh["sparse"] and not flags.sparse:
        upd["sparse"], upd["dense"] = True, False
    if beh["hybrid"] and not flags.hybrid:
        upd["hybrid"] = True
    if flags.approximation and flags.perman_algo != beh["algo"]:
        upd["perman_algo"] = beh["algo"]
    if upd:
        flags = dataclasses.replace(flags, **upd)
    # calc="exact": modular-CRT integer permanent (ops/exact.py).  It
    # folds degree-1/2 lines in exact bigint arithmetic itself and must
    # not run under the scaling or compression drivers (those round in
    # f64), so it is routed before their guards.
    if flags.resolved_calc() == "exact" and not flags.approximation:
        from ..ops.exact import perman_exact
        return perman_exact(dense, flags, device)
    # transform drivers wrap the core run, in the reference's order: the
    # scale driver may call compression, which recurses back here
    if flags.scaling_threshold != -1.0:
        from .scale_driver import scale_and_calculate
        res = scale_and_calculate(dense, flags, device)
        return _compression_sanity(dense, flags, res, device)
    if flags.compression:
        from .compress_driver import compress_singleton_and_then_recurse
        res = compress_singleton_and_then_recurse(dense, flags, device)
        return _compression_sanity(dense, flags, res, device)
    return run_algo(dense, flags, device)


#: (n, hash(bytes)) -> (Fraction, meta): exact certifications are
#: deterministic and cost up to 5 s each, and serving loops call
#: permanent() on the same matrix again and again
_CERT_CACHE: dict = {}
#: the certification runs where the exact engine's price on the device
#: fits this many seconds
CERT_BUDGET_S = 5.0
#: a certified pipeline value further than this from the exact one is
#: replaced by it: the double-class limit (df64's at n=32).  The JAX
#: package keeps values up to 1e-6 off (superman_tpu/drivers/runner.py:
#: 133); d34 splits can leave cores whose walks lose that much where the
#: matrix itself walks to 1e-13 (chip_smoke.py's sparse n=40 matrix: two
#: of its 24 cores sit 2^41 above their permanents, and the pipeline came
#: out 5.6e-7 off), and with the exact value in hand the port returns it
CERT_REL_TOL = 1e-9


def _exact_engine(flags: Flags):
    """The exact CRT engine that `flags` name: "native" under cpu=True
    without gpu (as ops.exact.perman_exact chooses), else None (the Z_p
    walk on the device)."""
    return "native" if (flags.cpu and not flags.gpu) else None


def _compression_sanity(dense: DenseMatrix, flags: Flags, res: Result,
                        device: torch.device) -> Result:
    """Bail out of a numerically broken compression or scaling pipeline.

    d2 merges multiply entries; the compressed matrix (and a Sinkhorn
    rescale of it) can be cancellation-catastrophic, needing 300+ bits
    where the ORIGINAL matrix walks fine.  Compression preserves the
    permanent exactly, so:

    * where the exact CRT engine is cheap on `device` (its price fits
      CERT_BUDGET_S), it certifies the pipeline's value or, further than
      CERT_REL_TOL from the exact one, replaces it.
      The JAX package certifies a core of n > 16 only with its native
      library; here the device walks every core (K3 on a card), so the
      gate is the price alone, as for calc="auto"'s exact rung.  Under
      cpu=True (without gpu) the native CPU engine prices and runs it,
      as perman_exact does;
    * otherwise the result must sit within 60 bits of the original
      matrix's magnitude estimate, else the direct engine runs again on
      the uncompressed matrix (n <= 42) or the result is flagged.
    """
    from ..ops.ryser import _log2_perm_estimate

    if flags.approximation:
        return res                       # estimates carry their own stderr
    a = np.asarray(dense.mat, dtype=np.float64)
    p = res.permanent
    # the f32 tiers would always miss a df64-class agreement band: keep
    # only the magnitude alarm for them, never replace the requested tier
    double_class = flags.resolved_calc() not in ("f32", "f32k")

    if a.shape[0] <= 100 and double_class:
        from ..ops.exact import (_float_of_fraction, exact_cost_estimate,
                                 perman_exact_fraction)
        engine = _exact_engine(flags)
        try:
            secs, _, _ = exact_cost_estimate(a, device,
                                             budget_s=CERT_BUDGET_S,
                                             engine=engine)
        except (OverflowError, ValueError):     # entries not finite
            secs = float("inf")
        if secs < CERT_BUDGET_S:
            key = (a.shape[0], hash(a.tobytes()), engine)
            hit = _CERT_CACHE.get(key)
            if hit is not None:
                frac, emeta = hit
                emeta = {**emeta, "wall_s": 0.0}
            else:
                frac, emeta = perman_exact_fraction(
                    a, device, threads=flags.threads, engine=engine)
                if len(_CERT_CACHE) >= 16:
                    _CERT_CACHE.pop(next(iter(_CERT_CACHE)))
                _CERT_CACHE[key] = (frac, emeta)
            ev = _float_of_fraction(frac)
            rel = (abs(p - ev) / abs(ev) if ev and np.isfinite(ev)
                   else (0.0 if p == ev else np.inf))
            if not np.isfinite(p) or rel > CERT_REL_TOL:
                trace.log(
                    "compression pipeline is cancellation-bound "
                    f"(rel error {rel:.1e} vs exact CRT); returning the "
                    f"exact value (core n={emeta['core_n']}, "
                    f"{emeta['wall_s']:.2f} s)", level=1)
                out = Result(ev, res.time + emeta["wall_s"],
                             algo_name="exact_crt",
                             iterations=res.iterations)
                out.meta["compression_bailout"] = "exact_crt"
                out.meta["exact_fraction"] = frac
                out.meta["replaced"] = {"value": p,
                                        "algo": res.algo_name}
                return out
            res.meta["exact_certified_rel"] = float(f"{rel:.2e}")
            return res

    est = _log2_perm_estimate(np.abs(a))
    suspicious = not np.isfinite(p)
    if not suspicious and est is not None and np.isfinite(est) and p != 0:
        suspicious = abs(float(np.log2(abs(p))) - est) > 60.0
    if not suspicious:
        return res
    if a.shape[0] > 42:
        # direct dense is infeasible here and exact was not cheap:
        # surface the suspicion instead of silently hanging
        trace.log("compression result fails the magnitude sanity check "
                  "but the matrix is too large for a direct re-run; "
                  "flagging compression_suspect", level=1)
        res.meta["compression_suspect"] = True
        return res
    trace.log("compression result fails the magnitude sanity check; "
              "re-running the direct engine on the uncompressed matrix",
              level=1)
    direct = run_algo(dense, dataclasses.replace(flags, compression=False),
                      device)
    direct.meta["compression_bailout"] = True
    return direct


def run_algo(dense: DenseMatrix, flags: Flags, device: torch.device) -> Result:
    if flags.approximation:
        from ..ops.approx import approximate
        return approximate(dense, flags, device)
    calc = flags.resolved_calc()
    # calc="quad" has no tier on the card (the reference's -q runs its
    # __float128 CPU algorithms): it goes to the parallel native engine
    # wherever that builds, and so does cpu=True; the host long-double walk
    # of ryser_exact is the fallback without one
    quad = calc == "quad"
    native_ok = True
    if quad and np.asarray(dense.mat).dtype == np.longdouble:
        a = np.asarray(dense.mat)
        # long-double storage (-v): the native ABI takes f64 matrices, so
        # only values that are exact in f64 go through it; otherwise the
        # host long-double walk keeps the storage bits
        native_ok = bool(np.all(
            a.astype(np.float64).astype(np.longdouble) == a))
    from ..prep.orderings import apply_preprocessing
    if ((flags.cpu and not flags.gpu) or quad) and native_ok:
        from ..bindings.native import native_available, perman_native
        if native_available():
            dm = apply_preprocessing(dense, flags.preprocessing) \
                if flags.sparse else dense
            return perman_native(dm, flags)
    if flags.dm_prune:
        from ..prep.dulmage_mendelsohn import dm_prune
        pruned = dm_prune(np.asarray(dense.mat))
        if pruned is None:
            return Result(0.0, 0.0, algo_name="dm_structural_zero")
        dense = DenseMatrix(pruned, dense.type)
    dm = apply_preprocessing(dense, flags.preprocessing) \
        if flags.sparse else dense
    from ..parallel.mesh import mesh_for_flags
    mesh = mesh_for_flags(flags, device)

    if calc == "auto":
        return _run_auto(dm, flags, device, mesh)

    if str(flags.perman_algo) == "glynn":
        # independent second exact engine (cross-algorithm oracle)
        from ..ops.glynn import glynn_exact
        res = glynn_exact(dm, flags, device, mesh=mesh)
        flags.algo_name = res.algo_name
        return res

    # dead-chunk pruning (the SkipPer of the chunked walk) happens inside
    # ryser_exact, which owns the chunk plan
    from ..ops.ryser import ryser_exact
    res = ryser_exact(dm, flags, device, mesh=mesh)
    if flags.sparse:
        res.algo_name = res.algo_name.replace("ryser", "sparyser")
    flags.algo_name = res.algo_name
    return res


def _amp_probe_log2(a: np.ndarray, samples: int = 256,
                    seed: int = 0xA3) -> float:
    """log2 of (an estimate of) sum_m |prod_i x_i(m)| over the Ryser walk.

    Monte-Carlo cancellation-amplitude probe: sample random Gray indices
    m, evaluate log2|prod_i x_i(m)| exactly on the host (O(n^2) each),
    and scale the sample mean |term| by the 2^(n-1) index count.  The
    ratio of this to |per| is the walk's error AMPLIFICATION, which the
    f32k/df64 difference under-measures when per-term rounding errors
    are correlated across lanes (degenerate matrices); this probe
    measures the amplitude itself, so correlation cannot hide it.
    Heavy-tailed term distributions bias the sample
    mean low, so callers should keep a few bits of slack.
    """
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    rng = np.random.default_rng(seed)
    x0 = a[:, -1] - a.sum(axis=1) / 2.0
    cols = a[:, : n - 1]                                 # (n, n-1)
    m = rng.integers(0, 1 << (n - 1), size=samples, dtype=np.uint64)
    g = m ^ (m >> np.uint64(1))
    bits = ((g[:, None] >> np.arange(n - 1, dtype=np.uint64)) &
            np.uint64(1)).astype(np.float64)             # (S, n-1)
    x = x0[None, :] + bits @ cols.T                      # (S, n)
    with np.errstate(divide="ignore"):
        logt = np.where(np.all(x != 0, axis=1),
                        np.log2(np.abs(x)).sum(axis=1), -np.inf)
    finite = logt[np.isfinite(logt)]
    if finite.size == 0:
        return -np.inf
    mx = float(finite.max())
    log_mean = mx + float(np.log2(np.exp2(finite - mx).sum() / samples))
    return log_mean + (n - 1)


def _cond_probe_log2(a: np.ndarray, samples: int = 256,
                     seed: int = 0xA3) -> float:
    """log2 of (an estimate of) the WITHIN-LINE conditioned amplitude
    sum_m sum_i S_i * prod_{j!=i} |x_j(m)| over the Ryser walk, with
    S_i = |x0_i| + sum_k |col_k(i)| (row i's x-amplitude bound).

    The walk's x-vector carries absolute rounding error ~S_i * 2^-m_x
    per row (m_x = the x-update mantissa: 48 for the df64 pair, absent
    only on exact-f32 integer storage); a line passing near zero
    mid-walk turns that into per-term error prod_{j!=i}|x_j| * S_i *
    2^-m_x — invisible to the plain amplitude probe (measured 2^27
    under-prediction on pores_1_r).  Same sampling
    (and the same heavy-tail low bias — callers keep slack) as
    _amp_probe_log2; rows are clamped at S_i * 2^-50 so a line AT zero
    still contributes its residual error term.
    """
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    rng = np.random.default_rng(seed)
    x0 = a[:, -1] - a.sum(axis=1) / 2.0
    cols = a[:, : n - 1]                                 # (n, n-1)
    S = np.abs(x0) + np.abs(cols).sum(axis=1)
    if not np.all(S > 0):
        return float("-inf")                             # empty row
    m = rng.integers(0, 1 << (n - 1), size=samples, dtype=np.uint64)
    g = m ^ (m >> np.uint64(1))
    bits = ((g[:, None] >> np.arange(n - 1, dtype=np.uint64)) &
            np.uint64(1)).astype(np.float64)             # (S, n-1)
    x = x0[None, :] + bits @ cols.T                      # (S, n)
    axc = np.maximum(np.abs(x), S[None, :] * 2.0 ** -50)
    logc = (np.log2(axc).sum(axis=1)
            + np.log2((S[None, :] / axc).sum(axis=1)))
    finite = logc[np.isfinite(logc)]
    if finite.size == 0:
        return float("-inf")
    mx = float(finite.max())
    log_mean = mx + float(np.log2(np.exp2(finite - mx).sum() / samples))
    return log_mean + (n - 1)


def _run_auto(dm: DenseMatrix, flags: Flags, device: torch.device,
              mesh=None) -> Result:
    """Accuracy-adaptive calc (calc="auto", target ~1e-9 relative).

    The f32k and df64 tiers share the same error AMPLIFICATION (the
    cancellation ratio sum|term| / |sum term|); their difference measures
    f32k's realized error (~amp * 2^-24), which predicts df64's
    (~amp * 2^-48).  When the prediction exceeds the target, escalate:
    tf96 (~amp * 2^-70) where the tier is REAL — integer-exact storage
    (f32-exact x updates) or the n < 19 host long-double walk — and the
    exact CRT engine otherwise / beyond.  The ladder, its constants and
    its decisions are the JAX package's, so both packages report the same
    rung on the same matrix; the card's df64 tier walks x in native double
    (2^-53, not the 2^-48 of an f32 pair), which the model's 48 bits only
    overstate.

    Two measured blind spots shape the model:
    * degenerate matrices correlate per-term rounding across lanes, so
      the f32k/df64 difference under-measures amplification — the
      direct amplitude probe (_amp_probe_log2) closes it;
    * real-valued (non-exact-storage) walks carry x as an f32 pair
      whose ~2^-48 update error is amplified by WITHIN-LINE
      cancellation (a line crossing zero mid-walk) beyond the plain
      amplitude — the conditioned probe/walk (_cond_probe_log2,
      ops/ryser.amp_cond_walk_log2) closes that (pores_1_r once
      self-reported 3.9e-6 against a true 3.2e9).
      On such matrices tf96 would silently fall back to df64 inside
      ryser_exact (its product tree needs exact-f32 x), so the float
      ladder STOPS at df64 and escalation goes straight to exact.
    """
    from ..ops.ryser import ryser_exact, _exact_storage

    TARGET = float(flags.auto_target)
    n = int(dm.mat.shape[0])
    exactish = n < 19 or _exact_storage(dm)
    res = ryser_exact(dm, dataclasses.replace(flags, calc="df64"), device,
                      mesh=mesh)
    scale = max(abs(res.permanent), 1e-300)
    # correlated-rounding guard: amplification measured directly.
    # amp_l2 can exceed 1000 bits (huge-entry cancellation-bound inputs
    # — the probe's whole reason to exist), where a bare 2.0**e would
    # raise OverflowError instead of escalating: saturate to inf.
    def _exp2_sat(e: float) -> float:
        return math.inf if e > 1023.0 else 2.0 ** e

    a64 = np.asarray(dm.mat, dtype=np.float64)
    lscale = float(np.log2(scale))
    amp_l2 = _amp_probe_log2(a64) - lscale
    # stat_l2: the l2 statistic that prices the df64 walk — the plain
    # amplitude on exactish storage (x updates exact), the conditioned
    # amplitude otherwise (x-pair update error dominates)
    stat_l2 = amp_l2
    if not exactish and np.isfinite(amp_l2):
        cw = _cond_probe_log2(a64)
        stat_l2 = max(amp_l2, cw - lscale) if np.isfinite(cw) else amp_l2
    probe_err = _exp2_sat(stat_l2 - 48.0) if np.isfinite(stat_l2) else 0.0
    # happy path: the probe alone predicts
    # df64's error; when it sits 3+ bits under the target the f32k
    # companion walk (the other ~1x of walk cost) cannot change the
    # decision — skip it.  The probe's heavy-tail low bias is why the
    # margin is TARGET/8, not TARGET; escalation candidates always run
    # the companion measurement.  A NON-FINITE amp (every probe sample
    # hit a zero factor -> -inf, or a term overflowed f64 -> +inf) is a
    # FAILED measurement, not a zero-error prediction — such inputs must
    # fall through to the companion walk that drove escalation before
    # this fast path existed.
    if np.isfinite(stat_l2) and probe_err < TARGET / 8.0:
        res.meta["auto"] = {"escalated": None,
                            "df64_err_est": float(f"{probe_err:.2e}"),
                            "err_est": float(f"{probe_err:.2e}"),
                            "probe_only": True}
        return res
    fast = ryser_exact(dm, dataclasses.replace(flags, calc="f32k"), device,
                       mesh=mesh)
    diff_rel = abs(res.permanent - fast.permanent) / scale
    # f32k error ~ diff_rel; df64 error ~ diff_rel * 2^-24
    est_df64_err = max(diff_rel * 2.0 ** -24, probe_err)
    amp_walk_l2 = cond_walk_l2 = None
    if est_df64_err > TARGET and n <= 41:
        # escalation candidate: replace the SAMPLED statistics with the
        # EXACT amp+cond walk (ops/ryser.amp_cond_walk_log2, the amp
        # tier of the walk kernel).  The sampled probe's heavy-tail bias
        # measured 55 bits low on pores_1_r, which made the
        # low-confidence bound below dishonest by 2^55.  n <= 41 is the
        # reference's limit for the full dense walk; larger cores keep
        # the sampled floor (documented bias).  A +inf walk
        # (unstabilizable after 4 shift retries — the most
        # cancellation-bound inputs) saturates the estimate to inf so
        # the ladder escalates conservatively, never falling back to the
        # known-dishonest sampled bound.
        from ..ops.ryser import amp_walk_log2, amp_cond_walk_log2
        if exactish:
            aw, cw = amp_walk_log2(a64, device), None
        else:
            aw, cw = amp_cond_walk_log2(a64, device)
        if aw == float("inf"):
            amp_l2 = stat_l2 = float("inf")
            est_df64_err = float("inf")
        elif np.isfinite(aw):
            amp_walk_l2 = aw - lscale
            amp_l2 = amp_walk_l2
            stat_l2 = amp_l2
            if cw is not None and np.isfinite(cw):
                cond_walk_l2 = cw - lscale
                stat_l2 = max(stat_l2, cond_walk_l2)
            est_df64_err = max(diff_rel * 2.0 ** -24,
                               _exp2_sat(stat_l2 - 48.0))
    if est_df64_err <= TARGET:
        res.meta["auto"] = {"escalated": None,
                            "df64_err_est": float(f"{est_df64_err:.2e}"),
                            "err_est": float(f"{est_df64_err:.2e}")}
        res.time += fast.time
        return res

    # ---- escalation: df64 is predicted to miss the target ----
    def _exact_price():
        """(seconds, feasible) of the exact CRT engine for this matrix —
        the ladder's last rung AND the price-of-truth attached to every
        flagged result.  The port always has a device to walk on, so
        the rung is feasible whenever its price on that device fits the
        budget."""
        from ..ops.exact import exact_cost_estimate
        budget = float(flags.auto_exact_budget_s)
        try:
            secs, _, _ = exact_cost_estimate(a64, device, budget_s=budget,
                                             engine=_exact_engine(flags))
        except Exception:
            secs = float("inf")
        return secs, secs < budget

    def _run_exact(est_tf96_err):
        from ..ops.exact import perman_exact
        ex = perman_exact(dm, flags, device)
        ex.meta["auto"] = {
            "escalated": "exact",
            "df64_err_est": float(f"{est_df64_err:.2e}"),
            "tf96_err_est": float(f"{est_tf96_err:.2e}")}
        ex.time += res.time + fast.time
        return ex

    # tf96's predicted error from the same amplification measurements
    # (eff. mantissa ~70 bits vs df64's ~48) — only where the tier is
    # real; on non-exactish storage there is NO float tier above df64
    if exactish:
        est_tf96_err = max(diff_rel * 2.0 ** -46,
                           _exp2_sat(amp_l2 - 70.0) if np.isfinite(amp_l2)
                           else 0.0)
    else:
        est_tf96_err = float("inf")
    exact_secs = None
    if est_tf96_err > TARGET:
        # the whole float ladder is predicted to miss: the last rung is
        # the exact CRT engine (real-matrix cancellation can sit 100s of
        # bits above ANY float tier — measured 2^280 on pores_1_r.mtx,
        # pinned in EXACT_KNOWN.jsonl) — when its price fits the budget.
        # Otherwise return the best float tier FLAGGED with its honest
        # bound and the price of truth: a self-reported error bound
        # beats silent noise.
        exact_secs, feasible = _exact_price()
        if feasible:
            return _run_exact(est_tf96_err)
    if not exactish:
        # no tf96 rung here: the df64 result IS the best float tier.
        # Its bound is already relative to its own magnitude.
        est_rep = est_df64_err
        res.meta["auto"] = {"escalated": None, "ladder": "df64_max",
                            "df64_err_est": float(f"{est_df64_err:.2e}"),
                            "err_est": float(f"{est_rep:.2e}")}
        if amp_walk_l2 is not None:
            res.meta["auto"]["amp_walk_l2"] = round(amp_walk_l2, 1)
        if cond_walk_l2 is not None:
            res.meta["auto"]["cond_walk_l2"] = round(cond_walk_l2, 1)
        if est_rep > TARGET:
            res.meta["auto"]["low_confidence"] = True
            if exact_secs is not None and np.isfinite(exact_secs):
                res.meta["auto"]["exact_feasible_s"] = round(exact_secs, 1)
        res.time += fast.time
        return res
    hi = ryser_exact(dm, dataclasses.replace(flags, calc="tf96"), device,
                     mesh=mesh)
    # The bound so far is relative to the DF64 result's magnitude.
    # On cancellation-bound inputs that scale is itself noise far
    # above both the truth and the tf96 result, so a bound left on
    # the df64 scale understates the error relative to the VALUE
    # BEING RETURNED by exactly |df64|/|tf96|.  Renormalize the
    # self-reported bound to the returned value.
    est_rep = est_tf96_err * scale / max(abs(hi.permanent), 1e-300)
    if est_rep > TARGET and exact_secs is None:
        # the renormalized bound can exceed the pre-walk df64-scale one
        # by orders; re-check the exact budget before returning a
        # flagged result the user could have had exactly
        exact_secs, feasible = _exact_price()
        if feasible:
            return _run_exact(est_tf96_err)
    hi.meta["auto"] = {"escalated": "tf96",
                       "df64_err_est": float(f"{est_df64_err:.2e}"),
                       "err_est": float(f"{est_rep:.2e}")}
    if amp_walk_l2 is not None:
        hi.meta["auto"]["amp_walk_l2"] = round(amp_walk_l2, 1)
    if est_rep > TARGET:
        hi.meta["auto"]["low_confidence"] = True
        if exact_secs is not None and np.isfinite(exact_secs):
            hi.meta["auto"]["exact_feasible_s"] = round(exact_secs, 1)
    hi.time += res.time + fast.time
    return hi
