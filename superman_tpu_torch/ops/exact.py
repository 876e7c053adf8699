"""Exact permanent via modular CRT -- the arbiter of last resort.

Port of ``superman_tpu/ops/exact.py``.  Every fixed-precision engine
computes the Ryser sum with an error of ~``amp * 2^-mantissa`` where
``amp`` is the cancellation amplitude ``sum_m |term_m| / |per|``.  Real
matrices can push ``amp`` past 2^280, where every such engine returns
noise.

This engine is immune by construction: an f64 matrix is exactly
``M / 2^k`` for an integer matrix M (dyadic rationals), and ``per(M)``
is computed EXACTLY as an integer via the Nijenhuis-Wilf walk in Z_p
over enough primes plus Chinese remaindering.  One extra held-out prime
verifies the reconstruction end to end, so a kernel bug cannot produce
a silently wrong value.  The walks run on the card through the Z_p
kernel (ops/modp.py, csrc/modp_walk.cu) at 31-bit primes; the CPU runs
the kernel's plain version.  engine="native" (and cpu=True) walks 61-bit
primes with the native CPU engine instead (bindings/native.py).

Degree-1 and degree-2 lines are folded exactly in bigint arithmetic
first.
"""

from __future__ import annotations

import math
import time
from fractions import Fraction
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import trace

#: the host walk's primes live just under 2^61: sums x + c < 2^62 stay
#: clear of u64, and ~61 bits/prime keeps the CRT prime count minimal
_PRIME_CEIL = (1 << 61) - 1

_SMALL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def _is_prime_u64(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 2^64 (fixed witness set)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _SMALL_PRIMES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def primes_desc(count: int, start: int = _PRIME_CEIL) -> List[int]:
    out, c = [], start | 1
    while len(out) < count:
        if _is_prime_u64(c):
            out.append(c)
        c -= 2
    return out


def dyadic_int_matrix(a: np.ndarray) -> Tuple[List[List[int]], int]:
    """Exact (M, k) with a == M / 2^k elementwise (f64s are dyadic)."""
    rows = []
    k = 0
    ratios = [[float(v).as_integer_ratio() for v in row]
              for row in np.asarray(a, dtype=np.float64).tolist()]
    for row in ratios:
        for _, den in row:
            k = max(k, den.bit_length() - 1)   # den is a power of two
    for row in ratios:
        rows.append([num << (k - (den.bit_length() - 1))
                     for num, den in row])
    return rows, k


def _fold_lines(m: List[List[int]]) -> Tuple[List[List[int]], int]:
    """Exactly fold degree-1 AND degree-2 lines: per(M) = mult * per(core).

    d1: a single-support line contributes its entry as a factor.  d2: a
    2-support row (entries a@j1, b@j2) folds by column multilinearity
    into one merged column a*col_j2 + b*col_j1 -- exact here in bigints,
    where f64 merges would round.  Columns fold by transpose symmetry.
    Entry bit-lengths grow under d2 merges; the CRT prime count scales
    with the bound, so exactness is never at risk.
    """
    mult = 1
    while m:
        n = len(m)
        deg_r = [sum(1 for v in row if v) for row in m]
        deg_c = [sum(1 for row in m if row[j]) for j in range(n)]
        if 0 in deg_r or 0 in deg_c:
            return [], 0                       # structural zero
        if 1 in deg_r:
            i = deg_r.index(1)
            j = next(jj for jj, v in enumerate(m[i]) if v)
        elif 1 in deg_c:
            j = deg_c.index(1)
            i = next(ii for ii in range(n) if m[ii][j])
        elif 2 in deg_r:
            i = deg_r.index(2)
            j1, j2 = (jj for jj, v in enumerate(m[i]) if v)
            a, b = m[i][j1], m[i][j2]
            m = [[v for jj, v in enumerate(row) if jj not in (j1, j2)]
                 + [a * row[j2] + b * row[j1]]
                 for ii, row in enumerate(m) if ii != i]
            continue
        elif 2 in deg_c:
            j = deg_c.index(2)
            i1, i2 = (ii for ii in range(n) if m[ii][j])
            a, b = m[i1][j], m[i2][j]
            merged = [a * v2 + b * v1 for v1, v2 in zip(
                (v for jj, v in enumerate(m[i1]) if jj != j),
                (v for jj, v in enumerate(m[i2]) if jj != j))]
            m = [[v for jj, v in enumerate(row) if jj != j]
                 for ii, row in enumerate(m) if ii not in (i1, i2)]
            m.append(merged)
            continue
        else:
            break
        mult *= m[i][j]
        m = [[v for jj, v in enumerate(row) if jj != j]
             for ii, row in enumerate(m) if ii != i]
    return m, mult


def _perman_bigint_dfs(m: List[List[int]]) -> int:
    """Exact DFS permanent on a small bigint matrix (host fallback)."""
    n = len(m)
    rows = [[(j, row[j]) for j in range(n) if row[j]] for row in m]
    order = sorted(range(n), key=lambda i: len(rows[i]))

    def rec(level: int, used: int) -> int:
        if level == n:
            return 1
        tot = 0
        for j, v in rows[order[level]]:
            if not (used >> j) & 1:
                sub = rec(level + 1, used | (1 << j))
                if sub:
                    tot += v * sub
        return tot

    return rec(0, 0)


def _perman_mod_host(m: List[List[int]], p: int) -> int:
    """Pure-Python Z_p Nijenhuis-Wilf walk: the engine="host" walk and
    the kernel's unit-test twin; practical to n ~ 20."""
    n = len(m)
    if n == 0:
        return 1 % p
    if n == 1:
        return m[0][0] % p
    inv2 = (p + 1) // 2
    x = [(m[j][n - 1] - sum(m[j]) * inv2) % p for j in range(n)]
    colp = [[m[j][k] % p for j in range(n)] for k in range(n - 1)]
    colm = [[(p - v) % p for v in col] for col in colp]
    acc = 1
    for v in x:
        acc = acc * v % p
    for i in range(1, 1 << (n - 1)):
        k = (i & -i).bit_length() - 1
        g = i ^ (i >> 1)
        c = colp[k] if (g >> k) & 1 else colm[k]
        prod = 1
        for j in range(n):
            xv = x[j] + c[j]
            if xv >= p:
                xv -= p
            x[j] = xv
            prod = prod * xv % p
        acc = (acc - prod if i & 1 else acc + prod) % p
    acc = acc * 2 % p
    if not n & 1:
        acc = (-acc) % p
    return acc


def _log2_bound(m: List[List[int]]) -> float:
    """log2 upper bound on |per(M)|.

    Base: the row-sum bound prod_i sum_j |M_ij| in BOTH orientations
    (per(M) = per(M^T)), taking the smaller.  For 0/1 matrices it is
    tightened to Bregman-Minc  per(A) <= prod_i (r_i!)^(1/r_i), which
    means fewer CRT primes and hence fewer walks."""
    n = len(m)
    rows = [sum(abs(v) for v in row) for row in m]
    if any(s == 0 for s in rows):
        return 0.0
    cols = [sum(abs(m[i][j]) for i in range(n)) for j in range(n)]
    if any(s == 0 for s in cols):
        return 0.0

    def lg(s):
        return math.log2(s) if s.bit_length() < 900 else float(s.bit_length())

    best = min(sum(map(lg, rows)), sum(map(lg, cols)))
    if all(v == 0 or v == 1 for row in m for v in row):
        # Bregman-Minc; lgamma is ~1e-15-relative, absolute slack well
        # under the caller's +3-bit margin
        def bm(degs):
            return sum(math.lgamma(r + 1) / (math.log(2) * r) for r in degs)

        best = min(best, bm(rows), bm(cols))
    return best


#: what one calc="exact" call costs beyond its walks, in seconds: dyadic
#: lift, folds, bound, packing, one launch and one copy back per prime and
#: the CRT.  Measured whole on a core too small for its walks to count:
#: n=20, 4 walks of 2^19 steps, 5.2 ms (NVIDIA H100 80GB HBM3, 700.00 W)
_EXACT_FIXED_S = 0.005

#: what planning a core costs on its first call (modp.core_plan: candidate
#: orderings, then the exact bigint live mask), in seconds, per
#: 2^(n-1) / 2^31 of index space: 24 ms at n=32 (the same card's host)
_PLAN_S_N32 = 0.024

#: the native engine's price of a Z_p walk, seconds per (column update +
#: Montgomery product) element step, and the cost of a dense native run
#: above which it pays for a pruned plan (modp.core_plan) and runs the
#: checkpointed CRT pipeline instead of the flat batch walk: the JAX
#: package's figures (superman_tpu/ops/exact.py:279-310), with which it
#: prices the same engine
_NATIVE_S_PER_ELEMENT = 6e-9
_NATIVE_PLAN_FLOOR_S = 60.0


def _native_cost_estimate(core, bits: float, budget_s: float = None
                          ) -> Tuple[float, int]:
    """(seconds, nprimes) of perman_exact_fraction(engine="native") on a
    folded core: the dense walk at 61-bit primes, or past
    _NATIVE_PLAN_FLOOR_S the pruned plan's live steps at the IFMA or
    scalar element rate.  inf where the engine does not build."""
    from ..bindings.native import cpu_ifma, native_available
    n = len(core)
    npr = max(1, math.ceil(bits / 61.0)) + 1
    if not native_available():
        return math.inf, npr
    secs = npr * (1 << max(0, n - 1)) * n * _NATIVE_S_PER_ELEMENT
    if (secs > _NATIVE_PLAN_FLOOR_S
            and (budget_s is None or budget_s > _NATIVE_PLAN_FLOOR_S)):
        # the plan is cached by core fingerprint, so the run
        # (crt_perman_core backend="native") reuses the plan priced here
        from .modp import core_plan
        ifma = cpu_ifma()
        npr_nat = max(1, math.ceil(bits / (50.0 if ifma else 61.0))) + 1
        pl_ = core_plan(core)
        live_iters = ((len(pl_[1]) << pl_[2]) if pl_ is not None
                      else (1 << max(0, n - 1)))
        # per-element rates of the JAX package's measurement on one host
        # core: 0.46 ns IFMA, 4.8 ns scalar, priced with headroom
        secs = min(secs, npr_nat * live_iters * n
                   * (0.5e-9 if ifma else _NATIVE_S_PER_ELEMENT))
    return secs, npr


def exact_cost_estimate(a: np.ndarray, device: torch.device,
                        budget_s: float = None, engine: Optional[str] = None
                        ) -> Tuple[float, int, int]:
    """(seconds, nprimes, core_n) for perman_exact_fraction on `device`
    with `engine`.

    engine None or "device": every core with n >= 2 walks on the device;
    the price is the fixed cost of a call, the plan, and (31-bit prime
    count + 1) walks of the plan's live steps at the Z_p walk's measured
    rate on that device, the kernel's on a card and the plain version's
    on the CPU (modp.card_cost_estimate).
    engine "native": the native CPU engine's price, the JAX package's
    native branch (_native_cost_estimate); inf where it does not build.

    budget_s: the caller's acceptance threshold, if it has one.  Pricing
    the walks computes the real pruned plan (host bigint liveness over up
    to 2^26-entry gray masks), so when the fixed cost alone is over the
    budget it is skipped: the answer ("too expensive") is already known.
    """
    m, _ = dyadic_int_matrix(a)
    core, mult = _fold_lines([row[:] for row in m])
    if mult == 0 or not core:
        return 0.0, 0, 0
    n = len(core)
    bits = _log2_bound(core) + 3
    if engine == "native":
        secs, npr = _native_cost_estimate(core, bits, budget_s)
        return secs, npr, n
    from .modp import PRIME_CEIL, card_cost_estimate
    npr = max(1, math.ceil(bits / math.log2(PRIME_CEIL))) + 1
    secs = _EXACT_FIXED_S + _PLAN_S_N32 * 2.0 ** (n - 32)
    if budget_s is not None and budget_s <= secs:
        return secs, npr, n         # already over budget; skip the plan
    return secs + card_cost_estimate(core, bits, device), npr, n


def _crt(residues, prs, need: int) -> int:
    """The integer of |X| < P/2 with X = residues[i] mod prs[i] over the
    first `need` primes, checked against the held-out prime prs[need]: a
    walk or CRT bug cannot return silently (P covers |per| by the row-sum
    bound, so X is forced and the verifier must match)."""
    X, P = 0, 1
    for r, p in zip(residues[:need], prs[:need]):
        t = (r - X) * pow(P, -1, p) % p
        X += P * t
        P *= p
    if X > P // 2:
        X -= P
    if X % prs[need] != residues[need]:
        raise AssertionError(
            "exact CRT verification prime mismatch -- modular walk or "
            "reconstruction is broken")
    return X


def perman_exact_fraction(a: np.ndarray, device: torch.device,
                          threads: int = 0, log=None,
                          engine: Optional[str] = None,
                          checkpoint_path: Optional[str] = None,
                          ) -> Tuple[Fraction, dict]:
    """EXACT permanent of the f64 matrix `a`, as a Fraction.

    engine: None or "device" walks every prime with the Z_p kernel on
    `device` (its plain version on the CPU); "host" runs the pure-Python
    walk for cores with n <= 16; "native" runs the native CPU engine with
    `threads` threads (0: all), as the JAX package runs it: the flat batch
    walk at 61-bit primes, or past _NATIVE_PLAN_FLOOR_S the pruned,
    checkpointed CRT pipeline (modp.crt_perman_core backend="native").
    meta["engine"] says which ran.
    """
    t0 = time.perf_counter()
    with trace.timer("exact_lift"):
        a = np.asarray(a, dtype=np.float64)
        n0 = a.shape[0]
        m, k = dyadic_int_matrix(a)
        core, mult = _fold_lines(m)
        den = 1 << (k * n0)
        meta = {"k": k, "core_n": len(core), "n": n0}
    if mult == 0:
        meta["wall_s"] = time.perf_counter() - t0
        return Fraction(0), meta
    if not core:                                # fully folded
        per_core = 1
        meta.update(nprimes=0, engine="fold_only")
    else:
        nc = len(core)
        if engine is None:
            engine = "device"
        if engine == "device":
            from .modp import crt_perman_core
            per_core, tmeta = crt_perman_core(
                core, device, log=log, checkpoint_path=checkpoint_path)
            meta.update(engine=tmeta["engine"], nprimes=tmeta["nprimes"],
                        bound_bits=tmeta["bound_bits"],
                        live_frac=tmeta["live_frac"])
            if "plan_search" in tmeta:
                meta["plan_search"] = tmeta["plan_search"]
        elif engine in ("host", "native"):
            bits = _log2_bound(core) + 3            # sign + slack headroom
            need = max(1, math.ceil(bits / 61.0))
            if engine == "host" and nc > 16:
                raise ValueError(f'engine="host" walks cores with n <= 16, '
                                 f"got core n={nc}")
            if engine == "native":
                from ..bindings.native import (native_available,
                                               perman_mod_batch)
                if not native_available():
                    raise RuntimeError("the native CPU engine does not "
                                       "build on this host")
            if engine == "native" and ((need + 1) * (1 << (nc - 1)) * nc
                                       * _NATIVE_S_PER_ELEMENT
                                       > _NATIVE_PLAN_FLOOR_S):
                # a big core: the pruned-plan CRT pipeline (checkpointed,
                # held-out-verified); the batch below would walk the whole
                # 2^(nc-1) index space per prime
                from .modp import crt_perman_core
                per_core, tmeta = crt_perman_core(
                    core, device, log=log, checkpoint_path=checkpoint_path,
                    backend="native", threads=threads)
                meta.update(engine=tmeta["engine"],
                            nprimes=tmeta["nprimes"],
                            bound_bits=tmeta["bound_bits"],
                            live_frac=tmeta["live_frac"])
                if "plan_search" in tmeta:
                    meta["plan_search"] = tmeta["plan_search"]
            else:
                prs = primes_desc(need + 1)         # +1 held-out verifier
                if engine == "native":
                    mats = np.empty((len(prs), nc, nc), dtype=np.uint64)
                    for i, p in enumerate(prs):
                        mats[i] = [[v % p for v in row] for row in core]
                    residues = [int(r) for r in perman_mod_batch(
                        mats, np.asarray(prs, np.uint64), threads)]
                    meta["engine"] = "native_mod"
                else:
                    residues = [_perman_mod_host(core, p) for p in prs]
                    meta["engine"] = "host_mod"
                per_core = _crt(residues, prs, need)
                meta.update(nprimes=need, bound_bits=round(bits, 1))
        else:
            raise ValueError(f"unknown exact engine {engine!r}")
    with trace.timer("exact_crt"):
        per_int = mult * per_core
        frac = Fraction(per_int, den)
        meta["wall_s"] = time.perf_counter() - t0
        if per_int:
            meta["log2"] = (1.0 if per_int > 0 else -1.0,
                            log2_abs_fraction(frac))
    if log:
        log(f"exact CRT: core n={meta['core_n']} "
            f"primes={meta.get('nprimes')} wall={meta['wall_s']:.1f}s")
    return frac, meta


def _float_of_fraction(f: Fraction) -> float:
    try:
        return float(f)
    except OverflowError:
        return math.inf if f > 0 else -math.inf


def log2_abs_fraction(f: Fraction) -> float:
    if f == 0:
        return -math.inf
    num, den = abs(f.numerator), f.denominator
    shift = num.bit_length() - 64
    top = num >> shift if shift > 0 else num
    return (math.log2(top) + max(0, shift)) - (den.bit_length() - 1)


def perman_exact(dense, flags, device: torch.device):
    """calc="exact" engine entry (Result-producing)."""
    from ..core.result import Result

    a = np.asarray(dense.mat, dtype=np.float64)
    # cpu=True names the native CPU engine, as it does for the float walks
    engine = "native" if (flags.cpu and not flags.gpu) else None
    frac, meta = perman_exact_fraction(a, device, threads=flags.threads,
                                       engine=engine)
    with trace.timer("exact_crt"):
        val = _float_of_fraction(frac)
        res = Result(val, meta["wall_s"], algo_name="exact_crt")
        res.meta["exact"] = {
            "log2": (log2_abs_fraction(frac) if frac else -math.inf),
            "core_n": meta["core_n"], "nprimes": meta.get("nprimes"),
            "engine": meta.get("engine"), "k": meta["k"],
        }
        if "plan_search" in meta:
            res.meta["exact"]["plan_search"] = meta["plan_search"]
        res.meta["exact_fraction"] = frac
    return res
