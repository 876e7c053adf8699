"""Chunk-level dead-range pruning: the SkipPer of the chunked walk.

Port of ``superman_tpu/ops/pruning.py``: the planner of the sparse walk
(ops/ryser.py) and of the exact engine (ops/modp.core_plan), the live
chunk list and the host version of the factored rows' weights.

A row z is *constant* within every aligned chunk of 2**r indices iff it
has no nonzero among columns 0..r-1 (only those columns toggle inside a
chunk).  A chunk is *dead* -- every one of its 2**r terms is exactly
zero -- iff some constant row has x_z(base) == 0.  x-values are
half-integers (or exact dyadics) so the zero test in float64 is exact.

Liveness evaluation is O(C) with tiny constants, no per-chunk loop: for
a chunk id with m = n-1-r bits, x_z(base) = x0_z + sum_b g_{b-r} *
a[z, b] over the row's support b in [r, n-2], where g_j = gray(id) bit j
(column r-1 pairs with id&1, but constant rows have no support there).
So in *gray space* G = gray(id), each constant row's dead set is a union
of subcubes over its k_z support bits: enumerate the row's 2**k_z
reachable x values (a tiny array), find the zero patterns, and OR them
into a (2,)*m bool tensor with one broadcast.  Live G values map back to
chunk ids with a vectorized inverse-gray transform.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.matrix import DenseMatrix
from . import gray

#: what a chunk costs a walk on the card beyond its 2^r steps, in seconds:
#: its id going up from the host (8 bytes), the prologue that builds x from
#: its Gray bits, its weight, its share of a block pair coming down.
#: Measured by tools/chunk_cost.py on the n=36 sparse plan of
#: chip_smoke.py: the same 5.64e9 live steps walked as 86,112 to
#: 22,044,672 chunks (every level that fills the card), the slope of the
#: wall time over the chunk count: 1.08 ns a chunk in df64, 1.24 ns in
#: tf96; the kernel alone shows none (NVIDIA H100 80GB HBM3, 700.00 W)
C_CHUNK_S = 1.1e-9

#: what the exact dead mask (dead_mask_gray, then the live ids) costs the
#: host per entry of the gray space, 2^(n-1-r) entries, in seconds.
#: Measured by tools/chunk_cost.py on the same plan's matrix, host clock of
#: the card's machine: 24 ns an entry at 2^17 entries, 14.7 at 2^19, 13.6
#: at 2^21, 13.0 at 2^23 (beside an NVIDIA H100 80GB HBM3, 700.00 W)
C_MASK_S = 1.5e-8

#: largest constant-row outer support whose 2^k reachable-value pattern
#: is materialized (8 MB f64 at 20); heavier rows are skipped by the
#: masks (under-pruning, correct)
_PAT_SUPPORT_CAP = 20


def inverse_gray(g: np.ndarray, m: int) -> np.ndarray:
    """Vectorized gray^{-1}: y such that y ^ (y >> 1) == g (g < 2**m)."""
    y = np.asarray(g, dtype=np.uint64).copy()
    shift = 1
    while shift < m:
        y ^= y >> np.uint64(shift)
        shift <<= 1
    return y


def const_rows(a: np.ndarray, r: int) -> np.ndarray:
    """Rows with no support among the within-chunk toggling columns
    0..r-1 (their x value is constant across each aligned 2**r chunk)."""
    nz = np.asarray(a) != 0
    return np.nonzero(~nz[:, :r].any(axis=1))[0]


def dead_mask_gray(a: np.ndarray, r: int):
    """Dead flags over gray space, shape (2,)*m viewed flat (m = n-1-r).

    Entry G is True iff the chunk id = gray^{-1}(G) is dead: some
    constant row's base x value is exactly 0.  Returns None when no
    constant row can reach zero (nothing prunable).
    """
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    m = n - 1 - r
    if m < 1:
        return None
    cr = const_rows(a, r)
    if len(cr) == 0:
        return None
    x0 = gray.x0_f64(a)
    dead = None
    for z in cr:
        cols = np.nonzero(a[z, : n - 1])[0]      # all >= r by constness
        if len(cols) > _PAT_SUPPORT_CAP:
            # the reachable-value pattern is 2^support entries; skipping
            # a heavy row only UNDER-prunes (its chunks stay live) --
            # correctness is unaffected, memory stays bounded
            continue
        # reachable x values of row z: flat pattern index bit q selects
        # cols[q] (LSB-first), i.e. pat[i] = x0_z + sum_{q: bit q of i}
        # a[z, cols[q]] -- exact in f64 (half-integer walk values)
        pat = np.array([x0[z]])
        for v in a[z, cols]:
            pat = np.concatenate([pat, pat + v])
        zpat = pat == 0.0
        if not zpat.any():
            continue
        if dead is None:
            dead = np.zeros((2,) * m, dtype=bool)
        # OR the zero subcubes into gray space.  Gray bit of col b is
        # j = b - r; the (2,)*m tensor's axis t holds bit m-1-t
        # (C-order), so bit j lands at axis m-1-j.  zpat's flat C-order
        # axes carry bits[k-1], bits[k-2], ... (descending), and their
        # target axes m-1-bits[k-1] < m-1-bits[k-2] < ... are ascending:
        # the relative order matches, so a plain reshape aligns them.
        bits = cols - r
        shape = [1] * m
        for j in bits:
            shape[m - 1 - j] = 2
        dead |= zpat.reshape(shape)
    return dead


def _row_pat(a: np.ndarray, z: int, r: int, dtype=np.float64):
    """(cols, pat): the reachable x values of row z over its outer
    support; pat[i] selects cols[q] for each set bit q of i."""
    n = a.shape[1]
    cols = np.nonzero(a[z, : n - 1])[0]
    pat = np.array([gray.x0_f64(a[z:z + 1])[0]], dtype=dtype)
    for v in a[z, cols]:
        pat = np.concatenate([pat, pat + dtype(v)])
    return cols, pat


def live_chunks(dense: DenseMatrix, flags=None, r: int = None):
    """Live chunk-id list for the (ordered) matrix at chunk length 2**r.

    Returns None when nothing can be pruned (the caller keeps the dense
    plan); an empty array means the permanent is exactly 0.  Without r
    the chunk length is flags.chunk_log2 or, failing that, the short-chunk
    default r = max(5, n - 18) of direct callers (the engine's own sparse
    plans come from plan_sparse, which picks r by cost).
    """
    a = np.asarray(dense.mat, dtype=np.float64)
    n = a.shape[0]
    if n < 19:
        return None
    if r is None:
        r = flags.chunk_log2 if flags is not None else None
        if r is None:
            r = max(5, n - 18)
        r = max(1, min(r, n - 2))
    return _live_for(a, r)


def chunk_factors(a_s: np.ndarray, factor_rows, ids, r: int,
                  dtype=np.float64) -> np.ndarray:
    """Per-chunk products of the factored-out constant rows, on the host.

    Each term of chunk id is prod(all rows) = factor(id) * prod(alive
    rows): the kernel walks only alive rows and weights each chunk's
    partial by this factor (sentinel ids < 0 get weight 0).  The device
    computes the same weights from the ids (gray.factor_weights, the
    kernel's chunk_weight); this is their independent host version.
    dtype=np.longdouble keeps the tf96 tier's extra bits.
    """
    ids = np.asarray(ids, dtype=np.int64)
    g = (ids ^ (ids >> 1)).astype(np.int64)
    f = np.ones(ids.shape, dtype=dtype)
    for z in factor_rows:
        cols, pat = _row_pat(a_s, int(z), r, dtype=dtype)
        bits = cols - r
        idx = np.zeros(ids.shape, dtype=np.int64)
        for q, b in enumerate(bits):
            idx |= ((g >> int(b)) & 1) << q
        f *= pat[idx]
    f[ids < 0] = 0
    return f


@dataclasses.dataclass
class SparsePlan:
    col_perm: np.ndarray     # column permutation applied to the matrix
    r: int                   # chosen chunk length log2
    ids: np.ndarray          # live chunk ids at r (sorted)
    alive_rows: np.ndarray   # rows the kernel walks
    factor_rows: np.ndarray  # rows applied as per-chunk weights
    dead_frac: float
    est_live: float          # the planner's live-fraction estimate


def plan_from_jax(sp) -> SparsePlan:
    """A ``superman_tpu.ops.pruning.SparsePlan`` as this package's: the
    same fields, so both packages can walk one plan."""
    return SparsePlan(**{f.name: getattr(sp, f.name)
                         for f in dataclasses.fields(SparsePlan)})


def plan_sparse(a: np.ndarray, *, giters: float, chunk_log2=None,
                allow_factor: bool = True, stats: dict = None):
    """Choose (column order, chunk length, live set, row split) for the
    sparse exact walk, or None to keep the dense plan.

    The candidate orderings come from prune_order; each (perm, r) pair
    is scored with a cheap independence estimate of the live fraction
    (product over constant rows of their nonzero-pattern fraction) and
    a cost model: wall ~= live * (2^(n-1) * t_iter + chunks * C_CHUNK_S)
    + chunks * C_MASK_S.  The exact dead mask is computed once, for the
    winner only.

    giters: the walk's rate on the card, in G Gray steps per second.  It
    has no default: each caller passes the rate of the kernel that will
    walk the plan (ops/ryser.py for K1's tiers, ops/modp.py for the Z_p
    walk).

    The search does each matrix's work once: prune_order's row supports
    and zero fractions serve every r, and a constant row's share of zeros
    is looked up by what alone decides it, its x0 and its values in the
    candidate's column order, so candidates that share a row build its
    pattern once.  stats, a dict, gets the search's counts: `candidates`,
    the (r, ordering) pairs scored, and `patterns_built` and
    `patterns_reused`, the lookups that built a pattern and those that
    found it.
    """
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    if stats is None:
        stats = {}
    stats.update(candidates=0, patterns_built=0, patterns_reused=0)
    if n < 19:
        return None
    from ..prep.orderings import prune_order, prune_rows, zero_frac
    t_iter = 1.0 / (giters * 1e9)
    dense_iters = float(1 << (n - 1))
    dense_cost = dense_iters * t_iter
    if chunk_log2 is not None:
        r_cands = [int(chunk_log2)]
    else:
        # deeper r (shorter chunks) exposes more constant rows -- on very
        # sparse structured matrices the live fraction keeps halving down
        # to r ~ n-26.  The exact-mask host cost is 2^(n-1-r) entries, so
        # it joins the cost model below and the gray-space tensor is
        # capped at 2^26 entries (~64 MB).
        r_cands = sorted({min(max(7, rr), n - 3)
                          for rr in (n - 26, n - 24, n - 22, n - 20,
                                     n - 18, n - 16)
                          if n - 1 - rr <= 26})
    rows = prune_rows(a)
    zeros = {}               # (x0, values) -> the row's share of zeros
    best = None              # (cost, r, perm, est_live)
    for r in r_cands:
        for perm in prune_order(a, r, rows=rows):
            stats["candidates"] += 1
            inner = sum(1 << int(c) for c in perm[:r])
            walked = ~(1 << int(perm[-1]))
            # constant rows (no support in the first r columns) whose
            # support among columns 0..n-2 is within the estimator's cap;
            # the exact mask still sees the heavier ones later
            cr = [z for z, sup in enumerate(rows.support)
                  if not sup & inner and (sup & walked).bit_count() <= 16]
            live_p = 1.0
            if cr:
                sub = a[np.ix_(cr, perm)]
                x0 = gray.x0_f64(sub)
                for x, row in zip(x0.tolist(), sub[:, : n - 1]):
                    vals = row[row != 0]
                    key = (x, vals.tobytes())
                    zf = zeros.get(key)
                    if zf is None:
                        zf = zeros[key] = zero_frac(x, vals)
                        stats["patterns_built"] += 1
                    else:
                        stats["patterns_reused"] += 1
                    live_p *= 1.0 - zf
            chunks = float(1 << (n - 1 - r))
            cost = (live_p * (dense_iters * t_iter + chunks * C_CHUNK_S)
                    + chunks * C_MASK_S)
            if best is None or cost < best[0]:
                best = (cost, r, perm, live_p)
    # an explicit chunk_log2 is a user override: prune whenever anything
    # is prunable; the cost-vs-dense gate only arbitrates auto plans
    if best is None or (chunk_log2 is None and best[0] > 0.9 * dense_cost):
        return None
    _, r, perm, est_live = best
    ap = a[:, perm]
    ids = _live_for(ap, r)
    if ids is None or len(ids) == (1 << (n - 1 - r)):
        return None
    dead_frac = 1.0 - len(ids) / (1 << (n - 1 - r))
    cr = const_rows(ap, r)
    if len(cr):
        # heavy-support rows stay in the kernel walk: factoring them
        # would materialize a 2^support pattern each
        sup = np.array([np.count_nonzero(ap[z, : n - 1]) for z in cr])
        cr = cr[sup <= _PAT_SUPPORT_CAP]
    alive = np.setdiff1d(np.arange(n), cr)
    if allow_factor and len(alive) >= 1:
        # pad the walked row set to a multiple of 8 (min 8) by promoting
        # constant rows back into the kernel walk -- the kernel's x is
        # padded to a multiple of 8 anyway, and every factor row stays a
        # true reduction in width
        target = max(8, -(-len(alive) // 8) * 8)
        promote = min(len(cr), target - len(alive))
        if promote:
            alive = np.sort(np.concatenate([alive, cr[:promote]]))
            cr = cr[promote:]
        factor_rows = cr
    else:
        alive = np.arange(n)
        factor_rows = np.empty(0, dtype=np.int64)
    return SparsePlan(col_perm=perm, r=r, ids=ids, alive_rows=alive,
                      factor_rows=factor_rows, dead_frac=dead_frac,
                      est_live=est_live)


def _live_for(a: np.ndarray, r: int):
    """Live chunk ids of the (ordered) matrix at chunk length 2**r, or
    None when nothing can be pruned (an empty array: per == 0)."""
    n = a.shape[0]
    m = n - 1 - r
    dead = dead_mask_gray(a, r)
    if dead is None:
        return None
    g_live = np.nonzero(~dead.ravel())[0].astype(np.uint64)
    ids = inverse_gray(g_live, m).astype(np.int64)
    ids.sort()
    return ids
