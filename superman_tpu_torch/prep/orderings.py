"""Matrix orderings that accelerate the sparse exact walk.

Port of ``superman_tpu/prep/orderings.py``, pure numpy, with the same
orderings; prune_order reads each matrix's rows once (prune_rows) and runs
its greedy on bit masks.  Parity: matrix2compressed_sortOrder /
_skipOrder (reference util.h:553-684).  Row/column permutations leave
the permanent unchanged; they reshape WHERE zeros fall along the Gray
walk, which is what both the reference's SkipPer skip-ahead and our
chunk-level pruning (ops/pruning.py) exploit.

Note on orientation: the reference's orderings place low-degree columns at
LOW indices (toggled most often, so x-updates are cheap in SpaRyser, and
zero rows skip far).  For chunk pruning the same orientation is right: a
chunk is prunable via rows with no support in the low column range.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from ..core.matrix import DenseMatrix


def sort_order(a: np.ndarray) -> np.ndarray:
    """Column permutation: ascending column degree (stable).
    Reference util.h:553-570 (qsort by nnz)."""
    degs = (a != 0).sum(axis=0)
    return np.argsort(degs, kind="stable")


def skip_order(a: np.ndarray):
    """Greedy min-degree column order with first-seen row order.

    Reference util.h:621-668: repeatedly pick the unpicked column of minimum
    *residual* degree (degree among rows not yet seen); rows are ordered by
    first appearance in the chosen columns' supports.
    """
    n = a.shape[0]
    nz = a != 0
    degs = nz.sum(axis=0).astype(np.int64)
    INF = 1 << 30
    col_perm = np.empty(n, dtype=np.int64)
    row_perm = []
    row_seen = np.zeros(n, dtype=bool)
    for j in range(n):
        c = int(np.argmin(degs))
        degs[c] = INF
        col_perm[j] = c
        for r in np.nonzero(nz[:, c])[0]:
            if not row_seen[r]:
                row_seen[r] = True
                row_perm.append(r)
                mask = nz[r] & (degs != INF)
                degs[mask] -= 1
    for r in range(n):           # rows never touched (all-zero rows)
        if not row_seen[r]:
            row_perm.append(r)
    return np.asarray(row_perm, dtype=np.int64), col_perm


def row_deg_order(a: np.ndarray, inc: bool = True) -> np.ndarray:
    """Row permutation by degree (sparyser sortWRowDeg, kutils.h:311)."""
    degs = (a != 0).sum(axis=1)
    order = np.argsort(degs, kind="stable")
    return order if inc else order[::-1]


def first_seen_row_order(a: np.ndarray) -> np.ndarray:
    """Rows by first appearance scanning columns left to right (sparyser
    firstSeenRow, kutils.h:372)."""
    n = a.shape[0]
    seen = np.zeros(n, dtype=bool)
    perm = []
    for j in range(n):
        for r in np.nonzero(a[:, j])[0]:
            if not seen[r]:
                seen[r] = True
                perm.append(r)
    perm.extend(r for r in range(n) if not seen[r])
    return np.asarray(perm, dtype=np.int64)


def _sym_pattern(a: np.ndarray) -> np.ndarray:
    nz = a != 0
    return nz | nz.T


def bfs_order(a: np.ndarray) -> np.ndarray:
    """BFS vertex order on the symmetrized pattern, started from a
    minimum-degree vertex; restarts per component (sparyser bfsOrder,
    kutils.h:479)."""
    g = _sym_pattern(a)
    n = a.shape[0]
    deg = g.sum(axis=1)
    visited = np.zeros(n, dtype=bool)
    order = []
    while len(order) < n:
        start = min((i for i in range(n) if not visited[i]),
                    key=lambda i: deg[i])
        queue = [start]
        visited[start] = True
        while queue:
            v = queue.pop(0)
            order.append(v)
            nbrs = np.nonzero(g[v] & ~visited)[0]
            visited[nbrs] = True
            queue.extend(nbrs.tolist())
    return np.asarray(order, dtype=np.int64)


def rcm_order(a: np.ndarray) -> np.ndarray:
    """Reverse Cuthill–McKee on the symmetrized pattern: BFS with
    neighbours enqueued in ascending-degree order, then reversed
    (sparyser sortRCM / vendored rcm.cpp — own implementation)."""
    g = _sym_pattern(a)
    n = a.shape[0]
    deg = g.sum(axis=1)
    visited = np.zeros(n, dtype=bool)
    order = []
    while len(order) < n:
        start = min((i for i in range(n) if not visited[i]),
                    key=lambda i: deg[i])
        queue = [start]
        visited[start] = True
        while queue:
            v = queue.pop(0)
            order.append(v)
            nbrs = np.nonzero(g[v] & ~visited)[0]
            nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
            visited[nbrs] = True
            queue.extend(nbrs.tolist())
    return np.asarray(order[::-1], dtype=np.int64)


def _subset_sums(x0: float, vals) -> np.ndarray:
    """x0 plus each subset sum of vals: entry i adds vals[q] for each set
    bit q of i, one value after another (the Gray walk's x values)."""
    pat = np.array([x0])
    for v in vals:
        pat = np.concatenate([pat, pat + v])
    return pat


@functools.lru_cache(maxsize=None)
def _bit_table(k: int) -> np.ndarray:
    """(2^k, k) float64: row i holds the bits of i."""
    t = ((np.arange(1 << k)[:, None] >> np.arange(k)) & 1).astype(np.float64)
    t.flags.writeable = False
    return t


#: a row of at most this many values builds its pattern as a Python list:
#: the same IEEE float64 additions as numpy's, without numpy's cost a call
_LIST_MAX = 8


def zero_frac(x0: float, vals: np.ndarray) -> float:
    """Share of the 2^k reachable x values of a row (x0 plus a subset sum
    of its k values) that are exactly zero: float((pat == 0.0).mean())
    of the pattern _subset_sums builds, bitwise.

    Where x0 and the values are half-integers whose magnitudes sum below
    2^51, every sum is exact in float64 in any order, so the zeros are the
    pairs of a sum over the first half of the values and one over the
    second that cancel: two tables of ~2^(k/2) sums in place of one of
    2^k.  The count over 2^k is exact, so the share is the pattern's mean.
    """
    k = len(vals)
    if k <= _LIST_MAX:
        pat = [x0]
        for v in vals.tolist():
            pat += [p + v for p in pat]
        return pat.count(0.0) / (1 << k)
    t = 2.0 * np.append(vals, x0)
    if np.all(np.floor(t) == t) and np.abs(t).sum() < 2.0 ** 52:
        h = k // 2
        lo = x0 + _bit_table(h) @ vals[:h]
        hi = np.sort(-(_bit_table(k - h) @ vals[h:]))
        hits = (np.searchsorted(hi, lo, "right")
                - np.searchsorted(hi, lo, "left"))
        return int(hits.sum()) / (1 << k)
    return float((_subset_sums(x0, vals) == 0.0).mean())


def _row_zero_frac(a: np.ndarray, z: int) -> float:
    """Fraction of a row's reachable Gray-walk x values that are exactly
    zero (the row's chunk-kill power if it becomes chunk-constant)."""
    n = a.shape[1]
    cols = np.nonzero(a[z, : n - 1])[0]
    if len(cols) > 16:
        return 0.0
    x0 = float(a[z, -1]) - float(a[z].sum()) / 2.0
    return zero_frac(x0, a[z, cols].astype(np.float64))


def _greedy_steps(support: list, order: list, budget: int,
                  zf: list = None) -> list:
    """The outer columns (bit masks) after each step of one greedy set
    packing, from none.

    Each step adopts the row in `order` of the strictly greatest score
    among those whose new columns still fit the budget: -need, or with zf
    (zf + 0.01) / (need + 1), need being its columns not yet outer.  A
    row of need 0 leaves the outer set as it is whenever it is adopted,
    so it is dropped at once: the steps that grow the set are those of a
    greedy that adopts it.
    """
    steps = [0]
    outer, used = 0, 0
    rows = list(order)
    while True:
        best, best_score, keep = None, None, []
        for i in rows:
            need = (support[i] & ~outer).bit_count()
            if need == 0:
                continue
            keep.append(i)
            if used + need > budget:
                continue
            score = -need if zf is None else (zf[i] + 0.01) / (need + 1)
            if best_score is None or score > best_score:
                best, best_score = i, score
        if best is None:
            return steps
        outer |= support[best]
        used = outer.bit_count()
        steps.append(outer)
        keep.remove(best)
        rows = keep


class PruneRows(NamedTuple):
    """What prune_order's greedy reads of a matrix, whatever r is."""
    support: list      # each row's nonzero columns, bit c for column c
    zero_frac: list    # each row's _row_zero_frac
    by_degree: list    # rows by support size, stable
    # the -need greedy's steps with no budget, rows by degree and rows in
    # default_rng(1).permutation(n) order.  Under -need the step's winner
    # is the first row of least need, whatever the budget, so the greedy
    # under a budget stops at the last of these steps that fits it
    mindeg_steps: list
    random_steps: list


def prune_rows(a: np.ndarray) -> PruneRows:
    """prune_order's per-matrix inputs, computed once for every r."""
    a = np.asarray(a)
    n = a.shape[0]
    nz = a != 0
    packed = np.packbits(nz, axis=1, bitorder="little")
    support = [int.from_bytes(row.tobytes(), "little") for row in packed]
    by_degree = np.argsort(nz.sum(axis=1), kind="stable").tolist()
    shuffled = np.random.default_rng(1).permutation(n).tolist()
    return PruneRows(
        support=support,
        zero_frac=[_row_zero_frac(a, i) for i in range(n)],
        by_degree=by_degree,
        mindeg_steps=_greedy_steps(support, by_degree, n),
        random_steps=_greedy_steps(support, shuffled, n))


def prune_order(a: np.ndarray, r: int, *, rows: PruneRows = None) -> list:
    """Column permutations that maximize chunk-prunable rows.

    A row is chunk-constant (and hence can kill whole chunks, see
    ops/pruning.py) iff its support lies entirely in the n-r "outer"
    columns r..n-1.  Greedy set packing over three candidate scoring
    rules; the caller evaluates each candidate's true/estimated dead
    fraction and keeps the best:

    * "mindeg": adopt the row needing the fewest new outer columns
      (maximizes the COUNT of constant rows);
    * "zero": score rows by zero_frac/(need+1) — a constant row only
      kills chunks if some signed subset of its values hits zero, so
      spend the outer budget on rows that actually will (measured +4
      to +13 points of dead fraction on the d=0.20-0.25 suites);
    * "random": a shuffled tie-break of mindeg.

    rows: prune_rows(a), for a caller that orders the same matrix at
    several r.

    The reference's orderings (SortOrder/SkipOrder, util.h:553-684)
    optimize for per-thread skip length; these optimize for the TPU
    engine's chunk-granular pruning instead.
    """
    n = np.asarray(a).shape[0]
    if rows is None:
        rows = prune_rows(a)
    budget = n - r
    zero_steps = _greedy_steps(rows.support, rows.by_degree, budget,
                               rows.zero_frac)
    perms = []
    for steps in (rows.mindeg_steps, zero_steps, rows.random_steps):
        outer = [m for m in steps if m.bit_count() <= budget][-1]
        out_cols = [c for c in range(n) if outer >> c & 1]
        inner = [c for c in range(n) if not outer >> c & 1]
        perms.append(np.asarray(inner + out_cols, dtype=np.int64))
    return perms


# preprocessing selector: reference -r {0,1,2} plus the sparyser ordering
# menu (sortWRowDeg/sortWColDeg/firstSeenRow/sortRCM/bfsOrder/sortMinNew —
# sortMinNew is exactly skip_order's greedy)
_NAMES = {0: "none", 1: "sort", 2: "skip", 3: "rcm", 4: "bfs",
          5: "rowdeg", 6: "firstseen", 7: "coldeg_dec"}


def apply_preprocessing(dense: DenseMatrix, preprocessing) -> DenseMatrix:
    """0/'none'; 1/'sort' (SortOrder); 2/'skip'/'minnew' (SkipOrder);
    3/'rcm'; 4/'bfs'; 5/'rowdeg'; 6/'firstseen'; 7/'coldeg_dec'."""
    kind = _NAMES.get(preprocessing, preprocessing)
    a = dense.mat
    if kind == "none":
        return dense
    if kind == "sort":
        cp = sort_order(a)
        return DenseMatrix(np.ascontiguousarray(a[:, cp]), dense.type)
    if kind in ("skip", "minnew"):
        rp, cp = skip_order(a)
        return DenseMatrix(np.ascontiguousarray(a[rp][:, cp]), dense.type)
    if kind == "rcm":
        p = rcm_order(a)
        return DenseMatrix(np.ascontiguousarray(a[p][:, p]), dense.type)
    if kind == "bfs":
        p = bfs_order(a)
        return DenseMatrix(np.ascontiguousarray(a[p][:, p]), dense.type)
    if kind == "rowdeg":
        rp = row_deg_order(a)
        return DenseMatrix(np.ascontiguousarray(a[rp]), dense.type)
    if kind == "firstseen":
        rp = first_seen_row_order(a)
        return DenseMatrix(np.ascontiguousarray(a[rp]), dense.type)
    if kind == "coldeg_dec":
        cp = sort_order(a)[::-1]
        return DenseMatrix(np.ascontiguousarray(a[:, cp]), dense.type)
    raise ValueError(f"unknown preprocessing {preprocessing!r}")
