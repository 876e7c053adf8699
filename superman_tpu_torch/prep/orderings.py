"""Matrix orderings that accelerate the sparse exact walk.

Port of ``superman_tpu/prep/orderings.py``, unchanged: the module is pure
numpy.  Parity: matrix2compressed_sortOrder / _skipOrder (reference
util.h:553-684).  Row/column permutations leave the permanent unchanged;
they reshape WHERE zeros fall along the Gray walk, which is what both the
reference's SkipPer skip-ahead and our chunk-level pruning (ops/pruning.py)
exploit.

Note on orientation: the reference's orderings place low-degree columns at
LOW indices (toggled most often, so x-updates are cheap in SpaRyser, and
zero rows skip far).  For chunk pruning the same orientation is right: a
chunk is prunable via rows with no support in the low column range.
"""

from __future__ import annotations

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


def _row_zero_frac(a: np.ndarray, z: int) -> float:
    """Fraction of a row's reachable Gray-walk x values that are exactly
    zero (the row's chunk-kill power if it becomes chunk-constant)."""
    n = a.shape[1]
    cols = np.nonzero(a[z, : n - 1])[0]
    if len(cols) > 16:
        return 0.0
    x0 = float(a[z, -1]) - float(a[z].sum()) / 2.0
    pat = np.array([x0])
    for v in a[z, cols].astype(np.float64):
        pat = np.concatenate([pat, pat + v])
    return float((pat == 0.0).mean())


def prune_order(a: np.ndarray, r: int) -> list:
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

    The reference's orderings (SortOrder/SkipOrder, util.h:553-684)
    optimize for per-thread skip length; these optimize for the TPU
    engine's chunk-granular pruning instead.
    """
    a = np.asarray(a)
    n = a.shape[0]
    nz = a != 0
    budget = n - r
    supports = [frozenset(np.nonzero(nz[i])[0]) for i in range(n)]
    zf = [_row_zero_frac(a, i) for i in range(n)]
    perms = []
    for strategy in ("mindeg", "zero", "random"):
        rnd = np.random.default_rng(1)
        order = (rnd.permutation(n) if strategy == "random"
                 else np.argsort([len(s) for s in supports],
                                 kind="stable"))
        outer: set = set()
        covered: set = set()
        while True:
            best, best_score = None, None
            for i in order:
                if i in covered:
                    continue
                need = len(supports[i] - outer)
                if len(outer) + need > budget:
                    continue
                if strategy == "zero":
                    score = (zf[i] + 0.01) / (need + 1)
                else:
                    score = -need
                if best_score is None or score > best_score:
                    best, best_score = i, score
            if best is None:
                break
            outer |= supports[best]
            covered.add(best)
        out_cols = sorted(outer)
        inner = [c for c in range(n) if c not in outer]
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
