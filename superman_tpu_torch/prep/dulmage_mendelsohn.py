"""Dulmage–Mendelsohn zero-structure pruning.

Port of ``superman_tpu/prep/dulmage_mendelsohn.py``, unchanged: the
module is pure numpy.

Parity: match / reach / dulmage_mendehlson (reference util.h:30-312):
compute a maximum bipartite matching (here scipy-free Hopcroft-Karp-style
augmenting paths); if no perfect matching exists the permanent is 0.
Otherwise build the digraph row->col edges oriented through the matching
and zero out every entry whose edge connects two different strongly
connected components — such entries lie in no perfect matching, so erasing
them preserves the permanent while sparsifying the matrix.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def max_bipartite_matching(a: np.ndarray) -> np.ndarray:
    """row_match[i] = matched column of row i, or -1 (augmenting paths)."""
    n = a.shape[0]
    adj = [np.nonzero(a[i])[0].tolist() for i in range(n)]
    row_match = np.full(n, -1, dtype=np.int64)
    col_match = np.full(n, -1, dtype=np.int64)

    def augment(i, seen):
        for j in adj[i]:
            if not seen[j]:
                seen[j] = True
                if col_match[j] == -1 or augment(col_match[j], seen):
                    row_match[i] = j
                    col_match[j] = i
                    return True
        return False

    for i in range(n):
        if row_match[i] == -1:
            augment(i, np.zeros(n, dtype=bool))
    return row_match


def _tarjan_scc(n, adj):
    """Iterative Tarjan SCC; returns component id per node."""
    index = np.full(n, -1); low = np.zeros(n, dtype=np.int64)
    on = np.zeros(n, dtype=bool)
    comp = np.full(n, -1); stack = []
    counter = [0]; cid = [0]
    for root in range(n):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter[0]; counter[0] += 1
                stack.append(v); on[v] = True
            recurse = False
            for i in range(pi, len(adj[v])):
                w = adj[v][i]
                if index[w] == -1:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                if on[w]:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            if low[v] == index[v]:
                while True:
                    w = stack.pop(); on[w] = False
                    comp[w] = cid[0]
                    if w == v:
                        break
                cid[0] += 1
            work.pop()
            if work:
                p = work[-1][0]
                low[p] = min(low[p], low[v])
    return comp


def dm_prune(a: np.ndarray) -> Optional[np.ndarray]:
    """Zero entries outside every perfect matching; None if per(A) = 0."""
    n = a.shape[0]
    rm = max_bipartite_matching(a)
    if (rm == -1).any():
        return None                      # no perfect matching: permanent 0
    # digraph on rows: edge i -> rowOf(col j) for each nonzero (i, j) not in
    # the matching (equivalent to the reference's col-contracted graph)
    col_row = np.empty(n, dtype=np.int64)
    col_row[rm] = np.arange(n)
    adj = [[int(col_row[j]) for j in np.nonzero(a[i])[0] if j != rm[i]]
           for i in range(n)]
    comp = _tarjan_scc(n, adj)
    out = a.copy()
    for i in range(n):
        for j in np.nonzero(a[i])[0]:
            if j != rm[i] and comp[i] != comp[col_row[j]]:
                out[i, j] = 0
    return out
