"""The seeded corpus the tools read when no `--root` is given.

    python -m superman_tpu_torch.tools.corpus --root DIR [--seed 0] [--small]

The JAX package's corpus tools read the reference project's matrices
from a fixed path outside this repository.  This module writes a stand-in
of the same layout, every file a pure function of the seed:

* the int suite `{root}/int/{n}_{d}_{s}` in the v1 triplet format
  (io/triplet.write_triplet): entries 1..4 at density d, drawn as
  tests/conftest.py's `random_int_matrix` draws them, then a full
  diagonal of 1..4 so that every file has a perfect matching (the
  reference's suites have no zero permanent);
* the real corpus that tools/real_suite.py classifies:
  `known_perman/*.mtx`, `real/*.mtxzero` (a v1 triplet), `matrices/*.mtx`
  and `unknown_perman/*.mtx`, MatrixMarket coordinate files whose
  structure reaches each class of the suite:
  - A (exact feasible): degree-1 and degree-2 lines, entries over many
    binades, one real-valued file, one .mtxzero triplet, one symmetric
    pattern;
  - Z: a file with no perfect matching;
  - B: an order above the exact bound whose degree-1/2 folds leave a
    small core;
  - B2: an order above the bound with a sparse core above the core bound;
  - C: an order above the bound with no small core;
  - D (unknown_perman): a few hundred rows: positive, without a perfect
    matching, signed (for Gurvits), rectangular.
  Every name starts with `seed_<seed>_` (`seed_<seed>s_` in the small
  corpus), so no two corpora, and none of them and the reference corpus,
  share a file name in a table keyed by it (exact_known's output).

`small=True` writes the same layout at orders the CPU's plain versions
walk in seconds (the tests' corpus).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
import sys
import tempfile
from typing import Dict, List, Tuple

import numpy as np

from ..core.matrix import DenseMatrix
from ..io.triplet import write_triplet
from .kernel_time import random_int_matrix

#: the int suite's orders, densities and seeds (the JAX suite_check's
#: defaults)
SUITE_NS = (30, 31, 32)
SUITE_DENSITIES = ("0.10", "0.20", "0.30", "0.50", "0.70", "0.90")
SUITE_SEEDS = (0,)

KNOWN, REAL, SMALL, UNKNOWN = ("known_perman", "real", "matrices",
                               "unknown_perman")

#: (core order, tail order) of the A, B and B2 files, and the orders of
#: the others, full and small.  A card prices the exact bound at n = 44
#: and the core bound at 35 (tools/real_suite.py); the small corpus meets
#: the bounds the tests pass
SIZES = {
    False: {"a_real": (12, 8), "a_int": (10, 6), "a_pattern": 11,
            "z": 12, "b": (14, 38), "b2": (38, 18), "c": 60,
            "d_band": 240, "d_singular": 160, "d_signed": 200,
            "d_rect": (240, 80)},
    True: {"a_real": (8, 4), "a_int": (7, 3), "a_pattern": 8,
           "z": 9, "b": (6, 8), "b2": (10, 6), "c": 13,
           "d_band": 40, "d_singular": 30, "d_signed": 36,
           "d_rect": (36, 12)},
}


def suite_matrix(seed: int, n: int, density: str, s: int) -> np.ndarray:
    """The int suite's file {n}_{density}_{s}."""
    rng = np.random.default_rng([seed, n, round(float(density) * 100), s])
    a = random_int_matrix(rng, n, float(density))
    np.fill_diagonal(a, rng.integers(1, 5, n))
    return a


def write_int_suite(root: str, seed: int = 0, ns=SUITE_NS,
                    densities=SUITE_DENSITIES, seeds=SUITE_SEEDS
                    ) -> List[str]:
    """Write {root}/int/{n}_{d}_{s} for every n, d, s; return the paths."""
    os.makedirs(os.path.join(root, "int"), exist_ok=True)
    paths = []
    for n in ns:
        for d in densities:
            for s in seeds:
                path = os.path.join(root, "int", f"{n}_{d}_{s}")
                write_triplet(path, DenseMatrix(suite_matrix(seed, n, d, s),
                                                "int"))
                paths.append(path)
    return paths


def write_mtx(path: str, a: np.ndarray, field: str = "real",
              symmetry: str = "general") -> None:
    """A MatrixMarket coordinate file of `a`: field "real", "integer" or
    "pattern"; symmetry "general", or "symmetric" (the lower triangle is
    written, as the format stores it)."""
    a = np.asarray(a)
    m, n = a.shape
    src = np.tril(a) if symmetry == "symmetric" else a
    ri, ci = np.nonzero(src)
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        f.write(f"{m} {n} {len(ri)}\n")
        for i, j in zip(ri, ci):
            v = src[i, j]
            if field == "pattern":
                f.write(f"{i + 1} {j + 1}\n")
            elif field == "integer":
                f.write(f"{i + 1} {j + 1} {int(v)}\n")
            else:
                f.write(f"{i + 1} {j + 1} {float(v):.17g}\n")


def _binades(rng, size) -> np.ndarray:
    """Positive reals over 49 binades, 2^-24 .. 2^24."""
    return rng.uniform(1.0, 2.0, size) * np.exp2(rng.integers(-24, 25, size))


def _ints(rng, size) -> np.ndarray:
    return rng.integers(1, 10, size)


def _core(rng, k: int, density: float, values) -> np.ndarray:
    """A k x k core with a full diagonal and entries at `density`."""
    a = (rng.random((k, k)) < density) * values(rng, (k, k))
    np.fill_diagonal(a, values(rng, k))
    return a


def _chain(rng, core: np.ndarray, m: int, values) -> np.ndarray:
    """core with a tail of m lines that fold away: [[core, X], [0, T]]
    with T upper bidiagonal (its last row has degree 1, and each fold
    leaves the next one at degree 1) and each tail column tied to one or
    two rows of the core, rows and columns then shuffled.  per(A) =
    per(core) * prod(diag T)."""
    k = core.shape[0]
    n = k + m
    a = np.zeros((n, n), dtype=core.dtype)
    a[:k, :k] = core
    for j in range(k, n):
        rows = rng.choice(k, size=int(rng.integers(1, 3)), replace=False)
        a[rows, j] = values(rng, len(rows))
        a[j, j] = values(rng, 1)[0]
        if j + 1 < n:
            a[j, j + 1] = values(rng, 1)[0]
    return a[rng.permutation(n)][:, rng.permutation(n)]


def _hall_violation(rng, a: np.ndarray, rows: int) -> np.ndarray:
    """a with its first `rows` rows confined to rows - 1 columns (no
    perfect matching, and no empty line), rows and columns shuffled."""
    a = a.copy()
    n = a.shape[0]
    a[:rows, rows - 1:] = 0
    a[:rows, :rows - 1] = np.maximum(a[:rows, :rows - 1], 1)
    for j in np.nonzero(~a.any(axis=0))[0]:
        a[rows + j % (n - rows), j] = 1
    return a[rng.permutation(n)][:, rng.permutation(n)]


def real_matrices(seed: int = 0, small: bool = False
                  ) -> Dict[str, Tuple[np.ndarray, str, str]]:
    """{relative path: (matrix, field, symmetry)} of the real corpus; field
    "triplet" marks the v1 triplet (.mtxzero)."""
    sz = SIZES[small]
    pre = f"seed_{seed}{'s' if small else ''}_"
    out = {}

    def rng(tag: int):
        return np.random.default_rng([seed, tag])

    g = rng(1)
    k, m = sz["a_real"]
    out[f"{KNOWN}/{pre}a_real.mtx"] = (
        _chain(g, _core(g, k, 0.45, _binades), m, _binades), "real",
        "general")
    g = rng(2)
    k, m = sz["a_int"]
    out[f"{REAL}/{pre}a_int.mtxzero"] = (
        _chain(g, _core(g, k, 0.5, _ints), m, _ints), "triplet", "general")
    g = rng(3)
    n = sz["a_pattern"]
    p = np.triu(g.random((n, n)) < 0.35, 1)
    p = (p | p.T).astype(np.int64)
    np.fill_diagonal(p, 1)
    out[f"{SMALL}/{pre}a_pattern.mtx"] = (p, "pattern", "symmetric")
    g = rng(4)
    n = sz["z"]
    out[f"{SMALL}/{pre}z_singular.mtx"] = (
        _hall_violation(g, _core(g, n, 0.5, _ints), 3), "integer", "general")
    g = rng(5)
    k, m = sz["b"]
    out[f"{KNOWN}/{pre}b_chain.mtx"] = (
        _chain(g, _core(g, k, 0.35, _ints), m, _ints), "integer", "general")
    g = rng(6)
    k, m = sz["b2"]
    out[f"{SMALL}/{pre}b2_sparse.mtx"] = (
        _chain(g, _core(g, k, 0.15, _ints), m, _ints), "integer", "general")
    g = rng(7)
    n = sz["c"]
    out[f"{SMALL}/{pre}c_dense.mtx"] = (_core(g, n, 0.5, _ints), "integer",
                                        "general")
    g = rng(8)
    n = sz["d_band"]
    band = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 3
    out[f"{UNKNOWN}/{pre}d_band.mtx"] = (
        band * (g.random((n, n)) < 0.6) * _binades(g, (n, n))
        + np.diag(_binades(g, n)), "real", "general")
    g = rng(9)
    n = sz["d_singular"]
    out[f"{UNKNOWN}/{pre}d_singular.mtx"] = (
        _hall_violation(g, _core(g, n, 0.05, _ints) > 0, 5).astype(np.int64),
        "pattern", "general")
    g = rng(10)
    n = sz["d_signed"]
    s = np.triu((g.random((n, n)) < 0.04) * -g.uniform(0.5, 2.0, (n, n)), 1)
    s = s + s.T
    np.fill_diagonal(s, np.abs(s).sum(axis=1) + g.uniform(1.0, 2.0, n))
    out[f"{UNKNOWN}/{pre}d_signed.mtx"] = (s, "real", "symmetric")
    g = rng(11)
    rows, cols = sz["d_rect"]
    r = (g.random((rows, cols)) < 0.1) * _binades(g, (rows, cols))
    r[np.arange(cols), np.arange(cols)] = _binades(g, cols)
    out[f"{UNKNOWN}/{pre}d_rect.mtx"] = (r, "real", "general")
    return out


def write_real_corpus(root: str, seed: int = 0, small: bool = False
                      ) -> List[str]:
    """Write the real corpus under root; return the paths."""
    paths = []
    for rel, (a, field, symmetry) in real_matrices(seed, small).items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if field == "triplet":
            write_triplet(path, DenseMatrix(np.asarray(a, np.int64), "int"))
        else:
            write_mtx(path, a, field, symmetry)
        paths.append(path)
    return paths


def corpus(root: str) -> List[str]:
    """The files real_suite classifies and exact_known certifies, in the
    JAX package's order (real_suite.corpus)."""
    return (sorted(glob.glob(os.path.join(root, KNOWN, "*.mtx")))
            + sorted(glob.glob(os.path.join(root, REAL, "*.mtxzero")))
            + sorted(glob.glob(os.path.join(root, SMALL, "*.mtx"))))


def corpus_unknown(root: str) -> List[str]:
    """unknown_perman, kept out of corpus() as the JAX package keeps it
    (it holds a rectangular file)."""
    return sorted(glob.glob(os.path.join(root, UNKNOWN, "*.mtx")))


@contextlib.contextmanager
def real_root(root=None, seed: int = 0, small: bool = False):
    """`root` itself, or a temporary directory holding the seeded real
    corpus (removed on exit)."""
    if root is not None:
        yield root
        return
    with tempfile.TemporaryDirectory() as tmp:
        write_real_corpus(tmp, seed, small)
        yield tmp


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="superman-torch-corpus",
                                description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--small", action="store_true",
                   help="orders the CPU's plain versions walk in seconds")
    args = p.parse_args(argv)
    paths = (write_int_suite(args.root, args.seed)
             + write_real_corpus(args.root, args.seed, args.small))
    print(f"corpus: {len(paths)} files under {args.root}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
