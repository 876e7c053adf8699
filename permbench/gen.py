"""The int suite's matrices, made from a seed.

A frozen copy of the port's `tools/corpus.suite_matrix` and of
`tools/kernel_time.random_int_matrix` (SUPerman's `int/{n}_{d}_{s}`
files as the port's tools draw them): entries 1..4 at density d, then a
full diagonal of 1..4, so that every matrix has a perfect matching.
Item k of a pool at seed `seed` is drawn from
`default_rng([seed, n, round(100 d), k])`, the corpus's `int/{n}_{d}_{k}`
at that seed.  A batch item draws its matrices one after another from
the item's generator.
"""

from __future__ import annotations

import numpy as np

#: largest entry of the suite's matrices
VMAX = 4


def item_rng(seed: int, n: int, density: float, k: int):
    """The generator of pool item k; any whole seed, negative ones too."""
    return np.random.default_rng([seed % (1 << 64), n,
                                  round(float(density) * 100), k])


def random_int_matrix(rng, n: int, density: float,
                      vmax: int = VMAX) -> np.ndarray:
    """Entries 1..vmax at `density`, the rest 0."""
    a = (rng.random((n, n)) < density).astype(np.int64)
    return a * rng.integers(1, vmax + 1, (n, n))


def suite_matrix(rng, n: int, density: float) -> np.ndarray:
    """One matrix of the int suite: random_int_matrix and a full diagonal
    of 1..4."""
    a = random_int_matrix(rng, n, density)
    np.fill_diagonal(a, rng.integers(1, VMAX + 1, n))
    return a


def pool(seed: int, n: int, density: float, size: int,
         batch: int = 1) -> list:
    """`size` items: (n, n) int64 matrices, or with batch > 1 (batch, n, n)
    stacks."""
    out = []
    for k in range(size):
        rng = item_rng(seed, n, density, k)
        if batch == 1:
            out.append(suite_matrix(rng, n, density))
        else:
            out.append(np.stack([suite_matrix(rng, n, density)
                                 for _ in range(batch)]))
    return out
