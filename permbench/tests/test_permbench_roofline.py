import itertools
import math

import numpy as np
import pytest

from permbench import gen, reference, roofline


def test_bounds_of_the_ports_records():
    """PERF.md's bounds: K1 df64 at n=32 4.68 ms, K2 df64 for 256 x n=24
    3.65 ms, K3 a prime at n=32 32.31 ms."""
    k1 = roofline.least_s(roofline.walk_ops(32, 1 << 31), "fp64")
    k2 = roofline.least_s(256 * roofline.walk_ops(24, 1 << 23), "fp64")
    k3 = roofline.least_s(roofline.modp_ops(32, 1 << 31), "int32")
    assert round(k1 * 1e3, 2) == 4.68
    assert round(k2 * 1e3, 2) == 3.65
    assert round(k3 * 1e3, 2) == 32.31


def test_reduced_bound_at_the_sparse_plan():
    """The n=36 sparse plan's 4.27e9 live steps over 32 alive rows: 9.30
    ms (PERF.md's reduced df64 bound)."""
    assert round(roofline.least_s(
        roofline.walk_ops(32, 4.27e9), "fp64") * 1e3, 2) == 9.30


def _brute(a):
    n = len(a)
    return sum(math.prod(int(a[i][p[i]]) for i in range(n))
               for p in itertools.permutations(range(n)))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8])
def test_reference_against_brute_force(n, monkeypatch):
    a = np.random.default_rng(n).integers(-3, 5, (n, n))
    want = _brute(a)
    assert reference.perm_exact(a) == want
    assert reference.perm_f64(a) == pytest.approx(want, abs=1e-9)
    # blocks of a few subsets: the split and the block loop
    monkeypatch.setattr(reference, "LOW_BITS", 2)
    monkeypatch.setattr(reference, "BLOCK_ELEMS", 16)
    assert reference.perm_exact(a) == want
    assert reference.perm_f64(a) == pytest.approx(want, abs=1e-9)


def test_float_reference_near_exact_at_n20():
    a = gen.pool(1, 20, 0.5, 1)[0]
    exact = reference.perm_exact(a)
    assert abs(reference.perm_f64(a) - exact) / exact < 1e-13


def test_primes():
    ps = reference.primes_below(1 << 52, 3)
    assert all(reference._is_prime(p) for p in ps)
    assert ps == sorted(ps, reverse=True) and ps[0] < 1 << 52
    assert not reference._is_prime(ps[0] * ps[1] % (1 << 61))
