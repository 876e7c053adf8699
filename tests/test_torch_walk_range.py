"""The range of the port's float lane walks: each row scaled by an exact
power of two before the walk, as the kernel route scales it.

The routes are ryser_walk (permanent() below n=19, and under calc="f64"
at any n), the small-order batch walk (permanent_batch below n=13) and
Glynn's float64 route (below n=19, and under calc="f64").  The JAX
package walks the matrix as given on all three (ops/ryser_xla.py:45-73,
ops/batch.py:31-58, ops/glynn.py:73-78), so a product that overflows
gives NaN and products that all underflow give -0.0; the port differs
there on purpose.  Matrices are np.random.default_rng(seed).integers(1,
5, (n, n)) times a scale; each value is held to the JAX package's
calc="exact" on the same matrix (meta["exact_fraction"], its exact
engine): f32 within 5e-2, f64 and df64 within 1e-10, inf where the exact
value is beyond a double, +0.0 where it is below one.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

import superman_tpu as sp
import superman_tpu_torch as spt
from superman_tpu_torch.ops.glynn import glynn_lanes, glynn_scaled
from superman_tpu_torch.ops.oracle import perman_glynn
from tests.conftest import random_float_matrix

CPU = torch.device("cpu")
#: (n, seed, scale): a permanent near 6e49, one near 1.5e-67, one beyond
#: a double (1e25 entries at n=12), one below it (1e-30), one beyond it
#: at n=22 and n=24, the orders that calc="f64" alone sends to the lane
#: walk, and entries near the top of a double's range (1e297, 2^1020 ~
#: 1.1e307), whose abs row sums overflow
CASES = {"n18x30": (18, 18, 30.0), "n18x1e-5": (18, 18, 1e-5),
         "n12x1e25": (12, 12, 1e25), "n12x1e-30": (12, 12, 1e-30),
         "n22x1e14": (22, 22, 1e14), "n18x1e297": (18, 18, 1e297),
         "n12x2p1020": (12, 12, 2.0 ** 1020),
         "n24x2p1020": (24, 24, 2.0 ** 1020)}
REL = {"f32": 5e-2, "df64": 1e-10, "f64": 1e-10}
SMALL = [c for c, (n, _, _) in CASES.items() if n < 19]
BELOW_13 = [c for c, (n, _, _) in CASES.items() if n < 13]
_EXACT = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores and slows the walks tenfold
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _mat(n, seed, scale):
    return np.random.default_rng(seed).integers(1, 5, (n, n)) * scale


def _exact(case) -> Fraction:
    if case not in _EXACT:
        res = sp.permanent(_mat(*case), calc="exact")
        _EXACT[case] = res.meta["exact_fraction"]
    return _EXACT[case]


def _hold(got: float, exact: Fraction, rel: float):
    """got against the exact value: inf beyond a double, +0.0 below one,
    else within rel."""
    try:
        want = float(exact)
    except OverflowError:
        want = math.inf if exact > 0 else -math.inf
    assert not math.isnan(got)
    if math.isinf(want):
        assert got == want
    elif want == 0.0:
        assert got == 0.0 and math.copysign(1.0, got) == 1.0
    else:
        assert abs(Fraction(got) - exact) <= rel * abs(exact), (got, want)


@pytest.mark.parametrize("calc,case",
                         [("f32", c) for c in SMALL]
                         + [("df64", c) for c in SMALL]
                         + [("f64", c) for c in CASES])
def test_ryser_walk_range(calc, case):
    """permanent() on the lane walk route: n < 19 in f32 (a float32 walk)
    and df64, any n in f64.  The JAX package's ryser_xla.py:45-73 gives
    NaN on n18x30 in f32 and n12x1e25, -0.0 on n18x1e-5 in f32 and
    n12x1e-30."""
    got = spt.permanent(_mat(*CASES[case]), calc=calc, device="cpu")
    assert got.algo_name == f"ryser_walk_{calc}"
    _hold(got.permanent, _exact(CASES[case]), REL[calc])


@pytest.mark.parametrize("calc,case", [("df64", c) for c in SMALL]
                         + [("f64", c) for c in CASES])
def test_glynn_float64_route_range(calc, case):
    """perman_algo="glynn" on its float64 host route, columns scaled by
    powers of two (the JAX package's glynn.py:73-78 gives NaN on
    n12x1e25)."""
    got = spt.permanent(_mat(*CASES[case]), perman_algo="glynn", calc=calc,
                        device="cpu")
    assert got.algo_name == "glynn_host"
    _hold(got.permanent, _exact(CASES[case]), REL[calc])


@pytest.mark.parametrize("cases", [[c] for c in BELOW_13]
                         + [["n12x1e25", "n14x1e25"]])
def test_batch_walk_range(cases):
    """permanent_batch below n=13 walks the small-order batch walk (the
    JAX package's batch.py:31-58 gives NaN on n12x1e25 and -0.0 on
    n12x1e-30); in a batch beside n=14, which takes the batch kernel's
    plain version, both orders give inf."""
    shapes = [CASES.get(c, (14, 14, 1e25)) for c in cases]
    got = spt.permanent_batch([_mat(*s) for s in shapes], device="cpu")
    for res, s in zip(got, shapes):
        if s[0] < 13:
            assert res.algo_name == "ryser_walk_batch"
        _hold(res.permanent, _exact(s), REL["df64"])


def test_auto_probe_below_the_double_range():
    """calc="auto" probes with the df64 walk: on a matrix whose permanent
    is a subnormal double (2.28e-311) the JAX package answers -0.0; the
    port's scaled walk gives the value within 1e-10."""
    case = (12, 11, 1e-27)
    got = spt.permanent(_mat(*case), calc="auto", device="cpu")
    exact = _exact(case)
    assert 0.0 < float(exact) < np.finfo(np.float64).tiny
    _hold(got.permanent, exact, REL["df64"])


@pytest.mark.parametrize("case,kw", [
    ("n18x30", dict(calc="f32")), ("n18x1e-5", dict(calc="f32")),
    ("n12x1e25", dict(calc="df64")), ("n12x1e-30", dict(calc="df64")),
    ("n12x1e25", dict(perman_algo="glynn"))])
def test_reference_walks_the_matrix_as_given(case, kw):
    """The one deliberate difference from the JAX package: where its lane
    walk (ryser_xla.py:45-73, glynn.py:73-78) returns NaN or -0.0, the
    port returns the value a double holds, inf or +0.0."""
    a = _mat(*CASES[case])
    ref = sp.permanent(a, **kw).permanent
    got = spt.permanent(a, device="cpu", **kw).permanent
    assert math.isnan(ref) or (ref == 0.0 and math.copysign(1.0, ref) < 0)
    _hold(got, _exact(CASES[case]), REL[kw.get("calc", "df64")])


#: row (Glynn: column) exponents k_i, and the scale of the base matrix
#: that keeps the result a normal double: the first rows' 2^+-1400 take
#: an unscaled walk's partial products out of a double's range
SHIFTS = {"+1100": ([700, 700, -300] + [0] * 7, 2.0 ** -20),
          "-1100": ([-700, -700, 300] + [0] * 7, 2.0 ** 10),
          "mixed": ([3, -5, 0, 7, -1, 0, 2, 0, 0, -4], 1.0)}
ROUTES = {
    "ryser_walk_f64": lambda a: spt.permanent(a, calc="f64",
                                              device="cpu").permanent,
    "ryser_walk_f32": lambda a: spt.permanent(a, calc="f32",
                                              device="cpu").permanent,
    "batch": lambda a: spt.permanent_batch([a], device="cpu")[0].permanent,
    "glynn_host": lambda a: spt.permanent(a, perman_algo="glynn", calc="f64",
                                          device="cpu").permanent,
    "glynn_lanes": lambda a: glynn_scaled(a, lambda m: glynn_lanes(m, CPU)),
}


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("route", ROUTES)
def test_scale_equivariance(route, shift):
    """Row i (for Glynn column i) times 2^k_i multiplies the result by
    exactly 2^sum(k), bit for bit: the scaled walk sees the same matrix."""
    k, base = SHIFTS[shift]
    a = _mat(10, 7, base)
    p = ROUTES[route](a)
    assert np.isfinite(p) and abs(p) >= np.finfo(np.float64).tiny
    e = np.array(k)
    shifted = (np.ldexp(a, e[None, :]) if route.startswith("glynn")
               else np.ldexp(a, e[:, None]))
    want = np.ldexp(p, int(e.sum()))
    assert np.isfinite(want) and abs(want) >= np.finfo(np.float64).tiny
    assert ROUTES[route](shifted) == want


@pytest.mark.parametrize("n", [2, 5, 13, 17, 20])
def test_glynn_lanes_match_host_walk(n):
    """The torch lane walk of Glynn's flips (the float64 route on a card,
    run here on the CPU) against the host walk perman_glynn: rel 1e-12
    (other lane counts, so other sums)."""
    a = random_float_matrix(np.random.default_rng(n), n, 0.8)
    want = perman_glynn(a)
    assert want != 0.0
    assert glynn_lanes(a, CPU) == pytest.approx(want, rel=1e-12)
    assert glynn_scaled(a, lambda m: glynn_lanes(m, CPU)) == pytest.approx(
        want, rel=1e-12)


def test_lane_walls_times_every_lane_route():
    """tools/lane_walls.py's routes, here on the CPU, this tree beside
    itself loaded under another module name (as --against loads another
    checkout): each takes the lane walk its name says, and each median
    is a time; without a card its command line exits with a message."""
    import os
    from superman_tpu_torch.tools import lane_walls
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = lane_walls.load_tree(root, "superman_tpu_torch_walls_test")
    assert other is not spt and other.__name__ != spt.__name__
    got = lane_walls.walls({"this": spt, "other": other}, CPU, reps=2)
    want = {"float64 walk n=12": "ryser_walk_df64",
            "float32 walk n=12": "ryser_walk_f32",
            "glynn float64 n=12": "glynn_host",
            "float64 walk n=18": "ryser_walk_df64",
            "float32 walk n=18": "ryser_walk_f32",
            "glynn float64 n=18": "glynn_host",
            "batch walk 64 x n=12": "ryser_walk_batch"}
    # the lane walks' counter beside each wall; Glynn and the batch keep
    # none
    lanes = {"float64 walk n=12": (1024, 1, "float64"),
             "float32 walk n=12": (1024, 1, "float32"),
             "float64 walk n=18": (8192, 4, "float64"),
             "float32 walk n=18": (8192, 4, "float32")}
    for label in ("this", "other"):
        assert {k: v[label]["algo"] for k, v in got.items()} == want
        assert all(v[label]["ms"] > 0 for v in got.values())
        assert {k: (v[label]["lanes"]["lanes"], v[label]["lanes"]["r"],
                    v[label]["lanes"]["dtype"])
                for k, v in got.items() if v[label]["lanes"]} == lanes
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA card"):
            lane_walls.main([])
