"""The range of the port's exact and estimating routes past the lane walks:
the long-double host walks (calc="tf96" below n=19, dense and sparse, and
calc="auto" there; Glynn's tf96 and quad; calc="quad" without the native
engine), the native CPU engine (calc="quad", cpu=True dense, sparse and
SkipPer, read_calculate_return), orders 1 and 2, and the scaling
estimator (its batch of trials, the SMC populations, the native
engine's).  Each scales its rows (Glynn: columns) by exact powers of two
and multiplies back by 2^E (ops/ryser_walk.walk_scales, times_pow2;
native/perman_cpu.cpp scale_rows).  The JAX package walks the matrix as
given on every one of them: NaN where a product overflows, -0.0 where all
underflow (test_reference_walks_the_matrix_as_given).

Matrices are np.random.default_rng(seed).integers(1, 5, (n, n)) times a
scale, at 1e300 with a random sign on each entry (default_rng(seed + 1));
"rows2^+-600" moves alternate rows by 2^600 and 2^-600, so the permanent
is a double's while the unscaled products overflow (Glynn's routes take
the transpose: each formula scales the lines it sums across, and one
whose summed lines stand 2^1200 apart loses the small ones, in both
packages).  The estimators take default_rng(16).random((16, 16)), all
positive.  Each value is held to the JAX package's calc="exact" fraction
on the same matrix (meta["exact_fraction"]): +-inf where it is beyond a
double, +0.0 (the sign checked) where it is below one, else within the
tier's contract: 1e-14 for the long-double and __float128 walks, 1e-10
for the double ones, 4 stderr for an estimate.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

import superman_tpu as sp
import superman_tpu.bindings.native as jnative
import superman_tpu_torch as spt
from superman_tpu.core.flags import Flags as JFlags
from superman_tpu.core.matrix import DenseMatrix as JDense
from superman_tpu_torch.bindings import native
from superman_tpu_torch.core.matrix import DenseMatrix
from superman_tpu_torch.io.triplet import write_triplet
from superman_tpu_torch.ops import approx, batch

CPU = torch.device("cpu")
THREADS = 1
#: (scale, signed): four scales whose permanents at n=18 lie beyond or
#: below a double, a finite permanent (1e15) and one whose rows leave a
#: double's products
SCALES = {"1e300s": (1e300, True), "1e25": (1e25, False),
          "1e-30": (1e-30, False), "1e-300": (1e-300, False),
          "1e15": (1e15, False), "rows2^+-600": (600, False)}
RANGE4 = ["1e300s", "1e25", "1e-30", "1e-300"]
REL = {"long": 1e-14, "double": 1e-10}
_EXACT = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _mat(n, seed, scale):
    """The seeded matrix at a SCALES entry (or a plain float scale)."""
    a = np.random.default_rng(seed).integers(1, 5, (n, n)).astype(np.float64)
    if scale == "rows2^+-600":
        return np.ldexp(a, np.where(np.arange(n) % 2, -600, 600)[:, None])
    value, signed = SCALES[scale] if isinstance(scale, str) else (scale, 0)
    if signed:
        a *= np.where(np.random.default_rng(seed + 1).random((n, n)) < 0.5,
                      -1, 1)
    return a * value


def _est_mat(scale):
    a = np.random.default_rng(16).random((16, 16))
    if scale == "rows2^+-600":
        return np.ldexp(a, np.where(np.arange(16) % 2, -600, 600)[:, None])
    return a * SCALES[scale][0]


def _exact(a) -> Fraction:
    key = a.tobytes() + bytes(a.shape)
    if key not in _EXACT:
        _EXACT[key] = sp.permanent(a, calc="exact").meta["exact_fraction"]
    return _EXACT[key]


def _hold(got: float, exact: Fraction, rel: float, stderr=None):
    """got against the exact value: +-inf beyond a double, +0.0 below one,
    else within rel (or within 4 stderr for an estimate)."""
    try:
        want = float(exact)
    except OverflowError:
        want = math.inf if exact > 0 else -math.inf
    assert not math.isnan(got)
    if math.isinf(want):
        assert got == want
    elif want == 0.0:
        assert got == 0.0 and math.copysign(1.0, got) == 1.0
    elif stderr is not None:
        assert abs(got - want) <= 4 * stderr, (got, want, stderr)
    else:
        assert abs(Fraction(got) - exact) <= rel * abs(exact), (got, want)


def _no_native(monkeypatch):
    monkeypatch.setattr(native, "native_available", lambda: False)
    monkeypatch.setattr(jnative, "native_available", lambda: False)


def _triplet(a, tmp_path):
    path = str(tmp_path / "m.txt")
    write_triplet(path, DenseMatrix(a, "double"))
    return path


#: route -> (the port's call, its algo_name or None, its contract); each
#: call takes (matrix, tmp_path, monkeypatch) and gives a Result or float
ROUTES = {
    "tf96": (lambda a, t, mp: spt.permanent(a, calc="tf96", device="cpu"),
             "ryser_tf96_host", "long"),
    "tf96_sparse": (lambda a, t, mp: spt.permanent(
        a, calc="tf96", sparse=True, device="cpu"),
        "sparyser_tf96_host", "long"),
    "auto": (lambda a, t, mp: spt.permanent(a, calc="auto", device="cpu"),
             None, "double"),
    "glynn_tf96": (lambda a, t, mp: spt.permanent(
        a, calc="tf96", perman_algo="glynn", device="cpu"),
        "glynn_host", "long"),
    "quad_host": (lambda a, t, mp: _no_native(mp) or spt.permanent(
        a, calc="quad", device="cpu"), "ryser_quad_host", "long"),
    "glynn_quad_host": (lambda a, t, mp: _no_native(mp) or spt.permanent(
        a, calc="quad", perman_algo="glynn", device="cpu"),
        "glynn_host", "long"),
    "quad_native": (lambda a, t, mp: spt.permanent(
        a, calc="quad", threads=THREADS, device="cpu"),
        "cpu_ryser_quad", "long"),
    "cpu_ryser": (lambda a, t, mp: spt.permanent(
        a, cpu=True, gpu=False, threads=THREADS, device="cpu"),
        "cpu_ryser", "double"),
    "cpu_sparyser": (lambda a, t, mp: spt.permanent(
        a, cpu=True, gpu=False, sparse=True, threads=THREADS,
        device="cpu"), "cpu_sparyser", "double"),
    "cpu_skipper": (lambda a, t, mp: spt.permanent(
        a, cpu=True, gpu=False, sparse=True, preprocessing=2,
        threads=THREADS, device="cpu"), "cpu_skipper", "double"),
    "read_calculate_return": (lambda a, t, mp: native.read_calculate_return(
        _triplet(a, t), 5, nt=THREADS), None, "double"),
}
#: orders 1 and 2: (n, seed) or the cancelling [[1, 1], [1, -1]]
SMALL = {"n1": (1, 3), "n2": (2, 5), "n2_cancelling": None}
SMALL_ROUTES = {
    "ryser": lambda a: spt.permanent(a, device="cpu"),
    "glynn": lambda a: spt.permanent(a, perman_algo="glynn", device="cpu"),
    "tf96": lambda a: spt.permanent(a, calc="tf96", device="cpu"),
    "quad_native": lambda a: spt.permanent(a, calc="quad", device="cpu",
                                           threads=THREADS),
    "permanent_batch": lambda a: spt.permanent_batch([a, a],
                                                     device="cpu")[1],
    "batch_same_n": lambda a: float(batch.permanent_batch_same_n(
        a[None], CPU)[0]),
}
ESTIMATORS = {
    "sis": lambda a: spt.permanent(a, approximation=True,
                                   perman_algo="scaling",
                                   number_of_times=4000, seed=1,
                                   device="cpu"),
    "smc": lambda a: spt.permanent(a, approximation=True,
                                   perman_algo="scaling", smc=1,
                                   number_of_times=4096, seed=1,
                                   scale_intervals=4, device="cpu"),
    "native": lambda a: native.perman_native(
        DenseMatrix(a, "double"),
        spt.Flags(approximation=True, perman_algo="scaling",
                  number_of_times=4000, threads=THREADS, seed=1,
                  scale_intervals=4)),
}


def _small(case, scale):
    if SMALL[case] is None:
        a = np.array([[1.0, 1.0], [1.0, -1.0]])
        return a * (1e300 if scale == "1e300s" else SCALES[scale][0])
    return _mat(*SMALL[case], scale)


def _value(res):
    return res if isinstance(res, float) else res.permanent


@pytest.mark.parametrize(
    "route,scale",
    [(r, s) for r in ROUTES for s in SCALES]
    + [(f"{r}:{c}", s) for r in SMALL_ROUTES for c in SMALL
       for s in RANGE4]
    + [(f"est:{e}", s) for e in ESTIMATORS
       for s in RANGE4 + ["rows2^+-600"]])
def test_route_range(route, scale, tmp_path, monkeypatch):
    """Every route at every scale against the JAX package's calc="exact":
    never NaN or -0.0; +-inf, +0.0 or a value within the route's
    contract."""
    if route.startswith("est:"):
        a = _est_mat(scale)
        res = ESTIMATORS[route[4:]](a)
        # the native estimator reports no stderr: 5% is 4 of the SIS
        # batch's at these trials (1.2%)
        _hold(res.permanent, _exact(a), 0.05, res.meta.get("stderr"))
        return
    if ":" in route:
        r, case = route.split(":")
        a = _small(case, scale)
        _hold(_value(SMALL_ROUTES[r](a)), _exact(a), REL["double"])
        return
    call, name, contract = ROUTES[route]
    a = _mat(18, 18, scale)
    if route.startswith("glynn"):
        a = a.T.copy()              # Glynn scales the lines it sums across
    exact = _exact(a)               # before the routes that unload native
    res = call(a, tmp_path, monkeypatch)
    if name is not None:
        assert res.algo_name == name
    if route.startswith("glynn"):
        assert res.meta["calc"] == route.split("_")[1]
    _hold(_value(res), exact, REL[contract])


#: (route, scale, the JAX package's value there): its NaN or -0.0
DEFECTS = [
    ("tf96", "1e300s", "nan"), ("tf96", "1e-300", "-0.0"),
    ("tf96_sparse", "1e300s", "nan"), ("auto", "1e300s", "nan"),
    ("auto", "1e-30", "-0.0"), ("glynn_tf96", "1e300s", "nan"),
    ("quad_native", "1e300s", "nan"), ("quad_native", "1e-300", "-0.0"),
    ("cpu_ryser", "1e25", "nan"), ("cpu_ryser", "1e-30", "-0.0"),
    ("cpu_sparyser", "1e25", "nan"), ("cpu_skipper", "1e-300", "-0.0"),
    ("read_calculate_return", "1e25", "nan"),
    ("ryser:n2_cancelling", "1e300s", "nan"),
    ("quad_native:n2_cancelling", "1e300s", "-0.0"),
    ("est:sis", "1e300s", "nan")]
JAX_ROUTES = {
    "tf96": lambda a, t: sp.permanent(a, calc="tf96").permanent,
    "tf96_sparse": lambda a, t: sp.permanent(a, calc="tf96",
                                             sparse=True).permanent,
    "auto": lambda a, t: sp.permanent(a, calc="auto").permanent,
    "glynn_tf96": lambda a, t: sp.permanent(a, calc="tf96",
                                            perman_algo="glynn").permanent,
    "quad_native": lambda a, t: sp.permanent(a, calc="quad",
                                             threads=THREADS).permanent,
    "cpu_ryser": lambda a, t: sp.permanent(a, cpu=True, gpu=False,
                                           threads=THREADS).permanent,
    "cpu_sparyser": lambda a, t: sp.permanent(
        a, cpu=True, gpu=False, sparse=True, threads=THREADS).permanent,
    "cpu_skipper": lambda a, t: sp.permanent(
        a, cpu=True, gpu=False, sparse=True, preprocessing=2,
        threads=THREADS).permanent,
    "read_calculate_return": lambda a, t: jnative.read_calculate_return(
        _triplet(a, t), 5, nt=THREADS),
    "ryser": lambda a, t: sp.permanent(a).permanent,
    "est:sis": lambda a, t: sp.permanent(
        a, approximation=True, perman_algo="scaling", number_of_times=256,
        seed=1).permanent,
}


@pytest.mark.parametrize("route,scale,ref_value", DEFECTS)
def test_reference_walks_the_matrix_as_given(route, scale, ref_value,
                                             tmp_path, monkeypatch):
    """The deliberate difference from the JAX package: its host walks
    (ryser.py:257-266, glynn.py:73-80), its native engine
    (perman_cpu.cpp's walks on the matrix as given), its orders 1-2
    (ryser.py:251-253) and its scaling estimator (approx.py:634-, float32
    trials of entries past 2^128) give NaN or -0.0 where the port gives
    the value a double holds, inf or +0.0."""
    if route.startswith("est:"):
        a = _est_mat(scale)
        got = ESTIMATORS[route[4:]](a).permanent
    elif ":" in route:
        r, case = route.split(":")
        a = _small(case, scale)
        got = _value(SMALL_ROUTES[r](a))
        route = r
    else:
        a = _mat(18, 18, scale)
        got = _value(ROUTES[route][0](a, tmp_path, monkeypatch))
    ref = JAX_ROUTES[route](a, tmp_path)
    if ref_value == "nan":
        assert math.isnan(ref)
    else:
        assert ref == 0.0 and math.copysign(1.0, ref) < 0
    _hold(got, _exact(a), REL["double"])


#: row (Glynn: column) exponents k_i with sum +-1100, multiples of 100
#: (the estimators' step), and the scale of the base n=10 matrix, and of
#: the n=2 one, that keeps the result a normal double
SHIFTS = {"+1100": ([700, 700, -300] + [0] * 7, 2.0 ** -20,
                    [700, 400], 2.0 ** -45),
          "-1100": ([-700, -700, 300] + [0] * 7, 2.0 ** 10,
                    [-700, -400], 2.0 ** 40)}
#: route -> (the port's call, the JAX package's same route or None);
#: each takes (matrix, tmp_path, monkeypatch) and gives a float
EQUIVARIANT = {
    name: (lambda a, t, mp, c=call: _value(c(a, t, mp)),
           (lambda a, t, mp, j=JAX_ROUTES.get(name): j(a, t))
           if name in JAX_ROUTES else None)
    for name, (call, _, _) in ROUTES.items() if name != "auto"}
EQUIVARIANT["quad_host"] = (EQUIVARIANT["quad_host"][0],
                            lambda a, t, mp: _no_native(mp) or sp.permanent(
                                a, calc="quad").permanent)
EQUIVARIANT["glynn_quad_host"] = (
    EQUIVARIANT["glynn_quad_host"][0],
    lambda a, t, mp: _no_native(mp) or sp.permanent(
        a, calc="quad", perman_algo="glynn").permanent)
EQUIVARIANT.update({
    "n2_ryser": (lambda a, t, mp: spt.permanent(a, device="cpu").permanent,
                 lambda a, t, mp: sp.permanent(a).permanent),
    "n2_glynn": (lambda a, t, mp: spt.permanent(
        a, perman_algo="glynn", device="cpu").permanent,
        lambda a, t, mp: sp.permanent(a, perman_algo="glynn").permanent),
    "n2_batch_same_n": (lambda a, t, mp: float(batch.permanent_batch_same_n(
        a[None], CPU)[0]), None),
    "est:sis": (lambda a, t, mp: ESTIMATORS["sis"](a).permanent, None),
    "est:smc": (lambda a, t, mp: ESTIMATORS["smc"](a).permanent, None),
    "est:native": (lambda a, t, mp: ESTIMATORS["native"](a).permanent,
                   lambda a, t, mp: jnative.perman_native(
                       JDense(a, "double"),
                       JFlags(approximation=True, perman_algo="scaling",
                              number_of_times=4000, threads=THREADS, seed=1,
                              scale_intervals=4)).permanent),
})


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("route", EQUIVARIANT)
def test_scale_equivariance(route, shift, tmp_path, monkeypatch):
    """Row i (Glynn: column i) times 2^k_i multiplies the result by exactly
    2^sum(k), bit for bit: the scaled route sees the same matrix.  And
    where no product leaves the range, the result is the JAX package's on
    the same route bit for bit (a power of two commutes with every IEEE
    operation that stays normal; its native engine's with the same
    seed)."""
    k, base, k2, base2 = SHIFTS[shift]
    if route.startswith("n2"):
        k, a = k2, _mat(2, 7, base2)
    elif route.startswith("est:"):
        a = np.random.default_rng(7).integers(1, 5, (10, 10)) * base
    else:
        a = _mat(10, 7, base)
    port, ref = EQUIVARIANT[route]
    p = port(a, tmp_path, monkeypatch)
    assert np.isfinite(p) and abs(p) >= np.finfo(np.float64).tiny
    if ref is not None:
        assert ref(a, tmp_path, monkeypatch) == p
    e = np.array(k)
    shifted = (np.ldexp(a, e[None, :]) if "glynn" in route
               else np.ldexp(a, e[:, None]))
    want = np.ldexp(p, int(e.sum()))
    assert np.isfinite(want) and abs(want) >= np.finfo(np.float64).tiny
    assert port(shifted, tmp_path, monkeypatch) == want


@pytest.mark.parametrize("smc", [0, 1])
def test_estimator_in_range_draws_on_the_matrix_as_given(monkeypatch, smc):
    """Rows within 2^+-50 of 1 keep their entries (exponents in steps of
    approx.ESTIMATOR_STEP): the trials see the matrix as given, so an
    estimate whose entries the float32 trials hold is the one it was
    before the scales, bit for bit; a matrix past that range reaches them
    scaled, and the estimate comes back times 2^E."""
    seen = []
    real = approx._device_matrices

    def record(a, device):
        seen.append(np.array(a))
        return real(a, device)

    monkeypatch.setattr(approx, "_device_matrices", record)
    a = np.random.default_rng(3).random((8, 8)) * 1e10
    ESTIMATORS["smc" if smc else "sis"](a)
    assert all(np.array_equal(m, a) for m in seen) and seen
    seen.clear()
    big = np.ldexp(a, 300)
    got = ESTIMATORS["smc" if smc else "sis"](big)
    assert all(np.array_equal(m, np.ldexp(big, -300)) for m in seen)
    assert got.permanent == math.inf


def test_lane_walls_host_routes():
    """tools/lane_walls.py --host times the n=18 tf96 host walk and the
    native n=32 double walk (on chip_smoke.py's n=32 matrix); here on the
    CPU the tf96 route only (the native n=32 walk takes minutes on one
    core): it takes the long-double host walk."""
    from superman_tpu_torch.tools import lane_walls
    calls = lane_walls.routes(spt, CPU, host=True)
    assert list(calls) == ["tf96 host walk n=18", "native double walk n=32"]
    res = calls["tf96 host walk n=18"]()
    assert res.algo_name == "ryser_tf96_host"
    _hold(res.permanent, _exact(lane_walls.mat(18, 18)), REL["long"])
