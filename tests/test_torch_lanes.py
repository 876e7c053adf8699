"""The small-order route through the normal entry point, permanent(m) below
n=19 (ops/ryser_walk.ryser_walk, the float64 lane walk; float32 under
calc="f32"): its values against the plain reference and the exact
integer, its two spans and its counters, and the benchmark's readers of
them (permbench/metrics/, cell erdos_int_dense.n18_lanes) on canned
windows and on a short run of the cell on the CPU.  The suite's matrices
come from permbench.gen, the yardstick from permbench.reference."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import superman_tpu_torch as spt
from permbench import gen, harness, reference, roofline
from permbench.devtrace import Trace
from superman_tpu_torch.ops import oracle, ryser_walk as rw
from superman_tpu_torch.ops.ryser_walk import LANE_WALKS
from superman_tpu_torch.utils import trace

CELL = "erdos_int_dense.n18_lanes"
READERS = ("lane_init_ms", "lane_walk_ms", "lane_dispatch_ms",
           "lane_roofline", "lane_call_mfu", "lane_api_prepare_ms",
           "lane_idle_pct", "lane_call_p95_ms")
LANE_SPANS = ("lane_init", "lane_walk")
#: the float64 walk's rounding over 2^(n-1) terms of the suite's entries,
#: with room: it reads 1e-14 to 1e-13 against the reference here
F64_REL = 1e-12
#: (order, seed) of the int suite's d=0.50 matrices the tests walk
SUITE = [(12, 21), (15, 22), (18, 23)]
#: a large seed, as the benchmark's are
BIG_SEED = (1 << 31) + 977


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _names(res):
    return [name for name, _ in res.meta["spans"]]


@pytest.mark.parametrize("n,seed", SUITE)
def test_lane_route_matches_the_reference_and_the_exact_value(n, seed):
    """permanent(m) with no flags takes the float64 lane walk below n=19,
    within F64_REL of the plain reference; up to n=16 also of the port's
    exact integer (calc="exact")."""
    for k, m in enumerate(gen.pool(seed, n, 0.5, 2)):
        res = spt.permanent(m, device="cpu")
        assert res.algo_name == "ryser_walk_df64", k
        want = reference.perm_f64(m)
        assert abs(res.permanent - want) <= F64_REL * abs(want), k
        if n <= 16:
            exact = spt.permanent(m, device="cpu", calc="exact")
            frac = exact.meta["exact_fraction"]
            assert isinstance(frac, Fraction) and frac.denominator == 1
            assert abs(Fraction(res.permanent) - frac) <= F64_REL * frac, k


@pytest.mark.parametrize("calc,dtype", [(None, "float64"),
                                        ("f32", "float32"),
                                        ("f32k", "float64")])
def test_lane_counter_at_n18(calc, dtype):
    """meta["lane_walk"]: 8,192 lanes of 2^4 steps, the 15 Gray steps after
    each lane's start, in float64 but under calc="f32"."""
    m = gen.pool(BIG_SEED, 18, 0.5, 1)[0]
    kw = {} if calc is None else {"calc": calc}
    res = spt.permanent(m, device="cpu", **kw)
    assert res.meta["lane_walk"] == {"lanes": 8192, "r": 4, "steps": 15,
                                 "dtype": dtype}
    assert res.iterations == 1 << 17


@pytest.mark.parametrize("n,lanes,r", [(3, 2, 1), (12, 1024, 1),
                                       (15, 8192, 1), (16, 8192, 2)])
def test_lane_counter_across_orders(n, lanes, r):
    """Half the steps a lane up to MAX_LANES lanes, then longer lanes."""
    res = spt.permanent(gen.pool(7, n, 0.5, 1)[0], device="cpu")
    assert res.meta["lane_walk"] == {"lanes": lanes, "r": r,
                                 "steps": (1 << r) - 1, "dtype": "float64"}
    assert lanes << r == 1 << (n - 1)


@pytest.mark.parametrize("calc,dtype", [(None, "float64"),
                                        ("f32", "float32")])
def test_lane_walk_counter_moves_by_one_a_call(calc, dtype):
    m = gen.pool(3, 14, 0.5, 1)[0]
    kw = {} if calc is None else {"calc": calc}
    before = dict(LANE_WALKS)
    for k in range(3):
        spt.permanent(m, device="cpu", **kw)
        assert LANE_WALKS[dtype] == before.get(dtype, 0) + k + 1
    assert {d: v for d, v in LANE_WALKS.items() if d != dtype} == {
        d: v for d, v in before.items() if d != dtype}


def test_kernel_route_walks_no_lanes():
    """From n=19 the call takes K1's route: no lane span, no lane walk."""
    m = gen.pool(4, 19, 0.5, 1)[0]
    before = dict(LANE_WALKS)
    res = spt.permanent(m, device="cpu")
    assert not set(LANE_SPANS) & set(_names(res))
    assert "walk" in _names(res)
    assert dict(LANE_WALKS) == before


def test_kernel_route_keeps_its_lane_count():
    """The kernel route's meta["lanes"] stays its plan's lane count, an
    int; the lane walk's record has a key of its own."""
    res = spt.permanent(gen.pool(4, 19, 0.5, 1)[0], device="cpu")
    assert isinstance(res.meta["lanes"], int)
    assert "lane_walk" not in res.meta


# ---- the lanes' start, bit for bit the product's

def _start_by_product(a, C, r):
    """The lanes' start as oracle.gray_init_lanes makes it: the lane-bit
    table times the columns."""
    return oracle.gray_init_lanes(a, np.arange(C, dtype=np.int64), r,
                                  dtype=np.float64)


def _walk_by_product(a, dtype=torch.float64):
    """ryser_walk's value with its lanes started by _start_by_product."""
    n = a.shape[0]
    s = rw.walk_scales(a)
    a = np.ldexp(a, -s[:, None])
    C = min(1 << (n - 2), rw.MAX_LANES)
    r = ((1 << (n - 1)) // C).bit_length() - 1
    X, sign_mid = _start_by_product(a, C, r)
    acc = rw.walk_lanes(torch.as_tensor(X).to(dtype),
                        torch.as_tensor(sign_mid).to(dtype),
                        torch.as_tensor(np.ascontiguousarray(
                            a[:, : n - 1].T)).to(dtype), r)
    total = float(np.sum(acc.numpy().astype(np.float64)))
    return float(rw.times_pow2((4 * (n & 1) - 2) * total, int(s.sum())))


def _float_matrix(rng, n):
    """Entries of mixed signs over ~2^+-20, zeros among them: sums that
    round."""
    a = rng.standard_normal((n, n)) * np.exp2(rng.integers(-20, 20, (n, n)))
    a[rng.random((n, n)) < 0.2] = 0.0
    return a


@pytest.mark.parametrize("n", [3, 4, 7, 12, 15, 16, 18])
def test_lane_x_is_the_products_start_bitwise(n):
    """lane_x sums each lane's columns in the product's order: the same
    float64 bits on rounding sums, on the suite's integers and with
    -0.0 entries."""
    rng = np.random.default_rng(1000 + n)
    C = min(1 << (n - 2), rw.MAX_LANES)
    r = ((1 << (n - 1)) // C).bit_length() - 1
    mats = [_float_matrix(rng, n) for _ in range(4)]
    mats += [np.asarray(m, dtype=np.float64)
             for m in gen.pool(BIG_SEED, n, 0.5, 2)]
    neg0 = _float_matrix(rng, n)
    neg0[neg0 == 0.0] = -0.0
    mats.append(neg0)
    for k, a in enumerate(mats):
        a = np.ldexp(a, -rw.walk_scales(a)[:, None])
        want = _start_by_product(a, C, r)[0]
        got = rw.lane_x(a, C, r, np.empty((C, n)), np.empty((2 * C, n)))
        assert got.tobytes() == want.tobytes(), k


@pytest.mark.parametrize("n", [5, 11, 18])
def test_lane_route_value_is_the_products_bitwise(n):
    """permanent(m) below n=19 gives the bits of the walk started by the
    product, in float64 and in float32."""
    rng = np.random.default_rng(2000 + n)
    for k in range(3):
        a = _float_matrix(rng, n)
        for calc, dtype in ((None, torch.float64), ("f32", torch.float32)):
            kw = {} if calc is None else {"calc": calc}
            got = spt.permanent(a, device="cpu", **kw).permanent
            want = _walk_by_product(a, dtype)
            assert np.float64(got).tobytes() == \
                np.float64(want).tobytes(), (k, calc)


def test_lane_route_makes_no_product_on_finite_matrices(monkeypatch):
    """A finite matrix's lanes start without gray_init_lanes' product;
    a matrix with a non-finite entry (which the API refuses, so only a
    direct call of ryser_walk) takes it, as before: 0 times inf is NaN
    there, and the value is the product's."""
    def refuse(*args, **kwargs):
        raise AssertionError("gray_init_lanes called")
    a = _float_matrix(np.random.default_rng(5), 12)
    with monkeypatch.context() as mp:
        mp.setattr(rw, "gray_init_lanes", refuse)
        spt.permanent(a, device="cpu")
    for bad in (np.inf, -np.inf, np.nan):
        b = a.copy()
        b[3, 7] = bad
        got, _ = rw.ryser_walk(b, torch.device("cpu"))
        want = _walk_by_product(b)
        assert np.float64(got).tobytes() == np.float64(want).tobytes(), bad


@pytest.mark.parametrize("n", [12, 18])
def test_lane_spans_once_a_call(n):
    res = spt.permanent(gen.pool(9, n, 0.5, 1)[0], device="cpu")
    assert _names(res) == ["api_prepare", "lane_init", "lane_walk",
                           "permanent[auto]"]


def test_lane_spans_are_leaves_on_the_profilers_timeline():
    from torch.profiler import ProfilerActivity, profile
    m = gen.pool(9, 18, 0.5, 1)[0]
    spt.permanent(m, device="cpu")                     # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = spt.permanent(m, device="cpu")
    ranges = sorted(
        (ev.start_ns(), ev.start_ns() + ev.duration_ns(),
         ev.name()[len(trace.SPAN):])
        for ev in prof.profiler.kineto_results.events()
        if ev.name().startswith(trace.SPAN)
        and str(ev.device_type()).endswith("CPU")
        and not ev.name().startswith(trace.SPAN + "permanent["))
    assert [n for _, _, n in ranges] == ["api_prepare", *LANE_SPANS]
    for (s0, e0, n0), (s1, e1, n1) in zip(ranges, ranges[1:]):
        assert e0 <= s1, f"{n0} [{s0}, {e0}] overlaps {n1} [{s1}, {e1}]"
    assert sorted(n for _, _, n in ranges) == sorted(
        n for n in _names(res) if not n.startswith("permanent["))


def test_lane_spans_hold_most_of_the_call():
    """The two spans cover the walk's host and device work: with
    api_prepare, most of the call's own clock."""
    m = gen.pool(11, 18, 0.5, 1)[0]
    spt.permanent(m, device="cpu")
    res = spt.permanent(m, device="cpu")
    spans = dict(res.meta["spans"])
    inner = spans["api_prepare"] + spans["lane_init"] + spans["lane_walk"]
    assert inner >= 0.5 * spans["permanent[auto]"]


# ---- the cell's readers on canned windows

def _ctx(calls=4, spans=True, device_s=None, window_s=None, on_card=True):
    """A traced window of `calls` n=18 df64 calls of 2 ms; device_s
    defaults to the walk at its bound in one kernel, with copies."""
    cell = harness.load_cell(CELL)
    n = cell.traffic["order"]
    least = roofline.least_s(roofline.walk_ops(n, 1 << (n - 1)), "fp64")
    span = ({"api_prepare": 1e-4, "lane_init": 5e-4, "lane_walk": 1.2e-3,
             "permanent[auto]": 1.9e-3} if spans
            else {"api_prepare": 1e-4, "permanent[auto]": 1.9e-3})
    cs = [harness.Call(item=k, wall_s=2e-3, perms=1, spans=dict(span),
                       calc="df64", iterations=1 << (n - 1))
          for k in range(calls)]
    dev = {"elementwise_kernel": calls * least,
           "Memcpy HtoD ": 1.0, "Memset ": 1.0} if device_s is None \
        else device_s
    return harness.Context(
        cell=cell, calls=cs, n=n, batch=1, on_card=on_card,
        window_s=calls * 2e-3 if window_s is None else window_s,
        trace=Trace(device_s=dev))


def _read(name, ctx):
    return harness.load_metric(harness.CHECKOUT, name).read(ctx)


def test_the_cell_loads_its_readers():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["order"] == 18
    assert cell.traffic["calc"] is None
    assert cell.traffic["control_calc"] == "f32"
    assert [e["name"] for e, _ in cell.per_layer] == list(READERS)
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                     "perms_per_s"}


@pytest.mark.parametrize("name,ms", [("lane_init_ms", 0.5),
                                     ("lane_walk_ms", 1.2),
                                     ("lane_dispatch_ms", 0.2)])
def test_lane_span_readers(name, ms):
    """ms a call, and None on a window whose calls recorded no lane span
    (a tree without them)."""
    assert _read(name, _ctx()) == pytest.approx(ms)
    assert _read(name, _ctx(spans=False)) is None


def test_lane_api_prepare_reader():
    assert _read("lane_api_prepare_ms", _ctx()) == pytest.approx(0.1)


def test_lane_call_p95_reads_the_stalls():
    """One call in ten stalled at 20 ms: the tail shows it, the median
    call does not."""
    ctx = _ctx(calls=20)
    for c in ctx.calls[::10]:
        c.wall_s = 20e-3
    assert _read("lane_call_p95_ms", ctx) == pytest.approx(20.0)
    assert _read("lane_call_p95_ms", _ctx()) == pytest.approx(2.0)


def test_lane_idle_pct_over_the_window():
    ctx = _ctx()
    ctx.trace.busy_s, ctx.trace.window_s = 0.25, 10.0
    assert _read("lane_idle_pct", ctx) == pytest.approx(97.5)
    assert _read("lane_idle_pct", _ctx()) is None      # no device time


def test_lane_roofline_leaves_copies_and_sets_out():
    """The walk at its bound in its kernels reads 100%, whatever the
    copies and sets took; twice the kernels' seconds half."""
    ctx = _ctx()
    assert _read("lane_roofline", ctx) == pytest.approx(100.0)
    k = ctx.trace.device_s["elementwise_kernel"]
    twice = _ctx(device_s={"a": k, "b": k, "Memcpy DtoH ": 5.0})
    assert _read("lane_roofline", twice) == pytest.approx(50.0)
    assert _read("lane_roofline", _ctx(device_s={"Memcpy HtoD ": 1.0})) \
        is None
    assert _read("lane_roofline", _ctx(on_card=False)) is None


def test_lane_call_mfu_over_the_window():
    ctx = _ctx()
    least = ctx.calls[0].perms * roofline.least_s(
        roofline.walk_ops(18, 1 << 17), "fp64")
    assert _read("lane_call_mfu", ctx) == pytest.approx(
        100.0 * least / 2e-3)
    assert _read("lane_call_mfu", _ctx(on_card=False)) is None


def test_the_readers_of_a_run_with_nothing_to_read():
    """No call in the window: every reader is None, none raises."""
    empty = _ctx(calls=0, device_s={}, window_s=30.0)
    for name in READERS:
        assert _read(name, empty) is None, name


# ---- the cell on the CPU

def _run(control=False, traced=False):
    return harness.run_cell(harness.load_cell(CELL), BIG_SEED, 1.0, traced,
                            device="cpu", control=control,
                            log=lambda msg: None)


def test_the_cell_runs_correct_on_the_cpu():
    line = _run()
    assert line["correct"] is True and line["failed"] == 0
    err, limit = line["checks"]["max_rel_err"]
    assert err <= F64_REL and limit == 1e-9
    assert set(line["metrics"]) == {"setup_s", "perms_per_s"}


def test_the_cells_control_fails_its_check():
    """The float32 walk misses the df64 guarantee by orders."""
    line = _run(control=True)
    assert line["correct"] is False and line["failed"] == 0
    err, limit = line["checks"]["max_rel_err"]
    assert err > 100 * limit


def test_a_traced_cpu_run_reads_the_spans_alone():
    """On the CPU the span readers and the host clock's tail read; the
    device's readers give nothing (no card), and none raises."""
    line = _run(traced=True)
    assert line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(got) == {"lane_init_ms", "lane_walk_ms", "lane_dispatch_ms",
                        "lane_api_prepare_ms", "lane_call_p95_ms"}
    assert all(v > 0 for v in got.values())
