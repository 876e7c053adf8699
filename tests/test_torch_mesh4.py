"""SUPerman's multi-GPU deployment through the normal entry point,
permanent(m, perman_algo="multi", gpu_num=4), on four "cpu" mesh entries
(the kernels' plain versions): bitwise the one-device value, its spans
and per-entry counters, and the benchmark's readers of them
(permbench/metrics/, cell erdos_int_dense_mesh4.n38_mesh4) on canned
runs.  The suite's matrices come from permbench.gen, the yardstick from
permbench.reference."""

import pytest
import torch

import superman_tpu_torch as spt
from permbench import gen, harness, reference, roofline
from permbench.devtrace import Trace

MESH4 = {"perman_algo": "multi", "gpu_num": 4}
MESH_SPANS = ("mesh_launch", "mesh_wait", "mesh_gather")
#: (order, seed) of the int suite's d=0.50 matrices the tests walk
SUITE = [(20, 11), (21, 12), (22, 13)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _suite(n, seed):
    return gen.suite_matrix(gen.item_rng(seed, n, 0.5, 0), n, 0.5)


def _names(res):
    return [name for name, _ in res.meta["spans"]]


@pytest.mark.parametrize("calc", ["df64", "f32", "f32k"])
@pytest.mark.parametrize("n,seed", SUITE)
def test_mesh4_is_bitwise_the_one_device_value(n, seed, calc):
    """The deal over four entries keeps the one-device plan and block
    order, so the value is the one-device value to the last bit; in df64
    both are float64 sums of the same terms as the reference's, within
    1e-12 of it."""
    a = _suite(n, seed)
    one = spt.permanent(a, calc=calc, device="cpu")
    four = spt.permanent(a, calc=calc, device="cpu", **MESH4)
    assert four.permanent == one.permanent
    assert four.meta["mesh"] == 4 and one.meta["mesh"] is None
    if calc == "df64":
        want = reference.perm_f64(a)
        assert abs(four.permanent - want) <= 1e-12 * abs(want)


#: (one device's flags, the same call's flags over four entries)
SPAN_CASES = {"ryser": ({}, MESH4),
              "glynn": ({"perman_algo": "glynn"},
                        {"perman_algo": "glynn", "mesh_shape": (4,)})}


@pytest.mark.parametrize("algo", sorted(SPAN_CASES))
def test_mesh4_spans_stand_in_for_walk(algo):
    """A dealt walk records the deal's three spans and no `walk`; one
    device keeps `walk` and none of the three."""
    a = _suite(20, 11)
    one_kw, four_kw = SPAN_CASES[algo]
    one = _names(spt.permanent(a, device="cpu", **one_kw))
    four = _names(spt.permanent(a, device="cpu", **four_kw))
    assert "walk" not in four and "walk" in one
    for name in MESH_SPANS:
        assert name in four and name not in one
    # launch, wait and gather of the one attempt
    assert [s for s in four if s.startswith("mesh_")] == [
        "mesh_launch", "mesh_wait", "mesh_gather"]


def _two_processes(monkeypatch):
    # this process as the first of two, whose host total is its own
    from superman_tpu_torch.parallel import mesh, multihost
    monkeypatch.setattr(mesh, "process_info", lambda: (0, 2))
    monkeypatch.setattr(multihost, "combine_host_totals", lambda t: t)


#: routes over a mesh of four that do not deal the walk themselves: the
#: hybrid scheduler's device worker, and one of several processes
OTHER_ROUTES = {"hybrid": ({"hybrid": True}, None),
                "processes": ({}, _two_processes)}


@pytest.mark.parametrize("route", sorted(OTHER_ROUTES))
def test_mesh4_spans_keep_walk_off_the_plain_deal(route, monkeypatch):
    """The scheduler's device worker and a process of several keep the
    caller's `walk` around their share of the walk: no mesh span, no
    per-entry counters."""
    flags, setup = OTHER_ROUTES[route]
    if setup is not None:
        setup(monkeypatch)
    res = spt.permanent(_suite(20, 11), device="cpu", mesh_shape=(4,),
                        **flags)
    names = _names(res)
    assert res.meta["mesh"] == 4
    assert "walk" in names
    assert not [s for s in names if s.startswith("mesh_")]
    assert "mesh_cards" not in res.meta


def test_mesh4_spans_are_leaves_on_the_profilers_timeline():
    from torch.profiler import ProfilerActivity, profile
    from superman_tpu_torch.utils import trace
    a = _suite(20, 11)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = spt.permanent(a, device="cpu", **MESH4)
    ranges = sorted(
        (ev.start_ns(), ev.start_ns() + ev.duration_ns(),
         ev.name()[len(trace.SPAN):])
        for ev in prof.profiler.kineto_results.events()
        if ev.name().startswith(trace.SPAN)
        and str(ev.device_type()).endswith("CPU")
        and not ev.name().startswith(trace.SPAN + "permanent["))
    assert sorted(n for _, _, n in ranges) == sorted(
        n for n in _names(res) if not n.startswith("permanent["))
    for (s0, e0, n0), (s1, e1, n1) in zip(ranges, ranges[1:]):
        assert e0 <= s1, f"{n0} [{s0}, {e0}] overlaps {n1} [{s1}, {e1}]"


@pytest.mark.parametrize("n,seed", SUITE)
def test_mesh4_cards_count_every_block_row(n, seed):
    """meta["mesh_cards"]: one entry a mesh entry, the round-robin shares
    of the plan's block rows, no CUDA events on the CPU; one device has
    none."""
    a = _suite(n, seed)
    res = spt.permanent(a, device="cpu", **MESH4)
    cards = res.meta["mesh_cards"]
    rows = -(-res.meta["chunks"] // res.meta["lanes"])
    assert len(cards) == 4
    assert sum(c["rows"] for c in cards) == rows
    assert [c["rows"] for c in cards] == [len(range(rows)[e::4])
                                          for e in range(4)]
    assert all(c["walk_ms"] is None for c in cards)
    assert "mesh_cards" not in spt.permanent(a, device="cpu").meta


# ---- the cell's readers on canned runs

CELL = "erdos_int_dense_mesh4.n38_mesh4"
READERS = ("mesh_launch_ms", "mesh_wait_ms", "mesh_gather_ms",
           "k1_mesh_roofline", "mesh_call_mfu")


def _ctx(calls=4, spans=True, kernel_s=None, window_s=None, on_card=True):
    """A traced window of `calls` n=38 df64 calls on the cell's 4 cards;
    window_s defaults to four cards at their bound, kernel_s (the K1
    seconds summed over the cards) to the same."""
    cell = harness.load_cell(CELL)
    n = cell.traffic["order"]
    least = roofline.least_s(roofline.walk_ops(n, 1 << (n - 1)), "fp64")
    span = {"mesh_launch": 4e-4, "mesh_wait": 0.2, "mesh_gather": 3e-4,
            "permanent[multi]": 0.21} if spans else {"walk": 0.2}
    cs = [harness.Call(item=k, wall_s=0.21, perms=1, spans=dict(span),
                       calc="df64", iterations=1 << (n - 1))
          for k in range(calls)]
    dev = {} if kernel_s == 0 else {
        "ryser_walk_kernel<40, 0, 1>":
            calls * least if kernel_s is None else kernel_s}
    return harness.Context(
        cell=cell, calls=cs, n=n, batch=1, on_card=on_card,
        window_s=calls * least / cell.chips if window_s is None
        else window_s, trace=Trace(device_s=dev))


def _read(name, ctx):
    return harness.load_metric(harness.CHECKOUT, name).read(ctx)


def test_the_cell_loads_its_readers():
    cell = harness.load_cell(CELL)
    assert cell.chips == 4 and cell.traffic["flags"] == MESH4
    assert [e["name"] for e, _ in cell.per_layer] == list(READERS)
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                     "perms_per_s"}


def test_mesh_call_mfu_divides_by_the_cards():
    """Four cards at their bound: the whole call's share of their peak is
    100%, where call_mfu (one card's peak) reads 400%."""
    ctx = _ctx()
    assert _read("mesh_call_mfu", ctx) == pytest.approx(100.0)
    assert _read("call_mfu", ctx) == pytest.approx(400.0)
    assert _read("mesh_call_mfu", _ctx(window_s=1.0)) < 100.0
    assert _read("mesh_call_mfu", _ctx(on_card=False)) is None


def test_k1_mesh_roofline_over_every_cards_seconds():
    """The least time over the kernel's seconds summed over the cards: at
    most 100%, and twice the seconds read half."""
    assert _read("k1_mesh_roofline", _ctx()) == pytest.approx(100.0)
    ctx = _ctx()
    twice = _ctx(kernel_s=2 * sum(ctx.trace.device_s.values()))
    assert _read("k1_mesh_roofline", twice) == pytest.approx(50.0)
    assert _read("k1_mesh_roofline", _ctx(kernel_s=0)) is None


@pytest.mark.parametrize("name,span", [("mesh_launch_ms", 0.4),
                                       ("mesh_wait_ms", 200.0),
                                       ("mesh_gather_ms", 0.3)])
def test_mesh_span_readers(name, span):
    """ms a call of the span, and None on a run whose calls never dealt
    (the parent's spans: `walk` alone)."""
    assert _read(name, _ctx()) == pytest.approx(span)
    assert _read(name, _ctx(spans=False)) is None


def test_the_readers_of_a_run_with_nothing_to_read():
    """No call in the window: every reader is None, none raises."""
    empty = _ctx(calls=0, kernel_s=0, window_s=30.0)
    for name in READERS:
        assert _read(name, empty) is None, name


def test_a_mesh_counts_each_call_alone():
    """A Mesh handed in for several calls counts each call alone."""
    from superman_tpu_torch.core.flags import Flags
    from superman_tpu_torch.core.matrix import DenseMatrix
    from superman_tpu_torch.ops.ryser import ryser_exact
    from superman_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(devices=["cpu"] * 3)
    dm = DenseMatrix(_suite(20, 11), "int")
    cpu = torch.device("cpu")
    first = ryser_exact(dm, Flags(calc="df64"), cpu,
                        mesh=mesh).meta["mesh_cards"]
    again = ryser_exact(dm, Flags(calc="df64"), cpu,
                        mesh=mesh).meta["mesh_cards"]
    assert first == again
    assert [c["rows"] for c in again] == [43, 43, 42]
