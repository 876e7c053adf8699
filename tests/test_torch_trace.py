"""The port's spans (utils/trace.py): which host work each call names,
their place on torch.profiler's timeline, their scoping to the outermost
entry point, and what they cost with no profiler running.  CPU only,
small orders."""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import superman_tpu_torch as spt
from superman_tpu_torch.utils import trace

EXACT = ("exact_lift", "exact_plan", "exact_pack", "exact_walk",
         "exact_crt")


def _rng(seed):
    return np.random.default_rng([seed, 17])


def _int_matrix(rng, n, density=0.6):
    a = rng.integers(1, 5, (n, n)) * (rng.random((n, n)) < density)
    np.fill_diagonal(a, 1)
    return a


def _names(res):
    return [name for name, _ in res.meta["spans"]]


def _zero_perm_13():
    """n=13, permanent 0 by cancellation (no empty line): the batch's
    total is 0, so permanent_batch_kernel sends it to its redo call."""
    z = np.eye(13)
    z[0, :2] = [1, -1]
    z[1, :2] = [1, 1]
    return z


def _exact_call(seed=3, n=14):
    return spt.permanent(_int_matrix(_rng(seed), n), calc="exact",
                         device="cpu")


def _calls():
    """The four paths of the profiler test, each -> a Result."""
    rng = _rng(7)
    dense = rng.integers(1, 5, (20, 20))
    sparse = _int_matrix(rng, 20, density=0.18)
    stack = [rng.integers(1, 5, (13, 13)) for _ in range(8)]
    return {
        "df64 n=20": lambda: spt.permanent(dense, calc="df64",
                                           device="cpu"),
        "sparse n=20": lambda: spt.permanent(sparse, sparse=True,
                                             chunk_log2=8, device="cpu"),
        "batch 8 x n=13": lambda: spt.permanent_batch(stack,
                                                      device="cpu")[0],
        "exact n=14": _exact_call,
    }


@pytest.mark.parametrize("seed,n", [(3, 14), (4, 12)])
def test_exact_call_records_every_exact_span(seed, n):
    res = _exact_call(seed, n)
    names = _names(res)
    assert res.meta["exact"]["engine"] == "plain_mod"
    assert set(EXACT) <= set(names)
    primes = res.meta["exact"]["nprimes"] + 1        # the verifier too
    assert names.count("exact_pack") == primes
    assert names.count("exact_walk") == primes
    assert names.count("exact_lift") == 1
    assert names.count("exact_plan") == 1
    # the CRT in crt_perman_core, then the Fraction, then the Result
    assert names.count("exact_crt") == 3
    assert names[0] == "api_prepare"
    assert names[-1].startswith("permanent[")


def test_kernel_path_spans():
    calls = _calls()
    assert _names(calls["df64 n=20"]()) == [
        "api_prepare", "engine_plan", "engine_plan", "scales", "scales",
        "pack", "walk", "permanent[auto]"]
    assert _names(calls["sparse n=20"]()) == [
        "api_prepare", "engine_plan", "sparse_plan", "engine_plan",
        "scales", "scales", "pack", "walk", "permanent[auto]"]
    names = _names(calls["batch 8 x n=13"]())
    assert names[:2] == ["batch_check", "batch_group"]
    for name in ("batch_pack", "batch_walk", "batch_finish"):
        assert name in names


def _ranges(prof):
    """(name, start, end) of every span: range on the host's timeline."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if (name.startswith(trace.SPAN)
                and str(ev.device_type()).endswith("CPU")):
            s = ev.start_ns()
            out.append((name[len(trace.SPAN):], s, s + ev.duration_ns()))
    return out


@pytest.mark.parametrize("path", list(_calls()))
def test_spans_are_leaf_ranges_on_the_profilers_timeline(path):
    call = _calls()[path]
    call()                                          # warm
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = call()
    ranges = _ranges(prof)
    assert sorted(n for n, _, _ in ranges) == sorted(_names(res))
    leaves = sorted((s, e, n) for n, s, e in ranges
                    if not n.startswith("permanent["))
    for (s0, e0, n0), (s1, e1, n1) in zip(leaves, leaves[1:]):
        assert e0 <= s1, f"{n0} [{s0}, {e0}] overlaps {n1} [{s1}, {e1}]"
    outer = [(s, e) for n, s, e in ranges if n.startswith("permanent[")]
    if path != "batch 8 x n=13":
        (os_, oe), = outer
        inside = [n for s, e, n in leaves if os_ <= s and e <= oe]
        assert "api_prepare" not in inside
        assert len(inside) == len(leaves) - 1


def test_no_profiler_no_record_function(monkeypatch):
    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("record_function entered with no "
                                 "profiler running")
    import torch.autograd.profiler as ap
    monkeypatch.setattr(ap, "record_function", Refused)
    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    assert not ap._is_profiler_enabled
    for path, call in _calls().items():
        assert call().meta["spans"], path


def test_redo_call_leaves_the_batch_its_spans():
    """The redo permanent inside permanent_batch_kernel is an inner entry:
    it does not drain the batch's spans, and its own go to the batch."""
    rng = _rng(11)
    mats = [_zero_perm_13()] + [rng.integers(1, 5, (13, 13))
                                for _ in range(2)]
    rs = spt.permanent_batch(mats, device="cpu")
    assert rs[0].permanent == 0.0 and rs[0].meta["redo"] == 1
    for res in rs:
        names = _names(res)
        assert names[:2] == ["batch_check", "batch_group"]
        for name in ("batch_pack", "batch_walk", "batch_finish",
                     "api_prepare"):
            assert name in names, name
        assert sum(n.startswith("permanent[") for n in names) == 1
        # the redo runs after the batch's sums, before its Results
        i = names.index("api_prepare")
        assert names[i - 1] == "batch_finish" and \
            names[-1] == "batch_finish"


def test_one_by_one_calls_leave_the_batch_its_spans():
    """Under tf96 an order below 13 runs through permanent one by one,
    inside permanent_batch: batch_check stays with the batch, and every
    Result carries the whole call's spans."""
    rng = _rng(12)
    mats = [rng.integers(1, 5, (13, 13)), rng.integers(1, 5, (10, 10)),
            rng.integers(1, 5, (13, 13))]
    rs = spt.permanent_batch(mats, device="cpu", calc="tf96")
    assert rs[1].algo_name == "ryser_tf96_host"
    names = _names(rs[0])
    assert all(_names(r) == names for r in rs)
    assert names[0] == "batch_check" and names.count("batch_check") == 1
    assert sum(n.startswith("permanent[") for n in names) == 1
    for name in ("batch_pack", "batch_walk", "batch_finish"):
        assert name in names, name


def test_unbatchable_overrides_keep_the_batch_spans():
    rng = _rng(13)
    mats = [rng.integers(1, 5, (6, 6)) for _ in range(3)]
    rs = spt.permanent_batch(mats, device="cpu", calc="quad")
    names = _names(rs[0])
    assert all(_names(r) == names for r in rs)
    assert names[:2] == ["batch_check", "batch_group"]
    assert sum(n.startswith("permanent[") for n in names) == 3


def test_spans_of_no_call_are_dropped():
    """Spans recorded outside every entry point (a direct engine call)
    do not reach the next call's Result."""
    with trace.timer("stray"):
        pass
    res = spt.permanent(np.ones((6, 6)), device="cpu")
    assert "stray" not in _names(res)


def test_failed_call_leaves_no_spans_behind():
    with pytest.raises(ValueError):
        spt.permanent_batch([np.ones((4, 4)), np.ones((3, 4))],
                            device="cpu")
    res = spt.permanent(np.ones((6, 6)), device="cpu")
    assert "batch_check" not in _names(res)
    assert trace._depth == 0


def test_profile_dir_writes_one_file_a_call(monkeypatch, tmp_path):
    monkeypatch.setenv("SUPERMAN_PROFILE_DIR", str(tmp_path))
    spt.permanent(np.ones((6, 6)), device="cpu")
    spt.permanent(np.ones((6, 6)), device="cpu")
    spt.permanent_batch([np.ones((13, 13))] * 2, device="cpu")
    perm = sorted(tmp_path.glob("superman_tpu_torch.permanent.*.json"))
    batch = list(tmp_path.glob("superman_tpu_torch.permanent_batch.*.json"))
    assert len(perm) == 2 and len(batch) == 1
    text = batch[0].read_text()
    for name in ("span:batch_check", "span:batch_pack", "span:batch_walk"):
        assert name in text, name


# ---- the benchmark's reading of doubly marked spans

class _Ev:
    def __init__(self, name, start, dur, dev="CPU"):
        self._n, self._s, self._d, self._dev = name, start, dur, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._dev}"


def _events(double):
    """A window of two calls; with `double` each span is marked twice,
    the harness's mark around the program's own (which starts later and
    ends sooner), and the card's timeline repeats both."""
    from permbench import devtrace
    spans = [("permanent[auto]", 110, 480), ("api_prepare", 112, 20),
             ("engine_plan", 135, 10), ("scales", 146, 4),
             ("pack", 150, 50), ("walk", 200, 300),
             ("exact_walk", 720, 120)]
    evs = [_Ev(devtrace.WINDOW, 0, 1000), _Ev(devtrace.CALL, 100, 500),
           _Ev(devtrace.CALL, 700, 200),
           _Ev("void k<32>(long*)", 250, 200, "CUDA"),
           _Ev("void k<32>(long*)", 760, 60, "CUDA")]
    for name, s, d in spans:
        marks = [(s, d)] + ([(s + 1, d - 2)] if double else [])
        for ms, md in marks:
            evs.append(_Ev(devtrace.SPAN + name, ms, md))
            evs.append(_Ev(devtrace.SPAN + name, ms + 3, md, "CUDA"))
    return evs


def test_double_marks_read_as_single_marks():
    from permbench import devtrace

    def summary(double):
        prof = SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: _events(double))))
        return devtrace.summarize(prof, True)
    one, two = summary(False), summary(True)
    assert one.busy_s == two.busy_s == pytest.approx(260e-9)
    assert one.device_ops == two.device_ops
    assert one.idle_gaps == two.idle_gaps
    idle = dict(one.idle_gaps)
    for name in ("api_prepare", "engine_plan", "scales", "pack", "walk",
                 "exact_walk"):
        assert idle.get(name, 0) > 0, name


@contextlib.contextmanager
def _harness_marks():
    """permbench.harness.span_marks, as a traced run wraps the program."""
    from permbench import harness
    with harness.span_marks(torch):
        yield


def test_harness_marks_around_program_marks():
    """Under the harness's own marks every span shows twice on the
    timeline, the program's range inside the harness's."""
    from torch.profiler import ProfilerActivity, profile
    call = _calls()["exact n=14"]
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            _harness_marks():
        res = call()
    ranges = sorted(_ranges(prof), key=lambda r: (r[1], -r[2]))
    assert len(ranges) == 2 * len(_names(res))
    by_name = {}
    for name, s, e in ranges:
        by_name.setdefault(name, []).append((s, e))
    for name, iv in by_name.items():
        for (s0, e0), (s1, e1) in zip(iv[::2], iv[1::2]):
            assert s0 <= s1 and e1 <= e0, name
