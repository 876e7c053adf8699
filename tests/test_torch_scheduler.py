"""The port's hybrid scheduler: the device worker (the walk's plain
version on device="cpu") and the native CPU worker over one unit queue,
the checkpoint journal and its resume, retries and hand-offs; and the
estimators' hybrid CPU trial worker.  The cases follow
tests/test_scheduler.py, held against the port on one device and against
the JAX package.  Matrices stay at n <= 20 and the native engine at 2
threads.
"""

import json

import numpy as np
import pytest
import torch

import superman_tpu as sp
import superman_tpu_torch as spt
from superman_tpu.ops.oracle import perman64
from superman_tpu_torch.bindings.native import perman_dense_chunks
from superman_tpu_torch.ops import exact, gray
from superman_tpu_torch.parallel import scheduler, sharding
from tests.conftest import random_int_matrix

CPU = torch.device("cpu")
THREADS = 2
PLAN = {"calc": "df64", "chunk_log2": 6, "lanes": 256}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several worker processes; torch's own thread pool on
    # top of them oversubscribes the cores
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _matrix(seed, n=20):
    a = random_int_matrix(np.random.default_rng(seed), n, 0.5, vmax=2)
    np.fill_diagonal(a, 1)
    return a


def _run(a, **kw):
    return spt.permanent(a, device="cpu", threads=THREADS, **{**PLAN, **kw})


def test_hybrid_matches_single():
    """The unit queue on the device alone: the single-device value (unit
    sums regrouped: 1e-12) and the JAX package's hybrid value."""
    a = _matrix(1)
    ref = _run(a)
    hyb = _run(a, hybrid=True, cpu=False)
    assert hyb.permanent == pytest.approx(ref.permanent, rel=1e-12)
    assert hyb.algo_name.startswith("ryser_hybrid")
    h = hyb.meta["hybrid"]
    assert h["units"] >= 1 and h["cpu"] == 0 and h["device"] == h["units"]
    jhyb = sp.permanent(a, hybrid=True, cpu=False, **PLAN)
    assert hyb.permanent == pytest.approx(jhyb.permanent, rel=1e-12)


def test_hybrid_with_cpu_helper():
    """Device and native CPU units together: the workers' arithmetic
    differs (the card's double walk, the native double walk with its
    long-double sum), so the contract is reference-grade accuracy."""
    a = random_int_matrix(np.random.default_rng(2), 20, 0.4, vmax=2)
    hyb = _run(a, chunk_log2=5, lanes=128, hybrid=True, cpu=True, gpu=True)
    ref = float(perman64(a))
    assert abs(hyb.permanent - ref) <= 1e-9 * abs(ref)
    h = hyb.meta["hybrid"]
    assert h["device"] + h["cpu"] == h["units"]
    assert h["cpu"] >= 1    # the helper took units


def test_native_chunks_follow_the_kernel_convention():
    """The native range walk and the card's walk share the raw-sum
    convention: all chunks through sup_perman_dense_chunks, times the
    final sign factor, give the permanent, bitwise on a binary matrix
    (every x a half-integer, every product exact), and any chunk list
    sums to what the card's walk (its plain version) gives for it."""
    n, r = 16, 5
    a = random_int_matrix(np.random.default_rng(3), n, 0.6,
                          vmax=1).astype(np.float64)
    ids = np.arange((1 << (n - 1)) >> r, dtype=np.int64)
    raw = perman_dense_chunks(a, ids, r, threads=THREADS)
    assert (4 * (n & 1) - 2) * raw == float(perman64(a))
    plan = gray.RyserPlan(n=n, n_pad=gray.pad_n(n), r=r, lanes=64,
                          num_chunks=len(ids))
    x0, cols = gray.pack_matrix(a, plan.n_pad)
    some = ids[::7]
    blocks = sharding.pad_ids(some, 64)
    dev = sharding.compute_partials(blocks, x0, cols, plan, CPU).sum()
    assert perman_dense_chunks(a, some, r, threads=THREADS) == dev


def test_checkpoint_resume(tmp_path):
    """The journal holds one record per unit; cut to half, a second run
    resumes those and walks the rest; a fully journaled run resumes every
    unit and returns the first value bit for bit (the units' sums are
    added in block order); another matrix's journal is ignored."""
    a = _matrix(4)
    ck = str(tmp_path / "journal.jsonl")
    full = _run(a, hybrid=True, checkpoint_path=ck)
    lines = [json.loads(x) for x in open(ck)]
    assert lines[0]["key"]
    pulls = lines[1:]
    assert len(pulls) == full.meta["hybrid"]["units"]
    assert all("start" in rec and "count" in rec for rec in pulls)
    again = _run(a, hybrid=True, checkpoint_path=ck)
    assert again.meta["hybrid"]["resumed"] == len(pulls)
    assert again.permanent == full.permanent
    keep = 1 + len(pulls) // 2
    with open(ck, "w") as f:
        for rec in lines[:keep]:
            f.write(json.dumps(rec) + "\n")
    resumed = _run(a, hybrid=True, checkpoint_path=ck)
    assert resumed.permanent == pytest.approx(full.permanent, rel=1e-12)
    assert resumed.meta["hybrid"]["resumed"] == keep - 1
    other = _run(_matrix(5), hybrid=True, checkpoint_path=ck)
    assert other.meta["hybrid"]["resumed"] == 0


def test_failure_retry_then_abort(monkeypatch):
    """A transient failure is retried; a unit that keeps failing, with no
    other worker kind, aborts the run naming its blocks."""
    a = _matrix(6)
    ref = _run(a)
    real_cp = sharding.compute_partials
    calls = {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 2:       # fail one unit once
            raise RuntimeError("injected transient fault")
        return real_cp(*args, **kw)

    monkeypatch.setattr(sharding, "compute_partials", flaky)
    res = _run(a, hybrid=True)
    assert res.permanent == pytest.approx(ref.permanent, rel=1e-12)
    assert res.meta["hybrid"]["retries"] == 1

    def always_fails(*args, **kw):
        raise RuntimeError("injected permanent fault")

    monkeypatch.setattr(sharding, "compute_partials", always_fails)
    with pytest.raises(RuntimeError, match="blocks at 0 failed"):
        _run(a, hybrid=True)


def test_failed_unit_handoff_to_cpu(monkeypatch):
    """On device="cpu", a unit that keeps failing on the device worker
    goes back to the queue and the CPU worker completes it."""
    a = _matrix(7)
    ref = _run(a)
    real_cp = sharding.compute_partials
    state = {"first": None}

    def poisoned(blk, *args, **kw):
        first = int(np.asarray(blk).ravel()[0])
        if state["first"] is None:
            state["first"] = first
        if first == state["first"]:
            raise RuntimeError("injected persistent device fault")
        return real_cp(blk, *args, **kw)

    monkeypatch.setattr(sharding, "compute_partials", poisoned)
    res = _run(a, hybrid=True, cpu=True, gpu=True)
    assert res.permanent == pytest.approx(ref.permanent, rel=1e-12)
    assert res.meta["hybrid"]["handoffs"] >= 1
    assert res.meta["hybrid"]["cpu"] >= 1


def _standin_queue(monkeypatch, B=40, L=4, device_walk=None):
    """A (B, L) id layout whose walks are stand-ins: the device's sums the
    chunk ids (or runs `device_walk`), the CPU's sums them and counts its
    calls."""
    from superman_tpu_torch.bindings import native
    ids_blocks = sharding.pad_ids(np.arange(B * L), L)
    cpu_calls = []

    def sum_ids(blk, *args, **kw):
        return np.where(blk >= 0, blk, 0).astype(np.float64)

    def cpu_walk(a_s, ids, r, threads):
        cpu_calls.append(len(ids))
        return float(ids.sum())

    monkeypatch.setattr(sharding, "compute_partials", device_walk or sum_ids)
    monkeypatch.setattr(native, "perman_dense_chunks", cpu_walk)
    monkeypatch.setattr(native, "native_available", lambda: True)
    plan = gray.RyserPlan(n=20, n_pad=24, r=4, lanes=L, num_chunks=B * L)
    return ids_blocks, plan, cpu_calls


@pytest.mark.parametrize("mesh", [None, ["cpu", "cuda:0"]])
def test_failed_device_unit_on_a_card_raises(monkeypatch, mesh):
    """Where the device, or any mesh entry, is a card, a device unit that
    exhausts its retries fails the run: it is not handed to the CPU
    worker, which takes no unit of it."""
    def always_fails(*args, **kw):
        raise RuntimeError("injected kernel launch fault")

    ids_blocks, plan, cpu_calls = _standin_queue(monkeypatch,
                                                 device_walk=always_fails)
    if mesh is None:
        device, m = torch.device("cuda", 0), None
    else:
        # a Mesh makes a stream for each card entry; a list stands in
        device, m = CPU, [torch.device(d) for d in mesh]
    with pytest.raises(RuntimeError, match="no hand-off to the CPU"):
        scheduler.compute_partials_hybrid(
            np.ones((20, 20)), ids_blocks, None, None, plan, device,
            mesh=m, threads=1, unit_blocks=4)
    assert cpu_calls == []


def test_cpu_worker_skips_units_it_would_finish_last(monkeypatch):
    """The CPU worker takes no unit whose predicted time outlasts the
    device worker's remaining walk (a native engine priced far below the
    device here), and takes units where the device is the slower one."""
    import time as _time

    def slow_device(blk, *args, **kw):
        _time.sleep(0.002)
        return np.where(blk >= 0, blk, 0).astype(np.float64)

    ids_blocks, plan, cpu_calls = _standin_queue(monkeypatch,
                                                 device_walk=slow_device)
    want = float(np.arange(ids_blocks.size).sum())
    monkeypatch.setattr(scheduler, "NATIVE_ROW_STEPS_S", 1.0)
    total, stats = scheduler.compute_partials_hybrid(
        np.ones((20, 20)), ids_blocks, None, None, plan, CPU, threads=1,
        unit_blocks=1)
    assert total == want
    assert stats.units_cpu == 0 and cpu_calls == []
    assert stats.units_device == stats.units_total == len(ids_blocks)
    monkeypatch.setattr(scheduler, "NATIVE_ROW_STEPS_S", 1e12)
    total, stats = scheduler.compute_partials_hybrid(
        np.ones((20, 20)), ids_blocks, None, None, plan, CPU, threads=1,
        unit_blocks=1)
    assert total == want
    assert stats.units_cpu >= 1 and len(cpu_calls) == stats.units_cpu


def test_hybrid_mesh_checkpoint_combo(tmp_path):
    """Everything at once: a mesh of 4 "cpu" entries, the unit queue, the
    journal, the sparse engine's pruned plan (without factored rows under
    the scheduler); then its resume."""
    lrng = np.random.default_rng(2024)
    a = random_int_matrix(lrng, 20, 0.35, vmax=2)
    np.fill_diagonal(a, lrng.integers(1, 3, 20))
    ck = str(tmp_path / "combo.jsonl")
    kw = dict(chunk_log2=6, lanes=128)
    ref = _run(a, **kw)
    got = _run(a, sparse=True, preprocessing=2, hybrid=True,
               mesh_shape=(4,), checkpoint_path=ck, **kw)
    assert got.permanent == pytest.approx(ref.permanent, rel=1e-10)
    assert got.meta["hybrid"]["units"] >= 1 and got.meta["mesh"] == 4
    again = _run(a, sparse=True, preprocessing=2, hybrid=True,
                 mesh_shape=(4,), checkpoint_path=ck, **kw)
    assert again.meta["hybrid"]["resumed"] >= 1
    assert again.permanent == pytest.approx(got.permanent, rel=1e-12)
    want = sp.permanent(a, sparse=True, preprocessing=2, hybrid=True,
                        mesh_shape=(4,), calc="df64", **kw)
    assert got.permanent == pytest.approx(want.permanent, rel=1e-10)


def test_journal_key_pins_layout(tmp_path):
    """A journal written under one layout is never replayed under another:
    other lanes, another mesh size, other pruned ids (the key holds them
    all)."""
    a = _matrix(8)
    ck = str(tmp_path / "layout.jsonl")
    first = _run(a, hybrid=True, checkpoint_path=ck)
    for kw in ({"lanes": 128}, {"mesh_shape": (2,)}):
        other = _run(a, hybrid=True, checkpoint_path=ck, **kw)
        assert other.meta["hybrid"]["resumed"] == 0, kw
        assert other.permanent == pytest.approx(first.permanent, rel=1e-12)
    a_s = np.ones((4, 4))
    ids = sharding.pad_ids(np.arange(10), 4)
    key = scheduler._journal_key(a_s, 2, ids, 1)
    assert key != scheduler._journal_key(a_s, 2, ids[:, ::-1].copy(), 1)
    assert key != scheduler._journal_key(a_s, 2, ids, 2)
    assert key != scheduler._journal_key(a_s, 2, ids, 1, "f32")


@pytest.mark.parametrize("algo", ["rasmussen", "scaling"])
def test_estimator_hybrid_runs_exactly_n_trials(algo):
    """The estimators' hybrid CPU worker takes 50,000-trial chunks from the
    one budget the device loop takes its batches from: exactly
    number_of_times trials run, and the estimate lies within 4 stderr of
    the exact permanent."""
    rng = np.random.default_rng(30)
    a = (rng.random((16, 16)) < 0.5).astype(np.float64)
    np.fill_diagonal(a, 1.0)
    want = float(exact.perman_exact_fraction(a, CPU)[0])
    N = 120_000
    res = spt.permanent(a, device="cpu", approximation=True,
                        perman_algo=algo, number_of_times=N, hybrid=True,
                        cpu=True, threads=THREADS, scale_intervals=4)
    assert res.algo_name == f"approx_{algo}_hybrid"
    assert res.meta["trials"] == res.iterations == N
    assert 1 <= res.meta["cpu_trials"] < N
    # the stderr is the device trials' (the CPU chunks report means only)
    assert abs(res.permanent - want) <= 4 * res.meta["stderr"]


def test_estimator_hybrid_device_failure_stops_the_cpu_worker(monkeypatch):
    """A device batch that raises fails the estimator: the error reaches
    the caller, and the CPU trial worker has stopped (it does not finish
    the budget on the host)."""
    import threading

    from superman_tpu_torch.ops import approx

    def broken(*args, **kw):
        raise RuntimeError("injected device batch fault")

    monkeypatch.setattr(approx, "_run_batch", broken)
    a = np.ones((12, 12))
    with pytest.raises(RuntimeError, match="injected device batch fault"):
        spt.permanent(a, device="cpu", approximation=True,
                      perman_algo="rasmussen", number_of_times=10_000_000,
                      hybrid=True, cpu=True, threads=THREADS)
    assert not any(t.name == "approx-cpu" and t.is_alive()
                   for t in threading.enumerate())


def test_unit_queue_covers_every_block_once_under_contention(monkeypatch):
    """Stress of the shared queue: both workers pull one-block units with
    the interpreter switching threads every microsecond; every block is
    walked exactly once and the total is the sum over all of them (a lost
    or doubled claim would change it).  The walks are stand-ins that sum
    the chunk ids."""
    import sys
    import threading

    from superman_tpu_torch.bindings import native
    B, L = 400, 4
    ids_blocks = sharding.pad_ids(np.arange(B * L - 3), L)
    seen, lock = [], threading.Lock()

    def device_walk(blk, *args, **kw):
        with lock:
            seen.extend(int(b) for b in blk[:, 0])
        return np.where(blk >= 0, blk, 0).astype(np.float64)

    def cpu_walk(a_s, ids, r, threads):
        with lock:
            seen.extend(int(i) for i in ids[::L])
        return float(ids.sum())

    monkeypatch.setattr(sharding, "compute_partials", device_walk)
    monkeypatch.setattr(native, "perman_dense_chunks", cpu_walk)
    plan = gray.RyserPlan(n=20, n_pad=24, r=4, lanes=L, num_chunks=B * L)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        total, stats = scheduler.compute_partials_hybrid(
            np.ones((20, 20)), ids_blocks, None, None, plan, CPU,
            threads=1, unit_blocks=1)
    finally:
        sys.setswitchinterval(old)
    assert sorted(seen) == list(range(0, B * L, L))
    assert total == float(np.arange(B * L - 3).sum())
    assert stats.units_total == B == stats.units_device + stats.units_cpu
    assert stats.units_cpu >= 1 and stats.units_device >= 1
