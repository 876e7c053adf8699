"""Hybrid dynamic chunk scheduler: card and native-CPU workers over one
queue.

Port of ``superman_tpu/parallel/scheduler.py``.  Parity: the reference's
dynamic chunked multi-GPU+CPU load balancer
(`gpu_perman64_*_multigpucpu_chunks`, gpu_exact_dense.cu:776-896): the
Gray-code range is over-decomposed into work units that the workers pull
from a shared counter.  Here:

* one Python thread drives the card's walk (sharding.compute_partials,
  over the mesh where there is one), an optional second drives the native
  C++ OpenMP engine (native/perman_cpu.cpp: sup_perman_dense_chunks); both
  pull units from a lock-protected counter.  The ctypes call releases the
  GIL and so does the device worker's wait for its card (the copy of the
  partials back), so the workers overlap;
* the CPU worker pulls finer units (an eighth of the device's), so a slow
  CPU unit near the end cannot hold up the finish;
* each finished unit is journaled to an optional checkpoint file (fsync
  after every record), and a killed run resumes by replaying the journal
  and skipping the units it holds.  The journal's key pins the layout
  (matrix, r, lanes, block count, mesh size, the ids themselves, tier), so
  a journal written under another layout is ignored, never replayed;
* a unit that raises is retried up to 3 times; a unit that exhausts its
  retries on one worker kind goes back to the queue for the OTHER kind,
  and the run fails only once every participating kind rejected it.
  Where the device (or a mesh entry) is a card, a device unit never goes
  to the CPU: one that exhausts its retries fails the run, so a kernel
  that does not build or launch cannot be finished on the host in its
  place;
* the CPU worker takes a unit only while it would finish before the
  device worker runs out of blocks: it waits for the device's second
  unit and then compares its unit's predicted time with the device's remaining
  time, both from the latest unit of each kind (the CPU's first from the
  native engine's rate, NATIVE_ROW_STEPS_S).  The reference's CPU worker
  always takes units; on one H100 (K1 df64 ~700x the native engine) its
  unit of n=32 outlasts the card's whole walk, so it could only slow the
  run.

Exactness: unit partials are raw Gray-term sums over the row-scaled
matrix; for integer matrices every partial is exact, so the float64 total
does not depend on which worker computed what.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import gray
from ..utils import trace

#: the native dense walk's rate per thread, in row updates (steps x n) a
#: second: chip_smoke.py phase 5a measured 0.30-0.37 G steps/s at n=32 on
#: 8 threads of the H100 machine's host (NVIDIA H100 80GB HBM3, 700 W), the
#: lower end taken; it prices the CPU worker's first unit only
NATIVE_ROW_STEPS_S = 1.2e9


@dataclass
class HybridStats:
    units_total: int = 0
    units_device: int = 0
    units_cpu: int = 0
    units_resumed: int = 0
    retries: int = 0
    handoffs: int = 0   # units that exhausted retries on one worker kind
    #                     and completed on the other


def _journal_key(a_s: np.ndarray, r: int, ids_blocks: np.ndarray,
                 num_shards: int, tier: str = "df64") -> str:
    """Checkpoint identity.  The journal records (start, count) BLOCK
    ranges whose meaning depends on the whole ids_blocks layout (lanes,
    the pruned chunk list, the mesh), so the key pins all of it, and the
    tier whose sums it holds: a resume under another layout would replay
    partial sums against other blocks and return a wrong permanent."""
    h = hashlib.sha256(np.ascontiguousarray(a_s).tobytes()).hexdigest()[:16]
    hb = hashlib.sha256(
        np.ascontiguousarray(ids_blocks, dtype=np.int64).tobytes()
    ).hexdigest()[:16]
    B, lanes = ids_blocks.shape
    return f"{a_s.shape[0]}:{r}:{lanes}:{B}:{num_shards}:{tier}:{h}:{hb}"


class _Journal:
    """Append-only checkpoint of (block range -> raw partial sum)."""

    def __init__(self, path: Optional[str], key: str):
        self.path = path
        self.key = key
        self.done: dict = {}
        self._f = None
        if not path:
            return
        if os.path.exists(path):
            try:
                with open(path) as f:
                    head = json.loads(f.readline())
                    if head.get("key") == key:
                        for line in f:
                            rec = json.loads(line)
                            self.done[(int(rec["start"]),
                                       int(rec["count"]))] = \
                                float(rec["value"])
                    else:
                        trace.log(f"checkpoint {path}: key mismatch, "
                                  "starting fresh", level=1)
            except (ValueError, OSError, KeyError) as e:
                trace.log(f"checkpoint {path}: unreadable ({e}), "
                          "starting fresh", level=1)
                self.done = {}
        mode = "a" if self.done else "w"
        self._f = open(path, mode)
        if mode == "w":
            self._f.write(json.dumps({"key": key}) + "\n")
            self._f.flush()

    def record(self, start: int, count: int, value: float, by: str,
               dt: float) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps({"start": start, "count": count,
                                  "value": value, "by": by,
                                  "t": round(dt, 4)}) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def compute_partials_hybrid(
        a_s: np.ndarray, ids_blocks: np.ndarray, x0: np.ndarray,
        cols: np.ndarray, plan: gray.RyserPlan, device: torch.device, *,
        tier: str = "df64", mesh=None, threads: int = 16,
        cpu_helper: bool = True, checkpoint_path: Optional[str] = None,
        unit_blocks: Optional[int] = None):
    """Dynamic-chunked partial-sum computation over the (B, L) chunk ids.

    a_s is the row-scaled matrix that (x0, cols) pack (the CPU worker
    walks it); tier is one of "df64", "f32", "f32k" (the journal holds
    float64 unit sums).  Returns (total, HybridStats): `total` is the raw
    sum of Gray terms (no (4*(n&1)-2) factor, no 2**E unscaling), the
    convention of sharding.compute_total, with the units' sums (the
    journal's and this run's) added in block order.
    """
    from . import sharding

    B = ids_blocks.shape[0]
    num_shards = 1 if mesh is None else len(mesh)
    if unit_blocks is None:
        # over-decompose: ~8 units per worker, at least a row per entry
        workers = 2 if cpu_helper else 1
        unit_blocks = max(num_shards, B // max(1, 8 * workers))
    unit_blocks = max(1, int(unit_blocks))
    cpu_blocks = max(1, unit_blocks // 8)

    journal = _Journal(checkpoint_path,
                       _journal_key(a_s, plan.r, ids_blocks, num_shards,
                                    tier))
    covered = np.zeros(B, dtype=bool)
    results: dict = {}
    for (start, count), value in journal.done.items():
        covered[start:start + count] = True
        results[start] = value
    stats = HybridStats(units_resumed=len(journal.done),
                        units_total=len(journal.done))

    # one lock for the queue; its condition wakes a waiting worker when a
    # unit ends, a unit is released, or a worker exits
    lock = threading.Condition()
    pos = [0]
    failures: list = []
    aborted: list = []          # (start, err) of a device unit on a card
    entries = [torch.device(device)] if mesh is None else list(mesh)
    on_card = any(d.type == "cuda" for d in entries)
    # seconds a block by kind, from the latest unit of that kind
    cpu_threads = min(threads if threads > 0 else os.cpu_count() or 1,
                      os.cpu_count() or 1)
    sec_block = {"device": None,
                 "cpu": plan.lanes * float(1 << plan.r) * plan.n
                 / (NATIVE_ROW_STEPS_S * cpu_threads)}
    # blocks a worker KIND has exhausted its retries on; the unit returns
    # to the queue for the OTHER kind, and the run fails only if every
    # participating kind rejected it
    banned = {"device": np.zeros(B, dtype=bool),
              "cpu": np.zeros(B, dtype=bool)}
    alive = {"device": False, "cpu": False}

    def pull(k: int, kind: str):
        """Next run of up to k uncovered contiguous blocks this worker
        kind may take, or None."""
        ban = banned[kind]
        with lock:
            # pos[0]: a lower bound on the first uncovered block
            p = pos[0]
            while p < B and covered[p]:
                p += 1
            pos[0] = p
            while p < B and (covered[p] or ban[p]):
                p += 1
            if p >= B:
                return None
            start = p
            while p < B and not covered[p] and not ban[p] \
                    and p - start < k:
                p += 1
            covered[start:p] = True        # claimed
            return start, p

    def release(start: int, end: int, kind: str, err: BaseException):
        """Retries exhausted on `kind`: back to the queue, banned for this
        kind only."""
        with lock:
            covered[start:end] = False
            banned[kind][start:end] = True
            failures.append((start, kind, err))
            pos[0] = min(pos[0], start)
            lock.notify_all()

    def cpu_may_take(k: int) -> bool:
        """Whether a CPU unit of k blocks would end before the device
        worker runs out of blocks it may take.  Call under the lock."""
        if not alive["device"]:
            return True
        uncov = ~covered
        if (uncov & banned["device"]).any():
            return True                # blocks only the CPU may take
        if stats.units_device < 2:
            # wait for the device's second unit: the first also pays the
            # run's start (threads, journal, the pack's upload)
            return False
        left = int(np.count_nonzero(uncov))
        return k * sec_block["cpu"] < left * sec_block["device"]

    def run_device_unit(start: int, end: int) -> float:
        out = sharding.compute_partials(ids_blocks[start:end], x0, cols,
                                        plan, device, tier, mesh)
        return float(out.sum(dtype=np.float64))

    def run_cpu_unit(start: int, end: int) -> float:
        from ..bindings.native import perman_dense_chunks
        ids = ids_blocks[start:end].ravel()
        ids = ids[ids >= 0].astype(np.int64)
        if len(ids) == 0:
            return 0.0
        return perman_dense_chunks(a_s, ids, plan.r, threads)

    def worker(kind: str, fn, k: int):
        # alive[kind] was set before the thread started (setting it here
        # would race the other worker's liveness check)
        other = "cpu" if kind == "device" else "device"
        try:
            _worker_loop(kind, other, fn, k)
        finally:
            with lock:
                alive[kind] = False
                lock.notify_all()

    def _worker_loop(kind: str, other: str, fn, k: int):
        while True:
            with lock:
                if aborted:
                    return
                if kind == "cpu" and not cpu_may_take(k):
                    if not (~covered).any():
                        return
                    lock.wait(0.05)
                    continue
            item = pull(k, kind)
            if item is None:
                with lock:
                    uncov = ~covered
                    if not uncov.any() or not alive[other]:
                        return
                    # blocks banned for BOTH kinds never complete; the
                    # final check reports them
                    if np.all(banned["device"][uncov]
                              & banned["cpu"][uncov]):
                        return
                    # the other worker may still hand units back to this
                    # kind
                    lock.wait(0.05)
                continue
            start, end = item
            t0 = time.perf_counter()
            value = None
            err = None
            for attempt in range(3):
                try:
                    value = fn(start, end)
                    break
                except Exception as e:          # noqa: BLE001 -- retried
                    with lock:
                        stats.retries += 1
                    trace.log(f"blocks [{start},{end}) failed on {kind} "
                              f"(attempt {attempt + 1}): {e}", level=1)
                    err = e
            if value is None:
                if kind == "device" and on_card:
                    with lock:
                        aborted.append((start, err))
                        lock.notify_all()
                    return
                trace.log(f"blocks [{start},{end}) exhausted retries on "
                          f"{kind}; returned to queue for {other}", level=1)
                release(start, end, kind, err)
                continue
            dt = time.perf_counter() - t0
            with lock:
                sec_block[kind] = dt / (end - start)
                results[start] = value
                stats.units_total += 1
                if kind == "device":
                    stats.units_device += 1
                else:
                    stats.units_cpu += 1
                if banned[other][start:end].any():
                    stats.handoffs += 1
                journal.record(start, end - start, value, kind, dt)
                lock.notify_all()
            trace.log(f"blocks [{start},{end}) DONE by {kind} "
                      f"in {dt:.4f}s", level=2)

    workers = [("device", run_device_unit, unit_blocks)]
    if cpu_helper:
        from ..bindings.native import native_available
        if native_available():
            workers.append(("cpu", run_cpu_unit, cpu_blocks))
        else:
            trace.log("hybrid: native CPU engine unavailable, running on "
                      "the device alone", level=1)
    threads_list = [threading.Thread(target=worker, args=w,
                                     name=f"hybrid-{w[0]}") for w in workers]
    for kind, _, _ in workers:
        alive[kind] = True
    for t in threads_list:
        t.start()
    for t in threads_list:
        t.join()
    journal.close()

    if aborted:
        start, err = aborted[0]
        raise RuntimeError(
            f"hybrid scheduler: blocks at {start} failed on the device "
            f"worker after retries ({device}; no hand-off to the CPU from "
            f"a card): {err}") from err
    if not covered.all():
        # blocks rejected by every participating worker kind
        if failures:
            start, kind, err = failures[0]
            raise RuntimeError(
                f"hybrid scheduler: blocks at {start} failed on {kind} "
                f"worker after retries: {err}") from err
        raise RuntimeError("hybrid scheduler: blocks never completed")
    total = float(np.sum(np.fromiter(
        (results[s] for s in sorted(results)), dtype=np.float64)))
    return total, stats
