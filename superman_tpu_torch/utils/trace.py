"""Tracing / profiling / progress observability.

The same surface as ``superman_tpu.utils.trace``, and `entry`:

* `log(...)`        — leveled stderr logging, enabled with
                      SUPERMAN_VERBOSE=1 (or 2 for per-chunk noise).
* `timer(name)`     — context manager recording a wall-clock span;
                      spans are retrievable via `drain_spans()` for
                      Result.meta["spans"], a list of (name, seconds).
                      While a torch profiler runs, the span is also a
                      `record_function` range named SPAN + name
                      ("span:walk"), on the profiler's timeline beside
                      the kernels; with none running it costs one flag
                      read more.
* `entry(name)`     — the scope of one call of an entry point
                      (`api.permanent`, `ops.batch.permanent_batch`):
                      the outermost one collects the spans of its call,
                      one called inside it leaves them to it.
* `profile(name)`   — context manager that wraps the block in a
                      `torch.profiler` trace when SUPERMAN_PROFILE_DIR is
                      set, and writes a Chrome trace (`<name>.<k>.json`,
                      k counting the traces of this process) there.

The spans, each a leaf (none holds another) but the outer
``permanent[<algo>]`` of `api.permanent`:

* `api_prepare` (api.py): the flags, the device and the input's checks;
* `engine_plan`, `sparse_plan`, `scales`, `pack`, `walk`
  (ops/ryser.py; `pack` and `walk` in ops/glynn.py too): the checks and
  the plan, the sparse planner, the row scales, the pack, the walk;
* `lane_init`, `lane_walk` (ops/ryser_walk.ryser_walk), where ryser_exact
  takes the lane walk (below n=19, and calc="f64"): the row scales, the
  lanes' set-up and their copies to the device; the walk's steps, the
  lane sums back, their host sum and the scale multiplied back;
* `mesh_launch`, `mesh_wait`, `mesh_gather` (parallel/sharding.py), in
  place of `walk` where one process deals the walk over several mesh
  entries itself (no hybrid scheduler): the entries' launches queued,
  the host's wait for them, their words back in the rows' order;
* `exact_lift`, `exact_plan`, `exact_pack`, `exact_walk`, `exact_crt`
  (ops/exact.py, ops/modp.py): the dyadic lift and folds, the primes and
  the pruned plan, each prime's residue pack and walk, the CRT and the
  value;
* `batch_check`, `batch_group`, `batch_pack`, `batch_walk`,
  `batch_finish` (ops/batch.py): the input's checks, the grouping and
  stacking, the pack, the walk, the sums and the Results.

A span that runs more than once in a call (a prime, an attempt) is
recorded each time under its one name.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time
from typing import List, Tuple

import torch.autograd.profiler as _profiler

#: the prefix of a span's range on the profiler's timeline
SPAN = "span:"

_lock = threading.Lock()
_spans: List[Tuple[str, float]] = []
#: entry points open, outermost first (entry)
_depth = 0
#: the index of this process's next profile file
_profiles = itertools.count()


def verbosity() -> int:
    try:
        return int(os.environ.get("SUPERMAN_VERBOSE", "0"))
    except ValueError:
        return 0       # malformed value -> the documented default (quiet)


def log(msg: str, level: int = 1) -> None:
    if verbosity() >= level:
        with _lock:
            print(f"[superman_tpu_torch +{time.monotonic():.3f}] {msg}",
                  file=sys.stderr, flush=True)


@contextlib.contextmanager
def timer(name: str, level: int = 2):
    mark = (_profiler.record_function(SPAN + name)
            if _profiler._is_profiler_enabled else contextlib.nullcontext())
    with mark:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with _lock:
                _spans.append((name, dt))
            log(f"{name}: {dt:.4f}s", level=level)


def drain_spans() -> List[Tuple[str, float]]:
    """Return and clear the recorded (name, seconds) spans."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return out


@contextlib.contextmanager
def entry(name: str):
    """One call of an entry point.  Yields a list that the outermost
    entry fills, as it ends, with the spans recorded since it began; an
    entry inside another (the batch's one-by-one and redo calls of
    `permanent`) leaves its spans to the outer one and yields [].  The
    outermost entry runs under `profile(name)`."""
    global _depth
    with _lock:
        outer = _depth == 0
        _depth += 1
    if outer:
        drain_spans()              # spans of no call's, recorded before
    spans: List[Tuple[str, float]] = []
    try:
        with profile(name) if outer else contextlib.nullcontext():
            yield spans
    finally:
        with _lock:
            _depth -= 1
        if outer:
            spans.extend(drain_spans())


@contextlib.contextmanager
def profile(name: str):
    """torch.profiler trace around the block when SUPERMAN_PROFILE_DIR is
    set and no profiler runs already; otherwise a no-op.  The Chrome
    trace opens in chrome://tracing or Perfetto; CUDA activity is traced
    when a card is present, and the spans (timer) show as "span:<name>"
    ranges."""
    outdir = os.environ.get("SUPERMAN_PROFILE_DIR")
    if not outdir or _profiler._is_profiler_enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(name):
            yield
    path = os.path.join(outdir, f"{name}.{next(_profiles)}.json")
    prof.export_chrome_trace(path)
    log(f"profile '{name}' written to {path}", level=1)
