"""Tracing / profiling / progress observability.

The same surface as ``superman_tpu.utils.trace``:

* `log(...)`        — leveled stderr logging, enabled with
                      SUPERMAN_VERBOSE=1 (or 2 for per-chunk noise).
* `timer(name)`     — context manager recording wall-clock spans; spans are
                      retrievable via `drain_spans()` for Result.meta.
* `profile(name)`   — context manager that wraps the block in a
                      `torch.profiler` trace when SUPERMAN_PROFILE_DIR is
                      set, and writes a Chrome trace (`<name>.json`) there.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import List, Tuple

_lock = threading.Lock()
_spans: List[Tuple[str, float]] = []


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
def profile(name: str):
    """torch.profiler trace around the block when SUPERMAN_PROFILE_DIR is
    set; otherwise a no-op.  The Chrome trace opens in chrome://tracing
    or Perfetto; CUDA activity is traced when a card is present."""
    outdir = os.environ.get("SUPERMAN_PROFILE_DIR")
    if not outdir:
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
    path = os.path.join(outdir, f"{name}.json")
    prof.export_chrome_trace(path)
    log(f"profile '{name}' written to {path}", level=1)
