"""Batched exact permanents: many matrices in one kernel launch.

Port of ``superman_tpu/ops/batch.py``, the system's serving entry point:
for a batch of same-order matrices the whole Ryser walk of every matrix
runs in one launch of the serving-batch kernel (csrc/ryser_batch.cu), so
B permanents cost one launch and one small device-to-host copy.  This is
how small orders use the card at all: a single n=20 matrix is 2^19 steps,
far too few to fill it, and carries milliseconds of host work.
"""

from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np
import torch

from ..core.matrix import require_finite
from ..core.result import Result
from ..utils import trace
from ..utils.debug import check_nan
from . import gray
from .oracle import gray_init_lanes
from .ryser import _row_scales
from .ryser_walk import brute_scaled, times_pow2, walk_lanes, walk_scales
from .scaled_walk import empty_line, exact_f32

#: largest order the serving batch groups
BATCH_MAX_N = 32
#: smallest order that goes to the kernel; below it the float64 walk
KERNEL_MIN_N = 13
#: tiers that stay batched
BATCHED_CALCS = ("df64", "f32", "f32k", "tf96")


def exact_storage_mask(mats: np.ndarray) -> np.ndarray:
    """(B,) bool: which matrices of a (B, n, n) float64 stack hold integers
    whose rows keep the half-integer x walk exact in float32
    (ryser._exact_storage, decided matrix by matrix)."""
    return exact_f32(mats)


def permanent_batch_same_n(mats: np.ndarray, device: torch.device,
                           max_lanes: int = 1 << 11) -> np.ndarray:
    """Exact permanents of a (B, n, n) stack by one batched float64 walk
    on `device` (the reference's vmapped XLA walk, no kernel there).
    Each matrix's rows are scaled as ryser_walk scales them (the
    reference walks them as given, batch.py:31-58), so that each value is
    finite where a double holds it, +-inf beyond and +0.0 below."""
    mats = np.asarray(mats, dtype=np.float64)
    B, n, _ = mats.shape
    if n <= 2:
        return np.array([brute_scaled(m) for m in mats])
    s = walk_scales(mats)                                 # (B, n)
    mats = np.ldexp(mats, -s[:, :, None])
    total = 1 << (n - 1)
    C = min(total >> 1, max_lanes)
    r = (total // C).bit_length() - 1
    ids = np.arange(C, dtype=np.int64)
    Xs = np.empty((B, C, n), dtype=np.float64)
    for b in range(B):
        Xs[b], sign_mid = gray_init_lanes(mats[b], ids, r, dtype=np.float64)
    X = torch.as_tensor(Xs, device=device)
    sign_mid = torch.as_tensor(sign_mid, device=device)
    colss = torch.as_tensor(np.ascontiguousarray(
        mats[:, :, : n - 1].transpose(0, 2, 1)), device=device)  # (B, n-1, n)
    acc = walk_lanes(X, sign_mid, colss, r)               # (B, C)
    sums = acc.cpu().numpy().sum(axis=1)
    return times_pow2((4 * (n & 1) - 2) * sums, s.sum(axis=1))


def pack_stack(mats: np.ndarray):
    """Host side of the batch kernel for a (B, n, n) float64 stack:
    per-matrix power-of-two row scales s (B, n) that bound every |x_j| by
    1 along the whole walk, the scaled packs x0 (B, n_pad) and cols
    (B, n-1, n_pad) as gray.pack_matrix lays one out, and the mask of
    matrices with an empty row or column (permanent 0)."""
    B, n, _ = mats.shape
    s = _row_scales(mats)
    a_s = np.ldexp(mats, -s[:, :, None])
    zero = empty_line(mats)
    n_pad = gray.pad_n(n)
    x0p = np.ones((B, n_pad), dtype=np.float64)
    x0p[:, :n] = a_s[:, :, -1] - a_s.sum(axis=2) / 2
    colsT = np.zeros((B, n - 1, n_pad), dtype=np.float64)
    colsT[:, :, :n] = a_s[:, :, : n - 1].transpose(0, 2, 1)
    return x0p, colsT, s, zero


def walk_stack(x0p: np.ndarray, colsT: np.ndarray, *, n: int, r: int,
               calc: str, device: torch.device) -> np.ndarray:
    """The serving-batch kernel over a packed stack (pack_stack's x0p and
    colsT): the (B, blocks, 2) float64 host array of every block's words,
    checked for NaN under SUPERMAN_DEBUG_NANS (utils/debug.py)."""
    from .ryser_cuda import batch_partials
    out = batch_partials(torch.as_tensor(x0p).to(device),
                         torch.as_tensor(colsT).to(device),
                         n=n, r=r, tier=calc)
    # one small copy per group
    o = out.cpu().numpy().astype(np.float64)
    check_nan(f"ryser_batch ({calc})", o)
    return o


def permanent_batch_kernel(mats: np.ndarray, calc: str = "df64", device=None,
                           chunk_log2=None):
    """(B, n, n) stack, 13 <= n <= 32 -> (permanents, meta) via the
    serving-batch kernel; the counterpart of the reference's
    ``permanent_batch_pallas``, which returns the permanents alone.

    Each matrix is cut into 2^(n-1-r) chunks (gray.batch_plan, or
    chunk_log2) walked by its own blocks of 128 threads with its own
    column table; every block reduces to one pair on the card, so the
    whole batch costs one launch and one copy of a few words per matrix.
    device=None means cuda:{device_id} and raises without CUDA; on "cpu"
    the kernel's plain version runs instead.

    Matrices whose scaled total underflows (below 2^-40) are re-run
    through the single-matrix engine, whose retry loop handles them.

    calc="tf96" takes only matrices whose storage is exact
    (exact_storage_mask) and raises on any other: its products are exact
    to ~2^-100 only on x updates that are exact.  permanent_batch sends
    the others through df64.
    """
    from ..api import permanent, resolve_device
    from ..core.flags import Flags
    from .ryser import _sm_count
    from .tf96 import sum_words

    with trace.timer("batch_group"):
        device = resolve_device(device, Flags())
        mats = np.asarray(mats, dtype=np.float64)
        B, n, _ = mats.shape
        if calc not in BATCHED_CALCS:
            raise ValueError(f"permanent_batch_kernel: unsupported calc "
                             f"{calc!r} (one of {BATCHED_CALCS})")
        if not KERNEL_MIN_N <= n <= BATCH_MAX_N:
            raise ValueError(f"permanent_batch_kernel takes orders "
                             f"{KERNEL_MIN_N}..{BATCH_MAX_N}, got {n}")
        # whether the whole stack is exact, as the reference reports it;
        # the df64 and f32 tiers walk the same way either way
        exact_storage = bool(exact_storage_mask(mats).all())
        if calc == "tf96" and not exact_storage:
            raise ValueError(
                "permanent_batch_kernel: calc='tf96' needs exact-f32 "
                "storage (integer values, row abs-sums below 2^22) in "
                "every matrix; walk the others as calc='df64'")

    with trace.timer("batch_pack"):
        x0p, colsT, s, zero = pack_stack(mats)
    r = gray.batch_plan(n, B, chunk_log2, sms=_sm_count(device))
    with trace.timer("batch_walk"):
        o = walk_stack(x0p, colsT, n=n, r=r, calc=calc, device=device)
    with trace.timer("batch_finish"):
        # a matrix's few blocks are summed as the single-matrix path sums
        # its chunks: hi + lo, then float64 (tf96: all the words as
        # double-doubles, tf96.sum_words)
        if calc == "tf96":
            tot = sum_words(o)
        else:
            tot = (o[:, :, 0] + o[:, :, 1]).sum(axis=1)
        sign = 4 * (n & 1) - 2
        E = s.sum(axis=1)
        with np.errstate(over="ignore"):
            per = np.array([float(sign * np.ldexp(t, int(e)))
                            for t, e in zip(tot, E)])
        per[zero] = 0.0
        # underflowed totals: the single-matrix engine's retry loop
        # recovers the lost terms
        redo = np.nonzero(~zero & (np.abs(tot) < 2.0 ** -40))[0]
    for i in redo:
        per[i] = permanent(mats[i], calc=calc, device=device).permanent
    meta = {"calc": calc, "batch": B, "r": r,
            "chunks": 1 << (n - 1 - r), "exact_storage": exact_storage,
            "redo": len(redo), "device": str(device)}
    return per, meta


def permanent_batch(mats: Sequence[np.ndarray], device=None,
                    **overrides) -> List[Result]:
    """Exact permanents of a sequence of square matrices.

    Same-order matrices with 2 < n <= BATCH_MAX_N are grouped into
    batched walks on `device`: orders from 13 go to the serving-batch
    kernel, smaller ones to one batched float64 walk.  A `calc` override
    ("df64"/"f32"/"f32k"/"tf96") stays batched.  Any other override (or
    an unbatchable calc such as "quad"/"auto") routes through the normal
    engine one by one, with a logged warning, never silently.
    Under calc="tf96" a matrix whose storage is not exact in f32 walks as
    df64 with a UserWarning, matrix by matrix (the reference decides for
    the whole stack and then walks such a matrix rounded to f32), and
    orders below 13 run one by one, where the long-double host route
    keeps the tier's precision.
    device=None means cuda:{device_id} and raises without CUDA; "cpu"
    runs the kernels' plain versions.

    Every matrix is checked before any walk: one that is not square, or
    that holds a NaN or infinite entry, fails the whole call with a
    ValueError naming its index (and the entry), and no result is
    computed."""
    with trace.entry("superman_tpu_torch.permanent_batch") as spans:
        results = _permanent_batch(mats, device, overrides)
    if spans:
        for res in results:
            res.meta.setdefault("spans", spans)
    return results


def _permanent_batch(mats, device, overrides: dict) -> List[Result]:
    """permanent_batch inside its trace.entry."""
    from ..api import permanent, resolve_device
    from ..core.flags import Flags

    calc = overrides.get("calc", "df64")
    batchable_calc = calc in BATCHED_CALCS
    batchable = batchable_calc and not (overrides.keys() - {"calc"})
    if not batchable:
        why = (f"calc={calc!r} has no batched tier" if not batchable_calc
               else f"overrides {sorted(overrides.keys() - {'calc'})} "
                    f"are per-matrix only")
        trace.log(f"permanent_batch: falling back to one-by-one runs "
                  f"({why}); the serving-batch speedup does not apply",
                  level=0)

    with trace.timer("batch_check"):
        mats = [np.asarray(m) for m in mats]
        for i, m in enumerate(mats):
            if m.ndim != 2 or m.shape[0] != m.shape[1]:
                raise ValueError(f"matrix {i} is not square")
            require_finite(m, f"matrix {i}")
    t0 = time.perf_counter()
    results: List[Result] = [None] * len(mats)
    with trace.timer("batch_group"):
        groups: dict = {}
        singles = []
        for i, m in enumerate(mats):
            n = m.shape[0]
            if 2 < n <= BATCH_MAX_N and batchable and (n >= KERNEL_MIN_N
                                                       or calc != "tf96"):
                tier = calc
                if calc == "tf96" and not exact_storage_mask(
                        m.astype(np.float64)[None])[0]:
                    tier = "df64"
                groups.setdefault((n, tier), []).append(i)
            else:
                # tf96 below 13 too: the small-order batch walk is plain
                # float64 and would quietly downgrade the tier
                singles.append(i)
    for i in singles:
        results[i] = permanent(mats[i], device=device, **overrides)
    if groups:
        dev = resolve_device(device, Flags())
    if any(tier != calc for _, tier in groups):
        import warnings
        warnings.warn("tf96 requires exact-f32 storage; falling back to "
                      "df64 for the matrices without it")
    for (n, tier), idxs in groups.items():
        with trace.timer("batch_group"):
            stack = np.stack([mats[i].astype(np.float64) for i in idxs])
        if n >= KERNEL_MIN_N:
            vals, meta = permanent_batch_kernel(stack, tier, dev)
            where = "cuda" if dev.type == "cuda" else "plain"
            name = f"ryser_{where}_batch_{tier}"
        else:
            # small orders: the float64 walk (>= the accuracy of the
            # f32/f32k/df64 tiers)
            vals = permanent_batch_same_n(stack, dev)
            meta = {"calc": calc, "batch": len(idxs), "device": str(dev)}
            name = "ryser_walk_batch"
        with trace.timer("batch_finish"):
            dt = time.perf_counter() - t0
            for i, v in zip(idxs, vals):
                results[i] = Result(float(v), dt, algo_name=name,
                                    iterations=1 << (n - 1),
                                    meta=dict(meta))
    return results
