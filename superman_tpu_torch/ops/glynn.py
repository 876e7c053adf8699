"""Glynn-formula exact permanent, an independent second exact engine.

Port of ``superman_tpu/ops/glynn.py``.

per(A) = 2^(1-n) * sum over delta in {+-1}^n with delta_n = +1 of
         (prod_i delta_i) * prod_j (sum_i delta_i * a_ij).

Cross-ALGORITHM agreement is the primary correctness oracle, and the
Ryser / Nijenhuis-Wilf formula otherwise provides every result of the
card.  The Gray walk over delta maps exactly onto the Ryser walk kernel
(csrc/ryser_walk.cu) with another packing:

* state x_j = sum_i delta_i a_ij; initially (all delta = +1) the column
  sums of A;
* flipping delta_k toggles -2 * a[k, :] in and out of x, so the kernel's
  column table holds  row k = -2 * (row k of A)  for k < n-1;
* the term sign (prod delta) = (-1)^popcount(gray(m)) = (-1)^m, the
  parity the kernel already applies;
* the final factor 2^(1-n) replaces Ryser's (4*(n&1)-2).

Column scaling by powers of two is exact and keeps every |x_j| <~ 1, as
row scaling does on the Ryser path.  The engine runs every tier of the
kernel (df64, f32, f32k, tf96).  Of the Ryser engine's host code it
shares only the rules of a scaled walk (ops/scaled_walk.py: the line
exponents, the exact-storage and empty-line tests, the underflow retry);
its formula and its pack are its own: that is its value.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..core.matrix import DenseMatrix
from ..core.result import Result
from ..utils import trace
from . import gray
from .scaled_walk import (empty_line, exact_f32, line_exponents,
                          retry_scaled)


def _col_scales(a: np.ndarray) -> np.ndarray:
    """Integer exponents s_j bounding |x_j| <= ~1 along the whole walk:
    |x_j| <= sum_i |a_ij| always."""
    ab = np.abs(np.asarray(a, dtype=np.float64))
    return line_exponents(ab.sum(axis=0))


def _pack_glynn(a_s: np.ndarray, n_pad: int):
    """x0 = column sums (padding 1); walk table row k = -2 * row k of the
    matrix, k < n-1 (padding 0): (x0 (n_pad,), cols (n-1, n_pad)),
    float64, the layout gray.pack_matrix gives the Ryser walk."""
    n = a_s.shape[0]
    x0 = np.ones(n_pad, dtype=np.float64)
    x0[:n] = a_s.sum(axis=0)
    g = np.zeros((n - 1, n_pad), dtype=np.float64)
    g[:, :n] = -2.0 * a_s[: n - 1, :]
    return x0, g


def glynn_scaled(a: np.ndarray, walk) -> float:
    """Glynn's host and lane routes: walk(a') is the permanent of a', the
    matrix with column j scaled by 2^-s_j (ryser_walk.walk_scales over
    columns), times 2^E, E the sum of the s_j, applied in the type walk
    returns (a long-double walk's total is rounded to a double once).  A
    long-double matrix is scaled in long double.  The reference walks the
    matrix as given (glynn.py:73-80), and returns NaN where a product
    overflows; here a permanent that a double holds comes back finite, one
    beyond its range as +-inf, one below it as +0.0."""
    from .ryser_walk import times_pow2, walk_scales
    a = np.asarray(a)
    if a.dtype != np.longdouble:
        a = a.astype(np.float64)
    s = walk_scales(a, axis=-2)
    return float(times_pow2(walk(np.ldexp(a, -s[None, :])), int(s.sum())))


def glynn_lanes(a: np.ndarray, device: torch.device) -> float:
    """oracle.perman_glynn's walk in float64 as plain PyTorch on
    `device`: ryser_walk.walk_lanes over Glynn's lanes
    (oracle.glynn_init_lanes) and flip table, up to ryser_walk.MAX_LANES
    lanes, the lane sums added in float64 on the host."""
    from .oracle import glynn_init_lanes, perman_glynn
    from .ryser_walk import MAX_LANES, walk_lanes
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    if n <= 1:
        return perman_glynn(a)
    total = 1 << (n - 1)
    C = min(total >> 1, MAX_LANES)
    r = (total // C).bit_length() - 1
    X, sign_mid, flips = glynn_init_lanes(a, np.arange(C, dtype=np.int64),
                                          r)
    acc = walk_lanes(*(torch.as_tensor(v, device=device)
                       for v in (X, sign_mid, flips)), r)
    return float(np.sum(acc.cpu().numpy()) * 2.0 ** (1 - n))


def glynn_exact(dense: DenseMatrix, flags, device: torch.device,
                mesh=None) -> Result:
    """Exact permanent of `dense` on `device` by the Glynn formula, calc
    "df64", "f32", "f32k", "tf96" or "f64"; calc "quad" walks on the host
    in long double whatever the device (single-threaded, practical up to
    n ~ 24).  mesh: deal the walk's blocks over a parallel.mesh.Mesh
    (bitwise the single-device result), or None."""
    a = np.asarray(dense.mat)
    n = a.shape[0]
    calc = flags.resolved_calc()
    if calc not in ("df64", "f32", "f32k", "tf96", "f64", "quad"):
        raise ValueError(f"glynn_exact has no {calc!r} tier")
    t0 = time.perf_counter()
    if n <= 2 or calc in ("quad", "f64") or n < 19:
        from .oracle import perman_glynn
        meta = {"calc": calc}
        if calc in ("quad", "tf96"):
            # quad (and small-n tf96) keep long-double precision on the
            # host walk, the same contract as ryser_exact's host route
            name = "glynn_host"
            walk = functools.partial(perman_glynn, dtype=np.longdouble)
        elif device.type == "cpu":
            name, walk = "glynn_host", perman_glynn
        else:
            # the float64 lane walk on the card, as ryser_walk walks Ryser
            name = f"glynn_walk_{calc}"
            walk = functools.partial(glynn_lanes, device=device)
            meta["device"] = str(device)
        return Result(glynn_scaled(a, walk), time.perf_counter() - t0,
                      algo_name=name, iterations=1 << max(n - 1, 0),
                      meta=meta)

    where = "cuda" if device.type == "cuda" else "plain"
    # trivial zero: an empty row or column zeroes every Glynn term, and
    # the scale-retry heuristic would rerun 3 full walks on pure zeros
    if empty_line(a):
        return Result(0.0, time.perf_counter() - t0,
                      algo_name=f"glynn_{where}_{calc}", iterations=0,
                      meta={"reason": "empty row/col"})

    # x_j = sum_i delta_i a_ij * 2^-s_j: all terms of x_j share the column
    # scale, so the walk is exact in f32 iff the values are integers and
    # the column abs-sums fit in 24-bit mantissas (the mirror of
    # ryser._exact_storage's row test, decided on the values likewise)
    a64 = a.astype(np.float64)
    exact_storage = bool(exact_f32(a64, -2,
                                   declared_int=dense.type == "int"))
    if calc == "tf96" and not exact_storage:
        import warnings
        warnings.warn("tf96 requires exact-f32 storage; falling back to "
                      "df64")
        calc = "df64"

    from ..parallel.sharding import (compute_total, mesh_cards,
                                     total_words, walk_span)
    from .ryser import _sm_count
    plan = gray.make_plan(n, flags.lanes, flags.chunk_log2,
                          sms=_sm_count(device),
                          grid_multip=int(flags.grid_multip))
    cards = mesh_cards(mesh)

    def walk(a_s):
        with trace.timer("pack"):
            x0, cols = _pack_glynn(a_s, plan.n_pad)
        with walk_span(cards):
            return compute_total(x0, cols, plan, device, tier=calc,
                                 mesh=mesh, cards=cards)

    total, E = retry_scaled(a64, _col_scales(a), -2, walk)
    with np.errstate(over="ignore"):
        acc = np.longdouble(total) if calc == "tf96" else np.float64(total)
        p = float(np.ldexp(acc, E + 1 - n)) + 0.0
    dt = time.perf_counter() - t0
    iters = plan.num_chunks << plan.r
    meta = {"calc": calc, "chunks": plan.num_chunks, "r": plan.r,
            "lanes": plan.lanes, "scale_log2": E,
            "iters_per_sec": iters / dt, "device": str(device),
            "exact_storage": exact_storage,
            "mesh": None if mesh is None else len(mesh),
            "walk_words": total_words(plan, calc)}
    if cards is not None:
        meta["mesh_cards"] = cards
    return Result(p, dt, algo_name=f"glynn_{where}_{calc}",
                  iterations=iters, meta=meta)
