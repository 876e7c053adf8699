"""Top-level Python API.

``permanent(matrix_or_path, device=None, **flag_overrides)`` is the entry
point, as ``superman_tpu.permanent`` is for the JAX package, with one
addition: the torch device the engine runs on.  ``permanent_batch`` is
the serving entry point for many matrices at once, ``grid_permanent`` the
perfect-matching count of a grid graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .core.flags import Flags
from .core.matrix import DenseMatrix, SparseMatrix, require_finite
from .core.result import Result
from .drivers.runner import run
from .utils import trace


def resolve_device(device, flags: Flags) -> torch.device:
    """device=None means cuda:{flags.device_id} and raises when CUDA is
    absent: the plain CPU versions run only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
        return torch.device("cuda", flags.device_id)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _pad_rect(dm: DenseMatrix, flags: Flags
              ) -> Tuple[DenseMatrix, Optional[Tuple[int, int]]]:
    """Rectangular reduction (flags.rectangular): per_rect(A), the sum
    over injections of the smaller side into the larger, equals
    per([A; ones(n-m, n)]) / (n-m)! exactly, so every engine runs
    unchanged on the padded square matrix.  Inputs with more rows than
    columns are transposed first (per_rect is defined for m <= n).

    Returns (the square matrix, (m, n) or None when the input was
    square).  The shape goes back to the caller, never onto `flags`: a
    Flags reused after a rectangular call must not divide a square
    result by (n-m)!."""
    a = np.asarray(dm.mat)
    m_, n_ = a.shape
    if m_ == n_:
        return dm, None
    if not flags.rectangular:
        raise ValueError(
            f"matrix is {m_}x{n_} (not square); pass rectangular=True "
            "for the injection-sum rectangular permanent")
    if m_ > n_:
        a = a.T
        m_, n_ = n_, m_
    pad = np.ones((n_ - m_, n_), dtype=a.dtype)
    return DenseMatrix(np.vstack([a, pad]), dm.type), (m_, n_)


def _unpad_rect_result(res: Result, rect: Tuple[int, int]) -> Result:
    """Divide the padding (n-m)! back out of a Result (value, meta
    log2_estimate, stderr), in log space where (n-m)! leaves the double
    range."""
    m_, n_ = rect
    k = n_ - m_
    fact_l2 = math.lgamma(k + 1) / math.log(2.0)
    with np.errstate(over="ignore", invalid="ignore"):
        if np.isfinite(res.permanent) and res.permanent != 0.0:
            if k <= 170:      # (n-m)! fits f64: one division
                res.permanent = res.permanent / float(math.factorial(k))
            else:
                sgn = math.copysign(1.0, res.permanent)
                res.permanent = sgn * float(
                    np.exp2(np.log2(abs(res.permanent)) - fact_l2)) + 0.0
        elif np.isinf(res.permanent) and "log2_estimate" in res.meta:
            l2 = float(res.meta["log2_estimate"]) - fact_l2
            sgn = float(res.meta.get("sign", 1.0))
            res.permanent = sgn * float(np.exp2(min(l2, 1100))) + 0.0
        if res.meta.get("log2_estimate") is not None:
            res.meta["log2_estimate"] = \
                float(res.meta["log2_estimate"]) - fact_l2
        if res.meta.get("stderr"):
            se = float(res.meta["stderr"])
            if np.isfinite(se) and se > 0:
                res.meta["stderr"] = (
                    se / float(math.factorial(k)) if k <= 170 else
                    float(np.exp2(np.log2(se) - fact_l2)) + 0.0)
    res.meta["rect_shape"] = [m_, n_]
    res.meta["pad_rows"] = k
    return res


def _as_dense(m, flags: Flags
              ) -> Tuple[DenseMatrix, Optional[Tuple[int, int]]]:
    """(the square matrix the engines run on, the rectangular input's
    (m, n) or None)."""
    if m is None:
        if not flags.grid_graph:
            raise ValueError("matrix is required unless grid_graph=True")
        from .prep.gridgraph import grid_graph_matrix
        dm = grid_graph_matrix(flags.gridm, flags.gridn)
        flags.type = dm.type
        return dm, None
    if isinstance(m, SparseMatrix):
        # keep the storage class: densifying as "double" would hide an
        # integer-valued input's exact storage
        vals = np.asarray(m.cvals)
        if np.issubdtype(vals.dtype, np.integer):
            tname = "int"
        elif vals.dtype == np.float32:
            tname = "float"
        else:
            tname = "double"
        m = m.to_dense(tname)
    if isinstance(m, DenseMatrix):
        dm = m
    elif isinstance(m, str):
        from .io.matrixmarket import read_any
        dm = read_any(m, flags.binary_graph, flags.storage_half_precision,
                      flags.storage_quad_precision,
                      allow_rect=flags.rectangular)
        flags.filename = m
    else:
        a = np.asarray(m)
        if np.issubdtype(a.dtype, np.integer):
            tname = "int"
        elif a.dtype == np.float32:
            tname = "float"
        else:
            tname = "double"
        dm = DenseMatrix(a, tname)
    if dm.mat.ndim != 2 or (dm.mat.shape[0] != dm.mat.shape[1]
                            and not flags.rectangular):
        raise ValueError("matrix must be square")
    # before the binarization, which would turn a NaN into a 1
    require_finite(dm.mat)
    if flags.binary_graph:
        dm = dm.binarized()
    dm, rect = _pad_rect(dm, flags)
    flags.type = dm.type
    return dm, rect


def permanent(matrix: Union[np.ndarray, DenseMatrix, str, None] = None,
              device: Union[str, torch.device, None] = None,
              **overrides) -> Result:
    """Compute the permanent of a square matrix (or, with
    rectangular=True, the injection-sum permanent of an m x n one).

    matrix: array-like, DenseMatrix, SparseMatrix, a path (triplet /
    MatrixMarket), or None with grid_graph=True (the perfect matchings of
    a gridm x gridn grid).
    device: the torch device to run on; None means cuda:{device_id} and
    raises RuntimeError when CUDA is absent.  "cpu" runs the kernels'
    plain PyTorch versions.
    overrides: any `Flags` field, e.g. calc="f64", chunk_log2=6,
    compression=True, scaling_threshold=1.0, dm_prune=True,
    rectangular=True, approximation=True.
    """
    with trace.entry("superman_tpu_torch.permanent") as spans:
        with trace.timer("api_prepare"):
            flag_fields = {f.name for f in dataclasses.fields(Flags)}
            unknown = set(overrides) - flag_fields
            if unknown:
                raise TypeError(f"unknown flags: {sorted(unknown)}")
            flags = Flags(**overrides)
            dev = resolve_device(device, flags)
            dm, rect = _as_dense(matrix, flags)
        with trace.timer(f"permanent[{flags.algo_name or flags.perman_algo}]",
                         level=2):
            res = run(dm, flags, dev)
    if spans:
        res.meta.setdefault("spans", spans)
    if rect is not None:
        res = _unpad_rect_result(res, rect)
    return res


def permanent_batch(mats: Sequence[np.ndarray],
                    device: Union[str, torch.device, None] = None,
                    **overrides) -> List[Result]:
    """Permanents of many square matrices; same-order groups share one
    kernel launch (see ops.batch.permanent_batch).  device as in
    `permanent`."""
    from .ops.batch import permanent_batch as _pb
    return _pb(mats, device=device, **overrides)


def grid_permanent(m: int, n: int,
                   device: Union[str, torch.device, None] = None,
                   **overrides) -> Result:
    """Number of perfect matchings of an m x n grid graph (reference -i);
    device as in `permanent`."""
    overrides.setdefault("grid_graph", True)
    overrides.setdefault("gridm", m)
    overrides.setdefault("gridn", n)
    return permanent(None, device=device, **overrides)
