"""Top-level Python API.

``permanent(matrix_or_path, device=None, **flag_overrides)`` is the entry
point, as ``superman_tpu.permanent`` is for the JAX package, with one
addition: the torch device the engine runs on.  ``permanent_batch`` is
the serving entry point for many matrices at once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Union

import numpy as np
import torch

from .core.flags import Flags
from .core.matrix import DenseMatrix, SparseMatrix
from .core.result import Result
from .drivers.runner import run, unported
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


def _as_dense(m, flags: Flags) -> DenseMatrix:
    if m is None:
        if flags.grid_graph:
            raise unported("grid-graph permanents", 9)
        raise ValueError("matrix is required")
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
                      flags.storage_quad_precision)
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
    if dm.mat.ndim != 2 or dm.mat.shape[0] != dm.mat.shape[1]:
        raise ValueError("matrix must be square")
    if flags.binary_graph:
        dm = dm.binarized()
    flags.type = dm.type
    return dm


def permanent(matrix: Union[np.ndarray, DenseMatrix, str, None] = None,
              device: Union[str, torch.device, None] = None,
              **overrides) -> Result:
    """Compute the permanent of a square matrix.

    matrix: array-like, DenseMatrix, SparseMatrix or a path (triplet /
    MatrixMarket).
    device: the torch device to run on; None means cuda:{device_id} and
    raises RuntimeError when CUDA is absent.  "cpu" runs the kernels'
    plain PyTorch versions.
    overrides: any `Flags` field, e.g. calc="f64", chunk_log2=6.
    """
    flag_fields = {f.name for f in dataclasses.fields(Flags)}
    unknown = set(overrides) - flag_fields
    if unknown:
        raise TypeError(f"unknown flags: {sorted(unknown)}")
    flags = Flags(**overrides)
    if flags.rectangular:
        raise unported("rectangular permanents", 10)
    dev = resolve_device(device, flags)
    dm = _as_dense(matrix, flags)
    with trace.profile("superman_tpu_torch.permanent"):
        with trace.timer(f"permanent[{flags.algo_name or flags.perman_algo}]",
                         level=2):
            res = run(dm, flags, dev)
    spans = trace.drain_spans()
    if spans:
        res.meta.setdefault("spans", spans)
    return res


def permanent_batch(mats: Sequence[np.ndarray],
                    device: Union[str, torch.device, None] = None,
                    **overrides) -> List[Result]:
    """Permanents of many square matrices; same-order groups share one
    kernel launch (see ops.batch.permanent_batch).  device as in
    `permanent`."""
    from .ops.batch import permanent_batch as _pb
    return _pb(mats, device=device, **overrides)
