"""Sinkhorn preconditioning driver.

Port of ``superman_tpu/drivers/scale_driver.py``.  Parity:
scale_and_calculate (reference revised_perman/main.cpp:1097-1264): swap
int storage to double (or float with -w), Sinkhorn-scale the matrix, run
(or hand off to the compression driver), then divide the result by
prod(r_v) * prod(c_v).  The scaled matrix is "double" storage, so a tier
that needs exact-f32 storage (tf96) falls back to df64 inside the engine
as it does for any real-valued matrix.
"""

from __future__ import annotations

import torch

from ..core.matrix import DenseMatrix
from ..core.result import Result
from ..prep.scaling import scalesk, scale_matrix, unscale_permanent


def scale_and_calculate(dense: DenseMatrix, flags, device: torch.device,
                        compressing: bool = False) -> Result:
    if dense.type == "int":
        dense = dense.astype("float" if flags.storage_half_precision
                             else "double")
        flags.type = dense.type
    sc = scalesk(dense.mat, flags.scaling_threshold)
    scaled = scale_matrix(dense, sc)

    if flags.compression and not compressing:
        from .compress_driver import compress_singleton_and_then_recurse
        res = compress_singleton_and_then_recurse(scaled, flags, device)
    else:
        from .runner import run_algo
        res = run_algo(scaled, flags, device)
    res.permanent = unscale_permanent(res.permanent, sc)
    res.meta["scaled"] = True
    return res
