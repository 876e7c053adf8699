"""Orchestration: dispatch a (matrix, flags) pair to an engine.

Port of ``superman_tpu/drivers/runner.py`` for what the port carries so
far: the dense exact engine (ops/ryser.py) in the df64, f32, f32k, tf96 and
f64 tiers, the Glynn engine (ops/glynn.py, perman_algo="glynn") in the same
tiers, and the modular CRT exact engine (ops/exact.py, calc="exact").
Every other feature the flags can ask for raises NotImplementedError
naming the ROADMAP item that brings it; none is ignored, so no result
differs quietly from what the JAX package would return.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.flags import Flags, id_behavior
from ..core.matrix import DenseMatrix
from ..core.result import Result

#: ROADMAP.md Queue 1 items that carry the features not ported yet
ROADMAP_ITEMS = {
    5: "sparse engine",
    6: 'calc="auto" ladder',
    9: "estimators",
    10: "drivers, prep and rectangular",
    11: "multi-GPU and scheduling",
    12: "CLI, bindings and tools",
}


def unported(feature: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to superman_tpu_torch yet (ROADMAP.md "
        f"Queue 1 item {item}: {ROADMAP_ITEMS[item]})")


def run(dense: DenseMatrix, flags: Flags, device: torch.device) -> Result:
    # resolve the reference algorithm id up front (the same table as the
    # CLI); unknown ids raise here
    beh = id_behavior(flags.perman_algo, flags.sparse, flags.approximation)
    # calc="exact": modular-CRT integer permanent (ops/exact.py).  It
    # folds degree-1/2 lines in exact bigint arithmetic itself and must
    # not run under the sparse, scaling or compression drivers (those
    # round in f64), so it is routed before their guards.
    if flags.resolved_calc() == "exact" and not flags.approximation:
        from ..ops.exact import perman_exact
        return perman_exact(dense, flags, device)
    if flags.approximation:
        raise unported("approximation", 9)
    if beh["sparse"]:
        raise unported("the sparse walk (sparse=True or a SkipPer id)", 5)
    if beh["hybrid"] or flags.hybrid or flags.checkpoint_path:
        raise unported("the hybrid scheduler and checkpointing", 11)
    if beh["multi"] or (flags.mesh_shape is not None
                        and int(np.prod(flags.mesh_shape)) > 1):
        raise unported("multi-device runs", 11)
    if flags.scaling_threshold != -1.0:
        raise unported("Sinkhorn scaling", 10)
    if flags.compression:
        raise unported("compression", 10)
    return run_algo(dense, flags, device)


def run_algo(dense: DenseMatrix, flags: Flags, device: torch.device) -> Result:
    if flags.approximation:
        raise unported("approximation", 9)
    calc = flags.resolved_calc()
    if calc == "quad" or (flags.cpu and not flags.gpu):
        raise unported("the native CPU engine (cpu=True, calc='quad')", 12)
    if flags.dm_prune:
        raise unported("Dulmage-Mendelsohn pruning", 10)
    if calc == "auto":
        raise unported('calc="auto"', 6)
    if str(flags.perman_algo) == "glynn":
        # independent second exact engine (cross-algorithm oracle)
        from ..ops.glynn import glynn_exact
        res = glynn_exact(dense, flags, device)
    else:
        from ..ops.ryser import ryser_exact
        res = ryser_exact(dense, flags, device)
    flags.algo_name = res.algo_name
    return res
