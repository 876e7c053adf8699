"""Run configuration.

The same fields as ``superman_tpu.core.flags`` (itself parity with the
reference's ``struct flags``, revised_perman/flags.h:48-143), so
``superman_tpu_torch.permanent(**overrides)`` accepts every override the
JAX package accepts.  Fields whose feature the port does not carry yet are
rejected by the dispatcher (drivers/runner.py), never ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# calc dtypes (the reference's calculation precision knobs -h/-q map to
# half/quad; the ladder is f32 < df64 < f64; "quad" maps to the
# CPU-native long-double path in the native engine).
CALC_DTYPES = ("f32", "f32k", "df64", "tf96", "f64", "quad")


@dataclasses.dataclass
class Flags:
    # ---- device / algorithm selection (flags.h:49-66) ----
    cpu: bool = False           # -c : run on host CPU (native engine / XLA-CPU)
    gpu: bool = True            # -g : run on the accelerator (the CUDA card)
    dense: bool = True
    sparse: bool = False        # -s
    exact: bool = True
    approximation: bool = False  # -a
    binary_graph: bool = False   # -b : treat all values as 1
    grid_graph: bool = False     # -i : compute #perfect-matchings of a grid
    gridm: int = 36              # -m
    gridn: int = 36              # -n
    perman_algo: str = "auto"    # -p : algorithm name or numeric alias
    threads: int = 16            # -t : host threads for the native CPU engine

    # ---- precision policy (flags.h:67-79) ----
    # storage dtype of the matrix ("int" | "float" | "double"); set by readers.
    type: str = "double"
    calculation_half_precision: bool = False  # -h : calc in f32
    calculation_quad_precision: bool = False  # -q : calc in quad (CPU only)
    storage_half_precision: bool = False      # -w : store matrix in f32
    storage_quad_precision: bool = False      # -v
    #: calc dtype; None -> derive from the booleans above
    calc: Optional[str] = None

    # ---- approximation parameters (flags.h:80-89) ----
    number_of_times: int = 100000  # -x : Monte-Carlo trials
    #: -y; -1 = auto: the SMC estimator selects scale_intervals by
    #: cross-population agreement (ops/approx._select_si — the round-4
    #: flagship needed a hand-picked si=2 against a si=4 proposal bias
    #: of ~-3 bits); the per-trial path resolves -1 to the reference
    #: default 4 (flags.h -y).  The CLI still passes 4 explicitly.
    scale_intervals: int = -1
    scale_times: int = 5           # -z

    # ---- preprocessing / transforms (flags.h:90-103) ----
    preprocessing: int = 0         # -r : 0 none, 1 SortOrder, 2 SkipOrder
    compression: bool = False      # -o : exact-preserving d1/d2/d34 reductions
    scaling_threshold: float = -1.0  # -u : Sinkhorn target row/col sum; -1 off

    # ---- run shape (flags.h:104-143) ----
    gpu_num: int = 2               # -d : number of accelerator devices to use
    device_id: int = 0             # -l
    rep: int = 1                   # -k : repetitions
    grid_multip: int = 1           # -e : grid-dim multiplier (launch tuning)

    # ---- engine knobs (no reference equivalent) ----
    #: log2 of the Gray-code chunk size; each kernel thread walks one chunk of
    #: 2**chunk_log2 consecutive subset indices. None -> auto from n.
    chunk_log2: Optional[int] = None
    #: chunk ids per id block (the padding granularity of the chunk list)
    lanes: int = 1024
    #: mesh axis sizes, e.g. (8,) for an 8-chip ring; None -> all local devices
    mesh_shape: Optional[Tuple[int, ...]] = None
    #: chunk-level dead-range pruning for sparse matrices (SkipPer)
    skip_pruning: bool = True
    #: Dulmage-Mendelsohn zero-structure pruning before orderings
    #: (sparyser CLI `dm` toggle): zero entries outside every perfect
    #: matching; detects per(A) = 0 structurally
    dm_prune: bool = False
    #: dynamic chunked accelerator+CPU scheduling (reference multigpucpu_chunks,
    #: algo ids 6/17); the CPU helper joins when `cpu` is also set
    hybrid: bool = False
    #: journal finished work units here; a restarted run resumes from it
    checkpoint_path: Optional[str] = None
    #: relative-accuracy target for calc="auto" escalation
    auto_target: float = 1e-9
    #: calc="auto" last rung: when even tf96's predicted error misses
    #: auto_target, escalate to the exact CRT engine (ops/exact.py) if
    #: its cost estimate fits this budget; else flag low_confidence
    auto_exact_budget_s: float = 30.0
    #: SMC population estimator for the scaling approximation:
    #: -1 auto (engage at n >= 64, where plain SIS dies by attrition),
    #: 0 never, 1 always (ops/approx.py:_smc_population)
    smc: int = -1
    #: x-distribution for the gurvits signed estimator: "auto" starts
    #: with Rademacher (minimum variance) and escalates to Gaussian when
    #: the probe batch collapses into the exact-zero atom (sparse signed
    #: rows cancel (Ax)_i to 0 for half the sign assignments — measured
    #: on 662_bus: 20000/20000 trials exactly zero); "rademacher" /
    #: "gaussian" force a choice.  Any iid zero-mean unit-variance x
    #: keeps the Glynn identity unbiased (ops/approx._gurvits_trial).
    gurvits_dist: str = "auto"
    #: accept non-square input and compute the RECTANGULAR permanent
    #: per_rect(A) = sum over injections of the smaller side into the
    #: larger (inputs with more rows than columns are transposed).
    #: Implemented by the exact padding identity
    #: per_rect(A) = per([A; ones(n-m, n)]) / (n-m)!  — every engine
    #: (exact walks, estimators, gurvits) runs on the padded square
    #: matrix unchanged.  The reference crashes on non-square input
    #: (its readers reject it; ch5-5-b2.mtx in its own corpus is
    #: 600x200).  Default False: a non-square matrix is usually a bug.
    rectangular: bool = False
    #: PRNG seed for approximation algorithms
    seed: int = 0

    # ---- bookkeeping ----
    filename: str = ""             # -f
    algo_name: str = ""

    def resolved_calc(self) -> str:
        if self.calc is not None:
            return self.calc
        if self.calculation_quad_precision:
            return "quad"
        if self.calculation_half_precision:
            return "f32"
        # reference default is double calc; the accelerator's default is
        # the compensated df64 tier
        return "f64" if self.resolved_device() == "cpu" else "df64"

    def resolved_device(self) -> str:
        # cpu AND gpu together = hybrid (both worker kinds participate)
        return "cpu" if (self.cpu and not self.gpu) else "gpu"


# Named (non-numeric) algorithms the engine accepts directly.
# "gurvits" (approximation context only): the Glynn/Gurvits unbiased
# estimator for ARBITRARY-SIGN matrices — beyond the reference, whose
# estimators all require nonnegative weights (algo.h:269/471).
_NAMED_ALGOS = ("auto", "glynn", "rasmussen", "scaling", "multi",
                "ryser_multi", "skipper", "gurvits")


def id_behavior(perman_algo, sparse: bool, approximation: bool) -> dict:
    """Unified v1+v2 algorithm-id table -> engine behavior.

    The reference interprets ``-p`` ids IN CONTEXT of (sparse, approx):
    v1 dispatch main.cu:20-248, v2 dispatch revised_perman/main.cpp:98-762.
    All memory-placement variants of one algorithm collapse onto the one
    engine; what remains of an id is three booleans:

      sparse — run the pruned (SkipPer-equivalent) path
      hybrid — dynamic chunked accelerator+CPU scheduling (multigpucpu_chunks)
      multi  — shard over a device mesh (multigpu)

    Exact, dense context (v1 main.cu:34-76 / v2 main.cpp:288-398):
      0,1,2,3,4,21  xglobal/xlocal/xshared/coalescing/mshared -> single
      5             multigpu                                  -> multi
      6             v1 multigpucpu_chunks                     -> multi+hybrid
                    (v2's 6 = manual 3/8,3/8,1/8,1/8 split — subsumed by
                    dynamic pulling, gpu_exact_dense.cu:941-968)
      7             v2 multigpucpu_chunks                     -> multi+hybrid
      66            v1 manual distribution                    -> multi
      8,14,17       SkipPer ids given without -s: imply sparse (below)

    Exact, sparse context (v1 main.cu:106-155 / v2 main.cpp:399-524):
      1,2,3,4       sparse memory variants   -> single, pruned
      5             multigpu_sparse          -> multi
      6             v1 multigpucpu_chunks_sparse -> multi+hybrid
      7             v1 SkipPer (v2: hybrid chunks sparse = use 6/8) -> single
      8             v1 multigpucpu_chunks_skipper -> multi+hybrid
      14            v2 SkipPer                    -> single
      17            v2 multigpucpu_chunks_skipper -> multi+hybrid
      66            v1 manual distribution sparse -> multi
      CPU-only sparse exact keeps v1/v2 CPU ids: 1 SparRyser, 2 SkipPer,
      3 balanced SkipPer (algo.h:568/748/885) — all map to the native
      engine's chunked-dynamic variants.

    Approximation context (v1 main.cu:78-104,157-183; v2 :526-653,705-753):
      1 rasmussen, 2 scaling, 3 rasmussen hybrid chunks (multi+hybrid),
      4 scaling hybrid chunks (multi+hybrid).

    Unknown numeric ids raise ValueError (the reference exits with "No
    algorithm with specified setting").
    """
    algo = str(perman_algo)
    out = {"sparse": sparse, "hybrid": False, "multi": False,
           "algo": algo}
    if algo in _NAMED_ALGOS:
        out["multi"] = algo in ("multi", "ryser_multi")
        out["sparse"] = sparse or algo == "skipper"
        return out
    if not algo.lstrip("-").isdigit():
        raise ValueError(f"unknown algorithm '{perman_algo}'")
    i = int(algo)
    if approximation:
        if i in (1, 3):
            out["algo"] = "rasmussen"
        elif i in (2, 4):
            out["algo"] = "scaling"
        else:
            raise ValueError(
                f"unknown approximation algorithm id {i} (valid: 1-4)")
        out["multi"] = out["hybrid"] = i in (3, 4)
        return out
    if sparse:
        if i not in (1, 2, 3, 4, 5, 6, 7, 8, 14, 17, 66):
            raise ValueError(
                f"unknown sparse exact algorithm id {i}")
        out["multi"] = i in (5, 6, 8, 17, 66)
        out["hybrid"] = i in (6, 8, 17)
        return out
    if i in (8, 14, 17):
        # SkipPer ids without -s: enable the sparse path (the reference
        # requires -s; we auto-enable for convenience)
        out["sparse"] = True
        out["multi"] = out["hybrid"] = i in (8, 17)
        return out
    if i not in (0, 1, 2, 3, 4, 5, 6, 7, 21, 66):
        raise ValueError(f"unknown dense exact algorithm id {i}")
    out["multi"] = i in (5, 6, 7, 66)
    out["hybrid"] = i in (6, 7)
    return out
