"""superman_tpu_torch — the matrix permanent engine in PyTorch and CUDA.

The port of ``superman_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100.  It imports neither jax nor superman_tpu, and importing it
changes no global configuration.  It carries the exact engine: the
Gray-code Ryser walk in the df64, f32, f32k and tf96 tiers as a
hand-written CUDA kernel (csrc/ryser_walk.cu, also the sparse engine's
pruned walk and calc="auto"'s amp walk), and the float64 walk; the
serving batch over a second kernel on the same walk body
(csrc/ryser_batch.cu); calc="exact", the modular CRT engine over a
hand-written Z_p walk kernel (csrc/modp_walk.cu); the transform drivers
(Sinkhorn scaling, compression, Dulmage-Mendelsohn pruning), rectangular
permanents, and the Monte-Carlo estimators, grid graphs included.

    import superman_tpu_torch as spt
    spt.permanent(a)                  # on cuda:0
    spt.permanent(a, device="cpu")    # the kernels' plain versions
    spt.permanent_batch([a1, a2])     # same-order groups, one launch each
    spt.permanent(a, compression=True)            # folded core, certified
    spt.permanent(a, approximation=True)          # an estimate and stderr
    spt.grid_permanent(8, 8)          # perfect matchings of the 8x8 grid

A NaN or infinite entry is refused with a ValueError before any walk.
SUPERMAN_DEBUG_NANS=1 in the environment, read at every call
(utils/debug.py), makes a NaN in the output of a walk or an estimator's
trial raise FloatingPointError, as the reference's jax_debug_nans does.
"""

from .core.flags import Flags
from .core.result import Result
from .core.matrix import DenseMatrix, SparseMatrix, matrix2compressed
from .io.triplet import read_triplet, write_triplet
from .io.matrixmarket import read_matrix_market, read_any
from .api import grid_permanent, permanent, permanent_batch

__version__ = "0.1.0"

__all__ = [
    "Flags", "Result", "DenseMatrix", "SparseMatrix", "matrix2compressed",
    "read_triplet", "write_triplet", "read_matrix_market", "read_any",
    "permanent", "permanent_batch", "grid_permanent",
]
