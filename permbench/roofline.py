"""The least time each kernel's work could take on one H100, frozen here.

The work is the algorithm's, whatever implements it:
* a Gray-code Ryser walk of an order-n matrix takes 2^(n-1) steps (the
  sparse engine's reduced walk: the steps its plan walks, over its alive
  rows), and a step takes n - 1 multiplies, n adds and the tier's
  accumulator (ACC_OPS), all floating-point;
* a Z_p walk (calc="exact") takes the same steps a prime, and a step
  takes 2n + 6(n - 1) + 2 int32 operations: n modular adds (an add and a
  conditional subtract), n - 1 Montgomery products (three multiplies and
  three more) and the accumulator's modular add.
The least time is the operations over the peak.  The walks read a few KiB
of columns and write a few words a chunk, so bytes never bound them.

At n=32 these give the port's recorded bounds: 2^31 * 73 / 33.5e12 =
4.68 ms (K1 df64), 256 * 2^23 * 57 / 33.5e12 = 3.65 ms (K2 df64 at
n=24), 2^31 * 252 / 16.75e12 = 32.3 ms (K3 a prime).
"""

from __future__ import annotations

#: peak rates of one H100 SXM5 at its 700 W limit.  fp32: NVIDIA's data
#: sheet (67 TFLOP/s outside the tensor cores, an FMA counted as two).
#: fp64: half of it, 64 FP64 lanes of an SM's 128 (the data sheet's 34
#: TFLOP/s, rounded).  int32: derived, 64 INT32 lanes an SM at one
#: operation an instruction, a quarter of fp32.  bytes: the data sheet's
#: 3.35 TB/s of HBM3
PEAK = {"fp64": 33.5e12, "fp32": 67e12, "int32": 16.75e12,
        "bytes": 3.35e12}
#: operations of each tier's accumulator a term: df64 a double-double sum
#: (TwoSum 6 and its renormalisation 4), f32 one add, f32k TwoSum 6 and
#: the add that gathers its compensation
ACC_OPS = {"df64": 10, "f32": 1, "f32k": 7}
#: where each tier's operations run
PIPE = {"df64": "fp64", "f32": "fp32", "f32k": "fp32"}


def walk_ops(n: int, steps: int, tier: str = "df64") -> int:
    """Floating-point operations of `steps` Ryser steps over n rows."""
    return steps * (2 * n - 1 + ACC_OPS[tier])


def modp_ops(n: int, steps: int) -> int:
    """int32 operations of `steps` Z_p steps over n rows."""
    return steps * (2 * n + 6 * (n - 1) + 2)


def least_s(ops: int, pipe: str) -> float:
    """Seconds the operations take at the pipe's peak."""
    return ops / PEAK[pipe]


def call_least_s(call, n: int, batched: bool):
    """(the kernel that carries the call's walk, the least seconds of the
    walk's work) of one harness.Call of order n, or None for a call that
    returned nothing or ran a tier without a count here."""
    if not call.perms:
        return None
    if call.calc == "exact":
        steps = 1 << (call.core_n - 1)
        return ("modp_walk_kernel",
                least_s(call.primes * modp_ops(call.core_n, steps), "int32"))
    if call.calc not in ACC_OPS:
        return None
    pipe = PIPE[call.calc]
    if call.factored_rows is not None:
        alive = n - call.factored_rows
        return ("ryser_reduced_kernel",
                least_s(walk_ops(alive, call.iterations, call.calc), pipe))
    kernel = "ryser_batch_kernel" if batched else "ryser_walk_kernel"
    return (kernel, call.perms
            * least_s(walk_ops(n, 1 << (n - 1), call.calc), pipe))


def kernel_roofline(ctx, kernel: str):
    """The kernel's share of its roofline in %: the least time of the
    window's walks that it carries over its device time; None where the
    trace holds none of it."""
    dev_s = ctx.trace.kernel_s(kernel)
    least = 0.0
    for c in ctx.calls:
        got = call_least_s(c, ctx.n, ctx.batch > 1)
        if got is not None and got[0] == kernel:
            least += got[1]
    if not dev_s or not least:
        return None
    return 100.0 * least / dev_s
