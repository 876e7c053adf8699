"""Share of its roofline of K1, csrc/ryser_walk.cu ryser_walk_kernel,
over a walk dealt over the cell's cards, in %: the walks' least time on
one card's FP64 peak (permbench/roofline.py, 2^(n-1) steps a matrix) over
the kernel's device seconds summed over every card of the traced window
(the profiler records each card's kernels), so at most 100%.  None where
the trace holds no instance of the kernel."""

from permbench.roofline import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "ryser_walk_kernel")
