"""Share of its roofline of K1, csrc/ryser_walk.cu ryser_walk_kernel: the
dense walks (2^(n-1) steps a matrix), in %: the walks' least time
(permbench/roofline.py) over the kernel's device time in the traced
window."""

from permbench.roofline import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "ryser_walk_kernel")
