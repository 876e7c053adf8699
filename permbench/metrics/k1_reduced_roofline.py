"""Share of its roofline of K1's reduced entry, ryser_reduced_kernel: the
sparse engine's walks (the steps of its plan, Result.iterations, over
its alive rows), in %: the walks' least time (permbench/roofline.py)
over the kernel's device time in the traced window."""

from permbench.roofline import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "ryser_reduced_kernel")
