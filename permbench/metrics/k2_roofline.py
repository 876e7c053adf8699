"""Share of its roofline of K2, csrc/ryser_batch.cu ryser_batch_kernel:
permanent_batch's walks (2^(n-1) steps a matrix), in %: the walks' least
time (permbench/roofline.py) over the kernel's device time in the traced
window."""

from permbench.roofline import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "ryser_batch_kernel")
