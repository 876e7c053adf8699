"""Share of its roofline of K3, csrc/modp_walk.cu modp_walk_kernel:
calc="exact"'s Z_p walks (2^(n-1) steps a prime, the verifier's too), in
%: the walks' least time (permbench/roofline.py) over the kernel's
device time in the traced window."""

from permbench.roofline import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "modp_walk_kernel")
