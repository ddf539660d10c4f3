"""``ray_march_kernel``'s share of its roofline, in %: the least time of its
launches a frame in the cell's ``kernel_launches`` table over their
measured device time a frame (``kernel_share.read``); None where the
profile shows no launch of it."""

from port_bench import kernel_share


def read(ctx):
    return kernel_share.read(ctx, "ray_march_kernel")
