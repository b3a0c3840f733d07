"""kernel_roofline.demo: the four kernels' share of their roofline in the traced window (%)."""
from benchmark.harness.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "demo")
