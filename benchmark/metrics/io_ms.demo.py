"""io_ms.demo: median host time of a frame's input and output handling outside device work (ms)."""
from benchmark.harness.program import median_host_ms


def read(ctx):
    return median_host_ms(ctx, "demo", "confignet.io.")
