"""io_ms.serve: median host time of a request's input and output handling outside device work (ms)."""
from benchmark.harness.program import median_host_ms


def read(ctx):
    return median_host_ms(ctx, "serve", "confignet.io.")
