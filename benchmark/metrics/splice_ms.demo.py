"""splice_ms.demo: median host time of a frame's attribute splice outside device work (ms)."""
from benchmark.harness.program import median_host_ms


def read(ctx):
    return median_host_ms(ctx, "demo", "confignet.splice")
