"""frontend_ms.demo: median host time of a frame outside device work (ms)."""
from benchmark.harness.readers import median_frontend_ms


def read(ctx):
    return median_frontend_ms(ctx, "demo")
