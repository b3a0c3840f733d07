"""frontend_ms.serve: median host time of a request outside device work (ms)."""
from benchmark.harness.readers import median_frontend_ms


def read(ctx):
    return median_frontend_ms(ctx, "serve")
