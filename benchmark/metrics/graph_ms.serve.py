"""graph_ms.serve: median host time of a request in the graph cache outside device work (ms)."""
from benchmark.harness.program import median_host_ms


def read(ctx):
    return median_host_ms(ctx, "serve", "confignet.graph.")
