"""idle_share.serve: the device's idle share in the traced window (%)."""
from benchmark.harness.readers import idle_share


def read(ctx):
    return idle_share(ctx, "serve")
