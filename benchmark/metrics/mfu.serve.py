"""mfu.serve: share of the f32 peak in the traced window (%)."""
from benchmark.harness.readers import mfu


def read(ctx):
    return mfu(ctx, "serve")
