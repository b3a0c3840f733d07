"""chunk_fill.serve: rows requested over rows run, padding included, in the traced slice (%)."""
from benchmark.harness.program import chunk_fill


def read(ctx):
    return chunk_fill(ctx, "serve")
