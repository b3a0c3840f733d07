"""first_call_s.train: host seconds of the graph caches' first calls of a key over the run (s)."""
from benchmark.harness.program import first_call_s


def read(ctx):
    return first_call_s(ctx, "train")
