"""input_wait_ms.train: the program's wait for its next batch, mean per traced step (ms)."""
from benchmark.harness.program import mean_span_ms_per_step


def read(ctx):
    return mean_span_ms_per_step(ctx, "train", "confignet.data.wait")
