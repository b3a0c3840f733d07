"""data_wait_ms.train: mean wait in the prefetcher's next() per step (ms)."""
from benchmark.harness.readers import mean_data_wait_ms


def read(ctx):
    return mean_data_wait_ms(ctx, "train")
