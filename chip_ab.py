#!/usr/bin/env python3
"""Time two variants of the port's paths in turns, in one process on one
NVIDIA GPU, so that host and card drift fall on both alike.

    python3 chip_ab.py [--out results.json]

1. The MLPs' LeakyReLU (``models/blocks.MLP``): ``LeakyReLUUnitGradAtZero``,
   whose gradient at exactly 0 is 1 as JAX's is, against ``F.leaky_relu``,
   whose gradient there is the slope.  A float32 stage-2 train step
   (chip_smoke.py step 8's model: 256px, batch 24) and a float32 fine-tune
   (step 9's: the serving model, one photo) run in blocks in the order
   A B B A A B B A, each block TRAIN_STEPS steps or FINE_TUNE_ITERS
   iterations; one step and one FINE_TUNE_PROFILE_ITERS-iteration fine-tune
   of each variant are counted in device ops under torch.profiler.
2. ``ConfigNetServer.sample(256, truncation=0.7)`` against ``generate`` of
   256 latents on one bfloat16 server (chunk 32), with each LeakyReLU
   variant: per round the variants in the order A B B A, each with a generate
   and a sample request, ROUNDS rounds; and ``generate_latents(256, 0.7)``,
   the work ``sample`` adds, alone.

Prints every block, a summary per variant (median, min, max), the card's
name and power limit, then the records as one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from chip_smoke import (TRAIN_BATCH, TRAIN_CONFIG, FakeDataset, card_line, check_finite,
                        give_encoder_heads_weights, serving_config, train_config)
from confignet_tpu_torch.core import graphs
from confignet_tpu_torch.models import blocks
from confignet_tpu_torch.ops import cuda_build
from confignet_tpu_torch.serving import ConfigNetServer
from confignet_tpu_torch.training.latent_gan import LatentGAN
from confignet_tpu_torch.training.second_stage import ConfigNet

TRAIN_STEPS = 3
FINE_TUNE_ITERS = 50
FINE_TUNE_PROFILE_ITERS = 5
ROUNDS = 10
SAMPLE_N = 256
ORDER = ("function", "leaky_relu", "leaky_relu", "function") * 2


@contextlib.contextmanager
def mlp_activation(variant: str):
    """``function``: the MLPs as committed; ``leaky_relu``: F.leaky_relu.
    Both run op by op (``graphs.eager()``): a replayed CUDA graph would run
    whichever variant it captured."""
    with graphs.eager():
        if variant == "function":
            yield
            return
        with mock.patch.object(blocks.LeakyReLUUnitGradAtZero, "apply",
                               lambda x, negative_slope: F.leaky_relu(x, negative_slope)):
            yield


def device_ops(fn) -> int:
    """Device ops of one fn() under torch.profiler (chip_smoke.profile's count)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def summary(values) -> dict:
    return dict(median=statistics.median(values), min=min(values), max=max(values), n=len(values))


def in_blocks(label: str, unit: str, per_block: int, block, card: str) -> dict:
    """``block()`` once per entry of ORDER under that variant, after one
    warm-up of each; its rate in ``unit`` per second, per variant."""
    for variant in ("function", "leaky_relu"):
        with mlp_activation(variant):
            block(1)
    rates = {"function": [], "leaky_relu": []}
    for variant in ORDER:
        with mlp_activation(variant):
            seconds = block(per_block)
        rates[variant].append(per_block / seconds)
        print(f"{label} {variant}: {per_block} {unit} in {seconds * 1e3:.1f} ms = "
              f"{per_block / seconds:.4f} {unit}/s ({card})", flush=True)
    rec = {variant: summary(values) for variant, values in rates.items()}
    rec["blocks"] = rates
    rec["function_over_leaky_relu"] = rec["function"]["median"] / rec["leaky_relu"]["median"]
    print(f"{label}: median {unit}/s function {rec['function']['median']:.4f}, leaky_relu "
          f"{rec['leaky_relu']['median']:.4f}, ratio {rec['function_over_leaky_relu']:.4f}",
          flush=True)
    return rec


def stage2_ab(card: str) -> dict:
    dataset = FakeDataset(64, 256, {name: dims[0] for name, dims
                                    in TRAIN_CONFIG["facemodel_inputs"].items()}, seed=0)
    trainer = ConfigNet(train_config("float32"))
    give_encoder_heads_weights(trainer, dataset.imgs[:TRAIN_BATCH])
    step = trainer._build_train_step()

    def block(n):
        batches = [trainer._sample_host_batch(dataset, dataset) for _ in range(n)]
        losses = []
        seconds = timed(lambda: losses.extend(step(b) for b in batches))
        for value in losses:
            check_finite(value, "stage2 float32")
        return seconds

    rec = in_blocks("stage2 float32 step", "steps", TRAIN_STEPS, block, card)
    batch = trainer._sample_host_batch(dataset, dataset)
    for variant in ("function", "leaky_relu"):
        with mlp_activation(variant):
            rec[f"device_ops_{variant}"] = device_ops(lambda: step(batch))
    print(f"stage2 float32 step: device ops function {rec['device_ops_function']}, leaky_relu "
          f"{rec['device_ops_leaky_relu']}", flush=True)
    return rec


def fine_tune_ab(card: str) -> dict:
    model = ConfigNet(serving_config("float32"))
    size = model.config["output_shape"][0]
    photos = np.random.default_rng(0).integers(0, 256, (8, size, size, 3), dtype=np.uint8)
    give_encoder_heads_weights(model, photos)
    photo = photos[0]

    def block(n):
        seconds = timed(lambda: model.fine_tune_on_img(photo, n_iters=n))
        if not np.isfinite(float(model.fine_tune_losses[-1])):
            raise AssertionError(f"fine-tune loss {model.fine_tune_losses[-1]}")
        return seconds

    rec = in_blocks("fine-tune float32", "iters", FINE_TUNE_ITERS, block, card)
    for variant in ("function", "leaky_relu"):
        with mlp_activation(variant):
            rec[f"device_ops_{variant}"] = device_ops(
                lambda: model.fine_tune_on_img(photo, n_iters=FINE_TUNE_PROFILE_ITERS))
    print(f"fine-tune float32 ({FINE_TUNE_PROFILE_ITERS} iterations): device ops function "
          f"{rec['device_ops_function']}, leaky_relu {rec['device_ops_leaky_relu']}", flush=True)
    return rec


def sample_ab(card: str) -> dict:
    model = ConfigNet(serving_config("bfloat16"))
    gan = LatentGAN({"latent_dim": model.config["latent_dim"]})
    server = ConfigNetServer(model, gan, chunk=32)
    rotations = model.sample_rotations(SAMPLE_N)
    latents = gan.generate_latents(SAMPLE_N, truncation=0.7)
    requests = {"generate": lambda: server.generate(latents, rotations),
                "sample": lambda: server.sample(SAMPLE_N, rotations=rotations, truncation=0.7)}
    for variant in ("function", "leaky_relu"):
        with mlp_activation(variant):
            for call in requests.values():
                call()
    rates = {f"{kind} {variant}": [] for kind in requests for variant in ("function", "leaky_relu")}
    for _ in range(ROUNDS):
        for variant in ORDER[:4]:
            with mlp_activation(variant):
                for kind, call in requests.items():
                    rates[f"{kind} {variant}"].append(SAMPLE_N / timed(call))
    latents_ms = [timed(lambda: gan.generate_latents(SAMPLE_N, truncation=0.7)) * 1e3
                  for _ in range(ROUNDS)]
    rec = {key: summary(values) for key, values in rates.items()}
    rec["requests"] = rates
    rec["generate_latents_ms"] = summary(latents_ms)
    for key, values in rates.items():
        s = rec[key]
        print(f"{key}: {s['n']} requests of {SAMPLE_N}, img/s median {s['median']:.1f} (min "
              f"{s['min']:.1f}, max {s['max']:.1f}) at 256px bfloat16, chunk 32 ({card})", flush=True)
    s = rec["generate_latents_ms"]
    print(f"generate_latents({SAMPLE_N}, 0.7): median {s['median']:.3f} ms (min {s['min']:.3f}, "
          f"max {s['max']:.3f})", flush=True)
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the records to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    t_start = time.perf_counter()
    cuda_build.build()
    records = {"card": card, "torch": torch.__version__}
    for name, fn in (("sample", sample_ab), ("fine_tune", fine_tune_ab), ("stage2", stage2_ab)):
        records[name] = fn(card)
        torch.cuda.empty_cache()
    records["seconds"] = time.perf_counter() - t_start
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    print(f"card: {card}")
    print(json.dumps(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
