#!/usr/bin/env python3
"""Count the host-to-device copies of one float32 stage-2 train step and the
card's busy share of its wall time, on one NVIDIA GPU.

    python3 chip_copies.py [--label NAME] [--steps 3]

The model and batch are chip_smoke.py step 8's (256px, batch 24, the encoder
heads given weights); each step takes a host batch, whose arrays it copies
to the device itself (the same copies in every version of the step).  After
two warm-up steps, ``--steps`` steps run under torch.profiler; the script
prints, per step, the ``aten::copy_`` calls, the host-to-device memcpys the
card ran, the device's busy time (kernels and copies) and the wall time,
with the card's name and power limit, then one JSON line.

To compare two versions of the package in turns, run this script once per
tree with ``python3 -P`` (so the script's own directory is not put on the
import path) and ``PYTHONPATH`` set to that tree, in the order A B B A.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

import confignet_tpu_torch
from chip_smoke import TRAIN_BATCH, FakeDataset, TRAIN_CONFIG, card_line, give_encoder_heads_weights, train_config
from confignet_tpu_torch.ops import cuda_build
from confignet_tpu_torch.training.second_stage import ConfigNet


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--label", default="", help="a name for this run's line")
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_copies: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    cuda_build.build()
    dataset = FakeDataset(64, 256, {name: dims[0] for name, dims
                                    in TRAIN_CONFIG["facemodel_inputs"].items()}, seed=0)
    model = ConfigNet(train_config("float32"))
    give_encoder_heads_weights(model, dataset.imgs[:TRAIN_BATCH])
    step = model._build_train_step()
    batches = [model._sample_host_batch(dataset, dataset) for _ in range(args.steps + 2)]
    for batch in batches[:2]:
        step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[2:]:
            step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    copies = sum(e.count for e in events if e.key == "aten::copy_")
    device = [e for e in events if e.device_type.name == "CUDA"]
    h2d = sum(e.count for e in device if "HtoD" in e.key)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    rec = dict(label=args.label, package=confignet_tpu_torch.__file__, card=card, steps=args.steps,
               copy_calls_per_step=copies / args.steps, h2d_memcpys_per_step=h2d / args.steps,
               device_busy_ms_per_step=busy_ms / args.steps, wall_ms_per_step=wall_ms / args.steps,
               device_busy_share=busy_ms / wall_ms)
    print(f"copies {args.label}: per f32 stage-2 step {rec['copy_calls_per_step']:.1f} aten::copy_, "
          f"{rec['h2d_memcpys_per_step']:.1f} HtoD memcpys, device busy "
          f"{rec['device_busy_ms_per_step']:.1f} of {rec['wall_ms_per_step']:.1f} ms "
          f"({100 * rec['device_busy_share']:.1f}%) on {card} ({rec['package']})", flush=True)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
