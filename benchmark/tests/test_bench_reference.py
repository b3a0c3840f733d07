"""The frozen reference against the port at a CPU size, on the same
weights: the served pipeline's renders and a stage-2 step's first losses
and gradients."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import weights
from benchmark.reference import model as ref
from benchmark.tests.conftest import TINY


def port_model(trees, names):
    from confignet_tpu_torch.training.second_stage import ConfigNet

    model = ConfigNet(dict(TINY["model"], seed=3), device="cpu", initialize=False)
    for name in names:
        getattr(model, name).load_state_dict(trees[name].state_dict())
    return model


def test_served_renders_match(cpu):
    from confignet_tpu_torch.serving import ConfigNetServer

    g = torch.Generator().manual_seed(5)
    photos = weights.random_u8((6, 128, 128, 3), g, cpu)
    trees = weights.make_trees(TINY, ref.SERVING_TREES, 5, cpu, photos)
    server = ConfigNetServer(port_model(trees, ref.SERVING_TREES), chunk=4, device="cpu")
    value = np.random.default_rng(0).standard_normal((1, 51)).astype(np.float32)
    poses = np.random.default_rng(1).uniform(-0.3, 0.3, (6, 3)).astype(np.float32)
    for rotations in (None, poses):
        served = server.render_with_attribute(photos.numpy(), "blendshape_values", value, rotations)
        want = ref.to_uint8(ref.render_with_attribute(
            trees, TINY["model"], photos, "blendshape_values", torch.from_numpy(value),
            None if rotations is None else torch.from_numpy(rotations))).numpy()
        gap = np.abs(served.astype(int) - want.astype(int))
        assert gap.max() <= 1 and gap.mean() < 1e-2


def test_first_stage2_step_matches(cpu):
    from benchmark.harness import train

    g = torch.Generator().manual_seed(7)
    traffic = {"real_images": 8, "synth_images": 8, "eye_mask_share": 0.05,
               "pose_ranges_deg": [[-30, 30], [-10, 10], [0, 0]]}
    real_set, synth_set, head = train.make_datasets(traffic, TINY["model"], g, cpu)
    trees = weights.make_trees(TINY, train.TRAIN_TREES, 7, cpu, head)
    model = port_model(trees, train.TRAIN_TREES)
    host = train.host_batch(np.random.default_rng(0), real_set, synth_set, TINY["model"])
    losses = model._build_train_step()(host)
    want = ref.Stage2Trainer(trees, dict(TINY["model"]), 3, cpu).step(ref.as_device_batch(host, cpu))
    for player in want:
        assert float(losses[player]["loss_sum"]) == pytest.approx(float(want[player]), rel=1e-5)
