"""The port's train steps through their graph caches (core/graphs.py
``GraphCache.run_step``), on the CPU.

On the card a train step's loss dicts are a captured graph's output
buffers, which the next replay overwrites, and a step is captured at the
second call of its key, after the first call has built the optimizers'
state.  Here every function runs directly, so these tests stand in for the
card where the CPU can hold the logic:

- the stage-1 ``train()`` loop and the LatentGAN step with every step's
  outputs overwritten in place at the next call, as a replay overwrites
  them: the losses the loop logs (and the losses a step returned) still
  equal those of a run without the overwrite, bit for bit;
- the policy of ``run_step`` (eager, then capture, then replay; the key
  taken again after the eager call) through a cache whose capture and
  replay are stand-ins;
- the train step's graph key: it changes with the batch's structure and
  shapes, the R1 heads and the optimizers' state.
"""
import math

import numpy as np
import pytest
import torch

from helpers import FakeDataset, TINY_FIRST_STAGE_CONFIG
from confignet_tpu_torch.core import graphs
from confignet_tpu_torch.core.graphs import GraphCache
from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage
from confignet_tpu_torch.training.latent_gan import LatentGAN
from confignet_tpu_torch.training.state import optimizer_state

torch.set_num_threads(1)

LOOP_CONFIG = dict(TINY_FIRST_STAGE_CONFIG, loss_print_period=2, image_checkpoint_period=100,
                   metrics_checkpoint_period=100, async_checkpointing=False)
LOOP_STEPS = 5


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in _leaves(value)]
    return [tree]


def _overwriting_run_step(monkeypatch):
    """``GraphCache.run_step`` that, at each call, first overwrites the
    outputs of the call before it with NaN (as a replay overwrites its
    graph's output buffers); returns the list of calls."""
    run_step, last, calls = GraphCache.run_step, [], []

    def overwriting(self, *args, **kwargs):
        with torch.no_grad():
            for tensor in last:
                tensor.fill_(math.nan)
        out = run_step(self, *args, **kwargs)
        last[:] = _leaves(out)
        calls.append(len(last))
        return out

    monkeypatch.setattr(GraphCache, "run_step", overwriting)
    return calls


def _loop_histories(tmp_path, name):
    dataset = FakeDataset(n_images=8, img_size=128)
    dataset.inception_features = np.random.default_rng(2).normal(size=(8, 2048)).astype(np.float32)
    np.random.seed(3)
    model = ConfigNetFirstStage(dict(LOOP_CONFIG), device="cpu")
    np.random.seed(5)
    model.train(dataset, dataset, str(tmp_path / name), str(tmp_path / (name + "_logs")),
                n_steps=LOOP_STEPS, n_samples_for_metrics=2)
    return {"g": model.g_losses, "d": model.d_losses, "synth_d": model.synth_d_losses,
            "latent_d": model.latent_d_losses}


def test_loop_logs_each_steps_losses_when_replays_overwrite_them(tmp_path, monkeypatch):
    """Stage-1 train() for 5 steps, flushing every 2: with each step's
    outputs overwritten at the next step, every logged loss equals the
    run without overwrites bit for bit (the step copies its losses out of
    the buffers before it returns)."""
    want = _loop_histories(tmp_path, "plain")
    calls = _overwriting_run_step(monkeypatch)
    got = _loop_histories(tmp_path, "overwritten")
    assert len(calls) == LOOP_STEPS and all(n > 0 for n in calls)
    assert got == want
    assert all(len(v) == LOOP_STEPS and np.isfinite(v).all()
               for history in got.values() for v in history.values())


def test_latent_gan_step_returns_its_own_losses(monkeypatch):
    """Two LatentGAN steps with the first one's outputs overwritten by the
    second call: the losses the first step returned are unchanged, and
    equal an untouched model's."""
    config = {"latent_dim": 12, "batch_size": 8}
    real = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 12)).astype(np.float32))
    plain_step = LatentGAN(config, device="cpu")._build_train_step()
    want = [{g: {k: float(v) for k, v in d.items()} for g, d in plain_step(real).items()}
            for _ in range(2)]
    calls = _overwriting_run_step(monkeypatch)
    step = LatentGAN(config, device="cpu")._build_train_step()
    first = step(real)
    second = step(real)
    assert len(calls) == 2
    for got, expected in ((first, want[0]), (second, want[1])):
        assert {g: {k: float(v) for k, v in d.items()} for g, d in got.items()} == expected


class _StandInCache(GraphCache):
    """A cache that takes the card's path on the CPU: a capture records the
    function and its input buffers, a replay runs it on them."""

    active = True

    def __init__(self):
        super().__init__("cpu")
        self.log = []

    def run_on_capture_stream(self, fn, *args):
        self.log.append("eager")
        return fn(*args)

    def capture(self, key, fn, inputs=(), modules=(), generators=()):
        self.log.append("capture")
        assert tuple(generators) == (self.generator,)
        self._entries[key] = graphs._Entry(fn, tuple(inputs), None, (0, 0, 0, 0))

    def replay(self, key, tensors=()):
        self.log.append("replay")
        entry = self._entries[key]
        for static, tensor in zip(entry.inputs, tensors):
            static.copy_(tensor)
        return entry.graph(*entry.inputs)


def test_run_step_runs_eagerly_then_captures_then_replays():
    """A stateful step whose state appears at its first call: call 1 runs
    eagerly and the key is taken again after it, call 2 captures and
    replays, calls 3-4 replay; each call computes on its own input."""
    cache = _StandInCache()
    cache.generator = torch.Generator()
    weight = torch.nn.Linear(3, 1)
    optimizer_state = {}

    def fn(x):
        if "moment" not in optimizer_state:  # built at the first call, as Adam's moments
            optimizer_state["moment"] = torch.zeros(())
        optimizer_state["moment"].add_(x.sum())
        return {"loss": weight(x).sum() + optimizer_state["moment"]}

    state = lambda: list(optimizer_state.values())  # noqa: E731
    outs = [cache.run_step("step", fn, (torch.full((2, 3), float(i)),), (weight,), state,
                           (cache.generator,))["loss"] for i in range(1, 5)]
    assert cache.log == ["eager", "capture", "replay", "replay", "replay"]
    assert len(cache) == 1 and optimizer_state["moment"].item() == 6 * (1 + 2 + 3 + 4)
    with torch.no_grad():
        w, b = weight.weight.sum().item(), weight.bias.item()
    moments = np.cumsum([6 * i for i in range(1, 5)])
    for i, (out, moment) in enumerate(zip(outs, moments), 1):
        assert out.item() == pytest.approx(2 * (i * w + b) + moment)


def _device_batch(model, dataset):
    return model._batch_to_device(model._sample_host_batch(dataset, dataset))


def _step_key(model, batch, r1_heads="all"):
    leaves, structure = graphs.flatten(batch)
    return GraphCache("cpu").key(model._train_step_name(structure, r1_heads),
                                 model._train_step_modules(), leaves,
                                 optimizer_state(model.optimizers))


def test_train_step_graph_key_follows_batch_structure_r1_heads_and_state():
    dataset = FakeDataset(n_images=8, img_size=128)
    model = ConfigNetFirstStage(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
    batch = _device_batch(model, dataset)
    leaves, structure = graphs.flatten(batch)
    rebuilt = graphs.unflatten(structure, leaves)
    assert rebuilt.keys() == batch.keys()
    for name, value in batch.items():
        assert (all(a is b for a, b in zip(rebuilt[name], value)) if isinstance(value, list)
                else rebuilt[name] is value)
    key = _step_key(model, batch)
    assert key == _step_key(model, _device_batch(model, dataset))
    assert key != _step_key(model, batch, r1_heads="final")
    # a batch of another size: the same structure, other shapes
    smaller = {k: [x[:2] for x in v] if isinstance(v, list) else v[:2] for k, v in batch.items()}
    assert key != _step_key(model, smaller)
    # two discriminator updates: every D field stacked on a leading axis
    stacked = ConfigNetFirstStage(dict(TINY_FIRST_STAGE_CONFIG, n_discriminator_updates=2),
                                  device="cpu")
    stacked.set_weights(model.get_weights())
    stacked_batch = _device_batch(stacked, dataset)
    assert graphs.flatten(stacked_batch)[1] == structure
    assert _step_key(stacked, stacked_batch)[0] != key[0]
    # the first step builds the Adam state, whose addresses join the key
    model._build_train_step()(batch)
    assert optimizer_state(model.optimizers) and _step_key(model, batch) != key
