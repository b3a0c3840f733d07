"""Runs of the harness with the look for a card skipped: a sound run is
judged correct, and a run whose timed path is broken underneath is judged
not correct, once for each fault the cells can have (an answer altered
where it is produced, half of the batch left out, a step that leaves its
state unchanged).  On the CPU at a small size; the fault that lives only in
a captured CUDA graph on the card at the cell's own size."""
from __future__ import annotations

import time

import pytest

from benchmark import run
from benchmark.faults import half_batch_in_captured_graph
from benchmark.harness.core import load_cell
from benchmark.tests.conftest import tiny_cell


def drive(name, cpu, seconds=1.5):
    return run.drive(tiny_cell(name), 2 ** 31 + 11, seconds, False, cpu, time.perf_counter())


def correct(outcome):
    return all(c.ok for c in outcome.checks)


@pytest.mark.parametrize("name", ["serve_256_interactive", "serve_512_bulk"])
def test_a_sound_serving_run_is_correct(name, cpu):
    outcome = drive(name, cpu)
    assert correct(outcome), outcome.checks
    rate = "demo_img_s" if name == "serve_256_interactive" else "render_img_s"
    assert outcome.attempted > 0 and outcome.metrics[rate] > 0


def test_an_altered_demo_frame_is_caught(cpu, monkeypatch):
    from confignet_tpu_torch.training import first_stage

    to_u8 = first_stage.uint8_from_unit_range

    def altered(x):
        out = to_u8(x).clone()
        out[:1] = 255 - out[:1]
        return out

    monkeypatch.setattr(first_stage, "uint8_from_unit_range", altered)
    assert not correct(drive("serve_256_interactive", cpu))


def test_an_altered_render_is_caught(cpu, monkeypatch):
    from confignet_tpu_torch.serving import ConfigNetServer

    generate = ConfigNetServer._generate

    def altered(self, latents, rotations):
        out = generate(self, latents, rotations).clone()
        out[:1] = 255 - out[:1]
        return out

    monkeypatch.setattr(ConfigNetServer, "_generate", altered)
    assert not correct(drive("serve_512_bulk", cpu))


def test_half_of_a_served_batch_left_out_is_caught(cpu, monkeypatch):
    from confignet_tpu_torch.serving import ConfigNetServer

    encode = ConfigNetServer._encode

    def half(self, images):
        latents, rotations = encode(self, images)
        h = latents.shape[0] // 2
        latents, rotations = latents.clone(), rotations.clone()
        latents[h:2 * h], rotations[h:2 * h] = latents[:h], rotations[:h]
        return latents, rotations

    monkeypatch.setattr(ConfigNetServer, "_encode", half)
    assert not correct(drive("serve_512_bulk", cpu))


def test_a_step_that_leaves_its_state_unchanged_is_caught(cpu, monkeypatch):
    from confignet_tpu_torch.training.state import OptaxAdam

    monkeypatch.setattr(OptaxAdam, "step", lambda self, closure=None: None)
    outcome = drive("train_256_stage2", cpu, seconds=0.5)
    assert not correct(outcome)
    read = {c.name: c.value for c in outcome.checks}
    assert read["change_gap"] > 0.5


def test_half_of_a_training_batch_left_out_is_caught(cpu, monkeypatch):
    from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage

    to_device = ConfigNetFirstStage._batch_to_device

    def half(self, batch):
        def cut(v):
            return [cut(x) for x in v] if isinstance(v, (list, tuple)) else v[:max(1, len(v) // 2)]
        return to_device(self, {k: cut(v) for k, v in batch.items()})

    monkeypatch.setattr(ConfigNetFirstStage, "_batch_to_device", half)
    outcome = drive("train_256_stage2", cpu, seconds=0.5)
    assert not correct(outcome)
    assert next(c for c in outcome.checks if c.name == "loss_gap").value > 1e-2


@pytest.mark.gpu
def test_half_of_a_training_batch_in_the_captured_graph_only_is_caught(gpu):
    cell = load_cell("train_256_stage2")
    with half_batch_in_captured_graph():
        outcome = run.drive(cell, 2 ** 31 + 13, 2.0, False, gpu, time.perf_counter())
    read = outcome.extra["readings"]
    assert not correct(outcome), read
    # the eager first step is whole; the captured and replayed steps are not
    assert read["loss_gap.1"] < cell.traffic["checks"]["loss_gap"] < read["loss_gap.2"], read
