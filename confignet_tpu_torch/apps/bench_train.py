"""Training-path benchmarks of the port on one GPU: the counterpart of the
JAX package's ``bench_train.py`` at the repository root, with its rows,
metric names and configuration.

    python3 -m confignet_tpu_torch.apps.bench_train [--only NAMES] [--iters 10]
        [--batch_size N] [--r1_heads all|final] [--set key=json ...]
        [--device cuda|cpu] [--out PATH]

Prints one JSON line a row and writes the rows to ``--out`` (by default
``chiprun_out/bench_train.json`` in the checkout).  ``--only`` takes a comma
list of ``stage1_f32, stage1_bf16, stage2_f32, stage2_bf16, fine_tune,
serving, gen512, checkpointing``:

- ``stage{1,2}_train_step_{float32,bfloat16}``: steps/s of the stage's train
  step at ``BENCH_CONFIG`` (256px, batch 24), ``--iters`` steps chained with
  no host sync after two warm steps, ending at the last step's
  ``g/loss_sum``: on the card the captured step (``core/graphs.py``; the
  warm steps run eagerly and capture), and the same chain run eagerly
  (``graphs.eager()``) as ``eager_steps_per_s``.  First, under
  deterministic algorithms, ``CHECK_STEPS`` steps through the graph must
  equal the same steps run eagerly from the same state bit for bit
  (``captured_against_eager``).  Batches come through
  ``data/prefetch.BatchPrefetcher``, or
  with ``BENCH_STAGED=1`` three batches staged on the device beforehand
  (the metric then ends in ``_staged``).  ``_b<N>`` marks a batch other than
  24 and ``_r1_final`` the single-head R1 penalty.
- ``one_shot_fine_tune``: iters/s of ``ConfigNet.fine_tune_on_img`` on one
  photo (f32; one warm call of 2 iterations, then a call of 50 timed, on the
  card one eager iteration and 49 replays of its captured graph).
- ``serving_encode_splice_generate``: img/s of ``ConfigNetServer``'s encode,
  ``blendshape_values`` splice and generate as one batch-128 bf16 call on
  uint8 photos staged on the device once: eager, and replayed through the
  server's graph cache (``graph_img_s``; its renders must equal the eager
  call's bit for bit).
- ``generator_fwd_512_throughput``: img/s of the 512px bf16 generator at
  batch 64, the headline's method (``apps/bench.py``): eager, and replayed
  as one CUDA graph (``graph_img_s``).
- ``train_loop_ckpt_{steady,async,sync}``: steps/s of one stage-1 model's
  ``train()`` (bf16) over three windows of 40 steps: no checkpoint, one every
  10 steps on the worker thread, one every 10 steps inline; then
  ``ckpt_stall_per_event_*`` (s) and ``ckpt_overhead_at_500_*`` (% at the
  500-step cadence).  Rows are refused when the checkpoints that ran differ
  from the schedule.

Every timed window starts with the four kernel wrappers' launch counters at
zero and ends by holding them to the window's launches: a generator forward
(1, 0, 6, 0) at 256px and (1, 0, 7, 0) at 512px, a train step (4, 2, 24, 12),
a fine-tune iteration (0, 0, 6, 6), in (rotation, transpose, AdaIN, AdaIN
backward); none on the CPU.  So no row can time the plain path on the card.
A row that raises prints an error row; the others still run, and the
process exits 1.  TF32 is off.  Each row names its device, and on the card
the card (``nvidia-smi`` name and power limit) and its peak memory.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import itertools
import json
import math
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from confignet_tpu_torch.core import graphs, initializers
from confignet_tpu_torch.core.device import card_line, resolve_device
from confignet_tpu_torch.core.graphs import GraphCache
from confignet_tpu_torch.data.distributions import fit_distribution
from confignet_tpu_torch.data.prefetch import BatchPrefetcher
from confignet_tpu_torch.models.generator import HologanGenerator
from confignet_tpu_torch.ops.launches import (LAUNCH_NAMES, launch_counts, scaled, unit_launches,
                                              zero_launch_counts)
from confignet_tpu_torch.serving import ConfigNetServer
from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage, checkpoint_chunks
from confignet_tpu_torch.training.second_stage import ConfigNet

BENCH_CONFIG = {
    # Reference-scale model: 256px output, 5 discriminator layers, the
    # standard 145-dim latent layout.  Facemodel input dims are plausible
    # stand-ins (they only size the tiny per-param MLPs).
    "output_shape": (256, 256, 3),
    "n_discr_layers": 5,
    "batch_size": 24,  # reference default (confignet_first_stage.py:53)
    "facemodel_inputs": {
        "texture_embedding": (60, 30),
        "geometry_identity_params": (60, 30),
        "blendshape_values": (51, 30),
        "beard_style_embedding": (7, 7),
        "eyebrow_style_embedding": (7, 7),
        "lower_eyelash_style": (2, 2),
        "upper_eyelash_style": (2, 2),
        "head_hair_style_embedding": (9, 9),
        "eye_color": (3, 3),
        "head_hair_color": (3, 3),
        "hdri_embedding": (20, 20),
        "bone_rotations:left_eye": (2, 2),
    },
    "metrics_checkpoint_period": 10 ** 9,
    "image_checkpoint_period": 10 ** 9,
}
ROW_NAMES = ("stage1_f32", "stage1_bf16", "stage2_f32", "stage2_bf16", "fine_tune", "serving",
             "gen512", "checkpointing")
LATENT_DIM = 145  # the generator rows' latent, as bench.py's
SERVING_BATCH = 128
GEN512_BATCH, GEN512_ITERS = 64, 10
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "bench_train.json"

def check_launches(label: str, expected: tuple, device: torch.device) -> Dict[str, int]:
    """The launch counters since the last zeroing, held to ``expected`` (to
    none on the CPU, where the wrappers take their plain versions)."""
    got = launch_counts()
    want = tuple(expected) if device.type == "cuda" else (0,) * len(LAUNCH_NAMES)
    if got != want:
        raise AssertionError(f"{label}: launches {LAUNCH_NAMES} {got}, expected {want}")
    return dict(zip(LAUNCH_NAMES, got))


def device_fields(device: torch.device) -> Dict[str, Any]:
    """What every row says of where it ran."""
    if device.type != "cuda":
        return {"device": device.type, "kind": None, "card": None}
    return {"device": "cuda", "kind": torch.cuda.get_device_name(device), "card": card_line()}


def tf32_on(device: torch.device) -> bool:
    return device.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                                      or torch.backends.cudnn.allow_tf32)


def turn_tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def start_window(device: torch.device) -> None:
    """Wait for queued work, clear the peak memory and zero the counters."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()


def peak_gb(device: torch.device) -> Optional[float]:
    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None


def release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _emit(results: List[dict], metric: str, value: float, unit: str, **extra) -> dict:
    row = {"metric": metric, "value": value, "unit": unit, **extra}
    results.append(row)
    print(json.dumps(row), flush=True)
    return row


def poses(batch: int, rng) -> np.ndarray:
    """The reference's head-pose sampling ranges (yaw +-30deg, pitch
    +-10deg, roll 0), as bench.py draws them: the rotation kernel's work
    depends on the poses, so the bench uses the real distribution."""
    rot = rng.uniform(-1.0, 1.0, size=(batch, 3)).astype(np.float32)
    rot *= np.array([np.pi / 6, np.pi / 18, 0.0], np.float32)
    return rot


LEFT_EYE = "bone_rotations:left_eye"


class BenchDataset:
    """The root bench_train.py's training set: the draws of its
    ``tests/helpers.FakeDataset``, in their order, from numpy's
    ``default_rng(seed)``: uint8 images, eye masks, one Gaussian array per
    face-model input, rotations uniform in +-0.2 rad on all three axes and
    32-dim stand-in Inception features (which the trainer recomputes, as
    the JAX trainer does)."""

    def __init__(self, n_images: int, img_size: int, facemodel_dims: dict, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.imgs = rng.integers(0, 256, size=(n_images, img_size, img_size, 3), dtype=np.uint8)
        self.eye_masks = (rng.random((n_images, img_size, img_size)) > 0.95).astype(np.uint8)
        self.metadata_inputs = {name: rng.normal(size=(n_images, dim)).astype(np.float32)
                                for name, dim in facemodel_dims.items()}
        self.metadata_inputs["rotations"] = rng.uniform(-0.2, 0.2, size=(n_images, 3)).astype(
            np.float32)
        self.inception_features = rng.normal(size=(n_images, 32)).astype(np.float32)


def fake_dataset(config: dict, distributions: bool = False) -> BenchDataset:
    """64 fake images at the config's size, as the root bench_train.py's
    ``_fake_dataset`` draws them at seed 0: the left eye's input is taken out
    of the drawn dims and copied from the first two rotation axes.  With
    ``distributions`` also exemplar distributions of the metadata, which
    ``train()`` stores in its checkpoints."""
    dims = {k: v[0] for k, v in config["facemodel_inputs"].items() if k != LEFT_EYE}
    dataset = BenchDataset(64, config["output_shape"][0], dims, seed=0)
    if LEFT_EYE in config["facemodel_inputs"]:
        dataset.metadata_inputs[LEFT_EYE] = dataset.metadata_inputs["rotations"][:, :2].copy()
    if distributions:
        dataset.metadata_input_distributions = {
            name: fit_distribution(values, "exemplar")
            for name, values in dataset.metadata_inputs.items()}
    return dataset


# -- the generator forward: the headline's method --------------------------------


def bench_generator(size: int, device: torch.device, config: Optional[dict] = None,
                    dtype: Optional[torch.dtype] = torch.bfloat16) -> HologanGenerator:
    """The generator at ``size`` px with weights from a seeded
    ``torch.Generator``.  ``config`` may narrow it (the trainer's
    ``n_generator_features``, ``const_input_shape``, ``n_adain_mlp_units``,
    ``n_adain_mlp_layers``); by default it has the reference's widths."""
    config = config or {}
    generator = HologanGenerator(
        latent_dim=LATENT_DIM, output_shape=(size, size), dtype=dtype,
        n_features_first=config.get("n_generator_features", 256),
        const_shape=tuple(config.get("const_input_shape", (4, 4, 4, 512))),
        n_adain_mlp_units=config.get("n_adain_mlp_units", 128),
        n_adain_mlp_layers=config.get("n_adain_mlp_layers", 2))
    initializers.initialize(generator, torch.Generator().manual_seed(0))
    return generator.to(device).eval()


def generator_inputs(batch: int):
    """(z, poses) of the generator rows, float32 from numpy seed 0 in
    bench.py's order."""
    rng = np.random.default_rng(0)
    z = rng.normal(size=(batch, LATENT_DIM)).astype(np.float32)
    return z, poses(batch, rng)


def forward_loop(generator, z: torch.Tensor, rot: torch.Tensor, n_iters: int):
    """bench.py's loop body ``n_iters`` times, on the device: ``out =
    G(z + i * 1e-6, rot)``, ``acc += sum(out in float32)``.  Returns (acc, the
    last out); nothing waits for the device."""
    acc = torch.zeros((), dtype=torch.float32, device=z.device)
    out = None
    for i in range(n_iters):
        out = generator(z + i * 1e-6, rot)
        acc = acc + out.float().sum()
    return acc, out


def generator_throughput(results: List[dict], metric: str, size: int, batch: int, n_iters: int,
                         device=None, config: Optional[dict] = None) -> dict:
    """img/s of the bf16 generator at ``size`` px over ``n_iters`` forwards
    of ``batch`` (bench.py's method): z and the poses from numpy seed 0, one
    warm run of the loop, then a timed run ending at ``acc.item()``; on the
    card also the loop replayed as one CUDA graph (``graph_img_s``), the
    counterpart of bench.py's single jitted ``fori_loop``."""
    device = resolve_device(device)
    generator = bench_generator(size, device, config)
    z, rot = (torch.from_numpy(a).to(device) for a in generator_inputs(batch))
    expected = scaled(n_iters, unit_launches("forward", size))
    with torch.inference_mode():
        forward_loop(generator, z, rot, n_iters)[0].item()  # builds kernels, constants, plans
        start_window(device)
        t0 = time.perf_counter()
        acc, out = forward_loop(generator, z, rot, n_iters)
        acc_value = acc.item()
        seconds = time.perf_counter() - t0
        launches = check_launches(metric, expected, device)
        peak = peak_gb(device)
        if out.shape != (batch, size, size, 3) or not math.isfinite(acc_value):
            raise AssertionError(f"{metric}: images {tuple(out.shape)}, acc {acc_value}")
        del out
        graph_img_s = graph_launches = graph_acc = None
        if device.type == "cuda":
            # the loop captured once (a warm call that captures, then a
            # warm replay) and one timed replay ending at acc.item()
            cache = GraphCache(device)

            def loop():
                return cache.run(("loop", n_iters),
                                 lambda z, rot: forward_loop(generator, z, rot, n_iters)[0],
                                 (z, rot), (generator,))

            loop()
            loop().item()
            start_window(device)
            t0 = time.perf_counter()
            graph_acc = loop().item()
            graph_s = time.perf_counter() - t0
            graph_launches = check_launches(f"{metric} (graph)", expected, device)
            del cache
            # the same work on the same inputs: every op on the path, the
            # kernels' fixed-order reductions included, gives the same bits
            if graph_acc != acc_value:
                raise AssertionError(f"{metric}: the replayed graph gave acc {graph_acc}, "
                                     f"the eager loop {acc_value}")
            graph_img_s = n_iters * batch / graph_s
    del generator
    release(device)
    return _emit(results, metric, n_iters * batch / seconds, "img/s", batch=batch, n_iters=n_iters,
                 graph_img_s=graph_img_s, dtype="bfloat16", launches=launches,
                 graph_launches=graph_launches, acc=acc_value, graph_acc=graph_acc,
                 peak_memory_gb=peak, **device_fields(device))


# -- the training rows -------------------------------------------------------------------


def _metric_name_parts(cfg: dict, staged: bool):
    """Metric-name suffix + row annotations shared by both train-step benches.

    Non-default R1 head selection gets its own metric name so a --r1_heads
    run can't silently replace the reference-semantics row — this applies
    to stage 2 as much as stage 1 (r1_heads changes both steps' semantics)."""
    suffix = "" if cfg["batch_size"] == 24 else f"_b{cfg['batch_size']}"
    suffix += "_staged" if staged else ""
    row_kwargs = {}
    if cfg.get("r1_heads", "all") != "all":
        suffix += f"_r1_{cfg['r1_heads']}"
        row_kwargs["note"] = (
            f"r1_heads={cfg['r1_heads']} (single-head R1, Mescheder-style) "
            "instead of the reference's per-head penalty")
    return suffix, row_kwargs


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic algorithms, and PyTorch's deterministic
    implementations where an op has one (a warning names any op without)."""
    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


# the steps of a train row's captured chain held to its eager chain
CHECK_STEPS = 2


def step_state(model) -> Dict[str, torch.Tensor]:
    """Every tensor a train step writes, by name: each weight tree's
    parameters and buffers (the EMA generator's too) and each player's
    optimizer state (moments, step counts)."""
    state = {f"{tree}/{name}": tensor for tree in model.WEIGHT_TREES
             for name, tensor in getattr(model, tree).state_dict().items()}
    for player, optimizer in sorted(model.optimizers.items()):
        for i, param_state in enumerate(optimizer.state.values()):
            state.update({f"{player}/{i}/{key}": value for key, value in param_state.items()})
    return state


def captured_against_eager(model, step, inputs: List[Any], label: str) -> Dict[str, Any]:
    """A train step's graph against its eager run, under deterministic
    algorithms: one step on ``inputs[0]`` (the first call of its key, so
    eager: it builds the optimizers' state), then from the state it leaves
    a step on each of the other inputs run eagerly (``graphs.eager()``),
    then, from that state restored in place and the draw generator's
    restored, the same steps through the graph (the first captures, the
    others replay).  Every tensor of :func:`step_state`, every loss, the
    launches and the draw generator's state after each step must be equal
    bit for bit, and that state must move at every step (each replay draws
    afresh).  Returns the steps held, the state tensors compared and the
    graph's launches over the steps."""
    with deterministic_algorithms():
        step(inputs[0])
        state = step_state(model)
        with torch.no_grad():
            start = {k: v.clone() for k, v in state.items()}
        draws = model._draws.get_state()
        runs = {}
        for mode in ("eager", "graph"):
            with torch.no_grad():
                for k, v in state.items():
                    v.copy_(start[k])
            model._draws.set_state(draws)
            zero_launch_counts()
            losses, draw_states = [], []
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                for x in inputs[1:]:
                    losses.append(step(x))
                    draw_states.append(model._draws.get_state())
            with torch.no_grad():
                runs[mode] = ({k: v.clone() for k, v in state.items()}, losses, draw_states,
                              launch_counts())
    (eager_state, eager_losses, eager_draws, eager_launches) = runs["eager"]
    (graph_state, graph_losses, graph_draws, launches) = runs["graph"]
    unequal = [k for k in eager_state if not torch.equal(eager_state[k], graph_state[k])]
    unequal += [f"step {i + 1} {group}/{key}"
                for i, (a, b) in enumerate(zip(eager_losses, graph_losses))
                for group in a for key in a[group] if not torch.equal(a[group][key], b[group][key])]
    unequal += [f"the draw generator after step {i + 1}"
                for i, (a, b) in enumerate(zip(eager_draws, graph_draws)) if not torch.equal(a, b)]
    if unequal or launches != eager_launches:
        raise AssertionError(f"{label}: {len(inputs) - 1} captured steps differ from the eager "
                             f"steps in {len(unequal)} tensors ({unequal[:5]}); launches "
                             f"{launches} against {eager_launches}")
    if any(torch.equal(a, b) for a, b in zip([draws] + graph_draws, graph_draws)):
        raise AssertionError(f"{label}: a captured step left the draw generator where it was")
    return {"steps": len(inputs) - 1, "tensors": len(eager_state), "launches": launches}


def _timed_train_steps(model, dataset, n_iters: int, label: str):
    """steps/s of ``n_iters`` train steps chained with no host sync after
    two warm steps (on the card the first runs eagerly, the second captures
    the step), ending at ``.item()`` of the last step's ``g/loss_sum``; then
    the same chain run eagerly.  First ``CHECK_STEPS`` captured steps are
    held to the eager ones (:func:`captured_against_eager`).  Batches come
    through a BatchPrefetcher (host sampling and the copy on a background
    thread, as ``train()`` runs), or with BENCH_STAGED=1 from three batches
    staged on the device beforehand.  Returns (steps/s, eager steps/s,
    staged, launches, peak GB, the check's record)."""
    device = model.device
    step = model._build_train_step()
    expected = scaled(n_iters, unit_launches("train_step", model.config["output_shape"][0]))
    staged = os.environ.get("BENCH_STAGED") == "1"

    def timed(next_batch, mode):
        start_window(device)
        t0 = time.perf_counter()
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            for _ in range(n_iters):
                losses = step(next_batch())
            loss = losses["g"]["loss_sum"].item()
        seconds = time.perf_counter() - t0
        launches = check_launches(f"{label} ({mode})", expected, device)
        if not math.isfinite(loss):
            raise AssertionError(f"{label} ({mode}): loss {loss}")
        return n_iters / seconds, launches

    def chain(next_batch):
        check = captured_against_eager(model, step, [next_batch() for _ in range(CHECK_STEPS + 1)],
                                       label)
        for _ in range(2):
            warm = step(next_batch())["g"]["loss_sum"].item()
            if not math.isfinite(warm):
                raise AssertionError(f"{label}: warm step loss {warm}")
        rate, launches = timed(next_batch, "graph")
        peak = peak_gb(device)
        eager_rate, _ = timed(next_batch, "eager")
        return rate, eager_rate, staged, launches, peak, check

    if staged:
        batches = [model._batch_to_device(model._sample_host_batch(dataset, dataset))
                   for _ in range(3)]
        return chain(itertools.cycle(batches).__next__)
    with BatchPrefetcher(lambda: model._sample_host_batch(dataset, dataset), device=device) as pf:
        return chain(pf.next)


def _train_step_row(results, stage: str, model, cfg: dict, dtype_name: str, n_iters: int) -> dict:
    dataset = fake_dataset(cfg)
    rate, eager_rate, staged, launches, peak, check = _timed_train_steps(
        model, dataset, n_iters, f"{stage} {dtype_name}")
    suffix, row_kwargs = _metric_name_parts(cfg, staged)
    device = model.device
    return _emit(results, f"{stage}_train_step_{dtype_name}{suffix}", rate, "steps/s",
                 batch=cfg["batch_size"], imgs_per_sec=rate * cfg["batch_size"], n_iters=n_iters,
                 eager_steps_per_s=eager_rate, graph_check=check, dtype=dtype_name,
                 tf32=tf32_on(device), launches=launches, peak_memory_gb=peak, **row_kwargs,
                 **device_fields(device))


def bench_stage1(results, dtype_name: str, n_iters: int = 10, config: dict = BENCH_CONFIG,
                 device=None) -> dict:
    cfg = dict(config, compute_dtype=dtype_name)
    return _train_step_row(results, "stage1", ConfigNetFirstStage(cfg, device=device), cfg,
                           dtype_name, n_iters)


def bench_stage2(results, dtype_name: str, n_iters: int = 10, config: dict = BENCH_CONFIG,
                 device=None) -> dict:
    cfg = dict(config, compute_dtype=dtype_name)
    return _train_step_row(results, "stage2", ConfigNet(cfg, device=device), cfg, dtype_name,
                           n_iters)


def bench_fine_tune(results, n_iters: int = 50, config: dict = BENCH_CONFIG, device=None) -> dict:
    """iters/s of fine_tune_on_img on one seeded photo (the config's dtype:
    float32 for BENCH_CONFIG): one warm call of 2 iterations (on the card it
    captures the iteration's CUDA graph), then a call of ``n_iters`` timed,
    its first iteration eager and the others replays, ending as the call
    returns the embeddings to the host."""
    cfg = dict(config)
    model = ConfigNet(cfg, device=device)
    device = model.device
    size = cfg["output_shape"][0]
    img = np.random.default_rng(0).integers(0, 256, (size, size, 3), dtype=np.uint8)
    model.fine_tune_on_img(img, n_iters=2)
    start_window(device)
    t0 = time.perf_counter()
    model.fine_tune_on_img(img, n_iters=n_iters)
    seconds = time.perf_counter() - t0
    launches = check_launches("one_shot_fine_tune",
                              scaled(n_iters, unit_launches("fine_tune_iteration", size)), device)
    peak = peak_gb(device)
    loss = float(model.fine_tune_losses[-1])
    if not math.isfinite(loss):
        raise AssertionError(f"one_shot_fine_tune: final loss {loss}")
    del model
    release(device)
    rate = n_iters / seconds
    return _emit(results, "one_shot_fine_tune", rate, "iters/s", total_s_for_50=50 / rate,
                 n_iters=n_iters, dtype=cfg.get("compute_dtype") or "float32",
                 tf32=tf32_on(device), launches=launches, peak_memory_gb=peak,
                 final_loss=loss, **device_fields(device))


def bench_serving(results, n_iters: int = 20, config: dict = BENCH_CONFIG, device=None,
                  batch: int = SERVING_BATCH) -> dict:
    """img/s of the serving pipeline: encode a uint8 photo batch, splice a
    zero ``blendshape_values`` into the latents, render with the EMA
    generator; ConfigNetServer's own building blocks as one bf16 call of
    ``batch`` (no chunking), the photos staged on the device once.  Each
    call ends at a host copy of one pixel.  On the card, CUDA events around
    the encode and around the splice and generate split each call's stream
    time (host gaps included) as ``encode_ms`` and ``generate_ms``."""
    cfg = dict(config, compute_dtype="bfloat16")
    model = ConfigNet(cfg, device=device)
    device = model.device
    size = cfg["output_shape"][0]
    server = ConfigNetServer(model, chunk=batch, device=device)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)).to(device)
    param_name = "blendshape_values"
    value = torch.zeros((1, cfg["facemodel_inputs"][param_name][0]), device=device)

    events = []

    def mark():
        if device.type == "cuda":
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

    def pipeline():
        mark()
        latents, rotations = server._encode(imgs)
        mark()
        out = server._generate(server._splice(latents, param_name, value), rotations)
        mark()
        return out

    with torch.inference_mode():
        pipeline()[0, 0, 0].cpu()
        start_window(device)
        events.clear()
        t0 = time.perf_counter()
        for _ in range(n_iters):
            out = pipeline()
            out[0, 0, 0].cpu()
        seconds = time.perf_counter() - t0
    split = {"encode_ms": None, "generate_ms": None}
    if events:
        calls = [events[i:i + 3] for i in range(0, len(events), 3)]
        split = {"encode_ms": sum(a.elapsed_time(b) for a, b, _ in calls) / n_iters,
                 "generate_ms": sum(b.elapsed_time(c) for _, b, c in calls) / n_iters}
    expected = scaled(n_iters, unit_launches("forward", size))
    launches = check_launches("serving_encode_splice_generate", expected, device)
    peak = peak_gb(device)
    if out.shape != (batch, size, size, 3) or out.dtype != torch.uint8:
        raise AssertionError(f"serving: renders {out.dtype} {tuple(out.shape)}")
    graph_img_s = graph_launches = None
    if device.type == "cuda":
        graph_s, graph_launches, graph_out = _serving_graph_run(server, imgs, value, param_name,
                                                                n_iters, expected)
        # the same call on the same inputs: the replay gives the eager renders' bits
        if not torch.equal(graph_out, out):
            raise AssertionError("serving: the replayed graph's renders differ from the eager "
                                 "call's")
        graph_img_s = batch * n_iters / graph_s
    del model, server, out
    release(device)
    return _emit(results, "serving_encode_splice_generate", batch * n_iters / seconds, "img/s",
                 batch=batch, n_iters=n_iters, graph_img_s=graph_img_s, dtype="bfloat16", **split,
                 launches=launches, graph_launches=graph_launches, peak_memory_gb=peak,
                 **device_fields(device))


def _serving_graph_run(server, imgs, value, param_name: str, n_iters: int, expected: tuple):
    """The serving row's call through the server's graph cache: one call
    that captures, then ``n_iters`` replays, each ending at a host copy of
    one pixel.  Returns (seconds, the replays' launches, the last renders)."""
    modules = (server._encoder, server._synthetic_encoder, server._generator)

    def render(imgs, value):
        latents, rotations = server._encode(imgs)
        return server._generate(server._splice(latents, param_name, value), rotations)

    def call():
        return server._graphs.run(("bench_serving", param_name), render, (imgs, value), modules)

    with torch.inference_mode():
        call()[0, 0, 0].cpu()
        start_window(imgs.device)
        t0 = time.perf_counter()
        for _ in range(n_iters):
            out = call()
            out[0, 0, 0].cpu()
        seconds = time.perf_counter() - t0
        launches = check_launches("serving_encode_splice_generate (graph)", expected, imgs.device)
        return seconds, launches, out.clone()


def bench_generator_512(results, n_iters: int = GEN512_ITERS, config: Optional[dict] = None,
                        device=None, batch: int = GEN512_BATCH) -> dict:
    """512px generator forward throughput, the headline's method at
    ``output_shape`` (512, 512) (the reference ships 256 and 512 models)."""
    return generator_throughput(results, "generator_fwd_512_throughput", 512, batch, n_iters,
                                device, config)


class _Sink:
    """An ``aml_run``: takes the loop's values in place of its matplotlib
    loss plots (the card's machine has no matplotlib)."""

    def log(self, name, value):
        pass


def bench_checkpointing(results, window: int = 40, period: int = 10, config: dict = BENCH_CONFIG,
                        device=None, metric_samples: int = 64) -> List[dict]:
    """Checkpoint cost through the real train loop.

    One model runs three consecutive ``train()`` windows of ``window``
    steps: checkpoint-free, checkpoints every ``period`` steps on the worker
    thread, and inline (the reference's semantics), so the comparison
    carries no cross-model noise.  ``period`` 10 is 50x denser than the
    production cadence (500), so besides the dense-cadence rates this emits
    the per-event stall and the projected overhead at a 500-step cadence.
    A checkpoint renders the two panels and scores FID/KID on
    ``metric_samples`` latents, and writes its files."""
    cfg = dict(config, compute_dtype="bfloat16", image_checkpoint_period=10 ** 9,
               metrics_checkpoint_period=10 ** 9, async_checkpointing=True,
               loss_print_period=10 ** 9)
    dataset = fake_dataset(cfg, distributions=True)
    model = ConfigNetFirstStage(cfg, device=device)
    device = model.device
    size = cfg["output_shape"][0]
    chunks = checkpoint_chunks(model, metric_samples)
    sink = _Sink()
    rates, events, window_launches = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        logs = os.path.join(tmp, "logs")
        # setup + warm-up + step 0 (and its checkpoint), untimed
        model.train(dataset, dataset, tmp, logs, n_steps=1, n_samples_for_metrics=metric_samples,
                    aml_run=sink)
        next_start = 1
        for label, p, async_flag in [("steady", 10 ** 9, True), ("async", period, True),
                                     ("sync", period, False)]:
            model.config["image_checkpoint_period"] = p
            model.config["metrics_checkpoint_period"] = p
            model.config["async_checkpointing"] = async_flag
            end = next_start + window
            events_before = model.checkpoint_events_run
            start_window(device)
            stats = model.train(dataset, dataset, tmp, logs, n_steps=end,
                                n_samples_for_metrics=metric_samples, aml_run=sink)
            next_start = end
            rates[label] = stats["steps_run"] / stats["loop_seconds"]
            # count the checkpoints that dispatched: never trust the schedule
            events[label] = model.checkpoint_events_run - events_before
            expected = sum(1 for s in range(end - stats["steps_run"], end) if s % p == 0)
            if events[label] != expected:
                raise RuntimeError(
                    f"checkpoint window '{label}' dispatched {events[label]} checkpoint(s), "
                    f"schedule says {expected} — the bench would be measuring nothing; "
                    "refusing to emit rows")
            launches = tuple(
                s + c for s, c in zip(scaled(stats["steps_run"], unit_launches("train_step", size)),
                                      scaled(events[label] * chunks,
                                             unit_launches("forward", size))))
            window_launches[label] = check_launches(f"train_loop_ckpt_{label}", launches, device)
            _emit(results, f"train_loop_ckpt_{label}", rates[label], "steps/s",
                  batch=cfg["batch_size"], n_steps=stats["steps_run"],
                  checkpoint_events=events[label], dtype="bfloat16",
                  launches=window_launches[label], peak_memory_gb=peak_gb(device),
                  **device_fields(device))
    del model
    release(device)

    steady = rates["steady"]
    for label in ("async", "sync"):
        n_ev = max(events[label], 1)
        stall_s = max(0.0, (window / rates[label] - window / steady) / n_ev)
        overhead_500 = 100.0 * stall_s / (500.0 / steady + stall_s)
        # the window this row is derived from (with the steady one)
        derived = dict(windows=["steady", label], launches=window_launches[label],
                       **device_fields(device))
        _emit(results, f"ckpt_stall_per_event_{label}", stall_s, "s",
              note="extra wall per checkpoint event vs checkpoint-free window", **derived)
        _emit(results, f"ckpt_overhead_at_500_{label}", overhead_500, "%",
              note="projected steps/s loss at the production 500-step cadence", **derived)
    return results


# -- the command line -----------------------------------------------------------------


def bench_config(args) -> dict:
    """BENCH_CONFIG with the command line's overrides (a copy)."""
    config = copy.deepcopy(BENCH_CONFIG)
    if args.batch_size is not None:
        config["batch_size"] = args.batch_size
    if args.r1_heads is not None:
        config["r1_heads"] = args.r1_heads
    for override in args.set:
        key, _, raw = override.partition("=")
        try:
            config[key] = json.loads(raw)
        except json.JSONDecodeError:
            config[key] = raw
    return config


def rows(args, config: dict, device) -> Dict[str, Any]:
    """The rows by ``--only`` name, each a function of the results list."""
    return {
        "stage1_f32": lambda r: bench_stage1(r, "float32", args.iters, config, device),
        "stage1_bf16": lambda r: bench_stage1(r, "bfloat16", args.iters, config, device),
        "stage2_f32": lambda r: bench_stage2(r, "float32", args.iters, config, device),
        "stage2_bf16": lambda r: bench_stage2(r, "bfloat16", args.iters, config, device),
        "fine_tune": lambda r: bench_fine_tune(r, config=config, device=device),
        "serving": lambda r: bench_serving(r, config=config, device=device),
        "gen512": lambda r: bench_generator_512(r, config=config, device=device),
        "checkpointing": lambda r: bench_checkpointing(r, config=config, device=device),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default=None, help="comma list: " + ",".join(ROW_NAMES))
    parser.add_argument("--iters", type=int, default=10, help="timed train steps a train row")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="override the train-step batch (default 24, the reference value)")
    parser.add_argument("--r1_heads", default=None, choices=["all", "final"],
                        help="override R1 penalty head selection")
    parser.add_argument("--set", action="append", default=[],
                        help="config override key=value (value parsed as JSON, falling back to "
                        "string); repeatable")
    parser.add_argument("--device", default=None,
                        help="cuda (the default; fails without a card) or cpu")
    parser.add_argument("--out", default=str(DEFAULT_OUT), help="where the rows are written")
    args = parser.parse_args(argv)
    only = set(args.only.split(",")) if args.only else set(ROW_NAMES)
    if only - set(ROW_NAMES):
        parser.error(f"unknown rows {sorted(only - set(ROW_NAMES))}")
    if args.device is None and not torch.cuda.is_available():
        print("bench_train: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    turn_tf32_off()
    config = bench_config(args)

    results, failed = [], []
    for name, fn in rows(args, config, device).items():
        if name not in only:
            continue
        try:
            fn(results)
        except Exception as exc:  # report the row, run the others, fail at the end
            traceback.print_exc()
            failed.append(name)
            row = {"metric": name, "error": f"{type(exc).__name__}: {exc}"[:300]}
            results.append(row)
            print(json.dumps(row), flush=True)
        finally:
            release(device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    if failed:
        print(f"bench_train: rows failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
