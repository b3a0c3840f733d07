"""The training runner: the port's train step as the training loop calls it
(the built step through ``GraphCache.run_step``, fed by
``BatchPrefetcher`` from seeded data sets), timed over the window to a host
read of the last step's losses.

Set-up drives the same step object through its first steps (eager,
captured, replayed) on batches it records, and keeps the program's state
after each.  After the window the plain reference takes each of those
steps on the same batch and draws: the first from the benchmark's weights
and a fresh optimizer, each later one from the program's own state after
the step before it (its weights, EMA and Adam moments), so every step,
captured and replayed ones too, is judged from the state it started from.
Each step is compared by its loss sums and the norm by leaf of its change,
the first also by the norm by leaf of its gradient (read from Adam's first
moment).
"""
from __future__ import annotations

import gc
import statistics
import time
from collections import deque
from contextlib import nullcontext
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from benchmark.counts import flops, kernels
from benchmark.harness import weights
from benchmark.harness.core import Cell, Check, Context, Outcome, resolve
from benchmark.harness.traffic import poses
from benchmark.reference import model as ref

TRAFFIC_KEYS = {"program", "reference", "real_images", "synth_images", "eye_mask_share",
                "pose_ranges_deg", "prefetch_depth", "checked_steps", "trace_seconds", "checks"}
TRAIN_TREES = ref.TREES + ("perceptual_loss",)
# steps in flight on the device behind the host, as a loop that does not
# wait for each step keeps its queue full
MAX_LAG = 2


def make_datasets(traffic: Dict, model_cfg: Dict, generator: torch.Generator, device):
    """The real and synthetic training sets: uint8 noise images, sparse eye
    masks, Gaussian face-model inputs and poses from the pose ranges."""
    size = int(model_cfg["output_shape"][0])
    n_real, n_synth = int(traffic["real_images"]), int(traffic["synth_images"])
    real = weights.random_u8((n_real, size, size, 3), generator, device)
    synth = weights.random_u8((n_synth, size, size, 3), generator, device)
    masks = (torch.rand((n_synth, size, size), generator=generator, device=device)
             < traffic["eye_mask_share"]).to(torch.uint8)
    inputs = {name: torch.randn((n_synth, dims[0]), generator=generator, device=device)
              for name, dims in ref.facemodel_inputs(model_cfg)}
    seed = int(torch.randint(0, 2 ** 31, (1,), generator=generator, device=device).item())
    inputs = {k: v.cpu().numpy() for k, v in inputs.items()}
    inputs["rotations"] = poses(np.random.default_rng(seed), n_synth, traffic["pose_ranges_deg"])
    real_set = SimpleNamespace(imgs=real.cpu().numpy())
    synth_set = SimpleNamespace(imgs=synth.cpu().numpy(), eye_masks=masks.cpu().numpy(),
                                metadata_inputs=inputs)
    return real_set, synth_set, real[:8]


# -- state and readings ---------------------------------------------------------


def named_params(trees: Dict[str, torch.nn.Module], names) -> Dict[str, torch.Tensor]:
    return {f"{t}/{n}": p for t in names for n, p in trees[t].named_parameters()}


def snapshot(trees: Dict[str, torch.nn.Module], optimizers: Dict, player_params: Dict) -> Dict:
    """A state after a step, on the host: every tree's state dict, and each
    player's Adam count and moments by leaf (zeros where it made none)."""
    adam = {}
    for player, named in player_params.items():
        opt, t = optimizers[player], 0
        mu, nu = {}, {}
        for i, (leaf, p) in enumerate(named.items()):
            s = opt.state[i] if isinstance(opt.state, list) else opt.state.get(p, {})
            if "exp_avg" in s:
                mu[leaf] = s["exp_avg"].detach().to("cpu", copy=True)
                nu[leaf] = s["exp_avg_sq"].detach().to("cpu", copy=True)
                t = int(round(float(s["step"]))) if "step" in s else opt.t
            else:
                mu[leaf] = nu[leaf] = torch.zeros(p.shape)
        adam[player] = {"t": t, "mu": mu, "nu": nu}
    return {"trees": weights.state_dicts({k: trees[k] for k in ref.TREES}), "adam": adam}


def program_readings(losses: List[Dict], states: List[Dict], start: Dict, b1: float,
                     leaves: frozenset) -> Dict:
    """Per step: the loss sums, each leaf's gradient norm (from Adam's first
    moments before and after: g = (mu - b1 mu_before) / (1 - b1)) and each
    leaf's change norm, from the states after each step; ``start``: the
    weights before the first."""
    out = {"losses": losses, "grads": [], "changes": []}
    before = {"trees": start, "adam": None}
    for state in states:
        grads = {}
        for player, a in state["adam"].items():
            for leaf, mu in a["mu"].items():
                mu0 = 0.0 if before["adam"] is None else before["adam"][player]["mu"][leaf]
                grads[leaf] = float(((mu - b1 * mu0) / (1.0 - b1)).norm())
        out["grads"].append(grads)
        out["changes"].append(changes(state["trees"], before["trees"], leaves))
        before = state
    return out


def param_leaves(trees: Dict[str, torch.nn.Module]) -> frozenset:
    """The parameter leaves ``tree/name`` of the checkpoint's trees (a
    state dict also holds buffers, which no optimizer moves)."""
    return frozenset(named_params(trees, ref.TREES))


def changes(now: Dict, then: Dict, leaves: frozenset) -> Dict[str, float]:
    """Each parameter leaf's change norm between two sets of state dicts."""
    return {f"{tree}/{name}": float((v.float() - then[tree][name].float()).norm())
            for tree, sd in now.items() for name, v in sd.items() if f"{tree}/{name}" in leaves}


def readings(program: Dict, reference: Dict) -> Dict[str, float]:
    """``program`` and ``reference``: per step {"losses": {player: loss},
    "grads": {leaf: norm}, "changes": {leaf: norm}}.  Every gap is relative:
    a gap of values or norms, never the norm of a difference, against the
    reference's value or, for a leaf, the step's median leaf, whichever is
    larger.  Leaves whose reference gradient is under a thousandth of the
    step's median leaf (moved by Adam's round-off alone) are left out of the
    change; an EMA leaf goes with its generator leaf.

    Compared: ``loss_gap`` (the worst player's loss sum) and ``change_gap``
    (the worst leaf's change), each the worst over the steps, and
    ``grad_gap``, the worst leaf's gradient of the first step.  A later
    step's gradient is not compared: at random weights the first update
    blows the losses up to 1e12 and more, and the later gradients are then
    rounding in any float32 implementation, the reference's too (PERF.md).
    Beside them, per step: ``loss_gap.<n>``, ``grad_gap.<n>``,
    ``change_gap.<n>`` and the median leaf's ``median_change_gap.<n>``."""
    n = len(reference["losses"])
    if len(program["losses"]) != n or n == 0:
        return {"loss_gap": float("inf"), "grad_gap": float("inf"), "change_gap": float("inf")}
    out: Dict[str, float] = {}
    for i in range(n):
        p_loss, r_loss = program["losses"][i], reference["losses"][i]
        out[f"loss_gap.{i + 1}"] = max(abs(p_loss[k] - r_loss[k]) / max(abs(r_loss[k]), 1e-12)
                                       for k in r_loss)
        g_ref = reference["grads"][i]
        g_med = statistics.median(g_ref.values())
        out[f"grad_gap.{i + 1}"] = max(abs(program["grads"][i][k] - g_ref[k]) / max(g_ref[k], g_med)
                                       for k in g_ref)

        def moved(leaf: str) -> bool:
            return g_ref[leaf.replace("generator_smoothed/", "generator/", 1)] >= 1e-3 * g_med

        c_ref = {k: v for k, v in reference["changes"][i].items() if moved(k)}
        c_med = statistics.median(c_ref.values())
        gaps = [abs(program["changes"][i][k] - c_ref[k]) / max(c_ref[k], c_med) for k in c_ref]
        out[f"change_gap.{i + 1}"] = max(gaps)
        out[f"median_change_gap.{i + 1}"] = statistics.median(gaps)
    for name in ("loss_gap", "change_gap"):
        out[name] = max(out[f"{name}.{i + 1}"] for i in range(n))
    out["grad_gap"] = out["grad_gap.1"]
    return out


def compare(program: Dict, reference: Dict, limits: Dict[str, float]) -> List[Check]:
    """The checks of :func:`readings` that ``limits`` names."""
    values = readings(program, reference)
    return [Check(name, float(values[name]), limits[name]) for name in limits]


def follow(trainer_cls, trees, model_cfg: Dict, batches: List[Dict], states: List[Dict],
           device) -> Dict:
    """The reference's readings of each step: the first from ``trees`` as
    they are (the benchmark's weights) with a fresh optimizer, step k from
    ``states[k - 2]``, the program's state after the step before."""
    start = weights.state_dicts({k: trees[k] for k in ref.TREES})
    leaves = param_leaves(trees)
    trainer = trainer_cls(trees, model_cfg, model_cfg["seed"], device)
    players = {player: named_params(trees, names) for player, names in ref.PLAYER_TREES.items()}
    out = {"losses": [], "grads": [], "changes": []}
    for i, host in enumerate(batches):
        if i > 0:
            load(trainer, trees, players, states[i - 1], device)
        before = start if i == 0 else states[i - 1]["trees"]
        losses = trainer.step(ref.as_device_batch(host, device))
        out["losses"].append({k: float(v) for k, v in losses.items()})
        out["grads"].append({leaf: float(g.float().norm()) for player, named in players.items()
                             for leaf, g in zip(named, trainer.last_grads[player])})
        now = weights.state_dicts({k: trees[k] for k in ref.TREES})
        out["changes"].append(changes(now, before, leaves))
    return out


@torch.no_grad()
def load(trainer, trees, players: Dict, state: Dict, device) -> None:
    """Put a state of :func:`snapshot` into the reference's trees and Adams."""
    for name, sd in state["trees"].items():
        trees[name].load_state_dict(sd)
    for player, named in players.items():
        a = state["adam"][player]
        opt = trainer.optimizers[player]
        opt.t = a["t"]
        opt.state = [{"exp_avg": a["mu"][leaf].to(device).clone(),
                      "exp_avg_sq": a["nu"][leaf].to(device).clone()} for leaf in named]


# -- the run -------------------------------------------------------------------------


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Outcome:
    t = cell.traffic
    model_cfg = dict(cell.config["model"], seed=int(seed) % 2 ** 31,
                     prefetch_depth=int(t["prefetch_depth"]))
    batch_size = int(model_cfg["batch_size"])
    b1 = float(model_cfg["optimizer"]["beta_1"])
    generator = torch.Generator(device=device).manual_seed(int(seed))
    real_set, synth_set, head_photos = make_datasets(t, model_cfg, generator, device)
    trees = weights.make_trees(cell.config, TRAIN_TREES, seed, device, head_photos)
    leaves = param_leaves(trees)
    for tree in trees.values():
        tree.to("cpu")
    start = weights.state_dicts({k: trees[k] for k in ref.TREES})

    from confignet_tpu_torch.data.prefetch import BatchPrefetcher

    np.random.seed(int(seed) % 2 ** 32)
    model = resolve(t["program"])(model_cfg, device=device, initialize=False)
    for name in TRAIN_TREES:
        getattr(model, name).load_state_dict(trees[name].state_dict())
    step = model._build_train_step()
    recorded: List[Dict] = []
    checked = int(t["checked_steps"])

    def sample():
        batch = model._sample_host_batch(real_set, synth_set)
        if len(recorded) < checked:
            recorded.append(batch)
        return batch

    port_trees = {name: getattr(model, name) for name in ref.TREES}
    player_params = {player: named_params(port_trees, names)
                     for player, names in ref.PLAYER_TREES.items()}
    prefetcher = BatchPrefetcher(sample, depth=int(t["prefetch_depth"]), device=device)
    try:
        losses_seen, states = [], []
        for _ in range(checked):
            losses = step(prefetcher.next())
            losses_seen.append({k: float(v["loss_sum"]) for k, v in losses.items()})
            states.append(snapshot(port_trees, model.optimizers, player_params))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start

        from benchmark.harness.trace import Tracer
        tracer = Tracer() if trace else None
        in_flight: deque = deque()
        waits: List[float] = []
        steps = traced_steps = 0
        t0 = time.perf_counter()
        if tracer:
            tracer.start()
        while time.perf_counter() - t0 < seconds:
            if tracer and tracer.active and time.perf_counter() - t0 >= t["trace_seconds"]:
                slice_ = tracer.stop()
            traced = bool(tracer and tracer.active)
            w0 = time.perf_counter()
            with torch.profiler.record_function("bench.data_wait") if traced else nullcontext():
                batch = prefetcher.next()
            if traced:
                waits.append(time.perf_counter() - w0)
            with torch.profiler.record_function("bench.step") if traced else nullcontext():
                losses = step(batch)
            done = torch.cuda.Event() if device.type == "cuda" else None
            if done is not None:
                done.record()
                in_flight.append(done)
                if len(in_flight) > MAX_LAG:
                    in_flight.popleft().synchronize()
            steps += 1
            traced_steps += traced
        last_loss = float(losses["g"]["loss_sum"])
        elapsed = time.perf_counter() - t0
        if tracer and tracer.active:
            slice_ = tracer.stop()
    finally:
        prefetcher.close()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    del step, model, port_trees, player_params, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    program = program_readings(losses_seen, states, start, b1, leaves)
    for tree in trees.values():
        tree.to(device)
    reference = follow(resolve(t["reference"]), trees, model_cfg, recorded, states, device)
    read = readings(program, reference)
    checks = [Check(name, float(read[name]), limit) for name, limit in t["checks"].items()]
    checks.append(Check("window_loss_finite", 0.0 if np.isfinite(last_loss) else 1.0, 0.0))

    context = Context("train", data_waits_s=waits)
    if trace:
        context.slice = slice_
        context.flops_done = traced_steps * flops.stage2_step(model_cfg)
        context.kernel_bound_s = traced_steps * kernels.plan_bound_s(
            kernels.stage2_step(batch_size), model_cfg)
    metrics = {"train_img_s": steps * batch_size / elapsed, "setup_s": setup_s}
    return Outcome(metrics, checks, attempted=steps, failed=0, memory_peak_bytes=memory_peak,
                   context=context, extra={"steps": steps, "checked_steps": len(recorded),
                                           "readings": read})


# -- the control --------------------------------------------------------------------


def host_batch(rng: np.random.Generator, real_set, synth_set, model_cfg: Dict) -> Dict:
    """A stage-2 host batch in the port's layout, its rows drawn by ``rng``
    (for the control, which runs no program)."""
    n = int(model_cfg["batch_size"])
    half = n // 2
    names = [name for name, _ in ref.facemodel_inputs(model_cfg)]
    n_real, n_synth = len(real_set.imgs), len(synth_set.imgs)

    def facemodel(idx):
        return tuple(np.ascontiguousarray(synth_set.metadata_inputs[k][idx]) for k in names)

    sd, ld, g = (rng.integers(0, n_synth, m) for m in (n, n, half))
    return {"d_real_imgs": real_set.imgs[rng.integers(0, n_real, n)],
            "d_input_imgs": real_set.imgs[rng.integers(0, n_real, n)],
            "synth_d_real_imgs": synth_set.imgs[rng.integers(0, n_synth, n)],
            "synth_d_facemodel": facemodel(sd),
            "synth_d_rotations": synth_set.metadata_inputs["rotations"][sd],
            "latent_d_real_imgs": real_set.imgs[rng.integers(0, n_real, n)],
            "latent_d_facemodel": facemodel(ld),
            "g_facemodel": facemodel(g), "g_rotations": synth_set.metadata_inputs["rotations"][g],
            "g_gt_imgs": synth_set.imgs[g], "g_eye_masks": synth_set.eye_masks[g],
            "g_real_imgs": real_set.imgs[rng.integers(0, n_real, n - half)]}


def half_batch(batch: Dict) -> Dict:
    """The batch with the second half of every field's rows left out."""
    def cut(v):
        if isinstance(v, (tuple, list)):
            return type(v)(cut(x) for x in v)
        return v[:max(1, len(v) // 2)]
    return {k: cut(v) for k, v in batch.items()}


def control_readings(cell: Cell, seed: int, device) -> Dict:
    """The control and the half-batch fault, each in the program's place
    over the cell's checked steps from the benchmark's weights and data,
    judged as a run is judged (:func:`follow` from its own states): the
    reference with TF32 on, and the reference on half of every batch."""
    from benchmark.harness.serve import tf32

    t = cell.traffic
    model_cfg = dict(cell.config["model"], seed=int(seed) % 2 ** 31)
    b1 = float(model_cfg["optimizer"]["beta_1"])
    trainer_cls = resolve(t["reference"])
    generator = torch.Generator(device=device).manual_seed(int(seed))
    real_set, synth_set, head_photos = make_datasets(t, model_cfg, generator, device)
    trees = weights.make_trees(cell.config, TRAIN_TREES, seed, device, head_photos)
    leaves = param_leaves(trees)
    initial = weights.state_dicts(trees)
    start = weights.state_dicts({k: trees[k] for k in ref.TREES})
    rng = np.random.default_rng([seed, 3])
    batches = [host_batch(rng, real_set, synth_set, model_cfg) for _ in range(int(t["checked_steps"]))]
    players = {player: named_params(trees, names) for player, names in ref.PLAYER_TREES.items()}

    def reset():
        for name, state in initial.items():
            trees[name].load_state_dict(state)

    out = {}
    for label, tf32_on, cut in (("tf32", True, False), ("half_batch", False, True)):
        reset()
        trainer = trainer_cls(trees, model_cfg, model_cfg["seed"], device)
        losses, states = [], []
        with tf32(tf32_on):
            for host in batches:
                got = trainer.step(ref.as_device_batch(half_batch(host) if cut else host, device))
                losses.append({k: float(v) for k, v in got.items()})
                states.append(snapshot(trees, trainer.optimizers, players))
        program = program_readings(losses, states, start, b1, leaves)
        reset()
        out[label] = readings(program, follow(trainer_cls, trees, model_cfg, batches, states, device))
    return out
