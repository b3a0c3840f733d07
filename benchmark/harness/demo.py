"""The interactive runner: the demo's render loop
(``apps/confignet_demo.run_loop``) on the port's model, one frame after the
other as the demo renders them, timed per frame.

A session encodes its grid's photos once (``encode_images``); every frame
glides the latent (the demo's ``LatentInterpolator``), splices the gaze in
(``set_facemodel_param_in_latents``), renders (``generate_images``), and
then acts on the frame's key, as the demo's loop does.  After the window a
seeded sample of the finished sessions (a largest one among them) is
replayed by the plain reference (``reference/demo.py``) and the checked
frames are compared byte for byte.
"""
from __future__ import annotations

import gc
import time
from contextlib import nullcontext
from typing import Dict, List

import numpy as np
import torch

from benchmark.counts import flops, kernels
from benchmark.harness import traffic as traffic_gen
from benchmark.harness import weights
from benchmark.harness.core import Cell, Context, Outcome
from benchmark.harness.serve import compare, tf32
from benchmark.reference import demo as ref_demo
from benchmark.reference import model as ref

TRAFFIC_KEYS = {"photos_per_session", "frames_per_session", "key_every", "key_block",
                "glide_frames", "pose_step_rad", "photo_pool", "check_sessions",
                "check_frames", "trace_seconds", "checks"}


def attributes(model_cfg: Dict) -> Dict[str, int]:
    widths = dict(ref.facemodel_inputs(model_cfg))
    return {name: widths[name][0] for name in ref_demo.demo_attributes(model_cfg)}


class Player:
    """Plays sessions on the port's model as the demo's loop does."""

    def __init__(self, model, model_cfg: Dict, pool: np.ndarray, traffic: Dict):
        from confignet_tpu_torch.apps.basic_ui import LatentInterpolator

        self.model, self.pool, self.traffic = model, pool, traffic
        self.interpolator = LatentInterpolator
        # the configuration file's order, which the reference cycles through too
        self.names = ref_demo.demo_attributes(model_cfg)
        self.gaze_on = ref_demo.EYE in model_cfg["facemodel_inputs"]
        self.step = float(traffic["pose_step_rad"])

    def start(self, session) -> None:
        self.session = session
        latents, self.rotations = self.model.encode_images(self.pool[session.photos])
        self.glide = self.interpolator(int(self.traffic["glide_frames"]))
        self.glide.retarget(latents)
        self.pose, self.gaze, self.attribute = np.zeros((1, 3)), np.zeros((1, 3)), 0

    def frame(self, index: int) -> np.ndarray:
        """One turn of the loop: render the frame, then act on its key."""
        model = self.model
        shown = self.glide.value()
        if self.gaze_on:
            shown = model.set_facemodel_param_in_latents(shown, ref_demo.EYE, self.gaze)
        images = model.generate_images(shown, self.rotations + self.pose)
        self.glide.advance()
        kind, arg = self.session.events.get(index, (None, None))
        if kind == "edit":
            self.glide.retarget(model.set_facemodel_param_in_latents(
                self.glide.value(), self.names[self.attribute], arg))
        elif kind in ("pose", "gaze"):
            (self.pose if kind == "pose" else self.gaze)[0, arg[0]] += arg[1] * self.step
        elif kind == "cycle":
            self.attribute = (self.attribute + arg) % len(self.names)
        return images


def warm_sessions(traffic: Dict, widths: Dict[str, int]) -> List:
    """A session of every grid size whose keys edit every attribute once and
    take every kind of key, so every call shape is built before the window."""
    sizes = sorted(set(traffic_gen.size_block(traffic["photos_per_session"])))
    first = int(traffic["key_every"]) - 1
    events = {}
    for i, name in enumerate(widths):
        frame = first + 4 * i
        events[frame] = ("edit", np.zeros((1, widths[name]), np.float32))
        events[frame + 1] = ("pose", (0, 1.0))
        events[frame + 2] = ("gaze", (1, -1.0))
        events[frame + 3] = ("cycle", 1)
    frames = first + 4 * len(widths) + 1
    return [traffic_gen.Session(-1 - i, np.arange(n), frames, events, [])
            for i, n in enumerate(sizes)]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Outcome:
    t = cell.traffic
    model_cfg = dict(cell.config["model"], seed=int(seed) % 2 ** 31)
    size = int(model_cfg["output_shape"][0])
    generator = torch.Generator(device=device).manual_seed(int(seed))
    pool_dev = weights.random_u8((t["photo_pool"], size, size, 3), generator, device)
    trees = weights.make_trees(cell.config, ref.SERVING_TREES, seed, device, pool_dev[:8])
    pool = pool_dev.cpu().numpy()
    del pool_dev
    widths = attributes(model_cfg)

    from confignet_tpu_torch.training.second_stage import ConfigNet

    np.random.seed(int(seed) % 2 ** 32)
    model = ConfigNet(model_cfg, device=device, initialize=False)
    for name in ref.SERVING_TREES:
        getattr(model, name).load_state_dict(trees[name].state_dict())
    for tree in trees.values():
        tree.to("cpu")
    player = Player(model, model_cfg, pool, t)

    for _ in range(2):
        for session in warm_sessions(t, widths):
            player.start(session)
            for index in range(session.frames):
                player.frame(index)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    from benchmark.harness.trace import Tracer
    tracer = Tracer() if trace else None
    sessions = traffic_gen.demo_sessions(t, widths, seed, int(t["check_frames"]))
    sample = traffic_gen.Reservoir(int(t["check_sessions"]), seed)
    latencies: List[float] = []
    images = traced_rows = traced_photos = 0
    gen_bound: Dict[int, float] = {}
    traced_bound = 0.0
    session, index, kept = None, 0, {}
    t0 = time.perf_counter()
    if tracer:
        tracer.start()
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        if tracer and tracer.active and now - t0 >= t["trace_seconds"]:
            slice_ = tracer.stop()
        traced = bool(tracer and tracer.active)
        span = torch.profiler.record_function("bench.request") if traced else nullcontext()
        start = time.perf_counter()
        with span:
            if session is None:
                session, index, kept = next(sessions), 0, {}
                player.start(session)
                traced_photos += len(session) * traced
            out = player.frame(index)
        latencies.append(time.perf_counter() - start)
        n = len(session)
        images += n
        if index in session.checked:
            kept[index] = out
        if traced:
            traced_rows += n
            if n not in gen_bound:
                gen_bound[n] = kernels.plan_bound_s(kernels.generator_forward(n, False), model_cfg)
            traced_bound += gen_bound[n]
        index += 1
        if index == session.frames:
            sample.offer(session, kept)
            session = None
    elapsed = time.perf_counter() - t0
    if tracer and tracer.active:
        slice_ = tracer.stop()
    if session is not None and index > 0:
        session.frames = index  # the frames it finished
        sample.offer(session, {k: v for k, v in kept.items() if k < index})
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    del player, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for tree in trees.values():
        tree.to(device)
    pairs = reference_pairs(trees, model_cfg, pool, t, sample.sample(), device)
    checks = compare(pairs, t["checks"])

    context = Context("demo")
    if trace:
        context.slice = slice_
        context.flops_done = (traced_rows * flops.generate_per_row(model_cfg)
                              + traced_photos * flops.encode_per_photo(model_cfg))
        context.kernel_bound_s = traced_bound
    metrics = {"demo_img_s": images / elapsed,
               "frame_p95_ms": 1e3 * float(np.percentile(latencies, 95)), "setup_s": setup_s}
    return Outcome(metrics, checks, attempted=len(latencies), failed=0,
                   memory_peak_bytes=memory_peak, context=context,
                   extra={"frames": len(latencies), "images": images,
                          "checked_frames": len(pairs)})


def reference_pairs(trees, model_cfg: Dict, pool: np.ndarray, t: Dict, kept, device) -> List:
    """(served, reference) uint8 renders of every kept frame."""
    pairs = []
    for session, outputs in kept:
        if not outputs:
            continue
        photos = torch.from_numpy(pool[session.photos]).to(device)
        want = ref_demo.render_session(trees, model_cfg, photos, session, int(t["glide_frames"]),
                                       float(t["pose_step_rad"]), outputs)
        pairs += [(outputs[f], want[f]) for f in sorted(outputs)]
    return pairs


def control_readings(cell: Cell, seed: int, device) -> Dict:
    """The control: the reference in TF32 in the program's place, read
    against the reference in float32 on the checked frames of the first
    ``check_sessions`` sessions and a largest one.  Returns the checks'
    readings under ``tf32``."""
    t = cell.traffic
    model_cfg = dict(cell.config["model"], seed=int(seed) % 2 ** 31)
    size = int(model_cfg["output_shape"][0])
    generator = torch.Generator(device=device).manual_seed(int(seed))
    pool_dev = weights.random_u8((t["photo_pool"], size, size, 3), generator, device)
    trees = weights.make_trees(cell.config, ref.SERVING_TREES, seed, device, pool_dev[:8])
    pool = pool_dev.cpu().numpy()
    stream = traffic_gen.demo_sessions(t, attributes(model_cfg), seed, int(t["check_frames"]))
    first = [next(stream) for _ in range(4 * int(t["check_sessions"]))]
    chosen = first[:int(t["check_sessions"])]
    largest = max(first, key=len)
    if largest not in chosen:
        chosen.append(largest)
    pairs = []
    for session in chosen:
        photos = torch.from_numpy(pool[session.photos]).to(device)
        args = (trees, model_cfg, photos, session, int(t["glide_frames"]),
                float(t["pose_step_rad"]), session.checked)
        want = ref_demo.render_session(*args)
        with tf32(True):
            got = ref_demo.render_session(*args)
        pairs += [(got[f], want[f]) for f in session.checked]
    return {"tf32": {c.name: c.value for c in compare(pairs, t["checks"])}}
