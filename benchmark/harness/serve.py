"""The serving runner: ``ConfigNetServer.render_with_attribute`` under a
closed loop of one client, timed from the call to its uint8 array on the
host, then a seeded sample of the finished requests (the longest among them)
rendered again by the plain reference and compared byte for byte.
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
from benchmark.harness.core import Cell, Check, Context, Outcome
from benchmark.reference import model as ref

TRAFFIC_KEYS = {"photos_per_request", "value_rows", "rotations_share", "pose_ranges_deg",
                "photo_pool", "chunk", "check_sample", "trace_seconds", "checks"}
# rows the reference renders at a time
REFERENCE_BLOCK = 32


def input_widths(model_cfg: Dict) -> Dict[str, int]:
    return {name: dims[0] for name, dims in ref.facemodel_inputs(model_cfg)}


def make_inputs(cell: Cell, seed: int, device):
    """(the photo pool on the host, the reference's trees with the
    benchmark's weights, on ``device``)."""
    model_cfg = cell.config["model"]
    size = int(model_cfg["output_shape"][0])
    generator = torch.Generator(device=device).manual_seed(int(seed))
    pool = weights.random_u8((cell.traffic["photo_pool"], size, size, 3), generator, device)
    trees = weights.make_trees(cell.config, ref.SERVING_TREES, seed, device, pool[:8])
    return pool.cpu().numpy(), trees


@torch.no_grad()
def reference_render(trees, model_cfg: Dict, pool: np.ndarray, request, device) -> np.ndarray:
    """The reference's uint8 renders of ``request``, in blocks of rows."""
    out = []
    n = len(request.photos)
    for start in range(0, n, REFERENCE_BLOCK):
        rows = slice(start, start + REFERENCE_BLOCK)
        photos = torch.from_numpy(pool[request.rows][rows]).to(device)
        value = request.value if request.value.shape[0] == 1 else request.value[rows]
        rotations = None if request.rotations is None else torch.from_numpy(
            request.rotations[rows]).to(device)
        images = ref.render_with_attribute(trees, model_cfg, photos, request.attribute,
                                           torch.from_numpy(value).to(device), rotations)
        out.append(ref.to_uint8(images).cpu().numpy())
    return np.concatenate(out)


def compare(pairs, limits: Dict[str, float]) -> List[Check]:
    """Served against reference uint8 renders: the worst photo's mean
    absolute gap (uint8 steps), so one wrong render shows, and the share of
    all bytes more than one step off (%)."""
    worst = 0.0
    total = far = 0
    for served, want in pairs:
        if served.shape != want.shape:
            return [Check(name, float("inf"), limits[name]) for name in limits]
        gap = np.abs(served.astype(np.int16) - want.astype(np.int16))
        worst = max(worst, float(gap.reshape(len(gap), -1).mean(axis=1).max()))
        total += gap.size
        far += int((gap > 1).sum())
    readings = {"worst_photo_abs_u8": worst, "share_off_by_2_pct": 100.0 * far / max(total, 1)}
    return [Check(name, readings[name], limits[name]) for name in limits]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Outcome:
    t = cell.traffic
    model_cfg = dict(cell.config["model"], seed=int(seed) % 2 ** 31)
    pool, trees = make_inputs(cell, seed, device)
    widths = input_widths(model_cfg)

    from confignet_tpu_torch.serving import ConfigNetServer
    from confignet_tpu_torch.training.second_stage import ConfigNet

    np.random.seed(int(seed) % 2 ** 32)
    model = ConfigNet(model_cfg, device=device, initialize=False)
    for name in ref.SERVING_TREES:
        getattr(model, name).load_state_dict(trees[name].state_dict())
    for tree in trees.values():
        tree.to("cpu")
    server = ConfigNetServer(model, chunk=int(t["chunk"]), device=device)

    def call(request):
        return server.render_with_attribute(pool[request.rows], request.attribute,
                                            request.value, request.rotations)

    for _ in range(2):
        for request in traffic_gen.warm_requests(t, widths):
            call(request)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    from benchmark.harness.trace import Tracer
    tracer = Tracer() if trace else None
    requests = traffic_gen.serve_requests(t, widths, seed)
    sample = traffic_gen.Reservoir(int(t["check_sample"]), seed)
    latencies: List[float] = []
    photos = traced_photos = traced_chunks = 0
    chunk = int(t["chunk"])
    t0 = time.perf_counter()
    if tracer:
        tracer.start()
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        if tracer and tracer.active and now - t0 >= t["trace_seconds"]:
            slice_ = tracer.stop()
        request = next(requests)
        span = torch.profiler.record_function("bench.request") if tracer and tracer.active \
            else nullcontext()
        start = time.perf_counter()
        with span:
            out = call(request)
        latencies.append(time.perf_counter() - start)
        n = len(request.photos)
        photos += n
        if tracer and tracer.active:
            traced_photos += n
            traced_chunks += -(-n // chunk)
        sample.offer(request, out)
    elapsed = time.perf_counter() - t0
    if tracer and tracer.active:
        slice_ = tracer.stop()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    del server, model, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for tree in trees.values():
        tree.to(device)
    pairs = [(out, reference_render(trees, model_cfg, pool, request, device))
             for request, out in sample.sample()]
    checks = compare(pairs, t["checks"])

    context = Context("serve")
    if trace:
        context.slice = slice_
        per_photo = flops.serving_per_photo(model_cfg, sorted(widths)[0])
        context.flops_done = per_photo * traced_photos
        context.kernel_bound_s = traced_chunks * kernels.plan_bound_s(
            kernels.serving_chunk(chunk), model_cfg)
    metrics = {"render_img_s": photos / elapsed, "setup_s": setup_s}
    return Outcome(metrics, checks, attempted=len(latencies), failed=0,
                   memory_peak_bytes=memory_peak, context=context,
                   extra={"photos": photos, "checked_requests": len(pairs),
                          "checked_photos": sum(len(o) for o, _ in pairs)})


def control_readings(cell: Cell, seed: int, device) -> Dict:
    """The control: the reference in TF32 in the program's place, read
    against the reference in float32 on the requests a run would sample
    (the first ``check_sample`` of the stream and the longest of its first
    ten times as many).  Returns the checks' readings under ``tf32``."""
    t = cell.traffic
    model_cfg = dict(cell.config["model"], seed=int(seed) % 2 ** 31)
    pool, trees = make_inputs(cell, seed, device)
    stream = traffic_gen.serve_requests(t, input_widths(model_cfg), seed)
    first = [next(stream) for _ in range(10 * int(t["check_sample"]))]
    chosen = first[:int(t["check_sample"])]
    longest = max(first, key=lambda r: len(r.photos))
    if longest not in chosen:
        chosen.append(longest)
    pairs = []
    for request in chosen:
        want = reference_render(trees, model_cfg, pool, request, device)
        with tf32(True):
            got = reference_render(trees, model_cfg, pool, request, device)
        pairs.append((got, want))
    return {"tf32": {c.name: c.value for c in compare(pairs, t["checks"])}}


class tf32:
    """TF32 on (or off) for matrix products and convolutions while open."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
