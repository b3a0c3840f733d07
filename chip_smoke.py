#!/usr/bin/env python3
"""Drive the PyTorch port (confignet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--profile profile.txt]
    python3 chip_smoke.py --rotate-sweep sweep.json   (rotation tiles only)

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; turns TF32 off.
2. Builds the CUDA kernels from the sources in this checkout, one nvcc per
   source, all at once.
3. Holds each kernel against its plain PyTorch version at the serving
   path's shapes, in float32 and bfloat16, and times the kernel, the plain
   version and one PyTorch library call that computes the same function,
   beside the least time the card could take (bytes over 3.35 TB/s or
   float32 operations over 67 TFLOP/s, whichever is larger).  Each time is
   taken twice: ``ms`` over back-to-back launches (which the host may pace)
   and ``device_ms`` by replaying a CUDA graph of 10 launches (the library
   call too, as ``library_device_ms``).  AdaIN runs on the route
   adain_route picks (printed per site) and, for comparison, on the
   two-pass route; the rotation on the slab route rotate_plan picks
   (printed with its plan) and on route v1, the first kernel; each pair
   timed in turns.
4. Serves requests at full width (256px, bf16, 145-dim latents, weights
   from seed 0) through ConfigNetServer(chunk=32): encode 40 photos,
   re-render them with a spliced attribute, generate 256 latents.  The
   launch counters are zeroed just before and read just after, and must
   show one rotation and six AdaIN launches per generator chunk.
5. Runs the same float32 server with the kernels and with their plain
   versions on 8 photos; the renders must agree to a mean abs uint8
   difference below 1.0.
6. Holds the rotation's transpose kernel (the backward of the resample) against
   its plain version at B=12, 24 (the train step's), 32 and 256 (float32
   atol 2e-4, bf16 3e-2 relative) on the owner-computes route, whose two
   launches must agree bit for bit, and on route v1, timed in turns beside
   the input gradient of F.grid_sample.  Holds the AdaIN backward kernel
   against its plain version (torch ops) at the six 256px sites, B=12 and
   24, float32 and bf16, on its own route and the two-pass route; two
   launches must agree bit for bit; times it beside the autograd backward
   of F.group_norm + affine.
7. Trains the stage-1 model at full width (256px, batch 24, 5 discriminator
   layers, VGG19 taps (1, 2, 8, 13), 145-dim latents, weights from seed 0) on a
   fake dataset of 64 images: float32, one warm-up and 3 timed steps, each with
   exactly 4 rotation-forward, 2 transpose, 24 AdaIN-forward and 12
   AdaIN-backward launches, finite losses,
   a nonzero gradient for every generator-player parameter and a moving EMA;
   then bfloat16, the same.  Then one float32 step of a kernel-path model and
   of a plain-path model (gather rotation, plain AdaIN) on the same weights,
   batch and draws: losses within rtol 1e-3, each player's gradient within a
   relative L2 distance of 1e-3, or, where the step's own sensitivity to
   rounding exceeds that, within 4x the distance of a one-site rounding probe
   (see compare_train_paths).
8. Prints the kernels' JSON record (launches and times on the float32 train
   step's path), then as the last line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
It also exits non-zero without a CUDA device, and outside a checkout (the
package import fails).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from confignet_tpu_torch.core.transforms import _source_coords, euler_angles_to_matrix, rotate_3d_grid
from confignet_tpu_torch.models import generator as generator_module
from confignet_tpu_torch.models.backbones.resnet import resnet50_preprocess
from confignet_tpu_torch.ops import cuda_build
from confignet_tpu_torch.ops.adain_cuda import (
    adain_route, adain_two_pass_plan, device_limits, fused_adain_backward, fused_adain_backward_plain,
    fused_adain_forward, fused_adain_plain_with_stats, launch_backward, launch_forward)
from confignet_tpu_torch.ops.rotate_cuda import (
    device_limits as rotate_device_limits, forward_shared_bytes, launch_rotate_forward,
    launch_rotate_transpose, rotate_3d_grid_forward, rotate_3d_grid_plain, rotate_3d_grid_transpose,
    rotate_3d_grid_transpose_plain, rotate_plan, rotate_v1_plan, transpose_shared_bytes)
from confignet_tpu_torch.serving import ConfigNetServer
from confignet_tpu_torch.training.first_stage import PLAYER_TREES, ConfigNetFirstStage
from confignet_tpu_torch.training.second_stage import ConfigNet

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
ROTATE_FLOPS_PER_ELEMENT = 21  # 7 lerps of 3 operations
TRANSPOSE_FLOPS_PER_ELEMENT = 25  # 3 (1 - d), 14 weight products, 8 accumulating adds
ADAIN_FLOPS_PER_ELEMENT = 7  # mean 1, centred variance 3, normalise+modulate 3
ADAIN_SITES_256 = ((512, 256), (4096, 128), (256, 256), (1024, 64), (4096, 32), (16384, 32))
ADAIN_SITE_512 = (65536, 16)
SERVE_CHUNK = 32
TRAIN_BATCH = 24  # the D updates' generator batch; the G step renders two halves of 12
TRAIN_STEPS = 3
# bench_train.py's reference-scale stage-1 config (the reference's defaults at
# 256px, 5 discriminator layers, the 145-dim latent layout), copied here
TRAIN_CONFIG = {
    "output_shape": (256, 256, 3),
    "n_discr_layers": 5,
    "batch_size": TRAIN_BATCH,
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
    "seed": 0,
}
# float32: absolute (the JAX kernels' contracts, tests/test_pallas_interpret.py);
# bfloat16: 3e-2 of max(1, |value|) -- kernel and plain version each round
# once to bf16, and one bf16 ulp is 2^-7 relative (0.03125 in [4, 8)).
# The transpose's float32 bound is the JAX transpose kernel's contract (2e-4).
TOL = {"float32": {"rotate": 2e-5, "adain": 1e-4, "transpose": 2e-4},
       "bfloat16": {"rotate": 3e-2, "adain": 3e-2, "transpose": 3e-2}}


def compare(got, want):
    """(max abs error, the error the tolerance applies to)."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == want.dtype and got.dtype.is_floating_point and got.element_size() == 2:
        return diff.max().item(), (diff / want.float().abs().clamp(min=1.0)).max().item()
    return diff.max().item(), diff.max().item()


def card_line() -> str:
    result = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60, check=True)
    return result.stdout.strip().splitlines()[0]


def time_ms(fn, budget_ms: float = 60.0, max_iters: int = 50) -> float:
    """Mean device time of fn() over a run of launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = int(max(1, min(max_iters, budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, reps: int = 10, replays: int = 5, stream=None) -> float:
    """Device time of one fn() without the host's launch pacing: ``reps``
    calls captured in one CUDA graph (on ``stream``, where given), the graph
    replayed back to back and timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def in_turns(first, second) -> tuple:
    """device_ms of two versions of one function measured in turns (first,
    second, second, first); each the mean of its two readings."""
    a1, b1, b2, a2 = device_ms(first), device_ms(second), device_ms(second), device_ms(first)
    return (a1 + a2) / 2, (b1 + b2) / 2


def bound(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def poses(batch: int, rng):
    """The reference pose distribution (yaw +-30deg, pitch +-10deg, roll 0),
    plus a zero row and a yaw-90deg row."""
    rot = rng.uniform(-1, 1, size=(batch, 3)) * np.array([np.pi / 6, np.pi / 18, 0.0])
    rot[0] = 0.0
    rot[-1] = [np.pi / 2, 0.0, 0.0]
    return rot.astype(np.float32)


def rotation_inputs(batch: int, dtype, seed: int):
    """A random (B, 16, 16, 16, 128) volume and the reference poses."""
    size, channels = 16, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    volume = torch.randn((batch, size, size, size, channels), generator=gen, device="cuda").to(dtype)
    transform = euler_angles_to_matrix(
        torch.from_numpy(poses(batch, np.random.default_rng(batch)))).cuda()
    return volume, transform


def grid_sample_grid(volume, transform):
    """grid_sample's sampling grid for the resample: 5-D trilinear,
    align_corners, border padding, the volume's (x, y, z) axes as
    grid_sample's (D, H, W)."""
    batch, size = volume.shape[0], volume.shape[1]
    floor, _, frac = _source_coords(volume, transform)
    src = (floor.float() + frac) / (size - 1) * 2 - 1  # (B, 3, P), clamped
    return src.flip(1).transpose(1, 2).reshape(batch, size, size, size, 3).to(volume.dtype)


def rotate_plans(volume, transpose: bool = False):
    batch, size, channels = volume.shape[0], volume.shape[1], volume.shape[4]
    plan = rotate_plan(batch, size, channels, volume.dtype,
                       *rotate_device_limits(volume.device.index), transpose=transpose)
    return plan, rotate_v1_plan(batch, size, channels)


def rotate_phase(batch: int, dtype, records: list):
    """The forward kernel on the route rotate_plan picks and on route v1,
    each against the plain version, timed beside the plain version and
    F.grid_sample: ``ms`` by back-to-back launches, ``device_ms`` by
    CUDA-graph replay (the two routes in turns)."""
    grid, transform = rotation_inputs(batch, dtype, batch)
    plan, v1 = rotate_plans(grid)
    got = rotate_3d_grid_forward(grid, transform)
    got_v1 = launch_rotate_forward(grid, transform, v1)
    want = rotate_3d_grid_plain(grid, transform)
    torch.cuda.synchronize()
    err, checked = compare(got, want)
    _, checked_v1 = compare(got_v1, want)

    sample_grid = grid_sample_grid(grid, transform)
    volume = grid.permute(0, 4, 1, 2, 3)

    def library():
        return F.grid_sample(volume, sample_grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    def kernel():
        return rotate_3d_grid_forward(grid, transform)

    def old_route():
        return launch_rotate_forward(grid, transform, v1)

    lib_err = (library().permute(0, 2, 3, 4, 1).float() - want.float()).abs().max().item()
    elem = grid.element_size()
    n_bytes = 2 * grid.numel() * elem + transform.numel() * 4
    bound_ms, bound_by = bound(n_bytes, ROTATE_FLOPS_PER_ELEMENT * grid.numel())
    kernel_device, v1_device = in_turns(kernel, old_route)
    rec = dict(kernel="rotate_cuda", batch=batch, dtype=str(dtype).replace("torch.", ""),
               shape=list(grid.shape), route=plan.route, plan=plan._asdict(), max_abs_err=err,
               checked_err=checked, v1_checked_err=checked_v1, library_max_abs_err=lib_err,
               ms=time_ms(kernel), device_ms=kernel_device,
               v1_ms=time_ms(old_route), v1_device_ms=v1_device,
               plain_ms=time_ms(lambda: rotate_3d_grid_plain(grid, transform)),
               library_ms=time_ms(library), library_device_ms=device_ms(library),
               bound_ms=bound_ms, bound_by=bound_by)
    records.append(rec)
    print("phase " + json.dumps(rec), flush=True)
    tol = TOL[rec["dtype"]]["rotate"]
    if not (checked <= tol and checked_v1 <= tol):
        raise AssertionError(f"rotate kernel disagrees with its plain version: {rec}")


def site(positions: int, channels: int) -> str:
    return f"{positions}x{channels}"


def adain_phase(batch: int, positions: int, channels: int, dtype, records: list):
    """The forward kernel on the route adain_route picks and on the two-pass
    route, each against the plain version, timed beside the plain version
    and F.group_norm + affine: ``ms`` by back-to-back launches, ``device_ms``
    by CUDA-graph replay (kernel and two-pass route in turns)."""
    gen = torch.Generator(device="cuda").manual_seed(positions * channels + batch)
    x = (torch.randn((batch, positions, channels), generator=gen, device="cuda") * 3 + 1).to(dtype)
    scale = torch.randn((batch, channels), generator=gen, device="cuda").to(dtype)
    bias = torch.randn((batch, channels), generator=gen, device="cuda").to(dtype)
    smem, sms = device_limits(x.device.index)
    plan = adain_route(batch, positions, channels, dtype, smem, sms)
    two_pass = adain_two_pass_plan(batch, positions, channels, dtype, sms)
    got, stats = fused_adain_forward(x, scale, bias)
    got_two, stats_two = launch_forward(x, scale, bias, 1e-3, two_pass)
    want, want_stats = fused_adain_plain_with_stats(x, scale, bias)
    torch.cuda.synchronize()
    err, checked = compare(got, want)
    _, checked_two = compare(got_two, want)
    stats_err = max(compare(s, want_stats)[0] for s in (stats, stats_two))

    x_cf = x.transpose(1, 2).contiguous()  # group_norm's channels-first layout
    gain, shift = (scale + 1)[:, :, None], bias[:, :, None]

    def library():
        return F.group_norm(x_cf, channels, eps=1e-3) * gain + shift

    def kernel():
        return fused_adain_forward(x, scale, bias)

    def old_route():
        return launch_forward(x, scale, bias, 1e-3, two_pass)

    elem = x.element_size()
    n_bytes = 2 * x.numel() * elem + 2 * scale.numel() * elem
    bound_ms, bound_by = bound(n_bytes, ADAIN_FLOPS_PER_ELEMENT * x.numel())
    kernel_device, two_pass_device = in_turns(kernel, old_route)
    rec = dict(kernel="adain_cuda", batch=batch, dtype=str(dtype).replace("torch.", ""),
               shape=list(x.shape), site=site(positions, channels), route=plan.route,
               plan=plan._asdict(), max_abs_err=err, checked_err=checked,
               two_pass_checked_err=checked_two, stats_max_abs_err=stats_err,
               ms=time_ms(kernel), device_ms=kernel_device,
               two_pass_ms=time_ms(old_route), two_pass_device_ms=two_pass_device,
               plain_ms=time_ms(lambda: fused_adain_plain_with_stats(x, scale, bias)),
               plain_device_ms=device_ms(lambda: fused_adain_plain_with_stats(x, scale, bias)),
               library_ms=time_ms(library), library_device_ms=device_ms(library),
               bound_ms=bound_ms, bound_by=bound_by)
    records.append(rec)
    print("phase " + json.dumps(rec), flush=True)
    tol = TOL[rec["dtype"]]["adain"]
    if not (checked <= tol and checked_two <= tol and stats_err <= 1e-4 * max(
            1.0, want_stats.abs().max().item())):
        raise AssertionError(f"AdaIN kernel disagrees with its plain version: {rec}")


def transpose_phase(batch: int, dtype, records: list):
    """The transpose kernel (gradient of the resample w.r.t. the grid) on the
    route rotate_plan picks, launched twice (the two must be equal bit for
    bit: fixed-order sums), and on route v1 (float atomics), each against
    the plain version; timed beside the plain version and the input gradient
    of F.grid_sample (the two routes' device times in turns)."""
    ct, transform = rotation_inputs(batch, dtype, 1000 + batch)
    plan, v1 = rotate_plans(ct, transpose=True)
    got = rotate_3d_grid_transpose(ct, transform)
    again = rotate_3d_grid_transpose(ct, transform)
    got_v1 = launch_rotate_transpose(ct, transform, v1)
    want = rotate_3d_grid_transpose_plain(ct, transform)
    torch.cuda.synchronize()
    err, checked = compare(got, want)
    _, checked_v1 = compare(got_v1, want)
    repeat_equal = torch.equal(got, again)

    # library yardstick: the input gradient of the forward phase's 5-D
    # grid_sample, only the volume requiring grad (backward timed alone).
    # The forward runs on a side stream: autograd runs the backward on the
    # forward's stream, which the graph capture must then use too.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sample_grid = grid_sample_grid(ct, transform)
        volume = torch.zeros_like(ct).permute(0, 4, 1, 2, 3).requires_grad_(True)
        out = F.grid_sample(volume, sample_grid, mode="bilinear", padding_mode="border",
                            align_corners=True)
        ct_cf = ct.permute(0, 4, 1, 2, 3)
    torch.cuda.current_stream().wait_stream(side)

    def library():
        return torch.autograd.grad(out, volume, ct_cf, retain_graph=True)[0]

    def kernel():
        return rotate_3d_grid_transpose(ct, transform)

    def old_route():
        return launch_rotate_transpose(ct, transform, v1)

    lib_err = (library().permute(0, 2, 3, 4, 1).float() - want.float()).abs().max().item()
    elem = ct.element_size()
    n_bytes = 2 * ct.numel() * elem + transform.numel() * 4
    bound_ms, bound_by = bound(n_bytes, TRANSPOSE_FLOPS_PER_ELEMENT * ct.numel())
    kernel_device, v1_device = in_turns(kernel, old_route)
    rec = dict(kernel="rotate_transpose_cuda", batch=batch, dtype=str(dtype).replace("torch.", ""),
               shape=list(ct.shape), route=plan.route, plan=plan._asdict(), max_abs_err=err,
               checked_err=checked, v1_checked_err=checked_v1, repeat_equal=repeat_equal,
               library_max_abs_err=lib_err, ms=time_ms(kernel), device_ms=kernel_device,
               v1_ms=time_ms(old_route), v1_device_ms=v1_device,
               plain_ms=time_ms(lambda: rotate_3d_grid_transpose_plain(ct, transform)),
               library_ms=time_ms(library), library_device_ms=device_ms(library, stream=side),
               bound_ms=bound_ms, bound_by=bound_by)
    records.append(rec)
    print("phase " + json.dumps(rec), flush=True)
    tol = TOL[rec["dtype"]]["transpose"]
    if not (repeat_equal and checked <= tol and checked_v1 <= tol):
        raise AssertionError(f"transpose kernel disagrees with its plain version: {rec}")


def rotate_sweep(path: str) -> None:
    """Device time of the slab forward and the owner-computes transpose at
    the main path's shapes for each tile that fits, beside route v1, each
    checked against the plain version; one JSON line per tile, also written
    to ``path``.  The tiles rotate_plan prefers come from this sweep."""
    smem, _ = rotate_device_limits(0)
    rows = []
    for transpose, batch, dtype in ((False, 24, torch.float32), (False, 12, torch.float32),
                                    (False, 32, torch.bfloat16), (False, 256, torch.bfloat16),
                                    (True, 12, torch.float32), (True, 24, torch.float32),
                                    (True, 12, torch.bfloat16), (True, 32, torch.bfloat16)):
        volume, transform = rotation_inputs(batch, dtype, 7)
        plan, v1 = rotate_plans(volume, transpose)
        elem = volume.element_size()
        if transpose:
            tiles = [plan._replace(group=g, shared_bytes=transpose_shared_bytes(16, g))
                     for g in (32, 64, 128)]
            run, plain = launch_rotate_transpose, rotate_3d_grid_transpose_plain
        else:
            tiles = [plan._replace(window=w, group=r // elem,
                                   shared_bytes=forward_shared_bytes(16, w, r // elem, elem))
                     for w in (1, 2, 4, 8) for r in (32, 64, 128)]
            run, plain = launch_rotate_forward, rotate_3d_grid_plain
        want = plain(volume, transform)
        for tile in [v1] + [t for t in tiles if t.shared_bytes <= smem]:
            got = run(volume, transform, tile)
            checked = compare(got, want)[1]
            ms = device_ms(lambda: run(volume, transform, tile))
            row = dict(transpose=transpose, batch=batch, dtype=str(dtype).replace("torch.", ""),
                       route=tile.route, window=tile.window, group=tile.group,
                       shared_bytes=tile.shared_bytes, device_ms=ms, checked_err=checked,
                       picked=tile == plan)
            rows.append(row)
            print("sweep " + json.dumps(row), flush=True)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(rows, indent=1))


def adain_backward_phase(batch: int, positions: int, channels: int, dtype, records: list):
    """The backward kernel against its plain version (the torch-op backward)
    on the same saved statistics, launched twice (the two results must be
    equal bit for bit: fixed-order sums), also on the two-pass route; timed
    beside the plain version and the autograd backward of F.group_norm +
    affine."""
    gen = torch.Generator(device="cuda").manual_seed(positions * channels + batch + 7)
    x = (torch.randn((batch, positions, channels), generator=gen, device="cuda") * 3 + 1).to(dtype)
    g = torch.randn((batch, positions, channels), generator=gen, device="cuda").to(dtype)
    scale = torch.randn((batch, channels), generator=gen, device="cuda").to(dtype)
    bias = torch.zeros((batch, channels), device="cuda", dtype=dtype)
    smem, sms = device_limits(x.device.index)
    plan = adain_route(batch, positions, channels, dtype, smem, sms, backward=True)
    two_pass = adain_two_pass_plan(batch, positions, channels, dtype, sms)
    _, stats = fused_adain_forward(x, scale, bias)
    got = fused_adain_backward(x, g, stats, scale, bias.dtype)
    again = fused_adain_backward(x, g, stats, scale, bias.dtype)
    got_two = launch_backward(x, g, stats, scale, bias.dtype, two_pass)
    want = fused_adain_backward_plain(x, g, stats, scale, bias.dtype)
    torch.cuda.synchronize()
    repeat_equal = all(torch.equal(a, b) for a, b in zip(got, again))
    err, checked = compare(got[0], want[0])
    _, checked_two = compare(got_two[0], want[0])
    sums_err = max((a.float() - b.float()).abs().max().item()
                   / max(1.0, b.float().abs().max().item())
                   for pair in (got, got_two) for a, b in zip(pair[1:], want[1:]))

    # the library's forward runs on a side stream: autograd runs the backward
    # on the forward's stream, which the graph capture must then use too
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x_cf = x.transpose(1, 2).contiguous().requires_grad_(True)
        gain = (scale.detach().clone() + 1).requires_grad_(True)
        shift = bias.detach().clone().requires_grad_(True)
        out = F.group_norm(x_cf, channels, eps=1e-3) * gain[:, :, None] + shift[:, :, None]
        g_cf = g.transpose(1, 2).contiguous()
    torch.cuda.current_stream().wait_stream(side)

    def library():
        return torch.autograd.grad(out, (x_cf, gain, shift), g_cf, retain_graph=True)

    def kernel():
        return fused_adain_backward(x, g, stats, scale, bias.dtype)

    def plain():
        return fused_adain_backward_plain(x, g, stats, scale, bias.dtype)

    elem = x.element_size()
    n_bytes = 3 * x.numel() * elem + 3 * scale.numel() * elem  # x, g read; dx written
    rec = dict(kernel="adain_backward_cuda", batch=batch, dtype=str(dtype).replace("torch.", ""),
               shape=list(x.shape), site=site(positions, channels), route=plan.route,
               plan=plan._asdict(), max_abs_err=err, checked_err=checked,
               two_pass_checked_err=checked_two, sums_err=sums_err, repeat_equal=repeat_equal,
               ms=time_ms(kernel), device_ms=device_ms(kernel),
               two_pass_ms=time_ms(lambda: launch_backward(x, g, stats, scale, bias.dtype,
                                                           two_pass)),
               plain_ms=time_ms(plain), plain_device_ms=device_ms(plain),
               library_ms=time_ms(library), library_device_ms=device_ms(library, stream=side),
               bound_ms=bound(n_bytes, 0)[0], bound_by="bytes")
    records.append(rec)
    print("phase " + json.dumps(rec), flush=True)
    tol = TOL[rec["dtype"]]["adain"]
    sums_tol = 1e-4 if dtype == torch.float32 else tol
    if not (repeat_equal and checked <= tol and checked_two <= tol and sums_err <= sums_tol):
        raise AssertionError(f"AdaIN backward kernel disagrees with its plain version: {rec}")


class FakeDataset:
    """A training set in the shape the trainer reads: uint8 images, eye masks,
    face-model metadata and rotations within the configured ranges."""

    def __init__(self, n_images: int, img_size: int, facemodel_dims: dict, seed: int):
        rng = np.random.default_rng(seed)
        self.imgs = rng.integers(0, 256, (n_images, img_size, img_size, 3), dtype=np.uint8)
        self.eye_masks = (rng.random((n_images, img_size, img_size)) > 0.95).astype(np.uint8)
        self.metadata_inputs = {name: rng.normal(size=(n_images, dim)).astype(np.float32)
                                for name, dim in facemodel_dims.items()}
        ranges = np.radians(np.asarray(((-30, 30), (-10, 10), (0, 0)), np.float64))
        self.metadata_inputs["rotations"] = rng.uniform(
            ranges[:, 0], ranges[:, 1], size=(n_images, 3)).astype(np.float32)


def train_config(compute_dtype: str, **extra):
    return dict(TRAIN_CONFIG, compute_dtype=compute_dtype, **extra)


KERNEL_WRAPPERS = (rotate_3d_grid_forward, rotate_3d_grid_transpose, fused_adain_forward,
                   fused_adain_backward)
LAUNCH_NAMES = ("rotate", "transpose", "adain", "adain_backward")
# per 256px train step: rotation forward, transpose, AdaIN forward (6 sites x
# 4 generator passes), AdaIN backward (6 sites x the G step's 2 halves of 12)
TRAIN_STEP_LAUNCHES = (4, 2, 24, 12)


def train_launches():
    return tuple(w.launches for w in KERNEL_WRAPPERS)


def check_finite(losses, label):
    for group, values in losses.items():
        for key, value in values.items():
            if not torch.isfinite(value).item():
                raise AssertionError(f"{label}: {group}/{key} = {value.item()}")


def train_run(model, dataset, label: str, card: str, kind: str):
    """One warm-up step, then TRAIN_STEPS timed steps (host batches drawn
    beforehand), each with exactly TRAIN_STEP_LAUNCHES kernel launches.  The
    launch counters are zeroed after the warm-up; returns (the counters after
    the timed steps, the run's record)."""
    step = model._build_train_step()
    batches = [model._sample_host_batch(dataset, dataset) for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    check_finite(step(batches[0]), label)
    warmup_s = time.perf_counter() - t0

    for wrapper in KERNEL_WRAPPERS:
        wrapper.launches = 0
    all_losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[1:]:
        before = train_launches()
        all_losses.append(step(batch))
        delta = tuple(after - b for after, b in zip(train_launches(), before))
        if delta != TRAIN_STEP_LAUNCHES:
            raise AssertionError(f"{label}: launches {LAUNCH_NAMES} {delta} in one "
                                 f"step, expected {TRAIN_STEP_LAUNCHES}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = train_launches()
    for losses in all_losses:
        check_finite(losses, label)
    rec = dict(run=label, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seconds=seconds,
               steps_per_s=TRAIN_STEPS / seconds, img_per_s=TRAIN_STEPS * TRAIN_BATCH / seconds,
               warmup_s=warmup_s, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=dict(zip(LAUNCH_NAMES, launches)),
               last_losses={g: {k: float(v) for k, v in d.items()} for g, d in all_losses[-1].items()})
    print(f"train {label}: {TRAIN_STEPS} steps of {TRAIN_BATCH} in {seconds * 1e3:.1f} ms = "
          f"{rec['steps_per_s']:.3f} steps/s, {rec['img_per_s']:.1f} img/s on {kind} ({card}); "
          f"warm-up {warmup_s:.1f} s; peak {rec['peak_memory_gb']:.1f} GB; launches {launches}; "
          f"loss_sum g {rec['last_losses']['g']['loss_sum']:.4f} d "
          f"{rec['last_losses']['d']['loss_sum']:.4f}", flush=True)
    return launches, rec


def check_generator_gradients_and_ema(model, ema_before) -> dict:
    """Every generator-player parameter got a nonzero gradient in the last G
    step (with beta_1 = 0 the Adam first moment is that gradient) and every
    EMA leaf moved."""
    zero = [f"{tree}/{key}" for tree, leaves in model.first_moments()["generator"].items()
            for key, value in leaves.items() if not np.any(value)]
    if zero:
        raise AssertionError(f"generator-player parameters without gradient: {zero[:10]}")
    still = [k for k, v in model.generator_smoothed.state_dict().items()
             if torch.equal(v, ema_before[k])]
    if still:
        raise AssertionError(f"generator_smoothed leaves that did not move: {still[:10]}")
    n = sum(len(leaves) for leaves in model.first_moments()["generator"].values())
    print(f"train float32: all {n} generator-player parameters got a nonzero gradient; all "
          f"{len(ema_before)} generator_smoothed leaves moved", flush=True)
    return dict(generator_player_leaves=n, ema_leaves=len(ema_before))


def _rotate_via_float64(grid, transform):
    """The gather form computed in float64 and rounded once: the plain path
    with one site rounded differently (about one ulp)."""
    return rotate_3d_grid(grid.double(), transform.double()).to(grid.dtype)


def compare_train_paths(model_k, dataset) -> dict:
    """One float32 step of the kernel-path model and of a plain-path model
    (gather rotation, plain AdaIN) from the same weights, fresh optimizers,
    the same host batch and the same draws.

    At random weights the step's gradients amplify last-bit differences in
    the forward a long way (a deterministic rerun of one path agrees
    exactly, but changing only the rounding of one site moves the generator
    player's gradient by ~1e-2 relative L2; NVIDIA H100, this script).  So
    the bounds (1e-3 on every loss's relative error and every player's
    relative L2 gradient distance) are widened, per quantity, to 4x the
    distance of a probe: the plain path with only the resample rounded
    differently (``_rotate_via_float64``).  The kernel path changes the
    rounding at 7 sites forward and backward, the probe at one."""
    weights = model_k.get_weights()
    model_k.set_weights(weights)
    generator_module._ROTATION_IMPLS["gather_via_float64"] = _rotate_via_float64
    batch = model_k._sample_host_batch(dataset, dataset)
    rng = np.random.default_rng(7)
    latent_dim, half = model_k.config["latent_dim"], TRAIN_BATCH // 2
    latents = [rng.normal(size=(n, latent_dim)).astype(np.float32)
               for n in (TRAIN_BATCH, TRAIN_BATCH, TRAIN_BATCH - half)]
    rotations = [poses(n, rng) for n in (TRAIN_BATCH, TRAIN_BATCH - half)]
    flips = [rng.random(TRAIN_BATCH) < 0.5 for _ in range(2)]

    def step(model):
        queues = [list(latents), list(rotations), list(flips)]
        model._sample_latent = lambda n: torch.from_numpy(queues[0].pop(0)).cuda()
        model._sample_rotations = lambda n: torch.from_numpy(queues[1].pop(0)).cuda()
        model._flip_mask = lambda n: torch.from_numpy(queues[2].pop(0)).cuda()
        losses = model._build_train_step()(batch)
        return ({f"{g}/{k}": float(v) for g, d in losses.items() for k, v in d.items()},
                model.first_moments())

    results = {}
    for name, rotation in (("plain", "gather"), ("probe", "gather_via_float64")):
        model = ConfigNetFirstStage(train_config("float32", rotation_resample_train=rotation,
                                                 adain_impl="plain"))
        model.set_weights(weights)
        before = train_launches()
        results[name] = step(model)
        if train_launches() != before:
            raise AssertionError(f"the {name}-path train step launched a kernel")
        del model
        torch.cuda.empty_cache()
    before = train_launches()
    results["kernel"] = step(model_k)
    delta = tuple(a - b for a, b in zip(train_launches(), before))
    if delta != TRAIN_STEP_LAUNCHES:
        raise AssertionError(f"the kernel-path train step launched {delta}")

    def distances(name):
        losses, moments = results[name]
        plain_losses, plain_moments = results["plain"]
        out = {"losses": max(abs(losses[k] - v) / abs(v) for k, v in plain_losses.items())}
        for player, trees in PLAYER_TREES.items():
            keys = [(t, k) for t in trees for k in sorted(plain_moments[player][t])]
            a = np.concatenate([moments[player][t][k].ravel() for t, k in keys])
            b = np.concatenate([plain_moments[player][t][k].ravel() for t, k in keys])
            out[player] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        return out

    kernel, probe = distances("kernel"), distances("probe")
    bounds = {k: max(1e-3, 4 * v) for k, v in probe.items()}
    print(f"train float32 kernel vs plain path (losses: max relative error; players: relative L2 "
          f"of the gradient): {json.dumps(kernel)}; one-site rounding probe vs plain path: "
          f"{json.dumps(probe)}; bounds {json.dumps(bounds)}", flush=True)
    failed = [k for k in kernel if not kernel[k] <= bounds[k]]
    if failed:
        raise AssertionError(f"kernel-path and plain-path train steps disagree on {failed}")
    return dict(kernel_vs_plain=kernel, probe_vs_plain=probe, bounds=bounds)


def serving_config(compute_dtype: str, **extra):
    # every face-model input given an input dim: blendshapes 62, the others
    # their latent slice -> latent_dim 145
    slices = {"texture_embedding": 30, "geometry_identity_params": 30, "blendshape_values": 30,
              "beard_style_embedding": 7, "eyebrow_style_embedding": 7, "lower_eyelash_style": 2,
              "upper_eyelash_style": 2, "head_hair_style_embedding": 9, "eye_color": 3,
              "head_hair_color": 3, "hdri_embedding": 20, "bone_rotations:left_eye": 2}
    inputs = {k: (62 if k == "blendshape_values" else v, v) for k, v in slices.items()}
    return dict(output_shape=(256, 256, 3), compute_dtype=compute_dtype, facemodel_inputs=inputs,
                seed=0, **extra)


def give_encoder_heads_weights(model, photos):
    """The heads are zero-initialised; seeded noise scaled to the random
    trunk's features makes latents and poses vary from photo to photo."""
    enc = model.real_encoder
    with torch.inference_mode():
        imgs = torch.from_numpy(photos).to(model.device).float() / 127.5 - 1.0
        features = enc.resnet(resnet50_preprocess(imgs)).float()
    std = 1.0 / (np.sqrt(2048) * features.square().mean().sqrt().item())
    gen = torch.Generator().manual_seed(1234)
    with torch.no_grad():
        for head in (enc.feature_to_latent, enc.rotation_regressor):
            head.weight.copy_(torch.randn(head.weight.shape, generator=gen) * std)


def profile(label: str, fn, path: str) -> None:
    """Device time of one warm call of ``fn``, by kernel name
    (torch.profiler), beside its host wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    by_shape = prof.key_averages(group_by_input_shape=True).table(
        sort_by="cuda_time_total", row_limit=25, max_name_column_width=40,
        max_shapes_column_width=160)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(f"{label}: wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms\n"
                          f"{table}\n\nby input shape:\n{by_shape}\n")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    print(f"profile {label}: wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms "
          f"({100 * device_ms / wall_ms:.1f}%), {sum(e.count for e in events)} device ops",
          flush=True)
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write every record to this JSON file")
    parser.add_argument("--profile", help="also profile one warm generate chunk of the bf16 "
                        "server with torch.profiler and write its kernel table here (and one "
                        "float32 train step's beside it, as <stem>_train.txt)")
    parser.add_argument("--rotate-sweep", metavar="PATH",
                        help="only build the kernels, time every rotation tile that fits at the "
                        "main path's shapes, write the rows to PATH and stop")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'nothing (cached)'}")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or line.startswith("built"):
                print(f"  {name}: {line.strip()}")
    if args.rotate_sweep:
        rotate_sweep(args.rotate_sweep)
        return 0

    # -- 3. kernel phases ------------------------------------------------------
    records = []
    for batch in (SERVE_CHUNK, 256):
        for dtype in (torch.float32, torch.bfloat16):
            rotate_phase(batch, dtype, records)
            for positions, channels in ADAIN_SITES_256:
                adain_phase(batch, positions, channels, dtype, records)
    for dtype in (torch.float32, torch.bfloat16):
        adain_phase(256, *ADAIN_SITE_512, dtype, records)
    # the float32 train step's shapes: the D updates render 24, the G step 12 + 12
    for batch in (TRAIN_BATCH // 2, TRAIN_BATCH):
        rotate_phase(batch, torch.float32, records)
        for positions, channels in ADAIN_SITES_256:
            adain_phase(batch, positions, channels, torch.float32, records)
    torch.cuda.empty_cache()

    # -- 4. serving at full width ----------------------------------------------
    rng = np.random.default_rng(0)
    photos = rng.integers(0, 256, (40, 256, 256, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    model = ConfigNet(serving_config("bfloat16"))
    give_encoder_heads_weights(model, photos[:SERVE_CHUNK])
    server = ConfigNetServer(model, chunk=SERVE_CHUNK)
    print(f"model: latent_dim {model.config['latent_dim']}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if model.config["latent_dim"] != 145:
        raise AssertionError(model.config["latent_dim"])
    n_blend = model.config["facemodel_inputs"]["blendshape_values"][0]
    blend = rng.uniform(0, 1, size=(1, n_blend)).astype(np.float32)
    latents = rng.normal(size=(256, 145)).astype(np.float32)
    rotations = poses(256, rng)

    requests = [
        ("encode", 40, 0, lambda: server.encode(photos)),
        ("render_with_attribute", 40, 2, lambda: server.render_with_attribute(
            photos, "blendshape_values", blend)),
        ("generate", 256, 8, lambda: server.generate(latents, rotations)),
    ]
    rotate_3d_grid_forward.launches = 0
    fused_adain_forward.launches = 0
    results, served = {}, []
    for name, n_images, gen_chunks, call in requests:
        for attempt in ("cold", "warm"):
            rot0, ada0 = rotate_3d_grid_forward.launches, fused_adain_forward.launches
            t0 = time.perf_counter()
            out = call()
            seconds = time.perf_counter() - t0
            d_rot, d_ada = rotate_3d_grid_forward.launches - rot0, fused_adain_forward.launches - ada0
            if (d_rot, d_ada) != (gen_chunks, 6 * gen_chunks):
                raise AssertionError(f"{name}: {d_rot} rotation and {d_ada} AdaIN launches for "
                                     f"{gen_chunks} generator chunks")
            served.append(dict(request=name, run=attempt, images=n_images, seconds=seconds,
                               img_per_s=n_images / seconds, rotate_launches=d_rot,
                               adain_launches=d_ada))
            print(f"serve {name} ({attempt}): {n_images} images in {seconds * 1e3:.1f} ms = "
                  f"{n_images / seconds:.1f} img/s on {kind} ({card}); launches rotate {d_rot}, "
                  f"adain {d_ada}", flush=True)
        results[name] = out
    main_launches = {"rotate_cuda": rotate_3d_grid_forward.launches,
                     "adain_cuda": fused_adain_forward.launches}
    if args.profile:
        chunk = (latents[:SERVE_CHUNK], rotations[:SERVE_CHUNK])
        profile(f"generate chunk {SERVE_CHUNK}", lambda: server.generate(*chunk), args.profile)

    lat, rot = results["encode"]
    if lat.shape != (40, 145) or rot.shape != (40, 3) or not (np.isfinite(lat).all()
                                                               and np.isfinite(rot).all()):
        raise AssertionError(f"encode gave {lat.shape} {rot.shape}")
    if lat[:, 0].std() == 0 or rot[:, 0].std() == 0:
        raise AssertionError("encode gave the same latent for every photo")
    for name, n in (("render_with_attribute", 40), ("generate", 256)):
        imgs = results[name]
        if imgs.shape != (n, 256, 256, 3) or imgs.dtype != np.uint8:
            raise AssertionError(f"{name} gave {imgs.shape} {imgs.dtype}")
        if imgs.std() == 0 or np.all(imgs[0] == imgs[1]):
            raise AssertionError(f"{name} gave constant images")
    del server, model, results
    torch.cuda.empty_cache()

    # -- 5. kernel path vs plain path, float32 ------------------------------------
    model_k = ConfigNet(serving_config("float32"))
    give_encoder_heads_weights(model_k, photos[:8])
    model_p = ConfigNet(serving_config("float32", rotation_resample="gather", adain_impl="plain"))
    model_p.set_weights(model_k.get_weights())
    before = (rotate_3d_grid_forward.launches, fused_adain_forward.launches)
    out_p = ConfigNetServer(model_p, chunk=8).render_with_attribute(photos[:8], "blendshape_values", blend)
    if (rotate_3d_grid_forward.launches, fused_adain_forward.launches) != before:
        raise AssertionError("the plain-path server launched a kernel")
    out_k = ConfigNetServer(model_k, chunk=8).render_with_attribute(photos[:8], "blendshape_values", blend)
    if (rotate_3d_grid_forward.launches - before[0], fused_adain_forward.launches - before[1]) != (1, 6):
        raise AssertionError("the kernel-path server did not go through the kernels")
    e2e = float(np.mean(np.abs(out_k.astype(int) - out_p.astype(int))))
    print(f"e2e float32 kernel vs plain path: mean abs uint8 difference {e2e:.4f} "
          f"(max {int(np.abs(out_k.astype(int) - out_p.astype(int)).max())}), bound 1.0", flush=True)
    if not e2e < 1.0 or out_k.std() == 0:
        raise AssertionError(f"kernel path and plain path disagree: {e2e}")

    del model_k, model_p
    torch.cuda.empty_cache()

    # -- 6. transpose kernel; AdaIN backward kernel ----------------------------------
    for batch in (TRAIN_BATCH // 2, TRAIN_BATCH, SERVE_CHUNK, 256):
        for dtype in (torch.float32, torch.bfloat16):
            transpose_phase(batch, dtype, records)
    for batch in (TRAIN_BATCH // 2, TRAIN_BATCH):
        for dtype in (torch.float32, torch.bfloat16):
            for positions, channels in ADAIN_SITES_256:
                adain_backward_phase(batch, positions, channels, dtype, records)
    torch.cuda.empty_cache()

    # -- 7. stage-1 training at full width ---------------------------------------------
    dataset = FakeDataset(64, 256, {name: dims[0] for name, dims
                                    in TRAIN_CONFIG["facemodel_inputs"].items()}, seed=0)
    t0 = time.perf_counter()
    trainer = ConfigNetFirstStage(train_config("float32"))
    print(f"trainer: latent_dim {trainer.config['latent_dim']}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if trainer.config["latent_dim"] != 145:
        raise AssertionError(trainer.config["latent_dim"])
    ema_before = {k: v.clone() for k, v in trainer.generator_smoothed.state_dict().items()}
    train_main_launches, train_f32 = train_run(trainer, dataset, "float32", card, kind)
    train_f32.update(check_generator_gradients_and_ema(trainer, ema_before))
    if args.profile:
        step = trainer._build_train_step()
        batch = trainer._sample_host_batch(dataset, dataset)
        profile("train step (float32, batch 24)", lambda: step(batch),
                str(Path(args.profile).with_name(Path(args.profile).stem + "_train.txt")))
    train_paths = compare_train_paths(trainer, dataset)
    del trainer
    torch.cuda.empty_cache()
    _, train_bf16 = train_run(ConfigNetFirstStage(train_config("bfloat16")), dataset, "bfloat16",
                              card, kind)

    # -- 8. records ------------------------------------------------------------------
    def entry(kernel, source, replaces, launches, phase_counts):
        """Times of one float32 train step's launches: the phases at its
        shapes, each counted as often as the step launches it."""
        picked = [(r, n) for r in records for (name, batch), n in phase_counts.items()
                  if r["kernel"] == name and r["batch"] == batch and r["dtype"] == "float32"]
        item = {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r, _ in picked),
                "ms": sum(r["ms"] * n for r, n in picked),
                "device_ms": sum(r["device_ms"] * n for r, n in picked),
                "plain_ms": sum(r["plain_ms"] * n for r, n in picked),
                "bound_ms": sum(r["bound_ms"] * n for r, n in picked),
                "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r, _ in picked)
                else "operations",
                "library_ms": sum(r["library_ms"] * n for r, n in picked),
                "library_device_ms": sum(r["library_device_ms"] * n for r, n in picked),
                "serving_launches": serving_launches.get(kernel)}
        if any("site" in r for r, _ in picked):  # AdaIN: the route of each site and batch
            item["site_routes"] = {f"B{r['batch']} {r['site']}": r["route"] for r, _ in picked}
        else:  # rotation: the kernel route of each batch, and route v1 in turns
            item["kernel_route"] = {f"B{r['batch']}": r["route"] for r, _ in picked}
            item["v1_device_ms"] = sum(r["v1_device_ms"] * n for r, n in picked)
        return item

    serving_launches = main_launches
    half = TRAIN_BATCH // 2
    n_rot, n_transpose, n_adain, n_adain_backward = train_main_launches
    kernels = [
        entry("rotate_cuda", "confignet_tpu_torch/csrc/rotate.cu",
              "confignet_tpu/ops/rotate_pallas.py:65", n_rot,
              {("rotate_cuda", TRAIN_BATCH): 2, ("rotate_cuda", half): 2}),
        entry("rotate_transpose_cuda", "confignet_tpu_torch/csrc/rotate.cu",
              "confignet_tpu/ops/rotate_pallas.py:95", n_transpose,
              {("rotate_transpose_cuda", half): 2}),
        entry("adain_cuda", "confignet_tpu_torch/csrc/adain.cu",
              "confignet_tpu/ops/adain_pallas.py:29", n_adain,
              {("adain_cuda", TRAIN_BATCH): 2, ("adain_cuda", half): 2}),
        entry("adain_backward_cuda", "confignet_tpu_torch/csrc/adain.cu",
              "confignet_tpu/ops/adain_pallas.py:87", n_adain_backward,
              {("adain_backward_cuda", half): 2}),
    ]
    for item in kernels:
        if item["launches"] < 1:
            raise AssertionError(f"{item['name']} was not launched on the main path")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kind": kind, "torch": torch.__version__, "cuda": torch.version.cuda,
             "phases": records, "serving": served, "e2e_mean_abs_uint8": e2e,
             "train": [train_f32, train_bf16], "train_paths": train_paths,
             "kernels": kernels, "seconds": time.perf_counter() - t_start}, indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
