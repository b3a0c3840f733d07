#!/usr/bin/env python3
"""Drive the PyTorch port (confignet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; turns TF32 off.
2. Builds the CUDA kernels from the sources in this checkout, one nvcc per
   source, all at once.
3. Holds each kernel against its plain PyTorch version at the serving
   path's shapes, in float32 and bfloat16, and times the kernel, the plain
   version and one PyTorch library call that computes the same function,
   beside the least time the card could take (bytes over 3.35 TB/s or
   float32 operations over 67 TFLOP/s, whichever is larger).
4. Serves requests at full width (256px, bf16, 145-dim latents, weights
   from seed 0) through ConfigNetServer(chunk=32): encode 40 photos,
   re-render them with a spliced attribute, generate 256 latents.  The
   launch counters are zeroed just before and read just after, and must
   show one rotation and six AdaIN launches per generator chunk.
5. Runs the same float32 server with the kernels and with their plain
   versions on 8 photos; the renders must agree to a mean abs uint8
   difference below 1.0.
6. Prints the kernels' JSON record, then as the last line
   {"ok": true, "device": {...}}.

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

from confignet_tpu_torch.core.transforms import _source_coords, euler_angles_to_matrix
from confignet_tpu_torch.models.backbones.resnet import resnet50_preprocess
from confignet_tpu_torch.ops import cuda_build
from confignet_tpu_torch.ops.adain_cuda import fused_adain, fused_adain_plain
from confignet_tpu_torch.ops.rotate_cuda import rotate_3d_grid_kernel, rotate_3d_grid_plain
from confignet_tpu_torch.serving import ConfigNetServer
from confignet_tpu_torch.training.second_stage import ConfigNet

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
ROTATE_FLOPS_PER_ELEMENT = 21  # 7 lerps of 3 operations
ADAIN_FLOPS_PER_ELEMENT = 7  # mean 1, centred variance 3, normalise+modulate 3
ADAIN_SITES_256 = ((512, 256), (4096, 128), (256, 256), (1024, 64), (4096, 32), (16384, 32))
ADAIN_SITE_512 = (65536, 16)
SERVE_CHUNK = 32
# float32: absolute (the JAX kernels' contracts, tests/test_pallas_interpret.py);
# bfloat16: 3e-2 of max(1, |value|) -- kernel and plain version each round
# once to bf16, and one bf16 ulp is 2^-7 relative (0.03125 in [4, 8)).
TOL = {"float32": {"rotate": 2e-5, "adain": 1e-4}, "bfloat16": {"rotate": 3e-2, "adain": 3e-2}}


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


def rotate_phase(batch: int, dtype, records: list):
    size, channels = 16, 128
    gen = torch.Generator(device="cuda").manual_seed(batch)
    grid = torch.randn((batch, size, size, size, channels), generator=gen, device="cuda").to(dtype)
    transform = euler_angles_to_matrix(
        torch.from_numpy(poses(batch, np.random.default_rng(batch)))).cuda()
    got = rotate_3d_grid_kernel(grid, transform)
    want = rotate_3d_grid_plain(grid, transform)
    torch.cuda.synchronize()
    err, checked = compare(got, want)

    # library yardstick: 5-D trilinear grid_sample, align_corners, border
    # padding, the grid's (x, y, z) axes as grid_sample's (D, H, W)
    floor, _, frac = _source_coords(grid, transform)
    src = (floor.float() + frac) / (size - 1) * 2 - 1  # (B, 3, P), clamped
    sample_grid = src.flip(1).transpose(1, 2).reshape(batch, size, size, size, 3).to(dtype)
    volume = grid.permute(0, 4, 1, 2, 3)

    def library():
        return F.grid_sample(volume, sample_grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    lib_err = (library().permute(0, 2, 3, 4, 1).float() - want.float()).abs().max().item()
    elem = grid.element_size()
    n_bytes = 2 * grid.numel() * elem + transform.numel() * 4
    bound_ms, bound_by = bound(n_bytes, ROTATE_FLOPS_PER_ELEMENT * grid.numel())
    rec = dict(kernel="rotate_cuda", batch=batch, dtype=str(dtype).replace("torch.", ""),
               shape=list(grid.shape), max_abs_err=err, checked_err=checked,
               library_max_abs_err=lib_err,
               ms=time_ms(lambda: rotate_3d_grid_kernel(grid, transform)),
               plain_ms=time_ms(lambda: rotate_3d_grid_plain(grid, transform)),
               library_ms=time_ms(library), bound_ms=bound_ms, bound_by=bound_by)
    records.append(rec)
    print("phase " + json.dumps(rec), flush=True)
    if not checked <= TOL[rec["dtype"]]["rotate"]:
        raise AssertionError(f"rotate kernel disagrees with its plain version: {rec}")


def adain_phase(batch: int, positions: int, channels: int, dtype, records: list):
    gen = torch.Generator(device="cuda").manual_seed(positions * channels + batch)
    x = (torch.randn((batch, positions, channels), generator=gen, device="cuda") * 3 + 1).to(dtype)
    scale = torch.randn((batch, channels), generator=gen, device="cuda").to(dtype)
    bias = torch.randn((batch, channels), generator=gen, device="cuda").to(dtype)
    got = fused_adain(x, scale, bias)
    want = fused_adain_plain(x, scale, bias)
    torch.cuda.synchronize()
    err, checked = compare(got, want)

    x_cf = x.transpose(1, 2).contiguous()  # group_norm's channels-first layout
    gain, shift = (scale + 1)[:, :, None], bias[:, :, None]

    def library():
        return F.group_norm(x_cf, channels, eps=1e-3) * gain + shift

    elem = x.element_size()
    n_bytes = 2 * x.numel() * elem + 2 * scale.numel() * elem
    bound_ms, bound_by = bound(n_bytes, ADAIN_FLOPS_PER_ELEMENT * x.numel())
    rec = dict(kernel="adain_cuda", batch=batch, dtype=str(dtype).replace("torch.", ""),
               shape=list(x.shape), max_abs_err=err, checked_err=checked,
               ms=time_ms(lambda: fused_adain(x, scale, bias)),
               plain_ms=time_ms(lambda: fused_adain_plain(x, scale, bias)),
               library_ms=time_ms(library), bound_ms=bound_ms, bound_by=bound_by)
    records.append(rec)
    print("phase " + json.dumps(rec), flush=True)
    if not checked <= TOL[rec["dtype"]]["adain"]:
        raise AssertionError(f"AdaIN kernel disagrees with its plain version: {rec}")


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


def profile_generate(server, latents, rotations, path: str) -> None:
    """Device time of one generate chunk, by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    server.generate(latents, rotations)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.generate(latents, rotations)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(f"wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms\n{table}\n")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    print(f"profile generate chunk {len(latents)}: wall {wall_ms:.3f} ms, device busy "
          f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}%)", flush=True)
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write every record to this JSON file")
    parser.add_argument("--profile", help="also profile one warm generate chunk of the bf16 "
                        "server with torch.profiler and write its kernel table here")
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

    # -- 3. kernel phases ------------------------------------------------------
    records = []
    for batch in (SERVE_CHUNK, 256):
        for dtype in (torch.float32, torch.bfloat16):
            rotate_phase(batch, dtype, records)
            for positions, channels in ADAIN_SITES_256:
                adain_phase(batch, positions, channels, dtype, records)
    for dtype in (torch.float32, torch.bfloat16):
        adain_phase(256, *ADAIN_SITE_512, dtype, records)
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
    rotate_3d_grid_kernel.launches = 0
    fused_adain.launches = 0
    results, served = {}, []
    for name, n_images, gen_chunks, call in requests:
        for attempt in ("cold", "warm"):
            rot0, ada0 = rotate_3d_grid_kernel.launches, fused_adain.launches
            t0 = time.perf_counter()
            out = call()
            seconds = time.perf_counter() - t0
            d_rot, d_ada = rotate_3d_grid_kernel.launches - rot0, fused_adain.launches - ada0
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
    main_launches = {"rotate_cuda": rotate_3d_grid_kernel.launches,
                     "adain_cuda": fused_adain.launches}
    if args.profile:
        profile_generate(server, latents[:SERVE_CHUNK], rotations[:SERVE_CHUNK], args.profile)

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
    before = (rotate_3d_grid_kernel.launches, fused_adain.launches)
    out_p = ConfigNetServer(model_p, chunk=8).render_with_attribute(photos[:8], "blendshape_values", blend)
    if (rotate_3d_grid_kernel.launches, fused_adain.launches) != before:
        raise AssertionError("the plain-path server launched a kernel")
    out_k = ConfigNetServer(model_k, chunk=8).render_with_attribute(photos[:8], "blendshape_values", blend)
    if (rotate_3d_grid_kernel.launches - before[0], fused_adain.launches - before[1]) != (1, 6):
        raise AssertionError("the kernel-path server did not go through the kernels")
    e2e = float(np.mean(np.abs(out_k.astype(int) - out_p.astype(int))))
    print(f"e2e float32 kernel vs plain path: mean abs uint8 difference {e2e:.4f} "
          f"(max {int(np.abs(out_k.astype(int) - out_p.astype(int)).max())}), bound 1.0", flush=True)
    if not e2e < 1.0 or out_k.std() == 0:
        raise AssertionError(f"kernel path and plain path disagree: {e2e}")

    # -- 6. records ------------------------------------------------------------------
    def main_path_entry(kernel, source, replaces, phase_records):
        return {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "launches": main_launches[kernel],
                "max_abs_err": max(r["max_abs_err"] for r in phase_records),
                "ms": sum(r["ms"] for r in phase_records),
                "plain_ms": sum(r["plain_ms"] for r in phase_records),
                "bound_ms": sum(r["bound_ms"] for r in phase_records),
                "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in phase_records)
                else "operations",
                "library_ms": sum(r["library_ms"] for r in phase_records)}

    # the serving path's shapes: one bf16 generator chunk of 32 (the AdaIN
    # entry sums its six 256px sites)
    at_main = [r for r in records if r["batch"] == SERVE_CHUNK and r["dtype"] == "bfloat16"]
    kernels = [
        main_path_entry("rotate_cuda", "confignet_tpu_torch/csrc/rotate.cu",
                        "confignet_tpu/ops/rotate_pallas.py:65",
                        [r for r in at_main if r["kernel"] == "rotate_cuda"]),
        main_path_entry("adain_cuda", "confignet_tpu_torch/csrc/adain.cu",
                        "confignet_tpu/ops/adain_pallas.py:29",
                        [r for r in at_main if r["kernel"] == "adain_cuda"]),
    ]
    for entry in kernels:
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} was not launched on the main path")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kind": kind, "torch": torch.__version__, "cuda": torch.version.cuda,
             "phases": records, "serving": served, "e2e_mean_abs_uint8": e2e,
             "kernels": kernels, "seconds": time.perf_counter() - t_start}, indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
