#!/usr/bin/env python3
"""Drive the PyTorch port (confignet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--profile profile.txt]
    python3 chip_smoke.py --rotate-sweep sweep.json   (rotation tiles only)
    python3 chip_smoke.py --loops-only | --demo-only | --mesh-only | --512-only | --bench-only
                          | --graphs-only            (step 13, 14, 15, 16, 17 or 18 only)
    python3 chip_smoke.py --first-step-probe probe.json  (the first-step bisect only)

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; turns TF32 off.
2. Builds the CUDA kernels from the sources in this checkout, one nvcc per
   source, all at once.
3. Holds each kernel against its plain PyTorch version at the serving
   path's shapes, in float32 and bfloat16, and times the kernel, the plain
   version and one PyTorch library call that computes the same function,
   beside the least time the card could take (benchmark/counts/kernels.py's
   bound: bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s,
   whichever is larger).  Each time is
   taken twice: ``ms`` over back-to-back launches (which the host may pace)
   and ``device_ms`` by replaying a CUDA graph of 10 launches (the library
   call too, as ``library_device_ms``).  AdaIN runs on the route
   adain_route picks (printed per site; two launches must agree bit for
   bit), the rotation on the slab tiles rotate_plan picks (printed with
   its plan).  Batches 32 (a serving chunk), 64 (a fused FID chunk)
   and 256, both dtypes; the float32 train step's 12 and 24; and B=1, the
   fine-tune's batch (AdaIN, both dtypes) and the tuned controllability
   metric's renders (the rotation, float32).
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
   launches must agree bit for bit, timed beside the input gradient of
   F.grid_sample.  Holds the AdaIN backward kernel against its plain
   version (torch ops) at the six 256px sites, B=12, 24 and 1 (the
   fine-tune's), float32 and bf16, on the route adain_route picks; two
   launches must agree bit for bit; times it beside the autograd backward
   of F.group_norm + affine.
7. Trains the stage-1 model at full width (256px, batch 24, 5 discriminator
   layers, VGG19 taps (1, 2, 8, 13), 145-dim latents, weights from seed 0) on a
   fake dataset of 64 images: float32, two warm-up steps (the first eager, the
   second capturing the step's CUDA graph) and 3 timed replays, each with
   exactly 4 rotation-forward, 2 transpose, 24 AdaIN-forward and 12
   AdaIN-backward launches, finite losses,
   a nonzero gradient for every generator-player parameter and a moving EMA;
   then bfloat16, the same.  Then one float32 step of a kernel-path model and
   of a plain-path model (the gather form with the transform's gradient
   stopped, as the kernels define it, and plain AdaIN) on the same weights,
   batch and draws: losses within rtol 1e-3, each player's gradient within a
   relative L2 distance of 1e-3, or, where the step's own sensitivity to
   rounding exceeds that, within 4x the distance of a one-site rounding probe
   (see compare_train_paths).
8. Trains the stage-2 model (ConfigNet: the encoder joins the generator
   player; its VGGFace loss is the fine-tune's, not the step's) at the same
   width and batch, its encoder heads given weights: float32 and bfloat16,
   two warm-up steps and 3 timed replays each, with the stage-1 step's launch
   counts, finite losses, a nonzero gradient for every generator-player
   parameter (the encoder's included) and a moving EMA.  Then one float32
   step of the kernel path and of the plain path, bounded as in step 7.
9. Fine-tunes the full-width serving model (heads given weights) on one
   seeded photo with fine_tune_on_img: float32, then bfloat16, one warm call
   of 2 iterations (which captures the iteration's CUDA graph) and a timed
   call of 50 (one eager iteration, 49 replays), each iteration with exactly
   0 rotation, 0 transpose, 6 AdaIN-forward and 6 AdaIN-backward launches,
   counted at capture and added at each replay (the fine-tune
   differentiates the rotations, so it resamples with the gather form); a
   finite final loss, a fine-tuned generator unlike the EMA, the
   EMA unchanged, and ConfigNetServer.refresh() rendering with the
   fine-tuned weights.
10. Fine-tunes along one trajectory (5 iterations of the plain path from the
   same weights and photo) and at each iteration's state holds the kernel
   path against the plain path: the loss within rtol 1e-3, the gradient
   within a relative L2 distance of 1e-3, widened, where the fine-tune's own
   sensitivity to rounding exceeds it, to 4x the largest distance of a
   one-site rounding probe along the trajectory; then both render the
   trajectory's end within a mean abs uint8 difference of 1.0 (see
   compare_fine_tune_paths).
11. The sampling path, at full width: saves the float32 serving model (heads
   given weights, seeded Gaussian face-model distributions) with save() and
   reloads it with load_confignet(), every weight tree equal bit for bit and
   32 renders identical; trains a LatentGAN(latent_dim=145) at batch 32 on the
   embeddings of 64 seeded photos (extract_embeddings; two warm-up and
   LATENT_GAN_STEPS timed steps, finite losses, a generator that moved,
   steps/s printed) and round-trips it (generate_latents_smoothed equal bit
   for bit); times ConfigNetServer(model, latent_gan, chunk=32).sample(256,
   truncation=0.7) in bfloat16, warm, with the counters zeroed just before
   and read just after: exactly 8 rotation-forward and 48 AdaIN-forward
   launches, no transpose or AdaIN backward; renders 32 sampled face-model
   parameter sets with generate_images_from_facemodel (1 and 6 launches);
   and renders 32 sampled latents with the kernels and with the plain path
   in float32, within a mean abs uint8 difference of 1.0.
12. The evaluation path, at full width (the serving config with the beard
   embedding's 9 PCA dims, seeded Gaussian face-model distributions; Inception
   and MobileNetV2 at 256px): a NeuralRendererDataset of 1,000 seeded images
   with labels for the classifier CLI's 38 CelebA attributes, saved and
   reloaded (equal), its Inception features (bf16) timed; FID/KID as the
   trainer scores them (InceptionMetrics over the dataset, then the fused
   generator -> Inception features of 1,000 sampled latents in 16 chunks of
   64, bf16, warm, exactly 16 rotation-forward and 96 AdaIN-forward launches,
   finite KID and FID); in float32 the fused features of the kernel path and
   the plain path, and the fused against get_features(generate_images(...)),
   all through a float32 Inception, within 1e-3 relative L2; the attribute classifier (38 attributes,
   batch 32, trainable BN) 1 warm-up and 10 timed train steps, BN
   recalibration, 256 predictions timed, save/load with predictions equal bit
   for bit; ControllabilityMetrics.get_metrics on 64 images in bf16 (exactly
   34 rotation-forward and 204 AdaIN-forward launches, 8 configs, a finite
   controllability); the float32 kernel and plain paths' renders within a mean
   abs uint8 difference of 1.0, the same images scored identically through
   either, every per-config value within 1e-3 (widened to 4x a one-site
   rounding probe where the judge's outputs are that sensitive); and with
   per_image_tuning_iters=10 on 2 images in float32 (exactly 34, 0, 324 and
   120 launches).
13. The train() loops (their steps replays of the captured step after the
   first two), at full width (TRAIN_CONFIG, bf16, a 64-image fake
   set with exemplar distributions, loss_print_period 2, both checkpoint
   periods 3, FID/KID on 64 samples, an aml_run recorder in place of the
   loss plots): stage-1 train() for 6 steps on the checkpoint worker, its
   launch counters zeroed just before and read just after (exactly 6 steps'
   launches plus, per checkpoint, the two panels' 4 render chunks and one
   fused FID chunk), its files (checkpoints 0 and 3, both panels, whose PNG
   IHDR and JPEG SOF0 sizes are read, four loss tables of 4 rows), metrics
   at steps [0, 3] with finite KID/FID, 2 checkpoint events, steps/s and the
   checkpoint times printed; 20 full-size batches through BatchPrefetcher,
   once with its copies slowed and once with its consumer slowed, byte-equal
   to _batch_to_device (a missing stream wait, an early reuse of a pinned
   buffer or a missing record_stream fails this); attempt_reloading_checkpoint resumes at step 4 and
   train(n_steps=8) runs 4 steps and writes checkpoint 6; the same seeded
   loop with deterministic algorithms on the worker, inline, inline, on the
   worker: the step-3 weights and loss tables of each worker run equal an
   inline run's bit for bit where the two inline runs do, else within 4x
   their distance;
   stage-2 train() for 4 steps with a 64-image validation set and a
   random-weight judge saved to json (checkpoints, the autoencoding panel,
   image_metrics.txt, the controllability keys, finite values); and
   LatentGAN.train() for 60 steps on the stage-2 model's embeddings, a
   verbose log every 30 (checkpoints 0 and 30, finite KID/FID).
14. The demo path, at full width (the serving config with the reference's
   gaze and HDRI input widths, heads given weights, seeded exemplar
   distributions, a seeded LatentGAN(latent_dim=145), float32): writes a
   reference release from the port's path tables (Keras weight lists of the
   generator, the EMA generator, both discriminators, the latent regressor,
   the latent discriminator, the synthetic encoder and the real encoder with
   its ResNet50, the json, the distributions pickled under the reference's
   module, and the LatentGAN's three lists) and loads it with load_confignet
   and LatentGAN.load: every tree equal bit for bit, 32 renders identical.
   Then confignet_demo in --test_mode, each mode with its launch counters
   zeroed just before and read just after: run() with no input on that
   release (2x3 grid; exactly 3, 0, 18, 0 rotation, transpose, AdaIN-forward
   and AdaIN-backward launches), run_loop on 6 seeded 256px photo arrays
   (2x3; 1, 0, 6, 0) and on one (1x1, with one fine-tune iteration on B; 1, 0,
   12, 6), each timed; the no-input frame again on the plain path from the
   same draws, within a mean abs uint8 difference of 1.0; and affine_warp
   of 32 seeded 1024x1024x3 float32 photos to 256x256 on the card against
   the same call on the CPU (1e-4), timed.  The card has no h5py and no cv2,
   so the Keras .h5 import, HDRI fitting, generate_dataset and the demo's
   --image_path reading are covered by the CPU tests only.
15. The mesh path (data parallelism over torch.distributed, parallel/):
   (a) the native host gather (runtime/) must have built with g++; it
   gathers one stage-2 host batch's images at 256px, global batch 24, from a
   64-image fake set byte-equal to numpy indexing, both timed on the host.
   (b) A world-size-1 NCCL group, whose collectives are launched: one
   float32 stage-2 step at full width over it against mesh=None from the
   same weights, batch and draws under deterministic algorithms, losses,
   gradients and weights bit-equal (and the step without a mesh bit-equal
   to its own repeat: with --mesh-only, the process's first stage-2 step
   against its second), with step 8's launches (4, 2, 24, 12)
   and exactly 4 gradient all-reduces (one per player) and 4 sums of the
   latent regression's batch statistics (2 forward, 2 backward); a
   ConfigNetServer(mesh=...) rendering 32 latents bit-equal to the server
   without a mesh (1, 0, 6, 0 launches, one gather); fine_tune_on_img(photo,
   n_iters=2, mesh=...) ending bit-equal to the run without a mesh.  (c) Two
   ranks on the one card (NCCL takes one rank a card, so gloo), spawned
   processes: their float32 stage-2 step at global batch 24 (12 a rank)
   against the single-process step from the same weights, host batch and
   global draws, losses (the ranks' mean) within rtol 1e-3, each player's
   gradient within a relative L2 distance of 1e-3 or 4x a one-site rounding
   probe's (compare_train_paths' rule), the ranks bit-equal after the step;
   two timed steps (steps/s, peak memory a rank); their server's 32 renders
   within a mean abs uint8 difference of 1.0 of the single-process server's.
16. The 512px path, at full width (the configs above with output_shape
   (512, 512, 3): the generator adds map_2d_2c, a seventh AdaIN site of
   (65536, 16), which takes the co-resident route forward and backward):
   (a) the AdaIN forward at that site at B = 1, 12, 24 and 32 and its
   backward at B = 1 and 12, float32 and bf16, each against its plain
   version with step 3's and step 6's bounds, all on the co-resident route
   (asserted), each timed;
   (b) ConfigNetServer(chunk=32) over the bf16 serving model: encode and
   render_with_attribute 40 photos, generate 256 latents and sample 256
   through a LatentGAN, each cold and warm with exactly (1, 0, 7, 0)
   launches a generator chunk, img/s printed; the float32 kernel path
   against the plain path on 8 photos (mean abs uint8 below 1.0); (c) a
   reference release of the demo model at 512px written and loaded bit-equal
   (step 14's load_release), then confignet_demo --resolution 512 --test_mode
   in its three modes, each timed, with launches (3, 0, 21, 0), (1, 0, 7, 0)
   and (1, 0, 14, 7); (d) fine_tune_on_img on one photo, float32 and bf16, 20
   iterations of exactly (0, 0, 7, 7) launches (iters/s), and the float32
   kernel path against the plain path along one trajectory (step 10's
   rule); (e) the float32 stage-2 step (step 8's config at 512px, batch
   24): two warm-up and 2 timed steps of exactly
   (4, 2, 28, 14) launches (steps/s, peak GB), then the kernel path against
   the plain path (step 7's rule); (f) with --profile, one 512px generate
   chunk (<stem>_512_generate.txt) and a 5-iteration fine-tune call
   (<stem>_512_fine_tune.txt).
17. The bench (confignet_tpu_torch/apps/bench.py and bench_train.py).
   First each kernel against its plain version (step 3's and step 6's
   phases) at every batch and dtype the bench's rows launch it, taken from
   the bench's own constants, where no earlier phase checked it: serving's
   B=128, the bf16 train rows' 24 and 12, the 512 site at the 512px row's
   B=64 bf16.  Then every
   row at full width and reduced counts: the headline (the bf16 256px
   generator at B=256) and the 512px generator (B=64) over 2 forwards each,
   eager and replayed as one CUDA graph; stage-1 and stage-2 steps at batch 24,
   f32 and bf16, 2 timed after a warm step, through the prefetcher; the f32
   fine-tune, 5 iterations; serving's encode, splice and generate at batch
   128 in bf16, twice; the checkpoint windows of train() at 4 steps, every 2.
   Each row holds its timed window's launches (zeroed just before, read just
   after) to its path's, and must give finite rates under the JAX bench's
   metric names; the step's time is printed.
18. The captured paths (core/graphs.py, the counterpart of jax.jit's
   per-shape cache; on the card the paths of steps 4-17 run through it
   too): each path the JAX package jits, held against the same call run
   eagerly (graphs.eager()) bit for bit, at the widths above: the bf16
   256px ConfigNetServer(chunk=32)'s encode and render_with_attribute of 64
   photos, generate and sample (through a LatentGAN) of 256 latents; the
   model's generate_images (chunk 32), fused FID features (chunk 64) and
   encode_images (chunk 32); each first call (which captures) and a
   replayed call, the replayed call with exactly its chunks' launches
   (1, 0, 6, 0) a generator chunk, counted at capture and added at each
   replay, then eager and graph timed in turns (img/s), with each capture's
   time and the memory its graphs hold; fine_tune_on_img in float32 at
   256px and 512px (the 512px AdaIN backward's co-resident launch captured
   there): under deterministic algorithms two eager runs of 5 iterations
   must agree bit for bit (every loss_sum, the final embeddings, rotations
   and generator), and the captured run (one eager iteration, then
   replays) must equal them, with (0, 0, 6, 6) / (0, 0, 7, 7) launches an
   iteration; then 20 / 10 iterations (50 with --graphs-only) of each mode
   timed in turns.  Then the train steps (GraphCache.run_step): the
   stage-1 step in float32 and bfloat16, the float32 stage-2 step at 256px
   and at 512px (step 7's config, batch 24) and the LatentGAN's step (batch
   32, latent_dim 145): under deterministic algorithms, after one eager
   step, 3 steps run eagerly and the same 3 steps through the graph from
   the same state and draws must agree bit for bit (every parameter, Adam
   moment and step count, the EMA generator, every loss, the draw
   generator's state after each step, which must move at every step), with
   exactly (4, 2, 24, 12) launches a replay at 256px and (4, 2, 28, 14) at
   512px; then a capture of its own (ms, pool GB) and 2 / 1 / 50 steps of
   each mode timed in turns (steps/s; --graphs-only: 5 / 2 / 200), each
   turn's launches held.  Last, the LatentGAN's sampler
   (generate_latents_smoothed, 4 chunks of 256) against eager as the
   chunks above.  With --profile, also one captured and one eager step of
   the float32 stages and the LatentGAN (<stem>_graph_stage*.txt,
   <stem>_graph_latent_gan_*.txt): the busy shares.  The loops of steps 13
   and 16 and the train rows of step 17 run on the same replays.
19. Prints the kernels' JSON record (launches per path, times on the
   float32 train step's path and, as train_step_512, on the 512px step's),
   then as the last line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
It also exits non-zero without a CUDA device, and outside a checkout (the
package import fails).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import hashlib
import itertools
import json
import multiprocessing
import os
import socket
import struct
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.counts.kernels import (
    ADAIN_FLOPS_PER_ELEMENT, F32_FLOPS_PER_S, HBM_BYTES_PER_S, ROTATE_FLOPS_PER_ELEMENT,
    TRANSPOSE_FLOPS_PER_ELEMENT, adain_sites, bound_s)
from confignet_tpu_torch.apps import bench, bench_train, confignet_demo
from confignet_tpu_torch.core import graphs, pickles, reference_import
from confignet_tpu_torch.core.device import card_line
from confignet_tpu_torch.core.model_io import attempt_reloading_checkpoint, load_confignet
from confignet_tpu_torch.data.dataset import NeuralRendererDataset
from confignet_tpu_torch.core.transforms import _source_coords, euler_angles_to_matrix, rotate_3d_grid
from confignet_tpu_torch.data.distributions import fit_distribution
from confignet_tpu_torch.data.fake import FakeDataset
from confignet_tpu_torch.data.prefetch import BatchPrefetcher
from confignet_tpu_torch.models import generator as generator_module
from confignet_tpu_torch.models.backbones.resnet import resnet50_preprocess
from confignet_tpu_torch.ops import cuda_build
from confignet_tpu_torch.ops.launches import (LAUNCH_NAMES, launch_counts, unit_launches,
                                              zero_launch_counts)
from confignet_tpu_torch.ops.adain_cuda import (
    adain_route, device_limits, fused_adain_backward, fused_adain_backward_plain,
    fused_adain_forward, fused_adain_plain_with_stats)
from confignet_tpu_torch.ops.epilogue_cuda import conv_epilogue, conv_epilogue_plain
from confignet_tpu_torch.ops.warp import affine_warp
from confignet_tpu_torch.parallel import create_mesh
from confignet_tpu_torch.runtime import gather_images, native_available
from confignet_tpu_torch.ops.rotate_cuda import (
    device_limits as rotate_device_limits, forward_shared_bytes, launch_rotate_forward,
    launch_rotate_transpose, rotate_3d_grid_forward, rotate_3d_grid_plain, rotate_3d_grid_transpose,
    rotate_3d_grid_transpose_plain, rotate_plan, transpose_shared_bytes)
from confignet_tpu_torch.metrics.celeba_attribute_prediction import CelebaAttributeClassifier
from confignet_tpu_torch.metrics.controllability import ControllabilityMetrics
from confignet_tpu_torch.metrics.inception import InceptionFeatureExtractor, InceptionMetrics
from confignet_tpu_torch.serving import ConfigNetServer
from confignet_tpu_torch.training.first_stage import (
    DEFAULT_CONFIG, METRIC_CHUNK, RENDER_CHUNK, ConfigNetFirstStage, checkpoint_chunks)
from confignet_tpu_torch.training.latent_gan import SAMPLE_CHUNK, LatentGAN
from confignet_tpu_torch.training.second_stage import ConfigNet

# the generator's AdaIN sites, (positions, channels), as the benchmark counts them
ADAIN_SITES_256 = tuple(adain_sites(dict(DEFAULT_CONFIG, output_shape=(256, 256, 3))))
ADAIN_SITE_512 = adain_sites(dict(DEFAULT_CONFIG, output_shape=(512, 512, 3)))[-1]
SERVE_CHUNK = 32
TRUNK_EPILOGUES = 1 + 16 * 3  # a folded ResNet50 call's epilogue launches: stem, 3 a block
TRAIN_BATCH = 24  # the D updates' generator batch; the G step renders two halves of 12
TRAIN_STEPS = 3
FINE_TUNE_ITERS = 50  # bench_train.py's fine-tune flow: one photo, 50 iterations
FINE_TUNE_COMPARE_ITERS = 5
SAMPLE_N = 256  # ConfigNetServer.sample's request: 8 chunks of 32
LATENT_GAN_STEPS = 20
EVAL_IMAGES = 1000  # the evaluation dataset's images
FID_SAMPLES = 1000  # the trainer's default n_samples_for_metrics (first_stage.py:767)
FID_CHUNK = METRIC_CHUNK  # _metric_features_for_latents' chunk
JUDGE_STEPS = 10
JUDGE_PREDICTIONS = 256
CONTR_IMAGES = 64  # get_metrics without tuning: 17 generate calls of 2 chunks of 32
LOOP_IMAGES = 64  # the training loops' fake training and validation sets
LOOP_STEPS = 6  # stage-1 train(): checkpoints at steps 0 and 3
LOOP_PERIOD = 3  # both checkpoint periods of the loops
LOOP_RESUME_STEPS = 8  # the resumed stage-1 train(): steps 4..7, a checkpoint at 6
LOOP_METRIC_SAMPLES = 64  # n_samples_for_metrics: one fused FID chunk
LOOP2_STEPS = 4  # stage-2 train(): checkpoints at steps 0 and 3
PREFETCH_BATCHES = 20
GAN_LOOP_STEPS = 60
GAN_LOOP_PERIOD = 30  # verbose_log_period: checkpoints at 0 and 30
CONTR_TUNED_IMAGES = 2
CONTR_TUNING_ITERS = 10
# CelebA's 40 attributes less Wearing_Necklace and Wearing_Necktie, which the
# classifier CLI leaves out (apps/train_attribute_classifier.py:29-30), sorted
JUDGE_ATTRIBUTES = sorted([
    "5_o_Clock_Shadow", "Arched_Eyebrows", "Attractive", "Bags_Under_Eyes", "Bald", "Bangs",
    "Big_Lips", "Big_Nose", "Black_Hair", "Blond_Hair", "Blurry", "Brown_Hair", "Bushy_Eyebrows",
    "Chubby", "Double_Chin", "Eyeglasses", "Goatee", "Gray_Hair", "Heavy_Makeup",
    "High_Cheekbones", "Male", "Mouth_Slightly_Open", "Mustache", "Narrow_Eyes", "No_Beard",
    "Oval_Face", "Pale_Skin", "Pointy_Nose", "Receding_Hairline", "Rosy_Cheeks", "Sideburns",
    "Smiling", "Straight_Hair", "Wavy_Hair", "Wearing_Earrings", "Wearing_Hat",
    "Wearing_Lipstick", "Young"])
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


def bound(n_bytes: float, flops: float):
    """The benchmark's bound of a launch in ms, and what sets it."""
    by = "bytes" if n_bytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else "operations"
    return bound_s(n_bytes, flops) * 1e3, by


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


def picked_rotate_plan(volume, transpose: bool = False):
    batch, size, channels = volume.shape[0], volume.shape[1], volume.shape[4]
    return rotate_plan(batch, size, channels, volume.dtype,
                       *rotate_device_limits(volume.device.index), transpose=transpose)


def rotate_phase(batch: int, dtype, records: list):
    """The forward kernel on the slab tiles rotate_plan picks against the
    plain version, timed beside the plain version and F.grid_sample: ``ms``
    by back-to-back launches, ``device_ms`` by CUDA-graph replay."""
    grid, transform = rotation_inputs(batch, dtype, batch)
    plan = picked_rotate_plan(grid)
    got = rotate_3d_grid_forward(grid, transform)
    want = rotate_3d_grid_plain(grid, transform)
    torch.cuda.synchronize()
    err, checked = compare(got, want)

    sample_grid = grid_sample_grid(grid, transform)
    volume = grid.permute(0, 4, 1, 2, 3)

    def library():
        return F.grid_sample(volume, sample_grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    def kernel():
        return rotate_3d_grid_forward(grid, transform)

    lib_err = (library().permute(0, 2, 3, 4, 1).float() - want.float()).abs().max().item()
    elem = grid.element_size()
    n_bytes = 2 * grid.numel() * elem + transform.numel() * 4
    bound_ms, bound_by = bound(n_bytes, ROTATE_FLOPS_PER_ELEMENT * grid.numel())
    rec = dict(kernel="rotate_cuda", batch=batch, dtype=str(dtype).replace("torch.", ""),
               shape=list(grid.shape), plan=plan._asdict(), max_abs_err=err,
               checked_err=checked, library_max_abs_err=lib_err,
               ms=time_ms(kernel), device_ms=device_ms(kernel),
               plain_ms=time_ms(lambda: rotate_3d_grid_plain(grid, transform)),
               library_ms=time_ms(library), library_device_ms=device_ms(library),
               bound_ms=bound_ms, bound_by=bound_by)
    records.append(rec)
    print("phase " + json.dumps(rec), flush=True)
    if not checked <= TOL[rec["dtype"]]["rotate"]:
        raise AssertionError(f"rotate kernel disagrees with its plain version: {rec}")


def site(positions: int, channels: int) -> str:
    return f"{positions}x{channels}"


def adain_phase(batch: int, positions: int, channels: int, dtype, records: list):
    """The forward kernel on the route adain_route picks, launched twice
    (the two must be equal bit for bit: fixed-order merges), against the
    plain version, timed beside the plain version and F.group_norm +
    affine: ``ms`` by back-to-back launches, ``device_ms`` by CUDA-graph
    replay."""
    gen = torch.Generator(device="cuda").manual_seed(positions * channels + batch)
    x = (torch.randn((batch, positions, channels), generator=gen, device="cuda") * 3 + 1).to(dtype)
    scale = torch.randn((batch, channels), generator=gen, device="cuda").to(dtype)
    bias = torch.randn((batch, channels), generator=gen, device="cuda").to(dtype)
    plan = adain_route(batch, positions, channels, dtype, *device_limits(x.device.index))
    got, stats = fused_adain_forward(x, scale, bias)
    again, stats_again = fused_adain_forward(x, scale, bias)
    want, want_stats = fused_adain_plain_with_stats(x, scale, bias)
    torch.cuda.synchronize()
    repeat_equal = torch.equal(got, again) and torch.equal(stats, stats_again)
    err, checked = compare(got, want)
    stats_err = compare(stats, want_stats)[0]

    x_cf = x.transpose(1, 2).contiguous()  # group_norm's channels-first layout
    gain, shift = (scale + 1)[:, :, None], bias[:, :, None]

    def library():
        return F.group_norm(x_cf, channels, eps=1e-3) * gain + shift

    def kernel():
        return fused_adain_forward(x, scale, bias)

    elem = x.element_size()
    n_bytes = 2 * x.numel() * elem + 2 * scale.numel() * elem
    bound_ms, bound_by = bound(n_bytes, ADAIN_FLOPS_PER_ELEMENT * x.numel())
    rec = dict(kernel="adain_cuda", batch=batch, dtype=str(dtype).replace("torch.", ""),
               shape=list(x.shape), site=site(positions, channels), route=plan.route,
               plan=plan._asdict(), max_abs_err=err, checked_err=checked,
               stats_max_abs_err=stats_err, repeat_equal=repeat_equal, ms=time_ms(kernel),
               device_ms=device_ms(kernel),
               plain_ms=time_ms(lambda: fused_adain_plain_with_stats(x, scale, bias)),
               plain_device_ms=device_ms(lambda: fused_adain_plain_with_stats(x, scale, bias)),
               library_ms=time_ms(library), library_device_ms=device_ms(library),
               bound_ms=bound_ms, bound_by=bound_by)
    records.append(rec)
    print("phase " + json.dumps(rec), flush=True)
    tol = TOL[rec["dtype"]]["adain"]
    if not (repeat_equal and checked <= tol and stats_err <= 1e-4 * max(
            1.0, want_stats.abs().max().item())):
        raise AssertionError(f"AdaIN kernel disagrees with its plain version: {rec}")


def epilogue_shapes(size: int) -> list:
    """(form, (C, H, W)) of each distinct epilogue launch of a folded
    ResNet50 on ``size``-px photos: the stem's ReLU, then per stage the
    ReLU after conv1 and conv2, the first block's end with its projection
    and the other blocks' ends with the identity shortcut."""
    shapes = [("relu", (64, size // 2, size // 2))]
    side = size // 4
    for stage, width in enumerate((64, 128, 256, 512)):
        side = side if stage == 0 else side // 2
        shapes += [("relu", (width, side, side)), ("shortcut", (4 * width, side, side)),
                   ("residual", (4 * width, side, side))]
    return shapes


def epilogue_phase(size: int, batch: int, records: list, timed: bool):
    """The epilogue kernel against its plain version, which on the card is
    ATen's separate passes it replaces, bit for bit, at every shape a
    folded trunk launches it on ``size``-px photos; with ``timed``, each
    shape timed beside the plain version, with its achieved TB/s."""
    for i, (form, chw) in enumerate(epilogue_shapes(size)):
        shape = (batch, *chw)
        gen = torch.Generator(device="cuda").manual_seed(1000 * size + 10 * i + batch)
        y = torch.randn(shape, generator=gen, device="cuda")
        bias = torch.randn(chw[0], generator=gen, device="cuda")
        extra = {}
        if form == "residual":
            extra["residual"] = torch.randn(shape, generator=gen, device="cuda")
        elif form == "shortcut":
            extra.update(shortcut=torch.randn(shape, generator=gen, device="cuda"),
                         shortcut_bias=torch.randn(chw[0], generator=gen, device="cuda"))
        want = conv_epilogue_plain(y, bias, **extra)
        got = conv_epilogue(y.clone(), bias, **extra)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        rec = dict(kernel="conv_epilogue_cuda", form=form, size=size, batch=batch,
                   dtype="float32", shape=list(shape), bit_equal=equal)
        if timed:
            n_bytes = 4 * y.numel() * (2 + len([t for t in extra.values() if t.ndim == 4]))
            bound_ms, bound_by = bound(n_bytes, 3 * y.numel())
            kernel_device = device_ms(lambda: conv_epilogue(y, bias, **extra))
            rec.update(ms=time_ms(lambda: conv_epilogue(y, bias, **extra)),
                       device_ms=kernel_device, tb_per_s=n_bytes / kernel_device / 1e9,
                       plain_ms=time_ms(lambda: conv_epilogue_plain(y, bias, **extra)),
                       plain_device_ms=device_ms(lambda: conv_epilogue_plain(y, bias, **extra)),
                       bound_ms=bound_ms, bound_by=bound_by)
        records.append(rec)
        print("phase " + json.dumps(rec), flush=True)
        if not equal:
            raise AssertionError(f"epilogue kernel disagrees with its plain version: {rec}")


def transpose_phase(batch: int, dtype, records: list):
    """The transpose kernel (gradient of the resample w.r.t. the grid) on the
    owner-computes tiles rotate_plan picks, launched twice (the two must be
    equal bit for bit: fixed-order sums), against the plain version; timed
    beside the plain version and the input gradient of F.grid_sample."""
    ct, transform = rotation_inputs(batch, dtype, 1000 + batch)
    plan = picked_rotate_plan(ct, transpose=True)
    got = rotate_3d_grid_transpose(ct, transform)
    again = rotate_3d_grid_transpose(ct, transform)
    want = rotate_3d_grid_transpose_plain(ct, transform)
    torch.cuda.synchronize()
    err, checked = compare(got, want)
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

    lib_err = (library().permute(0, 2, 3, 4, 1).float() - want.float()).abs().max().item()
    elem = ct.element_size()
    n_bytes = 2 * ct.numel() * elem + transform.numel() * 4
    bound_ms, bound_by = bound(n_bytes, TRANSPOSE_FLOPS_PER_ELEMENT * ct.numel())
    rec = dict(kernel="rotate_transpose_cuda", batch=batch, dtype=str(dtype).replace("torch.", ""),
               shape=list(ct.shape), plan=plan._asdict(), max_abs_err=err,
               checked_err=checked, repeat_equal=repeat_equal,
               library_max_abs_err=lib_err, ms=time_ms(kernel), device_ms=device_ms(kernel),
               plain_ms=time_ms(lambda: rotate_3d_grid_transpose_plain(ct, transform)),
               library_ms=time_ms(library), library_device_ms=device_ms(library, stream=side),
               bound_ms=bound_ms, bound_by=bound_by)
    records.append(rec)
    print("phase " + json.dumps(rec), flush=True)
    if not (repeat_equal and checked <= TOL[rec["dtype"]]["transpose"]):
        raise AssertionError(f"transpose kernel disagrees with its plain version: {rec}")


def rotate_sweep(path: str) -> None:
    """Device time of the slab forward and the owner-computes transpose at
    the main path's shapes for each tile that fits, each checked against the
    plain version; one JSON line per tile, also written to ``path``.  The
    tiles rotate_plan prefers come from this sweep."""
    smem, _ = rotate_device_limits(0)
    rows = []
    for transpose, batch, dtype in ((False, 24, torch.float32), (False, 12, torch.float32),
                                    (False, 32, torch.bfloat16), (False, 256, torch.bfloat16),
                                    (True, 12, torch.float32), (True, 24, torch.float32),
                                    (True, 12, torch.bfloat16), (True, 32, torch.bfloat16)):
        volume, transform = rotation_inputs(batch, dtype, 7)
        plan = picked_rotate_plan(volume, transpose)
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
        for tile in [t for t in tiles if t.shared_bytes <= smem]:
            got = run(volume, transform, tile)
            checked = compare(got, want)[1]
            ms = device_ms(lambda: run(volume, transform, tile))
            row = dict(transpose=transpose, batch=batch, dtype=str(dtype).replace("torch.", ""),
                       window=tile.window, group=tile.group,
                       shared_bytes=tile.shared_bytes, device_ms=ms, checked_err=checked,
                       picked=tile == plan)
            rows.append(row)
            print("sweep " + json.dumps(row), flush=True)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(rows, indent=1))


def adain_backward_phase(batch: int, positions: int, channels: int, dtype, records: list):
    """The backward kernel against its plain version (the torch-op backward)
    on the same saved statistics, launched twice (the two results must be
    equal bit for bit: fixed-order sums); timed beside the plain version and
    the autograd backward of F.group_norm + affine."""
    gen = torch.Generator(device="cuda").manual_seed(positions * channels + batch + 7)
    x = (torch.randn((batch, positions, channels), generator=gen, device="cuda") * 3 + 1).to(dtype)
    g = torch.randn((batch, positions, channels), generator=gen, device="cuda").to(dtype)
    scale = torch.randn((batch, channels), generator=gen, device="cuda").to(dtype)
    bias = torch.zeros((batch, channels), device="cuda", dtype=dtype)
    plan = adain_route(batch, positions, channels, dtype, *device_limits(x.device.index),
                       backward=True)
    _, stats = fused_adain_forward(x, scale, bias)
    got = fused_adain_backward(x, g, stats, scale, bias.dtype)
    again = fused_adain_backward(x, g, stats, scale, bias.dtype)
    want = fused_adain_backward_plain(x, g, stats, scale, bias.dtype)
    torch.cuda.synchronize()
    repeat_equal = all(torch.equal(a, b) for a, b in zip(got, again))
    err, checked = compare(got[0], want[0])
    sums_err = max((a.float() - b.float()).abs().max().item()
                   / max(1.0, b.float().abs().max().item())
                   for a, b in zip(got[1:], want[1:]))

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
               sums_err=sums_err, repeat_equal=repeat_equal,
               ms=time_ms(kernel), device_ms=device_ms(kernel),
               plain_ms=time_ms(plain), plain_device_ms=device_ms(plain),
               library_ms=time_ms(library), library_device_ms=device_ms(library, stream=side),
               bound_ms=bound(n_bytes, 0)[0], bound_by="bytes")
    records.append(rec)
    print("phase " + json.dumps(rec), flush=True)
    tol = TOL[rec["dtype"]]["adain"]
    sums_tol = 1e-4 if dtype == torch.float32 else tol
    if not (repeat_equal and checked <= tol and sums_err <= sums_tol):
        raise AssertionError(f"AdaIN backward kernel disagrees with its plain version: {rec}")


def train_config(compute_dtype: str, **extra):
    return dict(TRAIN_CONFIG, compute_dtype=compute_dtype, **extra)


# per 256px train step, both stages: rotation forward, transpose, AdaIN
# forward (6 sites x 4 generator passes), AdaIN backward (6 sites x the G
# step's 2 halves of 12)
TRAIN_STEP_LAUNCHES = unit_launches("train_step", 256)  # (4, 2, 24, 12)
# per fine-tune iteration: the gather resample (no rotation kernel), AdaIN
# forward and backward at the 6 sites, batch 1
FINE_TUNE_ITER_LAUNCHES = unit_launches("fine_tune_iteration", 256)  # (0, 0, 6, 6)
# per generator chunk of 32 at inference: one resample, six AdaIN sites
CHUNK_LAUNCHES = unit_launches("forward", 256)  # (1, 0, 6, 0)
# the same at 512px, whose generator adds a seventh AdaIN site (map_2d_2c,
# (65536, 16) at full width, on the co-resident route): a generator chunk, a
# fine-tune iteration, a train step
CHUNK_LAUNCHES_512 = unit_launches("forward", 512)  # (1, 0, 7, 0)
FINE_TUNE_ITER_LAUNCHES_512 = unit_launches("fine_tune_iteration", 512)  # (0, 0, 7, 7)
TRAIN_STEP_LAUNCHES_512 = unit_launches("train_step", 512)  # (4, 2, 28, 14)


def check_finite(losses, label):
    for group, values in losses.items():
        for key, value in values.items():
            if not torch.isfinite(value).item():
                raise AssertionError(f"{label}: {group}/{key} = {value.item()}")


def train_run(model, dataset, label: str, card: str, kind: str, per_step=TRAIN_STEP_LAUNCHES,
              steps: int = TRAIN_STEPS):
    """Two warm-up steps (the first eager, the second capturing the step's
    CUDA graph), then ``steps`` timed steps (replays; host batches drawn
    beforehand), each with exactly ``per_step`` kernel launches.  The
    launch counters are zeroed after the warm-up; returns (the counters after
    the timed steps, the run's record, the Adam first moments of the
    generator player after the first step)."""
    batch_size = model.config["batch_size"]
    step = model._build_train_step()
    batches = [model._sample_host_batch(dataset, dataset) for _ in range(steps + 2)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    check_finite(step(batches[0]), label)
    warmup_s = time.perf_counter() - t0
    first_moments = model.first_moments()["generator"]
    t0 = time.perf_counter()
    check_finite(step(batches[1]), label)
    capture_step_s = time.perf_counter() - t0

    zero_launch_counts()
    all_losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[2:]:
        before = launch_counts()
        all_losses.append(step(batch))
        delta = tuple(after - b for after, b in zip(launch_counts(), before))
        if delta != per_step:
            raise AssertionError(f"{label}: launches {LAUNCH_NAMES} {delta} in one "
                                 f"step, expected {per_step}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    for losses in all_losses:
        check_finite(losses, label)
    rec = dict(run=label, steps=steps, batch=batch_size, seconds=seconds,
               steps_per_s=steps / seconds, img_per_s=steps * batch_size / seconds,
               warmup_s=warmup_s, capture_step_s=capture_step_s,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=dict(zip(LAUNCH_NAMES, launches)),
               last_losses={g: {k: float(v) for k, v in d.items()} for g, d in all_losses[-1].items()})
    print(f"train {label}: {steps} steps of {batch_size} in {seconds * 1e3:.1f} ms = "
          f"{rec['steps_per_s']:.3f} steps/s, {rec['img_per_s']:.1f} img/s on {kind} ({card}); "
          f"warm-up {warmup_s:.1f} s, capturing step {capture_step_s:.1f} s; peak "
          f"{rec['peak_memory_gb']:.1f} GB; launches {launches}; "
          f"loss_sum g {rec['last_losses']['g']['loss_sum']:.4f} d "
          f"{rec['last_losses']['d']['loss_sum']:.4f}", flush=True)
    return launches, rec, first_moments


def check_generator_gradients_and_ema(model, moments, ema_before, label: str) -> dict:
    """Every generator-player parameter got a nonzero gradient in the first G
    step (``moments``: with beta_1 = 0 the Adam first moment is that
    gradient) and every EMA leaf moved.  The first step is the one that
    counts: at random weights the encoder's ResNet features reach ~1e5, so
    one Adam step of the rotation head saturates its tanh and later steps
    give that head an exactly zero gradient."""
    zero = [f"{tree}/{key}" for tree, leaves in moments.items()
            for key, value in leaves.items() if not np.any(value)]
    if zero:
        raise AssertionError(f"{label}: generator-player parameters without gradient: {zero[:10]}")
    still = [k for k, v in model.generator_smoothed.state_dict().items()
             if torch.equal(v, ema_before[k])]
    if still:
        raise AssertionError(f"{label}: generator_smoothed leaves that did not move: {still[:10]}")
    n = sum(len(leaves) for leaves in moments.values())
    print(f"train {label}: all {n} generator-player parameters got a nonzero gradient; all "
          f"{len(ema_before)} generator_smoothed leaves moved", flush=True)
    return dict(generator_player_leaves=n, ema_leaves=len(ema_before))


def _rotate_plain(grid, transform):
    """The gather form with the transform's gradient stopped: the plain
    version of the kernel path's training resample, whose transform gradient
    is defined zero (stage 2 differentiates the encoder's rotations)."""
    return rotate_3d_grid(grid, transform.detach())


def _rotate_via_float64(grid, transform):
    """_rotate_plain computed in float64 and rounded once: the plain path
    with one site rounded differently (about one ulp)."""
    return rotate_3d_grid(grid.double(), transform.detach().double()).to(grid.dtype)


def pinned_draws(model, rng) -> tuple:
    """The random draws of one train step, in call order: (latents,
    rotations, flip masks).  Stage 1 draws latents for the D fakes, the
    latent-D reals and the G reals, rotations for the D fakes and the G
    reals, and flips for the D and synth-D reals; stage 2 draws only flips,
    for the D, synth-D and latent-D reals and the G reals."""
    batch = model.config["batch_size"]
    half = batch // 2
    if isinstance(model, ConfigNet):
        return [], [], [rng.random(n) < 0.5 for n in (batch,) * 3 + (batch - half,)]
    latent_dim = model.config["latent_dim"]
    latents = [rng.normal(size=(n, latent_dim)).astype(np.float32)
               for n in (batch, batch, batch - half)]
    rotations = [poses(n, rng) for n in (batch, batch - half)]
    return latents, rotations, [rng.random(batch) < 0.5 for _ in range(2)]


def pinned_step(model, batch, draws, label: str) -> tuple:
    """One train step of ``model`` on ``batch`` with its draw methods fed the
    pinned (latents, rotations, flips) of :func:`pinned_draws` (global
    arrays: over a mesh each rank cuts its rows).  Returns ({group/loss:
    float}, the Adam first moments, the gradients when beta_1 = 0)."""
    queues = [list(d) for d in draws]

    def feeder(queue):
        def draw(n):
            value = queue.pop(0)
            if value.shape[0] != n:
                raise AssertionError(f"{label}: a draw of {n} met a pinned {value.shape}")
            return torch.from_numpy(value).to(model.device)
        return draw

    model._sample_latent, model._sample_rotations, model._flip_mask = map(feeder, queues)
    try:
        losses = model._build_train_step()(batch)
    finally:
        del model._sample_latent, model._sample_rotations, model._flip_mask
    if any(queues):
        raise AssertionError(f"{label}: the step left pinned draws unused")
    return ({f"{g}/{k}": float(v) for g, d in losses.items() for k, v in d.items()},
            model.first_moments())


def train_distances(result, plain, player_trees) -> dict:
    """The largest relative error over the losses, and each player's
    relative L2 gradient distance, of one ``pinned_step`` result from
    another's (``plain``)."""
    losses, moments = result
    plain_losses, plain_moments = plain
    # a loss that is exactly zero on both paths (a saturated GAN head) agrees
    out = {"losses": max(abs(losses[k] - v) / max(abs(v), 1e-30) for k, v in plain_losses.items())}
    for player, trees in player_trees.items():
        keys = [(t, k) for t in trees for k in sorted(plain_moments[player][t])]
        a = np.concatenate([moments[player][t][k].ravel() for t, k in keys])
        b = np.concatenate([plain_moments[player][t][k].ravel() for t, k in keys])
        out[player] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    return out


def compare_train_paths(model_k, dataset, label: str, config=None,
                        launches=TRAIN_STEP_LAUNCHES) -> dict:
    """One float32 step of the kernel-path model and of a plain-path model
    of the same class (_rotate_plain, plain AdaIN) from the same weights,
    fresh optimizers, the same host batch and the same draws.

    At random weights the step's gradients amplify last-bit differences in
    the forward a long way (a deterministic rerun of one path agrees
    exactly, but changing only the rounding of one site moves the generator
    player's gradient by ~1e-2 relative L2; NVIDIA H100, this script).  So
    the bounds (1e-3 on every loss's relative error and every player's
    relative L2 gradient distance) are widened, per quantity, to 4x the
    distance of a probe: the plain path with only the resample rounded
    differently (``_rotate_via_float64``).  The kernel path changes the
    rounding at 7 sites forward and backward, the probe at one.  ``config``
    (model_k's, default the float32 training config) builds the plain-path
    models; the kernel-path step must launch exactly ``launches``."""
    config = config or train_config("float32")
    weights = model_k.get_weights()
    model_k.set_weights(weights)
    generator_module._ROTATION_IMPLS.update(gather_plain=_rotate_plain,
                                            gather_via_float64=_rotate_via_float64)
    batch = model_k._sample_host_batch(dataset, dataset)
    draws = pinned_draws(model_k, np.random.default_rng(7))

    def step(model):
        return pinned_step(model, batch, draws, label)

    results = {}
    for name, rotation in (("plain", "gather_plain"), ("probe", "gather_via_float64")):
        model = type(model_k)(dict(config, rotation_resample_train=rotation, adain_impl="plain"))
        model.set_weights(weights)
        before = launch_counts()
        results[name] = step(model)
        if launch_counts() != before:
            raise AssertionError(f"{label}: the {name}-path train step launched a kernel")
        del model
        torch.cuda.empty_cache()
    before = launch_counts()
    results["kernel"] = step(model_k)
    delta = tuple(a - b for a, b in zip(launch_counts(), before))
    if delta != launches:
        raise AssertionError(f"{label}: the kernel-path train step launched {delta}")

    def distances(name):
        return train_distances(results[name], results["plain"], model_k.PLAYER_TREES)

    kernel, probe = distances("kernel"), distances("probe")
    bounds = {k: max(1e-3, 4 * v) for k, v in probe.items()}
    print(f"train {label} kernel vs plain path (losses: max relative error; players: relative L2 "
          f"of the gradient): {json.dumps(kernel)}; one-site rounding probe vs plain path: "
          f"{json.dumps(probe)}; bounds {json.dumps(bounds)}", flush=True)
    failed = [k for k in kernel if not kernel[k] <= bounds[k]]
    if failed:
        raise AssertionError(f"{label}: kernel-path and plain-path train steps disagree on {failed}")
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


def fine_tune_run(model, photo, label: str, card: str, kind: str, iters: int = FINE_TUNE_ITERS,
                  per_iteration=FINE_TUNE_ITER_LAUNCHES):
    """One warm fine_tune_on_img call of 2 iterations (the second a replay
    of the iteration's CUDA graph, captured there), then a timed call of
    ``iters``: one eager iteration and ``iters - 1`` replays.  The graph's
    launches at capture, and the timed call's (counters zeroed just
    before), must be ``per_iteration`` an iteration.  Checks a finite final
    loss, a fine-tuned generator unlike the EMA, the EMA unchanged, and a
    server's refresh() rendering with the fine-tuned weights.  Returns (the
    counters after the timed call, the run's record)."""
    server = ConfigNetServer(model, chunk=1, device=model.device)  # snapshots the EMA generator
    ema_before = {k: v.clone() for k, v in model.generator_smoothed.state_dict().items()}
    t0 = time.perf_counter()
    model.fine_tune_on_img(photo, n_iters=2)
    warmup_s = time.perf_counter() - t0
    captured = model._graphs.launches(model._fine_tune_graph_key(False, 1))
    if captured != per_iteration:
        raise AssertionError(f"fine-tune {label}: the captured iteration launches {captured}, "
                             f"expected {per_iteration}")

    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeddings, rotations = model.fine_tune_on_img(photo, n_iters=iters)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    if launches != tuple(iters * n for n in per_iteration):
        raise AssertionError(f"fine-tune {label}: {launches} launches in the call, expected "
                             f"{per_iteration} an iteration")
    final_loss = float(model.fine_tune_losses[-1])
    if (not np.isfinite(final_loss) or embeddings.shape != (1, model.config["latent_dim"])
            or rotations.shape != (1, 3)):
        raise AssertionError(f"fine-tune {label}: loss {final_loss}, shapes {embeddings.shape} "
                             f"{rotations.shape}")
    tuned = model._fine_tuned_generator_params
    if any(not torch.equal(v, ema_before[k]) for k, v in model.generator_smoothed.state_dict().items()):
        raise AssertionError(f"fine-tune {label}: the EMA generator changed")
    if all(torch.equal(v, ema_before[k]) for k, v in tuned.items()):
        raise AssertionError(f"fine-tune {label}: the fine-tuned generator equals the EMA")

    stale = server.generate(embeddings, rotations)
    server.refresh()
    fresh = server.generate(embeddings, rotations)
    direct = model.generate_images(embeddings, rotations)
    refresh_diff = float(np.mean(np.abs(fresh.astype(int) - direct.astype(int))))
    if np.array_equal(fresh, stale) or not refresh_diff < 1.0:
        raise AssertionError(f"fine-tune {label}: refresh() did not render the fine-tuned weights "
                             f"({refresh_diff})")
    rec = dict(run=label, iters=iters, seconds=seconds, iters_per_s=iters / seconds,
               warmup_s=warmup_s, captured_launches=dict(zip(LAUNCH_NAMES, captured)),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=dict(zip(LAUNCH_NAMES, launches)), final_loss=final_loss,
               refresh_vs_generate_images=refresh_diff)
    print(f"fine-tune {label}: {iters} iterations in {seconds * 1e3:.1f} ms = "
          f"{rec['iters_per_s']:.2f} iters/s on {kind} ({card}); warm-up {warmup_s:.1f} s; peak "
          f"{rec['peak_memory_gb']:.2f} GB; launches {launches}; final loss {final_loss:.6g}; "
          f"refreshed server vs generate_images {refresh_diff:.4f}", flush=True)
    return launches, rec


def _rotate_via_float64_ft(grid, transform):
    """The fine-tune's gather form (differentiable in the transform)
    computed in float64 and rounded once: its one-site rounding probe."""
    return rotate_3d_grid(grid.double(), transform.double()).to(grid.dtype)


def fine_tune_iteration(model, state, values, images):
    """One fine-tune iteration of ``model`` (its step, its fine-tune
    generator) from the given generator weights and variable values: the
    loss, and the gradient with respect to every optimised tensor, flattened
    in float64, read from a fresh Adam's first moment (0.1 times the
    gradient after one step)."""
    generator = model._fine_tune_generator()
    generator.load_state_dict(state)
    variables = {k: v.clone().requires_grad_(True) for k, v in values.items()}
    optimizer = model._fine_tune_optimizer(generator, variables, False)
    losses, _ = model._get_fine_tune_step(False, images.shape[0])(generator, variables, optimizer,
                                                                   images)
    gradient = torch.cat([optimizer.state[p]["exp_avg"].flatten() for group in optimizer.param_groups
                          for p in group["params"]]).double() / 0.1
    return float(losses["loss_sum"]), gradient


def compare_fine_tune_paths(model_k, photo, config=None,
                            per_iteration=FINE_TUNE_ITER_LAUNCHES) -> dict:
    """Float32 fine-tune iterations with the kernels and with their plain
    versions (plain AdaIN; the gather resample either way) along one
    trajectory: FINE_TUNE_COMPARE_ITERS iterations of the plain path's
    fine-tune step from model_k's weights on ``photo``.  At each
    iteration's generator, embedding and pose, the kernel path's loss must
    agree with the plain path's within rtol 1e-3 and its gradient within a
    relative L2 distance of 1e-3, widened, where the step's own sensitivity
    to rounding exceeds it, to 4x the largest distance over the trajectory
    of a probe: the plain path with only the resample computed in float64
    (_rotate_via_float64_ft), as in compare_train_paths.  The largest, since
    one iteration's distance is a noisy sample of that sensitivity (from
    0.4e-3 to 4.5e-3 for the probe along one trajectory; NVIDIA H100, this
    script).  Then both models render the trajectory's end through
    generate_images: mean abs uint8 difference below 1.0.

    The paths are compared from one state at every iteration, not each
    along its own fine-tune, because the fine-tune is chaotic under rounding
    at random weights: Adam's first steps move every parameter by about lr
    along the sign of its gradient, and rounding sets the signs of near-zero
    gradients, so after 5 free-running iterations even the probe's render
    differs from the plain path's by about 30 uint8 (NVIDIA H100, this
    script).  ``config`` (model_k's, default the float32 serving config)
    builds the plain-path models; each kernel-path iteration must launch
    exactly ``per_iteration``."""
    config = config or serving_config("float32")
    generator_module._ROTATION_IMPLS["gather_via_float64_ft"] = _rotate_via_float64_ft
    weights = model_k.get_weights()
    models = {}
    for name in ("plain", "probe"):
        model = ConfigNet(dict(config, rotation_resample="gather", adain_impl="plain"))
        model.set_weights(weights)
        if name == "probe":
            model._generator_ft = model._generator("gather_via_float64_ft").to(model.device).eval()
        models[name] = model
    models["kernel"] = model_k
    plain = models["plain"]

    images = (photo[np.newaxis] / 127.5 - 1.0).astype(np.float32)
    variables = plain._fine_tune_variables(*plain.encode_images(images), False)
    images = torch.from_numpy(images).to(plain.device)
    trajectory = plain._generator("gather").to(plain.device).eval()
    trajectory.load_state_dict(plain.generator_smoothed.state_dict())
    optimizer = plain._fine_tune_optimizer(trajectory, variables, False)
    step = plain._get_fine_tune_step(False, 1)
    kernel = dict(losses=[], gradients=[])
    probe = dict(losses=[], gradients=[])
    plain_losses = []
    for _ in range(FINE_TUNE_COMPARE_ITERS):
        state = {k: v.detach().clone() for k, v in trajectory.state_dict().items()}
        values = {k: v.detach().clone() for k, v in variables.items()}
        results = {}
        for name, model in models.items():
            before = launch_counts()
            results[name] = fine_tune_iteration(model, state, values, images)
            delta = tuple(a - b for a, b in zip(launch_counts(), before))
            if delta != (per_iteration if name == "kernel" else (0, 0, 0, 0)):
                raise AssertionError(f"the {name}-path fine-tune iteration launched {delta}")
        plain_loss, plain_gradient = results["plain"]
        plain_losses.append(plain_loss)
        for name, out in (("kernel", kernel), ("probe", probe)):
            loss, gradient = results[name]
            out["losses"].append(abs(loss - plain_loss) / abs(plain_loss))
            out["gradients"].append((torch.linalg.norm(gradient - plain_gradient)
                                     / torch.linalg.norm(plain_gradient)).item())
        step(trajectory, variables, optimizer, images)

    with torch.no_grad():
        embeddings = plain._fine_tune_embeddings(variables, 1).float().cpu().numpy()
    rotations = variables["rotations"].detach().float().cpu().numpy()
    tuned = {k: v.detach().clone() for k, v in trajectory.state_dict().items()}
    if all(torch.equal(v, plain.generator_smoothed.state_dict()[k]) for k, v in tuned.items()):
        raise AssertionError("the fine-tune trajectory left the generator unchanged")
    renders = {}
    for name in ("plain", "kernel"):
        models[name]._fine_tuned_generator_params = tuned
        renders[name] = models[name].generate_images(embeddings, rotations)
    kernel["e2e_mean_abs_uint8"] = float(np.mean(np.abs(renders["kernel"].astype(int)
                                                        - renders["plain"].astype(int))))
    gradient_bound = max(1e-3, 4 * max(probe["gradients"]))
    bounds = dict(losses=[1e-3] * FINE_TUNE_COMPARE_ITERS,
                  gradients=[gradient_bound] * FINE_TUNE_COMPARE_ITERS, e2e_mean_abs_uint8=1.0)
    print(f"fine-tune float32 kernel vs plain path, {FINE_TUNE_COMPARE_ITERS} iterations from the "
          f"plain path's states (losses: relative error; gradients: relative L2; final render: mean "
          f"abs uint8 difference): {json.dumps(kernel)}; one-site rounding probe vs plain path: "
          f"{json.dumps(probe)}; bounds {json.dumps(bounds)}; plain losses {json.dumps(plain_losses)}",
          flush=True)
    if not (all(d <= b for d, b in zip(kernel["losses"], bounds["losses"]))
            and all(d <= b for d, b in zip(kernel["gradients"], bounds["gradients"]))
            and kernel["e2e_mean_abs_uint8"] <= bounds["e2e_mean_abs_uint8"]
            and renders["kernel"].std() > 0):
        raise AssertionError(f"fine-tune kernel and plain paths disagree: {kernel}; bounds {bounds}")
    return dict(plain_losses=plain_losses, kernel_vs_plain=kernel, probe_vs_plain=probe,
                bounds=bounds)


def counted(fn, expected, label: str):
    """fn() with the launch counters zeroed just before and read just after;
    they must equal ``expected``.  Returns (fn's result, the counters)."""
    zero_launch_counts()
    out = fn()
    launches = launch_counts()
    if launches != expected:
        raise AssertionError(f"{label}: launches {LAUNCH_NAMES} {launches}, expected {expected}")
    return out, launches


def check_renders(imgs, n: int, label: str, size: int = 256) -> None:
    if imgs.shape != (n, size, size, 3) or imgs.dtype != np.uint8:
        raise AssertionError(f"{label} gave {imgs.shape} {imgs.dtype}")
    if imgs.std() == 0 or np.all(imgs[0] == imgs[1]):
        raise AssertionError(f"{label} gave constant images")


def unequal_leaves(a, b) -> list:
    """The tree/key of every leaf of two get_weights() results that differs
    (a missing tree or key counts)."""
    if set(a) != set(b) or any(set(a[t]) != set(b[t]) for t in a):
        return ["the trees or their keys differ"]
    return [f"{t}/{k}" for t, leaves in a.items() for k, v in leaves.items()
            if not np.array_equal(v, b[t][k])]


def round_trip_confignet(model, directory: str):
    """save() then load_confignet(): every weight tree equal bit for bit,
    the log and the distributions' draws equal, and 32 renders identical."""
    t0 = time.perf_counter()
    model.save(directory, "confignet")
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_confignet(os.path.join(directory, "confignet.json"))
    load_s = time.perf_counter() - t0
    if type(loaded) is not ConfigNet or loaded.device != model.device:
        raise AssertionError(f"load_confignet gave a {type(loaded).__name__} on {loaded.device}")
    saved = model.get_weights()
    unequal = unequal_leaves(saved, loaded.get_weights())
    if unequal:
        raise AssertionError(f"the reloaded weights differ: {unequal[:10]}")
    if loaded.get_log_dict() != model.get_log_dict():
        raise AssertionError("the reloaded log differs")
    draws = []
    for m in (model, loaded):
        np.random.seed(1)
        draws.append(b"".join(p.tobytes() for p in m.sample_facemodel_params(4)))
    np.random.seed(2)
    latents = np.random.normal(size=(SERVE_CHUNK, model.config["latent_dim"])).astype(np.float32)
    rotations = model.sample_rotations(SERVE_CHUNK)
    same_renders = np.array_equal(model.generate_images(latents, rotations),
                                  loaded.generate_images(latents, rotations))
    if draws[0] != draws[1] or not same_renders:
        raise AssertionError(f"the reloaded model differs: distributions {draws[0] == draws[1]}, "
                             f"renders {same_renders}")
    n_leaves = sum(len(leaves) for leaves in saved.values())
    print(f"sample: saved the float32 serving model in {save_s:.2f} s and reloaded it in "
          f"{load_s:.2f} s; all {n_leaves} leaves of {len(saved)} trees equal bit for bit, the "
          f"log and distributions equal, {SERVE_CHUNK} renders identical", flush=True)
    return loaded, dict(save_s=save_s, load_s=load_s, leaves=n_leaves, trees=len(saved))


def latent_gan_run(confignet, dataset, directory: str, card: str, kind: str,
                   profile_path=None):
    """A LatentGAN(latent_dim=145) with the default config (batch 32) on the
    embeddings of ``dataset.imgs``: two warm-up steps (eager, then the
    capture of the step's CUDA graph) and LATENT_GAN_STEPS timed replays
    (finite losses with the JAX package's keys, a generator that moved), then
    save() / LatentGAN.load() with generate_latents_smoothed equal bit for
    bit; with ``profile_path``, one more step profiled.  Returns (the GAN,
    the run's record)."""
    gan = LatentGAN({"latent_dim": confignet.config["latent_dim"]})
    t0 = time.perf_counter()
    embeddings = gan.extract_embeddings(confignet, dataset)
    embed_s = time.perf_counter() - t0
    if not np.isfinite(embeddings).all() or embeddings[:, 0].std() == 0:
        raise AssertionError("extract_embeddings gave non-finite or equal embeddings")
    real = torch.from_numpy(embeddings).to(gan.device)
    idx = np.random.default_rng(3).integers(0, len(embeddings), (LATENT_GAN_STEPS + 2, 32))
    batches = [real[torch.from_numpy(i).to(gan.device)] for i in idx]
    before = gan.get_weights()["generator"]
    step = gan._build_train_step()
    for batch in batches[:2]:
        check_finite(step(batch), "latent GAN")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    all_losses = [step(batch) for batch in batches[2:]]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for losses in all_losses:
        check_finite(losses, "latent GAN")
    keys = set(all_losses[-1]["d"])
    if keys != {"GAN_loss_real", "GAN_loss_fake", "gp_loss", "loss_sum"}:
        raise AssertionError(f"latent GAN D losses {sorted(keys)}")
    after = gan.get_weights()["generator"]
    if all(np.array_equal(after[k], v) for k, v in before.items()):
        raise AssertionError("the latent GAN's generator did not move")

    gan.save(directory, "latent_gan")
    loaded = LatentGAN.load(os.path.join(directory, "latent_gan.json"))
    noise = np.random.default_rng(4).normal(size=(SAMPLE_N, gan.config["latent_dim"]))
    if not np.array_equal(loaded.generate_latents_smoothed(noise), gan.generate_latents_smoothed(noise)):
        raise AssertionError("the reloaded latent GAN samples other latents")
    last = {g: {k: float(v) for k, v in d.items()} for g, d in all_losses[-1].items()}
    rec = dict(steps=LATENT_GAN_STEPS, batch=gan.config["batch_size"], seconds=seconds,
               steps_per_s=LATENT_GAN_STEPS / seconds, extract_embeddings_s=embed_s,
               last_losses=last)
    print(f"sample: latent GAN {LATENT_GAN_STEPS} steps of {rec['batch']} in {seconds * 1e3:.1f} ms "
          f"= {rec['steps_per_s']:.1f} steps/s on {kind} ({card}); embeddings of {len(embeddings)} photos "
          f"in {embed_s:.2f} s; loss_sum d {last['d']['loss_sum']:.4f} g {last['g']['loss_sum']:.4f}; "
          f"save/load: generate_latents_smoothed equal bit for bit", flush=True)
    if profile_path:
        profile(f"latent GAN step (batch {rec['batch']})", lambda: step(batches[0]), profile_path)
    return gan, rec


def sampling_path(card: str, kind: str, profile_stem=None):
    """Step 11: checkpoint files, the LatentGAN and photo-free sampling at
    full width; with ``profile_stem``, a LatentGAN step and one sampled
    chunk are profiled into ``<profile_stem>_latent_gan.txt`` and
    ``_sample.txt``.  Returns (the sample call's launch counters, the
    record)."""
    dataset = FakeDataset(64, 256, {}, seed=11)
    rng = np.random.default_rng(11)
    model = ConfigNet(serving_config("float32"))
    give_encoder_heads_weights(model, dataset.imgs[:SERVE_CHUNK])
    model.facemodel_param_distributions = {
        name: fit_distribution(rng.normal(size=(256, dims[0])), "GMM")
        for name, dims in model.config["facemodel_inputs"].items()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as directory:
        loaded, files = round_trip_confignet(model, directory)
        del model
        gan, gan_rec = latent_gan_run(loaded, dataset, directory, card, kind,
                                      profile_stem and profile_stem + "_latent_gan.txt")

    # photo-free sampling, bfloat16, warm
    model16 = ConfigNet(serving_config("bfloat16"), initialize=False)
    model16.set_weights(loaded.get_weights())
    server = ConfigNetServer(model16, gan, chunk=SERVE_CHUNK)
    rotations = model16.sample_rotations(SAMPLE_N)
    chunks = SAMPLE_N // SERVE_CHUNK
    expected = tuple(chunks * n for n in CHUNK_LAUNCHES)
    t0 = time.perf_counter()
    counted(lambda: server.sample(SAMPLE_N, rotations=rotations, truncation=0.7), expected,
            "sample (cold)")
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    imgs, launches = counted(lambda: server.sample(SAMPLE_N, rotations=rotations, truncation=0.7),
                             expected, "sample")
    seconds = time.perf_counter() - t0
    check_renders(imgs, SAMPLE_N, "sample")
    print(f"sample: {SAMPLE_N} images in {seconds * 1e3:.1f} ms = {SAMPLE_N / seconds:.1f} img/s "
          f"(warm; cold {SAMPLE_N / cold_s:.1f}) at 256px bfloat16, chunk {SERVE_CHUNK}, "
          f"truncation 0.7 on {kind} ({card}); launches {launches}", flush=True)
    if profile_stem:
        profile(f"sample chunk {SERVE_CHUNK} (bfloat16)", lambda: server.sample(
            SERVE_CHUNK, rotations=rotations[:SERVE_CHUNK], truncation=0.7), profile_stem + "_sample.txt")
    del server, model16

    # face-model parameters -> synthetic encoder -> generator, float32
    facemodel_imgs, _ = counted(lambda: loaded.generate_images_from_facemodel(
        loaded.sample_facemodel_params(SERVE_CHUNK), rotations[:SERVE_CHUNK]), CHUNK_LAUNCHES,
        "generate_images_from_facemodel")
    check_renders(facemodel_imgs, SERVE_CHUNK, "generate_images_from_facemodel")

    # the same sampled latents through the kernels and the plain path, float32
    latents = gan.generate_latents(SERVE_CHUNK, truncation=0.7)
    plain = ConfigNet(serving_config("float32", rotation_resample="gather", adain_impl="plain"),
                      initialize=False)
    plain.set_weights(loaded.get_weights())
    out_p, _ = counted(lambda: plain.generate_images(latents, rotations[:SERVE_CHUNK]),
                       (0, 0, 0, 0), "sample plain path")
    out_k, _ = counted(lambda: loaded.generate_images(latents, rotations[:SERVE_CHUNK]),
                       CHUNK_LAUNCHES, "sample kernel path")
    diff = np.abs(out_k.astype(int) - out_p.astype(int))
    e2e = float(diff.mean())
    print(f"sample float32 kernel vs plain path: mean abs uint8 difference {e2e:.4f} (max "
          f"{int(diff.max())}), bound 1.0", flush=True)
    if not e2e < 1.0 or out_k.std() == 0:
        raise AssertionError(f"sampled renders: kernel path and plain path disagree: {e2e}")
    rec = dict(files=files, latent_gan=gan_rec, images=SAMPLE_N, seconds=seconds,
               img_per_s=SAMPLE_N / seconds, cold_img_per_s=SAMPLE_N / cold_s,
               launches=dict(zip(LAUNCH_NAMES, launches)), e2e_mean_abs_uint8=e2e)
    return launches, rec


def eval_config(compute_dtype: str, **extra):
    """The serving config with the beard embedding given its 9 PCA dims, the
    length of the controllability configs' beard exemplars
    (metrics/controllability_metric_configs.py); latent_dim stays 145."""
    config = serving_config(compute_dtype, **extra)
    config["facemodel_inputs"]["beard_style_embedding"] = (9, 7)
    return config


def eval_model(compute_dtype: str, weights=None, **extra):
    """A ConfigNet of eval_config with the evaluation's weights (seed 0, the
    encoder heads given weights, or ``weights``) and seeded Gaussian
    face-model distributions."""
    model = ConfigNet(eval_config(compute_dtype, **extra), initialize=weights is None)
    if weights is None:
        give_encoder_heads_weights(model, FakeDataset(SERVE_CHUNK, model.config["output_shape"][0],
                                                      {}, seed=12).imgs)
    else:
        model.set_weights(weights)
    rng = np.random.default_rng(12)
    model.facemodel_param_distributions = {
        name: fit_distribution(rng.normal(size=(256, dims[0])), "GMM")
        for name, dims in model.config["facemodel_inputs"].items()}
    return model


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def contr_launches(n_images: int, tuning_iters: int = 0):
    """ControllabilityMetrics.get_metrics: 17 generate_images calls (the raw
    renders, then 8 configs set and not set) of ceil(n / 32) chunks, or with
    tuning, per image a fine-tune and 17 calls of one chunk."""
    if tuning_iters == 0:
        return tuple(17 * -(-n_images // SERVE_CHUNK) * c for c in CHUNK_LAUNCHES)
    return tuple(n_images * (tuning_iters * f + 17 * c)
                 for f, c in zip(FINE_TUNE_ITER_LAUNCHES, CHUNK_LAUNCHES))


def evaluation_dataset(directory: str):
    """EVAL_IMAGES seeded uint8 images in a NeuralRendererDataset memmap with
    seeded labels for JUDGE_ATTRIBUTES; saved, loaded back (equal), and its
    Inception features computed (bf16), timed.  Returns (the loaded
    dataset, its record)."""
    size = eval_config("float32")["output_shape"][0]
    rng = np.random.default_rng(12)
    dataset = NeuralRendererDataset((size, size, 3), is_synthetic=False)
    path = os.path.join(directory, "eval_set.pck")
    dataset._initialize_imgs_memmap(EVAL_IMAGES, path)
    dataset.imgs[:] = rng.integers(0, 256, dataset.imgs.shape, dtype=np.uint8)
    labels = rng.random((EVAL_IMAGES, len(JUDGE_ATTRIBUTES))) < 0.5
    dataset.attributes = [dict(zip(JUDGE_ATTRIBUTES, map(int, row))) for row in labels]
    dataset.imgs.flush()
    dataset.save(path)
    loaded = NeuralRendererDataset.load(path)
    if not (np.array_equal(loaded.imgs, dataset.imgs) and loaded.attributes == dataset.attributes
            and loaded.img_shape == dataset.img_shape):
        raise AssertionError("the reloaded evaluation dataset differs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded._compute_inception_features()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    features = loaded.inception_features
    if features.shape != (EVAL_IMAGES, 2048) or not np.isfinite(features).all() or features.std() == 0:
        raise AssertionError(f"dataset inception features {features.shape}")
    print(f"evaluate: dataset of {EVAL_IMAGES} {size}px images saved and reloaded (equal); "
          f"_compute_inception_features (bf16, extractor built in the call) in {seconds:.2f} s = "
          f"{EVAL_IMAGES / seconds:.1f} img/s", flush=True)
    return loaded, dict(images=EVAL_IMAGES, inception_s=seconds,
                        inception_img_per_s=EVAL_IMAGES / seconds)


def fid_run(model, dataset, card: str, kind: str):
    """The trainer's FID/KID at bf16: InceptionMetrics on the dataset and
    the fused features of FID_SAMPLES sampled latents in chunks of
    FID_CHUNK, cold and warm, each with the launches of one generator chunk
    per chunk.  Returns (the latents, rotations, launches, the record)."""
    model._inception_metric_object = InceptionMetrics(model.config, dataset, FID_SAMPLES)
    np.random.seed(12)
    latents = model.sample_latent_vector(FID_SAMPLES)
    rotations = model.sample_rotations(FID_SAMPLES)
    expected = tuple(-(-FID_SAMPLES // FID_CHUNK) * c for c in CHUNK_LAUNCHES)
    run = lambda: model._metric_features_for_latents(latents, rotations, batch_chunk=FID_CHUNK)  # noqa: E731
    t0 = time.perf_counter()
    counted(run, expected, "fused FID features (cold)")
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    features, launches = counted(run, expected, "fused FID features")
    seconds = time.perf_counter() - t0
    kid, fid = model._inception_metric_object.get_metrics(features=features)
    if features.shape != (FID_SAMPLES, 2048) or not (np.isfinite(kid) and np.isfinite(fid)):
        raise AssertionError(f"fused FID features {features.shape}: KID {kid}, FID {fid}")
    print(f"evaluate: fused FID features of {FID_SAMPLES} latents in {seconds * 1e3:.1f} ms = "
          f"{FID_SAMPLES / seconds:.1f} features/s (warm; cold {FID_SAMPLES / cold_s:.1f}) at "
          f"{model.config['output_shape'][0]}px bfloat16, chunk {FID_CHUNK}, on {kind} ({card}); "
          f"launches {launches}; KID {kid:.6g}, "
          f"FID {fid:.6g}", flush=True)
    return latents, rotations, launches, dict(
        samples=FID_SAMPLES, chunk=FID_CHUNK, seconds=seconds, features_per_s=FID_SAMPLES / seconds,
        cold_features_per_s=FID_SAMPLES / cold_s, launches=dict(zip(LAUNCH_NAMES, launches)),
        kid=kid, fid=fid)


def compare_fid_paths(weights, metric_object, latents, rotations) -> dict:
    """float32 fused features of the kernel path and of the plain path
    (gather rotation, plain AdaIN) from the same weights and latents, and of
    get_features(generate_images(...), max_chunk_size=FID_CHUNK) on the
    kernel path, each through a float32 Inception with the metric object's
    weights: each within a relative L2 distance of 1e-3.  (The bf16
    Inception moves its features by ~1.7e-3 under any change of the uint8
    images, so it could not tell a wrong kernel from rounding.)"""
    extractor = InceptionFeatureExtractor(metric_object.inception_feature_extractor.input_shape,
                                          dtype=torch.float32)
    metric_object = copy.copy(metric_object)
    metric_object.inception_feature_extractor = extractor
    features = {}
    for name, extra in (("plain", dict(rotation_resample="gather", adain_impl="plain")),
                        ("kernel", {})):
        model = eval_model("float32", weights, **extra)
        model._inception_metric_object = metric_object
        expected = (0, 0, 0, 0) if extra else tuple(
            -(-len(latents) // FID_CHUNK) * c for c in CHUNK_LAUNCHES)
        features[name], _ = counted(lambda: model._metric_features_for_latents(
            latents, rotations, batch_chunk=FID_CHUNK), expected, f"fused FID features ({name})")
        if name == "kernel":
            renders = model.generate_images(latents, rotations)
            features["separate"] = extractor.get_features(renders, max_chunk_size=FID_CHUNK)
        del model
        torch.cuda.empty_cache()
    out = dict(kernel_vs_plain=rel_l2(features["kernel"], features["plain"]),
               fused_vs_separate=rel_l2(features["kernel"], features["separate"]), bound=1e-3)
    print(f"evaluate float32 fused features (float32 Inception), relative L2: kernel vs plain "
          f"path {out['kernel_vs_plain']:.6g}, fused vs get_features(generate_images) "
          f"{out['fused_vs_separate']:.6g}; bound {out['bound']:.6g}", flush=True)
    if not (out["kernel_vs_plain"] <= out["bound"] and out["fused_vs_separate"] <= out["bound"]):
        raise AssertionError(f"fused FID features disagree: {out}")
    return out


def judge_run(dataset, directory: str, card: str, kind: str):
    """The attribute classifier at full width (256px, the 38 attributes,
    batch 32, trainable trunk norms): one warm-up and JUDGE_STEPS timed train
    steps through the step function, recalibrate_batch_stats(dataset, 10),
    predict_attributes on JUDGE_PREDICTIONS images (warm, timed), then
    save / load with predictions equal bit for bit.  Returns (the reloaded
    classifier, the record)."""
    size = dataset.img_shape[0]
    clf = CelebaAttributeClassifier({"input_shape": (size, size, 3),
                                     "predicted_attributes": JUDGE_ATTRIBUTES, "batch_size": 32,
                                     "trainable_bn": True})
    np.random.seed(12)
    batches = [tuple(torch.from_numpy(a).to(clf.device) for a in clf.sample_batch_from_dataset(dataset))
               for _ in range(JUDGE_STEPS + 1)]
    step = clf._build_train_step()
    results = [step(*batches[0])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results += [step(*batch) for batch in batches[1:]]
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    losses = [float(loss) for loss, _ in results]
    if not np.isfinite(losses).all():
        raise AssertionError(f"attribute classifier losses {losses}")
    clf.recalibrate_batch_stats(dataset, 10)
    imgs = np.asarray(dataset.imgs[:JUDGE_PREDICTIONS])
    clf.predict_attributes(imgs)
    t0 = time.perf_counter()
    predictions = clf.predict_attributes(imgs)
    predict_s = time.perf_counter() - t0
    if predictions.shape != (JUDGE_PREDICTIONS, len(JUDGE_ATTRIBUTES)) or not (
            np.isfinite(predictions).all() and predictions.std() > 0):
        raise AssertionError(f"predictions {predictions.shape}")
    clf.save(directory, "judge")
    loaded = CelebaAttributeClassifier.load(os.path.join(directory, "judge.json"))
    if not np.array_equal(loaded.predict_attributes(imgs), predictions):
        raise AssertionError("the reloaded attribute classifier predicts otherwise")
    rec = dict(steps=JUDGE_STEPS, batch=32, steps_per_s=JUDGE_STEPS / step_s,
               predictions=JUDGE_PREDICTIONS, predictions_per_s=JUDGE_PREDICTIONS / predict_s,
               losses=losses)
    print(f"evaluate: attribute classifier ({len(JUDGE_ATTRIBUTES)} attributes, {size}px, trainable "
          f"BN) {JUDGE_STEPS} steps of 32 in {step_s * 1e3:.1f} ms = {rec['steps_per_s']:.2f} steps/s; "
          f"{JUDGE_PREDICTIONS} predictions in {predict_s * 1e3:.1f} ms = "
          f"{rec['predictions_per_s']:.1f}/s on {kind} ({card}); losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; save/load: predictions equal bit for bit", flush=True)
    return loaded, rec


def check_contr_metrics(metrics, label: str) -> None:
    tuples = [k for k, v in metrics.items() if k.endswith("_config")]
    if len(tuples) != 8 or not np.isfinite(metrics["controllability"]):
        raise AssertionError(f"{label}: configs {tuples}, controllability {metrics['controllability']}")


def contr_run(model, judge, imgs, tuning_iters: int, label: str, card: str, kind: str,
              profile_path=None):
    """ControllabilityMetrics(model, judge, tuning_iters).get_metrics(imgs),
    timed, with the launches contr_launches gives; with ``profile_path``,
    one more call profiled.  Returns (launches, the record)."""
    metrics_obj = ControllabilityMetrics(model, judge, per_image_tuning_iters=tuning_iters)
    np.random.seed(13)
    t0 = time.perf_counter()
    metrics, launches = counted(lambda: metrics_obj.get_metrics(imgs),
                                contr_launches(len(imgs), tuning_iters), label)
    seconds = time.perf_counter() - t0
    model._fine_tuned_generator_params = None
    check_contr_metrics(metrics, label)
    print(f"evaluate: {label}: {len(imgs)} images in {seconds * 1e3:.1f} ms = "
          f"{len(imgs) / seconds:.2f} img/s on {kind} ({card}); launches {launches}; "
          f"controllability {metrics['controllability']:.6g}", flush=True)
    if profile_path:
        profile(label, lambda: metrics_obj.get_metrics(imgs), profile_path)
    return launches, dict(images=len(imgs), tuning_iters=tuning_iters, seconds=seconds,
                          img_per_s=len(imgs) / seconds, launches=dict(zip(LAUNCH_NAMES, launches)),
                          controllability=metrics["controllability"])


def compare_contr_paths(weights, judge, imgs) -> dict:
    """The controllability renders and metrics of the float32 kernel path and
    of the plain path from the same weights after the same np.random seed:
    every render within a mean abs uint8 difference of 1.0; the same uint8
    images scored through either model's metric object give identical
    tuples (a check of the judge); every per-config value of the two full
    runs within 1e-3 absolute, widened to 4x a one-site rounding probe (the
    plain path with the resample rounded once from float64) where the
    judge's outputs are that sensitive.  The probe's largest change to any
    value sets the one bound: a single config's change is one draw of the
    same rounding noise (NVIDIA H100: 5e-5 to 1.2e-3 across the configs of
    one probe)."""
    generator_module._ROTATION_IMPLS.update(gather_via_float64=_rotate_via_float64)
    runs = {}
    for name, extra in (("plain", dict(rotation_resample="gather", adain_impl="plain")),
                        ("probe", dict(rotation_resample="gather_via_float64", adain_impl="plain")),
                        ("kernel", {})):
        model = eval_model("float32", weights, **extra)
        metrics_obj = ControllabilityMetrics(model, judge)
        np.random.seed(14)
        expected = (0, 0, 0, 0) if extra else contr_launches(len(imgs))
        renders, _ = counted(lambda: metrics_obj.generate_images_for_metric(imgs), expected,
                             f"controllability renders ({name})")
        runs[name] = (metrics_obj, renders, metrics_obj.get_metrics_from_attribute_images(*renders[1:]))
        del model
        torch.cuda.empty_cache()

    def pairs(renders):
        raw, with_attr, without_attr = renders
        return [("raw", raw)] + [(f"{k}+", v) for k, v in with_attr.items()] + \
            [(f"{k}-", v) for k, v in without_attr.items()]

    diffs = {k: float(np.abs(a.astype(int) - b.astype(int)).mean())
             for (k, a), (_, b) in zip(pairs(runs["kernel"][1]), pairs(runs["plain"][1]))}
    same_images = runs["plain"][0].get_metrics_from_attribute_images(*runs["kernel"][1][1:])
    judge_identical = all(np.array_equal(v, runs["kernel"][2][k], equal_nan=True)
                          for k, v in same_images.items())

    def deltas(name):
        """Max abs difference of each value from the plain path's (a
        correlation that is NaN on both sides, from constant predictions,
        agrees)."""
        out = {}
        for k, v in runs[name][2].items():
            a, b = np.asarray(v, np.float64), np.asarray(runs["plain"][2][k], np.float64)
            out[k] = float(np.max(np.where(np.isnan(a) & np.isnan(b), 0.0, np.abs(a - b))))
        return out

    kernel, probe = deltas("kernel"), deltas("probe")
    bound = max(1e-3, 4 * max(probe.values()))
    worst = max(diffs, key=diffs.get)
    print(f"evaluate float32 controllability kernel vs plain path: renders mean abs uint8 difference "
          f"up to {diffs[worst]:.4f} ({worst}), bound 1.0; the same images through either model "
          f"{'identical' if judge_identical else 'DIFFER'}; per-config max abs difference "
          f"{json.dumps(kernel)}; one-site rounding probe {json.dumps(probe)}; bound {bound:.6g}",
          flush=True)
    failed = [k for k in kernel if not kernel[k] <= bound]
    if not (diffs[worst] < 1.0 and judge_identical) or failed:
        raise AssertionError(f"controllability kernel and plain paths disagree: {failed}")
    return dict(render_mean_abs_uint8=diffs, kernel_vs_plain=kernel, probe_vs_plain=probe,
                bound=bound)


def evaluation_path(card: str, kind: str, profile_stem=None):
    """Step 12: the evaluation dataset, FID/KID through the fused path, the
    attribute judge and the controllability metric at full width; with
    ``profile_stem``, one fused FID chunk and one controllability request
    are profiled into ``<profile_stem>_fid.txt`` and ``_contr.txt``.
    Returns (the launches of the evaluation's kernel runs, summed, the
    record)."""
    t_step = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as directory:
        dataset, dataset_rec = evaluation_dataset(directory)
        model = eval_model("bfloat16")
        weights = model.get_weights()
        latents, rotations, fid_launches, fid_rec = fid_run(model, dataset, card, kind)
        if profile_stem:
            profile(f"fused FID chunk {FID_CHUNK} (bfloat16)", lambda: model._metric_features_for_latents(
                latents[:FID_CHUNK], rotations[:FID_CHUNK]), profile_stem + "_fid.txt")
        fid_paths = compare_fid_paths(weights, model._inception_metric_object, latents, rotations)
        judge, judge_rec = judge_run(dataset, directory, card, kind)

        imgs = np.asarray(dataset.imgs[:CONTR_IMAGES])
        contr_counts, contr_rec = contr_run(
            model, judge, imgs, 0, "controllability (bfloat16, no tuning)", card, kind,
            profile_stem and profile_stem + "_contr.txt")
        del model
        torch.cuda.empty_cache()
        contr_paths = compare_contr_paths(weights, judge, imgs)
        model = eval_model("float32", weights)
        tuned_launches, tuned_rec = contr_run(
            model, judge, imgs[:CONTR_TUNED_IMAGES], CONTR_TUNING_ITERS,
            f"controllability (float32, {CONTR_TUNING_ITERS} tuning iterations)", card, kind)
        del model
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_step
    print(f"evaluate: step 12 took {seconds:.1f} s", flush=True)
    launches = tuple(map(sum, zip(fid_launches, contr_counts, tuned_launches)))
    return launches, dict(dataset=dataset_rec, fid=fid_rec, fid_paths=fid_paths, judge=judge_rec,
                          contr=contr_rec, contr_paths=contr_paths, contr_tuned=tuned_rec,
                          seconds=seconds)


class SinkRecorder:
    """An ``aml_run`` stand-in: records ``log(name, value)``.  With a sink the
    loops write no matplotlib plots (as in the JAX package), which this
    machine could not draw."""

    def __init__(self):
        self.calls = []

    def log(self, name, value):
        self.calls.append((name, value))

    def values(self, name):
        return [v for n, v in self.calls if n == name]


def loop_config(compute_dtype: str, **extra):
    return train_config(compute_dtype, loss_print_period=2, image_checkpoint_period=LOOP_PERIOD,
                        metrics_checkpoint_period=LOOP_PERIOD, **extra)


def loop_dataset(config, seed: int):
    """LOOP_IMAGES fake images of the config's size with metadata and
    exemplar distributions of it (setup_training stores the distributions in
    the checkpoints)."""
    dataset = FakeDataset(LOOP_IMAGES, config["output_shape"][0],
                          {k: v[0] for k, v in config["facemodel_inputs"].items()}, seed)
    dataset.metadata_input_distributions = {
        name: fit_distribution(values, "exemplar") for name, values in dataset.metadata_inputs.items()}
    return dataset


def loop_launches(steps: int, checkpoints: int, render_chunks: int):
    """Launches of ``steps`` train steps and ``checkpoints`` checkpoints of
    ``render_chunks`` generator chunks each."""
    return tuple(steps * t + checkpoints * render_chunks * c
                 for t, c in zip(TRAIN_STEP_LAUNCHES, CHUNK_LAUNCHES))


def png_size(path) -> tuple:
    """(height, width) from a PNG's IHDR chunk."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    width, height = struct.unpack(">II", data[16:24])
    return height, width


def jpeg_size(path) -> tuple:
    """(height, width) from a baseline JPEG's SOF0 segment."""
    data = Path(path).read_bytes()
    sof = data.find(b"\xff\xc0")
    if data[:2] != b"\xff\xd8" or sof < 0:
        raise AssertionError(f"{path} is not a baseline JPEG")
    return struct.unpack(">HH", data[sof + 5:sof + 9])


def check_files(directory, names, label: str) -> None:
    missing = [name for name in names if not os.path.exists(os.path.join(directory, name))]
    if missing:
        raise AssertionError(f"{label}: missing {missing}")


def checkpoint_files(step: int):
    stem = f"checkpoints/{step:06d}"
    return [stem + suffix for suffix in (".json", ".npz", "_log.json", "_facemodel_distr.pck")]


def table_rows(path) -> np.ndarray:
    table = np.atleast_2d(np.loadtxt(path))
    if not np.isfinite(table).all():
        raise AssertionError(f"{path} holds non-finite values")
    return table


LOSS_TABLES = ("generator", "discriminator", "synth_discriminator", "latent_discriminator")


def stage1_loop(dataset, directory: str, label: str, card: str, kind: str, async_checkpointing=True):
    """Stage-1 train() at full width (bf16, LOOP_STEPS steps, checkpoint
    periods LOOP_PERIOD, FID/KID on LOOP_METRIC_SAMPLES) from seeded weights,
    batches and metric draws, with the launch counters zeroed just before
    and read just after: exactly LOOP_STEPS train steps' launches plus, per
    checkpoint, the 2 + 2 render chunks of the two panels and the fused FID
    chunk.  Checks the files, the tables, the metrics and the panels' sizes.
    Returns (the model, the launches, the record)."""
    np.random.seed(21)
    model = ConfigNetFirstStage(loop_config("bfloat16", async_checkpointing=async_checkpointing))
    sink = SinkRecorder()
    np.random.seed(22)
    zero_launch_counts()
    result = model.train(dataset, dataset, directory, os.path.join(directory, "logs"),
                         n_steps=LOOP_STEPS, n_samples_for_metrics=LOOP_METRIC_SAMPLES, aml_run=sink)
    launches = launch_counts()
    checkpoints = -(-LOOP_STEPS // LOOP_PERIOD)
    expected = loop_launches(LOOP_STEPS, checkpoints, checkpoint_chunks(model, LOOP_METRIC_SAMPLES))
    if launches != expected:
        raise AssertionError(f"{label}: launches {LAUNCH_NAMES} {launches}, expected {expected}")
    if result["steps_run"] != LOOP_STEPS or model.checkpoint_events_run != checkpoints:
        raise AssertionError(f"{label}: {result}, {model.checkpoint_events_run} checkpoints")
    steps = list(range(0, LOOP_STEPS, LOOP_PERIOD))
    check_files(directory, [f for step in steps for f in checkpoint_files(step)]
                + [f"output_imgs/{step:06d}{suffix}" for step in steps for suffix in (".png", "_synth.jpg")]
                + [f"{table}_losses.txt" for table in LOSS_TABLES] + ["inception_metrics.txt"], label)
    for table in LOSS_TABLES:
        rows = table_rows(os.path.join(directory, f"{table}_losses.txt")).shape[0]
        if rows != steps[-1] + 1:  # written at the last checkpoint
            raise AssertionError(f"{label}: {table}_losses.txt has {rows} rows")
    if len(model.g_losses["loss_sum"]) != LOOP_STEPS:
        raise AssertionError(f"{label}: {len(model.g_losses['loss_sum'])} loss rows in memory")
    metrics = model.metrics
    if metrics.get("training_step_number") != steps or not (
            len(metrics["kid"]) == len(steps) and np.isfinite(metrics["kid"] + metrics["fid"]).all()):
        raise AssertionError(f"{label}: metrics {metrics}")
    size = model.config["output_shape"][0]
    last = os.path.join(directory, "output_imgs", f"{steps[-1]:06d}")
    shapes = (png_size(last + ".png"), jpeg_size(last + "_synth.jpg"))
    want = ((model.n_checkpoint_rotations * size, model.n_checkpoint_samples * size),
            ((model.n_checkpoint_rotations + 1) * size, model.n_checkpoint_samples * size))
    if shapes != want:
        raise AssertionError(f"{label}: panels {shapes}, expected {want}")
    checkpoint_s = sink.values("Checkpoint time")
    rec = dict(run=label, async_checkpointing=async_checkpointing, steps=LOOP_STEPS,
               loop_seconds=result["loop_seconds"], steps_per_s=LOOP_STEPS / result["loop_seconds"],
               checkpoint_s=checkpoint_s, launches=dict(zip(LAUNCH_NAMES, launches)),
               kid=metrics["kid"], fid=metrics["fid"])
    print(f"loop {label}: {LOOP_STEPS} steps in {result['loop_seconds']:.3f} s (the checkpoints' "
          f"drain included) = {rec['steps_per_s']:.3f} steps/s on {kind} ({card}); Checkpoint time "
          f"{['%.3f' % t for t in checkpoint_s]} s; launches {launches}; KID {metrics['kid']}, "
          f"FID {metrics['fid']}; panels {shapes}", flush=True)
    return model, launches, rec


def npz_distance(a_path, b_path) -> float:
    """The largest absolute difference between two checkpoints' leaves (the
    leaf sets must be equal)."""
    a, b = np.load(a_path), np.load(b_path)
    if sorted(a.files) != sorted(b.files):
        raise AssertionError(f"{a_path} and {b_path} hold other leaves")
    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in a.files)


def tables_distance(a_dir, b_dir) -> float:
    return max(float(np.abs(table_rows(os.path.join(a_dir, f"{t}_losses.txt"))
                            - table_rows(os.path.join(b_dir, f"{t}_losses.txt"))).max())
               for t in LOSS_TABLES)


def async_against_sync(dataset, directory: str, card: str, kind: str) -> dict:
    """The seeded stage-1 loop on the worker, inline, inline, on the worker,
    with deterministic algorithms (with cuDNN's defaults two inline runs on
    the card differ: 0.0039 in a weight and 2.4 in a loss table after 4
    steps, and a loss table amplifies any difference further).  The two
    inline runs measure the card's run-to-run distance; each worker run's
    step-3 checkpoint and loss tables must equal an inline run's bit for
    bit where the inline runs agree bit for bit, else lie within 4x their
    distance.  This is the check that the worker never reads live weights:
    the step after a checkpoint updates them in place."""
    runs, records = {}, []
    with bench_train.deterministic_algorithms():
        for name, async_checkpointing in (("async_1", True), ("sync_1", False), ("sync_2", False),
                                          ("async_2", True)):
            runs[name] = os.path.join(directory, name)
            model, _, rec = stage1_loop(dataset, runs[name], f"stage1 bfloat16 deterministic {name}",
                                        card, kind, async_checkpointing)
            records.append(rec)
            del model
            torch.cuda.empty_cache()
    step = f"checkpoints/{LOOP_PERIOD:06d}.npz"

    def distances(a, b):
        return (npz_distance(os.path.join(runs[a], step), os.path.join(runs[b], step)),
                tables_distance(runs[a], runs[b]))

    sync = distances("sync_1", "sync_2")
    pairs = {"async_1-sync_1": distances("async_1", "sync_1"),
             "async_2-sync_2": distances("async_2", "sync_2")}
    bound = tuple(4 * d for d in sync)
    print(f"loop async against sync: sync run to run (weights, tables) {sync}; async against sync "
          f"{pairs}; bound {bound} (bit-equal where the sync runs are)", flush=True)
    if any(d > b for pair in pairs.values() for d, b in zip(pair, bound)):
        raise AssertionError(f"the async checkpoints differ from the sync ones: {pairs}, bound {bound}")
    return dict(sync_distance=sync, async_distance=pairs, bound=bound, runs=records)


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_clone(v) for v in tree]
    return tree.clone()


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def prefetch_integrity(model, dataset, card: str, kind: str) -> dict:
    """PREFETCH_BATCHES full-size host batches through BatchPrefetcher, twice,
    must reach the device byte for byte as ``_batch_to_device`` copies them.
    Each phase makes one kind of stream fault show:

    - "slow copies": the sampler, which runs on the prefetcher's thread just
      before each batch is staged, queues a ~10 ms device sleep on the copy
      stream, so every batch's copies run well after it is handed over.
      Each batch is cloned on the consumer's stream as soon as it is taken,
      and kept.  Without the consumer's wait on the copy's event the clone
      reads memory the copy has not written yet; a pinned buffer that is
      refilled before its copy has run sends the next batch's bytes, which
      the kept batch then holds.
    - "slow consumer": each batch is cloned behind a ~12 ms device sleep on
      the consumer's stream and dropped at once.  Without ``record_stream``
      the allocator hands its memory to the next copies on the side stream,
      which overwrite it before the clone reads it.

    All batches are compared after the last take.  A prefetcher with one of
    these faults fails this check on the card (a mutation run, PERF.md §6)."""
    host = [model._sample_host_batch(dataset, dataset) for _ in range(PREFETCH_BATCHES)]
    want = [model._batch_to_device(batch) for batch in host]
    n_bytes = sum(x.numel() * x.element_size() for x in _tree_leaves(want[0]))
    rec = dict(batches=PREFETCH_BATCHES, batch_mb=n_bytes / 1e6)
    for phase in ("slow copies", "slow consumer"):
        counter = itertools.count()
        clones, kept = [], []
        started, prefetchers = threading.Event(), []

        def sample():
            if phase == "slow copies":
                started.wait()
                with torch.cuda.stream(prefetchers[0]._copy_stream):
                    torch.cuda._sleep(20_000_000)
            return host[next(counter) % PREFETCH_BATCHES]

        t0 = time.perf_counter()
        with BatchPrefetcher(sample, depth=2) as prefetcher:
            prefetchers.append(prefetcher)
            started.set()
            for _ in range(PREFETCH_BATCHES):
                batch = prefetcher.next()
                if phase == "slow copies":
                    kept.append(batch)
                else:
                    torch.cuda._sleep(20_000_000)
                clones.append(_tree_clone(batch))
                del batch
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        bad = []
        for i, reference in enumerate(want):
            got = [clones[i]] + ([kept[i]] if kept else [])
            if any(a.device.type != "cuda" or a.dtype != b.dtype or not torch.equal(a, b)
                   for tree in got for a, b in zip(_tree_leaves(tree), _tree_leaves(reference))):
                bad.append(i)
        print(f"loop prefetch ({phase}): {PREFETCH_BATCHES} batches of {n_bytes / 1e6:.1f} MB "
              f"through BatchPrefetcher in {seconds:.3f} s on {kind} ({card}); byte-equal to "
              f"_batch_to_device: {PREFETCH_BATCHES - len(bad)} of {PREFETCH_BATCHES}", flush=True)
        if bad:
            raise AssertionError(f"prefetched batches {bad} differ from _batch_to_device's ({phase})")
        rec[phase.replace(" ", "_") + "_s"] = seconds
    return rec


def loop2_config():
    """TRAIN_CONFIG with the evaluation's face-model layout (62 blendshapes,
    9 beard dims), which the controllability configs need; latent_dim 145."""
    inputs = dict(TRAIN_CONFIG["facemodel_inputs"], blendshape_values=(62, 30),
                  beard_style_embedding=(9, 7))
    return loop_config("bfloat16", facemodel_inputs=inputs)


def stage2_loop(directory: str, card: str, kind: str):
    """Stage-2 train() at full width (bf16, LOOP2_STEPS steps, periods
    LOOP_PERIOD) with a LOOP_IMAGES validation set and a random-weight
    attribute judge (the 38 attributes, 256px) saved to a json path: the
    checkpoints, the autoencoding panel, image_metrics.txt with a row per
    metrics checkpoint, the controllability keys, finite values.  Returns
    (the model, the validation set, the record)."""
    config = loop2_config()
    dataset = loop_dataset(config, seed=31)
    validation = loop_dataset(config, seed=32)
    judge = CelebaAttributeClassifier({"input_shape": tuple(config["output_shape"]),
                                       "predicted_attributes": JUDGE_ATTRIBUTES})
    judge.save(os.path.join(directory, "judge"), "judge")
    np.random.seed(23)
    model = ConfigNet(config)
    give_encoder_heads_weights(model, dataset.imgs[:TRAIN_BATCH])
    sink = SinkRecorder()
    np.random.seed(24)
    zero_launch_counts()
    out = os.path.join(directory, "stage2")
    result = model.train(dataset, dataset, validation, os.path.join(directory, "judge", "judge.json"),
                         out, os.path.join(out, "logs"), n_steps=LOOP2_STEPS,
                         n_samples_for_metrics=LOOP_METRIC_SAMPLES, aml_run=sink)
    launches = launch_counts()
    steps = list(range(0, LOOP2_STEPS, LOOP_PERIOD))
    check_files(out, [f for step in steps for f in checkpoint_files(step)]
                + [f"output_imgs/{step:06d}{s}" for step in steps for s in (".png", "_synth.jpg")]
                + ["image_metrics.txt", "controllability_metrics.json"], "stage-2 loop")
    size = config["output_shape"][0]
    panel = png_size(os.path.join(out, "output_imgs", f"{steps[-1]:06d}.png"))
    if panel != ((model.n_checkpoint_rotations + 2) * size, model.n_checkpoint_samples * size):
        raise AssertionError(f"stage-2 autoencoding panel {panel}")
    rows = np.atleast_1d(np.loadtxt(os.path.join(out, "image_metrics.txt")))
    metrics = model.metrics
    contr_keys = [k for k in metrics if k.endswith("_config")] + ["controllability"]
    values = [metrics[k] for k in ("kid", "fid", "perceptual_loss", "controllability")]
    if (rows.shape != (len(steps),) or not np.isfinite(rows).all() or len(contr_keys) != 9
            or metrics.get("training_step_number") != steps
            or not all(len(v) == len(steps) and np.isfinite(v).all() for v in values)):
        raise AssertionError(f"stage-2 loop: image_metrics {rows}, metrics {sorted(metrics)}")
    # per checkpoint: the synthetic panel, the autoencoding panel (10
    # renders, then 60), the fused FID chunks of the encoded metric images,
    # the controllability's 17 renders of them (contr_launches) and the
    # perceptual metric's render of them
    panel = model.n_checkpoint_rotations * model.n_checkpoint_samples
    metric_chunks = -(-LOOP_METRIC_SAMPLES // SERVE_CHUNK)
    chunks = (2 * -(-panel // SERVE_CHUNK) + -(-model.n_checkpoint_samples // SERVE_CHUNK)
              + -(-LOOP_METRIC_SAMPLES // FID_CHUNK) + 17 * metric_chunks + metric_chunks)
    expected = loop_launches(LOOP2_STEPS, len(steps), chunks)
    if launches != expected:
        raise AssertionError(f"stage-2 loop: launches {LAUNCH_NAMES} {launches}, expected {expected}")
    rec = dict(steps=LOOP2_STEPS, loop_seconds=result["loop_seconds"],
               steps_per_s=LOOP2_STEPS / result["loop_seconds"],
               checkpoint_s=sink.values("Checkpoint time"), launches=dict(zip(LAUNCH_NAMES, launches)),
               perceptual_loss=metrics["perceptual_loss"], controllability=metrics["controllability"],
               kid=metrics["kid"], fid=metrics["fid"])
    print(f"loop stage 2 (bfloat16): {LOOP2_STEPS} steps in {result['loop_seconds']:.3f} s = "
          f"{rec['steps_per_s']:.3f} steps/s on {kind} ({card}); Checkpoint time "
          f"{['%.3f' % t for t in rec['checkpoint_s']]} s; launches {launches}; image_metrics "
          f"{rows.tolist()}; controllability {metrics['controllability']}; panel {panel}", flush=True)
    return model, validation, rec


def latent_gan_loop(confignet, dataset, directory: str, card: str, kind: str) -> dict:
    """LatentGAN.train() on the stage-2 model's embeddings of ``dataset``:
    GAN_LOOP_STEPS steps, a verbose log (panel, checkpoint, KID/FID of the
    ConfigNet's renders of LOOP_METRIC_SAMPLES latents) every GAN_LOOP_PERIOD."""
    np.random.seed(25)
    gan = LatentGAN({"latent_dim": confignet.config["latent_dim"],
                     "verbose_log_period": GAN_LOOP_PERIOD,
                     "n_samples_for_metrics": LOOP_METRIC_SAMPLES})
    out = os.path.join(directory, "latent_gan")
    zero_launch_counts()
    t0 = time.perf_counter()
    gan.train(dataset, confignet, out, os.path.join(out, "logs"), n_iters=GAN_LOOP_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    steps = list(range(0, GAN_LOOP_STEPS, GAN_LOOP_PERIOD))
    # per verbose log the ConfigNet renders the panel's and the metrics' latents
    chunks = (-(-gan.config["logging_img_square_size"] ** 2 // SERVE_CHUNK)
              + -(-LOOP_METRIC_SAMPLES // SERVE_CHUNK))
    expected = loop_launches(0, len(steps), chunks)
    if launches != expected:
        raise AssertionError(f"LatentGAN loop: launches {LAUNCH_NAMES} {launches}, expected {expected}")
    check_files(out, [f"checkpoints/{step:06d}{s}" for step in steps for s in (".json", ".npz")],
                "LatentGAN loop")
    metrics = gan.metrics
    if metrics.get("training_step_number") != steps or not np.isfinite(metrics["kid"] + metrics["fid"]).all():
        raise AssertionError(f"LatentGAN loop: metrics {metrics}")
    rec = dict(steps=GAN_LOOP_STEPS, seconds=seconds, steps_per_s=GAN_LOOP_STEPS / seconds,
               launches=dict(zip(LAUNCH_NAMES, launches)), kid=metrics["kid"], fid=metrics["fid"])
    print(f"loop LatentGAN: {GAN_LOOP_STEPS} steps (embedding {len(dataset.imgs)} images and "
          f"{len(steps)} verbose logs included) in {seconds:.3f} s = {rec['steps_per_s']:.2f} steps/s "
          f"on {kind} ({card}); launches {launches}; KID {metrics['kid']}, FID {metrics['fid']}",
          flush=True)
    return rec


def training_loops(card: str, kind: str, profile_stem=None):
    """Step 13: the train() loops at full width.  Stage 1 (bf16) on the
    checkpoint worker with its launches counted; the resume from its step-3
    checkpoint; the same seeded loop inline and on the worker in turns; the
    prefetcher's integrity; stage 2 with a validation set and a judge; the
    LatentGAN on the stage-2 model.  With ``profile_stem``, one loop window of
    LOOP_PERIOD steps with a checkpoint is profiled into ``<stem>_loop.txt``.
    Returns (the stage-1 loop's launches, the record)."""
    t_step = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as directory:
        dataset = loop_dataset(TRAIN_CONFIG, seed=0)
        main_dir = os.path.join(directory, "async_1")
        model, launches, loop_rec = stage1_loop(dataset, main_dir, "stage1 bfloat16 async_1", card, kind)
        prefetch = prefetch_integrity(model, dataset, card, kind)
        del model
        torch.cuda.empty_cache()

        resumed = attempt_reloading_checkpoint(main_dir)
        start = resumed.get_resume_step()
        if type(resumed) is not ConfigNetFirstStage or start != LOOP_PERIOD + 1:
            raise AssertionError(f"resumed a {type(resumed).__name__} at step {start}")
        resume_dir = os.path.join(directory, "resumed")
        zero_launch_counts()
        result = resumed.train(dataset, dataset, resume_dir, os.path.join(resume_dir, "logs"),
                               n_steps=LOOP_RESUME_STEPS, n_samples_for_metrics=LOOP_METRIC_SAMPLES,
                               aml_run=SinkRecorder())
        resumed_launches = launch_counts()
        if result["steps_run"] != LOOP_RESUME_STEPS - start or resumed.get_resume_step() != LOOP_RESUME_STEPS:
            raise AssertionError(f"the resumed loop ran {result}")
        check_files(resume_dir, checkpoint_files(2 * LOOP_PERIOD), "resumed loop")
        expected = loop_launches(result["steps_run"], 1, checkpoint_chunks(resumed, LOOP_METRIC_SAMPLES))
        if resumed_launches != expected:
            raise AssertionError(f"the resumed loop launched {resumed_launches}, expected {expected}")
        print(f"loop resume: attempt_reloading_checkpoint gave a ConfigNetFirstStage at step {start}; "
              f"train(n_steps={LOOP_RESUME_STEPS}) ran {result['steps_run']} steps in "
              f"{result['loop_seconds']:.3f} s and wrote checkpoints/{2 * LOOP_PERIOD:06d}", flush=True)
        if profile_stem:
            profile(f"stage-1 loop window of {LOOP_PERIOD} steps with a checkpoint (bfloat16)",
                    lambda: resumed._run_training(dataset, dataset, resume_dir,
                                                  resumed.get_resume_step() + LOOP_PERIOD, None),
                    profile_stem + "_loop.txt")
        del resumed
        torch.cuda.empty_cache()

        turns = async_against_sync(dataset, os.path.join(directory, "turns"), card, kind)
        stage2, validation, stage2_rec = stage2_loop(directory, card, kind)
        gan_rec = latent_gan_loop(stage2, validation, directory, card, kind)
        del stage2
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_step
    print(f"loop: step 13 took {seconds:.1f} s", flush=True)
    return launches, dict(stage1=loop_rec, prefetch=prefetch, resume=dict(start=start, **result),
                          async_against_sync=turns, stage2=stage2_rec, latent_gan=gan_rec,
                          seconds=seconds)


# -- step 14: the demo path ----------------------------------------------------

DEMO_PHOTOS = 6  # the photo-list mode's photos: one 2x3 grid
RELEASE_RENDERS = 32
WARP_BATCH = 32
WARP_SOURCE = 1024  # a phone photo's face crop, warped to the model's 256px
# (rotation, transpose, AdaIN forward, AdaIN backward) launches of each
# --test_mode run of the demo (apps/confignet_demo.run_loop; the encoder and
# the LatentGAN launch none):
# - no input, 2x3: three renders of one 6-latent chunk (the LatentGAN's
#   originals, the frame, the resample that the test mode's space key asks for);
# - one photo: the frame (one chunk of 1), then one fine-tune iteration on B
#   (the gather resample, six AdaIN sites forward and backward);
# - six photos, 2x3: the frame (one chunk of 6); B needs a single photo.
DEMO_LAUNCHES = {"no_input": (3, 0, 18, 0), "single_photo": (1, 0, 12, 6),
                 "photo_list": (1, 0, 6, 0)}
DEMO_DEVICE = "cuda"


def demo_config(compute_dtype: str, **extra):
    """The serving config with the reference's input widths for the gaze
    (three Euler angles, the width of the demo's gaze offset) and the
    illumination (the 50 PCA dims of the repo's HDRI turntable), which step
    11's config shortens; latent_dim stays 145."""
    config = serving_config(compute_dtype, **extra)
    config["facemodel_inputs"] = dict(config["facemodel_inputs"],
                                      **{"bone_rotations:left_eye": (3, 2), "hdri_embedding": (50, 20)})
    return config


class ReferencePickler(pickles._Pickler):
    """Writes the port's distribution classes under the reference's module,
    as a released model's pickle names them."""

    write_modules = {"confignet_tpu_torch.data.distributions": "confignet.neural_renderer_dataset"}


def _weight_list(tree, paths):
    """A Keras weight list (an npz object array) of ``tree``'s leaves along
    ``paths``; the dead learned-input kernel is zeros."""
    items = [np.zeros((1, tree["learned_input"].shape[0]), np.float32)
             if path == reference_import.DROP_ZERO_KERNEL else tree["/".join(path)]
             for path in paths]
    out = np.empty(len(items), dtype=object)
    out[:] = items
    return out


def write_reference_release(model, gan, directory: str):
    """The files of a released ConfigNet and LatentGAN in the reference's
    format (confignet_first_stage.py:173-206, latent_gan.py:48-81), written
    from the port's path tables: Keras weight lists in an npz, the config
    json and the distributions pickled under confignet.neural_renderer_dataset.
    Returns the two json paths."""
    cfg, weights = model.config, model.get_weights()
    n_res, from_rgb = cfg["n_discr_layers"], cfg["initial_from_rgb_layer_in_discr"]
    generator_paths = reference_import.generator_weight_paths(cfg["output_shape"][0])
    discriminator_paths = reference_import.discriminator_weight_paths(n_res, from_rgb, "grouped")
    lists = {
        "generator_weights": _weight_list(weights["generator"], generator_paths),
        "generator_smoothed_weights": _weight_list(weights["generator_smoothed"], generator_paths),
        "discriminator_weights": _weight_list(weights["discriminator"], discriminator_paths),
        "synth_discriminator_weights": _weight_list(weights["synth_discriminator"],
                                                    discriminator_paths),
        "latent_regressor_weights": _weight_list(
            weights["latent_regressor"], reference_import.latent_regressor_weight_paths(n_res, from_rgb)),
        "latent_discriminator_weights": _weight_list(
            weights["latent_discriminator"],
            reference_import.mlp_weight_paths(cfg["n_latent_discr_layers"])),
        "synthetic_encoder_weights": _weight_list(
            weights["synthetic_encoder"], reference_import.synthetic_encoder_weight_paths(
                model.facemodel_inputs_tuple, cfg["num_synth_encoder_layers"])),
        "real_encoder_weights": _weight_list(weights["real_encoder"],
                                             reference_import.real_encoder_weight_paths()),
    }
    np.savez(os.path.join(directory, "confignet.npz"), **lists)
    with open(os.path.join(directory, "confignet.json"), "w") as fp:
        json.dump(model._json_safe_config(), fp, indent=4)
    with open(os.path.join(directory, "confignet_facemodel_distr.pck"), "wb") as fp:
        ReferencePickler(fp, protocol=4).dump(model.facemodel_param_distributions)

    gan_weights, gan_paths = gan.get_weights(), reference_import.mlp_weight_paths(gan.config["num_mlp_layers"])
    np.savez(os.path.join(directory, "latent_gan.npz"),
             generator_weights=_weight_list(gan_weights["generator"], gan_paths),
             smoothed_generator_weights=_weight_list(gan_weights["generator_smoothed"], gan_paths),
             discriminator_weights=_weight_list(gan_weights["discriminator"], gan_paths))
    with open(os.path.join(directory, "latent_gan.json"), "w") as fp:
        json.dump(gan.config, fp, indent=4)
    return os.path.join(directory, "confignet.json"), os.path.join(directory, "latent_gan.json")


def load_release(model, gan, directory: str):
    """Write the release, load it with load_confignet and LatentGAN.load:
    every tree equal to the source's bit for bit, the distributions' exemplars
    equal, RELEASE_RENDERS renders identical.  Returns (the json paths, the
    loaded ConfigNet, the loaded LatentGAN, the record)."""
    t0 = time.perf_counter()
    paths = write_reference_release(model, gan, directory)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_confignet(paths[0], device=DEMO_DEVICE)
    loaded_gan = LatentGAN.load(paths[1], device=DEMO_DEVICE)
    load_s = time.perf_counter() - t0
    if type(loaded) is not ConfigNet or type(loaded_gan) is not LatentGAN:
        raise AssertionError(f"the release loaded as {type(loaded).__name__}, {type(loaded_gan).__name__}")
    unequal = unequal_leaves(model.get_weights(), loaded.get_weights())
    unequal += unequal_leaves(gan.get_weights(), loaded_gan.get_weights())
    if unequal:
        raise AssertionError(f"the release's weights differ from the source's: {unequal[:10]}")
    distributions_equal = all(
        type(d) is type(model.facemodel_param_distributions[name])
        and np.array_equal(d.exemplars, model.facemodel_param_distributions[name].exemplars)
        for name, d in loaded.facemodel_param_distributions.items())
    rng = np.random.default_rng(14)
    latents = rng.normal(size=(RELEASE_RENDERS, loaded.config["latent_dim"])).astype(np.float32)
    rotations = poses(RELEASE_RENDERS, rng)
    same_renders = np.array_equal(model.generate_images(latents, rotations),
                                  loaded.generate_images(latents, rotations))
    if not distributions_equal or not same_renders:
        raise AssertionError(f"the loaded release differs: distributions {distributions_equal}, "
                             f"renders {same_renders}")
    n_leaves = sum(len(leaves) for leaves in loaded.get_weights().values())
    print(f"demo: wrote a reference release (Keras weight lists) in {write_s:.2f} s and loaded it in "
          f"{load_s:.2f} s; all {n_leaves} ConfigNet leaves and the LatentGAN's equal bit for bit, "
          f"the distributions equal, {RELEASE_RENDERS} renders identical", flush=True)
    return paths, loaded, loaded_gan, dict(write_s=write_s, load_s=load_s, leaves=n_leaves)


def demo_mode(label: str, fn, card: str, kind: str, expected=None):
    """fn() with ``expected`` (default DEMO_LAUNCHES[label]) counted; the
    frame it returns must be a finite uint8 grid that varies.  Returns (the
    frame, the launches, the record)."""
    t0 = time.perf_counter()
    frame, launches = counted(fn, expected or DEMO_LAUNCHES[label], f"demo {label}")
    seconds = time.perf_counter() - t0
    if frame is None or frame.dtype != np.uint8 or frame.ndim != 3 or frame.std() == 0:
        raise AssertionError(f"demo {label} gave the frame {None if frame is None else frame.shape}")
    print(f"demo {label}: one --test_mode frame {frame.shape} in {seconds:.2f} s on {kind} ({card}); "
          f"launches {dict(zip(LAUNCH_NAMES, launches))}", flush=True)
    return frame, launches, dict(seconds=seconds, frame_shape=list(frame.shape),
                                 launches=dict(zip(LAUNCH_NAMES, launches)))


def warp_run(card: str, kind: str) -> dict:
    """affine_warp of WARP_BATCH seeded WARP_SOURCE^2 float32 photos to the
    model's 256px on the card, against the same call on the CPU (1e-4), timed."""
    rng = np.random.default_rng(15)
    photos = rng.random((WARP_BATCH, WARP_SOURCE, WARP_SOURCE, 3), dtype=np.float32)
    center = (WARP_SOURCE / 2, WARP_SOURCE / 2)
    affines = []
    for _ in range(WARP_BATCH):  # a similarity that puts a face crop of ~1000px at 256px
        scale = 256 / rng.uniform(900, 1100)
        angle = np.radians(rng.uniform(-15, 15))
        A = scale * np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]])
        shift = np.array([128.0, 128.0]) - A @ (np.asarray(center) + rng.normal(scale=20, size=2))
        affines.append(np.concatenate([A, shift[:, None]], axis=1))
    affines = np.asarray(affines, np.float32)
    images, M = torch.from_numpy(photos).to(DEMO_DEVICE), torch.from_numpy(affines).to(DEMO_DEVICE)
    out = affine_warp(images, M, (256, 256))
    want = affine_warp(torch.from_numpy(photos), torch.from_numpy(affines), (256, 256))
    err = (out.cpu() - want).abs().max().item()
    if not err <= 1e-4 or out.shape != (WARP_BATCH, 256, 256, 3) or out.std().item() == 0:
        raise AssertionError(f"affine_warp on the card: {tuple(out.shape)}, max abs error {err}")
    ms = time_ms(lambda: affine_warp(images, M, (256, 256)))
    print(f"demo warp: affine_warp of {WARP_BATCH} photos {WARP_SOURCE}^2 -> 256^2 float32 in "
          f"{ms:.3f} ms on {kind} ({card}); max abs error against the CPU {err:.2e} (bound 1e-4)",
          flush=True)
    return dict(batch=WARP_BATCH, source=WARP_SOURCE, ms=ms, max_abs_err=err)


def demo_path(card: str, kind: str):
    """Step 14: the demo path at full width.  The card has no h5py and no
    cv2, so the Keras .h5 import, HDRI fitting, generate_dataset and the
    demo's --image_path reading are held to the JAX package by the CPU
    tests only; the photo modes here start from photo arrays.  Returns (the
    three modes' launches summed, the record)."""
    t_step = time.perf_counter()
    config = demo_config("float32")
    dataset = FakeDataset(DEMO_PHOTOS + 2, config["output_shape"][0], {}, seed=14)
    rng = np.random.default_rng(14)
    model = ConfigNet(config)
    give_encoder_heads_weights(model, dataset.imgs)
    model.facemodel_param_distributions = {
        name: fit_distribution(rng.normal(size=(256, dims[0])).astype(np.float32), "exemplar")
        for name, dims in model.config["facemodel_inputs"].items()}
    gan = LatentGAN({"latent_dim": model.config["latent_dim"]})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_demo_") as directory:
        (model_json, gan_json), loaded, loaded_gan, release = load_release(model, gan, directory)
        del model, gan
        argv = ["--test_mode", "--device", DEMO_DEVICE, "--confignet_model_path", model_json,
                "--latent_gan_model_path", gan_json]
        modes, total = {}, np.zeros(4, np.int64)

        np.random.seed(140)
        _, launches, modes["no_input"] = demo_mode(
            "no_input", lambda: confignet_demo.run(argv), card, kind)
        total += launches

        # the no-input loop on the loaded release and on a plain-path copy, from the same draws
        plain = ConfigNet(demo_config("float32", rotation_resample="gather", adain_impl="plain"),
                          initialize=False)
        plain.set_weights(loaded.get_weights())
        plain.facemodel_param_distributions = loaded.facemodel_param_distributions
        frames = []
        for confignet, expected in ((loaded, DEMO_LAUNCHES["no_input"]), (plain, (0, 0, 0, 0))):
            np.random.seed(141)
            frames.append(counted(lambda: confignet_demo.run_loop(
                confignet_demo.parse_args(argv), None, loaded_gan, confignet), expected,
                "demo no_input compared")[0])
        del plain
        diff = np.abs(frames[0].astype(int) - frames[1].astype(int))
        e2e = float(diff.mean())
        print(f"demo float32 kernel vs plain path: no-input frame mean abs uint8 difference "
              f"{e2e:.4f} (max {int(diff.max())}), bound 1.0", flush=True)
        if not e2e < 1.0:
            raise AssertionError(f"demo frames: kernel path and plain path disagree: {e2e}")

        photos = list(dataset.imgs[:DEMO_PHOTOS])
        _, launches, modes["photo_list"] = demo_mode("photo_list", lambda: confignet_demo.run_loop(
            confignet_demo.parse_args(argv), photos, None, loaded), card, kind)
        total += launches
        _, launches, modes["single_photo"] = demo_mode("single_photo", lambda: confignet_demo.run_loop(
            confignet_demo.parse_args(argv), [dataset.imgs[DEMO_PHOTOS]], None, loaded), card, kind)
        total += launches
        if loaded._fine_tuned_generator_params is None or len(loaded.fine_tune_losses) != 1:
            raise AssertionError("the single-photo mode did not fine-tune")
    del loaded, loaded_gan
    torch.cuda.empty_cache()
    warp = warp_run(card, kind)
    seconds = time.perf_counter() - t_step
    print(f"demo: step 14 took {seconds:.1f} s", flush=True)
    return tuple(int(n) for n in total), dict(release=release, modes=modes, e2e_mean_abs_uint8=e2e,
                                              warp=warp, seconds=seconds)


# -- step 15: the mesh path ----------------------------------------------------

MESH_DEVICE = "cuda:0"
MESH_BACKEND = "nccl"  # the world-size-1 group's; two ranks on one card need gloo
MESH_RANKS = 2  # part (c): two ranks on the one card
MESH_TIMED_STEPS = 2  # the 2-rank steps timed after the compared one
MESH_FINE_TUNE_ITERS = 2
MESH_GATHER_REPS = 20
MESH_SEED = 15
# collectives of one stage-2 train step over a process group: one gradient
# all-reduce per player, and the variance-normalised latent regression's
# batch statistics (two sums forward, their two sums backward)
STEP_COLLECTIVES = {"all_reduce_mean": 4, "all_reduce_sum": 4, "all_gather_rows": 0, "broadcast": 0}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def zero_collectives(mesh) -> None:
    for name in mesh.launches:
        mesh.launches[name] = 0


def mesh_dataset_spec() -> tuple:
    """FakeDataset's arguments: step 8's fake set, 64 seeded images at the
    train config's width (256px) with its face-model inputs."""
    return (64, TRAIN_CONFIG["output_shape"][0],
            {name: dims[0] for name, dims in TRAIN_CONFIG["facemodel_inputs"].items()}, MESH_SEED)


def flat_state(trees) -> dict:
    """{tree: {path: array}} (or deeper) as {"tree|path": array}."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for key, value in node.items():
                walk(f"{prefix}|{key}" if prefix else key, value)
        else:
            out[prefix] = np.asarray(node)

    walk("", trees)
    return out


def unequal_arrays(a: dict, b: dict) -> list:
    """The keys whose arrays differ in any bit (or that only one side has)."""
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
                  or a[k].tobytes() != b[k].tobytes())


def native_gather_run(dataset, card: str, kind: str) -> dict:
    """(a) The native gather must have built (g++); it gathers one stage-2
    host batch's images at the global batch (four gathers of 24, two of 12,
    and the 24 D reals again with a flip mask) byte-equal to numpy
    indexing, each timed over MESH_GATHER_REPS batches on the host."""
    if not native_available():
        raise AssertionError("the native gather did not build: g++ failed or is missing")
    rng = np.random.RandomState(MESH_SEED)
    n = dataset.imgs.shape[0]
    indices = [rng.randint(0, n, size) for size in (TRAIN_BATCH,) * 4 + (TRAIN_BATCH // 2,) * 2]
    flips = (rng.random_sample(TRAIN_BATCH) < 0.5).astype(np.uint8)

    def native():
        return [gather_images(dataset.imgs, i) for i in indices] + [
            gather_images(dataset.imgs, indices[0], flips)]

    def numpy_indexing():
        flipped = dataset.imgs[indices[0]].copy()
        flipped[flips.astype(bool)] = flipped[flips.astype(bool)][:, :, ::-1]
        return [np.ascontiguousarray(dataset.imgs[i]) for i in indices] + [flipped]

    got, want = native(), numpy_indexing()
    if any(a.shape != b.shape or a.tobytes() != b.tobytes() for a, b in zip(got, want)):
        raise AssertionError("the native gather disagrees with numpy indexing")
    times = {}
    for name, fn in (("native", native), ("numpy", numpy_indexing), ("native_again", native)):
        t0 = time.perf_counter()
        for _ in range(MESH_GATHER_REPS):
            fn()
        times[name] = (time.perf_counter() - t0) / MESH_GATHER_REPS * 1e3
    megabytes = sum(a.nbytes for a in got) / 1e6
    rec = dict(megabytes=megabytes, native_ms=min(times["native"], times["native_again"]),
               numpy_ms=times["numpy"], threads=os.cpu_count())
    print(f"mesh native gather: one stage-2 batch's images ({megabytes:.1f} MB, "
          f"{dataset.imgs.shape[1]}px, global batch {TRAIN_BATCH}) byte-equal to numpy; host time native {rec['native_ms']:.3f} ms, numpy "
          f"{rec['numpy_ms']:.3f} ms a batch ({os.cpu_count()} host cores; card {kind}, {card})",
          flush=True)
    return rec


@contextlib.contextmanager
def process_group(backend: str, rank: int, world_size: int, port: int, device):
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world_size)
    try:
        yield create_mesh(device=device)
    finally:
        dist.destroy_process_group()


def single_rank_group(dataset, card: str, kind: str) -> tuple:
    """(b) A world-size-1 group (MESH_BACKEND, NCCL on the card), whose
    collectives are launched: one float32 stage-2 step, a server's renders
    and a fine-tune, each over the mesh and without it from the same
    weights, inputs and draws, under deterministic algorithms; each pair
    bit-equal.  The mesh step launches step 8's kernels and STEP_COLLECTIVES.
    No call runs warm first: the step without a mesh runs twice from the
    same weights, and the two (with --mesh-only, the process's first and
    second stage-2 steps) must be bit-equal, as the JAX step's are
    (losses/gan.lead_autograd_sequence).  Returns (the step's launches, the
    server's launches, the record)."""
    rec = {}
    if torch.device(MESH_DEVICE).type == "cuda":
        torch.cuda.set_device(MESH_DEVICE)
    with process_group(MESH_BACKEND, 0, 1, free_port(), MESH_DEVICE) as mesh, \
            bench_train.deterministic_algorithms():
        # the train step
        model = ConfigNet(train_config("float32"), device=MESH_DEVICE)
        give_encoder_heads_weights(model, dataset.imgs[:TRAIN_BATCH])
        weights = model.get_weights()
        draws = pinned_draws(model, np.random.default_rng(MESH_SEED))
        model._batch_rng = np.random.RandomState(MESH_SEED)
        batch = model._sample_host_batch(dataset, dataset)
        alone = pinned_step(model, batch, draws, "mesh step without a mesh")
        alone_weights = flat_state(model.get_weights())
        model.set_weights(weights)
        again = pinned_step(model, batch, draws, "the same step again")
        differ = [k for k, v in alone[0].items() if again[0][k] != v]
        differ += unequal_arrays(flat_state(alone[1]), flat_state(again[1]))
        differ += unequal_arrays(alone_weights, flat_state(model.get_weights()))
        if differ:
            raise AssertionError(f"a stage-2 step and its repeat from the same weights differ: "
                                 f"{differ[:10]}")
        print(f"mesh: a float32 stage-2 step and its repeat from the same weights, batch and draws "
              f"bit-equal ({len(alone_weights)} weight leaves, the gradients, the losses)", flush=True)
        del model
        torch.cuda.empty_cache()

        model = ConfigNet(train_config("float32"), device=MESH_DEVICE, initialize=False)
        model.set_weights(weights)
        model._use_mesh(mesh)
        model._batch_rng = np.random.RandomState(MESH_SEED)
        mesh_batch = model._sample_host_batch(dataset, dataset)
        if unequal_arrays(flat_state({k: dict(enumerate(v)) if isinstance(v, tuple) else v
                                      for k, v in batch.items()}),
                          flat_state({k: dict(enumerate(v)) if isinstance(v, tuple) else v
                                      for k, v in mesh_batch.items()})):
            raise AssertionError("mesh step: the host batch differs from the one without a mesh")
        zero_collectives(mesh)
        zero_launch_counts()
        t0 = time.perf_counter()
        over_mesh = pinned_step(model, mesh_batch, draws, "mesh step over a world-size-1 group")
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        train_launches, collectives = launch_counts(), dict(mesh.launches)
        if train_launches != TRAIN_STEP_LAUNCHES or collectives != STEP_COLLECTIVES:
            raise AssertionError(f"mesh step: launches {train_launches}, collectives {collectives}; "
                                 f"expected {TRAIN_STEP_LAUNCHES}, {STEP_COLLECTIVES}")
        differ = [k for k, v in alone[0].items() if over_mesh[0][k] != v]
        differ += unequal_arrays(flat_state(alone[1]), flat_state(over_mesh[1]))
        differ += unequal_arrays(alone_weights, flat_state(model.get_weights()))
        if differ:
            raise AssertionError(f"mesh step: not bit-equal to the step without a mesh: {differ[:10]}")
        rec["train_step"] = dict(launches=dict(zip(LAUNCH_NAMES, train_launches)),
                                 collectives=collectives, seconds=step_s,
                                 leaves_compared=len(alone_weights))
        print(f"mesh world-size-1 {MESH_BACKEND} group: one float32 stage-2 step (batch {TRAIN_BATCH}) "
              f"bit-equal to mesh=None (losses, {len(alone_weights)} weight leaves, the gradients); "
              f"launches {train_launches}, collectives {collectives}; {step_s:.3f} s on {kind} ({card})",
              flush=True)
        del model
        torch.cuda.empty_cache()

        # the server
        rng = np.random.default_rng(MESH_SEED)
        model = ConfigNet(serving_config("float32"), device=MESH_DEVICE)
        give_encoder_heads_weights(model, dataset.imgs[:8])
        latents = rng.normal(size=(SERVE_CHUNK, model.config["latent_dim"])).astype(np.float32)
        rotations = poses(SERVE_CHUNK, rng)
        alone = ConfigNetServer(model, chunk=SERVE_CHUNK, device=MESH_DEVICE).generate(latents, rotations)
        server = ConfigNetServer(model, chunk=SERVE_CHUNK, mesh=mesh)
        zero_collectives(mesh)
        renders, serve_launches = counted(lambda: server.generate(latents, rotations), CHUNK_LAUNCHES,
                                          "mesh server")
        if mesh.launches["all_gather_rows"] != 1 or not np.array_equal(renders, alone):
            raise AssertionError(f"mesh server: {mesh.launches}, renders bit-equal "
                                 f"{np.array_equal(renders, alone)}")
        check_renders(renders, SERVE_CHUNK, "mesh server")
        rec["server"] = dict(launches=dict(zip(LAUNCH_NAMES, serve_launches)),
                             collectives=dict(mesh.launches))
        print(f"mesh world-size-1 server: {SERVE_CHUNK} renders bit-equal to the server without a "
              f"mesh; launches {serve_launches}", flush=True)
        del server

        # the fine-tune
        photo = dataset.imgs[0]
        ends = []
        for over in (None, mesh):
            expected = tuple(MESH_FINE_TUNE_ITERS * n for n in FINE_TUNE_ITER_LAUNCHES)
            (embeddings, rotations), _ = counted(lambda: model.fine_tune_on_img(
                photo, n_iters=MESH_FINE_TUNE_ITERS, mesh=over), expected, f"mesh fine-tune {over}")
            ends.append({"embeddings": embeddings, "rotations": rotations,
                         **{f"generator|{k}": v.cpu().numpy()
                            for k, v in model._fine_tuned_generator_params.items()}})
            model._fine_tuned_generator_params = None
        differ = unequal_arrays(*ends)
        if differ:
            raise AssertionError(f"mesh fine-tune: not bit-equal to the run without a mesh: {differ[:10]}")
        rec["fine_tune"] = dict(iterations=MESH_FINE_TUNE_ITERS, leaves_compared=len(ends[0]))
        print(f"mesh world-size-1 fine-tune: {MESH_FINE_TUNE_ITERS} iterations end bit-equal to the "
              f"run without a mesh ({len(ends[0])} arrays)", flush=True)
        del model
        torch.cuda.empty_cache()
    return train_launches, serve_launches, rec


def gloo_rank(rank: int, port: int, spec: dict) -> None:
    """(c) One of MESH_RANKS ranks on the one card (a spawned process; every
    setting arrives in ``spec``): the compared stage-2 step from the saved
    weights and global draws, MESH_TIMED_STEPS timed steps, and the renders
    of a server built before the steps.  Writes ``result_<rank>.npz``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(spec["device"])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats()
    directory = Path(spec["directory"])
    with np.load(directory / "inputs.npz") as npz:
        arrays = dict(npz)
    weights = {}
    for key, value in arrays.items():
        if key.startswith("weights|"):
            _, tree, path = key.split("|", 2)
            weights.setdefault(tree, {})[path] = value
    draws = ([], [], [arrays[f"flips|{i}"] for i in range(spec["n_flips"])])
    out = {}
    with process_group("gloo", rank, MESH_RANKS, port, device) as mesh:
        model = ConfigNet(spec["config"], device=device, initialize=False)
        model.set_weights(weights)
        model._use_mesh(mesh)
        server = ConfigNetServer(model, chunk=spec["chunk"], mesh=mesh)  # the weights before the steps
        dataset = FakeDataset(*spec["dataset"])
        model._batch_rng = np.random.RandomState(spec["batch_seed"])
        batch = model._sample_host_batch(dataset, dataset)
        zero_launch_counts()
        zero_collectives(mesh)
        losses, moments = pinned_step(model, batch, draws, f"gloo rank {rank}")
        out["step_launches"] = np.array(launch_counts())
        out["step_collectives"] = np.array([mesh.launches[k] for k in sorted(mesh.launches)])
        out.update({f"loss|{k}": np.asarray(v) for k, v in losses.items()})
        state = flat_state({"moments": moments, "weights": model.get_weights()})
        digest = hashlib.sha256()
        for key in sorted(state):
            digest.update(key.encode())
            digest.update(state[key].tobytes())
        out["digest"] = np.array(digest.hexdigest())
        if rank == 0:
            out.update({f"moments|{k}": v for k, v in flat_state(moments).items()})
        del state, moments

        step = model._build_train_step()
        batches = [model._sample_host_batch(dataset, dataset) for _ in range(spec["timed_steps"])]
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for timed in batches:
            check_finite(step(timed), f"gloo rank {rank}")
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()
        out["steps_seconds"] = np.asarray(time.perf_counter() - t0)
        zero_launch_counts()
        out["renders"] = server.generate(arrays["latents"], arrays["rotations"])
        out["serve_launches"] = np.array(launch_counts())
        out["peak_memory_gb"] = np.asarray(torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0)
    np.savez(directory / f"result_{rank}.npz", **out)


def two_ranks_one_card(dataset, card: str, kind: str) -> dict:
    """(c) MESH_RANKS ranks on the one card over gloo (NCCL takes one rank a
    card), spawned processes loading the kernels step 2 built.  Their
    float32 stage-2 step at the global batch against the single-process
    step from the same weights, host batch and global draws: the losses (the
    ranks' mean) within rtol 1e-3, each player's gradient within a relative
    L2 distance of 1e-3, or 4x a one-site rounding probe's distance where
    the step is that sensitive (compare_train_paths' rule), and the ranks
    bit-equal after the step.  Their server's renders of SERVE_CHUNK
    latents within a mean abs uint8 difference of 1.0 of the single-process
    server's."""
    rng = np.random.default_rng(MESH_SEED + 1)
    config = train_config("float32")
    model = ConfigNet(config, device=MESH_DEVICE)
    give_encoder_heads_weights(model, dataset.imgs[:TRAIN_BATCH])
    weights = model.get_weights()
    latents = rng.normal(size=(SERVE_CHUNK, model.config["latent_dim"])).astype(np.float32)
    rotations = poses(SERVE_CHUNK, rng)
    alone_renders = ConfigNetServer(model, chunk=SERVE_CHUNK, device=MESH_DEVICE).generate(
        latents, rotations)
    draws = pinned_draws(model, rng)
    model._batch_rng = np.random.RandomState(MESH_SEED)
    batch = model._sample_host_batch(dataset, dataset)
    results = {"alone": pinned_step(model, batch, draws, "single-process step")}
    player_trees = model.PLAYER_TREES
    del model
    torch.cuda.empty_cache()
    # the step's own sensitivity to rounding, as compare_train_paths measures it
    generator_module._ROTATION_IMPLS.update(gather_plain=_rotate_plain,
                                            gather_via_float64=_rotate_via_float64)
    for name, rotation in (("plain", "gather_plain"), ("probe", "gather_via_float64")):
        model = ConfigNet(train_config("float32", rotation_resample_train=rotation, adain_impl="plain"),
                          device=MESH_DEVICE, initialize=False)
        model.set_weights(weights)
        results[name] = pinned_step(model, batch, draws, f"single-process {name} step")
        del model
        torch.cuda.empty_cache()
    probe = train_distances(results["probe"], results["plain"], player_trees)
    bounds = {k: 1e-3 if k == "losses" else max(1e-3, 4 * v) for k, v in probe.items()}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as directory:
        inputs = {f"weights|{k}": v for k, v in flat_state(weights).items()}
        inputs.update({f"flips|{i}": f for i, f in enumerate(draws[2])})
        np.savez(Path(directory) / "inputs.npz", latents=latents, rotations=rotations, **inputs)
        spec = dict(device=MESH_DEVICE, directory=directory, config=config, chunk=SERVE_CHUNK,
                    n_flips=len(draws[2]), batch_seed=MESH_SEED, timed_steps=MESH_TIMED_STEPS,
                    dataset=mesh_dataset_spec())
        context = multiprocessing.get_context("spawn")
        port = free_port()
        procs = [context.Process(target=gloo_rank, args=(rank, port, spec)) for rank in range(MESH_RANKS)]
        t0 = time.perf_counter()
        for proc in procs:
            proc.start()
        try:
            for proc in procs:
                proc.join(timeout=900)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        seconds = time.perf_counter() - t0
        if any(proc.exitcode != 0 for proc in procs):
            raise AssertionError(f"gloo ranks exited with {[p.exitcode for p in procs]}")
        ranks = []
        for rank in range(MESH_RANKS):
            with np.load(Path(directory) / f"result_{rank}.npz") as npz:
                ranks.append(dict(npz))

    losses = {k.split("|", 1)[1]: float(np.mean([r[k] for r in ranks]))
              for k in ranks[0] if k.startswith("loss|")}
    moments = {}
    for key, value in ranks[0].items():
        if key.startswith("moments|"):
            _, player, tree, path = key.split("|", 3)
            moments.setdefault(player, {}).setdefault(tree, {})[path] = value
    distance = train_distances((losses, moments), results["alone"], player_trees)
    renders_diff = [float(np.mean(np.abs(r["renders"].astype(int) - alone_renders.astype(int))))
                    for r in ranks]
    steps_per_s = [MESH_TIMED_STEPS / float(r["steps_seconds"]) for r in ranks]
    rec = dict(ranks=MESH_RANKS, backend="gloo", distances=distance, probe=probe, bounds=bounds,
               renders_mean_abs_uint8=renders_diff, steps_per_s=min(steps_per_s),
               img_per_s=min(steps_per_s) * TRAIN_BATCH,
               peak_memory_gb=[float(r["peak_memory_gb"]) for r in ranks],
               step_launches=[dict(zip(LAUNCH_NAMES, r["step_launches"].tolist())) for r in ranks],
               serve_launches=[dict(zip(LAUNCH_NAMES, r["serve_launches"].tolist())) for r in ranks],
               step_collectives=[dict(zip(sorted(STEP_COLLECTIVES), r["step_collectives"].tolist()))
                                 for r in ranks],
               seconds=seconds)
    print(f"mesh {MESH_RANKS} gloo ranks on one card: step at global batch {TRAIN_BATCH} "
          f"({TRAIN_BATCH // MESH_RANKS} a rank) vs the single-process step (losses: max relative "
          f"error; players: relative L2 of the gradient) {json.dumps(distance)}; one-site rounding "
          f"probe {json.dumps(probe)}; bounds {json.dumps(bounds)}; renders vs the single-process "
          f"server, mean abs uint8 {renders_diff}; {rec['steps_per_s']:.3f} steps/s "
          f"({rec['img_per_s']:.1f} img/s), peak {rec['peak_memory_gb']} GB a rank; "
          f"{seconds:.1f} s with the spawns, on {kind} ({card})", flush=True)
    failed = [k for k in distance if not distance[k] <= bounds[k]]
    if failed or len({str(r["digest"]) for r in ranks}) != 1:
        raise AssertionError(f"2-rank step: off on {failed}; rank digests "
                             f"{[str(r['digest'])[:12] for r in ranks]}")
    if not all(d < 1.0 for d in renders_diff) or not np.array_equal(ranks[0]["renders"],
                                                                   ranks[1]["renders"]):
        raise AssertionError(f"2-rank server: renders off by {renders_diff}")
    for r in ranks:
        if tuple(r["step_launches"]) != TRAIN_STEP_LAUNCHES or tuple(r["serve_launches"]) != CHUNK_LAUNCHES:
            raise AssertionError(f"2-rank launches: {rec['step_launches']}, {rec['serve_launches']}")
        if dict(zip(sorted(STEP_COLLECTIVES), r["step_collectives"].tolist())) != STEP_COLLECTIVES:
            raise AssertionError(f"2-rank collectives: {rec['step_collectives']}")
    return rec


def mesh_path(card: str, kind: str) -> tuple:
    """Step 15: the native gather, a world-size-1 process group, two ranks
    on one card.  Returns (the train_mesh launches, the serve_mesh launches,
    the record)."""
    t_step = time.perf_counter()
    dataset = FakeDataset(*mesh_dataset_spec())
    gather = native_gather_run(dataset, card, kind)
    train_launches, serve_launches, single = single_rank_group(dataset, card, kind)
    two = two_ranks_one_card(dataset, card, kind)
    seconds = time.perf_counter() - t_step
    print(f"mesh: step 15 took {seconds:.1f} s", flush=True)
    return train_launches, serve_launches, dict(native_gather=gather, single_rank=single,
                                                two_ranks=two, seconds=seconds)


# -- the first stage-2 step of a process: an op-by-op bisect ---------------------


def _digest(t: torch.Tensor) -> torch.Tensor:
    """Two int64 sums over a tensor's bits (all of it, every other element):
    any single changed bit changes them."""
    t = t.detach()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    t = t.contiguous().reshape(-1)
    if t.is_complex():
        t = torch.view_as_real(t).reshape(-1)
    size = t.element_size()
    bits = t.view({8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}[size])
    return torch.stack([bits.sum(dtype=torch.int64), bits[::2].sum(dtype=torch.int64)])


class OpDigests(TorchDispatchMode):
    """Records, for every ATen op, its name and digests of its tensor inputs
    and outputs (outputs of the allocators, whose memory is uninitialised,
    are not digested)."""

    def __init__(self):
        super().__init__()
        self.names, self.inputs, self.outputs = [], [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        tensors_in = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
                      if isinstance(a, torch.Tensor)]
        tensors_out = [a for a in torch.utils._pytree.tree_leaves(out)
                       if isinstance(a, torch.Tensor)]
        if tensors_in or tensors_out:
            self.names.append(name)
            self.inputs.append([_digest(t) for t in tensors_in])
            self.outputs.append([] if "empty" in name else [_digest(t) for t in tensors_out])
        return out

    def host(self) -> tuple:
        """(names, input digests, output digests) as host lists."""
        flat = [d for group in self.inputs + self.outputs for d in group]
        values = [None] * len(flat)
        for on_card in (True, False):
            index = [i for i, d in enumerate(flat) if d.is_cuda == on_card]
            if index:
                for i, value in zip(index, torch.stack([flat[i] for i in index]).cpu().tolist()):
                    values[i] = value
        it = iter(values)
        ins = [[tuple(next(it)) for _ in group] for group in self.inputs]
        outs = [[tuple(next(it)) for _ in group] for group in self.outputs]
        return self.names, ins, outs


def computing_ops(names: list) -> list:
    """Indices of the ops that compute: the allocators (whose memory is
    uninitialised) and the first call's device-constant builds (a
    ``lift_fresh`` and its copy to the device, core/constants.py) left out."""
    keep, i = [], 0
    while i < len(names):
        if names[i] == "aten.lift_fresh.default":
            i += 2 if names[i + 1:i + 2] == ["aten._to_copy.default"] else 1
            continue
        if "empty" not in names[i]:
            keep.append(i)
        i += 1
    return keep


def first_step_probe(card: str, kind: str, path: str) -> dict:
    """Three float32 stage-2 steps at full width (step 8's config, batch 24)
    from the same weights, host batch and draws under deterministic
    algorithms, each its own fresh step (pinned_step), the first the first
    of the process; every op's inputs and outputs digested (OpDigests).
    Reports whether step 1 equals step 2 and step 2 step 3 bit for bit, and,
    over the ops that compute (computing_ops), the first position where the
    two steps run another op and the first before it whose outputs or
    inputs differ; writes the report to ``path``."""
    dataset = FakeDataset(64, 256, {name: dims[0] for name, dims
                                    in TRAIN_CONFIG["facemodel_inputs"].items()}, seed=0)
    runs = []
    with bench_train.deterministic_algorithms():
        model = ConfigNet(train_config("float32"))
        give_encoder_heads_weights(model, dataset.imgs[:TRAIN_BATCH])
        weights = model.get_weights()
        draws = pinned_draws(model, np.random.default_rng(8))
        batch = model._sample_host_batch(dataset, dataset)
        model._build_train_step()  # the first build's own ops stay out of the digests
        for i in range(3):
            model.set_weights(weights)
            digests = OpDigests()
            with digests:
                losses, moments = pinned_step(model, batch, draws, f"probe step {i + 1}")
            torch.cuda.synchronize()
            runs.append(dict(losses=losses, moments=flat_state(moments), ops=digests.host(),
                             weights=flat_state(model.get_weights())))
    rec = {"ops": [len(r["ops"][0]) for r in runs]}
    for a, b in ((0, 1), (1, 2)):
        first, second = runs[a], runs[b]
        label = f"step {a + 1} vs step {b + 1}"
        differ = unequal_arrays(first["moments"], second["moments"])
        differ_weights = unequal_arrays(first["weights"], second["weights"])
        differ_losses = [k for k, v in first["losses"].items() if second["losses"][k] != v]
        names_a, ins_a, outs_a = first["ops"]
        names_b, ins_b, outs_b = second["ops"]
        ka, kb = computing_ops(names_a), computing_ops(names_b)
        order = next((p for p, (i, j) in enumerate(zip(ka, kb)) if names_a[i] != names_b[j]),
                     None if len(ka) == len(kb) else min(len(ka), len(kb)))
        limit = len(ka) if order is None else order
        first_out = next((p for p in range(limit) if outs_a[ka[p]] != outs_b[kb[p]]), None)
        first_in = next((p for p in range(limit) if ins_a[ka[p]] != ins_b[kb[p]]), None)
        item = dict(gradients_differ=len(differ), weights_differ=len(differ_weights),
                    losses_differ=differ_losses, computing_ops=[len(ka), len(kb)],
                    first_order_change=order, first_output_change=first_out,
                    first_input_change=first_in)
        if order is not None:
            item["order_change"] = {name: [names[k[p]] for p in range(max(0, order - 6), order + 6)
                                           if p < len(k)]
                                    for name, names, k in ((f"step {a + 1}", names_a, ka),
                                                           (f"step {b + 1}", names_b, kb))}
        rec[label] = item
        print(f"first-step probe {label}: {json.dumps(item)}", flush=True)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps({"card": card, "kind": kind, **rec}, indent=1))
    return rec


# -- step 16: the 512px path ---------------------------------------------------

SIZE_512 = 512
SERVE_512_PHOTOS = 40  # encode and render_with_attribute: two chunks of 32
GENERATE_512 = 256  # generate and sample: 8 chunks of 32
FINE_TUNE_512_ITERS = 20
TRAIN_512_STEPS = 2
ADAIN_512_BATCHES = (1, TRAIN_BATCH // 2, TRAIN_BATCH, SERVE_CHUNK)  # the fine-tune, G step, D, serving
ADAIN_512_BACKWARD_BATCHES = (1, TRAIN_BATCH // 2)  # the fine-tune, the G step's halves
# the demo at 512px: each 256px mode's generator passes, each with the seventh site
DEMO_LAUNCHES_512 = {"no_input": (3, 0, 21, 0), "single_photo": (1, 0, 14, 7),
                     "photo_list": (1, 0, 7, 0)}


def at_512(config: dict) -> dict:
    """A config at 512px: the generator adds map_2d_2c, the discriminators,
    the regressor, the encoder and the perceptual losses see 512x512."""
    return dict(config, output_shape=(SIZE_512, SIZE_512, 3))


def serve_512(photos, card: str, kind: str, profile_stem=None):
    """(b) ConfigNetServer(chunk=32) over the bf16 serving model at 512px:
    encode and render_with_attribute SERVE_512_PHOTOS photos, generate and
    sample (a LatentGAN of random weights, truncation 0.7) GENERATE_512,
    each cold then warm, with exactly CHUNK_LAUNCHES_512 a generator chunk;
    then the float32 kernel path against the plain path on 8 photos.
    Returns (the launches of the timed requests, the record)."""
    rng = np.random.default_rng(160)
    model = ConfigNet(at_512(serving_config("bfloat16")))
    give_encoder_heads_weights(model, photos[:SERVE_CHUNK])
    server = ConfigNetServer(model, LatentGAN({"latent_dim": model.config["latent_dim"]}),
                             chunk=SERVE_CHUNK)
    n_blend = model.config["facemodel_inputs"]["blendshape_values"][0]
    blend = rng.uniform(0, 1, size=(1, n_blend)).astype(np.float32)
    latents = rng.normal(size=(GENERATE_512, model.config["latent_dim"])).astype(np.float32)
    rotations = poses(GENERATE_512, rng)
    n, chunks = len(photos), -(-len(photos) // SERVE_CHUNK)
    requests = [
        ("encode", n, 0, lambda: server.encode(photos)),
        ("render_with_attribute", n, chunks, lambda: server.render_with_attribute(
            photos, "blendshape_values", blend)),
        ("generate", GENERATE_512, GENERATE_512 // SERVE_CHUNK,
         lambda: server.generate(latents, rotations)),
        ("sample", GENERATE_512, GENERATE_512 // SERVE_CHUNK,
         lambda: server.sample(GENERATE_512, rotations=rotations, truncation=0.7)),
    ]
    zero_launch_counts()
    served, outputs = [], {}
    for name, n_images, gen_chunks, call in requests:
        for attempt in ("cold", "warm"):
            before = launch_counts()
            t0 = time.perf_counter()
            out = call()
            seconds = time.perf_counter() - t0
            delta = tuple(a - b for a, b in zip(launch_counts(), before))
            if delta != tuple(gen_chunks * k for k in CHUNK_LAUNCHES_512):
                raise AssertionError(f"serve 512 {name}: launches {delta} for {gen_chunks} "
                                     f"generator chunks of {CHUNK_LAUNCHES_512}")
            served.append(dict(request=name, run=attempt, images=n_images, seconds=seconds,
                               img_per_s=n_images / seconds, launches=list(delta)))
            print(f"serve 512px {name} ({attempt}): {n_images} images in {seconds * 1e3:.1f} ms = "
                  f"{n_images / seconds:.1f} img/s at bfloat16, chunk {SERVE_CHUNK}, on {kind} "
                  f"({card}); launches {delta}", flush=True)
        outputs[name] = out
    launches = launch_counts()
    lat, rot = outputs["encode"]
    if lat.shape != (n, 145) or rot.shape != (n, 3) or not (np.isfinite(lat).all()
                                                             and np.isfinite(rot).all()):
        raise AssertionError(f"serve 512 encode gave {lat.shape} {rot.shape}")
    if lat[:, 0].std() == 0 or rot[:, 0].std() == 0:
        raise AssertionError("serve 512 encode gave the same latent for every photo")
    for name, n_images in (("render_with_attribute", n), ("generate", GENERATE_512),
                           ("sample", GENERATE_512)):
        check_renders(outputs[name], n_images, f"serve 512 {name}", SIZE_512)
    if profile_stem:
        chunk = (latents[:SERVE_CHUNK], rotations[:SERVE_CHUNK])
        profile(f"generate chunk {SERVE_CHUNK} at 512px (bfloat16)",
                lambda: server.generate(*chunk), profile_stem + "_512_generate.txt")
    del server, model, outputs
    torch.cuda.empty_cache()

    model_k = ConfigNet(at_512(serving_config("float32")))
    give_encoder_heads_weights(model_k, photos[:8])
    model_p = ConfigNet(at_512(serving_config("float32", rotation_resample="gather",
                                              adain_impl="plain")), initialize=False)
    model_p.set_weights(model_k.get_weights())
    out_p, _ = counted(lambda: ConfigNetServer(model_p, chunk=8).render_with_attribute(
        photos[:8], "blendshape_values", blend), (0, 0, 0, 0), "serve 512 plain path")
    out_k, _ = counted(lambda: ConfigNetServer(model_k, chunk=8).render_with_attribute(
        photos[:8], "blendshape_values", blend), CHUNK_LAUNCHES_512, "serve 512 kernel path")
    diff = np.abs(out_k.astype(int) - out_p.astype(int))
    e2e = float(diff.mean())
    print(f"serve 512px float32 kernel vs plain path: mean abs uint8 difference {e2e:.4f} (max "
          f"{int(diff.max())}), bound 1.0", flush=True)
    if not e2e < 1.0 or out_k.std() == 0:
        raise AssertionError(f"512px renders: kernel path and plain path disagree: {e2e}")
    return launches, dict(requests=served, e2e_mean_abs_uint8=e2e)


def demo_512(photos, card: str, kind: str):
    """(c) A reference release of the float32 demo model at 512px, written and
    loaded bit-equal (load_release), then confignet_demo --resolution 512
    --test_mode in its three input modes with DEMO_LAUNCHES_512.  Returns
    (the three modes' launches summed, the record)."""
    rng = np.random.default_rng(161)
    model = ConfigNet(at_512(demo_config("float32")))
    give_encoder_heads_weights(model, photos[:8])
    model.facemodel_param_distributions = {
        name: fit_distribution(rng.normal(size=(256, dims[0])).astype(np.float32), "exemplar")
        for name, dims in model.config["facemodel_inputs"].items()}
    gan = LatentGAN({"latent_dim": model.config["latent_dim"]})
    total, modes = np.zeros(4, np.int64), {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_512_") as directory:
        (model_json, gan_json), loaded, loaded_gan, release = load_release(model, gan, directory)
        del model, gan
        argv = ["--test_mode", "--resolution", str(SIZE_512), "--device", DEMO_DEVICE,
                "--confignet_model_path", model_json, "--latent_gan_model_path", gan_json]
        np.random.seed(162)
        runs = (("no_input", lambda: confignet_demo.run(argv)),
                ("photo_list", lambda: confignet_demo.run_loop(
                    confignet_demo.parse_args(argv), list(photos[:DEMO_PHOTOS]), None, loaded)),
                ("single_photo", lambda: confignet_demo.run_loop(
                    confignet_demo.parse_args(argv), [photos[DEMO_PHOTOS]], None, loaded)))
        for label, fn in runs:
            frame, launches, modes[label] = demo_mode(label, fn, card, kind, DEMO_LAUNCHES_512[label])
            if frame.shape[0] % SIZE_512:  # rows of 512px renders
                raise AssertionError(f"demo 512 {label}: a frame of {frame.shape}")
            total += launches
        if loaded._fine_tuned_generator_params is None or len(loaded.fine_tune_losses) != 1:
            raise AssertionError("the 512px single-photo mode did not fine-tune")
    del loaded, loaded_gan
    torch.cuda.empty_cache()
    return tuple(int(n) for n in total), dict(release=release, modes=modes)


def fine_tune_512(photos, card: str, kind: str, profile_stem=None):
    """(d) fine_tune_on_img on one 512px photo, float32 then bfloat16
    (fine_tune_run: FINE_TUNE_512_ITERS iterations of exactly
    FINE_TUNE_ITER_LAUNCHES_512), and the float32 kernel path against the
    plain path along one trajectory (compare_fine_tune_paths).  Returns (the
    float32 run's launches, the record)."""
    photo, config = photos[0], at_512(serving_config("float32"))
    model = ConfigNet(config)
    give_encoder_heads_weights(model, photos[:8])
    launches, f32 = fine_tune_run(model, photo, "512px float32", card, kind,
                                  FINE_TUNE_512_ITERS, FINE_TUNE_ITER_LAUNCHES_512)
    if profile_stem:
        profile("fine-tune at 512px (float32, 5 iterations)",
                lambda: model.fine_tune_on_img(photo, n_iters=5), profile_stem + "_512_fine_tune.txt")
        model._fine_tuned_generator_params = None
    paths = compare_fine_tune_paths(model, photo, config, FINE_TUNE_ITER_LAUNCHES_512)
    del model
    torch.cuda.empty_cache()
    model = ConfigNet(at_512(serving_config("bfloat16")))
    give_encoder_heads_weights(model, photos[:8])
    _, bf16 = fine_tune_run(model, photo, "512px bfloat16", card, kind, FINE_TUNE_512_ITERS,
                            FINE_TUNE_ITER_LAUNCHES_512)
    del model
    torch.cuda.empty_cache()
    return launches, dict(runs=[f32, bf16], paths=paths)


def train_512(card: str, kind: str):
    """(e) The float32 stage-2 step at 512px, step 8's batch of 24 (32.6 GB
    at its peak on an 80 GB H100), on 64 random images: one warm-up and TRAIN_512_STEPS timed steps of exactly
    TRAIN_STEP_LAUNCHES_512 (train_run: steps/s, peak GB), every
    generator-player parameter with a gradient and the EMA moving, then the
    kernel path against the plain path (compare_train_paths).  Returns (the
    timed steps' launches, the record)."""
    config = at_512(train_config("float32"))
    dataset = FakeDataset(64, SIZE_512, {name: dims[0] for name, dims
                                         in TRAIN_CONFIG["facemodel_inputs"].items()}, seed=16)
    trainer = ConfigNet(config)
    give_encoder_heads_weights(trainer, dataset.imgs[:TRAIN_BATCH])
    ema_before = {k: v.clone() for k, v in trainer.generator_smoothed.state_dict().items()}
    launches, rec, moments = train_run(trainer, dataset, "stage2 512px float32", card, kind,
                                       TRAIN_STEP_LAUNCHES_512, TRAIN_512_STEPS)
    rec.update(check_generator_gradients_and_ema(trainer, moments, ema_before,
                                                 "stage2 512px float32"))
    paths = compare_train_paths(trainer, dataset, "stage2 512px float32", config,
                                TRAIN_STEP_LAUNCHES_512)
    del trainer
    torch.cuda.empty_cache()
    return launches, dict(run=rec, paths=paths)


def path_512(card: str, kind: str, records: list, profile_stem=None) -> tuple:
    """Step 16: the 512px path at full width ((a) to (e) above, (f) with
    ``profile_stem``).  Returns ({path: launches}, the record)."""
    t_step = time.perf_counter()
    for batch in ADAIN_512_BATCHES:
        for dtype in (torch.float32, torch.bfloat16):
            adain_phase(batch, *ADAIN_SITE_512, dtype, records)
    for batch in ADAIN_512_BACKWARD_BATCHES:
        for dtype in (torch.float32, torch.bfloat16):
            adain_backward_phase(batch, *ADAIN_SITE_512, dtype, records)
    routes = {f"{r['kernel']} B{r['batch']} {r['dtype']}": r["route"] for r in records
              if r.get("site") == site(*ADAIN_SITE_512)}
    if set(routes.values()) != {"resident"}:
        raise AssertionError(f"the 512 site left the co-resident route: {routes}")
    torch.cuda.empty_cache()
    photos = np.random.default_rng(16).integers(0, 256, (SERVE_512_PHOTOS, SIZE_512, SIZE_512, 3),
                                                dtype=np.uint8)
    launches, rec = {}, {"routes": routes}
    launches["serve_512"], rec["serve"] = serve_512(photos, card, kind, profile_stem)
    launches["demo_512"], rec["demo"] = demo_512(photos, card, kind)
    launches["fine_tune_512"], rec["fine_tune"] = fine_tune_512(photos, card, kind, profile_stem)
    launches["train_512"], rec["train"] = train_512(card, kind)
    rec["seconds"] = time.perf_counter() - t_step
    print(f"512px: step 16 took {rec['seconds']:.1f} s", flush=True)
    return launches, rec


BENCH_CONFIG = bench_train.BENCH_CONFIG  # also the generator rows' widths (the reference's)
BENCH_ITERS = 2  # the generator rows' forwards and the train rows' steps in step 17
BENCH_FINE_TUNE_ITERS = 5
BENCH_SERVING_ITERS = 2
BENCH_CKPT_WINDOW, BENCH_CKPT_PERIOD = 4, 2
# step 17's rows: the headline, then apps/bench_train.py's eight under their metric names
BENCH_METRICS = (
    "generator_fwd_256_throughput", "stage1_train_step_float32", "stage1_train_step_bfloat16",
    "stage2_train_step_float32", "stage2_train_step_bfloat16", "one_shot_fine_tune",
    "serving_encode_splice_generate", "generator_fwd_512_throughput", "train_loop_ckpt_steady",
    "train_loop_ckpt_async", "train_loop_ckpt_sync", "ckpt_stall_per_event_async",
    "ckpt_overhead_at_500_async", "ckpt_stall_per_event_sync", "ckpt_overhead_at_500_sync")


def bench_shapes() -> dict:
    """Where the bench's rows launch each kernel, from the bench's own
    constants: {kernel: {(batch, dtype, output size)}}.  The generator
    forwards: the headline, the 512px row, serving, the train rows' D renders
    and G halves in both dtypes, the checkpoint windows' panel and metric
    chunks (bf16); the backward kernels: the G halves, and for AdaIN the
    float32 fine-tune's single photo (which also runs AdaIN's forward, but
    resamples without the rotation kernel)."""
    batch = BENCH_CONFIG["batch_size"]
    forward = {(bench.BATCH, "bfloat16", 256), (bench_train.GEN512_BATCH, "bfloat16", 512),
               (bench_train.SERVING_BATCH, "bfloat16", 256), (RENDER_CHUNK, "bfloat16", 256),
               (METRIC_CHUNK, "bfloat16", 256)}
    forward |= {(b, dtype, 256) for b in (batch, batch // 2) for dtype in ("float32", "bfloat16")}
    halves = {(batch // 2, dtype, 256) for dtype in ("float32", "bfloat16")}
    photo = {(1, "float32", 256)}
    return {"rotate_cuda": forward, "adain_cuda": forward | photo,
            "rotate_transpose_cuda": halves, "adain_backward_cuda": halves | photo}


def bench_phases(records: list) -> int:
    """Each kernel against its plain version at every shape of bench_shapes()
    that no phase in ``records`` has checked yet.  Returns the phases run."""
    def checked(kernel, batch, dtype, at=None):
        return any(r["kernel"] == kernel and r["batch"] == batch and r["dtype"] == dtype
                   and r.get("site") == at for r in records)

    sites = {256: ADAIN_SITES_256, 512: ADAIN_SITES_256 + (ADAIN_SITE_512,)}
    phases = {"rotate_cuda": rotate_phase, "rotate_transpose_cuda": transpose_phase}
    site_phases = {"adain_cuda": adain_phase, "adain_backward_cuda": adain_backward_phase}
    n_run = 0
    for kernel, shapes in bench_shapes().items():
        for batch, dtype, size in sorted(shapes):
            if kernel in phases and not checked(kernel, batch, dtype):
                phases[kernel](batch, getattr(torch, dtype), records)
                n_run += 1
            for positions, channels in sites[size] if kernel in site_phases else ():
                if not checked(kernel, batch, dtype, site(positions, channels)):
                    site_phases[kernel](batch, positions, channels, getattr(torch, dtype), records)
                    n_run += 1
    torch.cuda.empty_cache()
    return n_run


def bench_path(card: str, kind: str, records: list) -> tuple:
    """Step 17: the kernels at the bench's shapes (bench_phases), then every
    row of apps/bench.py and apps/bench_train.py at full width and reduced
    counts, each row holding its own timed window's launch counts (zeroed
    just before it, read just after).  Returns (the launches of all the
    windows and graph captures, summed; the record)."""
    t_step = time.perf_counter()
    n_phases = bench_phases(records)
    rows, device, config = [], "cuda", BENCH_CONFIG
    bench_train.generator_throughput(rows, bench.METRIC, 256, bench.BATCH, BENCH_ITERS, device,
                                     config)
    for dtype in ("float32", "bfloat16"):
        bench_train.bench_stage1(rows, dtype, BENCH_ITERS, config, device)
        bench_train.bench_stage2(rows, dtype, BENCH_ITERS, config, device)
    bench_train.bench_fine_tune(rows, BENCH_FINE_TUNE_ITERS, config, device)
    bench_train.bench_serving(rows, BENCH_SERVING_ITERS, config, device)
    bench_train.bench_generator_512(rows, BENCH_ITERS, config, device)
    bench_train.bench_checkpointing(rows, BENCH_CKPT_WINDOW, BENCH_CKPT_PERIOD, config, device)
    torch.cuda.empty_cache()
    if sorted(r["metric"] for r in rows) != sorted(BENCH_METRICS):
        raise AssertionError(f"bench rows {[r['metric'] for r in rows]}, expected {BENCH_METRICS}")
    for row in rows:
        if not (np.isfinite(row["value"]) and row["value"] >= 0
                and (row["card"], row["kind"]) == (card, kind)):
            raise AssertionError(f"bench row {row}")
    # every window once (a derived row repeats the window it is derived from)
    windows = [r["launches"] for r in rows if "windows" not in r]
    windows += [r["graph_launches"] for r in rows if r.get("graph_launches")]
    launches = tuple(sum(w[name] for w in windows) for name in LAUNCH_NAMES)
    rec = dict(rows=rows, phases_run=n_phases, seconds=time.perf_counter() - t_step)
    print(f"bench: step 17 took {rec['seconds']:.1f} s ({n_phases} kernel phases); "
          f"launches {launches}", flush=True)
    return launches, rec


# -- step 18: the captured paths ---------------------------------------------------------

GRAPH_PHOTOS = 64  # encode, render_with_attribute, encode_images: 2 chunks of 32
GRAPH_LATENTS = 256  # generate and sample: 8 chunks of 32; generate_images: 8; FID: 4 of 64
GRAPH_TURNS = 2  # eager, graph, graph, eager: this many times for each path
GRAPH_FINE_TUNE_CHECK_ITERS = 5  # the fine-tunes held bit for bit, eager twice then captured
GRAPH_FINE_TUNE_ITERS = {256: 20, 512: 10}  # the timed fine-tunes (--graphs-only: 50)
GRAPH_TRAIN_CHECK_STEPS = 3  # the train steps held bit for bit, eager then captured
GRAPH_TRAIN_STEPS = {256: 2, 512: 1, "latent_gan": 50}  # a timed turn's steps (--graphs-only: more)
GRAPH_SAMPLE_LATENTS = 4 * SAMPLE_CHUNK  # the LatentGAN sampler: 4 chunks


def _same(a, b) -> bool:
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def graph_against_eager(label: str, call, cache, unit: tuple, chunks: int, images: int,
                        card: str, kind: str) -> dict:
    """One path through its graph cache against the same call run eagerly
    (graphs.eager()): the first call (which captures) and a replayed call
    must give the eager call's bits, the replayed call exactly ``chunks``
    times ``unit`` launches, and each graph captured by the path ``unit``
    a replay.  Then both modes timed in turns (eager, graph, graph, eager,
    GRAPH_TURNS times; img/s, host clock, each call ending on the host),
    with the memory the capture held (reserved after empty_cache, before
    and after the first call) and each mode's peak."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    with graphs.eager():
        eager = call()
    captures, capture_s = cache.captures, cache.capture_seconds
    t0 = time.perf_counter()
    first = call()
    first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - reserved
    zero_launch_counts()
    replayed = call()
    launches = launch_counts()
    recorded = sorted(set(cache.launches_by_name().values()))
    if not (_same(first, eager) and _same(replayed, eager)):
        raise AssertionError(f"graphs {label}: the captured path differs from the eager one")
    if launches != tuple(chunks * n for n in unit) or (cache.active and recorded != [unit]):
        raise AssertionError(f"graphs {label}: launches {launches} for {chunks} chunks, captured "
                             f"{recorded}; expected {unit} a chunk")
    rates, peaks = {"eager": [], "graph": []}, {}
    for mode in ("eager", "graph", "graph", "eager") * GRAPH_TURNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            t0 = time.perf_counter()
            call()
            rates[mode].append(images / (time.perf_counter() - t0))
        peaks[mode] = torch.cuda.max_memory_allocated() / 1e9
    rec = dict(path=label, images=images, chunks=chunks, bit_equal=True,
               launches=dict(zip(LAUNCH_NAMES, launches)), captured=cache.captures - captures,
               capture_s=cache.capture_seconds - capture_s, first_call_s=first_s,
               graph_pool_gb=held / 1e9, eager_img_s=rates["eager"], graph_img_s=rates["graph"],
               eager_peak_gb=peaks["eager"], graph_peak_gb=peaks["graph"])
    print(f"graphs {label}: bit-equal to eager; launches {launches}; {rec['captured']} graph(s) "
          f"captured in {rec['capture_s'] * 1e3:.1f} ms (first call {first_s * 1e3:.1f} ms), pool "
          f"{rec['graph_pool_gb']:.3f} GB; img/s eager {[round(r, 1) for r in rates['eager']]}, "
          f"graph {[round(r, 1) for r in rates['graph']]}; peak GB eager {peaks['eager']:.2f}, "
          f"graph {peaks['graph']:.2f} on {kind} ({card})", flush=True)
    return rec


def fine_tune_graph_run(model, photo, label: str, unit: tuple, iters: int, card: str,
                        kind: str) -> dict:
    """fine_tune_on_img captured against eager.  Under deterministic
    algorithms two eager runs of GRAPH_FINE_TUNE_CHECK_ITERS iterations must
    agree bit for bit (every iteration's loss_sum, the final embeddings and
    rotations, the fine-tuned generator), then a captured run must equal
    them, with ``unit`` launches an iteration through capture and replay;
    then, with the default algorithms, a capture (its time and the memory
    its pool holds) and ``iters`` iterations of each mode timed in turns
    (eager, graph, graph, eager)."""
    def run(n_iters):
        embeddings, rotations = model.fine_tune_on_img(photo, n_iters=n_iters)
        tuned = {k: v.cpu().numpy() for k, v in model._fine_tuned_generator_params.items()}
        return [float(x) for x in model.fine_tune_losses], embeddings, rotations, tuned

    def same(a, b):
        return (a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
                and not unequal_arrays(a[3], b[3]))

    n = GRAPH_FINE_TUNE_CHECK_ITERS
    expected = tuple(n * u for u in unit)
    with bench_train.deterministic_algorithms():
        runs = []
        for mode in ("eager", "eager", "graph"):
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                out, launches = counted(lambda: run(n), expected, f"graphs {label} ({mode})")
            runs.append(out)
        key = model._fine_tune_graph_key(False, 1)
        captured = model._graphs.launches(key) if model._graphs.active else unit
    if not same(runs[0], runs[1]):
        raise AssertionError(f"graphs {label}: two eager fine-tunes from the same weights differ")
    if not same(runs[2], runs[0]) or captured != unit:
        raise AssertionError(f"graphs {label}: the captured fine-tune differs from the eager one "
                             f"(losses {runs[2][0]} vs {runs[0][0]}; captured launches {captured})")
    model._graphs.clear()  # a capture of its own, for its time and pool
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved, capture_s = torch.cuda.memory_reserved(), model._graphs.capture_seconds
    run(2)
    capture_s = model._graphs.capture_seconds - capture_s
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - reserved
    rates = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            t0 = time.perf_counter()
            run(iters)
            rates[mode].append(iters / (time.perf_counter() - t0))
    model._fine_tuned_generator_params = None
    rec = dict(path=label, bit_equal=True, check_iters=n, iters=iters,
               launches=dict(zip(LAUNCH_NAMES, launches)), capture_s=capture_s,
               graph_pool_gb=held / 1e9, eager_iters_s=rates["eager"],
               graph_iters_s=rates["graph"])
    print(f"graphs {label}: {n} iterations bit-equal to eager (two eager runs bit-equal), launches "
          f"{launches}; captured in {capture_s * 1e3:.1f} ms, pool {held / 1e9:.3f} GB; {iters} "
          f"iterations, iters/s eager "
          f"{[round(r, 2) for r in rates['eager']]}, graph {[round(r, 2) for r in rates['graph']]} "
          f"on {kind} ({card})", flush=True)
    return rec


def train_graph_run(model, next_input, label: str, unit: tuple, steps: int, card: str, kind: str,
                    profile_path=None) -> dict:
    """A train step (either stage's, or the LatentGAN's) through its graph
    against eager.  Under deterministic algorithms, after one eager step,
    GRAPH_TRAIN_CHECK_STEPS steps run eagerly and the same steps through the
    graph from the same state and draws (bench_train.captured_against_eager)
    must agree bit for bit in every parameter, Adam moment and step count,
    the EMA generator, every loss and the draw generator's state, with
    ``unit`` launches a captured step; the draws differ from step to step.
    Then, with the default algorithms, a capture of its own (its time, and
    the memory its pool holds: reserved after empty_cache, around the
    capturing call) and ``steps`` steps of each mode timed in turns (eager,
    graph, graph, eager), each turn with exactly ``steps`` times ``unit``
    launches, on inputs staged beforehand; with ``profile_path`` one
    captured and one eager step profiled (<path>_graph.txt, _eager.txt)."""
    step = model._build_train_step()
    n = GRAPH_TRAIN_CHECK_STEPS
    check = bench_train.captured_against_eager(model, step, [next_input() for _ in range(n + 1)],
                                               label)
    if check["launches"] != tuple(n * u for u in unit):
        raise AssertionError(f"graphs {label}: {n} captured steps launched {check['launches']}, "
                             f"expected {unit} a step")
    step.graphs.clear()  # a capture of its own, for its time and pool
    step(next_input())  # the first call with the default algorithms: eager
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved, capture_s = torch.cuda.memory_reserved(), step.graphs.capture_seconds
    t0 = time.perf_counter()
    check_finite(step(next_input()), label)
    first_s = time.perf_counter() - t0
    capture_s = step.graphs.capture_seconds - capture_s
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - reserved
    rates, peaks = {"eager": [], "graph": []}, {}
    for mode in ("eager", "graph", "graph", "eager"):
        inputs = [next_input() for _ in range(steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            t0 = time.perf_counter()
            for x in inputs:
                losses = step(x)
            losses["g"]["loss_sum"].item()
            rates[mode].append(steps / (time.perf_counter() - t0))
        if launch_counts() != tuple(steps * u for u in unit):
            raise AssertionError(f"graphs {label} ({mode}): launches {launch_counts()} in {steps} "
                                 f"steps, expected {unit} a step")
        check_finite(losses, label)
        peaks[mode] = torch.cuda.max_memory_allocated() / 1e9
    rec = dict(path=label, bit_equal=True, check_steps=n, tensors=check["tensors"],
               launches=dict(zip(LAUNCH_NAMES, check["launches"])),
               launches_per_step=dict(zip(LAUNCH_NAMES, unit)), capture_s=capture_s,
               first_call_s=first_s, graph_pool_gb=held / 1e9, steps=steps,
               eager_steps_s=rates["eager"], graph_steps_s=rates["graph"],
               eager_peak_gb=peaks["eager"], graph_peak_gb=peaks["graph"])
    print(f"graphs {label}: {n} steps bit-equal to eager ({check['tensors']} state tensors, every "
          f"loss, the draw generator), launches {check['launches']}; captured in "
          f"{capture_s * 1e3:.1f} ms (first call {first_s * 1e3:.1f} ms), pool "
          f"{held / 1e9:.3f} GB; "
          f"steps/s eager {[round(r, 3) for r in rates['eager']]}, graph "
          f"{[round(r, 3) for r in rates['graph']]}; peak GB eager {peaks['eager']:.2f}, graph "
          f"{peaks['graph']:.2f} on {kind} ({card})", flush=True)
    if profile_path:
        x = next_input()
        for mode in ("graph", "eager"):
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                rec[f"profile_{mode}"] = profile(f"{label} step ({mode})", lambda: step(x),
                                                 f"{profile_path}_{mode}.txt")
    return rec


def train_graphs(card: str, kind: str, profile_stem=None) -> list:
    """Step 18's train paths, through train_graph_run: the stage-1 step at
    full width in float32 and bfloat16, the float32 stage-2 step at 256px
    and at 512px (the seventh AdaIN site's co-resident launches captured),
    the LatentGAN's step (batch 32, latent_dim 145); then its sampler,
    generate_latents_smoothed, over GRAPH_SAMPLE_LATENTS latents
    (graph_against_eager)."""
    dims = {name: d[0] for name, d in TRAIN_CONFIG["facemodel_inputs"].items()}
    records = []
    for label, cls, config, size in (
            ("stage1 float32", ConfigNetFirstStage, train_config("float32"), 256),
            ("stage1 bfloat16", ConfigNetFirstStage, train_config("bfloat16"), 256),
            ("stage2 float32", ConfigNet, train_config("float32"), 256),
            ("stage2 512px float32", ConfigNet, at_512(train_config("float32")), SIZE_512)):
        dataset = FakeDataset(64, size, dims, seed=18)
        model = cls(config)
        if cls is ConfigNet:
            give_encoder_heads_weights(model, dataset.imgs[:TRAIN_BATCH])

        def next_batch():
            return model._batch_to_device(model._sample_host_batch(dataset, dataset))

        profile_path = (f"{profile_stem}_graph_{label.replace(' ', '_')}"
                        if profile_stem and size == 256 and "bfloat16" not in label else None)
        records.append(train_graph_run(model, next_batch, label, unit_launches("train_step", size),
                                       GRAPH_TRAIN_STEPS[size], card, kind, profile_path))
        del model, next_batch
        gc.collect()
        torch.cuda.empty_cache()

    latent_dim = sum(d[1] for d in TRAIN_CONFIG["facemodel_inputs"].values())
    gan = LatentGAN({"latent_dim": latent_dim})
    embeddings = torch.from_numpy(np.random.default_rng(18).normal(
        size=(LOOP_IMAGES, latent_dim)).astype(np.float32)).to(gan.device)
    rng = np.random.default_rng(19)

    def next_real():
        idx = torch.from_numpy(rng.integers(0, LOOP_IMAGES, gan.config["batch_size"]))
        return embeddings[idx.to(gan.device)]

    records.append(train_graph_run(
        gan, next_real, "latent_gan step", (0, 0, 0, 0), GRAPH_TRAIN_STEPS["latent_gan"], card,
        kind, profile_stem and f"{profile_stem}_graph_latent_gan"))
    noise = np.random.default_rng(20).normal(size=(GRAPH_SAMPLE_LATENTS, latent_dim))
    gan._graphs.clear()
    records.append(graph_against_eager(
        "latent_gan generate_latents_smoothed", lambda: gan.generate_latents_smoothed(noise),
        gan._graphs, (0, 0, 0, 0), GRAPH_SAMPLE_LATENTS // SAMPLE_CHUNK, GRAPH_SAMPLE_LATENTS,
        card, kind))
    return records


def graph_key_costs(server, model, photos, blend, latents, rotations, card: str,
                    kind: str) -> dict:
    """The host time a chunk spends building its graph key (the modules'
    parameters and buffers walked for their addresses), in microseconds, for
    the server's generate and render_with_attribute chunks and a fused FID
    chunk: the mean of 200 builds."""
    def chunk(a, n=SERVE_CHUNK):
        return torch.from_numpy(np.ascontiguousarray(a[:n]))

    extractor = model._inception_metric_object.inception_feature_extractor
    builds = {
        "generate": lambda: server._graphs.key(
            "generate", (server._generator,), (chunk(latents), chunk(rotations))),
        "render_with_attribute": lambda: server._graphs.key(
            ("render_with_attribute", "blendshape_values"),
            (server._encoder, server._synthetic_encoder, server._generator),
            (chunk(photos), torch.from_numpy(blend))),
        "metric_features": lambda: model._graphs.key(
            "metric_features", (model._inference_generator(), extractor.module),
            (chunk(latents, METRIC_CHUNK), chunk(rotations, METRIC_CHUNK))),
    }
    costs = {}
    for label, build in builds.items():
        build()
        t0 = time.perf_counter()
        for _ in range(200):
            build()
        costs[label] = (time.perf_counter() - t0) / 200 * 1e6
    print(f"graphs key construction, microseconds a chunk: "
          f"{ {k: round(v, 1) for k, v in costs.items()} } on {kind} ({card})", flush=True)
    return costs


def graphs_path(card: str, kind: str, profile_stem=None) -> tuple:
    """Step 18: every path the JAX package jits, through the port's graph
    caches (core/graphs.py), held against its eager run bit for bit, its
    launches counted through capture and replay, timed in turns: the bf16
    256px server's encode, generate, render_with_attribute and sample
    (chunk 32); the model's generate_images (32), fused FID features (64)
    and encode_images (32); fine_tune_on_img in float32 at 256px and 512px
    (the 512px backward on the co-resident route, captured).  With
    ``profile_stem``, a warm generate chunk and a 10-iteration fine-tune,
    each captured and eager (<stem>_graph_*.txt).  Returns (the launches of
    the captured runs: each path's replayed call and captured fine-tune,
    summed; the record)."""
    t_step = time.perf_counter()
    rng = np.random.default_rng(18)
    model = ConfigNet(serving_config("bfloat16"))
    size = model.config["output_shape"][0]
    photos = rng.integers(0, 256, (GRAPH_PHOTOS, size, size, 3), dtype=np.uint8)
    give_encoder_heads_weights(model, photos[:SERVE_CHUNK])
    server = ConfigNetServer(model, LatentGAN({"latent_dim": model.config["latent_dim"]}),
                             chunk=SERVE_CHUNK)
    n_blend = model.config["facemodel_inputs"]["blendshape_values"][0]
    blend = rng.uniform(0, 1, size=(1, n_blend)).astype(np.float32)
    latents = rng.normal(size=(GRAPH_LATENTS, model.config["latent_dim"])).astype(np.float32)
    rotations = poses(GRAPH_LATENTS, rng)
    model._inception_metric_object = types.SimpleNamespace(
        inception_feature_extractor=InceptionFeatureExtractor((size, size, 3)))

    def sample():
        np.random.seed(18)
        return server.sample(GRAPH_LATENTS, rotations=rotations, truncation=0.7)

    none = (0, 0, 0, 0)
    paths = [
        ("encode", lambda: server.encode(photos), server._graphs, none,
         GRAPH_PHOTOS // SERVE_CHUNK, GRAPH_PHOTOS),
        ("generate", lambda: server.generate(latents, rotations), server._graphs, CHUNK_LAUNCHES,
         GRAPH_LATENTS // SERVE_CHUNK, GRAPH_LATENTS),
        ("render_with_attribute", lambda: server.render_with_attribute(
            photos, "blendshape_values", blend), server._graphs, CHUNK_LAUNCHES,
         GRAPH_PHOTOS // SERVE_CHUNK, GRAPH_PHOTOS),
        ("sample", sample, server._graphs, CHUNK_LAUNCHES, GRAPH_LATENTS // SERVE_CHUNK,
         GRAPH_LATENTS),
        ("generate_images", lambda: model.generate_images(latents, rotations), model._graphs,
         CHUNK_LAUNCHES, GRAPH_LATENTS // RENDER_CHUNK, GRAPH_LATENTS),
        ("metric_features", lambda: model._metric_features_for_latents(latents, rotations),
         model._graphs, CHUNK_LAUNCHES, GRAPH_LATENTS // METRIC_CHUNK, GRAPH_LATENTS),
        ("encode_images", lambda: model.encode_images(photos), model._graphs, none,
         GRAPH_PHOTOS // RENDER_CHUNK, GRAPH_PHOTOS),
    ]
    rec = {"paths": []}
    for label, call, cache, unit, chunks, images in paths:
        cache.clear()  # each path's graphs alone in its cache, so its pool is its own
        rec["paths"].append(graph_against_eager(label, call, cache, unit, chunks, images, card,
                                                kind))
    rec["key_us"] = graph_key_costs(server, model, photos, blend, latents, rotations, card, kind)
    if profile_stem:
        chunk = (latents[:SERVE_CHUNK], rotations[:SERVE_CHUNK])
        for mode in ("graph", "eager"):
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                rec[f"profile_generate_{mode}"] = profile(
                    f"generate chunk {SERVE_CHUNK} ({mode})", lambda: server.generate(*chunk),
                    f"{profile_stem}_graph_generate_{mode}.txt")
    del server, model
    gc.collect()
    torch.cuda.empty_cache()

    for size, config, unit in ((256, serving_config("float32"), FINE_TUNE_ITER_LAUNCHES),
                               (SIZE_512, at_512(serving_config("float32")),
                                FINE_TUNE_ITER_LAUNCHES_512)):
        model = ConfigNet(config)
        side = model.config["output_shape"][0]
        photo = np.random.default_rng(size).integers(0, 256, (side, side, 3), dtype=np.uint8)
        give_encoder_heads_weights(model, photo[np.newaxis])
        rec["paths"].append(fine_tune_graph_run(model, photo, f"fine_tune_on_img {size}px float32",
                                                unit, GRAPH_FINE_TUNE_ITERS[size], card, kind))
        if profile_stem and size == 256:
            for mode in ("graph", "eager"):
                with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                    rec[f"profile_fine_tune_{mode}"] = profile(
                        f"fine-tune 10 iterations ({mode})",
                        lambda: model.fine_tune_on_img(photo, n_iters=10),
                        f"{profile_stem}_graph_fine_tune_{mode}.txt")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    rec["paths"] += train_graphs(card, kind, profile_stem)
    # the captured runs' launches: each check zeroes the counters before its own
    launches = tuple(sum(r["launches"][name] for r in rec["paths"]) for name in LAUNCH_NAMES)
    rec["seconds"] = time.perf_counter() - t_step
    print(f"graphs: step 18 took {rec['seconds']:.1f} s; launches of the captured runs "
          f"{launches}", flush=True)
    return launches, rec


def profile(label: str, fn, path: str) -> dict:
    """Device time of one warm call of ``fn``, by kernel name
    (torch.profiler), beside its host wall time; returns the totals."""
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
    # a user annotation's range (the optimizers' "Optimizer.step#...") spans
    # kernels that are counted themselves
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    by_shape = prof.key_averages(group_by_input_shape=True).table(
        sort_by="cuda_time_total", row_limit=25, max_name_column_width=40,
        max_shapes_column_width=160)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(f"{label}: wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms\n"
                          f"{table}\n\nby input shape:\n{by_shape}\n")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    n_ops = sum(e.count for e in events)
    print(f"profile {label}: wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms "
          f"({100 * device_ms / wall_ms:.1f}%), {n_ops} device ops", flush=True)
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, busy=device_ms / wall_ms, device_ops=n_ops)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write every record to this JSON file")
    parser.add_argument("--profile", help="also profile one warm generate chunk of the bf16 "
                        "server with torch.profiler and write its kernel table here (and, beside "
                        "it, one float32 train step's of each stage, as <stem>_train.txt and "
                        "<stem>_train2.txt, a float32 fine-tune of 10 iterations, as "
                        "<stem>_fine_tune.txt, one LatentGAN step, as <stem>_latent_gan.txt, "
                        "one sampled chunk, as <stem>_sample.txt, one fused FID chunk, as "
                        "<stem>_fid.txt, one controllability request, as <stem>_contr.txt, and one "
                        "stage-1 loop window of 3 steps with a checkpoint, as <stem>_loop.txt)")
    parser.add_argument("--loops-only", action="store_true",
                        help="only build the kernels and run step 13, the train() loops, then stop "
                        "(no kernels line and no result line)")
    parser.add_argument("--demo-only", action="store_true",
                        help="only build the kernels and run step 14, the demo path, then stop "
                        "(no kernels line and no result line)")
    parser.add_argument("--mesh-only", action="store_true",
                        help="only build the kernels and run step 15, the mesh path, then stop "
                        "(no kernels line and no result line)")
    parser.add_argument("--512-only", dest="only_512", action="store_true",
                        help="only build the kernels and run step 16, the 512px path, then stop "
                        "(no kernels line and no result line)")
    parser.add_argument("--bench-only", action="store_true",
                        help="only build the kernels and run step 17, the bench rows, then stop "
                        "(no kernels line and no result line)")
    parser.add_argument("--graphs-only", action="store_true",
                        help="only build the kernels and run step 18, the captured paths, at the "
                        "measurement's counts (50 fine-tune iterations at 256px and 512px, three "
                        "turns, train turns of 5 / 2 / 200 steps), then stop (no kernels line and "
                        "no result line)")
    parser.add_argument("--first-step-probe", metavar="PATH",
                        help="only build the kernels, run three float32 stage-2 steps from the same "
                        "weights with every op digested, write where the first differs to PATH "
                        "and stop")
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
    if args.first_step_probe:
        first_step_probe(card, kind, args.first_step_probe)
        return 0
    profile_stem = args.profile and str(Path(args.profile).with_name(Path(args.profile).stem))
    if args.loops_only:
        _, loops = training_loops(card, kind, profile_stem)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"card": card, "kind": kind, "loops": loops}, indent=1))
        print(f"total {time.perf_counter() - t_start:.1f} s (step 13 only)")
        return 0
    if args.demo_only:
        _, demo = demo_path(card, kind)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"card": card, "kind": kind, "demo": demo}, indent=1))
        print(f"total {time.perf_counter() - t_start:.1f} s (step 14 only)")
        return 0
    if args.mesh_only:
        *_, mesh = mesh_path(card, kind)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"card": card, "kind": kind, "mesh": mesh}, indent=1))
        print(f"total {time.perf_counter() - t_start:.1f} s (step 15 only)")
        return 0
    if args.only_512:
        records = []
        launches_512, rec_512 = path_512(card, kind, records, profile_stem)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"card": card, "kind": kind, "phases": records,
                                                  "launches": launches_512, "path_512": rec_512},
                                                 indent=1))
        print(f"total {time.perf_counter() - t_start:.1f} s (step 16 only)")
        return 0
    if args.graphs_only:
        global GRAPH_TURNS
        GRAPH_TURNS = 3
        GRAPH_FINE_TUNE_ITERS.update({256: 50, 512: 50})
        GRAPH_TRAIN_STEPS.update({256: 5, 512: 2, "latent_gan": 200})
        _, graph_rec = graphs_path(card, kind, profile_stem)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"card": card, "kind": kind, "graphs": graph_rec},
                                                 indent=1))
        print(f"total {time.perf_counter() - t_start:.1f} s (step 18 only)")
        return 0
    if args.bench_only:
        records = []
        _, bench_rec = bench_path(card, kind, records)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"card": card, "kind": kind, "phases": records,
                                                  "bench": bench_rec}, indent=1))
        print(f"total {time.perf_counter() - t_start:.1f} s (step 17 only)")
        return 0

    # -- 3. kernel phases ------------------------------------------------------
    records = []
    for batch in (SERVE_CHUNK, FID_CHUNK, 256):
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
    # the fine-tune's batch and the tuned controllability's renders: one photo
    rotate_phase(1, torch.float32, records)
    for dtype in (torch.float32, torch.bfloat16):
        for positions, channels in ADAIN_SITES_256:
            adain_phase(1, positions, channels, dtype, records)
    # the float32 servers' folded encoders: a full chunk (timed), step 5's and
    # step 16's chunks of 8, the fine-tunes' refreshed servers' single photo
    for size in (256, SIZE_512):
        for batch in (SERVE_CHUNK, 8, 1):
            epilogue_phase(size, batch, records, timed=batch == SERVE_CHUNK)
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
    zero_launch_counts()
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
    path_launches = {"serve": launch_counts()}
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
        check_renders(results[name], n, name)
    del server, model, results
    torch.cuda.empty_cache()

    # -- 5. kernel path vs plain path, float32 ------------------------------------
    model_k = ConfigNet(serving_config("float32"))
    give_encoder_heads_weights(model_k, photos[:8])
    model_p = ConfigNet(serving_config("float32", rotation_resample="gather", adain_impl="plain"))
    model_p.set_weights(model_k.get_weights())
    before = (rotate_3d_grid_forward.launches, fused_adain_forward.launches)
    epilogues = conv_epilogue.launches
    out_p = ConfigNetServer(model_p, chunk=8).render_with_attribute(photos[:8], "blendshape_values", blend)
    if (rotate_3d_grid_forward.launches, fused_adain_forward.launches) != before:
        raise AssertionError("the plain-path server launched a kernel")
    out_k = ConfigNetServer(model_k, chunk=8).render_with_attribute(photos[:8], "blendshape_values", blend)
    if (rotate_3d_grid_forward.launches - before[0], fused_adain_forward.launches - before[1]) != (1, 6):
        raise AssertionError("the kernel-path server did not go through the kernels")
    # both servers' folded float32 encoders, one chunk each (eager: its first call)
    if conv_epilogue.launches - epilogues != 2 * TRUNK_EPILOGUES:
        raise AssertionError(f"{conv_epilogue.launches - epilogues} epilogue launches for two "
                             f"encoder chunks, not {2 * TRUNK_EPILOGUES}")
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
    for batch in (TRAIN_BATCH // 2, TRAIN_BATCH, 1):
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
    path_launches["train_stage1"], train_f32, moments = train_run(trainer, dataset,
                                                                  "stage1 float32", card, kind)
    train_f32.update(check_generator_gradients_and_ema(trainer, moments, ema_before,
                                                       "stage1 float32"))

    def profile_step(model, label, suffix):
        """One step as the loop runs it: a replay (a first call, eager,
        then profile's warm call, which captures)."""
        step = model._build_train_step()
        batch = model._sample_host_batch(dataset, dataset)
        step(batch)
        profile(label, lambda: step(batch),
                str(Path(args.profile).with_name(Path(args.profile).stem + suffix)))

    if args.profile:
        profile_step(trainer, "train step (stage 1, float32, batch 24)", "_train.txt")
    train_paths = compare_train_paths(trainer, dataset, "stage1 float32")
    del trainer
    torch.cuda.empty_cache()
    _, train_bf16, _ = train_run(ConfigNetFirstStage(train_config("bfloat16")), dataset,
                                 "stage1 bfloat16", card, kind)
    torch.cuda.empty_cache()

    # -- 8. stage-2 training at full width ---------------------------------------------
    def stage2_trainer(compute_dtype):
        t0 = time.perf_counter()
        trainer = ConfigNet(train_config(compute_dtype))
        give_encoder_heads_weights(trainer, dataset.imgs[:TRAIN_BATCH])
        print(f"stage-2 trainer ({compute_dtype}): built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        return trainer, {k: v.clone() for k, v in trainer.generator_smoothed.state_dict().items()}

    trainer, ema_before = stage2_trainer("float32")
    path_launches["train_stage2"], train2_f32, moments = train_run(trainer, dataset,
                                                                   "stage2 float32", card, kind)
    train2_f32.update(check_generator_gradients_and_ema(trainer, moments, ema_before,
                                                        "stage2 float32"))
    if args.profile:
        profile_step(trainer, "train step (stage 2, float32, batch 24)", "_train2.txt")
    train2_paths = compare_train_paths(trainer, dataset, "stage2 float32")
    del trainer
    torch.cuda.empty_cache()
    trainer, ema_before = stage2_trainer("bfloat16")
    _, train2_bf16, moments = train_run(trainer, dataset, "stage2 bfloat16", card, kind)
    train2_bf16.update(check_generator_gradients_and_ema(trainer, moments, ema_before,
                                                         "stage2 bfloat16"))
    del trainer
    torch.cuda.empty_cache()

    # -- 9. one-shot fine-tune at full width; 10. its kernel path vs plain path ---------
    photo = photos[0]
    model = ConfigNet(serving_config("float32"))
    give_encoder_heads_weights(model, photos[:8])
    path_launches["fine_tune"], fine_tune_f32 = fine_tune_run(model, photo, "float32", card, kind)
    if args.profile:
        profile("fine-tune (float32, 10 iterations)",
                lambda: model.fine_tune_on_img(photo, n_iters=10),
                str(Path(args.profile).with_name(Path(args.profile).stem + "_fine_tune.txt")))
    fine_tune_paths = compare_fine_tune_paths(model, photo)
    del model
    torch.cuda.empty_cache()
    model = ConfigNet(serving_config("bfloat16"))
    give_encoder_heads_weights(model, photos[:8])
    _, fine_tune_bf16 = fine_tune_run(model, photo, "bfloat16", card, kind)
    del model
    torch.cuda.empty_cache()

    # -- 11. the sampling path: checkpoint files, LatentGAN, photo-free samples --------
    path_launches["sample"], sampling = sampling_path(card, kind, profile_stem)
    torch.cuda.empty_cache()

    # -- 12. the evaluation path: dataset, FID/KID, attribute judge, controllability ----
    path_launches["evaluate"], evaluation = evaluation_path(card, kind, profile_stem)
    torch.cuda.empty_cache()

    # -- 13. the train() loops: stage 1, resume, async against sync, prefetch, stage 2, GAN --
    path_launches["train_loop"], loops = training_loops(card, kind, profile_stem)
    torch.cuda.empty_cache()

    # -- 14. the demo path: a reference release, the three input modes, the warp --------
    path_launches["demo"], demo = demo_path(card, kind)
    torch.cuda.empty_cache()

    # -- 15. the mesh path: the native gather, a world-size-1 group, two ranks on one card --
    path_launches["train_mesh"], path_launches["serve_mesh"], mesh = mesh_path(card, kind)
    torch.cuda.empty_cache()

    # -- 16. the 512px path: the seventh AdaIN site, serving, the demo, fine-tune, training --
    launches_512, rec_512 = path_512(card, kind, records, profile_stem)
    path_launches.update(launches_512)
    torch.cuda.empty_cache()

    # -- 17. the bench: apps/bench.py's headline and apps/bench_train.py's rows ---------
    path_launches["bench"], bench_rec = bench_path(card, kind, records)
    torch.cuda.empty_cache()

    # -- 18. the captured paths: every jitted path of the JAX package against its eager run --
    path_launches["graphs"], graph_rec = graphs_path(card, kind, profile_stem)
    torch.cuda.empty_cache()

    # -- 19. records -----------------------------------------------------------------
    sites_256 = {site(*s) for s in ADAIN_SITES_256}
    sites_512 = sites_256 | {site(*ADAIN_SITE_512)}

    def times(phase_counts, dtype="float32", sites=sites_256):
        """The phases at a path's shapes, each counted as often as the path
        launches it (AdaIN at the given sites): error, times and bound of the
        path's launches."""
        picked = [(r, n) for r in records for (name, batch), n in phase_counts.items()
                  if r["kernel"] == name and r["batch"] == batch and r["dtype"] == dtype
                  and r.get("site", "") in sites | {""}]
        summed = {key: sum(r[key] * n for r, n in picked)
                  for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                              "library_device_ms")}
        return dict(max_abs_err=max(r["max_abs_err"] for r, _ in picked), **summed,
                    bound_by="bytes" if all(r["bound_by"] == "bytes" for r, _ in picked)
                    else "operations"), picked

    def entry(kernel, source, replaces, index, phase_counts):
        """Launches on each path (``launches``: the float32 stage-2 train
        run's), and the times of one float32 train step's launches; for
        AdaIN also those of one fine-tune iteration's (six sites at B=1)."""
        step_times, picked = times(phase_counts)
        item = {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "launches": path_launches["train_stage2"][index],
                "launches_by_path": {path: counts[index] for path, counts in path_launches.items()},
                **step_times}
        # one float32 stage-2 step at 512px: the same rotation shapes, AdaIN at seven sites
        item["train_step_512"] = times(phase_counts, sites=sites_512)[0]
        if any("site" in r for r, _ in picked):  # AdaIN: the route of each site and batch
            item["site_routes"] = {f"B{r['batch']} {r['site']}": r["route"] for r, _ in picked}
            item["site_routes"].update({f"B{r['batch']} {r['dtype']} {r['site']}": r["route"]
                                        for r in records if r["kernel"] == kernel
                                        and r.get("site") == site(*ADAIN_SITE_512)})
            item["fine_tune_iteration"] = {dtype: times({(kernel, 1): 1}, dtype)[0]
                                           for dtype in ("float32", "bfloat16")}
            item["fine_tune_iteration_512"] = {dtype: times({(kernel, 1): 1}, dtype, sites_512)[0]
                                               for dtype in ("float32", "bfloat16")}
        else:  # rotation: the tiles of each batch
            item["plans"] = {f"B{r['batch']}": r["plan"] for r, _ in picked}
        return item

    half = TRAIN_BATCH // 2
    kernels = [
        entry("rotate_cuda", "confignet_tpu_torch/csrc/rotate.cu",
              "confignet_tpu/ops/rotate_pallas.py:65", 0,
              {("rotate_cuda", TRAIN_BATCH): 2, ("rotate_cuda", half): 2}),
        entry("rotate_transpose_cuda", "confignet_tpu_torch/csrc/rotate.cu",
              "confignet_tpu/ops/rotate_pallas.py:95", 1,
              {("rotate_transpose_cuda", half): 2}),
        entry("adain_cuda", "confignet_tpu_torch/csrc/adain.cu",
              "confignet_tpu/ops/adain_pallas.py:29", 2,
              {("adain_cuda", TRAIN_BATCH): 2, ("adain_cuda", half): 2}),
        entry("adain_backward_cuda", "confignet_tpu_torch/csrc/adain.cu",
              "confignet_tpu/ops/adain_pallas.py:87", 3,
              {("adain_backward_cuda", half): 2}),
    ]
    # the kernels each path runs: serving and sampling render only; the
    # fine-tune resamples with the gather form; the evaluation renders, and
    # fine-tunes with per_image_tuning_iters
    on_path = {"serve": {"rotate_cuda", "adain_cuda"},
               "train_stage1": {item["name"] for item in kernels},
               "train_stage2": {item["name"] for item in kernels},
               "fine_tune": {"adain_cuda", "adain_backward_cuda"},
               "sample": {"rotate_cuda", "adain_cuda"},
               "evaluate": {"rotate_cuda", "adain_cuda", "adain_backward_cuda"},
               "train_loop": {item["name"] for item in kernels},
               "demo": {"rotate_cuda", "adain_cuda", "adain_backward_cuda"},
               "train_mesh": {item["name"] for item in kernels},
               "serve_mesh": {"rotate_cuda", "adain_cuda"},
               "serve_512": {"rotate_cuda", "adain_cuda"},
               "demo_512": {"rotate_cuda", "adain_cuda", "adain_backward_cuda"},
               "fine_tune_512": {"adain_cuda", "adain_backward_cuda"},
               "train_512": {item["name"] for item in kernels},
               "bench": {item["name"] for item in kernels},
               "graphs": {item["name"] for item in kernels}}
    for item in kernels:
        missed = [path for path, names in on_path.items()
                  if item["name"] in names and item["launches_by_path"][path] < 1]
        if missed:
            raise AssertionError(f"{item['name']} was not launched on the {missed} path(s)")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kind": kind, "torch": torch.__version__, "cuda": torch.version.cuda,
             "phases": records, "serving": served, "e2e_mean_abs_uint8": e2e,
             "train": [train_f32, train_bf16], "train_paths": train_paths,
             "train_stage2": [train2_f32, train2_bf16], "train_stage2_paths": train2_paths,
             "fine_tune": [fine_tune_f32, fine_tune_bf16], "fine_tune_paths": fine_tune_paths,
             "sampling": sampling, "evaluation": evaluation, "loops": loops, "demo": demo,
             "mesh": mesh, "path_512": rec_512, "bench": bench_rec, "graphs": graph_rec,
             "kernels": kernels, "seconds": time.perf_counter() - t_start}, indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
