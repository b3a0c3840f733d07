"""The server's encoder snapshot with each frozen batch norm folded into the
float32 convolution before it (``models/backbones/resnet.fold_frozen_norms``,
called by ``ConfigNetServer.refresh``) against the unfolded encoder the model
keeps.  A bfloat16 trunk keeps its norms: their float32 multiply is what
lifts its stream back to float32.

The norms get random statistics (gamma, beta, mean, variance > 0) and the
convolutions random biases: at a fresh model's constants (1, 0, 0, 1) and
zero biases a wrong fold could not be told from a right one.  The encoder's
zero-initialised heads are scaled so latents and poses are of unit scale.
In float64 the fold is exact to 1e-12; in float32 the folded trunk sits as
close to the float64 trunk as the unfolded one does (both about 5e-7
relative), so "within rounding" below is 2e-6 relative.

The server's float32 trunk runs channels-first inside
(``models/backbones/resnet.py``); :func:`force_channels_last` puts a
snapshot's trunk through the channels-last formula instead, for holding the
route against it.

The tests marked ``gpu`` render two 512px requests of the bulk cell's shape
(chunks of 32, padded tails) through a folded and an unfolded server, and
through the folded server on its channels-first route and the same snapshot
forced channels-last, with random norm statistics, and hold them to the
cell's checks; they import no JAX, so on a machine without it:
python -m pytest --noconftest -m gpu tests/test_torch_fold_norms.py
"""
import copy
import functools
import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from helpers import TINY_FIRST_STAGE_CONFIG
from confignet_tpu_torch.core import graphs, tracing
from confignet_tpu_torch.models.backbones.resnet import (FrozenBatchNorm, GroupNorm,
                                                         fold_frozen_norms, resnet50_preprocess)
from confignet_tpu_torch.models.blocks import Conv2d
from confignet_tpu_torch.serving import ConfigNetServer
from confignet_tpu_torch.training.second_stage import ConfigNet

torch.set_num_threads(1)

# the stem's, three a bottleneck block's (16 blocks) and four projections'
N_NORMS = 53
ROUNDING = 2e-6
CHUNK = 4


@torch.no_grad()
def randomize_norms(encoder: nn.Module, seed: int) -> None:
    """Random statistics in every frozen norm, random biases in every
    convolution of ``encoder``'s trunk."""
    g = torch.Generator().manual_seed(seed)
    for m in encoder.resnet.modules():
        if isinstance(m, FrozenBatchNorm):
            n = m.gamma.numel()
            m.gamma.copy_(torch.rand(n, generator=g) + 0.5)
            m.beta.copy_(torch.randn(n, generator=g))
            m.moving_mean.copy_(torch.randn(n, generator=g))
            m.moving_variance.copy_(torch.rand(n, generator=g) * 1.5 + 0.5)
        elif isinstance(m, Conv2d):
            m.bias.copy_(torch.randn(m.bias.shape, generator=g))


@torch.no_grad()
def scale_heads(encoder: nn.Module, photos_u8: np.ndarray) -> None:
    """The encoder's heads to unit-scale outputs on ``photos_u8``."""
    device = next(encoder.parameters()).device
    x = torch.from_numpy(photos_u8).to(device).float() / 127.5 - 1.0
    rms = float(encoder.resnet(resnet50_preprocess(x)).float().square().mean().sqrt())
    g = torch.Generator().manual_seed(1)
    for head in (encoder.feature_to_latent, encoder.rotation_regressor):
        w = torch.randn(head.weight.shape, generator=g)
        head.weight.copy_(w / (w.square().mean().sqrt() * head.weight.shape[1] ** 0.5 * rms))


def force_channels_last(encoder: nn.Module) -> None:
    """``encoder``'s trunk through the channels-last formula from now on,
    whatever its dtype (a bound method, so a deep copy keeps to its own
    trunk)."""
    trunk = encoder.resnet
    trunk.forward = functools.partial(trunk.features, channels_first=False)


def _route_ticks() -> float:
    return tracing.totals.get("resnet.channels_first", 0)


def _photos(n, seed, size=128):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def _count(module: nn.Module, kind: type) -> int:
    return sum(isinstance(m, kind) for m in module.modules())


@pytest.fixture(scope="module")
def model():
    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
    randomize_norms(model.real_encoder, seed=0)
    scale_heads(model.real_encoder, _photos(4, 10))
    return model


def _inputs(n=3, seed=0):
    return torch.from_numpy(_photos(n, seed)).float() / 127.5 - 1.0


def test_fold_is_exact_in_float64(model):
    unfolded = copy.deepcopy(model.real_encoder.resnet).double()
    folded = copy.deepcopy(unfolded)
    assert fold_frozen_norms(folded) == N_NORMS
    x = resnet50_preprocess(_inputs().double())
    with torch.no_grad():
        assert _rel(folded(x), unfolded(x)) < 1e-12


def test_folded_trunk_within_float32_rounding(model):
    """Float32, folded and unfolded, each against the float64 trunk and
    against each other."""
    trunk = model.real_encoder.resnet
    folded = copy.deepcopy(trunk)
    assert fold_frozen_norms(folded) == N_NORMS
    x = resnet50_preprocess(_inputs())
    with torch.no_grad():
        want = copy.deepcopy(trunk).double()(x.double())
        unfolded_out, folded_out = trunk(x), folded(x)
    assert folded_out.abs().max() > 1e3  # the random trunk amplifies
    assert _rel(unfolded_out, want) < ROUNDING
    assert _rel(folded_out, want) < ROUNDING
    assert _rel(folded_out, unfolded_out) < ROUNDING


def test_fold_takes_every_frozen_norm_and_only_those(model):
    folded = copy.deepcopy(model.real_encoder)
    assert fold_frozen_norms(folded.resnet) == N_NORMS
    assert _count(folded, FrozenBatchNorm) == 0
    assert _count(folded, nn.Identity) == N_NORMS
    # the statistics leave the tree; the convolutions and heads stay
    keys = set(folded.state_dict())
    assert not any(k.endswith(("moving_mean", "moving_variance", "gamma", "beta")) for k in keys)
    assert keys == {k for k in model.real_encoder.state_dict()
                    if not k.endswith(("moving_mean", "moving_variance", "gamma", "beta"))}
    assert fold_frozen_norms(folded.resnet) == 0  # nothing left to fold


def test_folded_scale_is_the_forwards(model):
    """One formula: the scale the fold multiplies the kernel by is, bit for
    bit, the one the unfolded norm multiplies its input by."""
    trunk = model.real_encoder.resnet
    norm, conv = trunk.stem_bn, trunk.stem_conv
    scale, shift = norm.scale_shift()
    probe = torch.ones((1, 1, 1, norm.gamma.numel()))
    with torch.no_grad():
        assert torch.equal(norm(probe).reshape(-1), (probe * scale + shift).reshape(-1))
    folded = copy.deepcopy(trunk)
    fold_frozen_norms(folded)
    assert torch.equal(folded.stem_conv.weight, conv.weight * scale.view(-1, 1, 1, 1))
    assert torch.equal(folded.stem_conv.bias, conv.bias * scale + shift)


def test_server_matches_the_models_unfolded_path(model):
    server = ConfigNetServer(model, chunk=CHUNK, device="cpu")
    assert _count(server._encoder, FrozenBatchNorm) == 0
    assert _count(server._encoder, nn.Identity) == N_NORMS

    imgs = _photos(5, 1)  # 5 photos pad to two chunks of 4
    lat, rot = server.encode(imgs)
    mlat, mrot = model.encode_images(imgs, batch_chunk=CHUNK)
    assert np.std(lat[:, 0]) > 0 and np.std(rot[:, 0]) > 0  # the photos differ
    assert _rel(lat, mlat) < ROUNDING and _rel(rot, mrot) < ROUNDING

    n_blend = model.config["facemodel_inputs"]["blendshape_values"][0]
    value = np.random.default_rng(2).normal(size=(5, n_blend)).astype(np.float32)
    out = server.render_with_attribute(imgs, "blendshape_values", value)
    want = model.generate_images(
        model.set_facemodel_param_in_latents(mlat, "blendshape_values", value), mrot,
        batch_chunk=CHUNK)
    assert out.shape == want.shape and out.dtype == want.dtype == np.uint8 and out.std() > 0
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_model_keeps_its_norms(model):
    state = {k: v.clone() for k, v in model.real_encoder.state_dict().items()}
    server = ConfigNetServer(model, chunk=CHUNK, device="cpu")
    server.refresh()
    assert _count(model.real_encoder, FrozenBatchNorm) == N_NORMS
    after = model.real_encoder.state_dict()
    assert state.keys() == after.keys()
    assert all(torch.equal(state[k], after[k]) for k in state)


def test_refresh_takes_new_norm_statistics(model):
    imgs = _photos(3, 4)
    server = ConfigNetServer(model, chunk=CHUNK, device="cpu")
    first, _ = server.encode(imgs)
    saved = {k: v.clone() for k, v in model.real_encoder.state_dict().items()}
    try:
        randomize_norms(model.real_encoder, seed=5)
        np.testing.assert_array_equal(server.encode(imgs)[0], first)  # the snapshot is fixed
        server.refresh()
        assert _count(server._encoder, nn.Identity) == N_NORMS
        lat, _ = server.encode(imgs)
        want, _ = model.encode_images(imgs, batch_chunk=CHUNK)
        assert _rel(lat, first) > 1e-2
        assert _rel(lat, want) < ROUNDING
    finally:
        model.real_encoder.load_state_dict(saved)


def test_server_encoder_runs_channels_first(model):
    """The server's folded float32 trunk takes the channels-first route once
    a chunk (every chunk runs eagerly on the CPU), and its latents are the
    channels-last formula's within rounding."""
    server = ConfigNetServer(model, chunk=CHUNK, device="cpu")
    imgs = _photos(5, 11)  # two chunks of 4
    before = _route_ticks()
    lat, rot = server.encode(imgs)
    assert _route_ticks() == before + 2
    force_channels_last(server._encoder)
    want_lat, want_rot = server.encode(imgs)
    assert _route_ticks() == before + 2
    assert np.std(lat[:, 0]) > 0
    assert _rel(lat, want_lat) < ROUNDING and _rel(rot, want_rot) < ROUNDING


def test_group_norm_trunk_folds_nothing():
    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG, encoder_norm="group"), device="cpu")
    scale_heads(model.real_encoder, _photos(4, 10))
    server = ConfigNetServer(model, chunk=CHUNK, device="cpu")
    assert fold_frozen_norms(copy.deepcopy(model.real_encoder.resnet)) == 0
    assert _count(server._encoder, GroupNorm) == N_NORMS
    assert _count(server._encoder, nn.Identity) == 0
    imgs = _photos(3, 6)
    lat, rot = server.encode(imgs)
    mlat, mrot = model.encode_images(imgs, batch_chunk=CHUNK)
    assert _rel(lat, mlat) < ROUNDING and _rel(rot, mrot) < ROUNDING


def test_bfloat16_trunk_keeps_its_norms():
    """A bfloat16 trunk's convolutions give bfloat16 outputs that its norms
    multiply by a float32 scale, as the JAX trunk does: the server keeps
    those norms, and its latents are the model's own."""
    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG, compute_dtype="bfloat16"), device="cpu")
    randomize_norms(model.real_encoder, seed=3)
    scale_heads(model.real_encoder, _photos(4, 10))
    assert fold_frozen_norms(copy.deepcopy(model.real_encoder.resnet)) == 0
    server = ConfigNetServer(model, chunk=CHUNK, device="cpu")
    assert _count(server._encoder, FrozenBatchNorm) == N_NORMS
    assert _count(server._encoder, nn.Identity) == 0
    imgs = _photos(5, 7)
    lat, rot = server.encode(imgs)
    mlat, mrot = model.encode_images(imgs, batch_chunk=CHUNK)
    assert np.std(lat[:, 0]) > 0
    np.testing.assert_array_equal(lat, mlat)
    np.testing.assert_array_equal(rot, mrot)


def _bulk_model_config():
    path = os.path.join(os.path.dirname(__file__), "..", "benchmark", "configs",
                        "confignet_512.json")
    with open(path) as f:
        return json.load(f)["model"]


def _card_bulk_model():
    """The bulk cell's model at 512px with random norm statistics, its 227
    photos, and its two requests: 150 photos at the encoder's poses, 77 at
    given poses (chunks of 32, padded tails)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = ConfigNet(dict(_bulk_model_config(), seed=7))
    randomize_norms(model.real_encoder, seed=8)
    photos = _photos(150 + 77, 9, size=512)
    scale_heads(model.real_encoder, photos[:8])
    rng = np.random.default_rng(10)
    n_blend = model.config["facemodel_inputs"]["blendshape_values"][0]
    rotations = (rng.uniform(-1, 1, (77, 3)) * [np.pi / 6, np.pi / 18, 0]).astype(np.float32)
    requests = [(photos[:150], rng.normal(size=(150, n_blend)).astype(np.float32), None),
                (photos[150:], rng.normal(size=(77, n_blend)).astype(np.float32), rotations)]
    return model, photos, requests


def _compare_servers(got_server, want_server, photos, requests):
    """(the worst photo's mean byte gap, the bytes two or more steps off,
    the latents' relative gap) of two servers' renders and latents."""
    worst, far, total = 0.0, 0, 0
    for imgs, value, rots in requests:
        got = got_server.render_with_attribute(imgs, "blendshape_values", value, rots)
        want = want_server.render_with_attribute(imgs, "blendshape_values", value, rots)
        assert got.shape == want.shape == imgs.shape and got.std() > 0
        gap = np.abs(got.astype(np.int16) - want.astype(np.int16))
        worst = max(worst, float(gap.reshape(len(gap), -1).mean(axis=1).max()))
        far += int((gap > 1).sum())
        total += gap.size
    lat_got, _ = got_server.encode(photos[:40])
    lat_want, _ = want_server.encode(photos[:40])
    assert np.std(lat_got[:, 0]) > 0
    print(f"worst_photo_abs_u8 {worst:.6f} share_off_by_2_pct {100.0 * far / total:.6f} "
          f"latents rel {_rel(lat_got, lat_want):.3e}")
    return worst, far, _rel(lat_got, lat_want)


@pytest.mark.gpu
def test_card_bulk_renders_folded_against_unfolded():
    """The bulk cell's model at 512px, f32 with TF32 off, random norm
    statistics: two requests (150 photos at the encoder's poses, 77 at
    given poses; chunks of 32, padded tails) through the folded server and a
    server whose encoder keeps its norms, within the cell's checks
    (``worst_photo_abs_u8`` < 0.03, no byte two steps off)."""
    model, photos, requests = _card_bulk_model()
    folded = ConfigNetServer(model, chunk=32)
    unfolded = ConfigNetServer(model, chunk=32)
    unfolded._encoder = copy.deepcopy(model.real_encoder).eval()
    assert not any(isinstance(m, FrozenBatchNorm) for m in folded._encoder.modules())
    worst, far, _ = _compare_servers(folded, unfolded, photos, requests)
    assert worst < 0.03 and far == 0


@pytest.mark.gpu
def test_card_bulk_renders_channels_first_against_channels_last():
    """The bulk cell's folded server, whose float32 trunk runs
    channels-first, against the same snapshot forced through the
    channels-last formula: the same two requests within
    ``worst_photo_abs_u8`` < 0.002 and no byte two steps off, latents within
    1e-5 relative.  A captured encoder call replays bit-equal to its eager
    call, and the route's counter ticks at the capture, never at a replay."""
    model, photos, requests = _card_bulk_model()
    route = ConfigNetServer(model, chunk=32)
    formula = ConfigNetServer(model, chunk=32)
    force_channels_last(formula._encoder)
    worst, far, lat_gap = _compare_servers(route, formula, photos, requests)
    assert worst < 0.002 and far == 0 and lat_gap < 1e-5

    imgs = photos[:64]  # two full chunks: a key captured above
    before = _route_ticks()
    replayed = route.encode(imgs)
    assert _route_ticks() == before
    with graphs.eager():
        eager = route.encode(imgs)
    assert _route_ticks() == before + 2
    for a, b in zip(replayed, eager):
        np.testing.assert_array_equal(a, b)
