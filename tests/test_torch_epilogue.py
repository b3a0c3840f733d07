"""The fused convolution epilogue (``csrc/epilogue.cu`` via
``ops/epilogue_cuda.conv_epilogue``) on the card.

The kernel is held against its plain version computed by ATen on the card,
which is the sequence of passes it replaces, with ``torch.equal``: its three
forms at every shape the 256px and 512px servers' folded encoders launch
(the stem, each stage's convolutions, identity and projection blocks, B = 1
and 32), and at a plane size not a multiple of 4 and a view that is not
16-byte aligned (the scalar route), with NaNs and negative zeros among the
values.  A folded trunk's eager call launches it 49 times (the stem's and
three a block's); its features, and the bulk server's renders and latents,
equal bit for bit those of the same snapshot through the separate passes;
a captured encode replays bit-equal to its eager call.

Marked ``gpu``; each test skips without a CUDA device.  No JAX, so on a
machine without it:
python -m pytest --noconftest -m gpu tests/test_torch_epilogue.py
"""
import numpy as np
import pytest
import torch

from confignet_tpu_torch.core import graphs, tracing
from confignet_tpu_torch.models.backbones import resnet
from confignet_tpu_torch.models.backbones.resnet import (ResNet50, fold_frozen_norms,
                                                         resnet50_preprocess)
from confignet_tpu_torch.ops.epilogue_cuda import conv_epilogue, conv_epilogue_plain
from confignet_tpu_torch.serving import ConfigNetServer
from test_torch_fold_norms import _card_bulk_model

pytestmark = pytest.mark.gpu

# the stem's epilogue and three a bottleneck block's (16 blocks)
TRUNK_LAUNCHES = 1 + 16 * 3
FORMS = ("relu", "residual", "shortcut")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(form: str, shape, seed: int, device):
    """(y, bias, keyword operands) of one call, about half the sums negative."""
    g = torch.Generator().manual_seed(seed)
    channels = shape[1]
    y = torch.randn(shape, generator=g)
    extra = {}
    if form == "residual":
        extra["residual"] = torch.randn(shape, generator=g)
    elif form == "shortcut":
        extra["shortcut"] = torch.randn(shape, generator=g)
        extra["shortcut_bias"] = torch.randn(channels, generator=g)
    bias = torch.randn(channels, generator=g)
    return (y.to(device), bias.to(device), {k: v.to(device) for k, v in extra.items()})


def _kernel_against_plain(form: str, shape, seed: int, device, edit=None) -> None:
    y, bias, extra = _operands(form, shape, seed, device)
    if edit is not None:
        edit(y, extra)
    want = conv_epilogue_plain(y, bias, **extra)
    launches = conv_epilogue.launches
    got = conv_epilogue(y, bias, **extra)
    torch.cuda.synchronize()
    assert conv_epilogue.launches == launches + 1
    assert got.data_ptr() == y.data_ptr()  # in place
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert (want == 0).any() and (want > 0).any()


def folded_trunk(device, seed: int = 0) -> ResNet50:
    """A float32 ResNet50 with its norms folded and random conv biases."""
    torch.manual_seed(seed)
    trunk = ResNet50()
    assert fold_frozen_norms(trunk) == 53
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in trunk.modules():
            if isinstance(m, resnet.Conv2d):
                m.bias.copy_(torch.randn(m.bias.shape, generator=g))
    return trunk.to(device).eval()


def _photos(n: int, size: int, device, seed: int = 2) -> torch.Tensor:
    u8 = np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return resnet50_preprocess(torch.from_numpy(u8).to(device).float() / 127.5 - 1.0)


def epilogue_shapes(trunk: ResNet50, size: int, device) -> list:
    """The distinct (form, (C, H, W)) of a folded trunk's epilogue calls on
    ``size``-px photos, recorded from one call."""
    seen = []
    wrapped = resnet.conv_epilogue

    def record(y, bias, residual=None, shortcut=None, shortcut_bias=None):
        form = ("residual" if residual is not None else
                "shortcut" if shortcut is not None else "relu")
        if (form, tuple(y.shape[1:])) not in seen:
            seen.append((form, tuple(y.shape[1:])))
        return wrapped(y, bias, residual, shortcut, shortcut_bias)

    resnet.conv_epilogue = record
    try:
        with torch.no_grad():
            trunk(_photos(1, size, device))
    finally:
        resnet.conv_epilogue = wrapped
    return seen


@pytest.mark.parametrize("size", [256, 512])
def test_kernel_equals_plain_at_the_servers_shapes(cuda, size):
    trunk = folded_trunk(cuda)
    shapes = epilogue_shapes(trunk, size, cuda)
    # the stem; per stage a relu shape, a shortcut and a residual one
    assert len(shapes) == 1 + 4 * 3 and {form for form, _ in shapes} == set(FORMS)
    assert shapes[0] == ("relu", (64, size // 2, size // 2))
    for i, (form, chw) in enumerate(shapes):
        for batch in (1, 32):
            _kernel_against_plain(form, (batch, *chw), seed=100 * i + batch, device=cuda)


@pytest.mark.parametrize("form", FORMS)
def test_scalar_route_nan_and_negative_zero(cuda, form):
    """A plane of 63 elements, NaNs in the output and the shortcut, negative
    zeros: the plain version's values, NaN where it has NaN."""
    def edit(y, extra):
        y.view(-1)[::97] = float("nan")
        y.view(-1)[5::89] = -0.0
        for t in extra.values():
            if t.ndim == 4:
                t.view(-1)[7::101] = float("nan")

    _kernel_against_plain(form, (3, 5, 7, 9), seed=1, device=cuda, edit=edit)


def test_unaligned_view_takes_the_scalar_route(cuda):
    """A contiguous view starting 4 bytes past a 16-byte boundary, with a
    plane size that is a multiple of 4: the plain version's values."""
    shape = (2, 6, 8, 8)
    n = int(np.prod(shape))
    for form in FORMS:
        y, bias, extra = _operands(form, shape, seed=3, device=cuda)
        storage = torch.empty(n + 4, device=cuda)
        view = storage[1:1 + n].view(shape)
        view.copy_(y)
        assert view.data_ptr() % 16 != 0
        want = conv_epilogue_plain(view.clone(), bias, **extra)
        got = conv_epilogue(view, bias, **extra)
        assert torch.equal(got, want)


def test_folded_trunk_call_launches_49(cuda):
    trunk = folded_trunk(cuda)
    x = _photos(2, 256, cuda)
    before, ticks = conv_epilogue.launches, tracing.totals.get("resnet.fused_epilogue", 0)
    with torch.no_grad():
        trunk(x)
    assert conv_epilogue.launches == before + TRUNK_LAUNCHES
    assert tracing.totals.get("resnet.fused_epilogue", 0) == ticks + 1
    with torch.no_grad():  # a trunk with norms launches none
        ResNet50().to(cuda).eval()(x)
    assert conv_epilogue.launches == before + TRUNK_LAUNCHES


def _separate_passes(monkeypatch):
    """From now on the folded trunks run the separate passes the epilogue
    replaced (each convolution with its bias, ReLU, ``y + shortcut``)."""
    monkeypatch.setattr(resnet, "_folded", lambda norms, channels_first: False)


@pytest.mark.parametrize("size", [256, 512])
def test_folded_trunk_equals_the_separate_passes(cuda, size, monkeypatch):
    trunk = folded_trunk(cuda)
    x = _photos(32, size, cuda)
    with torch.no_grad():
        fused = trunk(x)
        _separate_passes(monkeypatch)
        launches = conv_epilogue.launches
        want = trunk(x)
    assert conv_epilogue.launches == launches
    assert fused.abs().max() > 1 and torch.equal(fused, want)


def test_card_bulk_renders_fused_against_separate_passes(cuda, monkeypatch):
    """The bulk cell's 512px model (random norm statistics, folded; chunks of
    32, padded tails): renders and latents of the server on the fused route
    equal bit for bit those of a server whose snapshot runs the separate
    passes; a captured encode replays bit-equal to its eager call and
    launches nothing through the wrapper."""
    model, photos, requests = _card_bulk_model()
    server = ConfigNetServer(model, chunk=32)
    fused = [server.render_with_attribute(imgs, "blendshape_values", value, rots)
             for imgs, value, rots in requests]
    lat, rot = server.encode(photos[:64])
    launches = conv_epilogue.launches
    replayed = server.encode(photos[:64])  # two full chunks, captured above
    assert conv_epilogue.launches == launches
    with graphs.eager():
        eager = server.encode(photos[:64])
    assert conv_epilogue.launches == launches + 2 * TRUNK_LAUNCHES
    for a, b, c in zip(replayed, eager, (lat, rot)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)

    _separate_passes(monkeypatch)
    separate = ConfigNetServer(model, chunk=32)
    for got, (imgs, value, rots) in zip(fused, requests):
        want = separate.render_with_attribute(imgs, "blendshape_values", value, rots)
        assert got.std() > 0
        np.testing.assert_array_equal(got, want)
    want_lat, want_rot = separate.encode(photos[:64])
    assert np.std(lat[:, 0]) > 0
    np.testing.assert_array_equal(lat, want_lat)
    np.testing.assert_array_equal(rot, want_rot)
    assert conv_epilogue.launches == launches + 2 * TRUNK_LAUNCHES
