"""The discriminator trunks' convolution with its own double backward
(confignet_tpu_torch/ops/conv_double_backward.py, ``DiscrConv2d``) against
``F.conv2d``'s built-in autograd (``Conv2d``, the same parameters).

On the CPU: first- and second-order gradients of both at small shapes, in
float64 and float32; the ``conv.double_backward`` counter over an R1
discriminator update; and the gradients each backward asks of
``aten.convolution_backward``, which must be the built-in's.  The test
marked ``gpu`` runs a 256px float32 discriminator update at batch 24 on the
card, against the built-in path and through a captured graph; it imports
no JAX, so on a machine without it:
python -m pytest --noconftest -m gpu tests/test_torch_conv_double_backward.py
"""
import statistics

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from confignet_tpu_torch.core import tracing
from confignet_tpu_torch.losses.gan import compute_discriminator_loss
from confignet_tpu_torch.models.blocks import Conv2d, DiscrConv2d
from confignet_tpu_torch.models.discriminator import HologanDiscriminator

torch.set_num_threads(1)

# (in, out, kernel, stride, input size): the DiscrBlock conv, whose TF SAME
# padding on an even input is asymmetric (an F.pad of 0 before, 1 after),
# and the 1x1 from_rgb conv
LAYERS = {"stride2_3x3_same": (5, 7, 3, 2, 8), "from_rgb_1x1": (3, 3, 1, 1, 6)}
TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}


def _pair(layer, use_bias, dtype):
    """A DiscrConv2d and a Conv2d with the same seeded parameters."""
    cin, cout, k, stride, _ = LAYERS[layer]
    torch.manual_seed(0)
    new = DiscrConv2d(cin, cout, (k, k), stride=stride, use_bias=use_bias).to(dtype)
    if use_bias:
        with torch.no_grad():
            new.bias.uniform_(-1, 1)
    old = Conv2d(cin, cout, (k, k), stride=stride, use_bias=use_bias).to(dtype)
    old.load_state_dict(new.state_dict())
    return new, old


def _gradients(conv, x, order):
    """A first-order gradient taken with ``create_graph`` (of the input, as
    R1 takes it, or of the parameters), then the gradient of a loss on it
    with respect to the input and the parameters."""
    params = list(conv.parameters())
    x = x.detach().requires_grad_(True)
    out = conv(x)
    probe = torch.linspace(-1, 1, out.numel(), dtype=out.dtype).reshape(out.shape)
    first = (out * probe).sum() + out.square().sum()
    wrt = [x] if order == "input" else params
    inner = torch.autograd.grad(first, wrt, create_graph=True)
    loss = sum(g.square().sum() for g in inner) + first
    return inner + torch.autograd.grad(loss, [x] + params)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("order", ["input", "parameters"])
def test_gradients_equal_the_builtin_double_backward(layer, use_bias, dtype, order):
    """On channels-last input (B, H, W, C): the first-order gradient and
    the second-order gradients of the input, weight and bias equal the
    built-in autograd's, to 1e-12 in float64 and 1e-5 in float32, relative
    to each tensor's largest value."""
    new, old = _pair(layer, use_bias, dtype)
    size = LAYERS[layer][4]
    x = torch.randn((3, size, size, LAYERS[layer][0]), generator=torch.Generator().manual_seed(1),
                    dtype=dtype)
    got, want = _gradients(new, x, order), _gradients(old, x, order)
    assert len(got) == len(want)
    tol = TOLERANCE[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol * float(w.detach().abs().max()))


def _tiny_discriminator():
    """The default trunk (the 1x1 from_rgb and 5 DiscrBlocks, six heads) at
    small widths."""
    torch.manual_seed(2)
    return HologanDiscriminator((32, 32), disc_expansion_factor=4, disc_max_feature_maps=16)


def _images(n, seed):
    return torch.rand((n, 32, 32, 3), generator=torch.Generator().manual_seed(seed)) * 2 - 1


@pytest.mark.parametrize("r1_heads, calls", [("all", 26), ("final", 6)])
def test_counter_counts_each_conv_on_each_penalised_heads_path(r1_heads, calls):
    """One discriminator loss and the D update's gradient: the R1 term of a
    head differentiates each conv on its path twice (head i's path holds
    from_rgb and blocks 0..i, the final head's all six convolutions:
    2 + 3 + 4 + 5 + 6 + 6 = 26 with every head, 6 with the final one); the
    loss alone takes no second derivative."""
    disc = _tiny_discriminator()
    start = tracing.totals.get("conv.double_backward", 0)
    losses = compute_discriminator_loss(disc, _images(2, 3), _images(2, 4), r1_heads=r1_heads)
    assert tracing.totals.get("conv.double_backward", 0) == start
    torch.autograd.grad(losses["loss_sum"], list(disc.parameters()))
    assert tracing.totals["conv.double_backward"] - start == calls


class _MaskSpy(TorchDispatchMode):
    """Records the output mask of every ``aten.convolution_backward``."""

    def __init__(self):
        super().__init__()
        self.masks = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution_backward.default:
            self.masks.append(tuple(args[10]))
        return func(*args, **(kwargs or {}))


def _masks(disc, wrt):
    x = _images(2, 5).requires_grad_(True)
    out = sum(head.sum() for head in disc(x).values())
    inputs = {"input": [x], "parameters": list(disc.parameters()),
              "both": [x] + list(disc.parameters())}[wrt]
    with _MaskSpy() as spy:
        torch.autograd.grad(out, inputs)
    return spy.masks


@pytest.mark.parametrize("wrt", ["input", "parameters", "both"])
def test_backward_asks_only_for_the_gradients_the_engine_uses(wrt, monkeypatch):
    """A gradient of the trunk with respect to its input alone asks
    ``convolution_backward`` for no weight or bias gradient; one with
    respect to the parameters alone asks no input gradient of the stem:
    the same masks as the built-in backward's, call for call."""
    disc = _tiny_discriminator()
    got = _masks(disc, wrt)
    assert len(got) == 6
    if wrt == "input":
        assert all(mask == (True, False, False) for mask in got)
    if wrt == "parameters":
        assert got.count((False, True, True)) == 1 and got.count((True, True, True)) == 5
    monkeypatch.setattr(DiscrConv2d, "forward", Conv2d.forward)
    assert got == _masks(disc, wrt)


# -- on the card ----------------------------------------------------------------------


@pytest.mark.gpu
def test_card_256_discriminator_update_matches_builtin_and_replays_equal_eager(monkeypatch):
    """A 256px float32 discriminator update at batch 24 (the default
    5-block trunk, R1 on all six heads): through a captured graph it
    equals the same update run eagerly bit for bit, under deterministic
    algorithms; against the built-in double backward (``Conv2d``'s
    forward on the same parameters) its R1 losses agree within 2e-4 and
    each parameter's gradient within 0.03 of the larger of its norm and
    the median leaf's (the train_256_stage2 cell's loss and gradient
    limits), the difference's norm taken."""
    from confignet_tpu_torch.apps.bench_train import deterministic_algorithms
    from confignet_tpu_torch.core.graphs import GraphCache

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    torch.manual_seed(0)
    disc = HologanDiscriminator((256, 256)).to(device)
    params = list(disc.parameters())
    generator = torch.Generator(device=device).manual_seed(1)
    real, fake = (torch.rand((24, 256, 256, 3), generator=generator, device=device) * 2 - 1
                  for _ in range(2))

    def update(real, fake):
        losses = compute_discriminator_loss(disc, real, fake)
        grads = torch.autograd.grad(losses["loss_sum"], params)
        return [losses[f"gp_loss_{i}"].detach() for i in range(6)] + list(grads)

    cache = GraphCache(device)
    start = tracing.totals.get("conv.double_backward", 0)
    with deterministic_algorithms():
        cache.run_step("discriminator_update", update, (real, fake), (disc,))
        captured = [t.clone() for t in cache.run_step("discriminator_update", update,
                                                      (real, fake), (disc,))]
        replayed = [t.clone() for t in cache.run_step("discriminator_update", update,
                                                      (real, fake), (disc,))]
        eager = update(real, fake)
        # the eager first call, the capture and the eager call above; no replay
        assert tracing.totals["conv.double_backward"] - start == 3 * 26
        assert all(torch.equal(a, b) for a, b in zip(eager, captured))
        assert all(torch.equal(a, b) for a, b in zip(eager, replayed))
        monkeypatch.setattr(DiscrConv2d, "forward", Conv2d.forward)
        builtin = update(real, fake)
    for got, want in zip(eager[:6], builtin[:6]):
        assert abs(float(got) - float(want)) <= 2e-4 * abs(float(want))
    norms = [float(w.norm()) for w in builtin[6:]]
    median = statistics.median(norms)
    gaps = [float((g - w).norm()) / max(n, median) for g, w, n in zip(eager[6:], builtin[6:], norms)]
    assert max(gaps) < 0.03, gaps
