"""The ResNet50 trunk's two layouts (``models/backbones/resnet.py``): a trunk
whose convolutions compute in float32, called with autograd off, runs
channels-first (NCHW) from its stem to its pooling; a bfloat16 trunk, and a
call that records a backward, run channels-last; both are one forward
(``ResNet50.features(x, channels_first)``).

The channels-first formula is held against the channels-last one on the
same weights: the forward, the input's gradient and every parameter's
gradient,
with frozen norms (random statistics), frozen norms folded into the
convolutions, and group norms.  The two layouts sum in other orders, so
they agree within float32 rounding: the frozen trunks' gaps are 1e-7 to
2e-6 relative, the group norms' statistics amplify theirs to about 1e-4 in
the gradients (a one-ulp change of the input moves the channels-last trunk
itself by 2e-5 there).  A wrong channel axis, pad or pooling gives gaps of
order 1.  A convolution's bias before a one-channel group is cancelled by
the norm, so its gradient is rounding alone, 1e-6 of the median leaf's:
leaves under 1/1000 of the median are left out, as the stage-2 tests do.

Trunks are tiny (two blocks in the first stage, one in each other, width
16), at an odd and an even input size: an odd size gives odd maps to the
strided 1x1 convolutions, whose SAME output rounds up.  The convolution
itself is held on asymmetric SAME pads below.

A folded trunk called with autograd off runs each convolution without its
bias and one epilogue pass after it (``ops/epilogue_cuda.conv_epilogue``:
the bias, the block's shortcut, the ReLU; the plain version here on the
CPU).  Its blocks are held bit for bit against the separate passes they
replace, as ATen makes them on the card: the convolution's output, its bias
added in a pass of its own, ReLU, ``y + shortcut``, ReLU.  (On the CPU a
float32 convolution with a bias may add it inside its own sums, so there
the bias is added as ATen adds it on the card; in float64 the two agree.)
Only that route calls the epilogue: a trunk with norms, a bfloat16 trunk
and a call recording a backward never do.
"""
import statistics

import pytest
import torch

from confignet_tpu_torch.core import tracing
from confignet_tpu_torch.models.backbones import resnet
from confignet_tpu_torch.models.backbones.resnet import (BottleneckBlock, FrozenBatchNorm,
                                                         ResNet50, fold_frozen_norms)
from confignet_tpu_torch.models.blocks import Conv2d

torch.set_num_threads(1)

COUNTER = "resnet.channels_first"
FUSED = "resnet.fused_epilogue"
# the stem's, three a block's (5 blocks) and four projections': as many convolutions
N_NORMS = 1 + 5 * 3 + 4
# epilogue passes of a folded trunk's call: the stem's and three a block's
N_EPILOGUES = 1 + 5 * 3
# relative gaps, channels-first against channels-last: (forward, input
# gradient, worst parameter gradient)
LIMITS = {"frozen": (2e-6, 1e-5, 2e-5), "folded": (2e-6, 1e-5, 2e-5),
          "group": (5e-5, 1e-3, 2e-3)}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _ticks(counter: str = COUNTER) -> float:
    return tracing.totals.get(counter, 0)


@pytest.fixture
def epilogue_calls(monkeypatch):
    """The list of the trunk's epilogue calls, one form name a call."""
    calls = []

    def counted(y, bias, residual=None, shortcut=None, shortcut_bias=None):
        calls.append("residual" if residual is not None else
                     "shortcut" if shortcut is not None else "relu")
        return wrapped(y, bias, residual, shortcut, shortcut_bias)

    wrapped = resnet.conv_epilogue
    monkeypatch.setattr(resnet, "conv_epilogue", counted)
    return calls


def tiny_trunk(norm: str, dtype=None, seed: int = 0) -> ResNet50:
    """A two-stage-deep ResNet50 of width 16 with random frozen statistics
    and conv biases; ``norm`` "folded" is "frozen" with every norm folded."""
    torch.manual_seed(seed)
    trunk = ResNet50(dtype=dtype, stage_sizes=(2, 1, 1, 1), stage_widths=(16, 16, 16, 16),
                     norm="group" if norm == "group" else "frozen")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in trunk.modules():
            if isinstance(m, FrozenBatchNorm):
                n = m.gamma.numel()
                m.gamma.copy_(torch.rand(n, generator=g) + 0.5)
                m.beta.copy_(torch.randn(n, generator=g))
                m.moving_mean.copy_(torch.randn(n, generator=g))
                m.moving_variance.copy_(torch.rand(n, generator=g) + 0.5)
            elif isinstance(m, Conv2d):
                m.bias.copy_(torch.randn(m.bias.shape, generator=g))
    if norm == "folded":
        assert fold_frozen_norms(trunk) == N_NORMS
    return trunk


def _inputs(size: int, seed: int = 2) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((2, size, size, 3), generator=g) * 50.0


def _run(trunk: ResNet50, forward, x0: torch.Tensor):
    """(output, the input's gradient, each parameter's gradient) of a fixed
    weighted sum of ``forward(x0)``."""
    x = x0.clone().requires_grad_(True)
    trunk.zero_grad(set_to_none=True)
    y = forward(x)
    (y * torch.linspace(-1, 1, y.numel()).view_as(y)).sum().backward()
    return y.detach(), x.grad, {k: p.grad.clone() for k, p in trunk.named_parameters()}


def channels_last(trunk: ResNet50):
    """The trunk forced through the channels-last formula."""
    return lambda x: trunk.features(x, channels_first=False)


def channels_first(trunk: ResNet50):
    """The route's formula on (B, H, W, 3), whatever the grad mode."""
    return lambda x: trunk.features(x.movedim(-1, 1).contiguous(), channels_first=True)


@pytest.mark.parametrize("size", [61, 64])
@pytest.mark.parametrize("norm", ["frozen", "folded", "group"])
def test_channels_first_formula_matches_channels_last(norm, size):
    trunk = tiny_trunk(norm)
    x = _inputs(size)
    before = _ticks()
    y, gx, grads = _run(trunk, channels_first(trunk), x)
    want_y, want_gx, want_grads = _run(trunk, channels_last(trunk), x)
    assert _ticks() == before  # the formulas alone: no call took the route
    assert y.shape == (2, 64) and want_y.abs().max() > 1

    median = statistics.median(float(g.norm()) for g in want_grads.values())
    compared = [k for k, g in want_grads.items() if float(g.norm()) >= 1e-3 * median]
    assert len(compared) >= len(want_grads) - 12  # group: the biases before one-channel groups
    limit_y, limit_gx, limit_grad = LIMITS[norm]
    assert _rel(y, want_y) < limit_y
    assert _rel(gx, want_gx) < limit_gx
    assert max(_rel(grads[k], want_grads[k]) for k in compared) < limit_grad


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
@pytest.mark.parametrize("norm", ["frozen", "folded", "group"])
def test_float32_call_without_autograd_takes_the_route(norm, mode, epilogue_calls):
    """With autograd off a float32 call is the channels-first formula, bit
    for bit, and ticks the counter once; a folded trunk's call also runs
    its epilogue passes (the stem's and three a block's) and ticks the
    fused counter once, a trunk with norms runs none."""
    trunk = tiny_trunk(norm)
    x = _inputs(61)
    before, fused_before = _ticks(), _ticks(FUSED)
    with getattr(torch, mode)():
        got = trunk(x)
        assert _ticks() == before + 1
        want = channels_first(trunk)(x)
    assert _ticks() == before + 1
    assert torch.equal(got, want)
    folded = norm == "folded"
    assert _ticks(FUSED) == fused_before + folded
    assert len(epilogue_calls) == 2 * N_EPILOGUES * folded
    if folded:  # a call's: the stem's, then three a block's, ending with its shortcut
        block = ["relu", "relu", "shortcut"]
        assert epilogue_calls[:N_EPILOGUES] == (["relu"] + block + ["relu", "relu", "residual"]
                                                + block * 3)


@pytest.mark.parametrize("norm", ["frozen", "folded", "group"])
def test_call_recording_a_backward_keeps_channels_last(norm, epilogue_calls):
    """A float32 call with autograd on runs the channels-last formula, bit
    for bit, and does not tick the counters nor call the epilogue; the
    gradients are its own."""
    trunk = tiny_trunk(norm)
    x = _inputs(61)
    before, fused_before = _ticks(), _ticks(FUSED)
    y, gx, grads = _run(trunk, trunk, x)
    want_y, want_gx, want_grads = _run(trunk, channels_last(trunk), x)
    assert _ticks() == before and _ticks(FUSED) == fused_before and not epilogue_calls
    assert torch.equal(y, want_y) and torch.equal(gx, want_gx)
    assert all(torch.equal(grads[k], want_grads[k]) for k in grads)


@pytest.mark.parametrize("norm", ["frozen", "folded", "group"])
def test_float32_route_runs_nchw_contiguous(norm):
    """Every convolution of a float32 trunk takes and gives NCHW-contiguous
    tensors, channels on axis 1."""
    trunk = tiny_trunk(norm)
    seen = []

    def check(module, args, out):
        (x,) = [a for a in args if isinstance(a, torch.Tensor)]
        seen.append((x.shape[1] == module.weight.shape[1] and x.is_contiguous()
                     and out.shape[1] == module.weight.shape[0] and out.is_contiguous()))

    hooks = [m.register_forward_hook(check) for m in trunk.modules() if isinstance(m, Conv2d)]
    try:
        with torch.no_grad():
            trunk(_inputs(61))
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) == N_NORMS and all(seen)


@pytest.mark.parametrize("norm", ["frozen", "group"])
def test_bfloat16_trunk_keeps_channels_last(norm, epilogue_calls):
    """A trunk computing in bfloat16 runs the channels-last formula, bit for
    bit, and its convolutions see channels-last tensors; the counters do
    not tick and the epilogue is not called."""
    trunk = tiny_trunk(norm, dtype=torch.bfloat16)
    inputs = []
    hooks = [m.register_forward_pre_hook(lambda m, args: inputs.append((m, args[0])))
             for m in trunk.modules() if isinstance(m, Conv2d)]
    x = _inputs(61)
    before, fused_before = _ticks(), _ticks(FUSED)
    with torch.no_grad():
        got = trunk(x)
        for h in hooks:
            h.remove()
        want = channels_last(trunk)(x)
    assert _ticks() == before and _ticks(FUSED) == fused_before and not epilogue_calls
    assert torch.equal(got, want)
    assert inputs and all(t.shape[-1] == m.weight.shape[1] for m, t in inputs)


@pytest.mark.parametrize("calls", [1, 3])
@pytest.mark.parametrize("norm", ["frozen", "folded", "group"])
def test_counter_ticks_once_a_float32_call(norm, calls):
    """``resnet.channels_first`` ticks once a call; ``resnet.fused_epilogue``
    once a folded trunk's call, never a trunk's with norms."""
    trunk = tiny_trunk(norm)
    x = _inputs(33)
    before, fused_before = _ticks(), _ticks(FUSED)
    with torch.no_grad():
        for _ in range(calls):
            trunk(x)
    assert _ticks() == before + calls
    assert _ticks(FUSED) == fused_before + calls * (norm == "folded")


def _separate_passes(block: BottleneckBlock, x: torch.Tensor) -> torch.Tensor:
    """The folded block's channels-first forward as the separate passes the
    epilogue replaces, each convolution's bias added as ATen adds it on the
    card (a pass after the convolution): ReLU, ``y + shortcut``, ReLU."""
    def conv(c, t):
        return c(t, True, add_bias=False) + c.bias[:, None, None]

    shortcut = conv(block.shortcut_conv, x) if block.project_shortcut else x
    y = torch.relu(conv(block.conv1, x))
    y = torch.relu(conv(block.conv2, y))
    return torch.relu(conv(block.conv3, y) + shortcut)


@pytest.mark.parametrize("size", [61, 64])
@pytest.mark.parametrize("project", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_block_is_the_separate_passes(dtype, project, size, epilogue_calls):
    """A folded block on the route (three epilogue passes, the last with the
    identity or the projection shortcut) equals the separate passes bit for
    bit; in float64 also the convolutions with their biases."""
    torch.manual_seed(5)
    features = 16 if project else 32  # an identity block keeps its width, 4 x 8
    block = BottleneckBlock(features, 8, stride=2 if project else 1, project_shortcut=project)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, Conv2d):
                m.bias.copy_(torch.randn(m.bias.shape, generator=g))
        for name in ("bn1", "bn2", "bn3") + (("shortcut_bn",) if project else ()):
            setattr(block, name, torch.nn.Identity())
        block = block.to(dtype)
        x = torch.randn((2, features, size, size), generator=g, dtype=dtype)
        got = block(x, channels_first=True)
        want = _separate_passes(block, x)
    assert epilogue_calls == ["relu", "relu", "shortcut" if project else "residual"]
    assert got.dtype == dtype and (got == 0).any() and (got > 1).any()
    assert torch.equal(got, want)
    if dtype == torch.float64:
        with torch.no_grad():
            shortcut = block.shortcut_conv(x, True) if project else x
            y = torch.relu(block.conv2(torch.relu(block.conv1(x, True)), True))
            assert torch.equal(got, torch.relu(block.conv3(y, True) + shortcut))


def test_float64_trunk_takes_the_route_exactly():
    """The route's arithmetic is the channels-last formula's: in float64
    (no lower compute dtype, so the route with autograd off) the two agree
    to 1e-13."""
    trunk = tiny_trunk("frozen").double()
    x = _inputs(61).double()
    with torch.no_grad():
        assert _rel(trunk(x), channels_last(trunk)(x)) < 1e-13


@pytest.mark.parametrize("size,kernel,stride,groups", [
    (8, 4, 1, 1),   # even kernel: SAME pads 1 before, 2 after
    (8, 3, 2, 1),   # stride 2 on an even size: 0 before, 1 after
    (9, 3, 2, 1),   # odd size: symmetric
    (9, 1, 2, 1),   # the trunk's strided 1x1
    (8, 3, 1, 4),   # grouped
])
def test_conv2d_channels_first_is_the_channels_last_conv(size, kernel, stride, groups):
    torch.manual_seed(3)
    conv = Conv2d(8, 12, (kernel, kernel), stride=stride, groups=groups)
    with torch.no_grad():
        conv.bias.copy_(torch.randn(12))
        x = torch.randn(2, size, size, 8)
        want = conv(x)
        got = conv(x.movedim(-1, 1).contiguous(), channels_first=True)
    assert got.shape == want.movedim(-1, 1).shape
    assert _rel(got.movedim(1, -1), want) < 1e-6

