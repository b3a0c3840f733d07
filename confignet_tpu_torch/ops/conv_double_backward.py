"""A 2D convolution whose backward is itself differentiable through
cuDNN's own gradient kernels, for the convolutions that the R1 penalty
differentiates twice (the discriminator trunks'; no JAX counterpart: there
``jax.grad`` of ``jax.grad`` lowers the same products).

PyTorch's built-in double backward of a convolution
(``aten::_convolution_double_backward``) computes the weight term
``conv(ggI, gO)`` as a *forward* convolution with the batch and channel
axes swapped and ``gO`` as the filter: at a 256px discriminator's 1x1
stem that is a 256x256 filter, at its first block a dilated 128x128 one,
for which cuDNN has only slow generic forward kernels.  Here the two levels are ``torch.autograd.Function``\\ s:

- :class:`_Conv2d` runs ``F.conv2d`` (the same kernel as the built-in
  forward); its backward hands ``gO`` to :class:`_Conv2dGrads`;
- :class:`_Conv2dGrads` returns ``(gI, gW, gB)`` from
  ``aten.convolution_backward`` (the built-in backward's call); its own
  backward takes ``(ggI, ggW, ggB)`` and returns
  ``ggO = conv(ggI, W) + conv(x, ggW) + ggB`` as forward convolutions, the
  weight term ``wgrad(ggI, gO)`` and the input term ``dgrad(gO, ggW)``
  through ``convolution_backward`` (cuDNN's wgrad and dgrad).

Nothing takes a third derivative, so the second level is
``once_differentiable``.  Each level computes only the gradients the
running backward will use: a Function's ``needs_input_grad`` says which
operands require grad, not which ones this ``autograd.grad`` asks for, so
each operand's gradient edge is asked of the engine
(``torch._C._will_engine_execute_node``).  The engine cannot answer for a
leaf inside ``autograd.grad``, so a leaf operand (a parameter, an input
image) enters through a view, whose node it can.  Each second-order call
adds 1 to the ``conv.double_backward`` counter (core/tracing.py).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from confignet_tpu_torch.core.tracing import count

_DILATION = (1, 1)
_OUTPUT_PADDING = (0, 0)


def _pair(v: Union[int, Sequence[int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _will_use(ctx, i: int) -> bool:
    """Whether the running backward uses the gradient of the Function's
    ``i``-th tensor operand."""
    node = ctx.next_functions[i][0]
    return node is not None and torch._C._will_engine_execute_node(node)


def _convolution_backward(gO, x, w, has_bias: bool, stride, padding, groups, mask):
    return torch.ops.aten.convolution_backward(
        gO, x, w, [w.shape[0]] if has_bias else None, stride, padding, _DILATION, False,
        _OUTPUT_PADDING, groups, mask)


class _Conv2dGrads(torch.autograd.Function):
    """``(gI, gW, gB)`` of a convolution from ``gO``, as ``mask`` asks (None
    where it does not); differentiable once more."""

    @staticmethod
    def forward(ctx, gO, x, w, has_bias, stride, padding, groups, mask):
        ctx.save_for_backward(gO, x, w)
        ctx.conv = (stride, padding, groups)
        return _convolution_backward(gO, x, w, has_bias, stride, padding, groups, mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, ggI, ggW, ggB):
        count("conv.double_backward")
        gO, x, w = ctx.saved_tensors
        stride, padding, groups = ctx.conv
        ggO = gx = gw = None
        if _will_use(ctx, 0):
            if ggI is not None:
                ggO = F.conv2d(ggI, w, None, stride, padding, _DILATION, groups)
            if ggW is not None:
                term = F.conv2d(x, ggW, None, stride, padding, _DILATION, groups)
                ggO = term if ggO is None else ggO + term
            if ggB is not None:
                term = ggB[None, :, None, None].expand_as(gO)
                ggO = term if ggO is None else ggO + term
        if ggW is not None and _will_use(ctx, 1):
            gx = _convolution_backward(gO, x, ggW, False, stride, padding, groups,
                                       (True, False, False))[0]
        if ggI is not None and _will_use(ctx, 2):
            gw = _convolution_backward(gO, ggI, w, False, stride, padding, groups,
                                       (False, True, False))[1]
        return ggO, gx, gw, None, None, None, None, None


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` whose backward runs through :class:`_Conv2dGrads`."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conv = (b is not None, stride, padding, groups)
        return F.conv2d(x, w, b, stride, padding, _DILATION, groups)

    @staticmethod
    def backward(ctx, gO):
        x, w = ctx.saved_tensors
        has_bias, stride, padding, groups = ctx.conv
        mask = (_will_use(ctx, 0), _will_use(ctx, 1), has_bias and _will_use(ctx, 2))
        gI, gW, gB = _Conv2dGrads.apply(gO, x, w, has_bias, stride, padding, groups, mask)
        return gI, gW, gB, None, None, None


def _edge(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A leaf that requires grad as a view of itself (see the module
    docstring); anything else as it is."""
    if t is not None and t.requires_grad and t.grad_fn is None:
        return t.view_as(t)
    return t


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           stride: Union[int, Sequence[int]], padding: Union[int, Sequence[int]],
           groups: int) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, padding, groups=groups)``, with
    the double backward of this module."""
    return _Conv2d.apply(_edge(x), _edge(weight), _edge(bias), _pair(stride), _pair(padding),
                         groups)
