"""Floating-point operations of the work a cell requests, counted by
``torch.utils.flop_counter``'s formulas (those of ``FlopCounterMode``,
without its module tracking) over the plain reference on
the ``meta`` device: no memory, no device, and the same count whatever
implements the work.  The counter sees matrix products and convolutions
(forward, backward and double backward), which are nearly all of it; the
elementwise work, the rotation and the AdaIN statistics are left out, so a
share of the peak read from these counts is a lower bound.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from benchmark.reference import model as ref


class _Counter(TorchDispatchMode):
    """Adds up the operations of every op that has a formula."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def _count(fn) -> int:
    with _Counter() as counter:
        fn()
    return counter.total


def serving_per_photo(model: Dict, attribute: str) -> float:
    """One photo through the served pipeline: encode, splice, render."""
    with torch.device("meta"):
        trees = ref.build(model, ref.SERVING_TREES)
        photos = torch.zeros((1, *model["output_shape"]), dtype=torch.uint8)
        width = dict(ref.facemodel_inputs(model))[attribute][0]
        value = torch.zeros((1, width))
        return float(_count(lambda: ref.render_with_attribute(trees, model, photos, attribute, value)))


def generate_per_row(model: Dict) -> float:
    """One latent rendered by the inference generator."""
    with torch.device("meta"):
        generator = ref.build(model, ("generator_smoothed",))["generator_smoothed"]
        latent_dim = sum(dims[1] for _, dims in ref.facemodel_inputs(model))
        with torch.no_grad():
            return float(_count(lambda: generator(torch.zeros((1, latent_dim)), torch.zeros((1, 3)))))


def encode_per_photo(model: Dict) -> float:
    """One photo through the real encoder."""
    with torch.device("meta"):
        encoder = ref.build(model, ("real_encoder",))["real_encoder"]
        photos = torch.zeros((1, *model["output_shape"]), dtype=torch.uint8)
        with torch.no_grad():
            return float(_count(lambda: encoder(ref.unit_range(photos))))


def stage2_step(model: Dict) -> float:
    """One stage-2 step at the configured batch."""
    batch = int(model["batch_size"])
    half = batch // 2
    size = tuple(model["output_shape"])
    inputs = ref.facemodel_inputs(model)
    with torch.device("meta"):
        trees = ref.build(model, ref.TREES + ("perceptual_loss",))
        trainer = ref.Stage2Trainer(trees, model, seed=0, device=torch.device("meta"))

        def imgs(n):
            return torch.zeros((n, *size), dtype=torch.uint8)

        def facemodel(n):
            return [torch.zeros((n, dims[0])) for _, dims in inputs]

        batch_ = {"d_real_imgs": imgs(batch), "d_input_imgs": imgs(batch),
                  "synth_d_real_imgs": imgs(batch), "synth_d_facemodel": facemodel(batch),
                  "synth_d_rotations": torch.zeros((batch, 3)), "latent_d_real_imgs": imgs(batch),
                  "latent_d_facemodel": facemodel(batch), "g_facemodel": facemodel(half),
                  "g_rotations": torch.zeros((half, 3)), "g_gt_imgs": imgs(half),
                  "g_eye_masks": torch.zeros((half, *size[:2]), dtype=torch.uint8),
                  "g_real_imgs": imgs(batch - half)}
        return float(_count(lambda: trainer.step(batch_)))
