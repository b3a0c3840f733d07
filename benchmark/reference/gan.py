"""GAN and auxiliary losses as plain functions (counterpart of
``confignet_tpu/losses/gan.py``; reference: confignet/losses.py).

The R1 penalty differentiates the discriminator's output with respect to its
input with ``torch.autograd.grad(..., create_graph=True)``, so the D update
can differentiate the penalty again with respect to the parameters.  One
``grad`` call per penalised head, of that head's sum, equals the JAX
pullback with ones on that head and zeros on the others.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F



def gan_g_loss(scores: torch.Tensor) -> torch.Tensor:
    """Non-saturating generator loss (losses.py:7-8)."""
    return F.softplus(-scores).mean()


def gan_d_loss(labels, scores: torch.Tensor) -> torch.Tensor:
    """Label-weighted softplus discriminator loss (losses.py:10-11).
    ``labels``: a Python number or a tensor that broadcasts to ``scores``."""
    return (labels * F.softplus(-scores) + (1.0 - labels) * F.softplus(scores)).mean()


def eye_loss(gt_imgs: torch.Tensor, gen_imgs: torch.Tensor, eye_masks: torch.Tensor) -> torch.Tensor:
    """Masked MSE over the eye region, normalised per image by the mask area
    (losses.py:13-18).  ``eye_masks`` is (B, H, W) in {0, 1}."""
    masks = eye_masks.to(gt_imgs.dtype)
    img_diff = (gt_imgs - gen_imgs) * masks[..., None]
    per_img = img_diff.square().sum(dim=(1, 2, 3)) / (1.0 + masks.sum(dim=(1, 2)))
    return per_img.mean()


def r1_penalty(gradients: torch.Tensor) -> torch.Tensor:
    """R1 penalty: 10 * 0.5 * mean_b ||grad_b||^2 (losses.py:75-82)."""
    per_sample = gradients.square().reshape(gradients.shape[0], -1).sum(dim=1)
    return 10.0 * 0.5 * per_sample.mean()


def _input_gradient(output: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    (grad,) = torch.autograd.grad(output.sum(), inputs, create_graph=True)
    return grad


def compute_discriminator_loss(
    discriminator_fn: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
    real_imgs: torch.Tensor,
    fake_imgs: torch.Tensor,
    r1_heads: str = "all",
) -> Dict[str, torch.Tensor]:
    """Multi-head discriminator loss: per-head GAN loss on real and fake
    images plus R1 on the real ones (losses.py:20-47).

    ``discriminator_fn`` maps images to an ordered dict of logits; the head
    order is the dict's insertion order.  ``r1_heads``: "all" penalises every
    head like the reference, "final" only the last (full-image) head.
    """
    if r1_heads not in ("all", "final"):
        raise ValueError(f"unknown r1_heads mode {r1_heads!r}")
    real_imgs = real_imgs.detach().requires_grad_(True)
    out_real = discriminator_fn(real_imgs)
    out_fake = discriminator_fn(fake_imgs)
    head_keys = list(out_fake.keys())

    losses: Dict[str, torch.Tensor] = {}
    for i, key in enumerate(head_keys):
        losses[f"GAN_loss_real_{i}"] = gan_d_loss(1.0, out_real[key])
    for i, key in enumerate(head_keys):
        losses[f"GAN_loss_fake_{i}"] = gan_d_loss(0.0, out_fake[key])
    r1_keys = head_keys if r1_heads == "all" else head_keys[-1:]
    for key in r1_keys:
        losses[f"gp_loss_{head_keys.index(key)}"] = r1_penalty(
            _input_gradient(out_real[key], real_imgs))
    losses["loss_sum"] = sum(losses.values())
    return losses


def compute_latent_discriminator_loss(
    latent_discriminator_fn: Callable[[torch.Tensor], torch.Tensor],
    real_latents: torch.Tensor,
    fake_latents: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Single-head latent discriminator loss with R1 (losses.py:49-73)."""
    real_latents = real_latents.detach().requires_grad_(True)
    out_real = latent_discriminator_fn(real_latents)
    out_fake = latent_discriminator_fn(fake_latents)
    losses: Dict[str, torch.Tensor] = {}
    losses["GAN_loss_real"] = gan_d_loss(1.0, out_real)
    losses["GAN_loss_fake"] = gan_d_loss(0.0, out_fake)
    losses["gp_loss"] = r1_penalty(_input_gradient(out_real, real_latents))
    losses["loss_sum"] = sum(losses.values())
    return losses


def latent_regression_loss(predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain MSE between the regressor output and the (latent, weighted
    rotation) labels (losses.py:85-90)."""
    return (predictions - labels).square().mean()


def normalized_latent_regression_loss(predictions: torch.Tensor, labels: torch.Tensor,
                                      regression_weight: float, eps: float = 1e-3) -> torch.Tensor:
    """Variance-normalised latent regression of the second stage (reference:
    confignet_second_stage.py:93-107): predictions and labels are re-centred
    and scaled by the labels' per-dimension std (the last 3 dims, rotations,
    unscaled), the statistics of the whole batch."""
    n_rows = labels.shape[0]
    label_mean = labels.sum(dim=0) / n_rows
    pred_mean = (predictions.sum(dim=0).to(labels.dtype) / n_rows).to(predictions.dtype)
    variance = (labels - label_mean).square().sum(dim=0) / n_rows
    denominator = torch.sqrt(variance + eps)[None]
    denominator = torch.cat([denominator[:, :-3], torch.ones_like(denominator[:, -3:])], dim=1)
    predictions = pred_mean + (predictions - pred_mean) / denominator
    labels = label_mean + (labels - label_mean) / denominator
    return (predictions - labels).square().mean() * regression_weight
