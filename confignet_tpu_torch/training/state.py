"""Optimizers and the generator EMA (counterpart of
``confignet_tpu/training/state.py``).

Each adversarial player (generator side, image discriminator, synthetic
discriminator, latent discriminator) has its own Adam.  The generator player
bundles the generator, the latent regressor and the synthetic encoder under
one optimizer, as the reference does (confignet_first_stage.py:556-558).

Keras Adam parity: eps 1e-7 (Keras' default).  optax's ``adam`` and
``torch.optim.Adam`` compute the same update, ``lr * m_hat / (sqrt(v_hat) +
eps)``.  Their ``amsgrad`` variants differ: optax takes the running maximum
of the bias-corrected second moment, torch of the uncorrected one, so
``amsgrad: true`` takes :class:`OptaxAmsgrad`, written out as optax does it.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable

import torch


class OptaxAmsgrad(torch.optim.Optimizer):
    """optax 0.2.6's ``amsgrad(lr, b1, b2, eps)``: ``scale_by_amsgrad`` then
    ``scale(-lr)``.  Per parameter, at step t:

        mu = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2,
        nu_max = max(nu_max, nu / (1 - b2^t)),
        p -= lr * (mu / (1 - b1^t)) / (sqrt(nu_max) + eps).

    The state keeps torch Adam's names: ``exp_avg`` (mu), ``exp_avg_sq``
    (nu), ``max_exp_avg_sq`` (nu_max, bias-corrected, unlike torch's) and
    ``step``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    for key in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
                        state[key] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                mu, nu, nu_max = state["exp_avg"], state["exp_avg_sq"], state["max_exp_avg_sq"]
                mu.mul_(b1).add_(p.grad, alpha=1 - b1)
                nu.mul_(b2).add_(p.grad.square().mul_(1 - b2))
                torch.maximum(nu_max, nu / (1 - b2 ** t), out=nu_max)
                mu_hat = mu / (1 - b1 ** t)
                p.sub_(mu_hat.div_(nu_max.sqrt().add_(group["eps"])).mul_(group["lr"]))
        return loss


def make_adam(params: Iterable[torch.nn.Parameter],
              optimizer_config: Dict[str, Any]) -> torch.optim.Optimizer:
    """Adam from the reference's optimizer config dict
    ({lr, beta_1, beta_2, amsgrad}, confignet_first_stage.py:46-51); with
    ``amsgrad`` :class:`OptaxAmsgrad`, as the JAX package takes
    ``optax.amsgrad``."""
    lr = optimizer_config.get("lr", 4e-4)
    betas = (optimizer_config.get("beta_1", 0.0), optimizer_config.get("beta_2", 0.9))
    if optimizer_config.get("amsgrad", False):
        return OptaxAmsgrad(params, lr=lr, betas=betas, eps=1e-7)
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-7)


def make_fine_tune_adam(params: Iterable[torch.Tensor], capturable: bool = False) -> torch.optim.Adam:
    """The one-shot fine-tune's Adam (second_stage.py:714): lr 1e-4, betas
    (0.9, 0.999), eps 1e-7 -- not the players' betas (0, 0.9).  With
    ``capturable`` (CUDA parameters only) its step counts and bias
    corrections stay on the device, as optax's do, so its step can be
    captured in a CUDA graph."""
    return torch.optim.Adam(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-7, capturable=capturable)


@torch.no_grad()
def ema_update(ema: torch.nn.Module, current: torch.nn.Module, alpha: float = 0.999) -> None:
    """ema <- alpha * ema + (1 - alpha) * current, in place
    (reference: confignet_first_stage.py:393-400)."""
    ema_params = list(ema.parameters())
    torch._foreach_mul_(ema_params, alpha)
    torch._foreach_add_(ema_params, list(current.parameters()), alpha=1.0 - alpha)
