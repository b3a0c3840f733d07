"""Optimizers and the generator EMA (counterpart of
``confignet_tpu/training/state.py``).

Each adversarial player (generator side, image discriminator, synthetic
discriminator, latent discriminator) has its own Adam.  The generator player
bundles the generator, the latent regressor and the synthetic encoder under
one optimizer, as the reference does (confignet_first_stage.py:556-558).

Keras Adam parity: eps 1e-7 (Keras' default).  The players' optimizers are
written out as optax writes ``adam`` and ``amsgrad`` (:class:`OptaxAdam`):
the step count is a tensor on the parameters' device and the bias
corrections are computed from it there, so a train step captured in a CUDA
graph (``core/graphs.py``) replays every later step's corrections, not the
captured step's; the one-shot fine-tune takes the same optimizer.
``torch.optim.Adam`` keeps its count on the host unless ``capturable``
(which refuses CPU parameters and rounds otherwise), and its ``amsgrad``
takes the running maximum of the uncorrected second moment, optax's of the
corrected one.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List

import torch


class OptaxAdam(torch.optim.Optimizer):
    """optax 0.2.6's ``adam(lr, b1, b2, eps)`` (``amsgrad``: its
    ``amsgrad``): ``scale_by_adam`` (``scale_by_amsgrad``) then
    ``scale(-lr)``.  Per parameter, at step t:

        mu = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2,
        mu_hat = mu / (1 - b1^t),  nu_hat = nu / (1 - b2^t),
        amsgrad: nu_hat = nu_max = max(nu_max, nu_hat),
        p += -lr * (mu_hat / (sqrt(nu_hat) + eps)).

    The state keeps torch Adam's names: ``exp_avg`` (mu), ``exp_avg_sq``
    (nu), ``max_exp_avg_sq`` (nu_max, bias-corrected, unlike torch's) and
    ``step``, t as a float32 0-d tensor on the parameter's device.  The
    state is made at a parameter's first step; a parameter without a
    gradient is skipped, as torch's optimizers skip it."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-7, amsgrad: bool = False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, amsgrad=amsgrad))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(group, params)
        return loss

    def _update(self, group: Dict[str, Any], params: List[torch.Tensor]) -> None:
        b1, b2 = group["betas"]
        keys = ("exp_avg", "exp_avg_sq") + (("max_exp_avg_sq",) if group["amsgrad"] else ())
        for p in params:
            state = self.state[p]
            if not state:
                state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                for key in keys:
                    state[key] = torch.zeros_like(p)
        states = [self.state[p] for p in params]
        grads = [p.grad for p in params]
        steps = [s["step"] for s in states]
        mus, nus = [s["exp_avg"] for s in states], [s["exp_avg_sq"] for s in states]
        torch._foreach_add_(steps, 1)
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        mu_hat = torch._foreach_div(mus, _bias_correction(b1, steps))
        nu_hat = torch._foreach_div(nus, _bias_correction(b2, steps))
        if group["amsgrad"]:
            nu_max = [s["max_exp_avg_sq"] for s in states]
            torch._foreach_maximum_(nu_max, nu_hat)
            nu_hat = nu_max
        denominator = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denominator, group["eps"])
        updates = torch._foreach_div(mu_hat, denominator)
        torch._foreach_mul_(updates, -group["lr"])
        torch._foreach_add_(params, updates)


def _bias_correction(decay: float, steps: List[torch.Tensor]) -> List[torch.Tensor]:
    """1 - decay^t for each count t, on the counts' device."""
    corrections = torch._foreach_pow(decay, steps)
    torch._foreach_neg_(corrections)
    torch._foreach_add_(corrections, 1.0)
    return corrections


class OptaxAmsgrad(OptaxAdam):
    """:class:`OptaxAdam` with ``amsgrad``: optax's ``amsgrad``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-7):
        super().__init__(params, lr=lr, betas=betas, eps=eps, amsgrad=True)


def make_adam(params: Iterable[torch.nn.Parameter],
              optimizer_config: Dict[str, Any]) -> OptaxAdam:
    """A player's Adam from the reference's optimizer config dict
    ({lr, beta_1, beta_2, amsgrad}, confignet_first_stage.py:46-51), in
    optax's form, as the JAX package takes ``optax.adam`` or
    ``optax.amsgrad``."""
    lr = optimizer_config.get("lr", 4e-4)
    betas = (optimizer_config.get("beta_1", 0.0), optimizer_config.get("beta_2", 0.9))
    if optimizer_config.get("amsgrad", False):
        return OptaxAmsgrad(params, lr=lr, betas=betas, eps=1e-7)
    return OptaxAdam(params, lr=lr, betas=betas, eps=1e-7)


def optimizer_state(optimizers: Dict[str, torch.optim.Optimizer]) -> List[torch.Tensor]:
    """Every tensor of every player's optimizer state (moments, step
    counts): what a captured train step updates beside the modules."""
    return [value for optimizer in optimizers.values()
            for state in optimizer.state.values() for value in state.values()]


def optimizer_constants(optimizers: Dict[str, torch.optim.Optimizer]) -> tuple:
    """Each player's hyperparameters, which a captured step holds as
    constants."""
    return tuple((player, tuple((g["lr"], tuple(g["betas"]), g["eps"], g["amsgrad"])
                                for g in optimizer.param_groups))
                 for player, optimizer in sorted(optimizers.items()))


def make_fine_tune_adam(params: Iterable[torch.Tensor]) -> OptaxAdam:
    """The one-shot fine-tune's Adam (second_stage.py:714): optax's ``adam``
    with lr 1e-4, betas (0.9, 0.999), eps 1e-7 -- not the players' betas
    (0, 0.9)."""
    return OptaxAdam(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-7)


@torch.no_grad()
def ema_update(ema: torch.nn.Module, current: torch.nn.Module, alpha: float = 0.999) -> None:
    """ema <- alpha * ema + (1 - alpha) * current, in place
    (reference: confignet_first_stage.py:393-400)."""
    ema_params = list(ema.parameters())
    torch._foreach_mul_(ema_params, alpha)
    torch._foreach_add_(ema_params, list(current.parameters()), alpha=1.0 - alpha)
