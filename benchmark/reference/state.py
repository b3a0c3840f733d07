"""Adam and the generator EMA in plain per-parameter form (frozen copy of
the arithmetic of the port's ``training/state.py``, which is optax's
``adam``).  Per parameter, at step t:

    mu = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2,
    p += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps).
"""
from __future__ import annotations

from typing import Dict, List

import torch


class PlainAdam:
    """One player's Adam over ``params``; ``state`` holds (mu, nu) per
    parameter, made at the first step."""

    def __init__(self, params: List[torch.Tensor], lr: float, betas, eps: float = 1e-7):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.t = 0
        self.state: List[Dict[str, torch.Tensor]] = []

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        if not self.state:
            self.state = [{"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
                          for p in self.params]
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, s in zip(self.params, grads, self.state):
            s["exp_avg"].mul_(self.b1).add_(g * (1.0 - self.b1))
            s["exp_avg_sq"].mul_(self.b2).add_(g * g * (1.0 - self.b2))
            p.add_(-self.lr * (s["exp_avg"] / c1) / (torch.sqrt(s["exp_avg_sq"] / c2) + self.eps))


def make_adam(params: List[torch.Tensor], optimizer_config: Dict) -> PlainAdam:
    """A player's Adam from the config's {lr, beta_1, beta_2} (amsgrad off)."""
    if optimizer_config.get("amsgrad", False):
        raise ValueError("the reference has no amsgrad")
    return PlainAdam(params, lr=optimizer_config.get("lr", 4e-4),
                     betas=(optimizer_config.get("beta_1", 0.0), optimizer_config.get("beta_2", 0.9)))


@torch.no_grad()
def ema_update(ema: torch.nn.Module, current: torch.nn.Module, alpha: float = 0.999) -> None:
    """ema <- alpha * ema + (1 - alpha) * current, parameter by parameter."""
    for e, c in zip(ema.parameters(), current.parameters()):
        e.mul_(alpha).add_(c * (1.0 - alpha))
