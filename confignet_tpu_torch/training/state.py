"""Optimizers and the generator EMA (counterpart of
``confignet_tpu/training/state.py``).

Each adversarial player (generator side, image discriminator, synthetic
discriminator, latent discriminator) has its own Adam.  The generator player
bundles the generator, the latent regressor and the synthetic encoder under
one optimizer, as the reference does (confignet_first_stage.py:556-558).

Keras Adam parity: eps 1e-7 (Keras' default).  optax's ``adam`` and
``torch.optim.Adam`` compute the same update, ``lr * m_hat / (sqrt(v_hat) +
eps)``.  ``amsgrad`` is not ported: optax takes the running maximum of the
bias-corrected second moment, torch of the uncorrected one, so the updates
differ.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable

import torch


def make_adam(params: Iterable[torch.nn.Parameter], optimizer_config: Dict[str, Any]) -> torch.optim.Adam:
    """Adam from the reference's optimizer config dict
    ({lr, beta_1, beta_2, amsgrad}, confignet_first_stage.py:46-51)."""
    if optimizer_config.get("amsgrad", False):
        raise NotImplementedError("amsgrad is not ported (optax and torch differ; see module "
                                  "docstring)")
    return torch.optim.Adam(
        params, lr=optimizer_config.get("lr", 4e-4),
        betas=(optimizer_config.get("beta_1", 0.0), optimizer_config.get("beta_2", 0.9)), eps=1e-7)


@torch.no_grad()
def ema_update(ema: torch.nn.Module, current: torch.nn.Module, alpha: float = 0.999) -> None:
    """ema <- alpha * ema + (1 - alpha) * current, in place
    (reference: confignet_first_stage.py:393-400)."""
    ema_params = list(ema.parameters())
    torch._foreach_mul_(ema_params, alpha)
    torch._foreach_add_(ema_params, list(current.parameters()), alpha=1.0 - alpha)
