"""Seeding and a resumable stream of seeds (counterpart of
``confignet_tpu/core/randomness.py``; reference: training_utils.py:8-11).

The JAX package splits ``jax.random`` keys; the port's draws come from
``torch.Generator`` objects, so its :class:`KeyChain` hands out seeds for
them from one root generator.  The number drawn is
counted, so a resumed run can restore the stream's position exactly.
"""
from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch


class KeyChain:
    """A host-side stream of seeds from a root ``torch.Generator``:
    :meth:`next` gives a fresh 63-bit seed (for ``torch.Generator.manual_seed``),
    :meth:`numpy_rng` a numpy Generator seeded with the next one.
    ``KeyChain(seed, position)`` continues a chain that has drawn
    ``position`` seeds."""

    def __init__(self, seed: int = 0, position: int = 0):
        self._seed = int(seed)
        self._position = 0
        self._root = torch.Generator().manual_seed(self._seed)
        for _ in range(position):
            self.next()

    @property
    def seed(self) -> int:
        return self._seed

    @property
    def position(self) -> int:
        return self._position

    def next(self) -> int:
        self._position += 1
        return int(torch.randint(0, 2**63 - 1, (), generator=self._root))

    def numpy_rng(self) -> np.random.Generator:
        """A numpy Generator seeded with the next seed (for host-side
        sampling such as dataset index selection)."""
        return np.random.default_rng(self.next())


def initialize_random_seed(seed: int) -> None:
    """Seed numpy's and Python's global RNGs, which the host-side code
    (metric samples, checkpoint panels, batch index streams) draws from."""
    np.random.seed(seed)
    random.seed(seed)


def key_or_seed(key_or_int: Optional[object], default_seed: int = 0) -> torch.Generator:
    """A CPU ``torch.Generator`` for an int seed (``default_seed`` when
    None); a generator passes through."""
    if key_or_int is None:
        return torch.Generator().manual_seed(default_seed)
    if isinstance(key_or_int, int):
        return torch.Generator().manual_seed(key_or_int)
    return key_or_int
