"""Randomness from explicit generators.

``torch.nn.functional.dropout`` draws from the global generator and takes
no ``torch.Generator``; the port's dropout draws its keep mask from the
generator it is given, so a candidate rollout is reproducible from one
seed.  On a CUDA tensor the generator must be a CUDA generator.  A train
step's dropout draws from ``step_generator(seed, step)``, the counterpart of
the JAX package's ``fold_in(key(seed), step)``.
"""
from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout`` / torch ``F.dropout``
    semantics): keep with probability 1 - p and scale by 1 / (1 - p).
    Identity when ``generator`` is None or ``p`` is 0 (evaluation)."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def step_generator(seed: int, step: int, device=None) -> torch.Generator:
    """The generator of training step ``step`` of a run seeded ``seed``: a
    fresh stream per (seed, step), so a step can be repeated exactly."""
    g = torch.Generator(device=device)
    return g.manual_seed(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
