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


_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """SplitMix64's finaliser: every output bit depends on every input
    bit."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def step_generator(seed: int, step: int, device=None,
                   stream: int = 0) -> torch.Generator:
    """The generator of training step ``step`` of a run seeded ``seed``: a
    fresh stream per (seed, step), so a step can be repeated exactly.  The
    pair is mixed into one 64-bit seed: the CPU generator (mt19937) keeps
    only a seed's low 32 bits, the CUDA one (Philox) all 64.  ``stream``
    > 0 (a data rank) mixes in once more: another stream of the step."""
    key = _mix64(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    if stream:
        key = _mix64(key ^ (stream & _M64))
    return torch.Generator(device=device).manual_seed(key)
