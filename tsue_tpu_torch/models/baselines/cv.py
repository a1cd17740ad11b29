"""Constant-velocity baseline (B1; ref scripts/baseline_cv.py:186-239).

Counterpart of ``tsue_tpu/models/baselines/cv.py``: the K candidates are
one broadcast expression over (B, K, 2, T_out), the velocity noise drawn
from an explicit generator.
"""
from __future__ import annotations

from typing import Optional

import torch


def cv_candidates(x: torch.Tensor, out_len: int,
                  generator: Optional[torch.Generator] = None,
                  num_candidates: int = 1,
                  noise_scale: float = 0.1) -> torch.Tensor:
    """(B, 2, T_in) -> (B, K, 2, T_out): the last position moved on by the
    last step's velocity, plus N(0, noise_scale) velocity noise per
    candidate drawn from ``generator``; noise-free when it is None."""
    B, C, _ = x.shape
    last = x[:, :, -1]                                    # (B, 2)
    vel = last - x[:, :, -2]
    if generator is not None:
        noise = torch.randn((B, num_candidates, C), generator=generator,
                            device=x.device, dtype=x.dtype) * noise_scale
    else:
        noise = x.new_zeros((B, num_candidates, C))
    v = vel[:, None, :] + noise                           # (B, K, 2)
    steps = torch.arange(1, out_len + 1, dtype=x.dtype, device=x.device)
    return last[:, None, :, None] + v[..., None] * steps  # (B, K, 2, T_out)
