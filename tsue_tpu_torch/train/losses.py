"""Loss and denormalisation as plain functions.

Counterpart of ``tsue_tpu/train/losses.py``.  Pixel coordinates reach
~3840, so the squared error has a large dynamic range: everything here is
fp32 whatever the model's compute dtype.
"""
from __future__ import annotations

from typing import Optional

import torch


def denorm(traj: torch.Tensor, norm_stat: torch.Tensor) -> torch.Tensor:
    """Map normalized (B, 2, T) back to pixel coords using (B, 4) min/max
    [min_x, max_x, min_y, max_y] (ref scripts/train.py:947-957)."""
    traj = traj.float()
    ns = norm_stat.float()
    min_xy = torch.stack([ns[:, 0], ns[:, 2]], dim=1)[:, :, None]  # (B,2,1)
    max_xy = torch.stack([ns[:, 1], ns[:, 3]], dim=1)[:, :, None]
    return traj * (max_xy - min_xy) + min_xy


def denorm_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                    norm_stat: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE_x + MSE_y on denormalized coords (ref scripts/train.py:959-961).
    ``valid`` (B,) masks the batch iterator's wrap-around padding rows.
    ``n_valid``: the valid rows of the whole batch when these rows are a
    data rank's part of it (the parts then sum to the batch's loss)."""
    se = (denorm(pred, norm_stat) - denorm(target, norm_stat)) ** 2
    if valid is None:
        return se[:, 0].mean() + se[:, 1].mean()
    w = valid.float()[:, None]                                   # (B, 1)
    denom = ((w.sum() if n_valid is None else n_valid)
             * se.shape[2]).clamp_min(1.0)
    return (se[:, 0] * w).sum() / denom + (se[:, 1] * w).sum() / denom
