"""GAIL baseline (B7; ref scripts/baseline_GAIL.py:193-247).

Counterpart of ``tsue_tpu/models/baselines/gail.py``: an MLP generator
(flattened history -> hidden 128 -> horizon, optional output noise drawn
from a generator) and an MLP discriminator over [x || y] with a sigmoid
output; the alternating BCE step is ``train.baseline_steps``'.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tsue_tpu_torch.models.layers import Dense


def _flat(traj: torch.Tensor) -> torch.Tensor:
    """(B, 2, T) -> (B, T * 2), time-major."""
    return traj.transpose(1, 2).reshape(traj.shape[0], -1)


class GAILGenerator(nn.Module):
    def __init__(self, seq_len: int, out_len: int, feature_size: int = 2,
                 hidden_dim: int = 128):
        super().__init__()
        self.out_len, self.feature_size = out_len, feature_size
        self.enc1 = Dense(seq_len * feature_size, hidden_dim)
        self.enc2 = Dense(hidden_dim, hidden_dim)
        self.dec1 = Dense(hidden_dim, hidden_dim)
        self.dec2 = Dense(hidden_dim, out_len * feature_size)

    def forward(self, batch: dict, deterministic: bool = True,
                teacher: Optional[torch.Tensor] = None,
                noise_scale: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, 2, T_out); ``noise_scale`` > 0 adds N(0, noise_scale) noise
        drawn from ``generator``, which must then be given."""
        h = torch.relu(self.enc1(_flat(batch["traj_in"])))
        h = torch.relu(self.enc2(h))
        h = torch.relu(self.dec1(h))
        out = self.dec2(h).reshape(-1, self.out_len, self.feature_size)
        if noise_scale > 0:
            if generator is None:
                raise ValueError("GAILGenerator's output noise is drawn from "
                                 "a generator; pass one")
            out = out + noise_scale * torch.randn(
                out.shape, generator=generator, device=out.device,
                dtype=out.dtype)
        return out.transpose(1, 2)                           # (B, 2, T_out)


class GAILDiscriminator(nn.Module):
    def __init__(self, seq_len: int, out_len: int, feature_size: int = 2,
                 hidden_dim: int = 128):
        super().__init__()
        self.fc1 = Dense((seq_len + out_len) * feature_size, hidden_dim)
        self.fc2 = Dense(hidden_dim, hidden_dim)
        self.fc3 = Dense(hidden_dim, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x (B, 2, T_in), y (B, 2, T_out) -> probability (B, 1)."""
        h = torch.relu(self.fc1(torch.cat([_flat(x), _flat(y)], dim=1)))
        h = torch.relu(self.fc2(h))
        return torch.sigmoid(self.fc3(h))
