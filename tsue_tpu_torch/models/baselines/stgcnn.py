"""Social-STGCNN baseline (B4; ref scripts/test_baseline_stgcnn.py:210-265).

Counterpart of ``tsue_tpu/models/baselines/stgcnn.py``: embed, two temporal
graph-conv blocks (a k = 3 conv over time, BatchNorm, ReLU), flatten, one
Dense to the horizon.  The convs run on (B, C, T) (``nn.Conv1d``,
padding 1: Flax's "SAME" at k = 3); the flatten is time-major, as the JAX
package's (B, T, C) reshape.

``BatchNorm`` is Flax's ``nn.BatchNorm``, not ``torch.nn.BatchNorm1d``:
the running statistics move by momentum 0.99 on the old value (torch's
0.01 on the new), the batch variance is E[x^2] - E[x]^2 (biased) both for
the normalisation and for the running update, and eps is 1e-5.  A train-
mode forward (``deterministic=False``) normalises by the batch's
statistics and updates the running buffers in place, as Flax's mutable
"batch_stats" collection is updated; a deterministic one reads them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tsue_tpu_torch.models.layers import Dense


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over the channel axis 1 of (B, C, T)."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                use_running_average: bool = True) -> torch.Tensor:
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean(dim=(0, 2))
            var = ((x * x).mean(dim=(0, 2)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


class STGConvBlock(nn.Module):
    def __init__(self, features: int, kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv1d(features, features, kernel_size,
                              padding=kernel_size // 2)
        self.norm = BatchNorm(features)

    def forward(self, x: torch.Tensor,
                use_running_average: bool = True) -> torch.Tensor:
        # x: (B, C, T)
        return torch.relu(self.norm(self.conv(x), use_running_average))


class SocialSTGCNN(nn.Module):
    def __init__(self, seq_len: int, out_len: int, feature_size: int = 2,
                 hidden_dim: int = 128, kernel_size: int = 3):
        super().__init__()
        self.out_len, self.feature_size = out_len, feature_size
        self.input_embedding = Dense(feature_size, hidden_dim)
        self.stgconv1 = STGConvBlock(hidden_dim, kernel_size)
        self.stgconv2 = STGConvBlock(hidden_dim, kernel_size)
        self.output_layer = Dense(seq_len * hidden_dim,
                                  out_len * feature_size)

    def forward(self, batch: dict, deterministic: bool = True,
                teacher: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, 2, T_out); ``deterministic=False`` takes the batch's
        statistics and updates the running ones."""
        x = self.input_embedding(batch["traj_in"].transpose(1, 2))
        x = x.transpose(1, 2)                                # (B, H, T)
        x = self.stgconv1(x, deterministic)
        x = self.stgconv2(x, deterministic)
        B = x.shape[0]
        pred = self.output_layer(x.transpose(1, 2).reshape(B, -1))
        return pred.reshape(B, self.out_len,
                            self.feature_size).transpose(1, 2)
