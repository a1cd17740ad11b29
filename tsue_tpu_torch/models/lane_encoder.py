"""Lane polygon geometry encoder.

Counterpart of ``tsue_tpu/models/lane_encoder.py`` (ref scripts/train.py:
352-383): Linear(2 -> d) + learned positional embedding + N post-LN encoder
blocks with a key-padding mask + masked mean-pool -> (B, d); the zero vector
for an empty polygon.  The blocks drop when a ``generator`` is passed
(training), and only then.  An empty polygon's
attention rows have no valid key; the attention kernel gives them the
uniform average, as the JAX package does, and the pool then zeroes the row.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tsue_tpu_torch.models.layers import Dense, EncoderBlock


class LanePolygonEncoder(nn.Module):
    def __init__(self, d_model: int = 64, num_heads: int = 4,
                 num_layers: int = 2, max_points: int = 64,
                 dropout: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        self.input_proj = Dense(2, d_model)
        self.pos_embedding = nn.Parameter(torch.zeros(1, max_points, d_model))
        for i in range(num_layers):
            self.add_module(f"block_{i}",
                            EncoderBlock(d_model, num_heads, dropout))

    def forward(self, polygon: torch.Tensor, polygon_len: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """polygon: (B, P, 2) raw pixel coords; polygon_len: (B,) int."""
        P = polygon.shape[1]
        x = self.input_proj(polygon) + self.pos_embedding[:, :P]
        valid = (torch.arange(P, device=polygon.device)[None, :]
                 < polygon_len[:, None])                       # (B, P)
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x, key_mask=valid,
                                            generator=generator)
        w = valid[..., None].to(x.dtype)
        pooled = (x * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
        return torch.where((polygon_len > 0)[:, None], pooled,
                           torch.zeros((), dtype=x.dtype, device=x.device))
