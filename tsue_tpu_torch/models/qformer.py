"""BLIP-2-style Q-Former: per-frame vision embeddings -> query tokens.

Counterpart of ``tsue_tpu/models/qformer.py`` (ref scripts/train.py:388-414):
Dense vision projection -> N-layer encoder over the frame axis -> learned
query tokens cross-attending through an N-layer decoder.  The blocks drop
(``QFormerConfig.dropout``) when a ``generator`` is passed, and only then.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tsue_tpu_torch.config import QFormerConfig
from tsue_tpu_torch.models.layers import (DecoderBlock, Dense,
                                          EncoderBlock)


class QFormer(nn.Module):
    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.vision_proj = Dense(c.vision_dim, c.hidden_size)
        for i in range(c.num_encoder_layers):
            self.add_module(f"enc_{i}",
                            EncoderBlock(c.hidden_size, c.num_heads,
                                         c.dropout))
        self.query_tokens = nn.Parameter(
            torch.zeros(c.num_query_tokens, c.hidden_size))
        for i in range(c.num_decoder_layers):
            self.add_module(f"dec_{i}",
                            DecoderBlock(c.hidden_size, c.num_heads,
                                         c.dropout))

    def forward(self, vision_embs: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """vision_embs: (B, Tv, vision_dim) -> (B, Q, hidden)."""
        x = self.vision_proj(vision_embs)
        for i in range(self.cfg.num_encoder_layers):
            x = getattr(self, f"enc_{i}")(x, generator=generator)
        q = self.query_tokens[None].expand(x.shape[0], -1, -1)
        for i in range(self.cfg.num_decoder_layers):
            q = getattr(self, f"dec_{i}")(q, x, generator)
        return q
