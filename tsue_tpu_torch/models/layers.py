"""Shared transformer building blocks.

Counterpart of ``tsue_tpu/models/layers.py``: post-LN encoder/decoder blocks
with torch ``nn.TransformerEncoderLayer``/``DecoderLayer`` semantics as the
reference instantiates them (ReLU FFN, ``dim_feedforward=2048`` whatever
d_model is).  Submodules carry the Flax names (``MHA_0``, ``LayerNorm_0``,
``FFN_0``, ``Dense_0``) so ``convert.load_flax_params`` maps weights by path.
All attention goes through ``ops.attention.dot_product_attention``.

Every block drops (``MHA``: probabilities and output; ``FFN``: after the
activation and after the second Dense, as torch's Transformer layers do)
when a ``generator`` is passed, and only then: the training step and the
forecaster's K candidates pass one, the deterministic forward passes None.

``Dense`` and ``LayerNorm`` compute as Flax's ``Dense`` and ``LayerNorm``
over parameters cast to bf16 (the bfloat16 configuration): the input and
the parameters meet in their promoted dtype, so an fp32 input stays fp32
and a bf16 one stays bf16; the norm's statistics are fp32.  With fp32
parameters and inputs they are ``nn.Linear`` and ``nn.LayerNorm``, bit for
bit.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tsue_tpu_torch.ops.attention import dot_product_attention
from tsue_tpu_torch.utils.precision import promote
from tsue_tpu_torch.utils.random import dropout

LN_EPS = 1e-6          # flax nn.LayerNorm's default epsilon
DIM_FF = 2048  # torch nn.Transformer*Layer default, whatever d_model is


class Dense(nn.Linear):
    """``nn.Linear`` in the promoted dtype of its input and parameters
    (Flax ``Dense``'s ``promote_dtype``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = promote(x, self.weight)
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with fp32 statistics, the output in the promoted
    dtype of the input and the parameters (Flax ``LayerNorm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = promote(x, self.weight)
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(dt)


def layer_norm(d: int) -> LayerNorm:
    return LayerNorm(d, eps=LN_EPS)


class MHA(nn.Module):
    """Multi-head attention with separate ``project_kv``/``attend``, so a
    deterministic memory is projected once and attended by K candidates."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.q = Dense(d_model, d_model)
        self.k = Dense(d_model, d_model)
        self.v = Dense(d_model, d_model)
        self.o = Dense(d_model, d_model)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        return x.reshape(B, T, self.num_heads, D // self.num_heads)

    def project_kv(self, kv_in: torch.Tensor):
        return self._heads(self.k(kv_in)), self._heads(self.v(kv_in))

    def attend(self, q_in, k, v, mask=None,
               generator: Optional[torch.Generator] = None):
        q = self._heads(self.q(q_in))
        # torch nn.MultiheadAttention(dropout=p) drops the softmax probs; the
        # surrounding Transformer layer also drops the attention output
        out = dot_product_attention(q, k, v, mask=mask,
                                    dropout_p=self.dropout,
                                    generator=generator)
        out = self.o(out.flatten(2))
        return dropout(out, self.dropout, generator)

    def forward(self, q_in, kv_in, mask=None,
                generator: Optional[torch.Generator] = None):
        k, v = self.project_kv(kv_in)
        return self.attend(q_in, k, v, mask, generator)


class FFN(nn.Module):
    def __init__(self, d_model: int, dim_ff: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.Dense_0 = Dense(d_model, dim_ff)
        self.Dense_1 = Dense(dim_ff, d_model)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = dropout(torch.relu(self.Dense_0(x)), self.dropout, generator)
        return dropout(self.Dense_1(h), self.dropout, generator)


class EncoderBlock(nn.Module):
    """Post-LN transformer encoder block (torch TransformerEncoderLayer)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.MHA_0 = MHA(d_model, num_heads, dropout)
        self.LayerNorm_0 = layer_norm(d_model)
        self.FFN_0 = FFN(d_model, DIM_FF, dropout)
        self.LayerNorm_1 = layer_norm(d_model)

    def forward(self, x, key_mask=None,
                generator: Optional[torch.Generator] = None):
        x = self.LayerNorm_0(x + self.MHA_0(x, x, mask=key_mask,
                                            generator=generator))
        return self.LayerNorm_1(x + self.FFN_0(x, generator))


class DecoderBlock(nn.Module):
    """Post-LN transformer decoder block with self + cross attention."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.self_attn = MHA(d_model, num_heads, dropout)
        self.LayerNorm_0 = layer_norm(d_model)
        self.cross_attn = MHA(d_model, num_heads, dropout)
        self.LayerNorm_1 = layer_norm(d_model)
        self.FFN_0 = FFN(d_model, DIM_FF, dropout)
        self.LayerNorm_2 = layer_norm(d_model)

    def forward(self, x, memory, generator: Optional[torch.Generator] = None):
        x = self.LayerNorm_0(x + self.self_attn(x, x, generator=generator))
        x = self.LayerNorm_1(x + self.cross_attn(x, memory,
                                                 generator=generator))
        return self.LayerNorm_2(x + self.FFN_0(x, generator))
