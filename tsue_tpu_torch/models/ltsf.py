"""LTSF-NLinear + self-attention trajectory forecaster.

Counterpart of ``tsue_tpu/models/ltsf.py`` (ref scripts/train.py:659-842).
The channel-time layout stays (B, C, T) at the interface.

Reference quirks kept on purpose (``tsue_tpu/models/ltsf.py:14-20``):
- SelfAttentionBlock's first residual adds the *normalized* input
  (``res1 = x_norm + attn_out``), not the raw input;
- the post-MLP REPLACES the decoded signal rather than adding to it;
- cross-attention fusion adds to the pre-MLP/lane-adjusted decode via
  ``fused = dec_t + cross_to_d``, then LN + MLP fusion.

Dropout is active when a ``generator`` is passed, and only then.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tsue_tpu_torch.models.layers import MHA, Dense, layer_norm
from tsue_tpu_torch.utils.random import dropout


class PerChannelLinear(nn.Module):
    """Independent Linear(T_in -> T_out) per channel, as one einsum."""

    def __init__(self, channels: int, t_in: int, t_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(channels, t_in, t_out))
        self.bias = nn.Parameter(torch.zeros(channels, t_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, C, T_in)
        # fp32 products (the JAX einsum's preferred_element_type), then the
        # bias added under promotion
        return torch.einsum("bct,cto->bco", x.float(),
                            self.kernel.float()) + self.bias


class SelfAttentionBlock(nn.Module):
    """Pre-LN MHA + FFN over (B, C, T) (ref train.py:659-686)."""

    def __init__(self, d_model: int, num_heads: int = 1,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.norm1 = layer_norm(d_model)
        self.mha = MHA(d_model, num_heads, dropout)
        self.norm2 = layer_norm(d_model)
        self.ffn1 = Dense(d_model, d_model * 4)
        self.ffn2 = Dense(d_model * 4, d_model)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h_norm = self.norm1(x.transpose(1, 2))            # (B, T, C)
        res1 = h_norm + self.mha(h_norm, h_norm, generator=generator)
        res1n = self.norm2(res1)
        ff = dropout(torch.relu(self.ffn1(res1n)), self.dropout, generator)
        ff = dropout(self.ffn2(ff), self.dropout, generator)
        return (res1n + ff).transpose(1, 2)               # (B, C, T)


class NLinearEncoder(nn.Module):
    """NLinear: subtract the last step, per-channel Linear(T -> T), add back."""

    def __init__(self, window_size: int, d_model: int,
                 individual: bool = True):
        super().__init__()
        if individual:
            self.linears = PerChannelLinear(d_model, window_size, window_size)
        else:
            self.linear = Dense(window_size, window_size)
        self.individual = individual

    def forward(self, x):                                  # (B, C, T)
        last = x[:, :, -1:]
        proj = self.linears if self.individual else self.linear
        return proj(x - last) + last


class NLinearDecoder(nn.Module):
    """NLinear decode T_in -> T_out + lane bias + post-MLP + cross-attention
    fusion (ref scripts/train.py:718-806)."""

    def __init__(self, window_size: int, forecast_size: int, d_model: int,
                 individual: bool = True, polygon_embed_dim: int = 64,
                 use_post_mlp: bool = True, post_mlp_hidden_dim: int = 64,
                 dropout: float = 0.1, cross_dim: int = 2048,
                 cross_nhead: int = 2, output_feature_dim: int = 2,
                 use_cross_attn: bool = True):
        super().__init__()
        C, F = d_model, forecast_size
        self.forecast_size = F
        self.individual = individual
        self.use_post_mlp = use_post_mlp
        self.use_cross_attn = use_cross_attn
        self.dropout = dropout
        if individual:
            self.linears = PerChannelLinear(C, window_size, F)
        else:
            self.linear = Dense(window_size, F)
        self.lane_fc = Dense(polygon_embed_dim, C * F)
        if use_post_mlp:
            self.post_mlp1 = Dense(C * F, post_mlp_hidden_dim)
            self.post_mlp2 = Dense(post_mlp_hidden_dim, C * F)
        if use_cross_attn:
            self.dec_proj = Dense(C, cross_dim)
            self.cross_attn = MHA(cross_dim, cross_nhead, dropout)
            self.dec_unproj = Dense(cross_dim, C)
        self.fusion_ln = layer_norm(C)
        self.fusion_fc1 = Dense(C, C)
        self.fusion_fc2 = Dense(C, C)
        self.out_proj = Dense(C, output_feature_dim)

    def project_cross_kv(self, final_hidden: torch.Tensor):
        """Cross-attention K/V of a (deterministic) memory, computed once."""
        return self.cross_attn.project_kv(final_hidden)

    def forward(self, encoded, lane_polygon_emb, final_hidden=None,
                hidden_mask=None, generator=None,
                cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        B, C, _ = encoded.shape
        F = self.forecast_size
        last = encoded[:, :, -1:]
        proj = self.linears if self.individual else self.linear
        decoded = proj(encoded - last) + last
        decoded = decoded + self.lane_fc(lane_polygon_emb).reshape(B, C, F)
        if self.use_post_mlp:
            h = torch.relu(self.post_mlp1(decoded.reshape(B, C * F)))
            h = dropout(h, self.dropout, generator)
            decoded = self.post_mlp2(h).reshape(B, C, F)   # REPLACES
        dec_t = decoded.transpose(1, 2)                    # (B, F, C)
        if self.use_cross_attn and (final_hidden is not None
                                    or cross_kv is not None):
            q = self.dec_proj(dec_t)
            if cross_kv is None:
                cross_kv = self.project_cross_kv(final_hidden)
            ca = self.cross_attn.attend(q, cross_kv[0], cross_kv[1],
                                        mask=hidden_mask, generator=generator)
            fused = dec_t + self.dec_unproj(ca)
        else:
            fused = dec_t
        h = torch.relu(self.fusion_fc1(self.fusion_ln(fused)))
        out = self.out_proj(self.fusion_fc2(h))           # (B, F, 2)
        return out.transpose(1, 2)                         # (B, 2, F)


class TransformerLTSF(nn.Module):
    """Token conv -> NLinear encoder -> + pos -> self-attention -> NLinear
    decoder (ref scripts/train.py:808-842)."""

    def __init__(self, seq_len: int, out_len: int, d_model: int = 64,
                 individual: bool = True, feature_size: int = 2,
                 polygon_embed_dim: int = 64, use_post_mlp: bool = True,
                 post_mlp_hidden_dim: int = 64, nhead: int = 1,
                 dropout: float = 0.1, cross_dim: int = 2048,
                 cross_nhead: int = 2, use_cross_attn: bool = True):
        super().__init__()
        self.token_proj = Dense(feature_size, d_model)
        self.nlinear_encoder = NLinearEncoder(seq_len, d_model, individual)
        self.pos_encoding = nn.Parameter(torch.zeros(1, d_model, seq_len))
        self.attn_block = SelfAttentionBlock(d_model, nhead, dropout)
        self.decoder = NLinearDecoder(
            seq_len, out_len, d_model, individual=individual,
            polygon_embed_dim=polygon_embed_dim, use_post_mlp=use_post_mlp,
            post_mlp_hidden_dim=post_mlp_hidden_dim, dropout=dropout,
            cross_dim=cross_dim, cross_nhead=cross_nhead,
            output_feature_dim=feature_size, use_cross_attn=use_cross_attn)

    def project_cross_kv(self, final_hidden):
        return self.decoder.project_cross_kv(final_hidden)

    def forward(self, x, lane_polygon_emb, final_hidden=None,
                hidden_mask=None, generator=None, cross_kv=None):
        # token_proj: Conv1d(feature, d, k=1) == Dense over the channel axis
        h = self.token_proj(x.transpose(1, 2)).transpose(1, 2)  # (B, d, T)
        h = self.nlinear_encoder(h)
        h = h + self.pos_encoding[:, :, :h.shape[2]]
        h = self.attn_block(h, generator)
        return self.decoder(h, lane_polygon_emb, final_hidden, hidden_mask,
                            generator, cross_kv)
