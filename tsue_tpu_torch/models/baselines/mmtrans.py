"""MMTrans baseline (B6; ref scripts/baseline_mmtrans.py:210-287).

Counterpart of ``tsue_tpu/models/baselines/mmtrans.py``: the trajectory
and the window-normalised lane polygon embedded apart with a sinusoidal
positional encoding, concatenated, encoded by a 4-layer post-LN
transformer (the port's ``EncoderBlock``) with a key mask over the zero
lane points, decoded from the trajectory positions by flatten + Dense.

The deterministic forward's self-attention is the flash kernel on the
card (fp32, 8 heads of 16 over T_in + P keys, a (B, Tk) key mask); a
train-mode forward drops (p = ``dropout``) from its ``generator`` and so
attends in PyTorch ops, as the JAX package's dropout forces XLA.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from tsue_tpu_torch.models.layers import Dense, EncoderBlock


def sinusoidal_pos_encoding(max_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def normalize_polygon(polygon: torch.Tensor, polygon_len: torch.Tensor,
                      norm_stat: torch.Tensor) -> torch.Tensor:
    """(B, P, 2) raw px -> window-normalized coords; invalid points -> 0."""
    ns = norm_stat
    mins = torch.stack([ns[:, 0], ns[:, 2]], dim=1)[:, None, :]  # (B,1,2)
    rng = torch.stack([ns[:, 1] - ns[:, 0], ns[:, 3] - ns[:, 2]],
                      dim=1)[:, None, :]
    rng = torch.where(rng.abs() < 1e-6, torch.ones_like(rng), rng)
    out = (polygon - mins) / rng
    valid = (torch.arange(polygon.shape[1], device=polygon.device)[None, :]
             < polygon_len[:, None])[..., None]
    return torch.where(valid, out, torch.zeros_like(out))


class MMTrans(nn.Module):
    def __init__(self, seq_len: int, out_len: int, feature_size: int = 2,
                 d_model: int = 128, n_heads: int = 8, n_layers: int = 4,
                 dropout: float = 0.1, max_len: int = 100):
        super().__init__()
        self.seq_len, self.out_len = seq_len, out_len
        self.feature_size = feature_size
        self.n_layers = n_layers
        self.register_buffer("pe", torch.from_numpy(
            sinusoidal_pos_encoding(max_len, d_model)), persistent=False)
        self.traj_embedding = Dense(feature_size, d_model)
        self.lane_embedding = Dense(feature_size, d_model)
        for i in range(n_layers):
            self.add_module(f"enc_{i}", EncoderBlock(d_model, n_heads,
                                                     dropout))
        self.decoder = Dense(seq_len * d_model, out_len * feature_size)

    def forward(self, batch: dict, deterministic: bool = True,
                teacher: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, 2, T_out); dropout only when not ``deterministic`` and
        given a ``generator``."""
        traj = batch["traj_in"].transpose(1, 2)              # (B, T_in, 2)
        lane = normalize_polygon(batch["polygon"], batch["polygon_len"],
                                 batch["norm_stat"])         # (B, P, 2)
        B, T_in, _ = traj.shape
        P = lane.shape[1]
        x = torch.cat([self.traj_embedding(traj) + self.pe[None, :T_in],
                       self.lane_embedding(lane) + self.pe[None, :P]], 1)
        # key mask: all traj positions + nonzero lane points (ref :258-261)
        key_mask = torch.cat([
            torch.ones(B, T_in, dtype=torch.bool, device=x.device),
            lane.abs().sum(-1) != 0], dim=1)
        gen = None if deterministic else generator
        for i in range(self.n_layers):
            x = self.get_submodule(f"enc_{i}")(x, key_mask, gen)
        pred = self.decoder(x[:, :self.seq_len].reshape(B, -1))
        return pred.reshape(B, self.out_len,
                            self.feature_size).transpose(1, 2)
