"""Trajectron++-style VAE baseline (B5; ref scripts/baseline_trajtron.py:192-245).

Counterpart of ``tsue_tpu/models/baselines/trajectron.py``: an LSTM
encoder, the latent (mu, logvar), z = mu + exp(logvar / 2) eps, an LSTM
decoder over [last input || z] repeated across the horizon, one Dense.  The
JAX package's "latent" RNG stream is the ``generator`` here: each train
step and each of the K candidates draws its own eps.  The loss
(``train.baseline_steps``) adds 0.1 * ``kl_divergence``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tsue_tpu_torch.models.baselines.lstm import StackedLSTM
from tsue_tpu_torch.models.layers import Dense


class TrajectronPP(nn.Module):
    def __init__(self, seq_len: int, out_len: int, feature_size: int = 2,
                 hidden_dim: int = 128, latent_dim: int = 32):
        super().__init__()
        self.out_len = out_len
        self.encoder_lstm = StackedLSTM(feature_size, hidden_dim, 1)
        self.fc_mu = Dense(hidden_dim, latent_dim)
        self.fc_logvar = Dense(hidden_dim, latent_dim)
        self.decoder_lstm = StackedLSTM(feature_size + latent_dim,
                                        hidden_dim, 1)
        self.output_layer = Dense(hidden_dim, feature_size)

    def forward(self, batch: dict, deterministic: bool = True,
                teacher: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                return_latent: bool = False):
        """(B, 2, T_out), and (mu, logvar) with ``return_latent``.  z = mu
        when ``deterministic``; otherwise eps is drawn from ``generator``,
        which must then be given."""
        x = batch["traj_in"].transpose(1, 2)                 # (B, T, 2)
        outs, _ = self.encoder_lstm(x)
        h = outs[:, -1]
        mu, logvar = self.fc_mu(h), self.fc_logvar(h)
        if deterministic:
            z = mu
        else:
            if generator is None:
                raise ValueError("a stochastic TrajectronPP forward draws its "
                                 "latent from a generator; pass one")
            eps = torch.randn(mu.shape, generator=generator,
                              device=mu.device, dtype=mu.dtype)
            z = mu + torch.exp(0.5 * logvar) * eps
        T = self.out_len
        dec_in = torch.cat([x[:, -1:].expand(-1, T, -1),
                            z[:, None].expand(-1, T, -1)], dim=-1)
        dec_out, _ = self.decoder_lstm(dec_in)
        pred = self.output_layer(dec_out).transpose(1, 2)   # (B, 2, T_out)
        return (pred, (mu, logvar)) if return_latent else pred


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """-0.5 * sum(1 + logvar - mu^2 - exp(logvar)) / B (ref :241-242)."""
    return -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar)) \
        / mu.shape[0]
