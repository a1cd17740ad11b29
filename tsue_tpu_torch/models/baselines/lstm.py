"""LSTM baselines: CS-LSTM (B2) and Social-LSTM (B3).

Counterpart of ``tsue_tpu/models/baselines/lstm.py`` (ref
scripts/baseline_cs_lstm.py:192-248: a 2-layer LSTM encoder-decoder,
teacher-forced in training, autoregressive otherwise; ref
scripts/baseline_sociallstm.py:193-250: embed, a 1-layer LSTM, one Dense to
the whole horizon).

The cell is Flax's ``nn.OptimizedLSTMCell`` in plain ops, not
``torch.nn.LSTM`` (two biases, one fused gate layout, cuDNN's own sums): per
gate i, f, g, o an input kernel without bias (``ii`` .. ``io``) and a
hidden kernel with one (``hi`` .. ``ho``), named as the Flax parameters so
``convert.load_flax_params`` maps them mechanically; ``c' = f c + i g``,
``h' = o tanh(c')``, the carry (c, h) starting at zero.  A layer's input
products for the whole sequence are one product before its time loop; the
hidden product is one (B, H) x (H, 4H) product a step.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tsue_tpu_torch.models.layers import Dense

GATES = ("i", "f", "g", "o")
Carry = Tuple[torch.Tensor, torch.Tensor]          # (c, h), each (B, H)


class OptimizedLSTMCell(nn.Module):
    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        for gate in GATES:
            # "if" is a keyword: the submodules are added by name
            self.add_module(f"i{gate}", Dense(in_features, hidden,
                                              bias=False))
            self.add_module(f"h{gate}", Dense(hidden, hidden))

    def fused(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The four gates' kernels side by side: (W_in (4H, in), W_h (4H,
        H), b_h (4H,)), gates in the order i, f, g, o."""
        sub = self.get_submodule
        return (torch.cat([sub(f"i{g}").weight for g in GATES]),
                torch.cat([sub(f"h{g}").weight for g in GATES]),
                torch.cat([sub(f"h{g}").bias for g in GATES]))

    def step(self, carry: Carry, x_proj: torch.Tensor, w_h: torch.Tensor,
             b_h: torch.Tensor) -> Carry:
        """One step given the input's product ``x_proj`` (B, 4H)."""
        c, h = carry
        i, f, g, o = (F.linear(h, w_h, b_h) + x_proj).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


class StackedLSTM(nn.Module):
    """``num_layers`` cells (``cell_0`` ..) over (B, T, F) sequences."""

    def __init__(self, in_features: int, hidden: int, num_layers: int):
        super().__init__()
        self.hidden = hidden
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"cell_{i}", OptimizedLSTMCell(
                in_features if i == 0 else hidden, hidden))

    def cells(self) -> List[OptimizedLSTMCell]:
        return [self.get_submodule(f"cell_{i}")
                for i in range(self.num_layers)]

    def zero_carries(self, x: torch.Tensor) -> List[Carry]:
        z = x.new_zeros((x.shape[0], self.hidden))
        return [(z, z)] * self.num_layers

    def forward(self, xs: torch.Tensor,
                carries: Optional[List[Carry]] = None
                ) -> Tuple[torch.Tensor, List[Carry]]:
        """xs (B, T, F) -> (top layer's outputs (B, T, H), final carries).
        Layer by layer: each layer's input product over all T at once."""
        carries = carries or self.zero_carries(xs)
        out, final = xs, []
        for cell, carry in zip(self.cells(), carries):
            w_in, w_h, b_h = cell.fused()
            x_proj = F.linear(out, w_in)                    # (B, T, 4H)
            hs = []
            for t in range(xs.shape[1]):
                carry = cell.step(carry, x_proj[:, t], w_h, b_h)
                hs.append(carry[1])
            out = torch.stack(hs, dim=1)
            final.append(carry)
        return out, final

    def step(self, carries: List[Carry], x: torch.Tensor, weights
             ) -> Tuple[List[Carry], torch.Tensor]:
        """One timestep through the stack, ``weights`` being each cell's
        ``fused()``; returns (new carries, the top layer's h)."""
        new, h = [], x
        for cell, carry, (w_in, w_h, b_h) in zip(self.cells(), carries,
                                                 weights):
            carry = cell.step(carry, F.linear(h, w_in), w_h, b_h)
            new.append(carry)
            h = carry[1]
        return new, h


class CSLSTM(nn.Module):
    """2-layer LSTM encoder-decoder (ref scripts/baseline_cs_lstm.py:192-248)."""

    def __init__(self, seq_len: int, out_len: int, feature_size: int = 2,
                 hidden_dim: int = 128, num_layers: int = 2):
        super().__init__()
        self.out_len = out_len
        self.encoder = StackedLSTM(feature_size, hidden_dim, num_layers)
        self.decoder = StackedLSTM(feature_size, hidden_dim, num_layers)
        self.fc = Dense(hidden_dim, feature_size)

    def forward(self, batch: dict, deterministic: bool = True,
                teacher: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """batch["traj_in"] (B, 2, T_in) -> (B, 2, T_out).  With
        ``teacher`` (B, 2, T_out) the decoder reads [last input, y_0 ..
        y_{T-2}] (teacher forcing); without, it feeds back its own
        predictions for ``out_len`` steps.  No randomness: ``deterministic``
        and ``generator`` change nothing."""
        x = batch["traj_in"].transpose(1, 2)                 # (B, T, 2)
        _, carries = self.encoder(x)
        prev = x[:, -1, :]
        if teacher is not None:
            y = teacher.transpose(1, 2)
            outs, _ = self.decoder(torch.cat([prev[:, None], y[:, :-1]], 1),
                                   carries)
            preds = self.fc(outs)                            # (B, T_out, 2)
        else:
            weights = [cell.fused() for cell in self.decoder.cells()]
            preds = []
            for _ in range(self.out_len):
                carries, h = self.decoder.step(carries, prev, weights)
                prev = self.fc(h)
                preds.append(prev)
            preds = torch.stack(preds, dim=1)
        return preds.transpose(1, 2)


class SocialLSTM(nn.Module):
    """Embed -> LSTM -> FC to horizon (ref scripts/baseline_sociallstm.py:193-250)."""

    def __init__(self, seq_len: int, out_len: int, feature_size: int = 2,
                 embedding_dim: int = 64, hidden_dim: int = 128):
        super().__init__()
        self.out_len, self.feature_size = out_len, feature_size
        self.embedding = Dense(feature_size, embedding_dim)
        self.lstm = StackedLSTM(embedding_dim, hidden_dim, 1)
        self.fc = Dense(hidden_dim, out_len * feature_size)

    def forward(self, batch: dict, deterministic: bool = True,
                teacher: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = batch["traj_in"].transpose(1, 2)                 # (B, T, 2)
        outs, _ = self.lstm(self.embedding(x))
        pred = self.fc(outs[:, -1])
        return pred.reshape(-1, self.out_len,
                            self.feature_size).transpose(1, 2)
