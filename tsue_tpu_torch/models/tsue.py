"""Top-level TSUE trajectory model.

Counterpart of ``tsue_tpu/models/tsue.py`` (ref scripts/train.py:847-964):
lane polygon encoder + multimodal LLM hidden states + LTSF forecaster +
last-input-position residual, split into the deterministic per-batch
context (``encode_context``/``encode_context_kv``) and the forecaster
(``forecast``/``forecast_kv``), whose dropout drives K-candidate diversity.
Dropout draws from a ``generator`` and runs only where one is passed: the
training forward (``forward(batch, deterministic=False, generator=...)``)
drops everywhere, the fast rollout drops in ``forecast_kv`` only, and the
deterministic forward nowhere.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch import nn

from tsue_tpu_torch.config import ModelConfig
from tsue_tpu_torch.models.fusion import MultiModalLLM
from tsue_tpu_torch.models.lane_encoder import LanePolygonEncoder
from tsue_tpu_torch.models.llama import LoRADense, RMSNorm
from tsue_tpu_torch.models.ltsf import PerChannelLinear, TransformerLTSF


class TrajectoryModel(nn.Module):
    def __init__(self, cfg: ModelConfig, seq_len: int, out_len: int):
        super().__init__()
        self.cfg = cfg
        self.lane_encoder = LanePolygonEncoder(
            d_model=cfg.lane.d_model, num_heads=cfg.lane.nhead,
            num_layers=cfg.lane.num_layers, max_points=cfg.lane.max_points,
            dropout=cfg.lane.dropout)
        if cfg.use_llm:
            dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                     else torch.float32)
            self.mllm = MultiModalLLM(cfg.llama, cfg.qformer,
                                      use_vision=cfg.use_vision, dtype=dtype)
        self.ltsf = TransformerLTSF(
            seq_len=seq_len, out_len=out_len, d_model=cfg.ltsf.d_model,
            individual=cfg.ltsf.individual,
            feature_size=cfg.ltsf.feature_size,
            polygon_embed_dim=cfg.lane.d_model,
            use_post_mlp=cfg.ltsf.use_post_mlp,
            post_mlp_hidden_dim=cfg.ltsf.post_mlp_hidden_dim,
            nhead=cfg.ltsf.nhead, dropout=cfg.ltsf.dropout,
            cross_dim=cfg.llama.hidden_size,
            cross_nhead=cfg.ltsf.cross_nhead, use_cross_attn=cfg.use_llm)

    def encode_context(self, batch: dict,
                       generator: Optional[torch.Generator] = None,
                       stop_llm_grad: bool = False):
        """(final_hidden, hidden_mask, poly_emb): the per-batch context.

        ``stop_llm_grad=True`` runs the MLLM under ``torch.no_grad()``: the
        JAX package's ``stop_gradient`` at the MLLM output, for the regime
        that freezes the whole MLLM (ref scripts/train.py:1141-1142).  Its
        dropout still draws from ``generator``."""
        poly_emb = self.lane_encoder(batch["polygon"], batch["polygon_len"],
                                     generator)
        final_hidden = hidden_mask = None
        if self.cfg.use_llm:
            with (torch.no_grad() if stop_llm_grad
                  else contextlib.nullcontext()):
                final_hidden, hidden_mask = self.mllm(
                    batch.get("vision") if self.cfg.use_vision else None,
                    batch["input_ids"], batch["attention_mask"], generator)
        return final_hidden, hidden_mask, poly_emb

    def encode_context_kv(self, batch: dict):
        """The context with the forecaster's cross-attention K/V projected
        once, so K candidates skip those projections."""
        final_hidden, hidden_mask, poly_emb = self.encode_context(batch)
        cross_kv = None
        if final_hidden is not None:
            cross_kv = self.ltsf.project_cross_kv(final_hidden)
        return cross_kv, hidden_mask, poly_emb

    def forecast_kv(self, batch: dict, cross_kv, hidden_mask, poly_emb,
                    generator: Optional[torch.Generator] = None):
        x = batch["traj_in"]
        pred = self.ltsf(x, poly_emb, None, hidden_mask, generator,
                         cross_kv=cross_kv)
        return pred + x[:, :, -1:]

    def forecast(self, batch: dict, final_hidden, hidden_mask, poly_emb,
                 generator: Optional[torch.Generator] = None):
        """LTSF decode + last-input-position residual (ref :941-943)."""
        x = batch["traj_in"]
        pred = self.ltsf(x, poly_emb, final_hidden, hidden_mask, generator)
        return pred + x[:, :, -1:]

    def forward(self, batch: dict, deterministic: bool = True,
                stop_llm_grad: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """batch -> pred (B, 2, out_len) in normalized coordinates.

        ``deterministic=False`` is the training forward: every dropout draws
        from ``generator``, which it then needs.  ``stop_llm_grad``: see
        ``encode_context``."""
        if deterministic:
            generator = None
        elif generator is None:
            raise ValueError("a non-deterministic forward needs a generator "
                             "for its dropout")
        final_hidden, hidden_mask, poly_emb = self.encode_context(
            batch, generator, stop_llm_grad)
        return self.forecast(batch, final_hidden, hidden_mask, poly_emb,
                             generator)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``, with the distributions of the
    JAX package's Flax initialisers: lecun-normal kernels (dense and
    convolution; the LSTM cells' recurrent kernels too, where Flax draws
    them orthogonal), zero biases, unit norm scales, normal(1) embeddings,
    tokens and modality embeddings, zero positional embeddings and LoRA B,
    U(+-1/sqrt(T_in)) per-channel linears.  The generator must live on the model's device."""
    def normal(t, std):
        t.normal_(0.0, std, generator=generator)

    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            normal(mod.weight, mod.in_features ** -0.5)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Conv1d):
            normal(mod.weight, (mod.in_channels * mod.kernel_size[0]) ** -0.5)
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            normal(mod.weight, mod.embedding_dim ** -0.5)
        elif isinstance(mod, RMSNorm):
            mod.scale.fill_(1.0)
        elif isinstance(mod, LoRADense):
            normal(mod.kernel, mod.kernel.shape[0] ** -0.5)
            if mod.lora_r > 0:
                bound = math.sqrt(6.0 / mod.lora_a.shape[0])
                mod.lora_a.uniform_(-bound, bound, generator=generator)
                mod.lora_b.zero_()
        elif isinstance(mod, PerChannelLinear):
            bound = mod.kernel.shape[1] ** -0.5
            mod.kernel.uniform_(-bound, bound, generator=generator)
            mod.bias.zero_()
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("query_tokens", "vision_modality_embedding",
                    "text_modality_embedding"):
            normal(p, 1.0)
        elif leaf in ("pos_embedding", "pos_encoding"):
            p.zero_()
    return model
