"""Multimodal fusion: Q-Former image tokens + text embeddings -> Llama.

Counterpart of ``tsue_tpu/models/fusion.py`` (``MultiModalLLM.fuse`` and
``__call__``; ref scripts/train.py:459-575): image tokens projected to the
LLM width plus learned vision/text modality embeddings, input-level concat
[img || text], the extended attention mask, the Llama forward returning
the last hidden states, the stage-1 LM loss (``lm_loss``: -100 over the
image-token span), and generation support: the soft-prefix prefill into a
KV cache, the cached decode step and the speculative window forward
(``fusion.py:87-194``).  The blocks
drop (Q-Former, LoRA) when a ``generator`` is passed, and only then.

Under tensor parallelism (``mesh.model > 1``) the Llama is this rank's
local shard (``models/llama.py``) and the image tokens' projection to the
LLM width is split by columns, as the JAX package's rule for a
``q_proj`` kernel splits it: this rank's slice of the output features,
gathered whole, then the whole bias.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tsue_tpu_torch.config import LlamaConfig, QFormerConfig
from tsue_tpu_torch.models.llama import (IGNORE_LABEL, LlamaForCausalLM,
                                         init_kv_cache)
from tsue_tpu_torch.models.layers import Dense
from tsue_tpu_torch.models.qformer import QFormer
from tsue_tpu_torch.parallel.mesh import copy_to_model, gather_from_model
from tsue_tpu_torch.parallel.sharding import unsharded
from tsue_tpu_torch.utils.precision import promote


class ColumnDense(Dense):
    """The image tokens' projection under TP: this rank's column slice of
    the output features (weight ``(d_out / model, d_in)``), gathered
    whole, then the whole bias ``(d_out,)``, which has no split rule."""

    def __init__(self, d_in: int, d_out: int, mesh):
        super().__init__(d_in, d_out // mesh.model)
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = promote(x, self.weight)
        y = torch.nn.functional.linear(copy_to_model(x, self.mesh).to(dt),
                                       self.weight.to(dt))
        return gather_from_model(y, self.mesh) + self.bias.to(dt)


class MultiModalLLM(nn.Module):
    def __init__(self, llama: LlamaConfig, qformer: QFormerConfig,
                 use_vision: bool = True, dtype: torch.dtype = torch.float32,
                 mesh=None, layers=None):
        """``layers``: the decoder layers a pipeline stage holds (all by
        default; ``parallel.pipeline``)."""
        super().__init__()
        self.use_vision = use_vision
        self.mesh = mesh
        tp = mesh.model if mesh is not None else 1
        if use_vision:
            self.qformer = QFormer(qformer)
            if qformer.hidden_size == llama.hidden_size:
                self.q_proj = nn.Identity()
            elif tp > 1:
                self.q_proj = ColumnDense(qformer.hidden_size,
                                          llama.hidden_size, mesh)
            else:
                self.q_proj = Dense(qformer.hidden_size, llama.hidden_size)
            self.vision_modality_embedding = nn.Parameter(
                torch.zeros(1, 1, llama.hidden_size))
        self.text_modality_embedding = nn.Parameter(
            torch.zeros(1, 1, llama.hidden_size))
        self.llama = LlamaForCausalLM(llama, dtype, mesh, layers)

    def image_tokens(self, vision: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        return (self.q_proj(self.qformer(vision, generator))
                + self.vision_modality_embedding)

    def fuse(self, vision: Optional[torch.Tensor], input_ids: torch.Tensor,
             attention_mask: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        """Fused embeddings and mask: returns (embeds, mask, n_img)."""
        with unsharded(self):   # the modality embeddings (FSDP)
            text = self.llama.embed(input_ids) + self.text_modality_embedding
            if not (self.use_vision and vision is not None):
                return text, attention_mask, 0
            img = self.image_tokens(vision, generator).to(text.dtype)
        n_img = img.shape[1]
        img_mask = torch.ones(text.shape[0], n_img, dtype=attention_mask.dtype,
                              device=attention_mask.device)
        return (torch.cat([img, text], dim=1),
                torch.cat([img_mask, attention_mask], dim=1), n_img)

    def forward(self, vision, input_ids, attention_mask,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage-2 path: (final_hidden (B, n_img + L, D), fused_mask)."""
        fused, mask, _ = self.fuse(vision, input_ids, attention_mask,
                                   generator)
        return self.llama(fused, mask, generator=generator)["hidden"], mask

    def lm_loss(self, vision, input_ids, attention_mask, labels,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Stage-1 path: the causal-LM loss over the fused sequence, with
        -100 prepended across the image-token span (``fusion.py:196-208``,
        ref scripts/train.py:534-543).  ``deterministic=False`` drops,
        drawing from ``generator``, which it then needs."""
        if deterministic:
            generator = None
        elif generator is None:
            raise ValueError("a non-deterministic forward needs a generator "
                             "for its dropout")
        fused, mask, n_img = self.fuse(vision, input_ids, attention_mask,
                                       generator)
        if n_img:
            pad = torch.full((labels.shape[0], n_img), IGNORE_LABEL,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        return self.llama(fused, mask, labels=labels,
                          generator=generator)["loss"]

    # generation support: soft-prefix prefill + cached decode

    def prefill(self, vision: Optional[torch.Tensor],
                prompt_ids: torch.Tensor, prompt_mask: torch.Tensor,
                cache_len: int):
        """Prefill KV caches of ``cache_len`` slots, in the fused
        embeddings' dtype (fp32, or bf16 for bf16 parameters), with the
        fused [img || prompt] prefix.  Returns (caches, last_hidden (B, D),
        prefix_valid_len (B,), fused_mask (B, P)).  Positions are the
        cumulative count of the fused mask; the prompt occupies a prefix of
        its row, so the last valid position is ``valid_len - 1``."""
        fused, fmask, _ = self.fuse(vision, prompt_ids, prompt_mask)
        B, P, _ = fused.shape
        caches = init_kv_cache(self.llama.cfg, B, cache_len, fused.dtype,
                               fused.device)
        hidden = self.llama.model(fused, fmask, kv_caches=caches,
                                  cache_index=0)
        valid_len = fmask.sum(dim=1)
        rows = torch.arange(B, device=fused.device)
        last_hidden = hidden[rows, valid_len - 1]
        return caches, last_hidden, valid_len.to(torch.int32), fmask

    def decode_hidden(self, token: torch.Tensor, step_index,
                      prefix_len: torch.Tensor, caches,
                      fused_mask: torch.Tensor, cache_len: int,
                      quant_ok: bool = True) -> torch.Tensor:
        """One cached decode step without the LM head: token (B,) at
        decode step ``step_index`` -> hidden (B, D); the caches are written
        in place at slot P + step_index.  ``step_index`` is an int, or a
        (B,) tensor of per-row steps (continuous batching: every slot
        advances on its own clock, ``tsue_tpu/models/fusion.py:142-161``).
        Generated tokens are embedded without the text modality embedding
        (the reference's patched embedding) at positions ``prefix_len +
        step_index``; row b sees its valid prefix and the decode slots up
        to its own (a (B, S) key mask)."""
        P = fused_mask.shape[1]
        dev = token.device
        emb = self.llama.embed(token[:, None])
        pos = (prefix_len.long() + step_index)[:, None]
        slot = P + step_index
        upper = slot[:, None] if isinstance(slot, torch.Tensor) else slot
        k_idx = torch.arange(cache_len, device=dev)[None, :]
        prefix_ok = torch.nn.functional.pad(fused_mask, (0, cache_len - P)) > 0
        kv_mask = ((k_idx < P) & prefix_ok) | ((k_idx >= P) & (k_idx <= upper))
        hidden = self.llama.model(emb, positions=pos, kv_caches=caches,
                                  cache_index=slot, kv_mask=kv_mask,
                                  quant_ok=quant_ok)
        return hidden[:, 0]

    def decode_step(self, token: torch.Tensor, step_index,
                    prefix_len: torch.Tensor, caches,
                    fused_mask: torch.Tensor, cache_len: int) -> torch.Tensor:
        """``decode_hidden`` followed by the LM head: (B, V) fp32 logits."""
        hidden = self.decode_hidden(token, step_index, prefix_len, caches,
                                    fused_mask, cache_len)
        return self.llama.logits_from_hidden(hidden, quant_ok=True)

    def decode_window(self, tokens: torch.Tensor, step_index,
                      prefix_len: torch.Tensor, caches,
                      fused_mask: torch.Tensor, cache_len: int
                      ) -> torch.Tensor:
        """Cached decode over a W-token window (speculative decoding,
        ``tsue_tpu/models/fusion.py:163-194``): tokens (B, W) at decode
        steps ``step_index`` .. + W - 1 (an int, or (B,) per-row steps) ->
        (B, W, V) fp32 logits.  The caches are written in place at slots P
        + step .. P + step + W - 1 of each row.  Position j of row b sees
        the valid prefix and the decode slots P .. P + step[b] + j (its own
        slot included: causality inside the window), a (B, W, S)
        per-query mask; so logits[:, j] conditions on tokens[:, :j + 1],
        and one forward, one pass over the weights, scores every draft.
        At W = 1 it computes what ``decode_step`` computes."""
        B, W = tokens.shape
        P = fused_mask.shape[1]
        dev = tokens.device
        step = (step_index.to(dev, torch.long)
                if isinstance(step_index, torch.Tensor)
                else torch.full((B,), step_index, dtype=torch.long,
                                device=dev))
        emb = self.llama.embed(tokens)
        offs = torch.arange(W, device=dev)[None, :]
        pos = prefix_len.long()[:, None] + step[:, None] + offs
        slot = P + step
        k_idx = torch.arange(cache_len, device=dev)[None, None, :]
        prefix_ok = torch.nn.functional.pad(fused_mask,
                                            (0, cache_len - P)) > 0
        upper = (slot[:, None] + offs)[..., None]            # (B, W, 1)
        kv_mask = (((k_idx < P) & prefix_ok[:, None, :])
                   | ((k_idx >= P) & (k_idx <= upper)))      # (B, W, S)
        hidden = self.llama.model(emb, positions=pos, kv_caches=caches,
                                  cache_index=slot, kv_mask=kv_mask,
                                  quant_ok=True)
        return self.llama.logits_from_hidden(hidden, quant_ok=True)
