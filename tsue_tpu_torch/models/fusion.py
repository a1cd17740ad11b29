"""Multimodal fusion: Q-Former image tokens + text embeddings -> Llama.

Counterpart of ``tsue_tpu/models/fusion.py`` (``MultiModalLLM.fuse`` and
``__call__``; ref scripts/train.py:459-575): image tokens projected to the
LLM width plus learned vision/text modality embeddings, input-level concat
[img || text], the extended attention mask, and the Llama forward returning
the last hidden states, and generation support: the soft-prefix prefill
into a KV cache and the cached decode step (``fusion.py:87-161``).  The LM
loss comes with a later slice.  The stage-2 forward drops (Q-Former, LoRA)
when a ``generator`` is passed, and only then.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tsue_tpu_torch.config import LlamaConfig, QFormerConfig
from tsue_tpu_torch.models.llama import LlamaForCausalLM, init_kv_cache
from tsue_tpu_torch.models.qformer import QFormer


class MultiModalLLM(nn.Module):
    def __init__(self, llama: LlamaConfig, qformer: QFormerConfig,
                 use_vision: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_vision = use_vision
        if use_vision:
            self.qformer = QFormer(qformer)
            self.q_proj = (nn.Linear(qformer.hidden_size, llama.hidden_size)
                           if qformer.hidden_size != llama.hidden_size
                           else nn.Identity())
            self.vision_modality_embedding = nn.Parameter(
                torch.zeros(1, 1, llama.hidden_size))
        self.text_modality_embedding = nn.Parameter(
            torch.zeros(1, 1, llama.hidden_size))
        self.llama = LlamaForCausalLM(llama, dtype)

    def image_tokens(self, vision: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        return (self.q_proj(self.qformer(vision, generator))
                + self.vision_modality_embedding)

    def fuse(self, vision: Optional[torch.Tensor], input_ids: torch.Tensor,
             attention_mask: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        """Fused embeddings and mask: returns (embeds, mask, n_img)."""
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
        return self.llama(fused, mask, generator), mask

    # generation support: soft-prefix prefill + cached decode

    def prefill(self, vision: Optional[torch.Tensor],
                prompt_ids: torch.Tensor, prompt_mask: torch.Tensor,
                cache_len: int):
        """Prefill fp32 KV caches of ``cache_len`` slots with the fused
        [img || prompt] prefix.  Returns (caches, last_hidden (B, D),
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

    def decode_hidden(self, token: torch.Tensor, step_index: int,
                      prefix_len: torch.Tensor, caches,
                      fused_mask: torch.Tensor, cache_len: int,
                      quant_ok: bool = True) -> torch.Tensor:
        """One cached decode step without the LM head: token (B,) at
        decode step ``step_index`` (an int) -> hidden (B, D); the caches
        are written in place at slot P + step_index.  Generated tokens are
        embedded without the text modality embedding (the reference's
        patched embedding) at positions ``prefix_len + step_index``; they
        see the valid prefix and the decode slots up to their own."""
        P = fused_mask.shape[1]
        dev = token.device
        emb = self.llama.embed(token[:, None])
        pos = (prefix_len.long() + step_index)[:, None]
        slot = P + step_index
        k_idx = torch.arange(cache_len, device=dev)[None, :]
        prefix_ok = torch.nn.functional.pad(fused_mask, (0, cache_len - P)) > 0
        kv_mask = ((k_idx < P) & prefix_ok) | ((k_idx >= P) & (k_idx <= slot))
        hidden = self.llama.model(emb, positions=pos, kv_caches=caches,
                                  cache_index=slot, kv_mask=kv_mask,
                                  quant_ok=quant_ok)
        return hidden[:, 0]

    def decode_step(self, token: torch.Tensor, step_index: int,
                    prefix_len: torch.Tensor, caches,
                    fused_mask: torch.Tensor, cache_len: int) -> torch.Tensor:
        """``decode_hidden`` followed by the LM head: (B, V) fp32 logits."""
        hidden = self.decode_hidden(token, step_index, prefix_len, caches,
                                    fused_mask, cache_len)
        return self.llama.logits_from_hidden(hidden, quant_ok=True)
