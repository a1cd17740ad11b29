"""Attention ops: the single entry point every model of the port uses.

Counterpart of ``tsue_tpu/ops/attention.py``.  Without dropout, attention
goes to ``ops.flash.flash_attention`` (the CUDA kernel on the card, its
plain version on the CPU).  With probability dropout it runs as PyTorch ops
(``_plain_attention``), as the JAX package runs it outside any Pallas
kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from tsue_tpu_torch.ops.flash import flash_attention, rope_bthd
from tsue_tpu_torch.utils.random import dropout


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          is_causal: bool = False,
                          scale: Optional[float] = None,
                          dropout_p: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
                          = None) -> torch.Tensor:
    """Scaled dot-product attention.

    q: (B, Tq, H, D); k, v: (B, Tk, Hkv, D) with Hkv dividing H (GQA).
    mask: boolean or integer, True = attend: (B, Tk) key validity, or
    per query (B, Tq, Tk) or (B, 1, Tq, Tk) (and (B, H, Tq, Tk) on the
    CPU).  ``dropout_p``/``generator``: dropout on the softmax
    probabilities, active only when both are set.  ``rope``: (cos, sin),
    each (B, T, D/2) fp32, applied to q and k (self-attention).
    Returns (B, Tq, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if dropout_p > 0.0 and generator is not None:
        if rope is not None:
            q = rope_bthd(q, *rope)
            k = rope_bthd(k, *rope)
        return _plain_attention(q, k, v, mask, is_causal, scale, dropout_p,
                                generator)
    return flash_attention(q, k, v, mask=mask, is_causal=is_causal,
                           scale=scale, rope=rope)


def _plain_attention(q, k, v, mask, is_causal, scale, dropout_p=0.0,
                     generator=None, out_dtype=None) -> torch.Tensor:
    """GQA attention without repeating K/V: query head h attends KV head
    h // G, the head order of a repeat of K/V.  The logits and softmax are
    fp32 (``preferred_element_type``), the probabilities are rounded to v's
    dtype, the sums are fp32 and the output takes ``out_dtype``: v's, as
    the JAX package's ``_xla_attention``, by default."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Tq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    probs = _finish_attention(logits.reshape(B, H, Tq, Tk), mask, is_causal,
                              dropout_p, generator)
    out = torch.einsum("bhgqk,bkhd->bqhgd",
                       probs.reshape(B, Hkv, G, Tq, Tk).to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Tq, H, D).to(out_dtype or v.dtype)


def _finish_attention(logits, mask, is_causal, dropout_p, generator):
    """Masked fp32 softmax (masked logits get the dtype's minimum, so a row
    with no valid key is a uniform average) and inverted dropout."""
    Tq, Tk = logits.shape[2], logits.shape[3]
    neg = torch.finfo(logits.dtype).min
    if mask is not None:
        if mask.dim() == 2:                       # (B, Tk) key validity
            mask = mask[:, None, None, :]
        elif mask.dim() == 3:                     # (B, Tq, Tk) per query
            mask = mask[:, None]
        logits = logits.masked_fill(~mask.bool(), neg)
    if is_causal:
        causal = torch.ones(Tq, Tk, dtype=torch.bool,
                            device=logits.device).tril(Tk - Tq)
        logits = logits.masked_fill(~causal, neg)
    probs = torch.softmax(logits, dim=-1)
    return dropout(probs, dropout_p, generator)
