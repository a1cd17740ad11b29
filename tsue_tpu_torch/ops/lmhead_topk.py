"""Fused LM head + exact top-128, and sampling from that slice.

Counterpart of ``tsue_tpu/ops/lmhead_topk.py``.  ``lmhead_topk`` takes the
decode hidden state and returns the 128 largest processed logits of each
row, with their indices, ordered by (value desc, index asc) — a stable
descending sort of the processed logits, truncated to 128 — without ever
writing the (B, V) logits to device memory.  The processing is the plain
sampler's repetition penalty (divide when positive, multiply otherwise)
and n-gram ban (``NEG_INF``), read from a (B, V) token-state mask
(``token_state_mask``).  The weight is the raw tied embedding (V, D), fp32
with fp32 h or bf16 with bf16 h, or the int8 head ``(w8 (D, V), scale
(V,))`` of ``ops/quant.py`` with fp32 or bf16 h.  The logits are fp32
sums of the products of h and the weight in h's dtype (for bf16 these
products are exact in fp32), as the Pallas kernel computes them
(``tsue_tpu/ops/lmhead_topk.py:163-170``).

On CUDA tensors it runs the kernel ``csrc/lmhead_topk.cu`` and on CPU
tensors its plain version ``lmhead_topk_plain``, and only there: a CUDA
tensor the kernel cannot take raises.  ``sample_from_topk_slice`` draws the
next tokens from the slice with the draws of ``ops.sampling``: tokens are
the plain chain's whenever the processed logits agree and the tie class of
the k-th logit fits in the slice.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tsue_tpu_torch.ops._build import (bind, check_tensor, count_launch,
                                     refuse_grad, uses_kernel)
from tsue_tpu_torch.ops.sampling import (NEG_INF, SamplingConfig,
                                         banned_tokens, gumbel_argmax,
                                         seen_tokens, slot_logits_from_sorted,
                                         sorted_desc, tie_target)

LANES = 128          # width of the emitted slice
_SEEN, _BANNED = 1, 2


def token_state_mask(token_history: torch.Tensor, history_len: torch.Tensor,
                     vocab_size: int, cfg: SamplingConfig) -> torch.Tensor:
    """(B, V) int32 per-token state for the head's processors: bit 0 = in
    the history (repetition penalty), bit 1 = completes a seen n-gram
    (ban).  The window match of ``ops.sampling``.  As in the JAX package
    the two are combined by a maximum, so a banned token holds 2 alone:
    the ban overrides the penalty either way."""
    B = token_history.shape[0]
    mask = torch.zeros(B, vocab_size, dtype=torch.int32,
                       device=token_history.device)
    if cfg.repetition_penalty != 1.0:
        mask = seen_tokens(token_history, history_len,
                           vocab_size).to(torch.int32) * _SEEN
    if cfg.no_repeat_ngram_size > 0:
        banned = banned_tokens(token_history, history_len, vocab_size,
                               cfg.no_repeat_ngram_size)
        mask = torch.maximum(mask, banned.to(torch.int32) * _BANNED)
    return mask


def lmhead_topk_plain(hidden: torch.Tensor, weight: Optional[torch.Tensor],
                      mask: Optional[torch.Tensor], penalty: float = 1.0,
                      quant=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch ops: the (B, V) logits, the mask's
    penalty and ban, then a stable descending sort cut to 128."""
    h = hidden.float()
    if quant is not None:
        w8, scale = quant
        logits = (h @ w8.float()) * scale
    else:
        logits = h @ weight.to(hidden.dtype).float().t()
    if mask is not None:
        if penalty != 1.0:
            pen = torch.where(logits > 0, logits / penalty, logits * penalty)
            logits = torch.where((mask & _SEEN) != 0, pen, logits)
        logits = logits.masked_fill((mask & _BANNED) != 0, NEG_INF)
    vals, idx = sorted_desc(logits, LANES)
    return vals, idx.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _lib():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return bind("lmhead_topk", {
        "lmhead_topk": [ptr, ptr, ptr, ptr, ptr,        # h w w8 scale mask
                        ctypes.c_float, ptr, ptr, ptr,  # penalty cand vals idx
                        i32, i32, i32, i32, ptr],       # B D V bf16 stream
        "lmhead_topk_plan": [i32, i32]})                # form field


LAYOUTS = ("int8", "tied_fp32", "tied_bf16")
PLAN_FIELDS = ("tile_cols", "warp_cols", "k_rows_per_stage", "stages",
               "smem_bytes", "threads", "stage_rows")


def lmhead_topk_plan(layout: str = "int8") -> dict:
    """The layout of one form of the kernel (builds the kernel): the vocab
    columns a CTA (the tile: one CTA a tile, one candidate list a tile and
    batch row), the tile's columns a warp owns, the K (= D) rows a stage of
    the cp.async ring, the ring's stages, the shared memory and the threads
    of a CTA, and the vocab columns a stage holds (the whole tile, or the
    tied bf16 form's 256-row chunk).  ``layout`` is "int8" (fp32 or bf16 h:
    one layout), "tied_fp32" or "tied_bf16"."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    lib, form = _lib(), LAYOUTS.index(layout)
    return {f: lib.lmhead_topk_plan(form, i)
            for i, f in enumerate(PLAN_FIELDS)}


def _lmhead_cuda(hidden, weight, mask, penalty, quant):
    if hidden.dim() != 2:
        raise ValueError("hidden must be (B, D)")
    B, D = hidden.shape
    dev = hidden.device
    hd = hidden.dtype
    if hd not in (torch.float32, torch.bfloat16):
        raise TypeError(f"hidden must be fp32 or bf16, got {hd}")
    check_tensor("hidden", hidden, dev, (B, D), hd, True)
    w_ptr = w8_ptr = s_ptr = None
    if quant is not None:
        w8, scale = quant
        V = w8.shape[1]
        check_tensor("w8", w8, dev, (D, V), torch.int8, True)
        check_tensor("scale", scale, dev, (V,), torch.float32, True)
        w8_ptr, s_ptr = w8.data_ptr(), scale.data_ptr()
    else:
        V = weight.shape[0]
        # the tied forms take the weight in h's dtype
        check_tensor("weight", weight, dev, (V, D), hd, True)
        w_ptr = weight.data_ptr()
    dmod = 8 if hd == torch.bfloat16 else 4    # 16-byte rows of h
    if V < LANES or V % 4 or D % dmod or B == 0:
        raise ValueError(f"the head kernel needs V >= {LANES}, V % 4 == 0, "
                         f"D % {dmod} == 0 and B > 0 (B={B}, D={D}, V={V})")
    mask_ptr = None
    if mask is not None:
        check_tensor("mask", mask, dev, (B, V), torch.int32, True)
        mask_ptr = mask.data_ptr()
    lib = _lib()
    layout = ("int8" if quant is not None else
              "tied_bf16" if hd == torch.bfloat16 else "tied_fp32")
    n_tiles = -(-V // lib.lmhead_topk_plan(LAYOUTS.index(layout), 0))
    cand = torch.empty(B, n_tiles, LANES, device=dev, dtype=torch.int64)
    vals = torch.empty(B, LANES, device=dev, dtype=torch.float32)
    idx = torch.empty(B, LANES, device=dev, dtype=torch.int32)
    with torch.cuda.device(dev):
        err = lib.lmhead_topk(
            hidden.data_ptr(), w_ptr, w8_ptr, s_ptr, mask_ptr, float(penalty),
            cand.data_ptr(), vals.data_ptr(), idx.data_ptr(), B, D, V,
            int(hd == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    count_launch(lmhead_topk, err)
    return vals, idx


def lmhead_topk(hidden: torch.Tensor, weight: Optional[torch.Tensor],
                mask: Optional[torch.Tensor], penalty: float = 1.0,
                quant=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Processed-logits exact top-128 straight from the hidden state.

    hidden: (B, D) fp32 or bf16.  ``weight``: the tied embedding (V, D)
    (on the card in hidden's dtype), or None with ``quant=(w8 (D, V) int8,
    scale (V,) fp32)``.  ``mask``: the
    (B, V) int32 ``token_state_mask`` or None.  Returns (vals (B, 128)
    fp32, idx (B, 128) int32).  CPU tensors take ``lmhead_topk_plain``;
    CUDA tensors launch the kernel or raise (also under grad mode when an
    input requires a gradient: the kernel has no backward).
    ``lmhead_topk.launches`` counts kernel launches."""
    if not uses_kernel(hidden, "head kernel"):
        return lmhead_topk_plain(hidden, weight, mask, penalty, quant)
    refuse_grad("lmhead_topk", hidden, weight, *(quant or ()))
    return _lmhead_cuda(hidden, weight, mask, penalty, quant)


lmhead_topk.launches = 0


def topk_slice_slots(vals: torch.Tensor, idx: torch.Tensor, k: int, p: float,
                     temperature: float):
    """The slot logits of ``ops.sampling._topk_topp_slots`` computed on the
    (B, M) slice instead of the whole vocabulary.  Returns (slot_logits,
    t_keep, tie (B, M) bool, spill (B,) bool); ``spill`` flags rows whose
    tie class may run past the slice.  Temperature is applied here: it is
    monotonic, so the slice of the raw logits is the slice of the scaled
    ones."""
    M = vals.shape[1]
    v = vals if temperature == 1.0 else vals / temperature
    thresh = v[:, k - 1:k]
    tie = v == thresh
    spill = v[:, M - 1] == thresh[:, 0]
    slot_logits, t_keep = slot_logits_from_sorted(v, k, p, tie.sum(dim=-1))
    return slot_logits, t_keep, tie, spill


def _draw_slice(slot_logits, idx, t_keep, tie, k: int,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """``ops.sampling._draw_sliced`` on slice-local ties, with the same
    draws (the categorical noise, then one uniform per row): tie entry j is
    the j-th tied slot in slice order, which is ascending token order."""
    choice = gumbel_argmax(slot_logits, generator)
    target = tie_target(t_keep, generator)
    trank = torch.cumsum(tie.to(torch.int64), dim=-1) - 1
    tie_slot = torch.argmax((tie & (trank == target[:, None])).to(torch.int32),
                            dim=-1)
    tie_tok = idx.gather(1, tie_slot[:, None])[:, 0]
    from_slice = idx.gather(1, choice.clamp_max(k - 1)[:, None])[:, 0]
    return torch.where(choice == k, tie_tok, from_slice)


def sample_from_topk_slice(vals: torch.Tensor, idx: torch.Tensor,
                           generator: Optional[torch.Generator],
                           cfg: SamplingConfig) -> torch.Tensor:
    """(vals, idx) of ``lmhead_topk`` -> next tokens (B,).  Greedy returns
    slot 0 (the argmax with ascending-index ties); the sampled arm needs
    ``0 < cfg.top_k < 128``."""
    if not cfg.do_sample:
        return idx[:, 0]
    M = vals.shape[1]
    if not 0 < cfg.top_k < M:
        raise ValueError(f"fused sampling needs 0 < top_k < {M}, got "
                         f"{cfg.top_k} (use the plain sampler)")
    slot_logits, t_keep, tie, _ = topk_slice_slots(
        vals, idx, cfg.top_k, cfg.top_p, cfg.temperature)
    return _draw_slice(slot_logits, idx, t_keep, tie, cfg.top_k, generator)
