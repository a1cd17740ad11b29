"""Flash-attention forward: the Hopper kernel and its plain PyTorch version.

Counterpart of ``tsue_tpu/ops/flash.py``.  The three Pallas bodies there
(``_gqa_rope_kernel``, ``_gqa_kernel``, ``_folded_kernel``) are one CUDA
source here, ``csrc/flash_attn_fwd.cu``: on Hopper the GQA index map
``h_kv = h_q // G`` replaces the TPU's head folding and K/V repetition.  It
has two forms, picked per call by the C side: a tiled one for many (row,
head) items per (batch, KV head), and a split-KV one for few items over
many keys (decode, the LTSF cross-attention), which writes per-split
partials to a scratch allocated here and merges them in a second launch.
All-bf16 calls run on the bf16 tensor cores: the tiled form as
"bf16_mma", the split-KV form (no RoPE, at most 16 items) as
"bf16_decode", which merges its splits in the same launch.  bf16 k and v at
D = 1024 (the LTSF cross-attention of a bf16 model, q fp32 or bf16) take
"bf16_wide": the tensor cores too, an fp32 q split into three exact bf16
terms, the key splits of a thread block cluster merged in the same launch.
``flash_attention_form`` names the form a call takes,
``flash_attention_plan`` its splits and blocks.
``flash_attention.launches`` counts calls, one per call in any form.
The mask is a (B, Tk) key mask or a per-query (B, Tq, Tk) one (a
speculative window's in-window causality), passed to the kernel with its
query stride (0 or Tk).

Dtypes (the Pallas function, ``tsue_tpu/ops/flash.py:_softmax_attend``):
q, k and v fp32 or bf16, k and v alike.  The logits and the softmax are
fp32, a roped q or k is rounded back to its own dtype, the probabilities
are rounded to v's dtype before the product with v, the sums are fp32 and
the output takes q's dtype.  The kernel takes fp32, bf16, and fp32 q over
bf16 k and v; a bf16 q over fp32 k and v (no RoPE) is widened to fp32
first, which is exact, and its output rounded to bf16.

``flash_attention`` takes the plain version for tensors on the CPU, and
only there.  On a CUDA tensor it launches the kernel or raises: there is
no fallback.  Training differentiates it through ``_FlashAttention``, whose
backward recomputes with the plain version, as the JAX package's
``_flash_bwd`` does (``tsue_tpu/ops/flash.py:394-419``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tsue_tpu_torch.ops._build import (bind, check_tensor, count_launch,
                                     recompute_backward, uses_kernel)

SUPPORTED_HEAD_DIMS = (16, 32, 64, 96, 128, 1024)
_FLOATS = (torch.float32, torch.bfloat16)
# the C side's Dtypes codes: (q dtype, k/v dtype) -> dt
_DT = {(torch.float32, torch.float32): 0,
       (torch.bfloat16, torch.bfloat16): 1,
       (torch.float32, torch.bfloat16): 2}


def rope_bthd(x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding on (B, T, H, D) given (B, T, D/2) fp32 cos/sin —
    the rotate-half math of ``tsue_tpu.ops.flash.rope_bthd``."""
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def flash_attention_plain(q, k, v, mask=None, is_causal=False, scale=None,
                          rope=None) -> torch.Tensor:
    """The kernel's function in PyTorch ops: rope, then the
    ``_xla_attention``/``_finish_attention`` math, the output in q's
    dtype."""
    from tsue_tpu_torch.ops.attention import _plain_attention
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if rope is not None:
        q = rope_bthd(q, *rope)
        k = rope_bthd(k, *rope)
    return _plain_attention(q, k, v, mask, is_causal, scale,
                            out_dtype=q.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return bind("flash_attn_fwd", {
        "flash_attn_splits": [i32] * 9,     # B Tq Tk Hq Hkv D rope pq dt
        "flash_attn_form": [i32] * 9,       # the same
        "flash_attn_plan": [i32] * 10,      # the same, then the field
        "flash_attn_fwd": [
            ptr, ptr, ptr, ptr, ptr, ptr,   # q k v mask cos sin
            ptr, ptr,                       # out, split scratch
            i32, i32, i32, i32, i32, i32,   # B Tq Tk Hq Hkv D
            i32, ctypes.c_float, i32,       # causal scale splits
            i32, i32, ptr]})                # mask query stride, dt, stream


# the C side's forms (flash_attn_form)
_FORMS = ("tiled", "split-KV", "split-KV D1024", "bf16_mma", "bf16_decode",
          "bf16_wide")
# flash_attn_plan's fields
_PLAN_FIELDS = ("form", "splits", "cluster", "blocks", "keys_per_split",
                "waves")


def _call_codes(q_dtype, kv_dtype):
    """The dtypes code of a call (a bf16 q over fp32 k and v takes its
    widened fp32 call)."""
    if (q_dtype, kv_dtype) == (torch.bfloat16, torch.float32):
        q_dtype = torch.float32
    return _DT[(q_dtype, kv_dtype)]


def flash_attention_form(B: int, Tq: int, Tk: int, Hq: int, Hkv: int,
                         D: int, rope: bool, per_query_mask: bool,
                         q_dtype: torch.dtype, kv_dtype: torch.dtype) -> str:
    """The form of the kernel a call on the card takes: "tiled" (fp32
    FMAs), "split-KV", "split-KV D1024", "bf16_mma" (the tiled form of
    all-bf16 operands, on the bf16 tensor cores), "bf16_decode" (the
    split-KV form of all-bf16 operands, on the tensor cores, one launch
    with its merge) or "bf16_wide" (bf16 k and v at D = 1024, q fp32 or
    bf16: the tensor cores, one launch of clusters).  Asks the CUDA library,
    which builds it; raises for a call the kernel does not take.  A bf16 q
    over fp32 k and v takes the form of its widened fp32 call."""
    form = _lib().flash_attn_form(B, Tq, Tk, Hq, Hkv, D, int(rope),
                                  int(per_query_mask),
                                  _call_codes(q_dtype, kv_dtype))
    if form < 0:
        raise ValueError(f"the attention kernel does not take B={B} Tq={Tq} "
                         f"Tk={Tk} Hq={Hq} Hkv={Hkv} D={D} with q {q_dtype},"
                         f" k {kv_dtype}")
    return _FORMS[form]


def flash_attention_plan(B: int, Tq: int, Tk: int, Hq: int, Hkv: int,
                         D: int, rope: bool, per_query_mask: bool,
                         q_dtype: torch.dtype, kv_dtype: torch.dtype
                         ) -> dict:
    """A call's plan on the card: its "form" (as ``flash_attention_form``),
    its key "splits", the "cluster" size that merges them ("bf16_wide"; 1
    for the others), the "blocks" of the launch, the "keys_per_split" of
    the longest split and the "waves" of clusters ("bf16_wide"; 0 for the
    others).  Asks the CUDA library; raises as ``flash_attention_form``."""
    plan = {"form": flash_attention_form(B, Tq, Tk, Hq, Hkv, D, rope,
                                         per_query_mask, q_dtype, kv_dtype)}
    dt = _call_codes(q_dtype, kv_dtype)
    for i, name in enumerate(_PLAN_FIELDS[1:], 1):
        plan[name] = _lib().flash_attn_plan(B, Tq, Tk, Hq, Hkv, D, int(rope),
                                            int(per_query_mask), dt, i)
    return plan


def _flash_cuda(q, k, v, mask, is_causal, scale, rope) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q/k/v must be (B, T, H, D)")
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in _FLOATS or k.dtype not in _FLOATS:
        raise TypeError(f"the attention kernel takes float32 or bfloat16, "
                        f"got q {q.dtype}, k {k.dtype}")
    if (q.dtype, k.dtype) == (torch.bfloat16, torch.float32):
        if rope is not None:
            # the roped q would be rounded to bf16: no exact widening
            raise ValueError("the attention kernel takes a bf16 q over fp32 "
                             "k and v without RoPE only")
        # exact: q widened to fp32, the output rounded back to q's dtype
        return _flash_cuda(q.float(), k, v, mask, is_causal, scale,
                           rope).to(q.dtype)
    dt = _DT[(q.dtype, k.dtype)]
    check_tensor("q", q, dev, (B, Tq, Hq, D), q.dtype, aligned=True)
    check_tensor("k", k, dev, (B, Tk, Hkv, D), k.dtype, aligned=True)
    check_tensor("v", v, dev, (B, Tk, Hkv, D), k.dtype, aligned=True)
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the kernel "
                         f"(supported: {SUPPORTED_HEAD_DIMS})")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hkv={Hkv} must divide Hq={Hq}")
    if min(B, Tq, Tk) == 0 or max(B, Hq) > 65535:
        raise ValueError(f"unsupported sizes B={B} Tq={Tq} Tk={Tk} Hq={Hq}")
    mask_ptr, mq = None, 0
    if mask is not None:
        if mask.dim() == 4:
            if mask.shape[1] != 1:
                raise ValueError("the kernel takes a (B, Tk), (B, Tq, Tk) "
                                 "or (B, 1, Tq, Tk) mask")
            mask = mask[:, 0]
        # a key mask is read by every row (stride 0), a per-query mask row
        # by row (stride Tk)
        mask = mask.to(torch.int32).contiguous()
        mq = 0 if mask.dim() == 2 else Tk
        check_tensor("mask", mask, dev, (B, Tk) if mq == 0 else (B, Tq, Tk),
                     torch.int32)
        mask_ptr = mask.data_ptr()
    cos_ptr = sin_ptr = None
    if rope is not None:
        if Tq != Tk or D > 128:
            raise ValueError("in-kernel rope takes self-attention with "
                             f"D <= 128 (Tq={Tq}, Tk={Tk}, D={D})")
        cos, sin = rope
        check_tensor("cos", cos, dev, (B, Tk, D // 2), torch.float32,
                     aligned=True)
        check_tensor("sin", sin, dev, (B, Tk, D // 2), torch.float32,
                     aligned=True)
        cos_ptr, sin_ptr = cos.data_ptr(), sin.data_ptr()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        lib = _lib()
        splits = lib.flash_attn_splits(B, Tq, Tk, Hq, Hkv, D,
                                       int(rope is not None), int(mq != 0),
                                       dt)
        if splits == -2:
            raise RuntimeError("CUDA refused the attention kernel's "
                               "shared-memory or occupancy set-up")
        if splits < 1:
            raise ValueError(f"the attention kernel does not take B={B} "
                             f"Tq={Tq} Tk={Tk} Hq={Hq} Hkv={Hkv} D={D} "
                             f"with q {q.dtype}, k {k.dtype}"
                             + (", a per-query mask" if mq else ""))
        # split-KV forms: per-split (acc, m, l) partials, merged in order
        # (by a second launch, or by the decode form's last block; the
        # wide form's cluster merges without a scratch: splits is 1)
        scratch = (torch.empty(splits * B * Tq * Hq * (D + 2), device=dev,
                               dtype=torch.float32)
                   if splits > 1 else None)
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, cos_ptr,
            sin_ptr, out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, Tq, Tk, Hq,
            Hkv, D, int(bool(is_causal)), float(scale), splits, mq, dt,
            torch.cuda.current_stream(dev).cuda_stream)
    count_launch(flash_attention, err)
    return out


class _FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes through the plain version
    (rope included) and returns dq, dk, dv, as the JAX package's
    ``_flash_bwd`` does.  The mask, cos and sin get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, cos, sin, is_causal, scale):
        ctx.save_for_backward(q, k, v, mask, cos, sin)
        ctx.is_causal, ctx.scale = is_causal, scale
        rope = None if cos is None else (cos, sin)
        if uses_kernel(q, "attention kernel"):
            return _flash_cuda(q, k, v, mask, is_causal, scale, rope)
        return flash_attention_plain(q, k, v, mask, is_causal, scale, rope)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, mask, cos, sin = ctx.saved_tensors
        rope = None if cos is None else (cos, sin)
        dq, dk, dv = recompute_backward(
            lambda q_, k_, v_: flash_attention_plain(
                q_, k_, v_, mask, ctx.is_causal, ctx.scale, rope),
            (q, k, v), ctx.needs_input_grad[:3], grad)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    is_causal: bool = False, scale: Optional[float] = None,
                    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, T, H, D) tensors, GQA-native (Hkv
    divides Hq).  ``mask``: (B, Tk) key validity, or a per-query (B, Tq,
    Tk) mask, also given as (B, 1, Tq, Tk) (a speculative window's
    in-window causality over the decode cache); ``is_causal`` adds
    ``tril(k=Tk-Tq)``; ``rope=(cos, sin)``, each (B, T, D/2) fp32, applies
    the rotary embedding to q and k (self-attention only).

    CPU tensors take ``flash_attention_plain``; CUDA tensors launch the
    kernel (fp32 or bf16 as the module docstring says, contiguous, D in
    ``SUPPORTED_HEAD_DIMS``; a per-query mask in fp32 only) or raise.  Both
    are differentiable in q, k and v, through a backward that recomputes
    with the plain version.  ``flash_attention.launches`` counts kernel
    launches.

    A mask with a head axis, (B, H, Tq, Tk) with H > 1, is taken by the
    plain version on the CPU and refused on a CUDA tensor (the kernel has no
    head stride for the mask).  No path of the port passes one."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    cos, sin = rope if rope is not None else (None, None)
    return _FlashAttention.apply(q, k, v, mask, cos, sin, bool(is_causal),
                                 float(scale))


flash_attention.launches = 0
