"""Int8 KV cache: quantisation, cache writes and decode attention over it.

Counterpart of ``tsue_tpu/ops/kv_quant.py``.  The decode cache is stored
per-token, per-head symmetric int8 (``k ~ k8 * ks``).  Prefill stays exact:
the prefix is prefilled into an fp32 (or, for a bf16 model, bf16) cache
and ``quantize_cache`` converts it once before the decode loop; every
decode write quantises the new rows on the way in (``update_kv_int8``).
A cache layer is the 4-tuple ``(k8, ks, v8, vs)``; the port writes it in
place where the JAX package returns a new one.

``attend_int8_kv`` runs the CUDA kernel ``csrc/attend_int8_kv.cu`` on CUDA
tensors and its plain version ``attend_int8_kv_plain`` on CPU tensors, and
only there: a CUDA tensor the kernel cannot take raises.  Both compute the
fp32 softmax(QK^T)V of the Pallas kernel ``_attend_kernel`` (q widened to
fp32, masked logits -1e30, ``p / max(s, 1e-30)``, the output in q's
dtype).  The JAX package's default is instead its XLA formulation, the
cache dequantised to q's dtype (``tsue_tpu/ops/kv_quant.py:301-306``); the
port computes the kernel's function on every device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from tsue_tpu_torch.ops._build import (bind, check_tensor, count_launch,
                                     refuse_grad, uses_kernel)

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)

LayerCache = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., Dh) -> (int8 (..., Dh), fp32 scale (...,)): symmetric per
    vector (per token, per head)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    x8 = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return x8, scale


def dequantize_kv(x8: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (x8.float() * scale[..., None]).to(dtype)


def quantize_cache(caches: List[Tuple[torch.Tensor, torch.Tensor]]
                   ) -> List[LayerCache]:
    """Per-layer fp32 or bf16 (k, v) -> per-layer (k8, ks, v8, vs), once
    after prefill (the values quantised as they are)."""
    out = []
    for k, v in caches:
        k8, ks = quantize_kv(k)
        v8, vs = quantize_kv(v)
        out.append((k8, ks, v8, vs))
    return out


def write_rows(cache: torch.Tensor, rows: torch.Tensor, cache_index
               ) -> None:
    """Write ``rows`` (B, T, ...) into ``cache`` (B, S, ...) in place from
    slot ``cache_index``: an int (every row at the same slots) or a (B,)
    tensor (row b from its own slot, one ``index_put_``)."""
    T = rows.shape[1]
    if isinstance(cache_index, torch.Tensor):
        B = rows.shape[0]
        b = torch.arange(B, device=cache.device)[:, None]
        cols = cache_index.to(cache.device, torch.long)[:, None] + \
            torch.arange(T, device=cache.device)[None, :]
        cache.index_put_((b, cols), rows.to(cache.dtype))
    else:
        cache[:, cache_index:cache_index + T] = rows


def update_kv_int8(layer_cache: LayerCache, k: torch.Tensor, v: torch.Tensor,
                   cache_index) -> LayerCache:
    """Quantise new (B, T, Hkv, Dh) rows and write them in place at
    ``cache_index``, an int or (B,) per-row slots (``write_rows``); returns
    the layer cache."""
    k8n, ksn = quantize_kv(k)
    v8n, vsn = quantize_kv(v)
    for cache, rows in zip(layer_cache, (k8n, ksn, v8n, vsn)):
        write_rows(cache, rows, cache_index)
    return layer_cache


def mask3(mask: Optional[torch.Tensor], B: int, Tq: int, S: int
          ) -> Optional[torch.Tensor]:
    """The decode masks as the kernel reads them (``_mask3`` of
    ``tsue_tpu/ops/kv_quant.py:255-264``): None, a (B, S) key mask kept as
    it is (every query step reads it), or a per-query (B, Tq, S) mask, also
    from (B, 1|H, Tq, S), read as ``mask[:, 0]``."""
    if mask is None or mask.dim() == 2:
        return mask
    if mask.dim() == 4:
        mask = mask[:, 0]
    if mask.dim() != 3:
        raise ValueError(f"a decode mask is (B, S), (B, Tq, S) or (B, 1|H, "
                         f"Tq, S), got shape {tuple(mask.shape)}")
    return mask.expand(B, Tq, S)


def attend_int8_kv_plain(q: torch.Tensor, layer_cache: LayerCache,
                         mask: Optional[torch.Tensor],
                         scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops: fp32 throughout, q widened,
    the output rounded once to q's dtype."""
    k8, ks, v8, vs = layer_cache
    B, Tq, Hq, D = q.shape
    S, Hkv = k8.shape[1], k8.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    k = dequantize_kv(k8, ks)
    v = dequantize_kv(v8, vs)
    qg = q.float().reshape(B, Tq, Hkv, G, D)
    logits = torch.einsum("bthgd,bshd->bhgts", qg, k) * scale
    mask = mask3(mask, B, Tq, S)
    if mask is not None:
        valid = mask.bool()
        valid = (valid[:, None, None, None, :] if valid.dim() == 2
                 else valid[:, None, None])
        logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgts,bshd->bthgd", p, v)
    return out.reshape(B, Tq, Hq, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return bind("attend_int8_kv", {
        "attend_int8_kv": [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # q k8 ks v8 vs mask out
            i32, i32, i32, i32, i32, i32,       # B Tq S Hq Hkv D
            i32, ctypes.c_float, i32, ptr],     # mask query stride, scale,
                                                # q bf16, stream
        "attend_int8_kv_plan": [i32, i32, i32, i32],   # S G D field
        "attend_int8_kv_max_groups": []})


PLAN_FIELDS = ("splits", "keys_per_split", "smem_bytes")


def attend_int8_kv_plan(S: int, G: int, D: int) -> Optional[dict]:
    """The kernel's launch plan for S cache slots, G query heads a KV head
    and head dim D (builds the kernel): the key splits (one thread block
    cluster of that many CTAs per (row, query step, KV head)), the keys a
    split and the shared memory a CTA asks for; None when a split's keys do
    not fit the shared memory."""
    lib = _lib()
    plan = {f: lib.attend_int8_kv_plan(S, G, D, i)
            for i, f in enumerate(PLAN_FIELDS)}
    return None if plan["splits"] < 1 else plan


def _attend_cuda(q, layer_cache, mask, scale) -> torch.Tensor:
    k8, ks, v8, vs = layer_cache
    if q.dim() != 4 or k8.dim() != 4:
        raise ValueError("q must be (B, Tq, Hq, D) and k8/v8 (B, S, Hkv, D)")
    B, Tq, Hq, D = q.shape
    S, Hkv = k8.shape[1], k8.shape[2]
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be fp32 or bf16, got {q.dtype}")
    check_tensor("q", q, dev, (B, Tq, Hq, D), q.dtype)
    check_tensor("k8", k8, dev, (B, S, Hkv, D), torch.int8, aligned=True)
    check_tensor("v8", v8, dev, (B, S, Hkv, D), torch.int8, aligned=True)
    check_tensor("ks", ks, dev, (B, S, Hkv), torch.float32)
    check_tensor("vs", vs, dev, (B, S, Hkv), torch.float32)
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the kernel "
                         f"(supported: {SUPPORTED_HEAD_DIMS})")
    lib = _lib()
    if Hkv == 0 or Hq % Hkv or Hq // Hkv > lib.attend_int8_kv_max_groups():
        raise ValueError(f"Hkv={Hkv} must divide Hq={Hq} in at most "
                         f"{lib.attend_int8_kv_max_groups()} groups")
    if min(B, Tq, S) == 0 or B * Tq > 65535:
        raise ValueError(f"unsupported sizes B={B} Tq={Tq} S={S}")
    if attend_int8_kv_plan(S, Hq // Hkv, D) is None:
        raise ValueError(f"cache length S={S} too long for the kernel's "
                         "shared memory")
    mask_ptr, mq = None, 0
    mask = mask3(mask, B, Tq, S)
    if mask is not None:
        # a key mask is read by every query step (stride 0), a per-query
        # mask row by row (stride S)
        mask = mask.to(torch.int32).contiguous()
        mq = 0 if mask.dim() == 2 else S
        check_tensor("mask", mask, dev, (B, S) if mq == 0 else (B, Tq, S),
                     torch.int32)
        mask_ptr = mask.data_ptr()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = lib.attend_int8_kv(
            q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
            vs.data_ptr(), mask_ptr, out.data_ptr(), B, Tq, S, Hq, Hkv, D,
            mq, float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    count_launch(attend_int8_kv, err)
    return out


def attend_int8_kv(q: torch.Tensor, layer_cache: LayerCache,
                   mask: Optional[torch.Tensor],
                   scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over an int8 layer cache.

    q: (B, Tq, Hq, Dh) roped queries (Tq = 1, or a speculative window);
    layer_cache: (k8, ks, v8, vs) with k8/v8 (B, S, Hkv, Dh) and ks/vs (B,
    S, Hkv); mask: None, (B, S) key validity (every query step), or a
    per-query (B, Tq, S) mask, also given as (B, 1|H, Tq, S) and read as
    ``mask[:, 0]`` (``mask3``).  q is fp32 or bf16; returns (B, Tq, Hq, Dh)
    in q's dtype.  CPU tensors take ``attend_int8_kv_plain``; CUDA tensors
    launch the kernel or raise (also under grad mode when an input requires
    a gradient: the kernel has no backward).  ``attend_int8_kv.launches``
    counts kernel launches."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not uses_kernel(q, "int8 attention kernel"):
        return attend_int8_kv_plain(q, layer_cache, mask, scale)
    refuse_grad("attend_int8_kv", q, *layer_cache)
    return _attend_cuda(q, layer_cache, mask, scale)


attend_int8_kv.launches = 0
