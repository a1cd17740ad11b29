"""Int8 weight-only decode: the Hopper kernel, its plain version and the
int8 tables.

Counterpart of ``tsue_tpu/ops/quant.py``.  The Llama projections and the LM
head are stored per-output-channel symmetric int8 (``w ~ w8 * scale``) and
streamed as int8 during decode; activations keep their dtype (fp32, or
bf16 in a model whose parameters are bf16).  The tables are built from the
port's own parameters (``quantize_llama_params``) and attached to its
modules (``attach_quant``); ``LoRADense`` and
``LlamaForCausalLM.logits_from_hidden`` use them only on decode calls
(``quant_ok=True``), so prefill keeps the full-precision weights.

``int8_matmul`` runs the CUDA kernel ``csrc/int8_matmul.cu`` on CUDA
tensors and its plain version ``int8_matmul_ref`` on CPU tensors, and only
there: a CUDA tensor the kernel cannot take raises.  ``plain_int8`` scopes
the plain version onto CUDA tensors too: the witness that tells the
kernel's rounding from the quantisation error of the weights themselves.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from tsue_tpu_torch.ops._build import (bind, count_launch, refuse_grad,
                                     uses_kernel)

PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
        "down_proj")
MAX_ROWS = 128       # rows a launch takes; more rows go in launches of at
                     # most this many (the JAX path sends them to XLA,
                     # quant.py:226-234)
_PLAIN = contextvars.ContextVar("plain_int8", default=False)


@contextlib.contextmanager
def plain_int8():
    """``with plain_int8(): ...`` sends every ``int8_matmul`` in the block
    to ``int8_matmul_ref``, on a CUDA tensor too (no launch), in this
    context only (a ``contextvars`` scope, as the JAX package's
    ``int8_impl("xla")``)."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def quantize_weight(w: torch.Tensor, axis: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8: ``w ~ w8 * scale`` with one scale per
    output channel (``axis`` is the contraction axis reduced over).
    Returns (w8 int8, scale fp32 of shape w.shape[1 - axis]); rounding is
    half to even, as ``jnp.round``."""
    wf = w.float()
    a = wf.abs().amax(dim=axis, keepdim=True)
    scale = a.clamp_min(1e-8) / 127.0
    w8 = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return w8, scale.reshape(-1)


def int8_matmul_ref(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops (``tsue_tpu/ops/quant.py:87-
    93``): fp32 products of x and the int8 weight (exact for bf16 x), fp32
    sums, the per-column scale, then one rounding to ``out_dtype`` (x's by
    default)."""
    y = (x.float() @ w8.float()) * scale
    return y.to(out_dtype or x.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return bind("int8_matmul", {
        "int8_matmul": [ptr, ptr, ptr, ptr,        # x w8 scale out
                        i32, i32, i32,              # M K N
                        i32, i32, ptr],             # x bf16, out bf16,
                                                    # stream
        "int8_matmul_plan": [i32, i32, i32, i32]})  # M K N field


PLAN_FIELDS = ("cluster", "ctas", "cols_per_cta", "k_rows_per_rank")


def int8_matmul_plan(M: int, K: int, N: int) -> Dict[str, int]:
    """The kernel's launch plan for an (M, K, N) product (builds the
    kernel): the K split across a thread block cluster, the CTAs, the
    columns a CTA and the K rows a cluster rank."""
    lib = _lib()
    return {f: lib.int8_matmul_plan(M, K, N, i)
            for i, f in enumerate(PLAN_FIELDS)}


_FORMS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32)}     # (x, out) dtypes


def _int8_cuda(x2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    M, K = x2.shape
    N = w8.shape[1]
    dev = x2.device
    if (x2.dtype, out_dtype) not in _FORMS or w8.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul takes fp32 x (fp32 out) or bf16 x "
                        f"(bf16 or fp32 out), int8 w8 and fp32 scale, got "
                        f"x {x2.dtype}, out {out_dtype}, {w8.dtype}, "
                        f"{scale.dtype}")
    if w8.device != dev or scale.device != dev:
        raise ValueError("x, w8 and scale must be on one device")
    if w8.shape[0] != K or tuple(scale.shape) != (N,):
        raise ValueError(f"shapes x {tuple(x2.shape)}, w8 {tuple(w8.shape)}, "
                         f"scale {tuple(scale.shape)} do not match")
    if not 0 < M <= MAX_ROWS:
        raise ValueError(f"a launch takes 1..{MAX_ROWS} rows, got {M}")
    if N % 4 or not w8.is_contiguous() or w8.data_ptr() % 16:
        raise ValueError("w8 must be contiguous, 16-byte aligned, with "
                         f"N % 4 == 0 (N={N})")
    x2 = x2.contiguous()
    scale = scale.contiguous()
    if scale.data_ptr() % 16:   # the kernel copies 16-byte chunks of it
        scale = scale.clone()
    out = torch.empty(M, N, device=dev, dtype=out_dtype)
    bf = torch.bfloat16
    with torch.cuda.device(dev):
        err = _lib().int8_matmul(
            x2.data_ptr(), w8.data_ptr(), scale.data_ptr(), out.data_ptr(),
            M, K, N, int(x2.dtype == bf), int(out_dtype == bf),
            torch.cuda.current_stream(dev).cuda_stream)
    count_launch(int8_matmul, err)
    return out


def int8_matmul(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ (w8 * scale)`` with w8 streamed as int8.  x: (..., K) fp32 or
    bf16; w8: (K, N) int8; scale: (N,) fp32.  Returns (..., N) in
    ``out_dtype``, x's by default (fp32 x gives fp32 only).

    CPU tensors, and any tensor under ``plain_int8()``, take
    ``int8_matmul_ref``; otherwise CUDA tensors launch the kernel or raise,
    and raise under grad mode when x or scale requires a gradient (the
    kernel has no backward).  More than ``MAX_ROWS`` rows (a speculative
    window's B * W) go in consecutive launches of at most ``MAX_ROWS``
    rows: the kernel computes each row alone, so a row's bits do not depend
    on the row count.  ``int8_matmul.launches`` counts kernel launches."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not _PLAIN.get() and uses_kernel(x, "int8 kernel"):
        refuse_grad("int8_matmul", x, scale)
        if x2.shape[0] <= MAX_ROWS:
            out = _int8_cuda(x2, w8, scale, out_dtype)
        else:
            out = torch.cat([_int8_cuda(x2[i:i + MAX_ROWS], w8, scale,
                                        out_dtype)
                             for i in range(0, x2.shape[0], MAX_ROWS)])
    else:
        out = int8_matmul_ref(x2, w8, scale, out_dtype)
    return out.reshape(*lead, w8.shape[1])


int8_matmul.launches = 0


@torch.no_grad()
def quantize_llama_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The int8 tables of every Llama inside ``model`` (a TrajectoryModel,
    a MultiModalLLM or a LlamaForCausalLM of the port), as a flat dict keyed
    like the JAX package's ``"quant"`` collection with ``.`` for ``/``:

    - ``<...>.attn.q_proj.w8`` / ``.scale`` for each projection of the
      attention and MLP blocks, from its ``kernel`` (K, N), one scale per
      output column;
    - ``<llama>.lm_head_w8`` (D, V) and ``<llama>.lm_head_scale`` (V,) at
      the LlamaForCausalLM, from the head weight quantised per vocab row:
      the tied embedding (V, D), or the untied head.

    The parameters are quantised as they are, fp32 or bf16, not rounded to
    the compute dtype first (``tsue_tpu/ops/quant.py:247-293``)."""
    from tsue_tpu_torch.models.llama import LlamaForCausalLM, LoRADense
    tables: Dict[str, torch.Tensor] = {}
    for name, mod in model.named_modules():
        parts = name.split(".")
        if isinstance(mod, LoRADense) and parts[-1] in PROJ \
                and len(parts) > 1 and parts[-2] in ("attn", "mlp"):
            w8, s = quantize_weight(mod.kernel, axis=0)
            tables[f"{name}.w8"] = w8
            tables[f"{name}.scale"] = s
        elif isinstance(mod, LlamaForCausalLM):
            w8, s = quantize_weight(mod.head_weight(), axis=1)
            prefix = f"{name}." if name else ""
            tables[f"{prefix}lm_head_w8"] = w8.t().contiguous()
            tables[f"{prefix}lm_head_scale"] = s
    return tables


def attach_quant(model: nn.Module, tables: Dict[str, torch.Tensor]) -> None:
    """Set the tables of ``quantize_llama_params(model)`` on the modules
    they belong to (non-persistent buffers: the state dict is unchanged)."""
    modules = dict(model.named_modules())
    for key, t in tables.items():
        mod_name, _, leaf = key.rpartition(".")
        setattr(modules[mod_name], leaf, t)
