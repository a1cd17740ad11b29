"""The LoRA product in one kernel: ``y = x W + scale * (x A) B`` without
writing ``xA`` to memory.

Counterpart of ``tsue_tpu/ops/lora.py``.  ``lora_matmul`` launches
``csrc/lora_matmul.cu``; ``lora_ref`` is the plain version.  The Pallas
kernel rounds ``xA`` to x's dtype before the second product
(``lora.py:36``) and the JAX ``lora_ref`` does not; in fp32 the two are the
same function.  ``lora_ref(..., round_xa=True)`` is the kernel's function
(the CPU path and the card's check); the backward recomputes through
``lora_ref`` as the JAX ``custom_vjp`` does.  As in the JAX package nothing
calls the kernel: ``models.llama.LoRADense`` keeps its plain products.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(fp32, or bf16 with fp32 sums) or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tsue_tpu_torch.ops._build import (bind, check_tensor, count_launch,
                                     recompute_backward, uses_kernel)

MAX_RANK = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def lora_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, scale: float,
             round_xa: bool = False) -> torch.Tensor:
    """x (M, K), w (K, N), a (K, r), b (r, N) -> (M, N) in x's dtype, every
    product in fp32; ``round_xa`` rounds ``xA`` to x's dtype before the
    second product, as the kernel does."""
    xf = x.float()
    base = xf @ w.float()
    xa = xf @ a.float()
    if round_xa:
        xa = xa.to(x.dtype).float()
    return (base + scale * (xa @ b.float())).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return bind("lora_matmul", {
        "lora_matmul": [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                        ctypes.c_float, i32, ptr]})


def _lora_cuda(x, w, a, b, scale: float) -> torch.Tensor:
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    dev = x.device
    if x.dtype not in _DTYPES:
        raise TypeError(f"the lora kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    check_tensor("x", x, dev, (M, K), x.dtype)
    check_tensor("w", w, dev, (K, N), x.dtype)
    check_tensor("a", a, dev, (K, r), x.dtype)
    check_tensor("b", b, dev, (r, N), x.dtype)
    if min(M, K, N) == 0 or not 0 < r <= MAX_RANK:
        raise ValueError(f"the lora kernel takes M, K, N > 0 and 0 < r <= "
                         f"{MAX_RANK} (M={M}, K={K}, N={N}, r={r})")
    out = torch.empty(M, N, device=dev, dtype=x.dtype)
    with torch.cuda.device(dev):
        err = _lib().lora_matmul(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), M, K, N, r, float(scale), _DTYPES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    count_launch(lora_matmul, err)
    return out


class _LoRAMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, a, b, scale):
        ctx.save_for_backward(x, w, a, b)
        ctx.scale = scale
        if uses_kernel(x, "lora kernel"):
            return _lora_cuda(x, w, a, b, scale)
        return lora_ref(x, w, a, b, scale, round_xa=True)

    @staticmethod
    def backward(ctx, grad):
        grads = recompute_backward(
            lambda x_, w_, a_, b_: lora_ref(x_, w_, a_, b_, ctx.scale),
            ctx.saved_tensors, ctx.needs_input_grad[:4], grad)
        return (*grads, None)


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float) -> torch.Tensor:
    """x (M, K) @ [w (K, N) + scale * a (K, r) @ b (r, N)] -> (M, N) in x's
    dtype.  ``lora_matmul.launches`` counts kernel launches."""
    return _LoRAMatmul.apply(x, w, a, b, float(scale))


lora_matmul.launches = 0
