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
(fp32, or bf16 with fp32 sums) or raises.  ``lora_matmul_plan`` names the
kernel's form for a shape: the tensor-core form of the dtype where TMA can
read x and W (16-byte rows and bases) and the rank is 16 or less, the SIMT
form elsewhere (any rank: one more walk over x and A for each further 16
ranks); the wrapper launches that form and no other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tsue_tpu_torch.ops._build import (bind, check_tensor, count_launch,
                                     recompute_backward, uses_kernel)

TC_MAX_RANK = 16      # the tensor-core forms' ranks; the SIMT form any
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the forms' launch shapes: the constants of csrc/lora_matmul.cu (SIMT: BM,
# BN, BK, kThreads; tensor cores: kTM, kTN, Tc<T>::kK and ::kStages,
# kTcThreads)
_FORMS = {
    "simt": dict(tile_m=128, tile_n=128, k_step=8, stages=2, threads=256),
    "wgmma_bf16": dict(tile_m=128, tile_n=256, k_step=64, stages=4,
                       threads=384),
    "tf32x3": dict(tile_m=128, tile_n=256, k_step=32, stages=2,
                   threads=384),
}


def _form(M: int, K: int, N: int, r: int, dtype: torch.dtype,
          aligned: bool) -> str:
    if dtype not in _DTYPES:
        raise TypeError(f"the lora kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    if min(M, K, N, r) <= 0:
        raise ValueError(f"the lora kernel takes M, K, N, r > 0 (M={M}, "
                         f"K={K}, N={N}, r={r})")
    per_16_bytes = 4 if dtype == torch.float32 else 8
    if (aligned and K % per_16_bytes == 0 and N % per_16_bytes == 0
            and r <= TC_MAX_RANK):
        return "tf32x3" if dtype == torch.float32 else "wgmma_bf16"
    return "simt"


def lora_matmul_plan(M: int, K: int, N: int, r: int, dtype: torch.dtype,
                     aligned: bool = True) -> dict:
    """The kernel's launch for an (M, K) x (K, N) product of rank r in
    ``dtype``: its form, output tile, K positions a step, ring stages,
    threads, output tiles and CTAs.  The tensor-core form of the dtype
    ("wgmma_bf16", "tf32x3") takes rows of x and W that are multiples of 16
    bytes and, with ``aligned``, 16-byte aligned bases (TMA's terms), at
    rank 16 or less; every other shape and every rank above 16 takes the
    "simt" form, one CTA a tile.  A tensor-core form
    runs a persistent grid, each CTA walking its tiles: as many CTAs as the
    card holds at once (asked of the CUDA device, which builds the kernel;
    without one, one a tile) or one a tile where there are fewer."""
    form = _form(M, K, N, r, dtype, aligned)
    plan = dict(form=form, **_FORMS[form])
    plan["tiles"] = -(-M // plan["tile_m"]) * -(-N // plan["tile_n"])
    held = plan["tiles"]
    if form != "simt" and torch.cuda.is_available():
        held = _lib().lora_matmul_ctas(_DTYPES[dtype])
        if held < 1:
            raise RuntimeError("the lora kernel does not fit on the card")
    plan["ctas"] = min(plan["tiles"], held)
    return plan


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
                        ctypes.c_float, i32, i32, ptr],
        "lora_matmul_ctas": [i32]})


def _lora_cuda(x, w, a, b, scale: float) -> torch.Tensor:
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    dev = x.device
    form = _form(M, K, N, r, x.dtype, aligned=x.data_ptr() % 16 == 0
                 and w.data_ptr() % 16 == 0)
    check_tensor("x", x, dev, (M, K), x.dtype)
    check_tensor("w", w, dev, (K, N), x.dtype)
    check_tensor("a", a, dev, (K, r), x.dtype)
    check_tensor("b", b, dev, (r, N), x.dtype)
    out = torch.empty(M, N, device=dev, dtype=x.dtype)
    with torch.cuda.device(dev):
        err = _lib().lora_matmul(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), M, K, N, r, float(scale), _DTYPES[x.dtype],
            int(form != "simt"),     # the C side's form code
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
