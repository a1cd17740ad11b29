"""The Llama block's fused kernels: one-pass RMSNorm and the SwiGLU
down-projection, each with its plain PyTorch version.

Counterpart of ``tsue_tpu/ops/fused.py``.  ``fused_rmsnorm`` reads each row
once and writes it once (``csrc/rmsnorm.cu``); ``swiglu_matmul`` computes
``(silu(gate) * up) @ W`` without writing the activation product to memory
(``csrc/swiglu_matmul.cu``).  Both are opt-in, as in the JAX package: the
``TSUE_FUSED`` switch (``auto`` | ``on`` | ``off``, ``auto`` = off) routes
``models.llama.RMSNorm`` and the MLP's ``down_proj`` to them.  The JAX
package reads the switch when it traces a program, so a jitted callable
keeps the value it was built with; the port runs eagerly and reads it on
every call, so ``fused_scope`` takes effect at once.

Dispatch is the JAX package's: a shape the kernel would tile badly takes
the plain version on any device (RMSNorm: ``K % 128`` or ``M < 128``, which
keeps decode steps plain; SwiGLU: also ``N % 128``).  Otherwise a CPU tensor
takes the plain version and a CUDA tensor launches the kernel or raises.
Each kernel sits in a ``torch.autograd.Function`` whose backward recomputes
through the plain version, as the JAX package's ``custom_vjp``s recompute
through XLA; it computes only the gradients autograd asks for.

Dtypes, as the Pallas kernels take them: RMSNorm takes fp32 or bf16 x and
scale, sums in fp32 and returns x's dtype (one multi-row stream, the form
"fp32_stream" or "bf16_stream" by x's dtype, ``rmsnorm_plan``); the SwiGLU
product takes fp32 or bf16 operands, all alike: silu in fp32 rounded to
up's dtype, times up in that dtype, the product with W summed in fp32 and
returned in gate's dtype, bf16 in a form of its own.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from tsue_tpu_torch.ops._build import (bind, check_tensor, count_launch,
                                     recompute_backward, uses_kernel)

_MODES = ("auto", "on", "off")
_FUSED = os.environ.get("TSUE_FUSED", "auto")


def set_fused(name: str) -> None:
    if name not in _MODES:
        raise ValueError(f"TSUE_FUSED must be one of {_MODES}, got {name!r}")
    global _FUSED
    _FUSED = name


def fused_enabled() -> bool:
    """True when the switch is ``on``; ``auto`` is off, as in the JAX
    package (its A/B measured the fusions as a wash on the TPU)."""
    return _FUSED == "on"


class fused_scope:
    """Scoped override of the switch: ``with fused_scope("on"): ...``."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.prev = _FUSED
        set_fused(self.name)
        return self

    def __exit__(self, *exc):
        set_fused(self.prev)
        return False


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1] if x.shape[-1] else 0


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

_FLOATS = (torch.float32, torch.bfloat16)


def _bf16_code(name: str, t: torch.Tensor) -> int:
    """The C side's dtype code of ``t``: 0 fp32, 1 bf16."""
    if t.dtype not in _FLOATS:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    return int(t.dtype == torch.bfloat16)


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """fp32 mean of squares, rsqrt, scale (promoted to fp32), cast back to
    x's dtype (``rmsnorm_ref``)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rmsnorm_lib():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return bind("rmsnorm", {
        "rmsnorm": [ptr, ptr, ptr, i32, i32, ctypes.c_float, i32, i32, ptr],
        "rmsnorm_plan": [i32, i32, i32, i32, ctypes.POINTER(i32)],
        "rmsnorm_max_k": []})


# the C side's forms (rmsnorm_plan)
_RMSNORM_FORMS = ("fp32_stream", "bf16_stream")


def rmsnorm_plan(M: int, K: int, x_dtype: torch.dtype,
                 scale_dtype: torch.dtype) -> dict:
    """The kernel's launch for (M, K) rows of ``x_dtype`` and a (K,) scale
    of ``scale_dtype``, as the CUDA library plans it (it builds the
    library): ``form`` "fp32_stream" or "bf16_stream" by x's dtype, one
    kernel: a persistent grid of ``ctas`` CTAs of 8 warps strides over the
    rows, ``warps_per_row`` warps own a row and each lane holds
    ``vectors_per_lane`` 16-byte vectors of it (4 fp32 or 8 bf16
    elements), both chosen by the row's count of vectors: up to 128 one
    warp and 1, 2 or 4 vectors, then 2, 4 and 8 warps of 4 vectors up to
    1024, and 8 warps of 8 vectors at 2048 (fp32 at K = 8192).  Raises for
    a call the kernel does not take (K % 4, bf16 x K % 8, K above
    ``rmsnorm_max_k()``)."""
    xb = _bf16_code("x", torch.empty(0, dtype=x_dtype))
    sb = _bf16_code("scale", torch.empty(0, dtype=scale_dtype))
    plan = (ctypes.c_int * 4)()
    err = _rmsnorm_lib().rmsnorm_plan(M, K, xb, sb, plan)
    if err:
        raise ValueError(f"the rmsnorm kernel does not take M={M} K={K} of "
                         f"{x_dtype} with a {scale_dtype} scale (code {err})")
    return dict(form=_RMSNORM_FORMS[plan[0]], warps_per_row=plan[1],
                vectors_per_lane=plan[2], ctas=plan[3])


def _rmsnorm_cuda(x2: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    M, K = x2.shape
    dev = x2.device
    xb, sb = _bf16_code("x", x2), _bf16_code("scale", scale)
    check_tensor("x", x2, dev, (M, K), x2.dtype, aligned=True)
    check_tensor("scale", scale, dev, (K,), scale.dtype, aligned=True)
    lib = _rmsnorm_lib()
    vec = 8 if xb else 4      # bf16 rows load 8 elements (16 bytes) a step
    if M == 0 or K % vec or K > lib.rmsnorm_max_k():
        raise ValueError(f"the rmsnorm kernel takes M > 0 rows of K % {vec} "
                         f"== 0, K <= {lib.rmsnorm_max_k()} (M={M}, K={K})")
    out = torch.empty_like(x2)
    with torch.cuda.device(dev):
        err = lib.rmsnorm(x2.data_ptr(), scale.data_ptr(), out.data_ptr(), M,
                          K, float(eps), xb, sb,
                          torch.cuda.current_stream(dev).cuda_stream)
    count_launch(fused_rmsnorm, err)
    return out


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, scale, eps):
        ctx.save_for_backward(x2, scale)
        ctx.eps = eps
        if uses_kernel(x2, "rmsnorm kernel"):
            return _rmsnorm_cuda(x2, scale, eps)
        return rmsnorm_plain(x2, scale, eps)

    @staticmethod
    def backward(ctx, grad):
        x2, scale = ctx.saved_tensors
        dx, ds = recompute_backward(
            lambda x_, s_: rmsnorm_plain(x_, s_, ctx.eps), (x2, scale),
            ctx.needs_input_grad[:2], grad)
        return dx, ds, None


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """One-pass RMSNorm over the last axis of x (..., K) with scale (K,).
    ``K % 128 != 0`` or fewer than 128 rows take ``rmsnorm_plain``; else
    CPU tensors take it too and CUDA tensors launch the kernel (fp32 or bf16
    x and scale) or raise.  ``fused_rmsnorm.launches`` counts kernel
    launches."""
    K = x.shape[-1]
    M = _rows(x)
    if K % 128 != 0 or M < 128:
        return rmsnorm_plain(x, scale, eps)
    return _RMSNorm.apply(x.reshape(M, K), scale, float(eps)).reshape(x.shape)


fused_rmsnorm.launches = 0


# --------------------------------------------------------------------------
# (silu(gate) * up) @ W
# --------------------------------------------------------------------------

def swiglu_matmul_plain(gate: torch.Tensor, up: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """The activation product, then the product with W: silu in fp32
    rounded to up's dtype, times up, the product summed in fp32 (the
    ``_swiglu_kernel`` function; the unfused MLP's own ops in fp32)."""
    return ((F.silu(gate.float()).to(up.dtype) * up) @ w).to(gate.dtype)


# the kernel's launches: the constants of csrc/swiglu_matmul.cu (fp32: kTM,
# kTN, kK, kStages, kThreads; bf16: kTM, kTN, kBK, kGStages, kWStages,
# kThreads)
_SWIGLU_FORMS = {
    torch.float32: dict(form="tf32x3", tile_m=128, tile_n=256, k_step=32,
                        stages=2, threads=384),
    torch.bfloat16: dict(form="bf16_wgmma", tile_m=128, tile_n=256,
                         k_step=64, stages=3, w_stages=4, threads=384),
}


@functools.lru_cache(maxsize=None)
def _swiglu_lib():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return bind("swiglu_matmul", {
        "swiglu_matmul": [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr],
        "swiglu_matmul_bf16": [ptr, ptr, ptr, ptr, i32, i32, i32, ptr],
        "swiglu_matmul_ctas": [], "swiglu_matmul_bf16_ctas": []})


def swiglu_matmul_plan(M: int, K: int, N: int,
                       dtype: torch.dtype = torch.float32) -> dict:
    """The kernel's launch for (M, K) activations and a (K, N) weight in
    ``dtype``: its form, output tile, K positions a step, ring stages,
    threads, output tiles and CTAs.  Each dtype has one form, a persistent
    grid of 384-thread CTAs (a TMA producer, two consumer warpgroups on
    ``wgmma``): fp32 "tf32x3" (3xTF32), bf16 "bf16_wgmma" (bf16 products
    with fp32 sums, W read as it lies; ``stages`` of g and u and
    ``w_stages`` of W in two rings).  Each takes M, N > 0, K > 0 with K
    % 128 == 0 and N % 8 == 0 (fp32: N % 4); any other shape or dtype
    raises.  Each CTA walks its tiles: as many CTAs as the card holds at
    once (asked of the CUDA device, which builds the kernel; without one,
    one a tile) or one a tile where there are fewer."""
    if dtype not in _SWIGLU_FORMS:
        raise TypeError(f"the swiglu kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    n_align = 4 if dtype == torch.float32 else 8
    if min(M, K, N) <= 0 or K % 128 or N % n_align:
        raise ValueError(f"the swiglu kernel takes M > 0, K % 128 == 0 and "
                         f"N % {n_align} == 0 (M={M}, K={K}, N={N})")
    plan = dict(_SWIGLU_FORMS[dtype])
    plan["tiles"] = -(-M // plan["tile_m"]) * -(-N // plan["tile_n"])
    held = plan["tiles"]
    if torch.cuda.is_available():
        lib = _swiglu_lib()
        held = (lib.swiglu_matmul_ctas() if dtype == torch.float32
                else lib.swiglu_matmul_bf16_ctas())
        if held < 1:
            raise RuntimeError("the swiglu kernel does not fit on the card")
    plan["ctas"] = min(plan["tiles"], held)
    return plan


def _swiglu_cuda(g: torch.Tensor, u: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    M, K = g.shape
    N = w.shape[1]
    dev = g.device
    _bf16_code("gate", g)
    check_tensor("gate", g, dev, (M, K), g.dtype, aligned=True)
    check_tensor("up", u, dev, (M, K), g.dtype, aligned=True)
    check_tensor("w", w, dev, (K, N), g.dtype, aligned=True)
    swiglu_matmul_plan(M, K, N, g.dtype)  # raises for what it does not take
    if g.dtype == torch.bfloat16:
        out = torch.empty(M, N, device=dev, dtype=g.dtype)
        with torch.cuda.device(dev):
            err = _swiglu_lib().swiglu_matmul_bf16(
                g.data_ptr(), u.data_ptr(), w.data_ptr(), out.data_ptr(), M,
                K, N, torch.cuda.current_stream(dev).cuda_stream)
        count_launch(swiglu_matmul, err)
        return out
    # W^T's tf32 halves, written by the kernel's pre-pass
    wt = torch.empty(2, N, K, device=dev, dtype=torch.float32)
    out = torch.empty(M, N, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = _swiglu_lib().swiglu_matmul(
            g.data_ptr(), u.data_ptr(), w.data_ptr(), wt.data_ptr(),
            out.data_ptr(), M, K, N,
            torch.cuda.current_stream(dev).cuda_stream)
    count_launch(swiglu_matmul, err)
    return out


class _SwiGLUMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, u, w):
        ctx.save_for_backward(g, u, w)
        if uses_kernel(g, "swiglu kernel"):
            return _swiglu_cuda(g, u, w)
        return swiglu_matmul_plain(g, u, w)

    @staticmethod
    def backward(ctx, grad):
        return recompute_backward(swiglu_matmul_plain, ctx.saved_tensors,
                                  ctx.needs_input_grad, grad)


def swiglu_matmul(gate: torch.Tensor, up: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """``(silu(gate) * up) @ w`` for gate/up (..., K) and w (K, N).
    ``K % 128``, ``N % 128`` or fewer than 128 rows take
    ``swiglu_matmul_plain``; else CPU tensors take it too and CUDA tensors
    launch the kernel (fp32 or bf16, all three alike) or raise.  ``swiglu_matmul.launches`` counts
    kernel launches."""
    K = gate.shape[-1]
    N = w.shape[1]
    lead = gate.shape[:-1]
    M = _rows(gate)
    if K % 128 != 0 or N % 128 != 0 or M < 128:
        return swiglu_matmul_plain(gate, up, w)
    out = _SwiGLUMatmul.apply(gate.reshape(M, K), up.reshape(M, K), w)
    return out.reshape(*lead, N)


swiglu_matmul.launches = 0
