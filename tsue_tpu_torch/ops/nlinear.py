"""NLinear in one kernel: subtract the last step, the per-channel Linear
(T_in -> T_out), add the last step back.

Counterpart of ``tsue_tpu/ops/nlinear.py`` (ref scripts/train.py:688-716,
767-782).  ``nlinear_fused`` reads each row's (C, T_in) block once and
writes its (C, T_out) block once (``csrc/nlinear.cu``); ``nlinear_ref`` is
the plain version (one einsum and two elementwise passes).  As in the JAX
package nothing calls the kernel: the model's ``PerChannelLinear`` keeps
the einsum, and the kernel is the op API with its gradient.

A CPU tensor takes ``nlinear_ref``; a CUDA tensor launches the kernel
(fp32) or raises.  The kernel sits in a ``torch.autograd.Function`` whose
backward recomputes through ``nlinear_ref``, as the JAX ``custom_vjp``
does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tsue_tpu_torch.ops._build import (bind, check_tensor, count_launch,
                                     recompute_backward, uses_kernel)


def nlinear_ref(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x (B, C, Ti), w (C, Ti, To), b (C, To) -> (B, C, To): the product in
    fp32, plus the bias and the last step, in x's dtype."""
    last = x[:, :, -1:]
    out = torch.einsum("bct,cto->bco", (x - last).float(), w.float()) + b
    return (out + last).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return bind("nlinear", {
        "nlinear": [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr],
        "nlinear_max_row": []})


def _nlinear_cuda(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    B, C, Ti = x.shape
    To = w.shape[2]
    dev = x.device
    check_tensor("x", x, dev, (B, C, Ti), torch.float32)
    check_tensor("w", w, dev, (C, Ti, To), torch.float32)
    check_tensor("b", b, dev, (C, To), torch.float32)
    lib = _lib()
    if B == 0 or C == 0 or Ti == 0 or To == 0 or C * Ti > lib.nlinear_max_row():
        raise ValueError(f"the nlinear kernel takes B, C, Ti, To > 0 and "
                         f"C * Ti <= {lib.nlinear_max_row()} (B={B}, C={C}, "
                         f"Ti={Ti}, To={To})")
    out = torch.empty(B, C, To, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.nlinear(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                          out.data_ptr(), B, C, Ti, To,
                          torch.cuda.current_stream(dev).cuda_stream)
    count_launch(nlinear_fused, err)
    return out


class _NLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        if uses_kernel(x, "nlinear kernel"):
            return _nlinear_cuda(x, w, b)
        return nlinear_ref(x, w, b)

    @staticmethod
    def backward(ctx, grad):
        return recompute_backward(nlinear_ref, ctx.saved_tensors,
                                  ctx.needs_input_grad, grad)


def nlinear_fused(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """``(x - x[..., -1:]) @ w + b + x[..., -1:]`` per channel: x (B, C,
    Ti), w (C, Ti, To), b (C, To) -> (B, C, To).  ``nlinear_fused.launches``
    counts kernel launches."""
    return _NLinear.apply(x, w, b)


nlinear_fused.launches = 0
