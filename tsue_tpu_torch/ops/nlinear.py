"""NLinear in one kernel: subtract the last step, the per-channel Linear
(T_in -> T_out), add the last step back.

Counterpart of ``tsue_tpu/ops/nlinear.py`` (ref scripts/train.py:688-716,
767-782).  ``nlinear_fused`` reads each input once and writes its (B, C,
T_out) output once (``csrc/nlinear.cu``); ``nlinear_ref`` is the plain
version (one einsum and two elementwise passes).  As in the JAX package
nothing calls the kernel: the model's ``PerChannelLinear`` keeps the
einsum, and the kernel is the op API with its gradient.

A CPU tensor takes ``nlinear_ref``; a CUDA tensor launches the kernel
(fp32) or raises.  ``nlinear_plan`` names the kernel's launch for a shape:
cg channels and bb rows a CTA, and the copy form that stages them in
shared memory (Hopper's bulk copies where their 16-byte terms hold, 4-byte
``cp.async`` copies elsewhere); the wrapper launches that plan and no
other.  The kernel sits in a ``torch.autograd.Function`` whose backward
recomputes through ``nlinear_ref``, as the JAX ``custom_vjp`` does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tsue_tpu_torch.ops._build import (bind, check_tensor, count_launch,
                                     recompute_backward, uses_kernel)

_FORMS = {"bulk": 0, "cp4": 1}   # the C side's form codes
ROWS_PER_CTA = 4                 # bb, where shared memory allows
MAX_THREADS = 256
MAX_SMEM = 232448                # the dynamic shared memory a CTA may ask
MAX_ROW_BLOCKS = 65535           # the grid's second dimension
_BAR_BYTES = 16                  # the mbarrier, padded to 16 bytes


def nlinear_ref(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x (B, C, Ti), w (C, Ti, To), b (C, To) -> (B, C, To): the product in
    fp32, plus the bias and the last step, in x's dtype."""
    last = x[:, :, -1:]
    out = torch.einsum("bct,cto->bco", (x - last).float(), w.float()) + b
    return (out + last).to(x.dtype)


def _smem(Ti: int, To: int, cg: int, bb: int) -> int:
    """A CTA's shared bytes: its mbarrier, w's and bias's slices of cg
    channels, and bb rows of x's (cg, Ti) slices (``nlinear_smem`` in
    ``csrc/nlinear.cu``)."""
    return _BAR_BYTES + 4 * cg * (Ti * To + To + bb * Ti)


def _bulk_cg(C: int, Ti: int, To: int) -> int | None:
    """The channels a CTA takes in the bulk form, or None where no group
    size gives every copy 16-byte offsets and sizes."""
    return next((g for g in (2, 4, 1) if C % g == 0 and g * Ti % 4 == 0
                 and g * To % 4 == 0), None)


def nlinear_plan(B: int, C: int, Ti: int, To: int,
                 aligned: bool = True) -> dict:
    """The kernel's launch for x (B, C, Ti) and w (C, Ti, To): its copy
    form, cg channels and bb rows a CTA, threads a CTA, CTAs (a grid of
    (C / cg, B / bb), rounded up) and shared bytes a CTA.  The "bulk" form
    (one thread's ``cp.async.bulk`` copies on one mbarrier) takes shapes
    whose copies are all 16-byte aligned multiples of 16 bytes: C % cg ==
    0, cg * Ti and cg * To multiples of 4, and, with ``aligned``, x, w and
    bias at 16-byte aligned addresses; every other shape takes the "cp4"
    form (4-byte ``cp.async`` copies, two channels a CTA).  Where one row
    of cg channels does not fit in a CTA's shared memory, cg is 1; bb is 4
    rows, fewer where shared memory asks it.  A shape whose one channel
    and one row do not fit raises, as do more than 65535 blocks of rows.
    The plan depends on the shape alone, not on the card."""
    if min(B, C, Ti, To) <= 0:
        raise ValueError(f"the nlinear kernel takes B, C, Ti, To > 0 (B={B}"
                         f", C={C}, Ti={Ti}, To={To})")
    cg = _bulk_cg(C, Ti, To) if aligned else None
    form = "cp4" if cg is None else "bulk"
    cg = cg or min(2, C)
    if _smem(Ti, To, cg, 1) > MAX_SMEM and cg > 1:
        cg = 1
        if Ti % 4 or To % 4:       # one channel's copies off 16 bytes
            form = "cp4"
    bb = min(B, ROWS_PER_CTA)
    while _smem(Ti, To, cg, bb) > MAX_SMEM and bb > 1:
        bb = (bb + 1) // 2
    smem = _smem(Ti, To, cg, bb)
    row_blocks = -(-B // bb)
    if smem > MAX_SMEM or row_blocks > MAX_ROW_BLOCKS:
        raise ValueError(
            f"the nlinear kernel takes one channel's (Ti, To) weight, its "
            f"bias and one row of x within {MAX_SMEM} bytes of shared "
            f"memory, and B <= {MAX_ROW_BLOCKS * bb} (B={B}, C={C}, Ti={Ti},"
            f" To={To})")
    threads = min(MAX_THREADS, -(-bb * cg * To // 32) * 32)
    return dict(form=form, cg=cg, bb=bb, threads=threads,
                ctas=-(-C // cg) * row_blocks, smem_bytes=smem)


@functools.lru_cache(maxsize=None)
def _lib():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return bind("nlinear", {
        "nlinear": [ptr, ptr, ptr, ptr] + [i32] * 8 + [ptr]})


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            out: torch.Tensor, plan: dict) -> int:
    """One launch of the kernel in ``plan``'s form and layout; returns the
    C entry's CUDA error code."""
    B, C, Ti = x.shape
    with torch.cuda.device(x.device):
        return _lib().nlinear(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, C,
            Ti, w.shape[2], _FORMS[plan["form"]], plan["cg"], plan["bb"],
            plan["threads"], torch.cuda.current_stream(x.device).cuda_stream)


def _nlinear_cuda(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    B, C, Ti = x.shape
    To = w.shape[2]
    dev = x.device
    check_tensor("x", x, dev, (B, C, Ti), torch.float32)
    check_tensor("w", w, dev, (C, Ti, To), torch.float32)
    check_tensor("b", b, dev, (C, To), torch.float32)
    plan = nlinear_plan(B, C, Ti, To, aligned=all(
        t.data_ptr() % 16 == 0 for t in (x, w, b)))
    out = torch.empty(B, C, To, device=dev, dtype=torch.float32)
    count_launch(nlinear_fused, _launch(x, w, b, out, plan))
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
