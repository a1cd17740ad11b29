"""Per-sample ADE and FDE in pixels in one kernel: denormalise, squared
error, square root and the reduction over the horizon, without writing an
intermediate.

Counterpart of ``tsue_tpu/ops/metric_kernels.py`` (ref
scripts/train.py:1306-1321).  ``fused_ade_fde`` launches
``csrc/ade_fde.cu``; ``ade_fde_plain`` is its plain version, the same
arithmetic in PyTorch ops.  Both take the difference before the
denormalisation, ``(pred - gt) * (max - min)``, as the Pallas kernel does;
``eval.metrics.ade_fde`` (the reference the JAX tests hold the kernel to)
denormalises each tensor and then subtracts, which differs by rounding.  As
in the JAX package nothing calls the kernel: ``evaluate`` keeps
``eval.metrics``.

A CPU tensor takes ``ade_fde_plain``; a CUDA tensor launches the kernel or
raises.  The JAX kernel has no VJP, so under grad mode with an input that
requires a gradient the kernel path raises (``_build.refuse_grad``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tsue_tpu_torch.ops._build import (bind, check_tensor, count_launch,
                                     refuse_grad, uses_kernel)


def ade_fde_plain(pred: torch.Tensor, gt: torch.Tensor,
                  norm_stat: torch.Tensor) -> torch.Tensor:
    """pred, gt (B, 2, T) normalised, norm_stat (B, 4) [xmin, xmax, ymin,
    ymax] -> (B, 2) fp32 [ade, fde] per sample."""
    st = norm_stat.float()
    rng = torch.stack([st[:, 1] - st[:, 0], st[:, 3] - st[:, 2]], 1)
    d = (pred.float() - gt.float()) * rng[:, :, None]
    dist = torch.sqrt((d * d).sum(dim=1) + 1e-12)               # (B, T)
    return torch.stack([dist.mean(dim=1), dist[:, -1]], 1)


@functools.lru_cache(maxsize=None)
def _lib():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return bind("ade_fde", {"ade_fde": [ptr, ptr, ptr, ptr, i32, i32, ptr]})


def fused_ade_fde(pred: torch.Tensor, gt: torch.Tensor,
                  norm_stat: torch.Tensor) -> torch.Tensor:
    """pred, gt (B, 2, T) normalised, norm_stat (B, 4) [xmin, xmax, ymin,
    ymax] -> (B, 2) fp32 [ade, fde] per sample.  Inputs of another float
    dtype are cast to fp32 first, as the Pallas kernel casts them.
    ``fused_ade_fde.launches`` counts kernel launches."""
    if not uses_kernel(pred, "ade/fde kernel"):
        return ade_fde_plain(pred, gt, norm_stat)
    refuse_grad("fused_ade_fde", pred, gt, norm_stat)
    if pred.dim() != 3 or pred.shape[1] != 2 or 0 in pred.shape:
        raise ValueError(f"the ade/fde kernel takes (B, 2, T) with B, T > 0, "
                         f"got {tuple(pred.shape)}")
    B, _, T = pred.shape
    dev = pred.device
    pred, gt, norm_stat = (t.float().contiguous() for t in
                           (pred, gt, norm_stat))
    check_tensor("pred", pred, dev, (B, 2, T), torch.float32)
    check_tensor("gt", gt, dev, (B, 2, T), torch.float32)
    check_tensor("norm_stat", norm_stat, dev, (B, 4), torch.float32)
    out = torch.empty(B, 2, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = _lib().ade_fde(pred.data_ptr(), gt.data_ptr(),
                             norm_stat.data_ptr(), out.data_ptr(), B, T,
                             torch.cuda.current_stream(dev).cuda_stream)
    count_launch(fused_ade_fde, err)
    return out


fused_ade_fde.launches = 0
