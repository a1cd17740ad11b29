"""Mixed-precision helpers.

Counterpart of ``tsue_tpu/utils/precision.py``: the bfloat16 configuration
casts every floating parameter to bf16 after init (``runner.py:347-349`` of
the JAX package), and the modules then compute in the dtypes that jnp's
promotion gives (bf16 with bf16 stays bf16, fp32 with bf16 is fp32); the
statistics of the norms, the softmax, the rope and the losses stay fp32.
"""
from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype) if t.is_floating_point() else t


@torch.no_grad()
def cast_params(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                dtype: torch.dtype = torch.bfloat16):
    """Floating tensors to ``dtype``; integer and boolean ones untouched.

    A module has its parameters cast in place (the same ``Parameter``
    objects, holding the new data) and is returned; a state dict gives a
    new dict.  Buffers are left as they are (the rope's inverse
    frequencies stay fp32, as the JAX package computes them)."""
    if isinstance(params, nn.Module):
        for p in params.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)
        return params
    return {k: _cast(v, dtype) for k, v in params.items()}


def promote(*tensors: torch.Tensor) -> torch.dtype:
    """The dtype ``jnp`` promotion gives the tensors' floating dtypes (for
    fp32 and bf16: fp32 if any is fp32)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt
