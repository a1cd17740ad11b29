"""Diagnostics: debug printing, parameter counting, non-finite probes.

Counterpart of ``tsue_tpu/utils/debug.py`` (ref modify_scripts/test.py:26-29,
modify_scripts/check.py:1350-1418, the DEBUG prints of
scripts/modify_im_kim_train.py).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn


def debug_print(*args, **kwargs):
    """``print``, flushed at once (the port runs one process)."""
    print(*args, **kwargs, flush=True)


def count_params(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                 trainable_label_fn: Optional[
                     Callable[[Tuple[str, ...]], str]] = None
                 ) -> Dict[str, object]:
    """Total, per-top-level-group and trainable parameter counts of a
    module (its parameters; a module on the ``meta`` device costs no
    memory) or a state dict.  ``trainable_label_fn(path) -> "train" |
    "freeze"`` (e.g. ``train.trainer.freeze_label`` with a regime) takes
    the name split at its dots, the JAX package's path."""
    items = (params.named_parameters() if isinstance(params, nn.Module)
             else params.items())
    out: Dict[str, object] = {"total": 0, "trainable": 0}
    groups: Dict[str, int] = {}
    for name, t in items:
        n = t.numel()
        path = tuple(name.split("."))
        out["total"] += n
        groups[path[0]] = groups.get(path[0], 0) + n
        if trainable_label_fn is None or trainable_label_fn(path) == "train":
            out["trainable"] += n
    out["groups"] = groups
    return out


def nan_probe(x: torch.Tensor, name: str) -> torch.Tensor:
    """Print when ``x`` holds a non-finite value; return ``x`` unchanged.
    It reads one flag back, so it waits for the device where it is
    called, and only there."""
    if not bool(torch.isfinite(x).all()):
        print(f"[nan_probe] {name}: NON-FINITE VALUES", flush=True)
    return x
