"""Module weights on disk, and the stage-1 -> stage-2 handoff.

Counterpart of the handoff in ``tsue_tpu/train/checkpoint.py``
(``export_mllm`` / ``import_mllm``, ``:331-342``).  The JAX package writes
Orbax pytrees, which the port cannot read; the port writes its own format:
a directory holding ``state.pt``, the module's ``state_dict`` as CPU
tensors (``torch.save``; read back with ``weights_only=True``).  Loading
is strict, as the reference's ``strict=True`` load and the JAX package's
``restore_pytree(target=...)`` are: every key present on both sides and
every shape equal, or it raises before anything is copied.  Weights from
the JAX package cross through ``convert.load_flax_params`` instead.
"""
from __future__ import annotations

import os

import torch
from torch import nn

STATE_FILE = "state.pt"


def save_state_dict(module: nn.Module, path: str) -> str:
    """Write ``module.state_dict()`` to ``<path>/state.pt``; returns the
    file's path."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, STATE_FILE)
    state = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    tmp = out + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, out)
    return out


def load_state_dict(module: nn.Module, path: str) -> nn.Module:
    """Fill ``module`` in place from ``save_state_dict``'s directory; every
    key and every shape must match (KeyError, ValueError)."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    own = module.state_dict()
    missing, extra = sorted(set(own) - set(state)), sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"{path}: checkpoint keys differ from the module's: "
                       f"missing {missing}, unexpected {extra}")
    for k, v in state.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, the "
                             f"module's {tuple(own[k].shape)}")
    module.load_state_dict(state, strict=True)
    return module


def _mllm(model: nn.Module) -> nn.Module:
    """The MultiModalLLM of a TrajectoryModel, or the model itself."""
    return getattr(model, "mllm", model)


def export_mllm(model: nn.Module, path: str) -> str:
    """Save the MLLM (stage-1 artifact, ref train.py:1137) of a
    ``MultiModalLLM`` or a ``TrajectoryModel``."""
    return save_state_dict(_mllm(model), path)


def import_mllm(model: nn.Module, path: str) -> nn.Module:
    """Load a stage-1 artifact into the MLLM of ``model`` (a
    ``TrajectoryModel`` or a ``MultiModalLLM``), strictly; returns
    ``model``."""
    load_state_dict(_mllm(model), path)
    return model
