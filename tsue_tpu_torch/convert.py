"""Weight bridge: the JAX package's Flax parameter tree -> the port's modules.

``load_flax_params(model, tree)`` takes the tree as nested dicts of numpy
arrays (``jax.device_get`` of ``variables["params"]``) and fills the port's
module in place.  The port names its submodules after the Flax paths, so the
walk is mechanical: the leaf ``a/b/c/kernel`` goes to module ``a.b.c``, and
the module's type says how the leaf maps:

- ``nn.Linear``: ``kernel`` (in-dims..., out-dims...) -> ``weight`` (out,
  in), so a DenseGeneral q/k/v kernel (D, H, Dh) and an o kernel (H, Dh, D)
  flatten to (in, out) and transpose; ``bias`` flattens to (out,);
- ``nn.LayerNorm``: ``scale`` -> ``weight``, ``bias`` -> ``bias``;
- ``nn.Embedding``: ``embedding`` -> ``weight``;
- ``nn.Conv1d``: ``kernel`` (k, in, out) -> ``weight`` (out, in, k),
  ``bias`` -> ``bias``;
- the port's Flax ``BatchNorm`` (``models.baselines.stgcnn``): ``scale``
  -> ``weight``, ``bias`` -> ``bias``;
- any other module holds Flax-layout parameters under the Flax names.

``load_flax_batch_stats(model, tree)`` carries the ``"batch_stats"``
collection the same way: ``mean`` and ``var`` go to the BatchNorm's
``running_mean`` and ``running_var`` buffers.

Both are strict: every Flax leaf is consumed exactly once, every port
parameter (every BatchNorm statistic) is filled, and every shape must
match.  Neither imports jax.

Only parameters and batch statistics cross the bridge.  The int8 decode tables (the JAX
package's ``"quant"`` collection) are not carried: the port builds them
from its own fp32 parameters (``ops.quant.quantize_llama_params``), and
``tests/test_torch_quant.py`` holds them equal to the JAX package's.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from tsue_tpu_torch.models.baselines.stgcnn import BatchNorm


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def _linear_kernel(mod: nn.Linear, kernel: np.ndarray, path: str
                   ) -> np.ndarray:
    """(in-dims..., out-dims...) -> (out, in), if some split of the dims
    gives exactly (in_features, out_features)."""
    for i in range(1, kernel.ndim):
        if (math.prod(kernel.shape[:i]) == mod.in_features
                and math.prod(kernel.shape[i:]) == mod.out_features):
            return kernel.reshape(mod.in_features, mod.out_features).T
    raise ValueError(f"{path}: kernel shape {kernel.shape} does not map to "
                     f"Linear({mod.in_features}, {mod.out_features})")


def _convert_leaf(mod: nn.Module, leaf: str, value: np.ndarray, path: str
                  ) -> Tuple[str, np.ndarray]:
    """(port parameter name, value in the port's layout)."""
    if isinstance(mod, nn.Linear):
        if leaf == "kernel":
            return "weight", _linear_kernel(mod, value, path)
        if leaf == "bias":
            return "bias", value.reshape(-1)
    elif isinstance(mod, nn.LayerNorm):
        if leaf in ("scale", "bias"):
            return {"scale": "weight", "bias": "bias"}[leaf], value
    elif isinstance(mod, nn.Embedding):
        if leaf == "embedding":
            return "weight", value
    elif isinstance(mod, nn.Conv1d):
        if leaf == "kernel":
            return "weight", value.transpose(2, 1, 0)
        if leaf == "bias":
            return "bias", value
    elif isinstance(mod, BatchNorm):
        if leaf in ("scale", "bias"):
            return {"scale": "weight", "bias": "bias"}[leaf], value
    else:
        return leaf, value
    raise KeyError(f"{path}: no {type(mod).__name__} parameter for Flax "
                   f"leaf {leaf!r}")


def _fill(model: nn.Module, tree: Mapping, targets: Dict[str, torch.Tensor],
          convert, what: str) -> nn.Module:
    """Copy every leaf of ``tree`` into ``targets`` (port name -> tensor)
    through ``convert(module, leaf, value, path) -> (name, array)``, each
    target exactly once."""
    modules = dict(model.named_modules())
    filled = set()
    for path, value in _flatten(tree).items():
        flax_path = "/".join(path)
        mod_name, leaf = ".".join(path[:-1]), path[-1]
        if mod_name not in modules:
            raise KeyError(f"{flax_path}: the port has no module {mod_name!r}")
        name, arr = convert(modules[mod_name], leaf, value, flax_path)
        full = f"{mod_name}.{name}" if mod_name else name
        if full not in targets:
            raise KeyError(f"{flax_path}: the port has no {what} {full!r}")
        if full in filled:
            raise KeyError(f"{flax_path}: {what} {full!r} filled twice")
        p = targets[full]
        if tuple(p.shape) != arr.shape:
            raise ValueError(f"{flax_path}: shape {arr.shape} after "
                             f"conversion, port {full} has {tuple(p.shape)}")
        p.copy_(torch.as_tensor(np.array(arr, np.float32)))
        filled.add(full)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"port {what}s with no Flax leaf: {missing}")
    return model


@torch.no_grad()
def load_flax_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """Fill ``model`` in place from a Flax parameter tree; returns it."""
    return _fill(model, tree, dict(model.named_parameters()), _convert_leaf,
                 "parameter")


def _stat_leaf(mod: nn.Module, leaf: str, value: np.ndarray, path: str
               ) -> Tuple[str, np.ndarray]:
    if isinstance(mod, BatchNorm) and leaf in ("mean", "var"):
        return f"running_{leaf}", value
    raise KeyError(f"{path}: no BatchNorm statistic for Flax leaf {leaf!r}")


@torch.no_grad()
def load_flax_batch_stats(model: nn.Module, tree: Mapping) -> nn.Module:
    """Fill the running statistics of ``model``'s BatchNorms in place from
    a Flax ``"batch_stats"`` tree; returns it."""
    stats = {f"{m}.{b}": getattr(mod, b)
             for m, mod in model.named_modules() if isinstance(mod, BatchNorm)
             for b in ("running_mean", "running_var")}
    return _fill(model, tree, stats, _stat_leaf, "BatchNorm statistic")
