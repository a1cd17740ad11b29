"""Checkpoints on disk: module weights, the best-val artifact, the full
train state for exact resume, and the stage-1 -> stage-2 handoff.

Counterpart of ``tsue_tpu/train/checkpoint.py``.  The JAX package writes
Orbax pytrees, which the port cannot read; the port writes its own format:
one directory per artifact holding ``state.pt`` (``torch.save`` of CPU
tensors, read back with ``weights_only=True``).  Parameters are keyed by
the port's names (``mllm.llama.layer_0.q_proj.lora_a``), which follow the
Flax paths.

- ``save_state_dict``/``load_state_dict``: a whole module, loaded strictly
  (the reference's ``strict=True``, the JAX package's
  ``restore_pytree(target=...)``): every key on both sides and every shape
  equal, or it raises before anything is copied;
- ``restore_merge``: a full artifact or any subset of one, merged over a
  model (the eval flows do not know which freeze regime wrote it);
- ``BestCheckpointer``: the best-val protocol (ref scripts/train.py:
  1219-1224), storing only the trainable subset;
- ``save_train_state``/``restore_train_state``: the step, the trainable
  subset, the whole optimizer state (AdamW's moments and steps, the
  non-finite guard's count), the epoch and the best val loss in one file,
  saved crash-safe (the reference saves no optimizer state and cannot
  resume); under a mesh the parameters and moments are gathered whole, so
  the file is the one process's whatever the mesh, and cut back to each
  rank's shards on restore;
- ``export_mllm``/``import_mllm``: the stage-1 artifact (ref
  mllm_lora_ddp_finetuned.pt, consumed at scripts/train.py:1137-1138);
- ``strip_lora``: drops the LoRA factors (the no-LoRA ablation's loader,
  ref ablation_study_without_lora.py:1070-1084).

Weights from the JAX package cross through ``convert.load_flax_params``
instead.  The JAX package's shim for its pre-r4 optimizer layout has no
counterpart: the port never wrote that layout.
"""
from __future__ import annotations

import math
import os
import shutil
from typing import Callable, Dict, List, Mapping, Optional

import torch
from torch import nn

from tsue_tpu_torch.train.trainer import param_labels

STATE_FILE = "state.pt"

NameFilter = Optional[Callable[[str], bool]]


def _cpu(obj):
    """``obj`` with every tensor detached and moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, Mapping):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _write(path: str, obj) -> str:
    """``torch.save`` ``obj`` to ``<path>/state.pt`` through a temporary
    file; returns the file's path."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, STATE_FILE)
    torch.save(_cpu(obj), out + ".tmp")
    os.replace(out + ".tmp", out)
    return out


def _read(path: str):
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def save_state_dict(module: nn.Module, path: str) -> str:
    """Write ``module.state_dict()`` to ``<path>/state.pt``; returns the
    file's path."""
    return _write(path, module.state_dict())


def _check_keys(path: str, stored, want) -> None:
    missing, extra = sorted(set(want) - set(stored)), \
        sorted(set(stored) - set(want))
    if missing or extra:
        raise KeyError(f"{path}: checkpoint keys differ from the module's: "
                       f"missing {missing}, unexpected {extra}")


def _merge(module: nn.Module, stored: Mapping[str, torch.Tensor],
           path: str) -> nn.Module:
    """Copy ``stored`` over ``module``'s state in place, after checking
    that every key exists in the module with the same shape."""
    own = module.state_dict()
    extra = sorted(set(stored) - set(own))
    if extra:
        raise ValueError(
            f"checkpoint {path} holds {len(extra)} keys absent from the "
            f"model ({extra[:3]}); wrong preset or model config for this "
            "artifact?")
    bad = [(k, tuple(v.shape), tuple(own[k].shape))
           for k, v in stored.items() if tuple(v.shape) != tuple(own[k].shape)]
    if bad:
        raise ValueError(
            f"checkpoint {path}: {len(bad)} tensors have mismatched shapes "
            f"({', '.join(f'{k}: stored {s} vs model {m}' for k, s, m in bad[:3])})"
            " -- was the checkpoint trained under a different preset or "
            "horizon?  Pass the training preset to the eval run.")
    with torch.no_grad():
        for k, v in stored.items():
            own[k].copy_(v)
    return module


def load_state_dict(module: nn.Module, path: str) -> nn.Module:
    """Fill ``module`` in place from ``save_state_dict``'s directory; every
    key and every shape must match (KeyError, ValueError)."""
    stored = _read(path)
    _check_keys(path, stored, module.state_dict())
    return _merge(module, stored, path)


def restore_merge(path: str, module: nn.Module) -> nn.Module:
    """Merge an artifact holding ``module``'s full state or any subset of
    it over ``module``, in place; returns ``module``.  Frozen-regime best
    artifacts hold only the trainable subset, and the eval flows (ref
    scripts/test.py:1273-1276) do not know which regime wrote the one they
    are given.  Keys absent from the model, or shapes that differ (an
    18->30 forecaster evaluated under an 18->18 preset), raise with the
    offending names before anything is copied."""
    return _merge(module, _read(path), path)


def trainable_filter(model: nn.Module, regime: str) -> Callable[[str], bool]:
    """The names ``trainer.param_labels`` labels "train" under ``regime``
    (a buffer is never trainable)."""
    labels = param_labels(model, regime)
    return lambda name: labels.get(name) == "train"


def _trainable_subset(state: Mapping[str, torch.Tensor],
                      trainable: NameFilter) -> Dict[str, torch.Tensor]:
    """The entries of a state dict whose names ``trainable`` passes (all of
    them without a filter)."""
    if trainable is None:
        return dict(state)
    return {k: v for k, v in state.items() if trainable(k)}


def _restore_subset(module: nn.Module, stored, trainable: NameFilter,
                    path: str) -> nn.Module:
    """Merge ``stored`` over ``module``, whose keys must be exactly the
    subset ``trainable`` names (the whole state without a filter)."""
    _check_keys(path, stored, _trainable_subset(module.state_dict(),
                                                trainable))
    return _merge(module, stored, path)


class BestCheckpointer:
    """Best-val checkpoint protocol (ref scripts/train.py:1219-1224).

    ``trainable_filter(name) -> bool`` restricts the artifact to the
    trainable parameters: in the frozen-MLLM regime the 1.3B frozen
    parameters never change and are rebuilt from the seed, so writing them
    on every improvement would be gigabytes of copies for nothing.
    ``restore_best`` merges the saved subset back over the model.

    Under a mesh (``parallel.mesh.Mesh``, the module a rank's shard) every
    rank calls ``maybe_save`` with the same val loss: the subset is
    gathered whole (``parallel.sharding.gather_state``, a collective), rank
    0 writes the one-process file, and every rank keeps its own shard of
    it in memory, which ``restore_best`` copies back
    (``tsue_tpu/runner.py:226-233``)."""

    def __init__(self, directory: str, trainable_filter: NameFilter = None,
                 mesh=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.best_val = float("inf")
        self.trainable_filter = trainable_filter
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._best_local: Optional[Dict[str, torch.Tensor]] = None

    @property
    def best_path(self) -> str:
        return os.path.join(self.directory, "best")

    def maybe_save(self, val_loss: float, module: nn.Module) -> bool:
        """Save on a finite improvement of the val loss; returns whether it
        saved."""
        if not math.isfinite(val_loss) or val_loss >= self.best_val:
            return False
        self.best_val = val_loss
        subset = _trainable_subset(module.state_dict(), self.trainable_filter)
        if self.mesh is None:
            _write(self.best_path, subset)
            return True
        from tsue_tpu_torch.parallel.sharding import gather_state
        whole = gather_state(subset, self.mesh)
        if self.mesh.is_primary():
            _write(self.best_path, whole)
        self._best_local = {k: _local(v).detach().clone()
                            for k, v in subset.items()}
        return True

    def restore_best(self, module: nn.Module) -> nn.Module:
        """Merge the best artifact over ``module``, in place (under a mesh,
        the rank's shard kept in memory, or, where this run saved none (a
        resumed run whose best epoch came before it), the file cut to the
        rank's shards)."""
        if self.mesh is None:
            return _restore_subset(module, _read(self.best_path),
                                   self.trainable_filter, self.best_path)
        own = module.state_dict()
        if self._best_local is None:
            stored = _read(self.best_path)
            _check_keys(self.best_path, stored,
                        _trainable_subset(own, self.trainable_filter))
            from tsue_tpu_torch.parallel.sharding import load_local
            load_local(own, stored, self.mesh)
            return module
        with torch.no_grad():
            for k, v in self._best_local.items():
                _local(own[k]).copy_(v)
        return module


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


# ---------------------------------------------------------------------------
# Full train-state save/resume (step + trainable subset + optimizer)
# ---------------------------------------------------------------------------

def _sharded(state):
    """``state.mesh`` where the state is laid out on one of several
    processes, else None."""
    mesh = state.mesh
    return mesh if mesh is not None and mesh.size > 1 else None


def _optimizer_names(state) -> List[str]:
    """The parameter name of each of the optimizer's parameters (its
    state's indices)."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for p in state.optimizer.params]


def _map_moments(opt_state: Dict, names: List[str], fn) -> Dict:
    """``opt_state`` (``GuardedAdamW.state_dict()``'s form) with every
    per-parameter tensor of AdamW's state (the moments; not the 0-d step
    counts) replaced by the entry of ``fn({parameter name: tensor})``,
    moment by moment, in the parameters' order."""
    adamw = opt_state["adamw"]
    per = {i: dict(s) for i, s in adamw["state"].items()}
    keys = sorted({k for s in per.values() for k, v in s.items()
                   if isinstance(v, torch.Tensor) and v.dim() > 0})
    for key in keys:
        done = fn({names[i]: s[key] for i, s in per.items()})
        for i, s in per.items():
            s[key] = done[names[i]]
    return dict(opt_state, adamw=dict(adamw, state=per))


def save_train_state(path: str, state, *, epoch: int = 0,
                     best_val: float = float("inf"),
                     trainable_filter: NameFilter = None) -> None:
    """Persist a ``TrainState`` for exact resume.

    - ``epoch`` and ``best_val`` ride in the same file as the state, so a
      crash cannot leave them disagreeing;
    - ``trainable_filter`` restricts the stored parameters to the trainable
      ones (the frozen ones are rebuilt from the seed at restore, as for
      ``BestCheckpointer``); the optimizer state is stored whole;
    - under a mesh (``state.mesh``) every rank calls it: the parameters
      and each AdamW moment are gathered whole by the parameter's own
      spec (``parallel.sharding.gather_state``, a collective) and rank 0
      writes the one-process file;
    - the save is crash-safe: it writes ``<path>.tmp``, moves the previous
      state to ``<path>.old``, renames, then removes ``.old``;
      ``train_state_path`` falls back to ``.old`` if a crash lands between
      the renames, so the last durable state is never lost."""
    params = _trainable_subset(state.model.state_dict(), trainable_filter)
    optimizer = state.optimizer.state_dict()
    mesh = _sharded(state)
    if mesh is not None:
        from tsue_tpu_torch.parallel.sharding import gather_state
        params = gather_state(params, mesh)
        optimizer = _map_moments(optimizer, _optimizer_names(state),
                                 lambda d: gather_state(d, mesh))
        if not mesh.is_primary():
            return
    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    shutil.rmtree(tmp, ignore_errors=True)
    _write(tmp, {"step": int(state.step), "params": params,
                 "optimizer": optimizer,
                 "epoch": int(epoch), "best_val": float(best_val)})
    shutil.rmtree(old, ignore_errors=True)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def train_state_path(path: str) -> Optional[str]:
    """The live train-state directory, or the ``.old`` survivor a crash in
    the middle of ``save_train_state``'s swap leaves; None if neither."""
    path = os.path.abspath(path)
    for p in (path, path + ".old"):
        if os.path.exists(os.path.join(p, STATE_FILE)):
            return p
    return None


def restore_train_state(path: str, state, *,
                        trainable_filter: NameFilter = None):
    """Restore into ``state`` (a ``TrainState`` built as the saved one was:
    the same model and optimizer), in place.  ``trainable_filter`` must be
    the one used at save time; the stored parameters merge over the
    model's, whose frozen ones the caller rebuilt from the seed.  Under a
    mesh every rank reads the file and cuts the parameters and the AdamW
    moments to its shards (``parallel.sharding.local_state``), each FSDP
    moment placed as its parameter is: a file written on any mesh, or by
    one process, resumes on any other.  Returns
    ``(state, {"epoch", "best_val"})``."""
    resolved = train_state_path(path)
    if resolved is None:
        raise FileNotFoundError(f"no train state at {path} (or .old)")
    stored = _read(resolved)
    mesh = _sharded(state)
    if mesh is None:
        _restore_subset(state.model, stored["params"], trainable_filter,
                        resolved)
        state.optimizer.load_state_dict(stored["optimizer"])
    else:
        from tsue_tpu_torch.parallel.sharding import load_local, local_state
        own = state.model.state_dict()
        _check_keys(resolved, stored["params"],
                    _trainable_subset(own, trainable_filter))
        load_local(own, stored["params"], mesh)
        params = dict(state.model.named_parameters())
        state.optimizer.load_state_dict(_map_moments(
            stored["optimizer"], _optimizer_names(state),
            lambda d: local_state(d, {n: params[n] for n in d}, mesh)))
    state.step = stored["step"]
    return state, {"epoch": stored["epoch"], "best_val": stored["best_val"]}


# ---------------------------------------------------------------------------
# Stage handoff + LoRA surgery
# ---------------------------------------------------------------------------

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


def strip_lora(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A state dict without its ``lora_a``/``lora_b`` entries, to load a
    LoRA checkpoint into a model built without LoRA (ref
    ablation_study_without_lora.py:1070-1084)."""
    return {k: v for k, v in state.items()
            if not any(p in ("lora_a", "lora_b") for p in k.split("."))}
