"""Parameter partition rules: Megatron tensor parallelism over the
``model`` axis and ZeRO-3 (FSDP) placement over the ``data`` axis.

Counterpart of ``tsue_tpu/parallel/sharding.py``.  The rule table and
the resolution functions are the JAX package's, as pure functions over
Flax paths and Flax shapes: attention q/k/v split by heads (the output
dim), o_proj on its input dim, the MLP's gate/up on the output and down on
the input, the embedding and the LM head's int8 table on the feature dim;
``fsdp`` puts the largest still-free divisible dim of every parameter of
at least ``FSDP_MIN_SIZE`` elements on ``data``; a parameter whose split
dim does not divide its axis stays replicated.

The port names its modules after the Flax paths, so a port parameter's
Flax path is its name split at the dots, with two renamings: the
embedding's table is ``embed_tokens.weight`` (Flax ``embedding``), and a
torch ``Linear``'s ``weight`` (out, in) is the Flax ``kernel`` (in-dims...,
out-dims...) transposed (``flax_layout``).  The int8 decode tables of
``ops.quant.quantize_llama_params`` carry the Flax ``"quant"`` names.

What XLA's partitioner does from these specs, the port does by hand:
``shard_state`` cuts a full state dict into this rank's model-axis shards
(the local-shard Llama of ``models/llama.py`` has exactly their shapes),
``apply_fsdp`` hands the data-axis placement to FSDP2 (``fully_shard``),
and ``gather_state`` is the inverse of both: the full state, on every
rank, in the one-process layout.  ``local_state`` cuts a full state the
other way, to a rank's TP shards and FSDP DTensors laid out as a given
state's (a checkpoint read back under a mesh), and ``load_local`` copies
it over a sharded module's.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch
from torch import nn

from tsue_tpu_torch.parallel import mesh as M

Spec = Tuple[Optional[str], ...]

# (Flax path suffix, spec) -- first hit whose length equals the rank wins
_TP_RULES: Tuple[Tuple[Tuple[str, ...], Spec], ...] = (
    (("q_proj", "kernel"), (None, "model")),
    (("k_proj", "kernel"), (None, "model")),
    (("v_proj", "kernel"), (None, "model")),
    (("o_proj", "kernel"), ("model", None)),
    (("gate_proj", "kernel"), (None, "model")),
    (("up_proj", "kernel"), (None, "model")),
    (("down_proj", "kernel"), ("model", None)),
    (("q_proj", "lora_b"), (None, "model")),
    (("k_proj", "lora_b"), (None, "model")),
    (("v_proj", "lora_b"), (None, "model")),
    (("o_proj", "lora_a"), ("model", None)),
    (("embed_tokens", "weight"), (None, "model")),
    # int8 decode tables: w8 splits like its kernel twin; the per-output
    # scale splits with the output dim where that is split (q/k/v/gate/up)
    # and stays whole where the contraction dim is (o/down)
    (("q_proj", "w8"), (None, "model")),
    (("k_proj", "w8"), (None, "model")),
    (("v_proj", "w8"), (None, "model")),
    (("o_proj", "w8"), ("model", None)),
    (("gate_proj", "w8"), (None, "model")),
    (("up_proj", "w8"), (None, "model")),
    (("down_proj", "w8"), ("model", None)),
    (("q_proj", "scale"), ("model",)),
    (("k_proj", "scale"), ("model",)),
    (("v_proj", "scale"), ("model",)),
    (("gate_proj", "scale"), ("model",)),
    (("up_proj", "scale"), ("model",)),
    # the (D, V) LM-head int8 table splits D, the tied embedding's axis
    (("lm_head_w8",), ("model", None)),
)

# parameters smaller than this stay replicated under FSDP (norm scales,
# biases, LoRA adapters)
FSDP_MIN_SIZE = 2 ** 16


def param_spec(path: Tuple[str, ...], ndim: int) -> Spec:
    """The TP spec of a Flax path; ``()`` (replicated) unless a rule
    matches (``sharding.py:61-68``)."""
    for suffix, spec in _TP_RULES:
        if len(path) >= len(suffix) and tuple(path[-len(suffix):]) == \
                suffix and ndim == len(spec):
            return spec
    return ()


def _fsdp_augment(spec: Spec, shape, data: int,
                  min_size: int = FSDP_MIN_SIZE) -> Spec:
    """The largest still-free dim that ``data`` divides goes on "data"
    (``sharding.py:77-96``)."""
    if data <= 1 or math.prod(shape) < min_size:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for dim in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if entries[dim] is None and shape[dim] % data == 0 \
                and shape[dim] >= data:
            entries[dim] = "data"
            return tuple(entries)
    return spec


def resolve(path: Tuple[str, ...], shape, mesh_shape: Mapping[str, int],
            fsdp: bool = False, min_size: int = FSDP_MIN_SIZE) -> Spec:
    """The spec of a Flax path and shape on a mesh of ``mesh_shape``: the
    TP rule, replicated where its dim does not divide, then the FSDP
    augmentation (``sharding.py:99-111``)."""
    spec = param_spec(path, len(shape))
    for dim, axis in enumerate(spec):
        if axis is not None and shape[dim] % mesh_shape.get(axis, 1):
            spec = ()
            break
    if fsdp:
        spec = _fsdp_augment(spec, tuple(shape), mesh_shape.get("data", 1),
                             min_size)
    return spec


# ---------------------------------------------------------------------------
# The port's names and layouts
# ---------------------------------------------------------------------------

def _is_linear_weight(name: str, ndim: int) -> bool:
    """A 2-D ``weight`` outside the embedding is a torch ``Linear``'s."""
    parts = name.split(".")
    return parts[-1] == "weight" and ndim == 2 and \
        (len(parts) < 2 or parts[-2] != "embed_tokens")


def flax_path(name: str, ndim: int) -> Tuple[str, ...]:
    parts = name.split(".")
    if _is_linear_weight(name, ndim):
        parts[-1] = "kernel"
    return tuple(parts)


def _to_port(name: str, spec: Spec, ndim: int,
             groups: Optional[Tuple[Tuple[int, ...], ...]] = None) -> Spec:
    """A Flax-layout spec in the port's layout: a ``Linear`` weight's
    (out, in) takes the axis of the Flax kernel's out dims and in dims
    (``groups``: the Flax dims of in and of out)."""
    if not spec:
        return ()
    if not _is_linear_weight(name, ndim):
        return tuple(spec)
    entries = list(spec) + [None] * (sum(len(g) for g in groups) - len(spec))

    def axis(dims):
        found = [entries[d] for d in dims if entries[d] is not None]
        return found[0] if found else None
    return (axis(groups[1]), axis(groups[0]))


def tp_spec(name: str, shape, mesh_shape: Mapping[str, int]) -> Spec:
    """The port-layout TP spec of a port parameter or int8 table (the
    Flax kernel of a ``Linear`` taken as (in, out))."""
    lin = _is_linear_weight(name, len(shape))
    fshape = tuple(reversed(shape)) if lin else tuple(shape)
    spec = resolve(flax_path(name, len(shape)), fshape, mesh_shape)
    return _to_port(name, spec, len(shape), ((0,), (1,)) if lin else None)


def flax_layout(model: nn.Module) -> Dict[str, Tuple[Tuple[str, ...],
                                                       Tuple[int, ...],
                                                       Optional[tuple]]]:
    """{port name: (Flax path, Flax shape, Linear dim groups)} of every
    parameter.  A ``Linear`` inside an attention block with ``num_heads``
    (``models.layers.MHA``: Flax ``DenseGeneral``) has the Flax kernel
    (D, H, Dh) for q/k/v and (H, Dh, D) for o; any other ``Linear`` (in,
    out)."""
    out = {}
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        path = flax_path(name, p.dim())
        groups = None
        if _is_linear_weight(name, p.dim()):
            o, i = shape
            mod_name, _, _ = name.rpartition(".")
            parent_name, _, leaf = mod_name.rpartition(".")
            heads = getattr(modules.get(parent_name), "num_heads", None)
            if heads and leaf in ("q", "k", "v"):
                shape, groups = (i, heads, o // heads), ((0,), (1, 2))
            elif heads and leaf == "o":
                shape, groups = (heads, i // heads, o), ((0, 1), (2,))
            else:
                shape, groups = (i, o), ((0,), (1,))
        out[name] = (path, shape, groups)
    return out


def param_specs(model: nn.Module, mesh_shape: Mapping[str, int],
                fsdp: bool = False, min_size: int = FSDP_MIN_SIZE
                ) -> Dict[str, Spec]:
    """{port name: port-layout spec} of every parameter of ``model`` (a
    one-process model: the full shapes)."""
    layout = flax_layout(model)
    out = {}
    for name, p in model.named_parameters():
        path, shape, groups = layout[name]
        out[name] = _to_port(name, resolve(path, shape, mesh_shape, fsdp,
                                           min_size), p.dim(), groups)
    return out


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def check_tensor_parallel(llama_cfg, mesh: M.Mesh) -> None:
    """The local-shard Llama needs every split to divide: heads, KV
    heads, the FFN and the hidden width (the embedding's feature split).
    JAX falls back to replication there; the port raises."""
    tp = mesh.model
    if tp == 1:
        return
    c = llama_cfg
    bad = {k: v for k, v in (("num_heads", c.num_heads),
                             ("num_kv_heads", c.num_kv_heads),
                             ("intermediate_size", c.intermediate_size),
                             ("hidden_size", c.hidden_size)) if v % tp}
    if bad:
        raise ValueError(f"model_parallel={tp} must divide the Llama's "
                         f"{bad} for the local-shard Llama")


def _cut(t: torch.Tensor, spec: Spec, mesh: M.Mesh) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis == "model":
            t = t.chunk(mesh.model, dim)[mesh.model_rank]
    return t.contiguous()


def shard_state(state: Mapping[str, torch.Tensor], mesh: Optional[M.Mesh]
                ) -> Dict[str, torch.Tensor]:
    """This rank's model-axis shards of a full state dict (parameters
    and, under their Flax names, int8 tables): every entry the TP rules
    split is cut to the model rank's contiguous slice, the rest is kept
    whole.  A state from ``convert.load_flax_params`` or a checkpoint goes
    to any mesh this way; FSDP's data-axis cut is ``apply_fsdp``'s."""
    if mesh is None or mesh.model == 1:
        return dict(state)
    return {k: _cut(v, tp_spec(k, tuple(v.shape), mesh.shape), mesh)
            for k, v in state.items()}


def gather_state(state: Mapping[str, torch.Tensor], mesh: Optional[M.Mesh]
                 ) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_state`` and ``apply_fsdp``: the full state
    (every FSDP DTensor's local shards gathered over data, every TP shard
    over model, through ``parallel.mesh``'s collectives), detached, on
    every rank.  A collective: every rank calls it, with the same keys in
    the same order.  So an N-rank checkpoint is the file one process
    writes."""
    out = {}
    for k, v in state.items():
        v = v.detach()
        if hasattr(v, "full_tensor"):
            # an FSDP shard: even, on the dim ``apply_fsdp`` chose
            (place,) = v.placements
            v = M.all_gather_cat(v.to_local(), mesh.data_group, place.dim)
        if mesh is not None and mesh.model > 1:
            for dim, axis in enumerate(_tp_local_spec(k, v)):
                if axis == "model":
                    v = M.all_gather_cat(v, mesh.model_group, dim)
        out[k] = v
    return out


def local_state(full: Mapping[str, torch.Tensor],
                like: Mapping[str, torch.Tensor], mesh: M.Mesh
                ) -> Dict[str, torch.Tensor]:
    """The inverse of ``gather_state``: each entry of the full (one-process)
    ``full`` cut to this rank's part, laid out as ``like``'s entry of the
    same name: its model-axis shard (``shard_state``), and where ``like``'s
    is an FSDP DTensor, a DTensor of this data rank's even slice on the
    same dim, placed as ``like``'s.  No collective."""
    out = {}
    for k, v in shard_state(full, mesh).items():
        t = like[k]
        if hasattr(t, "to_local"):
            from torch.distributed.tensor import DTensor
            (place,) = t.placements
            piece = v.chunk(mesh.data, place.dim)[mesh.data_rank]
            v = DTensor.from_local(
                piece.to(t.to_local().device).contiguous(), t.device_mesh,
                t.placements, run_check=False)
        out[k] = v
    return out


def load_local(module_state: Mapping[str, torch.Tensor],
               full: Mapping[str, torch.Tensor], mesh: M.Mesh) -> None:
    """Copy a full state's entries over this rank's parts of
    ``module_state`` (a sharded module's ``state_dict()``), in place."""
    with torch.no_grad():
        for k, v in local_state(full, module_state, mesh).items():
            t = module_state[k]
            _local_tensor(t).copy_(_local_tensor(v))


def _local_tensor(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def _tp_local_spec(name: str, t: torch.Tensor) -> Spec:
    """The TP spec of a local shard: the rule alone (a cut dim divided)."""
    lin = _is_linear_weight(name, t.dim())
    spec = param_spec(flax_path(name, t.dim()), t.dim())
    spec = _to_port(name, spec, t.dim(), ((0,), (1,)) if lin else None)
    return spec + (None,) * (t.dim() - len(spec))


def fsdp_specs(model: nn.Module, mesh: M.Mesh,
               min_size: int = FSDP_MIN_SIZE) -> Dict[str, int]:
    """{name: dim} of the parameters FSDP shards over data: those the
    augmentation puts on "data", at the full (one-process) shapes of the
    TP layout; the dim is the port tensor's."""
    specs = {}
    layout = flax_layout(model)
    for name, p in model.named_parameters():
        path, shape, groups = layout[name]
        local = _tp_local_spec(name, p) if mesh.model > 1 else ()
        if "model" in local:
            # a TP shard: the augmentation sees the full shape
            full = tuple(s * (mesh.model if a == "model" else 1)
                         for s, a in zip(p.shape, local))
            shape = (full[1], full[0]) if groups is not None else full
        spec = _to_port(name, resolve(path, shape, mesh.shape, True,
                                      min_size), p.dim(), groups)
        if "data" in spec:
            specs[name] = spec.index("data")
    return specs


def apply_fsdp(model: nn.Module, mesh: M.Mesh,
               min_size: int = FSDP_MIN_SIZE) -> Dict[str, int]:
    """FSDP2 over the data axis, in place: each module that directly owns
    a parameter of ``fsdp_specs`` becomes one ``fully_shard`` unit (its
    forward all-gathers them, its backward reduce-scatters their
    gradients), sharded on the spec's dim; every other parameter is left
    to the caller (``sync_replicated_grads``).  Inside a forward a
    parameter is a plain tensor, so the kernels run unchanged.  Returns
    the specs."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    if mesh.data == 1:
        return {}       # nothing to shard over, as the augmentation finds
    specs = fsdp_specs(model, mesh, min_size)
    params = dict(model.named_parameters())
    sharded = {id(params[n]): d for n, d in specs.items()}
    ignored = {p for n, p in params.items() if n not in specs}
    owners = []
    for mod in model.modules():
        if any(id(p) in sharded for p in mod.parameters(recurse=False)):
            owners.append(mod)
    dmesh = mesh.data_device_mesh()
    # innermost first: a unit takes the sharded parameters no inner unit
    # took
    for mod in reversed(owners):
        fully_shard(mod, mesh=dmesh,
                    shard_placement_fn=lambda p: Shard(sharded[id(p)])
                    if id(p) in sharded else None,
                    ignored_params=ignored, reshard_after_forward=True)
    return specs


@contextlib.contextmanager
def unsharded(module: nn.Module):
    """``module``'s own parameters whole for the block, where they are
    FSDP2-sharded (``apply_fsdp``): a method other than ``forward``
    reading them, which FSDP2's hooks do not unshard.  Inside the
    module's forward, or without FSDP, nothing is done."""
    if not any(hasattr(p, "full_tensor")
               for p in module.parameters(recurse=False)):
        yield
        return
    module.unshard()
    try:
        yield
    finally:
        module.reshard()


def grad_free(attr: str):
    """A method decorator: the method runs under ``torch.inference_mode``,
    or under ``torch.no_grad`` where the module ``getattr(self, attr)``
    holds FSDP2-sharded parameters (``apply_fsdp``), whose unshard needs
    the version counters that inference tensors lack."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(self, *args, **kwargs):
            sharded = any(hasattr(p, "full_tensor")
                          for p in getattr(self, attr).parameters())
            with torch.no_grad() if sharded else torch.inference_mode():
                return fn(self, *args, **kwargs)
        return run
    return wrap


def sync_replicated_grads(params: Iterable[nn.Parameter], mesh: M.Mesh
                          ) -> None:
    """Average the gradients of the data-replicated parameters that no
    FSDP unit reduces, over the data axis (what DDP does for them)."""
    if mesh.data == 1:
        return
    for p in params:
        if p.grad is not None and not hasattr(p.grad, "full_tensor"):
            M.all_reduce(p.grad, mesh.data_group).div_(mesh.data)


def tp_sharded(name: str, t: torch.Tensor, mesh: M.Mesh) -> bool:
    """Whether a local parameter is cut over the model axis (its
    gradient's square norm then sums over the model ranks)."""
    return mesh.model > 1 and "model" in _tp_local_spec(name, t)
