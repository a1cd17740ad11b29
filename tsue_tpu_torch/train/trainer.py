"""Stage-2 training: freeze regimes, the guarded AdamW step, train and eval
steps.

Counterpart of ``tsue_tpu/train/trainer.py``.  The JAX package routes
frozen parameters to ``optax.set_to_zero`` through a label tree; the port
gives the same labels to its parameter names (which follow the Flax paths,
``mllm.llama.model.layer_0.attn.q_proj.lora_a``), sets ``requires_grad``
from them and hands only the trainable ones to ``torch.optim.AdamW``:

- frozen parameters get neither updates nor weight decay, and autograd
  computes no gradient for them;
- the global-norm clip is taken over the trainable set only
  (``optax.clip_by_global_norm``: ``g / norm * clip`` when ``norm >= clip``);
- a step whose trainable gradients are not all finite is skipped: the Adam
  moments and the Adam step count stay as they were, until more than
  ``MAX_CONSECUTIVE_ERRORS`` (100) such steps in a row, when it is taken
  anyway (``optax.apply_if_finite``).

The train step's dropout draws from ``utils.random.step_generator(seed,
step)``, the counterpart of ``fold_in(key(seed), state.step)``; torch
cannot reproduce JAX's masks, so parity is tested with dropout at 0.

Under a mesh (``TrainState.mesh``; ``runner.run_stage2`` places the model)
each data rank trains on its rows of the global batch: the loss is the
global batch's (its valid-row count summed over data), the gradients are
averaged over data by DDP or, with FSDP, reduce-scattered by FSDP2 (the
replicated rest all-reduced), and the guard and the clip read the global
gradient: every element counted once, over the model ranks' shards and
the data ranks' FSDP shards.  Dropout draws from the step's stream folded
with the data rank, the same on the model ranks of a data rank; a mesh
step equals the one-process step with dropout at 0 (the rows' masks
differ otherwise).  On a pipeline's mesh (``parallel.pipeline``) a
stage's own decoder layers are counted once per stage (``stage_own``)
and the replicated rest once in all.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tsue_tpu_torch.config import ExperimentConfig
from tsue_tpu_torch.parallel import mesh as M
from tsue_tpu_torch.train.losses import denorm_mse_loss
from tsue_tpu_torch.utils.random import step_generator

MAX_CONSECUTIVE_ERRORS = 100


# ---------------------------------------------------------------------------
# Freeze regimes
# ---------------------------------------------------------------------------

def freeze_label(path_strs: Tuple[str, ...], regime: str) -> str:
    """Return "train" or "freeze" for a parameter path under the regime.

    Regimes (SURVEY.md §2.6 T1-T4):
      frozen_mllm — whole mllm subtree frozen (ref scripts/train.py:1141-1142)
      joint       — everything trainable (ref im_kim_train_GRN.py:976-1008)
      lora_only   — inside mllm/llama only lora params train
                    (ref modify_train.py:522-528); everything else trains
      full_freeze — mllm/llama frozen incl. LoRA (ref modify.py:523-525);
                    qformer/forecaster train
    """
    in_mllm = "mllm" in path_strs
    in_llama = in_mllm and any(p == "llama" for p in path_strs)
    is_lora = any("lora" in p for p in path_strs)
    if regime == "joint":
        return "train"
    if regime == "frozen_mllm":
        return "freeze" if in_mllm else "train"
    if regime == "lora_only":
        if in_llama and not is_lora:
            return "freeze"
        return "train"
    if regime == "full_freeze":
        return "freeze" if in_llama else "train"
    raise ValueError(f"unknown freeze regime {regime!r}")


def param_labels(model: nn.Module, regime: str) -> Dict[str, str]:
    """{parameter name: "train" | "freeze"} for every parameter."""
    return {name: freeze_label(tuple(name.split(".")), regime)
            for name, _ in model.named_parameters()}


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

class GuardedAdamW:
    """AdamW over the trainable parameters behind a global-norm clip and a
    non-finite guard: the train branch of the JAX package's
    ``multi_transform`` (``trainer.py:84-108``)."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float,
                 weight_decay: float, grad_clip=None, nan_guard: bool = True,
                 mesh=None, tp_sharded: Optional[List[bool]] = None,
                 stage_own: Optional[List[bool]] = None):
        """``mesh``, ``tp_sharded`` (per parameter, cut over the model
        axis), ``stage_own`` (per parameter, one pipeline stage's own):
        the guard and the clip read the global gradient (module
        docstring)."""
        self.params = list(params)
        sharded = any(hasattr(p, "to_local") for p in self.params)
        # the per-tensor loop where FSDP2's DTensors sit beside plain ones
        self.foreach = False if sharded else None
        self.adamw = torch.optim.AdamW(self.params, lr=lr,
                                       weight_decay=weight_decay,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       foreach=self.foreach)
        self.grad_clip = grad_clip
        self.nan_guard = nan_guard
        self.notfinite_count = 0
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.tp_sharded = tp_sharded or [False] * len(self.params)
        self.stage_own = stage_own or [False] * len(self.params)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        """Apply the gradients in ``p.grad``, unless the guard skips them.  A
        trainable parameter that got no gradient counts as a zero gradient
        (optax sees zeros: the moments decay, the decay applies)."""
        if not self.params:
            return
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.mesh is not None:
            return self._mesh_step(grads)
        norm = None
        if self.nan_guard:
            finite, norm = self._probe(grads)
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= MAX_CONSECUTIVE_ERRORS:
                return
        if self.grad_clip:
            if norm is None:
                norm = global_norm(grads)
            keep = norm < self.grad_clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.grad_clip))
        self.adamw.step()

    def _probe(self, grads: List[torch.Tensor]
               ) -> Tuple[bool, Optional[torch.Tensor]]:
        """(every gradient element finite, the global norm where the
        probe computes it for the clip to reuse, else None): one
        ``isfinite`` reduction a tensor (``optax.apply_if_finite``).
        ``train.guard`` holds two other probes."""
        return bool(torch.stack(
            [torch.isfinite(g).all() for g in grads]).all()), None

    def _mesh_step(self, grads) -> None:
        """``step`` over sharded gradients: one all-reduce decides the
        guard for every rank, the square norms sum each element once."""
        mesh = self.mesh
        loc = [_local(g) for g in grads]
        dev = loc[0].device
        if self.nan_guard:
            bad = torch.stack([~torch.isfinite(g).all() for g in loc]).any()
            bad = bad.to(torch.float32).reshape(1)
            M.COUNTS["all_reduce"] += 1
            torch.distributed.all_reduce(bad, torch.distributed.ReduceOp.MAX)
            finite = not bool(bad)
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= MAX_CONSECUTIVE_ERRORS:
                return
        if self.grad_clip:
            # square norms by the axes a gradient is cut over: bit 1 model,
            # bit 2 data (FSDP), bit 4 pipe (a stage's own layers)
            sq = torch.zeros(8, dtype=torch.float64, device=dev)
            for g, lg, tp, own in zip(grads, loc, self.tp_sharded,
                                      self.stage_own):
                k = int(tp) + 2 * int(hasattr(g, "to_local")) + 4 * int(own)
                sq[k] += torch.linalg.vector_norm(lg).double() ** 2
            for bit, group in ((1, mesh.model_group), (2, mesh.data_group),
                               (4, mesh.pipe_group)):
                cut = [k for k in range(8) if k & bit]
                sq[cut] = M.all_reduce(sq[cut].contiguous(), group)
            norm = float(sq.sum().sqrt())
            if norm >= self.grad_clip:
                for lg in loc:
                    lg.mul_(self.grad_clip / norm)
        self.adamw.step()

    def state_dict(self) -> Dict:
        """AdamW's state (moments, step counts, hyperparameters) and the
        guard's count.  The per-tensor loop choice is left out: it belongs
        to the placement, so the state is the same whatever the mesh."""
        adamw = self.adamw.state_dict()
        for group in adamw["param_groups"]:
            group.pop("foreach", None)
        return {"adamw": adamw, "notfinite_count": self.notfinite_count}

    def load_state_dict(self, state: Dict) -> None:
        """Load ``state_dict()``'s form; the loop choice stays this
        optimizer's."""
        self.adamw.load_state_dict(state["adamw"])
        for group in self.adamw.param_groups:
            group["foreach"] = self.foreach
        self.notfinite_count = state["notfinite_count"]


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm over every element of ``grads`` (``optax.global_norm``),
    as the clip takes it."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))


def set_trainable(model: nn.Module, regime: str) -> List[nn.Parameter]:
    """Label every parameter under ``regime``, set ``requires_grad`` from
    the label and return the trainable parameters.  The flags also decide
    the last bits of an fp32 forward, with or without grad mode:
    ``torch.matmul`` of a batch of rows by a weight that requires grad
    folds the batch into one product, by one that does not it may run a
    batched product."""
    labels = param_labels(model, regime)
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
        if labels[name] == "train":
            trainable.append(p)
    return trainable


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (FSDP2), or the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def make_optimizer(cfg: ExperimentConfig, model: nn.Module,
                   mesh=None) -> GuardedAdamW:
    """``set_trainable`` under ``cfg.train.freeze_regime``, then
    AdamW(lr, weight_decay) with clip and guard over the trainable
    parameters (under ``mesh``, over the global gradient)."""
    tcfg = cfg.train
    trainable = set_trainable(model, tcfg.freeze_regime)
    tp = None
    if mesh is not None:
        from tsue_tpu_torch.parallel.sharding import tp_sharded
        names = {id(p): n for n, p in model.named_parameters()}
        tp = [tp_sharded(names[id(p)], _local(p), mesh) for p in trainable]
    return GuardedAdamW(trainable, tcfg.lr, tcfg.weight_decay,
                        tcfg.grad_clip, tcfg.nan_guard, mesh, tp)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer, the run's seed and the
    number of train steps taken (skipped ones included, as the JAX
    package's ``TrainState.step``)."""
    model: nn.Module
    optimizer: GuardedAdamW
    seed: int = 0
    step: int = 0
    mesh: Optional[object] = None     # parallel.mesh.Mesh
    forward: Optional[nn.Module] = None   # the DDP wrapper, under DP


def make_train_step(cfg: ExperimentConfig) -> Callable:
    """Returns ``step(state, batch) -> {"loss"}``, which updates ``state``
    in place.  In the frozen-MLLM regime the MLLM runs under
    ``torch.no_grad()`` (``stop_llm_grad``): the whole mllm subtree is
    frozen, so no trainable parameter needs its backward."""
    stop_llm = cfg.train.freeze_regime == "frozen_mllm" and cfg.model.use_llm

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict:
        mesh = state.mesh
        gen = step_generator(state.seed, state.step,
                             batch["traj_in"].device)
        if mesh is not None and mesh.data > 1:
            gen = step_generator(state.seed, state.step,
                                 batch["traj_in"].device,
                                 stream=mesh.data_rank)
        pred = (state.forward or state.model)(
            batch, deterministic=False, stop_llm_grad=stop_llm,
            generator=gen)
        state.optimizer.zero_grad()
        if mesh is None or mesh.data == 1:
            loss = denorm_mse_loss(pred, batch["traj_out"],
                                   batch["norm_stat"], batch.get("valid"))
            loss.backward()
        else:
            part = data_parallel_loss(pred, batch, mesh)
            # DDP and FSDP average over data: scale the rank's part up
            (part * mesh.data).backward()
            if state.forward is None:
                from tsue_tpu_torch.parallel.sharding import \
                    sync_replicated_grads
                sync_replicated_grads(state.optimizer.params, mesh)
            loss = M.all_reduce(part.detach().clone(), mesh.data_group)
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach()}

    return step


def make_eval_step(cfg: ExperimentConfig) -> Callable:
    """Returns ``step(state, batch) -> {"loss", "pred"}``: the deterministic
    forward, no gradient."""
    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict:
        mesh = state.mesh
        pred = state.model(batch)
        if mesh is None or mesh.data == 1:
            loss = denorm_mse_loss(pred, batch["traj_out"],
                                   batch["norm_stat"], batch.get("valid"))
        else:
            loss = M.all_reduce(data_parallel_loss(pred, batch, mesh),
                                mesh.data_group)
        return {"loss": loss, "pred": pred}
    return step


def stack_epoch_batches(iterator, device=None) -> Dict[str, torch.Tensor]:
    """One epoch of batches, each key stacked on a leading (num_batches)
    axis on ``device``, for ``make_scan_epoch``
    (``tsue_tpu/train/trainer.py:151``)."""
    batches = list(iterator)
    return {k: torch.from_numpy(np.stack([np.asarray(b[k])
                                          for b in batches])).to(device)
            for k in batches[0]}


def make_scan_epoch(cfg: ExperimentConfig) -> Callable:
    """Returns ``epoch(state, batches) -> (state, losses)``: a whole epoch
    of ``make_train_step`` over the leading axis of
    ``stack_epoch_batches``' tensors, ``losses`` (num_batches,).  The
    counterpart of the JAX package's ``lax.scan`` epoch
    (``tsue_tpu/train/trainer.py:161``): the same steps as the runner's
    loop, bit for bit (each step's dropout from ``state.step``)."""
    step = make_train_step(cfg)

    def epoch(state: TrainState, batches: Dict[str, torch.Tensor]):
        n = len(next(iter(batches.values())))
        losses = [step(state, {k: v[i] for k, v in batches.items()})["loss"]
                  for i in range(n)]
        return state, torch.stack(losses)

    return epoch


def data_parallel_loss(pred: torch.Tensor, batch: Dict[str, torch.Tensor],
                       mesh) -> torch.Tensor:
    """This data rank's part of the global batch's ``denorm_mse_loss``:
    its rows' squared errors over the global valid-row count (summed over
    data), so the parts sum to the one-process loss."""
    n = M.all_reduce(batch["valid"].float().sum(), mesh.data_group)
    return denorm_mse_loss(pred, batch["traj_out"], batch["norm_stat"],
                           batch["valid"], n_valid=n)
