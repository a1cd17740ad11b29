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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch import nn

from tsue_tpu_torch.config import ExperimentConfig
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
                 weight_decay: float, grad_clip=None, nan_guard: bool = True):
        self.params = list(params)
        self.adamw = torch.optim.AdamW(self.params, lr=lr,
                                       weight_decay=weight_decay,
                                       betas=(0.9, 0.999), eps=1e-8)
        self.grad_clip = grad_clip
        self.nan_guard = nan_guard
        self.notfinite_count = 0

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
        if self.nan_guard:
            finite = bool(torch.stack(
                [torch.isfinite(g).all() for g in grads]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= MAX_CONSECUTIVE_ERRORS:
                return
        if self.grad_clip:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            keep = norm < self.grad_clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.grad_clip))
        self.adamw.step()

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(),
                "notfinite_count": self.notfinite_count}

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.notfinite_count = state["notfinite_count"]


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


def make_optimizer(cfg: ExperimentConfig, model: nn.Module) -> GuardedAdamW:
    """``set_trainable`` under ``cfg.train.freeze_regime``, then
    AdamW(lr, weight_decay) with clip and guard over the trainable
    parameters."""
    tcfg = cfg.train
    return GuardedAdamW(set_trainable(model, tcfg.freeze_regime), tcfg.lr,
                        tcfg.weight_decay, tcfg.grad_clip, tcfg.nan_guard)


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


def make_train_step(cfg: ExperimentConfig) -> Callable:
    """Returns ``step(state, batch) -> {"loss"}``, which updates ``state``
    in place.  In the frozen-MLLM regime the MLLM runs under
    ``torch.no_grad()`` (``stop_llm_grad``): the whole mllm subtree is
    frozen, so no trainable parameter needs its backward."""
    stop_llm = cfg.train.freeze_regime == "frozen_mllm" and cfg.model.use_llm

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict:
        gen = step_generator(state.seed, state.step,
                             batch["traj_in"].device)
        pred = state.model(batch, deterministic=False,
                           stop_llm_grad=stop_llm, generator=gen)
        loss = denorm_mse_loss(pred, batch["traj_out"], batch["norm_stat"],
                               batch.get("valid"))
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach()}

    return step


def make_eval_step(cfg: ExperimentConfig) -> Callable:
    """Returns ``step(state, batch) -> {"loss", "pred"}``: the deterministic
    forward, no gradient."""
    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict:
        pred = state.model(batch)
        loss = denorm_mse_loss(pred, batch["traj_out"], batch["norm_stat"],
                               batch.get("valid"))
        return {"loss": loss, "pred": pred}
    return step
