"""Stage-1 MLLM fine-tuning: the causal-LM loss over the fused [img ||
text] sequence.

Counterpart of ``tsue_tpu/train/stage1.py`` (the reference ships only the
evaluation harness, ref scripts/check_generation.py; the JAX package
supplies the trainer with the same artifact contract).  The model is a
``MultiModalLLM``; its parameter names follow the Flax paths
(``llama.model.layer_0.attn.q_proj.lora_a``), so the stage-1 freeze rule
reads them as the JAX package reads its paths.  The optimizer is stage 2's
``GuardedAdamW`` over the trainable set, with two differences from stage
2's, both the JAX package's: the clip is ``cfg.train.grad_clip or 1.0``
(never off), and the regime is the stage-1 rule's, not
``cfg.train.freeze_regime``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from tsue_tpu_torch.config import ExperimentConfig
from tsue_tpu_torch.train.trainer import GuardedAdamW, TrainState


def stage1_freeze_label(path_strs: Tuple[str, ...],
                        regime: str = "lora_only") -> str:
    """"train" or "freeze": ``lora_only`` (the default) trains the LoRA
    adapters and everything outside the base Llama (Q-Former, projection,
    modality embeddings); ``joint`` trains everything."""
    in_llama = any(p == "llama" for p in path_strs)
    is_lora = any("lora" in p for p in path_strs)
    if regime == "joint":
        return "train"
    if in_llama and not is_lora:
        return "freeze"
    return "train"


def make_stage1_optimizer(cfg: ExperimentConfig, model: nn.Module,
                          regime: str = "lora_only",
                          mesh=None) -> GuardedAdamW:
    """Label every parameter with ``stage1_freeze_label``, set
    ``requires_grad`` from the label, and return AdamW(lr, weight_decay)
    behind the clip ``cfg.train.grad_clip or 1.0`` and, with
    ``cfg.train.nan_guard``, the non-finite guard over the trainable ones
    (``tsue_tpu/train/stage1.py:32-58``).  On a pipeline's mesh (``model``
    a stage's) the guard and the clip read the global gradient, the
    stage's own decoder layers once per stage
    (``tsue_tpu/parallel/pipeline.py:277-322``: in the layers only LoRA
    trains, which this rule says of them too)."""
    tcfg = cfg.train
    trainable = []
    for name, p in model.named_parameters():
        train = stage1_freeze_label(tuple(name.split(".")), regime) == "train"
        p.requires_grad_(train)
        if train:
            trainable.append(p)
    own = None
    if mesh is not None and mesh.pipe > 1:
        stack = model.llama.model
        layers = {id(p) for i in stack.layer_ids
                  for p in stack.get_submodule(f"layer_{i}").parameters()}
        own = [id(p) in layers for p in trainable]
    return GuardedAdamW(trainable, tcfg.lr, tcfg.weight_decay,
                        tcfg.grad_clip or 1.0, tcfg.nan_guard, mesh,
                        stage_own=own)


def make_stage1_train_step() -> Callable:
    """Returns ``step(state, batch, generator) -> {"lm_loss"}``, which
    updates ``state`` (model: a ``MultiModalLLM``) in place.  The loss is
    the masked causal-LM cross entropy over [img-span (-100) || prompt
    (-100) || answer] (ref scripts/check_generation.py:131-150); every
    dropout draws from ``generator``, the counterpart of the JAX step's
    ``rng`` (``fold_in(key(epoch), step)`` in ``run_stage1``)."""
    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> Dict:
        loss = state.model.lm_loss(batch.get("vision"), batch["input_ids"],
                                   batch["attention_mask"], batch["labels"],
                                   deterministic=False, generator=generator)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"lm_loss": loss.detach()}

    return step


def make_stage1_eval_step() -> Callable:
    """Returns ``step(state, batch) -> {"lm_loss"}``: the deterministic
    loss, no gradient."""
    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict:
        return {"lm_loss": state.model.lm_loss(
            batch.get("vision"), batch["input_ids"], batch["attention_mask"],
            batch["labels"])}
    return step
