"""Train and eval steps of the baseline models.

Counterpart of ``tsue_tpu/train/baseline_steps.py`` (the per-script loops
of ref scripts/baseline_*.py: AdamW or Adam on the denormalised MSE;
Trajectron adds 0.1 * KL, ref scripts/baseline_trajtron.py:241-243; GAIL
alternates BCE updates of D and G, ref scripts/baseline_GAIL.py:287-460).
A step updates its modules and optimizers in place; every random draw
(dropout, Trajectron's latent) comes from the generator it is given, as
the JAX step's from its key.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from tsue_tpu_torch.models.baselines import (CSLSTM, GAILDiscriminator,
                                             GAILGenerator, TrajectronPP)
from tsue_tpu_torch.models.baselines.trajectron import kl_divergence
from tsue_tpu_torch.train.losses import denorm_mse_loss

GAIL_EPS = 1e-6


def make_baseline_train_step(model: nn.Module,
                             optimizer: torch.optim.Optimizer,
                             kl_weight: float = 0.1) -> Callable:
    """Returns ``step(batch, generator) -> {"loss"}``: one train-mode
    forward (teacher-forced for CS-LSTM, ref
    scripts/baseline_cs_lstm.py:219-226; STGCNN's BatchNorm updates its
    running statistics from the batch; Trajectron draws its latent and adds
    ``kl_weight`` * KL), the loss's backward and one optimizer step."""
    is_cslstm = isinstance(model, CSLSTM)
    is_vae = isinstance(model, TrajectronPP)

    def step(batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> Dict:
        kwargs = {}
        if is_cslstm:
            kwargs["teacher"] = batch["traj_out"]
        if is_vae:
            kwargs["return_latent"] = True
        pred = model(batch, False, generator=generator, **kwargs)
        if is_vae:
            pred, (mu, logvar) = pred
        loss = denorm_mse_loss(pred, batch["traj_out"], batch["norm_stat"],
                               batch.get("valid"))
        if is_vae:
            loss = loss + kl_weight * kl_divergence(mu, logvar)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step


def make_baseline_eval_fn(model: nn.Module) -> Callable:
    """Returns ``candidates(batch, generator, K) -> (B, K, 2, T_out)``: K
    train-mode forwards (dropout, latent and BatchNorm's batch statistics
    live, as the JAX package's vmapped candidates), each over the whole
    batch, drawing from ``generator`` in turn; deterministic models give K
    equal candidates.  Each candidate's BatchNorm statistics are over its
    own rows, and the running statistics the forwards update are put back
    afterwards (the JAX package discards the mutated "batch_stats")."""
    @torch.no_grad()
    def candidates(batch: Dict[str, torch.Tensor],
                   generator: torch.Generator, K: int) -> torch.Tensor:
        saved = [(b, b.clone()) for b in model.buffers()]
        try:
            preds = [model(batch, False, generator=generator)
                     for _ in range(K)]
        finally:
            for buf, value in saved:
                buf.copy_(value)
        return torch.stack(preds, dim=1)

    return candidates


def make_gail_train_step(gen: GAILGenerator, disc: GAILDiscriminator,
                         g_opt: torch.optim.Optimizer,
                         d_opt: torch.optim.Optimizer,
                         adv_weight: float = 0.05) -> Callable:
    """Alternating GAN update (ref scripts/baseline_GAIL.py:287-460):
    ``step(batch) -> {"d_loss", "g_loss", "mse", "adv"}``.  D: BCE(real =
    1, fake = 0) on [history || future], the fake detached; then G:
    denorm-MSE + ``adv_weight`` * BCE(fake = 1) against the updated D."""
    def step(batch: Dict[str, torch.Tensor]) -> Dict:
        x = batch["traj_in"]
        with torch.no_grad():
            fake = gen(batch)
        d_loss = (-torch.mean(torch.log(disc(x, batch["traj_out"])
                                        + GAIL_EPS))
                  - torch.mean(torch.log(1 - disc(x, fake) + GAIL_EPS)))
        d_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        d_opt.step()

        # D is a constant of G's loss: its gradients stay D's own
        disc.requires_grad_(False)
        try:
            fake = gen(batch)
            mse = denorm_mse_loss(fake, batch["traj_out"],
                                  batch["norm_stat"], batch.get("valid"))
            adv = -torch.mean(torch.log(disc(x, fake) + GAIL_EPS))
            g_loss = mse + adv_weight * adv
            g_opt.zero_grad(set_to_none=True)
            g_loss.backward()
        finally:
            disc.requires_grad_(True)
        g_opt.step()
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                "mse": mse.detach(), "adv": adv.detach()}

    return step
