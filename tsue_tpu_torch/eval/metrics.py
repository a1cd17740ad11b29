"""Trajectory metrics: ADE/FDE and K-candidate minADE/minFDE/minRMSE.

Counterpart of ``tsue_tpu/eval/metrics.py``.  The K MC-dropout candidates
of the fast rollout are a written-out batch dimension: the forecaster runs
once over K*B rows, with its dropout masks drawn from one generator.  The
parity rollout runs the whole stochastic model K times in a loop, as the
reference does (ref scripts/test.py:1327-1339), each candidate from a
generator of its own, so its peak memory is one forward's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from tsue_tpu_torch.train.losses import denorm
from tsue_tpu_torch.utils.random import step_generator


def ade_fde(pred: torch.Tensor, target: torch.Tensor,
            norm_stat: torch.Tensor, valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean over samples of mean/final-step Euclidean error in pixels.
    pred/target: (B, 2, T) normalized; returns scalars (ade, fde)."""
    pd = denorm(pred, norm_stat)
    gt = denorm(target, norm_stat)
    dist = torch.sqrt(((pd - gt) ** 2).sum(dim=1) + 1e-12)     # (B, T)
    per_ade, per_fde = dist.mean(dim=1), dist[:, -1]
    if valid is None:
        return per_ade.mean(), per_fde.mean()
    w = valid.float()
    n = w.sum().clamp_min(1.0)
    return (per_ade * w).sum() / n, (per_fde * w).sum() / n


def candidate_rollout(model, batch: Dict[str, torch.Tensor],
                      num_candidates: int, seed: int,
                      stream: int = 0) -> torch.Tensor:
    """Parity mode: K stochastic forwards of the whole model (dropout in
    the lane encoder, the Q-Former, the LoRA adapters and the forecaster),
    the reference's ``model.train()``-inside-``no_grad`` sampling (ref
    scripts/test.py:1308-1309).  Candidate k drops from
    ``step_generator(seed, k)``, so it is reproducible and does not depend
    on K; ``stream`` (a data rank) draws another stream of each.
    Returns (B, K, 2, T_out)."""
    dev = batch["traj_in"].device
    preds = [model(batch, deterministic=False,
                   generator=step_generator(seed, k, dev, stream))
             for k in range(num_candidates)]
    return torch.stack(preds, dim=1)


def fast_candidate_rollout(model, batch: Dict[str, torch.Tensor],
                           num_candidates: int,
                           generator: torch.Generator) -> torch.Tensor:
    """Fast mode: the deterministic context (lane encoder, MLLM, the
    cross-attention K/V) is computed once; only the stochastic forecaster
    runs for the K candidates.  Returns (B, K, 2, T_out).  Row k*B + b of
    the forecaster batch is candidate k of window b."""
    K = num_candidates
    cross_kv, mask, poly = model.encode_context_kv(batch)
    x = batch["traj_in"]
    B = x.shape[0]

    def rep(t):
        return None if t is None else t.repeat((K,) + (1,) * (t.dim() - 1))

    if cross_kv is not None:
        cross_kv = (rep(cross_kv[0]), rep(cross_kv[1]))
    preds = model.forecast_kv({"traj_in": rep(x)}, cross_kv, rep(mask),
                              rep(poly), generator)
    return preds.reshape(K, B, *preds.shape[1:]).transpose(0, 1)


def min_ade_fde_rmse(cands: torch.Tensor, target: torch.Tensor,
                     norm_stat: torch.Tensor,
                     valid: Optional[torch.Tensor] = None):
    """Per-sample min over K candidates, averaged (ref scripts/test.py:
    1342-1376).  cands (B, K, 2, T) and target (B, 2, T), normalized.
    Returns (minADE, minFDE, minRMSE) scalars."""
    B, K, _, T = cands.shape
    pd = denorm(cands.reshape(B * K, 2, T),
                norm_stat.repeat_interleave(K, dim=0)).reshape(B, K, 2, T)
    gt = denorm(target, norm_stat)[:, None]                    # (B, 1, 2, T)
    sq = ((pd - gt) ** 2).sum(dim=2)                           # (B, K, T)
    dist = torch.sqrt(sq + 1e-12)
    ade_k, fde_k = dist.mean(dim=2), dist[:, :, -1]
    # the reference divides the summed squared error by 2T (mean over
    # coordinate and time, test.py:1370): sq sums the coordinates already
    rmse_k = torch.sqrt(sq.mean(dim=2) / 2.0 + 1e-12)
    mins = (ade_k.min(dim=1).values, fde_k.min(dim=1).values,
            rmse_k.min(dim=1).values)
    if valid is None:
        return tuple(m.mean() for m in mins)
    w = valid.float()
    n = w.sum().clamp_min(1.0)
    return tuple((m * w).sum() / n for m in mins)
