"""Stage-2 experiment runner: data, model, train loop, best-val restore,
test metrics.

Counterpart of ``tsue_tpu/runner.py`` (``prepare_data``,
``build_model_and_params``, ``evaluate``, ``run_stage2``; ref
scripts/train.py:1044-1328 ``train_ddp``): a seeded split, windows built
once, epochs of train steps over shuffled fixed-size batches, the mean
validation loss per epoch, the best epoch's trainable parameters restored
before the test (kept in memory), then deterministic ADE/FDE and, with
``eval_candidates`` K > 0, the fast K-candidate metrics.

It runs on the CUDA device unless it is given ``device="cpu"``, and never
falls back to the CPU on its own.  The ``TSUE_FUSED`` switch
(``ops.fused``) applies as everywhere in the port.  Not taken yet (ROADMAP
A.9): ``mllm_ckpt``, ``restore_ckpt``, ``save_every``/``resume``,
``viz_every`` and the per-epoch text sample, ``save_viz``, the parity
candidate mode, remat and bfloat16 training; each raises
``NotImplementedError`` when asked for.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from tsue_tpu_torch.config import ExperimentConfig
from tsue_tpu_torch.data import (BatchIterator, build_windows,
                                 check_data_sanity, get_tokenizer,
                                 load_tracks, make_synthetic_tracks,
                                 split_tracks)
from tsue_tpu_torch.eval.metrics import (ade_fde, fast_candidate_rollout,
                                         min_ade_fde_rmse)
from tsue_tpu_torch.models.tsue import TrajectoryModel, init_params
from tsue_tpu_torch.train.trainer import (TrainState, make_eval_step,
                                          make_optimizer, make_train_step)
from tsue_tpu_torch.utils import MetricLogger, seed_everything


def prepare_data(cfg: ExperimentConfig, data_path: Optional[str],
                 tokenizer, synthetic_tracks: int = 40):
    """pickle -> sanity -> seeded split -> windows; synthetic fallback
    (``synthetic_tracks`` tracks of 600 frames)."""
    if data_path and os.path.exists(data_path):
        tracks = load_tracks(data_path)
    else:
        if data_path:
            print(f"[warn] {data_path} not found; using synthetic fixture")
        tracks = make_synthetic_tracks(num_tracks=synthetic_tracks,
                                       track_len=600,
                                       vision_dim=cfg.data.vision_dim,
                                       seed=cfg.data.split_seed)
    tracks = check_data_sanity(tracks)
    tr, va, te = split_tracks(tracks, cfg.data.train_ratio,
                              cfg.data.val_ratio, cfg.data.test_ratio,
                              seed=cfg.data.split_seed)
    return (build_windows(tr, cfg.data, tokenizer),
            build_windows(va, cfg.data, tokenizer),
            build_windows(te, cfg.data, tokenizer))


def resolve_device(device) -> torch.device:
    """The device to run on: a CUDA device must exist when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on the CUDA device by default and "
                           "none is available; pass device='cpu' to run on "
                           "the CPU")
    return dev


def to_device(batch: Dict[str, np.ndarray], device) -> Dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _batches(ds, cfg, shuffle, epoch=0):
    it = BatchIterator(ds, cfg.train.batch_size,
                       shuffle=shuffle, seed=cfg.train.seed,
                       length_buckets=cfg.data.length_buckets)
    it.set_epoch(epoch)
    return it


def build_model_and_params(cfg: ExperimentConfig, tokenizer,
                           device="cuda") -> TrajectoryModel:
    """The model with its parameters: the vocabulary resized to the
    tokenizer's, random weights from ``cfg.train.seed`` (a generator on
    ``device``), fp32."""
    if cfg.model.dtype != "float32":
        raise NotImplementedError(
            f"training with ModelConfig.dtype={cfg.model.dtype!r} is not "
            "ported yet (ROADMAP A.9); the training presets are float32")
    model_cfg = cfg.model
    if model_cfg.llama.vocab_size != tokenizer.vocab_size and \
            model_cfg.use_llm:
        model_cfg = dataclasses.replace(
            model_cfg, llama=dataclasses.replace(
                model_cfg.llama, vocab_size=tokenizer.vocab_size))
    dev = resolve_device(device)
    with torch.device(dev):
        model = TrajectoryModel(model_cfg, cfg.data.seq_len, cfg.data.out_len)
    return init_params(model,
                       torch.Generator(device=dev).manual_seed(cfg.train.seed))


@torch.no_grad()
def evaluate(model: TrajectoryModel, dte, cfg: ExperimentConfig,
             eval_candidates: int = 0, candidate_mode: str = "fast",
             eval_seed: int = 1000) -> Dict:
    """Test loop (ref train.py:1256-1328 / test.py:1279-1396): the
    sample-weighted mean of the deterministic ADE/FDE over the test windows
    (wrap-padded rows excluded) and, with K = ``eval_candidates``, the
    min-over-K ADE/FDE/RMSE of the fast rollout (the MLLM context once per
    batch, K dropout forecasts from a generator seeded ``eval_seed + i``
    for batch i), on the model's device."""
    if eval_candidates and (candidate_mode != "fast"
                            or not model.cfg.use_llm):
        raise NotImplementedError(
            "only the fast K-candidate rollout of a use_llm model is ported "
            "(ROADMAP A.7: candidate_rollout)")
    dev = next(model.parameters()).device
    per_batch = []
    for i, batch in enumerate(_batches(dte, cfg, False)):
        b = to_device(batch, dev)
        pred = model(b)
        a, f = ade_fde(pred, b["traj_out"], b["norm_stat"], b["valid"])
        entry = [a, f, b["valid"].sum()]
        if eval_candidates:
            gen = torch.Generator(device=dev).manual_seed(eval_seed + i)
            cands = fast_candidate_rollout(model, b, eval_candidates, gen)
            entry.extend(min_ade_fde_rmse(cands, b["traj_out"],
                                          b["norm_stat"], b["valid"]))
        per_batch.append(entry)
    ade_sum = fde_sum = n_sum = 0.0
    min_sums = np.zeros(3)
    for entry in per_batch:
        vals = [float(x) for x in entry]
        nv = vals[2]
        ade_sum += vals[0] * nv
        fde_sum += vals[1] * nv
        n_sum += nv
        if eval_candidates:
            min_sums += np.array(vals[3:6]) * nv
    n = max(n_sum, 1.0)
    out = {"test_ade": ade_sum / n if n_sum else float("nan"),
           "test_fde": fde_sum / n if n_sum else float("nan")}
    if eval_candidates and n_sum:
        m = min_sums / n
        out.update(min_ade=float(m[0]), min_fde=float(m[1]),
                   min_rmse=float(m[2]), K=eval_candidates)
    return out


def _refuse(**options) -> None:
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"run_stage2({name}=...) is not ported yet (ROADMAP A.9)")


def run_stage2(cfg: ExperimentConfig, data_path: Optional[str] = None,
               out_dir: str = "runs", mllm_ckpt: Optional[str] = None,
               epochs: Optional[int] = None, eval_candidates: int = 0,
               save_viz: bool = False, synthetic_tracks: int = 40,
               restore_ckpt: Optional[str] = None, viz_every: int = 0,
               candidate_mode: str = "fast",
               tokenizer_path: Optional[str] = None, save_every: int = 0,
               resume: bool = False, device="cuda") -> Dict:
    """Stage-2 pipeline; returns the test metrics dict (``test_ade``,
    ``test_fde`` and, with ``eval_candidates``, ``min_ade``, ``min_fde``,
    ``min_rmse``, ``K``), as the JAX package's ``run_stage2``.  Metrics
    go to ``<out_dir>/<cfg.name>/metrics.jsonl``."""
    _refuse(mllm_ckpt=mllm_ckpt, restore_ckpt=restore_ckpt,
            save_every=save_every, resume=resume, viz_every=viz_every,
            save_viz=save_viz, remat=cfg.model.llama.remat)
    dev = resolve_device(device)
    if dev.type == "cuda":
        # fp32 products stay fp32, as in the JAX package
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    seed_everything(cfg.train.seed)
    logger = MetricLogger(os.path.join(out_dir, cfg.name))
    tokenizer = get_tokenizer(tokenizer_path)
    dtr, dva, dte = prepare_data(cfg, data_path, tokenizer, synthetic_tracks)
    print(f"windows: train={len(dtr)} val={len(dva)} test={len(dte)}")

    model = build_model_and_params(cfg, tokenizer, dev)
    state = TrainState(model, make_optimizer(cfg, model), cfg.train.seed)
    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)
    best_val, best = float("inf"), None
    n_epochs = epochs if epochs is not None else cfg.train.epochs
    for epoch in range(n_epochs):
        # per-step losses stay on the device until the epoch ends
        step_losses = [train_step(state, to_device(b, dev))["loss"]
                       for b in _batches(dtr, cfg, True, epoch)]
        val_losses = [eval_step(state, to_device(b, dev))["loss"]
                      for b in _batches(dva, cfg, False)]
        train_loss = (sum(float(x) for x in step_losses)
                      / max(len(step_losses), 1))
        # empty val split: NaN (never "best") instead of a misleading 0
        val_loss = (sum(float(x) for x in val_losses) / len(val_losses)
                    if val_losses else float("nan"))
        logger.log(epoch, train_loss=train_loss, val_loss=val_loss)
        if math.isfinite(val_loss) and val_loss < best_val:
            best_val = val_loss
            best = {n: p.detach().clone()
                    for n, p in model.named_parameters() if p.requires_grad}

    # restore the best epoch's trainable parameters before the test (ref
    # train.py:1249-1252); frozen ones never changed
    if best is not None:
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in best:
                    p.copy_(best[n])
    metrics = evaluate(model, dte, cfg, eval_candidates, candidate_mode)
    logger.log(n_epochs, **metrics)
    logger.close()
    return metrics
