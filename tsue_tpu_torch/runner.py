"""Experiment runners: stage-1 MLLM fine-tuning and the stage-2 pipeline
(data, model, train loop, best-val restore, test metrics).

Counterpart of ``tsue_tpu/runner.py`` (``prepare_data``,
``build_model_and_params``, ``evaluate``, ``run_stage2``, ``run_stage1``;
ref scripts/train.py:1044-1328 ``train_ddp`` and
scripts/check_generation.py): a seeded split, windows built once, epochs
of train steps over shuffled fixed-size batches, the mean validation loss
per epoch.  Stage 2 restores the best epoch's trainable parameters before
the test (kept in memory), then reports deterministic ADE/FDE and, with
``eval_candidates`` K > 0, the fast K-candidate metrics.  Stage 1 trains
the MLLM's causal-LM loss, exports it (``train.checkpoint.export_mllm``)
for ``run_stage2(mllm_ckpt=...)`` and writes a generation dump.

It runs on the CUDA device unless it is given ``device="cpu"``, and never
falls back to the CPU on its own.  The ``TSUE_FUSED`` switch
(``ops.fused``) applies as everywhere in the port.  Not taken yet (ROADMAP
A: checkpoints on disk, the parity candidate mode, the rest of training,
parallel): ``restore_ckpt``, ``save_every``/``resume``, ``viz_every`` and
the per-epoch text sample, ``save_viz``, the parity candidate mode, remat,
bfloat16 training and stage 1's pipeline parallelism; each raises
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
from tsue_tpu_torch.models.fusion import MultiModalLLM
from tsue_tpu_torch.models.tsue import TrajectoryModel, init_params
from tsue_tpu_torch.train.checkpoint import export_mllm, import_mllm
from tsue_tpu_torch.train.stage1 import (make_stage1_eval_step,
                                         make_stage1_optimizer,
                                         make_stage1_train_step)
from tsue_tpu_torch.train.trainer import (TrainState, make_eval_step,
                                          make_optimizer, make_train_step)
from tsue_tpu_torch.utils import MetricLogger, seed_everything
from tsue_tpu_torch.utils.random import step_generator


def prepare_data(cfg: ExperimentConfig, data_path: Optional[str],
                 tokenizer, synthetic_tracks: int = 40,
                 return_tracks: bool = False):
    """pickle -> sanity -> seeded split -> windows; synthetic fallback
    (``synthetic_tracks`` tracks of 600 frames).  ``return_tracks`` appends
    the split's raw tracks (train, val, test)."""
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
    out = (build_windows(tr, cfg.data, tokenizer),
           build_windows(va, cfg.data, tokenizer),
           build_windows(te, cfg.data, tokenizer))
    if return_tracks:
        return out + ((tr, va, te),)
    return out


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


def _refuse_bf16(cfg: ExperimentConfig) -> None:
    if cfg.model.dtype != "float32":
        raise NotImplementedError(
            f"training with ModelConfig.dtype={cfg.model.dtype!r} is not "
            "ported yet (ROADMAP A: the rest of training); the training "
            "presets are float32")


def _vocab_resized(llama, tokenizer):
    """The Llama config with the tokenizer's vocabulary (the JAX package's
    resize, ``runner.py:336-340``, ``:746-747``)."""
    if llama.vocab_size == tokenizer.vocab_size:
        return llama
    return dataclasses.replace(llama, vocab_size=tokenizer.vocab_size)


def build_model_and_params(cfg: ExperimentConfig, tokenizer,
                           device="cuda", mllm_ckpt: Optional[str] = None
                           ) -> TrajectoryModel:
    """The model with its parameters: the vocabulary resized to the
    tokenizer's, random weights from ``cfg.train.seed`` (a generator on
    ``device``), fp32; then, with ``mllm_ckpt``, the stage-1 artifact
    loaded strictly into its MLLM (``train.checkpoint.import_mllm``)."""
    _refuse_bf16(cfg)
    model_cfg = cfg.model
    if model_cfg.use_llm:
        model_cfg = dataclasses.replace(
            model_cfg, llama=_vocab_resized(model_cfg.llama, tokenizer))
    dev = resolve_device(device)
    with torch.device(dev):
        model = TrajectoryModel(model_cfg, cfg.data.seq_len, cfg.data.out_len)
    init_params(model, torch.Generator(device=dev).manual_seed(cfg.train.seed))
    if mllm_ckpt:
        import_mllm(model, mllm_ckpt)       # the stage-1 handoff
    return model


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
            "(ROADMAP A: the parity candidate mode, candidate_rollout)")
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


# the ROADMAP A item that ports each refused option
_ITEM = dict(restore_ckpt="checkpoints on disk",
             save_every="checkpoints on disk", resume="checkpoints on disk",
             viz_every="the rest of training", save_viz="the rest of training",
             remat="the rest of training")


def _refuse(entry: str, **options) -> None:
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"{entry}({name}=...) is not ported yet (ROADMAP A: "
                f"{_ITEM[name]})")


def _train_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        # fp32 products stay fp32, as in the JAX package
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


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
    _refuse("run_stage2", restore_ckpt=restore_ckpt, save_every=save_every,
            resume=resume, viz_every=viz_every, save_viz=save_viz,
            remat=cfg.model.llama.remat)
    dev = _train_device(device)
    seed_everything(cfg.train.seed)
    logger = MetricLogger(os.path.join(out_dir, cfg.name))
    tokenizer = get_tokenizer(tokenizer_path)
    dtr, dva, dte = prepare_data(cfg, data_path, tokenizer, synthetic_tracks)
    print(f"windows: train={len(dtr)} val={len(dva)} test={len(dte)}")

    model = build_model_and_params(cfg, tokenizer, dev, mllm_ckpt)
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


def run_stage1(cfg: ExperimentConfig, data_path: Optional[str] = None,
               out_dir: str = "runs", epochs: Optional[int] = None,
               export_path: Optional[str] = None,
               synthetic_tracks: int = 20,
               generation_dump: Optional[str] = None,
               tokenizer_path: Optional[str] = None, device="cuda") -> Dict:
    """Stage-1 MLLM LM fine-tune and generation eval (ref
    scripts/check_generation.py flow, training included;
    ``tsue_tpu/runner.py:725-828``): a ``MultiModalLLM`` with the
    tokenizer's vocabulary and random weights from ``cfg.train.seed``, the
    ``lora_only`` stage-1 optimizer, epochs of train steps (step ``si`` of
    epoch ``e`` drops from ``step_generator(e, si)``), the mean validation
    LM loss per epoch, then the MLLM exported to ``export_path`` and, with
    ``generation_dump``, the test windows' generated contexts written
    there (inside ``<out_dir>/stage1_<name>``).  Returns
    ``{"final_lm_loss"}`` and, with the dump, ``"generated"``."""
    if cfg.mesh.pipeline_parallel > 1:
        raise NotImplementedError("run_stage1 with pipeline_parallel > 1 is "
                                  "not ported yet (ROADMAP A: parallel)")
    _refuse("run_stage1", remat=cfg.model.llama.remat)
    _refuse_bf16(cfg)
    dev = _train_device(device)
    seed_everything(cfg.train.seed)
    out_dir = os.path.join(out_dir, f"stage1_{cfg.name}")
    logger = MetricLogger(out_dir)
    tokenizer = get_tokenizer(tokenizer_path)
    dtr, dva, dte, raw = prepare_data(cfg, data_path, tokenizer,
                                      synthetic_tracks, return_tracks=True)
    print(f"windows: train={len(dtr)} val={len(dva)} test={len(dte)}")
    with torch.device(dev):
        mllm = MultiModalLLM(_vocab_resized(cfg.model.llama, tokenizer),
                             cfg.model.qformer, cfg.model.use_vision)
    init_params(mllm, torch.Generator(device=dev).manual_seed(cfg.train.seed))
    state = TrainState(mllm, make_stage1_optimizer(cfg, mllm), cfg.train.seed)
    train_step, eval_step = make_stage1_train_step(), make_stage1_eval_step()
    n_epochs = epochs if epochs is not None else cfg.train.epochs
    train_loss = float("nan")
    for epoch in range(n_epochs):
        # per-step losses stay on the device until the epoch ends
        losses = [train_step(state, to_device(b, dev),
                             step_generator(epoch, si, dev))["lm_loss"]
                  for si, b in enumerate(_batches(dtr, cfg, True, epoch))]
        val = [float(eval_step(state, to_device(b, dev))["lm_loss"])
               for b in _batches(dva, cfg, False)]
        train_loss = sum(float(x) for x in losses) / max(len(losses), 1)
        logger.log(epoch, lm_loss=train_loss,
                   val_lm_loss=float(np.mean(val)) if val else float("nan"))
    if export_path:
        export_mllm(mllm, export_path)      # run_stage2(mllm_ckpt=...)
    out = {"final_lm_loss": train_loss}
    if generation_dump:
        from tsue_tpu_torch.eval.generation import (
            distributed_generate_and_save)
        refs = {}
        for t in raw[2]:
            tid = t.get("track_id", t.get("id", -1))
            try:
                refs[int(tid)] = t.get("context_str", "")
            except (TypeError, ValueError):
                pass
        recs = distributed_generate_and_save(
            mllm, tokenizer, dte, os.path.join(out_dir, generation_dump),
            seed=9, max_new_tokens=48, reference_texts=refs)
        out["generated"] = len(recs)
    logger.close()
    return out
