"""Experiment runners: stage-1 MLLM fine-tuning and the stage-2 pipeline
(data, model, train loop, best-val checkpoint, test metrics).

Counterpart of ``tsue_tpu/runner.py`` (``prepare_data``,
``build_model_and_params``, ``rebuild_for_eval``, ``evaluate``,
``run_stage2``, ``run_stage1``; ref scripts/train.py:1044-1328
``train_ddp``, scripts/test.py and scripts/check_generation.py): a seeded
split, windows built once, epochs of train steps over shuffled fixed-size
batches, the mean validation loss per epoch.  Stage 2 keeps the best
epoch's trainable parameters on disk (``train.checkpoint.BestCheckpointer``)
and restores them before the test, checkpoints the full train state every
``save_every`` epochs for an exact ``resume``, and evaluates a checkpoint
given as ``restore_ckpt``; it reports deterministic ADE/FDE and, with
``eval_candidates`` K > 0, the K-candidate metrics of the fast or the
parity rollout.  Stage 1 trains the MLLM's causal-LM loss, exports it
(``train.checkpoint.export_mllm``) for ``run_stage2(mllm_ckpt=...)`` and
writes a generation dump.

``run_baseline`` trains and scores the seven comparison baselines and
``run_diffusion`` the DDPM trajectory generator, as the JAX package's
runners of the same names.

A "bfloat16" ``ModelConfig`` trains stage 2 on bf16 parameters (cast after
init, as the JAX package's ``build_model_and_params`` casts them), with
AdamW's moments in bf16; stage 1 trains in fp32 whatever the dtype, as the
JAX package's ``run_stage1`` does.  ``LlamaConfig.remat`` rematerialises
the Llama's layers in both.  ``viz_every=N`` plots a validation sample and
generates a text sample every N epochs; ``save_viz`` plots the test's
first batch (matplotlib, imported then).

It runs on the CUDA device unless it is given ``device="cpu"``, and never
falls back to the CPU on its own.  The ``TSUE_FUSED`` switch
(``ops.fused``) applies as everywhere in the port.

``run_stage2`` runs on a mesh (``parallel.mesh``) when the process is one
of several (torchrun) or ``cfg.mesh`` asks for one: each rank takes its
data rank's rows of every batch, the model is placed by
``parallel.sharding`` (Megatron TP over ``cfg.mesh.model_parallel`` ranks,
FSDP2 over data with ``cfg.mesh.fsdp``, DDP over data otherwise), the
metrics are global on every rank, and only rank 0 writes
(``tsue_tpu/runner.py:136-155``, ``:226-242``); its train state is
gathered whole, so a sharded run saves and resumes the one-process file.
``run_stage1`` with ``cfg.mesh.pipeline_parallel > 1`` trains on the GPipe
pipeline of ``parallel.pipeline`` over a ``(data, pipe)`` mesh.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from tsue_tpu_torch.config import ExperimentConfig
from tsue_tpu_torch.data import (BatchIterator, build_windows,
                                 check_data_sanity, get_tokenizer,
                                 load_tracks, make_synthetic_tracks,
                                 split_tracks)
from tsue_tpu_torch.eval.metrics import (ade_fde, candidate_rollout,
                                         fast_candidate_rollout,
                                         min_ade_fde_rmse)
from tsue_tpu_torch.models.fusion import MultiModalLLM
from tsue_tpu_torch.models.tsue import TrajectoryModel, init_params
from tsue_tpu_torch.train.checkpoint import (BestCheckpointer, export_mllm,
                                             import_mllm, restore_merge,
                                             restore_train_state,
                                             save_train_state,
                                             train_state_path,
                                             trainable_filter)
from tsue_tpu_torch.train.stage1 import (make_stage1_eval_step,
                                         make_stage1_optimizer,
                                         make_stage1_train_step)
from tsue_tpu_torch.train.losses import denorm
from tsue_tpu_torch.train.trainer import (TrainState, make_eval_step,
                                          make_optimizer, make_train_step,
                                          set_trainable)
from tsue_tpu_torch.utils import MetricLogger, seed_everything
from tsue_tpu_torch.utils.precision import cast_params
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


def _batches(ds, cfg, shuffle, epoch=0, mesh=None):
    """The epoch's batches; under a mesh, the data rank's rows of each."""
    it = BatchIterator(ds, cfg.train.batch_size,
                       shuffle=shuffle, seed=cfg.train.seed,
                       process_index=mesh.data_rank if mesh else 0,
                       process_count=mesh.data if mesh else 1,
                       length_buckets=cfg.data.length_buckets)
    it.set_epoch(epoch)
    return it


def _vocab_resized(llama, tokenizer):
    """The Llama config with the tokenizer's vocabulary (the JAX package's
    resize, ``runner.py:336-340``, ``:746-747``)."""
    if llama.vocab_size == tokenizer.vocab_size:
        return llama
    return dataclasses.replace(llama, vocab_size=tokenizer.vocab_size)


def build_model_and_params(cfg: ExperimentConfig, tokenizer,
                           device="cuda", mllm_ckpt: Optional[str] = None,
                           cast: bool = True) -> TrajectoryModel:
    """The model with its parameters: the vocabulary resized to the
    tokenizer's, random weights from ``cfg.train.seed`` (a generator on
    ``device``), fp32, every floating parameter cast to bf16 for a
    "bfloat16" ``ModelConfig`` unless ``cast`` is False
    (``tsue_tpu/runner.py:347-349``); then, with ``mllm_ckpt``, the
    stage-1 artifact loaded strictly into its MLLM
    (``train.checkpoint.import_mllm``, in the MLLM's dtype)."""
    model_cfg = cfg.model
    if model_cfg.use_llm:
        model_cfg = dataclasses.replace(
            model_cfg, llama=_vocab_resized(model_cfg.llama, tokenizer))
    dev = resolve_device(device)
    with torch.device(dev):
        model = TrajectoryModel(model_cfg, cfg.data.seq_len, cfg.data.out_len)
    init_params(model, torch.Generator(device=dev).manual_seed(cfg.train.seed))
    if cast and cfg.model.dtype == "bfloat16":
        cast_params(model)
    if mllm_ckpt:
        import_mllm(model, mllm_ckpt)       # the stage-1 handoff
    return model


def _check_restore_meta(restore_ckpt: str, mllm_ckpt: Optional[str]):
    """Fail fast when a checkpoint whose training imported a stage-1 MLLM
    is evaluated without one.  Frozen-regime artifacts hold only the
    trainable subset; the frozen MLLM is rebuilt from the seed and the
    ``mllm_ckpt`` import, so without that import the restore would succeed
    and score a random-init LLM.  ``run_stage2`` writes ``meta.json``
    beside the artifact at train time (``tsue_tpu/runner.py:80-109``)."""
    meta_path = os.path.join(os.path.dirname(os.path.abspath(restore_ckpt)),
                             "meta.json")
    if not os.path.exists(meta_path):
        return
    with open(meta_path) as f:
        trained_with = json.load(f).get("mllm_ckpt")
    if trained_with and not mllm_ckpt:
        raise RuntimeError(
            f"checkpoint {restore_ckpt} was trained with a stage-1 MLLM "
            f"import ({trained_with}) but this eval run passes no "
            "mllm_ckpt; the frozen MLLM would be re-initialized randomly "
            "and the metrics would be silently wrong.  Pass "
            f"mllm_ckpt={trained_with!r} (or the equivalent artifact).")
    if trained_with and mllm_ckpt and \
            os.path.abspath(mllm_ckpt) != os.path.abspath(trained_with):
        print(f"[warn] eval mllm_ckpt {mllm_ckpt} differs from the one "
              f"recorded at train time ({trained_with})")


def rebuild_for_eval(cfg: ExperimentConfig, data_path: Optional[str],
                     out_dir: str, tokenizer_path: Optional[str] = None,
                     synthetic_tracks: int = 40,
                     mllm_ckpt: Optional[str] = None, device="cuda"):
    """Rebuild the model and data as ``run_stage2`` did and restore its
    best-val artifact (``<out_dir>/<cfg.name>/ckpt/best``), through the one
    shared ``build_model_and_params``: a frozen-regime artifact holds only
    the trainable subset, so the frozen one must be rebuilt bit for bit.
    The parameters' ``requires_grad`` follows the freeze regime, as in
    ``run_stage2``, so ``evaluate`` gives its metrics bit for bit.
    Returns ``(model, (dtr, dva, dte))``."""
    dev = _train_device(device)
    seed_everything(cfg.train.seed)
    tokenizer = get_tokenizer(tokenizer_path)
    splits = prepare_data(cfg, data_path, tokenizer, synthetic_tracks)
    model = build_model_and_params(cfg, tokenizer, dev, mllm_ckpt)
    set_trainable(model, cfg.train.freeze_regime)
    BestCheckpointer(
        os.path.join(out_dir, cfg.name, "ckpt"),
        trainable_filter(model, cfg.train.freeze_regime)).restore_best(model)
    return model, splits


@torch.no_grad()
def evaluate(model: TrajectoryModel, dte, cfg: ExperimentConfig,
             eval_candidates: int = 0, candidate_mode: str = "fast",
             eval_seed: int = 1000, viz_dir: Optional[str] = None,
             mesh=None) -> Dict:
    """Test loop (ref train.py:1256-1328 / test.py:1279-1396): the
    sample-weighted mean of the deterministic ADE/FDE over the test windows
    (wrap-padded rows excluded) and, with K = ``eval_candidates``, the
    min-over-K ADE/FDE/RMSE, on the model's device.  The candidates of
    batch i come from seed ``eval_seed + i``, routed as the JAX package's
    ``evaluate`` routes them: ``candidate_mode == "fast"`` on a ``use_llm``
    model takes the fast rollout (the MLLM context once, K dropout
    forecasts), every other case the parity rollout (K whole stochastic
    forwards).  ``viz_dir``: the first test batch's first window is plotted
    into ``<viz_dir>/viz`` (``tsue_tpu/runner.py:457-477``).

    Under a mesh each rank scores its data rank's rows (its candidates
    from the batch's seed folded with the data rank) and the sums of
    (ADE n, FDE n, n) and the candidate metrics are all-reduced over data,
    so every rank returns the global metrics (``tsue_tpu/runner.py:
    397-440``); the plot is made by a single process only."""
    fast = candidate_mode == "fast" and model.cfg.use_llm
    dev = next(model.parameters()).device
    per_batch = []
    first = None
    dp = mesh is not None and mesh.data > 1
    for i, batch in enumerate(_batches(dte, cfg, False, mesh=mesh)):
        b = to_device(batch, dev)
        pred = model(b)
        cands = None
        if eval_candidates:
            if fast:
                gen = torch.Generator(device=dev).manual_seed(eval_seed + i)
                if dp:
                    gen = step_generator(eval_seed + i, 0, dev,
                                         stream=mesh.data_rank)
                cands = fast_candidate_rollout(model, b, eval_candidates, gen)
            else:
                cands = candidate_rollout(model, b, eval_candidates,
                                          eval_seed + i,
                                          mesh.data_rank if dp else 0)
        per_batch.append(_batch_metrics(b, pred, cands))
        if first is None:
            first = (b, pred, cands)
    out = _test_metrics(per_batch, eval_candidates, mesh)
    if viz_dir and first is not None and (mesh is None or mesh.size == 1):
        _plot_test_batch(os.path.join(viz_dir, "viz"), *first)
    return out


def _test_metrics(per_batch, eval_candidates: int, mesh=None) -> Dict:
    """The sample-weighted means of per-batch entries [ADE, FDE, valid
    rows, (minADE, minFDE, minRMSE with K candidates)], read from the
    device once all batches are queued: ``test_ade``, ``test_fde`` and,
    with K and any valid row, ``min_ade``, ``min_fde``, ``min_rmse``,
    ``K``.  Under a mesh the weighted sums are summed over data first."""
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
    if mesh is not None and mesh.data > 1:
        from tsue_tpu_torch.parallel.mesh import all_reduce_scalars
        tot = all_reduce_scalars([ade_sum, fde_sum, n_sum, *min_sums],
                                 mesh.data_group, mesh.device)
        ade_sum, fde_sum, n_sum = (float(x) for x in tot[:3])
        min_sums = tot[3:]
    n = max(n_sum, 1.0)
    out = {"test_ade": ade_sum / n if n_sum else float("nan"),
           "test_fde": fde_sum / n if n_sum else float("nan")}
    if eval_candidates and n_sum:
        m = min_sums / n
        out.update(min_ade=float(m[0]), min_fde=float(m[1]),
                   min_rmse=float(m[2]), K=eval_candidates)
    return out


def _batch_metrics(b, pred, cands=None) -> list:
    """One test batch's entry for ``_test_metrics`` (device scalars)."""
    a, f = ade_fde(pred, b["traj_out"], b["norm_stat"], b["valid"])
    entry = [a, f, b["valid"].sum()]
    if cands is not None:
        entry.extend(min_ade_fde_rmse(cands, b["traj_out"], b["norm_stat"],
                                      b["valid"]))
    return entry


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _plot_test_batch(d: str, b, pred, cands) -> None:
    """The test's PNGs of one window (past, truth, prediction; x and y over
    time; the K candidates and the best of K), in pixels."""
    from tsue_tpu_torch.viz import (plot_best_of_k, plot_candidates,
                                    plot_one_sample, plot_xy_time)
    ns = b["norm_stat"]
    past = _np(denorm(b["traj_in"], ns))
    gt = _np(denorm(b["traj_out"], ns))
    pd = _np(denorm(pred, ns))
    plot_one_sample(past[0], gt[0], pd[0], d, prefix="test")
    plot_xy_time(gt[0], [pd[0]], d, prefix="test_xy_time")
    if cands is not None:
        K = cands.shape[1]
        cd = _np(denorm(cands[0], ns[:1].repeat_interleave(K, dim=0)))
        plot_candidates(past[0], gt[0], cd, d, prefix="test_candidates")
        plot_best_of_k(past[0], gt[0], cd, d, prefix="test_best_of_k")


def _epoch_text_sample(model: TrajectoryModel, tokenizer, batch,
                       generator: torch.Generator,
                       max_new_tokens: int = 48) -> str:
    """One traffic-context paragraph generated from the first row of a
    validation batch, by the model's MLLM in its own dtype
    (``tsue_tpu/runner.py:289-325``, ref scripts/train.py:1231-1241): the
    prompt span (``prompt_only``), the default sampling, decoded and cut
    as the stage-1 generation harness does (``trim_and_decode``)."""
    from tsue_tpu_torch.eval.generation import (make_generate_fn,
                                                prompt_only, trim_and_decode)
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    dev = batch["input_ids"].device
    ids, prompt_mask = prompt_only(
        {k: v[:1].cpu().numpy() for k, v in batch.items()
         if k in ("attention_mask", "labels", "input_ids")})
    gen = make_generate_fn(model.mllm, SamplingConfig(), max_new_tokens,
                           ids.shape[1], tokenizer.eos_id, tokenizer.pad_id)
    vision = (batch["vision"][:1] if "vision" in batch
              and model.cfg.use_vision else None)
    out = gen(vision, torch.from_numpy(ids).to(dev),
              torch.from_numpy(prompt_mask).to(dev), generator)
    return trim_and_decode(out[0].cpu().numpy(), tokenizer)


def _epoch_viz(model, state, eval_step, tokenizer, dva, cfg, run_dir: str,
               epoch: int, dev) -> None:
    """The per-epoch qualitative samples (``tsue_tpu/runner.py:236-262``):
    the first validation window's prediction plotted into
    ``<run_dir>/viz/epoch<NNNN>_0.png`` and, for a model with an LLM, a
    text sample appended to ``<run_dir>/generated_samples.txt``, drawn from
    ``step_generator(777, epoch)`` (the JAX package's ``fold_in(key(777),
    epoch)``)."""
    from tsue_tpu_torch.viz import plot_one_sample
    vb = to_device(next(iter(_batches(dva, cfg, False))), dev)
    pred = eval_step(state, vb)["pred"]
    ns = vb["norm_stat"]
    plot_one_sample(_np(denorm(vb["traj_in"], ns))[0],
                    _np(denorm(vb["traj_out"], ns))[0],
                    _np(denorm(pred, ns))[0], os.path.join(run_dir, "viz"),
                    prefix=f"epoch{epoch:04d}")
    if cfg.model.use_llm and "input_ids" in vb:
        text = _epoch_text_sample(model, tokenizer, vb,
                                  step_generator(777, epoch, dev))
        print(f"[epoch {epoch}] generated sample: {text}")
        with open(os.path.join(run_dir, "generated_samples.txt"), "a") as f:
            f.write(f"[epoch {epoch}] {text}\n")


def _train_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        # fp32 products stay fp32, and bf16 products sum in fp32, as in the
        # JAX package
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return dev


def run_stage2(cfg: ExperimentConfig, data_path: Optional[str] = None,
               out_dir: str = "runs", mllm_ckpt: Optional[str] = None,
               epochs: Optional[int] = None, eval_candidates: int = 0,
               save_viz: bool = False, synthetic_tracks: int = 40,
               restore_ckpt: Optional[str] = None, viz_every: int = 0,
               candidate_mode: str = "fast",
               tokenizer_path: Optional[str] = None, save_every: int = 0,
               resume: bool = False, device="cuda", mesh=None) -> Dict:
    """Stage-2 pipeline; returns the test metrics dict (``test_ade``,
    ``test_fde`` and, with ``eval_candidates``, ``min_ade``, ``min_fde``,
    ``min_rmse``, ``K``), as the JAX package's ``run_stage2``.  Metrics
    go to ``<out_dir>/<cfg.name>/metrics.jsonl``, the best epoch's
    trainable parameters to ``<out_dir>/<cfg.name>/ckpt/best``.

    ``restore_ckpt``: an artifact (full, or the trainable subset) merged
    over the model before anything else; with ``epochs=0`` this is the
    reference's eval flow (ref scripts/test.py:1273-1276).
    ``save_every=N`` writes the full train state (``ckpt/state``: step,
    trainable parameters, optimizer, epoch, best val loss) every N epochs;
    ``resume=True`` restores it and continues, so an interrupted run
    equals the uninterrupted one exactly (a step's dropout draws from
    ``step_generator(seed, step)``, an epoch's shuffle from the epoch).

    ``viz_every=N``: every N epochs (epoch % N == 0), the first validation
    window plotted into ``<out_dir>/<cfg.name>/viz`` and, for a model with
    an LLM, one generated context appended to ``generated_samples.txt``
    there.  ``save_viz``: the test's first window plotted there too.

    ``mesh``: a ``parallel.mesh.Mesh``; without one, a process that is
    one of several (torchrun), or a ``cfg.mesh`` asking for TP or FSDP,
    makes its own (``make_mesh(cfg.mesh.model_parallel)`` on ``device``).
    Every rank builds the one-process model from the seed, then keeps its
    shard; rank 0 alone writes the metrics, ``meta.json``, the best
    artifact and the train state, each gathered whole (the one-process
    file: ``tsue_tpu/runner.py:192-206``, ``:264-268``), and every rank
    also keeps the best artifact's shard in memory; a resume cuts the file
    to each rank's shards.  The per-epoch samples run in one process
    only."""
    if restore_ckpt:
        _check_restore_meta(restore_ckpt, mllm_ckpt)
    mesh = _stage2_mesh(cfg, mesh, device)
    dev = _train_device(mesh.device if mesh is not None else device)
    seed_everything(cfg.train.seed)
    run_dir = os.path.join(out_dir, cfg.name)
    primary = mesh is None or mesh.is_primary()
    logger = MetricLogger(run_dir) if primary else None
    tokenizer = get_tokenizer(tokenizer_path)
    dtr, dva, dte = prepare_data(cfg, data_path, tokenizer, synthetic_tracks)
    if primary:
        print(f"windows: train={len(dtr)} val={len(dva)} test={len(dte)}")

    model = build_model_and_params(cfg, tokenizer, dev, mllm_ckpt)
    if restore_ckpt:
        restore_merge(restore_ckpt, model)
    tfilter = trainable_filter(model, cfg.train.freeze_regime)
    state = _place_for_training(cfg, model, mesh)
    model = state.model
    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)
    ckpt = BestCheckpointer(os.path.join(run_dir, "ckpt"), tfilter,
                            mesh=mesh)
    n_epochs = epochs if epochs is not None else cfg.train.epochs
    if n_epochs > 0 and primary:
        # provenance for _check_restore_meta: which stage-1 artifact, if
        # any, rebuilt the frozen subtree
        with open(os.path.join(ckpt.directory, "meta.json"), "w") as f:
            json.dump({"name": cfg.name,
                       "freeze_regime": cfg.train.freeze_regime,
                       "use_llm": cfg.model.use_llm,
                       "seq_len": cfg.data.seq_len,
                       "out_len": cfg.data.out_len,
                       "mllm_ckpt": (os.path.abspath(mllm_ckpt)
                                     if mllm_ckpt else None)}, f)
    state_dir = os.path.join(ckpt.directory, "state")
    start_epoch = 0
    if resume:
        if train_state_path(state_dir):
            _, extra = restore_train_state(state_dir, state,
                                           trainable_filter=tfilter)
            start_epoch, ckpt.best_val = extra["epoch"], extra["best_val"]
            print(f"[resume] epoch {start_epoch}, step {state.step}, "
                  f"best_val {ckpt.best_val:.6g}")
        else:
            # loud: a mistyped out_dir or a crash before the first save
            # would otherwise restart at epoch 0 over old artifacts
            print(f"[resume] nothing to resume at {state_dir}; training "
                  "from scratch")
    for epoch in range(start_epoch, n_epochs):
        # per-step losses stay on the device until the epoch ends
        step_losses = [train_step(state, to_device(b, dev))["loss"]
                       for b in _batches(dtr, cfg, True, epoch, mesh)]
        val_losses = [eval_step(state, to_device(b, dev))["loss"]
                      for b in _batches(dva, cfg, False, mesh=mesh)]
        train_loss = (sum(float(x) for x in step_losses)
                      / max(len(step_losses), 1))
        # empty val split: NaN (never "best") instead of a misleading 0
        val_loss = (sum(float(x) for x in val_losses) / len(val_losses)
                    if val_losses else float("nan"))
        if logger is not None:
            logger.log(epoch, train_loss=train_loss, val_loss=val_loss)
        ckpt.maybe_save(val_loss, model)
        if viz_every and epoch % viz_every == 0 and len(dva) and \
                (mesh is None or mesh.size == 1):
            _epoch_viz(model, state, eval_step, tokenizer, dva, cfg, run_dir,
                       epoch, dev)
        if save_every and (epoch + 1) % save_every == 0:
            save_train_state(state_dir, state, epoch=epoch + 1,
                             best_val=ckpt.best_val,
                             trainable_filter=tfilter)

    # restore the best epoch's trainable parameters before the test (ref
    # train.py:1249-1252); frozen ones never changed
    if n_epochs > 0 and ckpt.best_val < float("inf"):
        ckpt.restore_best(model)
    metrics = evaluate(model, dte, cfg, eval_candidates, candidate_mode,
                       viz_dir=run_dir if save_viz else None, mesh=mesh)
    if logger is not None:
        logger.log(n_epochs, **metrics)
        logger.close()
    return metrics


def _stage2_mesh(cfg: ExperimentConfig, mesh, device):
    """The mesh ``run_stage2`` runs on: the one given, or its own when the
    process is one of several or ``cfg.mesh`` asks for TP or FSDP; None
    for one plain process."""
    from tsue_tpu_torch.parallel.mesh import distributed, make_mesh
    if mesh is not None:
        return mesh
    if distributed() or cfg.mesh.model_parallel > 1 or cfg.mesh.fsdp:
        return make_mesh(cfg.mesh.model_parallel, device=device)
    return None


def _place_for_training(cfg: ExperimentConfig, model: TrajectoryModel, mesh,
                        fsdp_min_size: Optional[int] = None) -> TrainState:
    """The train state over ``model`` (one-process, full) placed on
    ``mesh``: the rank's TP shard (a local-shard model loaded with its cut
    of the state), FSDP2 over data with ``cfg.mesh.fsdp``, DDP over data
    otherwise (``tsue_tpu/runner.py:148-155``)."""
    if mesh is None or mesh.size == 1:
        return TrainState(model, make_optimizer(cfg, model), cfg.train.seed)
    from tsue_tpu_torch.parallel.serve_tp import load_shards
    from tsue_tpu_torch.parallel.sharding import (FSDP_MIN_SIZE,
                                                  apply_fsdp)
    if mesh.model > 1:
        with torch.device(mesh.device):
            local = TrajectoryModel(model.cfg, cfg.data.seq_len,
                                    cfg.data.out_len, mesh=mesh)
        load_shards(local, model.state_dict(), mesh)
        model = local
    set_trainable(model, cfg.train.freeze_regime)
    forward = None
    if mesh.data > 1:
        if cfg.mesh.fsdp:
            apply_fsdp(model, mesh, FSDP_MIN_SIZE if fsdp_min_size is None
                       else fsdp_min_size)
        else:
            forward = torch.nn.parallel.DistributedDataParallel(
                model, process_group=mesh.data_group,
                broadcast_buffers=False, find_unused_parameters=True)
    return TrainState(model, make_optimizer(cfg, model, mesh),
                      cfg.train.seed, mesh=mesh, forward=forward)


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
    ``{"final_lm_loss"}`` and, with the dump, ``"generated"``.

    The MLLM is built without a dtype, so it trains in fp32 whatever
    ``ModelConfig.dtype`` says, as the JAX package's ``run_stage1`` builds
    it (``tsue_tpu/runner.py:747-753``); ``LlamaConfig.remat`` applies.

    ``cfg.mesh.pipeline_parallel`` = pp > 1 trains on the GPipe pipeline
    (``parallel.pipeline``; ``tsue_tpu/runner.py:755-809``) over a
    ``(data, pipe)`` mesh of torchrun's processes (the group joined here
    if it is not yet: NCCL, or gloo on the CPU): every rank builds the
    whole MLLM from the seed and keeps its stage; each data rank trains on
    its rows of every batch, in ``cfg.mesh.microbatches`` clamped to the
    largest divisor of its rows.  Afterwards the stages' layers are joined
    on every rank (``gather_stages``), rank 0 exports the one-process
    artifact and writes the dump, which every data rank helps generate."""
    mesh = _pipeline_mesh(cfg, device)
    dev = _train_device(mesh.device if mesh is not None else device)
    primary = mesh is None or mesh.is_primary()
    seed_everything(cfg.train.seed)
    out_dir = os.path.join(out_dir, f"stage1_{cfg.name}")
    logger = MetricLogger(out_dir) if primary else None
    tokenizer = get_tokenizer(tokenizer_path)
    dtr, dva, dte, raw = prepare_data(cfg, data_path, tokenizer,
                                      synthetic_tracks, return_tracks=True)
    if primary:
        print(f"windows: train={len(dtr)} val={len(dva)} test={len(dte)}")
    with torch.device(dev):
        mllm = MultiModalLLM(_vocab_resized(cfg.model.llama, tokenizer),
                             cfg.model.qformer, cfg.model.use_vision)
    init_params(mllm, torch.Generator(device=dev).manual_seed(cfg.train.seed))
    if mesh is None:
        state = TrainState(mllm, make_stage1_optimizer(cfg, mllm),
                           cfg.train.seed)
        one_step, eval_step = (make_stage1_train_step(),
                               make_stage1_eval_step())

        def train_step(state, b, epoch, si):
            return one_step(state, b, step_generator(epoch, si, dev))
    else:
        from tsue_tpu_torch.parallel.pipeline import (
            make_pipelined_stage1_step, stage_of)
        stage = stage_of(mllm, mesh)
        del mllm
        state = TrainState(stage, make_stage1_optimizer(cfg, stage,
                                                        mesh=mesh),
                           cfg.train.seed, mesh=mesh)
        train_step, eval_step = make_pipelined_stage1_step(
            mesh, _microbatch_count(cfg, mesh))
    n_epochs = epochs if epochs is not None else cfg.train.epochs
    train_loss = float("nan")
    for epoch in range(n_epochs):
        # per-step losses stay on the device until the epoch ends
        losses = [train_step(state, to_device(b, dev), epoch, si)["lm_loss"]
                  for si, b in enumerate(_batches(dtr, cfg, True, epoch,
                                                  mesh))]
        val = [float(eval_step(state, to_device(b, dev))["lm_loss"])
               for b in _batches(dva, cfg, False, mesh=mesh)]
        train_loss = sum(float(x) for x in losses) / max(len(losses), 1)
        if logger is not None:
            logger.log(epoch, lm_loss=train_loss, val_lm_loss=float(
                np.mean(val)) if val else float("nan"))
    if mesh is not None:
        # back to the one process's tree, joined on the host as the JAX
        # package joins it (``tsue_tpu/runner.py:803-809``); the stage is
        # freed before the whole model is built on the device
        from tsue_tpu_torch.parallel.pipeline import gather_stages
        whole = gather_stages(stage, mesh, "cpu")
        del state, stage
        with torch.device(dev):
            mllm = MultiModalLLM(_vocab_resized(cfg.model.llama, tokenizer),
                                 cfg.model.qformer, cfg.model.use_vision)
        mllm.load_state_dict(whole)
        del whole
    if export_path and primary:
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
            seed=9, max_new_tokens=48, reference_texts=refs, mesh=mesh)
        out["generated"] = len(recs)
    if logger is not None:
        logger.close()
    return out


def _pipeline_mesh(cfg: ExperimentConfig, device):
    """The ``(data, pipe)`` mesh of ``cfg.mesh.pipeline_parallel`` > 1
    over torchrun's processes (the group joined where it is not:
    ``parallel.mesh.join_torchrun``); None for one plain process.  Raises
    where the degree does not divide the world or the batch the data
    axis."""
    pp = cfg.mesh.pipeline_parallel
    if pp <= 1:
        return None
    from tsue_tpu_torch.parallel.mesh import join_torchrun
    from tsue_tpu_torch.parallel.pipeline import make_pipeline_mesh
    join_torchrun(device)
    mesh = make_pipeline_mesh(pp, device)
    if cfg.train.batch_size % mesh.data:
        raise ValueError(f"batch_size={cfg.train.batch_size} must be "
                         "divisible by the data-parallel degree "
                         f"{mesh.data}")
    return mesh


def _microbatch_count(cfg: ExperimentConfig, mesh) -> int:
    """``cfg.mesh.microbatches`` clamped to the largest divisor of a data
    rank's rows (an upper bound, as in ``tsue_tpu/runner.py:766-774``)."""
    B, dp = cfg.train.batch_size, mesh.data
    n = max(m for m in range(1, cfg.mesh.microbatches + 1)
            if B % (m * dp) == 0)
    if mesh.is_primary():
        print(f"pipeline: pp={mesh.pipe} dp={dp} microbatches={n}")
    return n


def _no_text_cfg(cfg: ExperimentConfig) -> ExperimentConfig:
    """The configuration without text or vision inputs (the baselines and
    the DDPM generator read trajectories and lane polygons only)."""
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, use_text=False, use_vision=False))


def _seeded(module, dev, seed: int):
    """``module`` on ``dev`` with random weights from ``seed``."""
    module = module.to(dev)
    return init_params(module, torch.Generator(device=dev).manual_seed(seed))


def run_baseline(name: str, cfg: ExperimentConfig,
                 data_path: Optional[str] = None, out_dir: str = "runs",
                 epochs: Optional[int] = None, eval_candidates: int = 0,
                 synthetic_tracks: int = 40, device="cuda") -> Dict:
    """Baseline pipeline (ref scripts/baseline_*.py main flows;
    ``tsue_tpu/runner.py:479-586``): ``name`` one of
    ``models.baselines.BASELINE_NAMES``.  "cv" trains nothing and scores
    its K = ``eval_candidates or 10`` noisy candidates; "gail" trains the
    alternating GAN (``_run_gail``); the others train their registry model
    (random weights from seed 0, AdamW(lr, weight_decay); step ``si`` of
    epoch ``e`` draws from ``step_generator(e, si)``) and score the
    deterministic forward and, with K = ``eval_candidates``, K train-mode
    candidates (batch i from seed 100 + i), plotting the first test
    window's candidates into ``<out_dir>/baseline_<name>/viz``.  Returns
    ``test_ade``, ``test_fde`` and, with K, ``min_ade``, ``min_fde``,
    ``min_rmse``, ``K``; metrics go to
    ``<out_dir>/baseline_<name>/metrics.jsonl``."""
    from tsue_tpu_torch.models.baselines import (BASELINE_NAMES,
                                                 BASELINE_REGISTRY,
                                                 cv_candidates)
    from tsue_tpu_torch.train.baseline_steps import (make_baseline_eval_fn,
                                                     make_baseline_train_step)
    if name not in BASELINE_NAMES:
        raise KeyError(f"unknown baseline {name!r}; have {BASELINE_NAMES}")
    dev = _train_device(device)
    seed_everything(cfg.train.seed)
    out_dir = os.path.join(out_dir, f"baseline_{name}")
    logger = MetricLogger(out_dir)
    cfg = _no_text_cfg(cfg)
    dtr, dva, dte = prepare_data(cfg, data_path, None, synthetic_tracks)
    print(f"windows: train={len(dtr)} val={len(dva)} test={len(dte)}")

    if name == "cv":  # no training (ref baseline_cv.py)
        K = eval_candidates or 10
        per_batch = []
        for i, batch in enumerate(_batches(dte, cfg, False)):
            b = to_device(batch, dev)
            cands = cv_candidates(b["traj_in"], cfg.data.out_len,
                                  torch.Generator(device=dev).manual_seed(i),
                                  K, 0.1)
            per_batch.append(_batch_metrics(b, cands[:, 0], cands))
        out = _test_metrics(per_batch, K)
        if "K" not in out:                    # no test window
            out.update(min_ade=float("nan"), min_fde=float("nan"),
                       min_rmse=float("nan"), K=K)
        logger.log(0, **out)
        logger.close()
        return out

    if name == "gail":
        return _run_gail(cfg, dtr, dte, logger, epochs, eval_candidates, dev)

    model = _seeded(BASELINE_REGISTRY[name](seq_len=cfg.data.seq_len,
                                            out_len=cfg.data.out_len), dev, 0)
    step = make_baseline_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=cfg.train.lr,
        weight_decay=cfg.train.weight_decay, eps=1e-8))
    n_epochs = epochs if epochs is not None else cfg.train.epochs
    for epoch in range(n_epochs):
        # per-step losses stay on the device until the epoch ends
        losses = [step(to_device(b, dev), step_generator(epoch, si, dev))
                  ["loss"]
                  for si, b in enumerate(_batches(dtr, cfg, True, epoch))]
        logger.log(epoch, train_loss=(
            sum(float(x) for x in losses) / max(len(losses), 1)))

    # test (sample-weighted like evaluate())
    eval_fn = make_baseline_eval_fn(model)
    per_batch = []
    with torch.no_grad():
        for i, batch in enumerate(_batches(dte, cfg, False)):
            b = to_device(batch, dev)
            cands = (eval_fn(b, torch.Generator(device=dev).manual_seed(
                100 + i), eval_candidates) if eval_candidates else None)
            per_batch.append(_batch_metrics(b, model(b), cands))
    out = _test_metrics(per_batch, eval_candidates)
    if eval_candidates and len(dte):
        # candidate visualization (ref test_baseline_stgcnn.py:342-489)
        from tsue_tpu_torch.viz import plot_candidates
        b = to_device(next(iter(_batches(dte, cfg, False))), dev)
        cands = eval_fn(b, torch.Generator(device=dev).manual_seed(99),
                        eval_candidates)
        ns = b["norm_stat"]
        cd = _np(denorm(cands[0], ns[:1].repeat_interleave(eval_candidates,
                                                           dim=0)))
        plot_candidates(_np(denorm(b["traj_in"], ns))[0],
                        _np(denorm(b["traj_out"], ns))[0], cd,
                        os.path.join(out_dir, "viz"),
                        prefix=f"{name}_candidates")
    logger.log(n_epochs, **out)
    logger.close()
    return out


def _run_gail(cfg, dtr, dte, logger, epochs, eval_candidates: int, dev):
    """GAIL's part of ``run_baseline`` (``tsue_tpu/runner.py:589-650``):
    generator and discriminator from seeds 0 and 1, Adam(lr) each, one D
    then one G update a step; the test scores the noise-free generator
    and, with K, K candidates with output noise 0.05 (batch i from seed
    500 + i, ref scripts/baseline_GAIL.py:441-460)."""
    from tsue_tpu_torch.models.baselines import (GAILDiscriminator,
                                                 GAILGenerator)
    from tsue_tpu_torch.train.baseline_steps import make_gail_train_step
    lens = dict(seq_len=cfg.data.seq_len, out_len=cfg.data.out_len)
    gen = _seeded(GAILGenerator(**lens), dev, 0)
    disc = _seeded(GAILDiscriminator(**lens), dev, 1)
    step = make_gail_train_step(
        gen, disc, torch.optim.Adam(gen.parameters(), lr=cfg.train.lr),
        torch.optim.Adam(disc.parameters(), lr=cfg.train.lr))
    n_epochs = epochs if epochs is not None else cfg.train.epochs
    for epoch in range(n_epochs):
        ms = [step(to_device(b, dev))
              for b in _batches(dtr, cfg, True, epoch)]
        n = max(len(ms), 1)
        logger.log(epoch, g_loss=sum(float(m["g_loss"]) for m in ms) / n,
                   d_loss=sum(float(m["d_loss"]) for m in ms) / n)
    per_batch = []
    with torch.no_grad():
        for i, batch in enumerate(_batches(dte, cfg, False)):
            b = to_device(batch, dev)
            cands = None
            if eval_candidates:
                g = torch.Generator(device=dev).manual_seed(500 + i)
                cands = torch.stack([gen(b, noise_scale=0.05, generator=g)
                                     for _ in range(eval_candidates)], 1)
            per_batch.append(_batch_metrics(b, gen(b), cands))
    out = _test_metrics(per_batch, eval_candidates)
    logger.log(n_epochs, **out)
    logger.close()
    return out


def run_diffusion(cfg: ExperimentConfig, data_path: Optional[str] = None,
                  out_dir: str = "runs", epochs: Optional[int] = None,
                  cfg_scale: float = 3.0, n_timestep: int = 1000,
                  n_samples: int = 5, synthetic_tracks: int = 40,
                  device="cuda") -> Dict:
    """DDPM generate mode (ref capstone_project.py:1138-1423;
    ``tsue_tpu/runner.py:653-722``): train the conditional UNet (random
    weights from seed 0) on the future trajectories scaled to [-1, 1]
    under a zero placeholder condition, Adam(1e-4) with coupled L2 1e-4
    (torch Adam's ``weight_decay``, the reference's) and an EMA copy after
    every step (step ``i`` of epoch ``e`` draws from ``step_generator(e,
    i)``), then ``n_samples`` guided reverse chains of ``n_timestep`` steps
    with the EMA weights (the chains' draws from seed 7), plotted against
    the first test window's X/Y over time into
    ``<out_dir>/diffusion/viz``.  Returns ``final_diff_loss`` (the last
    epoch's mean) and ``samples``."""
    from tsue_tpu_torch.models.diffusion import (ConditionalUNet,
                                                 DDPMSchedule,
                                                 make_diffusion_train_step,
                                                 p_sample_loop)
    dev = _train_device(device)
    seed_everything(cfg.train.seed)
    out_dir = os.path.join(out_dir, "diffusion")
    logger = MetricLogger(out_dir)
    cfg = _no_text_cfg(cfg)
    dtr, _, dte = prepare_data(cfg, data_path, None, synthetic_tracks)

    model = _seeded(ConditionalUNet(), dev, 0)
    ema = copy.deepcopy(model).requires_grad_(False)
    sched = DDPMSchedule.create("cosine", n_timestep)
    # ref: torch.optim.Adam(lr=diffusion_lr=1e-4, weight_decay=1e-4),
    # capstone_project.py:1194-1196: L2 added to the gradient before the
    # moments (the JAX package's add_decayed_weights then adam)
    step = make_diffusion_train_step(
        model, sched, torch.optim.Adam(model.parameters(), lr=1e-4,
                                       weight_decay=1e-4), ema, cfg_scale)
    n_epochs = epochs if epochs is not None else 20  # ref diffusion_epochs=20
    tl, tn = 0.0, 0
    for epoch in range(n_epochs):
        losses = []   # device scalars; fetched once per epoch
        for i, batch in enumerate(_batches(dtr, cfg, True, epoch)):
            x0 = torch.from_numpy(batch["traj_out"]).to(dev) * 2.0 - 1.0
            cond = torch.zeros(x0.shape[0], 128, device=dev)  # ref :1218-1221
            losses.append(step(x0, cond, step_generator(epoch, i, dev))
                          ["loss"])
        tl, tn = sum(float(x) for x in losses), len(losses)
        logger.log(epoch, diff_loss=tl / max(tn, 1))

    # sampling with the EMA weights (ref ema.apply_shadow, :1282)
    cond = torch.zeros(2 * n_samples, 128, device=dev)
    out = p_sample_loop(ema, sched, (2 * n_samples, 2, cfg.data.out_len),
                        cond, torch.Generator(device=dev).manual_seed(7),
                        cfg_scale)
    guided = _np(out[n_samples:])                 # cond half (CFG-combined)
    if len(dte):
        from tsue_tpu_torch.viz import plot_xy_time
        plot_xy_time(np.asarray(dte.traj_out[0]) * 2.0 - 1.0, list(guided),
                     os.path.join(out_dir, "viz"), prefix="ddpm_samples")
    metrics = {"final_diff_loss": tl / max(tn, 1) if n_epochs
               else float("nan"), "samples": int(n_samples)}
    logger.log(n_epochs, **metrics)
    logger.close()
    return metrics
