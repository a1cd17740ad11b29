"""Shared plumbing of the port's commands (the port's copy of
``scripts/_common.py``).

``base_parser`` takes the JAX scripts' flags, with ``--device {cuda,cpu}``
(the CUDA device by default) in place of ``--platform``; there is no
``--rng-impl``, which names JAX PRNG implementations.  ``apply_overrides``
maps the flags onto a preset as the JAX scripts do.  ``add_roi_args`` and
``resolve_roi`` are the lane-ROI flags of the map commands,
``build_mllm_bf16`` the bf16 decode substrate of ``quality_quant``, and
``midsize_cfg`` and ``emitted`` the mid-size configuration and the token
count of the two trained-weight studies.

``add_mesh_args`` (--model-parallel, --fsdp) and ``setup_mesh`` run a
command over a (data, model) mesh: under torchrun (``python -m
torch.distributed.run --nproc_per_node N -m tsue_tpu_torch.cli ...``)
each process joins the group (NCCL on the card, gloo with --device cpu),
and on the card rank 0 builds the kernels before the others load them
(``parallel.mesh.join_torchrun``, which ``run_stage1`` calls itself for
``stage1 --pipeline-parallel``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--data", default=None,
                   help="path to all_data.pkl (synthetic fixture if absent)")
    p.add_argument("--out-dir", default="runs")
    p.add_argument("--epochs", type=int, default=None,
                   help="override preset epoch count")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--synthetic-tracks", type=int, default=40)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model config (smoke runs)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="run on the CUDA device (default) or the CPU (the "
                        "kernels' plain versions)")
    p.add_argument("--tokenizer", default=None,
                   help="local HF tokenizer path/name (byte tokenizer if "
                        "unset or unavailable)")
    p.add_argument("--loss-chunk", type=int, default=None,
                   help="compute the LM loss in sequence chunks of this "
                        "size (no (B, T, V) logits; same numerics)")
    p.add_argument("--remat", action="store_true",
                   help="per-layer Llama rematerialization (activation "
                        "memory for a recompute in the backward)")
    p.add_argument("--remat-policy", default=None,
                   choices=("full", "dots", "dots_no_batch"),
                   help="checkpoint policy under remat (implies --remat): "
                        "full recomputes the layer, dots saves every "
                        "matrix product, dots_no_batch the 2-D ones")
    p.add_argument("--length-buckets", default=None,
                   help="comma-separated static text-length buckets (e.g. "
                        "256,384,512, the preset default); 'none' disables "
                        "bucketing")
    return p


def add_mesh_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model-parallel", type=int, default=0,
                   help="tensor-parallel degree: ranks of a model group "
                        "(must divide the world size; launch with "
                        "torchrun)")
    p.add_argument("--fsdp", action="store_true",
                   help="with --model-parallel: also shard the large "
                        "parameters over the data axis (FSDP2)")


def check_mesh_args(p: argparse.ArgumentParser, args) -> None:
    """--fsdp needs --model-parallel (``scripts/serve.py:260-261``)."""
    if getattr(args, "fsdp", False) and not args.model_parallel:
        p.error("--fsdp requires --model-parallel")


def setup_mesh(args):
    """The mesh a command runs on, or None for one plain process: joins
    the process group (``parallel.mesh.join_torchrun``) and lays out
    ``--model-parallel`` (``parallel.mesh.make_mesh``, which raises where
    it does not divide the world)."""
    from tsue_tpu_torch.parallel.mesh import join_torchrun, make_mesh
    several = join_torchrun(args.device)
    mp = getattr(args, "model_parallel", 0) or 0
    if not (several or mp > 1):
        return None
    return make_mesh(max(mp, 1), device=args.device)


def with_mesh(cfg, args):
    """``cfg`` with ``--model-parallel``/``--fsdp`` in its MeshConfig."""
    if not getattr(args, "model_parallel", 0):
        return cfg
    return dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, model_parallel=args.model_parallel, fsdp=args.fsdp))


def parse_length_buckets(spec: str):
    """'256,384,512' -> (256, 384, 512); 'none'/''/'0' -> ()."""
    if spec.strip().lower() in ("none", "", "0", "off"):
        return ()
    try:
        buckets = tuple(sorted(int(s) for s in spec.split(",")))
    except ValueError:
        raise SystemExit(f"--length-buckets: cannot parse {spec!r} "
                         "(want e.g. 256,384,512 or 'none')")
    if any(b <= 0 for b in buckets):
        raise SystemExit("--length-buckets: buckets must be positive")
    return buckets


def add_roi_args(p: argparse.ArgumentParser) -> None:
    """--roi/--site/--zone for the lane-ROI map commands (roi_map, plot)."""
    p.add_argument("--roi", default=None,
                   help="lane-ROI table: reference graph.py-format .py, "
                        ".json, or .pkl; the literal 'synthetic' selects "
                        "the parametric stand-in (default: --data's table, "
                        "else the vendored Site-C reference table)")
    p.add_argument("--site", default=None,
                   help="site key in the ROI table (default: auto when the "
                        "table has exactly one site, else an error listing "
                        "the available keys)")
    p.add_argument("--zone", default=None, help="zone key (same defaulting)")


def resolve_roi(args):
    """The lane ROI, by precedence: --roi table > --data pickle > the
    vendored Site-C reference table; ``--roi synthetic`` is the parametric
    stand-in."""
    from tsue_tpu_torch.data.schema import (load_lane_roi, load_tracks,
                                            load_vendored_lane_roi,
                                            make_synthetic_lane_roi)
    if args.roi == "synthetic":
        return make_synthetic_lane_roi()
    if args.roi:
        return load_lane_roi(args.roi)
    if args.data:
        return load_tracks(args.data)[0]["lane_roi"]
    return load_vendored_lane_roi()


def build_mllm_bf16(batch_size: int = 16, prompt_len: int = 144,
                    vocab: int = 128256, device="cuda", llama=None,
                    qformer=None, hf_state=None, seed: int = 0):
    """A MultiModalLLM with every parameter bf16, and synthetic inputs: the
    decode substrate of ``quality_quant`` (``scripts/_common.py:190-214``).
    ``llama``/``qformer`` default to Llama-3.2-1B at ``vocab`` and the
    default Q-Former.  The weights are drawn by ``models.tsue.init_params``
    from ``torch.Generator(device).manual_seed(seed)`` (the Flax
    initialisers' distributions); ``hf_state``, an HF-named Llama state
    dict, then replaces the Llama's base weights through
    ``models.llama_loader.load_hf_llama``.  The inputs come from
    ``numpy.random.default_rng(0)``, as the JAX copy draws them: vision
    (B, 18, vision_dim) fp32, ids (B, P) int32 in [3, min(vocab, 50000)),
    an all-ones mask.  Returns (mllm, (vision, ids, mask)) on ``device``,
    the model in eval mode."""
    import numpy as np
    import torch
    from tsue_tpu_torch.config import LlamaConfig, QFormerConfig
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    from tsue_tpu_torch.models.tsue import init_params
    from tsue_tpu_torch.utils.precision import cast_params
    llama = llama or LlamaConfig(vocab_size=vocab)
    qformer = qformer or QFormerConfig()
    dev = torch.device(device)
    with torch.device(dev):
        mllm = MultiModalLLM(llama, qformer, dtype=torch.bfloat16)
    init_params(mllm, torch.Generator(device=dev).manual_seed(seed))
    cast_params(mllm, torch.bfloat16)
    if hf_state is not None:
        from tsue_tpu_torch.models.llama_loader import load_hf_llama
        load_hf_llama(mllm.llama, hf_state)
    rng = np.random.default_rng(0)
    vision = torch.from_numpy(rng.standard_normal(
        (batch_size, 18, qformer.vision_dim)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(
        3, min(llama.vocab_size, 50000),
        (batch_size, prompt_len)).astype(np.int32)).to(dev)
    mask = torch.ones(batch_size, prompt_len, dtype=torch.int32, device=dev)
    return mllm.eval(), (vision, ids, mask)


def midsize_cfg(name: str, freeze_regime: str = "frozen_mllm"):
    """The studies' mid-size stack (``scripts/study_fast_vs_parity.py:27-44``
    and ``scripts/study_speculative_acceptance.py:27-43``, which differ
    only in ``name`` and the fast-vs-parity study's ``"joint"`` regime): a
    Llama of 4 layers, hidden 256, 8 query and 4 KV heads of 32,
    intermediate 1024, vocabulary 384; a Q-Former of hidden 128, 8 heads,
    2 + 2 layers and 8 query tokens; the default lane encoder and LTSF;
    18 -> 18 windows, text up to 640 tokens, batch 16."""
    from tsue_tpu_torch.config import (DataConfig, ExperimentConfig,
                                       LaneEncoderConfig, LlamaConfig,
                                       LTSFConfig, ModelConfig,
                                       QFormerConfig, TrainConfig)
    llama = LlamaConfig(vocab_size=384, hidden_size=256,
                        intermediate_size=1024, num_layers=4, num_heads=8,
                        num_kv_heads=4, head_dim=32, rope_scaling_factor=1.0)
    model = ModelConfig(
        llama=llama,
        qformer=QFormerConfig(hidden_size=128, num_heads=8,
                              num_encoder_layers=2, num_decoder_layers=2,
                              num_query_tokens=8),
        lane=LaneEncoderConfig(), ltsf=LTSFConfig())
    return ExperimentConfig(
        name=name, data=DataConfig(seq_len=18, out_len=18, max_length=640),
        model=model,
        train=TrainConfig(batch_size=16, freeze_regime=freeze_regime))


def emitted(rows, eos_id: int):
    """(B,) int64: the tokens each generated id row holds, up to and
    including its first EOS, the whole row without one; the speculative
    study counts their sum (``scripts/study_speculative_acceptance.py:
    127-132``)."""
    import numpy as np
    rows = np.asarray(rows)
    hit = rows == eos_id
    return np.where(hit.any(axis=1), hit.argmax(axis=1) + 1, rows.shape[1])


def apply_overrides(cfg, args):
    """The preset ``cfg`` with the parsed flags applied, as
    ``scripts/_common.py:apply_overrides`` applies them."""
    tr = cfg.train
    if args.batch_size is not None:
        tr = dataclasses.replace(tr, batch_size=args.batch_size)
    if args.lr is not None:
        tr = dataclasses.replace(tr, lr=args.lr)
    cfg = dataclasses.replace(cfg, train=tr)
    if getattr(args, "length_buckets", None) is not None:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data,
            length_buckets=parse_length_buckets(args.length_buckets)))
    ms = cfg.mesh
    if getattr(args, "pipeline_parallel", None):
        ms = dataclasses.replace(ms, pipeline_parallel=args.pipeline_parallel)
    if getattr(args, "microbatches", None):
        ms = dataclasses.replace(ms, microbatches=args.microbatches)
    if ms is not cfg.mesh:
        cfg = dataclasses.replace(cfg, mesh=ms)
    if getattr(args, "tiny", False):
        from tsue_tpu_torch.config import (LaneEncoderConfig, LlamaConfig,
                                           LTSFConfig, QFormerConfig)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model,
            llama=LlamaConfig.tiny(),
            qformer=QFormerConfig(num_encoder_layers=1, num_decoder_layers=1,
                                  num_query_tokens=4),
            lane=LaneEncoderConfig(d_model=16, nhead=2, num_layers=1),
            ltsf=LTSFConfig(d_model=16, polygon_embed_dim=16)))
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, max_length=640))
    # after --tiny so the flags survive the tiny LlamaConfig swap
    if getattr(args, "loss_chunk", None) is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, llama=dataclasses.replace(
                cfg.model.llama, loss_chunk=args.loss_chunk)))
    if getattr(args, "remat", False) or getattr(args, "remat_policy", None):
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, llama=dataclasses.replace(
                cfg.model.llama, remat=True,
                remat_policy=(args.remat_policy or
                              cfg.model.llama.remat_policy))))
    return cfg


def finish(metrics: dict) -> dict:
    """Print the command's JSON line (rank 0 only under torchrun)."""
    from tsue_tpu_torch.parallel.mesh import is_primary
    if is_primary():
        print(json.dumps(metrics))
    return metrics
