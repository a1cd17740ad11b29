"""Shared plumbing of the port's commands (the port's copy of
``scripts/_common.py``).

``base_parser`` takes the JAX scripts' flags, with ``--device {cuda,cpu}``
(the CUDA device by default) in place of ``--platform``; there is no
``--rng-impl``, which names JAX PRNG implementations.  ``apply_overrides``
maps the flags onto a preset as the JAX scripts do.  A flag whose work is
not ported yet is taken by the parser and raises ``NotImplementedError``,
naming its ROADMAP item, before any work (``refuse_not_ported``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

NOT_PORTED = (   # (flag, its dest, whether a value asks for the work, item)
    ("--model-parallel", "model_parallel", bool, "parallel"),
    ("--fsdp", "fsdp", bool, "parallel"),
    ("--pipeline-parallel", "pipeline_parallel", lambda v: v > 1,
     "parallel"),
)


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


def refuse_not_ported(args) -> None:
    """Raise ``NotImplementedError`` for the first flag of ``args`` whose
    work is not ported yet (``NOT_PORTED``); a flag the command does not
    take, or left unset, asks for nothing."""
    for flag, dest, asks, item in NOT_PORTED:
        value = getattr(args, dest, None)
        if value is not None and asks(value):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP A: {item})")


def finish(metrics: dict) -> dict:
    print(json.dumps(metrics))
    return metrics
