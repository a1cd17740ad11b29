"""Quantised-decode quality at Llama-3.2-1B's widths, in bf16 (the port's
``scripts/quality_quant.py``).

For each quantised decode mode, ``int8_w`` (int8 weights), ``int8_kv``
(the int8 KV cache) and ``both``, against the bf16 baseline, on a
MultiModalLLM whose parameters are all bf16 (``_common.build_mllm_bf16``):

1. greedy generation agreement over ``--max-new`` tokens: the share of rows
   whose whole sequence is equal, the share of equal tokens, and the mean
   length of the equal prefix;
2. the same for the default sampled chain, every arm drawing from a
   generator seeded alike;
3. teacher-forced logit drift: the baseline's own greedy tokens decoded
   through each mode, the logits of all ``max_new + 1`` steps (the first
   token's head and each decode step) against the baseline's: the largest
   and mean |dlogit|, the last step's largest, the share of equal argmaxes
   and the baseline logits' standard deviation.

    python -m tsue_tpu_torch.cli quality_quant [--bs 16] [--prompt-len 144]
        [--max-new 64] [--device cuda|cpu] [--tiny] [--llama-dir DIR]

Prints one JSON line with the JAX script's keys.  ``--tiny`` uses the tiny
Llama and Q-Former (a CPU run). ``--llama-dir`` loads the Llama's weights
from a local HF checkout (``models.llama_loader``) over the random ones;
``main(argv, hf_state=...)`` takes an HF-named state dict in memory.  After
a call, ``last_steps`` holds the decode steps each generation ran, by
"<chain>_<arm>" (the launch counts follow from them), and ``last_ids`` the
greedy ids of the baseline and of each arm, by arm.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import numpy as np
import torch

MODES = {"int8_w": (True, False), "int8_kv": (False, True),
         "both": (True, True)}      # (int8 weights, int8 KV cache)

last_steps: Dict[str, int] = {}
last_ids: Dict[str, np.ndarray] = {}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def set_quant(mllm, tables: Optional[dict], keys) -> None:
    """Attach ``tables`` (``ops.quant.quantize_llama_params``) or, with
    None, take the int8 tables of ``keys`` off again."""
    from tsue_tpu_torch.ops.quant import attach_quant
    attach_quant(mllm, tables if tables is not None
                 else {k: None for k in keys})


def agreement(ref: np.ndarray, out: np.ndarray) -> dict:
    eq = ref == out
    prefix = np.argmin(np.pad(eq, ((0, 0), (0, 1)), constant_values=False),
                       axis=1)
    return {"seq_agree": round(float(eq.all(axis=1).mean()), 4),
            "tok_agree": round(float(eq.mean()), 4),
            "mean_prefix": round(float(prefix.mean()), 1)}


@torch.inference_mode()
def rollout_logits(mllm, vision, ids, mask, toks: torch.Tensor,
                   quantize_kv: bool) -> torch.Tensor:
    """(N + 1, B, V) fp32 logits of the teacher-forced decode of ``toks``
    (B, N): the first token's head over the prefill's last hidden state,
    then one decode step per token."""
    from tsue_tpu_torch.ops.kv_quant import quantize_cache
    N = toks.shape[1]
    n_img = mllm.qformer.cfg.num_query_tokens if mllm.use_vision else 0
    cache_len = n_img + ids.shape[1] + N
    caches, last_hidden, prefix_len, fmask = mllm.prefill(
        vision, ids, mask, cache_len)
    if quantize_kv:
        caches = quantize_cache(caches)
    out = [mllm.llama.logits_from_hidden(last_hidden, quant_ok=True)]
    for step in range(N):
        out.append(mllm.decode_step(toks[:, step].long(), step, prefix_len,
                                    caches, fmask, cache_len))
    return torch.stack(out)


def drift(base: torch.Tensor, q: torch.Tensor) -> dict:
    d = (base - q).abs()
    return {"max_abs_dlogit": round(float(d.max()), 4),
            "mean_abs_dlogit": round(float(d.mean(dtype=torch.float64)), 5),
            "last_step_max": round(float(d[-1].max()), 4),
            "top1_agree": round(float(
                (base.argmax(-1) == q.argmax(-1)).double().mean()), 4),
            "logit_std": round(float(base.double().std(correction=0)), 3)}


def generate(mllm, cfg, N: int, vision, ids, mask, seed: int,
             quantize_kv: bool = False, fused_head: bool = False):
    """(ids (B, N) numpy, decode steps run) of one generation, drawing from
    a generator seeded with ``seed`` on the inputs' device."""
    from tsue_tpu_torch.eval.generation import make_generate_fn
    V = mllm.llama.cfg.vocab_size
    gen = make_generate_fn(mllm, cfg, N, ids.shape[1], eos_id=V - 1,
                           pad_id=0, quantize_kv=quantize_kv,
                           fused_head=fused_head)
    g = torch.Generator(device=ids.device).manual_seed(seed)
    out = gen(vision, ids, mask, g)
    return out.cpu().numpy(), gen.steps


def quality_study(mllm, vision, ids, mask, max_new: int, seed: int = 0
                  ) -> dict:
    """The three measurements above, as the JAX script's dict.  The int8
    tables are built once from the model's bf16 parameters and attached
    for the int8-weight arms only."""
    from tsue_tpu_torch.ops.quant import quantize_llama_params
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    tables = quantize_llama_params(mllm)
    N = max_new
    result = {}
    last_steps.clear()
    last_ids.clear()
    try:
        for sname, cfg in [("greedy", SamplingConfig(do_sample=False)),
                           ("sampled", SamplingConfig())]:
            set_quant(mllm, None, tables)
            ref, last_steps[f"{sname}_bf16"] = generate(
                mllm, cfg, N, vision, ids, mask, seed)
            if sname == "greedy":
                ref_toks = torch.from_numpy(ref).to(ids.device)
                last_ids["bf16"] = ref
            for mname, (w8, kv8) in MODES.items():
                set_quant(mllm, tables if w8 else None, tables)
                out, last_steps[f"{sname}_{mname}"] = generate(
                    mllm, cfg, N, vision, ids, mask, seed, quantize_kv=kv8)
                if sname == "greedy":
                    last_ids[mname] = out
                result[f"{sname}_{mname}"] = agreement(ref, out)
                log(sname, mname, result[f"{sname}_{mname}"])
        set_quant(mllm, None, tables)
        base = rollout_logits(mllm, vision, ids, mask, ref_toks, False)
        for mname, (w8, kv8) in MODES.items():
            set_quant(mllm, tables if w8 else None, tables)
            q = rollout_logits(mllm, vision, ids, mask, ref_toks, kv8)
            result[f"drift_{mname}"] = drift(base, q)
            log("drift", mname, result[f"drift_{mname}"])
            del q
    finally:
        set_quant(mllm, None, tables)
    return result


def main(argv=None, hf_state=None) -> dict:
    """``hf_state``: an HF-named Llama state dict loaded over the random
    Llama weights (``--llama-dir`` reads one from a local checkout)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bs", type=int, default=16)
    p.add_argument("--prompt-len", type=int, default=144)
    p.add_argument("--max-new", type=int, default=64)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--tiny", action="store_true",
                   help="the tiny Llama and Q-Former (a CPU run)")
    p.add_argument("--llama-dir", default=None,
                   help="local HF Llama checkout (*.safetensors or "
                        "pytorch_model*.bin) to load the Llama's weights from")
    args = p.parse_args(argv)
    from tsue_tpu_torch.cli._common import build_mllm_bf16, finish
    if args.llama_dir:
        from tsue_tpu_torch.models.llama_loader import read_hf_dir
        hf_state = read_hf_dir(args.llama_dir)
    llama = qformer = None
    if args.tiny:
        from tsue_tpu_torch.config import LlamaConfig, QFormerConfig
        llama = LlamaConfig.tiny()
        qformer = QFormerConfig(num_encoder_layers=1, num_decoder_layers=1,
                                num_query_tokens=4)
    mllm, (vision, ids, mask) = build_mllm_bf16(
        args.bs, args.prompt_len, device=args.device, llama=llama,
        qformer=qformer, hf_state=hf_state)
    log(f"device: {ids.device}")
    return finish(quality_study(mllm, vision, ids, mask, args.max_new))


if __name__ == "__main__":
    main()
