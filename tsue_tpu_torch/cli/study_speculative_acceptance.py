"""Speculative-decoding acceptance on trained weights: ``python -m
tsue_tpu_torch.cli study_speculative_acceptance [--epochs 100]`` (the
port's ``scripts/study_speculative_acceptance.py``).

On random weights no draft is accepted; this study measures the realistic
middle: the mid-size byte-level MLLM (``_common.midsize_cfg``) is
stage-1 fine-tuned on the synthetic traffic contexts until it generates
the templated paragraphs, then greedy generation from the prompts of the
first ``--bs`` windows of ``--split`` is timed plain against speculative
(``eval.speculative``, window ``--window``, prompt-lookup drafts of
``--draft-ngram``), the best of ``--reps`` calls each, in turns in one
process.  Prints one JSON line: ``tok_per_fwd`` (emitted tokens, up to
and including each row's first EOS, over the window forwards),
``token_agreement`` (the share of ids equal to the plain decode's),
``plain_tok_s``, ``spec_tok_s``, ``speedup``, ``final_lm_loss``,
``window``, ``epochs``, ``split``.

The track count is ``--synthetic-tracks or 20``, as in the JAX script:
with the parser's default of 40 that is 40 unless the flag is given (0
gives 20).  ``--tiny`` takes the tiny Llama and Q-Former for CPU runs
(``--device cpu``)."""
from __future__ import annotations

import dataclasses
import sys
import time

from tsue_tpu_torch.cli._common import (apply_overrides, base_parser,
                                        emitted, finish, midsize_cfg)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def greedy_config(processors: str):
    """Greedy decoding with the reference's processors (``"hf"``:
    repetition penalty 1.2, no-repeat-ngram 3) or none."""
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    if processors == "hf":
        return SamplingConfig(do_sample=False)
    return SamplingConfig(do_sample=False, repetition_penalty=1.0,
                          no_repeat_ngram_size=0)


def load_mllm(cfg, tokenizer, export: str, device):
    """A fresh ``MultiModalLLM`` at the tokenizer's vocabulary with the
    stage-1 export loaded strictly, in eval mode."""
    import torch
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    from tsue_tpu_torch.train.checkpoint import import_mllm
    llama = dataclasses.replace(cfg.model.llama,
                                vocab_size=tokenizer.vocab_size)
    with torch.device(device):
        mllm = MultiModalLLM(llama, cfg.model.qformer, cfg.model.use_vision)
    return import_mllm(mllm, export).eval()


def study_inputs(cfg, data_path, tokenizer, ntracks: int, split: str,
                 bs: int):
    """(vision, ids, mask) numpy: the prompt spans (``prompt_only``) of the
    first ``bs`` windows of the ``split`` ("train" or "test") of
    ``ntracks`` tracks, at the dataset's full text width."""
    import numpy as np
    from tsue_tpu_torch.eval.generation import prompt_only
    from tsue_tpu_torch.runner import prepare_data
    dtr, _, dte = prepare_data(cfg, data_path, tokenizer, ntracks)
    ds = dtr if split == "train" else dte
    b = ds.slice(np.arange(min(bs, len(ds)))).as_batch_dict()
    ids, mask = prompt_only(b)
    return np.asarray(b["vision"]), ids, mask


def parser():
    """The JAX script's flags (``base_parser``'s and the study's own)."""
    p = base_parser(__doc__)
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--draft-ngram", type=int, default=3)
    p.add_argument("--max-new", type=int, default=96)
    p.add_argument("--bs", type=int, default=16)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--processors", choices=("none", "hf"), default="none",
                   help="'hf' = repetition_penalty 1.2 + no_repeat_ngram 3 "
                        "(the reference's sampled-decode settings); at byte "
                        "granularity these penalize every character seen "
                        "before and derail templated text, so the realistic "
                        "byte-level serving configuration is 'none' (pure "
                        "greedy)")
    p.add_argument("--split", choices=("train", "test"), default="train",
                   help="prompt source: 'train' probes the converged, "
                        "memorized regime (the templated-serving case); "
                        "'test' probes held-out generalization")
    return p


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    import torch
    from tsue_tpu_torch.data import get_tokenizer
    from tsue_tpu_torch.eval.generation import (make_generate_fn,
                                                trim_and_decode)
    from tsue_tpu_torch.eval.speculative import make_speculative_generate_fn
    from tsue_tpu_torch.runner import resolve_device, run_stage1

    dev = resolve_device(args.device)
    log("device: " + (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"))
    cfg = apply_overrides(midsize_cfg("study_spec_accept"), args)
    epochs = args.epochs if args.epochs is not None else 100
    ntracks = args.synthetic_tracks or 20
    export = f"{args.out_dir}/spec_accept_mllm"
    log(f"stage-1 fine-tuning mid-size byte MLLM for {epochs} epochs...")
    t_start = time.perf_counter()
    out = run_stage1(cfg, args.data, args.out_dir, epochs=epochs,
                     export_path=export, synthetic_tracks=ntracks,
                     tokenizer_path=args.tokenizer, device=dev)
    t_train = time.perf_counter() - t_start
    log(f"final LM loss: {out['final_lm_loss']:.3f}")

    tokenizer = get_tokenizer(args.tokenizer)
    mllm = load_mllm(cfg, tokenizer, export, dev)
    inputs = [torch.from_numpy(a).to(dev) for a in study_inputs(
        cfg, args.data, tokenizer, ntracks, args.split, args.bs)]
    P = inputs[1].shape[1]

    greedy = greedy_config(args.processors)
    plain = make_generate_fn(mllm, greedy, args.max_new, P,
                             eos_id=tokenizer.eos_id, pad_id=tokenizer.pad_id)
    spec = make_speculative_generate_fn(
        mllm, greedy, args.max_new, P, eos_id=tokenizer.eos_id,
        pad_id=tokenizer.pad_id, window=args.window,
        draft_ngram=args.draft_ngram, with_stats=True)

    def call(fn):
        out = fn(*inputs, None)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    ref = call(plain).cpu().numpy()
    got, n_fwd = call(spec)
    got, n_fwd = got.cpu().numpy(), n_fwd.cpu().numpy()
    tok_spec = int(emitted(got, tokenizer.eos_id).sum())
    agree = float((got == ref).mean())
    tok_per_fwd = tok_spec / float(n_fwd.sum())
    log(f"tokens/forward: {tok_per_fwd:.2f} (emitted {tok_spec}, forwards "
        f"{int(n_fwd.sum())}); agreement {agree:.4f}")
    log(f"sample generation: {trim_and_decode(got[0], tokenizer)[:120]!r}")

    best = {"plain": float("inf"), "spec": float("inf")}
    for w in range(args.reps):
        for arm, fn in (("plain", plain), ("spec", spec)):
            t0 = time.perf_counter()
            call(fn)
            dt = time.perf_counter() - t0
            best[arm] = min(best[arm], dt)
            log(f"  w{w} {arm}: {dt * 1000:.0f} ms/call")
    log(f"study wall time: {time.perf_counter() - t_start:.1f}s (run_stage1 "
        f"{t_train:.1f}s)")
    return finish({
        "tok_per_fwd": round(tok_per_fwd, 2),
        "token_agreement": round(agree, 4),
        "plain_tok_s": round(int(emitted(ref, tokenizer.eos_id).sum())
                             / best["plain"], 1),
        "spec_tok_s": round(tok_spec / best["spec"], 1),
        "speedup": round(best["plain"] / best["spec"], 3),
        "final_lm_loss": round(out["final_lm_loss"], 3),
        "window": args.window, "epochs": epochs, "split": args.split})


if __name__ == "__main__":
    main()
