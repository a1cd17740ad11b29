"""Batched text generation: soft-prefix prefill + KV-cached sampled decode.

Counterpart of ``tsue_tpu/eval/generation.py`` (``head_arrays``, the
generator of ``make_generate_fn``, ``postprocess_text``, ``prompt_only``,
``trim_and_decode``, ``generate_texts`` and
``distributed_generate_and_save``): condition on the fused [image-tokens ||
prompt] prefix, decode with the HF-semantics sampler of
``ops/sampling.py``, stop each sequence at EOS, and cut the text at the
reference's "No right-following vehicle." marker.

The JAX package runs the decode as one compiled ``while_loop`` over fixed
``scan`` chunks; here it is a Python loop over the same chunks (of the same
rebalanced size), with one host check of ``all(finished)`` per chunk —
the only point where the loop waits for the device.  Options, as in the
JAX package:

- ``fused_head``: sample from ``ops.lmhead_topk`` (the (B, V) logits are
  never materialised) fed by ``MultiModalLLM.decode_hidden``;
- ``quantize_kv``: quantise the prefilled cache (fp32, or bf16 for a
  model whose parameters are bf16) to int8 once and
  decode over it (``ops.kv_quant``);
- int8 weights are not an option here: they are used when the Predictor
  has attached the tables (``ops.quant.attach_quant``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from tsue_tpu_torch.ops.sampling import SamplingConfig, process_and_sample
from tsue_tpu_torch.parallel.sharding import grad_free

CUTOFF_MARKER = "No right-following vehicle."


def head_arrays(mllm):
    """LM-head weights for the fused sampler: (the raw tied embedding
    (V, D) in the parameters' dtype, fp32 or bf16, None), or (None,
    (lm_head_w8, lm_head_scale)) when int8 tables are attached.  A sharded
    model's whole table (``llama.head_table``, placed by
    ``parallel.serve_tp``) stands in for its shard."""
    llama = mllm.llama
    whole = llama.head_table
    if llama.lm_head_w8 is not None:
        return None, (whole if whole is not None
                      else (llama.lm_head_w8, llama.lm_head_scale))
    if not llama.cfg.tie_word_embeddings:
        raise NotImplementedError(
            "fused_head needs the tied embedding (V, D) layout or the int8 "
            "tables; the untied head is a Dense")
    return (whole if whole is not None
            else llama.model.embed_tokens.weight), None


class DecodeProgram:
    """The generator of ``make_generate_fn``: a callable (vision,
    prompt_ids, prompt_mask, generator) -> (B, max_new_tokens) int32 ids.
    ``steps`` holds the decode steps the last call executed; on a CUDA
    device ``timing_ms()`` gives its (prefill, decode) device times from
    three CUDA events recorded on the stream (read once the ids are on the
    host)."""

    def __init__(self, mllm, cfg: SamplingConfig, max_new_tokens: int,
                 prompt_len: int, eos_id: int, pad_id: int = 0,
                 early_exit_chunk: Optional[int] = 8,
                 fused_head: bool = False, quantize_kv: bool = False):
        from tsue_tpu_torch.ops.lmhead_topk import LANES
        V = mllm.llama.cfg.vocab_size
        if fused_head:
            if V % LANES:
                raise ValueError(f"fused_head needs vocab_size % {LANES} == 0")
            if cfg.do_sample and not 0 < cfg.top_k < LANES:
                raise ValueError(f"fused_head needs 0 < top_k < {LANES}")
        self.mllm = mllm
        self.cfg = cfg
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.fused_head = fused_head
        self.quantize_kv = quantize_kv
        self.vocab_size = V
        n_img = mllm.qformer.cfg.num_query_tokens if mllm.use_vision else 0
        chunk = early_exit_chunk or max_new_tokens
        chunk = max(1, min(chunk, max_new_tokens))
        n_chunks = -(-max_new_tokens // chunk)
        if n_chunks:      # balance: ceil(max_new / n) pads at most n-1 steps
            chunk = -(-max_new_tokens // n_chunks)
        self.chunk, self.n_chunks = chunk, n_chunks
        self.total = n_chunks * chunk
        self.cache_len = n_img + prompt_len + self.total
        self.steps = 0
        self._events = None

    @grad_free("mllm")
    def __call__(self, vision: Optional[torch.Tensor],
                 prompt_ids: torch.Tensor, prompt_mask: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        from tsue_tpu_torch.ops import lmhead_topk as LT
        from tsue_tpu_torch.ops.kv_quant import quantize_cache
        mllm, cfg = self.mllm, self.cfg
        B = prompt_ids.shape[0]
        dev = prompt_ids.device
        events = None
        if dev.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            events[0].record()
        caches, last_hidden, prefix_len, fmask = mllm.prefill(
            vision, prompt_ids, prompt_mask, self.cache_len)
        if events is not None:
            events[1].record()
        if self.quantize_kv:
            caches = quantize_cache(caches)
        if self.fused_head:
            head = last_hidden
            w_head, quant_head = head_arrays(mllm)
            use_mask = (cfg.repetition_penalty != 1.0
                        or cfg.no_repeat_ngram_size > 0)
        else:
            head = mllm.llama.logits_from_hidden(last_hidden, quant_ok=True)
        # the token history for the penalty and the n-gram ban starts with
        # the prompt (HF sees the prompt ids, ref train.py:625)
        history = torch.cat([prompt_ids.to(torch.int64),
                             torch.full((B, self.total), self.pad_id,
                                        dtype=torch.int64, device=dev)], 1)
        hlen = prompt_mask.sum(dim=1).to(torch.int64)
        rows = torch.arange(B, device=dev)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        toks = torch.full((B, self.total), self.pad_id, dtype=torch.int32,
                          device=dev)
        # one chunk of steps when the loop has no early exit (n_chunks <= 1)
        n_steps = self.max_new_tokens if self.n_chunks <= 1 else self.total
        step = 0
        while step < n_steps:
            for _ in range(min(self.chunk, n_steps - step)):
                if self.fused_head:
                    mask = (LT.token_state_mask(history, hlen,
                                                self.vocab_size, cfg)
                            if use_mask else None)
                    vals, idx = LT.lmhead_topk(
                        head, w_head, mask, penalty=cfg.repetition_penalty,
                        quant=quant_head)
                    tok = LT.sample_from_topk_slice(vals, idx, generator,
                                                    cfg).to(torch.int64)
                else:
                    tok = process_and_sample(head, generator, history, hlen,
                                             cfg)
                tok = torch.where(finished, torch.full_like(tok, self.pad_id),
                                  tok)
                finished = finished | (tok == self.eos_id)
                history[rows, hlen] = tok
                hlen = hlen + (~(finished & (tok == self.pad_id))).long()
                toks[:, step] = tok.to(torch.int32)
                if self.fused_head:
                    head = mllm.decode_hidden(tok, step, prefix_len, caches,
                                              fmask, self.cache_len)
                else:
                    head = mllm.decode_step(tok, step, prefix_len, caches,
                                            fmask, self.cache_len)
                step += 1
            if self.n_chunks > 1 and bool(finished.all()):
                break
        self.steps = step
        if events is not None:
            events[2].record()
        self._events = events
        return toks[:, :self.max_new_tokens]

    def timing_ms(self):
        """(prefill ms, decode ms) of the last call on a CUDA device."""
        e = self._events
        return e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])


def make_generate_fn(mllm, cfg: SamplingConfig, max_new_tokens: int,
                     prompt_len: int, eos_id: int, pad_id: int = 0,
                     early_exit_chunk: Optional[int] = 8,
                     fused_head: bool = False,
                     quantize_kv: bool = False) -> DecodeProgram:
    """A (vision, prompt_ids, prompt_mask, generator) -> (B, max_new_tokens)
    int32 generator for prompts of width ``prompt_len``.  Decoding runs in
    chunks of ``early_exit_chunk`` steps (rebalanced to ceil(max_new /
    n_chunks)) and stops after the first chunk at whose end every sequence
    has emitted EOS; finished rows emit ``pad_id``.  ``None`` runs one
    chunk of ``max_new_tokens`` steps with no early exit."""
    return DecodeProgram(mllm, cfg, max_new_tokens, prompt_len, eos_id,
                         pad_id, early_exit_chunk, fused_head, quantize_kv)


def postprocess_text(text: str, extract_answer: bool = False) -> str:
    """Cutoff + optional Answer extraction (ref train.py:648-653,
    check_generation.py:203-221)."""
    if extract_answer and "Answer:" in text:
        text = text.split("Answer:", 1)[1].strip()
    if CUTOFF_MARKER in text:
        text = text[:text.index(CUTOFF_MARKER) + len(CUTOFF_MARKER)]
    return text


def prompt_only(batch) -> tuple:
    """(ids, mask) int32 numpy: the prompt span of dataset rows, which hold
    prompt + answer; the answer span is exactly where labels != -100 (ref
    check_generation.py generates from the prompt alone)."""
    from tsue_tpu_torch.models.fusion import IGNORE_LABEL
    prompt_mask = np.asarray(batch["attention_mask"])
    if "labels" in batch:
        prompt_mask = prompt_mask * (
            np.asarray(batch["labels"]) == IGNORE_LABEL)
    ids = (np.asarray(batch["input_ids"]) * prompt_mask).astype(np.int32)
    return ids, prompt_mask.astype(np.int32)


def trim_and_decode(row, tokenizer, extract_answer: bool = False) -> str:
    """Generated id row -> postprocessed text (strip pad, cut at EOS)."""
    ids = [int(t) for t in row if t != tokenizer.pad_id]
    if tokenizer.eos_id in ids:
        ids = ids[:ids.index(tokenizer.eos_id)]
    return postprocess_text(tokenizer.decode(ids), extract_answer)


def generate_texts(mllm, tokenizer, vision, prompt_ids, prompt_mask,
                   generator, max_new_tokens: int = 128,
                   cfg: Optional[SamplingConfig] = None,
                   extract_answer: bool = False,
                   speculative: bool = False) -> List[str]:
    """Ids in, postprocessed strings out, on the device of ``mllm``'s
    parameters (``tsue_tpu/eval/generation.py:210-238``).
    ``speculative=True`` decodes with prompt-lookup speculative decoding
    (``eval/speculative.py``): ``cfg=None`` becomes greedy (the plain
    greedy decode's tokens); a sampled ``cfg`` samples and matches, and
    ``generator`` is then a CPU generator per row."""
    if speculative and cfg is None:
        cfg = SamplingConfig(do_sample=False)
    cfg = cfg or SamplingConfig()
    dev = next(mllm.parameters()).device
    if speculative:
        from tsue_tpu_torch.eval.speculative import \
            make_speculative_generate_fn
        gen = make_speculative_generate_fn(
            mllm, cfg, max_new_tokens, prompt_ids.shape[1],
            tokenizer.eos_id, tokenizer.pad_id)
    else:
        gen = make_generate_fn(mllm, cfg, max_new_tokens,
                               prompt_ids.shape[1], tokenizer.eos_id,
                               tokenizer.pad_id)
    out = gen(None if vision is None else torch.as_tensor(vision).to(dev),
              torch.as_tensor(prompt_ids).to(dev),
              torch.as_tensor(prompt_mask).to(dev), generator)
    return [trim_and_decode(row, tokenizer, extract_answer)
            for row in out.cpu().numpy()]


def distributed_generate_and_save(mllm, tokenizer, dataset, out_path: str,
                                  seed: int, batch_size: int = 8,
                                  max_new_tokens: int = 128,
                                  cfg: Optional[SamplingConfig] = None,
                                  reference_texts: Optional[dict] = None,
                                  mesh=None):
    """The generation eval (ref check_generation.py:331-369,
    ``tsue_tpu/eval/generation.py:241-304``): generate from the prompt span
    of every window of ``dataset`` in order, batch i drawing from
    ``utils.random.step_generator(seed, i)`` (the counterpart of
    ``fold_in(key(seed), i)``), and write generated-vs-reference pairs
    (``reference_texts``: track_id -> ground-truth context) to
    ``out_path``.  Returns the records of the real (not wrap-padded)
    windows.

    Under a mesh (``mllm`` the rank's local shard) every data rank
    generates its contiguous rows of each batch (drawing from the batch's
    stream folded with its data rank), the rows are gathered in the
    one-process order, rank 0 decodes and writes the file once, and every
    rank waits at a barrier; rank 0 returns the records, the others an
    empty list."""
    from tsue_tpu_torch.data.dataset import BatchIterator
    from tsue_tpu_torch.parallel import mesh as M
    from tsue_tpu_torch.utils.random import step_generator

    cfg = cfg or SamplingConfig()
    dev = next(mllm.parameters()).device
    shards = (mesh.data_rank, mesh.data) if mesh is not None else (0, 1)
    gen = None
    local = []
    for i, batch in enumerate(BatchIterator(
            dataset, batch_size=batch_size, shuffle=False,
            process_index=shards[0], process_count=shards[1])):
        if gen is None:
            gen = make_generate_fn(mllm, cfg, max_new_tokens,
                                   batch["input_ids"].shape[1],
                                   tokenizer.eos_id, tokenizer.pad_id)
        ids, prompt_mask = prompt_only(batch)
        g = step_generator(seed, i, dev)
        if mesh is not None and mesh.data > 1:
            from tsue_tpu_torch.parallel.serve_tp import data_rank_generator
            g = data_rank_generator(g, mesh)
        out = gen(torch.from_numpy(batch["vision"]).to(dev),
                  torch.from_numpy(ids).to(dev),
                  torch.from_numpy(prompt_mask).to(dev), g).cpu().numpy()
        local.append((batch["track_id"], out, batch["valid"]))
    # batch-major, data rank within: the one-process row order
    per_rank = (M.all_gather_object(local, mesh.data_group)
                if mesh is not None and mesh.data > 1 else [local])
    records = []
    if M.is_primary(mesh):
        for b in range(len(local)):
            for rank_batches in per_rank:
                tids, rows, valid = rank_batches[b]
                for tid, row, v in zip(tids, rows, valid):
                    if not v:
                        continue
                    rec = {"track_id": int(tid),
                           "generated": trim_and_decode(row, tokenizer)}
                    if reference_texts is not None:
                        rec["reference"] = reference_texts.get(int(tid), "")
                    records.append(rec)
        if records:
            with open(out_path, "w") as f:
                for rec in records:
                    f.write(f"[track {rec['track_id']}]\n"
                            f"GENERATED: {rec['generated']}\n")
                    if "reference" in rec:
                        f.write(f"REFERENCE: {rec['reference']}\n")
                    f.write("\n")
    M.barrier()
    return records
