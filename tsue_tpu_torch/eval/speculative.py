"""Speculative decoding, greedy and sampled, with prompt-lookup drafts.

Counterpart of ``tsue_tpu/eval/speculative.py``.  A decode step streams
every weight to emit one token a row.  A speculative forward drafts W - 1
tokens from the row's own history (the latest earlier occurrence of its
(n-1)-token suffix, ``ngram_draft``), scores the committed token and the
drafts in one window forward (``MultiModalLLM.decode_window``: the weights
are read once for all W positions) and keeps the longest prefix the model
itself would have produced, so a row advances 1..W tokens a forward.

- Greedy (``do_sample=False``): every emitted token is the processed-logits
  argmax given its prefix (``greedy_token``), so the ids are the
  token-at-a-time greedy decode's; only the number of forwards changes.
- Sampled: the draft is deterministic, so exact speculative sampling is
  sample-and-match: draw the token of every window position with the
  production sampler, accept a draft while it equals the draw, and on the
  first mismatch emit the draw.  Row r draws from its own CPU generator,
  one block of uniforms a token position (``ops.sampling.uniform_widths``:
  k + 2 under top-k, V without it): block j is the j-th the generator gives,
  and position j always reads block j, so a rejected position's block is
  used again when the position is scored anew, never skipped.  The ids are
  then bit for bit those of the per-row plain decode that draws token j of
  row r with ``process_and_sample_per_row`` from the same generators.

As in the JAX package, a window forward computes the same logits as W
decode steps only up to the summation order of its products: where a
product computes each row alone (the int8 weights of ``ops/quant.py``, the
int8-KV attention), the ids are bitwise the plain decode's; with fp32
weights on the card a near-tie can flip.

The loop runs in Python over chunks of ``CHUNK`` window forwards and reads
the device once a chunk (``all(finished)``), the early-exit cadence of
``eval/generation.py``.  Rows advance on their own clocks (per-row steps);
a rejected draft's cache slots are written again by the next window before
any query can see them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from tsue_tpu_torch.ops.sampling import (SamplingConfig, row_uniform_blocks,
                                         sample_from_uniforms, uniform_widths)
from tsue_tpu_torch.parallel.sharding import grad_free

CHUNK = 8     # window forwards between two reads of the device


def greedy_token(logits: torch.Tensor, history: torch.Tensor,
                 history_len: torch.Tensor,
                 cfg: SamplingConfig) -> torch.Tensor:
    """The processed-logits argmax (the production chain's greedy arm:
    temperature, top-k and top-p do not move an argmax), so the verifier
    never drifts from the plain decode's greedy processing."""
    return sample_from_uniforms(logits, None, history, history_len,
                                cfg._replace(do_sample=False))


def ngram_draft(history: torch.Tensor, history_len: torch.Tensor, n: int,
                width: int) -> torch.Tensor:
    """Prompt-lookup proposal: continue the latest earlier occurrence of
    the row's last n - 1 valid tokens.

    history (B, L) padded ids, history_len (B,) valid counts.  Returns (B,
    width) drafts.  The latest occurrence whose continuation lies wholly
    inside the written history is preferred (the latest one overall often
    sits so near the end that it proposes padding); without an occurrence
    the last token is repeated.  Any draft is safe: verification rejects
    what the model would not emit."""
    B, L = history.shape
    dev = history.device
    rows = torch.arange(B, device=dev)
    idx = torch.arange(L, device=dev)[None, :]
    hlen = history_len.long()
    match = torch.ones(B, L, dtype=torch.bool, device=dev)
    for k in range(n - 1):
        suf = history[rows, (hlen - 1 - k).clamp(0, L - 1)]
        # an occurrence ending at j needs history[j - k] == the suffix's
        # k-th token from the end; the roll puts history[j - k] at j
        match &= torch.roll(history, k, dims=1) == suf[:, None]
    match &= idx >= n - 2                          # the occurrence fits
    match &= idx < hlen[:, None] - 1               # strictly earlier
    match &= (hlen >= n)[:, None]
    has = match.any(dim=1)
    full = match & (idx <= hlen[:, None] - 1 - width)
    match = torch.where(full.any(dim=1)[:, None], full, match)
    # the latest occurrence: the first True of the flipped row
    j = (L - 1) - torch.argmax(match.flip(1).to(torch.int32), dim=1)
    cols = (j[:, None] + 1 + torch.arange(width, device=dev)[None, :]
            ).clamp(0, L - 1)
    draft = history[rows[:, None], cols]
    last = history[rows, (hlen - 1).clamp(0, L - 1)]
    return torch.where(has[:, None], draft, last[:, None])


def window_step(mllm, cfg: SamplingConfig, draft_ngram: int,
                logits: torch.Tensor, u_window: Optional[torch.Tensor],
                live: torch.Tensor, step: torch.Tensor, hlen: torch.Tensor,
                history: torch.Tensor, out: torch.Tensor, caches,
                prefix_len: torch.Tensor, fmask: torch.Tensor,
                cache_len: int, caps, window: int, eos: int, pad: int):
    """One speculative forward over all rows, the rule both the static
    program and the slot pool run: draw the committed token of output
    position ``step`` from ``logits`` (B, V), propose ``window - 1`` drafts
    from the history it implies, score the window in one
    ``decode_window`` forward, and accept drafts while they equal the
    row's own draw at their position and no EOS came before them.

    ``u_window`` (B, W, n): the blocks of output positions step .. step +
    W - 1, or None when greedy.  A row emits at most ``caps - step``
    tokens (``caps`` an int or (B,)), a row that is not ``live`` none.
    ``step``, ``hlen``, ``history`` and ``out`` are updated in place; the
    caches are written at slots P + step .. + W - 1 of every row, live or
    not.  Returns the logits of the next committed position (B, V) (the
    window's at offset n_emit - 1, n_emit the row's emitted tokens; a row
    that is not live keeps its own) and whether it emitted EOS (B,)."""
    B = logits.shape[0]
    W, dev = window, logits.device
    rows = torch.arange(B, device=dev)
    offs = torch.arange(W, device=dev)[None, :]
    H = history.shape[1]
    tok = sample_from_uniforms(logits,
                               None if u_window is None else u_window[:, 0],
                               history, hlen, cfg)
    tok = torch.where(live, tok, torch.full_like(tok, pad))
    hidx = hlen.clamp_max(H - 1)
    hist1 = history.clone()
    hist1[rows, hidx] = torch.where(live, tok, history[rows, hidx])
    draft = ngram_draft(hist1, hlen + 1, draft_ngram, W - 1)
    wtoks = torch.cat([tok[:, None], draft], dim=1)
    logits_w = mllm.decode_window(wtoks, step, prefix_len, caches, fmask,
                                  cache_len).float()
    # positions step + 1 .. step + W - 1, each against the history it
    # implies (its processors read the first hlen + m + 1 entries),
    # batched over all B * (W - 1) rows
    cols = hlen[:, None] + offs
    hist_all = history.clone()
    hist_all[rows[:, None], cols] = wtoks
    g = sample_from_uniforms(
        logits_w[:, :W - 1].reshape(B * (W - 1), -1),
        None if u_window is None
        else u_window[:, 1:].reshape(B * (W - 1), -1),
        hist_all.repeat_interleave(W - 1, dim=0),
        (hlen[:, None] + offs[:, :W - 1] + 1).reshape(-1),
        cfg).reshape(B, W - 1)
    acc = (wtoks[:, 1:] == g) & (wtoks[:, :-1] != eos)
    n_emit = 1 + torch.cumprod(acc.long(), dim=1).sum(dim=1)
    n_emit = torch.where(live, torch.minimum(n_emit, caps - step),
                         torch.zeros_like(n_emit))
    emit = offs < n_emit[:, None]
    ocols = step[:, None] + offs
    out[rows[:, None], ocols] = torch.where(emit, wtoks,
                                            out[rows[:, None], ocols])
    history[rows[:, None], cols] = torch.where(
        emit, wtoks, history[rows[:, None], cols])
    hlen += n_emit
    step += n_emit
    sel = (n_emit - 1).clamp(0, W - 1)
    nxt = torch.where(live[:, None], logits_w[rows, sel], logits)
    return nxt, ((wtoks == eos) & emit).any(dim=1)


class SpeculativeProgram:
    """The generator of ``make_speculative_generate_fn``: a callable
    (vision, prompt_ids, prompt_mask, generators) -> (B, max_new_tokens)
    int32 ids, or (ids, n_forwards (B,)) with ``with_stats``.  ``forwards``
    holds the window forwards the last call ran; on a CUDA device
    ``timing_ms()`` gives its (prefill, decode) device times from CUDA
    events."""

    def __init__(self, mllm, cfg: SamplingConfig, max_new_tokens: int,
                 prompt_len: int, eos_id: int, pad_id: int = 0,
                 window: int = 8, draft_ngram: int = 3,
                 with_stats: bool = False, quantize_kv: bool = False):
        if window < 2:
            raise ValueError("window must be >= 2 (1 target + >= 1 draft)")
        self.mllm = mllm
        self.cfg = cfg
        self.max_new_tokens = max_new_tokens
        self.prompt_len = prompt_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.window = window
        self.draft_ngram = draft_ngram
        self.with_stats = with_stats
        self.quantize_kv = quantize_kv
        n_img = mllm.qformer.cfg.num_query_tokens if mllm.use_vision else 0
        # a window overruns the nominal lengths by less than W
        self.cache_len = n_img + prompt_len + max_new_tokens + window
        self.hist_len = prompt_len + max_new_tokens + window
        self.out_len = max_new_tokens + window
        self.widths = uniform_widths(cfg, mllm.llama.cfg.vocab_size)
        self.forwards = 0
        self._events = None

    @grad_free("mllm")
    def __call__(self, vision: Optional[torch.Tensor],
                 prompt_ids: torch.Tensor, prompt_mask: torch.Tensor,
                 generators: Optional[Sequence[torch.Generator]] = None):
        from tsue_tpu_torch.ops.kv_quant import quantize_cache
        mllm, cfg = self.mllm, self.cfg
        W, N, eos, pad = (self.window, self.max_new_tokens, self.eos_id,
                          self.pad_id)
        B = prompt_ids.shape[0]
        dev = prompt_ids.device
        u = None
        if cfg.do_sample:
            if generators is None or isinstance(generators, torch.Generator) \
                    or len(generators) != B:
                raise ValueError("sampled speculative decoding needs a CPU "
                                 "generator per row")
            # block j of row r: the uniforms of output position j
            u = row_uniform_blocks(generators, self.widths, max(N, 1), dev)
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
        logits = mllm.llama.logits_from_hidden(last_hidden,
                                               quant_ok=True).float()
        offs = torch.arange(W, device=dev)[None, :]
        history = torch.cat([prompt_ids.long(),
                             torch.full((B, self.hist_len - self.prompt_len),
                                        pad, dtype=torch.long, device=dev)],
                            dim=1)
        hlen = prompt_mask.sum(dim=1).long()
        out = torch.full((B, self.out_len), pad, dtype=torch.long,
                         device=dev)
        step = torch.zeros(B, dtype=torch.long, device=dev)
        finished = torch.full((B,), N <= 0, dtype=torch.bool, device=dev)
        n_fwd = torch.zeros(B, dtype=torch.long, device=dev)
        rows = torch.arange(B, device=dev)[:, None]
        forwards = 0
        # every live row emits at least one token a forward
        while forwards < N:
            for _ in range(min(CHUNK, N - forwards)):
                live = ~finished
                # window position m reads the block of output position
                # step + m (past the last position it is never emitted)
                uw = (None if u is None
                      else u[rows, (step[:, None] + offs).clamp_max(N - 1)])
                logits, eos_hit = window_step(
                    mllm, cfg, self.draft_ngram, logits, uw, live, step,
                    hlen, history, out, caches, prefix_len, fmask,
                    self.cache_len, N, W, eos, pad)
                finished = finished | eos_hit | (step >= N)
                n_fwd += live
                forwards += 1
            if bool(finished.all()):
                break
        self.forwards = forwards
        if events is not None:
            events[2].record()
        self._events = events
        toks = out[:, :N].to(torch.int32)
        return (toks, n_fwd) if self.with_stats else toks

    def timing_ms(self):
        """(prefill ms, decode ms) of the last call on a CUDA device."""
        e = self._events
        return e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])


def make_speculative_generate_fn(mllm, cfg: SamplingConfig,
                                 max_new_tokens: int, prompt_len: int,
                                 eos_id: int, pad_id: int = 0,
                                 window: int = 8, draft_ngram: int = 3,
                                 with_stats: bool = False,
                                 quantize_kv: bool = False
                                 ) -> SpeculativeProgram:
    """A (vision, prompt_ids, prompt_mask, generators) -> (B,
    max_new_tokens) int32 generator with the contract of
    ``eval.generation.make_generate_fn``: rows stop at EOS and emit
    ``pad_id`` after it.

    ``cfg.do_sample=False``: exact greedy (``generators`` ignored).
    ``cfg.do_sample=True``: sample-and-match (module docstring);
    ``generators`` is a sequence of one CPU ``torch.Generator`` a row
    (raises without), from which all ``max_new_tokens`` blocks are drawn
    before the decode (B * max_new_tokens * (k + 2) floats; V in place of k
    + 2 without top-k), so the generators end where a per-row plain decode
    of ``max_new_tokens`` steps leaves them.

    ``window``: tokens scored a forward (one target, W - 1 drafts);
    ``draft_ngram``: the n of the suffix lookup; ``with_stats``: return
    (ids, n_forwards (B,)), the forwards each row was live for;
    ``quantize_kv``: quantise the prefilled cache to int8 once and run the
    windows over it (``ops/kv_quant.py``).  The head is the plain one (the
    int8 head when int8 tables are attached), never the fused one."""
    return SpeculativeProgram(mllm, cfg, max_new_tokens, prompt_len, eos_id,
                              pad_id, window, draft_ngram, with_stats,
                              quantize_kv)
