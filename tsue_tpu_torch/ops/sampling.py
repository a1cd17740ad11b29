"""Sampled-decoding logit processors in PyTorch ops.

Counterpart of ``tsue_tpu/ops/sampling.py`` (HF-``generate`` semantics of
the reference: temperature 0.9, top-k 40, top-p 0.9, repetition penalty
1.2, no-repeat-ngram 3):

- repetition penalty (CTRL): logits of tokens already seen are divided by
  the penalty when positive, multiplied when negative;
- no-repeat-ngram: tokens completing an already-seen n-gram are banned
  (``NEG_INF``);
- ``apply_top_k`` and ``apply_top_p``, the filters as functions;
- top-k then top-p filtering, then the draw, through the tie-exact
  (B, k+1)-slot sampler of the JAX package (``_topk_topp_slots``,
  ``_tie_blocks``, ``_draw_sliced``), with one generator for the batch
  (``process_and_sample``) or one per row (``process_and_sample_per_row``,
  or ``sample_from_uniforms`` from uniforms drawn beforehand).

Draws come from an explicit ``torch.Generator``: the categorical draw is a
Gumbel-max over ``torch.rand`` noise, then one uniform per row for the tie
pick.  The JAX package draws from threefry keys, so sampled tokens agree
with it in distribution, not bit for bit; greedy decoding agrees exactly.
In the shared form every operation is a tensor op on the logits' device:
nothing there waits for the device.  The per-row form draws each row's
uniforms on the host from that row's CPU generator and sends them in one
copy (``row_uniforms``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

NEG_INF = -1e9
_TIE_LANES = 128


class SamplingConfig(NamedTuple):
    temperature: float = 0.9
    top_k: int = 40
    top_p: float = 0.9
    repetition_penalty: float = 1.2
    no_repeat_ngram_size: int = 3
    do_sample: bool = True


def _scatter_any(B: int, V: int, index: torch.Tensor,
                 flags: torch.Tensor) -> torch.Tensor:
    """(B, V) bool: True where some position j of row b has
    ``index[b, j] == v`` and ``flags[b, j]`` (a scatter-max, so duplicate
    indices never overwrite a True with a False)."""
    out = torch.zeros(B, V, dtype=torch.int32, device=index.device)
    out.scatter_reduce_(1, index.long(), flags.to(torch.int32), reduce="amax")
    return out > 0


def seen_tokens(token_history: torch.Tensor, history_len: torch.Tensor,
                vocab_size: int) -> torch.Tensor:
    """(B, V) bool: token v occurs in the first ``history_len`` entries."""
    B, L = token_history.shape
    valid = (torch.arange(L, device=token_history.device)[None, :]
             < history_len[:, None])
    return _scatter_any(B, vocab_size, token_history, valid)


def banned_tokens(token_history: torch.Tensor, history_len: torch.Tensor,
                  vocab_size: int, n: int) -> torch.Tensor:
    """(B, V) bool: token v would complete an n-gram already in the
    history — the window match of ``apply_no_repeat_ngram``."""
    B, L = token_history.shape
    dev = token_history.device
    idx = torch.arange(L, device=dev)
    rows = torch.arange(B, device=dev)

    def suffix_tok(k):          # k = distance from the end (0 = last token)
        pos = (history_len - 1 - k).clamp(0, L - 1)
        return token_history[rows, pos]

    match = torch.ones(B, L, dtype=torch.bool, device=dev)
    for k in range(n - 1):
        shifted = torch.roll(token_history, -k, dims=1)
        match &= shifted == suffix_tok(n - 2 - k)[:, None]
    fits = idx[None, :] + n - 1 < history_len[:, None]
    enough = (history_len >= n - 1)[:, None]
    match &= fits & enough
    next_tok = token_history[:, (idx + n - 1).clamp(0, L - 1)]
    return _scatter_any(B, vocab_size, next_tok, match)


def apply_repetition_penalty(logits: torch.Tensor,
                             token_history: torch.Tensor,
                             history_len: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """logits (B, V); token_history (B, L) padded ids; history_len (B,)."""
    if penalty == 1.0:
        return logits
    seen = seen_tokens(token_history, history_len, logits.shape[1])
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def apply_no_repeat_ngram(logits: torch.Tensor, token_history: torch.Tensor,
                          history_len: torch.Tensor, n: int) -> torch.Tensor:
    """Ban tokens that would complete any already-seen n-gram."""
    if n <= 0:
        return logits
    banned = banned_tokens(token_history, history_len, logits.shape[1], n)
    return logits.masked_fill(banned, NEG_INF)


def sorted_desc(logits: torch.Tensor, k: int):
    """(vals, idx) of the k largest entries per row, ordered by (value
    desc, index asc) — ``lax.top_k``'s order, ties included."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k filtering (``tsue_tpu/ops/sampling.py:85``): logits below the
    k-th largest of their row become ``NEG_INF`` (ties at the k-th value
    are all kept); ``k`` <= 0 or >= V leaves them as they are.  The
    sampler itself draws through the tie-exact slots of
    ``_topk_topp_slots`` and masks nothing."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF),
                       logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering with HF semantics (the first token crossing p is
    kept)."""
    if p >= 1.0:
        return logits
    sorted_logits, _ = torch.sort(logits, dim=-1, descending=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    inf = torch.full_like(sorted_logits, float("inf"))
    thresh = torch.where(keep, sorted_logits, inf).amin(dim=-1, keepdim=True)
    return torch.where(logits >= thresh, logits,
                       torch.full_like(logits, NEG_INF))


def gumbel_pick(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The categorical draw per row from uniforms ``u`` of the logits'
    shape: argmax of logits plus Gumbel noise."""
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def gumbel_argmax(logits: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """A categorical draw per row: argmax of logits plus Gumbel noise."""
    return gumbel_pick(logits, torch.rand(logits.shape, generator=generator,
                                          device=logits.device))


def process_and_sample(logits: torch.Tensor,
                       generator: Optional[torch.Generator],
                       token_history: torch.Tensor,
                       history_len: torch.Tensor,
                       cfg: SamplingConfig) -> torch.Tensor:
    """The full processor chain -> next token ids (B,).  Greedy
    (``do_sample=False``) is the argmax with ascending-index ties and
    draws nothing from ``generator``."""
    logits = logits.float()
    logits = apply_repetition_penalty(logits, token_history, history_len,
                                      cfg.repetition_penalty)
    logits = apply_no_repeat_ngram(logits, token_history, history_len,
                                   cfg.no_repeat_ngram_size)
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    if cfg.temperature != 1.0:
        logits = logits / cfg.temperature
    if 0 < cfg.top_k < logits.shape[-1]:
        k = cfg.top_k
        slot_logits, idx, t_keep, tie_blocks = _topk_topp_slots(
            logits, k, cfg.top_p)
        return _draw_sliced(slot_logits, idx, t_keep, tie_blocks, k,
                            generator)
    return gumbel_argmax(apply_top_p(logits, cfg.top_p), generator)


def _tie_blocks(logits: torch.Tensor, thresh: torch.Tensor):
    """Tie mask in 128-wide blocks and per-block counts: (mb (B, nb, 128)
    bool, bs (B, nb) int)."""
    B, V = logits.shape
    m = logits == thresh
    pad = (-V) % _TIE_LANES
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    mb = m.reshape(B, -1, _TIE_LANES)
    return mb, mb.sum(dim=-1)


def slot_logits_from_sorted(vals: torch.Tensor, k: int, p: float,
                            n_tie: torch.Tensor):
    """The (B, k+1) slot logits and ``t_keep`` from a row's sorted top
    values ``vals`` (at least k columns, (value desc, index asc)) and the
    size ``n_tie`` of the tie class at the k-th value.  Slots 0..k-1 are
    the entries strictly above the k-th value, top-p-masked with HF's
    per-slot rule; slot k carries the mass of the kept part of the tie
    class (``t_keep`` entries of ``exp(thresh)``)."""
    kv = vals[:, :k]
    thresh = kv[:, k - 1:k]
    mx = kv[:, :1]
    exp_v = torch.exp(kv - mx)
    e_t = torch.exp(thresh - mx)[:, 0]
    m = k - (kv == thresh).sum(dim=-1)
    above = torch.arange(k, device=vals.device)[None, :] < m[:, None]
    e_above = torch.where(above, exp_v, torch.zeros_like(exp_v))
    cum = torch.cumsum(e_above, dim=-1)
    cum_m = cum[:, -1]
    n_tie_f = n_tie.to(torch.float32)
    if p < 1.0:
        pZ = p * (cum_m + n_tie_f * e_t)
        keep_above = above & ((cum - e_above) < pZ[:, None])
        t_keep = torch.ceil((pZ - cum_m) / e_t.clamp_min(1e-38))
        t_keep = torch.minimum(t_keep.clamp_min(0.0), n_tie_f)
        t_keep = torch.where(m == 0, t_keep.clamp_min(1.0), t_keep)
    else:
        keep_above = above
        t_keep = n_tie_f
    neg = torch.full_like(kv, NEG_INF)
    tie_slot = torch.where(
        t_keep > 0, torch.log((t_keep * e_t).clamp_min(1e-38)) + mx[:, 0],
        torch.full_like(t_keep, NEG_INF))
    slot_logits = torch.cat([torch.where(keep_above, kv, neg),
                             tie_slot[:, None]], dim=-1)
    return slot_logits, t_keep


def _topk_topp_slots(logits: torch.Tensor, k: int, p: float):
    """Tie-exact (B, k+1)-slot logits for the sliced top-k/top-p draw:
    returns (slot_logits, idx, t_keep, (mb, bs) tie blocks)."""
    vals, idx = sorted_desc(logits, k)
    mb, bs = _tie_blocks(logits, vals[:, k - 1:k])
    slot_logits, t_keep = slot_logits_from_sorted(vals, k, p, bs.sum(-1))
    return slot_logits, idx, t_keep, (mb, bs)


def tie_target(t_keep: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """Which kept tied token a tie-slot draw picks (0-based, in ascending
    token order), from one uniform per row (``tie_pick``)."""
    return tie_pick(t_keep, torch.rand(t_keep.shape, generator=generator,
                                       device=t_keep.device))


def tie_pick(t_keep: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """floor(u * t_keep), clamped to t_keep - 1 so an f32 round-up never
    reaches a tied token beyond the kept top-p prefix."""
    return torch.minimum((u * t_keep).to(torch.int64),
                         (t_keep.to(torch.int64) - 1).clamp_min(0))


def _draw_sliced(slot_logits, idx, t_keep, tie_blocks, k: int,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Draw next tokens from the (B, k+1) slots and the tie blocks: the
    categorical noise first, then one uniform per row for the tie pick."""
    return _slot_tokens(idx, tie_blocks, k, gumbel_argmax(slot_logits,
                                                          generator),
                        tie_target(t_keep, generator))


def _slot_tokens(idx, tie_blocks, k: int, choice: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
    """The token ids of drawn slots: slot ``choice`` < k is the slice's
    entry, slot k the ``target``-th kept tied token in ascending order."""
    B = idx.shape[0]
    mb, bs = tie_blocks
    rows = torch.arange(B, device=idx.device)
    cum_b = torch.cumsum(bs, dim=-1)
    blk = torch.argmax((cum_b > target[:, None]).to(torch.int32), dim=-1)
    before = cum_b[rows, blk] - bs[rows, blk]
    within = (target - before)[:, None]
    bm = mb[rows, blk]                                 # (B, 128) one block
    wrank = torch.cumsum(bm.to(torch.int64), dim=-1) - 1
    off = torch.argmax((bm & (wrank == within)).to(torch.int32), dim=-1)
    tie_tok = blk * mb.shape[-1] + off
    from_slice = idx.gather(1, choice.clamp_max(k - 1)[:, None])[:, 0]
    return torch.where(choice == k, tie_tok.to(idx.dtype), from_slice)


def uniform_widths(cfg: SamplingConfig, vocab_size: int) -> Tuple[int, ...]:
    """The uniforms one token's draw consumes from its row's stream, in
    order: (k + 1, 1) under top-k (the slot draw, then the tie pick), (V,)
    without it (the full-vocabulary draw), none when greedy.  Their sum is
    the width of a token's block."""
    if not cfg.do_sample:
        return ()
    if 0 < cfg.top_k < vocab_size:
        return (cfg.top_k + 1, 1)
    return (vocab_size,)


def row_uniform_blocks(generators: Sequence[Optional[torch.Generator]],
                       widths: Sequence[int], n: int, device
                       ) -> torch.Tensor:
    """(B, n, sum(widths)) uniforms on ``device``: block j of row b holds,
    in turn, the draws ``torch.rand((1, w), generator=generators[b])`` for
    each w of ``widths``, the blocks drawn in order from that row's CPU
    generator on the host; a row whose generator is None draws nothing and
    gets 0.5.  One host-to-device copy for the batch (from pinned memory,
    not waiting for the device, when ``device`` is a CUDA device)."""
    u = torch.full((len(generators), n, sum(widths)), 0.5)
    for b, g in enumerate(generators):
        if g is not None:
            for j in range(n):
                u[b, j] = torch.cat([torch.rand((1, w), generator=g)[0]
                                     for w in widths])
    return host_to_device(u, device)


def host_to_device(u: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``: from pinned memory, without waiting
    for the device, when it is a CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return u.pin_memory().to(dev, non_blocking=True)
    return u.to(dev)


def row_uniforms(generators: Sequence[Optional[torch.Generator]],
                 widths: Sequence[int], device) -> torch.Tensor:
    """(B, sum(widths)) uniforms on ``device``: one block a row
    (``row_uniform_blocks``)."""
    return row_uniform_blocks(generators, widths, 1, device)[:, 0]


def sample_from_uniforms(logits: torch.Tensor, u: Optional[torch.Tensor],
                         token_history: torch.Tensor,
                         history_len: torch.Tensor,
                         cfg: SamplingConfig) -> torch.Tensor:
    """The processor chain and the draw of ``process_and_sample_per_row``
    from given uniforms: row b's draw reads ``u[b]``, the (B, n) block of
    ``uniform_widths(cfg, V)`` (n their sum; ``u`` is unused, and may be
    None, when greedy).  Every stage runs batched over the rows, so a
    row's token depends on its logits, its history and its block only.
    Speculative decoding scores window position j of a row with the row's
    block for that output position (``eval/speculative.py``)."""
    logits = logits.float()
    logits = apply_repetition_penalty(logits, token_history, history_len,
                                      cfg.repetition_penalty)
    logits = apply_no_repeat_ngram(logits, token_history, history_len,
                                   cfg.no_repeat_ngram_size)
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    if cfg.temperature != 1.0:
        logits = logits / cfg.temperature
    if 0 < cfg.top_k < logits.shape[-1]:
        k = cfg.top_k
        slot_logits, idx, t_keep, tie_blocks = _topk_topp_slots(
            logits, k, cfg.top_p)
        return _slot_tokens(idx, tie_blocks, k,
                            gumbel_pick(slot_logits, u[:, :k + 1]),
                            tie_pick(t_keep, u[:, k + 1]))
    logits = apply_top_p(logits, cfg.top_p)
    return gumbel_pick(logits, u[:, :logits.shape[-1]])


def process_and_sample_per_row(logits: torch.Tensor,
                               generators: Sequence[
                                   Optional[torch.Generator]],
                               token_history: torch.Tensor,
                               history_len: torch.Tensor,
                               cfg: SamplingConfig) -> torch.Tensor:
    """``process_and_sample`` with a generator per row (the JAX package's
    ``process_and_sample_per_row``, ``tsue_tpu/ops/sampling.py:194-240``).

    Every key-free stage runs batched over all rows: the repetition
    penalty, the n-gram ban and the (k+1)-slot top-k/top-p machinery.  Only
    the draw is per row, and row b consumes from ``generators[b]`` (a CPU
    generator) exactly what a one-row ``process_and_sample(logits[b:b+1],
    generators[b], ...)`` on CPU logits consumes: ``(1, k+1)`` uniforms for
    the slot draw, then one for the tie pick (with ``top_k`` 0 or >= V,
    ``(1, V)`` uniforms for the full-vocabulary draw).  So a row's token
    depends on its logits, its history and its own stream only, never on
    the other rows, and the same generators give the same tokens on the
    CPU and on a CUDA device.  The uniforms are drawn on the host and sent
    in one copy (``row_uniforms``), then ``sample_from_uniforms`` draws
    from them.  A row whose generator is None draws nothing; its token is
    meaningless.  Greedy (``do_sample=False``) draws nothing."""
    widths = uniform_widths(cfg, logits.shape[-1])
    u = row_uniforms(generators, widths, logits.device) if widths else None
    return sample_from_uniforms(logits, u, token_history, history_len, cfg)
