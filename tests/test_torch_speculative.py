"""Speculative decoding in the port (``tsue_tpu_torch.eval.speculative``,
``MultiModalLLM.decode_window``, the pool's window mode, the Predictor's
and the serve command's speculative paths, and the per-query masks of the
two attention routes), against the JAX package at its own tests' tiny
configuration (``tests/test_speculative.py``: vocabulary 64, prompts of 8,
4 frames, ``LlamaConfig.tiny``).

Flax initialises the MultiModalLLM and ``convert.load_flax_params``
carries the weights.  Tolerances: atol = rtol = 1e-4 against the JAX
package (fp32 on both sides, summed in other orders) and 2e-5 between two
routes of the port (a window forward against W decode steps, as the JAX
test holds its own).  Token ids must be equal: greedy speculative ids to
the port's token-at-a-time greedy decode and to the JAX package's
speculative ids; sampled speculative ids, bit for bit, to the port's
per-row plain decode from the same CPU generators (the JAX package draws
from threefry keys, which a torch generator cannot reproduce)."""
import copy
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tsue_tpu import config as jax_config
from tsue_tpu.eval import speculative as jax_spec
from tsue_tpu.models.fusion import MultiModalLLM as JaxMLLM
from tsue_tpu.ops import kv_quant as jax_kv
from tsue_tpu.ops.flash import flash_attention as jax_flash_attention
from tsue_tpu.ops.quant import with_quantized_decode
from tsue_tpu.ops.sampling import SamplingConfig as JaxSamplingConfig
from tsue_tpu_torch import config as port_config
from tsue_tpu_torch.convert import load_flax_params
from tsue_tpu_torch.eval import speculative as spec
from tsue_tpu_torch.eval.generation import make_generate_fn
from tsue_tpu_torch.models.fusion import MultiModalLLM
from tsue_tpu_torch.ops.attention import dot_product_attention
from tsue_tpu_torch.ops.kv_quant import (attend_int8_kv_plain,
                                         quantize_cache)
from tsue_tpu_torch.ops.quant import attach_quant, quantize_llama_params
from tsue_tpu_torch.ops.sampling import (SamplingConfig,
                                         process_and_sample_per_row)
from tsue_tpu_torch.serve_batching import ContinuousBatcher

VOCAB = 64
EOS = VOCAB - 1
PROMPT_LEN = 8
T_VIS = 4
MAX_NEW = 12
TOL = dict(atol=1e-4, rtol=1e-4)
ROUTES = dict(atol=2e-5, rtol=2e-5)
QF = dict(hidden_size=32, num_heads=2, num_encoder_layers=1,
          num_decoder_layers=1, num_query_tokens=4, dropout=0.0)
GREEDY = dict(do_sample=False, repetition_penalty=1.2,
              no_repeat_ngram_size=3)
SAMPLED = dict(do_sample=True, temperature=0.9, top_k=40, top_p=0.9,
               repetition_penalty=1.2, no_repeat_ngram_size=3)


@pytest.fixture(scope="module")
def stacks():
    """The JAX MLLM and variables, and the port's MLLM with fp32 decode
    weights and a copy with the int8 tables attached."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    llama = dataclasses.replace(jax_config.LlamaConfig.tiny(VOCAB),
                                lora_dropout=0.0)
    jm = JaxMLLM(llama, jax_config.QFormerConfig(**QF))
    rng = np.random.default_rng(0)
    vision = jnp.asarray(rng.standard_normal((1, T_VIS, 512)), jnp.float32)
    ids = jnp.asarray(rng.integers(3, VOCAB - 1, (1, PROMPT_LEN)), jnp.int32)
    params = jax.device_get(jax.jit(jm.init, static_argnums=4)(
        {"params": jax.random.key(0)}, vision, ids,
        jnp.ones((1, PROMPT_LEN), jnp.int32), True)["params"])
    # flax inits lora_b = 0; give the adapters mass
    flat = traverse_util.flatten_dict(params)
    for key in flat:
        if key[-1] == "lora_b":
            flat[key] = rng.normal(0, 0.05, flat[key].shape).astype(
                np.float32)
    params = traverse_util.unflatten_dict(flat)
    port = load_flax_params(
        MultiModalLLM(port_config.LlamaConfig(**dataclasses.asdict(llama)),
                      port_config.QFormerConfig(**QF)), params).eval()
    quant = copy.deepcopy(port)
    attach_quant(quant, quantize_llama_params(quant))
    yield {"jm": jm, "jv": {"params": params}, "port": port, "quant": quant}
    torch.set_num_threads(prev)


def _batch(n, seed=5):
    """n rows of vision and prompts of 3..8 valid tokens (numpy)."""
    rng = np.random.default_rng(seed)
    vision = rng.standard_normal((n, T_VIS, 512)).astype(np.float32)
    ids = np.zeros((n, PROMPT_LEN), np.int32)
    mask = np.zeros((n, PROMPT_LEN), np.int32)
    for i in range(n):
        plen = int(rng.integers(3, PROMPT_LEN + 1))
        ids[i, :plen] = rng.integers(3, VOCAB - 1, plen)
        mask[i, :plen] = 1
    return vision, ids, mask


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ngram_draft ---------------------------------------------------------------

def _histories(case):
    """(history (B, 12), history_len (B,), n, width) of one case, from a
    seeded generator where the case allows."""
    rng = np.random.default_rng(["random", "no_match",
                                 "shorter_than_n"].index(case)
                                if case != "full_continuation" else 0)
    if case == "random":          # small vocabulary: many matches
        return (rng.integers(0, 4, (6, 12)), rng.integers(1, 13, (6,)), 3,
                3)
    if case == "no_match":        # distinct tokens: nothing recurs
        hist = np.stack([rng.permutation(40)[:12] for _ in range(4)])
        return hist, np.array([12, 9, 5, 3]), 3, 4
    if case == "shorter_than_n":  # fewer valid tokens than n
        return rng.integers(0, 3, (4, 12)), np.array([0, 1, 2, 3]), 4, 2
    # a period-1 loop and a latest occurrence too near the end: the full
    # continuation is preferred over the latest match
    hist = np.array([[3, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0],
                     [5, 6, 9, 9, 5, 6, 7, 5, 6, 0, 0, 0],
                     [1, 2, 8, 1, 2, 8, 1, 2, 0, 0, 0, 0]])
    return hist, np.array([5, 9, 8]), 3, 3


@pytest.mark.parametrize("case", ["random", "no_match", "shorter_than_n",
                                  "full_continuation"])
def test_ngram_draft_matches_jax(case):
    hist, hlen, n, width = _histories(case)
    hist, hlen = hist.astype(np.int32), hlen.astype(np.int32)
    theirs = np.asarray(jax.jit(jax_spec.ngram_draft, static_argnums=(2, 3))(
        jnp.asarray(hist), jnp.asarray(hlen), n, width))
    ours = spec.ngram_draft(torch.from_numpy(hist).long(),
                            torch.from_numpy(hlen).long(), n, width)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    if case == "no_match":        # the last valid token repeated
        last = hist[np.arange(len(hlen)), hlen - 1]
        np.testing.assert_array_equal(ours.numpy(),
                                      np.repeat(last[:, None], width, 1))


# decode_window -------------------------------------------------------------

def _jit(jm, method, cache_len):
    """A jitted JAX MLLM method whose last argument is ``cache_len``."""
    fn = getattr(jm, method)
    return jax.jit(lambda v, *a: jm.apply(v, *a, cache_len, method=fn))


def _prefilled(stacks, quantize_kv=False, jax_side=True, seed=3):
    """Both sides (or the port alone) prefilled on three rows at per-row
    steps [0, 1, 2] (the earlier decode slots of rows 1 and 2 written by
    decode steps), and a window of four tokens."""
    jm, jv, port = stacks["jm"], stacks["jv"], stacks["port"]
    rng = np.random.default_rng(seed)
    B, W = 3, 4
    vision = rng.standard_normal((B, T_VIS, 512)).astype(np.float32)
    ids = rng.integers(3, VOCAB - 1, (B, PROMPT_LEN)).astype(np.int32)
    mask = np.ones((B, PROMPT_LEN), np.int32)
    mask[1, 5:] = 0
    cache_len = QF["num_query_tokens"] + PROMPT_LEN + 2 * W
    toks = rng.integers(3, VOCAB - 1, (B, W)).astype(np.int32)
    pre = rng.integers(3, VOCAB - 1, (B, 2)).astype(np.int32)
    pc, _, pplen, pfmask = port.prefill(*_torch(vision, ids, mask),
                                        cache_len)
    if quantize_kv:
        pc = quantize_cache(pc)
    for j in range(2):
        port.decode_step(torch.from_numpy(pre[:, j]).long(),
                         torch.full((B,), j), pplen, pc, pfmask, cache_len)
    if not jax_side:
        return None, (pc, pplen, pfmask), toks, cache_len
    jc, _, jplen, jfmask = _jit(jm, "prefill", cache_len)(
        jv, *map(jnp.asarray, (vision, ids, mask)))
    step = _jit(jm, "decode_step", cache_len)
    for j in range(2):
        _, jc = step(jv, jnp.asarray(pre[:, j]),
                     jnp.full((B,), j, jnp.int32), jplen, jc, jfmask)
    return (jc, jplen, jfmask), (pc, pplen, pfmask), toks, cache_len


@torch.inference_mode()
def test_decode_window_matches_jax(stacks):
    """Logits and every cache row after a window at per-row steps [0, 1,
    2] equal the JAX package's ``decode_window``."""
    jm, jv, port = stacks["jm"], stacks["jv"], stacks["port"]
    (jc, jplen, jfmask), (pc, pplen, pfmask), toks, cache_len = _prefilled(
        stacks)
    step = np.array([0, 1, 2], np.int32)
    jl, jc = _jit(jm, "decode_window", cache_len)(
        jv, jnp.asarray(toks), jnp.asarray(step), jplen, jc, jfmask)
    pl = port.decode_window(torch.from_numpy(toks).long(),
                            torch.from_numpy(step).long(), pplen, pc,
                            pfmask, cache_len)
    assert pl.shape == (3, 4, VOCAB) and pl.dtype == torch.float32
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    for (jk, jvv), (pk, pv) in zip(jc, pc):
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jvv), **TOL)


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["fp32", "int8"])
@torch.inference_mode()
def test_decode_window_matches_sequential_steps(stacks, quantize_kv):
    """Window position j equals the j-th of W sequential decode steps at
    the same per-row steps, logits and caches (in-window causality, per-row
    slots), over the fp32 and the int8 cache; a one-token window is a
    decode step bit for bit."""
    port = stacks["port"]
    _, (pc, pplen, pfmask), toks, cache_len = _prefilled(
        stacks, quantize_kv, jax_side=False)
    toks = torch.from_numpy(toks).long()
    step = torch.tensor([0, 1, 2])
    seq = [tuple(c.clone() for c in layer) for layer in pc]
    seq_logits = [port.decode_step(toks[:, j], step + j, pplen, seq, pfmask,
                                   cache_len) for j in range(4)]
    one = [tuple(c.clone() for c in layer) for layer in pc]
    win = port.decode_window(toks, step, pplen, pc, pfmask, cache_len)
    for j in range(4):
        torch.testing.assert_close(win[:, j], seq_logits[j], **ROUTES)
    for a, b in zip(pc, seq):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, **ROUTES)
    w1 = port.decode_window(toks[:, :1], step, pplen, one, pfmask,
                            cache_len)
    assert torch.equal(w1[:, 0], port.decode_step(
        toks[:, 0], step, pplen, [tuple(c.clone() for c in layer)
                                  for layer in one], pfmask, cache_len))


# the static generator ------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True],
                         ids=["fp32", "int8_weights_and_kv"])
@pytest.mark.parametrize("window,ngram", [(2, 2), (5, 3)])
def test_greedy_speculative_matches_greedy_and_jax(stacks, window, ngram,
                                                   int8):
    """Greedy speculative ids equal the port's token-at-a-time greedy
    decode and the JAX package's speculative ids, with fp32 weights and
    cache and with int8 weights (``quantize_decode``) and the int8 KV
    cache; every row runs at least one and at most MAX_NEW forwards."""
    port = stacks["quant" if int8 else "port"]
    vision, ids, mask = _batch(4)
    cfg = SamplingConfig(**GREEDY)
    ref = make_generate_fn(port, cfg, MAX_NEW, PROMPT_LEN, EOS,
                           quantize_kv=int8)(*_torch(vision, ids, mask),
                                             None)
    toks, n_fwd = spec.make_speculative_generate_fn(
        port, cfg, MAX_NEW, PROMPT_LEN, EOS, window=window,
        draft_ngram=ngram, with_stats=True, quantize_kv=int8)(
            *_torch(vision, ids, mask), None)
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), ref.numpy())
    assert ((n_fwd >= 1) & (n_fwd <= MAX_NEW)).all()
    jv = with_quantized_decode(stacks["jv"]) if int8 else stacks["jv"]
    theirs = jax_spec.make_speculative_generate_fn(
        stacks["jm"], JaxSamplingConfig(**GREEDY), MAX_NEW, PROMPT_LEN,
        eos_id=EOS, window=window, draft_ngram=ngram, quantize_kv=int8)(
            jv, *map(jnp.asarray, (vision, ids, mask)))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(theirs))


@torch.inference_mode()
def _per_row_plain_decode(port, cfg, vision, ids, mask, gens):
    """The token-at-a-time decode with a CPU generator per row: token j of
    row r from ``process_and_sample_per_row`` (one block of row r's
    uniforms a step), finished rows emitting pad, MAX_NEW steps."""
    B = ids.shape[0]
    cache_len = QF["num_query_tokens"] + PROMPT_LEN + MAX_NEW
    caches, last_hidden, plen, fmask = port.prefill(vision, ids, mask,
                                                    cache_len)
    logits = port.llama.logits_from_hidden(last_hidden, quant_ok=True)
    history = torch.cat([ids.long(), torch.zeros(B, MAX_NEW).long()], 1)
    hlen = mask.sum(1).long()
    finished = torch.zeros(B, dtype=torch.bool)
    out = []
    for j in range(MAX_NEW):
        tok = process_and_sample_per_row(logits, gens, history, hlen, cfg)
        tok = torch.where(finished, torch.zeros_like(tok), tok)
        finished |= tok == EOS
        history[torch.arange(B), hlen] = tok
        hlen = hlen + (~(finished & (tok == 0))).long()
        out.append(tok)
        logits = port.decode_step(tok, j, plen, caches, fmask, cache_len)
    return torch.stack(out, 1).to(torch.int32)


def _oracle(ref, plen):
    """Drafts that are the reference's own continuation: the committed
    token of a window sits at output position hlen - 1 - plen."""
    def draft(hist, hlen, n, width):
        pos = (hlen - plen)[:, None] + torch.arange(width)[None, :]
        return ref.long().gather(1, pos.clamp_max(ref.shape[1] - 1))
    return draft


@pytest.mark.parametrize("drafts", ["ngram", "oracle"])
@pytest.mark.parametrize("window,ngram", [(2, 2), (5, 3)])
def test_sampled_speculative_is_the_per_row_plain_decode(
        stacks, monkeypatch, window, ngram, drafts):
    """Sample-and-match: the ids are bit for bit the per-row plain
    decode's from equal generators, which end in the same state; with
    prompt-lookup drafts (mostly rejected at these random weights) and
    with oracle drafts (all accepted: every window position reads its own
    output position's block)."""
    port = stacks["port"]
    vision, ids, mask = _torch(*_batch(4, seed=9))
    cfg = SamplingConfig(**SAMPLED)

    def gens():
        return [torch.Generator().manual_seed(21 + r) for r in range(4)]
    ref_gens, our_gens = gens(), gens()
    ref = _per_row_plain_decode(port, cfg, vision, ids, mask, ref_gens)
    if drafts == "oracle":
        monkeypatch.setattr(spec, "ngram_draft",
                            _oracle(ref, mask.sum(1).long()))
    toks, n_fwd = spec.make_speculative_generate_fn(
        port, cfg, MAX_NEW, PROMPT_LEN, EOS, window=window,
        draft_ngram=ngram, with_stats=True)(vision, ids, mask, our_gens)
    np.testing.assert_array_equal(toks.numpy(), ref.numpy())
    assert len(np.unique(toks.numpy())) > 8
    assert ((n_fwd >= 1) & (n_fwd <= MAX_NEW)).all()
    for a, b in zip(ref_gens, our_gens):
        assert torch.equal(a.get_state(), b.get_state())
    if drafts == "oracle":
        emitted = [MAX_NEW if EOS not in row else row.index(EOS) + 1
                   for row in ref.tolist()]
        assert n_fwd.tolist() == [math.ceil(e / window) for e in emitted]


def test_sampled_speculative_needs_generators(stacks):
    vision, ids, mask = _torch(*_batch(2))
    gen = spec.make_speculative_generate_fn(
        stacks["port"], SamplingConfig(**SAMPLED), 8, PROMPT_LEN, EOS)
    with pytest.raises(ValueError, match="generator per row"):
        gen(vision, ids, mask, None)
    with pytest.raises(ValueError, match="generator per row"):
        gen(vision, ids, mask, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="window"):
        spec.make_speculative_generate_fn(
            stacks["port"], SamplingConfig(**SAMPLED), 8, PROMPT_LEN, EOS,
            window=1)


def test_oracle_drafts_take_ceil_of_tokens_over_window(stacks, monkeypatch):
    """Drafts that are the greedy continuation itself are all accepted: a
    row runs ceil(tokens / W) forwards, and its ids are still the greedy
    decode's."""
    port = stacks["port"]
    vision, ids, mask = _torch(*_batch(3, seed=4))
    cfg = SamplingConfig(**GREEDY)
    ref = make_generate_fn(port, cfg, MAX_NEW, PROMPT_LEN, EOS)(
        vision, ids, mask, None).long()
    monkeypatch.setattr(spec, "ngram_draft", _oracle(ref, mask.sum(1).long()))
    W = 4
    toks, n_fwd = spec.make_speculative_generate_fn(
        port, cfg, MAX_NEW, PROMPT_LEN, EOS, window=W, with_stats=True)(
            vision, ids, mask, None)
    np.testing.assert_array_equal(toks.numpy(), ref.numpy())
    emitted = [MAX_NEW if EOS not in row else row.index(EOS) + 1
               for row in ref.tolist()]
    assert n_fwd.tolist() == [math.ceil(e / W) for e in emitted]
    assert n_fwd.tolist() == [math.ceil(MAX_NEW / W)] * 3 or EOS in ref


# the pool's window mode ----------------------------------------------------

def _requests(n, seed=7):
    rng = np.random.default_rng(seed)
    vision, ids, mask = _batch(n, seed)
    return [{"vision": vision[i], "prompt_ids": ids[i],
             "prompt_mask": mask[i], "max_new": int(rng.integers(2, 11))}
            for i in range(n)]


def _pool_oracle(pool, reqs, outs, monkeypatch):
    """The pool's oracle drafts: each slot's request, recorded as the pool
    admits it, proposes its ids from the window-1 run (EOS-trimmed, so
    EOS follows them)."""
    index = {id(r): i for i, r in enumerate(reqs)}
    slot_req = torch.zeros(pool.B, dtype=torch.long)
    plen = torch.as_tensor(np.stack([r["prompt_mask"] for r in reqs])
                           ).sum(1).long()
    ref = torch.full((len(outs), MAX_NEW + 1), EOS, dtype=torch.long)
    for i, o in enumerate(outs):
        ref[i, :len(o)] = torch.as_tensor(o).long()
    admit = pool._admit

    def recording_admit(st, slot, req, max_new):
        slot_req[slot] = index[id(req)]
        admit(st, slot, req, max_new)
    monkeypatch.setattr(pool, "_admit", recording_admit)

    def draft(hist, hlen, n, width):
        pos = (hlen - plen[slot_req])[:, None] + torch.arange(width)[None, :]
        return ref[slot_req].gather(1, pos.clamp(0, MAX_NEW))
    monkeypatch.setattr(spec, "ngram_draft", draft)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_pool_window_mode_equals_window_one(stacks, monkeypatch, sampled,
                                            int8):
    """Five requests through two slots: the window-4 pool gives every
    request the window-1 pool's ids (greedy and sampled, fp32 and int8
    weights and cache), with prompt-lookup drafts and with oracle drafts;
    with the oracle's, rows advance several positions a tick, so the live
    slot-ticks are fewer than the tokens."""
    port = stacks["quant" if int8 else "port"]
    cfg = SamplingConfig(**(SAMPLED if sampled else GREEDY))
    reqs = _requests(5)

    def run(window, oracle_of=None):
        pool = ContinuousBatcher(port, cfg, num_slots=2,
                                 prompt_len=PROMPT_LEN,
                                 max_new_tokens=MAX_NEW, eos_id=EOS,
                                 chunk=3, window=window, quantize_kv=int8,
                                 device="cpu")
        rs = [dict(r, generator=torch.Generator().manual_seed(500 + i))
              for i, r in enumerate(reqs)]
        if oracle_of is not None:
            _pool_oracle(pool, rs, oracle_of, monkeypatch)
        return pool.run(rs), pool
    plain, _ = run(1)
    ours, pool = run(4)
    oracle, opool = run(4, oracle_of=plain)
    for got in (ours, oracle):
        assert len(got) == len(plain)
        for i, (a, b) in enumerate(zip(got, plain)):
            np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    tokens = sum(len(x) for x in plain)
    assert tokens > 15
    assert pool.cache_len == QF["num_query_tokens"] + PROMPT_LEN + MAX_NEW + 4
    run_ = opool.last_run
    assert round(run_["mean_live_slots"] * run_["ticks"]) < tokens


# the Predictor and the serve command ---------------------------------------

def _predictor(quantize=False):
    from tsue_tpu_torch.config import (DataConfig, ExperimentConfig,
                                       LaneEncoderConfig, LTSFConfig,
                                       ModelConfig, QFormerConfig)
    from tsue_tpu_torch.data.tokenizer import ByteTokenizer
    from tsue_tpu_torch.models.tsue import TrajectoryModel
    from tsue_tpu_torch.serve import Predictor
    torch.manual_seed(0)
    cfg = ExperimentConfig(
        name="torch_speculative",
        data=DataConfig(seq_len=6, out_len=6, max_length=640),
        model=ModelConfig(
            llama=dataclasses.replace(port_config.LlamaConfig.tiny(),
                                      lora_dropout=0.0),
            qformer=QFormerConfig(**QF),
            lane=LaneEncoderConfig(d_model=16, nhead=2, num_layers=1),
            ltsf=LTSFConfig(d_model=16, polygon_embed_dim=16)))
    state = TrajectoryModel(cfg.model, 6, 6).state_dict()
    return Predictor(cfg, state, batch_size=2, tokenizer=ByteTokenizer(),
                     quantize_decode=quantize, quantize_kv=quantize,
                     device="cpu")


def test_predictor_speculative_paths(stacks):
    """``generate_context(speculative=True)`` with ``sampling=None`` is
    the greedy request's text and ids; its sampled form repeats with an
    equal generator; ``generate_context_batched(speculative=True)`` gives
    the plain pool's ids; ``generate_texts(speculative=True)`` is the
    greedy texts; the pool's window defaults are 8 greedy and 4
    sampled."""
    from tsue_tpu_torch.data import make_synthetic_tracks
    from tsue_tpu_torch.eval.generation import generate_texts
    from tsue_tpu_torch.eval.speculative import SpeculativeProgram
    from tsue_tpu_torch.serve import Predictor
    assert Predictor._spec_window(False, None, None) == 1
    assert Predictor._spec_window(True, None, None) == 8
    assert Predictor._spec_window(True, None,
                                  SamplingConfig(do_sample=False)) == 8
    assert Predictor._spec_window(True, None, SamplingConfig()) == 4
    assert Predictor._spec_window(True, 3, SamplingConfig()) == 3
    with pytest.raises(ValueError, match="speculative=True"):
        Predictor._spec_window(False, 4, None)
    pred = _predictor(quantize=True)
    tracks = make_synthetic_tracks(num_tracks=3, track_len=300, seed=9)
    greedy = pred.generate_context(tracks, max_new_tokens=10,
                                   sampling=SamplingConfig(do_sample=False))
    ids = pred.last_request["ids"]
    assert isinstance(pred.generation_program(10, 512, None, True),
                      SpeculativeProgram)
    assert pred.generate_context(tracks, max_new_tokens=10,
                                 speculative=True) == greedy
    np.testing.assert_array_equal(pred.last_request["ids"], ids)
    assert all("forwards" in c for c in pred.last_request["chunks"])
    sampled = [pred.generate_context(
        tracks, max_new_tokens=10, sampling=SamplingConfig(),
        speculative=True, generator=torch.Generator().manual_seed(5))
        for _ in range(2)]
    assert sampled[0] == sampled[1]
    for batched in (False, True):     # every serving width, speculative
        assert pred.prepare_generation(
            4, speculative=True, sampling=SamplingConfig(),
            batched=batched) is pred
    kw = dict(max_new_tokens=10, seed=4, sampling=SamplingConfig(),
              num_slots=2, chunk=3)
    plain = pred.generate_context_batched(tracks, **kw)
    plain_ids = pred.last_request["ids"]
    assert pred.generate_context_batched(tracks, speculative=True,
                                         **kw) == plain
    for a, b in zip(pred.last_request["ids"], plain_ids):
        np.testing.assert_array_equal(a, b)
    reqs, _, _, _ = pred.generation_requests(tracks)
    args = [torch.from_numpy(np.stack([r[k] for r in reqs]))
            for k in ("vision", "prompt_ids", "prompt_mask")]
    texts = generate_texts(pred._mllm(), pred.tokenizer, *args, None,
                           max_new_tokens=10, speculative=True)
    assert texts == generate_texts(pred._mllm(), pred.tokenizer, *args,
                                   None, max_new_tokens=10,
                                   cfg=SamplingConfig(do_sample=False))
    assert texts == [r["context"] for r in greedy]


def test_serve_command_speculative_equals_library(tmp_path):
    """``serve --generate --speculative`` writes the text of
    ``Predictor.generate_context(speculative=True)`` on the same weights,
    and through the continuous batcher that of
    ``generate_context_batched(speculative=True)``."""
    from tsue_tpu_torch.cli import _common, serve
    from tsue_tpu_torch.data import make_synthetic_tracks
    argv = ["--tiny", "--device", "cpu", "--generate", "--speculative",
            "--synthetic-tracks", "2", "--serve-batch-size", "2",
            "--max-new-tokens", "6"]
    args = serve.parser().parse_args(argv)
    cfg = _common.apply_overrides(port_config.get_preset(args.preset), args)
    pred = serve.build_predictor(args, cfg)
    tracks = make_synthetic_tracks(num_tracks=2,
                                   vision_dim=cfg.data.vision_dim,
                                   seed=cfg.data.split_seed)
    for batcher, want in (
            ("static", pred.generate_context(tracks, max_new_tokens=6,
                                             speculative=True)),
            ("continuous", pred.generate_context_batched(
                tracks, max_new_tokens=6, speculative=True))):
        out = tmp_path / f"{batcher}.jsonl"
        meta = serve.main(argv + ["--batcher", batcher, "--out", str(out)])
        assert meta["mode"] == "generate" and meta["results"] == len(want)
        got = [json.loads(ln) for ln in out.read_text().splitlines() if ln]
        assert got == want


# the per-query masks of the two attention routes ---------------------------

def _window_masks(rng, B, W, S, P):
    """(B, W, S) in-window causal masks over a cache of S slots, prefix P
    valid up to each row's length, a row with no valid key."""
    plen = rng.integers(1, P + 1, B)
    step = rng.integers(0, S - P - W + 1, B)
    k = np.arange(S)[None, None, :]
    upper = (P + step[:, None] + np.arange(W)[None, :])[..., None]
    m = ((k < plen[:, None, None]) | ((k >= P) & (k <= upper)))
    m[1] = False
    return m.astype(np.int32)


@pytest.mark.parametrize("form", ["b_w_s", "b_1_w_s"])
def test_per_query_masks_match_jax(form):
    """A (B, W, S) window mask, or the same as (B, 1, W, S), through the
    port's ``dot_product_attention`` (flash's plain version) and
    ``attend_int8_kv_plain`` equals JAX's ``flash_attention`` (its XLA
    route for masks that are not 2-D) and ``attend_int8_kv`` (the XLA
    route, and the Pallas kernel in interpret mode under
    ``kv_attn_impl("kernel")``, whose ``_mask3`` takes both forms); a
    masked-out row is the uniform mean of V on every route."""
    rng = np.random.default_rng(13)
    B, W, S, P, Hq, Hkv, D = 3, 4, 20, 8, 4, 2, 64
    q = rng.standard_normal((B, W, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    m3 = _window_masks(rng, B, W, S, P)
    ours_mask = torch.from_numpy(m3 if form == "b_w_s" else m3[:, None])
    jmask = jnp.asarray(m3[:, None])
    ours = dot_product_attention(*_torch(q, k, v), mask=ours_mask)
    theirs = jax_flash_attention(*map(jnp.asarray, (q, k, v)), mask=jmask)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
    mean_v = np.repeat(v[1].mean(0), Hq // Hkv, axis=0)
    np.testing.assert_allclose(ours[1].numpy(),
                               np.broadcast_to(mean_v, (W, Hq, D)), **TOL)
    pc = quantize_cache([tuple(_torch(k, v))])[0]
    jc = jax_kv.quantize_cache([tuple(map(jnp.asarray, (k, v)))])[0]
    ours = attend_int8_kv_plain(torch.from_numpy(q), pc, ours_mask)
    for route in ("xla", "kernel"):
        with jax_kv.kv_attn_impl(route):
            theirs = jax_kv.attend_int8_kv(
                jnp.asarray(q), jc,
                jmask if route == "xla" else jnp.asarray(
                    m3 if form == "b_w_s" else m3[:, None]))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL,
                                   err_msg=route)
    # a (B, W, S) mask that repeats a (B, S) key mask is that key mask
    key = torch.from_numpy(m3[:, -1])
    rep = key[:, None].expand(B, W, S)
    assert torch.equal(attend_int8_kv_plain(torch.from_numpy(q), pc, rep),
                       attend_int8_kv_plain(torch.from_numpy(q), pc, key))
