"""The port's continuous batcher (``tsue_tpu_torch.serve_batching``), its
per-row decode step and its per-row sampler, against the JAX package at
``LlamaConfig.tiny`` (vocabulary 64), mirroring ``tests/test_serve_batching.py``.

Flax initialises the MultiModalLLM and ``convert.load_flax_params`` carries
the weights.  The per-row decode step's logits and caches agree with the
JAX package's within atol = rtol = 1e-4 (fp32 on both sides, summed in
other orders), and the pool's greedy ids equal the JAX pool's.  Sampled ids
cannot match the JAX package's: the port draws from torch generators, not
threefry keys (ROADMAP, "Dropout masks will not match bitwise"), so the
sampled contracts are held within the port: a request's tokens equal its
single-request decode, whatever the pool geometry, the chunk, the refill
policy or the co-batched traffic."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tsue_tpu import config as jax_config
from tsue_tpu.models.fusion import MultiModalLLM as JaxMLLM
from tsue_tpu.ops import sampling as jax_sampling
from tsue_tpu.serve_batching import ContinuousBatcher as JaxBatcher
from tsue_tpu_torch import config as port_config
from tsue_tpu_torch.convert import load_flax_params
from tsue_tpu_torch.models.fusion import MultiModalLLM
from tsue_tpu_torch.ops import sampling as port_sampling
from tsue_tpu_torch.ops.sampling import (SamplingConfig, process_and_sample,
                                         process_and_sample_per_row)
from tsue_tpu_torch.serve_batching import ContinuousBatcher

VOCAB = 64
EOS = VOCAB - 1
PROMPT_LEN = 6
T_VIS = 4
MAX_NEW = 8
TOL = dict(atol=1e-4, rtol=1e-4)
SAMPLED = dict(temperature=1.0, top_k=8, top_p=0.9, repetition_penalty=1.2,
               no_repeat_ngram_size=3)
QF = dict(hidden_size=32, num_heads=2, num_encoder_layers=1,
          num_decoder_layers=1, num_query_tokens=4, dropout=0.0)


def _stacks(use_vision: bool):
    llama = dataclasses.replace(jax_config.LlamaConfig.tiny(VOCAB),
                                lora_dropout=0.0)
    jm = JaxMLLM(llama, jax_config.QFormerConfig(**QF),
                 use_vision=use_vision)
    rng = np.random.default_rng(0)
    vision = jnp.asarray(rng.standard_normal((1, T_VIS, 512)), jnp.float32)
    ids = jnp.asarray(rng.integers(3, VOCAB - 1, (1, PROMPT_LEN)), jnp.int32)
    mask = jnp.ones((1, PROMPT_LEN), jnp.int32)
    params = jax.device_get(jax.jit(jm.init, static_argnums=4)(
        {"params": jax.random.key(0)}, vision if use_vision else None, ids,
        mask, True)["params"])
    # flax inits lora_b = 0; give the adapters mass
    flat = traverse_util.flatten_dict(params)
    for key in flat:
        if key[-1] == "lora_b":
            flat[key] = rng.normal(0, 0.05, flat[key].shape).astype(
                np.float32)
    params = traverse_util.unflatten_dict(flat)
    port = MultiModalLLM(port_config.LlamaConfig(**dataclasses.asdict(llama)),
                         port_config.QFormerConfig(**QF),
                         use_vision=use_vision)
    return jm, {"params": params}, load_flax_params(port, params).eval()


@pytest.fixture(scope="module")
def stacks():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield {v: _stacks(v) for v in (True, False)}
    torch.set_num_threads(prev)


def _requests(n, seed=7, vision=True):
    """n requests with varied prompts, vision and caps (the JAX test's)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(2, PROMPT_LEN + 1))
        ids = np.zeros(PROMPT_LEN, np.int32)
        ids[:plen] = rng.integers(3, VOCAB - 1, plen)
        mask = np.zeros(PROMPT_LEN, np.int32)
        mask[:plen] = 1
        r = {"vision": rng.standard_normal((T_VIS, 512)).astype(np.float32),
             "prompt_ids": ids, "prompt_mask": mask,
             "max_new": int(rng.integers(2, MAX_NEW + 1))}
        if not vision:
            del r["vision"]
        reqs.append(r)
    return reqs


def _with_generators(reqs, base=1000):
    return [dict(r, generator=torch.Generator().manual_seed(base + i))
            for i, r in enumerate(reqs)]


def _pool(mllm, sampling, **kw):
    kw = {"num_slots": 2, "chunk": 3, "device": "cpu", **kw}
    return ContinuousBatcher(mllm, sampling, prompt_len=PROMPT_LEN,
                             max_new_tokens=MAX_NEW, eos_id=EOS, **kw)


def _same(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")


def _jit(jm, method, cache_len):
    """A jitted JAX MLLM method whose last argument is ``cache_len``."""
    fn = getattr(jm, method)
    return jax.jit(lambda v, *a: jm.apply(v, *a, cache_len, method=fn))


def _prefilled(jm, jv, port, B=3, seed=3):
    rng = np.random.default_rng(seed)
    vision = rng.standard_normal((B, T_VIS, 512)).astype(np.float32)
    ids = rng.integers(3, VOCAB - 1, (B, PROMPT_LEN)).astype(np.int32)
    mask = np.ones((B, PROMPT_LEN), np.int32)
    mask[1, 4:] = 0
    cache_len = QF["num_query_tokens"] + PROMPT_LEN + MAX_NEW
    jc, _, jplen, jfmask = _jit(jm, "prefill", cache_len)(
        jv, jnp.asarray(vision), jnp.asarray(ids), jnp.asarray(mask))
    pc, _, pplen, pfmask = port.prefill(torch.from_numpy(vision),
                                        torch.from_numpy(ids),
                                        torch.from_numpy(mask), cache_len)
    tok = rng.integers(3, VOCAB - 1, (B,)).astype(np.int32)
    return (jc, jplen, jfmask), (pc, pplen, pfmask), tok, cache_len


@torch.inference_mode()
def test_vector_decode_step_matches_jax(stacks):
    """``decode_step`` with (B,) per-row steps: logits and every cache row
    equal the JAX package's vector form after each of three steps."""
    jm, jv, port = stacks[True]
    (jc, jplen, jfmask), (pc, pplen, pfmask), tok, cache_len = _prefilled(
        jm, jv, port)
    step = _jit(jm, "decode_step", cache_len)
    for t in range(3):
        steps = np.array([t, 2 * t + 1, t + 3], np.int32)
        jl, jc = step(jv, jnp.asarray(tok), jnp.asarray(steps), jplen, jc,
                      jfmask)
        pl = port.decode_step(torch.from_numpy(tok).long(),
                              torch.from_numpy(steps).long(), pplen, pc,
                              pfmask, cache_len)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        for (jk, jvv), (pk, pv) in zip(jc, pc):
            np.testing.assert_allclose(pk.numpy(), np.asarray(jk), **TOL)
            np.testing.assert_allclose(pv.numpy(), np.asarray(jvv), **TOL)
        tok = np.array(jnp.argmax(jl, -1), np.int32)


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["fp32", "int8"])
@torch.inference_mode()
def test_scalar_and_vector_decode_agree(stacks, quantize_kv):
    """The port's int and (B,) step forms give the same bits (logits and
    caches) when every row is at the same step, over the fp32 and the int8
    cache."""
    from tsue_tpu_torch.ops.kv_quant import quantize_cache
    jm, jv, port = stacks[True]
    _, (pc, pplen, pfmask), tok, cache_len = _prefilled(jm, jv, port)
    if quantize_kv:
        pc = quantize_cache(pc)
    vc = [tuple(c.clone() for c in layer) for layer in pc]
    tok = torch.from_numpy(tok).long()
    for step in range(3):
        ls = port.decode_step(tok, step, pplen, pc, pfmask, cache_len)
        lv = port.decode_step(tok, torch.full((3,), step), pplen, vc, pfmask,
                              cache_len)
        assert torch.equal(ls, lv)
        for a, b in zip(pc, vc):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        tok = ls.argmax(-1)


@pytest.mark.parametrize("case", ["vision", "text", "vision_int8_kv"])
def test_pool_greedy_matches_jax(stacks, case):
    """Greedy ids of the port's pool equal the JAX ContinuousBatcher's, with
    mixed caps and refill traffic (five requests through two slots)."""
    vision = case.startswith("vision")
    jm, jv, port = stacks[vision]
    kv = case.endswith("int8_kv")
    reqs = _requests(5, seed=11, vision=vision)
    theirs = JaxBatcher(jm, jv, jax_sampling.SamplingConfig(do_sample=False),
                        num_slots=2, prompt_len=PROMPT_LEN,
                        max_new_tokens=MAX_NEW, eos_id=EOS, chunk=3,
                        quantize_kv=kv).run(reqs)
    ours = _pool(port, SamplingConfig(do_sample=False), quantize_kv=kv
                 ).run(reqs)
    _same(ours, [np.asarray(x) for x in theirs])
    assert sum(len(x) for x in ours) > 10


def _processed(logits, hist, hlen, cfg, ns):
    lo = ns.apply_repetition_penalty(logits, hist, hlen,
                                     cfg.repetition_penalty)
    lo = ns.apply_no_repeat_ngram(lo, hist, hlen, cfg.no_repeat_ngram_size)
    return lo / cfg.temperature


def test_per_row_sampler_key_free_stages_match_jax():
    """The per-row sampler's key-free stages (the processed logits, the
    (k+1) slot logits, t_keep) equal the JAX package's, ties included, and
    its greedy form is the argmax of the processed logits."""
    rng = np.random.default_rng(5)
    B, L, k = 4, 10, 8
    logits = rng.standard_normal((B, VOCAB)).astype(np.float32)
    logits[1, 10:20] = logits[1].max()          # a tie class at the k-th
    hist = rng.integers(3, VOCAB - 1, (B, L)).astype(np.int32)
    hlen = rng.integers(1, L, (B,)).astype(np.int32)
    cfg = SamplingConfig(temperature=0.9, top_k=k, top_p=0.9,
                         repetition_penalty=1.2, no_repeat_ngram_size=3)
    jp = _processed(jnp.asarray(logits), jnp.asarray(hist), jnp.asarray(hlen),
                    cfg, jax_sampling)
    pp = _processed(torch.from_numpy(logits), torch.from_numpy(hist).long(),
                    torch.from_numpy(hlen).long(), cfg, port_sampling)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), **TOL)
    js, jidx, jt, _ = jax_sampling._topk_topp_slots(jp, k, cfg.top_p)
    ps, pidx, pt, _ = port_sampling._topk_topp_slots(pp, k, cfg.top_p)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), **TOL)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert float(pt[1]) > 1
    greedy = process_and_sample_per_row(
        torch.from_numpy(logits), [None] * B, torch.from_numpy(hist).long(),
        torch.from_numpy(hlen).long(), cfg._replace(do_sample=False))
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.asarray(pp).argmax(-1))


@pytest.mark.parametrize("top_k", [8, 0], ids=["sliced", "full_vocab"])
def test_per_row_sampler_equals_single_row_draws(top_k):
    """Row b of the per-row sampler is the one-row ``process_and_sample``
    with row b's generator: the same token, and the generator left in the
    same state (it consumed exactly the same draws)."""
    rng = np.random.default_rng(6)
    B, L = 5, 10
    logits = torch.from_numpy(rng.standard_normal((B, VOCAB)).astype(
        np.float32))
    hist = torch.from_numpy(rng.integers(3, VOCAB - 1, (B, L))).long()
    hlen = torch.from_numpy(rng.integers(1, L, (B,))).long()
    cfg = SamplingConfig(**{**SAMPLED, "top_k": top_k})
    gens = [torch.Generator().manual_seed(40 + b) for b in range(B)]
    solo_gens = [torch.Generator().manual_seed(40 + b) for b in range(B)]
    got = process_and_sample_per_row(logits, gens, hist, hlen, cfg)
    for b in range(B):
        solo = process_and_sample(logits[b:b + 1], solo_gens[b],
                                  hist[b:b + 1], hlen[b:b + 1], cfg)
        assert int(got[b]) == int(solo[0])
        assert torch.equal(torch.rand(3, generator=gens[b]),
                           torch.rand(3, generator=solo_gens[b]))


@torch.inference_mode()
def _reference_decode(port, req, sampling):
    """One request decoded alone with the shared-generator sampler and the
    int step: the contract the pool's rows are held to."""
    cache_len = QF["num_query_tokens"] + PROMPT_LEN + MAX_NEW
    vision = torch.from_numpy(req["vision"])[None] if "vision" in req \
        else None
    ids = torch.from_numpy(req["prompt_ids"])[None]
    mask = torch.from_numpy(req["prompt_mask"])[None]
    caches, last_hidden, plen, fmask = port.prefill(vision, ids, mask,
                                                    cache_len)
    logits = port.llama.logits_from_hidden(last_hidden)
    history = torch.cat([ids.long(), torch.zeros(1, MAX_NEW).long()], 1)
    hlen = mask.sum(1).long()
    g = torch.Generator().manual_seed(req["seed"])
    toks = []
    for step in range(req["max_new"]):
        tok = process_and_sample(logits, g, history, hlen, sampling)
        toks.append(int(tok[0]))
        if toks[-1] == EOS:
            break
        history[0, hlen[0]] = tok[0]
        hlen = hlen + 1
        logits = port.decode_step(tok, step, plen, caches, fmask, cache_len)
    if toks and toks[-1] == EOS:
        toks = toks[:-1]
    return np.asarray(toks, np.int32)


@pytest.mark.parametrize("vision", [True, False], ids=["vision", "text"])
def test_pool_matches_single_request_decode(stacks, vision):
    """Sampled: every request through a pool of two slots with refill
    traffic equals its single-request decode from the same seed."""
    _, _, port = stacks[vision]
    sampling = SamplingConfig(**SAMPLED)
    reqs = [dict(r, seed=1000 + i)
            for i, r in enumerate(_requests(5, vision=vision))]
    got = _pool(port, sampling).run(_with_generators(reqs))
    for i, req in enumerate(reqs):
        np.testing.assert_array_equal(got[i],
                                      _reference_decode(port, req, sampling),
                                      err_msg=f"request {i}")


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_pool_insensitive_to_geometry(stacks, sampled):
    """The same requests through other pool sizes, chunks, admission
    orders and the batch-synchronous policy give the same ids."""
    _, _, port = stacks[True]
    sampling = SamplingConfig(**SAMPLED) if sampled else \
        SamplingConfig(do_sample=False)
    reqs = _requests(4, seed=11)
    a = _pool(port, sampling, num_slots=1, chunk=8).run(
        _with_generators(reqs))
    b = _pool(port, sampling, num_slots=4, chunk=2).run(
        list(reversed(_with_generators(reqs))))[::-1]
    c = _pool(port, sampling, num_slots=3, chunk=1).run(
        _with_generators(reqs), refill=False)
    _same(a, b)
    _same(a, c)


def test_pool_seeds_requests_from_seed_and_index(stacks):
    """A request without a generator draws from ``step_generator(seed,
    i)``: the same seed gives the same ids, another seed other ids."""
    from tsue_tpu_torch.utils.random import step_generator
    _, _, port = stacks[True]
    pool = _pool(port, SamplingConfig(**SAMPLED))
    reqs = _requests(4, seed=3)
    for r in reqs:
        r["max_new"] = MAX_NEW
    a = pool.run(reqs, seed=5)
    _same(a, pool.run([dict(r, generator=step_generator(5, i))
                       for i, r in enumerate(reqs)]))
    assert any(not np.array_equal(x, y)
               for x, y in zip(a, pool.run(reqs, seed=6)))
    assert pool.last_run["admissions"] == 4
    assert 0 < pool.last_run["mean_live_slots"] <= 2


def test_max_new_contract(stacks):
    """A cap outside [0, max_new_tokens] raises before any work; a cap of
    0 gives an empty, order-aligned result and takes no slot."""
    _, _, port = stacks[True]
    pool = _pool(port, SamplingConfig(**SAMPLED))
    reqs = _with_generators(_requests(3, seed=21))
    with pytest.raises(ValueError, match="max_new=9"):
        pool.run([reqs[0], dict(reqs[1], max_new=9)])
    with pytest.raises(ValueError, match="max_new=-1"):
        pool.run([dict(reqs[0], max_new=-1)])
    reqs = _with_generators(_requests(3, seed=21))
    reqs[1] = dict(reqs[1], max_new=0)
    out = pool.run(reqs)
    assert out[1].shape == (0,) and pool.last_run["admissions"] == 2
    solo = _with_generators(_requests(3, seed=21))
    solo = pool.run([solo[0], solo[2]])
    _same([out[0], out[2]], solo)
    assert pool.run([dict(reqs[0], max_new=0)])[0].shape == (0,)


def test_quantized_kv_pool_isolated(stacks):
    """The int8 pool cache: a request's sampled tokens do not depend on the
    pool geometry or the traffic, and the pool really holds int8."""
    _, _, port = stacks[True]
    sampling = SamplingConfig(**SAMPLED)
    reqs = _requests(4, seed=13)
    a = _pool(port, sampling, num_slots=1, chunk=8, quantize_kv=True).run(
        _with_generators(reqs))
    b = _pool(port, sampling, num_slots=4, chunk=2, quantize_kv=True).run(
        list(reversed(_with_generators(reqs))))[::-1]
    _same(a, b)
    state = _pool(port, sampling, quantize_kv=True)._init_state()
    assert state.caches[0][0].dtype == torch.int8 and len(state.caches[0]) == 4


def _predictor(fused_head=False):
    from tsue_tpu_torch.config import (DataConfig, ExperimentConfig,
                                       LaneEncoderConfig, LTSFConfig,
                                       ModelConfig, QFormerConfig)
    from tsue_tpu_torch.models.tsue import TrajectoryModel
    from tsue_tpu_torch.serve import Predictor
    cfg = ExperimentConfig(
        name="refuse", data=DataConfig(seq_len=6, out_len=6),
        model=ModelConfig(
            llama=port_config.LlamaConfig.tiny(),
            qformer=QFormerConfig(**QF),
            lane=LaneEncoderConfig(d_model=16, nhead=2, num_layers=1),
            ltsf=LTSFConfig(d_model=16, polygon_embed_dim=16)))
    state = TrajectoryModel(cfg.model, 6, 6).state_dict()
    return Predictor(cfg, state, batch_size=2, fused_head=fused_head,
                     device="cpu")


@pytest.mark.parametrize("what", ["mesh", "fused_head"])
def test_not_taken_raises(stacks, what):
    """What the batcher does not take raises: a mesh whose data axis does
    not divide the slots (the pool shards slot-major over data), and the
    fused head (the JAX package drops it without a word; the port refuses
    it)."""
    from tsue_tpu_torch.parallel.mesh import Mesh
    _, _, port = stacks[True]
    greedy = SamplingConfig(do_sample=False)
    if what == "mesh":
        with pytest.raises(ValueError, match="must divide the mesh's data"):
            _pool(port, greedy, mesh=Mesh(data=4), num_slots=2)
    else:
        with pytest.raises(ValueError, match="fused_head"):
            _predictor(fused_head=True).continuous_batcher(num_slots=2)


def _exp_cfg(c):
    """A tiny TrajectoryModel configuration in the config classes of module
    ``c`` (byte tokenizer, 640-token budget: the prompts fill the 512
    bucket)."""
    return c.ExperimentConfig(
        name="torch_batched",
        data=c.DataConfig(seq_len=6, out_len=6, max_length=640),
        model=c.ModelConfig(
            llama=dataclasses.replace(c.LlamaConfig.tiny(), lora_dropout=0.0),
            qformer=c.QFormerConfig(**QF),
            lane=c.LaneEncoderConfig(d_model=16, nhead=2, num_layers=1),
            ltsf=c.LTSFConfig(d_model=16, polygon_embed_dim=16)))


@pytest.mark.parametrize("quantize_decode", [False, True],
                         ids=["fp32", "int8"])
def test_predictor_batched_greedy_matches_jax(stacks, quantize_decode):
    """The slice as a whole: ``Predictor.generate_context_batched`` (greedy,
    three tracks through two slots, 10 new tokens, int8 KV) gives the JAX
    predictor's text, with fp32 and with int8 decode weights."""
    from tsue_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
    from tsue_tpu.models.tsue import TrajectoryModel as JaxTrajectoryModel
    from tsue_tpu.serve import Predictor as JaxPredictor
    from tsue_tpu_torch.data import make_synthetic_tracks
    from tsue_tpu_torch.data.tokenizer import ByteTokenizer
    from tsue_tpu_torch.models.tsue import TrajectoryModel
    from tsue_tpu_torch.serve import Predictor
    cfg = _exp_cfg(jax_config)
    model = JaxTrajectoryModel(cfg.model, 6, 6)
    dummy = JaxPredictor(cfg, None, batch_size=2)._dummy_batch()
    params = jax.device_get(jax.jit(
        lambda b: model.init({"params": jax.random.key(0),
                              "dropout": jax.random.key(1)}, b, False))(
        dummy)["params"])
    state = load_flax_params(TrajectoryModel(_exp_cfg(port_config).model, 6,
                                             6), params).state_dict()
    flags = dict(batch_size=2, quantize_decode=quantize_decode,
                 quantize_kv=True)
    tracks = make_synthetic_tracks(num_tracks=3, track_len=300, seed=9)
    greedy = dict(max_new_tokens=10, num_slots=2, chunk=3)
    theirs = JaxPredictor(cfg, params, tokenizer=JaxByteTokenizer(), **flags
                          ).generate_context_batched(
        tracks, sampling=jax_sampling.SamplingConfig(do_sample=False),
        **greedy)
    tp = Predictor(_exp_cfg(port_config), state, tokenizer=ByteTokenizer(),
                   device="cpu", **flags)
    ours = tp.generate_context_batched(
        tracks, sampling=SamplingConfig(do_sample=False), **greedy)
    assert ours == theirs
    assert tp.last_request["width"] == 512
    assert [len(r) for r in tp.last_request["ids"]] == [10, 10, 10]
