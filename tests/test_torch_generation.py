"""Traffic-context generation, ``Predictor.generate_context``, in the port
against the JAX package at ``LlamaConfig.tiny`` (vocabulary 384).

Flax initialises the TrajectoryModel, ``load_flax_params`` carries the
weights, and both predictors generate from the same tracks with each of the
three decode switches alone, all three, and none.  Greedy token ids must be
equal, and the first decode step's logits (or the fused head's top-128
values) agree to 1e-4: fp32 on both sides through a two-layer model and the
prefill, summed in different orders.  Sampled draws come from a torch
generator in the port and from threefry keys in JAX, so the port is checked
on its own for reproducible and generator-dependent sampling."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tsue_tpu import config as jax_config
from tsue_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from tsue_tpu.eval.generation import make_generate_fn as jax_make_generate_fn
from tsue_tpu.models.tsue import TrajectoryModel as JaxTrajectoryModel
from tsue_tpu.ops.lmhead_topk import lmhead_topk as jax_lmhead_topk
from tsue_tpu.ops.sampling import SamplingConfig as JaxSamplingConfig
from tsue_tpu.serve import Predictor as JaxPredictor
from tsue_tpu_torch import config as port_config
from tsue_tpu_torch.convert import load_flax_params
from tsue_tpu_torch.data import make_synthetic_tracks
from tsue_tpu_torch.data.tokenizer import ByteTokenizer
from tsue_tpu_torch.data.text_dataset import build_track_text_dataset
from tsue_tpu_torch.eval.generation import head_arrays, make_generate_fn
from tsue_tpu_torch.models.tsue import TrajectoryModel
from tsue_tpu_torch.ops.lmhead_topk import lmhead_topk
from tsue_tpu_torch.ops.sampling import SamplingConfig
from tsue_tpu_torch.serve import Predictor

FLAGS = {
    "none": {},
    "int8": dict(quantize_decode=True),
    "fused": dict(fused_head=True),
    "int8_kv": dict(quantize_kv=True),
    "all": dict(quantize_decode=True, fused_head=True, quantize_kv=True),
}
MAX_NEW = 10          # two decode chunks of 5 (early-exit chunk 8)
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfg(c):
    """The test configuration in the config classes of module ``c``."""
    tok = ByteTokenizer()
    return c.ExperimentConfig(
        name="torch_generation",
        data=c.DataConfig(seq_len=6, out_len=6, max_length=640),
        model=c.ModelConfig(
            llama=dataclasses.replace(c.LlamaConfig.tiny(tok.vocab_size),
                                      lora_dropout=0.0),
            qformer=c.QFormerConfig(hidden_size=32, num_heads=2,
                                    num_encoder_layers=1,
                                    num_decoder_layers=1,
                                    num_query_tokens=4, dropout=0.0),
            lane=c.LaneEncoderConfig(d_model=16, nhead=2, num_layers=1),
            ltsf=c.LTSFConfig(d_model=16, polygon_embed_dim=16)))


@pytest.fixture(scope="module")
def weights():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = _cfg(jax_config)
    model = JaxTrajectoryModel(cfg.model, 6, 6)
    dummy = JaxPredictor(cfg, None, batch_size=2)._dummy_batch()
    params = jax.device_get(jax.jit(
        lambda b: model.init({"params": jax.random.key(0),
                              "dropout": jax.random.key(1)}, b, False))(
        dummy)["params"])
    # flax inits lora_b = 0; give the adapters mass
    flat = traverse_util.flatten_dict(params)
    rng = np.random.default_rng(0)
    for key in flat:
        if key[-1] == "lora_b":
            flat[key] = rng.normal(0, 0.05, flat[key].shape).astype(
                np.float32)
    params = traverse_util.unflatten_dict(flat)
    state = load_flax_params(TrajectoryModel(_cfg(port_config).model, 6, 6),
                             params).state_dict()
    yield params, state
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tracks():
    return make_synthetic_tracks(num_tracks=3, track_len=300, seed=9)


def _predictors(weights, flags):
    params, state = weights
    jp = JaxPredictor(_cfg(jax_config), params, batch_size=2,
                      tokenizer=JaxByteTokenizer(), **flags)
    tp = Predictor(_cfg(port_config), state, batch_size=2,
                   tokenizer=ByteTokenizer(), device="cpu", **flags)
    return jp, tp


def _prompts(tp, tracks):
    ds = build_track_text_dataset(tracks, tp.cfg.data, tp.tokenizer,
                                  require_context=False,
                                  require_vision=False)
    mask = np.asarray(ds.attention_mask * (ds.labels == -100), np.int32)
    ids, mask, width = tp._bucket_prompts(
        np.asarray(ds.input_ids, np.int32) * mask, mask)
    return ds.vision[:2], ids[:2], mask[:2], width


@pytest.mark.parametrize("flags", list(FLAGS))
def test_greedy_generation_matches_jax(weights, tracks, flags):
    jp, tp = _predictors(weights, FLAGS[flags])
    vision, ids, mask, width = _prompts(tp, tracks)
    assert width == 512 and ids.shape == (2, 512)
    greedy_j = JaxSamplingConfig(do_sample=False)
    greedy_t = SamplingConfig(do_sample=False)

    jgen, variables = jp._generation_fn(MAX_NEW, False, greedy_j,
                                        prompt_len=width)
    ref = np.asarray(jgen(variables, jnp.asarray(vision), jnp.asarray(ids),
                          jnp.asarray(mask), jax.random.key(0)))
    prog = tp.generation_program(MAX_NEW, width, greedy_t)
    out = prog(torch.from_numpy(vision), torch.from_numpy(ids),
               torch.from_numpy(mask), None)
    assert out.dtype == torch.int32 and out.shape == (2, MAX_NEW)
    assert prog.steps == MAX_NEW
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(np.unique(ref)) > 2             # a real decode, not one id

    # the first decode step: prefill, then the head (or the fused top-128)
    mllm = jp._mllm_module()
    cache_len = 4 + width + MAX_NEW
    _, last_j, _, _ = mllm.apply(variables, jnp.asarray(vision),
                                 jnp.asarray(ids), jnp.asarray(mask),
                                 cache_len, method=mllm.prefill)
    with torch.inference_mode():
        tmllm = tp._mllm()
        _, last_t, _, _ = tmllm.prefill(torch.from_numpy(vision),
                                        torch.from_numpy(ids),
                                        torch.from_numpy(mask), cache_len)
        np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), **TOL)
        if tp.fused_head:
            w, q = head_arrays(tmllm)
            jw = jq = None
            if q is None:
                jw = variables["params"]["llama"]["model"]["embed_tokens"][
                    "embedding"]
            else:
                jq = (variables["quant"]["llama"]["lm_head_w8"],
                      variables["quant"]["llama"]["lm_head_scale"])
            ref_v, _ = jax_lmhead_topk(last_j, jw, None, quant=jq,
                                       interpret=True)
            out_v, _ = lmhead_topk(last_t, w, None, quant=q)
            np.testing.assert_allclose(out_v.numpy(), np.asarray(ref_v),
                                       **TOL)
        else:
            ref_l = mllm.apply(variables, last_j,
                               method=lambda m, h: m.llama_mod
                               .logits_from_hidden(h, quant_ok=True))
            out_l = tmllm.llama.logits_from_hidden(last_t, quant_ok=True)
            np.testing.assert_allclose(out_l.numpy(), np.asarray(ref_l),
                                       **TOL)

    # the whole request: texts per track, two chunks (3 tracks, batch 2)
    ref_txt = jp.generate_context(tracks, max_new_tokens=MAX_NEW,
                                  sampling=greedy_j)
    out_txt = tp.generate_context(tracks, max_new_tokens=MAX_NEW,
                                  sampling=greedy_t)
    assert out_txt == ref_txt


def test_sampled_generation_reproducible(weights, tracks):
    _, tp = _predictors(weights, FLAGS["all"])
    runs = [tp.generate_context(tracks, max_new_tokens=MAX_NEW,
                                generator=torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert [r["track_id"] for r in runs[0]] == [0, 1, 2]


@pytest.mark.parametrize("fused", [False, True])
def test_chunked_early_exit_stops_on_eos(weights, tracks, fused):
    """When every row emits EOS in the first chunk the decode stops after
    that chunk; finished rows emit pad, as in the JAX generator."""
    jp, tp = _predictors(weights, dict(fused_head=fused))
    vision, ids, mask, width = _prompts(tp, tracks)
    vision, ids, mask = (np.repeat(a[:1], 2, axis=0)
                         for a in (vision, ids, mask))
    greedy = SamplingConfig(do_sample=False)
    first = tp.generation_program(1, width, greedy)(
        torch.from_numpy(vision), torch.from_numpy(ids),
        torch.from_numpy(mask), None)
    eos = int(first[0, 0])
    prog = make_generate_fn(tp._mllm(), greedy, 24, width, eos_id=eos,
                            pad_id=0, fused_head=fused)
    assert (prog.chunk, prog.n_chunks) == (8, 3)
    out = prog(torch.from_numpy(vision), torch.from_numpy(ids),
               torch.from_numpy(mask), None)
    assert prog.steps == 8
    assert out[:, 0].tolist() == [eos, eos] and not out[:, 1:].any()
    jgen = jax_make_generate_fn(jp._mllm_module(),
                                JaxSamplingConfig(do_sample=False), 24,
                                width, eos_id=eos, pad_id=0,
                                fused_head=fused)
    ref = jgen({"params": weights[0]["mllm"]}, jnp.asarray(vision),
               jnp.asarray(ids), jnp.asarray(mask), jax.random.key(0))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_compile_cap_and_unconditionable_tracks(weights, tracks):
    """``compile_cap`` decodes every request for the cap and trims to
    ``max_new_tokens`` (a greedy prefix), a request above the cap raises,
    and a track without vision embeddings comes back as an error record."""
    _, tp = _predictors(weights, {})
    greedy = SamplingConfig(do_sample=False)
    full = tp.generate_context(tracks[:2], max_new_tokens=8, sampling=greedy)
    full_ids = tp.last_request["ids"]
    short = tp.generate_context(tracks[:2], max_new_tokens=5, sampling=greedy,
                                compile_cap=8)
    assert tp.last_request["ids"].shape == (2, 5)
    np.testing.assert_array_equal(tp.last_request["ids"], full_ids[:, :5])
    assert [r["track_id"] for r in short] == [r["track_id"] for r in full]
    with pytest.raises(ValueError, match="compile_cap"):
        tp.generate_context(tracks[:1], max_new_tokens=9, compile_cap=8)
    no_vis = dict(tracks[2], vision_embeddings=None)
    out = tp.generate_context([no_vis, tracks[0]], max_new_tokens=2,
                              sampling=greedy)
    assert [r["track_id"] for r in out] == [0, 2]
    assert "error" in out[1] and "context" in out[0]
    assert tp.generate_context([], max_new_tokens=2) == []
