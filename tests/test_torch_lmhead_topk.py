"""The fused LM head + top-128 and the sampler in the port against the JAX
package (its Pallas head kernel in interpret mode).

Exact-arithmetic inputs (integer hidden states and weights, power-of-two
int8 scales, a penalty of 2, many tied logits) must give identical indices
and bitwise-equal values, ties ordered by ascending index; random inputs
agree to 1e-5 (fp32 products summed in different orders).  The token-state
mask, the slice's slot logits and the greedy picks must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsue_tpu.ops import lmhead_topk as JL
from tsue_tpu.ops import sampling as JS
from tsue_tpu_torch.ops import lmhead_topk as TL
from tsue_tpu_torch.ops import sampling as TS

B, D, V = 4, 64, 512
CFG = dict(temperature=0.9, top_k=40, top_p=0.9, repetition_penalty=2.0,
           no_repeat_ngram_size=3)


def _history(rng, vocab=V, L=24):
    """Histories drawn from a 4-token alphabet per row, so n-grams
    repeat."""
    base = rng.integers(0, vocab - 4, (B, 1))
    hist = (rng.integers(0, 4, (B, L)) + base).astype(np.int32)
    hlen = np.array([L, 17, 2, 0], np.int32)
    return hist, hlen


def _masks(rng):
    hist, hlen = _history(rng)
    jm = JL.token_state_mask(jnp.asarray(hist), jnp.asarray(hlen), V,
                             JS.SamplingConfig(**CFG))
    tm = TL.token_state_mask(torch.from_numpy(hist).long(),
                             torch.from_numpy(hlen).long(), V,
                             TS.SamplingConfig(**CFG))
    return np.asarray(jm), tm


def test_token_state_mask_equal():
    rng = np.random.default_rng(0)
    jm, tm = _masks(rng)
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert (jm & 1).any() and (jm & 2).any()
    for cfg in (dict(CFG, repetition_penalty=1.0),
                dict(CFG, no_repeat_ngram_size=0)):
        hist, hlen = _history(rng)
        ref = JL.token_state_mask(jnp.asarray(hist), jnp.asarray(hlen), V,
                                  JS.SamplingConfig(**cfg))
        out = TL.token_state_mask(torch.from_numpy(hist).long(),
                                  torch.from_numpy(hlen).long(), V,
                                  TS.SamplingConfig(**cfg))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _exact_inputs(rng):
    hidden = rng.integers(-3, 4, (B, D)).astype(np.float32)
    emb = rng.integers(-2, 3, (V, D)).astype(np.float32)
    w8 = rng.integers(-4, 5, (D, V)).astype(np.int8)
    scale = (2.0 ** rng.integers(-3, 2, (V,))).astype(np.float32)
    return hidden, emb, w8, scale


def _both(hidden, emb, mask_np, mask_t, penalty, quant):
    jq = None if quant is None else tuple(map(jnp.asarray, quant))
    tq = None if quant is None else tuple(torch.from_numpy(a) for a in quant)
    jv, ji = JL.lmhead_topk(jnp.asarray(hidden),
                            None if quant else jnp.asarray(emb),
                            None if mask_np is None else jnp.asarray(mask_np),
                            penalty=penalty, quant=jq, interpret=True)
    tv, ti = TL.lmhead_topk(torch.from_numpy(hidden),
                            None if quant else torch.from_numpy(emb),
                            mask_t, penalty=penalty, quant=tq)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("layout", ["tied_fp32", "int8"])
@pytest.mark.parametrize("masked", [False, True])
def test_lmhead_topk_exact_inputs_bitwise(layout, masked):
    rng = np.random.default_rng(1)
    hidden, emb, w8, scale = _exact_inputs(rng)
    jm, tm = _masks(rng) if masked else (None, None)
    quant = (w8, scale) if layout == "int8" else None
    (jv, ji), (tv, ti) = _both(hidden, emb, jm, tm, 2.0, quant)
    assert tv.shape == (B, 128) and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv.view(np.uint32), jv.view(np.uint32))
    assert any(len(np.unique(r)) < 128 for r in tv)      # ties were there


@pytest.mark.parametrize("layout", ["tied_fp32", "int8"])
@pytest.mark.parametrize("masked", [False, True])
def test_lmhead_topk_random_inputs_close(layout, masked):
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((B, D)).astype(np.float32)
    emb = (rng.standard_normal((V, D)) * 0.2).astype(np.float32)
    w8 = rng.integers(-127, 128, (D, V)).astype(np.int8)
    scale = (rng.random(V) * 1e-2).astype(np.float32)
    jm, tm = _masks(rng) if masked else (None, None)
    quant = (w8, scale) if layout == "int8" else None
    (jv, ji), (tv, ti) = _both(hidden, emb, jm, tm, 1.2, quant)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(ti, ji)


def _slice_inputs():
    rng = np.random.default_rng(3)
    vals = np.sort(rng.integers(-6, 6, (B, 128)).astype(np.float32),
                   axis=1)[:, ::-1].copy()
    vals[1, :] = 4.0                      # the whole slice tied
    idx = np.argsort(rng.random((B, 128)), axis=1).astype(np.int32)
    return vals, idx


@pytest.mark.parametrize("p,temp", [(0.9, 0.9), (1.0, 1.0), (0.5, 1.3)])
def test_topk_slice_slots_equal(p, temp):
    vals, idx = _slice_inputs()
    ref = JL.topk_slice_slots(jnp.asarray(vals), jnp.asarray(idx), 40, p,
                              temp)
    out = TL.topk_slice_slots(torch.from_numpy(vals), torch.from_numpy(idx),
                              40, p, temp)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sample_from_topk_slice_greedy_equal():
    vals, idx = _slice_inputs()
    greedy = dict(do_sample=False)
    ref = JL.sample_from_topk_slice(jnp.asarray(vals), jnp.asarray(idx),
                                    jax.random.key(0),
                                    JS.SamplingConfig(**greedy))
    out = TL.sample_from_topk_slice(torch.from_numpy(vals),
                                    torch.from_numpy(idx), None,
                                    TS.SamplingConfig(**greedy))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampled_draws_stay_in_the_kept_set():
    """Every draw is a kept token of the slice: above the top-p cut or in
    the kept part of the tie class."""
    vals, idx = _slice_inputs()
    cfg = TS.SamplingConfig(**dict(CFG, temperature=1.0))
    slot_logits, t_keep, tie, _ = TL.topk_slice_slots(
        torch.from_numpy(vals), torch.from_numpy(idx), cfg.top_k, cfg.top_p,
        1.0)
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = TL.sample_from_topk_slice(torch.from_numpy(vals),
                                        torch.from_numpy(idx), g, cfg)
        for b in range(B):
            pos = int(np.nonzero(idx[b] == int(tok[b]))[0][0])
            kept_above = slot_logits[b, :cfg.top_k] > TS.NEG_INF
            if tie[b, pos] and pos >= int(kept_above.sum()):
                rank = int(tie[b, :pos].sum())
                assert rank < int(t_keep[b])
            else:
                assert bool(kept_above[pos])


def test_topk_topp_slots_and_greedy_chain_equal():
    """The V-wide slot sampler's deterministic part and the greedy
    processor chain of ``ops.sampling`` against the JAX package."""
    rng = np.random.default_rng(4)
    logits = rng.integers(-5, 6, (B, V)).astype(np.float32)
    hist, hlen = _history(rng)
    ref = JS._topk_topp_slots(jnp.asarray(logits), 40, 0.9)
    out = TS._topk_topp_slots(torch.from_numpy(logits), 40, 0.9)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    for a, b in zip(out[3], ref[3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    greedy = dict(CFG, do_sample=False)
    ref = JS.process_and_sample(jnp.asarray(logits), jax.random.key(0),
                                jnp.asarray(hist), jnp.asarray(hlen),
                                JS.SamplingConfig(**greedy))
    out = TS.process_and_sample(torch.from_numpy(logits), None,
                                torch.from_numpy(hist).long(),
                                torch.from_numpy(hlen).long(),
                                TS.SamplingConfig(**greedy))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_plan_rejects_an_unknown_layout():
    """The kernel's plan names its three layouts (the int8 head with fp32
    or bf16 h, the tied fp32 and the tied bf16 head) and checks the name
    before it builds anything, so a wrong layout fails the same way with or
    without a card."""
    assert TL.LAYOUTS == ("int8", "tied_fp32", "tied_bf16")
    with pytest.raises(ValueError, match="layout"):
        TL.lmhead_topk_plan("bf16")
