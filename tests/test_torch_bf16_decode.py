"""The bf16 quantised decode in the port against the JAX package, on the CPU.

A model whose parameters are all bf16 (the JAX package's ``build_mllm_bf16``
substrate, and any served bf16 checkpoint) runs the three decode kernels on
bf16 operands: the int8 product (bf16 x), the int8-KV attention (bf16 q) and
the fused LM head (bf16 h, over the int8 head or the tied bf16 embedding).
Checked here: each kernel's plain version against the Pallas kernel in
interpret mode (the JAX package's ``int8_impl("pallas")`` and
``kv_attn_impl("kernel")``, the fused head) on bf16 inputs from a seeded
numpy generator; one decode step and the teacher-forced logits of a tiny
all-bf16 MultiModalLLM in each quantised mode against the JAX package's;
the ``quality_quant`` command at tiny dims; the ``plain_int8`` scope.

Tolerances, in bf16 ulps (the spacing of bf16 values at |y|: 2^-8 of |y| at
the top of a binade, 2^-7 at its bottom):

- the int8 product on bf16 x: within 1 ulp of each output (measured 1: the
  products are exact in fp32, the two sum in different orders, then round
  once, and a sum on a rounding boundary lands either side), the fp32
  output (the LM head) within 1e-5 of the largest;
- the int8-KV attention on bf16 q: within 1 ulp of each output (both fp32
  throughout, one rounding), or 1e-6 of the largest where an output
  cancels towards 0 (the same floor for every ulp bound here);
- the fused head: equal indices and values on integer inputs (exact logits,
  exact ties); on random inputs values within 1e-5 of the largest and the
  index sets equal apart from logits tied within that;
- the fused head's penalised logits: within one fp32 ulp of the Pallas
  kernel's in interpret mode, where XLA turns the division by the constant
  penalty into a product by its reciprocal; the port's plain version and
  its kernel divide, as the plain sampling chain does;
- the tiny MLLM's logits (fp32, largest about 4.2): one decode step and the
  teacher-forced logits of every mode within 2^-5 of the largest logit
  (measured at most 0.041 with int8 weights, 0.059 with the int8 cache,
  0.052 with both: the bf16 residual stream rounds at other points in the
  two packages, and the JAX package's default int8-KV route dequantises
  to bf16 where the port, as the kernel, keeps fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tsue_tpu import config as jax_config
from tsue_tpu.models.fusion import MultiModalLLM as JaxMLLM
from tsue_tpu.ops import kv_quant as jkv
from tsue_tpu.ops import quant as jq
from tsue_tpu.ops.lmhead_topk import lmhead_topk as jax_lmhead_topk
from tsue_tpu_torch import config as port_config
from tsue_tpu_torch.cli import quality_quant as QQ
from tsue_tpu_torch.convert import load_flax_params
from tsue_tpu_torch.eval.generation import head_arrays
from tsue_tpu_torch.models.fusion import MultiModalLLM
from tsue_tpu_torch.ops import kv_quant as tkv
from tsue_tpu_torch.ops import lmhead_topk as LT
from tsue_tpu_torch.ops import quant as tq
from tsue_tpu_torch.utils.precision import cast_params

BF = torch.bfloat16


def _ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    x = np.abs(np.asarray(x, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(x, 1e-30))) - 7)


def _bf16(a):
    """numpy fp32 -> (bf16 torch tensor, the same values as a jnp bf16
    array)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _assert_ulps(out, ref, ulps, what=""):
    """Within ``ulps`` ulps of each output, or 1e-6 of the largest (fp32
    sums in two orders, where an output cancels towards 0)."""
    out, ref = _np(out), _np(ref)
    d = np.abs(out - ref)
    bad = d > ulps * _ulp(ref) + 1e-6 * np.abs(ref).max()
    assert not bad.any(), (what, float(d.max()), int(bad.sum()))


# --------------------------------------------------------------------------
# 0. the repair: the int8 product on bf16 x
# --------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N", [(16, 2048, 512), (1, 128, 256),
                                   (5, 384, 128)])
def test_int8_matmul_bf16_matches_pallas(M, K, N):
    """bf16 x: the port returns bf16 (x's dtype), within one ulp of the
    Pallas kernel (interpret mode) under ``int8_impl("pallas")``; with
    ``out_dtype=float32`` (the LM head) fp32 within 1e-5 of the largest."""
    rng = np.random.default_rng(M + K)
    xt, xj = _bf16(rng.standard_normal((M, K)))
    w8, s = jq.quantize_weight(jnp.asarray(
        rng.standard_normal((K, N)).astype(np.float32) * 0.05), axis=0)
    w8t, st = torch.from_numpy(np.array(w8)), torch.from_numpy(np.array(s))
    with jq.int8_impl("pallas"):
        ref = jq.int8_matmul(xj, w8, s, interpret=True)
        ref32 = jq.int8_matmul(xj, w8, s, out_dtype=jnp.float32,
                               interpret=True)
    assert ref.dtype == jnp.bfloat16
    out = tq.int8_matmul(xt, w8t, st)
    assert out.dtype == BF and out.shape == (M, N)
    _assert_ulps(out, ref, 1, (M, K, N))
    out32 = tq.int8_matmul(xt, w8t, st, out_dtype=torch.float32)
    assert out32.dtype == torch.float32
    r32 = np.asarray(ref32)
    np.testing.assert_allclose(out32.numpy(), r32, rtol=1e-5,
                               atol=1e-5 * np.abs(r32).max())


def test_int8_matmul_fp32_unchanged_by_the_repair():
    """fp32 x: the repaired plain version gives the bits of the earlier
    formula, ``(x @ w8.to(x.dtype)) * scale``, so the fp32 results (and the
    card's fp32 rows) are unchanged."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((16, 384)).astype(np.float32))
    w8, s = tq.quantize_weight(torch.from_numpy(
        rng.standard_normal((384, 256)).astype(np.float32)))
    out = tq.int8_matmul(x, w8, s)
    assert out.dtype == torch.float32
    assert torch.equal(out, (x @ w8.to(x.dtype)) * s)
    assert torch.equal(tq.int8_matmul_ref(x, w8, s), out)


# --------------------------------------------------------------------------
# the bf16 forms' plain versions against the Pallas kernels
# --------------------------------------------------------------------------

def _cache(rng, B, S, Hkv, D):
    k, _ = _bf16(rng.standard_normal((B, S, Hkv, D)) * 0.5)
    v, _ = _bf16(rng.standard_normal((B, S, Hkv, D)) * 0.5)
    tc = tkv.quantize_cache([(k, v)])[0]
    jc = tuple(jnp.asarray(t.numpy()) for t in tc)
    return tc, jc


@pytest.mark.parametrize("W", [1, 4])
def test_attend_int8_kv_bf16_matches_pallas(W):
    """bf16 q over a cache quantised from bf16 k/v: the port's plain
    version returns bf16, within one ulp of the Pallas kernel (interpret
    mode, ``kv_attn_impl("kernel")``); a key mask with a fully masked row,
    and at W = 4 a per-query (B, 1, W, S) mask."""
    B, S, Hq, Hkv, D = 3, 40, 8, 2, 64
    rng = np.random.default_rng(W)
    tc, jc = _cache(rng, B, S, Hkv, D)
    qt, qj = _bf16(rng.standard_normal((B, W, Hq, D)))
    if W == 1:
        m = (np.arange(S)[None] < np.array([[30], [0], [40]])).astype(
            np.int32)
    else:
        m = (np.arange(S)[None, None, None] <= 20 + np.arange(W)[
            None, None, :, None]).repeat(B, 0).astype(np.int32)
        m[1, 0, 2] = 0
    with jkv.kv_attn_impl("kernel"):
        ref = jkv.attend_int8_kv(qj, jc, jnp.asarray(m), interpret=True)
    assert ref.dtype == jnp.bfloat16
    out = tkv.attend_int8_kv(qt, tc, torch.from_numpy(m))
    assert out.dtype == BF
    _assert_ulps(out, ref, 1, W)


def _head_inputs(rng, B, D, V, exact):
    if exact:      # integers: every logit exact, ties plentiful
        h = rng.integers(-3, 4, (B, D)).astype(np.float32)
        w = rng.integers(-2, 3, (V, D)).astype(np.float32)
        w8 = rng.integers(-4, 5, (D, V)).astype(np.int8)
        scale = (2.0 ** rng.integers(-3, 2, (V,))).astype(np.float32)
    else:
        h = rng.standard_normal((B, D)).astype(np.float32)
        w = (rng.standard_normal((V, D)) * 0.1).astype(np.float32)
        w8q, scale = jq.quantize_weight(jnp.asarray(w), axis=1)
        w8, scale = np.asarray(w8q).T.copy(), np.asarray(scale)
    hist = rng.integers(0, 8, (B, 12))
    mask = np.zeros((B, V), np.int32)
    for b in range(B):
        mask[b, hist[b]] = 1 + (b % 2)          # seen, or banned
    return h, w, w8, scale, mask


@pytest.mark.parametrize("layout", ["int8", "tied_bf16"])
@pytest.mark.parametrize("exact", [True, False])
def test_lmhead_topk_bf16_matches_pallas(layout, exact):
    """bf16 h through the fused head (the int8 head, or the tied bf16
    embedding) against the Pallas kernel in interpret mode, with the
    penalty and the ban: on integer inputs equal indices and values; on
    random ones values within 1e-5 of the largest and the index sets equal
    apart from logits tied within that."""
    B, D, V = 3, 64, 256
    rng = np.random.default_rng(5 + exact)
    h, w, w8, scale, mask = _head_inputs(rng, B, D, V, exact)
    ht, hj = _bf16(h)
    if layout == "int8":
        args_t = dict(weight=None, quant=(torch.from_numpy(w8),
                                          torch.from_numpy(scale)))
        args_j = dict(weight=None, quant=(jnp.asarray(w8),
                                          jnp.asarray(scale)))
    else:
        wt, wj = _bf16(w)
        args_t, args_j = dict(weight=wt), dict(weight=wj)
    rv, ri = jax_lmhead_topk(hj, mask=jnp.asarray(mask), penalty=1.3,
                             interpret=True, **args_j)
    vals, idx = LT.lmhead_topk(ht, mask=torch.from_numpy(mask), penalty=1.3,
                               **args_t)
    rv, ri = np.asarray(rv), np.asarray(ri)
    if exact:
        # exact logits; a penalised one may sit one fp32 ulp from the
        # interpreter's (a product by the reciprocal), and order with it
        np.testing.assert_allclose(vals.numpy(), rv, rtol=2 ** -23, atol=0)
        same = vals.numpy() == rv
        np.testing.assert_array_equal(idx.numpy()[same], ri[same])
        assert same.mean() > 0.99
        assert any(len(np.unique(r)) < LT.LANES for r in rv)   # ties
        return
    tol = 1e-5 * np.abs(rv).max()
    np.testing.assert_allclose(vals.numpy(), rv, rtol=0, atol=tol)
    for b in range(B):
        diff = set(idx[b].tolist()) ^ set(ri[b].tolist())
        assert all(abs(v - rv[b, -1]) <= 2 * tol for v in
                   vals[b].numpy()[np.isin(idx[b].numpy(), list(diff))])


# --------------------------------------------------------------------------
# a tiny all-bf16 MultiModalLLM, decoding in each quantised mode
# --------------------------------------------------------------------------

QF = dict(vision_dim=32, hidden_size=32, num_heads=2, num_encoder_layers=1,
          num_decoder_layers=1, num_query_tokens=4, dropout=0.0)
B, P, N = 2, 8, 6


@pytest.fixture(scope="module")
def stacks():
    """One Flax init, every floating leaf cast to bf16 (as the JAX
    package's ``build_mllm_bf16``), in both packages; seeded inputs."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    llama = jax_config.LlamaConfig.tiny()
    jmllm = JaxMLLM(llama=llama, qformer=jax_config.QFormerConfig(**QF),
                    dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    vision = rng.standard_normal((B, 18, 32)).astype(np.float32)
    ids = rng.integers(3, llama.vocab_size, (B, P)).astype(np.int32)
    mask = np.ones((B, P), np.int32)
    mask[1, 6:] = 0
    variables = jax.jit(lambda v, i, m: jmllm.init(
        {"params": jax.random.key(0)}, v, i, m, True))(
            vision[:1], ids[:1], mask[:1])
    variables = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
        variables)
    params = jax.device_get(variables["params"])
    port = MultiModalLLM(
        port_config.LlamaConfig(**{f: getattr(llama, f) for f in
                                   llama.__dataclass_fields__}),
        port_config.QFormerConfig(**QF), dtype=BF)
    port = cast_params(load_flax_params(port, traverse_util.unflatten_dict(
        {k: np.asarray(v, np.float32) for k, v in
         traverse_util.flatten_dict(params).items()})), BF).eval()
    inputs = tuple(map(torch.from_numpy, (vision, ids, mask)))
    yield jmllm, variables, port, inputs
    torch.set_num_threads(prev)


MODES = {"int8_w": (True, False), "int8_kv": (False, True),
         "both": (True, True)}


_ROLLOUTS = {}


def _jax_rollout(jmllm, vs, vision, ids, mask, toks, quantize_kv):
    """The JAX script's teacher-forced rollout: (N + 1, B, V) fp32; one
    compiled program per (int8 tables, int8 cache)."""
    cache_len = jmllm.qformer.num_query_tokens + ids.shape[1] + \
        toks.shape[1]
    key = ("quant" in vs, quantize_kv, cache_len)
    if key not in _ROLLOUTS:
        @jax.jit
        def f(vs, vision, ids, mask, toks):
            caches, last_hidden, prefix_len, fmask = jmllm.apply(
                vs, vision, ids, mask, cache_len, method=jmllm.prefill)
            if quantize_kv:
                caches = jkv.quantize_cache(caches)
            l0 = jmllm.apply(vs, last_hidden, method=lambda m, h:
                             m.llama_mod.logits_from_hidden(h, quant_ok=True))

            def body(caches, xs):
                tok, step = xs
                lg, caches = jmllm.apply(vs, tok, step, prefix_len, caches,
                                         fmask, cache_len,
                                         method=jmllm.decode_step)
                return caches, lg

            _, ls = jax.lax.scan(body, caches, (jnp.swapaxes(toks, 0, 1),
                                                jnp.arange(toks.shape[1])))
            return jnp.concatenate([l0[None], ls], axis=0)

        _ROLLOUTS[key] = f
    return np.asarray(_ROLLOUTS[key](vs, jnp.asarray(vision), jnp.asarray(
        ids), jnp.asarray(mask), jnp.asarray(toks)), np.float32)


def _tokens():
    return np.random.default_rng(7).integers(3, 384, (B, N)).astype(
        np.int32)


def test_decode_step_stays_bf16(stacks):
    """One decode step with int8 weights and the int8 cache: every
    projection takes bf16 x and gives bf16 (no fp32 from the first int8
    product on), the logits are fp32 and close to the JAX package's."""
    jmllm, variables, port, (vision, ids, mask) = stacks
    toks = _tokens()
    tables = tq.quantize_llama_params(port)
    assert all(t.dtype in (torch.int8, torch.float32)
               for t in tables.values())
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append((args[0].dtype, out.dtype)))
        for name, m in port.named_modules()
        if (".attn." in name or ".mlp." in name) and name.endswith("_proj")]
    try:
        QQ.set_quant(port, tables, tables)
        with torch.inference_mode():
            cache_len = 4 + P + N
            caches, last, plen, fmask = port.prefill(vision, ids, mask,
                                                     cache_len)
            caches = tkv.quantize_cache(caches)
            assert last.dtype == BF and caches[0][0].dtype == torch.int8
            seen.clear()
            tok = torch.from_numpy(toks[:, 0]).long()
            logits = port.decode_step(tok, 0, plen, caches, fmask,
                                      cache_len)
    finally:
        QQ.set_quant(port, None, tables)
        for hk in hooks:
            hk.remove()
    assert seen and set(seen) == {(BF, BF)}, set(seen)
    assert logits.dtype == torch.float32 and logits.shape == (B, 384)
    ref = _jax_rollout(jmllm, {**variables, "quant": jq.quantize_llama_params(
        variables["params"])}, vision.numpy(), ids.numpy(), mask.numpy(),
        toks, True)[1]
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0,
                               atol=2 ** -5 * np.abs(ref).max())


@pytest.mark.parametrize("mode", list(MODES))
def test_teacher_forced_logits_match_jax(stacks, mode):
    """``quality_quant``'s rollout (the port's ``rollout_logits``) against
    the JAX script's, over N + 1 steps of the same tokens, in each mode
    (the JAX package's int8-KV route at these widths is its default,
    "xla": its kernel needs lane-tiled heads)."""
    jmllm, variables, port, (vision, ids, mask) = stacks
    w8, kv8 = MODES[mode]
    toks = _tokens()
    vs = (dict(variables, quant=jq.quantize_llama_params(variables["params"]))
          if w8 else variables)
    ref = _jax_rollout(jmllm, vs, vision.numpy(), ids.numpy(), mask.numpy(),
                       toks, kv8)
    tables = tq.quantize_llama_params(port)
    QQ.set_quant(port, tables if w8 else None, tables)
    try:
        out = QQ.rollout_logits(port, vision, ids, mask,
                                torch.from_numpy(toks), kv8)
    finally:
        QQ.set_quant(port, None, tables)
    assert out.shape == ref.shape == (N + 1, B, 384)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=2 ** -5 * np.abs(ref).max())


def test_quality_quant_keys_at_tiny_dims():
    """``quality_quant --device cpu --tiny`` returns the JAX script's keys,
    each with its fields, every drift finite."""
    res = QQ.main(["--device", "cpu", "--tiny", "--bs", "2",
                   "--prompt-len", "8", "--max-new", "4"])
    arms = ("int8_w", "int8_kv", "both")
    want = {f"{c}_{a}" for c in ("greedy", "sampled") for a in arms} | \
        {f"drift_{a}" for a in arms}
    assert set(res) == want
    for a in arms:
        assert set(res[f"greedy_{a}"]) == {"seq_agree", "tok_agree",
                                           "mean_prefix"}
        d = res[f"drift_{a}"]
        assert set(d) == {"max_abs_dlogit", "mean_abs_dlogit",
                          "last_step_max", "top1_agree", "logit_std"}
        assert all(np.isfinite(v) for v in d.values())
    assert set(QQ.last_steps) == {f"{c}_{a}" for c in ("greedy", "sampled")
                                  for a in ("bf16",) + arms}
    assert set(QQ.last_ids) == {"bf16", *arms}
    assert all(v.shape == (2, 4) for v in QQ.last_ids.values())


def test_head_arrays_of_a_bf16_model(stacks):
    """The fused head's weights of a bf16 model: the tied bf16 embedding,
    or the int8 tables once attached."""
    _, _, port, _ = stacks
    w, quant = head_arrays(port)
    assert quant is None and w.dtype == BF
    tables = tq.quantize_llama_params(port)
    QQ.set_quant(port, tables, tables)
    try:
        w, quant = head_arrays(port)
        assert w is None and quant[0].dtype == torch.int8
    finally:
        QQ.set_quant(port, None, tables)


# --------------------------------------------------------------------------
# the plain int8 scope
# --------------------------------------------------------------------------

def test_plain_int8_scope():
    """``plain_int8()`` holds for its block only, nested or left by an
    exception, and not in another context (a server thread's); a CPU
    tensor takes the plain version inside it and outside."""
    import contextvars
    rng = np.random.default_rng(13)
    x, _ = _bf16(rng.standard_normal((4, 64)))
    w8, s = tq.quantize_weight(torch.from_numpy(
        rng.standard_normal((64, 32)).astype(np.float32)))
    ref = tq.int8_matmul_ref(x, w8, s)
    assert not tq._PLAIN.get()
    ctx = contextvars.copy_context()
    with tq.plain_int8():
        assert tq._PLAIN.get() and not ctx.run(tq._PLAIN.get)
        with tq.plain_int8():
            assert tq._PLAIN.get()
        assert tq._PLAIN.get()
        assert torch.equal(tq.int8_matmul(x, w8, s), ref)
    assert not tq._PLAIN.get()
    with pytest.raises(RuntimeError):
        with tq.plain_int8():
            raise RuntimeError
    assert not tq._PLAIN.get()
    assert torch.equal(tq.int8_matmul(x, w8, s), ref)


# --------------------------------------------------------------------------
# a served bf16 checkpoint with the three decode switches
# --------------------------------------------------------------------------

def test_bf16_checkpoint_decodes_with_every_switch(tmp_path):
    """A bf16 ``run_stage2`` artifact served by ``Predictor.from_checkpoint``
    with int8 weights, the int8 KV cache and the fused head, and with the
    switches off: fp32 parameters, as the JAX package restores into its
    fp32 init (int8 tables from them), and greedy ids equal to those of a
    ``Predictor`` over the same merged state in fp32 with the same
    switches."""
    from test_torch_bf16 import _flow_bf16, _merged_fp32
    from test_torch_checkpoint import RUN
    from tsue_tpu_torch.data import make_synthetic_tracks
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    from tsue_tpu_torch.runner import run_stage2
    from tsue_tpu_torch.serve import Predictor
    cfg = _flow_bf16()
    run_stage2(cfg, out_dir=str(tmp_path), epochs=1, **RUN)
    best = str(tmp_path / cfg.name / "ckpt" / "best")
    direct_cfg, state = _merged_fp32(cfg, best)
    tracks = make_synthetic_tracks(num_tracks=2, track_len=300, seed=3)
    greedy = SamplingConfig(do_sample=False)
    texts = {}
    for on in (True, False):
        kw = dict(device="cpu", batch_size=2, quantize_decode=on,
                  quantize_kv=on, fused_head=on)
        pred = Predictor.from_checkpoint(cfg, best, **kw)
        assert {p.dtype for p in pred.model.parameters()} == {torch.float32}
        out = pred.generate_context(tracks, max_new_tokens=4,
                                    sampling=greedy)
        assert len(out) == 2 and all(isinstance(r["context"], str)
                                     for r in out), out
        texts[on] = pred.last_request["ids"]
        assert texts[on].shape == (2, 4)
        direct = Predictor(direct_cfg, state, **kw)
        direct.generate_context(tracks, max_new_tokens=4, sampling=greedy)
        np.testing.assert_array_equal(texts[on],
                                      direct.last_request["ids"])
    if pred._quant is not None:
        assert all(t.dtype in (torch.int8, torch.float32)
                   for t in pred._quant.values())
