"""Int8 weight-only decode in the port against the JAX package: the plain
version of the int8 kernel against JAX ``int8_matmul`` (its Pallas kernel in
interpret mode), and the port's int8 tables, built from its own fp32
parameters, against JAX ``quantize_llama_params`` of the same tree.

Tolerances: the products agree to 1e-5 relative (fp32 on both sides, summed
in different orders); int8 values must be identical and scales agree to
1e-7 relative (the same fp32 max / 127 on both sides)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tsue_tpu import config as jax_config
from tsue_tpu.models.fusion import MultiModalLLM as JaxMLLM
from tsue_tpu.ops import quant as jq
from tsue_tpu_torch import config as port_config
from tsue_tpu_torch.convert import load_flax_params
from tsue_tpu_torch.models.fusion import MultiModalLLM
from tsue_tpu_torch.ops import quant as tq


def _w(rng, shape, s=0.1):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def test_quantize_weight_equal():
    rng = np.random.default_rng(0)
    w = _w(rng, (96, 160), 0.3)
    w[:, 3] = 0.0                             # an all-zero channel
    w[5, 7] = w[:, 7].max() * 0.5 + 1e-3      # a value on a .5 boundary
    for axis in (0, 1):
        w8, s = tq.quantize_weight(torch.from_numpy(w), axis=axis)
        jw8, js = jq.quantize_weight(jnp.asarray(w), axis=axis)
        np.testing.assert_array_equal(w8.numpy(), np.asarray(jw8))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)


@pytest.mark.parametrize("shape", [(16, 256, 384), (1, 128, 256),
                                   (5, 384, 128)])
def test_int8_matmul_plain_matches_jax(shape):
    M, K, N = shape
    rng = np.random.default_rng(M)
    x = _w(rng, (M, K), 1.0)
    w8, s = jq.quantize_weight(jnp.asarray(_w(rng, (K, N))), axis=0)
    ref = np.asarray(jq.int8_matmul(jnp.asarray(x), w8, s, interpret=True))
    out = tq.int8_matmul(torch.from_numpy(x),
                         torch.from_numpy(np.array(w8)),
                         torch.from_numpy(np.array(s)))
    assert out.dtype == torch.float32 and out.shape == (M, N)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_int8_matmul_keeps_leading_dims():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_w(rng, (4, 1, 64), 1.0))
    w8, s = tq.quantize_weight(torch.from_numpy(_w(rng, (64, 32))))
    out = tq.int8_matmul(x, w8, s)
    assert out.shape == (4, 1, 32)
    torch.testing.assert_close(out[:, 0], tq.int8_matmul_ref(x[:, 0], w8, s))


@pytest.fixture(scope="module")
def stacks():
    fields = dict(vision_dim=32, hidden_size=32, num_heads=2,
                  num_encoder_layers=1, num_decoder_layers=1,
                  num_query_tokens=4, dropout=0.0)
    llama = jax_config.LlamaConfig.tiny()
    jmllm = JaxMLLM(llama=llama, qformer=jax_config.QFormerConfig(**fields))
    vision = jnp.zeros((2, 8, 32))
    ids = jnp.ones((2, 6), jnp.int32)
    params = jax.device_get(jax.jit(lambda v, i, m: jmllm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        v, i, m, True))(vision, ids, jnp.ones((2, 6), jnp.int32))["params"])
    # flax inits lora_b = 0; give the adapters mass
    flat = traverse_util.flatten_dict(params)
    rng = np.random.default_rng(2)
    for key in flat:
        if key[-1] == "lora_b":
            flat[key] = _w(rng, flat[key].shape, 0.05)
    params = traverse_util.unflatten_dict(flat)
    port = MultiModalLLM(
        port_config.LlamaConfig(**dataclasses.asdict(llama)),
        port_config.QFormerConfig(**fields))
    return params, load_flax_params(port, params).eval()


def test_int8_tables_equal_jax(stacks):
    params, port = stacks
    ref = {".".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.device_get(jq.quantize_llama_params(params))).items()}
    ours = tq.quantize_llama_params(port)
    assert sorted(ours) == sorted(ref)
    assert "llama.lm_head_w8" in ours and \
        "llama.model.layer_1.mlp.down_proj.w8" in ours
    for key, val in ref.items():
        t = ours[key].numpy()
        assert t.shape == val.shape and t.dtype == val.dtype, key
        if val.dtype == np.int8:
            np.testing.assert_array_equal(t, val, err_msg=key)
        else:
            np.testing.assert_allclose(t, val, rtol=1e-7, err_msg=key)


def test_attached_tables_drive_decode_projections_only(stacks):
    """``attach_quant`` leaves the state dict alone; a projection uses the
    int8 table on a decode call (``quant_ok=True``) and its fp32 kernel
    otherwise, and the LoRA delta is added after either."""
    import copy
    _, port = stacks
    port = copy.deepcopy(port)
    keys = set(port.state_dict())
    tables = tq.quantize_llama_params(port)
    tq.attach_quant(port, tables)
    assert set(port.state_dict()) == keys
    proj = port.llama.model.layer_0.attn.q_proj
    x = torch.from_numpy(_w(np.random.default_rng(3), (3, 64), 1.0))
    with torch.no_grad():
        delta = (proj.lora_alpha / proj.lora_r) * (
            (x @ proj.lora_a) @ proj.lora_b)
        torch.testing.assert_close(
            proj(x, quant_ok=True),
            tq.int8_matmul_ref(x, proj.w8, proj.scale) + delta)
        torch.testing.assert_close(proj(x), x @ proj.kernel + delta)
        h = x[:, :port.llama.cfg.hidden_size]
        torch.testing.assert_close(
            port.llama.logits_from_hidden(h, quant_ok=True),
            tq.int8_matmul_ref(h, tables["llama.lm_head_w8"],
                               tables["llama.lm_head_scale"]))
