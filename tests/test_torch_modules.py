"""Each model module of the port against its Flax counterpart.

Flax initialises the weights, ``convert.load_flax_params`` carries them into
the port, and the same numpy inputs go through both.  Each side takes its own
package's config classes, built from the same fields.  Tolerance 1e-4
(relative, and absolute on O(1) hidden states): both sides are fp32, but
matmul and LayerNorm statistics sum in different orders through several
layers (flax's LayerNorm takes the variance as E[x^2] - E[x]^2, torch's in
two passes), so errors of a few 1e-6 grow layer by layer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tsue_tpu.config import LlamaConfig, QFormerConfig
from tsue_tpu.models.lane_encoder import LanePolygonEncoder as JaxLane
from tsue_tpu.models.llama import LlamaModel as JaxLlama
from tsue_tpu.models.ltsf import TransformerLTSF as JaxLTSF
from tsue_tpu.models.qformer import QFormer as JaxQFormer
from tsue_tpu.ops.attention import attention_impl
from tsue_tpu_torch import config as port_config
from tsue_tpu_torch.convert import load_flax_params
from tsue_tpu_torch.models.lane_encoder import LanePolygonEncoder
from tsue_tpu_torch.models.llama import LlamaModel
from tsue_tpu_torch.models.ltsf import TransformerLTSF
from tsue_tpu_torch.models.qformer import QFormer

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _init(module, *args):
    variables = jax.jit(module.init)({"params": jax.random.key(0),
                                      "dropout": jax.random.key(1)}, *args)
    return jax.device_get(variables["params"])


def _apply(module, params, *args):
    return jax.jit(module.apply)({"params": params}, *args)


def _port(module, params):
    return load_flax_params(module, params).eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _port_cfg(cfg):
    """The port's config object with the fields of a JAX-package one."""
    return getattr(port_config, type(cfg).__name__)(**dataclasses.asdict(cfg))


def test_lane_encoder_with_empty_polygons():
    rng = np.random.default_rng(0)
    poly = (rng.random((3, 64, 2)) * 1000).astype(np.float32)
    plen = np.array([64, 0, 9], np.int32)
    flax_mod = JaxLane(d_model=16, num_heads=2, num_layers=2)
    params = _init(flax_mod, jnp.asarray(poly), jnp.asarray(plen))
    ref = _apply(flax_mod, params, jnp.asarray(poly), jnp.asarray(plen))
    port = _port(LanePolygonEncoder(d_model=16, num_heads=2, num_layers=2),
                 params)
    with torch.no_grad():
        out = port(_t(poly), _t(plen))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert np.all(out[1].numpy() == 0.0)


def test_qformer():
    cfg = QFormerConfig(vision_dim=24, hidden_size=32, num_heads=2,
                        num_encoder_layers=2, num_decoder_layers=2,
                        num_query_tokens=4)
    vis = np.random.default_rng(1).standard_normal((2, 6, 24),
                                                   dtype=np.float32)
    flax_mod = JaxQFormer(cfg)
    params = _init(flax_mod, jnp.asarray(vis))
    ref = _apply(flax_mod, params, jnp.asarray(vis))
    with torch.no_grad():
        out = _port(QFormer(_port_cfg(cfg)), params)(_t(vis))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


LLAMA = LlamaConfig(vocab_size=64, hidden_size=128, intermediate_size=256,
                    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_model_through_rope_kernel(dtype):
    """G*D = 2*64 = 128: JAX runs ``_gqa_rope_kernel`` in interpret mode.
    bfloat16 rounds the weights only, the activations stay fp32 (the
    promotion in ``LoRADense``)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 128), dtype=np.float32)
    mask = (np.arange(12)[None] < np.array([[12], [7]])).astype(np.int32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    flax_mod = JaxLlama(LLAMA, jdt)
    params = _init(flax_mod, jnp.asarray(x), jnp.asarray(mask))
    # flax inits lora_b = 0; give the adapters mass so they are exercised
    flat = traverse_util.flatten_dict(params)
    for key in flat:
        if key[-1] == "lora_b":
            flat[key] = rng.normal(0, 0.05, flat[key].shape).astype(np.float32)
    params = traverse_util.unflatten_dict(flat)
    # the stack takes embeddings, so flax never creates the embedding table
    params["embed_tokens"] = {"embedding": rng.standard_normal(
        (LLAMA.vocab_size, LLAMA.hidden_size), dtype=np.float32)}
    with attention_impl("pallas"):
        ref, _ = _apply(flax_mod, params, jnp.asarray(x), jnp.asarray(mask))
    assert ref.dtype == jnp.float32
    with torch.no_grad():
        out = _port(LlamaModel(_port_cfg(LLAMA), tdt), params)(_t(x),
                                                               _t(mask))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_ltsf_with_and_without_precomputed_cross_kv():
    rng = np.random.default_rng(3)
    x = rng.random((2, 2, 6), dtype=np.float32)
    poly = rng.standard_normal((2, 16), dtype=np.float32)
    hidden = rng.standard_normal((2, 10, 64), dtype=np.float32)
    hmask = (np.arange(10)[None] < np.array([[10], [4]])).astype(np.int32)
    flax_mod = JaxLTSF(seq_len=6, out_len=6, d_model=16, polygon_embed_dim=16,
                       nhead=2, cross_dim=64, cross_nhead=2)
    args = tuple(map(jnp.asarray, (x, poly, hidden, hmask)))
    params = _init(flax_mod, *args)
    ref = _apply(flax_mod, params, *args)
    port = _port(TransformerLTSF(seq_len=6, out_len=6, d_model=16,
                                 polygon_embed_dim=16, nhead=2, cross_dim=64,
                                 cross_nhead=2), params)
    with torch.no_grad():
        out = port(_t(x), _t(poly), _t(hidden), _t(hmask))
        kv = port.project_cross_kv(_t(hidden))
        out_kv = port(_t(x), _t(poly), None, _t(hmask), cross_kv=kv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out_kv.numpy(), np.asarray(ref), **TOL)
