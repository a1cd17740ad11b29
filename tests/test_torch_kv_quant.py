"""The int8 KV cache in the port against the JAX package: quantisation and
the scalar-slot cache write must be identical; the plain version of the
decode-attention kernel agrees with the JAX Pallas kernel (interpret mode,
``kv_attn_impl("kernel")``) and with its default XLA formulation to 1e-5
(fp32 on all sides, summed in different orders), at Tq = 1 with masked
slots and a row whose every slot is masked."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsue_tpu.ops import kv_quant as jk
from tsue_tpu_torch.ops import kv_quant as tk

TOL = dict(atol=1e-5, rtol=1e-5)


def _kv(rng, B, S, Hkv, D):
    k = (rng.standard_normal((B, S, Hkv, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, S, Hkv, D)) * 0.5).astype(np.float32)
    k[0, -1, 0] = 0.0                    # an all-zero vector: scale floor
    return k, v


def test_quantize_kv_and_cache_equal():
    k, v = _kv(np.random.default_rng(0), 2, 9, 3, 16)
    x8, s = tk.quantize_kv(torch.from_numpy(k))
    jx8, js = jk.quantize_kv(jnp.asarray(k))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(jx8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    ours = tk.quantize_cache([(torch.from_numpy(k), torch.from_numpy(v))])
    theirs = jk.quantize_cache([(jnp.asarray(k), jnp.asarray(v))])
    for a, b in zip(ours[0], theirs[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tk.dequantize_kv(x8, s).numpy(),
        np.asarray(jk.dequantize_kv(jx8, js, jnp.float32)))


@pytest.mark.parametrize("T", [1, 3])
def test_update_kv_int8_scalar_slot_equal(T):
    rng = np.random.default_rng(T)
    k, v = _kv(rng, 2, 12, 2, 16)
    nk, nv = _kv(rng, 2, T, 2, 16)
    slot = 5
    ours = tk.quantize_cache([(torch.from_numpy(k), torch.from_numpy(v))])[0]
    ours = tk.update_kv_int8(ours, torch.from_numpy(nk), torch.from_numpy(nv),
                             slot)
    theirs = jk.quantize_cache([(jnp.asarray(k), jnp.asarray(v))])[0]
    theirs = jk.update_kv_int8(theirs, jnp.asarray(nk), jnp.asarray(nv),
                               jnp.int32(slot))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("Hq,Hkv,D", [(16, 8, 64), (8, 2, 64)])
def test_attend_int8_kv_matches_jax(Hq, Hkv, D):
    B, S = 3, 40
    rng = np.random.default_rng(Hq)
    k, v = _kv(rng, B, S, Hkv, D)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    mask = rng.random((B, S)) > 0.3
    mask[:, 0] = True
    mask[2] = False                      # a row with every slot masked
    jcache = jk.quantize_cache([(jnp.asarray(k), jnp.asarray(v))])[0]
    with jk.kv_attn_impl("kernel"):
        kernel = np.asarray(jk.attend_int8_kv(jnp.asarray(q), jcache,
                                              jnp.asarray(mask),
                                              interpret=True))
    with jk.kv_attn_impl("xla"):
        xla = np.asarray(jk.attend_int8_kv(jnp.asarray(q), jcache,
                                           jnp.asarray(mask)))
    cache = tuple(torch.from_numpy(np.array(a)) for a in jcache)
    out = tk.attend_int8_kv(torch.from_numpy(q), cache,
                            torch.from_numpy(mask.astype(np.int32)))
    assert out.shape == (B, 1, Hq, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), kernel, **TOL)
    np.testing.assert_allclose(out[:2].numpy(), xla[:2], **TOL)
    # every slot masked: the uniform average of the values
    vd = tk.dequantize_kv(cache[2], cache[3])[2]          # (S, Hkv, D)
    G = Hq // Hkv
    np.testing.assert_allclose(
        out[2, 0].numpy(), vd.mean(0).repeat_interleave(G, 0).numpy(), **TOL)
