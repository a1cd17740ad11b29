"""Port attention against the JAX package's Pallas kernel (interpret mode).

The same numpy inputs go through ``tsue_tpu.ops.flash.flash_attention(...,
interpret=True)`` and the port's ``flash_attention`` (its plain PyTorch
version on the CPU), one case for each Pallas body.  Tolerance
atol = rtol = 1e-5: both sides compute in fp32, the port with one matmul
per head and the kernel block by block, so they differ only in the order
of summation.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsue_tpu.ops.flash import flash_attention as jax_flash_attention
from tsue_tpu_torch.ops.attention import dot_product_attention
from tsue_tpu_torch.ops.flash import flash_attention

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _case(B, Tq, Tk, Hq, Hkv, D, valid_len, rope=False, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, Tk, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, Tk, Hkv, D), dtype=np.float32)
    mask = (np.arange(Tk)[None, :] < np.asarray(valid_len)[:, None])
    mask = mask.astype(np.int32)
    cs = None
    if rope:
        pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.float32)
        inv = 1.0 / (10000.0 ** (np.arange(0, D, 2) / D)).astype(np.float32)
        ang = pos[..., None] * inv
        cs = (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
    return q, k, v, mask, cs


# (name, B, Tq, Tk, Hq, Hkv, D, valid key counts, causal, rope)
CASES = [
    # _gqa_rope_kernel: G*D = 2*64 = 128, right-padded keys, causal
    ("gqa_rope", 2, 24, 24, 4, 2, 64, [24, 17], True, True),
    # _gqa_kernel: G*D = 1*128, cross-attention shape Tq != Tk, key mask
    ("gqa", 2, 8, 20, 2, 2, 128, [20, 13], False, False),
    # _folded_kernel (G*D < 128): lane width D=16 with an empty polygon row
    ("folded_d16", 2, 12, 12, 4, 4, 16, [7, 0], False, False),
    # _folded_kernel: Q-Former width D=96, GQA, a fully masked row
    ("folded_d96", 2, 10, 14, 4, 2, 96, [0, 9], False, False),
    # _gqa_kernel at the LTSF cross width D=1024, more keys than one tile
    ("gqa_d1024_cross", 2, 6, 70, 2, 2, 1024, [70, 41], False, False),
    # _gqa_kernel as one decode step: Tq=1, G=4, padded key mask
    ("decode_g4", 2, 1, 70, 8, 2, 64, [70, 23], False, False),
    # _gqa_kernel, causal with Tk > Tq (the tril offset), one row of the
    # batch with no valid key
    ("causal_offset_empty", 2, 6, 20, 4, 2, 64, [0, 13], True, False),
]


@pytest.mark.parametrize("name,B,Tq,Tk,Hq,Hkv,D,valid,causal,rope", CASES,
                         ids=[c[0] for c in CASES])
def test_matches_pallas_kernel(name, B, Tq, Tk, Hq, Hkv, D, valid, causal,
                               rope):
    q, k, v, mask, cs = _case(B, Tq, Tk, Hq, Hkv, D, valid, rope)
    ref = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        is_causal=causal,
        rope=None if cs is None else tuple(map(jnp.asarray, cs)),
        interpret=True)
    out = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), is_causal=causal,
        rope=None if cs is None else tuple(map(torch.from_numpy, cs)))
    assert out.shape == (B, Tq, Hq, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    empty = np.flatnonzero(np.asarray(valid) == 0)
    for b in empty:
        # no valid key: the uniform average over all Tk keys, not NaN
        mean_v = np.repeat(v[b].mean(axis=0), Hq // Hkv, axis=0)
        np.testing.assert_allclose(out[b].numpy(),
                                   np.broadcast_to(mean_v, (Tq, Hq, D)),
                                   **TOL)


def _dropout_inputs():
    q, k, v, mask, _ = _case(2, 6, 9, 4, 2, 16, [9, 5], seed=3)
    return tuple(map(torch.from_numpy, (q, k, v, mask)))


def test_dropout_reproducible_from_generator():
    q, k, v, mask = _dropout_inputs()

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return dot_product_attention(q, k, v, mask, dropout_p=0.3,
                                     generator=g)

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    assert not torch.allclose(a, dot_product_attention(q, k, v, mask))


def test_dropout_zero_is_deterministic_attention():
    q, k, v, mask = _dropout_inputs()
    g = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(
        dot_product_attention(q, k, v, mask, dropout_p=0.0,
                              generator=g).numpy(),
        dot_product_attention(q, k, v, mask).numpy())
