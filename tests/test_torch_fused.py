"""The fused kernels' functions and the gradients of the port's three
``autograd.Function``s against the JAX package's kernels in interpret mode.

``fused_rmsnorm`` and ``swiglu_matmul`` (on the CPU: the Function around
the plain version) at the JAX tests' shapes, forward and gradients; the
fallback shapes and the switch; the flash Function's gradient against the
JAX ``flash_attention`` gradient (its ``custom_vjp`` backward).  The same
numpy inputs go to both sides.  Tolerances: forward 1e-5 (1e-4 for the
4096-deep K loop, whose sums run over 16x more terms); gradients 1e-4 (the
backward recomputes, then sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsue_tpu.ops import fused as jax_fused
from tsue_tpu.ops.flash import flash_attention as jax_flash_attention
from tsue_tpu_torch.models.llama import LoRADense, RMSNorm
from tsue_tpu_torch.ops import fused
from tsue_tpu_torch.ops.flash import flash_attention, flash_attention_plain

FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _torch_grads(fn, arrays, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_grads(fn, arrays, cot):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def test_rmsnorm_forward_and_grad_match_jax():
    rng = np.random.default_rng(3)
    x = _randn(rng, 2, 96, 256)
    s = 1.0 + 0.1 * _randn(rng, 256)
    cot = _randn(rng, 2, 96, 256)
    out, grads = _torch_grads(lambda a, b: fused.fused_rmsnorm(a, b, 1e-5),
                              (x, s), cot)
    ref, ref_grads = _jax_grads(
        lambda a, b: jax_fused.fused_rmsnorm(a, b, 1e-5, interpret=True),
        (x, s), cot)
    np.testing.assert_allclose(out, ref, **FWD)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g, r, **GRAD)


def test_swiglu_forward_and_grad_match_jax():
    rng = np.random.default_rng(8)
    g, u = _randn(rng, 2, 80, 384), _randn(rng, 2, 80, 384)
    w = _randn(rng, 384, 128, scale=0.05)
    cot = _randn(rng, 2, 80, 128)
    out, grads = _torch_grads(fused.swiglu_matmul, (g, u, w), cot)
    ref, ref_grads = _jax_grads(
        lambda a, b, c: jax_fused.swiglu_matmul(a, b, c, interpret=True),
        (g, u, w), cot)
    np.testing.assert_allclose(out, ref, **FWD)
    for x, r in zip(grads, ref_grads):
        np.testing.assert_allclose(x, r, **GRAD)


def test_swiglu_k_loop_matches_jax():
    """K = 4096: the Pallas kernel accumulates two 2048-deep blocks."""
    rng = np.random.default_rng(9)
    g, u = _randn(rng, 256, 4096), _randn(rng, 256, 4096)
    w = _randn(rng, 4096, 256, scale=0.02)
    out = fused.swiglu_matmul(*map(torch.from_numpy, (g, u, w)))
    ref = jax_fused._swiglu_fwd_impl(jnp.asarray(g), jnp.asarray(u),
                                     jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_frozen_weight_gets_no_dw():
    """A weight that requires no gradient costs no dW in the backward; the
    inputs' gradients are those of the plain version."""
    rng = np.random.default_rng(1)
    g = torch.tensor(_randn(rng, 160, 128), requires_grad=True)
    u = torch.tensor(_randn(rng, 160, 128), requires_grad=True)
    w = torch.from_numpy(_randn(rng, 128, 128, scale=0.05))
    fused.swiglu_matmul(g, u, w).square().sum().backward()
    g2, u2 = (t.detach().clone().requires_grad_() for t in (g, u))
    fused.swiglu_matmul_plain(g2, u2, w).square().sum().backward()
    assert w.grad is None
    torch.testing.assert_close(g.grad, g2.grad, **GRAD)
    torch.testing.assert_close(u.grad, u2.grad, **GRAD)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts of the two fused Functions' applications."""
    calls = {"rmsnorm": 0, "swiglu": 0}
    for key, fn in (("rmsnorm", fused._RMSNorm), ("swiglu",
                                                  fused._SwiGLUMatmul)):
        def counted(*a, _key=key, _apply=fn.apply):
            calls[_key] += 1
            return _apply(*a)
        monkeypatch.setattr(fn, "apply", counted)
    return calls


@pytest.mark.parametrize("shape", [(16, 256), (40, 96), (2, 100, 96)])
def test_small_shapes_take_the_plain_version(shape, kernel_calls):
    """Fewer than 128 rows (decode steps) or K % 128: the plain version, as
    the JAX package's dispatch, and identical to it."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_randn(rng, *shape))
    s = torch.ones(shape[-1])
    out = fused.fused_rmsnorm(x, s, 1e-5)
    assert torch.equal(out, fused.rmsnorm_plain(x, s, 1e-5))
    w = torch.from_numpy(_randn(rng, shape[-1], 128))
    out = fused.swiglu_matmul(x, x, w)
    assert torch.equal(out, fused.swiglu_matmul_plain(x, x, w))
    assert kernel_calls == {"rmsnorm": 0, "swiglu": 0}
    np.testing.assert_allclose(
        np.asarray(jax_fused.fused_rmsnorm(jnp.asarray(x.numpy()),
                                           jnp.ones(shape[-1]), 1e-5)),
        fused.rmsnorm_plain(x, s, 1e-5).numpy(), **FWD)


def test_swiglu_n_not_a_multiple_of_128_is_plain(kernel_calls):
    rng = np.random.default_rng(2)
    g = torch.from_numpy(_randn(rng, 160, 128))
    out = fused.swiglu_matmul(g, g, torch.from_numpy(_randn(rng, 128, 96)))
    assert out.shape == (160, 96) and kernel_calls["swiglu"] == 0
    fused.swiglu_matmul(g, g, torch.zeros(128, 128))
    assert kernel_calls["swiglu"] == 1


def test_swiglu_plan_shape_rules(monkeypatch):
    """The kernel's one form takes every shape the kernel takes (M, N > 0,
    K % 128 == 0, N % 4 == 0: 16-byte rows for TMA) in 128 x 256 tiles;
    any other shape raises.  (With no CUDA device, as set here, the plan
    counts one CTA a tile.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = fused.swiglu_matmul_plan(8448, 8192, 2048)
    assert plan == dict(form="tf32x3", tile_m=128, tile_n=256, k_step=32,
                        stages=2, threads=384, tiles=528, ctas=528)
    assert fused.swiglu_matmul_plan(4224, 8192, 2048)["tiles"] == 264
    plan = fused.swiglu_matmul_plan(65, 128, 132)      # row and column tails
    assert (plan["form"], plan["tiles"], plan["ctas"]) == ("tf32x3", 1, 1)
    assert fused.swiglu_matmul_plan(129, 256, 260)["tiles"] == 4
    for M, K, N in ((128, 200, 256), (128, 0, 256), (128, 128, 130),
                    (0, 128, 256), (128, 128, 0)):
        with pytest.raises(ValueError, match="K % 128 == 0 and N % 4"):
            fused.swiglu_matmul_plan(M, K, N)


def test_swiglu_bf16_plan_shape_rules(monkeypatch):
    """The bf16 form, "bf16_wgmma", beside the fp32 one: the same 128 x 256
    tiles and persistent grid, 64-deep stages in a ring of three for g and
    u and one of four for W, 384 threads; it takes M, N > 0, K % 128 == 0 and N % 8 == 0 (16-byte rows of
    bf16 for TMA), row and column tails included; any other shape, and a
    dtype other than fp32 and bf16, raises.  (With no CUDA device, as set
    here, the plan counts one CTA a tile.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bf = torch.bfloat16
    plan = fused.swiglu_matmul_plan(8448, 8192, 2048, bf)
    assert plan == dict(form="bf16_wgmma", tile_m=128, tile_n=256,
                        k_step=64, stages=3, w_stages=4, threads=384,
                        tiles=528, ctas=528)
    assert fused.swiglu_matmul_plan(4224, 8192, 2048, bf)["tiles"] == 264
    plan = fused.swiglu_matmul_plan(129, 128, 136, bf)   # row, column tails
    assert (plan["form"], plan["tiles"], plan["ctas"]) == ("bf16_wgmma", 2, 2)
    assert fused.swiglu_matmul_plan(65, 8192, 520, bf)["tiles"] == 3
    for M, K, N in ((128, 200, 256), (128, 0, 256), (128, 128, 132),
                    (0, 128, 256), (128, 128, 0), (128, 64, 256)):
        with pytest.raises(ValueError, match="K % 128 == 0 and N % 8"):
            fused.swiglu_matmul_plan(M, K, N, bf)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused.swiglu_matmul_plan(128, 128, 256, torch.float16)


def test_switch_semantics(monkeypatch):
    """``auto`` is off; ``fused_scope`` nests and restores; the Llama
    modules consult the switch on every call."""
    calls = {"rms": 0, "swiglu": 0}
    import tsue_tpu_torch.models.llama as L

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(L, "fused_rmsnorm", count("rms", L.fused_rmsnorm))
    monkeypatch.setattr(L, "swiglu_matmul", count("swiglu", L.swiglu_matmul))
    with fused.fused_scope("auto"):
        assert not fused.fused_enabled()
        with fused.fused_scope("on"):
            assert fused.fused_enabled()
            with fused.fused_scope("off"):
                assert not fused.fused_enabled()
            assert fused.fused_enabled()
        assert not fused.fused_enabled()
    with pytest.raises(ValueError):
        fused.set_fused("yes")

    norm = RMSNorm(128)
    down = LoRADense(128, 128)
    lora = LoRADense(128, 128, lora_r=4)
    for p in (*down.parameters(), *lora.parameters()):
        torch.nn.init.normal_(p, std=0.05)
    x = torch.from_numpy(_randn(np.random.default_rng(4), 2, 80, 128))
    with fused.fused_scope("off"):
        ref_norm, ref_down = norm(x), down(x, swiglu_up=x)
    assert calls == {"rms": 0, "swiglu": 0}
    with fused.fused_scope("on"):
        torch.testing.assert_close(norm(x), ref_norm, **FWD)
        torch.testing.assert_close(down(x, swiglu_up=x), ref_down, **FWD)
        lora(x, swiglu_up=x)              # an adapter keeps the plain path
    assert calls == {"rms": 1, "swiglu": 1}


def _attention_case(B, T, Hq, Hkv, D, lens, rope, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (_randn(rng, B, T, h, D) for h in (Hq, Hkv, Hkv))
    mask = (np.arange(T)[None] < np.asarray(lens)[:, None]).astype(np.int32)
    cs = None
    if rope:
        pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.float32)
        inv = (1.0 / 10000.0 ** (np.arange(0, D, 2) / D)).astype(np.float32)
        ang = pos[..., None] * inv
        cs = (np.cos(ang), np.sin(ang))
    return q, k, v, mask, cs, _randn(rng, B, T, Hq, D)


@pytest.mark.parametrize("case", ["gqa_rope_causal_mask",
                                  "d16_fully_masked_rows"])
def test_flash_function_gradient_matches_jax(case):
    """The Function's dq, dk, dv against the JAX kernel's custom_vjp
    (interpret mode), rtol = atol = 1e-4; and against autograd through the
    plain version."""
    if case == "gqa_rope_causal_mask":
        args = _attention_case(2, 24, 4, 2, 32, [24, 13], True, 0)
        causal = True
    else:
        args = _attention_case(3, 10, 2, 2, 16, [10, 0, 4], False, 1)
        causal = False
    q, k, v, mask, cs, cot = args
    tmask = torch.from_numpy(mask)
    trope = None if cs is None else tuple(map(torch.from_numpy, cs))
    out, grads = _torch_grads(
        lambda a, b, c: flash_attention(a, b, c, tmask, causal, rope=trope),
        (q, k, v), cot)
    _, plain_grads = _torch_grads(
        lambda a, b, c: flash_attention_plain(a, b, c, tmask, causal,
                                              rope=trope), (q, k, v), cot)
    jrope = None if cs is None else tuple(map(jnp.asarray, cs))
    ref, ref_grads = _jax_grads(
        lambda a, b, c: jax_flash_attention(
            a, b, c, jnp.asarray(mask), causal, rope=jrope, interpret=True),
        (q, k, v), cot)
    np.testing.assert_allclose(out, ref, **FWD)
    for g, p, r in zip(grads, plain_grads, ref_grads):
        np.testing.assert_allclose(g, r, **GRAD)
        np.testing.assert_array_equal(g, p)
