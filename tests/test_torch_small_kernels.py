"""NLinear, the fused LoRA product and the per-sample ADE/FDE in the port
against the JAX package: the port's CPU path (the kernels' plain versions
inside the same autograd Functions) against the JAX functions with their
Pallas kernels in interpret mode, at the JAX tests' shapes and cases
(``tests/test_fused_kernels.py``, ``tests/test_scan_epoch_lora.py``), on
the same numpy inputs.

Tolerances: forward atol = rtol = 1e-5 (fp32 on both sides, sums in
another order); gradients atol = rtol = 1e-4 against ``jax.grad`` through
the JAX ``custom_vjp``s (both recompute through the reference
formulation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsue_tpu.eval.metrics import ade_fde as jax_ade_fde
from tsue_tpu.ops.lora import lora_matmul as jax_lora
from tsue_tpu.ops.metric_kernels import fused_ade_fde as jax_fused_ade_fde
from tsue_tpu.ops.nlinear import nlinear_fused as jax_nlinear
from tsue_tpu_torch.eval.metrics import ade_fde
from tsue_tpu_torch.ops.lora import lora_matmul, lora_matmul_plan, lora_ref
from tsue_tpu_torch.ops.metric_kernels import ade_fde_plain, fused_ade_fde
from tsue_tpu_torch.ops.nlinear import nlinear_fused, nlinear_plan

FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
B, C, TI, TO = 4, 64, 18, 30


def _normal(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _port_grads(fn, arrays):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (fn(*leaves) ** 2).sum().backward()
    return [t.grad.numpy() for t in leaves]


def _jax_grads(fn, arrays):
    return jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                    argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])


def _nlinear_inputs(seed=0):
    x, = _normal(seed, (B, C, TI))
    w, b = _normal(seed + 1, (C, TI, TO), (C, TO), scale=0.1)
    return x, w, b


def test_nlinear_matches_jax():
    x, w, b = _nlinear_inputs()
    ref = jax_nlinear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), True)
    out = nlinear_fused(*map(torch.from_numpy, (x, w, b)))
    assert out.shape == (B, C, TO) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)


def test_nlinear_zero_weights_pass_the_last_step_through():
    x, _, _ = _nlinear_inputs(2)
    w, b = np.zeros((C, TI, TO), np.float32), np.zeros((C, TO), np.float32)
    ref = jax_nlinear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), True)
    out = nlinear_fused(*map(torch.from_numpy, (x, w, b))).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(out, np.broadcast_to(x[:, :, -1:],
                                                    (B, C, TO)), atol=1e-6)


def test_nlinear_gradients_match_jax():
    arrays = _nlinear_inputs(4)
    ours = _port_grads(nlinear_fused, arrays)
    ref = _jax_grads(lambda *a: jax_nlinear(*a, True), arrays)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, np.asarray(r), **GRAD)


def _lora_inputs(M, K, N, r, seed=0):
    x, = _normal(seed, (M, K))
    w, a, b = _normal(seed + 1, (K, N), (K, r), (r, N), scale=0.05)
    return x, w, a, b


@pytest.mark.parametrize("M,K,N,r", [(32, 64, 128, 8), (40, 32, 96, 4)])
def test_lora_matches_jax(M, K, N, r):
    arrays = _lora_inputs(M, K, N, r)
    ref = jax_lora(*map(jnp.asarray, arrays), 4.0, True)
    out = lora_matmul(*map(torch.from_numpy, arrays), 4.0)
    assert out.shape == (M, N) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)


def test_lora_bf16_rounds_xa_as_the_pallas_kernel():
    """bf16 inputs: the plain path rounds xA to bf16 before the second
    product, as the Pallas kernel does (``lora.py:36``), and returns bf16;
    against the interpreted kernel within one bf16 ulp (2^-8 relative to
    the largest output: fp32 sums in another order may round the other
    way)."""
    arrays = _lora_inputs(32, 64, 128, 8, seed=6)
    ref = jax_lora(*[jnp.asarray(a, jnp.bfloat16) for a in arrays], 4.0, True)
    out = lora_matmul(*[torch.from_numpy(a).bfloat16() for a in arrays], 4.0)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    big = np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -8,
                               atol=2 ** -8 * big)
    # the rounding of xA is the kernel's, not lora_ref's default
    xs = [torch.from_numpy(a).bfloat16() for a in arrays]
    assert torch.equal(out, lora_ref(*xs, 4.0, round_xa=True))


def test_lora_gradients_match_jax():
    arrays = _lora_inputs(16, 32, 48, 4, seed=3)
    arrays = [arrays[0], *(a * 2.0 for a in arrays[1:])]
    ours = _port_grads(lambda *t: lora_matmul(*t, 4.0), arrays)
    ref = _jax_grads(lambda *a: jax_lora(*a, 4.0, True), arrays)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, np.asarray(r), **GRAD)


def _ade_inputs(seed=5, T=TO):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(size=(B, 2, T)).astype(np.float32)
    gt = rng.uniform(size=(B, 2, T)).astype(np.float32)
    stat = np.tile(np.array([100., 900., 50., 350.], np.float32), (B, 1))
    return pred, gt, stat


def test_ade_fde_matches_jax():
    """Per sample against the interpreted Pallas kernel (the same
    arithmetic: difference before denormalisation), and the means against
    ``eval.metrics.ade_fde`` of both packages (which denormalise first:
    rtol 1e-5, as the JAX test holds its kernel)."""
    pred, gt, stat = _ade_inputs()
    ref = np.asarray(jax_fused_ade_fde(*map(jnp.asarray, (pred, gt, stat)),
                                       interpret=True))
    out = fused_ade_fde(*map(torch.from_numpy, (pred, gt, stat)))
    assert out.shape == (B, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **FWD)
    jade, jfde = jax_ade_fde(*map(jnp.asarray, (pred, gt, stat)))
    pade, pfde = ade_fde(*map(torch.from_numpy, (pred, gt, stat)))
    for mean, j, p in ((out[:, 0].mean(), jade, pade),
                       (out[:, 1].mean(), jfde, pfde)):
        np.testing.assert_allclose(float(mean), float(j), rtol=1e-5)
        np.testing.assert_allclose(float(mean), float(p), rtol=1e-5)


def test_ade_fde_reads_the_stat_as_xmin_xmax_ymin_ymax():
    """A y-only error scales with ymax - ymin; a unit x error with xmax -
    xmin, and the FDE is the last step's distance."""
    pred = np.zeros((1, 2, 3), np.float32)
    gt = np.zeros((1, 2, 3), np.float32)
    gt[0, 1, :] = 0.5
    gt[0, 0, 2] = 1.0
    stat = np.array([[10., 20., 0., 300.]], np.float32)
    out = ade_fde_plain(*map(torch.from_numpy, (pred, gt, stat)))[0]
    last = np.hypot(10.0, 150.0)
    np.testing.assert_allclose(out.numpy(), [(150 + 150 + last) / 3, last],
                               rtol=1e-6)
    ref = np.asarray(jax_fused_ade_fde(*map(jnp.asarray, (pred, gt, stat)),
                                       interpret=True))[0]
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


def test_lora_plan_picks_the_form_by_shape(monkeypatch):
    """The kernel's form follows TMA's terms: rows of x and W a multiple of
    16 bytes and aligned bases take the dtype's tensor-core form, any other
    shape the SIMT form, and so does a rank past 16, which only the SIMT
    form takes; an unknown dtype or a rank below 1 raises.  (With no CUDA
    device, as set here, a tensor-core plan counts one CTA a tile.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = lora_matmul_plan(8448, 2048, 2048, 8, torch.bfloat16)
    assert plan == dict(form="wgmma_bf16", tile_m=128, tile_n=256, k_step=64,
                        stages=4, threads=384, tiles=528, ctas=528)
    plan = lora_matmul_plan(8448, 2048, 512, 8, torch.float32)
    assert (plan["form"], plan["k_step"], plan["stages"], plan["tiles"]) == (
        "tf32x3", 32, 2, 132)
    assert lora_matmul_plan(1, 37, 517, 8, torch.float32) == dict(
        form="simt", tile_m=128, tile_n=128, k_step=8, stages=2, threads=256,
        tiles=5, ctas=5)
    # 16-byte rows: 4 fp32 or 8 bf16 values
    assert lora_matmul_plan(64, 36, 260, 4, torch.float32)["form"] == "tf32x3"
    assert lora_matmul_plan(64, 36, 264, 4, torch.bfloat16)["form"] == "simt"
    assert lora_matmul_plan(64, 64, 260, 4, torch.bfloat16)["form"] == "simt"
    assert lora_matmul_plan(64, 64, 256, 4, torch.bfloat16,
                            aligned=False)["form"] == "simt"
    with pytest.raises(TypeError):
        lora_matmul_plan(64, 64, 256, 4, torch.float16)
    for r in (17, 24, 64):
        for dtype in (torch.float32, torch.bfloat16):
            assert lora_matmul_plan(8448, 2048, 2048, r, dtype) == dict(
                form="simt", tile_m=128, tile_n=128, k_step=8, stages=2,
                threads=256, tiles=1056, ctas=1056)
    assert lora_matmul_plan(64, 64, 256, 16, torch.float32)["form"] == "tf32x3"
    with pytest.raises(ValueError, match="r > 0"):
        lora_matmul_plan(64, 64, 256, 0, torch.float32)
    with pytest.raises(ValueError):
        lora_matmul_plan(0, 64, 256, 4, torch.float32)


def test_nlinear_plan_picks_the_form_by_shape():
    """The bulk form where every copy is a 16-byte aligned multiple of 16
    bytes (C % cg == 0, cg * Ti and cg * To multiples of 4, aligned
    bases), the 4-byte form elsewhere (odd C, Ti = 1 with C = 5, an offset
    input); a (C / cg, B / bb) grid of 128 CTAs at B = 16 and 1280 at B =
    160; rows a CTA cut where shared memory asks it; shapes the kernel
    cannot take raise."""
    assert nlinear_plan(16, 64, 18, 18) == dict(
        form="bulk", cg=2, bb=4, threads=160, ctas=128, smem_bytes=3328)
    assert nlinear_plan(160, 64, 18, 18) == dict(
        form="bulk", cg=2, bb=4, threads=160, ctas=1280, smem_bytes=3328)
    assert nlinear_plan(16, 64, 18, 30) == dict(
        form="bulk", cg=2, bb=4, threads=256, ctas=128, smem_bytes=5152)
    assert nlinear_plan(16, 64, 18, 18, aligned=False) == dict(
        form="cp4", cg=2, bb=4, threads=160, ctas=128, smem_bytes=3328)
    assert nlinear_plan(3, 7, 30, 6) == dict(
        form="cp4", cg=2, bb=3, threads=64, ctas=4, smem_bytes=2224)
    assert nlinear_plan(2, 5, 1, 4)["form"] == "cp4"
    # Ti = 1 at C = 64: four channels make a 16-byte row of x
    assert (nlinear_plan(161, 64, 1, 64)["form"],
            nlinear_plan(161, 64, 1, 64)["cg"]) == ("bulk", 4)
    big = nlinear_plan(4, 3, 200, 240)
    assert (big["form"], big["cg"], big["bb"]) == ("bulk", 1, 4)
    assert big["smem_bytes"] <= 232448
    assert nlinear_plan(8, 2, 120, 400)["bb"] == 4
    assert nlinear_plan(8, 1, 2000, 26)["bb"] == 2
    with pytest.raises(ValueError, match="shared memory"):
        nlinear_plan(1, 1, 300, 300)
    with pytest.raises(ValueError):
        nlinear_plan(0, 64, 18, 18)
    with pytest.raises(ValueError):
        nlinear_plan(4 * 65535 + 1, 64, 18, 18)
