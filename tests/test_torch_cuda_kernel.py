"""The port's CUDA kernels against their plain PyTorch versions, on the
card: flash attention, the int8 matrix product, the fused LM head + top-128,
the int8-KV decode attention, the one-pass RMSNorm, the fused SwiGLU
down-projection, NLinear, the fused LoRA product and the per-sample
ADE/FDE, and the gradients of the kernels in autograd Functions (flash,
RMSNorm, SwiGLU, NLinear, LoRA) against autograd through their plain
versions.

These tests need a CUDA device and skip without one.  The machine with the
card has no JAX, which ``tests/conftest.py`` imports, so run them there
without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernel.py -q

Tolerance atol = rtol = 1e-4 against the plain version, both fp32: they sum
in different orders (the kernel key tile by key tile).  The head kernel is
held to identical indices and values on exact-arithmetic inputs (integer
hidden states and weights, power-of-two scales), where no summation order
changes a logit.
"""
import itertools

import pytest
import torch

from tsue_tpu_torch.ops import fused as FU
from tsue_tpu_torch.ops import kv_quant as KV
from tsue_tpu_torch.ops import lmhead_topk as LT
from tsue_tpu_torch.ops import quant as Q
from tsue_tpu_torch.ops.lora import lora_matmul, lora_ref
from tsue_tpu_torch.ops.metric_kernels import ade_fde_plain, fused_ade_fde
from tsue_tpu_torch.ops.nlinear import nlinear_fused, nlinear_ref
from tsue_tpu_torch.ops.flash import (SUPPORTED_HEAD_DIMS, flash_attention,
                                      flash_attention_plain)

pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _inputs(dev, g, B, Tq, Tk, Hq, Hkv, D, masked, rope):
    q = torch.randn(B, Tq, Hq, D, generator=g, device=dev)
    k = torch.randn(B, Tk, Hkv, D, generator=g, device=dev)
    v = torch.randn(B, Tk, Hkv, D, generator=g, device=dev)
    mask = None
    if masked != "none":
        lens = torch.randint(1, Tk + 1, (B,), generator=g, device=dev)
        if masked == "empty_rows":
            lens[1] = 0
        mask = (torch.arange(Tk, device=dev)[None] < lens[:, None]).int()
    cs = None
    if rope:
        ang = torch.rand(B, Tk, D // 2, generator=g, device=dev) * 50
        cs = (torch.cos(ang), torch.sin(ang))
    return q, k, v, mask, cs


@pytest.mark.parametrize("D", SUPPORTED_HEAD_DIMS)
def test_kernel_matches_plain_on_edge_shapes(dev, D):
    """GQA 1..8, Tq != Tk with the causal offset, padded and empty key
    rows, RoPE, tails shorter than a 32-key tile or an 8-item block."""
    g = torch.Generator(device=dev).manual_seed(D)
    heads = ((4, 4), (4, 2), (8, 1)) + (((32, 8),) if D <= 128 else ())
    lengths = ((1, 1), (5, 5), (33, 33), (7, 40), (40, 7), (70, 70))
    for (Hq, Hkv), (Tq, Tk), causal, masked, rope in itertools.product(
            heads, lengths, (False, True), ("none", "pad", "empty_rows"),
            (False, True)):
        if rope and (Tq != Tk or D > 128):
            continue
        q, k, v, mask, cs = _inputs(dev, g, 3, Tq, Tk, Hq, Hkv, D, masked,
                                    rope)
        before = flash_attention.launches
        out = flash_attention(q, k, v, mask, causal, None, cs)
        assert flash_attention.launches == before + 1
        ref = flash_attention_plain(q, k, v, mask, causal, None, cs)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, **TOL, msg=lambda m: (
            f"Hq={Hq} Hkv={Hkv} Tq={Tq} Tk={Tk} causal={causal} "
            f"mask={masked} rope={rope}: {m}"))


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q = torch.randn(2, 8, 4, 64, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.randn(2, 8, 4, 48, device=dev)
        flash_attention(x, x, x)
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2).contiguous().transpose(1, 2)
        flash_attention(t, t, t)
    with pytest.raises(ValueError, match="key mask"):
        flash_attention(q, q, q, torch.ones(2, 1, 8, 8, device=dev))
    with pytest.raises(ValueError, match="Hkv"):
        k = q[:, :, :3].contiguous()
        flash_attention(q, k, k)


@pytest.mark.parametrize("M", [1, 16, 128])
def test_int8_matmul_matches_plain(dev, M):
    """Every decode projection shape of Llama-3.2-1B plus ragged K and N;
    M up to the kernel's limit of 128 rows."""
    g = torch.Generator(device=dev).manual_seed(M)
    for K, N in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
                 (300, 132), (64, 4)):
        x = torch.randn(M, K, generator=g, device=dev)
        w8, s = Q.quantize_weight(torch.randn(K, N, generator=g, device=dev))
        before = Q.int8_matmul.launches
        out = Q.int8_matmul(x, w8, s)
        assert Q.int8_matmul.launches == before + 1
        ref = Q.int8_matmul_ref(x, w8, s)
        torch.cuda.synchronize()
        # K products of up to 127 x |x| each, summed in another order:
        # the error scales with the largest output, not with each one
        torch.testing.assert_close(
            out, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()),
            msg=lambda m: f"M={M} K={K} N={N}: {m}")


def test_int8_matmul_rejects_what_it_does_not_take(dev):
    w8, s = Q.quantize_weight(torch.randn(64, 8, device=dev))
    with pytest.raises(ValueError, match="rows"):
        Q.int8_matmul(torch.randn(129, 64, device=dev), w8, s)
    w8o, so = Q.quantize_weight(torch.randn(64, 6, device=dev))
    with pytest.raises(ValueError, match="N % 4"):
        Q.int8_matmul(torch.randn(2, 64, device=dev), w8o, so)
    with pytest.raises(TypeError):
        Q.int8_matmul(torch.randn(2, 64, device=dev).double(), w8, s)


def _exact_head(dev, g, B, D, V, layout):
    h = torch.randint(-3, 4, (B, D), generator=g, device=dev).float()
    if layout == "int8":
        w8 = torch.randint(-4, 5, (D, V), generator=g, device=dev).to(
            torch.int8)
        scale = 2.0 ** torch.randint(-3, 2, (V,), generator=g,
                                     device=dev).float()
        return h, None, (w8, scale)
    return h, torch.randint(-2, 3, (V, D), generator=g,
                            device=dev).float(), None


@pytest.mark.parametrize("layout", ["tied_fp32", "int8"])
def test_lmhead_topk_exact_ties_across_tiles(dev, layout):
    """Tied logits straddling the 1024-column tile borders, a ragged last
    tile, an all-banned row, penalised rows, and batches of 1, 16 and 20
    rows (two row groups): indices and values identical to a stable
    descending sort of the processed logits."""
    g = torch.Generator(device=dev).manual_seed(7)
    D = 64
    for B, V in ((1, 1024), (16, 3000), (20, 2176), (3, 128)):
        h, w, quant = _exact_head(dev, g, B, D, V, layout)
        if w is not None:                  # one tied value across a border
            w[V // 2 - 40:V // 2 + 40] = w[V // 2]
            if V > 1024:
                w[1000:1100] = w[1000]
        mask = torch.randint(0, 4, (B, V), generator=g, device=dev).int()
        mask[0] = 2                        # every token banned
        for m, pen in ((None, 1.0), (mask, 2.0), (mask, 1.0)):
            before = LT.lmhead_topk.launches
            vals, idx = LT.lmhead_topk(h, w, m, penalty=pen, quant=quant)
            assert LT.lmhead_topk.launches == before + 1
            rv, ri = LT.lmhead_topk_plain(h, w, m, penalty=pen, quant=quant)
            torch.cuda.synchronize()
            assert torch.equal(idx, ri), (B, V, pen)
            assert torch.equal(vals, rv), (B, V, pen)
        assert (rv[0] == -1e9).all() and torch.equal(
            ri[0], torch.arange(128, device=dev, dtype=torch.int32))


def test_lmhead_topk_random_close(dev):
    g = torch.Generator(device=dev).manual_seed(8)
    B, D, V = 16, 2048, 128256
    h = torch.randn(B, D, generator=g, device=dev)
    w = torch.randn(V, D, generator=g, device=dev) * 0.05
    w8, s = Q.quantize_weight(w, axis=1)
    for weight, quant in ((w, None), (None, (w8.t().contiguous(), s))):
        vals, idx = LT.lmhead_topk(h, weight, None, quant=quant)
        rv, ri = LT.lmhead_topk_plain(h, weight, None, quant=quant)
        torch.cuda.synchronize()
        torch.testing.assert_close(vals, rv, **TOL)
        assert (idx == ri).float().mean() > 0.99


@pytest.mark.parametrize("D", KV.SUPPORTED_HEAD_DIMS)
def test_attend_int8_kv_matches_plain(dev, D):
    """Fully masked rows, S not a multiple of the thread count, GQA groups
    1..8, one and several query steps."""
    g = torch.Generator(device=dev).manual_seed(D)
    for (Hq, Hkv), S, Tq in itertools.product(
            ((4, 4), (32, 8), (8, 1)), (1, 37, 200, 592), (1, 3)):
        B = 3
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        cache = KV.quantize_cache([(k, v)])[0]
        q = torch.randn(B, Tq, Hq, D, generator=g, device=dev)
        lens = torch.randint(1, S + 1, (B,), generator=g, device=dev)
        lens[1] = 0                        # every slot masked
        mask = (torch.arange(S, device=dev)[None] < lens[:, None]).int()
        before = KV.attend_int8_kv.launches
        out = KV.attend_int8_kv(q, cache, mask)
        assert KV.attend_int8_kv.launches == before + 1
        ref = KV.attend_int8_kv_plain(q, cache, mask)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, **TOL, msg=lambda m: (
            f"Hq={Hq} Hkv={Hkv} S={S} Tq={Tq}: {m}"))


@pytest.mark.parametrize("M", [128, 129, 8448])
def test_rmsnorm_matches_plain(dev, M):
    """Rows of K = 128, 2048 and 8192 (the kernel's widest); a row of zeros
    (the eps alone), rows of large values.  Both sides take fp32 sums of
    squares in different orders and the kernel's rsqrtf is within 2 ulp:
    atol = rtol = 1e-5."""
    g = torch.Generator(device=dev).manual_seed(M)
    for K in (128, 2048, 8192):
        x = torch.randn(M, K, generator=g, device=dev)
        x[0] = 0.0
        x[-1] *= 1e3
        scale = 1.0 + 0.1 * torch.randn(K, generator=g, device=dev)
        before = FU.fused_rmsnorm.launches
        out = FU.fused_rmsnorm(x, scale, 1e-5)
        assert FU.fused_rmsnorm.launches == before + 1
        ref = FU.rmsnorm_plain(x, scale, 1e-5)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all() and (out[0] == 0).all()
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"M={M} K={K}: {m}")


@pytest.mark.parametrize("M", [128, 129, 8448])
def test_swiglu_matmul_matches_plain(dev, M):
    """K = 128 and 8192, N = 128; a row tail (M = 129) and the gate up to
    +-60, where sigmoid saturates at both ends.  The fp32 sums run in
    another order: rtol 1e-4, atol 1e-5 of the largest output."""
    g = torch.Generator(device=dev).manual_seed(M)
    for K in (128, 8192):
        gate = torch.randn(M, K, generator=g, device=dev) * 3
        gate[:, :64] = torch.linspace(-60, 60, 64, device=dev)
        up = torch.randn(M, K, generator=g, device=dev)
        w = torch.randn(K, 128, generator=g, device=dev) * K ** -0.5
        before = FU.swiglu_matmul.launches
        out = FU.swiglu_matmul(gate, up, w)
        assert FU.swiglu_matmul.launches == before + 1
        ref = FU.swiglu_matmul_plain(gate, up, w)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        torch.testing.assert_close(
            out, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()),
            msg=lambda m: f"M={M} K={K}: {m}")
        again = FU.swiglu_matmul(gate, up, w)
        assert torch.equal(out, again)            # one fixed order of sums


def test_swiglu_kernel_column_tail_and_rejects(dev):
    """The kernel predicates a column tail (N % 128 != 0; the dispatch sends
    such N to the plain version, the kernel itself takes N % 4 == 0); the
    wrapper rejects K % 128, N % 4 and other dtypes."""
    gate = torch.randn(200, 256, device=dev)
    up = torch.randn(200, 256, device=dev)
    w = torch.randn(256, 132, device=dev) * 0.05
    out = FU._swiglu_cuda(gate, up, w)
    torch.testing.assert_close(out, FU.swiglu_matmul_plain(gate, up, w),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="K % 128"):
        FU._swiglu_cuda(gate[:, :200].contiguous(), up[:, :200].contiguous(),
                        w[:200].contiguous())
    with pytest.raises(ValueError, match="N % 4"):
        FU._swiglu_cuda(gate, up, w[:, :130].contiguous())
    with pytest.raises(TypeError):
        FU._swiglu_cuda(gate.double(), up.double(), w.double())


def _grads(fn, inputs, cot):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    (fn(*leaves) * cot).sum().backward()
    return [t.grad for t in leaves]


def test_function_gradients_match_plain_autograd(dev):
    """The flash, RMSNorm and SwiGLU Functions on the card: kernel forward,
    backward by recompute, against autograd through the plain versions."""
    g = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    q, k, v, mask, cs = _inputs(dev, g, 2, 40, 40, 8, 2, 64, "pad", True)
    cot = randn(2, 40, 8, 64)
    before = flash_attention.launches
    ours = _grads(lambda a, b, c: flash_attention(a, b, c, mask, True, None,
                                                  cs), (q, k, v), cot)
    assert flash_attention.launches == before + 1
    ref = _grads(lambda a, b, c: flash_attention_plain(a, b, c, mask, True,
                                                       None, cs),
                 (q, k, v), cot)
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, **TOL)
    x, s, cot = randn(256, 2048), 1.0 + 0.1 * randn(2048), randn(256, 2048)
    ours = _grads(FU.fused_rmsnorm, (x, s), cot)
    ref = _grads(lambda a, b: FU.rmsnorm_plain(a, b, 1e-5), (x, s), cot)
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, **TOL)
    gate, up, w = randn(256, 1024), randn(256, 1024), randn(1024, 256) * 0.03
    cot = randn(256, 256)
    ours_s = _grads(FU.swiglu_matmul, (gate, up, w), cot)
    ref_s = _grads(FU.swiglu_matmul_plain, (gate, up, w), cot)
    for a, b in zip(ours_s, ref_s):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_matmul_matches_plain_on_ragged_tiles(dev, dtype):
    """M and N not multiples of the 128 x 128 tile, K not a multiple of the
    8-deep step or of 4 (the element-by-element loads), r = 4, 8 and 16.
    fp32: rtol 1e-4, atol 1e-5 of the largest output (K products summed in
    another order).  bf16 (inputs and output bf16, sums fp32, xA rounded to
    bf16 as the Pallas kernel rounds it): within 2 bf16 ulps, rtol = atol =
    2^-7 of the largest output, since a sum on the other side of a rounding
    boundary moves the output or xA by one ulp."""
    g = torch.Generator(device=dev).manual_seed(13)
    for (M, K, N), r in itertools.product(
            ((1, 64, 4), (129, 256, 132), (200, 37, 300), (300, 2048, 517)),
            (4, 8, 16)):
        x = torch.randn(M, K, generator=g, device=dev).to(dtype)
        w = (torch.randn(K, N, generator=g, device=dev) * K ** -0.5).to(dtype)
        a = (torch.randn(K, r, generator=g, device=dev) * K ** -0.5).to(dtype)
        b = (torch.randn(r, N, generator=g, device=dev) * 0.1).to(dtype)
        before = lora_matmul.launches
        out = lora_matmul(x, w, a, b, 32.0 / r)
        assert lora_matmul.launches == before + 1
        assert out.dtype == dtype and out.shape == (M, N)
        ref = lora_ref(x, w, a, b, 32.0 / r, round_xa=True)
        torch.cuda.synchronize()
        big = float(ref.float().abs().max())
        tol = (dict(rtol=1e-4, atol=1e-5 * big) if dtype == torch.float32
               else dict(rtol=2 ** -7, atol=2 ** -7 * big))
        torch.testing.assert_close(out.float(), ref.float(), **tol,
                                   msg=lambda m: f"M={M} K={K} N={N} r={r}: "
                                                 f"{m}")
        assert torch.equal(out, lora_matmul(x, w, a, b, 32.0 / r))


def test_lora_matmul_rejects_what_it_does_not_take(dev):
    x, w = torch.randn(8, 16, device=dev), torch.randn(16, 8, device=dev)
    with pytest.raises(ValueError, match="r <="):
        lora_matmul(x, w, torch.randn(16, 17, device=dev),
                    torch.randn(17, 8, device=dev), 1.0)
    with pytest.raises(TypeError):
        lora_matmul(x.double(), w.double(), torch.randn(16, 4, device=dev,
                                                        dtype=torch.float64),
                    torch.randn(4, 8, device=dev, dtype=torch.float64), 1.0)
    with pytest.raises(TypeError):       # mixed dtypes
        lora_matmul(x, w.bfloat16(), torch.randn(16, 4, device=dev),
                    torch.randn(4, 8, device=dev), 1.0)


def test_nlinear_matches_plain(dev):
    """B = 1, 16 and 160; To < Ti, To = Ti and To > Ti; one input step; the
    sums run in the same order as the plain einsum's only by chance:
    atol = rtol = 1e-5."""
    g = torch.Generator(device=dev).manual_seed(14)
    for B, C, Ti, To in ((1, 64, 18, 30), (16, 64, 18, 18), (160, 64, 18, 18),
                         (3, 7, 30, 6), (2, 5, 1, 4)):
        x = torch.randn(B, C, Ti, generator=g, device=dev)
        w = torch.randn(C, Ti, To, generator=g, device=dev) * Ti ** -0.5
        b = torch.randn(C, To, generator=g, device=dev) * 0.1
        before = nlinear_fused.launches
        out = nlinear_fused(x, w, b)
        assert nlinear_fused.launches == before + 1
        ref = nlinear_ref(x, w, b)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"B={B} C={C} Ti={Ti} "
                                                 f"To={To}: {m}")
    zero = nlinear_fused(x, torch.zeros_like(w), torch.zeros_like(b))
    assert torch.equal(zero, x[:, :, -1:].expand(-1, -1, w.shape[2]))


def test_ade_fde_matches_plain(dev):
    """B = 1 and 160, T = 1, 18, 30 and 70 (more steps than a warp's
    lanes); the [xmin, xmax, ymin, ymax] order of norm_stat is taken from
    a stat whose x and y ranges differ.  atol = rtol = 1e-5."""
    g = torch.Generator(device=dev).manual_seed(15)
    for B, T in ((1, 1), (1, 30), (16, 18), (160, 18), (9, 70)):
        pred = torch.rand(B, 2, T, generator=g, device=dev)
        gt = torch.rand(B, 2, T, generator=g, device=dev)
        lo = torch.rand(B, 2, generator=g, device=dev) * 100
        hi = lo + 10 + torch.rand(B, 2, generator=g, device=dev) * 900
        stat = torch.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], 1)
        before = fused_ade_fde.launches
        out = fused_ade_fde(pred, gt, stat)
        assert fused_ade_fde.launches == before + 1
        ref = ade_fde_plain(pred, gt, stat)
        torch.cuda.synchronize()
        assert out.shape == (B, 2) and out.dtype == torch.float32
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"B={B} T={T}: {m}")
    same = fused_ade_fde(gt, gt, stat)
    assert torch.allclose(same, torch.full_like(same, 1e-6))


def test_ade_fde_raises_under_grad(dev):
    pred = torch.rand(4, 2, 6, device=dev, requires_grad=True)
    stat = torch.tensor([[0., 1., 0., 1.]], device=dev).expand(4, 4)
    before = fused_ade_fde.launches
    with pytest.raises(RuntimeError, match="fused_ade_fde has no backward"):
        fused_ade_fde(pred, pred.detach(), stat)
    with torch.no_grad():
        fused_ade_fde(pred, pred.detach(), stat)
    assert fused_ade_fde.launches == before + 1


def test_nlinear_and_lora_gradients_match_plain_autograd(dev):
    """The NLinear and LoRA Functions on the card: kernel forward, backward
    by recompute through the plain version, against autograd through the
    plain version (the LoRA forward in fp32, where the kernel's rounding
    of xA is the identity)."""
    g = torch.Generator(device=dev).manual_seed(16)

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s
    inputs = (randn(16, 64, 18), randn(64, 18, 30, s=0.2), randn(64, 30))
    cot = randn(16, 64, 30)
    before = nlinear_fused.launches
    ours = _grads(nlinear_fused, inputs, cot)
    assert nlinear_fused.launches == before + 1
    for o, r in zip(ours, _grads(nlinear_ref, inputs, cot)):
        torch.testing.assert_close(o, r, **TOL)
    inputs = (randn(200, 256), randn(256, 130, s=0.06), randn(256, 8, s=0.06),
              randn(8, 130, s=0.1))
    cot = randn(200, 130)
    before = lora_matmul.launches
    ours = _grads(lambda *t: lora_matmul(*t, 4.0), inputs, cot)
    assert lora_matmul.launches == before + 1
    for o, r in zip(ours, _grads(lambda *t: lora_ref(*t, 4.0), inputs, cot)):
        torch.testing.assert_close(o, r, **TOL)
