"""The port's CUDA kernels against their plain PyTorch versions, on the
card: flash attention (also at batch 1, the continuous batcher's
admission, and with the per-query masks of a speculative window), the int8
matrix product (also above one launch's 128 rows), the fused LM head +
top-128, the int8-KV decode attention (also with per-query masks), the one-pass RMSNorm, the fused SwiGLU
down-projection, NLinear, the fused LoRA product and the per-sample
ADE/FDE, and the gradients of the kernels in autograd Functions (flash,
RMSNorm, SwiGLU, NLinear, LoRA) against autograd through their plain
versions; flash, RMSNorm and SwiGLU also at the trained-weight studies'
mid-size shapes (``cli._common.midsize_cfg``; ``-k study``).

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
from tsue_tpu_torch.ops.lora import lora_matmul, lora_matmul_plan, lora_ref
from tsue_tpu_torch.ops.metric_kernels import ade_fde_plain, fused_ade_fde
from tsue_tpu_torch.ops.nlinear import (nlinear_fused, nlinear_plan,
                                        nlinear_ref)
from tsue_tpu_torch.ops.flash import (SUPPORTED_HEAD_DIMS, flash_attention,
                                      flash_attention_form,
                                      flash_attention_plain,
                                      flash_attention_plan)

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
        elif masked == "one_key":       # every later key split all masked
            lens[0] = 1
        mask = (torch.arange(Tk, device=dev)[None] < lens[:, None]).int()
    cs = None
    if rope:
        ang = torch.rand(B, Tk, D // 2, generator=g, device=dev) * 50
        cs = (torch.cos(ang), torch.sin(ang))
    return q, k, v, mask, cs


@pytest.mark.parametrize("D", SUPPORTED_HEAD_DIMS)
def test_kernel_matches_plain_on_edge_shapes(dev, D):
    """GQA 1..8, Tq != Tk with the causal offset, padded and empty key
    rows, RoPE, tails shorter than a 64-key tile or a block of items; Tq
    and Tk across several 64-item blocks and 64-key tiles (130, 200; 70
    rows against 130 keys), and few rows over many keys, which take the
    split-KV form with several key splits (1 x 592, 18 x 600)."""
    g = torch.Generator(device=dev).manual_seed(D)
    heads = ((4, 4), (4, 2), (8, 1), (8, 2)) + (
        ((32, 8),) if D <= 128 else ())
    lengths = ((1, 1), (5, 5), (33, 33), (7, 40), (40, 7), (70, 70),
               (130, 130), (200, 200), (70, 130), (18, 600), (1, 592))
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


@pytest.mark.parametrize("B,Tq,Tk,Hq,Hkv,D,causal,rope", [
    (3, 1, 592, 8, 2, 64, False, False),      # split-KV, 10 key splits
    (3, 18, 600, 2, 2, 1024, False, False),   # split-KV at D = 1024
    (3, 18, 600, 2, 2, 1024, True, False),
    (2, 200, 200, 32, 8, 64, True, True),     # tiled, RoPE, causal
])
def test_kernel_repeats_bit_identical(dev, B, Tq, Tk, Hq, Hkv, D, causal,
                                      rope):
    """Two calls on the same inputs give the same bits: the split-KV form
    merges its partials in one fixed split order, with no atomics."""
    g = torch.Generator(device=dev).manual_seed(Tk + D)
    q, k, v, mask, cs = _inputs(dev, g, B, Tq, Tk, Hq, Hkv, D, "empty_rows",
                                rope)
    before = flash_attention.launches
    first = flash_attention(q, k, v, mask, causal, None, cs)
    second = flash_attention(q, k, v, mask, causal, None, cs)
    assert flash_attention.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(
        first, flash_attention_plain(q, k, v, mask, causal, None, cs), **TOL)


@pytest.mark.parametrize("case", ["llama_rope", "llama_prefill",
                                  "qformer"])
def test_kernel_at_batch_one(dev, case):
    """The continuous batcher's admission prefills one request at a time:
    batch 1 at the Llama's 32/8 heads of 64 over the prompt buckets plus
    16 image tokens (Tq = Tk = 272, 400, 528), causal with a padded tail,
    with RoPE in the kernel (the predict path's form) and without (the
    cached prefill's, the keys roped before), and the Q-Former's D = 96
    self- and cross-attention over 64 frames."""
    g = torch.Generator(device=dev).manual_seed(1)
    if case == "qformer":
        calls = [_inputs(dev, g, 1, 64, 64, 8, 8, 96, "none", False),
                 _inputs(dev, g, 1, 16, 64, 8, 8, 96, "none", False)]
        calls = [(c, False) for c in calls]
    else:
        calls = [(_inputs(dev, g, 1, T, T, 32, 8, 64, "pad",
                          case == "llama_rope"), True)
                 for T in (272, 400, 528)]
    for (q, k, v, mask, cs), causal in calls:
        before = flash_attention.launches
        out = flash_attention(q, k, v, mask, causal, None, cs)
        assert flash_attention.launches == before + 1
        ref = flash_attention_plain(q, k, v, mask, causal, None, cs)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, **TOL, msg=lambda m: (
            f"{case} Tq={q.shape[1]} Tk={k.shape[1]}: {m}"))


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
    with pytest.raises(ValueError, match="mask must have shape"):
        flash_attention(q, q, q, torch.ones(2, 9, 8, device=dev))
    with pytest.raises(ValueError, match="the kernel takes a"):
        flash_attention(q, q, q, torch.ones(2, 4, 8, 8, device=dev))
    with pytest.raises(ValueError, match="Hkv"):
        k = q[:, :, :3].contiguous()
        flash_attention(q, k, k)


@pytest.mark.parametrize("M", [1, 15, 16, 17, 128])
def test_int8_matmul_matches_plain(dev, M):
    """Every decode projection shape of Llama-3.2-1B plus ragged K and N; M
    across the 16-row tiles up to the kernel's limit of 128 rows.  K = 20
    is less than one stage of the ring (64 rows); K = 300 and 1000 are
    multiples of neither the stage nor the split; K = 320 at N = 4096 and
    K = 576 at N = 2048 split K over several cluster ranks (at 576 the last
    one short); N = 4, 132 and 516 are multiples of 4 but not of the column
    tile, and not of 16 (the 4-byte copy path).  Every plan gives each
    cluster rank whole 64-row stages but the last, which is never empty."""
    g = torch.Generator(device=dev).manual_seed(M)
    shapes = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
              (300, 132), (64, 4), (20, 516), (320, 4096), (576, 2048),
              (1000, 132))
    for K, N in shapes:
        plan = Q.int8_matmul_plan(M, K, N)
        per, ranks = plan["k_rows_per_rank"], plan["cluster"]
        assert per % 64 == 0 and (ranks - 1) * per < K <= ranks * per, plan
    for K, N in shapes:
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
        Q.int8_matmul(torch.randn(0, 64, device=dev), w8, s)
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


def _tie_runs(w, quant, V, step):
    """Copy one column over the 16 columns around every multiple of
    ``step`` (the kernel's tile and warp borders) and over the 80 around
    V / 2: runs of one logit across the borders."""
    starts = [(x - 8, min(x + 8, V)) for x in range(step, V, step)]
    starts.append((V // 2 - 40, min(V // 2 + 40, V)))
    for lo, hi in starts:
        if quant is None:
            w[lo:hi] = w[lo]
        else:
            w8, scale = quant
            w8[:, lo:hi] = w8[:, lo:lo + 1]
            scale[lo:hi] = scale[lo]


def test_lmhead_topk_plan_layouts(dev):
    """Every form tiles the vocabulary in 1024 columns, splits the tile
    evenly across 16 warps (one a batch row in the selection) and fits its
    ring and keys in a block's shared memory; the tied bf16 form streams
    whole 128-byte lines of 256-row chunks (TMA boxes, a producer warp
    more) beside its 32-bit values, on a 1024-byte-aligned ring; an unknown
    layout raises."""
    plans = {layout: LT.lmhead_topk_plan(layout) for layout in LT.LAYOUTS}
    for layout, plan in plans.items():
        assert plan["tile_cols"] == 1024 and plan["warp_cols"] * 16 == 1024
        assert plan["stages"] >= 2 and plan["k_rows_per_stage"] % 8 == 0
        assert plan["tile_cols"] % plan["stage_rows"] == 0, plan
        assert plan["smem_bytes"] <= 232448, plan
    for layout in ("int8", "tied_fp32"):
        assert plans[layout]["threads"] == 512
        assert plans[layout]["stage_rows"] == 1024
        assert plans[layout]["smem_bytes"] >= 16 * 1024 * 8   # the keys
    bf = plans["tied_bf16"]
    assert bf["threads"] == 512 + 32
    assert bf["k_rows_per_stage"] * 2 == 128 and bf["stage_rows"] == 256
    assert bf["stages"] >= 3 and bf["smem_bytes"] == (
        1024 + bf["stages"] * (256 + 16) * 128 + 16 * 1024 * 4), bf
    with pytest.raises(ValueError, match="layout"):
        LT.lmhead_topk_plan("bf16")


@pytest.mark.parametrize("layout", ["tied_fp32", "int8"])
def test_lmhead_topk_exact_ties_across_tiles(dev, layout):
    """Tied logits straddling the tile borders and the form's own warp
    borders (read from its plan), a ragged last tile, an all-banned row,
    penalised rows, batches of 1, 16, 17 and 20 rows (two row groups past
    16), and 131 tiles (two rounds of the per-row merge, which takes 127
    tiles a round) at 17 and 20 rows; D a multiple of the form's stage
    depth and D = 100, a multiple of 4 but not of the depth (a last stage
    zero-filled past D): indices and values identical to a stable
    descending sort of the processed logits, and a repeated call
    bit-identical."""
    g = torch.Generator(device=dev).manual_seed(7)
    plan = LT.lmhead_topk_plan(layout)
    assert plan["tile_cols"] == 1024 and plan["tile_cols"] % plan[
        "warp_cols"] == 0, plan
    assert 100 % plan["k_rows_per_stage"], plan
    n131 = 131 * plan["tile_cols"] - 768
    for D, (B, V) in itertools.chain(
            itertools.product([4 * plan["k_rows_per_stage"]],
                              ((1, 1024), (16, 3000), (17, 2176),
                               (20, 2176), (3, 128), (17, n131))),
            itertools.product([100], ((16, 3000), (17, n131), (20, n131)))):
        h, w, quant = _exact_head(dev, g, B, D, V, layout)
        _tie_runs(w, quant, V, plan["warp_cols"])
        mask = torch.randint(0, 4, (B, V), generator=g, device=dev).int()
        mask[0] = 2                        # every token banned
        for m, pen in ((None, 1.0), (mask, 2.0), (mask, 1.0)):
            before = LT.lmhead_topk.launches
            vals, idx = LT.lmhead_topk(h, w, m, penalty=pen, quant=quant)
            again = LT.lmhead_topk(h, w, m, penalty=pen, quant=quant)
            assert LT.lmhead_topk.launches == before + 2
            rv, ri = LT.lmhead_topk_plain(h, w, m, penalty=pen, quant=quant)
            torch.cuda.synchronize()
            assert torch.equal(idx, ri), (D, B, V, pen)
            assert torch.equal(vals, rv), (D, B, V, pen)
            assert torch.equal(again[0], vals) and torch.equal(again[1],
                                                               idx), (D, B, V)
        assert (rv[0] == -1e9).all() and torch.equal(
            ri[0], torch.arange(128, device=dev, dtype=torch.int32))


def test_lmhead_topk_random_close(dev):
    """Random inputs at the decode shape, both forms: values within TOL of
    the plain version, nearly all indices equal (the rest ties within
    TOL), and a repeated call bit-identical."""
    g = torch.Generator(device=dev).manual_seed(8)
    B, D, V = 16, 2048, 128256
    h = torch.randn(B, D, generator=g, device=dev)
    w = torch.randn(V, D, generator=g, device=dev) * 0.05
    w8, s = Q.quantize_weight(w, axis=1)
    for weight, quant in ((w, None), (None, (w8.t().contiguous(), s))):
        vals, idx = LT.lmhead_topk(h, weight, None, quant=quant)
        again = LT.lmhead_topk(h, weight, None, quant=quant)
        rv, ri = LT.lmhead_topk_plain(h, weight, None, quant=quant)
        torch.cuda.synchronize()
        torch.testing.assert_close(vals, rv, **TOL)
        assert (idx == ri).float().mean() > 0.99
        assert torch.equal(again[0], vals) and torch.equal(again[1], idx)


@pytest.mark.parametrize("D", KV.SUPPORTED_HEAD_DIMS)
def test_attend_int8_kv_matches_plain(dev, D):
    """GQA groups 1..8, one and several query steps, and S giving one key
    split (S = 1, 20), two (37) and the most (200, 592; a split of 50 and
    148 keys).  Row 1 has no valid key (the uniform mean over all S, with
    more than one split when S > 32); row 2's only valid keys sit in the
    last split; the rest are padded."""
    g = torch.Generator(device=dev).manual_seed(D)
    splits = {S: KV.attend_int8_kv_plan(S, 4, D)["splits"]
              for S in (1, 20, 37, 200, 592)}
    assert splits == {1: 1, 20: 1, 37: 2, 200: 4, 592: 4}, splits
    for G, S, Tq in itertools.product(range(1, 9), (1, 20, 37, 200, 592),
                                      (1, 3)):
        B, Hkv = 3, 2
        Hq = G * Hkv
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        cache = KV.quantize_cache([(k, v)])[0]
        q = torch.randn(B, Tq, Hq, D, generator=g, device=dev)
        lens = torch.randint(1, S + 1, (B,), generator=g, device=dev)
        lens[1] = 0                        # every slot masked
        slots = torch.arange(S, device=dev)[None]
        mask = (slots < lens[:, None]).int()
        mask[2] = (slots[0] >= S - 3).int()  # valid keys in the last split
        before = KV.attend_int8_kv.launches
        out = KV.attend_int8_kv(q, cache, mask)
        assert KV.attend_int8_kv.launches == before + 1
        ref = KV.attend_int8_kv_plain(q, cache, mask)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, **TOL, msg=lambda m: (
            f"G={G} S={S} Tq={Tq}: {m}"))


@pytest.mark.parametrize("kernel", ["int8_matmul", "attend_int8_kv"])
def test_decode_kernels_repeat_bit_identical(dev, kernel):
    """At the decode shapes (M = 16 against each Llama-3.2-1B projection
    and the LM head; B = 16, 32/8 heads of 64, S = 592 with padded rows):
    two calls give the same bits.  Both kernels add their K or key splits
    in one fixed rank order through a cluster's shared memory, with no
    atomics."""
    g = torch.Generator(device=dev).manual_seed(17)
    if kernel == "int8_matmul":
        for K, N in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
                     (2048, 128256)):
            x = torch.randn(16, K, generator=g, device=dev)
            w8, s = Q.quantize_weight(torch.randn(K, N, generator=g,
                                                  device=dev))
            first, second = Q.int8_matmul(x, w8, s), Q.int8_matmul(x, w8, s)
            torch.cuda.synchronize()
            assert torch.equal(first, second), (K, N)
        return
    B, S, Hq, Hkv, D = 16, 592, 32, 8, 64
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
    cache = KV.quantize_cache([(k, v)])[0]
    q = torch.randn(B, 1, Hq, D, generator=g, device=dev)
    lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
    lens[1] = 0
    mask = (torch.arange(S, device=dev)[None] < lens[:, None]).int()
    first = KV.attend_int8_kv(q, cache, mask)
    second = KV.attend_int8_kv(q, cache, mask)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(first, KV.attend_int8_kv_plain(q, cache, mask),
                               **TOL)


def test_attend_int8_kv_rows_at_their_own_fill_levels(dev):
    """The continuous batcher's pool tick: B = 16 rows over S = 592 slots,
    each with its own valid prefix and its own decode step (the (B, S) mask
    of ``MultiModalLLM.decode_hidden`` with per-row steps), some rows with
    none (an empty slot riding along)."""
    g = torch.Generator(device=dev).manual_seed(23)
    B, S, Hq, Hkv, D, P = 16, 592, 32, 8, 64, 528
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
    cache = KV.quantize_cache([(k, v)])[0]
    q = torch.randn(B, 1, Hq, D, generator=g, device=dev)
    prefix = torch.randint(16, P + 1, (B,), generator=g, device=dev)
    step = torch.randint(0, S - P, (B,), generator=g, device=dev)
    slots = torch.arange(S, device=dev)[None]
    mask = ((slots < prefix[:, None])
            | ((slots >= P) & (slots <= P + step[:, None]))).int()
    mask[3] = 0
    out = KV.attend_int8_kv(q, cache, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, KV.attend_int8_kv_plain(q, cache, mask),
                               **TOL)


@pytest.mark.parametrize("kernel", ["int8_matmul", "attend_int8_kv"])
def test_decode_kernels_rows_independent(dev, kernel):
    """A row's bits do not depend on the other rows of the call: row b of
    a 16-row call equals the same row called alone (a pool of 16 slots
    against a pool of one)."""
    g = torch.Generator(device=dev).manual_seed(29)
    B = 16
    if kernel == "int8_matmul":
        for K, N in ((2048, 2048), (8192, 2048), (2048, 128256)):
            x = torch.randn(B, K, generator=g, device=dev)
            w8, s = Q.quantize_weight(torch.randn(K, N, generator=g,
                                                  device=dev))
            full = Q.int8_matmul(x, w8, s)
            for b in (0, 7, 15):
                assert torch.equal(full[b:b + 1],
                                   Q.int8_matmul(x[b:b + 1], w8, s)), (K, N)
        return
    S, Hq, Hkv, D = 592, 32, 8, 64
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
    cache = KV.quantize_cache([(k, v)])[0]
    q = torch.randn(B, 1, Hq, D, generator=g, device=dev)
    lens = torch.randint(1, S + 1, (B,), generator=g, device=dev)
    mask = (torch.arange(S, device=dev)[None] < lens[:, None]).int()
    full = KV.attend_int8_kv(q, cache, mask)
    for b in (0, 7, 15):
        one = KV.attend_int8_kv(q[b:b + 1],
                                tuple(c[b:b + 1] for c in cache),
                                mask[b:b + 1])
        assert torch.equal(full[b:b + 1], one), b


def _capacity(K, scale_dtype=torch.float32):
    """The rows one pass of the fp32 stream's grid covers at width K:
    its CTAs times the rows a CTA step."""
    plan = FU.rmsnorm_plan(1 << 24, K, torch.float32, scale_dtype)
    return plan["ctas"] * (8 // plan["warps_per_row"])


@pytest.mark.parametrize("rows", [128, 129, 2112, 4224, 8448, "capacity-1",
                                  "capacity+1"])
def test_rmsnorm_matches_plain(dev, rows):
    """Rows of K = 128, 2048 and 8192 (the kernel's widest); a row of zeros
    (the eps alone), rows of large values; M at the path's rows and one row
    below and above what one pass of the grid covers at each K.  Both sides
    take fp32 sums of squares in different orders and the kernel's rsqrtf
    is within 2 ulp: atol = rtol = 1e-5."""
    g = torch.Generator(device=dev).manual_seed(
        {"capacity-1": 1, "capacity+1": 2}.get(rows, rows))
    for K in (128, 2048, 8192):
        M = (rows if isinstance(rows, int)
             else _capacity(K) + int(rows[len("capacity"):]))
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


@pytest.mark.parametrize("M", [128, 129, 2112, 8448])
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


def _swiglu_case(dev, g, M, K, N, scale=1.0, gate=None):
    """One call of the kernel itself (``_swiglu_cuda``: any M and N % 4 ==
    0) against the plain version, rtol 1e-4 and atol 1e-5 of the largest
    output (the fp32 sums run in another order, on the tensor cores in
    3xTF32), one launch, and a repeated call bit-identical."""
    if gate is None:
        gate = torch.randn(M, K, generator=g, device=dev) * scale
    up = torch.randn(M, K, generator=g, device=dev) * scale
    w = torch.randn(K, N, generator=g, device=dev) * K ** -0.5
    before = FU.swiglu_matmul.launches
    out = FU._swiglu_cuda(gate, up, w)
    assert FU.swiglu_matmul.launches == before + 1
    ref = FU.swiglu_matmul_plain(gate, up, w)
    torch.cuda.synchronize()
    assert out.shape == (M, N) and torch.isfinite(out).all()
    torch.testing.assert_close(
        out, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()),
        msg=lambda m: f"M={M} K={K} N={N} scale={scale}: {m}")
    assert torch.equal(out, FU._swiglu_cuda(gate, up, w))
    return out, ref


@pytest.mark.parametrize("K", [128, 8192])
def test_swiglu_kernel_tile_borders(dev, K):
    """Rows at the 128 x 256 tile's borders (64, a warpgroup's rows; 65,
    127, 129; 8448, the training shape's 66 row blocks) against N = 132 (a
    column tail), 256 and 2048 (8 column tiles), at K = 128 (four 32-deep
    stages, fewer than a CTA's ring turns) and K = 8192 (the MLP's)."""
    g = torch.Generator(device=dev).manual_seed(K)
    for M, N in itertools.product((64, 65, 127, 129, 8448), (132, 256, 2048)):
        if K == 8192 and M == 8448 and N != 2048:
            continue                  # the training shape once, below
        _swiglu_case(dev, g, M, K, N)
    if K == 8192:
        _swiglu_case(dev, g, 8448, K, 2048)


@pytest.mark.parametrize("scale", [100.0, 1e-3])
def test_swiglu_kernel_large_and_small_exponents(dev, scale):
    """g and u scaled to ~100 (h up to ~1e6, the gate saturated) and to
    ~1e-3 (h ~1e-6): the tf32 split meets large and small exponents; the
    gate's ends at +-60 give exact 0 and g * u."""
    g = torch.Generator(device=dev).manual_seed(int(scale * 1000))
    M, K, N = 256, 1024, 256
    gate = torch.randn(M, K, generator=g, device=dev) * scale
    gate[:, :64] = torch.linspace(-60, 60, 64, device=dev)
    _swiglu_case(dev, g, M, K, N, scale=scale, gate=gate)
    # the gate's ends alone: W picks single K positions, so out = h exactly
    gate = torch.full((128, 128), -60.0, device=dev)
    gate[:, 64:] = 60.0
    up = torch.randn(128, 128, generator=g, device=dev) * scale
    out = FU._swiglu_cuda(gate, up, torch.eye(128, device=dev))
    torch.cuda.synchronize()
    assert (out[:, :64].abs() < 1e-20).all()
    torch.testing.assert_close(out[:, 64:], 60.0 * up[:, 64:], rtol=1e-6,
                               atol=0.0)


def test_swiglu_kernel_plan(dev):
    """The plan names the one form, its tiles and a persistent grid of at
    most one CTA a tile (one a SM on an H100), and refuses what the kernel
    does not take."""
    plan = FU.swiglu_matmul_plan(8448, 8192, 2048)
    assert plan["form"] == "tf32x3" and plan["tiles"] == 66 * 8
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan["ctas"] == min(528, sms)
    assert FU.swiglu_matmul_plan(4224, 8192, 2048)["tiles"] == 264
    small = FU.swiglu_matmul_plan(65, 128, 132)
    assert small["tiles"] == small["ctas"] == 1
    with pytest.raises(ValueError, match="K % 128"):
        FU.swiglu_matmul_plan(128, 200, 256)


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


def _lora_case(dev, g, M, K, N, r, dtype, scale=None):
    """One LoRA product against the plain version (tolerances as in
    ``test_lora_matmul_matches_plain_on_ragged_tiles``), one launch, and a
    repeated call bit-identical; returns the plan's form."""
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    w = (torch.randn(K, N, generator=g, device=dev) * K ** -0.5).to(dtype)
    a = (torch.randn(K, r, generator=g, device=dev) * K ** -0.5).to(dtype)
    b = (torch.randn(r, N, generator=g, device=dev) * 0.1).to(dtype)
    scale = 32.0 / r if scale is None else scale
    before = lora_matmul.launches
    out = lora_matmul(x, w, a, b, scale)
    assert lora_matmul.launches == before + 1
    assert out.dtype == dtype and out.shape == (M, N)
    ref = lora_ref(x, w, a, b, scale, round_xa=True)
    torch.cuda.synchronize()
    big = float(ref.float().abs().max())
    tol = (dict(rtol=1e-4, atol=1e-5 * big) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=2 ** -7 * big))
    torch.testing.assert_close(out.float(), ref.float(), **tol,
                               msg=lambda m: f"M={M} K={K} N={N} r={r}: {m}")
    assert torch.equal(out, lora_matmul(x, w, a, b, scale))
    return lora_matmul_plan(M, K, N, r, dtype)["form"]


_TC_FORM = {torch.float32: "tf32x3", torch.bfloat16: "wgmma_bf16"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_matmul_tensor_core_tile_borders(dev, dtype):
    """Outputs at the 128 x 256 tile's borders: M of 63, 64, 65 (a
    warpgroup's 64 rows), 127, 128, 129, N of 248, 256, 264 (tails inside
    rows that TMA reads: the tensor-core form) and 255, 257 (rows not a
    multiple of 16 bytes: the SIMT form), K = 72, past a whole k step of
    either tensor-core form."""
    g = torch.Generator(device=dev).manual_seed(17)
    for M, N in itertools.product((63, 64, 65, 127, 128, 129),
                                  (248, 255, 256, 257, 264)):
        form = _lora_case(dev, g, M, 72, N, 8, dtype)
        assert form == ("simt" if N % 8 else _TC_FORM[dtype]), (M, N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_matmul_k_tails_and_ranks(dev, dtype):
    """K shorter than a k step (8, 40), not a multiple of it (200: 3 x 64 +
    8 in bf16, 6 x 32 + 8 in fp32) and long (2056), with ranks 1, 4, 8 and
    16 (the fp32 form keeps 8 xA sums a thread for r <= 8, 16 above), all
    through the tensor-core form; several tiles a CTA at the long K."""
    g = torch.Generator(device=dev).manual_seed(18)
    for K, r in itertools.product((8, 40, 200, 2056), (1, 4, 8, 16)):
        assert _lora_case(dev, g, 130, K, 264, r, dtype) == _TC_FORM[dtype]
    # more tiles than the card holds CTAs: each CTA walks several
    assert _lora_case(dev, g, 4096, 256, 4096, 8, dtype) == _TC_FORM[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_matmul_stage1_shape(dev, dtype):
    """The stage-1 q_proj shape of chip_smoke.py (M 8448, K 2048, N 2048,
    r 8, scale 4), once in each dtype."""
    g = torch.Generator(device=dev).manual_seed(19)
    assert (_lora_case(dev, g, 16 * 528, 2048, 2048, 8, dtype, 4.0)
            == _TC_FORM[dtype])


def test_lora_matmul_plan_picks_the_form_by_shape(dev):
    """The plan sends an unaligned stride (K = 37) and a base that is not
    16-byte aligned to the SIMT form, the stage-1 shapes to the tensor-core
    forms; the wrapper launches what the plan names, and each is right."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = lora_matmul_plan(300, 37, 520, 8, dtype)
        assert plan["form"] == "simt" and plan["ctas"] == plan["tiles"] == 15
        for N in (2048, 512):
            plan = lora_matmul_plan(16 * 528, 2048, N, 8, dtype)
            assert plan["form"] == _TC_FORM[dtype]
            assert plan["tiles"] == 66 * N // 256
            assert 0 < plan["ctas"] <= plan["tiles"]
        assert lora_matmul_plan(64, 64, 256, 8, dtype,
                                aligned=False)["form"] == "simt"
    g = torch.Generator(device=dev).manual_seed(20)
    assert _lora_case(dev, g, 200, 37, 300, 8, torch.float32) == "simt"
    # x one element past an aligned base: contiguous, but not 16-byte aligned
    M, K, N, r = 130, 64, 256, 8
    x = torch.randn(M * K + 1, generator=g, device=dev)[1:].view(M, K)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = torch.randn(K, N, generator=g, device=dev) * K ** -0.5
    a = torch.randn(K, r, generator=g, device=dev) * K ** -0.5
    b = torch.randn(r, N, generator=g, device=dev) * 0.1
    out = lora_matmul(x, w, a, b, 4.0)
    ref = lora_ref(x, w, a, b, 4.0, round_xa=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()))


def test_lora_matmul_rejects_what_it_does_not_take(dev):
    x, w = torch.randn(8, 16, device=dev), torch.randn(16, 8, device=dev)
    with pytest.raises(ValueError, match="r > 0"):
        lora_matmul(x, w, torch.randn(16, 0, device=dev),
                    torch.randn(0, 8, device=dev), 1.0)
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


def _nlinear_case(dev, g, B, C, Ti, To):
    x = torch.randn(B, C, Ti, generator=g, device=dev)
    w = torch.randn(C, Ti, To, generator=g, device=dev) * Ti ** -0.5
    b = torch.randn(C, To, generator=g, device=dev) * 0.1
    return x, w, b


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary: ``flat[1:]`` of a buffer one element longer."""
    flat = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("C,Ti", [(7, 1), (7, 18), (7, 30), (64, 1),
                                  (64, 18), (64, 30)])
def test_nlinear_kernel_edge_shapes(dev, C, Ti):
    """B = 1, 17, 160, 161 (a last block of rows that is not full) and To
    = 1, 18, 30, 64, at odd C (a last group of one channel; the 4-byte
    form) and C = 64 (the bulk form where cg * Ti and cg * To are
    multiples of 4), Ti = 1 (an empty sum): one launch each, against the
    plain version, atol = rtol = 1e-5."""
    g = torch.Generator(device=dev).manual_seed(100 * C + Ti)
    for B, To in itertools.product((1, 17, 160, 161), (1, 18, 30, 64)):
        x, w, b = _nlinear_case(dev, g, B, C, Ti, To)
        before = nlinear_fused.launches
        out = nlinear_fused(x, w, b)
        assert nlinear_fused.launches == before + 1
        torch.cuda.synchronize()
        torch.testing.assert_close(out, nlinear_ref(x, w, b), atol=1e-5,
                                   rtol=1e-5, msg=lambda m: f"B={B} C={C} "
                                   f"Ti={Ti} To={To} "
                                   f"{nlinear_plan(B, C, Ti, To)}: {m}")


def test_nlinear_misaligned_views_give_the_aligned_bits(dev):
    """At the three path shapes, x, w and bias as contiguous views 4 bytes
    off a 16-byte boundary (x[1:] of a longer buffer) take the 4-byte form
    and give the bulk form's bits: both forms run the same arithmetic in
    the same order."""
    g = torch.Generator(device=dev).manual_seed(16)
    for B, C, Ti, To in ((16, 64, 18, 18), (160, 64, 18, 18),
                         (16, 64, 18, 30)):
        x, w, b = _nlinear_case(dev, g, B, C, Ti, To)
        aligned = nlinear_fused(x, w, b)
        for which in range(3):
            args = [x, w, b]
            args[which] = _misaligned(args[which])
            out = nlinear_fused(*args)
            torch.cuda.synchronize()
            assert torch.equal(out, aligned), (B, To, which)
        torch.testing.assert_close(aligned, nlinear_ref(x, w, b), **TOL)


def test_nlinear_repeats_bit_identical(dev):
    g = torch.Generator(device=dev).manual_seed(17)
    for B, C, Ti, To in ((16, 64, 18, 18), (161, 7, 30, 64), (2, 5, 1, 4)):
        x, w, b = _nlinear_case(dev, g, B, C, Ti, To)
        assert torch.equal(nlinear_fused(x, w, b), nlinear_fused(x, w, b))


def test_nlinear_launch_uses_the_plan(dev, monkeypatch):
    """The wrapper launches nlinear_plan's form and layout, for aligned
    and misaligned inputs; the C entry refuses a bulk launch on a
    misaligned x, and the wrapper a shape whose one channel does not fit
    in a CTA's shared memory."""
    import tsue_tpu_torch.ops.nlinear as NL
    launched = []
    real = NL._launch

    def spy(x, w, b, out, plan):
        launched.append(plan)
        return real(x, w, b, out, plan)
    monkeypatch.setattr(NL, "_launch", spy)
    g = torch.Generator(device=dev).manual_seed(18)
    x, w, b = _nlinear_case(dev, g, 16, 64, 18, 30)
    nlinear_fused(x, w, b)
    assert launched[-1] == nlinear_plan(16, 64, 18, 30) == dict(
        form="bulk", cg=2, bb=4, threads=256, ctas=128, smem_bytes=5152)
    xm = _misaligned(x)
    nlinear_fused(xm, w, b)
    assert launched[-1] == nlinear_plan(16, 64, 18, 30, aligned=False)
    assert launched[-1]["form"] == "cp4"
    x7, w7, b7 = _nlinear_case(dev, g, 3, 7, 30, 6)
    nlinear_fused(x7, w7, b7)
    assert launched[-1] == nlinear_plan(3, 7, 30, 6)
    out = torch.empty(16, 64, 30, device=dev)
    assert real(xm, w, b, out, nlinear_plan(16, 64, 18, 30)) != 0
    before = nlinear_fused.launches
    with pytest.raises(ValueError, match="shared"):
        nlinear_fused(*_nlinear_case(dev, g, 1, 1, 300, 300))
    assert nlinear_fused.launches == before


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


def _window_mask(dev, g, B, W, S, P):
    """(B, W, S) masks of a speculative window at per-row steps: query j of
    row b sees its valid prefix and the decode slots P .. P + step[b] + j.
    Query 0 of row 0 sees nothing, and with B > 1 row 1 sees nothing."""
    plen = torch.randint(1, P + 1, (B,), generator=g, device=dev)
    step = torch.randint(0, S - P - W + 1, (B,), generator=g, device=dev)
    k = torch.arange(S, device=dev)[None, None]
    upper = (P + step[:, None] + torch.arange(W, device=dev)[None])[..., None]
    m = (k < plen[:, None, None]) | ((k >= P) & (k <= upper))
    m[0, 0] = False
    if B > 1:
        m[1] = False
    return m.int()


@pytest.mark.parametrize("B", [1, 16])
def test_attention_kernels_take_per_query_masks(dev, B):
    """A speculative window's attention over the decode cache: W = 1..8
    queries of 32/8 heads of 64 over S = 600 slots, a (B, W, S) mask and
    the same as (B, 1, W, S), through the flash kernel (its split-KV form
    up to 16 items per (row, KV head), W <= 4, and its tiled form above)
    and the int8-KV kernel: one launch each, within 1e-4 of the plain
    versions, all-masked query rows the uniform mean of V."""
    from tsue_tpu_torch.ops.flash import _lib
    g = torch.Generator(device=dev).manual_seed(31 + B)
    S, P, Hq, Hkv, D = 600, 528, 32, 8, 64
    split_forms = set()
    for W in range(1, 9):
        q = torch.randn(B, W, Hq, D, generator=g, device=dev)
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        cache = KV.quantize_cache([(k, v)])[0]
        m = _window_mask(dev, g, B, W, S, P)
        split_forms.add(_lib().flash_attn_splits(B, W, S, Hq, Hkv, D, 0, 1, 0)
                        > 1)
        for mask in (m, m[:, None]):
            before = flash_attention.launches
            out = flash_attention(q, k, v, mask)
            assert flash_attention.launches == before + 1
            ref = flash_attention_plain(q, k, v, mask)
            before = KV.attend_int8_kv.launches
            out8 = KV.attend_int8_kv(q, cache, mask)
            assert KV.attend_int8_kv.launches == before + 1
            ref8 = KV.attend_int8_kv_plain(q, cache, mask)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, **TOL, msg=lambda e: (
                f"flash W={W} {tuple(mask.shape)}: {e}"))
            torch.testing.assert_close(out8, ref8, **TOL, msg=lambda e: (
                f"int8-KV W={W} {tuple(mask.shape)}: {e}"))
            mean_v = v[0].mean(0).repeat_interleave(Hq // Hkv, 0)
            torch.testing.assert_close(out[0, 0], mean_v, **TOL)
    assert split_forms == {True, False}


@pytest.mark.parametrize("kernel", ["flash", "attend_int8_kv"])
def test_repeated_key_mask_gives_the_key_mask_bits(dev, kernel):
    """A (B, W, S) mask whose rows repeat a (B, S) key mask gives the bits
    of the key-mask call (the same loads and arithmetic, another stride),
    in both flash forms (W = 4 split-KV, W = 8 tiled)."""
    g = torch.Generator(device=dev).manual_seed(37)
    B, S, Hq, Hkv, D = 16, 600, 32, 8, 64
    for W in (1, 4, 8):
        q = torch.randn(B, W, Hq, D, generator=g, device=dev)
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        lens = torch.randint(0, S + 1, (B,), generator=g, device=dev)
        key = (torch.arange(S, device=dev)[None] < lens[:, None]).int()
        rep = key[:, None].expand(B, W, S).contiguous()
        if kernel == "flash":
            a, b = flash_attention(q, k, v, key), flash_attention(q, k, v, rep)
        else:
            cache = KV.quantize_cache([(k, v)])[0]
            a, b = (KV.attend_int8_kv(q, cache, key),
                    KV.attend_int8_kv(q, cache, rep))
        torch.cuda.synchronize()
        assert torch.equal(a, b), W


def test_int8_matmul_above_one_launch(dev):
    """M = 256 rows (a speculative window of 16 rows by 16 positions) run
    as two launches of 128 rows, bit for bit two 128-row calls; M = 200
    as 128 + 72."""
    g = torch.Generator(device=dev).manual_seed(41)
    for M, K, N in ((256, 2048, 2048), (256, 2048, 128256),
                    (200, 8192, 2048)):
        x = torch.randn(M, K, generator=g, device=dev)
        w8, s = Q.quantize_weight(torch.randn(K, N, generator=g, device=dev))
        before = Q.int8_matmul.launches
        out = Q.int8_matmul(x, w8, s)
        assert Q.int8_matmul.launches == before + 2
        parts = torch.cat([Q.int8_matmul(x[:128], w8, s),
                           Q.int8_matmul(x[128:], w8, s)])
        torch.cuda.synchronize()
        assert torch.equal(out, parts), (M, K, N)
        ref = Q.int8_matmul_ref(x, w8, s)
        torch.testing.assert_close(out, ref, rtol=1e-4,
                                   atol=1e-5 * float(ref.abs().max()))


# --------------------------------------------------------------------------
# bf16 forms (a model whose parameters are bf16) and LoRA above rank 16
# --------------------------------------------------------------------------

# The bf16 kernels round where their plain versions round, not always the
# same value: flash rounds the unnormalised probabilities to bf16 (the plain
# version the normalised ones), and a bf16 output can land on the other side
# of a rounding boundary from a sum in another order.  Both are a few bf16
# ulps (2^-8 relative): atol 2^-6, rtol 2^-7 against outputs of order 1.
BF_TOL = dict(atol=2 ** -6, rtol=2 ** -7)
BF = torch.bfloat16
# (q dtype, k/v dtype): all bf16 (the Llama, the Q-Former's self-attention),
# fp32 q over bf16 k/v (the LTSF cross-attention), bf16 q over fp32 k/v
# (the Q-Former's cross-attention; the wrapper widens q)
MIXED = {"bf16": (BF, BF), "f32_q": (torch.float32, BF),
         "bf16_q": (BF, torch.float32)}


# shapes at the edges of the all-bf16 tensor-core form ("bf16_mma"): T
# not a multiple of 16 or 64, causal with Tq < Tk, D 16 to 128, G 1 and 4,
# RoPE on and off, one block of 128 items and several
BF16_MMA_EDGES = [(2, 17, 17, 4, 1, 128, True, True),
                  (2, 33, 70, 8, 2, 64, True, False),
                  (2, 70, 70, 4, 4, 128, False, True),
                  (2, 200, 200, 4, 1, 96, True, True),
                  (2, 33, 33, 8, 8, 32, True, True),
                  (2, 17, 40, 4, 1, 16, True, False),
                  (2, 70, 200, 8, 2, 64, True, False),
                  (2, 200, 200, 8, 8, 16, True, True)]
# shapes at the edges of the all-bf16 decode form ("bf16_decode"): Tq 1 and
# 4 at G 4 (4 and 16 items), Tq 2 at G 1, D 16 to 128, Tk 1, 63, 65, 592
# and 2000 (one key split and several, a tile tail), causal with Tq > 1,
# the Llama's decode step (B 16, 32/8 x 64: one split), few (b, KV head)
# pairs over many keys (many splits, merged by the last block)
BF16_DECODE_EDGES = [(2, 1, 1, 4, 1, 64, False, False),
                     (2, 4, 63, 16, 4, 32, True, False),
                     (2, 2, 65, 2, 2, 16, False, False),
                     (3, 4, 592, 8, 2, 96, False, False),
                     (2, 1, 2000, 32, 8, 128, False, False),
                     (2, 2, 2000, 4, 4, 64, True, False),
                     (2, 4, 65, 4, 1, 16, True, False),
                     (16, 1, 592, 32, 8, 64, False, False)]


@pytest.mark.parametrize("dtypes", list(MIXED))
def test_kernel_bf16_matches_plain(dev, dtypes):
    """Each dtype combination in the three forms of the kernel: tiled
    (GQA 32/8 x 64, 200 rows, causal, with RoPE where the combination takes
    it; D = 16, 32 and 96 of the small encoders; all bf16: the tensor-core
    form, also at ``BF16_MMA_EDGES``), split-KV (one query over 592 keys;
    18 queries of the LTSF cross-attention, D = 1024, over 600: the wide
    form "bf16_wide" where k and v are bf16; all bf16 at D <= 128: the
    decode form, also at ``BF16_DECODE_EDGES``, with no mask and with one
    valid key in a row), with padded and all-masked key
    rows: the form the plan names, one launch, the output in q's dtype,
    within BF_TOL of the plain version, a repeat bit-identical."""
    qd, kd = MIXED[dtypes]
    g = torch.Generator(device=dev).manual_seed(41)
    shapes = [(2, 200, 200, 32, 8, 64, True, True),
              (3, 70, 70, 8, 8, 16, False, False),
              (3, 18, 18, 2, 2, 32, False, True),
              (3, 33, 64, 8, 8, 96, False, False),
              (3, 1, 592, 8, 2, 64, False, False),
              (3, 18, 600, 2, 2, 1024, False, False)]
    masks = ("pad", "empty_rows")
    cases = list(itertools.product(shapes, masks))
    if dtypes == "bf16":
        cases += list(itertools.product(BF16_MMA_EDGES, masks))
        cases += list(itertools.product(BF16_DECODE_EDGES,
                                        masks + ("none", "one_key")))
    for (B, Tq, Tk, Hq, Hkv, D, causal, rope), masked in cases:
        rope = rope and dtypes != "bf16_q"
        q, k, v, mask, cs = _inputs(dev, g, B, Tq, Tk, Hq, Hkv, D, masked,
                                    rope)
        q, k, v = q.to(qd), k.to(kd), v.to(kd)
        form = flash_attention_form(B, Tq, Tk, Hq, Hkv, D, rope, False, qd,
                                    kd)
        tiled = D <= 128 and (rope or Tq * Hq // Hkv > 16)
        assert form == (("bf16_wide" if kd == BF else "split-KV D1024")
                        if D > 128 else
                        ("bf16_mma" if tiled else "bf16_decode")
                        if dtypes == "bf16" else
                        "tiled" if tiled else "split-KV"), form
        before = flash_attention.launches
        out = flash_attention(q, k, v, mask, causal, None, cs)
        assert flash_attention.launches == before + 1
        assert out.dtype == qd
        ref = flash_attention_plain(q, k, v, mask, causal, None, cs)
        again = flash_attention(q, k, v, mask, causal, None, cs)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all()
        torch.testing.assert_close(out.float(), ref.float(), **BF_TOL,
                                   msg=lambda m: (
            f"{dtypes} B={B} Tq={Tq} Tk={Tk} D={D} causal={causal} "
            f"mask={masked} rope={rope}: {m}"))
        assert torch.equal(out, again)


def test_kernel_bf16_decode_plan(dev):
    """The decode form's key splits: one wave of blocks over the card, so
    the Llama's decode step (B 16, 8 KV heads: 128 pairs) takes one split
    and no merge, while one request (B 1) spreads its 10 key tiles over
    one split each; a repeat after another shape's call is bit-identical
    (the merging block left its ticket at zero)."""
    from tsue_tpu_torch.ops.flash import _DT, _lib
    dt = _DT[(BF, BF)]
    assert _lib().flash_attn_splits(16, 1, 592, 32, 8, 64, 0, 0, dt) == 1
    assert _lib().flash_attn_splits(1, 1, 592, 32, 8, 64, 0, 0, dt) == 10
    g = torch.Generator(device=dev).manual_seed(45)
    q, k, v, mask, _ = _inputs(dev, g, 1, 1, 592, 32, 8, 64, "pad", False)
    q, k, v = q.to(BF), k.to(BF), v.to(BF)
    first = flash_attention(q, k, v, mask)
    flash_attention(*(t.contiguous() for t in (
        q[:, :, :16], k[:, :300, :4], v[:, :300, :4])), mask[:, :300])
    torch.cuda.synchronize()
    assert torch.equal(first, flash_attention(q, k, v, mask))


# shapes at the edges of the wide form ("bf16_wide": bf16 k and v at D =
# 1024), (B, Tq, Tk, Hq, Hkv, causal): Tk 1, 63, 64, 65, 528 and 2000
# (one 16-key tile, tile tails, one key split and up to eight, ragged
# splits), B 1 and 64 (one (b, head) pair a head and one wave of pairs), Tq
# 1, 18 and 33 (one item block, a full one, two), GQA 4/2 (four blocks),
# causal with Tq > Tk (rows with no visible key) and Tq < Tk
BF16_WIDE_EDGES = [(1, 1, 1, 2, 2, False),
                   (2, 18, 1, 2, 2, True),
                   (2, 18, 63, 2, 2, False),
                   (2, 18, 64, 2, 2, True),
                   (2, 33, 65, 2, 2, True),
                   (16, 18, 528, 2, 2, False),
                   (1, 18, 528, 2, 2, False),
                   (2, 1, 2000, 2, 2, False),
                   (2, 18, 2000, 2, 2, True),
                   (64, 18, 65, 2, 2, False),
                   (3, 33, 200, 4, 2, True)]


@pytest.mark.parametrize("dtypes", ["f32_q", "bf16"])
def test_kernel_bf16_wide_edges(dev, dtypes):
    """The wide form at ``BF16_WIDE_EDGES``, with no mask, padded key rows,
    a row with no valid key (B > 1) and a row with one valid key (every
    later key split all masked): the form "bf16_wide", one launch, the
    output in q's dtype, finite, within BF_TOL of the plain version, a
    repeat bit-identical."""
    qd, kd = MIXED[dtypes]
    g = torch.Generator(device=dev).manual_seed(47)
    for B, Tq, Tk, Hq, Hkv, causal in BF16_WIDE_EDGES:
        masks = ("none", "pad", "one_key") + (("empty_rows",) if B > 1
                                              else ())
        for masked in masks:
            q, k, v, mask, _ = _inputs(dev, g, B, Tq, Tk, Hq, Hkv, 1024,
                                       masked, False)
            q, k, v = q.to(qd), k.to(kd), v.to(kd)
            assert flash_attention_form(B, Tq, Tk, Hq, Hkv, 1024, False,
                                        False, qd, kd) == "bf16_wide"
            before = flash_attention.launches
            out = flash_attention(q, k, v, mask, causal)
            assert flash_attention.launches == before + 1
            assert out.dtype == qd
            ref = flash_attention_plain(q, k, v, mask, causal)
            again = flash_attention(q, k, v, mask, causal)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all()
            torch.testing.assert_close(out.float(), ref.float(), **BF_TOL,
                                       msg=lambda m: (
                f"{dtypes} B={B} Tq={Tq} Tk={Tk} Hq={Hq} Hkv={Hkv} "
                f"causal={causal} mask={masked}: {m}"))
            assert torch.equal(out, again)
            del q, k, v, out, ref, again


def test_kernel_bf16_wide_plan(dev):
    """The wide form's plan: the LTSF cross-attention's call (B 16, 18
    queries over 528 keys, 2 heads of 1024) takes one wave of clusters,
    one block an SM at most, each cluster's key splits no more than 8 and
    no more than its 33 tiles of 16 keys, the same plan for fp32 and bf16
    q; an fp32 call keeps "split-KV D1024"; a repeat after another shape's
    call is bit-identical (the merge leaves nothing behind)."""
    args = (16, 18, 528, 2, 2, 1024, False, False)
    plans = [flash_attention_plan(*args, qd, BF)
             for qd in (torch.float32, BF)]
    for plan in plans:
        assert plan["form"] == "bf16_wide" and plan["waves"] == 1, plan
        assert plan["cluster"] == plan["splits"] <= 8, plan
        assert plan["blocks"] == 32 * plan["splits"], plan
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert plan["blocks"] <= sms, plan
        assert plan["keys_per_split"] == 16 * -(-33 // plan["splits"]), plan
    assert plans[0] == plans[1]
    assert flash_attention_form(*args, torch.float32,
                                torch.float32) == "split-KV D1024"
    g = torch.Generator(device=dev).manual_seed(48)
    q, k, v, mask, _ = _inputs(dev, g, 16, 18, 528, 2, 2, 1024, "pad", False)
    k, v = k.to(BF), v.to(BF)
    first = flash_attention(q, k, v, mask)
    flash_attention(*(t[:3, :5].contiguous() for t in (q, k, v)),
                    mask[:3, :5])
    torch.cuda.synchronize()
    assert torch.equal(first, flash_attention(q, k, v, mask))


def test_kernel_bf16_rejects_what_it_does_not_take(dev):
    """A per-query mask is taken in fp32 only; a bf16 q over fp32 k/v
    with RoPE has no exact widening; fp16 is not taken."""
    q = torch.randn(2, 8, 4, 64, device=dev, dtype=BF)
    with pytest.raises(ValueError, match="per-query mask"):
        flash_attention(q, q, q, torch.ones(2, 8, 8, device=dev))
    cs = (torch.ones(2, 8, 32, device=dev), torch.zeros(2, 8, 32, device=dev))
    with pytest.raises(ValueError, match="without RoPE"):
        flash_attention(q, q.float(), q.float(), rope=cs)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())


@pytest.mark.parametrize("dtypes", ["bf16_bf16", "bf16_f32", "f32_bf16"])
def test_rmsnorm_bf16_matches_plain(dev, dtypes):
    """bf16 x and/or bf16 scale (x's dtype out), rows of 128, 2048, 4096
    and 8192 (bf16 x: one, two, four and eight warps a row), 128 rows to
    100 000 (more rows than one wave of the stream's CTAs holds), a zero
    row, large
    rows, a row of bf16's largest values (the sum of squares overflows to
    inf, the output to 0) and one of its smallest normals: the plan's form
    ("bf16_stream" for bf16 x, "fp32_stream" for fp32), one launch, within one bf16
    ulp of the plain version (rtol 2^-7), a repeat bit-identical."""
    xd, sd = (BF if t == "bf16" else torch.float32
              for t in dtypes.split("_"))
    g = torch.Generator(device=dev).manual_seed(43)
    big, tiny = torch.finfo(BF).max, torch.finfo(BF).tiny
    for M, K in ((129, 2048), (8448, 2048), (256, 8192), (128, 128),
                 (128, 4096), (100_000, 128), (100_000, 4096)):
        x = torch.randn(M, K, generator=g, device=dev)
        x[0] = 0.0
        x[-1] *= 1e3
        x[1] = big * torch.sign(x[1])
        x[2] = tiny * torch.sign(x[2])
        x = x.to(xd)
        scale = (1.0 + 0.1 * torch.randn(K, generator=g, device=dev)).to(sd)
        plan = FU.rmsnorm_plan(M, K, xd, sd)
        assert plan["form"] == ("bf16_stream" if xd == BF
                                else "fp32_stream"), plan
        if xd == BF:
            assert plan["warps_per_row"] == max(1, K // 1024), plan
        before = FU.fused_rmsnorm.launches
        out = FU.fused_rmsnorm(x, scale, 1e-5)
        assert FU.fused_rmsnorm.launches == before + 1
        assert out.dtype == xd
        ref = FU.rmsnorm_plain(x, scale, 1e-5)
        again = FU.fused_rmsnorm(x, scale, 1e-5)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-5,
                                   rtol=2 ** -7, msg=lambda m: (
                                       f"{dtypes} M={M} K={K}: {m}"))
        assert torch.equal(out, again)


# K: (warps a row, 16-byte vectors a lane) of the fp32 stream
FP32_SPLITS = {128: (1, 1), 256: (1, 2), 512: (1, 4), 1024: (2, 4),
               2048: (4, 4), 4096: (8, 4), 8192: (8, 8)}


@pytest.mark.parametrize("K", sorted(FP32_SPLITS))
def test_rmsnorm_fp32_stream_edges(dev, K):
    """The fp32 form at each split of K (one warp a row up to K = 512,
    then 2, 4 and 8; eight vectors a lane at 8192), over fp32 and bf16
    scales: M = 128, 129 (one row past a CTA step), one row below and
    above what one pass of the grid covers, 2112 and 8448; a zero row and
    a row of large values.  The plan, one launch, within 1e-5 of the plain
    version (sums in another order), a repeat bit-identical, and the first
    and last 128 rows bit-identical to the call on those rows alone: a
    row's bits do not depend on M or on the grid."""
    warps, vectors = FP32_SPLITS[K]
    g = torch.Generator(device=dev).manual_seed(K)
    for sd in (torch.float32, BF):
        cap = _capacity(K, sd)
        for M in (128, 129, cap - 1, cap + 1, 2112, 8448):
            x = torch.randn(M, K, generator=g, device=dev)
            x[0] = 0.0
            x[-1] *= 1e3
            scale = (1.0 + 0.1 * torch.randn(K, generator=g,
                                              device=dev)).to(sd)
            plan = FU.rmsnorm_plan(M, K, torch.float32, sd)
            assert (plan["form"], plan["warps_per_row"],
                    plan["vectors_per_lane"]) == (
                        "fp32_stream", warps, vectors), plan
            before = FU.fused_rmsnorm.launches
            out = FU.fused_rmsnorm(x, scale, 1e-5)
            assert FU.fused_rmsnorm.launches == before + 1
            ref = FU.rmsnorm_plain(x, scale, 1e-5)
            again = FU.fused_rmsnorm(x, scale, 1e-5)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5,
                                       msg=lambda m: f"M={M} {sd}: {m}")
            assert torch.equal(out, again), (M, sd)
            for a in (0, M - 128):
                part = FU.fused_rmsnorm(x[a:a + 128], scale, 1e-5)
                assert torch.equal(out[a:a + 128], part), (M, sd, a)


@pytest.mark.parametrize("M", [128, 129, 8448])
def test_swiglu_matmul_bf16_matches_plain(dev, M):
    """The bf16 form: K = 128 (two 64-deep stages) and 8192, N = 128, 136
    (a column tile of 136, a W box past N left unloaded), 520 (a last tile
    of 8 columns) and 2048, a row tail, the gate up to +-60: one launch of
    the plan's form "bf16_wgmma", within BF_TOL-like bounds of the plain
    version (rtol 2^-7, atol 2^-7 of the largest output: sums in another
    order, one output rounding), a repeat bit-identical."""
    g = torch.Generator(device=dev).manual_seed(M + 5)
    for K, N in ((128, 128), (128, 136), (8192, 520), (8192, 2048)):
        gate = torch.randn(M, K, generator=g, device=dev) * 3
        gate[:, :64] = torch.linspace(-60, 60, 64, device=dev)
        gate = gate.to(BF)
        up = torch.randn(M, K, generator=g, device=dev).to(BF)
        w = (torch.randn(K, N, generator=g, device=dev) * K ** -0.5).to(BF)
        assert FU.swiglu_matmul_plan(M, K, N, BF)["form"] == "bf16_wgmma"
        # the wrapper sends N % 128 != 0 to the plain version, as the JAX
        # package's dispatch does; the kernel's entry takes N % 8 == 0
        call = FU.swiglu_matmul if N % 128 == 0 else FU._swiglu_cuda
        before = FU.swiglu_matmul.launches
        out = call(gate, up, w)
        assert FU.swiglu_matmul.launches == before + 1
        assert out.dtype == BF
        ref = FU.swiglu_matmul_plain(gate, up, w)
        again = call(gate, up, w)
        torch.cuda.synchronize()
        big = float(ref.float().abs().max())
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                                   atol=2 ** -7 * big,
                                   msg=lambda m: f"M={M} K={K} N={N}: {m}")
        assert torch.equal(out, again)


def test_bf16_function_gradients_match_plain_autograd(dev):
    """The flash, RMSNorm and SwiGLU Functions on bf16 tensors: the kernel
    forward, the backward by recompute through the plain version, gradients
    in the inputs' dtypes, equal to autograd through the plain versions."""
    g = torch.Generator(device=dev).manual_seed(47)

    def randn(*shape, dtype=BF):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)
    q, k, v, mask, cs = _inputs(dev, g, 2, 40, 40, 8, 2, 64, "pad", True)
    q, k, v = q.to(BF), k.to(BF), v.to(BF)
    cot = randn(2, 40, 8, 64)
    ours = _grads(lambda a, b, c: flash_attention(a, b, c, mask, True, None,
                                                  cs), (q, k, v), cot)
    ref = _grads(lambda a, b, c: flash_attention_plain(a, b, c, mask, True,
                                                       None, cs),
                 (q, k, v), cot)
    for a, b in zip(ours, ref):
        assert a.dtype == BF
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    x, s, cot = randn(256, 2048), 1.0 + 0.1 * randn(2048), randn(256, 2048)
    ours = _grads(FU.fused_rmsnorm, (x, s), cot)
    ref = _grads(lambda a, b: FU.rmsnorm_plain(a, b, 1e-5), (x, s), cot)
    for a, b in zip(ours, ref):
        assert a.dtype == BF
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    gate, up, w = randn(256, 1024), randn(256, 1024), randn(1024, 256) * 0.03
    cot = randn(256, 256)
    ours = _grads(FU.swiglu_matmul, (gate, up, w), cot)
    ref = _grads(FU.swiglu_matmul_plain, (gate, up, w), cot)
    for a, b in zip(ours, ref):
        assert a.dtype == BF
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_matmul_above_rank_16(dev, dtype):
    """Ranks 17, 24 and 64 (one, two and four walks of 16 ranks) on ragged
    and stage-1 shapes: the SIMT form, one launch, within the tolerances
    of ``test_lora_matmul_matches_plain_on_ragged_tiles``, a repeat
    bit-identical."""
    g = torch.Generator(device=dev).manual_seed(53)
    for (M, K, N), r in itertools.product(
            ((129, 256, 132), (200, 37, 300), (8448, 2048, 512)),
            (17, 24, 64)):
        assert _lora_case(dev, g, M, K, N, r, dtype) == "simt"


# --------------------------------------------------------------------------
# bf16 forms of the three decode kernels (a bf16 model's quantised decode)
# and the implementation switches' plain routes
# --------------------------------------------------------------------------

def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(
        1e-30))) - 7)


def _assert_bf16_ulp(out, ref, ulps, what):
    """bf16 ``out`` within ``ulps`` ulps of bf16 ``ref``, element by
    element (the two sum in different orders, then round once), or 1e-6
    of the largest where an output cancels towards 0."""
    assert out.dtype == ref.dtype == BF, what
    d = (out.float() - ref.float()).abs()
    bad = d > ulps * _bf16_ulp(ref) + 1e-6 * ref.float().abs().max()
    assert not bad.any(), (what, float(d.max()), int(bad.sum()))


@pytest.mark.parametrize("M", [1, 16, 128, 300])
def test_int8_matmul_bf16_matches_plain(dev, M):
    """bf16 x (the one-term form) at the decode projections, the LM head
    with an fp32 output, ragged K and N (N = 132 and 516: the 4-byte copy
    path; K = 100: not a multiple of 8, x staged by plain loads), and M
    across one launch's 128 rows and above (300: three consecutive
    launches): bf16 outputs within one bf16 ulp of the plain version,
    fp32 outputs within 1e-5 of the largest, a repeated call
    bit-identical, one launch per 128 rows."""
    g = torch.Generator(device=dev).manual_seed(43 + M)
    for K, N, out_dtype in ((2048, 2048, BF), (2048, 512, BF),
                            (8192, 2048, BF), (2048, 8192, BF),
                            (2048, 128256, torch.float32), (300, 132, BF),
                            (100, 516, BF), (576, 2048, torch.float32)):
        x = torch.randn(M, K, generator=g, device=dev).to(BF)
        w8, s = Q.quantize_weight(torch.randn(K, N, generator=g, device=dev))
        before = Q.int8_matmul.launches
        out = Q.int8_matmul(x, w8, s, out_dtype=out_dtype)
        assert Q.int8_matmul.launches == before + -(-M // Q.MAX_ROWS)
        again = Q.int8_matmul(x, w8, s, out_dtype=out_dtype)
        ref = Q.int8_matmul_ref(x, w8, s, out_dtype)
        torch.cuda.synchronize()
        assert out.dtype == out_dtype and torch.equal(out, again), (K, N)
        if out_dtype == BF:
            _assert_bf16_ulp(out, ref, 1, (M, K, N))
        else:
            torch.testing.assert_close(out, ref, rtol=1e-5,
                                       atol=1e-5 * float(ref.abs().max()))


def test_int8_matmul_bf16_forms_and_plain_scope(dev):
    """fp32 x takes no bf16 output (TypeError); under plain_int8() a CUDA
    tensor launches nothing and gets the plain version's bits; the
    bf16 form's rows do not depend on the other rows of the call."""
    g = torch.Generator(device=dev).manual_seed(47)
    x = torch.randn(16, 2048, generator=g, device=dev).to(BF)
    w8, s = Q.quantize_weight(torch.randn(2048, 2048, generator=g,
                                          device=dev))
    with pytest.raises(TypeError):
        Q.int8_matmul(x.float(), w8, s, out_dtype=BF)
    before = Q.int8_matmul.launches
    with Q.plain_int8():
        plain = Q.int8_matmul(x, w8, s)
    assert Q.int8_matmul.launches == before
    assert torch.equal(plain, Q.int8_matmul_ref(x, w8, s))
    full = Q.int8_matmul(x, w8, s)
    for b in (0, 9, 15):
        assert torch.equal(full[b:b + 1], Q.int8_matmul(x[b:b + 1], w8, s))


@pytest.mark.parametrize("D", KV.SUPPORTED_HEAD_DIMS)
def test_attend_int8_kv_bf16_matches_plain(dev, D):
    """bf16 q (widened as it is loaded, the output rounded once): GQA
    groups 1, 4 and 8, S giving one key split and several (37 and 200 are
    not multiples of a split), a fully masked row (the uniform mean over
    all S), a row whose only valid keys sit in the last split, a key mask
    and per-query masks of W = 4 and 8 (also as (B, 1, W, S)): within one
    bf16 ulp of the plain version, one launch each, a repeat
    bit-identical."""
    g = torch.Generator(device=dev).manual_seed(53 + D)
    for G, S in itertools.product((1, 4, 8), (1, 37, 200, 592)):
        B, Hkv = 3, 2
        Hq = G * Hkv
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(BF)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(BF)
        cache = KV.quantize_cache([(k, v)])[0]
        slots = torch.arange(S, device=dev)[None]
        lens = torch.randint(1, S + 1, (B,), generator=g, device=dev)
        key = (slots < lens[:, None]).int()
        key[1] = 0
        key[2] = (slots[0] >= S - 3).int()
        masks = [(1, key), (1, None)]
        for W in (4, 8):
            upper = torch.randint(0, S, (B, W, 1), generator=g, device=dev)
            pq = (slots[None] <= upper).int()
            pq[0, 1] = 0
            masks += [(W, pq), (W, pq[:, None])]
        for W, mask in masks:
            q = torch.randn(B, W, Hq, D, generator=g, device=dev).to(BF)
            before = KV.attend_int8_kv.launches
            out = KV.attend_int8_kv(q, cache, mask)
            again = KV.attend_int8_kv(q, cache, mask)
            assert KV.attend_int8_kv.launches == before + 2
            ref = KV.attend_int8_kv_plain(q, cache, mask)
            torch.cuda.synchronize()
            assert torch.equal(out, again)
            _assert_bf16_ulp(out, ref, 1, (G, S, W, None if mask is None
                                           else tuple(mask.shape)))


@pytest.mark.parametrize("layout", ["tied_bf16", "int8"])
def test_lmhead_topk_bf16_exact_ties_across_tiles(dev, layout):
    """bf16 h (and the tied bf16 weight): integer inputs, exact in bf16,
    with runs of one logit across the tile and warp borders (ties), a
    ragged last tile, an all-banned row, penalised rows, batches of 1, 16
    and 17 rows, V = 128256 and D a multiple of the stage depth and D =
    104 (a multiple of 8, not of the depth): indices and values identical
    to a stable descending sort of the processed logits, a repeated call
    bit-identical."""
    g = torch.Generator(device=dev).manual_seed(61)
    plan = LT.lmhead_topk_plan(layout)
    assert 104 % plan["k_rows_per_stage"], plan
    for D, (B, V) in itertools.chain(
            itertools.product([4 * plan["k_rows_per_stage"]],
                              ((1, 1024), (16, 3000), (17, 2176),
                               (16, 128256))),
            itertools.product([104], ((16, 3000), (17, 128256)))):
        h, w, quant = _exact_head(dev, g, B, D, V,
                                  "int8" if layout == "int8" else "tied")
        _tie_runs(w, quant, V, plan["warp_cols"])
        h = h.to(BF)
        w = None if w is None else w.to(BF)
        mask = torch.randint(0, 4, (B, V), generator=g, device=dev).int()
        mask[0] = 2
        for m, pen in ((None, 1.0), (mask, 2.0)):
            before = LT.lmhead_topk.launches
            vals, idx = LT.lmhead_topk(h, w, m, penalty=pen, quant=quant)
            again = LT.lmhead_topk(h, w, m, penalty=pen, quant=quant)
            assert LT.lmhead_topk.launches == before + 2
            rv, ri = LT.lmhead_topk_plain(h, w, m, penalty=pen, quant=quant)
            torch.cuda.synchronize()
            assert torch.equal(idx, ri), (layout, D, B, V, pen)
            assert torch.equal(vals, rv), (layout, D, B, V, pen)
            assert torch.equal(again[0], vals) and torch.equal(again[1], idx)


def test_lmhead_topk_bf16_random_close(dev):
    """Random bf16 inputs at the decode shape (B 16, D 2048, V 128256),
    both bf16 forms: values within 1e-4 of the plain version (fp32 sums of
    exact products in two orders), nearly all indices equal; a tied fp32
    weight with bf16 h is refused on the card."""
    g = torch.Generator(device=dev).manual_seed(67)
    B, D, V = 16, 2048, 128256
    h = torch.randn(B, D, generator=g, device=dev).to(BF)
    w = (torch.randn(V, D, generator=g, device=dev) * 0.05).to(BF)
    w8, s = Q.quantize_weight(w, axis=1)
    for weight, quant in ((w, None), (None, (w8.t().contiguous(), s))):
        vals, idx = LT.lmhead_topk(h, weight, None, quant=quant)
        rv, ri = LT.lmhead_topk_plain(h, weight, None, quant=quant)
        torch.cuda.synchronize()
        torch.testing.assert_close(vals, rv, **TOL)
        assert (idx == ri).float().mean() > 0.99
    with pytest.raises(TypeError):
        LT.lmhead_topk(h, w.float(), None)


# the four forms: (h's dtype, tied weight or the int8 head)
HEAD_FORMS = {"int8": (torch.float32, False), "int8_bf16_h": (BF, False),
              "tied_fp32": (torch.float32, True), "tied_bf16": (BF, True)}


def _head_form_inputs(dev, g, form, B, D, V):
    """Integer inputs, exact in the form's types: h in [-3, 3], a tied
    weight in [-2, 2] or an int8 head in [-4, 4] with power-of-two
    scales."""
    hd, tied = HEAD_FORMS[form]
    h, w, quant = _exact_head(dev, g, B, D, V, "tied" if tied else "int8")
    return h.to(hd), None if w is None else w.to(hd), quant


def _head_case(dev, g, form, case):
    """[(h, w, quant, mask, penalty), ...] for one selection case."""
    hd, tied = HEAD_FORMS[form]
    D = 128
    if case == "all_equal":
        # every logit of a row equal: the 128 lowest indices, in order;
        # with every token banned, the same (the ban's -1e9 ties)
        h, w, quant = _head_form_inputs(dev, g, form, 3, D, 3000)
        h[:] = 1
        if tied:
            w[:] = 1
        else:
            quant[0][:] = 1
            quant[1][:] = 0.5
        mask = torch.full((3, 3000), 2, dtype=torch.int32, device=dev)
        return [(h, w, quant, None, 1.0), (h, w, quant, mask, 1.0)]
    if case == "few_unbanned":
        # rows with 0, 5, 127 and 128 unbanned tokens spread over the
        # tiles: those first, then the banned ones by index
        V = 5000
        h, w, quant = _head_form_inputs(dev, g, form, 4, D, V)
        mask = torch.full((4, V), 2, dtype=torch.int32, device=dev)
        for b, n in enumerate((0, 5, 127, 128)):
            keep = torch.randperm(V, generator=g, device=dev)[:n]
            mask[b, keep] = torch.randint(0, 2, (n,), generator=g,
                                          device=dev).int()
        return [(h, w, quant, mask, 2.0)]
    if case == "signed_zero":
        # -0.0 beside +0.0 (int8: zero columns times negative scales;
        # tied: zero weight rows against a negative h), with a few
        # positive and negative logits around them: one value
        h, w, quant = _head_form_inputs(dev, g, form, 2, D, 2048)
        h[:] = -1
        zero = torch.rand(2048, generator=g, device=dev) < 0.9
        if tied:
            w[zero] = 0
        else:
            quant[0][:, zero] = 0
            quant[1][zero & (torch.arange(2048, device=dev) % 2 == 0)] *= -1
        return [(h, w, quant, None, 1.0)]
    if case == "batch_1_17":
        out = []
        for B in (1, 17):
            h, w, quant = _head_form_inputs(dev, g, form, B, D, 3000)
            mask = torch.randint(0, 4, (B, 3000), generator=g,
                                 device=dev).int()
            out.append((h, w, quant, mask, 2.0))
        return out
    if case == "short_vocab":
        # V = 128: one tile of 128 columns; V = 1028: a tail tile of 4
        out = []
        for V in (128, 1028):
            h, w, quant = _head_form_inputs(dev, g, form, 5, D, V)
            mask = torch.randint(0, 4, (5, V), generator=g, device=dev).int()
            out += [(h, w, quant, None, 1.0), (h, w, quant, mask, 2.0)]
        return out
    assert case == "one_tile"
    # every row's top 128 inside one tile, row b's in tile b % 8: h[b, b %
    # 8] = 100 against a weight of 2 at position p in tile p's columns
    # (scales 1), the other positions' sums at most 240 in size
    B, V = 9, 8 * 1024
    h, w, quant = _head_form_inputs(dev, g, form, B, D, V)
    h[:, :8] = 0
    h[:, 8:] = h[:, 8:].clamp(-1, 1)
    for b in range(B):
        h[b, b % 8] = 100
    hot = 2 * (torch.arange(V, device=dev)[:, None] // 1024
               == torch.arange(8, device=dev)[None, :])
    if tied:
        w[:, :8] = hot.to(w.dtype)
    else:
        quant[0][:8] = hot.t().to(torch.int8)
        quant[1][:] = 1
    return [(h, w, quant, None, 1.0)]


@pytest.mark.parametrize("case", ["all_equal", "few_unbanned",
                                  "signed_zero", "batch_1_17",
                                  "short_vocab", "one_tile"])
@pytest.mark.parametrize("form", list(HEAD_FORMS))
def test_lmhead_topk_selection_cases(dev, form, case):
    """The selection's edge cases on each of the four forms, exact inputs:
    indices and values identical to a stable descending sort of the
    processed logits, a repeated call bit-identical, one counted launch a
    call."""
    g = torch.Generator(device=dev).manual_seed(
        71 + list(HEAD_FORMS).index(form))
    for h, w, quant, mask, pen in _head_case(dev, g, form, case):
        before = LT.lmhead_topk.launches
        vals, idx = LT.lmhead_topk(h, w, mask, penalty=pen, quant=quant)
        again = LT.lmhead_topk(h, w, mask, penalty=pen, quant=quant)
        assert LT.lmhead_topk.launches == before + 2
        rv, ri = LT.lmhead_topk_plain(h, w, mask, penalty=pen, quant=quant)
        torch.cuda.synchronize()
        where = (form, case, tuple(h.shape), pen)
        assert torch.equal(idx, ri), where
        assert torch.equal(vals, rv), where
        assert torch.equal(again[0], vals) and torch.equal(again[1], idx)
        if case == "all_equal":
            assert torch.equal(idx[0], torch.arange(
                128, device=dev, dtype=torch.int32)), where
        if case == "one_tile":
            rows = torch.arange(idx.shape[0], device=dev)[:, None]
            assert (idx // 1024 == rows % 8).all(), where


# ---------------------------------------------------------------------------
# The local shapes of the parallel layer (Llama-3.2-1B at TP 2 and DP 2)
# ---------------------------------------------------------------------------

TP2_INT8 = ((2048, 1024), (2048, 256), (2048, 4096), (1024, 2048),
            (4096, 2048))     # (K, N): q, k/v, gate/up, o, down at TP 2


@pytest.mark.parametrize("K,N", TP2_INT8)
def test_int8_matmul_tp2_shard_shapes(dev, K, N):
    """The int8 product at each TP 2 rank's projection shape, the decode
    batch M = 16: one counted launch, the plain version's values, a repeat
    bit-identical."""
    g = torch.Generator(device=dev).manual_seed(K + N)
    x = torch.randn(16, K, generator=g, device=dev)
    w8, s = Q.quantize_weight(torch.randn(K, N, generator=g, device=dev))
    before = Q.int8_matmul.launches
    out = Q.int8_matmul(x, w8, s)
    assert Q.int8_matmul.launches == before + 1
    ref = Q.int8_matmul_ref(x, w8, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(out, Q.int8_matmul(x, w8, s))


@pytest.mark.parametrize("case", ["tp2_prefill", "dp2_prefill",
                                  "tp2_decode", "pp_microbatch"])
def test_flash_parallel_shard_shapes(dev, case):
    """Flash at the parallel layer's local shapes: the Llama prefill with
    RoPE at 16/4 heads of 64 (TP 2, B 16), at 32/8 (DP 2, B 8) and at a
    pipeline microbatch's B 4 (batch 16 in 4 microbatches), 528 tokens,
    and the decode step at 16/4 over 592 slots."""
    g = torch.Generator(device=dev).manual_seed(len(case))
    B, Hq, Hkv = {"tp2_prefill": (16, 16, 4), "dp2_prefill": (8, 32, 8),
                  "tp2_decode": (16, 16, 4),
                  "pp_microbatch": (4, 32, 8)}[case]
    decode = case == "tp2_decode"
    q, k, v, mask, cs = _inputs(dev, g, B, 1 if decode else 528,
                                592 if decode else 528, Hq, Hkv, 64, "some",
                                not decode)
    kw = dict(q=q, k=k, v=v, mask=mask, is_causal=not decode, rope=cs)
    out = flash_attention(**kw)
    ref = flash_attention_plain(**kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **TOL)


def test_swiglu_matmul_tp2_shard(dev):
    """The SwiGLU down-projection of a TP 2 rank: (M, 4096) x (4096, 2048),
    the partial sum that the row-split reduce adds up."""
    g = torch.Generator(device=dev).manual_seed(4096)
    M = 16 * 528
    gate = torch.randn(M, 4096, generator=g, device=dev)
    up = torch.randn(M, 4096, generator=g, device=dev)
    w = torch.randn(4096, 2048, generator=g, device=dev) * 4096 ** -0.5
    out = FU.swiglu_matmul(gate, up, w)
    ref = FU.swiglu_matmul_plain(gate, up, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()))


def test_attend_int8_kv_tp2_shard(dev):
    """The int8-KV decode attention at a TP 2 rank's 16/4 heads of 64."""
    g = torch.Generator(device=dev).manual_seed(164)
    k = torch.randn(16, 592, 4, 64, generator=g, device=dev)
    v = torch.randn(16, 592, 4, 64, generator=g, device=dev)
    cache = KV.quantize_cache([(k, v)])[0]
    q = torch.randn(16, 1, 16, 64, generator=g, device=dev)
    lens = torch.randint(300, 592, (16, 1), generator=g, device=dev)
    mask = (torch.arange(592, device=dev)[None] < lens).int()
    out = KV.attend_int8_kv(q, cache, mask)
    ref = KV.attend_int8_kv_plain(q, cache, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **TOL)


def _tp_rank(rank, port, q):
    """One of two ranks on cuda:0 over gloo: a column-split LoRA projection,
    SiLU, a row-split one (``models.llama.LoRADense``), the output and the
    gradients of the input and of every weight against one process."""
    import torch.distributed as dist
    from tsue_tpu_torch.models.llama import LoRADense
    from tsue_tpu_torch.parallel import mesh as M
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    mesh = M.make_mesh(2, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(8, 64, generator=g, device=dev)

    def net(m):
        mid = 128 // (m.model if m is not None else 1)   # the rank's share
        col = LoRADense(64, mid, lora_r=4, split="col", mesh=m).to(dev)
        row = LoRADense(mid, 64, lora_r=4, split="row", mesh=m).to(dev)
        return col, row
    ref_col, ref_row = net(None)
    for p in list(ref_col.parameters()) + list(ref_row.parameters()):
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.1)
    names = {"col.kernel": (1, ref_col.kernel), "col.lora_a": (None,
             ref_col.lora_a), "col.lora_b": (1, ref_col.lora_b),
             "row.kernel": (0, ref_row.kernel), "row.lora_a": (0,
             ref_row.lora_a), "row.lora_b": (None, ref_row.lora_b)}
    col, row = net(mesh)
    for n, (dim, full) in names.items():
        mod = col if n.startswith("col") else row
        part = full if dim is None else full.chunk(2, dim)[rank]
        with torch.no_grad():
            getattr(mod, n.split(".")[1]).copy_(part)
    xr, xs = x.clone().requires_grad_(), x.clone().requires_grad_()
    ref = ref_row(torch.nn.functional.silu(ref_col(xr)))
    out = row(torch.nn.functional.silu(col(xs)))
    ref.square().sum().backward()
    out.square().sum().backward()
    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())
    errs = {"out": rel(out, ref), "x": rel(xs.grad, xr.grad)}
    for n, (dim, full) in names.items():
        mod = col if n.startswith("col") else row
        gr = getattr(mod, n.split(".")[1]).grad
        if dim is not None:
            gr = M.all_gather_cat(gr, mesh.model_group, dim)
        errs[n] = rel(gr, full.grad)
    try:    # a kind gloo does not run on CUDA tensors raises
        M._collective("all_to_all", mesh.model_group, x, lambda t: t)
        refused = False
    except RuntimeError:
        refused = True
    q.put((rank, errs, dict(M.COUNTS), refused))
    dist.destroy_process_group()


def test_tp_functions_gradients_gloo_on_cuda(dev):
    """Megatron's copy and reduce Functions on two ranks sharing the card
    over gloo: the output and every gradient equal one process's to 1e-5
    (relative to the largest), the input's gradient whole on both ranks
    (copy's backward all-reduces once, reduce's backward passes through);
    only the kinds gloo runs on CUDA tensors were issued, and another kind
    raises."""
    import socket
    import torch.multiprocessing as mp
    from tsue_tpu_torch.parallel import mesh as M
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_tp_rank, args=(r, port, q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        res = [q.get(timeout=180) for _ in procs]
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
    for rank, errs, counts, refused in res:
        assert all(v <= 1e-5 for v in errs.values()), (rank, errs)
        assert counts["all_reduce"] > 0, counts
        assert set(counts) <= M.GLOO_CUDA_OPS, counts
        assert refused


# ---------------------------------------------------------------------------
# Point-to-point transfers and the pipeline (parallel/mesh.py, pipeline.py)
# ---------------------------------------------------------------------------

def _spawn(target, n, *args, timeout=180):
    """Run ``target(rank, port, queue, *args)`` on ``n`` spawned ranks;
    returns what each put on the queue, by rank."""
    import socket
    import torch.multiprocessing as mp
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, port, q) + args)
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        res = dict(q.get(timeout=timeout) for _ in procs)
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
    return res


def _send_rank(rank, port, q, backend):
    """Rank 0 sends an fp32, a bf16 and an int64 CUDA tensor to rank 1,
    which sends the fp32 one back doubled, through ``parallel.mesh``'s
    ``isend``/``irecv`` (rank r on cuda:r under NCCL, both on cuda:0 under
    gloo)."""
    import torch.distributed as dist
    from tsue_tpu_torch.parallel import mesh as M
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    g = torch.Generator(device="cuda").manual_seed(0)
    sent = [torch.randn(4, 33, 7, generator=g, device=dev),
            torch.randn(300, generator=g, device=dev).bfloat16(),
            torch.randint(-2 ** 40, 2 ** 40, (17,), generator=g,
                          device=dev)]
    M.reset_counts()
    if rank == 0:
        works = [M.isend(t, 1) for t in sent]
        for w in works:
            w.wait()
        back = torch.empty_like(sent[0])
        M.irecv(back, 1).wait()
        ok = torch.equal(back, 2 * sent[0])
    else:
        got = [torch.empty_like(t) for t in sent]
        works = [M.irecv(t, 0) for t in got]
        for w in works:
            w.wait()
        ok = all(torch.equal(a, b) for a, b in zip(got, sent))
        M.isend(2 * got[0], 0).wait()
    torch.cuda.synchronize()
    q.put((rank, (ok, dict(M.COUNTS), [t.numel() * t.element_size()
                                       for t in sent])))
    dist.destroy_process_group()


def test_staged_send_gloo_on_cuda(dev):
    """Two ranks on cuda:0 over gloo (which cannot send a CUDA tensor):
    every transfer goes through a pinned host buffer, the values arrive
    exactly, and each is counted as staged with its bytes, none as
    direct."""
    res = _spawn(_send_rank, 2, "gloo")
    (ok0, c0, sizes), (ok1, c1, _) = res[0], res[1]
    assert ok0 and ok1
    assert c0 == {"send_staged": 3, "send_staged_bytes": sum(sizes),
                  "recv_staged": 1, "recv_staged_bytes": sizes[0]}, c0
    assert c1 == {"recv_staged": 3, "recv_staged_bytes": sum(sizes),
                  "send_staged": 1, "send_staged_bytes": sizes[0]}, c1


def test_direct_send_nccl(dev):
    """Under NCCL a CUDA tensor is sent directly (no staging).  NCCL refuses
    two ranks on one device (``ncclInvalidUsage``), so this needs two
    cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL refuses two ranks on one device: a NCCL send "
                    "needs two cards")
    res = _spawn(_send_rank, 2, "nccl")
    assert res[0][0] and res[1][0]
    assert res[0][1] == {"send": 3, "recv": 1}, res[0][1]
    assert res[1][1] == {"recv": 3, "send": 1}, res[1][1]


def _pipeline_rank(rank, port, q):
    """One stage of a 2-stage pipeline of a small MLLM on cuda:0 over gloo:
    the pipelined loss and its backward over 2 microbatches."""
    import torch.distributed as dist
    from tsue_tpu_torch.parallel import mesh as M
    from tsue_tpu_torch.parallel import pipeline as P
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    mesh = P.make_pipeline_mesh(2, dev)
    whole, batch = _pipeline_model(dev)
    stage = P.stage_of(whole, mesh)
    M.reset_counts()
    loss = P.pipelined_lm_loss(stage, mesh, batch, 2, backward=True)
    counts = dict(M.COUNTS)
    grads = {}
    for n, p in stage.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if P.layer_index(n) is None:
            # the outer part: each stage holds its share of the gradient
            # (the front-end on stage 0, the final norm and the tied head
            # on stage 1), summed over the two here
            dist.all_reduce(g, group=mesh.pipe_group)
        grads[n] = g.cpu().numpy()      # by value through the queue
    q.put((rank, (float(loss), grads, counts)))
    dist.destroy_process_group()


def _pipeline_model(dev):
    """A 4-layer MLLM 128 wide and a batch of 8 rows of 4 image + 60 text
    tokens, one row padded."""
    import dataclasses
    from tsue_tpu_torch.config import LlamaConfig, QFormerConfig
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    from tsue_tpu_torch.models.tsue import init_params
    llama = dataclasses.replace(LlamaConfig.tiny(256), hidden_size=128,
                                intermediate_size=256, num_layers=4,
                                head_dim=32, lora_dropout=0.0)
    qf = QFormerConfig(hidden_size=32, num_heads=2, num_encoder_layers=1,
                       num_decoder_layers=1, num_query_tokens=4, dropout=0.0)
    with torch.device(dev):
        m = MultiModalLLM(llama, qf)
    init_params(m, torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(3, 250, (8, 60), generator=g, device=dev)
    mask = torch.ones(8, 60, dtype=torch.int32, device=dev)
    mask[3, 40:] = 0
    labels = torch.where(mask > 0, ids, -100)
    labels[:, :10] = -100
    return m, dict(vision=torch.randn(8, 6, 512, generator=g, device=dev),
                   input_ids=ids, attention_mask=mask, labels=labels)


def test_pipeline_gloo_on_cuda(dev):
    """The pipelined LM loss on two ranks sharing the card over gloo: the
    loss and every gradient equal one process's to 1e-5 (relative to the
    tensor's largest): each stage's layers, and the outer part (the
    Q-Former, the projection, the modality embeddings, the tied
    embedding, the final norm) summed over the stages.  A key bias of the
    Q-Former's attention shifts each softmax row by a constant, so its
    gradient is zero in exact arithmetic and fp32 noise here: it is held
    to 1e-5 of the model's largest gradient.  The activations and their
    gradients are sent staged, 2 + 2 a rank of (4, 64, 128) fp32."""
    from tsue_tpu_torch.parallel import pipeline as P
    ref_model, batch = _pipeline_model(dev)
    ref = ref_model.lm_loss(batch["vision"], batch["input_ids"],
                            batch["attention_mask"], batch["labels"])
    ref.backward()
    ref_grads = {n: p.grad.cpu() for n, p in ref_model.named_parameters()}
    largest = max(float(g.abs().max()) for g in ref_grads.values())
    res = _spawn(_pipeline_rank, 2)
    act = 4 * 64 * 128 * 4
    for rank, (loss, grads, counts) in res.items():
        assert loss == pytest.approx(float(ref), rel=1e-5)
        outer = [n for n in ref_grads if P.layer_index(n) is None]
        assert outer and set(outer) <= set(grads), sorted(grads)
        for n, gr in grads.items():
            err = float((torch.from_numpy(gr) - ref_grads[n]).abs().max())
            scale = largest if n.endswith(".k.bias") else float(
                ref_grads[n].abs().max())
            assert err <= 1e-5 * scale + 1e-12, (n, err, scale)
        assert counts["send_staged"] == counts["recv_staged"] == 2, counts
        assert counts["send_staged_bytes"] == 2 * act, counts
        assert "send" not in counts and "recv" not in counts, counts


# the studies' mid-size stack (``cli._common.midsize_cfg``): Llama 8/4
# heads of 32, hidden 256, FFN 1024; Q-Former 8 heads of 16; 8 image
# tokens before the text (640 tokens, buckets 256, 384, 512)
STUDY_TOKENS = (8 + 256, 8 + 384, 8 + 512, 8 + 640)
STUDY_ROWS = 16 * (8 + 640)


def _study_flash_case(dev, g, case, T=8 + 640):
    """Flash's arguments at one of the studies' calls (B 16)."""
    B = 16
    if case == "llama_rope":            # training and eval, RoPE inside
        return _inputs(dev, g, B, T, T, 8, 4, 32, "some", True), True
    if case == "gen_prefill":           # the prefill, RoPE outside
        return _inputs(dev, g, B, T, T, 8, 4, 32, "some", False), True
    if case == "decode":                # a plain decode step, 744 slots
        return _inputs(dev, g, B, 1, T + 96, 8, 4, 32, "some", False), False
    if case == "window_w8":             # a speculative window, 752 slots
        q, k, v, _, _ = _inputs(dev, g, B, 8, T + 104, 8, 4, 32, "none",
                                False)
        return (q, k, v, _window_mask(dev, g, B, 8, T + 104, T), None), False
    if case == "ltsf_cross":            # the forecaster over the context
        return _inputs(dev, g, B, 18, T, 2, 2, 128, "some", False), False
    Tq, Tk = {"qformer_self": (18, 18), "qformer_query_self": (8, 8),
              "qformer_cross": (8, 18)}[case]
    return _inputs(dev, g, B, Tq, Tk, 8, 8, 16, "none", False), False


@pytest.mark.parametrize("case", [
    *(f"llama_rope_T{T}" for T in STUDY_TOKENS), "gen_prefill", "decode",
    "window_w8", "ltsf_cross", "qformer_self", "qformer_query_self",
    "qformer_cross"])
def test_flash_study_shapes(dev, case):
    """Flash at the studies' mid-size shapes: the Llama's self-attention
    at 8/4 heads of 32 with RoPE inside (causal, a key mask; 8 image
    tokens + each text bucket), which takes the tiled form (the JAX
    package folds it over heads, G * D = 64), the prefill without RoPE,
    a decode step and a window of 8 over the cache, the LTSF
    cross-attention at 2 heads of 128 over 648 keys and the Q-Former's
    three calls at 8 heads of 16: one launch each, within 1e-4 of the
    plain version, a repeat bit-identical."""
    name, _, T = case.partition("_T")
    g = torch.Generator(device=dev).manual_seed(len(case))
    (q, k, v, mask, cs), causal = _study_flash_case(
        dev, g, name, int(T) if T else 8 + 640)
    kw = dict(q=q, k=k, v=v, mask=mask, is_causal=causal, rope=cs)
    (B, Tq, Hq, D), (Tk, Hkv) = q.shape, k.shape[1:3]
    form = flash_attention_form(B, Tq, Tk, Hq, Hkv, D, cs is not None,
                                mask is not None and mask.dim() == 3,
                                q.dtype, k.dtype)
    if name == "llama_rope":
        assert form == "tiled", form
    before = flash_attention.launches
    out = flash_attention(**kw)
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(**kw)
    again = flash_attention(**kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **TOL,
                               msg=lambda m: f"{case} ({form}): {m}")
    assert torch.equal(out, again)


def test_rmsnorm_fp32_stream_study_shape(dev):
    """RMSNorm at the studies' (16 x 648, 256) fp32 rows: "fp32_stream",
    one warp a row of two 16-byte vectors a lane, within 1e-5 of the plain
    version, a repeat bit-identical, the first 2592 rows bit-identical to
    the call on them alone."""
    g = torch.Generator(device=dev).manual_seed(256)
    x = torch.randn(STUDY_ROWS, 256, generator=g, device=dev)
    scale = 1.0 + 0.1 * torch.randn(256, generator=g, device=dev)
    plan = FU.rmsnorm_plan(STUDY_ROWS, 256, torch.float32, torch.float32)
    assert (plan["form"], plan["warps_per_row"],
            plan["vectors_per_lane"]) == ("fp32_stream", 1, 2), plan
    before = FU.fused_rmsnorm.launches
    out = FU.fused_rmsnorm(x, scale, 1e-5)
    assert FU.fused_rmsnorm.launches == before + 1
    ref = FU.rmsnorm_plain(x, scale, 1e-5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    assert torch.equal(out, FU.fused_rmsnorm(x, scale, 1e-5))
    sub = STUDY_ROWS // 4
    assert torch.equal(out[:sub], FU.fused_rmsnorm(x[:sub], scale, 1e-5))


def test_swiglu_matmul_study_shape(dev):
    """The SwiGLU down-projection at the studies' (16 x 648, 1024) x (1024,
    256): its plan (81 row tiles of one column tile), one launch, rtol
    1e-4 and atol 1e-5 of the largest output against the plain version,
    a repeat bit-identical."""
    g = torch.Generator(device=dev).manual_seed(1024)
    M, K, N = STUDY_ROWS, 1024, 256
    plan = FU.swiglu_matmul_plan(M, K, N)
    assert plan["form"] == "tf32x3" and plan["tiles"] == \
        -(-M // plan["tile_m"]) * -(-N // plan["tile_n"])
    gate = torch.randn(M, K, generator=g, device=dev) * 3
    up = torch.randn(M, K, generator=g, device=dev)
    w = torch.randn(K, N, generator=g, device=dev) * K ** -0.5
    before = FU.swiglu_matmul.launches
    out = FU.swiglu_matmul(gate, up, w)
    assert FU.swiglu_matmul.launches == before + 1
    ref = FU.swiglu_matmul_plain(gate, up, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(out, FU.swiglu_matmul(gate, up, w))
