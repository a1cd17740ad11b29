#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tsue_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: a CUDA device must be present; print its name and power limit
     as nvidia-smi gives them; TF32 off for fp32 products;
  2. build: compile the four kernels in tsue_tpu_torch/csrc/ with nvcc, one
     process per source, all started together;
  3. kernels: each kernel against its plain PyTorch version at every shape
     of the paths below, with errors, CUDA-event times (L2 flushed before
     each launch), the least time the card could take (bound) and the time
     of one PyTorch library call computing the same function where there
     is one;
  4. small configuration, on the card against the CPU (plain versions):
     Predictor.predict, and greedy Predictor.generate_context with the
     three decode switches all on and all off (token ids equal);
  5. predict path at the full width of the repo's Llama-3.2-1B
     configuration ("test_18_18", bfloat16 weights, random weights from a
     seed) with K=10 candidates: warmup, three requests, a repeated
     request, and the flash kernel's launch count;
  6. generation path at the same width: generate_context with int8 decode
     weights, the fused LM head and the int8 KV cache (batch 16, 64 new
     tokens, default sampling): warmup, three requests of 32 tracks, a
     repeated request whose ids must be equal, the launch count of each
     kernel against the expected count, a torch.profiler trace of one
     request for the device's busy share, and one greedy request with the
     three switches off.
Every number is printed beside the nvidia-smi name and power limit.  The
line before the last is a JSON object with the kernels' numbers; the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

TOL = dict(atol=1e-4, rtol=1e-4)   # fp32 vs fp32, different summation order
PX_TOL = 1e-2                      # pixels, small-config predict vs the CPU
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet, at 700 W
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores, same sheet
KERNELS = {
    "flash_attn_fwd": (
        "tsue_tpu_torch/csrc/flash_attn_fwd.cu",
        "tsue_tpu/ops/flash.py:103 _gqa_rope_kernel; "
        "tsue_tpu/ops/flash.py:85 _gqa_kernel; "
        "tsue_tpu/ops/flash.py:128 _folded_kernel"),
    "int8_matmul": ("tsue_tpu_torch/csrc/int8_matmul.cu",
                    "tsue_tpu/ops/quant.py:96 _int8_kernel"),
    "lmhead_topk": ("tsue_tpu_torch/csrc/lmhead_topk.cu",
                    "tsue_tpu/ops/lmhead_topk.py:133 _head_topk_kernel"),
    "attend_int8_kv": ("tsue_tpu_torch/csrc/attend_int8_kv.cu",
                       "tsue_tpu/ops/kv_quant.py:147 _attend_kernel"),
}
GEN_NEW_TOKENS = 64


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def gpu_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip()


class Timer:
    """Median CUDA-event time of one call on the device.  Before each timed
    call a 128 MB buffer is written, so weights come from device memory as
    in a decode step, and the device sleeps for about a millisecond while
    the host enqueues the call, so the time is the device's and not the
    host's launch overhead."""

    def __init__(self, dev):
        import torch
        self.flush = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                                 device=dev)

    def ms(self, fn, reps: int = 15) -> float:
        import torch
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]


def bound(nbytes: float, flops: float):
    """(least ms, what sets it): bytes over the memory rate or fp32 flops
    over the fp32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def row(kernel, shape, gpu, err, rel, ms, plain_ms, b, library_ms=None,
        **extra):
    out = dict(kernel=kernel, shape=shape, max_abs_err=err,
               max_rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
               bound_by=b[1], library_ms=library_ms, gpu=gpu, **extra)
    print("kernel_check " + json.dumps(out), flush=True)
    return out


def errors(out, ref):
    err = (out - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


# --------------------------------------------------------------------------
# 3. kernel checks
# --------------------------------------------------------------------------

def attention_cases(dev):
    """(name, kwargs of flash_attention) at the shapes of the predict path
    (batch 16, text 512 tokens + 16 image tokens) and of generation (the
    no-RoPE causal prefill, the Q-Former over 64 frames, and the decode
    step over an fp32 cache of 592 slots)."""
    import numpy as np
    import torch
    from tsue_tpu_torch.config import LlamaConfig
    from tsue_tpu_torch.models.llama import rope_inv_freq

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def key_mask(B, T, lens):
        return (torch.arange(T, device=dev)[None, :]
                < torch.as_tensor(lens, device=dev)[:, None]).to(torch.int32)

    B, T, S = 16, 528, 592
    lens = np.linspace(200, T, B).astype(np.int64)
    llama_mask = key_mask(B, T, lens)
    pos = (llama_mask.cumsum(1) - 1).clamp_min(0).float()
    inv = torch.as_tensor(rope_inv_freq(LlamaConfig()), device=dev)
    ang = pos[..., None] * inv
    lane_lens = [0, 5, 64, 0, 12, 30, 0, 64, 1, 2, 40, 0, 64, 7, 9, 0]
    decode_mask = key_mask(B, S, lens + 1)
    return [
        ("llama_self", dict(
            q=randn(B, T, 32, 64), k=randn(B, T, 8, 64), v=randn(B, T, 8, 64),
            mask=llama_mask, is_causal=True,
            rope=(torch.cos(ang), torch.sin(ang)))),
        ("ltsf_cross", dict(
            q=randn(B, 18, 2, 1024), k=randn(B, T, 2, 1024),
            v=randn(B, T, 2, 1024), mask=llama_mask)),
        ("qformer_self", dict(
            q=randn(B, 18, 8, 96), k=randn(B, 18, 8, 96),
            v=randn(B, 18, 8, 96))),
        ("qformer_cross", dict(
            q=randn(B, 16, 8, 96), k=randn(B, 18, 8, 96),
            v=randn(B, 18, 8, 96))),
        ("lane_self", dict(
            q=randn(B, 64, 4, 16), k=randn(B, 64, 4, 16),
            v=randn(B, 64, 4, 16), mask=key_mask(B, 64, lane_lens))),
        ("ltsf_self", dict(
            q=randn(B, 18, 2, 32), k=randn(B, 18, 2, 32),
            v=randn(B, 18, 2, 32))),
        ("gen_prefill", dict(
            q=randn(B, T, 32, 64), k=randn(B, T, 8, 64), v=randn(B, T, 8, 64),
            mask=llama_mask, is_causal=True)),
        ("gen_qformer_self", dict(
            q=randn(B, 64, 8, 96), k=randn(B, 64, 8, 96),
            v=randn(B, 64, 8, 96))),
        ("gen_qformer_cross", dict(
            q=randn(B, 16, 8, 96), k=randn(B, 64, 8, 96),
            v=randn(B, 64, 8, 96))),
        ("gen_decode_fp32_cache", dict(
            q=randn(B, 1, 32, 64), k=randn(B, S, 8, 64), v=randn(B, S, 8, 64),
            mask=decode_mask)),
    ]


def attended(kw):
    """(B, Tq, Tk) bool: the (query, key) pairs the call attends."""
    import torch
    q, k, mask = kw["q"], kw["k"], kw.get("mask")
    B, Tq, Tk = q.shape[0], q.shape[1], k.shape[1]
    pairs = torch.ones(B, Tq, Tk, dtype=torch.bool, device=q.device)
    if mask is not None:
        pairs &= mask.bool()[:, None, :]
    if kw.get("is_causal"):
        pairs &= torch.ones(Tq, Tk, dtype=torch.bool,
                            device=q.device).tril(Tk - Tq)
    return pairs


def flash_checks(dev, gpu, timer):
    import torch
    import torch.nn.functional as F
    from tsue_tpu_torch.ops.flash import (flash_attention,
                                          flash_attention_plain, rope_bthd)
    rows = []
    for name, kw in attention_cases(dev):
        out = flash_attention(**kw)
        ref = flash_attention_plain(**kw)
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        ok = bool(torch.isfinite(out).all()) and torch.allclose(out, ref,
                                                                **TOL)
        plain_ms = timer.ms(lambda: flash_attention_plain(**kw))
        ms = timer.ms(lambda: flash_attention(**kw))
        plain_ms = min(plain_ms, timer.ms(lambda: flash_attention_plain(**kw)))
        # the library call: SDPA on (B, H, T, D) with the same boolean mask
        # (and RoPE applied before it, where the kernel applies it inside)
        q, k, v = kw["q"], kw["k"], kw["v"]
        if kw.get("rope") is not None:
            q, k = rope_bthd(q, *kw["rope"]), rope_bthd(k, *kw["rope"])
        pairs = attended(kw)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=pairs[:, None], enable_gqa=True)
        lib_ms = timer.ms(lib)
        D, Hq = kw["q"].shape[3], kw["q"].shape[2]
        flops = 4.0 * D * Hq * pairs.sum().item()
        extra = [kw.get("mask")] + list(kw.get("rope") or ())
        b = bound(nbytes(kw["q"], kw["k"], kw["v"], out, *extra), flops)
        rows.append(row("flash_attn_fwd", name, gpu, err, rel, ms, plain_ms,
                        b, lib_ms, q=list(kw["q"].shape),
                        k=list(kw["k"].shape)))
        check(ok, f"flash_attn_fwd disagrees with the plain version at "
                  f"{name}: max abs err {err} (atol/rtol {TOL})")
    return rows


INT8_SHAPES = (   # (name, K, N, projections of this shape per layer)
    ("q_proj/o_proj", 2048, 2048, 2), ("k_proj/v_proj", 2048, 512, 2),
    ("gate_proj/up_proj", 2048, 8192, 2), ("down_proj", 8192, 2048, 1),
    ("lm_head", 2048, 128256, 0))


def int8_checks(dev, gpu, timer):
    import torch
    from tsue_tpu_torch.ops.quant import (int8_matmul, int8_matmul_ref,
                                          quantize_weight)
    g = torch.Generator(device=dev).manual_seed(1)
    rows, M = [], 16
    for name, K, N, per_layer in INT8_SHAPES:
        x = torch.randn(M, K, generator=g, device=dev)
        w8, s = quantize_weight(torch.randn(K, N, generator=g, device=dev)
                                * K ** -0.5)
        out = int8_matmul(x, w8, s)
        ref = int8_matmul_ref(x, w8, s)
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        # K products summed in another order: the error scales with the
        # largest output
        atol = 1e-5 * ref.abs().max().item()
        ok = torch.allclose(out, ref, rtol=1e-4, atol=atol)
        plain_ms = timer.ms(lambda: int8_matmul_ref(x, w8, s))
        ms = timer.ms(lambda: int8_matmul(x, w8, s))
        b = bound(nbytes(x, w8, s, out), 2.0 * M * K * N)
        # the library call: PyTorch's weight-only int8 product, (x @ w.T) *
        # scale with w (N, K) int8; timed here only, the port never calls it
        wt = w8.t().contiguous()
        lib = lambda: torch._weight_int8pack_mm(x, wt, s)  # noqa: E731
        lib_ms, lib_note = None, None
        try:
            lib_err = errors(lib(), ref)[0]
        except (RuntimeError, ValueError, TypeError) as e:
            # the library may refuse fp32 x on the card
            lib_note = f"torch._weight_int8pack_mm refused: {e}"[:300]
        else:
            lib_ms = timer.ms(lib)
            lib_note = f"torch._weight_int8pack_mm, max abs err {lib_err}"
        del wt
        rows.append(row("int8_matmul", f"{name} M={M} K={K} N={N}", gpu, err,
                        rel, ms, plain_ms, b, lib_ms, per_layer=per_layer,
                        library=lib_note))
        check(ok, f"int8_matmul disagrees with the plain version at {name}: "
                  f"max abs err {err} (rtol 1e-4, atol {atol})")
    return rows


def head_inputs(dev, g, exact: bool):
    """hidden (16, 2048), tied fp32 weight (128256, 2048), int8 head and a
    token-state mask from a history with repeats (penalty and bans)."""
    import torch
    from tsue_tpu_torch.ops.lmhead_topk import token_state_mask
    from tsue_tpu_torch.ops.quant import quantize_weight
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    B, D, V = 16, 2048, 128256
    if exact:   # integer dot products: no summation order changes a logit
        h = torch.randint(-3, 4, (B, D), generator=g, device=dev).float()
        w = torch.randint(-2, 3, (V, D), generator=g, device=dev).float()
        w8 = torch.randint(-4, 5, (D, V), generator=g, device=dev).to(
            torch.int8)
        scale = 2.0 ** torch.randint(-3, 2, (V,), generator=g,
                                     device=dev).float()
    else:
        h = torch.randn(B, D, generator=g, device=dev)
        w = torch.randn(V, D, generator=g, device=dev) * D ** -0.5
        w8, scale = quantize_weight(w, axis=1)
        w8 = w8.t().contiguous()
    hist = torch.randint(0, 6, (B, 600), generator=g, device=dev)
    hist += torch.randint(0, V - 6, (B, 1), generator=g, device=dev)
    hlen = torch.randint(300, 600, (B,), generator=g, device=dev)
    mask = token_state_mask(hist, hlen, V, SamplingConfig())
    return h, w, (w8, scale), mask


def head_checks(dev, gpu, timer):
    import torch
    from tsue_tpu_torch.ops.lmhead_topk import (LANES, lmhead_topk,
                                                lmhead_topk_plain)
    g = torch.Generator(device=dev).manual_seed(2)
    penalty = 1.2
    rows = []
    for exact in (True, False):
        h, w, quant, mask = head_inputs(dev, g, exact)
        for layout in ("int8", "tied_fp32"):
            args = ((h, None, mask, penalty, quant) if layout == "int8"
                    else (h, w, mask, penalty, None))
            vals, idx = lmhead_topk(*args)
            rv, ri = lmhead_topk_plain(*args)
            torch.cuda.synchronize()
            err, rel = errors(vals, rv)
            name = f"{layout} {'exact' if exact else 'random'} B=16 V=128256"
            if exact:
                check(torch.equal(idx, ri) and torch.equal(vals, rv),
                      f"lmhead_topk {name}: indices or values differ from a "
                      "stable descending sort")
                check(any(len(torch.unique(r)) < LANES for r in rv),
                      f"lmhead_topk {name}: the case has no ties")
            else:
                check(torch.allclose(vals, rv, **TOL),
                      f"lmhead_topk {name}: max abs err {err}")
                # index sets equal apart from entries tied within TOL
                kth = rv[:, -1:]
                for b in range(idx.shape[0]):
                    diff = set(idx[b].tolist()) ^ set(ri[b].tolist())
                    if diff:
                        d = torch.tensor(sorted(diff), device=dev)
                        logits = (h[b] @ (quant[0].float() if layout ==
                                          "int8" else w.t()))
                        if layout == "int8":
                            logits = logits * quant[1]
                        m = mask[b]
                        pen = torch.where(logits > 0, logits / penalty,
                                          logits * penalty)
                        logits = torch.where((m & 1) != 0, pen, logits)
                        logits = logits.masked_fill((m & 2) != 0, -1e9)
                        gap = (logits[d] - kth[b]).abs().max().item()
                        check(gap <= TOL["atol"] + TOL["rtol"] *
                              kth[b].abs().item(),
                              f"lmhead_topk {name}: row {b} index sets "
                              f"differ beyond ties (gap {gap})")
            plain_ms = timer.ms(lambda: lmhead_topk_plain(*args))
            ms = timer.ms(lambda: lmhead_topk(*args))
            wbytes = nbytes(*quant) if layout == "int8" else nbytes(w)
            b = bound(wbytes + nbytes(h, mask, vals, idx),
                      2.0 * h.shape[0] * h.shape[1] * 128256)
            rows.append(row("lmhead_topk", name, gpu, err, rel, ms, plain_ms,
                            b, None, layout=layout, exact=exact))
        del h, w, quant, mask
    return rows


def attend_checks(dev, gpu, timer):
    import torch
    from tsue_tpu_torch.ops.kv_quant import (attend_int8_kv,
                                             attend_int8_kv_plain,
                                             quantize_cache)
    g = torch.Generator(device=dev).manual_seed(3)
    B, Hq, Hkv, D = 16, 32, 8, 64
    rows = []
    for S in (336, 464, 592):
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        cache = quantize_cache([(k, v)])[0]
        q = torch.randn(B, 1, Hq, D, generator=g, device=dev)
        prefix = torch.randint(S // 2, S - 64, (B,), generator=g, device=dev)
        step = 40
        s_idx = torch.arange(S, device=dev)[None, :]
        mask = ((s_idx < prefix[:, None])
                | ((s_idx >= S - 64) & (s_idx <= S - 64 + step))).int()
        out = attend_int8_kv(q, cache, mask)
        ref = attend_int8_kv_plain(q, cache, mask)
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        plain_ms = timer.ms(lambda: attend_int8_kv_plain(q, cache, mask))
        ms = timer.ms(lambda: attend_int8_kv(q, cache, mask))
        b = bound(nbytes(q, *cache, mask, out), 4.0 * B * Hq * S * D)
        rows.append(row("attend_int8_kv", f"S={S} B=16 32/8x64 Tq=1", gpu,
                        err, rel, ms, plain_ms, b, None))
        check(torch.allclose(out, ref, **TOL),
              f"attend_int8_kv disagrees with the plain version at S={S}: "
              f"max abs err {err}")
    return rows


# --------------------------------------------------------------------------
# 4. small configuration: the card against the CPU
# --------------------------------------------------------------------------

def small_cfg():
    from tsue_tpu_torch.config import (DataConfig, ExperimentConfig,
                                       LaneEncoderConfig, LlamaConfig,
                                       LTSFConfig, ModelConfig,
                                       QFormerConfig)
    return ExperimentConfig(
        name="smoke_small", data=DataConfig(seq_len=18, out_len=18,
                                            max_length=96),
        model=ModelConfig(
            llama=LlamaConfig(vocab_size=384, hidden_size=256,
                              intermediate_size=512, num_layers=2,
                              num_heads=8, num_kv_heads=2, head_dim=64),
            qformer=QFormerConfig(hidden_size=96, num_heads=1,
                                  num_encoder_layers=1, num_decoder_layers=1),
            lane=LaneEncoderConfig(d_model=64, nhead=4, num_layers=1),
            ltsf=LTSFConfig(), dtype="bfloat16"))


def small_reference_phase(dev):
    """The whole Predictor on a small configuration: CUDA (kernels) against
    the CPU (plain versions), same weights and tracks."""
    import numpy as np
    import torch
    from tsue_tpu_torch.data import make_synthetic_tracks
    from tsue_tpu_torch.models.tsue import TrajectoryModel, init_params
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    from tsue_tpu_torch.serve import Predictor

    cfg = small_cfg()
    model = TrajectoryModel(cfg.model, 18, 18)
    init_params(model, torch.Generator().manual_seed(1))
    state = model.state_dict()
    tracks = make_synthetic_tracks(num_tracks=3, track_len=400, seed=4)
    outs = [Predictor(cfg, state, batch_size=8, device=d).predict(tracks)
            for d in ("cpu", dev)]
    check(len(outs[0]) == len(outs[1]) > 0, "small predict: window counts")
    err = max(float(np.abs(a["pred_pixel_xy"] - b["pred_pixel_xy"]).max())
              for a, b in zip(*outs))
    print(f"small_reference: {len(outs[0])} windows, cuda vs cpu "
          f"pred_pixel_xy max abs err {err} px (tol {PX_TOL})", flush=True)
    check(err <= PX_TOL, f"small predict: cuda vs cpu differ by {err} px")

    greedy = SamplingConfig(do_sample=False)
    for flags in (dict(quantize_decode=True, fused_head=True,
                       quantize_kv=True), {}):
        ids = []
        for d in ("cpu", dev):
            p = Predictor(cfg, state, batch_size=4, device=d, **flags)
            p.generate_context(tracks, max_new_tokens=16, sampling=greedy)
            ids.append(p.last_request["ids"])
        same = np.array_equal(ids[0], ids[1])
        print(f"small_generation {sorted(flags) or 'all off'}: ids "
              f"{ids[1].shape}, cuda == cpu: {same}, "
              f"{len(np.unique(ids[1]))} distinct ids", flush=True)
        check(same, f"small greedy generation differs on the card ({flags})")


# --------------------------------------------------------------------------
# 5. predict path at full width
# --------------------------------------------------------------------------

def full_width_state(dev):
    import torch
    from tsue_tpu_torch.config import ModelConfig, get_preset
    from tsue_tpu_torch.models.tsue import TrajectoryModel, init_params
    cfg = get_preset("test_18_18").replace(model=ModelConfig(dtype="bfloat16"))
    m = cfg.model
    t0 = time.time()
    with torch.device(dev):
        model = TrajectoryModel(m, cfg.data.seq_len, cfg.data.out_len)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"full width: {cfg.name}, Llama {m.llama.num_layers}x"
          f"{m.llama.hidden_size} vocab {m.llama.vocab_size}, "
          f"{n_params / 1e9:.3f}B params, init {time.time() - t0:.1f}s",
          flush=True)
    return cfg, model.state_dict()


def predict_phase(dev, gpu, cfg, state):
    import numpy as np
    import torch
    from tsue_tpu_torch.data import make_synthetic_tracks
    from tsue_tpu_torch.ops.flash import flash_attention
    from tsue_tpu_torch.serve import Predictor

    K, B = 10, 16
    m = cfg.model
    # the attention calls one chunk makes: _predict runs every attention
    # through the kernel; the rollout's context does too, but its
    # forecaster attends under dropout in PyTorch ops
    per_predict = (m.lane.num_layers + m.qformer.num_encoder_layers
                   + 2 * m.qformer.num_decoder_layers + m.llama.num_layers
                   + 2)
    per_rollout = per_predict - 2
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    pred = Predictor(cfg, state, batch_size=B, num_candidates=K, device=dev)
    pred.warmup()
    print(f"predict: predictor + warmup {time.time() - t0:.1f}s", flush=True)
    flash_attention.launches = 0
    chunks = windows = 0
    seconds = 0.0
    first = None
    for seed in (1, 2, 3):
        tracks = make_synthetic_tracks(num_tracks=4, track_len=400, seed=seed)
        t0 = time.perf_counter()
        out = pred.predict(tracks,
                           torch.Generator(device=dev).manual_seed(seed))
        dt = time.perf_counter() - t0
        seconds += dt
        windows += len(out)
        chunks += math.ceil(len(out) / B)
        check(len(out) > 0, "predict returned no windows")
        for r in out:
            check(r["pred_pixel_xy"].shape == (2, 18), "pred shape")
            check(r["candidates_pixel_xy"].shape == (K, 2, 18), "cand shape")
            check(np.isfinite(r["pred_pixel_xy"]).all()
                  and np.isfinite(r["candidates_pixel_xy"]).all(),
                  "non-finite output")
            c = r["candidates_pixel_xy"]
            check(not np.allclose(c[0], c[1]), "candidates do not differ")
        print(f"predict request seed={seed}: {len(out)} windows in "
              f"{dt:.3f}s", flush=True)
        if first is None:
            first = (tracks, out)
    tracks, out = first
    again = pred.predict(tracks, torch.Generator(device=dev).manual_seed(1))
    chunks += math.ceil(len(again) / B)
    for a, b in zip(out, again):
        for key in ("pred_pixel_xy", "candidates_pixel_xy"):
            check(np.array_equal(a[key], b[key]),
                  f"repeated request differs in {key}")
    launches = flash_attention.launches
    expected = chunks * (per_predict + per_rollout)
    print(f"predict: {launches} flash launches over {chunks} chunks "
          f"(expected {expected} = {chunks} x ({per_predict} + "
          f"{per_rollout}))", flush=True)
    check(launches == expected, f"launches {launches} != {expected}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"predict: {windows} windows in {seconds:.3f}s = "
          f"{windows / seconds:.3f} windows/s, "
          f"{windows * K / seconds:.3f} candidate trajectories/s (K={K}, "
          f"batch {B}); peak memory {peak:.2f} GiB; gpu: {gpu}", flush=True)
    del pred
    torch.cuda.empty_cache()
    return {"flash_attn_fwd": launches}


# --------------------------------------------------------------------------
# 6. generation path at full width
# --------------------------------------------------------------------------

def counters():
    from tsue_tpu_torch.ops.flash import flash_attention
    from tsue_tpu_torch.ops.kv_quant import attend_int8_kv
    from tsue_tpu_torch.ops.lmhead_topk import lmhead_topk
    from tsue_tpu_torch.ops.quant import int8_matmul
    return {"flash_attn_fwd": flash_attention, "int8_matmul": int8_matmul,
            "lmhead_topk": lmhead_topk, "attend_int8_kv": attend_int8_kv}


def reset_counts():
    for f in counters().values():
        f.launches = 0


def read_counts():
    return {k: f.launches for k, f in counters().items()}


def request_stats(pred):
    """(chunks, executed decode steps, prefill s per chunk, decode ms per
    step) of the predictor's last request."""
    ch = pred.last_request["chunks"]
    steps = sum(c["steps"] for c in ch)
    prefill = [c["prefill_ms"] / 1e3 for c in ch]
    decode_ms = sum(c["decode_ms"] for c in ch) / max(steps, 1)
    return len(ch), steps, prefill, decode_ms


def generation_phase(dev, gpu, cfg, state):
    import numpy as np
    import torch
    from tsue_tpu_torch.data import make_synthetic_tracks
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    from tsue_tpu_torch.serve import Predictor

    B, N = 16, GEN_NEW_TOKENS
    m = cfg.model
    L = m.llama.num_layers
    qformer_calls = m.qformer.num_encoder_layers + \
        2 * m.qformer.num_decoder_layers

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    pred = Predictor(cfg, state, batch_size=B, quantize_decode=True,
                     fused_head=True, quantize_kv=True, device=dev)
    warm = make_synthetic_tracks(num_tracks=B, track_len=400, seed=100)
    pred.generate_context(warm, max_new_tokens=N, generator=gen(0))
    torch.cuda.synchronize(dev)
    print(f"generate: predictor + int8 tables + warmup "
          f"{time.time() - t0:.1f}s", flush=True)

    reset_counts()
    chunks = steps = 0
    seconds = 0.0
    first = None
    for seed in (1, 2, 3):
        tracks = make_synthetic_tracks(num_tracks=32, track_len=400, seed=seed)
        t0 = time.perf_counter()
        out = pred.generate_context(tracks, max_new_tokens=N,
                                    generator=gen(seed))
        dt = time.perf_counter() - t0
        c, s, prefill, step_ms = request_stats(pred)
        chunks, steps, seconds = chunks + c, steps + s, seconds + dt
        ids = pred.last_request["ids"]
        check(len(out) == 32 and ids.shape == (32, N), "generate: shapes")
        check(all(isinstance(r["context"], str) for r in out),
              "generate: text records")
        check(len(np.unique(ids)) > 32, "generate: degenerate ids")
        print(f"generate request seed={seed}: 32 tracks in {dt:.3f}s, "
              f"{c} chunks, {s} decode steps, prefill "
              f"{', '.join(f'{p:.4f}' for p in prefill)} s per chunk, "
              f"{step_ms:.3f} ms per decode step (device events), "
              f"{B * s / dt:.1f} generated tokens/s; gpu: {gpu}", flush=True)
        if first is None:
            first = (tracks, ids.copy())
    chunks3 = chunks
    tracks, ids = first
    pred.generate_context(tracks, max_new_tokens=N, generator=gen(1))
    c, s, _, _ = request_stats(pred)
    chunks, steps = chunks + c, steps + s
    check(np.array_equal(pred.last_request["ids"], ids),
          "generate: a repeated request with an equal generator differs")
    counts = read_counts()
    expected = {"flash_attn_fwd": chunks * (L + qformer_calls),
                "int8_matmul": steps * 7 * L, "lmhead_topk": steps,
                "attend_int8_kv": steps * L}
    print(f"generate: launches {json.dumps(counts)} over {chunks} chunks and "
          f"{steps} decode steps, expected {json.dumps(expected)}",
          flush=True)
    check(counts == expected, f"generate: launches {counts} != {expected}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"generate: 3 requests, {B * (steps - s)} generated tokens in "
          f"{seconds:.3f}s = {B * (steps - s) / seconds:.1f} tokens/s "
          f"(batch {B}, {N} new tokens, int8 weights + fused head + int8 "
          f"KV); peak memory {peak:.2f} GiB; gpu: {gpu}", flush=True)

    # the device's busy share: the kernels' device time in a torch.profiler
    # trace of one chunk (16 tracks), against the wall time of one chunk of
    # the unprofiled requests above; the trace's own host cost stretches
    # its wall time, so the share under the trace is printed beside it
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tracks = make_synthetic_tracks(num_tracks=16, track_len=400, seed=7)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.generate_context(tracks, max_new_tokens=N, generator=gen(7))
        torch.cuda.synchronize(dev)
        traced = time.perf_counter() - t0
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e6
    chunk_wall = seconds / chunks3
    print(f"generate profile: one chunk of 16 tracks, {N} decode steps: "
          f"device busy {busy:.3f}s; unprofiled chunk wall "
          f"{chunk_wall:.3f}s -> busy share {busy / chunk_wall:.3f}, idle "
          f"share {1 - busy / chunk_wall:.3f} (under the trace: wall "
          f"{traced:.3f}s, idle share {1 - busy / traced:.3f}); gpu: {gpu}",
          flush=True)
    for e in sorted(device, key=lambda e: e.self_device_time_total,
                    reverse=True)[:10]:
        print(f"  {e.key[:70]}: {e.self_device_time_total / 1e3:.3f} ms, "
              f"{e.count} calls", flush=True)
    del pred
    torch.cuda.empty_cache()

    # one greedy request with the three switches off
    plain = Predictor(cfg, state, batch_size=B, device=dev)
    tracks = make_synthetic_tracks(num_tracks=32, track_len=400, seed=1)
    reset_counts()
    t0 = time.perf_counter()
    out = plain.generate_context(tracks, max_new_tokens=N,
                                 sampling=SamplingConfig(do_sample=False))
    dt = time.perf_counter() - t0
    off = read_counts()
    c, s, prefill, step_ms = request_stats(plain)
    check(len(out) == 32 and len(np.unique(plain.last_request["ids"])) > 32,
          "generate (switches off): output")
    exp_off = {"flash_attn_fwd": c * (L + qformer_calls) + s * L,
               "int8_matmul": 0, "lmhead_topk": 0, "attend_int8_kv": 0}
    print(f"generate, switches off, greedy: 32 tracks in {dt:.3f}s, {s} "
          f"decode steps, prefill {', '.join(f'{p:.4f}' for p in prefill)} "
          f"s per chunk, {step_ms:.3f} ms per decode step, "
          f"{B * s / dt:.1f} tokens/s; launches {json.dumps(off)}; gpu: "
          f"{gpu}", flush=True)
    check(off == exp_off, f"generate (switches off): launches {off} != "
                          f"{exp_off}")
    del plain
    torch.cuda.empty_cache()
    return counts, off


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    gpu = gpu_line()
    print(gpu, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tsue_tpu_torch.ops._build import build_all
    t0 = time.time()
    libs = build_all(list(KERNELS))
    print(f"build: {', '.join(KERNELS)} in {time.time() - t0:.1f}s "
          "(one nvcc each, in parallel)", flush=True)
    for name, (_, report) in libs.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: " + line.strip(), flush=True)

    timer = Timer(dev)
    rows = {"flash_attn_fwd": flash_checks(dev, gpu, timer),
            "int8_matmul": int8_checks(dev, gpu, timer),
            "lmhead_topk": head_checks(dev, gpu, timer),
            "attend_int8_kv": attend_checks(dev, gpu, timer)}
    del timer
    small_reference_phase(dev)
    cfg, state = full_width_state(dev)
    predict_counts = predict_phase(dev, gpu, cfg, state)
    gen_counts, off_counts = generation_phase(dev, gpu, cfg, state)

    def head(name):
        """The kernel's line: its main-path shape (int8: the sum over one
        decoder layer's seven projections)."""
        r = rows[name]
        if name == "flash_attn_fwd":
            pick = [r[0]]                      # Llama self-attention, RoPE
        elif name == "int8_matmul":
            pick = [x for x in r for _ in range(x["per_layer"])]
        elif name == "lmhead_topk":
            pick = [x for x in r if x["layout"] == "int8"
                    and not x["exact"]]
        else:
            pick = [r[-1]]                     # S = 592
        out = {"ms": sum(x["ms"] for x in pick),
               "plain_ms": sum(x["plain_ms"] for x in pick),
               "bound_ms": sum(x["bound_ms"] for x in pick),
               "bound_by": max(pick, key=lambda x: x["bound_ms"])[
                   "bound_by"],
               "library_ms": (None if any(x["library_ms"] is None
                                          for x in pick)
                              else sum(x["library_ms"] for x in pick)),
               "shape": (pick[0]["shape"] if len(pick) == 1 else
                         "one decoder layer's 7 projections, M=16")}
        return out

    launches = {name: predict_counts.get(name, 0) + gen_counts[name]
                + off_counts[name] for name in KERNELS}
    for name in KERNELS:
        check(gen_counts[name] > 0,
              f"{name} was not launched on the generation path")
    check(predict_counts["flash_attn_fwd"] > 0,
          "flash_attn_fwd was not launched on the predict path")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": {
                "predict": predict_counts.get(name, 0),
                "generate_all_switches": gen_counts[name],
                "generate_switches_off": off_counts[name]},
            "max_abs_err": max(x["max_abs_err"] for x in rows[name]),
            **head(name), "gpu": gpu})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
