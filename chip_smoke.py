#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tsue_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: a CUDA device must be present; print its name and power limit
     as nvidia-smi gives them; TF32 off for fp32 products;
  2. build: compile the nine kernels in tsue_tpu_torch/csrc/ with nvcc, one
     process per source, all started together;
  3. kernels: each kernel against its plain PyTorch version at every shape
     of the paths below, with errors, CUDA-event times (L2 flushed before
     each launch), the least time the card could take (bound) and the time
     of one PyTorch library call computing the same function where there
     is one; NLinear, the fused LoRA product and the per-sample ADE/FDE,
     which no path of the JAX package calls, at the shapes where they
     would sit (their launches here are the only ones, and are reported
     under their own name); then the gradient of each autograd.Function
     (flash, RMSNorm, SwiGLU, NLinear, LoRA: kernel forward, backward by
     recompute) against autograd through the plain version;
  4. small configuration, on the card against the CPU (plain versions):
     Predictor.predict, greedy Predictor.generate_context with the three
     decode switches all on and all off (token ids equal), one train step
     in the frozen_mllm and lora_only regimes and one stage-1 step with
     the fused switch on and dropout 0 (loss and parameters equal within
     the CPU tests' tolerances), run_stage1 for one epoch on the card
     (export and generation dump), and run_stage2 for one epoch from that
     artifact;
  5. predict path at the full width of the repo's Llama-3.2-1B
     configuration ("test_18_18", bfloat16 weights, random weights from a
     seed) with K=10 candidates: warmup, three requests, a repeated
     request, the flash kernel's launch count, and one request with the
     fused switch on (RMSNorm and SwiGLU kernels) against the same request
     with it off;
  6. generation path at the same width: generate_context with int8 decode
     weights, the fused LM head and the int8 KV cache (batch 16, 64 new
     tokens, default sampling): warmup, three requests of 32 tracks, a
     repeated request whose ids must be equal, the launch count of each
     kernel against the expected count, a torch.profiler trace of one
     request for the device's busy share, and one greedy request with the
     three switches off;
  7. training at the same width (fp32, the fused switch on, random weights
     from a seed), for the presets "train_18_30" (frozen_mllm, batch 16)
     and "lora_only_18_18" (batch 8): the launch counts of one step's
     forward and of its backward (none), a warmup step and three timed
     steps (ms per step, train windows/s, peak memory, launch counts),
     frozen parameters bit-identical and trainable ones changed, a
     repeated step from the same state and seed bit-identical, and an
     eval step;
  8. stage-1 MLLM fine-tuning at the same width ("train_18_30": lora_only,
     batch 16, the Llama-3.2-1B vocabulary, the fused switch on): the launch
     counts of one step's forward and backward, a warmup step and three
     timed steps (ms per step, stage-1 train windows/s, supervised
     tokens/s, peak memory), a profiled step (idle share), a repeated step
     bit-identical, the same step with loss_chunk=128 (loss within rel
     1e-5 of the dense one, peak memory), and an eval step.
Every number is printed beside the nvidia-smi name and power limit.  The
line before the last is a JSON object with the kernels' numbers; the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

TOL = dict(atol=1e-4, rtol=1e-4)   # fp32 vs fp32, different summation order
PX_TOL = 1e-2                      # pixels, small-config predict vs the CPU
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet, at 700 W
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores, same sheet
BF16_FLOPS = 989e12                # bf16 tensor cores, dense, same sheet
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
    "rmsnorm": ("tsue_tpu_torch/csrc/rmsnorm.cu",
                "tsue_tpu/ops/fused.py:96 _rmsnorm_kernel"),
    "swiglu_matmul": ("tsue_tpu_torch/csrc/swiglu_matmul.cu",
                      "tsue_tpu/ops/fused.py:176 _swiglu_kernel"),
    "nlinear": ("tsue_tpu_torch/csrc/nlinear.cu",
                "tsue_tpu/ops/nlinear.py:31 _nlinear_kernel"),
    "lora_matmul": ("tsue_tpu_torch/csrc/lora_matmul.cu",
                    "tsue_tpu/ops/lora.py:32 _lora_kernel"),
    "ade_fde": ("tsue_tpu_torch/csrc/ade_fde.cu",
                "tsue_tpu/ops/metric_kernels.py:19 _ade_fde_kernel"),
}
# kernels no path of the JAX package calls (only its op API and its tests):
# they are driven by the kernel phase alone, and the port wires them into
# no path either
NO_PATH = ("nlinear", "lora_matmul", "ade_fde")
KERNEL_PHASE = "kernel phase (no caller in the JAX package)"
TRAIN_PRESETS = ("train_18_30", "lora_only_18_18")
TEXT_TOKENS = 512         # the synthetic prompts fill the 512-token bucket
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


def bound(nbytes: float, flops: float, rate: float = FP32_FLOPS):
    """(least ms, what sets it): bytes over the memory rate or flops over
    the peak rate of the inputs' type (fp32 unless given), whichever is
    larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
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


def fused_checks(dev, gpu, timer):
    """RMSNorm (M, 2048) and the SwiGLU down-projection (M, 8192) x (8192,
    2048) at M = B * (16 image + 512 text tokens): training at batch 16
    (also the predict chunk with the fused switch on) and at batch 8."""
    import torch
    import torch.nn.functional as F
    from tsue_tpu_torch.ops.fused import (fused_rmsnorm, rmsnorm_plain,
                                          swiglu_matmul, swiglu_matmul_plain)
    g = torch.Generator(device=dev).manual_seed(4)
    rows = {"rmsnorm": [], "swiglu_matmul": []}
    D, I = 2048, 8192
    for paths, B in (("train_18_30 b16 / predict b16", 16),
                     ("lora_only_18_18 b8", 8)):
        M = B * (16 + TEXT_TOKENS)
        x = torch.randn(M, D, generator=g, device=dev)
        scale = 1.0 + 0.1 * torch.randn(D, generator=g, device=dev)
        out = fused_rmsnorm(x, scale, 1e-5)
        ref = rmsnorm_plain(x, scale, 1e-5)
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        check(torch.allclose(out, ref, **TOL),
              f"rmsnorm disagrees with the plain version at M={M}: {err}")
        plain_ms = timer.ms(lambda: rmsnorm_plain(x, scale, 1e-5))
        ms = timer.ms(lambda: fused_rmsnorm(x, scale, 1e-5))
        lib_ms = timer.ms(lambda: F.rms_norm(x, (D,), scale, 1e-5))
        b = bound(nbytes(x, scale, out), 4.0 * M * D)
        rows["rmsnorm"].append(row("rmsnorm", f"{paths}: M={M} K={D}", gpu,
                                   err, rel, ms, plain_ms, b, lib_ms,
                                   batch=B))
        del x, out, ref
        gate = torch.randn(M, I, generator=g, device=dev)
        up = torch.randn(M, I, generator=g, device=dev)
        w = torch.randn(I, D, generator=g, device=dev) * I ** -0.5
        out = swiglu_matmul(gate, up, w)
        ref = swiglu_matmul_plain(gate, up, w)
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        # 8192 products summed in another order: the error scales with the
        # largest output
        atol = 1e-5 * ref.abs().max().item()
        check(torch.allclose(out, ref, rtol=1e-4, atol=atol),
              f"swiglu_matmul disagrees with the plain version at M={M}: "
              f"max abs err {err} (rtol 1e-4, atol {atol})")
        plain_ms = timer.ms(lambda: swiglu_matmul_plain(gate, up, w))
        ms = timer.ms(lambda: swiglu_matmul(gate, up, w))
        b = bound(nbytes(gate, up, w, out), 2.0 * M * D * I)
        rows["swiglu_matmul"].append(row(
            "swiglu_matmul", f"{paths}: M={M} K={I} N={D}", gpu, err, rel,
            ms, plain_ms, b, None, batch=B))
        del gate, up, w, out, ref
    torch.cuda.empty_cache()
    return rows


def nlinear_checks(dev, gpu, timer):
    """NLinear where it would sit in the LTSF (C = 64 channels): the
    deterministic forecast at batch 16 (18 -> 18 and 18 -> 30) and the K=10
    rollout's 160 rows.  No one PyTorch call computes it (the einsum alone
    omits the last-step subtract and add; its time is printed beside)."""
    import torch
    from tsue_tpu_torch.ops.nlinear import nlinear_fused, nlinear_ref
    g = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for B, Ti, To in ((16, 18, 18), (160, 18, 18), (16, 18, 30)):
        C = 64
        x = torch.randn(B, C, Ti, generator=g, device=dev)
        w = torch.randn(C, Ti, To, generator=g, device=dev) * Ti ** -0.5
        b = torch.randn(C, To, generator=g, device=dev) * 0.1
        out = nlinear_fused(x, w, b)
        ref = nlinear_ref(x, w, b)
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        check(torch.allclose(out, ref, **TOL),
              f"nlinear disagrees with the plain version at B={B} {Ti}->{To}"
              f": max abs err {err}")
        plain_ms = timer.ms(lambda: nlinear_ref(x, w, b))
        ms = timer.ms(lambda: nlinear_fused(x, w, b))
        einsum_ms = timer.ms(lambda: torch.einsum("bct,cto->bco", x, w))
        name = f"B={B} C={C} {Ti}->{To}"
        print(f"nlinear {name}: torch.einsum alone (no subtract/add, not the "
              f"same function) {einsum_ms:.4f} ms; gpu: {gpu}", flush=True)
        b_ = bound(nbytes(x, w, b, out), 2.0 * B * C * Ti * To)
        rows.append(row("nlinear", name, gpu, err, rel, ms, plain_ms, b_,
                        None, einsum_ms=einsum_ms))
    return rows


LORA_SHAPES = (   # (name, M, K, N): stage-1 batch 16, 16 + 512 tokens
    ("q_proj", 16 * (16 + TEXT_TOKENS), 2048, 2048),
    ("v_proj", 16 * (16 + TEXT_TOKENS), 2048, 512))


def lora_checks(dev, gpu, timer):
    """The fused LoRA product where it would sit in stage 1 (r = 8, scale
    32 / 8 = 4), fp32 and, at q_proj, bf16.  fp32: rtol 1e-4, atol 1e-5 of
    the largest output (K products summed in another order); bf16 (xA
    rounded to bf16 before the second product, as the Pallas kernel): rtol
    = atol = 2^-7 of the largest output, two bf16 ulps.  No one PyTorch
    call computes it; the cuBLAS time of x @ w alone, the floor any fused
    LoRA product competes with, is printed beside."""
    import torch
    from tsue_tpu_torch.ops.lora import lora_matmul, lora_ref
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []
    r, scale = 8, 4.0
    for (name, M, K, N), dtype in ((LORA_SHAPES[0], torch.float32),
                                   (LORA_SHAPES[1], torch.float32),
                                   (LORA_SHAPES[0], torch.bfloat16)):
        x = torch.randn(M, K, generator=g, device=dev).to(dtype)
        w = (torch.randn(K, N, generator=g, device=dev) * K ** -0.5).to(dtype)
        a = (torch.randn(K, r, generator=g, device=dev) * K ** -0.5).to(dtype)
        b = (torch.randn(r, N, generator=g, device=dev) * 0.1).to(dtype)
        out = lora_matmul(x, w, a, b, scale)
        ref = lora_ref(x, w, a, b, scale, round_xa=True)
        torch.cuda.synchronize()
        err, rel = errors(out.float(), ref.float())
        big = ref.float().abs().max().item()
        tol = (dict(rtol=1e-4, atol=1e-5 * big) if dtype == torch.float32
               else dict(rtol=2 ** -7, atol=2 ** -7 * big))
        label = f"{name} M={M} K={K} N={N} r={r} {str(dtype)[6:]}"
        check(torch.allclose(out.float(), ref.float(), **tol),
              f"lora_matmul disagrees with the plain version at {label}: "
              f"max abs err {err} ({tol})")
        check(torch.equal(out, lora_matmul(x, w, a, b, scale)),
              f"lora_matmul {label}: a repeated call differs")
        plain_ms = timer.ms(lambda: lora_ref(x, w, a, b, scale,
                                             round_xa=True))
        ms = timer.ms(lambda: lora_matmul(x, w, a, b, scale))
        base_ms = timer.ms(lambda: x @ w)
        print(f"lora_matmul {label}: cuBLAS x @ w alone {base_ms:.4f} ms; "
              f"gpu: {gpu}", flush=True)
        flops = 2.0 * M * N * K + 2.0 * M * K * r + 2.0 * M * r * N
        # bf16 inputs: the card's bound is the bf16 tensor-core rate, which
        # this fp32-FMA kernel does not use
        rate = FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS
        rows.append(row("lora_matmul", label, gpu, err, rel, ms, plain_ms,
                        bound(nbytes(x, w, a, b, out), flops, rate), None,
                        cublas_xw_ms=base_ms, dtype=str(dtype)[6:]))
        del x, w, a, b, out, ref
    torch.cuda.empty_cache()
    return rows


def ade_fde_checks(dev, gpu, timer):
    """Per-sample ADE/FDE at the evaluation's shapes: a batch of 16 at 18
    and 30 output steps, and the K=10 rollout's 160 candidate rows.  Against
    the plain version (the same arithmetic) atol = rtol = 1e-4; no one
    PyTorch call computes it."""
    import torch
    from tsue_tpu_torch.ops.metric_kernels import ade_fde_plain, fused_ade_fde
    g = torch.Generator(device=dev).manual_seed(8)
    rows = []
    for B, T in ((16, 18), (160, 18), (16, 30)):
        pred = torch.rand(B, 2, T, generator=g, device=dev)
        gt = torch.rand(B, 2, T, generator=g, device=dev)
        lo = torch.rand(B, 2, generator=g, device=dev) * 500
        hi = lo + 100 + torch.rand(B, 2, generator=g, device=dev) * 3000
        stat = torch.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], 1)
        out = fused_ade_fde(pred, gt, stat)
        ref = ade_fde_plain(pred, gt, stat)
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        check(torch.allclose(out, ref, **TOL),
              f"ade_fde disagrees with the plain version at B={B} T={T}: "
              f"max abs err {err}")
        plain_ms = timer.ms(lambda: ade_fde_plain(pred, gt, stat))
        ms = timer.ms(lambda: fused_ade_fde(pred, gt, stat))
        # per step: 2 differences, 2 scalings, 2 squares, 2 adds, a root
        rows.append(row("ade_fde", f"B={B} T={T}", gpu, err, rel, ms,
                        plain_ms, bound(nbytes(pred, gt, stat, out),
                                        9.0 * B * T), None))
    return rows


def function_grad_checks(dev):
    """Each kernel's autograd.Function on the card (kernel forward, backward
    by recompute through the plain version) against autograd through the
    plain version, at reduced shapes; the comparison's launches do not
    count for any path."""
    import torch
    from tsue_tpu_torch.models.llama import rope_inv_freq
    from tsue_tpu_torch.config import LlamaConfig
    from tsue_tpu_torch.ops.flash import flash_attention, flash_attention_plain
    from tsue_tpu_torch.ops.fused import (fused_rmsnorm, rmsnorm_plain,
                                          swiglu_matmul, swiglu_matmul_plain)
    from tsue_tpu_torch.ops.lora import lora_matmul, lora_ref
    from tsue_tpu_torch.ops.nlinear import nlinear_fused, nlinear_ref
    g = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s

    def grads(fn, inputs, cot):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        (fn(*leaves) * cot).sum().backward()
        return [t.grad for t in leaves]

    B, T = 2, 96
    mask = (torch.arange(T, device=dev)[None] < torch.tensor(
        [[T], [61]], device=dev)).int()
    ang = ((mask.cumsum(1) - 1).clamp_min(0).float()[..., None]
           * torch.as_tensor(rope_inv_freq(LlamaConfig()), device=dev))
    rope = (torch.cos(ang), torch.sin(ang))
    cases = {
        "flash_attn_fwd": (
            lambda q, k, v: flash_attention(q, k, v, mask, True, None, rope),
            lambda q, k, v: flash_attention_plain(q, k, v, mask, True, None,
                                                  rope),
            (randn(B, T, 32, 64), randn(B, T, 8, 64), randn(B, T, 8, 64)),
            randn(B, T, 32, 64)),
        "rmsnorm": (fused_rmsnorm,
                    lambda x, s: rmsnorm_plain(x, s, 1e-5),
                    (randn(256, 2048), 1.0 + randn(2048, s=0.1)),
                    randn(256, 2048)),
        "swiglu_matmul": (swiglu_matmul, swiglu_matmul_plain,
                          (randn(256, 1024), randn(256, 1024),
                           randn(1024, 256, s=0.03)), randn(256, 256)),
        "nlinear": (nlinear_fused, nlinear_ref,
                    (randn(16, 64, 18), randn(64, 18, 30, s=0.2),
                     randn(64, 30)), randn(16, 64, 30)),
        "lora_matmul": (lambda *t: lora_matmul(*t, 4.0),
                        lambda *t: lora_ref(*t, 4.0),
                        (randn(528, 2048), randn(2048, 512, s=0.02),
                         randn(2048, 8, s=0.02), randn(8, 512, s=0.1)),
                        randn(528, 512)),
    }
    out = {}
    for name, (fn, plain, inputs, cot) in cases.items():
        ours, ref = grads(fn, inputs, cot), grads(plain, inputs, cot)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(ours, ref))
        ok = all(torch.allclose(a, b, **TOL) for a, b in zip(ours, ref))
        print(f"function_grad {name}: {len(ours)} input gradients, max abs "
              f"err {err} against autograd through the plain version "
              f"(atol/rtol {TOL['atol']})", flush=True)
        check(ok, f"the {name} Function's gradient disagrees: {err}")
        out[name] = err
    return out


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


def small_train_cfg(regime: str, dropout: float = 0.0, batch: int = 4):
    """``small_cfg`` in fp32 for training: hidden 256 and intermediate 512
    reach the fused kernels (M = 4 * (16 + 96) = 448 rows)."""
    from tsue_tpu_torch.config import TrainConfig
    cfg = small_cfg()
    m = cfg.model
    return cfg.replace(
        name=f"smoke_train_{regime}",
        model=dataclasses.replace(
            m, dtype="float32",
            llama=dataclasses.replace(m.llama, lora_dropout=dropout),
            qformer=dataclasses.replace(m.qformer, dropout=dropout),
            lane=dataclasses.replace(m.lane, dropout=dropout),
            ltsf=dataclasses.replace(m.ltsf, dropout=dropout)),
        train=TrainConfig(batch_size=batch, freeze_regime=regime))


def small_training_phase(dev):
    """One train step per regime on the card against the CPU (same weights,
    batch and seed; the fused switch on, dropout 0) and one stage-1 step
    likewise, then run_stage1 for one epoch on the card (export and
    generation dump) and run_stage2 for one epoch from its artifact, with
    dropout live.  Tolerances are the CPU train
    tests' (tests/test_torch_train.py): loss rtol 1e-4; after the step, a
    parameter element within atol 2e-6, or 2 * lr where its gradient is
    below 1e-4 or 1e-3 of its tensor's largest, or is an attention key
    bias's (zero in exact arithmetic): the clipped gradients are near Adam's
    eps, where a step moves by up to lr / 4 times the gradient's relative
    error, and the two devices' errors scale with the tensor's largest
    gradient; frozen ones unchanged.
    The lane polygons go in in kilopixels: at random init raw pixel
    polygons saturate the lane attention, whose gradient is then rounding
    noise on any device."""
    import numpy as np
    import torch
    from tsue_tpu_torch.data import (BatchIterator, build_windows,
                                     get_tokenizer, make_synthetic_tracks)
    from tsue_tpu_torch.models.tsue import TrajectoryModel, init_params
    from tsue_tpu_torch.ops.fused import fused_scope
    from tsue_tpu_torch.runner import run_stage1, run_stage2, to_device
    from tsue_tpu_torch.train.losses import denorm_mse_loss
    from tsue_tpu_torch.train.trainer import (TrainState, make_optimizer,
                                              make_train_step)
    from tsue_tpu_torch.utils.random import step_generator

    tracks = make_synthetic_tracks(num_tracks=3, track_len=400, seed=4)
    for regime in ("frozen_mllm", "lora_only"):
        cfg = small_train_cfg(regime)
        L = cfg.model.llama.num_layers
        ds = build_windows(tracks, cfg.data, get_tokenizer())
        batch = next(iter(BatchIterator(ds, 4, seed=cfg.train.seed)))
        batch["polygon"] = batch["polygon"] / 1000.0
        base = TrajectoryModel(cfg.model, 18, 18)
        init_params(base, torch.Generator().manual_seed(1))
        start = base.state_dict()
        runs = []
        with fused_scope("on"):
            for d in ("cpu", dev):
                with torch.device(d):
                    model = TrajectoryModel(cfg.model, 18, 18)
                model.load_state_dict(start)
                state = TrainState(model, make_optimizer(cfg, model),
                                   cfg.train.seed)
                b = to_device(batch, d)
                grads = None
                if d == "cpu":       # the step's gradients, for conditioning
                    pred = model(b, deterministic=False,
                                 stop_llm_grad=regime == "frozen_mllm",
                                 generator=step_generator(cfg.train.seed, 0))
                    denorm_mse_loss(pred, b["traj_out"], b["norm_stat"],
                                    b["valid"]).backward()
                    grads = {n: p.grad.abs() for n, p in
                             model.named_parameters() if p.grad is not None}
                    state.optimizer.zero_grad()
                reset_counts()
                loss = float(make_train_step(cfg)(state, b)["loss"])
                counts = read_counts()
                runs.append((loss, {n: p.detach().cpu() for n, p in
                                    model.named_parameters()}, grads,
                             counts))
        (l_cpu, *_), (l_gpu, _, _, counts) = runs
        m = cfg.model       # dropout 0: every attention takes the kernel
        expected = {"flash_attn_fwd": L + m.lane.num_layers
                    + m.qformer.num_encoder_layers
                    + 2 * m.qformer.num_decoder_layers + 2,
                    "int8_matmul": 0, "lmhead_topk": 0, "attend_int8_kv": 0,
                    "rmsnorm": 2 * L + 1, "swiglu_matmul": L,
                    **dict.fromkeys(NO_PATH, 0)}
        check(counts == expected, f"small train {regime}: launches {counts} "
                                  f"!= {expected}")
        worst = step_parity(f"small train {regime}", start, runs,
                            cfg.train.lr)
        print(f"small_train {regime}: loss cuda {l_gpu} cpu {l_cpu}; "
              f"parameters after one step: max abs diff {worst} on "
              f"well-conditioned elements (tol 2e-6); launches "
              f"{json.dumps(counts)}", flush=True)

    small_stage1_step(dev)

    # run_stage1 for one epoch on the card (export + generation dump), then
    # run_stage2 for one epoch from its artifact, dropout live
    cfg = small_stage1_cfg(small_train_cfg("frozen_mllm", dropout=0.1,
                                           batch=8))
    out = Path(__file__).resolve().parent / "runs" / "chip_smoke"
    art = str(out / "stage1_mllm")
    t0 = time.time()
    with fused_scope("on"):
        s1 = run_stage1(cfg, out_dir=str(out), epochs=1, export_path=art,
                        synthetic_tracks=12, generation_dump="generated.txt",
                        device=dev)
    dump = out / f"stage1_{cfg.name}" / "generated.txt"
    check(math.isfinite(s1["final_lm_loss"]) and s1["final_lm_loss"] > 0
          and s1["generated"] > 0 and (Path(art) / "state.pt").exists()
          and dump.read_text().count("GENERATED:") == s1["generated"],
          f"run_stage1 on the card: {s1}")
    print(f"small run_stage1 on the card, 1 epoch: {json.dumps(s1)} in "
          f"{time.time() - t0:.1f}s; artifact {art}", flush=True)
    t0 = time.time()
    with fused_scope("on"):
        metrics = run_stage2(cfg, out_dir=str(out), mllm_ckpt=art, epochs=1,
                             eval_candidates=3, synthetic_tracks=12,
                             device=dev)
    check(set(metrics) == {"test_ade", "test_fde", "min_ade", "min_fde",
                           "min_rmse", "K"}
          and all(np.isfinite(v) for v in metrics.values()),
          f"run_stage2 on the card: {metrics}")
    print(f"small run_stage2(mllm_ckpt=<the stage-1 artifact>) on the card, "
          f"1 epoch: {json.dumps(metrics)} in {time.time() - t0:.1f}s",
          flush=True)


def step_parity(what, start, runs, lr):
    """One train step on the CPU and on the card from the same ``start``
    (runs: [(loss, parameters after, the CPU's first gradients, counts)]
    for the CPU, then the card): the losses within rtol 1e-4, frozen
    parameters unchanged, trainable ones within 2e-6 where well conditioned
    (see ``small_training_phase``).  Returns the largest such difference."""
    import torch
    (l_cpu, p_cpu, grads, _), (l_gpu, p_gpu, _, _) = runs
    check(abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu),
          f"{what}: loss {l_gpu} on the card, {l_cpu} on the CPU")
    worst = 0.0
    for n, before in start.items():
        a, c = p_gpu[n], p_cpu[n]
        if n not in grads:
            check(torch.equal(a, before) and torch.equal(c, before),
                  f"{what}: frozen {n} changed")
            continue
        gm = grads[n]
        small = (gm < 1e-4) | (gm < 1e-3 * gm.max())
        if n.endswith(".k.bias"):
            # zero in exact arithmetic (a shift common to all keys): both
            # sides step on rounding noise
            small[:] = True
        diff = (a - c).abs()
        check(bool((diff[~small] <= 2e-6).all())
              and bool((diff[small] <= 2 * lr).all()),
              f"{what}: {n} differs by {diff.max().item()}")
        if (~small).any():
            worst = max(worst, diff[~small].max().item())
    return worst


def small_stage1_cfg(cfg):
    """``cfg`` with 600 text tokens and no buckets: the byte tokenizer's
    prompts take ~430, so the answers (the stage-1 labels) survive."""
    return cfg.replace(data=dataclasses.replace(cfg.data, max_length=600,
                                                length_buckets=()))


def small_stage1_step(dev):
    """One stage-1 step (lora_only, the fused switch on, dropout 0) of the
    small MLLM on the card against the CPU, same weights, batch and seed,
    with the stage-2 steps' tolerances."""
    import torch
    from tsue_tpu_torch.data import (BatchIterator, build_windows,
                                     get_tokenizer, make_synthetic_tracks)
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    from tsue_tpu_torch.models.tsue import init_params
    from tsue_tpu_torch.ops.fused import fused_scope
    from tsue_tpu_torch.runner import to_device
    from tsue_tpu_torch.train.stage1 import (make_stage1_optimizer,
                                             make_stage1_train_step)
    from tsue_tpu_torch.train.trainer import TrainState
    from tsue_tpu_torch.utils.random import step_generator

    cfg = small_stage1_cfg(small_train_cfg("lora_only"))
    m = cfg.model
    L = m.llama.num_layers
    tracks = make_synthetic_tracks(num_tracks=3, track_len=400, seed=4)
    ds = build_windows(tracks, cfg.data, get_tokenizer())
    batch = next(iter(BatchIterator(ds, 4, seed=cfg.train.seed)))
    base = MultiModalLLM(m.llama, m.qformer)
    init_params(base, torch.Generator().manual_seed(2))
    start = base.state_dict()
    runs = []
    with fused_scope("on"):
        for d in ("cpu", dev):
            with torch.device(d):
                mllm = MultiModalLLM(m.llama, m.qformer)
            mllm.load_state_dict(start)
            state = TrainState(mllm, make_stage1_optimizer(cfg, mllm),
                               cfg.train.seed)
            b = to_device(batch, d)
            grads = None
            if d == "cpu":           # the step's gradients, for conditioning
                mllm.lm_loss(b["vision"], b["input_ids"], b["attention_mask"],
                             b["labels"]).backward()
                grads = {n: p.grad.abs() for n, p in mllm.named_parameters()
                         if p.grad is not None}
                state.optimizer.zero_grad()
            reset_counts()
            loss = float(make_stage1_train_step()(
                state, b, step_generator(0, 0, d))["lm_loss"])
            counts = read_counts()
            runs.append((loss, {n: p.detach().cpu() for n, p in
                                mllm.named_parameters()}, grads, counts))
    expected = dict(train_forward_launches(L), flash_attn_fwd=L
                    + m.qformer.num_encoder_layers
                    + 2 * m.qformer.num_decoder_layers)   # dropout 0
    counts = runs[1][3]
    check(counts == expected, f"small stage-1 step: launches {counts} != "
                              f"{expected}")
    check(runs[0][0] > 0, "small stage-1 step: no supervised token")
    worst = step_parity("small stage-1 step", start, runs, cfg.train.lr)
    print(f"small_stage1 lora_only: lm loss cuda {runs[1][0]} cpu "
          f"{runs[0][0]}; parameters after one step: max abs diff {worst} on "
          f"well-conditioned elements (tol 2e-6); launches "
          f"{json.dumps(counts)}", flush=True)


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

    # the first request again with the fused switch on: the context's Llama
    # (in _predict and in the rollout) takes the RMSNorm and SwiGLU kernels
    from tsue_tpu_torch.ops.fused import fused_scope
    L = m.llama.num_layers
    reset_counts()
    t0 = time.perf_counter()
    with fused_scope("on"):
        fused = pred.predict(tracks,
                             torch.Generator(device=dev).manual_seed(1))
    dt = time.perf_counter() - t0
    fused_counts = read_counts()
    c = math.ceil(len(fused) / B)
    expected = {"flash_attn_fwd": c * (per_predict + per_rollout),
                "int8_matmul": 0, "lmhead_topk": 0, "attend_int8_kv": 0,
                "rmsnorm": c * 2 * (2 * L + 1), "swiglu_matmul": c * 2 * L,
                **dict.fromkeys(NO_PATH, 0)}
    err = max(float(np.abs(a[key] - b[key]).max())
              for a, b in zip(out, fused)
              for key in ("pred_pixel_xy", "candidates_pixel_xy"))
    print(f"predict, fused switch on: {len(fused)} windows in {dt:.3f}s, "
          f"max abs diff {err} px from the same request with it off (tol "
          f"{PX_TOL}); launches {json.dumps(fused_counts)}; gpu: {gpu}",
          flush=True)
    check(len(fused) == len(out) and err <= PX_TOL,
          f"predict with the fused switch on differs by {err} px")
    check(fused_counts == expected, f"predict, fused on: launches "
                                    f"{fused_counts} != {expected}")
    del pred
    torch.cuda.empty_cache()
    return {"flash_attn_fwd": launches}, fused_counts


# --------------------------------------------------------------------------
# 6. generation path at full width
# --------------------------------------------------------------------------

def counters():
    from tsue_tpu_torch.ops.flash import flash_attention
    from tsue_tpu_torch.ops.fused import fused_rmsnorm, swiglu_matmul
    from tsue_tpu_torch.ops.kv_quant import attend_int8_kv
    from tsue_tpu_torch.ops.lmhead_topk import lmhead_topk
    from tsue_tpu_torch.ops.lora import lora_matmul
    from tsue_tpu_torch.ops.metric_kernels import fused_ade_fde
    from tsue_tpu_torch.ops.nlinear import nlinear_fused
    from tsue_tpu_torch.ops.quant import int8_matmul
    return {"flash_attn_fwd": flash_attention, "int8_matmul": int8_matmul,
            "lmhead_topk": lmhead_topk, "attend_int8_kv": attend_int8_kv,
            "rmsnorm": fused_rmsnorm, "swiglu_matmul": swiglu_matmul,
            "nlinear": nlinear_fused, "lora_matmul": lora_matmul,
            "ade_fde": fused_ade_fde}


def reset_counts():
    for f in counters().values():
        f.launches = 0


def read_counts():
    return {k: f.launches for k, f in counters().items()}


def profile_device(dev, gpu, what: str, wall_s: float, fn) -> None:
    """Run ``fn`` once under torch.profiler and print the device's busy
    time, its busy and idle shares against ``wall_s`` (the unprofiled wall
    time of the same work: the trace's own host cost stretches its wall
    time, so the share under the trace is printed beside it) and the ten
    kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        traced = time.perf_counter() - t0
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e6
    print(f"{what}: device busy {busy:.3f}s; unprofiled wall {wall_s:.3f}s "
          f"-> busy share {busy / wall_s:.3f}, idle share "
          f"{1 - busy / wall_s:.3f} (under the trace: wall {traced:.3f}s, "
          f"idle share {1 - busy / traced:.3f}); gpu: {gpu}", flush=True)
    for e in sorted(device, key=lambda e: e.self_device_time_total,
                    reverse=True)[:10]:
        print(f"  {e.key[:70]}: {e.self_device_time_total / 1e3:.3f} ms, "
              f"{e.count} calls", flush=True)


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
                "attend_int8_kv": steps * L, "rmsnorm": 0,
                "swiglu_matmul": 0, **dict.fromkeys(NO_PATH, 0)}
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
    tracks = make_synthetic_tracks(num_tracks=16, track_len=400, seed=7)
    profile_device(
        dev, gpu, f"generate profile: one chunk of 16 tracks, {N} decode "
        "steps", seconds / chunks3,
        lambda: pred.generate_context(tracks, max_new_tokens=N,
                                      generator=gen(7)))
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
               "int8_matmul": 0, "lmhead_topk": 0, "attend_int8_kv": 0,
               "rmsnorm": 0, "swiglu_matmul": 0,
               **dict.fromkeys(NO_PATH, 0)}
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


# --------------------------------------------------------------------------
# 7. training at full width
# --------------------------------------------------------------------------

def train_forward_launches(L: int):
    """Launches of one training forward of an L-layer Llama with the fused
    switch on: the Llama's attention (the Q-Former's drops, so it takes
    PyTorch ops), 2 L + 1 RMSNorms and L SwiGLU products."""
    return {"flash_attn_fwd": L, "int8_matmul": 0, "lmhead_topk": 0,
            "attend_int8_kv": 0, "rmsnorm": 2 * L + 1, "swiglu_matmul": L,
            **dict.fromkeys(NO_PATH, 0)}


def train_phase(dev, gpu, preset: str):
    """A stage-2 trainer of the preset at full Llama-3.2-1B width (fp32, the
    vocabulary of the preset, random weights from the preset's seed) with
    the fused switch on, through the port's entry points: ``make_optimizer``,
    ``make_train_step``, ``make_eval_step``."""
    import torch
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.data import (BatchIterator, build_windows,
                                     get_tokenizer, make_synthetic_tracks)
    from tsue_tpu_torch.models.tsue import TrajectoryModel, init_params
    from tsue_tpu_torch.ops.fused import fused_scope
    from tsue_tpu_torch.runner import to_device
    from tsue_tpu_torch.train.losses import denorm_mse_loss
    from tsue_tpu_torch.train.trainer import (TrainState, make_eval_step,
                                              make_optimizer,
                                              make_train_step)
    from tsue_tpu_torch.utils.random import step_generator

    cfg = get_preset(preset)
    m, regime, B = cfg.model, cfg.train.freeze_regime, cfg.train.batch_size
    L = m.llama.num_layers
    tracks = make_synthetic_tracks(num_tracks=8, track_len=600, seed=5)
    ds = build_windows(tracks, cfg.data, get_tokenizer())
    batches = [to_device(b, dev) for _, b in zip(range(6), BatchIterator(
        ds, B, seed=cfg.train.seed, length_buckets=cfg.data.length_buckets))]
    check(len(batches) == 6, f"{preset}: too few windows ({len(ds)})")
    T = m.qformer.num_query_tokens + batches[0]["input_ids"].shape[1]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    with torch.device(dev):
        model = TrajectoryModel(m, cfg.data.seq_len, cfg.data.out_len)
    init_params(model, torch.Generator(device=dev).manual_seed(
        cfg.train.seed))
    state = TrainState(model, make_optimizer(cfg, model), cfg.train.seed)
    train_step, eval_step = make_train_step(cfg), make_eval_step(cfg)
    params = dict(model.named_parameters())
    trainable = [n for n, p in params.items() if p.requires_grad]
    start = {n: p.detach().clone() for n, p in params.items()}
    n_train = sum(params[n].numel() for n in trainable)
    print(f"train {preset} ({regime}, batch {B}, {B} x {T} tokens, lr "
          f"{cfg.train.lr}): {sum(p.numel() for p in params.values()) / 1e9:.3f}"
          f"B params, {n_train / 1e6:.2f}M trainable; model + data "
          f"{time.time() - t0:.1f}s", flush=True)
    per_forward = train_forward_launches(L)
    with fused_scope("on"):
        # one step's forward and backward, counted apart
        reset_counts()
        b = batches[0]
        pred = model(b, deterministic=False,
                     stop_llm_grad=regime == "frozen_mllm",
                     generator=step_generator(cfg.train.seed, 0, dev))
        loss = denorm_mse_loss(pred, b["traj_out"], b["norm_stat"],
                               b["valid"])
        fwd = read_counts()
        loss.backward()
        torch.cuda.synchronize(dev)
        bwd = {k: v - fwd[k] for k, v in read_counts().items()}
        state.optimizer.zero_grad()
        del pred, loss
        print(f"train {preset}: launches in one step's forward "
              f"{json.dumps(fwd)}, in its backward {json.dumps(bwd)}",
              flush=True)
        check(fwd == per_forward, f"{preset}: forward launches {fwd} != "
                                  f"{per_forward}")
        check(not any(bwd.values()), f"{preset}: the backward launched {bwd}")

        train_step(state, batches[0])                     # warmup
        torch.cuda.synchronize(dev)
        reset_counts()
        times, losses = [], []
        for b in batches[1:4]:
            t0 = time.perf_counter()
            losses.append(float(train_step(state, b)["loss"]))
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        counts = read_counts()
        expected = {k: 3 * v for k, v in per_forward.items()}
        profile_device(dev, gpu, f"train {preset} profile: one step",
                       sum(times) / len(times),
                       lambda: train_step(state, batches[3]))
        check(counts == expected, f"{preset}: launches in 3 steps {counts} "
                                  f"!= {expected}")
        check(all(math.isfinite(x) for x in losses),
              f"{preset}: losses {losses}")
        # frozen parameters bit-identical; trainable ones changed, unless
        # no gradient above Adam's eps reached them (the lane attention's
        # q/k saturate on raw pixel polygons at random init), so that the
        # step and the decay lr * wd are below fp32 resolution
        adam = state.optimizer.adamw.state
        unreached = []
        for n, p in params.items():
            same = torch.equal(p.detach(), start[n])
            if n not in trainable:
                check(same, f"{preset}: frozen {n} changed")
            elif same:
                unreached.append(n)
                check(adam[p]["exp_avg"].abs().max().item() < 1e-8,
                      f"{preset}: trainable {n} got a gradient but did not "
                      "change")
        check(len(unreached) < len(trainable) // 2,
              f"{preset}: most trainable tensors did not change")
        del start

        # a repeated step from the same state and seed
        snap = {n: params[n].detach().clone() for n in trainable}
        opt_snap = copy.deepcopy(state.optimizer.state_dict())
        step0 = state.step
        train_step(state, batches[4])
        first = {n: params[n].detach().clone() for n in trainable}
        with torch.no_grad():
            for n in trainable:
                params[n].copy_(snap[n])
        state.optimizer.load_state_dict(opt_snap)
        state.step = step0
        train_step(state, batches[4])
        check(all(torch.equal(params[n], first[n]) for n in trainable),
              f"{preset}: a repeated step from the same state and seed "
              "differs")
        del snap, first, opt_snap

        reset_counts()
        ev = eval_step(state, batches[5])
        ev_counts = read_counts()
        ev_expected = dict(per_forward, flash_attn_fwd=L + m.lane.num_layers
                           + m.qformer.num_encoder_layers
                           + 2 * m.qformer.num_decoder_layers + 2)
        check(ev_counts == ev_expected, f"{preset}: eval launches "
                                        f"{ev_counts} != {ev_expected}")
        check(tuple(ev["pred"].shape) == (B, 2, cfg.data.out_len)
              and bool(torch.isfinite(ev["pred"]).all())
              and math.isfinite(float(ev["loss"])),
              f"{preset}: eval step output")
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    step_s = sum(times) / len(times)
    print(f"train {preset}: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms "
          f"per step = {B / step_s:.3f} train windows/s (batch {B}); losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; eval loss "
          f"{float(ev['loss']):.4f}; {len(trainable) - len(unreached)} of "
          f"{len(trainable)} trainable tensors changed (gradients below 1e-8: "
          f"{unreached}); repeated step bit-identical; peak memory "
          f"{peak:.2f} GiB; launches per step {json.dumps(per_forward)}; eval "
          f"launches {json.dumps(ev_counts)}; gpu: {gpu}", flush=True)
    del state, model, params, batches, ev
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# 8. stage-1 MLLM fine-tuning at full width
# --------------------------------------------------------------------------

def stage1_phase(dev, gpu):
    """Stage-1 steps of the preset "train_18_30" (its batch 16, lr 5e-4,
    fp32, the stage-1 default lora_only freeze, LoRA r 8 on q/v, the dense
    loss) at full Llama-3.2-1B width with its vocabulary (128256; the byte
    tokenizer's ids index it), random weights from the preset's seed, the
    fused switch on, through the port's entry points:
    ``make_stage1_optimizer``, ``make_stage1_train_step``,
    ``make_stage1_eval_step``.  ``run_stage1`` would resize the vocabulary
    to the tokenizer's; it runs at the small configuration."""
    import torch
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.data import (BatchIterator, build_windows,
                                     get_tokenizer, make_synthetic_tracks)
    from tsue_tpu_torch.models.fusion import IGNORE_LABEL, MultiModalLLM
    from tsue_tpu_torch.models.tsue import init_params
    from tsue_tpu_torch.ops.fused import fused_scope
    from tsue_tpu_torch.runner import to_device
    from tsue_tpu_torch.train.stage1 import (make_stage1_eval_step,
                                             make_stage1_optimizer,
                                             make_stage1_train_step)
    from tsue_tpu_torch.train.trainer import TrainState
    from tsue_tpu_torch.utils.random import step_generator

    cfg = get_preset("train_18_30")
    m, B = cfg.model, cfg.train.batch_size
    L = m.llama.num_layers
    tracks = make_synthetic_tracks(num_tracks=8, track_len=600, seed=5)
    ds = build_windows(tracks, cfg.data, get_tokenizer())
    batches = [to_device(b, dev) for _, b in zip(range(6), BatchIterator(
        ds, B, seed=cfg.train.seed, length_buckets=cfg.data.length_buckets))]
    check(len(batches) == 6, f"stage1: too few windows ({len(ds)})")
    T = m.qformer.num_query_tokens + batches[0]["input_ids"].shape[1]
    supervised = [int((b["labels"] != IGNORE_LABEL).sum()) for b in batches]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    with torch.device(dev):
        mllm = MultiModalLLM(m.llama, m.qformer, m.use_vision)
    init_params(mllm, torch.Generator(device=dev).manual_seed(cfg.train.seed))
    state = TrainState(mllm, make_stage1_optimizer(cfg, mllm), cfg.train.seed)
    train_step, eval_step = make_stage1_train_step(), make_stage1_eval_step()
    params = dict(mllm.named_parameters())
    trainable = [n for n, p in params.items() if p.requires_grad]
    n_train = sum(params[n].numel() for n in trainable)
    print(f"stage1 {cfg.name} (lora_only, batch {B}, {B} x {T} tokens, "
          f"{supervised[0]} supervised, lr {cfg.train.lr}, vocab "
          f"{m.llama.vocab_size}): "
          f"{sum(p.numel() for p in params.values()) / 1e9:.3f}B params, "
          f"{n_train / 1e6:.2f}M trainable; model + data "
          f"{time.time() - t0:.1f}s", flush=True)

    def gen(i):
        return step_generator(0, i, dev)

    per_forward = dict(train_forward_launches(L))
    with fused_scope("on"):
        # one step's forward and backward, counted apart
        reset_counts()
        b = batches[0]
        loss = mllm.lm_loss(b["vision"], b["input_ids"], b["attention_mask"],
                            b["labels"], deterministic=False,
                            generator=gen(0))
        fwd = read_counts()
        loss.backward()
        torch.cuda.synchronize(dev)
        bwd = {k: v - fwd[k] for k, v in read_counts().items()}
        state.optimizer.zero_grad()
        del loss
        print(f"stage1: launches in one step's forward {json.dumps(fwd)}, in "
              f"its backward {json.dumps(bwd)}", flush=True)
        check(fwd == per_forward, f"stage1: forward launches {fwd} != "
                                  f"{per_forward}")
        check(not any(bwd.values()), f"stage1: the backward launched {bwd}")

        start = {n: p.detach().clone() for n, p in params.items()
                 if not p.requires_grad}
        train_step(state, batches[0], gen(0))                 # warmup
        torch.cuda.synchronize(dev)
        reset_counts()
        times, losses = [], []
        for i, b in enumerate(batches[1:4], 1):
            t0 = time.perf_counter()
            losses.append(float(train_step(state, b, gen(i))["lm_loss"]))
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        counts = read_counts()
        expected = {k: 3 * v for k, v in per_forward.items()}
        check(counts == expected, f"stage1: launches in 3 steps {counts} != "
                                  f"{expected}")
        check(all(math.isfinite(x) and x > 0 for x in losses),
              f"stage1: losses {losses}")
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        step_s = sum(times) / len(times)
        profile_device(dev, gpu, "stage1 profile: one step", step_s,
                       lambda: train_step(state, batches[3], gen(3)))
        for n, before in start.items():
            check(torch.equal(params[n].detach(), before),
                  f"stage1: frozen {n} changed")
        moved = [n for n in trainable if n.endswith("lora_b")
                 and bool(params[n].detach().abs().max() > 0)]
        check(len(moved) == 2 * L, f"stage1: LoRA B moved in {moved}")
        del start

        # a repeated step from the same state and seed, then the same step
        # with the chunked loss
        snap = {n: params[n].detach().clone() for n in trainable}
        opt_snap = copy.deepcopy(state.optimizer.state_dict())

        def restore():
            with torch.no_grad():
                for n in trainable:
                    params[n].copy_(snap[n])
            state.optimizer.load_state_dict(opt_snap)

        torch.cuda.reset_peak_memory_stats(dev)
        dense_loss = float(train_step(state, batches[4], gen(4))["lm_loss"])
        dense_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        first = {n: params[n].detach().clone() for n in trainable}
        restore()
        again = float(train_step(state, batches[4], gen(4))["lm_loss"])
        check(again == dense_loss and all(torch.equal(params[n], first[n])
                                          for n in trainable),
              "stage1: a repeated step from the same state and seed differs")
        restore()
        llama = mllm.llama
        dense_cfg = llama.cfg
        llama.cfg = dataclasses.replace(dense_cfg, loss_chunk=128)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        chunk_loss = float(train_step(state, batches[4], gen(4))["lm_loss"])
        torch.cuda.synchronize(dev)
        chunk_s = time.perf_counter() - t0
        chunk_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        llama.cfg = dense_cfg
        rel = abs(chunk_loss - dense_loss) / abs(dense_loss)
        print(f"stage1: loss_chunk=128 step loss {chunk_loss} vs dense "
              f"{dense_loss} (rel {rel:.3e}, tol 1e-5) in {chunk_s * 1e3:.1f}"
              f" ms; peak memory {chunk_peak:.2f} GiB chunked vs "
              f"{dense_peak:.2f} GiB dense; gpu: {gpu}", flush=True)
        check(rel <= 1e-5, f"stage1: chunked loss {chunk_loss} vs dense "
                           f"{dense_loss}")
        del snap, first, opt_snap

        reset_counts()
        ev = float(eval_step(state, batches[5])["lm_loss"])
        ev_counts = read_counts()
        ev_expected = dict(per_forward, flash_attn_fwd=L
                           + m.qformer.num_encoder_layers
                           + 2 * m.qformer.num_decoder_layers)
        check(ev_counts == ev_expected, f"stage1: eval launches {ev_counts} "
                                        f"!= {ev_expected}")
        check(math.isfinite(ev), f"stage1: eval loss {ev}")
    tok_s = sum(supervised[1:4]) / sum(times)
    print(f"stage1 {cfg.name}: {', '.join(f'{t * 1e3:.1f}' for t in times)} "
          f"ms per step = {B / step_s:.3f} stage-1 train windows/s, "
          f"{tok_s:.1f} supervised tokens/s (batch {B}, {T} tokens, "
          f"{supervised[1:4]} supervised); losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; eval loss {ev:.4f}; "
          f"repeated step bit-identical; peak memory {peak:.2f} GiB (dense "
          f"loss); launches per step {json.dumps(per_forward)}; eval "
          f"launches {json.dumps(ev_counts)}; gpu: {gpu}", flush=True)
    del state, mllm, params, batches
    torch.cuda.empty_cache()
    return counts


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
            "attend_int8_kv": attend_checks(dev, gpu, timer),
            **fused_checks(dev, gpu, timer)}
    reset_counts()
    rows.update(nlinear=nlinear_checks(dev, gpu, timer),
                lora_matmul=lora_checks(dev, gpu, timer),
                ade_fde=ade_fde_checks(dev, gpu, timer))
    kernel_phase = {name: read_counts()[name] for name in NO_PATH}
    del timer
    grad_errs = function_grad_checks(dev)
    small_reference_phase(dev)
    small_training_phase(dev)
    cfg, state = full_width_state(dev)
    predict_counts, fused_predict_counts = predict_phase(dev, gpu, cfg,
                                                         state)
    gen_counts, off_counts = generation_phase(dev, gpu, cfg, state)
    del state
    torch.cuda.empty_cache()
    train_counts = {preset: train_phase(dev, gpu, preset)
                    for preset in TRAIN_PRESETS}
    stage1_counts = stage1_phase(dev, gpu)

    def head(name):
        """The kernel's line: its main-path shape (int8: the sum over one
        decoder layer's seven projections; the three kernels with no path:
        where they would sit, at batch 16)."""
        r = rows[name]
        if name == "flash_attn_fwd":
            pick = [r[0]]                      # Llama self-attention, RoPE
        elif name == "int8_matmul":
            pick = [x for x in r for _ in range(x["per_layer"])]
        elif name == "lmhead_topk":
            pick = [x for x in r if x["layout"] == "int8"
                    and not x["exact"]]
        elif name in ("rmsnorm", "swiglu_matmul", "nlinear", "lora_matmul",
                      "ade_fde"):
            pick = [r[0]]      # batch 16 (LoRA: q_proj, fp32)
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

    by_path = {name: {
        "predict": predict_counts.get(name, 0),
        "predict_fused": fused_predict_counts[name],
        "generate_all_switches": gen_counts[name],
        "generate_switches_off": off_counts[name],
        **{f"train {p} (3 steps)": train_counts[p][name]
           for p in TRAIN_PRESETS},
        "stage1 train_18_30 (3 steps)": stage1_counts[name]}
        for name in KERNELS}
    for name in KERNELS:
        if name in NO_PATH:
            # no driven path reaches them (none calls them in the JAX
            # package): their launches are the kernel phase's, named so
            check(not any(by_path[name].values()),
                  f"{name} was launched on a driven path: {by_path[name]}")
            check(kernel_phase[name] > 0, f"{name} was not launched in the "
                                          "kernel phase")
            by_path[name][KERNEL_PHASE] = kernel_phase[name]
        check(sum(by_path[name].values()) > 0,
              f"{name} was not launched on any driven path")
    check(predict_counts["flash_attn_fwd"] > 0,
          "flash_attn_fwd was not launched on the predict path")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": max(x["max_abs_err"] for x in rows[name]),
            **head(name), "gpu": gpu}
        if name in grad_errs:
            entry["grad_max_abs_err"] = grad_errs[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
