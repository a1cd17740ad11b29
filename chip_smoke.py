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
     is one; the two decode kernels also with their launch plans (K or key
     splits across a thread block cluster, CTAs) and a repeated call that
     must give the same bits, the int8 product also at M = 1 and 128; the
     fused head with each form's layout, a repeated call that must give
     the same bits and the unfused product's time beside its own (the
     int8 LM-head product, or cuBLAS fp32 for the tied form; the
     difference is the selection and merge); the SwiGLU down-projection
     with its launch plan, its share of the tolerance, a repeated call that
     must give the same bits and cuBLAS's fp32 h @ w alone beside;
     the bf16 forms at the training shapes of a bf16 model (flash: the
     Llama's and the Q-Former's self-attention on the bf16 tensor cores,
     the LTSF cross-attention's fp32 queries over bf16 keys and its
     all-bf16 twin (the wide form, its plan printed), a bf16 decode step;
     RMSNorm; SwiGLU as a TMA + wgmma pipeline, its drift against an
     fp64 product), against their plain versions, the form that ran, a
     repeat bit-identical, bounds at bf16's rate and bytes, SDPA /
     F.rms_norm / cuBLAS in bf16 beside;
     NLinear (with its launch plan), the fused LoRA product (fp32 and
     bf16 at q_proj and v_proj, and ranks 24 and 64 at q_proj, which take
     the SIMT form, each with its launch plan) and the
     per-sample ADE/FDE, which no path of the JAX package calls, at the
     shapes where they would sit (their launches here are the only ones,
     and are reported under their own name); the timer's launch floor (a
     one-element zero_) is printed as launch_floor_ms, is the bound of
     NLinear and ADE/FDE where it exceeds their roofline bound (both
     printed), and stands beside any other row whose roofline bound is
     below it; then the gradient of each autograd.Function
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
     request, the flash kernel's launch count, one request with the
     fused switch on (RMSNorm and SwiGLU kernels) against the same request
     with it off, and one request under torch.profiler;
  6. generation path at the same width: generate_context with int8 decode
     weights, the fused LM head and the int8 KV cache (batch 16, 64 new
     tokens, default sampling): warmup, three requests of 32 tracks, a
     repeated request whose ids must be equal, the launch count of each
     kernel against the expected count, a torch.profiler trace of one
     request for the device's busy share and the two decode kernels'
     device totals; the same with the fused head alone (fp32 weights and
     KV cache, the tied fp32 head: two requests, a repeated one, launch
     counts, the head's device time in a trace of one chunk); and one
     greedy request with the three switches off;
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
     1e-5 of the dense one, peak memory), and an eval step;
  9. eval from disk at the same width (preset "test_18_18": frozen_mllm,
     batch 16, 18->18, K=10; fp32, the vocabulary resized to the byte
     tokenizer's as run_stage2 resizes it, the fused switch on, synthetic
     tracks, a temporary out_dir removed afterwards): run_stage2 for 2
     epochs with a train state every epoch; an interrupted twin (1 epoch,
     then resume=True to 2) whose test metrics, best artifact and train
     state must be equal; run_stage2(epochs=0, restore_ckpt=<best>) in
     the fast and the parity mode, whose test_ade and test_fde must be
     equal (and the fast mode's K-candidate metrics), with the launch
     count of each kernel against the expected count (parity: K whole
     stochastic forwards a test batch, the Llama's flash attention in
     each, plus the deterministic forward); both modes' eval windows/s and
     peak memory on rebuild_for_eval's model (equal metrics again);
     Predictor.from_checkpoint against a Predictor over that model (bit
     for bit); a profiled parity candidate forward; the checkpoint files'
     sizes and the seconds to save and restore them;
 10. the serving entry points at the width of phase 6 (run right after it,
     over the same weights, one Predictor with int8 weights and the int8
     KV cache): the continuous batcher (16 slots, chunk 8, greedy) on 48
     tracks with caps from seed 0 in 8-64, every request at its cap,
     launches as the path implies, three requests alone in a pool of one
     slot and a sampled request alone and among 16 others with the same
     ids, tokens/s, ms per tick, mean live slots, admission prefill ms, a
     profiled run's idle share, and the static batcher on the same tracks
     for comparison; the small configuration's pool (greedy and sampled,
     int8 switches and the fp32 cache) on the card against the CPU; and
     the serve command's HTTP API (make_server, in threads on free ports):
     /healthz, /predict bit for bit against Predictor.predict, /generate
     through both batchers, a dropped track and an unknown path, each
     request's latency;
 11. speculative decoding at the width of phase 6 (over its weights, 16
     tracks, 64 new tokens): generate_context(speculative=True), greedy,
     window 8, with int8 weights and the int8 KV cache (ids equal to the
     plain greedy request's: every product on that path computes a row
     alone) and with fp32 weights and cache (the share of equal tokens
     printed: the fp32 products sum a window's rows in other orders), and
     the continuous batcher at window 4, sampled, on phase 10's 48 tracks
     against the same pool at window 1 (equal ids), then at window 4 with
     oracle drafts (equal ids in fewer ticks: the accept path, where rows
     advance several positions a tick); for each run the plain
     run's tokens/s beside its own, forwards per token, ms per window
     forward (CUDA events) and the launch counts against the expected
     table;
 12. bfloat16 training and remat at full width: "train_18_30" under a
     "bfloat16" ModelConfig (parameters cast to bf16, the fused switch on:
     the bf16 flash, RMSNorm and SwiGLU kernels), as phase 7 runs it
     without the profile, its windows/s and peak memory beside phase 7's
     fp32 numbers; "lora_only_18_18" without remat and under the policies
     "full", "dots" and "dots_no_batch" (LoRA dropout 0.1): one step's loss
     and gradients equal to the no-remat step's bit for bit, the kernels
     launched again in the backward's recompute, ms per step and peak
     memory; stage 1 of "train_18_30" under "full" (peak memory beside
     phase 8's); run_stage2 of "test_18_18" in bf16 for one epoch and a
     K=10 request through Predictor.from_checkpoint of its bf16 artifact
     (fp32 parameters, launches as a fp32 request's), bit for bit a
     Predictor over the merged state in fp32; the small
     configuration's per-epoch text sample (a bf16 MLLM's decode) twice,
     equal;
 13. the comparison models: (a) at their own widths on a small batch, the
     card against the CPU from the same weights: one train step of
     CS-LSTM, Social-LSTM, STGCNN (its running statistics too), MMTrans
     (dropout 0) and GAIL (D, then G), Trajectron's deterministic loss and
     gradients, the DDPM UNet's CFG forward and a reverse step; (b)
     run_baseline for all seven names (preset "ablation_no_llm", 6->30,
     batch 16, 2 epochs, no candidate plot: the card's machine has no
     matplotlib) with train windows/s, ms per step and eval windows/s and
     the launch counts (MMTrans: 4 flash launches a test batch), then the
     test pass timed alone at K = 0 and with K = 10 candidates
     (make_baseline_eval_fn: STGCNN's running statistics unchanged,
     MMTrans's dropout passes launching nothing); (c) the DDPM generator
     (preset "mllm_free_18_18": 32 UNet rows a step, 1000 timesteps):
     three epochs of train steps (ms per step, one flash launch a step),
     5 + 5 reverse chains of 1000 steps with the EMA weights (ms per
     reverse step, 1000 flash launches, peak memory), the chain repeated
     bit for bit, and the idle share of a profiled 50-step stretch;
 14. the bf16 quantised decode: the bf16 forms of the int8 product (bf16
     x at a decode step's seven projections, bf16 out, and at the LM head,
     fp32 out), of the int8-KV attention (bf16 q over the phase's 224-slot
     cache) and of the fused head (bf16 h over the int8 head and the tied
     bf16 embedding, exact and random inputs) against their plain
     versions, with times, bounds at bf16's rate and library times; then
     the quality_quant command (cli/quality_quant.main) at Llama-3.2-1B's
     widths with every parameter bf16 (batch 16, prompt 144, 64 new
     tokens, vocab 128256), the Llama's weights an HF-named bf16 state
     dict drawn from a seed and loaded by models.llama_loader
     .load_hf_llama: its JSON line, every drift finite, teacher-forced
     top-1 agreement >= 0.90 in each mode, its launches exactly as the
     code implies (113 int8 products and 16 int8-KV attentions a decode
     step of the arms that use them); the model rebuilt (greedy ids equal
     to the study's), and two greedy runs through the fused head's bf16
     forms, bf16 alone and with int8 weights + int8 KV, id for id equal to
     the unfused runs or each divergence a tie within 1e-3 reported; last
     the int8_w arm's teacher-forced rollout twice more, once through the
     kernel and once through the plain int8 product (ops.quant.plain_int8)
     on the same weights, both top-1 figures printed and held within one
     point of each other (the kernel's share of the int8 arms' gap);
 15. the parallel layer: two ranks on cuda:0 over gloo (NCCL refuses two
     ranks on one device): TP 2 serving at phase 5's width (prefill
     logits, greedy ids, a prediction, launches against one process's),
     a DP 2 and an FSDP step of "train_18_30" against one process, and
     run_stage2 of phase 4's small configuration under TP 2 interrupted
     after one epoch and resumed to two (test metrics and train state
     equal to the straight run's);
 16. the GPipe pipeline: two ranks on cuda:0 over gloo, pp 2 at the full
     width of "train_18_30" stage 1 (Llama-3.2-1B, lora_only, batch 16, 4
     microbatches of 4 rows, the fused switch on, every dropout 0, random
     weights from the preset's seed, phase 8's batches): a clip + SGD step
     against one process's (the loss within rel 1e-5 of the whole batch's
     step and of the step over the same 4 microbatches, whose gradients
     one process sums; the updates within 1e-5 of the largest against the
     latter, and against the whole batch's with the term of the Q-Former
     ReLU units that change sign between the whole batch's forward and
     the microbatches' removed: the units must lie within 1e-5 of zero,
     and the microbatches with the whole batch's ReLU masks must give the
     whole batch's updates within 1e-5; the whole batch's step with the
     fused switch off printed beside), the base Llama bit-identical and
     LoRA and the front-end moved, a repeated AdamW step bit-identical,
     the eval loss equal on both ranks, each rank's launches against the
     table the schedule implies, the staged sends (2 x 4 a step of (4,
     528, 2048) fp32 through pinned host buffers), ms per step and peak
     memory beside phase 8's, and the joined model (gathered on the host)
     exported by rank 0 (the one-process file), read back strictly in
     one process and equal bit for bit to each rank's own state;
 17. the reference's checkpoint migrated (run right after phase 5, over
     its state): the state exported to the reference's stage-2 layout
     (``convert.flax_params``, ``models.torch_export``) and written with
     torch.save, the import_ref command (--stage2 --preset test_18_18) on
     that file, every tensor of its artifact equal to the state,
     Predictor.from_checkpoint on it under phase 5's "bfloat16"
     configuration answering phase 5's first request bit for bit as phase
     5 answered it, with the fused switch off and on (launches as phase
     5's), the file's size, the reference key count and the export, save,
     import and load seconds; then export_ref -> import_ref of phase 4's
     small configuration, bit for bit;
 18. the trained-weight studies (last), through their commands' main at
     the mid-size configuration they publish (Llama 4 layers of 256, 8/4
     heads of 32, FFN 1024, vocabulary 384; Q-Former 128 wide, 8 heads of
     16, 2 + 2 layers, 8 query tokens), only epochs, seeds and repeats
     cut: study_fast_vs_parity (joint stage 2, 2 epochs on 40 tracks,
     the fused switch on, K=10 in both modes over 2 seeds: study.json's
     layout, finite metrics) and study_speculative_acceptance (stage 1, 3
     epochs on 20 tracks, one plain and one speculative W8 greedy call:
     the JAX script's keys; each row's window forwards between ceil(emitted
     / 8) and its emitted tokens), the launches of each run and its
     wall time.
Phase 3 also checks flash at the comparison models' shapes: MMTrans's
self-attention (B 16, 70 keys, 8 heads of 16, a key mask) and the UNet's
cross-attention over one key (B 32 and B 10, 18 queries, 1 head of 64),
their bound the larger of the roofline's and the timer's launch floor;
flash, RMSNorm and SwiGLU at phase 16's microbatch shapes (B 4: 2112
rows), reported under ``microbatch_shapes``; and at phase 18's study
shapes (B 16, 8 + 640 tokens: the Llama's 8/4 heads of 32 with RoPE in
the tiled form, the prefill, a decode step over 744 slots, a window of 8
over 752, the LTSF cross-attention at 2 heads of 128, the Q-Former's
three calls at 8 heads of 16; RMSNorm (10368, 256), SwiGLU (10368, 1024)
x (1024, 256)), reported under ``study_shapes``.
Every number is printed beside the nvidia-smi name and power limit.  The
line before the last is a JSON object with the kernels' numbers; the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

TOL = dict(atol=1e-4, rtol=1e-4)   # fp32 vs fp32, different summation order
PX_TOL = 1e-2                      # pixels, small-config predict vs the CPU
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet, at 700 W
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores, same sheet
BF16_FLOPS = 989e12                # bf16 tensor cores, dense, same sheet
TF32_FLOPS = 495e12                # TF32 tensor cores, dense, same sheet
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
# kernels whose work takes the card less than a launch: their bound is the
# larger of the roofline's and the timer's launch floor
FLOOR_BOUND = ("nlinear", "ade_fde")
# the same for these attention cases (the comparison models' shapes)
FLOOR_BOUND_CASES = ("mmtrans_self", "ddpm_cross_train", "ddpm_cross_sample")
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
    host's launch overhead.  ``floor_ms`` is this timer's time of a launch
    that does almost nothing (one-element ``zero_``): the least any one
    kernel launch takes on it."""

    def __init__(self, dev):
        import torch
        self.flush = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                                 device=dev)
        one = torch.zeros(1, device=dev)
        self.floor_ms = self.ms(lambda: one.zero_())

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
        floor_ms=None, floor_bound=False, **extra):
    """One kernel check's line.  ``b`` is (roofline bound, what sets it);
    the timer's launch floor ``floor_ms`` stands beside it where it is
    larger, and in the bound of the tiny kernels (``FLOOR_BOUND``) and of
    the rows asked for (``floor_bound``), as the larger of the two, with
    ``roofline_bound_ms`` beside."""
    if kernel in FLOOR_BOUND or floor_bound:
        extra.update(floor_ms=floor_ms, roofline_bound_ms=b[0],
                     roofline_bound_by=b[1])
        if floor_ms > b[0]:
            b = (floor_ms, "floor")
    elif floor_ms is not None and floor_ms > b[0]:
        extra["floor_ms"] = floor_ms
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
    (batch 16, text 512 tokens + 16 image tokens), of generation (the
    no-RoPE causal prefill, the Q-Former over 64 frames, and the decode
    step over an fp32 cache of 592 slots) and of the continuous batcher's
    admission (the prefill and the Q-Former at batch 1)."""
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

    def window(W):
        """A speculative window of W queries over the fp32 cache of
        P + 64 + W slots, each row at its own step (a (B, W, S) mask)."""
        Sw = T + GEN_NEW_TOKENS + W
        return dict(q=randn(B, W, 32, 64), k=randn(B, Sw, 8, 64),
                    v=randn(B, Sw, 8, 64),
                    mask=window_mask(dev, g, lens, T, W, Sw))
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
        # the continuous batcher's admission: one request's prefill
        ("admit_prefill", dict(
            q=randn(1, T, 32, 64), k=randn(1, T, 8, 64), v=randn(1, T, 8, 64),
            mask=llama_mask[-1:], is_causal=True)),
        ("admit_qformer_self", dict(
            q=randn(1, 64, 8, 96), k=randn(1, 64, 8, 96),
            v=randn(1, 64, 8, 96))),
        ("admit_qformer_cross", dict(
            q=randn(1, 16, 8, 96), k=randn(1, 64, 8, 96),
            v=randn(1, 64, 8, 96))),
        # speculative windows over the fp32 cache: greedy (W 8, the tiled
        # form) and sampled (W 4, the split-KV form)
        ("spec_window_w8", window(8)),
        ("spec_window_w4", window(4)),
        # the comparison models (phase 13): MMTrans's self-attention over 6
        # trajectory steps and 64 lane points, the lane's zero points masked;
        # the DDPM UNet's bottleneck cross-attention, 18 queries over its one
        # condition token, in training (B 32) and in sampling (B 10)
        ("mmtrans_self", dict(
            q=randn(B, 70, 8, 16), k=randn(B, 70, 8, 16),
            v=randn(B, 70, 8, 16),
            mask=key_mask(B, 70, [6 + n for n in lane_lens]))),
        ("ddpm_cross_train", dict(
            q=randn(32, 18, 1, 64), k=randn(32, 1, 1, 64),
            v=randn(32, 1, 1, 64))),
        ("ddpm_cross_sample", dict(
            q=randn(10, 18, 1, 64), k=randn(10, 1, 1, 64),
            v=randn(10, 1, 1, 64))),
    ]



def window_mask(dev, g, lens, P, W, S):
    """(B, W, S) int32: query j of row b sees its valid prefix (lens[b]
    of P slots) and the decode slots P .. P + step[b] + j, a step per row
    drawn from ``g``."""
    import torch
    B = len(lens)
    step = torch.randint(0, S - P - W + 1, (B,), generator=g, device=dev)
    k = torch.arange(S, device=dev)[None, None]
    upper = (P + step[:, None] + torch.arange(W, device=dev)[None])[..., None]
    valid = torch.as_tensor(lens, device=dev)[:, None, None]
    return ((k < valid) | ((k >= P) & (k <= upper))).to(torch.int32)


def attended(kw):
    """(B, Tq, Tk) bool: the (query, key) pairs the call attends."""
    import torch
    q, k, mask = kw["q"], kw["k"], kw.get("mask")
    B, Tq, Tk = q.shape[0], q.shape[1], k.shape[1]
    pairs = torch.ones(B, Tq, Tk, dtype=torch.bool, device=q.device)
    if mask is not None:
        pairs &= mask.bool()[:, None, :] if mask.dim() == 2 else mask.bool()
    if kw.get("is_causal"):
        pairs &= torch.ones(Tq, Tk, dtype=torch.bool,
                            device=q.device).tril(Tk - Tq)
    return pairs


def flash_checks(dev, gpu, timer, cases=None, **marks):
    """``cases`` (default ``attention_cases``); ``marks`` go on each row."""
    import torch
    import torch.nn.functional as F
    from tsue_tpu_torch.ops.flash import (_DT, _lib, flash_attention,
                                          flash_attention_form,
                                          flash_attention_plain, rope_bthd)
    rows = []
    for name, kw in (cases if cases is not None else attention_cases(dev)):
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
        (B, Tq, Hq, D), (Tk, Hkv) = kw["q"].shape, kw["k"].shape[1:3]
        mask = kw.get("mask")
        call = (B, Tq, Tk, Hq, Hkv, D, kw.get("rope") is not None,
                mask is not None and mask.dim() == 3)
        splits = _lib().flash_attn_splits(
            *call[:6], *map(int, call[6:]),
            _DT.get((kw["q"].dtype, kw["k"].dtype), 0))
        rows.append(row("flash_attn_fwd", name, gpu, err, rel, ms, plain_ms,
                        b, lib_ms, timer.floor_ms,
                        floor_bound=name in FLOOR_BOUND_CASES,
                        q=list(kw["q"].shape), k=list(kw["k"].shape),
                        mask=None if kw.get("mask") is None
                        else list(kw["mask"].shape),
                        form=flash_attention_form(*call, kw["q"].dtype,
                                                  kw["k"].dtype),
                        splits=splits, **marks))
        check(ok, f"flash_attn_fwd disagrees with the plain version at "
                  f"{name}: max abs err {err} (atol/rtol {TOL})")
    return rows


INT8_SHAPES = (   # (name, K, N, projections of this shape per layer)
    ("q_proj/o_proj", 2048, 2048, 2), ("k_proj/v_proj", 2048, 512, 2),
    ("gate_proj/up_proj", 2048, 8192, 2), ("down_proj", 8192, 2048, 1),
    ("lm_head", 2048, 128256, 0))


def int8_checks(dev, gpu, timer, cases=None, **marks):
    """Each projection shape at the decode batch M = 16 (with the library
    call's time), q_proj also at M = 1 and M = 128, the ends of the row
    range the kernel takes; each row with its launch plan and a second call
    that must give the same bits.  ``cases``: (name, K, N, per layer, M)
    in place of these; ``marks`` go on each row."""
    import torch
    from tsue_tpu_torch.ops.quant import (int8_matmul, int8_matmul_plan,
                                          int8_matmul_ref, quantize_weight)
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    if cases is None:
        cases = [(name, K, N, per_layer, 16)
                 for name, K, N, per_layer in INT8_SHAPES]
        cases += [("q_proj", 2048, 2048, 0, M) for M in (1, 128)]
    for name, K, N, per_layer, M in cases:
        x = torch.randn(M, K, generator=g, device=dev)
        w8, s = quantize_weight(torch.randn(K, N, generator=g, device=dev)
                                * K ** -0.5)
        out = int8_matmul(x, w8, s)
        again = int8_matmul(x, w8, s)
        ref = int8_matmul_ref(x, w8, s)
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        # K products summed in another order: the error scales with the
        # largest output
        atol = 1e-5 * ref.abs().max().item()
        ok = torch.allclose(out, ref, rtol=1e-4, atol=atol)
        plain_ms = timer.ms(lambda: int8_matmul_ref(x, w8, s))
        ms = timer.ms(lambda: int8_matmul(x, w8, s))
        # the kernel multiplies on the tensor cores in bf16: three terms of
        # x against each weight, exact products (csrc/int8_matmul.cu)
        b = bound(nbytes(x, w8, s, out), 3 * 2.0 * M * K * N, BF16_FLOPS)
        lib_ms, lib_note = None, None
        if M == 16:
            # the library call: PyTorch's weight-only int8 product, (x @
            # w.T) * scale with w (N, K) int8; timed here only, the port
            # never calls it
            wt = w8.t().contiguous()
            lib = lambda: torch._weight_int8pack_mm(x, wt, s)  # noqa: E731
            try:
                lib_err = errors(lib(), ref)[0]
            except (RuntimeError, ValueError, TypeError) as e:
                # the library may refuse fp32 x on the card
                lib_note = f"torch._weight_int8pack_mm refused: {e}"[:300]
            else:
                lib_ms = timer.ms(lib)
                lib_note = (f"torch._weight_int8pack_mm, max abs err "
                            f"{lib_err}")
            del wt
        rows.append(row("int8_matmul", f"{name} M={M} K={K} N={N}", gpu, err,
                        rel, ms, plain_ms, b, lib_ms, timer.floor_ms,
                        per_layer=per_layer,
                        library=lib_note, plan=int8_matmul_plan(M, K, N),
                        repeat_bit_identical=bool(torch.equal(out, again)),
                        **marks))
        check(ok, f"int8_matmul disagrees with the plain version at {name} "
                  f"M={M}: max abs err {err} (rtol 1e-4, atol {atol})")
        check(torch.equal(out, again), f"int8_matmul at {name} M={M}: a "
                                       "repeated call differs")
    return rows


def head_inputs(dev, g, exact: bool, B: int = 16):
    """hidden (B, 2048), tied fp32 weight (128256, 2048), int8 head and a
    token-state mask from a history with repeats (penalty and bans)."""
    import torch
    from tsue_tpu_torch.ops.lmhead_topk import token_state_mask
    from tsue_tpu_torch.ops.quant import quantize_weight
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    D, V = 2048, 128256
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


def head_split_ms(timer, args, split) -> dict:
    """The head form's product alone and its selection and merge alone on
    ``args``: the text variants ``split`` (head_variants.SPLIT, built by
    ``head_variants.split_libs``) swapped in under the wrapper for the
    timing only."""
    import tsue_tpu_torch.ops.lmhead_topk as LT
    own = LT._lib
    out = {}
    try:
        for name, lib in split.items():
            LT._lib = lambda lib=lib: lib    # noqa: E731
            out[name] = timer.ms(lambda: LT.lmhead_topk(*args))
    finally:
        LT._lib = own
    return {"product_ms": out["product_only"],
            "selection_and_merge_ms": out["select_only"]}


def head_checks(dev, gpu, timer, lm_head_ms, split, B=16,
                exacts=(True, False), **marks):
    """The fused head at the decode shape (B 16, V 128256), both fp32
    layouts, on exact inputs (indices and values identical to the plain
    version) and random ones (values within TOL, index sets equal apart
    from ties), each with a second call that must give the same bits.
    Beside each form: its product alone and its selection and merge alone
    (``head_split_ms``); the library call of the same function, timed only
    and never called by the port (tied: ``torch.topk(h @ w.t(), 128)`` in
    cuBLAS fp32 with TF32 off; int8: ``torch.topk((h @ w8f) * scale,
    128)`` with w8f the int8 head in fp32 beforehand); and the unfused
    product (int8: ``lm_head_ms``, int8_checks' lm_head row; tied: ``h @
    w.t()``).  ``B`` rows and ``exacts`` in place of 16 and both kinds
    of input (``lm_head_ms`` None: the unfused int8 product timed here);
    ``marks`` go on each row."""
    import torch
    from tsue_tpu_torch.ops.lmhead_topk import (LANES, lmhead_topk,
                                                lmhead_topk_plain,
                                                lmhead_topk_plan)
    from tsue_tpu_torch.ops.quant import int8_matmul
    g = torch.Generator(device=dev).manual_seed(2)
    penalty = 1.2
    rows = []
    for exact in exacts:
        h, w, quant, mask = head_inputs(dev, g, exact, B)
        for layout in ("int8", "tied_fp32"):
            args = ((h, None, mask, penalty, quant) if layout == "int8"
                    else (h, w, mask, penalty, None))
            vals, idx = lmhead_topk(*args)
            again = lmhead_topk(*args)
            rv, ri = lmhead_topk_plain(*args)
            torch.cuda.synchronize()
            err, rel = errors(vals, rv)
            name = (f"{layout} {'exact' if exact else 'random'} B={B} "
                    "V=128256")
            same = torch.equal(again[0], vals) and torch.equal(again[1], idx)
            check(same, f"lmhead_topk {name}: a repeated call differs")
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
            flops = 2.0 * h.shape[0] * h.shape[1] * 128256
            if layout == "int8":
                # the int8 form multiplies on the tensor cores in bf16:
                # three terms of h against each weight, exact products
                # (csrc/lmhead_topk.cu)
                b = bound(nbytes(*quant, h, mask, vals, idx), 3 * flops,
                          BF16_FLOPS)
                unfused_ms, unfused = lm_head_ms, ("unfused int8 LM-head "
                                                   "product (int8_matmul "
                                                   "lm_head row)")
                if unfused_ms is None:
                    unfused_ms = timer.ms(lambda: int8_matmul(
                        h, quant[0], quant[1]))
                w8f = quant[0].float()
                lib = lambda: torch.topk(  # noqa: E731
                    (h @ w8f) * quant[1], LANES)
                library = "torch.topk((h @ w8f) * scale), w8f fp32"
            else:
                # the tied form multiplies on the tensor cores in TF32:
                # three products of big and small terms (csrc/lmhead_topk.cu)
                b = bound(nbytes(w, h, mask, vals, idx), 3 * flops,
                          TF32_FLOPS)
                unfused_ms = timer.ms(lambda: h @ w.t())
                unfused = "unfused product h @ w.t() (cuBLAS fp32, TF32 off)"
                lib = lambda: torch.topk(h @ w.t(), LANES)  # noqa: E731
                library = "torch.topk(h @ w.t()), cuBLAS fp32, TF32 off"
            lib_ms = timer.ms(lib)
            parts = head_split_ms(timer, args, split)
            print(f"lmhead_topk {name}: {ms:.4f} ms (product alone "
                  f"{parts['product_ms']:.4f}, selection and merge alone "
                  f"{parts['selection_and_merge_ms']:.4f}); bound "
                  f"{b[0]:.4f} ms ({b[0] / ms:.0%}); library {lib_ms:.4f} "
                  f"ms ({library}); the {unfused}'s {unfused_ms:.4f} ms; "
                  f"plain {plain_ms:.4f} ms; gpu: {gpu}", flush=True)
            rows.append(row("lmhead_topk", name, gpu, err, rel, ms, plain_ms,
                            b, lib_ms, timer.floor_ms, layout=layout,
                            exact=exact, library=library,
                            repeat_bit_identical=same,
                            plan=lmhead_topk_plan(layout),
                            unfused_product_ms=unfused_ms, **parts, **marks))
        del h, w, quant, mask
    return rows


def attend_checks(dev, gpu, timer, cases=None, heads=(32, 8), **marks):
    """The decode step's int8-KV attention at the three cache lengths of
    generation (and at 592 slots with a decode step per row, the
    continuous batcher's tick), and a speculative window's (W 8 over 600
    slots, greedy; W 4 over 596, the sampled pool's) with its (B, W, S)
    per-query mask, each row with its launch plan, a second call that must
    give the same bits, and the library call's time: SDPA over the cache
    dequantised to fp32 beforehand (timed only, never called by the
    port).  ``cases`` (S, per-row steps, W) and ``heads`` (query, KV) in
    place of these; ``marks`` go on each row."""
    import torch
    import torch.nn.functional as F
    from tsue_tpu_torch.ops.kv_quant import (attend_int8_kv,
                                             attend_int8_kv_plain,
                                             attend_int8_kv_plan,
                                             dequantize_kv, quantize_cache)
    g = torch.Generator(device=dev).manual_seed(3)
    B, (Hq, Hkv), D = 16, heads, 64
    rows = []
    for S, per_row, W in (cases or (
            (336, False, 1), (464, False, 1), (592, True, 1), (600, True, 8),
            (596, True, 4), (592, False, 1))):
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
        cache = quantize_cache([(k, v)])[0]
        q = torch.randn(B, W, Hq, D, generator=g, device=dev)
        prefix = torch.randint(S // 2, S - 64, (B,), generator=g, device=dev)
        # the static path's rows share a step; the continuous batcher's
        # each have their own
        step = (torch.randint(0, 64, (B, 1), generator=g, device=dev)
                if per_row else 40)
        s_idx = torch.arange(S, device=dev)[None, :]
        if W > 1:
            mask = window_mask(dev, g, prefix.clamp_max(S - 64 - W).tolist(),
                               S - 64 - W, W, S)
        else:
            mask = ((s_idx < prefix[:, None])
                    | ((s_idx >= S - 64) & (s_idx <= S - 64 + step))).int()
        out = attend_int8_kv(q, cache, mask)
        again = attend_int8_kv(q, cache, mask)
        ref = attend_int8_kv_plain(q, cache, mask)
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        plain_ms = timer.ms(lambda: attend_int8_kv_plain(q, cache, mask))
        ms = timer.ms(lambda: attend_int8_kv(q, cache, mask))
        kd, vd = (dequantize_kv(x8, xs).transpose(1, 2)
                  for x8, xs in ((cache[0], cache[1]), (cache[2], cache[3])))
        qd = q.transpose(1, 2)
        amask = (mask.bool()[:, None, None, :] if mask.dim() == 2
                 else mask.bool()[:, None])
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=amask, enable_gqa=True))
        del kd, vd
        # the (query, key) pairs the call attends: a key mask's row sums
        # times W, a per-query mask's sum
        pairs = mask.bool().sum().item() * (W if mask.dim() == 2 else 1)
        b = bound(nbytes(q, *cache, mask, out), 4.0 * D * Hq * pairs)
        plan = attend_int8_kv_plan(S, Hq // Hkv, D)
        rows.append(row("attend_int8_kv", f"S={S} B=16 {Hq}/{Hkv}x64 Tq={W}"
                        + (" per-row steps" if per_row else "")
                        + (" (B, W, S) mask" if W > 1 else ""), gpu,
                        err, rel, ms, plain_ms, b, lib_ms, timer.floor_ms,
                        library="SDPA over the cache dequantised to fp32 "
                                "beforehand",
                        plan={**plan, "ctas": plan["splits"] * B * W * Hkv},
                        repeat_bit_identical=bool(torch.equal(out, again)),
                        **marks))
        check(torch.allclose(out, ref, **TOL),
              f"attend_int8_kv disagrees with the plain version at S={S}: "
              f"max abs err {err}")
        check(torch.equal(out, again), f"attend_int8_kv at S={S}: a "
                                       "repeated call differs")
    return rows


def fused_checks(dev, gpu, timer, cases=None, **marks):
    """RMSNorm (M, 2048) and the SwiGLU down-projection (M, 8192) x (8192,
    2048) at M = B * (16 image + 512 text tokens): training at batch 16
    (also the predict chunk with the fused switch on) and at batch 8.
    RMSNorm: the form "fp32_stream", within TOL of the plain version, a
    repeated call bit-identical and the first M / 4 rows (2112 of 8448)
    bit-identical to the call on those rows alone, ``F.rms_norm`` beside.
    SwiGLU: rtol 1e-4, atol 1e-5 of the largest output, ``tol_used`` the
    largest |out - ref| / (atol + rtol |ref|); its launch plan, a repeated
    call bit-identical, and the cuBLAS time of h @ w alone beside.
    ``cases``: (paths, B, FFN width, with RMSNorm[, tokens a row, model
    width]) in place of these (16 + 512 tokens and 2048 by default);
    ``marks`` go on each row."""
    import torch
    import torch.nn.functional as F
    from tsue_tpu_torch.ops.fused import (fused_rmsnorm, rmsnorm_plain,
                                          rmsnorm_plan, swiglu_matmul,
                                          swiglu_matmul_plain,
                                          swiglu_matmul_plan)
    g = torch.Generator(device=dev).manual_seed(4)
    rows = {"rmsnorm": [], "swiglu_matmul": []}
    for paths, B, I, norm, *width in (cases or (
            ("train_18_30 b16 / predict b16", 16, 8192, True),
            ("lora_only_18_18 b8", 8, 8192, True))):
        T, D = width or (16 + TEXT_TOKENS, 2048)
        M = B * T
        if not norm:
            x = out = ref = None
        else:
            x = torch.randn(M, D, generator=g, device=dev)
            scale = 1.0 + 0.1 * torch.randn(D, generator=g, device=dev)
            plan = rmsnorm_plan(M, D, x.dtype, scale.dtype)
            check(plan["form"] == "fp32_stream", f"rmsnorm M={M}: plan {plan}")
            out = fused_rmsnorm(x, scale, 1e-5)
            ref = rmsnorm_plain(x, scale, 1e-5)
            torch.cuda.synchronize()
            err, rel = errors(out, ref)
            check(torch.allclose(out, ref, **TOL),
                  f"rmsnorm disagrees with the plain version at M={M}: {err}")
            check(torch.equal(out, fused_rmsnorm(x, scale, 1e-5)),
                  f"rmsnorm M={M}: a repeated call differs")
            sub = M // 4
            check(torch.equal(out[:sub], fused_rmsnorm(x[:sub], scale, 1e-5)),
                  f"rmsnorm: the first {sub} of {M} rows differ from the call "
                  "on those rows alone")
            plain_ms = timer.ms(lambda: rmsnorm_plain(x, scale, 1e-5))
            ms = timer.ms(lambda: fused_rmsnorm(x, scale, 1e-5))
            lib_ms = timer.ms(lambda: F.rms_norm(x, (D,), scale, 1e-5))
            b = bound(nbytes(x, scale, out), 4.0 * M * D)
            rows["rmsnorm"].append(row("rmsnorm", f"{paths}: M={M} K={D}", gpu,
                                       err, rel, ms, plain_ms, b, lib_ms,
                                       timer.floor_ms, batch=B,
                                       form=plan["form"], plan=plan,
                                       repeat_bit_identical=True,
                                       rows_bit_identical_to=sub, **marks))
        del x, out, ref
        gate = torch.randn(M, I, generator=g, device=dev)
        up = torch.randn(M, I, generator=g, device=dev)
        w = torch.randn(I, D, generator=g, device=dev) * I ** -0.5
        plan = swiglu_matmul_plan(M, I, D)
        out = swiglu_matmul(gate, up, w)
        ref = swiglu_matmul_plain(gate, up, w)
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        # 8192 products summed in another order, on the tensor cores in
        # 3xTF32: the error scales with the largest output
        atol = 1e-5 * ref.abs().max().item()
        used = ((out - ref).abs() / (atol + 1e-4 * ref.abs())).max().item()
        label = f"M={M} K={I} N={D}"
        print(f"swiglu_matmul {label}: plan {json.dumps(plan)}, tol_used "
              f"{used:.4f}", flush=True)
        check(torch.allclose(out, ref, rtol=1e-4, atol=atol),
              f"swiglu_matmul disagrees with the plain version at M={M}: "
              f"max abs err {err} (rtol 1e-4, atol {atol})")
        check(torch.equal(out, swiglu_matmul(gate, up, w)),
              f"swiglu_matmul {label}: a repeated call differs")
        plain_ms = timer.ms(lambda: swiglu_matmul_plain(gate, up, w))
        ms = timer.ms(lambda: swiglu_matmul(gate, up, w))
        # the unfused product alone, h formed outside the timer: the floor
        # the fused kernel competes with (timed here only)
        h = F.silu(gate) * up
        hw_ms = timer.ms(lambda: h @ w)
        del h
        print(f"swiglu_matmul {label}: cuBLAS h @ w alone {hw_ms:.4f} ms; "
              f"gpu: {gpu}", flush=True)
        # the products run on the tensor cores as three TF32 products
        # each; the fp32 CUDA-core bound beside
        moved, flops = nbytes(gate, up, w, out), 2.0 * M * D * I
        b = bound(moved, 3 * flops, TF32_FLOPS)
        rows["swiglu_matmul"].append(row(
            "swiglu_matmul", f"{paths}: {label}", gpu, err, rel, ms,
            plain_ms, b, None, timer.floor_ms, batch=B, cublas_hw_ms=hw_ms,
            fp32_fma_bound_ms=bound(moved, flops)[0], plan=plan,
            tol_used=used, **marks))
        del gate, up, w, out, ref
    torch.cuda.empty_cache()
    return {k: v for k, v in rows.items() if v}


def llama_case(dev, g, B, Hq, Hkv):
    """Flash's arguments at the Llama's self-attention of B rows of 16
    image + 512 text tokens (row lengths 200..528, RoPE, causal) with Hq/Hkv
    heads of 64."""
    import numpy as np
    import torch
    from tsue_tpu_torch.config import LlamaConfig
    from tsue_tpu_torch.models.llama import rope_inv_freq
    T = 16 + TEXT_TOKENS
    inv = torch.as_tensor(rope_inv_freq(LlamaConfig()), device=dev)
    lens = torch.as_tensor(np.linspace(200, T, B).astype(np.int64),
                           device=dev)
    mask = (torch.arange(T, device=dev)[None] < lens[:, None]).int()
    ang = (mask.cumsum(1) - 1).clamp_min(0).float()[..., None] * inv

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    return dict(q=randn(B, T, Hq, 64), k=randn(B, T, Hkv, 64),
                v=randn(B, T, Hkv, 64), mask=mask, is_causal=True,
                rope=(torch.cos(ang), torch.sin(ang)))


def shard_shape_checks(dev, gpu, timer, head_split):
    """Phase 3 at the local shapes of phase 15's parallel paths, Llama-3.2-1B
    at TP 2 (heads, KV heads and FFN halved on each rank) and DP 2 (the
    batch halved): flash at 16/4 heads of 64 (B 16, 528 tokens, RoPE) and
    at 32/8 (B 8), its decode step at 16/4 over 592 slots; the int8
    product at each TP 2 projection (M 16); the int8-KV attention at 16/4;
    the SwiGLU down-projection at K 4096 (the TP 2 rank's partial sum
    before the reduce); the fused head at B 8 (DP 2: every rank holds the
    whole table).  Each row carries ``shard=True``; the main-path lines
    leave them out."""
    import torch
    g = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    S = 592

    def llama(B, Hq, Hkv):
        return llama_case(dev, g, B, Hq, Hkv)
    dmask = (torch.arange(S, device=dev)[None]
             < torch.randint(300, S, (16, 1), generator=g, device=dev)).int()
    flash = [("TP 2 llama_self 16/4x64 B16", llama(16, 16, 4)),
             ("DP 2 llama_self 32/8x64 B8", llama(8, 32, 8)),
             ("TP 2 gen_decode_fp32_cache 16/4x64 S592",
              dict(q=randn(16, 1, 16, 64), k=randn(16, S, 4, 64),
                   v=randn(16, S, 4, 64), mask=dmask))]
    out = {"flash_attn_fwd": flash_checks(dev, gpu, timer, flash,
                                          shard=True)}
    out["int8_matmul"] = int8_checks(dev, gpu, timer, [
        ("TP 2 q_proj", 2048, 1024, 0, 16),
        ("TP 2 k_proj/v_proj", 2048, 256, 0, 16),
        ("TP 2 gate_proj/up_proj", 2048, 4096, 0, 16),
        ("TP 2 o_proj", 1024, 2048, 0, 16),
        ("TP 2 down_proj", 4096, 2048, 0, 16)], shard=True)
    out["attend_int8_kv"] = attend_checks(
        dev, gpu, timer, ((592, False, 1),), heads=(16, 4), shard=True)
    out.update(fused_checks(dev, gpu, timer, (
        ("TP 2 rank b16, a partial sum before the reduce", 16, 4096,
         False),), shard=True))
    out["lmhead_topk"] = head_checks(dev, gpu, timer, None, head_split, B=8,
                                     exacts=(False,), shard=True)
    return out


def microbatch_shape_checks(dev, gpu, timer):
    """Phase 3 at phase 16's microbatch shapes: "train_18_30" stage 1 at
    batch 16 in 4 microbatches is B 4 a microbatch, 4 x 528 = 2112 rows:
    flash at the Llama's 32/8 heads of 64 (RoPE, causal), RMSNorm (2112,
    2048) and the SwiGLU down-projection (2112, 8192) x (8192, 2048).
    Each row carries ``microbatch=True``; the main-path lines leave them
    out."""
    import torch
    g = torch.Generator(device=dev).manual_seed(16)
    mb = 16 // PIPE_MICRO
    out = {"flash_attn_fwd": flash_checks(
        dev, gpu, timer, [(f"pipeline microbatch llama_self 32/8x64 B{mb}",
                           llama_case(dev, g, mb, 32, 8))], microbatch=True)}
    out.update(fused_checks(dev, gpu, timer, (
        (f"pipeline microbatch b{mb} (train_18_30 stage 1, pp 2, "
         f"{PIPE_MICRO} microbatches)", mb, 8192, True),), microbatch=True))
    return out


STUDY_TOKENS = 8 + 640   # the studies' 8 image tokens + 640 text tokens
STUDY_NEW = 96           # the speculative study's new tokens


def study_shape_checks(dev, gpu, timer):
    """Phase 3 at phase 18's shapes, the studies' mid-size stack (B 16,
    8 + 640 tokens): flash at the Llama's 8/4 heads of 32 with RoPE inside
    (causal, a key mask), which takes the tiled form, the prefill without
    RoPE, a decode step over 744 slots and the speculative window of 8
    over 752 (a (B, W, S) mask), the LTSF cross-attention at 2 heads of
    128 and the Q-Former's self, query and cross attention at 8 heads of
    16; RMSNorm (10368, 256) and the SwiGLU down-projection (10368, 1024)
    x (1024, 256) with the fused switch on.  Each row carries
    ``study=True``; the main-path lines leave them out."""
    import numpy as np
    import torch
    from tsue_tpu_torch.cli._common import midsize_cfg
    from tsue_tpu_torch.models.llama import rope_inv_freq
    g = torch.Generator(device=dev).manual_seed(18)
    B, T = 16, STUDY_TOKENS
    llama = midsize_cfg("study").model.llama
    Hq, Hkv, D = llama.num_heads, llama.num_kv_heads, llama.head_dim

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def key_mask(S, lens):
        return (torch.arange(S, device=dev)[None]
                < torch.as_tensor(lens, device=dev)[:, None]).int()
    lens = np.linspace(400, T, B).astype(np.int64)
    mask = key_mask(T, lens)
    inv = torch.as_tensor(rope_inv_freq(llama), device=dev)
    ang = (mask.cumsum(1) - 1).clamp_min(0).float()[..., None] * inv
    S1, Sw = T + STUDY_NEW, T + STUDY_NEW + 8
    flash = [
        (f"study llama_self {Hq}/{Hkv}x{D} B16 T{T}, RoPE", dict(
            q=randn(B, T, Hq, D), k=randn(B, T, Hkv, D),
            v=randn(B, T, Hkv, D), mask=mask, is_causal=True,
            rope=(torch.cos(ang), torch.sin(ang)))),
        (f"study gen_prefill {Hq}/{Hkv}x{D} B16 T{T}", dict(
            q=randn(B, T, Hq, D), k=randn(B, T, Hkv, D),
            v=randn(B, T, Hkv, D), mask=mask, is_causal=True)),
        (f"study gen_decode {Hq}/{Hkv}x{D} Tq1 S{S1}", dict(
            q=randn(B, 1, Hq, D), k=randn(B, S1, Hkv, D),
            v=randn(B, S1, Hkv, D), mask=key_mask(S1, lens + 1))),
        (f"study spec_window_w8 {Hq}/{Hkv}x{D} S{Sw}", dict(
            q=randn(B, 8, Hq, D), k=randn(B, Sw, Hkv, D),
            v=randn(B, Sw, Hkv, D),
            mask=window_mask(dev, g, lens, T, 8, Sw))),
        (f"study ltsf_cross 2x128 Tq18 Tk{T}", dict(
            q=randn(B, 18, 2, 128), k=randn(B, T, 2, 128),
            v=randn(B, T, 2, 128), mask=mask)),
        ("study qformer_self 8x16 T18", dict(
            q=randn(B, 18, 8, 16), k=randn(B, 18, 8, 16),
            v=randn(B, 18, 8, 16))),
        ("study qformer_query_self 8x16 T8", dict(
            q=randn(B, 8, 8, 16), k=randn(B, 8, 8, 16),
            v=randn(B, 8, 8, 16))),
        ("study qformer_cross 8x16 Tq8 Tk18", dict(
            q=randn(B, 8, 8, 16), k=randn(B, 18, 8, 16),
            v=randn(B, 18, 8, 16)))]
    out = {"flash_attn_fwd": flash_checks(dev, gpu, timer, flash,
                                          study=True)}
    check(out["flash_attn_fwd"][0]["form"] == "tiled",
          f"the study's Llama attention took {out['flash_attn_fwd'][0]}")
    out.update(fused_checks(dev, gpu, timer, (
        ("study_fast_vs_parity b16 (fused switch on)", B,
         llama.intermediate_size, True, T, llama.hidden_size),),
        study=True))
    return out


BF_TOL = dict(atol=2 ** -6, rtol=2 ** -7)   # bf16 outputs: a few ulps


def bf16_checks(dev, gpu, timer):
    """The bf16 forms at the training shapes of a bf16 model: flash
    attention (the Llama's self-attention, B16 T528 32/8 x 64, RoPE,
    causal, and the Q-Former's, B16 T18 8 x 96: the tensor-core form
    "bf16_mma"; the LTSF cross-attention's fp32 queries over bf16 keys, D =
    1024, and its all-bf16 twin: the wide form "bf16_wide", its plan
    printed; a decode step of bf16 queries over a bf16 cache: the decode
    form "bf16_decode"), RMSNorm (8448, 2048) (the form "bf16_stream") and the
    SwiGLU product (8448, 8192) x (8192, 2048) (the form "bf16_wgmma"),
    each against its plain version (flash, RMSNorm: atol
    2^-6, rtol 2^-7; SwiGLU: rtol 2^-7, atol 2^-7 of the largest output),
    the form that ran, a repeated call bit-identical, the bound at bf16's 2
    bytes an element and 989 TFLOP/s, and the library call in bf16: SDPA,
    ``F.rms_norm``, cuBLAS ``h @ w``.  SwiGLU's tensor cores sum all of K =
    8192 in fp32 accumulators: its ``tol_used`` against an fp64 product of
    the same h is printed beside the plain version's (the drift of an
    unpromoted accumulator).  Returns rows by kernel."""
    import torch
    import torch.nn.functional as F
    from tsue_tpu_torch.ops.flash import (flash_attention,
                                          flash_attention_plain,
                                          flash_attention_plan, rope_bthd)
    from tsue_tpu_torch.ops.fused import (fused_rmsnorm, rmsnorm_plain,
                                          rmsnorm_plan, swiglu_matmul,
                                          swiglu_matmul_plain,
                                          swiglu_matmul_plan)
    bf = torch.bfloat16
    rows = {"flash_attn_fwd": [], "rmsnorm": [], "swiglu_matmul": []}
    cases = dict(attention_cases(dev))

    def cast(kw, q_dtype, kv_dtype):
        return dict(kw, q=kw["q"].to(q_dtype), k=kw["k"].to(kv_dtype),
                    v=kw["v"].to(kv_dtype))
    for name, kw in (
            ("llama_self bf16", cast(cases["llama_self"], bf, bf)),
            ("qformer_self bf16", cast(cases["qformer_self"], bf, bf)),
            ("ltsf_cross fp32 q, bf16 k/v",
             cast(cases["ltsf_cross"], torch.float32, bf)),
            ("ltsf_cross bf16", cast(cases["ltsf_cross"], bf, bf)),
            ("decode bf16, Tq1 S592",
             cast(cases["gen_decode_fp32_cache"], bf, bf))):
        out = flash_attention(**kw)
        ref = flash_attention_plain(**kw)
        torch.cuda.synchronize()
        err, rel = errors(out.float(), ref.float())
        check(out.dtype == kw["q"].dtype and bool(
            torch.isfinite(out.float()).all()) and torch.allclose(
                out.float(), ref.float(), **BF_TOL),
              f"flash_attn_fwd {name}: max abs err {err} ({BF_TOL})")
        check(torch.equal(out, flash_attention(**kw)),
              f"flash_attn_fwd {name}: a repeated call differs")
        (B, Tq, Hq, D), (Tk, Hkv) = kw["q"].shape, kw["k"].shape[1:3]
        plan = flash_attention_plan(B, Tq, Tk, Hq, Hkv, D,
                                    kw.get("rope") is not None, False,
                                    kw["q"].dtype, kw["k"].dtype)
        form = plan["form"]
        want = ("bf16_wide" if name.startswith("ltsf_cross") else
                "bf16_decode" if name.startswith("decode") else "bf16_mma")
        check(form == want, f"flash_attn_fwd {name}: form {form}")
        if form == "bf16_wide":
            # one wave of clusters, one launch, no scratch
            check(plan["waves"] == 1, f"flash_attn_fwd {name}: plan {plan}")
            print(f"flash_attn_fwd {name}: plan {json.dumps(plan)} (key "
                  f"splits merged by their cluster in one launch); gpu: "
                  f"{gpu}", flush=True)
        plain_ms = timer.ms(lambda: flash_attention_plain(**kw))
        ms = timer.ms(lambda: flash_attention(**kw))
        q, k, v = kw["q"], kw["k"], kw["v"]
        if kw.get("rope") is not None:
            q, k = rope_bthd(q, *kw["rope"]), rope_bthd(k, *kw["rope"])
        pairs = attended(kw)
        dt = torch.promote_types(q.dtype, k.dtype)
        qt, kt, vt = (t.transpose(1, 2).contiguous().to(dt)
                      for t in (q, k, v))
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=pairs[:, None], enable_gqa=True))
        D, Hq = q.shape[3], q.shape[2]
        extra = [kw.get("mask")] + list(kw.get("rope") or ())
        b = bound(nbytes(kw["q"], kw["k"], kw["v"], out, *extra),
                  4.0 * D * Hq * pairs.sum().item(), BF16_FLOPS)
        rows["flash_attn_fwd"].append(row(
            "flash_attn_fwd", name, gpu, err, rel, ms, plain_ms, b, lib_ms,
            timer.floor_ms, q=list(q.shape), k=list(k.shape),
            dtypes=[str(kw["q"].dtype)[6:], str(kw["k"].dtype)[6:]],
            form=form, plan=plan, repeat_bit_identical=True))
        del out, ref, qt, kt, vt
    del cases
    g = torch.Generator(device=dev).manual_seed(12)
    D, I, M = 2048, 8192, 16 * (16 + TEXT_TOKENS)
    x = torch.randn(M, D, generator=g, device=dev).to(bf)
    scale = (1.0 + 0.1 * torch.randn(D, generator=g, device=dev)).to(bf)
    plan = rmsnorm_plan(M, D, bf, bf)
    check(plan["form"] == "bf16_stream", f"rmsnorm bf16: plan {plan}")
    out = fused_rmsnorm(x, scale, 1e-5)
    ref = rmsnorm_plain(x, scale, 1e-5)
    torch.cuda.synchronize()
    err, rel = errors(out.float(), ref.float())
    check(out.dtype == bf and torch.allclose(out.float(), ref.float(),
                                             **BF_TOL),
          f"rmsnorm bf16 disagrees with the plain version: {err}")
    check(torch.equal(out, fused_rmsnorm(x, scale, 1e-5)),
          "rmsnorm bf16: a repeated call differs")
    plain_ms = timer.ms(lambda: rmsnorm_plain(x, scale, 1e-5))
    ms = timer.ms(lambda: fused_rmsnorm(x, scale, 1e-5))
    lib_ms = timer.ms(lambda: F.rms_norm(x, (D,), scale, 1e-5))
    rows["rmsnorm"].append(row(
        "rmsnorm", f"bf16 x and scale: M={M} K={D}", gpu, err, rel, ms,
        plain_ms, bound(nbytes(x, scale, out), 4.0 * M * D, BF16_FLOPS),
        lib_ms, timer.floor_ms, dtype="bfloat16", form=plan["form"],
        plan=plan, repeat_bit_identical=True))
    del x, out, ref
    gate = (torch.randn(M, I, generator=g, device=dev)).to(bf)
    up = torch.randn(M, I, generator=g, device=dev).to(bf)
    w = (torch.randn(I, D, generator=g, device=dev) * I ** -0.5).to(bf)
    plan = swiglu_matmul_plan(M, I, D, bf)
    check(plan["form"] == "bf16_wgmma", f"swiglu_matmul bf16: plan {plan}")
    out = swiglu_matmul(gate, up, w)
    ref = swiglu_matmul_plain(gate, up, w)
    torch.cuda.synchronize()
    err, rel = errors(out.float(), ref.float())
    big = ref.float().abs().max().item()
    check(out.dtype == bf and torch.allclose(
        out.float(), ref.float(), rtol=2 ** -7, atol=2 ** -7 * big),
          f"swiglu_matmul bf16 disagrees with the plain version: {err}")
    check(torch.equal(out, swiglu_matmul(gate, up, w)),
          "swiglu_matmul bf16: a repeated call differs")
    h = (F.silu(gate.float()).to(bf) * up)

    def tol_used(x, r):
        return ((x.double() - r).abs()
                / (2 ** -7 * big + 2 ** -7 * r.abs())).max().item()
    ref64 = h.double() @ w.double()
    drift = dict(tol_used=tol_used(out, ref.double()),
                 tol_used_f64=tol_used(out, ref64),
                 plain_tol_used_f64=tol_used(ref, ref64),
                 share_unequal_to_plain=(out != ref).float().mean().item())
    del ref64
    print(f"swiglu_matmul bf16 M={M} K={I} N={D}: plan {json.dumps(plan)}; "
          f"no promotion of partial sums: {json.dumps(drift)}; gpu: {gpu}",
          flush=True)
    plain_ms = timer.ms(lambda: swiglu_matmul_plain(gate, up, w))
    ms = timer.ms(lambda: swiglu_matmul(gate, up, w))
    lib_ms = timer.ms(lambda: h @ w)
    del h
    rows["swiglu_matmul"].append(row(
        "swiglu_matmul", f"bf16: M={M} K={I} N={D}", gpu, err, rel, ms,
        plain_ms, bound(nbytes(gate, up, w, out), 2.0 * M * D * I,
                        BF16_FLOPS), lib_ms, timer.floor_ms, plan=plan,
        dtype="bfloat16", form=plan["form"], repeat_bit_identical=True,
        **drift))
    del gate, up, w, out, ref
    torch.cuda.empty_cache()
    return rows


def nlinear_checks(dev, gpu, timer):
    """NLinear where it would sit in the LTSF (C = 64 channels): the
    deterministic forecast at batch 16 (18 -> 18 and 18 -> 30) and the K=10
    rollout's 160 rows, each with its launch plan (nlinear_plan: the copy
    form, channels and rows a CTA, CTAs).  Its bound is the larger of the
    roofline's and the timer's launch floor, both printed.  No one PyTorch
    call computes it (the einsum alone omits the last-step subtract and
    add; its time is printed beside)."""
    import torch
    from tsue_tpu_torch.ops.nlinear import (nlinear_fused, nlinear_plan,
                                            nlinear_ref)
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
        plan = nlinear_plan(B, C, Ti, To)
        b_ = bound(nbytes(x, w, b, out), 2.0 * B * C * Ti * To)
        print(f"nlinear {name}: plan {json.dumps(plan)}; launch floor "
              f"{timer.floor_ms:.4f} ms, roofline bound {b_[0]:.6f} ms "
              f"({b_[1]}); torch.einsum alone (no subtract/add, not the "
              f"same function) {einsum_ms:.4f} ms; gpu: {gpu}", flush=True)
        rows.append(row("nlinear", name, gpu, err, rel, ms, plain_ms, b_,
                        None, timer.floor_ms, einsum_ms=einsum_ms,
                        plan=plan))
    return rows


LORA_SHAPES = (   # (name, M, K, N): stage-1 batch 16, 16 + 512 tokens
    ("q_proj", 16 * (16 + TEXT_TOKENS), 2048, 2048),
    ("v_proj", 16 * (16 + TEXT_TOKENS), 2048, 512))


def lora_checks(dev, gpu, timer):
    """The fused LoRA product where it would sit in stage 1 (r = 8, scale
    32 / 8 = 4), at q_proj and v_proj in fp32 and bf16, and ranks 24 and 64
    at q_proj (the SIMT form), each with its launch plan
    (lora_matmul_plan: the form, tile, ring and CTAs).  fp32: rtol
    1e-4, atol 1e-5 of the largest output (K products summed in another
    order, on the tensor cores in 3xTF32); bf16 (xA rounded to bf16 before
    the second product, as the Pallas kernel): rtol = atol = 2^-7 of the
    largest output, two bf16 ulps; ``tol_used`` is the largest
    |out - ref| / (atol + rtol |ref|).  No one PyTorch call computes it; the
    cuBLAS time of x @ w alone, the floor any fused LoRA product competes
    with, is printed beside."""
    import torch
    from tsue_tpu_torch.ops.lora import lora_matmul, lora_matmul_plan, lora_ref
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []
    scale = 4.0
    # rank 8 at both shapes; ranks 24 and 64 (the SIMT form's walks of 16
    # ranks, above the tensor-core forms' 16) at q_proj
    cases = [(dtype, shape, 8) for dtype in (torch.float32, torch.bfloat16)
             for shape in LORA_SHAPES]
    cases += [(dtype, LORA_SHAPES[0], r) for r in (24, 64)
              for dtype in (torch.float32, torch.bfloat16)]
    for dtype, (name, M, K, N), r in cases:
        x = torch.randn(M, K, generator=g, device=dev).to(dtype)
        w = (torch.randn(K, N, generator=g, device=dev)
             * K ** -0.5).to(dtype)
        a = (torch.randn(K, r, generator=g, device=dev)
             * K ** -0.5).to(dtype)
        b = (torch.randn(r, N, generator=g, device=dev) * 0.1).to(dtype)
        plan = lora_matmul_plan(M, K, N, r, dtype)
        out = lora_matmul(x, w, a, b, scale)
        ref = lora_ref(x, w, a, b, scale, round_xa=True)
        torch.cuda.synchronize()
        err, rel = errors(out.float(), ref.float())
        big = ref.float().abs().max().item()
        tol = (dict(rtol=1e-4, atol=1e-5 * big)
               if dtype == torch.float32
               else dict(rtol=2 ** -7, atol=2 ** -7 * big))
        used = ((out.float() - ref.float()).abs()
                / (tol["atol"] + tol["rtol"] * ref.float().abs())
                ).max().item()
        label = f"{name} M={M} K={K} N={N} r={r} {str(dtype)[6:]}"
        print(f"lora_matmul {label}: plan {json.dumps(plan)}",
              flush=True)
        check(torch.allclose(out.float(), ref.float(), **tol),
              f"lora_matmul disagrees with the plain version at {label}"
              f": max abs err {err} ({tol})")
        check(torch.equal(out, lora_matmul(x, w, a, b, scale)),
              f"lora_matmul {label}: a repeated call differs")
        plain_ms = timer.ms(lambda: lora_ref(x, w, a, b, scale,
                                             round_xa=True))
        ms = timer.ms(lambda: lora_matmul(x, w, a, b, scale))
        base_ms = timer.ms(lambda: x @ w)
        print(f"lora_matmul {label}: cuBLAS x @ w alone {base_ms:.4f} "
              f"ms; gpu: {gpu}", flush=True)
        flops = 2.0 * M * N * K + 2.0 * M * K * r + 2.0 * M * r * N
        moved = nbytes(x, w, a, b, out)
        extra = {}
        if dtype == torch.float32:
            # the kernel's products run on the tensor cores as three
            # TF32 products each; the fp32 CUDA-core bound beside
            b_ = bound(moved, 3 * flops, TF32_FLOPS)
            extra["fp32_fma_bound_ms"] = bound(moved, flops)[0]
        else:
            b_ = bound(moved, flops, BF16_FLOPS)
        rows.append(row("lora_matmul", label, gpu, err, rel, ms,
                        plain_ms, b_, None, timer.floor_ms,
                        cublas_xw_ms=base_ms,
                        dtype=str(dtype)[6:], plan=plan, tol_used=used,
                        **extra))
        del x, w, a, b, out, ref
    torch.cuda.empty_cache()
    return rows


def ade_fde_checks(dev, gpu, timer):
    """Per-sample ADE/FDE at the evaluation's shapes: a batch of 16 at 18
    and 30 output steps, and the K=10 rollout's 160 candidate rows.  Against
    the plain version (the same arithmetic) atol = rtol = 1e-4; no one
    PyTorch call computes it.  Its bound is the larger of the roofline's and
    the timer's launch floor."""
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
                                        9.0 * B * T), None, timer.floor_ms))
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
    below 1e-4 or 1e-3 of its tensor's largest (an attention key bias,
    zero in exact arithmetic, moves by at most lr on either side, see
    ``step_parity``): the clipped gradients are near Adam's
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
    (see ``small_training_phase``); a bias whose gradient is 0 in exact
    arithmetic (an attention key bias: a shift common to all keys; a conv
    bias before a train-mode BatchNorm, which subtracts the channel's
    batch mean) steps on rounding noise, so each side must move it by at
    most lr, Adam's first step.  Returns the largest such difference."""
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
        if n.endswith((".k.bias", "conv.bias")):
            check(bool(((a - before).abs() <= lr * 1.001).all())
                  and bool(((c - before).abs() <= lr * 1.001).all()),
                  f"{what}: {n} moved by more than lr")
            continue
        gm = grads[n]
        small = (gm < 1e-4) | (gm < 1e-3 * gm.max())
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


def predict_flash_calls(m):
    """(per predict, per rollout): the attention calls one K > 0 chunk of
    ``Predictor.predict`` makes.  _predict runs every attention through
    the kernel; the rollout's context does too, but its forecaster attends
    under dropout in PyTorch ops."""
    per_predict = (m.lane.num_layers + m.qformer.num_encoder_layers
                   + 2 * m.qformer.num_decoder_layers + m.llama.num_layers
                   + 2)
    return per_predict, per_predict - 2


def predict_phase(dev, gpu, cfg, state):
    import numpy as np
    import torch
    from tsue_tpu_torch.data import make_synthetic_tracks
    from tsue_tpu_torch.ops.flash import flash_attention
    from tsue_tpu_torch.serve import Predictor

    K, B = 10, 16
    m = cfg.model
    per_predict, per_rollout = predict_flash_calls(m)
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

    # the first request once more, then under torch.profiler: where a
    # chunk's device time goes (the launch counts above are already read)
    def request():
        pred.predict(tracks, torch.Generator(device=dev).manual_seed(1))
    t0 = time.perf_counter()
    request()
    torch.cuda.synchronize(dev)
    profile_device(dev, gpu, f"predict profile: one request, {len(out)} "
                   f"windows in {math.ceil(len(out) / B)} chunks",
                   time.perf_counter() - t0, request)
    del pred
    torch.cuda.empty_cache()
    return {"flash_attn_fwd": launches}, fused_counts, (out, fused)


# --------------------------------------------------------------------------
# 17. the reference's checkpoint migrated into the port at full width
# --------------------------------------------------------------------------

def same_predictions(a, b) -> bool:
    import numpy as np
    return len(a) == len(b) and all(
        np.array_equal(x[k], y[k]) for x, y in zip(a, b)
        for k in ("pred_pixel_xy", "candidates_pixel_xy"))


def reference_ckpt_phase(dev, gpu, cfg, state, fused_counts, first):
    """Phase 17 (run right after phase 5, over its state): the state
    exported to the reference's stage-2 layout (``flax_params`` and
    ``models.torch_export``) and written with ``torch.save``, as the
    reference writes its best-val checkpoint; the ``import_ref`` command
    (``--stage2 --preset test_18_18``: fp32, as the file) on that file;
    every tensor of its artifact equal to the state;
    ``Predictor.from_checkpoint`` on the artifact under phase 5's
    "bfloat16" configuration (a byte tokenizer of the file's vocabulary)
    serving the state bit for bit in fp32 and answering phase 5's first
    request, with the fused switch off and on, bit for bit as phase 5
    answered it (``first``: its two answers), with phase 5's launches;
    then ``export_ref`` -> ``import_ref`` of phase 4's small
    configuration, bit for bit.  The temporary files live under ``runs/``
    and are removed.  Returns the launch counts of the fused request."""
    import shutil
    import tempfile
    import torch
    from tsue_tpu_torch.cli import export_ref, import_ref
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.convert import flax_params
    from tsue_tpu_torch.data import make_synthetic_tracks
    from tsue_tpu_torch.data.tokenizer import ByteTokenizer, get_tokenizer
    from tsue_tpu_torch.models import torch_export as te
    from tsue_tpu_torch.models.tsue import TrajectoryModel
    from tsue_tpu_torch.ops.fused import fused_scope
    from tsue_tpu_torch.runner import build_model_and_params
    from tsue_tpu_torch.serve import Predictor
    from tsue_tpu_torch.train.checkpoint import STATE_FILE, save_state_dict

    t_phase = time.time()
    cfg32 = get_preset(cfg.name)       # what import_ref builds: fp32
    check(cfg32.model == dataclasses.replace(cfg.model, dtype="float32"),
          "phase 17's preset is not phase 5's configuration in fp32")
    tracks = make_synthetic_tracks(num_tracks=4, track_len=400, seed=1)
    runs = Path(__file__).resolve().parent / "runs"
    runs.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="reference_ckpt_", dir=runs)
    ref_pt = os.path.join(tmp, "best_val_checkpoint.pt")
    imported = os.path.join(tmp, "imported")

    def artifact(path):
        return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                          weights_only=True)

    def unequal(got, want):
        """Keys whose tensors differ (fp32 files, bf16-valued states)."""
        check(set(got) == set(want), "imported keys differ: "
              f"{sorted(set(got) ^ set(want))[:4]}")
        return [k for k, v in want.items()
                if not torch.equal(got[k], v.detach().cpu().float())]

    def requests(pred):
        """Phase 5's first request, fused switch off then on; the launch
        counts of the second."""
        pred.warmup()
        off = pred.predict(tracks, torch.Generator(device=dev).manual_seed(1))
        reset_counts()
        with fused_scope("on"):
            on = pred.predict(tracks,
                              torch.Generator(device=dev).manual_seed(1))
        return off, on, read_counts()

    try:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.device(dev):
            model = TrajectoryModel(cfg.model, cfg.data.seq_len,
                                    cfg.data.out_len)
        model.load_state_dict(state)
        exported = te.to_torch_state_dict(
            te.export_reference_stage2(flax_params(model)))
        t_export = time.perf_counter() - t0
        del model
        n_keys = len(exported)
        n_params = sum(v.numel() for v in exported.values())
        t0 = time.perf_counter()
        torch.save(exported, ref_pt)
        t_save = time.perf_counter() - t0
        del exported
        size = os.path.getsize(ref_pt)
        t0 = time.perf_counter()
        res = import_ref.main(["--stage2", "--preset", cfg.name,
                               "--torch-ckpt", ref_pt, "--out", imported])
        t_import = time.perf_counter() - t0
        check(res["keys"] == n_keys, f"import_ref read {res['keys']} keys "
              f"of {n_keys}")
        bad = unequal(artifact(imported), state)
        check(not bad, f"imported tensors differ from the state: {bad[:4]}")
        print(f"reference checkpoint: {n_keys} keys, {n_params / 1e9:.4f}B "
              f"values, file {size / 1e9:.3f} GB (fp32); export "
              f"{t_export:.2f}s, torch.save {t_save:.2f}s, import_ref "
              f"{t_import:.2f}s (load {res['load_s']:.2f}, convert "
              f"{res['convert_s']:.2f}, save {res['save_s']:.2f}); every "
              f"tensor of the artifact equal to the state; gpu: {gpu}",
              flush=True)

        t0 = time.perf_counter()
        pred = Predictor.from_checkpoint(
            cfg, imported, device=dev, batch_size=16, num_candidates=10,
            tokenizer=ByteTokenizer(cfg.model.llama.vocab_size))
        torch.cuda.synchronize(dev)
        t_load = time.perf_counter() - t0
        served = pred.model.state_dict()
        check(all(torch.equal(served[k], v) for k, v in state.items())
              and {p.dtype for p in pred.model.parameters()}
              == {torch.float32},
              "the served state differs from the exported one")
        got_off, got_on, counts = requests(pred)
        del pred, served
        check(same_predictions(got_off, first[0]), "the migrated model's "
              "predictions differ from phase 5's")
        check(same_predictions(got_on, first[1]), "the migrated model's "
              "fused-switch predictions differ from phase 5's")
        check(counts == fused_counts, f"migrated predict, fused on: "
              f"launches {counts} != phase 5's {fused_counts}")
        print(f"reference checkpoint served: Predictor.from_checkpoint "
              f"{t_load:.2f}s under phase 5's bfloat16 configuration (fp32 "
              f"parameters); phase 5's request ({len(got_off)} windows, "
              f"K=10) bit-identical to phase 5's answers, fused switch off "
              f"and on; launches {json.dumps(counts)} as phase 5's; gpu: "
              f"{gpu}", flush=True)

        # phase 4's small configuration: export_ref -> import_ref
        scfg = small_cfg()
        small = build_model_and_params(scfg, get_tokenizer(), dev)
        save_state_dict(small, os.path.join(tmp, "small"))
        t0 = time.perf_counter()
        export_ref.export_reference(scfg, os.path.join(tmp, "small"),
                                    os.path.join(tmp, "small.pt"),
                                    stage2=True, device=dev)
        import_ref.import_reference(scfg, os.path.join(tmp, "small.pt"),
                                    os.path.join(tmp, "small_back"),
                                    stage2=True, device=dev)
        t_small = time.perf_counter() - t0
        bad = unequal(artifact(os.path.join(tmp, "small_back")),
                      small.state_dict())
        check(not bad, f"small export_ref -> import_ref differs: {bad[:4]}")
        print(f"reference checkpoint, phase 4's configuration: export_ref -> "
              f"import_ref {t_small:.2f}s, bit for bit", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"reference checkpoint phase: {time.time() - t_phase:.1f}s in all; "
          f"gpu: {gpu}", flush=True)
    return {"predict_fused (migrated reference checkpoint)": counts}


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


def profile_device(dev, gpu, what: str, wall_s: float, fn,
                   totals=()) -> dict:
    """Run ``fn`` once under torch.profiler and print the device's busy
    time, its busy and idle shares against ``wall_s`` (the unprofiled wall
    time of the same work: the trace's own host cost stretches its wall
    time, so the share under the trace is printed beside it), the ten
    kernels with the most device time and, for each name in ``totals``,
    the device time and calls of every kernel whose name holds it.
    Returns those device times in ms, by name."""
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
    out = {}
    for name in totals:
        hits = [e for e in device if name in e.key]
        out[name] = sum(e.self_device_time_total for e in hits) / 1e3
        print(f"{what}: {name} total {out[name]:.3f} ms in "
              f"{sum(e.count for e in hits)} calls; gpu: {gpu}", flush=True)
    return out


def request_stats(pred):
    """(chunks, executed decode steps, prefill s per chunk, decode ms per
    step) of the predictor's last request."""
    ch = pred.last_request["chunks"]
    steps = sum(c["steps"] for c in ch)
    prefill = [c["prefill_ms"] / 1e3 for c in ch]
    decode_ms = sum(c["decode_ms"] for c in ch) / max(steps, 1)
    return len(ch), steps, prefill, decode_ms


def timed_requests(dev, gpu, pred, label: str, seeds):
    """``generate_context`` on 32 tracks for each seed (64 new tokens, the
    seed's generator), each printed with its numbers, then the first
    seed's request again, whose ids must be equal.  Returns (chunks,
    steps, seconds) of the timed requests and (chunks, steps) with the
    repeat."""
    import numpy as np
    import torch
    from tsue_tpu_torch.data import make_synthetic_tracks

    B, N = 16, GEN_NEW_TOKENS

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    chunks = steps = 0
    seconds = 0.0
    first = None
    for seed in seeds:
        tracks = make_synthetic_tracks(num_tracks=32, track_len=400, seed=seed)
        t0 = time.perf_counter()
        out = pred.generate_context(tracks, max_new_tokens=N,
                                    generator=gen(seed))
        dt = time.perf_counter() - t0
        c, s, prefill, step_ms = request_stats(pred)
        chunks, steps, seconds = chunks + c, steps + s, seconds + dt
        ids = pred.last_request["ids"]
        check(len(out) == 32 and ids.shape == (32, N), f"{label}: shapes")
        check(all(isinstance(r["context"], str) for r in out),
              f"{label}: text records")
        check(len(np.unique(ids)) > 32, f"{label}: degenerate ids")
        print(f"{label} request seed={seed}: 32 tracks in {dt:.3f}s, "
              f"{c} chunks, {s} decode steps, prefill "
              f"{', '.join(f'{p:.4f}' for p in prefill)} s per chunk, "
              f"{step_ms:.3f} ms per decode step (device events), "
              f"{B * s / dt:.1f} generated tokens/s; gpu: {gpu}", flush=True)
        if first is None:
            first = (tracks, ids.copy())
    tracks, ids = first
    pred.generate_context(tracks, max_new_tokens=N, generator=gen(seeds[0]))
    c, s, _, _ = request_stats(pred)
    check(np.array_equal(pred.last_request["ids"], ids),
          f"{label}: a repeated request with an equal generator differs")
    return chunks, steps, seconds, chunks + c, steps + s


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
    chunks3, steps3, seconds, chunks, steps = timed_requests(
        dev, gpu, pred, "generate", (1, 2, 3))
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
    print(f"generate: 3 requests, {B * steps3} generated tokens in "
          f"{seconds:.3f}s = {B * steps3 / seconds:.1f} tokens/s "
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
                                      generator=gen(7)),
        totals=("int8_matmul_kernel", "attend_int8_kernel",
                "head_tile_topk", "head_merge"))
    del pred
    torch.cuda.empty_cache()
    head_counts = fused_head_requests(dev, gpu, cfg, state)

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
    return counts, head_counts, off


def fused_head_requests(dev, gpu, cfg, state):
    """generate_context with the fused head alone (fp32 decode weights, the
    fp32 KV cache, the tied fp32 embedding as the head): a warmup, two
    requests of 32 tracks, a repeated request whose ids must be equal, the
    launch counts against the expected table, and a torch.profiler trace
    of one chunk with the head's device time.  Returns the launches."""
    import torch
    from tsue_tpu_torch.data import make_synthetic_tracks
    from tsue_tpu_torch.serve import Predictor

    B, N = 16, GEN_NEW_TOKENS
    m = cfg.model
    L = m.llama.num_layers
    qformer_calls = m.qformer.num_encoder_layers + \
        2 * m.qformer.num_decoder_layers

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    t0 = time.time()
    pred = Predictor(cfg, state, batch_size=B, fused_head=True, device=dev)
    warm = make_synthetic_tracks(num_tracks=B, track_len=400, seed=100)
    pred.generate_context(warm, max_new_tokens=N, generator=gen(0))
    torch.cuda.synchronize(dev)
    print(f"generate, fused head alone: predictor + warmup "
          f"{time.time() - t0:.1f}s", flush=True)
    reset_counts()
    chunks2, steps2, seconds2, chunks, steps = timed_requests(
        dev, gpu, pred, "generate, fused head alone", (1, 2))
    counts = read_counts()
    expected = {"flash_attn_fwd": chunks * (L + qformer_calls) + steps * L,
                "int8_matmul": 0, "lmhead_topk": steps, "attend_int8_kv": 0,
                "rmsnorm": 0, "swiglu_matmul": 0,
                **dict.fromkeys(NO_PATH, 0)}
    print(f"generate, fused head alone: launches {json.dumps(counts)} over "
          f"{chunks} chunks and {steps} decode steps, expected "
          f"{json.dumps(expected)}", flush=True)
    check(counts == expected, f"generate, fused head alone: launches "
                              f"{counts} != {expected}")
    print(f"generate, fused head alone: 2 requests, {B * steps2} "
          f"generated tokens in {seconds2:.3f}s = "
          f"{B * steps2 / seconds2:.1f} tokens/s (batch {B}, {N} new "
          f"tokens, fp32 weights + fused tied fp32 head + fp32 KV); gpu: "
          f"{gpu}", flush=True)
    tracks = make_synthetic_tracks(num_tracks=16, track_len=400, seed=7)
    head = profile_device(
        dev, gpu, f"generate, fused head alone, profile: one chunk of 16 "
        f"tracks, {N} decode steps", seconds2 / chunks2,
        lambda: pred.generate_context(tracks, max_new_tokens=N,
                                      generator=gen(7)),
        totals=("head_tile_topk", "head_merge"))
    print(f"generate, fused head alone: the head's device time "
          f"{sum(head.values()):.3f} ms per chunk of {N} decode steps "
          f"({sum(head.values()) / N:.4f} ms a step); gpu: {gpu}",
          flush=True)
    del pred
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# 10. the serving entry points at full width
# --------------------------------------------------------------------------

POOL_SLOTS, POOL_CHUNK, POOL_TRACKS = 16, 8, 48


def pool_expected(m, run) -> dict:
    """The launches of a continuous-batcher run with int8 weights and the
    int8 KV cache: each admission prefills one request (flash in every
    Llama layer and Q-Former call, the int8 LM head once for its first
    logits); each tick is one decode step over all slots (seven int8
    products a layer and the int8 head, one int8-KV attention a layer)."""
    L = m.llama.num_layers
    qformer_calls = m.qformer.num_encoder_layers + \
        2 * m.qformer.num_decoder_layers
    A, T = run["admissions"], run["ticks"]
    return {"flash_attn_fwd": A * (L + qformer_calls),
            "int8_matmul": T * (7 * L + 1) + A, "lmhead_topk": 0,
            "attend_int8_kv": T * L, "rmsnorm": 0, "swiglu_matmul": 0,
            **dict.fromkeys(NO_PATH, 0)}


def pool_run(batcher, reqs):
    """(ids, wall s) of one run, synchronised."""
    import torch
    t0 = time.perf_counter()
    out = batcher.run(reqs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def pool_stats(run, tokens: int, wall: float) -> str:
    ticks = run["ticks"]
    admit = run["admit_ms"]
    return (f"{tokens} generated tokens in {wall:.3f}s = "
            f"{tokens / wall:.1f} tokens/s, {ticks} ticks ({run['chunks']} "
            f"chunks of {ticks // run['chunks']}), {wall * 1e3 / ticks:.3f} "
            f"ms per tick wall, {sum(run['decode_ms']) / ticks:.3f} ms per "
            f"tick device events (admissions included in the wall only), "
            f"mean live slots per tick {run['mean_live_slots']:.3f}, "
            f"{run['admissions']} admissions, admission prefill "
            f"{sum(admit) / len(admit):.3f} ms each (device events; "
            f"{min(admit):.3f}-{max(admit):.3f})")


def serving_phase(dev, gpu, cfg, state):
    """Phase 10: the continuous batcher, the small configuration's pool on
    the card against the CPU, and the HTTP API, over one Predictor of the
    full-width weights.  Returns the launches of the pool run and of the
    HTTP requests."""
    import numpy as np
    import torch
    from tsue_tpu_torch.data import make_synthetic_tracks
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    from tsue_tpu_torch.serve import Predictor

    t_phase = time.time()
    greedy = SamplingConfig(do_sample=False)
    m = cfg.model
    pred = Predictor(cfg, state, batch_size=POOL_SLOTS, num_candidates=10,
                     quantize_decode=True, quantize_kv=True, device=dev)
    tracks = make_synthetic_tracks(num_tracks=POOL_TRACKS, track_len=400,
                                   seed=11)
    caps = np.random.default_rng(0).integers(8, 65, POOL_TRACKS)
    reqs, _, width, errs = pred.generation_requests(tracks)
    check(len(reqs) == POOL_TRACKS and not errs, "pool: requests")
    reqs = [dict(r, max_new=int(c)) for r, c in zip(reqs, caps)]
    pool = pred.continuous_batcher(num_slots=POOL_SLOTS, prompt_len=width,
                                   max_new_tokens=64, chunk=POOL_CHUNK,
                                   sampling=greedy)
    t0 = time.time()
    pool_run(pool, reqs[:2])
    print(f"serve pool: predictor + int8 tables + warmup "
          f"{time.time() - t0:.1f}s; prompt width {width}, cache "
          f"{pool.cache_len} slots", flush=True)

    # (a) 48 requests through 16 slots
    reset_counts()
    out, wall = pool_run(pool, reqs)
    counts = read_counts()
    run = dict(pool.last_run)
    lens = [len(o) for o in out]
    check(lens == [int(c) for c in caps], "serve pool: a request did not "
          f"reach its cap: {lens} against {caps.tolist()}")
    expected = pool_expected(m, run)
    print(f"serve pool (greedy, {POOL_SLOTS} slots, chunk {POOL_CHUNK}, "
          f"{POOL_TRACKS} requests, caps 8-64 from seed 0, int8 weights + "
          f"int8 KV): {pool_stats(run, sum(lens), wall)}; gpu: {gpu}",
          flush=True)
    print(f"serve pool: launches {json.dumps(counts)}, expected "
          f"{json.dumps(expected)} (flash = admissions x (L + Q-Former "
          f"calls), int8 = ticks x (7L + 1) + admissions, int8-KV = ticks "
          f"x L)", flush=True)
    check(counts == expected, f"serve pool: launches {counts} != "
                              f"{expected}")
    # three requests alone in a pool of one slot: the same tokens
    solo_pool = pred.continuous_batcher(num_slots=1, prompt_len=width,
                                        max_new_tokens=64, chunk=POOL_CHUNK,
                                        sampling=greedy)
    for i in (0, 17, 40):
        alone, dt = pool_run(solo_pool, [reqs[i]])
        same = np.array_equal(alone[0], out[i])
        print(f"serve pool: request {i} (cap {caps[i]}) alone in one slot "
              f"in {dt:.3f}s, equal to the pool's: {same}", flush=True)
        check(same, f"serve pool: request {i} alone differs from the pool")
    # a sampled request: with its co-traffic in 16 slots and alone
    sampled = SamplingConfig()
    target = dict(reqs[5], generator=torch.Generator().manual_seed(77))
    spool = pred.continuous_batcher(num_slots=POOL_SLOTS, prompt_len=width,
                                    max_new_tokens=64, chunk=POOL_CHUNK,
                                    sampling=sampled)
    traffic = reqs[16:32]
    mixed, dt = pool_run(spool, traffic[:7] + [target] + traffic[7:])
    target["generator"] = torch.Generator().manual_seed(77)
    alone, _ = pool_run(pred.continuous_batcher(
        num_slots=1, prompt_len=width, max_new_tokens=64, chunk=POOL_CHUNK,
        sampling=sampled), [target])
    same = np.array_equal(alone[0], mixed[7])
    print(f"serve pool, sampled (default SamplingConfig, own generator "
          f"seeded 77): 17 requests in {dt:.3f}s; the request alone equal "
          f"to it among 16 others: {same} ({len(alone[0])} tokens, "
          f"{len(np.unique(alone[0]))} distinct)", flush=True)
    check(same, "serve pool: a sampled request alone differs from the "
                "same request among co-traffic")
    # the device's idle share over one admission wave (16 requests)
    _, wall16 = pool_run(pool, reqs[:16])
    profile_device(dev, gpu, "serve pool profile: 16 requests, greedy",
                   wall16, lambda: pool.run(reqs[:16]),
                   totals=("int8_matmul_kernel", "attend_int8_kernel"))
    # the same 48 tracks through the static batcher, trimmed to the caps
    t0 = time.perf_counter()
    pred.generate_context(tracks, max_new_tokens=64, sampling=greedy)
    torch.cuda.synchronize(dev)
    swall = time.perf_counter() - t0
    ids = pred.last_request["ids"]
    c, s, prefill, step_ms = request_stats(pred)
    agree = sum(np.array_equal(ids[i][:caps[i]], out[i])
                for i in range(POOL_TRACKS))
    print(f"serve static (comparison, not a claim): the 48 tracks in "
          f"{c} chunks of {POOL_SLOTS}, {s} decode steps in {swall:.3f}s: "
          f"{sum(lens) / swall:.1f} tokens/s trimmed to the caps "
          f"({POOL_SLOTS * s / swall:.1f} decoded), {step_ms:.3f} ms per "
          f"step, prefill {', '.join(f'{p:.4f}' for p in prefill)} s per "
          f"chunk; {agree} of {POOL_TRACKS} requests' ids equal to the "
          f"pool's; pool / static tokens/s {sum(lens) / wall:.1f} / "
          f"{sum(lens) / swall:.1f}; gpu: {gpu}", flush=True)

    small_pool_phase(dev)
    http_counts = http_phase(dev, gpu, pred)
    del pred, pool, solo_pool, spool
    torch.cuda.empty_cache()
    print(f"serve phase: {time.time() - t_phase:.1f}s in all; gpu: {gpu}",
          flush=True)
    return counts, http_counts


def small_pool_phase(dev):
    """(b) The small configuration's pool, greedy and sampled, with the
    int8 switches and with the fp32 cache: the card's ids equal the CPU's
    (the sampled draws come from the requests' CPU generators on both)."""
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
    tracks = make_synthetic_tracks(num_tracks=6, track_len=400, seed=4)
    for flags in (dict(quantize_decode=True, quantize_kv=True), {}):
        preds = [Predictor(cfg, state, batch_size=4, device=d, **flags)
                 for d in ("cpu", dev)]
        for sampling in (SamplingConfig(do_sample=False), SamplingConfig()):
            ids = []
            for p in preds:
                p.generate_context_batched(tracks, max_new_tokens=16,
                                           seed=3, sampling=sampling,
                                           num_slots=4, chunk=4)
                ids.append(p.last_request["ids"])
            same = all(np.array_equal(a, b) for a, b in zip(*ids))
            what = "sampled" if sampling.do_sample else "greedy"
            print(f"small_pool {sorted(flags) or 'fp32 cache'} {what}: 6 "
                  f"requests through 4 slots, cuda == cpu: {same}",
                  flush=True)
            check(same, f"small pool ({what}, {flags}): the card's ids "
                        "differ from the CPU's")


def http_phase(dev, gpu, pred) -> dict:
    """(c) The serve command's HTTP API (``make_server``) in threads on
    free ports over ``pred``: /healthz, /predict (bit for bit against
    Predictor.predict), /generate through both batchers, a dropped track,
    an unknown path.  Returns the launches of the requests."""
    import argparse
    import threading
    import urllib.error
    import urllib.request
    import numpy as np
    import torch
    from tsue_tpu_torch.cli import serve
    from tsue_tpu_torch.data import make_synthetic_tracks

    args = serve.parser().parse_args([
        "--preset", "test_18_18", "--serve-batch-size", "16",
        "--candidates", "10", "--quantize-decode", "--quantize-kv",
        "--max-new-tokens", "16", "--port", "0"])
    t0 = time.time()
    pred.warmup()
    pred.prepare_generation(args.max_new_tokens)
    pred.prepare_generation(args.max_new_tokens, batched=True)
    print(f"serve http: warmup + prepare_generation (static and continuous, "
          f"widths {pred._serving_widths()}) {time.time() - t0:.1f}s",
          flush=True)
    servers, threads = {}, []
    for batcher in ("static", "continuous"):
        srv = serve.make_server(pred, argparse.Namespace(
            **{**vars(args), "batcher": batcher}))
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        servers[batcher], threads = srv, threads + [th]

    def call(batcher, path, payload=None):
        port = servers[batcher].server_address[1]
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=data,
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                code, body = resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            code, body = e.code, json.loads(e.read())
        dt = time.perf_counter() - t0
        print(f"serve http {batcher} {'POST' if data else 'GET'} {path}: "
              f"{code} in {dt * 1e3:.1f} ms; gpu: {gpu}", flush=True)
        return code, body

    def wire(ts):
        return [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in t.items()} for t in ts]

    tracks = make_synthetic_tracks(num_tracks=4, track_len=400, seed=21)
    short = dict(make_synthetic_tracks(num_tracks=1, seed=22)[0],
                 track_id=99)
    short["raw_trajectory"] = short["raw_trajectory"][:10]
    short["vision_embeddings"] = short["vision_embeddings"][:10]
    ref = pred.predict(tracks)          # what /predict must give
    try:
        reset_counts()
        code, body = call("static", "/healthz")
        check(code == 200 and body["status"] == "ok"
              and body["candidates"] == 10, f"/healthz: {code} {body}")
        code, body = call("static", "/predict", {"tracks": wire(tracks)})
        check(code == 200 and len(body["results"]) == len(ref) > 0,
              f"/predict: {code}, {len(body.get('results', []))} results")
        for got, want in zip(body["results"], ref):
            for key in ("pred_pixel_xy", "candidates_pixel_xy"):
                check(np.array_equal(np.asarray(got[key], np.float32),
                                     want[key]),
                      f"/predict differs from Predictor.predict in {key}")
        print(f"serve http: /predict's {len(ref)} windows equal "
              "Predictor.predict bit for bit", flush=True)
        for batcher in ("static", "continuous"):
            code, body = call(batcher, "/generate",
                              {"tracks": wire(tracks), "max_new_tokens": 16})
            check(code == 200 and len(body["results"]) == 4
                  and all(isinstance(r["context"], str)
                          for r in body["results"]),
                  f"/generate ({batcher}): {code}")
        code, body = call("static", "/predict",
                          {"tracks": wire(tracks[:1] + [short])})
        check(code == 200 and body.get("dropped_track_ids") == [99],
              f"dropped track: {code} {body.get('dropped_track_ids')}")
        code, _ = call("static", "/nope", {})
        check(code == 404, f"unknown path: {code}")
        counts = read_counts()
    finally:
        for srv in servers.values():
            srv.shutdown()
            srv.server_close()
        for th in threads:
            th.join(timeout=60)
    check(not any(th.is_alive() for th in threads), "a server thread lives")
    print(f"serve http: launches {json.dumps(counts)}", flush=True)
    check(counts["flash_attn_fwd"] > 0 and counts["int8_matmul"] > 0
          and counts["attend_int8_kv"] > 0 and counts["lmhead_topk"] == 0,
          f"serve http: launches {counts}")
    torch.cuda.synchronize(dev)
    return counts


# --------------------------------------------------------------------------
# 11. speculative decoding at full width
# --------------------------------------------------------------------------

SPEC_WINDOW = 8          # the static greedy window (Predictor default)
POOL_SPEC_WINDOW = 4     # the sampled pool's (Predictor._spec_window)


def spec_expected(m, chunks: int, forwards: int, int8: bool) -> dict:
    """The launches of a static speculative request: each chunk's prefill
    (flash in every Llama layer and Q-Former call) and first logits (the
    int8 head under int8 weights), then one window forward each (seven
    products a layer and the head: one int8 launch each, B * W <= 128
    rows; the attention over the cache: int8-KV, or flash with the fp32
    cache)."""
    L = m.llama.num_layers
    qformer_calls = m.qformer.num_encoder_layers + \
        2 * m.qformer.num_decoder_layers
    return {"flash_attn_fwd": chunks * (L + qformer_calls)
            + (0 if int8 else forwards * L),
            "int8_matmul": chunks + forwards * (7 * L + 1) if int8 else 0,
            "lmhead_topk": 0, "attend_int8_kv": forwards * L if int8 else 0,
            "rmsnorm": 0, "swiglu_matmul": 0, **dict.fromkeys(NO_PATH, 0)}


def oracle_drafts(ref_ids, prompt_mask, dev):
    """An ``ngram_draft`` stand-in whose drafts are the plain request's own
    ids (``ref_ids`` (B, N), the rows' prompts ``prompt_mask``): every
    draft is right, so every window is accepted whole.  It drives the
    accept path at full width and bounds the speculation win from above."""
    import torch
    ref = torch.as_tensor(ref_ids, device=dev).long()
    plen = torch.as_tensor(prompt_mask, device=dev).sum(1).long()

    def draft(history, history_len, n, width):
        # the window's committed token sits at output position hlen - 1 -
        # plen, its drafts after it
        pos = (history_len - plen)[:, None] + torch.arange(width,
                                                           device=dev)
        return ref.gather(1, pos.clamp_max(ref.shape[1] - 1))
    return draft


def pool_oracle_drafts(pool, reqs, outs, dev):
    """The pool's ``oracle_drafts``: each slot's request, recorded as the
    pool admits it (``pool._admit`` wrapped on the instance; the prompts
    alone may not tell requests apart), proposes its ids from an earlier
    run (``outs``, EOS-trimmed, so EOS follows them).  Returns (draft,
    undo)."""
    import numpy as np
    import torch
    index = {id(r): i for i, r in enumerate(reqs)}
    slot_req = torch.zeros(pool.B, dtype=torch.long, device=dev)
    plen = torch.as_tensor(np.stack([r["prompt_mask"] for r in reqs]),
                           device=dev).sum(1).long()
    ref = np.full((len(outs), max(len(o) for o in outs) + 1), pool.eos_id)
    for i, o in enumerate(outs):
        ref[i, :len(o)] = o
    ref = torch.as_tensor(ref, device=dev).long()
    admit = pool._admit

    def recording_admit(st, slot, req, max_new):
        slot_req[slot] = index[id(req)]
        admit(st, slot, req, max_new)
    pool._admit = recording_admit

    def draft(history, history_len, n, width):
        pos = (history_len - plen[slot_req])[:, None] + torch.arange(
            width, device=dev)
        return ref[slot_req].gather(1, pos.clamp(0, ref.shape[1] - 1))
    return draft, lambda: pool.__dict__.pop("_admit")


def speculative_phase(dev, gpu, cfg, state):
    """Phase 11: static speculative greedy decoding (window 8) with int8
    weights and KV (and, once more, with oracle drafts: every window
    accepted whole) and with fp32 weights and cache, each against the
    plain greedy request on the same 16 tracks, then the sampled pool at
    window 4 against window 1 on phase 10's tracks (and, once more, with
    oracle drafts: the window mode's accept path, where rows advance
    several positions a tick).  Returns the launches of the speculative
    runs."""
    import numpy as np
    import torch
    from tsue_tpu_torch.data import make_synthetic_tracks
    from tsue_tpu_torch.eval import speculative as SP
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    from tsue_tpu_torch.serve import Predictor

    t_phase = time.time()
    B, N = 16, GEN_NEW_TOKENS
    m = cfg.model
    greedy = SamplingConfig(do_sample=False)
    tracks = make_synthetic_tracks(num_tracks=B, track_len=400, seed=1)
    counts = {}
    int8_pred = None
    for what, flags in (("int8 weights + int8 KV",
                         dict(quantize_decode=True, quantize_kv=True)),
                        ("fp32 weights and cache", {})):
        int8 = bool(flags)
        pred = Predictor(cfg, state, batch_size=B, device=dev, **flags)
        # warm both programs (cuBLAS picks, the int8 tables)
        pred.generate_context(tracks, max_new_tokens=8, sampling=greedy)
        pred.generate_context(tracks, max_new_tokens=8, speculative=True)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        pred.generate_context(tracks, max_new_tokens=N, sampling=greedy)
        plain_s = time.perf_counter() - t0
        plain_ids = pred.last_request["ids"].copy()
        _, steps, _, step_ms = request_stats(pred)
        reset_counts()
        t0 = time.perf_counter()
        out = pred.generate_context(tracks, max_new_tokens=N,
                                    speculative=True)
        spec_s = time.perf_counter() - t0
        got = read_counts()
        ids = pred.last_request["ids"]
        chunk = pred.last_request["chunks"][0]
        fwd = chunk["forwards"]
        expected = spec_expected(m, 1, fwd, int8)
        same = float((ids == plain_ids).mean())
        check(len(out) == B and ids.shape == (B, N)
              and len(np.unique(ids)) > B, f"speculative ({what}): output")
        print(f"speculative static, greedy, window {SPEC_WINDOW}, {what}: "
              f"16 tracks x {N} tokens in {spec_s:.3f}s = "
              f"{B * N / spec_s:.1f} tokens/s (plain greedy "
              f"{B * N / plain_s:.1f} tokens/s, {plain_s:.3f}s, {steps} "
              f"steps of {step_ms:.3f} ms); {fwd} window forwards = "
              f"{fwd / N:.3f} forwards per token, "
              f"{chunk['decode_ms'] / fwd:.3f} ms per window forward, "
              f"prefill {chunk['prefill_ms']:.1f} ms (device events); "
              f"share of tokens equal to the plain greedy request's "
              f"{same:.4f}; launches {json.dumps(got)}, expected "
              f"{json.dumps(expected)}; gpu: {gpu}", flush=True)
        check(got == expected, f"speculative ({what}): launches {got} != "
                               f"{expected}")
        if int8:
            # every product on this path computes a row alone
            check(same == 1.0, "speculative (int8): ids differ from the "
                               "plain greedy decode's")
            counts["speculative static, int8 (W8)"] = got
            int8_pred = pred
            # oracle drafts: the accept path, and the win's ceiling
            reqs, _, _, _ = pred.generation_requests(tracks)
            saved = SP.ngram_draft
            SP.ngram_draft = oracle_drafts(
                plain_ids, np.stack([r["prompt_mask"] for r in reqs]), dev)
            try:
                reset_counts()
                t0 = time.perf_counter()
                pred.generate_context(tracks, max_new_tokens=N,
                                      speculative=True)
                oracle_s = time.perf_counter() - t0
                got = read_counts()
            finally:
                SP.ngram_draft = saved
            chunk = pred.last_request["chunks"][0]
            fwd = chunk["forwards"]
            expected = spec_expected(m, 1, fwd, True)
            same = bool(np.array_equal(pred.last_request["ids"], plain_ids))
            print(f"speculative static, greedy, window {SPEC_WINDOW}, "
                  f"{what}, oracle drafts: {B * N / oracle_s:.1f} tokens/s "
                  f"({oracle_s:.3f}s), {fwd} window forwards = "
                  f"{fwd / N:.3f} forwards per token, "
                  f"{chunk['decode_ms'] / fwd:.3f} ms per window forward; "
                  f"ids equal to the plain greedy request's: {same}; "
                  f"launches {json.dumps(got)}, expected "
                  f"{json.dumps(expected)}; gpu: {gpu}", flush=True)
            check(same and fwd == -(-N // SPEC_WINDOW),
                  "speculative (oracle drafts): ids or forwards wrong")
            check(got == expected, f"speculative (oracle): launches {got} "
                                   f"!= {expected}")
            counts["speculative static, int8, oracle drafts (W8)"] = got
        else:
            counts["speculative static, fp32 (W8)"] = got
            del pred
    # the sampled pool at window 4 against window 1 on phase 10's tracks
    pred = int8_pred
    sampled = SamplingConfig()
    ptracks = make_synthetic_tracks(num_tracks=POOL_TRACKS, track_len=400,
                                    seed=11)
    caps = np.random.default_rng(0).integers(8, 65, POOL_TRACKS)
    runs, ticks = {}, {}
    for window, oracle in ((1, False), (POOL_SPEC_WINDOW, False),
                           (POOL_SPEC_WINDOW, True)):
        what = f"window {window}" + (", oracle drafts" if oracle else "")
        reqs, _, width, _ = pred.generation_requests(ptracks)
        reqs = [dict(r, max_new=int(c)) for r, c in zip(reqs, caps)]
        pool = pred.continuous_batcher(num_slots=POOL_SLOTS,
                                       prompt_len=width, max_new_tokens=64,
                                       chunk=POOL_CHUNK, sampling=sampled,
                                       window=window)
        if not oracle:
            pool_run(pool, reqs[:2])
        reqs, _, _, _ = pred.generation_requests(ptracks)
        reqs = [dict(r, max_new=int(c)) for r, c in zip(reqs, caps)]
        saved, undo = SP.ngram_draft, None
        if oracle:
            SP.ngram_draft, undo = pool_oracle_drafts(pool, reqs, runs[1],
                                                      dev)
        try:
            reset_counts()
            out, wall = pool_run(pool, reqs)
            got = read_counts()
        finally:
            SP.ngram_draft = saved
            if undo is not None:
                undo()
        run = dict(pool.last_run)
        tokens = sum(len(o) for o in out)
        expected = pool_expected(m, run)
        slot_ticks = run["mean_live_slots"] * run["ticks"]
        same = sum(np.array_equal(a, b) for a, b in zip(out, runs.get(1,
                                                                      out)))
        print(f"speculative pool, sampled, {what} ({POOL_SLOTS} "
              f"slots, chunk {POOL_CHUNK}, {POOL_TRACKS} requests, caps "
              f"8-64 from seed 0, int8 weights + int8 KV): "
              f"{pool_stats(run, tokens, wall)}; "
              f"{slot_ticks / tokens:.3f} live slot-forwards per token; "
              f"{same} of {POOL_TRACKS} requests' ids equal to window 1's; "
              f"launches {json.dumps(got)}, expected {json.dumps(expected)};"
              f" gpu: {gpu}", flush=True)
        check(got == expected, f"speculative pool ({what}): launches {got} "
                               f"!= {expected}")
        check(same == POOL_TRACKS, f"speculative pool ({what}): ids differ "
                                   "from the window-1 pool's")
        if oracle:
            # every draft is right: rows advance several positions a tick
            check(slot_ticks < tokens and run["ticks"] < ticks[1],
                  f"speculative pool ({what}): {slot_ticks} live "
                  f"slot-forwards for {tokens} tokens, {run['ticks']} "
                  f"ticks against window 1's {ticks[1]}")
            counts[f"speculative pool, sampled, oracle drafts "
                   f"(W{window})"] = got
        else:
            runs[window], ticks[window] = out, run["ticks"]
            if window > 1:
                counts[f"speculative pool, sampled (W{window})"] = got
    del pred, pool, int8_pred
    torch.cuda.empty_cache()
    print(f"speculative phase: {time.time() - t_phase:.1f}s in all; gpu: "
          f"{gpu}", flush=True)
    return counts


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


TRAIN_STATS: dict = {}     # run label -> ms per step, windows/s, peak GiB
# kernel-name fragments whose device time a profiled train step sums: the
# port's kernels, cuBLAS's products (gemm, nvjet, cutlass), and PyTorch's
# elementwise, reduction and copy kernels
STEP_FAMILIES = ("attn_", "rmsnorm", "swiglu", "gemm", "nvjet", "cutlass",
                 "elementwise", "reduce", "Memcpy", "Memset")


def train_phase(dev, gpu, preset: str, bf16: bool = False):
    """A stage-2 trainer of the preset at full Llama-3.2-1B width (fp32, the
    vocabulary of the preset, random weights from the preset's seed) with
    the fused switch on, through the port's entry points: ``make_optimizer``,
    ``make_train_step``, ``make_eval_step``.  ``bf16``: the preset under a
    "bfloat16" ``ModelConfig`` with its parameters cast to bf16, as
    ``runner.build_model_and_params`` casts them; Adam's step is then
    below half an ulp of the larger weights, so a trainable tensor that
    holds no small weight may keep its bits."""
    import dataclasses
    import torch
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.utils.precision import cast_params
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
    label = preset
    if bf16:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    dtype="bfloat16"))
        label = f"{preset} bf16"
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
    if bf16:
        cast_params(model)
    preset = label
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
                       lambda: train_step(state, batches[3]),
                       totals=STEP_FAMILIES)
        check(counts == expected, f"{preset}: launches in 3 steps {counts} "
                                  f"!= {expected}")
        check(all(math.isfinite(x) for x in losses),
              f"{preset}: losses {losses}")
        # frozen parameters bit-identical; trainable ones changed, unless
        # no gradient above Adam's eps reached them (the lane attention's
        # q/k saturate on raw pixel polygons at random init), so that the
        # step and the decay lr * wd are below fp32 resolution.  In bf16 a
        # step of about lr is lost where it is under half an ulp of the
        # weight: a tensor with a gradient may keep its bits only if it
        # holds no weight below 64 lr (where half an ulp is at most lr / 4),
        # as a LayerNorm scale of ones does
        adam = state.optimizer.adamw.state
        unreached, no_grad = [], 0
        for n, p in params.items():
            same = torch.equal(p.detach(), start[n])
            if n not in trainable:
                check(same, f"{preset}: frozen {n} changed")
            elif same:
                moved = adam[p]["exp_avg"].abs().max().item()
                least = start[n].abs().min().item()
                unreached.append(f"{n} (|m| {moved:.3g}, |w| >= {least:.3g})")
                check(moved < 1e-8 or (bf16 and least >= 64 * cfg.train.lr),
                      f"{preset}: trainable {n} got a gradient but did not "
                      f"change (largest |m| {moved}, least |w| {least})")
                no_grad += moved == 0
        check(len(unreached) < len(trainable) // 2,
              f"{preset}: most trainable tensors did not change")
        check(no_grad < len(trainable) // 2,
              f"{preset}: most trainable tensors got no gradient")
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
    TRAIN_STATS[preset] = dict(ms=[t * 1e3 for t in times],
                               windows_s=B / step_s, peak_gib=peak)
    print(f"train {preset}: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms "
          f"per step = {B / step_s:.3f} train windows/s (batch {B}); losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; eval loss "
          f"{float(ev['loss']):.4f}; {len(trainable) - len(unreached)} of "
          f"{len(trainable)} trainable tensors changed (unchanged: "
          f"{unreached if len(unreached) <= 16 else len(unreached)}; "
          f"{no_grad} with a zero gradient); "
          f"repeated step bit-identical; peak memory "
          f"{peak:.2f} GiB; launches per step {json.dumps(per_forward)}; eval "
          f"launches {json.dumps(ev_counts)}; gpu: {gpu}", flush=True)
    del state, model, params, batches, ev
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# 8. stage-1 MLLM fine-tuning at full width
# --------------------------------------------------------------------------

def stage1_batches(cfg, dev, n: int = 6):
    """Stage 1's first ``n`` batches of ``cfg`` (phases 8 and 16): windows
    of 8 synthetic tracks (seed 5) with the byte tokenizer, on ``dev``."""
    from tsue_tpu_torch.data import (BatchIterator, build_windows,
                                     get_tokenizer, make_synthetic_tracks)
    from tsue_tpu_torch.runner import to_device
    tracks = make_synthetic_tracks(num_tracks=8, track_len=600, seed=5)
    ds = build_windows(tracks, cfg.data, get_tokenizer())
    batches = [to_device(b, dev) for _, b in zip(range(n), BatchIterator(
        ds, cfg.train.batch_size, seed=cfg.train.seed,
        length_buckets=cfg.data.length_buckets))]
    check(len(batches) == n, f"stage1: too few windows ({len(ds)})")
    return batches


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
    from tsue_tpu_torch.models.fusion import IGNORE_LABEL, MultiModalLLM
    from tsue_tpu_torch.models.tsue import init_params
    from tsue_tpu_torch.ops.fused import fused_scope
    from tsue_tpu_torch.train.stage1 import (make_stage1_eval_step,
                                             make_stage1_optimizer,
                                             make_stage1_train_step)
    from tsue_tpu_torch.train.trainer import TrainState
    from tsue_tpu_torch.utils.random import step_generator

    cfg = get_preset("train_18_30")
    m, B = cfg.model, cfg.train.batch_size
    L = m.llama.num_layers
    batches = stage1_batches(cfg, dev)
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
        TRAIN_STATS["stage1"] = dict(ms=[t * 1e3 for t in times],
                                     windows_s=B / step_s, peak_gib=peak)
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


# --------------------------------------------------------------------------
# 9. eval from disk at full width
# --------------------------------------------------------------------------

EVAL_TRACKS = 5     # 15 windows a track: train 45, val 15, test 15


def same(x, y) -> bool:
    """Equal nested artifacts, tensors bit for bit."""
    import torch
    if isinstance(x, torch.Tensor):
        return isinstance(y, torch.Tensor) and torch.equal(x, y)
    if isinstance(x, dict):
        return (isinstance(y, dict) and x.keys() == y.keys()
                and all(same(x[k], y[k]) for k in x))
    if isinstance(x, (list, tuple)):
        return (type(x) is type(y) and len(x) == len(y)
                and all(same(a, b) for a, b in zip(x, y)))
    return x == y


def eval_from_disk_phase(dev, gpu):
    """The reference's train-then-test flow through ``run_stage2``, at full
    Llama-3.2-1B width: preset "test_18_18" (scripts/test.py: frozen_mllm,
    batch 16, 18->18, K=10), fp32, the vocabulary resized to the byte
    tokenizer's as ``run_stage2`` resizes it, random weights from the
    preset's seed, synthetic tracks, the fused switch on, under a temporary
    out_dir removed afterwards.  Train 2 epochs with a train state every
    epoch; an interrupted twin (1 epoch, then resumed to 2) must give the
    same test metrics, best artifact and final train state; ``restore_ckpt`` of the best
    artifact with ``epochs=0`` in the fast and the parity mode must give
    the same test_ade and test_fde (and, fast, the same K-candidate
    metrics); ``Predictor.from_checkpoint`` must serve, bit for bit, what a
    Predictor over ``rebuild_for_eval``'s model serves.  Returns the launch
    counts of the two eval runs."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.data import BatchIterator, make_synthetic_tracks
    from tsue_tpu_torch.ops.fused import fused_scope
    from tsue_tpu_torch.runner import (evaluate, rebuild_for_eval,
                                       run_stage2, to_device)
    from tsue_tpu_torch.serve import Predictor
    from tsue_tpu_torch.train import checkpoint as ck
    from tsue_tpu_torch.train.trainer import TrainState, make_optimizer
    from tsue_tpu_torch.utils.random import step_generator

    cfg = get_preset("test_18_18")
    m, B, K = cfg.model, cfg.train.batch_size, cfg.train.eval_num_candidates
    L = m.llama.num_layers
    det = dict(train_forward_launches(L),
               flash_attn_fwd=L + m.lane.num_layers
               + m.qformer.num_encoder_layers
               + 2 * m.qformer.num_decoder_layers + 2)
    stochastic = train_forward_launches(L)   # the Llama's flash alone
    runs = Path(__file__).resolve().parent / "runs"
    runs.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="eval_from_disk_", dir=runs)
    run = dict(synthetic_tracks=EVAL_TRACKS, eval_candidates=K, device=dev)

    def out(name):
        return os.path.join(tmp, name)

    def timed(what, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        metrics = run_stage2(cfg, **run, **kw)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        print(f"eval_from_disk {what}: {json.dumps(metrics)} in {dt:.2f}s",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        return metrics

    def artifact(path):
        return torch.load(os.path.join(path, ck.STATE_FILE),
                          weights_only=True)

    try:
        with fused_scope("on"):
            trained = timed("run_stage2(epochs=2, save_every=1)",
                            out_dir=out("a"), epochs=2, save_every=1)
            timed("twin run_stage2(epochs=1, save_every=1)",
                  out_dir=out("b"), epochs=1, save_every=1)
            resumed = timed("twin run_stage2(epochs=2, resume=True)",
                            out_dir=out("b"), epochs=2, resume=True,
                            save_every=1)
            check(resumed == trained, f"the resumed run's metrics {resumed} "
                                      f"!= the uninterrupted run's {trained}")
            best = os.path.join(out("a"), cfg.name, "ckpt", "best")
            for what in ("best", "state"):
                check(same(*(artifact(os.path.join(out(r), cfg.name, "ckpt",
                                                   what)) for r in "ab")),
                      f"the resumed run's {what} artifact differs")

            counts, restored = {}, {}
            for mode in ("fast", "parity"):
                reset_counts()
                restored[mode] = timed(
                    f"run_stage2(epochs=0, restore_ckpt=<best>, "
                    f"candidate_mode={mode!r})", out_dir=out(f"eval_{mode}"),
                    epochs=0, restore_ckpt=best, candidate_mode=mode)
                counts[mode] = read_counts()
                for key in ("test_ade", "test_fde"):
                    check(restored[mode][key] == trained[key],
                          f"restore_ckpt ({mode}): {key} "
                          f"{restored[mode][key]} != {trained[key]}")
            check(restored["fast"] == trained,
                  f"restore_ckpt (fast): {restored['fast']} != {trained}")

            t0 = time.time()
            model, (dtr, dva, dte) = rebuild_for_eval(
                cfg, None, out("a"), synthetic_tracks=EVAL_TRACKS,
                device=dev)
            n_test = math.ceil(len(dte) / B)
            print(f"eval_from_disk: windows train={len(dtr)} val={len(dva)} "
                  f"test={len(dte)} ({math.ceil(len(dtr) / B)} / "
                  f"{math.ceil(len(dva) / B)} / {n_test} batches of {B}); "
                  f"rebuild_for_eval {time.time() - t0:.1f}s", flush=True)
            for mode in ("fast", "parity"):
                if mode == "fast":
                    # the deterministic forward, then the rollout's context
                    # (every attention but the forecaster's two)
                    per_batch = {k: 2 * v for k, v in det.items()}
                    per_batch["flash_attn_fwd"] -= 2
                else:
                    # the deterministic forward, then K whole stochastic
                    # forwards (the Llama's attention alone has no dropout)
                    per_batch = {k: det[k] + K * stochastic[k] for k in det}
                expected = {k: n_test * v for k, v in per_batch.items()}
                check(counts[mode] == expected,
                      f"eval from disk ({mode}): launches {counts[mode]} != "
                      f"{expected}")
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                again = evaluate(model, dte, cfg, K, mode)
                torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
                check(again == restored[mode],
                      f"evaluate ({mode}) on rebuild_for_eval's model "
                      f"{again} != run_stage2's {restored[mode]}")
                print(f"eval_from_disk {mode} eval: {len(dte)} windows in "
                      f"{dt:.3f}s = {len(dte) / dt:.3f} windows/s (K={K}, "
                      f"batch {B}); peak memory {peak:.2f} GiB; launches "
                      f"{json.dumps(counts[mode])}; gpu: {gpu}", flush=True)
            print("eval_from_disk fast vs parity (printed, not checked: two "
                  "epochs from random weights are not a statistic): "
                  + ", ".join(f"{k} {restored['fast'][k]:.4f} / "
                              f"{restored['parity'][k]:.4f}"
                              for k in ("min_ade", "min_fde", "min_rmse")),
                  flush=True)

            tracks = make_synthetic_tracks(num_tracks=2, track_len=400,
                                           seed=11)
            served = []
            for build in (lambda: Predictor.from_checkpoint(
                              cfg, best, batch_size=B, num_candidates=K,
                              device=dev),
                          lambda: Predictor(
                              cfg.replace(model=model.cfg),
                              model.state_dict(), batch_size=B,
                              num_candidates=K, device=dev)):
                pred = build()
                served.append(pred.predict(
                    tracks, torch.Generator(device=dev).manual_seed(3)))
                del pred
                gc.collect()
                torch.cuda.empty_cache()
            check(len(served[0]) == len(served[1]) > 0
                  and all(np.array_equal(a[key], b[key])
                          for a, b in zip(*served)
                          for key in ("pred_pixel_xy",
                                      "candidates_pixel_xy")),
                  "Predictor.from_checkpoint differs from a Predictor over "
                  "rebuild_for_eval's model")
            print(f"eval_from_disk: Predictor.from_checkpoint == Predictor "
                  f"over rebuild_for_eval's model, bit for bit "
                  f"({len(served[0])} windows, K={K})", flush=True)

            # where a parity candidate's time goes: one stochastic forward
            b = to_device(next(iter(BatchIterator(
                dte, B, shuffle=False,
                length_buckets=cfg.data.length_buckets))), dev)

            @torch.no_grad()
            def candidate():
                model(b, deterministic=False,
                      generator=step_generator(1000, 0, dev))
            candidate()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            candidate()
            torch.cuda.synchronize(dev)
            profile_device(dev, gpu, f"eval_from_disk profile: one parity "
                           f"candidate forward (B{B}, "
                           f"T{m.qformer.num_query_tokens + b['input_ids'].shape[1]})",
                           time.perf_counter() - t0, candidate)

        # the checkpoint files: sizes, and the seconds to save and restore
        state_dir = os.path.join(out("a"), cfg.name, "ckpt", "state")
        tfilter = ck.trainable_filter(model, cfg.train.freeze_regime)
        state = TrainState(model, make_optimizer(cfg, model), cfg.train.seed)
        t0 = time.perf_counter()
        _, extra = ck.restore_train_state(state_dir, state,
                                          trainable_filter=tfilter)
        torch.cuda.synchronize(dev)
        t_restore = time.perf_counter() - t0
        steps = 2 * math.ceil(len(dtr) / B)
        check(state.step == steps and extra["epoch"] == 2,
              f"restored train state: step {state.step} (expected {steps}), "
              f"{extra}")
        t0 = time.perf_counter()
        ck.save_train_state(out("state_copy"), state, trainable_filter=tfilter,
                            **extra)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck.restore_merge(best, model)
        torch.cuda.synchronize(dev)
        t_merge = time.perf_counter() - t0
        mb = {name: os.path.getsize(os.path.join(path, ck.STATE_FILE)) / 1e6
              for name, path in (("trainable subset", best),
                                 ("train state", state_dir))}
        n_sub = sum(t.numel() for t in artifact(best).values())
        print(f"eval_from_disk checkpoints: trainable subset "
              f"{mb['trainable subset']:.2f} MB ({n_sub / 1e6:.2f}M "
              f"parameters), train state {mb['train state']:.2f} MB; "
              f"save_train_state {t_save:.3f}s, restore_train_state "
              f"{t_restore:.3f}s, restore_merge of the subset {t_merge:.3f}s",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# 12. bfloat16 training, remat, the per-epoch text sample
# --------------------------------------------------------------------------

def remat_runs(dev, gpu):
    """``lora_only_18_18`` (batch 8, a backward through every layer, LoRA
    dropout 0.1) at full width, fp32, the fused switch on, without remat and
    under the three policies: one step's loss and gradients, which must
    equal the no-remat step's bit for bit (the recompute replays the
    dropout generator), the launches of its forward and backward (a
    rematerialised layer launches its kernels again in the backward), then
    a warmup and three timed train steps with their peak memory.  Returns
    the launch counts of each run's three steps."""
    import dataclasses
    import torch
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.data import (BatchIterator, build_windows,
                                     get_tokenizer, make_synthetic_tracks)
    from tsue_tpu_torch.models.tsue import TrajectoryModel, init_params
    from tsue_tpu_torch.ops.fused import fused_scope
    from tsue_tpu_torch.runner import to_device
    from tsue_tpu_torch.train.losses import denorm_mse_loss
    from tsue_tpu_torch.train.trainer import (TrainState, make_optimizer,
                                              make_train_step)
    from tsue_tpu_torch.utils.random import step_generator

    base = get_preset("lora_only_18_18")
    B, seed = base.train.batch_size, base.train.seed
    L = base.model.llama.num_layers
    ds = build_windows(make_synthetic_tracks(num_tracks=8, track_len=600,
                                             seed=5), base.data,
                       get_tokenizer())
    batches = [to_device(b, dev) for _, b in zip(range(5), BatchIterator(
        ds, B, seed=seed, length_buckets=base.data.length_buckets))]
    check(len(batches) == 5, f"remat: too few windows ({len(ds)})")
    per_forward = train_forward_launches(L)
    recompute = dict.fromkeys(per_forward, 0)
    recompute.update(flash_attn_fwd=L, rmsnorm=2 * L, swiglu_matmul=L)
    ref, out, summary = None, {}, []
    for policy in (None, "full", "dots", "dots_no_batch"):
        name = policy or "none"
        llama = dataclasses.replace(base.model.llama,
                                    remat=policy is not None,
                                    remat_policy=policy or "full")
        cfg = base.replace(model=dataclasses.replace(base.model,
                                                     llama=llama))
        gc.collect()
        torch.cuda.empty_cache()
        with torch.device(dev):
            model = TrajectoryModel(cfg.model, cfg.data.seq_len,
                                    cfg.data.out_len)
        init_params(model, torch.Generator(device=dev).manual_seed(seed))
        state = TrainState(model, make_optimizer(cfg, model), seed)
        step = make_train_step(cfg)
        with fused_scope("on"):
            reset_counts()
            b = batches[0]
            pred = model(b, deterministic=False,
                         generator=step_generator(seed, 0, dev))
            loss = denorm_mse_loss(pred, b["traj_out"], b["norm_stat"],
                                   b["valid"])
            fwd = read_counts()
            loss.backward()
            torch.cuda.synchronize(dev)
            bwd = {k: v - fwd[k] for k, v in read_counts().items()}
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
            state.optimizer.zero_grad()
            del pred
            check(fwd == per_forward, f"remat {name}: forward launches "
                                      f"{fwd} != {per_forward}")
            want = recompute if policy else dict.fromkeys(per_forward, 0)
            check(bwd == want, f"remat {name}: backward launches {bwd} != "
                               f"{want}")
            if ref is None:
                ref = (loss.detach(), grads)
            else:
                check(torch.equal(loss.detach(), ref[0]),
                      f"remat {name}: loss {float(loss)} != {float(ref[0])}")
                check(grads.keys() == ref[1].keys() and all(
                    torch.equal(g, ref[1][n]) for n, g in grads.items()),
                      f"remat {name}: gradients differ from the plain step's")
            del loss, grads
            step(state, batches[1])                           # warmup
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            times = []
            for b in batches[2:5]:
                t0 = time.perf_counter()
                step(state, b)
                torch.cuda.synchronize(dev)
                times.append(time.perf_counter() - t0)
            counts = read_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        ms = [t * 1e3 for t in times]
        summary.append((name, sum(ms) / 3, peak))
        print(f"remat lora_only_18_18 {name}: {', '.join(f'{t:.1f}' for t in ms)}"
              f" ms per step = {3 * B / sum(times):.3f} train windows/s; "
              f"peak memory {peak:.2f} GiB; flash launches a step "
              f"{fwd['flash_attn_fwd'] + bwd['flash_attn_fwd']} (forward "
              f"{fwd['flash_attn_fwd']}); loss and gradients "
              f"{'the reference' if policy is None else 'equal to no remat'}"
              f"; gpu: {gpu}", flush=True)
        out[f"train lora_only_18_18 remat {name} (3 steps)"] = counts
        del state, model, step
    print("remat summary (policy, ms per step, peak GiB): "
          + json.dumps(summary) + f"; gpu: {gpu}", flush=True)
    del ref, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def stage1_remat_run(dev, gpu):
    """Stage-1 steps of "train_18_30" (lora_only, batch 16, vocabulary
    128256, fp32, the fused switch on) with the Llama rematerialised,
    policy "full": a warmup and two timed steps, their peak memory against
    phase 8's.  Returns the two steps' launch counts."""
    import dataclasses
    import torch
    from tsue_tpu_torch.config import get_preset
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

    cfg = get_preset("train_18_30")
    m, B = cfg.model, cfg.train.batch_size
    L = m.llama.num_layers
    ds = build_windows(make_synthetic_tracks(num_tracks=8, track_len=600,
                                             seed=5), cfg.data,
                       get_tokenizer())
    batches = [to_device(b, dev) for _, b in zip(range(3), BatchIterator(
        ds, B, seed=cfg.train.seed, length_buckets=cfg.data.length_buckets))]
    llama = dataclasses.replace(m.llama, remat=True, remat_policy="full")
    with torch.device(dev):
        mllm = MultiModalLLM(llama, m.qformer, m.use_vision)
    init_params(mllm, torch.Generator(device=dev).manual_seed(cfg.train.seed))
    state = TrainState(mllm, make_stage1_optimizer(cfg, mllm), cfg.train.seed)
    step = make_stage1_train_step()
    with fused_scope("on"):
        step(state, batches[0], step_generator(0, 0, dev))    # warmup
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        times, losses = [], []
        for i, b in enumerate(batches[1:3], 1):
            t0 = time.perf_counter()
            losses.append(float(step(state, b, step_generator(0, i, dev))
                                ["lm_loss"]))
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    want = {k: 2 * v for k, v in train_forward_launches(L).items()}
    for k in ("flash_attn_fwd", "swiglu_matmul"):
        want[k] += 2 * L
    want["rmsnorm"] += 2 * 2 * L
    check(counts == want, f"stage1 remat: launches {counts} != {want}")
    check(all(math.isfinite(x) and x > 0 for x in losses),
          f"stage1 remat: losses {losses}")
    dense = TRAIN_STATS.get("stage1", {})
    print(f"stage1 train_18_30 remat full: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms per step "
          f"(phase 8 without remat: "
          f"{', '.join(f'{t:.1f}' for t in dense.get('ms', []))}); peak "
          f"memory {peak:.2f} GiB (phase 8: {dense.get('peak_gib', 0):.2f} "
          f"GiB); losses {losses}; launches in 2 steps {json.dumps(counts)};"
          f" gpu: {gpu}", flush=True)
    del state, mllm, batches
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def bf16_checkpoint_request(dev, gpu):
    """``run_stage2`` of "test_18_18" under a "bfloat16" ``ModelConfig`` at
    full width (bf16 parameters and moments; the vocabulary resized to the
    byte tokenizer's; 5 synthetic tracks, one epoch), its best artifact
    (bf16 leaves) served by ``Predictor.from_checkpoint`` for a K=10
    request: fp32 parameters, as the JAX package restores into its fp32
    init, so every kernel takes its fp32 form (the configuration rounds
    the Llama's weights per call), flash launched as phase 5's request
    launches it and nothing else; the request must equal, bit for bit, a
    ``Predictor`` over the same merged state in fp32.  Returns the
    request's launch counts."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.data import get_tokenizer, make_synthetic_tracks
    from tsue_tpu_torch.ops.fused import fused_scope
    from tsue_tpu_torch.runner import build_model_and_params, run_stage2
    from tsue_tpu_torch.serve import Predictor
    from tsue_tpu_torch.train.checkpoint import STATE_FILE, restore_merge

    cfg = get_preset("test_18_18")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype="bfloat16"))
    runs = Path(__file__).resolve().parent / "runs"
    runs.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="bf16_ckpt_", dir=runs)
    try:
        t0 = time.perf_counter()
        with fused_scope("on"):
            metrics = run_stage2(cfg, out_dir=tmp, epochs=1,
                                 synthetic_tracks=EVAL_TRACKS, device=dev)
        train_s = time.perf_counter() - t0
        best = os.path.join(tmp, cfg.name, "ckpt", "best")
        stored = torch.load(os.path.join(best, STATE_FILE),
                            weights_only=True)
        check(stored and {v.dtype for v in stored.values()}
              == {torch.bfloat16}, "bf16 checkpoint: artifact dtypes")
        gc.collect()
        torch.cuda.empty_cache()
        tracks = make_synthetic_tracks(num_tracks=2, track_len=600, seed=9)
        kw = dict(device=dev, batch_size=16, num_candidates=10)
        served = Predictor.from_checkpoint(cfg, best, **kw)
        check({p.dtype for p in served.model.parameters()}
              == {torch.float32}, "bf16 checkpoint: served dtypes")
        reset_counts()
        t0 = time.perf_counter()
        got = served.predict(tracks)
        torch.cuda.synchronize(dev)
        req_s = time.perf_counter() - t0
        counts = read_counts()
        del served
        gc.collect()
        want_counts = dict.fromkeys(KERNELS, 0)
        want_counts["flash_attn_fwd"] = math.ceil(len(got) / 16) * sum(
            predict_flash_calls(cfg.model))
        check(counts == want_counts, f"bf16 checkpoint: launches {counts} "
                                     f"!= {want_counts}")
        cfg32 = cfg.replace(model=dataclasses.replace(cfg.model,
                                                      dtype="float32"))
        model = build_model_and_params(cfg32, get_tokenizer(), dev)
        check({p.dtype for p in model.parameters()} == {torch.float32},
              "bf16 checkpoint: build_model_and_params dtypes in fp32")
        restore_merge(best, model)
        state = model.state_dict()
        model_cfg = dataclasses.replace(model.cfg, dtype="bfloat16")
        del model
        gc.collect()
        direct = Predictor(cfg.replace(model=model_cfg), state, **kw)
        want = direct.predict(tracks)
        del direct, state
        check(len(got) == len(want) > 0 and all(
            np.array_equal(a[k], b[k]) for a, b in zip(got, want)
            for k in ("pred_pixel_xy", "candidates_pixel_xy")),
              "bf16 checkpoint: from_checkpoint differs from Predictor over "
              "the merged state in fp32")
        print(f"bf16 checkpoint: run_stage2 test_18_18 bf16 1 epoch "
              f"{json.dumps(metrics)} in {train_s:.1f}s; from_checkpoint "
              f"(fp32 parameters, fp32 kernel forms) request of {len(got)} "
              f"windows (K=10) in {req_s:.2f}s, equal to Predictor(cfg, "
              f"state) over the merged state in fp32; launches "
              f"{json.dumps(counts)}; gpu: {gpu}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def text_sample_run(dev, gpu):
    """The per-epoch text sample (``runner._epoch_text_sample``) of the
    small configuration built as ``run_stage2`` builds it (bf16
    parameters): the MLLM's sampled decode in bf16, twice from
    ``step_generator(777, 0)``, equal texts.  Returns its launch
    counts."""
    import torch
    from tsue_tpu_torch.data import get_tokenizer
    from tsue_tpu_torch.runner import (_batches, _epoch_text_sample,
                                       build_model_and_params, prepare_data,
                                       to_device)
    from tsue_tpu_torch.utils.random import step_generator
    cfg = small_cfg()
    tok = get_tokenizer()
    _, dva, _ = prepare_data(cfg, None, tok, synthetic_tracks=6)
    model = build_model_and_params(cfg, tok, dev)
    check({p.dtype for p in model.parameters()} == {torch.bfloat16},
          "text sample: parameters not bf16")
    vb = to_device(next(iter(_batches(dva, cfg, False))), dev)
    reset_counts()
    t0 = time.perf_counter()
    texts = [_epoch_text_sample(model, tok, vb, step_generator(777, 0, dev))
             for _ in range(2)]
    dt = (time.perf_counter() - t0) / 2
    counts = read_counts()
    check(texts[0] == texts[1], "text sample: a repeated sample differs")
    check(counts["flash_attn_fwd"] > 0, "text sample: no flash launch")
    print(f"text sample (small config, bf16 MLLM, 48 new tokens): "
          f"{dt:.2f}s a sample, repeat equal, {len(texts[0])} characters; "
          f"launches in two samples {json.dumps(counts)}; gpu: {gpu}",
          flush=True)
    del model
    torch.cuda.empty_cache()
    return counts


def bf16_remat_phase(dev, gpu):
    """Phase 12: bf16 training of "train_18_30" beside phase 7's fp32
    numbers, remat of "lora_only_18_18" under each policy, stage 1 with
    remat, a bf16 checkpoint served, the text sample.  Returns launch
    counts by run."""
    import torch
    t_phase = time.time()
    counts = {"train train_18_30 bf16 (3 steps)": train_phase(
        dev, gpu, "train_18_30", bf16=True)}
    f32 = TRAIN_STATS.get("train_18_30", dict(windows_s=float("nan"),
                                              peak_gib=float("nan")))
    b16 = TRAIN_STATS["train_18_30 bf16"]
    print(f"train_18_30 bf16 steps: "
          f"{', '.join(f'{t:.1f}' for t in b16['ms'])} ms (with the "
          f"earlier mma.sync SwiGLU and fp32-FMA flash forms: 94.8-110.8 ms "
          f"steady on an H100 80GB HBM3 at 700 W); gpu: {gpu}", flush=True)
    print(f"train_18_30 bf16 against fp32 (phase 7): "
          f"{b16['windows_s']:.3f} against {f32['windows_s']:.3f} train "
          f"windows/s ({b16['windows_s'] / f32['windows_s']:.3f}x); peak "
          f"memory {b16['peak_gib']:.2f} against {f32['peak_gib']:.2f} GiB; "
          f"gpu: {gpu}", flush=True)
    torch.cuda.empty_cache()
    counts.update(remat_runs(dev, gpu))
    counts["stage1 train_18_30 remat full (2 steps)"] = stage1_remat_run(
        dev, gpu)
    counts["predict from a bf16 checkpoint (K=10)"] = \
        bf16_checkpoint_request(dev, gpu)
    counts["epoch text sample (small, bf16)"] = text_sample_run(dev, gpu)
    print(f"bf16 and remat phase: {time.time() - t_phase:.1f}s in all; "
          f"gpu: {gpu}", flush=True)
    return counts


# --------------------------------------------------------------------------
# 13. the comparison models: the seven baselines and the DDPM generator
# --------------------------------------------------------------------------

BASELINE_PRESET = "ablation_no_llm"      # 6 -> 30, batch 16
DIFFUSION_PRESET = "mllm_free_18_18"     # 18 -> 18, batch 16 (32 UNet rows)
CANDIDATES = 10
DIFFUSION_EPOCHS = 3
REVERSE_STEPS = 1000
DDPM_SAMPLES = 5                         # 5 + 5 chains: [uncond || cond]


def _after(model):
    return ({n: p.detach().cpu() for n, p in model.named_parameters()},
            {n: p.grad.abs().cpu() for n, p in model.named_parameters()})


def small_comparison_phase(dev):
    """Phase 13 (a): the comparison models at their own widths on a small
    batch (8 windows), the card against the CPU from the same weights: one
    train step of CS-LSTM, Social-LSTM, STGCNN (with its running
    statistics) and MMTrans (dropout 0, so its attention is the kernel's),
    GAIL's D-then-G step, Trajectron's deterministic loss (z = mu, + 0.1
    KL) and its gradients (its train step draws the latent from the
    device's own generator); the DDPM UNet's CFG forward and one reverse
    step with a given z (atol 1e-5, the CPU tests' forward tolerance)."""
    import numpy as np
    import torch
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.data import BatchIterator
    from tsue_tpu_torch.models import baselines as bl
    from tsue_tpu_torch.models.baselines.trajectron import kl_divergence
    from tsue_tpu_torch.models.diffusion import (ConditionalUNet,
                                                 DDPMSchedule, p_sample_step)
    from tsue_tpu_torch.models.tsue import init_params
    from tsue_tpu_torch.runner import _no_text_cfg, prepare_data, to_device
    from tsue_tpu_torch.train.baseline_steps import (make_baseline_train_step,
                                                     make_gail_train_step)
    from tsue_tpu_torch.train.losses import denorm_mse_loss

    cfg = _no_text_cfg(get_preset(BASELINE_PRESET))
    lr, wd = cfg.train.lr, cfg.train.weight_decay
    T_in, T_out = cfg.data.seq_len, cfg.data.out_len
    dtr, _, _ = prepare_data(cfg, None, None, 3)
    batch = next(iter(BatchIterator(dtr, 8, shuffle=False)))

    def seeded(module, seed):
        return init_params(module, torch.Generator().manual_seed(seed))

    for name in ("cs_lstm", "social_lstm", "stgcnn", "mmtrans"):
        kw = dict(dropout=0.0) if name == "mmtrans" else {}
        base = seeded(bl.BASELINE_REGISTRY[name](seq_len=T_in, out_len=T_out,
                                                 **kw), 1)
        start = {n: p.detach().clone() for n, p in base.named_parameters()}
        runs, stats = [], []
        for d in ("cpu", dev):
            m = copy.deepcopy(base).to(d)
            step = make_baseline_train_step(m, torch.optim.AdamW(
                m.parameters(), lr=lr, weight_decay=wd, eps=1e-8))
            reset_counts()
            loss = float(step(to_device(batch, d),
                              torch.Generator(device=d).manual_seed(0))
                         ["loss"])
            counts = read_counts()
            params, grads = _after(m)
            runs.append((loss, params, grads, counts))
            stats.append({n: b.cpu() for n, b in m.named_buffers()})
        want = 4 if name == "mmtrans" else 0     # one per encoder layer
        check(counts["flash_attn_fwd"] == want
              and sum(counts.values()) == want,
              f"small {name} step: launches {counts}")
        worst = step_parity(f"small {name} step", start, runs, lr)
        for n, b in stats[0].items():
            check(torch.allclose(stats[1][n], b, rtol=0, atol=1e-5),
                  f"small {name} step: buffer {n} differs")
        print(f"small {name} train step: loss cuda {runs[1][0]} cpu "
              f"{runs[0][0]}; parameters max abs diff {worst} on "
              f"well-conditioned elements (tol 2e-6)", flush=True)

    # GAIL: D's step, then G's against the updated D
    gen0 = seeded(bl.GAILGenerator(T_in, T_out), 1)
    disc0 = seeded(bl.GAILDiscriminator(T_in, T_out), 2)
    start = {f"{side}.{n}": p.detach().clone()
             for side, mod in (("g", gen0), ("d", disc0))
             for n, p in mod.named_parameters()}
    runs, d_losses = [], []
    for d in ("cpu", dev):
        gen, disc = copy.deepcopy(gen0).to(d), copy.deepcopy(disc0).to(d)
        m = make_gail_train_step(
            gen, disc, torch.optim.Adam(gen.parameters(), lr=lr),
            torch.optim.Adam(disc.parameters(), lr=lr))(to_device(batch, d))
        (gp, gg), (dp, dg) = _after(gen), _after(disc)
        runs.append((float(m["g_loss"]),
                     {**{f"g.{n}": v for n, v in gp.items()},
                      **{f"d.{n}": v for n, v in dp.items()}},
                     {**{f"g.{n}": v for n, v in gg.items()},
                      **{f"d.{n}": v for n, v in dg.items()}}, None))
        d_losses.append(float(m["d_loss"]))
    check(abs(d_losses[1] - d_losses[0]) <= 1e-4 * abs(d_losses[0]),
          f"small gail step: d_loss {d_losses[1]} on the card, "
          f"{d_losses[0]} on the CPU")
    worst = step_parity("small gail step", start, runs, lr)
    print(f"small gail train step: g_loss cuda {runs[1][0]} cpu {runs[0][0]},"
          f" d_loss cuda {d_losses[1]} cpu {d_losses[0]}; parameters max abs "
          f"diff {worst} (tol 2e-6)", flush=True)

    # Trajectron: the deterministic loss and its gradients
    base = seeded(bl.TrajectronPP(T_in, T_out), 1)
    out = []
    for d in ("cpu", dev):
        m = copy.deepcopy(base).to(d)
        b = to_device(batch, d)
        pred, (mu, logvar) = m(b, return_latent=True)
        loss = denorm_mse_loss(pred, b["traj_out"], b["norm_stat"],
                               b["valid"]) + 0.1 * kl_divergence(mu, logvar)
        loss.backward()
        out.append((float(loss.detach()), {n: p.grad.cpu()
                                  for n, p in m.named_parameters()}))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out
    check(abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu),
          f"small trajectron: loss {l_gpu} on the card, {l_cpu} on the CPU")
    for n, r in g_cpu.items():
        check(torch.allclose(g_gpu[n], r, rtol=1e-4,
                             atol=1e-4 * r.abs().max().item() + 1e-4),
              f"small trajectron: gradient {n} differs")
    print(f"small trajectron deterministic loss: cuda {l_gpu} cpu {l_cpu}; "
          "gradients within rtol 1e-4", flush=True)

    # the DDPM UNet's CFG forward and one reverse step with a given z
    unet = seeded(ConditionalUNet(), 3)
    sched = DDPMSchedule.create("cosine", REVERSE_STEPS)
    g = torch.Generator().manual_seed(5)
    x, z = (torch.randn(8, 2, 18, generator=g) for _ in range(2))
    cond = torch.randn(8, 128, generator=g)
    res = []
    for d in ("cpu", dev):
        m = copy.deepcopy(unet).to(d)
        with torch.no_grad():
            res.append([m(x.to(d), cond.to(d)).cpu()] + [
                p_sample_step(m, sched, x.to(d), t, cond.to(d), z.to(d)).cpu()
                for t in (REVERSE_STEPS // 2, 0)])
    for what, a, c in zip(("cfg forward",
                           f"reverse step t={REVERSE_STEPS // 2}",
                           "reverse step t=0"), res[1], res[0]):
        err = (a - c).abs().max().item()
        check(bool(torch.isfinite(a).all()) and err <= 1e-5,
              f"small ddpm {what}: card vs CPU max abs diff {err}")
        print(f"small ddpm {what}: card vs CPU max abs diff {err} (tol "
              "1e-5)", flush=True)


def baseline_runs(dev, gpu) -> dict:
    """Phase 13 (b): ``run_baseline`` of all seven names at their own widths
    (preset "ablation_no_llm", 2 epochs, no candidates: the card's machine
    has no matplotlib for the candidate plot), the test metrics checked,
    the rates read from the run's own metrics stream (the second epoch's
    train windows/s and ms a step, the test's eval windows/s, to the
    stream's millisecond); then the test pass timed alone, as
    ``run_baseline``'s test loop runs it: cv's K = 10 candidates, and for
    the five registry models (fresh weights from seed 0) the deterministic
    forwards alone (K = 0) and with the K = 10 candidates of
    ``make_baseline_eval_fn``: windows/s, STGCNN's running statistics
    unchanged, MMTrans's flash launches 4 a deterministic batch and none in
    the dropout passes.  Returns the launch counts by run."""
    import shutil
    import numpy as np
    import torch
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.eval.metrics import min_ade_fde_rmse
    from tsue_tpu_torch.models import baselines as bl
    from tsue_tpu_torch.models.tsue import init_params
    from tsue_tpu_torch.runner import (_batches, _no_text_cfg, prepare_data,
                                       run_baseline, to_device)
    from tsue_tpu_torch.train.baseline_steps import make_baseline_eval_fn

    cfg = get_preset(BASELINE_PRESET)
    bs = cfg.train.batch_size
    dtr, _, dte = prepare_data(_no_text_cfg(cfg), None, None, 40)
    steps, test_batches = -(-len(dtr) // bs), -(-len(dte) // bs)
    out_dir = Path(__file__).resolve().parent / "runs" / "chip_smoke_comparison"
    shutil.rmtree(out_dir, ignore_errors=True)
    all_counts = {}
    for name in bl.BASELINE_NAMES:
        reset_counts()
        t0 = time.time()
        metrics = run_baseline(name, cfg, out_dir=str(out_dir), epochs=2,
                               device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        want = ({"test_ade", "test_fde", "min_ade", "min_fde", "min_rmse",
                 "K"} if name == "cv" else {"test_ade", "test_fde"})
        check(set(metrics) == want
              and all(np.isfinite(v) for v in metrics.values()),
              f"run_baseline {name} on the card: {metrics}")
        expected = dict.fromkeys(KERNELS, 0)
        expected["flash_attn_fwd"] = 4 * test_batches if name == "mmtrans" \
            else 0
        check(counts == expected, f"run_baseline {name}: launches {counts} "
                                  f"!= {expected}")
        for k, v in counts.items():
            all_counts[k] = all_counts.get(k, 0) + v
        log = [json.loads(line) for line in
               (out_dir / f"baseline_{name}" / "metrics.jsonl").open()]
        if name == "cv":
            rates = "no training"
        else:
            train_s = log[1]["t"] - log[0]["t"]
            eval_s = log[2]["t"] - log[1]["t"]
            rates = (f"train {steps * bs / train_s:.1f} windows/s, "
                     f"{train_s / steps * 1e3:.2f} ms/step (the second "
                     f"epoch's {steps} steps of {bs}); eval "
                     f"{len(dte) / eval_s:.1f} windows/s ({len(dte)} test "
                     f"windows, {test_batches} batches)")
        print(f"run_baseline {name} ({BASELINE_PRESET}, 2 epochs): "
              f"{json.dumps(metrics)}; {rates}; {wall:.1f}s in all; "
              f"launches {json.dumps(counts)}; gpu: {gpu}", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)

    # the test pass at K = 0 (run_baseline's eval) and K = 10, timed alone
    ecfg = _no_text_cfg(cfg)
    from tsue_tpu_torch.ops.flash import flash_attention

    def timed(fn):
        fn()                                           # warm-up
        reset_counts()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0, read_counts()

    def cv_pass():
        with torch.no_grad():
            for i, batch in enumerate(_batches(dte, ecfg, False)):
                b = to_device(batch, dev)
                cands = bl.cv_candidates(
                    b["traj_in"], cfg.data.out_len,
                    torch.Generator(device=dev).manual_seed(i), CANDIDATES)
                min_ade_fde_rmse(cands, b["traj_out"], b["norm_stat"],
                                 b["valid"])
    _, dt, _ = timed(cv_pass)
    print(f"cv K={CANDIDATES} test pass (cv_candidates, {len(dte)} test "
          f"windows): {len(dte) / dt:.1f} windows/s; gpu: {gpu}", flush=True)
    cand_counts = dict.fromkeys(KERNELS, 0)
    for name, cls in bl.BASELINE_REGISTRY.items():
        model = cls(seq_len=cfg.data.seq_len, out_len=cfg.data.out_len)
        model = init_params(model.to(dev),
                            torch.Generator(device=dev).manual_seed(0))
        eval_fn = make_baseline_eval_fn(model)
        before = {n: b.clone() for n, b in model.named_buffers()}

        def test_pass(K):
            """run_baseline's test loop: the deterministic forward and,
            with K, the K candidates; (flash launches of the forwards, of
            the candidates)."""
            det = drop = 0
            sums = []
            with torch.no_grad():
                for i, batch in enumerate(_batches(dte, ecfg, False)):
                    b = to_device(batch, dev)
                    c0 = flash_attention.launches
                    model(b)
                    c1 = flash_attention.launches
                    det += c1 - c0
                    if K:
                        cands = eval_fn(b, torch.Generator(device=dev)
                                        .manual_seed(100 + i), K)
                        drop += flash_attention.launches - c1
                        sums.append(min_ade_fde_rmse(
                            cands, b["traj_out"], b["norm_stat"], b["valid"]))
            if K:
                check(tuple(cands.shape) == (bs, K, 2, cfg.data.out_len)
                      and all(math.isfinite(float(x)) for s in sums
                              for x in s),
                      f"{name} K={K} candidates: {tuple(cands.shape)}")
            return det, drop
        _, det_s, _ = timed(lambda: test_pass(0))
        (det, drop), dt, counts = timed(lambda: test_pass(CANDIDATES))
        for k, v in counts.items():
            cand_counts[k] += v
        for n, b in model.named_buffers():
            check(torch.equal(b, before[n]),
                  f"{name}: buffer {n} changed by the candidate eval")
        want_det = 4 * test_batches if name == "mmtrans" else 0
        check(det == want_det and drop == 0,
              f"{name} K={CANDIDATES}: flash launches {det} in the "
              f"deterministic forwards (want {want_det}), {drop} in the "
              "dropout passes (want 0)")
        print(f"{name} test pass ({len(dte)} test windows, {test_batches} "
              f"batches of {bs}): K=0 {len(dte) / det_s:.1f} windows/s; "
              f"K={CANDIDATES} (make_baseline_eval_fn) {len(dte) / dt:.1f} "
              f"windows/s, {dt / test_batches * 1e3:.2f} ms a batch; flash "
              f"launches {det} in the deterministic forwards, {drop} in the "
              f"dropout passes; buffers unchanged; gpu: {gpu}", flush=True)
    return {f"baselines: run_baseline x{len(bl.BASELINE_NAMES)} "
            f"({BASELINE_PRESET}, 2 epochs)": all_counts,
            f"baselines: K={CANDIDATES} candidate eval x"
            f"{len(bl.BASELINE_REGISTRY)}": cand_counts}


def diffusion_runs(dev, gpu) -> dict:
    """Phase 13 (c): the DDPM generator at its own width (UNet 64 channels,
    1000 timesteps, preset "mllm_free_18_18": batch 16, so 32 UNet rows a
    step) through the functions ``run_diffusion`` calls: three epochs of
    ``make_diffusion_train_step`` (ms a step over the last two, one flash
    launch a step, the EMA copy moved), then ``p_sample_loop`` with the EMA
    weights, 5 + 5 chains of 1000 steps (ms a reverse step, exactly 1000
    flash launches, values in [-1, 1], peak memory), the same chain again
    (bit-identical), and the idle share of a profiled 50-step stretch.
    Returns the launch counts by run."""
    import torch
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.models.diffusion import (ConditionalUNet,
                                                 DDPMSchedule,
                                                 make_diffusion_train_step,
                                                 p_sample_loop, p_sample_step)
    from tsue_tpu_torch.models.tsue import init_params
    from tsue_tpu_torch.runner import _batches, _no_text_cfg, prepare_data
    from tsue_tpu_torch.utils.random import step_generator

    cfg = _no_text_cfg(get_preset(DIFFUSION_PRESET))
    dtr, _, _ = prepare_data(cfg, None, None, 40)
    model = init_params(ConditionalUNet().to(dev),
                        torch.Generator(device=dev).manual_seed(0))
    ema = copy.deepcopy(model).requires_grad_(False)
    ema0 = [p.clone() for p in ema.parameters()]
    sched = DDPMSchedule.create("cosine", REVERSE_STEPS)
    step = make_diffusion_train_step(
        model, sched, torch.optim.Adam(model.parameters(), lr=1e-4,
                                       weight_decay=1e-4), ema)
    reset_counts()
    n_steps, timed_steps, losses = 0, 0, []
    t_timed = None
    for epoch in range(DIFFUSION_EPOCHS):
        if epoch == 1:
            torch.cuda.synchronize()
            t_timed = time.time()
        for i, batch in enumerate(_batches(dtr, cfg, True, epoch)):
            x0 = torch.from_numpy(batch["traj_out"]).to(dev) * 2.0 - 1.0
            cond = torch.zeros(x0.shape[0], 128, device=dev)
            losses.append(step(x0, cond, step_generator(epoch, i, dev))
                          ["loss"])
            n_steps += 1
            timed_steps += epoch >= 1
    torch.cuda.synchronize()
    ms_step = (time.time() - t_timed) / timed_steps * 1e3
    train_counts = read_counts()
    losses = [float(x) for x in losses]
    expected = dict.fromkeys(KERNELS, 0)
    expected["flash_attn_fwd"] = n_steps
    check(train_counts == expected,
          f"ddpm train: launches {train_counts} != {expected}")
    check(all(math.isfinite(x) for x in losses)
          and not all(torch.equal(a, b) for a, b in
                      zip(ema.parameters(), ema0)),
          "ddpm train: non-finite loss or the EMA copy did not move")
    rows = 2 * cfg.train.batch_size
    print(f"ddpm train ({DIFFUSION_PRESET}, UNet 64 ch, {rows} rows a "
          f"step): {n_steps} steps in {DIFFUSION_EPOCHS} epochs, "
          f"{ms_step:.2f} ms/step over the last {timed_steps}, "
          f"{cfg.train.batch_size * 1e3 / ms_step:.1f} windows/s; loss "
          f"{losses[0]:.4f} -> mean of the last epoch "
          f"{sum(losses[-timed_steps // 2:]) / (timed_steps // 2):.4f}; "
          f"flash launches {train_counts['flash_attn_fwd']} (one a step); "
          f"gpu: {gpu}", flush=True)

    n = 2 * DDPM_SAMPLES
    shape = (n, 2, cfg.data.out_len)
    cond = torch.zeros(n, 128, device=dev)

    def chain():
        return p_sample_loop(ema, sched, shape, cond,
                             torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.time()
    first = chain()
    torch.cuda.synchronize()
    wall = time.time() - t0
    sample_counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    expected = dict.fromkeys(KERNELS, 0)
    expected["flash_attn_fwd"] = REVERSE_STEPS
    check(sample_counts == expected,
          f"ddpm sampling: launches {sample_counts} != {expected}")
    again = chain()
    check(torch.equal(first, again), "ddpm sampling: the same generator "
                                     "gave another chain")
    check(bool(torch.isfinite(first).all())
          and first.abs().max().item() <= 1.0 + 1e-6,
          "ddpm sampling: values outside [-1, 1] or not finite")
    print(f"ddpm sampling ({DDPM_SAMPLES} + {DDPM_SAMPLES} chains of "
          f"{REVERSE_STEPS} steps, the EMA weights): {wall:.3f}s, "
          f"{wall / REVERSE_STEPS * 1e3:.3f} ms a reverse step; flash "
          f"launches {sample_counts['flash_attn_fwd']}; a repeated chain "
          f"bit-identical; peak memory {peak:.1f} MiB; gpu: {gpu}",
          flush=True)

    g = torch.Generator(device=dev).manual_seed(11)

    def stretch():
        x = first
        with torch.no_grad():
            for t in range(REVERSE_STEPS - 1, REVERSE_STEPS - 51, -1):
                z = torch.randn(shape, generator=g, device=dev)
                x = p_sample_step(ema, sched, x, t, cond, z)
        return x
    stretch()
    torch.cuda.synchronize()
    t0 = time.time()
    stretch()
    torch.cuda.synchronize()
    profile_device(dev, gpu, "ddpm reverse chain, 50 steps",
                   time.time() - t0, stretch)
    return {f"ddpm train ({DIFFUSION_EPOCHS} epochs)": train_counts,
            f"ddpm sampling ({REVERSE_STEPS} steps)": sample_counts}


def comparison_phase(dev, gpu) -> dict:
    """Phase 13: (a) the small configuration, card against CPU; (b) the
    seven baselines at full width; (c) the DDPM generator at full width.
    Returns the launch counts by run."""
    t_phase = time.time()
    small_comparison_phase(dev)
    counts = baseline_runs(dev, gpu)
    counts.update(diffusion_runs(dev, gpu))
    print(f"comparison models phase: {time.time() - t_phase:.1f}s in all; "
          f"gpu: {gpu}", flush=True)
    return counts


# --------------------------------------------------------------------------
# 14. the bf16 quantised decode and its quality study
# --------------------------------------------------------------------------

QQ_BATCH, QQ_PROMPT, QQ_NEW = 16, 144, 64     # the JAX script's defaults
QQ_TOP1_FLOOR = 0.90          # teacher-forced top-1 agreement, every mode
QQ_TIE_BOUND = 1e-3           # a greedy divergence's top-2 logit gap
QQ_WITNESS_BOUND = 0.01       # |top-1, kernel - top-1, plain int8 product|
QQ_CACHE = 16 + QQ_PROMPT + QQ_NEW    # 16 image tokens + prompt + decode


def _bf16_ulp_err(out, ref):
    """(max abs err, the largest error in bf16 ulps of each output, with
    the floor of 1e-6 of the largest output where an output cancels)."""
    import torch
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    ulp = torch.exp2(torch.floor(torch.log2(r.clamp_min(1e-30))) - 7)
    return d.max().item(), (d / (ulp + 1e-6 * r.max())).max().item()


def bf16_decode_kernel_checks(dev, gpu, timer, split):
    """The bf16 forms at the shapes phase 14 launches: the int8 product on
    bf16 x at the seven projections of a decode step (bf16 out) and the LM
    head (fp32 out), M = 16; the int8-KV attention on bf16 q over the
    phase's cache (B 16, 32/8 heads of 64, S 224, a prefix and a decode
    step); the fused head on bf16 h over the int8 head and over the tied
    bf16 embedding (B 16, D 2048, V 128256, the penalty and the ban), on
    exact inputs (indices and values equal) and random ones.  Each against
    its plain version, a repeat bit-identical, with the library call's time
    beside: (x @ w8.to(bf16)) * scale; SDPA over the cache dequantised to
    bf16 beforehand; cuBLAS bf16 h @ W^T (the int8 head's weight as bf16)
    and torch.topk; the head's forms also with their product alone and
    their selection and merge alone (``head_split_ms``).  Returns the rows
    by kernel."""
    import torch
    import torch.nn.functional as F
    from tsue_tpu_torch.ops.kv_quant import (attend_int8_kv,
                                             attend_int8_kv_plain,
                                             attend_int8_kv_plan,
                                             dequantize_kv, quantize_cache)
    from tsue_tpu_torch.ops.lmhead_topk import (LANES, lmhead_topk,
                                                lmhead_topk_plain,
                                                lmhead_topk_plan)
    from tsue_tpu_torch.ops.quant import (int8_matmul, int8_matmul_plan,
                                          int8_matmul_ref, quantize_weight)
    BF = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(14)
    rows = {"int8_matmul": [], "attend_int8_kv": [], "lmhead_topk": []}
    M = QQ_BATCH
    for name, K, N, per_layer in INT8_SHAPES:
        od = torch.float32 if name == "lm_head" else BF
        x = torch.randn(M, K, generator=g, device=dev).to(BF)
        w8, s = quantize_weight(torch.randn(K, N, generator=g, device=dev)
                                * K ** -0.5)
        out = int8_matmul(x, w8, s, out_dtype=od)
        again = int8_matmul(x, w8, s, out_dtype=od)
        ref = int8_matmul_ref(x, w8, s, od)
        torch.cuda.synchronize()
        same = torch.equal(out, again)
        if od == BF:
            err, ulps = _bf16_ulp_err(out, ref)
            ok = ulps <= 1.0
            tol = "1 bf16 ulp of each output"
        else:
            err, ulps = errors(out, ref)[0], None
            ok = torch.allclose(out, ref, rtol=1e-5,
                                atol=1e-5 * ref.abs().max().item())
            tol = "rtol 1e-5, atol 1e-5 of the largest"
        plain_ms = timer.ms(lambda: int8_matmul_ref(x, w8, s, od))
        ms = timer.ms(lambda: int8_matmul(x, w8, s, out_dtype=od))
        lib_ms = timer.ms(lambda: (x @ w8.to(BF)) * s)
        # one bf16 product a weight: x is exact in bf16 (csrc/int8_matmul.cu)
        b = bound(nbytes(x, w8, s, out), 2.0 * M * K * N, BF16_FLOPS)
        rows["int8_matmul"].append(row(
            "int8_matmul", f"bf16 x {name} M={M} K={K} N={N} out {od}",
            gpu, err, err / max(ref.float().abs().max().item(), 1e-30), ms,
            plain_ms, b, lib_ms, timer.floor_ms, per_layer=0,
            bf16_per_layer=per_layer, form="bf16", max_ulps=ulps,
            tolerance=tol, library="(x @ w8.to(bf16)) * scale",
            plan=int8_matmul_plan(M, K, N), repeat_bit_identical=same))
        check(ok, f"int8_matmul bf16 {name}: max abs err {err} ({tol})")
        check(same, f"int8_matmul bf16 {name}: a repeated call differs")

    B, Hq, Hkv, D, S = QQ_BATCH, 32, 8, 64, QQ_CACHE
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(BF)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(BF)
    cache = quantize_cache([(k, v)])[0]
    q = torch.randn(B, 1, Hq, D, generator=g, device=dev).to(BF)
    P = S - QQ_NEW
    s_idx = torch.arange(S, device=dev)[None, :]
    mask = ((s_idx < P) | ((s_idx >= P) & (s_idx <= P + 40))).expand(
        B, S).contiguous()
    out = attend_int8_kv(q, cache, mask)
    again = attend_int8_kv(q, cache, mask)
    ref = attend_int8_kv_plain(q, cache, mask)
    torch.cuda.synchronize()
    err, ulps = _bf16_ulp_err(out, ref)
    kd, vd = (dequantize_kv(x8, xs, BF).transpose(1, 2)
              for x8, xs in ((cache[0], cache[1]), (cache[2], cache[3])))
    qd = q.transpose(1, 2)
    amask = mask[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qd, kd, vd, attn_mask=amask, enable_gqa=True)
    plain_ms = timer.ms(lambda: attend_int8_kv_plain(q, cache, mask))
    ms = timer.ms(lambda: attend_int8_kv(q, cache, mask))
    lib_ms = timer.ms(lib)
    b = bound(nbytes(q, *cache, mask, out),
              4.0 * D * Hq * mask.sum().item())
    plan = attend_int8_kv_plan(S, Hq // Hkv, D)
    rows["attend_int8_kv"].append(row(
        "attend_int8_kv", f"bf16 q S={S} B={B} 32/8x64 Tq=1", gpu, err,
        err / max(ref.float().abs().max().item(), 1e-30), ms, plain_ms, b,
        lib_ms, timer.floor_ms, form="bf16", max_ulps=ulps,
        tolerance="1 bf16 ulp of each output",
        library="SDPA over the cache dequantised to bf16 beforehand",
        plan={**plan, "ctas": plan["splits"] * B * Hkv},
        repeat_bit_identical=bool(torch.equal(out, again))))
    check(ulps <= 1.0, f"attend_int8_kv bf16: {ulps} ulps (max abs err "
                       f"{err})")
    check(torch.equal(out, again), "attend_int8_kv bf16: a repeated call "
                                   "differs")
    del k, v, cache, kd, vd

    penalty = 1.2
    for exact in (True, False):
        h, w, quant, hmask = head_inputs(dev, g, exact)
        h, w = h.to(BF), w.to(BF)
        for layout in ("int8 (bf16 h)", "tied_bf16"):
            args = ((h, None, hmask, penalty, quant) if layout != "tied_bf16"
                    else (h, w, hmask, penalty, None))
            vals, idx = lmhead_topk(*args)
            again = lmhead_topk(*args)
            rv, ri = lmhead_topk_plain(*args)
            torch.cuda.synchronize()
            err, rel = errors(vals, rv)
            same = torch.equal(again[0], vals) and torch.equal(again[1], idx)
            name = f"{layout} {'exact' if exact else 'random'} B=16 V=128256"
            check(same, f"lmhead_topk {name}: a repeated call differs")
            if exact:
                check(torch.equal(idx, ri) and torch.equal(vals, rv),
                      f"lmhead_topk {name}: indices or values differ")
                check(any(len(torch.unique(r)) < LANES for r in rv),
                      f"lmhead_topk {name}: the case has no ties")
            else:
                check(torch.allclose(vals, rv, **TOL),
                      f"lmhead_topk {name}: max abs err {err}")
                agree = (idx == ri).float().mean().item()
                check(agree > 0.99, f"lmhead_topk {name}: {agree} of the "
                                    "indices agree")
            plain_ms = timer.ms(lambda: lmhead_topk_plain(*args))
            ms = timer.ms(lambda: lmhead_topk(*args))
            if layout == "tied_bf16":
                lib = lambda: torch.topk(h @ w.t(), LANES)  # noqa: E731
                wb = nbytes(w)
            else:
                w8b = quant[0].to(BF)
                lib = lambda: torch.topk(  # noqa: E731
                    (h @ w8b).float() * quant[1], LANES)
                wb = nbytes(*quant)
            lib_ms = timer.ms(lib)
            parts = head_split_ms(timer, args, split)
            # one bf16 product a weight (csrc/lmhead_topk.cu)
            b = bound(wb + nbytes(h, hmask, vals, idx),
                      2.0 * h.shape[0] * h.shape[1] * 128256, BF16_FLOPS)
            print(f"lmhead_topk {name}: {ms:.4f} ms (product alone "
                  f"{parts['product_ms']:.4f}, selection and merge alone "
                  f"{parts['selection_and_merge_ms']:.4f}); bound "
                  f"{b[0]:.4f} ms ({b[0] / ms:.0%}); library {lib_ms:.4f} "
                  f"ms (cuBLAS bf16 h @ W^T, then torch.topk); plain "
                  f"{plain_ms:.4f} ms; gpu: {gpu}", flush=True)
            rows["lmhead_topk"].append(row(
                "lmhead_topk", name, gpu, err, rel, ms, plain_ms, b, lib_ms,
                timer.floor_ms, layout=layout, exact=exact, form="bf16",
                repeat_bit_identical=same,
                library="cuBLAS bf16 h @ W^T, then torch.topk",
                plan=lmhead_topk_plan("int8" if layout != "tied_bf16"
                                      else "tied_bf16"), **parts))
        del h, w, quant, hmask
    torch.cuda.empty_cache()
    return rows


def hf_llama_state(cfg, dev, seed: int) -> dict:
    """An HF-named bf16 Llama state dict at ``cfg``'s widths, drawn on the
    card from a seeded generator: (out, in) projections N(0, 1/in), the
    embedding N(0, 1/D), unit norms (the distributions of
    models.tsue.init_params)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    D, Hd = cfg.hidden_size, cfg.head_dim

    def w(o, i):
        return (torch.randn(o, i, generator=g, device=dev)
                * i ** -0.5).to(torch.bfloat16)

    def ones():
        return torch.ones(D, dtype=torch.bfloat16, device=dev)

    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, D),
          "model.norm.weight": ones()}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        for name, o, n_in in (("q_proj", cfg.num_heads * Hd, D),
                              ("k_proj", cfg.num_kv_heads * Hd, D),
                              ("v_proj", cfg.num_kv_heads * Hd, D),
                              ("o_proj", D, cfg.num_heads * Hd)):
            sd[f"{p}.self_attn.{name}.weight"] = w(o, n_in)
        for name, o, n_in in (("gate_proj", cfg.intermediate_size, D),
                              ("up_proj", cfg.intermediate_size, D),
                              ("down_proj", D, cfg.intermediate_size)):
            sd[f"{p}.mlp.{name}.weight"] = w(o, n_in)
        sd[f"{p}.input_layernorm.weight"] = ones()
        sd[f"{p}.post_attention_layernorm.weight"] = ones()
    return sd


def study_expected(steps: dict, L: int, qformer_calls: int) -> dict:
    """The launches of quality_quant's run, written out from the code:
    each generation prefills once (flash in every Llama layer and Q-Former
    call); each decode step runs flash in every layer (the bf16 cache) or
    attend_int8_kv (the int8 cache), and with int8 weights seven int8
    products a layer plus the LM head's (113 a step at 16 layers), with one
    more head product for the first token; the four teacher-forced
    rollouts decode QQ_NEW steps each the same way."""
    from tsue_tpu_torch.cli.quality_quant import MODES
    exp = {"flash_attn_fwd": 0, "int8_matmul": 0, "attend_int8_kv": 0}
    runs = [(MODES.get(run.split("_", 1)[1], (False, False)), s)
            for run, s in steps.items()]
    runs += [((False, False), QQ_NEW)] + [(m, QQ_NEW)
                                          for m in MODES.values()]
    for (w8, kv8), s in runs:
        exp["flash_attn_fwd"] += L + qformer_calls + (0 if kv8 else s * L)
        exp["int8_matmul"] += (1 + s * (7 * L + 1)) if w8 else 0
        exp["attend_int8_kv"] += s * L if kv8 else 0
    return {**dict.fromkeys(KERNELS, 0), **exp}


def greedy_ties(dev, gpu, mllm, inputs, label, ref_ids, out_ids, kv8):
    """Rows where a fused-head greedy run's ids differ from the unfused
    run's: the first step that differs, and the gap between the two
    largest processed logits of the unfused run there (its teacher-forced
    logits along its own ids, the greedy chain's penalty and ban).  Each
    divergence must start at a tie within QQ_TIE_BOUND (the two heads sum
    the same exact products in other orders).  Returns the rows and
    gaps."""
    import numpy as np
    import torch
    from tsue_tpu_torch.cli.quality_quant import rollout_logits
    from tsue_tpu_torch.ops.sampling import (SamplingConfig,
                                             apply_no_repeat_ngram,
                                             apply_repetition_penalty)
    vision, ids, mask = inputs
    diff = [r for r in range(ref_ids.shape[0])
            if not np.array_equal(ref_ids[r], out_ids[r])]
    ties = []
    if not diff:
        return ties
    cfg = SamplingConfig(do_sample=False)
    logits = rollout_logits(mllm, vision, ids, mask,
                            torch.from_numpy(ref_ids).to(dev), kv8)
    for r in diff:
        t = int(np.argmax(ref_ids[r] != out_ids[r]))
        hist = torch.cat([ids[r:r + 1].long(), torch.from_numpy(
            ref_ids[r:r + 1, :t]).to(dev).long()], 1)
        hlen = torch.tensor([hist.shape[1]], device=dev)
        lg = apply_repetition_penalty(logits[t, r:r + 1].float(), hist, hlen,
                                      cfg.repetition_penalty)
        lg = apply_no_repeat_ngram(lg, hist, hlen, cfg.no_repeat_ngram_size)
        top = torch.topk(lg[0], 2).values
        gap = (top[0] - top[1]).item()
        ties.append({"row": r, "step": t, "top2_gap": gap})
        print(f"{label}: row {r} diverges at step {t}: the unfused run's "
              f"top-2 processed logits {top[0].item():.6f} and "
              f"{top[1].item():.6f}, gap {gap:.3g} (bound {QQ_TIE_BOUND}); "
              f"gpu: {gpu}", flush=True)
        check(gap <= QQ_TIE_BOUND, f"{label}: row {r} diverges at step {t} "
                                   f"with a top-2 gap of {gap}: not a tie")
    return ties


def int8_witness(gpu, mllm, inputs, tables, ref_ids, study_drift):
    """The int8_w arm's teacher-forced rollout along the bf16 baseline's
    greedy ids, through the int8 kernel and through the plain int8
    product (``plain_int8``: fp32 products and sums, one rounding after
    the scale), on the same weights: both drifts against the bf16
    rollout, and the top-1 figures within QQ_WITNESS_BOUND of each other.
    Equal figures put the int8 arms' distance from the TPU table on the
    weights' quantisation, not on the kernel."""
    import torch
    from tsue_tpu_torch.cli import quality_quant as QQ
    from tsue_tpu_torch.ops.quant import plain_int8
    t0 = time.time()
    toks = torch.from_numpy(ref_ids).to(inputs[1].device)
    base = QQ.rollout_logits(mllm, *inputs, toks, False)
    QQ.set_quant(mllm, tables, tables)
    try:
        kern = QQ.rollout_logits(mllm, *inputs, toks, False)
        with plain_int8():
            plain = QQ.rollout_logits(mllm, *inputs, toks, False)
    finally:
        QQ.set_quant(mllm, None, tables)
    dk, dp = QQ.drift(base, kern), QQ.drift(base, plain)
    between = QQ.drift(plain, kern)
    print(f"int8_w plain witness ({time.time() - t0:.1f}s, 3 rollouts): "
          f"top-1 vs bf16 through the kernel {dk['top1_agree']} (the "
          f"study's {study_drift['top1_agree']}), through the plain int8 "
          f"product {dp['top1_agree']}; max |dlogit| vs bf16 "
          f"{dk['max_abs_dlogit']} and {dp['max_abs_dlogit']}; kernel vs "
          f"plain: max |dlogit| {between['max_abs_dlogit']}, mean "
          f"{between['mean_abs_dlogit']}, top-1 {between['top1_agree']}; "
          f"gpu: {gpu}", flush=True)
    check(all(math.isfinite(x) for d in (dk, dp, between)
              for x in d.values()), "int8_w plain witness: not finite")
    check(abs(dk["top1_agree"] - dp["top1_agree"]) <= QQ_WITNESS_BOUND,
          f"int8_w plain witness: top-1 through the kernel "
          f"{dk['top1_agree']} and through the plain product "
          f"{dp['top1_agree']} differ by more than {QQ_WITNESS_BOUND}")


def bf16_decode_phase(dev, gpu, head_split):
    """Phase 14: the bf16 forms' kernel checks, quality_quant at
    Llama-3.2-1B's widths in bf16 (B 16, prompt 144, 64 new tokens) with
    the Llama's weights an HF-named state dict loaded by load_hf_llama,
    its launch counts exact, every drift finite and teacher-forced top-1
    agreement >= QQ_TOP1_FLOOR in each mode; then, over a rebuild of the
    same model, the bf16 greedy run again (equal to the study's), and two
    greedy runs through the fused head's bf16 forms: bf16 with the fused
    head alone against the bf16 baseline, and int8 weights + int8 KV +
    the fused head against the study's "both" arm, id for id or each
    divergence a reported, bounded tie; last the plain int8 witness
    (``int8_witness``).  Returns (kernel rows, launches by run)."""
    import numpy as np
    import torch
    from tsue_tpu_torch.cli import quality_quant as QQ
    from tsue_tpu_torch.cli._common import build_mllm_bf16
    from tsue_tpu_torch.config import LlamaConfig, QFormerConfig
    from tsue_tpu_torch.ops.quant import quantize_llama_params
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    t_phase = time.time()
    timer = Timer(dev)
    rows = bf16_decode_kernel_checks(dev, gpu, timer, head_split)
    del timer
    llama, qcfg = LlamaConfig(vocab_size=128256), QFormerConfig()
    L = llama.num_layers
    qcalls = qcfg.num_encoder_layers + 2 * qcfg.num_decoder_layers
    t0 = time.time()
    hf = hf_llama_state(llama, dev, seed=21)
    print(f"bf16 decode: HF-named bf16 Llama state dict ({len(hf)} tensors, "
          f"{sum(t.numel() for t in hf.values()) / 1e9:.3f}B values) drawn "
          f"in {time.time() - t0:.1f}s", flush=True)
    argv = ["--bs", str(QQ_BATCH), "--prompt-len", str(QQ_PROMPT),
            "--max-new", str(QQ_NEW)]
    reset_counts()
    t0 = time.time()
    result = QQ.main(argv, hf_state=hf)
    torch.cuda.synchronize(dev)
    study_s = time.time() - t0
    study = read_counts()
    expected = study_expected(QQ.last_steps, L, qcalls)
    print(f"quality_quant: {study_s:.1f}s for 8 generations and 4 "
          f"teacher-forced rollouts of {QQ_NEW} steps (B {QQ_BATCH}, prompt "
          f"{QQ_PROMPT}, vocab 128256, all-bf16 parameters, model build "
          f"included); steps {json.dumps(QQ.last_steps)}; launches "
          f"{json.dumps(study)}, expected {json.dumps(expected)}; gpu: "
          f"{gpu}", flush=True)
    check(study == expected, f"quality_quant: launches {study} != "
                             f"{expected}")
    for mode in QQ.MODES:
        d = result[f"drift_{mode}"]
        check(all(math.isfinite(x) for x in d.values()),
              f"quality_quant drift_{mode}: not finite: {d}")
        check(d["top1_agree"] >= QQ_TOP1_FLOOR,
              f"quality_quant drift_{mode}: teacher-forced top-1 "
              f"{d['top1_agree']} < {QQ_TOP1_FLOOR}")
    print("quality_quant table (this card; PARITY.md:376-378 has the JAX "
          "package's on a TPU: top-1 97.7 / 99.2 / 98.0%): " + "; ".join(
              f"{m}: max |dlogit| {result[f'drift_{m}']['max_abs_dlogit']}, "
              f"mean {result[f'drift_{m}']['mean_abs_dlogit']}, last-step "
              f"max {result[f'drift_{m}']['last_step_max']}, top-1 "
              f"{result[f'drift_{m}']['top1_agree']}, greedy prefix "
              f"{result[f'greedy_{m}']['mean_prefix']}"
              for m in QQ.MODES) + f"; gpu: {gpu}", flush=True)

    t0 = time.time()
    mllm, inputs = build_mllm_bf16(QQ_BATCH, QQ_PROMPT, device=dev,
                                   hf_state=hf)
    lay = mllm.llama.model.layer_3
    check(torch.equal(lay.attn.q_proj.kernel,
                      hf["model.layers.3.self_attn.q_proj.weight"].t())
          and torch.equal(lay.mlp.down_proj.kernel,
                          hf["model.layers.3.mlp.down_proj.weight"].t())
          and torch.equal(mllm.llama.model.embed_tokens.weight,
                          hf["model.embed_tokens.weight"]),
          "load_hf_llama: the model's weights are not the state dict's")
    check({p.dtype for p in mllm.parameters()} == {torch.bfloat16},
          "bf16 decode: a parameter is not bf16")
    del hf
    greedy = SamplingConfig(do_sample=False)
    again, _ = QQ.generate(mllm, greedy, QQ_NEW, *inputs, 0)
    check(np.array_equal(again, QQ.last_ids["bf16"]),
          "bf16 decode: the rebuilt model's greedy ids differ from the "
          "study's bf16 baseline")
    print(f"bf16 decode: rebuilt through load_hf_llama and the bf16 greedy "
          f"run repeated bit for bit in {time.time() - t0:.1f}s", flush=True)
    tables = quantize_llama_params(mllm)
    reset_counts()
    t0 = time.perf_counter()
    ids_b, s_b = QQ.generate(mllm, greedy, QQ_NEW, *inputs, 0,
                             fused_head=True)
    t_b = time.perf_counter() - t0
    QQ.set_quant(mllm, tables, tables)
    t0 = time.perf_counter()
    ids_q, s_q = QQ.generate(mllm, greedy, QQ_NEW, *inputs, 0,
                             quantize_kv=True, fused_head=True)
    t_q = time.perf_counter() - t0
    fused = read_counts()
    exp_fused = {**dict.fromkeys(KERNELS, 0),
                 "flash_attn_fwd": 2 * (L + qcalls) + s_b * L,
                 "lmhead_topk": s_b + s_q, "int8_matmul": s_q * 7 * L,
                 "attend_int8_kv": s_q * L}
    print(f"bf16 fused head, greedy: bf16 + fused head {t_b:.3f}s, int8 w + "
          f"int8 KV + fused head {t_q:.3f}s ({s_b} and {s_q} steps); "
          f"launches {json.dumps(fused)}, expected {json.dumps(exp_fused)}; "
          f"gpu: {gpu}", flush=True)
    check(fused == exp_fused, f"bf16 fused head: launches {fused} != "
                              f"{exp_fused}")
    ties = greedy_ties(dev, gpu, mllm, inputs, "bf16 fused head vs bf16",
                       QQ.last_ids["bf16"], ids_b, False)
    QQ.set_quant(mllm, tables, tables)
    ties += greedy_ties(dev, gpu, mllm, inputs, "both + fused head vs both",
                        QQ.last_ids["both"], ids_q, True)
    QQ.set_quant(mllm, None, tables)
    eq_b = sum(np.array_equal(a, b)
               for a, b in zip(QQ.last_ids["bf16"], ids_b))
    eq_q = sum(np.array_equal(a, b)
               for a, b in zip(QQ.last_ids["both"], ids_q))
    print(f"bf16 fused head, greedy: rows equal id for id {eq_b}/{QQ_BATCH} "
          f"(bf16) and {eq_q}/{QQ_BATCH} (both); ties {json.dumps(ties)}; "
          f"gpu: {gpu}", flush=True)
    int8_witness(gpu, mllm, inputs, tables, QQ.last_ids["bf16"],
                 result["drift_int8_w"])
    del mllm, tables
    gc.collect()
    torch.cuda.empty_cache()
    print(f"bf16 decode phase: {time.time() - t_phase:.1f}s in all; gpu: "
          f"{gpu}", flush=True)
    return rows, {"quality_quant bf16 (8 generations, 4 rollouts)": study,
                  "bf16 fused head greedy (bf16; int8 w + KV)": fused}


# --------------------------------------------------------------------------
# 15. the parallel paths on the one card
# --------------------------------------------------------------------------

PARALLEL_NEW_TOKENS = 16
PARALLEL_TIMEOUT_S = 600
LOGIT_TOL = 1e-3       # of max |logit|: TP 2 sums each product in halves


def parallel_train_cfg():
    """"train_18_30" (frozen_mllm, fp32, batch 16) with every dropout at 0:
    a data rank then draws no mask, and its step equals one process's."""
    from tsue_tpu_torch.config import get_preset
    cfg = get_preset("train_18_30")
    m = cfg.model
    return cfg.replace(model=dataclasses.replace(
        m, llama=dataclasses.replace(m.llama, lora_dropout=0.0),
        qformer=dataclasses.replace(m.qformer, dropout=0.0),
        lane=dataclasses.replace(m.lane, dropout=0.0),
        ltsf=dataclasses.replace(m.ltsf, dropout=0.0)))


def parallel_work(dev, tp=None, dp=None) -> dict:
    """Phase 15's work in one process (``tp``, ``dp`` None) or on a rank of
    the two (``tp`` the TP 2 mesh, ``dp`` the DP 2 mesh of the same ranks):
    (a) at the width of phase 5 a Predictor with the three decode switches
    on: the prefill's last-position logits on seeded prompts, a greedy
    ``generate_context`` of 16 tracks (16 new tokens) with its launches,
    and a ``predict`` request (K = 10); (b) one stage-2 step of
    ``parallel_train_cfg`` with the fused switch on, clip + SGD at a
    learning rate of 1 (an update affine in the gradient, large beside an
    fp32 ulp of the weights), on DP 2 and (c) on DP 2 with FSDP."""
    import numpy as np
    import torch
    from tsue_tpu_torch.data import (BatchIterator, build_windows,
                                     get_tokenizer, make_synthetic_tracks)
    from tsue_tpu_torch.models.tsue import TrajectoryModel, init_params
    from tsue_tpu_torch.ops.fused import fused_scope
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    from tsue_tpu_torch.parallel.sharding import gather_state
    from tsue_tpu_torch.runner import _place_for_training, to_device
    from tsue_tpu_torch.serve import Predictor
    from tsue_tpu_torch.train.trainer import make_train_step
    from tsue_tpu_torch.parallel.mesh import shard_batch
    out = {}
    cfg, state = full_width_state(dev)
    B, N = 16, PARALLEL_NEW_TOKENS
    pred = Predictor(cfg, state, batch_size=B, num_candidates=10,
                     quantize_decode=True, fused_head=True, quantize_kv=True,
                     device=dev, mesh=tp)
    del state
    rng = np.random.default_rng(15)
    vision = torch.from_numpy(rng.standard_normal(
        (B, cfg.data.seq_len, cfg.data.vision_dim)).astype(np.float32)
        ).to(dev)
    ids = torch.from_numpy(rng.integers(
        3, min(50000, cfg.model.llama.vocab_size), (B, 144)).astype(
        np.int32)).to(dev)
    mask = torch.ones(B, 144, dtype=torch.int32, device=dev)
    mllm = pred._mllm()
    with torch.no_grad():
        _, last, _, _ = mllm.prefill(vision, ids, mask, 144 + 16 + N)
        out["logits"] = mllm.llama.logits_from_hidden(
            last, quant_ok=True).float().cpu()
    greedy = SamplingConfig(do_sample=False)
    tracks = make_synthetic_tracks(num_tracks=B, track_len=400, seed=15)
    pred.generate_context(tracks, max_new_tokens=N, sampling=greedy)
    torch.cuda.synchronize(dev)
    reset_counts()
    t0 = time.perf_counter()
    pred.generate_context(tracks, max_new_tokens=N, sampling=greedy)
    torch.cuda.synchronize(dev)
    out["generate_s"] = time.perf_counter() - t0
    out["generate_counts"] = read_counts()
    out["ids"] = pred.last_request["ids"]
    out["generate_steps"] = sum(c["steps"] for c in
                                pred.last_request["chunks"])
    req = make_synthetic_tracks(num_tracks=2, track_len=400, seed=16)
    pred.predict(req)
    torch.cuda.synchronize(dev)
    reset_counts()
    t0 = time.perf_counter()
    res = pred.predict(req, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize(dev)
    out["predict_s"] = time.perf_counter() - t0
    out["predict_counts"] = read_counts()
    out["pred"] = np.stack([r["pred_pixel_xy"] for r in res])
    who = "one process" if tp is None else f"rank {tp.rank}"
    print(f"parallel {who}: (a) serving done", flush=True)
    del pred, mllm, last
    gc.collect()
    torch.cuda.empty_cache()

    tcfg = parallel_train_cfg()
    ds = build_windows(make_synthetic_tracks(num_tracks=8, track_len=600,
                                             seed=5), tcfg.data,
                       get_tokenizer())
    batch = to_device(next(iter(BatchIterator(
        ds, tcfg.train.batch_size, seed=tcfg.train.seed,
        length_buckets=tcfg.data.length_buckets))), dev)
    step = make_train_step(tcfg)
    for key, fsdp in (("dp", False), ("fsdp", True)):
        if dp is None and key == "fsdp":
            break
        c = tcfg.replace(mesh=dataclasses.replace(tcfg.mesh, fsdp=fsdp))
        with torch.device(dev):
            model = TrajectoryModel(c.model, c.data.seq_len, c.data.out_len)
        init_params(model, torch.Generator(device=dev).manual_seed(
            c.train.seed))
        if dp is None:
            out["start"] = {n: p.detach().cpu().clone()
                            for n, p in model.named_parameters()}
        st = _place_for_training(c, model, dp)
        st.optimizer.adamw = torch.optim.SGD(st.optimizer.params, lr=1.0,
                                             foreach=False)
        trainable = {n for n, p in st.model.named_parameters()
                     if p.requires_grad}
        with fused_scope("on"):
            reset_counts()
            t0 = time.perf_counter()
            loss = step(st, shard_batch(batch, dp))["loss"]
            torch.cuda.synchronize(dev)
            out[f"{key}_s"] = time.perf_counter() - t0
            out[f"{key}_counts"] = read_counts()
        out[f"{key}_loss"] = float(loss)
        whole = gather_state(dict(st.model.named_parameters()), dp)
        out[f"{key}_params"] = {n: v.cpu() for n, v in whole.items()
                                if n in trainable}
        print(f"parallel {who}: ({'b' if key == 'dp' else 'c'}) {key} step "
              "done", flush=True)
        del st, model, whole
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp2_resume_runs(dev, tp, out_dir: str) -> dict:
    """``run_stage2`` of phase 4's small configuration (fp32, joint, batch
    4, 5 synthetic tracks, the fused switch on) under TP 2: two epochs
    with a train state every epoch, and a twin of one epoch resumed to
    two.  Returns both runs' metrics, their launches, and on rank 0
    whether the two final train states (gathered whole, the one-process
    file) are equal bit for bit."""
    import torch
    from tsue_tpu_torch.ops.fused import fused_scope
    from tsue_tpu_torch.runner import run_stage2
    from tsue_tpu_torch.train.checkpoint import STATE_FILE
    cfg = small_train_cfg("joint")
    run = dict(synthetic_tracks=5, device=dev, mesh=tp, save_every=1)
    with fused_scope("on"):
        reset_counts()
        t0 = time.perf_counter()
        straight = run_stage2(cfg, out_dir=os.path.join(out_dir, "s2a"),
                              epochs=2, **run)
        run_stage2(cfg, out_dir=os.path.join(out_dir, "s2b"), epochs=1,
                   **run)
        resumed = run_stage2(cfg, out_dir=os.path.join(out_dir, "s2b"),
                             epochs=2, resume=True, **run)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        counts = read_counts()
    equal = None
    if tp.is_primary():
        equal = same(*(torch.load(os.path.join(
            out_dir, r, cfg.name, "ckpt", "state", STATE_FILE),
            weights_only=True) for r in ("s2a", "s2b")))
    return dict(straight=straight, resumed=resumed, state_equal=equal,
                s=secs, counts=counts)


def _parallel_rank(rank: int, port: int, out_dir: str) -> None:
    """One of phase 15's two ranks, on cuda:0 over gloo (a crash prints
    the rank's Python stack)."""
    import faulthandler
    import torch
    faulthandler.enable()
    import torch.distributed as dist
    from tsue_tpu_torch.ops._build import build_all
    from tsue_tpu_torch.parallel import mesh as M
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    build_all(list(KERNELS))          # built by the parent: loads only
    tp = M.make_mesh(2, device=dev)
    dp = M.make_mesh(1, device=dev)
    M.reset_counts()
    out = parallel_work(dev, tp, dp)
    out["collectives"] = dict(M.COUNTS)
    out["resume"] = tp2_resume_runs(dev, tp, out_dir)
    out["mesh"] = (tp.data, tp.model, tp.model_rank, dp.data, dp.data_rank)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _close_updates(ref, other, start) -> float:
    """The largest parameter difference over the largest update
    (``tests/test_multichip.py:54-71``'s rule: at most 1e-5)."""
    scale = max(float((ref[k] - start[k]).abs().max()) for k in ref)
    check(scale > 0, "phase 15: the step moved no parameter")
    return max(float((ref[k] - other[k]).abs().max()) for k in ref) / scale


def parallel_phase(dev, gpu) -> dict:
    """Phase 15: the parallel layer on the one card.  NCCL refuses two
    ranks on one device, so two ranks share cuda:0 over gloo, which runs
    every tensor collective the port issues on CUDA tensors (another kind
    raises in ``parallel.mesh``; no collective is staged through the
    host).  The
    one-process run of ``parallel_work`` comes first, then the two ranks
    run it on their meshes: (a) TP 2 serving, the prefill logits within
    ``LOGIT_TOL`` of max |logit|, greedy ids equal on at least 0.9 of the
    positions, the deterministic prediction within ``PX_TOL`` px, each
    rank's launches those of one process; (b) the DP 2 and (c) FSDP over
    DP 2 step, the loss within rtol 1e-5 and every update within 1e-5 of
    the largest; (d) ``run_stage2`` under TP 2 interrupted and resumed
    (``tp2_resume_runs``), equal to the straight run.  Two ranks on one
    card measure no scaling: their rates are printed for the record only.
    Returns the ranks' launches by run."""
    import shutil
    import socket
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from tsue_tpu_torch.parallel.mesh import GLOO_CUDA_OPS
    t_phase = time.time()
    ref = parallel_work(dev)
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = Path("runs") / f"chip_smoke_parallel_{os.getpid()}"
    out_dir.mkdir(parents=True, exist_ok=True)
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_parallel_rank, args=(r, port, str(out_dir)))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.time() + PARALLEL_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.time()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"phase 15: a rank failed (exit codes {[p.exitcode for p in procs]})")
    outs = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(2)]
    shutil.rmtree(out_dir, ignore_errors=True)
    check([o["mesh"] for o in outs] == [(1, 2, 0, 2, 0), (1, 2, 1, 2, 1)],
          f"phase 15: mesh layout {[o['mesh'] for o in outs]}")
    scale = ref["logits"].abs().max().item()
    counts = {}
    for r, o in enumerate(outs):
        lerr = (o["logits"] - ref["logits"]).abs().max().item() / scale
        share = float((o["ids"] == ref["ids"]).mean())
        perr = float(np.abs(o["pred"] - ref["pred"]).max())
        print(f"parallel TP 2 rank {r}: prefill logits max |diff| "
              f"{lerr:.3e} of max |logit| {scale:.3f} (tolerance "
              f"{LOGIT_TOL}); greedy ids equal on {share:.4f} of "
              f"{o['ids'].size} positions; prediction max |diff| {perr:.3e} "
              f"px (tolerance {PX_TOL}); gpu: {gpu}", flush=True)
        check(lerr <= LOGIT_TOL, f"phase 15 rank {r}: logits {lerr}")
        check(share >= 0.9, f"phase 15 rank {r}: greedy share {share}")
        check(perr <= PX_TOL, f"phase 15 rank {r}: prediction {perr} px")
        for what in ("generate", "predict"):
            check(o[f"{what}_counts"] == ref[f"{what}_counts"],
                  f"phase 15 rank {r} {what}: launches "
                  f"{o[what + '_counts']} != one process's "
                  f"{ref[what + '_counts']}")
        for key in ("dp", "fsdp"):
            rel = abs(o[f"{key}_loss"] - ref["dp_loss"]) / abs(ref["dp_loss"])
            upd = _close_updates(ref["dp_params"], o[f"{key}_params"],
                                 ref["start"])
            print(f"parallel {key.upper()} over DP 2 rank {r}: loss "
                  f"{o[key + '_loss']:.6f} (one process "
                  f"{ref['dp_loss']:.6f}, rel {rel:.2e}); largest parameter "
                  f"difference {upd:.2e} of the largest update; step "
                  f"{o[key + '_s']:.3f}s (one process {ref['dp_s']:.3f}s); "
                  f"launches {json.dumps(o[key + '_counts'])}", flush=True)
            check(rel <= 1e-5, f"phase 15 rank {r} {key}: loss rel {rel}")
            check(upd <= 1e-5, f"phase 15 rank {r} {key}: updates {upd}")
        toks = o["ids"].shape[0] * o["generate_steps"]
        print(f"parallel rank {r}: generate {o['generate_s']:.3f}s "
              f"({toks / o['generate_s']:.1f} tokens/s; one process "
              f"{ref['generate_s']:.3f}s), predict {o['predict_s']:.3f}s "
              f"(one process {ref['predict_s']:.3f}s) -- two ranks share "
              f"one card: no scaling is measured; collectives "
              f"{json.dumps(o['collectives'])}; gpu: {gpu}", flush=True)
        tensor_kinds = {k for k in o["collectives"] if "object" not in k
                        and k != "barrier"}
        check(o["collectives"].get("all_reduce", 0) > 0
              and tensor_kinds <= GLOO_CUDA_OPS,
              f"phase 15 rank {r}: collectives {o['collectives']}")
        for run in ("generate", "predict", "dp", "fsdp"):
            counts[f"phase 15 {run} rank {r}"] = o[f"{run}_counts"]
        res = o["resume"]
        print(f"parallel TP 2 run_stage2 rank {r} (small configuration): "
              f"straight 2 epochs {json.dumps(res['straight'])}, 1 epoch "
              f"resumed to 2 {json.dumps(res['resumed'])}; train states "
              f"equal: {res['state_equal']}; three runs {res['s']:.1f}s; "
              f"gpu: {gpu}", flush=True)
        check(res["resumed"] == res["straight"] == outs[0]["resume"]
              ["straight"], f"phase 15 rank {r}: the resumed TP 2 run's "
              f"metrics {res['resumed']} != {res['straight']}")
        check(r > 0 or res["state_equal"], "phase 15: the resumed TP 2 "
              "run's train state differs from the straight run's")
        counts[f"phase 15 run_stage2 TP 2 resumed rank {r}"] = res["counts"]
    print(f"parallel phase: {time.time() - t_phase:.1f}s in all; gpu: {gpu}",
          flush=True)
    return counts


# --------------------------------------------------------------------------
# 16. the GPipe pipeline on the one card
# --------------------------------------------------------------------------

PIPE_STAGES = 2
PIPE_MICRO = 4
PIPE_TIMEOUT_S = 600


def pipeline_cfg():
    """"train_18_30" stage 1 (lora_only, batch 16, fp32) on a pipeline of
    ``PIPE_STAGES`` x ``PIPE_MICRO`` microbatches, every dropout at 0: a
    step then equals one process's up to the order of its sums."""
    from tsue_tpu_torch.config import get_preset
    cfg = get_preset("train_18_30")
    m = cfg.model
    return cfg.replace(
        model=dataclasses.replace(
            m, llama=dataclasses.replace(m.llama, lora_dropout=0.0),
            qformer=dataclasses.replace(m.qformer, dropout=0.0)),
        mesh=dataclasses.replace(cfg.mesh, pipeline_parallel=PIPE_STAGES,
                                 microbatches=PIPE_MICRO))


def pipeline_launches(cfg, stage: int) -> dict:
    """The launches of one pipelined step's forward on ``stage`` (the
    backward recomputes through the plain versions): the Llama's flash,
    two RMSNorms and a SwiGLU a layer of the stage's a microbatch, the
    Q-Former's flash (dropout 0: no plain path) on stage 0 and the final
    RMSNorm on the last stage, a microbatch each."""
    m, M = cfg.model, PIPE_MICRO
    Ls = m.llama.num_layers // PIPE_STAGES
    qf = m.qformer.num_encoder_layers + 2 * m.qformer.num_decoder_layers
    last = stage == PIPE_STAGES - 1
    return dict(train_forward_launches(0), flash_attn_fwd=M * (
        Ls + (qf if stage == 0 else 0)), rmsnorm=M * (2 * Ls + int(last)),
        swiglu_matmul=M * Ls)


def _sgd(state):
    """The optimizer's clip and guard with SGD at lr 1 in place of AdamW:
    an update affine in the gradient (phase 15's comparison step)."""
    import torch
    state.optimizer.adamw = torch.optim.SGD(state.optimizer.params, lr=1.0,
                                            foreach=False)


class PinnedRelu:
    """The Q-Former FFNs' ReLU masks of a whole batch, replayed on its
    microbatches.  ``ReLU'`` jumps at 0, so a unit whose pre-activation
    lies within rounding of 0 may change sign between the whole batch's
    forward and a microbatch's (the products take other cuBLAS kernels at
    other row counts), and its token's whole contribution to that FFN's
    gradient comes or goes.  ``record()`` patches ``FFN.forward`` to keep
    each Q-Former FFN's mask (pre-activation > 0) over the whole batch;
    ``replay(rows)`` to take the consecutive ``rows``-row slices of it on
    consecutive calls (the microbatches in order), counting the units whose
    own sign differs and the largest |pre-activation| among them.  Every
    dropout is 0 here."""

    def __init__(self, mllm):
        from tsue_tpu_torch.models.layers import FFN
        self.cls = FFN
        self.names = {m: n for n, m in mllm.qformer.named_modules()
                      if isinstance(m, FFN)}
        self.masks: dict = {}
        self.calls: dict = {}
        self.flips, self.flip_pre = 0, 0.0

    def _patched(self, rows):
        import torch
        pin = self

        def forward(ffn, x, generator=None):
            pre = ffn.Dense_0(x)
            name = pin.names[ffn]
            if rows is None:
                pin.masks[name] = pre > 0
                return ffn.Dense_1(torch.relu(pre))
            i = pin.calls[name] = pin.calls.get(name, -1) + 1
            mask = pin.masks[name][i * rows:(i + 1) * rows]
            flip = mask != (pre > 0)
            pin.flips += int(flip.sum())
            if flip.any():
                pin.flip_pre = max(pin.flip_pre,
                                   float(pre.detach()[flip].abs().max()))
            return ffn.Dense_1(pre * mask)
        return forward

    @contextlib.contextmanager
    def _using(self, rows):
        self.calls.clear()
        orig = self.cls.forward
        self.cls.forward = self._patched(rows)
        try:
            yield self
        finally:
            self.cls.forward = orig

    def record(self):
        return self._using(None)

    def replay(self, rows: int):
        return self._using(rows)


def pipeline_reference(dev) -> dict:
    """The one-process stage-1 steps that phase 16's ranks are held to:
    ``pipeline_cfg``'s MLLM from the preset's seed, phase 8's first batch,
    clip + SGD, the fused switch on unless said; "full" the whole batch at
    once (``make_stage1_train_step``), its Q-Former FFNs' ReLU masks
    recorded (``PinnedRelu``); "full_plain" the same with the fused switch
    off (the same function, rounded otherwise); "micro" the same
    ``PIPE_MICRO`` microbatches as the pipeline, their gradients summed in
    one process (``make_pipelined_stage1_step`` on a one-process mesh);
    "micro_pinned" the same with the whole batch's ReLU masks.  Returns
    each step's loss, seconds and trainable parameters after it, the
    trainable parameters before (on the host), and the ReLU units whose
    sign the microbatches change with the largest |pre-activation| among
    them."""
    import torch
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    from tsue_tpu_torch.models.tsue import init_params
    from tsue_tpu_torch.ops.fused import fused_scope
    from tsue_tpu_torch.parallel.mesh import Mesh
    from tsue_tpu_torch.parallel.pipeline import make_pipelined_stage1_step
    from tsue_tpu_torch.train.stage1 import (make_stage1_optimizer,
                                             make_stage1_train_step)
    from tsue_tpu_torch.train.trainer import TrainState
    from tsue_tpu_torch.utils.random import step_generator
    cfg = pipeline_cfg()
    m = cfg.model
    batch = stage1_batches(cfg, dev, 1)[0]
    with torch.device(dev):
        mllm = MultiModalLLM(m.llama, m.qformer, m.use_vision)
    init_params(mllm, torch.Generator(device=dev).manual_seed(cfg.train.seed))
    state = TrainState(mllm, make_stage1_optimizer(cfg, mllm), cfg.train.seed)
    _sgd(state)
    params = dict(mllm.named_parameters())
    trainable = [n for n, p in params.items() if p.requires_grad]
    start = {n: params[n].detach().clone() for n in trainable}
    full_step = make_stage1_train_step()
    micro_step, _ = make_pipelined_stage1_step(Mesh(device=dev), PIPE_MICRO)
    out = dict(start={n: t.cpu() for n, t in start.items()})
    pin = PinnedRelu(mllm)
    rows = cfg.train.batch_size // PIPE_MICRO
    for key, fused, scope, step in (
            ("full", "on", pin.record(), lambda: full_step(
                state, batch, step_generator(0, 0, dev))),
            ("full_plain", "off", contextlib.nullcontext(), lambda: full_step(
                state, batch, step_generator(0, 0, dev))),
            ("micro", "on", contextlib.nullcontext(), lambda: micro_step(
                state, batch, 0, 0)),
            ("micro_pinned", "on", pin.replay(rows), lambda: micro_step(
                state, batch, 0, 0))):
        with torch.no_grad():
            for n in trainable:
                params[n].copy_(start[n])
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with fused_scope(fused), scope:
            loss = float(step()["lm_loss"])
        torch.cuda.synchronize(dev)
        out[key] = dict(loss=loss, s=time.perf_counter() - t0, after={
            n: params[n].detach().cpu() for n in trainable})
    out["relu_flips"], out["relu_flip_pre"] = pin.flips, pin.flip_pre
    del state, mllm, params, start, pin
    gc.collect()
    torch.cuda.empty_cache()
    return out


def update_diff(ref, other, start, scale):
    """The largest parameter difference over ``scale`` (the largest
    update) and the three tensors that hold the largest differences."""
    diffs = sorted(((float((ref[n] - other[n]).abs().max()), n)
                    for n in other), reverse=True)
    worst = [(n, d / scale, float((ref[n] - start[n]).abs().max()) / scale)
             for d, n in diffs[:3]]
    return diffs[0][0] / scale, worst


def _pipeline_rank(rank: int, port: int, out_dir: str) -> None:
    """One of phase 16's two pipeline stages, on cuda:0 over gloo (a crash
    prints the rank's Python stack)."""
    import faulthandler
    import torch
    faulthandler.enable()
    import torch.distributed as dist
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    from tsue_tpu_torch.models.tsue import init_params
    from tsue_tpu_torch.ops._build import build_all
    from tsue_tpu_torch.ops.fused import fused_scope
    from tsue_tpu_torch.parallel import mesh as M
    from tsue_tpu_torch.parallel import pipeline as P
    from tsue_tpu_torch.train.checkpoint import STATE_FILE, export_mllm
    from tsue_tpu_torch.train.stage1 import make_stage1_optimizer
    from tsue_tpu_torch.train.trainer import TrainState
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=PIPE_STAGES)
    build_all(list(KERNELS))          # built by the parent: loads only
    t_rank = time.perf_counter()
    mesh = P.make_pipeline_mesh(PIPE_STAGES, dev)
    cfg = pipeline_cfg()
    m = cfg.model
    batches = stage1_batches(cfg, dev)
    # every rank builds the whole MLLM from the seed and keeps its stage
    with torch.device(dev):
        whole = MultiModalLLM(m.llama, m.qformer, m.use_vision)
    init_params(whole, torch.Generator(device=dev).manual_seed(
        cfg.train.seed))
    stage = P.stage_of(whole, mesh)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    state = TrainState(stage, make_stage1_optimizer(cfg, stage, mesh=mesh),
                       cfg.train.seed, mesh=mesh)
    adamw = state.optimizer.adamw
    train_step, eval_step = P.make_pipelined_stage1_step(mesh, PIPE_MICRO)
    params = dict(stage.named_parameters())
    trainable = [n for n, p in params.items() if p.requires_grad]
    frozen = {n: p.detach().clone() for n, p in params.items()
              if not p.requires_grad}
    start = {n: params[n].detach().clone() for n in trainable}
    out = {"mesh": (mesh.data, mesh.pipe, mesh.pipe_rank),
           "layers": stage.llama.model.layer_ids,
           "build_s": time.perf_counter() - t_rank}

    def restore(snap, opt=None):
        with torch.no_grad():
            for n in trainable:
                params[n].copy_(snap[n])
        if opt is not None:
            # a copy: the optimizer keeps the tensors it is given
            state.optimizer.load_state_dict(copy.deepcopy(opt))

    with fused_scope("on"):
        # (a) the comparison step: clip + SGD, phase 8's first batch
        _sgd(state)
        reset_counts()
        M.reset_counts()
        t0 = time.perf_counter()
        out["cmp_loss"] = float(train_step(state, batches[0], 0, 0)
                                ["lm_loss"])
        torch.cuda.synchronize(dev)
        out["cmp_s"] = time.perf_counter() - t0
        out["cmp_counts"] = read_counts()
        out["cmp_transfers"] = dict(M.COUNTS)
        out["cmp_params"] = {n: params[n].detach().cpu() for n in trainable}
        out["cmp_moved"] = [n for n in trainable
                            if not torch.equal(params[n], start[n])]
        restore(start)
        state.optimizer.adamw = adamw
        # (b) AdamW: a warmup step, then a step twice from one state
        torch.cuda.reset_peak_memory_stats(dev)
        train_step(state, batches[1], 0, 1)
        torch.cuda.synchronize(dev)
        snap = {n: params[n].detach().clone() for n in trainable}
        opt = copy.deepcopy(state.optimizer.state_dict())
        runs = []
        for _ in range(2):
            restore(snap, opt)
            reset_counts()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            loss = float(train_step(state, batches[2], 0, 2)["lm_loss"])
            torch.cuda.synchronize(dev)
            runs.append((time.perf_counter() - t0, loss, read_counts(),
                         {n: params[n].detach().clone() for n in trainable}))
        out["ms"] = [r[0] * 1e3 for r in runs]
        out["losses"] = [r[1] for r in runs]
        out["step_counts"] = runs[0][2]
        out["repeat_equal"] = runs[0][1] == runs[1][1] and all(
            torch.equal(runs[0][3][n], runs[1][3][n]) for n in trainable)
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        del runs, snap, opt
        # (c) the eval step
        reset_counts()
        out["eval"] = float(eval_step(state, batches[5])["lm_loss"])
        out["eval_counts"] = read_counts()
    out["frozen_equal"] = all(torch.equal(params[n], t)
                              for n, t in frozen.items())
    del frozen, start, batches
    # (d) the join: every rank gathers the whole model on the host (as
    # run_stage1 joins it), rank 0 exports the one-process artifact, each
    # rank compares the file with its own state
    t0 = time.perf_counter()
    joined = P.gather_stages(stage, mesh, "cpu")
    path = os.path.join(out_dir, "export")
    if rank == 0:
        with torch.device(dev):
            mllm = MultiModalLLM(m.llama, m.qformer, m.use_vision)
        mllm.load_state_dict(joined)
        export_mllm(mllm, path)
        del mllm
    del joined
    M.barrier()
    out["join_s"] = time.perf_counter() - t0
    stored = torch.load(os.path.join(path, STATE_FILE), mmap=True,
                        weights_only=True)
    own = stage.state_dict()
    out["export_equal"] = all(torch.equal(stored[k], v.cpu())
                              for k, v in own.items())
    out["export_keys"] = len(stored)
    out["rank_s"] = time.perf_counter() - t_rank
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    M.barrier()
    dist.destroy_process_group()


def pipeline_phase(dev, gpu) -> dict:
    """Phase 16: the GPipe pipeline of stage 1 on the one card, two stages
    as two ranks on cuda:0 over gloo: every activation and its gradient
    goes through ``parallel.mesh``'s staged sends (gloo cannot send a CUDA
    tensor).  The one-process reference runs first and is freed; then the
    ranks (``_pipeline_rank``) are held to it and to the checks of the
    module docstring.  Two ranks on one card measure no scaling.  Returns
    the ranks' launches by run."""
    import shutil
    import socket
    import torch
    import torch.multiprocessing as mp
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    from tsue_tpu_torch.train.checkpoint import import_mllm
    t_phase = time.time()
    ref = pipeline_reference(dev)
    cfg = pipeline_cfg()
    m = cfg.model
    out_dir = Path("runs") / f"chip_smoke_pipeline_{os.getpid()}"
    out_dir.mkdir(parents=True, exist_ok=True)
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_pipeline_rank, args=(r, port, str(out_dir)))
             for r in range(PIPE_STAGES)]
    for p in procs:
        p.start()
    deadline = time.time() + PIPE_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.time()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check(all(p.exitcode == 0 for p in procs),
          "phase 16: a rank failed (exit codes "
          f"{[p.exitcode for p in procs]})")
    outs = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(PIPE_STAGES)]
    # the export, read back strictly in one process
    t0 = time.time()
    with torch.device(dev):
        one = MultiModalLLM(m.llama, m.qformer, m.use_vision)
    import_mllm(one, str(out_dir / "export"))
    n_keys = len(one.state_dict())
    del one
    gc.collect()
    torch.cuda.empty_cache()
    read_s = time.time() - t0
    shutil.rmtree(out_dir, ignore_errors=True)

    L, B = m.llama.num_layers, cfg.train.batch_size
    bm, T = B // PIPE_MICRO, m.qformer.num_query_tokens + TEXT_TOKENS
    act_bytes = bm * T * m.llama.hidden_size * 4
    full, micro, pinned = ref["full"], ref["micro"], ref["micro_pinned"]
    scale = max(float((full["after"][n] - ref["start"][n]).abs().max())
                for n in full["after"])
    check(scale > 0, "phase 16: the reference step moved no parameter")
    # the ReLU units the microbatches flip, and their term in the update
    kink = {n: micro["after"][n] - pinned["after"][n] for n in micro["after"]}
    mf, worst = update_diff(full["after"], micro["after"], ref["start"],
                            scale)
    mp, worst_p = update_diff(full["after"], pinned["after"], ref["start"],
                              scale)
    spread, worst_s = update_diff(full["after"], ref["full_plain"]["after"],
                                  ref["start"], scale)
    print(f"pipeline reference, one process: the whole batch's step loss "
          f"{full['loss']:.6f} in {full['s'] * 1e3:.1f} ms (the fused "
          f"switch off: {ref['full_plain']['loss']:.6f}, updates "
          f"{spread:.2e} of the largest apart, worst {worst_s}); the "
          f"{PIPE_MICRO} microbatches' step loss {micro['loss']:.6f} in "
          f"{micro['s'] * 1e3:.1f} ms, updates {mf:.2e} of the largest "
          f"from the whole batch's (worst tensors, difference and own "
          f"largest update over the largest: {worst}); "
          f"{ref['relu_flips']} ReLU unit(s) of the Q-Former's FFNs change "
          f"sign between the whole batch's forward and the microbatches' "
          f"(|pre-activation| at most {ref['relu_flip_pre']:.2e}); with "
          f"the whole batch's ReLU masks the microbatches' updates are "
          f"{mp:.2e} of the largest from the whole batch's (tolerance "
          f"1e-5; worst {worst_p}); gpu: {gpu}", flush=True)
    check(ref["relu_flip_pre"] <= 1e-5, "phase 16: a ReLU unit the "
          "microbatches flip lies off zero by "
          f"{ref['relu_flip_pre']:.2e}: more than rounding")
    check(mp <= 1e-5, f"phase 16: the microbatches' step with the whole "
          f"batch's ReLU masks is {mp:.2e} of the largest update from the "
          f"whole batch's")
    phase8 = TRAIN_STATS.get("stage1", {})
    counts = {}
    check([o["mesh"] for o in outs] == [(1, PIPE_STAGES, r)
                                        for r in range(PIPE_STAGES)],
          f"phase 16: mesh layout {[o['mesh'] for o in outs]}")
    for r, o in enumerate(outs):
        Ls = L // PIPE_STAGES
        check(o["layers"] == list(range(r * Ls, (r + 1) * Ls)),
              f"phase 16 rank {r}: layers {o['layers']}")
        rel = {k: abs(o["cmp_loss"] - x["loss"]) / abs(x["loss"])
               for k, x in (("full", full), ("micro", micro))}
        upd, worst = update_diff(micro["after"], o["cmp_params"],
                                 ref["start"], scale)
        upd_full, worst_full = update_diff(full["after"], o["cmp_params"],
                                           ref["start"], scale)
        # against the whole batch's step, the flipped units' term removed
        upd_whole, worst_whole = update_diff(full["after"], {
            n: t - kink[n] for n, t in o["cmp_params"].items()},
            ref["start"], scale)
        moved = set(o["cmp_moved"])
        lora = [n for n in o["cmp_params"] if n.endswith("lora_b")]
        front = [n for n in o["cmp_params"] if n.startswith("qformer.")]
        print(f"pipeline rank {r} (stage {r}, layers {o['layers'][0]}-"
              f"{o['layers'][-1]}): clip + SGD step loss {o['cmp_loss']:.6f} "
              f"(one process, whole batch {full['loss']:.6f}: rel "
              f"{rel['full']:.2e}; the same microbatches {micro['loss']:.6f}"
              f": rel {rel['micro']:.2e}; tolerance 1e-5); largest "
              f"parameter difference {upd:.2e} of the largest update "
              f"against the one-process step over the same microbatches "
              f"(tolerance 1e-5; worst {worst}), {upd_whole:.2e} against "
              f"the whole batch's with the flipped ReLU units' term "
              f"removed (tolerance 1e-5; worst {worst_whole}), "
              f"{upd_full:.2e} with it (worst {worst_full}); {len(moved)} of "
              f"{len(o['cmp_params'])} trainable tensors moved; base Llama "
              f"bit-identical after all steps: {o['frozen_equal']}; gpu: "
              f"{gpu}", flush=True)
        check(max(rel.values()) <= 1e-5, f"phase 16 rank {r}: loss rel {rel}")
        check(upd <= 1e-5, f"phase 16 rank {r}: updates {upd}")
        check(upd_whole <= 1e-5, f"phase 16 rank {r}: updates against the "
              f"whole batch's step {upd_whole}")
        check(o["frozen_equal"], f"phase 16 rank {r}: the base Llama moved")
        check(lora and set(lora) <= moved,
              f"phase 16 rank {r}: LoRA B did not move")
        check(front and set(front) <= moved | {
            n for n in front if not full["after"][n].ne(
                ref["start"][n]).any()},
            f"phase 16 rank {r}: the Q-Former did not move")
        check(o["repeat_equal"], f"phase 16 rank {r}: a repeated step from "
                                 "the same state and seeds differs")
        want = pipeline_launches(cfg, r)
        for run in ("cmp", "step"):
            check(o[f"{run}_counts"] == want, f"phase 16 rank {r} {run}: "
                  f"launches {o[run + '_counts']} != {want}")
        check(o["eval_counts"] == want, f"phase 16 rank {r} eval: launches "
              f"{o['eval_counts']} != {want}")
        tr = o["cmp_transfers"]
        staged = {k: tr.get(k, 0) for k in (
            "send_staged", "recv_staged", "send_staged_bytes",
            "recv_staged_bytes")}
        want_staged = dict(send_staged=PIPE_MICRO, recv_staged=PIPE_MICRO,
                           send_staged_bytes=PIPE_MICRO * act_bytes,
                           recv_staged_bytes=PIPE_MICRO * act_bytes)
        print(f"pipeline rank {r}: transfers a step {json.dumps(tr)} (2 x "
              f"{PIPE_MICRO} staged a boundary, ({bm}, {T}, "
              f"{m.llama.hidden_size}) fp32 = {act_bytes} bytes each); "
              f"launches a step {json.dumps(o['step_counts'])}; gpu: {gpu}",
              flush=True)
        check(staged == want_staged and not tr.get("send")
              and not tr.get("recv"),
              f"phase 16 rank {r}: transfers {tr} != {want_staged}")
        check(o["export_equal"] and o["export_keys"] == n_keys,
              f"phase 16 rank {r}: the export differs from the rank's state")
        counts[f"phase 16 pipeline step (clip + SGD) rank {r}"] = \
            o["cmp_counts"]
        counts[f"phase 16 pipeline steps (AdamW, 3) rank {r}"] = {
            k: 3 * v for k, v in o["step_counts"].items()}
        counts[f"phase 16 pipeline eval rank {r}"] = o["eval_counts"]
        ms = ", ".join(f"{t:.1f}" for t in o["ms"])
        ms8 = ", ".join(f"{t:.1f}" for t in phase8.get("ms", []))
        print(f"pipeline rank {r}: AdamW step {ms} ms (losses "
              f"{o['losses']}, repeat bit-identical) against phase 8's "
              f"one-process {ms8} ms; "
              f"clip + SGD step {o['cmp_s'] * 1e3:.1f} ms (one process "
              f"{full['s'] * 1e3:.1f} ms); peak memory {o['peak_gib']:.2f} "
              f"GiB (phase 8, one process: "
              f"{phase8.get('peak_gib', float('nan')):.2f} GiB); eval loss "
              f"{o['eval']:.6f}; build {o['build_s']:.1f}s, join + export "
              f"{o['join_s']:.1f}s, rank {o['rank_s']:.1f}s -- two ranks "
              f"share one card: no scaling is measured; gpu: {gpu}",
              flush=True)
    check(len({o["eval"] for o in outs}) == 1, "phase 16: eval losses "
          f"differ across ranks {[o['eval'] for o in outs]}")
    check(len({o["cmp_loss"] for o in outs}) == 1,
          "phase 16: the step's loss differs across ranks")
    print(f"pipeline phase: export of {n_keys} tensors read back strictly "
          f"in one process in {read_s:.1f}s, equal to both ranks' states; "
          f"{time.time() - t_phase:.1f}s in all; gpu: {gpu}", flush=True)
    return counts


# --------------------------------------------------------------------------
# 18. the trained-weight studies
# --------------------------------------------------------------------------

STUDY_SEEDS = 2
# the keys of scripts/study_speculative_acceptance.py's JSON line
SPEC_KEYS = ("tok_per_fwd", "token_agreement", "plain_tok_s", "spec_tok_s",
             "speedup", "final_lm_loss", "window", "epochs", "split")


def study_phase(dev, gpu) -> dict:
    """Phase 18: the two trained-weight studies through their commands'
    ``main`` at the mid-size configuration they publish
    (``cli._common.midsize_cfg``), only epochs, seeds and repeats cut,
    under a temporary out_dir removed afterwards.
    (a) ``study_fast_vs_parity``: joint stage 2 for 2 epochs (of 30) on 40
    synthetic tracks with the fused switch on, then K=10 in the fast and
    the parity mode over 2 eval seeds (of 5): ``study.json``'s layout,
    finite metrics, the file equal to the returned dict, launches (the
    Llama's 2 L + 1 RMSNorms to L SwiGLU products a forward).
    (b) ``study_speculative_acceptance``: stage 1 for 3 epochs (of 100) on
    20 tracks, one plain and one speculative W8 greedy call (1 repeat of
    3), the switch off: the JAX script's keys, finite rates; then the
    export read back and the speculative program run once more on the
    study's prompts: each row's window forwards between ceil(emitted / 8)
    and its emitted tokens, and the study's tokens a forward; a plain and
    a speculative call timed (ms a decode step, ms a window forward) and
    profiled (busy and idle shares).  Returns the launch counts of the two
    commands' runs."""
    import contextlib
    import io
    import shutil
    import tempfile
    import numpy as np
    import torch
    from tsue_tpu_torch.cli import study_fast_vs_parity as fvp
    from tsue_tpu_torch.cli import study_speculative_acceptance as sa
    from tsue_tpu_torch.cli._common import (apply_overrides, emitted,
                                            midsize_cfg)
    from tsue_tpu_torch.data import get_tokenizer
    from tsue_tpu_torch.eval.generation import make_generate_fn
    from tsue_tpu_torch.eval.speculative import make_speculative_generate_fn
    from tsue_tpu_torch.ops.fused import fused_scope

    t_phase = time.time()
    L = midsize_cfg("study").model.llama.num_layers
    runs = Path(__file__).resolve().parent / "runs"
    runs.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="studies_", dir=runs)
    counts = {}
    try:
        # (a) fast against parity
        argv = ["--epochs", "2", "--seeds", str(STUDY_SEEDS), "--k", "10",
                "--synthetic-tracks", "40", "--out-dir", tmp]
        reset_counts()
        t0 = time.time()
        printed = io.StringIO()
        with fused_scope("on"), contextlib.redirect_stdout(printed):
            study = fvp.main(argv)
        wall_a = time.time() - t0
        c = read_counts()
        counts["study fast_vs_parity (joint, 2 epochs, K=10, 2 seeds x "
               "2 modes, fused switch on)"] = c
        with open(os.path.join(tmp, "study_fast_vs_parity",
                               "study.json")) as f:
            check(json.load(f) == study, "study_fast_vs_parity: study.json "
                  "differs from the returned dict")
        check(list(study) == ["k", "seeds", "epochs", "summary", "raw"]
              and (study["k"], study["seeds"], study["epochs"]) ==
              (10, STUDY_SEEDS, 2), f"study_fast_vs_parity: {list(study)}")
        raw = np.array([study["raw"][m] for m in ("fast", "parity")])
        check(raw.shape == (2, STUDY_SEEDS, 3) and np.isfinite(raw).all()
              and (raw > 0).all(), f"study_fast_vs_parity: raw {raw}")
        check(all(set(v) == {"fast_mean", "fast_std", "parity_mean",
                             "parity_std", "delta_pct"}
                  and np.isfinite(list(v.values())).all()
                  for v in study["summary"].values()),
              f"study_fast_vs_parity: summary {study['summary']}")
        check(c["flash_attn_fwd"] > 0 and c["swiglu_matmul"] > 0
              and c["rmsnorm"] * L == c["swiglu_matmul"] * (2 * L + 1)
              and not any(c[k] for k in c if k not in (
                  "flash_attn_fwd", "rmsnorm", "swiglu_matmul")),
              f"study_fast_vs_parity: launches {c}")
        table = [ln for ln in printed.getvalue().splitlines()
                 if ln.startswith("|")]
        print("\n".join(table), flush=True)
        print(f"study fast_vs_parity: {wall_a:.1f}s, launches "
              f"{json.dumps(c)}; gpu: {gpu}", flush=True)

        # (b) speculative acceptance
        argv = ["--epochs", "3", "--synthetic-tracks", "20", "--reps", "1",
                "--out-dir", tmp]
        reset_counts()
        t0 = time.time()
        printed = io.StringIO()
        with fused_scope("off"), contextlib.redirect_stdout(printed):
            res = sa.main(argv)
        wall_b = time.time() - t0
        c = read_counts()
        counts["study speculative (stage 1, 3 epochs, plain + W8 "
               "greedy)"] = c
        check(tuple(res) == SPEC_KEYS and json.loads(
            printed.getvalue().splitlines()[-1]) == res,
              f"study_speculative_acceptance: keys {list(res)}")
        check(all(np.isfinite(res[k]) and res[k] > 0 for k in (
            "tok_per_fwd", "plain_tok_s", "spec_tok_s", "speedup",
            "final_lm_loss")) and 0 <= res["token_agreement"] <= 1
            and (res["window"], res["epochs"]) == (8, 3),
            f"study_speculative_acceptance: {res}")
        check(c["flash_attn_fwd"] > 0 and not any(
            c[k] for k in c if k != "flash_attn_fwd"),
            f"study_speculative_acceptance: launches {c}")
        args = sa.parser().parse_args(argv)
        cfg = apply_overrides(midsize_cfg("study_spec_accept"), args)
        tok = get_tokenizer(None)
        mllm = sa.load_mllm(cfg, tok, os.path.join(tmp, "spec_accept_mllm"),
                            dev)
        inputs = [torch.from_numpy(a).to(dev) for a in sa.study_inputs(
            cfg, None, tok, args.synthetic_tracks, args.split, args.bs)]
        check(tuple(inputs[1].shape) == (16, 640),
              f"study prompts {tuple(inputs[1].shape)}")
        spec = make_speculative_generate_fn(
            mllm, sa.greedy_config("none"), args.max_new,
            inputs[1].shape[1], tok.eos_id, tok.pad_id, window=args.window,
            with_stats=True)
        ids, n_fwd = spec(*inputs, None)
        ids, n_fwd = ids.cpu().numpy(), n_fwd.cpu().numpy()
        rows = emitted(ids, tok.eos_id)
        check(ids.shape == (16, args.max_new) and (n_fwd <= rows).all()
              and (n_fwd >= -(-rows // args.window)).all(),
              f"speculative forwards {n_fwd.tolist()} against emitted "
              f"{rows.tolist()}")
        check(round(int(rows.sum()) / float(n_fwd.sum()), 2)
              == res["tok_per_fwd"], f"speculative tokens a forward "
              f"{rows.sum()} / {n_fwd.sum()} against {res['tok_per_fwd']}")
        print(f"study speculative: {wall_b:.1f}s, {json.dumps(res)}; "
              f"forwards a row {n_fwd.tolist()}, emitted {rows.tolist()}; "
              f"launches {json.dumps(c)}; gpu: {gpu}", flush=True)
        # what a decode step and a window forward cost at this width: one
        # warm call of each program, then each under the profiler
        plain = make_generate_fn(mllm, sa.greedy_config("none"),
                                 args.max_new, inputs[1].shape[1],
                                 tok.eos_id, tok.pad_id)

        def timed(fn):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn(*inputs, None)
            torch.cuda.synchronize(dev)
            return time.perf_counter() - t0
        timed(plain)
        wall_p, wall_s = timed(plain), timed(spec)
        print(f"study decode cost: plain {plain.steps} steps in "
              f"{wall_p * 1e3:.1f} ms ({wall_p * 1e3 / plain.steps:.3f} ms a "
              f"step, the prefill included), speculative {spec.forwards} "
              f"window forwards in {wall_s * 1e3:.1f} ms "
              f"({wall_s * 1e3 / spec.forwards:.3f} ms a forward); gpu: "
              f"{gpu}", flush=True)
        profile_device(dev, gpu, "study plain greedy call", wall_p,
                       lambda: plain(*inputs, None))
        profile_device(dev, gpu, "study speculative W8 call", wall_s,
                       lambda: spec(*inputs, None))
        del mllm, spec, plain
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"study phase: {time.time() - t_phase:.1f}s in all; gpu: {gpu}",
          flush=True)
    return counts


def _build_head_split(out: dict) -> None:
    """head_variants.split_libs() into ``out`` (or its error), in a
    thread."""
    try:
        import head_variants
        out.update(head_variants.split_libs())
    except Exception as exc:    # reported by the caller's check
        out["error"] = repr(exc)


def main() -> int:
    t_start = time.time()
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
    # the head's product-alone and selection-alone variants, built beside
    # the kernels (head_variants.py; timed beside the head's forms only)
    head_split: dict = {}
    split_build = threading.Thread(target=_build_head_split,
                                   args=(head_split,))
    split_build.start()
    libs = build_all(list(KERNELS))
    split_build.join()
    check("error" not in head_split, "the head's split variants did not "
          f"build: {head_split.get('error')}")
    print(f"build: {', '.join(KERNELS)} in {time.time() - t0:.1f}s "
          "(one nvcc each, in parallel, with the head's two split "
          "variants)", flush=True)
    for name, (_, report) in libs.items():
        for line in report.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  ptxas {name}: " + line.strip(), flush=True)

    timer = Timer(dev)
    # the timer's floor: a launch that does almost nothing
    print(f"launch_floor_ms {timer.floor_ms:.4f} (one-element zero_, this "
          f"timer); gpu: {gpu}", flush=True)
    int8_rows = int8_checks(dev, gpu, timer)
    lm_head_ms = next(x["ms"] for x in int8_rows
                      if x["shape"].startswith("lm_head M=16"))
    rows = {"flash_attn_fwd": flash_checks(dev, gpu, timer),
            "int8_matmul": int8_rows,
            "lmhead_topk": head_checks(dev, gpu, timer, lm_head_ms,
                                       head_split),
            "attend_int8_kv": attend_checks(dev, gpu, timer),
            **fused_checks(dev, gpu, timer)}
    for name, extra in bf16_checks(dev, gpu, timer).items():
        rows[name] += extra
    for name, extra in shard_shape_checks(dev, gpu, timer,
                                          head_split).items():
        rows[name] += extra
    for name, extra in microbatch_shape_checks(dev, gpu, timer).items():
        rows[name] += extra
    for name, extra in study_shape_checks(dev, gpu, timer).items():
        rows[name] += extra
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
    predict_counts, fused_predict_counts, first_request = predict_phase(
        dev, gpu, cfg, state)
    ref_ckpt_counts = reference_ckpt_phase(dev, gpu, cfg, state,
                                           fused_predict_counts,
                                           first_request)
    gen_counts, head_counts, off_counts = generation_phase(dev, gpu, cfg,
                                                           state)
    pool_counts, http_counts = serving_phase(dev, gpu, cfg, state)
    spec_counts = speculative_phase(dev, gpu, cfg, state)
    del state
    # the serving phases' objects hold device memory through reference
    # cycles: collect them, or the training phases' peaks include them
    gc.collect()
    torch.cuda.empty_cache()
    train_counts = {preset: train_phase(dev, gpu, preset)
                    for preset in TRAIN_PRESETS}
    stage1_counts = stage1_phase(dev, gpu)
    eval_counts = eval_from_disk_phase(dev, gpu)
    p12_counts = bf16_remat_phase(dev, gpu)
    p13_counts = comparison_phase(dev, gpu)
    p14_rows, p14_counts = bf16_decode_phase(dev, gpu, head_split)
    for name, extra in p14_rows.items():
        rows[name] += extra
    gc.collect()
    torch.cuda.empty_cache()
    p15_counts = parallel_phase(dev, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    p16_counts = pipeline_phase(dev, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    p18_counts = study_phase(dev, gpu)

    def head(name):
        """The kernel's line: its main-path shape (int8: the sum over one
        decoder layer's seven projections; the three kernels with no path:
        where they would sit, at batch 16)."""
        r = [x for x in rows[name] if not x.get("shard")
             and not x.get("microbatch") and not x.get("study")]
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
        else:                                  # S = 592, a decode step
            pick = [x for x in r
                    if x["shape"] == "S=592 B=16 32/8x64 Tq=1"]
        # the contract's bound is the roofline's (bytes or operations);
        # the tiny kernels' floor-inclusive bound stands beside it
        roof = [(x.get("roofline_bound_ms", x["bound_ms"]),
                 x.get("roofline_bound_by", x["bound_by"])) for x in pick]
        out = {"ms": sum(x["ms"] for x in pick),
               "plain_ms": sum(x["plain_ms"] for x in pick),
               "bound_ms": sum(b for b, _ in roof),
               "bound_by": max(roof)[1],
               "library_ms": (None if any(x["library_ms"] is None
                                          for x in pick)
                              else sum(x["library_ms"] for x in pick)),
               "shape": (pick[0]["shape"] if len(pick) == 1 else
                         "one decoder layer's 7 projections, M=16")}
        if name in FLOOR_BOUND:
            out.update(floor_ms=pick[0]["floor_ms"],
                       floor_bound_ms=pick[0]["bound_ms"])
        return out

    by_path = {name: {
        "predict": predict_counts.get(name, 0),
        "predict_fused": fused_predict_counts[name],
        "generate_all_switches": gen_counts[name],
        "generate_fused_head": head_counts[name],
        "generate_switches_off": off_counts[name],
        f"serve pool ({POOL_TRACKS} requests)": pool_counts[name],
        "serve http": http_counts[name],
        **{run: c[name] for run, c in spec_counts.items()},
        **{f"train {p} (3 steps)": train_counts[p][name]
           for p in TRAIN_PRESETS},
        "stage1 train_18_30 (3 steps)": stage1_counts[name],
        **{f"eval from disk, {mode} (K=10)": eval_counts[mode][name]
           for mode in ("fast", "parity")},
        **{run: c[name] for run, c in p12_counts.items()},
        **{run: c[name] for run, c in p13_counts.items()},
        **{run: c[name] for run, c in p14_counts.items()},
        **{run: c[name] for run, c in p15_counts.items()},
        **{run: c[name] for run, c in p16_counts.items()},
        **{run: c[name] for run, c in p18_counts.items()},
        **{run: c[name] for run, c in ref_ckpt_counts.items()}}
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
    def bf16_forms(name):
        """The bf16 forms' lines (phase 14): int8, the sum over a decode
        step's seven projections and the LM head's; the head, each form on
        random inputs; the int8-KV attention, the phase's cache."""
        r = p14_rows.get(name, [])
        if name == "int8_matmul":
            # a decode step of the int8 arms: each projection shape as
            # often as a layer has it, and the LM head once
            times = [x["bf16_per_layer"] or int("lm_head" in x["shape"])
                     for x in r]
            groups = {"one decoder layer's 7 projections + LM head, M=16, "
                      "bf16 x": [x for x, n in zip(r, times)
                                 for _ in range(n)]}
        elif name == "lmhead_topk":
            groups = {x["shape"]: [x] for x in r if not x["exact"]}
        else:
            groups = {x["shape"]: [x] for x in r}
        return {shape: {"ms": sum(x["ms"] for x in pick),
                        "plain_ms": sum(x["plain_ms"] for x in pick),
                        "bound_ms": sum(x["bound_ms"] for x in pick),
                        "bound_by": max((x["bound_ms"], x["bound_by"])
                                        for x in pick)[1],
                        "library_ms": sum(x["library_ms"] for x in pick)}
                for shape, pick in groups.items()}

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
        if name in p14_rows:
            entry["bf16_forms"] = bf16_forms(name)
        for mark, key in (("shard", "shard_shapes"),
                          ("microbatch", "microbatch_shapes"),
                          ("study", "study_shapes")):
            # phase 3 at phase 15's local, phase 16's microbatch and phase
            # 18's study shapes
            marked = [x for x in rows[name] if x.get(mark)]
            if marked:
                entry[key] = {x["shape"]: {
                    k: x[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "max_abs_err")} for x in marked}
        kernels.append(entry)
    print(f"chip_smoke: {time.time() - t_start:.1f}s in all, the build "
          f"included; gpu: {gpu}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
