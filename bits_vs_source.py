#!/usr/bin/env python3
"""Check that the fp32 calls of the flash and SwiGLU kernels give the same
bits as an earlier source's, and time both kernels' bf16 forms beside the
earlier ones, on one GPU.

    python3 bits_vs_source.py --old-dir DIR [--out FILE]

DIR holds earlier sources ``flash_attn_fwd.cu`` and ``swiglu_matmul.cu``
(e.g. ``git show <commit>:tsue_tpu_torch/csrc/<name>.cu > DIR/<name>.cu``,
with DIR under ``runs/``, which git ignores).  Each is built with nvcc
into ``build/bits_vs_source/`` beside the current sources.  Every fp32 call
of chip_smoke.py's attention cases (the tiled and split-KV forms, the
per-query masks of the speculative windows) and the fp32 SwiGLU product at
chip_smoke.py's fused shapes (batch 16 and 8) runs through both libraries
on the same inputs, and the outputs must be equal bit for bit.  Then the
bf16 forms at chip_smoke.py's shapes (flash: the Llama's and the
Q-Former's self-attention; SwiGLU: the training shape) are checked against
their plain versions (chip_smoke.py's BF_TOL; SwiGLU rtol 2^-7, atol 2^-7
of the largest output) and timed with chip_smoke.py's timer in turns: old,
new, new, old.  Exits 1 on any fp32 difference or bf16 disagreement.  It
needs a CUDA device and nvcc, and prints the card beside every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import chip_smoke as cs
from flash_variants import build as build_flash
from swiglu_variants import _caller


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-dir", type=Path, required=True,
                    help="the earlier flash_attn_fwd.cu and swiglu_matmul.cu")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the results here as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bits_vs_source: no CUDA device", file=sys.stderr)
        return 1
    import tsue_tpu_torch.ops.flash as FL
    import tsue_tpu_torch.ops.fused as FU
    from tsue_tpu_torch.ops._build import BUILD_DIR, build_variants
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    out_dir = BUILD_DIR / "bits_vs_source"
    flash = {"old": build_flash(
        {"old": (args.old_dir / "flash_attn_fwd.cu").read_text()},
        out_dir / "flash")["old"], "new": FL._lib()}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    swiglu = {"old": build_variants(
        {"old": (args.old_dir / "swiglu_matmul.cu").read_text()},
        out_dir / "swiglu", {
            "swiglu_matmul": [ptr] * 5 + [i32] * 3 + [ptr],
            "swiglu_matmul_bf16": [ptr] * 4 + [i32] * 3 + [ptr],
            "swiglu_matmul_ctas": []})["old"][0], "new": FU._swiglu_lib()}
    dev = torch.device("cuda:0")
    result: dict = {"gpu": gpu, "fp32_equal": {}, "bf16_ms": {}}
    wrong = []

    def flash_with(name, kw):
        FL._lib = lambda: flash[name]      # the wrapper's binding
        return FL.flash_attention(**kw)

    for case, kw in cs.attention_cases(dev):
        a, b = flash_with("old", kw), flash_with("new", kw)
        torch.cuda.synchronize()
        same = torch.equal(a, b)
        result["fp32_equal"][f"flash {case}"] = same
        print(f"fp32 flash {case}: bit-identical to the old source: {same}",
              flush=True)
        wrong += [] if same else [f"flash {case}"]
    g = torch.Generator(device=dev).manual_seed(4)
    I, D = 8192, 2048
    for B in (16, 8):
        M = B * (16 + cs.TEXT_TOKENS)
        gate = torch.randn(M, I, generator=g, device=dev)
        up = torch.randn(M, I, generator=g, device=dev)
        w = torch.randn(I, D, generator=g, device=dev) * I ** -0.5
        a = _caller(FU, swiglu["old"], gate, up, w)()
        b = _caller(FU, swiglu["new"], gate, up, w)()
        torch.cuda.synchronize()
        same = torch.equal(a, b)
        result["fp32_equal"][f"swiglu M={M}"] = same
        print(f"fp32 swiglu M={M} K={I} N={D}: bit-identical to the old "
              f"source: {same}", flush=True)
        wrong += [] if same else [f"swiglu M={M}"]
        del gate, up, w, a, b

    timer = cs.Timer(dev)
    bf = torch.bfloat16
    cases = dict(cs.attention_cases(dev))
    for case in ("llama_self", "qformer_self"):
        kw = dict(cases[case])
        kw.update(q=kw["q"].to(bf), k=kw["k"].to(bf), v=kw["v"].to(bf))
        ref = FL.flash_attention_plain(**kw).float()
        for name in ("old", "new", "new", "old"):
            out = flash_with(name, kw).float()
            torch.cuda.synchronize()
            if not torch.allclose(out, ref, **cs.BF_TOL):
                wrong.append(f"bf16 flash {case} ({name})")
            ms = timer.ms(lambda: flash_with(name, kw))
            result["bf16_ms"].setdefault(f"flash {case} {name}",
                                         []).append(ms)
            print(f"bf16 flash {case} {name}: {ms:.4f} ms; gpu: {gpu}",
                  flush=True)
    FL._lib = lambda: flash["new"]
    M = 16 * (16 + cs.TEXT_TOKENS)
    gate = torch.randn(M, I, generator=g, device=dev).to(bf)
    up = torch.randn(M, I, generator=g, device=dev).to(bf)
    w = (torch.randn(I, D, generator=g, device=dev) * I ** -0.5).to(bf)
    ref = FU.swiglu_matmul_plain(gate, up, w).float()
    atol = 2 ** -7 * ref.abs().max().item()
    for name in ("old", "new", "new", "old"):
        call = _caller(FU, swiglu[name], gate, up, w)
        out = call().float()
        torch.cuda.synchronize()
        if not torch.allclose(out, ref, rtol=2 ** -7, atol=atol):
            wrong.append(f"bf16 swiglu ({name})")
        ms = timer.ms(call)
        result["bf16_ms"].setdefault(f"swiglu {name}", []).append(ms)
        print(f"bf16 swiglu M={M} K={I} N={D} {name}: {ms:.4f} ms; gpu: "
              f"{gpu}", flush=True)
    result["wrong"] = wrong
    print(json.dumps(result), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    if wrong:
        print(f"bits_vs_source: {wrong}", flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
