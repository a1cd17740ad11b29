#!/usr/bin/env python3
"""Check that the forms of the flash, SwiGLU and RMSNorm kernels that a
change left alone give the same bits as an earlier source's, and time the
redesigned forms beside the earlier ones, on one GPU.

    python3 bits_vs_source.py --old-dir DIR [--out FILE]

DIR holds earlier sources ``flash_attn_fwd.cu``, ``swiglu_matmul.cu`` and
``rmsnorm.cu`` (e.g. ``git show <commit>:tsue_tpu_torch/csrc/<name>.cu >
DIR/<name>.cu``, with DIR under ``runs/``, which git ignores).  Each is
built with nvcc into ``build/bits_vs_source/`` beside the current sources.
On the same inputs through both libraries, these must be equal bit for
bit: every fp32 call of chip_smoke.py's attention cases (the tiled and
split-KV forms, the per-query masks of the speculative windows); every
one of them without a per-query mask at D <= 128 with fp32 q over bf16
k/v; every one with all-bf16 operands that takes the tensor-core form
"bf16_mma" or the decode form "bf16_decode"; the SwiGLU product in fp32
and in bf16 at chip_smoke.py's fused shapes (batch 16 and 8); RMSNorm with
bf16 x over fp32 and bf16 scales at the same rows.  Then the forms
redesigned since the earlier source are checked against their plain
versions and timed with chip_smoke.py's timer in turns, old, new, new,
old: flash's wide form "bf16_wide" at chip_smoke.py's LTSF
cross-attention (B 16, 18 queries over 528 keys, 2 heads of 1024, a key
mask) with fp32 q over bf16 k/v and all bf16 (chip_smoke.py's BF_TOL);
RMSNorm's "fp32_stream" at chip_smoke.py's fused rows (8448, 4224 and 2112
rows of 2048) over fp32 and bf16 scales (chip_smoke.py's TOL), with
``F.rms_norm`` timed beside, and a variant of the current source with its
streaming cache hints toggled (``HINTS``), timed between the two new
turns, and ``y.copy_(x)`` beside (the same bytes streamed by one copy);
and "bf16_stream" at 8448 rows, timed the same way.  Exits 1 on any
difference or disagreement.  It needs a CUDA device and nvcc, and prints
the card beside every time.
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

# the x loads and out stores of rmsnorm.cu without and with streaming
# hints (ld.global.cs, st.global.cs); the variant swaps each pair
HINTS = (("return __ldg(p); }", "return __ldcs(p); }"),
         ("{ *p = v; }", "{ __stcs(p, v); }"))


def toggled_hints(src: str) -> str:
    """``src`` with each of ``HINTS`` swapped for its other half."""
    for plain, hinted in HINTS:
        if plain in src:
            src = src.replace(plain, hinted)
        elif hinted in src:
            src = src.replace(hinted, plain)
        else:
            raise ValueError(f"rmsnorm.cu has neither {plain!r} nor "
                             f"{hinted!r}")
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-dir", type=Path, required=True,
                    help="the earlier flash_attn_fwd.cu, swiglu_matmul.cu "
                         "and rmsnorm.cu")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the results here as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bits_vs_source: no CUDA device", file=sys.stderr)
        return 1
    import tsue_tpu_torch.ops.flash as FL
    import tsue_tpu_torch.ops.fused as FU
    from tsue_tpu_torch.ops._build import BUILD_DIR, CSRC, build_variants
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    out_dir = BUILD_DIR / "bits_vs_source"
    ptr, i32 = ctypes.c_void_p, ctypes.c_int

    def old_lib(name, signatures):
        return build_variants({"old": (args.old_dir / f"{name}.cu")
                               .read_text()}, out_dir / name,
                              signatures)["old"][0]
    flash = {"old": build_flash(
        {"old": (args.old_dir / "flash_attn_fwd.cu").read_text()},
        out_dir / "flash")["old"], "new": FL._lib()}
    swiglu = {"old": old_lib("swiglu_matmul", {
        "swiglu_matmul": [ptr] * 5 + [i32] * 3 + [ptr],
        "swiglu_matmul_bf16": [ptr] * 4 + [i32] * 3 + [ptr],
        "swiglu_matmul_ctas": []}), "new": FU._swiglu_lib()}
    rms_sig = {"rmsnorm": [ptr, ptr, ptr, i32, i32, ctypes.c_float, i32,
                           i32, ptr],
               "rmsnorm_max_k": []}
    rms = {"old": old_lib("rmsnorm", rms_sig), "new": FU._rmsnorm_lib(),
           "hints": build_variants(
               {"hints": toggled_hints((CSRC / "rmsnorm.cu").read_text())},
               out_dir / "rmsnorm_hints", rms_sig)["hints"][0]}
    dev = torch.device("cuda:0")
    result: dict = {"gpu": gpu, "equal": {}, "ms": {}}
    wrong = []

    def flash_with(name, kw):
        FL._lib = lambda: flash[name]      # the wrapper's binding
        return FL.flash_attention(**kw)

    def rms_with(name, x, s):
        FU._rmsnorm_lib = lambda: rms[name]
        return FU.fused_rmsnorm(x, s, 1e-5)

    def same(label, a, b):
        torch.cuda.synchronize()
        eq = torch.equal(a, b)
        result["equal"][label] = eq
        print(f"{label}: bit-identical to the old source: {eq}", flush=True)
        if not eq:
            wrong.append(label)

    bf = torch.bfloat16
    cases = cs.attention_cases(dev)
    for case, kw in cases:
        same(f"flash fp32 {case}", flash_with("old", kw),
             flash_with("new", kw))
    for case, kw in cases:
        if kw.get("mask") is not None and kw["mask"].dim() == 3:
            continue       # per-query masks: fp32 only
        (B, Tq, Hq, D), (Tk, Hkv) = kw["q"].shape, kw["k"].shape[1:3]
        if D > 128:
            continue       # bf16 k/v at D = 1024: the wide form, timed below
        mixed = dict(kw, k=kw["k"].to(bf), v=kw["v"].to(bf))
        same(f"flash fp32 q, bf16 k/v {case}", flash_with("old", mixed),
             flash_with("new", mixed))
        all_bf = dict(mixed, q=kw["q"].to(bf))
        FL._lib = lambda: flash["new"]
        form = FL.flash_attention_form(B, Tq, Tk, Hq, Hkv, D,
                                       kw.get("rope") is not None, False,
                                       bf, bf)
        if form in ("bf16_mma", "bf16_decode"):
            same(f"flash {form} {case}", flash_with("old", all_bf),
                 flash_with("new", all_bf))
        del mixed, all_bf
    g = torch.Generator(device=dev).manual_seed(4)
    I, D = 8192, 2048
    for B in (16, 8):
        M = B * (16 + cs.TEXT_TOKENS)
        for dtype in (torch.float32, bf):
            gate = torch.randn(M, I, generator=g, device=dev).to(dtype)
            up = torch.randn(M, I, generator=g, device=dev).to(dtype)
            w = (torch.randn(I, D, generator=g, device=dev)
                 * I ** -0.5).to(dtype)
            same(f"swiglu {str(dtype)[6:]} M={M}",
                 _caller(FU, swiglu["old"], gate, up, w)(),
                 _caller(FU, swiglu["new"], gate, up, w)())
            del gate, up, w
        x = torch.randn(M, D, generator=g, device=dev).to(bf)
        for sd in (torch.float32, bf):
            s = (1.0 + 0.1 * torch.randn(D, generator=g, device=dev)).to(sd)
            same(f"rmsnorm bf16 x, {str(sd)[6:]} scale M={M}",
                 rms_with("old", x, s), rms_with("new", x, s))
        del x

    timer = cs.Timer(dev)
    kw = dict(cases)["ltsf_cross"]
    mixed = dict(kw, k=kw["k"].to(bf), v=kw["v"].to(bf))
    all_bf = dict(mixed, q=kw["q"].to(bf))
    timed = {
        "flash fp32 q, bf16 k/v ltsf_cross": (
            lambda name: flash_with(name, mixed),
            FL.flash_attention_plain(**mixed)),
        "flash bf16 ltsf_cross": (
            lambda name: flash_with(name, all_bf),
            FL.flash_attention_plain(**all_bf))}
    for label, (call, ref) in timed.items():
        for name in ("old", "new", "new", "old"):
            out = call(name)
            torch.cuda.synchronize()
            if not torch.allclose(out.float(), ref.float(), **cs.BF_TOL):
                wrong.append(f"{label} ({name})")
            ms = timer.ms(lambda: call(name))
            result["ms"].setdefault(f"{label} {name}", []).append(ms)
            print(f"{label} {name}: {ms:.4f} ms; gpu: {gpu}", flush=True)

    # RMSNorm: "fp32_stream" at the fused rows, "bf16_stream" at 8448
    rms_cases = [(M, torch.float32, sd) for M in (8448, 4224, 2112)
                 for sd in (torch.float32, bf)] + [(8448, bf, bf)]
    for M, xd, sd in rms_cases:
        x = torch.randn(M, D, generator=g, device=dev).to(xd)
        s = (1.0 + 0.1 * torch.randn(D, generator=g, device=dev)).to(sd)
        ref = FU.rmsnorm_plain(x, s, 1e-5).float()
        tol = cs.TOL if xd == torch.float32 else cs.BF_TOL
        label = (f"rmsnorm {str(xd)[6:]} x, {str(sd)[6:]} scale "
                 f"({M}, {D})")
        for name in ("old", "new", "hints", "hints", "new", "old"):
            out = rms_with(name, x, s)
            torch.cuda.synchronize()
            if not torch.allclose(out.float(), ref, **tol):
                wrong.append(f"{label} ({name})")
            ms = timer.ms(lambda: rms_with(name, x, s))
            result["ms"].setdefault(f"{label} {name}", []).append(ms)
            print(f"{label} {name}: {ms:.5f} ms; gpu: {gpu}", flush=True)
        s_x = s.to(xd)     # F.rms_norm takes one dtype
        lib = timer.ms(lambda: torch.nn.functional.rms_norm(x, (D,), s_x,
                                                            1e-5))
        # the same bytes read once and written once by one PyTorch copy:
        # what the card streams in practice
        y = torch.empty_like(x)
        copy = timer.ms(lambda: y.copy_(x))
        result["ms"][f"{label} F.rms_norm"] = [lib]
        result["ms"][f"{label} copy_"] = [copy]
        print(f"{label} F.rms_norm: {lib:.5f} ms, copy_ of x: {copy:.5f} "
              f"ms, launch floor {timer.floor_ms:.5f} ms; gpu: {gpu}",
              flush=True)
        del x, s, s_x, ref, y
    FL._lib = lambda: flash["new"]
    FU._rmsnorm_lib = lambda: rms["new"]
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
