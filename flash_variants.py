#!/usr/bin/env python3
"""Time text variants of the flash-attention kernel side by side on one GPU.

    python3 flash_variants.py [--dtype bfloat16] [--old-source FILE]
                              [--out build/flash_variants.json]

Each variant is ``tsue_tpu_torch/csrc/flash_attn_fwd.cu`` with one edit
(``EDITS``), built with nvcc into ``build/flash_variants/`` (all in
parallel) and swapped in under ``tsue_tpu_torch.ops.flash``.  Every variant
is timed on chip_smoke.py's attention cases with chip_smoke.py's timer (L2
flushed, median of 15), in two rounds, the second in reverse order, so a
drift of the card does not favour one variant.  ``--old-source`` adds an
earlier source of the kernel (e.g. ``git show
<commit>:tsue_tpu_torch/csrc/flash_attn_fwd.cu`` written under ``runs/``)
as the variant ``old``.  The fp32 variants (the default) answer where a
form's time goes:

  no_compute  the ring runs and copies every tile, no warp computes
              (the copies alone; outputs wrong, not checked)
  no_copies   every warp computes, no tile is copied (the arithmetic
              alone; outputs wrong, not checked)
  ring3       a three-stage ring in every form (two copies in flight)
  wide_4x4    D = 1024 with 128 threads and 4 x 4 register tiles
              (fewer shared-memory reads per FMA, fewer warps)

With ``--dtype bfloat16`` the cases are the Llama's self-attention and the
Q-Former's at 64 frames with all-bf16 operands (the tensor-core form,
held to chip_smoke.py's BF_TOL), and the variants:

  mma_no_compute  the tensor-core form's copies alone
  mma_no_copies   its arithmetic alone (no tile copied; also the fp32
                  cp.async, which no bf16 case reaches)
  mma_bm64        blocks of 4 warps, 64 items, instead of 8 and 128
  mma_ring2       a ring of two tiles (one in flight) instead of three
  mma_expf        the softmax's exponentials by expf instead of exp2f of
                  the scaled difference

It needs a CUDA device and nvcc, and prints the card beside every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import chip_smoke as cs

CASES = ("llama_self", "ltsf_cross", "gen_decode_fp32_cache",
         "gen_qformer_self")
EDITS = {   # variant: (text in the source, its replacement)
    "no_compute": ("      if (busy) {\n        if (S < NS)",
                   "      if (false) {\n        if (S < NS)"),
    "no_copies": ("""  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));""",
                  "  (void)s; (void)src; (void)ok;"),
    "ring3": ("  static constexpr int NBUF = (SPLIT && QRES) ? 3 : 2;",
              "  static constexpr int NBUF = 3;"),
    "wide_4x4": ("f(Kern<1024, 16, 2, PQ, QT, KT>{});",
                 "f(Kern<1024, 8, 4, PQ, QT, KT>{});"),
}
BF16_CASES = ("llama_self", "gen_qformer_self")
BF16_EDITS = {
    "mma_no_compute": ("      if (busy) compute(t, buf);",
                       "      if (false) compute(t, buf);"),
    "mma_no_copies": EDITS["no_copies"],
    "mma_bm64": ("constexpr int kMmaWarps = 8;", "constexpr int kMmaWarps = 4;"),
    "mma_ring2": ("constexpr int kMmaStages = 3;",
                  "constexpr int kMmaStages = 2;"),
    "mma_expf": ("""      const float corr = exp2f((m[rr] - mnew) * kLog2e);""",
                 """      const float corr = expf(m[rr] - mnew);"""),
}
# variants that compute the function
CHECKED = ("base", "ring3", "wide_4x4", "mma_bm64", "mma_ring2", "mma_expf",
           "old")


def build(sources: dict, out_dir: Path) -> dict:
    """nvcc each variant's source into a library, all at once."""
    from tsue_tpu_torch.ops._build import build_variants
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build_variants(sources, out_dir, {
        "flash_attn_splits": [i32] * 9,
        "flash_attn_fwd": [ptr] * 8 + [i32] * 6 + [i32, ctypes.c_float,
                                                  i32, i32, i32, ptr]})
    return {name: lib for name, (lib, _) in libs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32", help="the operands' dtype")
    ap.add_argument("--old-source", type=Path, default=None,
                    help="an earlier flash_attn_fwd.cu, timed as 'old'")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the timings here as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    import tsue_tpu_torch.ops.flash as FL
    from tsue_tpu_torch.ops._build import BUILD_DIR, CSRC
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    base = (CSRC / "flash_attn_fwd.cu").read_text()
    bf16 = args.dtype == "bfloat16"
    sources = {"base": base}
    for name, (old, new) in (BF16_EDITS if bf16 else EDITS).items():
        cs.check(base.count(old) == 1, f"variant {name}: edit not found")
        sources[name] = base.replace(old, new)
    if "mma_expf" in sources:   # the edit's second half
        sources["mma_expf"] = sources["mma_expf"].replace(
            "          x = exp2f((x - mnew) * kLog2e);",
            "          x = expf(x - mnew);")
    if args.old_source is not None:
        sources["old"] = args.old_source.read_text()
    libs = build(sources, BUILD_DIR / "flash_variants")
    dev = torch.device("cuda:0")
    timer = cs.Timer(dev)
    cases = [(n, kw) for n, kw in cs.attention_cases(dev)
             if n in (BF16_CASES if bf16 else CASES)]
    if bf16:
        bf = torch.bfloat16
        cases = [(n, dict(kw, q=kw["q"].to(bf), k=kw["k"].to(bf),
                          v=kw["v"].to(bf))) for n, kw in cases]
    tol = cs.BF_TOL if bf16 else cs.TOL
    times: dict = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            FL._lib = lambda lib=libs[name]: lib    # the wrapper's binding
            for case, kw in cases:
                out = FL.flash_attention(**kw).float()
                if name in CHECKED:
                    ref = FL.flash_attention_plain(**kw).float()
                    torch.cuda.synchronize()
                    cs.check(torch.allclose(out, ref, **tol),
                             f"{name} disagrees with the plain version at "
                             f"{case}")
                ms = timer.ms(lambda: FL.flash_attention(**kw))
                times.setdefault(name, {}).setdefault(case, []).append(ms)
                print(f"{name} {case}: {ms:.4f} ms; gpu: {gpu}", flush=True)
    summary = {name: {case: min(v) for case, v in per.items()}
               for name, per in times.items()}
    print(json.dumps({"gpu": gpu, "min_ms_of_two_rounds": summary}),
          flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"gpu": gpu, "ms": times}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
