#!/usr/bin/env python3
"""Time text variants of the flash-attention kernel side by side on one GPU.

    python3 flash_variants.py [--out build/flash_variants.json]

Each variant is ``tsue_tpu_torch/csrc/flash_attn_fwd.cu`` with one edit
(``EDITS``), built with nvcc into ``build/flash_variants/`` (all in
parallel) and swapped in under ``tsue_tpu_torch.ops.flash``.  Every variant
is timed on chip_smoke.py's attention cases with chip_smoke.py's timer (L2
flushed, median of 15), in two rounds, the second in reverse order, so a
drift of the card does not favour one variant.  The variants answer where
a form's time goes:

  no_compute  the ring runs and copies every tile, no warp computes
              (the copies alone; outputs wrong, not checked)
  no_copies   every warp computes, no tile is copied (the arithmetic
              alone; outputs wrong, not checked)
  ring3       a three-stage ring in every form (two copies in flight)
  wide_4x4    D = 1024 with 128 threads and 4 x 4 register tiles
              (fewer shared-memory reads per FMA, fewer warps)

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
CHECKED = ("base", "ring3", "wide_4x4")   # variants that compute the function


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
    sources = {"base": base}
    for name, (old, new) in EDITS.items():
        cs.check(base.count(old) == 1, f"variant {name}: edit not found")
        sources[name] = base.replace(old, new)
    libs = build(sources, BUILD_DIR / "flash_variants")
    dev = torch.device("cuda:0")
    timer = cs.Timer(dev)
    cases = [(n, kw) for n, kw in cs.attention_cases(dev) if n in CASES]
    times: dict = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            FL._lib = lambda lib=libs[name]: lib    # the wrapper's binding
            for case, kw in cases:
                out = FL.flash_attention(**kw)
                if name in CHECKED:
                    ref = FL.flash_attention_plain(**kw)
                    torch.cuda.synchronize()
                    cs.check(torch.allclose(out, ref, **cs.TOL),
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
