#!/usr/bin/env python3
"""Time text variants of the fused LM-head kernel side by side on one GPU.

    python3 head_variants.py [--out build/head_variants.json]

Each variant is ``tsue_tpu_torch/csrc/lmhead_topk.cu`` with some edits
(``EDITS``), built with nvcc into ``build/head_variants/`` (all in
parallel) and swapped in under ``tsue_tpu_torch.ops.lmhead_topk``.  Every
variant is timed on the int8 form at the decode shape of chip_smoke.py
(B 16, D 2048, V 128256, random inputs with a token-state mask) with
chip_smoke.py's timer (L2 flushed, median of 15), in two rounds, the
second in reverse order, so a drift of the card does not favour one
variant.  The variants answer where the int8 form's time goes:

  no_merge      the tile kernel alone (head_merge not launched)
  product_only  the tile kernel without its selection: the product, the
                processing and the keys written to shared memory
  copies_only   the ring's copies alone (no fragment, no mma, no
                selection, no merge)
  no_copies     the product's arithmetic alone (no copy into the ring, no
                selection, no merge)
  t256, t1024   8 or 32 warps a CTA instead of 16 (128 or 32 columns a
                warp); with _product_only, without the selection and merge
  k16           16 K rows a stage (7 stages in the keys' 128 KB)
  s6            6 stages of 32 K rows (210 KB)
  unrolled      the two k16 steps of a stage unrolled

The variants named ``*only`` and ``no_*`` do not compute the function and
are not checked; every other variant is held to the plain version (TOL).
It needs a CUDA device and nvcc, and prints the card beside every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import chip_smoke as cs

_SELECT = ("    __syncthreads();\n"
           "    select_tile(keys, cand, b0, B, tile, n_tiles);\n"
           "  }\n}\n\n// ---- the fp32 tied form")
_NO_SELECT = ("    __syncthreads();\n"
              "  }\n}\n\n// ---- the fp32 tied form")
_MERGE = ("  head_merge<<<B, kMergeThreads, kMergeSegs * kSeg * sizeof(u64), "
          "stream>>>(\n      c, vals, idx, n_tiles);\n")
_COMPUTE = "      cp_commit();\n      const unsigned char* ws ="
_NO_COMPUTE = ("      cp_commit();\n      if (D > 0) continue;\n"
               "      const unsigned char* ws =")
_CP16 = ('  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" '
         '::"r"(s),\n               "l"(src), "r"(bytes));')
_NO_CP16 = "  (void)s; (void)src; (void)bytes;"
_T = "constexpr int kI8Threads = 512;"
_KS = "constexpr int kKS = 32; "
_ST = "constexpr int kStages = kKeyBytes / kStageBytes;"
_PRODUCT_ONLY = [(_MERGE, ""), (_SELECT, _NO_SELECT)]


def _shape(threads=512, ks=32, stages=None):
    """Edits of the int8 form's threads a CTA, K rows a stage and ring
    stages."""
    out = []
    if threads != 512:
        out.append((_T, f"constexpr int kI8Threads = {threads};"))
    if ks != 32:
        out.append((_KS, f"constexpr int kKS = {ks}; "))
    if stages is not None:
        out.append((_ST, f"constexpr int kStages = {stages};"))
    return out


_UNROLL1 = "#pragma unroll 1   // unrolled, the two steps' fragments spill"
EDITS = {   # variant: [(text in the source, its replacement), ...]
    "no_merge": [(_MERGE, "")],
    "product_only": _PRODUCT_ONLY,
    "copies_only": _PRODUCT_ONLY + [(_COMPUTE, _NO_COMPUTE)],
    "no_copies": _PRODUCT_ONLY + [(_CP16, _NO_CP16)],
    "t256": _shape(256),
    "t256_product_only": _shape(256) + _PRODUCT_ONLY,
    "t1024": _shape(1024),
    "t1024_product_only": _shape(1024) + _PRODUCT_ONLY,
    "k16": _shape(ks=16),
    "s6": _shape(stages=6),
    "unrolled": [(_UNROLL1, "#pragma unroll")],
}


def build(sources: dict, out_dir: Path) -> dict:
    """nvcc each variant's source into a library, all at once; print the
    int8 tile kernel's registers and spills of each."""
    from tsue_tpu_torch.ops._build import build_variants
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build_variants(sources, out_dir, {
        "lmhead_topk_plan": [i32],
        "lmhead_topk": [ptr] * 5 + [ctypes.c_float] + [ptr] * 3 + [i32] * 3
        + [ptr]})
    for name, (_, report) in libs.items():
        lines = report.splitlines()
        for i, line in enumerate(lines):
            if "entry function" in line and "head_tile_topk_i8" in line:
                print(f"ptxas {name}: " + " ".join(
                    x.split("info    :")[-1].strip()
                    for x in lines[i + 2:i + 4]), flush=True)
    return {name: lib for name, (lib, _) in libs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the timings here as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("head_variants: no CUDA device", file=sys.stderr)
        return 1
    import tsue_tpu_torch.ops.lmhead_topk as LT
    from tsue_tpu_torch.ops._build import BUILD_DIR, CSRC
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    base = (CSRC / "lmhead_topk.cu").read_text()
    sources = {"base": base}
    for name, edits in EDITS.items():
        text = base
        for old, new in edits:
            cs.check(text.count(old) == 1, f"variant {name}: edit not found")
            text = text.replace(old, new)
        sources[name] = text
    libs = build(sources, BUILD_DIR / "head_variants")
    dev = torch.device("cuda:0")
    timer = cs.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    h, _, quant, mask = cs.head_inputs(dev, g, exact=False)
    args_ = (h, None, mask, 1.2, quant)
    times: dict = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            LT._lib = lambda lib=libs[name]: lib    # the wrapper's binding
            vals, idx = LT.lmhead_topk(*args_)
            if "only" not in name and "no_" not in name:
                rv, ri = LT.lmhead_topk_plain(*args_)
                torch.cuda.synchronize()
                cs.check(torch.allclose(vals, rv, **cs.TOL),
                         f"{name} disagrees with the plain version")
            ms = timer.ms(lambda: LT.lmhead_topk(*args_))
            times.setdefault(name, []).append(ms)
            print(f"{name}: {ms:.4f} ms; gpu: {gpu}", flush=True)
    summary = {name: min(v) for name, v in times.items()}
    print(json.dumps({"gpu": gpu, "min_ms_of_two_rounds": summary}),
          flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"gpu": gpu, "ms": times}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
