#!/usr/bin/env python3
"""Time text variants of the fused LM-head kernel side by side on one GPU.

    python3 head_variants.py [--out build/head_variants.json]

Each variant is ``tsue_tpu_torch/csrc/lmhead_topk.cu`` with some edits
(``EDITS``), built with nvcc into ``build/head_variants/`` (all in
parallel) and swapped in under ``tsue_tpu_torch.ops.lmhead_topk``.  Every
variant is timed on its form (the unedited source on both) at the decode
shape of chip_smoke.py (B 16, D 2048, V 128256, random inputs with a
token-state mask) with chip_smoke.py's timer (L2 flushed, median of 15),
in two rounds, the second in reverse order, so a drift of the card does
not favour one variant.  The variants answer where each form's time goes
(names with ``f32_`` are the tied fp32 form's, the others the int8
form's):

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
  f32_k<d>_s<n> the tied form with d D positions a stage and n stages
                (the source's choice: 16 and 3)
  f32_no_l2_prefetch, f32_l2_256
                the tied form's weight copies without the L2 prefetch of
                the 128-byte line around each, or with 256 bytes

The variants named ``*only`` and ``no_*`` do not compute the function and
are not checked; every other variant is held to the plain version (TOL).
The edits reach every instantiation of a form's kernel (the tied form's
bf16 twin, the int8 form's bf16-h twin); the runs time the fp32 forms.
It needs a CUDA device and nvcc, and prints the card beside every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import chip_smoke as cs

_NEXT = {"int8": "\n\n// ---- the fp32 tied form",
         "f32": "\n\n__global__ void __launch_bounds__(kMergeThreads)"}
_MERGE = ("  head_merge<<<B, kMergeThreads, kMergeSmem, stream>>>(cand, vals, "
          "idx,\n                                                       "
          "n_tiles);\n")
_COMPUTE = {"int8": ("      cp_commit();\n      const unsigned char* ws = "
                     "smem_raw + (st % kStages)"),
            "f32": ("      cp_commit();\n      const unsigned char* ws =\n"
                    "          smem_raw + (st % kF32Stages)")}
_CP16 = ('  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" '
         '::"r"(s),\n               "l"(src), "r"(bytes));')
_NO_CP16 = "  (void)s; (void)src; (void)bytes;"
_L2 = "cp.async.cg.shared.global.L2::128B"
_CP16_W = ('  asm volatile("' + _L2 + ' [%0], [%1], 16, %2;\\n"\n'
           '               ::"r"(s), "l"(src), "r"(bytes));')


def _product_only(form):
    """Edits that drop the form's selection and the merge launch."""
    select = ("    __syncthreads();\n"
              "    select_tile(keys, cand, b0, B, tile, n_tiles);\n  }\n}")
    return [(_MERGE, ""), (select + _NEXT[form],
                           "    __syncthreads();\n  }\n}" + _NEXT[form])]


def _copies_only(form):
    """Edits that also skip the product's arithmetic."""
    return _product_only(form) + [(_COMPUTE[form], _COMPUTE[form].replace(
        "cp_commit();\n", "cp_commit();\n      if (D > 0) continue;\n"))]


def _shape(threads=512, ks=32, stages=None):
    """Edits of the int8 form's threads a CTA, K rows a stage and ring
    stages."""
    out = []
    if threads != 512:
        out.append(("constexpr int kI8Threads = 512;",
                    f"constexpr int kI8Threads = {threads};"))
    if ks != 32:
        out.append(("constexpr int kKS = 32; ", f"constexpr int kKS = {ks}; "))
    if stages is not None:
        out.append(("constexpr int kStages = kKeyBytes / kStageBytes;",
                    f"constexpr int kStages = {stages};"))
    return out


def _f32_shape(ks=16, stages=3, threads=512):
    """Edits of the tied form's D positions a stage, ring stages and
    threads a CTA."""
    out = []
    if ks != 16:
        out.append(("constexpr int kF32KS = 16;",
                    f"constexpr int kF32KS = {ks};"))
    if stages != 3:
        out.append(("constexpr int kF32Stages = 3;",
                    f"constexpr int kF32Stages = {stages};"))
    if threads != 512:
        out.append(("constexpr int kF32Threads = 512;",
                    f"constexpr int kF32Threads = {threads};"))
    return out


_UNROLL1 = "#pragma unroll 1   // unrolled, the two steps' fragments spill"
EDITS = {   # variant: [(text in the source, its replacement), ...]
    "no_merge": [(_MERGE, "")],
    "product_only": _product_only("int8"),
    "copies_only": _copies_only("int8"),
    "no_copies": _product_only("int8") + [(_CP16, _NO_CP16)],
    "t256": _shape(256),
    "t256_product_only": _shape(256) + _product_only("int8"),
    "t1024": _shape(1024),
    "t1024_product_only": _shape(1024) + _product_only("int8"),
    "k16": _shape(ks=16),
    "s6": _shape(stages=6),
    "unrolled": [(_UNROLL1, "#pragma unroll")],
    "f32_no_merge": [(_MERGE, "")],
    "f32_product_only": _product_only("f32"),
    "f32_copies_only": _copies_only("f32"),
    "f32_no_copies": _product_only("f32") + [(_CP16, _NO_CP16),
                                             (_CP16_W, _NO_CP16)],
    "f32_no_l2_prefetch": [(_L2, "cp.async.cg.shared.global")],
    "f32_l2_256": [(_L2, "cp.async.cg.shared.global.L2::256B")],
    "f32_k16_s2": _f32_shape(stages=2),
    "f32_k8_s3": _f32_shape(ks=8),
    "f32_k8_s6": _f32_shape(ks=8, stages=6),
    "f32_t256": _f32_shape(threads=256),
    "f32_t256_product_only": _f32_shape(threads=256) + _product_only("f32"),
}


def build(sources: dict, out_dir: Path) -> dict:
    """nvcc each variant's source into a library, all at once; print the
    tile kernels' registers and spills of each."""
    from tsue_tpu_torch.ops._build import build_variants
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build_variants(sources, out_dir, {
        "lmhead_topk_plan": [i32, i32],
        "lmhead_topk": [ptr] * 5 + [ctypes.c_float] + [ptr] * 3 + [i32] * 4
        + [ptr]})
    for name, (_, report) in libs.items():
        lines = report.splitlines()
        for i, line in enumerate(lines):
            for kernel in ("head_tile_topk_i8", "head_tile_topk_tied"):
                if "entry function" in line and kernel in line:
                    print(f"ptxas {name} {kernel}: " + " ".join(
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
    h, w, quant, mask = cs.head_inputs(dev, g, exact=False)
    forms = {"int8": (h, None, mask, 1.2, quant),
             "f32": (h, w, mask, 1.2, None)}
    runs = [(f"base_{form}", "base", form) for form in forms]
    runs += [(name, name, "f32" if name.startswith("f32_") else "int8")
             for name in EDITS]
    times: dict = {}
    for order in (runs, runs[::-1]):
        for label, name, form in order:
            args_ = forms[form]
            LT._lib = lambda lib=libs[name]: lib    # the wrapper's binding
            vals, idx = LT.lmhead_topk(*args_)
            if "only" not in name and "no_" not in name:
                rv, ri = LT.lmhead_topk_plain(*args_)
                torch.cuda.synchronize()
                cs.check(torch.allclose(vals, rv, **cs.TOL),
                         f"{label} disagrees with the plain version")
            ms = timer.ms(lambda: LT.lmhead_topk(*args_))
            times.setdefault(label, []).append(ms)
            print(f"{label}: {ms:.4f} ms; gpu: {gpu}", flush=True)
    summary = {name: min(v) for name, v in times.items()}
    print(json.dumps({"gpu": gpu, "min_ms_of_two_rounds": summary}),
          flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"gpu": gpu, "ms": times}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
