#!/usr/bin/env python3
"""Time text variants of the fused LM-head kernel side by side on one GPU.

    python3 head_variants.py [--old-source DIR/lmhead_topk.cu ...]
                             [--variants a,b] [--out FILE]

Each variant is ``tsue_tpu_torch/csrc/lmhead_topk.cu`` with some edits
(``EDITS``), built with nvcc into ``build/head_variants/`` (all in
parallel) and swapped in under ``tsue_tpu_torch.ops.lmhead_topk``;
each ``--old-source`` adds an earlier source unedited as a variant named
after its directory (e.g. ``git show
<commit>:tsue_tpu_torch/csrc/lmhead_topk.cu`` written to
``runs/old/lmhead_topk.cu``: variant ``old``).  Every variant is timed on each of the kernel's four
forms (int8 head with fp32 or bf16 h, tied fp32, tied bf16) at the decode
shape of chip_smoke.py (B 16, D 2048, V 128256, random inputs with a
token-state mask and penalty 1.2) with chip_smoke.py's timer (L2 flushed,
median of 15), in two rounds, the second in reverse order (old, base, ...,
base, old), so a drift of the card does not favour one variant.  The
variants answer where each form's time goes:

  tiles_only    the tile kernels alone (head_merge not launched)
  product_only  the tile kernels without their selection and no merge:
                the product, the processing and the keys or values
                written to shared memory
  select_only   the selection and the merge alone: no copies and no
                products; the epilogues key pseudo-random logits of
                (row, column) through the mask and penalty
  select_tile_only
                select_only without the merge: the epilogues and the
                tiles' selection
  merge_launch_only, merge_loads_only, merge_bound_only
                head_merge cut short: at once, after its loads, after
                the bound
  copies_only   the ring's copies alone (no fragment, no mma, no
                selection, no merge)
  tsel_search_only, tsel_gather_only
                the tiles' selection cut short: after its search, after
                its gather (before the keys are ordered and written)
  b16_rows128   the tied bf16 form with boxes of 128 rows (8 stages of
                18 KB) instead of 256 (4 of 34 KB)
  b16_s3        the tied bf16 form with 3 stages instead of 4

The variants named ``*_only`` do not compute the function and are not
checked; every other variant is held to the plain version (TOL), and
the earlier sources to the current one bit for bit on the forms whose
product the tied bf16 redesign left alone.  It also counts, from the logits of each form's inputs,
how many of head_merge's 126 x 128 candidates of a row a filter by the
largest of the tiles' 128th keys would keep, and, for the current source
each earlier one and each variant, the device time of each of the head's
kernels per call (torch.profiler, L2 flushed before each call).  It needs a CUDA
device and nvcc, and prints the card beside every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import chip_smoke as cs

_MERGE = ("  head_merge<<<B, kMergeThreads, 0, stream>>>(cand, vals, idx, "
          "n_tiles);\n")
_SELECT = [("    select_tile(keys, cand, b0, B, v0, V, tile, n_tiles);\n",
            "", 2),
           ("    select_tile(vals, cand, b0, B, v0, V, tile, n_tiles);\n",
            "", 1)]
_NOISE = '''
// a pseudo-random logit in [-0.5, 0.5) of (row, column)
__device__ __forceinline__ float noise(int b, int v) {
  uint32_t x = (uint32_t)b * 0x9E3779B9u ^ (uint32_t)v * 0x85EBCA6Bu;
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 12;
  x *= 0x297A2D39u;
  x ^= x >> 15;
  return (float)(x >> 8) * (1.f / 16777216.f) - 0.5f;
}

// ---- the selection ----'''


def _product_only():
    return [(_MERGE, "", 1)] + _SELECT


_FULL_WAIT = "      mbar_wait(&full[s], (gs / kB16Stages) & 1);\n"
_TMA = ("          tma_load(ws, &tw, k0, v0 + (st / nk) * kB16Rows, "
        "&full[s]);\n          tma_load(ws + kB16WBytes, &th, k0, b0, "
        "&full[s]);\n")


def _copies_only():
    """The cp.async forms skip their fragments and products after each
    stage's copies; the tied bf16 form's consumer warps release each
    stage as soon as it lands."""
    return _product_only() + [
        ("      cp_commit();\n      const ",
         "      cp_commit();\n      if (D > 0) continue;\n      const ", 2),
        (_FULL_WAIT, _FULL_WAIT + "      if (D > 0) {\n        __syncwarp();"
         "\n        if (lane == 0) mbar_arrive(&empty[s]);\n        "
         "continue;\n      }\n", 1)]


def _select_only():
    """No copies (the int8 and tied fp32 loops run no stage; the tied bf16
    form's producer issues nothing and its consumers run only each chunk's
    last stage, over stale shared memory, without waiting), pseudo-random
    logits into the epilogues."""
    return [
        ("\n// ---- the selection ----", _NOISE, 1),
        ("      if (st < nst) load_stage(st);\n", "", 2),
        ("    for (int st = 0; st < nst; ++st) {\n      cp_wait",
         "    for (int st = 0; st < 0; ++st) {\n      cp_wait", 2),
        ("    if (lane == 0) {\n      int g = 0;   // stages issued",
         "    if (lane == 0 && D < 0) {\n      int g = 0;   // stages issued",
         1),
        (_FULL_WAIT, "      if (kst != nk - 1) continue;\n", 1),
        ("const float val = acc[i][j][2 * half + c4] * sv[j];",
         "const float val = noise(b, v + j) * sv[j];", 1),
        ("processed(acc[t][2 * half], m2.x, penalty)",
         "processed(noise(b, v), m2.x, penalty)", 2),
        ("processed(acc[t][2 * half + 1], m2.y, penalty)",
         "processed(noise(b, v + 1), m2.y, penalty)", 2),
    ]


_MERGE_START = ("  const u64* src = cand + (size_t)b * n_tiles * kSeg;\n"
                "  int par = 0;\n")
_MERGE_LOADED = "    if (e < m) {\n"
_MERGE_BOUND = "    __syncthreads();   // the bound is set\n"
_LEAVE = "      if (n_tiles > 0) return;\n"
_SEL_GATHER = ("  u64* buf = reinterpret_cast<u64*>(row);\n"
               "  __syncwarp();   // the row was read out\n")
_SEL_SORT = ("  u64 x[4];\n#pragma unroll\n  for (int i = 0; i < 4; ++i) x[i] = "
             "buf[4 * lane + i];\n")
EDITS = {   # variant: [(text in the source, its replacement, count), ...]
    "merge_launch_only": [(_MERGE_START, _MERGE_START + _LEAVE, 1)],
    "merge_loads_only": [(_MERGE_LOADED, (
        "    {\n      u64 x = 0;\n      for (int j = 0; j < kMergeKeys; ++j) "
        "x ^= key[j];\n      if (x == 42) vals[0] = 1.f;\n"
        + _LEAVE + "    }\n" + _MERGE_LOADED), 1)],
    "merge_bound_only": [(_MERGE_BOUND, _MERGE_BOUND + (
        "      if (tid == 0 && bound == 42) vals[0] = 1.f;\n") + _LEAVE, 1)],
    "tiles_only": [(_MERGE, "", 1)],
    "product_only": _product_only(),
    "select_only": _select_only(),
    "select_tile_only": _select_only() + [(_MERGE, "", 1)],
    "copies_only": _copies_only(),
    "tsel_search_only": [(_SEL_GATHER, "  if (n_tiles > 0) {\n    if (t == "
                          "42u) cand[0] = exact;\n    return;\n  }\n"
                          + _SEL_GATHER, 1)],
    "tsel_gather_only": [(_SEL_SORT, "  if (n_tiles > 0) {\n    if (buf[lane]"
                          " == 42) cand[0] = 0;\n    return;\n  }\n"
                          + _SEL_SORT, 1)],
    "b16_rows128": [("constexpr int kB16Rows = 256;",
                     "constexpr int kB16Rows = 128;", 1)],
    "b16_s3": [("constexpr int kB16Stages =\n    (kMaxSmem - kB16Static - "
                "kAlign - kValBytes) / kB16StageBytes;",
                "constexpr int kB16Stages = 3;", 1)],
}
FORMS = ("int8", "int8_bf16_h", "tied_fp32", "tied_bf16")
# the forms whose variants are timed (the others: every form)
ONLY = {"b16_rows128": ("tied_bf16",), "b16_s3": ("tied_bf16",),
        "merge_launch_only": ("int8",), "merge_loads_only": ("int8",),
        "merge_bound_only": ("int8",)}
# the forms whose product the redesign of the tied bf16 form left alone:
# the earlier sources give their bits
SAME_PRODUCT = ("int8", "int8_bf16_h", "tied_fp32")


# the variants chip_smoke.py times beside each form: its product alone
# and its selection and merge alone
SPLIT = ("product_only", "select_only")


def variant_source(base: str, name: str) -> str:
    """The source ``base`` with variant ``name``'s edits."""
    text = base
    for old, new, count in EDITS[name]:
        cs.check(text.count(old) == count,
                 f"variant {name}: {text.count(old)} of {count} copies of "
                 "an edit's text found")
        text = text.replace(old, new)
    return text


def split_libs() -> dict:
    """The ``SPLIT`` variants of the current source, built into
    ``build/head_split/`` (for chip_smoke.py)."""
    from tsue_tpu_torch.ops._build import BUILD_DIR, CSRC
    base = (CSRC / "lmhead_topk.cu").read_text()
    return build({name: variant_source(base, name) for name in SPLIT},
                 BUILD_DIR / "head_split", report=False)


def build(sources: dict, out_dir: Path, report: bool = True) -> dict:
    """nvcc each variant's source into a library, all at once; print the
    kernels' registers, spills and shared memory of each (``report``)."""
    from tsue_tpu_torch.ops._build import build_variants
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build_variants(sources, out_dir, {
        "lmhead_topk_plan": [i32, i32],
        "lmhead_topk": [ptr] * 5 + [ctypes.c_float] + [ptr] * 3 + [i32] * 4
        + [ptr]})
    for name, (_, text) in libs.items():
        lines = text.splitlines() if report else []
        for i, line in enumerate(lines):
            if "entry function" in line and "head_" in line:
                kernel = line.split("'")[1] if "'" in line else line
                print(f"ptxas {name} {kernel}: " + " ".join(
                    x.split("info    :")[-1].strip()
                    for x in lines[i + 1:i + 4]), flush=True)
    return {name: lib for name, (lib, _) in libs.items()}


def filter_survivors(args, penalty: float) -> dict:
    """Of head_merge's candidates (each 1024-column tile's top 128 of a
    row), how many lie at or above the largest of the tiles' 128th values
    (what a filter by that bound would keep), and how many at or above
    head_merge's bound, the 128th of the lists' leading keys.  From the
    plain logits."""
    import torch
    import torch.nn.functional as F
    h, w, mask, _, quant = args
    hf = h.float()
    if quant is not None:
        logits = (hf @ quant[0].float()) * quant[1]
    else:
        logits = hf @ w.float().t()
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    logits = torch.where((mask & 1) != 0, pen, logits)
    logits = logits.masked_fill((mask & 2) != 0, -1e9)
    B, V = logits.shape
    n = -(-V // 1024)
    tiles = F.pad(logits, (0, n * 1024 - V), value=float("-inf")).view(
        B, n, 1024)
    top = tiles.topk(128, dim=-1).values            # (B, n, 128)
    bound = top[:, :, -1].max(dim=1).values          # (B,)
    keep = (top >= bound[:, None, None]).sum(dim=(1, 2)).float()
    # head_merge's own bound: the 128th of the lists' leading m keys
    m = min(128, 256 // n)
    pool = top[:, :, :m].reshape(B, -1).topk(128, dim=-1).values[:, -1]
    sur = (top >= pool[:, None, None]).sum(dim=(1, 2)).float()
    return {"candidates": n * 128, "kept_min": keep.min().item(),
            "kept_mean": keep.mean().item(), "kept_max": keep.max().item(),
            "pool_bound_kept_mean": sur.mean().item(),
            "pool_bound_kept_max": sur.max().item()}


def kernel_device_us(fn, flush, reps: int = 10) -> dict:
    """Mean device microseconds a call of each CUDA kernel ``fn`` launches
    (torch.profiler; ``flush`` written before each call, outside the
    kernels' names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "head_" in e.key:
            name = "head_merge" if "head_merge" in e.key else "tile"
            out[name] = out.get(name, 0) + round(
                e.self_device_time_total / reps, 2)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", type=Path, action="append",
                    default=[], help="an earlier lmhead_topk.cu, timed "
                    "under its directory's name (repeatable)")
    ap.add_argument("--variants", default=None,
                    help="comma-separated names of EDITS to build (default "
                         "all)")
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
    names = list(EDITS) if args.variants is None else [
        x for x in args.variants.split(",") if x]
    olds = {path.parent.name: path.read_text() for path in args.old_source}
    sources = {**olds, "base": base}
    for name in names:
        sources[name] = variant_source(base, name)
    libs = build(sources, BUILD_DIR / "head_variants")
    dev = torch.device("cuda:0")
    timer = cs.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    h, w, quant, mask = cs.head_inputs(dev, g, exact=False)
    BF = torch.bfloat16
    hb, wb = h.to(BF), w.to(BF)
    penalty = 1.2
    forms = {"int8": (h, None, mask, penalty, quant),
             "int8_bf16_h": (hb, None, mask, penalty, quant),
             "tied_fp32": (h, w, mask, penalty, None),
             "tied_bf16": (hb, wb, mask, penalty, None)}
    for form, a in forms.items():
        print(f"filter {form}: " + json.dumps(filter_survivors(a, penalty)),
              flush=True)
    order = list(olds) + ["base"] + names
    runs = [(f"{name} {form}", name, form) for name in order
            for form in ONLY.get(name, FORMS)]
    outs: dict = {}
    times: dict = {}
    for rnd in (runs, runs[::-1]):
        for label, name, form in rnd:
            a = forms[form]
            LT._lib = lambda lib=libs[name]: lib    # the wrapper's binding
            vals, idx = LT.lmhead_topk(*a)
            torch.cuda.synchronize()
            if not name.endswith("_only"):
                rv, ri = LT.lmhead_topk_plain(*a)
                cs.check(torch.allclose(vals, rv, **cs.TOL),
                         f"{label} disagrees with the plain version")
                outs[label] = (vals, idx)
            ms = timer.ms(lambda: LT.lmhead_topk(*a))
            times.setdefault(label, []).append(ms)
            print(f"{label}: {ms:.4f} ms; gpu: {gpu}", flush=True)
    for old in olds:
        for form in SAME_PRODUCT:
            ov, oi = outs[f"{old} {form}"]
            nv, ni = outs[f"base {form}"]
            cs.check(torch.equal(ov, nv) and torch.equal(oi, ni),
                     f"{form}: the source's bits differ from {old}'s")
        print(f"{old} and the source bit-identical on " + ", ".join(
            SAME_PRODUCT), flush=True)
    for name in order:
        LT._lib = lambda lib=libs[name]: lib
        for form in ONLY.get(name, FORMS):
            us = kernel_device_us(lambda: LT.lmhead_topk(*forms[form]),
                                  timer.flush)
            print(f"device us a call, {name} {form}: {json.dumps(us)}; "
                  f"gpu: {gpu}", flush=True)
    summary = {name: min(v) for name, v in times.items()}
    print(json.dumps({"gpu": gpu, "min_ms_of_two_rounds": summary}),
          flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"gpu": gpu, "ms": times}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
