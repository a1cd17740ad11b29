#!/usr/bin/env python3
"""Time text variants of the flash-attention kernel side by side on one GPU.

    python3 flash_variants.py [--dtype bfloat16] [--old-source FILE]
                              [--variants NAME,...]
                              [--out build/flash_variants.json]

Each variant is ``tsue_tpu_torch/csrc/flash_attn_fwd.cu`` with one edit
(``EDITS``), built with nvcc into ``build/flash_variants/`` (all in
parallel) and swapped in under ``tsue_tpu_torch.ops.flash``.  Every variant
is timed on chip_smoke.py's attention cases with chip_smoke.py's timer (L2
flushed, median of 15), in two rounds, the second in reverse order, so a
drift of the card does not favour one variant.  ``--old-source`` adds an
earlier source of the kernel (e.g. ``git show
<commit>:tsue_tpu_torch/csrc/flash_attn_fwd.cu`` written under ``runs/``)
as the variant ``old``; ``--variants`` keeps only the named variants
(``base`` always runs).  The fp32 variants (the default) answer where a
form's time goes:

  no_compute  the ring runs and copies every tile, no warp computes
              (the copies alone; outputs wrong, not checked)
  no_copies   every warp computes, no tile is copied (the arithmetic
              alone; outputs wrong, not checked)
  ring3       a three-stage ring in every form (two copies in flight)
  wide_4x4    D = 1024 with 128 threads and 4 x 4 register tiles
              (fewer shared-memory reads per FMA, fewer warps)

With ``--dtype bfloat16`` the cases are the Llama's self-attention and the
Q-Former's at 64 frames (the tensor-core form "bf16_mma"), the decode
step over a 592-slot cache (B 16, Tq 1, 32/8 x 64: the decode form
"bf16_decode"), all with bf16 operands, and the LTSF cross-attention (B
16, 18 queries over 528 keys, 2 heads of 1024: the wide form "bf16_wide")
with fp32 q over bf16 k and v and all bf16, held to chip_smoke.py's
BF_TOL, and the variants:

  mma_no_compute  the tensor-core form's copies alone
  mma_no_copies   its arithmetic alone (no tile copied; also the fp32
                  cp.async, which no bf16 case reaches), and the decode
                  form's (its key masks still copied)
  mma_bm64        blocks of 4 warps, 64 items, instead of 8 and 128
  mma_ring2       a ring of two tiles (one in flight) instead of three
  mma_expf        the softmax's exponentials by expf instead of exp2f of
                  the scaled difference
  dec_no_compute  the decode form's copies alone
  dec_skeleton    the decode form with neither copies nor arithmetic (its
                  launch, Q's loads, the warps' merge and the store)
  dec_split2      the decode form's keys in at least two splits a (b, KV
                  head), merged by the last block (one launch)
  dec_merge_launch  the same splits merged by a second launch
                  (merge_kernel), as the fp32 split-KV form does
  dec_ring3       three tiles in flight a warp at D = 64 instead of two
  dec_ring1       one tile in flight a warp at D = 64 (75 KB blocks, three
                  an SM: three key splits, every tile issued at once)
  dec_ring1_merge_launch  dec_ring1's three splits merged by a second
                  launch (merge_kernel) instead of the last block
  dec_l2_256      the decode form's K and V copies with an L2 prefetch of
                  256 bytes (the neighbouring KV head's row)
  dec_contig_no_compute  the decode form's copies alone, each block's rows
                  read contiguously instead of 1 KB apart (timing only)
  wide_no_compute the wide form's copies alone (with its launch, Q's
                  loads and the cluster's merge)
  wide_no_copies  its arithmetic alone (no tile or key mask copied)
  wide_skeleton   neither: the launch, Q's loads and the merge
  wide_skel_nomerge, wide_skel_noq, wide_skel_noloop  the skeleton without
                  the cluster's merge, without Q's loads, or without the
                  tile loop (its barriers)
  wide_skel_nosync  the skeleton without the merge and the two cluster
                  barriers
  wide_empty      the wide form's launch alone (every block returns at
                  once)
  wide_nc_no_s, wide_nc_no_softmax, wide_nc_no_pv, wide_nc_no_bar  the
                  arithmetic alone without S^T's products, the softmax, P V,
                  or the key loop's two barriers (timing only)
  wide_evict_normal  the wide form's K and V copies with L2's normal
                  eviction priority instead of evict-first

``--clean-l2`` times every case a second time with another 128 MB read
after the flush, before the call (L2 then holds clean lines, so the
call's misses evict nothing to write back), under "<case> clean-L2".

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
EDITS = {   # variant: [(text in the source, its replacement), ...]
    "no_compute": [("      if (busy) {\n        if (S < NS)",
                    "      if (false) {\n        if (S < NS)")],
    "no_copies": [("""  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));""",
                   "  (void)s; (void)src; (void)ok;")],
    "ring3": [("  static constexpr int NBUF = (SPLIT && QRES) ? 3 : 2;",
               "  static constexpr int NBUF = 3;")],
    "wide_4x4": [("f(Kern<1024, 16, 2, PQ, QT, KT>{});",
                  "f(Kern<1024, 8, 4, PQ, QT, KT>{});")],
}
BF16_CASES = ("llama_self", "gen_qformer_self", "gen_decode_fp32_cache",
              "ltsf_cross")
_DEC_SPLIT2 = ("    const long per = std::max<long>(1, (long)sm_count() * "
               "p->per_sm / pairs);",
               "    const long per = std::max<long>(2, (long)sm_count() * "
               "p->per_sm / pairs);")
BF16_DEC_NO_COMPUTE = [("    compute(i);\n    __syncwarp();", "    __syncwarp();")]
WIDE_NO_COPIES = [
    ("""  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(ok ? 16 : 0), "l"(policy));""",
     "  (void)dst; (void)src; (void)ok; (void)policy;"),
    ("""  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));""",
     "  (void)dst; (void)src; (void)ok;")]
WIDE_NO_COMPUTE = [("      s_part(buf(2 * t));\n", ""),
                   ("    if (t < nt) softmax(t, mk);\n", ""),
                   ("    if (t > 0) pv(buf(2 * t - 1));\n", "")]
BF16_EDITS = {
    "mma_no_compute": [("      if (busy) compute(t, buf);",
                        "      if (false) compute(t, buf);")],
    "mma_no_copies": EDITS["no_copies"],
    "mma_bm64": [("constexpr int kMmaWarps = 8;",
                  "constexpr int kMmaWarps = 4;")],
    "mma_ring2": [("constexpr int kMmaStages = 3;",
                   "constexpr int kMmaStages = 2;")],
    "mma_expf": [("      const float corr = exp2f((m[rr] - mnew) * kLog2e);",
                  "      const float corr = expf(m[rr] - mnew);"),
                 ("          x = exp2f((x - mnew) * kLog2e);",
                  "          x = expf(x - mnew);")],
    "dec_no_compute": BF16_DEC_NO_COMPUTE,
    "dec_skeleton": BF16_DEC_NO_COMPUTE + EDITS["no_copies"],
    "dec_split2": [_DEC_SPLIT2],
    "dec_merge_launch": [
        _DEC_SPLIT2,
        ("  if (a.splits == 1) return;\n\n  // the last block",
         "  return;\n\n  // the last block"),
        ("  if (err != cudaSuccess || p.splits == 1 || p.kind == kDecode)",
         "  if (err != cudaSuccess || p.splits == 1)")],
    "dec_ring3": [("  static constexpr int NBW = D <= 32 ? 4 : (D <= 96 ? 2 : 1);",
                   "  static constexpr int NBW = D <= 32 ? 4 : (D <= 64 ? 3 : "
                   "D <= 96 ? 2 : 1);")],
    "dec_ring1": [("  static constexpr int NBW = D <= 32 ? 4 : (D <= 96 ? 2 : 1);",
                   "  static constexpr int NBW = D <= 32 ? 4 : 1;")],
    "dec_contig_no_compute": BF16_DEC_NO_COMPUTE + [(
        "        const size_t row = ((size_t)b * a.Tk + (ok ? c0 + j : 0)) "
        "* a.Hkv + hkv;",
        "        const size_t row = (size_t)blockIdx.x * a.Tk + "
        "(ok ? c0 + j : 0);")],
    "dec_ring1_merge_launch": [
        ("  static constexpr int NBW = D <= 32 ? 4 : (D <= 96 ? 2 : 1);",
         "  static constexpr int NBW = D <= 32 ? 4 : 1;"),
        ("  if (a.splits == 1) return;\n\n  // the last block",
         "  return;\n\n  // the last block"),
        ("  if (err != cudaSuccess || p.splits == 1 || p.kind == kDecode)",
         "  if (err != cudaSuccess || p.splits == 1)")],
    "wide_no_compute": WIDE_NO_COMPUTE,
    "wide_no_copies": WIDE_NO_COPIES,
    "wide_skeleton": WIDE_NO_COMPUTE + WIDE_NO_COPIES,
    "wide_skel_nomerge": WIDE_NO_COMPUTE + WIDE_NO_COPIES + [
        ("  for (int r = rank; r < nib; r += RB * nc) {",
         "  for (int r = nib; r < nib; r += RB * nc) {")],
    "wide_skel_noq": WIDE_NO_COMPUTE + WIDE_NO_COPIES + [
        ("      qx[j][kc][0] = QPair<QT>::load(qr + 16 * kc);\n"
         "      qx[j][kc][1] = QPair<QT>::load(qr + 16 * kc + 8);\n",
         "      qx[j][kc][0] = qx[j][kc][1] = {};\n")],
    "wide_skel_nosync": WIDE_NO_COMPUTE + WIDE_NO_COPIES + [
        ("  for (int r = rank; r < nib; r += RB * nc) {",
         "  for (int r = nib; r < nib; r += RB * nc) {"),
        ("  if (tid < nib) {\n    float ms[kWideMaxCluster]",
         "  if (false) {\n    float ms[kWideMaxCluster]"),
        ("  cluster.sync();          // every rank's (O, m, l) visible",
         "  //"),
        ("  cluster.sync();          // no rank leaves", "  //")],
    "wide_nc_no_s": WIDE_NO_COPIES + [WIDE_NO_COMPUTE[0]],
    "wide_nc_no_softmax": WIDE_NO_COPIES + [WIDE_NO_COMPUTE[1]],
    "wide_nc_no_pv": WIDE_NO_COPIES + [WIDE_NO_COMPUTE[2]],
    "wide_nc_no_bar": WIDE_NO_COPIES + [
        ("    __syncthreads();       // K_t and V_{t-1} landed; P_{t-1} "
         "written\n", ""),
        ("    __syncthreads();       // the partials written; K_t's, "
         "V_{t-1}'s buffers free\n", "")],
    "wide_evict_normal": [("createpolicy.fractional.L2::evict_first.b64",
                           "createpolicy.fractional.L2::evict_normal.b64")],
    "wide_empty": [("  cg::cluster_group cluster = cg::this_cluster();\n",
                    "  cg::cluster_group cluster = cg::this_cluster();\n"
                    "  if (a.scale != 0.f) return;\n")],
    "wide_skel_noloop": WIDE_NO_COMPUTE + WIDE_NO_COPIES + [
        ("  for (int t = 0; t <= nt; ++t) {", "  for (int t = 0; t < 0; ++t) {")],
    "dec_l2_256": [
        ("constexpr int kDecWarps = 4;",
         """__device__ __forceinline__ void cp16_pf(void* dst, const void* src,
                                        bool ok) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
constexpr int kDecWarps = 4;"""),
        ("""        cp16(reinterpret_cast<float*>(kd + j * P + d),
             reinterpret_cast<const float*>(ak + row * D + d), ok);
        cp16(reinterpret_cast<float*>(vd + j * P + d),
             reinterpret_cast<const float*>(av + row * D + d), ok);""",
         """        cp16_pf(kd + j * P + d, ak + row * D + d, ok);
        cp16_pf(vd + j * P + d, av + row * D + d, ok);""")],
}
# variants that compute the function
CHECKED = ("base", "ring3", "wide_4x4", "mma_bm64", "mma_ring2", "mma_expf",
           "dec_split2", "dec_merge_launch", "dec_ring3", "dec_ring1",
           "dec_ring1_merge_launch", "dec_l2_256", "wide_evict_normal", "old")


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
    ap.add_argument("--variants", default=None,
                    help="comma-separated variants to build and time beside "
                         "base (default: all)")
    ap.add_argument("--clean-l2", action="store_true",
                    help="also time each case after a flush read back")
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
    keep = None if args.variants is None else set(args.variants.split(","))
    for name, edits in (BF16_EDITS if bf16 else EDITS).items():
        if keep is not None and name not in keep:
            continue
        text = base
        for old, new in edits:
            cs.check(text.count(old) == 1, f"variant {name}: edit not found")
            text = text.replace(old, new)
        sources[name] = text
    if args.old_source is not None:
        sources["old"] = args.old_source.read_text()
    libs = build(sources, BUILD_DIR / "flash_variants")
    dev = torch.device("cuda:0")
    timer = cs.Timer(dev)
    clean = None
    if args.clean_l2:
        # the flush, then a read of another 128 MB: its misses write the
        # dirty lines back before the call, whose misses then evict clean
        # lines
        clean = cs.Timer(dev)
        dirty, other = clean.flush, torch.ones_like(clean.flush)
        clean.flush = type("ReadBack", (), {"zero_": lambda self: (
            dirty.zero_(), other.sum())})()
    cases = [(n, kw) for n, kw in cs.attention_cases(dev)
             if n in (BF16_CASES if bf16 else CASES)]
    if bf16:
        bf = torch.bfloat16
        cases = [(n, dict(kw, q=kw["q"].to(bf), k=kw["k"].to(bf),
                          v=kw["v"].to(bf))) for n, kw in cases]
        # the LTSF cross-attention of a bf16 model: fp32 q over bf16 k, v
        cases += [(f"{n} fp32 q", dict(kw, q=kw["q"].float()))
                  for n, kw in cases if n == "ltsf_cross"]
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
                for label, tm in ((case, timer), (f"{case} clean-L2", clean)):
                    if tm is None:
                        continue
                    ms = tm.ms(lambda: FL.flash_attention(**kw))
                    times.setdefault(name, {}).setdefault(label, []).append(ms)
                    print(f"{name} {label}: {ms:.4f} ms; gpu: {gpu}",
                          flush=True)
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
