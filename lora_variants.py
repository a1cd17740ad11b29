#!/usr/bin/env python3
"""Time text variants of the fused LoRA kernel side by side on one GPU.

    python3 lora_variants.py [--out build/lora_variants.json]

Each variant is ``tsue_tpu_torch/csrc/lora_matmul.cu`` with some edits
(``EDITS``, and ``_spans`` for edits that cut whole blocks), built with
nvcc into ``build/lora_variants/`` (all in parallel) and swapped in under
``tsue_tpu_torch.ops.lora``.  Every variant is timed on its form (the
unedited source on both) at chip_smoke.py's stage-1 shapes
(``LORA_SHAPES``: M 8448, K 2048, N 2048 and 512, r 8) with chip_smoke.py's
timer (L2 flushed, median of 15), in two rounds, the second in reverse
order, so a drift of the card does not favour one variant.  The variants
answer where each tensor-core form's time goes (names with ``f32_`` are the
fp32 form's, the others the bf16 form's):

  copies_only   the ring's TMA copies alone (no product; the epilogue runs)
  mma_only      the products alone: no TMA copy, the ring's stages are
                released as they are (the adapter's rows are still staged)
  mma_only_no_store  mma_only, and the epilogue stores nothing
  x_copies_only, w_copies_only  copies_only with the x tiles, or the W
                tiles, alone
  no_adapter    the tile without the adapter: no xA product, no delta
  no_a_stage    the producer does not store the adapter's rows (nor, so,
                load them; xA wrong)
  no_a_load     the producer stores the adapter's rows without loading
                them (made-up values; xA wrong)
  no_store      the epilogue does not store the output
  l2_128        TMA loads promote to 128-byte L2 lines instead of 256
  s2, s3        2 or 3 ring stages instead of 4
  n128          a 128 x 128 output tile instead of 128 x 256 (m64n128k16)
  f32_copies_only  the ring's copies alone: no re-staging, no product
  f32_mma_only  no TMA copy (the consumers re-stage and multiply what the
                ring holds)
  f32_no_restage  the products on halves left from before (no re-staging)
  f32_no_adapter  no xA sums in the producer, no delta
  f32_no_store  the epilogue does not store the output
  f32_r16       the producer keeps 16 xA sums a thread at every rank (the
                source keeps 8 for r <= 8, as at these shapes)
  f32_mma_sync  the fp32 form on mma.sync instead of wgmma (m16n8k8
                3xTF32 on fragments gathered from the ring's swizzled
                tiles: x by ldmatrix, W by 32-bit loads; 8 warps of 64 x
                64 outputs; 3 ring stages; no re-staging)

The variants named ``*only`` and ``no_*`` do not compute the function and
are not checked; every other variant is held to the plain version with
chip_smoke.py's LoRA tolerances, and one that disagrees is named, left
untimed, and makes the script exit 1.  It needs a CUDA device and nvcc, and
prints the card beside every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import chip_smoke as cs

_BF16_PRODUCTS = (
    "        wgmma_m64n256_ss(acc, da,\n"
    "                         sw128_desc(ws + kk * 16 * kRowBytes, kK * "
    "kRowBytes,\n                                    1024));\n")
_BF16_XA = ("        wgmma_m64n16_ss(xa, da, sw128_desc(as + kk * 32, 16, "
            "1024));\n")
_NO_PRODUCTS = (_BF16_PRODUCTS + _BF16_XA, "        (void)da;\n")
_M64N16 = "// D (64 x 16, fp32) += A (64 x 16, smem) * B (16 x 16, smem, K-major)"


def _m64n128_asm() -> str:
    """The m64n128k16 bf16 wgmma (W N-major) that the n128 variant adds."""
    regs = 64
    ops = ", ".join(f"%{i}" for i in range(regs))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    return (
        "__device__ __forceinline__ void wgmma_m64n128_ss(\n"
        "    float (&d)[64], uint64_t da, uint64_t db) {\n"
        "  asm volatile(\n"
        '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"\n'
        '      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 '
        f'{{{ops}}}, "\n'
        '      "%64, %65, p, 1, 1, 0, 1;\\n}\\n"\n'
        f"      : {outs}\n"
        '      : "l"(da), "l"(db), "r"(1));\n'
        "}\n\n")
_W_TMA = ("              tma_load(st + kXBytes + j * kK * kRowBytes, &tw,\n"
          "                       n0 + j * Tc<T>::kBoxN, k0, &full[u]);\n")
_TMA = [("            mbar_arrive_tx(&full[u], kXBytes + kWBytes);\n",
         "            mbar_arrive(&full[u]);\n"),
        ("            tma_load(st, &tx, k0, m0, &full[u]);\n", ""),
        (_W_TMA, "              (void)j;\n")]
_X_ONLY = [("            mbar_arrive_tx(&full[u], kXBytes + kWBytes);\n",
            "            mbar_arrive_tx(&full[u], kXBytes);\n"),
           (_W_TMA, "              (void)j;\n")]
_W_ONLY = ("            mbar_arrive_tx(&full[u], kXBytes + kWBytes);\n"
           "            tma_load(st, &tx, k0, m0, &full[u]);\n",
           "            mbar_arrive_tx(&full[u], kWBytes);\n")
_A_STAGE = ("          store_adapter<T>(st + kXBytes + kWBytes, pre[u % kPre], "
            "p);\n", "")
_A_LOAD = ("    v[e] = bf16_bits(q, j < r && k + 2 * e < K) |\n"
           "           bf16_bits(q + r, j < r && k + 2 * e + 1 < K) << 16;",
           "    v[e] = (uint32_t)(k + e) * 0x00010001u;")
_NO_STORE = ("        if (row0 + rl < M && col < N)",
             "        if (row0 + rl < 0 && col < N)")
_STAGES = "static constexpr int kStages = 4;"
_F32_STAGES = "static constexpr int kStages = 2;"

EDITS = {   # variant: [(text in the source, its replacement), ...]
    "copies_only": [_NO_PRODUCTS],
    "mma_only": _TMA,
    "mma_only_no_store": _TMA + [_NO_STORE],
    "x_copies_only": [_NO_PRODUCTS] + _X_ONLY,
    "w_copies_only": [_NO_PRODUCTS, _W_ONLY],
    "no_adapter": [(_BF16_XA, ""),
                   ("    for (int j = 0; j < kTN / 8; ++j) {\n"
                    "      const uint8_t* p",
                    "    for (int j = 0; j < 0; ++j) {\n"
                    "      const uint8_t* p")],
    "no_a_stage": [_A_STAGE],
    "no_a_load": [_A_LOAD],
    "no_store": [_NO_STORE],
    "l2_128": [("CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
                "CU_TENSOR_MAP_L2_PROMOTION_L2_128B")],
    "s2": [(_STAGES, "static constexpr int kStages = 2;")],
    "s3": [(_STAGES, "static constexpr int kStages = 3;")],
    "n128": [("constexpr int kTN = 256;", "constexpr int kTN = 128;"),
             ("        wgmma_m64n256_ss(acc, da,",
              "        wgmma_m64n128_ss(acc, da,"),
             (_M64N16, _m64n128_asm() + _M64N16)],
    "f32_mma_only": _TMA,
    "f32_no_adapter": [("            sum_xa(xa, smem + ux * kStageBytes<T>, r, "
                        "p);\n", ""),
                       ("    for (int q = 0; q < r; ++q) {\n"
                        "      const float x0 = scale",
                        "    for (int q = 0; q < 0; ++q) {\n"
                        "      const float x0 = scale")],
    "f32_no_store": [("        if (row < M)\n", "        if (row < 0)\n")],
    "f32_r16": [("    if (form == 1 && r <= 8)\n", "    if (form == 1 && r <= 0)\n")],
}

_RESTAGE = ("      consumers_sync();                 // the last step's wgmmas "
            "are done\n")


def _between(base: str, start: str, end: str) -> str:
    """The text of ``base`` from ``start`` up to (not including) ``end``."""
    i = base.index(start)
    return base[i:base.index(end, i)]


# The fp32 consumers of the f32_mma_sync variant (with the helpers they
# use): 8 warps as 2 x 4 on m16n8k8 3xTF32 mma.sync.
_MMA_SYNC_CONSUMER = r'''
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a * b in 3xTF32: the two small terms first, then big * big.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ab,
                                           const uint32_t* as, uint32_t bb0,
                                           uint32_t bb1, uint32_t bs0,
                                           uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&v)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]) : "r"(addr));
}

// The fp32 consumers: 8 warps as 2 x 4, warp (wm, wn) owning rows wm * 64 ..
// + 64 and columns wn * kTN / 4 .. of the tile, in m16n8k8 3xTF32 mma.sync
// products: A fragments from the swizzled x tile by ldmatrix, B fragments
// from the W tile by 32-bit loads, both split into big and small in
// registers.  xA comes from the producer warpgroup (sum_xa).
__device__ __forceinline__ void consume_f32(
    uint8_t* smem, uint64_t* full, uint64_t* empty, const float* b,
    float* out, int M, int N, int r, float scale, const Work& wk) {
  constexpr int kK = Tc<float>::kK, S = Tc<float>::kStages;
  constexpr int kWN = kTN / 4, kWN8 = kWN / 8;   // a warp's columns
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const float* xas =
      reinterpret_cast<const float*>(smem + S * kStageBytes<float>);
  float* bsm = reinterpret_cast<float*>(smem + S * kStageBytes<float> +
                                        kXaBytes);
  // ldmatrix: lane l addresses row l % 8 of 8 x 4-float matrix l / 8, i.e.
  // rows +8 for matrices 1 and 3, the K chunk +1 for matrices 2 and 3
  const int lrow = wm * 64 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lchunk = lane >> 4;
  int gk = 0;
  for (int tile = wk.cta; tile < wk.tiles; tile += wk.ctas) {
    const int m0 = wk.m0(tile), n0 = wk.n0(tile);
    float acc[4][kWN8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kWN8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int kt = 0; kt < wk.nk; ++kt, ++gk) {
      const int s = gk % S;
      mbar_wait(&full[s], (gk / S) & 1);
      const uint8_t* st = smem + s * kStageBytes<float>;
      const uint32_t xs = smem_u32(st);
      const uint8_t* ws = st + kXBytes;
#pragma unroll
      for (int kk = 0; kk < kK / 8; ++kk) {
        uint32_t ab[4][4], asm_[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = lrow + i * 16, chunk = kk * 2 + lchunk;
          uint32_t v[4];
          ldmatrix_x4(v, xs + row * kRowBytes + ((chunk ^ (row & 7)) << 4));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(__uint_as_float(v[e]), ab[i][e], asm_[i][e]);
        }
#pragma unroll
        for (int j = 0; j < kWN8; ++j) {
          // W (k, n): box n / 32, row k, chunk (n % 32) / 4 swizzled by k % 8
          const int n = wn * kWN + j * 8 + g, k = kk * 8 + t;
          const uint8_t* box = ws + (n >> 5) * kK * kRowBytes;
          const int c = (n & 31) >> 2, w4 = (n & 3) * 4;
          const float w0 = *reinterpret_cast<const float*>(
              box + k * kRowBytes + ((c ^ (k & 7)) << 4) + w4);
          const float w1 = *reinterpret_cast<const float*>(
              box + (k + 4) * kRowBytes + ((c ^ ((k + 4) & 7)) << 4) + w4);
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(w0, bb0, bs0);
          split_tf32(w1, bb1, bs1);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma_3xtf32(acc[i][j], ab[i], asm_[i], bb0, bb1, bs0, bs1);
        }
      }
      release<S>(empty, gk, wk.total, lane);
    }

    // epilogue: B[:r, n0:n0+kTN] and the producer's xA, past the ring;
    // delta by fp32 FMAs, added as acc + scale * d
    consumers_sync();                 // the previous tile's B is read
    for (int i = tid; i < r * kTN; i += kConsumers) {
      const int q = i / kTN, n = i % kTN;
      bsm[i] = n0 + n < N ? b[(size_t)q * N + n0 + n] : 0.f;
    }
    // xA of this tile written (and the B tile)
    asm volatile("bar.sync 2, %0;\n" ::"n"(kTcThreads) : "memory");
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = wm * 64 + i * 16 + g;
      float d[kWN8][4];
#pragma unroll
      for (int j = 0; j < kWN8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
      for (int q = 0; q < r; ++q) {
        const float x0 = xas[rl * kXaLd + q], x1 = xas[(rl + 8) * kXaLd + q];
#pragma unroll
        for (int j = 0; j < kWN8; ++j) {
          const float2 bv = *reinterpret_cast<const float2*>(
              bsm + q * kTN + wn * kWN + j * 8 + 2 * t);
          d[j][0] = fmaf(x0, bv.x, d[j][0]);
          d[j][1] = fmaf(x0, bv.y, d[j][1]);
          d[j][2] = fmaf(x1, bv.x, d[j][2]);
          d[j][3] = fmaf(x1, bv.y, d[j][3]);
        }
      }
      // N % 4 == 0, so a pair of columns is in or out whole
#pragma unroll
      for (int j = 0; j < kWN8; ++j) {
        const int col = n0 + wn * kWN + j * 8 + 2 * t;
        if (col >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + rl + 8 * h;
          if (row < M)
            *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
                make_float2(acc[i][j][2 * h] + scale * d[j][2 * h],
                            acc[i][j][2 * h + 1] + scale * d[j][2 * h + 1]);
        }
      }
    }
    // this tile's xA is read: the producer may write the next one's
    if (tile + wk.ctas < wk.tiles)
      asm volatile("bar.arrive 3, %0;\n" ::"n"(kTcThreads) : "memory");
  }
}

'''


def _spans(base: str) -> dict:
    """Variants whose edits cut whole blocks of the fp32 consumer."""
    fp32 = _between(base, "// The fp32 consumers, 3xTF32 on wgmma.",
                    "// A persistent kernel:")
    restage = _between(fp32, _RESTAGE, "      fence_proxy_async();\n")
    products = _between(fp32, "      const uint32_t ab = smem_u32(xb)",
                         "      fence_regs(acc);\n")
    wgmma = _between(base, "// D (64 x 256, fp32) += A (64 x 8, tf32)",
                     "// A persistent kernel:")
    return {
        "f32_copies_only": [(restage, ""), (products, "")],
        "f32_no_restage": [(restage, _RESTAGE)],
        "f32_mma_sync": [
            (wgmma, _MMA_SYNC_CONSUMER),
            (_F32_STAGES, "static constexpr int kStages = 3;"),
            ("constexpr int kRestageBytes = sizeof(T) == 4 ? 2 * kXBytes + "
             "2 * kWBytes : 0;", "constexpr int kRestageBytes = 0;")],
    }


def build(sources: dict, out_dir: Path) -> dict:
    """nvcc each variant's source into a library, all at once; print the
    tensor-core kernels' registers, spills and ptxas warnings of each."""
    from tsue_tpu_torch.ops._build import build_variants
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build_variants(sources, out_dir, {
        "lora_matmul": [ptr] * 5 + [i32] * 4 + [ctypes.c_float, i32, i32,
                                                ptr],
        "lora_matmul_ctas": [i32]})
    for name, (_, report) in libs.items():
        lines = report.splitlines()
        for i, line in enumerate(lines):
            if "entry function" in line and "lora_tc_kernel" in line:
                form = ("bf16" if "nv_bfloat16" in line
                        else "f32 r<=8" if "Li8E" in line else "f32")
                print(f"ptxas {name} {form}: " + " ".join(
                    x.split("info    :")[-1].strip()
                    for x in lines[i + 2:i + 4]), flush=True)
            if "serialized" in line:
                print(f"ptxas {name}: " + line.split(": ", 1)[-1][:100],
                      flush=True)
    return {name: lib for name, (lib, _) in libs.items()}


def inputs(dev, g, M, K, N, dtype, r=8):
    """chip_smoke.py's LoRA inputs."""
    import torch
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    w = (torch.randn(K, N, generator=g, device=dev) * K ** -0.5).to(dtype)
    a = (torch.randn(K, r, generator=g, device=dev) * K ** -0.5).to(dtype)
    b = (torch.randn(r, N, generator=g, device=dev) * 0.1).to(dtype)
    return x, w, a, b, 4.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the timings here as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lora_variants: no CUDA device", file=sys.stderr)
        return 1
    import tsue_tpu_torch.ops.lora as LO
    from tsue_tpu_torch.ops._build import BUILD_DIR, CSRC
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    base = (CSRC / "lora_matmul.cu").read_text()
    edits_of = dict(EDITS, **_spans(base))
    sources = {"base": base}
    for name, edits in edits_of.items():
        text = base
        for old, new in edits:
            cs.check(text.count(old) == 1, f"variant {name}: edit not found")
            text = text.replace(old, new)
        sources[name] = text
    libs = build(sources, BUILD_DIR / "lora_variants")
    dev = torch.device("cuda:0")
    timer = cs.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    cases = {}
    for sname, M, K, N in cs.LORA_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            form = "f32" if dtype == torch.float32 else "bf16"
            cases[f"{sname}_{form}"] = (form, inputs(dev, g, M, K, N, dtype))
    runs = [(f"base@{c}", "base", c) for c in cases]
    runs += [(f"{name}@{c}", name, c) for name in edits_of
             for c, (form, _) in cases.items()
             if name.startswith("f32_") == (form == "f32")]
    times: dict = {}
    wrong: set = set()
    for order in (runs, runs[::-1]):
        for label, name, case in order:
            form, args_ = cases[case]
            LO._lib = lambda lib=libs[name]: lib    # the wrapper's binding
            out = LO.lora_matmul(*args_)
            if "only" not in name and "no_" not in name:
                ref = LO.lora_ref(*args_, round_xa=True).float()
                big = ref.abs().max().item()
                tol = (dict(rtol=1e-4, atol=1e-5 * big) if form == "f32"
                       else dict(rtol=2 ** -7, atol=2 ** -7 * big))
                if not torch.allclose(out.float(), ref, **tol):
                    print(f"{label} disagrees with the plain version",
                          flush=True)
                    wrong.add(label)
                    continue
            ms = timer.ms(lambda: LO.lora_matmul(*args_))
            times.setdefault(label, []).append(ms)
            print(f"{label}: {ms:.4f} ms; gpu: {gpu}", flush=True)
    summary = {name: min(v) for name, v in times.items()}
    print(json.dumps({"gpu": gpu, "min_ms_of_two_rounds": summary}),
          flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"gpu": gpu, "ms": times}, indent=1))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
