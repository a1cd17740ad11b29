#!/usr/bin/env python3
"""Time text variants of the fused SwiGLU down-projection kernel side by
side on one GPU.

    python3 swiglu_variants.py [--dtype bfloat16] [--old-source FILE]
                               [--out build/swiglu_variants.json]

Each variant is ``tsue_tpu_torch/csrc/swiglu_matmul.cu`` with some edits
(``EDITS``, and ``_spans`` for edits that swap whole blocks), built with
nvcc into ``build/swiglu_variants/`` (all in parallel) and swapped in under
``tsue_tpu_torch.ops.fused``.  Every variant is timed at chip_smoke.py's
training shape at batch 16 (M 8448, K 8192, N 2048) with chip_smoke.py's
timer (L2 flushed, median of 15), in two rounds, the second in reverse
order, so a drift of the card does not favour one variant.  ``--old-source``
adds an earlier source of the kernel (e.g. ``git show
<commit>:tsue_tpu_torch/csrc/swiglu_matmul.cu`` written under ``runs/``) as
the variant ``old``, checked and timed beside the others through the same
C entry.  The fp32 form's variants (the default, ``--dtype float32``)
answer where its time goes:

  copies_only    the ring's TMA copies alone (the pre-pass runs; no
                 activation, no product; the epilogue stores zeros)
  mma_only       the products alone: no TMA copy, no activation (h = g of
                 what the ring holds), the stages released as they are
  no_activation  h = g: the copies and the products without the
                 activation's arithmetic
  no_prepass     the product without the pre-pass (W^T's halves left from
                 before)
  prepass_only   the pre-pass alone
  ieee_div       the activation's division in IEEE fp32 (g / (1 + expf(-g)),
                 with its slow-path branch) instead of __fdividef
  no_promote     the products of a stage summed by the tensor cores into
                 one m64n256 accumulator a warpgroup, no chunks, no
                 promotion to CUDA-core sums (the A fragments double-
                 buffered, so a stage's activation overlaps the previous
                 stage's products): the precision the promotion buys, and
                 its cost
  restage        W's halves re-staged K-major in shared memory by the
                 consumers each stage (as lora_matmul.cu's fp32 form; one
                 buffer beside a ring of g, u and W, 64 KB a stage)
                 instead of the pre-pass
  cn64           chunks of 64 columns (m64n64 wgmmas) instead of 128

The bf16 form's (``--dtype bfloat16``; inputs and W bf16):

  bf16_copies_only    the two rings' TMA copies alone (no activation, no
                      product; the epilogue stores what the accumulators
                      hold)
  bf16_mma_only       the products alone: no TMA copy, no activation (h = g
                      of what the ring holds)
  bf16_no_activation  h = g: the copies and the products without the
                      activation's arithmetic

The variants named ``*only``, ``no_activation`` and ``no_prepass`` do not
compute the function and are not checked.  ``no_promote`` is held to the
tolerance but only reported: its ``tol_used`` is what it measures.  Every
other variant is held to the plain version with chip_smoke.py's SwiGLU
tolerance (fp32: rtol 1e-4, atol 1e-5 of the largest output; bf16: rtol
2^-7, atol 2^-7 of the largest output); one that disagrees is named, left
untimed, and makes the script exit 1.  It needs a CUDA
device and nvcc, and prints the card beside every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import chip_smoke as cs

SHAPE = (16 * (16 + cs.TEXT_TOKENS), 8192, 2048)   # M, K, N: train b16


def _wgmma_asm(n: int) -> str:
    """The m64n<n>k8 tf32 wgmma with A from registers, into a chunk or
    accumulator of n / 2 sums a thread, named as in the source."""
    regs = n // 2
    ops = ", ".join(f"%{i}" for i in range(regs))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    a_ops = ", ".join(f"%{regs + i}" for i in range(4))
    return (
        "__device__ __forceinline__ void wgmma_tf32_rs(\n"
        f"    float (&d)[{regs}], const uint32_t (&a)[4], uint64_t db,\n"
        "    int acc) {\n"
        "  asm volatile(\n"
        f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 5}, 0;\\n"\n'
        f'      "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 '
        f'{{{ops}}}, "\n'
        f'      "{{{a_ops}}}, %{regs + 4}, p, 1, 1;\\n}}\\n"\n'
        f"      : {outs}\n"
        '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), '
        '"r"(acc));\n'
        "}\n\n")


def _between(base: str, start: str, end: str) -> str:
    """The text of ``base`` from ``start`` up to (not including) ``end``."""
    i = base.index(start)
    return base[i:base.index(end, i)]


_ACT = ("  return __fdividef(g, 1.0f + expf(-g)) * u;",
        "  return g + 0.f * u;")
_PREPASS = ("  split_wt_kernel<<<dim3((N + kT - 1) / kT, K / kT), 256, 0, "
            "stream>>>(\n      w, wb, ws, K, N);\n", "")
_PRODUCT = ("  swiglu_tc_kernel<<<tiles < resident ? tiles : resident, "
            "kThreads, kSmem,\n                     stream>>>(tg, tu, twb, "
            "tws, out, M, K, N);\n", "")
_LOADS = ("        tma_load(st, &tg, k0, m0, &full[s]);\n"
          "        tma_load(st + kGBytes, &tu, k0, m0, &full[s]);\n"
          "        tma_load(st + 2 * kGBytes, &twb, k0, n0, &full[s]);\n"
          "        tma_load(st + 2 * kGBytes + kWBytes, &tws, k0, n0, "
          "&full[s]);\n")
_TX = "        mbar_arrive_tx(&full[s], kStageBytes);\n"
_RELEASE = "      release(empty, gk, wk.total, lane);\n"
_WB = "      const uint32_t wb = smem_u32(st + 2 * kGBytes), ws = wb + kWBytes;\n"
_CN64 = [("constexpr int kCN = 128;", "constexpr int kCN = 64; "),
         ("static_assert(kCN == 128 &&", "static_assert(kCN == 64 &&")]

EDITS = {   # variant: [(text in the source, its replacement), ...]
    "no_activation": [_ACT],
    "no_prepass": [_PREPASS],
    "prepass_only": [_PRODUCT],
    "ieee_div": [(_ACT[0], "  return g / (1.0f + expf(-g)) * u;")],
    "mma_only": [(_TX, "        mbar_arrive(&full[s]);\n"), (_LOADS, ""),
                 _ACT],
}

# no_promote's consumer: one m64n256 accumulator a warpgroup; the stages
# taken in pairs, so a stage's A fragments (buffer b) stay untouched while
# its products run and the next stage's are formed in the other buffer.
_NO_PROMOTE_CONSUMER = r"""
__device__ __forceinline__ void consume(uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, float* out, int M,
                                        int N, const Work& wk) {
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, g8 = lane >> 2, t = lane & 3;
  const int rl = wg * 64 + warp * 16 + g8;
  const int a_off = rl * kRowBytes + t * 4;
  int gk = 0;
  for (int tile = wk.cta; tile < wk.tiles; tile += wk.ctas) {
    const int m0 = wk.m0(tile), n0 = wk.n0(tile);
    float sum[kTN / 2];
#pragma unroll
    for (int i = 0; i < kTN / 2; ++i) sum[i] = 0.f;
    uint32_t ab[2][kK / 8][4], as[2][kK / 8][4];
    for (int kt = 0; kt < wk.nk; kt += 2) {
#pragma unroll
      for (int b = 0; b < 2; ++b, ++gk) {
        const int s = gk % kStages;
        mbar_wait(&full[s], (gk / kStages) & 1);
        const uint8_t* st = smem + s * kStageBytes;
#pragma unroll
        for (int kk = 0; kk < kK / 8; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int off = a_off + (e & 1) * 8 * kRowBytes +
                            (((2 * kk + (e >> 1)) ^ g8) << 4);
            const float gv = *reinterpret_cast<const float*>(st + off);
            const float uv =
                *reinterpret_cast<const float*>(st + kGBytes + off);
            split_tf32(swiglu(gv, uv), ab[b][kk][e], as[b][kk][e]);
          }
        }
        const uint32_t wb = smem_u32(st + 2 * kGBytes), ws = wb + kWBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kK / 8; ++kk) {
          wgmma_tf32_rs(sum, as[b][kk], sw128_desc(wb + kk * 32), 1);
          wgmma_tf32_rs(sum, ab[b][kk], sw128_desc(ws + kk * 32), 1);
          wgmma_tf32_rs(sum, ab[b][kk], sw128_desc(wb + kk * 32), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (kt + b > 0) release(empty, gk - 1, wk.total, lane);
      }
    }
    wgmma_wait<0>();
    fence_regs(sum);
    release(empty, gk - 1, wk.total, lane);
#pragma unroll
    for (int j = 0; j < kTN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + rl + 8 * h;
        if (row < M)
          *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
              make_float2(sum[j * 4 + 2 * h], sum[j * 4 + 2 * h + 1]);
      }
    }
  }
}

"""

# restage: the consumers transpose the ring's W tile (8 boxes of 32 columns,
# N-major, swizzled) into W^T's halves, K-major and swizzled, in one buffer
# past the ring, 4 x 4 blocks through registers (lora_matmul.cu's fp32 form).
_RESTAGE_BLOCK = r'''      uint8_t* rb = smem + kStages * kStageBytes;   // W^T big, then small
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
      for (int h = 0; h < 2; ++h) {     // W: 4 x 4 blocks (k 4kb.., n 4nb..)
        const int kb = tid & 7, nb = (tid >> 3) + 32 * h;
        float v[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * kb + e;
          const float4 w4 = *reinterpret_cast<const float4*>(
              st + 2 * kGBytes + (nb >> 3) * kK * kRowBytes + k * kRowBytes +
              (((nb & 7) ^ (k & 7)) << 4));
          v[e][0] = w4.x; v[e][1] = w4.y; v[e][2] = w4.z; v[e][3] = w4.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 4 * nb + i;
          uint32_t bg[4], sm[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(v[e][i], bg[e], sm[e]);
          const int off = n * kRowBytes + ((kb ^ (n & 7)) << 4);
          *reinterpret_cast<uint4*>(rb + off) =
              make_uint4(bg[0], bg[1], bg[2], bg[3]);
          *reinterpret_cast<uint4*>(rb + kWBytes + off) =
              make_uint4(sm[0], sm[1], sm[2], sm[3]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      release(empty, gk, wk.total, lane);
      const uint32_t wb = smem_u32(rb), ws = wb + kWBytes;
'''


def _spans(base: str) -> dict:
    """Variants whose edits swap whole blocks of the source."""
    wgmma = _between(base, "// D (64 x 128, fp32) = A (64 x 8, tf32",
                     "// The tiles of a CTA:")
    consumer = _between(base, "__device__ __forceinline__ void consume(",
                        "// A persistent kernel:")
    compute = _between(consumer, "      uint32_t ab[kK / 8][4]", _RELEASE)
    return {
        "copies_only": [(compute, "      (void)st;\n")],
        "no_promote": [(wgmma, _wgmma_asm(256)),
                       (consumer, _NO_PROMOTE_CONSUMER.lstrip("\n"))],
        "cn64": _CN64 + [(wgmma, _wgmma_asm(64))],
        "restage": [
            ("constexpr int kStageBytes = 2 * kGBytes + 2 * kWBytes;",
             "constexpr int kStageBytes = 2 * kGBytes + kWBytes;"),
            ("constexpr int kSmem = kStages * kStageBytes + 1024;",
             "constexpr int kSmem = kStages * kStageBytes + 2 * kWBytes + "
             "1024;"),
            (_RELEASE, ""),            # released after the re-stage
            (_WB, _RESTAGE_BLOCK),
            ("        tma_load(st + 2 * kGBytes, &twb, k0, n0, &full[s]);\n"
             "        tma_load(st + 2 * kGBytes + kWBytes, &tws, k0, n0, "
             "&full[s]);\n",
             "        for (int j = 0; j < kTN / 32; ++j)\n"
             "          tma_load(st + 2 * kGBytes + j * kK * kRowBytes, "
             "&twb, n0 + j * 32, k0, &full[s]);\n"),
            _PREPASS,
            ("      !tensor_map(&twb, wb, N, K, kTN) || "
             "!tensor_map(&tws, ws, N, K, kTN))",
             "      !tensor_map(&twb, w, K, N, kK) || "
             "!tensor_map(&tws, ws, N, K, kTN))")],
    }


CHECKED = ("base", "ieee_div", "restage", "cn64", "old")
REPORTED = ("no_promote",)

_BF16_ACT = ("  const bf162 h = __hmul2(s, *reinterpret_cast<const bf162*>(&u2));\n"
             "  return *reinterpret_cast<const uint32_t*>(&h);",
             "  (void)s; (void)u2;\n  return g2;")
_BF16_G_TX = ("        mbar_arrive_tx(&full_g[s], kGStageBytes);\n"
              "        tma_load(st, &tg, k0, m0, &full_g[s]);\n"
              "        tma_load(st + kBGBytes, &tu, k0, m0, &full_g[s]);\n")
_BF16_W_TX = ("        mbar_arrive_tx(&full_w[s], boxes * kWBoxBytes);\n"
              "        for (int i = 0; i < boxes; ++i)\n"
              "          tma_load(st + i * kWBoxBytes, &tw, n0 + i * kWBoxN, "
              "k0, &full_w[s]);\n")
BF16_EDITS = {
    "bf16_no_activation": [_BF16_ACT],
    "bf16_mma_only": [(_BF16_G_TX, "        mbar_arrive(&full_g[s]);\n"),
                      (_BF16_W_TX, "        mbar_arrive(&full_w[s]);\n"),
                      _BF16_ACT],
}


def _bf16_spans(base: str) -> dict:
    """The bf16 variants whose edits swap whole blocks of the source."""
    consumer = _between(base, "__device__ __forceinline__ void consume_bf16(",
                        "// The bf16 form's persistent kernel")
    act = _between(consumer, "#pragma unroll\n        for (int kk = 0;",
                   "        release_bf16<kGStages>")
    mma = _between(consumer, "        wgmma_fence();", "        wgmma_wait<1>();")
    return {"bf16_copies_only": [(act, "        (void)st;\n"),
                                 (mma, "        (void)wb;\n")]}


def build(sources: dict, out_dir: Path) -> dict:
    """nvcc each variant's source into a library, all at once; print the
    product kernel's registers, spills and ptxas warnings of each."""
    from tsue_tpu_torch.ops._build import build_variants
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build_variants(sources, out_dir, {
        "swiglu_matmul": [ptr] * 5 + [i32] * 3 + [ptr],
        "swiglu_matmul_bf16": [ptr] * 4 + [i32] * 3 + [ptr],
        "swiglu_matmul_ctas": []})
    for name, (_, report) in libs.items():
        lines = report.splitlines()
        for i, line in enumerate(lines):
            if "entry function" in line and ("swiglu_tc_kernel" in line or
                                             "swiglu_bf16_kernel" in line):
                print(f"ptxas {name}: " + " ".join(
                    x.split("info    :")[-1].strip()
                    for x in lines[i + 2:i + 4]), flush=True)
            if "serialized" in line or "setmaxnreg" in line:
                print(f"ptxas {name}: " + line.split(": ", 1)[-1][:120],
                      flush=True)
    return {name: lib for name, (lib, _) in libs.items()}


def _caller(FU, lib, gate, up, w):
    """A call of one variant's library: through the wrapper (bound to
    ``lib``), or, for the bf16 form, straight to its C entry with the
    output the wrapper would allocate (an earlier source may lack the
    entries the wrapper's plan asks for)."""
    import torch
    if gate.dtype == torch.float32:
        FU._swiglu_lib = lambda: lib      # the wrapper's binding
        return lambda: FU._swiglu_cuda(gate, up, w)
    (M, K), N = gate.shape, w.shape[1]
    out = torch.empty(M, N, device=gate.device, dtype=gate.dtype)

    def call():
        err = lib.swiglu_matmul_bf16(
            gate.data_ptr(), up.data_ptr(), w.data_ptr(), out.data_ptr(), M,
            K, N, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"swiglu_matmul_bf16: CUDA error {err}")
        return out
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32", help="the form whose variants run")
    ap.add_argument("--old-source", type=Path, default=None,
                    help="an earlier swiglu_matmul.cu, timed as 'old'")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the timings here as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("swiglu_variants: no CUDA device", file=sys.stderr)
        return 1
    import tsue_tpu_torch.ops.fused as FU
    from tsue_tpu_torch.ops._build import BUILD_DIR, CSRC
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    base = (CSRC / "swiglu_matmul.cu").read_text()
    bf16 = args.dtype == "bfloat16"
    edits_of = ({**BF16_EDITS, **_bf16_spans(base)} if bf16
                else {**EDITS, **_spans(base)})
    sources = {"base": base}
    if args.old_source is not None:
        sources["old"] = args.old_source.read_text()
    for name, edits in edits_of.items():
        text = base
        for old, new in edits:
            cs.check(text.count(old) == 1, f"variant {name}: edit not found")
            text = text.replace(old, new)
        sources[name] = text
    libs = build(sources, BUILD_DIR / "swiglu_variants")
    dev = torch.device("cuda:0")
    timer = cs.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    M, K, N = SHAPE
    dtype = torch.bfloat16 if bf16 else torch.float32
    gate = torch.randn(M, K, generator=g, device=dev).to(dtype)
    up = torch.randn(M, K, generator=g, device=dev).to(dtype)
    w = (torch.randn(K, N, generator=g, device=dev) * K ** -0.5).to(dtype)
    ref = FU.swiglu_matmul_plain(gate, up, w).float()
    rtol = 2 ** -7 if bf16 else 1e-4
    atol = (2 ** -7 if bf16 else 1e-5) * ref.abs().max().item()
    names = list(sources)
    times: dict = {}
    used: dict = {}
    wrong: set = set()
    for order in (names, names[::-1]):
        for name in order:
            if name in wrong:
                continue
            call = _caller(FU, libs[name], gate, up, w)
            out = call().float()
            torch.cuda.synchronize()
            if name in CHECKED or name in REPORTED:
                used[name] = ((out - ref).abs()
                              / (atol + rtol * ref.abs())).max().item()
                print(f"{name}: tol_used {used[name]:.4f}", flush=True)
                if name in CHECKED and not torch.allclose(
                        out, ref, rtol=rtol, atol=atol):
                    print(f"{name} disagrees with the plain version",
                          flush=True)
                    wrong.add(name)
                    continue
            del out
            ms = timer.ms(call)
            times.setdefault(name, []).append(ms)
            print(f"{name} M={M} K={K} N={N}: {ms:.4f} ms; gpu: {gpu}",
                  flush=True)
    summary = {name: min(v) for name, v in times.items()}
    print(json.dumps({"gpu": gpu, "dtype": args.dtype, "shape": SHAPE,
                      "tol_used": used,
                      "min_ms_of_two_rounds": summary}), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"gpu": gpu, "ms": times,
                                        "tol_used": used}, indent=1))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
