// Flash-attention forward for Hopper (sm_90a), fp32 or bf16, GQA-native,
// optional RoPE.
//
// Replaces three Pallas TPU bodies of tsue_tpu/ops/flash.py:
//   - _gqa_rope_kernel (:103)  Llama self-attention, RoPE applied in the kernel
//   - _gqa_kernel      (:85)   the same without RoPE: LTSF cross-attention
//                              (D = 1024), the no-RoPE prefill, fp32-cache decode
//   - _folded_kernel   (:128)  small-width encoders: Q-Former D = 96, lane
//                              encoder D = 16, LTSF self-attention D = 32
// On the TPU they differ only in how heads are laid into the (8, 128) vector
// tiles.  Here the GQA index map h_kv = h_q / G replaces head folding and K/V
// repetition, so one source covers all three.
//
// Semantics (tsue_tpu/ops/flash.py:_softmax_attend and the three bodies):
// fp32 logits q.k * scale; a key is valid when the mask lets row i see key j
// and, if causal, j <= i + (Tk - Tq) (jnp.tril(k=Tk-Tq)).  The mask is
// int32, read at mask[b * (mq ? Tq * mq : Tk) + i * mq + j] with mq, its
// query stride, 0 for a (B, Tk) key mask (every row reads it) and Tk for a
// (B, Tq, Tk) per-query mask (a speculative window over the decode cache:
// in-window causality); null lets every key through.  A key mask takes the
// same loads and arithmetic as before the stride existed: the same bits.
// Invalid logits become the finite -1e30, so a row with no valid key gives
// the uniform mean of V over all Tk keys (not NaN); softmax in fp32; out =
// P.V / max(sum P, 1e-30).  RoPE is
// rotate-half in fp32 on q and k (self-attention, D <= 128).  Activations
// are fp32 and products are fp32 FMAs on the CUDA cores (no TF32).
//
// bf16 (a model whose parameters are bf16): Q, K and V all bf16, or
// fp32 Q over bf16 K and V (the wrapper widens a bf16 Q over fp32 K and V,
// which is exact).  Both compute the Pallas function of those dtypes: QK^T
// and the softmax in fp32, the roped q and k rounded to their own dtype
// (_rope_2d's astype), P rounded to V's dtype before P V
// (p.astype(v.dtype)), fp32 sums, the output in Q's dtype.  The Pallas
// kernel rounds the normalised P, these kernels the unnormalised one
// (online softmax): the same rounding error, not the same bits.
//   - All-bf16 calls of the tiled form take the tensor-core form below
//     (attn_mma_kernel, "bf16_mma"); those of the split-KV form at D <= 128
//     (the decode step) take the decode form below (attn_decode_kernel,
//     "bf16_decode").
//   - bf16 K and V at D = 1024, Q fp32 or bf16 (the LTSF cross-attention of
//     a bf16 model), take the wide form below (attn_wide_kernel,
//     "bf16_wide").
//   - fp32 Q over bf16 K and V at D <= 128 takes attn_kernel with the
//     template parameters QT, KT: the copying thread loads bf16 operands
//     (8-byte loads), widens them and stores them to the fp32 stages; the
//     ring and its barriers are the fp32 kernel's.
// fp32 calls compile to the kernels they were (QT = KT = float).
//
// The bf16 tensor-core form (attn_mma_kernel<D>, D 16 to 128):
//   - bound on an H100 at the Llama shape (B 16, T 528, 32/8 heads of 64,
//     RoPE, causal, key mask): 0.0265 ms of bytes (q, k, v, out, mask, cos,
//     sin once), 0.016 ms of bf16 operations (989 TFLOP/s); the widening
//     form's floor was the 0.237 ms of fp32 FMAs;
//   - a block of 8 warps owns 128 (row, head) items of one (b, KV head),
//     16 a warp: one m16 tile of mma.sync m16n8k16 (bf16 operands, exact
//     products, fp32 sums: the Pallas function itself).  K/V tiles are read
//     once for the group (GQA without repetition);
//   - K and V tiles of 64 keys stay bf16 in shared memory (rows padded to D
//     + 8: ldmatrix reads 8 rows from 8 bank groups), with the tile's key
//     mask and, roped, its cos and sin, through a ring of three stages (two
//     tiles in flight) filled by 16-byte cp.async (4-byte for the mask);
//     the first tiles are issued before the Q block loads;
//   - the Q block is roped and rounded as it loads, staged in the last
//     stage's buffer, and held as A fragments in registers for the whole
//     key walk (ldmatrix); each K tile is roped in place as it lands, each
//     thread rotating the pairs it copied (no extra barrier), and rounded
//     to bf16;
//   - S = Q K^T: B fragments of K by ldmatrix; the online softmax on the S
//     accumulators in fp32 (exp2f of the scaled difference; the row's four
//     lanes by shuffles; the row sum a lane's share, added at the end); P
//     packed to bf16 from the S registers straight into the A fragments of
//     P V (no shared-memory round trip); B fragments of V by
//     ldmatrix.trans; O rescaled in fp32 registers;
//   - the causal early stop, heaviest row blocks first, the run on to Tk
//     of a block in which a row saw no valid key, and one fixed order of
//     sums (a repeated call bit-identical) are the tiled form's;
//   - on an H100 80GB HBM3 at 700 W (chip_smoke.py's bf16 rows): the
//     Llama shape 0.198 ms (the widening form 0.845, SDPA bf16 0.267),
//     the Q-Former's self-attention (B 16, T 18, 8 heads of 96) 0.0095
//     (0.0178); at the Llama shape its copies alone take 0.159 ms and its
//     arithmetic alone 0.170 (flash_variants.py --dtype bfloat16): they
//     overlap;
//   - ptxas (sm_90a, CUDA 12.8), registers (spill store / load bytes) and
//     the dynamic shared memory a launch asks for (three stages; roped):
//     <16> 128 (0), 19,200 (31,488); <32> 128 (0), 31,488 (56,064); <64>
//     128 (28 / 40: the 128-register cap of two 256-thread blocks an SM),
//     56,064 (105,216); <96> 196 (0), 80,640 (154,368); <128> 226 (0),
//     105,216 (203,520).
//
// The bf16 decode form (attn_decode_kernel<D>, D 16 to 128; all-bf16
// operands, no RoPE, at most 16 items per (b, KV head), a key mask or
// none):
//   - bound on an H100 at the decode step (B 16, Tq 1, 592 slots, 32/8
//     heads of 64): 19.4 MB of K and V read once, 0.0058 ms; the widening
//     split-KV form it replaces took 0.043 ms in two launches, K and V
//     loaded synchronously into an fp32 ring, 6 of its 8 warps only
//     copying, its products fp32 FMAs;
//   - a block of 4 warps per (b, KV head, key split); the items are one
//     m16 tile, held by every warp as bf16 A fragments loaded straight from
//     device memory; warp w takes the split's key tiles w, w + 4, .. and
//     walks them through a ring of its own (2 tiles at D 64 and 96, 4 at
//     16 and 32, 1 at 128), filled by 16-byte cp.async before Q loads, K
//     and V bf16 in shared memory as attn_mma_kernel lays them: no block
//     barrier in the key walk;
//   - QK^T, the online softmax and P V as attn_mma_kernel does them
//     (mma.sync m16n8k16, ldmatrix(.trans), P packed from the S
//     registers); the warps merge in warp order through shared memory;
//   - key splits: one wave of blocks over the card (B * Hkv * splits at
//     most the blocks the card holds at once, whole tiles a split): the
//     decode step's 128 (b, KV head) pairs take one split of 10 tiles, a
//     block an SM; B 1 takes 10 splits of one tile.  With several splits
//     each block writes its (acc, m, l) to the wrapper's scratch and the
//     block that takes its pair's last ticket (g_dec_tickets, reset by it)
//     merges all splits in split order: one launch, a repeat bit-identical;
//   - on an H100 80GB HBM3 at 700 W (chip_smoke.py's bf16 decode row,
//     bits_vs_source.py): 0.0185-0.0189 ms (SDPA bf16 0.0259-0.0266, the
//     widening form 0.0428-0.0444); its copies alone take 0.0160-0.0166
//     ms, its arithmetic alone 0.0097-0.0100, and neither (the launch, Q's
//     loads, the merge and the store) 0.0069 (flash_variants.py --dtype
//     bfloat16): the copies add ~0.0092, ~2.1 TB/s; contiguous rows
//     instead of the cache's 1 KB-strided ones copy no faster (0.0159
//     against 0.0160), nor do three tiles in flight a warp (0.0194 in all);
//   - ptxas: the table below (attn_decode_kernel<D>).
//
// The bf16 wide form (attn_wide_kernel<QT>; D = 1024, bf16 K and V, Q fp32
// or bf16, a key mask or none, causal or not; no RoPE, no per-query mask):
//   - bound on an H100 at the LTSF cross-attention (B 16, Tq 18, Tk 528, 2
//     heads of 1024, a key mask): 73.9 MB of q, k, v, out and mask read or
//     written once, 0.0221 ms (fp32 q; 0.0214 with a bf16 q), against 0.0025
//     ms of bf16 operations with the three-term split; the widening form it
//     replaces took 0.182 ms in two launches, K and V widened by a
//     synchronous copy into an fp32 ring, 9 splits of one 64-key tile
//     each re-reading Q, fp32 FMAs, a 42 MB scratch round trip;
//   - a thread block cluster of c CTAs per (b, KV head, 18 items), one
//     CTA of 8 warps per key split (c <= 8 and the tiles; picked with
//     cudaOccupancyMaxActiveClusters for the least waves x tiles: on an H100
//     SXM the LTSF call takes 32 clusters of 3, one wave of 96 CTAs, 11
//     tiles each: cudaOccupancyMaxActiveClusters puts fewer than 32
//     clusters of 4 such CTAs on the card at once);
//   - warp w owns columns 128 w ..: S^T = K Q^T (keys m, items n, three n8
//     tiles) on mma.sync m16n8k16 with exact products; Q's hi term is held
//     in registers for the whole walk, an fp32 q's mid and lo terms in
//     shared memory (Q re-read from shared memory every 16-key tile bound
//     S^T: 147 KB a tile); the 8 warps' partials added in warp order by
//     the softmax threads (8 an item); P bf16 in shared memory; O^T += V^T
//     P^T in registers (96 a thread);
//   - 16-key tiles (one m16 of S^T, one k16 of P V: a tile of K or V at D
//     1024 is 32 KB), K with its key mask and V as half-tiles through a
//     cp.async ring of 4 (fp32 q) or 6 (bf16 q) with an L2 evict-first
//     policy (read once; the misses then displace K and V, not dirty lines:
//     with normal priority 0.0527 ms (fp32 q) and 0.0505 (bf16 q) after the
//     timer's flush, flash_variants.py wide_evict_normal); a step runs tile
//     t's S^T beside tile t - 1's P V, then tile t's softmax: two barriers
//     a tile;
//   - the ranks' (O, m, l) stay in shared memory; after a cluster barrier
//     each rank reads every item's (m, l) once, weighs and adds every
//     rank's O for its items in rank order through distributed shared
//     memory and writes the output: one launch, no scratch, a repeat
//     bit-identical;
//   - on an H100 80GB HBM3 at 700 W (chip_smoke.py, bits_vs_source.py,
//     flash_variants.py --dtype bfloat16): fp32 q 0.0459-0.0464 ms, bf16 q
//     0.0448-0.0452 (SDPA 0.395 in fp32, 0.141 in bf16); with L2 left clean
//     0.0446 and 0.0388.  Copies alone (wide_no_compute) 0.0433 and 0.0394
//     (clean 0.0390, 0.0353), arithmetic alone (wide_no_copies) 0.0322 and
//     0.0242, neither 0.0154 and 0.0112 (an empty launch 0.0054, the merge
//     0.0033 and 0.0031, the cluster barriers and weights 0.0015, an fp32
//     q's loads and split 0.0034): the copies bound it, ~2.5 TB/s after the
//     timer's flush, ~2.9 with L2 clean;
//   - ptxas: the table below (attn_wide_kernel<QT>).
//
// What bounds it on an H100 (67 TFLOP/s fp32, 3.35 TB/s):
//   - Llama self-attention (B 16, T 528, 32/8 heads of 64, causal, key
//     mask): 4 * D * Hq * (attended pairs) = 15.9 GFLOP, 0.237 ms of FMAs
//     against 0.03 ms of bytes: operations.  The design has to keep the FMA
//     pipes fed, so every operand is reused from registers.
//   - LTSF cross-attention (Tq 18, Tk 528, 2 heads of 1024) and fp32-cache
//     decode (Tq 1, S 592, 32/8 x 64): K/V are read once per (b, KV head)
//     for only 18 or 4 (row, head) items: bytes (0.043 / 0.012 ms).  The
//     design has to spread each (b, KV head)'s keys over many SMs and read
//     them from device memory once.
//
// Tiled form (many items per (b, KV head); kernel <D, 16, 4>):
//   - a block of 256 threads owns BM = 64 items of one (b, KV head): items
//     are (row, head of the group) pairs, row-major, so at G = 4 a block is
//     16 rows x 4 heads and at G = 1 64 rows;
//   - K/V tiles of BN = 64 keys stream through a two-stage shared-memory
//     ring filled by 16-byte cp.async: the next stage's copy runs under the
//     current stage's arithmetic.  A tile is two stages (K, then V); K rows
//     are padded to D + 4 floats, so the float4 reads of 8 consecutive lanes
//     fall into distinct banks;
//   - RoPE: the Q block is roped once as it is loaded; each K tile is roped
//     in place as it lands, every thread rotating the (d, d + D/2) pairs it
//     copied itself (with the cos/sin it copied beside them), so no extra
//     barrier is needed;
//   - S = Q K^T and O += P V are register-tiled: thread (ty, tx) of a 16 x
//     16 grid holds a 4 x 4 micro-tile of S (items 4ty.., keys tx + 16j)
//     and its four items' slice of O (columns h*64 + 4tx..).  Row max and
//     row sum are shuffles among the 16 lanes that share a row; P goes
//     through shared memory ([key][item], padded) to the P V product;
//   - causal: a block stops at the last key its last row may see, only
//     tiles that cross the diagonal test it per element, and the grid hands
//     out the latest (heaviest) row blocks first.  Only a block in which
//     some row saw no valid key runs on to Tk (the keys past its causal end
//     are invalid for all its rows, so the others add exact zeros).
// Split-KV form (few items per (b, KV head), flash-decoding; kernels
// <D, 16, 1> for D <= 128 and at most 16 items, <1024, 16, 2> for fp32 at
// D = 1024):
//   - one block per (b, KV head, item chunk, key split) holds all the items
//     of its (b, KV head) (up to 16, or 32 at D = 1024) and one split of the
//     keys; the keys are split so that the grid covers at least two waves
//     of the card, so every K/V byte is read from device memory once.  The
//     ring has three stages, so the K and V copies of a tile are in flight
//     together and the Q block rides with the first one;
//   - D = 1024 goes through the ring in 128-wide head-dim slices (the Q
//     slice rides with each K slice).  A block takes one 64-key tile, so
//     its O is needed one slice at a time: each V slice's product is
//     written out as it ends, 16 registers a thread, two blocks an SM;
//   - each split writes its items' unnormalised (m, l, acc) to a scratch
//     the wrapper allocates; a second kernel merges them in split order, so
//     a repeated call is bit-identical.  Every split is computed (none is
//     skipped), so a split whose keys are all invalid for an item reports
//     m = -1e30 with l = its key count, and an item with no valid key
//     anywhere gets the uniform mean over all Tk keys, as the reference.
// Speculative windows (B 16, Tq = W queries, 32/8 heads of 64, Tk = P + 64
// + W slots of the fp32 cache, a (B, W, Tk) mask): the plan picks the form
// by the items of a (b, KV head), W * G.  At W = 8 that is 32, above the 16
// a split-KV block holds, so the window takes the tiled form: 128 blocks,
// one per (b, KV head), each with 32 of its 64 item slots empty and all
// ~10 key tiles in one block.  At W <= 4 (16 items or fewer) it takes the
// split-KV form.  The per-query mask is read per item in the softmax step
// and changes neither plan.
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py's kernel phase, L2 flushed):
// Llama self-attention 0.81 ms (a warp-per-item design took 2.53), LTSF
// cross 0.14 ms (0.42), decode over a 592-slot fp32 cache 0.048 ms (0.082),
// Q-Former self-attention at 64 frames 0.021 ms (0.043), a speculative
// window over a 600-slot fp32 cache 0.059 ms at W = 8 (tiled) and 0.049 at
// W = 4 (split-KV, 596 slots).
//
// ptxas (nvcc -Xptxas -v, sm_90a; chip_smoke.py's build phase prints it),
// with the dynamic shared memory each launch asks for, for the key-mask
// kernel (PQ false) and its per-query twin (PQ true):
//   kernel <D, TY, RPT>  registers  spill st/ld bytes  PQ: regs, spills  smem
//   tiled  <16, 16, 4>   128        28 / 40            128, 0         32 KB (40 KB roped)
//          <32, 16, 4>   128        76 / 72            128, 12 / 24   44 KB (60 KB)
//          <64, 16, 4>   128        12 / 24            128, 12 / 12   68 KB (100 KB)
//          <96, 16, 4>   202        0                  200, 0         92 KB (140 KB)
//          <128, 16, 4>  198        0                  196, 0         116 KB (180 KB)
//   few    <16, 16, 1>   120        0                  124, 0         21 KB
//          <32, 16, 1>   123        0                  126, 0         34 KB
//          <64, 16, 1>   128        12 / 36            127, 0         60 KB
//          <96, 16, 1>   156        0                  156, 0         86 KB
//          <128, 16, 1>  152        0                  151, 0         112 KB
//   wide   <1024, 16, 2> 124        0                  128, 0         108 KB
//   merge_kernel         32         0                                 0
//   bf16 wide <float>    255        0                  -              214.8 KB
//             <bf16>     233        0                  -              206.3 KB
//   decode <16>          128        0                  -              100 KB
//          <32>          141        0                  -              164 KB
//          <64>          168        0                  -              146 KB
//          <96>          255        0                  -              210 KB
//          <128>         213        0                  -              137 KB
// (the "few" rows are fp32 and fp32 Q over bf16 K and V; all-bf16 few-item
// calls take the decode form, attn_decode_kernel<D>, 16 bytes of static
// shared memory beside the dynamic; the wide row is fp32, bf16 K and V at D
// = 1024 take attn_wide_kernel<QT>, Q's type, one block an SM.)
// The spills come from the 128-register cap of two 256-thread blocks an SM.
//
// C interface (loaded with ctypes by tsue_tpu_torch/ops/flash.py):
//   flash_attn_splits(...) is the number of key splits whose partials a
//   call writes to a scratch (the caller allocates splits * B*Tq*Hq * (D +
//   2) floats when it is above 1; 1 for the wide form, whose cluster
//   merges them; pq: the call passes a per-query mask; dt: the Dtypes code,
//   0 fp32, 1 bf16, 2 fp32 Q over bf16 K and V; a per-query mask takes 0
//   only); flash_attn_form(...) names the form; flash_attn_plan(..., field)
//   reports its splits, cluster, blocks, keys a split and waves;
//   flash_attn_fwd(...) returns cudaGetLastError() after the launches (two
//   for the fp32 and widening split-KV forms, one for the others), or -1
//   for what it does not take.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 64;                 // keys per tile
constexpr int TX = 16;                 // lanes across keys / output columns
constexpr int KPT = BN / TX;           // keys per thread in S: tx + 16 j
constexpr float kNegInf = -1e30f;      // finite: fully masked rows stay finite
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kTiled = 0, kSmall = 1, kWide = 2, kDecode = 3, kWideBf16 = 4 };

template <int D, int TY, int RPT>
struct Cfg {
  static constexpr int NT = TY * TX;              // threads
  static constexpr int BM = TY * RPT;             // items per block
  static constexpr int DS = D <= 128 ? D : 128;   // head-dim slice per stage
  static constexpr int NS = D / DS;               // slices
  static constexpr bool QRES = NS == 1;           // Q stays in shared memory
  // D > 128: one key tile per block, so O lives one head-dim slice at a
  // time (written out after each V slice) instead of all D columns
  static constexpr bool ONE_TILE = NS > 1;
  static constexpr bool SPLIT = RPT != 4 || ONE_TILE;   // split-KV form
  // ring stages: the few-item form keeps two copies in flight (K and V
  // of a tile land together); the tiled form one, to fit two blocks an SM
  static constexpr int NBUF = (SPLIT && QRES) ? 3 : 2;
  static constexpr int P = DS + 4;                // padded Q / K row
  static constexpr int VEC = DS >= 64 ? 4 : DS / 16;  // O columns per step
  static constexpr int NH = DS >= 64 ? (DS + 63) / 64 : 1;
  static constexpr int Q_F = BM * P;
  static constexpr int K_F = BN * P;
  static constexpr int V_F = BN * DS;
  static constexpr int KQ_F = K_F + (QRES ? 0 : Q_F);
  static constexpr int STAGE_F = KQ_F > V_F ? KQ_F : V_F;
  static constexpr int PS = BM + 4;               // P row ([key][item])
  static constexpr int P_F = BN * PS;
  static constexpr int CS_F = BN * D;             // cos + sin of a K tile
  static constexpr int MINB = (D <= 64 || ONE_TILE) ? 2 : 1;
  static int smem(bool rope) {   // RoPE calls take the tiled form only
    return 4 * ((QRES ? Q_F : 0) + NBUF * STAGE_F + P_F +
                (rope && !SPLIT ? NBUF * CS_F : 0));
  }
};

struct Args {
  const void* q;       // QT
  const void* k;       // KT
  const void* v;       // KT
  const int* mask;     // (B, Tk), (B, Tq, Tk) or nullptr
  const float* cos;    // (B, T, D/2) or nullptr
  const float* sin;
  void* out;           // QT
  float* part;         // splits > 1: (splits, NI, D) acc then (splits, NI, 2)
  int B, Tq, Tk, Hq, Hkv, causal, splits, tps;   // tps: tiles per split
  int mq;              // the mask's query stride: 0 (key mask) or Tk
  float scale;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 sm4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 rot_lo(float4 a, float4 b, float4 c, float4 s) {
  return make_float4(a.x * c.x - b.x * s.x, a.y * c.y - b.y * s.y,
                     a.z * c.z - b.z * s.z, a.w * c.w - b.w * s.w);
}
__device__ __forceinline__ float4 rot_hi(float4 a, float4 b, float4 c, float4 s) {
  return make_float4(b.x * c.x + a.x * s.x, b.y * c.y + a.y * s.y,
                     b.z * c.z + a.z * s.z, b.w * c.w + a.w * s.w);
}

// 16-byte async copy global -> shared; with ok == false it writes zeros
// (src-size 0), so tails past Tk or past the last item are never garbage.
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

// bf16 operands: four elements (8 bytes) widened to fp32 on the way in.
using bf16 = __nv_bfloat16;
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// Four elements of a Q, K or V row into the fp32 stage: an async copy for
// fp32, a load, widening and store for bf16 (visible to the block after the
// ring's barrier, as the async copies are after their wait).
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  cp16(dst, src, ok);
}
__device__ __forceinline__ void cp4(float* dst, const bf16* src, bool ok) {
  st4(dst, ok ? ld4(src) : make_float4(0.f, 0.f, 0.f, 0.f));
}
// a value of the operand type T, as fp32: RoPE's output is rounded to its
// operand's dtype (tsue_tpu/ops/flash.py:_rope_2d), P to V's before P V
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16(x));
  return x;
}
template <typename T>
__device__ __forceinline__ float4 rnd4(float4 x) {
  return make_float4(rnd<T>(x.x), rnd<T>(x.y), rnd<T>(x.z), rnd<T>(x.w));
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put4(float* p, float4 v) { st4(p, v); }
__device__ __forceinline__ void put4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>   // all but the newest N groups of this thread landed
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// PQ: the mask is per query (mq == Tk).  A template parameter, so that the
// key-mask kernels compile to what they were before per-query masks existed
// (a runtime flag raised the tiled D = 64 kernel's spills and cost it ~10%).
// QT, KT: the element types of Q (and of the output) and of K and V, float
// or bf16; the stages, the sums and the softmax are fp32 in every case.
template <int D, int TY, int RPT, bool PQ, typename QT, typename KT>
__global__ void __launch_bounds__(Cfg<D, TY, RPT>::NT, Cfg<D, TY, RPT>::MINB)
attn_kernel(const Args a) {
  using C = Cfg<D, TY, RPT>;
  constexpr int NS = C::NS, DS = C::DS, P = C::P, VEC = C::VEC, NH = C::NH;
  constexpr int NBUF = C::NBUF;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // QRES: [BM][P]
  float* stage = qs + (C::QRES ? C::Q_F : 0);      // [NBUF][STAGE_F]
  float* ps = stage + NBUF * C::STAGE_F;           // [BN][PS]
  float* cs = ps + C::P_F;                         // rope: [NBUF][cos, sin]

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int G = a.Hq / a.Hkv, items = a.Tq * G;
  const int b = blockIdx.x / a.Hkv, hkv = blockIdx.x % a.Hkv;
  const int ib = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int i0 = ib * C::BM;
  const int split = blockIdx.z;
  const int off = a.Tk - a.Tq;
  const bool rope = a.cos != nullptr;
  const int ntiles = (a.Tk + BN - 1) / BN;
  // warps whose items all lie past the last one only copy tiles
  const bool busy = i0 + (tid / 32) * 2 * RPT < items;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  const QT* aq = static_cast<const QT*>(a.q);
  const KT* ak = static_cast<const KT*>(a.k);
  const KT* av = static_cast<const KT*>(a.v);
  auto qrow = [&](int it) {            // q row of item it (it < items)
    const int row = it / G, hq = hkv * G + it % G;
    return aq + (((size_t)b * a.Tq + row) * a.Hq + hq) * D;
  };

  if constexpr (C::QRES) {             // Q block, roped once as it loads
    if (rope) {
      constexpr int H4 = D / 8, half = D / 2;
      for (int e = tid; e < C::BM * H4; e += C::NT) {
        const int r = e / H4, d = (e % H4) * 4, it = i0 + r;
        float4 lo = zero, hi = zero;
        if (it < items) {
          const QT* qr = qrow(it);
          const size_t cr = ((size_t)b * a.Tq + it / G) * half + d;
          const float4 x1 = ld4(qr + d), x2 = ld4(qr + half + d);
          const float4 c = ld4(a.cos + cr), s = ld4(a.sin + cr);
          lo = rnd4<QT>(rot_lo(x1, x2, c, s));
          hi = rnd4<QT>(rot_hi(x1, x2, c, s));
        }
        st4(qs + r * P + d, lo);
        st4(qs + r * P + half + d, hi);
      }
    }
    // (the first barrier of run() orders these writes)
  }

  // Q block without RoPE: copied with the first stage of the ring
  auto issue_q = [&]() {
    constexpr int C4 = D / 4;
    for (int e = tid; e < C::BM * C4; e += C::NT) {
      const int r = e / C4, d = (e % C4) * 4, it = i0 + r;
      cp4(qs + r * P + d, qrow(it < items ? it : 0) + d, it < items);
    }
  };

  // Stage s of tile t: s < NS copies K slice s (with the Q slice when Q is
  // not resident, and cos/sin when roped), s >= NS copies V slice s - NS.
  auto issue = [&](int t, int s, int buf) {
    const int c0 = t * BN;
    float* dst = stage + buf * C::STAGE_F;
    constexpr int C4 = DS / 4;
    if (s < NS) {
      if (C::QRES && rope) {
        constexpr int H4 = D / 8, half = D / 2;
        float* cb = cs + buf * C::CS_F;
        for (int e = tid; e < BN * H4; e += C::NT) {
          const int j = e / H4, d = (e % H4) * 4;
          const bool ok = c0 + j < a.Tk;
          const size_t key = (size_t)b * a.Tk + (ok ? c0 + j : 0);
          const KT* kr = ak + (key * a.Hkv + hkv) * D;
          cp4(dst + j * P + d, kr + d, ok);
          cp4(dst + j * P + half + d, kr + half + d, ok);
          cp16(cb + j * half + d, a.cos + key * half + d, ok);
          cp16(cb + BN * half + j * half + d, a.sin + key * half + d, ok);
        }
      } else {
        for (int e = tid; e < BN * C4; e += C::NT) {
          const int j = e / C4, d = (e % C4) * 4;
          const bool ok = c0 + j < a.Tk;
          const size_t key = (size_t)b * a.Tk + (ok ? c0 + j : 0);
          cp4(dst + j * P + d, ak + (key * a.Hkv + hkv) * D + s * DS + d, ok);
        }
        if (!C::QRES) {
          float* qd = dst + C::K_F;
          for (int e = tid; e < C::BM * C4; e += C::NT) {
            const int r = e / C4, d = (e % C4) * 4, it = i0 + r;
            const bool ok = it < items;
            cp4(qd + r * P + d, qrow(ok ? it : 0) + s * DS + d, ok);
          }
        }
      }
    } else {
      const int sl = s - NS;
      for (int e = tid; e < BN * C4; e += C::NT) {
        const int j = e / C4, d = (e % C4) * 4;
        const bool ok = c0 + j < a.Tk;
        const size_t key = (size_t)b * a.Tk + (ok ? c0 + j : 0);
        cp4(dst + j * DS + d, av + (key * a.Hkv + hkv) * D + sl * DS + d, ok);
      }
    }
    cp_commit();
  };

  // the pairs this thread copied in issue(): rotate them in place
  auto rope_own = [&](int buf) {
    if constexpr (C::QRES) {
      constexpr int H4 = D / 8, half = D / 2;
      float* kb = stage + buf * C::STAGE_F;
      const float* cb = cs + buf * C::CS_F;
      for (int e = tid; e < BN * H4; e += C::NT) {
        const int j = e / H4, d = (e % H4) * 4;
        const float4 x1 = sm4(kb + j * P + d), x2 = sm4(kb + j * P + half + d);
        const float4 c = sm4(cb + j * half + d);
        const float4 s = sm4(cb + BN * half + j * half + d);
        st4(kb + j * P + d, rnd4<KT>(rot_lo(x1, x2, c, s)));
        st4(kb + j * P + half + d, rnd4<KT>(rot_hi(x1, x2, c, s)));
      }
    }
  };

  float o[RPT][NH][VEC];   // one head-dim slice: NS == 1 or ONE_TILE
  float m[RPT], l[RPT], sacc[RPT][KPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[i][h][e] = 0.f;
  }
  const size_t NI = (size_t)a.B * a.Tq * a.Hq;

  // O, head-dim slice sl, of the busy thread's items: to out, normalised,
  // or unnormalised to the split's partials
  auto write_slice = [&](int sl) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int it = i0 + ty * RPT + i;
      if (it >= items) continue;
      const size_t flat = ((size_t)b * a.Tq + it / G) * a.Hq + hkv * G + it % G;
      auto store = [&](auto* dst, float f) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const int col = h * 64 + tx * VEC;
          if (col >= DS) continue;
          auto* dp = dst + sl * DS + col;
          if constexpr (VEC == 4) {
            put4(dp, make_float4(o[i][h][0] * f, o[i][h][1] * f,
                                 o[i][h][2] * f, o[i][h][3] * f));
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) put(dp + e, o[i][h][e] * f);
          }
        }
      };
      if (a.splits == 1)
        store(static_cast<QT*>(a.out) + flat * D, 1.f / fmaxf(l[i], 1e-30f));
      else
        store(a.part + ((size_t)split * NI + flat) * D, 1.f);
    }
  };

  // K slice s of tile t: S += Q_s K_s^T; after the last slice, the online
  // softmax of the tile and P into shared memory.
  // a per-query mask: each item reads its own row's mask below
  constexpr bool pq = PQ;
  auto k_stage = [&](int t, int s, const float* buf) {
    const int c0 = t * BN;
    int mk[KPT];                       // -1 past Tk, 0 masked, 1 valid
    if (s == NS - 1) {
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = c0 + tx + 16 * j;
        mk[j] = key >= a.Tk ? -1
                : (a.mask == nullptr || pq ||
                   __ldg(a.mask + (size_t)b * a.Tk + key) != 0);
      }
    }
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) sacc[i][j] = 0.f;
    }
    const float* qb = C::QRES ? qs : buf + C::K_F;
#pragma unroll 8
    for (int d = 0; d < DS; d += 4) {
      float4 qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sm4(qb + (ty * RPT + i) * P + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = sm4(buf + (tx + 16 * j) * P + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          float x = sacc[i][j];
          x = fmaf(qv[i].x, kv[j].x, x);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          sacc[i][j] = fmaf(qv[i].w, kv[j].w, x);
        }
    }
    if (s != NS - 1) return;
    const bool diag = a.causal && c0 + BN - 1 > i0 / G + off;
    float p[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qrow = (i0 + ty * RPT + i) / G;
      const int last = qrow + off;                      // last visible key
      // the item's mask row (rows past the last item read the last row)
      const int* mrow =
          pq ? a.mask + ((size_t)b * a.Tq + min(qrow, a.Tq - 1)) * a.mq
             : nullptr;
      float sv[KPT], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const bool ok = mk[j] > 0 && (!diag || c0 + tx + 16 * j <= last) &&
                        (!pq || __ldg(mrow + c0 + tx + 16 * j) != 0);
        sv[j] = mk[j] < 0 ? -INFINITY : (ok ? sacc[i][j] * a.scale : kNegInf);
        mx = fmaxf(mx, sv[j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      const float mnew = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mnew);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        p[i][j] = expf(sv[j] - mnew);   // 0 past Tk (sv = -inf)
        sum += p[i][j];
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(kFull, sum, w);
      l[i] = l[i] * corr + sum;
      m[i] = mnew;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[i][h][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      float* pr = ps + (tx + 16 * j) * C::PS + ty * RPT;
      if constexpr (RPT == 4) {
        st4(pr, rnd4<KT>(make_float4(p[0][j], p[1][j], p[2][j], p[3][j])));
      } else {
#pragma unroll
        for (int i = 0; i < RPT; ++i) pr[i] = rnd<KT>(p[i][j]);
      }
    }
  };

  // V slice sl of the tile: O[:, slice] += P V_sl
  auto v_stage = [&](int sl, const float* buf) {
    if constexpr (C::ONE_TILE) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[i][h][e] = 0.f;
    }
#pragma unroll 8
    for (int j = 0; j < BN; ++j) {
      float pv[RPT];
      if constexpr (RPT == 4) {
        const float4 t4 = sm4(ps + j * C::PS + ty * 4);
        pv[0] = t4.x; pv[1] = t4.y; pv[2] = t4.z; pv[3] = t4.w;
      } else {
#pragma unroll
        for (int i = 0; i < RPT; ++i) pv[i] = ps[j * C::PS + ty * RPT + i];
      }
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const int col = h * 64 + tx * VEC;
        if (col >= DS) continue;
        float vv[VEC];
        const float* vr = buf + j * DS + col;
        if constexpr (VEC == 4) {
          const float4 t4 = sm4(vr);
          vv[0] = t4.x; vv[1] = t4.y; vv[2] = t4.z; vv[3] = t4.w;
        } else if constexpr (VEC == 2) {
          const float2 t2 = *reinterpret_cast<const float2*>(vr);
          vv[0] = t2.x; vv[1] = t2.y;
        } else {
          vv[0] = vr[0];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            o[i][h][e] = fmaf(pv[i], vv[e], o[i][h][e]);
      }
    }
    if constexpr (C::ONE_TILE) write_slice(sl);
  };

  // Tiles [t0, t1) through the ring of NBUF stage buffers, NBUF - 1
  // copies ahead.  Every thread runs it (the bounds are block-uniform);
  // warps that are not busy only copy.  Each step commits exactly one copy
  // group (empty at the end), so cp_wait<NBUF - 2> means "this stage landed".
  auto run = [&](int t0, int t1, bool with_q) {
    if (t0 >= t1) return;
    const int nst = (t1 - t0) * 2 * NS;
    auto issue_g = [&](int g) {
      if (g < nst) issue(t0 + g / (2 * NS), g % (2 * NS), g % NBUF);
      else cp_commit();
    };
    if (C::QRES && with_q) issue_q();   // joins the first stage's group
#pragma unroll
    for (int g = 0; g < NBUF - 1; ++g) issue_g(g);
    // a loop, not unrolled: with the 16 stages of D = 1024 unrolled, the
    // copies stopped overlapping the arithmetic (LTSF cross 0.245 ms, the
    // copies alone 0.096 and the arithmetic alone 0.105; as a loop 0.137),
    // most likely the instruction cache
#pragma unroll 1
    for (int g = 0; g < nst; ++g) {
      const int t = t0 + g / (2 * NS), S = g % (2 * NS), buf = g % NBUF;
      cp_wait<NBUF - 2>();
      if (S == 0 && C::QRES && rope) rope_own(buf);
      __syncthreads();     // stage g landed; stage g-1's buffer is free
      issue_g(g + NBUF - 1);
      const float* sb = stage + buf * C::STAGE_F;
      if (busy) {
        if (S < NS) k_stage(t, S, sb);
        else v_stage(S - NS, sb);
      }
    }
    __syncthreads();       // the ring and P are free for a later run()
  };

  int t0 = 0, t1 = ntiles;
  if (a.splits > 1) {
    t0 = split * a.tps;
    t1 = min(ntiles, t0 + a.tps);
  } else if (a.causal && !C::ONE_TILE) {
    const int last_row = min(a.Tq - 1, (i0 + C::BM - 1) / G);
    const int kend = max(0, min(a.Tk, last_row + off + 1));
    t1 = (kend + BN - 1) / BN;
  }
  run(t0, t1, C::QRES && !rope);
  if (a.splits == 1 && t1 < ntiles) {
    // m stays at -1e30 only for a row that saw no valid key: then every key
    // counts with weight 1, as in the reference, so run on to Tk
    int empty = 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      empty |= busy && i0 + ty * RPT + i < items && m[i] <= kNegInf;
    if (__syncthreads_or(empty)) run(t1, ntiles, false);
  }

  if (!busy) return;
  if constexpr (!C::ONE_TILE) write_slice(0);
  if (a.splits > 1 && tx == 0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int it = i0 + ty * RPT + i;
      if (it >= items) continue;
      const size_t flat = ((size_t)b * a.Tq + it / G) * a.Hq + hkv * G + it % G;
      float* ml = a.part + (size_t)a.splits * NI * D + ((size_t)split * NI + flat) * 2;
      ml[0] = m[i];
      ml[1] = l[i];
    }
  }
}

// Merge of the splits' partials, in split order: out = sum_s w_s acc_s /
// max(sum_s w_s l_s, 1e-30) with w_s = exp(m_s - max_s m_s).
template <typename OT>
__global__ void merge_kernel(const float* __restrict__ part,
                             OT* __restrict__ out, size_t NI, int D,
                             int splits) {
  const int D4 = D / 4;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NI * D4) return;
  const size_t item = i / D4;
  const int d = (int)(i % D4) * 4;
  const float* ml = part + (size_t)splits * NI * D;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, ml[((size_t)s * NI + item) * 2]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const size_t rec = (size_t)s * NI + item;
    const float w = expf(ml[rec * 2] - M);
    l = fmaf(ml[rec * 2 + 1], w, l);
    const float4 x = ld4(part + rec * D + d);
    acc.x = fmaf(x.x, w, acc.x);
    acc.y = fmaf(x.y, w, acc.y);
    acc.z = fmaf(x.z, w, acc.z);
    acc.w = fmaf(x.w, w, acc.w);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  put4(out + item * D + d, make_float4(acc.x * inv, acc.y * inv, acc.z * inv,
                                       acc.w * inv));
}

// ---- the bf16 tensor-core form ---------------------------------------------
//
// All-bf16 operands in the tiled form: QK^T and P V on the bf16 tensor
// cores (mma.sync m16n8k16, fp32 accumulators), which compute the Pallas
// function itself: bf16 operands, exact products, fp32 sums.  Block of
// kMmaWarps warps, BM = 16 kMmaWarps items; warp w owns items i0 + 16 w ..
// + 16, one m16 tile.

constexpr int kMmaWarps = 8;
constexpr int kMmaStages = 3;   // the ring: kMmaStages - 1 tiles in flight

template <int D>
struct MmaCfg {
  static constexpr int NT = 32 * kMmaWarps;
  static constexpr int BM = 16 * kMmaWarps;       // items a block
  static constexpr int P = D + 8;                 // padded bf16 row of Q, K, V
  static constexpr int KV_B = BN * P * 2;         // bytes of a K or V tile
  static constexpr int MASK_B = BN * 4;           // the tile's key mask
  static constexpr int CS_B = BN * D * 4;         // its cos and sin, fp32
  // two blocks of 8 warps an SM at D <= 64 (128 registers a thread)
  static constexpr int MINB = (D <= 64 ? 16 : 8) / kMmaWarps;
  __host__ __device__ static constexpr int stage(bool rope) {
    return 2 * KV_B + MASK_B + (rope ? CS_B : 0);
  }
  __host__ __device__ static constexpr int smem(bool rope) {
    return kMmaStages * stage(rope);
  }
};
// a row of P bf16 values is 16 * (D / 8 + 1) bytes: 8 rows of an ldmatrix
// fall on 8 distinct 16-byte bank groups; cp.async and ldmatrix want
// 16-byte aligned rows and tiles
static_assert(MmaCfg<64>::P * 2 % 16 == 0 && MmaCfg<64>::P * 2 % 128 == 16,
              "padded rows: 16-byte aligned, shifted one bank group a row");
static_assert(MmaCfg<16>::KV_B % 16 == 0 && MmaCfg<16>::BM <= 2 * BN,
              "the Q block is staged in a K and a V tile's place");
static_assert(kMmaStages >= 2 && MmaCfg<128>::smem(true) <= 232448,
              "the ring fits in a block's shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4-byte async copy (zeros with ok == false)
__device__ __forceinline__ void cp4b(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += a (16 x 16, row) b (16 x 8, col), bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// Eight bf16 values (16 bytes) rotated as rot_lo / rot_hi do, rounded to
// bf16: (x1, x2) the pair's halves, c and s their eight cos and sin.
__device__ __forceinline__ void rope8(uint4& x1, uint4& x2, const float* c,
                                      const float* s) {
  const bf16* a = reinterpret_cast<const bf16*>(&x1);
  const bf16* b = reinterpret_cast<const bf16*>(&x2);
  uint4 lo, hi;
  uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
  uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float rl[2], rh[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float x = __bfloat162float(a[2 * i + e]);
      const float y = __bfloat162float(b[2 * i + e]);
      const float cc = c[2 * i + e], ss = s[2 * i + e];
      rl[e] = x * cc - y * ss;
      rh[e] = y * cc + x * ss;
    }
    l[i] = pack_bf16(rl[0], rl[1]);
    h[i] = pack_bf16(rh[0], rh[1]);
  }
  x1 = lo;
  x2 = hi;
}

template <int D>
__global__ void __launch_bounds__(MmaCfg<D>::NT, MmaCfg<D>::MINB)
attn_mma_kernel(const Args a) {
  using C = MmaCfg<D>;
  constexpr int P = C::P, KC = D / 16, ND = D / 8, half = D / 2;
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int G = a.Hq / a.Hkv, items = a.Tq * G;
  const int b = blockIdx.x / a.Hkv, hkv = blockIdx.x % a.Hkv;
  const int ib = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int i0 = ib * C::BM;
  const int off = a.Tk - a.Tq;
  const bool rope = a.cos != nullptr;
  const int stage_b = C::stage(rope);
  const int ntiles = (a.Tk + BN - 1) / BN;
  const bool busy = i0 + warp * 16 < items;   // else the warp only copies
  const bf16* aq = static_cast<const bf16*>(a.q);
  const bf16* ak = static_cast<const bf16*>(a.k);
  const bf16* av = static_cast<const bf16*>(a.v);
  auto kbuf = [&](int buf) { return reinterpret_cast<bf16*>(sm + buf * stage_b); };
  auto vbuf = [&](int buf) { return kbuf(buf) + BN * P; };
  auto mbuf = [&](int buf) {
    return reinterpret_cast<int*>(sm + buf * stage_b + 2 * C::KV_B);
  };
  auto cbuf = [&](int buf) {   // cos [BN][half], then sin [BN][half]
    return reinterpret_cast<float*>(sm + buf * stage_b + 2 * C::KV_B +
                                    C::MASK_B);
  };

  // tile t into buffer buf: K (with cos and sin when roped), V and the key
  // mask, 16-byte cp.async (4 bytes for the mask); rows past Tk are zeros
  auto issue = [&](int t, int buf) {
    const int c0 = t * BN;
    bf16* kd = kbuf(buf);
    bf16* vd = vbuf(buf);
    constexpr int C8 = D / 8, H8 = D / 16;
    if (rope) {
      float* cd = cbuf(buf);
      float* sd = cd + BN * half;
      for (int e = tid; e < BN * H8; e += C::NT) {
        const int j = e / H8, d = (e % H8) * 8;
        const bool ok = c0 + j < a.Tk;
        const size_t key = (size_t)b * a.Tk + (ok ? c0 + j : 0);
        const bf16* kr = ak + (key * a.Hkv + hkv) * D;
        cp16(reinterpret_cast<float*>(kd + j * P + d),
             reinterpret_cast<const float*>(kr + d), ok);
        cp16(reinterpret_cast<float*>(kd + j * P + half + d),
             reinterpret_cast<const float*>(kr + half + d), ok);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          cp16(cd + j * half + d + 4 * i, a.cos + key * half + d + 4 * i, ok);
          cp16(sd + j * half + d + 4 * i, a.sin + key * half + d + 4 * i, ok);
        }
      }
    } else {
      for (int e = tid; e < BN * C8; e += C::NT) {
        const int j = e / C8, d = (e % C8) * 8;
        const bool ok = c0 + j < a.Tk;
        const size_t key = (size_t)b * a.Tk + (ok ? c0 + j : 0);
        cp16(reinterpret_cast<float*>(kd + j * P + d),
             reinterpret_cast<const float*>(ak + (key * a.Hkv + hkv) * D + d),
             ok);
      }
    }
    for (int e = tid; e < BN * C8; e += C::NT) {
      const int j = e / C8, d = (e % C8) * 8;
      const bool ok = c0 + j < a.Tk;
      const size_t key = (size_t)b * a.Tk + (ok ? c0 + j : 0);
      cp16(reinterpret_cast<float*>(vd + j * P + d),
           reinterpret_cast<const float*>(av + (key * a.Hkv + hkv) * D + d),
           ok);
    }
    if (a.mask != nullptr) {
      int* md = mbuf(buf);
      for (int j = tid; j < BN; j += C::NT) {
        const bool ok = c0 + j < a.Tk;
        cp4b(md + j, a.mask + (size_t)b * a.Tk + (ok ? c0 + j : 0), ok);
      }
    }
    cp_commit();
  };
  // the K pairs this thread copied in issue(), rotated in place and rounded
  auto rope_own = [&](int buf) {
    constexpr int H8 = D / 16;
    bf16* kd = kbuf(buf);
    const float* cd = cbuf(buf);
    const float* sd = cd + BN * half;
    for (int e = tid; e < BN * H8; e += C::NT) {
      const int j = e / H8, d = (e % H8) * 8;
      uint4* p1 = reinterpret_cast<uint4*>(kd + j * P + d);
      uint4* p2 = reinterpret_cast<uint4*>(kd + j * P + half + d);
      uint4 x1 = *p1, x2 = *p2;
      rope8(x1, x2, cd + j * half + d, sd + j * half + d);
      *p1 = x1;
      *p2 = x2;
    }
  };

  int t1 = ntiles;
  if (a.causal) {
    const int last_row = min(a.Tq - 1, (i0 + C::BM - 1) / G);
    const int kend = max(0, min(a.Tk, last_row + off + 1));
    t1 = (kend + BN - 1) / BN;
  }
  // the first kMmaStages - 1 tiles of [t0, t1) into buffers 0 ..; one copy
  // group each (empty past t1)
  auto prime = [&](int t0, int t1) {
#pragma unroll
    for (int i = 0; i < kMmaStages - 1; ++i) {
      if (t0 + i < t1) issue(t0 + i, i);
      else cp_commit();
    }
  };
  prime(0, t1);              // in flight while the Q block loads

  // The Q block, roped and rounded to bf16 as it loads, into the last
  // buffer's K and V tiles (free until tile kMmaStages - 1 is issued)
  {
    bf16* qs = kbuf(kMmaStages - 1);
    constexpr int C8 = D / 8, H8 = D / 16;
    const int per = rope ? H8 : C8;
    for (int e = tid; e < C::BM * per; e += C::NT) {
      const int r = e / per, d = (e % per) * 8, it = i0 + r;
      uint4 x1 = make_uint4(0u, 0u, 0u, 0u), x2 = x1;
      if (it < items) {
        const bf16* qr =
            aq + (((size_t)b * a.Tq + it / G) * a.Hq + hkv * G + it % G) * D;
        x1 = __ldg(reinterpret_cast<const uint4*>(qr + d));
        if (rope) {
          x2 = __ldg(reinterpret_cast<const uint4*>(qr + half + d));
          const size_t cr = ((size_t)b * a.Tq + it / G) * half + d;
          float c[8], sn[8];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float4 cv = ld4(a.cos + cr + 4 * i), sv = ld4(a.sin + cr + 4 * i);
            c[4 * i] = cv.x; c[4 * i + 1] = cv.y; c[4 * i + 2] = cv.z; c[4 * i + 3] = cv.w;
            sn[4 * i] = sv.x; sn[4 * i + 1] = sv.y; sn[4 * i + 2] = sv.z; sn[4 * i + 3] = sv.w;
          }
          rope8(x1, x2, c, sn);
        }
      }
      *reinterpret_cast<uint4*>(qs + r * P + d) = x1;
      if (rope) *reinterpret_cast<uint4*>(qs + r * P + half + d) = x2;
    }
  }

  uint32_t qf[KC][4];       // the warp's Q rows: A fragments of Q K^T
  float o[ND][4];           // O: n8 column tile n, rows g8 (e < 2), g8 + 8
  float m[2], l[2];         // rows g8, g8 + 8 (l: this thread's share)
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;

  // S = Q K^T of tile t, its online softmax, O += P V
  auto compute = [&](int t, int buf) {
    const int c0 = t * BN;
    const bf16* kd = kbuf(buf);
    const bf16* vd = vbuf(buf);
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {   // n8 key tiles 2 jp, 2 jp + 1
        uint32_t kb[4];
        ldsm4(kb, kd + (16 * jp + 8 * (mat >> 1) + r8) * P + 16 * kc +
                      8 * (mat & 1));
        mma_bf16(s[2 * jp], qf[kc], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qf[kc], kb[2], kb[3]);
      }
    }
    const bool diag = a.causal && c0 + BN - 1 > i0 / G + off;
    const int* md = mbuf(buf);
    bool in[8][2], kok[8][2];   // the thread's keys: below Tk; unmasked
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = 8 * j + 2 * t4 + e;
        in[j][e] = c0 + kl < a.Tk;
        kok[j][e] = a.mask == nullptr || md[kl] != 0;
      }
    uint32_t pa[4][4];      // P, rounded to bf16: A fragments of P V
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int it = i0 + warp * 16 + g8 + 8 * rr;
      const int last = it / G + off;                    // last visible key
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok =
              kok[j][e] && (!diag || c0 + 8 * j + 2 * t4 + e <= last);
          float& x = s[j][2 * rr + e];
          x = !in[j][e] ? -INFINITY : (ok ? x * a.scale : kNegInf);
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float mnew = fmaxf(m[rr], mx);
      const float corr = exp2f((m[rr] - mnew) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * rr + e];
          x = exp2f((x - mnew) * kLog2e);    // 0 past Tk (x = -inf)
          sum += x;
        }
      l[rr] = l[rr] * corr + sum;
      m[rr] = mnew;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * rr] *= corr;
        o[n][2 * rr + 1] *= corr;
      }
    }
    // the S accumulators of key tiles 2c, 2c + 1 are the A fragment of
    // keys 16c .. 16c + 15
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pa[c][0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
      pa[c][1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
      pa[c][2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
      pa[c][3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {   // n8 column tiles 2 np, + 1
        uint32_t vb[4];
        ldsm4t(vb, vd + (16 * c + 8 * (mat & 1) + r8) * P + 16 * np +
                       8 * (mat >> 1));
        mma_bf16(o[2 * np], pa[c], vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa[c], vb[2], vb[3]);
      }
    }
  };

  // tiles [t0, t1) through the ring, kMmaStages - 1 copies ahead (primed),
  // tile t0 landed in buffer 0 and roped; every thread runs it (the bounds
  // are block-uniform).  Each step commits one copy group, so
  // cp_wait<kMmaStages - 2> means "tile t + 1 landed".
  auto run = [&](int t0, int t1) {
#pragma unroll 1
    for (int t = t0; t < t1; ++t) {
      const int i = t - t0, buf = i % kMmaStages;
      if (t + kMmaStages - 1 < t1)
        issue(t + kMmaStages - 1, (i + kMmaStages - 1) % kMmaStages);
      else
        cp_commit();
      if (busy) compute(t, buf);
      cp_wait<kMmaStages - 2>();
      if (rope && t + 1 < t1) rope_own((i + 1) % kMmaStages);
      __syncthreads();     // tile t + 1 landed; buffer buf is free
    }
  };

  cp_wait<kMmaStages - 2>();
  if (rope && t1 > 0) rope_own(0);
  __syncthreads();         // the Q block and tile 0 landed
  {
    const bf16* qs = kbuf(kMmaStages - 1);
    const int mat = lane >> 3;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      ldsm4(qf[kc], qs + (warp * 16 + 8 * (mat & 1) + (lane & 7)) * P +
                        16 * kc + 8 * (mat >> 1));
  }
  __syncthreads();         // buffer 1 is free for the ring
  run(0, t1);
  if (t1 < ntiles) {
    // m stays at -1e30 only for a row that saw no valid key: then every key
    // counts with weight 1, as in the reference, so run on to Tk
    int empty = 0;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      empty |= busy && i0 + warp * 16 + g8 + 8 * rr < items && m[rr] <= kNegInf;
    if (__syncthreads_or(empty)) {
      cp_wait<0>();
      prime(t1, ntiles);
      cp_wait<kMmaStages - 2>();
      if (rope) rope_own(0);
      __syncthreads();
      run(t1, ntiles);
    }
  }
  if (!busy) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const int it = i0 + warp * 16 + g8 + 8 * rr;
    if (it >= items) continue;
    const float f = 1.f / fmaxf(lt, 1e-30f);
    bf16* orow = static_cast<bf16*>(a.out) +
                 (((size_t)b * a.Tq + it / G) * a.Hq + hkv * G + it % G) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t4) =
          pack_bf16(o[n][2 * rr] * f, o[n][2 * rr + 1] * f);
  }
}

template <int D>
struct MmaKern {
  using C = MmaCfg<D>;
  static constexpr int BM = C::BM;
  static int per_sm() {
    static int n = -1;
    if (n < 0) {
      if (cudaFuncSetAttribute(attn_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::smem(true)) != cudaSuccess)
        return 0;
      int k = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &k, attn_mma_kernel<D>, C::NT, C::smem(false)) != cudaSuccess)
        return 0;
      n = k;
    }
    return n;
  }
  static void launch(const Args& a, dim3 grid, bool rope, cudaStream_t st) {
    attn_mma_kernel<D><<<grid, C::NT, C::smem(rope), st>>>(a);
  }
};

// ---- the bf16 decode form --------------------------------------------------
//
// All-bf16 operands, at most 16 items per (b, KV head), no RoPE (the decode
// step): one block per (b, KV head, key split) of kDecWarps warps.  The
// block's items are one m16 tile, held by every warp as A fragments; warp w
// takes the split's key tiles w, w + kDecWarps, .. through a ring of its own
// (no block barrier in the key walk) and runs QK^T and P V on mma.sync as
// attn_mma_kernel does.  The warps merge in the block in warp order; with
// several splits each block writes its partials and the block that takes
// its (b, KV head)'s last ticket merges them in split order (one launch).

constexpr int kDecWarps = 4;
// (b, KV head) pairs a launch can merge: one ticket each, zero at load;
// the merging block resets its own, so every call finds them at zero.
// Calls share them, so split launches of this form run on one stream.
constexpr int kDecTickets = 1 << 16;
__device__ unsigned int g_dec_tickets[kDecTickets];

template <int D>
struct DecCfg {
  static constexpr int NT = 32 * kDecWarps;
  static constexpr int BM = 16;                   // items a block: one m16 tile
  static constexpr int P = D + 8;                 // padded bf16 row, as MmaCfg
  static constexpr int KV_B = BN * P * 2;         // bytes of a K or V tile
  static constexpr int TILE_B = 2 * KV_B + BN * 4;   // K, V, the key mask
  // tiles a warp keeps in flight: as many as fit beside the other warps'
  static constexpr int NBW = D <= 32 ? 4 : (D <= 96 ? 2 : 1);
  // the warps' (O, m, l) for the merge, in the ring's place
  static constexpr int RED_B = kDecWarps * BM * (D + 2) * 4;
  __host__ __device__ static constexpr int smem() {
    return kDecWarps * NBW * TILE_B > RED_B ? kDecWarps * NBW * TILE_B : RED_B;
  }
};
static_assert(DecCfg<16>::TILE_B % 16 == 0 && DecCfg<96>::TILE_B % 16 == 0,
              "each tile starts 16-byte aligned (cp.async, ldmatrix)");
static_assert(DecCfg<16>::smem() <= 232448 && DecCfg<32>::smem() <= 232448 &&
                  DecCfg<64>::smem() <= 232448 && DecCfg<96>::smem() <= 232448 &&
                  DecCfg<128>::smem() <= 232448,
              "the warps' rings fit in a block's shared memory");
static_assert(BN == 64 && DecCfg<64>::BM == 16,
              "a tile is four k16 chunks of P V; the items one m16 tile");

// The decode form's step over one key tile, for the block's m16 tile of
// items (Q as A fragments qf): S = Q K^T from the bf16 tile kd, its online
// softmax into (m, l) over the tile's keys c0 .. c0 + 63 (below Tk;
// unmasked in md when the call has a mask; causal), P rounded to bf16 from
// the S registers, O += P V from vd.  It repeats attn_mma_kernel's compute
// step: called from that kernel too, it changed its register allocation
// (attn_mma_kernel<96> spilled 24 / 40 bytes, the Llama shape ~1% slower
// in flash_variants.py, the same bits).
template <int D>
__device__ __forceinline__ void dec_tile(const Args& a,
                                         const uint32_t (&qf)[D / 16][4],
                                         const bf16* kd, const bf16* vd,
                                         const int* md, int c0,
                                         float (&o)[D / 8][4],
                                         float (&m)[2], float (&l)[2]) {
  constexpr int P = D + 8, KC = D / 16, ND = D / 8;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int mat = lane >> 3, r8 = lane & 7;
  const int G = a.Hq / a.Hkv, off = a.Tk - a.Tq;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {   // n8 key tiles 2 jp, 2 jp + 1
      uint32_t kb[4];
      ldsm4(kb, kd + (16 * jp + 8 * (mat >> 1) + r8) * P + 16 * kc +
                      8 * (mat & 1));
      mma_bf16(s[2 * jp], qf[kc], kb[0], kb[1]);
      mma_bf16(s[2 * jp + 1], qf[kc], kb[2], kb[3]);
    }
  }
  bool in[8][2], kok[8][2];   // the thread's keys: below Tk; unmasked
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kl = 8 * j + 2 * t4 + e;
      in[j][e] = c0 + kl < a.Tk;
      kok[j][e] = a.mask == nullptr || md[kl] != 0;
    }
  uint32_t pa[4][4];      // P, rounded to bf16: A fragments of P V
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int last = (g8 + 8 * rr) / G + off;        // last visible key
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok =
            kok[j][e] && (!a.causal || c0 + 8 * j + 2 * t4 + e <= last);
        float& x = s[j][2 * rr + e];
        x = !in[j][e] ? -INFINITY : (ok ? x * a.scale : kNegInf);
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float mnew = fmaxf(m[rr], mx);
    const float corr = exp2f((m[rr] - mnew) * kLog2e);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * rr + e];
        x = exp2f((x - mnew) * kLog2e);    // 0 past Tk (x = -inf)
        sum += x;
      }
    l[rr] = l[rr] * corr + sum;
    m[rr] = mnew;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][2 * rr] *= corr;
      o[n][2 * rr + 1] *= corr;
    }
  }
  // the S accumulators of key tiles 2c, 2c + 1 are the A fragment of
  // keys 16c .. 16c + 15
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    pa[c][0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
    pa[c][1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
    pa[c][2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
    pa[c][3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int np = 0; np < ND / 2; ++np) {   // n8 column tiles 2 np, + 1
      uint32_t vb[4];
      ldsm4t(vb, vd + (16 * c + 8 * (mat & 1) + r8) * P + 16 * np +
                       8 * (mat >> 1));
      mma_bf16(o[2 * np], pa[c], vb[0], vb[1]);
      mma_bf16(o[2 * np + 1], pa[c], vb[2], vb[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DecCfg<D>::NT, 1)
attn_decode_kernel(const Args a) {
  using C = DecCfg<D>;
  constexpr int P = C::P, KC = D / 16, ND = D / 8, NBW = C::NBW, C8 = D / 8;
  extern __shared__ float4 smem4[];
  __shared__ int merger;
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int G = a.Hq / a.Hkv, items = a.Tq * G;
  const int b = blockIdx.x / a.Hkv, hkv = blockIdx.x % a.Hkv;
  const int split = blockIdx.z;
  const int ntiles = (a.Tk + BN - 1) / BN;
  const int t0 = split * a.tps, t1 = min(ntiles, t0 + a.tps);
  // this warp's tiles: t0 + warp + kDecWarps i, i < nt
  const int nt = t1 - t0 > warp ? (t1 - t0 - warp + kDecWarps - 1) / kDecWarps : 0;
  const bf16* ak = static_cast<const bf16*>(a.k);
  const bf16* av = static_cast<const bf16*>(a.v);
  uint8_t* ring = sm + warp * NBW * C::TILE_B;
  auto kbuf = [&](int i) { return reinterpret_cast<bf16*>(ring + i % NBW * C::TILE_B); };
  auto vbuf = [&](int i) { return kbuf(i) + BN * P; };
  auto mbuf = [&](int i) {
    return reinterpret_cast<int*>(ring + i % NBW * C::TILE_B + 2 * C::KV_B);
  };

  // the warp's i-th tile into its buffer i % NBW: K and V by 16-byte
  // cp.async, the key mask by 4-byte ones; rows past Tk are zeros.  One
  // copy group each (empty past nt).
  auto issue = [&](int i) {
    if (i < nt) {
      const int c0 = (t0 + warp + kDecWarps * i) * BN;
      bf16* kd = kbuf(i);
      bf16* vd = vbuf(i);
#pragma unroll
      for (int n = 0; n < BN * C8 / 32; ++n) {
        const int e = lane + 32 * n, j = e / C8, d = (e % C8) * 8;
        const bool ok = c0 + j < a.Tk;
        const size_t row = ((size_t)b * a.Tk + (ok ? c0 + j : 0)) * a.Hkv + hkv;
        cp16(reinterpret_cast<float*>(kd + j * P + d),
             reinterpret_cast<const float*>(ak + row * D + d), ok);
        cp16(reinterpret_cast<float*>(vd + j * P + d),
             reinterpret_cast<const float*>(av + row * D + d), ok);
      }
      if (a.mask != nullptr) {
        int* md = mbuf(i);
#pragma unroll
        for (int j = lane; j < BN; j += 32) {
          const bool ok = c0 + j < a.Tk;
          cp4b(md + j, a.mask + (size_t)b * a.Tk + (ok ? c0 + j : 0), ok);
        }
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int i = 0; i < NBW; ++i) issue(i);   // in flight while Q loads

  // the items' Q rows as A fragments, straight from device memory: items
  // g8 and g8 + 8, columns 2 t4 (+ 8) of each k16 chunk; zeros past items
  uint32_t qf[KC][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int it = g8 + 8 * h;
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        static_cast<const bf16*>(a.q) +
        (((size_t)b * a.Tq + min(it, items - 1) / G) * a.Hq + hkv * G +
         min(it, items - 1) % G) * D + 2 * t4);
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        qf[kc][h + 2 * c] = it < items ? __ldg(qr + 8 * kc + 4 * c) : 0u;
  }

  float o[ND][4];           // O: n8 column tile n, rows g8 (e < 2), g8 + 8
  float m[2], l[2];         // rows g8, g8 + 8 (l: this thread's share)
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;

  // S = Q K^T of the warp's i-th tile, its online softmax, O += P V
  auto compute = [&](int i) {
    dec_tile<D>(a, qf, kbuf(i), vbuf(i), mbuf(i),
                (t0 + warp + kDecWarps * i) * BN, o, m, l);
  };

  // the warp's ring: NBW tiles in flight; tile i landed once all but the
  // newest NBW - 1 copy groups have (one group a step)
#pragma unroll 1
  for (int i = 0; i < nt; ++i) {
    cp_wait<NBW - 1>();
    __syncwarp();           // every lane's copies of tile i are visible
    compute(i);
    __syncwarp();           // every lane is done with buffer i % NBW
    issue(i + NBW);
  }
  cp_wait<0>();
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(kFull, l[rr], 1);
    l[rr] += __shfl_xor_sync(kFull, l[rr], 2);
  }

  // the warps' (O, m, l) into shared memory, in the rings' place
  float* red = reinterpret_cast<float*>(sm);        // [warp][BM][D]
  float* rml = red + kDecWarps * C::BM * D;         // [warp][BM][m, l]
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = warp * C::BM + g8 + 8 * rr;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(red + r * D + 8 * n + 2 * t4) =
          make_float2(o[n][2 * rr], o[n][2 * rr + 1]);
    if (t4 == 0) {
      rml[2 * r] = m[rr];
      rml[2 * r + 1] = l[rr];
    }
  }
  __syncthreads();

  // the block's result, the warps merged in warp order: out (one split) or
  // the split's unnormalised (acc, m, l)
  const size_t NI = (size_t)a.B * a.Tq * a.Hq;
  constexpr int D4 = D / 4;
  auto flat = [&](int r) {
    return ((size_t)b * a.Tq + r / G) * a.Hq + hkv * G + r % G;
  };
  for (int e = tid; e < items * D4; e += C::NT) {
    const int r = e / D4, d = (e % D4) * 4;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, rml[2 * (w * C::BM + r)]);
    float lw = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const int rw = w * C::BM + r;
      const float wt = exp2f((rml[2 * rw] - M) * kLog2e);
      lw = fmaf(rml[2 * rw + 1], wt, lw);
      const float4 x = sm4(red + rw * D + d);
      acc.x = fmaf(x.x, wt, acc.x);
      acc.y = fmaf(x.y, wt, acc.y);
      acc.z = fmaf(x.z, wt, acc.z);
      acc.w = fmaf(x.w, wt, acc.w);
    }
    if (a.splits == 1) {
      const float inv = 1.f / fmaxf(lw, 1e-30f);
      put4(static_cast<bf16*>(a.out) + flat(r) * D + d,
           make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
    } else {
      const size_t rec = (size_t)split * NI + flat(r);
      st4(a.part + rec * D + d, acc);
      if (d == 0) {
        float* ml = a.part + (size_t)a.splits * NI * D + rec * 2;
        ml[0] = M;
        ml[1] = lw;
      }
    }
  }
  if (a.splits == 1) return;

  // the last block of the (b, KV head) merges every split's partials in
  // split order (a repeated call bit-identical whichever block is last)
  __threadfence();          // this block's partials, visible to the merger
  __syncthreads();
  if (tid == 0)
    merger = atomicAdd(&g_dec_tickets[blockIdx.x], 1u) == (unsigned)a.splits - 1;
  __syncthreads();
  if (!merger) return;
  __threadfence();
  const float* mls = a.part + (size_t)a.splits * NI * D;
  for (int e = tid; e < items * D4; e += C::NT) {
    const int r = e / D4, d = (e % D4) * 4;
    const size_t it = flat(r);
    float M = -INFINITY;
    for (int s = 0; s < a.splits; ++s)
      M = fmaxf(M, __ldcg(mls + ((size_t)s * NI + it) * 2));
    float lw = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < a.splits; ++s) {
      const size_t rec = (size_t)s * NI + it;
      const float wt = exp2f((__ldcg(mls + rec * 2) - M) * kLog2e);
      lw = fmaf(__ldcg(mls + rec * 2 + 1), wt, lw);
      const float4 x = __ldcg(reinterpret_cast<const float4*>(a.part + rec * D + d));
      acc.x = fmaf(x.x, wt, acc.x);
      acc.y = fmaf(x.y, wt, acc.y);
      acc.z = fmaf(x.z, wt, acc.z);
      acc.w = fmaf(x.w, wt, acc.w);
    }
    const float inv = 1.f / fmaxf(lw, 1e-30f);
    put4(static_cast<bf16*>(a.out) + it * D + d,
         make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
  }
  if (tid == 0) g_dec_tickets[blockIdx.x] = 0u;   // for the next call
}

template <int D>
struct DecKern {
  using C = DecCfg<D>;
  static constexpr int BM = C::BM;
  static int per_sm() {
    static int n = -1;
    if (n < 0) {
      if (cudaFuncSetAttribute(attn_decode_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::smem()) != cudaSuccess)
        return 0;
      int k = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &k, attn_decode_kernel<D>, C::NT, C::smem()) != cudaSuccess)
        return 0;
      n = k;
    }
    return n;
  }
  static void launch(const Args& a, dim3 grid, bool, cudaStream_t st) {
    attn_decode_kernel<D><<<grid, C::NT, C::smem(), st>>>(a);
  }
};

// ---- the bf16 wide form ----------------------------------------------------
//
// D = 1024 with bf16 K and V, Q fp32 or bf16, a key mask or none (the LTSF
// cross-attention of a bf16 model): a thread block cluster per (b, KV
// head, block of kWideBM items), one CTA of kWideWarps warps per key split.
// Warp w owns head-dim columns 128 w .. 128 w + 127 of every product:
//   - S^T = K Q^T of a 16-key tile: m16n8k16 bf16 mma.sync with the keys as
//     m and the items as n (three n8 tiles hold up to 24 items), A = K by
//     ldmatrix from the bf16 tile, B = Q^T built from the fp32 Q rows in
//     shared memory: an fp32 q split into hi + mid + lo bf16 terms (exact,
//     as int8_matmul.cu splits x), a bf16 q one term; each warp's partial
//     sum over its 128 columns goes to shared memory and the softmax
//     threads (8 a item, 2 keys each) add the 8 partials in warp order;
//   - the online softmax in fp32, P rounded to bf16 into shared memory;
//   - O^T += V^T P^T: A = V^T by ldmatrix.trans, B = P^T by ldmatrix, the
//     warp's O^T (128 columns x 24 items, fp32) in registers;
//   - K and V tiles stay bf16 from device memory to the tensor cores: 16-
//     byte cp.async into a ring of half-tiles (a tile's K, then its V; 4
//     for an fp32 q, 6 for a bf16 q), all but one in flight;
//   - the cluster's CTAs leave their (O, m, l) in shared memory; after a
//     cluster barrier rank r merges a share of the outputs over all ranks
//     in rank order through distributed shared memory: one launch, no
//     scratch, a repeated call bit-identical.

constexpr int kWideD = 1024;
constexpr int kWideWarps = 8;
constexpr int kWideBM = 18;           // items a block (the LTSF's 18 queries)
constexpr int kWideKeys = 16;         // keys a tile: one m16 of S^T, one k16 of P V
constexpr int kWideMaxCluster = 8;    // portable cluster size: key splits

template <typename QT>
struct WideCfg {
  static constexpr int NTERM = sizeof(QT) == 4 ? 3 : 1;   // Q's bf16 terms
  static constexpr int NT = 32 * kWideWarps;
  static constexpr int DW = kWideD / kWideWarps;      // columns a warp
  static constexpr int NJ = 3;                        // n8 item tiles
  static constexpr int KP = kWideD + 8;               // padded bf16 K / V row
  static constexpr int KV_B = kWideKeys * KP * 2;     // a K or V tile
  static constexpr int HALF_B = KV_B + kWideKeys * 4; // + the key mask (K's)
  // half-tiles in the ring: as many as fit beside the terms of Q that stay
  // in shared memory (mid and lo of an fp32 q; the hi term is in registers)
  static constexpr int BUFS = NTERM == 3 ? 4 : 6;
  static constexpr int RING_B = BUFS * HALF_B;
  static constexpr int QW = kWideD / 2 + 8;           // a Q term's row, words
  static constexpr int Q_B = (NTERM - 1) * kWideBM * QW * 4;
  static constexpr int RS = kWideKeys + 4;            // a partial S row
  static constexpr int SP_B = kWideWarps * kWideBM * RS * 4;
  static constexpr int PP = kWideKeys + 8;            // bf16 P row
  static constexpr int P_B = 8 * NJ * PP * 2;
  static constexpr int OS = kWideD + 4;               // fp32 O row, merge
  static constexpr int SMEM = RING_B + Q_B + SP_B + P_B + 8 * NJ * 4;
};
using WideF = WideCfg<float>;
static_assert(WideF::DW == 128 && kWideKeys == 16,
              "a warp's columns are 8 m16 tiles of O^T and 8 k16 chunks of S^T;"
              " a tile is one m16 of S^T and one k16 of P V");
static_assert(kWideBM <= 8 * WideF::NJ && kWideBM * 8 <= WideF::NT,
              "the items fit the n8 tiles; 8 softmax threads an item");
static_assert(WideF::KP * 2 % 128 == 16 && WideF::PP * 2 % 16 == 0 &&
                  WideF::KV_B % 16 == 0 && WideF::HALF_B % 16 == 0,
              "ldmatrix rows 16-byte aligned, K / V rows one bank group apart");
static_assert(WideF::QW * 4 % 128 == 32 && WideF::Q_B % 16 == 0,
              "four Q rows of a half warp's 8-byte loads in distinct banks");
static_assert(kWideD / 4 == WideF::NT,
              "the merge: a thread a 4-column group of every row");
static_assert(WideF::RS % 32 == 20 && WideF::OS % 32 == 4,
              "partial S and O stores of a warp in 32 distinct banks");
static_assert(kWideBM * WideF::OS * 4 <= WideF::RING_B &&
                  (3 + kWideMaxCluster) * kWideBM * 4 <= WideF::SP_B,
              "the merge's O in the ring's place; (m, l), the ranks' weights "
              "and 1 / l in the partials'");
static_assert(kWideKeys * kWideD / 8 % WideF::NT == 0 && WideF::BUFS >= 3 &&
                  WideCfg<bf16>::BUFS >= 3,
              "whole 16-byte copies a thread; K and V of a tile in flight");
static_assert(WideF::SMEM <= 232448 && WideCfg<bf16>::SMEM <= 232448,
              "one block an SM");

// K and V are read once: their lines are the first L2 evicts (the lines
// the call's misses displace are then its own, not other data, dirty data
// included, which would cost a write-back)
__device__ __forceinline__ uint64_t stream_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
// 16-byte async copy with an L2 policy (zeros with ok == false)
__device__ __forceinline__ void cp16_policy(void* dst, const void* src,
                                            bool ok, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(ok ? 16 : 0), "l"(policy));
}
__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
// Two fp32 values -> three bf16x2 terms (low half the first value), by
// truncation: a = hi + mid + lo exactly (int8_matmul.cu's split).
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const uint32_t ha = __float_as_uint(a) & 0xffff0000u;
  const uint32_t hb = __float_as_uint(b) & 0xffff0000u;
  const float ra = a - __uint_as_float(ha), rb = b - __uint_as_float(hb);
  const uint32_t ma = __float_as_uint(ra) & 0xffff0000u;
  const uint32_t mb = __float_as_uint(rb) & 0xffff0000u;
  const float sa = ra - __uint_as_float(ma), sb = rb - __uint_as_float(mb);
  hi = __byte_perm(ha, hb, 0x7632);
  mid = __byte_perm(ma, mb, 0x7632);
  lo = __byte_perm(__float_as_uint(sa), __float_as_uint(sb), 0x7632);
}
// Two adjacent q values, loaded, then as bf16x2 terms (low half the
// first): hi, mid, lo of fp32 values; a bf16 pair as it lies (one term)
template <typename QT>
struct QPair;
template <>
struct QPair<float> {
  using T = float2;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ void terms(T x, uint32_t (&w)[3]) {
    split3(x.x, x.y, w[0], w[1], w[2]);
  }
};
template <>
struct QPair<bf16> {
  using T = unsigned int;
  static __device__ __forceinline__ T load(const bf16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ void terms(T x, uint32_t (&w)[3]) {
    w[0] = x;
    w[1] = w[2] = 0u;
  }
};

template <typename QT>
__global__ void __launch_bounds__(WideCfg<QT>::NT, 1)
attn_wide_kernel(const Args a) {
  using C = WideCfg<QT>;
  constexpr int NTERM = C::NTERM, NB = C::BUFS;
  constexpr int BM = kWideBM, KEYS = kWideKeys, NJ = C::NJ, DW = C::DW;
  constexpr int KP = C::KP, QW = C::QW, RS = C::RS, PP = C::PP, OS = C::OS;
  constexpr int C8 = kWideD / 8;            // 16-byte chunks of a bf16 row
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  uint32_t* qt = reinterpret_cast<uint32_t*>(sm + C::RING_B);  // [term-1][BM][QW]
  float* sp = reinterpret_cast<float*>(qt + (NTERM - 1) * BM * QW);  // [warp][BM][RS]
  bf16* ps = reinterpret_cast<bf16*>(sp + kWideWarps * BM * RS);   // [24][PP]
  float* corr_s = reinterpret_cast<float*>(ps + 8 * NJ * PP);      // [24]

  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3, mat = lane >> 3, r8 = lane & 7;
  const int G = a.Hq / a.Hkv, items = a.Tq * G;
  const int pair = blockIdx.x / nc;
  const int b = pair / a.Hkv, hkv = pair % a.Hkv;
  const int i0 = blockIdx.y * BM;
  const int nib = min(BM, items - i0);     // the block's items
  const int off = a.Tk - a.Tq;
  // this rank's tiles: a balanced share, every rank at least one
  const int ntiles = (a.Tk + KEYS - 1) / KEYS;
  const int t0 = (int)((long)rank * ntiles / nc);
  const int nt = (int)((long)(rank + 1) * ntiles / nc) - t0;
  const bf16* ak = static_cast<const bf16*>(a.k);
  const bf16* av = static_cast<const bf16*>(a.v);
  auto buf = [&](int h) {
    return reinterpret_cast<bf16*>(sm + (h % NB) * C::HALF_B);
  };
  const uint64_t policy = stream_policy();

  // half-tile h: K and the key mask (h even) or V (h odd) of the rank's
  // tile h / 2, 16-byte cp.async (4-byte for the mask), rows past Tk zeros;
  // one copy group each (empty past the end)
  auto issue = [&](int h) {
    if (h < 2 * nt) {
      const int c0 = (t0 + (h >> 1)) * KEYS;
      const bf16* src = (h & 1) ? av : ak;
      bf16* dst = buf(h);
#pragma unroll
      for (int n = 0; n < KEYS * C8 / C::NT; ++n) {
        const int e = tid + C::NT * n, j = e / C8, d = (e % C8) * 8;
        const bool ok = c0 + j < a.Tk;
        const size_t key = ((size_t)b * a.Tk + (ok ? c0 + j : 0)) * a.Hkv + hkv;
        cp16_policy(dst + j * KP + d, src + key * kWideD + d, ok, policy);
      }
      if (!(h & 1) && a.mask != nullptr && tid < KEYS) {
        const bool ok = c0 + tid < a.Tk;
        cp4b(dst + KEYS * KP + 2 * tid,
             a.mask + (size_t)b * a.Tk + (ok ? c0 + tid : 0), ok);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int h = 0; h < NB - 1; ++h) issue(h);   // in flight while Q loads

  // Q^T's B fragments of the warp's columns (items 8 j + g8; columns 2 t4,
  // 2 t4 + 1 and 2 t4 + 8, + 9 of each 16-column chunk), straight from
  // device memory: an fp32 q split into hi + mid + lo bf16 terms, a bf16 q
  // one term.  The hi term stays in registers for the whole key walk
  // (shared-memory reads of Q otherwise bound S^T); mid and lo go to shared
  // memory where this thread reads them back.  Items past the block's zeros.
  uint32_t qh[DW / 16][NJ][2];
  typename QPair<QT>::T qx[NJ][DW / 16][2];   // every load before the first use
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int it = i0 + min(8 * j + g8, nib - 1);
    const QT* qr = static_cast<const QT*>(a.q) +
                   (((size_t)b * a.Tq + it / G) * a.Hq + hkv * G + it % G) *
                       kWideD + warp * DW + 2 * t4;
#pragma unroll
    for (int kc = 0; kc < DW / 16; ++kc) {
      qx[j][kc][0] = QPair<QT>::load(qr + 16 * kc);
      qx[j][kc][1] = QPair<QT>::load(qr + 16 * kc + 8);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int r = 8 * j + g8;
#pragma unroll
    for (int kc = 0; kc < DW / 16; ++kc) {
      uint32_t w0[3], w1[3];
      QPair<QT>::terms(qx[j][kc][0], w0);
      QPair<QT>::terms(qx[j][kc][1], w1);
      const bool ok = r < nib;
      qh[kc][j][0] = ok ? w0[0] : 0u;
      qh[kc][j][1] = ok ? w1[0] : 0u;
#pragma unroll
      for (int u = 1; u < NTERM; ++u)
        if (r < BM)
          *reinterpret_cast<uint2*>(qt + ((u - 1) * BM + r) * QW +
                                    (warp * DW + 16 * kc) / 2 + 2 * t4) =
              ok ? make_uint2(w0[u], w1[u]) : make_uint2(0u, 0u);
    }
  }
  for (int e = tid; e < 8 * NJ * PP / 2; e += C::NT)   // P rows past the items
    reinterpret_cast<uint32_t*>(ps)[e] = 0u;
  if (tid < 8 * NJ) corr_s[tid] = 1.f;

  float o[8][NJ][4];   // O^T: column tile i (warp * DW + 16 i + g8, + 8),
                       // item tile j (items 8 j + 2 t4, + 1)
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][j][e] = 0.f;
  // the softmax threads: item sr of the block, keys sk, sk + 1 of a tile
  constexpr int SMW = (8 * BM + 31) / 32;    // their warps
  const int sr = tid >> 3, sk = (tid & 7) * 2;
  float m_r = kNegInf, l_r = 0.f;            // l: this thread's share

  // the warp's partial S^T of the tile in kb, over its DW columns
  auto s_part = [&](const bf16* kb) {
    float acc[NJ][NTERM][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int u = 0; u < NTERM; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][u][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DW / 16; ++kc) {
      const int d0 = warp * DW + 16 * kc;
      uint32_t ka[4];
      ldsm4(ka, kb + (8 * (mat & 1) + r8) * KP + d0 + 8 * (mat >> 1));
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = 8 * j + g8;
        const uint32_t* qw = qt + r * QW + (d0 >> 4) * 8 + 2 * t4;
#pragma unroll
        for (int u = NTERM - 1; u >= 1; --u) {   // smallest term first
          const uint2 bq = r < BM ? *reinterpret_cast<const uint2*>(
                                        qw + (u - 1) * BM * QW)
                                  : make_uint2(0u, 0u);
          mma_bf16(acc[j][u], ka, bq.x, bq.y);
        }
        mma_bf16(acc[j][0], ka, qh[kc][j][0], qh[kc][j][1]);
      }
    }
    float* spw = sp + warp * BM * RS;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e] = acc[j][NTERM - 1][e];
#pragma unroll
        for (int u = NTERM - 2; u >= 0; --u) s[e] += acc[j][u][e];
      }
      const int r = 8 * j + 2 * t4;   // c0, c1: key g8; c2, c3: key g8 + 8
      if (r < BM) {
        spw[r * RS + g8] = s[0];
        spw[r * RS + g8 + 8] = s[2];
      }
      if (r + 1 < BM) {
        spw[(r + 1) * RS + g8] = s[1];
        spw[(r + 1) * RS + g8 + 8] = s[3];
      }
    }
  };

  // the tile's logits (the warps' partials added in warp order), its
  // online softmax, P rounded to bf16 and the items' rescale factors; mk:
  // the thread's two keys' mask entries
  auto softmax = [&](int t, const int (&mk)[2]) {
    if (warp >= SMW) return;
    const int r = min(sr, BM - 1);
    const int c = (t0 + t) * KEYS + sk;
    float2 s = *reinterpret_cast<const float2*>(sp + r * RS + sk);
#pragma unroll
    for (int w = 1; w < kWideWarps; ++w) {
      const float2 v = *reinterpret_cast<const float2*>(sp + (w * BM + r) * RS + sk);
      s.x += v.x;
      s.y += v.y;
    }
    const int last = (i0 + r) / G + off;      // last visible key
    float x[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = c + e;
      const bool in = key < a.Tk;
      const bool ok = in && (!a.causal || key <= last) &&
                      (a.mask == nullptr || mk[e] != 0);
      x[e] = !in ? -INFINITY : (ok ? (e ? s.y : s.x) * a.scale : kNegInf);
    }
    float mx = fmaxf(x[0], x[1]);
#pragma unroll
    for (int w = 1; w < 8; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
    const float mnew = fmaxf(m_r, mx);
    const float corr = exp2f((m_r - mnew) * kLog2e);
    const float p0 = exp2f((x[0] - mnew) * kLog2e);   // 0 past Tk
    const float p1 = exp2f((x[1] - mnew) * kLog2e);
    l_r = l_r * corr + (p0 + p1);
    m_r = mnew;
    if (sr < nib) {
      *reinterpret_cast<uint32_t*>(ps + sr * PP + sk) = pack_bf16(p0, p1);
      if (sk == 0) corr_s[sr] = corr;
    }
  };

  // O^T = O^T * corr + V^T P^T over the warp's columns, V's tile in vb
  auto pv = [&](const bf16* vb) {
    float cr[NJ][2];
    uint32_t pb[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      cr[j][0] = corr_s[8 * j + 2 * t4];
      cr[j][1] = corr_s[8 * j + 2 * t4 + 1];
    }
    {
      uint32_t r4[4], r2[2];
      ldsm4(r4, ps + (8 * (mat >> 1) + r8) * PP + 8 * (mat & 1));
      ldsm2(r2, ps + (16 + r8) * PP + 8 * (mat & 1));
      pb[0][0] = r4[0]; pb[0][1] = r4[1];
      pb[1][0] = r4[2]; pb[1][1] = r4[3];
      pb[2][0] = r2[0]; pb[2][1] = r2[1];
    }
    // once the items' maxima settle every factor is 1 (the identity): the
    // warp skips the rescale
    bool scale = false;
#pragma unroll
    for (int j = 0; j < NJ; ++j) scale |= cr[j][0] != 1.f || cr[j][1] != 1.f;
    if (__any_sync(kFull, scale)) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          o[i][j][0] *= cr[j][0];
          o[i][j][1] *= cr[j][1];
          o[i][j][2] *= cr[j][0];
          o[i][j][3] *= cr[j][1];
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t va[4];
      ldsm4t(va, vb + (8 * (mat >> 1) + r8) * KP + warp * DW + 16 * i +
                     8 * (mat & 1));
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_bf16(o[i][j], va, pb[j][0], pb[j][1]);
    }
  };

  // Step t: S^T of tile t beside P V of tile t - 1 (both on the tensor
  // cores), then the softmax of tile t.  Half-tile h lands in buffer h % NB;
  // NB - 1 are issued ahead, two a step, so cp_wait<NB - 2> means "K_t and
  // V_{t-1} landed".
  int mk[2] = {1, 1};
#pragma unroll 1
  for (int t = 0; t <= nt; ++t) {
    cp_wait<NB - 2>();
    __syncthreads();       // K_t and V_{t-1} landed; P_{t-1} written
    if (t < nt) {
      if (a.mask != nullptr && warp < SMW) {   // read while K_t's buffer holds it
        const int* md = reinterpret_cast<const int*>(buf(2 * t) + KEYS * KP);
        mk[0] = md[sk];
        mk[1] = md[sk + 1];
      }
      s_part(buf(2 * t));
    }
    if (t > 0) pv(buf(2 * t - 1));
    __syncthreads();       // the partials written; K_t's, V_{t-1}'s buffers free
    issue(2 * t + NB - 1);
    issue(2 * t + NB);
    if (t < nt) softmax(t, mk);
  }
  cp_wait<0>();
  __syncthreads();         // every warp is done with the ring and the partials

  // the rank's unnormalised O (in the ring's place) and (m, l) (in the
  // partials' place), for the cluster
  float* ofin = reinterpret_cast<float*>(sm);   // [BM][OS]
  float* mfin = sp;
  float* lfin = sp + BM;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = warp * DW + 16 * i + g8, r = 8 * j + 2 * t4;
      if (r < nib) {
        ofin[r * OS + d] = o[i][j][0];
        ofin[r * OS + d + 8] = o[i][j][2];
      }
      if (r + 1 < nib) {
        ofin[(r + 1) * OS + d] = o[i][j][1];
        ofin[(r + 1) * OS + d + 8] = o[i][j][3];
      }
    }
  if (warp < SMW) {
#pragma unroll
    for (int w = 1; w < 8; w <<= 1) l_r += __shfl_xor_sync(kFull, l_r, w);
    if (sk == 0 && sr < nib) {
      mfin[sr] = m_r;
      lfin[sr] = l_r;
    }
  }
  cluster.sync();          // every rank's (O, m, l) visible to the cluster

  // each item's weights: rank s's exp(m_s - max m), in rank order, and
  // 1 / the weighed sum of l
  float* wgt = lfin + BM;                        // [rank][BM]
  float* inv = wgt + kWideMaxCluster * BM;       // [BM]
  if (tid < nib) {
    float ms[kWideMaxCluster], ls[kWideMaxCluster];
#pragma unroll
    for (int s = 0; s < kWideMaxCluster; ++s) {  // all loads in flight at once
      ms[s] = s < nc ? cluster.map_shared_rank(mfin, s)[tid] : -INFINITY;
      ls[s] = s < nc ? cluster.map_shared_rank(lfin, s)[tid] : 0.f;
    }
    float M = -INFINITY;
#pragma unroll
    for (int s = 0; s < kWideMaxCluster; ++s) M = fmaxf(M, ms[s]);
    float lw = 0.f;
#pragma unroll
    for (int s = 0; s < kWideMaxCluster; ++s) {
      if (s >= nc) break;
      const float w = exp2f((ms[s] - M) * kLog2e);
      lw = fmaf(ls[s], w, lw);
      wgt[s * BM + tid] = w;
    }
    inv[tid] = 1.f / fmaxf(lw, 1e-30f);
  }
  __syncthreads();

  // rank r finishes items r, r + nc, ..: every rank's partial O weighed and
  // added in rank order; thread tid the columns 4 tid .. 4 tid + 3, three
  // items' loads in flight at once (its own rank's from its own memory)
  const int d = 4 * tid;
  auto finish = [&](int r, const float4 (&v)[kWideMaxCluster]) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kWideMaxCluster; ++s) {
      if (s >= nc) break;
      const float w = wgt[s * BM + r];
      acc.x = fmaf(v[s].x, w, acc.x);
      acc.y = fmaf(v[s].y, w, acc.y);
      acc.z = fmaf(v[s].z, w, acc.z);
      acc.w = fmaf(v[s].w, w, acc.w);
    }
    const float f = inv[r];
    const int it = i0 + r;
    put4(static_cast<QT*>(a.out) +
             (((size_t)b * a.Tq + it / G) * a.Hq + hkv * G + it % G) * kWideD + d,
         make_float4(acc.x * f, acc.y * f, acc.z * f, acc.w * f));
  };
  constexpr int RB = 3;
  for (int r = rank; r < nib; r += RB * nc) {
    float4 v[RB][kWideMaxCluster];
#pragma unroll
    for (int s = 0; s < kWideMaxCluster; ++s) {
      if (s < nc) {
        const float* os =
            (s == rank ? ofin : cluster.map_shared_rank(ofin, s)) + d;
#pragma unroll
        for (int u = 0; u < RB; ++u)
          v[u][s] = *reinterpret_cast<const float4*>(
              os + min(r + u * nc, nib - 1) * OS);
      }
    }
#pragma unroll
    for (int u = 0; u < RB; ++u)
      if (r + u * nc < nib) finish(r + u * nc, v[u]);
  }
  cluster.sync();          // no rank leaves while another reads its partials
}

template <typename QT>
struct WideKern {
  using C = WideCfg<QT>;
  static const void* fn() {
    return reinterpret_cast<const void*>(&attn_wide_kernel<QT>);
  }
  // clusters of c blocks the card holds at once, asked once; 0 when CUDA
  // cannot say
  static int clusters(int c) {
    static bool set_up = false;
    static int cache[kWideMaxCluster + 1] = {};
    if (!set_up) {
      if (cudaFuncSetAttribute(attn_wide_kernel<QT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM) != cudaSuccess)
        return 0;
      set_up = true;
    }
    if (cache[c] == 0) {
      cudaLaunchConfig_t lc = {};
      lc.gridDim = dim3((unsigned)c, 1, 1);
      lc.blockDim = dim3(C::NT, 1, 1);
      lc.dynamicSmemBytes = (size_t)C::SMEM;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = (unsigned)c;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      lc.attrs = attr;
      lc.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, fn(), &lc) != cudaSuccess ||
          n < 1) {
        cudaGetLastError();
        return 0;
      }
      cache[c] = n;
    }
    return cache[c];
  }
  static cudaError_t launch(const Args& a, dim3 grid, int c, cudaStream_t st) {
    cudaLaunchConfig_t lc = {};
    lc.gridDim = grid;
    lc.blockDim = dim3(C::NT, 1, 1);
    lc.dynamicSmemBytes = (size_t)C::SMEM;
    lc.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    lc.attrs = attr;
    lc.numAttrs = 1;
    return cudaLaunchKernelEx(&lc, attn_wide_kernel<QT>, a);
  }
};

template <int D, int TY, int RPT, bool PQ, typename QT, typename KT>
struct Kern {
  using C = Cfg<D, TY, RPT>;
  static constexpr int BM = C::BM;
  // allow the largest dynamic shared memory once; blocks per SM
  static int per_sm() {
    static int n = -1;
    if (n < 0) {
      if (cudaFuncSetAttribute(attn_kernel<D, TY, RPT, PQ, QT, KT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::smem(true)) != cudaSuccess)
        return 0;
      int k = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &k, attn_kernel<D, TY, RPT, PQ, QT, KT>, C::NT, C::smem(false)) !=
          cudaSuccess)
        return 0;
      n = k;
    }
    return n;
  }
  static void launch(const Args& a, dim3 grid, bool rope, cudaStream_t st) {
    attn_kernel<D, TY, RPT, PQ, QT, KT><<<grid, C::NT, C::smem(rope), st>>>(a);
  }
};

struct Plan {
  int kind, bm, nib, splits, tps, per_sm;
  int waves;   // the bf16 wide form: waves of clusters (splits: their size)
};

// The operands' dtypes: fp32 Q, K and V; bf16 Q, K and V; fp32 Q over bf16
// K and V (the LTSF cross-attention of a bf16 model).  The wrapper widens a
// bf16 Q over fp32 K and V to fp32 (exact), so no kernel takes that one.
enum Dtypes { kF32 = 0, kBf16 = 1, kF32Bf16 = 2 };

// Calls f(Kern<...>{}) for the kernel of (kind, D, PQ, dtypes); false for a
// D it lacks.
template <bool PQ, typename QT, typename KT, typename F>
bool dispatch_pq(int kind, int D, F&& f) {
  if (kind == kWide) {   // bf16 K and V at D = 1024: the wide form
    if constexpr (std::is_same<KT, float>::value) {
      if (D != 1024) return false;
      f(Kern<1024, 16, 2, PQ, QT, KT>{});
      return true;
    }
    return false;
  }
  switch (D) {
#define FLASH_CASE(DD)                                               \
    case DD:                                                         \
      if (kind == kTiled) f(Kern<DD, 16, 4, PQ, QT, KT>{});          \
      else f(Kern<DD, 16, 1, PQ, QT, KT>{});                         \
      return true;
    FLASH_CASE(16) FLASH_CASE(32) FLASH_CASE(64) FLASH_CASE(96) FLASH_CASE(128)
#undef FLASH_CASE
    default: return false;
  }
}

// a per-query mask is taken in fp32 only (the speculative window over the
// fp32 decode cache)
template <typename F>
bool dispatch(int kind, int D, bool pq, int dt, F&& f) {
  if (dt == kF32)
    return pq ? dispatch_pq<true, float, float>(kind, D, f)
              : dispatch_pq<false, float, float>(kind, D, f);
  if (pq) return false;
  if (dt == kBf16 && kind == kTiled) {   // the tensor-core form
    switch (D) {
      case 16: f(MmaKern<16>{}); return true;
      case 32: f(MmaKern<32>{}); return true;
      case 64: f(MmaKern<64>{}); return true;
      case 96: f(MmaKern<96>{}); return true;
      case 128: f(MmaKern<128>{}); return true;
      default: return false;
    }
  }
  if (dt == kBf16 && kind == kDecode) {  // the decode form
    switch (D) {
      case 16: f(DecKern<16>{}); return true;
      case 32: f(DecKern<32>{}); return true;
      case 64: f(DecKern<64>{}); return true;
      case 96: f(DecKern<96>{}); return true;
      case 128: f(DecKern<128>{}); return true;
      default: return false;
    }
  }
  if (dt == kBf16) return false;
  if (dt == kF32Bf16) return dispatch_pq<false, float, bf16>(kind, D, f);
  return false;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

// The bf16 wide form's plan: a cluster of c key splits per (b, KV head,
// block of kWideBM items), c <= 8 and at most the key tiles, picked for the
// least modelled time: waves of clusters (as many as the card holds at
// once) times the tiles of the longest split.
int wide_plan(int B, long items, int Tk, int Hkv, int dt, Plan* p) {
  p->kind = kWideBf16;
  p->bm = kWideBM;
  p->per_sm = 1;
  const long nib = (items + kWideBM - 1) / kWideBM;
  const long groups = (long)B * Hkv * nib;
  const int ntiles = (Tk + kWideKeys - 1) / kWideKeys;
  if (nib > 65535) return -1;
  int best = 0;
  long best_t = 0, best_w = 0;
  for (int c = 1; c <= std::min(kWideMaxCluster, ntiles); ++c) {
    const int cap = dt == kBf16 ? WideKern<bf16>::clusters(c)
                                : WideKern<float>::clusters(c);
    if (cap < 1) continue;
    const long waves = (groups + cap - 1) / cap;
    const long t = waves * ((ntiles + c - 1) / c);
    if (best == 0 || t < best_t) {
      best = c;
      best_t = t;
      best_w = waves;
    }
  }
  if (best == 0) return -2;            // CUDA could not place the kernel
  if ((long)B * Hkv * best > 0x7fffffffL) return -1;
  p->nib = (int)nib;
  p->splits = best;
  p->tps = (ntiles + best - 1) / best;  // tiles of the longest split
  p->waves = (int)std::min<long>(best_w, 0x7fffffffL);
  return 0;
}

// The form and the key splits of a call: -1 for what the kernel does not
// take, -2 when CUDA refused the kernel's set-up.
int make_plan(int B, int Tq, int Tk, int Hq, int Hkv, int D, bool rope,
              bool pq, int dt, Plan* p) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hkv < 1 || Hq % Hkv) return -1;
  if (rope && (D > 128 || Tq != Tk)) return -1;
  const int G = Hq / Hkv;
  const long items = (long)Tq * G;
  const int ntiles = (Tk + BN - 1) / BN;
  p->kind = D > 128 ? kWide : (!rope && items <= 16 ? kSmall : kTiled);
  p->waves = 0;
  if (p->kind == kWide && dt != kF32) {  // bf16 K and V: the wide form
    if (pq || D != kWideD) return -1;
    return wide_plan(B, items, Tk, Hkv, dt, p);
  }
  if (p->kind == kSmall && dt == kBf16) p->kind = kDecode;
  bool known = dispatch(p->kind, D, pq, dt, [&](auto k) {
    p->bm = decltype(k)::BM;
    p->per_sm = decltype(k)::per_sm();
  });
  if (!known) return -1;
  if (p->per_sm < 1) return -2;        // the shared-memory or occupancy query failed
  const long nib = (items + p->bm - 1) / p->bm;
  if (nib > 65535 || (long)B * Hkv > 0x7fffffffL) return -1;
  p->nib = (int)nib;
  p->tps = ntiles;                      // tiled form: no split
  if (p->kind == kWide) {
    p->tps = 1;                         // one tile a block (ONE_TILE)
  } else if (p->kind == kSmall) {
    // at least two waves of blocks over the card, whole tiles a split
    const long base = (long)B * Hkv * nib;
    const long want = 2L * sm_count() * p->per_sm;
    const long per = std::max<long>(1, (want + base - 1) / base);
    p->tps = (int)std::max<long>(1, ntiles / per);
  } else if (p->kind == kDecode) {
    // one wave of blocks over the card (each block holds its split's
    // tiles in flight at once), whole tiles a split; a ticket a pair
    const long pairs = (long)B * Hkv;
    if (pairs > kDecTickets) return -1;
    const long per = std::max<long>(1, (long)sm_count() * p->per_sm / pairs);
    p->tps = (int)((ntiles + per - 1) / per);
  }
  p->splits = (ntiles + p->tps - 1) / p->tps;
  return p->splits > 65535 ? -1 : 0;    // grid.z
}

}  // namespace

// The key splits whose partials a call writes to the wrapper's scratch (1:
// none; the bf16 wide form merges through its cluster)
int scratch_splits(const Plan& p) {
  return p.kind == kWideBf16 ? 1 : p.splits;
}

int form_code(const Plan& p, int dt) {
  if (p.kind == kDecode) return 4;
  if (p.kind == kWideBf16) return 5;
  return p.kind == kTiled && dt == kBf16 ? 3 : p.kind;
}

extern "C" int flash_attn_splits(int B, int Tq, int Tk, int Hq, int Hkv,
                                 int D, int rope, int pq, int dt) {
  Plan p;
  const int err = make_plan(B, Tq, Tk, Hq, Hkv, D, rope != 0, pq != 0, dt, &p);
  return err != 0 ? err : scratch_splits(p);
}

// The form a call takes, with the arguments of flash_attn_splits: 0 tiled
// (fp32 FMAs), 1 split-KV, 2 split-KV at D = 1024, 3 tiled on the bf16
// tensor cores (all-bf16 operands), 4 the bf16 decode form (all-bf16
// operands, at most 16 items), 5 the bf16 wide form (bf16 K and V at D =
// 1024); negative as flash_attn_splits.
extern "C" int flash_attn_form(int B, int Tq, int Tk, int Hq, int Hkv, int D,
                               int rope, int pq, int dt) {
  Plan p;
  const int err = make_plan(B, Tq, Tk, Hq, Hkv, D, rope != 0, pq != 0, dt, &p);
  return err != 0 ? err : form_code(p, dt);
}

// A field of a call's plan, with the arguments of flash_attn_splits and
// then the field: 0 the form (flash_attn_form's code), 1 the key splits, 2
// the cluster size (the wide form's splits; 1 for the others), 3 the
// blocks of the launch, 4 the keys of the longest split, 5 the waves of
// clusters (the wide form; 0 for the others); negative as
// flash_attn_splits, -1 for another field.
extern "C" int flash_attn_plan(int B, int Tq, int Tk, int Hq, int Hkv, int D,
                               int rope, int pq, int dt, int field) {
  Plan p;
  const int err = make_plan(B, Tq, Tk, Hq, Hkv, D, rope != 0, pq != 0, dt, &p);
  if (err != 0) return err;
  const bool wide = p.kind == kWideBf16;
  const long blocks = (long)B * Hkv * p.nib * p.splits;
  switch (field) {
    case 0: return form_code(p, dt);
    case 1: return p.splits;
    case 2: return wide ? p.splits : 1;
    case 3: return (int)std::min<long>(blocks, 0x7fffffffL);
    case 4: return std::min(Tk, p.tps * (wide ? kWideKeys : BN));
    case 5: return p.waves;
    default: return -1;
  }
}

extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const int* mask, const float* cos,
                              const float* sin, void* out, float* part,
                              int B, int Tq, int Tk, int Hq, int Hkv, int D,
                              int causal, float scale, int splits, int mq,
                              int dt, void* stream) {
  Plan p;
  const bool rope = cos != nullptr;
  if (mq != 0 && mq != Tk) return -1;
  const bool pq = mask != nullptr && mq != 0;
  if (make_plan(B, Tq, Tk, Hq, Hkv, D, rope, pq, dt, &p) != 0) return -1;
  if (scratch_splits(p) != splits || (splits > 1 && part == nullptr))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, mask, cos, sin, out, part, B, Tq, Tk, Hq, Hkv,
               causal, p.splits, p.tps, mq, scale};
  if (p.kind == kWideBf16) {   // one launch: the cluster merges its splits
    const dim3 grid(B * Hkv * p.splits, p.nib, 1);
    const cudaError_t err =
        dt == kBf16 ? WideKern<bf16>::launch(a, grid, p.splits, s)
                    : WideKern<float>::launch(a, grid, p.splits, s);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  const dim3 grid(B * Hkv, p.nib, p.splits);
  dispatch(p.kind, D, pq, dt,
           [&](auto kern) { decltype(kern)::launch(a, grid, rope, s); });
  cudaError_t err = cudaGetLastError();
  // the decode form merges its splits itself
  if (err != cudaSuccess || p.splits == 1 || p.kind == kDecode)
    return static_cast<int>(err);
  // fp32 outputs only: every bf16-output form merges its own splits
  const size_t NI = (size_t)B * Tq * Hq;
  const size_t n = NI * (D / 4);
  const unsigned nb = (unsigned)((n + 255) / 256);
  merge_kernel<<<nb, 256, 0, s>>>(part, static_cast<float*>(out), NI, D,
                                  p.splits);
  return static_cast<int>(cudaGetLastError());
}
