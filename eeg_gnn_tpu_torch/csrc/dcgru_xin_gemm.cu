// The input half and the weight gradients of the x-in-kernel DCGRU layer,
// as bulk tensor-core products over all T*B clip-steps, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the parts of two Pallas TPU kernels of
// eeg_gnn_tpu/ops/pallas_recurrent.py that do not carry the state:
//   dcgru_xin_proj  <- _fwd_kernel_xin (:730): the input diffusion and
//                      projection xg / xc (:765-772), for every step at once:
//                      XP[t,b] = sum_m (A_m x[t,b]) Wx_m, Wx = [Wxg | Wxc].
//   dcgru_xin_dw    <- _bwd_kernel_xin (:782): every dW / db accumulation
//                      (acc_dot, :866-888) over its recomputed features
//                      (:820-838), summed in grid-resident blocks (:794-801):
//                      dWx = sum (A x)^T dpre, dWg = sum (A h_prev)^T dru_pre,
//                      dWc = sum (A (r h_prev))^T dc_pre, db = sum dpre.
//                   <- _bwd_kernel (:283) too, at D = 0: the hoisted
//                      layer's dWg, dWc and db (no x, no dWx).
//   dcgru_xin_dx    <- _bwd_kernel_xin (:782): the x cotangent (:875-892):
//                      dx = sum_m A_m^T (dpre Wx_m^T) = sum_m (A_m^T dpre) Wx_m^T.
// dpre = [dru_pre | dc_pre] (T, B, N, 3H) f32 comes from the state-only BPTT
// loop (dcgru_recurrence_bwd.cu); XP feeds the state-only forward loop
// (dcgru_recurrence.cu). None of this work is on the serial time chain.
//
// What bounds it on an H100. At the flagship shape (T=60, B=128, N=19,
// H=64, M=3) layer 0 (D=100) does 16.8 GFLOP of projection products, 27.5
// of dW products and 16.8 of dx products on tensor cores, plus 1.1-2.6
// GFLOP of diffusions each; with bf16 streams the least time for each
// is 0.04-0.07 ms (products at 989 TFLOP/s, or the bytes at 3.35 TB/s:
// chip_smoke.py's proj_work, dw_work, dx_work), far below the serial
// loops'.
//
// Projection and dx: out = sum_m (Op_m In) V_m per clip; the projection
// takes Op_m = A_m, In = x, V_m = Wx_m (D x 3H) and writes XP in f32, dx
// takes Op_m = A_m^T, In = dpre, V_m = Wx_m^T (3H x D) and writes dx in
// the stream dtype. Two bodies, by the stream dtype.
// - bf16 streams: xin_bulk_kernel. The first port staged K 16 columns at
//   a time, diffused on FMA between three barriers a stage and re-read
//   its f32 weights from L2 for every chunk, converting them at every
//   fragment; its probe (loop_probe.py --only proj|dx, PERF.md) found a
//   stage spent in the products' conversions (proj), or the FMA diffusion
//   (dx at D=64), and issuing the next stage's copies. This design
//   diffuses on the tensor cores: the operators arrive as mma A fragments
//   laid out once a launch by the wrapper (dw_op_frags, A_m or A_m^T), In
//   is the B operand (F_0 read by ldmatrix.trans, the rows past a pair's
//   N masked to zero), and F_m = Op_m In is written once into a shared
//   tile in bf16, one bf16 pass of bf16 A_m and In (the reference's
//   projection rounds the same F; its dx multiplies by Wx_m^T first:
//   PERF.md says why this one does not); m=0 is a copy. The product reads
//   F as A fragments (ldmatrix) and converts nothing. It keeps the weights
//   resident: the wrapper stages V_m as mma B fragments
//   (xin_weight_frags); a block owns one output column tile, copies its
//   weights in once and walks many chunks of whole (t, b) pairs (a
//   persistent grid of one wave of 132 blocks an SM slot; the H100's SM
//   count is a constant). F holds one m at a time. It stages by TMA from
//   a producer warp: a weight tile as one 3-D tensor copy, a chunk's rows
//   as one 2-D tensor copy (f32 In, rows padded for conflict-free reads)
//   or 1-D bulk copies of their span (bf16 x), the pairs' operator
//   fragments likewise (clip-major, so a chunk's are one span); the next
//   chunk's copies are issued as soon as its In is read and run under the
//   products. Two barriers an m a chunk; the plans fit two blocks an SM
//   (the projection) or 11 warps (dx), so one block's diffusion runs under
//   the other's product.
// - f32 streams: xin_bulk_tf32_wgmma_kernel, 3xTF32 on warpgroup MMA
//   (wgmma) with exact f32 diffusions (its note is below). Its TF32 hi|lo
//   weights are 4x bf16's bytes: held resident they would cap a block at
//   64 columns, and each column tile would re-read In and re-diffuse the
//   chunk (the 3H = 192 projection columns three times), so a block takes
//   every column and streams the weights from L2 by k8 slice instead
//   (PERF.md has the mma.sync design this replaced).
// - both write every output element from one block's registers: no sums
//   across blocks, the same bits on every run.
//
// dW. The TPU kernel diffused [h_prev | r h_prev | x] at every step and
// multiplied the features into resident dW blocks. The first port did the
// same per chunk of rows, and its probe (loop_probe.py --only dw, PERF.md)
// found a chunk of the slowest blocks spent 56% in the FMA diffusion, 23%
// issuing the next chunk's copies (the operators a word at a time, two
// integer divisions each) and 21% in products that converted every f32
// operand at every fragment; the copies were always there in time. This
// design:
// - moves the diffusion to dpre's side: per clip (A_m F)^T dpre =
//   F^T (A_m^T dpre), so dW_m = sum [x | h_prev | r h_prev]^T G_m with
//   G_m = A_m^T dpre. A block owns one m and one 64-column tile of dpre
//   (gate or candidate columns) and every 16-feature tile of [x | h_prev]
//   or [x | r h_prev], a warp each: it diffuses its dpre tile once a
//   chunk and every feature tile reads that G, and the raw features need
//   no diffusion. Blocks do equal products; m=0 has no diffusion and
//   sums db instead.
// - runs the diffusion on the tensor cores: A_m^T as mma A fragments
//   laid out once by the wrapper (dw_op_frags: bf16, or TF32 hi and lo),
//   dpre as the B operand, G written once as G^T in the operand type
//   (bf16, or hi and lo), which the product reads as conflict-free 32-bit
//   B words (bf16) or 8-byte hi|lo pairs (f32), unconverted. bf16: G_m is
//   one bf16 pass of bf16 A_m^T and dpre, rounded to bf16, and r h_prev
//   is rounded to bf16 (the reference rounds A_m F and dpre instead);
//   f32: 3xTF32 throughout. The mma are not `volatile`, so independent
//   products and loads interleave.
// - stages a chunk by TMA copies that one producer warp issues (a copy
//   holds its thread; the producer has no feature tile), counted in by
//   mbarriers: x, h_prev and ru rows as 1-D bulk copies of their
//   contiguous spans, the pairs' operator fragments likewise, dpre's
//   strided 64-column tile as one 2-D tensor copy (dw_dpre_map). No
//   thread spends instructions on a copy's addresses.
// - two barriers a chunk: the diffusion (and r h_prev, built once in
//   padded rows for conflict-free fragment reads), then the product; x
//   and h_prev double-buffered, the next chunk's dpre, ru and operators
//   issued while the product runs.
// - sums in an order fixed by the shape: dcgru_xin_dw's splits of the
//   (t, b) pairs fill whole waves of 132 blocks, at most 192 pairs each
//   (ops/cuda_recurrent.py, dw_splits; the H100's SM count is a constant,
//   never read from the card), a block walks its chunks in order and
//   adds each chunk's tensor-core partial into an f32 register sum
//   outside the tensor cores (see flush), and dcgru_dw_reduce
//   (dcgru_recurrence_bwd.cu) sums the splits in order. No atomics: two
//   runs, on any card, give the same bits.
// A chunk's stages still run in series in one 12-warp block an SM: the
// product, shared-memory-bound (every warp reads all of G^T), is the
// largest (PERF.md). wgmma and a persistent schedule are later work here
// (the f32 projection and dx have them).

#include <cuda.h>  // CUtensorMap and its enums (the encoder via the runtime)

#include <type_traits>

#include "dcgru_common.cuh"

namespace {

using namespace dcgru;

constexpr int kMaxSmem = 232448;   // shared bytes a block may have
constexpr int kSmemPerSm = 233472; // shared bytes of an SM (1 KB a block
                                   // is the system's)

// ---------------------------------------------------------------------------
// chunks of whole (t, b) pairs
// ---------------------------------------------------------------------------

struct Geom {
  int P, RB;  // pairs per chunk; rows per chunk, padded to 16
};

// The chunk of at most `cap` rows with the least padding (ties: more pairs).
Geom geom(int N, int cap) {
  Geom best{1, ((N + 15) / 16) * 16};
  for (int p = 1; p * N <= cap; ++p) {
    const int rb = ((p * N + 15) / 16) * 16;
    if ((long)(rb - p * N) * best.RB <= (long)(best.RB - best.P * N) * rb)
      best = Geom{p, rb};
  }
  return best;
}

// ---------------------------------------------------------------------------
// TMA copies and tensor-core helpers (others in dcgru_common.cuh)
// ---------------------------------------------------------------------------
//
// The copies are the Tensor Memory Accelerator's bulk copies
// (cp.async.bulk): one thread issues a whole span or tensor box and an
// mbarrier counts its bytes in, so no thread stalls on a chunk's loads.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `count` arrivals a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar,
                                          unsigned count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

// this phase's arrival, expecting `bytes` of copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16; both ends 16-byte aligned) global -> shared
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a box of the 2-D tensor map at (column c0, row c1) -> shared memory
// (128-byte aligned); the box's bytes count in `bar`, its parts past the
// tensor read as zeros
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// generic-proxy writes to shared memory before the copies' (async-proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A span of `bytes` (a multiple of 4) at `src` as 16-byte aligned bulk
// copies: the copy starts `lead` bytes early and is padded to 16 bytes,
// but never past `end` (the tensor's end): there its last `tail` bytes
// are left to word copies.
struct Span {
  const char* start;
  unsigned bytes;
  int lead, tail;
};

__device__ __forceinline__ Span span16(const void* src, int bytes,
                                       const void* end) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  Span s;
  s.lead = static_cast<int>(a & 15);
  s.start = reinterpret_cast<const char*>(a - s.lead);
  const int need = s.lead + bytes;
  int sp = (need + 15) & ~15;
  s.tail = 0;
  if (a - s.lead + sp > reinterpret_cast<uintptr_t>(end)) {
    sp -= 16;
    s.tail = need - sp;
  }
  s.bytes = static_cast<unsigned>(sp);
  return s;
}

// by one thread: the span into dst (16-byte aligned), counted by `bar`
__device__ __forceinline__ void copy_span(void* dst, const Span& s,
                                          uint64_t* bar) {
  if (s.bytes) bulk_copy(dst, s.start, s.bytes, bar);
  if (s.tail) {
    for (int k = 0; k < s.tail; k += 4)
      *reinterpret_cast<uint32_t*>(static_cast<char*>(dst) + s.bytes + k) =
          *reinterpret_cast<const uint32_t*>(s.start + s.bytes + k);
    fence_proxy_async();
  }
}

// G^T (column j, chunk row k) = v: bf16 rounded to nearest, or f32 as
// TF32 hi and lo (split once here, read by every feature tile)
__device__ __forceinline__ void store_g(__nv_bfloat16* gt, int ldg, int j,
                                        int k, float v) {
  gt[j * ldg + k] = __float2bfloat16(v);
}
__device__ __forceinline__ void store_g(float2* gt, int ldg, int j, int k,
                                        float v) {
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  gt[j * ldg + k] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

// G^T (column j, chunk rows k and k+1, k even) = (va, vb); also row j,
// columns k and k+1 of the bf16 projection's and dx's F
__device__ __forceinline__ void store_g2(__nv_bfloat16* gt, int ldg, int j,
                                         int k, float va, float vb) {
  *reinterpret_cast<uint32_t*>(gt + j * ldg + k) = pack_bf16(va, vb);
}
__device__ __forceinline__ void store_g2(float2* gt, int ldg, int j, int k,
                                         float va, float vb) {
  uint32_t ha, la, hb, lb;
  split_tf32(va, ha, la);
  split_tf32(vb, hb, lb);
  *reinterpret_cast<uint4*>(gt + j * ldg + k) = make_uint4(ha, la, hb, lb);
}

// a box of the 3-D tensor map at (c0, c1, c2) -> shared memory (128-byte
// aligned), counted in `bar`; its parts past the tensor read as zeros
__device__ __forceinline__ void tensor_copy3(void* dst, const CUtensorMap* map,
                                             int c0, int c1, int c2,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// the four 8x8 bf16 matrices of an m16n8k16 A fragment from shared memory:
// lane l gives row (l & 15), column 8 (l >> 4) of the 16 x 16 tile
// (volatile: never moved across a barrier; other loads may pass it)
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// the same, transposed: B fragments (k = 2t, 2t+1; n = g) of a k-major
// tile, lane l giving row (l & 15), column 8 (l >> 4)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&b)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// two adjacent output elements (the first 8-byte aligned)
__device__ __forceinline__ void store_out2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store_out2(__nv_bfloat16* o, float a,
                                           float b) {
  *reinterpret_cast<uint32_t*>(o) = pack_bf16(a, b);
}

// ---------------------------------------------------------------------------
// projection and dx in bf16: out = sum_m (Op_m In) V_m, a block a column
// tile
// ---------------------------------------------------------------------------
//
// Rows are clip-steps' node rows, (t, b, n) flattened; a chunk is P whole
// (t, b) pairs, P*N rows padded to RB (a multiple of 16) only at its end,
// so the per-clip diffusion stays inside it. A block owns columns
// [ctile*ct, ctile*ct + ct) of the output and walks the chunks walker,
// walker + walkers, ...; per chunk and m it writes F = Op_m In (m=0: In)
// into the shared operand tile, then every compute warp multiplies its
// 16 rows of F by its columns of V_m. Rows past a chunk's pairs hold stale
// values and meet only output rows that are never stored.

constexpr int kBulkWarps = 11;    // compute warps of a block, at most
constexpr int kBulkRows = 96;     // rows of a chunk, at most
constexpr int kBulkWave = 132;    // blocks of a wave: the H100's SMs, a
                                  // constant (the plan follows the shape)

struct BulkParams {
  const void* in;      // (pairs*N, K): x in the stream dtype, or dpre f32
  const uint4* ops;    // (a_batch, M-1, fw) Op_m as mma A fragments
  void* out;           // (pairs*N, C): XP f32, or dx in the stream dtype
  int pairs, B, N, K, C, M, a_batch;
  int P, RB;           // pairs a chunk; rows a chunk, padded to 16
  int ct, ctn;         // columns of a block's tile (64, 32, 16 or 8; a
                       // warp takes min(32, ct)); column tiles
  int kt;              // k tiles of one m: K padded to 16
  int fw;              // 16-byte words of one operator's fragments
  int wb;              // bytes of one n8 tile's B fragments, one k tile
  int tmap;            // In by the 2-D tensor map, rows ldk apart; else by
                       // 1-D bulk copies of the rows' span (ldk = K)
  int ldk, ldf;        // row strides: In (elements), F (bf16)
  int warps;           // compute warps; the producer is one more
  int walkers;         // blocks of one column tile
};

// Byte offsets of a block's shared memory: the weight tile (all m: M*kt k
// tiles by ct/8 n tiles, as the 3-D tensor copy lands it), the chunk's In
// rows (single: it is read once, into F_0, and the next chunk's copy is
// issued then), the pairs' operator fragments (one set for a shared
// graph, copied once), F_0 (= In, the diffusion's B operand too, rows to
// the last pair's last k tile) and F_m for one m at a time, the copies'
// mbarriers (weights and shared operators; a chunk's In; its
// operators).
struct BulkSmem {
  int w, in, ops, f, fm, bar, total;
  __host__ __device__ BulkSmem(const BulkParams& p, int ib) {
    w = 0;
    in = (p.M * p.kt * (p.ct / 8) * p.wb + 127) & ~127;
    // a span's copy starts up to 12 bytes early and ends padded to 16
    const int inb = p.tmap ? p.P * p.N * p.ldk * ib : p.P * p.N * p.K * ib + 32;
    ops = align16(in + inb);
    f = ops + (p.M > 1 ? (p.a_batch == 1 ? 1 : p.P) * (p.M - 1) * p.fw * 16
                       : 0);
    const int r0 = max(p.RB, (p.P - 1) * p.N + 16 * ((p.N + 15) / 16));
    fm = f + r0 * p.ldf * 2;
    bar = align16(fm + p.RB * p.ldf * 2);
    total = bar + 32;
  }
};

// PROJ: In = x (S), Op_m = A_m, out = XP (f32); else In = dpre (f32),
// Op_m = A_m^T, out = dx (S). S is bf16: one bf16 pass (f32 streams take
// xin_bulk_tf32_wgmma_kernel, below). wmap: the staged weights (M*kt,
// C/8 n tiles, one n tile's words) as a 3-D tensor map whose box is a
// block's column tile; imap: In (pairs*N rows, K columns) f32 as a 2-D
// tensor map whose box is a chunk's P*N rows by ldk columns (when
// p.tmap).
template <bool PROJ, typename S>
__global__ void __launch_bounds__(32 * (kBulkWarps + 1), 2)
    xin_bulk_kernel(const BulkParams p,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap imap) {
  using IT = typename std::conditional<PROJ, S, float>::type;
  using OT = typename std::conditional<PROJ, float, S>::type;
  using FT = __nv_bfloat16;
  constexpr int kNt = 4;  // n8 tiles of a warp's columns, at most
  extern __shared__ __align__(128) unsigned char dsm[];
  const BulkSmem L(p, sizeof(IT));
  const int N = p.N, K = p.K, M = p.M, P = p.P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the last warp issues the copies and helps build F_0
  const bool producer = warp == p.warps;
  DCGRU_PROBE_START;

  IT* sin = reinterpret_cast<IT*>(dsm + L.in);
  uint4* sops = reinterpret_cast<uint4*>(dsm + L.ops);
  FT* sf0 = reinterpret_cast<FT*>(dsm + L.f);
  FT* sfm = reinterpret_cast<FT*>(dsm + L.fm);
  uint64_t* bars = reinterpret_cast<uint64_t*>(dsm + L.bar);
  const int ctile = blockIdx.x % p.ctn, walker = blockIdx.x / p.ctn;
  const int chunks = (p.pairs + P - 1) / P;
  const int mine =
      walker < chunks ? (chunks - walker + p.walkers - 1) / p.walkers : 0;
  const IT* ig = static_cast<const IT*>(p.in);
  const IT* iend = ig + (size_t)p.pairs * N * K;
  const bool per_clip = M > 1 && p.a_batch > 1;
  const unsigned opw = (M - 1) * p.fw;  // 16-byte words of a clip's ops
  auto pair0_of = [&](int it) { return (walker + it * p.walkers) * P; };
  // chunk it's In rows, by the producer's lane 0
  auto issue_in = [&](int it) {
    const int pair0 = pair0_of(it), np = min(P, p.pairs - pair0);
    if (p.tmap) {
      mbar_expect(&bars[1], P * N * p.ldk * (int)sizeof(IT));
      tensor_copy(sin, &imap, 0, pair0 * N, &bars[1]);
    } else {
      const Span s = span16(ig + (size_t)pair0 * N * K,
                            np * N * K * (int)sizeof(IT), iend);
      mbar_expect(&bars[1], s.bytes);
      copy_span(sin, s, &bars[1]);
    }
  };
  // its pairs' operators (per-clip graphs): runs of consecutive clips
  auto issue_ops = [&](int it) {
    const int pair0 = pair0_of(it), np = min(P, p.pairs - pair0);
    mbar_expect(&bars[2], np * opw * 16);
    for (int q = 0, b = pair0 % p.B; q < np; b = 0) {
      const int run = min(np - q, p.B - b);
      bulk_copy(sops + q * opw, p.ops + (size_t)b * opw, run * opw * 16,
                &bars[2]);
      q += run;
    }
  };

  // zero every buffer once: F's pad columns and the tile's pad rows stay
  // zero
  for (int i = threadIdx.x; i < L.total / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(dsm)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer && lane == 0) {
    const bool shared_ops = M > 1 && p.a_batch == 1;
    mbar_expect(&bars[0], M * p.kt * (p.ct / 8) * p.wb +
                              (shared_ops ? opw * 16 : 0));
    tensor_copy3(dsm + L.w, &wmap, 0, ctile * (p.ct / 8), 0, &bars[0]);
    if (shared_ops) bulk_copy(sops, p.ops, opw * 16, &bars[0]);
    if (mine) {
      issue_in(0);
      if (per_clip) issue_ops(0);
    }
  }
  mbar_wait(&bars[0], 0);
  DCGRU_PROBE_MARK(0);

  // this warp's product tile: rows 16 wr.., n8 tiles of columns col0..
  // (wn of them), every k tile of each m
  const int rtiles = p.RB / 16, ntc = p.ct / 8, wn = min(32, p.ct);
  const int wtiles = rtiles * (p.ct / wn);  // the compute warps
  const int wr = warp % rtiles, wc = (warp % wtiles) / rtiles;
  const int col0 = ctile * p.ct + wc * wn;
  const int nt_live =
      producer ? 0 : max(0, min(wn / 8, (p.C - col0 + 7) / 8));
  const int RT = (N + 15) / 16;

  for (int it = 0; it < mine; ++it) {
    const int pair0 = pair0_of(it), np = min(P, p.pairs - pair0);
    const int rows = np * N;
    // in shared memory a span's first row sits `lead` elements in
    const IT* xs =
        sin + (p.tmap ? 0
                      : (int)(reinterpret_cast<uintptr_t>(
                                  ig + (size_t)pair0 * N * K) & 15) /
                            (int)sizeof(IT));
    DCGRU_PROBE_COUNT(10);
    mbar_wait(&bars[1], it & 1);
    DCGRU_PROBE_MARK(1);
    float acc[kNt][4] = {};
    // F_0 = In in the operand type, 4 columns a lane, a row a warp
    auto copy_f0 = [&]() {
      for (int r = warp; r < rows; r += p.warps + 1)
        for (int c = 4 * lane; c < K; c += 128) {
          if constexpr (sizeof(IT) == 2) {
            *reinterpret_cast<uint2*>(sf0 + r * p.ldf + c) =
                *reinterpret_cast<const uint2*>(xs + r * p.ldk + c);
          } else {
            const float4 v =
                *reinterpret_cast<const float4*>(xs + r * p.ldk + c);
            store_g2(sf0, p.ldf, r, c, v.x, v.y);
            store_g2(sf0, p.ldf, r, c + 2, v.z, v.w);
          }
        }
    };
    // F_m = Op_m In into dst per pair, every 16-node row tile of the pair,
    // In's rows past N read as zero; by the compute warps
    auto diffuse = [&](int m, FT* dst) {
      const uint4* opm = sops + (m - 1) * p.fw + lane;
      // a unit: one pair's 16 columns; B from F_0 by ldmatrix.trans (k
      // tiles past the pair's rows masked to zero), A, the pair's
      // operator tiles, kept while a warp's run of units stays on the
      // pair
      const int KT = (N + 15) / 16, ncp = (K + 15) / 16;
      const int units = np * ncp;
      const int u0 = warp * units / p.warps;
      const int u1 = (warp + 1) * units / p.warps;
      // a lane's k rows 2t, 2t+1 | 2t+8, 2t+9 of each k tile that lie
      // in the pair (B masks), and its output rows g, g+8 of each row
      // tile that do (their offsets in F, -1 past N)
      uint32_t mlo[2], mhi[2];
      int roff[2][2];
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        const int r = 16 * kt + 2 * t;
        mlo[kt] = (r < N ? 0xffffu : 0u) | (r + 1 < N ? 0xffff0000u : 0u);
        mhi[kt] = (r + 8 < N ? 0xffffu : 0u) | (r + 9 < N ? 0xffff0000u : 0u);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int n = 16 * kt + g + 8 * h2;
          roff[kt][h2] = kt < RT && n < N ? n * p.ldf : -1;
        }
      }
      const unsigned bl =
          smem_addr(sf0 + (lane & 15) * p.ldf + 8 * (lane >> 4));
      int q = u0 / ncp, c0 = 16 * (u0 - q * ncp);
      uint4 fa[2][2] = {};
      for (int u = u0; u < u1; ++u) {
        if (u == u0 || c0 == 0) {  // the pair's operator tiles
          const uint4* fr = opm + (per_clip ? q * opw : 0);
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int kt = 0; kt < 2; ++kt)
              if (rt < RT && kt < KT) fa[rt][kt] = fr[(rt * KT + kt) * 32];
        }
        float ga[2][2][4] = {};  // [row tile][n8 tile]
        const unsigned b0 = bl + 2 * (q * N * p.ldf + c0);
#pragma unroll
        for (int kt = 0; kt < 2; ++kt)
          if (kt < KT) {
            uint32_t b[4];
            ldsm_x4_t(b, b0 + 32 * kt * p.ldf);
            b[0] &= mlo[kt];
            b[1] &= mhi[kt];
            b[2] &= mlo[kt];
            b[3] &= mhi[kt];
#pragma unroll
            for (int rt = 0; rt < 2; ++rt)
              if (rt < RT) {
                const uint32_t a[4] = {fa[rt][kt].x, fa[rt][kt].y,
                                       fa[rt][kt].z, fa[rt][kt].w};
                mma_bf16_r(ga[rt][0], a, b[0], b[1]);
                mma_bf16_r(ga[rt][1], a, b[2], b[3]);
              }
          }
        FT* d = dst + q * N * p.ldf + c0 + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          if (c0 + 8 * nt + 2 * t < K)
#pragma unroll
            for (int rt = 0; rt < 2; ++rt)
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2)
                if (roff[rt][h2] >= 0)
                  *reinterpret_cast<uint32_t*>(d + roff[rt][h2] + 8 * nt) =
                      pack_bf16(ga[rt][nt][2 * h2], ga[rt][nt][2 * h2 + 1]);
        c0 += 16;
        if (c0 >= K) {
          c0 = 0;
          ++q;
        }
      }
    };
    // acc (16 rows x the warp's n8 tiles) += F_m V_m over its k tiles
    auto product = [&](int m, const FT* src) {
      const uint2* wt = reinterpret_cast<const uint2*>(dsm + L.w) +
                        ((size_t)m * p.kt * ntc + wc * (wn / 8)) * 32 + lane;
      const unsigned a0 = smem_addr(src + (16 * wr + (lane & 15)) * p.ldf +
                                    8 * (lane >> 4));
#pragma unroll 2
      for (int kk = 0; kk < p.kt; ++kk) {
        uint32_t fa[4];
        ldsm_x4(fa, a0 + 32 * kk);
#pragma unroll
        for (int j = 0; j < kNt; ++j)
          if (j < nt_live) {
            const uint2 b = wt[(kk * ntc + j) * 32];
            mma_bf16_r(acc[j], fa, b.x, b.y);
          }
      }
    };
    // per m: build F_m (m=0: F_0, the copy), then multiply it
    const bool next = producer && lane == 0 && it + 1 < mine;
    for (int m = 0; m < M; ++m) {
      DCGRU_PROBE_COUNT(11);
      __syncthreads();  // the last product has read F_m's buffer
      if (m == 1 && per_clip) mbar_wait(&bars[2], it & 1);
      DCGRU_PROBE_MARK(2);
      if (m == 0) {
        copy_f0();
        DCGRU_PROBE_MARK(3);
      } else {
        if (!producer) diffuse(m, sfm);
        DCGRU_PROBE_MARK(4);
      }
      __syncthreads();  // F_m is complete; what it was built from is read
      DCGRU_PROBE_MARK(5);
      // In is read only into F_0
      if (next && m == 0) issue_in(it + 1);
      if (next && m == M - 1 && per_clip) issue_ops(it + 1);
      if (nt_live > 0) product(m, m ? sfm : sf0);
      DCGRU_PROBE_MARK(6);
    }
    // rows < np*N, columns < C of the tile, two columns a store
    if (nt_live > 0) {
      OT* o = static_cast<OT*>(p.out) + (size_t)pair0 * N * p.C;
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = 16 * wr + g + 8 * h2, col = col0 + 8 * j + 2 * t;
          if (j < nt_live && r < rows && col < p.C)
            store_out2(o + (size_t)r * p.C + col, acc[j][2 * h2],
                       acc[j][2 * h2 + 1]);
        }
    }
    DCGRU_PROBE_MARK(7);
  }
  DCGRU_PROBE_MARK(8);
  DCGRU_PROBE_STORE;
}

// ---------------------------------------------------------------------------
// projection and dx in f32: 3xTF32 products on Hopper's warpgroup MMA, a
// block all columns
// ---------------------------------------------------------------------------
//
// A chunk is P whole (t, b) pairs, their P*N rows in 64 W (W consumer
// warpgroups of 64 rows; a warpgroup's rows may cross pairs, a pair never
// crosses a chunk). A block owns a tile of 64 NT product columns (all of
// them at the cells' widths) and walks the chunks walker, walker +
// walkers, ...; each consumer warpgroup keeps its 64 rows by 64 NT
// columns in registers (NT m64n64k8 accumulators) over every m and k.
//
// The projection (XP = sum_m (A_m x) Wx_m; dx where its m's do not fit
// one block) diffuses on the input side: the product of F_0 = In, then
// per m >= 1 F_m = Op_m In into the shared F tile and its product. dx
// (dx = sum_m A_m^T (dpre Wx_m^T)) diffuses on the output side where
// every m's columns fit one block, as the reference associates it: one
// product Y = dpre [Wx_0^T | Wx_1^T | ...] (the accumulators hold Y_m
// for every m: 3 x 64 columns at D = 64), Y into shared memory, then
// dx = Y_0 + sum_m A_m^T Y_m; the diffusion's FLOPs fall by 3H/D and dx
// needs no F tile, so more of shared memory holds weight slices.
//
// Products: a warpgroup loads its A operand (F, In) from shared memory
// into registers a k8 step at a time and splits it into TF32 hi and lo
// there; the weights are B operands in shared memory, K-major in wgmma's
// no-swizzle core-matrix layout (xin_weight_frags: per m and k8 step,
// hi's then lo's 8-column groups), through a ring of k8 slices that one
// producer warp fills by bulk copies from L2 (every block streams the
// same slices; on the output side a slice holds every m's groups). Three wgmma a k8 step and 64 columns, hi*lo, lo*hi, then
// hi*hi, into one f32 accumulator (lo*lo is below f32 rounding).
// Diffusions: exact f32 FMAs in node order, a task a pair's 4-row block
// by 4 columns spread over the consumer threads, the operators Op_m^T
// laid out by the wrapper (xin_op_rows). Copies: another producer warp
// brings each chunk's In rows (one tensor copy, rows ldk = 8 kt + 4 floats
// apart so the A fragments' reads are free of bank conflicts; a bulk copy
// a row where a row is wider than a tensor box) and, per clip, its
// operators, as soon as the chunk before has read them. Every output
// element is written once, from one thread: the same bits on every run.

constexpr int kWgGroups = 3;     // consumer warpgroups of a block, at most
constexpr int kWgNt = 3;         // 64-column accumulators a thread, at most
constexpr int kWgStages = 8;     // k8 weight slices in flight, at most
// wgmma groups in flight a warpgroup (each holds its weight slot until
// it completes, so a plan takes a slot more): the input side's three
// warpgroups keep the tensor cores fed with one each (measured fastest
// on the H100, and no spills), the output side's two with three
constexpr int kWgDepthIn = 1, kWgDepthOut = 3;
// registers a thread after setmaxnreg: the producer warpgroup gives up
// what the consumer warpgroups' accumulators take, from the block's own
// registers (128 a thread at launch): 128 * 32 + 384 * 160 = 65,536
constexpr int kWgProducerRegs = 32, kWgConsumerRegs = 160;

struct WgParams {
  const float* in;     // (pairs*N, K) f32: x, or dpre
  const float* ops;    // (a_batch, M-1, N, 4 NB) Op_m^T, rows zero-padded to
                       // whole 4-node blocks (NB = ceil(N/4))
  const float* w;      // (M, kt, 2, ng, 2, 8, 4) V_m, hi and lo planes
  float* out;          // (pairs*N, C) f32: XP, or dx
  int pairs, B, N, K, C, M, a_batch;
  int proj;            // the projection (else dx)
  int W;               // consumer warpgroups; a chunk's rows are 64 W
  int P;               // pairs a chunk
  int out_side;        // dx with the diffusion on the output side
  int dp;              // output side: D padded to 8, Y_m's columns
  int cw;              // columns of the products: C, or M dp (output side)
  int ms;              // weight passes a chunk: M, or 1 (output side)
  int nt, ctn;         // 64-column accumulators of a block; column tiles
  int kt;              // k8 steps of one pass (K padded to 8)
  int ldk;             // row stride of In and F in shared memory, floats
  int ldy;             // output side: row stride of Y, floats
  int tmap;            // In by the 2-D tensor map (ldk <= 256); else a bulk
                       // copy a row
  int ow;              // 16-byte words of one operator's rows: N * NB
  int stages;          // slots of the weight ring
  int walkers;         // blocks of one column tile
};

// Byte offsets of a block's shared memory: the weight ring (slots of
// 64 nt columns by one k8 step, hi then lo: 4096 nt bytes), the chunk's
// In rows, F (64 W rows; In's A fragment reads past its rows land in F,
// and meet only output rows that are never stored), the operators (one
// set for a shared graph, a chunk's pairs' per clip) and the mbarriers
// (the ring's full and empty slots; In full and empty; shared operators).
struct WgSmem {
  int slot, in, f, ops, bar, total;
  __host__ __device__ WgSmem(const WgParams& p) {
    slot = 4096 * p.nt;
    in = p.stages * slot;
    f = in + p.P * p.N * p.ldk * 4;
    ops = f + (p.out_side ? p.P * p.N * p.ldy : 64 * p.W * p.ldk) * 4;
    bar = align16(ops + (p.M > 1 ? (p.a_batch == 1 ? 1 : p.P) *
                                       (p.M - 1) * p.ow * 16
                                 : 0));
    total = bar + (2 * p.stages + 3) * 8;
  }
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the consumer warpgroups' barrier (the producer warps take no part)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// A wgmma shared-memory descriptor, no swizzle: the tile's 8-row by
// 16-byte core matrices `lbo` bytes apart along K and `sbo` bytes apart
// along M or N.
__device__ __forceinline__ uint64_t wg_desc(const void* p, unsigned lbo,
                                            unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending)
               : "memory");
}

// d (64 x 64, the warpgroup's; warp w rows 16 w.., lane (g, t) rows g and
// g+8, columns 8 j + 2 t and +1 in d[4 j..4 j+3]) (+)= a b: a the
// warpgroup's 64 x 8 A fragments in registers (warp w rows 16 w..; lane
// (g, t) holds (g, t), (g+8, t), (g, t+4), (g+8, t+4)), b 8 x 64 K-major
// in shared memory. scale_d 0 ignores d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// the accumulators as the wgmma left them: no read moves above the wait
__device__ __forceinline__ void wg_fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// PROJ: In = x, Op_m = A_m, V_m = Wx_m, out = XP; else In = dpre, Op_m =
// A_m^T, V_m = Wx_m^T, out = dx; both f32 and the same code (PROJ names
// the instance, so a trace tells them apart). Warps 0..4W-1 are the
// consumer warpgroups; of the producer warpgroup, warp 4W copies In and
// the operators, warp 4W+1 the weight slices.
template <bool PROJ, int NT, bool OUT>
__global__ void __launch_bounds__(128 * (kWgGroups + 1), 1)
    xin_bulk_tf32_wgmma_kernel(const WgParams p,
                               const __grid_constant__ CUtensorMap imap) {
  constexpr int kDepth = OUT ? kWgDepthOut : kWgDepthIn;
  extern __shared__ __align__(128) unsigned char dsm[];
  const WgSmem L(p);
  const int N = p.N, K = p.K, M = p.M, P = p.P, ldk = p.ldk;
  const int S = p.stages, consumers = 128 * p.W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  DCGRU_PROBE_START;

  float* sin = reinterpret_cast<float*>(dsm + L.in);
  float* sf = reinterpret_cast<float*>(dsm + L.f);
  uint4* sops = reinterpret_cast<uint4*>(dsm + L.ops);
  uint64_t* full = reinterpret_cast<uint64_t*>(dsm + L.bar);
  uint64_t* empty = full + S;
  uint64_t* in_full = empty + S;
  uint64_t* in_empty = in_full + 1;
  uint64_t* ops_full = in_full + 2;
  const int ctile = blockIdx.x % p.ctn, walker = blockIdx.x / p.ctn;
  const int chunks = (p.pairs + P - 1) / P;
  const int mine =
      walker < chunks ? (chunks - walker + p.walkers - 1) / p.walkers : 0;
  const bool per_clip = M > 1 && p.a_batch > 1;
  const unsigned opw = (M - 1) * p.ow;  // 16-byte words of a clip's ops
  auto pair0_of = [&](int it) { return (walker + it * p.walkers) * P; };

  // zero every buffer once: In's and F's pad columns stay zero
  for (int i = threadIdx.x; i < L.total / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(dsm)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s]);
      mbar_init(&empty[s], 4 * p.W);
    }
    mbar_init(in_full);
    mbar_init(in_empty, 4 * p.W);
    mbar_init(ops_full);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the 8-column groups of a slot: the tile's of V_m, or (the output
  // side, one tile) every V_m's side by side
  const int ngm = (p.C + 7) / 8;  // 8-column groups of one V_m
  const int g0 = ctile * 8 * NT, gl = min(8 * NT, (OUT ? M : 1) * ngm - g0);
  if (warp >= 4 * p.W) {
    // the producers' warpgroup gives up registers to the consumers'
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kWgProducerRegs));
    if (warp == 4 * p.W) {
      // In (one tensor copy, or a bulk copy a row spread over the lanes)
      // and the operators
      if (mine > 0 && lane == 0 && M > 1 && !per_clip) {
        mbar_expect(ops_full, opw * 16);
        bulk_copy(sops, p.ops, opw * 16, ops_full);
      }
      for (int it = 0; it < mine; ++it) {
        const int pair0 = pair0_of(it), np = min(P, p.pairs - pair0);
        const int rows = np * N;
        if (it > 0) mbar_wait(in_empty, (it - 1) & 1);
        const int ob = per_clip ? np * opw * 16 : 0;
        if (p.tmap) {
          if (lane == 0) {
            mbar_expect(in_full, P * N * ldk * 4 + ob);
            tensor_copy(sin, &imap, 0, pair0 * N, in_full);
          }
        } else {
          if (lane == 0) mbar_expect(in_full, rows * K * 4 + ob);
          __syncwarp();
          const float* src = p.in + (size_t)pair0 * N * K;
          for (int r = lane; r < rows; r += 32)
            bulk_copy(sin + r * ldk, src + (size_t)r * K, K * 4, in_full);
        }
        if (lane == 0 && per_clip)
          for (int q = 0, b = pair0 % p.B; q < np; b = 0) {
            const int run = min(np - q, p.B - b);
            bulk_copy(sops + q * opw, p.ops + (size_t)b * opw * 4,
                      run * opw * 16, in_full);
            q += run;
          }
      }
    } else if (warp == 4 * p.W + 1 && lane == 0) {
      // the weight slices, in the order the products take them
      int q = 0;
      for (int it = 0; it < mine; ++it)
        for (int mk = 0; mk < p.ms * p.kt; ++mk, ++q) {
          const int s = q % S;
          mbar_wait(&empty[s], ((q / S) & 1) ^ 1);
          mbar_expect(&full[s], 2 * gl * 256);
          unsigned char* dst = dsm + s * L.slot;
          // (m, k8 step) planes of V_m's groups: hi, then lo
          auto copy = [&](int m, int kk, int g, int n, int at) {
            const float* hi =
                p.w + ((size_t)(m * p.kt + kk) * 2 * ngm + g) * 64;
            bulk_copy(dst + at * 256, hi, n * 256, &full[s]);
            bulk_copy(dst + L.slot / 2 + at * 256, hi + (size_t)ngm * 64,
                      n * 256, &full[s]);
          };
          if (OUT)
            for (int m = 0; m < M; ++m) copy(m, mk, 0, ngm, m * ngm);
          else
            copy(mk / p.kt, mk % p.kt, g0, gl, 0);
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kWgConsumerRegs));

    // a consumer: rows r0 and r0 + 8 of the chunk in its A fragments
    const int r0 = 16 * warp + g;
    float acc[NT][32] = {};
    int q = 0;    // wgmma groups issued (a group a k8 step: one weight slice)
    int rel = 0;  // groups whose weight slots are released
    auto release_upto = [&](int upto) {
      for (; rel < upto; ++rel) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[rel % S]);
      }
    };
    // F_m = Op_m In per pair (rows past N and columns past K untouched) in
    // f32 FMAs, each sum in node order. A task is one pair's 4-row block by
    // 4 columns, the consumer threads' tasks running along the columns (In
    // rows' 16-byte loads side by side, Op_m^T's rows near-broadcast)
    const int NB = (N + 3) / 4, CQ = K / 4, per_pair = NB * CQ;
    auto diffuse = [&](int m, int np) {
      const float4* opm = reinterpret_cast<const float4*>(sops) +
                          (size_t)(m - 1) * N * NB;
      for (int task = threadIdx.x; task < np * per_pair; task += consumers) {
        const int pq = task / per_pair, rem = task - pq * per_pair;
        const int nb = rem / CQ, c = 4 * (rem - nb * CQ);
        const float4* op = opm + (per_clip ? (size_t)pq * opw : 0) + nb;
        const float* src = sin + pq * N * ldk + c;
        float f[4][4] = {};
#pragma unroll 4
        for (int j = 0; j < N; ++j) {
          const float4 w = op[j * NB];
          const float4 v = *reinterpret_cast<const float4*>(src + j * ldk);
          const float wr[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            f[r][0] = fmaf(wr[r], v.x, f[r][0]);
            f[r][1] = fmaf(wr[r], v.y, f[r][1]);
            f[r][2] = fmaf(wr[r], v.z, f[r][2]);
            f[r][3] = fmaf(wr[r], v.w, f[r][3]);
          }
        }
        float* dst = sf + (pq * N + 4 * nb) * ldk + c;
        const int nr = min(4, N - 4 * nb);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (r < nr)
            *reinterpret_cast<float4*>(dst + r * ldk) =
                make_float4(f[r][0], f[r][1], f[r][2], f[r][3]);
      }
    };
    // acc (+)= src's rows by V_m over every k8 step, kDepth groups in
    // flight (each its own A registers); the chunk's first group sets acc
    auto product = [&](const float* src, bool first) {
      const float* a0 = src + r0 * ldk + t;
      uint32_t ah[kDepth][4], al[kDepth][4];
      for (int k0 = 0; k0 < p.kt; k0 += kDepth) {
#pragma unroll
        for (int i = 0; i < kDepth; ++i) {
          const int kk = k0 + i;
          if (kk < p.kt) {
            const int s = q % S;
            split_tf32(a0[8 * kk], ah[i][0], al[i][0]);
            split_tf32(a0[8 * ldk + 8 * kk], ah[i][1], al[i][1]);
            split_tf32(a0[8 * kk + 4], ah[i][2], al[i][2]);
            split_tf32(a0[8 * ldk + 8 * kk + 4], ah[i][3], al[i][3]);
            mbar_wait(&full[s], (q / S) & 1);
            const unsigned char* slot = dsm + s * L.slot;
            const uint64_t bh = wg_desc(slot, 128, 256);
            const uint64_t bl = wg_desc(slot + L.slot / 2, 128, 256);
            const int sd = first && kk == 0 ? 0 : 1;
            wg_fence();
#pragma unroll
            for (int j = 0; j < NT; ++j)
              wgmma_tf32(acc[j], al[i], bh + 128 * j, sd);
#pragma unroll
            for (int j = 0; j < NT; ++j)
              wgmma_tf32(acc[j], ah[i], bl + 128 * j, 1);
#pragma unroll
            for (int j = 0; j < NT; ++j)
              wgmma_tf32(acc[j], ah[i], bh + 128 * j, 1);
            wg_commit();
            wg_wait<kDepth - 1>();
            ++q;
            release_upto(q - kDepth + 1);
          }
        }
      }
    };
    auto release_in = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(in_empty);
    };

    if (mine > 0 && M > 1 && !per_clip) mbar_wait(ops_full, 0);
    DCGRU_PROBE_MARK(0);
    if constexpr (OUT) {
      // dx, the output side: Y = In [V_0 | V_1 | ...] in the accumulators,
      // into shared memory (F's place, the chunk's rows); then dx = Y_0 +
      // sum_m Op_m Y_m in f32 FMAs in node order, a task one pair's 4-row
      // block by 4 columns, as the input side's diffusion
      const int dp = p.dp, ldy = p.ldy, DQ = p.C / 4, out_tasks = NB * DQ;
      const float4* sop = reinterpret_cast<const float4*>(sops);
      for (int it = 0; it < mine; ++it) {
        const int pair0 = pair0_of(it), np = min(P, p.pairs - pair0);
        const int rows = np * N;
        DCGRU_PROBE_COUNT(10);
        mbar_wait(in_full, it & 1);
        DCGRU_PROBE_MARK(1);
        product(sin, true);
        DCGRU_PROBE_MARK(6);
        wg_wait<0>();
#pragma unroll
        for (int j = 0; j < NT; ++j) wg_fence_acc(acc[j]);
        release_upto(q);
        // In is read; per-clip operators share its copy and are read below
        if (!per_clip) release_in();
        DCGRU_PROBE_MARK(3);
        consumers_sync(consumers);  // the last chunk's diffusion has read Y
        DCGRU_PROBE_MARK(2);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int col = 64 * j + 8 * i + 2 * t;
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int r = r0 + 8 * h2;
              if (r < rows && col < p.cw)
                *reinterpret_cast<float2*>(sf + r * ldy + col) =
                    make_float2(acc[j][4 * i + 2 * h2],
                                acc[j][4 * i + 2 * h2 + 1]);
            }
          }
        consumers_sync(consumers);  // Y is complete
        DCGRU_PROBE_MARK(5);
        float* o = p.out + (size_t)pair0 * N * p.C;
        for (int task = threadIdx.x; task < np * out_tasks; task += consumers) {
          const int pq = task / out_tasks, rem = task - pq * out_tasks;
          const int nb = rem / DQ, c = 4 * (rem - nb * DQ);
          const float* y = sf + pq * N * ldy + c;
          float f[4][4] = {};
          for (int m = 1; m < M; ++m) {
            const float4* op = sop + (per_clip ? (size_t)pq * opw : 0) +
                               (size_t)(m - 1) * p.ow + nb;
            const float* ym = y + m * dp;
#pragma unroll 4
            for (int jn = 0; jn < N; ++jn) {
              const float4 w = op[jn * NB];
              const float4 v = *reinterpret_cast<const float4*>(ym + jn * ldy);
              const float wr[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                f[r][0] = fmaf(wr[r], v.x, f[r][0]);
                f[r][1] = fmaf(wr[r], v.y, f[r][1]);
                f[r][2] = fmaf(wr[r], v.z, f[r][2]);
                f[r][3] = fmaf(wr[r], v.w, f[r][3]);
              }
            }
          }
          const int nr = min(4, N - 4 * nb);
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (r < nr) {
              const int row = pq * N + 4 * nb + r;
              const float4 y0 =
                  *reinterpret_cast<const float4*>(sf + row * ldy + c);
              *reinterpret_cast<float4*>(o + (size_t)row * p.C + c) =
                  make_float4(y0.x + f[r][0], y0.y + f[r][1], y0.z + f[r][2],
                              y0.w + f[r][3]);
            }
        }
        if (per_clip) release_in();
        DCGRU_PROBE_MARK(4);
      }
    } else {
      // dx on the input side adds each m's product into an f32 register
      // sum (the tensor cores add without rounding to nearest, so one
      // accumulator over every m and k drifts: dcgru_common.cuh); the
      // projection's accumulators leave no registers for it
      constexpr bool kFlush = !PROJ;
      float sum[NT][32] = {};
      auto flush = [&]() {
        if constexpr (kFlush) {
          wg_wait<0>();
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            wg_fence_acc(acc[j]);
#pragma unroll
            for (int e = 0; e < 32; ++e) sum[j][e] += acc[j][e];
          }
        }
      };
      float (&tot)[NT][32] = kFlush ? sum : acc;
      for (int it = 0; it < mine; ++it) {
        const int pair0 = pair0_of(it), np = min(P, p.pairs - pair0);
        const int rows = np * N;
        DCGRU_PROBE_COUNT(10);
        mbar_wait(in_full, it & 1);
        DCGRU_PROBE_MARK(1);
        if constexpr (kFlush) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 32; ++e) sum[j][e] = 0.0f;
        }
        product(sin, true);
        flush();
        if (M == 1) release_in();
        DCGRU_PROBE_MARK(6);
        for (int m = 1; m < M; ++m) {
          DCGRU_PROBE_COUNT(11);
          consumers_sync(consumers);  // the last product has read F
          DCGRU_PROBE_MARK(2);
          diffuse(m, np);
          if (m == M - 1) release_in();
          DCGRU_PROBE_MARK(4);
          consumers_sync(consumers);  // F_m is complete
          DCGRU_PROBE_MARK(5);
          product(sf, kFlush);
          flush();
          DCGRU_PROBE_MARK(6);
        }
        wg_wait<0>();
#pragma unroll
        for (int j = 0; j < NT; ++j) wg_fence_acc(acc[j]);
        release_upto(q);
        DCGRU_PROBE_MARK(3);
        // rows < np*N, columns < C of the tile, two columns a store
        float* o = p.out + (size_t)pair0 * N * p.C;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int col = 64 * (ctile * NT + j) + 8 * i + 2 * t;
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int r = r0 + 8 * h2;
              if (r < rows && col < p.C)
                *reinterpret_cast<float2*>(o + (size_t)r * p.C + col) =
                    make_float2(tot[j][4 * i + 2 * h2],
                                tot[j][4 * i + 2 * h2 + 1]);
            }
          }
        DCGRU_PROBE_MARK(7);
      }
    }
    DCGRU_PROBE_MARK(8);
    DCGRU_PROBE_STORE;
  }
}

// ---------------------------------------------------------------------------
// dW: (S, slab) f32 partials, one per split of the (t, b) pairs
// ---------------------------------------------------------------------------
//
// Per clip, (A_m F)^T dpre = F^T (A_m^T dpre): dW_m = sum over the pairs of
// [x | h_prev | r h_prev]^T G_m with G_m = A_m^T dpre (G_0 = dpre). A block
// owns one m, one tile of up to 64 dpre columns (all gate or all
// candidate columns) and a group of up to kDwTiles 16-feature tiles of
// [x | h_prev] (gate) or [x | r h_prev] (candidate), one warp a tile.
// Per chunk of whole pairs it diffuses its dpre tile once, on the tensor
// cores, into G^T in the operand type; every feature tile's product reads
// that G^T, and the raw features need no diffusion.

constexpr int kDwCols = 64;         // dpre columns of a block: 8 n8 tiles
constexpr int kDwTiles = 11;        // 16-feature tiles of a block, at most
constexpr int kDwMaxPairs = 6;      // pairs of a chunk, at most
// the split rule's constants (ops/cuda_recurrent.py, dw_splits, which
// chooses the splits; dcgru_xin_dw takes their count)
constexpr int kDwWaveBlocks = 132;  // blocks of a wave: the H100's SMs, a
                                    // constant (the sums' order follows
                                    // from the shape alone)
constexpr int kDwSplitPairs = 192;  // (t, b) pairs of a split, at most

struct DwParams {
  const void* x;       // (T, B, N, D)
  const void* h_prev;  // (T, B, N, H)
  const void* ru;      // (T, B, N, 2H)
  const float* dpre;   // (T, B, N, 3H) f32
  const uint4* frags;  // (M-1, a_batch, fw) A_m^T as mma A fragments
  float* part;         // (splits, slab)
  int pairs, B, N, D, H, M, a_batch;
  int pps;             // pairs a split
  int P, RB;           // pairs a chunk; rows a chunk, padded to 16
  int fw;              // 16-byte words of one operator's fragments
  int ct_g, ct;        // column tiles of the 2H gate columns; of all 3H
  int xt, ft, fg;      // feature tiles of x; of x and h; groups of them
  int warps;           // a block's warps: one a feature tile, then the
                       // producer
};

// the smallest row stride >= rb that is r modulo 16 (elements)
__host__ __device__ inline int dw_ld(int rb, int r) {
  return rb + (r - rb % 16 + 16) % 16;
}

// Byte offsets of a block's shared memory: x and h_prev double-buffered
// (the product of chunk i reads them while chunk i+1 arrives); ru, dpre's
// tile and the chunk's operator fragments single (the diffusion reads
// them before the product starts, and the next chunk's are issued then;
// double-buffering dpre too read no faster on the H100);
// G^T and the h part of the features (h_prev, or r h_prev) in the
// operand type, rows padded for conflict-free fragment reads; db's partial
// sums; the copies' mbarriers (x and h_prev per buffer; the rest).
struct DwSmem {
  int x, h, r, dp, op, gt, rh, db, bar, total;
  int xn, hn, rn;  // stream elements of one x / h_prev / ru buffer
  int ldp, ldg;    // row strides of dpre's tile and of G^T
  int ldo;         // row stride of the h part: 8 mod 32 elements
  __host__ __device__ DwSmem(const DwParams& p, int sb) {
    const bool bf = sb == 2;
    // slack: a span's copy starts up to 12 bytes before its first row and
    // ends padded to 16 bytes; a feature tile's fragment reads run up to
    // 15 features past the last row's end (their output rows are dropped)
    xn = p.RB * p.D + 32;
    hn = p.RB * p.H + 32;
    rn = p.RB * 2 * p.H + 32;
    // conflict-free fragment reads: dpre's B pairs (bf16: rows 2t, 2t+1;
    // f32: rows t), G^T's 32-bit B words (bf16) or 8-byte hi|lo pairs
    // (f32), and the padded h part's A words (8 mod 32 elements)
    ldp = kDwCols + (bf ? 4 : 8);
    ldg = dw_ld(p.RB, bf ? 8 : 4);
    ldo = p.H + (40 - p.H % 32) % 32;
    x = 0;
    h = x + align16(2 * xn * sb);
    r = h + align16(2 * hn * sb);
    dp = (r + rn * sb + 127) & ~127;  // a tensor copy's destination
    op = dp + p.RB * ldp * 4;
    gt = op + p.P * p.fw * 16;
    rh = gt + align16(kDwCols * ldg * (bf ? 2 : 8));
    db = rh + align16((p.RB * ldo + 16) * sb);
    bar = db + kDwMaxPairs * kDwCols * 4;  // blockDim / kDwCols <= 6
    total = bar + 32;
  }
};

template <typename S, bool BF16>
// dmap: dpre (T*B*N rows, 3H columns) f32 as a 2-D tensor map whose box
// is a chunk's P*N rows by ldp columns (dw_dpre_map)
__global__ void __launch_bounds__(32 * (kDwTiles + 1)) xin_dw_kernel(
    const DwParams p, const __grid_constant__ CUtensorMap dmap) {
  using GT = typename std::conditional<BF16, __nv_bfloat16, float2>::type;
  extern __shared__ __align__(128) unsigned char dsm[];
  const DwSmem L(p, sizeof(S));
  const int N = p.N, D = p.D, H = p.H, M = p.M, H3 = 3 * H;
  const int RB = p.RB, P = p.P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nwarps = blockDim.x >> 5;
  // the last warp issues the bulk copies (a copy holds its thread ~60-800
  // clocks) and has no feature tile; the diffusion runs on the others
  const int producer = nwarps - 1;

  // the block: (m, column tile, feature group)
  int bid = blockIdx.x;
  const int fgi = bid % p.fg;
  bid /= p.fg;
  const int ctile = bid % p.ct, m = bid / p.ct;
  const bool gate = ctile < p.ct_g;
  const int gcol = gate ? ctile * kDwCols : 2 * H + (ctile - p.ct_g) * kDwCols;
  const int ncols = min(kDwCols, (gate ? 2 * H : H3) - gcol);
  const int nt_live = (ncols + 7) / 8;
  const bool with_db = m == 0 && fgi == 0;
  DCGRU_PROBE_START;
#ifdef DCGRU_PROBE
  // probe roles (split 0, feature group 0): m = 0 with db, m = M-1 on the
  // first gate tile, m = M-1 on the first candidate tile
  int role = -1;
  if (blockIdx.y == 0 && fgi == 0 && ctile == 0 && m == 0) role = 0;
  if (blockIdx.y == 0 && fgi == 0 && m == M - 1 && M > 1)
    role = ctile == 0 ? 1 : ctile == p.ct_g ? 2 : -1;
#endif

  S* sx = reinterpret_cast<S*>(dsm + L.x);
  S* sh = reinterpret_cast<S*>(dsm + L.h);
  S* sr = reinterpret_cast<S*>(dsm + L.r);
  float* sdp = reinterpret_cast<float*>(dsm + L.dp);
  uint4* sop = reinterpret_cast<uint4*>(dsm + L.op);
  GT* sgt = reinterpret_cast<GT*>(dsm + L.gt);
  S* srh = reinterpret_cast<S*>(dsm + L.rh);
  float* sdb = reinterpret_cast<float*>(dsm + L.db);
  const S* xg = static_cast<const S*>(p.x);
  const S* hg = static_cast<const S*>(p.h_prev);
  const S* rug = static_cast<const S*>(p.ru);

  const int ps = blockIdx.y * p.pps;
  const int pe = min(p.pairs, ps + p.pps);
  const int nchunks = pe > ps ? (pe - ps + P - 1) / P : 0;

  uint64_t* bars = reinterpret_cast<uint64_t*>(dsm + L.bar);
  const S* xend = xg + (size_t)p.pairs * N * D;
  const S* hend = hg + (size_t)p.pairs * N * H;
  const S* ruend = rug + (size_t)p.pairs * N * 2 * H;
  // the spans of chunk `it`'s rows: x, h_prev, ru; in shared memory a
  // chunk's first row sits `lead` elements into its buffer
  auto rows0 = [&](int it) { return (size_t)(ps + it * P) * N; };
  auto lead = [](const S* src) {
    return (int)(reinterpret_cast<uintptr_t>(src) & 15) / (int)sizeof(S);
  };
  auto live_rows = [&](int it) { return min(P, pe - (ps + it * P)) * N; };
  auto span_x = [&](int it) {
    return span16(xg + rows0(it) * D, live_rows(it) * D * (int)sizeof(S),
                  xend);
  };
  auto span_h = [&](int it) {
    return span16(hg + rows0(it) * H, live_rows(it) * H * (int)sizeof(S),
                  hend);
  };
  auto span_r = [&](int it) {
    return span16(rug + rows0(it) * 2 * H,
                  live_rows(it) * 2 * H * (int)sizeof(S), ruend);
  };
  // x and h_prev rows of chunk `it` into buffer s
  auto issue_xh = [&](int it, int s) {
    if (warp != producer || lane != 0) return;
    const Span a = span_x(it), b = span_h(it);
    mbar_expect(&bars[s], a.bytes + b.bytes);
    copy_span(sx + s * L.xn, a, &bars[s]);
    copy_span(sh + s * L.hn, b, &bars[s]);
  };
  // dpre's column tile (one 2-D tensor copy: P*N rows by ldp columns,
  // rows and columns past the chunk's unused), ru (candidate tiles) and
  // the pairs' operators, by the producer
  auto issue_rest = [&](int it) {
    if (warp != producer || lane != 0) return;
    const int pair0 = ps + it * P, np = min(P, pe - pair0);
    Span r{};
    if (!gate) r = span_r(it);
    mbar_expect(&bars[2], P * N * L.ldp * 4 + r.bytes +
                              (m > 0 ? np * p.fw * 16 : 0));
    tensor_copy(sdp, &dmap, gcol, (int)rows0(it), &bars[2]);
    if (!gate) copy_span(sr, r, &bars[2]);
    if (m > 0)
      for (int q = 0; q < np; ++q) {
        const int b = p.a_batch == 1 ? 0 : (pair0 + q) % p.B;
        bulk_copy(sop + q * p.fw,
                  p.frags + ((size_t)(m - 1) * p.a_batch + b) * p.fw,
                  p.fw * 16, &bars[2]);
      }
  };

  // zero every buffer once: pad rows and columns stay zero
  for (int i = threadIdx.x; i < L.total / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(dsm)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (nchunks) {
    issue_xh(0, 0);
    issue_rest(0);
  }
  DCGRU_PROBE_MARK(0);

  // this warp's feature tile: of x, or of h_prev / r h_prev
  const int tile = fgi * kDwTiles + warp;
  const bool mine = warp < kDwTiles && tile < p.ft;
  const bool xtile = tile < p.xt;
  const int i0 = 16 * (xtile ? tile : tile - p.xt);
  const int lda = xtile ? D : gate ? H : L.ldo;
  float acc[8][4] = {}, sum[8][4] = {};
  float dbp = 0.0f;

  for (int it = 0; it < nchunks; ++it) {
    const int s = it & 1;
    const int np = min(P, pe - (ps + it * P));
    DCGRU_PROBE_COUNT(10);
    mbar_wait(&bars[s], (it >> 1) & 1);
    mbar_wait(&bars[2], it & 1);
    {
      // the buffers' rows past the chunk's pairs hold older rows (at
      // another lead): zero, since they meet G's zero rows and a NaN there
      // would spread (r h_prev's are zeroed where it is built)
      S* xs = sx + s * L.xn + lead(xg + rows0(it) * D);
      for (int i = np * N * D + threadIdx.x; i < RB * D; i += blockDim.x)
        xs[i] = from_f<S>(0.0f);
      if (gate) {
        S* hs = sh + s * L.hn + lead(hg + rows0(it) * H);
        for (int i = np * N * H + threadIdx.x; i < RB * H; i += blockDim.x)
          hs[i] = from_f<S>(0.0f);
      }
      fence_proxy_async();
    }
    DCGRU_PROBE_MARK(1);
    __syncthreads();  // the chunk has arrived; G^T and r h are free
    DCGRU_PROBE_MARK(2);
    if (it + 1 < nchunks) issue_xh(it + 1, s ^ 1);
    DCGRU_PROBE_MARK(3);

    // G^T of this chunk (absent pairs' rows zero), db, r h_prev
    if (m == 0) {
      // G_0 = dpre, two rows a store: a thread takes column j and every
      // rstep-th row pair, and keeps its column's db sum
      const int j = threadIdx.x % kDwCols, rstep = blockDim.x / kDwCols;
      if (j < ncols && threadIdx.x < rstep * kDwCols)
        for (int i = threadIdx.x / kDwCols; 2 * i < P * N; i += rstep) {
          const int ra = 2 * i;
          const float va = ra < np * N ? sdp[ra * L.ldp + j] : 0.0f;
          const float vb = ra + 1 < np * N ? sdp[(ra + 1) * L.ldp + j] : 0.0f;
          dbp += va;
          dbp += vb;
          store_g2(sgt, L.ldg, j, ra, va, vb);
        }
    } else {
      // a unit: one pair's 8 columns, G (16-node row tiles) = A_m^T
      // (row tiles x depth tiles) dpre, dpre's rows past N read as zero.
      // A warp takes a contiguous run of units, so consecutive units
      // mostly share a pair's operator fragments.
      const int RT = (N + 15) / 16;
      const int units = P * nt_live, cw = nwarps - 1;
      const int u0 = warp * units / cw;
      const int u1 = warp < cw ? (warp + 1) * units / cw : u0;
      int fq = -1;       // the pair whose fragments fc holds (bf16)
      uint4 fc[2][2] = {};
      for (int u = u0; u < u1; ++u) {
        const int q = u / nt_live, c = u - q * nt_live;
        if (q >= np) {
          for (int e = lane; e < 8 * N; e += 32)
            store_g(sgt, L.ldg, 8 * c + e / N, q * N + e % N, 0.0f);
          continue;
        }
        const float* dq = sdp + q * N * L.ldp + 8 * c + g;
        auto dv = [&](int n) { return n < N ? dq[n * L.ldp] : 0.0f; };
        const uint4* fr = sop + q * p.fw + lane;
        // f32: the small terms (lo hi, hi lo) apart from hi hi, so the
        // chains are half as long; G = big + small
        float gacc[2][4] = {}, gsml[2][4] = {};
        if constexpr (BF16) {
          const int KT = (N + 15) / 16;
          if (q != fq) {  // the pair's A_m^T tiles, kept for its run
            fq = q;
#pragma unroll
            for (int rt = 0; rt < 2; ++rt)
#pragma unroll
              for (int kt = 0; kt < 2; ++kt)
                if (rt < RT && kt < KT) fc[rt][kt] = fr[(rt * KT + kt) * 32];
          }
#pragma unroll
          for (int kt = 0; kt < 2; ++kt)
            if (kt < KT) {
              const int n0 = 16 * kt + 2 * t;
              const uint32_t b0 = pack_bf16(dv(n0), dv(n0 + 1));
              const uint32_t b1 = pack_bf16(dv(n0 + 8), dv(n0 + 9));
#pragma unroll
              for (int rt = 0; rt < 2; ++rt)
                if (rt < RT) {
                  const uint32_t fa[4] = {fc[rt][kt].x, fc[rt][kt].y,
                                          fc[rt][kt].z, fc[rt][kt].w};
                  mma_bf16_r(gacc[rt], fa, b0, b1);
                }
            }
        } else {
          const int KT = (N + 7) / 8;
          for (int kt = 0; kt < KT; ++kt) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(dv(8 * kt + t), bh0, bl0);
            split_tf32(dv(8 * kt + t + 4), bh1, bl1);
#pragma unroll
            for (int rt = 0; rt < 2; ++rt)
              if (rt < RT) {
                const uint4 h = fr[(rt * KT + kt) * 64];
                const uint4 l = fr[(rt * KT + kt) * 64 + 32];
                const uint32_t hi[4] = {h.x, h.y, h.z, h.w};
                const uint32_t lo[4] = {l.x, l.y, l.z, l.w};
                mma_tf32_r(gsml[rt], lo, bh0, bh1);
                mma_tf32_r(gsml[rt], hi, bl0, bl1);
                mma_tf32_r(gacc[rt], hi, bh0, bh1);
              }
          }
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int e = 0; e < 4; ++e) gacc[rt][e] += gsml[rt][e];
        }
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = 16 * rt + g + 8 * (e >> 1);
            if (k < N)
              store_g(sgt, L.ldg, 8 * c + 2 * t + (e & 1), q * N + k,
                      gacc[rt][e]);
          }
      }
    }
    if (!gate) {
      // r h_prev in the operand type with padded rows (a product of two
      // bf16 is exact in f32: one rounding); rows past the pairs zero.
      // 16-byte words where rows allow.
      const S* hs = sh + s * L.hn + lead(hg + rows0(it) * H);
      const S* rs = sr + lead(rug + rows0(it) * 2 * H);
      constexpr int kV = 16 / sizeof(S);  // elements of a 16-byte word
      if (H % kV == 0 && ((reinterpret_cast<uintptr_t>(hs) |
                           reinterpret_cast<uintptr_t>(rs)) & 15) == 0) {
        const int wpr = H / kV;
        for (int i = threadIdx.x; i < P * N * wpr; i += blockDim.x) {
          const int row = i / wpr, c = kV * (i - row * wpr);
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (row < np * N) {
            v = *reinterpret_cast<const uint4*>(hs + row * H + c);
            const uint4 rv =
                *reinterpret_cast<const uint4*>(rs + row * 2 * H + c);
            S* e = reinterpret_cast<S*>(&v);
            const S* re = reinterpret_cast<const S*>(&rv);
#pragma unroll
            for (int k = 0; k < kV; ++k)
              e[k] = from_f<S>(to_f(re[k]) * to_f(e[k]));
          }
          *reinterpret_cast<uint4*>(srh + row * L.ldo + c) = v;
        }
      } else {
        for (int row = warp; row < P * N; row += nwarps)
          for (int c = lane; c < H; c += 32) {
            const float v = row < np * N ? to_f(rs[row * 2 * H + c]) *
                                               to_f(hs[row * H + c])
                                         : 0.0f;
            srh[row * L.ldo + c] = from_f<S>(v);
          }
      }
    }
    DCGRU_PROBE_MARK(4);
    __syncthreads();  // G^T and r h are complete; dpre, r, A are read
    DCGRU_PROBE_MARK(5);
    if (it + 1 < nchunks) issue_rest(it + 1);
    DCGRU_PROBE_MARK(6);

    // acc (16 features x the tile's columns) += F^T G over the chunk
    if (mine) {
      const S* src = xtile  ? sx + s * L.xn + lead(xg + rows0(it) * D)
                     : gate ? sh + s * L.hn + lead(hg + rows0(it) * H)
                            : srh;
      if constexpr (BF16) {
        // B pairs (rows 2t, 2t+1 and 2t+8, 2t+9 of column 8c + g): 32-bit
        // words of G^T, conflict-free (ldg = 8 mod 16)
        const uint32_t* gw = reinterpret_cast<const uint32_t*>(sgt) +
                             ((g * L.ldg) >> 1) + t;
        const int cw = 4 * L.ldg;  // words of 8 columns
        const unsigned short* a16 =
            reinterpret_cast<const unsigned short*>(src) + i0 + g;
#pragma unroll 2
        for (int ks = 0; ks < RB; ks += 16) {
          const unsigned short* ak = a16 + (ks + 2 * t) * lda;
          const uint32_t fa[4] = {
              ak[0] | (uint32_t)ak[lda] << 16,
              ak[8] | (uint32_t)ak[lda + 8] << 16,
              ak[8 * lda] | (uint32_t)ak[9 * lda] << 16,
              ak[8 * lda + 8] | (uint32_t)ak[9 * lda + 8] << 16};
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (c < nt_live) {
              const uint32_t* bw = gw + c * cw + (ks >> 1);
              mma_bf16_r(acc[c], fa, bw[0], bw[4]);
            }
        }
      } else {
        const float2* gt2 = reinterpret_cast<const float2*>(sgt);
        const float* af = reinterpret_cast<const float*>(src) + i0 + g;
#pragma unroll 2
        for (int ks = 0; ks < RB; ks += 8) {
          const float* ak = af + (ks + t) * lda;
          uint32_t hi[4], lo[4];
          split_tf32(ak[0], hi[0], lo[0]);
          split_tf32(ak[8], hi[1], lo[1]);
          split_tf32(ak[4 * lda], hi[2], lo[2]);
          split_tf32(ak[4 * lda + 8], hi[3], lo[3]);
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (c < nt_live) {
              const float2* bp = gt2 + (8 * c + g) * L.ldg + ks + t;
              const float2 b0 = bp[0], b1 = bp[4];
              mma_tf32_r(acc[c], lo, __float_as_uint(b0.x),
                         __float_as_uint(b1.x));
              mma_tf32_r(acc[c], hi, __float_as_uint(b0.y),
                         __float_as_uint(b1.y));
              mma_tf32_r(acc[c], hi, __float_as_uint(b0.x),
                         __float_as_uint(b1.x));
            }
        }
      }
      flush(sum, acc);
    }
    DCGRU_PROBE_MARK(7);
  }

  // this split's slab: [dWxg (MD,2H) | dWxc (MD,H) | dWg (MH,2H) |
  // dWc (MH,H) | dbg (2H) | dbc (H)]
  const int MD = M * D, MH = M * H;
  float* slab = p.part + (size_t)blockIdx.y * slab_size(D, H, M);
  if (mine)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = i0 + g + (e >> 1) * 8;
        const int cl = 8 * j + 2 * t + (e & 1);  // of the tile
        const int col = gcol + cl;               // of dpre's 3H
        if (f >= (xtile ? D : H) || cl >= ncols) continue;
        float* o;
        if (xtile)
          o = col < 2 * H
                  ? slab + (size_t)(m * D + f) * 2 * H + col
                  : slab + (size_t)MD * 2 * H + (size_t)(m * D + f) * H +
                        (col - 2 * H);
        else if (gate)
          o = slab + (size_t)MD * H3 + (size_t)(m * H + f) * 2 * H + col;
        else
          o = slab + (size_t)MD * H3 + (size_t)MH * 2 * H +
              (size_t)(m * H + f) * H + (col - 2 * H);
        *o = sum[j][e];
      }
  if (with_db) {
    // db: each thread's column sum, then the row groups in order
    const int rstep = blockDim.x / kDwCols;
    if (threadIdx.x < rstep * kDwCols) sdb[threadIdx.x] = dbp;
    __syncthreads();
    if (threadIdx.x < ncols) {
      float d = 0.0f;
      for (int r = 0; r < rstep; ++r) d += sdb[r * kDwCols + threadIdx.x];
      slab[(size_t)(MD + MH) * H3 + gcol + threadIdx.x] = d;
    }
  }
  DCGRU_PROBE_MARK(8);
  DCGRU_PROBE_STORE_ROLE(role, 12);
}
// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename K, typename... Args>
int run(K kern, int smem, dim3 grid, int threads, cudaStream_t stream,
        Args... args) {
  if (smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// A tiled tensor map (cuTensorMapEncodeTiled, from the driver through the
// runtime): `rank` dims, innermost first, strides in bytes of dims 1.., a
// box per copy, parts past the tensor read as zeros. A cudaError_t.
int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
               const void* base, const cuuint64_t* dims,
               const cuuint64_t* strides, const cuuint32_t* box) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
      const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
      CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, type, rank, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The bf16 launch plan of a projection or dx shape: the column tile,
// chunk and warps with the least estimated tensor-core work a compute
// warp (the products' row tiles, and the diffusion, which every column
// tile of a chunk repeats), counting two blocks an SM where their shared
// memory fits and up to 16 warps an SM. Then one wave of blocks
// (kBulkWave a block slot of an SM). Shared bytes a block, or -1 where
// none fits. The plan, like every sum's order, follows from the shape
// alone.
int bulk_plan(BulkParams& p, int ib) {
  const int RT = ceil_div(p.N, 16), KTn = ceil_div(p.N, 16);
  p.kt = ceil_div(p.K, 16);
  p.fw = RT * KTn * 32;
  p.wb = 256;
  // F: ldmatrix rows an odd number of 16-byte words apart
  p.ldf = 16 * p.kt + 8;
  // f32 In (dx's dpre), the diffusion's B reads: rows 2t, 2t+1 of a
  // column 4 mod 16 words apart (bf16 pairs)
  const int ldk = p.K + (20 - p.K % 16) % 16;
  double best = 0.0;
  int smem = -1;
  BulkParams pick = p;
  for (int ct = 64; ct >= 8; ct /= 2) {
    const int ctn = ceil_div(p.C, ct);
    for (int P = 1; P * p.N <= kBulkRows; ++P) {
      BulkParams q = p;
      q.P = P;
      q.RB = ceil_div(P * p.N, 16) * 16;
      q.ct = ct;
      q.ctn = ctn;
      q.warps = q.RB / 16 * (ct / min(32, ct));
      if (q.RB > kBulkRows || q.warps > kBulkWarps) continue;
      q.tmap = ib == 4 && ldk <= 256 && P * p.N <= 256;
      q.ldk = q.tmap ? ldk : p.K;
      const BulkSmem L(q, ib);
      if (L.total > kMaxSmem) continue;
      const int per_sm = min(2, kSmemPerSm / (L.total + 1024));
      const double work =
          (double)q.RB / 16 / P * p.M * q.kt * ctn * (ct / 8) +
          1.0 * (p.M - 1) * RT * KTn * ceil_div(p.K, 8) * ctn;
      const double cost = work / min(16, per_sm * q.warps);
      if (smem < 0 || cost < best) {
        best = cost;
        smem = L.total;
        pick = q;
      }
    }
  }
  if (smem < 0) return -1;
  p = pick;
  const int per_sm = min(2, kSmemPerSm / (smem + 1024));
  p.walkers = max(1, min(ceil_div(p.pairs, p.P), kBulkWave * per_sm / p.ctn));
  return smem;
}

bool bulk_valid(const BulkParams& p, int D, int H, const void* w) {
  return p.N >= 1 && p.N <= kMaxNodes && p.M >= 1 && p.pairs >= 1 &&
         D >= 4 && D % 4 == 0 && H >= 4 && H % 4 == 0 && p.B >= 1 &&
         p.a_batch >= 1 && w != nullptr && (p.M == 1 || p.ops != nullptr);
}

BulkParams bulk_params(bool proj, const void* in, const void* ops,
                       int a_batch, void* out, int T, int B, int N, int D,
                       int H, int M) {
  BulkParams p{};
  p.in = in;
  p.ops = static_cast<const uint4*>(ops);
  p.out = out;
  p.pairs = T * B;
  p.B = B;
  p.N = N;
  p.K = proj ? D : 3 * H;
  p.C = proj ? 3 * H : D;
  p.M = M;
  p.a_batch = a_batch;
  return p;
}

template <bool PROJ, typename S>
int bulk(BulkParams p, const void* w, cudaStream_t stream) {
  using IT = typename std::conditional<PROJ, S, float>::type;
  const int smem = bulk_plan(p, sizeof(IT));
  if (smem < 0) return (int)cudaErrorInvalidValue;
  // the weights: (M*kt, C/8, words of an n8 tile) u32
  alignas(64) CUtensorMap wmap;
  alignas(64) CUtensorMap imap{};
  const int words = p.wb / 4, ntg = ceil_div(p.C, 8);
  const cuuint64_t wdims[3] = {(cuuint64_t)words, (cuuint64_t)ntg,
                               (cuuint64_t)(p.M * p.kt)};
  const cuuint64_t wstr[2] = {(cuuint64_t)p.wb, (cuuint64_t)ntg * p.wb};
  const cuuint32_t wbox[3] = {(cuuint32_t)words, (cuuint32_t)(p.ct / 8),
                              (cuuint32_t)(p.M * p.kt)};
  int err = encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, w, wdims,
                       wstr, wbox);
  if (err) return err;
  if (p.tmap) {
    const cuuint64_t dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.pairs * p.N};
    const cuuint64_t str[1] = {(cuuint64_t)p.K * 4};
    const cuuint32_t box[2] = {(cuuint32_t)p.ldk, (cuuint32_t)(p.P * p.N)};
    err = encode_map(&imap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, p.in, dims,
                     str, box);
    if (err) return err;
  }
  return run(xin_bulk_kernel<PROJ, S>, smem, dim3(p.walkers * p.ctn),
             32 * (p.warps + 1), stream, p, wmap, imap);
}

// The f32 launch plan of a projection or dx shape: dx's side, 64-column
// accumulators for every product column up to three (more columns take
// more column tiles), then the most warpgroups (rows of a chunk 64 W,
// P = 64 W / N pairs) and weight slots (from kWgStages down to one more
// than the groups in flight) whose shared memory fits one block an SM;
// one wave of blocks (kBulkWave). Shared bytes a block, or -1 where none
// fits. The plan, like every sum's order, follows from the shape alone.
int wg_plan(WgParams& p) {
  p.kt = ceil_div(p.K, 8);
  p.ldk = 8 * p.kt + 4;
  p.tmap = p.ldk <= 256;
  p.ow = p.N * ceil_div(p.N, 4);
  // dx moves its diffusion to the output side where every m's columns
  // fit one block's accumulators: Y = dpre [V_0 | V_1 | ...], then
  // dx = Y_0 + sum_m A_m^T Y_m (a weight slot holds every V_m's groups)
  p.dp = 8 * ceil_div(p.C, 8);
  p.out_side = !p.proj && p.M * p.dp <= 64 * kWgNt;
  p.cw = p.out_side ? p.M * p.dp : p.C;
  p.ms = p.out_side ? 1 : p.M;
  p.ldy = p.M * p.dp + 4;
  // (dx on the input side keeps a register sum beside one accumulator)
  p.nt = p.proj || p.out_side ? min(kWgNt, ceil_div(p.cw, 64)) : 1;
  p.ctn = ceil_div(p.cw, 64 * p.nt);
  const int smin = (p.out_side ? kWgDepthOut : kWgDepthIn) + 1;
  for (int W = kWgGroups; W >= 1; --W)
    for (int S = kWgStages; S >= smin; --S) {
      WgParams q = p;
      q.W = W;
      q.P = 64 * W / p.N;
      q.stages = S;
      const int smem = WgSmem(q).total;
      if (q.P < 1 || smem > kMaxSmem) continue;
      p = q;
      p.walkers = max(1, min(ceil_div(p.pairs, p.P), kBulkWave / p.ctn));
      return smem;
    }
  return -1;
}

WgParams wg_params(bool proj, const void* in, const void* ops, int a_batch,
                   const void* w, void* out, int T, int B, int N, int D,
                   int H, int M) {
  WgParams p{};
  p.in = static_cast<const float*>(in);
  p.ops = static_cast<const float*>(ops);
  p.w = static_cast<const float*>(w);
  p.out = static_cast<float*>(out);
  p.pairs = T * B;
  p.B = B;
  p.N = N;
  p.K = proj ? D : 3 * H;
  p.C = proj ? 3 * H : D;
  p.M = M;
  p.a_batch = a_batch;
  p.proj = proj;
  return p;
}

// the kernel instance of a plan: the projection, or dx with its diffusion
// on the input or the output side; its accumulators
template <int NT>
auto wg_kernel(const WgParams& p) {
  return p.proj       ? xin_bulk_tf32_wgmma_kernel<true, NT, false>
         : p.out_side ? xin_bulk_tf32_wgmma_kernel<false, NT, true>
                      : xin_bulk_tf32_wgmma_kernel<false, 1, false>;
}

template <int NT>
int wg_launch(const WgParams& p, int smem, const CUtensorMap& imap,
              cudaStream_t stream) {
  return run(wg_kernel<NT>(p), smem, dim3(p.walkers * p.ctn),
             128 * (p.W + 1), stream, p, imap);
}

int wg(WgParams p, cudaStream_t stream) {
  const int smem = wg_plan(p);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  // In (pairs*N rows, K columns) as a 2-D tensor map whose box is a
  // chunk's P*N rows by ldk columns (the columns past K read as zeros)
  alignas(64) CUtensorMap imap{};
  if (p.tmap) {
    const cuuint64_t dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.pairs * p.N};
    const cuuint64_t str[1] = {(cuuint64_t)p.K * 4};
    const cuuint32_t box[2] = {(cuuint32_t)p.ldk, (cuuint32_t)(p.P * p.N)};
    const int err = encode_map(&imap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                               p.in, dims, str, box);
    if (err) return err;
  }
  return p.nt == 1   ? wg_launch<1>(p, smem, imap, stream)
         : p.nt == 2 ? wg_launch<2>(p, smem, imap, stream)
                     : wg_launch<3>(p, smem, imap, stream);
}

// The dW launch plan of a shape: its tiles and warps, and the chunk (at
// most kDwMaxPairs whole pairs, rows padded to 16) with the least padding
// whose shared memory fits. Shared bytes, or -1 where none fits. The
// plan, like the split count, follows from the shape alone.
int dw_plan(DwParams& p, int sb) {
  const int RT = (p.N + 15) / 16;
  p.fw = sb == 2 ? RT * ((p.N + 15) / 16) * 32 : RT * ((p.N + 7) / 8) * 64;
  p.ct_g = ceil_div(2 * p.H, kDwCols);
  p.ct = p.ct_g + ceil_div(p.H, kDwCols);
  p.xt = ceil_div(p.D, 16);
  p.ft = p.xt + ceil_div(p.H, 16);
  p.fg = ceil_div(p.ft, kDwTiles);
  const int caps[] = {96, 80, 64, 48, 32, 16};
  for (int cap : caps) {
    const Geom g = geom(p.N, min(cap, kDwMaxPairs * p.N));
    if (g.RB > cap) continue;
    p.P = g.P;
    p.RB = g.RB;
    // at least P warps: db's (pair, column) tasks, two a thread; and
    // the producer; at D = 0 in f32 (few feature tiles, a diffusion in
    // 3xTF32) every warp a tile could have, for the diffusion (faster on
    // an H100; in bf16 the extra warps gained nothing)
    p.warps = max(max(min(p.ft, kDwTiles), p.P),
                  p.D == 0 && sb == 4 ? kDwTiles : 0) + 1;
    const int bytes = DwSmem(p, sb).total;
    if (bytes <= kMaxSmem) return bytes;
  }
  return -1;
}

// The 2-D tensor map of dpre (rows x 3H f32) whose box is a chunk's P*N
// rows by ldp columns. A cudaError_t.
int dw_dpre_map(CUtensorMap* map, const DwParams& p, int ldp) {
  const cuuint64_t dims[2] = {(cuuint64_t)(3 * p.H),
                              (cuuint64_t)p.pairs * p.N};
  const cuuint64_t strides[1] = {(cuuint64_t)(3 * p.H) * 4};
  const cuuint32_t box[2] = {(cuuint32_t)ldp, (cuuint32_t)(p.P * p.N)};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, p.dpre, dims,
                    strides, box);
}

template <typename S>
int dw(DwParams p, int splits, cudaStream_t stream) {
  const int smem = dw_plan(p, sizeof(S));
  if (smem < 0) return (int)cudaErrorInvalidValue;
  p.pps = ceil_div(p.pairs, splits);
  alignas(64) CUtensorMap dmap;
  const int err = dw_dpre_map(&dmap, p, DwSmem(p, sizeof(S)).ldp);
  if (err) return err;
  const dim3 grid(p.M * p.ct * p.fg, splits);
  return run(xin_dw_kernel<S, sizeof(S) == 2>, smem, grid, 32 * p.warps,
             stream, p, dmap);
}

#ifdef DCGRU_PROBE
// The splits of the (t, b) pairs (ops/cuda_recurrent.py, dw_splits):
// whole waves of kDwWaveBlocks blocks, the fewest whose splits hold at most
// kDwSplitPairs pairs each; none empty.
int dw_split_count(const DwParams& p) {
  const int per_split = p.M * p.ct * p.fg;
  for (int waves = 1;; ++waves) {
    const int splits = max(1, waves * kDwWaveBlocks / per_split);
    if (ceil_div(p.pairs, splits) <= kDwSplitPairs || splits >= p.pairs)
      return ceil_div(p.pairs, ceil_div(p.pairs, splits));
  }
}
#endif

// D = 0 is the hoisted layer's: no x rows (their spans are empty, no
// copy is issued), no x feature tiles, slabs without dWx
bool dw_valid(const DwParams& p) {
  return p.N >= 1 && p.N <= kMaxNodes && p.M >= 1 && p.pairs >= 1 &&
         p.D >= 0 && p.D % 4 == 0 && p.H >= 4 && p.H % 4 == 0 &&
         p.B >= 1 && p.a_batch >= 1;
}

DwParams dw_params(const void* x, const void* h_prev, const void* ru,
                   const float* dpre, const void* frags, int a_batch,
                   float* part, int T, int B, int N, int D, int H, int M) {
  DwParams p{};
  p.x = x;
  p.h_prev = h_prev;
  p.ru = ru;
  p.dpre = dpre;
  p.frags = static_cast<const uint4*>(frags);
  p.part = part;
  p.pairs = T * B;
  p.B = B;
  p.N = N;
  p.D = D;
  p.H = H;
  p.M = M;
  p.a_batch = a_batch;
  return p;
}

}  // namespace
extern "C" {

// XP (T, B, N, 3H) f32 = sum_m (A_m x) Wx_m; x in the stream dtype (bf16
// when bf16 != 0, else f32); ops (a_batch, M-1) the operators A_m, unused
// at M=1: bf16 as mma A fragments (the wrapper's dw_op_frags with
// transpose=False, batch_major=True), f32 as A_m^T rows (xin_op_rows);
// w Wx_m (D x 3H) as the kernel's B operands (xin_weight_frags).
// Returns a cudaError_t: 0 on a launch that was accepted.
int dcgru_xin_proj(const void* x, const void* ops, int a_batch,
                   const void* w, float* xp, int T, int B, int N, int D,
                   int H, int M, int bf16, void* stream) {
  const BulkParams p =
      bulk_params(true, x, ops, a_batch, xp, T, B, N, D, H, M);
  if (!bulk_valid(p, D, H, w)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bulk<true, __nv_bfloat16>(p, w, s)
              : wg(wg_params(true, x, ops, a_batch, w, xp, T, B, N,
                                   D, H, M),
                         s);
}

// dx (T, B, N, D) in the stream dtype = sum_m (A_m^T dpre) Wx_m^T; dpre
// (T, B, N, 3H) f32; ops (a_batch, M-1) A_m^T (bf16: dw_op_frags with
// batch_major=True; f32: A_m rows, xin_op_rows); w Wx_m^T (3H x D) as the
// kernel's B operands.
int dcgru_xin_dx(const float* dpre, const void* ops, int a_batch,
                 const void* w, void* dx_out, int T, int B, int N, int D,
                 int H, int M, int bf16, void* stream) {
  const BulkParams p =
      bulk_params(false, dpre, ops, a_batch, dx_out, T, B, N, D, H, M);
  if (!bulk_valid(p, D, H, w)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bulk<false, __nv_bfloat16>(p, w, s)
              : wg(wg_params(false, dpre, ops, a_batch, w, dx_out, T,
                                    B, N, D, H, M),
                          s);
}

// The launch plan of dcgru_xin_proj (proj != 0) or dcgru_xin_dx at a
// shape, on the current device: pairs a chunk, rows a chunk, columns a
// block, column tiles, threads a block, shared bytes a block, blocks a
// column tile, blocks an SM, In by tensor map, In's and F's row strides,
// consumer warpgroups and weight slots (f32; 0 for bf16).
int dcgru_xin_bulk_plan(int proj, int T, int B, int N, int D, int H, int M,
                        int a_batch, int bf16, int* out) {
  int v[13] = {};
  int smem, threads;
  // blocks an SM, after the launch's own shared-memory attribute
  auto occupancy = [&](auto kern, int& per_sm) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
    return e;
  };
  cudaError_t err;
  if (bf16) {
    BulkParams p = bulk_params(proj, nullptr, nullptr, a_batch, nullptr, T,
                               B, N, D, H, M);
    smem = bulk_plan(p, proj ? 2 : 4);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    threads = 32 * (p.warps + 1);
    const int w[] = {p.P, p.RB, p.ct, p.ctn, threads, smem, p.walkers, 0,
                     p.tmap, p.ldk, p.ldf, 0, 0};
    for (int i = 0; i < 13; ++i) v[i] = w[i];
    err = proj ? occupancy(xin_bulk_kernel<true, __nv_bfloat16>, v[7])
               : occupancy(xin_bulk_kernel<false, __nv_bfloat16>, v[7]);
  } else {
    WgParams p = wg_params(proj, nullptr, nullptr, a_batch, nullptr,
                           nullptr, T, B, N, D, H, M);
    smem = wg_plan(p);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    threads = 128 * (p.W + 1);
    const int w[] = {p.P, 64 * p.W, 64 * p.nt, p.ctn, threads, smem,
                     p.walkers, 0, p.tmap, p.ldk, p.ldk, p.W, p.stages};
    for (int i = 0; i < 13; ++i) v[i] = w[i];
    err = p.nt == 1   ? occupancy(wg_kernel<1>(p), v[7])
          : p.nt == 2 ? occupancy(wg_kernel<2>(p), v[7])
                      : occupancy(wg_kernel<3>(p), v[7]);
  }
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return 0;
}

// part (splits, (M*D + M*H)*3H + 3H) f32: split s sums the pairs
// [s*pps, min((s+1)*pps, T*B)), pps = ceil(T*B / splits); every entry is
// written. x, h_prev, ru in the stream dtype (x unused at D = 0, the
// hoisted layer's); dpre f32; frags (M-1,
// a_batch) operators A_m^T as the mma's A fragments (bf16: m16n8k16
// tiles; f32: m16n8k8 tiles split into TF32 hi and lo; the wrapper's
// dw_op_frags), unused at M=1.
int dcgru_xin_dw(const void* x, const void* h_prev, const void* ru,
                 const float* dpre, const void* frags, int a_batch,
                 float* part, int splits, int T, int B, int N, int D, int H,
                 int M, int bf16, void* stream) {
  const DwParams p = dw_params(x, h_prev, ru, dpre, frags, a_batch, part, T,
                               B, N, D, H, M);
  if (!dw_valid(p) || splits < 1 || (M > 1 && frags == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dw<__nv_bfloat16>(p, splits, s) : dw<float>(p, splits, s);
}

#ifdef DCGRU_PROBE
// probe builds: the probed blocks' phase clocks since the last read
// (dW: 12 slots a role; projection and dx: block 0's)
int dcgru_probe_read(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, dcgru::probe_cycles,
                                         sizeof(dcgru::probe_cycles));
  if (err != cudaSuccess) return (int)err;
  unsigned long long zero[dcgru::kProbeSlots] = {};
  return (int)cudaMemcpyToSymbol(dcgru::probe_cycles, zero, sizeof(zero));
}

// probe builds: the dW launch plan of a shape on the current device:
// splits, pairs a split, pairs a chunk, rows a chunk, shared bytes a
// block, threads a block, blocks a split, blocks an SM
int dcgru_xin_dw_plan(int T, int B, int N, int D, int H, int M, int bf16,
                      int* out) {
  DwParams p = dw_params(nullptr, nullptr, nullptr, nullptr, nullptr, 1,
                         nullptr, T, B, N, D, H, M);
  if (!dw_valid(p)) return (int)cudaErrorInvalidValue;
  const int smem = dw_plan(p, bf16 ? 2 : 4);
  const int splits = dw_split_count(p);
  int per_sm = 0;
  if (bf16)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, xin_dw_kernel<__nv_bfloat16, true>, 32 * p.warps, smem);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, xin_dw_kernel<float, false>, 32 * p.warps, smem);
  const int v[] = {splits, ceil_div(p.pairs, splits), p.P, p.RB, smem,
                   32 * p.warps, p.M * p.ct * p.fg, per_sm};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
#endif

const char* dcgru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
