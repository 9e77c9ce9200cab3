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
// Projection and dx: one body (xin_bulk_kernel), out = sum_m (Op_m In) V_m
// per clip; the projection takes Op_m = A_m, In = x, V_m = Wx_m (D x 3H)
// and writes XP in f32, dx takes Op_m = A_m^T, In = dpre, V_m = Wx_m^T
// (3H x D) and writes dx in the stream dtype. The first port staged K 16
// columns at a time, diffused on FMA between three barriers a stage and
// re-read its f32 weights from L2 for every chunk, converting them at
// every fragment; its probe (loop_probe.py --only proj|dx, PERF.md) found
// a stage spent in the products' conversions (proj), or the FMA
// diffusion (dx at D=64), and issuing the next stage's copies. This design:
// - diffuses on the tensor cores: the operators arrive as mma A fragments
//   laid out once a launch by the wrapper (dw_op_frags, A_m or A_m^T), In
//   is the B operand (bf16: F_0 read by ldmatrix.trans, the rows past a
//   pair's N masked to zero; f32: In, split as read), and F_m = Op_m In
//   is written once into a shared tile in the operand type (bf16, or TF32
//   hi|lo pairs); m=0 is a copy. The product reads F as A fragments
//   (ldmatrix, or 8-byte hi|lo loads, conflict-free) and converts
//   nothing. bf16: F_m is one bf16 pass of bf16 A_m and In, rounded to
//   bf16 (the reference's projection rounds the same F; its dx
//   multiplies by Wx_m^T first: PERF.md says why this one does not);
//   f32: 3xTF32.
// - keeps the weights resident: the wrapper stages V_m as mma B fragments
//   (xin_weight_frags: bf16, or TF32 hi and lo); a block owns one output
//   column tile, copies its weights in once and walks many chunks of whole
//   (t, b) pairs (a persistent grid of one wave of 132 blocks an SM slot;
//   the H100's SM count is a constant). F holds one m at a time (K staged
//   in pieces of one m). f32's hi|lo operands are 4x bf16's: the plan
//   takes a narrower column tile where the weights would not fit, and
//   splits each m's k tiles over up to 15 warps, whose partial sums are
//   added in a fixed order (bulk_plan; PERF.md records each plan).
// - stages by TMA from a producer warp: a weight tile as one 3-D tensor
//   copy, a chunk's rows as one 2-D tensor copy (f32 In, rows padded for
//   conflict-free reads) or 1-D bulk copies of their span (bf16 x), the
//   pairs' operator fragments likewise (clip-major, so a chunk's are one
//   span); the next chunk's copies are issued as soon as its In is read
//   and run under the products. Two barriers an m a chunk; bf16 plans fit
//   two blocks an SM (the projection) or 11 warps (dx), so one block's
//   diffusion runs under the other's product.
// - writes every output element from one block's registers: no sums
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
// largest (PERF.md). wgmma and a persistent schedule are later work.

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

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
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
// columns k and k+1 of the projection's and dx's F
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
// projection and dx: out = sum_m (Op_m In) V_m, a block a column tile
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

constexpr int kBulkWarps = 11;    // compute warps of a bf16 block, at most
constexpr int kBulkWarps32 = 15;  // of an f32 block (one block an SM)
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
  int ks;              // warps that split a piece's k tiles (f32)
  int kt;              // k tiles of one m: K padded to 16 (bf16) or 8 (f32)
  int fw;              // 16-byte words of one operator's fragments
  int wb;              // bytes of one n8 tile's B fragments, one k tile
  int tmap;            // In by the 2-D tensor map, rows ldk apart; else by
                       // 1-D bulk copies of the rows' span (ldk = K)
  int ldk, ldf;        // row strides: In (elements), F (bf16 or float2)
  int warps;           // compute warps; the producer is one more
  int walkers;         // blocks of one column tile
};

// Byte offsets of a block's shared memory: the weight tile (all m: M*kt k
// tiles by ct/8 n tiles, as the 3-D tensor copy lands it), the chunk's In
// rows (single: bf16 reads it once, into F_0, and the next chunk's copy is
// issued then; f32 diffuses from it and issues the next after the last
// m), the pairs' operator fragments (one set for a shared graph, copied
// once), F, the copies' mbarriers (weights and shared operators; a
// chunk's In; its operators). bf16: F_0 (= In, the diffusion's B operand
// too, rows to the last pair's last k tile) and F_m for one m at a time;
// f32: one F, F_0 and then each F_m, and at a chunk's end the k-split
// warps' partial sums.
struct BulkSmem {
  int w, in, ops, f, fm, bar, total;
  __host__ __device__ BulkSmem(const BulkParams& p, int ib, bool bf) {
    w = 0;
    in = (p.M * p.kt * (p.ct / 8) * p.wb + 127) & ~127;
    // a span's copy starts up to 12 bytes early and ends padded to 16
    const int inb = p.tmap ? p.P * p.N * p.ldk * ib : p.P * p.N * p.K * ib + 32;
    ops = align16(in + inb);
    f = ops + (p.M > 1 ? (p.a_batch == 1 ? 1 : p.P) * (p.M - 1) * p.fw * 16
                       : 0);
    const int r0 = max(p.RB, (p.P - 1) * p.N + 16 * ((p.N + 15) / 16));
    fm = bf ? f + r0 * p.ldf * 2 : f;
    bar = align16(fm + p.RB * p.ldf * (bf ? 2 : 8));
    total = bar + 32;
  }
};

// bytes of the k-split warps' partial sums (f32; in F at a chunk's end)
__host__ __device__ inline int bulk_red_bytes(const BulkParams& p) {
  return (p.ks - 1) * (p.warps / p.ks) * 4 * 4 * 32 * 4;
}

// PROJ: In = x (S), Op_m = A_m, out = XP (f32); else In = dpre (f32),
// Op_m = A_m^T, out = dx (S). BF16: one bf16 pass (bf16 streams), else
// 3xTF32. wmap: the staged weights (M*kt, C/8 n tiles, one n tile's
// words) as a 3-D tensor map whose box is a block's column tile; imap:
// In (pairs*N rows, K columns) f32 as a 2-D tensor map whose box is a
// chunk's P*N rows by ldk columns (when p.tmap).
template <bool PROJ, typename S, bool BF16>
__global__ void __launch_bounds__(BF16 ? 32 * (kBulkWarps + 1)
                                       : 32 * (kBulkWarps32 + 1),
                                  BF16 ? 2 : 1)
    xin_bulk_kernel(const BulkParams p,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap imap) {
  using IT = typename std::conditional<PROJ, S, float>::type;
  using OT = typename std::conditional<PROJ, float, S>::type;
  using FT = typename std::conditional<BF16, __nv_bfloat16, float2>::type;
  constexpr int kNt = 4;  // n8 tiles of a warp's columns, at most
  extern __shared__ __align__(128) unsigned char dsm[];
  const BulkSmem L(p, sizeof(IT), BF16);
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
  // (wn of them), k tiles [k0, k1) of each m
  const int rtiles = p.RB / 16, ntc = p.ct / 8, wn = min(32, p.ct);
  const int wtiles = rtiles * (p.ct / wn);  // warps of one k slice
  const int wr = warp % rtiles, wc = (warp % wtiles) / rtiles;
  const int ksi = warp / wtiles;
  const int k0 = ksi * p.kt / p.ks, k1 = (ksi + 1) * p.kt / p.ks;
  const int col0 = ctile * p.ct + wc * wn;
  const int nt_live =
      producer ? 0 : max(0, min(wn / 8, (p.C - col0 + 7) / 8));
  const int NTk = (K + 7) / 8;  // In's n8 column tiles
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
    float acc[kNt][4] = {}, sml[kNt][4] = {}, sum[kNt][4] = {};
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
      if constexpr (BF16) {
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
      } else {
        // a unit: one pair's 8 columns; B from In, split as it is read
        for (int u = warp; u < np * NTk; u += p.warps) {
          const int q = u / NTk, c0 = 8 * (u - q * NTk);
          const uint4* fr = opm + (per_clip ? q * opw : 0);
          const IT* src = xs + q * N * p.ldk + c0 + g;
          const bool cok = c0 + g < K;
          auto v = [&](int n) {
            return n < N && cok ? to_f(src[n * p.ldk]) : 0.0f;
          };
          // the small terms (lo hi, hi lo) apart from hi hi, so the
          // chains are half as long
          float ga[2][4] = {}, gs[2][4] = {};
          const int KT = (N + 7) / 8;
          for (int kt = 0; kt < KT; ++kt) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(v(8 * kt + t), bh0, bl0);
            split_tf32(v(8 * kt + t + 4), bh1, bl1);
#pragma unroll
            for (int rt = 0; rt < 2; ++rt)
              if (rt < RT) {
                const uint4 h = fr[(rt * KT + kt) * 64];
                const uint4 l = fr[(rt * KT + kt) * 64 + 32];
                const uint32_t hi[4] = {h.x, h.y, h.z, h.w};
                const uint32_t lo[4] = {l.x, l.y, l.z, l.w};
                mma_tf32_r(gs[rt], lo, bh0, bh1);
                mma_tf32_r(gs[rt], hi, bl0, bl1);
                mma_tf32_r(ga[rt], hi, bh0, bh1);
              }
          }
          if (c0 + 2 * t < K)
#pragma unroll
            for (int rt = 0; rt < 2; ++rt)
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2) {
                const int n = 16 * rt + g + 8 * h2;
                if (rt < RT && n < N)
                  store_g2(dst, p.ldf, q * N + n, c0 + 2 * t,
                           ga[rt][2 * h2] + gs[rt][2 * h2],
                           ga[rt][2 * h2 + 1] + gs[rt][2 * h2 + 1]);
              }
        }
      }
    };
    // acc (16 rows x the warp's n8 tiles) += F_m V_m over its k tiles
    auto product = [&](int m, const FT* src) {
      if constexpr (BF16) {
        const uint2* wt = reinterpret_cast<const uint2*>(dsm + L.w) +
                          ((size_t)m * p.kt * ntc + wc * (wn / 8)) * 32 + lane;
        const unsigned a0 = smem_addr(src + (16 * wr + (lane & 15)) * p.ldf +
                                      8 * (lane >> 4));
#pragma unroll 2
        for (int kk = k0; kk < k1; ++kk) {
          uint32_t fa[4];
          ldsm_x4(fa, a0 + 32 * kk);
#pragma unroll
          for (int j = 0; j < kNt; ++j)
            if (j < nt_live) {
              const uint2 b = wt[(kk * ntc + j) * 32];
              mma_bf16_r(acc[j], fa, b.x, b.y);
            }
        }
      } else {
        const uint4* wt = reinterpret_cast<const uint4*>(dsm + L.w) +
                          ((size_t)m * p.kt * ntc + wc * (wn / 8)) * 32 + lane;
        const float2* fa = src + (16 * wr + g) * p.ldf + t;
        for (int kk = k0; kk < k1; ++kk) {
          const float2 x0 = fa[8 * kk], x1 = fa[8 * p.ldf + 8 * kk];
          const float2 x2 = fa[8 * kk + 4], x3 = fa[8 * p.ldf + 8 * kk + 4];
          const uint32_t hi[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x),
                                  __float_as_uint(x2.x), __float_as_uint(x3.x)};
          const uint32_t lo[4] = {__float_as_uint(x0.y), __float_as_uint(x1.y),
                                  __float_as_uint(x2.y), __float_as_uint(x3.y)};
#pragma unroll
          for (int j = 0; j < kNt; ++j)
            if (j < nt_live) {
              // [hi(k), hi(k+4), lo(k), lo(k+4)] of column g
              const uint4 b = wt[(kk * ntc + j) * 32];
              mma_tf32_r(sml[j], lo, b.x, b.y);
              mma_tf32_r(sml[j], hi, b.z, b.w);
              mma_tf32_r(acc[j], hi, b.x, b.y);
            }
        }
        // a long f32 sum: each m's partial into the register sum
#pragma unroll
        for (int j = 0; j < kNt; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[j][e] += acc[j][e] + sml[j][e];
            acc[j][e] = sml[j][e] = 0.0f;
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
      // bf16 reads In only into F_0; f32 diffuses from it
      if (next && m == (BF16 ? 0 : M - 1)) issue_in(it + 1);
      if (next && m == M - 1 && per_clip) issue_ops(it + 1);
      if (nt_live > 0) product(m, m ? sfm : sf0);
      DCGRU_PROBE_MARK(6);
    }
    float (&tot)[kNt][4] = BF16 ? acc : sum;
    if (!BF16 && p.ks > 1) {
      // the k slices' partials, added in slice order into slice 0's
      float* red = reinterpret_cast<float*>(dsm + L.f);
      __syncthreads();  // every product has read F
      if (ksi > 0 && !producer)
#pragma unroll
        for (int j = 0; j < kNt; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[((((ksi - 1) * wtiles + warp % wtiles) * kNt + j) * 4 + e) *
                    32 + lane] = tot[j][e];
      __syncthreads();
      if (ksi == 0 && !producer)
        for (int s = 1; s < p.ks; ++s)
#pragma unroll
          for (int j = 0; j < kNt; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              tot[j][e] += red[((((s - 1) * wtiles + warp) * kNt + j) * 4 + e) *
                               32 + lane];
      __syncthreads();
      // F's pad columns meet every row's weights: zero again (a partial
      // there could be a NaN)
      const int pad = 8 * p.kt - K;
      for (int i = threadIdx.x; i < p.RB * pad; i += blockDim.x)
        sf0[(i / pad) * p.ldf + K + i % pad] = FT{};
    }
    // rows < np*N, columns < C of the tile, two columns a store
    if (nt_live > 0 && ksi == 0) {
      OT* o = static_cast<OT*>(p.out) + (size_t)pair0 * N * p.C;
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = 16 * wr + g + 8 * h2, col = col0 + 8 * j + 2 * t;
          if (j < nt_live && r < rows && col < p.C)
            store_out2(o + (size_t)r * p.C + col, tot[j][2 * h2],
                       tot[j][2 * h2 + 1]);
        }
    }
    DCGRU_PROBE_MARK(7);
  }
  DCGRU_PROBE_MARK(8);
  DCGRU_PROBE_STORE;
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

// The launch plan of a projection or dx shape: the column tile, chunk and
// warps with the least estimated tensor-core work a compute warp (the
// products' row tiles, and the diffusion, which every column tile of a
// chunk repeats; f32's diffusion weighted 4x, its B split as read and
// its chains short, the weight its plans measured fastest at on the
// H100), counting two bf16 blocks an SM where their shared memory fits
// and up to 16 warps an SM; f32 splits each m's k tiles over up to
// kBulkWarps32 warps. Then one wave of blocks (kBulkWave a
// block slot of an SM). Shared bytes a block, or -1 where none fits. The
// plan, like every sum's order, follows from the shape alone.
int bulk_plan(BulkParams& p, bool bf, int ib) {
  const int kd = bf ? 16 : 8;
  const int RT = ceil_div(p.N, 16), KTn = ceil_div(p.N, kd);
  p.kt = ceil_div(p.K, kd);
  p.fw = RT * KTn * (bf ? 32 : 64);
  p.wb = bf ? 256 : 512;
  // F: ldmatrix rows an odd number of 16-byte words apart (bf16); 8-byte
  // hi|lo loads of 8 rows 4 mod 16 words apart (f32)
  p.ldf = bf ? 16 * p.kt + 8 : 8 * p.kt + (8 * p.kt % 16 ? 12 : 4);
  // f32 In, the diffusion's B reads: rows 2t, 2t+1 of a column 4 mod 16
  // words apart (bf16 pairs), rows t, t+4 8 mod 32 (tf32)
  const int ldk = bf ? p.K + (20 - p.K % 16) % 16 : p.K + (40 - p.K % 32) % 32;
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
      const int wtiles = q.RB / 16 * (ct / min(32, ct));
      q.ks = bf ? 1 : max(1, min(q.kt, kBulkWarps32 / wtiles));
      q.warps = wtiles * q.ks;
      if (q.RB > kBulkRows || q.warps > (bf ? kBulkWarps : kBulkWarps32))
        continue;
      q.tmap = ib == 4 && ldk <= 256 && P * p.N <= 256;
      q.ldk = q.tmap ? ldk : p.K;
      const BulkSmem L(q, ib, bf);
      if (L.total > kMaxSmem || bulk_red_bytes(q) > L.bar - L.f) continue;
      const int per_sm = bf ? min(2, kSmemPerSm / (L.total + 1024)) : 1;
      const double work =
          (double)q.RB / 16 / P * p.M * q.kt * ctn * (ct / 8) +
          (bf ? 1.0 : 4.0) * (p.M - 1) * RT * KTn * ceil_div(p.K, 8) * ctn;
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
  const int per_sm = bf ? min(2, kSmemPerSm / (smem + 1024)) : 1;
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
  constexpr bool bf = sizeof(S) == 2;
  using IT = typename std::conditional<PROJ, S, float>::type;
  const int smem = bulk_plan(p, bf, sizeof(IT));
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
  return run(xin_bulk_kernel<PROJ, S, bf>, smem, dim3(p.walkers * p.ctn),
             32 * (p.warps + 1), stream, p, wmap, imap);
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
// when bf16 != 0, else f32); ops (a_batch, M-1) the operators A_m as mma
// A fragments (the wrapper's dw_op_frags with transpose=False,
// batch_major=True; unused at M=1); w Wx_m (D x 3H) as mma B fragments
// (xin_weight_frags).
// Returns a cudaError_t: 0 on a launch that was accepted.
int dcgru_xin_proj(const void* x, const void* ops, int a_batch,
                   const void* w, float* xp, int T, int B, int N, int D,
                   int H, int M, int bf16, void* stream) {
  const BulkParams p =
      bulk_params(true, x, ops, a_batch, xp, T, B, N, D, H, M);
  if (!bulk_valid(p, D, H, w)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bulk<true, __nv_bfloat16>(p, w, s)
              : bulk<true, float>(p, w, s);
}

// dx (T, B, N, D) in the stream dtype = sum_m (A_m^T dpre) Wx_m^T; dpre
// (T, B, N, 3H) f32; ops (a_batch, M-1) A_m^T (dw_op_frags with
// batch_major=True); w Wx_m^T (3H x D) as mma B fragments.
int dcgru_xin_dx(const float* dpre, const void* ops, int a_batch,
                 const void* w, void* dx_out, int T, int B, int N, int D,
                 int H, int M, int bf16, void* stream) {
  const BulkParams p =
      bulk_params(false, dpre, ops, a_batch, dx_out, T, B, N, D, H, M);
  if (!bulk_valid(p, D, H, w)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bulk<false, __nv_bfloat16>(p, w, s)
              : bulk<false, float>(p, w, s);
}

// The launch plan of dcgru_xin_proj (proj != 0) or dcgru_xin_dx at a
// shape, on the current device: pairs a chunk, rows a chunk, columns a
// block, column tiles, threads a block, shared bytes a block, blocks a
// column tile, blocks an SM, In by tensor map, In's and F's row strides.
int dcgru_xin_bulk_plan(int proj, int T, int B, int N, int D, int H, int M,
                        int a_batch, int bf16, int* out) {
  BulkParams p = bulk_params(proj, nullptr, nullptr, a_batch, nullptr, T, B,
                             N, D, H, M);
  const int ib = proj && bf16 ? 2 : 4;
  const int smem = bulk_plan(p, bf16, ib);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const int threads = 32 * (p.warps + 1);
  int per_sm = 0;
  // blocks an SM, after the launch's own shared-memory attribute
  auto occupancy = [&](auto kern) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
    return e;
  };
  const cudaError_t err =
      proj ? (bf16 ? occupancy(xin_bulk_kernel<true, __nv_bfloat16, true>)
                   : occupancy(xin_bulk_kernel<true, float, false>))
           : (bf16 ? occupancy(xin_bulk_kernel<false, __nv_bfloat16, true>)
                   : occupancy(xin_bulk_kernel<false, float, false>));
  if (err != cudaSuccess) return (int)err;
  const int v[] = {p.P, p.RB, p.ct, p.ctn, threads, smem, p.walkers, per_sm,
                   p.tmap, p.ldk, p.ldf};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
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
