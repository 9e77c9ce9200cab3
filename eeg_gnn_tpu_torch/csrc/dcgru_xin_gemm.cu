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
// Projection and dx. Rows are clip-steps' node rows, (t, b, n) flattened;
// a block takes a chunk of P whole (t, b) pairs, P*N rows padded to a
// multiple of 16 only at the chunk's end, so the per-clip diffusion stays
// inside the block. It runs on FMA in shared memory as a tile arrives; a
// block covers up to three 64-column output tiles, one per group of
// warps. Products are warp-level mma.sync: bf16 streams take m16n8k16 bf16
// operands with f32 accumulation (the reference's Precision.DEFAULT: one
// bf16 MXU pass); f32 streams take 3xTF32 (m16n8k8, a = hi + lo, hi*hi +
// hi*lo + lo*hi), ~f32 accuracy with TF32 off everywhere else. Operand
// tiles live in f32 shared memory, converted when a fragment is built;
// tiles arrive by cp.async, double-buffered.
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

constexpr int kCT = 64;       // output columns of a warp (8 n8 tiles)
constexpr int kGroup = 3;     // column tiles of a block, one per warp group
constexpr int kLg = kGroup * kCT + 4;  // padded row of a group's columns
constexpr int kLf = 2 * kCT + 4;       // padded row of dW's feature tile
constexpr int kKC = 16;       // K per stage of the projection and dx
constexpr int kLk = kKC + 4;  // padded row of a stage's f32 tile
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;
constexpr int kMaxSplitPairs = 512;  // (t, b) pairs a dW split sums, at most

// ---------------------------------------------------------------------------
// tensor-core fragments (helpers in dcgru_common.cuh)
// ---------------------------------------------------------------------------

// One warp: acc[j] += A (16 x 16) B (16 x 8) for the n8 tiles j < nt_live,
// A(i, k) = a[i*ai + k*ak], B(k, n) = b[k*bk + (8j + n)*bn], f32 in shared
// memory. Accumulator j holds rows g, g+8 and columns 2t, 2t+1 of tile j
// (g = lane / 4, t = lane % 4).
template <bool BF16>
__device__ __forceinline__ void mma_k16(float (&acc)[8][4],
                                        const float* __restrict__ a, int ai,
                                        int ak, const float* __restrict__ b,
                                        int bk, int bn, int nt_live) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * ai;
  const float* a1 = a + (g + 8) * ai;
  if constexpr (BF16) {
    const int k0 = 2 * t, k1 = 2 * t + 8;
    const uint32_t fa[4] = {pack_bf16(a0[k0 * ak], a0[(k0 + 1) * ak]),
                            pack_bf16(a1[k0 * ak], a1[(k0 + 1) * ak]),
                            pack_bf16(a0[k1 * ak], a0[(k1 + 1) * ak]),
                            pack_bf16(a1[k1 * ak], a1[(k1 + 1) * ak])};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nt_live) {
        const float* bj = b + (8 * j + g) * bn;
        mma_bf16(acc[j], fa, pack_bf16(bj[k0 * bk], bj[(k0 + 1) * bk]),
                 pack_bf16(bj[k1 * bk], bj[(k1 + 1) * bk]));
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 16; kk += 8) {
      const int k0 = kk + t, k1 = kk + t + 4;
      uint32_t hi[4], lo[4];
      split_tf32(a0[k0 * ak], hi[0], lo[0]);
      split_tf32(a1[k0 * ak], hi[1], lo[1]);
      split_tf32(a0[k1 * ak], hi[2], lo[2]);
      split_tf32(a1[k1 * ak], hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nt_live) {
          const float* bj = b + (8 * j + g) * bn;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(bj[k0 * bk], bh0, bl0);
          split_tf32(bj[k1 * bk], bh1, bl1);
          mma_tf32(acc[j], lo, bh0, bh1);
          mma_tf32(acc[j], hi, bl0, bl1);
          mma_tf32(acc[j], hi, bh0, bh1);
        }
      }
    }
  }
}

// dW's long sums flush each chunk into an f32 register sum (flush, in
// dcgru_common.cuh). The projection's and dx's sums run over M*D and
// M*3H (a few hundred adds at most) and keep one accumulator: their
// float32 error stays within 6e-6 of the plain version (PERF.md).

// ---------------------------------------------------------------------------
// cp.async tiles (copies in dcgru_common.cuh)
// ---------------------------------------------------------------------------

// Rows [0, RB) x quads [0, W/4) of a row-major global tile into shared
// memory (ld elements a row); rows >= rows_ok or columns >= cols_ok (both
// relative to the tile) are zero-filled.
template <typename S>
__device__ __forceinline__ void load_tile(S* dst, int ld, const S* src,
                                          size_t lds, int RB, int W,
                                          int rows_ok, int cols_ok) {
  const int q4 = W / 4;
  for (int i = threadIdx.x; i < RB * q4; i += blockDim.x) {
    const int r = i / q4, c = 4 * (i - r * q4);
    const bool ok = r < rows_ok && c < cols_ok;
    cp_quad(dst + r * ld + c, ok ? src + r * lds + c : src, ok);
  }
}

// dst[n * ldd] = sum_k a[n * Np + k] v[k] for n < N: a holds N operator
// rows padded to Np = pad4(N) floats (zeros past N; rows of A_m, or of
// A_m^T), v[k] = 0 past N; a == nullptr is the identity. Four rows at a
// time, so four FMA chains are in flight.
__device__ __forceinline__ void apply_rows(const float (&v)[kMaxNodes],
                                           const float* __restrict__ a, int N,
                                           float* dst, int ldd) {
  if (a == nullptr) {
#pragma unroll
    for (int k = 0; k < kMaxNodes; ++k)
      if (k < N) dst[k * ldd] = v[k];
    return;
  }
  const int Np = pad4(N);
  for (int n = 0; n < N; n += 4) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k4 = 0; k4 < kMaxNodes / 4; ++k4)
      if (4 * k4 < N) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (n + i < N) {
            const float4 w = *reinterpret_cast<const float4*>(
                a + (n + i) * Np + 4 * k4);
            s[i] = fmaf(w.x, v[4 * k4], s[i]);
            s[i] = fmaf(w.y, v[4 * k4 + 1], s[i]);
            s[i] = fmaf(w.z, v[4 * k4 + 2], s[i]);
            s[i] = fmaf(w.w, v[4 * k4 + 3], s[i]);
          }
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n + i < N) dst[(n + i) * ldd] = s[i];
  }
}

// v[k] = src[k * lds] for k < N, 0 past N.
template <typename S>
__device__ __forceinline__ void load_col(float (&v)[kMaxNodes], const S* src,
                                         int lds, int N) {
#pragma unroll
  for (int k = 0; k < kMaxNodes; ++k) v[k] = k < N ? to_f(src[k * lds]) : 0.0f;
}

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

struct Common {
  const float* a_ops;  // (M, a_batch, N, N)
  const float* wx;     // (M*D, 3H) = [Wxg | Wxc], m-major rows
  int pairs, B, N, D, H3, M, a_batch;
  Geom g;
};

__host__ __device__ inline int ops_size(const Common& c) {
  return c.g.P * (c.M - 1) * c.N * pad4(c.N);
}

// A_1..A_{M-1} (or their transposes) of the chunk's pairs -> s (P, M-1, N,
// Np), rows padded with zeros; absent pairs' operators are zero.
__device__ __forceinline__ void load_ops(float* s, const Common& c, int pair0,
                                         int np, bool transpose) {
  const int N = c.N, Np = pad4(N), NN = N * N, per = N * Np;
  for (int i = threadIdx.x; i < ops_size(c); i += blockDim.x) {
    const int q = i / ((c.M - 1) * per), e = i - q * (c.M - 1) * per;
    const int m = e / per + 1, r = e - (m - 1) * per, n = r / Np;
    const int k = r - n * Np;
    float v = 0.0f;
    if (q < np && k < N) {
      const int b = c.a_batch == 1 ? 0 : (pair0 + q) % c.B;
      v = c.a_ops[((size_t)m * c.a_batch + b) * NN +
                  (transpose ? k * N + n : n * N + k)];
    }
    s[i] = v;
  }
}

// ---------------------------------------------------------------------------
// projection: XP (pairs*N, 3H) f32; a block: a chunk x up to 3 column tiles
// ---------------------------------------------------------------------------

struct ProjSmem {
  int a, x, w, f, total;  // in floats
  __host__ __device__ ProjSmem(const Common& c, int sbytes) {
    a = 0;
    x = a + pad4(ops_size(c));
    w = x + 2 * c.g.RB * kKC * sbytes / 4;
    f = w + 2 * c.M * kKC * kLg;
    total = f + c.M * c.g.RB * kLk;
  }
};

template <typename S, bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
    xin_proj_kernel(const Common c, const S* __restrict__ x, float* xp) {
  extern __shared__ __align__(16) float smem[];
  const ProjSmem L(c, sizeof(S));
  const int N = c.N, Np = pad4(N), D = c.D, H3 = c.H3, M = c.M;
  const int RB = c.g.RB, P = c.g.P;
  const int pair0 = blockIdx.x * P, np = min(P, c.pairs - pair0);
  const int rows = np * N, g0 = blockIdx.y * kGroup * kCT;
  const size_t row0 = (size_t)pair0 * N;
  float* sA = smem + L.a;
  S* sx = reinterpret_cast<S*>(smem + L.x);
  float* sw = smem + L.w;
  float* sf = smem + L.f;
  // warp (row tile wr, column tile wc of the group)
  const int warp = threadIdx.x >> 5, mt = RB / 16;
  const int wr = warp % mt, wc = warp / mt, c0 = g0 + wc * kCT;
  const int nt_live = min(8, (H3 - c0 + 7) / 8);

  auto issue = [&](int kc, int s) {
    const int d0 = kc * kKC;
    load_tile(sx + s * RB * kKC, kKC, x + row0 * D + d0, D, RB, kKC, rows,
              D - d0);
    for (int m = 0; m < M; ++m)
      load_tile(sw + (s * M + m) * kKC * kLg, kLg,
                c.wx + ((size_t)m * D + d0) * H3 + g0, H3, kKC, kGroup * kCT,
                D - d0, H3 - g0);
    cp_commit();
  };

  load_ops(sA, c, pair0, np, false);
  for (int i = threadIdx.x; i < M * RB * kLk; i += blockDim.x) sf[i] = 0.0f;
  float acc[8][4] = {};
  const int nkc = (D + kKC - 1) / kKC;
  issue(0, 0);
  for (int kc = 0; kc < nkc; ++kc) {
    const int s = kc & 1;
    if (kc + 1 < nkc) {
      issue(kc + 1, s ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // F_m = A_m x for this stage's columns, one (m, pair, column) per task
    const S* xs = sx + s * RB * kKC;
    for (int task = threadIdx.x; task < M * np * kKC; task += blockDim.x) {
      const int m = task / (np * kKC), e = task - m * np * kKC;
      const int q = e / kKC, col = e - q * kKC;
      float v[kMaxNodes];
      load_col(v, xs + q * N * kKC + col, kKC, N);
      apply_rows(v, m ? sA + (q * (M - 1) + m - 1) * N * Np : nullptr, N,
                 sf + (m * RB + q * N) * kLk + col, kLk);
    }
    __syncthreads();
    if (nt_live > 0)
      for (int m = 0; m < M; ++m)
        mma_k16<BF16>(acc, sf + (m * RB + 16 * wr) * kLk, kLk, 1,
                      sw + (s * M + m) * kKC * kLg + wc * kCT, kLg, 1,
                      nt_live);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * wr + g + (e >> 1) * 8;
      const int col = c0 + 8 * j + 2 * t + (e & 1);
      if (r < rows && col < H3) xp[(row0 + r) * H3 + col] = acc[j][e];
    }
}

// ---------------------------------------------------------------------------
// dx (pairs*N, D) in the stream dtype; a block: a chunk x up to 3 tiles of D
// ---------------------------------------------------------------------------

struct DxSmem {
  int a, g, w, e, total;  // in floats
  __host__ __device__ explicit DxSmem(const Common& c) {
    a = 0;
    g = a + pad4(ops_size(c));
    w = g + 2 * c.g.RB * kKC;
    e = w + 2 * c.M * kGroup * kCT * kLk;
    total = e + c.M * c.g.RB * kLk;
  }
};

template <typename S, bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
    xin_dx_kernel(const Common c, const float* __restrict__ dpre, S* dx) {
  extern __shared__ __align__(16) float smem[];
  const DxSmem L(c);
  const int N = c.N, Np = pad4(N), D = c.D, H3 = c.H3, M = c.M;
  const int RB = c.g.RB, P = c.g.P;
  const int pair0 = blockIdx.x * P, np = min(P, c.pairs - pair0);
  const int rows = np * N, g0 = blockIdx.y * kGroup * kCT;
  const size_t row0 = (size_t)pair0 * N;
  float* sA = smem + L.a;
  float* sg = smem + L.g;
  float* sw = smem + L.w;
  float* se = smem + L.e;
  const int warp = threadIdx.x >> 5, mt = RB / 16;
  const int wr = warp % mt, wc = warp / mt, d0 = g0 + wc * kCT;
  const int nt_live = min(8, (D - d0 + 7) / 8);

  // stage: dpre columns [j0, j0 + kKC) of the chunk's rows, and Wx_m^T
  // kept as rows d (the group's 3 x 64) of Wx_m, columns j
  auto issue = [&](int jc, int s) {
    const int j0 = jc * kKC;
    load_tile(sg + s * RB * kKC, kKC, dpre + row0 * H3 + j0, H3, RB, kKC,
              rows, H3 - j0);
    for (int m = 0; m < M; ++m)
      load_tile(sw + (s * M + m) * kGroup * kCT * kLk, kLk,
                c.wx + ((size_t)m * D + g0) * H3 + j0, H3, kGroup * kCT, kKC,
                D - g0, H3 - j0);
    cp_commit();
  };

  load_ops(sA, c, pair0, np, true);
  for (int i = threadIdx.x; i < M * RB * kLk; i += blockDim.x) se[i] = 0.0f;
  float acc[8][4] = {};
  const int njc = (H3 + kKC - 1) / kKC;
  issue(0, 0);
  for (int jc = 0; jc < njc; ++jc) {
    const int s = jc & 1;
    if (jc + 1 < njc) {
      issue(jc + 1, s ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // E_m = A_m^T dpre for this stage's columns
    const float* gs = sg + s * RB * kKC;
    for (int task = threadIdx.x; task < M * np * kKC; task += blockDim.x) {
      const int m = task / (np * kKC), e = task - m * np * kKC;
      const int q = e / kKC, col = e - q * kKC;
      float v[kMaxNodes];
      load_col(v, gs + q * N * kKC + col, kKC, N);
      apply_rows(v, m ? sA + (q * (M - 1) + m - 1) * N * Np : nullptr, N,
                 se + (m * RB + q * N) * kLk + col, kLk);
    }
    __syncthreads();
    if (nt_live > 0)
      for (int m = 0; m < M; ++m)
        mma_k16<BF16>(acc, se + (m * RB + 16 * wr) * kLk, kLk, 1,
                      sw + ((s * M + m) * kGroup * kCT + wc * kCT) * kLk, 1,
                      kLk, nt_live);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * wr + g + (e >> 1) * 8;
      const int col = d0 + 8 * j + 2 * t + (e & 1);
      if (r < rows && col < D)
        dx[(row0 + r) * D + col] = from_f<S>(acc[j][e]);
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

// The copies are the Tensor Memory Accelerator's 1-D bulk copies
// (cp.async.bulk): one thread issues a whole span and an mbarrier counts
// its bytes in, so no thread stalls on a chunk's loads.

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

// mma_bf16 / mma_tf32 of dcgru_common.cuh without `volatile`: an mma
// is a pure function of its registers, so the compiler may interleave
// independent products and move operand loads above them. (The volatile
// forms issue in program order: a 3xTF32 tile's three dependent products
// back to back, each waiting out the last one's latency.)
__device__ __forceinline__ void mma_bf16_r(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32_r(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// G^T (column j, chunk rows k and k+1, k even) = (va, vb)
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

bool valid(const Common& c, int H) {
  return c.N >= 1 && c.N <= kMaxNodes && c.M >= 1 && c.pairs >= 1 &&
         c.D >= 4 && c.D % 4 == 0 && H >= 4 && H % 4 == 0 && c.B >= 1;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The largest chunk (at most 96 rows, and `max_tiles` row tiles of 16)
// whose shared memory fits.
template <typename F>
int fit(Common& c, int max_tiles, F bytes) {
  const int caps[] = {96, 80, 64, 48, 32, 16};
  for (int cap : caps) {
    if (cap > 16 * max_tiles) continue;
    c.g = geom(c.N, cap);
    if (c.g.RB <= cap && bytes(c) <= kMaxSmem) return bytes(c);
  }
  return -1;
}

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

template <typename S>
int proj(Common c, const void* x, float* xp, cudaStream_t stream) {
  const int groups = ceil_div(c.H3, kGroup * kCT);
  const int wc = min(kGroup, ceil_div(c.H3, kCT));
  const int smem = fit(c, kMaxThreads / 32 / wc, [](const Common& k) {
    return ProjSmem(k, sizeof(S)).total * 4;
  });
  const dim3 grid(ceil_div(c.pairs, c.g.P), groups);
  return run(xin_proj_kernel<S, sizeof(S) == 2>, smem, grid,
             32 * (c.g.RB / 16) * wc, stream, c, static_cast<const S*>(x),
             xp);
}

template <typename S>
int dx(Common c, const float* dpre, void* out, cudaStream_t stream) {
  const int groups = ceil_div(c.D, kGroup * kCT);
  const int wc = min(kGroup, ceil_div(c.D, kCT));
  const int smem = fit(c, kMaxThreads / 32 / wc, [](const Common& k) {
    return DxSmem(k).total * 4;
  });
  const dim3 grid(ceil_div(c.pairs, c.g.P), groups);
  return run(xin_dx_kernel<S, sizeof(S) == 2>, smem, grid,
             32 * (c.g.RB / 16) * wc, stream, c, dpre, static_cast<S*>(out));
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
    // the producer
    p.warps = max(min(p.ft, kDwTiles), p.P) + 1;
    const int bytes = DwSmem(p, sb).total;
    if (bytes <= kMaxSmem) return bytes;
  }
  return -1;
}

// The 2-D tensor map of dpre (rows x 3H f32) whose box is a chunk's P*N
// rows by ldp columns; cuTensorMapEncodeTiled comes from the driver
// through the runtime. A cudaError_t.
int dw_dpre_map(CUtensorMap* map, const DwParams& p, int ldp) {
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
  const cuuint64_t dims[2] = {(cuuint64_t)(3 * p.H),
                              (cuuint64_t)p.pairs * p.N};
  const cuuint64_t strides[1] = {(cuuint64_t)(3 * p.H) * 4};
  const cuuint32_t box[2] = {(cuuint32_t)ldp, (cuuint32_t)(p.P * p.N)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p.dpre),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
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

bool dw_valid(const DwParams& p) {
  return p.N >= 1 && p.N <= kMaxNodes && p.M >= 1 && p.pairs >= 1 &&
         p.D >= 4 && p.D % 4 == 0 && p.H >= 4 && p.H % 4 == 0 &&
         p.B >= 1 && p.a_batch >= 1;
}

Common common(const float* a_ops, int a_batch, const float* wx, int T, int B,
              int N, int D, int H, int M) {
  return Common{a_ops, wx, T * B, B, N, D, 3 * H, M, a_batch, Geom{1, 16}};
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
// when bf16 != 0, else f32); wx (M*D, 3H) = [Wxg | Wxc].
// Returns a cudaError_t: 0 on a launch that was accepted.
int dcgru_xin_proj(const void* x, const float* a_ops, int a_batch,
                   const float* wx, float* xp, int T, int B, int N, int D,
                   int H, int M, int bf16, void* stream) {
  Common c = common(a_ops, a_batch, wx, T, B, N, D, H, M);
  if (!valid(c, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? proj<__nv_bfloat16>(c, x, xp, s) : proj<float>(c, x, xp, s);
}

// dx (T, B, N, D) in the stream dtype = sum_m A_m^T (dpre Wx_m^T); dpre
// (T, B, N, 3H) f32.
int dcgru_xin_dx(const float* dpre, const float* a_ops, int a_batch,
                 const float* wx, void* dx_out, int T, int B, int N, int D,
                 int H, int M, int bf16, void* stream) {
  Common c = common(a_ops, a_batch, wx, T, B, N, D, H, M);
  if (!valid(c, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dx<__nv_bfloat16>(c, dpre, dx_out, s)
              : dx<float>(c, dpre, dx_out, s);
}

// part (splits, (M*D + M*H)*3H + 3H) f32: split s sums the pairs
// [s*pps, min((s+1)*pps, T*B)), pps = ceil(T*B / splits); every entry is
// written. x, h_prev, ru in the stream dtype; dpre f32; frags (M-1,
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
// probe builds: the dW blocks' phase clocks since the last read
// (kProbeSlots: 12 a role)
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
