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
//                      (:873-888) with its recomputed features (:820-838):
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
// GFLOP of FMA diffusions each; with bf16 streams the least time for each
// is 0.04-0.07 ms (products at 989 TFLOP/s, FMA at 67, or the bytes at
// 3.35 TB/s: chip_smoke.py's proj_work, dw_work, dx_work), far below the
// serial loops'.
//
// Design.
// - Rows are clip-steps' node rows, (t, b, n) flattened; a block takes a
//   chunk of P whole (t, b) pairs, P*N rows padded to a multiple of 16
//   only at the chunk's end (P picked per N for the least padding within
//   the shared memory: 4 pairs = 76 of 80 rows at N=19), so the per-clip
//   diffusion stays inside the block. It runs on FMA in shared memory as a
//   tile arrives, once per tile: a block covers up to three 64-column
//   output tiles (all 3H = 192 at H=64), one per group of warps, and the
//   operators' rows are padded to 4 and read as float4.
// - Products are warp-level mma.sync on tensor cores: bf16 streams take
//   m16n8k16 bf16 operands with f32 accumulation (the reference's
//   Precision.DEFAULT: one bf16 MXU pass); f32 streams take 3xTF32
//   (m16n8k8, a = hi + lo, hi*hi + hi*lo + lo*hi), ~f32 accuracy with TF32
//   off everywhere else. Operand tiles live in f32 shared memory, converted
//   when a fragment is built.
// - Stream tiles arrive by cp.async into double-buffered shared memory;
//   the next tile loads while the current one is diffused and multiplied.
// - dW: K is the row dimension. Each block owns 64 features of x (all 3H
//   columns) or of h_prev and r h_prev (2H and H columns) for one m, and
//   one of S splits of the (t, b) pairs, S chosen for whole waves of the
//   blocks the card holds at once (dcgru_xin_dw_splits); the S partial
//   slabs are summed in order by dcgru_dw_reduce (dcgru_recurrence_bwd.cu):
//   deterministic for a given card, no atomics. Each chunk's tensor-core
//   partial is added into an f32 register sum outside the tensor cores
//   (see flush).
// wgmma, TMA and a persistent schedule are later work.

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

struct DwParams {
  Common c;
  const void* x;       // (T, B, N, D)
  const void* h_prev;  // (T, B, N, H)
  const void* ru;      // (T, B, N, 2H)
  const float* dpre;   // (T, B, N, 3H) f32
  float* part;         // (splits, slab)
  int H, pps;          // pairs per split
  int nd_x, nd_h;      // 64-feature tiles of x and of h
  int nt_x, nt_g, nt_c;  // 64-column tiles of 3H, 2H, H
};

struct DwSmem {
  int src, r, g, a, f, total;  // in floats
  __host__ __device__ DwSmem(const Common& c, int sbytes) {
    const int raw = c.g.RB * kCT * sbytes / 4;
    src = 0;                         // 2 x (RB, 64) x or h_prev
    r = src + 2 * raw;               // 2 x (RB, 64) r (the h job)
    g = r + 2 * raw;                 // 2 x (RB, kLg) dpre columns
    a = g + 2 * c.g.RB * kLg;        // 2 x (P, N, Np) A_m of the pairs
    f = a + 2 * pad4(c.g.P * c.N * pad4(c.N));
    total = f + c.g.RB * kLf;        // (RB, kLf) features
  }
};

template <typename S, bool BF16>
__global__ void __launch_bounds__(4 * kGroup * 32) xin_dw_kernel(
    const DwParams p) {
  extern __shared__ __align__(16) float smem[];
  const Common& c = p.c;
  const DwSmem L(c, sizeof(S));
  const int N = c.N, Np = pad4(N), NN = N * N, M = c.M, H = p.H;
  const int H3 = c.H3, D = c.D, RB = c.g.RB, P = c.g.P;

  // the block: job x (features A_m x, dWx over all 3H columns) or job h
  // (features A_m h_prev and A_m (r h_prev): dWg over the 2H gate columns,
  // dWc over the H candidate columns), m, a 64-feature tile dt, and a group
  // of up to 3 column tiles: tiles 3z.. of the job's list
  int tile = blockIdx.x;
  const bool xjob = tile < M * p.nd_x;
  const int nd = xjob ? p.nd_x : p.nd_h;
  if (!xjob) tile -= M * p.nd_x;
  const int m = tile / nd, dt = tile - m * nd;
  const int width = xjob ? D : H;  // source columns
  const int f0 = dt * kCT;
  const int ntiles = xjob ? p.nt_x : p.nt_g + p.nt_c;
  const int tile0 = blockIdx.z * kGroup;
  if (tile0 >= ntiles) return;
  const S* src = static_cast<const S*>(xjob ? p.x : p.h_prev);
  const S* rus = static_cast<const S*>(p.ru);
  const bool with_db = xjob && m == 0 && dt == 0;

  // column tile i of the job: its features (0: x or h, 1: r h), its first
  // dpre column and its width
  auto tile_cols = [&](int i, int& fpart, int& gcol, int& ncols) {
    if (xjob || i < p.nt_g) {
      fpart = 0;
      gcol = i * kCT;
      ncols = (xjob ? H3 : 2 * H) - gcol;
    } else {
      fpart = 1;
      gcol = (i - p.nt_g) * kCT;
      ncols = H - gcol;
      gcol += 2 * H;
    }
  };

  S* ss = reinterpret_cast<S*>(smem + L.src);
  S* sr = reinterpret_cast<S*>(smem + L.r);
  float* sg = smem + L.g;
  float* sa = smem + L.a;
  float* sf = smem + L.f;
  const int sraw = RB * kCT;  // stream elements of one raw stage
  const int sa_stage = pad4(P * N * Np);

  const int ps = blockIdx.y * p.pps;
  const int pe = min(c.pairs, ps + p.pps);
  const int nchunks = pe > ps ? (pe - ps + P - 1) / P : 0;

  auto issue = [&](int it, int s) {
    const int pair0 = ps + it * P, np = min(P, pe - pair0);
    const size_t row0 = (size_t)pair0 * N;
    load_tile(ss + s * sraw, kCT, src + row0 * width + f0, width, RB, kCT,
              np * N, width - f0);
    if (!xjob)
      load_tile(sr + s * sraw, kCT, rus + row0 * 2 * H + f0, 2 * H, RB, kCT,
                np * N, H - f0);
    for (int u = 0; u < kGroup && tile0 + u < ntiles; ++u) {
      int fpart, gcol, ncols;
      tile_cols(tile0 + u, fpart, gcol, ncols);
      load_tile(sg + s * RB * kLg + u * kCT, kLg, p.dpre + row0 * H3 + gcol,
                H3, RB, kCT, np * N, ncols);
    }
    if (m > 0)
      for (int i = threadIdx.x; i < np * NN; i += blockDim.x) {
        const int q = i / NN, e = i - q * NN, n = e / N;
        const int b = c.a_batch == 1 ? 0 : (pair0 + q) % c.B;
        cp_word(sa + s * sa_stage + q * N * Np + n * Np + (e - n * N),
                c.a_ops + ((size_t)m * c.a_batch + b) * NN + e);
      }
    cp_commit();
  };

  // zero: the feature tile's pad rows and the operators' pad columns stay so
  for (int i = threadIdx.x; i < RB * kLf; i += blockDim.x) sf[i] = 0.0f;
  for (int i = threadIdx.x; i < 2 * sa_stage; i += blockDim.x) sa[i] = 0.0f;
  __syncthreads();

  // warp: feature row tile ft, column tile u of the group
  const int warp = threadIdx.x >> 5, ft = warp & 3, u = warp >> 2;
  int fpart = 0, gcol = 0, ncols = 0;
  if (tile0 + u < ntiles) tile_cols(tile0 + u, fpart, gcol, ncols);
  const int nt_live = min(8, (ncols + 7) / 8);
  float acc[8][4] = {}, sum[8][4] = {};
  float db = 0.0f;
  if (nchunks) issue(0, 0);
  for (int it = 0; it < nchunks; ++it) {
    const int s = it & 1;
    const int np = min(P, pe - (ps + it * P));
    if (it + 1 < nchunks) {
      issue(it + 1, s ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // the features of this chunk: A_m x, or A_m h_prev and A_m (r h_prev);
    // one (part, pair, feature) per task; absent pairs' rows are zero
    const S* xs = ss + s * sraw;
    const S* rs = sr + s * sraw;
    const int parts = xjob ? 1 : 2;
    for (int task = threadIdx.x; task < parts * P * kCT;
         task += blockDim.x) {
      const int part = task / (P * kCT), e = task - part * P * kCT;
      const int q = e / kCT, col = e - q * kCT;
      float* dst = sf + q * N * kLf + part * kCT + col;
      if (q >= np) {
        for (int n = 0; n < N; ++n) dst[n * kLf] = 0.0f;
        continue;
      }
      float v[kMaxNodes];
      load_col(v, xs + q * N * kCT + col, kCT, N);
      if (part) {
        float r[kMaxNodes];
        load_col(r, rs + q * N * kCT + col, kCT, N);
#pragma unroll
        for (int k = 0; k < kMaxNodes; ++k) v[k] *= r[k];
      }
      apply_rows(v, m ? sa + s * sa_stage + q * N * Np : nullptr, N, dst,
                 kLf);
    }
    if (with_db && threadIdx.x < kGroup * kCT) {
      const float* gs = sg + s * RB * kLg + threadIdx.x;
      for (int r = 0; r < np * N; ++r) db += gs[r * kLg];
    }
    __syncthreads();
    // acc (16 features x 64 columns) += F^T G over the chunk's rows
    if (nt_live > 0) {
      const float* gs = sg + s * RB * kLg + u * kCT;
      for (int ks = 0; ks < RB; ks += 16)
        mma_k16<BF16>(acc, sf + ks * kLf + fpart * kCT + 16 * ft, 1, kLf,
                      gs + ks * kLg, kLg, 1, nt_live);
      flush(sum, acc);
    }
    __syncthreads();
  }

  // this split's slab: [dWxg (MD,2H) | dWxc (MD,H) | dWg (MH,2H) |
  // dWc (MH,H) | dbg (2H) | dbc (H)]
  const int MD = M * D, MH = M * H;
  float* slab = p.part + (size_t)blockIdx.y * (size_t)((MD + MH) * H3 + H3);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (nt_live > 0)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = f0 + 16 * ft + g + (e >> 1) * 8;
        const int col = gcol + 8 * j + 2 * t + (e & 1);  // of dpre's 3H
        if (f >= width || col - gcol >= ncols) continue;
        const int fr = m * width + f;
        float* o;
        if (xjob)
          o = col < 2 * H ? slab + (size_t)fr * 2 * H + col
                          : slab + (size_t)MD * 2 * H + (size_t)fr * H +
                                (col - 2 * H);
        else if (fpart == 0)
          o = slab + (size_t)MD * H3 + (size_t)fr * 2 * H + col;
        else
          o = slab + (size_t)MD * H3 + (size_t)MH * 2 * H + (size_t)fr * H +
              (col - 2 * H);
        *o = sum[j][e];
      }
  if (with_db && threadIdx.x < kGroup * kCT) {
    const int col = (tile0 + threadIdx.x / kCT) * kCT + threadIdx.x % kCT;
    if (col < H3) slab[(size_t)(MD + MH) * H3 + col] = db;
  }
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

// The dW launch of p (sets its chunk geometry): shared memory bytes (-1:
// none fits), threads, and the blocks of one split.
template <typename S>
int dw_shape(DwParams& p, int& threads, dim3& blocks) {
  const int smem = fit(p.c, 6, [](const Common& k) {
    return DwSmem(k, sizeof(S)).total * 4;
  });
  const int ntiles = max(p.nt_x, p.nt_g + p.nt_c);
  threads = 32 * 4 * min(kGroup, ntiles);
  blocks = dim3(p.c.M * (p.nd_x + p.nd_h), 1, ceil_div(ntiles, kGroup));
  return smem;
}

template <typename S>
int dw(DwParams p, int splits, cudaStream_t stream) {
  int threads;
  dim3 grid;
  const int smem = dw_shape<S>(p, threads, grid);
  grid.y = splits;
  return run(xin_dw_kernel<S, sizeof(S) == 2>, smem, grid, threads, stream,
             p);
}

// The split count: whole waves of the blocks the current device holds at
// once (a partial last wave would leave SMs idle for a whole block's
// time), the fewest waves whose splits sum at most kMaxSplitPairs pairs
// each, none empty. -1 when the shape does not fit or the device cannot
// be queried.
template <typename S>
int dw_splits(DwParams p) {
  int threads;
  dim3 blocks;
  const int smem = dw_shape<S>(p, threads, blocks);
  if (smem < 0) return -1;
  auto kern = xin_dw_kernel<S, sizeof(S) == 2>;
  int dev, sms, per_sm;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    return -1;
  const int per_split = blocks.x * blocks.z;
  for (int waves = 1;; ++waves) {
    const int splits = max(1, waves * sms * per_sm / per_split);
    const int pps = ceil_div(p.c.pairs, splits);
    if (pps <= kMaxSplitPairs || splits >= p.c.pairs)
      return ceil_div(p.c.pairs, pps);  // none empty
  }
}

Common common(const float* a_ops, int a_batch, const float* wx, int T, int B,
              int N, int D, int H, int M) {
  return Common{a_ops, wx, T * B, B, N, D, 3 * H, M, a_batch, Geom{1, 16}};
}

DwParams dw_params(const void* x, const void* h_prev, const void* ru,
                   const float* dpre, const float* a_ops, int a_batch,
                   float* part, int splits, int T, int B, int N, int D,
                   int H, int M) {
  const Common c = common(a_ops, a_batch, nullptr, T, B, N, D, H, M);
  return DwParams{c,
                  x,
                  h_prev,
                  ru,
                  dpre,
                  part,
                  H,
                  ceil_div(c.pairs, splits),
                  ceil_div(D, kCT),
                  ceil_div(H, kCT),
                  ceil_div(3 * H, kCT),
                  ceil_div(2 * H, kCT),
                  ceil_div(H, kCT)};
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
// written. x, h_prev, ru in the stream dtype; dpre f32.
int dcgru_xin_dw(const void* x, const void* h_prev, const void* ru,
                 const float* dpre, const float* a_ops, int a_batch,
                 float* part, int splits, int T, int B, int N, int D, int H,
                 int M, int bf16, void* stream) {
  const DwParams p = dw_params(x, h_prev, ru, dpre, a_ops, a_batch, part,
                               splits, T, B, N, D, H, M);
  if (!valid(p.c, H) || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dw<__nv_bfloat16>(p, splits, s) : dw<float>(p, splits, s);
}

// The split count dcgru_xin_dw takes for this shape on the current
// device; -1 when the shape is not valid or does not fit.
int dcgru_xin_dw_splits(int T, int B, int N, int D, int H, int M,
                        int bf16) {
  const DwParams p = dw_params(nullptr, nullptr, nullptr, nullptr, nullptr, 1,
                               nullptr, 1, T, B, N, D, H, M);
  if (!valid(p.c, H)) return -1;
  return bf16 ? dw_splits<__nv_bfloat16>(p) : dw_splits<float>(p);
}

const char* dcgru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
