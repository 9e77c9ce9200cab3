// Device helpers shared by the kernels of this directory: stream
// conversions, activations, the shared-memory layout rule, the
// warp-level tensor-core fragments and cp.async copies of the bulk
// products (dcgru_xin_gemm.cu, sddmm.cu, fused_diffusion_conv.cu), and
// the tensor-core step products and operator applies of the serial state
// loops: the encoder's (dcgru_recurrence.cu, dcgru_recurrence_bwd.cu)
// and the seq2seq decoder's (dcgru_decoder.cu).
//
// Conventions: node rows are ragged (N <= kMaxNodes) and masked; features
// and weights are m-major, row n of an (N, M*W) feature slab holding
// [A_0 v | A_1 v | ... ] with A_0 = I.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dcgru {

constexpr int kMaxNodes = 32;  // node count the fragment tiles admit

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename S>
__device__ __forceinline__ S from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// act: 0 tanh, 1 relu, 2 linear
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 0) return tanhf(v);
  if (act == 1) return fmaxf(v, 0.0f);
  return v;
}

// act'(pre) as a function of c = act(pre)
__device__ __forceinline__ float act_grad(float c, int act) {
  if (act == 0) return 1.0f - c * c;
  if (act == 1) return c > 0.0f ? 1.0f : 0.0f;
  return 1.0f;
}

// shared-memory arrays start 16-byte aligned
__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// Floats of one cell's dW slab at input width D:
// [dWxg (MD,2H) | dWxc (MD,H) | dWg (MH,2H) | dWc (MH,H) | dbg (2H) | dbc (H)]
__host__ __device__ inline size_t slab_size(int D, int H, int M) {
  return (size_t)(M * D + M * H) * 3 * H + 3 * H;
}

// ---------------------------------------------------------------------------
// tensor-core fragments (warp-level mma.sync)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// v rounded to TF32's 10 mantissa bits, to nearest with ties away from
// zero: for v not NaN the bits of cvt.rna.tf32.f32 (an infinity stays
// one), in two integer ops rather than on the conversion unit, which
// issues at a fraction of the integer rate and would limit the 3xTF32
// products below. The add carries a NaN's mantissa into its exponent or
// sign (0x7fffffff becomes -0): split_tf32 keeps the NaN in lo.
__device__ __forceinline__ uint32_t round_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// 3xTF32: v = hi + lo; hi*hi + hi*lo + lo*hi carries ~f32 accuracy
// through the TF32 tensor cores (lo*lo is below f32 rounding). lo goes in
// as the f32 bits of v - hi, exact since hi is v rounded: the tensor
// cores read its TF32 bits, cut toward zero rather than rounded (the
// same parity on the H100 as rounding it, one op less per element). A
// NaN v makes v - hi NaN, so lo spreads it through the products as f32
// does (an infinite v gives NaN too, as a split by cvt.rna does).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = round_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8) += a (16 x 8) b (8 x 8). Lane (g = lane / 4, t = lane % 4)
// holds a[g][t], a[g+8][t], a[g][t+4], a[g+8][t+4]; b[t][g], b[t+4][g];
// d[g][2t], d[g][2t+1], d[g+8][2t], d[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma_bf16 / mma_tf32 above without `volatile`: an mma is a pure function
// of its registers, so the compiler may interleave independent products
// and move operand loads above them. (The volatile
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

// The tensor cores add in f32 without rounding to nearest, so a long sum
// in one accumulator drifts one way: over a dW split's ~1,700 adds it
// moved float32 gradients by 1e-4 (measured on the H100). A long
// reduction adds each chunk's partial product into `sum` with an ordinary
// f32 add, and the accumulator starts again at 0.
template <int J>
__device__ __forceinline__ void flush(float (&sum)[J][4], float (&acc)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sum[j][e] += acc[j][e];
      acc[j][e] = 0.0f;
    }
}

// ---------------------------------------------------------------------------
// cp.async: global -> shared copies that bypass the registers
// ---------------------------------------------------------------------------

// 4 stream elements (16 or 8 bytes), zero-filled when not valid
template <typename S>
__device__ __forceinline__ void cp_quad(void* dst, const S* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 * (int)sizeof(S) : 0;
  if constexpr (sizeof(S) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
}

// one float, zero-filled when not valid
__device__ __forceinline__ void cp_word(float* dst, const float* src,
                                        bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// bytes (a multiple of 16) from global to shared memory, by the whole block
__device__ __forceinline__ void cp_block(void* dst, const void* src,
                                         int bytes) {
  for (int i = 16 * threadIdx.x; i < bytes; i += 16 * blockDim.x) {
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(static_cast<char*>(dst) + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(static_cast<const char*>(src) + i));
  }
}

// rows x width stream elements (width % 4 == 0), dense in global memory,
// into shared rows ldd elements apart, by the whole block
template <typename S>
__device__ __forceinline__ void cp_rows(S* dst, int ldd, const S* src,
                                        int rows, int width) {
  const int quads = width / 4;
  for (int q = threadIdx.x; q < rows * quads; q += blockDim.x) {
    const int r = q / quads, c = 4 * (q - r * quads);
    cp_quad(dst + r * ldd + c, src + 4 * q, true);
  }
}

// ---------------------------------------------------------------------------
// serial-chain products: the state loops' per-step tensor-core products
// ---------------------------------------------------------------------------
//
// A step's product is out (R x N) = A (R x K) F^T, with A a weight matrix
// fixed for the whole loop and F (N x K) the step's features, node rows
// in shared memory. A is the mma's A operand: the wrapper stages it once
// (ops/cuda_recurrent.py, stage_chain_weights) as 16-row tiles by
// kDepth-deep tiles, zero-padded, each tile 32 lanes x 16 bytes in the
// order the lanes hold their fragment, so a warp reads a tile as one
// conflict-free 16-byte load a lane, from shared memory or from L2. F is
// the B operand: 8-node tiles, K padded with zeros to the tile depth.
//   bf16 streams: bf16 operands (m16n8k16), f32 accumulation: the
//     reference's one bf16 MXU pass (pallas_recurrent.py:113-122).
//   f32 streams:  3xTF32 (m16n8k8, hi*hi + hi*lo + lo*hi), ~f32.

constexpr int kChainNTiles = 4;  // 8-node tiles: kMaxNodes / 8

template <typename FT>
struct ChainOps;

template <>
struct ChainOps<__nv_bfloat16> {
  static constexpr int kDepth = 16;
  // feature row stride (elements): 32-bit B loads of a warp hit 32 banks
  __host__ __device__ static int ld(int K) { return ((K + 15) & ~15) + 8; }

  // acc[i] = A tile row (ktiles deep) x F^T for the node tiles n0 + i,
  // i < cnt. a: the row tile's first k tile; f: feature rows.
  __device__ __forceinline__ static void product(
      float (&acc)[kChainNTiles][4], const uint4* __restrict__ a,
      int ktiles, const __nv_bfloat16* __restrict__ f, int ldf, int n0,
      int cnt) {
    const int lane = threadIdx.x & 31;
    const uint32_t* b = reinterpret_cast<const uint32_t*>(f) +
                        (((8 * n0 + (lane >> 2)) * ldf) >> 1) + (lane & 3);
    const int tile = 4 * ldf;  // 8 rows, in 32-bit words
#pragma unroll
    for (int i = 0; i < kChainNTiles; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < ktiles; ++k) {
      const uint4 w = a[32 * k + lane];
      const uint32_t fa[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < kChainNTiles; ++i)
        if (i < cnt)
          mma_bf16(acc[i], fa, b[i * tile + 8 * k], b[i * tile + 8 * k + 4]);
    }
  }
};

template <>
struct ChainOps<float> {
  static constexpr int kDepth = 8;
  // feature row stride (elements): 32-bit B loads of a warp hit 32 banks
  __host__ __device__ static int ld(int K) { return ((K + 7) & ~7) + 4; }

  // As the bf16 product, in 3xTF32; every 8 k tiles the tensor-core
  // partial is added into an f32 register sum (see flush).
  __device__ __forceinline__ static void product(
      float (&acc)[kChainNTiles][4], const uint4* __restrict__ a,
      int ktiles, const float* __restrict__ f, int ldf, int n0, int cnt) {
    const int lane = threadIdx.x & 31;
    const float* b = f + (8 * n0 + (lane >> 2)) * ldf + (lane & 3);
    float sum[kChainNTiles][4];
#pragma unroll
    for (int i = 0; i < kChainNTiles; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = sum[i][e] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < ktiles; ++k) {
      const uint4 w = a[32 * k + lane];
      uint32_t hi[4], lo[4];
      split_tf32(__uint_as_float(w.x), hi[0], lo[0]);
      split_tf32(__uint_as_float(w.y), hi[1], lo[1]);
      split_tf32(__uint_as_float(w.z), hi[2], lo[2]);
      split_tf32(__uint_as_float(w.w), hi[3], lo[3]);
#pragma unroll
      for (int i = 0; i < kChainNTiles; ++i) {
        if (i < cnt) {
          const float* bi = b + i * 8 * ldf + 8 * k;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(bi[0], bh0, bl0);
          split_tf32(bi[4], bh1, bl1);
          mma_tf32(acc[i], lo, bh0, bh1);
          mma_tf32(acc[i], hi, bl0, bl1);
          mma_tf32(acc[i], hi, bh0, bh1);
        }
      }
      if ((k & 7) == 7) flush(sum, acc);
    }
    flush(sum, acc);
#pragma unroll
    for (int i = 0; i < kChainNTiles; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = sum[i][e];
  }
};

__host__ __device__ inline int chain_rtiles(int R) { return (R + 15) / 16; }
template <typename FT>
__host__ __device__ inline int chain_ktiles(int K) {
  return (K + ChainOps<FT>::kDepth - 1) / ChainOps<FT>::kDepth;
}
// bytes of a staged A operand (R x K)
template <typename FT>
__host__ __device__ inline int chain_wbytes(int R, int K) {
  return chain_rtiles(R) * chain_ktiles<FT>(K) * 32 * 16;
}

// The product out = A F^T of one step by the whole block: warp w takes
// tasks w, w + warps, ...; a task is a 16-row tile of A and a group of
// node tiles, the groups made small enough that every warp has a task
// where the row tiles are fewer than the warps. epi(row, n, v) receives
// every element with row < R, n < N, once; a (row, n) has one owner.
template <typename FT, typename Epi>
__device__ __forceinline__ void chain_product(const uint4* a, int R, int K,
                                              const FT* f, int ldf, int N,
                                              Epi&& epi) {
  const int rtiles = chain_rtiles(R), ktiles = chain_ktiles<FT>(K);
  const int ntiles = (N + 7) / 8;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int groups = min(ntiles, max(1, (warps + rtiles - 1) / rtiles));
  const int per = (ntiles + groups - 1) / groups;
  groups = (ntiles + per - 1) / per;
  for (int task = warp; task < rtiles * groups; task += warps) {
    const int rt = task / groups, n0 = (task - rt * groups) * per;
    const int cnt = min(per, ntiles - n0);
    float acc[kChainNTiles][4];
    ChainOps<FT>::product(acc, a + (size_t)rt * ktiles * 32, ktiles, f, ldf,
                          n0, cnt);
    // one copy of the epilogue's code: node tile i is in acc[0] when its
    // turn comes (the step's code runs once a step, so its size costs)
#pragma unroll 1
    for (int i = 0; i < cnt; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * rt + g + 8 * (e >> 1);
        const int n = 8 * (n0 + i) + 2 * t + (e & 1);
        if (row < R && n < N) epi(row, n, acc[0][e]);
      }
#pragma unroll
      for (int j = 0; j + 1 < kChainNTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = acc[j + 1][e];
    }
  }
}

// The launch plan of a state loop: the first Plan(N, H, M, wsmem, nbuf)
// whose shared memory (.total bytes) the current card gives a block, with
// the staged weights in shared memory before two stream buffers before
// the weights in L2. false where none fits.
template <typename Plan>
bool choose_plan(int N, int H, int M, bool& wsmem, int& nbuf, int& bytes) {
  int dev = 0, cap = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  for (int i = 0; i < 4; ++i) {
    wsmem = i < 2;
    nbuf = 2 - (i & 1);
    bytes = Plan(N, H, M, wsmem, nbuf).total;
    if (bytes <= cap) return true;
  }
  return false;
}

// A row stride (elements) of an f32 or stream array in shared memory that
// a chain product's epilogue reads or writes: the lanes of one access
// (8 rows of A, 4 node pairs) hit 32 banks.
__host__ __device__ inline int chain_ld(int W) { return ((W + 15) & ~15) + 4; }

// ---------------------------------------------------------------------------
// a step's operator applies on tensor cores (3xTF32)
// ---------------------------------------------------------------------------
//
// The clip's operators A_1..A_{M-1} (or their transposes) as TF32 A
// fragments of 16-row by 8-deep tiles over N x N, zero-padded and split
// once into hi and lo when the block starts: [m-1][rt][kt][hi | lo]
// [lane] 16 bytes. A step's source is the B operand, f32 in shared memory,
// split as it is read; its node rows N .. 8*ceil(N/8) must hold zeros.

__host__ __device__ inline int op_frag_bytes(int N, int M) {
  return (M - 1) * ((N + 15) / 16) * ((N + 7) / 8) * 2 * 32 * 16;
}

// by the whole block, from the clip's (M, a_batch, N, N) slice a_clip
__device__ __forceinline__ void stage_op_frags(uint4* dst,
                                               const float* a_clip,
                                               int a_batch, int N, int M,
                                               bool transpose) {
  const int RT = (N + 15) / 16, KT = (N + 7) / 8;
  for (int it = threadIdx.x; it < (M - 1) * RT * KT * 32;
       it += blockDim.x) {
    const int lane = it & 31, tile = it >> 5;
    const int kt = tile % KT, rt = (tile / KT) % RT, m = tile / (KT * RT) + 1;
    const int g = lane >> 2, t = lane & 3;
    const float* a = a_clip + (size_t)m * a_batch * N * N;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = 16 * rt + g + 8 * (q & 1);
      const int col = 8 * kt + t + 4 * (q >> 1);
      float v = 0.0f;
      if (row < N && col < N)
        v = transpose ? a[col * N + row] : a[row * N + col];
      split_tf32(v, hi[q], lo[q]);
    }
    dst[64 * tile + lane] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    dst[64 * tile + 32 + lane] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// acc (node rows 16 rt.., columns 8 ct..) = sum over m in [m0, m1) of the
// operator tiles of row rt times B_m, B_m(k, c) = src(k, m, c)
template <typename Src>
__device__ __forceinline__ void op_product(float (&acc)[4],
                                           const uint4* __restrict__ frags,
                                           int RT, int KT, int rt, int ct,
                                           int m0, int m1, Src&& src) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = 0.0f;
  for (int m = m0; m < m1; ++m) {
    const uint4* f = frags + (size_t)((m - 1) * RT + rt) * KT * 64 + lane;
    for (int kt = 0; kt < KT; ++kt) {
      const uint4 h = f[64 * kt], l = f[64 * kt + 32];
      const uint32_t hi[4] = {h.x, h.y, h.z, h.w};
      const uint32_t lo[4] = {l.x, l.y, l.z, l.w};
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(src(8 * kt + t, m, 8 * ct + g), bh0, bl0);
      split_tf32(src(8 * kt + t + 4, m, 8 * ct + g), bh1, bl1);
      mma_tf32(acc, lo, bh0, bh1);
      mma_tf32(acc, hi, bl0, bl1);
      mma_tf32(acc, hi, bh0, bh1);
    }
  }
}

// A chain's diffusions of one step by the whole block, into a feature
// buffer: dst[n * ldd + m * W + c] = (A_m src)[n, c] rounded to the
// operand type, for m < M, n < N, c < W (A_0 = I: a copy). src(k, c):
// element (k, c) of the (N, W) source, read for k < 8*ceil(N/8) and
// c < 8*ceil(W/8). A warp takes an (m, 16-row, 8-column) tile.
template <typename FT, typename Src>
__device__ __forceinline__ void diffuse_tc(const uint4* frags, Src&& src,
                                           int N, int M, int W, FT* dst,
                                           int ldd) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int n = threadIdx.x >> 5; n < N; n += blockDim.x >> 5)
    for (int c = lane; c < W; c += 32) dst[n * ldd + c] = from_f<FT>(src(n, c));
  const int RT = (N + 15) / 16, KT = (N + 7) / 8, CT = (W + 7) / 8;
  for (int task = threadIdx.x >> 5; task < (M - 1) * RT * CT;
       task += blockDim.x >> 5) {
    const int ct = task % CT, rt = (task / CT) % RT, m = task / (CT * RT) + 1;
    float acc[4];
    op_product(acc, frags, RT, KT, rt, ct, m, m + 1,
               [&](int k, int, int c) { return src(k, c); });
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 16 * rt + g + 8 * (e >> 1), c = 8 * ct + 2 * t + (e & 1);
      if (n < N && c < W) dst[n * ldd + m * W + c] = from_f<FT>(acc[e]);
    }
  }
}

// The adjoint, by the whole block: epi(n, c, v) receives, once for each
// n < N, c < W, v = src_0[n, c] + sum_{m>0} (A_m^T src_m)[n, c] for the
// (N, M*W) m-major slab src (row stride lds; its rows N .. 8*ceil(N/8)
// zero), frags the transposed operators. A warp takes a 16-row,
// 8-column tile and sums over m.
template <typename Epi>
__device__ __forceinline__ void diffuse_t_tc(const uint4* frags,
                                             const float* src, int lds,
                                             int N, int M, int W, Epi&& epi) {
  const int RT = (N + 15) / 16, KT = (N + 7) / 8, CT = (W + 7) / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int task = threadIdx.x >> 5; task < RT * CT; task += blockDim.x >> 5) {
    const int ct = task % CT, rt = task / CT;
    float acc[4];
    op_product(acc, frags, RT, KT, rt, ct, 1, M, [&](int k, int m, int c) {
      return src[k * lds + m * W + c];
    });
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 16 * rt + g + 8 * (e >> 1), c = 8 * ct + 2 * t + (e & 1);
      if (n < N && c < W) epi(n, c, src[n * lds + c] + acc[e]);
    }
  }
}

// ---------------------------------------------------------------------------
// phase clocks of the state loops and the bulk dW kernel: compiled in
// only with -DDCGRU_PROBE (loop_probe.py builds such a library beside the
// real one); the kernels' own builds have none of it
// ---------------------------------------------------------------------------

constexpr int kProbeSlots = 48;

#ifdef DCGRU_PROBE
// block 0's clocks in each phase, summed over its steps and launches
__device__ unsigned long long probe_cycles[kProbeSlots];
#define DCGRU_PROBE_START           \
  long long probe_last = clock64(); \
  long long probe_acc[kProbeSlots] = {}
#define DCGRU_PROBE_MARK(i)                   \
  do {                                        \
    const long long now = clock64();          \
    probe_acc[i] += now - probe_last;         \
    probe_last = now;                         \
  } while (0)
#define DCGRU_PROBE_STORE                                          \
  do {                                                             \
    if (blockIdx.x == 0 && threadIdx.x == 0)                       \
      for (int i = 0; i < kProbeSlots; ++i)                        \
        probe_cycles[i] += (unsigned long long)probe_acc[i];       \
  } while (0)
// thread 0 of a block of role `role` >= 0: slots [role*n, role*n + n)
#define DCGRU_PROBE_STORE_ROLE(role, n)                          \
  do {                                                           \
    if ((role) >= 0 && threadIdx.x == 0)                         \
      for (int i = 0; i < (n); ++i)                              \
        probe_cycles[(role) * (n) + i] +=                        \
            (unsigned long long)probe_acc[i];                    \
  } while (0)
#define DCGRU_PROBE_COUNT(i) (probe_acc[i] += 1)
#else
#define DCGRU_PROBE_START
#define DCGRU_PROBE_MARK(i)
#define DCGRU_PROBE_STORE
#define DCGRU_PROBE_STORE_ROLE(role, n)
#define DCGRU_PROBE_COUNT(i)
#endif

}  // namespace dcgru
