// Device helpers shared by the kernels of this directory: stream
// conversions, activations, the shared-memory layout rule, the small
// per-thread products every recurrence step is built from (f32 FMA), and
// the warp-level tensor-core fragments and cp.async copies of the bulk
// products (dcgru_xin_gemm.cu, sddmm.cu).
//
// Conventions: node rows are ragged (N <= kMaxNodes) and masked; features
// and weights are m-major, row n of an (N, M*W) feature slab holding
// [A_0 v | A_1 v | ... ] with A_0 = I.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dcgru {

constexpr int kMaxNodes = 32;     // node count the register arrays admit
constexpr int kRows = 10;         // node rows per output-column task
constexpr int kTRows = 8;         // node rows per A^T-apply task
constexpr int kWRows = 4;         // dW rows per accumulation task
constexpr int kMaxThreads = 384;  // __launch_bounds__: <= 168 regs/thread

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

// shared-memory arrays start 16-byte aligned: sizes are padded to 4 floats
__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// Floats of one cell's dW slab at input width D:
// [dWxg (MD,2H) | dWxc (MD,H) | dWg (MH,2H) | dWc (MH,H) | dbg (2H) | dbc (H)]
__host__ __device__ inline size_t slab_size(int D, int H, int M) {
  return (size_t)(M * D + M * H) * 3 * H + 3 * H;
}

// acc[r] += sum_k f[row_r, k] * w[k * ldw] over k < K, rows r0.. (clamped
// to N-1: surplus rows of a ragged chunk repeat the last row and are never
// stored). f rows are K floats, K % 4 == 0, 16-byte aligned.
__device__ __forceinline__ void gemm_col(float (&acc)[kRows],
                                         const float* __restrict__ f, int K,
                                         int r0, int N,
                                         const float* __restrict__ w,
                                         int ldw) {
  const float4* f4 = reinterpret_cast<const float4*>(f);
  const int K4 = K / 4;
  int row[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) row[r] = min(r0 + r, N - 1) * K4;
#pragma unroll 2
  for (int k4 = 0; k4 < K4; ++k4) {
    const float* wk = w + (size_t)(4 * k4) * ldw;
    const float w0 = __ldg(wk), w1 = __ldg(wk + ldw),
                w2 = __ldg(wk + 2 * ldw), w3 = __ldg(wk + 3 * ldw);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 v = f4[row[r] + k4];
      acc[r] = fmaf(v.x, w0, acc[r]);
      acc[r] = fmaf(v.y, w1, acc[r]);
      acc[r] = fmaf(v.z, w2, acc[r]);
      acc[r] = fmaf(v.w, w3, acc[r]);
    }
  }
}

// dst[n * ldd] = sum_k A_m[n, k] * v[k] for the column v already in
// registers; m == 0 is the identity. sA holds A_1..A_{M-1}.
__device__ __forceinline__ void diffuse_col(const float (&v)[kMaxNodes],
                                            const float* __restrict__ sA,
                                            int N, int m, float* dst,
                                            int ldd) {
  if (m == 0) {
#pragma unroll
    for (int k = 0; k < kMaxNodes; ++k)
      if (k < N) dst[k * ldd] = v[k];
    return;
  }
  const float* a = sA + (m - 1) * N * N;
  for (int n = 0; n < N; ++n) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxNodes; ++k)
      if (k < N) acc = fmaf(a[n * N + k], v[k], acc);
    dst[n * ldd] = acc;
  }
}

// acc[i] = sum_m sum_k A_m[k, n0+i] * src[k * lds + m * W] for the rows
// n0 + i < N: the adjoint of the diffusion, applied to one column of the
// (N, M*W) m-major slab src.
__device__ __forceinline__ void diffuse_t_col(float (&acc)[kTRows],
                                              const float* __restrict__ sA,
                                              int N, int M,
                                              const float* src, int lds,
                                              int W, int n0) {
#pragma unroll
  for (int i = 0; i < kTRows; ++i)
    acc[i] = n0 + i < N ? src[(n0 + i) * lds] : 0.0f;
  for (int m = 1; m < M; ++m) {
    float v[kMaxNodes];
#pragma unroll
    for (int k = 0; k < kMaxNodes; ++k)
      if (k < N) v[k] = src[k * lds + m * W];
    const float* a = sA + (m - 1) * N * N;
#pragma unroll
    for (int i = 0; i < kTRows; ++i) {
      const int n = n0 + i;
      if (n < N) {
        float s = acc[i];
#pragma unroll
        for (int k = 0; k < kMaxNodes; ++k)
          if (k < N) s = fmaf(a[k * N + n], v[k], s);
        acc[i] = s;
      }
    }
  }
}

// One dW task: rows i0..i0+kWRows-1 of column j of a (rows, cols) block
// of a slab: sum_n feat[n, i] * dpre[n, j]; written when `first`, added
// otherwise.
__device__ __forceinline__ void dw_quad(const float* __restrict__ feat,
                                        int ldf, int i0,
                                        const float* __restrict__ dpre,
                                        int ldp, int j, int N, float* dst,
                                        int cols, bool first) {
  float acc[kWRows] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int n = 0; n < N; ++n) {
    const float4 f = *reinterpret_cast<const float4*>(feat + n * ldf + i0);
    const float d = dpre[n * ldp + j];
    acc[0] = fmaf(f.x, d, acc[0]);
    acc[1] = fmaf(f.y, d, acc[1]);
    acc[2] = fmaf(f.z, d, acc[2]);
    acc[3] = fmaf(f.w, d, acc[3]);
  }
  float* o = dst + (size_t)i0 * cols + j;
#pragma unroll
  for (int r = 0; r < kWRows; ++r)
    o[r * cols] = first ? acc[r] : o[r * cols] + acc[r];
}

// dst[j] (=|+=) sum_n dpre[n, j]
__device__ __forceinline__ void db_col(const float* __restrict__ dpre,
                                       int ldp, int j, int N, float* dst,
                                       bool first) {
  float acc = 0.0f;
  for (int n = 0; n < N; ++n) acc += dpre[n * ldp + j];
  dst[j] = first ? acc : dst[j] + acc;
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

}  // namespace dcgru
