// Fused diffusion convolution, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel of eeg_gnn_tpu/ops/pallas_kernels.py
// (:32, launched from _fused_forward :69/:82; front door fused_diffusion_conv
// :141). For every clip b, with S per-clip supports and K diffusion steps:
//   T_0 = x_b; then, support by support, T = A_s T_i0, and for k = 2..K
//   T = 2 A_s T_i1 - T_i0, where i0 / i1 are the two previous terms and are
//   NOT reset between supports (the reference's carry-over quirk,
//   pallas_kernels.py:52-64, ops/diffusion.py);
//   out_b = sum_m T_m W_m + bias,  M = S*K + 1 terms.
// Only the use_pallas per-step loop of models/dcgru runs it: two launches
// per step and layer, on the hidden state (gate) and on r*h (candidate).
// Its gradient is the autograd of the plain diffusion conv (the JAX package
// has no backward kernel for it either).
//
// What bounds it on an H100. At the loop's shapes (B=128, N=19, D=H=64,
// O=128 or 64, M=3 or 5) one launch does 0.07-0.23 GFLOP and moves ~2 MB,
// ~1-4 us of work at the card's 67 TFLOP/s non-tensor f32 rate: it is
// bound by the launch itself, and the loop by the host that enqueues 240
// of them per forward.
//
// Design (simple and right first).
// - One thread block per clip, as the TPU's batch-tile grid without the
//   tile: no batch padding, and the ragged 19 node rows are masked.
// - The clip's S supports and the (N, M*D) term slab [T_0 | T_1 | ...] stay
//   in shared memory (27 KB at M=5, D=64); each term is built from the
//   earlier ones with one thread per (node, feature) and a block barrier.
// - The weight (M*D, O) is read from global memory (L2-resident across the
//   batch), one coalesced output column per thread and each value reused
//   for kRows node rows in registers (dcgru_common.cuh gemm_col); f32 FMA,
//   bias added, (B, N, O) f32 written.

#include "dcgru_common.cuh"

namespace {

using namespace dcgru;

struct Params {
  const float* sup;   // (S, B, N, N)
  const float* x;     // (B, N, D)
  const float* w;     // (M, D, O) = (M*D, O), m-major rows
  const float* bias;  // (O)
  float* out;         // (B, N, O)
  int S, B, N, D, O, K, M;
};

// dst term = (twice ? 2 A src - sub : A src), one thread per (n, d)
__device__ __forceinline__ void cheb_term(const float* __restrict__ A,
                                          float* f, int N, int D, int MD,
                                          int dst, int src, int sub,
                                          bool twice) {
  for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
    const int n = i / D, d = i - n * D;
    const float* a = A + n * N;
    const float* v = f + src * D + d;
    float acc = 0.0f;
    for (int k = 0; k < N; ++k) acc = fmaf(a[k], v[k * MD], acc);
    if (twice) acc = 2.0f * acc - f[n * MD + sub * D + d];
    f[n * MD + dst * D + d] = acc;
  }
}

__global__ void __launch_bounds__(kMaxThreads) fdc_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, D = p.D, MD = p.M * p.D, NN = p.N * p.N;
  const int b = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  float* sA = smem;                  // (S, N, N) supports of clip b
  float* sF = smem + pad4(p.S * NN);  // (N, M*D) terms, m-major per row

  for (int i = tid; i < p.S * NN; i += nthr) {
    const int s = i / NN;
    sA[i] = p.sup[((size_t)s * p.B + b) * NN + (i - s * NN)];
  }
  const float* xb = p.x + (size_t)b * N * D;
  for (int i = tid; i < N * D; i += nthr) {
    const int n = i / D;
    sF[n * MD + (i - n * D)] = xb[i];
  }
  __syncthreads();

  // Chebyshev terms; i0 (the reference's x0) carries over across supports
  int i0 = 0, mi = 1;
  for (int s = 0; s < p.S && p.K > 0; ++s) {
    const float* A = sA + s * NN;
    cheb_term(A, sF, N, D, MD, mi, i0, 0, false);
    int i1 = mi++;
    __syncthreads();
    for (int k = 2; k <= p.K; ++k) {
      cheb_term(A, sF, N, D, MD, mi, i1, i0, true);
      i0 = i1;
      i1 = mi++;
      __syncthreads();
    }
  }

  // out[n, j] = bias[j] + sum_{m,d} T_m[n, d] W[m*D + d, j]
  const int chunks = (N + kRows - 1) / kRows;
  float* ob = p.out + (size_t)b * N * p.O;
  for (int task = tid; task < p.O * chunks; task += nthr) {
    const int chunk = task / p.O, j = task - chunk * p.O;
    const int r0 = chunk * kRows;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    gemm_col(acc, sF, MD, r0, N, p.w + j, p.O);
    const float bj = p.bias[j];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r0 + r < N) ob[(r0 + r) * p.O + j] = acc[r] + bj;
  }
}

int threads_for(int N, int O) {
  const int chunks = (N + kRows - 1) / kRows;
  int nthr = ((O * chunks + 31) / 32) * 32;
  if (nthr < 128) nthr = 128;
  if (nthr > kMaxThreads) nthr = kMaxThreads;
  return nthr;
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a launch that was accepted.
int fused_diffusion_conv_fwd(const float* sup, const float* x, const float* w,
                             const float* bias, float* out, int S, int B,
                             int N, int D, int O, int K, int M,
                             void* stream) {
  if (N < 1 || N > kMaxNodes || D < 4 || D % 4 || O < 1 || B < 1 || S < 0 ||
      K < 0 || M != S * K + 1)
    return (int)cudaErrorInvalidValue;
  Params p{sup, x, w, bias, out, S, B, N, D, O, K, M};
  const size_t smem = (size_t)(pad4(S * N * N) + N * M * D) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      fdc_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fdc_fwd_kernel<<<B, threads_for(N, O), smem,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* fdc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
