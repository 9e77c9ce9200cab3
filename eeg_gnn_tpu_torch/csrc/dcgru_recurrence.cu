// Whole-sequence DCGRU layer recurrence, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the serial part of two Pallas TPU kernels of
// eeg_gnn_tpu/ops/pallas_recurrent.py:
//   dcgru_recurrence_fwd  <- _fwd_kernel (:240, launched from _forward
//                            :403/:417): the recurrence fed a precomputed
//                            fused x_proj = [gate | cand] in the stream dtype.
//   (xp_f32)              <- the state half of _fwd_kernel_xin (:730, launched
//                            from _forward_xin :902/:922): the same loop fed
//                            the f32 XP of dcgru_xin_proj (dcgru_xin_gemm.cu),
//                            which the TPU kernel adds unrounded (:766-767).
//
// One step, for every clip b (A_0 = I, M = S*K + 1 operators):
//   ru      = sigmoid(x_proj[:2H] + (A_m h) W_g + b_g)
//   c       = act(x_proj[2H:] + (A_m (r*h)) W_c + b_c)
//   h'      = u*h + (1-u)*c
//
// What bounds it on an H100. At the flagship shape (T=60, B=128, N=19,
// H=64, M=3) a layer does ~14 GFLOP on its serial chain (the diffusions of
// h and r*h and the hidden products), ~0.2 ms at the card's 67 TFLOP/s
// non-tensor f32 rate, which is what this kernel uses (f32 FMA, no TF32),
// against ~25-40 us for its streams at 3.35 TB/s. The time loop is
// sequential, so the parallelism is the batch.
//
// Design.
// - One thread block per clip with the T loop inside the block: the TPU's
//   sequential (batch-tile, time) grid becomes an in-block loop, and 128
//   clips fill ~all 132 SMs. The forward needs no cross-block reduction.
// - h (f32), the clip's M-1 non-identity operators, the step's x_proj slab
//   and the diffused features stay in shared memory for all T steps. The
//   TPU's 19 -> 24 node padding and J-clip block diagonals are not needed:
//   the ragged 19 rows are masked here.
// - The hidden weights are read from global memory, where they stay
//   L2-resident across the batch, one coalesced column per thread; every
//   weight value read is used for up to kRows rows held in registers, and
//   the features are read as 16-byte shared-memory broadcasts.
// - Streams (h_seq, ru_seq, c_seq) are f32 or bf16, x_proj the stream dtype
//   or f32; state, operators, weights and accumulation are f32
//   (pallas_recurrent.py:744,777). ru_seq / c_seq are written only when
//   their pointers are non-null.
// Tensor cores for the chain, bf16 weights and several clips per block are
// later work.

#include "dcgru_common.cuh"

namespace {

using namespace dcgru;

struct Params {
  const void* x_proj;  // (T, B, N, 3H) = [gate | cand], no biases
  const float* a_ops;  // (M, a_batch, N, N), a_batch in {1, B}
  const float* wg;     // (M*H, 2H) m-major rows
  const float* wc;     // (M*H, H)
  const float* bg;     // (2H)
  const float* bc;     // (H)
  const float* h0;     // (B, N, H) f32
  void* h_seq;         // (T, B, N, H)
  void* ru_seq;        // (T, B, N, 2H) or null
  void* c_seq;         // (T, B, N, H) or null
  int T, B, N, H, M, a_batch, act;
};

// Shared-memory layout, in floats; every array starts 16-byte aligned.
struct Smem {
  int a, h, in, hf, ru, total;
  __host__ __device__ Smem(int N, int H, int M) {
    a = 0;                                     // (M-1, N, N) operators
    h = a + pad4((M - 1) * N * N);             // (N, H) state
    in = h + pad4(N * H);                      // (N, 3H) step x_proj slab
    hf = in + pad4(N * 3 * H);                 // (N, M*H) state features
    ru = hf + pad4(N * M * H);                 // (N, 2H) gates
    total = ru + pad4(N * 2 * H);
  }
};

// S: the dtype of h_seq, ru_seq, c_seq; X: of x_proj (S, or f32).
template <typename S, typename X>
__global__ void __launch_bounds__(kMaxThreads)
    dcgru_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, H = p.H, M = p.M;
  const Smem L(N, H, M);
  float* sA = smem + L.a;
  float* sh = smem + L.h;
  float* sx = smem + L.in;
  float* hf = smem + L.hf;
  float* sru = smem + L.ru;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int NN = N * N, MH = M * H, H2 = 2 * H, H3 = 3 * H;
  const int chunks = (N + kRows - 1) / kRows;

  // the clip's operators A_1..A_{M-1} (a shared graph has a_batch == 1)
  const float* a_clip = p.a_ops + (size_t)(p.a_batch == 1 ? 0 : b) * NN;
  for (int i = tid; i < (M - 1) * NN; i += nthr) {
    int m = i / NN + 1, e = i - (m - 1) * NN;
    sA[i] = a_clip[(size_t)m * p.a_batch * NN + e];
  }
  for (int i = tid; i < N * H; i += nthr) sh[i] = p.h0[(size_t)b * N * H + i];

  const X* xs = static_cast<const X*>(p.x_proj);
  S* hseq = static_cast<S*>(p.h_seq);
  S* ruseq = static_cast<S*>(p.ru_seq);
  S* cseq = static_cast<S*>(p.c_seq);

  for (int t = 0; t < p.T; ++t) {
    const size_t slab = (size_t)t * p.B + b;  // (t, b) row of every stream
    const X* xt = xs + slab * N * H3;
    for (int i = tid; i < N * H3; i += nthr) sx[i] = to_f(xt[i]);
    // diffuse h: one (m, column) per task
    for (int task = tid; task < M * H; task += nthr) {
      int m = task / H, c = task - m * H;
      float v[kMaxNodes];
#pragma unroll
      for (int k = 0; k < kMaxNodes; ++k)
        if (k < N) v[k] = sh[k * H + c];
      diffuse_col(v, sA, N, m, hf + m * H + c, MH);
    }
    __syncthreads();

    // phase 1: gates
    for (int task = tid; task < H2 * chunks; task += nthr) {
      const int chunk = task / H2, j = task - chunk * H2;
      const int r0 = chunk * kRows;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      gemm_col(acc, hf, MH, r0, N, p.wg + j, H2);
      const float bj = p.bg[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = r0 + r;
        if (n < N) {
          const float v = sigmoid(acc[r] + bj + sx[n * H3 + j]);
          sru[n * H2 + j] = v;
          if (ruseq) ruseq[(slab * N + n) * H2 + j] = from_f<S>(v);
        }
      }
    }
    __syncthreads();

    // diffuse r*h into the state-feature buffer (its h features are spent)
    for (int task = tid; task < M * H; task += nthr) {
      int m = task / H, c = task - m * H;
      float v[kMaxNodes];
#pragma unroll
      for (int k = 0; k < kMaxNodes; ++k)
        if (k < N) v[k] = sru[k * H2 + c] * sh[k * H + c];
      diffuse_col(v, sA, N, m, hf + m * H + c, MH);
    }
    __syncthreads();

    // phase 2: candidate and state update; (n, j) of h has one owner
    for (int task = tid; task < H * chunks; task += nthr) {
      const int chunk = task / H, j = task - chunk * H;
      const int r0 = chunk * kRows;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      gemm_col(acc, hf, MH, r0, N, p.wc + j, H);
      const float bj = p.bc[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = r0 + r;
        if (n < N) {
          const float c = activate(acc[r] + bj + sx[n * H3 + H2 + j], p.act);
          const float u = sru[n * H2 + H + j];
          const float hn = u * sh[n * H + j] + (1.0f - u) * c;
          sh[n * H + j] = hn;
          const size_t o = (slab * N + n) * H + j;
          hseq[o] = from_f<S>(hn);
          if (cseq) cseq[o] = from_f<S>(c);
        }
      }
    }
    __syncthreads();
  }
}

int threads_for(const Params& p) {
  const int chunks = (p.N + kRows - 1) / kRows;
  int nthr = ((2 * p.H * chunks + 31) / 32) * 32;
  if (nthr < 128) nthr = 128;
  if (nthr > kMaxThreads) nthr = kMaxThreads;
  return nthr;
}

template <typename S, typename X>
int launch(const Params& p, cudaStream_t stream) {
  if (p.N > kMaxNodes || p.N < 1 || p.H % 4 || p.M < 1 || p.B < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Smem(p.N, p.H, p.M).total * 4;
  auto kern = dcgru_fwd_kernel<S, X>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<p.B, threads_for(p), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// act: 0 tanh, 1 relu, 2 linear. bf16: h_seq / ru_seq / c_seq are bf16
// (else f32); xp_f32: x_proj is f32 (else the dtype of the other streams).
// Returns a cudaError_t: 0 on a launch that was accepted.
int dcgru_recurrence_fwd(const void* x_proj, const float* a_ops, int a_batch,
                         const float* wg, const float* wc, const float* bg,
                         const float* bc, const float* h0, void* h_seq,
                         void* ru_seq, void* c_seq, int T, int B, int N,
                         int H, int M, int act, int bf16, int xp_f32,
                         void* stream) {
  Params p{x_proj, a_ops,  wg,    wc, bg, bc, h0, h_seq, ru_seq,
           c_seq,  T,      B,     N,  H,  M,  a_batch, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return launch<float, float>(p, s);
  return xp_f32 ? launch<__nv_bfloat16, float>(p, s)
                : launch<__nv_bfloat16, __nv_bfloat16>(p, s);
}

const char* dcgru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
