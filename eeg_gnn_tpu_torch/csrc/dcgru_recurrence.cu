// Whole-sequence DCGRU layer recurrence, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of eeg_gnn_tpu/ops/pallas_recurrent.py:
//   dcgru_recurrence_xin_fwd  <- _fwd_kernel_xin (:730, launched from
//                                _forward_xin :902/:922): the layer input x
//                                is diffused and projected in-kernel.
//   dcgru_recurrence_fwd      <- _fwd_kernel (:240, launched from _forward
//                                :403/:417): the same recurrence fed a
//                                precomputed fused x_proj = [gate | cand].
//
// One step, for every clip b (A_0 = I, M = S*K + 1 operators):
//   feats_m = A_m [h | x]                      (x half: xin kernel only)
//   ru      = sigmoid(xfeats Wx_g + hfeats W_g + b_g)     (or x_proj[:2H])
//   c       = act(xfeats Wx_c + (A_m (r*h)) W_c + b_c)    (or x_proj[2H:])
//   h'      = u*h + (1-u)*c
//
// What bounds it on an H100. At the flagship shape (T=60, B=128, N=19,
// H=64, D=100, M=3) layer 0 must move ~49 MB (bf16 streams; ~97 MB f32)
// but does ~30 GFLOP, so it is bound by operations: ~0.45 ms at the
// card's 67 TFLOP/s non-tensor f32 rate, which is what this kernel uses
// (f32 FMA, no TF32), against ~15-30 us for the bytes at 3.35 TB/s. The
// time loop is sequential, so the parallelism is the batch.
//
// Design.
// - One thread block per clip with the T loop inside the block: the TPU's
//   sequential (batch-tile, time) grid becomes an in-block loop, and 128
//   clips fill ~all 132 SMs. The forward needs no cross-block reduction.
// - h (f32), the clip's M-1 non-identity operators, the step's input slab
//   and the diffused features stay in shared memory for all T steps (67 KB
//   at M=3, 95 KB at M=5). The TPU's 19 -> 24 node padding and J-clip
//   block diagonals are not needed: the ragged 19 rows are masked here.
// - The weights (369 KiB f32 at M=3 layer 0) do not fit in shared memory.
//   They are read from global memory, where they stay L2-resident across
//   the batch, one coalesced column per thread; every weight value read
//   is used for up to kRows rows held in registers, and the features are
//   read as 16-byte shared-memory broadcasts.
// - Streams (x, x_proj, h_seq, ru_seq, c_seq) are f32 or bf16; state,
//   operators, weights and accumulation are f32 (pallas_recurrent.py:744,
//   777). ru_seq / c_seq are written only when their pointers are non-null.
// wgmma, TMA, bf16 weights and several clips per block are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNodes = 32;     // node count the register tiles admit
constexpr int kRows = 10;         // rows of one output column per thread
constexpr int kMaxThreads = 384;  // __launch_bounds__: <= 168 regs/thread

struct Params {
  const void* x;       // xin: (T,B,N,D); hoisted: x_proj (T,B,N,3H)
  const float* a_ops;  // (M, a_batch, N, N), a_batch in {1, B}
  const float* wxg;    // (M*D, 2H) m-major rows (xin only)
  const float* wxc;    // (M*D, H)                (xin only)
  const float* wg;     // (M*H, 2H) m-major rows
  const float* wc;     // (M*H, H)
  const float* bg;     // (2H)
  const float* bc;     // (H)
  const float* h0;     // (B, N, H) f32
  void* h_seq;         // (T, B, N, H)
  void* ru_seq;        // (T, B, N, 2H) or null
  void* c_seq;         // (T, B, N, H) or null
  int T, B, N, D, H, M, a_batch, act;
};

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

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 0) return tanhf(v);
  if (act == 1) return fmaxf(v, 0.0f);
  return v;
}

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// Shared-memory layout, in floats; every array starts 16-byte aligned.
struct Smem {
  int a, h, in, hf, xf, ru, xc, total;
  __host__ __device__ Smem(bool xin, int N, int D, int H, int M) {
    int dx = xin ? D : 3 * H;
    a = 0;                                     // (M-1, N, N) operators
    h = a + pad4((M - 1) * N * N);             // (N, H) state
    in = h + pad4(N * H);                      // (N, dx) step input slab
    hf = in + pad4(N * dx);                    // (N, M*H) state features
    xf = hf + pad4(N * M * H);                 // (N, M*D) input features
    ru = xf + (xin ? pad4(N * M * D) : 0);     // (N, 2H) gates
    xc = ru + pad4(N * 2 * H);                 // (N, H) x part of cand
    total = xc + (xin ? pad4(N * H) : 0);
  }
};

// acc[r] += sum_k f[row_r, k] * w[k * ldw] over k < K, rows r0.. (clamped
// to N-1: the surplus rows of a ragged chunk repeat the last row and are
// never stored). f rows are K floats, K % 4 == 0, 16-byte aligned.
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

// dst[n, m*W + c] = sum_k A_m[n, k] * v[k] for the column v = src[:, c]
// already in registers; m == 0 is the identity.
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

template <typename S, bool XIN>
__global__ void __launch_bounds__(kMaxThreads)
    dcgru_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, D = p.D, H = p.H, M = p.M;
  const Smem L(XIN, N, D, H, M);
  float* sA = smem + L.a;
  float* sh = smem + L.h;
  float* sx = smem + L.in;
  float* hf = smem + L.hf;
  float* xf = smem + L.xf;
  float* sru = smem + L.ru;
  float* sxc = smem + L.xc;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int NN = N * N, MH = M * H, MD = M * D, H2 = 2 * H;
  const int dx = XIN ? D : 3 * H;
  const int chunks = (N + kRows - 1) / kRows;
  const int cols1 = XIN ? 3 * H : 2 * H;  // phase-1 output columns

  // the clip's operators A_1..A_{M-1} (a shared graph has a_batch == 1)
  const float* a_clip = p.a_ops + (size_t)(p.a_batch == 1 ? 0 : b) * NN;
  for (int i = tid; i < (M - 1) * NN; i += nthr) {
    int m = i / NN + 1, e = i - (m - 1) * NN;
    sA[i] = a_clip[(size_t)m * p.a_batch * NN + e];
  }
  for (int i = tid; i < N * H; i += nthr) sh[i] = p.h0[(size_t)b * N * H + i];

  const S* xs = static_cast<const S*>(p.x);
  S* hseq = static_cast<S*>(p.h_seq);
  S* ruseq = static_cast<S*>(p.ru_seq);
  S* cseq = static_cast<S*>(p.c_seq);

  for (int t = 0; t < p.T; ++t) {
    const size_t slab = (size_t)t * p.B + b;  // (t, b) row of every stream
    const S* xt = xs + slab * N * dx;
    for (int i = tid; i < N * dx; i += nthr) sx[i] = to_f(xt[i]);
    __syncthreads();

    // diffuse [h | x] (x only in the xin kernel): one (m, column) per task
    const int wcols = XIN ? H + D : H;
    for (int task = tid; task < M * wcols; task += nthr) {
      int m = task / wcols, c = task - m * wcols;
      float v[kMaxNodes];
      const bool is_h = c < H;
      const float* src = is_h ? sh + c : sx + (c - H);
      const int lds = is_h ? H : D;
#pragma unroll
      for (int k = 0; k < kMaxNodes; ++k)
        if (k < N) v[k] = src[k * lds];
      if (is_h)
        diffuse_col(v, sA, N, m, hf + m * H + c, MH);
      else
        diffuse_col(v, sA, N, m, xf + m * D + (c - H), MD);
    }
    __syncthreads();

    // phase 1: gates (and, in the xin kernel, the x half of the candidate)
    for (int task = tid; task < cols1 * chunks; task += nthr) {
      const int chunk = task / cols1, j = task - chunk * cols1;
      const int r0 = chunk * kRows;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      if (j < H2) {
        if (XIN) gemm_col(acc, xf, MD, r0, N, p.wxg + j, H2);
        gemm_col(acc, hf, MH, r0, N, p.wg + j, H2);
        const float bj = p.bg[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int n = r0 + r;
          if (n < N) {
            float pre = acc[r] + bj;
            if (!XIN) pre += sx[n * dx + j];
            const float v = sigmoid(pre);
            sru[n * H2 + j] = v;
            if (ruseq) ruseq[(slab * N + n) * H2 + j] = from_f<S>(v);
          }
        }
      } else {
        const int jj = j - H2;
        gemm_col(acc, xf, MD, r0, N, p.wxc + jj, H);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r0 + r < N) sxc[(r0 + r) * H + jj] = acc[r];
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
          const float xpart = XIN ? sxc[n * H + j] : sx[n * dx + H2 + j];
          const float c = activate(acc[r] + bj + xpart, p.act);
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

int threads_for(const Params& p, bool xin) {
  const int chunks = (p.N + kRows - 1) / kRows;
  int work = (xin ? 3 * p.H : 2 * p.H) * chunks;
  int nthr = ((work + 31) / 32) * 32;
  if (nthr < 128) nthr = 128;
  if (nthr > kMaxThreads) nthr = kMaxThreads;
  return nthr;
}

template <typename S, bool XIN>
int launch(const Params& p, cudaStream_t stream) {
  if (p.N > kMaxNodes || p.N < 1 || p.H % 4 || (XIN && p.D % 4) ||
      p.M < 1 || p.B < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Smem(XIN, p.N, p.D, p.H, p.M).total * 4;
  auto kern = dcgru_fwd_kernel<S, XIN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<p.B, threads_for(p, XIN), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// act: 0 tanh, 1 relu, 2 linear. bf16: streams are bf16 (else f32).
// Returns a cudaError_t: 0 on a launch that was accepted.
int dcgru_recurrence_xin_fwd(const void* x, const float* a_ops, int a_batch,
                             const float* wxg, const float* wxc,
                             const float* wg, const float* wc,
                             const float* bg, const float* bc,
                             const float* h0, void* h_seq, void* ru_seq,
                             void* c_seq, int T, int B, int N, int D, int H,
                             int M, int act, int bf16, void* stream) {
  Params p{x,     a_ops,  wxg,   wxc, wg, wc, bg, bc, h0,
           h_seq, ru_seq, c_seq, T,   B,  N,  D,  H,  M,  a_batch, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, true>(p, s) : launch<float, true>(p, s);
}

int dcgru_recurrence_fwd(const void* x_proj, const float* a_ops, int a_batch,
                         const float* wg, const float* wc, const float* bg,
                         const float* bc, const float* h0, void* h_seq,
                         void* ru_seq, void* c_seq, int T, int B, int N,
                         int H, int M, int act, int bf16, void* stream) {
  Params p{x_proj, a_ops, nullptr, nullptr, wg, wc, bg, bc, h0,
           h_seq,  ru_seq, c_seq,  T,       B,  N,  0,  H,  M, a_batch, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, false>(p, s)
              : launch<float, false>(p, s);
}

const char* dcgru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
