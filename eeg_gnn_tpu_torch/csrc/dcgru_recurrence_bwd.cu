// Whole-sequence DCGRU layer recurrence, backward (BPTT): its state loop and
// the dW reduction, for NVIDIA Hopper (sm_90a).
//
// Replaces the serial part of two Pallas TPU kernels of
// eeg_gnn_tpu/ops/pallas_recurrent.py:
//   dcgru_xin_bwd_loop    <- the state chain of _bwd_kernel_xin (:782,
//                            launched from _backward_xin :964/:986) and of
//                            _bwd_kernel (:283, launched from _backward
//                            :462/:482): the reverse loop without any dW,
//                            writing dpre = [dru_pre | dc_pre] in f32 for
//                            the bulk dW (and, x-in, dx) products of
//                            dcgru_xin_gemm.cu. The hoisted layer's BPTT
//                            (ops/cuda_recurrent.py dcgru_recurrence_bwd) is
//                            this loop, the bulk dW at D = 0 and the
//                            reduction; its dx_proj is dpre in the stream
//                            dtype.
//   dcgru_dw_reduce       <- the cross-grid dW accumulation of both
//                            (:294-297, :794-801): the TPU grid runs in
//                            order and sums into one resident block; on
//                            the GPU the partial slabs (one per split of
//                            the clip-steps, dcgru_xin_gemm.cu) are summed
//                            in a fixed order (no atomics).
//
// One step, walking t from T-1 down to 0 (A_0 = I; math of
// eeg_gnn_tpu/ops/recurrent.py:36-46):
//   g       = dh + d_seq[t]
//   du      = g (h_prev - c);  dc_pre = g (1-u) act'(c)
//   drh     = sum_m A_m^T (dc_pre Wc_m^T)
//   dru_pre = [drh h_prev | du] ru (1-ru)
//   dh_prev = g u + drh r + sum_m A_m^T (dru_pre Wg_m^T)
// and at the end dh0 = dh.
//
// What bounds the loop on an H100: ~12 GFLOP of weight-transpose
// products (12 us at the bf16 tensor-core rate) and ~0.7 GFLOP of A^T
// applies, serial over T. As in the forward loop, a step (five phases
// between barriers) is bound by the instructions its warps dispatch, not
// by the tensor cores (loop_probe.py).
// Design, as the forward loop's (dcgru_recurrence.cu):
// - One block per clip, the reverse T loop inside it. The hidden weights
//   [Wc | Wg] (M*H rows), staged by the wrapper as tensor-core A
//   fragments in the operand type, are copied once into shared memory
//   (74 KB bf16 at M=3) and read from there at every step (from L2 where
//   they do not fit beside the state).
// - P2 (dc_pre Wc^T) and P4 (dru_pre Wg^T) run as chain_product on tensor
//   cores, transposed (W as A, the node rows of dc_pre / dru_pre as B):
//   bf16 operands with f32 sums for bf16 streams (the reference's one
//   bf16 pass, pallas_recurrent.py:849,865), 3xTF32 for f32 streams. The
//   A^T applies run on tensor cores in 3xTF32 whatever the streams
//   (diffuse_t_tc: the transposed operators split into hi and lo once).
//   dh, every sum and dpre are f32.
// - Step t-1's h_prev, ru, c and d_seq slabs arrive by cp.async into a
//   second buffer during step t (one buffer, loaded at the step's head,
//   where two do not fit: f32 at M=3); dpre is written as each half is
//   made, from the phase that makes it.

#include "dcgru_common.cuh"

namespace {

using namespace dcgru;

// ---------------------------------------------------------------------------
// the state loop (3.l; #4's too): tensor-core products, staged weights
// ---------------------------------------------------------------------------

// threads of a block: 16 warps where the registers allow (bf16 operands),
// 12 for 3xTF32; a step is latency-bound, and more warps hide more of it
template <typename FT>
constexpr int kLoopThreads = sizeof(FT) == 2 ? 512 : 384;

struct LoopParams {
  const float* a_ops;  // (M, a_batch, N, N), a_batch in {1, B}
  const void* w;       // staged A tiles: [Wc (M*H, H) | Wg (M*H, 2H)]
  const void* h_prev;  // (T, B, N, H)
  const void* ru;      // (T, B, N, 2H)
  const void* c;       // (T, B, N, H)
  const void* d_seq;   // (T, B, N, H) cotangent of h_seq
  float* dpre;         // (T, B, N, 3H) [dru_pre | dc_pre]
  float* dh0;          // (B, N, H)
  int T, B, N, H, M, a_batch, act;
};

// Shared-memory plan, in bytes; every array starts 16-byte aligned. The
// staged weights take no room when they are read from L2 (wsmem false);
// nbuf stream buffers, each [h_prev | ru | c | d_seq] dense.
template <typename FT, typename S>
struct LoopPlan {
  int w, op, dh, drh, dy, st, fc, fr, total;
  int wbytes, ldh, ldy, ldc, ldr, sbuf, nbuf;
  __host__ __device__ LoopPlan(int N, int H, int M, bool wsmem, int nbuf_)
      : nbuf(nbuf_) {
    const int MH = M * H, rows = 8 * ((N + 7) / 8);
    wbytes = chain_wbytes<FT>(MH, H) + chain_wbytes<FT>(MH, 2 * H);
    ldh = chain_ld(H);
    ldy = chain_ld(MH);
    ldc = ChainOps<FT>::ld(H);
    ldr = ChainOps<FT>::ld(2 * H);
    sbuf = align16(N * H * (int)sizeof(S));  // one N x H slab
    w = 0;                                       // A tiles
    op = w + (wsmem ? wbytes : 0);               // A_m^T fragments
    dh = op + op_frag_bytes(N, M);               // (N, H) dh, then g
    drh = dh + align16(N * ldh * 4);             // (N, H)
    dy = drh + align16(N * ldh * 4);             // (rows, M*H) dpre W^T
    st = dy + align16(rows * ldy * 4);           // nbuf x 5 slabs
    fc = st + nbuf * 5 * sbuf;                   // (rows, H) dc_pre
    fr = fc + align16(rows * ldc * (int)sizeof(FT));  // (rows, 2H) dru_pre
    total = fr + align16(rows * ldr * (int)sizeof(FT));
  }
};

// S: the dtype of the input streams; FT: the products' operand type;
// WSMEM: the staged weights sit in shared memory (else in L2).
template <typename S, typename FT, bool WSMEM>
__global__ void __launch_bounds__(kLoopThreads<FT>, 1)
    dcgru_xin_bwd_loop_kernel(const LoopParams p, const int nbuf) {
  extern __shared__ __align__(16) unsigned char loop_smem[];
  unsigned char* smem = loop_smem;
  const int N = p.N, H = p.H, M = p.M;
  const LoopPlan<FT, S> L(N, H, M, WSMEM, nbuf);
  uint4* sop = reinterpret_cast<uint4*>(smem + L.op);
  float* sdh = reinterpret_cast<float*>(smem + L.dh);
  float* sdrh = reinterpret_cast<float*>(smem + L.drh);
  float* sdy = reinterpret_cast<float*>(smem + L.dy);
  FT* sfc = reinterpret_cast<FT*>(smem + L.fc);
  FT* sfr = reinterpret_cast<FT*>(smem + L.fr);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int NN = N * N, MH = M * H, H2 = 2 * H, H3 = 3 * H;
  const uint4* wc = WSMEM ? reinterpret_cast<const uint4*>(smem + L.w)
                          : static_cast<const uint4*>(p.w);
  const uint4* wg = wc + chain_wbytes<FT>(MH, H) / 16;

  const S* hps = static_cast<const S*>(p.h_prev);
  const S* rus = static_cast<const S*>(p.ru);
  const S* cs = static_cast<const S*>(p.c);
  const S* ds = static_cast<const S*>(p.d_seq);
  // a buffer's slabs: h_prev (N, H) | ru (N, 2H) | c (N, H) | d_seq (N, H)
  auto buf = [&](int tt) {
    return reinterpret_cast<S*>(smem + L.st + (L.nbuf == 2 ? tt & 1 : 0) * 5 *
                                               L.sbuf);
  };
  auto load = [&](int tt) {
    const size_t o = ((size_t)tt * p.B + b) * N * H;
    S* d = buf(tt);
    const int row = L.sbuf / (int)sizeof(S);
    cp_rows(d, N * H, hps + o, 1, N * H);
    cp_rows(d + row, N * H2, rus + 2 * o, 1, N * H2);
    cp_rows(d + 3 * row, N * H, cs + o, 1, N * H);
    cp_rows(d + 4 * row, N * H, ds + o, 1, N * H);
    cp_commit();
  };

  if (WSMEM) cp_block(smem + L.w, p.w, L.wbytes);
  load(p.T - 1);
  // the clip's transposed operators (a shared graph has a_batch == 1)
  stage_op_frags(sop, p.a_ops + (size_t)(p.a_batch == 1 ? 0 : b) * NN,
                 p.a_batch, N, M, true);
  for (int i = tid; i < N * L.ldh; i += nthr) sdh[i] = 0.0f;
  // the operands' padding (node rows >= N, columns >= H / 2H) stays zero
  const int frows = 8 * ((N + 7) / 8);
  for (int i = tid; i < frows * L.ldy; i += nthr) sdy[i] = 0.0f;
  for (int i = tid; i < frows * L.ldc; i += nthr) sfc[i] = from_f<FT>(0.0f);
  for (int i = tid; i < frows * L.ldr; i += nthr) sfr[i] = from_f<FT>(0.0f);
  cp_wait<0>();
  __syncthreads();
  DCGRU_PROBE_START;

  for (int t = p.T - 1; t >= 0; --t) {
    const size_t slab = (size_t)t * p.B + b;  // (t, b) row of every stream
    float* dp = p.dpre + slab * N * H3;
    const S* shp = buf(t);
    const S* sru = shp + L.sbuf / (int)sizeof(S);
    const S* sc = sru + 2 * (L.sbuf / (int)sizeof(S));
    const S* sd = sc + L.sbuf / (int)sizeof(S);
    if (L.nbuf == 2 && t > 0) load(t - 1);
    if (L.nbuf == 1 && t < p.T - 1) {
      load(t);
      cp_wait<0>();
      __syncthreads();
    }

    // P0: g, du, dc_pre; the du and dc_pre columns of dpre
    for (int i = tid; i < N * H; i += nthr) {
      const int n = i / H, j = i - n * H;
      const float hp = to_f(shp[i]);
      const float u = to_f(sru[n * H2 + H + j]);
      const float c = to_f(sc[i]);
      const float g = sdh[n * L.ldh + j] + to_f(sd[i]);
      const float dc = g * (1.0f - u) * act_grad(c, p.act);
      const float du = g * (hp - c) * u * (1.0f - u);
      sdh[n * L.ldh + j] = g;
      sfc[n * L.ldc + j] = from_f<FT>(dc);
      sfr[n * L.ldr + H + j] = from_f<FT>(du);
      dp[n * H3 + H + j] = du;
      dp[n * H3 + H2 + j] = dc;
    }
    __syncthreads();
    DCGRU_PROBE_MARK(0);

    // P2: dc_pre Wc^T, as (Wc dc_pre^T)^T
    chain_product(wc, MH, H, sfc, L.ldc, N,
                  [&](int k, int n, float v) { sdy[n * L.ldy + k] = v; });
    __syncthreads();
    DCGRU_PROBE_MARK(1);

    // P3: A^T applies: drh, and the r half of dru_pre
    diffuse_t_tc(sop, sdy, L.ldy, N, M, H, [&](int n, int cc, float drh) {
      const float r = to_f(sru[n * H2 + cc]);
      const float dr = drh * to_f(shp[n * H + cc]) * r * (1.0f - r);
      sdrh[n * L.ldh + cc] = drh;
      sfr[n * L.ldr + cc] = from_f<FT>(dr);
      dp[n * H3 + cc] = dr;
    });
    __syncthreads();
    DCGRU_PROBE_MARK(2);

    // P4: dru_pre Wg^T
    chain_product(wg, MH, H2, sfr, L.ldr, N,
                  [&](int k, int n, float v) { sdy[n * L.ldy + k] = v; });
    __syncthreads();
    DCGRU_PROBE_MARK(3);

    // P5: the gate A^T applies: dh_prev
    diffuse_t_tc(sop, sdy, L.ldy, N, M, H, [&](int n, int cc, float v) {
      const float g = sdh[n * L.ldh + cc];
      const float r = to_f(sru[n * H2 + cc]);
      const float u = to_f(sru[n * H2 + H + cc]);
      sdh[n * L.ldh + cc] = g * u + sdrh[n * L.ldh + cc] * r + v;
    });
    if (L.nbuf == 2) cp_wait<0>();
    __syncthreads();
    DCGRU_PROBE_MARK(4);
  }
  DCGRU_PROBE_STORE;

  for (int i = tid; i < N * H; i += nthr) {
    const int n = i / H;
    p.dh0[(size_t)b * N * H + i] = sdh[n * L.ldh + i - n * H];
  }
}

template <typename S, typename FT>
int launch_loop(const LoopParams& p, cudaStream_t stream) {
  if (p.N > kMaxNodes || p.N < 1 || p.H % 4 || p.H < 4 || p.M < 1 ||
      p.B < 1 || p.T < 1)
    return (int)cudaErrorInvalidValue;
  bool wsmem;
  int nbuf, bytes;
  if (!choose_plan<LoopPlan<FT, S>>(p.N, p.H, p.M, wsmem, nbuf, bytes))
    return (int)cudaErrorInvalidValue;
  auto kern = wsmem ? dcgru_xin_bwd_loop_kernel<S, FT, true>
                    : dcgru_xin_bwd_loop_kernel<S, FT, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<p.B, kLoopThreads<FT>, bytes, stream>>>(p, nbuf);
  return (int)cudaGetLastError();
}

// out[i] = sum_b part[b, i], b in order: deterministic.
__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int B, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W) return;
  float s = 0.0f;
#pragma unroll 8
  for (int b = 0; b < B; ++b) s += __ldg(part + (size_t)b * W + i);
  out[i] = s;
}

}  // namespace

extern "C" {

// The state chain alone: dpre (T, B, N, 3H) f32 and dh0; no dW. w: the
// staged hidden weights [Wc | Wg] (ops/cuda_recurrent.py,
// stage_chain_weights), bf16 for bf16 streams, else f32.
int dcgru_xin_bwd_loop(const float* a_ops, int a_batch, const void* w,
                       const void* h_prev, const void* ru, const void* c,
                       const void* d_seq, float* dpre, float* dh0, int T,
                       int B, int N, int H, int M, int act, int bf16,
                       void* stream) {
  LoopParams p{a_ops, w, h_prev, ru, c, d_seq, dpre, dh0,
               T,     B, N,      H,  M, a_batch, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_loop<__nv_bfloat16, __nv_bfloat16>(p, s)
              : launch_loop<float, float>(p, s);
}

// out (W) = sum over b of part (B, W).
int dcgru_dw_reduce(const float* part, float* out, int B, int W,
                    void* stream) {
  if (B < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dw_reduce_kernel<<<(W + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(part, out, B, W);
  return (int)cudaGetLastError();
}

#ifdef DCGRU_PROBE
// probe builds: block 0's phase clocks since the last read (kProbeSlots)
int dcgru_probe_read(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, dcgru::probe_cycles,
                                         sizeof(dcgru::probe_cycles));
  if (err != cudaSuccess) return (int)err;
  unsigned long long zero[dcgru::kProbeSlots] = {};
  return (int)cudaMemcpyToSymbol(dcgru::probe_cycles, zero, sizeof(zero));
}
#endif

const char* dcgru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
