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
// H=64, M=3) a layer's chain does ~12 GFLOP of hidden products, 12 us at
// the bf16 tensor-core rate, and ~0.7 GFLOP of diffusions, against
// ~25-40 us for its streams at 3.35 TB/s. But the T steps are serial, and
// one clip's step is short dependent work between four block-wide
// barriers: a block alone takes as long as a full wave (loop_probe.py).
// Each phase is hundreds of instructions that every warp dispatches
// through the SM's four schedulers, so a step is bound by the
// instructions dispatched, not by the tensor cores: the epilogues stay
// one rolled copy each.
//
// Design.
// - One thread block per clip with the T loop inside the block: the TPU's
//   sequential (batch-tile, time) grid becomes an in-block loop, and 128
//   clips fill ~all 132 SMs. The TPU's 19 -> 24 node padding and J-clip
//   block diagonals are not needed: ragged node tiles are masked.
// - The hidden weights [Wg^T | Wc^T], staged by the wrapper as tensor-core
//   A fragments in the operand type, are copied once into shared memory
//   (74 KB in bf16 at M=3, 123 KB at M=5; 147 KB in f32 at M=3) and read
//   from there at every step; where they do not fit beside the state
//   (f32 at M=5, large N or H), the warps read them from L2.
// - Each step's products run on tensor cores (csrc/dcgru_common.cuh,
//   chain_product): out^T = W^T F^T, weights as A, the node rows of the
//   diffused features F as B, so the 19 nodes pad to 24, not 32. bf16
//   streams take bf16 operands with f32 sums (the reference's one bf16
//   pass, pallas_recurrent.py:113-122), f32 streams 3xTF32. The row tiles
//   split their node tiles over more warps where they are fewer than the
//   warps (the candidate's 4 over 2-3 warps each).
// - The diffusions A_m h and A_m (r h) run on tensor cores too, in 3xTF32
//   whatever the streams (diffuse_tc): the operators are split into hi
//   and lo fragments once, when the block starts, and F is written rounded
//   to the operand type. h, the gates and every sum are f32.
// - Step t+1's x_proj slab arrives by cp.async into a second buffer while
//   step t computes (one buffer, loaded at the step's head, where two do
//   not fit).
// - Streams (h_seq, ru_seq, c_seq) are f32 or bf16, x_proj the stream dtype
//   or f32 (pallas_recurrent.py:744,777). ru_seq / c_seq are written only
//   when their pointers are non-null.

#include "dcgru_common.cuh"

namespace {

using namespace dcgru;

// threads of a block: 16 warps where the registers allow (bf16 operands),
// 8 for 3xTF32; a step is latency-bound, and more warps hide more of it
template <typename FT>
constexpr int kThreads = sizeof(FT) == 2 ? 512 : 256;

struct Params {
  const void* x_proj;  // (T, B, N, 3H) = [gate | cand], no biases
  const float* a_ops;  // (M, a_batch, N, N), a_batch in {1, B}
  const void* w;       // staged A tiles: [Wg^T (2H, M*H) | Wc^T (H, M*H)]
  const float* bg;     // (2H)
  const float* bc;     // (H)
  const float* h0;     // (B, N, H) f32
  void* h_seq;         // (T, B, N, H)
  void* ru_seq;        // (T, B, N, 2H) or null
  void* c_seq;         // (T, B, N, H) or null
  int T, B, N, H, M, a_batch, act;
};

// Shared-memory plan, in bytes; every array starts 16-byte aligned. The
// staged weights take no room when they are read from L2 (wsmem false);
// nbuf x_proj buffers (2: the next step's arrives during this one).
template <typename FT, typename X>
struct Plan {
  int w, op, h, ru, bias, x, f, total;
  int wbytes, ldh, ldru, ldx, ldf, nbuf;
  __host__ __device__ Plan(int N, int H, int M, bool wsmem, int nbuf_)
      : nbuf(nbuf_) {
    const int MH = M * H, rows = 8 * ((N + 7) / 8);
    wbytes = chain_wbytes<FT>(2 * H, MH) + chain_wbytes<FT>(H, MH);
    ldh = chain_ld(H);
    ldru = chain_ld(2 * H);
    ldx = chain_ld(3 * H);
    ldf = ChainOps<FT>::ld(MH);
    w = 0;                                                 // A tiles
    op = w + (wsmem ? wbytes : 0);                         // A_m fragments
    h = op + op_frag_bytes(N, M);                          // (rows, H) f32
    ru = h + align16(rows * ldh * 4);                      // (rows, 2H) f32
    bias = ru + align16(rows * ldru * 4);                  // [bg | bc]
    x = bias + align16(3 * H * 4);                         // nbuf (N, 3H)
    f = x + nbuf * align16(N * ldx * (int)sizeof(X));      // (rows, MH)
    total = f + align16(rows * ldf * (int)sizeof(FT));
  }
};

// S: the dtype of h_seq, ru_seq, c_seq; X: of x_proj (S, or f32); FT: the
// products' operand type (bf16 for bf16 streams, f32 split into 3xTF32);
// WSMEM: the staged weights sit in shared memory (else in L2).
template <typename S, typename X, typename FT, bool WSMEM>
__global__ void __launch_bounds__(kThreads<FT>, 1)
    dcgru_fwd_kernel(const Params p, const int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, H = p.H, M = p.M;
  const Plan<FT, X> L(N, H, M, WSMEM, nbuf);
  uint4* sop = reinterpret_cast<uint4*>(smem + L.op);
  float* sh = reinterpret_cast<float*>(smem + L.h);
  float* sru = reinterpret_cast<float*>(smem + L.ru);
  float* sb = reinterpret_cast<float*>(smem + L.bias);
  X* sx = reinterpret_cast<X*>(smem + L.x);
  FT* sf = reinterpret_cast<FT*>(smem + L.f);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int NN = N * N, MH = M * H, H2 = 2 * H, H3 = 3 * H;
  const int xbuf = L.nbuf == 2 ? align16(N * L.ldx * (int)sizeof(X)) /
                                     (int)sizeof(X) : 0;
  const uint4* wg = WSMEM ? reinterpret_cast<const uint4*>(smem + L.w)
                          : static_cast<const uint4*>(p.w);
  const uint4* wc = wg + chain_wbytes<FT>(H2, MH) / 16;

  const X* xs = static_cast<const X*>(p.x_proj);
  S* hseq = static_cast<S*>(p.h_seq);
  S* ruseq = static_cast<S*>(p.ru_seq);
  S* cseq = static_cast<S*>(p.c_seq);
  // step tt's x_proj slab into buffer tt % nbuf
  auto load_x = [&](int tt) {
    cp_rows(sx + (tt & 1) * xbuf, L.ldx, xs + ((size_t)tt * p.B + b) * N * H3,
            N, H3);
    cp_commit();
  };

  if (WSMEM) cp_block(smem + L.w, p.w, L.wbytes);
  load_x(0);
  // the clip's operators A_1..A_{M-1} (a shared graph has a_batch == 1)
  stage_op_frags(sop, p.a_ops + (size_t)(p.a_batch == 1 ? 0 : b) * NN,
                 p.a_batch, N, M, false);
  // the padding (node rows >= N of h, ru and the features, the features'
  // columns >= M*H) stays zero
  const int frows = 8 * ((N + 7) / 8);
  for (int i = tid; i < frows * L.ldh; i += nthr) {
    const int n = i / L.ldh, c = i - n * L.ldh;
    sh[i] = n < N && c < H ? p.h0[((size_t)b * N + n) * H + c] : 0.0f;
  }
  for (int i = tid; i < frows * L.ldru; i += nthr) sru[i] = 0.0f;
  for (int i = tid; i < H3; i += nthr) sb[i] = i < H2 ? p.bg[i] : p.bc[i - H2];
  for (int i = tid; i < frows * L.ldf; i += nthr) sf[i] = from_f<FT>(0.0f);
  cp_wait<0>();
  __syncthreads();
  DCGRU_PROBE_START;

  for (int t = 0; t < p.T; ++t) {
    const size_t slab = (size_t)t * p.B + b;  // (t, b) row of every stream
    const X* sxt = sx + (L.nbuf == 2 ? (t & 1) * xbuf : 0);
    if (L.nbuf == 2 && t + 1 < p.T) load_x(t + 1);
    if (L.nbuf == 1 && t > 0) load_x(t);

    // the features [A_m h]
    diffuse_tc(sop, [&](int k, int c) { return sh[k * L.ldh + c]; }, N, M, H,
               sf, L.ldf);
    if (L.nbuf == 1) cp_wait<0>();
    __syncthreads();
    DCGRU_PROBE_MARK(0);

    // gates: ru^T = Wg^T F^T
    chain_product(wg, H2, MH, sf, L.ldf, N, [&](int j, int n, float v) {
      const float r = sigmoid(v + sb[j] + to_f(sxt[n * L.ldx + j]));
      sru[n * L.ldru + j] = r;
      if (ruseq) ruseq[(slab * N + n) * H2 + j] = from_f<S>(r);
    });
    __syncthreads();
    DCGRU_PROBE_MARK(1);

    // the features [A_m (r h)] (the h features are spent)
    diffuse_tc(
        sop,
        [&](int k, int c) { return sru[k * L.ldru + c] * sh[k * L.ldh + c]; },
        N, M, H, sf, L.ldf);
    __syncthreads();
    DCGRU_PROBE_MARK(2);

    // candidate and state update; (n, j) of h has one owner
    chain_product(wc, H, MH, sf, L.ldf, N, [&](int j, int n, float v) {
      const float c = activate(v + sb[H2 + j] + to_f(sxt[n * L.ldx + H2 + j]),
                               p.act);
      const float u = sru[n * L.ldru + H + j];
      const float hn = u * sh[n * L.ldh + j] + (1.0f - u) * c;
      sh[n * L.ldh + j] = hn;
      const size_t o = (slab * N + n) * H + j;
      hseq[o] = from_f<S>(hn);
      if (cseq) cseq[o] = from_f<S>(c);
    });
    if (L.nbuf == 2) cp_wait<0>();
    __syncthreads();
    DCGRU_PROBE_MARK(3);
  }
  DCGRU_PROBE_STORE;
}

bool valid(const Params& p) {
  return p.N <= kMaxNodes && p.N >= 1 && p.H % 4 == 0 && p.H >= 4 &&
         p.M >= 1 && p.B >= 1 && p.T >= 1;
}

template <typename S, typename X, typename FT>
int launch(const Params& p, cudaStream_t stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  bool wsmem;
  int nbuf, bytes;
  if (!choose_plan<Plan<FT, X>>(p.N, p.H, p.M, wsmem, nbuf, bytes))
    return (int)cudaErrorInvalidValue;
  auto kern = wsmem ? dcgru_fwd_kernel<S, X, FT, true>
                    : dcgru_fwd_kernel<S, X, FT, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<p.B, kThreads<FT>, bytes, stream>>>(p, nbuf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// act: 0 tanh, 1 relu, 2 linear. bf16: h_seq / ru_seq / c_seq are bf16
// (else f32); xp_f32: x_proj is f32 (else the dtype of the other streams).
// w: the staged hidden weights [Wg^T | Wc^T] (ops/cuda_recurrent.py,
// stage_chain_weights), bf16 for bf16 streams, else f32.
// Returns a cudaError_t: 0 on a launch that was accepted.
int dcgru_recurrence_fwd(const void* x_proj, const float* a_ops, int a_batch,
                         const void* w, const float* bg, const float* bc,
                         const float* h0, void* h_seq, void* ru_seq,
                         void* c_seq, int T, int B, int N, int H, int M,
                         int act, int bf16, int xp_f32, void* stream) {
  Params p{x_proj, a_ops, w,  bg, bc, h0, h_seq,   ru_seq,
           c_seq,  T,     B,  N,  H,  M,  a_batch, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (!bf16) return launch<float, float, float>(p, s);
  return xp_f32 ? launch<bf, float, bf>(p, s) : launch<bf, bf, bf>(p, s);
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
