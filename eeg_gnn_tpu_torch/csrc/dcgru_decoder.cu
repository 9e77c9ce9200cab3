// Whole-sequence DCGRU seq2seq decoder, forward and backward (BPTT), for
// NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of eeg_gnn_tpu/ops/pallas_decoder.py:
//   dcgru_decoder_fwd   <- _fwd_kernel_dec (:157, launched from _forward_dec
//                          :381/:401): all L cells, the output projection
//                          and the scheduled-sampling feedback over T_out
//                          steps;
//   dcgru_dec_bwd_loop  <- _bwd_kernel_dec (:229, launched from _backward_dec
//                          :456/:477): the serial part of its BPTT, the state
//                          cotangents and the feedback, writing each layer's
//                          dpre = [dru_pre | dc_pre] and each step's dproj in
//                          f32;
//   dcgru_dec_dwp       <- the same kernel's dWp / dbp sums (:281-282): the
//                          projection's gradient over all T_out*B*N rows at
//                          once, in split partials.
// The cells' dW / db, which the TPU kernel also sums in its body, come
// from the bulk x-in dW kernel (dcgru_xin_gemm.cu) fed this loop's dpre:
// once for layer 0 and once for the tied cell with layers 1..L-1 stacked
// as (L-1)*T_out steps, which sums the tied weights' gradient over the
// layers. Every split partial is summed by dcgru_dw_reduce
// (dcgru_recurrence_bwd.cu) in a fixed order.
//
// Forward, step t of every clip (A_0 = I; layer 0 has input width D and
// its own cell, layers >= 1 width H and ONE shared cell, the reference's
// tied-weight quirk):
//   in_0   = t == 0 ? 0 (GO) : f_{t-1} x_{t-1} + (1 - f_{t-1}) proj_{t-1}
//   layer l: feats = A_m [h_l | in_l];  ru = sigmoid(feats W_g + b_g)
//            c = act(A_m in_l W_xc + A_m (r h_l) W_c + b_c)
//            h_l = u h_l + (1 - u) c;  in_{l+1} = h_l
//   proj_t = h_{L-1} Wp + bp   (the feedback uses it in f32)
// Backward loop, walking t down (pallas_decoder.py:31-41):
//   dproj = dseq_t + (1 - f_t) din0;  dx_t = f_t din0;  dh_{L-1} += dproj Wp^T
//   layer l = L-1 .. 0, g = dh_l (the cotangent from above added):
//     du = g (h_prev - c);  dc_pre = g (1 - u) act'(c)
//     drh = sum_m A_m^T (dc_pre Wc_m^T)
//     dru_pre = [drh h_prev | du] ru (1 - ru)
//     dh_l = g u + drh r + sum_m A_m^T (dru_pre Wg_m^T)
//     din = sum_m A_m^T ([dru_pre | dc_pre] [Wxg | Wxc]_m^T), which adds
//       into dh_{l-1} at the same step, or becomes din0 at l = 0.
// The residuals are layer-major, (L, T, B, N, W), so each layer's stream,
// and layers 1..L-1 together, are contiguous for the bulk dW kernel.
//
// What bounds it on an H100. At the SSL shape (T_out=12, B=128, N=19,
// H=64, D=100, L=3, M=3) the forward does ~10.3 MFLOP per clip-step,
// ~15.9 GFLOP a launch, ~16 us on the bf16 tensor cores, against ~20 us
// for its ~65 MB of streams (bf16): bound by bytes. The backward loop does
// ~10.6 MFLOP per clip-step, ~16 us, against ~41 us for its streams, dpre
// (f32) among them. But the T_out x L layer-steps are serial, and each is
// a few phases of short dependent work between block-wide barriers: as in
// the encoder's loops (dcgru_recurrence.cu), a step is bound by the
// instructions its warps dispatch (loop_probe.py), not by the tensor cores
// or memory. dWp is ~0.4 GFLOP over ~15 MB: on the tensor cores (as the
// reference's one bf16 pass) bound by bytes.
//
// Design of the two loops, as the encoder's state loops:
// - One thread block per clip with the T_out loop inside and the layer
//   loop inside that; the TPU's 19 -> 24 node padding and clip block
//   diagonals dropped (ragged node tiles are masked).
// - Each step's products on tensor cores (chain_product, dcgru_common.cuh):
//   the weights are the A operand, staged by the wrapper at every launch
//   as tensor-core fragments (ops/cuda_decoder.py, decoder_fwd_weights /
//   decoder_bwd_weights), the node rows of the step's features or
//   cotangents the B operand, so 19 nodes pad to 24, not 32. bf16 streams
//   take bf16 operands with f32 sums (the reference's one bf16 pass),
//   f32 streams 3xTF32.
//     forward, a layer: the gates [Wg^T | Wxg^T] (2H rows) against
//       [A_m h | A_m in], the candidate [Wc^T | Wxc^T] (H rows) against
//       [A_m (r h) | A_m in], K = M (H + Din); the projection Wp^T (D
//       rows, K = H);
//     backward, a layer: dc_pre Wc^T (A = Wc, M H rows, K = H), then in
//       one phase dru_pre Wg^T (Wg, K = 2H) and the input's
//       [dru_pre | dc_pre] [Wxg | Wxc]^T (M Din rows, K = 3H); a step
//       starts with dproj Wp^T (A = Wp, H rows, K = D).
// - The operator applies A_m v and A_m^T v run on tensor cores in 3xTF32
//   whatever the streams (diffuse_tc, diffuse_t_tc), on the clip's
//   operators split into hi and lo fragments once, when the block starts.
// - Shared memory (at most 227 KB a block): the loop's buffers, then as
//   much of the tied cell's staged weights as fits, copied once: it runs
//   L-1 of every L layer-steps. The rest is read from L2 in fragment
//   order, one conflict-free 16-byte load a lane: layer 0 (186 KiB bf16
//   at M=3), Wp, and every weight of f32 streams or M=5. The plan
//   (dec_plan; dcgru_dec_plan reports it) takes the longest prefix of the
//   staged weights that fits: bf16 at M=3 the whole tied cell forward
//   (144 KiB), its Wg and Wx backward (120 KiB of 144).
// - Phases of a step between barriers: forward four a layer (diffuse
//   [h | in], gates, diffuse r h, candidate) and the projection, whose
//   epilogue makes the next step's layer-0 input; backward one and four a
//   layer (dproj Wp^T; dc_pre Wc^T, the A^T apply of drh, the gate and
//   input products, the A^T applies of dh and din). A layer's elementwise
//   head (g, du, dc_pre) runs in the epilogue of the phase that completes
//   its g: the projection's product for the top layer, the input
//   cotangent's apply above for the others; layer 0's input cotangent
//   makes the next step's dproj and dx in its epilogue.
// - Streams (x, proj and the residuals in0, h, ru, c; d_seq, dx) are f32
//   or bf16; state, gates, cotangents, dpre, dproj and every sum are f32
//   (pallas_decoder.py:441-445, 527-536).
// dWp: a block sums a 64 x 64 tile of (H, D) over a fixed split of 256
// rows on f32 FMA (16 outputs per thread), no atomics, the next 32 rows'
// loads in flight during each 32 rows' products.

#include "dcgru_common.cuh"

namespace {

using namespace dcgru;

// threads of a loop's block: 16 warps where the registers allow (bf16
// operands), fewer for 3xTF32; a step is latency-bound, and more warps
// hide more of it
template <typename FT>
constexpr int kFwdThreads = sizeof(FT) == 2 ? 512 : 256;
template <typename FT>
constexpr int kLoopThreads = sizeof(FT) == 2 ? 512 : 384;

struct FwdParams {
  const void* x;         // (T, B, N, D) teacher-forcing stream
  const float* force;    // (T,) per-step force f_t in {0, 1}
  const float* a_ops;    // (M, a_batch, N, N), a_batch in {1, B}
  const void* w;         // staged A tiles, DecOps::fwd order
  const float* bias[2][2];  // [layer 0 | shared] x [bg (2H), bc (H)]
  const float* bp;       // (D)
  const float* h0;       // (L, B, N, H) f32
  void* proj;            // (T, B, N, D)
  void* in0;             // (T, B, N, D) layer-0 inputs, or null
  void* h_seq;           // (L, T, B, N, H), or null
  void* ru_seq;          // (L, T, B, N, 2H), or null
  void* c_seq;           // (L, T, B, N, H), or null
  int T, B, N, D, H, M, L, a_batch, act;
};

struct LoopParams {
  const float* a_ops;
  const void* w;          // staged A tiles, DecOps::bwd order
  const void* h_prev;     // (L, T, B, N, H) [h0, h_seq[:-1]] per layer
  const void* ru;         // (L, T, B, N, 2H)
  const void* c;          // (L, T, B, N, H)
  const void* d_seq;      // (T, B, N, D) cotangent of proj
  const float* force;     // (T,)
  void* dx;               // (T, B, N, D)
  float* dh0;             // (L, B, N, H)
  float* dpre;            // (L, T, B, N, 3H) [dru_pre | dc_pre]
  float* dproj;           // (T, B, N, D)
  int T, B, N, D, H, M, L, a_batch, act;
};

struct DwpParams {
  const void* h_top;  // (R, H) the top layer's states, R = T*B*N rows
  const float* g;     // (R, D) dproj
  float* part;        // (splits, H*D + D): [dWp (H, D) | dbp (D)]
  int R, H, D;
};

// Byte offsets of the staged A operands (ops/cuda_decoder.py), the tied
// cell's first (only with L > 1), so that a prefix of them can sit in
// shared memory:
//   fwd: [tied gate^T | tied cand^T |] l0 gate^T | l0 cand^T | Wp^T
//        (gate^T = [Wg^T | Wxg^T] (2H, M(H+Din)), cand^T (H, M(H+Din)),
//        Wp^T (D, H))
//   bwd: [tied Wg | tied Wx | tied Wc |] l0 Wg | l0 Wx | l0 Wc | Wp
//        (Wg (MH, 2H), Wx = [Wxg | Wxc] (M Din, 3H), Wc (MH, H), Wp (H, D))
// cell[c][i]: operand i of cell c (0 layer 0, 1 tied); cuts: the prefix
// sizes a plan may copy, longest first, the last 0.
template <typename FT>
struct DecOps {
  int cell[2][3], wp, total, cuts[3];
  __host__ __device__ DecOps(bool fwd, int D, int H, int M, int L) {
    int off = 0;
    int size[2][3];
    for (int c = 1; c >= 0; --c) {
      const int Din = c == 0 ? D : H, K = M * (H + Din);
      if (fwd) {
        size[c][0] = chain_wbytes<FT>(2 * H, K);
        size[c][1] = chain_wbytes<FT>(H, K);
        size[c][2] = 0;
      } else {
        size[c][0] = chain_wbytes<FT>(M * H, 2 * H);
        size[c][1] = chain_wbytes<FT>(M * Din, 3 * H);
        size[c][2] = chain_wbytes<FT>(M * H, H);
      }
      for (int i = 0; i < 3; ++i) {
        cell[c][i] = off;
        if (c == 0 || L > 1) off += size[c][i];
      }
    }
    wp = off;
    total = off + (fwd ? chain_wbytes<FT>(D, H) : chain_wbytes<FT>(H, D));
    // the whole tied cell, all but its last operand, nothing
    cuts[0] = L > 1 ? cell[0][0] : 0;
    cuts[1] = L > 1 ? cell[1][fwd ? 1 : 2] : 0;
    cuts[2] = 0;
  }
};

// Shared-memory plans, in bytes; every array starts 16-byte aligned and
// the staged-weight prefix (wsmem bytes) comes first. rows: the node rows
// padded to the 8-node tile; a buffer that a product or an operator apply
// reads as its B operand keeps rows N..rows-1 (and its padded columns)
// zero.
template <typename FT>
struct FwdPlan {
  int op, h, in, ru, f, p, total;
  int ldh, ldi, ldru, ldf, ldp;
  __host__ __device__ FwdPlan(int N, int D, int H, int M, int L, int wsmem) {
    const int rows = 8 * ((N + 7) / 8), Dm = D > H ? D : H;
    ldh = chain_ld(H);
    ldi = chain_ld(D);
    ldru = chain_ld(2 * H);
    ldf = ChainOps<FT>::ld(M * (H + Dm));
    ldp = ChainOps<FT>::ld(H);
    op = wsmem;                                       // A_m fragments
    h = op + op_frag_bytes(N, M);                     // (L, rows, H) f32
    in = h + align16(L * rows * ldh * 4);             // (rows, D) f32 in_0
    ru = in + align16(rows * ldi * 4);                // (rows, 2H) f32
    f = ru + align16(rows * ldru * 4);                // (rows, M(H+Din))
    p = f + align16(rows * ldf * (int)sizeof(FT));    // (rows, H) h_{L-1}
    total = p + align16(rows * ldp * (int)sizeof(FT));
  }
};

template <typename FT, typename S>
struct LoopPlan {
  int op, dh, dy, pre, q, res, total;
  int ldh, ldy, ldpre, ldq, ldres;
  __host__ __device__ LoopPlan(int N, int D, int H, int M, int L,
                               int wsmem) {
    const int rows = 8 * ((N + 7) / 8), Dm = D > H ? D : H;
    ldh = chain_ld(H);
    ldy = chain_ld(M * (H + Dm));
    ldpre = ChainOps<FT>::ld(3 * H);
    ldq = ChainOps<FT>::ld(D);
    ldres = 3 * H + 8;
    op = wsmem;                                    // A_m^T fragments
    dh = op + op_frag_bytes(N, M);                 // (L, N, H) f32
    dy = dh + align16(L * N * ldh * 4);            // (rows, M(H+Din)) f32
    pre = dy + align16(rows * ldy * 4);            // (rows, 3H) dpre
    q = pre + align16(rows * ldpre * (int)sizeof(FT));  // (rows, D) dproj
    res = q + align16(rows * ldq * (int)sizeof(FT));    // (N, 3H) S
    total = res + align16(N * ldres * (int)sizeof(S));  //   [h_prev | r | u]
  }
};

// The staged-weight prefix a loop copies into shared memory: the longest
// cut of DecOps whose plan the current card gives a block; false where
// none fits.
template <typename Plan>
bool dec_plan(const int (&cuts)[3], int N, int D, int H, int M, int L,
              int& wsmem, int& bytes) {
  int dev = 0, cap = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  for (int i = 0; i < 3; ++i) {
    wsmem = cuts[i];
    bytes = Plan(N, D, H, M, L, wsmem).total;
    if (bytes <= cap) return true;
  }
  return false;
}

constexpr int kDwpTile = 64;   // dWp outputs of a block: 64 rows x 64 cols
constexpr int kDwpK = 32;      // rows per shared-memory stage
constexpr int kDwpRows = 256;  // rows a split sums (ops/cuda_decoder.py)
constexpr int kDwpThreads = 256;
constexpr int kDwpLoads = kDwpK * kDwpTile / kDwpThreads;  // per thread

// An operand at byte offset off of the staged weights: the shared-memory
// copy for the prefix [0, wsmem), else the wrapper's tiles in L2.
__device__ __forceinline__ const uint4* staged(const unsigned char* smem,
                                               const void* w, int off,
                                               int wsmem) {
  return reinterpret_cast<const uint4*>(
      off < wsmem ? smem + off : static_cast<const unsigned char*>(w) + off);
}

// S: the dtype of the streams; FT: the products' operand type (bf16 for
// bf16 streams, f32 split into 3xTF32). Probe slots (loop_probe.py): the
// four phases of layer 0, of the tied layers, then the projection.
template <typename S, typename FT>
__global__ void __launch_bounds__(kFwdThreads<FT>, 1)
    dcgru_dec_fwd_kernel(const FwdParams p, const int wsmem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, D = p.D, H = p.H, M = p.M, L = p.L;
  const FwdPlan<FT> P(N, D, H, M, L, wsmem);
  const DecOps<FT> W(true, D, H, M, L);
  uint4* sop = reinterpret_cast<uint4*>(smem + P.op);
  float* sh = reinterpret_cast<float*>(smem + P.h);
  float* sfeed = reinterpret_cast<float*>(smem + P.in);
  float* sru = reinterpret_cast<float*>(smem + P.ru);
  FT* sf = reinterpret_cast<FT*>(smem + P.f);
  FT* sp = reinterpret_cast<FT*>(smem + P.p);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int rows = 8 * ((N + 7) / 8);
  const int NN = N * N, MH = M * H, H2 = 2 * H, hslab = rows * P.ldh;

  const S* xs = static_cast<const S*>(p.x);
  S* projs = static_cast<S*>(p.proj);
  S* in0s = static_cast<S*>(p.in0);
  S* hs = static_cast<S*>(p.h_seq);
  S* rus = static_cast<S*>(p.ru_seq);
  S* cs = static_cast<S*>(p.c_seq);

  if (wsmem) cp_block(smem, p.w, wsmem);
  cp_commit();
  // the clip's operators A_1..A_{M-1} (a shared graph has a_batch == 1)
  stage_op_frags(sop, p.a_ops + (size_t)(p.a_batch == 1 ? 0 : b) * NN,
                 p.a_batch, N, M, false);
  // the L initial states and the GO symbol; every padding stays zero
  for (int i = tid; i < L * hslab; i += nthr) {
    const int l = i / hslab, n = (i - l * hslab) / P.ldh;
    const int c = i - l * hslab - n * P.ldh;
    sh[i] = n < N && c < H ? p.h0[(((size_t)l * p.B + b) * N + n) * H + c]
                           : 0.0f;
  }
  for (int i = tid; i < rows * P.ldi; i += nthr) sfeed[i] = 0.0f;
  for (int i = tid; i < rows * P.ldru; i += nthr) sru[i] = 0.0f;
  for (int i = tid; i < rows * P.ldf; i += nthr) sf[i] = from_f<FT>(0.0f);
  for (int i = tid; i < rows * P.ldp; i += nthr) sp[i] = from_f<FT>(0.0f);
  cp_wait<0>();
  __syncthreads();
  DCGRU_PROBE_START;

  for (int t = 0; t < p.T; ++t) {
    const size_t slab = (size_t)t * p.B + b;  // (t, b) row of x, proj, in0
    for (int l = 0; l < L; ++l) {
      const int cell = l == 0 ? 0 : 1, slot = l == 0 ? 0 : 4;
      const int Din = l == 0 ? D : H, K = M * (H + Din);
      const float* in = l == 0 ? sfeed : sh + (l - 1) * hslab;
      const int ldin = l == 0 ? P.ldi : P.ldh;
      float* hl = sh + l * hslab;
      const float* bg = p.bias[cell][0];
      const float* bc = p.bias[cell][1];
      // the (l, t, b) row of the layer-major residuals
      const size_t lrow = ((size_t)l * p.T + t) * p.B + b;

      // the features [A_m h | A_m in]; the depth padding past this
      // layer's K is zero (another layer's features may lie there)
      diffuse_tc(sop, [&](int k, int c) { return hl[k * P.ldh + c]; }, N, M,
                 H, sf, P.ldf);
      diffuse_tc(sop, [&](int k, int c) { return in[k * ldin + c]; }, N, M,
                 Din, sf + MH, P.ldf);
      const int kpad = chain_ktiles<FT>(K) * ChainOps<FT>::kDepth - K;
      for (int i = tid; i < N * kpad; i += nthr)
        sf[(i / kpad) * P.ldf + K + i % kpad] = from_f<FT>(0.0f);
      if (l == 0 && in0s)
        for (int i = tid; i < N * D; i += nthr)
          in0s[slab * N * D + i] = from_f<S>(sfeed[(i / D) * P.ldi + i % D]);
      __syncthreads();
      DCGRU_PROBE_MARK(slot);

      // gates: ru^T = [Wg^T | Wxg^T] F^T
      chain_product(
          staged(smem, p.w, W.cell[cell][0], wsmem), H2, K, sf, P.ldf, N,
          [&](int j, int n, float v) {
            const float r = sigmoid(v + __ldg(bg + j));
            sru[n * P.ldru + j] = r;
            if (rus) rus[(lrow * N + n) * H2 + j] = from_f<S>(r);
          });
      __syncthreads();
      DCGRU_PROBE_MARK(slot + 1);

      // the features [A_m (r h)] (the h features are spent; the input's
      // stay)
      diffuse_tc(
          sop,
          [&](int k, int c) { return sru[k * P.ldru + c] * hl[k * P.ldh + c]; },
          N, M, H, sf, P.ldf);
      __syncthreads();
      DCGRU_PROBE_MARK(slot + 2);

      // candidate and state update; (n, j) of h_l has one owner
      chain_product(
          staged(smem, p.w, W.cell[cell][1], wsmem), H, K, sf, P.ldf, N,
          [&](int j, int n, float v) {
            const float c = activate(v + __ldg(bc + j), p.act);
            const float u = sru[n * P.ldru + H + j];
            const float hn = u * hl[n * P.ldh + j] + (1.0f - u) * c;
            hl[n * P.ldh + j] = hn;
            const size_t o = (lrow * N + n) * H + j;
            if (hs) hs[o] = from_f<S>(hn);
            if (cs) cs[o] = from_f<S>(c);
            if (l == L - 1) sp[n * P.ldp + j] = from_f<FT>(hn);
          });
      __syncthreads();
      DCGRU_PROBE_MARK(slot + 3);
    }

    // the projection of the top state, and the next step's layer-0 input
    // (the feedback uses the projection in f32)
    const float f = p.force[t];
    chain_product(
        staged(smem, p.w, W.wp, wsmem), D, H, sp, P.ldp, N,
        [&](int j, int n, float v) {
          v += __ldg(p.bp + j);
          const size_t o = (slab * N + n) * D + j;
          projs[o] = from_f<S>(v);
          sfeed[n * P.ldi + j] = f * to_f(xs[o]) + (1.0f - f) * v;
        });
    __syncthreads();
    DCGRU_PROBE_MARK(8);
  }
  DCGRU_PROBE_STORE;
}

// S: the dtype of the streams; FT: the products' operand type. Probe
// slots: dproj Wp^T, the four phases of the tied layers, of layer 0.
template <typename S, typename FT>
__global__ void __launch_bounds__(kLoopThreads<FT>, 1)
    dcgru_dec_bwd_loop_kernel(const LoopParams p, const int wsmem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, D = p.D, H = p.H, M = p.M, L = p.L;
  const LoopPlan<FT, S> P(N, D, H, M, L, wsmem);
  const DecOps<FT> W(false, D, H, M, L);
  uint4* sop = reinterpret_cast<uint4*>(smem + P.op);
  float* sdh = reinterpret_cast<float*>(smem + P.dh);
  float* sdy = reinterpret_cast<float*>(smem + P.dy);
  FT* spre = reinterpret_cast<FT*>(smem + P.pre);
  FT* sq = reinterpret_cast<FT*>(smem + P.q);
  S* sres = reinterpret_cast<S*>(smem + P.res);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int rows = 8 * ((N + 7) / 8);
  const int NN = N * N, MH = M * H, H2 = 2 * H, H3 = 3 * H;
  const int dhslab = N * P.ldh;

  const S* hps = static_cast<const S*>(p.h_prev);
  const S* rus = static_cast<const S*>(p.ru);
  const S* cs = static_cast<const S*>(p.c);
  const S* ds = static_cast<const S*>(p.d_seq);
  S* dxs = static_cast<S*>(p.dx);

  // the elementwise head of layer l at step t, given g = dh_l (the
  // cotangent from above added) at node n, column j: g kept as dh_l; du
  // and dc_pre into dpre and the product operand; the residuals the
  // layer's A^T apply of drh needs
  auto head = [&](int l, int t, int n, int j, float g) {
    const size_t lrow = ((size_t)l * p.T + t) * p.B + b;
    const size_t o = (lrow * N + n) * H + j;
    const size_t oru = (lrow * N + n) * H2 + j;
    const S hp = hps[o], r = rus[oru], u = rus[oru + H];
    const float uf = to_f(u), c = to_f(cs[o]);
    const float dc = g * (1.0f - uf) * act_grad(c, p.act);
    const float du = g * (to_f(hp) - c) * uf * (1.0f - uf);
    sdh[l * dhslab + n * P.ldh + j] = g;
    spre[n * P.ldpre + H + j] = from_f<FT>(du);
    spre[n * P.ldpre + H2 + j] = from_f<FT>(dc);
    float* dp = p.dpre + (lrow * N + n) * H3;
    dp[H + j] = du;
    dp[H2 + j] = dc;
    S* rs = sres + n * P.ldres;
    rs[j] = hp;
    rs[H + j] = r;
    rs[H2 + j] = u;
  };
  // the feedback cotangent din0 (from step t+1) at node n, column j splits
  // between x_t and proj_t
  auto feedback = [&](int t, int n, int j, float din) {
    const float f = p.force[t];
    const size_t o = (((size_t)t * p.B + b) * N + n) * D + j;
    const float v = to_f(ds[o]) + (1.0f - f) * din;
    p.dproj[o] = v;
    sq[n * P.ldq + j] = from_f<FT>(v);
    dxs[o] = from_f<S>(f * din);
  };

  if (wsmem) cp_block(smem, p.w, wsmem);
  cp_commit();
  // the clip's transposed operators (a shared graph has a_batch == 1)
  stage_op_frags(sop, p.a_ops + (size_t)(p.a_batch == 1 ? 0 : b) * NN,
                 p.a_batch, N, M, true);
  for (int i = tid; i < L * dhslab; i += nthr) sdh[i] = 0.0f;
  // the operands' padding (node rows >= N, padded columns) stays zero
  for (int i = tid; i < rows * P.ldy; i += nthr) sdy[i] = 0.0f;
  for (int i = tid; i < rows * P.ldpre; i += nthr) spre[i] = from_f<FT>(0.0f);
  for (int i = tid; i < rows * P.ldq; i += nthr) sq[i] = from_f<FT>(0.0f);
  __syncthreads();
  // the last step's dproj and dx (no feedback cotangent yet)
  for (int i = tid; i < N * D; i += nthr)
    feedback(p.T - 1, i / D, i % D, 0.0f);
  cp_wait<0>();
  __syncthreads();
  DCGRU_PROBE_START;

  for (int t = p.T - 1; t >= 0; --t) {
    // dh_{L-1} += dproj Wp^T, and the top layer's head
    chain_product(
        staged(smem, p.w, W.wp, wsmem), H, D, sq, P.ldq, N,
        [&](int j, int n, float v) {
          head(L - 1, t, n, j, sdh[(L - 1) * dhslab + n * P.ldh + j] + v);
        });
    __syncthreads();
    DCGRU_PROBE_MARK(0);

    for (int l = L - 1; l >= 0; --l) {
      const int cell = l == 0 ? 0 : 1, slot = l == 0 ? 5 : 1;
      const int Din = l == 0 ? D : H, MD = M * Din;
      float* sdhl = sdh + l * dhslab;
      float* dp = p.dpre + (((size_t)l * p.T + t) * p.B + b) * N * H3;

      // dc_pre Wc^T, as (Wc dc_pre^T)^T
      chain_product(
          staged(smem, p.w, W.cell[cell][2], wsmem), MH, H, spre + H2,
          P.ldpre, N, [&](int k, int n, float v) { sdy[n * P.ldy + k] = v; });
      __syncthreads();
      DCGRU_PROBE_MARK(slot);

      // drh = sum A_m^T (dc_pre Wc_m^T); the r half of dru_pre; dh_l
      // starts as g u + drh r
      diffuse_t_tc(sop, sdy, P.ldy, N, M, H, [&](int n, int c, float drh) {
        const S* rs = sres + n * P.ldres;
        const float hp = to_f(rs[c]), r = to_f(rs[H + c]), u = to_f(rs[H2 + c]);
        const float dr = drh * hp * r * (1.0f - r);
        spre[n * P.ldpre + c] = from_f<FT>(dr);
        dp[n * H3 + c] = dr;
        sdhl[n * P.ldh + c] = sdhl[n * P.ldh + c] * u + drh * r;
      });
      __syncthreads();
      DCGRU_PROBE_MARK(slot + 1);

      // dru_pre Wg^T, and the input's [dru_pre | dc_pre] [Wxg | Wxc]^T
      chain_product(
          staged(smem, p.w, W.cell[cell][0], wsmem), MH, H2, spre, P.ldpre,
          N, [&](int k, int n, float v) { sdy[n * P.ldy + k] = v; });
      chain_product(
          staged(smem, p.w, W.cell[cell][1], wsmem), MD, H3, spre, P.ldpre,
          N, [&](int k, int n, float v) { sdy[n * P.ldy + MH + k] = v; });
      __syncthreads();
      DCGRU_PROBE_MARK(slot + 2);

      // the A^T applies: dh_l, and the input cotangent, which flows into
      // the layer below at this step (its head), or is din0: the previous
      // step's dproj and dx
      diffuse_t_tc(sop, sdy, P.ldy, N, M, H, [&](int n, int c, float v) {
        sdhl[n * P.ldh + c] += v;
      });
      diffuse_t_tc(sop, sdy + MH, P.ldy, N, M, Din,
                   [&](int n, int j, float v) {
                     if (l > 0)
                       head(l - 1, t, n, j,
                            sdh[(l - 1) * dhslab + n * P.ldh + j] + v);
                     else if (t > 0)
                       feedback(t - 1, n, j, v);
                   });
      __syncthreads();
      DCGRU_PROBE_MARK(slot + 3);
    }
  }
  DCGRU_PROBE_STORE;

  for (int i = tid; i < L * N * H; i += nthr) {
    const int l = i / (N * H), n = (i / H) % N, c = i % H;
    p.dh0[((size_t)l * p.B + b) * N * H + n * H + c] =
        sdh[l * dhslab + n * P.ldh + c];
  }
}

// One stage of dWp's operands, rows [k0, k0 + kDwpK) of the split: each
// thread's kDwpLoads elements of the h_top and g tiles (one column c,
// every kStep-th row), into registers (past the ends: zeros). Unrolled,
// so all of them are in flight at once.
template <typename S>
__device__ __forceinline__ void dwp_stage(const DwpParams& p, int k0, int r1,
                                          int h0, int d0, int tid,
                                          float (&vh)[kDwpLoads],
                                          float (&vg)[kDwpLoads]) {
  constexpr int kStep = kDwpThreads / kDwpTile;
  const int c = tid % kDwpTile, r = k0 + tid / kDwpTile;
  const bool hc = h0 + c < p.H, gc = d0 + c < p.D;
  const S* hp = static_cast<const S*>(p.h_top) + (size_t)r * p.H + h0 + c;
  const float* gp = p.g + (size_t)r * p.D + d0 + c;
#pragma unroll
  for (int q = 0; q < kDwpLoads; ++q) {
    const bool ok = r + q * kStep < r1;
    vh[q] = ok && hc ? to_f(hp[(size_t)q * kStep * p.H]) : 0.0f;
    vg[q] = ok && gc ? gp[(size_t)q * kStep * p.D] : 0.0f;
  }
}

// dWp / dbp split partials: block (tile, split) sums rows
// [split * kDwpRows, ...) into a 64 x 64 tile of dWp = h_top^T g, each
// thread a 4 x 4 register tile; in the blocks of the first row tile the
// first 16 threads also sum their 4 columns of dbp from the same g reads.
// The next stage's loads are in flight while a stage's products run;
// every output sums its rows in order.
template <typename S>
__global__ void __launch_bounds__(kDwpThreads)
    dcgru_dec_dwp_kernel(const DwpParams p) {
  __shared__ __align__(16) float sh[kDwpK][kDwpTile + 4];
  __shared__ __align__(16) float sg[kDwpK][kDwpTile + 4];
  const int H = p.H, D = p.D;
  const int tiles_d = (D + kDwpTile - 1) / kDwpTile;
  const int h0 = (blockIdx.x / tiles_d) * kDwpTile;
  const int d0 = (blockIdx.x % tiles_d) * kDwpTile;
  const int r0 = blockIdx.y * kDwpRows;
  const int r1 = min(p.R, r0 + kDwpRows);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const bool with_db = h0 == 0 && ty == 0;

  float acc[4][4];
  float db[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float vh[kDwpLoads], vg[kDwpLoads];
  dwp_stage<S>(p, r0, r1, h0, d0, tid, vh, vg);
  for (int k0 = r0; k0 < r1; k0 += kDwpK) {
#pragma unroll
    for (int q = 0; q < kDwpLoads; ++q) {
      const int i = tid + q * kDwpThreads;
      sh[i / kDwpTile][i % kDwpTile] = vh[q];
      sg[i / kDwpTile][i % kDwpTile] = vg[q];
    }
    __syncthreads();
    if (k0 + kDwpK < r1) dwp_stage<S>(p, k0 + kDwpK, r1, h0, d0, tid, vh, vg);
#pragma unroll 8
    for (int k = 0; k < kDwpK; ++k) {
      const float4 u = *reinterpret_cast<const float4*>(&sh[k][ty * 4]);
      const float4 v = *reinterpret_cast<const float4*>(&sg[k][tx * 4]);
      const float uu[4] = {u.x, u.y, u.z, u.w};
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(uu[i], vv[j], acc[i][j]);
      if (with_db)
#pragma unroll
        for (int j = 0; j < 4; ++j) db[j] += vv[j];
    }
    __syncthreads();
  }

  float* out = p.part + (size_t)blockIdx.y * ((size_t)H * D + D);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int h = h0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = d0 + tx * 4 + j;
      if (h < H && col < D) out[(size_t)h * D + col] = acc[i][j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = d0 + tx * 4 + j;
    if (with_db && col < D) out[(size_t)H * D + col] = db[j];
  }
}

bool valid_shape(int T, int B, int N, int D, int H, int M, int L) {
  return T >= 1 && B >= 1 && N >= 1 && N <= kMaxNodes && H >= 4 &&
         H % 4 == 0 && D >= 4 && D % 4 == 0 && M >= 1 && L >= 1;
}

// The plan of a loop (fwd: the forward, else the backward loop) at this
// shape: the staged-weight prefix in shared memory and the block's bytes.
template <typename S, typename FT>
bool loop_plan(bool fwd, int N, int D, int H, int M, int L, int& wsmem,
               int& bytes) {
  const DecOps<FT> W(fwd, D, H, M, L);
  return fwd ? dec_plan<FwdPlan<FT>>(W.cuts, N, D, H, M, L, wsmem, bytes)
             : dec_plan<LoopPlan<FT, S>>(W.cuts, N, D, H, M, L, wsmem,
                                         bytes);
}

template <typename S, typename FT>
int launch_fwd(const FwdParams& p, cudaStream_t stream) {
  if (!valid_shape(p.T, p.B, p.N, p.D, p.H, p.M, p.L))
    return (int)cudaErrorInvalidValue;
  int wsmem, bytes;
  if (!loop_plan<S, FT>(true, p.N, p.D, p.H, p.M, p.L, wsmem, bytes))
    return (int)cudaErrorInvalidValue;
  auto kern = dcgru_dec_fwd_kernel<S, FT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<p.B, kFwdThreads<FT>, bytes, stream>>>(p, wsmem);
  return (int)cudaGetLastError();
}

template <typename S, typename FT>
int launch_loop(const LoopParams& p, cudaStream_t stream) {
  if (!valid_shape(p.T, p.B, p.N, p.D, p.H, p.M, p.L))
    return (int)cudaErrorInvalidValue;
  int wsmem, bytes;
  if (!loop_plan<S, FT>(false, p.N, p.D, p.H, p.M, p.L, wsmem, bytes))
    return (int)cudaErrorInvalidValue;
  auto kern = dcgru_dec_bwd_loop_kernel<S, FT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<p.B, kLoopThreads<FT>, bytes, stream>>>(p, wsmem);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_dwp(const DwpParams& p, cudaStream_t stream) {
  if (p.R < 1 || p.H < 4 || p.H % 4 || p.D < 4 || p.D % 4)
    return (int)cudaErrorInvalidValue;
  const int tiles = ((p.H + kDwpTile - 1) / kDwpTile) *
                    ((p.D + kDwpTile - 1) / kDwpTile);
  const dim3 grid(tiles, (p.R + kDwpRows - 1) / kDwpRows);
  dcgru_dec_dwp_kernel<S><<<grid, kDwpThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// act: 0 tanh, 1 relu, 2 linear. bf16: streams are bf16 (else f32).
// w: the staged weights (ops/cuda_decoder.py, decoder_fwd_weights), bf16
// for bf16 streams, else f32. The shared cell's biases are read only when
// L > 1; in0, h_seq, ru_seq and c_seq are written only when non-null.
// Returns a cudaError_t: 0 on a launch that was accepted.
int dcgru_decoder_fwd(const void* x, const float* force, const float* a_ops,
                      int a_batch, const void* w, const float* b0g,
                      const float* b0c, const float* bsg, const float* bsc,
                      const float* bp, const float* h0, void* proj, void* in0,
                      void* h_seq, void* ru_seq, void* c_seq, int T, int B,
                      int N, int D, int H, int M, int L, int act, int bf16,
                      void* stream) {
  FwdParams p{x,     force, a_ops, w, {{b0g, b0c}, {bsg, bsc}},
              bp,    h0,    proj,  in0, h_seq, ru_seq, c_seq,
              T,     B,     N,     D,   H,     M,      L,
              a_batch, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16, __nv_bfloat16>(p, s)
              : launch_fwd<float, float>(p, s);
}

// w: the staged weights (ops/cuda_decoder.py, decoder_bwd_weights), bf16
// for bf16 streams, else f32; the streams are layer-major. Writes dx, dh0,
// dpre and dproj.
int dcgru_dec_bwd_loop(const float* a_ops, int a_batch, const void* w,
                       const void* h_prev, const void* ru, const void* c,
                       const void* d_seq, const float* force, void* dx,
                       float* dh0, float* dpre, float* dproj, int T, int B,
                       int N, int D, int H, int M, int L, int act, int bf16,
                       void* stream) {
  LoopParams p{a_ops, w,  h_prev, ru, c, d_seq, force, dx, dh0, dpre, dproj,
               T,     B,  N,      D,  H, M,     L,     a_batch, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_loop<__nv_bfloat16, __nv_bfloat16>(p, s)
              : launch_loop<float, float>(p, s);
}

// The launch plan a loop takes on the current card (fwd != 0: the
// forward, else the backward loop): out[0] the bytes of staged weights in
// shared memory, out[1] the block's shared memory; the staged weights'
// bytes in out[2]. Returns a cudaError_t (cudaErrorInvalidValue where no
// plan fits).
int dcgru_dec_plan(int fwd, int N, int D, int H, int M, int L, int bf16,
                   int* out) {
  if (!valid_shape(1, 1, N, D, H, M, L)) return (int)cudaErrorInvalidValue;
  bool ok;
  if (bf16) {
    ok = loop_plan<__nv_bfloat16, __nv_bfloat16>(fwd, N, D, H, M, L, out[0],
                                                 out[1]);
    out[2] = DecOps<__nv_bfloat16>(fwd, D, H, M, L).total;
  } else {
    ok = loop_plan<float, float>(fwd, N, D, H, M, L, out[0], out[1]);
    out[2] = DecOps<float>(fwd, D, H, M, L).total;
  }
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// part (ceil(R / 256), H*D + D) f32: split s sums the rows
// [256 s, min(256 (s+1), R)) of h_top (R, H) (bf16 when bf16 != 0, else
// f32) and g (R, D) f32 into [dWp = h_top^T g | dbp = sum g]; every entry
// is written.
int dcgru_dec_dwp(const void* h_top, const float* g, float* part, int R,
                  int H, int D, int bf16, void* stream) {
  DwpParams p{h_top, g, part, R, H, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dwp<__nv_bfloat16>(p, s) : launch_dwp<float>(p, s);
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
