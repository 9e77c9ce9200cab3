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
//   layer l = L-1 .. 0: the state part of the x-in cell backward
//     (dcgru_recurrence_bwd.cu) and its input cotangent, which adds into
//     dh_{l-1} at the same step, or becomes din0 at l = 0.
// The residuals are layer-major, (L, T, B, N, W), so each layer's stream,
// and layers 1..L-1 together, are contiguous for the bulk dW kernel.
//
// What bounds it on an H100. At the SSL shape (T_out=12, B=128, N=19,
// H=64, D=100, L=3, M=3) the forward does ~10.3 MFLOP per clip-step, ~16
// GFLOP a launch, ~0.24 ms at the 67 TFLOP/s non-tensor f32 rate these
// kernels use (f32 FMA, no TF32), against ~3 us for the ~10 MB of streams.
// The backward loop does the weight-transpose products and A^T applies,
// ~10 MFLOP per clip-step, ~0.23 ms; it writes dpre (67 MB f32), ~0.03 ms
// of bytes. Both bound by operations. dWp is ~0.4 GFLOP over ~15 MB: on
// the tensor cores (as the reference's one bf16 pass) bound by bytes.
//
// Design, as the encoder's kernels: one thread block per clip with the
// T_out loop inside and the layer loop inside that; the L state
// cotangents, din0, the clip's M-1 operators and the step's
// weight-transpose products in shared memory (forward 105 KB, backward
// loop 132 KB at M=5, D=100, L=3); the TPU's 19 -> 24 node padding and clip
// block diagonals dropped (ragged rows are masked); weights from global
// memory (L2), the backward's transposed by the wrapper. Streams (x, proj
// and the residuals in0, h, ru, c; d_seq, dx) are f32 or bf16; state,
// weights, dpre, dproj, dW and every sum are f32 (pallas_decoder.py:441-445,
// 527-536). dWp: a block sums a 64 x 64 tile of (H, D) over a fixed split
// of 256 rows on f32 FMA (16 outputs per thread), no atomics, the next 32
// rows' loads in flight during each 32 rows' products.
// Tensor cores for the loops' 19-row products, and several clips per
// block, are later work.

#include "dcgru_common.cuh"

namespace {

using namespace dcgru;

struct FwdParams {
  const void* x;         // (T, B, N, D) teacher-forcing stream
  const float* force;    // (T,) per-step force f_t in {0, 1}
  const float* a_ops;    // (M, a_batch, N, N), a_batch in {1, B}
  const float* w[2][4];  // [layer 0 | shared] x [wxg (M*Din, 2H),
                         // wxc (M*Din, H), wg (M*H, 2H), wc (M*H, H)]
  const float* bias[2][2];  // [layer 0 | shared] x [bg (2H), bc (H)]
  const float* wp;       // (H, D) projection (proj_w^T)
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
  const float* wT[2][4];  // [layer 0 | shared] x [wxgT (2H, M*Din),
                          // wxcT (H, M*Din), wgT (2H, M*H), wcT (H, M*H)]
  const float* wpT;       // (D, H) = proj_w
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

// Shared-memory layouts, in floats; every array starts 16-byte aligned.
// Dm = max(D, H) is the widest layer input.
struct FwdSmem {
  int a, h, in, hf, xf, ru, xc, total;
  __host__ __device__ FwdSmem(int N, int D, int H, int M, int L) {
    const int Dm = D > H ? D : H;
    a = 0;                               // (M-1, N, N) operators
    h = a + pad4((M - 1) * N * N);       // (L, N, H) states
    in = h + pad4(L * N * H);            // (N, D) layer-0 input (feedback)
    hf = in + pad4(N * D);               // (N, M*H) state features
    xf = hf + pad4(N * M * H);           // (N, M*Din) input features
    ru = xf + pad4(N * M * Dm);          // (N, 2H) gates
    xc = ru + pad4(N * 2 * H);           // (N, H) input part of cand
    total = xc + pad4(N * H);
  }
};

struct LoopSmem {
  int a, dh, din, hp, ru, c, dyh, dyx, dru, drh, dxa, total;
  __host__ __device__ LoopSmem(int N, int D, int H, int M, int L) {
    const int Dm = D > H ? D : H;
    a = 0;                               // (M-1, N, N) operators
    dh = a + pad4((M - 1) * N * N);      // (L, N, H) state cotangents
    din = dh + pad4(L * N * H);          // (N, D) din0, carried down in t
    hp = din + pad4(N * D);              // (N, H) h_prev
    ru = hp + pad4(N * H);               // (N, 2H) r | u
    c = ru + pad4(N * 2 * H);            // (N, H) dc_pre
    dyh = c + pad4(N * H);               // (N, M*H) dpre W_h^T
    dyx = dyh + pad4(N * M * H);         // (N, M*Din) dpre W_x^T
    dru = dyx + pad4(N * M * Dm);        // (N, 2H) dru_pre
    drh = dru + pad4(N * 2 * H);         // (N, H) drh
    dxa = drh + pad4(N * H);             // (N, Din) cand part of din;
    total = dxa + pad4(N * Dm);          //   dproj (N, D) at the top
  }
};

constexpr int kDwpTile = 64;   // dWp outputs of a block: 64 rows x 64 cols
constexpr int kDwpK = 32;      // rows per shared-memory stage
constexpr int kDwpRows = 256;  // rows a split sums (ops/cuda_decoder.py)
constexpr int kDwpThreads = 256;
constexpr int kDwpLoads = kDwpK * kDwpTile / kDwpThreads;  // per thread

template <typename S>
__global__ void __launch_bounds__(kMaxThreads)
    dcgru_dec_fwd_kernel(const FwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, D = p.D, H = p.H, M = p.M, L = p.L;
  const FwdSmem sm(N, D, H, M, L);
  float* sA = smem + sm.a;
  float* sh = smem + sm.h;
  float* sfeed = smem + sm.in;
  float* hf = smem + sm.hf;
  float* xf = smem + sm.xf;
  float* sru = smem + sm.ru;
  float* sxc = smem + sm.xc;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int NN = N * N, NH = N * H, MH = M * H, H2 = 2 * H, H3 = 3 * H;
  const int chunks = (N + kRows - 1) / kRows;

  // the clip's operators A_1..A_{M-1} (a shared graph has a_batch == 1),
  // the L initial states, and the GO symbol
  const float* a_clip = p.a_ops + (size_t)(p.a_batch == 1 ? 0 : b) * NN;
  for (int i = tid; i < (M - 1) * NN; i += nthr) {
    int m = i / NN + 1, e = i - (m - 1) * NN;
    sA[i] = a_clip[(size_t)m * p.a_batch * NN + e];
  }
  for (int i = tid; i < L * NH; i += nthr) {
    const int l = i / NH, e = i - l * NH;
    sh[i] = p.h0[((size_t)l * p.B + b) * NH + e];
  }
  for (int i = tid; i < N * D; i += nthr) sfeed[i] = 0.0f;

  const S* xs = static_cast<const S*>(p.x);
  S* projs = static_cast<S*>(p.proj);
  S* in0s = static_cast<S*>(p.in0);
  S* hs = static_cast<S*>(p.h_seq);
  S* rus = static_cast<S*>(p.ru_seq);
  S* cs = static_cast<S*>(p.c_seq);

  for (int t = 0; t < p.T; ++t) {
    const size_t slab = (size_t)t * p.B + b;  // (t, b) row of x, proj, in0
    __syncthreads();  // the previous step's states and feedback are in
    if (in0s)
      for (int i = tid; i < N * D; i += nthr)
        in0s[slab * N * D + i] = from_f<S>(sfeed[i]);

    for (int l = 0; l < L; ++l) {
      const int cell = l == 0 ? 0 : 1;
      const int Din = l == 0 ? D : H, MD = M * Din;
      const float* in = l == 0 ? sfeed : sh + (l - 1) * NH;
      float* hl = sh + l * NH;
      const float* wxg = p.w[cell][0];
      const float* wxc = p.w[cell][1];
      const float* wg = p.w[cell][2];
      const float* wc = p.w[cell][3];
      // the (l, t, b) row of the layer-major residuals
      const size_t lrow = ((size_t)l * p.T + t) * p.B + b;

      // diffuse [h_l | in_l]: one (m, column) per task
      const int wcols = H + Din;
      for (int task = tid; task < M * wcols; task += nthr) {
        const int m = task / wcols, cc = task - m * wcols;
        const bool is_h = cc < H;
        const float* src = is_h ? hl + cc : in + (cc - H);
        const int lds = is_h ? H : Din;
        float v[kMaxNodes];
#pragma unroll
        for (int k = 0; k < kMaxNodes; ++k)
          if (k < N) v[k] = src[k * lds];
        if (is_h)
          diffuse_col(v, sA, N, m, hf + m * H + cc, MH);
        else
          diffuse_col(v, sA, N, m, xf + m * Din + (cc - H), MD);
      }
      __syncthreads();

      // gates, and the input half of the candidate
      for (int task = tid; task < H3 * chunks; task += nthr) {
        const int chunk = task / H3, j = task - chunk * H3;
        const int r0 = chunk * kRows;
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
        if (j < H2) {
          gemm_col(acc, xf, MD, r0, N, wxg + j, H2);
          gemm_col(acc, hf, MH, r0, N, wg + j, H2);
          const float bj = p.bias[cell][0][j];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int n = r0 + r;
            if (n < N) {
              const float v = sigmoid(acc[r] + bj);
              sru[n * H2 + j] = v;
              if (rus)
                rus[(lrow * N + n) * H2 + j] = from_f<S>(v);
            }
          }
        } else {
          const int jj = j - H2;
          gemm_col(acc, xf, MD, r0, N, wxc + jj, H);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (r0 + r < N) sxc[(r0 + r) * H + jj] = acc[r];
        }
      }
      __syncthreads();

      // diffuse r*h into the state features (their h features are spent)
      for (int task = tid; task < M * H; task += nthr) {
        const int m = task / H, cc = task - m * H;
        float v[kMaxNodes];
#pragma unroll
        for (int k = 0; k < kMaxNodes; ++k)
          if (k < N) v[k] = sru[k * H2 + cc] * hl[k * H + cc];
        diffuse_col(v, sA, N, m, hf + m * H + cc, MH);
      }
      __syncthreads();

      // candidate and state update; (n, j) of h_l has one owner
      for (int task = tid; task < H * chunks; task += nthr) {
        const int chunk = task / H, j = task - chunk * H;
        const int r0 = chunk * kRows;
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
        gemm_col(acc, hf, MH, r0, N, wc + j, H);
        const float bj = p.bias[cell][1][j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int n = r0 + r;
          if (n < N) {
            const float c = activate(acc[r] + bj + sxc[n * H + j], p.act);
            const float u = sru[n * H2 + H + j];
            const float hn = u * hl[n * H + j] + (1.0f - u) * c;
            hl[n * H + j] = hn;
            const size_t o = (lrow * N + n) * H + j;
            if (hs) hs[o] = from_f<S>(hn);
            if (cs) cs[o] = from_f<S>(c);
          }
        }
      }
      __syncthreads();
    }

    // projection of the top state, and the next step's layer-0 input
    const float f = p.force[t];
    const float* top = sh + (L - 1) * NH;
    for (int task = tid; task < D * chunks; task += nthr) {
      const int chunk = task / D, j = task - chunk * D;
      const int r0 = chunk * kRows;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      gemm_col(acc, top, H, r0, N, p.wp + j, D);
      const float bj = p.bp[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = r0 + r;
        if (n < N) {
          const float v = acc[r] + bj;
          const size_t o = (slab * N + n) * D + j;
          projs[o] = from_f<S>(v);
          sfeed[n * D + j] = f * to_f(xs[o]) + (1.0f - f) * v;
        }
      }
    }
  }
}

template <typename S>
__global__ void __launch_bounds__(kMaxThreads)
    dcgru_dec_bwd_loop_kernel(const LoopParams p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, D = p.D, H = p.H, M = p.M, L = p.L;
  const LoopSmem sm(N, D, H, M, L);
  float* sA = smem + sm.a;
  float* sdh = smem + sm.dh;
  float* sdin = smem + sm.din;
  float* shp = smem + sm.hp;
  float* sru = smem + sm.ru;
  float* sdc = smem + sm.c;
  float* sdyh = smem + sm.dyh;
  float* sdyx = smem + sm.dyx;
  float* sdru = smem + sm.dru;
  float* sdrh = smem + sm.drh;
  float* sdxa = smem + sm.dxa;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int NN = N * N, NH = N * H, MH = M * H, H2 = 2 * H, H3 = 3 * H;
  const int chunks = (N + kRows - 1) / kRows;
  const int tchunks = (N + kTRows - 1) / kTRows;

  const float* a_clip = p.a_ops + (size_t)(p.a_batch == 1 ? 0 : b) * NN;
  for (int i = tid; i < (M - 1) * NN; i += nthr) {
    int m = i / NN + 1, e = i - (m - 1) * NN;
    sA[i] = a_clip[(size_t)m * p.a_batch * NN + e];
  }
  for (int i = tid; i < L * NH; i += nthr) sdh[i] = 0.0f;
  for (int i = tid; i < N * D; i += nthr) sdin[i] = 0.0f;

  const S* hps = static_cast<const S*>(p.h_prev);
  const S* rus = static_cast<const S*>(p.ru);
  const S* cs = static_cast<const S*>(p.c);
  const S* ds = static_cast<const S*>(p.d_seq);
  S* dxs = static_cast<S*>(p.dx);
  __syncthreads();

  for (int t = p.T - 1; t >= 0; --t) {
    const size_t slab = (size_t)t * p.B + b;  // (t, b) row of d_seq, dx
    const float f = p.force[t];

    // S0: the feedback cotangent splits between x_t and proj_t
    float* sdp = sdxa;  // dproj (N, D) until the layer loop
    for (int i = tid; i < N * D; i += nthr) {
      const size_t o = slab * N * D + i;
      const float din = sdin[i];
      const float v = to_f(ds[o]) + (1.0f - f) * din;
      sdp[i] = v;
      p.dproj[o] = v;
      dxs[o] = from_f<S>(f * din);
    }
    __syncthreads();

    // S1: dh_{L-1} += dproj Wp^T
    float* dtop = sdh + (L - 1) * NH;
    for (int task = tid; task < H * chunks; task += nthr) {
      const int chunk = task / H, j = task - chunk * H;
      const int r0 = chunk * kRows;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      gemm_col(acc, sdp, D, r0, N, p.wpT + j, H);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r0 + r < N) dtop[(r0 + r) * H + j] += acc[r];
    }
    __syncthreads();

    for (int l = L - 1; l >= 0; --l) {
      const int cell = l == 0 ? 0 : 1;
      const int Din = l == 0 ? D : H, MD = M * Din;
      const float* wxgT = p.wT[cell][0];
      const float* wxcT = p.wT[cell][1];
      const float* wgT = p.wT[cell][2];
      const float* wcT = p.wT[cell][3];
      float* sdhl = sdh + l * NH;
      // the (l, t, b) row of the layer-major streams and of dpre
      const size_t lrow = ((size_t)l * p.T + t) * p.B + b;
      float* dpre = p.dpre + lrow * N * H3;

      // P0: residuals in; g (dh_l, the cotangent from above already
      // added), du_pre and dc_pre (written to dpre)
      for (int i = tid; i < NH; i += nthr) {
        const int n = i / H, j = i - n * H;
        const size_t o = lrow * NH + i;
        const size_t oru = (lrow * N + n) * H2 + j;
        const float hp = to_f(hps[o]);
        const float r = to_f(rus[oru]);
        const float u = to_f(rus[oru + H]);
        const float c = to_f(cs[o]);
        const float g = sdhl[i];
        const float dc = g * (1.0f - u) * act_grad(c, p.act);
        const float du = g * (hp - c) * u * (1.0f - u);
        shp[i] = hp;
        sru[n * H2 + j] = r;
        sru[n * H2 + H + j] = u;
        sdc[i] = dc;
        sdru[n * H2 + H + j] = du;
        dpre[n * H3 + H + j] = du;
        dpre[n * H3 + H2 + j] = dc;
      }
      __syncthreads();

      // P2: candidate weight-transpose products dc_pre [Wc | Wxc]^T
      const int n_wt = (MH + MD) * chunks;
      for (int task = tid; task < n_wt; task += nthr) {
        const int chunk = task / (MH + MD), j = task - chunk * (MH + MD);
        const int r0 = chunk * kRows;
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
        float* dst;
        int ldd;
        if (j < MH) {
          gemm_col(acc, sdc, H, r0, N, wcT + j, MH);
          dst = sdyh + j;
          ldd = MH;
        } else {
          gemm_col(acc, sdc, H, r0, N, wxcT + (j - MH), MD);
          dst = sdyx + (j - MH);
          ldd = MD;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r0 + r < N) dst[(r0 + r) * ldd] = acc[r];
      }
      __syncthreads();

      // P3: A^T applies: drh and the gate half of dru_pre (written to
      // dpre), and the candidate part of the input cotangent
      for (int task = tid; task < (H + Din) * tchunks; task += nthr) {
        const int chunk = task / (H + Din), cc = task - chunk * (H + Din);
        const int n0 = chunk * kTRows;
        float acc[kTRows];
        if (cc < H) {
          diffuse_t_col(acc, sA, N, M, sdyh + cc, MH, H, n0);
#pragma unroll
          for (int i = 0; i < kTRows; ++i) {
            const int n = n0 + i;
            if (n < N) {
              const float r = sru[n * H2 + cc];
              const float dr = acc[i] * shp[n * H + cc] * r * (1.0f - r);
              sdrh[n * H + cc] = acc[i];
              sdru[n * H2 + cc] = dr;
              dpre[n * H3 + cc] = dr;
            }
          }
        } else {
          const int j = cc - H;
          diffuse_t_col(acc, sA, N, M, sdyx + j, MD, Din, n0);
#pragma unroll
          for (int i = 0; i < kTRows; ++i)
            if (n0 + i < N) sdxa[(n0 + i) * Din + j] = acc[i];
        }
      }
      __syncthreads();

      // P4: gate weight-transpose products dru_pre [Wg | Wxg]^T
      for (int task = tid; task < n_wt; task += nthr) {
        const int chunk = task / (MH + MD), j = task - chunk * (MH + MD);
        const int r0 = chunk * kRows;
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
        float* dst;
        int ldd;
        if (j < MH) {
          gemm_col(acc, sdru, H2, r0, N, wgT + j, MH);
          dst = sdyh + j;
          ldd = MH;
        } else {
          gemm_col(acc, sdru, H2, r0, N, wxgT + (j - MH), MD);
          dst = sdyx + (j - MH);
          ldd = MD;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r0 + r < N) dst[(r0 + r) * ldd] = acc[r];
      }
      __syncthreads();

      // P5: the gate A^T applies: dh_prev, and the rest of the input
      // cotangent, which flows into the layer below at this step (or is
      // din0, for x_{t-1} and proj_{t-1})
      for (int task = tid; task < (H + Din) * tchunks; task += nthr) {
        const int chunk = task / (H + Din), cc = task - chunk * (H + Din);
        const int n0 = chunk * kTRows;
        float acc[kTRows];
        if (cc < H) {
          diffuse_t_col(acc, sA, N, M, sdyh + cc, MH, H, n0);
#pragma unroll
          for (int i = 0; i < kTRows; ++i) {
            const int n = n0 + i;
            if (n < N) {
              const float g = sdhl[n * H + cc];
              const float r = sru[n * H2 + cc], u = sru[n * H2 + H + cc];
              sdhl[n * H + cc] = g * u + sdrh[n * H + cc] * r + acc[i];
            }
          }
        } else {
          const int j = cc - H;
          diffuse_t_col(acc, sA, N, M, sdyx + j, MD, Din, n0);
#pragma unroll
          for (int i = 0; i < kTRows; ++i) {
            const int n = n0 + i;
            if (n < N) {
              const float v = sdxa[n * Din + j] + acc[i];
              if (l == 0)
                sdin[n * D + j] = v;
              else
                sdh[(l - 1) * NH + n * H + j] += v;
            }
          }
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < L * NH; i += nthr) {
    const int l = i / NH, e = i - l * NH;
    p.dh0[((size_t)l * p.B + b) * NH + e] = sdh[i];
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

template <typename S>
int launch_fwd(const FwdParams& p, cudaStream_t stream) {
  if (!valid_shape(p.T, p.B, p.N, p.D, p.H, p.M, p.L))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)FwdSmem(p.N, p.D, p.H, p.M, p.L).total * sizeof(float);
  auto kern = dcgru_dec_fwd_kernel<S>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (p.N + kRows - 1) / kRows;
  int work = 3 * p.H * chunks;
  if (p.D * chunks > work) work = p.D * chunks;
  int nthr = ((work + 31) / 32) * 32;
  if (nthr < 128) nthr = 128;
  if (nthr > kMaxThreads) nthr = kMaxThreads;
  kern<<<p.B, nthr, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_loop(const LoopParams& p, cudaStream_t stream) {
  if (!valid_shape(p.T, p.B, p.N, p.D, p.H, p.M, p.L))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)LoopSmem(p.N, p.D, p.H, p.M, p.L).total * sizeof(float);
  auto kern = dcgru_dec_bwd_loop_kernel<S>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<p.B, kMaxThreads, smem, stream>>>(p);
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
// The shared cell's pointers are read only when L > 1; in0, h_seq,
// ru_seq and c_seq are written only when non-null.
// Returns a cudaError_t: 0 on a launch that was accepted.
int dcgru_decoder_fwd(const void* x, const float* force, const float* a_ops,
                      int a_batch, const float* wx0g, const float* wx0c,
                      const float* wh0g, const float* wh0c, const float* b0g,
                      const float* b0c, const float* wxsg, const float* wxsc,
                      const float* whsg, const float* whsc, const float* bsg,
                      const float* bsc, const float* wp, const float* bp,
                      const float* h0, void* proj, void* in0, void* h_seq,
                      void* ru_seq, void* c_seq, int T, int B, int N, int D,
                      int H, int M, int L, int act, int bf16, void* stream) {
  FwdParams p{x,
              force,
              a_ops,
              {{wx0g, wx0c, wh0g, wh0c}, {wxsg, wxsc, whsg, whsc}},
              {{b0g, b0c}, {bsg, bsc}},
              wp,
              bp,
              h0,
              proj,
              in0,
              h_seq,
              ru_seq,
              c_seq,
              T, B, N, D, H, M, L, a_batch, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(p, s) : launch_fwd<float>(p, s);
}

// Weights arrive transposed (see LoopParams); the streams are
// layer-major. Writes dx, dh0, dpre and dproj.
int dcgru_dec_bwd_loop(const float* a_ops, int a_batch, const float* wx0gT,
                       const float* wx0cT, const float* wh0gT,
                       const float* wh0cT, const float* wxsgT,
                       const float* wxscT, const float* whsgT,
                       const float* whscT, const float* wpT,
                       const void* h_prev, const void* ru, const void* c,
                       const void* d_seq, const float* force, void* dx,
                       float* dh0, float* dpre, float* dproj, int T, int B,
                       int N, int D, int H, int M, int L, int act, int bf16,
                       void* stream) {
  LoopParams p{a_ops,
               {{wx0gT, wx0cT, wh0gT, wh0cT}, {wxsgT, wxscT, whsgT, whscT}},
               wpT,
               h_prev,
               ru,
               c,
               d_seq,
               force,
               dx,
               dh0,
               dpre,
               dproj,
               T, B, N, D, H, M, L, a_batch, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_loop<__nv_bfloat16>(p, s) : launch_loop<float>(p, s);
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

const char* dcgru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
