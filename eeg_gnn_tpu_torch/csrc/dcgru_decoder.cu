// Whole-sequence DCGRU seq2seq decoder, forward and backward (BPTT), for
// NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of eeg_gnn_tpu/ops/pallas_decoder.py:
//   dcgru_decoder_fwd  <- _fwd_kernel_dec (:157, launched from _forward_dec
//                         :381/:401): all L cells, the output projection and
//                         the scheduled-sampling feedback over T_out steps;
//   dcgru_decoder_bwd  <- _bwd_kernel_dec (:229, launched from _backward_dec
//                         :456/:477): its BPTT. The TPU grid summed dW into
//                         resident blocks; here each clip leaves one f32
//                         partial slab, which dcgru_dw_reduce
//                         (dcgru_recurrence_bwd.cu) sums in a fixed order.
//
// Forward, step t of every clip (A_0 = I; layer 0 has input width D and
// its own cell, layers >= 1 width H and ONE shared cell, the reference's
// tied-weight quirk):
//   in_0   = t == 0 ? 0 (GO) : f_{t-1} x_{t-1} + (1 - f_{t-1}) proj_{t-1}
//   layer l: feats = A_m [h_l | in_l];  ru = sigmoid(feats W_g + b_g)
//            c = act(A_m in_l W_xc + A_m (r h_l) W_c + b_c)
//            h_l = u h_l + (1 - u) c;  in_{l+1} = h_l
//   proj_t = h_{L-1} Wp + bp   (the feedback uses it in f32)
// Backward, walking t down (pallas_decoder.py:31-41):
//   dproj = dseq_t + (1 - f_t) din0;  dx_t = f_t din0
//   dWp += h_{L-1}^T dproj;  dbp += dproj;  dh_{L-1} += dproj Wp^T
//   layer l = L-1 .. 0: the x-in cell backward of dcgru_recurrence_bwd.cu
//     on [h_prev | r h_prev | in_l] (recomputed); its input cotangent adds
//     into dh_{l-1} at the same step, or becomes din0 at l = 0; layers
//     >= 1 add into the one shared slab, one after another in the block.
//
// What bounds it on an H100. At the SSL shape (T_out=12, B=128, N=19,
// H=64, D=100, L=3, M=3) the forward does ~10.3 MFLOP per clip-step,
// ~16 GFLOP a launch, ~0.24 ms at the 67 TFLOP/s non-tensor f32 rate
// these kernels use (f32 FMA, no TF32), against ~3 us for the ~10 MB
// of streams; the backward ~21 MFLOP per clip-step, ~32 GFLOP, ~0.48 ms.
// Both are bound by operations. The backward adds traffic the bound does
// not count: each clip reads and writes its 700 KB f32 dW slab (layer 0,
// shared cell twice at L=3, projection) every step, ~2 MB per clip-step.
//
// Design, as the encoder's kernels: one thread block per clip with the
// T_out loop inside and the layer loop inside that; the L states (and in
// the backward the L state cotangents and din0), the clip's M-1
// operators, the step's inputs and recomputed features in shared memory
// (forward 105 KB, backward 226 KB at M=5, D=100, L=3); the TPU's
// 19 -> 24 node padding and clip block diagonals dropped (ragged rows are
// masked); weights from global memory (L2), the backward's transposed by
// the wrapper; dW in per-clip slabs, no atomics. Streams (x, proj and the
// residuals in0, h, ru, c; d_seq, dx) are f32 or bf16; state, weights,
// dW and every sum are f32 (pallas_decoder.py:441-445, 527-536).
// wgmma, several clips per block and a register-tiled dW are later work.

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
  void* h_seq;           // (T, B, N, L*H), or null
  void* ru_seq;          // (T, B, N, L*2H), or null
  void* c_seq;           // (T, B, N, L*H), or null
  int T, B, N, D, H, M, L, a_batch, act;
};

struct BwdParams {
  const float* a_ops;
  const float* wT[2][4];  // [layer 0 | shared] x [wxgT (2H, M*Din),
                          // wxcT (H, M*Din), wgT (2H, M*H), wcT (H, M*H)]
  const float* wpT;       // (D, H) = proj_w
  const void* h_prev;     // (T, B, N, L*H) [h0, h_seq[:-1]]
  const void* h_seq;      // (T, B, N, L*H)
  const void* ru;         // (T, B, N, L*2H)
  const void* c;          // (T, B, N, L*H)
  const void* in0;        // (T, B, N, D)
  const void* d_seq;      // (T, B, N, D) cotangent of proj
  const float* force;     // (T,)
  void* dx;               // (T, B, N, D)
  float* dh0;             // (L, B, N, H)
  float* part;            // (B, dec_slab_size) per-clip dW partials
  int T, B, N, D, H, M, L, a_batch, act;
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

struct BwdSmem {
  int a, dh, din, hp, ru, c, x, hf, rf, xf, dyh, dyx, dru, drh, dxa, total;
  __host__ __device__ BwdSmem(int N, int D, int H, int M, int L) {
    const int Dm = D > H ? D : H;
    a = 0;                               // (M-1, N, N) operators
    dh = a + pad4((M - 1) * N * N);      // (L, N, H) state cotangents
    din = dh + pad4(L * N * H);          // (N, D) din0, carried down in t
    hp = din + pad4(N * D);              // (N, H) h_prev; top h at proj
    ru = hp + pad4(N * H);               // (N, 2H) r | u
    c = ru + pad4(N * 2 * H);            // (N, H) dc_pre
    x = c + pad4(N * H);                 // (N, Din) layer input
    hf = x + pad4(N * Dm);               // (N, M*H) A h_prev
    rf = hf + pad4(N * M * H);           // (N, M*H) A (r h_prev)
    xf = rf + pad4(N * M * H);           // (N, M*Din) A in
    dyh = xf + pad4(N * M * Dm);         // (N, M*H) dpre W_h^T
    dyx = dyh + pad4(N * M * H);         // (N, M*Din) dpre W_x^T
    dru = dyx + pad4(N * M * Dm);        // (N, 2H) dru_pre
    drh = dru + pad4(N * 2 * H);         // (N, H) drh
    dxa = drh + pad4(N * H);             // (N, Din) cand part of din;
    total = dxa + pad4(N * Dm);          //   dproj (N, D) at proj
  }
};

// Floats of one clip's dW slab: [layer 0 cell (input width D) | shared
// cell (width H; only when L > 1) | dWp (H, D) | dbp (D)].
__host__ __device__ inline size_t dec_slab_size(int D, int H, int M, int L) {
  return slab_size(D, H, M) + (L > 1 ? slab_size(H, H, M) : 0) +
         (size_t)H * D + D;
}

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
  const int LH = L * H;
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
    const size_t slab = (size_t)t * p.B + b;  // (t, b) row of every stream
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
                rus[(slab * N + n) * (2 * LH) + l * H2 + j] = from_f<S>(v);
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
            const size_t o = (slab * N + n) * LH + l * H + j;
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
    dcgru_dec_bwd_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, D = p.D, H = p.H, M = p.M, L = p.L;
  const BwdSmem sm(N, D, H, M, L);
  float* sA = smem + sm.a;
  float* sdh = smem + sm.dh;
  float* sdin = smem + sm.din;
  float* shp = smem + sm.hp;
  float* sru = smem + sm.ru;
  float* sdc = smem + sm.c;
  float* sx = smem + sm.x;
  float* shf = smem + sm.hf;
  float* srf = smem + sm.rf;
  float* sxf = smem + sm.xf;
  float* sdyh = smem + sm.dyh;
  float* sdyx = smem + sm.dyx;
  float* sdru = smem + sm.dru;
  float* sdrh = smem + sm.drh;
  float* sdxa = smem + sm.dxa;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int NN = N * N, NH = N * H, MH = M * H, H2 = 2 * H;
  const int LH = L * H;
  const int chunks = (N + kRows - 1) / kRows;
  const int tchunks = (N + kTRows - 1) / kTRows;

  // this clip's dW slab: the two cells' blocks, then the projection's
  float* part = p.part + (size_t)b * dec_slab_size(D, H, M, L);
  float* dwp = part + dec_slab_size(D, H, M, L) - (size_t)H * D - D;
  float* dbp = dwp + (size_t)H * D;

  const float* a_clip = p.a_ops + (size_t)(p.a_batch == 1 ? 0 : b) * NN;
  for (int i = tid; i < (M - 1) * NN; i += nthr) {
    int m = i / NN + 1, e = i - (m - 1) * NN;
    sA[i] = a_clip[(size_t)m * p.a_batch * NN + e];
  }
  for (int i = tid; i < L * NH; i += nthr) sdh[i] = 0.0f;
  for (int i = tid; i < N * D; i += nthr) sdin[i] = 0.0f;

  const S* hps = static_cast<const S*>(p.h_prev);
  const S* hs = static_cast<const S*>(p.h_seq);
  const S* rus = static_cast<const S*>(p.ru);
  const S* cs = static_cast<const S*>(p.c);
  const S* in0s = static_cast<const S*>(p.in0);
  const S* ds = static_cast<const S*>(p.d_seq);
  S* dxs = static_cast<S*>(p.dx);
  __syncthreads();

  for (int t = p.T - 1; t >= 0; --t) {
    const bool last = t == p.T - 1;  // the slab's first write
    const size_t slab = (size_t)t * p.B + b;
    const float f = p.force[t];

    // S0: the feedback cotangent splits between x_t and proj_t; the top
    // layer's h_t is the projection's input
    float* sdp = sdxa;  // dproj (N, D) until the layer loop
    for (int i = tid; i < N * D; i += nthr) {
      const size_t o = slab * N * D + i;
      const float din = sdin[i];
      sdp[i] = to_f(ds[o]) + (1.0f - f) * din;
      dxs[o] = from_f<S>(f * din);
    }
    for (int i = tid; i < NH; i += nthr) {
      const int n = i / H, j = i - n * H;
      shp[i] = to_f(hs[(slab * N + n) * LH + (L - 1) * H + j]);
    }
    __syncthreads();

    // S1: dWp += h_top^T dproj, dbp += dproj, dh_{L-1} += dproj Wp^T
    {
      const int n_wp = (H / kWRows) * D;
      const int n_s1 = n_wp + D + H * chunks;
      float* dtop = sdh + (L - 1) * NH;
      for (int task = tid; task < n_s1; task += nthr) {
        int k = task;
        if (k < n_wp) {
          dw_quad(shp, H, (k / D) * kWRows, sdp, D, k % D, N, dwp, D, last);
          continue;
        }
        k -= n_wp;
        if (k < D) {
          db_col(sdp, D, k, N, dbp, last);
          continue;
        }
        k -= D;
        const int chunk = k / H, j = k - chunk * H;
        const int r0 = chunk * kRows;
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
        gemm_col(acc, sdp, D, r0, N, p.wpT + j, H);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r0 + r < N) dtop[(r0 + r) * H + j] += acc[r];
      }
    }
    __syncthreads();

    for (int l = L - 1; l >= 0; --l) {
      const int cell = l == 0 ? 0 : 1;
      const int Din = l == 0 ? D : H, MD = M * Din;
      // layer 0 owns its block; the shared block is first written by the
      // top layer at the last step
      const bool first = last && (l == 0 || l == L - 1);
      const float* wxgT = p.wT[cell][0];
      const float* wxcT = p.wT[cell][1];
      const float* wgT = p.wT[cell][2];
      const float* wcT = p.wT[cell][3];
      float* dwxg = cell == 0 ? part : part + slab_size(D, H, M);
      float* dwxc = dwxg + (size_t)MD * H2;
      float* dwg = dwxc + (size_t)MD * H;
      float* dwc = dwg + (size_t)MH * H2;
      float* dbg = dwc + (size_t)MH * H;
      float* dbc = dbg + H2;
      float* sdhl = sdh + l * NH;

      // P0: residuals in; g (dh_l, the cotangent from above already
      // added), du, dc_pre
      for (int i = tid; i < NH; i += nthr) {
        const int n = i / H, j = i - n * H;
        const size_t o = (slab * N + n) * LH + l * H + j;
        const size_t oru = (slab * N + n) * (2 * LH) + l * H2 + j;
        const float hp = to_f(hps[o]);
        const float r = to_f(rus[oru]);
        const float u = to_f(rus[oru + H]);
        const float c = to_f(cs[o]);
        const float g = sdhl[i];
        shp[i] = hp;
        sru[n * H2 + j] = r;
        sru[n * H2 + H + j] = u;
        sdc[i] = g * (1.0f - u) * act_grad(c, p.act);
        sdru[n * H2 + H + j] = g * (hp - c) * u * (1.0f - u);
      }
      if (l == 0) {
        for (int i = tid; i < N * D; i += nthr)
          sx[i] = to_f(in0s[slab * N * D + i]);
      } else {
        for (int i = tid; i < NH; i += nthr) {
          const int n = i / H, j = i - n * H;
          sx[i] = to_f(hs[(slab * N + n) * LH + (l - 1) * H + j]);
        }
      }
      __syncthreads();

      // P1: recompute the diffusions [h_prev | r h_prev | in]
      const int fcols = 2 * H + Din;
      for (int task = tid; task < M * fcols; task += nthr) {
        const int m = task / fcols, cc = task - m * fcols;
        float v[kMaxNodes];
        if (cc < H) {
#pragma unroll
          for (int k = 0; k < kMaxNodes; ++k)
            if (k < N) v[k] = shp[k * H + cc];
          diffuse_col(v, sA, N, m, shf + m * H + cc, MH);
        } else if (cc < H2) {
          const int j = cc - H;
#pragma unroll
          for (int k = 0; k < kMaxNodes; ++k)
            if (k < N) v[k] = sru[k * H2 + j] * shp[k * H + j];
          diffuse_col(v, sA, N, m, srf + m * H + j, MH);
        } else {
          const int j = cc - H2;
#pragma unroll
          for (int k = 0; k < kMaxNodes; ++k)
            if (k < N) v[k] = sx[k * Din + j];
          diffuse_col(v, sA, N, m, sxf + m * Din + j, MD);
        }
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

      // P3: A^T applies: drh (and the gate half of dru_pre), and the
      // candidate part of the input cotangent
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
              sdrh[n * H + cc] = acc[i];
              sdru[n * H2 + cc] = acc[i] * shp[n * H + cc] * r * (1.0f - r);
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

      // P4: gate weight-transpose products dru_pre [Wg | Wxg]^T, and every
      // dW / db accumulation of the step (independent of each other)
      const int q_x = MD / kWRows, q_h = MH / kWRows;
      const int n_dw[6] = {q_x * H2, q_x * H, q_h * H2, q_h * H, H2, H};
      const int n_p4 =
          n_wt + n_dw[0] + n_dw[1] + n_dw[2] + n_dw[3] + n_dw[4] + n_dw[5];
      for (int task = tid; task < n_p4; task += nthr) {
        int k = task;
        if (k < n_wt) {
          const int chunk = k / (MH + MD), j = k - chunk * (MH + MD);
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
          continue;
        }
        k -= n_wt;
        if (k < n_dw[0]) {  // dWxg += (A in)^T dru_pre
          dw_quad(sxf, MD, (k / H2) * kWRows, sdru, H2, k % H2, N, dwxg, H2,
                  first);
          continue;
        }
        k -= n_dw[0];
        if (k < n_dw[1]) {  // dWxc += (A in)^T dc_pre
          dw_quad(sxf, MD, (k / H) * kWRows, sdc, H, k % H, N, dwxc, H,
                  first);
          continue;
        }
        k -= n_dw[1];
        if (k < n_dw[2]) {  // dWg += (A h_prev)^T dru_pre
          dw_quad(shf, MH, (k / H2) * kWRows, sdru, H2, k % H2, N, dwg, H2,
                  first);
          continue;
        }
        k -= n_dw[2];
        if (k < n_dw[3]) {  // dWc += (A r h_prev)^T dc_pre
          dw_quad(srf, MH, (k / H) * kWRows, sdc, H, k % H, N, dwc, H,
                  first);
          continue;
        }
        k -= n_dw[3];
        if (k < n_dw[4]) {
          db_col(sdru, H2, k, N, dbg, first);
          continue;
        }
        db_col(sdc, H, k - n_dw[4], N, dbc, first);
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
int launch_bwd(const BwdParams& p, cudaStream_t stream) {
  if (!valid_shape(p.T, p.B, p.N, p.D, p.H, p.M, p.L))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)BwdSmem(p.N, p.D, p.H, p.M, p.L).total * sizeof(float);
  auto kern = dcgru_dec_bwd_kernel<S>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<p.B, kMaxThreads, smem, stream>>>(p);
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

// Weights arrive transposed (see BwdParams). part: B * dec_slab_size
// floats of scratch, written before read.
int dcgru_decoder_bwd(const float* a_ops, int a_batch, const float* wx0gT,
                      const float* wx0cT, const float* wh0gT,
                      const float* wh0cT, const float* wxsgT,
                      const float* wxscT, const float* whsgT,
                      const float* whscT, const float* wpT,
                      const void* h_prev, const void* h_seq, const void* ru,
                      const void* c, const void* in0, const void* d_seq,
                      const float* force, void* dx, float* dh0, float* part,
                      int T, int B, int N, int D, int H, int M, int L,
                      int act, int bf16, void* stream) {
  BwdParams p{a_ops,
              {{wx0gT, wx0cT, wh0gT, wh0cT}, {wxsgT, wxscT, whsgT, whscT}},
              wpT,
              h_prev,
              h_seq,
              ru,
              c,
              in0,
              d_seq,
              force,
              dx,
              dh0,
              part,
              T, B, N, D, H, M, L, a_batch, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(p, s) : launch_bwd<float>(p, s);
}

const char* dcgru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
