// Fused diffusion convolution, forward, on the tensor cores of NVIDIA Hopper
// (sm_90a).
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
// per step and layer, on the hidden state (gate, O = 2H) and on r*h
// (candidate, O = H). Its gradient is the autograd of the plain diffusion
// conv (the JAX package has no backward kernel for it either).
//
// What bounds it on an H100. At the loop's shapes (B=128, N=19, D=H=64,
// O=128 or 64, M=3 or 5) one launch does 0.07-0.23 GFLOP of products and
// moves 1-2 MB: ~1 us at the 3xTF32 tensor-core rate or the HBM rate
// (chip_smoke.py's fdc_work). The first port took ~25 us a launch: one
// thread an output column on FMA, the whole (M*D, O) weight read from L2
// by every clip's block, ten rows of reuse.
//
// Design.
// - Products on the tensor cores in 3xTF32 (hi*hi + hi*lo + lo*hi, each
//   operand split as in split_tf32, which keeps a NaN), f32 sums: ~f32.
//   The output is computed transposed, out^T (O x N) = W^T (O x M*D) F^T,
//   so the weight is the mma's A operand (16-row tiles of O) and a clip's
//   19 node rows the B operand (8-node tiles, 19 -> 24 rows).
// - The operands are staged by the wrapper once a weight version, not
//   once a launch (ops/cuda_kernels.py, stage_fdc_operands; the
//   use_pallas loop stages each layer's once a forward and hands them to
//   its 120 launches): W^T as f32 A fragments (split as read), the
//   per-clip supports as A fragments already split into TF32 hi and lo.
// - The weight is read from L2 once an SM: a persistent grid of at most
//   kSms blocks walks the clips (one clip a block at B <= 132), and a
//   block copies the weight fragments into shared memory once, by
//   cp.async, while its first clip's Chebyshev terms run (from L2 where
//   they do not fit). fdc_plan records the plan per shape.
// - A block holds its clip's terms [T_0 | T_1 | ...] as f32 rows (N x M*D,
//   rows past N zero) in shared memory. Each term is one tensor-core apply
//   of a support (a warp an (16-node, 8-column) tile), the 2 A T - T of
//   the later terms in its epilogue; a barrier between terms. The bias
//   is staged beside them once a block.
// - The product: a warp owns a 16-row tile of O and a range of the M*D
//   depth (ksplit warps a tile, so a block has up to 16 warps), all node
//   tiles at once (one A fragment read feeds every node tile; their count
//   a template parameter), the three products of 3xTF32 in three
//   accumulators (independent mma chains: the probe, loop_probe.py --only
//   fdc, found a launch mostly in products that waited on one another),
//   and the tensor-core partials flushed into f32 sums every 8 k tiles. The
//   ksplit partials meet in shared memory and are added in a fixed order
//   with the bias; the store is coalesced. No atomics: the same bits on
//   every run.

#include "dcgru_common.cuh"

namespace {

using namespace dcgru;

constexpr int kSms = 132;          // blocks of the persistent grid at most:
                                   // the H100's SMs, a constant
constexpr int kMaxWarps = 16;
constexpr int kMaxSmem = 232448;   // shared bytes a block may have

struct Params {
  const uint4* sup;   // (B, S, RT, KT, hi|lo, 32) A fragments, split
  const float* x;     // (B, N, D)
  const uint4* w;     // (ORT, WKT, 32) W^T A fragments, f32
  const float* bias;  // (O)
  float* out;         // (B, N, O)
  int S, B, N, D, O, K, M;
  int ksplit;         // warps a 16-row tile of O
  int wsmem;          // the weight fragments are copied to shared memory
};

// Byte offsets of a block's shared memory: the weight fragments (when
// they fit), the clip's support fragments, its term rows F (8*KT rows, a
// row stride of 4 mod 32 words: conflict-free B reads), the ksplit
// partial outputs (N rows of ldo words each, 4 mod 32: conflict-free
// fragment stores), the bias.
struct Layout {
  int rt, kt, ort, wkt, ldf, ldo, supw;
  int w, sup, f, o, bias, total;
  __host__ __device__ Layout(int S, int N, int D, int O, int M, int ksplit,
                             bool wsmem) {
    rt = (N + 15) / 16;
    kt = (N + 7) / 8;
    ort = (O + 15) / 16;
    wkt = (M * D + 7) / 8;
    ldf = ((M * D + 7) & ~7) + 4;
    ldo = ((O + 31) & ~31) + 4;
    supw = S * rt * kt * 64;  // 16-byte words of a clip's supports
    w = 0;
    sup = w + (wsmem ? ort * wkt * 512 : 0);
    f = sup + supw * 16;
    o = f + align16(8 * kt * ldf * 4);
    bias = o + align16(ksplit * N * ldo * 4);
    total = bias + align16(O * 4);
  }
};

// WSMEM: the weight fragments sit in shared memory (else read from L2);
// NT: the 8-node tiles of a clip, ceil(N / 8)
template <bool WSMEM, int NT>
__global__ void __launch_bounds__(32 * kMaxWarps) fdc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, D = p.D, O = p.O;
  const Layout L(p.S, N, D, O, p.M, p.ksplit, WSMEM);
  uint4* sw = reinterpret_cast<uint4*>(smem + L.w);
  uint4* ssup = reinterpret_cast<uint4*>(smem + L.sup);
  float* sf = reinterpret_cast<float*>(smem + L.f);
  float* so = reinterpret_cast<float*>(smem + L.o);
  float* sbias = reinterpret_cast<float*>(smem + L.bias);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nwarps = blockDim.x >> 5;
  const uint4* wa = WSMEM ? sw : p.w;
  DCGRU_PROBE_START;

  // F's rows past N and columns past M*D stay zero: the applies read
  // rows up to 8*KT (a NaN there would reach every node through A's zero
  // columns) and the product columns up to 8*WKT
  for (int i = threadIdx.x; i < (L.o - L.f) / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(sf)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < O; i += blockDim.x) sbias[i] = p.bias[i];
  __syncthreads();

  bool first = true;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    // the clip's x as T_0 and its supports, then (once) the weights, which
    // arrive while the first clip's terms are made
    cp_rows(sf, L.ldf, p.x + (size_t)b * N * D, N, D);
    cp_block(ssup, p.sup + (size_t)b * L.supw, L.supw * 16);
    cp_commit();
    if (first && WSMEM) {
      cp_block(sw, p.w, L.ort * L.wkt * 512);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    DCGRU_PROBE_MARK(0);

    // the Chebyshev terms, i0 (the reference's x0) carried across supports:
    // term dst = A_s T_src (- T_sub, doubled, for the later ones), a warp
    // a (16-node, 8-column) tile, the support's split fragments as A and
    // T_src split as read, the small products apart from hi*hi
    const int CT = (D + 7) / 8;
    auto term = [&](int s, int dst, int src, int sub) {
      for (int task = warp; task < L.rt * CT; task += nwarps) {
        const int rt = task / CT, ct = task - rt * CT;
        const uint4* fa = ssup + (size_t)(s * L.rt + rt) * L.kt * 64 + lane;
        const float* sc = sf + src * D + 8 * ct + g;
        float big[4] = {}, small[4] = {};
#pragma unroll
        for (int kt = 0; kt < kChainNTiles; ++kt)
          if (kt < L.kt) {
            const uint4 h = fa[64 * kt], l = fa[64 * kt + 32];
            const uint32_t hi[4] = {h.x, h.y, h.z, h.w};
            const uint32_t lo[4] = {l.x, l.y, l.z, l.w};
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(sc[(8 * kt + t) * L.ldf], bh0, bl0);
            split_tf32(sc[(8 * kt + t + 4) * L.ldf], bh1, bl1);
            mma_tf32_r(small, lo, bh0, bh1);
            mma_tf32_r(small, hi, bl0, bl1);
            mma_tf32_r(big, hi, bh0, bh1);
          }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 16 * rt + g + 8 * (e >> 1);
          const int c = 8 * ct + 2 * t + (e & 1);
          if (n < N && c < D) {
            float v = big[e] + small[e];
            if (sub >= 0) v = 2.0f * v - sf[n * L.ldf + sub * D + c];
            sf[n * L.ldf + dst * D + c] = v;
          }
        }
      }
      __syncthreads();
    };
    int i0 = 0, mi = 1;
    for (int s = 0; s < p.S && p.K > 0; ++s) {
      term(s, mi, i0, -1);
      int i1 = mi++;
      for (int k = 2; k <= p.K; ++k) {
        term(s, mi, i1, i0);
        i0 = i1;
        i1 = mi++;
      }
    }
    DCGRU_PROBE_MARK(1);
    if (first && WSMEM) {
      cp_wait<0>();
      __syncthreads();
      DCGRU_PROBE_MARK(0);
    }
    first = false;

    // out^T = W^T F^T: warp (rt, ks) over the k tiles [k0, k1), the three
    // products of a tile in three accumulators (independent chains), the
    // tensor-core partials flushed into f32 sums every 8 k tiles
    for (int task = warp; task < L.ort * p.ksplit; task += nwarps) {
      const int rt = task / p.ksplit, ks = task - rt * p.ksplit;
      const int k0 = ks * L.wkt / p.ksplit, k1 = (ks + 1) * L.wkt / p.ksplit;
      const uint4* a = wa + (size_t)rt * L.wkt * 32 + lane;
      const float* bf = sf + g * L.ldf + t;
      float lh[NT][4] = {}, hl[NT][4] = {}, hh[NT][4] = {}, sum[NT][4] = {};
      for (int k8 = k0; k8 < k1; k8 += 8) {
        const int k8e = min(k8 + 8, k1);
#pragma unroll 4
        for (int k = k8; k < k8e; ++k) {
          const uint4 wv = a[32 * k];
          uint32_t hi[4], lo[4];
          split_tf32(__uint_as_float(wv.x), hi[0], lo[0]);
          split_tf32(__uint_as_float(wv.y), hi[1], lo[1]);
          split_tf32(__uint_as_float(wv.z), hi[2], lo[2]);
          split_tf32(__uint_as_float(wv.w), hi[3], lo[3]);
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            const float* bi = bf + i * 8 * L.ldf + 8 * k;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(bi[0], bh0, bl0);
            split_tf32(bi[4], bh1, bl1);
            mma_tf32_r(lh[i], lo, bh0, bh1);
            mma_tf32_r(hl[i], hi, bl0, bl1);
            mma_tf32_r(hh[i], hi, bh0, bh1);
          }
        }
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[i][e] += hh[i][e] + (lh[i][e] + hl[i][e]);
            lh[i][e] = hl[i][e] = hh[i][e] = 0.0f;
          }
      }
      // this warp's partial: row o of out^T, node n -> so[ks][n][o]
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = 16 * rt + g + 8 * (e >> 1);
          const int n = 8 * i + 2 * t + (e & 1);
          if (o < O && n < N) so[(ks * N + n) * L.ldo + o] = sum[i][e];
        }
    }
    __syncthreads();
    DCGRU_PROBE_MARK(2);

    // the partials in order, the bias; coalesced stores
    float* ob = p.out + (size_t)b * N * O;
#pragma unroll 4
    for (int i = threadIdx.x; i < N * O; i += blockDim.x) {
      const int n = i / O, o = i - n * O;
      float v = so[n * L.ldo + o];
      for (int ks = 1; ks < p.ksplit; ++ks) v += so[(ks * N + n) * L.ldo + o];
      ob[i] = v + sbias[o];
    }
    __syncthreads();  // F and the partials are free for the next clip
    DCGRU_PROBE_MARK(3);
  }
  DCGRU_PROBE_STORE;
}

// The plan of a shape: the weight fragments in shared memory where they
// fit beside the rest with one warp a row tile, else read from L2; then
// ksplit 4, 2 or 1, the most that keeps the block at kMaxWarps warps, a
// split at least 4 k tiles deep, and the shared memory within the card's.
// Shared bytes, or -1 where nothing fits.
int fdc_plan(Params& p) {
  const int ort = (p.O + 15) / 16, wkt = (p.M * p.D + 7) / 8;
  p.wsmem = Layout(p.S, p.N, p.D, p.O, p.M, 1, true).total <= kMaxSmem;
  for (int ks = 4; ks >= 1; ks /= 2) {
    const int bytes = Layout(p.S, p.N, p.D, p.O, p.M, ks, p.wsmem).total;
    if (ks == 1 || (ort * ks <= kMaxWarps && 4 * ks <= wkt &&
                    bytes <= kMaxSmem)) {
      p.ksplit = ks;
      return bytes <= kMaxSmem ? bytes : -1;
    }
  }
  return -1;
}

int fdc_warps(const Params& p) {
  const int ort = (p.O + 15) / 16;
  return max(4, min(kMaxWarps, ort * p.ksplit));
}

bool fdc_valid(const Params& p) {
  return p.N >= 1 && p.N <= kMaxNodes && p.D >= 4 && p.D % 4 == 0 &&
         p.O >= 1 && p.B >= 1 && p.S >= 0 && p.K >= 0 &&
         p.M == p.S * p.K + 1;
}

}  // namespace

extern "C" {

// out (B, N, O) f32. sup: the per-clip supports as TF32-split A fragments
// (ops/cuda_kernels.py fdc_support_frags); x (B, N, D) f32; w: W^T
// (O x M*D) as f32 A fragments (fdc_weight_frags); bias (O).
// Returns a cudaError_t: 0 on a launch that was accepted.
int fused_diffusion_conv_fwd(const void* sup, const float* x, const void* w,
                             const float* bias, float* out, int S, int B,
                             int N, int D, int O, int K, int M,
                             void* stream) {
  Params p{static_cast<const uint4*>(sup), x, static_cast<const uint4*>(w),
           bias, out, S, B, N, D, O, K, M, 1, 0};
  if (!fdc_valid(p)) return (int)cudaErrorInvalidValue;
  const int smem = fdc_plan(p);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  using Kern = void (*)(const Params);
  static const Kern kerns[2][4] = {
      {fdc_kernel<false, 1>, fdc_kernel<false, 2>, fdc_kernel<false, 3>,
       fdc_kernel<false, 4>},
      {fdc_kernel<true, 1>, fdc_kernel<true, 2>, fdc_kernel<true, 3>,
       fdc_kernel<true, 4>}};
  // once a process: every plan's shared memory is within kMaxSmem
  static const cudaError_t attr = [] {
    for (const auto& row : kerns)
      for (Kern k : row) {
        const cudaError_t e = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
        if (e != cudaSuccess) return e;
      }
    return cudaSuccess;
  }();
  if (attr != cudaSuccess) return (int)attr;
  kerns[p.wsmem][(N + 7) / 8 - 1]<<<min(B, kSms), 32 * fdc_warps(p), smem,
                                     static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The plan of a shape: blocks, threads a block, shared bytes a block,
// ksplit, weights in shared memory (1) or read from L2 (0).
int fdc_plan_of(int S, int B, int N, int D, int O, int K, int M, int* out) {
  Params p{nullptr, nullptr, nullptr, nullptr, nullptr, S, B, N, D, O, K, M,
           1, 0};
  if (!fdc_valid(p)) return (int)cudaErrorInvalidValue;
  const int smem = fdc_plan(p);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const int v[] = {min(B, kSms), 32 * fdc_warps(p), smem, p.ksplit, p.wsmem};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
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

const char* fdc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
