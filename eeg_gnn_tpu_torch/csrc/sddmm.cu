// Block-sparse SDDMM for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _sddmm_block_kernel of
// eeg_gnn_tpu/ops/sddmm.py (:104, launched from sddmm_blocksparse
// :112/:146; front door sddmm_edges_blocksparse :155): the dense
// (block, block) tiles of X Y^T at the occupied block coordinates only,
//   out[i, r, c] = sum_d x[br_i*block + r, d] * y[bc_i*block + c, d],
// with rows or columns >= N written as 0, which is what the TPU kernel
// gives on its zero-padded inputs (sddmm.py:128-134). It has no gradient.
// Its caller is the correlation re-score of a fixed graph on a large
// montage (benchmarks/graph_build_bench.py:109-128, D=6000).
//
// What bounds it on an H100. Each occupied 128x128 block at D=6000 is a
// 197-MFLOP product whose inputs (two 128 x 6000 row slabs, 6 MB) are
// reused 128 times: bound by operations. The scores feed a top-k that is
// sensitive to near-ties, so the JAX package asks for full f32 precision:
// the products run on the TF32 tensor cores as 3xTF32 (x = hi + lo, each
// a TF32; hi*hi + hi*lo + lo*hi), ~f32 accuracy at a third of the 495
// TFLOP/s TF32 rate, 165 TFLOP/s, against 67 for f32 FMA.
//
// Design.
// - A thread block computes a BM x BM tile of an occupied block: BM = 128
//   (8 warps, each a 64 x 32 register tile) when the occupied blocks fill
//   the card's SMs at one block each, else BM = 64 (4 warps of 32 x 32,
//   the four quarters of a block), so the 96 occupied blocks of a banded
//   4096-node montage still give 384 thread blocks. The larger tile reads
//   each input slab half as often (at top-k occupancy 64-wide tiles read
//   12.6 GB through L2 for a 98 MB input) and splits each fragment for
//   twice the products. Each output's sum runs the same
//   instructions in the same order under either tile: the choice does not
//   change a bit of the result. Each block reads its block coordinates
//   from device memory (the TPU's scalar prefetch).
// - 32-wide K slices of the two row slabs arrive by cp.async into a
//   three-stage ring in shared memory (rows padded to 36 floats, so the
//   fragment reads hit 32 distinct banks); two slices load while one is
//   multiplied. D a multiple of 4 copies 16 bytes at a time, any other D
//   one float at a time.
// - Per 8-wide k step a warp splits its A and B fragments into hi / lo
//   (hi by integer rounding, lo the unrounded rest, so a NaN input stays
//   NaN; dcgru_common.cuh) and issues 3 mma.sync.m16n8k8 per 16 x 8
//   output tile.
// - D=6000 is a long reduction, and the tensor cores do not round their
//   f32 adds to nearest: each 32-wide slice's partial is added into an f32
//   register sum (flush, dcgru_common.cuh), so the result is a sum of
//   ~190 ordinary f32 adds. Fixed order, no atomics: deterministic.
// - Rows or columns past N (and coordinates out of range) load as zeros,
//   so their outputs are 0 and no read leaves the inputs.
// wgmma with TMA is later work.

#include "dcgru_common.cuh"

namespace {

using dcgru::cp_commit;
using dcgru::cp_quad;
using dcgru::cp_wait;
using dcgru::cp_word;
using dcgru::flush;
using dcgru::mma_tf32;
using dcgru::split_tf32;

constexpr int kBK = 32;       // K per cp.async stage
constexpr int kLd = kBK + 4;  // padded shared-memory row
constexpr int kStages = 3;

struct Params {
  const float* x;     // (N, D)
  const float* y;     // (N, D)
  const int* brow;    // (nnzb,)
  const int* bcol;    // (nnzb,)
  float* out;         // (nnzb, block, block)
  int N, D, block;
};

// A BM x BM output tile: 2 x (BM / 32) warps, each (BM / 2) x 32.
template <int BM>
struct Tile {
  static constexpr int kWarpsN = BM / 32;
  static constexpr int kThreads = 64 * kWarpsN;
  static constexpr int kWM = BM / 2;       // warp tile rows
  static constexpr int kMI = kWM / 16;     // 16-row A fragments per warp
  static constexpr int kNI = 4;            // 8-column B fragments per warp
  static constexpr int kStage = 2 * BM * kLd;  // floats: X and Y slices
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
};

// Columns [k0, k0 + kBK) of the BM rows from row0 of src (N, D) into
// s (BM, kLd); rows >= N (or < 0) and columns >= D are zero-filled.
template <int BM, bool VEC>
__device__ __forceinline__ void load_slab(float* s, const float* src,
                                          long long row0, int N, int D,
                                          int k0) {
  constexpr int kThreads = Tile<BM>::kThreads;
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < BM * kBK / 4; i += kThreads) {
      const int r = i / (kBK / 4), c = 4 * (i - r * (kBK / 4));
      const long long row = row0 + r;
      const bool ok = row >= 0 && row < N && k0 + c < D;
      cp_quad(s + r * kLd + c, ok ? src + row * D + k0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, c = i - r * kBK;
      const long long row = row0 + r;
      const bool ok = row >= 0 && row < N && k0 + c < D;
      cp_word(s + r * kLd + c, ok ? src + row * D + k0 + c : src, ok);
    }
  }
}

template <int BM, bool VEC>
__global__ void __launch_bounds__(Tile<BM>::kThreads) sddmm_kernel(Params p) {
  using T = Tile<BM>;
  constexpr int MI = T::kMI, NI = T::kNI;
  extern __shared__ __align__(16) float smem[];
  const int tiles = p.block / BM;
  const int per = tiles * tiles;
  const int blk = blockIdx.x / per, q = blockIdx.x - blk * per;
  const int qr = q / tiles, qc = q - qr * tiles;
  const long long row0 = (long long)p.brow[blk] * p.block + qr * BM;
  const long long col0 = (long long)p.bcol[blk] * p.block + qc * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / T::kWarpsN, wc = warp - wr * T::kWarpsN;
  const int g = lane >> 2, t = lane & 3;

  auto issue = [&](int kc) {
    float* st = smem + (kc % kStages) * T::kStage;
    load_slab<BM, VEC>(st, p.x, row0, p.N, p.D, kc * kBK);
    load_slab<BM, VEC>(st + BM * kLd, p.y, col0, p.N, p.D, kc * kBK);
  };

  // tile j = NI mi + ni: rows kWM wr + 16 mi, columns 32 wc + 8 ni
  float acc[MI * NI][4] = {}, sum[MI * NI][4] = {};
  const int nk = (p.D + kBK - 1) / kBK;
  for (int kc = 0; kc < kStages - 1; ++kc) {
    if (kc < nk) issue(kc);
    cp_commit();  // an empty group past the end keeps the count uniform
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait<kStages - 2>();  // slice kc has landed
    __syncthreads();         // and every warp is done with slice kc - 1
    if (kc + kStages - 1 < nk) issue(kc + kStages - 1);
    cp_commit();
    const float* st = smem + (kc % kStages) * T::kStage;
    const float* xs = st + (T::kWM * wr + g) * kLd + t;
    const float* ys = st + BM * kLd + (32 * wc + g) * kLd + t;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t bh[NI][2], bl[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const float* b = ys + 8 * ni * kLd + kk;
        split_tf32(b[0], bh[ni][0], bl[ni][0]);
        split_tf32(b[4], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float* a = xs + 16 * mi * kLd + kk;
        uint32_t ah[4], al[4];
        split_tf32(a[0], ah[0], al[0]);
        split_tf32(a[8 * kLd], ah[1], al[1]);
        split_tf32(a[4], ah[2], al[2]);
        split_tf32(a[8 * kLd + 4], ah[3], al[3]);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          float(&d)[4] = acc[NI * mi + ni];
          mma_tf32(d, al, bh[ni][0], bh[ni][1]);
          mma_tf32(d, ah, bl[ni][0], bl[ni][1]);
          mma_tf32(d, ah, bh[ni][0], bh[ni][1]);
        }
      }
    }
    flush(sum, acc);
  }

  float* o = p.out + (size_t)blk * p.block * p.block;
#pragma unroll
  for (int j = 0; j < MI * NI; ++j) {
    const int r = qr * BM + T::kWM * wr + 16 * (j / NI) + g;
    const int c = qc * BM + 32 * wc + 8 * (j % NI) + 2 * t;
    *reinterpret_cast<float2*>(o + (size_t)r * p.block + c) =
        make_float2(sum[j][0], sum[j][1]);
    *reinterpret_cast<float2*>(o + (size_t)(r + 8) * p.block + c) =
        make_float2(sum[j][2], sum[j][3]);
  }
}

template <int BM, bool VEC>
int launch(const Params& p, int nnzb, cudaStream_t stream) {
  const long long grid = (long long)nnzb * (p.block / BM) * (p.block / BM);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kern = sddmm_kernel<BM, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile<BM>::kSmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)grid, Tile<BM>::kThreads, Tile<BM>::kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_tile(const Params& p, int nnzb, cudaStream_t stream) {
  return p.D % 4 == 0 ? launch<BM, true>(p, nnzb, stream)
                      : launch<BM, false>(p, nnzb, stream);
}

}  // namespace

extern "C" {

// block: a positive multiple of 64. Returns a cudaError_t: 0 on a launch
// that was accepted.
int sddmm_blocksparse(const float* x, const float* y, const int* brow,
                      const int* bcol, float* out, int N, int D, int nnzb,
                      int block, void* stream) {
  if (N < 1 || D < 0 || nnzb < 1 || block < 64 || block % 64)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  Params p{x, y, brow, bcol, out, N, D, block};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long big = (long long)nnzb * (block / 128) * (block / 128);
  if (block % 128 == 0 && big >= sms) return launch_tile<128>(p, nnzb, s);
  return launch_tile<64>(p, nnzb, s);
}

const char* sddmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
