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
// reused 128 times: bound by operations, at the card's 67 TFLOP/s
// non-tensor f32 rate (no TF32: the scores feed a top-k that is sensitive
// to near-ties, so the JAX package asks for full f32 precision too).
//
// Design (simple and right first).
// - One thread block per 64x64 quarter of an occupied block, so the 96
//   occupied blocks of a banded 4096-node montage give 384 thread blocks,
//   about three per SM, instead of 96 on 132 SMs.
// - Each thread block reads its block coordinates from device memory (the
//   TPU's scalar prefetch), then runs a shared-memory-tiled f32 FMA GEMM
//   over D: 16-wide K slices of the two 64-row slabs, stored k-major in
//   shared memory, and a 4x4 register tile of outputs per thread.
// - Rows or columns past N (and coordinates out of range) load as zeros,
//   so their outputs are 0 and no read leaves the inputs.
// wgmma does no f32 (only TF32), so a faster version would deepen the
// register tile and double-buffer the slices; that is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output rows and columns per thread block
constexpr int kBK = 16;       // K slice per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

struct Params {
  const float* x;     // (N, D)
  const float* y;     // (N, D)
  const int* brow;    // (nnzb,)
  const int* bcol;    // (nnzb,)
  float* out;         // (nnzb, block, block)
  int N, D, block;
};

// 4 consecutive values of one row from column k on; zeros past the row's
// end or for a row that is not there
__device__ __forceinline__ float4 load4(const float* row, bool valid, int k,
                                        int D, bool vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!valid) return v;
  if (vec) {
    if (k < D) v = __ldg(reinterpret_cast<const float4*>(row + k));
    return v;
  }
  if (k < D) v.x = __ldg(row + k);
  if (k + 1 < D) v.y = __ldg(row + k + 1);
  if (k + 2 < D) v.z = __ldg(row + k + 2);
  if (k + 3 < D) v.w = __ldg(row + k + 3);
  return v;
}

__global__ void __launch_bounds__(kThreads) sddmm_kernel(Params p) {
  __shared__ __align__(16) float sX[kBK][kTile + 4];
  __shared__ __align__(16) float sY[kBK][kTile + 4];
  const int tiles = p.block / kTile;
  const int per = tiles * tiles;
  const int blk = blockIdx.x / per, q = blockIdx.x - blk * per;
  const int qr = q / tiles, qc = q - qr * tiles;
  const long long row0 = (long long)p.brow[blk] * p.block + qr * kTile;
  const long long col0 = (long long)p.bcol[blk] * p.block + qc * kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // loader: thread -> (slab row lr, 4 columns from lk)
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  const long long xr = row0 + lr, yr = col0 + lr;
  const bool xv = xr >= 0 && xr < p.N, yv = yr >= 0 && yr < p.N;
  const float* xrow = p.x + (xv ? xr : 0) * (long long)p.D;
  const float* yrow = p.y + (yv ? yr : 0) * (long long)p.D;
  const bool vec = (p.D % 4) == 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < p.D; k0 += kBK) {
    const float4 a = load4(xrow, xv, k0 + lk, p.D, vec);
    const float4 c = load4(yrow, yv, k0 + lk, p.D, vec);
    sX[lk][lr] = a.x; sX[lk + 1][lr] = a.y;
    sX[lk + 2][lr] = a.z; sX[lk + 3][lr] = a.w;
    sY[lk][lr] = c.x; sY[lk + 1][lr] = c.y;
    sY[lk + 2][lr] = c.z; sY[lk + 3][lr] = c.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 u = *reinterpret_cast<const float4*>(&sX[k][ty * 4]);
      const float4 v = *reinterpret_cast<const float4*>(&sY[k][tx * 4]);
      const float uu[4] = {u.x, u.y, u.z, u.w};
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(uu[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* o = p.out + (size_t)blk * p.block * p.block;
  const int c = qc * kTile + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = qr * kTile + ty * 4 + i;
    *reinterpret_cast<float4*>(o + (size_t)r * p.block + c) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace

extern "C" {

// block: a positive multiple of 64. Returns a cudaError_t: 0 on a launch
// that was accepted.
int sddmm_blocksparse(const float* x, const float* y, const int* brow,
                      const int* bcol, float* out, int N, int D, int nnzb,
                      int block, void* stream) {
  if (N < 1 || D < 0 || nnzb < 1 || block < kTile || block % kTile)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)nnzb * (block / kTile) * (block / kTile);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Params p{x, y, brow, bcol, out, N, D, block};
  sddmm_kernel<<<(unsigned)grid, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* sddmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
