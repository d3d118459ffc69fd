// The deterministic weight-gradient pass of the training kernels' backwards
// (csrc/two_cell.cu, csrc/lstm_seq.cu, csrc/vae_dense.cu), for Hopper (sm_90a).
//
// Each job is C[M, N] = sum over rows r of A[r, :M]^T Bm[r, :N] (A null: a
// column of ones, M = 1, i.e. the column sums of Bm). Up to kMaxJobs jobs run
// in one launch, each cut into kTile x kTile tiles of C, one block a tile.
// The TPU kernels accumulated these sums in resident blocks over a
// sequential grid; on this card concurrent blocks would need atomics, whose
// order changes from run to run. Here one thread sums each output element
// over the rows in a fixed order, so the result is deterministic.
//
// The kernel is a template on a tag type so that each source's copy carries
// its own name (`wgrad_kernel<two_cell_wgrad>` and so on), which a profiler's
// kernel table shows beside the source's other kernels.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace cvl {

constexpr int kWgTile = 64;      // C tile is kWgTile x kWgTile
constexpr int kWgChunk = 16;     // rows per shared-memory stage
constexpr int kWgThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kWgMaxJobs = 15;

struct WgradJob {
  const float* A;   // [R, M] (lda = M); null: a column of ones (M = 1)
  const float* Bm;  // [R, N]
  float* C;         // [M, N]
  int M, N;
};

struct WgradTile {
  WgradJob job;
  int tiles_n, first_block;
};

struct WgradArgs {
  WgradTile jobs[kWgMaxJobs];
  int njobs, R;
};

template <typename Tag>
__global__ void __launch_bounds__(kWgThreads) wgrad_kernel(const WgradArgs args) {
  __shared__ __align__(16) float As[kWgChunk][kWgTile];
  __shared__ __align__(16) float Bs[kWgChunk][kWgTile];
  int j = 0;
  while (j + 1 < args.njobs && (int)blockIdx.x >= args.jobs[j + 1].first_block) ++j;
  const WgradJob jb = args.jobs[j].job;
  const int local = blockIdx.x - args.jobs[j].first_block;
  const int tiles_n = args.jobs[j].tiles_n;
  const int m0 = (local / tiles_n) * kWgTile, n0 = (local % tiles_n) * kWgTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  for (int r0 = 0; r0 < args.R; r0 += kWgChunk) {
    for (int i = threadIdx.x; i < kWgChunk * kWgTile; i += kWgThreads) {
      const int rr = i / kWgTile, c = i - rr * kWgTile, r = r0 + rr;
      const int m = m0 + c, n = n0 + c;
      As[rr][c] = (r < args.R && m < jb.M) ? (jb.A ? jb.A[(size_t)r * jb.M + m] : 1.f) : 0.f;
      Bs[rr][c] = (r < args.R && n < jb.N) ? jb.Bm[(size_t)r * jb.N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kWgChunk; ++rr) {
      const float4 av = *reinterpret_cast<const float4*>(&As[rr][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[rr][tx * 4]);
      const float am[4] = {av.x, av.y, av.z, av.w};
      const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(am[i], bn[q], acc[i][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (m < jb.M && n < jb.N) jb.C[(size_t)m * jb.N + n] = acc[i][q];
    }
  }
}

// The njobs (<= kWgMaxJobs) jobs over R rows in one launch on `stream`;
// returns the cudaError_t of the launch.
template <typename Tag>
int launch_wgrad(const WgradJob* jobs, int njobs, int R, cudaStream_t stream) {
  if (njobs < 1 || njobs > kWgMaxJobs) return (int)cudaErrorInvalidValue;
  WgradArgs args{};
  args.njobs = njobs;
  args.R = R;
  int blocks = 0;
  for (int j = 0; j < njobs; ++j) {
    const int tm = (jobs[j].M + kWgTile - 1) / kWgTile, tn = (jobs[j].N + kWgTile - 1) / kWgTile;
    args.jobs[j] = WgradTile{jobs[j], tn, blocks};
    blocks += tm * tn;
  }
  wgrad_kernel<Tag><<<blocks, kWgThreads, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace cvl
