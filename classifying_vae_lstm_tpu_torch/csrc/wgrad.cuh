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
//
// A job with `bf16` set is the weight gradient of a bf16-mode product (the
// TPU kernels' `acc` with bf16 operands, then the cast of the result): A and
// Bm are rounded to bf16 as they are staged, the sum is taken in f32, and C
// is stored rounded, as bf16. `a_bf16` and `b_bf16` say that A or Bm itself
// is stored in bf16. `c_f32` (with `bf16`) stores C in f32, unrounded: the
// TPU kernels return some weight gradients of bf16 products in f32 (the
// whole-sequence LSTM's dW and its drk rung's dRk). All four default to 0.
// Testing the flags per staged element cost the f32 jobs 60-80% more time on
// an H100, so a launch whose jobs set none of `bf16`, `a_bf16` and `b_bf16`
// runs the instance without the tests (kFlags false).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cvl {

constexpr int kWgTile = 64;      // C tile is kWgTile x kWgTile
constexpr int kWgChunk = 16;     // rows per shared-memory stage
constexpr int kWgThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kWgMaxJobs = 15;

struct WgradJob {
  const void* A;    // [R, M] (lda = M), f32 (bf16 with a_bf16); null: a column of ones (M = 1)
  const void* Bm;   // [R, N], f32 (bf16 with b_bf16)
  void* C;          // [M, N], f32 (bf16 with bf16, unless c_f32)
  int M, N;
  int bf16 = 0;     // round A and Bm to bf16 as staged; store C rounded, as bf16
  int a_bf16 = 0;   // A is stored in bf16
  int c_f32 = 0;    // with bf16: store C in f32, unrounded
  int b_bf16 = 0;   // Bm is stored in bf16
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct WgradTile {
  WgradJob job;
  int tiles_n, first_block;
};

struct WgradArgs {
  WgradTile jobs[kWgMaxJobs];
  int njobs, R;
};

template <typename Tag, bool kFlags>
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
      if constexpr (kFlags) {
        float av = 0.f, bv = 0.f;
        if (r < args.R && m < jb.M) {
          const size_t ia = (size_t)r * jb.M + m;
          av = !jb.A     ? 1.f
               : jb.a_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(jb.A)[ia])
                           : static_cast<const float*>(jb.A)[ia];
        }
        if (r < args.R && n < jb.N) {
          const size_t ib = (size_t)r * jb.N + n;
          bv = jb.b_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(jb.Bm)[ib])
                         : static_cast<const float*>(jb.Bm)[ib];
        }
        As[rr][c] = jb.bf16 ? round_bf16(av) : av;
        Bs[rr][c] = jb.bf16 ? round_bf16(bv) : bv;
      } else {
        const float* A = static_cast<const float*>(jb.A);
        const float* Bm = static_cast<const float*>(jb.Bm);
        As[rr][c] = (r < args.R && m < jb.M) ? (A ? A[(size_t)r * jb.M + m] : 1.f) : 0.f;
        Bs[rr][c] = (r < args.R && n < jb.N) ? Bm[(size_t)r * jb.N + n] : 0.f;
      }
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
      if (m >= jb.M || n >= jb.N) continue;
      const size_t ic = (size_t)m * jb.N + n;
      if (kFlags && jb.bf16 && !jb.c_f32)
        static_cast<__nv_bfloat16*>(jb.C)[ic] = __float2bfloat16_rn(acc[i][q]);
      else
        static_cast<float*>(jb.C)[ic] = acc[i][q];
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
  bool flags = false;
  for (int j = 0; j < njobs; ++j) {
    const int tm = (jobs[j].M + kWgTile - 1) / kWgTile, tn = (jobs[j].N + kWgTile - 1) / kWgTile;
    args.jobs[j] = WgradTile{jobs[j], tn, blocks};
    blocks += tm * tn;
    flags = flags || jobs[j].bf16 || jobs[j].a_bf16 || jobs[j].b_bf16;
  }
  if (flags)
    wgrad_kernel<Tag, true><<<blocks, kWgThreads, 0, stream>>>(args);
  else
    wgrad_kernel<Tag, false><<<blocks, kWgThreads, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace cvl
