// One f32 product mainloop on FFMA for Hopper (sm_90a): a block of 128
// threads computes a 32 x 32 tile of C = A[M, K] . B[K, N] with B stored
// transposed as [N, K], which is how a product dz @ Rkᵀ reads a weight Rk
// [N, K] in its stored layout. The f32 walk and dx kernels of
// csrc/two_cell_tc.cu and csrc/lstm_bwd_f32.cu are this mainloop with their
// own epilogues; the bf16 kernels have csrc/mma_bf16.cuh (whose cp.async
// helpers this header uses).
//
// Plain FFMA, no TF32: f32 stays exact to the JAX side's
// precision="highest". Each output is summed by one thread over k in order,
// with no atomics, so results are the same from run to run.

#pragma once

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace cvl_ffma {

// FFMA tiles of kFM x kFN outputs, K chunks of kFK, a ring of kFStages
// stages of both operands with rows of kFS floats
constexpr int kFM = 32, kFN = 32, kFK = 32, kFThreads = 128, kFS = kFK + 4, kFStages = 3;
constexpr int kFStage = kFM * kFS;  // one operand's chunk, [32][kFS]
constexpr int kFSmemFloats = kFStages * 2 * kFStage;

// acc[i][q] (row ty + 16 i, column tx + 8 q of the block's kFM x kFN tile;
// ty = thread / 8, tx = thread % 8) += A [M, K] (row-major, lda) times B
// stored [N, K] (ldb), on FFMA, over K in chunks of kFK through a ring of
// kFStages cp.async stages in `sm` (kFSmemFloats). Each stage holds both
// operands' chunks row by row ([32][kFS], K contiguous), so the inner loop
// reads four k at once (float4) from rows whose 16-byte groups fall on
// distinct banks. K, lda, ldb are multiples of 4 and the bases 16-byte
// aligned; chunks outside M, N or K read as zeros. Each output is summed by
// one thread over k in order.
__device__ __forceinline__ void mainloop(float (&acc)[2][4], const float* __restrict__ A, int M,
                                         int lda, const float* __restrict__ Bt, int N, int ldb,
                                         int m0, int n0, int K, float* sm) {
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int nk = (K + kFK - 1) / kFK;
  auto load_stage = [&](int st, int k0) {
    float* as = sm + st * 2 * kFStage;
    float* bs = as + kFStage;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kFThreads, r = c / 8, k = k0 + (c % 8) * 4;
      const bool ka = k < K, va = ka && m0 + r < M, vb = ka && n0 + r < N;
      cvl_tc::cp_async16(as + r * kFS + (c % 8) * 4, va ? A + (size_t)(m0 + r) * lda + k : A, va);
      cvl_tc::cp_async16(bs + r * kFS + (c % 8) * 4, vb ? Bt + (size_t)(n0 + r) * ldb + k : Bt,
                         vb);
    }
  };
#pragma unroll
  for (int st = 0; st < kFStages - 1; ++st) {
    if (st < nk) load_stage(st, st * kFK);
    cvl_tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cvl_tc::cp_async_wait<kFStages - 2>();
    __syncthreads();
    const int pre = kt + kFStages - 1;
    if (pre < nk) load_stage(pre % kFStages, pre * kFK);
    cvl_tc::cp_async_commit();
    const float* as = sm + (kt % kFStages) * 2 * kFStage;
    const float* bs = as + kFStage;
#pragma unroll
    for (int k = 0; k < kFK; k += 4) {
      const float4 a4[2] = {*reinterpret_cast<const float4*>(as + ty * kFS + k),
                            *reinterpret_cast<const float4*>(as + (ty + 16) * kFS + k)};
      float4 b4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b4[q] = *reinterpret_cast<const float4*>(bs + (tx + 8 * q) * kFS + k);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][q] = fmaf(a4[i].x, b4[q].x, acc[i][q]);
          acc[i][q] = fmaf(a4[i].y, b4[q].y, acc[i][q]);
          acc[i][q] = fmaf(a4[i].z, b4[q].z, acc[i][q]);
          acc[i][q] = fmaf(a4[i].w, b4[q].w, acc[i][q]);
        }
    }
  }
  cvl_tc::cp_async_wait<0>();
}

// The block's accumulators into an f32 tile [kFM][kFN + 4] at `sm` (over the
// ring, once every warp is done with it), so that an epilogue can read them
// row by row
__device__ __forceinline__ void stage_acc(const float (&acc)[2][4], float* sm) {
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) sm[(ty + 16 * i) * (kFN + 4) + tx + 8 * q] = acc[i][q];
}

}  // namespace cvl_ffma
