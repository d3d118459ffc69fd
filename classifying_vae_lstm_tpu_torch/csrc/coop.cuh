// What the persistent cooperative generation kernels of csrc/generate_cl_vrnn.cu
// and csrc/generate_cl_vae.cu share: the grid barrier (also the f32 LSTM
// forward's group barrier, csrc/lstm_seq.cu), the int8 tensor-core product
// and block 0's clock of the parts of a step.

#pragma once

#include <cuda_runtime.h>

namespace cvl_coop {

// d += a . b on the int8 tensor cores: a 16 x 32 (row) by 32 x 8 (col)
// product of s8 codes, summed in s32 (exact)
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Every block of the grid (or of a group of `blocks` blocks that share
// `count`) arrives before any leaves. `count` only grows: round r ends when
// it reaches r * blocks. Thread 0 arrives with a
// release (after the block barrier, so it orders the whole block's writes
// before the arrival) and waits with acquiring loads (the block barrier
// after it orders the block's later reads after them). Full fences in place
// of the release and acquire cost ~0.1 us a barrier more on an H100.
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned& rounds, unsigned blocks) {
  __syncthreads();
  ++rounds;
  if (threadIdx.x == 0) {
    const unsigned target = rounds * blocks;
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(count) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

__device__ __forceinline__ void grid_sync(unsigned* count, unsigned& rounds) {
  grid_sync(count, rounds, gridDim.x);
}

// Block 0's clock of a step's parts (`out` set), summed over the steps: each
// kernel names its N parts. lap(i) adds the ns since the last lap to
// sums[i] (`%globaltimer`); `flush` writes them out.
template <int N>
struct PhaseClock {
  unsigned long long* out;
  unsigned long long last, sums[N];
  __device__ __forceinline__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ __forceinline__ void start() {
    if (!out) return;
    for (int i = 0; i < N; ++i) sums[i] = 0;
    last = now();
  }
  __device__ __forceinline__ void lap(int i) {
    if (!out) return;
    const unsigned long long t = now();
    sums[i] += t - last;
    last = t;
  }
  __device__ __forceinline__ void flush() {
    if (out)
      for (int i = 0; i < N; ++i) out[i] = sums[i];
  }
};

}  // namespace cvl_coop
