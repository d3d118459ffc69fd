// What the persistent cooperative generation kernels of csrc/generate_cl_vrnn.cu
// and csrc/generate_cl_vae.cu share: the grid barrier (also the f32 LSTM
// forward's group barrier, csrc/lstm_seq.cu, and, in a form that needs no
// zeroing, the f32 dense-stack backward's, csrc/vae_dense.cu), the int8
// tensor-core product and block 0's clock of the parts of a step.

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

// The same barrier on state that outlives the launch, so it needs no zeroing
// before each one (csrc/vae_dense.cu's backward): bar[0] counts the current
// round's arrivals and is 0 between rounds, bar[1] counts the rounds. Thread
// 0 reads the round, then arrives with an acquire-release add; the last
// block to arrive sets the count back to 0 and releases the next round,
// the others wait with acquiring loads until the round moves.
__device__ __forceinline__ void grid_sync_reusable(unsigned* bar, unsigned blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned round, prev;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(round) : "l"(bar + 1) : "memory");
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(bar)
                 : "memory");
    if (prev + 1 == blocks) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], 0;\n" ::"l"(bar) : "memory");
      asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(bar + 1), "r"(round + 1)
                   : "memory");
    } else {
      unsigned seen;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(bar + 1) : "memory");
      } while (seen == round);
    }
  }
  __syncthreads();
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
