// One tensor-core product mainloop for Hopper (sm_90a): a block computes a
// BM x BN tile of C = A[M, K] . B[K, N] with bf16 operands and f32 sums,
// through `mma.sync.m16n8k16` (bf16 -> f32) fed by `ldmatrix` from a
// three-stage `cp.async` ring in shared memory. The kernels of
// csrc/lstm_seq_tc.cu and the bf16 products of csrc/two_cell_tc.cu are this
// mainloop with their own epilogues.
//
// Shapes. B is row-major [K, N] (leading dimension ldb), or, with kBT,
// stored transposed as [N, K] (ldb), which is how a product dz @ Rkᵀ reads a
// weight Rk [N, K] in its stored layout. A is row-major [M, K] (lda), or,
// with kAT, stored transposed as [K, M] (lda), which is how a weight
// gradient sum_rows h_prevᵀ dz reads its left operand. A block
// of 128 threads (2 x 2 warps, 32 x 64 outputs each) owns the tile
// (m0, n0); K is walked in chunks of 32.
//
// Ragged edges. Each operand has its own bounds (rows and columns that
// hold data); a 16-byte chunk outside them is zero-filled (`cp.async` with
// source size 0), so K is padded with zeros and rows and columns past M and
// N come out zero. A 16-byte copy needs the operand's row width, leading
// dimension and base to be multiples of 8 elements (16 bytes); an operand
// that is not (an odd hidden width) is staged element by element instead,
// with the same zero fill.
//
// Sum order. Each output element is summed by one thread over K in a fixed
// order, with no atomics, so results are the same from run to run.
//
// Shared memory: 41,472 bytes a block (kSmemBytes; 46,080 with kBT,
// smem_bytes<true>()), static in the kernel, so several blocks share an SM.
// Rows are padded by 8 elements, which keeps the 8 row addresses of each
// `ldmatrix` on distinct banks. After the mainloop
// the same bytes can hold the block's f32 tile (`stage_acc`) for an
// epilogue that reads it row by row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cvl_tc {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64, kBN = 128, kBK = 32, kStages = 3, kThreads = 128;
constexpr int kAStride = kBK + 8;    // A tile [BM][BK] (row-major A)
constexpr int kATStride = kBM + 8;   // A tile [BK][BM] (kAT)
constexpr int kBStride = kBN + 8;    // B tile [BK][BN]
constexpr int kBTStride = kBK + 8;   // B tile [BN][BK] (kBT)
constexpr int kAStage = kBM * kAStride > kBK * kATStride ? kBM * kAStride : kBK * kATStride;
constexpr int kBStage = kBK * kBStride;
constexpr int kBTStage = kBN * kBTStride;
template <bool kBT>
__host__ __device__ constexpr int b_stage() {
  return kBT ? kBTStage : kBStage;
}

// An operand in global memory: `rows` x `cols` of data at leading dimension
// `ld` (elements); everything past them reads as zero.
struct Operand {
  const bf16* p;
  int rows, cols, ld;
};

// the accumulators of one thread: [m16 tile][n8 tile][fragment]
using Acc = float[2][8][4];

__device__ __forceinline__ bool vec_ok(const Operand& o) {
  return (o.cols % 8) == 0 && (o.ld % 8) == 0 && ((uintptr_t)o.p % 16) == 0;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one 8-element chunk of row r, columns c .. c+7 of `o` into `dst`
__device__ __forceinline__ void load_chunk(bf16* dst, const Operand& o, int r, int c, bool vec) {
  if (vec) {
    const bool valid = r < o.rows && c < o.cols;
    cp_async16(dst, valid ? o.p + (size_t)r * o.ld + c : o.p, valid);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = (r < o.rows && c + e < o.cols) ? o.p[(size_t)r * o.ld + c + e]
                                                : __float2bfloat16_rn(0.f);
  }
}

// stage `st` <- the K chunk starting at k0
template <bool kAT, bool kBT>
__device__ __forceinline__ void load_stage(bf16* As, bf16* Bs, const Operand& A, const Operand& B,
                                           int m0, int n0, int k0, bool va, bool vb) {
  const int tid = threadIdx.x;
  if (!kAT) {  // [BM][BK]: 64 rows x 4 chunks
#pragma unroll
    for (int i = 0; i < kBM * kBK / 8 / kThreads; ++i) {
      const int ch = tid + i * kThreads, r = ch / (kBK / 8), c = (ch % (kBK / 8)) * 8;
      load_chunk(As + r * kAStride + c, A, m0 + r, k0 + c, va);
    }
  } else {  // [BK][BM] from the stored [K][M]: 32 rows x 8 chunks
#pragma unroll
    for (int i = 0; i < kBM * kBK / 8 / kThreads; ++i) {
      const int ch = tid + i * kThreads, r = ch / (kBM / 8), c = (ch % (kBM / 8)) * 8;
      load_chunk(As + r * kATStride + c, A, k0 + r, m0 + c, va);
    }
  }
  if (!kBT) {
#pragma unroll
    for (int i = 0; i < kBK * kBN / 8 / kThreads; ++i) {  // [BK][BN]: 32 rows x 16 chunks
      const int ch = tid + i * kThreads, r = ch / (kBN / 8), c = (ch % (kBN / 8)) * 8;
      load_chunk(Bs + r * kBStride + c, B, k0 + r, n0 + c, vb);
    }
  } else {  // [BN][BK] from the stored [N][K]: 128 rows x 4 chunks
#pragma unroll
    for (int i = 0; i < kBK * kBN / 8 / kThreads; ++i) {
      const int ch = tid + i * kThreads, r = ch / (kBK / 8), c = (ch % (kBK / 8)) * 8;
      load_chunk(Bs + r * kBTStride + c, B, n0 + r, k0 + c, vb);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the products of one staged K chunk into this warp's accumulators
template <bool kAT, bool kBT>
__device__ __forceinline__ void compute_stage(Acc& acc, const bf16* As, const bf16* Bs) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    unsigned a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m = wm + mi * 16;
      if (!kAT) {
        // lanes 0-15: rows m .. m+15 at k; lanes 16-31: the same rows at k + 8
        ldmatrix_x4(a[mi], As + (m + (lane % 16)) * kAStride + kk + (lane / 16) * 8);
      } else {
        // matrix j = lane / 8: (m + 8 (j & 1), k + 8 (j >> 1)), read transposed
        const int j = lane / 8;
        ldmatrix_x4_trans(a[mi],
                          As + (kk + (j >> 1) * 8 + lane % 8) * kATStride + m + (j & 1) * 8);
      }
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];  // two n8 tiles: (b0, b1) of tile 2 np, then of tile 2 np + 1
      if (!kBT) {
        ldmatrix_x4_trans(b, Bs + (kk + (lane % 16)) * kBStride + wn + np * 16 + (lane / 16) * 8);
      } else {
        // matrix j = lane / 8: (n + 8 (j >> 1), k + 8 (j & 1)); rows n hold k
        // in order, which is the fragment's layout as it stands
        const int j = lane / 8;
        ldmatrix_x4(b, Bs + (wn + np * 16 + (j >> 1) * 8 + lane % 8) * kBTStride + kk +
                           (j & 1) * 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// Shared memory a kernel declares for the mainloop (and, after it, for
// the f32 tile of stage_acc)
constexpr int kTileStride = kBN + 4;  // f32 tile [BM][BN + 4]
constexpr int kTileBytes = kBM * kTileStride * 4;
template <bool kBT>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * (kAStage + b_stage<kBT>()) * 2 > kTileBytes
             ? kStages * (kAStage + b_stage<kBT>()) * 2
             : kTileBytes;
}
constexpr int kSmemBytes = smem_bytes<false>();

// acc += A[m0 .., 0 .. K) . B[0 .. K), n0 ..) for this block's tile; K is
// the longer of the two operands' K extents (the other reads zeros there);
// `smem` holds smem_bytes<kBT>(), 16-byte aligned
template <bool kAT, bool kBT = false>
__device__ __forceinline__ void mainloop(Acc& acc, const Operand& A, const Operand& B, int m0,
                                         int n0, int K, unsigned char* smem) {
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kStages * kAStage;
  constexpr int kBSt = b_stage<kBT>();
  const bool va = vec_ok(A), vb = vec_ok(B);
  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<kAT, kBT>(As + s * kAStage, Bs + s * kBSt, A, B, m0, n0, s * kBK, va, vb);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int pre = kt + kStages - 1;
    if (pre < nk)
      load_stage<kAT, kBT>(As + (pre % kStages) * kAStage, Bs + (pre % kStages) * kBSt, A, B,
                           m0, n0, pre * kBK, va, vb);
    cp_async_commit();
    compute_stage<kAT, kBT>(acc, As + (kt % kStages) * kAStage, Bs + (kt % kStages) * kBSt);
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
}

// The position of accumulator (mi, ni, q) of this thread in the block's tile
// (the m16n8 fragment layout: q = 0, 1 on row lane / 4, columns 2 (lane % 4)
// and + 1; q = 2, 3 eight rows below)
__device__ __forceinline__ int acc_row(int mi, int q) {
  return ((threadIdx.x / 32) / 2) * 32 + mi * 16 + (threadIdx.x % 32) / 4 + (q >= 2 ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int ni, int q) {
  return ((threadIdx.x / 32) % 2) * 64 + ni * 8 + 2 * (threadIdx.x % 4) + (q & 1);
}

// The block's accumulators into an f32 tile [BM][BN + 4] over the mainloop's
// shared memory, so that an epilogue can read them row by row and write
// global memory in whole rows (a warp per row)
__device__ __forceinline__ float* stage_acc(const Acc& acc, unsigned char* smem) {
  float* tile = reinterpret_cast<float*>(smem);
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + acc_row(mi, 2 * h) * kTileStride + acc_col(ni, 0)) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  __syncthreads();
  return tile;
}

}  // namespace cvl_tc
