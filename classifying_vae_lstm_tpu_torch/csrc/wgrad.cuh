// The deterministic weight-gradient pass of the training kernels' backwards
// (csrc/two_cell_tc.cu, csrc/lstm_bwd_f32.cu, csrc/lstm_seq_tc.cu,
// csrc/vae_dense_tc.cu launch wgrad_kernel; csrc/vae_dense.cu's cooperative
// backward calls its tile loop, wgrad_tile, after its grid barrier), for
// Hopper (sm_90a).
//
// Each job is C[M, N] = sum over rows r of A[r, :M]^T Bm[r, :N] (A null: a
// column of ones, M = 1, i.e. the column sums of Bm). Up to kWgMaxJobs jobs
// run in one launch, each cut into kWgTile x kWgTile tiles of C, one block a
// tile.
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
//
// A job over many rows and few output tiles leaves most SMs idle while its
// blocks walk the rows in series. `launch_wgrad_split` cuts the rows into
// segments of seg_rows: one block per (tile, segment) writes its f32 sums to
// a scratch, and a second launch adds each element's segments in order and
// stores it as the job's flags say. The sums stay in a fixed order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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
  int segs;           // row segments (split launches; 1 otherwise)
  size_t poff, eoff;  // the job's first partial and first output element (split launches)
};

struct WgradArgs {
  WgradTile jobs[kWgMaxJobs];
  int njobs, R;
  int seg_rows;       // rows a segment (split launches)
  float* partial;     // [segments][M N] per job (split launches); null: store C
};

// N consecutive floats (on 4 N bytes; N 1, 2 or a multiple of 4) into
// registers, by the widest loads they allow
template <int N>
__device__ __forceinline__ void ldv(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x, v[4 * q + 1] = t.y, v[4 * q + 2] = t.z, v[4 * q + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    static_assert(N == 1, "1, 2 or a multiple of 4 floats");
    v[0] = *p;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async global -> shared of 16 bytes (both on 16 bytes) or 4, and its
// groups
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + CHUNK) of X[:, c0 .. c0 + TILE) (f32 [rows, ld]; null: a
// column of ones, ld = 1) into dst ([CHUNK][TILE]) by cp.async, in 16-byte
// pieces where X allows them, as far as the 16-row step that holds row
// r_end - 1; its rows at or past r_end and columns past ld 0.
template <int T, int TILE, int CHUNK>
__device__ __forceinline__ void wg_stage(float* dst, const float* X, int ld, int c0, int r0,
                                         int r_end) {
  const bool v16 = X && ((uintptr_t)X & 15) == 0 && (ld & 3) == 0;
  const int rows = min(CHUNK, (r_end - r0 + 15) & ~15);
  for (int e = threadIdx.x; e < rows * (TILE / 4); e += T) {
    const int rr = e / (TILE / 4), c = (e - rr * (TILE / 4)) * 4, m = c0 + c, r = r0 + rr;
    float* d = dst + rr * TILE + c;
    const float* src = X ? X + (size_t)r * ld + m : nullptr;
    if (r < r_end && v16 && m + 3 < ld) {
      cp_async16(d, src);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r >= r_end || m + i >= ld)
        d[i] = 0.f;
      else if (X)
        cp_async4(d + i, src + i);
      else
        d[i] = 1.f;
    }
  }
}

// The sums of one TILE x TILE tile of a job's C over the rows [r_begin,
// r_end), for a block of T threads: acc[i][q] is C[m0 + ty TM + i, n0 + tx
// TN + q] (tx = thread % 16, ty = thread / 16; TM = 16 TILE / T, TN = TILE /
// 16), summed from 0 over the rows in order by its one thread. The rows
// pass through shared memory CHUNK at a time, rows and columns past the
// job's staged as 0, which leaves the sums as they are. Two ways to stage:
// * registers (kAsync false; As and Bs [CHUNK][TILE] floats each): the next
//   chunk's values are loaded into registers while this one's products run,
//   each converted as the job's flags say where kFlags is set (without it
//   the job is f32 throughout and the flags are not read). wgrad_kernel
//   below stages so, in static shared memory, since its bf16 flags convert
//   values on the way in.
// * cp.async (kAsync; f32 jobs, no flags; As and Bs [2][CHUNK][TILE] each):
//   two chunks in flight, the next one's copies landing while this one's
//   products run. csrc/vae_dense.cu's cooperative backward stages so, after
//   its grid barrier, in the shared memory its weights held (on an H100
//   its wide shape's gradients took 0.43 ms so, in chunks of 96 rows, and
//   0.67 ms through registers in chunks of 64; PERF.md §6).
// Every thread of the block calls it, on shared memory on 16 bytes; it
// leaves As and Bs free for the next call.
template <int T, int TILE, int CHUNK, bool kFlags, bool kAsync = false>
__device__ __forceinline__ void wgrad_tile(const WgradJob& jb, int m0, int n0, int r_begin,
                                           int r_end, float* As, float* Bs,
                                           float (&acc)[TILE * 16 / T][TILE / 16]) {
  constexpr int TM = TILE * 16 / T, TN = TILE / 16;
  static_assert(TM * T == TILE * 16 && (TM == 1 || TM == 2 || TM == 4) && TN <= 4,
                "a thread takes 1, 2 or 4 outputs down and at most 4 across");
  static_assert(CHUNK % 16 == 0 && CHUNK * TILE % T == 0, "whole chunks of 16 rows a thread");
  static_assert(!(kAsync && kFlags), "cp.async stages f32 as stored");
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[i][q] = 0.f;
  // the products of a staged chunk's first nr rows (rows past them are 0:
  // whole 16-row steps)
  auto sum_rows = [&](const float* a, const float* b, int nr) {
    for (int r16 = 0; r16 < nr; r16 += 16) {
#pragma unroll
      for (int rr = r16; rr < r16 + 16; ++rr) {
        float am[TM], bn[TN];
        ldv<TM>(a + rr * TILE + ty * TM, am);
        ldv<TN>(b + rr * TILE + tx * TN, bn);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < TN; ++q) acc[i][q] = fmaf(am[i], bn[q], acc[i][q]);
      }
    }
  };
  if constexpr (kAsync) {
    const float* A = static_cast<const float*>(jb.A);
    const float* Bm = static_cast<const float*>(jb.Bm);
    auto stage = [&](int r0, int buf) {
      wg_stage<T, TILE, CHUNK>(As + buf * CHUNK * TILE, A, A ? jb.M : 1, m0, r0, r_end);
      wg_stage<T, TILE, CHUNK>(Bs + buf * CHUNK * TILE, Bm, jb.N, n0, r0, r_end);
    };
    if (r_begin < r_end) stage(r_begin, 0);
    cp_commit();
    if (r_begin + CHUNK < r_end) stage(r_begin + CHUNK, 1);
    cp_commit();
    for (int r0 = r_begin, buf = 0; r0 < r_end; r0 += CHUNK, buf ^= 1) {
      cp_wait<1>();
      __syncthreads();
      sum_rows(As + buf * CHUNK * TILE, Bs + buf * CHUNK * TILE, min(CHUNK, r_end - r0));
      __syncthreads();
      if (r0 + 2 * CHUNK < r_end) stage(r0 + 2 * CHUNK, buf);
      cp_commit();
    }
    cp_wait<0>();
    return;
  }
  constexpr int kPer = CHUNK * TILE / T;
  float pa[kPer], pb[kPer];
  auto fetch = [&](int r0) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = threadIdx.x + e * T, rr = i / TILE, c = i - rr * TILE;
      const int r = r0 + rr, m = m0 + c, n = n0 + c;
      if constexpr (kFlags) {
        float av = 0.f, bv = 0.f;
        if (r < r_end && m < jb.M) {
          const size_t ia = (size_t)r * jb.M + m;
          av = !jb.A     ? 1.f
               : jb.a_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(jb.A)[ia])
                           : static_cast<const float*>(jb.A)[ia];
        }
        if (r < r_end && n < jb.N) {
          const size_t ib = (size_t)r * jb.N + n;
          bv = jb.b_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(jb.Bm)[ib])
                         : static_cast<const float*>(jb.Bm)[ib];
        }
        pa[e] = jb.bf16 ? round_bf16(av) : av;
        pb[e] = jb.bf16 ? round_bf16(bv) : bv;
      } else {
        const float* A = static_cast<const float*>(jb.A);
        const float* Bm = static_cast<const float*>(jb.Bm);
        pa[e] = (r < r_end && m < jb.M) ? (A ? A[(size_t)r * jb.M + m] : 1.f) : 0.f;
        pb[e] = (r < r_end && n < jb.N) ? Bm[(size_t)r * jb.N + n] : 0.f;
      }
    }
  };
  if (r_begin < r_end) fetch(r_begin);
  for (int r0 = r_begin; r0 < r_end; r0 += CHUNK) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = threadIdx.x + e * T;
      As[i] = pa[e];
      Bs[i] = pb[e];
    }
    __syncthreads();
    if (r0 + CHUNK < r_end) fetch(r0 + CHUNK);
    sum_rows(As, Bs, min(CHUNK, r_end - r0));
    __syncthreads();
  }
}

template <typename Tag, bool kFlags>
__global__ void __launch_bounds__(kWgThreads) wgrad_kernel(const WgradArgs args) {
  __shared__ __align__(16) float As[kWgChunk * kWgTile];
  __shared__ __align__(16) float Bs[kWgChunk * kWgTile];
  int j = 0;
  while (j + 1 < args.njobs && (int)blockIdx.x >= args.jobs[j + 1].first_block) ++j;
  const WgradJob jb = args.jobs[j].job;
  const int segs = args.jobs[j].segs;
  const int local = (blockIdx.x - args.jobs[j].first_block) / segs;
  const int seg = (blockIdx.x - args.jobs[j].first_block) % segs;
  const int tiles_n = args.jobs[j].tiles_n;
  const int m0 = (local / tiles_n) * kWgTile, n0 = (local % tiles_n) * kWgTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r_begin = args.partial ? seg * args.seg_rows : 0;
  const int R = args.partial ? min(args.R, r_begin + args.seg_rows) : args.R;
  float acc[4][4];
  wgrad_tile<kWgThreads, kWgTile, kWgChunk, kFlags>(jb, m0, n0, r_begin, R, As, Bs, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (m >= jb.M || n >= jb.N) continue;
      const size_t ic = (size_t)m * jb.N + n;
      if (args.partial)
        args.partial[args.jobs[j].poff + (size_t)seg * jb.M * jb.N + ic] = acc[i][q];
      else if (kFlags && jb.bf16 && !jb.c_f32)
        static_cast<__nv_bfloat16*>(jb.C)[ic] = __float2bfloat16_rn(acc[i][q]);
      else
        static_cast<float*>(jb.C)[ic] = acc[i][q];
    }
  }
}

// The second launch of a split: each output element of every job, its
// segments' sums added in order, stored as the job's flags say
template <typename Tag>
__global__ void __launch_bounds__(kWgThreads) wgrad_finish_kernel(const WgradArgs args,
                                                                  size_t elems) {
  const size_t e = (size_t)blockIdx.x * kWgThreads + threadIdx.x;
  if (e >= elems) return;
  int j = 0;
  while (j + 1 < args.njobs && e >= args.jobs[j + 1].eoff) ++j;
  const WgradTile& w = args.jobs[j];
  const size_t ic = e - w.eoff, mn = (size_t)w.job.M * w.job.N;
  float s = 0.f;
  for (int seg = 0; seg < w.segs; ++seg) s += args.partial[w.poff + seg * mn + ic];
  if (w.job.bf16 && !w.job.c_f32)
    static_cast<__nv_bfloat16*>(w.job.C)[ic] = __float2bfloat16_rn(s);
  else
    static_cast<float*>(w.job.C)[ic] = s;
}

// The launch arguments of a split over segments of seg_rows rows (0: no
// split); returns the blocks of the first launch and sets the scratch floats
// and output elements it needs
inline int wgrad_plan(const WgradJob* jobs, int njobs, int R, int seg_rows, WgradArgs& args,
                      size_t& partial_floats, size_t& elems, bool& flags) {
  args = WgradArgs{};
  args.njobs = njobs;
  args.R = R;
  args.seg_rows = seg_rows;
  int blocks = 0;
  partial_floats = elems = 0;
  flags = false;
  for (int j = 0; j < njobs; ++j) {
    const int tm = (jobs[j].M + kWgTile - 1) / kWgTile, tn = (jobs[j].N + kWgTile - 1) / kWgTile;
    const int segs = seg_rows ? (R + seg_rows - 1) / seg_rows : 1;
    args.jobs[j] = WgradTile{jobs[j], tn, blocks, segs, partial_floats, elems};
    blocks += tm * tn * segs;
    partial_floats += (size_t)segs * jobs[j].M * jobs[j].N;
    elems += (size_t)jobs[j].M * jobs[j].N;
    flags = flags || jobs[j].bf16 || jobs[j].a_bf16 || jobs[j].b_bf16;
  }
  return blocks;
}

// Floats of the scratch `launch_wgrad_split` needs for these jobs
inline size_t wgrad_split_floats(const WgradJob* jobs, int njobs, int R, int seg_rows) {
  WgradArgs args;
  size_t partial_floats, elems;
  bool flags;
  wgrad_plan(jobs, njobs, R, seg_rows, args, partial_floats, elems, flags);
  return partial_floats;
}

// The njobs (<= kWgMaxJobs) jobs over R rows in one launch on `stream`;
// returns the cudaError_t of the launch.
template <typename Tag>
int launch_wgrad(const WgradJob* jobs, int njobs, int R, cudaStream_t stream) {
  if (njobs < 1 || njobs > kWgMaxJobs) return (int)cudaErrorInvalidValue;
  WgradArgs args;
  size_t partial_floats, elems;
  bool flags;
  const int blocks = wgrad_plan(jobs, njobs, R, 0, args, partial_floats, elems, flags);
  if (flags)
    wgrad_kernel<Tag, true><<<blocks, kWgThreads, 0, stream>>>(args);
  else
    wgrad_kernel<Tag, false><<<blocks, kWgThreads, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

// The jobs with their rows cut into segments of seg_rows (> 0), two launches
// on `stream`: the segments' sums into `partial` (wgrad_split_floats floats),
// then each element's segments added in order. Returns the first nonzero
// cudaError_t of a launch.
template <typename Tag>
int launch_wgrad_split(const WgradJob* jobs, int njobs, int R, int seg_rows, float* partial,
                       cudaStream_t stream) {
  if (njobs < 1 || njobs > kWgMaxJobs || seg_rows < 1) return (int)cudaErrorInvalidValue;
  WgradArgs args;
  size_t partial_floats, elems;
  bool flags;
  const int blocks = wgrad_plan(jobs, njobs, R, seg_rows, args, partial_floats, elems, flags);
  args.partial = partial;
  if (flags)
    wgrad_kernel<Tag, true><<<blocks, kWgThreads, 0, stream>>>(args);
  else
    wgrad_kernel<Tag, false><<<blocks, kWgThreads, 0, stream>>>(args);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  wgrad_finish_kernel<Tag><<<(unsigned)((elems + kWgThreads - 1) / kWgThreads), kWgThreads, 0,
                             stream>>>(args, elems);
  return (int)cudaGetLastError();
}

}  // namespace cvl
