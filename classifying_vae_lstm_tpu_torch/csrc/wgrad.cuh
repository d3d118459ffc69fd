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

template <typename Tag, bool kFlags>
__global__ void __launch_bounds__(kWgThreads) wgrad_kernel(const WgradArgs args) {
  __shared__ __align__(16) float As[kWgChunk][kWgTile];
  __shared__ __align__(16) float Bs[kWgChunk][kWgTile];
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
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  // the next chunk's values are loaded into registers while this chunk's
  // products run; each is staged as the job's flags say
  constexpr int kPer = kWgChunk * kWgTile / kWgThreads;
  float pa[kPer], pb[kPer];
  auto fetch = [&](int r0) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = threadIdx.x + e * kWgThreads, rr = i / kWgTile, c = i - rr * kWgTile;
      const int r = r0 + rr, m = m0 + c, n = n0 + c;
      if constexpr (kFlags) {
        float av = 0.f, bv = 0.f;
        if (r < R && m < jb.M) {
          const size_t ia = (size_t)r * jb.M + m;
          av = !jb.A     ? 1.f
               : jb.a_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(jb.A)[ia])
                           : static_cast<const float*>(jb.A)[ia];
        }
        if (r < R && n < jb.N) {
          const size_t ib = (size_t)r * jb.N + n;
          bv = jb.b_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(jb.Bm)[ib])
                         : static_cast<const float*>(jb.Bm)[ib];
        }
        pa[e] = jb.bf16 ? round_bf16(av) : av;
        pb[e] = jb.bf16 ? round_bf16(bv) : bv;
      } else {
        const float* A = static_cast<const float*>(jb.A);
        const float* Bm = static_cast<const float*>(jb.Bm);
        pa[e] = (r < R && m < jb.M) ? (A ? A[(size_t)r * jb.M + m] : 1.f) : 0.f;
        pb[e] = (r < R && n < jb.N) ? Bm[(size_t)r * jb.N + n] : 0.f;
      }
    }
  };
  if (r_begin < R) fetch(r_begin);
  for (int r0 = r_begin; r0 < R; r0 += kWgChunk) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = threadIdx.x + e * kWgThreads, rr = i / kWgTile;
      As[rr][i - rr * kWgTile] = pa[e];
      Bs[rr][i - rr * kWgTile] = pb[e];
    }
    __syncthreads();
    if (r0 + kWgChunk < R) fetch(r0 + kWgChunk);
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
