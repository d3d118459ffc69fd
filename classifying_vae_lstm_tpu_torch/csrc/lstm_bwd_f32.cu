// The whole-sequence Keras-2.0 LSTM's full backward in f32 for Hopper
// (sm_90a): the reverse walk spread over the whole card on FFMA.
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_lstm.py:1378
// `_backward_call_full` -> `_lstm_bwd_kernel_full` :986, in the f32 mode (the
// default fusion rung (T, T, T)). The bf16 stream mode of the same rung is
// csrc/lstm_seq_tc.cu's; the other rungs' walks stay in csrc/lstm_seq.cu.
// One ported kernel, one wrapper call: the walk (T + 1 launches), dx, the
// weight gradients (two launches) and the bias sum.
//
// What it computes. Time runs in reverse, t = T-1 .. 0, with the carries dh
// and dc zero at t = T:
//   dz(t) = gates'(z[t], c[t], c_prev[t], dh + dh_seq[t], dc + dc_seq[t])
//   dh    = dz(t) @ Rkᵀ;  dc = dc * f
// then dx = dz @ Wᵀ, dRk = sum h_prevᵀ dz, dW = sum xᵀ dz, db = sum dz over
// the T*B rows; the last carries are dh0 and dc0. gates' is
// `_bwd_gate_grads` (:786) of the Keras-2.0 gates (i, f, c, o): the
// hard-sigmoid derivative is 0.2 strictly inside (0, 1) and 0 at and beyond
// the clip points.
//
// What bounds it. At the training shape (B=200, T=16, H=256, IN~103) the
// products are 4.7 GFLOP (0.070 ms at 67 TFLOP/s without tensor cores); the
// recurrent product dz(t+1) @ Rkᵀ, [B, 4H] x [4H, H], is in series from step
// to step (1.7 GFLOP of the 4.7), the rest is not.
//
// What the design does about it.
// * A step's recurrent product runs over the whole batch in 32 x 32 FFMA
//   tiles (csrc/ffma_f32.cuh), so each tile reads its slice of Rk once a step
//   (the first design's 4-row blocks each read all of (Rk | W)ᵀ, 1.4 MB, from
//   L2 every step, 50 blocks on 132 SMs). Rk is read in its stored layout
//   [H, 4H], which is Rkᵀ's [N, K]: nothing is transposed.
// * K of each tile is split between the kSplit = 4 blocks of a cluster
//   (1 x 1 x kSplit) in whole chunks: each sums its share of K, stages its
//   sums in shared memory, and after a cluster barrier each block takes
//   kFM / kSplit of the tile's rows, adding the ranks' sums through
//   distributed shared memory in rank order (`two_cell_walk_f32_kernel`'s
//   structure, without its z hand-off). At the training shape that is 224
//   blocks a step. On an H100 a split of 2 made the walk slower, and one of
//   8, with twice the bias partial sums, made the whole call slower.
// * The product's output columns are hidden units, and dz of a unit needs
//   only its own dh, c and z: the gate gradients run in the epilogue (warp w
//   takes rows w, w+4, ... of its block's share, lane l unit n0 + l), which
//   adds dh_seq[t] and dc_seq[t], updates the dc carry and writes dz(t) in
//   f32.
// * The state lives in global memory: dz of every step ([T, B, 4H], the next
//   step's operand, kept for dx and the weight gradients) and the dc carry;
//   T steps are T + 1 launches on one stream, the last giving dh0.
// * dx is out of the serial chain: dz @ Wᵀ over all T*B rows, one launch of
//   the same tiles after the walk, W [IN, 4H] read as Wᵀ's [N, K].
// * dRk and dW go through csrc/wgrad.cuh's row-split launch (the T*B rows
//   cut into segments, the segments added in order); db is the column sum,
//   in order, of partial sums that each epilogue writes per (step, row tile,
//   rank), its rows added warp by warp and the four warps in order.
// * Plain FFMA everywhere (no TF32, no 3xTF32) keeps f32 exact to the JAX
//   side's precision="highest"; no atomics, so two calls give the same bits.

#include <cuda_runtime.h>
#include <stddef.h>

#include <cooperative_groups.h>

#include "ffma_f32.cuh"
#include "wgrad.cuh"

namespace {

namespace cg = cooperative_groups;

using cvl_ffma::kFK;
using cvl_ffma::kFM;
using cvl_ffma::kFN;
using cvl_ffma::kFSmemFloats;
using cvl_ffma::kFThreads;

constexpr int kStride = kFN + 4;  // the staged f32 tile [kFM][kStride]
constexpr int kSplit = 4;         // blocks of a cluster that split K of a walk product
// rows a segment of the split wgrad.cuh sums
constexpr int kSegRows = 256;

__device__ __forceinline__ float hard_sigmoid(float x) {
  return fminf(fmaxf(0.2f * x + 0.5f, 0.f), 1.f);
}

// d hard_sigmoid / dx expressed through the gate's value, as `_bwd_gate_grads`
__device__ __forceinline__ float hard_sigmoid_grad(float gate) {
  return (gate > 0.f && gate < 1.f) ? 0.2f : 0.f;
}

struct WalkArgs {
  const float* z;                  // [T, B, 4H]
  const float *cp, *c, *dh, *dc;   // [T, B, H]; dh, dc: the cotangents of the h and c sequences
  const float* rk;                 // [H, 4H], read as Rkᵀ [N, K]
  float* dz;                       // [T, B, 4H]
  float* dh0;                      // [B, H], written by the last launch
  float* dc_c;                     // [B, H]  the dc carry (dc0 at the end), zero at the start
  float* part;                     // [T * row tiles * kSplit, 4H]  bias partial sums
  int T, B, H;
};

// The epilogue of walk step t for rank `rank`'s share of a kFM x kFN product
// tile (rows m0 + rank kFM/kSplit .., units n0 ..): the product is the ranks'
// staged sums added in rank order, read through the cluster. After the last
// step (t = -1) it is dh0. Otherwise dh = product + dh_seq[t] and the gate
// gradients: dz(t), the dc carry, and the share's rows of dz summed into
// `part` (warps in order 0 .. 3). `red` holds 16 kFN floats.
__device__ __forceinline__ void walk_epilogue(const float* const (&peer)[kSplit], float* red,
                                              const WalkArgs& a, int t, int rank) {
  constexpr int kShare = kFM / kSplit;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kFM + rank * kShare, u = blockIdx.x * kFN + lane;
  const int B = a.B, H = a.H, r0 = rank * kShare;
  const auto product = [&](int i) {
    float v = peer[0][i];
#pragma unroll
    for (int s = 1; s < kSplit; ++s) v += peer[s][i];
    return v;
  };
  if (t < 0) {
    for (int r = warp; r < kShare && m0 + r < B; r += 4)
      if (u < H) a.dh0[(size_t)(m0 + r) * H + u] = product((r0 + r) * kStride + lane);
    return;
  }
  float db[4] = {0.f, 0.f, 0.f, 0.f};
  const size_t tb = (size_t)t * B;
  for (int r = warp; r < kShare && m0 + r < B && u < H; r += 4) {
    const size_t row = tb + m0 + r, cu = (size_t)(m0 + r) * H + u;
    const float* zr = a.z + row * 4 * H + u;
    const float ig = hard_sigmoid(zr[0]), fg = hard_sigmoid(zr[H]);
    const float gg = tanhf(zr[2 * H]), og = hard_sigmoid(zr[3 * H]);
    const float tc = tanhf(a.c[row * H + u]);
    const float dh = product((r0 + r) * kStride + lane) + a.dh[row * H + u];
    const float dc = (a.dc_c[cu] + a.dc[row * H + u]) + dh * og * (1.f - tc * tc);
    const float dz[4] = {dc * gg * hard_sigmoid_grad(ig),
                         dc * a.cp[row * H + u] * hard_sigmoid_grad(fg),
                         dc * ig * (1.f - gg * gg), dh * tc * hard_sigmoid_grad(og)};
    a.dc_c[cu] = dc * fg;
    float* out = a.dz + row * 4 * H + u;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      out[g * H] = dz[g];
      db[g] += dz[g];
    }
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) red[(warp * 4 + g) * kFN + lane] = db[g];
  __syncthreads();
  float* part = a.part + (((size_t)t * gridDim.y + blockIdx.y) * kSplit + rank) * 4 * H;
  for (int i = threadIdx.x; i < 4 * kFN; i += blockDim.x) {
    const int g = i / kFN, col = i % kFN, n = blockIdx.x * kFN + col;
    if (n < H)
      part[g * H + n] = red[g * kFN + col] + red[(4 + g) * kFN + col] +
                        red[(8 + g) * kFN + col] + red[(12 + g) * kFN + col];
  }
}

// walk step t (t = -1: the last product only): the tile of dz(t+1) @ Rkᵀ on
// FFMA, K split across the kSplit blocks of a cluster (1 x 1 x kSplit;
// blockIdx.z = rank) in whole chunks, rank r the chunks [r per, (r + 1) per),
// then the epilogue
__global__ void __launch_bounds__(kFThreads) lstm_bwd_walk_kernel(const WalkArgs a, int t) {
  __shared__ __align__(16) float sm[kFSmemFloats];
  static_assert(kFM * kStride + 16 * kFN <= kFSmemFloats, "tile and partial sums fit");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int H4 = 4 * a.H;
  const int per = ((H4 + kFK - 1) / kFK + kSplit - 1) / kSplit * kFK;
  const int k0 = rank * per, len = min(per, H4 - k0);
  float acc[2][4] = {};
  if (t + 1 < a.T && len > 0)
    cvl_ffma::mainloop(acc, a.dz + (size_t)(t + 1) * a.B * H4 + k0, a.B, H4, a.rk + k0, a.H, H4,
                       blockIdx.y * kFM, blockIdx.x * kFN, len, sm);
  cvl_ffma::stage_acc(acc, sm);
  cluster.sync();  // every rank's sums are staged
  const float* peer[kSplit];
#pragma unroll
  for (int s = 0; s < kSplit; ++s) peer[s] = cluster.map_shared_rank(sm, s);
  walk_epilogue(peer, sm + kFM * kStride, a, t, rank);
  cluster.sync();  // the peers have read this block's sums
}

// one walk step's launch: a cluster of kSplit blocks a tile
int walk_step(const WalkArgs& a, int t, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.H + kFN - 1) / kFN, (a.B + kFM - 1) / kFM, kSplit);
  cfg.blockDim = dim3(kFThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = kSplit;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, lstm_bwd_walk_kernel, a, t);
}

// dx = dz @ Wᵀ over the R = T*B rows, W [IN, 4H] read as Wᵀ's [N, K]
__global__ void __launch_bounds__(kFThreads)
    lstm_bwd_dx_kernel(const float* dz, const float* w, float* dx, int R, int IN, int H4) {
  __shared__ __align__(16) float sm[kFSmemFloats];
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  float acc[2][4] = {};
  cvl_ffma::mainloop(acc, dz, R, H4, w, IN, H4, m0, n0, H4, sm);
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + ty + 16 * i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = n0 + tx + 8 * q;
      if (row < R && col < IN) dx[(size_t)row * IN + col] = acc[i][q];
    }
  }
}

struct lstm_bwd_wgrad {};  // names this source's copy of cvl::wgrad_kernel

int cdiv(int a, int b) { return (a + b - 1) / b; }

int part_rows(int T, int B) { return T * kSplit * cdiv(B, kFM); }

void wide_jobs(cvl::WgradJob* jobs, const float* hp, const float* x, const float* dz, float* drk,
               float* dw, int IN, int H) {
  jobs[0] = {hp, dz, drk, H, 4 * H};
  jobs[1] = {x, dz, dw, IN, 4 * H};
}

}  // namespace

// Rows of the bias partial sums (the wrapper sizes `part` as [rows, 4H]).
extern "C" int cvl_lstm_bwd_f32_part_rows(int T, int B) { return part_rows(T, B); }

// Floats of the scratch the weight-gradient sums need (their row segments).
extern "C" long long cvl_lstm_bwd_f32_scratch(int T, int B, int IN, int H) {
  cvl::WgradJob jobs[2];
  wide_jobs(jobs, nullptr, nullptr, nullptr, nullptr, nullptr, IN, H);
  return (long long)cvl::wgrad_split_floats(jobs, 2, T * B, kSegRows);
}

// The full backward on `stream`: the walk (T + 1 launches: dz [T, B, 4H]
// f32, dh0, dc0 (zeroed by the caller) and the bias partial sums `part`),
// then dx
// (one launch), dRk and dW (two launches, `scratch` holding
// cvl_lstm_bwd_f32_scratch floats) and db (one launch). z, h_prev, x, Rk
// [H, 4H] and W [IN, 4H] are read as stored. Returns the first nonzero
// cudaError_t of a launch.
extern "C" int cvl_lstm_bwd_f32(const float* z, const float* cp, const float* c,
                                const float* hp, const float* x, const float* dh,
                                const float* dc, const float* rk, const float* w, float* dx,
                                float* dh0, float* dc0, float* drk, float* dw, float* db,
                                float* dz, float* part, float* scratch, int T, int B, int IN,
                                int H, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WalkArgs a{z, cp, c, dh, dc, rk, dz, dh0, dc0, part, T, B, H};
  for (int t = T - 1; t >= -1; --t) {
    const int err = walk_step(a, t, st);
    if (err) return err;
  }
  const int R = T * B, H4 = 4 * H;
  lstm_bwd_dx_kernel<<<dim3(cdiv(IN, kFN), cdiv(R, kFM)), kFThreads, 0, st>>>(dz, w, dx, R, IN,
                                                                              H4);
  int err = (int)cudaGetLastError();
  if (err) return err;
  cvl::WgradJob jobs[2];
  wide_jobs(jobs, hp, x, dz, drk, dw, IN, H);
  err = cvl::launch_wgrad_split<lstm_bwd_wgrad>(jobs, 2, R, kSegRows, scratch, st);
  if (err) return err;
  const cvl::WgradJob bias[] = {{nullptr, part, db, 1, H4}};
  return cvl::launch_wgrad<lstm_bwd_wgrad>(bias, 1, part_rows(T, B), st);
}
