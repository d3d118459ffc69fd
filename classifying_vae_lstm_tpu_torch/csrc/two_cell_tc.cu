// The two-cell (encoder + decoder) cl_vrnn backward for Hopper (sm_90a): the
// reverse walk spread over the whole card, the bf16 stream mode on the tensor
// cores, the f32 mode on FFMA.
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_two_cell.py:408 `_bwd_call`
// -> `_bwd_kernel` :295 (with `_core_bwd` :503-516), in the f32 mode and in
// the bf16 stream mode (`compute_dtype=bf16`). csrc/two_cell.cu keeps the
// forward. One ported kernel, two wrapper calls: the walk (2T + 1 launches),
// then the gradient products (4 launches in bf16, 5 in f32).
//
// What it computes. Time runs in reverse, t = T-1 .. 0, with the carries
// dh_d, dc_d, dh_e, dc_e zero at t = T:
//   dz_d(t) = gates'(zd[t], cd[t], cpd[t], dh_d + dhd[t], dc_d)   decoder
//   dh_d    = dz_d(t) @ Rk_dᵀ
//   dzz     = dz_d(t) @ Kzᵀ;  dza = [dzz + dzargs[:L], dzz eps sig / 2 + dzargs[L:]]
//   dz_e(t) = gates'(ze[t], ce[t], cpe[t], dh_e + dza @ Wzᵀ, dc_e)  encoder
//   dh_e    = dz_e(t) @ Rk_eᵀ
// then dxd = dz_d @ Wdxᵀ, dxe = dz_e @ Weᵀ, the weight gradients hpᵀ dz, xᵀ dz
// (both cells), zᵀ dz_d, heᵀ dza, and the bias sums; the last carries are
// the initial-state cotangents. gates' is `_bwd_gate_grads` of the Keras-2.0
// gates (i, f, c, o): the hard-sigmoid derivative is 0.2 strictly inside
// (0, 1) and 0 at and beyond the clip points.
//
// What bounds it. At the bf16 shape (B=1,024, T=16, H=512, L=2, input widths
// 101) the backward is 165 GFLOP of products (0.167 ms at the tensor cores'
// 989 TFLOP/s); at the f32 shape (B=200, H=256, L=8) 9.5 GFLOP (0.142 ms at
// 67 TFLOP/s without tensor cores). But step t needs all of dz(t+1) of a row,
// so the T steps of the recurrent products run in series: 2 x [B, 4H] x
// [4H, H] a step.
//
// What the design does about it.
// * A step's recurrent products run over the whole batch, cut into tiles
//   (bf16: 64 rows x 128 units, csrc/mma_bf16.cuh's mma.sync mainloop; f32:
//   32 x 32 on FFMA through a cp.async ring), so the grid covers the card
//   and each tile reads its Rk slice once a step (the 4-row tiles of the
//   first design streamed all of Rk from L2 per 4 rows, and ran 50 blocks on
//   132 SMs at the f32 shape). The decoder's tiles and the encoder's are two
//   jobs of one grid: the encoder's product dz_e(t+1) @ Rk_eᵀ does not wait
//   for the decoder's step t. Rk is read in its stored layout [H, 4H],
//   which is Rkᵀ's [N, K] (the mainloop's kBT): nothing is transposed.
// * K of each tile is split between the two blocks of a cluster (1 x 1 x
//   2): each sums half of K, stages its sums in shared memory, and after a
//   cluster barrier each block takes half the tile's rows, adding rank 0's
//   and rank 1's sums through distributed shared memory, in that order.
//   With one 4-warp block per tile the card held one block an SM and the
//   mainloop ran latency-bound; the split doubles the warps an SM holds.
// * The product's output columns are units, and dz of a unit needs only its
//   own dh, c and z: the decoder's gate gradients run in the product's
//   epilogue (warp w takes rows w, w+4, ..., lane l the units n0 + l + 32q),
//   which adds dhd[t] and writes dz_d(t). No gate permutation is needed: the
//   four gates of a unit are four columns of dz, that is four rows of K.
// * The z hand-off couples the cells within a step: dzz needs all 4H columns
//   of a row of dz_d(t), and the encoder's dh needs dzz. It is a second,
//   row-wise launch a step (`two_cell_handoff_kernel`, 4 rows a block) with
//   no large product: dzz (the block's warps split the columns, their sums
//   added in order), dza, dza @ Wzᵀ and the encoder's gates. The TPU
//   kernel's `dhez` hand-off ran one grid step late; here the stream orders
//   the launches.
// * T steps are 2T + 1 launches on one stream; the state lives in global
//   memory: dz of every step ([T, B, 4H], the products' operand, kept for
//   dx and the weight gradients), the dc carries (dc0 at the end), the
//   encoder's product (dh0e at the end); a last product launch gives dh0d
//   and dh0e.
// * dx is out of the chain: dxe = dz_e @ Weᵀ and dxd = dz_d @ Wdxᵀ, one
//   launch of two jobs over the T*B rows after the walk.
// * Weight gradients. bf16: dRk_e, dWe, dRk_d, dWdx are tensor-core products
//   over the T*B rows (the left operand hp or x read transposed, kAT), one
//   launch of four jobs; x comes with its rows padded to a multiple of 8
//   (the input width 101 staged element by element took each block a load
//   latency per K chunk). f32: csrc/wgrad.cuh, its rows cut into segments
//   of kSegRows so that many blocks share a long sum (one block per output
//   tile walked all T*B rows in series), the segments added in order by a
//   second launch. dKz, dWz and the bias sums, whose one side is a few
//   columns wide, in both modes: `two_cell_dw_narrow_kernel`, a thread per
//   wide column and row segment, then the segments added in order.
// * The bias sums need the unrounded f32 dz, which is never stored: each
//   walk epilogue (and each hand-off block) sums its rows' f32 dz into a
//   partial sum per (step, half tile or hand-off block), and the narrow
//   kernel sums the partials.
// * Every sum is taken in a fixed order by one thread or a fixed tree, with
//   no atomics: two calls give the same bits.
// Known limits of this form: two launches a step, each latency-bound at
// these shapes (the mma.sync tiles at 64 x 128 reach about a tenth of the
// bf16 rate; wgmma, TMA and one persistent launch for all steps are the
// levers); the f32 tiles are FFMA at 32 x 32, two blocks an SM at the f32
// shape. f32 stays exact to JAX's precision="highest": FFMA only, no TF32.
//
// Rounding in the bf16 stream mode, where the Pallas body rounds: dz_e, dz_d
// and dzargs as the operands of their products (the stored dz is bf16 and
// is the operand of the recurrent products, of dx, of dKz and of the four
// tensor-core weight gradients); dxe and dxd as stored; the six weight
// gradients once, after their f32 sums (`_core_bwd`'s casts); the bias sums
// take the unrounded dz (the partial sums) and dza. The gates read the
// stored (rounded) ze and zd.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <cooperative_groups.h>

#include "mma_bf16.cuh"
#include "wgrad.cuh"

namespace {

namespace cg = cooperative_groups;

using cvl_tc::Acc;
using cvl_tc::bf16;
using cvl_tc::kBM;
using cvl_tc::kBN;
using cvl_tc::Operand;

constexpr int kHandoffRows = 4;       // batch rows per hand-off block
constexpr int kHandoffThreads = 256;
// the f32 products: FFMA tiles of kFM x kFN outputs, K chunks of kFK, a
// ring of kFStages stages of both operands with rows of kFS floats
constexpr int kFM = 32, kFN = 32, kFK = 32, kFThreads = 128, kFS = kFK + 4, kFStages = 3;
constexpr int kFStage = kFM * kFS;  // one operand's chunk, [32][kFS]
constexpr int kFSmemFloats = kFStages * 2 * kFStage;

__device__ __forceinline__ float hard_sigmoid(float x) {
  return fminf(fmaxf(0.2f * x + 0.5f, 0.f), 1.f);
}

// d hard_sigmoid / dx expressed through the gate's value, as `_bwd_gate_grads`
__device__ __forceinline__ float hard_sigmoid_grad(float gate) {
  return (gate > 0.f && gate < 1.f) ? 0.2f : 0.f;
}

__device__ __forceinline__ float ldv(const float* p) { return *p; }
__device__ __forceinline__ float ldv(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// the value a product's operand takes in the stream type's mode
template <typename S>
__device__ __forceinline__ float operand(float x) { return x; }
template <>
__device__ __forceinline__ float operand<bf16>(float x) {
  return cvl::round_bf16(x);
}

// `_bwd_gate_grads` of one unit: z its stored pre-activations (i, f, c, o),
// c and cp the cell's c after and before the step; dz gets the unit's four
// pre-activation cotangents, and the next dc carry is returned
__device__ __forceinline__ float gate_grads(const float (&z)[4], float c, float cp, float dh,
                                            float dc_in, float (&dz)[4]) {
  const float ig = hard_sigmoid(z[0]), fg = hard_sigmoid(z[1]);
  const float gg = tanhf(z[2]), og = hard_sigmoid(z[3]);
  const float tc = tanhf(c);
  const float dc = dc_in + dh * og * (1.f - tc * tc);
  dz[0] = dc * gg * hard_sigmoid_grad(ig);
  dz[1] = dc * cp * hard_sigmoid_grad(fg);
  dz[2] = dc * ig * (1.f - gg * gg);
  dz[3] = dh * tc * hard_sigmoid_grad(og);
  return dc * fg;
}

// S is the stream type: float, or bf16 in the bf16 stream mode
template <typename S>
struct WalkArgs {
  const S* zd;                 // [T, B, 4H]
  const float *cd, *cpd, *dhd; // [T, B, H]
  const S *rkd, *rke;          // [H, 4H], read as Rkᵀ [N, K]
  S *dzd, *dze;                // [T, B, 4H]  dz as the products' operand
  float* dh_d;                 // [B, H]  dh0d, written by the last launch
  float* dc_d;                 // [B, H]  the decoder's dc carry (dc0d at the end)
  float* dh_e;                 // [B, H]  the encoder's product (dh0e at the end)
  float* part_d;               // [T * row tiles, 4H]  bias partial sums
  int T, B, H;
};

// The epilogue of walk step t for one half of a BM x BN product tile (rows
// m0 + half BM/2 .., units n0 ..). The two blocks of a cluster each summed
// half of K and staged their f32 sums [BM][kStride] in shared memory; the
// product is t0 + t1 (rank 0's sums + rank 1's), t1 read through the
// cluster. The encoder's job (and, after the last step, t = -1, the
// decoder's) stores the product: the next dh carry. The decoder's job adds
// dhd[t] and runs the gate gradients, writes dz_d(t) (as an operand) and the
// dc carry, and sums its half tile's rows of the f32 dz into part_d (warps
// in order 0 .. 3). Warp w takes rows w, w + 4, ... of the half; lane l the
// units n0 + l + 32 q. `red` holds 16 BN floats.
template <typename S, int BM, int BN, int kStride>
__device__ __forceinline__ void walk_epilogue(const float* t0, const float* t1, float* red,
                                              const WalkArgs<S>& a, int t, bool enc, int half) {
  constexpr int kQ = BN / 32, kHalf = BM / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * BM + half * kHalf, n0 = blockIdx.x * BN, B = a.B, H = a.H;
  const int r0 = half * kHalf;  // the half's first row in the tile
  if (enc || t < 0) {
    float* dh = enc ? a.dh_e : a.dh_d;
    for (int r = warp; r < kHalf && m0 + r < B; r += 4)
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int u = n0 + lane + 32 * q, i = (r0 + r) * kStride + lane + 32 * q;
        if (u < H) dh[(size_t)(m0 + r) * H + u] = t0[i] + t1[i];
      }
    return;
  }
  float db[kQ][4];
#pragma unroll
  for (int q = 0; q < kQ; ++q)
#pragma unroll
    for (int g = 0; g < 4; ++g) db[q][g] = 0.f;
  const size_t tb = (size_t)t * B;
  for (int r = warp; r < kHalf && m0 + r < B; r += 4) {
    const size_t rr = tb + m0 + r;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int u = n0 + lane + 32 * q, i = (r0 + r) * kStride + lane + 32 * q;
      if (u >= H) continue;
      const S* zr = a.zd + rr * 4 * H + u;
      const float z[4] = {ldv(zr), ldv(zr + H), ldv(zr + 2 * H), ldv(zr + 3 * H)};
      const float dh = (t0[i] + t1[i]) + a.dhd[rr * H + u];
      const size_t cu = (size_t)(m0 + r) * H + u;
      float dz[4];
      a.dc_d[cu] = gate_grads(z, a.cd[rr * H + u], a.cpd[rr * H + u], dh, a.dc_d[cu], dz);
      S* out = a.dzd + rr * 4 * H + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        st(out + g * H, dz[g]);
        db[q][g] += dz[g];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q)
#pragma unroll
    for (int g = 0; g < 4; ++g) red[(warp * 4 + g) * BN + lane + 32 * q] = db[q][g];
  __syncthreads();
  float* part = a.part_d + (((size_t)t * gridDim.y + blockIdx.y) * 2 + half) * 4 * H;
  for (int i = threadIdx.x; i < 4 * BN; i += blockDim.x) {
    const int g = i / BN, c = i % BN;
    if (n0 + c < H)
      part[g * H + n0 + c] = red[g * BN + c] + red[(4 + g) * BN + c] + red[(8 + g) * BN + c] +
                             red[(12 + g) * BN + c];
  }
}

// K of a walk step's product is split between the two blocks of a cluster
// (blockIdx.z = 2 job + half): [half kh, ...) with kh a whole number of
// chunks, so each SM holds two blocks' warps and each block half the work
__device__ __forceinline__ void k_half(int K, int chunk, int half, int& k0, int& len) {
  const int kh = (K / 2 + chunk - 1) / chunk * chunk;
  k0 = half ? kh : 0;
  len = half ? max(K - kh, 0) : min(kh, K);
}

// (a) bf16 walk step t (t = -1: the last product only): the decoder's tile
// (job 0) or the encoder's (job 1) of dz(t+1) @ Rkᵀ on the tensor cores, K
// split across the cluster, then the epilogue
__global__ void __cluster_dims__(1, 1, 2) __launch_bounds__(cvl_tc::kThreads)
    two_cell_walk_tc_kernel(const WalkArgs<bf16> a, int t) {
  __shared__ __align__(16) unsigned char smem[cvl_tc::smem_bytes<true>()];
  static_assert(cvl_tc::kTileBytes + 16 * kBN * 4 <= cvl_tc::smem_bytes<true>(),
                "the staged tile and the partial sums fit the ring");
  cg::cluster_group cluster = cg::this_cluster();
  const int half = (int)cluster.block_rank();
  const bool enc = blockIdx.z >= 2;
  const int H4 = 4 * a.H;
  int k0, len;
  k_half(H4, cvl_tc::kBK, half, k0, len);
  Acc acc;
  cvl_tc::zero(acc);
  if (t + 1 < a.T && len > 0) {
    const bf16* dz = (enc ? a.dze : a.dzd) + (size_t)(t + 1) * a.B * H4 + k0;
    cvl_tc::mainloop<false, true>(acc, Operand{dz, a.B, len, H4},
                                  Operand{(enc ? a.rke : a.rkd) + k0, a.H, len, H4},
                                  blockIdx.y * kBM, blockIdx.x * kBN, len, smem);
  }
  float* tile = cvl_tc::stage_acc(acc, smem);
  cluster.sync();  // both halves' sums are staged
  const float* t0 = cluster.map_shared_rank(tile, 0);
  const float* t1 = cluster.map_shared_rank(tile, 1);
  float* red = reinterpret_cast<float*>(smem) + kBM * cvl_tc::kTileStride;
  walk_epilogue<bf16, kBM, kBN, cvl_tc::kTileStride>(t0, t1, red, a, t, enc, half);
  cluster.sync();  // the peer has read this block's sums
}

// acc[i][q] (row ty + 16 i, column tx + 8 q of the block's kFM x kFN tile;
// ty = thread / 8, tx = thread % 8) += A [M, K] (row-major, lda) times B
// stored [N, K] (ldb), on FFMA, over K in chunks of kFK through a ring of
// kFStages cp.async stages in `sm` (kFSmemFloats). Each stage holds both
// operands' chunks row by row ([32][kFS], K contiguous), so the inner loop
// reads four k at once (float4) from rows whose 16-byte groups fall on
// distinct banks. K, lda, ldb are multiples of 4 and the bases 16-byte
// aligned; chunks outside M, N or K read as zeros. Each output is summed by
// one thread over k in order.
__device__ __forceinline__ void ffma_mainloop(float (&acc)[2][4], const float* __restrict__ A,
                                              int M, int lda, const float* __restrict__ Bt,
                                              int N, int ldb, int m0, int n0, int K, float* sm) {
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

// (a) f32 walk step t: the tile of dz(t+1) @ Rkᵀ on FFMA, K split across
// the cluster, then the epilogue
__global__ void __cluster_dims__(1, 1, 2) __launch_bounds__(kFThreads)
    two_cell_walk_f32_kernel(const WalkArgs<float> a, int t) {
  __shared__ __align__(16) float sm[kFSmemFloats];
  static_assert(kFM * (kFN + 4) + 16 * kFN <= kFSmemFloats, "tile and partial sums fit");
  cg::cluster_group cluster = cg::this_cluster();
  const int half = (int)cluster.block_rank();
  const bool enc = blockIdx.z >= 2;
  const int H4 = 4 * a.H;
  int k0, len;
  k_half(H4, kFK, half, k0, len);
  float acc[2][4] = {};
  if (t + 1 < a.T && len > 0)
    ffma_mainloop(acc, (enc ? a.dze : a.dzd) + (size_t)(t + 1) * a.B * H4 + k0, a.B, H4,
                  (enc ? a.rke : a.rkd) + k0, a.H, H4, blockIdx.y * kFM, blockIdx.x * kFN, len,
                  sm);
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) sm[(ty + 16 * i) * (kFN + 4) + tx + 8 * q] = acc[i][q];
  cluster.sync();  // both halves' sums are staged
  walk_epilogue<float, kFM, kFN, kFN + 4>(cluster.map_shared_rank(sm, 0),
                                          cluster.map_shared_rank(sm, 1),
                                          sm + kFM * (kFN + 4), a, t, enc, half);
  cluster.sync();  // the peer has read this block's sums
}

template <typename S>
struct HandoffArgs {
  const S *dzd, *ze;                   // [T, B, 4H]
  const S *kz, *wz;                    // [L, 4H], [H, 2L]
  const float *ce, *cpe;               // [T, B, H]
  const float *eps, *zargs, *dzargs;   // [T, B, L], [T, B, 2L], [T, B, 2L]
  const float* dh_e;                   // [B, H]  the encoder's product of step t
  float* dc_e;                         // [B, H]  the encoder's dc carry (dc0e at the end)
  S* dze;                              // [T, B, 4H]
  float *dza, *zs;                     // [T, B, 2L], [T, B, L]
  float* part_e;                       // [T * row groups, 4H]  bias partial sums
  int T, B, H, L;
};

// (b) the z hand-off and the encoder's step t for kHandoffRows batch rows:
// dzz = dz_d(t) @ Kzᵀ (the warps split the columns; lanes' sums added in a
// fixed butterfly, warps in order), the z-sample backward (dza, and z for
// dKz), then per
// unit (a thread each, over the block's rows in order) dh = dh_e + dza @ Wzᵀ
// and the encoder's gate gradients; the rows' f32 dz_e summed into part_e
template <typename S>
__global__ void __launch_bounds__(kHandoffThreads)
    two_cell_handoff_kernel(const HandoffArgs<S> a, int t) {
  extern __shared__ float dzas[];  // [kHandoffRows][2L]  dzargs as an operand
  constexpr int kWarps = kHandoffThreads / 32, kLG = 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int B = a.B, H = a.H, L = a.L, H4 = 4 * H, s0 = blockIdx.x * kHandoffRows;
  const int RL = kHandoffRows * L;
  float* wsum = dzas + 2 * RL;  // [kWarps][kHandoffRows][L]
  const size_t tb = (size_t)t * B;
  // dzz = dz_d(t) @ Kzᵀ: warp w takes columns [w per, (w + 1) per) of every
  // row and latent (kLG latents a pass), lane l the columns l, l + 32, ...
  // of them; a butterfly adds the lanes, then the warps are added in order
  const int per = (H4 + kWarps - 1) / kWarps, j0 = warp * per, j1 = min(H4, j0 + per);
  for (int l0 = 0; l0 < L; l0 += kLG) {
    const int nl = min(kLG, L - l0);
    float acc[kHandoffRows][kLG];
#pragma unroll
    for (int r = 0; r < kHandoffRows; ++r)
#pragma unroll
      for (int i = 0; i < kLG; ++i) acc[r][i] = 0.f;
    for (int j = j0 + lane; j < j1; j += 32) {
      float d[kHandoffRows], k[kLG];
#pragma unroll
      for (int r = 0; r < kHandoffRows; ++r)
        d[r] = s0 + r < B ? ldv(a.dzd + (tb + s0 + r) * H4 + j) : 0.f;
#pragma unroll
      for (int i = 0; i < kLG; ++i) k[i] = i < nl ? ldv(a.kz + (size_t)(l0 + i) * H4 + j) : 0.f;
#pragma unroll
      for (int r = 0; r < kHandoffRows; ++r)
#pragma unroll
        for (int i = 0; i < kLG; ++i) acc[r][i] = fmaf(d[r], k[i], acc[r][i]);
    }
#pragma unroll
    for (int r = 0; r < kHandoffRows; ++r)
#pragma unroll
      for (int i = 0; i < kLG; ++i) {
        float v = acc[r][i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0 && i < nl) wsum[warp * RL + r * L + l0 + i] = v;
      }
  }
  __syncthreads();
  // the z-sample backward (dza, and z for dKz), a thread per row and latent
  for (int p = threadIdx.x; p < RL; p += kHandoffThreads) {
    const int r = p / L, l = p % L, s = s0 + r;
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += wsum[w * RL + p];
    float dzm = 0.f, dzlv = 0.f;
    if (s < B) {
      const size_t rr = tb + s;
      const float sig = expf(a.zargs[rr * 2 * L + L + l] / 2.f), e = a.eps[rr * L + l];
      dzm = v + a.dzargs[rr * 2 * L + l];
      dzlv = v * e * sig * 0.5f + a.dzargs[rr * 2 * L + L + l];
      a.dza[rr * 2 * L + l] = dzm;
      a.dza[rr * 2 * L + L + l] = dzlv;
      a.zs[rr * L + l] = a.zargs[rr * 2 * L + l] + sig * e;
    }
    dzas[r * 2 * L + l] = operand<S>(dzm);
    dzas[r * 2 * L + L + l] = operand<S>(dzlv);
  }
  __syncthreads();
  for (int u = threadIdx.x; u < H; u += kHandoffThreads) {
    // the z heads' cotangent dza @ Wzᵀ of the block's rows, Wz's row u read once
    float dhez[kHandoffRows];
#pragma unroll
    for (int r = 0; r < kHandoffRows; ++r) dhez[r] = 0.f;
    const S* wr = a.wz + (size_t)u * 2 * L;
    for (int j = 0; j < 2 * L; ++j) {
      const float w = ldv(wr + j);
#pragma unroll
      for (int r = 0; r < kHandoffRows; ++r) dhez[r] = fmaf(dzas[r * 2 * L + j], w, dhez[r]);
    }
    float db[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kHandoffRows; ++r) {
      if (s0 + r >= B) continue;
      const size_t rr = tb + s0 + r, cu = (size_t)(s0 + r) * H + u;
      const S* zr = a.ze + rr * H4 + u;
      const float z[4] = {ldv(zr), ldv(zr + H), ldv(zr + 2 * H), ldv(zr + 3 * H)};
      float dz[4];
      a.dc_e[cu] = gate_grads(z, a.ce[rr * H + u], a.cpe[rr * H + u], a.dh_e[cu] + dhez[r],
                              a.dc_e[cu], dz);
      S* out = a.dze + rr * H4 + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        st(out + g * H, dz[g]);
        db[g] += dz[g];
      }
    }
    float* part = a.part_e + ((size_t)t * gridDim.x + blockIdx.x) * H4 + u;
#pragma unroll
    for (int g = 0; g < 4; ++g) part[g * H] = db[g];
  }
}

// (c) dx = dz @ Wᵀ over the T*B rows, the decoder's job (blockIdx.z 0) or the
// encoder's (1), W [IN, 4H] read as Wᵀ's [N, K]; stored rounded, as bf16
struct DxJob {
  Operand dz, w;  // dz [R, 4H]; w [IN, 4H]
  bf16* dx;       // [R, IN]
};

__global__ void __launch_bounds__(cvl_tc::kThreads)
    two_cell_dx_tc_kernel(const DxJob dec, const DxJob enc) {
  __shared__ __align__(16) unsigned char smem[cvl_tc::smem_bytes<true>()];
  const DxJob& j = blockIdx.z ? enc : dec;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN, R = j.dz.rows, N = j.w.rows;
  if (n0 >= N) return;
  Acc acc;
  cvl_tc::zero(acc);
  cvl_tc::mainloop<false, true>(acc, j.dz, j.w, m0, n0, j.dz.cols, smem);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + cvl_tc::acc_row(mi, q), col = n0 + cvl_tc::acc_col(ni, q);
        if (row < R && col < N) j.dx[(size_t)row * N + col] = __float2bfloat16_rn(acc[mi][ni][q]);
      }
}

struct DxJobF32 {
  const float *dz, *w;  // dz [R, 4H]; w [IN, 4H]
  float* dx;            // [R, IN]
  int N;                // IN
};

// (c) the same in f32, on FFMA
__global__ void __launch_bounds__(kFThreads)
    two_cell_dx_f32_kernel(const DxJobF32 dec, const DxJobF32 enc, int R, int H4) {
  __shared__ __align__(16) float sm[kFSmemFloats];
  const DxJobF32& j = blockIdx.z ? enc : dec;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  if (n0 >= j.N) return;
  float acc[2][4] = {};
  ffma_mainloop(acc, j.dz, R, H4, j.w, j.N, H4, m0, n0, H4, sm);
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + ty + 16 * i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = n0 + tx + 8 * q;
      if (row < R && col < j.N) j.dx[(size_t)row * j.N + col] = acc[i][q];
    }
  }
}

// (d) the bf16 weight gradients C [M, N] = aᵀ b over the R = T*B rows on the
// tensor cores (a [R, M] read transposed, b [R, N] = bf16 dz), stored rounded
// once, as bf16: dRk_e, dWe, dRk_d, dWdx, one launch, a job's tiles after
// the one before
struct DwJob {
  Operand a, b;
  bf16* c;
  int M;  // rows of C stored (a.cols may hold zero pad columns past them)
  int tiles_n, first_block;
};
struct DwArgs {
  DwJob jobs[4];
  int njobs;
};

__global__ void __launch_bounds__(cvl_tc::kThreads) two_cell_dw_tc_kernel(const DwArgs args) {
  __shared__ __align__(16) unsigned char smem[cvl_tc::kSmemBytes];
  int j = 0;
  while (j + 1 < args.njobs && (int)blockIdx.x >= args.jobs[j + 1].first_block) ++j;
  const DwJob& jb = args.jobs[j];
  const int local = blockIdx.x - jb.first_block;
  const int m0 = (local / jb.tiles_n) * kBM, n0 = (local % jb.tiles_n) * kBN;
  Acc acc;
  cvl_tc::zero(acc);
  cvl_tc::mainloop<true>(acc, jb.a, jb.b, m0, n0, jb.a.rows, smem);
  const int M = jb.M, N = jb.b.cols;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + cvl_tc::acc_row(mi, q), col = n0 + cvl_tc::acc_col(ni, q);
        if (row < M && col < N) jb.c[(size_t)row * N + col] = __float2bfloat16_rn(acc[mi][ni][q]);
      }
}

struct two_cell_wgrad {};  // names this source's copy of cvl::wgrad_kernel

int cdiv(int a, int b) { return (a + b - 1) / b; }

// bias partial sums per step: the decoder's (two half tiles per walk row
// tile) or the encoder's (one per hand-off block)
int part_count(int B, bool bf16_mode, bool decoder) {
  return decoder ? 2 * cdiv(B, bf16_mode ? kBM : kFM) : cdiv(B, kHandoffRows);
}

// a walk step's grid: units x row tiles x (2 jobs x 2 halves of K)
int walk_step(const WalkArgs<bf16>& a, int t, cudaStream_t st) {
  two_cell_walk_tc_kernel<<<dim3(cdiv(a.H, kBN), cdiv(a.B, kBM), 4), cvl_tc::kThreads, 0, st>>>(
      a, t);
  return (int)cudaGetLastError();
}

int walk_step(const WalkArgs<float>& a, int t, cudaStream_t st) {
  two_cell_walk_f32_kernel<<<dim3(cdiv(a.H, kFN), cdiv(a.B, kFM), 4), kFThreads, 0, st>>>(a, t);
  return (int)cudaGetLastError();
}

// the 2T + 1 launches of the walk, in order
template <typename S>
int walk(const WalkArgs<S>& w, const HandoffArgs<S>& h, cudaStream_t st) {
  // dzargs as an operand, and the warps' sums of dz_d @ Kzᵀ
  const size_t smem = (size_t)(2 + kHandoffThreads / 32) * kHandoffRows * h.L * sizeof(float);
  const int blocks = cdiv(h.B, kHandoffRows);
  for (int t = w.T - 1; t >= 0; --t) {
    int err = walk_step(w, t, st);
    if (err) return err;
    two_cell_handoff_kernel<S><<<blocks, kHandoffThreads, smem, st>>>(h, t);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return walk_step(w, -1, st);
}

// (e) the weight gradients with one narrow side, C = sum_r S[r, s] W[r, w]
// for s < ns (a few) and w < nw (many): dKz (S = z, W = dz_d), dWz (S = dza,
// W = he; C stored [nw, ns]) and the bias sums (S = ones; W = dza, or the
// walk's partial sums). The rows are cut into kNarrowSegs segments; one
// thread per w and segment adds the segment's rows in order for kNarrow s
// at a time (a 64 x 64 tile of wgrad.cuh would spend most of its products
// on the empty rows of a narrow side); the second launch adds each
// element's segments in order and stores it, rounded to bf16 where the job
// says so.
constexpr int kNarrow = 16, kNarrowThreads = 256, kNarrowSegs = 64, kNarrowJobs = 5;

struct NarrowJob {
  const float* S;  // [R, ns] (null: ones, ns = 1)
  const void* W;   // [R, nw], f32 or (w_bf16) bf16
  void* C;         // [ns, nw], or [nw, ns] with c_t; bf16 with c_bf16, else f32
  int ns, nw, R;
  int s_round, w_bf16, c_bf16, c_t;  // s_round: S rounded to bf16 as an operand
  int seg_rows, segs, wblocks, first_block;
  size_t poff, eoff;
};
struct NarrowArgs {
  NarrowJob jobs[kNarrowJobs];
  int njobs;
  float* partial;  // [segs][ns][nw] per job
};

__global__ void __launch_bounds__(kNarrowThreads) two_cell_dw_narrow_kernel(const NarrowArgs args) {
  int j = 0;
  while (j + 1 < args.njobs && (int)blockIdx.x >= args.jobs[j + 1].first_block) ++j;
  const NarrowJob jb = args.jobs[j];
  const int local = blockIdx.x - jb.first_block, seg = local / jb.wblocks;
  const int w = (local % jb.wblocks) * kNarrowThreads + threadIdx.x;
  if (w >= jb.nw) return;
  const int r0 = seg * jb.seg_rows, r1 = min(jb.R, r0 + jb.seg_rows);
  for (int s0 = 0; s0 < jb.ns; s0 += kNarrow) {
    float acc[kNarrow];
#pragma unroll
    for (int i = 0; i < kNarrow; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const size_t iw = (size_t)r * jb.nw + w;
      const float wv = jb.w_bf16 ? ldv(static_cast<const bf16*>(jb.W) + iw)
                                 : static_cast<const float*>(jb.W)[iw];
#pragma unroll
      for (int i = 0; i < kNarrow; ++i) {
        if (s0 + i >= jb.ns) break;
        float sv = jb.S ? jb.S[(size_t)r * jb.ns + s0 + i] : 1.f;
        if (jb.s_round) sv = cvl::round_bf16(sv);
        acc[i] = fmaf(sv, wv, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kNarrow; ++i)
      if (s0 + i < jb.ns)
        args.partial[jb.poff + ((size_t)seg * jb.ns + s0 + i) * jb.nw + w] = acc[i];
  }
}

__global__ void __launch_bounds__(kNarrowThreads)
    two_cell_dw_narrow_finish_kernel(const NarrowArgs args, size_t elems) {
  const size_t e = (size_t)blockIdx.x * kNarrowThreads + threadIdx.x;
  if (e >= elems) return;
  int j = 0;
  while (j + 1 < args.njobs && e >= args.jobs[j + 1].eoff) ++j;
  const NarrowJob& jb = args.jobs[j];
  const size_t ic = e - jb.eoff, per = (size_t)jb.ns * jb.nw;
  float v = 0.f;
  for (int seg = 0; seg < jb.segs; ++seg) v += args.partial[jb.poff + seg * per + ic];
  const size_t s = ic / jb.nw, w = ic % jb.nw, at = jb.c_t ? w * jb.ns + s : ic;
  if (jb.c_bf16)
    static_cast<bf16*>(jb.C)[at] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(jb.C)[at] = v;
}

// The narrow jobs of either mode (`b`: the bf16 mode's rounding): dKz, dWz,
// dbz, dbe, dbd. Fills `a` and returns the first launch's blocks; `floats`
// and `elems` get the partial sums' floats and the output elements.
int narrow_plan(NarrowArgs& a, const float* zs, const void* dzd, const float* dza,
                const void* he, const float* part_e, const float* part_d, void* dkz, void* dwz,
                float* dbz, float* dbe, float* dbd, int T, int B, int H, int L, int b,
                size_t& floats, size_t& elems) {
  const int R = T * B, H4 = 4 * H;
  const NarrowJob jobs[kNarrowJobs] = {
      {zs, dzd, dkz, L, H4, R, b, b, b, 0},
      {dza, he, dwz, 2 * L, H, R, b, b, b, 1},
      {nullptr, dza, dbz, 1, 2 * L, R},
      {nullptr, part_e, dbe, 1, H4, T * part_count(B, b, false)},
      {nullptr, part_d, dbd, 1, H4, T * part_count(B, b, true)},
  };
  a = NarrowArgs{};
  a.njobs = kNarrowJobs;
  int blocks = 0;
  floats = elems = 0;
  for (int j = 0; j < kNarrowJobs; ++j) {
    NarrowJob jb = jobs[j];
    jb.seg_rows = cdiv(jb.R, kNarrowSegs);
    jb.segs = cdiv(jb.R, jb.seg_rows);
    jb.wblocks = cdiv(jb.nw, kNarrowThreads);
    jb.first_block = blocks;
    jb.poff = floats;
    jb.eoff = elems;
    blocks += jb.segs * jb.wblocks;
    floats += (size_t)jb.segs * jb.ns * jb.nw;
    elems += (size_t)jb.ns * jb.nw;
    a.jobs[j] = jb;
  }
  return blocks;
}

int narrow_grads(const float* zs, const void* dzd, const float* dza, const void* he,
                 const float* part_e, const float* part_d, void* dkz, void* dwz, float* dbz,
                 float* dbe, float* dbd, float* scratch, int T, int B, int H, int L, int b,
                 cudaStream_t st) {
  NarrowArgs a;
  size_t floats, elems;
  const int blocks = narrow_plan(a, zs, dzd, dza, he, part_e, part_d, dkz, dwz, dbz, dbe, dbd, T,
                                 B, H, L, b, floats, elems);
  a.partial = scratch;
  two_cell_dw_narrow_kernel<<<blocks, kNarrowThreads, 0, st>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  two_cell_dw_narrow_finish_kernel<<<(unsigned)((elems + kNarrowThreads - 1) / kNarrowThreads),
                                     kNarrowThreads, 0, st>>>(a, elems);
  return (int)cudaGetLastError();
}

// the f32 mode's recurrent and input weight gradients on wgrad.cuh
int wide_jobs(cvl::WgradJob* jobs, const void* hpe, const void* xe, const void* dze,
              const void* hpd, const void* xd, const void* dzd, void* drke, void* dwe, void* drkd,
              void* dwdx, int INe, int INd, int H) {
  const int H4 = 4 * H;
  jobs[0] = {hpe, dze, drke, H, H4};
  jobs[1] = {xe, dze, dwe, INe, H4};
  jobs[2] = {hpd, dzd, drkd, H, H4};
  jobs[3] = {xd, dzd, dwdx, INd, H4};
  return 4;
}

// rows a segment of the split wgrad.cuh sums: the T*B rows are walked by
// many blocks at once, not by one block per output tile
constexpr int kSegRows = 256;

// the scratch of the gradient products: the split wgrad.cuh sums (f32 mode),
// then the narrow jobs' partial sums
size_t wide_floats(int T, int B, int INe, int INd, int H, int b) {
  if (b) return 0;
  cvl::WgradJob jobs[4];
  wide_jobs(jobs, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
            nullptr, nullptr, INe, INd, H);
  return cvl::wgrad_split_floats(jobs, 4, T * B, kSegRows);
}

}  // namespace

// Each entry point queues its launches on `stream` and returns the first
// nonzero cudaError_t of a launch (0 when all were taken).

// Bias partial sums per step (the wrapper sizes part_e and part_d as
// [T * count, 4H]): the decoder's half tiles or the hand-off blocks.
extern "C" int cvl_two_cell_part_count(int B, int bf16_mode, int decoder) {
  return part_count(B, bf16_mode, decoder);
}

// Floats of the scratch the gradient products need (the segments' partial
// sums of the weight gradients)
extern "C" long long cvl_two_cell_grads_scratch(int T, int B, int INe, int INd, int H, int L,
                                                int bf16_mode) {
  NarrowArgs a;
  size_t floats, elems;
  narrow_plan(a, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr, nullptr, T, B, H, L, bf16_mode, floats, elems);
  return (long long)(wide_floats(T, B, INe, INd, H, bf16_mode) + floats);
}

// The reverse walk, f32: fills dze, dzd [T, B, 4H] (the products' operand),
// dza [T, B, 2L], zs [T, B, L], the bias partial sums, dh0e, dh0d, and the
// carries dc0e, dc0d (zeroed by the caller). 2T + 1 launches.
extern "C" int cvl_two_cell_walk(const float* ze, const float* zd, const float* cpe,
                                 const float* ce, const float* cpd, const float* cd,
                                 const float* eps, const float* zargs, const float* dhd,
                                 const float* dzargs, const float* rke, const float* rkd,
                                 const float* kz, const float* wz, float* dze, float* dzd,
                                 float* dza, float* zs, float* part_e, float* part_d, float* dh0e,
                                 float* dc0e, float* dh0d, float* dc0d, int T, int B, int H, int L,
                                 void* stream) {
  const WalkArgs<float> w{zd, cd, cpd, dhd, rkd, rke, dzd, dze, dh0d, dc0d, dh0e, part_d, T, B, H};
  const HandoffArgs<float> h{dzd, ze, kz, wz, ce, cpe, eps, zargs, dzargs, dh0e, dc0e, dze,
                             dza, zs, part_e, T, B, H, L};
  return walk(w, h, static_cast<cudaStream_t>(stream));
}

// The same in the bf16 stream mode: ze, zd, rke, rkd, kz, wz and dze, dzd
// are bf16 (dz rounded as an operand); the rest f32.
extern "C" int cvl_two_cell_walk_bf16(const void* ze, const void* zd, const float* cpe,
                                      const float* ce, const float* cpd, const float* cd,
                                      const float* eps, const float* zargs, const float* dhd,
                                      const float* dzargs, const void* rke, const void* rkd,
                                      const void* kz, const void* wz, void* dze, void* dzd,
                                      float* dza, float* zs, float* part_e, float* part_d,
                                      float* dh0e, float* dc0e, float* dh0d, float* dc0d, int T,
                                      int B, int H, int L, void* stream) {
  const auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  const auto out = [](void* p) { return static_cast<bf16*>(p); };
  const WalkArgs<bf16> w{in(zd), cd, cpd, dhd, in(rkd), in(rke), out(dzd), out(dze),
                         dh0d, dc0d, dh0e, part_d, T, B, H};
  const HandoffArgs<bf16> h{in(dzd), in(ze), in(kz), in(wz), ce, cpe, eps, zargs, dzargs, dh0e,
                            dc0e, out(dze), dza, zs, part_e, T, B, H, L};
  return walk(w, h, static_cast<cudaStream_t>(stream));
}

// The gradient products after the f32 walk: dxe, dxd (one FFMA launch); the
// recurrent and input weight gradients on wgrad.cuh, the rows split into
// segments (two launches); dKz, dWz and the bias sums (two launches).
// `scratch` holds cvl_two_cell_grads_scratch floats.
extern "C" int cvl_two_cell_grads(const float* dze, const float* dzd, const float* dza,
                                  const float* zs, const float* part_e, const float* part_d,
                                  const float* hpe, const float* he, const float* hpd,
                                  const float* xe, const float* xd, const float* we,
                                  const float* wdx, float* dxe, float* dxd, float* drke,
                                  float* dwe, float* dbe, float* drkd, float* dwdx, float* dkz,
                                  float* dbd, float* dwz, float* dbz, float* scratch, int T,
                                  int B, int INe, int INd, int H, int L, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = T * B, H4 = 4 * H;
  two_cell_dx_f32_kernel<<<dim3(cdiv(INe > INd ? INe : INd, kFN), cdiv(R, kFM), 2), kFThreads, 0,
                           st>>>(DxJobF32{dzd, wdx, dxd, INd}, DxJobF32{dze, we, dxe, INe}, R, H4);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  cvl::WgradJob jobs[4];
  wide_jobs(jobs, hpe, xe, dze, hpd, xd, dzd, drke, dwe, drkd, dwdx, INe, INd, H);
  const int e = cvl::launch_wgrad_split<two_cell_wgrad>(jobs, 4, R, kSegRows, scratch, st);
  if (e) return e;
  return narrow_grads(zs, dzd, dza, he, part_e, part_d, dkz, dwz, dbz, dbe, dbd,
                      scratch + wide_floats(T, B, INe, INd, H, 0), T, B, H, L, 0, st);
}

// The same after the bf16 walk: dxe, dxd stored bf16 (one tensor-core
// launch); dRk_e, dWe, dRk_d, dWdx on the tensor cores (one launch; xe and
// xd [T*B, round8(IN)] with their rows padded by zeros to whole 16-byte
// chunks, so that they stage by cp.async); dKz, dWz and the bias sums (two
// launches). hpe, he, hpd, xe, xd, we, wdx, dze, dzd and the six weight
// gradients are bf16.
extern "C" int cvl_two_cell_grads_bf16(const void* dze, const void* dzd, const float* dza,
                                       const float* zs, const float* part_e,
                                       const float* part_d, const void* hpe, const void* he,
                                       const void* hpd, const void* xe, const void* xd,
                                       const void* we, const void* wdx, void* dxe, void* dxd,
                                       void* drke, void* dwe, float* dbe, void* drkd, void* dwdx,
                                       void* dkz, float* dbd, void* dwz, float* dbz,
                                       float* scratch, int T, int B, int INe, int INd, int H,
                                       int L, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = T * B, H4 = 4 * H;
  const auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  const auto out = [](void* p) { return static_cast<bf16*>(p); };
  const DxJob dec{Operand{in(dzd), R, H4, H4}, Operand{in(wdx), INd, H4, H4}, out(dxd)};
  const DxJob enc{Operand{in(dze), R, H4, H4}, Operand{in(we), INe, H4, H4}, out(dxe)};
  two_cell_dx_tc_kernel<<<dim3(cdiv(INe > INd ? INe : INd, kBN), cdiv(R, kBM), 2),
                          cvl_tc::kThreads, 0, st>>>(dec, enc);
  int err = (int)cudaGetLastError();
  if (err) return err;
  DwArgs dw{};
  const Operand dz_e{in(dze), R, H4, H4}, dz_d{in(dzd), R, H4, H4};
  const int INep = cdiv(INe, 8) * 8, INdp = cdiv(INd, 8) * 8;
  const Operand lhs[4] = {Operand{in(hpe), R, H, H}, Operand{in(xe), R, INep, INep},
                          Operand{in(hpd), R, H, H}, Operand{in(xd), R, INdp, INdp}};
  const int rows[4] = {H, INe, H, INd};
  bf16* dst[4] = {out(drke), out(dwe), out(drkd), out(dwdx)};
  int blocks = 0;
  for (int j = 0; j < 4; ++j) {
    const int tn = cdiv(H4, kBN);
    dw.jobs[j] = DwJob{lhs[j], j < 2 ? dz_e : dz_d, dst[j], rows[j], tn, blocks};
    blocks += cdiv(rows[j], kBM) * tn;
  }
  dw.njobs = 4;
  two_cell_dw_tc_kernel<<<blocks, cvl_tc::kThreads, 0, st>>>(dw);
  err = (int)cudaGetLastError();
  if (err) return err;
  return narrow_grads(zs, dzd, dza, he, part_e, part_d, dkz, dwz, dbz, dbe, dbd, scratch, T, B,
                      H, L, 1, st);
}
