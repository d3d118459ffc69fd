// The cl_vae dense stack in the bf16 mode for Hopper (sm_90a), forward and
// backward: the wide layers as products over the whole batch on the tensor
// cores, the narrow ones and the elementwise steps in row kernels.
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_vae.py
//   * :214 `_fwd_call` -> `_fwd_kernel` :133 in the bf16 mode
//     (`vae_apply_core(compute_dtype=bf16)`, bf16 weights): one wrapper call
//     of 3 launches (`cvl_vae_tc_fwd`, at the end);
//   * :358 `_bwd_call` -> `_bwd_kernel` :230 in the bf16 mode: one wrapper
//     call of 8 launches (9 when B > kSegRows).
// The f32 mode of both stays in csrc/vae_dense.cu.
//
// The forward, per batch row (D frame width, Cw key-encoder width, H hidden
// width, L latent width, K key classes, K1 = K - 1):
//   a1    = relu(x @ Whw + bhw)                              [Cw]
//   wargs = a1 @ [Wwm | Wwv] + [bwm | bwv]                   [2 K1]
//   w     = softmax([wargs[:K1] + exp(wargs[K1:] / 2) eps_w, 0])   [K]
//   a2    = relu((x @ Whx + w @ Whw2) + bh)                  [H]
//   zargs = a2 @ [Wzm | Wzv] + [bzm | bzv]                   [2L]
//   z     = zargs[:L] + exp(zargs[L:] / 2) eps_z
//   a3    = relu(((w @ Wdw + z @ Wdz) + bd) [+ x_prev @ Wdxp])   [H]
//   xhat  = sigmoid(a3 @ Wxh + bxh)                          [D]
// (the JAX kernel's order of the sums, pallas_vae.py:141-162). Rounding,
// where the TPU kernel rounds: each product's left operand (x, x_prev, a1,
// w, a2, z, a3) is bf16 and the products accumulate in f32; a1, a2 and a3
// are written as f32 holding their bf16 values; the noise, the biases and
// every other stream stay f32.
//
// What bounds the forward. At the main path's shape (B=100, D=1,024,
// Cw=256, H=1,024, L=16, K=13, no x_prev) it is 0.49 GFLOP of bf16 products
// (0.0005 ms at 989 TFLOP/s) against 6.5 MB of weights and rows (0.0019 ms
// at 3.35 TB/s): bytes bound it, far below the cost of a launch. The first
// design ran the whole chain in one block of 4 rows, every block reading
// every weight from L2 (~118 MB of L2 reads at B=100, 25 blocks on 132
// SMs), every product on FFMA, the narrow layers leaving most threads idle.
//
// What the forward's design does about it.
// * One product launch for everything that does not depend on w: a1 (with
//   bhw, the ReLU and the rounding in the epilogue), x @ Whx and, with
//   x_prev, x_prev @ Wdxp (kept f32, to be added in the JAX order), three
//   jobs of one grid over the whole batch, each weight read in its stored
//   layout [in, out] once a call (the `vae_tc_product_kernel` of the
//   backward, kBT = false, K split over an 8-block cluster and summed
//   through distributed shared memory in rank order).
// * One row kernel, kRows rows a block, for the narrow chain: the w heads
//   and the z heads (`narrow_head`: the warps split the weight's rows, the
//   lanes its columns, so a warp reads a row of the weight coalesced; the
//   warps' sums added in order), the softmax with the pinned zero logit,
//   a2 and a3 a thread a unit (K and K + L terms), the z sample.
// * One product launch for a3 @ Wxh, the bias and the sigmoid in the
//   epilogue.
// * Every sum in a fixed order, no atomics: two calls give the same bits.
//
// The backward, per batch row, from the
// cotangents of xhat, wargs, zargs, w and the forward's residuals:
//   dxh  = dxhat xhat (1 - xhat)                        frame head
//   dd   = (dxh @ Wxhᵀ) (a3 > 0)                        decoder
//   dw1  = dw + dd @ Wdwᵀ;  dz = dd @ Wdzᵀ;  dxp = dd @ Wdxpᵀ
//   dza  = [dz + dzargs[:L], dz eps_z sig_z / 2 + dzargs[L:]]   z sample
//   dh   = (dza @ Wzzᵀ) (a2 > 0)                        latent encoder
//   dx1  = dh @ Whxᵀ;  dw2 = dw1 + dh @ Whw2ᵀ
//   dwa  = the softmax backward of dw2 (the pinned zero logit dropped),
//          then the w sample's                          w heads
//   dhw  = (dwa @ Wwzᵀ) (a1 > 0)                        key encoder
//   dx   = dx1 + dhw @ Whwᵀ
// and every weight gradient (aᵀ of the layer's input times its
// pre-activation cotangent, over the B rows) and bias sum.
//
// Rounding, where the TPU kernel rounds: each product's left operand is
// rounded to bf16 (dxh, dd, dza, dh, dwa, dhw, and
// a3, x, xp, w, z, a1, a2 as the weight gradients' operands); the weight
// gradients are summed in f32 and rounded once, as bf16; the bias sums take
// the unrounded f32 cotangents; dx and dxp are stored in bf16.
//
// What bounds the backward. At the main path's shape (B=100, D=1,024,
// Cw=256, H=1,024, L=16, K=13, no x_prev) it is 1.4 GFLOP of bf16 products
// (0.0014 ms at 989 TFLOP/s) against 6.6 MB of weights, residuals and
// gradients (0.0020 ms at 3.35 TB/s): bytes bound it, far below the cost of
// a launch. The layers run in a chain of six dependent launches.
//
// What the backward's design does about it.
// * The wide layers (dxh @ Wxhᵀ, dh @ Whxᵀ, dd @ Wdxpᵀ, dhw @ Whwᵀ) are one
//   tensor-core product each over the whole batch (csrc/mma_bf16.cuh's
//   mma.sync mainloop, 64 x 128 tiles, each weight read in its stored layout
//   [N, K]: nothing is transposed), so each weight is read about once a call
//   (the first design's 4-row blocks each read every weight from L2, 25
//   blocks on 132 SMs at B=100). B=100 is two row tiles, so K of each tile
//   is split over an 8-block cluster: each block sums an eighth of K,
//   stages its sums in shared memory, and after a cluster barrier each
//   block takes 8 of the tile's rows, adding the 8 blocks' sums through
//   distributed shared memory in rank order. The epilogue applies the ReLU
//   mask (or adds dx1), and writes the f32 value the bias sums need and the
//   rounded copy the next product reads.
// * The narrow layers (29 columns of dd @ [Wdw | Wdz]ᵀ, 13 of dh @ Whw2ᵀ, and
//   dza @ Wzzᵀ, dwa @ Wwzᵀ with K = 2L and 2 K1) and the elementwise steps
//   run in two row kernels of kRows rows a block: the dot products along
//   the weights' rows with the columns split between the warps (each
//   warp's lanes added in a fixed butterfly, the warps in order), the z and
//   w sample backward, the softmax backward, and per unit the narrow
//   product with its ReLU mask.
// * The wide weight gradients (dWxh, dWhx, dWhw, dWdxp) are tensor-core
//   products over the B rows (the left operand read transposed, kAT), one
//   launch; the narrow ones (dWdw, dWdz, dWhw2, dWzz, dWwz) and the bias sums
//   are csrc/wgrad.cuh jobs, one launch (two, its rows split into segments,
//   when B > kSegRows).
// * Every sum is taken in a fixed order by one thread, a fixed butterfly or
//   the cluster's rank order, with no atomics: two calls give the same bits.
// Operand widths D, H and Cw that are not multiples of 8 are staged by the
// mainloop element by element (correct, slower); every config the port
// trains has them as multiples of 8.

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
using cvl_tc::kBK;
using cvl_tc::kBM;
using cvl_tc::kBN;
using cvl_tc::Operand;

constexpr int kSplit = 8;          // K of a row-chain product split over an 8-block cluster
constexpr int kRowThreads = 256;   // the row kernels
constexpr int kWarps = kRowThreads / 32;
constexpr int kRows = 4;           // batch rows a row-kernel block
constexpr int kLG = 8;             // outputs a pass of row_dots
constexpr int kSegRows = 128;      // rows a segment of the split wgrad.cuh sums

__device__ __forceinline__ float ldb(const bf16* p) { return __bfloat162float(*p); }

// (a) dxh = dxhat xhat (1 - xhat), f32 and rounded (the first product's
// operand); a3 rounded (dWxh's operand)
__global__ void __launch_bounds__(kRowThreads)
    vae_tc_head_kernel(const float* dxhat, const float* xhat, const float* a3, float* dxh,
                       bf16* dxh_b, bf16* a3_b, size_t nd, size_t nh) {
  const size_t step = (size_t)gridDim.x * kRowThreads;
  for (size_t i = (size_t)blockIdx.x * kRowThreads + threadIdx.x; i < nd; i += step) {
    const float xh = xhat[i];
    const float v = dxhat[i] * xh * (1.f - xh);
    dxh[i] = v;
    dxh_b[i] = __float2bfloat16_rn(v);
  }
  for (size_t i = (size_t)blockIdx.x * kRowThreads + threadIdx.x; i < nh; i += step)
    a3_b[i] = __float2bfloat16_rn(a3[i]);
}

// A wide layer: out = a [M, K] @ b, b a weight as stored: [N, K] (a
// transposed product of the backward, kBT) or [K, N] (the forward's); then
// the epilogue v = add + out, zero where mask <= 0 (the backward's), or
// v = out + bias, then the activation, rounded to a bf16 value with `round`
// (the forward's), stored f32 and/or as bf16
enum Act { kNone = 0, kRelu = 1, kSigmoid = 2 };
struct ProdJob {
  Operand a, b;
  const float* add;   // [M, N] or null
  const float* mask;  // [M, N] (a ReLU's post-activation) or null
  const float* bias;  // [N] or null
  float* out;         // [M, N] or null
  bf16* out_b;        // [M, N] or null
  int act, round;
};

// one of three kernel parameters, chosen field by field (a reference chosen
// at run time would copy them to the stack)
__device__ __forceinline__ Operand pick(const Operand& a, const Operand& b, bool second) {
  return Operand{second ? b.p : a.p, second ? b.rows : a.rows, second ? b.cols : a.cols,
                 second ? b.ld : a.ld};
}
__device__ __forceinline__ ProdJob pick(const ProdJob& a, const ProdJob& b, bool second) {
  return ProdJob{pick(a.a, b.a, second),         pick(a.b, b.b, second),
                 second ? b.add : a.add,         second ? b.mask : a.mask,
                 second ? b.bias : a.bias,       second ? b.out : a.out,
                 second ? b.out_b : a.out_b,     second ? b.act : a.act,
                 second ? b.round : a.round};
}

// (b) blockIdx.z = kSplit job + rank: rank r sums its share of K (whole
// chunks, in order), then takes rows [r kBM / kSplit, ...) of the tile,
// adding the ranks' staged sums in rank order
template <bool kBT>
__global__ void __cluster_dims__(1, 1, kSplit) __launch_bounds__(cvl_tc::kThreads)
    vae_tc_product_kernel(const ProdJob j0, const ProdJob j1, const ProdJob j2) {
  __shared__ __align__(16) unsigned char smem[cvl_tc::smem_bytes<kBT>()];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int job = blockIdx.z / kSplit;
  const ProdJob j = pick(pick(j0, j1, job == 1), j2, job == 2);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int M = j.a.rows, N = kBT ? j.b.rows : j.b.cols, K = j.a.cols;
  const int per = ((K + kBK - 1) / kBK + kSplit - 1) / kSplit * kBK;
  const int k0 = rank * per, len = min(per, K - k0);
  Acc acc;
  cvl_tc::zero(acc);
  if (n0 < N && len > 0)
    cvl_tc::mainloop<false, kBT>(
        acc, Operand{j.a.p + k0, M, len, j.a.ld},
        kBT ? Operand{j.b.p + k0, N, len, j.b.ld}
            : Operand{j.b.p + (size_t)k0 * j.b.ld, len, N, j.b.ld},
        m0, n0, len, smem);
  const float* tile = cvl_tc::stage_acc(acc, smem);
  cluster.sync();  // every rank's sums are staged
  const float* peer[kSplit];
#pragma unroll
  for (int s = 0; s < kSplit; ++s) peer[s] = cluster.map_shared_rank(tile, s);
  constexpr int kRowsPer = kBM / kSplit;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = warp; rr < kRowsPer; rr += cvl_tc::kThreads / 32) {
    const int r = rank * kRowsPer + rr, m = m0 + r;
    if (m >= M || n0 >= N) break;
#pragma unroll
    for (int q = 0; q < kBN / 32; ++q) {
      const int c = lane + 32 * q, n = n0 + c;
      if (n >= N) break;
      float v = peer[0][r * cvl_tc::kTileStride + c];
#pragma unroll
      for (int s = 1; s < kSplit; ++s) v += peer[s][r * cvl_tc::kTileStride + c];
      const size_t o = (size_t)m * N + n;
      if (j.add) v = j.add[o] + v;
      if (j.mask && !(j.mask[o] > 0.f)) v = 0.f;
      if (j.bias) v = v + j.bias[n];
      if (j.act == kRelu) v = fmaxf(v, 0.f);
      if (j.act == kSigmoid) v = 1.f / (1.f + expf(-v));
      if (j.round) v = cvl::round_bf16(v);
      if (j.out) j.out[o] = v;
      if (j.out_b) j.out_b[o] = __float2bfloat16_rn(v);
    }
  }
  cluster.sync();  // the peers have read this block's sums
}

// out[r nj + j] = sum_c a[s0 + r, c] w_j[c] over c < n, for the block's
// kRows rows and the nj = n0j + n1j rows w_j of two row-major weights (w0
// [n0j, n], w1 [n1j, n]): warp w takes the columns [w per, (w + 1) per),
// lane l of them l, l + 32, ... in order; a butterfly adds the lanes' sums,
// then the warps' are added in order. `wsum` holds kWarps kRows nj floats.
__device__ __forceinline__ void row_dots(const bf16* a, int B, int s0, int n, const bf16* w0,
                                         int n0j, const bf16* w1, int n1j, float* out,
                                         float* wsum) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nj = n0j + n1j;
  const int per = (n + kWarps - 1) / kWarps, c0 = warp * per, c1 = min(n, c0 + per);
  for (int j0 = 0; j0 < nj; j0 += kLG) {
    float acc[kRows][kLG];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < kLG; ++i) acc[r][i] = 0.f;
    for (int c = c0 + lane; c < c1; c += 32) {
      float av[kRows], wv[kLG];
#pragma unroll
      for (int r = 0; r < kRows; ++r) av[r] = s0 + r < B ? ldb(a + (size_t)(s0 + r) * n + c) : 0.f;
#pragma unroll
      for (int i = 0; i < kLG; ++i) {
        const int jj = j0 + i;
        wv[i] = jj < n0j ? ldb(w0 + (size_t)jj * n + c)
                : jj < nj ? ldb(w1 + (size_t)(jj - n0j) * n + c)
                          : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < kLG; ++i) acc[r][i] = fmaf(av[r], wv[i], acc[r][i]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < kLG; ++i) {
        float v = acc[r][i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0 && j0 + i < nj) wsum[(warp * kRows + r) * nj + j0 + i] = v;
      }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < kRows * nj; p += kRowThreads) {
    float v = wsum[p];
    for (int w = 1; w < kWarps; ++w) v += wsum[w * kRows * nj + p];
    out[p] = v;
  }
  __syncthreads();
}

// out[s, u] = (sum_j op[r j] w[u, j]) (mask[s, u] > 0) for the block's rows
// s = s0 + r and every unit u < U: a thread per unit reads the row of the
// narrow weight w [U, J] once for the block's rows; op [kRows][J] in shared
// memory. Stored f32 and rounded.
__device__ __forceinline__ void narrow_cols(const float* op, const bf16* w, int J, int U,
                                            const float* mask, int B, int s0, float* out,
                                            bf16* out_b) {
  for (int u = threadIdx.x; u < U; u += kRowThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    const bf16* wr = w + (size_t)u * J;
    for (int jj = 0; jj < J; ++jj) {
      const float wv = ldb(wr + jj);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(op[r * J + jj], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (s0 + r >= B) break;
      const size_t o = (size_t)(s0 + r) * U + u;
      const float v = mask[o] > 0.f ? acc[r] : 0.f;
      out[o] = v;
      out_b[o] = __float2bfloat16_rn(v);
    }
  }
}

struct LatentArgs {
  const bf16 *dd_b, *wdw, *wdz, *wzz;              // [B, H], [K, H], [L, H], [H, 2L]
  const float *dw, *zargs, *eps_z, *dzargs, *a2;   // [B, K], [B, 2L], [B, L], [B, 2L], [B, H]
  float *dw1, *dza, *zs, *dh;                      // [B, K], [B, 2L], [B, L], [B, H]
  bf16* dh_b;                                      // [B, H]
  int B, H, L, K;
};

// (c) the decoder's narrow outputs, the z sample backward and the latent
// encoder's pre-activation cotangent, kRows rows a block
__global__ void __launch_bounds__(kRowThreads) vae_tc_latent_kernel(const LatentArgs a) {
  extern __shared__ float sm[];
  const int B = a.B, H = a.H, L = a.L, K = a.K, nj = K + L, s0 = blockIdx.x * kRows;
  float* dots = sm;                    // [kRows][K + L]  dd @ [Wdw | Wdz]ᵀ
  float* dzas = dots + kRows * nj;     // [kRows][2L]  dza as an operand
  float* wsum = dzas + kRows * 2 * L;  // [kWarps][kRows][K + L]
  row_dots(a.dd_b, B, s0, H, a.wdw, K, a.wdz, L, dots, wsum);
  for (int p = threadIdx.x; p < kRows * nj; p += kRowThreads) {
    const int r = p / nj, j = p % nj, s = s0 + r;
    if (j < K) {
      if (s < B) a.dw1[(size_t)s * K + j] = a.dw[(size_t)s * K + j] + dots[p];
      continue;
    }
    const int l = j - K;
    float dzm = 0.f, dzv = 0.f;
    if (s < B) {
      const size_t o = (size_t)s * 2 * L;
      const float sig = expf(a.zargs[o + L + l] / 2.f), e = a.eps_z[(size_t)s * L + l];
      const float dz = dots[p];
      dzm = dz + a.dzargs[o + l];
      dzv = dz * e * sig * 0.5f + a.dzargs[o + L + l];
      a.dza[o + l] = dzm;
      a.dza[o + L + l] = dzv;
      a.zs[(size_t)s * L + l] = a.zargs[o + l] + sig * e;
    }
    dzas[r * 2 * L + l] = cvl::round_bf16(dzm);
    dzas[r * 2 * L + L + l] = cvl::round_bf16(dzv);
  }
  __syncthreads();
  narrow_cols(dzas, a.wzz, 2 * L, H, a.a2, B, s0, a.dh, a.dh_b);
}

struct KeyArgs {
  const bf16 *dh_b, *whw2, *wwz;                        // [B, H], [K, H], [Cw, 2 K1]
  const float *dw1, *w, *wargs, *eps_w, *dwargs, *a1;   // [B, K], [B, K], [B, 2 K1],
                                                        // [B, K1], [B, 2 K1], [B, Cw]
  float *dwa, *dhw;                                     // [B, 2 K1], [B, Cw]
  bf16* dhw_b;                                          // [B, Cw]
  int B, H, Cw, K;
};

// (d) the latent encoder's share of dw, the softmax and w sample backward
// (a thread per row) and the key encoder's pre-activation cotangent
__global__ void __launch_bounds__(kRowThreads) vae_tc_key_kernel(const KeyArgs a) {
  extern __shared__ float sm[];
  const int B = a.B, K = a.K, K1 = K - 1, s0 = blockIdx.x * kRows;
  float* dots = sm;                     // [kRows][K]  dh @ Whw2ᵀ, then dw2
  float* dwas = dots + kRows * K;       // [kRows][2 K1]  dwa as an operand
  float* wsum = dwas + kRows * 2 * K1;  // [kWarps][kRows][K]
  row_dots(a.dh_b, B, s0, a.H, a.whw2, K, nullptr, 0, dots, wsum);
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x, s = s0 + r;
    float* dw2 = dots + r * K;
    float dot = 0.f;
    if (s < B)
      for (int j = 0; j < K; ++j) {
        dw2[j] = a.dw1[(size_t)s * K + j] + dw2[j];
        dot += dw2[j] * a.w[(size_t)s * K + j];
      }
    for (int j = 0; j < K1; ++j) {
      float dwm = 0.f, dwv = 0.f;
      if (s < B) {
        const size_t o = (size_t)s * 2 * K1;
        const float dl = a.w[(size_t)s * K + j] * (dw2[j] - dot);
        const float sig = expf(a.wargs[o + K1 + j] / 2.f), e = a.eps_w[(size_t)s * K1 + j];
        dwm = dl + a.dwargs[o + j];
        dwv = dl * e * sig * 0.5f + a.dwargs[o + K1 + j];
        a.dwa[o + j] = dwm;
        a.dwa[o + K1 + j] = dwv;
      }
      dwas[r * 2 * K1 + j] = cvl::round_bf16(dwm);
      dwas[r * 2 * K1 + K1 + j] = cvl::round_bf16(dwv);
    }
  }
  __syncthreads();
  narrow_cols(dwas, a.wwz, 2 * K1, a.Cw, a.a1, B, s0, a.dhw, a.dhw_b);
}

// (e) the wide weight gradients C [M, N] = aᵀ b over the B rows on the
// tensor cores (a [B, M] read transposed, b [B, N]), stored rounded once,
// as bf16; a job's tiles after the one before
struct DwJob {
  Operand a, b;
  bf16* c;
  int tiles_n, first_block;
};
struct DwArgs {
  DwJob jobs[4];
  int njobs;
};

__global__ void __launch_bounds__(cvl_tc::kThreads) vae_tc_dw_kernel(const DwArgs args) {
  __shared__ __align__(16) unsigned char smem[cvl_tc::kSmemBytes];
  int j = 0;
  while (j + 1 < args.njobs && (int)blockIdx.x >= args.jobs[j + 1].first_block) ++j;
  const DwJob& jb = args.jobs[j];
  const int local = blockIdx.x - jb.first_block;
  const int m0 = (local / jb.tiles_n) * kBM, n0 = (local % jb.tiles_n) * kBN;
  Acc acc;
  cvl_tc::zero(acc);
  cvl_tc::mainloop<true>(acc, jb.a, jb.b, m0, n0, jb.a.rows, smem);
  const int M = jb.a.cols, N = jb.b.cols;
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

// ------------------------------------------------------------------ forward

// The forward's row kernel: 16 warps, so that each walks a short run of a
// narrow weight's rows (its time is a chain of L2 round trips)
constexpr int kFwdThreads = 512;
constexpr int kFwdWarps = kFwdThreads / 32;

// out[r][j] = bias[j] + sum_c a(c)[r] w[c J + j] over c < n for the block's
// kRows rows and the J columns of a narrow weight w [n, J] as stored: warp
// w of kFwdWarps takes the rows c of w in [w per, (w + 1) per) in order,
// lane l column j0 + l of each pass of 32 columns (a coalesced read of a row
// of w); the warps' sums are added in warp order, then the bias. `av(c)`
// gives the block's rows of the operand at c (a float4: kRows = 4); `part`
// holds kFwdWarps kRows 32 floats. Ends with a block barrier.
template <typename A>
__device__ __forceinline__ void narrow_head(A av, int n, const bf16* w, int J, const float* bias,
                                            float* out, float* part) {
  static_assert(kRows == 4, "a float4 of operands");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per = (n + kFwdWarps - 1) / kFwdWarps, c0 = warp * per, c1 = min(n, c0 + per);
  for (int j0 = 0; j0 < J; j0 += 32) {
    const int j = j0 + lane;
    float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
    if (j < J) {
#pragma unroll 16
      for (int c = c0; c < c1; ++c) {
        const float wv = ldb(w + (size_t)c * J + j);
        const float4 a = av(c);
        acc[0] = fmaf(a.x, wv, acc[0]);
        acc[1] = fmaf(a.y, wv, acc[1]);
        acc[2] = fmaf(a.z, wv, acc[2]);
        acc[3] = fmaf(a.w, wv, acc[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[(warp * kRows + r) * 32 + lane] = acc[r];
    __syncthreads();
    for (int p = threadIdx.x; p < kRows * 32; p += kFwdThreads) {
      const int r = p / 32, jj = j0 + p % 32;
      if (jj >= J) continue;
      float v = part[p];
      for (int w2 = 1; w2 < kFwdWarps; ++w2) v += part[w2 * kRows * 32 + p];
      out[r * J + jj] = v + bias[jj];
    }
    __syncthreads();
  }
}

struct FwdRowArgs {
  const float *a1, *xh, *xpd;               // [B, Cw], [B, H], [B, H] (or null)
  const float *eps_w, *eps_z;               // [B, K-1], [B, L]
  const bf16 *wwz, *whw2, *wzz, *wdw, *wdz;  // [Cw, 2 K1], [K, H], [H, 2L], [K, H], [L, H]
  const float *bwz, *bh, *bzz, *bd;         // [2 K1], [H], [2L], [H]
  float *wargs, *w, *a2, *zargs, *a3;       // [B, 2 K1], [B, K], [B, H], [B, 2L], [B, H]
  bf16* a3_b;                               // [B, H]
  int B, Cw, H, L, K;
};

// (f2) the narrow chain of kRows rows a block: the w heads, the logistic-normal
// sample (softmax with the pinned zero logit), a2 = relu((x part + w @ Whw2)
// + bh), the z heads, the z sample, a3 = relu(((w @ Wdw + z @ Wdz) + bd) +
// x_prev part); the products' left operands (w, a2, z) rounded to bf16, a2
// and a3 stored as f32 holding their rounded values, a3 also as bf16 (the
// frame head's operand)
__global__ void __launch_bounds__(kFwdThreads) vae_tc_fwd_rows_kernel(const FwdRowArgs a) {
  extern __shared__ float sm[];
  const int B = a.B, Cw = a.Cw, H = a.H, L = a.L, K = a.K, K1 = K - 1;
  const int s0 = blockIdx.x * kRows;
  float* was = sm;                    // [kRows][2 K1]
  float* ws = was + kRows * 2 * K1;   // [K][kRows]  w rounded (a product operand)
  float* zas = ws + K * kRows;        // [kRows][2L]
  float* zs = zas + kRows * 2 * L;    // [L][kRows]  z rounded
  float* a2s = zs + L * kRows;        // [H][kRows]  a2 (rounded)
  float* part = a2s + H * kRows;      // [kFwdWarps][kRows][32]
  const auto row = [&](int r) { return s0 + r < B ? s0 + r : -1; };
  // w heads: wargs = a1 @ [Wwm | Wwv] + [bwm | bwv], a1 read as stored
  narrow_head(
      [&](int c) {
        float v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = row(r) >= 0 ? a.a1[(size_t)row(r) * Cw + c] : 0.f;
        return make_float4(v[0], v[1], v[2], v[3]);
      },
      Cw, a.wwz, 2 * K1, a.bwz, was, part);
  for (int p = threadIdx.x; p < kRows * 2 * K1; p += kFwdThreads) {
    const int r = p / (2 * K1);
    if (row(r) >= 0) a.wargs[(size_t)row(r) * 2 * K1 + p % (2 * K1)] = was[p];
  }
  // logistic-normal sample: softmax over the K-1 noisy logits and the pinned
  // zero logit, one thread a row
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x, s = row(r);
    float m = 0.f;  // the zero logit
    for (int j = 0; j < K1; ++j) {
      const float e = s >= 0 ? a.eps_w[(size_t)s * K1 + j] : 0.f;
      const float wn = was[r * 2 * K1 + j] + expf(was[r * 2 * K1 + K1 + j] / 2.f) * e;
      ws[j * kRows + r] = wn;
      m = fmaxf(m, wn);
    }
    ws[K1 * kRows + r] = 0.f;
    float sum = 0.f;
    for (int j = 0; j < K; ++j) {
      const float e = expf(ws[j * kRows + r] - m);
      ws[j * kRows + r] = e;
      sum += e;
    }
    for (int j = 0; j < K; ++j) {
      const float v = ws[j * kRows + r] / sum;
      ws[j * kRows + r] = cvl::round_bf16(v);
      if (s >= 0) a.w[(size_t)s * K + j] = v;
    }
  }
  __syncthreads();
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  // latent encoder: a2 = relu((x @ Whx + w @ Whw2) + bh), a thread a unit
  for (int n = threadIdx.x; n < H; n += kFwdThreads) {
    float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int j = 0; j < K; ++j) {
      const float wv = ldb(a.whw2 + (size_t)j * H + n);
      const float4 o = w4[j];
      acc[0] = fmaf(o.x, wv, acc[0]);
      acc[1] = fmaf(o.y, wv, acc[1]);
      acc[2] = fmaf(o.z, wv, acc[2]);
      acc[3] = fmaf(o.w, wv, acc[3]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int s = row(r);
      float v = 0.f;
      if (s >= 0) {
        v = cvl::round_bf16(fmaxf((a.xh[(size_t)s * H + n] + acc[r]) + a.bh[n], 0.f));
        a.a2[(size_t)s * H + n] = v;
      }
      a2s[n * kRows + r] = v;
    }
  }
  __syncthreads();
  // z heads: zargs = a2 @ [Wzm | Wzv] + [bzm | bzv]
  const float4* a24 = reinterpret_cast<const float4*>(a2s);
  narrow_head([&](int c) { return a24[c]; }, H, a.wzz, 2 * L, a.bzz, zas, part);
  for (int p = threadIdx.x; p < kRows * 2 * L; p += kFwdThreads) {
    const int r = p / (2 * L);
    if (row(r) >= 0) a.zargs[(size_t)row(r) * 2 * L + p % (2 * L)] = zas[p];
  }
  // z sample, rounded (the decoder's operand)
  for (int i = threadIdx.x; i < L * kRows; i += kFwdThreads) {
    const int l = i / kRows, r = i - l * kRows, s = row(r);
    const float e = s >= 0 ? a.eps_z[(size_t)s * L + l] : 0.f;
    zs[i] = cvl::round_bf16(zas[r * 2 * L + l] + expf(zas[r * 2 * L + L + l] / 2.f) * e);
  }
  __syncthreads();
  // decoder: a3 = relu(((w @ Wdw + z @ Wdz) + bd) [+ x_prev @ Wdxp]), a thread a unit
  const float4* z4 = reinterpret_cast<const float4*>(zs);
  for (int n = threadIdx.x; n < H; n += kFwdThreads) {
    float dw[kRows] = {0.f, 0.f, 0.f, 0.f}, dz[kRows] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int j = 0; j < K; ++j) {
      const float wv = ldb(a.wdw + (size_t)j * H + n);
      const float4 o = w4[j];
      dw[0] = fmaf(o.x, wv, dw[0]);
      dw[1] = fmaf(o.y, wv, dw[1]);
      dw[2] = fmaf(o.z, wv, dw[2]);
      dw[3] = fmaf(o.w, wv, dw[3]);
    }
#pragma unroll 8
    for (int l = 0; l < L; ++l) {
      const float wv = ldb(a.wdz + (size_t)l * H + n);
      const float4 o = z4[l];
      dz[0] = fmaf(o.x, wv, dz[0]);
      dz[1] = fmaf(o.y, wv, dz[1]);
      dz[2] = fmaf(o.z, wv, dz[2]);
      dz[3] = fmaf(o.w, wv, dz[3]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int s = row(r);
      if (s < 0) continue;
      const size_t o = (size_t)s * H + n;
      float v = (dw[r] + dz[r]) + a.bd[n];
      if (a.xpd) v = v + a.xpd[o];
      v = cvl::round_bf16(fmaxf(v, 0.f));
      a.a3[o] = v;
      a.a3_b[o] = __float2bfloat16_rn(v);
    }
  }
}

size_t fwd_rows_smem(int H, int L, int K) {
  return (size_t)(kRows * (2 * (K - 1) + K + 3 * L + H) + kFwdWarps * kRows * 32) * sizeof(float);
}

struct vae_tc_wgrad {};  // names this source's copy of cvl::wgrad_kernel

int cdiv(int a, int b) { return (a + b - 1) / b; }
size_t up8(size_t n) { return (n + 7) / 8 * 8; }  // 16-byte starts for both types

// The backward's scratch, carved from one f32 and one bf16 buffer: the
// layers' f32 cotangents (for the bias sums and the narrow weight
// gradients), dx1, the rounded operands; then the split wgrad.cuh sums
struct Scratch {
  float *dxh, *dd, *dw1, *dza, *zs, *dh, *dx1, *dwa, *dhw, *wg;
  bf16 *dxh_b, *a3_b, *dd_b, *dh_b, *dhw_b;
  size_t floats, halves;
};

Scratch carve(float* f, bf16* h, int B, int D, int Cw, int H, int L, int K, size_t wg_floats) {
  Scratch s{};
  size_t o = 0;
  auto take = [&](size_t n) {
    float* p = f ? f + o : nullptr;
    o += up8(n);
    return p;
  };
  s.dxh = take((size_t)B * D);
  s.dd = take((size_t)B * H);
  s.dw1 = take((size_t)B * K);
  s.dza = take((size_t)B * 2 * L);
  s.zs = take((size_t)B * L);
  s.dh = take((size_t)B * H);
  s.dx1 = take((size_t)B * D);
  s.dwa = take((size_t)B * 2 * (K - 1));
  s.dhw = take((size_t)B * Cw);
  s.wg = take(wg_floats);
  s.floats = o;
  size_t q = 0;
  auto take_b = [&](size_t n) {
    bf16* p = h ? h + q : nullptr;
    q += up8(n);
    return p;
  };
  s.dxh_b = take_b((size_t)B * D);
  s.a3_b = take_b((size_t)B * H);
  s.dd_b = take_b((size_t)B * H);
  s.dh_b = take_b((size_t)B * H);
  s.dhw_b = take_b((size_t)B * Cw);
  s.halves = q;
  return s;
}

// the narrow weight gradients and the bias sums as wgrad.cuh jobs (bf16:
// both operands rounded as staged, C stored rounded; b_bf16: Bm stored in
// bf16); returns their count
int narrow_jobs(cvl::WgradJob* jobs, const Scratch& s, const float* w, const float* a1,
                const float* a2, void* dwdw, void* dwdz, void* dwhw2, void* dwzz, void* dwwz,
                float* dbxh, float* dbd, float* dbzz, float* dbh, float* dbwz, float* dbhw, int D,
                int Cw, int H, int L, int K) {
  const int K2 = 2 * (K - 1);
  const cvl::WgradJob list[] = {
      {w, s.dd_b, dwdw, K, H, 1, 0, 0, 1},    {s.zs, s.dd_b, dwdz, L, H, 1, 0, 0, 1},
      {w, s.dh_b, dwhw2, K, H, 1, 0, 0, 1},   {a2, s.dza, dwzz, H, 2 * L, 1},
      {a1, s.dwa, dwwz, Cw, K2, 1},           {nullptr, s.dxh, dbxh, 1, D},
      {nullptr, s.dd, dbd, 1, H},             {nullptr, s.dza, dbzz, 1, 2 * L},
      {nullptr, s.dh, dbh, 1, H},             {nullptr, s.dwa, dbwz, 1, K2},
      {nullptr, s.dhw, dbhw, 1, Cw},
  };
  const int n = (int)(sizeof(list) / sizeof(list[0]));
  for (int i = 0; i < n; ++i) jobs[i] = list[i];
  return n;
}

size_t wgrad_floats(int B, int D, int Cw, int H, int L, int K) {
  if (B <= kSegRows) return 0;
  cvl::WgradJob jobs[cvl::kWgMaxJobs];
  const int n = narrow_jobs(jobs, Scratch{}, nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, D, Cw, H, L, K);
  return cvl::wgrad_split_floats(jobs, n, B, kSegRows);
}

size_t row_smem(int nj, int nop) {
  return (size_t)(kRows * nj + kRows * nop + kWarps * kRows * nj) * sizeof(float);
}

}  // namespace

// Floats (f32) and elements (bf16) of the two scratch buffers the backward
// needs at these widths.
extern "C" long long cvl_vae_tc_bwd_scratch(int B, int D, int Cw, int H, int L, int K,
                                            int bf16_elems) {
  const Scratch s = carve(nullptr, nullptr, B, D, Cw, H, L, K, wgrad_floats(B, D, Cw, H, L, K));
  return (long long)(bf16_elems ? s.halves : s.floats);
}

// The bf16-mode backward on `stream`, 8 launches (9 when B > kSegRows): the
// frame head; dd = dxh @ Wxhᵀ; the decoder's narrow outputs, the z sample
// and dh; dx1 = dh @ Whxᵀ (and dxp = dd @ Wdxpᵀ); the w side and dhw;
// dx = dx1 + dhw @ Whwᵀ; the wide weight gradients; the narrow ones and the
// bias sums. x, xp, the weights (as stored), dx, dxp and the weight
// gradients are bf16, the rest f32; xp, wdxp, dxp and dwdxp are null without
// use_x_prev. `scratch` and `scratch_b` hold cvl_vae_tc_bwd_scratch floats
// and bf16 elements. Returns the first nonzero cudaError_t of a launch.
extern "C" int cvl_vae_tc_bwd(
    const void* x, const void* xp, const float* eps_w, const float* eps_z, const float* a1,
    const float* a2, const float* a3, const float* xhat, const float* wargs, const float* zargs,
    const float* w, const float* dxhat, const float* dwargs, const float* dzargs,
    const float* dw, const void* whw, const void* wwz, const void* whx, const void* whw2,
    const void* wzz, const void* wdw, const void* wdxp, const void* wdz, const void* wxh,
    void* dx, void* dxp, void* dwhw, float* dbhw, void* dwwz, float* dbwz, void* dwhx,
    void* dwhw2, float* dbh, void* dwzz, float* dbzz, void* dwdw, void* dwdxp, void* dwdz,
    float* dbd, void* dwxh, float* dbxh, float* scratch, void* scratch_b, int B, int D, int Cw,
    int H, int L, int K, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  const auto out = [](void* p) { return static_cast<bf16*>(p); };
  const bool use_xp = xp != nullptr;
  const Scratch s = carve(scratch, static_cast<bf16*>(scratch_b), B, D, Cw, H, L, K,
                          wgrad_floats(B, D, Cw, H, L, K));
  int err;
  const int head_blocks = cdiv((B * (D > H ? D : H) + kRowThreads - 1) / kRowThreads, 4);
  vae_tc_head_kernel<<<head_blocks, kRowThreads, 0, st>>>(dxhat, xhat, a3, s.dxh, s.dxh_b,
                                                          s.a3_b, (size_t)B * D, (size_t)B * H);
  if ((err = (int)cudaGetLastError())) return err;
  const auto product = [&](const ProdJob& j0, const ProdJob* j1) {
    const int N = j1 && j1->b.rows > j0.b.rows ? j1->b.rows : j0.b.rows;
    const dim3 grid(cdiv(N, kBN), cdiv(B, kBM), kSplit * (j1 ? 2 : 1));
    vae_tc_product_kernel<true><<<grid, cvl_tc::kThreads, 0, st>>>(j0, j1 ? *j1 : j0, j0);
    return (int)cudaGetLastError();
  };
  // dd = (dxh @ Wxhᵀ) (a3 > 0)
  if ((err = product(ProdJob{Operand{s.dxh_b, B, D, D}, Operand{in(wxh), H, D, D}, nullptr, a3,
                             nullptr, s.dd, s.dd_b},
                     nullptr)))
    return err;
  const int rblocks = cdiv(B, kRows);
  const LatentArgs la{s.dd_b, in(wdw),  in(wdz), in(wzz), dw,  zargs, eps_z, dzargs, a2,
                      s.dw1,  s.dza,    s.zs,    s.dh,    s.dh_b, B,  H,     L,      K};
  vae_tc_latent_kernel<<<rblocks, kRowThreads, row_smem(K + L, 2 * L), st>>>(la);
  if ((err = (int)cudaGetLastError())) return err;
  // dx1 = dh @ Whxᵀ; dxp = dd @ Wdxpᵀ
  const ProdJob jxp{Operand{s.dd_b, B, H, H}, Operand{in(wdxp), D, H, H}, nullptr, nullptr,
                    nullptr, nullptr, out(dxp)};
  if ((err = product(ProdJob{Operand{s.dh_b, B, H, H}, Operand{in(whx), D, H, H}, nullptr,
                             nullptr, nullptr, s.dx1, nullptr},
                     use_xp ? &jxp : nullptr)))
    return err;
  const KeyArgs ka{s.dh_b, in(whw2), in(wwz), s.dw1, w, wargs, eps_w, dwargs, a1,
                   s.dwa,  s.dhw,    s.dhw_b, B,     H, Cw,    K};
  vae_tc_key_kernel<<<rblocks, kRowThreads, row_smem(K, 2 * (K - 1)), st>>>(ka);
  if ((err = (int)cudaGetLastError())) return err;
  // dx = dx1 + dhw @ Whwᵀ
  if ((err = product(ProdJob{Operand{s.dhw_b, B, Cw, Cw}, Operand{in(whw), D, Cw, Cw}, s.dx1,
                             nullptr, nullptr, nullptr, out(dx)},
                     nullptr)))
    return err;
  // dWxh = a3ᵀ dxh, dWhx = xᵀ dh, dWhw = xᵀ dhw, dWdxp = xpᵀ dd
  DwArgs wide_args{};
  const DwJob wide[4] = {
      {Operand{s.a3_b, B, H, H}, Operand{s.dxh_b, B, D, D}, out(dwxh)},
      {Operand{in(x), B, D, D}, Operand{s.dh_b, B, H, H}, out(dwhx)},
      {Operand{in(x), B, D, D}, Operand{s.dhw_b, B, Cw, Cw}, out(dwhw)},
      {Operand{in(xp), B, D, D}, Operand{s.dd_b, B, H, H}, out(dwdxp)},
  };
  wide_args.njobs = use_xp ? 4 : 3;
  int blocks = 0;
  for (int i = 0; i < wide_args.njobs; ++i) {
    wide_args.jobs[i] = wide[i];
    wide_args.jobs[i].tiles_n = cdiv(wide[i].b.cols, kBN);
    wide_args.jobs[i].first_block = blocks;
    blocks += cdiv(wide[i].a.cols, kBM) * wide_args.jobs[i].tiles_n;
  }
  vae_tc_dw_kernel<<<blocks, cvl_tc::kThreads, 0, st>>>(wide_args);
  if ((err = (int)cudaGetLastError())) return err;
  cvl::WgradJob jobs[cvl::kWgMaxJobs];
  const int n = narrow_jobs(jobs, s, w, a1, a2, dwdw, dwdz, dwhw2, dwzz, dwwz, dbxh, dbd, dbzz,
                            dbh, dbwz, dbhw, D, Cw, H, L, K);
  if (B > kSegRows) return cvl::launch_wgrad_split<vae_tc_wgrad>(jobs, n, B, kSegRows, s.wg, st);
  return cvl::launch_wgrad<vae_tc_wgrad>(jobs, n, B, st);
}

// Floats (f32) and elements (bf16) of the two scratch buffers the forward
// needs: the x part of the latent encoder's pre-activation and, with
// use_x_prev, of the decoder's ([B, H] f32 each); a3 as the frame head's
// operand ([B, H] bf16).
extern "C" long long cvl_vae_tc_fwd_scratch(int B, int H, int use_xp, int bf16_elems) {
  return (long long)(bf16_elems ? up8((size_t)B * H) : up8((size_t)B * H) * (1 + use_xp));
}

// The bf16-mode forward on `stream`, 3 launches: the products that do not
// depend on w (a1 = relu(x @ Whw + bhw), rounded; x @ Whx; x_prev @ Wdxp)
// over the whole batch; the narrow chain, kRows rows a block; xhat =
// sigmoid(a3 @ Wxh + bxh). x, xp and the weights (as stored, [in, out]) are
// bf16, the rest f32; xp and wdxp are null without use_x_prev; `scratch` and
// `scratch_b` hold cvl_vae_tc_fwd_scratch floats and bf16 elements. Returns
// the first nonzero cudaError_t of a launch.
extern "C" int cvl_vae_tc_fwd(
    const void* x, const void* xp, const float* eps_w, const float* eps_z, const void* whw,
    const float* bhw, const void* wwz, const float* bwz, const void* whx, const void* whw2,
    const float* bh, const void* wzz, const float* bzz, const void* wdw, const void* wdxp,
    const void* wdz, const float* bd, const void* wxh, const float* bxh, float* xhat,
    float* wargs, float* zargs, float* w, float* a1, float* a2, float* a3, float* scratch,
    void* scratch_b, int B, int D, int Cw, int H, int L, int K, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  const bool use_xp = xp != nullptr;
  float* xh = scratch;
  float* xpd = use_xp ? scratch + up8((size_t)B * H) : nullptr;
  bf16* a3_b = static_cast<bf16*>(scratch_b);
  int err;
  // a1 = relu(x @ Whw + bhw), rounded; x @ Whx; x_prev @ Wdxp
  const ProdJob ja1{Operand{in(x), B, D, D}, Operand{in(whw), D, Cw, Cw}, nullptr, nullptr, bhw,
                    a1, nullptr, kRelu, 1};
  const ProdJob jxh{Operand{in(x), B, D, D}, Operand{in(whx), D, H, H}, nullptr, nullptr, nullptr,
                    xh, nullptr, kNone, 0};
  const ProdJob jxp{Operand{in(xp), B, D, D}, Operand{in(wdxp), D, H, H}, nullptr, nullptr,
                    nullptr, xpd, nullptr, kNone, 0};
  const dim3 g1(cdiv(Cw > H ? Cw : H, kBN), cdiv(B, kBM), kSplit * (use_xp ? 3 : 2));
  vae_tc_product_kernel<false><<<g1, cvl_tc::kThreads, 0, st>>>(ja1, jxh, use_xp ? jxp : jxh);
  if ((err = (int)cudaGetLastError())) return err;
  const FwdRowArgs ra{a1,      xh,      xpd,     eps_w,   eps_z,    in(wwz), in(whw2), in(wzz),
                      in(wdw), in(wdz), bwz,     bh,      bzz,      bd,      wargs,    w,
                      a2,      zargs,   a3,      a3_b,    B,        Cw,      H,        L,
                      K};
  const size_t smem = fwd_rows_smem(H, L, K);
  if ((err = (int)cudaFuncSetAttribute(vae_tc_fwd_rows_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return err;
  vae_tc_fwd_rows_kernel<<<cdiv(B, kRows), kFwdThreads, smem, st>>>(ra);
  if ((err = (int)cudaGetLastError())) return err;
  // xhat = sigmoid(a3 @ Wxh + bxh)
  const ProdJob jx{Operand{a3_b, B, H, H}, Operand{in(wxh), H, D, D}, nullptr, nullptr, bxh, xhat,
                   nullptr, kSigmoid, 0};
  const dim3 g2(cdiv(D, kBN), cdiv(B, kBM), kSplit);
  vae_tc_product_kernel<false><<<g2, cvl_tc::kThreads, 0, st>>>(jx, jx, jx);
  return (int)cudaGetLastError();
}
