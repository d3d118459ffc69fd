// Two-cell (encoder + decoder) cl_vrnn training forward for Hopper (sm_90a):
// the skewed walk of the TPU grid spread over the whole card, the bf16
// stream mode on the tensor cores, the f32 mode on FFMA.
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_two_cell.py:272 `_fwd_call`
// -> `_fwd_kernel` :129, in the f32 mode and in the bf16 stream mode
// (`compute_dtype=bf16`). The backward (`_bwd_call` :408) is
// csrc/two_cell_tc.cu. One ported kernel, one wrapper call of T + 2
// launches: the operands' layouts, then T + 1 walk steps.
//
// What it computes, per batch row and time step t = 0 .. T-1:
//   ze = xe[t] @ We + be + h_e @ Rk_e;  (h_e, c_e) = gates(ze, c_e)
//   zargs = h_e @ Wz + bz;  z = zargs[:L] + exp(zargs[L:] / 2) * eps[t]
//   zd = xd[t] @ Wdx + bd + z @ Kz + h_d @ Rk_d;  (h_d, c_d) = gates(zd, c_d)
// with Keras-2.0 gates (i, f, c, o): hard sigmoid clip(0.2x + 0.5, 0, 1) for
// i, f, o, tanh for g and for the cell output. It emits hd, zargs and the
// residual streams the backward reads (ze, zd, and h, c before and after each
// cell).
//
// What bounds it. At the f32 training shape (B=200, T=16, H=256, L=8, input
// widths 101) the forward is ~4.8 GFLOP of FMAs (0.071 ms at 67 TFLOP/s
// without tensor cores); at the bf16 shape (B=1,024, H=512, L=2) ~35 GFLOP
// (0.035 ms at 989 TFLOP/s), against ~0.11 ms of streams at 3.35 TB/s. But
// step t needs all of h(t-1) of a row, so the recurrent products run in
// series: [B, H] x [H, 4H] for each cell a step.
//
// What the design does about it.
// * The skew of the TPU grid: launch t runs encoder step t (t < T) and
//   decoder step t - 1 (t > 0) as two jobs of one grid, so T steps take
//   T + 1 launches. Each job is one product [x[t] | h] @ [W ; Rk] over the
//   whole batch (the input projection rides in the step's product, as in
//   the Pallas body, in f32 and unrounded; lifted out into one launch over
//   all T*B rows it wrote and read back 268 MB of f32 at the bf16 shape,
//   and the whole forward took more device time on an H100), cut into
//   tiles (bf16: 64 rows x 128 columns on csrc/mma_bf16.cuh's mma.sync
//   mainloop; f32: 32 x 32 on csrc/ffma_f32.cuh), so each tile reads its
//   slice of Rk once a step (the first design's 4-row blocks streamed all
//   six weights from L2 every step, 50 blocks on 132 SMs at the f32 shape).
// * K of each tile (x's columns, then h's) is split between the two blocks
//   of a cluster (1 x 1 x 2), which stage their f32 sums; after a cluster
//   barrier each block takes half of the tile's rows and adds rank 0's and
//   rank 1's sums through distributed shared memory, in that order
//   (csrc/two_cell_tc.cu's walk).
// * The first launch lays out the products' operands (the wrapper's torch
//   ops for them cost more host time than the whole walk's device time at
//   the f32 shape): W and Rk transposed with their columns gate-interleaved
//   (row 4u + g of Wᵀ is gate g of unit u), the x rows padded to whole
//   16-byte chunks, so a tile's columns are the four gates of BN / 4 units
//   and the gates run in the epilogue: z = b [+ z @ Kz, L rank-1 f32 terms]
//   + the product; z, h, c are written at the original layout.
// * The z heads: the encoder's epilogue sums each row's h (as an operand)
//   times the tile's rows of Wz into a partial sum per (row, column tile);
//   the decoder's epilogue one launch later adds a row's partials over the
//   column tiles in order, + bz, draws z (the tile of column 0 writes
//   zargs) and takes z @ Kz. No z-head launch, no atomics.
// * State in global memory, no width limit: the h operand double-buffered
//   [2, B, Hp] per cell (Hp: H rounded up to 8, zero pad columns; buffer 0
//   holds op(h0)), c read back from the c streams, the z-head partials
//   double-buffered.
// * Every sum is taken in a fixed order by one thread or a fixed tree, so
//   two calls give the same bits. f32 stays exact to the JAX side's
//   precision="highest": FFMA only, no TF32.
// Known limits of this form: each of the T + 1 launches is latency-bound
// (tens of µs a step on an H100 at the shapes above, for products of a few
// µs of work): mma.sync at 64 x 128 tiles, a 3-stage ring, two cluster
// barriers; wgmma, TMA and one persistent launch for all steps are the
// levers, as for the backward.
//
// The bf16 stream mode. As `two_cell_sequence` :558-581 casts them outside
// its custom vjp, the x streams (xe, xd) and the six weight matrices (We,
// Rk_e, Wdx, Rk_d, Kz, Wz) arrive in bf16; the biases, eps, the initial
// states and the c streams stay f32. Rounding happens where the Pallas body
// rounds (`mm` :150 casts the left operand):
// * h as an operand: the h operand buffers hold the rounded h, which is
//   also the hpe, he and hpd streams; the decoder's unrounded h is written
//   to hd (f32) before it is rounded. The gates read the unrounded z sums.
// * z (the sampled latent) as the operand of z @ Kz; zargs stays f32.
// * ze and zd as they are stored (the backward's gates read them rounded).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <cooperative_groups.h>

#include "ffma_f32.cuh"
#include "mma_bf16.cuh"

namespace {

namespace cg = cooperative_groups;

using cvl_tc::Acc;
using cvl_tc::bf16;
using cvl_tc::kBM;
using cvl_tc::kBN;
using cvl_tc::Operand;

using cvl_ffma::kFK;
using cvl_ffma::kFM;
using cvl_ffma::kFN;
using cvl_ffma::kFSmemFloats;
using cvl_ffma::kFThreads;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float hard_sigmoid(float x) {
  return fminf(fmaxf(0.2f * x + 0.5f, 0.f), 1.f);
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
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------- (0) layouts

// The operands of the products, laid out once a call from the inputs as
// they come (`ops/two_cell.py` `fwd_operands` is this function in torch):
// the x rows padded by zeros to INp = round8(IN); Wᵀ of We, Wdx, Rk_e, Rk_d
// with rows gate-interleaved (row 4u + g is column g*H + u) and K padded by
// zero columns; Kz interleaved; the h operands [2, B, Hp] with
// op(h0) in buffer 0 and zeros elsewhere. One launch, a grid-stride loop
// over each part in turn; the weights are read through the read-only path
// (each 32-byte sector serves the rows of two units' four gates).
template <typename S>
struct LayoutArgs {
  const S *xe, *xd, *we, *rke, *wdx, *rkd, *kz;
  const float *h0e, *h0d;
  S *xep, *xdp, *wet, *rket, *wdxt, *rkdt, *kzi, *hbe, *hbd;
  int R, INe, INd, INep, INdp, H, Hp, L, B;
};

__device__ __forceinline__ float ldr(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldr(const bf16* p) { return __bfloat162float(__ldg(p)); }

// dst [rows][width] <- src [rows][k] (k < K), zeros past K
template <typename S>
__device__ __forceinline__ void pad_rows(S* dst, const S* src, size_t rows, int K, int width,
                                         size_t i0, size_t stride) {
  for (size_t i = i0; i < rows * width; i += stride) {
    const int k = (int)(i % width);
    st(dst + i, k < K ? ldr(src + i / width * K + k) : 0.f);
  }
}

// dst [4H][width] <- Wᵀ, rows gate-interleaved: dst[4u + g][k] = w[k][g H + u]
template <typename S>
__device__ __forceinline__ void gate_rows_t(S* dst, const S* w, int K, int H, int width,
                                            size_t i0, size_t stride) {
  for (size_t i = i0; i < (size_t)4 * H * width; i += stride) {
    const int n = (int)(i / width), k = (int)(i % width);
    st(dst + i, k < K ? ldr(w + (size_t)k * 4 * H + (n % 4) * H + n / 4) : 0.f);
  }
}

template <typename S>
__global__ void __launch_bounds__(256) two_cell_layout_kernel(const LayoutArgs<S> a) {
  const size_t i0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x,
               stride = (size_t)gridDim.x * blockDim.x;
  const int H = a.H, H4 = 4 * a.H;
  pad_rows(a.xep, a.xe, a.R, a.INe, a.INep, i0, stride);
  pad_rows(a.xdp, a.xd, a.R, a.INd, a.INdp, i0, stride);
  gate_rows_t(a.wet, a.we, a.INe, H, a.INep, i0, stride);
  gate_rows_t(a.wdxt, a.wdx, a.INd, H, a.INdp, i0, stride);
  gate_rows_t(a.rket, a.rke, H, H, a.Hp, i0, stride);
  gate_rows_t(a.rkdt, a.rkd, H, H, a.Hp, i0, stride);
  for (size_t i = i0; i < (size_t)a.L * H4; i += stride) {
    const int l = (int)(i / H4), n = (int)(i % H4), c = (n % 4) * H + n / 4;
    st(a.kzi + i, ldr(a.kz + (size_t)l * H4 + c));
  }
  for (size_t i = i0; i < (size_t)2 * a.B * a.Hp; i += stride) {
    const size_t r = i / a.Hp % a.B;
    const int k = (int)(i % a.Hp);
    const bool h0 = i < (size_t)a.B * a.Hp && k < H;
    st(a.hbe + i, h0 ? __ldg(a.h0e + r * H + k) : 0.f);  // st rounds: h as an operand
    st(a.hbd + i, h0 ? __ldg(a.h0d + r * H + k) : 0.f);
  }
}

// ---------------------------------------------------------------- (b) the walk

// S is the stream type: float, or bf16 in the bf16 stream mode
template <typename S>
struct StepArgs {
  const S *xep, *xdp;       // [T*B, INep], [T*B, INdp]  the x rows, zero pad columns
  const S *wet, *wdxt;      // [4H, INep], [4H, INdp]    Wᵀ, interleaved rows
  const S *rket, *rkdt;     // [4H, Hp]    Rkᵀ, interleaved rows, zero pad columns
  const float *be, *bd;     // [4H]
  const S* kz;              // [L, 4H]     interleaved
  const S* wz;              // [H, 2L]
  const float *bz, *eps;    // [2L], [T, B, L]
  const float *c0e, *c0d;   // [B, H]
  S *hbe, *hbd;             // [2, B, Hp]  the h operands, buffer 0 = op(h0)
  float* zpart;             // [2, column tiles, B, 2L]  the z heads' partial sums
  float *hd, *zargs;        // [T, B, H], [T, B, 2L]
  S *ze, *zd;               // [T, B, 4H]
  S *hpe, *he, *hpd;        // [T, B, H]
  float *cpe, *ce, *cpd, *cd;  // [T, B, H]
  int T, B, H, Hp, L, INep, INdp;
};

// Shared memory past the staged tile: op(h) of the half's rows and the
// tile's units and the tile's rows of Wz (the encoder's z-head partials),
// op(z) of the half's rows and the tile's columns of Kz (the decoder's z @
// Kz); the Wz and Kz tiles are read from L2 in one parallel pass
__host__ __device__ constexpr int ext_floats(int BM, int BN, int L) {
  return BM / 2 * (BN / 4) + BM / 2 * L + BN / 4 * 2 * L + L * BN;
}

// The epilogue of launch t for one half of a BM x BN tile (rows m0 + half
// BM/2 .., interleaved columns n0 ..: units n0/4 ..). The two blocks of the
// cluster each summed half of K and staged [BM][kStride] f32 sums; the
// product is t0 + t1 (rank 0's + rank 1's), t1 read through the cluster.
// The encoder's job runs step s = t, the decoder's s = t - 1.
template <typename S, int BM, int BN, int kStride>
__device__ __forceinline__ void step_epilogue(const float* t0, const float* t1, float* ext,
                                              const StepArgs<S>& a, int t, bool enc, int half) {
  constexpr int kU = BN / 4, kHalf = BM / 2;
  const int B = a.B, H = a.H, Hp = a.Hp, L = a.L, L2 = 2 * a.L, H4 = 4 * a.H;
  const int m0 = blockIdx.y * BM + half * kHalf, r0 = half * kHalf, u0 = blockIdx.x * kU;
  const int s = enc ? t : t - 1, ntn = gridDim.x;
  float* hs = ext;                 // [kHalf][kU]
  float* zs = hs + kHalf * kU;     // [kHalf][L]
  float* wzs = zs + kHalf * L;     // [kU][2L]
  float* kzs = wzs + kU * L2;      // [L][BN]
  const size_t sb = (size_t)s * B;
  if (enc)
    for (int i = threadIdx.x; i < kU * L2; i += blockDim.x)
      wzs[i] = u0 + i / L2 < H ? ldv(a.wz + (size_t)u0 * L2 + i) : 0.f;
  else
    for (int i = threadIdx.x; i < L * BN; i += blockDim.x) {
      const int l = i / BN, c = 4 * u0 + i - l * BN;
      kzs[i] = c < H4 ? ldv(a.kz + (size_t)l * H4 + c) : 0.f;
    }
  if (!enc) {
    // z of the half's rows: the encoder's partials of step s added over the
    // column tiles in order (loaded 8 tiles at a time), + bz; the draw; z
    // as the operand of z @ Kz
    const float* zp = a.zpart + (size_t)(s & 1) * ntn * B * L2;
    for (int i = threadIdx.x; i < kHalf * L; i += blockDim.x) {
      const int r = i / L, l = i - r * L, row = m0 + r;
      float z = 0.f;
      if (row < B) {
        float zm = 0.f, zv = 0.f;
        for (int n0 = 0; n0 < ntn; n0 += 8) {
          float pm[8], pv[8];
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float* p = zp + ((size_t)(n0 + n) * B + row) * L2;
            pm[n] = n0 + n < ntn ? p[l] : 0.f;
            pv[n] = n0 + n < ntn ? p[L + l] : 0.f;
          }
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            zm += pm[n];
            zv += pv[n];
          }
        }
        zm += a.bz[l];
        zv += a.bz[L + l];
        const size_t rr = sb + row;
        if (blockIdx.x == 0) {
          a.zargs[rr * L2 + l] = zm;
          a.zargs[rr * L2 + L + l] = zv;
        }
        z = zm + expf(zv / 2.f) * a.eps[rr * L + l];
      }
      zs[r * L + l] = operand<S>(z);
    }
  }
  __syncthreads();
  const S* hcur = (enc ? a.hbe : a.hbd) + (size_t)(s & 1) * B * Hp;
  S* hnxt = (enc ? a.hbe : a.hbd) + (size_t)((s + 1) & 1) * B * Hp;
  const float* bias = enc ? a.be : a.bd;
  const float* c0 = enc ? a.c0e : a.c0d;
  float* cout = enc ? a.ce : a.cd;
  const float* cprev = s ? cout + (sb - B) * H : c0;
  for (int i = threadIdx.x; i < kHalf * kU; i += blockDim.x) {
    const int r = i / kU, j = i - r * kU, row = m0 + r, u = u0 + j;
    float hq = 0.f;
    if (row < B && u < H) {
      const size_t rr = sb + row;
      float z[4] = {bias[u], bias[H + u], bias[2 * H + u], bias[3 * H + u]};
      if (!enc)
        for (int l = 0; l < L; ++l) {
          const float zl = zs[r * L + l];
#pragma unroll
          for (int g = 0; g < 4; ++g) z[g] = fmaf(zl, kzs[l * BN + 4 * j + g], z[g]);
        }
      const int ti = (r0 + r) * kStride + 4 * j;
#pragma unroll
      for (int g = 0; g < 4; ++g) z[g] += t0[ti + g] + t1[ti + g];
      const float ig = hard_sigmoid(z[0]), fg = hard_sigmoid(z[1]);
      const float gg = tanhf(z[2]), og = hard_sigmoid(z[3]);
      const size_t hu = (size_t)row * H + u;
      const float cp = cprev[hu];
      const float cn = fg * cp + ig * gg;
      const float hn = og * tanhf(cn);
      S* zo = (enc ? a.ze : a.zd) + rr * H4 + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) st(zo + g * H, z[g]);
      const size_t ru = rr * H + u;
      (enc ? a.hpe : a.hpd)[ru] = hcur[(size_t)row * Hp + u];
      (enc ? a.cpe : a.cpd)[ru] = cp;
      cout[ru] = cn;
      if (enc)
        st(a.he + ru, hn);
      else
        a.hd[ru] = hn;
      hq = operand<S>(hn);
      st(hnxt + (size_t)row * Hp + u, hq);
    }
    if (enc) hs[r * kU + j] = hq;
  }
  if (!enc) return;
  __syncthreads();
  // this column tile's share of the z heads: sum over its units in order
  float* zp = a.zpart + ((size_t)(s & 1) * ntn + blockIdx.x) * B * L2;
  for (int i = threadIdx.x; i < kHalf * L2; i += blockDim.x) {
    const int r = i / L2, c = i - r * L2, row = m0 + r;
    if (row >= B) continue;
    float p = 0.f;
    for (int j = 0; j < kU && u0 + j < H; ++j) p = fmaf(hs[r * kU + j], wzs[j * L2 + c], p);
    zp[(size_t)row * L2 + c] = p;
  }
}

// K of a step's product split between the two blocks of a cluster: [half
// kh, ...) with kh a whole number of chunks
__device__ __forceinline__ void k_half(int K, int chunk, int half, int& k0, int& len) {
  const int kh = (K / 2 + chunk - 1) / chunk * chunk;
  k0 = half ? kh : 0;
  len = half ? max(K - kh, 0) : min(kh, K);
}

// This block's share [k0, k0 + len) of a step product's K, x's INp columns
// then h's Hp, as mainloop calls on each segment it covers: (x offset,
// length) and (h offset, length)
__device__ __forceinline__ void k_segments(int INp, int Hp, int k0, int len, int& xo, int& xl,
                                           int& ho, int& hl) {
  xo = min(k0, INp);
  xl = max(min(k0 + len, INp) - xo, 0);
  ho = max(k0 - INp, 0);
  hl = max(k0 + len - INp - ho, 0);
}

// the job of a block: 0 the decoder (step t - 1), 1 the encoder (step t);
// false where that step does not exist (the cluster's two blocks agree)
__device__ __forceinline__ bool step_job(int t, int T, bool& enc) {
  enc = blockIdx.z >= 2;
  return enc ? t < T : t > 0;
}

__host__ __device__ constexpr int step_smem_tc(int L) {
  return cvl_tc::smem_bytes<true>() > cvl_tc::kTileBytes + ext_floats(kBM, kBN, L) * 4
             ? cvl_tc::smem_bytes<true>()
             : cvl_tc::kTileBytes + ext_floats(kBM, kBN, L) * 4;
}
__host__ __device__ constexpr int step_smem_f32(int L) {
  return kFSmemFloats * 4 > (kFM * (kFN + 4) + ext_floats(kFM, kFN, L)) * 4
             ? kFSmemFloats * 4
             : (kFM * (kFN + 4) + ext_floats(kFM, kFN, L)) * 4;
}

// (b) bf16 launch t: a tile of h(s) @ Rk on the tensor cores, K split
// across the cluster, then the epilogue
__global__ void __cluster_dims__(1, 1, 2) __launch_bounds__(cvl_tc::kThreads)
    two_cell_step_tc_kernel(const StepArgs<bf16> a, int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  bool enc;
  if (!step_job(t, a.T, enc)) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int half = (int)cluster.block_rank();
  const int s = enc ? t : t - 1, INp = enc ? a.INep : a.INdp, m0 = blockIdx.y * kBM,
            n0 = blockIdx.x * kBN, H4 = 4 * a.H;
  int k0, len, xo, xl, ho, hl;
  k_half(INp + a.Hp, cvl_tc::kBK, half, k0, len);
  k_segments(INp, a.Hp, k0, len, xo, xl, ho, hl);
  Acc acc;
  cvl_tc::zero(acc);
  if (xl > 0) {  // x[s] @ W
    const bf16* x = (enc ? a.xep : a.xdp) + (size_t)s * a.B * INp + xo;
    cvl_tc::mainloop<false, true>(acc, Operand{x, a.B, xl, INp},
                                  Operand{(enc ? a.wet : a.wdxt) + xo, H4, xl, INp}, m0, n0, xl,
                                  smem);
    __syncthreads();  // every warp is done with the ring
  }
  if (hl > 0) {  // h(s - 1) @ Rk
    const bf16* h = (enc ? a.hbe : a.hbd) + (size_t)(s & 1) * a.B * a.Hp + ho;
    cvl_tc::mainloop<false, true>(acc, Operand{h, a.B, hl, a.Hp},
                                  Operand{(enc ? a.rket : a.rkdt) + ho, H4, hl, a.Hp}, m0, n0, hl,
                                  smem);
  }
  float* tile = cvl_tc::stage_acc(acc, smem);
  cluster.sync();  // both halves' sums are staged
  step_epilogue<bf16, kBM, kBN, cvl_tc::kTileStride>(
      cluster.map_shared_rank(tile, 0), cluster.map_shared_rank(tile, 1),
      reinterpret_cast<float*>(smem) + kBM * cvl_tc::kTileStride, a, t, enc, half);
  cluster.sync();  // the peer has read this block's sums
}

// (b) f32 launch t: the tile on FFMA, K split across the cluster
__global__ void __cluster_dims__(1, 1, 2) __launch_bounds__(kFThreads)
    two_cell_step_f32_kernel(const StepArgs<float> a, int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  bool enc;
  if (!step_job(t, a.T, enc)) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int half = (int)cluster.block_rank();
  const int s = enc ? t : t - 1, INp = enc ? a.INep : a.INdp, m0 = blockIdx.y * kFM,
            n0 = blockIdx.x * kFN, H4 = 4 * a.H;
  int k0, len, xo, xl, ho, hl;
  k_half(INp + a.Hp, kFK, half, k0, len);
  k_segments(INp, a.Hp, k0, len, xo, xl, ho, hl);
  float acc[2][4] = {};
  if (xl > 0) {  // x[s] @ W
    cvl_ffma::mainloop(acc, (enc ? a.xep : a.xdp) + (size_t)s * a.B * INp + xo, a.B, INp,
                       (enc ? a.wet : a.wdxt) + xo, H4, INp, m0, n0, xl, sm);
    __syncthreads();  // every warp is done with the ring
  }
  if (hl > 0)  // h(s - 1) @ Rk
    cvl_ffma::mainloop(acc, (enc ? a.hbe : a.hbd) + (size_t)(s & 1) * a.B * a.Hp + ho, a.B, a.Hp,
                       (enc ? a.rket : a.rkdt) + ho, H4, a.Hp, m0, n0, hl, sm);
  cvl_ffma::stage_acc(acc, sm);
  cluster.sync();  // both halves' sums are staged
  step_epilogue<float, kFM, kFN, kFN + 4>(cluster.map_shared_rank(sm, 0),
                                          cluster.map_shared_rank(sm, 1), sm + kFM * (kFN + 4),
                                          a, t, enc, half);
  cluster.sync();  // the peer has read this block's sums
}

int set_smem(const void* fn, int bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int walk(const StepArgs<bf16>& a, cudaStream_t st) {
  const int smem = step_smem_tc(a.L);
  int err = set_smem((const void*)two_cell_step_tc_kernel, smem);
  if (err) return err;
  const dim3 grid(cdiv(4 * a.H, kBN), cdiv(a.B, kBM), 4);
  for (int t = 0; t <= a.T; ++t) {
    two_cell_step_tc_kernel<<<grid, cvl_tc::kThreads, smem, st>>>(a, t);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}
int walk(const StepArgs<float>& a, cudaStream_t st) {
  const int smem = step_smem_f32(a.L);
  int err = set_smem((const void*)two_cell_step_f32_kernel, smem);
  if (err) return err;
  const dim3 grid(cdiv(4 * a.H, kFN), cdiv(a.B, kFM), 4);
  for (int t = 0; t <= a.T; ++t) {
    two_cell_step_f32_kernel<<<grid, kFThreads, smem, st>>>(a, t);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }

// The scratch of a call, byte offsets (each a multiple of 16): the laid-out
// operands and the z heads' partial sums
struct FwdScratch {
  size_t xep, xdp, wet, wdxt, rket, rkdt, kzi, hbe, hbd, zpart, total;
};
inline FwdScratch fwd_scratch(int T, int B, int INe, int INd, int H, int L, int sbytes, int BN) {
  FwdScratch f{};
  size_t off = 0;
  const auto take = [&](size_t bytes) {
    const size_t at = off;
    off += (bytes + 15) / 16 * 16;
    return at;
  };
  const size_t R = (size_t)T * B, H4 = (size_t)4 * H, Hp = round8(H);
  f.xep = take(R * round8(INe) * sbytes);
  f.xdp = take(R * round8(INd) * sbytes);
  f.wet = take(H4 * round8(INe) * sbytes);
  f.wdxt = take(H4 * round8(INd) * sbytes);
  f.rket = take(H4 * Hp * sbytes);
  f.rkdt = take(H4 * Hp * sbytes);
  f.kzi = take((size_t)L * H4 * sbytes);
  f.hbe = take(2 * B * Hp * sbytes);
  f.hbd = take(2 * B * Hp * sbytes);
  f.zpart = take((size_t)2 * cdiv(4 * H, BN) * B * 2 * L * 4);
  f.total = off;
  return f;
}

// the whole forward: the layouts, then the T + 1 walk steps
template <typename S>
int fwd(const S* xe, const S* xd, const float* eps, const S* we, const float* be, const S* rke,
        const S* wdx, const float* bd, const S* rkd, const S* kz, const S* wz, const float* bz,
        const float* h0e, const float* c0e, const float* h0d, const float* c0d, void* scratch,
        float* hd, float* zargs, S* ze, S* zd, S* hpe, float* cpe, float* ce, S* he, S* hpd,
        float* cpd, float* cd, int T, int B, int INe, int INd, int H, int L, cudaStream_t st) {
  constexpr bool kBf16 = sizeof(S) == 2;
  const FwdScratch f = fwd_scratch(T, B, INe, INd, H, L, sizeof(S), kBf16 ? kBN : kFN);
  unsigned char* sb = static_cast<unsigned char*>(scratch);
  const auto sp = [&](size_t off) { return reinterpret_cast<S*>(sb + off); };
  const auto fp = [&](size_t off) { return reinterpret_cast<float*>(sb + off); };
  const int R = T * B, INep = round8(INe), INdp = round8(INd), Hp = round8(H);
  const LayoutArgs<S> la{xe, xd, we, rke, wdx, rkd, kz, h0e, h0d,
                         sp(f.xep), sp(f.xdp), sp(f.wet), sp(f.rket), sp(f.wdxt), sp(f.rkdt),
                         sp(f.kzi), sp(f.hbe), sp(f.hbd), R, INe, INd, INep, INdp, H, Hp, L, B};
  two_cell_layout_kernel<S><<<264, 256, 0, st>>>(la);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const StepArgs<S> a{sp(f.xep), sp(f.xdp), sp(f.wet), sp(f.wdxt), sp(f.rket), sp(f.rkdt),
                      be, bd, sp(f.kzi), wz, bz, eps, c0e, c0d, sp(f.hbe), sp(f.hbd),
                      fp(f.zpart), hd, zargs, ze, zd, hpe, he, hpd, cpe, ce, cpd, cd,
                      T, B, H, Hp, L, INep, INdp};
  return walk(a, st);
}

}  // namespace

// Column tiles of a step's product (the z heads' partial sums are [2, tiles,
// B, 2L] of the scratch), the dynamic shared memory of a step block, and the
// bytes of a call's scratch.
extern "C" int cvl_two_cell_fwd_tiles(int H, int bf16_mode) {
  return cdiv(4 * H, bf16_mode ? kBN : kFN);
}
extern "C" long long cvl_two_cell_fwd_smem_bytes(int L, int bf16_mode) {
  return bf16_mode ? step_smem_tc(L) : step_smem_f32(L);
}
extern "C" long long cvl_two_cell_fwd_scratch_bytes(int T, int B, int INe, int INd, int H, int L,
                                                    int bf16_mode) {
  return (long long)fwd_scratch(T, B, INe, INd, H, L, bf16_mode ? 2 : 4,
                                bf16_mode ? kBN : kFN).total;
}

// The forward on `stream`; returns the first nonzero cudaError_t of a launch
// (T + 2 launches: the layouts, the walk). The inputs and
// outputs are those of `two_cell_fwd_plain`, at their own layouts (wz [H,
// 2L]); `scratch` holds cvl_two_cell_fwd_scratch_bytes bytes.
extern "C" int cvl_two_cell_fwd(
    const float* xe, const float* xd, const float* eps, const float* we, const float* be,
    const float* rke, const float* wdx, const float* bd, const float* rkd, const float* kz,
    const float* wz, const float* bz, const float* h0e, const float* c0e, const float* h0d,
    const float* c0d, void* scratch, float* hd, float* zargs, float* ze, float* zd, float* hpe,
    float* cpe, float* ce, float* he, float* hpd, float* cpd, float* cd, int T, int B, int INe,
    int INd, int H, int L, void* stream) {
  return fwd(xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz, bz, h0e, c0e, h0d, c0d, scratch, hd,
             zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd, T, B, INe, INd, H, L,
             static_cast<cudaStream_t>(stream));
}

// The same in the bf16 stream mode: xe, xd, the six weights (we, rke, wdx,
// rkd, kz, wz) and ze, zd, hpe, he, hpd are bf16; eps, the biases, the
// initial states, hd, zargs and the c streams f32.
extern "C" int cvl_two_cell_fwd_bf16(
    const void* xe, const void* xd, const float* eps, const void* we, const float* be,
    const void* rke, const void* wdx, const float* bd, const void* rkd, const void* kz,
    const void* wz, const float* bz, const float* h0e, const float* c0e, const float* h0d,
    const float* c0d, void* scratch, float* hd, float* zargs, void* ze, void* zd, void* hpe,
    float* cpe, float* ce, void* he, void* hpd, float* cpd, float* cd, int T, int B, int INe,
    int INd, int H, int L, void* stream) {
  const auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  const auto out = [](void* p) { return static_cast<bf16*>(p); };
  return fwd(in(xe), in(xd), eps, in(we), be, in(rke), in(wdx), bd, in(rkd), in(kz), in(wz), bz,
             h0e, c0e, h0d, c0d, scratch, hd, zargs, out(ze), out(zd), out(hpe), cpe, ce, out(he),
             out(hpd), cpd, cd, T, B, INe, INd, H, L, static_cast<cudaStream_t>(stream));
}
