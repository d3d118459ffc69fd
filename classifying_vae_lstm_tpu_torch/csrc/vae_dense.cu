// Dense-stack cl_vae training kernels for Hopper (sm_90a), f32 mode.
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_vae.py
//   * :214 `_fwd_call` -> `_fwd_kernel` :133 in the f32 mode with
//     `vae_dense_fwd_kernel<R, T>` below;
//   * :358 `_bwd_call` -> `_bwd_kernel` :230 in the f32 mode with
//     `vae_dense_bwd_kernel<R, T>`: the row pass and the weight and bias
//     gradients in one cooperative launch, a grid barrier between them.
//   The bf16 mode of both is csrc/vae_dense_tc.cu (whole-batch products on
//   the tensor cores, the narrow layers in row kernels).
//
// What it computes, per batch row (D frame width, Cw key-encoder width, H
// hidden width, L latent width, K key classes):
//   a1    = relu(x @ Whw + bhw)                              [Cw]
//   wargs = a1 @ [Wwm | Wwv] + [bwm | bwv]                   [2(K-1)]
//   w     = softmax([wargs[:K-1] + exp(wargs[K-1:] / 2) * eps_w, 0])   [K]
//   a2    = relu(x @ Whx + w @ Whw2 + bh)                    [H]
//   zargs = a2 @ [Wzm | Wzv] + [bzm | bzv]                   [2L]
//   z     = zargs[:L] + exp(zargs[L:] / 2) * eps_z
//   a3    = relu(w @ Wdw + z @ Wdz [+ x_prev @ Wdxp] + bd)   [H]
//   xhat  = sigmoid(a3 @ Wxh + bxh)                          [D]
// The forward emits xhat, wargs, zargs, w and the residuals a1, a2, a3. The
// backward takes the cotangents of xhat, wargs, zargs and w, recomputes z and
// the exp factors from the zargs / wargs residuals, takes the relu masks from
// the post-activations (a > 0), runs the vjp chain frame head -> decoder ->
// z sample -> latent encoder -> softmax (the pinned zero logit dropped) -> w
// heads -> key encoder, and emits dx, dx_prev and every weight and bias
// gradient.
//
// What bounds it on this card. At the jsball_vae width with 13 keys (D = H =
// Cw = 88, L = 4, use_x_prev) a row is 36,432 FMAs forward, so B = 100 rows
// are 7.3 MFLOP (0.11 us at 67 TFLOP/s) against ~0.38 MB of weights and row
// streams (0.11 us at 3.35 TB/s); the backward is about twice that. Both are
// far below the cost of one launch: at this width a call is bound by the
// host work around the launch and, on the card, by latency: a chain of
// dependent layers, each a few hundred cycles of products, barriers and
// sums, run at the low clocks (345-800 MHz) a card mostly idle between tiny
// launches keeps. At the seq-concat width the JAX kernel was written for (D =
// 976, Cw = 256, H = 1024, L = 16, K = 13, B = 1024) a row is 3.33 M FMAs:
// 6.8 GFLOP forward, operations-bound at ~0.10 ms, with 13.3 MB of weights
// that fit no SM.
//
// What the design does about it.
// * The plan (`make_plan`, mirrored by ops/vae_dense.plan and checked
//   against it when the library loads): where every weight fits in one
//   block's shared memory beside a tile of 4 rows (the training shape: 146
//   KB of weights, ~19 KB of tiles) the layout is *resident*, 512 threads a
//   block; otherwise it is *streamed*, 256 threads, with as many rows a
//   block (8, 4, 2 or 1) as fit beside a ring of weight chunks. Both kernels
//   are templates on the rows (R) and threads (T) of a block. At the
//   training shape 1, 2 and 4 resident rows a block measured the same device
//   time on an H100 (PERF.md §6); 4 reads the weights from L2 into a quarter
//   of the blocks.
// * Resident: thread 0 of each block issues one `cp.async.bulk` global ->
//   shared copy per weight, in the order the chain reads them, each
//   completing on its own mbarrier; a layer waits only for its own weights,
//   so the first layer starts as soon as its weight has landed. A weight
//   whose source is not on 16 bytes, or the tail of fewer than 4 floats past
//   its last 16-byte chunk, is copied by that thread with ordinary loads
//   before it arrives on the barrier (the wrapper passes aligned copies of
//   misaligned weights, so this stays a safety net).
// * Streamed: a ring of `stages` slots of `slot` floats, filled with
//   `cp.async` `stages - 1` chunks ahead of the products, the chunks in chain
//   order, 16-byte pieces where the source allows. The forward's chunks are
//   runs of whole rows of a weight; the backward's are bands of whole
//   columns, each row's run as stored. Any width the plan accepts runs.
// * Products, all f32 FFMA from shared memory (no TF32: the JAX side runs
//   precision="highest"), each into [feature][row] tiles so one vector load
//   gives a thread its R rows. A layer of N outputs splits its k range over
//   S = T / N groups of N threads where 2 N <= T (every layer at the
//   training shape) and adds the groups' sums in group order; a wider layer
//   gives each thread whole outputs, at most 4, summed in registers across
//   the ring's chunks. The backward reads every weight as stored ([in,
//   out]): a thread walks its output's row of W (a resident weight, or a
//   band), split layers from their own offset (n = j mod len, for even
//   widths), so the lanes of a warp read different banks; no transposed
//   copy, no padded stride. Where the resident backward's products share
//   their input (dd against Wdw, Wdxp, Wdz; dh against Whx, Whw2) they run
//   as one stacked layer: one pass of products, one of sums.
// * Rows are independent: a block owns a tile of R rows. Every row input a
//   tile reads (x, x_prev, the noise and the biases; the backward's
//   residuals and cotangents, and its relu masks packed as bits by warp
//   ballots) is gathered at the start of the tile, its loads in flight
//   together, so the chain of layers reads shared memory only.
// * The backward is one launch. The grid is persistent and co-resident (a
//   cooperative launch of at most the blocks the card holds): each block
//   runs the row pass for its row tiles (dx, dx_prev, each layer's
//   pre-activation cotangent and z into one scratch), then a grid barrier
//   (cvl_coop::grid_sync_reusable: release-add, acquire loads, its state
//   left as it was found), then every dW = A^T dPre and every bias column
//   sum in wg_tile x wg_tile tiles (32 at B <= 256, else 64) spread over the
//   grid, each through csrc/wgrad.cuh's tile loop (`cvl::wgrad_tile`, the
//   one wgrad_kernel runs): each output element summed over the rows in row
//   order by one thread, the rows staged by cp.async through the weight
//   region, two chunks in flight. No atomics: the sums do not depend on
//   launch order, and two calls give the same bits.
// * Host: the plan, `cudaFuncSetAttribute` (once a kernel and device) and
//   the occupancy query (once a kernel, size and device) are computed in C
//   from the shape; the wrapper passes one array of pointers.
// Sum orders. The unsplit forward layers and the weight and bias gradients
// sum as the first design did (bias, then k ascending; rows ascending), as
// do the unsplit streamed backward layers (k ascending). The split layers
// (bias + group 0 + group 1 + ...) and the split backward walks (each from
// its own offset) sum in another order than the first design's one thread
// an output.
// Limits. At the seq-concat width every block streams all 13.3 MB of
// weights from L2 for 8 rows (1.7 GB of L2 reads a direction at B = 1024);
// whole-batch products (the bf16 mode's design) would read each once. The
// products run on FFMA, not the tensor cores. At the training shape each
// layer is a few hundred dependent cycles (products, two barriers, the
// groups' sums): the chain, not the card's rates, sets the time. The 10
// kernel instances (rows x threads x direction) take nvcc minutes.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

#include "coop.cuh"
#include "wgrad.cuh"

namespace {

constexpr int kResThreads = 512;    // threads a block, resident layout
constexpr int kResRows = 4;         // rows a block, resident layout
constexpr int kStrThreads = 256;    // threads a block, streamed layout
constexpr int kLimit = 232448;      // dynamic shared memory one block may use
constexpr int kBarBytes = 128;      // the mbarriers at the start of shared memory
constexpr int kSlotMin = 8448;      // floats of a ring slot, at least (8 rows or columns of 1,024)
constexpr int kStages = 3;          // ring slots, at most (at least 2; at most 6)
constexpr int kWgStage = 24576;     // floats, at least, of the weight region: the weight gradients
                                    // stage two chunks of kWgStage / (4 wg_tile) rows there
constexpr int kNW = 9;              // weights of the chain
constexpr int kJobs = 15;           // weight and bias gradients
constexpr int kMaxDev = 64;

// the weights, in the order of the forward chain
enum { W_HW, W_WZ, W_HX, W_HW2, W_ZZ, W_DW, W_DZ, W_DXP, W_XH };

__host__ __device__ constexpr long long up4(long long n) { return (n + 3) & ~3LL; }
__host__ __device__ constexpr long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

struct Dims {
  int B, D, Cw, H, L, K, xp;
};

// [in, out] of each weight (rows 0: the weight is absent)
inline void weight_shapes(const Dims& d, int rows[kNW], int cols[kNW]) {
  const int K2 = 2 * (d.K - 1), L2 = 2 * d.L;
  const int r[kNW] = {d.D, d.Cw, d.D, d.K, d.H, d.K, d.L, d.xp ? d.D : 0, d.H};
  const int c[kNW] = {d.Cw, K2, d.H, d.H, L2, d.H, d.H, d.H, d.D};
  for (int w = 0; w < kNW; ++w) rows[w] = r[w], cols[w] = c[w];
}

// floats of a [F][R] tile, kept on 16 bytes
inline long long tile(long long F, int R) { return up4(F * R); }

inline long long fwd_tiles(const Dims& d, int R, int T) {
  const int K1 = d.K - 1;
  // x, x_prev, a1, wargs, w, a2 (a3 too), zargs, z, eps_w, eps_z; the split
  // products' partial sums; the six biases
  return tile(d.D, R) * (1 + d.xp) + tile(d.Cw, R) + tile(2 * K1, R) + tile(d.K, R) +
         tile(d.H, R) + tile(2 * d.L, R) + tile(d.L, R) * 2 + tile(K1, R) + (long long)T * R +
         up4((long long)d.Cw + 2 * K1 + 2LL * d.H + 2 * d.L + d.D);
}

inline long long bwd_tiles(const Dims& d, int R, int T) {
  const int K1 = d.K - 1;
  // dxh, dd (dh too), dwt, dz, dza, dxs, dwa, dhw; staged w, wargs, eps_w,
  // dwargs, zargs, eps_z, dzargs; the split products' partial sums; the
  // relu masks of a3, a2, a1 as bits
  return tile(d.D, R) * 2 + tile(d.H, R) + tile(d.K, R) * 2 + tile(d.L, R) * 2 +
         tile(2 * d.L, R) * 3 + tile(2 * K1, R) * 3 + tile(d.Cw, R) + tile(K1, R) +
         (long long)T * R + tile(cdiv(d.H, 32), R) * 2 + tile(cdiv(d.Cw, 32), R);
}

inline long long smem_bytes(long long wfloats, long long tiles) {
  return kBarBytes + 4 * (wfloats + tiles);
}

struct Plan {
  int resident;        // 1: every weight resident in shared memory; 0: streamed
  int rows, threads;   // batch rows and threads a block
  int stages, slot;    // the ring (streamed): slots, floats a slot
  int tiles;           // row tiles, ceil(B / rows)
  int wg_tile;         // the weight-gradient tile's width
  int wg_tiles;        // the backward's weight-gradient tiles
  long long wfloats;   // floats of the weight region (resident weights or ring)
  long long fwd_smem, bwd_smem;  // dynamic shared memory bytes of each kernel
  long long scratch;   // floats of the backward's scratch
};

inline int wg_jobs(const Dims& d, int M[kJobs], int N[kJobs]) {
  const int K2 = 2 * (d.K - 1), L2 = 2 * d.L;
  const int m[kJobs] = {d.D, 1, d.Cw, 1, d.D, d.K, 1, d.H, 1, d.K, d.L, 1, d.H, 1, d.D};
  const int n[kJobs] = {d.Cw, d.Cw, K2, K2, d.H, d.H, d.H, L2, L2, d.H, d.H, d.H, d.D, d.D, d.H};
  const int nj = d.xp ? kJobs : kJobs - 1;
  for (int j = 0; j < nj; ++j) M[j] = m[j], N[j] = n[j];
  return nj;
}

// The layout of a call (ops/vae_dense.plan is its mirror); false where the
// dense-stack kernels refuse the shape (ops/vae_dense.fits's rule).
bool make_plan(const Dims& d, Plan& p) {
  if (d.B < 1 || d.D < 1 || d.Cw < 1 || d.H < 1 || d.K < 2 || d.K > 128 || d.L < 1 ||
      d.L > 128)
    return false;
  // the rule: a 4-row tile of the first design's activations fits one block
  const long long K1 = d.K - 1;
  const long long f_old = (long long)d.D * (1 + d.xp) + d.Cw + 2 * K1 + d.K + 2LL * d.H + 3LL * d.L;
  const long long b_old = 2LL * d.D + 2LL * d.H + d.K + 3LL * d.L + 2 * K1 + d.Cw;
  if (16 * (f_old > b_old ? f_old : b_old) > kLimit) return false;
  int rows[kNW], cols[kNW];
  weight_shapes(d, rows, cols);
  long long wres = 0;
  int maxc = 0;  // a slot holds one row of every weight, and one column (the backward's bands)
  for (int w = 0; w < kNW; ++w)
    if (rows[w]) {
      wres += up4((long long)rows[w] * cols[w]);
      if (cols[w] > maxc) maxc = cols[w];
      if (rows[w] + 1 > maxc) maxc = rows[w] + 1;
    }
  if (wres < kWgStage) wres = kWgStage;
  p = Plan{};
  const int R = kResRows, T = kResThreads;
  if (smem_bytes(wres, fwd_tiles(d, R, T)) <= kLimit &&
      smem_bytes(wres, bwd_tiles(d, R, T)) <= kLimit) {
    p.resident = 1, p.rows = R, p.threads = T, p.wfloats = wres;
  } else {
    p.slot = (int)up4(maxc > kSlotMin ? maxc : kSlotMin);
    for (int stages = kStages; stages >= 2 && !p.rows; --stages) {
      const long long wf = (long long)stages * p.slot > kWgStage ? (long long)stages * p.slot
                                                                 : kWgStage;
      for (int r = 8; r >= 1 && !p.rows; r /= 2)
        if (smem_bytes(wf, fwd_tiles(d, r, kStrThreads)) <= kLimit &&
            smem_bytes(wf, bwd_tiles(d, r, kStrThreads)) <= kLimit)
          p.rows = r, p.threads = kStrThreads, p.stages = stages, p.wfloats = wf;
    }
    if (!p.rows) return false;
  }
  p.tiles = (int)cdiv(d.B, p.rows);
  p.wg_tile = d.B <= 256 ? 32 : 64;
  int M[kJobs], N[kJobs];
  const int nj = wg_jobs(d, M, N);
  for (int j = 0; j < nj; ++j)
    p.wg_tiles += (int)(cdiv(M[j], p.wg_tile) * cdiv(N[j], p.wg_tile));
  p.fwd_smem = smem_bytes(p.wfloats, fwd_tiles(d, p.rows, p.threads));
  p.bwd_smem = smem_bytes(p.wfloats, bwd_tiles(d, p.rows, p.threads));
  p.scratch = (long long)d.B * (d.D + 2LL * d.H + 3LL * d.L + 2 * K1 + d.Cw);
  return true;
}

// ------------------------------------------------------------ device side

struct Weights {        // the chain's weights as stored, [in, out] row-major
  const float* p[kNW];
  int rows[kNW], cols[kNW];
  int order[kNW];       // the order the chain reads them
  int band;             // streamed chunks are column bands stored transposed (the backward)
};

struct Layout {
  int resident, stages, slot, wg_tile;
  long long wfloats;
};

// the parts of a call that block 0 times (ops/vae_dense.FWD_PARTS, BWD_PARTS)
constexpr int kFwdParts = 8, kBwdParts = 11;

struct FwdArgs {
  Weights W;
  Layout lay;
  const float *x, *xp, *eps_w, *eps_z;
  const float *bhw, *bwz, *bh, *bzz, *bd, *bxh;
  float *xhat, *wargs, *zargs, *w, *a1, *a2, *a3;
  unsigned long long* clock;  // block 0's ns of each of kFwdParts parts (or null)
  int B, D, Cw, H, L, K;
};

struct BwdArgs {
  Weights W;
  Layout lay;
  const float *x, *xp, *eps_w, *eps_z, *a1, *a2, *a3, *xhat, *wargs, *zargs, *w;
  const float *dxhat, *dwargs, *dzargs, *dw;
  float *dx, *dxp;
  // scratch: each layer's pre-activation cotangent, and z
  float *dxh_pre, *dd_pre, *dza, *dh_pre, *dwa, *dhw_pre, *zs;
  cvl::WgradJob jobs[kJobs];  // C[M, N] = A^T G over the B rows (f32; A null: a bias)
  int njobs, wg_tiles, tiles;
  unsigned* bar;        // the grid barrier's state (two words, zero before the first launch)
  unsigned long long* clock;  // block 0's ns of each of kBwdParts parts (or null)
  int B, D, Cw, H, L, K;
};

using cvl::cp_async16;
using cvl::cp_async4;
using cvl::cp_commit;
using cvl::cp_wait;
using cvl::smem_addr;

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// `bytes` (a multiple of 16) from global `src` (on 16 bytes) to shared `dst`
// (on 16 bytes), completing on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// this thread's copies of all but its newest n groups landed
__device__ __forceinline__ void wait_all_but(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    default: cp_wait<5>(); break;
  }
}

using cvl::ldv;

// R consecutive floats (on 4 R bytes) from registers
template <int R>
__device__ __forceinline__ void stv(float* p, const float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (R == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// e = a F + b walked by steps of T, one division at the start
struct Walk {
  int a, b, da, db, F;
  __device__ __forceinline__ Walk(int e, int F_, int T) : F(F_) {
    a = e / F;
    b = e - a * F;
    da = T / F;
    db = T - da * F;
  }
  __device__ __forceinline__ void next() {
    a += da;
    b += db;
    if (b >= F) b -= F, ++a;
  }
};

// Where a chain's products read their weights: resident regions, one
// mbarrier each, or a ring of chunks filled `stages - 1` chunks ahead. A
// chunk is a run of whole rows of one weight ([rows][cols] as stored), or in
// a band chain a run of whole columns ([rows][len], each row's run as
// stored). Every thread of the block runs the same calls in the same order.
template <int T>
struct Chain {
  float* reg;       // the weight region
  uint64_t* bars;   // one per weight (resident)
  int pw, pk;       // the next chunk to issue: its weight's place in the order, its first row / column
  int left;         // chunks still to issue
  int used;         // chunks consumed

  __device__ static int extent(const Weights& W, int w) { return W.band ? W.cols[w] : W.rows[w]; }

  __device__ static int chunk_len(const Weights& W, const Layout& lay, int w) {
    if (W.band) {
      int nb = lay.slot / W.rows[w];
      if (nb >= 8) nb &= ~7;  // whole 32-byte sectors of each row, and 16-byte pieces
      return min(nb, W.cols[w]);
    }
    return min(lay.slot / W.cols[w], W.rows[w]);
  }

  __device__ static size_t offset(const Weights& W, int w) {
    size_t o = 0;
    for (int v = 0; v < w; ++v) o += up4((size_t)W.rows[v] * W.cols[v]);
    return o;
  }

  // Start the copies of a block that runs `tiles` row tiles (none: no copy).
  __device__ void start(const Weights& W, const Layout& lay, int tiles) {
    used = pw = pk = left = 0;
    if (tiles == 0) return;
    if (lay.resident) {
      if (threadIdx.x == 0) {
        for (int w = 0; w < kNW; ++w) mbar_init(bars + w, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      __syncthreads();
      if (threadIdx.x == 0)
        for (int i = 0; i < kNW; ++i)
          if (W.rows[W.order[i]]) stage(W, W.order[i]);
      return;
    }
    int per = 0;
    for (int i = 0; i < kNW; ++i) {
      const int w = W.order[i];
      if (W.rows[w]) per += (extent(W, w) + chunk_len(W, lay, w) - 1) / chunk_len(W, lay, w);
    }
    left = per * tiles;
    skip_absent(W);
    for (int s = 0; s + 1 < lay.stages; ++s) {
      issue(W, lay, s);
      cp_commit();
    }
  }

  // thread 0: weight w into its region, one bulk copy of its 16-byte chunks
  // completing on its barrier; the tail (or a misaligned source) by hand
  __device__ void stage(const Weights& W, int w) {
    const float* src = W.p[w];
    float* dst = reg + offset(W, w);
    const size_t n = (size_t)W.rows[w] * W.cols[w];
    const size_t nb = ((uintptr_t)src & 15) ? 0 : (n & ~(size_t)3);
    for (size_t i = nb; i < n; ++i) dst[i] = src[i];
    mbar_arrive_expect_tx(bars + w, (unsigned)(nb * 4));
    if (nb) bulk_g2s(dst, src, (unsigned)(nb * 4), bars + w);
  }

  __device__ void skip_absent(const Weights& W) {
    while (W.rows[W.order[pw]] == 0) pw = (pw + 1) % kNW;
  }

  // all threads: the next chunk of the ring's sequence into slot `s`
  __device__ void issue(const Weights& W, const Layout& lay, int s) {
    if (left == 0) return;
    const int w = W.order[pw];
    const int len = min(chunk_len(W, lay, w), extent(W, w) - pk);
    float* dst = reg + (size_t)s * lay.slot;
    if (W.band) {
      // the band W[:, pk .. pk + len) as [rows][len]: 16-byte pieces where
      // every row's run starts on 16 bytes, else single floats
      const int J = W.rows[w], N = W.cols[w];
      const float* src = W.p[w] + pk;
      if (((uintptr_t)src & 15) == 0 && (N & 3) == 0 && (len & 3) == 0) {
        for (Walk e(threadIdx.x, len >> 2, T); e.a < J; e.next())
          cp_async16(dst + (size_t)e.a * len + 4 * e.b, src + (size_t)e.a * N + 4 * e.b);
      } else {
        for (Walk e(threadIdx.x, len, T); e.a < J; e.next())
          cp_async4(dst + (size_t)e.a * len + e.b, src + (size_t)e.a * N + e.b);
      }
    } else {
      const float* g = W.p[w] + (size_t)pk * W.cols[w];
      const int n = len * W.cols[w];
      int i0 = 0;
      if (((uintptr_t)g & 15) == 0) {
        const int n4 = n >> 2;
        for (int i = threadIdx.x; i < n4; i += T) cp_async16(dst + 4 * i, g + 4 * i);
        i0 = n4 << 2;
      }
      for (int i = i0 + threadIdx.x; i < n; i += T) cp_async4(dst + i, g + i);
    }
    --left;
    pk += len;
    if (pk >= extent(W, w)) {
      pk = 0;
      pw = (pw + 1) % kNW;
      skip_absent(W);
    }
  }

  // f(k0, kc, chunk in shared memory, its row stride) over weight w's chunks
  // in order: rows k0 .. k0 + kc of a row chunk (resident: the whole
  // weight), columns k0 .. k0 + kc of a band (stride kc)
  template <class F>
  __device__ __forceinline__ void each(const Weights& W, const Layout& lay, int w, F f) {
    const int rows = W.rows[w];
    if (rows == 0) return;
    if (lay.resident) {
      mbar_wait(bars + w, 0);
      f(0, rows, reg + offset(W, w), W.cols[w]);
      return;
    }
    const int ext = extent(W, w), len = chunk_len(W, lay, w);
    for (int k0 = 0; k0 < ext; k0 += len) {
      wait_all_but(lay.stages - 2);
      __syncthreads();  // this chunk landed for every thread; the previous slot is free
      issue(W, lay, (used + lay.stages - 1) % lay.stages);
      cp_commit();
      const int kc = min(len, ext - k0);
      f(k0, kc, reg + (size_t)(used % lay.stages) * lay.slot, W.band ? kc : W.cols[w]);
      ++used;
    }
  }

  // every copy landed and every thread past the products
  __device__ void drain(const Layout& lay) {
    if (!lay.resident) cp_wait<0>();
    __syncthreads();
  }
};

// S groups of N threads split a product's k when N is at most half a block
template <int T>
__device__ __forceinline__ int groups_for(int N) { return 2 * N <= T ? T / N : 1; }

// v[r] gains the sum over k in [k0, k1) of a[k R + r] * wp[(k - k0) ld], in
// k order.
template <int R>
__device__ __forceinline__ void fwd_acc(float (&v)[R], const float* a, int k0, int k1,
                                        const float* wp, int ld) {
  const float* ap = a + (size_t)k0 * R;
#pragma unroll 4
  for (int k = k0; k < k1; ++k, wp += ld, ap += R) {
    const float wv = *wp;
    float av[R];
    ldv<R>(ap, av);
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = fmaf(av[r], wv, v[r]);
  }
}

// v[r] gains the sum over n in [0, len) of g[n R + r] * wr[n], walked from n
// = o around.
template <int R>
__device__ __forceinline__ void bwd_acc(float (&v)[R], const float* g, const float* wr, int len,
                                        int o) {
  for (int t = 0; t < len; ++t) {
    const float wv = wr[o];
    float gv[R];
    ldv<R>(g + (size_t)o * R, gv);
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = fmaf(gv[r], wv, v[r]);
    if (++o == len) o = 0;
  }
}

// A chunk's share of a product over k, into shared-memory cells: cell c =
// s N + n of `acc` (group s, output column n) gains the sum over the
// group's part of the chunk's k of a[k R + r] * wc[k ld + n] (wc: the
// chunk's [kc][ld] rows; a from the chunk's first k). S > 1: at most one
// cell a thread.
template <int R, int T>
__device__ __forceinline__ void fwd_chunk(float* acc, int N, int S, const float* a, int kc,
                                          const float* wc, int ld) {
  for (int c = threadIdx.x; c < S * N; c += T) {
    const int s = S == 1 ? 0 : c / N, n = c - s * N;
    const int k0 = S == 1 ? 0 : kc * s / S, k1 = S == 1 ? kc : kc * (s + 1) / S;
    float v[R];
    ldv<R>(acc + (size_t)c * R, v);
    fwd_acc<R>(v, a, k0, k1, wc + (size_t)k0 * ld + n, ld);
    stv<R>(acc + (size_t)c * R, v);
  }
}

// A transposed product, W [N][ld] in shared memory as stored (a resident
// weight, or a band of columns), into shared-memory cells: cell c = s N + j
// of `acc` gains the sum over the group's part of [0, ld) of g[k R + r] *
// wc[j ld + k]. Each thread walks its row of W from its own offset (j mod
// len for even ld, where neighbouring rows would share a bank), so the
// lanes of a warp read different banks. S > 1: at most one cell a thread.
template <int R, int T>
__device__ __forceinline__ void bwd_chunk(float* acc, int N, int S, const float* g, int ld,
                                          const float* wc) {
  const bool rot = (ld & 1) == 0;
  for (int c = threadIdx.x; c < S * N; c += T) {
    const int s = S == 1 ? 0 : c / N, j = c - s * N;
    const int k0 = S == 1 ? 0 : ld * s / S, len = (S == 1 ? ld : ld * (s + 1) / S) - k0;
    if (len <= 0) continue;
    float v[R];
    ldv<R>(acc + (size_t)c * R, v);
    bwd_acc<R>(v, g + (size_t)k0 * R, wc + (size_t)j * ld + k0, len, rot ? j % len : 0);
    stv<R>(acc + (size_t)c * R, v);
  }
}

struct Op {             // an operand of a layer: a [k][R] tile times weight w
  const float* a;
  int w;
  int t;                // 1: times W transposed (the backward's products)
};

constexpr int kCells = 4;  // outputs a thread keeps in registers in an unsplit layer

// One layer: out(n, r) = bias[n] (null: 0) + the sum over the operands, then
// epi(n, r, value) for every output column n < N and tile row r. An unsplit
// layer of at most kCells T outputs keeps each thread's outputs in
// registers; otherwise `out` ([N][R]) holds the sums where the layer is not
// split, `part` where it is.
template <int R, int T, int NOps, class Epi>
__device__ __forceinline__ void layer(Chain<T>& ch, const Weights& W, const Layout& lay,
                                      const Op (&ops)[NOps], int N, const float* bias, float* out,
                                      float* part, Epi epi) {
  const int S = groups_for<T>(N);
  if (S == 1 && N <= kCells * T) {
    float v[kCells][R];
    int nq = 0;
#pragma unroll
    for (int q = 0; q < kCells; ++q) {
      const int n = threadIdx.x + q * T;
      nq += n < N;
      const float b = n < N && bias ? bias[n] : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) v[q][r] = b;
    }
#pragma unroll
    for (int i = 0; i < NOps; ++i)
      ch.each(W, lay, ops[i].w, [&](int k0, int kc, const float* wc, int ld) {
        const float* a = ops[i].a + (size_t)(ops[i].t ? 0 : k0) * R;
        if (!ops[i].t) {  // rows k of W [kc][ld], output columns n
#pragma unroll 2
          for (int k = 0; k < kc; ++k) {
            float av[R];
            ldv<R>(a + (size_t)k * R, av);
#pragma unroll
            for (int q = 0; q < kCells; ++q) {
              if (q >= nq) break;
              const float wv = wc[(size_t)k * ld + threadIdx.x + q * T];
#pragma unroll
              for (int r = 0; r < R; ++r) v[q][r] = fmaf(av[r], wv, v[q][r]);
            }
          }
        } else {  // W [N][ld] as stored: output j walks its row, k in order
          const float* g = ops[i].a + (size_t)k0 * R;
          const int k4 = (ld & 3) == 0 ? ld : 0;
          for (int k = 0; k < k4; k += 4) {
            float gv[4][R];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) ldv<R>(g + (size_t)(k + kk) * R, gv[kk]);
#pragma unroll
            for (int q = 0; q < kCells; ++q) {
              if (q >= nq) break;
              const float4 w4 = *reinterpret_cast<const float4*>(
                  wc + (size_t)(threadIdx.x + q * T) * ld + k);
              const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int r = 0; r < R; ++r) v[q][r] = fmaf(gv[kk][r], wk[kk], v[q][r]);
            }
          }
          for (int k = k4; k < ld; ++k) {
            float gv[R];
            ldv<R>(g + (size_t)k * R, gv);
#pragma unroll
            for (int q = 0; q < kCells; ++q) {
              if (q >= nq) break;
              const float wv = wc[(size_t)(threadIdx.x + q * T) * ld + k];
#pragma unroll
              for (int r = 0; r < R; ++r) v[q][r] = fmaf(gv[r], wv, v[q][r]);
            }
          }
        }
      });
#pragma unroll
    for (int q = 0; q < kCells; ++q) {
      if (q >= nq) break;
#pragma unroll
      for (int r = 0; r < R; ++r) epi(threadIdx.x + q * T, r, v[q][r]);
    }
    __syncthreads();
    return;
  }
  float* acc = S == 1 ? out : part;
  for (int c = threadIdx.x; c < S * N; c += T) {
    const float b = S == 1 && bias ? bias[c] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[(size_t)c * R + r] = b;
  }
#pragma unroll
  for (int i = 0; i < NOps; ++i)
    ch.each(W, lay, ops[i].w, [&](int k0, int kc, const float* wc, int ld) {
      if (ops[i].t)
        bwd_chunk<R, T>(acc, N, S, ops[i].a + (size_t)k0 * R, ld, wc);
      else
        fwd_chunk<R, T>(acc, N, S, ops[i].a + (size_t)k0 * R, kc, wc, ld);
    });
  __syncthreads();
  for (Walk e(threadIdx.x, N, T); e.a < R; e.next()) {
    const int r = e.a, n = e.b;
    float v;
    if (S == 1) {
      v = acc[(size_t)n * R + r];
    } else {
      v = bias ? bias[n] : 0.f;
      for (int s = 0; s < S; ++s) v += part[(size_t)(s * N + n) * R + r];
    }
    epi(n, r, v);
  }
  __syncthreads();
}

// Transposed products of one input g with several resident weights of one
// width ld, stacked: the rows of ops[0]'s weight first, then ops[1]'s, ...
// (N of them, at most T), summed as `layer` sums a split layer (no bias);
// then epi(i, j, r, value) for row j of op i and every tile row r. One pass
// of products and one of sums where separate layers would take one each.
template <int R, int T, int NOps, class Epi>
__device__ __forceinline__ void stacked(Chain<T>& ch, const Weights& W, const Layout& lay,
                                        const Op (&ops)[NOps], float* part, Epi epi) {
  int rows[NOps];
  const float* wr[NOps];
  int N = 0;
#pragma unroll
  for (int i = 0; i < NOps; ++i) {
    rows[i] = W.rows[ops[i].w];
    N += rows[i];
    wr[i] = nullptr;
    ch.each(W, lay, ops[i].w, [&](int, int, const float* wc, int) { wr[i] = wc; });
  }
  const int ld = W.cols[ops[0].w], S = groups_for<T>(N);
  const bool rot = (ld & 1) == 0;
  auto which = [&](int n, int& i, int& j, const float*& w) {  // op and row of stacked row n
    i = 0, j = n, w = wr[0];
#pragma unroll
    for (int q = 1; q < NOps; ++q)
      if (i == q - 1 && j >= rows[q - 1]) i = q, j -= rows[q - 1], w = wr[q];
  };
  for (int c = threadIdx.x; c < S * N; c += T) {
    const int s = c / N, n = c - s * N;
    const int k0 = ld * s / S, len = ld * (s + 1) / S - k0;
    int i, j;
    const float* w;
    which(n, i, j, w);
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = 0.f;
    if (len > 0) bwd_acc<R>(v, ops[0].a + (size_t)k0 * R, w + (size_t)j * ld + k0, len,
                            rot ? n % len : 0);
    stv<R>(part + (size_t)c * R, v);
  }
  __syncthreads();
  for (Walk e(threadIdx.x, N, T); e.a < R; e.next()) {
    const int r = e.a, n = e.b;
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += part[(size_t)(s * N + n) * R + r];
    int i, j;
    const float* w;
    which(n, i, j, w);
    epi(i, j, r, v);
  }
  __syncthreads();
}

struct Seg {            // a gather's piece: F floats (a vector), or a [F][R] tile of rows of [B, F]
  float* dst;
  const float* src;     // null: nothing
  int F, tile;
};

// The segments into shared memory by cp.async (rows >= B written as zero),
// committed as one group: every thread's loads in flight together.
template <int R, int T, int NS>
__device__ __forceinline__ void gather(const Seg (&sg)[NS], int B, int s0) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (!sg[s].src) continue;
    const int F = sg[s].F;
    if (!sg[s].tile) {
      for (int e = threadIdx.x; e < F; e += T) cp_async4(sg[s].dst + e, sg[s].src + e);
      continue;
    }
    for (Walk e(threadIdx.x, F, T); e.a < R; e.next()) {
      float* d = sg[s].dst + (size_t)e.b * R + e.a;
      if (s0 + e.a < B)
        cp_async4(d, sg[s].src + (size_t)(s0 + e.a) * F + e.b);
      else
        *d = 0.f;
    }
  }
  cp_commit();
}

constexpr int kB = 4;  // elements a thread loads before it uses them, in an elementwise step

// The relu masks (act > 0) of the tile's rows of a3 and a2 ([B, H]) and a1
// ([B, Cw]) as bits (bit n & 31 of word r ceil(F / 32) + (n >> 5); rows >=
// B: 0), a warp's ballot making each word, and the frame head's sigmoid
// backward (dxh = dxhat xhat (1 - xhat), to dxh_pre and its tile): each
// round issues every load of the round (kB words a warp, kB elements a
// thread) before it uses one.
template <int R, int T>
__device__ __forceinline__ void masks_and_head(const BwdArgs& a, int s0, unsigned* m3,
                                               unsigned* m2, unsigned* m1, float* dxh) {
  constexpr int kWarps = T / 32;
  const int B = a.B, D = a.D, H = a.H, Cw = a.Cw;
  const int wh = (H + 31) / 32, wc = (Cw + 31) / 32, mt = R * wh, tasks = 2 * mt + R * wc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int tb = 0, eb = 0; tb < tasks || eb < D * R; tb += kB * kWarps, eb += kB * T) {
    float mv[kB], xh[kB], g[kB];
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      int t = tb + q * kWarps + warp;
      const float* act = t < mt ? a.a3 : t < 2 * mt ? a.a2 : a.a1;
      const int F = t < 2 * mt ? H : Cw, words = t < 2 * mt ? wh : wc;
      t -= t < mt ? 0 : t < 2 * mt ? mt : 2 * mt;
      const int r = t / words, n = (t - r * words) * 32 + lane;
      mv[q] = tb + q * kWarps + warp < tasks && s0 + r < B && n < F
                  ? act[(size_t)(s0 + r) * F + n] : 0.f;
      const int i = eb + q * T + threadIdx.x, ri = i / D, ni = i - ri * D;
      xh[q] = g[q] = 0.f;
      if (i < D * R && s0 + ri < B) {
        xh[q] = a.xhat[(size_t)(s0 + ri) * D + ni];
        g[q] = a.dxhat[(size_t)(s0 + ri) * D + ni];
      }
    }
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int t = tb + q * kWarps + warp;
      const unsigned word = __ballot_sync(0xffffffffu, mv[q] > 0.f);
      if (t < tasks && lane == 0)
        *(t < mt ? m3 + t : t < 2 * mt ? m2 + (t - mt) : m1 + (t - 2 * mt)) = word;
      const int i = eb + q * T + threadIdx.x, ri = i / D, ni = i - ri * D;
      if (i >= D * R) continue;
      const bool ok = s0 + ri < B;
      const float v = ok ? g[q] * xh[q] * (1.f - xh[q]) : 0.f;
      if (ok) a.dxh_pre[(size_t)(s0 + ri) * D + ni] = v;
      dxh[(size_t)ni * R + ri] = v;
    }
  }
}

__device__ __forceinline__ bool bit(const unsigned* bits, int words, int n, int r) {
  return (bits[r * words + (n >> 5)] >> (n & 31)) & 1u;
}

template <int R, int T>
__global__ void __launch_bounds__(T, 1) vae_dense_fwd_kernel(const __grid_constant__ FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Weights& W = a.W;
  const Layout& lay = a.lay;
  const int B = a.B, D = a.D, Cw = a.Cw, H = a.H, L = a.L, K = a.K, K1 = K - 1;
  const bool use_xp = a.xp != nullptr;
  Chain<T> ch;
  ch.bars = reinterpret_cast<uint64_t*>(sm);
  ch.reg = sm + kBarBytes / 4;
  float* t = ch.reg + lay.wfloats;
  auto take = [&](long long n) {
    float* p = t;
    t += up4(n);
    return p;
  };
  float* xs = take((long long)D * R);                  // x; the frame head's sums
  float* xps = use_xp ? take((long long)D * R) : xs;   // x_prev
  float* a1s = take((long long)Cw * R);
  float* was = take(2LL * K1 * R);                     // wargs
  float* ws = take((long long)K * R);                  // w
  float* a2s = take((long long)H * R);                 // a2, then a3
  float* zas = take(2LL * L * R);                      // zargs
  float* zs = take((long long)L * R);                  // z
  float* ews = take((long long)K1 * R);                // eps_w
  float* ezs = take((long long)L * R);                 // eps_z
  float* part = take((long long)T * R);                // the split products' partial sums
  float* bias = t;                                     // bhw, bwz, bh, bzz, bd, bxh
  float *bhw = bias, *bwz = bhw + Cw, *bh = bwz + 2 * K1, *bzz = bh + H, *bd = bzz + 2 * L,
        *bxh = bd + H;
  const int s0 = blockIdx.x * R;                       // rows >= B are masked
  auto ok = [&](int r) { return s0 + r < B; };
  cvl_coop::PhaseClock<kFwdParts> clock{blockIdx.x == 0 ? a.clock : nullptr};
  clock.start();

  const Seg segs[] = {{xs, a.x, D, 1},       {xps, a.xp, D, 1},   {ews, a.eps_w, K1, 1},
                      {ezs, a.eps_z, L, 1},  {bhw, a.bhw, Cw, 0}, {bwz, a.bwz, 2 * K1, 0},
                      {bh, a.bh, H, 0},      {bzz, a.bzz, 2 * L, 0}, {bd, a.bd, H, 0},
                      {bxh, a.bxh, D, 0}};
  gather<R, T>(segs, B, s0);
  ch.start(W, lay, 1);  // the weights' copies start behind the inputs'
  wait_all_but(lay.resident ? 0 : lay.stages - 1);
  __syncthreads();
  clock.lap(0);

  // key encoder: a1 = relu(x @ Whw + bhw)
  const Op key_enc[] = {{xs, W_HW, 0}};
  layer<R, T>(ch, W, lay, key_enc, Cw, bhw, a1s, part, [&](int n, int r, float v) {
    v = fmaxf(v, 0.f);
    a1s[(size_t)n * R + r] = v;
    if (ok(r)) a.a1[(size_t)(s0 + r) * Cw + n] = v;
  });
  clock.lap(1);
  // w heads: wargs = a1 @ [Wwm | Wwv] + [bwm | bwv]
  const Op w_heads[] = {{a1s, W_WZ, 0}};
  layer<R, T>(ch, W, lay, w_heads, 2 * K1, bwz, was, part, [&](int n, int r, float v) {
    was[(size_t)n * R + r] = v;
    if (ok(r)) a.wargs[(size_t)(s0 + r) * 2 * K1 + n] = v;
  });
  clock.lap(2);
  // logistic-normal sample: softmax over the K-1 noisy logits and the pinned
  // zero logit, one thread a row
  if (threadIdx.x < R) {
    const int r = threadIdx.x, s = s0 + r;
    float m = 0.f;  // the zero logit
    for (int j = 0; j < K1; ++j) {
      const float wn = was[j * R + r] + expf(was[(K1 + j) * R + r] / 2.f) * ews[j * R + r];
      ws[j * R + r] = wn;
      m = fmaxf(m, wn);
    }
    ws[K1 * R + r] = 0.f;
    float sum = 0.f;
    for (int j = 0; j < K; ++j) {
      const float e = expf(ws[j * R + r] - m);
      ws[j * R + r] = e;
      sum += e;
    }
    for (int j = 0; j < K; ++j) {
      const float v = ws[j * R + r] / sum;
      ws[j * R + r] = v;
      if (s < B) a.w[(size_t)s * K + j] = v;
    }
  }
  __syncthreads();
  clock.lap(3);
  // latent encoder: a2 = relu(x @ Whx + w @ Whw2 + bh)
  const Op lat_enc[] = {{xs, W_HX, 0}, {ws, W_HW2, 0}};
  layer<R, T>(ch, W, lay, lat_enc, H, bh, a2s, part, [&](int n, int r, float v) {
    v = fmaxf(v, 0.f);
    a2s[(size_t)n * R + r] = v;
    if (ok(r)) a.a2[(size_t)(s0 + r) * H + n] = v;
  });
  clock.lap(4);
  // z heads: zargs = a2 @ [Wzm | Wzv] + [bzm | bzv]
  const Op z_heads[] = {{a2s, W_ZZ, 0}};
  layer<R, T>(ch, W, lay, z_heads, 2 * L, bzz, zas, part, [&](int n, int r, float v) {
    zas[(size_t)n * R + r] = v;
    if (ok(r)) a.zargs[(size_t)(s0 + r) * 2 * L + n] = v;
  });
  // z sample
  for (int i = threadIdx.x; i < L * R; i += T) {
    const int l = i / R, r = i - l * R;
    zs[i] = zas[l * R + r] + expf(zas[(L + l) * R + r] / 2.f) * ezs[i];
  }
  __syncthreads();
  clock.lap(5);
  // decoder: a3 = relu(w @ Wdw + z @ Wdz [+ x_prev @ Wdxp] + bd), into a2's tile
  const Op dec[] = {{ws, W_DW, 0}, {zs, W_DZ, 0}, {xps, W_DXP, 0}};
  layer<R, T>(ch, W, lay, dec, H, bd, a2s, part, [&](int n, int r, float v) {
    v = fmaxf(v, 0.f);
    a2s[(size_t)n * R + r] = v;
    if (ok(r)) a.a3[(size_t)(s0 + r) * H + n] = v;
  });
  clock.lap(6);
  // frame head: xhat = sigmoid(a3 @ Wxh + bxh), summed in x's tile
  const Op head[] = {{a2s, W_XH, 0}};
  layer<R, T>(ch, W, lay, head, D, bxh, xs, part, [&](int n, int r, float v) {
    if (ok(r)) a.xhat[(size_t)(s0 + r) * D + n] = 1.f / (1.f + expf(-v));
  });
  ch.drain(lay);
  clock.lap(7);
  clock.flush();
}

// Every weight and bias gradient, the tiles spread over the grid, each by
// wgrad.cuh's tile loop; `buf` (at least kWgStage floats) stages their rows.
template <int T, int TILE>
__device__ __forceinline__ void weight_gradients(const BwdArgs& a, float* buf) {
  constexpr int kChunk = kWgStage / (4 * TILE);
  constexpr int TM = TILE * 16 / T, TN = TILE / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[TM][TN];
  for (int tl = blockIdx.x; tl < a.wg_tiles; tl += gridDim.x) {
    int j = 0, rest = tl;
    for (;; ++j) {
      const int tn = (a.jobs[j].N + TILE - 1) / TILE;
      const int n = (a.jobs[j].M + TILE - 1) / TILE * tn;
      if (rest < n || j + 1 == a.njobs) break;
      rest -= n;
    }
    const cvl::WgradJob& jb = a.jobs[j];
    const int tn = (jb.N + TILE - 1) / TILE, m0 = rest / tn * TILE, n0 = rest % tn * TILE;
    cvl::wgrad_tile<T, TILE, kChunk, false, true>(jb, m0, n0, 0, a.B, buf, buf + 2 * kChunk * TILE,
                                                  acc);
    float* C = static_cast<float*>(jb.C);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        const int n = n0 + tx * TN + q;
        if (m < jb.M && n < jb.N) C[(size_t)m * jb.N + n] = acc[i][q];
      }
    }
  }
}

// The backward's row pass over the rows s0 .. s0 + R - 1.
template <int R, int T>
struct RowPass {
  float *dxh, *dd, *dwt, *dz, *dza, *dxs, *dwa, *dhw, *part;  // dd holds dh after the decoder
  float *wt, *wat, *ewt, *dwat, *zat, *ezt, *dzat;  // staged w, wargs, eps_w, dwargs, zargs, eps_z, dzargs
  unsigned *m3, *m2, *m1;                            // relu masks of a3, a2, a1

  __device__ void run(const BwdArgs& a, Chain<T>& ch, int s0,
                      cvl_coop::PhaseClock<kBwdParts>& clock) {
    const Weights& W = a.W;
    const Layout& lay = a.lay;
    const int B = a.B, D = a.D, Cw = a.Cw, H = a.H, L = a.L, K = a.K, K1 = K - 1;
    const int wh = (H + 31) / 32, wc = (Cw + 31) / 32;
    auto ok = [&](int r) { return s0 + r < B; };
    // every row input of the tile: staged by cp.async (dw into dwt, where the
    // decoder's share adds to it), the relu masks as bits, with the frame
    // head's step
    const Seg segs[] = {{wt, a.w, K, 1},          {wat, a.wargs, 2 * K1, 1},
                        {ewt, a.eps_w, K1, 1},    {dwat, a.dwargs, 2 * K1, 1},
                        {dwt, a.dw, K, 1},        {zat, a.zargs, 2 * L, 1},
                        {ezt, a.eps_z, L, 1},     {dzat, a.dzargs, 2 * L, 1}};
    gather<R, T>(segs, B, s0);
    masks_and_head<R, T>(a, s0, m3, m2, m1, dxh);
    // the staged rows (streamed: the ring's first wait covers them too)
    if (lay.resident) cp_wait<0>();
    __syncthreads();
    clock.lap(0);
    // decoder: dd_pre = (dxh_pre @ Wxh^T) * (a3 > 0)
    const Op head[] = {{dxh, W_XH, 1}};
    layer<R, T>(ch, W, lay, head, H, nullptr, dd, part, [&](int j, int r, float v) {
      v = bit(m3, wh, j, r) ? v : 0.f;
      dd[(size_t)j * R + r] = v;
      if (ok(r)) a.dd_pre[(size_t)(s0 + r) * H + j] = v;
    });
    clock.lap(1);
    // dd_pre @ (Wdw | Wdxp | Wdz)^T: the decoder's share of dw, dx_prev, dz
    auto dwt_add = [&](int j, int r, float v) { dwt[(size_t)j * R + r] = dwt[(size_t)j * R + r] + v; };
    auto dxp_out = [&](int j, int r, float v) {
      if (ok(r)) a.dxp[(size_t)(s0 + r) * D + j] = v;
    };
    auto dz_out = [&](int j, int r, float v) { dz[(size_t)j * R + r] = v; };
    const Op dec_w[] = {{dd, W_DW, 1}}, dec_xp[] = {{dd, W_DXP, 1}}, dec_z[] = {{dd, W_DZ, 1}};
    if (lay.resident && K + W.rows[W_DXP] + L <= T) {
      const Op dec[] = {dec_w[0], dec_xp[0], dec_z[0]};
      stacked<R, T>(ch, W, lay, dec, part, [&](int i, int j, int r, float v) {
        if (i == 0) dwt_add(j, r, v);
        else if (i == 1) dxp_out(j, r, v);
        else dz_out(j, r, v);
      });
    } else {
      layer<R, T>(ch, W, lay, dec_w, K, nullptr, dwt, part, dwt_add);
      if (a.dxp) layer<R, T>(ch, W, lay, dec_xp, D, nullptr, dxs, part, dxp_out);
      layer<R, T>(ch, W, lay, dec_z, L, nullptr, dz, part, dz_out);
    }
    clock.lap(2);
    // z sample + z heads backward, z recomputed from the zargs residual
    for (Walk e(threadIdx.x, L, T); e.a < R; e.next()) {
      const int r = e.a, l = e.b;
      float dzm = 0.f, dzv = 0.f;
      if (ok(r)) {
        const size_t o = (size_t)(s0 + r) * 2 * L;
        const float sig = expf(zat[(size_t)(L + l) * R + r] / 2.f);
        const float ez = ezt[(size_t)l * R + r];
        const float dzl = dz[(size_t)l * R + r];
        dzm = dzl + dzat[(size_t)l * R + r];
        dzv = dzl * ez * sig * 0.5f + dzat[(size_t)(L + l) * R + r];
        a.dza[o + l] = dzm;
        a.dza[o + L + l] = dzv;
        a.zs[(size_t)(s0 + r) * L + l] = zat[(size_t)l * R + r] + sig * ez;
      }
      dza[(size_t)l * R + r] = dzm;
      dza[(size_t)(L + l) * R + r] = dzv;
    }
    __syncthreads();
    clock.lap(3);
    // latent encoder: dh_pre = (dzargs @ Wzz^T) * (a2 > 0)
    const Op z_heads[] = {{dza, W_ZZ, 1}};
    layer<R, T>(ch, W, lay, z_heads, H, nullptr, dd, part, [&](int j, int r, float v) {
      v = bit(m2, wh, j, r) ? v : 0.f;
      dd[(size_t)j * R + r] = v;
      if (ok(r)) a.dh_pre[(size_t)(s0 + r) * H + j] = v;
    });
    clock.lap(4);
    // dh_pre @ (Whx | Whw2)^T: the latent encoder's share of dx and of dw
    auto dxs_out = [&](int j, int r, float v) { dxs[(size_t)j * R + r] = v; };
    auto dwt_acc = [&](int j, int r, float v) { dwt[(size_t)j * R + r] += v; };
    const Op lat_x[] = {{dd, W_HX, 1}}, lat_w[] = {{dd, W_HW2, 1}};
    if (lay.resident && D + K <= T) {
      const Op lat[] = {lat_x[0], lat_w[0]};
      stacked<R, T>(ch, W, lay, lat, part, [&](int i, int j, int r, float v) {
        if (i == 0) dxs_out(j, r, v);
        else dwt_acc(j, r, v);
      });
    } else {
      layer<R, T>(ch, W, lay, lat_x, D, nullptr, dxs, part, dxs_out);
      layer<R, T>(ch, W, lay, lat_w, K, nullptr, dwt, part, dwt_acc);
    }
    clock.lap(5);
    // logistic-normal sample backward: softmax vjp, the pinned zero logit
    // (lane K-1) dropped; one thread a row
    if (threadIdx.x < R) {
      const int r = threadIdx.x, s = s0 + r;
      float dot = 0.f;
      if (s < B)
        for (int j = 0; j < K; ++j) dot += dwt[j * R + r] * wt[j * R + r];
      for (int j = 0; j < K1; ++j) {
        float dwm = 0.f, dwv = 0.f;
        if (s < B) {
          const size_t o = (size_t)s * 2 * K1;
          const float wj = wt[j * R + r];
          const float dl = wj * (dwt[j * R + r] - dot);
          const float sig = expf(wat[(K1 + j) * R + r] / 2.f);
          const float e = ewt[j * R + r];
          dwm = dl + dwat[j * R + r];
          dwv = dl * e * sig * 0.5f + dwat[(K1 + j) * R + r];
          a.dwa[o + j] = dwm;
          a.dwa[o + K1 + j] = dwv;
        }
        dwa[j * R + r] = dwm;
        dwa[(K1 + j) * R + r] = dwv;
      }
    }
    __syncthreads();
    clock.lap(6);
    // key encoder: dhw_pre = (dwargs @ Wwz^T) * (a1 > 0)
    const Op w_heads[] = {{dwa, W_WZ, 1}};
    layer<R, T>(ch, W, lay, w_heads, Cw, nullptr, dhw, part, [&](int j, int r, float v) {
      v = bit(m1, wc, j, r) ? v : 0.f;
      dhw[(size_t)j * R + r] = v;
      if (ok(r)) a.dhw_pre[(size_t)(s0 + r) * Cw + j] = v;
    });
    clock.lap(7);
    // dx = the latent encoder's share + dhw_pre @ Whw^T, summed in dxh's tile
    const Op key_enc[] = {{dhw, W_HW, 1}};
    layer<R, T>(ch, W, lay, key_enc, D, nullptr, dxh, part, [&](int j, int r, float v) {
      if (ok(r)) a.dx[(size_t)(s0 + r) * D + j] = dxs[(size_t)j * R + r] + v;
    });
    clock.lap(8);
  }
};

template <int R, int T>
__global__ void __launch_bounds__(T, 1) vae_dense_bwd_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout& lay = a.lay;
  const int D = a.D, Cw = a.Cw, H = a.H, L = a.L, K = a.K, K1 = K - 1;
  Chain<T> ch;
  ch.bars = reinterpret_cast<uint64_t*>(sm);
  ch.reg = sm + kBarBytes / 4;
  float* t = ch.reg + lay.wfloats;
  auto take = [&](long long n) {
    float* p = t;
    t += up4(n);
    return p;
  };
  RowPass<R, T> rp;
  rp.dxh = take((long long)D * R);
  rp.dd = take((long long)H * R);
  rp.dwt = take((long long)K * R);
  rp.dz = take((long long)L * R);
  rp.dza = take(2LL * L * R);
  rp.dxs = take((long long)D * R);
  rp.dwa = take(2LL * K1 * R);
  rp.dhw = take((long long)Cw * R);
  rp.wt = take((long long)K * R);
  rp.wat = take(2LL * K1 * R);
  rp.ewt = take((long long)K1 * R);
  rp.dwat = take(2LL * K1 * R);
  rp.zat = take(2LL * L * R);
  rp.ezt = take((long long)L * R);
  rp.dzat = take(2LL * L * R);
  rp.part = take((long long)T * R);
  rp.m3 = reinterpret_cast<unsigned*>(take(cdiv(H, 32) * R));
  rp.m2 = reinterpret_cast<unsigned*>(take(cdiv(H, 32) * R));
  rp.m1 = reinterpret_cast<unsigned*>(take(cdiv(Cw, 32) * R));

  cvl_coop::PhaseClock<kBwdParts> clock{blockIdx.x == 0 ? a.clock : nullptr};
  clock.start();
  const int mine = a.tiles > (int)blockIdx.x
                       ? (a.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  ch.start(a.W, lay, mine);
  for (int tl = blockIdx.x; tl < a.tiles; tl += gridDim.x) rp.run(a, ch, tl * R, clock);
  ch.drain(lay);
  clock.lap(8);

  cvl_coop::grid_sync_reusable(a.bar, gridDim.x);
  clock.lap(9);

  if (lay.wg_tile == 32)
    weight_gradients<T, 32>(a, ch.reg);
  else
    weight_gradients<T, 64>(a, ch.reg);
  clock.lap(10);
  clock.flush();
  if (a.clock && blockIdx.x == 0 && threadIdx.x == 0) a.clock[kBwdParts] = gridDim.x;
}

// ------------------------------------------------------------ host side

constexpr int kInstances = 5;

struct DeviceState {
  int sms;
  bool attr[2][kInstances];  // cudaFuncSetAttribute done: [forward, backward][instance]
  long long occ_smem[kInstances];
  int occ[kInstances];       // backward blocks an SM at occ_smem
};

std::mutex g_mu;
DeviceState g_dev[kMaxDev];

// the instance of (rows, threads): 0 resident (512 threads, 4 rows), 1..4
// streamed (256 threads, 1, 2, 4 or 8 rows)
int instance(int R, int T) {
  return T == kResThreads ? 0 : R == 1 ? 1 : R == 2 ? 2 : R == 4 ? 3 : 4;
}

template <int R, int T>
const void* kernel_of(bool bwd) {
  return bwd ? (const void*)vae_dense_bwd_kernel<R, T> : (const void*)vae_dense_fwd_kernel<R, T>;
}

const void* kernel_for(bool bwd, int R, int T) {
  if (T == kResThreads) return kernel_of<kResRows, kResThreads>(bwd);
  switch (R) {
    case 1: return kernel_of<1, kStrThreads>(bwd);
    case 2: return kernel_of<2, kStrThreads>(bwd);
    case 4: return kernel_of<4, kStrThreads>(bwd);
    default: return kernel_of<8, kStrThreads>(bwd);
  }
}

// The current device set to `device` for the scope of a launch.
struct DeviceScope {
  int prev = -1;
  int err = 0;
  explicit DeviceScope(int device) {
    int cur = 0;
    err = (int)cudaGetDevice(&cur);
    if (!err && cur != device) {
      err = (int)cudaSetDevice(device);
      prev = cur;
    }
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// The kernel's shared-memory limit raised once a device; for the backward,
// the blocks the card holds at `smem` bytes a block.
int prepare(int device, bool bwd, const Plan& p, long long smem, int* capacity) {
  if (device < 0 || device >= kMaxDev) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  DeviceState& st = g_dev[device];
  const void* fn = kernel_for(bwd, p.rows, p.threads);
  const int ki = instance(p.rows, p.threads);
  if (!st.attr[bwd][ki]) {
    const int err = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              kLimit);
    if (err) return err;
    st.attr[bwd][ki] = true;
  }
  if (!capacity) return 0;
  if (!st.sms) {
    const int err = (int)cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, device);
    if (err) return err;
  }
  if (st.occ_smem[ki] != smem) {
    int n = 0;
    const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, p.threads,
                                                                       (size_t)smem);
    if (err) return err;
    st.occ[ki] = n;
    st.occ_smem[ki] = smem;
  }
  *capacity = st.occ[ki] * st.sms;
  return 0;
}

void fill_weights(Weights& W, const Dims& d, const float* const* ws, bool bwd) {
  int rows[kNW], cols[kNW];
  weight_shapes(d, rows, cols);
  const int fwd_order[kNW] = {W_HW, W_WZ, W_HX, W_HW2, W_ZZ, W_DW, W_DZ, W_DXP, W_XH};
  const int bwd_order[kNW] = {W_XH, W_DW, W_DXP, W_DZ, W_ZZ, W_HX, W_HW2, W_WZ, W_HW};
  for (int w = 0; w < kNW; ++w) {
    W.p[w] = ws[w];
    W.rows[w] = rows[w];
    W.cols[w] = cols[w];
    W.order[w] = bwd ? bwd_order[w] : fwd_order[w];
  }
  W.band = bwd ? 1 : 0;
}

Layout layout_of(const Plan& p) { return Layout{p.resident, p.stages, p.slot, p.wg_tile, p.wfloats}; }

int backward_blocks(const Plan& p, int capacity) {
  const int want = p.tiles > p.wg_tiles ? p.tiles : p.wg_tiles;
  return want < capacity ? want : capacity;
}

template <int R, int T>
int launch_fwd(const FwdArgs& a, const Plan& p, cudaStream_t stream) {
  vae_dense_fwd_kernel<R, T><<<p.tiles, T, p.fwd_smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int R, int T>
int launch_bwd(const BwdArgs& a, int blocks, long long smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;  // every block co-resident: the grid barrier needs it, or the launch fails
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, vae_dense_bwd_kernel<R, T>, a);
}

}  // namespace

// The plan of a call into out[12]: resident, rows, threads, stages, slot,
// tiles, wg_tile, wg_tiles, wfloats, fwd_smem, bwd_smem, scratch floats.
// Returns 0 where the kernels refuse the shape.
extern "C" int cvl_vae_dense_plan(int B, int D, int Cw, int H, int L, int K, int use_xp,
                                  long long* out) {
  Plan p;
  if (!make_plan(Dims{B, D, Cw, H, L, K, use_xp ? 1 : 0}, p)) return 0;
  const long long f[12] = {p.resident, p.rows,    p.threads, p.stages,   p.slot,     p.tiles,
                           p.wg_tile,  p.wg_tiles, p.wfloats, p.fwd_smem, p.bwd_smem, p.scratch};
  for (int i = 0; i < 12; ++i) out[i] = f[i];
  return 1;
}

// The forward on `stream` of `device`. p: x, xp, eps_w, eps_z, whw, bhw, wwz,
// bwz, whx, whw2, bh, wzz, bzz, wdw, wdxp, wdz, bd, wxh, bxh, then the
// outputs xhat, wargs, zargs, w, a1, a2, a3 (xp and wdxp null without
// use_x_prev), then a clock (null, or kFwdParts words: block 0's ns of each
// part). Returns the cudaError_t of the launch.
extern "C" int cvl_vae_dense_fwd(void* const* p, int B, int D, int Cw, int H, int L, int K,
                                 int use_xp, int device, void* stream) {
  const Dims d{B, D, Cw, H, L, K, use_xp ? 1 : 0};
  Plan pl;
  if (!make_plan(d, pl)) return (int)cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(p);
  float* const* o = reinterpret_cast<float* const*>(p);
  FwdArgs a{};
  const float* ws[kNW] = {f[4], f[6], f[8], f[9], f[11], f[13], f[15], f[14], f[17]};
  fill_weights(a.W, d, ws, false);
  a.lay = layout_of(pl);
  a.x = f[0], a.xp = f[1], a.eps_w = f[2], a.eps_z = f[3];
  a.bhw = f[5], a.bwz = f[7], a.bh = f[10], a.bzz = f[12], a.bd = f[16], a.bxh = f[18];
  a.xhat = o[19], a.wargs = o[20], a.zargs = o[21], a.w = o[22];
  a.a1 = o[23], a.a2 = o[24], a.a3 = o[25];
  a.clock = reinterpret_cast<unsigned long long*>(o[26]);
  a.B = B, a.D = D, a.Cw = Cw, a.H = H, a.L = L, a.K = K;
  const DeviceScope scope(device);
  if (scope.err) return scope.err;
  const int err = prepare(device, false, pl, pl.fwd_smem, nullptr);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pl.threads == kResThreads) return launch_fwd<kResRows, kResThreads>(a, pl, s);
  switch (pl.rows) {
    case 1: return launch_fwd<1, kStrThreads>(a, pl, s);
    case 2: return launch_fwd<2, kStrThreads>(a, pl, s);
    case 4: return launch_fwd<4, kStrThreads>(a, pl, s);
    default: return launch_fwd<8, kStrThreads>(a, pl, s);
  }
}

// The backward on `stream` of `device`: one cooperative launch. p: x, xp,
// eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w, dxhat, dwargs, dzargs, dw,
// whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh, then dx, dxp, dwhw, dbhw,
// dwwz, dbwz, dwhx, dwhw2, dbh, dwzz, dbzz, dwdw, dwdxp, dwdz, dbd, dwxh,
// dbxh, the scratch (the plan's floats), the barrier's two words (zero
// before its first launch, left so by every launch) and a clock (null, or
// kBwdParts + 1 words: block 0's ns of each part, then the grid's blocks).
// xp, wdxp, dxp and dwdxp are null without use_x_prev. Returns the
// cudaError_t of the launch.
extern "C" int cvl_vae_dense_bwd(void* const* p, int B, int D, int Cw, int H, int L, int K,
                                 int use_xp, int device, void* stream) {
  const Dims d{B, D, Cw, H, L, K, use_xp ? 1 : 0};
  Plan pl;
  if (!make_plan(d, pl)) return (int)cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(p);
  float* const* o = reinterpret_cast<float* const*>(p);
  BwdArgs a{};
  const float* ws[kNW] = {f[15], f[16], f[17], f[18], f[19], f[20], f[22], f[21], f[23]};
  fill_weights(a.W, d, ws, true);
  a.lay = layout_of(pl);
  a.x = f[0], a.xp = f[1], a.eps_w = f[2], a.eps_z = f[3];
  a.a1 = f[4], a.a2 = f[5], a.a3 = f[6], a.xhat = f[7], a.wargs = f[8], a.zargs = f[9];
  a.w = f[10], a.dxhat = f[11], a.dwargs = f[12], a.dzargs = f[13], a.dw = f[14];
  a.dx = o[24], a.dxp = o[25];
  float* sc = o[41];
  const size_t b = (size_t)B;
  const int K2 = 2 * (K - 1);
  a.dxh_pre = sc;
  a.dd_pre = a.dxh_pre + b * D;
  a.dza = a.dd_pre + b * H;
  a.dh_pre = a.dza + b * 2 * L;
  a.dwa = a.dh_pre + b * H;
  a.dhw_pre = a.dwa + b * K2;
  a.zs = a.dhw_pre + b * Cw;
  const float* ones = nullptr;
  const cvl::WgradJob jobs[kJobs] = {
      {a.x, a.dhw_pre, o[26], D, Cw},      {ones, a.dhw_pre, o[27], 1, Cw},
      {a.a1, a.dwa, o[28], Cw, K2},        {ones, a.dwa, o[29], 1, K2},
      {a.x, a.dh_pre, o[30], D, H},        {a.w, a.dh_pre, o[31], K, H},
      {ones, a.dh_pre, o[32], 1, H},       {a.a2, a.dza, o[33], H, 2 * L},
      {ones, a.dza, o[34], 1, 2 * L},      {a.w, a.dd_pre, o[35], K, H},
      {a.zs, a.dd_pre, o[37], L, H},       {ones, a.dd_pre, o[38], 1, H},
      {a.a3, a.dxh_pre, o[39], H, D},      {ones, a.dxh_pre, o[40], 1, D},
      {a.xp, a.dd_pre, o[36], D, H},  // last: dropped without use_x_prev
  };
  a.njobs = use_xp ? kJobs : kJobs - 1;
  for (int j = 0; j < a.njobs; ++j) a.jobs[j] = jobs[j];
  a.wg_tiles = pl.wg_tiles;
  a.tiles = pl.tiles;
  a.bar = reinterpret_cast<unsigned*>(o[42]);
  a.clock = reinterpret_cast<unsigned long long*>(o[43]);
  a.B = B, a.D = D, a.Cw = Cw, a.H = H, a.L = L, a.K = K;
  const DeviceScope scope(device);
  if (scope.err) return scope.err;
  int capacity = 0;
  const int err = prepare(device, true, pl, pl.bwd_smem, &capacity);
  if (err) return err;
  if (capacity < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int blocks = backward_blocks(pl, capacity);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pl.threads == kResThreads) return launch_bwd<kResRows, kResThreads>(a, blocks, pl.bwd_smem, s);
  switch (pl.rows) {
    case 1: return launch_bwd<1, kStrThreads>(a, blocks, pl.bwd_smem, s);
    case 2: return launch_bwd<2, kStrThreads>(a, blocks, pl.bwd_smem, s);
    case 4: return launch_bwd<4, kStrThreads>(a, blocks, pl.bwd_smem, s);
    default: return launch_bwd<8, kStrThreads>(a, blocks, pl.bwd_smem, s);
  }
}
