// Whole-generation cl_vae sampler for Hopper (sm_90a): f32 or bf16 weights
// (`generate_kernel`), f32 weights (`generate_wide_kernel`), and one
// cooperative kernel for int8, bf16 or f32 operands
// (`generate_vae_coop_kernel<E>`, at the end).
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_generate_vae.py:141
// `_make_kernel` (the f32/bf16 body of `generate_cl_vae_batch_pallas`). One
// launch runs the whole autoregressive song: relu z-encoder hidden on the
// fed-back frame, the z heads, z = m + exp(v/2)*eps (or z = eps under
// use_z_prior), relu decoder hidden on (w, z, the one-step-lagged frame), the
// sigmoid frame head, the Bernoulli draw x_t = (u < p), and the two carried
// frames (x_prev_t takes the old x_prev before x_prev takes x_t). The
// per-song folds of the w rows and biases (encb, decb) are computed by the
// caller.
//
// What bounds it on this card. At the largest serving bucket of the trained
// checkpoints (64 songs x 256 steps, D=H=88, L=4, use_x_prev) the call is
// 16,384 song-steps x 24,288 f32 FMAs = 0.80 GFLOP, ~0.012 ms at 67 TFLOP/s
// f32 without tensor cores, against ~11.8 MB of eps/u/out streams, ~0.0035 ms
// at HBM rate: operations bound it. But every step depends on the previous
// one through four small dependent products, so the 256 steps run in series
// and the kernel is latency-bound far above that bound.
//
// What the design does about it. Songs are independent: one block owns a
// tile of kSongs songs and runs the WHOLE time loop itself, so nothing is
// carried between blocks (the TPU grid walked time blocks in order and
// carried the frames in VMEM scratch). The weights (~94 KB in f32 at
// D=H=88) are small enough to live in the block's shared memory, as they
// lived in VMEM, so they are loaded from global memory once per block, not
// once per step. Per-song state (both frames, the folds, both hidden layers,
// z) is in shared memory too, stored [row][song]. Each product gives one
// thread an output column for every song of the tile, summing over k in
// registers; the z heads give one warp an output, its lanes splitting k. Each
// phase ends in __syncthreads(). Keeping the chain short (splitting k across
// threads, wgmma) is later work.
//
// Numerics follow the TPU kernel: relu hidden layers, expf for the z scale
// and the logistic head, no fast math. In bf16 mode the encoder x rows, the
// decoder x_prev rows, the z heads and the frame head are bf16 and their
// operands (the frames, h_e, h_d) are rounded to bf16, stored rounded as
// they are only ever read as operands; the decoder z rows, z and every bias
// stay f32, and every product accumulates in f32.
//
// The second kernel, `generate_wide_kernel`, f32 only, takes models without
// hidden layers (which sample in f32), and f32 models too wide for the
// first one (from H ~ 204 at D=88, L=4, use_x_prev) below H=512, where on an
// H100 it is faster than the cooperative kernel (the wrapper's
// `kernel_for`; it took every wider model, in bf16 too, before that kernel
// served f32 and bf16). It replaces the same `_make_kernel` at those
// widths, and the JAX package's XLA scan (sampling/generate.py
// `generate_cl_vae_batch_noise`) for configs without hidden layers, which
// no Pallas kernel takes. It computes exactly what the first kernel
// computes in f32: the same operands (the wrapper's `_pack`), the same
// step order. Without hidden layers
// the z heads read x_prev (and the folded w rows) and the frame head reads z
// as L rank-1 terms and x_prev_t (and the folded w rows).
//
// What bounds the wide kernel. Per song-step it does D*H*(1 + use_x_prev) +
// 3*L*H + H*D FMAs; at f32 D=88, H=256, L=4 with x_prev that is ~69 K FMAs,
// ~2.3 GFLOP for 64 songs x 256 steps, ~0.035 ms at 67 TFLOP/s of f32 FMAs
// (chip_smoke.py's `roofline_ms`). But every block reads all the weights
// from L2 every step (~0.28 MB in f32 at that width), so a step costs about
// the L2-to-SM transfer of the weights, and the steps run in series: the
// kernel sits far above its bound.
//
// What the design does about it, simply. One block owns a tile of kSongs
// songs and runs every step; the per-song state (both frames, the step's
// probabilities, z, h_e, h_d) lives in shared memory, or, past one block's
// shared memory, in a global scratch the wrapper allocates (the same code
// through a generic pointer). The weights are read from global memory (L2)
// every step, as generate_cl_vrnn.cu does; the folds of the w rows stay in
// global memory and are read in each layer's epilogue. A layer with few
// output columns splits its K rows across up to kMaxSlices groups of threads
// so that every thread has loads in flight; the groups' partial sums meet in
// shared memory and are added in a fixed order. Two songs per block give 32
// blocks at the largest serving bucket: more blocks pull more aggregate L2
// bandwidth, and each block's time is set by its own weight stream. Later
// work, not done here: a thread-block cluster that splits the columns so
// that each SM keeps its slice of the weights in shared memory, and wgmma.
//
// The third kernel, `generate_vae_coop_kernel<signed char>` (at the end),
// replaces
// classifying_vae_lstm_tpu/ops/pallas_generate_vae.py:192 `_make_kernel_int8`
// (the int8 body of `generate_cl_vae_batch_pallas`), which the JAX package
// picks for a bf16 checkpoint whose bf16 weights pass its VMEM rule (the
// seq-concat width D=1,024, L=16: H = 4,160 ... 7,808). The three large
// weights (encoder x rows, decoder x_prev rows, frame head) are per-column
// int8 codes with f32 scales, quantized by the wrapper as JAX quantizes
// them; the z heads stay bf16 and the decoder z rows f32.
//
// Numerics. Binary frames are exact codes; the decoder's relu hidden h_d
// gets a per-song scale rs = max(max h_d, 1e-12) / 127 (h_d >= 0, so its max
// is its largest magnitude; a max is exact in any order) and enters the
// frame head as round(h_d / rs) (IEEE division, `__float2int_rn`, half to
// even as jnp.round). Every int8 product sums codes in int32 on the tensor
// cores (`mma.sync.m16n8k32` s8 -> s32), exact in any order. Each column is
// dequantized once and the f32 epilogue is written with __fmul_rn /
// __fadd_rn in the JAX kernel's order (h_e = relu((float)acc * s + encb);
// z_d = decb, then the L z rows, then (float)acc * s; p = sigmoid(((float)acc
// * swx) * rs + bx)), so nvcc contracts nothing into an FMA. The bf16 z heads
// are summed in double (each product of two bf16 values is exact) and
// rounded to f32 once, so the plain version's float64 product gives the
// same z: an f32 sum in another order may differ by an ulp, which h_d / rs
// can turn into another code.
//
// What bounds it. At the seq-concat width (D=1,024, H=5,120, L=16, no
// x_prev), 64 songs x 256 steps, it does 1.05e7 int8 MACs per song-step,
// 1.7e11 MACs (3.4e11 operations) for the call: ~0.17 ms at the card's
// 1,979 TOPS of int8 tensor-core products, against 10.5 MB of int8 weights
// (15.7 MB with x_prev), ~0.003 ms at HBM rate, so operations bound it
// (chip_smoke.py's `int8_bound_ms` prints both). But each step is a chain
// of all-to-all dependencies (the z heads need every unit's h_e, the scale
// rs every unit's h_d, the frame head every unit's code, the next step
// every pitch's frame), 256 steps in series.
//
// What the design does about it.
// * One persistent cooperative launch runs the whole song (a launch takes
//   at most 64 songs, 4 m16 tiles; a call of more runs several). The
//   columns, not the songs, are spread over the card: each block owns nu
//   hidden units (`int8_grid`: nu = 8 cdiv(H, 8 SMs), cdiv(H, nu) blocks;
//   128 blocks of 40 units at H=5,120) for every song, and a slice of the
//   frame head's pitches (8-pitch tiles; with song groups, `head_split`,
//   half the songs of twice the pitches). The first design gave each
//   block two songs and every weight from L2 each step (32 SMs of 132 busy
//   at 64 songs, every product on `__dp4a`).
// * Residency: the wrapper packs each block's slices (its units' columns of
//   the encoder's and decoder's x rows, its pitch tiles of the frame head)
//   contiguously in the order the m16n8k32 B fragments load them; the block
//   copies them into shared memory once a launch where they fit (120 KB at
//   H=5,120 with two song groups), else they stream from L2 every step
//   through the 4-stage `cp.async` ring that carries the codes of x and of
//   h_d (the int8 cl_vrnn kernel's lane layout: any pairing of k gives the
//   same int32 sum). A stage copies each song row's span of 8 or more chunks
//   whole (full 128-byte lines; a row apart by 16 padding bytes in shared
//   memory, off the fragment loads' banks), twice or four times the chunks
//   for a pass of 32 or 16 rows, so that a pass of fewer songs keeps as many
//   bytes in flight; and each block starts at its own stage, so that the
//   blocks do not all ask the same L2 lines at once.
// * A step is five phases with a grid barrier (csrc/coop.cuh) after each:
//   (1) the encoder's product and h_e for the block's units, then the z
//   heads' sums over those units (double, the block's columns of the z
//   heads kept in double, each h_e converted once for four columns); (2) z,
//   one warp a (song, latent), the blocks' sums added in a fixed order;
//   (3) the decoder's h_d for the block's units, and each song's largest
//   over them; (4) rs (every block's maxima loaded at once), and the codes
//   of h_d for the block's units; (5) the frame head for the block's
//   pitches (the codes of every unit, int32 sums exact), the Bernoulli
//   draw, the output and the next step's x_prev codes. Under
//   use_z_prior z is the noise: phases 1 and 2 are skipped. The codes of x
//   (double-buffered: x_prev and the lagged x_prev_t) and of h_d, the z
//   heads' sums, z and the songs' maxima live in global memory, read
//   through L2 (`cp.async.cg`, `__ldcg`: other blocks rewrite them every
//   step); h_e and h_d stay in their owner's shared memory. A grid that
//   cannot be co-resident fails to launch.
// * Every sum in a fixed order or exact, no atomics: two calls give the
//   same bits.
// Known limits: every block reads the codes of x (64 KB at 64 songs, D =
// 1,024) and of its song group's h_d (164 KB at H=5,120) from L2 each step;
// an H100 80GB HBM3 at 700 W moves that broadcast at ~1.4-2.2 TB/s, and the
// frame head's and the encoder's products take ~16 of a step's ~45 us, the
// five grid barriers ~7. Cluster multicast of the codes and `wgmma` are the
// levers.
//
// The same kernel in f32 and bf16, `generate_vae_coop_kernel<float>` and
// `<__nv_bfloat16>`, replaces `_make_kernel` :141 (the f32 / bf16 body of
// `generate_cl_vae_batch_pallas`) at every width with hidden layers that
// the first kernel refuses, where the wide kernel's blocks each owned two
// songs and read every weight from L2 every step (296 ms a call at D=1,024,
// H=5,120, 64 x 256 in bf16, 32 SMs busy). It keeps the int8 design: the
// grid, the song groups of the frame head, the residency rule (in the
// mode's bytes), the ring, the z heads summed across blocks in double in a
// fixed order (a product of two bf16 or two f32 values is exact in double;
// z rounds to f32 once). Its operands are the first kernel's (`_pack`): the
// large weights, x and h_e / h_d as operands in the mode's type (bf16
// rounded as in the first kernel), the decoder z rows and every bias f32.
// What differs from int8: a 32-byte chunk holds 16 bf16 or 8 f32 values of
// k; bf16 products run on `mma.sync.m16n8k16` (bf16 -> f32), the lanes
// loading the same bytes of A and of each packed column as in int8, f32
// products on FFMA in the mma's output layout (lane (g, t): rows g, g + 8,
// columns 2t, 2t + 1, the chunk's 8 k in order), the warps' f32 sums added
// in warp order; h_d needs no song scale, so a step is four phases (the
// decoder writes its units' h_d as the frame head's operands), two under
// use_z_prior; the frame head is p = sigmoid(h_d . Wx + bx). Each block reads
// x and its song group's h_d as bf16 (twice the int8 codes' bytes) or f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "coop.cuh"
#include "mma_bf16.cuh"

namespace {

using cvl_coop::grid_sync;
using cvl_coop::mma_s8;

constexpr int kSongs = 2;      // songs per block
constexpr int kThreads = 128;  // threads per block
constexpr int kWarps = kThreads / 32;

struct Args {
  const float* seed;  // [B, D]
  const float* eps;   // [B, nsteps, L]
  const float* u;     // [B, nsteps, D]
  const void* wke;    // [D, H]   encoder x rows
  const float* encb;  // [B, H]   w rows . w + bias, per song
  const void* wz_t;   // [2L, H]  z_mean | z_log_var kernels, transposed
  const float* bz;    // [2L]
  const void* wkd_x;  // [D, H]   decoder x_prev rows (unused without use_x_prev)
  const float* wkd_z; // [L, H]   decoder z rows, f32
  const float* decb;  // [B, H]
  const void* wx;     // [H, D]   frame head
  const float* bx;    // [D]
  float* out;         // [B, nsteps, D]
  int B, nsteps, D, H, L, use_x_prev, use_z_prior, return_probs;
};

// Shared memory: f32 first ([row][kSongs] per-song state: x_prev, x_prev_t,
// encb, decb, h_e, h_d, z; then wkd_z, bz, bx), then the weights of type WT
// (wke, wkd_x if used, wz_t, wx).
__host__ __device__ constexpr size_t smem_floats(int D, int H, int L) {
  return (size_t)kSongs * (2 * D + 4 * H + L) + (size_t)L * H + 2 * L + D;
}
__host__ __device__ constexpr size_t smem_weights(int D, int H, int L, int use_x_prev) {
  return (size_t)(2 + use_x_prev) * D * H + (size_t)2 * L * H;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// the value a matmul operand takes in the weight type's mode
template <typename WT>
__device__ __forceinline__ float operand(float x);
template <>
__device__ __forceinline__ float operand<float>(float x) { return x; }
template <>
__device__ __forceinline__ float operand<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[b] += sum_k a[k][b] * w[k * ld_w + col] for k < K: one output column
// for every song of the tile; a in [K][kSongs], w a [K, ld_w] weight.
template <typename WT>
__device__ __forceinline__ void mac_col(float (&acc)[kSongs], const float* a, const WT* w,
                                        int K, int ld_w, int col) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float wk = ld(w + (size_t)k * ld_w + col);
#pragma unroll
    for (int b = 0; b < kSongs; ++b) acc[b] = fmaf(a[k * kSongs + b], wk, acc[b]);
  }
}

// Returns, in lane b < kSongs, sum_k a[k][b] * wrow[k]: the warp's lanes split
// k and a shuffle butterfly adds their partial sums.
template <typename WT>
__device__ __forceinline__ float warp_dot(const float* a, const WT* wrow, int K, int lane) {
  float s[kSongs];
#pragma unroll
  for (int b = 0; b < kSongs; ++b) s[b] = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float w = ld(wrow + k);
#pragma unroll
    for (int b = 0; b < kSongs; ++b) s[b] = fmaf(a[k * kSongs + b], w, s[b]);
  }
  float mine = 0.f;
#pragma unroll
  for (int b = 0; b < kSongs; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[b] += __shfl_xor_sync(0xffffffffu, s[b], off);
    if (lane == b) mine = s[b];
  }
  return mine;
}

template <typename T>
__device__ __forceinline__ void copy_in(T* dst, const T* src, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

template <typename WT>
__global__ void __launch_bounds__(kThreads) generate_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int D = a.D, H = a.H, L = a.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s0 = blockIdx.x * kSongs;  // songs s0 .. s0+kSongs-1; rows >= B are masked

  float* xp = sm;                   // [D][kSongs]  x_prev (the encoder's input)
  float* xpt = xp + D * kSongs;     // [D][kSongs]  x_prev_t (the decoder's, one step behind)
  float* encb = xpt + D * kSongs;   // [H][kSongs]
  float* decb = encb + H * kSongs;  // [H][kSongs]
  float* he = decb + H * kSongs;    // [H][kSongs]
  float* hd = he + H * kSongs;      // [H][kSongs]
  float* zs = hd + H * kSongs;      // [L][kSongs]
  float* wkd_z = zs + L * kSongs;   // [L, H]
  float* bz = wkd_z + L * H;        // [2L]
  float* bx = bz + 2 * L;           // [D]
  WT* wke = reinterpret_cast<WT*>(bx + D);  // [D, H]
  WT* wkd_x = wke + D * H;                  // [D, H] when use_x_prev
  WT* wz_t = wkd_x + (a.use_x_prev ? D * H : 0);  // [2L, H]
  WT* wx = wz_t + 2 * L * H;                // [H, D]

  // the weights, once per block
  copy_in(wke, static_cast<const WT*>(a.wke), (size_t)D * H);
  if (a.use_x_prev) copy_in(wkd_x, static_cast<const WT*>(a.wkd_x), (size_t)D * H);
  copy_in(wz_t, static_cast<const WT*>(a.wz_t), (size_t)2 * L * H);
  copy_in(wx, static_cast<const WT*>(a.wx), (size_t)H * D);
  copy_in(wkd_z, a.wkd_z, (size_t)L * H);
  copy_in(bz, a.bz, (size_t)2 * L);
  copy_in(bx, a.bx, (size_t)D);
  // per-song folds and both frames from the seed (rows >= B: zeros)
  for (int i = threadIdx.x; i < H * kSongs; i += kThreads) {
    const int j = i / kSongs, b = i % kSongs, s = s0 + b;
    encb[i] = s < a.B ? a.encb[(size_t)s * H + j] : 0.f;
    decb[i] = s < a.B ? a.decb[(size_t)s * H + j] : 0.f;
  }
  for (int i = threadIdx.x; i < D * kSongs; i += kThreads) {
    const int d = i / kSongs, b = i % kSongs, s = s0 + b;
    const float x = s < a.B ? operand<WT>(a.seed[(size_t)s * D + d]) : 0.f;
    xp[i] = x;
    xpt[i] = x;
  }
  __syncthreads();

  for (int t = 0; t < a.nsteps; ++t) {
    // 1. z-encoder hidden: h_e = relu(x_prev @ Wke + encb)
    for (int j = threadIdx.x; j < H; j += kThreads) {
      float acc[kSongs];
#pragma unroll
      for (int b = 0; b < kSongs; ++b) acc[b] = encb[j * kSongs + b];
      mac_col(acc, xp, wke, D, H, j);
#pragma unroll
      for (int b = 0; b < kSongs; ++b) he[j * kSongs + b] = operand<WT>(fmaxf(acc[b], 0.f));
    }
    __syncthreads();
    // 2. z heads and the draw, one warp per latent
    for (int l = warp; l < L; l += kWarps) {
      const float zm = warp_dot(he, wz_t + (size_t)l * H, H, lane);
      const float zv = warp_dot(he, wz_t + (size_t)(L + l) * H, H, lane);
      const int s = s0 + lane;
      if (lane < kSongs) {
        const float e = s < a.B ? a.eps[((size_t)s * a.nsteps + t) * L + l] : 0.f;
        zs[l * kSongs + lane] =
            a.use_z_prior ? e : (zm + bz[l]) + expf((zv + bz[L + l]) / 2.f) * e;
      }
    }
    __syncthreads();
    // 3. decoder hidden: h_d = relu(decb + sum_l z_l Wkd_z[l] (+ x_prev_t @ Wkd_x))
    for (int j = threadIdx.x; j < H; j += kThreads) {
      float acc[kSongs];
#pragma unroll
      for (int b = 0; b < kSongs; ++b) acc[b] = decb[j * kSongs + b];
      mac_col(acc, zs, wkd_z, L, H, j);
      if (a.use_x_prev) mac_col(acc, xpt, wkd_x, D, H, j);
#pragma unroll
      for (int b = 0; b < kSongs; ++b) hd[j * kSongs + b] = operand<WT>(fmaxf(acc[b], 0.f));
    }
    __syncthreads();
    // 4. frame head, Bernoulli draw, both carries, output; one thread per pitch
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float acc[kSongs];
#pragma unroll
      for (int b = 0; b < kSongs; ++b) acc[b] = 0.f;
      mac_col(acc, hd, wx, H, D, d);
#pragma unroll
      for (int b = 0; b < kSongs; ++b) {
        const int s = s0 + b;
        const float xm = 1.f / (1.f + expf(-(acc[b] + bx[d])));
        const float uu = s < a.B ? a.u[((size_t)s * a.nsteps + t) * D + d] : 1.f;
        const float xt = uu < xm ? 1.f : 0.f;
        xpt[d * kSongs + b] = xp[d * kSongs + b];  // the decoder's input lags one step
        xp[d * kSongs + b] = xt;
        if (s < a.B) a.out[((size_t)s * a.nsteps + t) * D + d] = a.return_probs ? xm : xt;
      }
    }
    __syncthreads();
  }
}

template <typename WT>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a.D, a.H, a.L) * sizeof(float) +
                      smem_weights(a.D, a.H, a.L, a.use_x_prev) * sizeof(WT);
  cudaError_t err = cudaFuncSetAttribute(
      generate_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.B + kSongs - 1) / kSongs);
  generate_kernel<WT><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ the wide kernel

constexpr int kWideThreads = 512;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kMaxSlices = 16;  // K-split groups of a layer with few columns
constexpr size_t kPartialFloats = (size_t)kWideThreads * kSongs;

struct WideArgs {
  const float* seed;   // [B, D]
  const float* eps;    // [B, nsteps, L]
  const float* u;      // [B, nsteps, D]
  const float* wke;    // [D, H]  encoder x rows (hidden layers only)
  const float* encb;   // [B, H]  w rows . w + bias, per song
  const float* wkd_x;  // [D, H]  decoder x_prev rows (hidden layers and use_x_prev)
  const float* wkd_z;  // [L, H]  decoder z rows, f32
  const float* decb;   // [B, H]
  const float* wz_t;   // [2L, E] z heads over e (h_e, E = H; without hidden layers x_prev, E = D)
  const float* zb;     // z-head bias: [2L] (zb_stride 0) or the per-song fold [B, 2L]
  const float* wx;     // [H, D]  frame head (hidden layers only)
  const float* wx_z;   // [L, D]  frame head z rows, f32 (no hidden layers)
  const float* wx_xp;  // [D, D]  frame head x_prev rows (no hidden layers, use_x_prev)
  const float* xb;     // frame-head bias: [D] (xb_stride 0) or the per-song fold [B, D]
  float* out;          // [B, nsteps, D]
  float* state;        // null: per-song state in shared memory; else [grid, state floats]
  int zb_stride, xb_stride;
  int B, nsteps, D, H, L, has_hidden, use_x_prev, use_z_prior, return_probs;
};

// per-song state of one block: x_prev, x_prev_t and the step's probabilities
// ([D][kSongs] each), z ([L][kSongs]), and with hidden layers h_e and h_d
// ([H][kSongs] each)
__host__ __device__ constexpr size_t wide_state_floats(int D, int H, int L, int has_hidden) {
  return (size_t)kSongs * (3 * D + L + (has_hidden ? 2 * H : 0));
}

// One operand of a layer: a [k][kSongs] tile (shared or scratch memory)
// times a [k, N] row-major f32 weight in global memory; k = 0 skips it.
struct Op {
  const float* a;
  const float* w;
  int k;
};

// acc[b] += sum_{k0 <= k < k1} a[k][b] * w[k * N + n]
__device__ __forceinline__ void mac_rows(float (&acc)[kSongs], const Op& o, int N, int n,
                                         int k0, int k1) {
  if (k0 >= k1) return;
  const float* wp = o.w + (size_t)k0 * N + n;
#pragma unroll 16
  for (int k = k0; k < k1; ++k, wp += N) {
    const float wv = __ldg(wp);
#pragma unroll
    for (int b = 0; b < kSongs; ++b) acc[b] = fmaf(o.a[k * kSongs + b], wv, acc[b]);
  }
}

// K-split groups for a layer of N columns: all threads busy, at most kMaxSlices
__device__ __forceinline__ int slices_for(int N) {
  const int s = kWideThreads / N;
  return s < 1 ? 1 : (s > kMaxSlices ? kMaxSlices : s);
}

// out(n, b) = sum over both operands of sum_k a[k][b] * w[k * N + n], handed
// to epi(n, b, value) exactly once for each column n < N and song b. Wide
// layers give each thread whole columns; narrow ones split the K rows of each
// operand across S groups, whose partial sums meet in `partial` after a
// barrier and are added in group order. The caller syncs before the next
// layer reads what epi stored.
template <typename Epi>
__device__ __forceinline__ void cols_layer(const Op& o1, const Op& o2, int N,
                                           float* partial, Epi epi) {
  const int S = slices_for(N);
  if (S == 1) {
    for (int n = threadIdx.x; n < N; n += kWideThreads) {
      float acc[kSongs];
#pragma unroll
      for (int b = 0; b < kSongs; ++b) acc[b] = 0.f;
      mac_rows(acc, o1, N, n, 0, o1.k);
      mac_rows(acc, o2, N, n, 0, o2.k);
#pragma unroll
      for (int b = 0; b < kSongs; ++b) epi(n, b, acc[b]);
    }
    return;
  }
  const int s = threadIdx.x / N, n = threadIdx.x - s * N;
  if (s < S) {
    float acc[kSongs];
#pragma unroll
    for (int b = 0; b < kSongs; ++b) acc[b] = 0.f;
    mac_rows(acc, o1, N, n, o1.k * s / S, o1.k * (s + 1) / S);
    mac_rows(acc, o2, N, n, o2.k * s / S, o2.k * (s + 1) / S);
#pragma unroll
    for (int b = 0; b < kSongs; ++b) partial[(s * N + n) * kSongs + b] = acc[b];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N * kSongs; i += kWideThreads) {
    const int col = i / kSongs, b = i - col * kSongs;
    float v = 0.f;
    for (int q = 0; q < S; ++q) v += partial[(q * N + col) * kSongs + b];
    epi(col, b, v);
  }
}

// z = m + exp(v/2) * eps (or eps under use_z_prior) for the tile's songs,
// the heads over e [E][kSongs]; one warp per latent, its lanes splitting E
__device__ __forceinline__ void z_draw(const WideArgs& a, const float* e, int E, float* zs,
                                       int t, int s0) {
  const float* wz = a.wz_t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, L = a.L;
  for (int l = warp; l < L; l += kWideWarps) {
    const float zm = warp_dot(e, wz + (size_t)l * E, E, lane);
    const float zv = warp_dot(e, wz + (size_t)(L + l) * E, E, lane);
    const int s = s0 + lane;
    if (lane < kSongs) {
      float z = 0.f;
      if (s < a.B) {
        const float* zb = a.zb + (size_t)s * a.zb_stride;
        const float ep = a.eps[((size_t)s * a.nsteps + t) * L + l];
        z = a.use_z_prior ? ep : (zm + zb[l]) + expf((zv + zb[L + l]) / 2.f) * ep;
      }
      zs[l * kSongs + lane] = z;
    }
  }
}

__global__ void __launch_bounds__(kWideThreads) generate_wide_kernel(const WideArgs a) {
  extern __shared__ float4 smem4[];
  float* partial = reinterpret_cast<float*>(smem4);  // [kPartialFloats]
  const int D = a.D, H = a.H, L = a.L;
  float* st = a.state ? a.state + (size_t)blockIdx.x * wide_state_floats(D, H, L, a.has_hidden)
                      : partial + kPartialFloats;
  float* xp = st;                 // [D][kSongs]  x_prev (the encoder's input)
  float* xpt = xp + D * kSongs;   // [D][kSongs]  x_prev_t (the decoder's, one step behind)
  float* pm = xpt + D * kSongs;   // [D][kSongs]  the step's frame probabilities
  float* zs = pm + D * kSongs;    // [L][kSongs]
  float* he = zs + L * kSongs;    // [H][kSongs]  with hidden layers
  float* hd = he + H * kSongs;    // [H][kSongs]  with hidden layers
  const int s0 = blockIdx.x * kSongs;
  const auto fold = [&](const float* f, int stride, int b, int n) {
    const int s = s0 + b;
    return s < a.B ? f[(size_t)s * stride + n] : 0.f;
  };

  for (int i = threadIdx.x; i < D * kSongs; i += kWideThreads) {
    const int d = i / kSongs, b = i % kSongs, s = s0 + b;
    const float x = s < a.B ? a.seed[(size_t)s * D + d] : 0.f;
    xp[i] = x;
    xpt[i] = x;
  }
  __syncthreads();

  const Op none{nullptr, nullptr, 0};
  const auto prob = [&](int d, int b, float acc) {
    pm[d * kSongs + b] = 1.f / (1.f + expf(-(acc + fold(a.xb, a.xb_stride, b, d))));
  };
  for (int t = 0; t < a.nsteps; ++t) {
    if (a.has_hidden) {
      // z-encoder hidden: h_e = relu(x_prev @ Wke + encb)
      cols_layer(Op{xp, a.wke, D}, none, H, partial, [&](int n, int b, float acc) {
                   he[n * kSongs + b] = fmaxf(acc + fold(a.encb, H, b, n), 0.f);
                 });
      __syncthreads();
      z_draw(a, he, H, zs, t, s0);
      __syncthreads();
      // decoder hidden: h_d = relu(decb + sum_l z_l Wkd_z[l] (+ x_prev_t @ Wkd_x))
      cols_layer(Op{zs, a.wkd_z, L}, Op{xpt, a.wkd_x, a.use_x_prev ? D : 0}, H, partial,
                 [&](int n, int b, float acc) {
                   hd[n * kSongs + b] = fmaxf(acc + fold(a.decb, H, b, n), 0.f);
                 });
      __syncthreads();
      // frame head: p = sigmoid(h_d @ Wx + bx)
      cols_layer(Op{hd, a.wx, H}, none, D, partial, prob);
    } else {
      // z heads over x_prev (w rows folded into zb)
      z_draw(a, xp, D, zs, t, s0);
      __syncthreads();
      // frame head: p = sigmoid(xb + sum_l z_l Wx_z[l] (+ x_prev_t @ Wx_xp))
      cols_layer(Op{zs, a.wx_z, L}, Op{xpt, a.wx_xp, a.use_x_prev ? D : 0}, D, partial, prob);
    }
    __syncthreads();
    // Bernoulli draw, both carries (the lagged frame takes the old x_prev
    // first), output
    for (int i = threadIdx.x; i < D * kSongs; i += kWideThreads) {
      const int d = i / kSongs, b = i % kSongs, s = s0 + b;
      if (s >= a.B) continue;
      const float xm = pm[i];
      const float xt = a.u[((size_t)s * a.nsteps + t) * D + d] < xm ? 1.f : 0.f;
      xpt[i] = xp[i];
      xp[i] = xt;
      a.out[((size_t)s * a.nsteps + t) * D + d] = a.return_probs ? xm : xt;
    }
    __syncthreads();
  }
}

size_t wide_smem_bytes(int D, int H, int L, int has_hidden, int state_in_smem) {
  return (kPartialFloats + (state_in_smem ? wide_state_floats(D, H, L, has_hidden) : 0)) *
         sizeof(float);
}

int launch_wide(const WideArgs& a, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(a.D, a.H, a.L, a.has_hidden, a.state == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      generate_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.B + kSongs - 1) / kSongs);
  generate_wide_kernel<<<grid, kWideThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------ the cooperative kernel

constexpr int kCThreads = 512;               // 16 warps a block
constexpr int kCWarps = kCThreads / 32;
constexpr int kCRows = 64;                   // songs of a launch: 4 m16 tiles
constexpr int kChunkBytes = 32;              // a chunk of a row: 32 int8 codes, 16 bf16, 8 f32
constexpr int kTileBytes = 256;              // one n8 tile's chunk of packed weights
constexpr int kCPS = 8;                      // chunks a ring stage
constexpr int kRing = 4;                     // ring stages
constexpr int kMaxNT = 8;                    // n8 tiles of one product pass
constexpr int kRowStride = kCPS * kChunkBytes + 16;   // a row of a stage's operand, padded
constexpr int kAStage = kCRows * kRowStride;          // the operand bytes of a stage

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round16(int n) { return cdiv(n, 16) * 16; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The element type E of a mode's products: int8 codes summed in int32 on
// the int8 tensor cores (the z heads bf16), bf16 values summed in f32 on the
// bf16 tensor cores, or f32 values summed on FFMA (the z heads f32).
template <typename E>
struct Mode {
  using Acc = float;
  using Z = E;
};
template <>
struct Mode<signed char> {
  using Acc = int;
  using Z = __nv_bfloat16;
};

struct CoopArgs {
  const float* seed;           // [B, D]
  const float* eps;            // [B, nsteps, L]
  const float* u;              // [B, nsteps, D]
  const int* wke;              // [G][KCx][NT][64] words: encoder x rows, the block's units
  const int* wkd;              // [G][KCx][NT][64]: decoder x_prev rows (use_x_prev, else null)
  const int* wx;               // [G][KCh][P][64]: the frame head, the block's pitch tiles
  const float* ske;            // [H]  int8: scales of the encoder x rows (else null)
  const float* skd;            // [H]  int8: scales of the decoder x_prev rows (or null)
  const float* encb;           // [B, H]  w rows . w + bias, per song
  const float* decb;           // [B, H]
  const void* wz_t;            // [2L, H]  z_mean | z_log_var kernels, transposed (Mode::Z)
  const float* bz;             // [2L]
  const float* wkd_z;          // [L, H]  decoder z rows, f32
  const float* swx;            // [D]  int8: scales of the frame head (else null)
  const float* bx;             // [D]
  float* out;                  // [B, nsteps, D]
  // the state shared between blocks, in global memory, zeroed by the caller
  // (`coop_state` cuts it from one buffer)
  int* xq;                     // [2][kCRows][KCx * 8] words: x_prev as operands, double-buffered
  int* hq;                     // [kCRows][KCh * 8] words: h_d as operands (int8: round(h_d / rs))
  double* zpart;               // [G][kCRows][2L]: the z heads summed over each block's units
  float* zs;                   // [kCRows][L]: the step's z
  float* hmax;                 // [G][kCRows]: int8, each block's largest h_d per song
  unsigned* bar;               // arrivals at the grid barrier
  unsigned long long* clock;   // [kLaps] or null: block 0's ns per part of a step
  int B, nsteps, D, H, L, use_x_prev, use_z_prior, return_probs;
  int nu;                      // hidden units a block owns (a multiple of 8)
  int P, hs;                   // pitch tiles a block, song groups of the frame head
  int res_cells, res_head;     // the x-row slices / the head's tiles resident in shared memory
};

// n8 tiles of weights a ring chunk carries: those of the widest streamed pass
__host__ __device__ constexpr int stream_tiles(int nu, int P, int res_cells, int res_head) {
  return imin(kMaxNT, imax(res_cells ? 0 : nu / 8, res_head ? 0 : P));
}
__host__ __device__ constexpr size_t ring_bytes(int wt) {
  return (size_t)kRing * (kAStage + (size_t)kCPS * wt * kTileBytes);
}

// dynamic shared memory of a block whose operands are `eb` bytes (1 int8, 2
// bf16, 4 f32): the ring (operands of kCPS chunks a stage and the streamed
// weights' chunks; after a pass, the warps' sums), the resident slices, the
// block's columns of the z heads in double ([nu][2L]), then f32: h_e / h_d
// ([kCRows][nu]), the block's columns of the two int8 scales ([nu] each)
// and of the decoder's z rows ([L][nu]), the z of the songs ([kCRows][L])
// and their int8 rs
__host__ __device__ constexpr size_t coop_smem_bytes(int D, int H, int L, int nu, int P,
                                                     int use_x_prev, int res_cells, int res_head,
                                                     int eb) {
  return ring_bytes(stream_tiles(nu, P, res_cells, res_head)) +
         (res_cells ? (size_t)cdiv(D, kChunkBytes / eb) * (1 + use_x_prev) * (nu / 8) * kTileBytes
                    : 0) +
         (res_head ? (size_t)cdiv(H, kChunkBytes / eb) * P * kTileBytes : 0) +
         (size_t)nu * 2 * L * sizeof(double) +
         ((size_t)kCRows * nu + (size_t)nu * (2 + L) + (size_t)kCRows * (L + 1)) * sizeof(float);
}

// the global state, in 4-byte words, each part a multiple of 16 bytes
struct CoopState {
  size_t xq, hq, zpart, zs, hmax, bar, total;
};
__host__ __device__ inline CoopState coop_state(int D, int H, int L, int G, int eb) {
  const size_t xw = (size_t)cdiv(D, kChunkBytes / eb) * 8;
  const size_t hw = (size_t)cdiv(H, kChunkBytes / eb) * 8;
  CoopState st{};
  st.xq = 0;
  st.hq = st.xq + 2 * kCRows * xw;
  st.zpart = st.hq + kCRows * hw;
  st.zs = st.zpart + (size_t)G * kCRows * 2 * L * 2;
  st.hmax = st.zs + (size_t)kCRows * L;
  st.bar = st.hmax + (size_t)G * kCRows;
  st.total = st.bar + 4;
  return st;
}

__host__ __device__ constexpr int ksplit(int mt) {
  return kCWarps / mt < kCPS ? kCWarps / mt : kCPS;
}

__device__ __forceinline__ float as_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }

// One product pass: the sums of song rows m0 .. m0 + 16 mt - 1 (mt <= 4)
// and n8 tiles n0 .. n0 + nt - 1 (nt <= kMaxNT) of a block's packed weight
// ([nch][ntot][64] words, chunk after chunk: in shared memory at `wres`, or
// streamed from global memory at `wg` when `wres` is null), times the
// operands `aq` (global, `aw` words a row, chunk c at words 8c .. 8c + 7).
// A packed tile's chunk holds its 8 columns one after the other, each
// column's 32 bytes of k in order (`pack_units`). The chunks stream through
// a ring of kRing stages of kCPS chunks (`cp.async`, L2 only: the operands
// are rewritten by other blocks every step). A stage holds each row's kCPS
// chunks as one contiguous 256-byte span (with resident weights, 2 or 4
// times that for a pass of 32 or 16 rows), copied by neighbouring threads
// (whole 128-byte lines a warp), and keeps it in shared memory a padded row
// apart, so that the loads of 8 rows fall on distinct banks. Every block
// reads the same operands: each starts at its own stage, so that the blocks
// do not all ask the same L2 lines at once. Warp (wm, kq) takes m-tile wm,
// all nt n-tiles, and the chunks q = kq, kq + nks, ... of each stage (nks =
// ksplit(mt)). int8 and bf16 run on the tensor cores (`mma.sync`
// m16n8k32 s8 -> s32, m16n8k16 bf16 -> f32): lane (g, t) holds rows g and g
// + 8, bytes 8t .. 8t + 7 of a chunk (one 8-byte load a row), and column
// g's same bytes of each tile, so that A and B pair the same k (any pairing
// of k gives the same products). f32 runs on FFMA in the same output layout
// (rows g, g + 8, columns 2t, 2t + 1 of each tile), summing the chunk's 8 k
// in order. The warps' sums are staged in the ring ([nks][16 mt][8 nt], at
// most 64 KB, within the ring) and added in warp order (int32: exact) into
// the first [16 mt][8 nt], which the function returns after a block
// barrier.
template <typename E>
__device__ __forceinline__ const typename Mode<E>::Acc* products(
    const int* aq, int aw, int nch, const int* wres, const int* __restrict__ wg, int ntot, int n0,
    int nt, int m0, int mt, unsigned char* ring) {
  using Acc = typename Mode<E>::Acc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nks = ksplit(mt), wm = warp % mt, kq = warp / mt;
  const bool active = kq < nks;
  const int rows = 16 * mt;
  // with resident weights a pass of 32 or 16 rows takes 2 or 4 times the
  // chunks a stage, so that a stage keeps its bytes (and the ring as many in
  // flight); the pieces of a stage stay 2 kCPS kCRows
  const int shift = wres ? (mt == 1 ? 2 : mt == 2 ? 1 : 0) : 0;
  const int cps = kCPS << shift, stride = cps * kChunkBytes + 16;  // chunks a stage, row bytes
  const int nst = cdiv(nch, cps);
  const int rot = (int)(((long long)blockIdx.x * nst) / gridDim.x);  // this block's first stage
  const int sb = kAStage + (wres ? 0 : kCPS * nt * kTileBytes);       // bytes a stage
  Acc acc[kMaxNT][4];
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0;
  // stage s (the chunks of stage (s + rot) % nst): operands [rows][stride]
  // (a row's chunks side by side), streamed weights [kCPS][nt][256 B];
  // 16-byte pieces dealt to the threads at fixed strides (no division): 2
  // cps pieces a row, and 128 weight slots a chunk
  static_assert(kCRows * 2 * kCPS % kCThreads == 0 && kCPS * 16 * kMaxNT % kCThreads == 0 &&
                16 * kMaxNT == 128, "whole rounds of pieces");
  auto load = [&](int s) {
    unsigned char* A = ring + (s % kRing) * sb;
    unsigned char* Bw = A + kAStage;
    const int c0 = ((s + rot) % nst) * cps;  // the stage's first chunk
#pragma unroll
    for (int e = 0; e < kCRows * 2 * kCPS / kCThreads; ++e) {
      const int i = tid + e * kCThreads, row = i >> (4 + shift), p = i & ((16 << shift) - 1);
      const int ch = c0 + p / 2;
      if (row < rows && ch < nch)  // the operands: row, chunk p / 2, half p % 2
        cvl_tc::cp_async16(A + row * stride + p * 16,
                           aq + (size_t)(m0 + row) * aw + ch * 8 + (p % 2) * 4, true);
    }
    if (!wres) {
#pragma unroll
      for (int e = 0; e < kCPS * 128 / kCThreads; ++e) {
        const int i = tid + e * kCThreads, q = i / 128, r = i % 128, ch = c0 + q;
        if (r < 16 * nt && ch < nch)  // the weights: piece r of the chunk's nt tiles
          cvl_tc::cp_async16(Bw + q * nt * kTileBytes + r * 16,
                             wg + ((size_t)ch * ntot + n0) * 64 + r * 4, true);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < nst) load(s);
    cvl_tc::cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cvl_tc::cp_async_wait<kRing - 2>();
    __syncthreads();
    if (s + kRing - 1 < nst) load(s + kRing - 1);
    cvl_tc::cp_async_commit();
    if (!active) continue;
    const unsigned char* A = ring + (s % kRing) * sb;
    const unsigned char* Bw = A + kAStage;
    const int c0 = ((s + rot) % nst) * cps;
    for (int q = kq; q < cps; q += nks) {
      const int ch = c0 + q;
      if (ch >= nch) break;
      const unsigned char* ar = A + (wm * 16 + g) * stride + q * kChunkBytes;
      const unsigned char* br =
          wres ? reinterpret_cast<const unsigned char*>(wres + ((size_t)ch * ntot + n0) * 64)
               : Bw + q * nt * kTileBytes;
      if constexpr (sizeof(E) == 4) {
        // rows g and g + 8: the chunk's 8 k each
        const float4* a4 = reinterpret_cast<const float4*>(ar);
        const float4* a8 = reinterpret_cast<const float4*>(ar + 8 * stride);
        const float4 r0[2] = {a4[0], a4[1]}, r1[2] = {a8[0], a8[1]};
        const float x0[8] = {r0[0].x, r0[0].y, r0[0].z, r0[0].w, r0[1].x, r0[1].y, r0[1].z, r0[1].w};
        const float x1[8] = {r1[0].x, r1[0].y, r1[0].z, r1[0].w, r1[1].x, r1[1].y, r1[1].z, r1[1].w};
#pragma unroll
        for (int n = 0; n < kMaxNT; ++n) {
          if (n >= nt) break;
          // columns 2t and 2t + 1 of the tile: 8 k each
          const float4* b4 = reinterpret_cast<const float4*>(br + n * kTileBytes + t * 64);
          const float4 c0v[2] = {b4[0], b4[1]}, c1v[2] = {b4[2], b4[3]};
          const float w0[8] = {c0v[0].x, c0v[0].y, c0v[0].z, c0v[0].w,
                               c0v[1].x, c0v[1].y, c0v[1].z, c0v[1].w};
          const float w1[8] = {c1v[0].x, c1v[0].y, c1v[0].z, c1v[0].w,
                               c1v[1].x, c1v[1].y, c1v[1].z, c1v[1].w};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            acc[n][0] = fmaf(x0[k], w0[k], acc[n][0]);
            acc[n][1] = fmaf(x0[k], w1[k], acc[n][1]);
            acc[n][2] = fmaf(x1[k], w0[k], acc[n][2]);
            acc[n][3] = fmaf(x1[k], w1[k], acc[n][3]);
          }
        }
      } else {
        const uint2 lo = *reinterpret_cast<const uint2*>(ar + t * 8);
        const uint2 hi = *reinterpret_cast<const uint2*>(ar + 8 * stride + t * 8);
        const unsigned af[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int n = 0; n < kMaxNT; ++n) {
          if (n >= nt) break;
          const uint2 b = *reinterpret_cast<const uint2*>(br + n * kTileBytes + lane * 8);
          if constexpr (sizeof(E) == 1)
            mma_s8(acc[n], af, b.x, b.y);
          else
            cvl_tc::mma_bf16(acc[n], af, b.x, b.y);
        }
      }
    }
  }
  cvl_tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial sums go in it
  // [nks][rows][8 nt]: row g (+8), columns 2t, 2t + 1 of each tile
  const int cols = 8 * nt, part = rows * cols;
  Acc* stg = reinterpret_cast<Acc*>(ring);
  if (active) {
#pragma unroll
    for (int n = 0; n < kMaxNT; ++n) {
      if (n >= nt) break;
      Acc* r0 = stg + (size_t)kq * part + (wm * 16 + g) * cols + n * 8 + 2 * t;
      r0[0] = acc[n][0];
      r0[1] = acc[n][1];
      r0[8 * cols] = acc[n][2];
      r0[8 * cols + 1] = acc[n][3];
    }
  }
  __syncthreads();
  for (int e = tid; e < part; e += kCThreads) {  // the warps' partial sums, in warp order
    Acc sum = stg[e];
    for (int k = 1; k < nks; ++k) sum += stg[(size_t)k * part + e];
    stg[e] = sum;
  }
  __syncthreads();
  return stg;
}

__device__ __forceinline__ void copy16(int* dst, const int* src, size_t bytes) {
  for (size_t i = threadIdx.x; i < bytes / 16; i += kCThreads)
    reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
}

// element `col` of song row s of an operand buffer (`row_words` words a row)
template <typename E>
__device__ __forceinline__ void put(int* words, int row_words, int s, int col, E v) {
  reinterpret_cast<E*>(words)[(size_t)s * row_words * (4 / sizeof(E)) + col] = v;
}

// a frame's value (0 or 1, or a seed's) as an operand of the mode; in f32
// and bf16 also a value of h_d
template <typename E>
__device__ __forceinline__ E to_operand(float x) {
  return x;
}
template <>
__device__ __forceinline__ signed char to_operand<signed char>(float x) {
  return static_cast<signed char>(__float2int_rz(x));  // binary frames are exact codes
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_operand<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float ldz(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ldz(const float* p) { return *p; }

// The largest value per row r < rows of vals(g, r) over g < G (a max is exact
// in any order; every value >= 0): 8 threads a row, each loading its blocks
// g = p, p + 8, ... all at once (G <= kMaxBlocks), then a butterfly over the
// 8; then fin(r, the max)
constexpr int kMaxBlocks = 136;
template <typename V, typename Fin>
__device__ __forceinline__ void row_max(int rows, int G, V vals, Fin fin) {
  constexpr int kParts = 8, kPer = (kMaxBlocks + kParts - 1) / kParts;
  static_assert(kCThreads == kCRows * kParts, "8 threads a row");
  const int r = threadIdx.x / kParts, p = threadIdx.x % kParts;
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int g = p + k * kParts;
    v[k] = r < rows && g < G ? vals(g, r) : 0.f;
  }
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) m = fmaxf(m, v[k]);
#pragma unroll
  for (int off = kParts / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (p == 0 && r < rows) fin(r, m);
}

// Block 0's clock of a step's parts: the encoder's products, its epilogue
// and the z heads' sums, its wait; z, its wait; the decoder (products,
// epilogue, int8 maxima or the h_d operands), its wait; int8 rs and the
// codes, their wait (0 in f32 and bf16); the frame head's products, its
// epilogue, its wait
constexpr int kLaps = 12;
using CoopClock = cvl_coop::PhaseClock<kLaps>;

// One persistent cooperative launch for the whole song of at most kCRows
// songs: every block owns nu hidden units for every song, and a slice of the
// frame head's pitches for a group of the songs; a step is five phases with a
// grid barrier after each in int8 (three under use_z_prior), four in f32 and
// bf16 (two under use_z_prior), whose h_d needs no song scale.
template <typename E>
__global__ void __launch_bounds__(kCThreads, 1) generate_vae_coop_kernel(const CoopArgs a) {
  using Z = typename Mode<E>::Z;
  constexpr bool kI8 = sizeof(E) == 1;
  constexpr int kPer = kChunkBytes / (int)sizeof(E);  // k of a chunk
  extern __shared__ int4 smem_i4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem_i4);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = a.D, H = a.H, L = a.L, B = a.B, nu = a.nu, NT = nu / 8, P = a.P;
  const int kcx = cdiv(D, kPer), kch = cdiv(H, kPer), xw = kcx * 8, hw = kch * 8;
  const int Bp = round16(B), mt = Bp / 16, G = gridDim.x;
  const int u0 = blockIdx.x * nu, nun = imin(nu, H - u0);  // the block's units
  const size_t cellw = (size_t)kcx * NT * 64, headw = (size_t)kch * P * 64;  // words a slice
  const int* gke = a.wke + blockIdx.x * cellw;
  const int* gkd = a.use_x_prev ? a.wkd + blockIdx.x * cellw : nullptr;
  const int* gx = a.wx + blockIdx.x * headw;
  int* cells = reinterpret_cast<int*>(ring + ring_bytes(stream_tiles(nu, P, a.res_cells,
                                                                     a.res_head)));
  int* head = cells + (a.res_cells ? cellw * (1 + a.use_x_prev) : 0);
  double* wz = reinterpret_cast<double*>(head + (a.res_head ? headw : 0));  // [nu][2L] z heads
  float* hv = reinterpret_cast<float*>(wz + 2 * L * nu);  // [kCRows][nu]
  float* sk = hv + kCRows * nu;      // [nu]  int8 scales of the encoder x rows
  float* sd = sk + nu;               // [nu]  of the decoder x_prev rows
  float* wzd = sd + nu;              // [L][nu]  decoder z rows
  float* zsm = wzd + L * nu;         // [kCRows][L]
  float* rs = zsm + kCRows * L;      // [kCRows]  int8
  const int *wke = nullptr, *wkd = nullptr, *wxs = nullptr;
  if (a.res_cells) {  // the block's slices, copied once (16-byte pieces)
    copy16(cells, gke, cellw * 4);
    wke = cells;
    if (a.use_x_prev) {
      copy16(cells + cellw, gkd, cellw * 4);
      wkd = cells + cellw;
    }
  }
  if (a.res_head) {
    copy16(head, gx, headw * 4);
    wxs = head;
  }
  for (int j = tid; j < nu; j += kCThreads) {
    sk[j] = kI8 && j < nun ? a.ske[u0 + j] : 0.f;
    sd[j] = kI8 && j < nun && a.use_x_prev ? a.skd[u0 + j] : 0.f;
  }
  for (int i = tid; i < L * nu; i += kCThreads) {
    const int l = i / nu, j = i - l * nu;
    wzd[i] = j < nun ? a.wkd_z[(size_t)l * H + u0 + j] : 0.f;
  }
  const Z* wz_t = static_cast<const Z*>(a.wz_t);
  for (int i = tid; i < 2 * L * nu; i += kCThreads) {
    const int j = i / (2 * L), c = i - j * 2 * L;
    wz[i] = j < nun ? (double)ldz(wz_t + (size_t)c * H + u0 + j) : 0.0;
  }
  // both carried frames start as the seed
  const size_t xbuf = (size_t)kCRows * xw;
  for (int i = blockIdx.x * kCThreads + tid; i < B * D; i += G * kCThreads) {
    const int s = i / D, d = i - s * D;
    const E x = to_operand<E>(a.seed[(size_t)s * D + d]);
    put(a.xq, xw, s, d, x);
    put(a.xq + xbuf, xw, s, d, x);
  }
  unsigned rounds = 0;
  grid_sync(a.bar, rounds);
  __shared__ CoopClock clk;  // thread 0 of block 0 keeps it
  const bool timer = tid == 0;
  if (timer) {
    clk.out = blockIdx.x == 0 ? a.clock : nullptr;
    clk.start();
  }
  // the frame head's share of the block: pitch group pg, song group sg
  const int pg = blockIdx.x / a.hs, sg = blockIdx.x - pg * a.hs;
  const int mtg = cdiv(mt, a.hs), m0 = 16 * sg * mtg, mtn = imin(mtg, mt - sg * mtg);
  const bool heads = mtn > 0 && pg * P < cdiv(D, 8);
  for (int t = 0; t < a.nsteps; ++t) {
    const int cur = t & 1;
    const int* xin = a.xq + cur * xbuf;  // x_prev, the encoder's input
    int* xlag = a.xq + (cur ^ 1) * xbuf;  // x_prev_t, the decoder's, one step behind
    if (!a.use_z_prior) {
      // 1. encoder: h_e = relu(x_prev.Wke (* ske) + encb), kept at the z
      // heads' operand values, then the z heads summed over the block's units
      for (int n0 = 0; n0 < NT; n0 += kMaxNT) {
        const int nt = imin(kMaxNT, NT - n0);
        const auto* sums = products<E>(xin, xw, kcx, wke, gke, NT, n0, nt, 0, mt, ring);
        if (timer) clk.lap(0);
        for (int i = tid; i < Bp * 8 * nt; i += kCThreads) {
          const int r = i / (8 * nt), j = 8 * n0 + i - r * 8 * nt;
          float v = 0.f;
          if (r < B && j < nun) {
            const float p = kI8 ? __fmul_rn(as_f32(sums[i]), sk[j]) : as_f32(sums[i]);
            v = operand<Z>(fmaxf(__fadd_rn(p, a.encb[(size_t)r * H + u0 + j]), 0.f));
          }
          hv[r * nu + j] = v;
        }
        __syncthreads();
      }
      // the z heads over the block's units, each sum in unit order, in
      // double (a product of two bf16 or f32 values is exact): a thread takes
      // a row and kZCols of its columns c, c + 8, ..., converting each h_e
      // once
      {
        constexpr int kZGroups = kCThreads / kCRows, kZCols = 4;
        const int r = tid / kZGroups, cg = tid % kZGroups;
        for (int c0 = 0; c0 < 2 * L; c0 += kZGroups * kZCols) {
          double acc[kZCols] = {0.0, 0.0, 0.0, 0.0};
          if (r < Bp)
            for (int j = 0; j < nun; ++j) {
              const double h = hv[r * nu + j];
#pragma unroll
              for (int k = 0; k < kZCols; ++k) {
                const int c = c0 + cg + kZGroups * k;
                if (c < 2 * L) acc[k] = fma(h, wz[j * 2 * L + c], acc[k]);
              }
            }
#pragma unroll
          for (int k = 0; k < kZCols; ++k) {
            const int c = c0 + cg + kZGroups * k;
            if (r < Bp && c < 2 * L)
              a.zpart[((size_t)blockIdx.x * kCRows + r) * 2 * L + c] = acc[k];
          }
        }
      }
      if (timer) clk.lap(1);
      grid_sync(a.bar, rounds);
      if (timer) clk.lap(2);
      // 2. z = m + exp(v/2) eps, one warp a (song, latent): lane l adds the
      // blocks l, l + 32, ... in order, a butterfly adds the lanes, all in
      // double, rounded to f32 once; then the JAX kernel's f32 order
      constexpr int kZPer = (kMaxBlocks + 31) / 32;
      for (int job = blockIdx.x * kCWarps + warp; job < B * L; job += G * kCWarps) {
        const int s = job / L, l = job - s * L;
        const float e = a.eps[((size_t)s * a.nsteps + t) * L + l];
        double pm[kZPer], pv[kZPer];
#pragma unroll
        for (int k = 0; k < kZPer; ++k) {
          const int g = lane + 32 * k;
          const double* p = a.zpart + ((size_t)g * kCRows + s) * 2 * L;
          pm[k] = g < G ? __ldcg(p + l) : 0.0;
          pv[k] = g < G ? __ldcg(p + L + l) : 0.0;
        }
        double zm = 0.0, zv = 0.0;
#pragma unroll
        for (int k = 0; k < kZPer; ++k) {
          zm += pm[k];
          zv += pv[k];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          zm += __shfl_xor_sync(0xffffffffu, zm, off);
          zv += __shfl_xor_sync(0xffffffffu, zv, off);
        }
        if (lane == 0) {
          const float scale = expf(__fadd_rn(__double2float_rn(zv), a.bz[L + l]) / 2.f);
          a.zs[s * L + l] =
              __fadd_rn(__fadd_rn(__double2float_rn(zm), a.bz[l]), __fmul_rn(scale, e));
        }
      }
      if (timer) clk.lap(3);
      grid_sync(a.bar, rounds);
      if (timer) clk.lap(4);
    }
    // 3. decoder: h_d = relu(((decb + z rows, l = 0 .. L-1) + x_prev_t.Wkd_x
    // (* skd))); in int8 each song's largest h_d over the block's units, in
    // f32 and bf16 the block's units of h_d as the frame head's operands
    for (int i = tid; i < Bp * L; i += kCThreads) {
      const int r = i / L, l = i - r * L;
      zsm[i] = r >= B ? 0.f
               : a.use_z_prior ? a.eps[((size_t)r * a.nsteps + t) * L + l]
                               : __ldcg(a.zs + i);
    }
    for (int n0 = 0; n0 < NT; n0 += kMaxNT) {
      const int nt = imin(kMaxNT, NT - n0);
      const auto* sums =
          a.use_x_prev ? products<E>(xlag, xw, kcx, wkd, gkd, NT, n0, nt, 0, mt, ring) : nullptr;
      __syncthreads();  // zsm is in
      for (int i = tid; i < Bp * 8 * nt; i += kCThreads) {
        const int r = i / (8 * nt), j = 8 * n0 + i - r * 8 * nt;
        float v = 0.f;
        if (r < B && j < nun) {
          v = a.decb[(size_t)r * H + u0 + j];
          for (int l = 0; l < L; ++l) v = __fadd_rn(v, __fmul_rn(zsm[r * L + l], wzd[l * nu + j]));
          if (sums)
            v = __fadd_rn(v, kI8 ? __fmul_rn(as_f32(sums[i]), sd[j]) : as_f32(sums[i]));
          v = fmaxf(v, 0.f);
        }
        hv[r * nu + j] = v;
      }
      __syncthreads();
    }
    if constexpr (kI8) {
      for (int r = warp; r < Bp; r += kCWarps) {
        float m = 0.f;  // h_d >= 0
        for (int j = lane; j < nun; j += 32) m = fmaxf(m, hv[r * nu + j]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0) a.hmax[(size_t)blockIdx.x * kCRows + r] = m;
      }
    } else {
      for (int i = tid; i < B * nun; i += kCThreads) {
        const int r = i / nun, j = i - r * nun;
        put(a.hq, hw, r, u0 + j, to_operand<E>(hv[r * nu + j]));
      }
    }
    if (timer) clk.lap(5);
    grid_sync(a.bar, rounds);
    if (timer) clk.lap(6);
    if constexpr (kI8) {
      // 4. rs = max(max h_d, 1e-12) / 127 per song, then the codes round(h_d
      // / rs) of the block's units
      row_max(Bp, G, [&](int g, int r) { return __ldcg(a.hmax + (size_t)g * kCRows + r); },
              [&](int r, float m) { rs[r] = __fdiv_rn(fmaxf(m, 1e-12f), 127.f); });
      __syncthreads();
      for (int i = tid; i < B * nun; i += kCThreads) {
        const int r = i / nun, j = i - r * nun;
        put(a.hq, hw, r, u0 + j,
            static_cast<signed char>(__float2int_rn(__fdiv_rn(hv[r * nu + j], rs[r]))));
      }
      if (timer) clk.lap(7);
      grid_sync(a.bar, rounds);
      if (timer) clk.lap(8);
    }
    // 5. frame head on h_d of every unit for the block's pitch tiles and song
    // group: p = sigmoid(h_d.Wx + bx) (int8: (codes.Wx * swx) * rs), the
    // Bernoulli draw, the output, and x_prev for the next step (into the
    // buffer the lagged frame leaves: it becomes x_prev_t then)
    if (heads) {
      for (int n0 = 0; n0 < P; n0 += kMaxNT) {
        const int nt = imin(kMaxNT, P - n0);
        const auto* sums = products<E>(a.hq, hw, kch, wxs, gx, P, n0, nt, m0, mtn, ring);
        if (timer) clk.lap(9);
        for (int i = tid; i < 16 * mtn * 8 * nt; i += kCThreads) {
          const int r = i / (8 * nt), c = i - r * 8 * nt, s = m0 + r;
          const int d = 8 * (pg * P + n0 + c / 8) + c % 8;
          if (s >= B || d >= D) continue;
          const float q = kI8 ? __fmul_rn(__fmul_rn(as_f32(sums[i]), a.swx[d]), rs[s])
                              : as_f32(sums[i]);
          const float xm = 1.f / (1.f + expf(-__fadd_rn(q, a.bx[d])));
          const size_t o = ((size_t)s * a.nsteps + t) * D + d;
          const float xt = a.u[o] < xm ? 1.f : 0.f;
          a.out[o] = a.return_probs ? xm : xt;
          put(xlag, xw, s, d, to_operand<E>(xt));
        }
        __syncthreads();
      }
    }
    if (timer) clk.lap(10);
    grid_sync(a.bar, rounds);
    if (timer) clk.lap(11);
  }
  if (timer) clk.flush();
}

template <typename E>
int launch_coop(const CoopArgs& a, cudaStream_t stream) {
  const size_t smem = coop_smem_bytes(a.D, a.H, a.L, a.nu, a.P, a.use_x_prev, a.res_cells,
                                      a.res_head, sizeof(E));
  cudaError_t err = cudaFuncSetAttribute(
      generate_vae_coop_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // cooperative: every block co-resident (the grid barrier needs it), or the
  // launch fails
  void* args[] = {const_cast<CoopArgs*>(&a)};
  err = cudaLaunchCooperativeKernel((const void*)generate_vae_coop_kernel<E>, dim3(cdiv(a.H, a.nu)),
                                    dim3(kCThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
}  // namespace

// Bytes of dynamic shared memory one block needs (the wrapper checks the limit).
extern "C" long long cvl_generate_cl_vae_smem_bytes(int D, int H, int L, int use_x_prev,
                                                    int bf16_weights) {
  return (long long)(smem_floats(D, H, L) * sizeof(float) +
                     smem_weights(D, H, L, use_x_prev) * (bf16_weights ? 2 : 4));
}

// Launches the sampler on `stream`; returns the cudaError_t of the launch.
extern "C" int cvl_generate_cl_vae(
    int bf16_weights, const float* seed, const float* eps, const float* u, const void* wke,
    const float* encb, const void* wz_t, const float* bz, const void* wkd_x,
    const float* wkd_z, const float* decb, const void* wx, const float* bx, float* out,
    int B, int nsteps, int D, int H, int L, int use_x_prev, int use_z_prior,
    int return_probs, void* stream) {
  const Args a{seed, eps, u, wke, encb, wz_t, bz, wkd_x, wkd_z, decb, wx, bx, out,
               B, nsteps, D, H, L, use_x_prev, use_z_prior, return_probs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_weights ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}

// Floats of per-song state one block of the wide kernel keeps (in shared
// memory, or in the global scratch the wrapper passes when it does not fit).
extern "C" long long cvl_generate_cl_vae_wide_state_floats(int D, int H, int L, int has_hidden) {
  return (long long)wide_state_floats(D, H, L, has_hidden);
}

// Bytes of dynamic shared memory one block of the wide kernel needs.
extern "C" long long cvl_generate_cl_vae_wide_smem_bytes(int D, int H, int L, int has_hidden,
                                                         int state_in_smem) {
  return (long long)wide_smem_bytes(D, H, L, has_hidden, state_in_smem);
}

// Launches the wide sampler on `stream`; returns the cudaError_t of the
// launch. Pointers a structure does not use are null; `state` is null when
// the per-song state fits shared memory.
extern "C" int cvl_generate_cl_vae_wide(
    const float* seed, const float* eps, const float* u, const float* wke,
    const float* encb, const float* wkd_x, const float* wkd_z, const float* decb,
    const float* wz_t, const float* zb, const float* wx, const float* wx_z, const float* wx_xp,
    const float* xb, float* out, float* state, int zb_stride, int xb_stride, int B, int nsteps,
    int D, int H, int L, int has_hidden, int use_x_prev, int use_z_prior, int return_probs,
    void* stream) {
  const WideArgs a{seed, eps,   u,         wke,        encb,        wkd_x, wkd_z,
                   decb, wz_t,  zb,        wx,         wx_z,        wx_xp, xb,
                   out,  state, zb_stride, xb_stride,  B,           nsteps, D,
                   H,    L,     has_hidden, use_x_prev, use_z_prior, return_probs};
  return launch_wide(a, static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory one block of the cooperative kernel needs:
// a block owning nu hidden units and P pitch tiles, its slices resident or
// not (the wrapper picks residency where it fits the limit), operands of
// `ebytes` bytes (1 int8, 2 bf16, 4 f32).
extern "C" long long cvl_generate_cl_vae_coop_smem_bytes(int D, int H, int L, int nu, int P,
                                                         int use_x_prev, int res_cells,
                                                         int res_head, int ebytes) {
  return (long long)coop_smem_bytes(D, H, L, nu, P, use_x_prev, res_cells, res_head, ebytes);
}

// 4-byte words of the state the cooperative kernel's blocks share in global
// memory (the caller zeroes them).
extern "C" long long cvl_generate_cl_vae_coop_state_words(int D, int H, int L, int nu,
                                                          int ebytes) {
  return (long long)coop_state(D, H, L, cdiv(H, nu), ebytes).total;
}

// Launches the cooperative sampler on `stream` for B <= 64 songs, its
// operands `ebytes` bytes (1: int8 codes, 2: bf16, 4: f32): one cooperative
// launch of cdiv(H, nu) blocks, each owning nu hidden units and P pitch
// tiles of one of hs song groups; wke, wkd and wx packed by the wrapper
// (`pack_coop`); wkd and skd null without use_x_prev, the three scales null
// outside int8; wz_t bf16 in int8 and bf16, f32 in f32; `state` holds
// cvl_generate_cl_vae_coop_state_words zeroed words; `clock` (kLaps counts,
// or null) receives block 0's ns per part of a step summed over the steps
// (CoopClock). Returns the cudaError_t of the launch
// (cudaErrorCooperativeLaunchTooLarge where the grid cannot be co-resident).
extern "C" int cvl_generate_cl_vae_coop(
    int ebytes, const float* seed, const float* eps, const float* u, const int* wke,
    const int* wkd, const int* wx, const float* ske, const float* skd, const float* encb,
    const float* decb, const void* wz_t, const float* bz, const float* wkd_z, const float* swx,
    const float* bx, float* out, int* state, unsigned long long* clock, int B, int nsteps, int D,
    int H, int L, int use_x_prev, int use_z_prior, int return_probs, int nu, int P, int hs,
    int res_cells, int res_head, void* stream) {
  const CoopState st = coop_state(D, H, L, cdiv(H, nu), ebytes);
  const CoopArgs a{seed, eps, u, wke, wkd, wx, ske, skd, encb, decb, wz_t, bz, wkd_z, swx, bx, out,
                   state + st.xq, state + st.hq, reinterpret_cast<double*>(state + st.zpart),
                   reinterpret_cast<float*>(state + st.zs),
                   reinterpret_cast<float*>(state + st.hmax),
                   reinterpret_cast<unsigned*>(state + st.bar), clock, B, nsteps, D, H, L,
                   use_x_prev, use_z_prior, return_probs, nu, P, hs, res_cells, res_head};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ebytes) {
    case 1: return launch_coop<signed char>(a, s);
    case 2: return launch_coop<__nv_bfloat16>(a, s);
    case 4: return launch_coop<float>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
