// Whole-generation cl_vae sampler for Hopper (sm_90a): f32 or bf16 weights
// (`generate_kernel`, `generate_wide_kernel`), or int8 weights
// (`generate_wide_int8_kernel`, at the end).
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
// The second kernel, `generate_wide_kernel`, takes every config the first
// one refuses: models whose weights do not fit one block's shared memory
// (f32 from H ~ 204, bf16 from H ~ 390 at D=88, L=4, use_x_prev), and models
// without hidden layers. It replaces the same `_make_kernel` at the widths
// where the TPU kernel kept its weights in VMEM, and the JAX package's XLA
// scan (sampling/generate.py `generate_cl_vae_batch_noise`) for configs
// without hidden layers, which no Pallas kernel takes. It computes exactly
// what the first kernel computes: the same operands (the wrapper's `_pack`),
// the same rounding in bf16 mode, the same step order. Without hidden layers
// the z heads read x_prev (and the folded w rows) and the frame head reads z
// as L rank-1 terms and x_prev_t (and the folded w rows).
//
// What bounds the wide kernel. Per song-step it does D*H*(1 + use_x_prev) +
// 3*L*H + H*D FMAs; at the seq-concat width without x_prev (D = H = 1024,
// L = 16) that is ~2.1 M FMAs, ~69 GFLOP for 64 songs x 256 steps, ~1.0 ms
// at 67 TFLOP/s of f32 FMAs (chip_smoke.py's `roofline_ms` gives the bound
// with the bf16 rate where the weights are bf16). But every block reads all
// the weights from L2 every step (~4 MB in bf16 at that width), so a step
// costs about the L2-to-SM transfer of the weights, and the steps run in
// series: the kernel sits far above its bound.
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
// The third kernel, `generate_wide_int8_kernel`, replaces
// classifying_vae_lstm_tpu/ops/pallas_generate_vae.py:192 `_make_kernel_int8`
// (the int8 body of `generate_cl_vae_batch_pallas`), which the JAX package
// picks for a bf16 checkpoint whose bf16 weights pass its VMEM rule (the
// seq-concat width D=1,024, L=16: H = 4,160 ... 7,808). It is the wide
// kernel with the three large weights (encoder x rows, decoder x_prev rows,
// frame head) as per-column int8 codes with f32 scales, quantized by the
// wrapper as JAX quantizes them; the z heads stay bf16 and the decoder z
// rows f32. Its numerics: binary frames are exact codes; the decoder's relu
// hidden h_d gets a per-song scale rs = max(max h_d, 1e-12) / 127 (h_d >= 0,
// so its max is its largest magnitude) and enters the frame head as
// round(h_d / rs) (IEEE division, `__float2int_rn` rounding half to even as
// jnp.round); every product sums int8 codes in int32 (`__dp4a`, four k at a
// time), exact in any order, so the K-split groups' partial sums add
// exactly; each column is dequantized once and the f32 epilogue is written
// with __fmul_rn / __fadd_rn in the JAX kernel's order (h_e = relu((float)
// acc * s + encb); z_d = decb, then the L z rows, then (float)acc * s; p =
// sigmoid(((float)acc * s) * rs + bx)), so nvcc contracts nothing into an FMA.
// Weights are packed by the wrapper as [ceil(K/4)][N] words of four k (zero
// rows pad K); the codes of the frames and of h_d are [ceil(K/4)][kSongs]
// words in the per-song state.
//
// What bounds the int8 kernel. At the seq-concat width (D=1,024, H=5,120,
// L=16, no x_prev), 64 songs x 256 steps, it does 1.05e7 int8 MACs per
// song-step, 1.7e11 MACs (3.4e11 operations) for the call: ~0.17 ms at the
// card's 1,979 TOPS of int8 tensor-core products, against 10.5 MB of int8
// weights (15.7 MB with x_prev), ~0.003 ms at HBM rate, so operations bound
// it (chip_smoke.py's `int8_bound_ms` prints both). Every block still
// reads every weight from L2 each step, as the wide kernel does, and
// `__dp4a` runs on the integer pipes, not the tensor cores: the kernel sits
// hundreds of times above its bound. The lever of a later PR is int8
// `mma.sync` (m16n8k32) or `wgmma`, with the columns split over a cluster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

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
  const void* wke;     // [D, H]  encoder x rows (hidden layers only)
  const float* encb;   // [B, H]  w rows . w + bias, per song
  const void* wkd_x;   // [D, H]  decoder x_prev rows (hidden layers and use_x_prev)
  const float* wkd_z;  // [L, H]  decoder z rows, f32
  const float* decb;   // [B, H]
  const void* wz_t;    // [2L, E] z heads over e (h_e, E = H; without hidden layers x_prev, E = D)
  const float* zb;     // z-head bias: [2L] (zb_stride 0) or the per-song fold [B, 2L]
  const void* wx;      // [H, D]  frame head (hidden layers only)
  const float* wx_z;   // [L, D]  frame head z rows, f32 (no hidden layers)
  const void* wx_xp;   // [D, D]  frame head x_prev rows (no hidden layers, use_x_prev)
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

__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// One operand of a layer: a [k][kSongs] tile (shared or scratch memory)
// times a [k, N] row-major weight in global memory; k = 0 skips it.
template <typename W>
struct Op {
  const float* a;
  const W* w;
  int k;
};

// acc[b] += sum_{k0 <= k < k1} a[k][b] * w[k * N + n]
template <typename W>
__device__ __forceinline__ void mac_rows(float (&acc)[kSongs], const Op<W>& o, int N, int n,
                                         int k0, int k1) {
  if (k0 >= k1) return;
  const W* wp = o.w + (size_t)k0 * N + n;
#pragma unroll 16
  for (int k = k0; k < k1; ++k, wp += N) {
    const float wv = ldg(wp);
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
template <typename W1, typename W2, typename Epi>
__device__ __forceinline__ void cols_layer(const Op<W1>& o1, const Op<W2>& o2, int N,
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
template <typename WT>
__device__ __forceinline__ void z_draw(const WideArgs& a, const float* e, int E, float* zs,
                                       int t, int s0) {
  const WT* wz = static_cast<const WT*>(a.wz_t);
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

template <typename WT>
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
    const float x = s < a.B ? operand<WT>(a.seed[(size_t)s * D + d]) : 0.f;
    xp[i] = x;
    xpt[i] = x;
  }
  __syncthreads();

  const Op<float> none{nullptr, nullptr, 0};
  const auto prob = [&](int d, int b, float acc) {
    pm[d * kSongs + b] = 1.f / (1.f + expf(-(acc + fold(a.xb, a.xb_stride, b, d))));
  };
  for (int t = 0; t < a.nsteps; ++t) {
    if (a.has_hidden) {
      // z-encoder hidden: h_e = relu(x_prev @ Wke + encb)
      cols_layer(Op<WT>{xp, static_cast<const WT*>(a.wke), D}, none, H, partial,
                 [&](int n, int b, float acc) {
                   he[n * kSongs + b] = operand<WT>(fmaxf(acc + fold(a.encb, H, b, n), 0.f));
                 });
      __syncthreads();
      z_draw<WT>(a, he, H, zs, t, s0);
      __syncthreads();
      // decoder hidden: h_d = relu(decb + sum_l z_l Wkd_z[l] (+ x_prev_t @ Wkd_x))
      cols_layer(Op<float>{zs, a.wkd_z, L},
                 Op<WT>{xpt, static_cast<const WT*>(a.wkd_x), a.use_x_prev ? D : 0}, H, partial,
                 [&](int n, int b, float acc) {
                   hd[n * kSongs + b] = operand<WT>(fmaxf(acc + fold(a.decb, H, b, n), 0.f));
                 });
      __syncthreads();
      // frame head: p = sigmoid(h_d @ Wx + bx)
      cols_layer(Op<WT>{hd, static_cast<const WT*>(a.wx), H}, none, D, partial, prob);
    } else {
      // z heads over x_prev (w rows folded into zb)
      z_draw<WT>(a, xp, D, zs, t, s0);
      __syncthreads();
      // frame head: p = sigmoid(xb + sum_l z_l Wx_z[l] (+ x_prev_t @ Wx_xp))
      cols_layer(Op<float>{zs, a.wx_z, L},
                 Op<WT>{xpt, static_cast<const WT*>(a.wx_xp), a.use_x_prev ? D : 0}, D,
                 partial, prob);
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

template <typename WT>
int launch_wide(const WideArgs& a, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(a.D, a.H, a.L, a.has_hidden, a.state == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      generate_wide_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.B + kSongs - 1) / kSongs);
  generate_wide_kernel<WT><<<grid, kWideThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------- the int8 kernel

static_assert(kSongs == 2, "the int8 kernel loads the tile's two code words as one int2");

struct Int8Args {
  const float* seed;          // [B, D]
  const float* eps;           // [B, nsteps, L]
  const float* u;             // [B, nsteps, D]
  const int* wke;             // [D4, H]  encoder x rows, int8 codes four k to a word
  const float* ske;           // [H]      their scales
  const float* encb;          // [B, H]   w rows . w + bias, per song
  const __nv_bfloat16* wz_t;  // [2L, H]  z_mean | z_log_var kernels, transposed, bf16
  const float* bz;            // [2L]
  const int* wkd_x;           // [D4, H]  decoder x_prev rows (use_x_prev)
  const float* skd;           // [H]
  const float* wkd_z;         // [L, H]   decoder z rows, f32
  const float* decb;          // [B, H]
  const int* wx;              // [H4, D]  frame head, four k to a word
  const float* swx;           // [D]
  const float* bx;            // [D]
  float* out;                 // [B, nsteps, D]
  float* state;               // null: per-song state in shared memory; else [grid, state floats]
  int B, nsteps, D, H, L, use_x_prev, use_z_prior, return_probs;
};

__host__ __device__ constexpr int words(int k) { return (k + 3) / 4; }

// per-song state of one block, in 4-byte units: the code words of x_prev and
// x_prev_t ([D4][kSongs] each), the step's probabilities ([D][kSongs]), z
// ([L][kSongs]), h_e (the z heads' bf16-valued operand) and h_d ([H][kSongs]
// each), and h_d's code words ([H4][kSongs])
__host__ __device__ constexpr size_t int8_state_words(int D, int H, int L) {
  return (size_t)kSongs * (2 * words(D) + D + L + 2 * H + words(H));
}

// the K-split int partial sums, then the row-max reduction ([kWideWarps]
// [kSongs]) and the songs' row scales ([kSongs])
constexpr size_t kInt8FixedWords = kPartialFloats + (size_t)(kWideWarps + 1) * kSongs;

size_t int8_smem_bytes(int D, int H, int L, int state_in_smem) {
  return (kInt8FixedWords + (state_in_smem ? int8_state_words(D, H, L) : 0)) * 4;
}

// acc[b] += sum_{k0 <= k < k1} dot4(a[k][b], w[k * N + n]): a is [K4][kSongs]
// code words, w a [K4, N] array of code words in global memory
__device__ __forceinline__ void mac_rows_i8(int (&acc)[kSongs], const int* a, const int* w,
                                            int N, int n, int k0, int k1) {
  const int* wp = w + (size_t)k0 * N + n;
#pragma unroll 16
  for (int k = k0; k < k1; ++k, wp += N) {
    const int wv = __ldg(wp);
    const int2 av = *reinterpret_cast<const int2*>(a + k * kSongs);
    acc[0] = __dp4a(av.x, wv, acc[0]);
    acc[1] = __dp4a(av.y, wv, acc[1]);
  }
}

// cols_layer for int8 codes: epi(n, b, sum_k dot4(a[k][b], w[k * N + n]))
// exactly once for each column n < N and song b. Narrow layers split the K4
// words across S groups, whose int partial sums meet in `partial` (exact in
// any order). The caller syncs before the next layer reads what epi stored.
template <typename Epi>
__device__ __forceinline__ void cols_layer_i8(const int* a, const int* w, int K4, int N,
                                              int* partial, Epi epi) {
  const int S = slices_for(N);
  if (S == 1) {
    for (int n = threadIdx.x; n < N; n += kWideThreads) {
      int acc[kSongs] = {0, 0};
      if (K4) mac_rows_i8(acc, a, w, N, n, 0, K4);
#pragma unroll
      for (int b = 0; b < kSongs; ++b) epi(n, b, acc[b]);
    }
    return;
  }
  const int s = threadIdx.x / N, n = threadIdx.x - s * N;
  if (s < S) {
    int acc[kSongs] = {0, 0};
    if (K4) mac_rows_i8(acc, a, w, N, n, K4 * s / S, K4 * (s + 1) / S);
#pragma unroll
    for (int b = 0; b < kSongs; ++b) partial[(s * N + n) * kSongs + b] = acc[b];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N * kSongs; i += kWideThreads) {
    const int col = i / kSongs, b = i - col * kSongs;
    int v = 0;
    for (int q = 0; q < S; ++q) v += partial[(q * N + col) * kSongs + b];
    epi(col, b, v);
  }
}

// The bf16 z heads of the int8 kernel: returns, in lane b < kSongs, sum_k
// a[k][b] * wrow[k] for bf16-valued a, summed in double and rounded to f32
// once. Each product of two bf16 values is exact, and the double sum rounds
// them the same in any order to within 2^-53, so the kernel's z and the plain
// version's (a float64 product) agree: an f32 sum in two orders may differ by
// an ulp, which the decoder's h_d / rs can turn into another code.
__device__ __forceinline__ float warp_dot_exact(const float* a, const __nv_bfloat16* wrow,
                                                int K, int lane) {
  double s[kSongs];
#pragma unroll
  for (int b = 0; b < kSongs; ++b) s[b] = 0.0;
  for (int k = lane; k < K; k += 32) {
    const double w = __bfloat162float(wrow[k]);
#pragma unroll
    for (int b = 0; b < kSongs; ++b) s[b] = fma((double)a[k * kSongs + b], w, s[b]);
  }
  float mine = 0.f;
#pragma unroll
  for (int b = 0; b < kSongs; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[b] += __shfl_xor_sync(0xffffffffu, s[b], off);
    if (lane == b) mine = __double2float_rn(s[b]);
  }
  return mine;
}

// the int8 code of one operand entry into byte `r % 4` of its word
__device__ __forceinline__ void put_code(int* words_, int r, int b, int code) {
  reinterpret_cast<signed char*>(words_)[((r / 4) * kSongs + b) * 4 + (r % 4)] =
      static_cast<signed char>(code);
}

__global__ void __launch_bounds__(kWideThreads) generate_wide_int8_kernel(const Int8Args a) {
  extern __shared__ int4 smem_i4[];
  int* partial = reinterpret_cast<int*>(smem_i4);  // [kPartialFloats]
  float* red = reinterpret_cast<float*>(partial + kPartialFloats);  // [kWideWarps][kSongs]
  float* rs = red + kWideWarps * kSongs;                             // [kSongs]
  const int D = a.D, H = a.H, L = a.L, D4 = words(D), H4 = words(H);
  int* st = a.state ? reinterpret_cast<int*>(a.state) +
                          (size_t)blockIdx.x * int8_state_words(D, H, L)
                    : partial + kInt8FixedWords;
  int* xpq = st;                                        // [D4][kSongs]  x_prev codes
  int* xptq = xpq + D4 * kSongs;                        // [D4][kSongs]  x_prev_t codes
  float* pm = reinterpret_cast<float*>(xptq + D4 * kSongs);  // [D][kSongs]
  float* zs = pm + D * kSongs;                          // [L][kSongs]
  float* he = zs + L * kSongs;                          // [H][kSongs]
  float* hd = he + H * kSongs;                          // [H][kSongs]
  int* hdq = reinterpret_cast<int*>(hd + H * kSongs);   // [H4][kSongs]
  const int s0 = blockIdx.x * kSongs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const auto fold = [&](const float* f, int b, int n) {
    const int s = s0 + b;
    return s < a.B ? f[(size_t)s * H + n] : 0.f;
  };

  for (int i = threadIdx.x; i < 2 * D4 * kSongs; i += kWideThreads) xpq[i] = 0;  // pad bytes
  __syncthreads();
  for (int i = threadIdx.x; i < D * kSongs; i += kWideThreads) {
    const int d = i / kSongs, b = i % kSongs, s = s0 + b;
    const int x = s < a.B ? __float2int_rz(a.seed[(size_t)s * D + d]) : 0;
    put_code(xpq, d, b, x);
    put_code(xptq, d, b, x);
  }
  __syncthreads();

  for (int t = 0; t < a.nsteps; ++t) {
    // z-encoder hidden: h_e = relu(x_prev.Wke * ske + encb), kept bf16-valued
    cols_layer_i8(xpq, a.wke, D4, H, partial, [&](int n, int b, int acc) {
      const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), a.ske[n]), fold(a.encb, b, n));
      he[n * kSongs + b] = operand<__nv_bfloat16>(fmaxf(v, 0.f));
    });
    __syncthreads();
    // z heads (bf16, summed exactly) and the draw, one warp per latent
    for (int l = warp; l < L; l += kWideWarps) {
      const float zm = warp_dot_exact(he, a.wz_t + (size_t)l * H, H, lane);
      const float zv = warp_dot_exact(he, a.wz_t + (size_t)(L + l) * H, H, lane);
      const int s = s0 + lane;
      if (lane < kSongs) {
        float z = 0.f;
        if (s < a.B) {
          const float ep = a.eps[((size_t)s * a.nsteps + t) * L + l];
          const float scale = expf(__fadd_rn(zv, a.bz[L + l]) / 2.f);
          z = a.use_z_prior ? ep : __fadd_rn(__fadd_rn(zm, a.bz[l]), __fmul_rn(scale, ep));
        }
        zs[l * kSongs + lane] = z;
      }
    }
    __syncthreads();
    // decoder hidden: h_d = relu(((decb + z rows, l = 0..L-1) + x_prev_t.Wkd_x * skd))
    cols_layer_i8(xptq, a.wkd_x, a.use_x_prev ? D4 : 0, H, partial, [&](int n, int b, int acc) {
      float v = fold(a.decb, b, n);
      for (int l = 0; l < L; ++l)
        v = __fadd_rn(v, __fmul_rn(zs[l * kSongs + b], a.wkd_z[(size_t)l * H + n]));
      if (a.use_x_prev) v = __fadd_rn(v, __fmul_rn(__int2float_rn(acc), a.skd[n]));
      hd[n * kSongs + b] = fmaxf(v, 0.f);
    });
    __syncthreads();
    // per-song scale rs = max(max_n h_d, 1e-12) / 127 (a max is exact in any order)
    {
      float m[kSongs] = {0.f, 0.f};
      for (int n = threadIdx.x; n < H; n += kWideThreads)
#pragma unroll
        for (int b = 0; b < kSongs; ++b) m[b] = fmaxf(m[b], hd[n * kSongs + b]);
#pragma unroll
      for (int b = 0; b < kSongs; ++b) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m[b] = fmaxf(m[b], __shfl_xor_sync(0xffffffffu, m[b], off));
        if (lane == 0) red[warp * kSongs + b] = m[b];
      }
      __syncthreads();
      if (threadIdx.x < kSongs) {
        float mx = 0.f;
        for (int w = 0; w < kWideWarps; ++w) mx = fmaxf(mx, red[w * kSongs + threadIdx.x]);
        rs[threadIdx.x] = __fdiv_rn(fmaxf(mx, 1e-12f), 127.f);
      }
      __syncthreads();
    }
    // h_d's codes, round(h_d / rs), four k to a word (zero past H)
    for (int i = threadIdx.x; i < H4 * kSongs; i += kWideThreads) {
      const int k4 = i / kSongs, b = i % kSongs;
      unsigned word = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 4 * k4 + r;
        const int c = n < H ? __float2int_rn(__fdiv_rn(hd[n * kSongs + b], rs[b])) : 0;
        word |= (unsigned)(c & 0xff) << (8 * r);
      }
      hdq[i] = (int)word;
    }
    __syncthreads();
    // frame head: p = sigmoid((round(h_d / rs).Wx * swx) * rs + bx)
    cols_layer_i8(hdq, a.wx, H4, D, partial, [&](int d, int b, int acc) {
      const float q = __fmul_rn(__fmul_rn(__int2float_rn(acc), a.swx[d]), rs[b]);
      pm[d * kSongs + b] = 1.f / (1.f + expf(-__fadd_rn(q, a.bx[d])));
    });
    __syncthreads();
    // Bernoulli draw, both carries (the lagged frame takes the old x_prev
    // first), output; the carries are code words, so one thread takes a
    // word's four pitches
    for (int i = threadIdx.x; i < D4 * kSongs; i += kWideThreads) {
      const int k4 = i / kSongs, b = i % kSongs, s = s0 + b;
      if (s >= a.B) continue;
      unsigned word = 0;
      for (int r = 0; r < 4 && 4 * k4 + r < D; ++r) {
        const int d = 4 * k4 + r;
        const float xm = pm[d * kSongs + b];
        const float xt = a.u[((size_t)s * a.nsteps + t) * D + d] < xm ? 1.f : 0.f;
        word |= (unsigned)(xt != 0.f) << (8 * r);
        a.out[((size_t)s * a.nsteps + t) * D + d] = a.return_probs ? xm : xt;
      }
      xptq[i] = xpq[i];
      xpq[i] = (int)word;
    }
    __syncthreads();
  }
}

int launch_int8(const Int8Args& a, cudaStream_t stream) {
  const size_t smem = int8_smem_bytes(a.D, a.H, a.L, a.state == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      generate_wide_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.B + kSongs - 1) / kSongs);
  generate_wide_int8_kernel<<<grid, kWideThreads, smem, stream>>>(a);
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
    int bf16_weights, const float* seed, const float* eps, const float* u, const void* wke,
    const float* encb, const void* wkd_x, const float* wkd_z, const float* decb,
    const void* wz_t, const float* zb, const void* wx, const float* wx_z, const void* wx_xp,
    const float* xb, float* out, float* state, int zb_stride, int xb_stride, int B, int nsteps,
    int D, int H, int L, int has_hidden, int use_x_prev, int use_z_prior, int return_probs,
    void* stream) {
  const WideArgs a{seed, eps,   u,         wke,        encb,        wkd_x, wkd_z,
                   decb, wz_t,  zb,        wx,         wx_z,        wx_xp, xb,
                   out,  state, zb_stride, xb_stride,  B,           nsteps, D,
                   H,    L,     has_hidden, use_x_prev, use_z_prior, return_probs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_weights ? launch_wide<__nv_bfloat16>(a, st) : launch_wide<float>(a, st);
}

// Floats of per-song state one block of the int8 kernel keeps (in shared
// memory, or in the global scratch the wrapper passes when it does not fit).
extern "C" long long cvl_generate_cl_vae_int8_state_floats(int D, int H, int L) {
  return (long long)int8_state_words(D, H, L);
}

// Bytes of dynamic shared memory one block of the int8 kernel needs.
extern "C" long long cvl_generate_cl_vae_int8_smem_bytes(int D, int H, int L, int state_in_smem) {
  return (long long)int8_smem_bytes(D, H, L, state_in_smem);
}

// Launches the int8 sampler on `stream`; returns the cudaError_t of the
// launch. `wkd_x` and `skd` are null without use_x_prev; `state` is null
// when the per-song state fits shared memory.
extern "C" int cvl_generate_cl_vae_int8(
    const float* seed, const float* eps, const float* u, const int* wke, const float* ske,
    const float* encb, const void* wz_t, const float* bz, const int* wkd_x, const float* skd,
    const float* wkd_z, const float* decb, const int* wx, const float* swx, const float* bx,
    float* out, float* state, int B, int nsteps, int D, int H, int L, int use_x_prev,
    int use_z_prior, int return_probs, void* stream) {
  const Int8Args a{seed,  eps,  u,     wke,         ske,   encb,
                   static_cast<const __nv_bfloat16*>(wz_t), bz,   wkd_x, skd,
                   wkd_z, decb, wx,    swx,         bx,    out,  state, B,
                   nsteps, D,   H,     L,           use_x_prev, use_z_prior, return_probs};
  return launch_int8(a, static_cast<cudaStream_t>(stream));
}
