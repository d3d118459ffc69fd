// Whole-generation cl_vae sampler for Hopper (sm_90a), f32 or bf16 weights.
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
