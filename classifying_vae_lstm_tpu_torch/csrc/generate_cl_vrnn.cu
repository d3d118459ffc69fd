// Whole-generation cl_vrnn sampler for Hopper (sm_90a): f32 or bf16 weights
// (`generate_kernel`), or int8 weights (`generate_int8_kernel`, at the end).
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_generate.py:153 `_make_kernel`
// (the f32/bf16 body of `generate_cl_vrnn_batch_pallas`). One launch runs the
// whole autoregressive song: encoder LSTM cell, z heads, z = m + exp(v/2)*eps,
// decoder LSTM cell (z as L rank-1 terms), sigmoid frame head, the Bernoulli
// draw x_t = (u < p), and x_t fed back as the next input. The per-song folds of
// the w rows and biases (encb, decb) are computed by the caller.
//
// What bounds it on this card. At the largest serving bucket (64 songs, 32 seed
// + 256 free steps, H=256, D=88, L=8) the call is ~27 GFLOP of f32 FMAs and
// ~17 MB of streams and weights, so operations bound it (~0.41 ms at 67 TFLOP/s
// f32 without tensor cores; the bytes take ~5 us). But every step depends on
// the previous one, so the 288 steps run in series.
//
// What the design does about it. Songs are independent: one block owns a tile
// of kSongs songs and runs the WHOLE time loop itself, so nothing is carried
// between blocks (the TPU grid walked time blocks in order and carried state
// in VMEM scratch). The carried state (h and c of both cells, the fed-back
// frame) lives in shared memory, stored [unit][song] so that one float4 load
// gives four songs' operand. The weights (2.9 MB in f32 at H=256) cannot stay
// in one SM's 227 KB as they stayed in VMEM, so they are read from global
// memory each step and stay resident in the 50 MB L2; they are stored
// [in, 4H] row-major so neighbouring threads read neighbouring columns. Each
// thread owns hidden units and computes their four gate columns (i, f, c, o)
// for all songs of the tile in registers, so the gates are applied without a
// trip through shared memory. Known limit of this simple form: each block
// streams every weight from L2 once per step, so a step costs about the L2->SM
// transfer of the weights and the kernel sits far above its bound; splitting
// the weights across the SMs of a cluster, and wgmma, are later work.
//
// Numerics follow the TPU kernel: hard sigmoid clip(0.2x+0.5, 0, 1) for i, f,
// o; tanhf for g and c; expf for the z scale and the logistic head; no fast
// math. In bf16 mode the weights are bf16 and the matmul operands x and h are
// rounded to bf16 (h is stored rounded, as it is only ever read as an
// operand), z stays f32, and every product accumulates in f32.
//
// The int8 kernel, `generate_int8_kernel`, replaces
// classifying_vae_lstm_tpu/ops/pallas_generate.py:211 `_make_kernel_int8`
// (the int8 body of `generate_cl_vrnn_batch_pallas`), which the JAX package
// picks for a bf16 checkpoint whose bf16 weights pass its VMEM rule (at D=88,
// L=2: H = 1,240 ... 1,752). The five large weights (encoder x rows and
// recurrent kernel, decoder x_prev rows and recurrent kernel, frame head)
// are per-column int8 codes with f32 scales, quantized by the wrapper as JAX
// quantizes them; the z head stays bf16 and the decoder z rows f32.
//
// Numerics. Every int8 product is exact: the operands are int8 codes (x is
// binary; h enters as round(h * 127), `__float2int_rn`, half to even like
// jnp.round), and the sums are int32 (`__dp4a` over four k at a time), so
// the accumulators equal the plain version's bit for bit in any order. Each
// column is dequantized once, (float)acc * scale, and the f32 epilogue is
// written with __fmul_rn / __fadd_rn in the JAX kernel's order, so that nvcc
// contracts nothing into an FMA: an ulp of h moved by a contraction can land
// on the other side of a rounding tie of h * 127 and change a code by one.
// The weights are packed by the wrapper as [ceil(K/4)][N] words of four k
// (zero rows pad K), the frame head as [D][ceil(H/4)]; the codes of x and h
// live in shared memory as [ceil(K/4)][kSongs] words, one int4 load giving
// the four songs' words.
//
// What bounds the int8 kernel. At the JAX band's H=1,536 (D=88, L=2,
// use_x_prev), 64 songs x (32 + 256) steps, it does 2.0e7 int8 MACs per
// song-step, 3.7e11 MACs (7.4e11 operations) for the call: ~0.37 ms at the
// card's 1,979 TOPS of int8 tensor-core products, against 20.7 MB of int8
// weights, 0.006 ms at HBM rate, so operations bound it (chip_smoke.py's
// `int8_bound_ms` prints both).
// The design is the bf16 kernel's: one block per 4-song tile runs every
// step, and every block reads all its weights from L2 each step (20.7 MB,
// half the bf16 weights' 40.7 MB, so the L2 holds them); `__dp4a` runs on
// the integer pipes, not the tensor cores, and 16 blocks leave most SMs
// idle, so the kernel sits hundreds of times above its bound. The lever of a
// later PR is int8 `mma.sync` (m16n8k32) or `wgmma` on the tensor cores,
// with the columns split over a cluster's SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kSongs = 4;                   // songs per block (multiple of 4: float4 loads)
constexpr int kThreads = 512;               // threads per block
constexpr int kSlices = 2;                  // the gate matmuls' K is split between two groups
constexpr int kUnits = kThreads / kSlices;  // hidden units per pass of the gate stages
constexpr int kWarps = kThreads / 32;

struct Args {
  const float* seed;  // [B, Tseed, D]
  const float* eps;   // [B, total, L]
  const float* u;     // [B, total, D]
  const void* wke_x;  // [D, 4H]  encoder x rows
  const void* rke;    // [H, 4H]  encoder recurrent kernel
  const float* encb;  // [B, 4H]  w rows . w + bias, per song
  const void* wz_t;   // [2L, H]  Z_mean | Z_log_var kernels, transposed
  const float* bz;    // [2L]
  const void* wkd_x;  // [D, 4H]  decoder x_prev rows (unused without use_x_prev)
  const void* wkd_z;  // [L, 4H]  decoder z rows
  const void* rkd;    // [H, 4H]  decoder recurrent kernel
  const float* decb;  // [B, 4H]
  const void* wx_t;   // [D, H]   frame head, transposed
  const float* bx;    // [D]
  float* out;         // [B, total - Tseed, D]
  int B, Tseed, total, D, H, L, use_x_prev, return_probs;
};

// shared memory: the carried state ([rows][kSongs] each: x_in, h_e x2, c_e,
// h_d x2, c_d, z) and the gate stages' partial sums ([4][kSongs][kUnits])
__host__ __device__ constexpr size_t smem_floats(int D, int H, int L) {
  return (size_t)(D + 6 * H + L) * kSongs + (size_t)4 * kSongs * kUnits;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
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

__device__ __forceinline__ float hard_sigmoid(float x) {
  return fminf(fmaxf(0.2f * x + 0.5f, 0.f), 1.f);
}

// acc[g][b] += sum_k a[k][b] * w[k][u + g*H] over this slice's half of the K
// rows, for the four gate columns of unit u. a is a [K][kSongs] operand in
// shared memory, w a [K, 4H] weight in global memory.
template <typename WT>
__device__ __forceinline__ void mac_gates(float (&acc)[4][kSongs], const float* a,
                                          const WT* __restrict__ w, int K, int u, int H,
                                          int slice) {
  const int k0 = slice ? K / 2 : 0, k1 = slice ? K : K / 2;
  const WT* wp = w + (size_t)k0 * 4 * H + u;
#pragma unroll 8
  for (int k = k0; k < k1; ++k, wp += 4 * H) {
    const float w0 = ld(wp), w1 = ld(wp + H), w2 = ld(wp + 2 * H), w3 = ld(wp + 3 * H);
    const float4* ap = reinterpret_cast<const float4*>(a + k * kSongs);
#pragma unroll
    for (int q = 0; q < kSongs / 4; ++q) {
      const float4 v = ap[q];
      const float av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int b = 4 * q + r;
        acc[0][b] = fmaf(av[r], w0, acc[0][b]);
        acc[1][b] = fmaf(av[r], w1, acc[1][b]);
        acc[2][b] = fmaf(av[r], w2, acc[2][b]);
        acc[3][b] = fmaf(av[r], w3, acc[3][b]);
      }
    }
  }
}

// Returns, in lane b < kSongs, sum_k a[k][b] * wrow[k]: the warp's lanes split
// k and a shuffle butterfly adds their partial sums.
template <typename WT>
__device__ __forceinline__ float warp_dot(const float* a, const WT* __restrict__ wrow, int K,
                                          int lane) {
  float s[kSongs];
#pragma unroll
  for (int b = 0; b < kSongs; ++b) s[b] = 0.f;
#pragma unroll 4
  for (int k = lane; k < K; k += 32) {
    const float w = ld(wrow + k);
    const float4* ap = reinterpret_cast<const float4*>(a + k * kSongs);
#pragma unroll
    for (int q = 0; q < kSongs / 4; ++q) {
      const float4 v = ap[q];
      s[4 * q + 0] = fmaf(v.x, w, s[4 * q + 0]);
      s[4 * q + 1] = fmaf(v.y, w, s[4 * q + 1]);
      s[4 * q + 2] = fmaf(v.z, w, s[4 * q + 2]);
      s[4 * q + 3] = fmaf(v.w, w, s[4 * q + 3]);
    }
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

// One LSTM cell for all units: z = bias + sum of the operand products, then
// the Keras-2.0 gates. Each unit's K is split between the two slices of the
// block; slice 1 hands its partial sums to slice 0 through shared memory.
template <typename WT>
__device__ __forceinline__ void lstm_cell(const Args& a, const float* bias, int s0,
                                          const float* x0, const WT* w0, int k0,
                                          const float* x1, const WT* w1, int k1,
                                          const float* x2, const WT* w2, int k2,
                                          float* c, float* h_out, float* part) {
  const int H = a.H;
  const int slice = threadIdx.x / kUnits, lu = threadIdx.x % kUnits;
  for (int u0 = 0; u0 < H; u0 += kUnits) {  // uniform trip count: syncs inside
    const int u = u0 + lu;
    float acc[4][kSongs];
#pragma unroll
    for (int b = 0; b < kSongs; ++b) {
      const int s = s0 + b;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[g][b] = (slice == 0 && u < H && s < a.B) ? bias[(size_t)s * 4 * H + g * H + u] : 0.f;
    }
    if (u < H) {
      mac_gates(acc, x0, w0, k0, u, H, slice);
      if (k1) mac_gates(acc, x1, w1, k1, u, H, slice);
      if (k2) mac_gates(acc, x2, w2, k2, u, H, slice);
      if (slice == 1) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int b = 0; b < kSongs; ++b) part[(g * kSongs + b) * kUnits + lu] = acc[g][b];
      }
    }
    __syncthreads();
    if (slice == 0 && u < H) {
#pragma unroll
      for (int b = 0; b < kSongs; ++b) {
        const float i = hard_sigmoid(acc[0][b] + part[(0 * kSongs + b) * kUnits + lu]);
        const float f = hard_sigmoid(acc[1][b] + part[(1 * kSongs + b) * kUnits + lu]);
        const float g = tanhf(acc[2][b] + part[(2 * kSongs + b) * kUnits + lu]);
        const float o = hard_sigmoid(acc[3][b] + part[(3 * kSongs + b) * kUnits + lu]);
        const float cn = f * c[u * kSongs + b] + i * g;
        c[u * kSongs + b] = cn;
        h_out[u * kSongs + b] = operand<WT>(o * tanhf(cn));  // stored as the operand
      }
    }
    __syncthreads();
  }
}

template <typename WT>
__global__ void __launch_bounds__(kThreads) generate_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int D = a.D, H = a.H, L = a.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // h is double-buffered: step t reads h[t-1] while it writes h[t]
  float* xin = sm;
  float* he_cur = xin + D * kSongs;
  float* he_nxt = he_cur + H * kSongs;
  float* ce = he_nxt + H * kSongs;
  float* hd_cur = ce + H * kSongs;
  float* hd_nxt = hd_cur + H * kSongs;
  float* cd = hd_nxt + H * kSongs;
  float* zs = cd + H * kSongs;
  float* part = zs + L * kSongs;
  const int n_floats = (D + 6 * H + L) * kSongs;
  for (int i = threadIdx.x; i < n_floats; i += kThreads) sm[i] = 0.f;

  const WT* wke_x = static_cast<const WT*>(a.wke_x);
  const WT* rke = static_cast<const WT*>(a.rke);
  const WT* wz_t = static_cast<const WT*>(a.wz_t);
  const WT* wkd_x = static_cast<const WT*>(a.wkd_x);
  const WT* wkd_z = static_cast<const WT*>(a.wkd_z);
  const WT* rkd = static_cast<const WT*>(a.rkd);
  const WT* wx_t = static_cast<const WT*>(a.wx_t);
  const int s0 = blockIdx.x * kSongs;  // songs s0 .. s0+kSongs-1; rows >= B are masked
  const int nsteps = a.total - a.Tseed;
  __syncthreads();

  for (int t = 0; t < a.total; ++t) {
    // 1. x_in = seed[t] while teacher-forcing, else the fed-back frame already in xin
    if (t < a.Tseed) {
      for (int i = threadIdx.x; i < D * kSongs; i += kThreads) {
        const int b = i / D, d = i - b * D, s = s0 + b;
        xin[d * kSongs + b] = s < a.B ? a.seed[((size_t)s * a.Tseed + t) * D + d] : 0.f;
      }
      __syncthreads();
    }
    // 2. encoder cell: z_e = encb + x_in @ Wke_x + h_e @ Rke
    lstm_cell(a, a.encb, s0, xin, wke_x, D, he_cur, rke, H, nullptr, rke, 0, ce, he_nxt, part);
    // 3. z heads and the reparameterized draw, one warp per latent
    for (int l = warp; l < L; l += kWarps) {
      const float zm = warp_dot(he_nxt, wz_t + (size_t)l * H, H, lane);
      const float zv = warp_dot(he_nxt, wz_t + (size_t)(L + l) * H, H, lane);
      const int s = s0 + lane;
      if (lane < kSongs) {
        const float e = s < a.B ? a.eps[((size_t)s * a.total + t) * L + l] : 0.f;
        zs[l * kSongs + lane] = (zm + a.bz[l]) + expf((zv + a.bz[L + l]) / 2.f) * e;
      }
    }
    __syncthreads();
    // 4. decoder cell: z_d = decb + h_d @ Rkd + z @ Wkd_z (+ x_in @ Wkd_x)
    lstm_cell(a, a.decb, s0, hd_cur, rkd, H, zs, wkd_z, L, xin, wkd_x,
              a.use_x_prev ? D : 0, cd, hd_nxt, part);
    // 5. frame head, Bernoulli draw, feedback, output; one warp per pitch
    for (int d = warp; d < D; d += kWarps) {
      const float logit = warp_dot(hd_nxt, wx_t + (size_t)d * H, H, lane) + a.bx[d];
      const int s = s0 + lane;
      if (lane < kSongs) {
        const float xm = 1.f / (1.f + expf(-logit));
        const float uu = s < a.B ? a.u[((size_t)s * a.total + t) * D + d] : 1.f;
        const float xt = uu < xm ? 1.f : 0.f;
        xin[d * kSongs + lane] = xt;
        if (t >= a.Tseed && s < a.B)
          a.out[((size_t)s * nsteps + (t - a.Tseed)) * D + d] = a.return_probs ? xm : xt;
      }
    }
    __syncthreads();
    float* tmp = he_cur; he_cur = he_nxt; he_nxt = tmp;
    tmp = hd_cur; hd_cur = hd_nxt; hd_nxt = tmp;
  }
}

template <typename WT>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a.D, a.H, a.L) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      generate_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.B + kSongs - 1) / kSongs);
  generate_kernel<WT><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- the int8 kernel

static_assert(kSongs == 4, "the int8 kernel loads the tile's four code words as one int4");

struct Int8Args {
  const float* seed;           // [B, Tseed, D]
  const float* eps;            // [B, total, L]
  const float* u;              // [B, total, D]
  const int* wke_x;            // [D4, 4H]  encoder x rows, int8 codes four k to a word
  const float* ske;            // [4H]      their scales
  const int* rke;              // [H4, 4H]  encoder recurrent kernel
  const float* srke;           // [4H]      its scales / 127
  const float* encb;           // [B, 4H]   w rows . w + bias, per song
  const __nv_bfloat16* wz_t;   // [2L, H]   Z_mean | Z_log_var kernels, transposed, bf16
  const float* bz;             // [2L]
  const int* wkd_x;            // [D4, 4H]  decoder x_prev rows (unused without use_x_prev)
  const float* skd;            // [4H]
  const float* wkd_z;          // [L, 4H]   decoder z rows, f32
  const int* rkd;              // [H4, 4H]  decoder recurrent kernel
  const float* srkd;           // [4H]      its scales / 127
  const float* decb;           // [B, 4H]
  const int* wx_t;             // [D, H4]   frame head, transposed, four k to a word
  const float* swx;            // [D]       its scales / 127
  const float* bx;             // [D]
  float* out;                  // [B, total - Tseed, D]
  int B, Tseed, total, D, H, L, use_x_prev, return_probs;
};

__host__ __device__ constexpr int words(int k) { return (k + 3) / 4; }

// shared memory, in 4-byte units: the code words ([rows][kSongs] each: x,
// h_e x2, h_d x2), h_e as the z head's bf16-valued operand, c_e, c_d, z, and
// the int partial sums of two operands ([2][4][kSongs][kUnits])
__host__ __device__ constexpr size_t int8_smem_words(int D, int H, int L) {
  return (size_t)(words(D) + 4 * words(H) + 3 * H + L) * kSongs +
         (size_t)2 * 4 * kSongs * kUnits;
}

__device__ __forceinline__ float hard_sigmoid_rn(float x) {
  return fminf(fmaxf(__fadd_rn(__fmul_rn(0.2f, x), 0.5f), 0.f), 1.f);
}

// acc[g][b] += sum over this slice's half of the K4 words of dot4(a[k][b],
// w[k][u + g*H]): a is [K4][kSongs] code words in shared memory, w a
// [K4, 4H] array of code words in global memory.
__device__ __forceinline__ void mac_gates_i8(int (&acc)[4][kSongs], const int* a,
                                             const int* __restrict__ w, int K4, int u, int H,
                                             int slice) {
  const int k0 = slice ? K4 / 2 : 0, k1 = slice ? K4 : K4 / 2;
  const int* wp = w + (size_t)k0 * 4 * H + u;
#pragma unroll 8
  for (int k = k0; k < k1; ++k, wp += 4 * H) {
    const int w0 = __ldg(wp), w1 = __ldg(wp + H), w2 = __ldg(wp + 2 * H), w3 = __ldg(wp + 3 * H);
    const int4 v = *reinterpret_cast<const int4*>(a + k * kSongs);
    const int av[kSongs] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int b = 0; b < kSongs; ++b) {
      acc[0][b] = __dp4a(av[b], w0, acc[0][b]);
      acc[1][b] = __dp4a(av[b], w1, acc[1][b]);
      acc[2][b] = __dp4a(av[b], w2, acc[2][b]);
      acc[3][b] = __dp4a(av[b], w3, acc[3][b]);
    }
  }
}

// The bf16 z head of the int8 kernel: returns, in lane b < kSongs, sum_k
// a[k][b] * wrow[k] for bf16-valued a, summed in double and rounded to f32
// once. Each product of two bf16 values is exact, and the double sum rounds
// them the same in any order to within 2^-53, so the kernel's z head and the
// plain version's (a float64 product) give the same f32 z: an f32 sum in two
// orders may differ by an ulp, which h_d * 127 can turn into another code.
__device__ __forceinline__ float warp_dot_exact(const float* a,
                                                const __nv_bfloat16* __restrict__ wrow, int K,
                                                int lane) {
  double s[kSongs];
#pragma unroll
  for (int b = 0; b < kSongs; ++b) s[b] = 0.0;
  for (int k = lane; k < K; k += 32) {
    const double w = __bfloat162float(wrow[k]);
    const float4 v = *reinterpret_cast<const float4*>(a + k * kSongs);
    s[0] = fma((double)v.x, w, s[0]);
    s[1] = fma((double)v.y, w, s[1]);
    s[2] = fma((double)v.z, w, s[2]);
    s[3] = fma((double)v.w, w, s[3]);
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

// One LSTM cell of the int8 kernel for all units. Operand x: codes xa
// against wx (kx words, scales sx); operand h: codes ha against wh (kh
// words, scales sh). Each unit's K is split between the block's two slices;
// slice 1 hands its int partial sums to slice 0, which adds them (exact) and
// runs the epilogue: the encoder's z = (x.sx + bias) + h.sh, the decoder's
// z = ((bias + h.sh) + z rows, l = 0..L-1) + x.sx, in the JAX kernel's
// order. Writes c, h's codes (`hq_out`) and, for the encoder, h as the z
// head's bf16-valued operand (`hf_out`).
__device__ __forceinline__ void lstm_cell_i8(const Int8Args& a, bool decoder, const float* bias,
                                             int s0, const int* xa, const int* wx,
                                             const float* sx, int kx, const int* ha,
                                             const int* wh, const float* sh, int kh,
                                             const float* zs, float* c, int* hq_out,
                                             float* hf_out, int* part) {
  const int H = a.H;
  const int slice = threadIdx.x / kUnits, lu = threadIdx.x % kUnits;
  for (int u0 = 0; u0 < H; u0 += kUnits) {  // uniform trip count: syncs inside
    const int u = u0 + lu;
    int accx[4][kSongs], acch[4][kSongs];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int b = 0; b < kSongs; ++b) accx[g][b] = acch[g][b] = 0;
    if (u < H) {
      if (kx) mac_gates_i8(accx, xa, wx, kx, u, H, slice);
      mac_gates_i8(acch, ha, wh, kh, u, H, slice);
      if (slice == 1) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int b = 0; b < kSongs; ++b) {
            part[(g * kSongs + b) * kUnits + lu] = accx[g][b];
            part[((4 + g) * kSongs + b) * kUnits + lu] = acch[g][b];
          }
      }
    }
    __syncthreads();
    if (slice == 0 && u < H) {
#pragma unroll
      for (int b = 0; b < kSongs; ++b) {
        const int s = s0 + b;
        float zg[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int col = g * H + u;
          const float fx = __int2float_rn(accx[g][b] + part[(g * kSongs + b) * kUnits + lu]);
          const float fh =
              __int2float_rn(acch[g][b] + part[((4 + g) * kSongs + b) * kUnits + lu]);
          const float bb = s < a.B ? bias[(size_t)s * 4 * H + col] : 0.f;
          float z;
          if (!decoder) {
            z = __fadd_rn(__fadd_rn(__fmul_rn(fx, sx[col]), bb), __fmul_rn(fh, sh[col]));
          } else {
            z = __fadd_rn(bb, __fmul_rn(fh, sh[col]));
            for (int l = 0; l < a.L; ++l)
              z = __fadd_rn(z, __fmul_rn(zs[l * kSongs + b], a.wkd_z[(size_t)l * 4 * H + col]));
            if (kx) z = __fadd_rn(z, __fmul_rn(fx, sx[col]));
          }
          zg[g] = z;
        }
        const float i = hard_sigmoid_rn(zg[0]), f = hard_sigmoid_rn(zg[1]);
        const float g = tanhf(zg[2]), o = hard_sigmoid_rn(zg[3]);
        const float cn = __fadd_rn(__fmul_rn(f, c[u * kSongs + b]), __fmul_rn(i, g));
        c[u * kSongs + b] = cn;
        const float h = __fmul_rn(o, tanhf(cn));
        put_code(hq_out, u, b, __float2int_rn(__fmul_rn(h, 127.f)));
        if (hf_out) hf_out[u * kSongs + b] = operand<__nv_bfloat16>(h);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) generate_int8_kernel(const Int8Args a) {
  extern __shared__ int4 smem_i4[];
  int* sm = reinterpret_cast<int*>(smem_i4);
  const int D = a.D, H = a.H, L = a.L, D4 = words(D), H4 = words(H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the codes of h are double-buffered: step t reads h[t-1] while it writes h[t]
  int* xq = sm;                       // [D4][kSongs]
  int* heq_cur = xq + D4 * kSongs;    // [H4][kSongs]
  int* heq_nxt = heq_cur + H4 * kSongs;
  int* hdq_cur = heq_nxt + H4 * kSongs;
  int* hdq_nxt = hdq_cur + H4 * kSongs;
  float* hef = reinterpret_cast<float*>(hdq_nxt + H4 * kSongs);  // [H][kSongs]
  float* ce = hef + H * kSongs;
  float* cd = ce + H * kSongs;
  float* zs = cd + H * kSongs;        // [L][kSongs]
  int* part = reinterpret_cast<int*>(zs + L * kSongs);
  const int n_words = (D4 + 4 * H4 + 3 * H + L) * kSongs;
  for (int i = threadIdx.x; i < n_words; i += kThreads) sm[i] = 0;

  const int s0 = blockIdx.x * kSongs;  // songs s0 .. s0+kSongs-1; rows >= B are masked
  const int nsteps = a.total - a.Tseed;
  __syncthreads();

  for (int t = 0; t < a.total; ++t) {
    // 1. x_in = seed[t] while teacher-forcing (its int8 code: binary frames
    // are exact), else the fed-back frame's codes already in xq
    if (t < a.Tseed) {
      for (int i = threadIdx.x; i < D * kSongs; i += kThreads) {
        const int b = i / D, d = i - b * D, s = s0 + b;
        const float x = s < a.B ? a.seed[((size_t)s * a.Tseed + t) * D + d] : 0.f;
        put_code(xq, d, b, __float2int_rz(x));
      }
      __syncthreads();
    }
    // 2. encoder cell: z_e = (x_in.Wke_x + encb) + round(h_e * 127).Rke
    lstm_cell_i8(a, false, a.encb, s0, xq, a.wke_x, a.ske, D4, heq_cur, a.rke, a.srke, H4,
                 nullptr, ce, heq_nxt, hef, part);
    // 3. z heads (bf16, summed exactly) and the reparameterized draw, one
    // warp per latent
    for (int l = warp; l < L; l += kWarps) {
      const float zm = warp_dot_exact(hef, a.wz_t + (size_t)l * H, H, lane);
      const float zv = warp_dot_exact(hef, a.wz_t + (size_t)(L + l) * H, H, lane);
      const int s = s0 + lane;
      if (lane < kSongs) {
        const float e = s < a.B ? a.eps[((size_t)s * a.total + t) * L + l] : 0.f;
        const float scale = expf(__fadd_rn(zv, a.bz[L + l]) / 2.f);
        zs[l * kSongs + lane] = __fadd_rn(__fadd_rn(zm, a.bz[l]), __fmul_rn(scale, e));
      }
    }
    __syncthreads();
    // 4. decoder cell: z_d = ((decb + round(h_d * 127).Rkd) + z rows) (+ x_in.Wkd_x)
    lstm_cell_i8(a, true, a.decb, s0, xq, a.wkd_x, a.skd, a.use_x_prev ? D4 : 0, hdq_cur, a.rkd,
                 a.srkd, H4, zs, cd, hdq_nxt, nullptr, part);
    // 5. frame head on round(h_d * 127), Bernoulli draw, feedback, output;
    // one warp per pitch, its lanes splitting the words of k
    for (int d = warp; d < D; d += kWarps) {
      int acc[kSongs] = {0, 0, 0, 0};
      const int* wrow = a.wx_t + (size_t)d * H4;
      for (int k = lane; k < H4; k += 32) {
        const int w = __ldg(wrow + k);
        const int4 v = *reinterpret_cast<const int4*>(hdq_nxt + k * kSongs);
        acc[0] = __dp4a(v.x, w, acc[0]);
        acc[1] = __dp4a(v.y, w, acc[1]);
        acc[2] = __dp4a(v.z, w, acc[2]);
        acc[3] = __dp4a(v.w, w, acc[3]);
      }
      int mine = 0;
#pragma unroll
      for (int b = 0; b < kSongs; ++b) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
        if (lane == b) mine = acc[b];
      }
      const int s = s0 + lane;
      if (lane < kSongs) {
        const float logit = __fadd_rn(__fmul_rn(__int2float_rn(mine), a.swx[d]), a.bx[d]);
        const float xm = 1.f / (1.f + expf(-logit));
        const float uu = s < a.B ? a.u[((size_t)s * a.total + t) * D + d] : 1.f;
        const float xt = uu < xm ? 1.f : 0.f;
        put_code(xq, d, lane, xt != 0.f);
        if (t >= a.Tseed && s < a.B)
          a.out[((size_t)s * nsteps + (t - a.Tseed)) * D + d] = a.return_probs ? xm : xt;
      }
    }
    __syncthreads();
    int* tmp = heq_cur; heq_cur = heq_nxt; heq_nxt = tmp;
    tmp = hdq_cur; hdq_cur = hdq_nxt; hdq_nxt = tmp;
  }
}

int launch_int8(const Int8Args& a, cudaStream_t stream) {
  const size_t smem = int8_smem_words(a.D, a.H, a.L) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      generate_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.B + kSongs - 1) / kSongs);
  generate_int8_kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs (the wrapper checks the limit).
extern "C" long long cvl_generate_cl_vrnn_smem_bytes(int D, int H, int L) {
  return (long long)(smem_floats(D, H, L) * sizeof(float));
}

// Launches the sampler on `stream`; returns the cudaError_t of the launch.
extern "C" int cvl_generate_cl_vrnn(
    int bf16_weights, const float* seed, const float* eps, const float* u,
    const void* wke_x, const void* rke, const float* encb, const void* wz_t, const float* bz,
    const void* wkd_x, const void* wkd_z, const void* rkd, const float* decb,
    const void* wx_t, const float* bx, float* out, int B, int Tseed, int total, int D,
    int H, int L, int use_x_prev, int return_probs, void* stream) {
  const Args a{seed, eps, u, wke_x, rke, encb, wz_t, bz, wkd_x, wkd_z, rkd, decb, wx_t, bx,
               out, B, Tseed, total, D, H, L, use_x_prev, return_probs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_weights ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}

// Bytes of dynamic shared memory one block of the int8 kernel needs.
extern "C" long long cvl_generate_cl_vrnn_int8_smem_bytes(int D, int H, int L) {
  return (long long)(int8_smem_words(D, H, L) * 4);
}

// Launches the int8 sampler on `stream`; returns the cudaError_t of the launch.
extern "C" int cvl_generate_cl_vrnn_int8(
    const float* seed, const float* eps, const float* u, const int* wke_x, const float* ske,
    const int* rke, const float* srke, const float* encb, const void* wz_t, const float* bz,
    const int* wkd_x, const float* skd, const float* wkd_z, const int* rkd, const float* srkd,
    const float* decb, const int* wx_t, const float* swx, const float* bx, float* out, int B,
    int Tseed, int total, int D, int H, int L, int use_x_prev, int return_probs, void* stream) {
  const Int8Args a{seed, eps, u, wke_x, ske, rke, srke, encb,
                   static_cast<const __nv_bfloat16*>(wz_t), bz, wkd_x, skd, wkd_z, rkd, srkd,
                   decb, wx_t, swx, bx, out, B, Tseed, total, D, H, L, use_x_prev,
                   return_probs};
  return launch_int8(a, static_cast<cudaStream_t>(stream));
}
