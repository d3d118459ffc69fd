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
// jnp.round), and the sums are int32, so the accumulators equal the plain
// version's bit for bit in any order. The x rows and the recurrent rows are
// two products with their own scales. Each column is dequantized once,
// (float)acc * scale, and the f32 epilogue is written with __fmul_rn /
// __fadd_rn in the JAX kernel's order, so that nvcc contracts nothing into an
// FMA: an ulp of h moved by a contraction can land on the other side of a
// rounding tie of h * 127 and change a code by one.
//
// What bounds the int8 kernel. At the JAX band's H=1,536 (D=88, L=2,
// use_x_prev), 64 songs x (32 + 256) steps, it does 2.0e7 int8 MACs per
// song-step, 3.7e11 MACs (7.4e11 operations) for the call: ~0.37 ms at the
// card's 1,979 TOPS of int8 tensor-core products, against 20.7 MB of int8
// weights, 0.006 ms at HBM rate, so operations bound it (chip_smoke.py's
// `int8_bound_ms` prints both). But each step is a chain of dependent
// phases (encoder cell, z heads, decoder cell, frame head, each needing the
// whole of the one before), 288 steps in series.
//
// What the design does about it.
// * The columns, not the songs, are spread over the card: each block owns nu
//   hidden units of both cells, all four gate columns (i, f, c, o) of each,
//   so the gate epilogue stays in the block, and computes them for every
//   song of the call (in passes of 64 songs, 16-row tiles, any B). The grid
//   is cdiv(H, nu) blocks with nu = 2 cdiv(H, 2 SMs): 128 blocks of 12 units
//   at H=1,536, 126 of 14 at H=1,752. The card then reads the weights once a
//   step in all, not once a song tile.
// * The products run on the int8 tensor cores, `mma.sync.m16n8k32` s8 x s8
//   -> s32. The wrapper packs each block's slice of each cell contiguously,
//   chunk by chunk in the order the B fragments load it (K zero-padded to
//   whole k32 chunks); the slices stream from L2 through a 4-stage
//   `cp.async` ring of 8 chunks a stage with the codes of the operand, the
//   copies dealt to the threads at fixed strides. Each of the 16 warps takes
//   one 16-song tile and all of the block's n8 tiles, and the warps of a
//   tile split the chunks of a stage (their int32 partial sums are added in
//   shared memory): NT mma for 2 + NT fragment loads. Lane (g, t) takes
//   codes 8t .. 8t + 7 of a chunk's row in one 8-byte load, and the packing
//   pairs the same k with them (any pairing of k gives the same int32 sum).
//   On an H100, 4 chunks a stage with a division per copy, and 8 warps of
//   1-2 tiles each, spent more time in the loop's own instructions than in
//   its loads.
// * One persistent cooperative launch runs the whole song. A step is four
//   phases with a grid barrier (a counter in global memory) after each: the
//   encoder cell; the z heads (one block per latent and group of four songs,
//   its threads splitting k); the decoder cell; the frame head (jobs of 16
//   songs x 8 pitches spread over the blocks, K split over a block's warps
//   and their sums added in warp order). The codes of x and of h of both
//   cells live in global memory (h double-buffered), written once a step and
//   read through L2 (`cp.async.cg`, `__ldcg`: other blocks rewrite them every
//   step); c of each unit stays in its owning block's shared memory, with
//   the scales and the decoder's z rows of the block's columns and a pass's
//   z. A grid that cannot be co-resident fails to launch.
// * Known limits: the cell phases stream ~23 MB from L2 a step each
//   (every block reads the whole of a cell's codes, 64 songs x (D + H)
//   bytes, beside its 78 KB of weights), and on an H100 that stream, not
//   the tensor cores, sets their time: more stages in flight made it
//   slower. The barriers cost ~1-1.7 us each. Residency of the weights
//   (~206 KB a block at the top of the band, which does not fit beside the
//   ring), cluster multicast of the codes and `wgmma` are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "mma_bf16.cuh"

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

constexpr int kI8Threads = 512;              // 16 warps a block
constexpr int kI8Warps = kI8Threads / 32;
constexpr int kGroupRows = 64;               // songs of one pass of a cell's products: 4 m16 tiles
constexpr int kChunkBytes = 32;              // one k32 chunk of a row of int8 codes
constexpr int kCPS = 8;                      // k32 chunks a ring stage
constexpr int kRing = 4;                     // ring stages
constexpr int kMaxNT = 8;                    // n8 tiles a block (16 hidden units)
constexpr int kAStage = kCPS * kGroupRows * kChunkBytes;  // the codes of a stage, bytes

struct Int8Args {
  const float* seed;           // [B, Tseed, D]
  const float* eps;            // [B, total, L]
  const float* u;              // [B, total, D]
  const int* enc_w;            // [G][KCx + KCh][NT][64] words: Wke_x, then Rke (`pack_int8`)
  const int* dec_w;            // [G][KCd + KCh][NT][64]: Wkd_x (KCd = 0 without use_x_prev), Rkd
  const int* head_w;           // [NTx][KCh][64]: the frame head
  const float* ske;            // [4H]  scales of Wke_x
  const float* srke;           // [4H]  scales of Rke / 127
  const float* encb;           // [B, 4H]  w rows . w + bias, per song
  const __nv_bfloat16* wz_t;   // [2L, H]  Z_mean | Z_log_var kernels, transposed, bf16
  const float* bz;             // [2L]
  const float* skd;            // [4H]  scales of Wkd_x
  const float* wkd_z;          // [L, 4H]  decoder z rows, f32
  const float* srkd;           // [4H]  scales of Rkd / 127
  const float* decb;           // [B, 4H]
  const float* swx;            // [D]   scales of the frame head / 127
  const float* bx;             // [D]
  float* out;                  // [B, total - Tseed, D]
  // the state shared between blocks, in global memory, zeroed by the caller
  // (`int8_state` cuts it from one buffer)
  int* xq;                     // [Bp][KCx * 8] words: the step's input x, int8 codes
  int* heq;                    // [2][Bp][KCh * 8] words: h_e codes, double-buffered
  int* hdq;                    // [2][Bp][KCh * 8] words: h_d codes, double-buffered
  float* hef;                  // [Bp / 4][H][4]: h_e as the z head's bf16-valued operand
  float* zs;                   // [Bp][L]: the step's z
  unsigned* bar;               // arrivals at the grid barrier
  unsigned long long* clock;   // [kLaps] or null: block 0's ns per part of a step (PhaseClock)
  int B, Tseed, total, D, H, L, use_x_prev, return_probs;
  int nu;                      // hidden units a block owns (even, at most 2 kMaxNT)
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round16(int n) { return cdiv(n, 16) * 16; }

// dynamic shared memory of a block owning nu units, for Bp song rows and L
// latents: the ring (codes and weights of kCPS chunks a stage; after a
// pass, the staged sums, the z heads' or the frame head's warp sums), c of
// both cells ([nu][Bp] each), the block's columns of the scales and of the
// decoder's z rows ([4 + L][4 nu]), and the z of a pass's songs ([64][L])
__host__ __device__ constexpr size_t ring_bytes(int nu) {
  return (size_t)kRing * (kAStage + kCPS * (nu / 2) * 256);
}
__host__ __device__ constexpr size_t int8_smem_bytes(int nu, int Bp, int L) {
  return ring_bytes(nu) +
         ((size_t)2 * nu * Bp + (size_t)(4 + L) * 4 * nu + (size_t)kGroupRows * L) * sizeof(float);
}

// the global state, in 4-byte words, each part a multiple of 16 bytes
struct Int8State {
  size_t xq, heq, hdq, hef, zs, bar, total;
};
__host__ __device__ inline Int8State int8_state(int B, int D, int H, int L) {
  const int Bp = round16(B);
  const size_t xw = (size_t)cdiv(D, 32) * 8, hw = (size_t)cdiv(H, 32) * 8;
  Int8State st{};
  st.xq = 0;
  st.heq = st.xq + Bp * xw;
  st.hdq = st.heq + 2 * Bp * hw;
  st.hef = st.hdq + 2 * Bp * hw;
  st.zs = st.hef + (size_t)Bp * H;
  st.bar = st.zs + (size_t)cdiv(Bp * L, 4) * 4;
  st.total = st.bar + 4;
  return st;
}

__device__ __forceinline__ float hard_sigmoid_rn(float x) {
  return fminf(fmaxf(__fadd_rn(__fmul_rn(0.2f, x), 0.5f), 0.f), 1.f);
}

// d += a . b on the int8 tensor cores: a 16 x 32 (row) by 32 x 8 (col)
// product of s8 codes, summed in s32 (exact)
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Every block of the grid arrives before any leaves. `count` only grows:
// round r ends when it reaches r * gridDim.x. Thread 0 arrives with a
// release (after the block barrier, so it orders the whole block's writes
// before the arrival) and waits with acquiring loads (the block barrier
// after it orders the block's later reads after them). Full fences in place
// of the release and acquire cost ~0.1 us a barrier more on an H100.
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned& rounds) {
  __syncthreads();
  ++rounds;
  if (threadIdx.x == 0) {
    const unsigned target = rounds * gridDim.x;
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(count) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// Block 0's clock of a step's parts (`a.clock` set), summed over the steps:
// the encoder's products, its epilogue, the wait at its barrier; the z
// heads, the wait; the decoder's products, epilogue, wait; the frame head,
// the wait. lap(i) adds the ns since the last lap to sums[i]
// (`%globaltimer`); `flush` writes them out.
constexpr int kLaps = 10;
struct PhaseClock {
  unsigned long long* out;
  unsigned long long last, sums[kLaps];
  __device__ __forceinline__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ __forceinline__ void start() {
    if (!out) return;
    for (int i = 0; i < kLaps; ++i) sums[i] = 0;
    last = now();
  }
  __device__ __forceinline__ void lap(int i) {
    if (!out) return;
    const unsigned long long t = now();
    sums[i] += t - last;
    last = t;
  }
  __device__ __forceinline__ void flush() {
    if (out)
      for (int i = 0; i < kLaps; ++i) out[i] = sums[i];
  }
};

// The z head's partial sums (bf16, summed exactly): this lane's k = k0,
// k0 + stride, ... of sum_k a[k][b] * wrow[k] for the bf16-valued a of four
// songs ([K][4] in global memory) and two weight rows, in double. Each
// product of two bf16 values is exact, and the double sum rounds them the
// same in any order to within 2^-53, so the kernel's z head and the plain
// version's (a float64 product), each rounded to f32 once, give the same f32
// z: an f32 sum in two orders may differ by an ulp, which h_d * 127 can turn
// into another code.
__device__ __forceinline__ void dot_exact(double (&s)[2][4], const float* a,
                                          const __nv_bfloat16* __restrict__ w0,
                                          const __nv_bfloat16* __restrict__ w1, int K, int k0,
                                          int stride) {
  // a batch's loads are issued before its sums: left to the compiler's
  // unrolling, the loads of the loop's remainder went in series (3x the
  // time at H=1,752 on an H100)
  constexpr int kBatch = 4;
  for (int kb = k0; kb < K; kb += kBatch * stride) {
    float4 v[kBatch];
    float w[kBatch][2];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int k = kb + i * stride;
      if (k < K) {
        v[i] = __ldcg(reinterpret_cast<const float4*>(a) + k);
        w[i][0] = __bfloat162float(w0[k]);
        w[i][1] = __bfloat162float(w1[k]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (kb + i * stride >= K) break;
      const double x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[0][b] = fma(x[b], (double)w[i][0], s[0][b]);
        s[1][b] = fma(x[b], (double)w[i][1], s[1][b]);
      }
    }
  }
}

// One cell's products for song rows m0 .. m0 + 16 mt - 1 (mt <= 4 m16 tiles)
// and the block's 8 NT columns: the x codes (kcx chunks, row width xw words)
// times the x rows into acc[.][0], the h codes (kch chunks, hw words) times
// the recurrent kernel into acc[.][1]: two products with their own scales,
// never one over the joined K. `w` is the block's packed slice, chunk by
// chunk. The chunks stream through a ring of kRing stages of kCPS chunks
// (`cp.async`, L2 only: the codes are rewritten by other blocks every
// step). Warp (wm, kq) takes m-tile wm, all NT n-tiles, and the chunks q
// = kq, kq + nks, ... of each stage: the nks = ksplit(mt) warps of an
// m-tile split K, and the caller adds their partial sums (exact, in any
// order). Each warp issues NT mma per chunk for 2 + NT fragment loads.
// Lane (g, t) holds the mma fragments: rows g and g + 8, codes 8t .. 8t + 7
// of each chunk (one 8-byte load a row), which the weights' packing pairs
// with the same k. The partial sums are staged in the ring as [nks][2][16
// mt][8 NT] ints (at most 16384 NT bytes, within the ring) and added in
// place, element by element, into the first [2][16 mt][8 NT].
__host__ __device__ constexpr int ksplit(int mt) {
  return kI8Warps / mt < kCPS ? kI8Warps / mt : kCPS;
}
__device__ __forceinline__ void cell_products(const int* __restrict__ w, int kcx, int kch,
                                              const int* xq, int xw, const int* hq, int hw,
                                              int m0, int mt, int NT, unsigned char* ring) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nks = ksplit(mt), wm = warp % mt, kq = warp / mt;
  const bool active = kq < nks;
  const int nch = kcx + kch, nst = cdiv(nch, kCPS), rows = 16 * mt;
  const int sb = kAStage + kCPS * NT * 256;  // bytes a stage
  int acc[kMaxNT][2][4];
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i)
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][o][q] = 0;
  // stage s: chunks s kCPS ..; codes [kCPS][kGroupRows][32 B], weights
  // [kCPS][NT][256 B]; 16-byte pieces, 2 kGroupRows and at most 16 kMaxNT =
  // 128 a chunk, dealt to the threads at fixed strides (no division)
  static_assert(kCPS * 2 * kGroupRows % kI8Threads == 0 && 16 * kMaxNT == 2 * kGroupRows,
                "whole rounds of pieces");
  auto load = [&](int s) {
    unsigned char* A = ring + (s % kRing) * sb;
    unsigned char* Bw = A + kAStage;
#pragma unroll
    for (int e = 0; e < kCPS * 2 * kGroupRows / kI8Threads; ++e) {
      const int i = tid + e * kI8Threads, q = i / (2 * kGroupRows), r = i % (2 * kGroupRows);
      const int ch = s * kCPS + q;
      if (ch >= nch) continue;
      if (r < 2 * rows) {  // the codes: row r / 2, half r % 2
        const int row = r / 2, half = r % 2;
        const int* src = ch < kcx ? xq + (size_t)(m0 + row) * xw + ch * 8 + half * 4
                                  : hq + (size_t)(m0 + row) * hw + (ch - kcx) * 8 + half * 4;
        cvl_tc::cp_async16(A + (q * kGroupRows + row) * kChunkBytes + half * 16, src, true);
      }
      if (r < 16 * NT)  // the weights: piece r of the chunk's NT tiles
        cvl_tc::cp_async16(Bw + q * NT * 256 + r * 16, w + ((size_t)ch * NT * 64 + r * 4), true);
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
    for (int q = kq; q < kCPS; q += nks) {
      const int ch = s * kCPS + q;
      if (ch >= nch) break;
      const unsigned char* ar = A + (q * kGroupRows + wm * 16 + g) * kChunkBytes + t * 8;
      const uint2 lo = *reinterpret_cast<const uint2*>(ar);
      const uint2 hi = *reinterpret_cast<const uint2*>(ar + 8 * kChunkBytes);
      const unsigned af[4] = {lo.x, hi.x, lo.y, hi.y};
      const unsigned char* br = Bw + q * NT * 256 + lane * 8;
#pragma unroll
      for (int n = 0; n < kMaxNT; ++n) {
        if (n >= NT) break;
        const uint2 b = *reinterpret_cast<const uint2*>(br + n * 256);
        if (ch < kcx)
          mma_s8(acc[n][0], af, b.x, b.y);
        else
          mma_s8(acc[n][1], af, b.x, b.y);
      }
    }
  }
  cvl_tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial sums go in it
  // [nks][2][rows][8 NT] ints: row g (+8), columns 2t, 2t + 1 of each tile
  const int cols = 8 * NT, part = 2 * rows * cols;
  int* stg = reinterpret_cast<int*>(ring);
  if (active) {
#pragma unroll
    for (int n = 0; n < kMaxNT; ++n) {
      if (n >= NT) break;
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        int* r0 = stg + (size_t)kq * part + (o * rows + wm * 16 + g) * cols + n * 8 + 2 * t;
        r0[0] = acc[n][o][0];
        r0[1] = acc[n][o][1];
        r0[8 * cols] = acc[n][o][2];
        r0[8 * cols + 1] = acc[n][o][3];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < part; e += kI8Threads) {  // the warps' partial sums, in order
    int sum = stg[e];
    for (int k = 1; k < nks; ++k) sum += stg[(size_t)k * part + e];
    stg[e] = sum;
  }
}

// One LSTM cell of the int8 kernel for the block's units u0 .. u0 + nu - 1
// and every song, in passes of kGroupRows songs: the products
// (`cell_products`), then the epilogue of each (song, unit), its four gate
// columns side by side in the staged sums: the encoder's z = (x.sx + bias)
// + h.sh, the decoder's z = ((bias + h.sh) + z rows, l = 0..L-1) + x.sx,
// in the JAX kernel's order, written with __fmul_rn / __fadd_rn so that
// nvcc contracts nothing into an FMA; then the gates, c (in shared memory,
// [unit][song]) and h's codes (`hq_out`, bytes [song][hw * 4]) and, for the
// encoder, h as the z head's bf16-valued operand (`hef`). The scales `sx`,
// `sh` and the decoder's z rows `wz` ([L][4 nu]) are the block's columns in
// shared memory, local column 4j + g for unit u0 + j, gate g; the decoder
// stages its pass's z in `zst` ([64][L]).
__device__ __forceinline__ void lstm_cell_i8(const Int8Args& a, bool decoder, const int* w,
                                             int kcx, const float* bias, const float* sx,
                                             const float* sh, const float* wz, float* zst,
                                             const int* hq, int* hq_out, float* c,
                                             unsigned char* ring, PhaseClock* clk, int lap) {
  const int H = a.H, nu = a.nu, NT = nu / 2, Bp = round16(a.B), L = a.L;
  const int kch = cdiv(H, 32), xw = cdiv(a.D, 32) * 8, hw = kch * 8;
  const int u0 = blockIdx.x * nu;
  for (int m0 = 0; m0 < Bp; m0 += kGroupRows) {
    const int mt = min(kGroupRows, Bp - m0) / 16;
    if (decoder)  // read once a pass; the products' barriers publish it
      for (int i = threadIdx.x; i < 16 * mt * L; i += kI8Threads)
        zst[i] = m0 + i / L < a.B ? __ldcg(a.zs + (size_t)m0 * L + i) : 0.f;
    cell_products(w, kcx, kch, a.xq, xw, hq, hw, m0, mt, NT, ring);
    __syncthreads();
    if (clk) clk->lap(lap);
    const int* stg = reinterpret_cast<const int*>(ring);
    const int cols = 8 * NT, rows = 16 * mt;
    for (int i = threadIdx.x; i < 16 * mt * nu; i += kI8Threads) {
      const int r = i / nu, j = i - r * nu, s = m0 + r, u = u0 + j;
      if (s >= a.B || u >= H) continue;
      float bb[4], zg[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) bb[g] = bias[(size_t)s * 4 * H + g * H + u];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int lc = 4 * j + g;
        const float fx = __int2float_rn(stg[r * cols + lc]);
        const float fh = __int2float_rn(stg[(rows + r) * cols + lc]);
        float z;
        if (!decoder) {
          z = __fadd_rn(__fadd_rn(__fmul_rn(fx, sx[lc]), bb[g]), __fmul_rn(fh, sh[lc]));
        } else {
          z = __fadd_rn(bb[g], __fmul_rn(fh, sh[lc]));
          for (int l = 0; l < L; ++l)
            z = __fadd_rn(z, __fmul_rn(zst[r * L + l], wz[l * 4 * nu + lc]));
          if (kcx) z = __fadd_rn(z, __fmul_rn(fx, sx[lc]));
        }
        zg[g] = z;
      }
      const float ig = hard_sigmoid_rn(zg[0]), fg = hard_sigmoid_rn(zg[1]);
      const float gg = tanhf(zg[2]), og = hard_sigmoid_rn(zg[3]);
      float* cs = c + (size_t)j * Bp + s;
      const float cn = __fadd_rn(__fmul_rn(fg, *cs), __fmul_rn(ig, gg));
      *cs = cn;
      const float h = __fmul_rn(og, tanhf(cn));
      reinterpret_cast<signed char*>(hq_out)[(size_t)s * hw * 4 + u] =
          static_cast<signed char>(__float2int_rn(__fmul_rn(h, 127.f)));
      if (!decoder) a.hef[((size_t)(s / 4) * H + u) * 4 + s % 4] = operand<__nv_bfloat16>(h);
    }
    __syncthreads();  // the staged sums are read: the ring is free
    if (clk) clk->lap(lap + 1);
  }
}

// The z heads and the reparameterized draw, one block per latent and group of
// four songs, the blocks' threads splitting k: each lane sums its k in
// order, the lanes of a warp in a shuffle butterfly, the warps in order,
// all in double, rounded to f32 once; then z = (zm + bz) + exp((zv + bz') /
// 2) * eps, in the JAX kernel's order
__device__ __forceinline__ void z_heads(const Int8Args& a, int t, unsigned char* ring) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, L = a.L, H = a.H;
  const int jobs = L * cdiv(a.B, 4);
  double* red = reinterpret_cast<double*>(ring);  // [kI8Warps][2][4]
  for (int j = blockIdx.x; j < jobs; j += gridDim.x) {
    const int l = j % L, q = j / L;
    double sums[2][4] = {{0.0, 0.0, 0.0, 0.0}, {0.0, 0.0, 0.0, 0.0}};
    dot_exact(sums, a.hef + (size_t)q * H * 4, a.wz_t + (size_t)l * H,
              a.wz_t + (size_t)(L + l) * H, H, threadIdx.x, kI8Threads);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sums[h][b] += __shfl_xor_sync(0xffffffffu, sums[h][b], off);
        if (lane == 0) red[(warp * 2 + h) * 4 + b] = sums[h][b];
      }
    __syncthreads();
    const int b = threadIdx.x, s = 4 * q + b;
    if (b < 4 && s < a.B) {
      double zm = 0.0, zv = 0.0;
      for (int w = 0; w < kI8Warps; ++w) {
        zm += red[(w * 2) * 4 + b];
        zv += red[(w * 2 + 1) * 4 + b];
      }
      const float e = a.eps[((size_t)s * a.total + t) * L + l];
      const float scale = expf(__fadd_rn(__double2float_rn(zv), a.bz[L + l]) / 2.f);
      a.zs[(size_t)s * L + l] =
          __fadd_rn(__fadd_rn(__double2float_rn(zm), a.bz[l]), __fmul_rn(scale, e));
    }
    __syncthreads();  // `red` is read
  }
}

// The frame head on round(h_d * 127) (`hq`), the Bernoulli draw, the output,
// and the next step's input codes (the seed's while teacher-forcing, else the
// drawn frame): jobs of 16 songs x 8 pitches spread over the blocks, each
// block's warps splitting the k32 chunks, their sums added in warp order.
__device__ __forceinline__ void frame_head(const Int8Args& a, const int* hq, int t,
                                           unsigned char* ring) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int D = a.D, kch = cdiv(a.H, 32), hw = kch * 8, xw = cdiv(D, 32) * 8;
  const int ntx = cdiv(D, 8), jobs = (round16(a.B) / 16) * ntx, nsteps = a.total - a.Tseed;
  int* red = reinterpret_cast<int*>(ring);  // [kI8Warps][32][4]
  for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
    const int mi = job / ntx, ni = job - mi * ntx;
    // warp q < 4 draws fragment entry q of each lane (row g + 8 (q / 2),
    // column 2 tq + q % 2): its u and the next seed frame are loaded first,
    // under the products
    const int q = warp, s = 16 * mi + g + 8 * (q / 2), d = 8 * ni + 2 * tq + q % 2;
    const bool mine = q < 4 && s < a.B && d < D;
    float uu = 0.f;
    int seed_code = 0;
    if (mine) {
      uu = a.u[((size_t)s * a.total + t) * D + d];
      if (t + 1 < a.Tseed)
        seed_code = __float2int_rz(a.seed[((size_t)s * a.Tseed + t + 1) * D + d]);
    }
    int acc[4] = {0, 0, 0, 0};
    const int* rows = hq + (size_t)(16 * mi + g) * hw + 2 * tq;
    const int* wp = a.head_w + (size_t)ni * kch * 64 + 2 * lane;
#pragma unroll 2
    for (int kc = warp; kc < kch; kc += kI8Warps) {
      const uint2 lo = __ldcg(reinterpret_cast<const uint2*>(rows + kc * 8));
      const uint2 hi = __ldcg(reinterpret_cast<const uint2*>(rows + 8 * hw + kc * 8));
      const uint2 b = __ldg(reinterpret_cast<const uint2*>(wp + (size_t)kc * 64));
      const unsigned af[4] = {lo.x, hi.x, lo.y, hi.y};
      mma_s8(acc, af, b.x, b.y);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(warp * 32 + lane) * 4 + e] = acc[e];
    __syncthreads();
    if (mine) {
      int sum = 0;
      for (int w = 0; w < kI8Warps; ++w) sum += red[(w * 32 + lane) * 4 + q];
      const float logit = __fadd_rn(__fmul_rn(__int2float_rn(sum), a.swx[d]), a.bx[d]);
      const float xm = 1.f / (1.f + expf(-logit));
      const float xt = uu < xm ? 1.f : 0.f;
      const int code = t + 1 < a.Tseed ? seed_code : (xt != 0.f);
      reinterpret_cast<signed char*>(a.xq)[(size_t)s * xw * 4 + d] =
          static_cast<signed char>(code);
      if (t >= a.Tseed)
        a.out[((size_t)s * nsteps + (t - a.Tseed)) * D + d] = a.return_probs ? xm : xt;
    }
    __syncthreads();  // `red` is read
  }
}

// One persistent cooperative launch for the whole song: every block owns nu
// hidden units of both cells (all four gate columns of each) for every song;
// a step is four phases with a grid barrier after each.
__global__ void __launch_bounds__(kI8Threads, 1) generate_int8_kernel(const Int8Args a) {
  extern __shared__ int4 smem_i4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem_i4);
  const int D = a.D, H = a.H, nu = a.nu, Bp = round16(a.B);
  const int kcx = cdiv(D, 32), kch = cdiv(H, 32), hw = kch * 8, xw = kcx * 8;
  float* ce = reinterpret_cast<float*>(ring + ring_bytes(nu));  // [nu][Bp] each
  float* cd = ce + (size_t)nu * Bp;
  float* sxe = cd + (size_t)nu * Bp;  // the block's columns: [4 nu] each
  float* she = sxe + 4 * nu;
  float* sxd = she + 4 * nu;
  float* shd = sxd + 4 * nu;
  float* wzd = shd + 4 * nu;          // [L][4 nu]
  float* zst = wzd + a.L * 4 * nu;    // [64][L]
  for (int i = threadIdx.x; i < 2 * nu * Bp; i += kI8Threads) ce[i] = 0.f;
  for (int i = threadIdx.x; i < 4 * nu; i += kI8Threads) {
    const int u = blockIdx.x * nu + i / 4, col = (i % 4) * H + u;
    const bool in = u < H;
    sxe[i] = in ? a.ske[col] : 0.f;
    she[i] = in ? a.srke[col] : 0.f;
    sxd[i] = in && a.use_x_prev ? a.skd[col] : 0.f;
    shd[i] = in ? a.srkd[col] : 0.f;
    for (int l = 0; l < a.L; ++l) wzd[l * 4 * nu + i] = in ? a.wkd_z[(size_t)l * 4 * H + col] : 0.f;
  }
  // the first input: the seed's first frame (binary frames are exact codes)
  for (int i = blockIdx.x * kI8Threads + threadIdx.x; i < a.B * D; i += gridDim.x * kI8Threads) {
    const int s = i / D, d = i - s * D;
    reinterpret_cast<signed char*>(a.xq)[(size_t)s * xw * 4 + d] =
        static_cast<signed char>(__float2int_rz(a.seed[(size_t)s * a.Tseed * D + d]));
  }
  unsigned rounds = 0;
  grid_sync(a.bar, rounds);
  __shared__ PhaseClock clk;  // thread 0 of block 0 keeps it
  const bool timer = threadIdx.x == 0;
  if (timer) {
    clk.out = blockIdx.x == 0 ? a.clock : nullptr;
    clk.start();
  }
  const size_t hbuf = (size_t)Bp * hw;
  const int* enc_w = a.enc_w + (size_t)blockIdx.x * (kcx + kch) * (nu / 2) * 64;
  const int kcd = a.use_x_prev ? kcx : 0;
  const int* dec_w = a.dec_w + (size_t)blockIdx.x * (kcd + kch) * (nu / 2) * 64;
  for (int t = 0; t < a.total; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    // 1. encoder cell: z_e = (x_in.Wke_x + encb) + round(h_e * 127).Rke
    lstm_cell_i8(a, false, enc_w, kcx, a.encb, sxe, she, nullptr, nullptr, a.heq + cur * hbuf,
                 a.heq + nxt * hbuf, ce, ring, timer ? &clk : nullptr, 0);
    grid_sync(a.bar, rounds);
    if (timer) clk.lap(2);
    // 2. z heads (bf16, summed exactly) and the reparameterized draw
    z_heads(a, t, ring);
    if (timer) clk.lap(3);
    grid_sync(a.bar, rounds);
    if (timer) clk.lap(4);
    // 3. decoder cell: z_d = ((decb + round(h_d * 127).Rkd) + z rows) (+ x_in.Wkd_x)
    lstm_cell_i8(a, true, dec_w, kcd, a.decb, sxd, shd, wzd, zst, a.hdq + cur * hbuf,
                 a.hdq + nxt * hbuf, cd, ring, timer ? &clk : nullptr, 5);
    grid_sync(a.bar, rounds);
    if (timer) clk.lap(7);
    // 4. frame head on round(h_d * 127), the draw, the output, the next input
    frame_head(a, a.hdq + nxt * hbuf, t, ring);
    if (timer) clk.lap(8);
    grid_sync(a.bar, rounds);
    if (timer) clk.lap(9);
  }
  if (timer) clk.flush();
}

int launch_int8(const Int8Args& a, cudaStream_t stream) {
  const size_t smem = int8_smem_bytes(a.nu, round16(a.B), a.L);
  cudaError_t err = cudaFuncSetAttribute(
      generate_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // cooperative: every block co-resident (the grid barrier needs it), or the
  // launch fails
  void* args[] = {const_cast<Int8Args*>(&a)};
  err = cudaLaunchCooperativeKernel((const void*)generate_int8_kernel, dim3(cdiv(a.H, a.nu)),
                                    dim3(kI8Threads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
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

// Bytes of dynamic shared memory one block of the int8 kernel needs: a block
// owning nu hidden units (the wrapper checks the limit), for B songs and L
// latents.
extern "C" long long cvl_generate_cl_vrnn_int8_smem_bytes(int nu, int B, int L) {
  return (long long)int8_smem_bytes(nu, round16(B), L);
}

// 4-byte words of the state the int8 kernel's blocks share in global memory
// (the caller zeroes them).
extern "C" long long cvl_generate_cl_vrnn_int8_state_words(int B, int D, int H, int L) {
  return (long long)int8_state(B, D, H, L).total;
}

// Launches the int8 sampler on `stream`: one cooperative launch of
// cdiv(H, nu) blocks, each owning nu hidden units; `state` holds
// cvl_generate_cl_vrnn_int8_state_words zeroed words; `clock` (kLaps
// counts, or null) receives block 0's ns per part of a step summed over the
// steps (PhaseClock). Returns the cudaError_t of the launch
// (cudaErrorCooperativeLaunchTooLarge where the grid cannot be co-resident).
extern "C" int cvl_generate_cl_vrnn_int8(
    const float* seed, const float* eps, const float* u, const int* enc_w, const int* dec_w,
    const int* head_w, const float* ske, const float* srke, const float* encb, const void* wz_t,
    const float* bz, const float* skd, const float* wkd_z, const float* srkd, const float* decb,
    const float* swx, const float* bx, float* out, int* state, unsigned long long* clock, int B,
    int Tseed, int total, int D, int H, int L, int use_x_prev, int return_probs, int nu,
    void* stream) {
  const Int8State st = int8_state(B, D, H, L);
  const Int8Args a{seed, eps, u, enc_w, dec_w, head_w, ske, srke, encb,
                   static_cast<const __nv_bfloat16*>(wz_t), bz, skd, wkd_z, srkd, decb, swx, bx,
                   out, state + st.xq, state + st.heq, state + st.hdq,
                   reinterpret_cast<float*>(state + st.hef), reinterpret_cast<float*>(state + st.zs),
                   reinterpret_cast<unsigned*>(state + st.bar), clock, B, Tseed, total, D, H, L,
                   use_x_prev, return_probs, nu};
  return launch_int8(a, static_cast<cudaStream_t>(stream));
}
