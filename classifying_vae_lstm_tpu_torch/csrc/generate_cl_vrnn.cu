// Whole-generation cl_vrnn sampler for Hopper (sm_90a): f32 or bf16 weights
// (`generate_kernel<WT, kGroups>`), or int8 weights (`generate_int8_kernel`). Both
// are one persistent cooperative launch whose blocks own hidden units.
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_generate.py:153 `_make_kernel`
// (the f32/bf16 body of `generate_cl_vrnn_batch_pallas`). One launch runs the
// whole autoregressive song: encoder LSTM cell, z heads, z = m + exp(v/2)*eps,
// decoder LSTM cell (z as L rank-1 terms), sigmoid frame head, the Bernoulli
// draw x_t = (u < p), and x_t fed back as the next input. The per-song folds of
// the w rows and biases (encb, decb) are computed by the caller.
//
// What bounds it on this card. At the largest serving bucket of jsball_vrnn4
// (64 songs, 32 seed + 256 free steps, H=256, D=88, L=8) the call is ~27
// GFLOP of f32 FMAs and ~17 MB of streams and weights, so operations bound
// it (~0.41 ms at 67 TFLOP/s without tensor cores); in bf16 at H=1,536 ~0.4
// TFLOP, ~0.4 ms at the tensor cores' rate. But every step depends on the
// one before, and a step is four all-to-all dependencies (encoder, z heads,
// decoder, frame head): 288 steps of four phases in series.
//
// What the design does about it (the int8 kernel below is the model):
// * The columns, not the songs, are spread over the card: each block owns
//   nu hidden units of both cells, all four gate columns of each, so the
//   gate epilogue stays in the block, and computes them for every song of
//   the call (passes of 64 songs, any B). cdiv(H, nu) blocks with nu = 2
//   cdiv(H, 2 SMs): 128 blocks of 2 units at H=256, of 12 at H=1,536. The
//   first design gave each block 4 songs and every weight from L2 each step
//   (16 SMs of 132 busy at 64 songs, one SM for one song). Past 20 units a
//   block (H > 2,640 on 132 SMs) a block owns nv > 1 groups of nu <= 20
//   units, each group a slice of its own, and runs a cell phase group after
//   group (the kGroups instance; one group a block keeps its own instance,
//   whose code is the one-group kernel's); its c of both cells is nv groups
//   of [nu][songs] in shared memory, so a launch takes the songs that fit
//   beside the ring (the wrapper's `launch_songs`), a call more in several
//   launches.
// * Weight residency: the wrapper packs each block's slice of each cell
//   ([x rows | recurrent rows] x its 4 nu columns) contiguously; where both
//   slices fit in shared memory beside the state (f32 at H=256, 23 KB; bf16
//   up to H=1,024, 143 KB) the block copies them in once per call, else it
//   reads them from L2 every step (the bf16 slices at H=1,536, 312 KB; the
//   whole weights at H=2,048, 70 MB, are more than the 50 MB L2).
// * bf16 products on the tensor cores, `mma.sync.m16n8k16` bf16 -> f32: the
//   16 warps take a pass's 16-song tiles and split its k16 chunks, their
//   sums added in warp order; the slices are packed in the order of the B
//   fragments, lane (g, t) reading k = 4t .. 4t + 3 of a chunk in one 8-byte
//   load of h or x, and the packing pairing the same k. f32 products on
//   FFMA: an item of 4 songs x 1 unit (16 sums) with its K split over up to
//   32 neighbouring lanes, added by a shuffle butterfly.
// * A step is four phases with a grid barrier (a counter in global memory,
//   shared with the int8 kernel) after each: the encoder cell; the z heads
//   (one block per latent and group of four songs, its threads splitting
//   k); the decoder cell; the frame head (jobs of 16 songs x 8 pitches, the
//   warps splitting K, bf16 on the tensor cores). x and h of both cells
//   (double-buffered) live in global memory and are read through L2; c of
//   each unit stays in its owning block's shared memory, beside the block's
//   columns of the decoder's z rows and a pass's z. A grid that cannot be
//   co-resident fails to launch.
// * Every sum in a fixed order, no atomics: two calls give the same bits.
// Known limits: every block reads all of a pass's A rows (x and h of every
// song) from L2 in each cell phase, and each of a step's four phases pays an
// L2 round trip or more before its barrier, so a step costs tens of µs on
// an H100 at any number of songs; cluster multicast of A, fewer phases a
// step and `wgmma` are the levers.
//
// Numerics follow the TPU kernel: hard sigmoid clip(0.2x+0.5, 0, 1) for i, f,
// o; tanhf for g and c; expf for the z scale and the logistic head; no fast
// math. In bf16 mode the weights are bf16 and the matmul operands x and h are
// rounded to bf16 (h is stored rounded, as it is only ever read as an
// operand), the z heads and the frame head take that h, z stays f32 and
// enters the decoder as L rank-1 f32 terms against the bf16 z rows widened
// to f32 (never on the tensor cores), and every sum is f32. f32 mode runs on
// FFMA only.
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

#include "coop.cuh"
#include "mma_bf16.cuh"

namespace {

using cvl_coop::grid_sync;
using cvl_coop::mma_s8;
constexpr int kLaps = 10;
using PhaseClock = cvl_coop::PhaseClock<kLaps>;

// the value a product's operand takes in the weight type's mode
template <typename WT>
__device__ __forceinline__ float operand(float x);
template <>
__device__ __forceinline__ float operand<float>(float x) { return x; }
template <>
__device__ __forceinline__ float operand<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// Block 0's clock (`PhaseClock`, csrc/coop.cuh) of a step's kLaps parts:
// the encoder's products, its epilogue, the wait at its barrier; the z
// heads, the wait; the decoder's products, epilogue, wait; the frame head,
// the wait.

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

// ------------------------------------------------------------- the f32 / bf16 kernel

constexpr int kGThreads = 512;               // 16 warps a block
constexpr int kGWarps = kGThreads / 32;
constexpr int kGPass = 64;                   // songs of one pass of a cell's products
constexpr int kGMaxNT = 10;                  // n8 tiles a block (20 hidden units)
constexpr int kGCPS = 8;                     // chunks a ring stage: 32 bytes of a row each
constexpr int kGRing = 4;                    // ring stages
constexpr int kGAStage = kGCPS * kGPass * 32;  // A bytes a stage

using bf16 = __nv_bfloat16;

template <typename WT>
struct GenArgs {
  const float* seed;   // [B, Tseed, D]
  const float* eps;    // [B, total, L]
  const float* u;      // [B, total, D]
  const WT* enc_w;     // [G] slices of [Kx + Kh rows] x [4 nu]: Wke_x, then Rke (`pack_slices`)
  const WT* dec_w;     // [G] of [Kxd + Kh] x [4 nu]: Wkd_x (Kxd = 0 without use_x_prev), Rkd
  const WT* head_w;    // bf16: [NTx][Kh / 16][32][4] fragments; f32: [8 NTx][Kh] (`pack_head`)
  const float* encb;   // [B, 4H]  w rows . w + bias, per song
  const WT* wz_t;      // [2L, H]  Z_mean | Z_log_var kernels, transposed
  const float* bz;     // [2L]
  const float* wkd_z;  // [L, 4H]  decoder z rows, f32 (bf16-valued in the bf16 mode)
  const float* decb;   // [B, 4H]
  const float* bx;     // [D]
  float* out;          // [B, total - Tseed, D]
  // the state shared between blocks, in global memory, zeroed by the caller
  WT* x;               // [Bp][Kx]  the step's input
  WT* he;              // [2][Bp][Kh]  h_e as an operand, double-buffered
  WT* hd;              // [2][Bp][Kh]  h_d as an operand, double-buffered
  float* zs;           // [Bp][L]  the step's z
  unsigned* bar;       // arrivals at the grid barrier
  unsigned long long* clock;  // [kLaps] or null: block 0's ns per part of a step (PhaseClock)
  int B, Tseed, total, D, H, L, use_x_prev, return_probs;
  int nu;              // hidden units of a unit group (even, at most 2 kGMaxNT)
  int nv;              // unit groups a block owns: groups blockIdx.x nv .. + nv - 1
  int resident;        // the block's weight slices are copied into shared memory (nv == 1)
};

// Rows of a cell's slice: x rows padded to Kx = round16(D) (none for the
// decoder without use_x_prev), then the recurrent rows padded to Kh =
// round16(H), times the block's 4 nu columns (local column 4j + g: unit u0
// + j, gate g); bf16 in the order of the B fragments, f32 column-major
// ([4 nu][K], `pack_slices`)
__host__ __device__ inline size_t slice_elems(int D, int H, int nu, bool x_rows) {
  return (size_t)((x_rows ? round16(D) : 0) + round16(H)) * 4 * nu;
}
__host__ __device__ inline size_t slices_bytes(int D, int H, int nu, int use_x_prev, int wbytes) {
  const size_t n = slice_elems(D, H, nu, true) + slice_elems(D, H, nu, use_x_prev != 0);
  return (n * wbytes + 15) / 16 * 16;
}

// The cp.async ring of the cell products: kGRing stages of kGCPS chunks of
// the pass's A rows (x, then h; a chunk is 32 bytes of a row: 16 bf16 k or
// 8 f32 k) and, where the slices stream, of the slice (NT x 256 bytes a
// chunk). After a pass it holds the warps' partial sums ([16 warps][16
// rows][8 NT] f32), and in the z-head and frame-head phases their warp sums.
__host__ __device__ inline size_t gen_ring_bytes(int nu, bool resident) {
  const size_t ring = (size_t)kGRing * (kGAStage + (resident ? 0 : kGCPS * (nu / 2) * 256));
  const size_t partial = (size_t)8192 * (nu / 2);
  return ring > partial ? ring : partial;
}

// dynamic shared memory of a block owning nv groups of nu units: the
// resident slices (or none), the ring, c of both cells ([nv][nu][Bp] each),
// the groups' columns of the decoder's z rows ([nv][L][4 nu]) and a pass's
// z ([64][L])
__host__ __device__ inline size_t gen_smem_bytes(int nu, int Bp, int L, size_t resident,
                                                 int nv) {
  return resident + gen_ring_bytes(nu, resident > 0) +
         ((size_t)2 * nv * nu * Bp + (size_t)4 * nv * nu * L + (size_t)kGPass * L) * 4;
}

__device__ __forceinline__ float hard_sigmoid_g(float x) {
  return fminf(fmaxf(0.2f * x + 0.5f, 0.f), 1.f);
}
__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// The bias of (song s, unit j of the block's unit group v of nv), its four
// gate columns of the per-song fold [B, 4H] (loaded ahead of the products,
// whose time covers the load). The unit is computed here from blockIdx.x,
// as in every epilogue: with one group a block (v = 0, nv = 1, constants)
// the code is the one-group kernel's.
__device__ __forceinline__ void load_bias(const float* bias, int s, int j, int B, int H, int nu,
                                          int v, int nv, float (&bb)[4]) {
  const int u = (blockIdx.x * nv + v) * nu + j;
#pragma unroll
  for (int g = 0; g < 4; ++g)
    bb[g] = s < B && u < H ? __ldg(bias + (size_t)s * 4 * H + g * H + u) : 0.f;
}

// The epilogue of one (song s, unit j of group v of nv), its four gate
// sums and bias given: z = bias + sums (+ the decoder's z rows, L rank-1 f32 terms on the
// pass's z), the Keras-2.0 gates, c in shared memory ([unit][song]) and h,
// as the products' operand, into `hout` [Bp][Kh]
template <typename WT>
__device__ __forceinline__ void cell_epilogue(const GenArgs<WT>& a, bool decoder, int s, int r,
                                              int j, int v, int nv, const float (&sum)[4],
                                              const float (&bb)[4], float* c, const float* wzd,
                                              const float* zst, WT* hout) {
  const int H = a.H, u = (blockIdx.x * nv + v) * a.nu + j, L = a.L;
  if (s >= a.B || u >= H) return;
  float z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) z[g] = bb[g] + sum[g];
  if (decoder)
    for (int l = 0; l < L; ++l) {
      const float zl = zst[r * L + l];
#pragma unroll
      for (int g = 0; g < 4; ++g) z[g] = fmaf(zl, wzd[l * 4 * a.nu + 4 * j + g], z[g]);
    }
  const float ig = hard_sigmoid_g(z[0]), fg = hard_sigmoid_g(z[1]);
  const float gg = tanhf(z[2]), og = hard_sigmoid_g(z[3]);
  float* cs = c + (size_t)j * round16(a.B) + s;
  const float cn = fg * *cs + ig * gg;
  *cs = cn;
  stf(hout + (size_t)s * round16(H) + u, operand<WT>(og * tanhf(cn)));
}

// Stage s of the ring: the pass's A chunks s kGCPS .. (rows m0 .. m0 +
// rows - 1; x chunks first, then h), two 16-byte pieces a row, and, where
// the slices stream, the slice's chunks, dealt to the threads at fixed
// strides. Layouts, each read without bank conflicts: bf16 A [chunk][row]
// (a fragment load reads 8 rows' 32 bytes) and the slice's chunks as they
// lie in global memory, [chunk][NT][32 lanes][8 bytes]; f32 A [row][chunk]
// (a lane's 4-k group follows its neighbour's) and the slice [4 nu columns]
// [64 k] from its column-major global layout [4 nu][K].
template <typename WT>
__device__ __forceinline__ void ring_load(unsigned char* stage, const unsigned char* w,
                                          bool streamed, const unsigned char* x, int xrow,
                                          const unsigned char* h, int hrow, int kcx, int nch,
                                          int m0, int rows, int NT, int K, int s) {
  constexpr bool kF32 = sizeof(WT) == 4;
  static_assert(kGCPS * 2 * kGPass % kGThreads == 0, "whole rounds of A pieces");
#pragma unroll
  for (int e = 0; e < kGCPS * 2 * kGPass / kGThreads; ++e) {
    const int i = threadIdx.x + e * kGThreads, q = i / (2 * kGPass), r = i % (2 * kGPass);
    const int ch = s * kGCPS + q, row = r / 2, half = r % 2;
    if (ch >= nch || row >= rows) continue;
    const unsigned char* src =
        ch < kcx ? x + (size_t)(m0 + row) * xrow + ch * 32 + half * 16
                 : h + (size_t)(m0 + row) * hrow + (ch - kcx) * 32 + half * 16;
    const int at = kF32 ? (row * kGCPS + q) * 32 : (q * kGPass + row) * 32;
    cvl_tc::cp_async16(stage + at + half * 16, src, true);
  }
  if (!streamed) return;
  unsigned char* Bw = stage + kGAStage;
  if (kF32) {  // 8 NT columns x 16 pieces of 4 k
    for (int i = threadIdx.x; i < 8 * NT * 16; i += kGThreads) {
      const int c = i / 16, k = s * kGCPS * 8 + (i % 16) * 4;
      if (k < K) cvl_tc::cp_async16(Bw + i * 16, w + ((size_t)c * K + k) * 4, true);
    }
    return;
  }
  const int pieces = 16 * NT;  // a chunk's slice: NT x 256 bytes
  const unsigned char* src = w + (size_t)s * kGCPS * pieces * 16;
  for (int i = threadIdx.x; i < kGCPS * pieces; i += kGThreads)
    if (s * kGCPS + i / pieces < nch) cvl_tc::cp_async16(Bw + i * 16, src + (size_t)i * 16, true);
}

// A cell's products for song rows m0 .. m0 + rows - 1 (a pass) and the
// block's 8 NT columns: [x | h] times the slice, its chunks streamed through
// the ring with the A chunks (`w` in global memory) or read from the
// resident copy (`w` in shared memory). A chunk is 32 bytes of each row.
// bf16, on the tensor cores (`mma.sync.m16n8k16` bf16 -> f32): warp (wm,
// kq) takes m-tile wm, all NT n-tiles and the chunks kq, kq + nks, ... of
// each stage; lane (g, t) loads k = 4t .. 4t + 3 of rows g and g + 8 (8
// bytes each) as its A fragments, and the slice pairs the same k in its B
// fragments (`pack_slices`: any pairing of k gives the same products); the
// nks warps of an m-tile stage their sums [nks][rows][8 NT] in the ring for
// the epilogue to add in warp order. f32, on FFMA: an item is four songs x
// one unit (16 sums), its 4-k groups (two a chunk) dealt to S neighbouring
// lanes, which a shuffle butterfly adds; `acc` holds a lane's 16 sums.
template <typename WT>
__device__ __forceinline__ void gen_products(const WT* w, bool streamed, int kcx, int kch,
                                             const WT* x, int Kx, const WT* h, int Kh, int m0,
                                             int rows, int NT, int nu, int S,
                                             unsigned char* ring, float (&acc)[kGMaxNT][4]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nch = kcx + kch, nst = cdiv(nch, kGCPS), K = nch * 32 / (int)sizeof(WT);
  const int sb = kGAStage + (streamed ? kGCPS * NT * 256 : 0);
  const auto* wb = reinterpret_cast<const unsigned char*>(w);
  const auto* xb = reinterpret_cast<const unsigned char*>(x);
  const auto* hb = reinterpret_cast<const unsigned char*>(h);
  const int xrow = Kx * (int)sizeof(WT), hrow = Kh * (int)sizeof(WT);
#pragma unroll
  for (int n = 0; n < kGMaxNT; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;
  // bf16: warp (wm, kq); f32: item (quad qi, unit j) and lane ks
  const int mt = rows / 16, nks = kGWarps / mt, wm = warp % mt, kq = warp / mt;
  const int item = tid / S, ks = tid % S, qi = item / nu, j = item - qi * nu;
  const bool active = sizeof(WT) == 2 ? kq < nks : item < rows / 4 * nu;
#pragma unroll
  for (int s = 0; s < kGRing - 1; ++s) {
    if (s < nst)
      ring_load<WT>(ring + s * sb, wb, streamed, xb, xrow, hb, hrow, kcx, nch, m0, rows, NT, K, s);
    cvl_tc::cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cvl_tc::cp_async_wait<kGRing - 2>();
    __syncthreads();
    if (s + kGRing - 1 < nst)
      ring_load<WT>(ring + ((s + kGRing - 1) % kGRing) * sb, wb, streamed, xb, xrow, hb, hrow,
                    kcx, nch, m0, rows, NT, K, s + kGRing - 1);
    cvl_tc::cp_async_commit();
    if (!active) continue;
    const unsigned char* A = ring + (s % kGRing) * sb;
    const unsigned char* Bw = A + kGAStage;
    if constexpr (sizeof(WT) == 2) {
      for (int q = kq; q < kGCPS; q += nks) {
        const int ch = s * kGCPS + q;
        if (ch >= nch) break;
        const unsigned char* ar = A + (q * kGPass + wm * 16 + g) * 32 + t * 8;
        const uint2 lo = *reinterpret_cast<const uint2*>(ar);
        const uint2 hi = *reinterpret_cast<const uint2*>(ar + 8 * 32);
        const unsigned af[4] = {lo.x, hi.x, lo.y, hi.y};
        const unsigned char* br =
            (streamed ? Bw + q * NT * 256 : wb + (size_t)ch * NT * 256) + lane * 8;
#pragma unroll
        for (int n = 0; n < kGMaxNT; ++n) {
          if (n >= NT) break;
          const uint2 b = *reinterpret_cast<const uint2*>(br + n * 256);
          cvl_tc::mma_bf16(acc[n], af, b.x, b.y);
        }
      }
    } else {
      // A [row][64 k] of the stage; the slice column-major: resident [4 nu][K],
      // streamed [4 nu][64 k]; a lane's 4-k group g4 of each
      const float* Af = reinterpret_cast<const float*>(A);
      const float* Wf = streamed ? reinterpret_cast<const float*>(Bw)
                                 : reinterpret_cast<const float*>(wb) + s * kGCPS * 8;
      const int wld = streamed ? kGCPS * 8 : K;
      for (int g4 = ks; g4 < 2 * kGCPS; g4 += S) {
        if (s * kGCPS + g4 / 2 >= nch) break;
        float4 av[4], wv[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          av[b] = *reinterpret_cast<const float4*>(Af + (4 * qi + b) * kGCPS * 8 + 4 * g4);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          wv[g] = *reinterpret_cast<const float4*>(Wf + (size_t)(4 * j + g) * wld + 4 * g4);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float x4[4] = {av[b].x, av[b].y, av[b].z, av[b].w};
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float w4[4] = {wv[g].x, wv[g].y, wv[g].z, wv[g].w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) acc[b][g] = fmaf(x4[kk], w4[kk], acc[b][g]);
          }
        }
      }
    }
  }
  cvl_tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free
}

// One LSTM cell for the units of the block's unit group v of nv and every
// song, in passes of kGPass songs: the products (`gen_products`), then the
// epilogue of each (song, unit): bf16, one thread per (song, unit) adds the
// warps' partial sums in order; f32, after the butterfly, lane b % S of
// each item song b's. A operands (x, h) come from L2 through the ring
// (`cp.async.cg`: other blocks rewrite them every step); the slice from
// shared memory where resident, else through the ring.
template <typename WT>
__device__ __forceinline__ void gen_cell(const GenArgs<WT>& a, bool decoder, int v, int nv,
                                         const WT* w, const float* bias, const WT* hcur,
                                         WT* hnxt, float* c, unsigned char* ring, const float* wzd,
                                         float* zst, PhaseClock* clk, int lap) {
  const int nu = a.nu, NT = nu / 2, Bp = round16(a.B), L = a.L;
  const int Kx = round16(a.D), Kh = round16(a.H), kx = (decoder && !a.use_x_prev) ? 0 : Kx;
  const int kcx = kx * (int)sizeof(WT) / 32, kch = Kh * (int)sizeof(WT) / 32;
  const bool streamed = !a.resident;
  for (int m0 = 0; m0 < Bp; m0 += kGPass) {
    const int rows = min(kGPass, Bp - m0), items = rows / 4 * nu;
    if (decoder)  // the pass's z, read once; the ring's barriers publish it
      for (int i = threadIdx.x; i < rows * L; i += kGThreads)
        zst[i] = m0 + i / L < a.B ? __ldcg(a.zs + (size_t)m0 * L + i) : 0.f;
    int S = 1;  // f32: lanes an item's K is dealt to
    while (S < 16 && 2 * S * items <= kGThreads) S *= 2;
    float acc[kGMaxNT][4];
    if constexpr (sizeof(WT) == 2) {
      // a thread's (song, unit) items of the epilogue: their biases first
      constexpr int kItems = (kGPass * 2 * kGMaxNT + kGThreads - 1) / kGThreads;
      float bb[kItems][4];
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        const int i = threadIdx.x + q * kGThreads, r = i / nu;
        load_bias(bias, i < rows * nu ? m0 + r : a.B, i - r * nu, a.B, a.H, nu, v, nv, bb[q]);
      }
      gen_products(w, streamed, kcx, kch, a.x, Kx, hcur, Kh, m0, rows, NT, nu, S, ring, acc);
      // the warps' partial sums [nks][rows][8 NT] into the ring: row g (+8),
      // columns 2t, 2t + 1 of each n-tile
      const int mt = rows / 16, nks = kGWarps / mt, cols = 8 * NT;
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wm = warp % mt, kq = warp / mt;
      float* stg = reinterpret_cast<float*>(ring);
      if (kq < nks) {
#pragma unroll
        for (int n = 0; n < kGMaxNT; ++n) {
          if (n >= NT) break;
          float* r0 =
              stg + ((size_t)kq * rows + 16 * wm + lane / 4) * cols + n * 8 + 2 * (lane % 4);
          r0[0] = acc[n][0];
          r0[1] = acc[n][1];
          r0[8 * cols] = acc[n][2];
          r0[8 * cols + 1] = acc[n][3];
        }
      }
      __syncthreads();
      if (clk) clk->lap(lap);
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        const int i = threadIdx.x + q * kGThreads, r = i / nu, j = i - r * nu;
        if (i >= rows * nu) break;
        float sum[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float v = 0.f;
          for (int k = 0; k < nks; ++k) v += stg[((size_t)k * rows + r) * cols + 4 * j + g];
          sum[g] = v;
        }
        cell_epilogue(a, decoder, m0 + r, r, j, v, nv, sum, bb[q], c, wzd, zst, hnxt);
      }
      __syncthreads();  // the staged sums are read
    } else {
      const int item = threadIdx.x / S, ks = threadIdx.x % S, q = item / nu, j = item - q * nu;
      // after the butterfly every lane of an item holds its 16 sums: song b's
      // epilogue runs on lane b % S; its biases are loaded under the products
      float bb[4][4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        load_bias(bias, item < items && b % S == ks ? m0 + 4 * q + b : a.B, j, a.B, a.H, nu, v,
                  nv, bb[b]);
      gen_products(w, streamed, kcx, kch, a.x, Kx, hcur, Kh, m0, rows, NT, nu, S, ring, acc);
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          for (int off = S / 2; off > 0; off >>= 1)
            acc[b][g] += __shfl_xor_sync(0xffffffffu, acc[b][g], off);
      if (clk) clk->lap(lap);
      if (item < items)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (b % S == ks)
            cell_epilogue(a, decoder, m0 + 4 * q + b, 4 * q + b, j, v, nv, acc[b], bb[b], c,
                          wzd, zst, hnxt);
      __syncthreads();  // zst is read
    }
    if (clk) clk->lap(lap + 1);
  }
}

// The z heads and the reparameterized draw on h_e (an operand: bf16 in the
// bf16 mode), one block per latent and group of four songs, its threads
// splitting k: each lane sums its k in order, the lanes of a warp in a
// shuffle butterfly, the warps in order; then z = (zm + bz) + exp((zv +
// bz') / 2) * eps, kept in f32
template <typename WT>
__device__ __forceinline__ void gen_z_heads(const GenArgs<WT>& a, const WT* h, int t,
                                            float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, L = a.L, H = a.H,
            Kh = round16(a.H);
  const int jobs = L * cdiv(a.B, 4);
  for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
    const int l = job % L, q = job / L, s = 4 * q + threadIdx.x;
    const float e = threadIdx.x < 4 && s < a.B ? a.eps[((size_t)s * a.total + t) * L + l] : 0.f;
    float sm[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k = threadIdx.x; k < H; k += kGThreads) {
      const float w0 = ldf(a.wz_t + (size_t)l * H + k), w1 = ldf(a.wz_t + (size_t)(L + l) * H + k);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float hv = ldf(h + (size_t)(4 * q + b) * Kh + k);
        sm[0][b] = fmaf(hv, w0, sm[0][b]);
        sm[1][b] = fmaf(hv, w1, sm[1][b]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sm[i][b] += __shfl_xor_sync(0xffffffffu, sm[i][b], off);
        if (lane == 0) red[(warp * 2 + i) * 4 + b] = sm[i][b];
      }
    __syncthreads();
    const int b = threadIdx.x;
    if (b < 4 && s < a.B) {
      float zm = 0.f, zv = 0.f;
      for (int w = 0; w < kGWarps; ++w) {
        zm += red[(w * 2) * 4 + b];
        zv += red[(w * 2 + 1) * 4 + b];
      }
      a.zs[(size_t)s * L + l] = (zm + a.bz[l]) + expf((zv + a.bz[L + l]) / 2.f) * e;
    }
    __syncthreads();  // `red` is read
  }
}

// The frame head on h_d (an operand), the Bernoulli draw, the output and
// the next step's input (the seed's frame while teacher-forcing, else the
// drawn one): jobs of 16 songs x 8 pitches spread over the blocks, each
// block's warps splitting the k16 chunks of H (bf16: `mma.sync` on the
// packed head; f32: FFMA on lane (g, t)'s four outputs, rows g, g + 8 and
// pitches 2t, 2t + 1), their sums added in warp order.
template <typename WT>
__device__ __forceinline__ void gen_frame_head(const GenArgs<WT>& a, const WT* h, int t,
                                               float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int D = a.D, Kh = round16(a.H), Kx = round16(D), kch = Kh / 16;
  const int ntx = cdiv(D, 8), jobs = (round16(a.B) / 16) * ntx, nsteps = a.total - a.Tseed;
  for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
    const int mi = job / ntx, ni = job - mi * ntx;
    // warp q < 4 draws fragment entry q of each lane (row g + 8 (q / 2),
    // pitch 2 tq + q % 2): its u and the next seed frame are loaded first
    const int q = warp, s = 16 * mi + g + 8 * (q / 2), d = 8 * ni + 2 * tq + q % 2;
    const bool mine = q < 4 && s < a.B && d < D;
    float uu = 0.f, seed_next = 0.f;
    if (mine) {
      uu = a.u[((size_t)s * a.total + t) * D + d];
      if (t + 1 < a.Tseed) seed_next = a.seed[((size_t)s * a.Tseed + t + 1) * D + d];
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const WT* r0 = h + (size_t)(16 * mi + g) * Kh;
    if constexpr (sizeof(WT) == 2) {
      const bf16* wp = a.head_w + ((size_t)ni * kch * 32 + lane) * 4;
      for (int kc = warp; kc < kch; kc += kGWarps) {
        const uint2 lo = __ldcg(reinterpret_cast<const uint2*>(r0 + kc * 16 + 4 * tq));
        const uint2 hi = __ldcg(reinterpret_cast<const uint2*>(r0 + 8 * Kh + kc * 16 + 4 * tq));
        const uint2 b = __ldg(reinterpret_cast<const uint2*>(wp + (size_t)kc * 128));
        const unsigned af[4] = {lo.x, hi.x, lo.y, hi.y};
        cvl_tc::mma_bf16(acc, af, b.x, b.y);
      }
    } else {
      const float* w0 = reinterpret_cast<const float*>(a.head_w) + (size_t)(8 * ni + 2 * tq) * Kh;
      const float* hr = reinterpret_cast<const float*>(r0);
      for (int kc = warp; kc < kch; kc += kGWarps)
#pragma unroll
        for (int k = kc * 16; k < kc * 16 + 16; k += 4) {
          const float4 x0 = __ldcg(reinterpret_cast<const float4*>(hr + k));
          const float4 x1 = __ldcg(reinterpret_cast<const float4*>(hr + 8 * Kh + k));
          const float4 v0 = __ldg(reinterpret_cast<const float4*>(w0 + k));
          const float4 v1 = __ldg(reinterpret_cast<const float4*>(w0 + Kh + k));
          const float a0[4] = {x0.x, x0.y, x0.z, x0.w}, a1[4] = {x1.x, x1.y, x1.z, x1.w};
          const float b0[4] = {v0.x, v0.y, v0.z, v0.w}, b1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[0] = fmaf(a0[i], b0[i], acc[0]);
            acc[1] = fmaf(a0[i], b1[i], acc[1]);
            acc[2] = fmaf(a1[i], b0[i], acc[2]);
            acc[3] = fmaf(a1[i], b1[i], acc[3]);
          }
        }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(warp * 32 + lane) * 4 + e] = acc[e];
    __syncthreads();
    if (mine) {
      float sum = 0.f;
      for (int w = 0; w < kGWarps; ++w) sum += red[(w * 32 + lane) * 4 + q];
      const float xm = 1.f / (1.f + expf(-(sum + a.bx[d])));
      const float xt = uu < xm ? 1.f : 0.f;
      stf(a.x + (size_t)s * Kx + d, t + 1 < a.Tseed ? seed_next : xt);
      if (t >= a.Tseed)
        a.out[((size_t)s * nsteps + (t - a.Tseed)) * D + d] = a.return_probs ? xm : xt;
    }
    __syncthreads();  // `red` is read
  }
}

// One persistent cooperative launch for the whole song: every block owns nv
// groups of nu hidden units of both cells (all four gate columns of each)
// for every song; a step is four phases with a grid barrier after each.
// kGroups = false is the instance of one group a block (a.nv == 1, every
// width up to 2,640 on 132 SMs): its group count is a constant, so the
// group loops compile away and it runs the one-group code as it did before
// the groups existed; kGroups = true takes a.nv >= 1 groups.
template <typename WT, bool kGroups>
__global__ void __launch_bounds__(kGThreads, 1) generate_kernel(const GenArgs<WT> a) {
  extern __shared__ int4 smem_g[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_g);
  const int nv = kGroups ? a.nv : 1;
  const int D = a.D, H = a.H, L = a.L, nu = a.nu, Bp = round16(a.B);
  const int Kx = round16(D), Kh = round16(H);
  const size_t encn = slice_elems(D, H, nu, true), decn = slice_elems(D, H, nu, a.use_x_prev);
  const unsigned v0 = blockIdx.x * nv;  // the block's first unit group
  // its groups holding units (the last block's may hold fewer)
  const int nvb = kGroups ? min(nv, cdiv(H, nu) - (int)v0) : 1;
  const WT* encw = a.enc_w + v0 * encn;
  const WT* decw = a.dec_w + v0 * decn;
  size_t off = 0;
  if (a.resident) {  // the block's slices, copied once (16-byte pieces)
    WT* ws = reinterpret_cast<WT*>(base);
    const size_t ne = encn * sizeof(WT) / 16, nd = decn * sizeof(WT) / 16;
    for (size_t i = threadIdx.x; i < ne; i += kGThreads)
      reinterpret_cast<int4*>(ws)[i] = reinterpret_cast<const int4*>(encw)[i];
    for (size_t i = threadIdx.x; i < nd; i += kGThreads)
      reinterpret_cast<int4*>(ws + encn)[i] = reinterpret_cast<const int4*>(decw)[i];
    encw = ws;
    decw = ws + encn;
    off = slices_bytes(D, H, nu, a.use_x_prev, sizeof(WT));
  }
  unsigned char* ring = base + off;
  // [nv][nu][Bp] each
  float* ce = reinterpret_cast<float*>(ring + gen_ring_bytes(nu, a.resident));
  float* cd = ce + (size_t)nv * nu * Bp;
  float* wzd = cd + (size_t)nv * nu * Bp;    // [nv][L][4 nu]
  float* zst = wzd + nv * L * 4 * nu;         // [kGPass][L]
  for (int i = threadIdx.x; i < 2 * nv * nu * Bp; i += kGThreads) ce[i] = 0.f;
  for (int i = threadIdx.x; i < nv * 4 * nu; i += kGThreads) {
    const int v = kGroups ? i / (4 * nu) : 0, iv = i - v * 4 * nu;
    const int u = (v0 + v) * nu + iv / 4, col = (iv % 4) * H + u;
    for (int l = 0; l < L; ++l)
      wzd[(v * L + l) * 4 * nu + iv] = u < H ? a.wkd_z[(size_t)l * 4 * H + col] : 0.f;
  }
  // the first input: the seed's first frame
  for (int i = blockIdx.x * kGThreads + threadIdx.x; i < a.B * D; i += gridDim.x * kGThreads) {
    const int s = i / D, d = i - s * D;
    stf(a.x + (size_t)s * Kx + d, a.seed[(size_t)s * a.Tseed * D + d]);
  }
  unsigned rounds = 0;
  grid_sync(a.bar, rounds);
  __shared__ PhaseClock clk;  // thread 0 of block 0 keeps it
  const bool timer = threadIdx.x == 0;
  if (timer) {
    clk.out = blockIdx.x == 0 ? a.clock : nullptr;
    clk.start();
  }
  const size_t hbuf = (size_t)Bp * Kh;
  for (int t = 0; t < a.total; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    // 1. encoder cell: z_e = encb + [x_in | h_e] . [Wke_x ; Rke], group by group
    for (int v = 0; v < nvb; ++v)
      gen_cell(a, false, v, nv, encw + v * encn, a.encb, a.he + cur * hbuf,
               a.he + nxt * hbuf, ce + (size_t)v * nu * Bp, ring, wzd + v * L * 4 * nu, zst,
               timer ? &clk : nullptr, 0);
    grid_sync(a.bar, rounds);
    if (timer) clk.lap(2);
    // 2. z heads on h_e and the reparameterized draw (z stays f32)
    gen_z_heads(a, a.he + nxt * hbuf, t, reinterpret_cast<float*>(ring));
    if (timer) clk.lap(3);
    grid_sync(a.bar, rounds);
    if (timer) clk.lap(4);
    // 3. decoder cell: z_d = decb + [x_in | h_d] . [Wkd_x ; Rkd] + z . Wkd_z
    for (int v = 0; v < nvb; ++v)
      gen_cell(a, true, v, nv, decw + v * decn, a.decb, a.hd + cur * hbuf,
               a.hd + nxt * hbuf, cd + (size_t)v * nu * Bp, ring, wzd + v * L * 4 * nu, zst,
               timer ? &clk : nullptr, 5);
    grid_sync(a.bar, rounds);
    if (timer) clk.lap(7);
    // 4. frame head on h_d, the draw, the output, the next input
    gen_frame_head(a, a.hd + nxt * hbuf, t, reinterpret_cast<float*>(ring));
    if (timer) clk.lap(8);
    grid_sync(a.bar, rounds);
    if (timer) clk.lap(9);
  }
  if (timer) clk.flush();
}

template <typename WT>
int launch_gen(const GenArgs<WT>& a, cudaStream_t stream) {
  const size_t res = a.resident ? slices_bytes(a.D, a.H, a.nu, a.use_x_prev, sizeof(WT)) : 0;
  const size_t smem = gen_smem_bytes(a.nu, round16(a.B), a.L, res, a.nv);
  const void* kernel = a.nv > 1 ? (const void*)generate_kernel<WT, true>
                                : (const void*)generate_kernel<WT, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // cooperative: every block co-resident (the grid barrier needs it), or the
  // launch fails
  void* args[] = {const_cast<GenArgs<WT>*>(&a)};
  err = cudaLaunchCooperativeKernel(kernel, dim3(cdiv(cdiv(a.H, a.nu), a.nv)), dim3(kGThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the global state of the f32 / bf16 kernel, in bytes, each part a
// multiple of 16 bytes: x, h_e and h_d (two buffers each), z, the barrier
struct GenState {
  size_t x, he, hd, zs, bar, total;
};
__host__ __device__ inline GenState gen_state(int B, int D, int H, int L, int wbytes) {
  const size_t Bp = round16(B);
  GenState st{};
  st.x = 0;
  st.he = st.x + Bp * round16(D) * wbytes;
  st.hd = st.he + 2 * Bp * round16(H) * wbytes;
  st.zs = st.hd + 2 * Bp * round16(H) * wbytes;
  st.bar = st.zs + (Bp * L * 4 + 15) / 16 * 16;
  st.total = st.bar + 16;
  return st;
}

}  // namespace

// Bytes of dynamic shared memory one block of the f32 / bf16 kernel needs: a
// block owning nv groups of nu hidden units, for B songs and L latents, with
// its weight slices resident in shared memory or not (the wrapper checks the
// limit and picks residency where it fits).
extern "C" long long cvl_generate_cl_vrnn_smem_bytes(int nu, int B, int D, int H, int L,
                                                     int use_x_prev, int bf16_weights,
                                                     int resident, int nv) {
  const size_t res = resident ? slices_bytes(D, H, nu, use_x_prev, bf16_weights ? 2 : 4) : 0;
  return (long long)gen_smem_bytes(nu, round16(B), L, res, nv);
}

// Bytes of the state the f32 / bf16 kernel's blocks share in global memory
// (the caller zeroes them).
extern "C" long long cvl_generate_cl_vrnn_state_bytes(int B, int D, int H, int L,
                                                      int bf16_weights) {
  return (long long)gen_state(B, D, H, L, bf16_weights ? 2 : 4).total;
}

// Launches the f32 / bf16 sampler on `stream`: one cooperative launch of
// cdiv(cdiv(H, nu), nv) blocks, each owning nv groups of nu hidden units
// (resident only with nv == 1); enc_w, dec_w and head_w
// packed by the wrapper (`pack_slices`, `pack_head`), wz_t [2L, H] in the
// weight type, wkd_z [L, 4H] f32; `state` holds
// cvl_generate_cl_vrnn_state_bytes zeroed bytes; `clock` (kLaps counts, or
// null) receives block 0's ns per part of a step summed over the steps
// (PhaseClock, the int8 kernel's ten parts: the encoder's products, its
// epilogue, its wait; the z heads, their wait; the decoder's products,
// epilogue, wait; the frame head, its wait). Returns the
// cudaError_t of the launch (cudaErrorCooperativeLaunchTooLarge where the
// grid cannot be co-resident).
extern "C" int cvl_generate_cl_vrnn(
    int bf16_weights, const float* seed, const float* eps, const float* u, const void* enc_w,
    const void* dec_w, const void* head_w, const float* encb, const void* wz_t, const float* bz,
    const float* wkd_z, const float* decb, const float* bx, float* out, void* state,
    unsigned long long* clock, int B, int Tseed, int total, int D, int H, int L, int use_x_prev,
    int return_probs, int nu, int nv, int resident, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GenState g = gen_state(B, D, H, L, bf16_weights ? 2 : 4);
  unsigned char* sb = static_cast<unsigned char*>(state);
  float* zs = reinterpret_cast<float*>(sb + g.zs);
  unsigned* bar = reinterpret_cast<unsigned*>(sb + g.bar);
  if (bf16_weights) {
    using T = bf16;
    const GenArgs<T> a{seed, eps, u, static_cast<const T*>(enc_w), static_cast<const T*>(dec_w),
                       static_cast<const T*>(head_w), encb, static_cast<const T*>(wz_t), bz,
                       wkd_z, decb, bx, out, reinterpret_cast<T*>(sb + g.x),
                       reinterpret_cast<T*>(sb + g.he), reinterpret_cast<T*>(sb + g.hd), zs, bar,
                       clock, B, Tseed, total, D, H, L, use_x_prev, return_probs, nu, nv,
                       resident};
    return launch_gen(a, st);
  }
  using T = float;
  const GenArgs<T> a{seed, eps, u, static_cast<const T*>(enc_w), static_cast<const T*>(dec_w),
                     static_cast<const T*>(head_w), encb, static_cast<const T*>(wz_t), bz,
                     wkd_z, decb, bx, out, reinterpret_cast<T*>(sb + g.x),
                     reinterpret_cast<T*>(sb + g.he), reinterpret_cast<T*>(sb + g.hd), zs, bar,
                     clock, B, Tseed, total, D, H, L, use_x_prev, return_probs, nu, nv,
                     resident};
  return launch_gen(a, st);
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
