// The step-decomposition probes of tools/ on Hopper (sm_90a): the
// microkernels that split an LSTM training step into its parts, the
// half-batch interleaved training forward and the padded-batch reverse-walk
// stub. They replace the six Pallas call sites of the TPU tools:
//   * tools/exp_h512_ablation.py:315 (`_chain_mm_kernel` :113,
//     `_chain_mm_x2_kernel` :131) -> `chain_kernel<1>`, `chain_kernel<2>`;
//   * tools/exp_h512_ablation.py:338 (`_chain_mm_x2_full_kernel` :155,
//     `_chain_mm_encdec_kernel` :185) -> `pair_kernel<false>`,
//     `pair_kernel<true>`;
//   * tools/exp_h512_ablation.py:375 (`_gates_fwd_kernel` :214,
//     `_gates_bwd_kernel` :236) -> `gates_fwd_kernel`, `gates_bwd_kernel`;
//   * tools/exp_h512_ablation.py:401 (`_offchain_mm_kernel` :273) ->
//     `offchain_kernel`;
//   * tools/exp_lstm_interleave.py:118 (`_interleaved_kernel` :50) ->
//     `interleave_kernel`;
//   * tools/repro_full_bwd_fault.py:140 (`_mini_kernel` :57) ->
//     `mini_walk_kernel<case>` and `mini_sum_kernel`.
//
// The function computed is the TPU kernels' as they run, not as their
// docstrings describe them. The h512 kernels set their scratch at grid step
// 0 only, and the TPU walks its grid in order, so batch block b starts from
// block b-1's final state: a chain returns, for block b, the state after
// (b+1)*T steps of block 0's h0 rows (the later blocks' h0 rows are never
// read); the gates kernels carry their state the same way over their own z
// blocks; `_offchain_mm_kernel` multiplies every block's hp and xp by block
// 0's dz. So each chain here is one serial chain of nb*T steps over bb rows.
//
// What bounds them. A chain step is [bb, H] x [H, 4H] in bf16 with f32 sums
// (2 bb H 4H operations; at bb=256, H=512 0.54 GFLOP, 0.5 us at the tensor
// cores' 989 TFLOP/s), and step s+1 needs every column block of step s: the
// bound is the steps' latency (product, epilogue, grid barrier), not the
// rate. The gates kernels are serial elementwise chains (a few operations a
// unit and step). The off-chain product and the interleaved forward are
// operation- and byte-bound respectively at their shapes.
//
// What the design does about it. Every chain and the interleaved forward is
// one persistent cooperative launch for all its steps: blocks walk the
// step's output tiles (64 rows x 128 columns, the `mma.sync` mainloop of
// csrc/mma_bf16.cuh) and meet at a grid barrier (csrc/coop.cuh) between
// steps; the bf16 h operand lives in a double buffer in global memory (L2),
// as `lstm_tc_step_kernel` keeps it (csrc/lstm_seq_tc.cu), so one barrier a
// step suffices. All 4H columns of each product are computed, as the TPU
// kernels compute them: the columns past H, which no output reads, are
// folded into a per-thread sink the kernel stores, so the time measures the
// whole product.
//   * chain_mm: one group of blocks, one barrier a step;
//   * chain_mm_x2: two groups, each owning half the rows with its own
//     barrier counter, so one half's product proceeds while the other half
//     waits at its barrier;
//   * chain_mm_x2_fullwidth / chain_mm_encdec: the tiles of both chains are
//     the work items of one grid, so the second chain runs on other blocks
//     (at bb=256, H=512, 64 tiles a chain: 128 blocks on 132 SMs). The
//     coupled chain B's step t reads chain A's step t output, so B runs two
//     steps behind A: iteration s runs A's step s and B's step s-2, and B's
//     tile forms its next operand bf16(hB + 0.001 hA) of its own elements
//     from its product and the f32 hA that A wrote an iteration before. One
//     barrier an iteration, N + 2 iterations for N steps;
//   * interleave: the unfused training forward (`lstm_tc_step_kernel<true>`'s
//     arithmetic: gate-interleaved Rk, the Keras gates in the epilogue) over
//     two half-batches with a barrier counter each, split into arrive and
//     wait: a block arrives after its half-A tiles of step t, waits for half
//     B's step t-1, runs its half-B tiles, arrives, and only then waits for
//     half A's step t; each half's barrier wait is hidden behind the other
//     half's work, the ping-pong of two warp groups at the grid's scale;
//   * gates_fwd: a block owns one row of the carried state (every unit reads
//     column 0 of its row's state each step: one block barrier a step);
//   * gates_bwd: elementwise, a thread per state element; z is read anew
//     each step (volatile loads), as the TPU kernel reads its VMEM ref, so
//     the compiler does not hoist the gate math out of the step loop;
//   * offchain_mm: a block owns a 64 x 128 tile of [dRk ; dW] and runs the
//     tensor-core mainloop nb*T times over it (its left operand read
//     transposed), the f32 sums in registers;
//   * mini walk: rows are independent, so a 16-row tile of the batch (B=40
//     leaves the last tile 8 rows, the rest masked to 0 as the TPU kernel
//     masks them) walks t = T-1 .. 0 with the dh carry in shared memory, and
//     adds each step's drk (and the dw and db its case has) into the tile's
//     own accumulators, which stay in global memory for the whole walk, as
//     the TPU kernel's constant-index output blocks stay resident; every
//     accumulator element is one thread's, so there are no atomics, and the
//     masked rows are summed like the others. The walk of a tile is repeated
//     by kMiniSplit blocks, each owning a slice of the accumulators' rows,
//     so that a thread's read-add-stores of global memory are few a step.
//     `mini_sum_kernel` then adds the tiles' partial sums in tile order.
//
// Rounding: h is rounded to bf16 as a product's operand (the TPU kernels'
// `.astype(rk.dtype)`); sums are f32; the interleave rounds z as it stores
// it; the mini walk is f32 throughout, its streams bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "coop.cuh"
#include "mma_bf16.cuh"

namespace {

using cvl_tc::Acc;
using cvl_tc::bf16;
using cvl_tc::kBM;
using cvl_tc::kBN;
using cvl_tc::kThreads;
using cvl_tc::Operand;

constexpr int kGateThreads = 256;
constexpr int kGateUnits = 8;  // units a thread of gates_fwd_kernel: H <= 2,048
constexpr int kMiniRows = 16;  // the TPU mini kernel's batch block
constexpr int kMiniThreads = 256;
constexpr int kMiniSplit = 32;  // blocks a tile: each owns 1/32 of the accumulator rows

__device__ __forceinline__ float hard_sigmoid(float x) {
  return fminf(fmaxf(0.2f * x + 0.5f, 0.f), 1.f);
}
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 b16(float v) { return __float2bfloat16_rn(v); }

// The two halves of a grid barrier (cvl_coop::grid_sync): arrive adds this
// block to `count` with a release after the block barrier; wait_for spins
// with acquiring loads until `count` reaches `target`
__device__ __forceinline__ void arrive(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
}
__device__ __forceinline__ void wait_for(unsigned* count, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(count) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// ------------------------------------------------------------------ chains

struct ChainArgs {
  const bf16* rk;  // [H, 4H]
  bf16* hb;        // [2, bb, H]  the h operand, double-buffered; hb[0] = bf16(h0[:bb])
  float* out;      // [nb * bb, H]
  float* sink;     // [grid * kThreads]  the columns past H
  unsigned* bar;   // [kGroups] barrier counters, zero at the launch
  int bb, H, nb, T;
};

// chain_mm (kGroups 1) and chain_mm_x2 (kGroups 2): nb*T steps of
// h <- (bf16(h) @ rk)[:, :H] * 0.02 over bb rows; group g owns rows
// [g bb/kGroups, (g+1) bb/kGroups) and the first or second half of the grid
template <int kGroups>
__global__ void __launch_bounds__(kThreads) chain_kernel(const ChainArgs a) {
  __shared__ __align__(16) unsigned char smem[cvl_tc::kSmemBytes];
  const int per = gridDim.x / kGroups, g = blockIdx.x / per, lb = blockIdx.x % per;
  const int H = a.H, N4 = 4 * H, rows = a.bb / kGroups, r0 = g * rows;
  const int nt = (N4 + kBN - 1) / kBN, items = ((rows + kBM - 1) / kBM) * nt;
  const int steps = a.nb * a.T;
  unsigned rounds = 0;
  float sink = 0.f;
  for (int s = 0; s < steps; ++s) {
    const bf16* hcur = a.hb + ((size_t)(s & 1) * a.bb + r0) * H;
    bf16* hnxt = a.hb + ((size_t)((s + 1) & 1) * a.bb + r0) * H;
    // the end of a TPU grid step: the state is that block's output
    float* out = (s + 1) % a.T ? nullptr : a.out + ((size_t)((s + 1) / a.T - 1) * a.bb + r0) * H;
    for (int it = lb; it < items; it += per) {
      const int m0 = (it / nt) * kBM, n0 = (it % nt) * kBN;
      Acc acc;
      cvl_tc::zero(acc);
      __syncthreads();  // the last item's mainloop is done with the ring
      cvl_tc::mainloop<false>(acc, Operand{hcur, rows, H, H}, Operand{a.rk, H, N4, N4}, m0, n0,
                              H, smem);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = m0 + cvl_tc::acc_row(mi, q), col = n0 + cvl_tc::acc_col(ni, q);
            if (row >= rows || col >= N4) continue;
            const float v = acc[mi][ni][q];
            if (col >= H) {
              sink += v;
              continue;
            }
            const float h = v * 0.02f;
            hnxt[(size_t)row * H + col] = b16(h);
            if (out) out[(size_t)row * H + col] = h;
          }
    }
    cvl_coop::grid_sync(a.bar + g, rounds, per);
  }
  a.sink[(size_t)blockIdx.x * kThreads + threadIdx.x] = sink;
}

struct PairArgs {
  const bf16 *rkA, *rkB;  // [H, 4H]
  const float* g0;        // [B, H]  chain B's start (rows < bb read)
  bf16 *hbA, *hbB;        // [2, bb, H]  the operands; hbA[0] = bf16(h0[:bb])
  float* fA;              // [2, bb, H]  chain A's h in f32 (the coupling reads it)
  float *outA, *outB;     // [nb * bb, H]
  float* sink;            // [grid * kThreads]
  unsigned* bar;          // [1], zero at the launch
  int bb, H, nb, T;
};

// chain_mm_x2_fullwidth (kCoupled false) and chain_mm_encdec (true): two
// chains over bb rows, A from h0 with rkA, B from g0 with rkB; B's step j
// takes opB_j = bf16(hB_j + 0.001 hA_{j+1}) (coupled) or bf16(hB_j) as its
// operand. The work items of an iteration are A's tiles and B's tiles, so
// the two chains run on different blocks. Iteration s = 0 .. N+1 runs A's
// step s (s < N: hA_{s+1}) and B's step s-2 (s >= 2: hB_{s-1}); B's tile
// then forms opB_{s-1} of its own elements from hB_{s-1} and hA_s, which A
// wrote in the iteration before (s = 1: hB_0 = g0, no product).
template <bool kCoupled>
__global__ void __launch_bounds__(kThreads) pair_kernel(const PairArgs a) {
  __shared__ __align__(16) unsigned char smem[cvl_tc::kSmemBytes];
  const int H = a.H, N4 = 4 * H, bb = a.bb;
  const int nt = (N4 + kBN - 1) / kBN, tiles = ((bb + kBM - 1) / kBM) * nt;
  const int N = a.nb * a.T;
  const size_t buf = (size_t)bb * H;
  unsigned rounds = 0;
  float sink = 0.f;
  for (int s = 0; s <= N + 1; ++s) {
    for (int it = blockIdx.x; it < 2 * tiles; it += gridDim.x) {
      const bool isA = it < tiles;
      if (isA ? s >= N : s == 0) continue;
      const int tile = isA ? it : it - tiles, m0 = (tile / nt) * kBM, n0 = (tile % nt) * kBN;
      Acc acc, hA;
      cvl_tc::zero(acc);
      if (kCoupled && !isA && s <= N) {
        // hA_s of this tile's elements, which A wrote an iteration before:
        // read through L2 (other SMs wrote it), all issued before the product
        const float* fA = a.fA + (size_t)(s & 1) * buf;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int row = m0 + cvl_tc::acc_row(mi, q), col = n0 + cvl_tc::acc_col(ni, q);
              hA[mi][ni][q] = row < bb && col < H ? __ldcg(fA + (size_t)row * H + col) : 0.f;
            }
      }
      if (isA || s >= 2) {
        __syncthreads();  // the last item's mainloop is done with the ring
        const bf16* op = isA ? a.hbA + (size_t)(s & 1) * buf : a.hbB + (size_t)(s & 1) * buf;
        cvl_tc::mainloop<false>(acc, Operand{op, bb, H, H},
                                Operand{isA ? a.rkA : a.rkB, H, N4, N4}, m0, n0, H, smem);
      }
      // A: hA_{s+1} into its operand, its f32 copy and at a block's end the
      // output; B: hB_{s-1} (g0 at s = 1) into opB_{s-1} and the output
      const int j = isA ? s + 1 : s - 1;
      float* out = j % a.T || j < a.T ? nullptr
                                       : (isA ? a.outA : a.outB) + (size_t)(j / a.T - 1) * buf;
      bf16* opn = isA ? a.hbA + (size_t)(j & 1) * buf
                      : (j < N ? a.hbB + (size_t)(j & 1) * buf : nullptr);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = m0 + cvl_tc::acc_row(mi, q), col = n0 + cvl_tc::acc_col(ni, q);
            if (row >= bb || col >= N4) continue;
            if (col >= H) {
              sink += acc[mi][ni][q];
              continue;
            }
            const size_t e = (size_t)row * H + col;
            const float h = (isA || s >= 2) ? acc[mi][ni][q] * 0.02f : a.g0[e];
            if (isA) {
              if (kCoupled) a.fA[(size_t)(j & 1) * buf + e] = h;
              opn[e] = b16(h);
            } else if (opn) {
              opn[e] = b16(kCoupled ? __fadd_rn(h, __fmul_rn(0.001f, hA[mi][ni][q])) : h);
            }
            if (out) out[e] = h;
          }
    }
    cvl_coop::grid_sync(a.bar, rounds);
  }
  a.sink[(size_t)blockIdx.x * kThreads + threadIdx.x] = sink;
}

// ------------------------------------------------------------------- gates

// gates_fwd: block r owns row r of the carried state c [bb, H] (zero at
// the start); for each z block b and step: z = z0[b bb + r] + c[r, 0], the
// Keras gates, c <- o * tanh(f c + i g); out[b bb + r] = c after block b
__global__ void __launch_bounds__(kGateThreads)
    gates_fwd_kernel(const float* __restrict__ z0, float* __restrict__ out, int bb, int H, int nb,
                     int T) {
  __shared__ float col0[2];
  const int r = blockIdx.x;
  float c[kGateUnits], zi[kGateUnits], zf[kGateUnits], zg[kGateUnits], zo[kGateUnits];
#pragma unroll
  for (int k = 0; k < kGateUnits; ++k) c[k] = 0.f;
  if (threadIdx.x == 0) col0[0] = 0.f;
  __syncthreads();
  int ph = 0;
  for (int b = 0; b < nb; ++b) {
    const float* zr = z0 + ((size_t)b * bb + r) * 4 * H;
#pragma unroll
    for (int k = 0; k < kGateUnits; ++k) {
      const int u = threadIdx.x + k * kGateThreads;
      if (u < H) zi[k] = zr[u], zf[k] = zr[H + u], zg[k] = zr[2 * H + u], zo[k] = zr[3 * H + u];
    }
    for (int t = 0; t < T; ++t) {
      const float s0 = col0[ph];
#pragma unroll
      for (int k = 0; k < kGateUnits; ++k) {
        const int u = threadIdx.x + k * kGateThreads;
        if (u >= H) continue;
        const float i = hard_sigmoid(zi[k] + s0), f = hard_sigmoid(zf[k] + s0);
        const float g = tanhf(zg[k] + s0), o = hard_sigmoid(zo[k] + s0);
        c[k] = o * tanhf(f * c[k] + i * g);
      }
      if (threadIdx.x == 0) col0[ph ^ 1] = c[0];
      __syncthreads();
      ph ^= 1;
    }
    float* orow = out + ((size_t)b * bb + r) * H;
#pragma unroll
    for (int k = 0; k < kGateUnits; ++k) {
      const int u = threadIdx.x + k * kGateThreads;
      if (u < H) orow[u] = c[k];
    }
  }
}

// gates_bwd: element (r, u) of the carried d [bb, H] (0.1 at the start);
// for each z block b and step the gate-gradient passes of the TPU kernel;
// out[b bb + r] = d after block b
__global__ void __launch_bounds__(kGateThreads)
    gates_bwd_kernel(const float* __restrict__ z0, float* __restrict__ out, int bb, int H, int nb,
                     int T) {
  const size_t e = (size_t)blockIdx.x * kGateThreads + threadIdx.x;
  if (e >= (size_t)bb * H) return;
  const int r = (int)(e / H), u = (int)(e % H);
  float d = 0.1f;
  for (int b = 0; b < nb; ++b) {
    const volatile float* zr = z0 + ((size_t)b * bb + r) * 4 * H;
    for (int t = 0; t < T; ++t) {
      const float zi = zr[u], zf = zr[H + u], zg = zr[2 * H + u], zo = zr[3 * H + u];
      const float i = hard_sigmoid(zi), f = hard_sigmoid(zf);
      const float g = tanhf(zg), o = hard_sigmoid(zo);
      const float dh = d;
      const float c = f * 0.5f + i * g;
      const float tc = tanhf(c);
      const float dov = dh * tc;
      const float dc = dh * o * (1.f - tc * tc) + d * f;
      const float di = dc * g, dg = dc * i, df = dc * 0.5f;
      const float mi = (zi > -2.5f && zi < 2.5f) ? 1.f : 0.f;
      const float mf = (zf > -2.5f && zf < 2.5f) ? 1.f : 0.f;
      const float mo = (zo > -2.5f && zo < 2.5f) ? 1.f : 0.f;
      d = 0.2f * di * mi + 0.2f * df * mf + dg * (1.f - g * g) + 0.2f * dov * mo;
    }
    out[((size_t)b * bb + r) * H + u] = d;
  }
}

// ------------------------------------------------------------ off-chain

// offchain_mm: the tile (blockIdx.y, blockIdx.x) of [dRk ; dW] ([H + IN,
// 4H], the first ceil(H / 64) row tiles dRk) = sum over the nb blocks and T
// steps of src_bᵀ @ dz_0: src_b the block's rows of hp (or xp), dz_0 block
// 0's rows of dz
__global__ void __launch_bounds__(kThreads)
    offchain_kernel(const bf16* __restrict__ hp, const bf16* __restrict__ dz,
                    const bf16* __restrict__ xp, float* __restrict__ drk, float* __restrict__ dw,
                    int bb, int H, int IN, int nb, int T) {
  __shared__ __align__(16) unsigned char smem[cvl_tc::kSmemBytes];
  const int N4 = 4 * H, n0 = blockIdx.x * kBN, mth = (H + kBM - 1) / kBM;
  const bool w = (int)blockIdx.y >= mth;
  const int m0 = (w ? (int)blockIdx.y - mth : (int)blockIdx.y) * kBM, M = w ? IN : H;
  const bf16* src = w ? xp : hp;
  float* out = w ? dw : drk;
  const Operand d{dz, bb, N4, N4};
  Acc acc;
  cvl_tc::zero(acc);
  for (int b = 0; b < nb; ++b) {
    const Operand lhs{src + (size_t)b * bb * M, bb, M, M};  // [K = bb rows, M], read transposed
    for (int t = 0; t < T; ++t) {
      __syncthreads();
      cvl_tc::mainloop<true>(acc, lhs, d, m0, n0, bb, smem);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + cvl_tc::acc_row(mi, q), col = n0 + cvl_tc::acc_col(ni, q);
        if (row < M && col < N4) out[(size_t)row * N4 + col] = acc[mi][ni][q];
      }
}

// ------------------------------------------------------------ interleave

struct IlvArgs {
  const bf16* xz;   // [T, B, 4H]  x @ W + b, gate-ordered
  const bf16* rk;   // [H, 4H]     gate-interleaved columns
  bf16* hb;         // [2, B, Hp]  the h operand, double-buffered; hb[0] = bf16(h0)
  const float* c0;  // [B, H]
  float *h, *c;     // [T, B, H]
  bf16* z;          // [T, B, 4H]
  unsigned* bar;    // [2] the halves' barrier counters, zero at the launch
  int T, B, H, Hp, Ba;  // rows [0, Ba) are half A, [Ba, B) half B
};

// step t of the tile (m0, n0) of the half whose rows are [r0, r0 + rows):
// z = xz[t] + h_{t-1} @ Rk and the gates, as lstm_tc_step_kernel<true>
__device__ __forceinline__ void interleave_tile(const IlvArgs& a, int t, int r0, int rows, int m0,
                                                int n0, unsigned char* smem) {
  const int B = a.B, H = a.H, Hp = a.Hp;
  const bf16* hcur = a.hb + ((size_t)(t & 1) * B + r0) * Hp;
  bf16* hnxt = a.hb + (size_t)((t + 1) & 1) * B * Hp;
  Acc acc;
  cvl_tc::zero(acc);
  cvl_tc::mainloop<false>(acc, Operand{hcur, rows, Hp, Hp}, Operand{a.rk, H, 4 * H, 4 * H}, m0,
                          n0, Hp, smem);
  const float* tile = cvl_tc::stage_acc(acc, smem);
  const float* cprev = t ? a.c + (size_t)(t - 1) * B * H : a.c0;
  // a warp per row: lane l holds unit n0 / 4 + l, its four gate columns adjacent
  const int u = n0 / 4 + threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < kBM; r += kThreads / 32) {
    if (m0 + r >= rows || u >= H) continue;
    const int row = r0 + m0 + r;
    const float4 v = *reinterpret_cast<const float4*>(tile + r * cvl_tc::kTileStride +
                                                      4 * (threadIdx.x % 32));
    const float p[4] = {v.x, v.y, v.z, v.w};
    const size_t tb = (size_t)t * B + row;
    const bf16* xzr = a.xz + tb * 4 * H;
    float zv[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) zv[g] = f32(xzr[g * H + u]) + p[g];
    const float i = hard_sigmoid(zv[0]), f = hard_sigmoid(zv[1]);
    const float g = tanhf(zv[2]), o = hard_sigmoid(zv[3]);
    const float cn = f * __ldcg(cprev + (size_t)row * H + u) + i * g;  // another SM wrote it
    const float hn = o * tanhf(cn);
    a.h[tb * H + u] = hn;
    a.c[tb * H + u] = cn;
    hnxt[(size_t)row * Hp + u] = b16(hn);
#pragma unroll
    for (int q = 0; q < 4; ++q) a.z[tb * 4 * H + q * H + u] = b16(zv[q]);
  }
  __syncthreads();  // the staged tile is read before the next mainloop fills the ring
}

__global__ void __launch_bounds__(kThreads) interleave_kernel(const IlvArgs a) {
  __shared__ __align__(16) unsigned char smem[cvl_tc::kSmemBytes];
  const int nt = (4 * a.H + kBN - 1) / kBN, Bb = a.B - a.Ba;
  const int itemsA = ((a.Ba + kBM - 1) / kBM) * nt, itemsB = ((Bb + kBM - 1) / kBM) * nt;
  for (int t = 0; t < a.T; ++t) {
    for (int it = blockIdx.x; it < itemsA; it += gridDim.x)
      interleave_tile(a, t, 0, a.Ba, (it / nt) * kBM, (it % nt) * kBN, smem);
    arrive(a.bar);
    wait_for(a.bar + 1, (unsigned)t * gridDim.x);  // half B's step t-1
    for (int it = blockIdx.x; it < itemsB; it += gridDim.x)
      interleave_tile(a, t, a.Ba, Bb, (it / nt) * kBM, (it % nt) * kBN, smem);
    arrive(a.bar + 1);
    wait_for(a.bar, (unsigned)(t + 1) * gridDim.x);  // half A's step t
  }
}

// ------------------------------------------------------------ mini walk

enum MiniCase { kBase = 0, kDxIn = 1, kDxOut = 2, kDw = 3, kDb = 4, kAll = 5 };

struct MiniArgs {
  const bf16 *z, *h, *x;  // [T, B, 4H], [T, B, H], [T, B, IN]
  bf16* dx;               // [T, B, IN]  (kDxOut, kAll)
  // each tile's accumulators: [nb, H, 4H] drk; [nb, H, 4H] (kDw) or [nb,
  // IN, 4H] (kAll) dw; [nb, 4H] db (kDb, kAll)
  float *pdrk, *pdw, *pdb;
  int T, B, H, IN;
};

__host__ __device__ constexpr bool mini_streams_x(int c) {
  return c == kDxIn || c == kDxOut || c == kAll;
}

// This block's rows [M s / S, M (s+1) / S) of a tile's accumulator P [M, N]
// (s = blockIdx.y, S = kMiniSplit): P <- (first ? 0 : P) + Aᵀ D over the
// tile's 16 rows, A [16, M] and D [16, N] in shared memory
__device__ __forceinline__ void tile_acc(float* __restrict__ P, const float* A, const float* D,
                                         int M, int N, bool first) {
  const int m0 = M * blockIdx.y / kMiniSplit, m1 = M * (blockIdx.y + 1) / kMiniSplit;
  for (int i = m0 * N + threadIdx.x; i < m1 * N; i += kMiniThreads) {
    const int m = i / N, n = i % N;
    const float p = first ? 0.f : P[i];  // issued before the products, which hide its latency
    float d = 0.f;
#pragma unroll
    for (int r = 0; r < kMiniRows; ++r) d = fmaf(A[r * M + m], D[r * N + n], d);
    P[i] = first ? d : p + d;
  }
}

// The reverse walk of the tile of rows [16 blockIdx.x, +16), its
// accumulator slice blockIdx.y: dz = tanh(z[t]) + dh @ ones(H, 4H) (every
// column of a row gets the row sum of its dh), h[t] and x[t] read, all three
// with the rows past B masked to 0; dh <- dz[:, :H]; drk += h[t]ᵀ dz, dw +=
// (x[t] at kAll, else h[t])ᵀ dz, db += the column sums of dz, dx[t] =
// bf16(dz[:, :IN] + x[t]) where the case has them. kDxIn streams x in and
// uses it for nothing, as the TPU case does.
template <int kCase>
__global__ void __launch_bounds__(kMiniThreads) mini_walk_kernel(const MiniArgs a) {
  extern __shared__ float sm[];
  __shared__ float rs[kMiniRows];
  const int H = a.H, H4 = 4 * H, IN = a.IN, r0 = blockIdx.x * kMiniRows;
  float* dz = sm;                   // [16, 4H]; its first H columns are the next step's dh
  float* hp = dz + kMiniRows * H4;  // [16, H]
  float* xp = hp + kMiniRows * H;   // [16, IN] (the cases that stream x)
  const int nrow = min(kMiniRows, a.B - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t tile = blockIdx.x;
  for (int i = threadIdx.x; i < kMiniRows * H4; i += kMiniThreads) dz[i] = 0.f;
  for (int t = a.T - 1; t >= 0; --t) {
    __syncthreads();
    for (int r = warp; r < kMiniRows; r += kMiniThreads / 32) {
      float s = 0.f;
      for (int k = lane; k < H; k += 32) s += dz[r * H4 + k];
#pragma unroll
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) rs[r] = s;
    }
    __syncthreads();
    const size_t row0 = (size_t)t * a.B + r0;
    for (int i = threadIdx.x; i < kMiniRows * H4; i += kMiniThreads) {
      const int r = i / H4;
      dz[i] = r < nrow ? tanhf(f32(a.z[row0 * H4 + i])) + rs[r] : 0.f;
    }
    for (int i = threadIdx.x; i < kMiniRows * H; i += kMiniThreads)
      hp[i] = i / H < nrow ? f32(a.h[row0 * H + i]) : 0.f;
    if (mini_streams_x(kCase))
      for (int i = threadIdx.x; i < kMiniRows * IN; i += kMiniThreads)
        xp[i] = i / IN < nrow ? f32(a.x[row0 * IN + i]) : 0.f;
    __syncthreads();
    if ((kCase == kDxOut || kCase == kAll) && blockIdx.y == 0)
      for (int i = threadIdx.x; i < nrow * IN; i += kMiniThreads)
        a.dx[row0 * IN + i] = b16(dz[(i / IN) * H4 + i % IN] + xp[i]);
    const bool first = t == a.T - 1;
    tile_acc(a.pdrk + tile * H * H4, hp, dz, H, H4, first);
    if (kCase == kDw) tile_acc(a.pdw + tile * H * H4, hp, dz, H, H4, first);
    if (kCase == kAll) tile_acc(a.pdw + tile * IN * H4, xp, dz, IN, H4, first);
    if ((kCase == kDb || kCase == kAll) && blockIdx.y == 0)
      for (int n = threadIdx.x; n < H4; n += kMiniThreads) {
        float d = 0.f;
#pragma unroll
        for (int r = 0; r < kMiniRows; ++r) d += dz[r * H4 + n];
        a.pdb[tile * H4 + n] = first ? d : a.pdb[tile * H4 + n] + d;
      }
  }
}

// C[i] = the sum of the nb tiles' P[b, i], added in tile order
__global__ void __launch_bounds__(256)
    mini_sum_kernel(const float* __restrict__ P, float* __restrict__ C, int n, int nb) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = P[i];
  for (int b = 1; b < nb; ++b) s += P[(size_t)b * n + i];
  C[i] = s;
}

template <typename K>
int coop_blocks(K kernel) {
  int dev = 0, sms = 0, per = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, 0) != cudaSuccess)
    return 0;
  return per * sms;
}

template <typename K, typename Args>
int launch_coop(K kernel, const Args& a, int grid, cudaStream_t st) {
  void* args[] = {const_cast<Args*>(&a)};
  const int err = (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                                   dim3(kThreads), args, 0, st);
  return err ? err : (int)cudaGetLastError();
}

int sum_launch(const float* P, float* C, int n, int nb, cudaStream_t st) {
  mini_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(P, C, n, nb);
  return (int)cudaGetLastError();
}

// The walk's shared memory: dz [16, 4H], h [16, H], x [16, IN] f32
int mini_smem(int kcase, int H, int IN) {
  return kMiniRows * (5 * H + (mini_streams_x(kcase) ? IN : 0)) * (int)sizeof(float);
}

template <int kCase>
int mini_launch(const MiniArgs& a, cudaStream_t st) {
  const int smem = mini_smem(kCase, a.H, a.IN);
  const int err = (int)cudaFuncSetAttribute(
      mini_walk_kernel<kCase>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const dim3 grid((a.B + kMiniRows - 1) / kMiniRows, kMiniSplit);
  mini_walk_kernel<kCase><<<grid, kMiniThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point queues its launches on `stream` and returns the first
// nonzero cudaError_t (0 when every launch was taken).

// The blocks of a cooperative kernel that the current card holds at once:
// kind 0 chain_kernel<1>, 1 chain_kernel<2>, 2 pair_kernel<false>, 3
// pair_kernel<true>, 4 interleave_kernel (0 if the card cannot say).
extern "C" int cvl_exp_coop_blocks(int kind) {
  switch (kind) {
    case 0: return coop_blocks(chain_kernel<1>);
    case 1: return coop_blocks(chain_kernel<2>);
    case 2: return coop_blocks(pair_kernel<false>);
    case 3: return coop_blocks(pair_kernel<true>);
    case 4: return coop_blocks(interleave_kernel);
    default: return 0;
  }
}

// chain_mm (groups 1) or chain_mm_x2 (groups 2): rk [H, 4H] bf16, hb [2,
// bb, H] bf16 with hb[0] = bf16(h0[:bb]), out [nb bb, H] f32, sink [grid
// 128] f32, bar [groups] zero; grid a multiple of groups that the card holds
// at once. One cooperative launch.
extern "C" int cvl_exp_chain(const void* rk, void* hb, float* out, float* sink, unsigned* bar,
                             int bb, int H, int nb, int T, int groups, int grid, void* stream) {
  const ChainArgs a{static_cast<const bf16*>(rk), static_cast<bf16*>(hb), out, sink, bar,
                    bb, H, nb, T};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return groups == 2 ? launch_coop(chain_kernel<2>, a, grid, st)
                     : launch_coop(chain_kernel<1>, a, grid, st);
}

// chain_mm_x2_fullwidth (coupled 0) or chain_mm_encdec (coupled 1): rkA,
// rkB [H, 4H] bf16, g0 [B, H] f32, hbA / hbB [2, bb, H] bf16 with hbA[0] =
// bf16(h0[:bb]), fA [2, bb, H] f32 scratch, outA / outB [nb bb, H] f32,
// sink [grid 128], bar [1] zero. One cooperative launch.
extern "C" int cvl_exp_pair(const void* rkA, const void* rkB, const float* g0, void* hbA,
                            void* hbB, float* fA, float* outA, float* outB, float* sink,
                            unsigned* bar, int bb, int H, int nb, int T, int coupled, int grid,
                            void* stream) {
  const PairArgs a{static_cast<const bf16*>(rkA), static_cast<const bf16*>(rkB), g0,
                   static_cast<bf16*>(hbA), static_cast<bf16*>(hbB), fA, outA, outB, sink, bar,
                   bb, H, nb, T};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return coupled ? launch_coop(pair_kernel<true>, a, grid, st)
                 : launch_coop(pair_kernel<false>, a, grid, st);
}

// gates_fwd (bwd 0) or gates_bwd (bwd 1): z0 [nb bb, 4H] f32 -> out [nb bb,
// H] f32. One launch (H <= 2,048 for the forward).
extern "C" int cvl_exp_gates(const float* z0, float* out, int bb, int H, int nb, int T, int bwd,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bwd) {
    const int blocks = (int)(((size_t)bb * H + kGateThreads - 1) / kGateThreads);
    gates_bwd_kernel<<<blocks, kGateThreads, 0, st>>>(z0, out, bb, H, nb, T);
  } else {
    if (H > kGateUnits * kGateThreads) return (int)cudaErrorInvalidValue;
    gates_fwd_kernel<<<bb, kGateThreads, 0, st>>>(z0, out, bb, H, nb, T);
  }
  return (int)cudaGetLastError();
}

// offchain_mm: hp [nb bb, H], dz [nb bb, 4H] (block 0's rows read), xp
// [nb bb, IN] bf16 -> drk [H, 4H], dw [IN, 4H] f32. One launch.
extern "C" int cvl_exp_offchain(const void* hp, const void* dz, const void* xp, float* drk,
                                float* dw, int bb, int H, int IN, int nb, int T, void* stream) {
  const dim3 grid((4 * H + kBN - 1) / kBN, (H + kBM - 1) / kBM + (IN + kBM - 1) / kBM);
  offchain_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(hp), static_cast<const bf16*>(dz), static_cast<const bf16*>(xp),
      drk, dw, bb, H, IN, nb, T);
  return (int)cudaGetLastError();
}

// The interleaved training forward: xz [T, B, 4H] bf16, rk [H, 4H] bf16
// gate-interleaved, hb [2, B, Hp] bf16 with hb[0] = bf16(h0) and zero pad
// columns, c0 [B, H] f32 -> h, c [T, B, H] f32, z [T, B, 4H] bf16; bar [2]
// zero. One cooperative launch of `grid` blocks.
extern "C" int cvl_exp_interleave(const void* xz, const void* rk, void* hb, const float* c0,
                                  float* h, float* c, void* z, unsigned* bar, int T, int B, int H,
                                  int Hp, int grid, void* stream) {
  const IlvArgs a{static_cast<const bf16*>(xz), static_cast<const bf16*>(rk),
                  static_cast<bf16*>(hb), c0, h, c, static_cast<bf16*>(z), bar, T, B, H, Hp,
                  (B + 1) / 2};
  return launch_coop(interleave_kernel, a, grid, static_cast<cudaStream_t>(stream));
}

// The mini walk of case kcase (MiniCase): z [T, B, 4H], h [T, B, H], x [T,
// B, IN] bf16; dx [T, B, IN] bf16 (dx_out and all, else null); the tiles'
// accumulators pdrk [nb, H, 4H], pdw ([nb, H, 4H] for dw, [nb, IN, 4H] for
// all, else null), pdb [nb, 4H] (db and all, else null) f32 scratch, nb =
// ceil(B / 16); their sums drk [H, 4H], dw, db [4H] f32. The walk, then one
// launch a sum.
extern "C" int cvl_exp_mini(int kcase, const void* z, const void* h, const void* x, void* dx,
                            float* pdrk, float* pdw, float* pdb, float* drk, float* dw, float* db,
                            int T, int B, int H, int IN, void* stream) {
  const MiniArgs a{static_cast<const bf16*>(z), static_cast<const bf16*>(h),
                   static_cast<const bf16*>(x), static_cast<bf16*>(dx), pdrk, pdw, pdb,
                   T, B, H, IN};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (kcase) {
    case kBase: err = mini_launch<kBase>(a, st); break;
    case kDxIn: err = mini_launch<kDxIn>(a, st); break;
    case kDxOut: err = mini_launch<kDxOut>(a, st); break;
    case kDw: err = mini_launch<kDw>(a, st); break;
    case kDb: err = mini_launch<kDb>(a, st); break;
    case kAll: err = mini_launch<kAll>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  const int nb = (B + kMiniRows - 1) / kMiniRows, H4 = 4 * H;
  if ((err = sum_launch(pdrk, drk, H * H4, nb, st))) return err;
  if (kcase == kDw || kcase == kAll)
    if ((err = sum_launch(pdw, dw, (kcase == kAll ? IN : H) * H4, nb, st))) return err;
  if (kcase == kDb || kcase == kAll) err = sum_launch(pdb, db, H4, nb, st);
  return err;
}
