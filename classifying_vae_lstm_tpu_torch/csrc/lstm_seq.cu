// Whole-sequence Keras-2.0 LSTM forward for Hopper (sm_90a), f32 streams.
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_lstm.py, the default fusion
// rung (proj, drk, full) = (T, T, T) of `lstm_sequence_pallas` :1553:
//   * :1203 `_forward_kernel_call_fp` -> `_lstm_seq_kernel_tblocked_fp` :632
//     (and its interleaved twin `_tblocked_fp_ilv` :676, the same math
//     pipelined for the TPU's MXU/VPU) with `lstm_fwd_kernel<RT, false,
//     false>`, the inference forward;
//   * :1146 `_forward_train_call_fp` -> `_lstm_seq_train_kernel_fp` :730 with
//     `lstm_fwd_kernel<RT, true, false>`, the training forward;
// and the other fusion rungs (proj, drk, full) of the same entry:
//   * :387 / :414 `_forward_kernel_call` -> `_lstm_seq_kernel` :216 (and
//     `_ilv` :244, `_tblocked` :289, `_tblocked_ilv` :328, the same math
//     scheduled for the TPU) with `lstm_fwd_kernel<RT, false, true>`, the
//     unfused inference forward: xz = x @ W + b comes in precomputed;
//   * :1070 `_forward_train_call` -> `_lstm_seq_train_kernel` :529 (and
//     `_ilv` :580) with `lstm_fwd_kernel<RT, true, true>`, which also
//     writes z.
// The backwards are csrc/lstm_bwd_f32.cu's; the bf16 stream mode is
// csrc/lstm_seq_tc.cu's.
//
// What it computes, per batch row and time step t = 0 .. T-1:
//   xz = x[t] @ W + b;  z = xz + h @ Rk;  (h, c) = gates(z, c)
// with Keras-2.0 gates (i, f, c, o): hard sigmoid clip(0.2x + 0.5, 0, 1) for
// i, f, o, tanh for g and for the cell output. The forward emits h and c per
// step; the training forward also emits z, h_prev and c_prev, the backward's
// residuals (z alone in the xz mode: the core rebuilds h_prev and c_prev).
//
// What bounds it on this card. Per row-step the forward is (IN + H) * 4H f32
// FMAs against IN + 2H floats of streams: at H=256 that is ~1,000 FMAs per
// float moved, so the operations bound it (67 TFLOP/s without tensor cores).
// At the training shape (B=200, T=16, H=256, IN~105) a forward is ~2.4 GFLOP,
// ~0.036 ms; at the evaluation shape (12,800 rows) ~151 GFLOP, ~2.2 ms. Each
// step depends on the one before, so the T steps run in series.
//
// What the design does about it.
// * The columns are spread over a group of NB blocks, the rows over the
//   groups: each block owns nu hidden units, all four gate columns (i, f, c,
//   o) of each, so the gates stay in its epilogue (as the f32 backward walk
//   keeps them, csrc/lstm_bwd_f32.cu), and every row of its group; a group
//   of NB = cdiv(H, nu) blocks covers every unit (nu = 2 cdiv(H, 16), 8
//   blocks, up to H = 512; nu = 64 and more blocks past it). One
//   cooperative launch runs all T steps; a group walks its rows in tiles
//   each step, then waits for its blocks at csrc/coop.cuh's barrier in
//   global memory (one counter a group) before the next step reads their
//   h_t. h_t and c_t are the outputs themselves, read back through L2
//   (`cp.async.cg`): a group's rows of h (800 rows x 1 KB at the evaluation
//   shape) do not fit its shared memory. The groups share nothing; a launch
//   holds SMs / NB of them, one block an SM (16 groups of 8 blocks on an
//   H100). Groups as thread-block clusters, with the cluster's barrier, are
//   not worth a second path: an H100 holds 15 clusters of 8 such blocks, not
//   16 (a cluster needs 8 SMs of one GPC), which costs a row tile at the
//   evaluation shape (6.02 against 5.60 ms); at the training shape they
//   were 0-4% faster on the device (PERF.md §6).
// * Residency: each block builds its slice of [W ; Rk] (its 4 nu columns, K
//   = the x rows padded to 32 then the h rows padded to 32; 192 KB at H=256,
//   IN~105) in shared memory once a launch, from the weights as stored, as
//   [K][nu][4 gates] (`slice_src` reads each element; the first design's
//   blocks each streamed all of W and Rk from L2 every step, 1.4 MB at
//   H=256, with 50 of 132 SMs busy at B=200). Where it does not fit (f32 H
//   >= ~400), the slice streams from L2 chunk by chunk through the ring with
//   the operands, every tile; no width the first design took is refused.
// * A tile's operand [x_t | h_{t-1}] streams through a `cp.async` ring of
//   32-k chunks ([row][32 k], rows padded by 4 floats): 8 stages for a
//   16-row tile, 5 for 32, 3 for 64, so that a small tile, which computes a
//   chunk faster than L2 delivers one, keeps enough chunks in flight (a
//   variant that ran a step's tiles through the ring as one sequence was
//   slower on an H100: 6.00 against 5.60 ms at 12,800 rows). The
//   products run on FFMA in register tiles: a thread owns RT rows (r, r + 8,
//   ...) x 2 units x 4 gates, a warp 8 RT rows x 8 units; per 4 k a thread
//   loads RT float4 of its rows' operands and 8 of weights (its 2 units' 4
//   gates a k) for 32 RT FMAs. RT = 1, 2 or 4 follows the rows a group
//   holds (`fwd_plan` in the wrapper): 1 at the training shape. The
//   epilogue's c_prev (and h_prev) are loaded before a tile's products.
// * Sum order: each output is summed by one thread over k in order (the x
//   rows, then b, then the h rows; in the xz mode from xz, then the h rows),
//   with no atomics, so two calls give the same bits. Plain FFMA, no TF32:
//   f32 stays exact to the JAX side's precision="highest".
// Known limits: every block of a group reads the group's operand rows from
// L2 (the 8 blocks of a group the same rows; TMA multicast would read them
// once); a block holds its slice alone on its SM, 8 warps, too few to keep
// the FFMA pipes full (~2.5x the bound at the evaluation shape).

#include <cuda_runtime.h>
#include <stddef.h>

#include "coop.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;        // k of a chunk
constexpr int kAS = kKC + 4;   // a row of a stage's operand, padded (floats)
// ring stages: a small tile computes a chunk in less time than L2 takes to
// deliver one, so it keeps more chunks in flight
__host__ __device__ constexpr int stages(int RT) { return RT == 1 ? 8 : RT == 2 ? 5 : 3; }

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The layout of a launch (the wrapper's `fwd_plan` computes the same)
struct Plan {
  int nu;        // hidden units a block owns (even)
  int NB;        // blocks a group: cdiv(H, nu)
  int rpg;       // rows a group
  int groups;    // cdiv(B, rpg)
  int kx, kh;    // the x rows and the h rows of the slice, each padded to kKC
  int resident;  // the slice is copied into shared memory once a launch
};

// warps across a block's unit pairs (4 pairs a warp) and across its rows
__host__ __device__ constexpr int warp_cols(int nu) { return cdiv(nu / 2, 4); }
__host__ __device__ constexpr int tile_rows(int nu, int RT) {
  return 8 * RT * (kWarps / warp_cols(nu));
}

// dynamic shared memory of a block: the resident slice [K][4 nu], the ring
// (each stage a tile's operand chunk [rows][kAS] and, streamed, the slice's
// chunk [kKC][4 nu])
__host__ __device__ constexpr size_t fwd_smem_bytes(int nu, int RT, int kx, int kh,
                                                    int resident) {
  return ((resident ? (size_t)(kx + kh) * 4 * nu : 0) +
          (size_t)stages(RT) * ((size_t)tile_rows(nu, RT) * kAS + (resident ? 0 : kKC * 4 * nu))) *
         sizeof(float);
}

struct FwdArgs {
  const float* x;         // [T, B, IN]   (null in the xz mode)
  const float* xz;        // [T, B, 4H]   xz mode only
  const float* w;         // [IN, 4H]     (null in the xz mode)
  const float* b;         // [4H]         (null in the xz mode)
  const float* rk;        // [H, 4H]
  const float *h0, *c0;   // [B, H]
  float *h, *c;           // [T, B, H]
  float* z;               // [T, B, 4H]  training forward only
  float* hp;              // [T, B, H]   training forward only, not in the xz mode
  float* cp;              // [T, B, H]   training forward only, not in the xz mode
  unsigned* bar;          // [groups] arrivals at each group's barrier, zeroed
  int T, B, IN, H;
  Plan p;
};

__device__ __forceinline__ float hard_sigmoid(float x) {
  return fminf(fmaxf(0.2f * x + 0.5f, 0.f), 1.f);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// columns c0 .. c0 + 31 of rows r0 .. r0 + rows - 1 of a [*, W] matrix into a
// stage [rows][kAS] (zero past `rend` and W): 16-byte copies where every row
// and the base are 16-byte aligned, else 4-byte ones
__device__ __forceinline__ void load_chunk(float* dst, const float* src, int W, int r0, int rend,
                                           int rows, int c0) {
  const bool vec = (W % 4) == 0 && ((size_t)src % 16) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < rows * (kKC / 4); i += kThreads) {
      const int r = i / (kKC / 4), c = c0 + (i % (kKC / 4)) * 4, row = r0 + r;
      const bool ok = row < rend && c < W;
      cvl_tc::cp_async16(dst + r * kAS + c - c0, ok ? src + (size_t)row * W + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kKC; i += kThreads) {
      const int r = i / kKC, c = c0 + i % kKC, row = r0 + r;
      const bool ok = row < rend && c < W;
      cp_async4(dst + r * kAS + c - c0, ok ? src + (size_t)row * W + c : src, ok);
    }
  }
}

// Element (k, gate g, unit u) of a block's slice of [W ; Rk]: row k of W
// (k < kx; zero past IN), else row k - kx of Rk (zero past H); zero past H
// units. Null where the element is a zero of the padding.
__device__ __forceinline__ const float* slice_src(const FwdArgs& a, int k, int g, int u) {
  if (u >= a.H) return nullptr;
  const size_t col = (size_t)g * a.H + u, H4 = 4 * (size_t)a.H;
  if (k < a.p.kx) return k < a.IN ? a.w + k * H4 + col : nullptr;
  k -= a.p.kx;
  return k < a.H ? a.rk + k * H4 + col : nullptr;
}

// rows k0 .. k0 + rows - 1 of the block's slice (units u0 ..) into a ring
// stage [rows][nu][4] through `cp.async` (4 bytes): thread i reads gate g's
// run of units (coalesced) and writes it unit by unit
__device__ __forceinline__ void slice_rows(float* dst, const FwdArgs& a, int k0, int rows,
                                           int u0) {
  const int nu = a.p.nu, ldw = 4 * nu;
  for (int i = threadIdx.x; i < rows * ldw; i += kThreads) {
    const int r = i / ldw, rem = i - r * ldw, g = rem / nu, j = rem - g * nu;
    const float* src = slice_src(a, k0 + r, g, u0 + j);
    cp_async4(dst + (size_t)r * ldw + j * 4 + g, src ? src : a.rk, src != nullptr);
  }
}

// The block's whole slice (rows 0 .. K - 1, units u0 .. u0 + nun - 1) into
// `dst` [K][nu][4], once a launch: where a block's nu units are whole runs
// of 4 aligned floats, 16-byte loads of 4 units of a gate (48 a thread at
// H=256), else 4-byte ones; both synchronous, many in flight a thread
// (4-byte `cp.async` copies of the whole slice took ~0.3 ms a launch on an
// H100, their L2 round trips queued)
__device__ __forceinline__ void build_slice(float* dst, const FwdArgs& a, int K, int u0,
                                            int nun) {
  const int nu = a.p.nu, ldw = 4 * nu;
  const bool vec = nu % 4 == 0 && nun == nu && a.H % 4 == 0 &&
                   ((size_t)a.rk % 16) == 0 && (!a.w || ((size_t)a.w % 16) == 0);
  if (vec) {
    const int nq = nu / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < K * 4 * nq; i += kThreads) {
      const int k = i / (4 * nq), rem = i - k * 4 * nq, g = rem / nq, q = rem - g * nq;
      const float* src = slice_src(a, k, g, u0 + 4 * q);
      const float4 v = src ? __ldg(reinterpret_cast<const float4*>(src)) : make_float4(0, 0, 0, 0);
      float* d = dst + (size_t)k * ldw + 16 * q + g;
      d[0] = v.x;
      d[4] = v.y;
      d[8] = v.z;
      d[12] = v.w;
    }
    return;
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < K * ldw; i += kThreads) {
    const int r = i / ldw, rem = i - r * ldw, g = rem / nu, j = rem - g * nu;
    const float* src = slice_src(a, r, g, u0 + j);
    dst[(size_t)r * ldw + j * 4 + g] = src ? __ldg(src) : 0.f;
  }
}

// kTrain: also z (and, outside the xz mode, h_prev and c_prev); kXz: xz = x @
// W + b comes in precomputed (the unfused rungs). Grid (NB, groups): block
// (rank, group) owns units rank nu .. and the group's rows.
template <int RT, bool kTrain, bool kXz>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_kernel(const FwdArgs a) {
  constexpr int kStages = stages(RT);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Plan& pl = a.p;
  const int T = a.T, B = a.B, H = a.H, IN = a.IN, nu = pl.nu, NP = nu / 2;
  const int WC = warp_cols(nu), WR = kWarps / WC, TR = tile_rows(nu, RT);
  const int K = pl.kx + pl.kh, nch = K / kKC, kcx = pl.kx / kKC, ldw = 4 * nu;
  const int rank = blockIdx.x, u0 = rank * nu, nun = min(nu, H - u0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / WC, pr = (warp % WC) * 4 + lane % 4;  // the thread's unit pair
  const int rq = wr * 8 * RT + lane / 4;                       // its rows rq, rq + 8, ...
  const bool active = wr < WR && pr < NP;
  float* ring = sm + (pl.resident ? (size_t)K * ldw : 0);
  const int bst = pl.resident ? 0 : kKC * ldw;  // floats of streamed weights a stage
  const int sfl = TR * kAS + bst;               // floats a stage
  if (pl.resident) build_slice(sm, a, K, u0, nun);  // the block's slice, once a launch
  float bias[2][4] = {};
  if (!kXz && active)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        bias[e][g] = 2 * pr + e < nun ? a.b[(size_t)g * H + u0 + 2 * pr + e] : 0.f;
  const int rows0 = blockIdx.y * pl.rpg, rend = min(B, rows0 + pl.rpg);
  unsigned rounds = 0;
  for (int t = 0; t < T; ++t) {
    const size_t tb = (size_t)t * B;
    const float* hprev = t ? a.h + (tb - B) * H : a.h0;  // [B, H]
    const float* cprev = t ? a.c + (tb - B) * H : a.c0;
    const float* xt = kXz ? nullptr : a.x + tb * IN;
    for (int r0 = rows0; r0 < rend; r0 += TR) {
      // stage s <- chunk ch: the operand's rows, and the streamed slice
      auto load = [&](int ch) {
        float* st = ring + (ch % kStages) * sfl;
        if (ch < kcx)
          load_chunk(st, xt, IN, r0, rend, TR, ch * kKC);
        else
          load_chunk(st, hprev, H, r0, rend, TR, (ch - kcx) * kKC);
        if (!pl.resident) slice_rows(st + TR * kAS, a, ch * kKC, kKC, u0);
      };
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < nch) load(s);
        cvl_tc::cp_async_commit();
      }
      // the epilogue's operands (c_prev, and h_prev for the training
      // forward) and xz, loaded ahead of the products, whose time covers them
      float acc[RT][2][4], cpv[RT][2], hpv[RT][2];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r0 + rq + 8 * i, j = 2 * pr + e;
          const bool mine = active && row < rend && j < nun;
          const size_t prev = (size_t)row * H + u0 + j;
          cpv[i][e] = mine ? cprev[prev] : 0.f;
          hpv[i][e] = kTrain && !kXz && mine ? hprev[prev] : 0.f;
#pragma unroll
          for (int g = 0; g < 4; ++g)  // z starts from xz in the xz mode
            acc[i][e][g] = kXz && mine ? a.xz[(tb + row) * 4 * H + g * H + u0 + j] : 0.f;
        }
      for (int ch = 0; ch < nch; ++ch) {
        cvl_tc::cp_async_wait<kStages - 2>();
        __syncthreads();
        if (ch + kStages - 1 < nch) load(ch + kStages - 1);
        cvl_tc::cp_async_commit();
        if (!active) continue;
        if (!kXz && ch == kcx)  // xz = x @ W + b, then + h @ Rk
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int g = 0; g < 4; ++g) acc[i][e][g] += bias[e][g];
        const float* As = ring + (ch % kStages) * sfl + rq * kAS;
        const float* Bs = (pl.resident ? sm + (size_t)ch * kKC * ldw : ring + (ch % kStages) * sfl +
                                                                          TR * kAS) + 8 * pr;
        // unrolled twice, not fully: a fully unrolled chunk makes the kernel
        // ~14 K instructions, and instruction fetch then doubles a step
#pragma unroll 2
        for (int kk = 0; kk < kKC; kk += 4) {
          float4 av[RT];
#pragma unroll
          for (int i = 0; i < RT; ++i)
            av[i] = *reinterpret_cast<const float4*>(As + 8 * i * kAS + kk);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4* bw = reinterpret_cast<const float4*>(Bs + (kk + q) * ldw);
            const float4 b0 = bw[0], b1 = bw[1];
            const float w[2][4] = {{b0.x, b0.y, b0.z, b0.w}, {b1.x, b1.y, b1.z, b1.w}};
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              const float x = q == 0 ? av[i].x : q == 1 ? av[i].y : q == 2 ? av[i].z : av[i].w;
#pragma unroll
              for (int e = 0; e < 2; ++e)
#pragma unroll
                for (int g = 0; g < 4; ++g) acc[i][e][g] = fmaf(x, w[e][g], acc[i][e][g]);
            }
          }
        }
      }
      cvl_tc::cp_async_wait<0>();
      __syncthreads();  // the ring is free for the next tile
      if (!active) continue;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int row = r0 + rq + 8 * i;
        if (row >= rend) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 2 * pr + e;
          if (j >= nun) continue;
          const int u = u0 + j;
          const size_t o = (tb + row) * H + u;
          const float* z = acc[i][e];
          const float ig = hard_sigmoid(z[0]), fg = hard_sigmoid(z[1]);
          const float gg = tanhf(z[2]), og = hard_sigmoid(z[3]);
          const float cp = cpv[i][e];
          const float cn = fg * cp + ig * gg;
          const float hn = og * tanhf(cn);
          a.h[o] = hn;
          a.c[o] = cn;
          if (kTrain) {
#pragma unroll
            for (int g = 0; g < 4; ++g) a.z[(tb + row) * 4 * H + g * H + u] = z[g];
            if (!kXz) {
              a.hp[o] = hpv[i][e];
              a.cp[o] = cp;
            }
          }
        }
      }
    }
    cvl_coop::grid_sync(a.bar + blockIdx.y, rounds, pl.NB);  // the group's h_t is written
  }
}

template <int RT, bool kTrain, bool kXz>
int launch_rt(const FwdArgs& a, cudaStream_t stream) {
  const Plan& p = a.p;
  const auto kern = lstm_fwd_kernel<RT, kTrain, kXz>;
  const size_t smem = fwd_smem_bytes(p.nu, RT, p.kx, p.kh, p.resident);
  int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.NB, p.groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;  // every group co-resident: its barrier needs it, or the launch fails
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kern, a);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <bool kTrain, bool kXz>
int launch(const FwdArgs& a, int rt, cudaStream_t stream) {
  switch (rt) {
    case 1: return launch_rt<1, kTrain, kXz>(a, stream);
    case 2: return launch_rt<2, kTrain, kXz>(a, stream);
    case 4: return launch_rt<4, kTrain, kXz>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of dynamic shared memory one forward block needs (the wrapper picks
// residency and checks the limit): nu units, RT rows a thread, kx + kh
// packed rows (kx = 0 in the xz mode).
extern "C" long long cvl_lstm_seq_fwd_smem_bytes(int nu, int rt, int kx, int kh, int resident) {
  return (long long)fwd_smem_bytes(nu, rt, kx, kh, resident);
}

// The forward on `stream` in the layout the wrapper planned (`fwd_plan`: nu,
// NB, rows a group, groups, kx, kh, residency, RT rows a thread): x [T, B,
// IN], W [IN, 4H], b [4H] and Rk [H, 4H] as stored (each block builds its
// slice), or in the xz mode (x, w, b null, kx = 0) xz [T, B, 4H] and Rk;
// `train` != 0 also writes z (and outside the xz mode hp and cp; null
// otherwise); `bar` holds `groups` zeroed counters. Returns the cudaError_t
// of the launch.
extern "C" int cvl_lstm_seq_fwd(const float* x, const float* xz, const float* w, const float* b,
                                const float* rk, const float* h0, const float* c0, float* h,
                                float* c, float* z, float* hp, float* cp, unsigned* bar, int T,
                                int B, int IN, int H, int nu, int NB, int rpg, int groups, int kx,
                                int kh, int resident, int rt, int train, void* stream) {
  const FwdArgs a{x, xz, w, b, rk, h0, c0, h, c, z, hp, cp, bar, T, B, IN, H,
                  Plan{nu, NB, rpg, groups, kx, kh, resident}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xz)
    return train ? launch<true, true>(a, rt, st) : launch<false, true>(a, rt, st);
  return train ? launch<true, false>(a, rt, st) : launch<false, false>(a, rt, st);
}
