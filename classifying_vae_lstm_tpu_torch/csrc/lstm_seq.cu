// Whole-sequence Keras-2.0 LSTM kernels for Hopper (sm_90a), f32 streams.
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_lstm.py, the default fusion
// rung (proj, drk, full) = (T, T, T) of `lstm_sequence_pallas` :1553:
//   * :1203 `_forward_kernel_call_fp` -> `_lstm_seq_kernel_tblocked_fp` :632
//     (and its interleaved twin `_tblocked_fp_ilv` :676, the same math
//     pipelined for the TPU's MXU/VPU) with `lstm_seq_fwd_kernel<R, false>`,
//     the inference forward;
//   * :1146 `_forward_train_call_fp` -> `_lstm_seq_train_kernel_fp` :730 with
//     `lstm_seq_fwd_kernel<R, true>`, the training forward;
// and the other fusion rungs (proj, drk, full) of the same entry:
//   * :387 / :414 `_forward_kernel_call` -> `_lstm_seq_kernel` :216 (and
//     `_ilv` :244, `_tblocked` :289, `_tblocked_ilv` :328, the same math
//     scheduled for the TPU) with `lstm_seq_fwd_kernel<S, R, false, true>`,
//     the unfused inference forward: xz = x @ W + b comes in precomputed;
//   * :1070 `_forward_train_call` -> `_lstm_seq_train_kernel` :529 (and
//     `_ilv` :580) with `lstm_seq_fwd_kernel<S, R, true, true>`, which also
//     writes z;
//   * :1251 `_backward_call` -> `_lstm_bwd_kernel` :810 (and `_ilv` :848)
//     with `lstm_seq_bwd_kernel<S, S, R>`, the dz-only walk: dh = dz @ Rkᵀ
//     and the dz stream at the stream type, no dx;
//   * :1306 `_backward_call_drk` -> `_lstm_bwd_kernel_drk` :920 with the same
//     walk followed by a `wgrad_kernel<lstm_seq_wgrad>` job for
//     dRk = sum h_prevᵀdz (two launches). The TPU kernel sums dRk in a
//     resident block over its sequential grid; here a deterministic second
//     pass sums it, so the dz-only and drk rungs share the walk and differ
//     in that pass.
// The default rung's backward, :1378 `_backward_call_full`, is
// csrc/lstm_bwd_f32.cu (the walk over the whole batch per step).
//
// What it computes, per batch row and time step t = 0 .. T-1:
//   xz = x[t] @ W + b;  z = xz + h @ Rk;  (h, c) = gates(z, c)
// with Keras-2.0 gates (i, f, c, o): hard sigmoid clip(0.2x + 0.5, 0, 1) for
// i, f, o, tanh for g and for the cell output. The forward emits h and c per
// step; the training forward also emits z, h_prev and c_prev, the backward's
// residuals. The walk runs time in reverse from the cotangents of h and c
// per step and emits dz per step, dh0 and dc0.
//
// What bounds it on this card. Per row-step the forward is (IN + H) * 4H f32
// FMAs against IN + 2H floats of streams: at H=256 that is ~1,000 FMAs per
// float moved, so the operations bound it (67 TFLOP/s without tensor cores).
// At the training shape (B=200, T=16, H=256, IN~105) a forward is ~2.4 GFLOP,
// ~0.036 ms; at the evaluation shape (12,800 rows) ~151 GFLOP, ~2.2 ms. The
// walk multiplies by Rkᵀ alone. Each step depends on the one before, so the
// T steps run in series.
//
// What the design does about it.
// * Time is serial, rows are independent: one block owns a tile of R batch
//   rows and runs the whole time loop itself (the TPU grid walked time in
//   order with (h, c) in VMEM scratch; CUDA blocks run in no order and carry
//   nothing between them). h (double-buffered), c and the step's x live in
//   shared memory, stored [unit][row] so that one float4 load gives four
//   rows' operands.
// * The weights do not fit one SM: W and Rk are 1.4 MB at f32, H=256 (the
//   TPU kernel keeps them resident in VMEM). They stream from global memory
//   each step, stay resident in the 50 MB L2, and are stored so that
//   neighbouring threads read neighbouring gate columns.
// * Each weight load serves the whole row tile. A thread owns one hidden unit
//   (its four gate columns) for all R rows, so per K step it issues 4 weight
//   loads for 4R FMAs. The tile is R=16 when the batch fills every SM with
//   16-row blocks (the evaluation shape: 12,800 rows, 800 blocks, a quarter
//   of the L2 traffic of a 4-row tile) and R=4 otherwise (the training shape:
//   B=200 gives 50 blocks, where 16-row tiles would leave 119 of 132 SMs idle).
// * The input projection x @ W + b is computed here, as in the TPU kernel's
//   body, ahead of h @ Rk in the same accumulators; it is not a library matmul.
// * dRk crosses blocks. The TPU grid accumulated it in a resident block over
//   a sequential grid; concurrent CUDA blocks would need atomics, which make
//   the sums depend on launch order. So the walk writes dz per (t, row), and
//   the drk rung's second, deterministic pass forms sum h_prevᵀdz over the
//   T*B rows, each output element summed in row order by one thread.
// * The hard-sigmoid derivative is 0.2 strictly inside (0, 1) and 0 at and
//   beyond the clip points, the TPU kernel's rule (`_bwd_gate_grads` :786).
// * At H above ~2,300 a 4-row walk tile no longer fits shared memory (6H
//   floats a row: dz, the two carries), and the walk takes 2-row tiles,
//   which reach H = 4,800.
// Known limits of this simple form: every block streams all weights from L2
// every step, and the products run on FFMA, not the tensor cores. Plain FFMA
// keeps f32 exact to the JAX side's precision="highest" (no TF32).
//
// The bf16 stream mode (`compute_dtype=bf16` of `lstm_sequence_pallas`) is
// not here: csrc/lstm_seq_tc.cu runs it on the tensor cores. These FFMA
// kernels serve the f32 mode, exact to the JAX side's precision="highest".

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "wgrad.cuh"

namespace {

constexpr int kFwdThreads = 256;  // forward: one hidden unit per thread and pass
constexpr int kBwdThreads = 512;  // walk: threads per block (4 or 2 batch rows a block)
constexpr int kSlices = 2;        // walk: a product's K is split between two groups
constexpr int kUnits = kBwdThreads / kSlices;  // walk: output columns per pass

// S is the stream type (float)
template <typename S>
struct FwdArgs {
  const S* x;             // [T, B, IN]
  const S* w;             // [IN, 4H]
  const float* b;         // [4H]
  const S* xz;            // [T, B, 4H]  xz mode only (x, w and b null)
  const S* rk;            // [H, 4H]
  const float *h0, *c0;   // [B, H]
  float *h, *c;           // [T, B, H]
  S* z;                   // [T, B, 4H]  training forward only
  S* hp;                  // [T, B, H]   training forward only, not in the xz mode
  float* cp;              // [T, B, H]   training forward only, not in the xz mode
  int T, B, IN, H;
};

template <typename S>
struct BwdArgs {
  const S* z;             // [T, B, 4H]
  const float *cp, *c;    // [T, B, H]
  const float *dh, *dc;   // [T, B, H]  cotangents of the h and c sequences
  const S* rkt;           // [4H, H]  Rk transposed
  float *dh0, *dc0;       // [B, H]
  S* dz;                  // [T, B, 4H]
  int T, B, H;
};

__host__ __device__ constexpr size_t fwd_smem_floats(int IN, int H, int rows) {
  return (size_t)(IN + 3 * H) * rows;
}

__host__ __device__ constexpr size_t bwd_smem_floats(int H, int rows) {
  return (size_t)6 * H * rows + (size_t)rows * kUnits;
}

__device__ __forceinline__ float hard_sigmoid(float x) {
  return fminf(fmaxf(0.2f * x + 0.5f, 0.f), 1.f);
}

// d hard_sigmoid / dx expressed through the gate's value, as `_bwd_gate_grads`
__device__ __forceinline__ float hard_sigmoid_grad(float gate) {
  return (gate > 0.f && gate < 1.f) ? 0.2f : 0.f;
}

// loads widen to f32: `ld` through the read-only cache (weights), `ldv` plain
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldv(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

// the value a product's operand takes in the stream type's mode
template <typename S>
__device__ __forceinline__ float operand(float x) { return x; }

struct Keep {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};
template <typename S>
struct AsOperand {
  __device__ __forceinline__ float operator()(float x) const { return operand<S>(x); }
};

// rows s0 .. s0+R-1 of a [B, W] matrix into a [W][R] shared tile, each value
// through `op` (rows >= B are zero)
template <int R, typename T, typename Op = Keep>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int B, int s0, int W,
                                          Op op = Op()) {
  for (int i = threadIdx.x; i < W * R; i += blockDim.x) {
    const int b = i / W, k = i - b * W, s = s0 + b;
    dst[k * R + b] = s < B ? op(ldv(src + (size_t)s * W + k)) : 0.f;
  }
}

// one K step: operand row a[k][0..R) times the four gate weights
template <int R>
__device__ __forceinline__ void fma_row(float (&acc)[4][R], const float* ak, const float (&w)[4]) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(ak + 4 * q);
    const float av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g][4 * q + j] = fmaf(av[j], w[g], acc[g][4 * q + j]);
  }
}

// a [K][R] shared-memory operand times a [K, 4H] weight, accumulated into the
// four gate columns (i, f, c, o) of unit u for all R rows. The weights of U
// consecutive K steps are loaded before their FMAs, so that 4U loads from L2
// are in flight per thread: a 4-row tile has few FMAs per load to hide their
// latency behind (U = 8), a 16-row tile many (U = 2, at 128 registers).
template <int R, typename S>
__device__ __forceinline__ void mac_gates(float (&acc)[4][R], const float* a,
                                          const S* __restrict__ w, int K, int u, int H) {
  constexpr int U = R >= 16 ? 2 : 8;
  const S* wp = w + u;
  int k = 0;
  for (; k + U <= K; k += U, wp += (size_t)U * 4 * H) {
    float wv[U][4];
#pragma unroll
    for (int s = 0; s < U; ++s)
#pragma unroll
      for (int g = 0; g < 4; ++g) wv[s][g] = ld(wp + (size_t)s * 4 * H + g * H);
#pragma unroll
    for (int s = 0; s < U; ++s) fma_row<R>(acc, a + (k + s) * R, wv[s]);
  }
  for (; k < K; ++k, wp += 4 * H) {
    const float wv[4] = {ld(wp), ld(wp + H), ld(wp + 2 * H), ld(wp + 3 * H)};
    fma_row<R>(acc, a + k * R, wv);
  }
}

// kXz: xz = x @ W + b comes in precomputed at the stream type (the unfused
// rungs), and the training forward writes z alone (the core rebuilds h_prev
// and c_prev from h and c)
template <typename S, int R, bool kTrain, bool kXz>
__global__ void __launch_bounds__(kFwdThreads) lstm_seq_fwd_kernel(const FwdArgs<S> a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int T = a.T, B = a.B, H = a.H, IN = a.IN;
  float* xs = sm;                  // [IN][R] (IN = 0 in the xz mode)
  float* h_cur = xs + IN * R;      // [H][R] each; h as the operand of h @ Rk
  float* h_nxt = h_cur + H * R;
  float* cs = h_nxt + H * R;
  const int s0 = blockIdx.x * R;   // rows >= B are masked

  load_rows<R>(h_cur, a.h0, B, s0, H, AsOperand<S>());
  load_rows<R>(cs, a.c0, B, s0, H);
  for (int t = 0; t < T; ++t) {
    const size_t tb = (size_t)t * B;
    if (!kXz) load_rows<R>(xs, a.x + tb * IN, B, s0, IN);
    __syncthreads();
    for (int u = threadIdx.x; u < H; u += kFwdThreads) {  // no syncs inside
      float acc[4][R];
      if (kXz) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int s = s0 + r;
          const S* xzr = a.xz + (tb + (s < B ? s : 0)) * 4 * H + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[g][r] = s < B ? ldv(xzr + g * H) : 0.f;
        }
      } else {
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int r = 0; r < R; ++r) acc[g][r] = 0.f;
        mac_gates<R>(acc, xs, a.w, IN, u, H);  // xz = x[t] @ W ...
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float bg = a.b[g * H + u];     // ... + b, rounded to the stream type
#pragma unroll
          for (int r = 0; r < R; ++r) acc[g][r] = operand<S>(acc[g][r] + bg);
        }
      }
      mac_gates<R>(acc, h_cur, a.rk, H, u, H);  // z = xz + h @ Rk
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float i = hard_sigmoid(acc[0][r]);
        const float f = hard_sigmoid(acc[1][r]);
        const float g = tanhf(acc[2][r]);
        const float o = hard_sigmoid(acc[3][r]);
        const float cp = cs[u * R + r];
        const float cn = f * cp + i * g;
        const float hn = o * tanhf(cn);
        cs[u * R + r] = cn;
        h_nxt[u * R + r] = operand<S>(hn);
        const int s = s0 + r;
        if (s < B) {
          const size_t row = tb + s;
          a.h[row * H + u] = hn;
          a.c[row * H + u] = cn;
          if (kTrain) {
#pragma unroll
            for (int q = 0; q < 4; ++q) st(a.z + row * 4 * H + q * H + u, acc[q][r]);
            if (!kXz) {
              st(a.hp + row * H + u, h_cur[u * R + r]);
              a.cp[row * H + u] = cp;
            }
          }
        }
      }
    }
    __syncthreads();
    float* tmp = h_cur;
    h_cur = h_nxt;
    h_nxt = tmp;
  }
}

// acc[b] += a[b] * w for the R rows of one K step (one vector load)
template <int R>
__device__ __forceinline__ void fma_rows(float (&acc)[R], const float* ak, float w) {
  static_assert(R == 4 || R == 2, "row tiles of 4 or 2");
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(ak);
    acc[0] = fmaf(v.x, w, acc[0]);
    acc[1] = fmaf(v.y, w, acc[1]);
    acc[2] = fmaf(v.z, w, acc[2]);
    acc[3] = fmaf(v.w, w, acc[3]);
  } else {
    const float2 v = *reinterpret_cast<const float2*>(ak);
    acc[0] = fmaf(v.x, w, acc[0]);
    acc[1] = fmaf(v.y, w, acc[1]);
  }
}

// out(n, b) = sum_k a[k][b] * wt[k * N + n] for n in [0, N): a [K][R] in
// shared memory times a [K, N] weight; neighbouring threads read
// neighbouring columns, and the two slices of the block split K.
// `store(n, b, value)` receives each result.
template <int R, typename S, typename Store>
__device__ __forceinline__ void matvec_t(const float* a, const S* __restrict__ wt, int K,
                                         int N, float* part, Store store) {
  const int slice = threadIdx.x / kUnits, ln = threadIdx.x % kUnits;
  const int k0 = slice ? K / 2 : 0, k1 = slice ? K : K / 2;
  for (int n0 = 0; n0 < N; n0 += kUnits) {  // uniform trip count: syncs inside
    const int n = n0 + ln;
    float acc[R];
#pragma unroll
    for (int b = 0; b < R; ++b) acc[b] = 0.f;
    if (n < N) {
      const S* wp = wt + (size_t)k0 * N + n;
#pragma unroll 8
      for (int k = k0; k < k1; ++k, wp += N) fma_rows<R>(acc, a + k * R, ld(wp));
      if (slice == 1) {
#pragma unroll
        for (int b = 0; b < R; ++b) part[b * kUnits + ln] = acc[b];
      }
    }
    __syncthreads();
    if (slice == 0 && n < N) {
#pragma unroll
      for (int b = 0; b < R; ++b) store(n, b, acc[b] + part[b * kUnits + ln]);
    }
    __syncthreads();
  }
}

// the reverse walk of the dz-only and drk rungs: dh = dz @ Rkᵀ per step
template <typename S, int R>
__global__ void __launch_bounds__(kBwdThreads) lstm_seq_bwd_kernel(const BwdArgs<S> a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int T = a.T, B = a.B, H = a.H;
  float* dzs = sm;                 // [4H][R]  dz as the operand of dz @ Rkᵀ
  float* dh_c = dzs + 4 * H * R;   // [H][R]  carry of dh
  float* dc_c = dh_c + H * R;      // [H][R]  carry of dc
  float* part = dc_c + H * R;      // [R][kUnits]
  const int s0 = blockIdx.x * R;
  for (int i = threadIdx.x; i < 2 * H * R; i += kBwdThreads) dh_c[i] = 0.f;  // both carries
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const size_t tb = (size_t)t * B;
    // gate gradients (`_bwd_gate_grads`): dh = carry + dh[t], dc = carry + dc[t]
    for (int i = threadIdx.x; i < H * R; i += kBwdThreads) {
      const int u = i / R, r = i - u * R, s = s0 + r;
      float dz[4] = {0.f, 0.f, 0.f, 0.f};
      if (s < B) {
        const size_t row = tb + s;
        const S* zr = a.z + row * 4 * H;
        const float ig = hard_sigmoid(ldv(zr + u));
        const float fg = hard_sigmoid(ldv(zr + H + u));
        const float gg = tanhf(ldv(zr + 2 * H + u));
        const float og = hard_sigmoid(ldv(zr + 3 * H + u));
        const float tc = tanhf(a.c[row * H + u]);
        const float dh = dh_c[i] + a.dh[row * H + u];
        const float dc = (dc_c[i] + a.dc[row * H + u]) + dh * og * (1.f - tc * tc);
        dz[0] = dc * gg * hard_sigmoid_grad(ig);
        dz[1] = dc * a.cp[row * H + u] * hard_sigmoid_grad(fg);
        dz[2] = dc * ig * (1.f - gg * gg);
        dz[3] = dh * tc * hard_sigmoid_grad(og);
        dc_c[i] = dc * fg;
#pragma unroll
        for (int g = 0; g < 4; ++g) st(a.dz + row * 4 * H + g * H + u, dz[g]);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) dzs[(g * H + u) * R + r] = operand<S>(dz[g]);
    }
    __syncthreads();
    // dz @ Rkᵀ: the new dh carry, the only serial product
    matvec_t<R>(dzs, a.rkt, 4 * H, H, part, [&](int n, int r, float v) { dh_c[n * R + r] = v; });
  }
  for (int i = threadIdx.x; i < H * R; i += kBwdThreads) {
    const int u = i / R, r = i - u * R, s = s0 + r;
    if (s < B) {
      a.dh0[(size_t)s * H + u] = dh_c[i];
      a.dc0[(size_t)s * H + u] = dc_c[i];
    }
  }
}

struct lstm_seq_wgrad {};  // names this source's copy of cvl::wgrad_kernel

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename S, int R, bool kTrain, bool kXz>
int launch_fwd(const FwdArgs<S>& a, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(a.IN, a.H, R) * sizeof(float);
  int err = set_smem((const void*)lstm_seq_fwd_kernel<S, R, kTrain, kXz>, smem);
  if (err) return err;
  lstm_seq_fwd_kernel<S, R, kTrain, kXz><<<(a.B + R - 1) / R, kFwdThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename S, bool kXz>
int fwd(const FwdArgs<S>& a, int rows, int train, cudaStream_t st) {
  if (rows == 16)
    return train ? launch_fwd<S, 16, true, kXz>(a, st) : launch_fwd<S, 16, false, kXz>(a, st);
  if (rows == 4)
    return train ? launch_fwd<S, 4, true, kXz>(a, st) : launch_fwd<S, 4, false, kXz>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <typename S, int R>
int launch_bwd(const BwdArgs<S>& a, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats(a.H, R) * sizeof(float);
  int err = set_smem((const void*)lstm_seq_bwd_kernel<S, R>, smem);
  if (err) return err;
  lstm_seq_bwd_kernel<S, R><<<(a.B + R - 1) / R, kBwdThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename S>
int walk(const BwdArgs<S>& a, int rows, cudaStream_t st) {
  if (rows == 4) return launch_bwd<S, 4>(a, st);
  if (rows == 2) return launch_bwd<S, 2>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Bytes of dynamic shared memory one block of each serial kernel needs (the
// wrapper checks them against the card's limit).
// The xz forwards pass IN = 0.
extern "C" long long cvl_lstm_seq_fwd_smem_bytes(int IN, int H, int rows) {
  return (long long)(fwd_smem_floats(IN, H, rows) * sizeof(float));
}
extern "C" long long cvl_lstm_seq_bwd_smem_bytes(int H, int rows) {
  return (long long)(bwd_smem_floats(H, rows) * sizeof(float));
}

// The forward on `stream`, with a tile of `rows` (4 or 16) batch rows per
// block; `train` != 0 also writes z, hp and cp (null otherwise). Returns the
// cudaError_t of the launch.
extern "C" int cvl_lstm_seq_fwd(const float* x, const float* w, const float* b, const float* rk,
                                const float* h0, const float* c0, float* h, float* c, float* z,
                                float* hp, float* cp, int T, int B, int IN, int H, int rows,
                                int train, void* stream) {
  const FwdArgs<float> a{x, w, b, nullptr, rk, h0, c0, h, c, z, hp, cp, T, B, IN, H};
  return fwd<float, false>(a, rows, train, static_cast<cudaStream_t>(stream));
}


// The unfused rungs' forward on `stream` (`_forward_kernel_call`, and
// `_forward_train_call` with `train` != 0, which also writes z; null
// otherwise): xz [T, B, 4H] in place of x, W and b. Returns the cudaError_t
// of the launch.
extern "C" int cvl_lstm_seq_xz_fwd(const float* xz, const float* rk, const float* h0,
                                   const float* c0, float* h, float* c, float* z, int T, int B,
                                   int H, int rows, int train, void* stream) {
  const FwdArgs<float> a{nullptr, nullptr, nullptr, xz, rk,  h0, c0, h,
                         c,       z,       nullptr, nullptr, T, B, 0, H};
  return fwd<float, true>(a, rows, train, static_cast<cudaStream_t>(stream));
}


// The other rungs' dz-only walk on `stream` (`_backward_call`), with a tile of
// `rows` (4 or 2) batch rows per block: rkt = Rkᵀ [4H, H]; fills dz [T, B,
// 4H], dh0 and dc0. Returns the cudaError_t of the launch.
extern "C" int cvl_lstm_seq_walk(const float* z, const float* cp, const float* c,
                                 const float* dh, const float* dc, const float* rkt, float* dh0,
                                 float* dc0, float* dz, int T, int B, int H, int rows,
                                 void* stream) {
  const BwdArgs<float> a{z, cp, c, dh, dc, rkt, dh0, dc0, dz, T, B, H};
  return walk(a, rows, static_cast<cudaStream_t>(stream));
}


// The drk rung's second launch (`_lstm_bwd_kernel_drk`'s dRk += h_prevᵀdz):
// dRk = hpᵀdz over the R = T*B rows of the walk's dz, in f32 (the core
// rounds it to the stream type, as `_core_bwd` / `_core_fp_bwd` cast it).
// Returns the cudaError_t of the launch.
extern "C" int cvl_lstm_seq_drk(const float* hp, const float* dz, float* drk, int R, int H,
                                void* stream) {
  const cvl::WgradJob jobs[] = {{hp, dz, drk, H, 4 * H}};
  return cvl::launch_wgrad<lstm_seq_wgrad>(jobs, 1, R, static_cast<cudaStream_t>(stream));
}

