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
//     writes z.
// The backwards are csrc/lstm_bwd_f32.cu's: the default rung's, :1378
// `_backward_call_full`, and the walks of the dz-only and drk rungs, :1251
// `_backward_call` and :1306 `_backward_call_drk` (the walk over the whole
// batch per step).
//
// What it computes, per batch row and time step t = 0 .. T-1:
//   xz = x[t] @ W + b;  z = xz + h @ Rk;  (h, c) = gates(z, c)
// with Keras-2.0 gates (i, f, c, o): hard sigmoid clip(0.2x + 0.5, 0, 1) for
// i, f, o, tanh for g and for the cell output. The forward emits h and c per
// step; the training forward also emits z, h_prev and c_prev, the backward's
// residuals.
//
// What bounds it on this card. Per row-step the forward is (IN + H) * 4H f32
// FMAs against IN + 2H floats of streams: at H=256 that is ~1,000 FMAs per
// float moved, so the operations bound it (67 TFLOP/s without tensor cores).
// At the training shape (B=200, T=16, H=256, IN~105) a forward is ~2.4 GFLOP,
// ~0.036 ms; at the evaluation shape (12,800 rows) ~151 GFLOP, ~2.2 ms. Each
// step depends on the one before, so the T steps run in series.
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

namespace {

constexpr int kFwdThreads = 256;  // forward: one hidden unit per thread and pass

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

__host__ __device__ constexpr size_t fwd_smem_floats(int IN, int H, int rows) {
  return (size_t)(IN + 3 * H) * rows;
}

__device__ __forceinline__ float hard_sigmoid(float x) {
  return fminf(fmaxf(0.2f * x + 0.5f, 0.f), 1.f);
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

}  // namespace

// Bytes of dynamic shared memory one forward block needs (the wrapper checks
// them against the card's limit). The xz forwards pass IN = 0.
extern "C" long long cvl_lstm_seq_fwd_smem_bytes(int IN, int H, int rows) {
  return (long long)(fwd_smem_floats(IN, H, rows) * sizeof(float));
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

