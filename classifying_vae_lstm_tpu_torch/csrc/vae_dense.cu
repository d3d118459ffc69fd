// Dense-stack cl_vae training kernels for Hopper (sm_90a), f32 or bf16 mode.
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_vae.py
//   * :214 `_fwd_call` -> `_fwd_kernel` :133 with `vae_dense_fwd_kernel` below;
//   * :358 `_bwd_call` -> `_bwd_kernel` :230 in the f32 mode with
//     `vae_dense_bwd_kernel` (the row pass) followed by
//     `wgrad_kernel<vae_dense_wgrad>` (the weight gradients,
//     csrc/wgrad.cuh): one ported kernel, two launches. The bf16 mode's
//     backward is csrc/vae_dense_tc.cu (whole-batch products on the tensor
//     cores).
//
// What it computes, per batch row (D frame width, Cw key-encoder width, H
// hidden width, L latent width, K key classes):
//   a1    = relu(x @ Whw + bhw)                              [Cw]
//   wargs = a1 @ [Wwm | Wwv] + [bwm | bwv]                   [2(K-1)]
//   w     = softmax([wargs[:K-1] + exp(wargs[K-1:] / 2) * eps_w, 0])   [K]
//   a2    = relu(x @ Whx + w @ Whw2 + bh)                    [H]
//   zargs = a2 @ [Wzm | Wzv] + [bzm | bzv]                   [2L]
//   z     = zargs[:L] + exp(zargs[L:] / 2) * eps_z
//   a3    = relu(w @ Wdw + z @ Wdz [+ x_prev @ Wdxp] + bd)   [H]
//   xhat  = sigmoid(a3 @ Wxh + bxh)                          [D]
// The forward emits xhat, wargs, zargs, w and the residuals a1, a2, a3. The
// backward takes the cotangents of xhat, wargs, zargs and w, recomputes z and
// the exp factors from the zargs / wargs residuals, takes the relu masks from
// the post-activations (a > 0), runs the vjp chain frame head -> decoder ->
// z sample -> latent encoder -> softmax (the pinned zero logit dropped) -> w
// heads -> key encoder, and emits dx, dx_prev and every weight and bias
// gradient.
//
// What bounds it on this card. At the jsball_vae width with 13 keys (D = H =
// Cw = 88, L = 4, use_x_prev) a row is 36,432 FMAs forward, so B = 100 rows
// are 7.3 MFLOP (0.11 us at 67 TFLOP/s) against ~0.38 MB of weights and row
// streams (0.11 us at 3.35 TB/s); the backward is about twice that. Both are
// far below the cost of one launch: at this width the kernels are bound by
// latency (launch, the chain of seven dependent layers, L2 reads), not by the
// card's rates. At the seq-concat width the JAX kernel was written for (D =
// 976, Cw = 256, H = 1024, L = 16, K = 13, B = 1024) a row is 3.33 M FMAs, and
// the forward, 6.8 GFLOP, is operations-bound at ~0.10 ms.
//
// What the design does about it.
// * Rows are independent: one block owns a tile of kRows rows and runs the
//   whole layer chain for them, keeping the tile's activations (x, x_prev,
//   a1, wargs, w, a2, zargs, z, a3) in shared memory, stored [feature][row] so
//   one float4 load gives the tile's four operands. One thread per output
//   column of the current layer sums over k; a barrier separates layers.
// * The weights are read from global memory and held by the 50 MB L2, not
//   staged in shared memory: each block reads each weight once per call, so
//   staging would buy nothing, and reading from L2 keeps every width working,
//   up to the seq-concat width whose weights (13.3 MB at H = 1024) fit no SM.
//   Neighbouring threads read neighbouring columns, so the reads coalesce;
//   the backward reads transposed weights, made by the wrapper, for the same.
// * The weight gradients cross blocks. The TPU grid accumulated them in
//   resident blocks over a sequential grid; here concurrent blocks would need
//   atomics, which make the sums depend on launch order. So the row pass
//   writes each layer's pre-activation cotangent (and z) to scratch, and a
//   second, deterministic launch forms every dW = A^T dPre and every bias
//   column sum, each output element summed in row order by one thread.
// * No library call: every product is the FFMA loop below, which keeps f32
//   exact to the JAX side's precision="highest" (no TF32). The loss stays in
//   torch on the kernel's outputs, as it stays in XLA in the JAX package.
// Known limits of this simple form: every block streams all weights from L2,
// and the products run on FFMA, not the tensor cores; a layer with few
// columns (the w and z heads) leaves most of the block's threads idle.
//
// The forward's bf16 mode (`vae_apply_core(compute_dtype=bf16)` in the JAX
// package: `_fwd_kernel` with bf16 weights) is the same code with the weight
// type WT = __nv_bfloat16: x, x_prev and every kernel are bf16, the biases,
// the noise and every other stream f32. Each product rounds its left operand
// to bf16 where the TPU kernel's `mm` does (a1, w, a2, z, a3) and accumulates
// in f32; the shared tiles hold those operands rounded, since they are only
// read as operands. The residuals a1, a2, a3 are written as f32 holding their
// bf16-rounded values (the TPU kernel stores them in bf16). The backward's
// bf16 mode, with the same rounding points as the TPU kernel (each
// pre-activation cotangent rounded as an operand, the weight gradients
// rounded once after their f32 sums, the bias sums of the unrounded
// cotangents), is csrc/vae_dense_tc.cu. At the seq-concat width bf16 halves
// the forward's weight stream (13.3 -> 6.7 MB at H = 1024 with x_prev); its
// products still run on FFMA, where bf16 operands would make mma.sync or
// wgmma legal: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "wgrad.cuh"

namespace {

constexpr int kRows = 4;       // batch rows per block (one float4 of operands)
constexpr int kThreads = 256;  // threads per block: one output column each per pass

// The fields typed `const void*` hold WT (float, or __nv_bfloat16 in bf16 mode).
struct FwdArgs {
  const void* x;       // [B, D]
  const void* xp;      // [B, D]  or null without use_x_prev
  const float* eps_w;  // [B, K-1]
  const float* eps_z;  // [B, L]
  const void* whw;     // [D, Cw]
  const float* bhw;    // [Cw]
  const void* wwz;     // [Cw, 2(K-1)]  w_mean | w_log_var kernels
  const float* bwz;    // [2(K-1)]
  const void* whx;     // [D, H]  latent encoder, x rows
  const void* whw2;    // [K, H]  latent encoder, w rows
  const float* bh;     // [H]
  const void* wzz;     // [H, 2L]  z_mean | z_log_var kernels
  const float* bzz;    // [2L]
  const void* wdw;     // [K, H]  decoder, w rows
  const void* wdxp;    // [D, H]  decoder, x_prev rows (or null)
  const void* wdz;     // [L, H]  decoder, z rows
  const float* bd;     // [H]
  const void* wxh;     // [H, D]
  const float* bxh;    // [D]
  float* xhat;         // [B, D]
  float* wargs;        // [B, 2(K-1)]
  float* zargs;        // [B, 2L]
  float* w;            // [B, K]
  float *a1, *a2, *a3;  // [B, Cw], [B, H], [B, H]
  int B, D, Cw, H, L, K, use_xp;
};

struct BwdArgs {
  const float *eps_w, *eps_z;                     // [B, K-1], [B, L]
  const float *a1, *a2, *a3;                      // [B, Cw], [B, H], [B, H]
  const float *xhat, *wargs, *zargs, *w;          // the forward's outputs
  const float *dxhat, *dwargs, *dzargs, *dw;      // their cotangents
  // the transposed weights and dx, dxp hold WT
  const void* wxh_t;   // [D, H]            frame head, transposed
  const void* wd_t;    // [H, K + n_xp + L] decoder (w | x_prev | z rows), transposed
  const void* wzz_t;   // [2L, H]           z heads, transposed
  const void* wh_t;    // [H, D + K]        latent encoder (x | w rows), transposed
  const void* wwz_t;   // [2(K-1), Cw]      w heads, transposed
  const void* whw_t;   // [Cw, D]           key encoder, transposed
  void *dx, *dxp;      // [B, D] (dxp null without use_x_prev)
  // scratch for the weight-gradient pass: each layer's pre-activation cotangent, and z
  float *dxh_pre, *dd_pre, *dza, *dh_pre, *dwa, *dhw_pre, *zs;
  int B, D, Cw, H, L, K, use_xp;
};

__host__ __device__ constexpr size_t fwd_smem_floats(int D, int Cw, int H, int L, int K,
                                                     int use_xp) {
  // x, x_prev, a1, wargs, w, a2, zargs, z, a3
  return (size_t)kRows * (D * (1 + use_xp) + Cw + 2 * (K - 1) + K + 2 * H + 3 * L);
}

__host__ __device__ constexpr size_t bwd_smem_floats(int D, int Cw, int H, int L, int K) {
  // dxh_pre, dd_pre, dw_tot, dz, dzargs, dh_pre, dx, dwargs, dhw_pre
  return (size_t)kRows * (2 * D + 2 * H + K + 3 * L + 2 * (K - 1) + Cw);
}

// One operand of a layer: a [k][kRows] tile in shared memory times a [k, N]
// row-major weight of type WT in global memory. k = 0 skips it.
template <typename WT>
struct Operand {
  const float* a;
  const WT* w;
  int k;
};

__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ldx(const float* p) { return *p; }
__device__ __forceinline__ float ldx(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void stx(float* p, float v) { *p = v; }

// the value a product's left operand takes in the weight type's mode
template <typename WT>
__device__ __forceinline__ float operand(float x) { return x; }
template <>
__device__ __forceinline__ float operand<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// out(n, r) = bias[n] + sum over the operands of sum_j a[j][r] * w[j * N + n],
// for n in [0, N) and the tile's rows r; neighbouring threads take
// neighbouring columns. `store(n, r, value)` receives each result. No
// barrier inside: the caller syncs before the next layer reads the results.
template <typename WT, int NOps, typename Store>
__device__ __forceinline__ void layer(const Operand<WT> (&ops)[NOps], const float* bias, int N,
                                      Store store) {
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float b = bias ? __ldg(bias + n) : 0.f;
    float acc[kRows] = {b, b, b, b};
#pragma unroll
    for (int i = 0; i < NOps; ++i) {
      const float* a = ops[i].a;
      const WT* wp = ops[i].w + n;
      const int k = ops[i].k;
#pragma unroll 4
      for (int j = 0; j < k; ++j, wp += N) {
        const float wv = ldw(wp);
        const float4 v = *reinterpret_cast<const float4*>(a + j * kRows);
        acc[0] = fmaf(v.x, wv, acc[0]);
        acc[1] = fmaf(v.y, wv, acc[1]);
        acc[2] = fmaf(v.z, wv, acc[2]);
        acc[3] = fmaf(v.w, wv, acc[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) store(n, r, acc[r]);
  }
}

// rows s0 .. s0+kRows-1 of a [B, W] matrix into a [W][kRows] shared tile
// (rows >= B are zero)
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int B, int s0, int W) {
  for (int i = threadIdx.x; i < W * kRows; i += kThreads) {
    const int r = i / W, k = i - r * W, s = s0 + r;
    dst[k * kRows + r] = s < B ? ldx(src + (size_t)s * W + k) : 0.f;
  }
}

template <typename WT>
__global__ void __launch_bounds__(kThreads) vae_dense_fwd_kernel(const FwdArgs a) {
  const auto W = [](const void* p) { return static_cast<const WT*>(p); };
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int B = a.B, D = a.D, Cw = a.Cw, H = a.H, L = a.L, K = a.K, K1 = K - 1;
  float* xs = sm;                                // [D][kRows]
  float* xps = xs + D * kRows;                   // [D][kRows] with use_x_prev
  float* a1s = xps + (a.use_xp ? D : 0) * kRows; // [Cw][kRows]
  float* was = a1s + Cw * kRows;                 // [2(K-1)][kRows]
  float* ws = was + 2 * K1 * kRows;              // [K][kRows]
  float* a2s = ws + K * kRows;                   // [H][kRows]
  float* zas = a2s + H * kRows;                  // [2L][kRows]
  float* zs = zas + 2 * L * kRows;               // [L][kRows]
  float* a3s = zs + L * kRows;                   // [H][kRows]
  const int s0 = blockIdx.x * kRows;             // rows >= B are masked

  load_rows(xs, W(a.x), B, s0, D);
  if (a.use_xp) load_rows(xps, W(a.xp), B, s0, D);
  __syncthreads();

  // key encoder: a1 = relu(x @ Whw + bhw)
  const Operand<WT> key_enc[] = {{xs, W(a.whw), D}};
  layer(key_enc, a.bhw, Cw, [&](int n, int r, float v) {
    v = operand<WT>(fmaxf(v, 0.f));
    a1s[n * kRows + r] = v;
    if (s0 + r < B) a.a1[(size_t)(s0 + r) * Cw + n] = v;
  });
  __syncthreads();
  // w heads: wargs = a1 @ [Wwm | Wwv] + [bwm | bwv]
  const Operand<WT> w_heads[] = {{a1s, W(a.wwz), Cw}};
  layer(w_heads, a.bwz, 2 * K1, [&](int n, int r, float v) {
    was[n * kRows + r] = v;
    if (s0 + r < B) a.wargs[(size_t)(s0 + r) * 2 * K1 + n] = v;
  });
  __syncthreads();
  // logistic-normal sample: softmax over the K-1 noisy logits and the pinned
  // zero logit, one thread per row
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x, s = s0 + r;
    float m = 0.f;  // the zero logit
    for (int j = 0; j < K1; ++j) {
      const float e = s < B ? a.eps_w[(size_t)s * K1 + j] : 0.f;
      const float wn = was[j * kRows + r] + expf(was[(K1 + j) * kRows + r] / 2.f) * e;
      ws[j * kRows + r] = wn;
      m = fmaxf(m, wn);
    }
    ws[K1 * kRows + r] = 0.f;
    float sum = 0.f;
    for (int j = 0; j < K; ++j) {
      const float e = expf(ws[j * kRows + r] - m);
      ws[j * kRows + r] = e;
      sum += e;
    }
    for (int j = 0; j < K; ++j) {
      const float v = ws[j * kRows + r] / sum;
      ws[j * kRows + r] = operand<WT>(v);
      if (s < B) a.w[(size_t)s * K + j] = v;
    }
  }
  __syncthreads();
  // latent encoder: a2 = relu(x @ Whx + w @ Whw2 + bh)
  const Operand<WT> lat_enc[] = {{xs, W(a.whx), D}, {ws, W(a.whw2), K}};
  layer(lat_enc, a.bh, H, [&](int n, int r, float v) {
    v = operand<WT>(fmaxf(v, 0.f));
    a2s[n * kRows + r] = v;
    if (s0 + r < B) a.a2[(size_t)(s0 + r) * H + n] = v;
  });
  __syncthreads();
  // z heads: zargs = a2 @ [Wzm | Wzv] + [bzm | bzv]
  const Operand<WT> z_heads[] = {{a2s, W(a.wzz), H}};
  layer(z_heads, a.bzz, 2 * L, [&](int n, int r, float v) {
    zas[n * kRows + r] = v;
    if (s0 + r < B) a.zargs[(size_t)(s0 + r) * 2 * L + n] = v;
  });
  __syncthreads();
  // z sample
  for (int i = threadIdx.x; i < L * kRows; i += kThreads) {
    const int l = i / kRows, r = i - l * kRows, s = s0 + r;
    const float e = s < B ? a.eps_z[(size_t)s * L + l] : 0.f;
    zs[i] = operand<WT>(zas[l * kRows + r] + expf(zas[(L + l) * kRows + r] / 2.f) * e);
  }
  __syncthreads();
  // decoder: a3 = relu(w @ Wdw + z @ Wdz [+ x_prev @ Wdxp] + bd)
  const Operand<WT> dec[] = {
      {ws, W(a.wdw), K}, {zs, W(a.wdz), L}, {xps, W(a.wdxp), a.use_xp ? D : 0}};
  layer(dec, a.bd, H, [&](int n, int r, float v) {
    v = operand<WT>(fmaxf(v, 0.f));
    a3s[n * kRows + r] = v;
    if (s0 + r < B) a.a3[(size_t)(s0 + r) * H + n] = v;
  });
  __syncthreads();
  // frame head: xhat = sigmoid(a3 @ Wxh + bxh)
  const Operand<WT> head[] = {{a3s, W(a.wxh), H}};
  layer(head, a.bxh, D, [&](int n, int r, float v) {
    if (s0 + r < B) a.xhat[(size_t)(s0 + r) * D + n] = 1.f / (1.f + expf(-v));
  });
}

// The f32 mode's row pass (WT = float: `operand` keeps every value).
template <typename WT>
__global__ void __launch_bounds__(kThreads) vae_dense_bwd_kernel(const BwdArgs a) {
  const auto W = [](const void* p) { return static_cast<const WT*>(p); };
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int B = a.B, D = a.D, Cw = a.Cw, H = a.H, L = a.L, K = a.K, K1 = K - 1;
  const int n_xp = a.use_xp ? D : 0;
  float* dxh = sm;                 // [D][kRows]   frame head pre-activation cotangent
  float* dd = dxh + D * kRows;     // [H][kRows]   decoder pre-activation cotangent
  float* dwt = dd + H * kRows;     // [K][kRows]   total cotangent of w
  float* dzs = dwt + K * kRows;    // [L][kRows]   cotangent of z
  float* dza = dzs + L * kRows;    // [2L][kRows]  cotangent of zargs
  float* dh = dza + 2 * L * kRows; // [H][kRows]   latent encoder pre-activation cotangent
  float* dxs = dh + H * kRows;     // [D][kRows]   dx from the latent encoder
  float* dwa = dxs + D * kRows;    // [2(K-1)][kRows]  cotangent of wargs
  float* dhw = dwa + 2 * K1 * kRows;  // [Cw][kRows]  key encoder pre-activation cotangent
  const int s0 = blockIdx.x * kRows;
  const bool ok[kRows] = {s0 < B, s0 + 1 < B, s0 + 2 < B, s0 + 3 < B};

  // frame head: sigmoid backward
  for (int i = threadIdx.x; i < D * kRows; i += kThreads) {
    const int r = i / D, n = i - r * D, s = s0 + r;
    float v = 0.f;
    if (s < B) {
      const size_t o = (size_t)s * D + n;
      const float xh = a.xhat[o];
      v = a.dxhat[o] * xh * (1.f - xh);
      a.dxh_pre[o] = v;
    }
    dxh[n * kRows + r] = operand<WT>(v);
  }
  __syncthreads();
  // decoder: dd_pre = (dxh_pre @ Wxh^T) * (a3 > 0)
  const Operand<WT> head[] = {{dxh, W(a.wxh_t), D}};
  layer(head, nullptr, H, [&](int n, int r, float v) {
    const size_t o = (size_t)(s0 + r) * H + n;
    v = (ok[r] && a.a3[o] > 0.f) ? v : 0.f;
    dd[n * kRows + r] = operand<WT>(v);
    if (ok[r]) a.dd_pre[o] = v;
  });
  __syncthreads();
  // dd_pre @ (Wdw | Wdxp | Wdz)^T: the decoder's share of dw, dx_prev, dz
  const Operand<WT> dec[] = {{dd, W(a.wd_t), H}};
  layer(dec, nullptr, K + n_xp + L, [&](int n, int r, float v) {
    const int s = s0 + r;
    if (n < K) {
      dwt[n * kRows + r] = (ok[r] ? a.dw[(size_t)s * K + n] : 0.f) + v;
    } else if (n < K + n_xp) {
      if (ok[r]) stx(static_cast<WT*>(a.dxp) + (size_t)s * D + (n - K), v);
    } else {
      dzs[(n - K - n_xp) * kRows + r] = v;
    }
  });
  __syncthreads();
  // z sample + z heads backward, z recomputed from the zargs residual
  for (int i = threadIdx.x; i < L * kRows; i += kThreads) {
    const int l = i / kRows, r = i - l * kRows, s = s0 + r;
    float dzm = 0.f, dzv = 0.f;
    if (s < B) {
      const size_t o = (size_t)s * 2 * L;
      const float sig = expf(a.zargs[o + L + l] / 2.f);
      const float e = a.eps_z[(size_t)s * L + l];
      const float dz = dzs[i];
      dzm = dz + a.dzargs[o + l];
      dzv = dz * e * sig * 0.5f + a.dzargs[o + L + l];
      a.dza[o + l] = dzm;
      a.dza[o + L + l] = dzv;
      a.zs[(size_t)s * L + l] = a.zargs[o + l] + sig * e;
    }
    dza[l * kRows + r] = operand<WT>(dzm);
    dza[(L + l) * kRows + r] = operand<WT>(dzv);
  }
  __syncthreads();
  // latent encoder: dh_pre = (dzargs @ Wzz^T) * (a2 > 0)
  const Operand<WT> z_heads[] = {{dza, W(a.wzz_t), 2 * L}};
  layer(z_heads, nullptr, H, [&](int n, int r, float v) {
    const size_t o = (size_t)(s0 + r) * H + n;
    v = (ok[r] && a.a2[o] > 0.f) ? v : 0.f;
    dh[n * kRows + r] = operand<WT>(v);
    if (ok[r]) a.dh_pre[o] = v;
  });
  __syncthreads();
  // dh_pre @ (Whx | Whw2)^T: the latent encoder's share of dx and of dw
  const Operand<WT> lat_enc[] = {{dh, W(a.wh_t), H}};
  layer(lat_enc, nullptr, D + K, [&](int n, int r, float v) {
    if (n < D) {
      dxs[n * kRows + r] = v;
    } else {
      dwt[(n - D) * kRows + r] += v;
    }
  });
  __syncthreads();
  // logistic-normal sample backward: softmax vjp, the pinned zero logit
  // (lane K-1) dropped; one thread per row
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x, s = s0 + r;
    float dot = 0.f;
    if (ok[r])
      for (int j = 0; j < K; ++j) dot += dwt[j * kRows + r] * a.w[(size_t)s * K + j];
    for (int j = 0; j < K1; ++j) {
      float dwm = 0.f, dwv = 0.f;
      if (ok[r]) {
        const size_t o = (size_t)s * 2 * K1;
        const float wj = a.w[(size_t)s * K + j];
        const float dl = wj * (dwt[j * kRows + r] - dot);
        const float sig = expf(a.wargs[o + K1 + j] / 2.f);
        const float e = a.eps_w[(size_t)s * K1 + j];
        dwm = dl + a.dwargs[o + j];
        dwv = dl * e * sig * 0.5f + a.dwargs[o + K1 + j];
        a.dwa[o + j] = dwm;
        a.dwa[o + K1 + j] = dwv;
      }
      dwa[j * kRows + r] = operand<WT>(dwm);
      dwa[(K1 + j) * kRows + r] = operand<WT>(dwv);
    }
  }
  __syncthreads();
  // key encoder: dhw_pre = (dwargs @ Wwz^T) * (a1 > 0)
  const Operand<WT> w_heads[] = {{dwa, W(a.wwz_t), 2 * K1}};
  layer(w_heads, nullptr, Cw, [&](int n, int r, float v) {
    const size_t o = (size_t)(s0 + r) * Cw + n;
    v = (ok[r] && a.a1[o] > 0.f) ? v : 0.f;
    dhw[n * kRows + r] = operand<WT>(v);
    if (ok[r]) a.dhw_pre[o] = v;
  });
  __syncthreads();
  // dx = the latent encoder's share + dhw_pre @ Whw^T
  const Operand<WT> key_enc[] = {{dhw, W(a.whw_t), Cw}};
  layer(key_enc, nullptr, D, [&](int n, int r, float v) {
    if (ok[r]) stx(static_cast<WT*>(a.dx) + (size_t)(s0 + r) * D + n, dxs[n * kRows + r] + v);
  });
}

struct vae_dense_wgrad {};  // names this source's copy of cvl::wgrad_kernel

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Bytes of dynamic shared memory the larger of the two row kernels needs per
// block (the wrapper checks them against the card's limit).
extern "C" long long cvl_vae_dense_smem_bytes(int D, int Cw, int H, int L, int K, int use_xp) {
  const size_t f = fwd_smem_floats(D, Cw, H, L, K, use_xp), b = bwd_smem_floats(D, Cw, H, L, K);
  return (long long)((f > b ? f : b) * sizeof(float));
}

// The forward on `stream` (bf16: the bf16 mode, x, xp and the kernels
// bf16); returns the cudaError_t of the launch.
extern "C" int cvl_vae_dense_fwd(
    int bf16, const void* x, const void* xp, const float* eps_w, const float* eps_z,
    const void* whw, const float* bhw, const void* wwz, const float* bwz, const void* whx,
    const void* whw2, const float* bh, const void* wzz, const float* bzz, const void* wdw,
    const void* wdxp, const void* wdz, const float* bd, const void* wxh, const float* bxh,
    float* xhat, float* wargs, float* zargs, float* w, float* a1, float* a2, float* a3, int B,
    int D, int Cw, int H, int L, int K, int use_xp, void* stream) {
  const FwdArgs a{x,   xp,  eps_w, eps_z, whw, bhw, wwz,   bwz,   whx, whw2, bh, wzz,
                  bzz, wdw, wdxp,  wdz,   bd,  wxh, bxh,   xhat,  wargs, zargs, w,  a1,
                  a2,  a3,  B,     D,     Cw,  H,   L,     K,     use_xp};
  const size_t smem = fwd_smem_floats(D, Cw, H, L, K, use_xp) * sizeof(float);
  const void* fn = bf16 ? (const void*)vae_dense_fwd_kernel<__nv_bfloat16>
                        : (const void*)vae_dense_fwd_kernel<float>;
  int err = set_smem(fn, smem);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    vae_dense_fwd_kernel<__nv_bfloat16><<<(B + kRows - 1) / kRows, kThreads, smem, st>>>(a);
  else
    vae_dense_fwd_kernel<float><<<(B + kRows - 1) / kRows, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The f32 backward's row pass on `stream`: fills dx, dxp and the scratch
// (dxh_pre, dd_pre, dza, dh_pre, dwa, dhw_pre, zs) that cvl_vae_dense_wgrad
// reduces. Returns the cudaError_t of the launch.
extern "C" int cvl_vae_dense_bwd(
    const float* eps_w, const float* eps_z, const float* a1, const float* a2,
    const float* a3, const float* xhat, const float* wargs, const float* zargs, const float* w,
    const float* dxhat, const float* dwargs, const float* dzargs, const float* dw,
    const void* wxh_t, const void* wd_t, const void* wzz_t, const void* wh_t,
    const void* wwz_t, const void* whw_t, void* dx, void* dxp, float* dxh_pre,
    float* dd_pre, float* dza, float* dh_pre, float* dwa, float* dhw_pre, float* zs, int B,
    int D, int Cw, int H, int L, int K, int use_xp, void* stream) {
  const BwdArgs a{eps_w,  eps_z,  a1,    a2,    a3,     xhat,   wargs, zargs, w,  dxhat,
                  dwargs, dzargs, dw,    wxh_t, wd_t,   wzz_t,  wh_t,  wwz_t, whw_t, dx,
                  dxp,    dxh_pre, dd_pre, dza, dh_pre, dwa,    dhw_pre, zs,  B,  D,
                  Cw,     H,      L,     K,     use_xp};
  const size_t smem = bwd_smem_floats(D, Cw, H, L, K) * sizeof(float);
  int err = set_smem((const void*)vae_dense_bwd_kernel<float>, smem);
  if (err) return err;
  vae_dense_bwd_kernel<float><<<(B + kRows - 1) / kRows, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The f32 backward's weight and bias gradients over the B rows of the
// residuals and the scratch, one launch; returns the cudaError_t of the
// launch. dwdxp (and xp) are null without use_x_prev.
extern "C" int cvl_vae_dense_wgrad(
    const float* x, const float* xp, const float* a1, const float* a2, const float* a3,
    const float* w, const float* zs, const float* dxh_pre, const float* dd_pre,
    const float* dza, const float* dh_pre, const float* dwa, const float* dhw_pre, float* dwhw,
    float* dbhw, float* dwwz, float* dbwz, float* dwhx, float* dwhw2, float* dbh, float* dwzz,
    float* dbzz, float* dwdw, float* dwdxp, float* dwdz, float* dbd, float* dwxh, float* dbxh,
    int B, int D, int Cw, int H, int L, int K, int use_xp, void* stream) {
  const int K2 = 2 * (K - 1);
  const cvl::WgradJob jobs[] = {
      {x, dhw_pre, dwhw, D, Cw},       {nullptr, dhw_pre, dbhw, 1, Cw},
      {a1, dwa, dwwz, Cw, K2},         {nullptr, dwa, dbwz, 1, K2},
      {x, dh_pre, dwhx, D, H},         {w, dh_pre, dwhw2, K, H},
      {nullptr, dh_pre, dbh, 1, H},    {a2, dza, dwzz, H, 2 * L},
      {nullptr, dza, dbzz, 1, 2 * L},  {w, dd_pre, dwdw, K, H},
      {zs, dd_pre, dwdz, L, H},        {nullptr, dd_pre, dbd, 1, H},
      {a3, dxh_pre, dwxh, H, D},       {nullptr, dxh_pre, dbxh, 1, D},
      {xp, dd_pre, dwdxp, D, H},  // last: dropped without use_x_prev
  };
  const int njobs = (int)(sizeof(jobs) / sizeof(jobs[0])) - (use_xp ? 0 : 1);
  return cvl::launch_wgrad<vae_dense_wgrad>(jobs, njobs, B, static_cast<cudaStream_t>(stream));
}
