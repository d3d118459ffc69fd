// Two-cell (encoder + decoder) cl_vrnn training kernels for Hopper (sm_90a), f32 and
// bf16 streams.
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_two_cell.py
//   * :272 `_fwd_call` -> `_fwd_kernel` :129 with `two_cell_fwd_kernel<S>` below;
//   * :408 `_bwd_call` -> `_bwd_kernel` :295 with `two_cell_bwd_kernel<S>` (the
//     serial reverse walk) followed by `wgrad_kernel<two_cell_wgrad>` (the
//     weight gradients, csrc/wgrad.cuh): one ported kernel, two launches.
// Both in the f32 mode (S = float) and in the bf16 stream mode
// (`compute_dtype=bf16`, S = __nv_bfloat16), described at the end of this note.
//
// What it computes, per batch row and time step t = 0 .. T-1:
//   ze = xe[t] @ We + be + h_e @ Rk_e;  (h_e, c_e) = gates(ze, c_e)
//   zargs = h_e @ Wz + bz;  z = zargs[:L] + exp(zargs[L:] / 2) * eps[t]
//   zd = xd[t] @ Wdx + bd + z @ Kz + h_d @ Rk_d;  (h_d, c_d) = gates(zd, c_d)
// with Keras-2.0 gates (i, f, c, o): hard sigmoid clip(0.2x + 0.5, 0, 1) for
// i, f, o, tanh for g and for the cell output. The forward emits hd, zargs and
// the residual streams (ze, zd, and h, c before and after each cell); the
// backward walks time in reverse, decoder step t then encoder step t (the
// decoder's z-head cotangent dh_e feeds the encoder at the same t, as the TPU
// kernel's `dhez` hand-off does one grid step later), and emits dxe, dxd, the
// initial-state cotangents and every weight gradient.
//
// What bounds it on this card. At the jsball_vrnn4 training shape (B=200,
// T=16, H=256, L=8, input widths 101) the forward is ~4.8 GFLOP and the
// backward ~9.5 GFLOP of f32 FMAs against a few tens of MB of streams, so the
// operations bound both (~0.07 and ~0.14 ms at 67 TFLOP/s without tensor
// cores). But each step depends on the one before, so the T steps of the
// recurrences run in series.
//
// What the design does about it.
// * Time is serial, rows are independent: one block owns a tile of kRows batch
//   rows and runs the whole time loop itself (the TPU grid walked time in
//   order with the state in VMEM scratch; CUDA blocks run in no order and
//   carry nothing between them). h, c and z of both cells, the step's inputs
//   and the backward's carries live in shared memory, stored [unit][row] so
//   that one float4 load gives the tile's four operands.
// * The weights do not fit one SM. The TPU kernel keeps both recurrent
//   kernels resident in VMEM; at f32 H=256 they are 2 MiB plus 0.8 MiB of
//   input kernels, against 227 KB of shared memory. They are read from global
//   memory each step and stay resident in the 50 MB L2, stored so that
//   neighbouring threads read neighbouring columns.
// * The input projections xe @ We and xd @ Wdx are extra rows of the cell's
//   product, as in the TPU kernel's body; they are not a library matmul.
// * The weight gradients cross blocks. The TPU grid accumulated them in
//   resident blocks over a sequential grid; here concurrent blocks would need
//   atomics, which make the sums depend on launch order. So the serial pass
//   writes dz_e, dz_d, dzargs and z per (t, row) to scratch, and a second,
//   deterministic pass forms sum hpᵀdz, xᵀdz, zᵀdz_d, heᵀdzargs and the column
//   sums over the B*T rows, each output element summed in row order by one
//   thread.
// * The hard-sigmoid derivative is 0.2 strictly inside (0, 1) and 0 at and
//   beyond the clip points, the TPU kernel's rule (`_bwd_gate_grads`).
// Known limits of this simple form: every block streams all weights from L2
// every step, and the products run on FFMA, not the tensor cores; splitting
// the weights across a cluster's SMs and wgmma are later work. Plain FFMA
// keeps f32 exact to the JAX side's precision="highest" (no TF32).

//
// The bf16 stream mode. As `two_cell_sequence` :558-581 casts them outside
// its custom vjp, the x streams (xe, xd) and the six weight matrices (We,
// Rk_e, Wdx, Rk_d, Kz, Wz) arrive in bf16; the biases, eps, the initial
// states and the c streams stay f32. Operands widen to f32 on load and the
// products stay FFMA with f32 sums; h, c, z and the carries live in shared
// memory in f32, so the shared-memory layout is the same in both modes.
// Rounding happens where the Pallas bodies round (`mm` :150 and :315 cast
// the left operand, `acc` :317 both):
// * h as an operand: the h tiles hold the rounded h, which is also the
//   hpe, he and hpd streams; the decoder's unrounded h is written to hd
//   (f32) before it is rounded. The gates read the unrounded z sums.
// * z (the sampled latent) as the operand of z @ Kz; zargs stays f32.
// * ze and zd as they are stored (the backward's gates read them rounded).
// * In the backward, dz_e, dz_d and dzargs as the operands of their serial
//   products (the tiles); dxe and dxd as stored. The dz scratch stays f32
//   and unrounded, because db sums the unrounded dz.
// * The six weight gradients: the weight-gradient pass rounds both operands
//   as it stages them, sums in f32 and stores C rounded, as bf16 (`bf16`
//   jobs of wgrad.cuh), as `_core_bwd` :514-516 casts the f32 sums; the
//   bias sums take no flag. An f32 launch has no flagged job, so it keeps
//   the flag-free instance of the weight-gradient kernel.
// bf16 halves the L2 stream of the weights; the FMAs still run at the f32
// rate, so the bf16 tensor-core bound is ~15x below this form's reach.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "wgrad.cuh"

namespace {

constexpr int kRows = 4;                    // batch rows per block (one float4 of operands)
constexpr int kThreads = 512;               // threads per block
constexpr int kSlices = 2;                  // a product's K is split between two groups
constexpr int kUnits = kThreads / kSlices;  // output columns per pass
constexpr int kWarps = kThreads / 32;

// S is the stream type: float, or __nv_bfloat16 in the bf16 mode
template <typename S>
struct FwdArgs {
  const S* xe;        // [T, B, INe]  x || w
  const S* xd;        // [T, B, INd]  [x_prev ||] w
  const float* eps;   // [T, B, L]
  const S* we;        // [INe, 4H]
  const float* be;    // [4H]
  const S* rke;       // [H, 4H]
  const S* wdx;       // [INd, 4H]
  const float* bd;    // [4H]
  const S* rkd;       // [H, 4H]
  const S* kz;        // [L, 4H]
  const S* wz_t;      // [2L, H]  Z_mean | Z_log_var kernels, transposed
  const float* bz;    // [2L]
  const float *h0e, *c0e, *h0d, *c0d;  // [B, H]
  float* hd;     // [T, B, H]
  float* zargs;  // [T, B, 2L]
  S *ze, *zd;                           // [T, B, 4H]
  S* hpe;                               // [T, B, H]
  float *cpe, *ce;                      // [T, B, H]
  S *he, *hpd;                          // [T, B, H]
  float *cpd, *cd;                      // [T, B, H]
  int T, B, INe, INd, H, L;
};

template <typename S>
struct BwdArgs {
  const S *ze, *zd;                              // [T, B, 4H]
  const float *cpe, *ce, *cpd, *cd;              // [T, B, H]
  const float* eps;                              // [T, B, L]
  const float* zargs;                            // [T, B, 2L]
  const float* dhd;                              // [T, B, H]
  const float* dzargs;                           // [T, B, 2L]
  const S* wd_t;  // [4H, H + INd + L]  (Rk_d | Wdx | Kz) transposed
  const S* we_t;  // [4H, H + INe]      (Rk_e | We) transposed
  const S* wz;    // [H, 2L]
  S *dxe, *dxd;                          // [T, B, INe], [T, B, INd]
  float *dh0e, *dc0e, *dh0d, *dc0d;      // [B, H]
  float *dz_e, *dz_d;                    // scratch [T, B, 4H], unrounded
  float *dza;                            // scratch [T, B, 2L], unrounded
  float *zs;                             // scratch [T, B, L]
  int T, B, INe, INd, H, L;
};

__host__ __device__ constexpr size_t fwd_smem_floats(int INe, int INd, int H, int L) {
  return (size_t)(INe + INd + 6 * H + L) * kRows + (size_t)4 * kRows * kUnits;
}

__host__ __device__ constexpr size_t bwd_smem_floats(int H, int L) {
  return (size_t)(4 * H + 5 * H + 3 * L) * kRows + (size_t)kRows * kUnits;
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
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ldv(const float* p) { return *p; }
__device__ __forceinline__ float ldv(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// the value a product's operand takes in the stream type's mode
template <typename S>
__device__ __forceinline__ float operand(float x) { return x; }
template <>
__device__ __forceinline__ float operand<__nv_bfloat16>(float x) {
  return cvl::round_bf16(x);
}

// rows [k0, k1) of a [K][kRows] shared-memory operand times a [K, 4H] weight,
// accumulated into the four gate columns (i, f, c, o) of unit u
template <typename S>
__device__ __forceinline__ void mac_gates(float (&acc)[4][kRows], const float* a,
                                          const S* __restrict__ w, int K, int u, int H,
                                          int slice) {
  const int k0 = slice ? K / 2 : 0, k1 = slice ? K : K / 2;
  const S* wp = w + (size_t)k0 * 4 * H + u;
#pragma unroll 8
  for (int k = k0; k < k1; ++k, wp += 4 * H) {
    const float w0 = ld(wp), w1 = ld(wp + H), w2 = ld(wp + 2 * H), w3 = ld(wp + 3 * H);
    const float4 v = *reinterpret_cast<const float4*>(a + k * kRows);
    const float av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      acc[0][b] = fmaf(av[b], w0, acc[0][b]);
      acc[1][b] = fmaf(av[b], w1, acc[1][b]);
      acc[2][b] = fmaf(av[b], w2, acc[2][b]);
      acc[3][b] = fmaf(av[b], w3, acc[3][b]);
    }
  }
}

// In lane b < kRows: sum_k a[k][b] * wrow[k]; the warp's lanes split k and a
// shuffle butterfly adds their partial sums.
template <typename S>
__device__ __forceinline__ float warp_dot(const float* a, const S* __restrict__ wrow, int K,
                                          int lane) {
  float s[kRows] = {0.f, 0.f, 0.f, 0.f};
  for (int k = lane; k < K; k += 32) {
    const float w = ld(wrow + k);
    const float4 v = *reinterpret_cast<const float4*>(a + k * kRows);
    s[0] = fmaf(v.x, w, s[0]);
    s[1] = fmaf(v.y, w, s[1]);
    s[2] = fmaf(v.z, w, s[2]);
    s[3] = fmaf(v.w, w, s[3]);
  }
  float mine = 0.f;
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[b] += __shfl_xor_sync(0xffffffffu, s[b], off);
    if (lane == b) mine = s[b];
  }
  return mine;
}

// Where one cell writes its step: global pointers already offset to step t.
// HO is the type of the cell's h output: the encoder's he is a stream (S),
// the decoder's hd an f32 output.
template <typename S, typename HO>
struct CellOut {
  S *z, *hp;        // z [B, 4H], hp [B, H]
  float *cp, *c;    // [B, H]
  HO* h;            // [B, H]
};

// One LSTM cell step for the block's rows: z = bias + the operand products
// (up to three operands), then the gates. Reads h_cur through the operands,
// writes the new h to h_nxt (rounded to the stream type: it is only ever an
// operand) and, unrounded, to out.h; c is updated in place. Each unit's K is
// split between the two slices; slice 1 hands its partial sums to slice 0
// through `part`.
template <typename S, typename HO>
__device__ __forceinline__ void lstm_cell(int H, int B, int s0, const float* bias,
                                          const float* x0, const S* w0, int k0,
                                          const float* x1, const S* w1, int k1,
                                          const float* x2, const S* w2, int k2,
                                          const float* h_cur, float* h_nxt, float* c,
                                          float* part, const CellOut<S, HO>& out) {
  const int slice = threadIdx.x / kUnits, lu = threadIdx.x % kUnits;
  for (int u0 = 0; u0 < H; u0 += kUnits) {  // uniform trip count: syncs inside
    const int u = u0 + lu;
    float acc[4][kRows];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float bg = (slice == 0 && u < H) ? bias[g * H + u] : 0.f;
#pragma unroll
      for (int b = 0; b < kRows; ++b) acc[g][b] = bg;
    }
    if (u < H) {
      mac_gates(acc, x0, w0, k0, u, H, slice);
      if (k1) mac_gates(acc, x1, w1, k1, u, H, slice);
      if (k2) mac_gates(acc, x2, w2, k2, u, H, slice);
      if (slice == 1) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int b = 0; b < kRows; ++b) part[(g * kRows + b) * kUnits + lu] = acc[g][b];
      }
    }
    __syncthreads();
    if (slice == 0 && u < H) {
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g] = acc[g][b] + part[(g * kRows + b) * kUnits + lu];
        const float i = hard_sigmoid(z[0]);
        const float f = hard_sigmoid(z[1]);
        const float gg = tanhf(z[2]);
        const float o = hard_sigmoid(z[3]);
        const float cp = c[u * kRows + b];
        const float cn = f * cp + i * gg;
        const float hn = o * tanhf(cn);
        c[u * kRows + b] = cn;
        h_nxt[u * kRows + b] = operand<S>(hn);
        const int s = s0 + b;
        if (s < B) {
          const size_t r = (size_t)s * H + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) st(out.z + (size_t)s * 4 * H + g * H + u, z[g]);
          st(out.hp + r, h_cur[u * kRows + b]);
          out.cp[r] = cp;
          out.c[r] = cn;
          st(out.h + r, hn);
        }
      }
    }
    __syncthreads();
  }
}

struct Keep {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};
template <typename S>
struct AsOperand {
  __device__ __forceinline__ float operator()(float x) const { return operand<S>(x); }
};

// rows s0 .. s0+kRows-1 of a [B, W] matrix into a [W][kRows] shared tile,
// each value through `op` (rows >= B are zero)
template <typename T, typename Op = Keep>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int B, int s0, int W,
                                          Op op = Op()) {
  for (int i = threadIdx.x; i < W * kRows; i += kThreads) {
    const int b = i / W, k = i - b * W, s = s0 + b;
    dst[k * kRows + b] = s < B ? op(ldv(src + (size_t)s * W + k)) : 0.f;
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads) two_cell_fwd_kernel(const FwdArgs<S> a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int T = a.T, B = a.B, H = a.H, L = a.L, INe = a.INe, INd = a.INd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* xes = sm;                       // [INe][kRows]
  float* xds = xes + INe * kRows;        // [INd][kRows]
  float* he_cur = xds + INd * kRows;     // [H][kRows] each; h as an operand
  float* he_nxt = he_cur + H * kRows;
  float* ce = he_nxt + H * kRows;
  float* hd_cur = ce + H * kRows;
  float* hd_nxt = hd_cur + H * kRows;
  float* cd = hd_nxt + H * kRows;
  float* zsm = cd + H * kRows;           // [L][kRows]  z as the operand of z @ Kz
  float* part = zsm + L * kRows;         // [4][kRows][kUnits]
  const int s0 = blockIdx.x * kRows;     // rows >= B are masked

  load_rows(he_cur, a.h0e, B, s0, H, AsOperand<S>());
  load_rows(ce, a.c0e, B, s0, H);
  load_rows(hd_cur, a.h0d, B, s0, H, AsOperand<S>());
  load_rows(cd, a.c0d, B, s0, H);

  for (int t = 0; t < T; ++t) {
    const size_t tb = (size_t)t * B;
    load_rows(xes, a.xe + tb * INe, B, s0, INe);
    load_rows(xds, a.xd + tb * INd, B, s0, INd);
    __syncthreads();
    // encoder cell t: ze = be + xe[t] @ We + h_e @ Rk_e
    const CellOut<S, S> eo{a.ze + tb * 4 * H, a.hpe + tb * H, a.cpe + tb * H, a.ce + tb * H,
                           a.he + tb * H};
    lstm_cell(H, B, s0, a.be, xes, a.we, INe, he_cur, a.rke, H, nullptr, (const S*)nullptr, 0,
              he_cur, he_nxt, ce, part, eo);
    // packed z heads and the reparameterized draw, one warp per latent
    for (int l = warp; l < L; l += kWarps) {
      const float zm = warp_dot(he_nxt, a.wz_t + (size_t)l * H, H, lane) + a.bz[l];
      const float zv = warp_dot(he_nxt, a.wz_t + (size_t)(L + l) * H, H, lane) + a.bz[L + l];
      const int s = s0 + lane;
      if (lane < kRows) {
        float z = 0.f;
        if (s < B) {
          const size_t r = tb + s;
          a.zargs[r * 2 * L + l] = zm;
          a.zargs[r * 2 * L + L + l] = zv;
          z = zm + expf(zv / 2.f) * a.eps[r * L + l];
        }
        zsm[l * kRows + lane] = operand<S>(z);
      }
    }
    __syncthreads();
    // decoder cell t: zd = bd + h_d @ Rk_d + z @ Kz + xd[t] @ Wdx
    const CellOut<S, float> dout{a.zd + tb * 4 * H, a.hpd + tb * H, a.cpd + tb * H,
                                 a.cd + tb * H, a.hd + tb * H};
    lstm_cell(H, B, s0, a.bd, hd_cur, a.rkd, H, zsm, a.kz, L, xds, a.wdx, INd,
              hd_cur, hd_nxt, cd, part, dout);
    float* tmp = he_cur; he_cur = he_nxt; he_nxt = tmp;
    tmp = hd_cur; hd_cur = hd_nxt; hd_nxt = tmp;
  }
}

// out(n, b) = sum_k a[k][b] * wt[k * N + n] for n in [0, N): a [K][kRows] in
// shared memory times a [K, N] weight; neighbouring threads read
// neighbouring columns. `store(n, b, value)` receives each result.
template <typename S, typename Store>
__device__ __forceinline__ void matvec_t(const float* a, const S* __restrict__ wt, int K,
                                         int N, float* part, Store store) {
  const int slice = threadIdx.x / kUnits, ln = threadIdx.x % kUnits;
  const int k0 = slice ? K / 2 : 0, k1 = slice ? K : K / 2;
  for (int n0 = 0; n0 < N; n0 += kUnits) {  // uniform trip count: syncs inside
    const int n = n0 + ln;
    float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
    if (n < N) {
      const S* wp = wt + (size_t)k0 * N + n;
#pragma unroll 8
      for (int k = k0; k < k1; ++k, wp += N) {
        const float w = ld(wp);
        const float4 v = *reinterpret_cast<const float4*>(a + k * kRows);
        acc[0] = fmaf(v.x, w, acc[0]);
        acc[1] = fmaf(v.y, w, acc[1]);
        acc[2] = fmaf(v.z, w, acc[2]);
        acc[3] = fmaf(v.w, w, acc[3]);
      }
      if (slice == 1) {
#pragma unroll
        for (int b = 0; b < kRows; ++b) part[b * kUnits + ln] = acc[b];
      }
    }
    __syncthreads();
    if (slice == 0 && n < N) {
#pragma unroll
      for (int b = 0; b < kRows; ++b) store(n, b, acc[b] + part[b * kUnits + ln]);
    }
    __syncthreads();
  }
}

// Gate gradients of one cell step for the block's rows (`_bwd_gate_grads`):
// dh = dh_carry + dh_in, dc = dc_carry; writes dz to the global scratch
// (unrounded) and, as an operand, to the shared tile, and dc * f back to the
// carry. z_t is the stored (in the bf16 mode rounded) pre-activation.
template <typename S>
__device__ __forceinline__ void gate_grads(int H, int B, int s0, const S* z_t,
                                           const float* c_t, const float* cp_t,
                                           const float* dh_carry, const float* dh_in,
                                           float* dc_carry, float* dzs, float* dz_out) {
  for (int i = threadIdx.x; i < H * kRows; i += kThreads) {
    const int u = i / kRows, b = i - u * kRows, s = s0 + b;
    float dz[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < B) {
      const size_t r = (size_t)s * H + u;
      const S* zr = z_t + (size_t)s * 4 * H;
      const float ig = hard_sigmoid(ldv(zr + u));
      const float fg = hard_sigmoid(ldv(zr + H + u));
      const float gg = tanhf(ldv(zr + 2 * H + u));
      const float og = hard_sigmoid(ldv(zr + 3 * H + u));
      const float tc = tanhf(c_t[r]);
      const float dh = dh_carry[u * kRows + b] + dh_in[i];
      const float dc = dc_carry[u * kRows + b] + dh * og * (1.f - tc * tc);
      dz[0] = dc * gg * hard_sigmoid_grad(ig);
      dz[1] = dc * cp_t[r] * hard_sigmoid_grad(fg);
      dz[2] = dc * ig * (1.f - gg * gg);
      dz[3] = dh * tc * hard_sigmoid_grad(og);
      dc_carry[u * kRows + b] = dc * fg;
#pragma unroll
      for (int g = 0; g < 4; ++g) dz_out[(size_t)s * 4 * H + g * H + u] = dz[g];
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) dzs[(g * H + u) * kRows + b] = operand<S>(dz[g]);
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads) two_cell_bwd_kernel(const BwdArgs<S> a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int T = a.T, B = a.B, H = a.H, L = a.L, INe = a.INe, INd = a.INd;
  float* dzs = sm;                    // [4H][kRows]  dz as an operand
  float* dh_e = dzs + 4 * H * kRows;  // [H][kRows] each
  float* dc_e = dh_e + H * kRows;
  float* dh_d = dc_e + H * kRows;
  float* dc_d = dh_d + H * kRows;
  float* dh_in = dc_d + H * kRows;    // this step's incoming dh, [H][kRows]
  float* dzz = dh_in + H * kRows;     // [L][kRows]   cotangent of z
  float* dzas = dzz + L * kRows;      // [2L][kRows]  cotangent of zargs, as an operand
  float* part = dzas + 2 * L * kRows; // [kRows][kUnits]
  const int s0 = blockIdx.x * kRows;
  for (int i = threadIdx.x; i < 4 * H * kRows; i += kThreads) dh_e[i] = 0.f;  // 4 carries
  __syncthreads();

  const int Nd = H + INd + L, Ne = H + INe;
  for (int t = T - 1; t >= 0; --t) {
    const size_t tb = (size_t)t * B;
    // ---- decoder step t: dh = carry + dhd[t]
    for (int i = threadIdx.x; i < H * kRows; i += kThreads) {
      const int u = i / kRows, b = i - u * kRows, s = s0 + b;
      dh_in[i] = s < B ? a.dhd[(tb + s) * H + u] : 0.f;
    }
    __syncthreads();
    gate_grads(H, B, s0, a.zd + tb * 4 * H, a.cd + tb * H, a.cpd + tb * H, dh_d, dh_in, dc_d,
               dzs, a.dz_d + tb * 4 * H);
    __syncthreads();
    // dz_d @ (Rk_d | Wdx | Kz)ᵀ: the new dh_d carry, dxd[t] and dz
    matvec_t(dzs, a.wd_t, 4 * H, Nd, part, [&](int n, int b, float v) {
      const int s = s0 + b;
      if (n < H) {
        dh_d[n * kRows + b] = v;
      } else if (n < H + INd) {
        if (s < B) st(a.dxd + (tb + s) * INd + (n - H), v);
      } else {
        dzz[(n - H - INd) * kRows + b] = v;
      }
    });
    // z sample backward: z = zm + exp(zlv / 2) * eps, plus the incoming dzargs
    for (int i = threadIdx.x; i < L * kRows; i += kThreads) {
      const int l = i / kRows, b = i - l * kRows, s = s0 + b;
      float dzm = 0.f, dzlv = 0.f;
      if (s < B) {
        const size_t r = tb + s;
        const float zv = a.zargs[r * 2 * L + L + l];
        const float sig = expf(zv / 2.f);
        const float e = a.eps[r * L + l];
        const float dz = dzz[l * kRows + b];
        dzm = dz + a.dzargs[r * 2 * L + l];
        dzlv = dz * e * sig * 0.5f + a.dzargs[r * 2 * L + L + l];
        a.dza[r * 2 * L + l] = dzm;
        a.dza[r * 2 * L + L + l] = dzlv;
        a.zs[r * L + l] = a.zargs[r * 2 * L + l] + sig * e;
      }
      dzas[l * kRows + b] = operand<S>(dzm);
      dzas[(L + l) * kRows + b] = operand<S>(dzlv);
    }
    __syncthreads();
    // z-head backward: the encoder's incoming dh = dzargs @ Wzᵀ
    for (int i = threadIdx.x; i < H * kRows; i += kThreads) {
      const int u = i / kRows, b = i - u * kRows;
      const S* wr = a.wz + (size_t)u * 2 * L;
      float v = 0.f;
      for (int j = 0; j < 2 * L; ++j) v = fmaf(dzas[j * kRows + b], ld(wr + j), v);
      dh_in[i] = v;
    }
    __syncthreads();
    // ---- encoder step t
    gate_grads(H, B, s0, a.ze + tb * 4 * H, a.ce + tb * H, a.cpe + tb * H, dh_e, dh_in, dc_e,
               dzs, a.dz_e + tb * 4 * H);
    __syncthreads();
    // dz_e @ (Rk_e | We)ᵀ: the new dh_e carry and dxe[t]
    matvec_t(dzs, a.we_t, 4 * H, Ne, part, [&](int n, int b, float v) {
      const int s = s0 + b;
      if (n < H) {
        dh_e[n * kRows + b] = v;
      } else if (s < B) {
        st(a.dxe + (tb + s) * INe + (n - H), v);
      }
    });
  }
  for (int i = threadIdx.x; i < H * kRows; i += kThreads) {
    const int u = i / kRows, b = i - u * kRows, s = s0 + b;
    if (s < B) {
      const size_t r = (size_t)s * H + u;
      a.dh0e[r] = dh_e[i];
      a.dc0e[r] = dc_e[i];
      a.dh0d[r] = dh_d[i];
      a.dc0d[r] = dc_d[i];
    }
  }
}

struct two_cell_wgrad {};  // names this source's copy of cvl::wgrad_kernel

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename S>
int fwd(const FwdArgs<S>& a, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(a.INe, a.INd, a.H, a.L) * sizeof(float);
  int err = set_smem((const void*)two_cell_fwd_kernel<S>, smem);
  if (err) return err;
  two_cell_fwd_kernel<S><<<(a.B + kRows - 1) / kRows, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename S>
int bwd(const BwdArgs<S>& a, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats(a.H, a.L) * sizeof(float);
  int err = set_smem((const void*)two_cell_bwd_kernel<S>, smem);
  if (err) return err;
  two_cell_bwd_kernel<S><<<(a.B + kRows - 1) / kRows, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The nine jobs of the weight-gradient pass over the R = T*B rows; `bf16`
// flags the six matrix gradients of the bf16 mode (the stored streams hpe,
// xe, hpd, xd and he are bf16 there, z is not).
int wgrad(const void* hpe, const void* xe, const float* dz_e, const void* hpd, const void* xd,
          const float* zs, const float* dz_d, const void* he, const float* dza, void* drke,
          void* dwe, float* dbe, void* drkd, void* dwdx, void* dkz, float* dbd, void* dwz,
          float* dbz, int R, int INe, int INd, int H, int L, int bf16, cudaStream_t stream) {
  const int b = bf16;
  const cvl::WgradJob jobs[] = {
      {hpe, dz_e, drke, H, 4 * H, b, b},   {xe, dz_e, dwe, INe, 4 * H, b, b},
      {nullptr, dz_e, dbe, 1, 4 * H},      {hpd, dz_d, drkd, H, 4 * H, b, b},
      {xd, dz_d, dwdx, INd, 4 * H, b, b},  {zs, dz_d, dkz, L, 4 * H, b, 0},
      {nullptr, dz_d, dbd, 1, 4 * H},      {he, dza, dwz, H, 2 * L, b, b},
      {nullptr, dza, dbz, 1, 2 * L},
  };
  return cvl::launch_wgrad<two_cell_wgrad>(jobs, (int)(sizeof(jobs) / sizeof(jobs[0])), R,
                                           stream);
}

}  // namespace

// Bytes of dynamic shared memory one block of each serial kernel needs (the
// wrapper checks them against the card's limit); the same in both modes.
extern "C" long long cvl_two_cell_fwd_smem_bytes(int INe, int INd, int H, int L) {
  return (long long)(fwd_smem_floats(INe, INd, H, L) * sizeof(float));
}
extern "C" long long cvl_two_cell_bwd_smem_bytes(int H, int L) {
  return (long long)(bwd_smem_floats(H, L) * sizeof(float));
}

// The forward on `stream`; returns the cudaError_t of the launch.
extern "C" int cvl_two_cell_fwd(
    const float* xe, const float* xd, const float* eps, const float* we, const float* be,
    const float* rke, const float* wdx, const float* bd, const float* rkd, const float* kz,
    const float* wz_t, const float* bz, const float* h0e, const float* c0e, const float* h0d,
    const float* c0d, float* hd, float* zargs, float* ze, float* zd, float* hpe, float* cpe,
    float* ce, float* he, float* hpd, float* cpd, float* cd, int T, int B, int INe, int INd,
    int H, int L, void* stream) {
  const FwdArgs<float> a{xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz_t, bz, h0e, c0e, h0d,
                         c0d, hd, zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd,
                         T, B, INe, INd, H, L};
  return fwd(a, static_cast<cudaStream_t>(stream));
}

// The same in the bf16 stream mode: xe, xd, the six weights (we, rke, wdx,
// rkd, kz, wz_t) and ze, zd, hpe, he, hpd are bf16; eps, the biases, the
// initial states, hd, zargs and the c streams f32.
extern "C" int cvl_two_cell_fwd_bf16(
    const void* xe, const void* xd, const float* eps, const void* we, const float* be,
    const void* rke, const void* wdx, const float* bd, const void* rkd, const void* kz,
    const void* wz_t, const float* bz, const float* h0e, const float* c0e, const float* h0d,
    const float* c0d, float* hd, float* zargs, void* ze, void* zd, void* hpe, float* cpe,
    float* ce, void* he, void* hpd, float* cpd, float* cd, int T, int B, int INe, int INd,
    int H, int L, void* stream) {
  using bf = __nv_bfloat16;
  const auto in = [](const void* p) { return static_cast<const bf*>(p); };
  const auto out = [](void* p) { return static_cast<bf*>(p); };
  const FwdArgs<bf> a{in(xe), in(xd), eps, in(we), be, in(rke), in(wdx), bd, in(rkd), in(kz),
                      in(wz_t), bz, h0e, c0e, h0d, c0d, hd, zargs, out(ze), out(zd), out(hpe),
                      cpe, ce, out(he), out(hpd), cpd, cd, T, B, INe, INd, H, L};
  return fwd(a, static_cast<cudaStream_t>(stream));
}

// The backward's serial reverse walk on `stream`; fills dxe, dxd, the
// initial-state cotangents and the scratch (dz_e, dz_d, dza, zs) that
// cvl_two_cell_wgrad reduces. Returns the cudaError_t of the launch.
extern "C" int cvl_two_cell_bwd(
    const float* ze, const float* zd, const float* cpe, const float* ce, const float* cpd,
    const float* cd, const float* eps, const float* zargs, const float* dhd,
    const float* dzargs, const float* wd_t, const float* we_t, const float* wz, float* dxe,
    float* dxd, float* dh0e, float* dc0e, float* dh0d, float* dc0d, float* dz_e, float* dz_d,
    float* dza, float* zs, int T, int B, int INe, int INd, int H, int L, void* stream) {
  const BwdArgs<float> a{ze, zd, cpe, ce, cpd, cd, eps, zargs, dhd, dzargs, wd_t, we_t, wz,
                         dxe, dxd, dh0e, dc0e, dh0d, dc0d, dz_e, dz_d, dza, zs,
                         T, B, INe, INd, H, L};
  return bwd(a, static_cast<cudaStream_t>(stream));
}

// The same in the bf16 stream mode: ze, zd, the transposed weights (wd_t,
// we_t, wz) and dxe, dxd are bf16; the scratch stays f32 and unrounded.
extern "C" int cvl_two_cell_bwd_bf16(
    const void* ze, const void* zd, const float* cpe, const float* ce, const float* cpd,
    const float* cd, const float* eps, const float* zargs, const float* dhd,
    const float* dzargs, const void* wd_t, const void* we_t, const void* wz, void* dxe,
    void* dxd, float* dh0e, float* dc0e, float* dh0d, float* dc0d, float* dz_e, float* dz_d,
    float* dza, float* zs, int T, int B, int INe, int INd, int H, int L, void* stream) {
  using bf = __nv_bfloat16;
  const auto in = [](const void* p) { return static_cast<const bf*>(p); };
  const BwdArgs<bf> a{in(ze), in(zd), cpe, ce, cpd, cd, eps, zargs, dhd, dzargs, in(wd_t),
                      in(we_t), in(wz), static_cast<bf*>(dxe), static_cast<bf*>(dxd), dh0e,
                      dc0e, dh0d, dc0d, dz_e, dz_d, dza, zs, T, B, INe, INd, H, L};
  return bwd(a, static_cast<cudaStream_t>(stream));
}

// The backward's weight gradients over the R = T*B rows of the scratch, one
// launch; returns the cudaError_t of the launch.
extern "C" int cvl_two_cell_wgrad(
    const float* hpe, const float* xe, const float* dz_e, const float* hpd, const float* xd,
    const float* zs, const float* dz_d, const float* he, const float* dza, float* drke,
    float* dwe, float* dbe, float* drkd, float* dwdx, float* dkz, float* dbd, float* dwz,
    float* dbz, int R, int INe, int INd, int H, int L, void* stream) {
  return wgrad(hpe, xe, dz_e, hpd, xd, zs, dz_d, he, dza, drke, dwe, dbe, drkd, dwdx, dkz, dbd,
               dwz, dbz, R, INe, INd, H, L, 0, static_cast<cudaStream_t>(stream));
}

// The same in the bf16 stream mode: hpe, xe, hpd, xd and he are bf16, the dz
// scratch and z are rounded as they are staged; the six weight gradients are
// stored rounded, as bf16, and the three bias sums take the unrounded dz.
extern "C" int cvl_two_cell_wgrad_bf16(
    const void* hpe, const void* xe, const float* dz_e, const void* hpd, const void* xd,
    const float* zs, const float* dz_d, const void* he, const float* dza, void* drke,
    void* dwe, float* dbe, void* drkd, void* dwdx, void* dkz, float* dbd, void* dwz,
    float* dbz, int R, int INe, int INd, int H, int L, void* stream) {
  return wgrad(hpe, xe, dz_e, hpd, xd, zs, dz_d, he, dza, drke, dwe, dbe, drkd, dwdx, dkz, dbd,
               dwz, dbz, R, INe, INd, H, L, 1, static_cast<cudaStream_t>(stream));
}
