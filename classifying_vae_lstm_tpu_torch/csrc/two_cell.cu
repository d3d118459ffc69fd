// Two-cell (encoder + decoder) cl_vrnn training kernels for Hopper (sm_90a), f32.
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_two_cell.py
//   * :272 `_fwd_call` -> `_fwd_kernel` :129 with `two_cell_fwd_kernel` below;
//   * :408 `_bwd_call` -> `_bwd_kernel` :295 with `two_cell_bwd_kernel` (the
//     serial reverse walk) followed by `wgrad_kernel<two_cell_wgrad>` (the
//     weight gradients, csrc/wgrad.cuh): one ported kernel, two launches.
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

#include <cuda_runtime.h>
#include <stddef.h>

#include "wgrad.cuh"

namespace {

constexpr int kRows = 4;                    // batch rows per block (one float4 of operands)
constexpr int kThreads = 512;               // threads per block
constexpr int kSlices = 2;                  // a product's K is split between two groups
constexpr int kUnits = kThreads / kSlices;  // output columns per pass
constexpr int kWarps = kThreads / 32;

struct FwdArgs {
  const float* xe;    // [T, B, INe]  x || w
  const float* xd;    // [T, B, INd]  [x_prev ||] w
  const float* eps;   // [T, B, L]
  const float* we;    // [INe, 4H]
  const float* be;    // [4H]
  const float* rke;   // [H, 4H]
  const float* wdx;   // [INd, 4H]
  const float* bd;    // [4H]
  const float* rkd;   // [H, 4H]
  const float* kz;    // [L, 4H]
  const float* wz_t;  // [2L, H]  Z_mean | Z_log_var kernels, transposed
  const float* bz;    // [2L]
  const float *h0e, *c0e, *h0d, *c0d;  // [B, H]
  float* hd;     // [T, B, H]
  float* zargs;  // [T, B, 2L]
  float *ze, *zd;                       // [T, B, 4H]
  float *hpe, *cpe, *ce, *he;           // [T, B, H]
  float *hpd, *cpd, *cd;                // [T, B, H]
  int T, B, INe, INd, H, L;
};

struct BwdArgs {
  const float *ze, *zd;                          // [T, B, 4H]
  const float *cpe, *ce, *cpd, *cd;              // [T, B, H]
  const float* eps;                              // [T, B, L]
  const float* zargs;                            // [T, B, 2L]
  const float* dhd;                              // [T, B, H]
  const float* dzargs;                           // [T, B, 2L]
  const float* wd_t;  // [4H, H + INd + L]  (Rk_d | Wdx | Kz) transposed
  const float* we_t;  // [4H, H + INe]      (Rk_e | We) transposed
  const float* wz;    // [H, 2L]
  float *dxe, *dxd;                      // [T, B, INe], [T, B, INd]
  float *dh0e, *dc0e, *dh0d, *dc0d;      // [B, H]
  float *dz_e, *dz_d;                    // scratch [T, B, 4H]
  float *dza;                            // scratch [T, B, 2L]
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

// rows [k0, k1) of a [K][kRows] shared-memory operand times a [K, 4H] weight,
// accumulated into the four gate columns (i, f, c, o) of unit u
__device__ __forceinline__ void mac_gates(float (&acc)[4][kRows], const float* a,
                                          const float* __restrict__ w, int K, int u, int H,
                                          int slice) {
  const int k0 = slice ? K / 2 : 0, k1 = slice ? K : K / 2;
  const float* wp = w + (size_t)k0 * 4 * H + u;
#pragma unroll 8
  for (int k = k0; k < k1; ++k, wp += 4 * H) {
    const float w0 = __ldg(wp), w1 = __ldg(wp + H), w2 = __ldg(wp + 2 * H),
                w3 = __ldg(wp + 3 * H);
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
__device__ __forceinline__ float warp_dot(const float* a, const float* __restrict__ wrow, int K,
                                          int lane) {
  float s[kRows] = {0.f, 0.f, 0.f, 0.f};
  for (int k = lane; k < K; k += 32) {
    const float w = __ldg(wrow + k);
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
struct CellOut {
  float *z, *hp, *cp, *c, *h;  // z [B, 4H]; the rest [B, H]
};

// One LSTM cell step for the block's rows: z = bias + the operand products
// (up to three operands), then the gates. Reads h_cur through the operands,
// writes the new h to h_nxt; c is updated in place. Each unit's K is split
// between the two slices; slice 1 hands its partial sums to slice 0 through
// `part`.
__device__ __forceinline__ void lstm_cell(int H, int B, int s0, const float* bias,
                                          const float* x0, const float* w0, int k0,
                                          const float* x1, const float* w1, int k1,
                                          const float* x2, const float* w2, int k2,
                                          const float* h_cur, float* h_nxt, float* c,
                                          float* part, const CellOut& out) {
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
        h_nxt[u * kRows + b] = hn;
        const int s = s0 + b;
        if (s < B) {
          const size_t r = (size_t)s * H + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) out.z[(size_t)s * 4 * H + g * H + u] = z[g];
          out.hp[r] = h_cur[u * kRows + b];
          out.cp[r] = cp;
          out.c[r] = cn;
          out.h[r] = hn;
        }
      }
    }
    __syncthreads();
  }
}

// rows s0 .. s0+kRows-1 of a [B, W] matrix into a [W][kRows] shared tile
// (rows >= B are zero)
__device__ __forceinline__ void load_rows(float* dst, const float* src, int B, int s0, int W) {
  for (int i = threadIdx.x; i < W * kRows; i += kThreads) {
    const int b = i / W, k = i - b * W, s = s0 + b;
    dst[k * kRows + b] = s < B ? src[(size_t)s * W + k] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads) two_cell_fwd_kernel(const FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int T = a.T, B = a.B, H = a.H, L = a.L, INe = a.INe, INd = a.INd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* xes = sm;                       // [INe][kRows]
  float* xds = xes + INe * kRows;        // [INd][kRows]
  float* he_cur = xds + INd * kRows;     // [H][kRows] each
  float* he_nxt = he_cur + H * kRows;
  float* ce = he_nxt + H * kRows;
  float* hd_cur = ce + H * kRows;
  float* hd_nxt = hd_cur + H * kRows;
  float* cd = hd_nxt + H * kRows;
  float* zsm = cd + H * kRows;           // [L][kRows]
  float* part = zsm + L * kRows;         // [4][kRows][kUnits]
  const int s0 = blockIdx.x * kRows;     // rows >= B are masked

  load_rows(he_cur, a.h0e, B, s0, H);
  load_rows(ce, a.c0e, B, s0, H);
  load_rows(hd_cur, a.h0d, B, s0, H);
  load_rows(cd, a.c0d, B, s0, H);

  for (int t = 0; t < T; ++t) {
    const size_t tb = (size_t)t * B;
    load_rows(xes, a.xe + tb * INe, B, s0, INe);
    load_rows(xds, a.xd + tb * INd, B, s0, INd);
    __syncthreads();
    // encoder cell t: ze = be + xe[t] @ We + h_e @ Rk_e
    const CellOut eo{a.ze + tb * 4 * H, a.hpe + tb * H, a.cpe + tb * H, a.ce + tb * H,
                     a.he + tb * H};
    lstm_cell(H, B, s0, a.be, xes, a.we, INe, he_cur, a.rke, H, nullptr, nullptr, 0,
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
        zsm[l * kRows + lane] = z;
      }
    }
    __syncthreads();
    // decoder cell t: zd = bd + h_d @ Rk_d + z @ Kz + xd[t] @ Wdx
    const CellOut dout{a.zd + tb * 4 * H, a.hpd + tb * H, a.cpd + tb * H, a.cd + tb * H,
                       a.hd + tb * H};
    lstm_cell(H, B, s0, a.bd, hd_cur, a.rkd, H, zsm, a.kz, L, xds, a.wdx, INd,
              hd_cur, hd_nxt, cd, part, dout);
    float* tmp = he_cur; he_cur = he_nxt; he_nxt = tmp;
    tmp = hd_cur; hd_cur = hd_nxt; hd_nxt = tmp;
  }
}

// out(n, b) = sum_k a[k][b] * wt[k * N + n] for n in [0, N): a [K][kRows] in
// shared memory times a [K, N] weight; neighbouring threads read
// neighbouring columns. `store(n, b, value)` receives each result.
template <typename Store>
__device__ __forceinline__ void matvec_t(const float* a, const float* __restrict__ wt, int K,
                                         int N, float* part, Store store) {
  const int slice = threadIdx.x / kUnits, ln = threadIdx.x % kUnits;
  const int k0 = slice ? K / 2 : 0, k1 = slice ? K : K / 2;
  for (int n0 = 0; n0 < N; n0 += kUnits) {  // uniform trip count: syncs inside
    const int n = n0 + ln;
    float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
    if (n < N) {
      const float* wp = wt + (size_t)k0 * N + n;
#pragma unroll 8
      for (int k = k0; k < k1; ++k, wp += N) {
        const float w = __ldg(wp);
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
// dh = dh_carry + dh_in, dc = dc_carry; writes dz to the shared tile and the
// global scratch, and dc * f back to the carry.
__device__ __forceinline__ void gate_grads(int H, int B, int s0, const float* z_t,
                                           const float* c_t, const float* cp_t,
                                           const float* dh_carry, const float* dh_in,
                                           float* dc_carry, float* dzs, float* dz_out) {
  for (int i = threadIdx.x; i < H * kRows; i += kThreads) {
    const int u = i / kRows, b = i - u * kRows, s = s0 + b;
    float dz[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < B) {
      const size_t r = (size_t)s * H + u;
      const float* zr = z_t + (size_t)s * 4 * H;
      const float ig = hard_sigmoid(zr[u]);
      const float fg = hard_sigmoid(zr[H + u]);
      const float gg = tanhf(zr[2 * H + u]);
      const float og = hard_sigmoid(zr[3 * H + u]);
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
    for (int g = 0; g < 4; ++g) dzs[(g * H + u) * kRows + b] = dz[g];
  }
}

__global__ void __launch_bounds__(kThreads) two_cell_bwd_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int T = a.T, B = a.B, H = a.H, L = a.L, INe = a.INe, INd = a.INd;
  float* dzs = sm;                    // [4H][kRows]
  float* dh_e = dzs + 4 * H * kRows;  // [H][kRows] each
  float* dc_e = dh_e + H * kRows;
  float* dh_d = dc_e + H * kRows;
  float* dc_d = dh_d + H * kRows;
  float* dh_in = dc_d + H * kRows;    // this step's incoming dh, [H][kRows]
  float* dzz = dh_in + H * kRows;     // [L][kRows]   cotangent of z
  float* dzas = dzz + L * kRows;      // [2L][kRows]  cotangent of zargs
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
        if (s < B) a.dxd[(tb + s) * INd + (n - H)] = v;
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
      dzas[l * kRows + b] = dzm;
      dzas[(L + l) * kRows + b] = dzlv;
    }
    __syncthreads();
    // z-head backward: the encoder's incoming dh = dzargs @ Wzᵀ
    for (int i = threadIdx.x; i < H * kRows; i += kThreads) {
      const int u = i / kRows, b = i - u * kRows;
      const float* wr = a.wz + (size_t)u * 2 * L;
      float v = 0.f;
      for (int j = 0; j < 2 * L; ++j) v = fmaf(dzas[j * kRows + b], __ldg(wr + j), v);
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
        a.dxe[(tb + s) * INe + (n - H)] = v;
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

}  // namespace

// Bytes of dynamic shared memory one block of each serial kernel needs (the
// wrapper checks them against the card's limit).
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
  const FwdArgs a{xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz_t, bz, h0e, c0e, h0d, c0d,
                  hd, zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd, T, B, INe, INd, H, L};
  const size_t smem = fwd_smem_floats(INe, INd, H, L) * sizeof(float);
  int err = set_smem((const void*)two_cell_fwd_kernel, smem);
  if (err) return err;
  two_cell_fwd_kernel<<<(B + kRows - 1) / kRows, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
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
  const BwdArgs a{ze, zd, cpe, ce, cpd, cd, eps, zargs, dhd, dzargs, wd_t, we_t, wz,
                  dxe, dxd, dh0e, dc0e, dh0d, dc0d, dz_e, dz_d, dza, zs, T, B, INe, INd, H, L};
  const size_t smem = bwd_smem_floats(H, L) * sizeof(float);
  int err = set_smem((const void*)two_cell_bwd_kernel, smem);
  if (err) return err;
  two_cell_bwd_kernel<<<(B + kRows - 1) / kRows, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The backward's weight gradients over the R = T*B rows of the scratch, one
// launch; returns the cudaError_t of the launch.
extern "C" int cvl_two_cell_wgrad(
    const float* hpe, const float* xe, const float* dz_e, const float* hpd, const float* xd,
    const float* zs, const float* dz_d, const float* he, const float* dza, float* drke,
    float* dwe, float* dbe, float* drkd, float* dwdx, float* dkz, float* dbd, float* dwz,
    float* dbz, int R, int INe, int INd, int H, int L, void* stream) {
  const cvl::WgradJob jobs[] = {
      {hpe, dz_e, drke, H, 4 * H},   {xe, dz_e, dwe, INe, 4 * H}, {nullptr, dz_e, dbe, 1, 4 * H},
      {hpd, dz_d, drkd, H, 4 * H},   {xd, dz_d, dwdx, INd, 4 * H}, {zs, dz_d, dkz, L, 4 * H},
      {nullptr, dz_d, dbd, 1, 4 * H}, {he, dza, dwz, H, 2 * L},    {nullptr, dza, dbz, 1, 2 * L},
  };
  return cvl::launch_wgrad<two_cell_wgrad>(jobs, (int)(sizeof(jobs) / sizeof(jobs[0])), R,
                                           static_cast<cudaStream_t>(stream));
}
