// Two-cell (encoder + decoder) cl_vrnn training forward for Hopper (sm_90a),
// f32 and bf16 streams.
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_two_cell.py
//   * :272 `_fwd_call` -> `_fwd_kernel` :129 with `two_cell_fwd_kernel<S>` below,
// in the f32 mode (S = float) and in the bf16 stream mode (`compute_dtype=bf16`,
// S = __nv_bfloat16), described at the end of this note. The backward
// (`_bwd_call` :408) is csrc/two_cell_tc.cu.
//
// What it computes, per batch row and time step t = 0 .. T-1:
//   ze = xe[t] @ We + be + h_e @ Rk_e;  (h_e, c_e) = gates(ze, c_e)
//   zargs = h_e @ Wz + bz;  z = zargs[:L] + exp(zargs[L:] / 2) * eps[t]
//   zd = xd[t] @ Wdx + bd + z @ Kz + h_d @ Rk_d;  (h_d, c_d) = gates(zd, c_d)
// with Keras-2.0 gates (i, f, c, o): hard sigmoid clip(0.2x + 0.5, 0, 1) for
// i, f, o, tanh for g and for the cell output. It emits hd, zargs and the
// residual streams the backward reads (ze, zd, and h, c before and after each
// cell).
//
// What bounds it on this card. At the jsball_vrnn4 training shape (B=200,
// T=16, H=256, L=8, input widths 101) the forward is ~4.8 GFLOP of f32 FMAs
// against a few tens of MB of streams, so the operations bound it (~0.07 ms
// at 67 TFLOP/s without tensor cores). But each step depends on the one
// before, so the T steps of the recurrences run in series.
//
// What the design does about it.
// * Time is serial, rows are independent: one block owns a tile of kRows batch
//   rows and runs the whole time loop itself (the TPU grid walked time in
//   order with the state in VMEM scratch; CUDA blocks run in no order and
//   carry nothing between them). h, c and z of both cells and the step's
//   inputs live in shared memory, stored [unit][row] so that one float4 load
//   gives the tile's four operands.
// * The weights do not fit one SM. The TPU kernel keeps both recurrent
//   kernels resident in VMEM; at f32 H=256 they are 2 MiB plus 0.8 MiB of
//   input kernels, against 227 KB of shared memory. They are read from global
//   memory each step and stay resident in the 50 MB L2, stored so that
//   neighbouring threads read neighbouring columns.
// * The input projections xe @ We and xd @ Wdx are extra rows of the cell's
//   product, as in the TPU kernel's body; they are not a library matmul.
// Known limits of this simple form: every block streams all weights from L2
// every step, and the products run on FFMA, not the tensor cores (the
// backward's redesign, csrc/two_cell_tc.cu, is the model for a later one).
// Plain FFMA keeps f32 exact to the JAX side's precision="highest" (no TF32).
//
// The bf16 stream mode. As `two_cell_sequence` :558-581 casts them outside
// its custom vjp, the x streams (xe, xd) and the six weight matrices (We,
// Rk_e, Wdx, Rk_d, Kz, Wz) arrive in bf16; the biases, eps, the initial
// states and the c streams stay f32. Operands widen to f32 on load and the
// products stay FFMA with f32 sums; h, c and z live in shared memory in f32,
// so the shared-memory layout is the same in both modes. Rounding happens
// where the Pallas body rounds (`mm` :150 casts the left operand):
// * h as an operand: the h tiles hold the rounded h, which is also the
//   hpe, he and hpd streams; the decoder's unrounded h is written to hd
//   (f32) before it is rounded. The gates read the unrounded z sums.
// * z (the sampled latent) as the operand of z @ Kz; zargs stays f32.
// * ze and zd as they are stored (the backward's gates read them rounded).
// bf16 halves the L2 stream of the weights; the FMAs still run at the f32
// rate.

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

__host__ __device__ constexpr size_t fwd_smem_floats(int INe, int INd, int H, int L) {
  return (size_t)(INe + INd + 6 * H + L) * kRows + (size_t)4 * kRows * kUnits;
}

__device__ __forceinline__ float hard_sigmoid(float x) {
  return fminf(fmaxf(0.2f * x + 0.5f, 0.f), 1.f);
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

}  // namespace

// Bytes of dynamic shared memory one forward block needs (the wrapper checks
// them against the card's limit); the same in both modes.
extern "C" long long cvl_two_cell_fwd_smem_bytes(int INe, int INd, int H, int L) {
  return (long long)(fwd_smem_floats(INe, INd, H, L) * sizeof(float));
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
