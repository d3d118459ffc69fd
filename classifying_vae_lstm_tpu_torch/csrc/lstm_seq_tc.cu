// The bf16 stream mode of the whole-sequence Keras-2.0 LSTM kernels, on
// Hopper's tensor cores (sm_90a).
//
// Replaces, at `compute_dtype=bf16`, the bf16 instances of
// classifying_vae_lstm_tpu/ops/pallas_lstm.py that csrc/lstm_seq.cu keeps
// in f32:
//   * :1203 `_forward_kernel_call_fp` -> `_lstm_seq_kernel_tblocked_fp` :632
//     (`_fp_ilv` :676) and :1146 `_forward_train_call_fp` ->
//     `_lstm_seq_train_kernel_fp` :730: the proj inference and training
//     forwards, `lstm_tc_proj_kernel` then `lstm_tc_step_kernel<kTrain>`;
//   * :387 / :414 `_forward_kernel_call` -> `_lstm_seq_kernel` :216 and
//     :1070 `_forward_train_call` -> `_lstm_seq_train_kernel` :529: the
//     unfused forwards, `lstm_tc_step_kernel` on an xz given in;
//   * :1378 `_backward_call_full` -> `_lstm_bwd_kernel_full` :986: the reverse
//     walk (`lstm_tc_bwd_gates_kernel<true>` and `lstm_tc_bwd_step_kernel`
//     per step), dRk (`lstm_tc_drk_kernel`), dW and db
//     (`wgrad_kernel<lstm_seq_tc_wgrad>`, csrc/wgrad.cuh);
//   * :1251 `_backward_call` -> `_lstm_bwd_kernel` :810 (the dz-only walk)
//     and :1306 `_backward_call_drk` -> `_lstm_bwd_kernel_drk` :920 (the
//     walk, then dRk).
//
// What bounds it. Rows are independent, but step t needs all of h_{t-1} of
// a row, so each step is one batched product [B, H] x [H, 4H] (the backward:
// [B, 4H] x [4H, H (+ IN)]). At B=1,024, H=2,048 a step is 34 GFLOP: at the
// tensor cores' bf16 rate (989 TFLOP/s) 0.035 ms, while the operands are
// 4 MB of h and 33.5 MB of Rk, which stay in the 50 MB L2. The old FFMA
// kernels ran one block per 4 batch rows through all steps, so every block
// streamed all of Rk from L2 every step (33.5 MB per 4 rows) and multiplied
// at the f32 rate.
//
// What the design does about it. Each step is one launch of a tiled
// tensor-core product (csrc/mma_bf16.cuh: mma.sync m16n8k16, ldmatrix, a
// 3-stage cp.async ring) over rows x gate columns, with the gate math fused
// into its epilogue; a tile of 64 rows reads its Rk columns once per step,
// 16x less L2 traffic than the 4-row tiles. T steps are T launches on one
// stream, which orders them; the carried state lives in global memory:
//   * the h operand in a double buffer [2][B, Hp] of bf16 (Hp: H rounded up
//     to 8, the pad columns zero), h0 rounded into it by the caller; step t
//     reads buffer t % 2 and writes the other;
//   * c_{t-1} is the c output of the step before (c0 at t = 0).
// Rk comes with its columns permuted by the caller so that the four gates
// (i, f, c, o) of unit u are columns 4u .. 4u+3: a 128-column tile holds all
// four gates of 32 units. The epilogue stages the tile's f32 sums in shared
// memory, and then a warp takes one row and lane l unit n0/4 + l, so that
// xz, c_{t-1}, h, c and z move in whole rows, and runs the Keras gates there
// (hard sigmoid clip(0.2x+0.5, 0, 1)).
//
// The backward walks t = T-1 .. 0 in two launches a step: the gate
// gradients (elementwise; `_bwd_gate_grads`, with the hard-sigmoid
// derivative 0.2 strictly inside (0, 1) and 0 at and beyond the clip
// points), then dz_t @ [Rkᵀ | Wᵀ] on the tensor cores, which gives the next
// dh carry and (the full rung) dx_t. The dh and dc carries are the dh0 and
// dc0 outputs, updated in place. dRk = sum_rows h_prevᵀ bf16(dz) is one more
// product over all T*B rows on the same mainloop, its left operand read
// transposed; dW and db (which need the unrounded f32 dz) stay on the
// deterministic `wgrad_kernel`. Every sum is taken by one thread in a fixed
// order: the results do not change from run to run.
//
// Rounding happens where the TPU kernels round (and the FFMA kernels did):
// xz = x @ W + b before h @ Rk is added (the projection stores it in bf16),
// h as the operand of h @ Rk (the double buffer holds the rounded h, which
// is also the h_prev stream), z as it is stored (the gates read the
// unrounded z; the backward's gates read the stored bf16 z), dz as the
// operand of dz @ (Rk | W)ᵀ and of dRk, dx as it is stored. The full rung
// keeps an f32 copy of dz for dW and db; the walks store dz in bf16 only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "mma_bf16.cuh"
#include "wgrad.cuh"

namespace {

using cvl_tc::Acc;
using cvl_tc::bf16;
using cvl_tc::kBM;
using cvl_tc::kBN;
using cvl_tc::kThreads;
using cvl_tc::Operand;

constexpr int kGateThreads = 256;

__device__ __forceinline__ float hard_sigmoid(float x) {
  return fminf(fmaxf(0.2f * x + 0.5f, 0.f), 1.f);
}

// d hard_sigmoid / dx expressed through the gate's value, as `_bwd_gate_grads`
__device__ __forceinline__ float hard_sigmoid_grad(float gate) {
  return (gate > 0.f && gate < 1.f) ? 0.2f : 0.f;
}

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 b16(float v) { return __float2bfloat16_rn(v); }

// (a) xz = bf16(x @ W + b) for all T*B rows: x [R, INp] (IN padded with
// zero columns to a multiple of 8), W [INp, 4H] with gate-interleaved
// columns; xz is stored at the original [i | f | c | o] layout, b read there
__global__ void __launch_bounds__(kThreads)
    lstm_tc_proj_kernel(const Operand x, const Operand w, const float* __restrict__ b,
                        bf16* __restrict__ xz, int H) {
  __shared__ __align__(16) unsigned char smem[cvl_tc::kSmemBytes];
  Acc acc;
  cvl_tc::zero(acc);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  cvl_tc::mainloop<false>(acc, x, w, m0, n0, x.cols, smem);
  const float* tile = cvl_tc::stage_acc(acc, smem);
  // a warp per row: lane l holds unit n0 / 4 + l (its four gate columns)
  const int u = n0 / 4 + threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < kBM; r += kThreads / 32) {
    const int row = m0 + r;
    if (row >= x.rows || u >= H) continue;
    const float4 v = *reinterpret_cast<const float4*>(tile + r * cvl_tc::kTileStride +
                                                      4 * (threadIdx.x % 32));
    const float p[4] = {v.x, v.y, v.z, v.w};
    bf16* xr = xz + (size_t)row * 4 * H;
#pragma unroll
    for (int g = 0; g < 4; ++g) xr[g * H + u] = b16(p[g] + b[g * H + u]);
  }
}

struct StepArgs {
  const bf16* xz;     // [T, B, 4H]  x @ W + b, rounded
  const bf16* rk;     // [H, 4H]     gate-interleaved columns
  bf16* hb;           // [2, B, Hp]  the h operand, double-buffered; hb[0] = bf16(h0)
  const float* c0;    // [B, H]
  float *h, *c;       // [T, B, H]
  bf16* z;            // [T, B, 4H]  training forward only
  bf16* hp;           // [T, B, H]   training forward only, proj rungs only
  float* cp;          // [T, B, H]   training forward only, proj rungs only
  int B, H, Hp;
};

// (b) step t: z = xz[t] + h_{t-1} @ Rk and the gates, fused into the epilogue
template <bool kTrain>
__global__ void __launch_bounds__(kThreads) lstm_tc_step_kernel(const StepArgs a, int t) {
  __shared__ __align__(16) unsigned char smem[cvl_tc::kSmemBytes];
  const int B = a.B, H = a.H, Hp = a.Hp;
  const bf16* hcur = a.hb + (size_t)(t & 1) * B * Hp;
  bf16* hnxt = a.hb + (size_t)((t + 1) & 1) * B * Hp;
  Acc acc;
  cvl_tc::zero(acc);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  cvl_tc::mainloop<false>(acc, Operand{hcur, B, Hp, Hp}, Operand{a.rk, H, 4 * H, 4 * H}, m0, n0,
                          Hp, smem);
  const float* tile = cvl_tc::stage_acc(acc, smem);
  const float* cprev = t ? a.c + (size_t)(t - 1) * B * H : a.c0;
  // a warp per row: lane l holds unit n0 / 4 + l, whose four gate columns
  // (i, f, c, o) are adjacent in the interleaved tile
  const int u = n0 / 4 + threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < kBM; r += kThreads / 32) {
    const int row = m0 + r;
    if (row >= B || u >= H) continue;
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
    const size_t hu = (size_t)row * H + u;
    const float cpv = cprev[hu];
    const float cn = f * cpv + i * g;
    const float hn = o * tanhf(cn);
    a.h[tb * H + u] = hn;
    a.c[tb * H + u] = cn;
    hnxt[(size_t)row * Hp + u] = b16(hn);
    if (kTrain) {
#pragma unroll
      for (int q = 0; q < 4; ++q) a.z[tb * 4 * H + q * H + u] = b16(zv[q]);
      if (a.hp) {
        a.hp[tb * H + u] = hcur[(size_t)row * Hp + u];
        a.cp[tb * H + u] = cpv;
      }
    }
  }
}

struct GateArgs {
  const bf16* z;             // [T, B, 4H]
  const float *cp, *c;       // [T, B, H]
  const float *dh, *dc;      // [T, B, H]  cotangents of the h and c sequences
  float *dh_c, *dc_c;        // [B, H]     the carries (dh0 and dc0 at the end)
  float* dz32;               // [T, B, 4H] f32 dz, the full rung only
  bf16* dzb;                 // [T, B, 4H] bf16(dz): the product's operand
  int B, H;
};

// (c) the gate gradients of step t (`_bwd_gate_grads`): dh = carry + dh[t],
// dc = carry + dc[t] + dh * o * (1 - tanh(c)^2)
template <bool kFull>
__global__ void __launch_bounds__(kGateThreads) lstm_tc_bwd_gates_kernel(const GateArgs a, int t) {
  const int H = a.H;
  const size_t i = (size_t)blockIdx.x * kGateThreads + threadIdx.x;
  if (i >= (size_t)a.B * H) return;
  const size_t row = (size_t)t * a.B + i / H;
  const int u = (int)(i % H);
  const bf16* zr = a.z + row * 4 * H;
  const float ig = hard_sigmoid(f32(zr[u]));
  const float fg = hard_sigmoid(f32(zr[H + u]));
  const float gg = tanhf(f32(zr[2 * H + u]));
  const float og = hard_sigmoid(f32(zr[3 * H + u]));
  const float tc = tanhf(a.c[row * H + u]);
  const float dh = a.dh_c[i] + a.dh[row * H + u];
  const float dc = (a.dc_c[i] + a.dc[row * H + u]) + dh * og * (1.f - tc * tc);
  const float dz[4] = {dc * gg * hard_sigmoid_grad(ig), dc * a.cp[row * H + u] * hard_sigmoid_grad(fg),
                       dc * ig * (1.f - gg * gg), dh * tc * hard_sigmoid_grad(og)};
  a.dc_c[i] = dc * fg;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const size_t j = row * 4 * H + g * H + u;
    if (kFull) a.dz32[j] = dz[g];
    a.dzb[j] = b16(dz[g]);
  }
}

// (d) step t's product: [B, 4H] bf16(dz_t) @ wt [4H, N], wt = [Rkᵀ | 0 | Wᵀ
// | 0] with Wᵀ's columns from `xs`: columns < H are the new dh carry (f32),
// columns xs .. xs+IN-1 dx_t (bf16)
__global__ void __launch_bounds__(kThreads)
    lstm_tc_bwd_step_kernel(const bf16* dzb, const Operand wt, float* __restrict__ dh_c,
                            bf16* __restrict__ dx, int B, int H, int xs, int IN) {
  __shared__ __align__(16) unsigned char smem[cvl_tc::kSmemBytes];
  Acc acc;
  cvl_tc::zero(acc);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  cvl_tc::mainloop<false>(acc, Operand{dzb, B, 4 * H, 4 * H}, wt, m0, n0, 4 * H, smem);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + cvl_tc::acc_row(mi, q), col = n0 + cvl_tc::acc_col(ni, q);
        if (row >= B) continue;
        if (col < H)
          dh_c[(size_t)row * H + col] = acc[mi][ni][q];
        else if (col >= xs && col < xs + IN)
          dx[(size_t)row * IN + col - xs] = b16(acc[mi][ni][q]);
      }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = b16(v); }

// (e) dRk [H, 4H] = sum over the R = T*B rows of h_prevᵀ bf16(dz): h_prev
// [R, H] is the left operand stored transposed
template <typename Out>
__global__ void __launch_bounds__(kThreads)
    lstm_tc_drk_kernel(const Operand hpT, const Operand dz, Out* __restrict__ drk) {
  __shared__ __align__(16) unsigned char smem[cvl_tc::kSmemBytes];
  Acc acc;
  cvl_tc::zero(acc);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  cvl_tc::mainloop<true>(acc, hpT, dz, m0, n0, hpT.rows, smem);
  const int H = hpT.cols, N = dz.cols;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + cvl_tc::acc_row(mi, q), col = n0 + cvl_tc::acc_col(ni, q);
        if (row < H && col < N) store(drk + (size_t)row * N + col, acc[mi][ni][q]);
      }
}

struct lstm_seq_tc_wgrad {};  // names this source's copy of cvl::wgrad_kernel

dim3 grid(int M, int N) { return dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM); }

}  // namespace

// Each entry point queues its launches on `stream` and returns the first
// nonzero cudaError_t of a launch (0 when all were taken).

// The projection of the proj rungs: xz [R, 4H] = bf16(x [R, INp] @ w [INp,
// 4H] + b), w gate-interleaved, xz at the original layout. One launch.
extern "C" int cvl_lstm_tc_proj(const void* x, const void* w, const float* b, void* xz, int R,
                                int INp, int H, void* stream) {
  const Operand xo{static_cast<const bf16*>(x), R, INp, INp};
  const Operand wo{static_cast<const bf16*>(w), INp, 4 * H, 4 * H};
  lstm_tc_proj_kernel<<<grid(R, 4 * H), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xo, wo, b, static_cast<bf16*>(xz), H);
  return (int)cudaGetLastError();
}

// The T steps of a forward on xz [T, B, 4H] (bf16): rk [H, 4H]
// gate-interleaved, hb [2, B, Hp] with hb[0] = bf16(h0) and zero pad
// columns; h and c [T, B, H] f32. The training forward passes z (and, at the
// proj rungs, hp and cp; null otherwise). T launches.
extern "C" int cvl_lstm_tc_steps(const void* xz, const void* rk, void* hb, const float* c0,
                                 float* h, float* c, void* z, void* hp, float* cp, int T, int B,
                                 int H, int Hp, void* stream) {
  const StepArgs a{static_cast<const bf16*>(xz), static_cast<const bf16*>(rk),
                   static_cast<bf16*>(hb), c0, h, c, static_cast<bf16*>(z),
                   static_cast<bf16*>(hp), cp, B, H, Hp};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    if (z)
      lstm_tc_step_kernel<true><<<grid(B, 4 * H), kThreads, 0, st>>>(a, t);
    else
      lstm_tc_step_kernel<false><<<grid(B, 4 * H), kThreads, 0, st>>>(a, t);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// The reverse walk over t = T-1 .. 0, two launches a step: z [T, B, 4H]
// bf16; cp, c, dh, dc [T, B, H] f32; wt [4H, N] bf16 (Rkᵀ in columns < H,
// and for the full rung Wᵀ in columns xs .. xs+IN-1, zeros elsewhere);
// dh_c and dc_c [B, H] zeroed by the caller, the carries and at the end dh0
// and dc0; dz32 (the full rung's f32 dz, else null) and dzb [T, B, 4H]; dx
// [T, B, IN] bf16 (null with IN = 0).
extern "C" int cvl_lstm_tc_walk(const void* z, const float* cp, const float* c, const float* dh,
                                const float* dc, const void* wt, int N, int xs, void* dx,
                                float* dh_c, float* dc_c, float* dz32, void* dzb, int T, int B,
                                int IN, int H, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GateArgs g{static_cast<const bf16*>(z), cp, c, dh, dc, dh_c, dc_c, dz32,
                   static_cast<bf16*>(dzb), B, H};
  const Operand wo{static_cast<const bf16*>(wt), 4 * H, N, N};
  const int gate_blocks = (int)(((size_t)B * H + kGateThreads - 1) / kGateThreads);
  for (int t = T - 1; t >= 0; --t) {
    if (dz32)
      lstm_tc_bwd_gates_kernel<true><<<gate_blocks, kGateThreads, 0, st>>>(g, t);
    else
      lstm_tc_bwd_gates_kernel<false><<<gate_blocks, kGateThreads, 0, st>>>(g, t);
    int err = (int)cudaGetLastError();
    if (err) return err;
    const size_t tb = (size_t)t * B;
    lstm_tc_bwd_step_kernel<<<grid(B, N), kThreads, 0, st>>>(
        static_cast<const bf16*>(dzb) + tb * 4 * H, wo, dh_c,
        dx ? static_cast<bf16*>(dx) + tb * IN : nullptr, B, H, xs, IN);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// dRk [H, 4H] = hpᵀ [H, R] @ dzb [R, 4H] over R = T*B rows, both bf16;
// stored bf16 (rounded once, the full rung) with `out_bf16`, else f32 (the
// drk walk). One launch.
extern "C" int cvl_lstm_tc_drk(const void* hp, const void* dzb, void* drk, int R, int H,
                               int out_bf16, void* stream) {
  const Operand a{static_cast<const bf16*>(hp), R, H, H};
  const Operand b{static_cast<const bf16*>(dzb), R, 4 * H, 4 * H};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    lstm_tc_drk_kernel<bf16><<<grid(H, 4 * H), kThreads, 0, st>>>(a, b, static_cast<bf16*>(drk));
  else
    lstm_tc_drk_kernel<float><<<grid(H, 4 * H), kThreads, 0, st>>>(a, b, static_cast<float*>(drk));
  return (int)cudaGetLastError();
}

// The full rung's dW [IN, 4H] = xᵀ bf16(dz) (x bf16, dz rounded as it is
// staged, dW stored in f32, unrounded) and db = column sums of the unrounded
// f32 dz over the R = T*B rows: the deterministic `wgrad_kernel`, one launch.
extern "C" int cvl_lstm_tc_dw_db(const void* x, const float* dz32, float* dw, float* db, int R,
                                 int IN, int H, void* stream) {
  const cvl::WgradJob jobs[] = {{x, dz32, dw, IN, 4 * H, 1, 1, 1},
                                {nullptr, dz32, db, 1, 4 * H}};
  return cvl::launch_wgrad<lstm_seq_tc_wgrad>(jobs, 2, R, static_cast<cudaStream_t>(stream));
}
