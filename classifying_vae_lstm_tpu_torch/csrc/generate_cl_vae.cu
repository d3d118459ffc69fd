// Whole-generation cl_vae sampler for Hopper (sm_90a): one kernel for f32 or
// bf16 weights split over a thread-block cluster (`generate_cluster_kernel`),
// the kernel that reads its f32 or bf16 weights from L2 (`generate_wide_kernel`)
// for the few configs the first and the last refuse, and one cooperative kernel for int8,
// bf16 or f32 operands (`generate_vae_coop_kernel<E>`, at the end).
//
// Replaces: classifying_vae_lstm_tpu/ops/pallas_generate_vae.py:141
// `_make_kernel` (the f32/bf16 body of `generate_cl_vae_batch_pallas`), and
// the JAX package's XLA scan (sampling/generate.py
// `generate_cl_vae_batch_noise`) for configs without hidden layers, which no
// Pallas kernel takes. One launch runs the whole autoregressive song: relu
// z-encoder hidden on the fed-back frame, the z heads, z = m + exp(v/2)*eps
// (or z = eps under use_z_prior), relu decoder hidden on (w, z, the
// one-step-lagged frame), the sigmoid frame head, the Bernoulli draw x_t =
// (u < p), and the two carried frames (x_prev_t takes the old x_prev before
// x_prev takes x_t). Without hidden layers the z heads read x_prev and the
// frame head reads z (L rank-1 terms) and x_prev_t. The per-song folds of
// the w rows and biases (encb, decb; without hidden layers zb, xb) are
// formed in the kernel's prologue (the other kernels: by the caller).
//
// What bounds it on this card. At the largest serving bucket of the trained
// checkpoints (64 songs x 256 steps, D=H=88, L=4, use_x_prev) the call is
// 16,384 song-steps x 24,288 f32 FMAs = 0.80 GFLOP, ~0.012 ms at 67 TFLOP/s
// f32 without tensor cores, against ~11.8 MB of eps/u/out streams, ~0.0035 ms
// at HBM rate: operations bound it. But every step depends on the previous
// one through four small dependent products, so the 256 steps run in series
// and the call costs 256 times the latency of one step's chain: the chain,
// not the work, is what the design shortens.
//
// What the design does about it.
// * Clusters of C blocks (C = 1, 2, 4 or 8: the fewest whose shared memory
//   holds the weights; the wrapper's `cluster_plan`) each own one song
//   (kClSongs) and run every step; clusters are independent, so any B runs, in
//   several waves past one wave of the card. Block r of a cluster owns a
//   share of the hidden units (the columns of the encoder's and the
//   decoder's x rows, of the decoder's z rows, and its units' rows of the z
//   heads) and a share of the pitches (the frame head's columns). Its slices
//   are packed by the wrapper (`pack_cluster`) and copied into shared memory
//   once a launch, one `cp.async.bulk` a weight, each completing on its own
//   mbarrier; a layer waits only for its own weight.
// * A step with hidden layers is three phases, each ended by a cluster
//   barrier (`__syncthreads()` when C = 1): (1) one pass over the block's
//   units: h_e (never stored: the lanes that hold it add its terms of the z
//   heads, which each warp sums over its groups into its slot) and the
//   decoder's x_prev_t product; (2) z in one warp of every block, the
//   warps' slots added in warp order and the blocks' sums in rank order
//   (through distributed shared memory), a block barrier, then h_d of the
//   block's units written into every block's copy of h_d; (3) the frame head
//   for its pitches over all of h_d, the sigmoid, the draw, the output, and
//   x_t written into every block's next frame. Under use_z_prior the first
//   barrier goes. Without hidden layers every block sums the z heads over
//   x_prev itself and a step is the two products, a block barrier and the
//   frame head's epilogue.
// * The frames live in a ring of three buffers indexed by step (step t reads
//   frame t and frame t - 1, the seed at both for t = 0, and writes frame t +
//   1), so nothing is copied.
// * Short chains: each output column of a layer goes to a group of g lanes
//   of one warp (g from the plan, per layer); lane i sums the 16-byte chunks
//   i, i + g, ... of k (k in order within a chunk, FFMA in f32 for both
//   modes), each of the tile's songs its own sum, and the group adds its lanes'
//   sums by a shuffle butterfly (offsets g/2, ..., 1), so every lane ends
//   with the same bits. A slab row is padded so that the lanes of a warp hit
//   distinct banks. On the register path (one song a cluster, one column a
//   group, at most kClRegVals values of k a lane: the committed checkpoints'
//   width) each lane keeps its chunks of the products' weights in registers
//   for the launch and reads only its operands from shared memory; it also
//   keeps the decoder's sums there for the h_d epilogue. What is left of a
//   step is dependent latency: ~2.9 us at jsball_vae's width on an H100
//   80GB HBM3 at 700 W (PERF.md, the kernel's own clock).
// * No global load on a step's chain: the last warp of each block (idle in
//   the products at most widths) stages the eps and u of its songs (u of
//   its pitches only) into a ring of kClRing steps with `cp.async`, kClRing
//   - 3 steps ahead; outputs are stored straight.
// * Every sum in a fixed order, no atomics: two calls give the same bits.
//
// Numerics follow the TPU kernel: relu hidden layers, expf for the z scale
// and the logistic head, no fast math, f32 FFMA without TF32 (JAX uses
// precision="highest" in f32). In bf16 mode the encoder x rows, the decoder
// x_prev rows, the z heads and the frame head are bf16 and their operands
// (the frames, h_e, h_d) are rounded to bf16, stored rounded as they are
// only ever read as operands; the decoder z rows, z and every bias stay f32,
// and every product accumulates in f32 on FFMA (a tile of at most 4 songs
// would leave an m16 tensor-core tile three quarters empty). The epilogues
// are written with __fadd_rn / __fmul_rn in the JAX kernel's order, so nvcc
// contracts nothing there into an FMA.
//
// `generate_wide_kernel` keeps the configs whose weights do not fit 8
// blocks of a cluster and that the cooperative kernel does not take: models
// without hidden layers with x_prev from D ~ 670 (D x D f32 rows of the
// frame head), or with a z-head width past 8 blocks, and f32 or bf16 models
// with hidden layers past the cooperative kernel's latent width (L past ~105
// at D=1,024, H=5,120). It computes what the cluster kernel computes, in
// f32 or bf16, from the same operands (the wrapper's `_pack`). Each block owns two songs and reads every weight from L2 every
// step: per song-step it does D*H*(1 + use_x_prev) + 3*L*H + H*D FMAs (with
// hidden layers) and its time is the L2-to-SM transfer of the weights each
// step, far above that bound. A layer with few output columns splits its K
// rows across up to kMaxSlices groups of threads whose partial sums meet in
// shared memory and are added in a fixed order; past one block's shared
// memory the per-song state goes to a global scratch the wrapper allocates.
//
// The cooperative kernel, `generate_vae_coop_kernel<signed char>` (at the end),
// replaces
// classifying_vae_lstm_tpu/ops/pallas_generate_vae.py:192 `_make_kernel_int8`
// (the int8 body of `generate_cl_vae_batch_pallas`), which the JAX package
// picks for a bf16 checkpoint whose bf16 weights pass its VMEM rule (the
// seq-concat width D=1,024, L=16: H = 4,160 ... 7,808). The three large
// weights (encoder x rows, decoder x_prev rows, frame head) are per-column
// int8 codes with f32 scales, quantized by the wrapper as JAX quantizes
// them; the z heads stay bf16 and the decoder z rows f32.
//
// Numerics. Binary frames are exact codes; the decoder's relu hidden h_d
// gets a per-song scale rs = max(max h_d, 1e-12) / 127 (h_d >= 0, so its max
// is its largest magnitude; a max is exact in any order) and enters the
// frame head as round(h_d / rs) (IEEE division, `__float2int_rn`, half to
// even as jnp.round). Every int8 product sums codes in int32 on the tensor
// cores (`mma.sync.m16n8k32` s8 -> s32), exact in any order. Each column is
// dequantized once and the f32 epilogue is written with __fmul_rn /
// __fadd_rn in the JAX kernel's order (h_e = relu((float)acc * s + encb);
// z_d = decb, then the L z rows, then (float)acc * s; p = sigmoid(((float)acc
// * swx) * rs + bx)), so nvcc contracts nothing into an FMA. The bf16 z heads
// are summed in double (each product of two bf16 values is exact) and
// rounded to f32 once, so the plain version's float64 product gives the
// same z: an f32 sum in another order may differ by an ulp, which h_d / rs
// can turn into another code.
//
// What bounds it. At the seq-concat width (D=1,024, H=5,120, L=16, no
// x_prev), 64 songs x 256 steps, it does 1.05e7 int8 MACs per song-step,
// 1.7e11 MACs (3.4e11 operations) for the call: ~0.17 ms at the card's
// 1,979 TOPS of int8 tensor-core products, against 10.5 MB of int8 weights
// (15.7 MB with x_prev), ~0.003 ms at HBM rate, so operations bound it
// (chip_smoke.py's `int8_bound_ms` prints both). But each step is a chain
// of all-to-all dependencies (the z heads need every unit's h_e, the scale
// rs every unit's h_d, the frame head every unit's code, the next step
// every pitch's frame), 256 steps in series.
//
// What the design does about it.
// * One persistent cooperative launch runs the whole song (a launch takes
//   at most 64 songs, 4 m16 tiles; a call of more runs several). The
//   columns, not the songs, are spread over the card: each block owns nu
//   hidden units (`int8_grid`: nu = 8 cdiv(H, 8 SMs), cdiv(H, nu) blocks;
//   128 blocks of 40 units at H=5,120) for every song, and a slice of the
//   frame head's pitches (8-pitch tiles; with song groups, `head_split`,
//   half the songs of twice the pitches). The first design gave each
//   block two songs and every weight from L2 each step (32 SMs of 132 busy
//   at 64 songs, every product on `__dp4a`).
// * Residency: the wrapper packs each block's slices (its units' columns of
//   the encoder's and decoder's x rows, its pitch tiles of the frame head)
//   contiguously in the order the m16n8k32 B fragments load them; the block
//   copies them into shared memory once a launch where they fit (120 KB at
//   H=5,120 with two song groups), else they stream from L2 every step
//   through the 4-stage `cp.async` ring that carries the codes of x and of
//   h_d (the int8 cl_vrnn kernel's lane layout: any pairing of k gives the
//   same int32 sum). A stage copies each song row's span of 8 or more chunks
//   whole (full 128-byte lines; a row apart by 16 padding bytes in shared
//   memory, off the fragment loads' banks), twice or four times the chunks
//   for a pass of 32 or 16 rows, so that a pass of fewer songs keeps as many
//   bytes in flight; and each block starts at its own stage, so that the
//   blocks do not all ask the same L2 lines at once.
// * A step is five phases with a grid barrier (csrc/coop.cuh) after each:
//   (1) the encoder's product and h_e for the block's units, then the z
//   heads' sums over those units (double, the block's columns of the z
//   heads kept in double, each h_e converted once for four columns); (2) z,
//   one warp a (song, latent), the blocks' sums added in a fixed order;
//   (3) the decoder's h_d for the block's units, and each song's largest
//   over them; (4) rs (every block's maxima loaded at once), and the codes
//   of h_d for the block's units; (5) the frame head for the block's
//   pitches (the codes of every unit, int32 sums exact), the Bernoulli
//   draw, the output and the next step's x_prev codes. Under
//   use_z_prior z is the noise: phases 1 and 2 are skipped. The codes of x
//   (double-buffered: x_prev and the lagged x_prev_t) and of h_d, the z
//   heads' sums, z and the songs' maxima live in global memory, read
//   through L2 (`cp.async.cg`, `__ldcg`: other blocks rewrite them every
//   step); h_e and h_d stay in their owner's shared memory. A grid that
//   cannot be co-resident fails to launch.
// * Every sum in a fixed order or exact, no atomics: two calls give the
//   same bits.
// Known limits: every block reads the codes of x (64 KB at 64 songs, D =
// 1,024) and of its song group's h_d (164 KB at H=5,120) from L2 each step;
// an H100 80GB HBM3 at 700 W moves that broadcast at ~1.4-2.2 TB/s, and the
// frame head's and the encoder's products take ~16 of a step's ~45 us, the
// five grid barriers ~7. Cluster multicast of the codes and `wgmma` are the
// levers.
//
// The same kernel in f32 and bf16, `generate_vae_coop_kernel<float>` and
// `<__nv_bfloat16>`, replaces `_make_kernel` :141 (the f32 / bf16 body of
// `generate_cl_vae_batch_pallas`) at the widths with hidden layers that the
// cluster kernel leaves to it (`kernel_for`), where the wide kernel's blocks each owned two
// songs and read every weight from L2 every step (296 ms a call at D=1,024,
// H=5,120, 64 x 256 in bf16, 32 SMs busy). It keeps the int8 design: the
// grid, the song groups of the frame head, the residency rule (in the
// mode's bytes), the ring, the z heads summed across blocks in double in a
// fixed order (a product of two bf16 or two f32 values is exact in double;
// z rounds to f32 once). Its operands are `_pack`'s: the large weights, x
// and h_e / h_d as operands in the mode's type (bf16 rounded as in the
// cluster kernel), the decoder z rows and every bias f32.
// What differs from int8: a 32-byte chunk holds 16 bf16 or 8 f32 values of
// k; bf16 products run on `mma.sync.m16n8k16` (bf16 -> f32), the lanes
// loading the same bytes of A and of each packed column as in int8, f32
// products on FFMA in the mma's output layout (lane (g, t): rows g, g + 8,
// columns 2t, 2t + 1, the chunk's 8 k in order), the warps' f32 sums added
// in warp order; h_d needs no song scale, so a step is four phases (the
// decoder writes its units' h_d as the frame head's operands), two under
// use_z_prior; the frame head is p = sigmoid(h_d . Wx + bx). Each block reads
// x and its song group's h_d as bf16 (twice the int8 codes' bytes) or f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "coop.cuh"
#include "mma_bf16.cuh"

namespace {

using cvl_coop::grid_sync;
using cvl_coop::mma_s8;

constexpr int kSongs = 2;  // songs per block of the wide kernel

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// the value a matmul operand takes in the weight type's mode
template <typename WT>
__device__ __forceinline__ float operand(float x);
template <>
__device__ __forceinline__ float operand<float>(float x) { return x; }
template <>
__device__ __forceinline__ float operand<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round16(int n) { return cdiv(n, 16) * 16; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// ---------------------------------------------------------- the cluster kernel

constexpr int kClMaxThreads = 512;
// songs a cluster (S): tiles of 2 and 4 songs were slower than 1 at 64 songs
// (PERF.md §6), so the kernel runs one; its loops over a tile's songs stay
// written for S
constexpr int kClSongs = 1;
constexpr int kClRing = 8;            // noise ring: step t's eps / u staged kClRing - 3 steps ahead
constexpr int kClMaxC = 8;            // blocks a cluster (the portable limit)
constexpr int kSmemLimit = 232448;    // shared memory one Hopper block can use
constexpr int kClStatic = 256;        // of it kept for the kernel's static shared memory (its clock)
constexpr int kEnc = 0, kZh = 1, kDec = 2, kHead = 3, kClLayers = 4;
constexpr int kClWarpSlots = 16;      // a block's warps (at most 512 threads)
constexpr int kClZPer = 4;            // z heads a lane of an encoder column sums (2L <= 4 g)
constexpr int kClRegVals = 24;        // values of k a lane keeps of a layer on the register path
constexpr int kClRegThreads = 384;    // the register path's most threads (its registers a thread)

// What the wrapper's plan gives (`cluster_plan`): the model's widths, the
// operand bytes eb (4 f32, 2 bf16), C blocks a cluster, T
// threads a block, and g, the lanes that sum one output column, per layer
// (encoder, z heads, decoder, frame head).
struct ClGeom {
  int D, H, L, has_hidden, use_x_prev, eb, C, T, g[kClLayers];
};

// What follows from it: a block's units Hc and pitches Dc; per layer its
// columns n, depth k, 16-byte chunks nck that a lane sums and the chunks rs
// of a slab row (the weight's columns k-contiguous, padded: rs = g m with m
// odd where g < 8, so that the lanes of a warp load from distinct banks);
// the floats of a song's row of the frames and of h_d; and the byte
// offsets of dynamic shared memory: the mbarriers, the four slabs, then f32
// regions, each a multiple of 16 bytes.
struct ClLayout {
  int Hc, Dc;
  int n[kClLayers], k[kClLayers], nck[kClLayers], rs[kClLayers];
  int Da, Ha;
  unsigned slab[kClLayers];
  unsigned zrows, bz, bx, frames, hd, fold0, fold1, zp, zs, dsum, noise, bytes;
};

__host__ __device__ inline unsigned cl_take(unsigned& off, int floats) {
  const unsigned o = off;
  off += (unsigned)(cdiv(floats, 4) * 16);
  return o;
}

__host__ __device__ inline ClLayout cl_layout(const ClGeom& g) {
  ClLayout y{};
  const int kp = 16 / g.eb;  // k of a chunk
  const int D = g.D, H = g.H, L = g.L, S = kClSongs;
  y.Hc = g.has_hidden ? cdiv(H, g.C) : 0;
  y.Dc = cdiv(D, g.C);
  if (g.has_hidden) {
    y.n[kEnc] = y.Hc, y.k[kEnc] = D;
    y.n[kZh] = 2 * L, y.k[kZh] = y.Hc;
    y.n[kDec] = g.use_x_prev ? y.Hc : 0, y.k[kDec] = g.use_x_prev ? D : 0;
    y.n[kHead] = y.Dc, y.k[kHead] = H;
  } else {
    y.n[kZh] = 2 * L, y.k[kZh] = D;
    y.n[kHead] = g.use_x_prev ? y.Dc : 0, y.k[kHead] = g.use_x_prev ? D : 0;
  }
  unsigned off = 32;  // four mbarriers
  int span[kClLayers];
  for (int i = 0; i < kClLayers; ++i) {
    const bool on = y.n[i] > 0 && y.k[i] > 0;
    y.nck[i] = on ? cdiv(cdiv(y.k[i], kp), g.g[i]) : 0;
    const int m = (g.g[i] < 8 && y.nck[i] % 2 == 0 && on) ? y.nck[i] + 1 : y.nck[i];
    y.rs[i] = m * g.g[i];
    span[i] = y.nck[i] * g.g[i] * kp;
    y.slab[i] = off;
    off += (unsigned)y.n[i] * (unsigned)y.rs[i] * 16u;
  }
  y.Da = imax(cdiv(D, 4) * 4, g.has_hidden ? imax(span[kEnc], span[kDec])
                                           : imax(span[kZh], span[kHead]));
  y.Ha = g.has_hidden ? imax(cdiv(H, 4) * 4, span[kHead]) : 0;
  const int own = g.has_hidden ? y.Hc : y.Dc;  // the columns the z rows hold
  y.zrows = cl_take(off, L * own);
  y.bz = cl_take(off, g.has_hidden ? 2 * L : 0);
  y.bx = cl_take(off, g.has_hidden ? y.Dc : 0);
  y.frames = cl_take(off, 3 * S * y.Da);
  y.hd = cl_take(off, S * y.Ha);
  y.fold0 = cl_take(off, S * (g.has_hidden ? y.Hc : 2 * L));  // encb, or zb
  y.fold1 = cl_take(off, S * (g.has_hidden ? y.Hc : y.Dc));   // decb, or xb
  // the z heads: each warp's sums of the block's units (with hidden layers),
  // or zmv; z
  y.zp = cl_take(off, S * 2 * L * (g.has_hidden ? kClWarpSlots : 1));
  y.zs = cl_take(off, g.has_hidden ? S * L : 0);
  y.dsum = cl_take(off, S * imax(y.Hc, y.Dc));  // the products that wait for z
  y.noise = cl_take(off, kClRing * S * (L + y.Dc));
  y.bytes = off;
  return y;
}

struct ClArgs {
  ClGeom geom;
  const float* seed;   // [B, D]
  const float* eps;    // [B, nsteps, L]
  const float* u;      // [B, nsteps, D]
  const void* w[kClLayers];  // [C][slab] each: block r's slab at r * n * rs * 16 bytes (or null)
  // the per-song folds of the key point w, formed in the prologue: the w
  // rows and biases of (hidden) the encoder and the decoder ([K, H] each,
  // -> encb, decb), or (none) of the two z heads ([K, L]) and the frame head
  // ([K, D]) (-> zb, xb)
  const float* ws;     // [B, K]
  const float* fw[3];
  const float* fb[3];
  const float* zrows;  // hidden: decoder z rows [L, H]; none: frame head z rows [L, D]
  const float* bz;     // [2L] (hidden)
  const float* bx;     // [D] (hidden)
  float* out;          // [B, nsteps, D]
  unsigned long long* clock;  // [kClLaps] or null: block 0's ns per part of a step
  int B, nsteps, K, use_z_prior, return_probs;
  ClLayout y;          // cl_layout(geom), computed on the host (read from the constant bank)
};

// Block 0's clock of a step's parts (thread 0's view): the noise staging (the
// z warp's); the encoder's and the decoder's products with h_e's terms of
// the z heads; the z heads' sums over the warp; the wait at the first
// barrier; z (the z warp's) and the block barrier after it; the h_d
// epilogue; the wait at the second barrier; the frame head's products; its
// epilogue (the draw, the output, x_t to every block); the wait for the
// next step's noise; the wait at the last barrier. Without hidden layers:
// the z heads' and the frame head's products, the block barrier, then the
// frame head's epilogue (z in each thread).
constexpr int kClLaps = 11;
using ClClock = cvl_coop::PhaseClock<kClLaps>;

__device__ __forceinline__ unsigned cl_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cl_mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(cl_smem(bar)), "r"(1u) : "memory");
}
__device__ __forceinline__ void cl_mbar_wait(uint64_t* bar) {  // phase 0 completed
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(cl_smem(bar)), "r"(0u)
        : "memory");
}
// `bytes` (a multiple of 16) from global `src` to shared `dst`, both on 16
// bytes, completing on `bar`
__device__ __forceinline__ void cl_bulk(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(cl_smem(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(cl_smem(dst)),
      "l"(src), "r"(bytes), "r"(cl_smem(bar))
      : "memory");
}
__device__ __forceinline__ void cl_cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(cl_smem(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cl_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cl_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a 16-byte chunk of a slab as f32 values in k order
__device__ __forceinline__ void cl_unpack(const uint4& v, float (&w)[4]) {
  w[0] = __uint_as_float(v.x), w[1] = __uint_as_float(v.y);
  w[2] = __uint_as_float(v.z), w[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void cl_unpack(const uint4& v, float (&w)[8]) {
  const unsigned q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(q[i] << 16);
    w[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
  }
}

// a column's sums, one a song (passed by value: kept in registers)
template <int S>
struct ClSums {
  float v[S];
};

// One layer for every song of the tile, its weights read from the block's
// shared memory: sum_k act[b][k] * w[n][k] for each of the block's n_cols
// columns, of one weight (slab2 null) or of two weights of the same shape
// over two operands (slab2, act2: the encoder's and the decoder's x rows,
// one pass with twice the independent sums). Group gi = tid >> lg (g = 1 <<
// lg lanes) takes columns gi, gi + T / g, ...; lane li = tid & (g - 1) sums
// the chunks li, li + g, ... (nck of them) of its column's slab row (rs
// chunks a row), k in order within a chunk, every song in its own sum; then
// the group adds its lanes' sums by a butterfly, offsets g/2 down to 1, so
// every lane of the group holds the column's sums. epi(n, on, sums, sums2)
// runs on every lane of the warp (on: a column of the block).
template <typename WT, int S, typename Epi>
__device__ __forceinline__ void cl_layer(const unsigned char* slab, const unsigned char* slab2,
                                         int n_cols, int lg, int nck, int rs, const float* act,
                                         const float* act2, int ld, Epi epi) {
  constexpr int kp = 16 / (int)sizeof(WT);
  const int g = 1 << lg, li = threadIdx.x & (g - 1), gi = threadIdx.x >> lg;
  const int ng = blockDim.x >> lg;
  const uint4* w4 = reinterpret_cast<const uint4*>(slab);
  const uint4* v4 = reinterpret_cast<const uint4*>(slab2);
  for (int n0 = 0; n0 < n_cols; n0 += ng) {
    const int n = n0 + gi;
    const bool on = n < n_cols;
    ClSums<S> s1, s2;
#pragma unroll
    for (int b = 0; b < S; ++b) s1.v[b] = s2.v[b] = 0.f;
    if (on) {
      const size_t row = (size_t)n * rs + li;
#pragma unroll 2
      for (int i = 0; i < nck; ++i) {
        float w[kp], v[kp];
        cl_unpack(w4[row + (i << lg)], w);
        if (slab2) cl_unpack(v4[row + (i << lg)], v);
        const int k0 = (li + (i << lg)) * kp;
#pragma unroll
        for (int b = 0; b < S; ++b) {
          const float4* a4 = reinterpret_cast<const float4*>(act + b * ld + k0);
#pragma unroll
          for (int q = 0; q < kp / 4; ++q) {
            const float4 x = a4[q];
            s1.v[b] = fmaf(x.x, w[4 * q], s1.v[b]);
            s1.v[b] = fmaf(x.y, w[4 * q + 1], s1.v[b]);
            s1.v[b] = fmaf(x.z, w[4 * q + 2], s1.v[b]);
            s1.v[b] = fmaf(x.w, w[4 * q + 3], s1.v[b]);
          }
          if (slab2) {
            const float4* c4 = reinterpret_cast<const float4*>(act2 + b * ld + k0);
#pragma unroll
            for (int q = 0; q < kp / 4; ++q) {
              const float4 x = c4[q];
              s2.v[b] = fmaf(x.x, v[4 * q], s2.v[b]);
              s2.v[b] = fmaf(x.y, v[4 * q + 1], s2.v[b]);
              s2.v[b] = fmaf(x.z, v[4 * q + 2], s2.v[b]);
              s2.v[b] = fmaf(x.w, v[4 * q + 3], s2.v[b]);
            }
          }
        }
      }
    }
    for (int off = g >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int b = 0; b < S; ++b) {
        s1.v[b] += __shfl_xor_sync(0xffffffffu, s1.v[b], off);
        if (slab2) s2.v[b] += __shfl_xor_sync(0xffffffffu, s2.v[b], off);
      }
    }
    epi(n, on, s1, s2);
  }
}

// The register path: where every column of a layer has its group (one
// round) and a lane sums at most kClRegVals values of k, the lane's chunks
// of each weight are loaded from the slab into registers once a launch and
// the layer reads only its operands from shared memory: the same sums, in
// the same order, as `cl_layer`.
template <typename WT>
__device__ __forceinline__ void cl_load_regs(float (&w)[kClRegVals], const unsigned char* slab,
                                             int n_cols, int lg, int nck, int rs) {
  constexpr int kp = 16 / (int)sizeof(WT);
  const int li = threadIdx.x & ((1 << lg) - 1), n = threadIdx.x >> lg;
#pragma unroll
  for (int i = 0; i < kClRegVals / kp; ++i) {
    float v[kp];
#pragma unroll
    for (int j = 0; j < kp; ++j) v[j] = 0.f;
    if (slab && n < n_cols && i < nck)
      cl_unpack(reinterpret_cast<const uint4*>(slab)[(size_t)n * rs + li + (i << lg)], v);
#pragma unroll
    for (int j = 0; j < kp; ++j) w[i * kp + j] = v[j];
  }
}

template <typename WT, int S, typename Epi>
__device__ __forceinline__ void cl_layer_regs(const float (&w)[kClRegVals],
                                              const float (&w2)[kClRegVals], bool two, int n_cols,
                                              int lg, int nck, const float* act, const float* act2,
                                              int ld, Epi epi) {
  constexpr int kp = 16 / (int)sizeof(WT);
  const int g = 1 << lg, li = threadIdx.x & (g - 1), n = threadIdx.x >> lg;
  const bool on = n < n_cols;
  ClSums<S> s1, s2;
#pragma unroll
  for (int b = 0; b < S; ++b) s1.v[b] = s2.v[b] = 0.f;
  if (on) {
#pragma unroll
    for (int i = 0; i < kClRegVals / kp; ++i) {
      if (i < nck) {
        const int k0 = (li + (i << lg)) * kp;
#pragma unroll
        for (int b = 0; b < S; ++b) {
          const float4* a4 = reinterpret_cast<const float4*>(act + b * ld + k0);
#pragma unroll
          for (int q = 0; q < kp / 4; ++q) {
            const float4 x = a4[q];
            s1.v[b] = fmaf(x.x, w[i * kp + 4 * q], s1.v[b]);
            s1.v[b] = fmaf(x.y, w[i * kp + 4 * q + 1], s1.v[b]);
            s1.v[b] = fmaf(x.z, w[i * kp + 4 * q + 2], s1.v[b]);
            s1.v[b] = fmaf(x.w, w[i * kp + 4 * q + 3], s1.v[b]);
          }
          if (two) {
            const float4* c4 = reinterpret_cast<const float4*>(act2 + b * ld + k0);
#pragma unroll
            for (int q = 0; q < kp / 4; ++q) {
              const float4 x = c4[q];
              s2.v[b] = fmaf(x.x, w2[i * kp + 4 * q], s2.v[b]);
              s2.v[b] = fmaf(x.y, w2[i * kp + 4 * q + 1], s2.v[b]);
              s2.v[b] = fmaf(x.z, w2[i * kp + 4 * q + 2], s2.v[b]);
              s2.v[b] = fmaf(x.w, w2[i * kp + 4 * q + 3], s2.v[b]);
            }
          }
        }
      }
    }
  }
  for (int off = g >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int b = 0; b < S; ++b) {
      s1.v[b] += __shfl_xor_sync(0xffffffffu, s1.v[b], off);
      if (two) s2.v[b] += __shfl_xor_sync(0xffffffffu, s2.v[b], off);
    }
  }
  epi(n, on, s1, s2);
}

// this block's rank in its cluster, block q's address of this block's
// shared `p` (distributed shared memory), and the cluster barrier (release /
// acquire: every block's writes into the others' shared memory are seen)
__device__ __forceinline__ int cl_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ float* cl_peer(float* p, int q) {
  unsigned long long d;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(d) : "l"(reinterpret_cast<unsigned long long>(p)),
               "r"(q));
  return reinterpret_cast<float*>(d);
}
__device__ __forceinline__ void cl_sync(int C) {
  if (C == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}
// v into element i of array p of every block of the cluster
__device__ __forceinline__ void cl_put(float* p, int i, float v, int C) {
  if (C == 1) {
    p[i] = v;
    return;
  }
  for (int q = 0; q < C; ++q) cl_peer(p, q)[i] = v;
}

// the sum of a song's z-head column over every block of the cluster: each
// block's 16 warp slots added in warp order (a warp the block lacks holds
// 0), the blocks' sums in rank order
__device__ __forceinline__ float cl_zsum(float* zpw, int idx, int C) {
  float s = 0.f;
  for (int q = 0; q < C; ++q) {
    const float4* p = reinterpret_cast<const float4*>((C == 1 ? zpw : cl_peer(zpw, q)) +
                                                      idx * kClWarpSlots);
    const float4 x0 = p[0], x1 = p[1], x2 = p[2], x3 = p[3];
    float t = x0.x;
    t += x0.y, t += x0.z, t += x0.w;
    t += x1.x, t += x1.y, t += x1.z, t += x1.w;
    t += x2.x, t += x2.y, t += x2.z, t += x2.w;
    t += x3.x, t += x3.y, t += x3.z, t += x3.w;
    s = q == 0 ? t : __fadd_rn(s, t);
  }
  return s;
}

// A cluster of C blocks runs S = kClSongs songs through every step (see the
// header); RG: the register path (at most 384 threads).
template <typename WT, bool RG>
__global__ void __launch_bounds__(RG ? kClRegThreads : kClMaxThreads, 1)
    generate_cluster_kernel(const ClArgs a) {
  constexpr int S = kClSongs;
  extern __shared__ int4 smem_cl[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_cl);
  const ClGeom& gm = a.geom;
  const ClLayout& y = a.y;
  const int C = gm.C, D = gm.D, H = gm.H, L = gm.L, T = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r = C == 1 ? 0 : cl_rank(), s0 = (blockIdx.x / C) * S;
  const int hh = gm.has_hidden, xp = gm.use_x_prev, zprior = a.use_z_prior;
  const int Hc = y.Hc, Dc = y.Dc, Da = y.Da, Ha = y.Ha, NZ = L + Dc;
  const int nun = hh ? imin(Hc, H - r * Hc) : 0, npt = imin(Dc, D - r * Dc);  // owned, in range
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);
  const WT* wz = reinterpret_cast<const WT*>(sm + y.slab[kZh]);  // [2L][rs kp] z heads
  const int wz_ld = y.rs[kZh] * (16 / (int)sizeof(WT));
  float* zrows = reinterpret_cast<float*>(sm + y.zrows);  // [L][Hc] (none: [L][Dc])
  float* bz = reinterpret_cast<float*>(sm + y.bz);
  float* bx = reinterpret_cast<float*>(sm + y.bx);        // [Dc]
  float* frames = reinterpret_cast<float*>(sm + y.frames);  // [3][S][Da]
  float* hd = reinterpret_cast<float*>(sm + y.hd);        // [S][Ha]
  float* fold0 = reinterpret_cast<float*>(sm + y.fold0);  // encb [S][Hc] (none: zb [S][2L])
  float* fold1 = reinterpret_cast<float*>(sm + y.fold1);  // decb [S][Hc] (none: xb [S][Dc])
  float* zpw = reinterpret_cast<float*>(sm + y.zp);       // [S][2L][16] warp sums (none: [S][2L])
  float* zs = reinterpret_cast<float*>(sm + y.zs);        // [S][L] z
  float* dsum = reinterpret_cast<float*>(sm + y.dsum);    // [S][Hc] (none: [S][Dc])
  float* noise = reinterpret_cast<float*>(sm + y.noise);  // [kClRing][S][L + Dc]: eps, u

  // the slabs: one bulk copy a weight (not the encoder's and the z heads'
  // under use_z_prior), each on its own mbarrier
  bool used[kClLayers];
#pragma unroll
  for (int i = 0; i < kClLayers; ++i)
    used[i] = y.n[i] > 0 && y.rs[i] > 0 && !(zprior && (i == kEnc || i == kZh));
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kClLayers; ++i) cl_mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
#pragma unroll
    for (int i = 0; i < kClLayers; ++i)
      if (used[i]) {
        const unsigned bytes = (unsigned)y.n[i] * (unsigned)y.rs[i] * 16u;
        cl_bulk(sm + y.slab[i], static_cast<const unsigned char*>(a.w[i]) + (size_t)r * bytes,
                bytes, bars + i);
      }
  // the f32 state: zeros (the pads of every operand row and the unused warp
  // slots stay 0), then the block's columns of the z rows, the biases, the
  // songs' folds and seeds
  for (unsigned i = y.zrows / 16 + tid; i < y.bytes / 16; i += T)
    smem_cl[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const int own = hh ? Hc : Dc, nown = hh ? nun : npt, c0 = r * own, ld0 = hh ? H : D;
  for (int i = tid; i < L * own; i += T) {
    const int l = i / own, j = i - l * own;
    if (j < nown) zrows[i] = a.zrows[(size_t)l * ld0 + c0 + j];
  }
  if (hh) {
    for (int i = tid; i < 2 * L; i += T) bz[i] = a.bz[i];
    for (int j = tid; j < npt; j += T) bx[j] = a.bx[r * Dc + j];
  }
  // a song's fold: w . (w rows)[:, col] (k in order) + bias[col]
  const auto fold = [&](int i, int ld, int col, int s) {
    float e = 0.f;
    for (int k = 0; k < a.K; ++k) e = fmaf(a.ws[(size_t)s * a.K + k], a.fw[i][(size_t)k * ld + col], e);
    return __fadd_rn(e, a.fb[i][col]);
  };
  for (int b = 0; b < S; ++b) {
    const int s = s0 + b;
    if (s >= a.B) break;
    if (hh) {
      for (int j = tid; j < nun; j += T) {
        fold0[b * Hc + j] = fold(0, H, r * Hc + j, s);  // encb
        fold1[b * Hc + j] = fold(1, H, r * Hc + j, s);  // decb
      }
    } else {
      for (int j = tid; j < 2 * L; j += T)  // zb: z_mean | z_log_var
        fold0[b * 2 * L + j] = j < L ? fold(0, L, j, s) : fold(1, L, j - L, s);
      for (int j = tid; j < npt; j += T) fold1[b * Dc + j] = fold(2, D, r * Dc + j, s);  // xb
    }
    for (int d = tid; d < D; d += T) frames[b * Da + d] = operand<WT>(a.seed[(size_t)s * D + d]);
  }
  // the noise ring: eps 0 and u 1 where no song is (the copies overwrite
  // the songs' slots), then the first kClRing - 3 steps in flight
  for (int i = tid; i < kClRing * S * NZ; i += T)
    if (i % NZ >= L) noise[i] = 1.f;
  __syncthreads();
  // the noise of step t into its slot, by the z warp (the last warp)
  const bool zwarp = tid >= T - 32;
  const auto stage = [&](int t) {
    if (t < a.nsteps) {
      float* slot = noise + (t % kClRing) * S * NZ;
      for (int i = lane; i < S * NZ; i += 32) {
        const int b = S == 1 ? 0 : i / NZ, e = i - b * NZ, s = s0 + b;
        if (s >= a.B) continue;
        if (e < L)
          cl_cp4(slot + i, a.eps + ((size_t)s * a.nsteps + t) * L + e);
        else if (e - L < npt)
          cl_cp4(slot + i, a.u + ((size_t)s * a.nsteps + t) * D + r * Dc + (e - L));
      }
    }
    cl_commit();
  };
  if (zwarp) {
    for (int t = 0; t < kClRing - 3; ++t) stage(t);
    cl_wait<kClRing - 4>();  // this lane's copies of step 0 landed
  }
  const int lg0 = __ffs(gm.g[kEnc]) - 1, lg1 = __ffs(gm.g[kZh]) - 1, lg3 = __ffs(gm.g[kHead]) - 1;
  const int g0 = 1 << lg0, li0 = lane & (g0 - 1), gh = 1 << lg3, lh = lane & (gh - 1);
  // the register path's weights: the lane's chunks of the encoder's (with
  // hidden layers; else the z heads') and the decoder's x rows, of the frame
  // head, and the z heads of its unit
  float wa[kClRegVals], wb[kClRegVals], wh[kClRegVals], wzr[kClZPer];
  if (RG) {
#pragma unroll
    for (int i = 0; i < kClLayers; ++i)
      if (used[i]) cl_mbar_wait(bars + i);
    const int la = hh ? kEnc : kZh, lga = hh ? lg0 : lg1;
    cl_load_regs<WT>(wa, used[la] ? sm + y.slab[la] : nullptr, y.n[la], lga, y.nck[la],
                     y.rs[la]);
    cl_load_regs<WT>(wb, used[kDec] ? sm + y.slab[kDec] : nullptr, y.n[kDec], lg0, y.nck[kDec],
                     y.rs[kDec]);
    cl_load_regs<WT>(wh, used[kHead] ? sm + y.slab[kHead] : nullptr, y.n[kHead], lg3,
                     y.nck[kHead], y.rs[kHead]);
    const int n = tid >> lg0;
#pragma unroll
    for (int j = 0; j < kClZPer; ++j) {
      const int c = li0 + j * g0;
      wzr[j] = hh && used[kZh] && n < Hc && c < 2 * L ? ld(wz + c * wz_ld + n) : 0.f;
    }
  }
  // every block of the cluster is running and its state set before any
  // block writes into another's shared memory
  cl_sync(C);
  __shared__ ClClock clk;  // thread 0 of block 0 keeps it
  const bool timer = tid == 0;
  if (timer) {
    clk.out = blockIdx.x == 0 ? a.clock : nullptr;
    clk.start();
  }

  for (int t = 0; t < a.nsteps; ++t) {
    // step t + kClRing - 3's noise into the slot step t - 3 left (the z
    // warp's, whose lanes the products of most configs leave idle)
    if (zwarp) stage(t + kClRing - 3);
    if (timer) clk.lap(0);
    const float* nz = noise + (t % kClRing) * S * NZ;  // [S][L + Dc]: eps, u of the block's pitches
    const float* xin = frames + (t % 3) * S * Da;                     // x_prev
    const float* xlag = frames + (t == 0 ? 0 : (t - 1) % 3) * S * Da;  // x_prev_t
    const int nxt = ((t + 1) % 3) * S * Da;
    // the Bernoulli draw of pitch r Dc + n of song b, its output, and x_t into
    // every block's next frame
    const auto emit = [&](int n, int b, float p) {
      const float xt = nz[b * NZ + L + n] < p ? 1.f : 0.f;
      const int s = s0 + b, d = r * Dc + n;
      if (s < a.B) a.out[((size_t)s * a.nsteps + t) * D + d] = a.return_probs ? p : xt;
      cl_put(frames, nxt + b * Da + d, xt, C);
    };
    if (hh) {
      // 1. one pass over the block's units: h_e = relu(x_prev.Wke + encb) and
      // its terms of the z heads (lane li of a column's group takes heads li,
      // li + g, ...: kClZPer a song), and the decoder's x_prev_t product; the
      // z heads' terms summed over the warp's groups (offsets 16 down to g)
      // into the warp's slot
      float zacc[S][kClZPer];
#pragma unroll
      for (int b = 0; b < S; ++b)
#pragma unroll
        for (int j = 0; j < kClZPer; ++j) zacc[b][j] = 0.f;
      ClSums<S> dec;  // the register path keeps the decoder's sums here
      const auto epi = [&](int n, bool on, const ClSums<S> acc, const ClSums<S> acc2) {
        if (!on) return;
        if (!zprior) {
#pragma unroll
          for (int b = 0; b < S; ++b) {
            const float h = operand<WT>(fmaxf(__fadd_rn(acc.v[b], fold0[b * Hc + n]), 0.f));
#pragma unroll
            for (int j = 0; j < kClZPer; ++j) {
              const int c = li0 + j * g0;
              if (c < 2 * L) zacc[b][j] = fmaf(h, RG ? wzr[j] : ld(wz + c * wz_ld + n), zacc[b][j]);
            }
          }
        }
        if (xp) {
          const ClSums<S> d = zprior ? acc : acc2;
          if (RG) {
            dec = d;
          } else {
#pragma unroll
            for (int b = 0; b < S; ++b)
              if ((b & (g0 - 1)) == li0) dsum[b * Hc + n] = d.v[b];
          }
        }
      };
      if (t == 0 && !RG) {
        if (!zprior) cl_mbar_wait(bars + kEnc), cl_mbar_wait(bars + kZh);
        if (xp) cl_mbar_wait(bars + kDec);
      }
      if (RG) {
        if (!zprior)
          cl_layer_regs<WT, S>(wa, wb, xp, Hc, lg0, y.nck[kEnc], xin, xlag, Da, epi);
        else if (xp)
          cl_layer_regs<WT, S>(wb, wb, false, Hc, lg0, y.nck[kEnc], xlag, nullptr, Da, epi);
      } else if (!zprior || xp) {
        cl_layer<WT, S>(zprior ? sm + y.slab[kDec] : sm + y.slab[kEnc],
                        zprior || !xp ? nullptr : sm + y.slab[kDec], Hc, lg0, y.nck[kEnc],
                        y.rs[kEnc], zprior ? xlag : xin, xlag, Da, epi);
      }
      if (timer) clk.lap(1);
      if (!zprior) {
#pragma unroll
        for (int j = 0; j < kClZPer; ++j)
          if (j * g0 < 2 * L)  // a head some lane of the warp sums
            for (int off = 16; off >= g0; off >>= 1)
#pragma unroll
              for (int b = 0; b < S; ++b) zacc[b][j] += __shfl_xor_sync(0xffffffffu, zacc[b][j], off);
        if (lane < g0)
#pragma unroll
          for (int b = 0; b < S; ++b)
#pragma unroll
            for (int j = 0; j < kClZPer; ++j) {
              const int c = li0 + j * g0;
              if (c < 2 * L) zpw[(b * 2 * L + c) * kClWarpSlots + warp] = zacc[b][j];
            }
      }
      if (timer) clk.lap(2);
      if (!zprior) cl_sync(C);  // the z heads' sums of every block are in
      if (timer) clk.lap(3);
      // 2. z = m + exp(v/2) eps in one warp (the blocks' sums added in rank
      // order), or eps; then h_d = relu(((decb + z rows, l = 0 .. L-1) + the
      // x_prev_t product)) of the block's units into every block's copy
      if (zwarp)
        for (int i = lane; i < S * L; i += 32) {
          const int b = S == 1 ? 0 : i / L, l = i - b * L;
          const float e = nz[b * NZ + l];
          float z = e;
          if (!zprior) {
            const float m = cl_zsum(zpw, b * 2 * L + l, C);
            const float v = cl_zsum(zpw, b * 2 * L + L + l, C);
            const float scale = expf(__fadd_rn(v, bz[L + l]) / 2.f);
            z = __fadd_rn(__fadd_rn(m, bz[l]), __fmul_rn(scale, e));
          }
          zs[i] = z;
        }
      __syncthreads();
      if (timer) clk.lap(4);
      const auto hd_out = [&](int b, int j, float dot) {
        float v = fold1[b * Hc + j];
        for (int l = 0; l < L; ++l) v = __fadd_rn(v, __fmul_rn(zs[b * L + l], zrows[l * Hc + j]));
        if (xp) v = __fadd_rn(v, dot);
        cl_put(hd, b * Ha + r * Hc + j, operand<WT>(fmaxf(v, 0.f)), C);
      };
      if (RG) {
        const int n = tid >> lg0;
        if (n < nun)
#pragma unroll
          for (int b = 0; b < S; ++b)
            if ((b & (g0 - 1)) == li0) hd_out(b, n, xp ? dec.v[b] : 0.f);
      } else {
        for (int i = tid; i < S * Hc; i += T) {
          const int b = S == 1 ? 0 : i / Hc, j = i - b * Hc;
          if (j < nun) hd_out(b, j, xp ? dsum[i] : 0.f);
        }
      }
      if (timer) clk.lap(5);
      cl_sync(C);
      if (timer) clk.lap(6);
      // 3. the frame head for the block's pitches: p = sigmoid(h_d.Wx + bx)
      const auto head = [&](int n, bool on, const ClSums<S> acc, const ClSums<S>) {
        if (timer) clk.lap(7);
        if (!on || n >= npt) return;
#pragma unroll
        for (int b = 0; b < S; ++b)
          if ((b & (gh - 1)) == lh) emit(n, b, 1.f / (1.f + expf(-__fadd_rn(acc.v[b], bx[n]))));
      };
      if (RG) {
        cl_layer_regs<WT, S>(wh, wh, false, Dc, lg3, y.nck[kHead], hd, nullptr, Ha, head);
      } else {
        if (t == 0) cl_mbar_wait(bars + kHead);
        cl_layer<WT, S>(sm + y.slab[kHead], nullptr, Dc, lg3, y.nck[kHead], y.rs[kHead], hd,
                        nullptr, Ha, head);
      }
      if (timer) clk.lap(8);
    } else {
      // the z heads over x_prev in every block, zmv = x_prev.Wz + zb, and the
      // frame head's x_prev_t product for the block's pitches
      const int g1 = 1 << lg1, li1 = lane & (g1 - 1);
      const auto zmv = [&](int n, bool on, const ClSums<S> acc, const ClSums<S>) {
        if (!on) return;
#pragma unroll
        for (int b = 0; b < S; ++b)
          if ((b & (g1 - 1)) == li1) zpw[b * 2 * L + n] = __fadd_rn(acc.v[b], fold0[b * 2 * L + n]);
      };
      const auto prod = [&](int n, bool on, const ClSums<S> acc, const ClSums<S>) {
        if (!on) return;
#pragma unroll
        for (int b = 0; b < S; ++b)
          if ((b & (gh - 1)) == lh) dsum[b * Dc + n] = acc.v[b];
      };
      if (!zprior) {
        if (RG) {
          cl_layer_regs<WT, S>(wa, wa, false, 2 * L, lg1, y.nck[kZh], xin, nullptr, Da, zmv);
        } else {
          if (t == 0) cl_mbar_wait(bars + kZh);
          cl_layer<WT, S>(sm + y.slab[kZh], nullptr, 2 * L, lg1, y.nck[kZh], y.rs[kZh], xin,
                          nullptr, Da, zmv);
        }
      }
      if (xp) {
        if (RG) {
          cl_layer_regs<WT, S>(wh, wh, false, Dc, lg3, y.nck[kHead], xlag, nullptr, Da, prod);
        } else {
          if (t == 0) cl_mbar_wait(bars + kHead);
          cl_layer<WT, S>(sm + y.slab[kHead], nullptr, Dc, lg3, y.nck[kHead], y.rs[kHead], xlag,
                          nullptr, Da, prod);
        }
      }
      if (timer) clk.lap(1);
      __syncthreads();
      if (timer) clk.lap(3);
      // the frame head: p = sigmoid(((xb + z rows, l = 0 .. L-1) + x_prev_t.Wx)),
      // z = m + exp(v/2) eps (or eps) in each thread
      for (int i = tid; i < S * Dc; i += T) {
        const int b = S == 1 ? 0 : i / Dc, n = i - b * Dc;
        if (n >= npt) continue;
        float v = fold1[i];
        for (int l = 0; l < L; ++l) {
          const float e = nz[b * NZ + l];
          const float z = zprior ? e
                                 : __fadd_rn(zpw[b * 2 * L + l],
                                             __fmul_rn(expf(zpw[b * 2 * L + L + l] / 2.f), e));
          v = __fadd_rn(v, __fmul_rn(z, zrows[l * Dc + n]));
        }
        if (xp) v = __fadd_rn(v, dsum[i]);
        emit(n, b, 1.f / (1.f + expf(-v)));
      }
      if (timer) clk.lap(8);
    }
    // step t + 1's noise has landed once the barrier is passed
    if (zwarp) cl_wait<kClRing - 4>();
    if (timer) clk.lap(9);
    cl_sync(C);
    if (timer) clk.lap(10);
  }
  if (timer) clk.flush();
#pragma unroll
  for (int i = 0; i < kClLayers; ++i)
    if (used[i]) cl_mbar_wait(bars + i);  // no copy outlives the block
}

ClGeom cl_geom(int D, int H, int L, int has_hidden, int use_x_prev, int eb, int C, int T, int g0,
               int g1, int g2, int g3) {
  return ClGeom{D, H, L, has_hidden, use_x_prev, eb, C, T, {g0, g1, g2, g3}};
}

// Can the register path take the geometry: one song a cluster, at most
// kClRegThreads threads, and every product it runs (with hidden layers the
// encoder's, the decoder's and the frame head's; without, the z heads' and
// the frame head's) one column a group with at most kClRegVals values a
// lane?
bool cl_regs_ok(const ClGeom& g, const ClLayout& y) {
  if (kClSongs != 1 || g.T > kClRegThreads) return false;
  const int kp = 16 / g.eb;
  for (int i = 0; i < kClLayers; ++i) {
    if (g.has_hidden && i == kZh) continue;  // read a unit at a time, not as a product
    if (y.n[i] && y.nck[i] && (y.n[i] > g.T / g.g[i] || y.nck[i] * kp > kClRegVals)) return false;
  }
  return true;
}

// the largest dynamic shared memory for an instance, once per device
template <typename WT, bool RG>
cudaError_t cl_smem_attr() {
  static unsigned set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (set & (1u << dev))) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, generate_cluster_kernel<WT, RG>);
  if (err != cudaSuccess) return err;
  if (fa.sharedSizeBytes > (size_t)kClStatic) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(generate_cluster_kernel<WT, RG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit - (int)fa.sharedSizeBytes);
  if (err == cudaSuccess) set |= 1u << dev;
  return err;
}

// a launch's configuration: `clusters` clusters of C blocks of T threads
struct ClLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClLaunch(int clusters, int C, int T, unsigned smem, cudaStream_t stream) : cfg{}, attr{} {
    cfg.gridDim = dim3(clusters * C);
    cfg.blockDim = dim3(T);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

template <typename WT, bool RG>
int launch_cluster(const ClArgs& a, cudaStream_t stream) {
  cudaError_t err = cl_smem_attr<WT, RG>();
  if (err != cudaSuccess) return (int)err;
  ClLaunch l(cdiv(a.B, kClSongs), a.geom.C, a.geom.T, a.y.bytes, stream);
  err = cudaLaunchKernelEx(&l.cfg, generate_cluster_kernel<WT, RG>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the clusters of the instance's layout the card holds at once
template <typename WT, bool RG>
int max_clusters(int C, int T, unsigned smem, int* result) {
  cudaError_t err = cl_smem_attr<WT, RG>();
  if (err != cudaSuccess) return (int)err;
  ClLaunch l(kClMaxC * 132, C, T, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(result, generate_cluster_kernel<WT, RG>, &l.cfg);
}

// Returns, in lane b < kSongs, sum_k a[k][b] * wrow[k]: the warp's lanes split
// k and a shuffle butterfly adds their partial sums.
template <typename WT>
__device__ __forceinline__ float warp_dot(const float* a, const WT* wrow, int K, int lane) {
  float s[kSongs];
#pragma unroll
  for (int b = 0; b < kSongs; ++b) s[b] = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float w = ld(wrow + k);
#pragma unroll
    for (int b = 0; b < kSongs; ++b) s[b] = fmaf(a[k * kSongs + b], w, s[b]);
  }
  float mine = 0.f;
#pragma unroll
  for (int b = 0; b < kSongs; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[b] += __shfl_xor_sync(0xffffffffu, s[b], off);
    if (lane == b) mine = s[b];
  }
  return mine;
}

// ------------------------------------------------------------ the wide kernel

constexpr int kWideThreads = 512;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kMaxSlices = 16;  // K-split groups of a layer with few columns
constexpr size_t kPartialFloats = (size_t)kWideThreads * kSongs;

// WT: the type of the large weights (f32, or bf16 with hidden layers)
template <typename WT>
struct WideArgs {
  const float* seed;   // [B, D]
  const float* eps;    // [B, nsteps, L]
  const float* u;      // [B, nsteps, D]
  const WT* wke;       // [D, H]  encoder x rows (hidden layers only)
  const float* encb;   // [B, H]  w rows . w + bias, per song
  const WT* wkd_x;     // [D, H]  decoder x_prev rows (hidden layers and use_x_prev)
  const float* wkd_z;  // [L, H]  decoder z rows, f32
  const float* decb;   // [B, H]
  const WT* wz_t;      // [2L, E] z heads over e (h_e, E = H; without hidden layers x_prev, E = D)
  const float* zb;     // z-head bias: [2L] (zb_stride 0) or the per-song fold [B, 2L]
  const WT* wx;        // [H, D]  frame head (hidden layers only)
  const float* wx_z;   // [L, D]  frame head z rows, f32 (no hidden layers)
  const WT* wx_xp;     // [D, D]  frame head x_prev rows (no hidden layers, use_x_prev)
  const float* xb;     // frame-head bias: [D] (xb_stride 0) or the per-song fold [B, D]
  float* out;          // [B, nsteps, D]
  float* state;        // null: per-song state in shared memory; else [grid, state floats]
  int zb_stride, xb_stride;
  int B, nsteps, D, H, L, has_hidden, use_x_prev, use_z_prior, return_probs;
};

// per-song state of one block: x_prev, x_prev_t and the step's probabilities
// ([D][kSongs] each), z ([L][kSongs]), and with hidden layers h_e and h_d
// ([H][kSongs] each)
__host__ __device__ constexpr size_t wide_state_floats(int D, int H, int L, int has_hidden) {
  return (size_t)kSongs * (3 * D + L + (has_hidden ? 2 * H : 0));
}

// One operand of a layer: a [k][kSongs] tile (shared or scratch memory)
// times a [k, N] row-major weight in global memory (f32, or bf16 widened to
// f32); k = 0 skips it.
template <typename W>
struct Op {
  const float* a;
  const W* w;
  int k;
};

__device__ __forceinline__ float ldg_w(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_w(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// acc[b] += sum_{k0 <= k < k1} a[k][b] * w[k * N + n]
template <typename W>
__device__ __forceinline__ void mac_rows(float (&acc)[kSongs], const Op<W>& o, int N, int n,
                                         int k0, int k1) {
  if (k0 >= k1) return;
  const W* wp = o.w + (size_t)k0 * N + n;
#pragma unroll 16
  for (int k = k0; k < k1; ++k, wp += N) {
    const float wv = ldg_w(wp);
#pragma unroll
    for (int b = 0; b < kSongs; ++b) acc[b] = fmaf(o.a[k * kSongs + b], wv, acc[b]);
  }
}

// K-split groups for a layer of N columns: all threads busy, at most kMaxSlices
__device__ __forceinline__ int slices_for(int N) {
  const int s = kWideThreads / N;
  return s < 1 ? 1 : (s > kMaxSlices ? kMaxSlices : s);
}

// out(n, b) = sum over both operands of sum_k a[k][b] * w[k * N + n], handed
// to epi(n, b, value) exactly once for each column n < N and song b. Wide
// layers give each thread whole columns; narrow ones split the K rows of each
// operand across S groups, whose partial sums meet in `partial` after a
// barrier and are added in group order. The caller syncs before the next
// layer reads what epi stored.
template <typename W1, typename W2, typename Epi>
__device__ __forceinline__ void cols_layer(const Op<W1>& o1, const Op<W2>& o2, int N,
                                           float* partial, Epi epi) {
  const int S = slices_for(N);
  if (S == 1) {
    for (int n = threadIdx.x; n < N; n += kWideThreads) {
      float acc[kSongs];
#pragma unroll
      for (int b = 0; b < kSongs; ++b) acc[b] = 0.f;
      mac_rows(acc, o1, N, n, 0, o1.k);
      mac_rows(acc, o2, N, n, 0, o2.k);
#pragma unroll
      for (int b = 0; b < kSongs; ++b) epi(n, b, acc[b]);
    }
    return;
  }
  const int s = threadIdx.x / N, n = threadIdx.x - s * N;
  if (s < S) {
    float acc[kSongs];
#pragma unroll
    for (int b = 0; b < kSongs; ++b) acc[b] = 0.f;
    mac_rows(acc, o1, N, n, o1.k * s / S, o1.k * (s + 1) / S);
    mac_rows(acc, o2, N, n, o2.k * s / S, o2.k * (s + 1) / S);
#pragma unroll
    for (int b = 0; b < kSongs; ++b) partial[(s * N + n) * kSongs + b] = acc[b];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N * kSongs; i += kWideThreads) {
    const int col = i / kSongs, b = i - col * kSongs;
    float v = 0.f;
    for (int q = 0; q < S; ++q) v += partial[(q * N + col) * kSongs + b];
    epi(col, b, v);
  }
}

// z = m + exp(v/2) * eps (or eps under use_z_prior) for the tile's songs,
// the heads over e [E][kSongs]; one warp per latent, its lanes splitting E
template <typename WT>
__device__ __forceinline__ void z_draw(const WideArgs<WT>& a, const float* e, int E, float* zs,
                                       int t, int s0) {
  const WT* wz = a.wz_t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, L = a.L;
  for (int l = warp; l < L; l += kWideWarps) {
    const float zm = warp_dot(e, wz + (size_t)l * E, E, lane);
    const float zv = warp_dot(e, wz + (size_t)(L + l) * E, E, lane);
    const int s = s0 + lane;
    if (lane < kSongs) {
      float z = 0.f;
      if (s < a.B) {
        const float* zb = a.zb + (size_t)s * a.zb_stride;
        const float ep = a.eps[((size_t)s * a.nsteps + t) * L + l];
        z = a.use_z_prior ? ep : (zm + zb[l]) + expf((zv + zb[L + l]) / 2.f) * ep;
      }
      zs[l * kSongs + lane] = z;
    }
  }
}

// bf16 mode: the weights are read as bf16 and h_e, h_d are stored rounded
// to bf16 (`operand`), as they are only ever read as operands; the frames
// are binary, z, the z rows and every bias f32, every sum f32 (the cluster
// kernel's rounding points).
template <typename WT>
__global__ void __launch_bounds__(kWideThreads) generate_wide_kernel(const WideArgs<WT> a) {
  extern __shared__ float4 smem4[];
  float* partial = reinterpret_cast<float*>(smem4);  // [kPartialFloats]
  const int D = a.D, H = a.H, L = a.L;
  float* st = a.state ? a.state + (size_t)blockIdx.x * wide_state_floats(D, H, L, a.has_hidden)
                      : partial + kPartialFloats;
  float* xp = st;                 // [D][kSongs]  x_prev (the encoder's input)
  float* xpt = xp + D * kSongs;   // [D][kSongs]  x_prev_t (the decoder's, one step behind)
  float* pm = xpt + D * kSongs;   // [D][kSongs]  the step's frame probabilities
  float* zs = pm + D * kSongs;    // [L][kSongs]
  float* he = zs + L * kSongs;    // [H][kSongs]  with hidden layers
  float* hd = he + H * kSongs;    // [H][kSongs]  with hidden layers
  const int s0 = blockIdx.x * kSongs;
  const auto fold = [&](const float* f, int stride, int b, int n) {
    const int s = s0 + b;
    return s < a.B ? f[(size_t)s * stride + n] : 0.f;
  };

  for (int i = threadIdx.x; i < D * kSongs; i += kWideThreads) {
    const int d = i / kSongs, b = i % kSongs, s = s0 + b;
    const float x = s < a.B ? a.seed[(size_t)s * D + d] : 0.f;
    xp[i] = x;
    xpt[i] = x;
  }
  __syncthreads();

  const Op<float> none{nullptr, nullptr, 0};
  const auto prob = [&](int d, int b, float acc) {
    pm[d * kSongs + b] = 1.f / (1.f + expf(-(acc + fold(a.xb, a.xb_stride, b, d))));
  };
  for (int t = 0; t < a.nsteps; ++t) {
    if (a.has_hidden) {
      // z-encoder hidden: h_e = relu(x_prev @ Wke + encb)
      cols_layer(Op<WT>{xp, a.wke, D}, none, H, partial, [&](int n, int b, float acc) {
                   he[n * kSongs + b] = operand<WT>(fmaxf(acc + fold(a.encb, H, b, n), 0.f));
                 });
      __syncthreads();
      z_draw(a, he, H, zs, t, s0);
      __syncthreads();
      // decoder hidden: h_d = relu(decb + sum_l z_l Wkd_z[l] (+ x_prev_t @ Wkd_x))
      cols_layer(Op<float>{zs, a.wkd_z, L}, Op<WT>{xpt, a.wkd_x, a.use_x_prev ? D : 0}, H,
                 partial, [&](int n, int b, float acc) {
                   hd[n * kSongs + b] = operand<WT>(fmaxf(acc + fold(a.decb, H, b, n), 0.f));
                 });
      __syncthreads();
      // frame head: p = sigmoid(h_d @ Wx + bx)
      cols_layer(Op<WT>{hd, a.wx, H}, none, D, partial, prob);
    } else {
      // z heads over x_prev (w rows folded into zb)
      z_draw(a, xp, D, zs, t, s0);
      __syncthreads();
      // frame head: p = sigmoid(xb + sum_l z_l Wx_z[l] (+ x_prev_t @ Wx_xp))
      cols_layer(Op<float>{zs, a.wx_z, L}, Op<WT>{xpt, a.wx_xp, a.use_x_prev ? D : 0}, D, partial,
                 prob);
    }
    __syncthreads();
    // Bernoulli draw, both carries (the lagged frame takes the old x_prev
    // first), output
    for (int i = threadIdx.x; i < D * kSongs; i += kWideThreads) {
      const int d = i / kSongs, b = i % kSongs, s = s0 + b;
      if (s >= a.B) continue;
      const float xm = pm[i];
      const float xt = a.u[((size_t)s * a.nsteps + t) * D + d] < xm ? 1.f : 0.f;
      xpt[i] = xp[i];
      xp[i] = xt;
      a.out[((size_t)s * a.nsteps + t) * D + d] = a.return_probs ? xm : xt;
    }
    __syncthreads();
  }
}

size_t wide_smem_bytes(int D, int H, int L, int has_hidden, int state_in_smem) {
  return (kPartialFloats + (state_in_smem ? wide_state_floats(D, H, L, has_hidden) : 0)) *
         sizeof(float);
}

template <typename WT>
int launch_wide(const WideArgs<WT>& a, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(a.D, a.H, a.L, a.has_hidden, a.state == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      generate_wide_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.B + kSongs - 1) / kSongs);
  generate_wide_kernel<WT><<<grid, kWideThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------ the cooperative kernel

constexpr int kCThreads = 512;               // 16 warps a block
constexpr int kCWarps = kCThreads / 32;
constexpr int kCRows = 64;                   // songs of a launch: 4 m16 tiles
constexpr int kChunkBytes = 32;              // a chunk of a row: 32 int8 codes, 16 bf16, 8 f32
constexpr int kTileBytes = 256;              // one n8 tile's chunk of packed weights
constexpr int kCPS = 8;                      // chunks a ring stage
constexpr int kRing = 4;                     // ring stages
constexpr int kMaxNT = 8;                    // n8 tiles of one product pass
constexpr int kRowStride = kCPS * kChunkBytes + 16;   // a row of a stage's operand, padded
constexpr int kAStage = kCRows * kRowStride;          // the operand bytes of a stage

// The element type E of a mode's products: int8 codes summed in int32 on
// the int8 tensor cores (the z heads bf16), bf16 values summed in f32 on the
// bf16 tensor cores, or f32 values summed on FFMA (the z heads f32).
template <typename E>
struct Mode {
  using Acc = float;
  using Z = E;
};
template <>
struct Mode<signed char> {
  using Acc = int;
  using Z = __nv_bfloat16;
};

struct CoopArgs {
  const float* seed;           // [B, D]
  const float* eps;            // [B, nsteps, L]
  const float* u;              // [B, nsteps, D]
  const int* wke;              // [G][KCx][NT][64] words: encoder x rows, the block's units
  const int* wkd;              // [G][KCx][NT][64]: decoder x_prev rows (use_x_prev, else null)
  const int* wx;               // [G][KCh][P][64]: the frame head, the block's pitch tiles
  const float* ske;            // [H]  int8: scales of the encoder x rows (else null)
  const float* skd;            // [H]  int8: scales of the decoder x_prev rows (or null)
  const float* encb;           // [B, H]  w rows . w + bias, per song
  const float* decb;           // [B, H]
  const void* wz_t;            // [2L, H]  z_mean | z_log_var kernels, transposed (Mode::Z)
  const float* bz;             // [2L]
  const float* wkd_z;          // [L, H]  decoder z rows, f32
  const float* swx;            // [D]  int8: scales of the frame head (else null)
  const float* bx;             // [D]
  float* out;                  // [B, nsteps, D]
  // the state shared between blocks, in global memory, zeroed by the caller
  // (`coop_state` cuts it from one buffer)
  int* xq;                     // [2][kCRows][KCx * 8] words: x_prev as operands, double-buffered
  int* hq;                     // [kCRows][KCh * 8] words: h_d as operands (int8: round(h_d / rs))
  double* zpart;               // [G][kCRows][2L]: the z heads summed over each block's units
  float* zs;                   // [kCRows][L]: the step's z
  float* hmax;                 // [G][kCRows]: int8, each block's largest h_d per song
  unsigned* bar;               // arrivals at the grid barrier
  unsigned long long* clock;   // [kLaps] or null: block 0's ns per part of a step
  int B, nsteps, D, H, L, use_x_prev, use_z_prior, return_probs;
  int nu;                      // hidden units a block owns (a multiple of 8)
  int P, hs;                   // pitch tiles a block, song groups of the frame head
  int res_cells, res_head;     // the x-row slices / the head's tiles resident in shared memory
};

// n8 tiles of weights a ring chunk carries: those of the widest streamed pass
__host__ __device__ constexpr int stream_tiles(int nu, int P, int res_cells, int res_head) {
  return imin(kMaxNT, imax(res_cells ? 0 : nu / 8, res_head ? 0 : P));
}
__host__ __device__ constexpr size_t ring_bytes(int wt) {
  return (size_t)kRing * (kAStage + (size_t)kCPS * wt * kTileBytes);
}

// dynamic shared memory of a block whose operands are `eb` bytes (1 int8, 2
// bf16, 4 f32): the ring (operands of kCPS chunks a stage and the streamed
// weights' chunks; after a pass, the warps' sums), the resident slices, the
// block's columns of the z heads in double ([nu][2L]), then f32: h_e / h_d
// ([kCRows][nu]), the block's columns of the two int8 scales ([nu] each)
// and of the decoder's z rows ([L][nu]), the z of the songs ([kCRows][L])
// and their int8 rs
__host__ __device__ constexpr size_t coop_smem_bytes(int D, int H, int L, int nu, int P,
                                                     int use_x_prev, int res_cells, int res_head,
                                                     int eb) {
  return ring_bytes(stream_tiles(nu, P, res_cells, res_head)) +
         (res_cells ? (size_t)cdiv(D, kChunkBytes / eb) * (1 + use_x_prev) * (nu / 8) * kTileBytes
                    : 0) +
         (res_head ? (size_t)cdiv(H, kChunkBytes / eb) * P * kTileBytes : 0) +
         (size_t)nu * 2 * L * sizeof(double) +
         ((size_t)kCRows * nu + (size_t)nu * (2 + L) + (size_t)kCRows * (L + 1)) * sizeof(float);
}

// the global state, in 4-byte words, each part a multiple of 16 bytes
struct CoopState {
  size_t xq, hq, zpart, zs, hmax, bar, total;
};
__host__ __device__ inline CoopState coop_state(int D, int H, int L, int G, int eb) {
  const size_t xw = (size_t)cdiv(D, kChunkBytes / eb) * 8;
  const size_t hw = (size_t)cdiv(H, kChunkBytes / eb) * 8;
  CoopState st{};
  st.xq = 0;
  st.hq = st.xq + 2 * kCRows * xw;
  st.zpart = st.hq + kCRows * hw;
  st.zs = st.zpart + (size_t)G * kCRows * 2 * L * 2;
  st.hmax = st.zs + (size_t)kCRows * L;
  st.bar = st.hmax + (size_t)G * kCRows;
  st.total = st.bar + 4;
  return st;
}

__host__ __device__ constexpr int ksplit(int mt) {
  return kCWarps / mt < kCPS ? kCWarps / mt : kCPS;
}

__device__ __forceinline__ float as_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }

// One product pass: the sums of song rows m0 .. m0 + 16 mt - 1 (mt <= 4)
// and n8 tiles n0 .. n0 + nt - 1 (nt <= kMaxNT) of a block's packed weight
// ([nch][ntot][64] words, chunk after chunk: in shared memory at `wres`, or
// streamed from global memory at `wg` when `wres` is null), times the
// operands `aq` (global, `aw` words a row, chunk c at words 8c .. 8c + 7).
// A packed tile's chunk holds its 8 columns one after the other, each
// column's 32 bytes of k in order (`pack_units`). The chunks stream through
// a ring of kRing stages of kCPS chunks (`cp.async`, L2 only: the operands
// are rewritten by other blocks every step). A stage holds each row's kCPS
// chunks as one contiguous 256-byte span (with resident weights, 2 or 4
// times that for a pass of 32 or 16 rows), copied by neighbouring threads
// (whole 128-byte lines a warp), and keeps it in shared memory a padded row
// apart, so that the loads of 8 rows fall on distinct banks. Every block
// reads the same operands: each starts at its own stage, so that the blocks
// do not all ask the same L2 lines at once. Warp (wm, kq) takes m-tile wm,
// all nt n-tiles, and the chunks q = kq, kq + nks, ... of each stage (nks =
// ksplit(mt)). int8 and bf16 run on the tensor cores (`mma.sync`
// m16n8k32 s8 -> s32, m16n8k16 bf16 -> f32): lane (g, t) holds rows g and g
// + 8, bytes 8t .. 8t + 7 of a chunk (one 8-byte load a row), and column
// g's same bytes of each tile, so that A and B pair the same k (any pairing
// of k gives the same products). f32 runs on FFMA in the same output layout
// (rows g, g + 8, columns 2t, 2t + 1 of each tile), summing the chunk's 8 k
// in order. The warps' sums are staged in the ring ([nks][16 mt][8 nt], at
// most 64 KB, within the ring) and added in warp order (int32: exact) into
// the first [16 mt][8 nt], which the function returns after a block
// barrier.
template <typename E>
__device__ __forceinline__ const typename Mode<E>::Acc* products(
    const int* aq, int aw, int nch, const int* wres, const int* __restrict__ wg, int ntot, int n0,
    int nt, int m0, int mt, unsigned char* ring) {
  using Acc = typename Mode<E>::Acc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nks = ksplit(mt), wm = warp % mt, kq = warp / mt;
  const bool active = kq < nks;
  const int rows = 16 * mt;
  // with resident weights a pass of 32 or 16 rows takes 2 or 4 times the
  // chunks a stage, so that a stage keeps its bytes (and the ring as many in
  // flight); the pieces of a stage stay 2 kCPS kCRows
  const int shift = wres ? (mt == 1 ? 2 : mt == 2 ? 1 : 0) : 0;
  const int cps = kCPS << shift, stride = cps * kChunkBytes + 16;  // chunks a stage, row bytes
  const int nst = cdiv(nch, cps);
  const int rot = (int)(((long long)blockIdx.x * nst) / gridDim.x);  // this block's first stage
  const int sb = kAStage + (wres ? 0 : kCPS * nt * kTileBytes);       // bytes a stage
  Acc acc[kMaxNT][4];
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0;
  // stage s (the chunks of stage (s + rot) % nst): operands [rows][stride]
  // (a row's chunks side by side), streamed weights [kCPS][nt][256 B];
  // 16-byte pieces dealt to the threads at fixed strides (no division): 2
  // cps pieces a row, and 128 weight slots a chunk
  static_assert(kCRows * 2 * kCPS % kCThreads == 0 && kCPS * 16 * kMaxNT % kCThreads == 0 &&
                16 * kMaxNT == 128, "whole rounds of pieces");
  auto load = [&](int s) {
    unsigned char* A = ring + (s % kRing) * sb;
    unsigned char* Bw = A + kAStage;
    const int c0 = ((s + rot) % nst) * cps;  // the stage's first chunk
#pragma unroll
    for (int e = 0; e < kCRows * 2 * kCPS / kCThreads; ++e) {
      const int i = tid + e * kCThreads, row = i >> (4 + shift), p = i & ((16 << shift) - 1);
      const int ch = c0 + p / 2;
      if (row < rows && ch < nch)  // the operands: row, chunk p / 2, half p % 2
        cvl_tc::cp_async16(A + row * stride + p * 16,
                           aq + (size_t)(m0 + row) * aw + ch * 8 + (p % 2) * 4, true);
    }
    if (!wres) {
#pragma unroll
      for (int e = 0; e < kCPS * 128 / kCThreads; ++e) {
        const int i = tid + e * kCThreads, q = i / 128, r = i % 128, ch = c0 + q;
        if (r < 16 * nt && ch < nch)  // the weights: piece r of the chunk's nt tiles
          cvl_tc::cp_async16(Bw + q * nt * kTileBytes + r * 16,
                             wg + ((size_t)ch * ntot + n0) * 64 + r * 4, true);
      }
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
    const int c0 = ((s + rot) % nst) * cps;
    for (int q = kq; q < cps; q += nks) {
      const int ch = c0 + q;
      if (ch >= nch) break;
      const unsigned char* ar = A + (wm * 16 + g) * stride + q * kChunkBytes;
      const unsigned char* br =
          wres ? reinterpret_cast<const unsigned char*>(wres + ((size_t)ch * ntot + n0) * 64)
               : Bw + q * nt * kTileBytes;
      if constexpr (sizeof(E) == 4) {
        // rows g and g + 8: the chunk's 8 k each
        const float4* a4 = reinterpret_cast<const float4*>(ar);
        const float4* a8 = reinterpret_cast<const float4*>(ar + 8 * stride);
        const float4 r0[2] = {a4[0], a4[1]}, r1[2] = {a8[0], a8[1]};
        const float x0[8] = {r0[0].x, r0[0].y, r0[0].z, r0[0].w, r0[1].x, r0[1].y, r0[1].z, r0[1].w};
        const float x1[8] = {r1[0].x, r1[0].y, r1[0].z, r1[0].w, r1[1].x, r1[1].y, r1[1].z, r1[1].w};
#pragma unroll
        for (int n = 0; n < kMaxNT; ++n) {
          if (n >= nt) break;
          // columns 2t and 2t + 1 of the tile: 8 k each
          const float4* b4 = reinterpret_cast<const float4*>(br + n * kTileBytes + t * 64);
          const float4 c0v[2] = {b4[0], b4[1]}, c1v[2] = {b4[2], b4[3]};
          const float w0[8] = {c0v[0].x, c0v[0].y, c0v[0].z, c0v[0].w,
                               c0v[1].x, c0v[1].y, c0v[1].z, c0v[1].w};
          const float w1[8] = {c1v[0].x, c1v[0].y, c1v[0].z, c1v[0].w,
                               c1v[1].x, c1v[1].y, c1v[1].z, c1v[1].w};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            acc[n][0] = fmaf(x0[k], w0[k], acc[n][0]);
            acc[n][1] = fmaf(x0[k], w1[k], acc[n][1]);
            acc[n][2] = fmaf(x1[k], w0[k], acc[n][2]);
            acc[n][3] = fmaf(x1[k], w1[k], acc[n][3]);
          }
        }
      } else {
        const uint2 lo = *reinterpret_cast<const uint2*>(ar + t * 8);
        const uint2 hi = *reinterpret_cast<const uint2*>(ar + 8 * stride + t * 8);
        const unsigned af[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int n = 0; n < kMaxNT; ++n) {
          if (n >= nt) break;
          const uint2 b = *reinterpret_cast<const uint2*>(br + n * kTileBytes + lane * 8);
          if constexpr (sizeof(E) == 1)
            mma_s8(acc[n], af, b.x, b.y);
          else
            cvl_tc::mma_bf16(acc[n], af, b.x, b.y);
        }
      }
    }
  }
  cvl_tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial sums go in it
  // [nks][rows][8 nt]: row g (+8), columns 2t, 2t + 1 of each tile
  const int cols = 8 * nt, part = rows * cols;
  Acc* stg = reinterpret_cast<Acc*>(ring);
  if (active) {
#pragma unroll
    for (int n = 0; n < kMaxNT; ++n) {
      if (n >= nt) break;
      Acc* r0 = stg + (size_t)kq * part + (wm * 16 + g) * cols + n * 8 + 2 * t;
      r0[0] = acc[n][0];
      r0[1] = acc[n][1];
      r0[8 * cols] = acc[n][2];
      r0[8 * cols + 1] = acc[n][3];
    }
  }
  __syncthreads();
  for (int e = tid; e < part; e += kCThreads) {  // the warps' partial sums, in warp order
    Acc sum = stg[e];
    for (int k = 1; k < nks; ++k) sum += stg[(size_t)k * part + e];
    stg[e] = sum;
  }
  __syncthreads();
  return stg;
}

__device__ __forceinline__ void copy16(int* dst, const int* src, size_t bytes) {
  for (size_t i = threadIdx.x; i < bytes / 16; i += kCThreads)
    reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
}

// element `col` of song row s of an operand buffer (`row_words` words a row)
template <typename E>
__device__ __forceinline__ void put(int* words, int row_words, int s, int col, E v) {
  reinterpret_cast<E*>(words)[(size_t)s * row_words * (4 / sizeof(E)) + col] = v;
}

// a frame's value (0 or 1, or a seed's) as an operand of the mode; in f32
// and bf16 also a value of h_d
template <typename E>
__device__ __forceinline__ E to_operand(float x) {
  return x;
}
template <>
__device__ __forceinline__ signed char to_operand<signed char>(float x) {
  return static_cast<signed char>(__float2int_rz(x));  // binary frames are exact codes
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_operand<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float ldz(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ldz(const float* p) { return *p; }

// The largest value per row r < rows of vals(g, r) over g < G (a max is exact
// in any order; every value >= 0): 8 threads a row, each loading its blocks
// g = p, p + 8, ... all at once (G <= kMaxBlocks), then a butterfly over the
// 8; then fin(r, the max)
constexpr int kMaxBlocks = 136;
template <typename V, typename Fin>
__device__ __forceinline__ void row_max(int rows, int G, V vals, Fin fin) {
  constexpr int kParts = 8, kPer = (kMaxBlocks + kParts - 1) / kParts;
  static_assert(kCThreads == kCRows * kParts, "8 threads a row");
  const int r = threadIdx.x / kParts, p = threadIdx.x % kParts;
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int g = p + k * kParts;
    v[k] = r < rows && g < G ? vals(g, r) : 0.f;
  }
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) m = fmaxf(m, v[k]);
#pragma unroll
  for (int off = kParts / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (p == 0 && r < rows) fin(r, m);
}

// Block 0's clock of a step's parts: the encoder's products, its epilogue
// and the z heads' sums, its wait; z, its wait; the decoder (products,
// epilogue, int8 maxima or the h_d operands), its wait; int8 rs and the
// codes, their wait (0 in f32 and bf16); the frame head's products, its
// epilogue, its wait
constexpr int kLaps = 12;
using CoopClock = cvl_coop::PhaseClock<kLaps>;

// One persistent cooperative launch for the whole song of at most kCRows
// songs: every block owns nu hidden units for every song, and a slice of the
// frame head's pitches for a group of the songs; a step is five phases with a
// grid barrier after each in int8 (three under use_z_prior), four in f32 and
// bf16 (two under use_z_prior), whose h_d needs no song scale.
template <typename E>
__global__ void __launch_bounds__(kCThreads, 1) generate_vae_coop_kernel(const CoopArgs a) {
  using Z = typename Mode<E>::Z;
  constexpr bool kI8 = sizeof(E) == 1;
  constexpr int kPer = kChunkBytes / (int)sizeof(E);  // k of a chunk
  extern __shared__ int4 smem_i4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem_i4);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = a.D, H = a.H, L = a.L, B = a.B, nu = a.nu, NT = nu / 8, P = a.P;
  const int kcx = cdiv(D, kPer), kch = cdiv(H, kPer), xw = kcx * 8, hw = kch * 8;
  const int Bp = round16(B), mt = Bp / 16, G = gridDim.x;
  const int u0 = blockIdx.x * nu, nun = imin(nu, H - u0);  // the block's units
  const size_t cellw = (size_t)kcx * NT * 64, headw = (size_t)kch * P * 64;  // words a slice
  const int* gke = a.wke + blockIdx.x * cellw;
  const int* gkd = a.use_x_prev ? a.wkd + blockIdx.x * cellw : nullptr;
  const int* gx = a.wx + blockIdx.x * headw;
  int* cells = reinterpret_cast<int*>(ring + ring_bytes(stream_tiles(nu, P, a.res_cells,
                                                                     a.res_head)));
  int* head = cells + (a.res_cells ? cellw * (1 + a.use_x_prev) : 0);
  double* wz = reinterpret_cast<double*>(head + (a.res_head ? headw : 0));  // [nu][2L] z heads
  float* hv = reinterpret_cast<float*>(wz + 2 * L * nu);  // [kCRows][nu]
  float* sk = hv + kCRows * nu;      // [nu]  int8 scales of the encoder x rows
  float* sd = sk + nu;               // [nu]  of the decoder x_prev rows
  float* wzd = sd + nu;              // [L][nu]  decoder z rows
  float* zsm = wzd + L * nu;         // [kCRows][L]
  float* rs = zsm + kCRows * L;      // [kCRows]  int8
  const int *wke = nullptr, *wkd = nullptr, *wxs = nullptr;
  if (a.res_cells) {  // the block's slices, copied once (16-byte pieces)
    copy16(cells, gke, cellw * 4);
    wke = cells;
    if (a.use_x_prev) {
      copy16(cells + cellw, gkd, cellw * 4);
      wkd = cells + cellw;
    }
  }
  if (a.res_head) {
    copy16(head, gx, headw * 4);
    wxs = head;
  }
  for (int j = tid; j < nu; j += kCThreads) {
    sk[j] = kI8 && j < nun ? a.ske[u0 + j] : 0.f;
    sd[j] = kI8 && j < nun && a.use_x_prev ? a.skd[u0 + j] : 0.f;
  }
  for (int i = tid; i < L * nu; i += kCThreads) {
    const int l = i / nu, j = i - l * nu;
    wzd[i] = j < nun ? a.wkd_z[(size_t)l * H + u0 + j] : 0.f;
  }
  const Z* wz_t = static_cast<const Z*>(a.wz_t);
  for (int i = tid; i < 2 * L * nu; i += kCThreads) {
    const int j = i / (2 * L), c = i - j * 2 * L;
    wz[i] = j < nun ? (double)ldz(wz_t + (size_t)c * H + u0 + j) : 0.0;
  }
  // both carried frames start as the seed
  const size_t xbuf = (size_t)kCRows * xw;
  for (int i = blockIdx.x * kCThreads + tid; i < B * D; i += G * kCThreads) {
    const int s = i / D, d = i - s * D;
    const E x = to_operand<E>(a.seed[(size_t)s * D + d]);
    put(a.xq, xw, s, d, x);
    put(a.xq + xbuf, xw, s, d, x);
  }
  unsigned rounds = 0;
  grid_sync(a.bar, rounds);
  __shared__ CoopClock clk;  // thread 0 of block 0 keeps it
  const bool timer = tid == 0;
  if (timer) {
    clk.out = blockIdx.x == 0 ? a.clock : nullptr;
    clk.start();
  }
  // the frame head's share of the block: pitch group pg, song group sg
  const int pg = blockIdx.x / a.hs, sg = blockIdx.x - pg * a.hs;
  const int mtg = cdiv(mt, a.hs), m0 = 16 * sg * mtg, mtn = imin(mtg, mt - sg * mtg);
  const bool heads = mtn > 0 && pg * P < cdiv(D, 8);
  for (int t = 0; t < a.nsteps; ++t) {
    const int cur = t & 1;
    const int* xin = a.xq + cur * xbuf;  // x_prev, the encoder's input
    int* xlag = a.xq + (cur ^ 1) * xbuf;  // x_prev_t, the decoder's, one step behind
    if (!a.use_z_prior) {
      // 1. encoder: h_e = relu(x_prev.Wke (* ske) + encb), kept at the z
      // heads' operand values, then the z heads summed over the block's units
      for (int n0 = 0; n0 < NT; n0 += kMaxNT) {
        const int nt = imin(kMaxNT, NT - n0);
        const auto* sums = products<E>(xin, xw, kcx, wke, gke, NT, n0, nt, 0, mt, ring);
        if (timer) clk.lap(0);
        for (int i = tid; i < Bp * 8 * nt; i += kCThreads) {
          const int r = i / (8 * nt), j = 8 * n0 + i - r * 8 * nt;
          float v = 0.f;
          if (r < B && j < nun) {
            const float p = kI8 ? __fmul_rn(as_f32(sums[i]), sk[j]) : as_f32(sums[i]);
            v = operand<Z>(fmaxf(__fadd_rn(p, a.encb[(size_t)r * H + u0 + j]), 0.f));
          }
          hv[r * nu + j] = v;
        }
        __syncthreads();
      }
      // the z heads over the block's units, each sum in unit order, in
      // double (a product of two bf16 or f32 values is exact): a thread takes
      // a row and kZCols of its columns c, c + 8, ..., converting each h_e
      // once
      {
        constexpr int kZGroups = kCThreads / kCRows, kZCols = 4;
        const int r = tid / kZGroups, cg = tid % kZGroups;
        for (int c0 = 0; c0 < 2 * L; c0 += kZGroups * kZCols) {
          double acc[kZCols] = {0.0, 0.0, 0.0, 0.0};
          if (r < Bp)
            for (int j = 0; j < nun; ++j) {
              const double h = hv[r * nu + j];
#pragma unroll
              for (int k = 0; k < kZCols; ++k) {
                const int c = c0 + cg + kZGroups * k;
                if (c < 2 * L) acc[k] = fma(h, wz[j * 2 * L + c], acc[k]);
              }
            }
#pragma unroll
          for (int k = 0; k < kZCols; ++k) {
            const int c = c0 + cg + kZGroups * k;
            if (r < Bp && c < 2 * L)
              a.zpart[((size_t)blockIdx.x * kCRows + r) * 2 * L + c] = acc[k];
          }
        }
      }
      if (timer) clk.lap(1);
      grid_sync(a.bar, rounds);
      if (timer) clk.lap(2);
      // 2. z = m + exp(v/2) eps, one warp a (song, latent): lane l adds the
      // blocks l, l + 32, ... in order, a butterfly adds the lanes, all in
      // double, rounded to f32 once; then the JAX kernel's f32 order
      constexpr int kZPer = (kMaxBlocks + 31) / 32;
      for (int job = blockIdx.x * kCWarps + warp; job < B * L; job += G * kCWarps) {
        const int s = job / L, l = job - s * L;
        const float e = a.eps[((size_t)s * a.nsteps + t) * L + l];
        double pm[kZPer], pv[kZPer];
#pragma unroll
        for (int k = 0; k < kZPer; ++k) {
          const int g = lane + 32 * k;
          const double* p = a.zpart + ((size_t)g * kCRows + s) * 2 * L;
          pm[k] = g < G ? __ldcg(p + l) : 0.0;
          pv[k] = g < G ? __ldcg(p + L + l) : 0.0;
        }
        double zm = 0.0, zv = 0.0;
#pragma unroll
        for (int k = 0; k < kZPer; ++k) {
          zm += pm[k];
          zv += pv[k];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          zm += __shfl_xor_sync(0xffffffffu, zm, off);
          zv += __shfl_xor_sync(0xffffffffu, zv, off);
        }
        if (lane == 0) {
          const float scale = expf(__fadd_rn(__double2float_rn(zv), a.bz[L + l]) / 2.f);
          a.zs[s * L + l] =
              __fadd_rn(__fadd_rn(__double2float_rn(zm), a.bz[l]), __fmul_rn(scale, e));
        }
      }
      if (timer) clk.lap(3);
      grid_sync(a.bar, rounds);
      if (timer) clk.lap(4);
    }
    // 3. decoder: h_d = relu(((decb + z rows, l = 0 .. L-1) + x_prev_t.Wkd_x
    // (* skd))); in int8 each song's largest h_d over the block's units, in
    // f32 and bf16 the block's units of h_d as the frame head's operands
    for (int i = tid; i < Bp * L; i += kCThreads) {
      const int r = i / L, l = i - r * L;
      zsm[i] = r >= B ? 0.f
               : a.use_z_prior ? a.eps[((size_t)r * a.nsteps + t) * L + l]
                               : __ldcg(a.zs + i);
    }
    for (int n0 = 0; n0 < NT; n0 += kMaxNT) {
      const int nt = imin(kMaxNT, NT - n0);
      const auto* sums =
          a.use_x_prev ? products<E>(xlag, xw, kcx, wkd, gkd, NT, n0, nt, 0, mt, ring) : nullptr;
      __syncthreads();  // zsm is in
      for (int i = tid; i < Bp * 8 * nt; i += kCThreads) {
        const int r = i / (8 * nt), j = 8 * n0 + i - r * 8 * nt;
        float v = 0.f;
        if (r < B && j < nun) {
          v = a.decb[(size_t)r * H + u0 + j];
          for (int l = 0; l < L; ++l) v = __fadd_rn(v, __fmul_rn(zsm[r * L + l], wzd[l * nu + j]));
          if (sums)
            v = __fadd_rn(v, kI8 ? __fmul_rn(as_f32(sums[i]), sd[j]) : as_f32(sums[i]));
          v = fmaxf(v, 0.f);
        }
        hv[r * nu + j] = v;
      }
      __syncthreads();
    }
    if constexpr (kI8) {
      for (int r = warp; r < Bp; r += kCWarps) {
        float m = 0.f;  // h_d >= 0
        for (int j = lane; j < nun; j += 32) m = fmaxf(m, hv[r * nu + j]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0) a.hmax[(size_t)blockIdx.x * kCRows + r] = m;
      }
    } else {
      for (int i = tid; i < B * nun; i += kCThreads) {
        const int r = i / nun, j = i - r * nun;
        put(a.hq, hw, r, u0 + j, to_operand<E>(hv[r * nu + j]));
      }
    }
    if (timer) clk.lap(5);
    grid_sync(a.bar, rounds);
    if (timer) clk.lap(6);
    if constexpr (kI8) {
      // 4. rs = max(max h_d, 1e-12) / 127 per song, then the codes round(h_d
      // / rs) of the block's units
      row_max(Bp, G, [&](int g, int r) { return __ldcg(a.hmax + (size_t)g * kCRows + r); },
              [&](int r, float m) { rs[r] = __fdiv_rn(fmaxf(m, 1e-12f), 127.f); });
      __syncthreads();
      for (int i = tid; i < B * nun; i += kCThreads) {
        const int r = i / nun, j = i - r * nun;
        put(a.hq, hw, r, u0 + j,
            static_cast<signed char>(__float2int_rn(__fdiv_rn(hv[r * nu + j], rs[r]))));
      }
      if (timer) clk.lap(7);
      grid_sync(a.bar, rounds);
      if (timer) clk.lap(8);
    }
    // 5. frame head on h_d of every unit for the block's pitch tiles and song
    // group: p = sigmoid(h_d.Wx + bx) (int8: (codes.Wx * swx) * rs), the
    // Bernoulli draw, the output, and x_prev for the next step (into the
    // buffer the lagged frame leaves: it becomes x_prev_t then)
    if (heads) {
      for (int n0 = 0; n0 < P; n0 += kMaxNT) {
        const int nt = imin(kMaxNT, P - n0);
        const auto* sums = products<E>(a.hq, hw, kch, wxs, gx, P, n0, nt, m0, mtn, ring);
        if (timer) clk.lap(9);
        for (int i = tid; i < 16 * mtn * 8 * nt; i += kCThreads) {
          const int r = i / (8 * nt), c = i - r * 8 * nt, s = m0 + r;
          const int d = 8 * (pg * P + n0 + c / 8) + c % 8;
          if (s >= B || d >= D) continue;
          const float q = kI8 ? __fmul_rn(__fmul_rn(as_f32(sums[i]), a.swx[d]), rs[s])
                              : as_f32(sums[i]);
          const float xm = 1.f / (1.f + expf(-__fadd_rn(q, a.bx[d])));
          const size_t o = ((size_t)s * a.nsteps + t) * D + d;
          const float xt = a.u[o] < xm ? 1.f : 0.f;
          a.out[o] = a.return_probs ? xm : xt;
          put(xlag, xw, s, d, to_operand<E>(xt));
        }
        __syncthreads();
      }
    }
    if (timer) clk.lap(10);
    grid_sync(a.bar, rounds);
    if (timer) clk.lap(11);
  }
  if (timer) clk.flush();
}

template <typename E>
int launch_coop(const CoopArgs& a, cudaStream_t stream) {
  const size_t smem = coop_smem_bytes(a.D, a.H, a.L, a.nu, a.P, a.use_x_prev, a.res_cells,
                                      a.res_head, sizeof(E));
  cudaError_t err = cudaFuncSetAttribute(
      generate_vae_coop_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // cooperative: every block co-resident (the grid barrier needs it), or the
  // launch fails
  void* args[] = {const_cast<CoopArgs*>(&a)};
  err = cudaLaunchCooperativeKernel((const void*)generate_vae_coop_kernel<E>, dim3(cdiv(a.H, a.nu)),
                                    dim3(kCThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
}  // namespace

// Bytes of dynamic shared memory one block of the cluster kernel needs at the
// plan's geometry (`cluster_plan` checks its own count against it).
extern "C" long long cvl_generate_cl_vae_cluster_smem_bytes(int D, int H, int L, int has_hidden,
                                                            int use_x_prev, int eb, int C, int T,
                                                            int g0, int g1, int g2, int g3) {
  return (long long)cl_layout(cl_geom(D, H, L, has_hidden, use_x_prev, eb, C, T, g0, g1, g2, g3))
      .bytes;
}

// How many clusters of C blocks of T threads, `smem` bytes of dynamic shared
// memory a block, of the instance (eb, regs) the card holds at once (into
// `result`); returns the cudaError_t.
extern "C" int cvl_generate_cl_vae_cluster_max_active(int eb, int regs, int C, int T, int smem,
                                                      int* result) {
  if (eb == 4) return regs ? max_clusters<float, true>(C, T, smem, result)
                           : max_clusters<float, false>(C, T, smem, result);
  if (eb == 2) return regs ? max_clusters<__nv_bfloat16, true>(C, T, smem, result)
                           : max_clusters<__nv_bfloat16, false>(C, T, smem, result);
  return (int)cudaErrorInvalidValue;
}

// Launches the cluster sampler on `stream`: B clusters (one song each) of C blocks
// of T threads, operands of `eb` bytes (4 f32, 2 bf16), g0 .. g3 the lanes
// a column of the encoder, the z heads, the decoder and the frame head, on
// the register path where `regs` (cl_regs_ok); w0 .. w3 their slabs packed
// by the wrapper (`pack_cluster`; null where a layer is absent). ws [B, K]
// are the songs' key points, fw0 .. fw2 the w
// rows and fb0 .. fb2 the biases of the per-song folds (with hidden layers
// the encoder's rows D.. [K, H] and the decoder's rows 0.. [K, H], fw2 and
// fb2 null; without, z_mean's and z_log_var's rows D.. [K, L] and the frame
// head's rows 0.. [K, D]); with hidden layers zrows are the decoder z rows
// [L, H], bz [2L], bx [D]; without, the frame head z rows [L, D] (bz, bx
// null). `clock` (kClLaps counts, or null) receives
// block 0's ns per part of a step summed over the steps (ClClock). Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for a geometry no
// instance takes).
extern "C" int cvl_generate_cl_vae_cluster(
    const float* seed, const float* eps, const float* u, const void* w0, const void* w1,
    const void* w2, const void* w3, const float* ws, const float* fw0, const float* fw1,
    const float* fw2, const float* fb0, const float* fb1, const float* fb2, const float* zrows,
    const float* bz, const float* bx, float* out, int B, int nsteps, int D, int H, int L, int K,
    int has_hidden, int use_x_prev, int use_z_prior, int return_probs, int eb, int C, int T,
    int g0, int g1, int g2, int g3, int regs, unsigned long long* clock, void* stream) {
  const ClGeom gm = cl_geom(D, H, L, has_hidden, use_x_prev, eb, C, T, g0, g1, g2, g3);
  const ClLayout y = cl_layout(gm);
  bool ok = (eb == 2 || eb == 4) && (C == 1 || C == 2 || C == 4 || C == 8) && T >= 32 &&
            T <= kClMaxThreads && T % 32 == 0 && B >= 1 && nsteps >= 1 &&
            y.bytes <= (unsigned)(kSmemLimit - kClStatic) &&
            (!has_hidden || 2 * L <= kClZPer * g0) && (!regs || cl_regs_ok(gm, y));
  for (int i = 0; i < kClLayers; ++i)
    ok = ok && gm.g[i] >= 1 && gm.g[i] <= 32 && (gm.g[i] & (gm.g[i] - 1)) == 0 && T % gm.g[i] == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const ClArgs a{gm,   seed, eps, u, {w0, w1, w2, w3}, ws, {fw0, fw1, fw2}, {fb0, fb1, fb2},
                 zrows, bz, bx, out, clock, B, nsteps, K, use_z_prior, return_probs, y};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (eb == 4)
    return regs ? launch_cluster<float, true>(a, st) : launch_cluster<float, false>(a, st);
  return regs ? launch_cluster<__nv_bfloat16, true>(a, st)
              : launch_cluster<__nv_bfloat16, false>(a, st);
}

// Floats of per-song state one block of the wide kernel keeps (in shared
// memory, or in the global scratch the wrapper passes when it does not fit).
extern "C" long long cvl_generate_cl_vae_wide_state_floats(int D, int H, int L, int has_hidden) {
  return (long long)wide_state_floats(D, H, L, has_hidden);
}

// Bytes of dynamic shared memory one block of the wide kernel needs.
extern "C" long long cvl_generate_cl_vae_wide_smem_bytes(int D, int H, int L, int has_hidden,
                                                         int state_in_smem) {
  return (long long)wide_smem_bytes(D, H, L, has_hidden, state_in_smem);
}

// Launches the wide sampler on `stream`; returns the cudaError_t of the
// launch. `eb` is the bytes of the large weights (wke, wkd_x, wz_t, wx,
// wx_xp): 4 f32, 2 bf16. Pointers a structure does not use are null;
// `state` is null when the per-song state fits shared memory.
extern "C" int cvl_generate_cl_vae_wide(
    int eb, const float* seed, const float* eps, const float* u, const void* wke,
    const float* encb, const void* wkd_x, const float* wkd_z, const float* decb,
    const void* wz_t, const float* zb, const void* wx, const float* wx_z, const void* wx_xp,
    const float* xb, float* out, float* state, int zb_stride, int xb_stride, int B, int nsteps,
    int D, int H, int L, int has_hidden, int use_x_prev, int use_z_prior, int return_probs,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (eb == 2) {
    using T = __nv_bfloat16;
    const WideArgs<T> a{seed, eps, u, static_cast<const T*>(wke), encb,
                        static_cast<const T*>(wkd_x), wkd_z, decb, static_cast<const T*>(wz_t),
                        zb, static_cast<const T*>(wx), wx_z, static_cast<const T*>(wx_xp), xb,
                        out, state, zb_stride, xb_stride, B, nsteps, D, H, L, has_hidden,
                        use_x_prev, use_z_prior, return_probs};
    return launch_wide(a, st);
  }
  using T = float;
  const WideArgs<T> a{seed, eps, u, static_cast<const T*>(wke), encb,
                      static_cast<const T*>(wkd_x), wkd_z, decb, static_cast<const T*>(wz_t),
                      zb, static_cast<const T*>(wx), wx_z, static_cast<const T*>(wx_xp), xb,
                      out, state, zb_stride, xb_stride, B, nsteps, D, H, L, has_hidden,
                      use_x_prev, use_z_prior, return_probs};
  return launch_wide(a, st);
}

// Bytes of dynamic shared memory one block of the cooperative kernel needs:
// a block owning nu hidden units and P pitch tiles, its slices resident or
// not (the wrapper picks residency where it fits the limit), operands of
// `ebytes` bytes (1 int8, 2 bf16, 4 f32).
extern "C" long long cvl_generate_cl_vae_coop_smem_bytes(int D, int H, int L, int nu, int P,
                                                         int use_x_prev, int res_cells,
                                                         int res_head, int ebytes) {
  return (long long)coop_smem_bytes(D, H, L, nu, P, use_x_prev, res_cells, res_head, ebytes);
}

// 4-byte words of the state the cooperative kernel's blocks share in global
// memory (the caller zeroes them).
extern "C" long long cvl_generate_cl_vae_coop_state_words(int D, int H, int L, int nu,
                                                          int ebytes) {
  return (long long)coop_state(D, H, L, cdiv(H, nu), ebytes).total;
}

// Launches the cooperative sampler on `stream` for B <= 64 songs, its
// operands `ebytes` bytes (1: int8 codes, 2: bf16, 4: f32): one cooperative
// launch of cdiv(H, nu) blocks, each owning nu hidden units and P pitch
// tiles of one of hs song groups; wke, wkd and wx packed by the wrapper
// (`pack_coop`); wkd and skd null without use_x_prev, the three scales null
// outside int8; wz_t bf16 in int8 and bf16, f32 in f32; `state` holds
// cvl_generate_cl_vae_coop_state_words zeroed words; `clock` (kLaps counts,
// or null) receives block 0's ns per part of a step summed over the steps
// (CoopClock). Returns the cudaError_t of the launch
// (cudaErrorCooperativeLaunchTooLarge where the grid cannot be co-resident).
extern "C" int cvl_generate_cl_vae_coop(
    int ebytes, const float* seed, const float* eps, const float* u, const int* wke,
    const int* wkd, const int* wx, const float* ske, const float* skd, const float* encb,
    const float* decb, const void* wz_t, const float* bz, const float* wkd_z, const float* swx,
    const float* bx, float* out, int* state, unsigned long long* clock, int B, int nsteps, int D,
    int H, int L, int use_x_prev, int use_z_prior, int return_probs, int nu, int P, int hs,
    int res_cells, int res_head, void* stream) {
  const CoopState st = coop_state(D, H, L, cdiv(H, nu), ebytes);
  const CoopArgs a{seed, eps, u, wke, wkd, wx, ske, skd, encb, decb, wz_t, bz, wkd_z, swx, bx, out,
                   state + st.xq, state + st.hq, reinterpret_cast<double*>(state + st.zpart),
                   reinterpret_cast<float*>(state + st.zs),
                   reinterpret_cast<float*>(state + st.hmax),
                   reinterpret_cast<unsigned*>(state + st.bar), clock, B, nsteps, D, H, L,
                   use_x_prev, use_z_prior, return_probs, nu, P, hs, res_cells, res_head};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ebytes) {
    case 1: return launch_coop<signed char>(a, s);
    case 2: return launch_coop<__nv_bfloat16>(a, s);
    case 4: return launch_coop<float>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
