// Fused NeRF training objective and render VJP for Hopper (sm_90a): the
// analytic backward to every packed weight, in one call each, the trunk's
// products on the tensor cores as 3xTF32.
//
// Replaces: nerf_fewshot_tpu/render/train_kernel.py:_train_pe_kernel (:343,
// inline PE, INLINE_PE = true) and :_train_kernel (:320, pre-encoded x,
// INLINE_PE = false), both running the body _objective_body (:65), entry
// nerf_train_objective; and nerf_fewshot_tpu/render/kernels.py:_bwd_kernel
// (:292, the custom VJP of fused_render), entry nerf_render_bwd.
//   x      = [raw | sin(c + raw.e2) | feats | 0]  or the given (N, D) x
//   h_1    = relu(x.w0 + b0), h_{i+1} = relu(h_i.wh[i-1] + bh[i-1]), i < L
//   out    = h_L.wout[:, :4] + bout[:4];  rgb_s = sigmoid(out[0:3]), sigma = out[3]
//   om     = exp(-relu(sigma)*dists) + 1e-10, T = exp(cumsum(log om) - log om)
//   w      = (1 - exp(-relu(sigma)*dists)) * T      (dists: [dz, 1e10] * |d|)
//   rgb    = sum w*rgb_s (+ 1 - acc if white_bkgd)
// The objective:
//   loss   = rgb_c*inv_denom * sum_r mask*|rgb - tgt|^2
//            [+ (3*reg/S)*inv_denom * sum_r mask*sum_s w^2]
//            [+ 3*depth*inv_denom * sum_r mask*|sum_s w*z - tgt_depth|]
//   g_rgb  = 2*rgb_c*err*inv_denom, g_acc = -sum g_rgb (white_bkgd),
//   dL/dw  = rgb_s.g_rgb + g_acc [+ 2*reg_scale*mask*w] [+ d_scale*sign*mask*z]
// The render VJP takes the cotangents (g_rgb, g_depth, g_acc, g_weights) of
// (rgb, depth, acc, weights) instead, with g_acc -= sum g_rgb (white_bkgd):
//   dL/dw  = rgb_s.g_rgb + g_acc + g_depth*z + g_weights
// Both then run:
//   s_after= sum_{t>s} dL/dw_t * w_t          (strict suffix sum, fp32 scan)
//   d_alpha= dL/dw*T - s_after/om, d_sigma = d_alpha*(1-alpha)*dists*[sigma>0]
//   head cotangent g_out = [w*g_rgb*rgb_s*(1-rgb_s), d_sigma], then the
//   ReLU-gated chain delta_i = (delta_{i+1}.W^T) * [h_i > 0], and
//   dW = A^T.delta, db = sum delta over all R*S points; the render VJP also
//   gives dx = delta_1.w0^T.
//
// Numerics. The trunk's products (the forward layers, the backward chain,
// the dW products and dx) run as 3xTF32 on the tensor cores (mma.sync
// m16n8k8 .tf32, fp32 accumulation): each fp32 operand is cut into two TF32
// halves, hi = rna(v) and lo = rna(v - hi), which keep ~22 of its 24 bits,
// and a product is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (a_lo.b_lo, ~2^-22 of
// it, is dropped). The weights are split once per call with
// cvt.rna.tf32.f32; activations and cotangents as their fragments are read,
// by the same rounding in integer operations. The tensor cores round their
// fp32 accumulation toward zero, so a long mma chain drifts one way: the
// products of every two k-steps (16 terms, a chain of 6 mma) accumulate in
// their own registers and are added to the running sum with
// round-to-nearest FADDs. The gradients are then as close to a float64 run
// as the fp32 plain version's (median rel ~3e-6 on 37-ray cases), and far
// finer than the TPU kernels' one bf16 pass per product. Near a ReLU gate
// no fp32-accurate route is exact: on a few hundred rays one gate that two
// routes round to different sides moves the gradient vector by ~1e-3, and
// which inputs show it depends on the order of the sums (PERF.md).
// Exact fp32 on the CUDA
// cores, as before: the PE phases (unfused multiply-adds, accurate sinf),
// the log-space transmittance prefix scan, the suffix sum s_after, the
// 4-column head and the seed of the backward chain, and the bias sums.
//
// That is the float32 route (ROUTE kTf32x3). Two more routes compute the
// JAX kernels' other compute_dtypes (nerf_fewshot_tpu/render/kernels.py:63
// _dot), with the same tiles, stages and launches; only the products differ:
//   kBf16 (compute_dtype bfloat16): both operands of every product are
//   rounded to bf16 (cvt.rn.bf16x2.f32: to nearest even) and multiplied by
//   mma.sync m16n8k8 .bf16 with fp32 accumulation, one pass; the weights'
//   images are rounded once per call, activations and cotangents as their
//   fragments are read. The products of every two k-steps are promoted with
//   round-to-nearest FADDs, as above. The head rounds its operands too
//   (the JAX head is a _dot), unless the caller pins it to exact fp32
//   (head_mode "vpu");
//   kFp32 (compute_dtype highest): every product as fp32 FFMAs on the CUDA
//   cores, from the same shared-memory stages (plain fp32 weight images),
//   each thread owning the outputs an mma fragment would hold: the plain
//   fp32 function up to the order of the sums. Its sums are ordered for
//   accuracy, since it is the verification route: the dW products' point
//   axis in two levels (32-point stages, then the stages), db as
//   compensated sums, and the transmittance from the exclusive prefix
//   (composite_forward).
// The six dW products take their own route (dw_route: the JAX dw_precision
// pin "highest" runs them as kFp32 under any route).
//
// Bound (float32 route): at the baseline widths (x_dim 90, 8x256 trunk) the forward is
// 2*(90*256 + 7*256^2 + 4*256) = 0.97 MFLOP per point, the backward chain
// 2*(4*256 + 7*256^2) = 0.92 MFLOP and the dW products 0.97 MFLOP: 2.85 MFLOP
// per point, 93 GFLOP for a 512-ray x 64-sample step (the render VJP adds dx,
// 2*256*90 = 0.05 MFLOP per point), against ~5 MB of inputs and outputs
// (~35 MB with a 128-wide x and dx): bound by operations. As 3xTF32 each
// product is three TF32 products: 3*93 GFLOP at the 495 TFLOP/s TF32 peak of
// an H100 SXM is 0.57 ms. That peak needs wgmma; mma.sync reaches about two
// thirds of it (chip_smoke.py's tensor-core probe measures the rate).
// The bfloat16 route does one bf16 product per product: 93 GFLOP at 989
// TFLOP/s, 0.094 ms; the highest route does them at the 67 TFLOP/s fp32
// CUDA-core rate, 1.39 ms.
//
// Design: the TPU kernels stash every layer's activations of a ray tile in
// VMEM, ~640 KB per 64-sample ray at 256 wide, far beyond an SM's 227 KB. So
// a call is split into grid launches on one stream, with the activations and
// cotangents in a global scratch buffer that the caller allocates once and
// grows:
//   1. weight_split: the TF32 halves of w0, wh and wh^T (the backward
//      chain's weights), or their bf16 or fp32 images in the hi half;
//   2. train_fwd: one 256-thread CTA per 64-point tile (points of any ray):
//      builds x (inline PE) into the scratch as A_0 (feature-major, [D][Np]),
//      then runs each layer with dense_tc: 2x4 warps of 32 points x H/4
//      columns, the weight halves streamed through two cp.async stages of
//      32 rows with one barrier per stage. Layer 0 streams its input too, 32
//      rows of x per stage beside the weights, so no D-wide tile is held in
//      shared memory (an input up to kMaxD = 896 wide fits beside the H-row
//      tile); layers >= 1 run in place on the H-row tile (feature-major in
//      shared memory). Writes each layer's activations A_i ([H][Np]) and the
//      4 head outputs;
//   3. train_composite (objective) or render_composite (VJP): one warp per
//      ray: sigmoid, log-space compositing with an fp32 shuffle prefix scan,
//      the ray's loss partial (objective), then the suffix sum s_after as an
//      fp32 shuffle scan run from the last sample (never a difference of
//      prefix sums, which cancels when om ~ 1e-10), and the head cotangent;
//   4. train_bwd: per 64-point tile, delta_L from g_out and wout, then the
//      L-1 gated products with wh^T through dense_tc, each delta written to
//      scratch;
//   5. train_dw: every dW_l = A_l^T.delta_l and db_l = sum delta_l as one
//      launch of 128x128 output tiles, each CTA reducing its part of the
//      point axis through a ring of three cp.async stages of 32 points (act
//      and gbuf are feature-major, so both operands are contiguous along the
//      reduction, as mma.sync's .row.col layout wants); the point axis is
//      split in P fixed parts, each written to its own partial;
//   6. train_finalize: the P partials of each gradient are summed in a fixed
//      order;
//   7. objective: loss_sum, the per-ray losses summed in a fixed order by
//      one CTA; render VJP (when dx is asked for): render_dx, dx = delta_1.w0^T
//      as 64x64 output tiles on the tensor cores.
// Fragments (mma.sync m16n8k8 .row.col tf32, g = lane/4, t = lane%4): A
// (16x8) a0 (g,t) a1 (g+8,t) a2 (g,t+4) a3 (g+8,t+4); B (8x8) b0 (k=t,n=g)
// b1 (k=t+4,n=g); C (16x8) c0 (g,2t) c1 (g,2t+1) c2 (g+8,2t) c3 (g+8,2t+1).
// The .bf16 shape packs two values a register, the lower k in the low half:
// A a01 (g, 2t..2t+1) a23 (g+8, 2t..2t+1); B b01 (k=2t..2t+1, n=g); C as tf32.
// They are read from shared memory with 32-bit loads; every row stride is
// padded so that a warp's 8x4 lane pattern hits 32 distinct banks.
// No atomic operations on the device: two runs of a call agree bit for bit.
// The launchers return cudaGetLastError() (or the first failing call), and
// the Python wrappers raise when it is not cudaSuccess.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kTileP = 64;       // points per trunk tile
constexpr int kLd = kTileP + 4;  // activation row stride in shared memory (4 mod 32)
constexpr int kKT = 32;          // weight rows per cp.async stage of a layer
constexpr int kOutPad = 128;     // packed head columns [r, g, b, sigma, 0...]
constexpr int kHead = 4;         // live head columns
constexpr float kFar = 1e10f;
constexpr float kEps = 1e-10f;
// Precision routes (render/kernels.py ROUTES)
constexpr int kTf32x3 = 0;  // compute_dtype float32
constexpr int kBf16 = 1;    // compute_dtype bfloat16
constexpr int kFp32 = 2;    // compute_dtype highest
constexpr int kDwT = 128;             // dW output tile edge (rows k and columns j)
constexpr int kBN = 32;               // points per dW cp.async stage
constexpr int kDwLd = kBN + 4;        // dW operand row stride (4 mod 32)
constexpr int kDwStage = 2 * kDwT * kDwLd;  // floats of one dW stage (A and G)
constexpr int kDwStages = 3;          // dW cp.async ring depth
constexpr int kDxP = 64;              // dx tile: points
constexpr int kDxK = 64;              // dx tile: input columns
constexpr int kDxJ = 32;              // dx reduction stage (trunk columns)
constexpr int kDxLdD = kDxP + 8;      // delta_1 stage row stride (8 mod 32)
constexpr int kDxLdW = kDxJ + 4;      // w0 stage row stride (4 mod 32)
constexpr int kDxStage = kDxJ * kDxLdD + 2 * kDxK * kDxLdW;
constexpr int kMaxD = 896;       // widest padded input (7 x 128: the script recipes' 858)
constexpr int kMaxS = 1024;      // samples per ray: the composite's 9*S floats stay < 48 KB
constexpr int kDwSmem = static_cast<int>(sizeof(float)) * kDwStages * kDwStage;
constexpr int kDxSmem = static_cast<int>(sizeof(float)) * 2 * kDxStage;
constexpr int kMaxParts = 8;     // split of the point axis in the dW products
constexpr int kPartRows = 4096;  // points per part before a further split
constexpr int kMaxJobs = 16;     // dW products in one launch (layers + head)
static_assert(kKT % 16 == 0 && kBN % 16 == 0 && kDxJ % 16 == 0,
              "each stage is an even number of k-steps: the products are promoted every two");

size_t round_up(size_t a, size_t b) { return (a + b - 1) / b * b; }

// Sizes shared by the launcher and nerf_train_scratch_floats.
struct Layout {
  int N, Np, L, P, chunk;
  size_t F;  // floats of the six packed gradients, flattened
  size_t act, gbuf, gout, out4, loss_r, wsplit, part, total;  // scratch offsets
};

Layout make_layout(int R, int S, int D, int H, int L1) {
  Layout s;
  s.N = R * S;
  s.Np = static_cast<int>(round_up(s.N, kTileP));
  s.L = L1 + 1;
  int P = s.N / kPartRows;
  s.P = P < 1 ? 1 : (P > kMaxParts ? kMaxParts : P);
  s.chunk = static_cast<int>(round_up((s.N + s.P - 1) / s.P, kBN));
  s.F = static_cast<size_t>(D) * H + H + static_cast<size_t>(L1) * H * H +
        static_cast<size_t>(L1) * H + static_cast<size_t>(H) * kOutPad + kOutPad;
  const size_t np = s.Np;
  size_t off = 0;
  s.act = off;    off += round_up((static_cast<size_t>(D) + static_cast<size_t>(s.L) * H) * np, 64);
  s.gbuf = off;   off += round_up(static_cast<size_t>(s.L) * H * np, 64);
  s.gout = off;   off += round_up(kHead * np, 64);
  s.out4 = off;   off += round_up(kHead * np, 64);
  s.loss_r = off; off += round_up(R, 64);
  // TF32 halves: w0 hi, lo (D*H each), then wh hi, lo and wh^T hi, lo (L1*H*H each)
  s.wsplit = off; off += round_up(2 * (static_cast<size_t>(D) * H + 2 * static_cast<size_t>(L1) * H * H), 64);
  s.part = off;   off += static_cast<size_t>(s.P) * round_up(s.F, 64);
  s.total = off;
  return s;
}

// ---- tensor-core primitives ----

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v ~ hi + lo to ~2^-22 relative (v - hi is exact in fp32), by
// cvt.rna.tf32.f32: the weights' split, once per call.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// The same split of a finite v in two integer operations per half: adding
// half of the 13 dropped bits to the magnitude and clearing them rounds to
// nearest, ties away from zero, as cvt.rna.tf32.f32 does (whose SASS adds an
// Inf/NaN test). Used for the operands split on the fly.
__device__ __forceinline__ uint32_t rna_bits(uint32_t b) { return (b + 0x1000u) & 0xffffe000u; }
__device__ __forceinline__ void split_fast(float v, uint32_t& hi, uint32_t& lo) {
  hi = rna_bits(__float_as_uint(v));
  lo = rna_bits(__float_as_uint(v - __uint_as_float(hi)));
}

// {lo, hi} rounded to bf16 (to nearest even), packed lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// v rounded to bf16, as an fp32 value.
__device__ __forceinline__ float round_bf16(float v) {
  return __uint_as_float(pack_bf16(0.f, v) & 0xffff0000u);
}

// The head's operand: rounded to bf16 on the bfloat16 route, else as is.
__device__ __forceinline__ float head_in(float v, bool bf16) { return bf16 ? round_bf16(v) : v; }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// part += a.b for one k-step of 8 over an MT x NT block, one bf16 pass;
// bfrag(j) gives the packed B fragment of n-tile j.
template <int MT, int NT, class BFrag>
__device__ __forceinline__ void mma1_step(float (&part)[MT][NT][4], const uint32_t (&a)[MT][2],
                                          BFrag bfrag) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const uint32_t b = bfrag(j);
#pragma unroll
    for (int i = 0; i < MT; ++i) mma_bf16(part[i][j], a[i], b);
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// part += a.b for one k-step of 8 over an MT x NT block of m16n8 tiles, as
// 3xTF32. The block is taken JG n-tiles at a time, in
// three passes each, the small terms first (a_lo.b_hi, a_hi.b_lo,
// a_hi.b_hi), so that no mma waits on one issued just before it.
// bfrag(j, hi, lo) loads the B fragment of n-tile j.
template <int JG, int MT, int NT, class BFrag>
__device__ __forceinline__ void mma3_step(float (&part)[MT][NT][4], const uint32_t (&ahi)[MT][4],
                                          const uint32_t (&alo)[MT][4], BFrag bfrag) {
  static_assert(NT % JG == 0, "n-tiles in groups");
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += JG) {
    uint32_t bhi[JG][2], blo[JG][2];
#pragma unroll
    for (int j = 0; j < JG; ++j) bfrag(j0 + j, bhi[j], blo[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < JG; ++j) mma_tf32(part[i][j0 + j], alo[i], bhi[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < JG; ++j) mma_tf32(part[i][j0 + j], ahi[i], blo[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < JG; ++j) mma_tf32(part[i][j0 + j], ahi[i], bhi[j]);
  }
}

// The tensor cores accumulate in fp32 but round toward zero, so a long
// chain of mma into one accumulator drifts by up to an ulp of the running
// sum per mma, always the same way. The products of every two k-steps
// therefore accumulate in their own block (a chain of 3 x 2 mma), which is
// added to the running sum with round-to-nearest FADDs, and zeroed.
template <int MT, int NT>
__device__ __forceinline__ void promote(float (&acc)[MT][NT][4], float (&part)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
        part[i][j][e] = 0.f;
      }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_block(float (&d)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
}

// The A fragment of a 16x8 tile whose element (m, k) is at p[m*ld + k]
// (row-major) in fp32, split into its TF32 halves.
__device__ __forceinline__ void load_a_mmajor_split(const float* p, int ld, int g, int t,
                                                    uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* q = p + g * ld + t;
  split_fast(q[0], hi[0], lo[0]);
  split_fast(q[8 * ld], hi[1], lo[1]);
  split_fast(q[4], hi[2], lo[2]);
  split_fast(q[8 * ld + 4], hi[3], lo[3]);
}

// The A fragment of a 16x8 tile whose element (m, k) is at p[k*ld + m]
// (feature-major) in fp32, split into its TF32 halves.
__device__ __forceinline__ void load_a_kmajor_split(const float* p, int ld, int g, int t,
                                                    uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* q = p + t * ld + g;
  split_fast(q[0], hi[0], lo[0]);
  split_fast(q[8], hi[1], lo[1]);
  split_fast(q[4 * ld], hi[2], lo[2]);
  split_fast(q[4 * ld + 8], hi[3], lo[3]);
}

// The bf16 A fragment of a 16x8 tile at p[m*ld + k] (row-major), rounded.
__device__ __forceinline__ void load_a_mmajor_bf16(const float* p, int ld, int g, int t,
                                                   uint32_t (&a)[2]) {
  const float* q = p + g * ld + 2 * t;
  a[0] = pack_bf16(q[0], q[1]);
  a[1] = pack_bf16(q[8 * ld], q[8 * ld + 1]);
}

// The bf16 A fragment of a 16x8 tile at p[k*ld + m] (feature-major), rounded.
__device__ __forceinline__ void load_a_kmajor_bf16(const float* p, int ld, int g, int t,
                                                   uint32_t (&a)[2]) {
  const float* q = p + 2 * t * ld + g;
  a[0] = pack_bf16(q[0], q[ld]);
  a[1] = pack_bf16(q[8], q[ld + 8]);
}

// 16 bytes global -> shared, bypassing L1; bytes < 16 zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Warp layout of a layer's kTileP x H output tile: 2 x 4 warps of 32
// points (MT m16 tiles) by H/4 columns (NT n8 tiles); and its weight stages.
template <int H>
struct Dense {
  static constexpr int MT = kTileP / 2 / 16;
  static constexpr int NT = H / 4 / 8;
  static constexpr int kLdw = H + 8;          // weight stage row stride (8 mod 32)
  static constexpr int kHalf = kKT * kLdw;    // floats of one half of a stage
  static constexpr int kSmem = 2 * 2 * kHalf; // two stages of hi and lo
  static constexpr int kXSmem = 2 * kKT * kLd;  // two stages of layer 0's input rows
  // dynamic shared memory of train_fwd (any D: layer 0 streams x) and train_bwd
  static constexpr int kFwdSmem = static_cast<int>(sizeof(float)) * (H * kLd + kSmem + kXSmem);
  static constexpr int kBwdSmem = static_cast<int>(sizeof(float)) * (H * kLd + kSmem);
  static constexpr int kChunks = 2 * kKT * H / 4;  // 16-byte copies per stage
  static_assert(kChunks % kThreads == 0, "stage copies per thread");
  static_assert(kFwdSmem <= 232448, "train_fwd's tile and stages fit a block's shared memory");
};

// Rows k0 .. k0+kKT-1 of W (K, H) into a stage: both TF32 halves (kHalves
// 2) or the hi half only (the bf16 and fp32 images); rows past K are
// zero-filled.
template <int H, int kHalves>
__device__ __forceinline__ void load_w_stage(float* st, const float* __restrict__ whi,
                                             const float* __restrict__ wlo, int k0, int K) {
  using S = Dense<H>;
#pragma unroll
  for (int v = 0; v < kHalves * S::kChunks / 2 / kThreads; ++v) {
    const int c = threadIdx.x + v * kThreads;
    const int half = c / (S::kChunks / 2);
    const int r = (c % (S::kChunks / 2)) / (H / 4);
    const int q = c % (H / 4);
    const bool in = k0 + r < K;
    cp_async16(st + half * S::kHalf + r * S::kLdw + q * 4,
               in ? (half ? wlo : whi) + static_cast<size_t>(k0 + r) * H + q * 4 : whi,
               in ? 16 : 0);
  }
}

// Rows k0 .. k0+kKT-1 of a feature-major input x ([K][Np] in global memory)
// at the tile's kTileP points from n0 into an input stage; rows past K are
// zero-filled.
__device__ __forceinline__ void load_x_stage(float* st, const float* __restrict__ x, int k0,
                                             int K, int Np, int n0) {
  constexpr int kRowChunks = kTileP / 4;
  static_assert(kKT * kRowChunks % kThreads == 0, "input stage copies per thread");
#pragma unroll
  for (int v = 0; v < kKT * kRowChunks / kThreads; ++v) {
    const int c = threadIdx.x + v * kThreads;
    const int r = c / kRowChunks, q = c % kRowChunks;
    const bool in = k0 + r < K;
    cp_async16(st + r * kLd + q * 4, in ? x + static_cast<size_t>(k0 + r) * Np + n0 + q * 4 : x,
               in ? 16 : 0);
  }
}

// One dense layer of a kTileP-point tile on the tensor cores, 3xTF32
// (ROUTE kTf32x3), one bf16 pass (kBf16) or as fp32 FFMAs on the CUDA
// cores (kFp32): t[col][p] <- f(sum_k in[k][p] * W[k][col]), W given by its
// TF32 halves, or its bf16 or fp32 image as whi, (K, H) row-major in global
// memory, streamed through two cp.async stages
// of kKT rows: stage s+1 is requested right after the barrier that ends
// every warp's use of its buffer, and lands while stage s is consumed. The
// input is the tile itself (x_g null: in place, read only before the barrier
// after the loop, so the output overwrites it) or, for layer 0, x_g: its
// kKT rows of each stage are streamed beside the weights into x_st, so that
// the sums are those of the in-place layer, in the same order. The input is
// split into TF32 halves (rounded to bf16) as its fragments are read. The
// FFMA route's threads own the outputs of the mma fragments. The epilogue is
//   forward (!BWD): out = relu(acc + bias);
//   backward (BWD): out = acc where gate[col][n] > 0, else 0;
// it writes t[col][p] in shared memory and dst[col*Np + n0 + p] in global.
template <int H, bool BWD, int ROUTE>
__device__ void dense_tc(float* __restrict__ t_sm, const float* __restrict__ whi,
                         const float* __restrict__ wlo, const float* __restrict__ bias, int K,
                         float* __restrict__ wst, float* __restrict__ dst,
                         const float* __restrict__ gate, int Np, int n0,
                         const float* __restrict__ x_g = nullptr,
                         float* __restrict__ x_st = nullptr) {
  using S = Dense<H>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pm = (warp >> 2) * S::MT * 16;  // the warp's first point
  const int cn = (warp & 3) * S::NT * 8;    // the warp's first column

  float acc[S::MT][S::NT][4], part[S::MT][S::NT][4];
  zero_block(acc);
  zero_block(part);

  constexpr int kHalves = ROUTE == kTf32x3 ? 2 : 1;
  const int n_stages = (K + kKT - 1) / kKT;
  load_w_stage<H, kHalves>(wst, whi, wlo, 0, K);
  if (x_g != nullptr) load_x_stage(x_st, x_g, 0, K, Np, n0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // stage s has landed; stage s-1 and the input writes are done
    if (s + 1 < n_stages) {
      load_w_stage<H, kHalves>(wst + ((s + 1) & 1) * 2 * S::kHalf, whi, wlo, (s + 1) * kKT, K);
      if (x_g != nullptr)
        load_x_stage(x_st + ((s + 1) & 1) * kKT * kLd, x_g, (s + 1) * kKT, K, Np, n0);
      cp_async_commit();
    }
    // the stage's kKT input rows: streamed (layer 0) or rows s*kKT.. of the tile
    const float* a_st = x_g != nullptr ? x_st + (s & 1) * kKT * kLd : t_sm + s * kKT * kLd;
    if constexpr (ROUTE == kFp32) {
      const float* wrow = wst + (s & 1) * 2 * S::kHalf + cn + 2 * t;
#pragma unroll 4
      for (int k = 0; k < kKT; ++k) {
        if (k == 16 && s * kKT + k >= K) break;  // K is a multiple of 16, not always of kKT
        float a[S::MT][2];
#pragma unroll
        for (int i = 0; i < S::MT; ++i) {
          a[i][0] = a_st[k * kLd + pm + i * 16 + g];
          a[i][1] = a_st[k * kLd + pm + i * 16 + g + 8];
        }
#pragma unroll
        for (int j = 0; j < S::NT; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(wrow + k * S::kLdw + j * 8);
#pragma unroll
          for (int i = 0; i < S::MT; ++i) {
            acc[i][j][0] = fmaf(a[i][0], b.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(a[i][0], b.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(a[i][1], b.x, acc[i][j][2]);
            acc[i][j][3] = fmaf(a[i][1], b.y, acc[i][j][3]);
          }
        }
      }
      continue;  // the FFMA route has no tensor-core pass
    }
    const float* ws = wst + (s & 1) * 2 * S::kHalf + cn + g;
#pragma unroll
    for (int kk = 0; kk < kKT; kk += 8) {
      if (kk > 0 && s * kKT + kk >= K) break;  // K is a multiple of 16, not always of kKT
      if constexpr (ROUTE == kBf16) {
        uint32_t a[S::MT][2];
#pragma unroll
        for (int i = 0; i < S::MT; ++i)
          load_a_kmajor_bf16(a_st + kk * kLd + pm + i * 16, kLd, g, t, a[i]);
        const float* wk = ws + (kk + 2 * t) * S::kLdw;
        mma1_step(part, a, [&](int j) { return pack_bf16(wk[j * 8], wk[j * 8 + S::kLdw]); });
      } else {
        uint32_t ahi[S::MT][4], alo[S::MT][4];
#pragma unroll
        for (int i = 0; i < S::MT; ++i)
          load_a_kmajor_split(a_st + kk * kLd + pm + i * 16, kLd, g, t, ahi[i], alo[i]);
        const float* wk = ws + (kk + t) * S::kLdw;
        auto bfrag = [&](int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
          const float* b = wk + j * 8;
          bh[0] = __float_as_uint(b[0]);
          bh[1] = __float_as_uint(b[4 * S::kLdw]);
          bl[0] = __float_as_uint(b[S::kHalf]);
          bl[1] = __float_as_uint(b[S::kHalf + 4 * S::kLdw]);
        };
        mma3_step<4>(part, ahi, alo, bfrag);
      }
      if (kk & 8) promote(acc, part);
    }
  }
  __syncthreads();  // every warp is done reading the input

#pragma unroll
  for (int j = 0; j < S::NT; ++j) {
    const int col = cn + j * 8 + 2 * t;
    const float b0 = BWD ? 0.f : __ldg(bias + col);
    const float b1 = BWD ? 0.f : __ldg(bias + col + 1);
#pragma unroll
    for (int i = 0; i < S::MT; ++i) {
      const int p = pm + i * 16 + g;
      float v[4] = {acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]};
      if (!BWD) {
        v[0] = fmaxf(v[0] + b0, 0.f);
        v[1] = fmaxf(v[1] + b1, 0.f);
        v[2] = fmaxf(v[2] + b0, 0.f);
        v[3] = fmaxf(v[3] + b1, 0.f);
      }
      t_sm[col * kLd + p] = v[0];
      t_sm[(col + 1) * kLd + p] = v[1];
      t_sm[col * kLd + p + 8] = v[2];
      t_sm[(col + 1) * kLd + p + 8] = v[3];
    }
  }
  __syncthreads();
  // the tile to global memory in 16-byte rows (and the backward's ReLU gate)
  for (int e = threadIdx.x; e < H * (kTileP / 4); e += kThreads) {
    const int col = e / (kTileP / 4);
    const int p = (e % (kTileP / 4)) * 4;
    float4* o = reinterpret_cast<float4*>(t_sm + col * kLd + p);
    float4 v = *o;
    if (BWD) {
      const float4 gt =
          *reinterpret_cast<const float4*>(gate + static_cast<size_t>(col) * Np + n0 + p);
      v.x = gt.x > 0.f ? v.x : 0.f;
      v.y = gt.y > 0.f ? v.y : 0.f;
      v.z = gt.z > 0.f ? v.z : 0.f;
      v.w = gt.w > 0.f ? v.w : 0.f;
      *o = v;
    }
    *reinterpret_cast<float4*>(dst + static_cast<size_t>(col) * Np + n0 + p) = v;
  }
}

// The weight images the products read, once per call: w0 (z = 0) and
// wh[z-1] as given, and wh[z-1]^T for the backward chain (32x32 tiles
// through shared memory). The float32 route's TF32 halves; the bfloat16
// route's bf16 roundings and the highest route's fp32 values in the hi half.
template <int ROUTE>
__device__ __forceinline__ void weight_image(float v, float* hi, float* lo, size_t i) {
  if constexpr (ROUTE == kTf32x3) {
    uint32_t h, l;
    split_tf32(v, h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  } else {
    hi[i] = ROUTE == kBf16 ? round_bf16(v) : v;
  }
}

template <int ROUTE>
__global__ void weight_split_kernel(const float* __restrict__ w0, const float* __restrict__ wh,
                                    float* __restrict__ w0hi, float* __restrict__ w0lo,
                                    float* __restrict__ whhi, float* __restrict__ whlo,
                                    float* __restrict__ whThi, float* __restrict__ whTlo, int D,
                                    int H) {
  __shared__ float tile[32][33];
  const int bx = blockIdx.x * 32, by = blockIdx.y * 32;
  const int tx = threadIdx.x;
  if (blockIdx.z == 0) {
    for (int r = threadIdx.y; r < 32; r += blockDim.y) {
      if (by + r >= D) break;
      const size_t i = static_cast<size_t>(by + r) * H + bx + tx;
      weight_image<ROUTE>(w0[i], w0hi, w0lo, i);
    }
    return;
  }
  if (by >= H) return;  // uniform over the block
  const size_t base = static_cast<size_t>(blockIdx.z - 1) * H * H;
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const size_t i = base + static_cast<size_t>(by + r) * H + bx + tx;
    const float v = wh[i];
    weight_image<ROUTE>(v, whhi, whlo, i);
    tile[r][tx] = v;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const size_t i = base + static_cast<size_t>(bx + r) * H + by + tx;
    weight_image<ROUTE>(tile[tx][r], whThi, whTlo, i);
  }
}

// Pointers into the TF32 halves of the scratch.
struct WSplit {
  float *w0hi, *w0lo, *whhi, *whlo, *whThi, *whTlo;
};

WSplit wsplit_at(float* base, int D, int H, int L1) {
  const size_t dh = static_cast<size_t>(D) * H, hh = static_cast<size_t>(L1) * H * H;
  WSplit w;
  w.w0hi = base;
  w.w0lo = w.w0hi + dh;
  w.whhi = w.w0lo + dh;
  w.whlo = w.whhi + hh;
  w.whThi = w.whlo + hh;
  w.whTlo = w.whThi + hh;
  return w;
}

// Forward trunk of one 64-point tile; A_0 = x and every A_i go to act
// ([D + L*H][Np]), the 4 raw head outputs to out4 ([4][Np]). Layer 0 reads
// x back from act, one 32-row stage at a time. head_bf16: the head's
// operands rounded to bf16.
template <int H, bool INLINE_PE, int ROUTE>
__global__ void __launch_bounds__(kThreads, 1)
train_fwd_kernel(const float* __restrict__ in, const float* __restrict__ feats,
                 const float* __restrict__ e2, const float* __restrict__ c, const WSplit ws,
                 const float* __restrict__ b0, const float* __restrict__ bh,
                 const float* __restrict__ wout, const float* __restrict__ bout,
                 float* __restrict__ act, float* __restrict__ out4, int N, int Np, int n_raw,
                 int n_phase, int Fd, int D, int L1, bool head_bf16) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* tile = smem;  // [H][kLd], each layer's output (layers >= 1 in place)
  float* wst = tile + H * kLd;
  float* xst = wst + Dense<H>::kSmem;  // layer 0's input stages
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kTileP;

  for (int idx = tid; idx < D * kTileP; idx += kThreads) {
    const int k = idx / kTileP;
    const int p = idx % kTileP;
    const int n = n0 + p;
    float v = 0.f;
    if (n < N) {
      if (INLINE_PE) {
        const float* r = in + static_cast<size_t>(n) * n_raw;
        if (k < n_raw) {
          v = r[k];
        } else if (k < n_raw + n_phase) {
          const int col = k - n_raw;
          float a = c[col];
          for (int d = 0; d < n_raw; ++d) a = __fadd_rn(a, __fmul_rn(r[d], e2[d * n_phase + col]));
          v = sinf(a);
        } else if (k < n_raw + n_phase + Fd) {
          v = feats[static_cast<size_t>(n) * Fd + (k - n_raw - n_phase)];
        }
      } else {
        v = in[static_cast<size_t>(n) * D + k];
      }
    }
    act[static_cast<size_t>(k) * Np + n] = v;
  }
  __syncthreads();  // x is in act before layer 0's stages copy it back

  for (int l = 0; l <= L1; ++l) {  // layer 0 streams x (D wide) from act, the others H wide
    const size_t off = static_cast<size_t>(l > 0 ? l - 1 : 0) * H * H;
    dense_tc<H, false, ROUTE>(tile, l ? ws.whhi + off : ws.w0hi, l ? ws.whlo + off : ws.w0lo,
                       l ? bh + static_cast<size_t>(l - 1) * H : b0, l ? H : D, wst,
                       act + (static_cast<size_t>(D) + static_cast<size_t>(l) * H) * Np, nullptr,
                       Np, n0, l ? nullptr : act, xst);
  }
  __syncthreads();

  // head, fp32 FMAs (of bf16-rounded operands with head_bf16): thread ->
  // (point, output column)
  for (int e = tid; e < kTileP * kHead; e += kThreads) {
    const int p = e >> 2;
    const int o = e & 3;
    float acc = 0.f;
    if (head_bf16) {
      for (int k = 0; k < H; ++k)
        acc = fmaf(round_bf16(tile[k * kLd + p]), round_bf16(__ldg(wout + k * kOutPad + o)), acc);
    } else {
      for (int k = 0; k < H; ++k) acc = fmaf(tile[k * kLd + p], __ldg(wout + k * kOutPad + o), acc);
    }
    out4[static_cast<size_t>(o) * Np + n0 + p] = acc + __ldg(bout + o);
  }
}

// Per-ray compositing state of one warp, in dynamic shared memory (9*S
// floats): weights, transmittances, om, alpha, dists, raw sigma, sigmoid rgb.
struct RaySmem {
  float *w, *T, *om, *alpha, *dist, *sig, *rgb;
};

__device__ __forceinline__ RaySmem ray_smem(float* base, int S) {
  RaySmem m;
  m.w = base;
  m.T = m.w + S;
  m.om = m.T + S;
  m.alpha = m.om + S;
  m.dist = m.alpha + S;
  m.sig = m.dist + S;
  m.rgb = m.sig + S;  // 3*S
  return m;
}

// Forward compositing of one ray by one warp: the log-space transmittance
// by an inclusive fp32 prefix scan, T = exp(incl - log om) as the JAX body
// computes it; kExclusive (the highest route) takes the exclusive prefix
// from the scan instead, T = exp(excl), which drops the cancellation of
// subtracting a large log om (~-23 at the 1e-10 floor) from a sum that
// holds it: the gradients come 4-5x closer to a float64 run. Fills m and
// returns, in every lane, sums = {sum w*r, sum w*g, sum w*b, sum w*z, sum w,
// sum w^2}.
template <bool kExclusive>
__device__ __forceinline__ void composite_forward(const float* __restrict__ out4,
                                                  const float* __restrict__ zr, float dn,
                                                  size_t nb, int Np, int S, RaySmem m,
                                                  float sums[6]) {
  const int lane = threadIdx.x;
  const unsigned full = 0xffffffffu;
  float carry = 0.f;
  float r0 = 0.f, r1 = 0.f, r2 = 0.f, dep = 0.f, accw = 0.f, wsq = 0.f;
  for (int base = 0; base < S; base += 32) {
    const int i = base + lane;
    float lg = 0.f, alpha = 0.f, zi = 0.f, dist = 0.f, sig = 0.f, om = 1.f;
    if (i < S) {
      zi = zr[i];
      dist = (i + 1 < S ? zr[i + 1] - zi : kFar) * dn;
      sig = out4[3 * static_cast<size_t>(Np) + nb + i];
      const float ea = expf(-fmaxf(sig, 0.f) * dist);
      alpha = 1.f - ea;
      om = ea + kEps;
      lg = logf(om);
    }
    float incl = lg;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(full, incl, off);
      if (lane >= off) incl += t;
    }
    float excl = __shfl_up_sync(full, incl, 1);
    if (lane == 0) excl = 0.f;
    excl += carry;
    incl += carry;
    carry = __shfl_sync(full, incl, 31);
    if (i < S) {
      const float T = kExclusive ? expf(excl) : expf(incl - lg);
      const float w = alpha * T;
      float rs[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        rs[ch] = 1.f / (1.f + expf(-out4[static_cast<size_t>(ch) * Np + nb + i]));
      m.w[i] = w;
      m.T[i] = T;
      m.om[i] = om;
      m.alpha[i] = alpha;
      m.dist[i] = dist;
      m.sig[i] = sig;
      m.rgb[3 * i + 0] = rs[0];
      m.rgb[3 * i + 1] = rs[1];
      m.rgb[3 * i + 2] = rs[2];
      r0 = fmaf(w, rs[0], r0);
      r1 = fmaf(w, rs[1], r1);
      r2 = fmaf(w, rs[2], r2);
      dep = fmaf(w, zi, dep);
      accw += w;
      wsq = fmaf(w, w, wsq);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r0 += __shfl_xor_sync(full, r0, off);
    r1 += __shfl_xor_sync(full, r1, off);
    r2 += __shfl_xor_sync(full, r2, off);
    dep += __shfl_xor_sync(full, dep, off);
    accw += __shfl_xor_sync(full, accw, off);
    wsq += __shfl_xor_sync(full, wsq, off);
  }
  sums[0] = r0;
  sums[1] = r1;
  sums[2] = r2;
  sums[3] = dep;
  sums[4] = accw;
  sums[5] = wsq;
}

// Backward compositing of one ray by one warp, from
//   dL/dw_i = rgb_s_i.g + g_acc [+ reg_coef*w_i] [+ depth_coef*z_i] [+ gw_i]:
// the strict suffix sums s_after by an fp32 scan from the last sample (never
// a difference of prefix sums, which cancels when om ~ 1e-10), then the head
// cotangent gout ([4][Np]: d pre-sigmoid rgb, d sigma).
__device__ __forceinline__ void composite_backward(const float* __restrict__ zr, size_t nb,
                                                   int Np, int S, RaySmem m, float g0, float g1,
                                                   float g2, float g_acc, bool use_reg,
                                                   float reg_coef, bool use_depth,
                                                   float depth_coef,
                                                   const float* __restrict__ gw,
                                                   float* __restrict__ gout) {
  const int lane = threadIdx.x;
  const unsigned full = 0xffffffffu;
  float carry = 0.f;
  for (int base = ((S - 1) / 32) * 32; base >= 0; base -= 32) {
    const int i = base + lane;
    float dLdw = 0.f, q = 0.f;
    if (i < S) {
      const float w = m.w[i];
      dLdw = m.rgb[3 * i + 0] * g0 + m.rgb[3 * i + 1] * g1 + m.rgb[3 * i + 2] * g2 + g_acc;
      if (use_reg) dLdw += reg_coef * w;
      if (use_depth) dLdw += depth_coef * zr[i];
      if (gw != nullptr) dLdw += gw[i];
      q = dLdw * w;
    }
    float incl = q;  // sum of q over lanes >= this one
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_down_sync(full, incl, off);
      if (lane + off < 32) incl += t;
    }
    float after = __shfl_down_sync(full, incl, 1);
    if (lane == 31) after = 0.f;
    after += carry;
    carry += __shfl_sync(full, incl, 0);
    if (i < S) {
      const float d_alpha = dLdw * m.T[i] - after / m.om[i];
      const float d_sigma = m.sig[i] > 0.f ? d_alpha * (1.f - m.alpha[i]) * m.dist[i] : 0.f;
      gout[3 * static_cast<size_t>(Np) + nb + i] = d_sigma;
      const float w = m.w[i];
      const float gs[3] = {g0, g1, g2};
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float rs = m.rgb[3 * i + ch];
        gout[static_cast<size_t>(ch) * Np + nb + i] = w * gs[ch] * rs * (1.f - rs);
      }
    }
  }
}

// One warp per ray: compositing, the ray's loss partial and the head
// cotangent g_out of the training objective.
template <bool kExclusive>
__global__ void __launch_bounds__(32)
train_composite_kernel(const float* __restrict__ out4, const float* __restrict__ z,
                       const float* __restrict__ dnorm, const float* __restrict__ tgt,
                       const float* __restrict__ mask, const float* __restrict__ inv_denom_p,
                       const float* __restrict__ tgt_depth, float* __restrict__ gout,
                       float* __restrict__ loss_r, int S, int Np, int white_bkgd, float rgb_c,
                       float reg_c, float depth_c) {
  extern __shared__ float4 csm4[];
  const RaySmem m = ray_smem(reinterpret_cast<float*>(csm4), S);
  const int ray = blockIdx.x;
  const float* zr = z + static_cast<size_t>(ray) * S;
  const size_t nb = static_cast<size_t>(ray) * S;
  const float inv_denom = *inv_denom_p;
  float sums[6];
  composite_forward<kExclusive>(out4, zr, dnorm[ray], nb, Np, S, m, sums);
  const float accw = sums[4];

  // loss partial and the scalars of the backward
  const float m_r = mask[ray];
  const float bg = white_bkgd ? 1.f - accw : 0.f;
  const float e0 = (sums[0] + bg - tgt[3 * ray + 0]) * m_r;
  const float e1 = (sums[1] + bg - tgt[3 * ray + 1]) * m_r;
  const float e2r = (sums[2] + bg - tgt[3 * ray + 2]) * m_r;
  const float rgb_scale = rgb_c * inv_denom;
  float loss = (e0 * e0 + e1 * e1 + e2r * e2r) * rgb_scale;
  const float g0 = 2.f * e0 * rgb_scale;
  const float g1 = 2.f * e1 * rgb_scale;
  const float g2 = 2.f * e2r * rgb_scale;
  const float g_acc = white_bkgd ? -(g0 + g1 + g2) : 0.f;
  float reg_coef = 0.f;
  if (reg_c != 0.f) {
    const float reg_scale = reg_c * inv_denom;
    loss += sums[5] * m_r * reg_scale;
    reg_coef = 2.f * reg_scale * m_r;
  }
  float depth_coef = 0.f;
  if (tgt_depth != nullptr) {
    const float d_scale = depth_c * inv_denom;
    const float diff = sums[3] - tgt_depth[ray];
    loss += fabsf(diff) * m_r * d_scale;
    const float sgn = diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f);
    depth_coef = d_scale * sgn * m_r;
  }
  composite_backward(zr, nb, Np, S, m, g0, g1, g2, g_acc, reg_c != 0.f, reg_coef,
                     tgt_depth != nullptr, depth_coef, nullptr, gout);
  if (threadIdx.x == 0) loss_r[ray] = loss;
}

// One warp per ray: the backward compositing of the differentiable render
// from the external cotangents (g_rgb (R,3), g_depth (R,1), g_acc (R,1),
// g_weights (R,S)); a white background adds -sum g_rgb into g_acc.
template <bool kExclusive>
__global__ void __launch_bounds__(32)
render_composite_kernel(const float* __restrict__ out4, const float* __restrict__ z,
                        const float* __restrict__ dnorm, const float* __restrict__ g_rgb,
                        const float* __restrict__ g_depth, const float* __restrict__ g_acc,
                        const float* __restrict__ g_weights, float* __restrict__ gout, int S,
                        int Np, int white_bkgd) {
  extern __shared__ float4 csm4[];
  const RaySmem m = ray_smem(reinterpret_cast<float*>(csm4), S);
  const int ray = blockIdx.x;
  const float* zr = z + static_cast<size_t>(ray) * S;
  const size_t nb = static_cast<size_t>(ray) * S;
  float sums[6];
  composite_forward<kExclusive>(out4, zr, dnorm[ray], nb, Np, S, m, sums);
  const float g0 = g_rgb[3 * ray + 0];
  const float g1 = g_rgb[3 * ray + 1];
  const float g2 = g_rgb[3 * ray + 2];
  float ga = g_acc[ray];
  if (white_bkgd) ga -= g0 + g1 + g2;
  composite_backward(zr, nb, Np, S, m, g0, g1, g2, ga, false, 0.f, true, g_depth[ray],
                     g_weights + nb, gout);
}

// Backward chain of one 64-point tile: delta_L = (g_out.wout[:, :4]^T) *
// [A_L > 0] (exact fp32), then delta_i = (delta_{i+1}.wh[i-1]^T) * [A_i > 0]
// on the tensor cores; each delta goes to gbuf ([L*H][Np], delta_i at row
// (i-1)*H). head_bf16: the seed's operands rounded to bf16.
template <int H, int ROUTE>
__global__ void __launch_bounds__(kThreads, 1)
train_bwd_kernel(const float* __restrict__ gout, const float* __restrict__ wout, const WSplit ws,
                 const float* __restrict__ act, float* __restrict__ gbuf, int N, int Np, int D,
                 int L1, bool head_bf16) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* tile = smem;  // [H][kLd], each layer in place
  float* wst = tile + H * kLd;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kTileP;
  const float* hL = act + (static_cast<size_t>(D) + static_cast<size_t>(L1) * H) * Np;
  float* dL = gbuf + static_cast<size_t>(L1) * H * Np;

  for (int idx = tid; idx < H * kTileP; idx += kThreads) {
    const int k = idx / kTileP;
    const int p = idx % kTileP;
    const int n = n0 + p;
    float v = 0.f;
    if (n < N) {
      const float* wk = wout + k * kOutPad;
      const bool r = head_bf16;
      float s = head_in(gout[n], r) * head_in(__ldg(wk + 0), r);
      s = fmaf(head_in(gout[static_cast<size_t>(Np) + n], r), head_in(__ldg(wk + 1), r), s);
      s = fmaf(head_in(gout[2 * static_cast<size_t>(Np) + n], r), head_in(__ldg(wk + 2), r), s);
      s = fmaf(head_in(gout[3 * static_cast<size_t>(Np) + n], r), head_in(__ldg(wk + 3), r), s);
      v = hL[static_cast<size_t>(k) * Np + n] > 0.f ? s : 0.f;
    }
    tile[k * kLd + p] = v;
    dL[static_cast<size_t>(k) * Np + n] = v;
  }

  for (int l = L1 - 1; l >= 0; --l) {
    // delta_{l+1} = (delta_{l+2} . wh[l]^T) * [A_{l+1} > 0]
    const size_t off = static_cast<size_t>(l) * H * H;
    dense_tc<H, true, ROUTE>(tile, ws.whThi + off, ws.whTlo + off, nullptr, H, wst,
                      gbuf + static_cast<size_t>(l) * H * Np,
                      act + (static_cast<size_t>(D) + static_cast<size_t>(l) * H) * Np, Np, n0);
  }
}

// One dW product: out[k][j] = sum_n A[k][n] * G[j][n] (j < J, zero for
// j >= Jreal), db[j] = sum_n G[j][n].
struct DwJob {
  const float* A;
  const float* G;
  int K, J, Jreal, tiles;
  size_t out, db;  // offsets in the flattened gradient
};
struct DwJobs {
  DwJob job[kMaxJobs];
  int n;
};

// One 128x128 tile (rows k, columns j) of a dW product over one part of
// the point axis, on the tensor cores: 2x4 warps of 64x32, the operands'
// 32-point stages through a ring of kDwStages cp.async buffers (both are
// feature-major, so a stage is 128 rows of 32 contiguous points each), one
// barrier per stage. Rows past K and columns past Jreal are zero-filled; so
// are points past the part's end. The CTAs of the tile row k0 = 0 also sum
// db from the G fragments (the fp32 values, whatever the route).
template <int ROUTE>
__global__ void __launch_bounds__(kThreads, 1)
train_dw_kernel(const DwJobs jobs, float* __restrict__ partial, int N, int Np, size_t Fp,
                int chunk) {
  extern __shared__ float4 dsm4[];
  float* sm = reinterpret_cast<float*>(dsm4);
  int tile = blockIdx.x;
  int jb = 0;
  while (jb + 1 < jobs.n && tile >= jobs.job[jb].tiles) {
    tile -= jobs.job[jb].tiles;
    ++jb;
  }
  const DwJob& jd = jobs.job[jb];
  const int tiles_j = (jd.J + kDwT - 1) / kDwT;
  const int k0 = (tile / tiles_j) * kDwT;
  const int j0 = (tile % tiles_j) * kDwT;
  const int nb = blockIdx.y * chunk;
  const int ne = min(N, nb + chunk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const bool live = j0 + wn * 32 < jd.Jreal;  // else the warp's G rows are all padding
  const bool sum_db = k0 == 0 && wm == 0;

  float acc[4][4][4], part[4][4][4];
  float gsum[4] = {0.f, 0.f, 0.f, 0.f};
  float gcomp[4] = {0.f, 0.f, 0.f, 0.f};  // the compensations of the kFp32 route's db sums
  zero_block(acc);
  zero_block(part);

  auto load = [&](int s) {
    float* st = sm + (s % kDwStages) * kDwStage;
    const int n = nb + s * kBN;
    constexpr int kRowChunks = kBN / 4;
#pragma unroll
    for (int v = 0; v < 2 * kDwT * kRowChunks / kThreads; ++v) {
      const int c = threadIdx.x + v * kThreads;
      const int op = c / (kDwT * kRowChunks);  // 0: A, 1: G
      const int r = (c / kRowChunks) % kDwT;
      const int q = c % kRowChunks;
      const int np = n + q * 4;
      int bytes = 4 * min(max(ne - np, 0), 4);
      const float* src;
      if (op == 0) {
        if (k0 + r >= jd.K) bytes = 0;
        src = jd.A + static_cast<size_t>(k0 + r) * Np + np;
      } else {
        if (j0 + r >= jd.Jreal) bytes = 0;
        src = jd.G + static_cast<size_t>(j0 + r) * Np + np;
      }
      cp_async16(st + (op * kDwT + r) * kDwLd + q * 4, bytes ? src : jd.A, bytes);
    }
    cp_async_commit();
  };

  const int n_stages = ne > nb ? (ne - nb + kBN - 1) / kBN : 0;
  for (int s = 0; s < kDwStages - 1 && s < n_stages; ++s) load(s);
  for (int s = 0; s < n_stages; ++s) {
    // stage s has landed once at most the stages after it are pending
    if (s + kDwStages - 2 < n_stages) {
      cp_async_wait<kDwStages - 2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage s is visible; every warp is done with stage s-1
    if (s + kDwStages - 1 < n_stages) load(s + kDwStages - 1);  // into stage s-1's buffer
    const float* As = sm + (s % kDwStages) * kDwStage + wm * 64 * kDwLd;
    const float* Gs = sm + (s % kDwStages) * kDwStage + (kDwT + wn * 32) * kDwLd;
    if (live && ROUTE == kFp32) {
      // each stage's 32 products into part, then one round-to-nearest add
      // per output: the point axis is summed in two levels, not as one
      // chain of up to kPartRows FMAs
#pragma unroll 4
      for (int k = 0; k < kBN; ++k) {
        float a[4][2], b[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i][0] = As[(i * 16 + g) * kDwLd + k];
          a[i][1] = As[(i * 16 + g + 8) * kDwLd + k];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j][0] = Gs[(j * 8 + 2 * t) * kDwLd + k];
          b[j][1] = Gs[(j * 8 + 2 * t + 1) * kDwLd + k];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            part[i][j][0] = fmaf(a[i][0], b[j][0], part[i][j][0]);
            part[i][j][1] = fmaf(a[i][0], b[j][1], part[i][j][1]);
            part[i][j][2] = fmaf(a[i][1], b[j][0], part[i][j][2]);
            part[i][j][3] = fmaf(a[i][1], b[j][1], part[i][j][3]);
          }
      }
      promote(acc, part);
      if (sum_db) {  // db as a compensated (Kahan) sum: a thread adds ~N/4 terms
#pragma unroll
        for (int kk = 0; kk < kBN; kk += 8) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float* b = Gs + (j * 8 + g) * kDwLd + kk + t;
            const float y = __fsub_rn(__fadd_rn(b[0], b[4]), gcomp[j]);
            const float sum = __fadd_rn(gsum[j], y);
            gcomp[j] = __fsub_rn(__fsub_rn(sum, gsum[j]), y);
            gsum[j] = sum;
          }
        }
      }
    } else if (live && ROUTE == kBf16) {
#pragma unroll
      for (int kk = 0; kk < kBN; kk += 8) {
        uint32_t a[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) load_a_mmajor_bf16(As + i * 16 * kDwLd + kk, kDwLd, g, t, a[i]);
        mma1_step(part, a, [&](int j) {
          const float2 v = *reinterpret_cast<const float2*>(Gs + (j * 8 + g) * kDwLd + kk + 2 * t);
          if (sum_db) gsum[j] += v.x + v.y;  // db from the same fp32 values
          return pack_bf16(v.x, v.y);
        });
        if (kk & 8) promote(acc, part);
      }
    } else if (live) {
#pragma unroll
      for (int kk = 0; kk < kBN; kk += 8) {
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_a_mmajor_split(As + i * 16 * kDwLd + kk, kDwLd, g, t, ahi[i], alo[i]);
        auto bfrag = [&](int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
          const float* b = Gs + (j * 8 + g) * kDwLd + kk + t;
          const float v0 = b[0], v1 = b[4];
          if (sum_db) gsum[j] += v0 + v1;  // db from the same fp32 values
          split_fast(v0, bh[0], bl[0]);
          split_fast(v1, bh[1], bl[1]);
        };
        mma3_step<2>(part, ahi, alo, bfrag);
        if (kk & 8) promote(acc, part);
      }
    }
  }

  float* out = partial + blockIdx.y * Fp;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = j0 + wn * 32 + j * 8 + 2 * t;
    if (col >= jd.J) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + wm * 64 + i * 16 + g;
      if (k < jd.K)
        *reinterpret_cast<float2*>(out + jd.out + static_cast<size_t>(k) * jd.J + col) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (k + 8 < jd.K)
        *reinterpret_cast<float2*>(out + jd.out + static_cast<size_t>(k + 8) * jd.J + col) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
  if (sum_db) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = gsum[j];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int col = j0 + wn * 32 + j * 8 + g;
      if (t == 0 && col < jd.J) out[jd.db + col] = v;
    }
  }
}

__global__ void train_finalize_kernel(const float* __restrict__ part, float* __restrict__ grads,
                                      size_t F, size_t Fp, int P) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= F) return;
  float s = part[idx];
  for (int p = 1; p < P; ++p) s += part[static_cast<size_t>(p) * Fp + idx];
  grads[idx] = s;
}

__global__ void __launch_bounds__(256)
loss_sum_kernel(const float* __restrict__ loss_r, float* __restrict__ loss, int R) {
  __shared__ float red[256];
  float s = 0.f;
  for (int r = threadIdx.x; r < R; r += 256) s += loss_r[r];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[0] = red[0];
}

// The input cotangent of the differentiable render: dx[n][k] = sum_j
// delta_1[j][n] * w0[k][j], (N, H) x (H, D), with delta_1 the ReLU-gated
// cotangent of the first layer (gbuf rows 0..H-1, [H][Np]), on the tensor
// cores: 64 points x 64 input columns per CTA, 2x4 warps of 32x16, the
// reduction over j in cp.async stages of 32 (delta_1 split on the fly, the
// halves of w0 from weight_split); the bfloat16 and highest routes read
// w0's image from the hi half, as dense_tc does.
template <int ROUTE>
__global__ void __launch_bounds__(kThreads, 1)
render_dx_kernel(const float* __restrict__ delta1, const float* __restrict__ w0hi,
                 const float* __restrict__ w0lo, float* __restrict__ dx, int N, int Np, int D,
                 int H) {
  extern __shared__ float4 xsm4[];
  float* sm = reinterpret_cast<float*>(xsm4);
  const int n0 = blockIdx.x * kDxP;
  const int k0 = blockIdx.y * kDxK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pm = (warp >> 2) * 32;  // the warp's first point
  const int kn = (warp & 3) * 16;   // the warp's first input column

  float acc[2][2][4], part[2][2][4];
  zero_block(acc);
  zero_block(part);

  // a stage: delta_1[j0 .. j0+31][n0 .. n0+63], then the hi and lo halves of
  // w0[k0 .. k0+63][j0 .. j0+31] (rows past D zero-filled)
  auto load = [&](float* st, int j0) {
    constexpr int kDChunks = kDxJ * kDxP / 4;        // 512
    constexpr int kWChunks = kDxK * kDxJ / 4;        // 512 per half
    constexpr int kAll = kDChunks + (ROUTE == kTf32x3 ? 2 : 1) * kWChunks;
    static_assert(kAll % kThreads == 0, "dx stage copies per thread");
#pragma unroll
    for (int v = 0; v < kAll / kThreads; ++v) {
      const int c = threadIdx.x + v * kThreads;
      if (c < kDChunks) {
        const int r = c / (kDxP / 4), q = c % (kDxP / 4);
        cp_async16(st + r * kDxLdD + q * 4,
                   delta1 + static_cast<size_t>(j0 + r) * Np + n0 + q * 4, 16);
      } else {
        const int c2 = c - kDChunks;
        const int half = c2 / kWChunks;
        const int r = (c2 % kWChunks) / (kDxJ / 4), q = c2 % (kDxJ / 4);
        const bool in = k0 + r < D;
        const float* src = (half ? w0lo : w0hi) + static_cast<size_t>(k0 + r) * H + j0 + q * 4;
        cp_async16(st + kDxJ * kDxLdD + (half * kDxK + r) * kDxLdW + q * 4, in ? src : w0hi,
                   in ? 16 : 0);
      }
    }
  };

  const int n_stages = H / kDxJ;
  load(sm, 0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // stage s has landed; every warp is done with stage s-1
    if (s + 1 < n_stages) {
      load(sm + ((s + 1) & 1) * kDxStage, (s + 1) * kDxJ);
      cp_async_commit();
    }
    const float* Ds = sm + (s & 1) * kDxStage;
    const float* Wh = Ds + kDxJ * kDxLdD;
    const float* Wl = Wh + kDxK * kDxLdW;
    if constexpr (ROUTE == kFp32) {
#pragma unroll 4
      for (int jj = 0; jj < kDxJ; ++jj) {
        float a[2][2], b[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[i][0] = Ds[jj * kDxLdD + pm + i * 16 + g];
          a[i][1] = Ds[jj * kDxLdD + pm + i * 16 + g + 8];
          b[i][0] = Wh[(kn + i * 8 + 2 * t) * kDxLdW + jj];
          b[i][1] = Wh[(kn + i * 8 + 2 * t + 1) * kDxLdW + jj];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            acc[i][j][0] = fmaf(a[i][0], b[j][0], acc[i][j][0]);
            acc[i][j][1] = fmaf(a[i][0], b[j][1], acc[i][j][1]);
            acc[i][j][2] = fmaf(a[i][1], b[j][0], acc[i][j][2]);
            acc[i][j][3] = fmaf(a[i][1], b[j][1], acc[i][j][3]);
          }
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < kDxJ; jj += 8) {
        if constexpr (ROUTE == kBf16) {
          uint32_t a[2][2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            load_a_kmajor_bf16(Ds + jj * kDxLdD + pm + i * 16, kDxLdD, g, t, a[i]);
          mma1_step(part, a, [&](int j) {
            const int o = (kn + j * 8 + g) * kDxLdW + jj + 2 * t;
            return pack_bf16(Wh[o], Wh[o + 1]);
          });
        } else {
          uint32_t ahi[2][4], alo[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            load_a_kmajor_split(Ds + jj * kDxLdD + pm + i * 16, kDxLdD, g, t, ahi[i], alo[i]);
          auto bfrag = [&](int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
            const int o = (kn + j * 8 + g) * kDxLdW + jj + t;
            bh[0] = __float_as_uint(Wh[o]);
            bh[1] = __float_as_uint(Wh[o + 4]);
            bl[0] = __float_as_uint(Wl[o]);
            bl[1] = __float_as_uint(Wl[o + 4]);
          };
          mma3_step<2>(part, ahi, alo, bfrag);
        }
        if (jj & 8) promote(acc, part);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = n0 + pm + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + kn + j * 8 + 2 * t;
      if (k >= D) continue;
      if (n < N)
        *reinterpret_cast<float2*>(dx + static_cast<size_t>(n) * D + k) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (n + 8 < N)
        *reinterpret_cast<float2*>(dx + static_cast<size_t>(n + 8) * D + k) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// Every dW = A^T.delta and db = sum delta (layer 0, the L1 hidden layers,
// the head) over fixed point-axis parts, then the fixed-order sum of the
// parts into grads. The layers' products take dw_route, the head's
// head_route: one launch when they agree, else one per route (into the
// same partials).
void launch_dw(const Layout& s, const float* act, const float* gbuf, const float* gout,
               float* part, float* grads, int D, int H, int L1, int dw_route, int head_route,
               cudaStream_t stream) {
  DwJobs jobs[2];
  int total_tiles[2] = {0, 0};
  jobs[0].n = jobs[1].n = 0;
  auto add = [&](int grp, const float* A, const float* G, int K, int J, int Jreal, size_t out,
                 size_t db) {
    DwJob& j = jobs[grp].job[jobs[grp].n++];
    j.A = A;
    j.G = G;
    j.K = K;
    j.J = J;
    j.Jreal = Jreal;
    j.tiles = ((K + kDwT - 1) / kDwT) * ((J + kDwT - 1) / kDwT);
    j.out = out;
    j.db = db;
    total_tiles[grp] += j.tiles;
  };
  const size_t np = s.Np;
  const size_t off_w0 = 0, off_b0 = static_cast<size_t>(D) * H;
  const size_t off_wh = off_b0 + H;
  const size_t off_bh = off_wh + static_cast<size_t>(L1) * H * H;
  const size_t off_wout = off_bh + static_cast<size_t>(L1) * H;
  const size_t off_bout = off_wout + static_cast<size_t>(H) * kOutPad;
  add(0, act, gbuf, D, H, H, off_w0, off_b0);
  for (int l = 0; l < L1; ++l) {
    add(0, act + (static_cast<size_t>(D) + static_cast<size_t>(l) * H) * np,
        gbuf + static_cast<size_t>(l + 1) * H * np, H, H, H,
        off_wh + static_cast<size_t>(l) * H * H, off_bh + static_cast<size_t>(l) * H);
  }
  add(head_route == dw_route ? 0 : 1, act + (static_cast<size_t>(D) + static_cast<size_t>(L1) * H) * np,
      gout, H, kOutPad, kHead, off_wout, off_bout);
  const size_t Fp = round_up(s.F, 64);
  for (int grp = 0; grp < 2; ++grp) {
    if (jobs[grp].n == 0) continue;
    const int route = grp ? head_route : dw_route;
    const dim3 grid(total_tiles[grp], s.P);
    if (route == kBf16)
      train_dw_kernel<kBf16><<<grid, kThreads, kDwSmem, stream>>>(jobs[grp], part, s.N, s.Np, Fp,
                                                                  s.chunk);
    else if (route == kFp32)
      train_dw_kernel<kFp32><<<grid, kThreads, kDwSmem, stream>>>(jobs[grp], part, s.N, s.Np, Fp,
                                                                  s.chunk);
    else
      train_dw_kernel<kTf32x3><<<grid, kThreads, kDwSmem, stream>>>(jobs[grp], part, s.N, s.Np,
                                                                    Fp, s.chunk);
  }
  train_finalize_kernel<<<static_cast<unsigned>((s.F + 255) / 256), 256, 0, stream>>>(
      part, grads, s.F, Fp, s.P);
}

// The recompute of the trunk: the weights' images, then every layer's
// activations and the 4 head outputs of each 64-point tile.
template <int H, bool INLINE_PE, int ROUTE>
void launch_forward(const Layout& s, const float* in, const float* feats, const float* e2,
                    const float* c, const float* w0, const float* b0, const float* wh,
                    const float* bh, const float* wout, const float* bout, float* act, float* out4,
                    const WSplit& ws, int n_raw, int n_phase, int Fd, int D, int L1,
                    bool head_bf16, cudaStream_t stream) {
  const int rows = D > H ? D : H;
  weight_split_kernel<ROUTE><<<dim3(H / 32, (rows + 31) / 32, 1 + L1), dim3(32, 8), 0, stream>>>(
      w0, wh, ws.w0hi, ws.w0lo, ws.whhi, ws.whlo, ws.whThi, ws.whTlo, D, H);
  train_fwd_kernel<H, INLINE_PE, ROUTE><<<s.Np / kTileP, kThreads, Dense<H>::kFwdSmem, stream>>>(
      in, feats, e2, c, ws, b0, bh, wout, bout, act, out4, s.N, s.Np, n_raw, n_phase, Fd, D, L1,
      head_bf16);
}

// The backward chain of each 64-point tile, from the head cotangent gout.
template <int H, int ROUTE>
void launch_backward(const Layout& s, const float* gout, const float* wout, const WSplit& ws,
                     const float* act, float* gbuf, int D, int L1, bool head_bf16,
                     cudaStream_t stream) {
  train_bwd_kernel<H, ROUTE><<<s.Np / kTileP, kThreads, Dense<H>::kBwdSmem, stream>>>(
      gout, wout, ws, act, gbuf, s.N, s.Np, D, L1, head_bf16);
}

struct Scratch {
  float *act, *gbuf, *gout, *out4, *loss_r, *part;
  WSplit ws;
};

Scratch carve(const Layout& s, float* scratch, int D, int H, int L1) {
  return Scratch{scratch + s.act,    scratch + s.gbuf, scratch + s.gout, scratch + s.out4,
                 scratch + s.loss_r, scratch + s.part, wsplit_at(scratch + s.wsplit, D, H, L1)};
}

// The shapes the launches take: every K and N a multiple of the tiles'
// edges, and S samples within the composite's shared memory.
bool shapes_ok(int S, int D, int H, int L1) {
  return S >= 1 && S <= kMaxS && D > 0 && D % 16 == 0 && D <= kMaxD && (H == 128 || H == 256) &&
         L1 >= 0 && L1 + 2 <= kMaxJobs;
}

bool route_ok(int route) { return route == kTf32x3 || route == kBf16 || route == kFp32; }

// The launches above 48 KB of dynamic shared memory need the limit raised,
// which is a host call; it is made once per device and width, for the most
// any call of that width asks for.
template <int H, int ROUTE>
cudaError_t raise_route_smem_limits() {
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(train_fwd_kernel<H, true, ROUTE>, a, Dense<H>::kFwdSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(train_fwd_kernel<H, false, ROUTE>, a, Dense<H>::kFwdSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(train_bwd_kernel<H, ROUTE>, a, Dense<H>::kBwdSmem);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(train_dw_kernel<ROUTE>, a, kDwSmem);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(render_dx_kernel<ROUTE>, a, kDxSmem);
  return err;
}

template <int H>
cudaError_t raise_smem_limits() {
  cudaError_t err = raise_route_smem_limits<H, kTf32x3>();
  if (err == cudaSuccess) err = raise_route_smem_limits<H, kBf16>();
  if (err == cudaSuccess) err = raise_route_smem_limits<H, kFp32>();
  return err;
}

cudaError_t smem_limits_once(int device, int H) {
  static std::atomic<unsigned long long> done[2];  // a bit per device, for H = 128 and 256
  std::atomic<unsigned long long>& d = done[H == 256];
  const unsigned long long bit = 1ull << (device & 63);
  if (d.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = H == 256 ? raise_smem_limits<256>() : raise_smem_limits<128>();
  if (err == cudaSuccess) d.fetch_or(bit, std::memory_order_release);
  return err;
}

// The objective's arguments, as nerf_train_objective takes them.
struct TrainArgs {
  const float *in, *feats, *z, *dnorm, *tgt, *mask, *inv_denom, *tgt_depth, *e2, *c;
  const float *w0, *b0, *wh, *bh, *wout, *bout;
  float *loss, *grads, *scratch;
  int R, S, n_raw, n_phase, Fd, D, L1, white_bkgd;
  float rgb_c, reg_c, depth_c;
  int dw_route, head_vpu;
};

// The objective on route ROUTE; the dW products on a.dw_route, the head in
// exact fp32 with a.head_vpu (its dW then kFp32 too).
template <int H, bool INLINE_PE, int ROUTE>
cudaError_t launch(const TrainArgs& a, cudaStream_t stream) {
  const Layout s = make_layout(a.R, a.S, a.D, H, a.L1);
  const Scratch b = carve(s, a.scratch, a.D, H, a.L1);
  const bool head_bf16 = ROUTE == kBf16 && !a.head_vpu;
  launch_forward<H, INLINE_PE, ROUTE>(s, a.in, a.feats, a.e2, a.c, a.w0, a.b0, a.wh, a.bh,
                                      a.wout, a.bout, b.act, b.out4, b.ws, a.n_raw, a.n_phase,
                                      a.Fd, a.D, a.L1, head_bf16, stream);

  const size_t comp_smem = sizeof(float) * 9 * static_cast<size_t>(a.S);  // < 48 KB
  train_composite_kernel<ROUTE == kFp32><<<a.R, 32, comp_smem, stream>>>(
      b.out4, a.z, a.dnorm, a.tgt, a.mask, a.inv_denom, a.tgt_depth, b.gout, b.loss_r, a.S, s.Np,
      a.white_bkgd, a.rgb_c, a.reg_c, a.depth_c);

  launch_backward<H, ROUTE>(s, b.gout, a.wout, b.ws, b.act, b.gbuf, a.D, a.L1, head_bf16, stream);
  launch_dw(s, b.act, b.gbuf, b.gout, b.part, a.grads, a.D, H, a.L1, a.dw_route,
            a.head_vpu ? kFp32 : a.dw_route, stream);
  loss_sum_kernel<<<1, 256, 0, stream>>>(b.loss_r, a.loss, a.R);
  return cudaGetLastError();
}

template <int H, bool INLINE_PE>
cudaError_t dispatch_route(int route, const TrainArgs& a, cudaStream_t st) {
  if (route == kBf16) return launch<H, INLINE_PE, kBf16>(a, st);
  if (route == kFp32) return launch<H, INLINE_PE, kFp32>(a, st);
  return launch<H, INLINE_PE, kTf32x3>(a, st);
}

template <int H>
cudaError_t dispatch(int inline_pe, int route, const TrainArgs& a, cudaStream_t st) {
  return inline_pe ? dispatch_route<H, true>(route, a, st) : dispatch_route<H, false>(route, a, st);
}

// Kernel 3: the VJP of the render from a pre-encoded x. Recomputes the
// forward, composites backward from the external cotangents, runs the
// backward chain and the dW products, and (dx != nullptr) the input
// cotangent, every product on route ROUTE.
template <int H, int ROUTE>
cudaError_t launch_render_bwd(const float* x, const float* z, const float* dnorm,
                              const float* w0, const float* b0, const float* wh,
                              const float* bh, const float* wout, const float* bout,
                              const float* g_rgb, const float* g_depth, const float* g_acc,
                              const float* g_weights, float* dx, float* grads, float* scratch,
                              int R, int S, int D, int L1, int white_bkgd, cudaStream_t stream) {
  const Layout s = make_layout(R, S, D, H, L1);
  const Scratch b = carve(s, scratch, D, H, L1);
  constexpr bool head_bf16 = ROUTE == kBf16;
  launch_forward<H, false, ROUTE>(s, x, nullptr, nullptr, nullptr, w0, b0, wh, bh, wout, bout,
                                  b.act, b.out4, b.ws, 0, 0, 0, D, L1, head_bf16, stream);

  const size_t comp_smem = sizeof(float) * 9 * static_cast<size_t>(S);  // < 48 KB
  render_composite_kernel<ROUTE == kFp32><<<R, 32, comp_smem, stream>>>(b.out4, z, dnorm, g_rgb, g_depth, g_acc,
                                                        g_weights, b.gout, S, s.Np, white_bkgd);

  launch_backward<H, ROUTE>(s, b.gout, wout, b.ws, b.act, b.gbuf, D, L1, head_bf16, stream);
  launch_dw(s, b.act, b.gbuf, b.gout, b.part, grads, D, H, L1, ROUTE, ROUTE, stream);
  if (dx != nullptr) {
    render_dx_kernel<ROUTE>
        <<<dim3(s.Np / kDxP, (D + kDxK - 1) / kDxK), kThreads, kDxSmem, stream>>>(
            b.gbuf, b.ws.w0hi, b.ws.w0lo, dx, s.N, s.Np, D, H);
  }
  return cudaGetLastError();
}

template <int H>
cudaError_t render_bwd_route(int route, const float* x, const float* z, const float* dnorm,
                             const float* w0, const float* b0, const float* wh, const float* bh,
                             const float* wout, const float* bout, const float* g_rgb,
                             const float* g_depth, const float* g_acc, const float* g_weights,
                             float* dx, float* grads, float* scratch, int R, int S, int D, int L1,
                             int white_bkgd, cudaStream_t st) {
  if (route == kBf16)
    return launch_render_bwd<H, kBf16>(x, z, dnorm, w0, b0, wh, bh, wout, bout, g_rgb, g_depth,
                                       g_acc, g_weights, dx, grads, scratch, R, S, D, L1,
                                       white_bkgd, st);
  if (route == kFp32)
    return launch_render_bwd<H, kFp32>(x, z, dnorm, w0, b0, wh, bh, wout, bout, g_rgb, g_depth,
                                       g_acc, g_weights, dx, grads, scratch, R, S, D, L1,
                                       white_bkgd, st);
  return launch_render_bwd<H, kTf32x3>(x, z, dnorm, w0, b0, wh, bh, wout, bout, g_rgb, g_depth,
                                       g_acc, g_weights, dx, grads, scratch, R, S, D, L1,
                                       white_bkgd, st);
}

}  // namespace

// Floats of scratch one call at these sizes needs (the same on every route).
extern "C" unsigned long long nerf_train_scratch_floats(int R, int S, int D, int H, int L1) {
  return make_layout(R, S, D, H, L1).total;
}

// route: the products' precision route (kTf32x3, kBf16, kFp32); dw_route:
// the six dW products'; head_vpu: the head in exact fp32 (the JAX pins
// dw_precision and head_mode).
extern "C" int nerf_train_objective(const float* in, const float* feats, const float* z,
                                    const float* dnorm, const float* tgt, const float* mask,
                                    const float* inv_denom, const float* tgt_depth,
                                    const float* e2, const float* c, const float* w0,
                                    const float* b0, const float* wh, const float* bh,
                                    const float* wout, const float* bout, float* loss,
                                    float* grads, float* scratch, int R, int S, int n_raw,
                                    int n_phase, int Fd, int D, int H, int L1, int inline_pe,
                                    int white_bkgd, float rgb_c, float reg_c, float depth_c,
                                    int route, int dw_route, int head_vpu, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!shapes_ok(S, D, H, L1) || !route_ok(route) || !route_ok(dw_route))
    return cudaErrorInvalidValue;
  err = smem_limits_once(device, H);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TrainArgs a{in,   feats, z,     dnorm,   tgt,     mask,   inv_denom, tgt_depth,
                    e2,   c,     w0,    b0,      wh,      bh,     wout,      bout,
                    loss, grads, scratch, R,     S,       n_raw,  n_phase,   Fd,
                    D,    L1,    white_bkgd, rgb_c, reg_c, depth_c, dw_route, head_vpu};
  if (H == 256) return dispatch<256>(inline_pe, route, a, st);
  return dispatch<128>(inline_pe, route, a, st);
}

extern "C" int nerf_render_bwd(const float* x, const float* z, const float* dnorm,
                               const float* w0, const float* b0, const float* wh, const float* bh,
                               const float* wout, const float* bout, const float* g_rgb,
                               const float* g_depth, const float* g_acc, const float* g_weights,
                               float* dx, float* grads, float* scratch, int R, int S, int D, int H,
                               int L1, int white_bkgd, int route, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!shapes_ok(S, D, H, L1) || !route_ok(route)) return cudaErrorInvalidValue;
  err = smem_limits_once(device, H);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 256)
    return render_bwd_route<256>(route, x, z, dnorm, w0, b0, wh, bh, wout, bout, g_rgb, g_depth,
                                 g_acc, g_weights, dx, grads, scratch, R, S, D, L1, white_bkgd, st);
  return render_bwd_route<128>(route, x, z, dnorm, w0, b0, wh, bh, wout, bout, g_rgb, g_depth,
                               g_acc, g_weights, dx, grads, scratch, R, S, D, L1, white_bkgd, st);
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
