// Fused NeRF training objective and render VJP for Hopper (sm_90a): the
// analytic backward to every packed weight, in one call each, the trunk's
// products on the tensor cores through wgmma.
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
// Numerics. On the float32 route (ROUTE kTf32x3) the trunk's products (the
// forward layers, the backward chain and the dW products) run as 3xTF32 on
// the tensor cores (wgmma .tf32, fp32 accumulation): each fp32 operand is cut
// into two TF32 halves, hi = rna(v) and lo = rna(v - hi), which keep ~22 of
// its 24 bits, and a product is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (a_lo.b_lo,
// ~2^-22 of it, is dropped). The weights are split once per call with
// cvt.rna.tf32.f32; activations and cotangents as they are read, by the same
// rounding in integer operations. The tensor cores round their fp32
// accumulation toward zero, so the products of each 32 weight rows in the
// trunk (two ring stages, a chain of 12 wgmma, as kernel 2's stages) and of
// each 32-point stage of the dW products (12 wgmma) accumulate in their own
// registers and are added to the running sum with round-to-nearest FADDs.
// The gradients are then as close to a float64 run as the fp32 plain
// version's, and far finer than the TPU kernels' one bf16 pass per product.
// Near a ReLU gate no fp32-accurate route is exact: on a few hundred rays
// one gate that two routes round to different sides moves the gradient
// vector by ~1e-3, and which inputs show it depends on
// the order of the sums (PERF.md). Exact fp32 on the CUDA cores: the PE
// phases (unfused multiply-adds, accurate sinf), the log-space transmittance
// prefix scan, the suffix sum s_after, the 4-column head and the seed of the
// backward chain, and the bias sums.
//
// Two more routes compute the JAX kernels' other compute_dtypes
// (nerf_fewshot_tpu/render/kernels.py:63 _dot), with the same launches,
// tiles, rings and producers; only the stage images and the products differ:
//   kBf16 (compute_dtype bfloat16): both operands of every product rounded
//   to bf16 (cvt.rn: to nearest even), one wgmma m64nNk16 .bf16 per 16 k
//   with fp32 accumulation, promoted per stage as above; the weights' images
//   are rounded once per call, activations and cotangents as they are read.
//   The head rounds its operands too (the JAX head is a _dot), unless the
//   caller pins it to exact fp32 (head_mode "vpu");
//   kFp32 (compute_dtype highest): every product as fp32 FFMAs on the CUDA
//   cores over the same stages (plain fp32 images), each thread owning
//   outputs of the tile: the plain fp32 function up to the order of the sums.
//   Its sums are ordered for accuracy, since it is the verification route:
//   the dW products' point axis in two levels (32-point stages, then the
//   stages), db as compensated sums, and the transmittance from the
//   exclusive prefix (composite_forward).
// The six dW products take their own route (dw_route: the JAX dw_precision
// pin "highest" runs them as kFp32 under any route).
//
// Bound (float32 route): at the baseline widths (x_dim 90, 8x256 trunk) the
// forward is 2*(90*256 + 7*256^2 + 4*256) = 0.97 MFLOP per point, the
// backward chain 2*(4*256 + 7*256^2) = 0.92 MFLOP and the dW products 0.97
// MFLOP: 2.85 MFLOP per point, 93 GFLOP for a 512-ray x 64-sample step (the
// render VJP adds dx, 2*256*90 = 0.05 MFLOP per point), against ~5 MB of
// inputs and outputs (~35 MB with a 128-wide x and dx): bound by operations.
// As 3xTF32 each product is three TF32 products: 3*93 GFLOP at the 495
// TFLOP/s TF32 peak of an H100 SXM is 0.57 ms, a rate only wgmma reaches.
// The bfloat16 route does one bf16 product per product: 93 GFLOP at 989
// TFLOP/s, 0.094 ms; the highest route does them at the 67 TFLOP/s fp32
// CUDA-core rate, 1.39 ms. The activations and cotangents the design keeps
// in global scratch between launches are ~1.1 GB of traffic per such step
// (written once, read by the backward's gates and twice by the dW tiles),
// ~0.35 ms at 3.35 TB/s, partly from L2: they, not the products, bound the
// bfloat16 route.
//
// Design: the TPU kernels stash every layer's activations of a ray tile in
// VMEM, ~640 KB per 64-sample ray at 256 wide, far beyond an SM's 227 KB. So
// a call is split into grid launches on one stream, with the activations and
// cotangents in a global scratch buffer that the caller allocates once and
// grows. Both hold images: per block of 32 points, every row (feature) as 32
// contiguous fp32 values (128 bytes), the rows one after the other, the
// 16-byte chunks of row r swizzled to chunk c ^ (r % 8), which is wgmma's
// 128-byte K-major swizzle with the points on K; so a dW stage of 128 rows
// is one contiguous 16 KB bulk copy.
//   1. weight_image: the weights' stage images, in the order the trunk
//      kernels stream them: w0 and each wh[l] for the forward, wh[l]^T (the
//      backward chain's, l from the last layer down). A stage is KS input
//      rows of a layer (16 on the float32 route, 32 on the others) for all
//      H output rows, K-major (output row n holds its KS input rows): the
//      float32 route's [hi | lo] TF32 halves and the bfloat16 route's
//      rounding are rows of 64 bytes in the 64-byte swizzle (chunk c of row
//      n at c ^ ((n / 2) % 4)), the TF32 k-slots of each group of 8 ordered
//      2j, then 2j+1 (slot j < 4 holds input row 2j, slot j >= 4 row
//      2(j-4)+1) so that a thread's two A-fragment columns t and t+4 are
//      adjacent in the activation tile; the highest route's are the KS fp32
//      rows as they are. With dx, w0's own image row-major for render_dx.
//   2. trunk (forward): persistent CTAs of 384 threads, one per SM, walk
//      tiles of 64 points of the flattened R*S axis (the last ragged).
//      Warpgroup 2 is the producer: one thread streams every layer's stage
//      images, tile after tile, by TMA bulk copies (cp.async.bulk) into a
//      128 KB ring of stages guarded by full/empty mbarriers (4 stages on
//      the float32 and highest routes at H 256, 8 on bfloat16; twice as
//      many at H 128), and the warpgroup hands its registers to the
//      consumers (setmaxnreg 40 / 232). Warps 0-7 are two consumer
//      warpgroups; both take all 64 points, warpgroup g the output columns
//      [g*H/2, (g+1)*H/2). The activation tile (64 points x H, point-major
//      fp32, row stride H + 8) stays in shared memory: per k-step each
//      thread loads its A fragment (rows 16w+lane/4 and +8, two adjacent
//      columns), splits it into TF32 halves (or rounds it to bf16) and
//      issues wgmma m64n(H/2)k8 (k16) with A from registers and B by
//      descriptor from the stage (on the float32 route two 16-row stages
//      make one chain); the next chain's fragments are loaded while the
//      chain runs, and its sum is promoted when it is done. The highest
//      route's FFMA threads own 8 columns of 4 or 8 points each instead,
//      fed by 16-byte loads of both operands. Layer 0's input x is built point-major (the PE phases, point
//      features or the pre-encoded x) into the tile, or, when wider than H
//      (any width), in 32-column slices through two small buffers,
//      the next slice while the current chain runs; x goes to the act image
//      as A_0 as it is built. Each layer's epilogue writes relu(acc + b)
//      over the tile in place, to the act image (A_i), and the thread's
//      [A_i > 0] as a bit mask (one bit per accumulator register, H/4 bits a
//      thread); the head (exact fp32) writes the four raw outputs ([4][Np]);
//   3. train_composite (objective) or render_composite (VJP): one warp per
//      ray, its state (9*S floats) in dynamic shared memory while it fits a
//      block (S <= 6456; past 48 KB by opt-in), else in the ray's slice of
//      the scratch, the same loop in the same order either way: sigmoid,
//      log-space compositing with an fp32 shuffle prefix scan,
//      the ray's loss partial (objective), then the suffix sum s_after as an
//      fp32 shuffle scan run from the last sample (never a difference of
//      prefix sums, which cancels when om ~ 1e-10), and the head cotangent;
//   4. trunk (backward): the same kernel and ring over the wh^T images: the
//      seed delta_L = (g_out.wout[:, :4]^T) * [A_L > 0] in exact fp32 in the
//      accumulators' own layout, then each gated product delta_i =
//      (delta_{i+1}.wh[i-1]^T) * [A_i > 0], the gate read as the forward's
//      bit mask of the same thread (the same tile, columns and fragments),
//      one coalesced load per layer. Each delta_i goes to the gbuf image,
//      and g_out beside them (for the head's dW);
//   5. train_dw: every dW_l = A_l^T.delta_l and db_l = sum delta_l as
//      launches of 128x128 output tiles (rows k, columns j; at most
//      kMaxJobs products a launch, so one launch up to 15 layers), the point axis
//      split in P fixed parts, each written to its own partial. A CTA of 384
//      threads: the producer streams, per 32-point block, the tile's 128 A
//      rows and 128 delta rows (two bulk copies out of the images) into a
//      ring of 32 KB stages (three on the float32 route, four on the
//      others); the consumers convert both operands' rows once per stage
//      into wgmma images (TF32 halves in the 128-byte swizzle, or bf16 in
//      the 64-byte one; fence.proxy.async before the tensor cores read
//      them), and warpgroup g runs wgmma m64n128 with A (rows [64g, +64))
//      and B both by descriptor; db from the same fp32 delta rows. The next
//      stage is converted while the current chain runs;
//   6. train_finalize: the P partials of each gradient are summed in a fixed
//      order;
//   7. objective: loss_sum, the per-ray losses summed in a fixed order by
//      one CTA; render VJP (when dx is asked for): render_dx, dx =
//      delta_1.w0^T as 64x64 output tiles (mma.sync m16n8k8, cp.async
//      stages; not redesigned).
// Shared memory per CTA at H 256 (of 227 KB): trunk 128 KB ring + 66 KB
// activation tile + 20 KB layer-0 slices + 4 KB head columns = 219 KB; dW
// 96 KB ring + two 64 KB images of both operands' TF32 halves = 225 KB (128
// KB + 2 x 16 KB at bfloat16; 128 KB at highest).
// Widths 384 and 512: the tile is 98 and 130 KB, and one 64-point tile's
// running sums and stage products (64 x H x 2 fp32) would take 75 % and all
// of an SM's 64 K registers, so no split of the columns over warpgroups
// holds them. A layer of the trunk (forward or backward chain) runs instead
// in H/128 column passes of 128 columns, 64 a warpgroup: the accumulators
// of H 128 (32 + 32 registers a thread, one mask word a thread and pass).
// Each pass streams its own stage images (the pass's 128 output rows: 16
// KB on every route) through a 96 KB (H 384: 6 stages, 12 at bfloat16) or
// 64 KB (H 512: 4, or 8) ring, 226 and 228 KB a block. Every pass reads the
// whole layer input from the tile, so a finished pass writes its outputs
// (and masks) to the act or gbuf image only; once the last pass has read
// the tile, each thread copies its own earlier outputs back from the image
// into the tile (L2-resident, same-thread reads). A column's sums are the
// one-pass design's, in the same order; H 128 and 256 are one pass, as
// before. The dW tiles (128 x 128), the composites and render_dx (K = H in
// 32-column stages) take any multiple of 128.
// Every wider H (any multiple of 128) runs one width-generic build (H read
// at run time, template width kAnyH): the tile would not fit beside a ring
// of four stages (162 KB at H 640, 260 KB at H 1024), so none is held. x
// and every layer's output go to the act or gbuf image only (where the dW
// products and render_dx read them in any case), and the producer copies
// each stage's input rows, the stage's KS rows of the tile's two 32-point
// image blocks (two contiguous bulk copies of KS x 128 bytes), into the
// ring slot beside the stage's weights, on the same full / empty
// mbarriers, once the layer that wrote them is done (a `ready` mbarrier:
// each consumer warp arrives after fence.proxy.async, which orders its
// generic stores before the copies' reads). The consumers read their A
// fragments from the slot's blocks (the image's swizzle puts a warp's 32
// reads of one row on 32 banks); the head reads A_L from the act image
// and wout from global memory. Shared memory is a 200 KB (float32) or 216
// KB ring and the mbarriers, at every width; each pass reads the layer
// input again from L2 (2 H^2 bytes a layer and tile beside 8 H^2 of
// weight halves). The fragments and the k order are the column passes': a
// column's sums are theirs.
// Fragments (wgmma m64nNk8 .tf32, warp w of the warpgroup, g = lane/4,
// t = lane%4): A a0 (16w+g, t), a1 (16w+g+8, t), a2 (16w+g, t+4),
// a3 (16w+g+8, t+4); D d[4j+e] at row 16w+g (+8 for e >= 2), column
// 8j+2t (+1 for odd e). wgmma m64nNk16 .bf16 packs two columns a register,
// the lower in the low half: a0 (16w+g, 2t..2t+1), a1 (16w+g+8, 2t..2t+1),
// a2 (16w+g, 2t+8..2t+9), a3 (16w+g+8, 2t+8..2t+9); D as tf32.
// No atomic operations on the device: two runs of a call agree bit for bit.
// The launchers return cudaGetLastError() (or the first failing call), and
// the Python wrappers raise when it is not cudaSuccess.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <vector>

namespace {

constexpr int kTileP = 64;             // points per trunk tile (wgmma's M)
constexpr int kConsumers = 256;        // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kRingBytes = 128 * 1024;  // the trunk's ring of weight stages (H <= 256)
constexpr int kPassCols = 128;          // columns per pass of a layer wider than 256
constexpr int kActPad = 8;             // activation row stride H + 8 (8 mod 32)
constexpr int kXK = 32;                // layer-0 input columns per slice
constexpr int kXLd = kXK + kActPad;    // row stride of a slice buffer (8 mod 32)
constexpr int kBlk = 32;               // points per image block (a 128-byte row)
constexpr int kProducerRegs = 40;      // setmaxnreg: the producer warpgroup gives registers
constexpr int kConsumerRegs = 232;     // to the consumer warpgroups
constexpr int kOutPad = 128;           // packed head columns [r, g, b, sigma, 0...]
constexpr int kHead = 4;               // live head columns
constexpr float kFar = 1e10f;
constexpr float kEps = 1e-10f;
// Precision routes (render/kernels.py ROUTES)
constexpr int kTf32x3 = 0;  // compute_dtype float32
constexpr int kBf16 = 1;    // compute_dtype bfloat16
constexpr int kFp32 = 2;    // compute_dtype highest
constexpr int kFwd = 0;     // trunk passes
constexpr int kBwd = 1;
constexpr int kAnyH = 0;    // the width-generic build's template width (H read at run time)
constexpr int kMaxFixedH = 512;  // the widest trunk with a build of its own
constexpr int kStreamRing = 216 * 1024;  // the generic build's ring: weight stages and input slices
constexpr int kDwT = 128;                     // dW output tile edge (rows k and columns j)
constexpr int kDwSlot = 2 * kDwT * kBlk * 4;  // a dW stage: 128 A rows, 128 delta rows
constexpr int kDxThreads = 256;       // render_dx: 8 warps
constexpr int kDxP = 64;              // dx tile: points
constexpr int kDxK = 64;              // dx tile: input columns
constexpr int kDxJ = 32;              // dx reduction stage (trunk columns)
constexpr int kDxLdD = kDxP + 8;      // delta_1 stage row stride (8 mod 32)
constexpr int kDxLdW = kDxJ + 4;      // w0 stage row stride (4 mod 32)
constexpr int kDxStage = kDxJ * kDxLdD + 2 * kDxK * kDxLdW;
constexpr int kSmemDefault = 48 * 1024;  // dynamic shared memory without opting in
constexpr int kSmemOptIn = 232448;       // a block's most, opted in (227 KB)
constexpr int kCompFloats = 9;           // the composite's state: floats per sample
constexpr int kDxSmem = static_cast<int>(sizeof(float)) * 2 * kDxStage;
constexpr int kMaxParts = 8;     // split of the point axis in the dW products
constexpr int kPartRows = 4096;  // points per part before a further split
constexpr int kMaxJobs = 16;     // dW products in one launch (layers + head), by value
constexpr int kMaxGridY = 65535;  // a launch's grid rows
constexpr int kMaskWords = 2;    // mask words a thread keeps per layer at H 256 (H/128)
static_assert(kDxJ % 16 == 0, "render_dx promotes its products every two k-steps");

size_t round_up(size_t a, size_t b) { return (a + b - 1) / b * b; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A route's trunk stages at width H. H == kAnyH: the width-generic build
// (STREAM), any H % 128 == 0 above kMaxFixedH, the column passes of the
// fixed widths above 256 with NPASS = H / 128 at run time (NPASS reads 0).
template <int H, int ROUTE>
struct Trunk {
  static constexpr bool STREAM = H == kAnyH;  // every layer's input copied into the ring
  static constexpr int NPASS = STREAM ? 0 : (H > 256 ? H / kPassCols : 1);  // column passes of a layer
  static constexpr int PW = STREAM ? kPassCols : H / NPASS;  // columns per pass
  static constexpr int NW = PW / 2;     // output columns per consumer warpgroup and pass
  static constexpr int NR = NW / 2;     // accumulator registers per thread
  static constexpr int MW = NR / 32;    // mask words per thread, layer and pass
  static constexpr int PR = NR / 8;     // FFMA route: points per thread (8 columns each)
  static constexpr int PL = kTileP / PR;  // and threads per column group
  static constexpr int KS = ROUTE == kTf32x3 ? 16 : 32;  // input rows per stage
  // a pass's stage image: [hi | lo] TF32 halves, the bf16 rounding, or the fp32 rows
  static constexpr int kStageBytes =
      ROUTE == kTf32x3 ? 2 * PW * KS * 4 : (ROUTE == kBf16 ? PW * KS * 2 : PW * KS * 4);
  // (STREAM) a stage's input slice: its KS rows of the tile's two 32-point
  // image blocks, as they lie in the act or gbuf image
  static constexpr int kSliceBytes = STREAM ? 2 * KS * kBlk * 4 : 0;
  static constexpr int kSlotBytes = kStageBytes + kSliceBytes;  // a ring slot
  static constexpr int kRing = STREAM ? kStreamRing / kSlotBytes * kSlotBytes
                               : (H <= 256 ? kRingBytes : (H == 384 ? 96 * 1024 : 64 * 1024));
  static constexpr int NS = kRing / kSlotBytes;  // ring depth
  // row strides of the activation tile and the layer-0 slices: 8 mod 32
  // words for the fragments' 8-byte loads, 4 mod 32 for the FFMA route's
  // 16-byte loads of 8 consecutive points
  static constexpr int LD = H + (ROUTE == kFp32 ? 4 : kActPad);
  static constexpr int XLD = ROUTE == kFp32 ? kXK + 4 : kXLd;
  static_assert(NS >= 4 && MW <= kMaskWords, "a ring of four stages or more");
};

// Full-width stages of the forward and the backward chain at width H; each
// is H / PW pass images.
template <int H0, int ROUTE>
int fwd_stages(int D, int H, int L1) {
  using T = Trunk<H0, ROUTE>;
  return cdiv(D, T::KS) + L1 * (H / T::KS);
}
template <int H0, int ROUTE>
int bwd_stages(int H, int L1) {
  return L1 * (H / Trunk<H0, ROUTE>::KS);
}

// The composite's per-ray state of S samples, in bytes: dynamic shared
// memory while it fits a block, else the scratch's ray state.
size_t comp_bytes(int S) { return sizeof(float) * kCompFloats * static_cast<size_t>(S); }
bool comp_in_smem(int S) { return comp_bytes(S) <= static_cast<size_t>(kSmemOptIn); }

// Sizes shared by the launchers and nerf_train_scratch_floats.
struct Layout {
  int N, Np, tiles, nblk, L, P, chunk_blk, act_rows, g_rows;
  size_t F;  // floats of the six packed gradients, flattened
  size_t act, gbuf, gout, out4, loss_r, mask, img, w0x, ray, part, total;  // scratch offsets
};

Layout make_layout(int R, int S, int D, int H, int L1) {
  Layout s;
  s.N = R * S;
  s.tiles = cdiv(s.N, kTileP);
  s.Np = s.tiles * kTileP;
  s.nblk = s.Np / kBlk;
  s.L = L1 + 1;
  int P = s.N / kPartRows;
  s.P = P < 1 ? 1 : (P > kMaxParts ? kMaxParts : P);
  s.chunk_blk = cdiv(s.nblk, s.P);
  s.act_rows = D + s.L * H;  // A_0 = x, then A_1 .. A_L
  s.g_rows = s.L * H + 8;    // delta_1 .. delta_L, then g_out's 4 rows
  s.F = static_cast<size_t>(D) * H + H + static_cast<size_t>(L1) * H * H +
        static_cast<size_t>(L1) * H + static_cast<size_t>(H) * kOutPad + kOutPad;
  const size_t np = s.Np, h = H, d = D, l1 = L1;
  // the stage images of the largest route: the float32 route's halves, or
  // the highest route's 32-row stages when D is not a multiple of 32
  const size_t img = 2 * h * (d + 2 * l1 * h);
  const size_t img32 = h * (round_up(d, 32) + 2 * l1 * h);
  size_t off = 0;
  auto take = [&](size_t floats) {
    const size_t at = off;
    off += round_up(floats, 256);  // 1 KB aligned
    return at;
  };
  s.act = take(static_cast<size_t>(s.act_rows) * np);
  s.gbuf = take(static_cast<size_t>(s.g_rows) * np);
  s.gout = take(kHead * np);
  s.out4 = take(kHead * np);
  s.loss_r = take(R);
  s.mask = take(static_cast<size_t>(s.tiles) * s.L * kConsumers *
                (H / 128 > kMaskWords ? H / 128 : kMaskWords));
  s.img = take(img > img32 ? img : img32);
  s.w0x = take(2 * d * h);  // w0's image row-major for render_dx: hi, lo
  // the composite's ray state, when it does not fit a block's shared memory
  s.ray = take(comp_in_smem(S) ? 0 : static_cast<size_t>(R) * kCompFloats * S);
  s.part = off;
  off += static_cast<size_t>(s.P) * round_up(s.F, 64);
  s.total = off;
  return s;
}

// ---- number formats ----

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

// ---- mma.sync primitives (render_dx) ----

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
// 3xTF32, JG n-tiles at a time, the small terms first (a_lo.b_hi,
// a_hi.b_lo, a_hi.b_hi). bfrag(j, hi, lo) loads the B fragment of n-tile j.
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

// The products of every two k-steps accumulate in their own block, added
// to the running sum with round-to-nearest FADDs (the tensor cores round
// their accumulation toward zero), and zeroed.
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

// ---- Hopper primitives: mbarriers, bulk copies, wgmma ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the phase of the given parity; a pipeline stalled for ~2^26
// polls (seconds) traps, so that a fault fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, polls = 0;
  while (!done) {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16) global -> shared by the TMA unit; completion
// counted on the mbarrier's transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Orders this thread's generic writes to shared memory before later reads
// of it by the async proxy (wgmma's B operand).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The same for its writes to global memory before bulk copies read them.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Named barrier of the two consumer warpgroups (not the producer's).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of d across a wgmma fence or wait.
template <int NR>
__device__ __forceinline__ void fence_regs(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// leading offset unused; the start advances 32 bytes per k-step of 8.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// The same in the 64-byte swizzle (layout type 2): rows of 64 bytes, 8-row
// groups 512 bytes apart; the start advances 32 bytes per k-step (8 tf32 or
// 16 bf16).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (static_cast<uint64_t>(2) << 62);
}

// d (+)= a.b for a 64 x N tile and one k-step of 8: A (64 x 8) from
// registers, B (8 x N) by descriptor; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}


// d (+)= a.b for a 64 x N tile and one bf16 k-step of 16: A (64 x 16) from
// registers, B (16 x N, K-major, not transposed) by descriptor.
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d);
template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  wgmma_m64n64k16_bf16(d, a, desc_b, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  wgmma_m64n128k16_bf16(d, a, desc_b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d);
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  wgmma_m64n64k8(d, a, desc_b, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  wgmma_m64n128k8(d, a, desc_b, scale_d);
}

// d (+)= a.b for a 64 x 128 tile and one k-step, both operands by
// descriptor from shared memory (K-major): 8 tf32, or 16 bf16.
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Per-ray compositing state of one warp (kCompFloats*S floats): weights,
// transmittances, om, alpha, dists, raw sigma, sigmoid rgb. In dynamic
// shared memory, or (gstate, when S samples do not fit a block) in the
// ray's slice of the scratch; each lane reads back only what it wrote.
struct RaySmem {
  float *w, *T, *om, *alpha, *dist, *sig, *rgb;
};

__device__ __forceinline__ RaySmem ray_smem(float* smem, float* gstate, int S) {
  float* base = gstate == nullptr
                    ? smem
                    : gstate + static_cast<size_t>(blockIdx.x) * kCompFloats * S;
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
                       float* __restrict__ loss_r, float* __restrict__ gstate, int S, int Np,
                       int white_bkgd, float rgb_c, float reg_c, float depth_c) {
  extern __shared__ float4 csm4[];
  const RaySmem m = ray_smem(reinterpret_cast<float*>(csm4), gstate, S);
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
                        const float* __restrict__ g_weights, float* __restrict__ gout,
                        float* __restrict__ gstate, int S, int Np, int white_bkgd) {
  extern __shared__ float4 csm4[];
  const RaySmem m = ray_smem(reinterpret_cast<float*>(csm4), gstate, S);
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


// Offset of (row, point n) in an image of `rows` rows per 32-point block:
// block n / 32 holds its rows one after the other, 32 points each, the
// 16-byte chunks of row r swizzled to chunk c ^ (r % 8).
__device__ __forceinline__ size_t img_at(int rows, int row, int n) {
  const int q = n & (kBlk - 1);
  return (static_cast<size_t>(n >> 5) * rows + row) * kBlk + ((((q >> 2) ^ (row & 7))) << 2) +
         (q & 3);
}

// ---- launch 1: the weights' images ----

// w0's image row-major (render_dx's): the float32 route's TF32 halves; the
// bfloat16 route's bf16 roundings and the highest route's fp32 values in
// the hi half.
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

// Stage y0 + blockIdx.y of the images (the forward's w0 and wh[l] stages, then
// the backward's wh[l]^T, l from L1 - 1 down), output rows [32*blockIdx.x,
// +32), through a KS x 32 tile in shared memory, into the image of the pass
// that owns the rows (per layer, the passes one after the other, each over
// the layer's stages: the consumers' order); the blocks past the stages
// write w0's row-major image, 32 rows each. Hr: the width of the generic
// build (H0 == kAnyH).
template <int H0, int ROUTE>
__global__ void __launch_bounds__(256)
weight_image_kernel(const float* __restrict__ w0, const float* __restrict__ wh,
                    uint8_t* __restrict__ images, float* __restrict__ w0hi,
                    float* __restrict__ w0lo, int D, int L1, int n_fwd, int n_stages, int y0,
                    int Hr) {
  using T = Trunk<H0, ROUTE>;
  const int H = T::STREAM ? Hr : H0;
  const int npass = T::STREAM ? H / kPassCols : T::NPASS;
  constexpr int KS = T::KS;
  __shared__ float tile[KS][33];
  const int nb = blockIdx.x * 32;
  const int tid = threadIdx.x;
  const int st = y0 + blockIdx.y;
  if (st >= n_stages) {
    const int r0 = (st - n_stages) * 32;
    for (int e = tid; e < 32 * 32; e += 256) {
      const int r = r0 + e / 32;
      if (r < D) {
        const size_t i = static_cast<size_t>(r) * H + nb + e % 32;
        weight_image<ROUTE>(w0[i], w0hi, w0lo, i);
      }
    }
    return;
  }
  const int s0 = cdiv(D, KS), per = H / KS;
  const int pass = nb / T::PW, np = nb - pass * T::PW;  // the pass, its first row
  int image;
  if (st < s0)
    image = pass * s0 + st;
  else if (st < n_fwd)
    image = npass * s0 + ((st - s0) / per * npass + pass) * per + (st - s0) % per;
  else
    image = npass * n_fwd + ((st - n_fwd) / per * npass + pass) * per + (st - n_fwd) % per;
  // tile[r][c]: the stage's input row k0 + r, output row nb + c (zero past K)
  if (st < n_fwd) {
    const float* W = st < s0 ? w0 : wh + static_cast<size_t>((st - s0) / per) * H * H;
    const int k0 = (st < s0 ? st : (st - s0) % per) * KS;
    const int K = st < s0 ? D : H;
    for (int e = tid; e < KS * 32; e += 256) {
      const int r = e / 32, c = e % 32;
      tile[r][c] = k0 + r < K ? W[static_cast<size_t>(k0 + r) * H + nb + c] : 0.f;
    }
  } else {  // wh[l]^T: input row j of the chain is column j of wh[l]
    const int b = st - n_fwd;
    const float* W = wh + static_cast<size_t>(L1 - 1 - b / per) * H * H;
    const int k0 = (b % per) * KS;
    for (int e = tid; e < KS * 32; e += 256) {
      const int r = e % KS, c = e / KS;
      tile[r][c] = W[static_cast<size_t>(nb + c) * H + k0 + r];
    }
  }
  __syncthreads();
  uint8_t* img = images + static_cast<size_t>(image) * T::kStageBytes;
  if constexpr (ROUTE == kFp32) {  // the KS rows as they are, [KS][PW]
    float* o = reinterpret_cast<float*>(img);
    for (int e = tid; e < KS * 32; e += 256) {
      const int r = e / 32, c = e % 32;
      o[r * T::PW + np + c] = tile[r][c];
    }
  } else if constexpr (ROUTE == kBf16) {  // row n's k-slot kk, 64-byte swizzle
    uint16_t* o = reinterpret_cast<uint16_t*>(img);
    for (int e = tid; e < KS * 32; e += 256) {
      const int kk = e % KS, n = np + e / KS;
      o[n * KS + ((((kk >> 3) ^ ((n >> 1) & 3))) << 3) + (kk & 7)] =
          static_cast<uint16_t>(pack_bf16(0.f, tile[kk][n - np]) >> 16);
    }
  } else {  // row n's k-slot s holds input row 8*(s/8) + (j < 4 ? 2j : 2j - 7), j = s % 8
    float* o = reinterpret_cast<float*>(img);
    for (int e = tid; e < KS * 32; e += 256) {
      const int s = e % KS, n = np + e / KS;
      const int j = s & 7;
      const int r = (s & ~7) + (j < 4 ? 2 * j : 2 * j - 7);
      uint32_t hi, lo;
      split_tf32(tile[r][n - np], hi, lo);
      const int pos = n * KS + ((((s >> 2) ^ ((n >> 1) & 3))) << 2) + (s & 3);
      o[pos] = __uint_as_float(hi);
      o[T::PW * KS + pos] = __uint_as_float(lo);
    }
  }
}

// ---- launches 2 and 4: the trunk, forward and backward ----

// What the trunk kernel reads and writes; the forward uses the input, the
// biases, act, out4 and writes the masks, the backward reads gout and the
// masks and writes gbuf.
struct TrunkArgs {
  const float *in, *feats, *e2, *c;  // layer 0's input (inline PE: raw and feats)
  const float *b0, *bh, *wout, *bout;
  const uint8_t* images;  // this pass's weight stages, in order
  float* act;             // A_0 .. A_L images, act_rows rows a block
  float* out4;            // the 4 raw head outputs, [4][Np]
  const float* gout;      // the head cotangent, [4][Np]
  float* gbuf;            // delta_1 .. delta_L and g_out images, g_rows rows a block
  uint32_t* mask;         // [A_i > 0], per tile, layer and thread
  int N, Np, tiles, stages, n_raw, n_phase, Fd, D, H, L1, act_rows, g_rows, head_bf16;
};

// Dynamic shared memory: the stage ring (1024-byte aligned), the activation
// tile, two layer-0 input slices, wout's live columns, the mbarriers; the
// generic build holds the ring of weight stages and input slices and the
// mbarriers alone, the same at every width.
template <int H, int ROUTE>
constexpr size_t trunk_smem() {
  using T = Trunk<H, ROUTE>;
  if (T::STREAM) return 1024 + T::kRing + (2 * T::NS + 1) * sizeof(uint64_t);
  return 1024 + T::kRing +
         sizeof(float) * (static_cast<size_t>(kTileP) * (H + kActPad + 2 * kXLd) + H * kHead) +
         2 * T::NS * sizeof(uint64_t);
}
template <int H>
constexpr bool trunk_fits() {
  return trunk_smem<H, kTf32x3>() <= 232448 && trunk_smem<H, kBf16>() <= 232448 &&
         trunk_smem<H, kFp32>() <= 232448;
}
static_assert(trunk_fits<128>() && trunk_fits<256>() && trunk_fits<384>() && trunk_fits<512>() &&
                  trunk_fits<kAnyH>(),
              "the trunk's shared memory fits a block");

// The two consumer warpgroups of a trunk pass. The generic build (H0 ==
// kAnyH, width a.H) holds no tile: x and each layer's output go to their
// image only, and the producer copies each stage's input rows (x or A_l of
// the forward, delta_{l+2} of the chain) from the image into the ring slot
// beside the stage's weights, once that layer is written (`ready`: every
// consumer warp arrives after a proxy fence). The consumers read their A
// fragments from the slot's two 32-point blocks (rows of 32 points, the
// image's swizzle: one bank per lane); the head reads A_L from the act
// image and wout's columns from global memory. The same fragments in the
// same k order: a column's sums are the column-pass design's.
template <int H0, int MODE, bool INLINE_PE, bool STAGED, int ROUTE>
__device__ __forceinline__ void trunk_consumer(const TrunkArgs& a, uint32_t ring,
                                               const uint8_t* ring_ptr, float* __restrict__ act_sm,
                                               float* __restrict__ xbuf, float* __restrict__ whead,
                                               uint32_t full0, uint32_t empty0, uint32_t ready) {
  using T = Trunk<H0, ROUTE>;
  const int H = T::STREAM ? a.H : H0;
  const int npass = T::STREAM ? H / kPassCols : T::NPASS;
  constexpr int KS = T::KS;
  constexpr int ld = T::LD;
  constexpr int xld = T::XLD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;            // warpgroup: pass columns [wg*NW, +NW)
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;  // fragment rows r0, r0 + 8
  const int cw = wg * T::NW;           // in a pass's images
  int c0 = cw;                         // in the layer: the pass's, pass * PW + cw
  // The FFMA route's threads own PR points x 8 columns each (points pl +
  // PL*p, columns c0 + 8*cgi + {0..7}): a warp's lanes take consecutive
  // points, so its image stores are as coalesced as a fragment's, and a
  // point's 4 inputs or a row's 8 weights are 16-byte loads. The wgmma
  // routes' threads own their fragments' (points r0 + 8p). pt_of and
  // col_of give accumulator i's point (its p = pidx(i)) and column; the
  // epilogues, the masks and the backward seed all go through them.
  constexpr int NP = ROUTE == kFp32 ? T::PR : 2;  // points a thread owns
  const int pl = (tid & 127) % T::PL, cgi = (tid & 127) / T::PL;
  auto pidx = [](int i) { return ROUTE == kFp32 ? i >> 3 : (i >> 1) & 1; };
  auto pt_at = [&](int p) { return ROUTE == kFp32 ? pl + T::PL * p : r0 + 8 * p; };
  auto pt_of = [&](int i) { return pt_at(pidx(i)); };
  auto col_of = [&](int i) {
    return ROUTE == kFp32 ? c0 + 8 * cgi + (i & 7) : c0 + 8 * (i >> 2) + 2 * t + (i & 1);
  };
  const int L = a.L1 + 1;
  const bool hb = a.head_bf16 != 0;
  float acc[T::NR], part[T::NR];
#pragma unroll
  for (int i = 0; i < T::NR; ++i) part[i] = 0.f;
  int it = 0;
  // the head's four live columns, once per CTA (rounded to bf16 with
  // head_bf16); the generic build reads them from global memory
  for (int e = tid; e < H0 * kHead; e += kConsumers) {
    const float w = __ldg(a.wout + (e / kHead) * kOutPad + e % kHead);
    whead[e] = hb ? round_bf16(w) : w;
  }
  consumers_sync();
  // (generic build) the layer's image is written: the producer may copy it
  auto images_ready = [&]() {
    fence_proxy_async_global();
    __syncwarp();
    if (lane == 0) mbar_arrive(ready);
  };
  auto head_w = [&](int k, int o) {
    if constexpr (T::STREAM) {
      const float w = __ldg(a.wout + k * kOutPad + o);
      return hb ? round_bf16(w) : w;
    } else {
      return whead[k * kHead + o];
    }
  };

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int n0 = tile * kTileP;
    // the thread's mask words of layer output A_{layer+1}, pass `pass`
    auto mask_at = [&](int layer, int pass) {
      return a.mask + (static_cast<size_t>(tile) * L + layer) * npass * T::MW * kConsumers +
             pass * T::MW * kConsumers + tid;
    };
    // columns [32*sl, +32) of layer 0's input to dst[p*ldd + j] (point-major)
    // and to the act image (A_0); a warp takes 32 points of one column
    auto build_x = [&](int sl, float* dst, int ldd) {
      for (int idx = tid; idx < kTileP * kXK; idx += kConsumers) {
        const int j = idx / kTileP, p = idx % kTileP;
        const int k = sl * kXK + j;
        const int n = n0 + p;
        float v = 0.f;
        if (n < a.N && k < a.D) {
          if (INLINE_PE) {
            const float* r = a.in + static_cast<size_t>(n) * a.n_raw;
            if (k < a.n_raw) {
              v = r[k];
            } else if (k < a.n_raw + a.n_phase) {
              const int col = k - a.n_raw;
              float ph = a.c[col];
              for (int d = 0; d < a.n_raw; ++d)
                ph = __fadd_rn(ph, __fmul_rn(r[d], a.e2[d * a.n_phase + col]));
              v = sinf(ph);
            } else if (k < a.n_raw + a.n_phase + a.Fd) {
              v = a.feats[static_cast<size_t>(n) * a.Fd + (k - a.n_raw - a.n_phase)];
            }
          } else {
            v = a.in[static_cast<size_t>(n) * a.D + k];
          }
        }
        if (!T::STREAM) dst[p * ldd + j] = v;
        if (k < a.D) a.act[img_at(a.act_rows, k, n)] = v;
      }
    };
    auto xslice = [&](int sl) { return xbuf + (sl & 1) * kTileP * kXLd; };  // kXLd: the widest

    // acc = the layer's products over K input rows: the tile's (from_tile)
    // or, a STAGED layer 0, x's slices; the stages come from the ring in
    // the producer's order
    auto products = [&](int K, bool from_tile) {
      const int nst = cdiv(K, KS);
      const int it0 = it;  // the ring position of stage 0
#pragma unroll
      for (int i = 0; i < T::NR; ++i) acc[i] = 0.f;
      const int sld = from_tile ? ld : xld;
      // stage st's input rows: the tile's or a STAGED layer 0's slice
      // (point-major), or (the generic build) the ring slot's, once landed
      auto src_of = [&](int st) -> const float* {
        if constexpr (T::STREAM) {
          const int i = it0 + st;
          mbar_wait(full0 + 8 * (i % T::NS), (i / T::NS) & 1);
          return reinterpret_cast<const float*>(ring_ptr + (i % T::NS) * T::kSlotBytes +
                                                T::kStageBytes);
        } else {
          return from_tile ? act_sm + st * KS : xslice(st * KS / kXK) + (st * KS) % kXK;
        }
      };
      // input (point pt, row k) of a stage's rows at src: point-major, or
      // (the generic build) in the slot's blocks of 32 points per row, the
      // 16-byte chunks of row k swizzled to chunk c ^ (k % 8), as the image
      auto in_at = [&](const float* src, int pt, int k) {
        if constexpr (T::STREAM)
          return src[(pt >> 5) * (KS * kBlk) + k * kBlk + (((((pt & 31) >> 2) ^ (k & 7))) << 2) +
                     (pt & 3)];
        else
          return src[pt * sld + k];
      };
      // inputs k, k + 1 of point pt (adjacent in a point-major row)
      auto pair_at = [&](const float* src, int pt, int k) {
        if constexpr (T::STREAM)
          return make_float2(in_at(src, pt, k), in_at(src, pt, k + 1));
        else
          return *reinterpret_cast<const float2*>(src + pt * sld + k);
      };
      // before stage st: a STAGED layer 0 builds the slice that st starts
      auto next_slice = [&](int st) {
        if (!T::STREAM && !from_tile && (st * KS) % kXK == 0) {
          build_x(st * KS / kXK, xslice(st * KS / kXK), xld);
          consumers_sync();
        }
      };
      if constexpr (ROUTE == kFp32) {
        // FFMAs over the stage's fp32 rows, four at a time (K is a multiple
        // of 16): each point's 4 inputs and each row's 8 weights in 16-byte
        // loads
        for (int st = 0; st < nst; ++st) {
          const int s = it % T::NS;
          const int rows = K - st * KS >= KS ? KS : 16;
          mbar_wait(full0 + 8 * s, (it / T::NS) & 1);
          const float* w =
              reinterpret_cast<const float*>(ring_ptr + s * T::kSlotBytes) + cw + 8 * cgi;
          const float* src = src_of(st);
#pragma unroll 1
          for (int k4 = 0; k4 < rows; k4 += 4) {
            float4 av[T::PR];
#pragma unroll
            for (int p = 0; p < T::PR; ++p) {
              if constexpr (T::STREAM) {
                const int pt = pl + T::PL * p;
                av[p] = make_float4(in_at(src, pt, k4), in_at(src, pt, k4 + 1),
                                    in_at(src, pt, k4 + 2), in_at(src, pt, k4 + 3));
              } else {
                av[p] = *reinterpret_cast<const float4*>(src + (pl + T::PL * p) * sld + k4);
              }
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float4 b0 = *reinterpret_cast<const float4*>(w + (k4 + kk) * T::PW);
              const float4 b1 = *reinterpret_cast<const float4*>(w + (k4 + kk) * T::PW + 4);
              const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
              for (int p = 0; p < T::PR; ++p) {
                const float x = kk == 0 ? av[p].x : kk == 1 ? av[p].y : kk == 2 ? av[p].z : av[p].w;
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[8 * p + c] = fmaf(x, bv[c], acc[8 * p + c]);
              }
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage is free again
          if (st + 1 < nst) next_slice(st + 1);
          ++it;
        }
      } else if constexpr (ROUTE == kBf16) {
        // A fragments of stage st's two k-steps of 16, rounded to bf16
        auto load_a = [&](int st, uint32_t (&af)[2][4]) {
          const int live = K - st * KS >= KS ? 2 : 1;
          const float* src = src_of(st);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (q < live) {
              const int k = 16 * q + 2 * t;
              const float2 u = pair_at(src, r0, k);
              const float2 v = pair_at(src, r0, k + 8);
              const float2 w = pair_at(src, r0 + 8, k);
              const float2 x = pair_at(src, r0 + 8, k + 8);
              af[q][0] = pack_bf16(u.x, u.y);
              af[q][1] = pack_bf16(w.x, w.y);
              af[q][2] = pack_bf16(v.x, v.y);
              af[q][3] = pack_bf16(x.x, x.y);
            }
          }
        };
        auto stage = [&](int st, uint32_t (&af)[2][4], uint32_t (&nx)[2][4]) {
          const int s = it % T::NS;
          const int live = K - st * KS >= KS ? 2 : 1;
          mbar_wait(full0 + 8 * s, (it / T::NS) & 1);
          const uint32_t img = ring + s * T::kSlotBytes + cw * (KS * 2);
          fence_regs(part);
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (q < live) wgmma_bf16<T::NW>(part, af[q], sw64_desc(img + 32 * q), q > 0);
          wgmma_commit();
          if (st + 1 < nst) {
            next_slice(st + 1);
            load_a(st + 1, nx);
          }
          wgmma_wait_all();
          fence_regs(part);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage is free again
#pragma unroll
          for (int i = 0; i < T::NR; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
          ++it;
        };
        uint32_t f0[2][4], f1[2][4];
        load_a(0, f0);
        for (int st = 0; st < nst; st += 2) {
          stage(st, f0, f1);
          if (st + 1 < nst) stage(st + 1, f1, f0);
        }
      } else {
        // A fragments of stages st .. st + n - 1 (n <= 2: 32 input rows, four
        // k-steps of 8), split into TF32 halves: slots t and t+4 of a k-step
        // are its input rows 2t and 2t+1
        auto load_a = [&](int st, int n, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q < 2 * n) {
              const float* src = src_of(st + (q >> 1));
              const int k = 8 * (q & 1) + 2 * t;
              const float2 u = pair_at(src, r0, k);
              const float2 w = pair_at(src, r0 + 8, k);
              split_fast(u.x, hi[q][0], lo[q][0]);
              split_fast(w.x, hi[q][1], lo[q][1]);
              split_fast(u.y, hi[q][2], lo[q][2]);
              split_fast(w.y, hi[q][3], lo[q][3]);
            }
          }
        };
        // one chain of the stages st, st + 1 (12 wgmma, or 6 for a last odd
        // stage), promoted once, as kernel 2 promotes its 32-row stages; the
        // next two stages' fragments are read while the chain runs
        auto chain = [&](int st, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                         uint32_t (&nhi)[4][4], uint32_t (&nlo)[4][4]) {
          const int n = nst - st >= 2 ? 2 : 1;
          fence_regs(part);
          wgmma_fence();
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            if (g < n) {
              const int s = (it + g) % T::NS;
              mbar_wait(full0 + 8 * s, ((it + g) / T::NS) & 1);
              const uint32_t hi_img = ring + s * T::kSlotBytes + cw * (KS * 4);
              const uint32_t lo_img = hi_img + T::PW * KS * 4;
#pragma unroll
              for (int k = 0; k < 2; ++k) {
                const int q = 2 * g + k;
                wgmma_tf32<T::NW>(part, lo[q], sw64_desc(hi_img + 32 * k), q > 0);
                wgmma_tf32<T::NW>(part, hi[q], sw64_desc(lo_img + 32 * k), 1);
                wgmma_tf32<T::NW>(part, hi[q], sw64_desc(hi_img + 32 * k), 1);
              }
            }
          }
          wgmma_commit();
          if (st + n < nst) {
            next_slice(st + n);
            load_a(st + n, nst - st - n >= 2 ? 2 : 1, nhi, nlo);
          }
          wgmma_wait_all();
          fence_regs(part);
          __syncwarp();
          if (lane == 0)
            for (int g = 0; g < n; ++g) mbar_arrive(empty0 + 8 * ((it + g) % T::NS));
#pragma unroll
          for (int i = 0; i < T::NR; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
          it += n;
        };
        uint32_t h0[4][4], l0[4][4], h1[4][4], l1[4][4];
        load_a(0, nst >= 2 ? 2 : 1, h0, l0);
        for (int st = 0; st < nst; st += 4) {
          chain(st, h0, l0, h1, l1);
          if (st + 2 < nst) chain(st + 2, h1, l1, h0, l0);
        }
      }
    };

    // v (the thread's NR outputs of columns c0..) to an image and, to_tile,
    // over the tile in place (the generic build: to the image only)
    auto write_out = [&](const float (&v)[T::NR], float* img, int rows, int row0, bool to_tile) {
#pragma unroll
      for (int i = 0; i < T::NR; i += 2) {  // i, i + 1: one point, adjacent columns
        if (!T::STREAM && to_tile)
          *reinterpret_cast<float2*>(act_sm + pt_of(i) * ld + col_of(i)) =
              make_float2(v[i], v[i + 1]);
        img[img_at(rows, row0 + col_of(i), n0 + pt_of(i))] = v[i];
        img[img_at(rows, row0 + col_of(i) + 1, n0 + pt_of(i))] = v[i + 1];
      }
    };
    // the passes before the last: their outputs, written by this thread to
    // the image only, over the tile (once every warp is done reading it)
    auto restore = [&](const float* img, int rows, int row0) {
      if (T::STREAM) return;  // no tile
      for (int pass = 0; pass + 1 < T::NPASS; ++pass) {
        c0 = pass * T::PW + cw;
#pragma unroll
        for (int i = 0; i < T::NR; i += 2)
          *reinterpret_cast<float2*>(act_sm + pt_of(i) * ld + col_of(i)) =
              make_float2(img[img_at(rows, row0 + col_of(i), n0 + pt_of(i))],
                          img[img_at(rows, row0 + col_of(i) + 1, n0 + pt_of(i))]);
      }
    };

    if constexpr (MODE == kFwd) {
      const int nx = cdiv(a.D, kXK);
      if (T::STREAM) {  // x, whole, to the act image (A_0)
        for (int sl = 0; sl < nx; ++sl) build_x(sl, nullptr, 0);
        images_ready();
      } else if (STAGED) {
        build_x(0, xslice(0), xld);
      } else {
        for (int sl = 0; sl < nx; ++sl) build_x(sl, act_sm + sl * kXK, ld);
      }
      consumers_sync();
      for (int l = 0; l <= a.L1; ++l) {
        for (int pass = 0; pass < npass; ++pass) {
          c0 = pass * T::PW + cw;
          const bool last = pass + 1 == npass;
          if (!T::STREAM && pass > 0 && STAGED && l == 0) {  // x's first slice again, once every warp is past it
            consumers_sync();
            build_x(0, xslice(0), xld);
            consumers_sync();
          }
          products(l ? H : a.D, !T::STREAM && (!STAGED || l > 0));
          if (last) consumers_sync();  // every warp is done reading the layer's input
          const float* bias = l ? a.bh + static_cast<size_t>(l - 1) * H : a.b0;
          uint32_t m[T::MW];
#pragma unroll
          for (int w = 0; w < T::MW; ++w) m[w] = 0u;
#pragma unroll
          for (int i = 0; i < T::NR; ++i) {
            acc[i] = fmaxf(acc[i] + __ldg(bias + col_of(i)), 0.f);
            if (acc[i] > 0.f) m[i >> 5] |= 1u << (i & 31);
          }
          write_out(acc, a.act, a.act_rows, a.D + l * H, last);
          uint32_t* mk = mask_at(l, pass);
#pragma unroll
          for (int w = 0; w < T::MW; ++w) mk[w * kConsumers] = m[w];
        }
        restore(a.act, a.act_rows, a.D + l * H);
        if (T::STREAM && l < a.L1) images_ready();  // A_{l+1}, the next layer's input
        consumers_sync();
      }
      // head, fp32 FMAs (bf16-rounded operands with head_bf16): thread ->
      // (point, output column)
      if (tid < kTileP * kHead) {
        const int p = tid >> 2;
        const int o = tid & 3;
        float s = 0.f;
        if constexpr (T::STREAM) {  // A_L from the act image
          const int row = a.D + a.L1 * H;
#pragma unroll 16
          for (int k = 0; k < H; ++k) {
            const float v = a.act[img_at(a.act_rows, row + k, n0 + p)];
            s = fmaf(hb ? round_bf16(v) : v, head_w(k, o), s);
          }
        } else if (hb) {
#pragma unroll 16
          for (int k = 0; k < H0; ++k)
            s = fmaf(round_bf16(act_sm[p * ld + k]), whead[k * kHead + o], s);
        } else {
#pragma unroll 16
          for (int k = 0; k < H0; ++k) s = fmaf(act_sm[p * ld + k], whead[k * kHead + o], s);
        }
        a.out4[static_cast<size_t>(o) * a.Np + n0 + p] = s + __ldg(a.bout + o);
      }
      consumers_sync();  // the head has read the tile before the next input build
    } else {
      // delta_L = (g_out.wout[:, :4]^T) * [A_L > 0], exact fp32
      {
        float gv[NP][kHead];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int n = n0 + pt_at(p);
#pragma unroll
          for (int o = 0; o < kHead; ++o)
            gv[p][o] = n < a.N ? head_in(a.gout[static_cast<size_t>(o) * a.Np + n], hb) : 0.f;
        }
        for (int pass = 0; pass < npass; ++pass) {
          c0 = pass * T::PW + cw;
          const uint32_t* mk = mask_at(a.L1, pass);
          uint32_t m[T::MW];
#pragma unroll
          for (int w = 0; w < T::MW; ++w) m[w] = mk[w * kConsumers];
#pragma unroll
          for (int i = 0; i < T::NR; ++i) {
            const int k = col_of(i);
            float s = gv[pidx(i)][0] * head_w(k, 0);
            s = fmaf(gv[pidx(i)][1], head_w(k, 1), s);
            s = fmaf(gv[pidx(i)][2], head_w(k, 2), s);
            s = fmaf(gv[pidx(i)][3], head_w(k, 3), s);
            acc[i] = n0 + pt_of(i) < a.N && ((m[i >> 5] >> (i & 31)) & 1u) ? s : 0.f;
          }
          write_out(acc, a.gbuf, a.g_rows, a.L1 * H, true);  // the seed reads no tile
        }
        // g_out beside the deltas, for the head's dW (zero past N)
        for (int e = tid; e < kHead * kTileP; e += kConsumers) {
          const int o = e / kTileP, n = n0 + e % kTileP;
          a.gbuf[img_at(a.g_rows, L * H + o, n)] =
              n < a.N ? a.gout[static_cast<size_t>(o) * a.Np + n] : 0.f;
        }
      }
      if (T::STREAM && a.L1 > 0) images_ready();  // delta_L, the chain's first input
      consumers_sync();
      for (int l = a.L1 - 1; l >= 0; --l) {
        // delta_{l+1} = (delta_{l+2} . wh[l]^T) * [A_{l+1} > 0]
        for (int pass = 0; pass < npass; ++pass) {
          c0 = pass * T::PW + cw;
          const bool last = pass + 1 == npass;
          const uint32_t* mk = mask_at(l, pass);
          uint32_t m[T::MW];
#pragma unroll
          for (int w = 0; w < T::MW; ++w) m[w] = mk[w * kConsumers];
          products(H, !T::STREAM);
          if (last) consumers_sync();  // every warp is done reading delta_{l+2}
#pragma unroll
          for (int i = 0; i < T::NR; ++i)
            if (!((m[i >> 5] >> (i & 31)) & 1u)) acc[i] = 0.f;
          write_out(acc, a.gbuf, a.g_rows, l * H, last);
        }
        restore(a.gbuf, a.g_rows, l * H);
        if (T::STREAM && l > 0) images_ready();  // delta_{l+1}, the next step's input
        consumers_sync();
      }
    }
  }
}

// A trunk pass: the producer warpgroup and the consumers' roles.
template <int H, int MODE, bool INLINE_PE, bool STAGED, int ROUTE>
__device__ __forceinline__ void trunk(const TrunkArgs& a) {
  using T = Trunk<H, ROUTE>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw_addr & 1023)) & 1023);
  const uint32_t ring = smem_u32(base);
  // the tile (64, H + 8), two (64, 40) input slices, wout's live columns
  // (H, 4); the generic build has the mbarriers alone after its ring
  float* act_sm = T::STREAM ? nullptr : reinterpret_cast<float*>(base + T::kRing);
  float* xbuf = T::STREAM ? nullptr : act_sm + kTileP * T::LD;
  float* whead = T::STREAM ? nullptr : xbuf + 2 * kTileP * kXLd;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      T::STREAM ? base + T::kRing : reinterpret_cast<uint8_t*>(whead + H * kHead));
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + T::NS);
  const uint32_t ready = smem_u32(bars + 2 * T::NS);  // (generic build) a layer's input written
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < T::NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    if (T::STREAM) mbar_init(ready, kConsumers / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The roles never meet again: registers move from the producer warpgroup
  // (one thread of which issues the copies) to the consumers.
  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      int it = 0;
      if constexpr (T::STREAM) {
        // per layer, once its input is written: every pass's stages, each
        // the weights' stage image and the input rows of the tile's two
        // image blocks (x and A_l in act, delta_{l+2} in gbuf)
        const float* in = MODE == kFwd ? a.act : a.gbuf;
        const int rows = MODE == kFwd ? a.act_rows : a.g_rows;
        const int npass = a.H / kPassCols, L = a.L1 + 1;
        int round = 0;
        for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
          int st = 0;
          for (int i = 0; i < (MODE == kFwd ? L : a.L1); ++i) {
            const int l = MODE == kFwd ? i : a.L1 - 1 - i;  // the layer
            const int row0 = MODE == kFwd ? (l ? a.D + (l - 1) * a.H : 0) : (l + 1) * a.H;
            const int nst = MODE == kFwd && l == 0 ? cdiv(a.D, T::KS) : a.H / T::KS;
            mbar_wait(ready, round++ & 1);
            for (int pass = 0; pass < npass; ++pass)
              for (int sl = 0; sl < nst; ++sl, ++st, ++it) {
                const int s = it % T::NS;
                const uint32_t slot = ring + s * T::kSlotBytes;
                mbar_wait(empty0 + 8 * s, ((it / T::NS) & 1) ^ 1);
                mbar_arrive_expect_tx(full0 + 8 * s, T::kSlotBytes);
                bulk_copy(slot, a.images + static_cast<size_t>(st) * T::kStageBytes,
                          T::kStageBytes, full0 + 8 * s);
                for (int b = 0; b < 2; ++b)
                  bulk_copy(slot + T::kStageBytes + b * (T::KS * kBlk * 4),
                            in + ((static_cast<size_t>(tile) * 2 + b) * rows + row0 + sl * T::KS) *
                                     kBlk,
                            T::KS * kBlk * 4, full0 + 8 * s);
              }
          }
        }
      } else {
        for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x)
          for (int st = 0; st < a.stages; ++st, ++it) {
            const int s = it % T::NS;
            mbar_wait(empty0 + 8 * s, ((it / T::NS) & 1) ^ 1);
            mbar_arrive_expect_tx(full0 + 8 * s, T::kStageBytes);
            bulk_copy(ring + s * T::kStageBytes,
                      a.images + static_cast<size_t>(st) * T::kStageBytes, T::kStageBytes,
                      full0 + 8 * s);
          }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    trunk_consumer<H, MODE, INLINE_PE, STAGED, ROUTE>(a, ring, base, act_sm, xbuf, whead, full0,
                                                      empty0, ready);
  }
}

// The forward pass (STAGED: an input wider than the tile, in slices).
template <int H, bool INLINE_PE, bool STAGED, int ROUTE>
__global__ void __launch_bounds__(kThreads, 1) train_fwd_kernel(const TrunkArgs a) {
  trunk<H, kFwd, INLINE_PE, STAGED, ROUTE>(a);
}

// The backward chain.
template <int H, int ROUTE>
__global__ void __launch_bounds__(kThreads, 1) train_bwd_kernel(const TrunkArgs a) {
  trunk<H, kBwd, false, false, ROUTE>(a);
}

// ---- launch 5: the dW products ----

// One dW product: out[k][j] = sum_n A[k][n] * G[j][n] (j < J, zero for
// j >= Jreal), db[j] = sum_n G[j][n]; A is rows a_row.. of the act image,
// G rows g_row.. of the gbuf image.
struct DwJob {
  int a_row, g_row, K, J, Jreal, tiles;
  size_t out, db;  // offsets in the flattened gradient
};
struct DwJobs {
  DwJob job[kMaxJobs];
  int n;
};
struct DwArgs {
  const float* act;
  const float* gbuf;
  float* partial;
  size_t Fp;  // floats of one partial
  int act_rows, g_rows, nblk, chunk_blk;
};

// A route's dW stages: kConv bytes of one of the two wgmma images the
// consumers convert a stage's A and delta rows into (TF32 halves in the
// 128-byte swizzle, bf16 in the 64-byte one; none for the FFMAs), and the
// depth of the ring of raw stages that fits beside them.
template <int ROUTE>
struct DwStage {
  static constexpr int kConv =
      ROUTE == kTf32x3 ? 2 * 2 * kDwT * kBlk * 4 : (ROUTE == kBf16 ? 2 * kDwT * kBlk * 2 : 0);
  static constexpr int NS = ROUTE == kTf32x3 ? 3 : 4;
  static constexpr size_t kSmem = 1024 + NS * kDwSlot + 2 * kConv + 2 * NS * sizeof(uint64_t);
  static_assert(kSmem <= 232448, "train_dw's shared memory fits a block");
};

// The consumers of one dW tile (rows k0.., columns j0..) over nst 32-point
// stages: warpgroup wg owns rows [64*wg, +64) of the tile. The db sums take
// thread tid's half (points [16*(tid%2), +16)) of delta row tid/2.
template <int ROUTE>
__device__ __forceinline__ void dw_consumer(const DwJob& jd, const DwArgs& d, int k0, int j0,
                                            int nst, const uint8_t* ring_ptr, uint32_t conv,
                                            uint8_t* conv_ptr, uint32_t full0, uint32_t empty0) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const bool sum_db = k0 == 0;
  const int jrow = tid >> 1, half = tid & 1;
  float gsum = 0.f, gcomp = 0.f;
  float* out = d.partial + blockIdx.y * d.Fp;
  auto slot_a = [&](int s) { return reinterpret_cast<const float*>(ring_ptr + s * kDwSlot); };
  auto slot_g = [&](int s) { return slot_a(s) + kDwT * kBlk; };
  // the (raw fp32) value of the thread's delta row at chunk c of its half
  auto g_chunk = [&](const float* G, int c) {  // also A's row jrow
    return *reinterpret_cast<const float4*>(G + jrow * kBlk + (((c ^ (jrow & 7))) << 2));
  };

  if constexpr (ROUTE == kFp32) {
    // FFMAs: thread (rg, cg) of its warpgroup owns rows 64*wg + rg + 8a and
    // columns cg + 16c (a, c < 8); each stage's 32 products go to part, then
    // one round-to-nearest add per output: the point axis in two levels
    const int i = tid & 127, rg = i >> 4, cg = i & 15;
    float acc[8][8], part[8][8];
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int y = 0; y < 8; ++y) acc[x][y] = part[x][y] = 0.f;
    for (int b = 0; b < nst; ++b) {
      const int s = b % DwStage<ROUTE>::NS;
      mbar_wait(full0 + 8 * s, (b / DwStage<ROUTE>::NS) & 1);
      const float* A = slot_a(s);
      const float* G = slot_g(s);
      if (sum_db) {  // a compensated (Kahan) sum: a thread adds ~N/2 terms
#pragma unroll
        for (int c = 4 * half; c < 4 * half + 4; ++c) {
          const float4 v = g_chunk(G, c);
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float y = __fsub_rn(vs[e], gcomp);
            const float sum = __fadd_rn(gsum, y);
            gcomp = __fsub_rn(__fsub_rn(sum, gsum), y);
            gsum = sum;
          }
        }
      }
#pragma unroll 2
      for (int ch = 0; ch < kBlk / 4; ++ch) {
        float4 av[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int r = 64 * wg + rg + 8 * x;
          av[x] = *reinterpret_cast<const float4*>(A + r * kBlk + ((ch ^ (r & 7)) << 2));
        }
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          const int cc = cg + 16 * y;
          const float4 gv = *reinterpret_cast<const float4*>(G + cc * kBlk + ((ch ^ (cc & 7)) << 2));
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            part[x][y] = fmaf(av[x].x, gv.x, part[x][y]);
            part[x][y] = fmaf(av[x].y, gv.y, part[x][y]);
            part[x][y] = fmaf(av[x].z, gv.z, part[x][y]);
            part[x][y] = fmaf(av[x].w, gv.w, part[x][y]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage is free again
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          acc[x][y] = __fadd_rn(acc[x][y], part[x][y]);
          part[x][y] = 0.f;
        }
    }
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int k = k0 + 64 * wg + rg + 8 * x;
      if (k >= jd.K) continue;
#pragma unroll
      for (int y = 0; y < 8; ++y) {
        const int col = j0 + cg + 16 * y;
        if (col < jd.J)
          out[jd.out + static_cast<size_t>(k) * jd.J + col] = col < jd.Jreal ? acc[x][y] : 0.f;
      }
    }
    gsum = __fsub_rn(gsum, gcomp);
  } else {
    constexpr int kConv = DwStage<ROUTE>::kConv;
    constexpr int kImg = kConv / 2;  // one operand's image: A, then G
    const int r0 = 64 * wg + 16 * (warp & 3) + g;  // the accumulators' rows r0, r0 + 8
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    // the stage's rows of both operands (the thread's half of A row jrow and
    // of delta row jrow) into B-operand image cb: TF32 halves [hi | lo] in
    // the 128-byte swizzle, or the bf16 rounding in the 64-byte swizzle; and
    // db's partial from the fp32 delta values
    auto convert = [&](int s, int cb) {
      uint8_t* dst = conv_ptr + cb * kConv;
#pragma unroll
      for (int op = 0; op < 2; ++op) {
        const float* src = op ? slot_g(s) : slot_a(s);
#pragma unroll
        for (int c = 4 * half; c < 4 * half + 4; ++c) {
          const float4 v = g_chunk(src, c);
          if (op == 1 && sum_db) {
            gsum += v.x;
            gsum += v.y;
            gsum += v.z;
            gsum += v.w;
          }
          if constexpr (ROUTE == kTf32x3) {
            uint4 hi, lo;
            split_fast(v.x, hi.x, lo.x);
            split_fast(v.y, hi.y, lo.y);
            split_fast(v.z, hi.z, lo.z);
            split_fast(v.w, hi.w, lo.w);
            const int off = op * kImg + (jrow * kBlk + ((c ^ (jrow & 7)) << 2)) * 4;
            *reinterpret_cast<uint4*>(dst + off) = hi;
            *reinterpret_cast<uint4*>(dst + off + kImg / 2) = lo;
          } else {  // bf16 chunk c/2 of the row's 64 bytes, its 8-byte half c%2
            const int off = op * kImg + jrow * 64 + ((((c >> 1) ^ ((jrow >> 1) & 3))) << 4) +
                            (c & 1) * 8;
            *reinterpret_cast<uint2*>(dst + off) =
                make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
          }
        }
      }
      fence_proxy_async();
    };
    // stage b's products from image b % 2 (A rows [64*wg, +64), all 128 G
    // rows), then the next stage's conversion while they run
    auto step = [&](int b) {
      const uint32_t img = conv + (b & 1) * kConv;
      fence_regs(part);
      wgmma_fence();
      if constexpr (ROUTE == kTf32x3) {
        const uint32_t a_hi = img + wg * 64 * 128, a_lo = a_hi + kImg / 2;
        const uint32_t g_hi = img + kImg, g_lo = g_hi + kImg / 2;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          wgmma_ss_tf32(part, sw128_desc(a_lo + 32 * q), sw128_desc(g_hi + 32 * q), q > 0);
          wgmma_ss_tf32(part, sw128_desc(a_hi + 32 * q), sw128_desc(g_lo + 32 * q), 1);
          wgmma_ss_tf32(part, sw128_desc(a_hi + 32 * q), sw128_desc(g_hi + 32 * q), 1);
        }
      } else {
        const uint32_t a = img + wg * 64 * 64, gi = img + kImg;
#pragma unroll
        for (int q = 0; q < 2; ++q)
          wgmma_ss_bf16(part, sw64_desc(a + 32 * q), sw64_desc(gi + 32 * q), q > 0);
      }
      wgmma_commit();
      if (b + 1 < nst) {
        const int s = (b + 1) % DwStage<ROUTE>::NS;
        mbar_wait(full0 + 8 * s, ((b + 1) / DwStage<ROUTE>::NS) & 1);
        convert(s, (b + 1) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage is free again
      }
      wgmma_wait_all();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      consumers_sync();  // image (b + 1) % 2 is written; image b % 2 is read
    };
    if (nst > 0) {
      mbar_wait(full0, 0);
      convert(0, 0);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0);
      consumers_sync();
    }
    for (int b = 0; b < nst; ++b) step(b);
#pragma unroll
    for (int j = 0; j < kDwT / 8; ++j) {
      const int col = j0 + 8 * j + 2 * t;
      if (col >= jd.J) continue;
      const bool live = col < jd.Jreal;
      const int k = k0 + r0;
      if (k < jd.K)
        *reinterpret_cast<float2*>(out + jd.out + static_cast<size_t>(k) * jd.J + col) =
            live ? make_float2(acc[4 * j], acc[4 * j + 1]) : make_float2(0.f, 0.f);
      if (k + 8 < jd.K)
        *reinterpret_cast<float2*>(out + jd.out + static_cast<size_t>(k + 8) * jd.J + col) =
            live ? make_float2(acc[4 * j + 2], acc[4 * j + 3]) : make_float2(0.f, 0.f);
    }
  }
  if (sum_db) {
    const float v = gsum + __shfl_xor_sync(0xffffffffu, gsum, 1);
    const int col = j0 + jrow;
    if (half == 0 && col < jd.J) out[jd.db + col] = col < jd.Jreal ? v : 0.f;
  }
}

// One 128x128 tile (rows k, columns j) of a dW product over one part of
// the point axis (blockIdx.y): the producer streams each 32-point block's
// tile rows of A and G (rows past K or Jreal are not copied; their outputs
// are not written, or written as zero) into the ring.
template <int ROUTE>
__global__ void __launch_bounds__(kThreads, 1)
train_dw_kernel(const DwJobs jobs, const DwArgs d) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw_addr & 1023)) & 1023);
  const uint32_t ring = smem_u32(base);
  constexpr int NS = DwStage<ROUTE>::NS;
  uint8_t* conv_ptr = base + NS * kDwSlot;
  uint64_t* bars = reinterpret_cast<uint64_t*>(conv_ptr + 2 * DwStage<ROUTE>::kConv);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + NS);
  int tile = blockIdx.x;
  int jb = 0;
  while (jb + 1 < jobs.n && tile >= jobs.job[jb].tiles) {
    tile -= jobs.job[jb].tiles;
    ++jb;
  }
  const DwJob& jd = jobs.job[jb];
  const int tiles_j = cdiv(jd.J, kDwT);
  const int k0 = (tile / tiles_j) * kDwT;
  const int j0 = (tile % tiles_j) * kDwT;
  const int b0 = blockIdx.y * d.chunk_blk;
  const int nst = max(min(d.nblk, b0 + d.chunk_blk) - b0, 0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      const int ka = min(kDwT, jd.K - k0), jg = min(kDwT, jd.Jreal - j0);
      for (int b = 0; b < nst; ++b) {
        const int s = b % NS;
        const uint32_t slot = ring + s * kDwSlot;
        mbar_wait(empty0 + 8 * s, ((b / NS) & 1) ^ 1);
        mbar_arrive_expect_tx(full0 + 8 * s, (ka + jg) * kBlk * 4);
        const size_t blk = static_cast<size_t>(b0 + b);
        bulk_copy(slot, d.act + (blk * d.act_rows + jd.a_row + k0) * kBlk, ka * kBlk * 4,
                  full0 + 8 * s);
        bulk_copy(slot + kDwT * kBlk * 4, d.gbuf + (blk * d.g_rows + jd.g_row + j0) * kBlk,
                  jg * kBlk * 4, full0 + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    dw_consumer<ROUTE>(jd, d, k0, j0, nst, base, smem_u32(conv_ptr), conv_ptr, full0, empty0);
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
// cotangent of the first layer (rows 0..H-1 of the gbuf image), on the tensor
// cores: 64 points x 64 input columns per CTA, 2x4 warps of 32x16, the
// reduction over j in cp.async stages of 32 (delta_1 split on the fly, the
// halves of w0's row-major image from weight_image); the bfloat16 and
// highest routes read w0's bf16 or fp32 image from the hi half.
template <int ROUTE>
__global__ void __launch_bounds__(kDxThreads, 1)
render_dx_kernel(const float* __restrict__ gbuf, const float* __restrict__ w0hi,
                 const float* __restrict__ w0lo, float* __restrict__ dx, int N, int D, int H,
                 int g_rows) {
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
    static_assert(kAll % kDxThreads == 0, "dx stage copies per thread");
#pragma unroll
    for (int v = 0; v < kAll / kDxThreads; ++v) {
      const int c = threadIdx.x + v * kDxThreads;
      if (c < kDChunks) {
        const int r = c / (kDxP / 4), q = c % (kDxP / 4);
        const int n = n0 + q * 4, j = j0 + r;  // 4 points of row j: one chunk of the image
        const size_t src = (static_cast<size_t>(n >> 5) * g_rows + j) * kBlk +
                           ((((n & 31) >> 2) ^ (j & 7)) << 2);
        cp_async16(st + r * kDxLdD + q * 4, gbuf + src, 16);
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


// ---- launchers ----

struct Scratch {
  float *act, *gbuf, *gout, *out4, *loss_r, *part, *w0hi, *w0lo;
  float* ray;  // the composite's ray state, or nullptr (it fits shared memory)
  uint32_t* mask;
  uint8_t* img;
};

Scratch carve(const Layout& s, float* scratch, int D, int H, int S) {
  Scratch b;
  b.ray = comp_in_smem(S) ? nullptr : scratch + s.ray;
  b.act = scratch + s.act;
  b.gbuf = scratch + s.gbuf;
  b.gout = scratch + s.gout;
  b.out4 = scratch + s.out4;
  b.loss_r = scratch + s.loss_r;
  b.part = scratch + s.part;
  b.w0hi = scratch + s.w0x;
  b.w0lo = b.w0hi + static_cast<size_t>(D) * H;
  b.mask = reinterpret_cast<uint32_t*>(scratch + s.mask);
  b.img = reinterpret_cast<uint8_t*>(scratch + s.img);
  return b;
}

// The launches above 48 KB of dynamic shared memory need the limit raised
// (a host call, made before each launch).
template <class K>
cudaError_t smem_limit(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The composite's dynamic shared memory for S samples (0 when its state
// goes to the scratch), the limit raised past kSmemDefault.
template <class K>
cudaError_t composite_smem(K kernel, int S, size_t& bytes) {
  bytes = comp_in_smem(S) ? comp_bytes(S) : 0;
  return bytes > static_cast<size_t>(kSmemDefault) ? smem_limit(kernel, bytes) : cudaSuccess;
}

// The weights' stage images (and, with_w0, w0's row-major image).
template <int H0, int ROUTE>
cudaError_t launch_weights(const float* w0, const float* wh, const Scratch& b, int D, int H,
                           int L1, bool with_w0, cudaStream_t st) {
  const int n_fwd = fwd_stages<H0, ROUTE>(D, H, L1);
  const int n_stages = n_fwd + bwd_stages<H0, ROUTE>(H, L1);
  const int rows = n_stages + (with_w0 ? cdiv(D, 32) : 0);
  for (int y0 = 0; y0 < rows; y0 += kMaxGridY) {  // any depth: grids of kMaxGridY rows
    const int n = rows - y0 < kMaxGridY ? rows - y0 : kMaxGridY;
    weight_image_kernel<H0, ROUTE><<<dim3(H / 32, n), 256, 0, st>>>(
        w0, wh, b.img, b.w0hi, b.w0lo, D, L1, n_fwd, n_stages, y0, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// One trunk pass (MODE kFwd or kBwd) over every tile, by persistent CTAs.
template <int H, int MODE, bool INLINE_PE, int ROUTE>
cudaError_t launch_trunk(const TrunkArgs& a, int device, cudaStream_t st) {
  constexpr size_t smem = trunk_smem<H, ROUTE>();
  void (*kernel)(TrunkArgs) = train_bwd_kernel<H, ROUTE>;
  // a forward input wider than the activation tile streams through the
  // slices, as does every input of the generic build
  if constexpr (MODE == kFwd)
    kernel = a.D > H ? train_fwd_kernel<H, INLINE_PE, true, ROUTE>
                     : train_fwd_kernel<H, INLINE_PE, Trunk<H, ROUTE>::STREAM, ROUTE>;
  cudaError_t err = smem_limit(kernel, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  kernel<<<a.tiles < sms ? a.tiles : sms, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// The trunk's arguments for a call; the launchers set images and stages.
TrunkArgs trunk_args(const Layout& s, const Scratch& b, const float* in, const float* feats,
                     const float* e2, const float* c, const float* b0, const float* bh,
                     const float* wout, const float* bout, int n_raw, int n_phase, int Fd, int D,
                     int H, int L1, bool head_bf16) {
  TrunkArgs a;
  a.in = in;
  a.feats = feats;
  a.e2 = e2;
  a.c = c;
  a.b0 = b0;
  a.bh = bh;
  a.wout = wout;
  a.bout = bout;
  a.images = nullptr;
  a.act = b.act;
  a.out4 = b.out4;
  a.gout = b.gout;
  a.gbuf = b.gbuf;
  a.mask = b.mask;
  a.N = s.N;
  a.Np = s.Np;
  a.tiles = s.tiles;
  a.stages = 0;
  a.n_raw = n_raw;
  a.n_phase = n_phase;
  a.Fd = Fd;
  a.D = D;
  a.H = H;
  a.L1 = L1;
  a.act_rows = s.act_rows;
  a.g_rows = s.g_rows;
  a.head_bf16 = head_bf16;
  return a;
}

// The recompute of the trunk: every layer's activations and masks, and
// the 4 head outputs of each 64-point tile.
template <int H, bool INLINE_PE, int ROUTE>
cudaError_t launch_forward(TrunkArgs a, const Scratch& b, int device, cudaStream_t st) {
  a.images = b.img;
  a.stages = a.H / Trunk<H, ROUTE>::PW * fwd_stages<H, ROUTE>(a.D, a.H, a.L1);
  return launch_trunk<H, kFwd, INLINE_PE, ROUTE>(a, device, st);
}

// The backward chain of each 64-point tile, from the head cotangent gout.
template <int H, int ROUTE>
cudaError_t launch_backward(TrunkArgs a, const Scratch& b, int device, cudaStream_t st) {
  using T = Trunk<H, ROUTE>;
  const int npass = a.H / T::PW;
  a.images = b.img + static_cast<size_t>(npass) * fwd_stages<H, ROUTE>(a.D, a.H, a.L1) *
                         T::kStageBytes;
  a.stages = npass * bwd_stages<H, ROUTE>(a.H, a.L1);
  return launch_trunk<H, kBwd, false, ROUTE>(a, device, st);
}

template <int ROUTE>
cudaError_t launch_dw_route(const DwJobs& jobs, const DwArgs& d, int tiles, int P,
                            cudaStream_t st) {
  constexpr size_t smem = DwStage<ROUTE>::kSmem;
  const cudaError_t err = smem_limit(train_dw_kernel<ROUTE>, smem);
  if (err != cudaSuccess) return err;
  train_dw_kernel<ROUTE><<<dim3(tiles, P), kThreads, smem, st>>>(jobs, d);
  return cudaGetLastError();
}

// Every dW = A^T.delta and db = sum delta (layer 0, the L1 hidden layers,
// the head) over fixed point-axis parts, then the fixed-order sum of the
// parts into grads. The layers' products take dw_route, the head's
// head_route: one group when they agree, else one per route. A group goes
// in launches of at most kMaxJobs products (one up to 15 layers); every
// product writes its own rows of the same partials, so how the products
// are split into launches changes no bit.
cudaError_t launch_dw(const Layout& s, const Scratch& b, float* grads, int D, int H, int L1,
                      int dw_route, int head_route, cudaStream_t st) {
  std::vector<DwJob> jobs[2];
  auto add = [&](int grp, int a_row, int g_row, int K, int J, int Jreal, size_t out, size_t db) {
    DwJob j;
    j.a_row = a_row;
    j.g_row = g_row;
    j.K = K;
    j.J = J;
    j.Jreal = Jreal;
    j.tiles = cdiv(K, kDwT) * cdiv(J, kDwT);
    j.out = out;
    j.db = db;
    jobs[grp].push_back(j);
  };
  const size_t off_w0 = 0, off_b0 = static_cast<size_t>(D) * H;
  const size_t off_wh = off_b0 + H;
  const size_t off_bh = off_wh + static_cast<size_t>(L1) * H * H;
  const size_t off_wout = off_bh + static_cast<size_t>(L1) * H;
  const size_t off_bout = off_wout + static_cast<size_t>(H) * kOutPad;
  add(0, 0, 0, D, H, H, off_w0, off_b0);
  for (int l = 0; l < L1; ++l)
    add(0, D + l * H, (l + 1) * H, H, H, H, off_wh + static_cast<size_t>(l) * H * H,
        off_bh + static_cast<size_t>(l) * H);
  add(head_route == dw_route ? 0 : 1, D + L1 * H, (L1 + 1) * H, H, kOutPad, kHead, off_wout,
      off_bout);
  DwArgs d;
  d.act = b.act;
  d.gbuf = b.gbuf;
  d.partial = b.part;
  d.Fp = round_up(s.F, 64);
  d.act_rows = s.act_rows;
  d.g_rows = s.g_rows;
  d.nblk = s.nblk;
  d.chunk_blk = s.chunk_blk;
  for (int grp = 0; grp < 2; ++grp) {
    const int route = grp ? head_route : dw_route;
    for (size_t first = 0; first < jobs[grp].size(); first += kMaxJobs) {
      DwJobs batch;
      batch.n = 0;
      int tiles = 0;
      for (size_t i = first; i < jobs[grp].size() && batch.n < kMaxJobs; ++i) {
        batch.job[batch.n++] = jobs[grp][i];
        tiles += jobs[grp][i].tiles;
      }
      cudaError_t err;
      if (route == kBf16)
        err = launch_dw_route<kBf16>(batch, d, tiles, s.P, st);
      else if (route == kFp32)
        err = launch_dw_route<kFp32>(batch, d, tiles, s.P, st);
      else
        err = launch_dw_route<kTf32x3>(batch, d, tiles, s.P, st);
      if (err != cudaSuccess) return err;
    }
  }
  train_finalize_kernel<<<static_cast<unsigned>((s.F + 255) / 256), 256, 0, st>>>(
      b.part, grads, s.F, d.Fp, s.P);
  return cudaGetLastError();
}

// The shapes the launches take: every K a multiple of 16, the R*S points
// (padded to whole tiles) counted in an int; any S, D and depth; any trunk
// width the JAX kernels take (a multiple of 128).
bool shapes_ok(int R, int S, int D, int H, int L1) {
  return R >= 1 && S >= 1 && static_cast<long long>(R) * S <= INT_MAX - kTileP && D > 0 &&
         D % 16 == 0 && H > 0 && H % kPassCols == 0 && L1 >= 0;
}

bool route_ok(int route) { return route == kTf32x3 || route == kBf16 || route == kFp32; }

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
// exact fp32 with a.head_vpu (its dW then kFp32 too). H0: a fixed width's
// build, or kAnyH (the generic build) at width H.
template <int H0, bool INLINE_PE, int ROUTE>
cudaError_t launch(const TrainArgs& a, int H, int device, cudaStream_t stream) {
  const Layout s = make_layout(a.R, a.S, a.D, H, a.L1);
  const Scratch b = carve(s, a.scratch, a.D, H, a.S);
  const bool head_bf16 = ROUTE == kBf16 && !a.head_vpu;
  cudaError_t err = launch_weights<H0, ROUTE>(a.w0, a.wh, b, a.D, H, a.L1, false, stream);
  const TrunkArgs ta = trunk_args(s, b, a.in, a.feats, a.e2, a.c, a.b0, a.bh, a.wout, a.bout,
                                  a.n_raw, a.n_phase, a.Fd, a.D, H, a.L1, head_bf16);
  if (err == cudaSuccess) err = launch_forward<H0, INLINE_PE, ROUTE>(ta, b, device, stream);
  if (err != cudaSuccess) return err;

  size_t comp_smem = 0;
  err = composite_smem(train_composite_kernel<ROUTE == kFp32>, a.S, comp_smem);
  if (err != cudaSuccess) return err;
  train_composite_kernel<ROUTE == kFp32><<<a.R, 32, comp_smem, stream>>>(
      b.out4, a.z, a.dnorm, a.tgt, a.mask, a.inv_denom, a.tgt_depth, b.gout, b.loss_r, b.ray,
      a.S, s.Np, a.white_bkgd, a.rgb_c, a.reg_c, a.depth_c);

  err = launch_backward<H0, ROUTE>(ta, b, device, stream);
  if (err == cudaSuccess)
    err = launch_dw(s, b, a.grads, a.D, H, a.L1, a.dw_route, a.head_vpu ? kFp32 : a.dw_route,
                    stream);
  if (err != cudaSuccess) return err;
  loss_sum_kernel<<<1, 256, 0, stream>>>(b.loss_r, a.loss, a.R);
  return cudaGetLastError();
}

template <int H0, bool INLINE_PE>
cudaError_t dispatch_route(int route, const TrainArgs& a, int H, int device, cudaStream_t st) {
  if (route == kBf16) return launch<H0, INLINE_PE, kBf16>(a, H, device, st);
  if (route == kFp32) return launch<H0, INLINE_PE, kFp32>(a, H, device, st);
  return launch<H0, INLINE_PE, kTf32x3>(a, H, device, st);
}

template <int H0>
cudaError_t dispatch(int inline_pe, int route, const TrainArgs& a, int H, int device,
                     cudaStream_t st) {
  return inline_pe ? dispatch_route<H0, true>(route, a, H, device, st)
                   : dispatch_route<H0, false>(route, a, H, device, st);
}

// f(std::integral_constant<int, H0>) for trunk width H (shapes_ok's): each
// width up to kMaxFixedH its own build, every wider one the generic build
// (H0 == kAnyH), any other H refused.
template <class F>
cudaError_t at_width(int H, F f) {
  switch (H) {
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 384: return f(std::integral_constant<int, 384>{});
    case 512: return f(std::integral_constant<int, 512>{});
    default:
      if (H > kMaxFixedH && H % kPassCols == 0) return f(std::integral_constant<int, kAnyH>{});
      return cudaErrorInvalidValue;
  }
}

// The render VJP's arguments, as nerf_render_bwd takes them.
struct RenderBwdArgs {
  const float *x, *z, *dnorm, *w0, *b0, *wh, *bh, *wout, *bout;
  const float *g_rgb, *g_depth, *g_acc, *g_weights;
  float *dx, *grads, *scratch;
  int R, S, D, L1, white_bkgd;
};

// Kernel 3: the VJP of the render from a pre-encoded x. Recomputes the
// forward, composites backward from the external cotangents, runs the
// backward chain and the dW products, and (dx != nullptr) the input
// cotangent, every product on route ROUTE.
template <int H0, int ROUTE>
cudaError_t launch_render_bwd(const RenderBwdArgs& a, int H, int device, cudaStream_t stream) {
  const Layout s = make_layout(a.R, a.S, a.D, H, a.L1);
  const Scratch b = carve(s, a.scratch, a.D, H, a.S);
  constexpr bool head_bf16 = ROUTE == kBf16;
  cudaError_t err =
      launch_weights<H0, ROUTE>(a.w0, a.wh, b, a.D, H, a.L1, a.dx != nullptr, stream);
  const TrunkArgs ta = trunk_args(s, b, a.x, nullptr, nullptr, nullptr, a.b0, a.bh, a.wout,
                                  a.bout, 0, 0, 0, a.D, H, a.L1, head_bf16);
  if (err == cudaSuccess) err = launch_forward<H0, false, ROUTE>(ta, b, device, stream);
  if (err != cudaSuccess) return err;

  size_t comp_smem = 0;
  err = composite_smem(render_composite_kernel<ROUTE == kFp32>, a.S, comp_smem);
  if (err != cudaSuccess) return err;
  render_composite_kernel<ROUTE == kFp32><<<a.R, 32, comp_smem, stream>>>(
      b.out4, a.z, a.dnorm, a.g_rgb, a.g_depth, a.g_acc, a.g_weights, b.gout, b.ray, a.S, s.Np,
      a.white_bkgd);

  err = launch_backward<H0, ROUTE>(ta, b, device, stream);
  if (err == cudaSuccess) err = launch_dw(s, b, a.grads, a.D, H, a.L1, ROUTE, ROUTE, stream);
  if (err != cudaSuccess) return err;
  if (a.dx != nullptr) {
    err = smem_limit(render_dx_kernel<ROUTE>, kDxSmem);
    if (err != cudaSuccess) return err;
    render_dx_kernel<ROUTE>
        <<<dim3(s.Np / kDxP, cdiv(a.D, kDxK)), kDxThreads, kDxSmem, stream>>>(
            b.gbuf, b.w0hi, b.w0lo, a.dx, s.N, a.D, H, s.g_rows);
  }
  return cudaGetLastError();
}

template <int H0>
cudaError_t render_bwd_route(int route, const RenderBwdArgs& a, int H, int device,
                             cudaStream_t st) {
  if (route == kBf16) return launch_render_bwd<H0, kBf16>(a, H, device, st);
  if (route == kFp32) return launch_render_bwd<H0, kFp32>(a, H, device, st);
  return launch_render_bwd<H0, kTf32x3>(a, H, device, st);
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
  if (!shapes_ok(R, S, D, H, L1) || !route_ok(route) || !route_ok(dw_route))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TrainArgs a{in,   feats, z,     dnorm,   tgt,     mask,   inv_denom, tgt_depth,
                    e2,   c,     w0,    b0,      wh,      bh,     wout,      bout,
                    loss, grads, scratch, R,     S,       n_raw,  n_phase,   Fd,
                    D,    L1,    white_bkgd, rgb_c, reg_c, depth_c, dw_route, head_vpu};
  return at_width(H, [&](auto w) {
    return dispatch<decltype(w)::value>(inline_pe, route, a, H, device, st);
  });
}

extern "C" int nerf_render_bwd(const float* x, const float* z, const float* dnorm,
                               const float* w0, const float* b0, const float* wh, const float* bh,
                               const float* wout, const float* bout, const float* g_rgb,
                               const float* g_depth, const float* g_acc, const float* g_weights,
                               float* dx, float* grads, float* scratch, int R, int S, int D, int H,
                               int L1, int white_bkgd, int route, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!shapes_ok(R, S, D, H, L1) || !route_ok(route)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RenderBwdArgs a{x,       z,     dnorm, w0, b0, wh, bh, wout, bout, g_rgb, g_depth,
                        g_acc,   g_weights, dx, grads, scratch, R, S, D, L1, white_bkgd};
  return at_width(H, [&](auto w) {
    return render_bwd_route<decltype(w)::value>(route, a, H, device, st);
  });
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
