// Forward NeRF render for Hopper (sm_90a): the trunk's products on the
// tensor cores as 3xTF32 through wgmma, in two builds.
//
// Replaces: nerf_fewshot_tpu/render/kernels.py:_fwd_pe_kernel (:251, the
// Pallas TPU kernel behind fused_render_fwd_pe; INLINE_PE = true) and
// :_fwd_kernel (:139, the forward of fused_render from a pre-encoded x;
// INLINE_PE = false). Both compute:
//   x      = [raw | sin(c + raw.e2) | feats | 0-pad]  or the given (N, D) x
//   h      = relu(x.w0 + b0), then L1 x relu(h.wh[l] + bh[l])
//   out    = h.wout[:, :4] + bout[:4];  rgb = sigmoid(out[0:3]), sigma = out[3]
//   dists  = [dz, 1e10] * |d|;  om = exp(-relu(sigma)*dists) + 1e-10
//   T      = exp(inclusive_cumsum(log om) - log om)
//   w      = (1 - exp(-relu(sigma)*dists)) * T
//   rgb    = sum w*rgb (+ 1 - acc if white_bkgd), depth = sum w*z, acc = sum w
//
// Numerics. The trunk's products run as 3xTF32 (csrc/train_pe.cu's rules):
// each fp32 operand is cut into hi = rna(v) and lo = rna(v - hi), and a
// product is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi. The weights are split once
// per call by cvt.rna.tf32.f32; the activations as their fragments are read,
// by the same rounding in integer operations. The tensor cores round their
// fp32 accumulation toward zero, so the products of each 32-row weight stage
// (four k-steps of 8, a chain of 12 wgmma) accumulate in their own registers
// and are added to the running sum with round-to-nearest FADDs. Exact fp32
// on the CUDA cores: the PE phases (broadcast multiply-adds; every nonzero
// of e2 is a power of two, so each phase is rounded once) and the accurate
// libdevice sinf (the phases reach ~2^9*|x| rad, where __sinf and
// --use_fast_math are wrong), the 4-column head, the sigmoid and the
// log-space transmittance scan (an fp32 warp scan) with the 1e10 far delta
// and the 1e-10 epsilon.
//
// Bound: at the baseline widths (x_dim 90, 8x256 trunk) the products are
// 2*(90*256 + 7*256*256 + 256*4) = 0.97 MFLOP per point, 127 GFLOP per
// 2048x64 chunk, against ~6 MB of inputs and outputs (~70 MB with a
// pre-encoded 128-wide x): bound by operations. As 3xTF32 each product is
// three TF32 products, so the least time is 3 * FLOPs at the 495 TFLOP/s
// TF32 peak of an H100 SXM (0.77 ms per chunk), a rate only wgmma reaches.
//
// Design: three grid launches on one stream.
//   1. fwd_split: the TF32 halves of w0 and wh into the caller's scratch,
//      laid out as the stage images the trunk copies into shared memory:
//      per 32 input rows ("stage"), [hi | lo], each H rows (output columns
//      n) of 32 k-slots, K-major, in the 128-byte swizzle wgmma reads
//      (16-byte chunk c of row n at chunk c ^ (n % 8)); rows past K are zero.
//      Within each group of 8 k-slots, slot j < 4 holds input row 2j and slot
//      j >= 4 row 2(j-4)+1, so that a thread's two A-fragment columns t and
//      t+4 are adjacent in the activation tile (one 8-byte load).
//   2. fwd_trunk: one persistent CTA of 384 threads per SM walks tiles of
//      64 points of the flattened R*S axis (points of any ray, the last tile
//      ragged). Warpgroup 2 is the producer: one thread streams the stage
//      images of every layer, tile after tile, by TMA bulk copies
//      (cp.async.bulk) into a 128 KB ring of shared-memory stages guarded by
//      full/empty mbarriers, and the warpgroup hands its registers to the
//      consumers (setmaxnreg 40 / 232; ptxas sizes a wgmma kernel by whole
//      warpgroups, 168 registers a thread at launch).
//      Warps 0-7 are two consumer warpgroups; both take all 64 points, and
//      warpgroup g the output columns [g*H/2, (g+1)*H/2). The activation
//      tile (64 points x H, point-major fp32, row stride H + 8) stays in
//      shared memory: per k-step each thread loads its A fragment (rows
//      16w+lane/4 and +8, two adjacent columns), splits it into TF32 halves
//      and issues wgmma m64n(H/2)k8 with A from registers and B (a weight
//      half) by descriptor from the stage; the next stage's fragments are
//      loaded and split while the stage's chain runs on the tensor cores,
//      and the chain's sum is promoted once it is done. After a layer's
//      last stage both warpgroups meet at a named barrier, write
//      relu(acc + b) over the tile in place and meet again. Layer 0's input
//      is built point-major (the PE phases, point features or the
//      pre-encoded x read coalesced): up to H columns into the tile, before
//      the layer; a wider one (STAGED, any width, more than the tile holds
//      beside the ring) is never held whole, each 32-column
//      stage built into one of two small stage buffers, the next one while
//      the current chain runs on the tensor cores. The sums are the same
//      either way, in the same order. The head
//      (exact fp32, wout's live columns staged in shared memory once per
//      CTA) writes the four raw outputs to scratch ([4][Np]).
//   3. fwd_composite: one warp per ray (8 rays per CTA): sigmoid, the
//      log-space scan carried over 32-sample chunks (any S, no state kept)
//      and the sums, written to rgb, depth, acc, weights.
// Widths. At H 128 and 256 a layer is one pass over its stages: warpgroup g
// owns H/2 columns, shared memory holds the 128 KB ring, the 64 x (H + 8)
// tile, the two 64 x 40 layer-0 stage buffers and H x 4 head columns (219
// KB at H 256). At H 384 and 512 the tile alone is 98 and 130 KB, and a
// 64-point tile's sums and stage products (64 x H x 2 fp32) would fill 75 %
// and all of the register file. So a layer runs in H/128 column passes of
// 128 columns, 64 a warpgroup (the accumulators of H 128: NR 32 and 32
// registers a thread), each pass streaming its own stage images (the 128
// output rows of the pass, [hi | lo] of 32 KB) through a 96 KB (H 384) or
// 64 KB (H 512) ring: 226 and 228 KB a block. A pass reads the whole layer
// input from the tile, so a finished pass's relu(acc + b) waits in a
// per-CTA global buffer (`held`, L2-resident: 96 KB a CTA per layer at H
// 512) until the last pass has read the tile; then every pass is written
// over it. A column's sums are the one-pass design's, in the same order.
// Every wider H (any multiple of 128) runs one width-generic build (H read
// at run time, template width kAnyH): the 64 x (H + 8) tile would not fit
// beside the ring (162 KB at H 640, 260 KB at H 1024), so none is held.
// The consumers write x, then each layer's output pass by pass, to the
// CTA's images in `held` (L2-resident; 32-column slices of 64 points in
// rows of 40 floats, so a slice is one contiguous 10 KB copy: 670 KB a CTA
// at H 1024, D 96), and the producer copies each stage's input slice from
// them by a bulk copy into the ring slot beside the stage's weights, on
// the same full / empty mbarriers, once the layer before is written (a
// `ready` mbarrier: each consumer warp arrives after fence.proxy.async,
// which orders its generic stores before the copies' reads). The
// consumers read their fragments from the slot as from a staged layer 0's
// buffers; the head reads the last image and wout from global memory.
// Shared memory is a 216 KB ring and the mbarriers, at every width; each
// pass reads the layer input again, from L2 (2.5 H^2 bytes a layer and
// tile with the rows' padding, beside the 8 H^2 of the weight halves).
// The fragments and the k order are the column passes': a column's sums
// are theirs.
// Fragments (wgmma m64nNk8 .tf32, warp w of the warpgroup, g = lane/4,
// t = lane%4): A a0 (16w+g, t), a1 (16w+g+8, t), a2 (16w+g, t+4),
// a3 (16w+g+8, t+4); D d[4j+e] at row 16w+g (+8 for e >= 2), column
// 8j+2t (+1 for odd e). wgmma m64nNk16 .bf16 packs two columns a register,
// the lower in the low half: a0 (16w+g, 2t..2t+1), a1 (16w+g+8, 2t..2t+1),
// a2 (16w+g, 2t+8..2t+9), a3 (16w+g+8, 2t+8..2t+9); D as tf32.
//
// Precision routes. The above is the float32 route (ROUTE kTf32x3). The
// JAX kernels' other compute_dtypes (nerf_fewshot_tpu/render/kernels.py:63
// _dot) keep the launches, the ring, the producer and the tiles, and change
// the stage images and the consumers' products:
//   kBf16 (bfloat16): the stage image is the bf16 rounding (cvt.rn: to
//   nearest even) of the 32 rows, H rows of 64 bytes in the 64-byte swizzle
//   (16-byte chunk c of row n at chunk c ^ ((n / 2) % 4)), k in order; the
//   activations are rounded as their fragments are read, and each stage is
//   two wgmma m64n(H/2)k16 .bf16 (fp32 accumulation), promoted as above;
//   the head rounds its operands too (the JAX head is a _dot). Bound: one
//   bf16 product per product, 127 GFLOP per chunk at 989 TFLOP/s, 0.128 ms;
//   kFp32 (highest): the stage image is the 32 rows of fp32 weights as they
//   are ([32][H], row-major), and the consumers run FFMAs on the CUDA cores
//   over it, each thread owning the outputs its wgmma fragment would hold:
//   the plain fp32 function up to the order of the sums. Bound: 127 GFLOP
//   at the 67 TFLOP/s fp32 CUDA-core rate, 1.9 ms.
// No atomic operations on the device: two runs of a call agree bit for bit.
// The launchers return cudaGetLastError() (or the first failing call), and
// the Python wrappers raise when it is not cudaSuccess.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTileP = 64;          // points per trunk tile (wgmma's M)
constexpr int kWarpgroups = 2;      // consumer warpgroups
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kStageK = 32;         // input rows per weight stage (128 bytes of k)
constexpr int kRingBytes = 128 * 1024;
constexpr int kActPad = 8;          // activation row stride H + 8 (8 mod 32)
constexpr int kXLd = kStageK + kActPad;  // row stride of a layer-0 input stage (8 mod 32)
constexpr int kOutPad = 128;        // packed head columns [r, g, b, sigma, 0...]
constexpr int kHead = 4;            // live head columns
constexpr int kPassCols = 128;      // columns per pass of a layer wider than 256
constexpr int kMaxCtas = 160;       // persistent CTAs at most (an H100 has 132 SMs)
constexpr int kRaysPerCta = 8;      // composite: one warp per ray
constexpr int kProducerRegs = 40;   // setmaxnreg: the producer warpgroup gives registers
constexpr int kConsumerRegs = 232;  // to the consumer warpgroups
constexpr int kMaxGridY = 65535;    // a launch's grid rows
constexpr float kFar = 1e10f;
constexpr float kEps = 1e-10f;
// Precision routes (render/kernels.py ROUTES)
constexpr int kTf32x3 = 0;  // compute_dtype float32
constexpr int kBf16 = 1;    // compute_dtype bfloat16
constexpr int kFp32 = 2;    // compute_dtype highest
constexpr int kAnyH = 0;    // the width-generic build's template width (H read at run time)
constexpr int kMaxFixedH = 512;  // the widest build with a width of its own
constexpr int kStreamRing = 216 * 1024;     // the generic build's ring: weights and inputs
constexpr int kSliceFloats = kTileP * kXLd;  // an input slice: 64 points x 32 columns, rows of 40

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Sizes shared by the launcher and nerf_fwd_scratch_floats; the scratch
// holds the stage images from offset 0 (sized for the float32 route's, the
// largest), then the head outputs at out4, then (H > 256) the finished
// passes' outputs of each persistent CTA at held (above kMaxFixedH: the
// CTA's two 64 x H layer images).
struct Layout {
  int N, Np, tiles, ctas, stages0, stages;  // stages0: of layer 0; stages: all layers, full width
  size_t out4, held, total;
};

// Passes of a layer, and the floats a CTA keeps of its finished passes: a
// consumer thread's kPassCols / 4 accumulators each; the generic build keeps
// its tile's x and two layer images whole, in slices of 64 x 32.
int passes(int H) { return H > 256 ? H / kPassCols : 1; }
size_t held_floats(int H, int D) {
  if (H > kMaxFixedH)
    return static_cast<size_t>(cdiv(D, kStageK) + 2 * (H / kStageK)) * kSliceFloats;
  return static_cast<size_t>(passes(H) - 1) * (kPassCols / 4) * kConsumers;
}

Layout make_layout(int R, int S, int D, int H, int L1) {
  Layout s;
  s.N = R * S;
  s.tiles = cdiv(s.N, kTileP);
  s.Np = s.tiles * kTileP;
  s.ctas = s.tiles < kMaxCtas ? s.tiles : kMaxCtas;
  s.stages0 = cdiv(D, kStageK);
  s.stages = s.stages0 + L1 * (H / kStageK);
  s.out4 = 2 * static_cast<size_t>(H) * kStageK * s.stages;
  s.held = s.out4 + static_cast<size_t>(kHead) * s.Np;
  s.total = s.held + held_floats(H, D) * s.ctas;
  return s;
}

// ---- PTX wrappers: mbarriers, bulk copies, wgmma ----

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

// Orders this thread's generic writes to global memory before later reads
// of it by the async proxy (the producer's bulk copies).
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
// groups 512 bytes apart; the start advances 32 bytes per bf16 k-step of 16.
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

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
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

// v ~ hi + lo to ~2^-22 relative (v - hi is exact in fp32) by integer
// operations: adding half of the 13 dropped bits to the magnitude and
// clearing them rounds to nearest, ties away from zero, as cvt.rna.tf32.f32
// does for a finite v.
__device__ __forceinline__ uint32_t rna_bits(uint32_t b) { return (b + 0x1000u) & 0xffffe000u; }
__device__ __forceinline__ void split_fast(float v, uint32_t& hi, uint32_t& lo) {
  hi = rna_bits(__float_as_uint(v));
  lo = rna_bits(__float_as_uint(v - __uint_as_float(hi)));
}

// ---- launch 1: the weights' stage images ----

// H == kAnyH: the width-generic build (STREAM), any H % 128 == 0 above
// kMaxFixedH, the passes of the fixed widths above 256 with NPASS = H / 128
// at run time (NPASS reads 0 here).
template <int H, int ROUTE>
struct Trunk {
  static constexpr bool STREAM = H == kAnyH;  // every layer's input copied into the ring
  static constexpr int NPASS = STREAM ? 0 : (H > 256 ? H / kPassCols : 1);  // column passes of a layer
  static constexpr int PW = STREAM ? kPassCols : H / NPASS;  // columns per pass
  static constexpr int NW = PW / kWarpgroups;    // output columns per warpgroup and pass
  static constexpr int NR = NW / 2;              // accumulator registers per thread
  // a pass's stage image: [hi | lo] TF32 halves, the bf16 rounding, or the fp32 rows
  static constexpr int kStageBytes = ROUTE == kTf32x3 ? 2 * PW * kStageK * 4
                                                      : (ROUTE == kBf16 ? PW * kStageK * 2
                                                                        : PW * kStageK * 4);
  // a ring slot: the stage image, and (STREAM) the stage's input slice
  static constexpr int kSlotBytes = kStageBytes + (STREAM ? kSliceFloats * 4 : 0);
  static constexpr int kRing = STREAM ? kStreamRing / kSlotBytes * kSlotBytes
                               : (H <= 256 ? kRingBytes : (H == 384 ? 96 * 1024 : 64 * 1024));
  static constexpr int NS = kRing / kSlotBytes;  // ring depth
  static_assert(NS >= 2 && H % (kWarpgroups * 32) == 0, "at least two stages");
};

// Stage `stage` (one 32-row slice of w0 or of one wh layer), columns
// [32*blockIdx.x, +32): a 32 x 32 tile through shared memory, read along n,
// written along the k-slots (or, kFp32, along n) of the image of the pass
// that owns the columns. The images go in the consumers' order: per layer,
// pass after pass, each over the layer's stages. Hr: the width of the
// generic build (H == kAnyH).
template <int H0, int ROUTE>
__global__ void __launch_bounds__(256)
fwd_split_kernel(const float* __restrict__ w0, const float* __restrict__ wh,
                 float* __restrict__ wsplit, int D, int stages0, int y0, int Hr) {
  using T = Trunk<H0, ROUTE>;
  const int H = T::STREAM ? Hr : H0;
  const int npass = T::STREAM ? H / kPassCols : T::NPASS;
  __shared__ float tile[kStageK][33];
  const int stage = y0 + blockIdx.y;
  const int pass = blockIdx.x * 32 / T::PW;
  const int nb = blockIdx.x * 32 - pass * T::PW;  // the first column within the pass
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int per = H / kStageK;
  const float* W;
  int k0, K, image;
  if (stage < stages0) {
    W = w0;
    k0 = stage * kStageK;
    K = D;
    image = pass * stages0 + stage;
  } else {
    const int layer = (stage - stages0) / per, sl = (stage - stages0) % per;
    W = wh + static_cast<size_t>(layer) * H * H;
    k0 = sl * kStageK;
    K = H;
    image = npass * stages0 + (layer * npass + pass) * per + sl;
  }
  for (int r = ty; r < kStageK; r += 8)
    tile[r][tx] = k0 + r < K ? W[static_cast<size_t>(k0 + r) * H + blockIdx.x * 32 + tx] : 0.f;
  __syncthreads();
  uint8_t* img_bytes =
      reinterpret_cast<uint8_t*>(wsplit) + static_cast<size_t>(image) * T::kStageBytes;
  if constexpr (ROUTE == kFp32) {
    float* img = reinterpret_cast<float*>(img_bytes);
    for (int r = ty; r < kStageK; r += 8) img[r * T::PW + nb + tx] = tile[r][tx];
    return;
  } else if constexpr (ROUTE == kBf16) {
    // row n's k-slot tx, in 16-byte chunk tx / 8 of its 64 bytes, swizzled
    uint16_t* img = reinterpret_cast<uint16_t*>(img_bytes);
    for (int r = ty; r < 32; r += 8) {
      const int n = nb + r;
      const int pos = n * kStageK + ((((tx >> 3) ^ ((n >> 1) & 3))) << 3) + (tx & 7);
      img[pos] = static_cast<uint16_t>(pack_bf16(0.f, tile[tx][r]) >> 16);
    }
    return;
  }
  // k-slot tx of a row holds input row 8*(tx/8) + (j < 4 ? 2j : 2j - 7), j = tx % 8
  const int j = tx & 7;
  const int src = (tx & ~7) + (j < 4 ? 2 * j : 2 * j - 7);
  float* img = reinterpret_cast<float*>(img_bytes);
  for (int r = ty; r < 32; r += 8) {
    const int n = nb + r;
    const float v = tile[src][r];
    const uint32_t hi = tf32_rna(v);
    const uint32_t lo = tf32_rna(v - __uint_as_float(hi));
    const int pos = n * kStageK + ((((tx >> 2) ^ (n & 7))) << 2) + (tx & 3);
    img[pos] = __uint_as_float(hi);
    img[T::PW * kStageK + pos] = __uint_as_float(lo);
  }
}

// ---- launch 2: the trunk ----

// Dynamic shared memory, whatever D: the stage ring (1024-byte aligned),
// the activation tile, two layer-0 input stages, wout's live columns, the
// mbarriers; the generic build holds the ring of weight stages and input
// slices and the mbarriers alone, the same at every width.
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
              "fwd_trunk's shared memory fits a block");

// The generic build's images of a CTA in held: its tile's x (cdiv(D, 32)
// slices), then the outputs of even and of odd layers (H / 32 slices each);
// a slice is 64 points x 32 columns in rows of kXLd floats, one bulk copy.
__device__ __forceinline__ float* cta_images(float* held, int D, int H) {
  return held + static_cast<size_t>(blockIdx.x) * (cdiv(D, kStageK) + 2 * (H / kStageK)) *
                    kSliceFloats;
}

// The two consumer warpgroups of fwd_trunk_kernel. The generic build (H0
// == kAnyH, width Hr) holds no activation tile: it writes x, then each
// layer's relu(acc + b), pass by pass, to the CTA's images in held
// (L2-resident), and the producer copies each stage's input slice from
// them into the ring slot beside the stage's weights, once the layer
// before is written (`ready`: every consumer warp arrives after a proxy
// fence). The consumers read their A fragments from the slot as from a
// STAGED layer 0's buffers; the head reads the last image, and wout's
// columns from global memory. The same fragments in the same k order: a
// column's sums are the column-pass design's.
template <int H0, bool INLINE_PE, bool STAGED, int ROUTE>
__device__ __forceinline__ void fwd_trunk_consumer(
    const float* __restrict__ in, const float* __restrict__ feats, const float* __restrict__ e2,
    const float* __restrict__ c, const float* __restrict__ b0, const float* __restrict__ bh,
    const float* __restrict__ wout, const float* __restrict__ bout, float* __restrict__ out4,
    int N, int Np, int tiles, int n_raw, int n_phase, int Fd, int D, int L1, int Hr,
    uint32_t ring, const uint8_t* ring_ptr, float* __restrict__ act, float* __restrict__ xbuf,
    float* __restrict__ whead, float* __restrict__ held, uint32_t full0, uint32_t empty0,
    uint32_t ready) {
  using T = Trunk<H0, ROUTE>;
  const int H = T::STREAM ? Hr : H0;
  const int npass = T::STREAM ? H / kPassCols : T::NPASS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;                       // warpgroup: pass columns [wg*NW, +NW)
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;             // fragment rows r0, r0 + 8
  const int cw = wg * T::NW;
  constexpr int ld = H0 + kActPad;
  float acc[T::NR], part[T::NR];
#pragma unroll
  for (int i = 0; i < T::NR; ++i) part[i] = 0.f;
  int it = 0;
  // this thread's accumulators of finished pass `pass` in the CTA's held
  // buffer, accumulator i at [i * kConsumers]
  auto held_at = [&](int pass) {
    return held + (static_cast<size_t>(blockIdx.x) * (T::NPASS - 1) + pass) * T::NR * kConsumers +
           tid;
  };
  // the generic build's images: x's, and layer l's output (the next layer's input)
  float* ximg = T::STREAM ? cta_images(held, D, H) : nullptr;
  auto img = [&](int l) {
    return ximg + (cdiv(D, kStageK) + (l & 1) * (H / kStageK)) * kSliceFloats;
  };
  // (generic build) the layer's images are written: the producer may copy them
  auto images_ready = [&]() {
    fence_proxy_async_global();
    __syncwarp();
    if (lane == 0) mbar_arrive(ready);
  };
  // the head's four live columns, once per CTA (rounded to bf16 on that route)
  for (int e = tid; e < H0 * kHead; e += kConsumers) {
    if constexpr (ROUTE == kBf16)
      whead[e] = round_bf16(__ldg(wout + (e / kHead) * kOutPad + e % kHead));
    else
      whead[e] = __ldg(wout + (e / kHead) * kOutPad + e % kHead);
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile * kTileP;
    // columns [32*sl, +32) of layer 0's input to dst[p*ldd + j], point-major
    // (reads along each point's row); columns past D are 0
    auto build_x = [&](int sl, float* dst, int ldd) {
      for (int idx = tid; idx < kTileP * kStageK; idx += kConsumers) {
        const int p = idx / kStageK;
        const int j = idx % kStageK;
        const int k = sl * kStageK + j;
        const int n = n0 + p;
        float v = 0.f;
        if (n < N && k < D) {
          if (INLINE_PE) {
            const float* r = in + static_cast<size_t>(n) * n_raw;
            if (k < n_raw) {
              v = r[k];
            } else if (k < n_raw + n_phase) {
              const int col = k - n_raw;
              float a = c[col];
              for (int d = 0; d < n_raw; ++d)
                a = __fadd_rn(a, __fmul_rn(r[d], e2[d * n_phase + col]));
              v = sinf(a);
            } else if (k < n_raw + n_phase + Fd) {
              v = feats[static_cast<size_t>(n) * Fd + (k - n_raw - n_phase)];
            }
          } else {
            v = in[static_cast<size_t>(n) * D + k];
          }
        }
        dst[p * ldd + j] = v;
      }
    };
    auto xstage = [&](int sl) { return xbuf + (sl & 1) * kTileP * kXLd; };
    if constexpr (T::STREAM) {  // x, every slice, into its image
      for (int sl = 0; sl < cdiv(D, kStageK); ++sl) build_x(sl, ximg + sl * kSliceFloats, kXLd);
      images_ready();
    }

    for (int l = 0; l <= L1; ++l) {
      const int K = l ? H : D;
      const int nst = (K + kStageK - 1) / kStageK;
      const bool from_tile = !T::STREAM && (!STAGED || l > 0);
      const bool staged = !T::STREAM && !from_tile;  // built here, stage by stage
      // the input rows of stage sl (the ring's `ahead` stages past `it`),
      // point-major: the tile's, a STAGED layer 0's stage buffer, or (the
      // generic build) the ring slot's slice, once it has landed
      auto a_src = [&](int sl, int ahead) -> const float* {
        if constexpr (T::STREAM) {
          const int i = it + ahead;
          mbar_wait(full0 + 8 * (i % T::NS), (i / T::NS) & 1);
          return reinterpret_cast<const float*>(ring_ptr + (i % T::NS) * T::kSlotBytes +
                                                T::kStageBytes);
        } else {
          return from_tile ? act + sl * kStageK : xstage(sl);
        }
      };
      const int sld = from_tile ? ld : kXLd;
      if (l == 0 && !T::STREAM) {  // the first stage, or the whole input into the tile
        if (STAGED)
          build_x(0, xstage(0), kXLd);
        else
          for (int sl = 0; sl < nst; ++sl) build_x(sl, act + sl * kStageK, ld);
        consumers_sync();
      }
      // columns [pass*PW, +PW) of the layer's output, warpgroup wg's NW of
      // them from the pass's images
      for (int pass = 0; pass < npass; ++pass) {
        if (pass > 0 && staged) {  // layer 0's first stage again, once every warp is past it
          consumers_sync();
          build_x(0, xstage(0), kXLd);
          consumers_sync();
        }
#pragma unroll
        for (int i = 0; i < T::NR; ++i) acc[i] = 0.f;
        if constexpr (ROUTE == kFp32) {
          // FFMAs over the stage's fp32 rows; K is a multiple of 16
          for (int sl = 0; sl < nst; ++sl) {
            const int s = it % T::NS;
            const int rows = K - sl * kStageK >= kStageK ? kStageK : 16;
            mbar_wait(full0 + 8 * s, (it / T::NS) & 1);
            const float* w =
                reinterpret_cast<const float*>(ring_ptr + s * T::kSlotBytes) + cw + 2 * t;
            const float* src = a_src(sl, 0);
#pragma unroll 4
            for (int k = 0; k < rows; ++k) {
              const float a0 = src[r0 * sld + k], a1 = src[(r0 + 8) * sld + k];
#pragma unroll
              for (int j = 0; j < T::NW / 8; ++j) {
                const float2 b = *reinterpret_cast<const float2*>(w + k * T::PW + 8 * j);
                acc[4 * j] = fmaf(a0, b.x, acc[4 * j]);
                acc[4 * j + 1] = fmaf(a0, b.y, acc[4 * j + 1]);
                acc[4 * j + 2] = fmaf(a1, b.x, acc[4 * j + 2]);
                acc[4 * j + 3] = fmaf(a1, b.y, acc[4 * j + 3]);
              }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage is free again
            if (sl + 1 < nst && staged) {  // its buffer was last read before the last sync
              build_x(sl + 1, xstage(sl + 1), kXLd);
              consumers_sync();
            }
            ++it;
          }
        } else if constexpr (ROUTE == kBf16) {
          // A fragments of stage sl's two k-steps of 16, rounded to bf16
          auto load_a = [&](int sl, int ahead, uint32_t (&a)[2][4]) {
            const int live = K - sl * kStageK >= kStageK ? 2 : 1;
            const float* src = a_src(sl, ahead);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              if (q < live) {
                const float* p = src + r0 * sld + 16 * q + 2 * t;
                const float2 u = *reinterpret_cast<const float2*>(p);
                const float2 v = *reinterpret_cast<const float2*>(p + 8);
                const float2 w = *reinterpret_cast<const float2*>(p + 8 * sld);
                const float2 x = *reinterpret_cast<const float2*>(p + 8 * sld + 8);
                a[q][0] = pack_bf16(u.x, u.y);
                a[q][1] = pack_bf16(w.x, w.y);
                a[q][2] = pack_bf16(v.x, v.y);
                a[q][3] = pack_bf16(x.x, x.y);
              }
            }
          };
          auto stage = [&](int sl, uint32_t (&a)[2][4], uint32_t (&next)[2][4]) {
            const int s = it % T::NS;
            const int live = K - sl * kStageK >= kStageK ? 2 : 1;
            mbar_wait(full0 + 8 * s, (it / T::NS) & 1);
            const uint32_t img = ring + s * T::kSlotBytes + cw * (kStageK * 2);
            fence_regs(part);
            wgmma_fence();
#pragma unroll
            for (int q = 0; q < 2; ++q)
              if (q < live) wgmma_bf16<T::NW>(part, a[q], sw64_desc(img + 32 * q), q > 0);
            wgmma_commit();
            if (sl + 1 < nst) {
              if (staged) {  // its buffer was last read by load_a(sl - 1), before the last sync
                build_x(sl + 1, xstage(sl + 1), kXLd);
                consumers_sync();
              }
              load_a(sl + 1, 1, next);
            }
            wgmma_wait_all();
            fence_regs(part);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage is free again
#pragma unroll
            for (int i = 0; i < T::NR; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
            ++it;
          };
          uint32_t a0[2][4], a1[2][4];
          load_a(0, 0, a0);
          for (int sl = 0; sl < nst; sl += 2) {
            stage(sl, a0, a1);
            if (sl + 1 < nst) stage(sl + 1, a1, a0);
          }
        } else {
          // A fragments of stage sl's k-steps, split into TF32 halves; K is a
          // multiple of 16, so a stage has 2 or 4 live k-steps.
          auto load_a = [&](int sl, int ahead, uint32_t (&ahi)[4][4], uint32_t (&alo)[4][4]) {
            const int kbase = sl * kStageK;
            const int live = K - kbase >= kStageK ? 4 : 2;
            const float* src = a_src(sl, ahead);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (q < live) {
                const float* a0p = src + r0 * sld + 8 * q + 2 * t;
                const float2 u = *reinterpret_cast<const float2*>(a0p);
                const float2 w = *reinterpret_cast<const float2*>(a0p + 8 * sld);
                split_fast(u.x, ahi[q][0], alo[q][0]);
                split_fast(w.x, ahi[q][1], alo[q][1]);
                split_fast(u.y, ahi[q][2], alo[q][2]);
                split_fast(w.y, ahi[q][3], alo[q][3]);
              }
            }
          };
          // stage sl from the fragments in (ahi, alo); the next stage's are read
          // into (nhi, nlo) while the tensor cores run
          auto stage = [&](int sl, uint32_t (&ahi)[4][4], uint32_t (&alo)[4][4],
                           uint32_t (&nhi)[4][4], uint32_t (&nlo)[4][4]) {
            const int s = it % T::NS;
            const int live = K - sl * kStageK >= kStageK ? 4 : 2;
            mbar_wait(full0 + 8 * s, (it / T::NS) & 1);
            const uint32_t hi_img = ring + s * T::kSlotBytes + cw * (kStageK * 4);
            const uint32_t lo_img = hi_img + T::PW * kStageK * 4;
            fence_regs(part);
            wgmma_fence();
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (q < live) {
                wgmma_tf32<T::NW>(part, alo[q], sw128_desc(hi_img + 32 * q), q > 0);
                wgmma_tf32<T::NW>(part, ahi[q], sw128_desc(lo_img + 32 * q), 1);
                wgmma_tf32<T::NW>(part, ahi[q], sw128_desc(hi_img + 32 * q), 1);
              }
            }
            wgmma_commit();
            if (sl + 1 < nst) {
              if (staged) {  // its buffer was last read by load_a(sl - 1), before the last sync
                build_x(sl + 1, xstage(sl + 1), kXLd);
                consumers_sync();
              }
              load_a(sl + 1, 1, nhi, nlo);
            }
            wgmma_wait_all();
            fence_regs(part);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage is free again
#pragma unroll
            for (int i = 0; i < T::NR; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
            ++it;
          };
          uint32_t h0[4][4], l0[4][4], h1[4][4], l1[4][4];
          load_a(0, 0, h0, l0);
          for (int sl = 0; sl < nst; sl += 2) {
            stage(sl, h0, l0, h1, l1);
            if (sl + 1 < nst) stage(sl + 1, h1, l1, h0, l0);
          }
        }
        if constexpr (T::STREAM) {  // relu(acc + b) to the layer's image
          const float* bias = (l ? bh + static_cast<size_t>(l - 1) * H : b0) + pass * T::PW + cw;
#pragma unroll
          for (int j = 0; j < T::NW / 8; ++j) {
            const int col = pass * T::PW + cw + 8 * j + 2 * t;
            float* o = img(l) + (col / kStageK) * kSliceFloats + col % kStageK;
            const float bb0 = __ldg(bias + 8 * j + 2 * t), bb1 = __ldg(bias + 8 * j + 2 * t + 1);
            *reinterpret_cast<float2*>(o + r0 * kXLd) =
                make_float2(fmaxf(acc[4 * j] + bb0, 0.f), fmaxf(acc[4 * j + 1] + bb1, 0.f));
            *reinterpret_cast<float2*>(o + (r0 + 8) * kXLd) =
                make_float2(fmaxf(acc[4 * j + 2] + bb0, 0.f), fmaxf(acc[4 * j + 3] + bb1, 0.f));
          }
        } else if (pass + 1 < T::NPASS) {  // a finished pass: relu(acc + b) waits until the tile is free
          const float* bias = (l ? bh + static_cast<size_t>(l - 1) * H : b0) + pass * T::PW + cw;
          float* hp = held_at(pass);
#pragma unroll
          for (int j = 0; j < T::NW / 8; ++j) {
            const float bb0 = __ldg(bias + 8 * j + 2 * t), bb1 = __ldg(bias + 8 * j + 2 * t + 1);
            hp[(4 * j) * kConsumers] = fmaxf(acc[4 * j] + bb0, 0.f);
            hp[(4 * j + 1) * kConsumers] = fmaxf(acc[4 * j + 1] + bb1, 0.f);
            hp[(4 * j + 2) * kConsumers] = fmaxf(acc[4 * j + 2] + bb0, 0.f);
            hp[(4 * j + 3) * kConsumers] = fmaxf(acc[4 * j + 3] + bb1, 0.f);
          }
        }
      }
      if (T::STREAM && l < L1) images_ready();  // the next layer's input
      consumers_sync();  // every warp is done reading the layer's input (streamed: writing it)
      if constexpr (!T::STREAM) {  // over the tile: the last pass, then the finished passes
        const float* bias = l ? bh + static_cast<size_t>(l - 1) * H : b0;
        const int c0 = (T::NPASS - 1) * T::PW + cw;  // the last pass's columns
#pragma unroll
        for (int j = 0; j < T::NW / 8; ++j) {
          const int col = c0 + 8 * j + 2 * t;
          const float bb0 = __ldg(bias + col), bb1 = __ldg(bias + col + 1);
          *reinterpret_cast<float2*>(act + r0 * ld + col) =
              make_float2(fmaxf(acc[4 * j] + bb0, 0.f), fmaxf(acc[4 * j + 1] + bb1, 0.f));
          *reinterpret_cast<float2*>(act + (r0 + 8) * ld + col) =
              make_float2(fmaxf(acc[4 * j + 2] + bb0, 0.f), fmaxf(acc[4 * j + 3] + bb1, 0.f));
        }
        for (int pass = 0; pass + 1 < T::NPASS; ++pass) {  // and the finished passes'
          const float* hp = held_at(pass);
#pragma unroll
          for (int j = 0; j < T::NW / 8; ++j) {
            const int col = pass * T::PW + cw + 8 * j + 2 * t;
            *reinterpret_cast<float2*>(act + r0 * ld + col) =
                make_float2(hp[(4 * j) * kConsumers], hp[(4 * j + 1) * kConsumers]);
            *reinterpret_cast<float2*>(act + (r0 + 8) * ld + col) =
                make_float2(hp[(4 * j + 2) * kConsumers], hp[(4 * j + 3) * kConsumers]);
          }
        }
        consumers_sync();
      }
    }

    // head, fp32 FMAs (bf16-rounded operands on that route): thread ->
    // (point, output column)
    if (tid < kTileP * kHead) {
      const int p = tid >> 2;
      const int o = tid & 3;
      float s = 0.f;
      if constexpr (T::STREAM) {  // the last layer's image, wout's columns from global memory
        const float* h = img(L1) + p * kXLd;
#pragma unroll 16
        for (int k = 0; k < H; ++k) {
          const float v = h[(k / kStageK) * kSliceFloats + k % kStageK];
          const float w = __ldg(wout + k * kOutPad + o);
          if constexpr (ROUTE == kBf16)
            s = fmaf(round_bf16(v), round_bf16(w), s);
          else
            s = fmaf(v, w, s);
        }
      } else {
#pragma unroll 16
        for (int k = 0; k < H0; ++k) {
          if constexpr (ROUTE == kBf16)
            s = fmaf(round_bf16(act[p * ld + k]), whead[k * kHead + o], s);
          else
            s = fmaf(act[p * ld + k], whead[k * kHead + o], s);
        }
      }
      s += __ldg(bout + o);
      out4[static_cast<size_t>(o) * Np + n0 + p] = s;
    }
    consumers_sync();  // the head has read the tile before the next input build
  }
}

template <int H0, bool INLINE_PE, bool STAGED, int ROUTE>
__global__ void __launch_bounds__(kThreads, 1)
fwd_trunk_kernel(const float* __restrict__ in, const float* __restrict__ feats,
                 const float* __restrict__ e2, const float* __restrict__ c,
                 const float* __restrict__ wsplit, const float* __restrict__ b0,
                 const float* __restrict__ bh, const float* __restrict__ wout,
                 const float* __restrict__ bout, float* __restrict__ out4,
                 float* __restrict__ held, int N, int Np, int tiles, int n_raw, int n_phase,
                 int Fd, int D, int L1, int Hr) {
  using T = Trunk<H0, ROUTE>;
  const int H = T::STREAM ? Hr : H0;
  const int npass = T::STREAM ? H / kPassCols : T::NPASS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw_addr & 1023)) & 1023);
  const uint32_t ring = smem_u32(base);
  // the tile (64, H + 8), two (64, 40) input stages, wout's live columns
  // (H, 4); the generic build has the mbarriers alone after its ring
  float* act = T::STREAM ? nullptr : reinterpret_cast<float*>(base + T::kRing);
  float* xbuf = T::STREAM ? nullptr : act + kTileP * (H0 + kActPad);
  float* whead = T::STREAM ? nullptr : xbuf + 2 * kTileP * kXLd;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      T::STREAM ? base + T::kRing : reinterpret_cast<uint8_t*>(whead + H0 * kHead));
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + T::NS);
  const uint32_t ready = smem_u32(bars + 2 * T::NS);  // (generic build) a layer's input written

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int stages0 = (D + kStageK - 1) / kStageK;
  const int stages = npass * (stages0 + L1 * (H / kStageK));  // pass images per tile

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
      const uint8_t* images = reinterpret_cast<const uint8_t*>(wsplit);
      int it = 0;
      if constexpr (T::STREAM) {
        // per layer, once its input is written: every pass's stages, each
        // the weights' stage image and the input slice from the CTA's images
        const float* ximg = cta_images(held, D, H);
        int round = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          int st = 0;
          for (int l = 0; l <= L1; ++l) {
            mbar_wait(ready, round++ & 1);
            const float* src =
                ximg + (l ? stages0 + ((l - 1) & 1) * (H / kStageK) : 0) * kSliceFloats;
            const int nst = l ? H / kStageK : stages0;
            for (int pass = 0; pass < npass; ++pass)
              for (int sl = 0; sl < nst; ++sl, ++st, ++it) {
                const int s = it % T::NS;
                mbar_wait(empty0 + 8 * s, ((it / T::NS) & 1) ^ 1);
                mbar_arrive_expect_tx(full0 + 8 * s, T::kSlotBytes);
                bulk_copy(ring + s * T::kSlotBytes,
                          images + static_cast<size_t>(st) * T::kStageBytes, T::kStageBytes,
                          full0 + 8 * s);
                bulk_copy(ring + s * T::kSlotBytes + T::kStageBytes, src + sl * kSliceFloats,
                          kSliceFloats * 4, full0 + 8 * s);
              }
          }
        }
      } else {
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
          for (int st = 0; st < stages; ++st, ++it) {
            const int s = it % T::NS;
            mbar_wait(empty0 + 8 * s, ((it / T::NS) & 1) ^ 1);
            mbar_arrive_expect_tx(full0 + 8 * s, T::kStageBytes);
            bulk_copy(ring + s * T::kStageBytes,
                      images + static_cast<size_t>(st) * T::kStageBytes, T::kStageBytes,
                      full0 + 8 * s);
          }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    fwd_trunk_consumer<H0, INLINE_PE, STAGED, ROUTE>(in, feats, e2, c, b0, bh, wout, bout, out4,
                                                     N, Np, tiles, n_raw, n_phase, Fd, D, L1, Hr,
                                                     ring, base, act, xbuf, whead, held, full0,
                                                     empty0, ready);
  }
}

// ---- launch 3: compositing, one warp per ray ----

__global__ void __launch_bounds__(32 * kRaysPerCta)
fwd_composite_kernel(const float* __restrict__ out4, const float* __restrict__ z,
                     const float* __restrict__ dnorm, float* __restrict__ rgb,
                     float* __restrict__ depth, float* __restrict__ acc,
                     float* __restrict__ weights, int R, int S, int Np, int white_bkgd) {
  const int ray = blockIdx.x * kRaysPerCta + (threadIdx.x >> 5);
  if (ray >= R) return;
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  const float dn = dnorm[ray];
  const size_t nb = static_cast<size_t>(ray) * S;
  const float* zr = z + nb;
  float* wr = weights + nb;
  float carry = 0.f;
  float r0 = 0.f, r1 = 0.f, r2 = 0.f, dep = 0.f, accw = 0.f;
  for (int base = 0; base < S; base += 32) {
    const int i = base + lane;
    float lg = 0.f, alpha = 0.f, zi = 0.f;
    if (i < S) {
      zi = zr[i];
      const float dist = (i + 1 < S ? zr[i + 1] - zi : kFar) * dn;
      const float ea = expf(-fmaxf(out4[3 * static_cast<size_t>(Np) + nb + i], 0.f) * dist);
      alpha = 1.f - ea;
      lg = logf(ea + kEps);
    }
    float incl = lg;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(full, incl, off);
      if (lane >= off) incl += v;
    }
    incl += carry;
    carry = __shfl_sync(full, incl, 31);
    if (i < S) {
      const float w = alpha * expf(incl - lg);
      float rs[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        rs[ch] = 1.f / (1.f + expf(-out4[static_cast<size_t>(ch) * Np + nb + i]));
      wr[i] = w;
      r0 = fmaf(w, rs[0], r0);
      r1 = fmaf(w, rs[1], r1);
      r2 = fmaf(w, rs[2], r2);
      dep = fmaf(w, zi, dep);
      accw += w;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r0 += __shfl_xor_sync(full, r0, off);
    r1 += __shfl_xor_sync(full, r1, off);
    r2 += __shfl_xor_sync(full, r2, off);
    dep += __shfl_xor_sync(full, dep, off);
    accw += __shfl_xor_sync(full, accw, off);
  }
  if (lane == 0) {
    const float bg = white_bkgd ? 1.f - accw : 0.f;
    rgb[3 * ray + 0] = r0 + bg;
    rgb[3 * ray + 1] = r1 + bg;
    rgb[3 * ray + 2] = r2 + bg;
    depth[ray] = dep;
    acc[ray] = accw;
  }
}

// H0: a fixed width's build, or kAnyH (the generic build) at width H.
template <int H0, bool INLINE_PE, int ROUTE>
cudaError_t launch(const float* in, const float* feats, const float* z, const float* dnorm,
                   const float* e2, const float* c, const float* w0, const float* b0,
                   const float* wh, const float* bh, const float* wout, const float* bout,
                   float* rgb, float* depth, float* acc, float* weights, float* scratch, int R,
                   int S, int n_raw, int n_phase, int Fd, int D, int H, int L1, int white_bkgd,
                   int device, cudaStream_t st) {
  const Layout lay = make_layout(R, S, D, H, L1);
  float* wsplit = scratch;
  float* out4 = scratch + lay.out4;
  float* held = scratch + lay.held;
  cudaError_t err;
  for (int y0 = 0; y0 < lay.stages; y0 += kMaxGridY) {  // any depth: grids of kMaxGridY rows
    const int n = lay.stages - y0 < kMaxGridY ? lay.stages - y0 : kMaxGridY;
    fwd_split_kernel<H0, ROUTE><<<dim3(H / 32, n), 256, 0, st>>>(w0, wh, wsplit, D, lay.stages0,
                                                                 y0, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  constexpr size_t smem = trunk_smem<H0, ROUTE>();
  // an input wider than the activation tile streams through the stage
  // buffers, as does every input of the generic build
  const auto trunk = D > H0 ? fwd_trunk_kernel<H0, INLINE_PE, true, ROUTE>
                            : fwd_trunk_kernel<H0, INLINE_PE, Trunk<H0, ROUTE>::STREAM, ROUTE>;
  err = cudaFuncSetAttribute(trunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int grid = lay.ctas < sms ? lay.ctas : sms;  // persistent CTAs
  trunk<<<grid, kThreads, smem, st>>>(
      in, feats, e2, c, wsplit, b0, bh, wout, bout, out4, held, lay.N, lay.Np, lay.tiles, n_raw,
      n_phase, Fd, D, L1, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  fwd_composite_kernel<<<cdiv(R, kRaysPerCta), 32 * kRaysPerCta, 0, st>>>(
      out4, z, dnorm, rgb, depth, acc, weights, R, S, lay.Np, white_bkgd);
  return cudaGetLastError();
}

template <int H0, bool INLINE_PE>
cudaError_t launch_route(int route, const float* in, const float* feats, const float* z,
                         const float* dnorm, const float* e2, const float* c, const float* w0,
                         const float* b0, const float* wh, const float* bh, const float* wout,
                         const float* bout, float* rgb, float* depth, float* acc, float* weights,
                         float* scratch, int R, int S, int n_raw, int n_phase, int Fd, int D,
                         int H, int L1, int white_bkgd, int device, cudaStream_t st) {
  if (route == kBf16)
    return launch<H0, INLINE_PE, kBf16>(in, feats, z, dnorm, e2, c, w0, b0, wh, bh, wout, bout,
                                        rgb, depth, acc, weights, scratch, R, S, n_raw, n_phase,
                                        Fd, D, H, L1, white_bkgd, device, st);
  if (route == kFp32)
    return launch<H0, INLINE_PE, kFp32>(in, feats, z, dnorm, e2, c, w0, b0, wh, bh, wout, bout,
                                        rgb, depth, acc, weights, scratch, R, S, n_raw, n_phase,
                                        Fd, D, H, L1, white_bkgd, device, st);
  return launch<H0, INLINE_PE, kTf32x3>(in, feats, z, dnorm, e2, c, w0, b0, wh, bh, wout, bout,
                                        rgb, depth, acc, weights, scratch, R, S, n_raw, n_phase,
                                        Fd, D, H, L1, white_bkgd, device, st);
}

template <bool INLINE_PE>
int dispatch(const float* in, const float* feats, const float* z, const float* dnorm,
             const float* e2, const float* c, const float* w0, const float* b0, const float* wh,
             const float* bh, const float* wout, const float* bout, float* rgb, float* depth,
             float* acc, float* weights, float* scratch, int R, int S, int n_raw, int n_phase,
             int Fd, int D, int H, int L1, int white_bkgd, int route, int device, void* stream) {
  if (D <= 0 || D % 16 != 0 || R < 1 || S < 1 ||
      static_cast<long long>(R) * S > INT_MAX - kTileP || L1 < 0 || route < kTf32x3 ||
      route > kFp32 || H <= 0 || H % kPassCols != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto at = [&](auto width) {
    return launch_route<decltype(width)::value, INLINE_PE>(
        route, in, feats, z, dnorm, e2, c, w0, b0, wh, bh, wout, bout, rgb, depth, acc, weights,
        scratch, R, S, n_raw, n_phase, Fd, D, H, L1, white_bkgd, device, st);
  };
  // each width up to kMaxFixedH its own build; every wider one the generic build
  switch (H) {
    case 128: return at(std::integral_constant<int, 128>{});
    case 256: return at(std::integral_constant<int, 256>{});
    case 384: return at(std::integral_constant<int, 384>{});
    case 512: return at(std::integral_constant<int, 512>{});
    default:  // H % 128 == 0 past the fixed builds
      return H > kMaxFixedH ? at(std::integral_constant<int, kAnyH>{}) : cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of the scratch nerf_fwd_pe and nerf_fwd_x need: the weights' stage
// images (the float32 route's TF32 halves, the largest) and the four raw
// head outputs of every point.
extern "C" unsigned long long nerf_fwd_scratch_floats(int R, int S, int D, int H, int L1) {
  return make_layout(R, S, D, H, L1).total;
}

// Kernel 2: the inline-PE render from the thin (R*S, n_raw) raw block;
// route: the products' precision route (kTf32x3, kBf16, kFp32).
extern "C" int nerf_fwd_pe(const float* raw, const float* feats, const float* z,
                           const float* dnorm, const float* e2, const float* c,
                           const float* w0, const float* b0, const float* wh, const float* bh,
                           const float* wout, const float* bout, float* rgb, float* depth,
                           float* acc, float* weights, float* scratch, int R, int S, int n_raw,
                           int n_phase, int Fd, int D, int H, int L1, int white_bkgd, int route,
                           int device, void* stream) {
  return dispatch<true>(raw, feats, z, dnorm, e2, c, w0, b0, wh, bh, wout, bout, rgb, depth, acc,
                        weights, scratch, R, S, n_raw, n_phase, Fd, D, H, L1, white_bkgd, route,
                        device, stream);
}

// Kernel 4: the render from a pre-encoded (R*S, D) x.
extern "C" int nerf_fwd_x(const float* x, const float* z, const float* dnorm, const float* w0,
                          const float* b0, const float* wh, const float* bh, const float* wout,
                          const float* bout, float* rgb, float* depth, float* acc,
                          float* weights, float* scratch, int R, int S, int D, int H, int L1,
                          int white_bkgd, int route, int device, void* stream) {
  return dispatch<false>(x, nullptr, z, dnorm, nullptr, nullptr, w0, b0, wh, bh, wout, bout, rgb,
                         depth, acc, weights, scratch, R, S, 0, 0, 0, D, H, L1, white_bkgd, route,
                         device, stream);
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
