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
//      the layer; a wider one (STAGED, up to kMaxD = 896 columns, more than
//      the tile holds beside the ring) is never held whole, each 32-column
//      stage built into one of two small stage buffers, the next one while
//      the current chain runs on the tensor cores. The sums are the same
//      either way, in the same order. The head
//      (exact fp32, wout's live columns staged in shared memory once per
//      CTA) writes the four raw outputs to scratch ([4][Np]).
//   3. fwd_composite: one warp per ray (8 rays per CTA): sigmoid, the
//      log-space scan and the sums, written to rgb, depth, acc, weights.
// Fragments (wgmma m64nNk8 .tf32, warp w of the warpgroup, g = lane/4,
// t = lane%4): A a0 (16w+g, t), a1 (16w+g+8, t), a2 (16w+g, t+4),
// a3 (16w+g+8, t+4); D d[4j+e] at row 16w+g (+8 for e >= 2), column
// 8j+2t (+1 for odd e).
// No atomic operations on the device: two runs of a call agree bit for bit.
// The launchers return cudaGetLastError() (or the first failing call), and
// the Python wrappers raise when it is not cudaSuccess.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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
constexpr int kMaxD = 896;          // widest padded input (7 x 128: the script recipes' 858)
constexpr int kRaysPerCta = 8;      // composite: one warp per ray
constexpr int kProducerRegs = 40;   // setmaxnreg: the producer warpgroup gives registers
constexpr int kConsumerRegs = 232;  // to the consumer warpgroups
constexpr float kFar = 1e10f;
constexpr float kEps = 1e-10f;

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Sizes shared by the launcher and nerf_fwd_scratch_floats; the scratch
// holds the stage images from offset 0, then the head outputs at out4.
struct Layout {
  int N, Np, tiles, stages0, stages;  // stages0: of layer 0; stages: all layers
  size_t out4, total;
};

Layout make_layout(int R, int S, int D, int H, int L1) {
  Layout s;
  s.N = R * S;
  s.tiles = cdiv(s.N, kTileP);
  s.Np = s.tiles * kTileP;
  s.stages0 = cdiv(D, kStageK);
  s.stages = s.stages0 + L1 * (H / kStageK);
  s.out4 = 2 * static_cast<size_t>(H) * kStageK * s.stages;
  s.total = s.out4 + static_cast<size_t>(kHead) * s.Np;
  return s;
}

// ---- PTX wrappers: mbarriers, bulk copies, wgmma ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
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

// v ~ hi + lo to ~2^-22 relative (v - hi is exact in fp32) by integer
// operations: adding half of the 13 dropped bits to the magnitude and
// clearing them rounds to nearest, ties away from zero, as cvt.rna.tf32.f32
// does for a finite v.
__device__ __forceinline__ uint32_t rna_bits(uint32_t b) { return (b + 0x1000u) & 0xffffe000u; }
__device__ __forceinline__ void split_fast(float v, uint32_t& hi, uint32_t& lo) {
  hi = rna_bits(__float_as_uint(v));
  lo = rna_bits(__float_as_uint(v - __uint_as_float(hi)));
}

// ---- launch 1: the weights' TF32 halves as stage images ----

// Stage `stage` (one 32-row slice of w0 or of one wh layer), columns
// [32*blockIdx.x, +32): a 32 x 32 tile through shared memory, read along n,
// written along the k-slots.
__global__ void __launch_bounds__(256)
fwd_split_kernel(const float* __restrict__ w0, const float* __restrict__ wh,
                 float* __restrict__ wsplit, int D, int H, int stages0) {
  __shared__ float tile[kStageK][33];
  const int stage = blockIdx.y;
  const int nb = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float* W;
  int k0, K;
  if (stage < stages0) {
    W = w0;
    k0 = stage * kStageK;
    K = D;
  } else {
    const int per = H / kStageK;
    W = wh + static_cast<size_t>((stage - stages0) / per) * H * H;
    k0 = ((stage - stages0) % per) * kStageK;
    K = H;
  }
  for (int r = ty; r < kStageK; r += 8)
    tile[r][tx] = k0 + r < K ? W[static_cast<size_t>(k0 + r) * H + nb + tx] : 0.f;
  __syncthreads();
  // k-slot tx of a row holds input row 8*(tx/8) + (j < 4 ? 2j : 2j - 7), j = tx % 8
  const int j = tx & 7;
  const int src = (tx & ~7) + (j < 4 ? 2 * j : 2 * j - 7);
  float* img = wsplit + static_cast<size_t>(stage) * 2 * H * kStageK;
  for (int r = ty; r < 32; r += 8) {
    const int n = nb + r;
    const float v = tile[src][r];
    const uint32_t hi = tf32_rna(v);
    const uint32_t lo = tf32_rna(v - __uint_as_float(hi));
    const int pos = n * kStageK + ((((tx >> 2) ^ (n & 7))) << 2) + (tx & 3);
    img[pos] = __uint_as_float(hi);
    img[H * kStageK + pos] = __uint_as_float(lo);
  }
}

// ---- launch 2: the trunk ----

template <int H>
struct Trunk {
  static constexpr int NW = H / kWarpgroups;     // output columns per warpgroup
  static constexpr int NR = NW / 2;              // accumulator registers per thread
  static constexpr int kStageBytes = 2 * H * kStageK * 4;  // [hi | lo]
  static constexpr int NS = kRingBytes / kStageBytes;      // ring depth
  static_assert(NS >= 2, "at least two stages");
};

// Dynamic shared memory, whatever D: the stage ring (1024-byte aligned),
// the activation tile, two layer-0 input stages, wout's live columns, the
// mbarriers.
template <int H>
constexpr size_t trunk_smem() {
  return 1024 + kRingBytes +
         sizeof(float) * (static_cast<size_t>(kTileP) * (H + kActPad + 2 * kXLd) + H * kHead) +
         2 * Trunk<H>::NS * sizeof(uint64_t);
}
static_assert(trunk_smem<256>() <= 232448, "fwd_trunk's shared memory fits a block");

// The two consumer warpgroups of fwd_trunk_kernel.
template <int H, bool INLINE_PE, bool STAGED>
__device__ __forceinline__ void fwd_trunk_consumer(
    const float* __restrict__ in, const float* __restrict__ feats, const float* __restrict__ e2,
    const float* __restrict__ c, const float* __restrict__ b0, const float* __restrict__ bh,
    const float* __restrict__ wout, const float* __restrict__ bout, float* __restrict__ out4,
    int N, int Np, int tiles, int n_raw, int n_phase, int Fd, int D, int L1,
    uint32_t ring, float* __restrict__ act, float* __restrict__ xbuf, float* __restrict__ whead,
    uint32_t full0, uint32_t empty0) {
  using T = Trunk<H>;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;                       // warpgroup: columns [wg*NW, +NW)
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;             // fragment rows r0, r0 + 8
  const int c0 = wg * T::NW;
  constexpr int ld = H + kActPad;
  float acc[T::NR], part[T::NR];
#pragma unroll
  for (int i = 0; i < T::NR; ++i) part[i] = 0.f;
  int it = 0;
  // the head's four live columns, once per CTA
  for (int e = tid; e < H * kHead; e += kConsumers)
    whead[e] = __ldg(wout + (e / kHead) * kOutPad + e % kHead);

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

    for (int l = 0; l <= L1; ++l) {
      const int K = l ? H : D;
      const int nst = (K + kStageK - 1) / kStageK;
#pragma unroll
      for (int i = 0; i < T::NR; ++i) acc[i] = 0.f;
      // A fragments of stage sl's k-steps, split into TF32 halves, from the
      // tile or (a STAGED layer 0) from the stage's input buffer; K is a
      // multiple of 16, so a stage has 2 or 4 live k-steps.
      const bool from_tile = !STAGED || l > 0;
      auto load_a = [&](int sl, uint32_t (&ahi)[4][4], uint32_t (&alo)[4][4]) {
        const int kbase = sl * kStageK;
        const int live = K - kbase >= kStageK ? 4 : 2;
        const float* src = from_tile ? act + kbase : xstage(sl);
        const int sld = from_tile ? ld : kXLd;
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
        const uint32_t hi_img = ring + s * T::kStageBytes + c0 * (kStageK * 4);
        const uint32_t lo_img = hi_img + H * kStageK * 4;
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
          if (!from_tile) {  // its buffer was last read by load_a(sl - 1), before the last sync
            build_x(sl + 1, xstage(sl + 1), kXLd);
            consumers_sync();
          }
          load_a(sl + 1, nhi, nlo);
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
      if (l == 0) {  // the first stage, or the whole input into the tile
        if (STAGED)
          build_x(0, xstage(0), kXLd);
        else
          for (int sl = 0; sl < nst; ++sl) build_x(sl, act + sl * kStageK, ld);
        consumers_sync();
      }
      load_a(0, h0, l0);
      for (int sl = 0; sl < nst; sl += 2) {
        stage(sl, h0, l0, h1, l1);
        if (sl + 1 < nst) stage(sl + 1, h1, l1, h0, l0);
      }
      consumers_sync();  // every warp is done reading the layer's input
      const float* bias = l ? bh + static_cast<size_t>(l - 1) * H : b0;
#pragma unroll
      for (int j = 0; j < T::NW / 8; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        const float bb0 = __ldg(bias + col), bb1 = __ldg(bias + col + 1);
        *reinterpret_cast<float2*>(act + r0 * ld + col) =
            make_float2(fmaxf(acc[4 * j] + bb0, 0.f), fmaxf(acc[4 * j + 1] + bb1, 0.f));
        *reinterpret_cast<float2*>(act + (r0 + 8) * ld + col) =
            make_float2(fmaxf(acc[4 * j + 2] + bb0, 0.f), fmaxf(acc[4 * j + 3] + bb1, 0.f));
      }
      consumers_sync();
    }

    // head, exact fp32: thread -> (point, output column)
    if (tid < kTileP * kHead) {
      const int p = tid >> 2;
      const int o = tid & 3;
      float s = 0.f;
#pragma unroll 16
      for (int k = 0; k < H; ++k) s = fmaf(act[p * ld + k], whead[k * kHead + o], s);
      s += __ldg(bout + o);
      out4[static_cast<size_t>(o) * Np + n0 + p] = s;
    }
    consumers_sync();  // the head has read the tile before the next input build
  }
}

template <int H, bool INLINE_PE, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1)
fwd_trunk_kernel(const float* __restrict__ in, const float* __restrict__ feats,
                 const float* __restrict__ e2, const float* __restrict__ c,
                 const float* __restrict__ wsplit, const float* __restrict__ b0,
                 const float* __restrict__ bh, const float* __restrict__ wout,
                 const float* __restrict__ bout, float* __restrict__ out4, int N, int Np,
                 int tiles, int n_raw, int n_phase, int Fd, int D, int L1) {
  using T = Trunk<H>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw_addr & 1023)) & 1023);
  const uint32_t ring = smem_u32(base);
  float* act = reinterpret_cast<float*>(base + kRingBytes);  // (64, H + 8)
  float* xbuf = act + kTileP * (H + kActPad);  // two (64, 40) layer-0 input stages
  float* whead = xbuf + 2 * kTileP * kXLd;     // (H, 4): wout's live columns
  uint64_t* bars = reinterpret_cast<uint64_t*>(whead + H * kHead);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + T::NS);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int stages0 = (D + kStageK - 1) / kStageK;
  const int stages = stages0 + L1 * (H / kStageK);

  if (tid == 0) {
    for (int s = 0; s < T::NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The roles never meet again: registers move from the producer warpgroup
  // (one thread of which issues the copies) to the consumers.
  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int st = 0; st < stages; ++st, ++it) {
          const int s = it % T::NS;
          mbar_wait(empty0 + 8 * s, ((it / T::NS) & 1) ^ 1);
          mbar_arrive_expect_tx(full0 + 8 * s, T::kStageBytes);
          bulk_copy(ring + s * T::kStageBytes,
                    wsplit + static_cast<size_t>(st) * 2 * H * kStageK, T::kStageBytes,
                    full0 + 8 * s);
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    fwd_trunk_consumer<H, INLINE_PE, STAGED>(in, feats, e2, c, b0, bh, wout, bout, out4, N, Np,
                                             tiles, n_raw, n_phase, Fd, D, L1, ring, act, xbuf,
                                             whead, full0, empty0);
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

template <int H, bool INLINE_PE>
cudaError_t launch(const float* in, const float* feats, const float* z, const float* dnorm,
                   const float* e2, const float* c, const float* w0, const float* b0,
                   const float* wh, const float* bh, const float* wout, const float* bout,
                   float* rgb, float* depth, float* acc, float* weights, float* scratch, int R,
                   int S, int n_raw, int n_phase, int Fd, int D, int L1, int white_bkgd,
                   int device, cudaStream_t st) {
  const Layout lay = make_layout(R, S, D, H, L1);
  float* wsplit = scratch;
  float* out4 = scratch + lay.out4;
  fwd_split_kernel<<<dim3(H / 32, lay.stages), 256, 0, st>>>(w0, wh, wsplit, D, H, lay.stages0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem = trunk_smem<H>();
  // an input wider than the activation tile streams through the stage buffers
  const auto trunk =
      D > H ? fwd_trunk_kernel<H, INLINE_PE, true> : fwd_trunk_kernel<H, INLINE_PE, false>;
  err = cudaFuncSetAttribute(trunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int grid = lay.tiles < sms ? lay.tiles : sms;  // persistent CTAs
  trunk<<<grid, kThreads, smem, st>>>(
      in, feats, e2, c, wsplit, b0, bh, wout, bout, out4, lay.N, lay.Np, lay.tiles, n_raw,
      n_phase, Fd, D, L1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  fwd_composite_kernel<<<cdiv(R, kRaysPerCta), 32 * kRaysPerCta, 0, st>>>(
      out4, z, dnorm, rgb, depth, acc, weights, R, S, lay.Np, white_bkgd);
  return cudaGetLastError();
}

template <bool INLINE_PE>
int dispatch(const float* in, const float* feats, const float* z, const float* dnorm,
             const float* e2, const float* c, const float* w0, const float* b0, const float* wh,
             const float* bh, const float* wout, const float* bout, float* rgb, float* depth,
             float* acc, float* weights, float* scratch, int R, int S, int n_raw, int n_phase,
             int Fd, int D, int H, int L1, int white_bkgd, int device, void* stream) {
  if (D % 16 != 0 || D > kMaxD || R < 1 || S < 1 || L1 < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 256)
    return launch<256, INLINE_PE>(in, feats, z, dnorm, e2, c, w0, b0, wh, bh, wout, bout, rgb,
                                  depth, acc, weights, scratch, R, S, n_raw, n_phase, Fd, D, L1,
                                  white_bkgd, device, st);
  if (H == 128)
    return launch<128, INLINE_PE>(in, feats, z, dnorm, e2, c, w0, b0, wh, bh, wout, bout, rgb,
                                  depth, acc, weights, scratch, R, S, n_raw, n_phase, Fd, D, L1,
                                  white_bkgd, device, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Floats of the scratch nerf_fwd_pe and nerf_fwd_x need: the weights' TF32
// stage images and the four raw head outputs of every point.
extern "C" unsigned long long nerf_fwd_scratch_floats(int R, int S, int D, int H, int L1) {
  return make_layout(R, S, D, H, L1).total;
}

// Kernel 2: the inline-PE render from the thin (R*S, n_raw) raw block.
extern "C" int nerf_fwd_pe(const float* raw, const float* feats, const float* z,
                           const float* dnorm, const float* e2, const float* c,
                           const float* w0, const float* b0, const float* wh, const float* bh,
                           const float* wout, const float* bout, float* rgb, float* depth,
                           float* acc, float* weights, float* scratch, int R, int S, int n_raw,
                           int n_phase, int Fd, int D, int H, int L1, int white_bkgd, int device,
                           void* stream) {
  return dispatch<true>(raw, feats, z, dnorm, e2, c, w0, b0, wh, bh, wout, bout, rgb, depth, acc,
                        weights, scratch, R, S, n_raw, n_phase, Fd, D, H, L1, white_bkgd, device,
                        stream);
}

// Kernel 4: the render from a pre-encoded (R*S, D) x.
extern "C" int nerf_fwd_x(const float* x, const float* z, const float* dnorm, const float* w0,
                          const float* b0, const float* wh, const float* bh, const float* wout,
                          const float* bout, float* rgb, float* depth, float* acc,
                          float* weights, float* scratch, int R, int S, int D, int H, int L1,
                          int white_bkgd, int device, void* stream) {
  return dispatch<false>(x, nullptr, z, dnorm, nullptr, nullptr, w0, b0, wh, bh, wout, bout, rgb,
                         depth, acc, weights, scratch, R, S, 0, 0, 0, D, H, L1, white_bkgd,
                         device, stream);
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
