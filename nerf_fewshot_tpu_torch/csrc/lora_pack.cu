// The LoRA trunk's packing and its VJP for Hopper (sm_90a): a NeRFMLP whose
// every trunk layer is a LoRADense (base (out, in), lora_a (in, r), lora_b
// (r, out)) packed into the six weight tensors the trunk kernels read, and
// the six packed gradients those kernels return mapped back to every
// parameter's gradient. Any rank r >= 1 and any depth L >= 1.
//
// Replaces no Pallas kernel. It is the counterpart of the JAX step's
// pack_params over a LoRA trunk (nerf_fewshot_tpu/render/kernels.py:660-710,
// the merge W + (alpha/r) * A @ B at :679-684) and of jax.vjp over it
// (nerf_fewshot_tpu/render/train_kernel.py:720-747), which XLA fuses into
// the one jitted step; eager PyTorch runs the same packing layer by layer
// (render/kernels.py:_pack_merged) as some forty small kernels, and its
// backward through the autograd engine as some eighty more.
//
// lora_pack_fwd, op for op as _pack_merged rounds it on the card up to rank
// kTorchOrderRank:
//   K_l[i][j] = base_l[j][i] + s * ab,  s = alpha / r rounded to fp32,
//   ab = torch.sum(a[:, :, None] * b[None], dim=1): r exact fp32 products
//        a[i][k] * b[k][j] in the order of torch's CUDA reduction over a
//        dimension that is not the fastest (Reduce.cuh, vt0 = 4, found on the
//        card): below r = 64 one thread takes every product, the n-th into
//        accumulator n % 4 (each starting at +0.0), and adds the four in
//        order; from r = 64 four threads split the products (thread t the
//        k = t mod 4, each as above) and their sums are added as a tree,
//        (t0 + t2) + (t1 + t3). Once a thread's share, ceil(r / 4), reaches
//        256 (r >= 1021), torch may split the sum across blocks, in a shape
//        its launch heuristics choose (the SM count, the output's size): no
//        property of the merge, so the kernel follows its own order there,
//        the rule of the VJP's lora_a / lora_b: the same r fp32 products
//        summed in float64 in k order and rounded once to fp32 (a and b
//        staged through shared memory kTile ranks at a time), then s * ab
//        and base + . rounded as above.
//   w0 = K_0's rows gathered through row_perm (or as they are), zero rows up
//   to d_pad; wh = K_1.. stacked; b0 / bh the biases; wout (H, 128) = [rgb^T
//   | sigma^T | 0]; bout = [rgb_b | sigma_b | 0]. Every rounding is explicit
//   (__fmul_rn / __fadd_rn): nvcc may contract nothing. No TF32, no tensor
//   cores.
//
// lora_pack_vjp, from the packed gradients (gw0, gb0, gwh, gbh, gwout, gbout):
//   dK_0[perm[d]] = 0 + gw0[d] (the accumulation onto zeros of the row
//   gather's backward, which turns -0.0 into +0.0), dK_0 = gw0[:in] without
//   row_perm, dK_l = gwh[l-1]; base_l.grad = dK_l^T, base_l.bias.grad and
//   the heads' gradients copies of the packed ones; and with g = dK * s
//   rounded to fp32 (autograd's MulBackward), the two reductions
//   lora_a.grad[i][k] = sum_j fl(g[i][j] * b[k][j])   (over out)
//   lora_b.grad[k][j] = sum_i fl(g[i][j] * a[i][k])   (over in)
//   of the same fp32 products autograd forms, summed in float64 in a fixed
//   order (each lane a strided slice, then a fixed tree) and rounded once:
//   autograd's fp32 order on the card is not matched; a second call is
//   bit-equal to the first. Nothing in it depends on r but the count of
//   rank chunks, kChunk ranks a block.
//
// Bound: bytes at small rank. The forward reads every base weight, A and B
// once and writes the packed tensors once (at lora_nerf_trunk.yaml's 8x256
// trunk, D 160, rank 4: 3.6 MB, 1.1 us at 3.35 TB/s); the VJP reads the
// packed gradients that reach a parameter (not gw0's pad rows, not the
// head's pad columns), A and B, and writes every gradient (about as many
// bytes). The arithmetic, 2 r operations a merged element (4 r in the VJP),
// overtakes the bytes as r grows: at rank 1024 the float64 sums bound both.
// Design: a grid over the layers of a launch (blockIdx.y), 32x32 tiles
// transposed through shared memory so that both the (out, in) reads or
// writes and the (in, out) ones are coalesced; in the VJP a block of the
// grid takes a transpose tile, eight rows of lora_a's reduction (a warp
// each) or 32 columns of lora_b's (8 row lanes each); a last grid row copies
// the launch's biases, and in the trunk's last launch the heads. A layer's
// block body (fwd_layer, vjp_layer) is a template on the trunk's first
// layer, whose rows go through the row gather, so that no loop tests the
// layer: tested at run time on s.first + blockIdx.y, it cost the VJP 1.7-2.5x
// its time on an H100 at rank 4 (nvcc then no longer split the reduction
// loops by layer).
// Parameters and outputs arrive by value (a table of pointers), so a CUDA
// graph holds them as captured: a launch takes at most kMaxLayers layers, a
// deeper trunk ceil(L / kMaxLayers) launches of the same kernel, launch c
// the layers 32 c .. 32 c + 31 (Shape::first, Shape::count), as the dW
// products of csrc/train_pe.cu go in launches of kMaxJobs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 32;           // layers a launch takes (its pointer table)
constexpr int kTile = 32;
constexpr int kLanes = 8;                // thread rows of a block
constexpr int kThreads = kTile * kLanes;
constexpr int kOutPad = 128;             // the packed head's columns
constexpr int kChunk = 4;                // ranks a pass of a reduction takes
constexpr int kSplitRank = 64;           // torch's merge splits its sum from this rank
constexpr int kTorchOrderRank = 1020;    // and may split it across blocks past this one

struct Lora {
  const float* w;     // base.weight (out, in)
  const float* bias;  // base.bias (out,)
  const float* a;     // lora_a (in, r)
  const float* b;     // lora_b (r, out)
};

struct Heads {
  const float* rgb_w;    // (3, H)
  const float* rgb_b;    // (3,)
  const float* sigma_w;  // (1, H)
  const float* sigma_b;  // (1,)
};

struct Shape {
  int n_layers, hidden, in_dim, n_rows, d_pad, rank;
  int first, count;  // the launch's layers: first .. first + count - 1 of the trunk
  bool heads;        // the trunk's last launch: it also writes the heads
  float scale;
  const long long* row_perm;  // (n_rows,) or null
};

struct FwdArgs {
  Lora layer[kMaxLayers];
  Heads heads;
  Shape s;
  float *w0, *b0, *wh, *bh, *wout, *bout;
};

struct LoraGrad {
  float* w;     // base.weight (out, in)
  float* bias;  // base.bias (out,)
  float* a;     // lora_a (in, r)
  float* b;     // lora_b (r, out)
};

struct HeadGrads {
  float *rgb_w, *rgb_b, *sigma_w, *sigma_b;
};

struct VjpArgs {
  const float* a[kMaxLayers];
  const float* b[kMaxLayers];
  LoraGrad grad[kMaxLayers];
  HeadGrads heads;
  Shape s;
  const float *gw0, *gb0, *gwh, *gbh, *gwout, *gbout;
};

// The trunk row of packed row `d`: of the trunk's first layer (`first`:
// gathered through row_perm, -1 for a zero pad row) or of any other.
__device__ __forceinline__ int trunk_row(const Shape& s, bool first, int d) {
  if (!first) return d;
  if (d >= s.n_rows) return -1;
  return s.row_perm != nullptr ? static_cast<int>(s.row_perm[d]) : d;
}

// One thread's part of torch's reduction: the products k = first, first +
// step, ... below r, the n-th into accumulator n % 4, the four added in order.
__device__ __forceinline__ float thread_sum(const float* __restrict__ ai,
                                            const float* __restrict__ b, int j, int r, int H,
                                            int first, int step) {
  auto term = [&](int k) { return __fmul_rn(ai[k], b[static_cast<long long>(k) * H + j]); };
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
  int k = first;
  for (; k + 3 * step < r; k += 4 * step) {
    acc0 = __fadd_rn(acc0, term(k));
    acc1 = __fadd_rn(acc1, term(k + step));
    acc2 = __fadd_rn(acc2, term(k + 2 * step));
    acc3 = __fadd_rn(acc3, term(k + 3 * step));
  }
  if (k < r) acc0 = __fadd_rn(acc0, term(k));
  if (k + step < r) acc1 = __fadd_rn(acc1, term(k + step));
  if (k + 2 * step < r) acc2 = __fadd_rn(acc2, term(k + 2 * step));
  return __fadd_rn(__fadd_rn(__fadd_rn(acc0, acc1), acc2), acc3);
}

// ab[i][j] as torch.sum(a[:, :, None] * b[None], dim=1) adds it on the card.
__device__ __forceinline__ float lora_product(const float* __restrict__ a,
                                              const float* __restrict__ b, int i, int j, int r,
                                              int H) {
  const float* ai = a + static_cast<long long>(i) * r;
  if (r < kSplitRank) return thread_sum(ai, b, j, r, H, 0, 1);
  const float t0 = thread_sum(ai, b, j, r, H, 0, 4), t1 = thread_sum(ai, b, j, r, H, 1, 4);
  const float t2 = thread_sum(ai, b, j, r, H, 2, 4), t3 = thread_sum(ai, b, j, r, H, 3, 4);
  return __fadd_rn(__fadd_rn(t0, t2), __fadd_rn(t1, t3));
}

__device__ __forceinline__ int tiles_of(int rows, int H) {
  return ((rows + kTile - 1) / kTile) * (H / kTile);
}

// Above kTorchOrderRank: acc[m] = the r products of row dd = threadIdx.y +
// kLanes * m of the tile at d0 and of column j0 + threadIdx.x, each an fp32
// product summed in float64 in k order; a and b staged through shared
// memory kTile ranks at a time (rows of a through the row gather, zeros for
// pad rows, whose sums are not read).
__device__ __forceinline__ void f64_products(const Lora& lw, const Shape& s, bool first, int rows,
                                             int d0, int j0, float (*as)[kTile + 1],
                                             float (*bs)[kTile + 1],
                                             double (&acc)[kTile / kLanes]) {
  const int r = s.rank, H = s.hidden, tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int m = 0; m < kTile / kLanes; ++m) acc[m] = 0.0;
  for (int k0 = 0; k0 < r; k0 += kTile) {
    const int nk = min(kTile, r - k0);
    for (int dd = ty; dd < kTile; dd += kLanes) {
      const int i = d0 + dd < rows ? trunk_row(s, first, d0 + dd) : -1;
      as[dd][tx] = i >= 0 && tx < nk ? lw.a[static_cast<long long>(i) * r + k0 + tx] : 0.0f;
    }
    for (int kk = ty; kk < nk; kk += kLanes)
      bs[kk][tx] = lw.b[static_cast<long long>(k0 + kk) * H + j0 + tx];
    __syncthreads();
    for (int kk = 0; kk < nk; ++kk) {
      const float bv = bs[kk][tx];
#pragma unroll
      for (int m = 0; m < kTile / kLanes; ++m)
        acc[m] += static_cast<double>(__fmul_rn(as[ty + kLanes * m][kk], bv));
    }
    __syncthreads();
  }
}

// The merge of the launch's layer `slot` (pointer table entry), trunk layer
// s.first + slot; kFirst for the trunk's layer 0, so that neither path
// branches on the layer inside its loops.
template <bool kFirst>
__device__ __forceinline__ void fwd_layer(const FwdArgs& p, int slot, float (*tile)[kTile + 1],
                                          float (*as)[kTile + 1], float (*bs)[kTile + 1]) {
  const Shape& s = p.s;
  const int H = s.hidden;
  const Lora& lw = p.layer[slot];
  const int layer = s.first + slot;  // the trunk's layer
  const int rows = kFirst ? s.d_pad : H;
  const int in = kFirst ? s.in_dim : H;
  float* out = kFirst ? p.w0 : p.wh + static_cast<long long>(layer - 1) * H * H;
  const int col_tiles = H / kTile;
  for (int t = blockIdx.x; t < tiles_of(rows, H); t += gridDim.x) {
    const int d0 = (t / col_tiles) * kTile, j0 = (t % col_tiles) * kTile;
    // tile[jj][dd] = base[j0 + jj][trunk row of d0 + dd]: reads along the row
    const int src = d0 + threadIdx.x < rows ? trunk_row(s, kFirst, d0 + threadIdx.x) : -1;
    for (int jj = threadIdx.y; jj < kTile; jj += kLanes)
      tile[jj][threadIdx.x] = src >= 0 ? lw.w[static_cast<long long>(j0 + jj) * in + src] : 0.0f;
    __syncthreads();
    const int j = j0 + threadIdx.x;
    if (s.rank > kTorchOrderRank) {
      double acc[kTile / kLanes];
      f64_products(lw, s, kFirst, rows, d0, j0, as, bs, acc);
#pragma unroll
      for (int m = 0; m < kTile / kLanes; ++m) {
        const int dd = threadIdx.y + kLanes * m;
        if (d0 + dd >= rows) continue;
        const float v = trunk_row(s, kFirst, d0 + dd) >= 0
                            ? __fadd_rn(tile[threadIdx.x][dd],
                                        __fmul_rn(s.scale, static_cast<float>(acc[m])))
                            : 0.0f;
        out[static_cast<long long>(d0 + dd) * H + j] = v;
      }
    } else {
      for (int dd = threadIdx.y; dd < kTile && d0 + dd < rows; dd += kLanes) {
        const int i = trunk_row(s, kFirst, d0 + dd);
        float v = 0.0f;
        if (i >= 0)
          v = __fadd_rn(tile[threadIdx.x][dd],
                        __fmul_rn(s.scale, lora_product(lw.a, lw.b, i, j, s.rank, H)));
        out[static_cast<long long>(d0 + dd) * H + j] = v;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
lora_pack_fwd_kernel(const __grid_constant__ FwdArgs p) {
  __shared__ float tile[kTile][kTile + 1];
  __shared__ float as[kTile][kTile + 1], bs[kTile][kTile + 1];  // above kTorchOrderRank
  const Shape& s = p.s;
  const int H = s.hidden;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  if (static_cast<int>(blockIdx.y) == s.count) {  // the launch's biases; last launch: heads
    const long long nb = static_cast<long long>(s.count) * H,
                    nw = static_cast<long long>(H) * kOutPad;
    const long long n = s.heads ? nb + nw + kOutPad : nb;
    for (long long e = static_cast<long long>(blockIdx.x) * kThreads + tid; e < n;
         e += static_cast<long long>(gridDim.x) * kThreads) {
      if (e < nb) {
        const int l = static_cast<int>(e / H), h = static_cast<int>(e % H), g = s.first + l;
        const float v = p.layer[l].bias[h];
        if (g == 0) p.b0[h] = v;
        else p.bh[static_cast<long long>(g - 1) * H + h] = v;
      } else if (e < nb + nw) {
        const long long f = e - nb;
        const int h = static_cast<int>(f / kOutPad), c = static_cast<int>(f % kOutPad);
        p.wout[f] = c < 3 ? p.heads.rgb_w[c * H + h] : c == 3 ? p.heads.sigma_w[h] : 0.0f;
      } else {
        const int c = static_cast<int>(e - nb - nw);
        p.bout[c] = c < 3 ? p.heads.rgb_b[c] : c == 3 ? p.heads.sigma_b[0] : 0.0f;
      }
    }
    return;
  }
  if (s.first + static_cast<int>(blockIdx.y) == 0) fwd_layer<true>(p, 0, tile, as, bs);
  else fwd_layer<false>(p, blockIdx.y, tile, as, bs);
}

// dK at packed row d, column j of the trunk's first layer (`first`) or of
// layer `layer` > 0.
__device__ __forceinline__ float packed_grad(const VjpArgs& p, bool first, int layer, int d,
                                             int j) {
  const int H = p.s.hidden;
  if (!first) return p.gwh[(static_cast<long long>(layer - 1) * H + d) * H + j];
  const float g = p.gw0[static_cast<long long>(d) * H + j];
  return p.s.row_perm != nullptr ? __fadd_rn(0.0f, g) : g;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The gradients of the launch's layer `slot`, trunk layer s.first + slot, as
// fwd_layer takes its merge.
template <bool kFirst>
__device__ __forceinline__ void vjp_layer(const VjpArgs& p, int slot, float (*tile)[kTile + 1],
                                          double (*part)[kChunk][kTile]) {
  const Shape& s = p.s;
  const int H = s.hidden, r = s.rank;
  const int layer = s.first + slot;  // the trunk's layer
  const int rows = kFirst ? s.n_rows : H;  // packed rows that reach the trunk
  const int in = kFirst ? s.in_dim : H;
  const LoraGrad& g = p.grad[slot];
  const float* __restrict__ a = p.a[slot];
  const float* __restrict__ b = p.b[slot];
  const int n_tiles = tiles_of(rows, H);
  const int n_rowblocks = (rows + kLanes - 1) / kLanes;
  const int chunks = (r + kChunk - 1) / kChunk;
  const int n_colblocks = (H / kTile) * chunks;
  const int col_tiles = H / kTile;
  for (int t = blockIdx.x; t < n_tiles + n_rowblocks + n_colblocks; t += gridDim.x) {
    if (t < n_tiles) {  // base.weight.grad[j][i] = dK[d][j], i = trunk row of d
      const int d0 = (t / col_tiles) * kTile, j0 = (t % col_tiles) * kTile;
      for (int dd = threadIdx.y; dd < kTile; dd += kLanes)
        tile[dd][threadIdx.x] =
            d0 + dd < rows ? packed_grad(p, kFirst, layer, d0 + dd, j0 + threadIdx.x) : 0.0f;
      __syncthreads();
      if (d0 + threadIdx.x < rows) {
        const int i = trunk_row(s, kFirst, d0 + threadIdx.x);
        for (int jj = threadIdx.y; jj < kTile; jj += kLanes)
          g.w[static_cast<long long>(j0 + jj) * in + i] = tile[threadIdx.x][jj];
      }
      __syncthreads();
    } else if (t < n_tiles + n_rowblocks) {  // lora_a.grad rows: a warp per packed row
      const int d = (t - n_tiles) * kLanes + threadIdx.y;
      if (d >= rows) continue;
      const int i = trunk_row(s, kFirst, d);
      for (int k0 = 0; k0 < r; k0 += kChunk) {
        double acc[kChunk] = {0.0, 0.0, 0.0, 0.0};
        for (int j = threadIdx.x; j < H; j += kTile) {
          const float gs = __fmul_rn(packed_grad(p, kFirst, layer, d, j), s.scale);
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            if (k0 + c < r)
              acc[c] += static_cast<double>(
                  __fmul_rn(gs, b[static_cast<long long>(k0 + c) * H + j]));
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const double v = warp_sum(acc[c]);
          if (threadIdx.x == 0 && k0 + c < r)
            g.a[static_cast<long long>(i) * r + k0 + c] = static_cast<float>(v);
        }
      }
    } else {  // lora_b.grad columns: 32 columns x kLanes row lanes, a chunk of ranks
      const int u = t - n_tiles - n_rowblocks;
      const int k0 = (u / col_tiles) * kChunk, j = (u % col_tiles) * kTile + threadIdx.x;
      double acc[kChunk] = {0.0, 0.0, 0.0, 0.0};
      for (int d = threadIdx.y; d < rows; d += kLanes) {
        const float gs = __fmul_rn(packed_grad(p, kFirst, layer, d, j), s.scale);
        const float* ai = a + static_cast<long long>(trunk_row(s, kFirst, d)) * r;
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (k0 + c < r) acc[c] += static_cast<double>(__fmul_rn(gs, ai[k0 + c]));
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) part[threadIdx.y][c][threadIdx.x] = acc[c];
      __syncthreads();
      if (threadIdx.y < kChunk && k0 + threadIdx.y < r) {
        const int c = threadIdx.y;
        double v = part[0][c][threadIdx.x];
#pragma unroll
        for (int lane = 1; lane < kLanes; ++lane) v += part[lane][c][threadIdx.x];
        g.b[static_cast<long long>(k0 + c) * H + j] = static_cast<float>(v);
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lora_pack_vjp_kernel(const __grid_constant__ VjpArgs p) {
  __shared__ float tile[kTile][kTile + 1];
  __shared__ double part[kLanes][kChunk][kTile];
  const Shape& s = p.s;
  const int H = s.hidden;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  if (static_cast<int>(blockIdx.y) == s.count) {  // the launch's biases; last launch: heads
    const long long nb = static_cast<long long>(s.count) * H;
    const long long n = s.heads ? nb + 4LL * H + 4 : nb;
    for (long long e = static_cast<long long>(blockIdx.x) * kThreads + tid; e < n;
         e += static_cast<long long>(gridDim.x) * kThreads) {
      if (e < nb) {
        const int l = static_cast<int>(e / H), h = static_cast<int>(e % H), g = s.first + l;
        p.grad[l].bias[h] = g == 0 ? p.gb0[h] : p.gbh[static_cast<long long>(g - 1) * H + h];
      } else if (e < nb + 3LL * H) {  // rgb_head.weight (3, H)
        const long long f = e - nb;
        const int c = static_cast<int>(f / H), h = static_cast<int>(f % H);
        p.heads.rgb_w[f] = p.gwout[static_cast<long long>(h) * kOutPad + c];
      } else if (e < nb + 4LL * H) {  // sigma_head.weight (1, H)
        const int h = static_cast<int>(e - nb - 3LL * H);
        p.heads.sigma_w[h] = p.gwout[static_cast<long long>(h) * kOutPad + 3];
      } else {
        const int c = static_cast<int>(e - nb - 4LL * H);
        if (c < 3) p.heads.rgb_b[c] = p.gbout[c];
        else p.heads.sigma_b[0] = p.gbout[3];
      }
    }
    return;
  }
  if (s.first + static_cast<int>(blockIdx.y) == 0) vjp_layer<true>(p, 0, tile, part);
  else vjp_layer<false>(p, blockIdx.y, tile, part);
}

bool shape_ok(int n_layers, int first, int count, int hidden, int in_dim, int n_rows,
              int rank) {
  return first >= 0 && count >= 1 && count <= kMaxLayers && first + count <= n_layers &&
         hidden > 0 && hidden % kTile == 0 && in_dim > 0 && n_rows > 0 && rank > 0;
}

// The grid's x: the most blocks any layer of the launch takes (`first_blocks`
// for layer 0, `rest_blocks` for any other), at least 1.
int grid_x(int first, int count, int first_blocks, int rest_blocks) {
  int most = first == 0 ? first_blocks : 0;
  if (first + count > 1 && rest_blocks > most) most = rest_blocks;
  return most < 1 ? 1 : most;
}

}  // namespace

// One launch of the packing: layers first .. first + count - 1 (count at
// most kMaxLayers) of an n_layers trunk; the trunk's last launch also packs
// the heads. `layers`: a host array of 4 * count device pointers (base.weight,
// base.bias, lora_a, lora_b of each of the launch's layers); `heads`: a host
// array of 4 (rgb_head.weight, rgb_head.bias, sigma_head.weight,
// sigma_head.bias); `outs`: a host array of the 6 outputs of the whole trunk
// (w0 (d_pad, H), b0 (1, H), wh (L-1, H, H), bh (L-1, H), wout (H, 128), bout
// (1, 128)); `row_perm` a device array of n_rows int64 (a permutation of the
// in_dim input rows) or null (n_rows = in_dim). fp32, contiguous.
extern "C" int nerf_lora_pack_fwd(const void* const* layers, const void* const* heads,
                                  void* const* outs, const long long* row_perm, int n_layers,
                                  int first, int count, int hidden, int in_dim, int n_rows,
                                  int d_pad, int rank, float scale, void* stream) {
  if (!shape_ok(n_layers, first, count, hidden, in_dim, n_rows, rank) || n_rows > d_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs p{};
  for (int l = 0; l < count; ++l)
    p.layer[l] = Lora{static_cast<const float*>(layers[4 * l]),
                      static_cast<const float*>(layers[4 * l + 1]),
                      static_cast<const float*>(layers[4 * l + 2]),
                      static_cast<const float*>(layers[4 * l + 3])};
  p.heads = Heads{static_cast<const float*>(heads[0]), static_cast<const float*>(heads[1]),
                  static_cast<const float*>(heads[2]), static_cast<const float*>(heads[3])};
  p.s = Shape{n_layers, hidden, in_dim, n_rows, d_pad, rank, first, count,
              first + count == n_layers, scale, row_perm};
  float** o[6] = {&p.w0, &p.b0, &p.wh, &p.bh, &p.wout, &p.bout};
  for (int k = 0; k < 6; ++k) *o[k] = static_cast<float*>(outs[k]);
  const int col_tiles = hidden / kTile;
  const int grid = grid_x(first, count, ((d_pad + kTile - 1) / kTile) * col_tiles,
                          col_tiles * col_tiles);
  lora_pack_fwd_kernel<<<dim3(grid, count + 1), dim3(kTile, kLanes), 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the VJP over layers first .. first + count - 1, as
// nerf_lora_pack_fwd: every gradient of those layers' parameters (and in the
// trunk's last launch the heads') from the six packed gradients `dpacked` (a
// host array of 6 device pointers, the outputs' shapes). `lora`: a host
// array of 2 * count device pointers (lora_a, lora_b of each of the launch's
// layers); `grads`: a host array of 4 * count (base.weight, base.bias, lora_a,
// lora_b gradients of each); `head_grads`: 4 (rgb_head.weight,
// rgb_head.bias, sigma_head.weight, sigma_head.bias). Every element of every
// gradient the launch owns is written.
extern "C" int nerf_lora_pack_vjp(const void* const* lora, const void* const* dpacked,
                                  void* const* grads, void* const* head_grads,
                                  const long long* row_perm, int n_layers, int first, int count,
                                  int hidden, int in_dim, int n_rows, int rank, float scale,
                                  void* stream) {
  if (!shape_ok(n_layers, first, count, hidden, in_dim, n_rows, rank))
    return static_cast<int>(cudaErrorInvalidValue);
  VjpArgs p{};
  for (int l = 0; l < count; ++l) {
    p.a[l] = static_cast<const float*>(lora[2 * l]);
    p.b[l] = static_cast<const float*>(lora[2 * l + 1]);
    p.grad[l] = LoraGrad{static_cast<float*>(grads[4 * l]), static_cast<float*>(grads[4 * l + 1]),
                         static_cast<float*>(grads[4 * l + 2]),
                         static_cast<float*>(grads[4 * l + 3])};
  }
  p.heads = HeadGrads{static_cast<float*>(head_grads[0]), static_cast<float*>(head_grads[1]),
                      static_cast<float*>(head_grads[2]), static_cast<float*>(head_grads[3])};
  p.s = Shape{n_layers, hidden, in_dim, n_rows, 0, rank, first, count,
              first + count == n_layers, scale, row_perm};
  const float** in[6] = {&p.gw0, &p.gb0, &p.gwh, &p.gbh, &p.gwout, &p.gbout};
  for (int k = 0; k < 6; ++k) *in[k] = static_cast<const float*>(dpacked[k]);
  const int col_tiles = hidden / kTile, chunks = (rank + kChunk - 1) / kChunk;
  auto blocks = [&](int rows) {
    return ((rows + kTile - 1) / kTile) * col_tiles + (rows + kLanes - 1) / kLanes +
           col_tiles * chunks;
  };
  const int grid = grid_x(first, count, blocks(n_rows), blocks(hidden));
  lora_pack_vjp_kernel<<<dim3(grid, count + 1), dim3(kTile, kLanes), 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
