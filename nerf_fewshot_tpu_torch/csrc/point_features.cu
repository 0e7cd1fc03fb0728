// The per-point feature sampler of the kernel path in one pass, for Hopper
// (sm_90a): N world points projected into one training view and its feature
// map sampled there bilinearly, as the plain version in
// nerf_fewshot_tpu_torch/render/point_features.py rounds it.
//
// Replaces no Pallas kernel. It is the counterpart of XLA's fusion of the
// JAX trainer's sampler closure (nerf_fewshot_tpu/training/trainer.py:76-105:
// ops/rays.py project_points_to_image or project_points_script, then
// ops/interp.py grid_sample), which the jitted step fuses into a few
// fusions; eager PyTorch runs the same arithmetic as about a hundred small
// kernels, four (N, Fd) tap intermediates and a 4x4 inverse per call.
//
// Per point, op for op as the plain version on the card rounds it (CUDA's
// eager ops divide by a Python scalar as a product with its reciprocal, so
// the host passes 1/W, 1/H in fp32; every other rounding is explicit:
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, nvcc may contract nothing):
//   reference: cam_i = fma chain over k of [p, 1]_k * w2c[i][k], k in order
//              x = cam_0 / (z + 1e-8) * focal + W/2,  valid = z > 0
//   script:    cam_i = fma chain over k of (p - t)_k * R[i][k]
//              x = cam_0 / z * focal + W/2 (no epsilon, no mask)
//   u = (x * (1/W)) * 2 - 1, then to the map's pixels: ((u + 1) * Wp - 1) / 2
//   (align_corners false) or (u + 1) / 2 * (Wp - 1) (true); the same for y
//   x0 = floor(x), wx1 = x - x0, wx0 = 1 - wx1; a tap outside
//   [0, Wp-1] x [0, Hp-1] reads 0; f = t00*(wx0*wy0) + t10*(wx1*wy0)
//   + t01*(wx0*wy1) + t11*(wx1*wy1), summed left to right.
// The 4x4 projection is the one place the plain version's order is
// cuBLAS's, not known: the FMA chain in k order is this kernel's guess.
// No TF32 and no tensor cores.
//
// invalid_fill mean (the multiscale trainer's quirk: invalid rows take the
// mean over all N sampled rows, the invalid ones included) adds three
// launches and no atomics, so a second call is bit-equal: per-channel
// partial sums of fixed row slices in float64 (`point_features_partial`),
// their sum in slice order rounded to fp32 (`point_features_sums`; under a
// mesh the caller all-reduces these sums here), and the fill
// (`point_features_fill`: mean = sum * (1/n) in fp32, as the plain
// `sum / n` and torch.mean round on the card).
//
// Bound: bytes. The sampler reads each point (12 bytes) and writes its Fd
// features (4 * Fd bytes) and its valid flag (1 byte); the view's map
// (9x9x64 to 14x14x768 floats, 20-600 KB) stays in L2. At dino_nerf's
// 32,768 points x 64 that is 8.8 MB, 2.6 us at 3.35 TB/s; at the script
// recipes' 262,144 x 768 it is 808 MB, 0.241 ms. Design: one pass and no
// intermediates. A group of lanes (a power of two, up to a warp) takes one
// point: every lane projects it (redundantly, no shuffles) and the lanes
// run over its channels with 16-byte loads of the four taps (read-only
// path) and 16-byte stores, a scalar path when Fd % 4 != 0. The view index
// is read from the device (a graphed step gathers neither map nor pose).

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSumRows = 8;      // row lanes of a partial-sum block
constexpr int kSumCols = 32;     // channel lanes of a partial-sum block

struct Geometry {
  float focal, half_w, half_h, inv_w, inv_h;
  int map_h, map_w, script, align_corners;
};

// Image coordinate -> the map's pixel coordinate (grid_sample's unnormalize).
__device__ __forceinline__ float to_map(float x, float inv_size, int size, int align_corners) {
  const float u = __fsub_rn(__fmul_rn(__fmul_rn(x, inv_size), 2.0f), 1.0f);
  const float s = __fadd_rn(u, 1.0f);
  if (align_corners) return __fmul_rn(__fmul_rn(s, 0.5f), static_cast<float>(size - 1));
  return __fmul_rn(__fsub_rn(__fmul_rn(s, static_cast<float>(size)), 1.0f), 0.5f);
}

struct Taps {
  long long off[4];  // element offsets of t00, t10, t01, t11 in the map stack, or -1
  float w[4];        // wx0*wy0, wx1*wy0, wx0*wy1, wx1*wy1
  bool valid;
};

// The taps of one point: `m` the view's 4x4 pose, `map_base` the view's
// first map row (view * map_h) in the stack.
__device__ __forceinline__ Taps point_taps(const float* __restrict__ pts, long long point,
                                           const float* __restrict__ m, long long map_base,
                                           const Geometry& g, int fd) {
  const float p0 = pts[3 * point], p1 = pts[3 * point + 1], p2 = pts[3 * point + 2];
  float cam[3];
  if (g.script) {
    const float d0 = __fsub_rn(p0, m[3]), d1 = __fsub_rn(p1, m[7]), d2 = __fsub_rn(p2, m[11]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float a = __fmul_rn(d0, m[4 * i]);
      a = __fmaf_rn(d1, m[4 * i + 1], a);
      cam[i] = __fmaf_rn(d2, m[4 * i + 2], a);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float a = __fmul_rn(p0, m[4 * i]);
      a = __fmaf_rn(p1, m[4 * i + 1], a);
      a = __fmaf_rn(p2, m[4 * i + 2], a);
      cam[i] = __fadd_rn(a, m[4 * i + 3]);  // the homogeneous 1 times w2c[i][3]
    }
  }
  const float z = cam[2];
  const float zd = g.script ? z : __fadd_rn(z, 1e-8f);
  const float xi = __fadd_rn(__fmul_rn(__fdiv_rn(cam[0], zd), g.focal), g.half_w);
  const float yi = __fadd_rn(__fmul_rn(__fdiv_rn(cam[1], zd), g.focal), g.half_h);
  const float x = to_map(xi, g.inv_w, g.map_w, g.align_corners);
  const float y = to_map(yi, g.inv_h, g.map_h, g.align_corners);
  const float x0 = floorf(x), y0 = floorf(y);
  const float x1 = __fadd_rn(x0, 1.0f), y1 = __fadd_rn(y0, 1.0f);
  const float wx1 = __fsub_rn(x, x0), wy1 = __fsub_rn(y, y0);
  const float wx0 = __fsub_rn(1.0f, wx1), wy0 = __fsub_rn(1.0f, wy1);
  Taps t;
  t.w[0] = __fmul_rn(wx0, wy0);
  t.w[1] = __fmul_rn(wx1, wy0);
  t.w[2] = __fmul_rn(wx0, wy1);
  t.w[3] = __fmul_rn(wx1, wy1);
  const float xs[4] = {x0, x1, x0, x1}, ys[4] = {y0, y0, y1, y1};
  const float wmax = static_cast<float>(g.map_w - 1), hmax = static_cast<float>(g.map_h - 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool in = xs[k] >= 0.0f && xs[k] <= wmax && ys[k] >= 0.0f && ys[k] <= hmax;
    t.off[k] = in ? ((map_base + static_cast<long long>(ys[k])) * g.map_w
                     + static_cast<long long>(xs[k])) * fd
                  : -1;
  }
  t.valid = z > 0.0f;
  return t;
}

__device__ __forceinline__ float combine(float t00, float t10, float t01, float t11,
                                         const float* w) {
  float s = __fadd_rn(__fmul_rn(t00, w[0]), __fmul_rn(t10, w[1]));
  s = __fadd_rn(s, __fmul_rn(t01, w[2]));
  return __fadd_rn(s, __fmul_rn(t11, w[3]));
}

__device__ __forceinline__ long long view_of(const long long* view_ptr, int view_imm,
                                             int n_views) {
  const long long v = view_ptr != nullptr ? view_ptr[0] : view_imm;
  if (v < 0 || v >= n_views) {
    if (threadIdx.x == 0 && blockIdx.x == 0)
      printf("point_features: view index %lld out of range [0, %d)\n", v, n_views);
    __trap();
  }
  return v;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
point_features_kernel(const float* __restrict__ pts, const float* __restrict__ maps,
                      const long long* __restrict__ view_ptr, int view_imm, int n_views,
                      const float* __restrict__ poses, Geometry g, int fd, long long n,
                      int group_shift, float* __restrict__ feats,
                      unsigned char* __restrict__ valid) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long point = tid >> group_shift;
  const int lanes = 1 << group_shift;
  const int lane = static_cast<int>(tid & (lanes - 1));
  const long long v = view_of(view_ptr, view_imm, n_views);
  if (point >= n) return;
  const Taps t = point_taps(pts, point, poses + v * 16, v * g.map_h, g, fd);
  if (valid != nullptr && lane == 0) valid[point] = t.valid ? 1 : 0;
  float* out = feats + point * fd;
  if (kVec4) {
    const int n4 = fd >> 2;
    for (int c = lane; c < n4; c += lanes) {
      float4 q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        q[k] = t.off[k] >= 0 ? __ldg(reinterpret_cast<const float4*>(maps + t.off[k]) + c)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 r;
      r.x = combine(q[0].x, q[1].x, q[2].x, q[3].x, t.w);
      r.y = combine(q[0].y, q[1].y, q[2].y, q[3].y, t.w);
      r.z = combine(q[0].z, q[1].z, q[2].z, q[3].z, t.w);
      r.w = combine(q[0].w, q[1].w, q[2].w, q[3].w, t.w);
      reinterpret_cast<float4*>(out)[c] = r;
    }
  } else {
    for (int c = lane; c < fd; c += lanes) {
      float q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = t.off[k] >= 0 ? __ldg(maps + t.off[k] + c) : 0.0f;
      out[c] = combine(q[0], q[1], q[2], q[3], t.w);
    }
  }
}

// partial[s][c] = sum of feats[r][c] over the rows r of slice s, in float64:
// each of kSumRows row lanes sums every kSumRows-th row of the slice, then
// the lanes' sums are added in lane order.
__global__ void __launch_bounds__(kSumRows * kSumCols)
point_features_partial(const float* __restrict__ feats, long long n, int fd,
                       long long rows_per_slice, double* __restrict__ partial) {
  __shared__ double lanes[kSumRows][kSumCols];
  const int c = blockIdx.x * kSumCols + threadIdx.x;
  const long long start = static_cast<long long>(blockIdx.y) * rows_per_slice;
  const long long end = min(n, start + rows_per_slice);
  double acc = 0.0;
  if (c < fd)
    for (long long r = start + threadIdx.y; r < end; r += kSumRows) acc += feats[r * fd + c];
  lanes[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < fd) {
    double s = lanes[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < kSumRows; ++k) s += lanes[k][threadIdx.x];
    partial[static_cast<long long>(blockIdx.y) * fd + c] = s;
  }
}

// sums[c] = the slices' partial sums of channel c added in slice order,
// rounded once to fp32.
__global__ void __launch_bounds__(kThreads)
point_features_sums(const double* __restrict__ partial, int n_slices, int fd,
                    float* __restrict__ sums) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= fd) return;
  double s = 0.0;
  for (int k = 0; k < n_slices; ++k) s += partial[static_cast<long long>(k) * fd + c];
  sums[c] = static_cast<float>(s);
}

// feats[r][c] = sums[c] * inv_n for every row r whose projection is invalid.
__global__ void __launch_bounds__(kThreads)
point_features_fill(float* __restrict__ feats, const unsigned char* __restrict__ valid,
                    const float* __restrict__ sums, float inv_n, long long n, int fd) {
  const long long total = n * fd;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = i / fd;
    if (!valid[r]) feats[i] = __fmul_rn(sums[i - r * fd], inv_n);
  }
}

int blocks_for(long long threads) { return static_cast<int>((threads + kThreads - 1) / kThreads); }

}  // namespace

// Lanes per point: the 16-byte (or 4-byte, when Fd % 4 != 0) columns of a
// row rounded up to a power of two, at most a warp; returned as its log2.
extern "C" int nerf_point_features_group_shift(int fd) {
  const int cols = fd % 4 == 0 ? fd / 4 : fd;
  int shift = 0;
  while (shift < 5 && (1 << shift) < cols) ++shift;
  return shift;
}

// The row slices of the mean's partial sums for n points (a function of n
// alone, so the order of the sums is too).
extern "C" long long nerf_point_features_rows_per_slice(long long n) {
  const long long slices = 128;
  long long rows = (n + slices - 1) / slices;
  return rows < kSumRows ? kSumRows : rows;
}

// feats (n, fd) [and valid (n,) as 0/1 bytes when not null] of n points of
// `pts` (n, 3) in the view `*view_ptr` (an int64 on the device), or
// `view_imm` when view_ptr is null, of `maps` (n_views, map_h, map_w, fd)
// and `poses` (n_views, 4, 4): w2c for the reference projection, c2w for the
// script one. All pointers device memory, fp32, contiguous; maps, feats 16-
// byte aligned when fd % 4 == 0.
extern "C" int nerf_point_features(const float* pts, const float* maps, const long long* view_ptr,
                                   int view_imm, int n_views, const float* poses, float focal,
                                   float half_w, float half_h, float inv_w, float inv_h, int map_h,
                                   int map_w, int fd, long long n, int script, int align_corners,
                                   float* feats, unsigned char* valid, void* stream) {
  if (n <= 0) return 0;
  const Geometry g{focal, half_w, half_h, inv_w, inv_h, map_h, map_w, script, align_corners};
  const int shift = nerf_point_features_group_shift(fd);
  const int blocks = blocks_for(n << shift);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fd % 4 == 0)
    point_features_kernel<true><<<blocks, kThreads, 0, s>>>(
        pts, maps, view_ptr, view_imm, n_views, poses, g, fd, n, shift, feats, valid);
  else
    point_features_kernel<false><<<blocks, kThreads, 0, s>>>(
        pts, maps, view_ptr, view_imm, n_views, poses, g, fd, n, shift, feats, valid);
  return static_cast<int>(cudaGetLastError());
}

// The mean fill's sums: partial sums into `partial` (n_slices, fd) float64
// scratch, then `sums` (fd,) fp32. Two launches.
extern "C" int nerf_point_features_sums(const float* feats, long long n, int fd, double* partial,
                                        float* sums, void* stream) {
  if (n <= 0) return 0;
  const long long rows = nerf_point_features_rows_per_slice(n);
  const int slices = static_cast<int>((n + rows - 1) / rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  point_features_partial<<<dim3((fd + kSumCols - 1) / kSumCols, slices),
                           dim3(kSumCols, kSumRows), 0, s>>>(feats, n, fd, rows, partial);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  point_features_sums<<<blocks_for(fd), kThreads, 0, s>>>(partial, slices, fd, sums);
  return static_cast<int>(cudaGetLastError());
}

// The mean fill itself: invalid rows of feats take sums * inv_n. One launch.
extern "C" int nerf_point_features_fill(float* feats, const unsigned char* valid,
                                        const float* sums, float inv_n, long long n, int fd,
                                        void* stream) {
  if (n <= 0) return 0;
  const int full = blocks_for(n * fd), cap = 132 * 16;  // grid-stride beyond 16 blocks an SM
  const int blocks = full < cap ? full : cap;
  point_features_fill<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, valid, sums, inv_n, n, fd);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
