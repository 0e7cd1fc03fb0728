// Forward NeRF render for Hopper (sm_90a), exact fp32, in two builds.
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
// The phases are broadcast multiply-adds (every nonzero of e2 is a power of
// two, so each phase is rounded once) and sinf is the accurate libdevice
// sine: the phases reach ~2^9*|x| rad, where __sinf and --use_fast_math
// are wrong. The log-space prefix sum is an fp32 warp scan.
//
// Bound: ~0.97 MFLOP per point at the baseline widths (x_dim 90, 8x256 trunk:
// 2*(90*256 + 7*256*256 + 256*4)), i.e. ~1.0 TFLOP per 128x128x64 view,
// against ~6 MB of input and output per 2048-ray chunk (~100 MB with a
// pre-encoded 128-wide x): compute-bound. The honest peak for an exact-fp32
// kernel is the FP32 CUDA-core rate (67 TFLOP/s on an H100 SXM), not the
// TF32 tensor cores.
//
// Design (simple first; the fast kernel is later work):
//   * one CTA of 256 threads (8 warps) per ray; the ray's S points run in
//     sub-tiles of 64 points;
//   * activations live transposed in dynamic shared memory, act[k][p] with a
//     row stride of 68 floats, ping-ponged between two buffers of
//     max(D, H) rows (2 x 256 x 68 x 4 B = 136 KB, so the launch sets
//     cudaFuncAttributeMaxDynamicSharedMemorySize; above 48 KB a launch
//     without it is refused);
//   * each warp owns 8 points and each lane H/32 output columns, an 8 x 8
//     register tile at H = 256 (fp32 FMAs on the CUDA cores): per k it reads
//     two broadcast float4 of activations and 8 weights, for 64 FMAs;
//   * weights stream from global memory (L2-resident, 2 MB) through a
//     16-row shared slice, the next slice prefetched into registers while
//     the current one is consumed;
//   * sigma and rgb of all S points stay in shared memory; warp 0 then
//     composites the ray with a shuffle scan.
// The launchers return cudaGetLastError() (or the first failing call), and
// the Python wrappers raise when it is not cudaSuccess.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kTileP = 64;       // points per sub-tile: 8 per warp
constexpr int kLd = kTileP + 4;  // activation row stride: conflict-free float4 stores
constexpr int kKT = 16;          // weight rows per shared slice
constexpr int kOutPad = 128;     // packed head columns [r, g, b, sigma, 0...]
constexpr float kFar = 1e10f;
constexpr float kEps = 1e-10f;

// out_t[col][p] = relu(sum_k in_t[k][p] * W[k][col] + bias[col]) for the
// sub-tile's 64 points; W is (K, H) row-major in global memory.
template <int H>
__device__ __forceinline__ void dense_relu(const float* __restrict__ in_t,
                                           float* __restrict__ out_t,
                                           const float* __restrict__ W,
                                           const float* __restrict__ bias, int K,
                                           float* __restrict__ wsl) {
  constexpr int NC = H / 32;                     // columns per lane
  constexpr int V4 = kKT * H / 4 / kThreads;     // float4 per thread per slice
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p0 = (tid >> 5) * 8;

  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  const float4* W4 = reinterpret_cast<const float4*>(W);
  float4 stage[V4];
#pragma unroll
  for (int v = 0; v < V4; ++v) stage[v] = __ldg(W4 + tid + v * kThreads);

  for (int k0 = 0; k0 < K; k0 += kKT) {
    __syncthreads();  // the previous slice is consumed and in_t is written
    float4* wsl4 = reinterpret_cast<float4*>(wsl);
#pragma unroll
    for (int v = 0; v < V4; ++v) wsl4[tid + v * kThreads] = stage[v];
    __syncthreads();
    if (k0 + kKT < K) {
      const float4* next = W4 + static_cast<size_t>(k0 + kKT) * (H / 4);
#pragma unroll
      for (int v = 0; v < V4; ++v) stage[v] = __ldg(next + tid + v * kThreads);
    }
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      const float* hrow = in_t + (k0 + kk) * kLd + p0;
      const float4 ha = *reinterpret_cast<const float4*>(hrow);
      const float4 hb = *reinterpret_cast<const float4*>(hrow + 4);
      const float h[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
      float w[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) w[j] = wsl[kk * H + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(h[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = lane + 32 * j;
    const float b = __ldg(bias + col);
    const float4 lo = make_float4(fmaxf(acc[0][j] + b, 0.f), fmaxf(acc[1][j] + b, 0.f),
                                  fmaxf(acc[2][j] + b, 0.f), fmaxf(acc[3][j] + b, 0.f));
    const float4 hi = make_float4(fmaxf(acc[4][j] + b, 0.f), fmaxf(acc[5][j] + b, 0.f),
                                  fmaxf(acc[6][j] + b, 0.f), fmaxf(acc[7][j] + b, 0.f));
    *reinterpret_cast<float4*>(out_t + col * kLd + p0) = lo;
    *reinterpret_cast<float4*>(out_t + col * kLd + p0 + 4) = hi;
  }
}

template <int H, bool INLINE_PE>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const float* __restrict__ raw, const float* __restrict__ feats,
              const float* __restrict__ z, const float* __restrict__ dnorm,
              const float* __restrict__ e2, const float* __restrict__ c,
              const float* __restrict__ w0, const float* __restrict__ b0,
              const float* __restrict__ wh, const float* __restrict__ bh,
              const float* __restrict__ wout, const float* __restrict__ bout,
              float* __restrict__ rgb, float* __restrict__ depth,
              float* __restrict__ acc, float* __restrict__ weights, int S,
              int n_raw, int n_phase, int Fd, int D, int L1, int white_bkgd) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rows = D > H ? D : H;
  float* act0 = smem;
  float* act1 = act0 + rows * kLd;
  float* wsl = act1 + rows * kLd;
  float* sig = wsl + kKT * H;
  float* rgbs = sig + S;

  const int ray = blockIdx.x;
  const int tid = threadIdx.x;

  for (int s0 = 0; s0 < S; s0 += kTileP) {
    __syncthreads();  // the previous sub-tile's head has read its buffer
    for (int idx = tid; idx < D * kTileP; idx += kThreads) {
      const int k = idx / kTileP;
      const int p = idx % kTileP;
      const int q = s0 + p;
      float v = 0.f;
      if (q < S && !INLINE_PE) {
        v = raw[(static_cast<size_t>(ray) * S + q) * D + k];  // the given x
      } else if (q < S) {
        const size_t n = static_cast<size_t>(ray) * S + q;
        const float* r = raw + n * n_raw;
        if (k < n_raw) {
          v = r[k];
        } else if (k < n_raw + n_phase) {
          const int col = k - n_raw;
          float a = c[col];
          for (int d = 0; d < n_raw; ++d) a = __fadd_rn(a, __fmul_rn(r[d], e2[d * n_phase + col]));
          v = sinf(a);
        } else if (k < n_raw + n_phase + Fd) {
          v = feats[n * Fd + (k - n_raw - n_phase)];
        }
      }
      act0[k * kLd + p] = v;
    }

    dense_relu<H>(act0, act1, w0, b0, D, wsl);
    float* cur = act1;
    float* other = act0;
    for (int l = 0; l < L1; ++l) {
      dense_relu<H>(cur, other, wh + static_cast<size_t>(l) * H * H,
                    bh + static_cast<size_t>(l) * H, H, wsl);
      float* t = cur;
      cur = other;
      other = t;
    }
    __syncthreads();

    // packed head: thread -> (point, output column)
    const int p = tid >> 2;
    const int o = tid & 3;
    float s = 0.f;
    for (int k = 0; k < H; ++k) s = fmaf(cur[k * kLd + p], __ldg(wout + k * kOutPad + o), s);
    s += __ldg(bout + o);
    const int q = s0 + p;
    if (q < S) {
      if (o == 3) {
        sig[q] = s;
      } else {
        rgbs[3 * q + o] = 1.f / (1.f + expf(-s));
      }
    }
  }
  __syncthreads();

  if (tid < 32) {
    const int lane = tid;
    const float dn = dnorm[ray];
    const float* zr = z + static_cast<size_t>(ray) * S;
    float* wr = weights + static_cast<size_t>(ray) * S;
    float carry = 0.f;
    float r0 = 0.f, r1 = 0.f, r2 = 0.f, dep = 0.f, accw = 0.f;
    for (int base = 0; base < S; base += 32) {
      const int i = base + lane;
      float lg = 0.f, alpha = 0.f, zi = 0.f;
      if (i < S) {
        zi = zr[i];
        const float dist = (i + 1 < S ? zr[i + 1] - zi : kFar) * dn;
        const float ea = expf(-fmaxf(sig[i], 0.f) * dist);
        alpha = 1.f - ea;
        lg = logf(ea + kEps);
      }
      float incl = lg;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      incl += carry;
      carry = __shfl_sync(0xffffffffu, incl, 31);
      if (i < S) {
        const float w = alpha * expf(incl - lg);
        wr[i] = w;
        r0 = fmaf(w, rgbs[3 * i + 0], r0);
        r1 = fmaf(w, rgbs[3 * i + 1], r1);
        r2 = fmaf(w, rgbs[3 * i + 2], r2);
        dep = fmaf(w, zi, dep);
        accw += w;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      r0 += __shfl_xor_sync(0xffffffffu, r0, off);
      r1 += __shfl_xor_sync(0xffffffffu, r1, off);
      r2 += __shfl_xor_sync(0xffffffffu, r2, off);
      dep += __shfl_xor_sync(0xffffffffu, dep, off);
      accw += __shfl_xor_sync(0xffffffffu, accw, off);
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
}

template <int H, bool INLINE_PE>
cudaError_t launch(const float* raw, const float* feats, const float* z, const float* dnorm,
                   const float* e2, const float* c, const float* w0, const float* b0,
                   const float* wh, const float* bh, const float* wout, const float* bout,
                   float* rgb, float* depth, float* acc, float* weights, int R, int S,
                   int n_raw, int n_phase, int Fd, int D, int L1, int white_bkgd,
                   cudaStream_t stream) {
  const int rows = D > H ? D : H;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(rows) * kLd +
                                       static_cast<size_t>(kKT) * H + 4 * static_cast<size_t>(S));
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<H, INLINE_PE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fwd_kernel<H, INLINE_PE><<<R, kThreads, smem, stream>>>(
      raw, feats, z, dnorm, e2, c, w0, b0, wh, bh, wout, bout, rgb, depth, acc, weights, S, n_raw,
      n_phase, Fd, D, L1, white_bkgd);
  return cudaGetLastError();
}

template <bool INLINE_PE>
int dispatch(const float* raw, const float* feats, const float* z, const float* dnorm,
             const float* e2, const float* c, const float* w0, const float* b0, const float* wh,
             const float* bh, const float* wout, const float* bout, float* rgb, float* depth,
             float* acc, float* weights, int R, int S, int n_raw, int n_phase, int Fd, int D,
             int H, int L1, int white_bkgd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 256)
    return launch<256, INLINE_PE>(raw, feats, z, dnorm, e2, c, w0, b0, wh, bh, wout, bout, rgb,
                                  depth, acc, weights, R, S, n_raw, n_phase, Fd, D, L1,
                                  white_bkgd, st);
  if (H == 128)
    return launch<128, INLINE_PE>(raw, feats, z, dnorm, e2, c, w0, b0, wh, bh, wout, bout, rgb,
                                  depth, acc, weights, R, S, n_raw, n_phase, Fd, D, L1,
                                  white_bkgd, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Kernel 2: the inline-PE render from the thin (R*S, n_raw) raw block.
extern "C" int nerf_fwd_pe(const float* raw, const float* feats, const float* z,
                           const float* dnorm, const float* e2, const float* c,
                           const float* w0, const float* b0, const float* wh, const float* bh,
                           const float* wout, const float* bout, float* rgb, float* depth,
                           float* acc, float* weights, int R, int S, int n_raw, int n_phase,
                           int Fd, int D, int H, int L1, int white_bkgd, int device,
                           void* stream) {
  return dispatch<true>(raw, feats, z, dnorm, e2, c, w0, b0, wh, bh, wout, bout, rgb, depth, acc,
                        weights, R, S, n_raw, n_phase, Fd, D, H, L1, white_bkgd, device, stream);
}

// Kernel 4: the render from a pre-encoded (R*S, D) x.
extern "C" int nerf_fwd_x(const float* x, const float* z, const float* dnorm, const float* w0,
                          const float* b0, const float* wh, const float* bh, const float* wout,
                          const float* bout, float* rgb, float* depth, float* acc,
                          float* weights, int R, int S, int D, int H, int L1, int white_bkgd,
                          int device, void* stream) {
  return dispatch<false>(x, nullptr, z, dnorm, nullptr, nullptr, w0, b0, wh, bh, wout, bout, rgb,
                         depth, acc, weights, R, S, 0, 0, 0, D, H, L1, white_bkgd, device,
                         stream);
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
