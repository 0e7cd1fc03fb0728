// Fused NeRF training objective and render VJP for Hopper (sm_90a), exact
// fp32: the analytic backward to every packed weight, in one call each.
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
// Bound: at the baseline widths (x_dim 90, 8x256 trunk) the forward is
// 2*(90*256 + 7*256^2 + 4*256) = 0.97 MFLOP per point, the backward chain
// 2*(4*256 + 7*256^2) = 0.92 MFLOP and the dW products 0.97 MFLOP: 2.85 MFLOP
// per point, 93 GFLOP for a 512-ray x 64-sample step (the render VJP adds dx,
// 2*256*90 = 0.05 MFLOP per point), against ~5 MB of inputs and outputs
// (~35 MB with a 128-wide x and dx): bound by operations, at the FP32
// CUDA-core rate (67 TFLOP/s on an H100 SXM); the exact-fp32 contract rules
// out the TF32 tensor cores.
//
// Design (simple first): the TPU kernels stash every layer's activations of
// a ray tile in VMEM, ~640 KB per 64-sample ray at 256 wide, far beyond an
// SM's 227 KB. So a call is split into grid launches on one stream, with
// the activations and cotangents in a global scratch buffer that the caller
// allocates once and grows:
//   1. wh_transpose: wh[l]^T, the backward chain's weights (none for a
//      one-layer trunk);
//   2. train_fwd: one 256-thread CTA per 64-point tile (points of any ray):
//      builds x (inline PE: unfused multiply-add phases, accurate sinf),
//      runs the trunk with fwd_pe.cu's 8x8 register-tiled fp32 FMA layers
//      (activations transposed in shared memory) and writes each layer's
//      activations A_i (feature-major, [K][Np]) and the 4 head outputs;
//   3. train_composite (objective) or render_composite (VJP): one warp per
//      ray: sigmoid, log-space compositing with an fp32 shuffle prefix scan,
//      the ray's loss partial (objective), then the suffix sum s_after as an
//      fp32 shuffle scan run from the last sample (never a difference of
//      prefix sums, which cancels when om ~ 1e-10), and the head cotangent;
//   4. train_bwd: per 64-point tile, delta_L from g_out and wout, then the
//      L-1 gated products with wh^T, each delta written to scratch;
//   5. train_dw: every dW_l = A_l^T.delta_l and db_l = sum delta_l as one
//      launch of 64x64 output tiles (4x4 per thread, fp32 FMAs); the point
//      axis is split in P fixed parts, each written to its own partial;
//   6. train_finalize: the P partials of each gradient are summed in a fixed
//      order;
//   7. objective: loss_sum, the per-ray losses summed in a fixed order by
//      one CTA; render VJP (when dx is asked for): render_dx, dx = delta_1.w0^T
//      as 64x64 output tiles, 4x4 per thread.
// No atomics: two runs of a call agree bit for bit.
// The launchers return cudaGetLastError() (or the first failing call), and
// the Python wrappers raise when it is not cudaSuccess.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kTileP = 64;       // points per tile: 8 per warp
constexpr int kLd = kTileP + 4;  // activation row stride in shared memory
constexpr int kKT = 16;          // weight rows per shared slice
constexpr int kOutPad = 128;     // packed head columns [r, g, b, sigma, 0...]
constexpr int kHead = 4;         // live head columns
constexpr float kFar = 1e10f;
constexpr float kEps = 1e-10f;
constexpr int kBT = 64;          // dW output tile edge
constexpr int kBN = 32;          // points per dW shared-memory stage
constexpr int kBLd = kBT + 4;
constexpr int kMaxParts = 8;     // split of the point axis in the dW products
constexpr int kPartRows = 4096;  // points per part before a further split
constexpr int kMaxJobs = 16;     // dW products in one launch (layers + head)

size_t round_up(size_t a, size_t b) { return (a + b - 1) / b * b; }

// Sizes shared by the launcher and nerf_train_scratch_floats.
struct Layout {
  int N, Np, L, P, chunk;
  size_t F;  // floats of the six packed gradients, flattened
  size_t act, gbuf, gout, out4, loss_r, whT, part, total;  // scratch offsets
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
  s.whT = off;    off += round_up(static_cast<size_t>(L1) * H * H, 64);
  s.part = off;   off += static_cast<size_t>(s.P) * round_up(s.F, 64);
  s.total = off;
  return s;
}

// One dense layer on a 64-point tile, fp32 FMAs on the CUDA cores:
// acc[p][col] = sum_k in_t[k][p] * W[k][col], W (K, H) row-major in global
// memory, streamed through a 16-row shared slice. The epilogue is
//   forward (!BWD): out = relu(acc + bias);
//   backward (BWD): out = acc where gate[col][n] > 0, else 0;
// it writes out_t[col][p] in shared memory and dst[col*Np + n0 + p] in global.
template <int H, bool BWD>
__device__ __forceinline__ void dense(const float* __restrict__ in_t, float* __restrict__ out_t,
                                      const float* __restrict__ W,
                                      const float* __restrict__ bias, int K,
                                      float* __restrict__ wsl, float* __restrict__ dst,
                                      const float* __restrict__ gate, int Np, int n0) {
  constexpr int NC = H / 32;                  // columns per lane
  constexpr int V4 = kKT * H / 4 / kThreads;  // float4 per thread per slice
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
    float v[8];
    if (BWD) {
      const float* g = gate + static_cast<size_t>(col) * Np + n0 + p0;
      const float4 ga = *reinterpret_cast<const float4*>(g);
      const float4 gb = *reinterpret_cast<const float4*>(g + 4);
      const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = gv[i] > 0.f ? acc[i][j] : 0.f;
    } else {
      const float b = __ldg(bias + col);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = fmaxf(acc[i][j] + b, 0.f);
    }
    const float4 lo = make_float4(v[0], v[1], v[2], v[3]);
    const float4 hi = make_float4(v[4], v[5], v[6], v[7]);
    *reinterpret_cast<float4*>(out_t + col * kLd + p0) = lo;
    *reinterpret_cast<float4*>(out_t + col * kLd + p0 + 4) = hi;
    float* d = dst + static_cast<size_t>(col) * Np + n0 + p0;
    *reinterpret_cast<float4*>(d) = lo;
    *reinterpret_cast<float4*>(d + 4) = hi;
  }
}

// whT[l][j][k] = wh[l][k][j], 32x32 tiles through shared memory.
__global__ void wh_transpose_kernel(const float* __restrict__ wh, float* __restrict__ whT, int H) {
  __shared__ float t[32][33];
  const size_t base = static_cast<size_t>(blockIdx.z) * H * H;
  const int bx = blockIdx.x * 32, by = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += blockDim.y)
    t[r][threadIdx.x] = wh[base + static_cast<size_t>(by + r) * H + bx + threadIdx.x];
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += blockDim.y)
    whT[base + static_cast<size_t>(bx + r) * H + by + threadIdx.x] = t[threadIdx.x][r];
}

// Forward trunk of one 64-point tile; A_0 = x and every A_i go to act
// ([D + L*H][Np]), the 4 raw head outputs to out4 ([4][Np]).
template <int H, bool INLINE_PE>
__global__ void __launch_bounds__(kThreads, 1)
train_fwd_kernel(const float* __restrict__ in, const float* __restrict__ feats,
                 const float* __restrict__ e2, const float* __restrict__ c,
                 const float* __restrict__ w0, const float* __restrict__ b0,
                 const float* __restrict__ wh, const float* __restrict__ bh,
                 const float* __restrict__ wout, const float* __restrict__ bout,
                 float* __restrict__ act, float* __restrict__ out4, int N, int Np, int n_raw,
                 int n_phase, int Fd, int D, int L1) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rows = D > H ? D : H;
  float* act0 = smem;
  float* act1 = act0 + rows * kLd;
  float* wsl = act1 + rows * kLd;
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
    act0[k * kLd + p] = v;
    act[static_cast<size_t>(k) * Np + n] = v;
  }

  dense<H, false>(act0, act1, w0, b0, D, wsl, act + static_cast<size_t>(D) * Np, nullptr, Np, n0);
  float* cur = act1;
  float* other = act0;
  for (int l = 0; l < L1; ++l) {
    dense<H, false>(cur, other, wh + static_cast<size_t>(l) * H * H,
                    bh + static_cast<size_t>(l) * H, H, wsl,
                    act + (static_cast<size_t>(D) + static_cast<size_t>(l + 1) * H) * Np,
                    nullptr, Np, n0);
    float* t = cur;
    cur = other;
    other = t;
  }
  __syncthreads();

  // head: thread -> (point, output column)
  const int p = tid >> 2;
  const int o = tid & 3;
  float s = 0.f;
  for (int k = 0; k < H; ++k) s = fmaf(cur[k * kLd + p], __ldg(wout + k * kOutPad + o), s);
  out4[static_cast<size_t>(o) * Np + n0 + p] = s + __ldg(bout + o);
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
// by an inclusive fp32 prefix scan. Fills m and returns, in every lane,
// sums = {sum w*r, sum w*g, sum w*b, sum w*z, sum w, sum w^2}.
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
    incl += carry;
    carry = __shfl_sync(full, incl, 31);
    if (i < S) {
      const float T = expf(incl - lg);
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
  composite_forward(out4, zr, dnorm[ray], nb, Np, S, m, sums);
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
  composite_forward(out4, zr, dnorm[ray], nb, Np, S, m, sums);
  const float g0 = g_rgb[3 * ray + 0];
  const float g1 = g_rgb[3 * ray + 1];
  const float g2 = g_rgb[3 * ray + 2];
  float ga = g_acc[ray];
  if (white_bkgd) ga -= g0 + g1 + g2;
  composite_backward(zr, nb, Np, S, m, g0, g1, g2, ga, false, 0.f, true, g_depth[ray],
                     g_weights + nb, gout);
}

// Backward chain of one 64-point tile: delta_L = (g_out.wout[:, :4]^T) *
// [A_L > 0], then delta_i = (delta_{i+1}.wh[i-1]^T) * [A_i > 0]; each delta
// goes to gbuf ([L*H][Np], delta_i at row (i-1)*H).
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
train_bwd_kernel(const float* __restrict__ gout, const float* __restrict__ wout,
                 const float* __restrict__ whT, const float* __restrict__ act,
                 float* __restrict__ gbuf, int N, int Np, int D, int L1) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* d0 = smem;
  float* d1 = d0 + H * kLd;
  float* wsl = d1 + H * kLd;
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
      float s = gout[n] * __ldg(wk + 0);
      s = fmaf(gout[static_cast<size_t>(Np) + n], __ldg(wk + 1), s);
      s = fmaf(gout[2 * static_cast<size_t>(Np) + n], __ldg(wk + 2), s);
      s = fmaf(gout[3 * static_cast<size_t>(Np) + n], __ldg(wk + 3), s);
      v = hL[static_cast<size_t>(k) * Np + n] > 0.f ? s : 0.f;
    }
    d0[k * kLd + p] = v;
    dL[static_cast<size_t>(k) * Np + n] = v;
  }

  float* cur = d0;
  float* other = d1;
  for (int l = L1 - 1; l >= 0; --l) {
    // delta_{l+1} = (delta_{l+2} . wh[l]^T) * [A_{l+1} > 0]
    dense<H, true>(cur, other, whT + static_cast<size_t>(l) * H * H, nullptr, H, wsl,
                   gbuf + static_cast<size_t>(l) * H * Np,
                   act + (static_cast<size_t>(D) + static_cast<size_t>(l) * H) * Np, Np, n0);
    float* t = cur;
    cur = other;
    other = t;
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

__global__ void __launch_bounds__(256)
train_dw_kernel(const DwJobs jobs, float* __restrict__ part, int N, int Np, size_t Fp,
                int chunk) {
  __shared__ __align__(16) float As[kBN][kBLd];
  __shared__ __align__(16) float Gs[kBN][kBLd];
  int t = blockIdx.x;
  int jb = 0;
  while (jb + 1 < jobs.n && t >= jobs.job[jb].tiles) {
    t -= jobs.job[jb].tiles;
    ++jb;
  }
  const DwJob& jd = jobs.job[jb];
  const int tiles_j = (jd.J + kBT - 1) / kBT;
  const int k0 = (t / tiles_j) * kBT;
  const int j0 = (t % tiles_j) * kBT;
  const int nb = blockIdx.y * chunk;
  const int ne = min(N, nb + chunk);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  float acc[4][4];
  float gsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (j0 < jd.Jreal) {
    for (int n = nb; n < ne; n += kBN) {
      for (int e = tid; e < kBT * kBN; e += 256) {
        const int r = e / kBN;
        const int q = e % kBN;
        const bool in_n = n + q < ne;
        As[q][r] = (k0 + r < jd.K && in_n) ? jd.A[static_cast<size_t>(k0 + r) * Np + n + q] : 0.f;
        Gs[q][r] = (j0 + r < jd.Jreal && in_n) ? jd.G[static_cast<size_t>(j0 + r) * Np + n + q] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int q = 0; q < kBN; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(&As[q][ty * 4]);
        const float4 g = *reinterpret_cast<const float4*>(&Gs[q][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
        if (ty == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) gsum[j] += gv[j];
        }
      }
      __syncthreads();
    }
  }

  float* out = part + blockIdx.y * Fp;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= jd.K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx * 4 + j;
      if (col < jd.J) out[jd.out + static_cast<size_t>(k) * jd.J + col] = acc[i][j];
    }
  }
  if (k0 == 0 && ty == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx * 4 + j;
      if (col < jd.J) out[jd.db + col] = gsum[j];
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
// cotangent of the first layer (gbuf rows 0..H-1, [H][Np]). 64 points x 64
// input columns per CTA, 4x4 outputs per thread, fp32 FMAs.
__global__ void __launch_bounds__(256)
render_dx_kernel(const float* __restrict__ delta1, const float* __restrict__ w0,
                 float* __restrict__ dx, int N, int Np, int D, int H) {
  __shared__ __align__(16) float Gs[kBN][kBLd];  // [j][point]
  __shared__ __align__(16) float Ws[kBN][kBLd];  // [j][input column]
  const int n0 = blockIdx.x * kBT;
  const int k0 = blockIdx.y * kBT;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < H; j0 += kBN) {
    for (int e = tid; e < kBT * kBN; e += 256) {
      const int p = e % kBT, jg = e / kBT;  // neighbouring threads: neighbouring points
      Gs[jg][p] = delta1[static_cast<size_t>(j0 + jg) * Np + n0 + p];
      const int jw = e % kBN, kk = e / kBN;  // neighbouring threads: neighbouring j
      Ws[jw][kk] = k0 + kk < D ? w0[static_cast<size_t>(k0 + kk) * H + j0 + jw] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kBN; ++j) {
      const float4 g = *reinterpret_cast<const float4*>(&Gs[j][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Ws[j][tx * 4]);
      const float gv[4] = {g.x, g.y, g.z, g.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(gv[i], wv[c], acc[i][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + tx * 4 + c;
      if (k < D) dx[static_cast<size_t>(n) * D + k] = acc[i][c];
    }
  }
}

// Every dW = A^T.delta and db = sum delta (layer 0, the L1 hidden layers,
// the head) as one launch over fixed point-axis parts, then the fixed-order
// sum of the parts into grads.
void launch_dw(const Layout& s, const float* act, const float* gbuf, const float* gout,
               float* part, float* grads, int D, int H, int L1, cudaStream_t stream) {
  DwJobs jobs;
  jobs.n = 0;
  int total_tiles = 0;
  auto add = [&](const float* A, const float* G, int K, int J, int Jreal, size_t out, size_t db) {
    DwJob& j = jobs.job[jobs.n++];
    j.A = A;
    j.G = G;
    j.K = K;
    j.J = J;
    j.Jreal = Jreal;
    j.tiles = ((K + kBT - 1) / kBT) * ((J + kBT - 1) / kBT);
    j.out = out;
    j.db = db;
    total_tiles += j.tiles;
  };
  const size_t np = s.Np;
  const size_t off_w0 = 0, off_b0 = static_cast<size_t>(D) * H;
  const size_t off_wh = off_b0 + H;
  const size_t off_bh = off_wh + static_cast<size_t>(L1) * H * H;
  const size_t off_wout = off_bh + static_cast<size_t>(L1) * H;
  const size_t off_bout = off_wout + static_cast<size_t>(H) * kOutPad;
  add(act, gbuf, D, H, H, off_w0, off_b0);
  for (int l = 0; l < L1; ++l) {
    add(act + (static_cast<size_t>(D) + static_cast<size_t>(l) * H) * np,
        gbuf + static_cast<size_t>(l + 1) * H * np, H, H, H,
        off_wh + static_cast<size_t>(l) * H * H, off_bh + static_cast<size_t>(l) * H);
  }
  add(act + (static_cast<size_t>(D) + static_cast<size_t>(L1) * H) * np, gout, H, kOutPad, kHead,
      off_wout, off_bout);
  const size_t Fp = round_up(s.F, 64);
  train_dw_kernel<<<dim3(total_tiles, s.P), 256, 0, stream>>>(jobs, part, s.N, s.Np, Fp, s.chunk);
  train_finalize_kernel<<<static_cast<unsigned>((s.F + 255) / 256), 256, 0, stream>>>(
      part, grads, s.F, Fp, s.P);
}

// The recompute of the trunk: wh^T for the backward chain, then every
// layer's activations and the 4 head outputs of each 64-point tile.
template <int H, bool INLINE_PE>
cudaError_t launch_forward(const Layout& s, const float* in, const float* feats, const float* e2,
                           const float* c, const float* w0, const float* b0, const float* wh,
                           const float* bh, const float* wout, const float* bout, float* act,
                           float* out4, float* whT, int n_raw, int n_phase, int Fd, int D, int L1,
                           cudaStream_t stream) {
  if (L1 > 0) {
    wh_transpose_kernel<<<dim3(H / 32, H / 32, L1), dim3(32, 8), 0, stream>>>(wh, whT, H);
  }
  const int rows = D > H ? D : H;
  const size_t tile_smem =
      sizeof(float) * (2 * static_cast<size_t>(rows) * kLd + static_cast<size_t>(kKT) * H);
  cudaError_t err = cudaFuncSetAttribute(train_fwd_kernel<H, INLINE_PE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(tile_smem));
  if (err != cudaSuccess) return err;
  train_fwd_kernel<H, INLINE_PE><<<s.Np / kTileP, kThreads, tile_smem, stream>>>(
      in, feats, e2, c, w0, b0, wh, bh, wout, bout, act, out4, s.N, s.Np, n_raw, n_phase, Fd, D,
      L1);
  return cudaSuccess;
}

// The backward chain of each 64-point tile, from the head cotangent gout.
template <int H>
cudaError_t launch_backward(const Layout& s, const float* gout, const float* wout,
                            const float* whT, const float* act, float* gbuf, int D, int L1,
                            cudaStream_t stream) {
  const size_t bwd_smem =
      sizeof(float) * (2 * static_cast<size_t>(H) * kLd + static_cast<size_t>(kKT) * H);
  cudaError_t err = cudaFuncSetAttribute(train_bwd_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bwd_smem));
  if (err != cudaSuccess) return err;
  train_bwd_kernel<H><<<s.Np / kTileP, kThreads, bwd_smem, stream>>>(gout, wout, whT, act, gbuf,
                                                                     s.N, s.Np, D, L1);
  return cudaSuccess;
}

struct Scratch {
  float *act, *gbuf, *gout, *out4, *loss_r, *whT, *part;
};

Scratch carve(const Layout& s, float* scratch) {
  return Scratch{scratch + s.act,    scratch + s.gbuf, scratch + s.gout, scratch + s.out4,
                 scratch + s.loss_r, scratch + s.whT,  scratch + s.part};
}

template <int H, bool INLINE_PE>
cudaError_t launch(const float* in, const float* feats, const float* z, const float* dnorm,
                   const float* tgt, const float* mask, const float* inv_denom,
                   const float* tgt_depth, const float* e2, const float* c, const float* w0,
                   const float* b0, const float* wh, const float* bh, const float* wout,
                   const float* bout, float* loss, float* grads, float* scratch, int R, int S,
                   int n_raw, int n_phase, int Fd, int D, int L1, int white_bkgd, float rgb_c,
                   float reg_c, float depth_c, cudaStream_t stream) {
  const Layout s = make_layout(R, S, D, H, L1);
  const Scratch b = carve(s, scratch);
  cudaError_t err = launch_forward<H, INLINE_PE>(s, in, feats, e2, c, w0, b0, wh, bh, wout, bout,
                                                 b.act, b.out4, b.whT, n_raw, n_phase, Fd, D, L1,
                                                 stream);
  if (err != cudaSuccess) return err;

  const size_t comp_smem = sizeof(float) * 9 * static_cast<size_t>(S);
  err = cudaFuncSetAttribute(train_composite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(comp_smem));
  if (err != cudaSuccess) return err;
  train_composite_kernel<<<R, 32, comp_smem, stream>>>(b.out4, z, dnorm, tgt, mask, inv_denom,
                                                       tgt_depth, b.gout, b.loss_r, S, s.Np,
                                                       white_bkgd, rgb_c, reg_c, depth_c);

  err = launch_backward<H>(s, b.gout, wout, b.whT, b.act, b.gbuf, D, L1, stream);
  if (err != cudaSuccess) return err;
  launch_dw(s, b.act, b.gbuf, b.gout, b.part, grads, D, H, L1, stream);
  loss_sum_kernel<<<1, 256, 0, stream>>>(b.loss_r, loss, R);
  return cudaGetLastError();
}

template <int H>
cudaError_t dispatch(int inline_pe, const float* in, const float* feats, const float* z,
                     const float* dnorm, const float* tgt, const float* mask,
                     const float* inv_denom, const float* tgt_depth, const float* e2,
                     const float* c, const float* w0, const float* b0, const float* wh,
                     const float* bh, const float* wout, const float* bout, float* loss,
                     float* grads, float* scratch, int R, int S, int n_raw, int n_phase, int Fd,
                     int D, int L1, int white_bkgd, float rgb_c, float reg_c, float depth_c,
                     cudaStream_t st) {
  if (inline_pe)
    return launch<H, true>(in, feats, z, dnorm, tgt, mask, inv_denom, tgt_depth, e2, c, w0, b0,
                           wh, bh, wout, bout, loss, grads, scratch, R, S, n_raw, n_phase, Fd, D,
                           L1, white_bkgd, rgb_c, reg_c, depth_c, st);
  return launch<H, false>(in, feats, z, dnorm, tgt, mask, inv_denom, tgt_depth, e2, c, w0, b0,
                          wh, bh, wout, bout, loss, grads, scratch, R, S, n_raw, n_phase, Fd, D,
                          L1, white_bkgd, rgb_c, reg_c, depth_c, st);
}

// Kernel 3: the VJP of the render from a pre-encoded x. Recomputes the
// forward, composites backward from the external cotangents, runs the
// backward chain and the dW products, and (dx != nullptr) the input
// cotangent.
template <int H>
cudaError_t launch_render_bwd(const float* x, const float* z, const float* dnorm,
                              const float* w0, const float* b0, const float* wh,
                              const float* bh, const float* wout, const float* bout,
                              const float* g_rgb, const float* g_depth, const float* g_acc,
                              const float* g_weights, float* dx, float* grads, float* scratch,
                              int R, int S, int D, int L1, int white_bkgd, cudaStream_t stream) {
  const Layout s = make_layout(R, S, D, H, L1);
  const Scratch b = carve(s, scratch);
  cudaError_t err = launch_forward<H, false>(s, x, nullptr, nullptr, nullptr, w0, b0, wh, bh,
                                             wout, bout, b.act, b.out4, b.whT, 0, 0, 0, D, L1,
                                             stream);
  if (err != cudaSuccess) return err;

  const size_t comp_smem = sizeof(float) * 9 * static_cast<size_t>(S);
  err = cudaFuncSetAttribute(render_composite_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(comp_smem));
  if (err != cudaSuccess) return err;
  render_composite_kernel<<<R, 32, comp_smem, stream>>>(b.out4, z, dnorm, g_rgb, g_depth, g_acc,
                                                        g_weights, b.gout, S, s.Np, white_bkgd);

  err = launch_backward<H>(s, b.gout, wout, b.whT, b.act, b.gbuf, D, L1, stream);
  if (err != cudaSuccess) return err;
  launch_dw(s, b.act, b.gbuf, b.gout, b.part, grads, D, H, L1, stream);
  if (dx != nullptr) {
    render_dx_kernel<<<dim3(s.Np / kBT, (D + kBT - 1) / kBT), 256, 0, stream>>>(b.gbuf, w0, dx,
                                                                                s.N, s.Np, D, H);
  }
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch one call at these sizes needs.
extern "C" unsigned long long nerf_train_scratch_floats(int R, int S, int D, int H, int L1) {
  return make_layout(R, S, D, H, L1).total;
}

extern "C" int nerf_train_objective(const float* in, const float* feats, const float* z,
                                    const float* dnorm, const float* tgt, const float* mask,
                                    const float* inv_denom, const float* tgt_depth,
                                    const float* e2, const float* c, const float* w0,
                                    const float* b0, const float* wh, const float* bh,
                                    const float* wout, const float* bout, float* loss,
                                    float* grads, float* scratch, int R, int S, int n_raw,
                                    int n_phase, int Fd, int D, int H, int L1, int inline_pe,
                                    int white_bkgd, float rgb_c, float reg_c, float depth_c,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (L1 + 2 > kMaxJobs) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 256)
    return dispatch<256>(inline_pe, in, feats, z, dnorm, tgt, mask, inv_denom, tgt_depth, e2, c,
                         w0, b0, wh, bh, wout, bout, loss, grads, scratch, R, S, n_raw, n_phase,
                         Fd, D, L1, white_bkgd, rgb_c, reg_c, depth_c, st);
  if (H == 128)
    return dispatch<128>(inline_pe, in, feats, z, dnorm, tgt, mask, inv_denom, tgt_depth, e2, c,
                         w0, b0, wh, bh, wout, bout, loss, grads, scratch, R, S, n_raw, n_phase,
                         Fd, D, L1, white_bkgd, rgb_c, reg_c, depth_c, st);
  return cudaErrorInvalidValue;
}

extern "C" int nerf_render_bwd(const float* x, const float* z, const float* dnorm,
                               const float* w0, const float* b0, const float* wh, const float* bh,
                               const float* wout, const float* bout, const float* g_rgb,
                               const float* g_depth, const float* g_acc, const float* g_weights,
                               float* dx, float* grads, float* scratch, int R, int S, int D, int H,
                               int L1, int white_bkgd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (L1 + 2 > kMaxJobs) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 256)
    return launch_render_bwd<256>(x, z, dnorm, w0, b0, wh, bh, wout, bout, g_rgb, g_depth, g_acc,
                                  g_weights, dx, grads, scratch, R, S, D, L1, white_bkgd, st);
  if (H == 128)
    return launch_render_bwd<128>(x, z, dnorm, w0, b0, wh, bh, wout, bout, g_rgb, g_depth, g_acc,
                                  g_weights, dx, grads, scratch, R, S, D, L1, white_bkgd, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
