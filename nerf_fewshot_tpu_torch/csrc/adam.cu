// One Adam (or AdamW) step of every parameter of a model in one launch,
// rounded as torch.optim.Adam(foreach=True) rounds it, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. It is the counterpart of the optax chain
// (add_decayed_weights, then scale_by_adam; nerf_fewshot_tpu/training/
// optim.py:56-57) that XLA fuses into the JAX trainer's one-dispatch epoch
// (epoch_fn, nerf_fewshot_tpu/training/trainer.py:474-537). The port's
// graphed step (nerf_fewshot_tpu_torch/training/step_graph.py) replays it
// once per minibatch, so it must take its per-step scalars from the device:
// torch's capturable Adam computes them there in another order (fp32 pow on
// the device, the denominator divided by the step size), and would move the
// parameters off the eager foreach step's bits.
//
// Arithmetic, per element, in the order and with the roundings of the
// eager foreach step (torch/optim/adam.py:_multi_tensor_adam; each rounding
// shown operation by operation on the card by tools/adam_bits.py):
//   g  = g + wd * p            _foreach_add(grads, params, alpha=wd): one FMA
//   m  = m + w1 * (g - m)      _foreach_lerp_(exp_avgs, grads, 1 - beta1): one FMA
//   v  = v * beta2             _foreach_mul_
//   v  = v + vs * (g * g)      _foreach_addcmul_(exp_avg_sqs, g, g, 1 - beta2): g*g, then one FMA
//   d  = sqrt(v) / bc2s + eps  _foreach_sqrt, _foreach_div_ (a scalar list), _foreach_add_
//   p  = p + ss * (m / d)      _foreach_addcdiv_(params, exp_avgs, d, step sizes): m/d, one FMA
// AdamW (decoupled decay) first scales p by (1 - lr * wd) (_foreach_mul_) and
// skips the first line. The constant scalars (wd, w1 = 1 - beta1, beta2,
// vs = 1 - beta2, eps) arrive as fp32 arguments; the per-step ones (ss =
// -lr / (1 - beta1^t), bc2s = sqrt(1 - beta2^t), and 1 - lr * wd) are a row
// of a device table the host fills once per epoch, each computed in float64
// and cast to fp32 as torch casts the Python scalars it hands to its
// foreach kernels. Explicit __fmaf_rn / __fmul_rn / __fadd_rn / __fdiv_rn /
// __fsqrt_rn fix every rounding: nvcc may contract nothing.
//
// The step index is a device counter (int64, so the trainer gathers its
// batch rows with it too): every block reads it at its start,
// and the last block to finish (a second counter, taken by atomicAdd)
// increments it and resets the second counter, so a graph replayed once per
// minibatch walks the table row by row without the host.
//
// Bound: bytes. Each element reads p, g, m, v and writes p, m, v: 28 bytes.
// At the baseline's 8x256 trunk (0.48 M parameters) that is 13.6 MB, 4.1 us
// at 3.35 TB/s; the arithmetic (a division, a square root, four FMAs) is far below
// the fp32 peak. Design: one multi-tensor pass, as torch's foreach kernels
// are, but in one launch for every operation: a table of (p, g, m, v,
// numel, first block) per tensor, blocks of 256 threads, each block 2048
// elements (8 per thread, coalesced) of one tensor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;

struct TensorEntry {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long numel;
  long long first_block;
};

// The scalars of a step's table row.
enum { kStepSize = 0, kBc2Sqrt = 1, kDecay = 2, kScalarsPerStep = 3 };

__global__ void __launch_bounds__(kThreads)
adam_step_kernel(const TensorEntry* __restrict__ table, int n_tensors,
                 const float* __restrict__ scalars, long long* counter, float wd, float w1,
                 float b2, float vs, float eps, int adamw) {
  __shared__ long long s_step;
  __shared__ int s_tensor;
  if (threadIdx.x == 0) {
    s_step = *reinterpret_cast<volatile long long*>(counter);
    int t = 0;
    while (t + 1 < n_tensors && table[t + 1].first_block <= blockIdx.x) ++t;
    s_tensor = t;
  }
  __syncthreads();
  const TensorEntry e = table[s_tensor];
  const float* row = scalars + s_step * kScalarsPerStep;
  const float ss = row[kStepSize], bc2s = row[kBc2Sqrt], decay = row[kDecay];
  const long long base = (blockIdx.x - e.first_block) * kChunk;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < e.numel) {
      float p = e.p[i], g = e.g[i], m = e.m[i], v = e.v[i];
      if (adamw) {
        p = __fmul_rn(p, decay);
      } else if (wd != 0.0f) {
        g = __fmaf_rn(wd, p, g);
      }
      m = __fmaf_rn(w1, __fsub_rn(g, m), m);
      v = __fmul_rn(v, b2);
      v = __fmaf_rn(vs, __fmul_rn(g, g), v);
      float d = __fsqrt_rn(v);
      d = __fdiv_rn(d, bc2s);
      d = __fadd_rn(d, eps);
      p = __fmaf_rn(ss, __fdiv_rn(m, d), p);
      e.p[i] = p;
      e.m[i] = m;
      e.v[i] = v;
    }
  }
  // the last block to finish moves the step index on
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    unsigned long long* done = reinterpret_cast<unsigned long long*>(counter + 1);
    if (atomicAdd(done, 1ULL) == gridDim.x - 1ULL) {
      counter[0] = s_step + 1;
      counter[1] = 0;
      __threadfence();
    }
  }
}

}  // namespace

// Elements per block: the host sizes each tensor's run of blocks with it.
extern "C" int nerf_adam_chunk() { return kChunk; }

// One step over the n_tensors entries of `table` (device memory, 6 int64
// per tensor: p, g, m, v, numel, first block), n_blocks blocks in all;
// `scalars` the epoch's (steps, 3) table, `counter` two int64 on the device
// (the step index, the blocks done: 0 between launches).
extern "C" int nerf_adam_step(const void* table, int n_tensors, int n_blocks,
                              const float* scalars, long long* counter, float wd, float w1, float b2,
                              float vs, float eps, int adamw, void* stream) {
  if (n_blocks <= 0 || n_tensors <= 0) return 0;
  adam_step_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TensorEntry*>(table), n_tensors, scalars, counter, wd, w1, b2, vs, eps,
      adamw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
