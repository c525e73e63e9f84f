// The decode engine's sampler under Bayesian model averaging, for Hopper
// (sm_90a): one launch a step for every slot.
//
// The reference's DecodeEngine (repro/serve/engine.py:356-380) runs it as
// jnp inside its jitted step; no pl.pallas_call. For slot s, from the M
// posterior samples' logits (M, slots, V) in the compute dtype:
//
//   x_m = logits_m * fl32(1 / temp)              (jit folds / temp, C5)
//   p_m = exp(x_m - max x_m) / sum exp(x_m - max x_m)   (f32 softmax)
//   p   = (((p_0 + p_1) + p_2) + ...) * fl32(1 / M)     (jnp.mean, C11)
//   H   = -sum p log max(p, 1e-12)              (predictive_entropy)
//   t   = argmax log max(p, 1e-12) + g          (jax.random.categorical)
//
// with g = gumbel(fold_in(key_s, pos_s), (V,)): threefry bits of the folded
// key on counters (0, v), u uniform in [tiny, 1), g = -log(-log(u)). Every
// log is XLA's f32 log (threefry.cuh: log_xla), so g is jax.random's draw
// bit for bit; the argmax takes the first index on ties and a NaN over any
// number, as jnp.argmax does. It writes the next token, the BMA
// probabilities (slots, V) f32 and the entropy.
//
// exp is taken in double and rounded to f32, and the sums over V (the
// softmax's and the entropy's) add f32 terms in double: the plain version
// (bma_sample.py) does the same in torch's order, and the two round to the
// same f32 unless a double's rounding error meets an f32 tie, so the tokens
// agree bit for bit. The reference uses XLA's exp and sums in f32, so its
// probabilities differ from these in the last bits.
//
// Design: a CTA of 1024 threads a slot. Pass 1 takes each sample's max and
// sum over V (block reductions in a fixed order); pass 2 recomputes each
// element's M softmax terms, writes p, and carries the entropy's partial
// sum and the best (score, index) pair, reduced across the CTA at the end.
// What bounds it: the logits' bytes (read twice, the second time mostly
// from L2) against threefry's INT32 operations; with one CTA a slot, a step
// of 8 slots uses 8 of the 132 SMs.
#include <cuda_bf16.h>

#include "threefry.cuh"

namespace repro_torch {

constexpr int kSampleThreads = 1024;
constexpr int kSampleWarps = kSampleThreads / 32;
constexpr int kMaxSamples = 64;      // bma_sample.py: MAX_SAMPLES

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float nan_max_f(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// jnp.argmax's order: a NaN first, then the larger value, then the lower
// index
__device__ __forceinline__ bool better(float a, int i, float b, int j) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return i < j;
}

// a block's sum of one double a thread, in a fixed order
__device__ double block_sum(double v, double* red) {
  const int ln = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (ln == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[ln];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (ln == 0) red[0] = v;
  }
  __syncthreads();
  const double out = red[0];
  __syncthreads();
  return out;
}

__device__ float block_max(float v, float* red) {
  const int ln = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max_f(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (ln == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[ln];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = nan_max_f(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (ln == 0) red[0] = v;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

struct SampleArgs {
  const void* logits;       // (M, slots, V) compute dtype
  const long long* keys;    // (slots, 2) uint32 words
  const long long* pos;     // (slots,)
  long long* next;          // (slots,)
  float* probs;             // (slots, V)
  float* entropy;           // (slots,)
  int samples, slots, vocab;
  float inv_temp, inv_samples, tiny;
};

template <typename T>
__global__ void __launch_bounds__(kSampleThreads)
bma_sample_kernel(const __grid_constant__ SampleArgs a) {
  __shared__ float mx[kMaxSamples], tot[kMaxSamples];
  __shared__ double red_d[kSampleWarps];
  __shared__ float red_f[kSampleWarps];
  __shared__ int red_i[kSampleWarps];
  const int s = blockIdx.x, tid = threadIdx.x;
  const long long V = a.vocab;
  const T* lg = static_cast<const T*>(a.logits);

  // pass 1: each sample's max and sum of exp over the vocabulary
  for (int m = 0; m < a.samples; ++m) {
    const T* x = lg + ((long long)m * a.slots + s) * V;
    float lm = -__int_as_float(0x7f800000);
    for (long long v = tid; v < V; v += kSampleThreads)
      lm = nan_max_f(lm, __fmul_rn(to_f32(x[v]), a.inv_temp));
    const float mm = block_max(lm, red_f);
    double ls = 0.0;
    for (long long v = tid; v < V; v += kSampleThreads)
      ls += (double)(float)exp(
          (double)__fsub_rn(__fmul_rn(to_f32(x[v]), a.inv_temp), mm));
    const double sum = block_sum(ls, red_d);
    if (tid == 0) {
      mx[m] = mm;
      tot[m] = (float)sum;
    }
  }
  __syncthreads();

  // pass 2: the BMA mean, its entropy terms and the perturbed scores
  const uint2 key = threefry2x32((uint32_t)a.keys[2 * s],
                                 (uint32_t)a.keys[2 * s + 1], 0u,
                                 (uint32_t)a.pos[s]);          // fold_in
  double lent = 0.0;
  float best = -__int_as_float(0x7f800000);
  int bidx = 0x7fffffff;
  for (long long v = tid; v < V; v += kSampleThreads) {
    float acc = 0.0f;
    for (int m = 0; m < a.samples; ++m) {
      const float x = __fmul_rn(
          to_f32(lg[((long long)m * a.slots + s) * V + v]), a.inv_temp);
      const float e = (float)exp((double)__fsub_rn(x, mx[m]));
      const float pm = __fdiv_rn(e, tot[m]);
      acc = m ? __fadd_rn(acc, pm) : pm;
    }
    const float p = __fmul_rn(acc, a.inv_samples);
    a.probs[(long long)s * V + v] = p;
    const float l = log_xla(p != p ? p : fmaxf(p, 1e-12f));
    lent += (double)__fmul_rn(p, l);
    const uint2 y = threefry2x32(key.x, key.y, 0u, (uint32_t)v);
    const float score = __fadd_rn(gumbel_of(y.x ^ y.y, a.tiny, 1.0f), l);
    if (better(score, (int)v, best, bidx)) {
      best = score;
      bidx = (int)v;
    }
  }
  const double ent = block_sum(lent, red_d);
  // the best (score, index) of the CTA, in jnp.argmax's order
  const int ln = tid % 32, warp = tid / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
    if (better(ob, oi, best, bidx)) {
      best = ob;
      bidx = oi;
    }
  }
  if (ln == 0) {
    red_f[warp] = best;
    red_i[warp] = bidx;
  }
  __syncthreads();
  if (warp == 0) {
    best = red_f[ln];
    bidx = red_i[ln];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
      if (better(ob, oi, best, bidx)) {
        best = ob;
        bidx = oi;
      }
    }
    if (ln == 0) {
      a.next[s] = bidx;
      a.entropy[s] = -(float)ent;
    }
  }
}

}  // namespace repro_torch

// One launch for `slots` slots: logits (samples, slots, vocab) in the
// compute dtype (bf16 if compute_bf16, else f32); keys (slots, 2) int64
// words and pos (slots,) int64; writes next (slots,) int64, probs (slots,
// vocab) f32 and entropy (slots,) f32. inv_temp = fl32(1 / temperature),
// inv_samples = fl32(1 / samples), tiny = the smallest normal f32.
extern "C" int repro_bma_sample(const void* logits, const long long* keys,
                                const long long* pos, long long* next,
                                float* probs, float* entropy, int samples,
                                int slots, int vocab, float inv_temp,
                                float inv_samples, float tiny,
                                int compute_bf16, void* stream) {
  using namespace repro_torch;
  if (samples < 1 || samples > kMaxSamples || slots < 1 || vocab < 1)
    return (int)cudaErrorInvalidValue;
  const SampleArgs a{logits, keys, pos, next, probs, entropy, samples,
                     slots, vocab, inv_temp, inv_samples, tiny};
  cudaStream_t st = (cudaStream_t)stream;
  if (compute_bf16)
    bma_sample_kernel<__nv_bfloat16><<<slots, kSampleThreads, 0, st>>>(a);
  else
    bma_sample_kernel<float><<<slots, kSampleThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
