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
// exp and log is XLA's f32 one (threefry.cuh: exp_xla, log_xla), so the
// softmax numerators are the reference's and g is jax.random's draw bit for
// bit; the argmax takes the first index on ties and a NaN over any number,
// as jnp.argmax does. It writes the next token, the BMA probabilities
// (slots, V) f32 and the entropy.
//
// All arithmetic is f32, every operation an explicit IEEE intrinsic. The
// order of the two sums over V (each sample's softmax denominator and the
// entropy), which the plain version (bma_sample.py: bma_sample_plain)
// follows op for op so that the two agree bit for bit: the vocabulary is
// cut into kCluster chunks of ceil(V / kCluster) entries (rounded up to a
// whole pack), one a CTA; a chunk into packs of PK entries (4 when V is a
// multiple of 4: 16 bytes of f32, 8 of bf16; else 1); thread tid of a CTA
// takes packs tid, tid + 256, ... and adds their entries in order from +0;
// then a halving tree over the warp's 32 lanes (xor 16, ..., 1); then the
// CTA's 8 warps in index order from +0; then the kCluster CTAs in rank
// order from +0. The maxima and the argmax are order-free. Each p_m =
// e / sum is correctly rounded (threefry.cuh: div_rn, Markstein's
// correction of a product by the reciprocal).
//
// Design: a thread block cluster of kCluster = 16 CTAs a slot (the
// non-portable size), so a step of 8 slots runs 128 CTAs. Each CTA reads
// its chunk of every sample's logits, kPacks packs and kBatch samples a
// thread at once: pass 1 takes each sample's max; pass 2 its sum of
// exp_xla(x - max), keeping the exps in shared memory where the chunk's
// fit (kept: no third read); pass 3 the BMA mean, its entropy terms and
// the perturbed scores. The
// Gumbel noise of the chunk (threefry and two logs an entry) is drawn into
// shared memory while the maxima cross the cluster. The CTAs push their
// partial maxima, sums, entropies and best (score, index) into each
// other's shared memory (distributed shared memory) and meet at a split
// cluster barrier (arrive, then wait); every CTA reads the partials in
// rank order, so all hold the same totals, and only rank 0 waits for the
// last. No scratch is allocated; the launch is capturable in a CUDA graph.
// What bounds it: at V = 49,152 the logits' bytes (0.8 MB at 8 slots, so
// about 0.25 us) are far below the work of the noise (threefry's INT32
// hash and two logs an entry) and of M exps an entry; phase timings with
// clock64 (chip_smoke.py's card, an NVIDIA H100 80GB HBM3 at 700 W) put
// the noise and the two passes at about a third each of a CTA's time, and
// the SMs that hold two CTAs of a cluster set the kernel's end. Its first
// form, one CTA a slot with exp in float64, took 0.1925 ms at 8 slots.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {

constexpr int kSampleThreads = 256;
constexpr int kSampleWarps = kSampleThreads / 32;
constexpr int kMaxSamples = 64;      // bma_sample.py: MAX_SAMPLES
constexpr int kCluster = 16;         // bma_sample.py: CLUSTER
constexpr int kBatch = 4;            // samples whose loads a thread batches
constexpr int kPacks = 4;            // packs whose loads a thread batches
// the dynamic shared memory a CTA may take (bma_sample.py: MAX_DYN_SMEM)
constexpr int kMaxDynamicSmem = 200 * 1024;

__device__ __forceinline__ float nan_max_f(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// jnp.argmax's order: a NaN first, then the larger value, then the lower
// index
__device__ __forceinline__ bool better(float a, int i, float b, int j) {
  const bool na = a != a, nb = b != b, first = i < j;
  // no branch: (a NaN, b not) or (the same NaN-ness and (a > b, or a tie
  // broken by the lower index)); a tie of two NaNs falls to the index
  return (na & !nb) | (!(na ^ nb) & ((a > b) | (((a == b) | na) & first)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max_f(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void warp_best(float& best, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (better(ob, oi, best, idx)) {
      best = ob;
      idx = oi;
    }
  }
}

// a pack of PK logits (PK = 1, or 4 entries of T), as f32 values times
// inv_temp
template <typename T, int PK>
__device__ __forceinline__ void scale_pack(const uint4& u, float inv_temp,
                                           float (&f)[PK]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (PK == 1) {
    f[0] = __fmul_rn(sizeof(T) == 4 ? __uint_as_float(w[0])
                                    : __uint_as_float(w[0] << 16),
                     inv_temp);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[k] = __fmul_rn(__uint_as_float(w[k]), inv_temp);
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      f[2 * k] = __fmul_rn(__uint_as_float(w[k] << 16), inv_temp);
      f[2 * k + 1] = __fmul_rn(__uint_as_float(w[k] & 0xffff0000u),
                               inv_temp);
    }
  }
}

// the raw pack at x: 4 entries (16 bytes of f32, 8 of bf16), or one entry
// in the low bits
template <typename T, int PK>
__device__ __forceinline__ uint4 load_pack(const T* x) {
  if constexpr (PK > 1 && sizeof(T) == 4) {
    return *reinterpret_cast<const uint4*>(x);
  } else if constexpr (PK > 1) {
    const uint2 u = *reinterpret_cast<const uint2*>(x);
    return make_uint4(u.x, u.y, 0u, 0u);
  } else if constexpr (sizeof(T) == 4) {
    return make_uint4(*reinterpret_cast<const uint32_t*>(x), 0u, 0u, 0u);
  } else {
    return make_uint4(*reinterpret_cast<const unsigned short*>(x), 0u, 0u,
                      0u);
  }
}

// the split cluster barrier: arrive (releasing this thread's writes, to
// the CTA's and its peers' shared memory), then wait (acquiring theirs)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct SampleArgs {
  const void* logits;       // (M, slots, V) compute dtype
  const long long* keys;    // (slots, 2) uint32 words
  const long long* pos;     // (slots,)
  long long* next;          // (slots,)
  float* probs;             // (slots, V)
  float* entropy;           // (slots,)
  int samples, slots, vocab, chunk;
  float inv_temp, inv_samples, tiny;
};

template <typename T, int PK, bool CACHE>
__global__ void __launch_bounds__(kSampleThreads, 2)
bma_sample_kernel(const __grid_constant__ SampleArgs a) {
  // the CTAs' partials, pushed into every CTA (rank-major), and the last
  // stage's into rank 0
  __shared__ float all_max[kCluster * kMaxSamples];
  __shared__ float all_sum[kCluster * kMaxSamples];
  __shared__ float all_ent[kCluster], all_best[kCluster];
  __shared__ int all_idx[kCluster];
  // the cluster's maxima and sums (with their reciprocals) and the warps'
  // partials
  __shared__ float mx[kMaxSamples], tot[kMaxSamples], rtot[kMaxSamples];
  __shared__ float red[kSampleWarps * kMaxSamples];
  __shared__ int red_i[kSampleWarps];
  extern __shared__ float dyn[];        // the chunk's noise, then exps
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / kCluster, tid = threadIdx.x;
  const int warp = tid / 32, ln = tid % 32, M = a.samples;
  const long long V = a.vocab;
  const int base = rank * a.chunk;
  const int end = (int)min((long long)base + a.chunk, V);
  const int npk = end > base ? (end - base) / PK : 0;  // PK divides it
  const T* lg = static_cast<const T*>(a.logits) + (long long)s * V + base;
  const long long sample = (long long)a.slots * V;   // a sample's stride
  float* noise = dyn;                   // (chunk,)
  float* exps = dyn + a.chunk;          // (M, chunk) where cached
  cluster_arrive();                     // this CTA has started

  // a thread's packs are tid, tid + 256, ...; passes 1 and 2 load kPacks
  // of them for kBatch samples at once (a pack past the last, or a sample
  // past M, repeats the last one and is not counted)
  auto load_block = [&](int j0, int m0, uint4 (&raw)[kPacks][kBatch]) {
#pragma unroll
    for (int pp = 0; pp < kPacks; ++pp)
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        raw[pp][k] = load_pack<T, PK>(
            lg + min(m0 + k, M - 1) * sample +
            min(j0 + kSampleThreads * pp, npk - 1) * PK);
  };
  constexpr int kStride = kSampleThreads * kPacks;

  // pass 1: each sample's max over the chunk
  for (int m0 = 0; m0 < M; m0 += kBatch) {
    float lm[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) lm[k] = -__int_as_float(0x7f800000);
    for (int j0 = tid; j0 - tid < npk; j0 += kStride) {
      uint4 raw[kPacks][kBatch];
      load_block(j0, m0, raw);
#pragma unroll
      for (int pp = 0; pp < kPacks; ++pp)
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          float f[PK];
          scale_pack<T, PK>(raw[pp][k], a.inv_temp, f);
#pragma unroll
          for (int e = 0; e < PK; ++e) lm[k] = nan_max_f(lm[k], f[e]);
        }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (m0 + k < M) {
        const float v = warp_max(lm[k]);
        if (ln == 0) red[warp * kMaxSamples + m0 + k] = v;
      }
    }
  }
  __syncthreads();
  cluster_wait();                       // every CTA has started
  for (int m = tid; m < M; m += kSampleThreads) {
    float v = red[m];
    for (int w = 1; w < kSampleWarps; ++w)
      v = nan_max_f(v, red[w * kMaxSamples + m]);
#pragma unroll
    for (int q = 0; q < kCluster; ++q)
      cluster.map_shared_rank(all_max, q)[rank * kMaxSamples + m] = v;
  }
  cluster_arrive();
  // the perturbation of the thread's entries while the maxima travel:
  // gumbel(fold_in(key, pos)) at counters (0, v)
  {
    const uint2 key = threefry2x32((uint32_t)a.keys[2 * s],
                                   (uint32_t)a.keys[2 * s + 1], 0u,
                                   (uint32_t)a.pos[s]);          // fold_in
    for (int j = tid; j < npk; j += kSampleThreads) {
#pragma unroll
      for (int e = 0; e < PK; ++e) {
        const uint2 y = threefry2x32(key.x, key.y, 0u,
                                     (uint32_t)(base + j * PK + e));
        noise[j * PK + e] = gumbel_of(y.x ^ y.y, a.tiny, 1.0f);
      }
    }
  }
  cluster_wait();
  for (int m = tid; m < M; m += kSampleThreads) {
    float v = -__int_as_float(0x7f800000);
    for (int q = 0; q < kCluster; ++q)
      v = nan_max_f(v, all_max[q * kMaxSamples + m]);
    mx[m] = v;
  }
  __syncthreads();                      // mx; red is rewritten below

  // pass 2: each sample's sum of exp_xla(x - max), in the fixed order; the
  // exps kept where they fit
  for (int m0 = 0; m0 < M; m0 += kBatch) {
    // samples past M (the last batch's) repeat sample M - 1 and are not
    // counted: no branch in the loop
    float ls[kBatch], mm[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      ls[k] = 0.0f;
      mm[k] = mx[min(m0 + k, M - 1)];
    }
    for (int j0 = tid; j0 - tid < npk; j0 += kStride) {
      uint4 raw[kPacks][kBatch];
      load_block(j0, m0, raw);
#pragma unroll
      for (int pp = 0; pp < kPacks; ++pp) {
        const int j = j0 + kSampleThreads * pp;
        if (j < npk) {
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            float f[PK];
            scale_pack<T, PK>(raw[pp][k], a.inv_temp, f);
#pragma unroll
            for (int e = 0; e < PK; ++e) {
              const float ex = exp_xla(__fsub_rn(f[e], mm[k]));
              ls[k] = __fadd_rn(ls[k], ex);
              if constexpr (CACHE)
                exps[min(m0 + k, M - 1) * a.chunk + j * PK + e] = ex;
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (m0 + k < M) {
        const float v = warp_sum(ls[k]);
        if (ln == 0) red[warp * kMaxSamples + m0 + k] = v;
      }
    }
  }
  __syncthreads();
  for (int m = tid; m < M; m += kSampleThreads) {
    float v = 0.0f;
    for (int w = 0; w < kSampleWarps; ++w)
      v = __fadd_rn(v, red[w * kMaxSamples + m]);
#pragma unroll
    for (int q = 0; q < kCluster; ++q)
      cluster.map_shared_rank(all_sum, q)[rank * kMaxSamples + m] = v;
  }
  cluster_arrive();
  cluster_wait();
  for (int m = tid; m < M; m += kSampleThreads) {
    float v = 0.0f;
    for (int q = 0; q < kCluster; ++q)
      v = __fadd_rn(v, all_sum[q * kMaxSamples + m]);
    tot[m] = v;
    rtot[m] = __frcp_rn(v);
  }
  __syncthreads();                      // tot, rtot

  // pass 3: the BMA mean, its entropy terms and the perturbed scores
  float lent = 0.0f;
  float best = -__int_as_float(0x7f800000);
  int bidx = 0x7fffffff;
  float* probs = a.probs + (long long)s * V + base;
  for (int j = tid; j < npk; j += kSampleThreads) {
    float acc[PK], ex[kBatch][PK], pm[kBatch][PK];
    for (int m0 = 0; m0 < M; m0 += kBatch) {
      bool slow = false;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int m = min(m0 + k, M - 1);
        if constexpr (CACHE) {
#pragma unroll
          for (int e = 0; e < PK; ++e)
            ex[k][e] = exps[m * a.chunk + j * PK + e];
        } else {
          float f[PK];
          scale_pack<T, PK>(load_pack<T, PK>(lg + m * sample + j * PK),
                            a.inv_temp, f);
#pragma unroll
          for (int e = 0; e < PK; ++e)
            ex[k][e] = exp_xla(__fsub_rn(f[e], mx[m]));
        }
#pragma unroll
        for (int e = 0; e < PK; ++e)
          pm[k][e] = div_rn(ex[k][e], tot[m], rtot[m], slow);
      }
      if (slow) {
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
#pragma unroll
          for (int e = 0; e < PK; ++e)
            pm[k][e] = __fdiv_rn(ex[k][e], tot[min(m0 + k, M - 1)]);
      }
      // the mean's sum in sample order; a repeated sample is not added
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int m = m0 + k;
#pragma unroll
        for (int e = 0; e < PK; ++e)
          acc[e] = m >= M ? acc[e] : m ? __fadd_rn(acc[e], pm[k][e])
                                       : pm[k][e];
      }
    }
#pragma unroll
    for (int e = 0; e < PK; ++e) {
      const float p = __fmul_rn(acc[e], a.inv_samples);
      acc[e] = p;
      const float l = log_xla(p != p ? p : fmaxf(p, 1e-12f));
      lent = __fadd_rn(lent, __fmul_rn(p, l));
      const int v = base + j * PK + e;
      const float score = __fadd_rn(noise[j * PK + e], l);
      const bool take = better(score, v, best, bidx);
      best = take ? score : best;
      bidx = take ? v : bidx;
    }
    if constexpr (PK == 1) {
      probs[j] = acc[0];
    } else {
      reinterpret_cast<float4*>(probs)[j] = make_float4(acc[0], acc[1],
                                                        acc[2], acc[3]);
    }
  }
  lent = warp_sum(lent);
  warp_best(best, bidx);
  if (ln == 0) {
    red[warp] = lent;
    red[kSampleWarps + warp] = best;
    red_i[warp] = bidx;
  }
  __syncthreads();
  if (tid == 0) {
    float v = 0.0f, b = red[kSampleWarps];
    int bi = red_i[0];
    for (int w = 0; w < kSampleWarps; ++w) {
      v = __fadd_rn(v, red[w]);
      if (better(red[kSampleWarps + w], red_i[w], b, bi)) {
        b = red[kSampleWarps + w];
        bi = red_i[w];
      }
    }
    cluster.map_shared_rank(all_ent, 0)[rank] = v;
    cluster.map_shared_rank(all_best, 0)[rank] = b;
    cluster.map_shared_rank(all_idx, 0)[rank] = bi;
  }
  cluster_arrive();                     // the last barrier: rank 0 waits
  if (rank == 0) {
    cluster_wait();
    if (tid == 0) {
      float v = 0.0f, b = all_best[0];
      int bi = all_idx[0];
      for (int q = 0; q < kCluster; ++q) {
        v = __fadd_rn(v, all_ent[q]);
        if (better(all_best[q], all_idx[q], b, bi)) {
          b = all_best[q];
          bi = all_idx[q];
        }
      }
      a.next[s] = bi;
      a.entropy[s] = -v;
    }
  }
}

// the cluster size above 8 is allowed once a kernel (not in a capture)
template <typename T, int PK, bool CACHE>
cudaError_t allow_cluster() {
  static bool ready = false;
  if (ready) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      bma_sample_kernel<T, PK, CACHE>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bma_sample_kernel<T, PK, CACHE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynamicSmem);
  ready = err == cudaSuccess;
  return err;
}

template <typename T, int PK, bool CACHE>
int launch(const SampleArgs& a, cudaStream_t stream) {
  const cudaError_t ok = allow_cluster<T, PK, CACHE>();
  if (ok != cudaSuccess) return (int)ok;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.slots * kCluster, 1, 1);
  cfg.blockDim = dim3(kSampleThreads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(float) * (size_t)a.chunk *
                         (CACHE ? 1 + a.samples : 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, bma_sample_kernel<T, PK, CACHE>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// One launch for `slots` slots: logits (samples, slots, vocab) in the
// compute dtype (bf16 if compute_bf16, else f32), 16-byte aligned; keys
// (slots, 2) int64 words and pos (slots,) int64; writes next (slots,)
// int64, probs (slots, vocab) f32 (16-byte aligned) and entropy (slots,)
// f32. pack: the entries a thread reads at once, 4 or 1 (bma_sample.py:
// pack_of); chunk: a CTA's entries, a multiple of pack (chunk_of);
// cache_exp: keep the chunk's exps in shared memory (chunk x (1 + samples)
// f32 of it, else chunk f32). inv_temp = fl32(1 / temperature),
// inv_samples = fl32(1 / samples), tiny = the smallest normal f32.
extern "C" int repro_bma_sample(const void* logits, const long long* keys,
                                const long long* pos, long long* next,
                                float* probs, float* entropy, int samples,
                                int slots, int vocab, int pack, int chunk,
                                int cache_exp, float inv_temp,
                                float inv_samples, float tiny,
                                int compute_bf16, void* stream) {
  using namespace repro_torch;
  const long long smem = 4LL * chunk * (cache_exp ? 1 + samples : 1);
  if (samples < 1 || samples > kMaxSamples || slots < 1 || vocab < 1 ||
      (pack != 1 && (pack != 4 || vocab % pack)) || chunk < 1 ||
      chunk % pack || (long long)chunk * kCluster < vocab ||
      smem > kMaxDynamicSmem || (long long)slots * kCluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const SampleArgs a{logits, keys, pos, next, probs, entropy, samples,
                     slots, vocab, chunk, inv_temp, inv_samples, tiny};
  cudaStream_t st = (cudaStream_t)stream;
  if (compute_bf16) {
    if (pack == 1)
      return cache_exp ? launch<__nv_bfloat16, 1, true>(a, st)
                       : launch<__nv_bfloat16, 1, false>(a, st);
    return cache_exp ? launch<__nv_bfloat16, 4, true>(a, st)
                     : launch<__nv_bfloat16, 4, false>(a, st);
  }
  if (pack == 1)
    return cache_exp ? launch<float, 1, true>(a, st)
                     : launch<float, 1, false>(a, st);
  return cache_exp ? launch<float, 4, true>(a, st)
                   : launch<float, 4, false>(a, st);
}
