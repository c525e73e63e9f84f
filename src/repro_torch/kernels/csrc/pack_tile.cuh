// Block-top-k selection of one 1024-element block per warp, shared by
// pack.cu (pack_topk, HAS_V = false), fused_compress.cu (delta_pack,
// HAS_V = true) and block_topk.cu (the dense masked output). It gives the
// reference's tile body (src/repro/kernels/pack.py:39-80, _pack_tile)
// exactly: the 40-step f32 threshold bisection's lo and hi, then the
// two-tier rank (definite survivors first, then ties at the threshold in
// index order). block_topk_pallas (src/repro/kernels/block_topk.py:28-51)
// runs the same bisection and tie rule.
//
// The selection. Every decision of the reference's bisection is
// count(|d| >= mid) >= k, which holds exactly when v_k >= mid, v_k being
// the block's k-th largest magnitude counted with multiplicity. So the 40
// steps depend only on the block's maximum m and on v_k, and bisect_block
// finds them in two steps:
//   (a) v_k exactly, by an MSB-first search on its bits (non-negative
//       floats order as their bit patterns): at most 31 passes of 32
//       register compares and adds a lane plus one __reduce_add_sync, with
//       no ballots and no popcounts (Hopper retires 16 popcounts per SM per
//       clock, a quarter of its compare rate), stopping early once exactly
//       k magnitudes reach the candidate;
//   (b) the 40 steps replayed in scalar registers from m and v_k, with the
//       reference's f32 arithmetic, identical in every lane.
// The survivor set and slot order still come from lo and hi through the
// two-tier rank, one pass of two ballots a row, so a radix select's
// different choice inside the final bracket never arises. What bounds the
// tile is instruction issue: ~70 warp instructions a pass of (a), and the
// rank's ~160 popcounts a lane.
//
// Non-finite blocks follow the reference (ROADMAP C6): m propagates NaN as
// jnp.max does, so a block holding a NaN ends at lo = 0, hi = NaN and keeps
// its first k non-NaN elements; ±inf take part as magnitudes.
//
// Layout: lane l of a warp holds elements j*32 + l (j = 0..31) of its block
// in registers, so every load is one coalesced 128-byte row and element
// order is (j, lane). The rank of an element is a prefix popcount of its
// ballot row plus a running total that every lane holds.
//
// v may be stored in bfloat16 or float16 (FedConfig.control_dtype, ROADMAP
// A3): the tile then reads the 2-byte elements and widens each in registers, which
// is exact, so d = θ − v is the f32 subtraction the reference computes
// after its v.astype(f32). A lane's loads keep their pattern: element
// j*32 + lane, a warp's 32 loads one coalesced 64-byte row.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kBlock = 1024;            // elements per top-k block
constexpr int kPerLane = kBlock / 32;   // values a lane keeps in registers
constexpr int kBisectIters = 40;        // pack.py: BISECT_ITERS
constexpr int kWarpsPerCta = 8;
constexpr int kMaxLeaves = 32;          // pack.py: MAX_TABLE_LEAVES
constexpr unsigned kFull = 0xffffffffu;

// The steps of one warp's block, shared by the packed kernel below and the
// dense kernel of block_topk.cu. Lane l of the warp holds elements
// j*32 + l of the block in d[j].

// false for ±inf and NaN
__device__ __forceinline__ bool is_finite(float a) {
  return fabsf(a) <= 3.40282347e38f;
}

// max that keeps a NaN, as jnp.max does (fmaxf drops it): one
// instruction, PTX's max.NaN
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// a stored control-variate element as f32 (exact for bfloat16 and float16,
// subnormal halves included)
__device__ __forceinline__ float widen(float a) { return a; }
__device__ __forceinline__ float widen(__nv_bfloat16 a) {
  return __bfloat162float(a);
}
__device__ __forceinline__ float widen(__half a) { return __half2float(a); }

// Load the block that starts at element `start` of a row (d = x − v when
// HAS_V: the residual is formed here and lives only in registers, which is
// fused_compress.py's point; v's elements are VT, float, bfloat16 or half).
// Elements at or past n read as 0, as the reference's zero padding of the
// ragged last block: such zeros can be picked as ties. A whole block takes
// its loads unpredicated.
template <bool HAS_V, typename VT = float>
__device__ __forceinline__ void load_block(const float* __restrict__ xr,
                                           const VT* __restrict__ vr,
                                           long long start, long long n,
                                           int lane, float (&d)[kPerLane]) {
  const float* xb = xr + start + lane;
  const VT* vb = HAS_V ? vr + start + lane : nullptr;
  if (start + kBlock <= n) {                      // uniform within a warp
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      d[j] = HAS_V ? __fsub_rn(xb[j * 32], widen(vb[j * 32])) : xb[j * 32];
    return;
  }
  const long long left = n - start - lane;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    float t = 0.0f;
    if (j * 32 < left) {
      t = xb[j * 32];
      if (HAS_V) t = __fsub_rn(t, widen(vb[j * 32]));
    }
    d[j] = t;
  }
}

// The block's largest magnitude, NaN if it holds one, in every lane.
__device__ __forceinline__ float block_max(const float (&d)[kPerLane]) {
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) m = max_keep_nan(m, fabsf(d[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max_keep_nan(m, __shfl_xor_sync(kFull, m, off));
  return m;
}

// (a) v_k, the k-th largest of the block's 1,024 magnitudes. Bit b of v_k
// is set exactly when at least k magnitudes are >= (the bits found so far
// with bit b set); candidates past +inf's bits are NaN and count nothing,
// and a NaN magnitude is never counted (NaN >= c is false). A lane counts
// its 32 compares as four partial sums of 1.0s and 0.0s (exact small
// integers): a compare that writes the float (FSET) and an add on the FMA
// pipe, in four independent chains. When exactly k magnitudes reach a
// candidate, they are the k largest, and v_k is their least: the search
// stops there, well before the 31st pass on continuous data (ties at v_k
// run all 31).
__device__ __forceinline__ float kth_magnitude(const float (&d)[kPerLane],
                                               int k) {
  unsigned bits = 0u;
#pragma unroll 1
  for (int b = 30; b >= 0; --b) {
    const unsigned cand = bits | (1u << b);
    const float c = __uint_as_float(cand);
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      part[j & 3] = __fadd_rn(part[j & 3], fabsf(d[j]) >= c ? 1.0f : 0.0f);
    const float mine = __fadd_rn(__fadd_rn(part[0], part[1]),
                                 __fadd_rn(part[2], part[3]));
    const int count = (int)__reduce_add_sync(kFull, (unsigned)mine);
    if (count < k) continue;
    bits = cand;
    if (count == k) {
      float least = __uint_as_float(0x7f800000u);           // +inf
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        if (fabsf(d[j]) >= c) least = fminf(least, fabsf(d[j]));
      return __uint_as_float(__reduce_min_sync(kFull, __float_as_uint(least)));
    }
  }
  return __uint_as_float(bits);
}

// (b) The reference's 40-step bisection, replayed: count(|d| >= mid) >= k
// is v_k >= mid. On return count(|d| >= lo) >= k and count(|d| >= hi) < k,
// as the reference's invariants say, for every finite block.
__device__ __forceinline__ void bisect_block(const float (&d)[kPerLane],
                                             float m, int k, float& lo,
                                             float& hi) {
  const float vk = kth_magnitude(d, k);
  lo = 0.0f;
  hi = __fadd_rn(m, 1.0f);
#pragma unroll
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (vk >= mid) lo = mid; else hi = mid;
  }
}

// The two-tier rank: definite survivors (|d| >= hi) take slots 0, 1, ...
// in element order, then ties (lo <= |d| < hi) the next slots in element
// order. Calls emit(j, keep, slot) for every d[j] of this lane, in element
// order; keep is true for the k survivors (the reference's
// mask_def | (mask_tie & pos_tie < k)) and slot is then the survivor's slot.
template <class Emit>
__device__ __forceinline__ void rank_block(const float (&d)[kPerLane],
                                           float lo, float hi, int k,
                                           int lane, Emit emit) {
  int n_def = 0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    n_def += __popc(__ballot_sync(kFull, fabsf(d[j]) >= hi));

  const unsigned below = (1u << lane) - 1u;       // lanes before this one
  int c_def = 0, c_tie = n_def;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const float a = fabsf(d[j]);
    const bool is_def = a >= hi;
    const bool is_tie = !is_def && a >= lo;
    const unsigned b_def = __ballot_sync(kFull, is_def);
    const unsigned b_tie = __ballot_sync(kFull, is_tie);
    const int pos = is_def ? c_def + __popc(b_def & below)
                           : c_tie + __popc(b_tie & below);
    emit(j, (is_def || is_tie) && pos < k, pos);
    c_def += __popc(b_def);
    c_tie += __popc(b_tie);
  }
}

// A table of node-stacked leaves packed by one launch. Leaf l is a
// (rows, n) row-major operand (x, and v when HAS_V) cut into nb blocks a
// row; its blocks are the launch's warps begin .. begin + rows·nb − 1,
// and its payload, (rows, nb, k) values and indices, starts at element
// `out` of the output arrays. Passed by value as a kernel parameter
// (__grid_constant__: read in place from the parameter bank, never
// copied).
struct PackLeaf {
  const float* x;
  const void* v;                          // float, bfloat16 or half
  long long n, nb, begin, out;
};

struct PackTable {
  PackLeaf leaf[kMaxLeaves];
  long long total;                                // Σ rows·nb
  int count;
};

// the NaN the port writes: torch's float('nan')
__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

// Warp w packs block w of the table: leaf l with begin_l <= w <
// begin_{l+1}, row (w − begin_l) / nb, block (w − begin_l) % nb. Padding
// zeros picked as ties put their block-local indices in the payload, as
// the reference's do.
//
// Values follow the reference's one-hot contraction (pack.py:78), which
// computes slot s as 0 + Σ_b x[b]·[slot(b) == s]: a -0.0 survivor comes
// out +0.0, and since 0·inf and 0·NaN are NaN, every slot of a block with
// a non-finite element is NaN except the slot of a lone ±inf, which keeps
// it (ROADMAP C6). A block holding a NaN may keep fewer than k elements;
// its empty slots are NaN at index 0, the contraction's zero index.
template <bool HAS_V, typename VT>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
pack_kernel(const __grid_constant__ PackTable table, float* __restrict__ vals,
            uint16_t* __restrict__ idx, int k) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (warp >= table.total) return;                // uniform within a warp
  int l = 0;
  while (l + 1 < table.count && warp >= table.leaf[l + 1].begin) ++l;
  const PackLeaf& leaf = table.leaf[l];
  const long long local = warp - leaf.begin;
  const long long row = local / leaf.nb;
  const long long start = (local - row * leaf.nb) * kBlock;

  float d[kPerLane];
  load_block<HAS_V, VT>(
      leaf.x + row * leaf.n,
      HAS_V ? static_cast<const VT*>(leaf.v) + row * leaf.n : nullptr, start,
      leaf.n, lane, d);
  const float m = block_max(d);
  float lo, hi;
  bisect_block(d, m, k, lo, hi);

  float* vrow = vals + leaf.out + local * k;
  uint16_t* irow = idx + leaf.out + local * k;
  int bad = 0;                                    // non-finite elements
  if (!is_finite(m)) {                             // uniform within a warp
    unsigned cnt = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) cnt += !is_finite(d[j]);
    bad = (int)__reduce_add_sync(kFull, cnt);
    for (int s = lane; s < k; s += 32) {
      vrow[s] = quiet_nan();
      irow[s] = 0;
    }
    __syncwarp();
  }
  rank_block(d, lo, hi, k, lane, [&](int j, bool keep, int pos) {
    if (keep) {
      vrow[pos] = bad > (int)!is_finite(d[j]) ? quiet_nan()
                                             : __fadd_rn(d[j], 0.0f);
      irow[pos] = (uint16_t)(j * 32 + lane);
    }
  });
}

// Fill a table from the host arrays of `count` <= kMaxLeaves leaves and
// launch once; leaf l's payload goes to vals and idx from element outs[l];
// v's elements are VT.
template <bool HAS_V, typename VT = float>
inline int launch_pack(const float* const* xs, const void* const* vs,
                       const long long* ns, const long long* nbs,
                       const long long* outs, int count, long long rows,
                       float* vals, uint16_t* idx, int k, void* stream) {
  if (count < 1 || count > kMaxLeaves || rows < 0)
    return (int)cudaErrorInvalidValue;
  PackTable table{};
  long long total = 0;
  for (int l = 0; l < count; ++l) {
    table.leaf[l] = PackLeaf{xs[l], HAS_V ? vs[l] : nullptr, ns[l], nbs[l],
                             total, outs[l]};
    total += rows * nbs[l];
  }
  table.total = total;
  table.count = count;
  if (total > 0) {
    const long long ctas = (total + kWarpsPerCta - 1) / kWarpsPerCta;
    pack_kernel<HAS_V, VT><<<(unsigned)ctas, kWarpsPerCta * 32, 0,
                         (cudaStream_t)stream>>>(table, vals, idx, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// ---------------------------------------------------------------------------
// The top_k-order selection of pack.cu's topk_select_kernel: what the
// reference's jnp BlockTopKCodec.encode computes for a block
// (src/repro/core/compression.py:426-435, lax.top_k of |d|), and its
// TopKCodec.encode for a leaf of at most one block (:374-383). lax.top_k as
// XLA runs it on the CPU (ROADMAP C9) orders |d| by its bit pattern: NaN
// above ±inf above finite, NaNs by payload, equal keys to the lower index;
// slots go in that order, and values are kept as they are (-0.0 and NaN
// payloads included). For k <= 32 a block's survivors come from the
// candidates its lanes' maxima admit (topk_from_candidates); the k-th-key
// search below is the path of a block with more than 32 of them, and of
// k > 32.
namespace repro_torch {

// the order key of an element: the bits of |d|
__device__ __forceinline__ unsigned mag_key(float a) {
  return __float_as_uint(a) & 0x7fffffffu;
}

// The k-th largest key of the block, counted with multiplicity: the
// MSB-first search of kth_magnitude on the keys' bits, so NaN keys take
// part (there a NaN magnitude counts nothing). Bit 31 of a key is 0.
__device__ __forceinline__ unsigned kth_key(const float (&d)[kPerLane],
                                            int k) {
  unsigned bits = 0u;
#pragma unroll 1
  for (int b = 30; b >= 0; --b) {
    const unsigned cand = bits | (1u << b);
    unsigned cnt = 0u;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) cnt += mag_key(d[j]) >= cand ? 1u : 0u;
    const int count = (int)__reduce_add_sync(kFull, cnt);
    if (count < k) continue;
    bits = cand;
    if (count == k) {                  // the k largest: v_k is their least
      unsigned least = 0xffffffffu;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const unsigned key = mag_key(d[j]);
        if (key >= cand) least = min(least, key);
      }
      return __reduce_min_sync(kFull, least);
    }
  }
  return bits;
}

// The lane-maxima bound of a block, k <= 32: L, the k-th largest of the 32
// lanes' largest |d| (as fmaxf takes them, so a NaN counts as nothing and
// L is never NaN). Each of the k lanes whose maximum is >= L holds an
// element whose key is >= L's bits, so the block's k-th largest key v_k is
// >= L, and every survivor, each tie at v_k included, is a candidate: an
// element with !(|d| < L), as every NaN key is. The maxima are sorted
// across the warp, descending, by a bitonic network (15 steps of one
// shuffle and one min or max).
__device__ __forceinline__ float lane_max_bound(const float (&d)[kPerLane],
                                                int k, int lane) {
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) m = fmaxf(m, fabsf(d[j]));
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float other = __shfl_xor_sync(kFull, m, stride);
      // the lower lane of a descending run keeps the larger
      const bool larger = ((lane & stride) == 0) == ((lane & size) == 0);
      m = larger ? fmaxf(m, other) : fminf(m, other);
    }
  }
  return __shfl_sync(kFull, m, k - 1);
}

// The fast path of k <= 32: the candidates of lane_max_bound (about 13 of
// 1,024 on continuous data at k = 11) gathered in element order into
// lanes 0..count-1 through `scratch` (one ballot a row, rows without a
// candidate skipped), then each finds its slot among them with `count`
// shuffles: larger keys first, equal keys by element order, which is lane
// order. False, with nothing emitted, when more than 32 are candidates
// (ties at the top, blocks of zeros, k near 32): the caller then takes the
// k-th-key search. The decision is uniform within the warp.
template <class Emit>
__device__ __forceinline__ bool topk_from_candidates(
    const float (&d)[kPerLane], int k, int lane, unsigned* scratch,
    Emit emit) {
  const float bound = lane_max_bound(d, k, lane);
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const bool cand = !(fabsf(d[j]) < bound);
    const unsigned b = __ballot_sync(kFull, cand);
    if (b != 0u) {                                // uniform within a warp
      const int p = count + __popc(b & below);
      if (cand && p < 32) {
        scratch[p] = __float_as_uint(d[j]);
        scratch[32 + p] = (unsigned)(j * 32 + lane);
      }
      count += __popc(b);
    }
  }
  if (count > 32) return false;
  __syncwarp();
  const unsigned bits = lane < count ? scratch[lane] : 0u;
  const unsigned key = bits & 0x7fffffffu;
  int slot = 0;
  for (int t = 0; t < count; ++t) {
    const unsigned other = __shfl_sync(kFull, key, t);
    slot += (other > key || (other == key && t < lane)) ? 1 : 0;
  }
  if (lane < count && slot < k)
    emit(slot, __uint_as_float(bits), (int)scratch[32 + lane]);
  return true;
}

// The k survivors of a block in top_k order. A survivor is every element
// whose key exceeds v_k, then the first k − count(key > v_k) elements whose
// key is v_k, in element order (so zero padding past a leaf's end is never
// kept while k valid elements exist). A survivor's slot is the count of
// survivors ranked before it: every element with a larger key (all of them
// survive) and every element with its key at a lower index. Calls
// emit(slot, value, element) once per survivor, from some lane.
//
// k <= 32: topk_from_candidates, or where it declines, v_k by kth_key, the
// survivors gathered in element order into lanes 0..k-1 through `scratch`
// and each lane's slot found with k shuffles. k > 32: the block's keys go
// to `scratch` and each survivor counts over all 1,024 of them.
// `scratch`: the warp's kFewWords words of shared memory for k <= 32,
// kBlock for k > 32.
constexpr int kFewWords = 96;

template <class Emit>
__device__ __forceinline__ void topk_order_block(const float (&d)[kPerLane],
                                                 int k, int lane,
                                                 unsigned* scratch,
                                                 Emit emit) {
  if (k <= 32 && topk_from_candidates(d, k, lane, scratch, emit)) return;
  __syncwarp();                       // scratch may hold declined candidates
  const unsigned vk = kth_key(d, k);
  int n_gt = 0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    n_gt += __popc(__ballot_sync(kFull, mag_key(d[j]) > vk));
  const int ties = k - n_gt;             // elements at v_k that survive
  const unsigned below = (1u << lane) - 1u;
  int c_eq = 0;
  if (k <= 32) {
    int c_keep = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const unsigned key = mag_key(d[j]);
      const unsigned b_eq = __ballot_sync(kFull, key == vk);
      const bool keep = key > vk ||
                        (key == vk && c_eq + __popc(b_eq & below) < ties);
      const unsigned b_keep = __ballot_sync(kFull, keep);
      if (keep) {
        const int p = c_keep + __popc(b_keep & below);
        scratch[p] = key;
        scratch[32 + p] = (unsigned)(j * 32 + lane);
        scratch[64 + p] = __float_as_uint(d[j]);
      }
      c_eq += __popc(b_eq);
      c_keep += __popc(b_keep);
    }
    __syncwarp();
    const unsigned key = lane < k ? scratch[lane] : 0u;
    int slot = 0;
    for (int t = 0; t < k; ++t) {
      const unsigned other = __shfl_sync(kFull, key, t);
      slot += (other > key || (other == key && t < lane)) ? 1 : 0;
    }
    if (lane < k)
      emit(slot, __uint_as_float(scratch[64 + lane]), (int)scratch[32 + lane]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) scratch[j * 32 + lane] = mag_key(d[j]);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const unsigned key = mag_key(d[j]);
    const unsigned b_eq = __ballot_sync(kFull, key == vk);
    const bool keep = key > vk ||
                      (key == vk && c_eq + __popc(b_eq & below) < ties);
    c_eq += __popc(b_eq);
    if (__any_sync(kFull, keep)) {
      const int e = j * 32 + lane;
      int slot = 0;
#pragma unroll 4
      for (int i = 0; i < kBlock; ++i) {
        const unsigned other = scratch[i];
        slot += (other > key || (other == key && i < e)) ? 1 : 0;
      }
      if (keep) emit(slot, d[j], e);
    }
  }
}

}  // namespace repro_torch
