// Block-top-k selection of one 1024-element block per warp, shared by
// pack.cu (pack_topk, HAS_V = false), fused_compress.cu (delta_pack,
// HAS_V = true) and block_topk.cu (the dense masked output). It is the CUDA
// form of the reference's tile body (src/repro/kernels/pack.py:39-80,
// _pack_tile): the same 40-step f32 threshold bisection and the same
// two-tier rank (definite survivors first, then ties at the threshold in
// index order), so pack and delta-pack select and order survivors exactly
// as the reference does. block_topk_pallas (src/repro/kernels/
// block_topk.py:28-51) runs the same bisection and tie rule, so the dense
// kernel keeps exactly the elements that pack packs.
//
// Layout: lane l of a warp holds elements j*32 + l (j = 0..31) of its block
// in registers, so every load is one coalesced 128-byte row and element
// order is (j, lane). A count over the block is 32 ballots + popcounts; the
// rank of an element is a prefix popcount of its ballot row plus a running
// total that every lane holds.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kBlock = 1024;            // elements per top-k block
constexpr int kPerLane = kBlock / 32;   // values a lane keeps in registers
constexpr int kBisectIters = 40;        // pack.py: BISECT_ITERS
constexpr int kWarpsPerCta = 8;
constexpr unsigned kFull = 0xffffffffu;

// The steps of one warp's block, shared by the packed kernel below and the
// dense kernel of block_topk.cu. Lane l of the warp holds elements
// j*32 + l of the block in d[j].

// Load the block that starts at element `start` of a row (d = x − v when
// HAS_V: the residual is formed here and lives only in registers, which is
// fused_compress.py's point). Elements at or past n read as 0, as the
// reference's zero padding of the ragged last block: such zeros can be
// picked as ties. Returns the block's largest magnitude.
template <bool HAS_V>
__device__ __forceinline__ float load_block(const float* __restrict__ xr,
                                            const float* __restrict__ vr,
                                            long long start, long long n,
                                            int lane, float (&d)[kPerLane]) {
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const long long e = start + j * 32 + lane;
    float t = 0.0f;
    if (e < n) {
      t = xr[e];
      if (HAS_V) t = __fsub_rn(t, vr[e]);
    }
    d[j] = t;
    m = fmaxf(m, fabsf(t));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  return m;
}

// The 40-step f32 threshold bisection; on return count(|d| >= lo) >= k and
// count(|d| >= hi) < k.
__device__ __forceinline__ void bisect_block(const float (&d)[kPerLane],
                                             float m, int k, float& lo,
                                             float& hi) {
  lo = 0.0f;
  hi = __fadd_rn(m, 1.0f);
#pragma unroll 1
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      cnt += __popc(__ballot_sync(kFull, fabsf(d[j]) >= mid));
    if (cnt >= k) lo = mid; else hi = mid;
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

// x (and v) are (rows, n) row-major; vals and idx are (rows, nb, k). Warp w
// packs block w % nb of row w / nb. Padding zeros picked as ties put their
// block-local indices in the payload, as the reference's do.
template <bool HAS_V>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
pack_kernel(const float* __restrict__ x, const float* __restrict__ v,
            float* __restrict__ vals, uint16_t* __restrict__ idx,
            long long rows, long long n, long long nb, int k) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (warp >= rows * nb) return;                  // uniform within a warp
  const long long row = warp / nb;
  const long long start = (warp - row * nb) * kBlock;

  float d[kPerLane];
  const float m = load_block<HAS_V>(x + row * n, HAS_V ? v + row * n : nullptr,
                                    start, n, lane, d);
  float lo, hi;
  bisect_block(d, m, k, lo, hi);

  float* vrow = vals + warp * k;
  uint16_t* irow = idx + warp * k;
  // every slot is filled unless the block holds a NaN; zero them first so
  // the output is defined either way, as the reference's one-hot sum is
  for (int s = lane; s < k; s += 32) {
    vrow[s] = 0.0f;
    irow[s] = 0;
  }
  __syncwarp();
  rank_block(d, lo, hi, k, lane, [&](int j, bool keep, int pos) {
    if (keep) {
      vrow[pos] = d[j];
      irow[pos] = (uint16_t)(j * 32 + lane);
    }
  });
}

template <bool HAS_V>
inline int launch_pack(const float* x, const float* v, float* vals,
                       uint16_t* idx, long long rows, long long n,
                       long long nb, int k, void* stream) {
  const long long warps = rows * nb;
  if (warps > 0) {
    const long long ctas = (warps + kWarpsPerCta - 1) / kWarpsPerCta;
    pack_kernel<HAS_V><<<(unsigned)ctas, kWarpsPerCta * 32, 0,
                         (cudaStream_t)stream>>>(x, v, vals, idx, rows, n,
                                                 nb, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace repro_torch
