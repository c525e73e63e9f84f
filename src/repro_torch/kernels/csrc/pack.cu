// Block-top-k wire format for Hopper (sm_90a): pack and unpack.
//
// Replaces the Pallas kernels of src/repro/kernels/pack.py:
//   repro_pack_topk   <- pack_topk_pallas   (pl.pallas_call at pack.py:104,
//                        body _pack_tile at pack.py:39-80)
//   repro_unpack_topk <- unpack_topk_pallas (pl.pallas_call at pack.py:122)
// and the two kernels of the top_k-order wire format, which the reference
// computes in jnp (no pl.pallas_call): the default, unfused
// BlockTopKCodec's encode and decode (src/repro/core/compression.py:413-448)
//   repro_topk_select <- lax.top_k of each block's |d| and take_along_axis
//                        (:426-435; a leaf of at most one block, TopKCodec's
//                        global top-k, :374-383)
//   repro_unpack_set  <- the .at[].set scatter of its decode (:445-448, :355-357)
//
// What bounds them on an H100:
//   pack   — the function's own bound is the read of the block: per
//            element, 4 bytes at 3.35 TB/s (1.2 ps) against 44 f32
//            operations (|x|, the max, 40 compares, 2 masks) at 67 TFLOP/s
//            (0.66 ps). This design is bound by instruction issue: the
//            k-th-magnitude search of pack_tile.cuh is up to 31 passes of 32
//            compares and adds a lane (~70 warp instructions a pass), and
//            the rank adds ~160 popcounts a lane, at 16 a clock per SM.
//   unpack — bytes: the dense (rows, n) f32 output is written once at
//            3.35 TB/s; the (rows, nb, k) input is wire-sized.
//   topk_select — the function's bound is the read of the block (4 bytes an
//            element, 8 with v): 0.0626 ms for the round's 10 leaves at
//            K = 10. The first design (up to 31 passes of a k-th-key search
//            a block) was bound by instruction issue at 39% of it.
//   unpack_set — bytes, as unpack.
// What the design does about that:
//   pack   — one warp per block, the block held in registers (32 values a
//            lane), so the search never touches memory; it counts per lane
//            and sums the warp with one __reduce_add_sync a pass (no ballots,
//            no popcounts), and the bisection's 40 steps are replayed from
//            the k-th magnitude in scalar registers. One launch covers every
//            leaf of a table (up to kMaxLeaves): the small leaves' few blocks
//            run beside fc1.w's, not as launches of 1-24 CTAs of their own.
//   unpack — one warp per block, 8 blocks a CTA, one launch over a table of
//            leaves: the C6 rule's count of non-finite values is a ballot
//            and a popcount (no CTA barrier), the fill is 8 float4 stores a
//            lane (512 contiguous bytes a warp a store), then __syncwarp()
//            orders the warp's writes and the k survivors are scattered.
//            Pack never repeats an index, but a payload rebuilt from frames
//            may (ROADMAP C7): the repeats are found without a load (one
//            __match_any_sync on the slots held in registers, or a 1024-bit
//            shared-memory set for k > 32), and only a block that holds one
//            takes the slower path in which one slot sums each index's
//            values in slot order.
//   topk_select — one warp a block, 32 values a lane in registers, d = x − v
//            formed there, one launch over the leaf table. For k <= 32 the
//            lanes' largest |d| bound the block's k-th key from below
//            (pack_tile.cuh, topk_from_candidates): about 13 candidates on
//            continuous data at k = 11, gathered with a ballot a row and
//            ranked with a shuffle a candidate, a few hundred warp
//            instructions a block by count in place of 1,000-3,000. A block
//            with more than 32 (ties at the top, zeros, k near 32) takes the
//            k-th-key search in the same launch. Shared memory is sized by
//            the launch (96 words a warp, 1,024 only when some k > 32), and
//            128 registers a thread keep a warp's 64 loads in flight: on the
//            card 2 CTAs an SM beat 3 (80 registers), and one warp a block
//            beat persistent warps that prefetched blocks with
//            cp.async.bulk (PERF.md §6).
#include "pack_tile.cuh"

namespace repro_torch {

// A table of node-stacked payloads unpacked by one launch. Leaf l's
// (rows, nb, k) values and indices are vals and idx (one pointer each a
// leaf: the values may come from QSGD's decode, one tensor a leaf), its
// dense (rows, n) output is out, and its blocks are the launch's warps
// begin .. begin + rows·nb − 1. vec: out's rows start 16-byte aligned
// (n % 4 == 0 and an aligned out), so the fill is float4 stores; uniform
// per leaf, so it never diverges within a warp.
struct UnpackLeaf {
  const float* vals;
  const uint16_t* idx;
  float* out;
  long long n, nb, begin;
  int vec;
};

struct UnpackTable {
  UnpackLeaf leaf[kMaxLeaves];
  long long total;                                // Σ rows·nb
  int count;
};

// Warp w unpacks block w of the table into its leaf's (rows, n) output;
// positions at or past n (the ragged last block's zero padding) are
// dropped, as the reference's [:n].
//
// Values follow the reference's one-hot contraction (pack.py:95-96),
// out[b] = 0 + Σ_s vals[s]·[idx[s] == b]: a -0.0 value decodes to +0.0, and
// since 0·inf and 0·NaN are NaN, a block whose values hold a non-finite
// decodes to NaN everywhere but at an index that holds all of the block's
// non-finite values, which keeps its sum (ROADMAP C6). Values that share an
// index add up, from +0.0 in slot order (ROADMAP C7).
__global__ void __launch_bounds__(kWarpsPerCta * 32)
unpack_kernel(const __grid_constant__ UnpackTable table, int k) {
  __shared__ unsigned seen[kWarpsPerCta][kBlock / 32];   // k > 32: the set

  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (warp >= table.total) return;                // uniform within a warp
  int l = 0;
  while (l + 1 < table.count && warp >= table.leaf[l + 1].begin) ++l;
  const UnpackLeaf& leaf = table.leaf[l];
  const long long local = warp - leaf.begin;
  const long long row = local / leaf.nb;
  const long long start = (local - row * leaf.nb) * kBlock;
  const long long n = leaf.n;
  const float* vb = leaf.vals + local * k;
  const uint16_t* ib = leaf.idx + local * k;

  // the block's non-finite values: slots 0..31 stay in registers (a lane
  // past k holds an index no slot has)
  const float v0 = lane < k ? vb[lane] : 0.0f;
  const int i0 = lane < k ? ib[lane] : -1 - lane;
  const unsigned bad0 = __ballot_sync(kFull, !is_finite(v0));
  int bad = __popc(bad0);
  for (int s0 = 32; s0 < k; s0 += 32) {           // k > 32: the rest
    const bool nf = s0 + lane < k && !is_finite(vb[s0 + lane]);
    bad += __popc(__ballot_sync(kFull, nf));
  }
  const float fill = bad ? quiet_nan() : 0.0f;

  // repeated indices: the lanes whose slot shares lane's index (k <= 32),
  // or a set of the block's indices in shared memory (k > 32)
  unsigned group = 1u << lane;
  bool repeats;
  if (k <= 32) {
    group = __match_any_sync(kFull, i0);
    repeats = __any_sync(kFull, group != 1u << lane);
  } else {
    unsigned* set = seen[threadIdx.x >> 5];
    set[lane] = 0u;
    __syncwarp();
    bool dup = false;
    for (int s = lane; s < k; s += 32) {
      const int i = s == lane ? i0 : ib[s];
      const unsigned bit = 1u << (i & 31);
      dup |= (atomicOr(set + ((i >> 5) & 31), bit) & bit) != 0u;
    }
    repeats = __any_sync(kFull, dup);
  }

  float* ob = leaf.out + row * n + start;
  if (leaf.vec) {
    const float4 f4 = make_float4(fill, fill, fill, fill);
#pragma unroll
    for (int j = 0; j < kBlock / 128; ++j) {
      const int e = 4 * lane + 128 * j;
      if (start + e < n) *reinterpret_cast<float4*>(ob + e) = f4;
    }
  } else {
    for (int e = lane; e < kBlock; e += 32)
      if (start + e < n) ob[e] = fill;
  }
  __syncwarp();                       // the fill lands before the survivors

  // an index's sum is stored when the index holds all of its block's
  // non-finite values (`nonfinite` of them), none in a finite block; a NaN
  // sum is stored as the fill's NaN
  const auto put = [&](float sum, int i, int nonfinite) {
    if (start + i < n && nonfinite == bad)
      ob[i] = sum == sum ? sum : quiet_nan();
  };
  if (!repeats) {                     // every payload that pack produces
    if (lane < k) put(__fadd_rn(0.0f, v0), i0, !is_finite(v0));
    for (int s = 32 + lane; s < k; s += 32) {
      const float v = vb[s];
      put(__fadd_rn(0.0f, v), ib[s], !is_finite(v));
    }
  } else if (k <= 32) {
    // the group's lowest slot sums it in slot order
    if (lane < k && (group & ((1u << lane) - 1u)) == 0u) {
      float sum = 0.0f;
      for (unsigned g = group; g; g &= g - 1u)
        sum = __fadd_rn(sum, vb[__ffs(g) - 1]);
      put(sum, i0, __popc(group & bad0));
    }
  } else {
    // slot s stores when no earlier slot has its index: the sum of the
    // index's values from slot s on, in slot order (L1-resident loads)
    for (int s = lane; s < k; s += 32) {
      const int i = ib[s];
      bool first = true;
      for (int t = 0; t < s && first; ++t) first = ib[t] != i;
      if (!first) continue;
      float sum = 0.0f;
      int nonfinite = 0;
      for (int t = s; t < k; ++t) {
        if (ib[t] != i) continue;
        const float v = vb[t];
        sum = __fadd_rn(sum, v);
        nonfinite += !is_finite(v);
      }
      put(sum, i, nonfinite);
    }
  }
}

// A table of node-stacked leaves selected in top_k order by one launch:
// PackLeaf's fields and the leaf's own k (a leaf of at most one block keeps
// ceil(ratio·n) of its n, a longer leaf ceil(ratio·block) a block).
struct TopkLeaf {
  const float* x;
  const void* v;                                  // float or bfloat16
  long long n, nb, begin, out;
  int k;
};

struct TopkTable {
  TopkLeaf leaf[kMaxLeaves];
  long long total;                                // Σ rows·nb
  int count;
  int words;              // scratch words a warp: kFewWords, or kBlock if
                          // some k > 32
};

// Warp w selects block w of the table (as pack_kernel walks it) in top_k
// order: its (k) values as they are and their block-local indices, d = x − v
// formed in registers when HAS_V. Zero padding past the leaf's end may be
// picked as a tie in a ragged last block, as the reference's jnp.pad zeros
// are; in a leaf of at most one block it never is. Dynamic shared memory:
// table.words a warp. 2 CTAs an SM allow 128 registers a thread, enough for
// a warp's 64 loads in flight (3 allow 80 and spill, and ran 3.8% slower:
// PERF.md §6).
template <bool HAS_V, typename VT>
__global__ void __launch_bounds__(kWarpsPerCta * 32, 2)
topk_select_kernel(const __grid_constant__ TopkTable table,
                   float* __restrict__ vals, uint16_t* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned smem[];
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (warp >= table.total) return;                // uniform within a warp
  int l = 0;
  while (l + 1 < table.count && warp >= table.leaf[l + 1].begin) ++l;
  const TopkLeaf& leaf = table.leaf[l];
  const long long local = warp - leaf.begin;
  const long long row = local / leaf.nb;
  const long long start = (local - row * leaf.nb) * kBlock;
  float d[kPerLane];
  load_block<HAS_V, VT>(
      leaf.x + row * leaf.n,
      HAS_V ? static_cast<const VT*>(leaf.v) + row * leaf.n : nullptr, start,
      leaf.n, lane, d);
  float* vrow = vals + leaf.out + local * leaf.k;
  uint16_t* irow = idx + leaf.out + local * leaf.k;
  topk_order_block(d, leaf.k, lane, smem + (threadIdx.x >> 5) * table.words,
                   [&](int slot, float value, int e) {
                     vrow[slot] = value;
                     irow[slot] = (uint16_t)e;
                   });
}

// A table of top_k-order payloads decoded by one launch: UnpackLeaf's
// fields and the leaf's own k.
struct SetLeaf {
  const float* vals;
  const uint16_t* idx;
  float* out;
  long long n, nb, begin;
  int k, vec;
};

struct SetTable {
  SetLeaf leaf[kMaxLeaves];
  long long total;                                // Σ rows·nb
  int count;
};

// Warp w decodes block w of the table: zeros, then each value stored as it
// is at its index (the reference's .at[].set: -0.0 and NaN payloads kept,
// no contraction). Top_k never repeats an index; a payload that does is a
// caller error, and which of its values lands is not defined.
__global__ void __launch_bounds__(kWarpsPerCta * 32)
unpack_set_kernel(const __grid_constant__ SetTable table) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (warp >= table.total) return;                // uniform within a warp
  int l = 0;
  while (l + 1 < table.count && warp >= table.leaf[l + 1].begin) ++l;
  const SetLeaf& leaf = table.leaf[l];
  const long long local = warp - leaf.begin;
  const long long row = local / leaf.nb;
  const long long start = (local - row * leaf.nb) * kBlock;
  const long long n = leaf.n;
  const float* vb = leaf.vals + local * leaf.k;
  const uint16_t* ib = leaf.idx + local * leaf.k;
  float* ob = leaf.out + row * n + start;
  if (leaf.vec) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < kBlock / 128; ++j) {
      const int e = 4 * lane + 128 * j;
      if (start + e < n) *reinterpret_cast<float4*>(ob + e) = z;
    }
  } else {
    for (int e = lane; e < kBlock; e += 32)
      if (start + e < n) ob[e] = 0.0f;
  }
  __syncwarp();                       // the zeros land before the values
  for (int s = lane; s < leaf.k; s += 32) {
    const int i = ib[s];
    if (start + i < n) ob[i] = vb[s];
  }
}

}  // namespace repro_torch

// One launch packs `count` <= kMaxLeaves leaves of `rows` rows each: leaf l
// is xs[l], (rows, ns[l]) with nbs[l] blocks a row, and its payload starts
// at element outs[l] of vals and idx.
extern "C" int repro_pack_topk(const float* const* xs, const long long* ns,
                               const long long* nbs, const long long* outs,
                               int count, long long rows, float* vals,
                               uint16_t* idx, int k, void* stream) {
  return repro_torch::launch_pack<false>(xs, nullptr, ns, nbs, outs, count,
                                         rows, vals, idx, k, stream);
}

// One launch unpacks `count` <= kMaxLeaves payloads of `rows` rows each:
// leaf l's values and indices are vals[l] and idx[l], (rows, nbs[l], k),
// and its dense (rows, ns[l]) output is outs[l].
extern "C" int repro_unpack_topk(const float* const* vals,
                                 const uint16_t* const* idx,
                                 float* const* outs, const long long* ns,
                                 const long long* nbs, int count,
                                 long long rows, int k, void* stream) {
  using namespace repro_torch;
  if (count < 1 || count > kMaxLeaves || rows < 0 || k < 1 || k > kBlock)
    return (int)cudaErrorInvalidValue;
  UnpackTable table{};
  long long total = 0;
  for (int l = 0; l < count; ++l) {
    const bool vec = ns[l] % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(outs[l]) % 16 == 0;
    table.leaf[l] = UnpackLeaf{vals[l], idx[l], outs[l], ns[l], nbs[l],
                               total, vec};
    total += rows * nbs[l];
  }
  table.total = total;
  table.count = count;
  if (total > 0) {
    const long long ctas = (total + kWarpsPerCta - 1) / kWarpsPerCta;
    unpack_kernel<<<(unsigned)ctas, kWarpsPerCta * 32, 0,
                    (cudaStream_t)stream>>>(table, k);
  }
  return (int)cudaGetLastError();
}

namespace repro_torch {

// Fill a top_k table from the host arrays and launch once; v's elements
// are VT.
template <typename VT>
inline int launch_topk_select(const float* const* xs, const void* const* vs,
                              const long long* ns, const long long* nbs,
                              const int* ks, const long long* outs, int count,
                              long long rows, float* vals, uint16_t* idx,
                              void* stream) {
  if (count < 1 || count > kMaxLeaves || rows < 0)
    return (int)cudaErrorInvalidValue;
  TopkTable table{};
  long long total = 0;
  int kmax = 1;
  for (int l = 0; l < count; ++l) {
    if (ks[l] < 1 || ks[l] > kBlock) return (int)cudaErrorInvalidValue;
    table.leaf[l] = TopkLeaf{xs[l], vs ? vs[l] : nullptr, ns[l], nbs[l],
                             total, outs[l], ks[l]};
    total += rows * nbs[l];
    kmax = ks[l] > kmax ? ks[l] : kmax;
  }
  table.total = total;
  table.count = count;
  table.words = kmax > 32 ? kBlock : kFewWords;
  if (total > 0) {
    const unsigned ctas =
        (unsigned)((total + kWarpsPerCta - 1) / kWarpsPerCta);
    const size_t bytes = 4 * (size_t)kWarpsPerCta * table.words;
    if (vs)
      topk_select_kernel<true, VT><<<ctas, kWarpsPerCta * 32, bytes,
                                     (cudaStream_t)stream>>>(table, vals,
                                                             idx);
    else
      topk_select_kernel<false, VT><<<ctas, kWarpsPerCta * 32, bytes,
                                      (cudaStream_t)stream>>>(table, vals,
                                                              idx);
  }
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// One launch selects `count` <= kMaxLeaves leaves of `rows` rows each in
// top_k order: leaf l is xs[l] (minus vs[l] when vs is not null), (rows,
// ns[l]) with nbs[l] blocks a row of ks[l] survivors, and its payload starts
// at element outs[l] of vals and idx. Shared memory a warp: kFewWords, or
// kBlock words when some k exceeds 32.
extern "C" int repro_topk_select(const float* const* xs,
                                 const float* const* vs, const long long* ns,
                                 const long long* nbs, const int* ks,
                                 const long long* outs, int count,
                                 long long rows, float* vals, uint16_t* idx,
                                 void* stream) {
  return repro_torch::launch_topk_select<float>(
      xs, reinterpret_cast<const void* const*>(vs), ns, nbs, ks, outs, count,
      rows, vals, idx, stream);
}

// The same with v stored in bfloat16 (FedConfig.control_dtype; vs not
// null): each element of v widened to f32 in registers before x − v.
extern "C" int repro_topk_select_bf16(const float* const* xs,
                                      const __nv_bfloat16* const* vs,
                                      const long long* ns,
                                      const long long* nbs, const int* ks,
                                      const long long* outs, int count,
                                      long long rows, float* vals,
                                      uint16_t* idx, void* stream) {
  if (!vs) return (int)cudaErrorInvalidValue;
  return repro_torch::launch_topk_select<__nv_bfloat16>(
      xs, reinterpret_cast<const void* const*>(vs), ns, nbs, ks, outs, count,
      rows, vals, idx, stream);
}

// One launch decodes `count` <= kMaxLeaves top_k-order payloads of `rows`
// rows each: leaf l's values and indices are vals[l] and idx[l], (rows,
// nbs[l], ks[l]), and its dense (rows, ns[l]) output is outs[l].
extern "C" int repro_unpack_set(const float* const* vals,
                                const uint16_t* const* idx,
                                float* const* outs, const long long* ns,
                                const long long* nbs, const int* ks,
                                int count, long long rows, void* stream) {
  using namespace repro_torch;
  if (count < 1 || count > kMaxLeaves || rows < 0)
    return (int)cudaErrorInvalidValue;
  SetTable table{};
  long long total = 0;
  for (int l = 0; l < count; ++l) {
    if (ks[l] < 1 || ks[l] > kBlock) return (int)cudaErrorInvalidValue;
    const int vec = ns[l] % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(outs[l]) % 16 == 0;
    table.leaf[l] = SetLeaf{vals[l], idx[l], outs[l], ns[l], nbs[l], total,
                            ks[l], vec};
    total += rows * nbs[l];
  }
  table.total = total;
  table.count = count;
  if (total > 0) {
    const long long ctas = (total + kWarpsPerCta - 1) / kWarpsPerCta;
    unpack_set_kernel<<<(unsigned)ctas, kWarpsPerCta * 32, 0,
                        (cudaStream_t)stream>>>(table);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
