// Exact fused score + top-k for Hopper.
//
// Replaces the Pallas TPU kernel
//   openrec_tpu/ops/topk.py::_fused_topk_kernel   (K3, wrapper fused_score_topk)
// and computes what it computes: the exact top k of s = u.V^T + b per user,
// the dot products accumulated in fp32 (f32 or bf16 inputs), without ever
// writing the [B, I] scores. The result is ordered by the total order
// (score descending, item id ascending), which is what lax.top_k's merge of
// concat([best, tile]) gives: among equal scores the smaller id comes first.
// Items t >= I are masked by the kernel itself (nothing is padded in device
// memory), so no id >= I is ever returned, even when k == I.
//
// What bounds it on an H100 at the serving shape (B = 256 users, the
// 450,166 x 64 bf16 catalog, k = 100): ~57.6 MB of table read once, ~22 us
// at 3.35 TB/s; the 14.8 GFLOP of dot products are ~15 us on the bf16 tensor
// cores but ~0.22 ms on the CUDA cores in fp32, where this design runs
// them (as K1 does). So it is bound by FMA issue, tile staging and the
// running-list merges, not by bytes; tensor cores (wgmma) are a later step.
//
// Design. The TPU kernel walks the whole catalog in sequence for one user
// block. Here a block owns G users and one contiguous slice of the catalog,
// so that (#slices x #user groups) blocks fill the 132 SMs; a second launch
// merges each user's per-slice lists.
//   * G = 4 * warps users per block. Their vectors sit in shared memory as
//     fp32 [G][Dp] (Dp = D rounded up to 4, zero padded). Item tiles of 128
//     rows are staged as fp32 [128][Sv] (row stride Sv = Dp or Dp + 4, so
//     that Sv/4 is odd and the float4 row reads of 8 lanes hit distinct
//     banks). A tile is one contiguous run of V, loaded in 16-byte chunks
//     (element by element where V is not 16-byte aligned, or at the run's
//     ragged end). Staging is latency-bound if a thread waits on one load
//     at a time (a 128 x 64 bf16 tile is 32 element loads a thread), so
//     each thread keeps kChunks chunk loads in flight, and the next tile's
//     first chunks are in flight while this tile's dot products run.
//   * Warp w owns users 4w..4w+3 outright: each lane computes 4 users x 4
//     items (items lane + 32q) from float4 loads, then the warp filters
//     each user's 128 scores by that user's current k-th key and appends
//     the survivors (compacted with ballots) to the user's pending buffer.
//     Whenever 32 are pending, it sorts them with a shuffle bitonic sort
//     and merges them into the user's running top-Kb list in shared memory
//     (Kb = k rounded up to 32). The merge places each element by rank
//     (list entries move by the number of better candidates, moved from the
//     tail down; candidates land at index + rank), so it touches only the
//     part of the list from the first insertion on. No block-wide barrier
//     guards the merge: only the tile load is shared.
//   * The merges, not the dot products, set this kernel's time, so fewer
//     candidates reach them: a merge waits for 32 pending (a sort and a
//     list merge cost as much for one late survivor as for 32), a slice
//     ends with one flush of the rest, and a candidate must beat the k-th
//     entry, not the Kb-th.
//     The slices of one user also share a bound on its k-th score in
//     global memory: after each merge a block raises it to its list's k-th
//     score (an integer atomic max), and every block drops the scores below
//     it. Any slice's k-th score is at most the user's true k-th score, so
//     this drops no item of the result (ties at the bound are kept).
//   * Second pass (when the catalog was split): one warp per user starts
//     from slice 0's list and merges the other slices' sorted lists chunk
//     by chunk, stopping in each list at the first entry that does not beat
//     the running k-th key.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTile = 128;           // items per tile
constexpr int kPending = 64;         // pending candidates a user can hold
constexpr int kScratch = 8 * kPending + 64;  // per-warp words: 4 users'
                                             // pending (v, id), merge 2x32
constexpr int kMergeWarps = 4;       // users per block of the second pass
constexpr int kChunks = 4;           // 16-byte tile chunks a thread has in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoId = INT_MAX;       // id of an empty list entry (score -inf)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
struct RawBits;  // the element's bits as an unsigned integer
template <>
struct RawBits<float> {
  using type = unsigned;
};
template <>
struct RawBits<__nv_bfloat16> {
  using type = unsigned short;
};

// Element x of a 16-byte chunk of T, as fp32 (bf16 pairs: low half first).
template <typename T>
__device__ __forceinline__ float chunk_elem(const uint4& q, int x) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[x]);
  } else {
    const unsigned h = w[x >> 1];
    return __uint_as_float((x & 1) ? (h & 0xffff0000u) : (h << 16));
  }
}

// A tile's rows * D elements are one contiguous run src[0, n) of V, cut
// into 16-byte chunks of E = 16 / sizeof(T) elements. Load the chunks
// c0 + j * step (j < kChunks), every load issued before any is used: whole
// when VEC (the run starts on a 16-byte boundary) and the chunk lies inside
// the run, else element by element.
template <typename T, bool VEC>
__device__ __forceinline__ void load_chunks(const T* __restrict__ src, int n,
                                            int c0, int step,
                                            uint4 (&buf)[kChunks]) {
  constexpr int E = 16 / sizeof(T);
  using Raw = typename RawBits<T>::type;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int e = (c0 + j * step) * E;
    if (VEC && e + E <= n) {
      buf[j] = __ldg(reinterpret_cast<const uint4*>(src + e));
    } else {
      const Raw* raw = reinterpret_cast<const Raw*>(src);
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int x = 0; x < E; ++x) {
        const unsigned bits = e + x < n ? (unsigned)raw[e + x] : 0u;
        w[x * sizeof(T) / 4] |= bits << (8 * ((x * sizeof(T)) & 3));
      }
      buf[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Store loaded chunks into the fp32 tile [rows][Sv]: element e is (row
// e / D, column e % D). When E divides D a chunk lies in one row at a
// column that is a multiple of E, and goes out as float4 stores.
template <typename T>
__device__ __forceinline__ void store_chunks(float* vs, int Sv, int D, int n,
                                             int c0, int step,
                                             const uint4 (&buf)[kChunks]) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int e = (c0 + j * step) * E;
    if (e >= n) continue;
    int r = e / D, d = e - r * D;
    if (D % E == 0) {
      float4* dst = reinterpret_cast<float4*>(vs + r * Sv + d);
#pragma unroll
      for (int h = 0; h < E / 4; ++h)
        dst[h] = make_float4(chunk_elem<T>(buf[j], 4 * h),
                             chunk_elem<T>(buf[j], 4 * h + 1),
                             chunk_elem<T>(buf[j], 4 * h + 2),
                             chunk_elem<T>(buf[j], 4 * h + 3));
    } else {
#pragma unroll
      for (int x = 0; x < E; ++x) {
        if (e + x < n) vs[r * Sv + d] = chunk_elem<T>(buf[j], x);
        if (++d == D) {
          d = 0;
          ++r;
        }
      }
    }
  }
}

__device__ __forceinline__ int tile_rows(int I, int t) {
  return (int)min((long long)kTile, (long long)I - (long long)t * kTile);
}

// The first chunks of tile t of V and the bias of its items (lane's items
// lane + 32q), into registers.
template <typename T, bool VEC>
__device__ __forceinline__ void prefetch_tile(const T* __restrict__ v,
                                              const float* __restrict__ bias,
                                              int I, int D, int t, int lane,
                                              uint4 (&pre)[kChunks],
                                              float (&pre_b)[4]) {
  const long long t0 = (long long)t * kTile;
  const int rows = tile_rows(I, t);
  load_chunks<T, VEC>(v + t0 * D, rows * D, threadIdx.x, blockDim.x, pre);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = lane + 32 * q;
    pre_b[q] = (r < rows && bias != nullptr) ? bias[t0 + r] : 0.f;
  }
}

// *addr = max(*addr, x) for floats (no NaN), as an integer atomic: the
// bits of non-negative floats order as ints, those of negative floats in
// reverse as unsigned ints.
__device__ __forceinline__ void atomic_max_f32(float* addr, float x) {
  if (x >= 0.f) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(x));
  } else {
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(x));
  }
}

// The result's total order: score descending, then id ascending.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Sort one (score, id) per lane across the warp, best first (bitonic).
__device__ __forceinline__ void warp_sort(float& v, int& id, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, stride);
      const int oi = __shfl_xor_sync(kFull, id, stride);
      const bool up = (lane & size) == 0;      // this run ends best first
      const bool lower = (lane & stride) == 0;
      const bool take = (lower == up) ? better(ov, oi, v, id)
                                      : better(v, id, ov, oi);
      if (take) {
        v = ov;
        id = oi;
      }
    }
  }
}

// Merge 32 sorted candidates (lane j holds the j-th best; empty entries are
// (-inf, kNoId)) into the sorted list (bv, bi)[0, Kb) of one user, keeping
// the Kb best; nothing happens unless the best candidate beats entry k - 1.
// cs_v / cs_i: 32 words of warp scratch. Warp-synchronous.
__device__ void warp_merge(float* bv, int* bi, int Kb, int k, float cv,
                           int ci, float* cs_v, int* cs_i, int lane) {
  const float best_v = __shfl_sync(kFull, cv, 0);
  const int best_i = __shfl_sync(kFull, ci, 0);
  if (!better(best_v, best_i, bv[k - 1], bi[k - 1])) return;
  cs_v[lane] = cv;
  cs_i[lane] = ci;
  // rank of this candidate in the list: entries better than it
  int lo = 0, hi = Kb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(bv[mid], bi[mid], cv, ci)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int first = __shfl_sync(kFull, lo, 0);  // first entry that moves
  __syncwarp();
  // Entry e moves to e + (#candidates better than it). New indices are
  // never below old ones, so chunks are moved from the tail down, each
  // read whole before any lane writes.
  for (int base = ((Kb - 1) >> 5) << 5; base >= (first & ~31); base -= 32) {
    const int e = base + lane;
    float ev = 0.f;
    int ei = 0;
    int dst = Kb;
    if (e >= first && e < Kb) {
      ev = bv[e];
      ei = bi[e];
      int a = 0, b = 32;
      while (a < b) {
        const int m = (a + b) >> 1;
        if (better(cs_v[m], cs_i[m], ev, ei)) {
          a = m + 1;
        } else {
          b = m;
        }
      }
      dst = e + a;
    }
    __syncwarp();
    if (dst < Kb) {
      bv[dst] = ev;
      bi[dst] = ei;
    }
    __syncwarp();
  }
  const int pos = lane + lo;
  if (ci != kNoId && pos < Kb) {
    bv[pos] = cv;
    bi[pos] = ci;
  }
  __syncwarp();
}

// Sort the first min(n, 32) pending candidates (pv, pi) of one user and
// merge them into its list (bv, bi)[0, Kb); the pending entries [32, n)
// (n < 64) move down to [0, n - 32). Returns the count left pending.
// Warp-synchronous.
__device__ int flush_pending(float* pv, int* pi, int n, float* bv, int* bi,
                             int Kb, int k, float* cs_v, int* cs_i,
                             int lane) {
  __syncwarp();
  float cv = -CUDART_INF_F;
  int ci = kNoId;
  if (lane < n) {
    cv = pv[lane];
    ci = pi[lane];
  }
  const bool more = lane + 32 < n;
  float mv = 0.f;
  int mi = 0;
  if (more) {
    mv = pv[lane + 32];
    mi = pi[lane + 32];
  }
  __syncwarp();
  if (more) {
    pv[lane] = mv;
    pi[lane] = mi;
  }
  warp_sort(cv, ci, lane);
  warp_merge(bv, bi, Kb, k, cv, ci, cs_v, cs_i, lane);
  __syncwarp();  // the moved entries are seen before the next append
  return n > 32 ? n - 32 : 0;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(256, 2)
fused_topk_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const float* __restrict__ bias, int B, int I, int D, int Dp,
                  int Sv, int Kb, int k, int tiles_per_slice, int width,
                  float* __restrict__ dst_v, int* __restrict__ dst_i,
                  float* __restrict__ thr_g) {
  extern __shared__ float4 smem4[];
  const int G = blockDim.x >> 3;               // 4 users per warp
  float* us = reinterpret_cast<float*>(smem4);  // [G][Dp]
  float* vs = us + G * Dp;                      // [kTile][Sv]
  float* bv = vs + kTile * Sv;                  // [G][Kb]
  int* bi = reinterpret_cast<int*>(bv + G * Kb);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // per warp: the pending candidates of its 4 users, then the merge scratch
  float* pend_v = reinterpret_cast<float*>(bi + G * Kb) + warp * kScratch;
  int* pend_i = reinterpret_cast<int*>(pend_v + 4 * kPending);
  float* cs_v = pend_v + 8 * kPending;
  int* cs_i = reinterpret_cast<int*>(cs_v + 32);
  int pending[4] = {0, 0, 0, 0};  // pending count of each user (warp-uniform)

  const int user0 = blockIdx.y * G;
  const int n_tiles = (I + kTile - 1) / kTile;
  const int tile_begin = blockIdx.x * tiles_per_slice;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_slice);

  for (int e = threadIdx.x; e < G * Dp; e += blockDim.x) {
    const int r = e / Dp, d = e - r * Dp;
    const int b = user0 + r;
    us[e] = (b < B && d < D) ? to_f32(u[(long long)b * D + d]) : 0.f;
  }
  for (int e = threadIdx.x; e < kTile * Sv; e += blockDim.x) vs[e] = 0.f;
  for (int e = threadIdx.x; e < G * Kb; e += blockDim.x) {
    bv[e] = -CUDART_INF_F;
    bi[e] = kNoId;
  }

  // Thread tid stages the tile's 16-byte chunks tid + j * nthreads,
  // kChunks loads in flight; the first kChunks of the next tile (and its
  // bias) are loaded before this tile's dot products, so that their latency
  // hides behind them.
  constexpr int E = 16 / sizeof(T);
  const int step = blockDim.x;
  uint4 pre[kChunks];
  float pre_b[4];
  if (tile_begin < tile_end)
    prefetch_tile<T, VEC>(v, bias, I, D, tile_begin, lane, pre, pre_b);

  for (int t = tile_begin; t < tile_end; ++t) {
    const long long t0 = (long long)t * kTile;
    const int rows = tile_rows(I, t);
    const int n = rows * D;
    __syncthreads();  // the previous tile has been consumed
    store_chunks<T>(vs, Sv, D, n, threadIdx.x, step, pre);
    for (int c0 = threadIdx.x + kChunks * step; c0 * E < n;
         c0 += kChunks * step) {  // tiles of more than kChunks * 4 KB
      uint4 buf[kChunks];
      load_chunks<T, VEC>(v + t0 * D, n, c0, step, buf);
      store_chunks<T>(vs, Sv, D, n, c0, step, buf);
    }
    float bq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) bq[q] = pre_b[q];
    __syncthreads();
    if (t + 1 < tile_end)
      prefetch_tile<T, VEC>(v, bias, I, D, t + 1, lane, pre, pre_b);

    // lane i < 4: the shared k-th score bound of the warp's user i (read
    // now, used after the dot products)
    const int b_lane = user0 + warp * 4 + lane;
    const float g_lane = (lane < 4 && b_lane < B) ? __ldcg(thr_g + b_lane)
                                                 : -CUDART_INF_F;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    const float* ub = us + warp * 4 * Dp;
#pragma unroll 2
    for (int d = 0; d < Dp; d += 4) {
      float4 uu[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        uu[i] = *reinterpret_cast<const float4*>(&ub[i * Dp + d]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        vv[q] = *reinterpret_cast<const float4*>(&vs[(lane + 32 * q) * Sv + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][q] = fmaf(uu[i].x, vv[q].x, acc[i][q]);
          acc[i][q] = fmaf(uu[i].y, vv[q].y, acc[i][q]);
          acc[i][q] = fmaf(uu[i].z, vv[q].z, acc[i][q]);
          acc[i][q] = fmaf(uu[i].w, vv[q].w, acc[i][q]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = warp * 4 + i;
      if (user0 + g >= B) continue;  // warp-uniform
      float* ubv = bv + g * Kb;
      int* ubi = bi + g * Kb;
      float* pv = pend_v + i * kPending;
      int* pi = pend_i + i * kPending;
      int count = pending[i];
      float thr_v = ubv[k - 1];  // changes only when this user's list does
      int thr_i = ubi[k - 1];
      const float g_thr = __shfl_sync(kFull, g_lane, i);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = lane + 32 * q;
        const float s = acc[i][q] + bq[q];
        const int id = (int)(t0 + r);
        const bool keep =
            r < rows && s >= g_thr && better(s, id, thr_v, thr_i);
        const unsigned m = __ballot_sync(kFull, keep);
        if (m == 0) continue;  // the common case once the list has filled
        if (keep) {
          const int off = count + __popc(m & ((1u << lane) - 1u));
          pv[off] = s;
          pi[off] = id;
        }
        count += __popc(m);
        if (count >= 32) {
          count = flush_pending(pv, pi, count, ubv, ubi, Kb, k, cs_v, cs_i,
                                lane);
          thr_v = ubv[k - 1];
          thr_i = ubi[k - 1];
          if (lane == 0 && thr_v > -CUDART_INF_F)
            atomic_max_f32(thr_g + user0 + g, thr_v);
        }
      }
      pending[i] = count;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = warp * 4 + i;
    if (user0 + g >= B || pending[i] == 0) continue;  // warp-uniform
    flush_pending(pend_v + i * kPending, pend_i + i * kPending, pending[i],
                  bv + g * Kb, bi + g * Kb, Kb, k, cs_v, cs_i, lane);
  }

  // this slice's list of each of the warp's users: [slice][B][width]
  const long long plane = (long long)blockIdx.x * B * width;
  for (int i = 0; i < 4; ++i) {
    const int g = warp * 4 + i;
    const int b = user0 + g;
    if (b >= B) continue;
    for (int e = lane; e < width; e += 32) {
      dst_v[plane + (long long)b * width + e] = bv[g * Kb + e];
      dst_i[plane + (long long)b * width + e] = bi[g * Kb + e];
    }
  }
}

// Second pass: per user (one warp), merge the n_slices sorted lists of Kb
// entries into the final top k.
__global__ void __launch_bounds__(32 * kMergeWarps)
merge_slices_kernel(const float* __restrict__ pv, const int* __restrict__ pi,
                    int n_slices, int B, int Kb, int k,
                    float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kMergeWarps + warp;
  float* bv = reinterpret_cast<float*>(smem4) + warp * (2 * Kb + 64);
  int* bi = reinterpret_cast<int*>(bv + Kb);
  float* cs_v = reinterpret_cast<float*>(bi + Kb);
  int* cs_i = reinterpret_cast<int*>(cs_v + 32);
  if (b >= B) return;  // the whole warp; this kernel has no block barrier

  const long long plane = (long long)B * Kb;
  for (int e = lane; e < Kb; e += 32) {
    bv[e] = pv[(long long)b * Kb + e];
    bi[e] = pi[(long long)b * Kb + e];
  }
  __syncwarp();
  for (int z = 1; z < n_slices; ++z) {
    const float* lv = pv + z * plane + (long long)b * Kb;
    const int* li = pi + z * plane + (long long)b * Kb;
    for (int c0 = 0; c0 < Kb; c0 += 32) {  // Kb is a multiple of 32
      const float cv = lv[c0 + lane];
      const int ci = li[c0 + lane];
      // the list is sorted: stop at the first chunk whose head loses
      if (!better(__shfl_sync(kFull, cv, 0), __shfl_sync(kFull, ci, 0),
                  bv[k - 1], bi[k - 1]))
        break;
      warp_merge(bv, bi, Kb, k, cv, ci, cs_v, cs_i, lane);
    }
  }
  for (int e = lane; e < k; e += 32) {
    out_v[(long long)b * k + e] = bv[e];
    out_i[(long long)b * k + e] = bi[e];
  }
}

__global__ void fill_minus_inf_kernel(float* x, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = -CUDART_INF_F;
}

template <typename T>
cudaError_t launch(const void* u, const void* v, const float* bias, int B,
                   int I, int D, int k, int Kb, int G, int n_slices,
                   int tiles_per_slice, float* out_v, int* out_i,
                   float* part_v, int* part_i, float* thr,
                   cudaStream_t stream) {
  const int Dp = (D + 3) & ~3;
  const int Sv = ((Dp >> 2) & 1) ? Dp : Dp + 4;
  const size_t smem = sizeof(float) * ((size_t)G * Dp + (size_t)kTile * Sv +
                                       2 * (size_t)G * Kb +
                                       (size_t)(G / 4) * kScratch);
  // whole 16-byte chunk loads need V to start on a 16-byte boundary
  auto kernel = reinterpret_cast<uintptr_t>(v) % 16 == 0
                    ? fused_topk_kernel<T, true>
                    : fused_topk_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool split = n_slices > 1;
  fill_minus_inf_kernel<<<(B + 255) / 256, 256, 0, stream>>>(thr, B);
  const dim3 grid(n_slices, (B + G - 1) / G);
  kernel<<<grid, G * 8, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v), bias, B, I, D, Dp,
      Sv, Kb, k, tiles_per_slice, split ? Kb : k, split ? part_v : out_v,
      split ? part_i : out_i, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const size_t smem2 = sizeof(float) * kMergeWarps * (2 * (size_t)Kb + 64);
  err = cudaFuncSetAttribute(merge_slices_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  merge_slices_kernel<<<(B + kMergeWarps - 1) / kMergeWarps,
                        32 * kMergeWarps, smem2, stream>>>(
      part_v, part_i, n_slices, B, Kb, k, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. u [B, D] and v [I, D] share one dtype
// (is_bf16 ? bf16 : f32), row-major; bias [I] f32 or null (zeros). Outputs
// [B, k] f32 scores and i32 ids, best first. Kb = k rounded up to 32 is the
// running list length, G (a multiple of 4, at most 32) the users per block;
// the catalog's ceil(I/128) tiles are cut into n_slices slices of
// tiles_per_slice tiles. With n_slices > 1, part_v / part_i hold
// [n_slices, B, Kb] partial lists (else they may be null). thr: [B] f32
// scratch, the bound on each user's k-th score that the slices share.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int openrec_fused_topk(const void* u, const void* v,
                                  const float* bias, int is_bf16, int B,
                                  int I, int D, int k, int Kb, int G,
                                  int n_slices, int tiles_per_slice,
                                  float* out_v, int* out_i, float* part_v,
                                  int* part_i, float* thr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(u, v, bias, B, I, D, k, Kb, G, n_slices,
                                 tiles_per_slice, out_v, out_i, part_v,
                                 part_i, thr, s);
  return launch<float>(u, v, bias, B, I, D, k, Kb, G, n_slices,
                       tiles_per_slice, out_v, out_i, part_v, part_i, thr,
                       s);
}
