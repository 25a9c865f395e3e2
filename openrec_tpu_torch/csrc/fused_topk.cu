// Exact fused score + top-k for Hopper: a threshold, a filter, one sort.
//
// Replaces the Pallas TPU kernel
//   openrec_tpu/ops/topk.py::_fused_topk_kernel   (K3, wrapper fused_score_topk)
// and computes what it computes: the exact top k of s = u.V^T + b per user,
// the dot products accumulated in fp32 (f32 or bf16 inputs), without ever
// writing the [B, I] scores. The result is ordered by the total order
// (score descending, item id ascending), which is what lax.top_k's merge of
// concat([best, tile]) gives: among equal scores the smaller id comes first.
// Items t >= I are masked by the kernels themselves (nothing is padded in
// device memory), so no id >= I is ever returned, even when k == I.
//
// What bounds it on an H100: the function reads u and V once and does
// 2*B*I*D operations. At the CiteULike retrieval shape (B 256, I 16,980,
// D 50, f32, k 100) that is 0.435 GFLOP, ~6.5 us at the 67 TFLOP/s fp32
// CUDA-core peak; at the Amazon shape (I 450,166, D 64, bf16) 57.6 MB of
// table, ~18 us at 3.35 TB/s. The score passes below run the products on
// the CUDA cores in fp32 and read V twice, so FMA issue bounds them. What
// made the earlier design of this kernel lose to matmul + torch.topk was
// not the products but the selection: a running top-k list per user and
// catalog slice, sorted and merged 32 candidates at a time, a second
// launch merging the slices' lists, and a block barrier per tile that made
// every warp wait for the slowest warp's merges.
//
// Design: no running lists. Four stages on the caller's stream, stages 2-4
// from one C call (openrec_k3):
//   1. Bound pass: the K1 kernel (bucket_max.cu) as it is, at a bucket that
//      leaves L >= 8 * Kb buckets (Kb = k rounded up to 32): [B, L] bucket
//      maxima and their argmax ids, which are distinct items.
//   2. tau_kernel, one block per user: rescores every argmax id < I with
//      item_score(), the filter's own arithmetic, and takes tau, the k-th
//      largest of these L values (a radix select; -inf when fewer than k ids
//      are real items). k distinct items score >= tau in the filter's
//      numbers, so the k-th best score is >= tau, and every item of the
//      result, ties at the k-th place included, passes s >= tau. K1's own
//      maxima are summed in another order: an item could clear them in K1's
//      numbers and miss them in the filter's, so they are not used.
//   3. filter_kernel: the score tiles of the earlier design (a block owns 32
//      users and one contiguous catalog slice; slices x user groups fill the
//      card once), with a register epilogue: keep s >= tau, and compact the
//      kept (score, id) of each 32 items with a ballot into cand[u][0, C),
//      behind one atomicAdd on count[u]. Counting goes on past C.
//   4. final_kernel, one block per user: when count <= C, one block-wide
//      bitonic sort in shared memory of the candidates (padded to a power
//      of two) and the first k out. With distinct scores about k + k^2/(2L)
//      items pass, and C is the smallest power of two >= 4 * Kb, so
//      count > C needs mass ties at tau. Then the same block rescans the
//      catalog exactly: a running top-Kb kept through chunks of C - Kb
//      scores from item_score(), each step one sort of C entries. A slow
//      path inside the kernel, never a fall-back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTile = 128;           // items per tile
constexpr int kChunks = 4;           // 16-byte tile chunks a thread has in flight
constexpr int kFilterThreads = 256;  // 8 warps of 4 users
constexpr int kUsers = kFilterThreads / 8;  // users per filter block
constexpr int kFilterBlocksPerSm = 2;  // topk.py's _FILTER_BLOCKS_PER_SM
constexpr int kTauThreads = 1024;    // ~1 rescored id a thread at L ~ 1-2K
constexpr int kFinalThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoId = INT_MAX;       // id of padding (score -inf)

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

// The result's total order: score descending, then id ascending.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// The score of item t for the user whose fp32 vector is us[0, D): fmaf over
// d = 0 .. D-1 in order, starting from 0, then the bias added last. Each
// accumulator of filter_kernel runs this same sequence (its zero-padded
// columns add fmaf(0, 0, acc) == acc), so the two give equal scores for one
// item. The tau and rescan code score items only through this helper, so
// that their numbers are the filter's own. VEC: rows are whole 16-byte
// chunks (D * sizeof(T) % 16 == 0, v 16-byte aligned), loaded as such; the
// sums are the same.
template <typename T, bool VEC>
__device__ __forceinline__ float item_score(const float* us,
                                            const T* __restrict__ v,
                                            const float* __restrict__ bias,
                                            int D, int t) {
  const T* row = v + (long long)t * D;
  float acc = 0.f;
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);
    const uint4* q = reinterpret_cast<const uint4*>(row);
    for (int c = 0; c < D / E; ++c) {
      const uint4 w = __ldg(q + c);
#pragma unroll
      for (int x = 0; x < E; ++x)
        acc = fmaf(us[c * E + x], chunk_elem<T>(w, x), acc);
    }
  } else {
#pragma unroll 8
    for (int d = 0; d < D; ++d) acc = fmaf(us[d], to_f32(row[d]), acc);
  }
  return acc + (bias != nullptr ? bias[t] : 0.f);
}

// Float <-> unsigned key of the same order (no NaN): a negative float has
// all its bits flipped, a non-negative one its sign bit set.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_float(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Stage 2, one block per user b: rescore the user's L bucket argmax ids in
// place of K1's maxima (ids >= I: -inf), set tau[b] to the k-th largest of
// them (k <= L), and zero count[b] for the filter.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kTauThreads)
tau_kernel(const T* __restrict__ u, const T* __restrict__ v,
           const float* __restrict__ bias, int I, int D, int L, int k,
           float* bmax_v, const int* __restrict__ bmax_i,
           float* __restrict__ tau, int* __restrict__ count) {
  extern __shared__ float4 smem4[];
  float* us = reinterpret_cast<float*>(smem4);  // [D]
  __shared__ unsigned hist[256];
  __shared__ unsigned pick[2];                  // digit, rank within it
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    us[d] = to_f32(u[(long long)b * D + d]);
  __syncthreads();
  float* vals = bmax_v + (long long)b * L;
  const int* ids = bmax_i + (long long)b * L;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const int t = ids[j];
    vals[j] = (t >= 0 && t < I) ? item_score<T, VEC>(us, v, bias, D, t)
                                : -CUDART_INF_F;
  }
  // Radix select of the k-th largest key, 8 bits a pass from the top:
  // rank is the wanted key's rank among the keys that match prefix.
  unsigned prefix = 0u, mask = 0u, rank = (unsigned)k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int e = threadIdx.x; e < 256; e += blockDim.x) hist[e] = 0u;
    __syncthreads();  // also puts every vals write before these reads
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
      const unsigned key = order_key(vals[j]);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l holds digits 255 - 8l down to 248 - 8l; incl counts the
      // keys at or above the lane's lowest digit
      unsigned c = 0u;
#pragma unroll
      for (int x = 0; x < 8; ++x) c += hist[255 - 8 * lane - x];
      unsigned incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      unsigned above = incl - c;
      if (above < rank && rank <= incl) {  // exactly one lane
        for (int x = 0; x < 8; ++x) {
          const unsigned h = hist[255 - 8 * lane - x];
          if (above + h >= rank) {
            pick[0] = 255 - 8 * lane - x;
            pick[1] = rank - above;
            break;
          }
          above += h;
        }
      }
    }
    __syncthreads();
    prefix |= pick[0] << shift;
    mask |= 255u << shift;
    rank = pick[1];
  }
  if (threadIdx.x == 0) {
    tau[b] = key_float(prefix);
    count[b] = 0;
  }
}

// Stage 3: the scores of G users x one catalog slice, tile by tile; every
// score s >= tau of its user is appended to the user's candidates.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kFilterThreads, kFilterBlocksPerSm)
filter_kernel(const T* __restrict__ u, const T* __restrict__ v,
              const float* __restrict__ bias, int B, int I, int D, int Dp,
              int Sv, int tiles_per_slice, int C,
              const float* __restrict__ tau, int* __restrict__ count,
              float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ float4 smem4[];
  const int G = blockDim.x >> 3;               // 4 users per warp
  float* us = reinterpret_cast<float*>(smem4);  // [G][Dp]
  float* vs = us + G * Dp;                      // [kTile][Sv]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

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
  // the thresholds of the warp's 4 users
  const int b_lane = user0 + warp * 4 + lane;
  const float tau_lane =
      (lane < 4 && b_lane < B) ? tau[b_lane] : CUDART_INF_F;
  float thr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) thr[i] = __shfl_sync(kFull, tau_lane, i);

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
      const int b = user0 + warp * 4 + i;
      if (b >= B) continue;  // warp-uniform
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = lane + 32 * q;
        const float s = acc[i][q] + bq[q];
        const bool keep = r < rows && s >= thr[i];
        const unsigned m = __ballot_sync(kFull, keep);
        if (m == 0) continue;  // the common case
        int base = 0;
        if (lane == 0) base = atomicAdd(count + b, __popc(m));
        base = __shfl_sync(kFull, base, 0) +
               __popc(m & ((1u << lane) - 1u));
        if (keep && base < C) {
          cand_v[(long long)b * C + base] = s;
          cand_i[(long long)b * C + base] = (int)(t0 + r);
        }
      }
    }
  }
}

// Sort (sv, si)[0, n) best first under better(), n a power of two: a
// bitonic sort by the whole block, which ends with a barrier.
__device__ void block_sort(float* sv, int* si, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const float vi = sv[i], vj = sv[j];
        const int ii = si[i], ij = si[j];
        // runs of `size` alternate best-first and worst-first
        const bool swap = (i & size) == 0 ? better(vj, ij, vi, ii)
                                          : better(vi, ii, vj, ij);
        if (swap) {
          sv[i] = vj;
          si[i] = ij;
          sv[j] = vi;
          si[j] = ii;
        }
      }
      __syncthreads();
    }
  }
}

// Stage 4, one block per user b: the first k of its candidates, sorted; or,
// when more than C passed the filter, the first k of an exact rescan.
template <typename T>
__global__ void __launch_bounds__(kFinalThreads)
final_kernel(const T* __restrict__ u, const T* __restrict__ v,
             const float* __restrict__ bias, int I, int D, int k, int Kb,
             int C, const float* __restrict__ cand_v,
             const int* __restrict__ cand_i, const int* __restrict__ count,
             float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  float* sv = reinterpret_cast<float*>(smem4);   // [C]
  int* si = reinterpret_cast<int*>(sv + C);      // [C]
  float* us = reinterpret_cast<float*>(si + C);  // [D]
  const int b = blockIdx.x;
  const int n = count[b];
  if (n <= C) {
    int P = 1;  // n >= k unless the filter lost an item; P <= C either way
    while (P < max(n, k)) P <<= 1;
    for (int e = threadIdx.x; e < P; e += blockDim.x) {
      const bool real = e < n;
      sv[e] = real ? cand_v[(long long)b * C + e] : -CUDART_INF_F;
      si[e] = real ? cand_i[(long long)b * C + e] : kNoId;
    }
    __syncthreads();
    block_sort(sv, si, P);
  } else {
    // [0, Kb): the running best; [Kb, C): the next chunk of the catalog
    for (int d = threadIdx.x; d < D; d += blockDim.x)
      us[d] = to_f32(u[(long long)b * D + d]);
    for (int e = threadIdx.x; e < Kb; e += blockDim.x) {
      sv[e] = -CUDART_INF_F;
      si[e] = kNoId;
    }
    __syncthreads();
    const int chunk = C - Kb;
    for (long long lo = 0; lo < I; lo += chunk) {
      for (int j = threadIdx.x; j < chunk; j += blockDim.x) {
        const long long t = lo + j;
        const bool real = t < I;
        sv[Kb + j] = real ? item_score<T, false>(us, v, bias, D, (int)t)
                          : -CUDART_INF_F;
        si[Kb + j] = real ? (int)t : kNoId;
      }
      __syncthreads();
      block_sort(sv, si, C);
    }
  }
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    out_v[(long long)b * k + e] = sv[e];
    out_i[(long long)b * k + e] = si[e];
  }
}

// Launch stages first .. last (1 tau, 2 filter, 3 final) on one stream.
template <typename T>
cudaError_t launch(const void* u_, const void* v_, const float* bias, int B,
                   int I, int D, int L, int k, int Kb, int C, int n_slices,
                   int tiles_per_slice, float* bmax_v, const int* bmax_i,
                   float* tau, int* count, float* cand_v, int* cand_i,
                   float* out_v, int* out_i, int first, int last,
                   cudaStream_t stream) {
  const T* u = static_cast<const T*>(u_);
  const T* v = static_cast<const T*>(v_);
  // whole 16-byte chunk loads need V to start on a 16-byte boundary
  const bool aligned = reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaError_t err = cudaSuccess;
  if (first <= 1 && last >= 1) {
    auto kernel = aligned && (D * sizeof(T)) % 16 == 0 ? tau_kernel<T, true>
                                                       : tau_kernel<T, false>;
    kernel<<<B, kTauThreads, sizeof(float) * D, stream>>>(
        u, v, bias, I, D, L, k, bmax_v, bmax_i, tau, count);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (first <= 2 && last >= 2) {
    const int Dp = (D + 3) & ~3;
    const int Sv = ((Dp >> 2) & 1) ? Dp : Dp + 4;
    const size_t smem =
        sizeof(float) * ((size_t)kUsers * Dp + (size_t)kTile * Sv);
    auto kernel = aligned ? filter_kernel<T, true> : filter_kernel<T, false>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(n_slices, (B + kUsers - 1) / kUsers);
    kernel<<<grid, kFilterThreads, smem, stream>>>(
        u, v, bias, B, I, D, Dp, Sv, tiles_per_slice, C, tau, count, cand_v,
        cand_i);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (first <= 3 && last >= 3) {
    const size_t smem = 8 * (size_t)C + sizeof(float) * D;
    err = cudaFuncSetAttribute(final_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    final_kernel<T><<<B, kFinalThreads, smem, stream>>>(
        u, v, bias, I, D, k, Kb, C, cand_v, cand_i, count, out_v, out_i);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// C entry point, bound with ctypes: stages first .. last of K3 after the
// K1 bound pass (1 tau, 2 filter, 3 final; the wrapper runs 1 .. 3 in one
// call, a timing harness one at a time). u [B, D] and v [I, D] share one
// dtype (is_bf16 ? bf16 : f32), row-major; bias [I] f32 or null (zeros).
//   bmax_v / bmax_i: K1's [B, L] maxima and argmax ids (k <= L); tau
//     overwrites bmax_v with the rescored values.
//   tau [B] f32, count [B] i32, cand_v / cand_i [B, C] f32 / i32: scratch;
//     count is the number of candidates that passed the filter, past C too.
//   out_v / out_i [B, k] f32 / i32: the result, best first.
// k <= Kb (k rounded up to 32), 4 * Kb <= C (a power of two); the
// catalog's ceil(I/128) tiles are cut into n_slices slices of
// tiles_per_slice tiles. Returns cudaGetLastError() after the launches
// (0 = success).
extern "C" int openrec_k3(const void* u, const void* v, const float* bias,
                          int is_bf16, int B, int I, int D, int L, int k,
                          int Kb, int C, int n_slices, int tiles_per_slice,
                          float* bmax_v, const int* bmax_i, float* tau,
                          int* count, float* cand_v, int* cand_i,
                          float* out_v, int* out_i, int first, int last,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(u, v, bias, B, I, D, L, k, Kb, C, n_slices,
                                 tiles_per_slice, bmax_v, bmax_i, tau, count,
                                 cand_v, cand_i, out_v, out_i, first, last,
                                 s);
  return launch<float>(u, v, bias, B, I, D, L, k, Kb, C, n_slices,
                       tiles_per_slice, bmax_v, bmax_i, tau, count, cand_v,
                       cand_i, out_v, out_i, first, last, s);
}
