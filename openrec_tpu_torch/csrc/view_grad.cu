// The gradient of the sparse step's gathered-view lookups and bags
// (Hopper): every view row's sum over its lookups, in the order the dedup
// sorted them, with no sort and no atomics.
//
// Replaces no Pallas kernel. The JAX package's sparse step takes the
// gradient of `jnp.take` on the gathered rows, a scatter-add that XLA
// lowers. PyTorch's backward of `index_select` and of `embedding_bag`
// sorts the step's lookups again, and walks each row's run of duplicates
// with one warp, so a Zipf-hot row of tens of thousands of lookups sets
// its length. Here the grouping comes in as `order`: a permutation that
// sorts the lookups by view row, stable (the flat dedup's sort of the
// same ids, since the search that maps ids to rows is monotone; any other
// view's one stable sort of its positions). Three passes follow a memset:
//
//   mark:   for each sorted lookup s, its row and the row of the gradient
//           it reads (the lookup's own, or its bag's); where the row
//           changes, span[r] = [first, end) of row r's run;
//   chunks: a row of more than kChunk lookups is cut, from its first
//           lookup on, into full chunks of kChunk and a shorter tail.
//           Each full chunk is summed by its own group of lanes into
//           partials[s / kChunk], s its first lookup: full chunks start
//           at least kChunk apart, so the slot is theirs alone;
//   rows:   each of the view's rows is written once: zeros where no
//           lookup names it (a pad, an empty hash slot), else the sum of
//           its chunks' partials in order, then of its tail's lookups, one
//           after another, from zero.
//
// A row's sum so depends on its own lookups, in order, alone: not on
// where its run lies in the sorted stream. It is the same in every dedup
// mode (each puts a row's lookups in the batch's order) and in every run.
// fp32 throughout; each add is one fp32 add rounded to nearest
// (__fadd_rn). The chunks spread a hot row over many groups of lanes; the
// rows pass then reads at most (lookups / kChunk) partials of a row.
//
// What bounds it on an H100: bytes. Each lookup's gradient row is read
// once (4 * D bytes; a bag's row once for each of its lookups) and the
// [cap, D] gradient is written once: at train-zipf's 1,703,936 lookups
// into a [1,703,936, 16] view ~218 MB, 0.065 ms at 3.35 TB/s. The lanes
// of a row take its 16-byte pieces (float4 where D % 4 == 0 and the
// gradient is 16-byte aligned, else single floats), neighbouring lanes on
// neighbouring addresses: a power of two of lanes a row, as many as the
// row has pieces up to 32 (4 at D 16, a warp at D 128), looping where the
// row is wider.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

template <int kVec>
struct Piece;

template <>
struct Piece<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Piece<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, T v) { *p = v; }
};

template <typename Pos>
__global__ void __launch_bounds__(kThreads)
    view_grad_segment_sum_mark(const Pos* __restrict__ positions,
                               const int64_t* __restrict__ order,
                               const int64_t* __restrict__ bag, int64_t n,
                               int* __restrict__ rows_sorted,
                               int* __restrict__ src_sorted,
                               int* __restrict__ span) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n) return;
  const int64_t j = order[s];
  const int r = static_cast<int>(positions[j]);
  rows_sorted[s] = r;
  src_sorted[s] = static_cast<int>(bag != nullptr ? bag[j] : j);
  if (s == 0 || static_cast<int>(positions[order[s - 1]]) != r)
    span[2 * static_cast<int64_t>(r)] = static_cast<int>(s);
  if (s + 1 == n || static_cast<int>(positions[order[s + 1]]) != r)
    span[2 * static_cast<int64_t>(r) + 1] = static_cast<int>(s + 1);
}

// One group of `lanes` lanes a block of kChunk sorted lookups [lo, hi): at
// most one full chunk starts there. It is either a chunk of the row that
// runs at lo, or the first chunk of a long row that starts inside the
// block, which then still runs at hi - 1.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    view_grad_segment_sum_chunks(const float* __restrict__ grad,
                                 const int* __restrict__ rows_sorted,
                                 const int* __restrict__ src_sorted,
                                 const int* __restrict__ span, int64_t n,
                                 int D, int lanes,
                                 float* __restrict__ partials) {
  using P = Piece<kVec>;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * (kThreads / lanes) +
                    threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  const int64_t lo = b * kChunk;
  if (lo >= n) return;
  const int64_t hi = lo + kChunk < n ? lo + kChunk : n;
  int64_t start = -1;
  {
    const int64_t r = rows_sorted[lo];
    const int64_t f = span[2 * r], e = span[2 * r + 1];
    if (e - f > kChunk) {
      const int64_t c = f + (lo - f + kChunk - 1) / kChunk * kChunk;
      if (c < hi && c + kChunk <= e) start = c;
    }
  }
  if (start < 0) {
    const int64_t r = rows_sorted[hi - 1];
    const int64_t f = span[2 * r], e = span[2 * r + 1];
    if (f > lo && e - f > kChunk) start = f;
  }
  if (start < 0) return;
  const int pieces = D / kVec;
  for (int c = lane; c < pieces; c += lanes) {
    const float* g = grad + c * kVec;
    typename P::T acc = P::zero();
#pragma unroll 8
    for (int i = 0; i < kChunk; ++i)
      acc = add(acc, P::load(g + static_cast<int64_t>(src_sorted[start + i]) * D));
    P::store(partials + b * D + c * kVec, acc);
  }
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    view_grad_segment_sum_rows(const float* __restrict__ grad,
                               const int* __restrict__ src_sorted,
                               const int* __restrict__ span,
                               const float* __restrict__ partials,
                               int64_t cap, int D, int lanes,
                               float* __restrict__ out) {
  using P = Piece<kVec>;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (kThreads / lanes) +
                    threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  if (r >= cap) return;
  const int64_t f = span[2 * r], e = span[2 * r + 1];  // f < 0: no lookup
  const int64_t full = f >= 0 && e - f > kChunk ? (e - f) / kChunk : 0;
  const int64_t tail = f >= 0 ? f + full * kChunk : 0;
  const int64_t end = f >= 0 ? e : 0;
  const float* part = partials + (f >= 0 ? f / kChunk : 0) * D;
  const int pieces = D / kVec;
  for (int c = lane; c < pieces; c += lanes) {
    typename P::T acc = P::zero();
#pragma unroll 8
    for (int64_t k = 0; k < full; ++k)
      acc = add(acc, P::load(part + k * D + c * kVec));
    const float* g = grad + c * kVec;
#pragma unroll 8
    for (int64_t s = tail; s < end; ++s)
      acc = add(acc, P::load(g + static_cast<int64_t>(src_sorted[s]) * D));
    P::store(out + r * D + c * kVec, acc);
  }
}

int lanes_for(int pieces) {
  int lanes = 1;
  while (lanes < pieces && lanes < 32) lanes *= 2;
  return lanes;
}

template <int kVec>
void launch_sums(const float* grad, const int* rows_sorted,
                 const int* src_sorted, const int* span, float* partials,
                 float* out, int64_t n, int64_t cap, int D, cudaStream_t s) {
  const int lanes = lanes_for(D / kVec);
  const int64_t groups = kThreads / lanes;
  if (n > 0) {
    const int64_t blocks = (n + kChunk - 1) / kChunk;
    view_grad_segment_sum_chunks<kVec>
        <<<static_cast<unsigned>((blocks + groups - 1) / groups), kThreads, 0,
           s>>>(grad, rows_sorted, src_sorted, span, n, D, lanes, partials);
  }
  view_grad_segment_sum_rows<kVec>
      <<<static_cast<unsigned>((cap + groups - 1) / groups), kThreads, 0, s>>>(
          grad, src_sorted, span, partials, cap, D, lanes, out);
}

}  // namespace

// The lookups' chunk length, which sizes `partials`.
extern "C" int openrec_view_grad_chunk() { return kChunk; }

// grad: [M, D] fp32, contiguous (M = n lookups, or the bags); positions:
// [n] int64 (pos_int64) or int32, each in [0, cap); order: [n] int64, a
// permutation that sorts the lookups by position; bag: [n] int64, each
// lookup's row of grad, or null (lookup i reads row i); work: 2 * n +
// 2 * cap ints; partials: ceil(n / kChunk) * D floats; out: [cap, D] fp32,
// every row written. vec4 requires D % 4 == 0 and a 16-byte aligned grad.
// Returns the first CUDA error of the memset or the launches.
extern "C" int openrec_view_grad(const float* grad, const void* positions,
                                 int pos_int64, const int64_t* order,
                                 const int64_t* bag, long long n,
                                 long long cap, int D, int vec4, int* work,
                                 float* partials, float* out, void* stream) {
  if (cap <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* rows_sorted = work;
  int* src_sorted = work + n;
  int* span = work + 2 * n;
  cudaError_t err =
      cudaMemsetAsync(span, 0xFF, static_cast<size_t>(cap) * 2 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    if (pos_int64)
      view_grad_segment_sum_mark<int64_t><<<blocks, kThreads, 0, s>>>(
          static_cast<const int64_t*>(positions), order, bag, n, rows_sorted,
          src_sorted, span);
    else
      view_grad_segment_sum_mark<int32_t><<<blocks, kThreads, 0, s>>>(
          static_cast<const int32_t*>(positions), order, bag, n, rows_sorted,
          src_sorted, span);
  }
  if (vec4)
    launch_sums<4>(grad, rows_sorted, src_sorted, span, partials, out, n, cap,
                   D, s);
  else
    launch_sums<1>(grad, rows_sorted, src_sorted, span, partials, out, n, cap,
                   D, s);
  return static_cast<int>(cudaGetLastError());
}
