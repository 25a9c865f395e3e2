// Fused score + strided bucket-max (top-1 or top-2 per bucket) for Hopper.
//
// Replaces the Pallas TPU kernels
//   openrec_tpu/ops/bucketed_topk.py::_bucket_max_kernel   (K1, top-1)
//   openrec_tpu/ops/bucketed_topk.py::_bucket_max2_kernel  (K2, top-2)
// and computes what they compute: s = u.V^T + b in fp32 (f32 or bf16
// inputs), reduced per strided bucket without ever writing the [B, I]
// scores. Item t lies in bucket (t / (128*bucket))*128 + t % 128; within a
// grid block j of 128*bucket items, bucket member a of lane l is item
// j*128*bucket + a*128 + l. Items t >= I score -1e30. Accumulators start
// at -inf; strict `>` keeps the earliest member on ties (slot 1); K2's
// second slot follows the reference merge rule, its tie order unspecified.
// With bucket == 1, K2's second slot stays -inf and names the first member.
//
// What bounds it on an H100 at the serving shape (B = 256 users, the
// 450,166 x 64 bf16 catalog, bucket 64 -> L = 7,040): ~57.6 MB of table
// plus ~14.4 MB of K1 outputs, 73.8 MB in all, is ~22 us at 3.35 TB/s;
// the 14.8 GFLOP of dot products are ~15 us on the bf16 tensor cores. So
// the work is memory-bound — IF the products run on the tensor cores.
// This first design runs them on the CUDA cores in fp32 (67 TFLOP/s peak,
// ~0.22 ms for 14.8 GFLOP), so it is bound by FMA issue, not by bytes.
// wgmma/TMA pipelines are the next step; this one is simple and right.
//
// Design. One block = 64 users x 64 of the 128 lanes of one grid block j
// (two blocks per j), 256 threads, each owning 4 users x 4 lanes and
// their running (max, member) state in registers. The user tile is staged
// once in shared memory as fp32 [D][64]; for each member a, the 64 item
// rows j*128*bucket + a*128 + [0, 64) (one contiguous run of 64*D
// elements, read coalesced) are staged as fp32 [D][64], then each thread
// does a 4x4 outer product per d from two float4 shared-memory loads.
// When the grid (grid blocks x lane halves x user tiles) is too small to
// fill the card, the member range [0, bucket) is split across n_split
// blocks that write partial states, and a second pass merges them in
// member order with the same rule (earlier split = lower indices, so the
// earliest-member tie rule survives).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kLanes = 128;        // bucket stride of the strided layout
constexpr int kUsers = 64;         // users per block
constexpr int kBlockLanes = 64;    // lanes per block (half a grid block)
constexpr int kThreads = 256;      // 16 x 16 threads, 4 users x 4 lanes each
constexpr int kStride = 64 + 4;    // smem row stride (floats): keeps the
                                   // float4 loads 16-byte aligned
constexpr float kPadScore = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, bool TOP2>
__global__ void __launch_bounds__(kThreads)
bucket_max_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const float* __restrict__ bias, int B, int I, int D,
                  int bucket, int n_split, int L,
                  float* __restrict__ out_v1, int* __restrict__ out_i1,
                  float* __restrict__ out_v2, int* __restrict__ out_i2) {
  extern __shared__ float4 smem4[];
  float* u_s = reinterpret_cast<float*>(smem4);  // [D][kStride]
  float* v_s = u_s + D * kStride;                // [D][kStride]

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // lane group: lanes tx*4 .. tx*4+3
  const int ty = tid >> 4;   // user group: users ty*4 .. ty*4+3
  const int z = blockIdx.x % n_split;
  const int jh = blockIdx.x / n_split;
  const int j = jh >> 1;
  const int lane_base = (jh & 1) * kBlockLanes;
  const int user0 = blockIdx.y * kUsers;
  const long long item_block = (long long)bucket * kLanes;
  const int a_per = (bucket + n_split - 1) / n_split;
  const int a_begin = z * a_per;
  const int a_end = min(bucket, a_begin + a_per);

  // User tile, transposed to [d][user], zeros past B.
  for (int e = tid; e < kUsers * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int b = user0 + r;
    u_s[d * kStride + r] = b < B ? to_f32(u[(long long)b * D + d]) : 0.f;
  }

  float v1[4][4], v2[4][4];
  int c1[4][4], c2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v1[i][q] = -CUDART_INF_F;
      v2[i][q] = -CUDART_INF_F;
      c1[i][q] = a_begin;
      c2[i][q] = a_begin;
    }

  // Walk the tile's elements e = tid, tid + 256, ... as (row, d) without
  // dividing in the loop.
  const int dr = kThreads / D, dd = kThreads % D;
  const int r_first = tid / D, d_first = tid - r_first * D;

  for (int a = a_begin; a < a_end; ++a) {
    const long long t0 = j * item_block + (long long)a * kLanes + lane_base;
    __syncthreads();  // the previous tile has been consumed
    {
      int r = r_first, d = d_first;
      const T* src = v + t0 * D;
      for (int e = tid; e < kBlockLanes * D; e += kThreads) {
        v_s[d * kStride + r] = (t0 + r < I) ? to_f32(src[e]) : 0.f;
        r += dr;
        d += dd;
        if (d >= D) {
          d -= D;
          ++r;
        }
      }
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 uu =
          *reinterpret_cast<const float4*>(&u_s[d * kStride + ty * 4]);
      const float4 vv =
          *reinterpret_cast<const float4*>(&v_s[d * kStride + tx * 4]);
      const float ua[4] = {uu.x, uu.y, uu.z, uu.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(ua[i], va[q], acc[i][q]);
    }

#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long t = t0 + tx * 4 + q;
      const bool real = t < I;
      const float bq = (real && bias != nullptr) ? bias[t] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = real ? acc[i][q] + bq : kPadScore;
        if (TOP2) {
          float lose_v = s;
          int lose_c = a;
          if (s > v1[i][q]) {
            lose_v = v1[i][q];
            lose_c = c1[i][q];
            v1[i][q] = s;
            c1[i][q] = a;
          }
          if (lose_v > v2[i][q]) {
            v2[i][q] = lose_v;
            c2[i][q] = lose_c;
          }
        } else if (s > v1[i][q]) {
          v1[i][q] = s;
          c1[i][q] = a;
        }
      }
    }
  }

  const long long plane = (long long)z * B * L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = user0 + ty * 4 + i;
    if (b >= B) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lane = lane_base + tx * 4 + q;
      const long long o = plane + (long long)b * L + (long long)j * kLanes + lane;
      const long long base = j * item_block + lane;
      out_v1[o] = v1[i][q];
      out_i1[o] = (int)(base + (long long)c1[i][q] * kLanes);
      if (TOP2) {
        out_v2[o] = v2[i][q];
        out_i2[o] = (int)(base + (long long)c2[i][q] * kLanes);
      }
    }
  }
}

// Second pass: merge n_split partial [B, L] states in split order with the
// reference's pair merge rule (bucketed_topk.py:170-183).
template <bool TOP2>
__global__ void merge_splits_kernel(const float* __restrict__ pv1,
                                    const int* __restrict__ pi1,
                                    const float* __restrict__ pv2,
                                    const int* __restrict__ pi2, int n_split,
                                    long long n, float* __restrict__ v1,
                                    int* __restrict__ i1,
                                    float* __restrict__ v2,
                                    int* __restrict__ i2) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float a1 = pv1[idx], a2 = -CUDART_INF_F;
  int c1 = pi1[idx], c2 = 0;
  if (TOP2) {
    a2 = pv2[idx];
    c2 = pi2[idx];
  }
  for (int z = 1; z < n_split; ++z) {
    const long long o = (long long)z * n + idx;
    const float b1 = pv1[o];
    const int d1 = pi1[o];
    if (TOP2) {
      const float b2 = pv2[o];
      const int d2 = pi2[o];
      const bool take_b = b1 > a1;
      const float lose_v = take_b ? a1 : b1;
      const int lose_c = take_b ? c1 : d1;
      if (take_b) {
        a1 = b1;
        c1 = d1;
      }
      if (b2 > a2) {
        a2 = b2;
        c2 = d2;
      }
      if (lose_v > a2) {
        a2 = lose_v;
        c2 = lose_c;
      }
    } else if (b1 > a1) {
      a1 = b1;
      c1 = d1;
    }
  }
  v1[idx] = a1;
  i1[idx] = c1;
  if (TOP2) {
    v2[idx] = a2;
    i2[idx] = c2;
  }
}

template <typename T, bool TOP2>
cudaError_t launch(const void* u, const void* v, const float* bias, int B,
                   int I, int D, int bucket, int n_split, int L, float* v1,
                   int* i1, float* v2, int* i2, float* pv1, int* pi1,
                   float* pv2, int* pi2, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)D * kStride * sizeof(float);
  auto kernel = bucket_max_kernel<T, TOP2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_j = L / kLanes;
  const dim3 grid(n_j * 2 * n_split, (B + kUsers - 1) / kUsers);
  const bool split = n_split > 1;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v), bias, B, I, D,
      bucket, n_split, L, split ? pv1 : v1, split ? pi1 : i1,
      split ? pv2 : v2, split ? pi2 : i2);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const long long n = (long long)B * L;
  merge_splits_kernel<TOP2><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      pv1, pi1, pv2, pi2, n_split, n, v1, i1, v2, i2);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. u [B, D] and v [I, D] share one dtype
// (is_bf16 ? bf16 : f32), row-major; bias [I] f32 or null (zeros). Outputs
// [B, L] with L = 128 * ceil(I / (128 * bucket)); the top-2 outputs and the
// [n_split, B, L] partials may be null when unused. Returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int openrec_bucket_max(const void* u, const void* v,
                                  const float* bias, int is_bf16, int top2,
                                  int B, int I, int D, int bucket,
                                  int n_split, int L, float* v1, int* i1,
                                  float* v2, int* i2, float* pv1, int* pi1,
                                  float* pv2, int* pi2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return top2 ? launch<__nv_bfloat16, true>(u, v, bias, B, I, D, bucket,
                                              n_split, L, v1, i1, v2, i2,
                                              pv1, pi1, pv2, pi2, s)
                : launch<__nv_bfloat16, false>(u, v, bias, B, I, D, bucket,
                                               n_split, L, v1, i1, v2, i2,
                                               pv1, pi1, pv2, pi2, s);
  }
  return top2 ? launch<float, true>(u, v, bias, B, I, D, bucket, n_split, L,
                                    v1, i1, v2, i2, pv1, pi1, pv2, pi2, s)
              : launch<float, false>(u, v, bias, B, I, D, bucket, n_split,
                                     L, v1, i1, v2, i2, pv1, pi1, pv2, pi2, s);
}
