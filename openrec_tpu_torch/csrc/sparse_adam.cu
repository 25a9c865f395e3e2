// Keras-form Adam on the O(batch) sparse step's live rows, written back in
// place (Hopper).
//
// Replaces no Pallas kernel. The JAX package's sparse step
// (openrec_tpu/training/sparse.py) gathers both moments at every slot of
// a table's padded unique ids, runs Adam there and adds the deltas back
// with a scatter, each pad's delta multiplied by zero; XLA fuses that. In
// PyTorch the same steps are about twenty launches over all [cap, D]
// slots, and in the flat dedup every pad repeats the last unique id, so
// the three `index_add_` pile the pads' zero deltas onto one row by
// atomics. This kernel does the same arithmetic on the live slots alone.
//
// For every slot s with write[s] (live slots name distinct rows, which
// every dedup mode guarantees, so there are no atomics and no order):
//   r = at[s];  m = mu[r];  v = nu[r];  x = g[s]
//   m' = b1*m + (1-b1)*x
//   v' = b2*v + ((1-b2)*x)*x
//   step = ((-alpha)*m') / (sqrt(v') + eps)
//   table[r] = table[r] + step;  mu[r] = m + (m' - m);  nu[r] = v + (v' - v)
// Each operation is one fp32 operation rounded to nearest, as the plain
// version's PyTorch operations round it; the intrinsics keep nvcc from
// contracting a product and a sum into an FMA, so the kernel is bit-equal
// to the plain version (ops/sparse_adam.py). `alpha` (the bias-corrected
// step size) is read from the device, so the host never waits for it. A
// slot whose write is false returns before any other load: a pad costs
// one byte.
//
// What bounds it on an H100: bytes. A live row reads its table, mu, nu
// and gradient rows and writes three rows, 7 * 4 * D bytes (448 at
// D = 16), plus its index; every slot reads its mask byte. At
// train-zipf's 210,127 live rows of 1,703,936 slots that is ~96 MB,
// ~29 us at 3.35 TB/s. One thread takes a 16-byte chunk of a slot's row
// (float4 loads, a row's chunks in adjacent threads) where D % 4 == 0 and
// every row pointer is 16-byte aligned, else one element; the grid covers
// every chunk once, 26,624 blocks of 256 at 1.7 M slots and D = 16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float b1, b2, eps, one_minus_b1, one_minus_b2;
};

__device__ __forceinline__ void adam(float& w, float& m, float& v, float x,
                                     float neg_alpha, const Hyper& h) {
  const float m_new = __fadd_rn(__fmul_rn(h.b1, m),
                                __fmul_rn(h.one_minus_b1, x));
  const float v_new = __fadd_rn(__fmul_rn(h.b2, v),
                                __fmul_rn(__fmul_rn(h.one_minus_b2, x), x));
  const float step = __fdiv_rn(__fmul_rn(neg_alpha, m_new),
                               __fadd_rn(__fsqrt_rn(v_new), h.eps));
  w = __fadd_rn(w, step);
  m = __fadd_rn(m, __fsub_rn(m_new, m));
  v = __fadd_rn(v, __fsub_rn(v_new, v));
}

template <typename Index, int kVec>
__global__ void __launch_bounds__(kThreads)
    sparse_adam_kernel(float* __restrict__ table, float* __restrict__ mu,
                       float* __restrict__ nu, const float* __restrict__ g,
                       const Index* __restrict__ at,
                       const uint8_t* __restrict__ write,
                       const float* __restrict__ alpha, int64_t n,
                       int chunks, int D, Hyper h) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t s = i / chunks;
  if (!write[s]) return;
  const int c = static_cast<int>(i - s * chunks) * kVec;
  const int64_t dst = static_cast<int64_t>(at[s]) * D + c;
  const int64_t src = s * D + c;
  const float neg_alpha = -__ldg(alpha);
  if constexpr (kVec == 4) {
    float4 w = *reinterpret_cast<const float4*>(table + dst);
    float4 m = *reinterpret_cast<const float4*>(mu + dst);
    float4 v = *reinterpret_cast<const float4*>(nu + dst);
    const float4 x = __ldg(reinterpret_cast<const float4*>(g + src));
    adam(w.x, m.x, v.x, x.x, neg_alpha, h);
    adam(w.y, m.y, v.y, x.y, neg_alpha, h);
    adam(w.z, m.z, v.z, x.z, neg_alpha, h);
    adam(w.w, m.w, v.w, x.w, neg_alpha, h);
    *reinterpret_cast<float4*>(table + dst) = w;
    *reinterpret_cast<float4*>(mu + dst) = m;
    *reinterpret_cast<float4*>(nu + dst) = v;
  } else {
    float w = table[dst], m = mu[dst], v = nu[dst];
    adam(w, m, v, __ldg(g + src), neg_alpha, h);
    table[dst] = w;
    mu[dst] = m;
    nu[dst] = v;
  }
}

template <typename Index>
void launch(float* table, float* mu, float* nu, const float* g,
            const void* at, const uint8_t* write, const float* alpha,
            int64_t cap, int D, bool vec4, const Hyper& h, cudaStream_t s) {
  const int chunks = vec4 ? D / 4 : D;
  const int64_t n = cap * chunks;
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const Index* idx = static_cast<const Index*>(at);
  if (vec4)
    sparse_adam_kernel<Index, 4><<<blocks, kThreads, 0, s>>>(
        table, mu, nu, g, idx, write, alpha, n, chunks, D, h);
  else
    sparse_adam_kernel<Index, 1><<<blocks, kThreads, 0, s>>>(
        table, mu, nu, g, idx, write, alpha, n, chunks, D, h);
}

}  // namespace

// table, mu, nu: [rows, D] fp32, contiguous, updated in place; g: [cap, D]
// fp32, contiguous; at: [cap] int64 (at_int64) or int32; write: [cap]
// bools (bytes 0 or 1); alpha: one fp32 on the device. vec4 requires
// D % 4 == 0 and 16-byte aligned table, mu, nu and g. Returns
// cudaGetLastError() after the launch.
extern "C" int openrec_sparse_adam(float* table, float* mu, float* nu,
                                   const float* g, const void* at,
                                   int at_int64, const uint8_t* write,
                                   const float* alpha, long long cap, int D,
                                   int vec4, float b1, float b2, float eps,
                                   float one_minus_b1, float one_minus_b2,
                                   void* stream) {
  if (cap <= 0 || D <= 0) return 0;
  const Hyper h{b1, b2, eps, one_minus_b1, one_minus_b2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (at_int64)
    launch<int64_t>(table, mu, nu, g, at, write, alpha, cap, D, vec4 != 0, h,
                    s);
  else
    launch<int32_t>(table, mu, nu, g, at, write, alpha, cap, D, vec4 != 0, h,
                    s);
  return static_cast<int>(cudaGetLastError());
}
