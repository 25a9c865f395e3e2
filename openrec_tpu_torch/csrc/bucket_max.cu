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
// What bounds it on an H100. At the online serving shape (B = 256 users,
// the 450,166 x 64 bf16 catalog) bytes: K1 (bucket 64, L = 7,040) reads
// 57.6 MB of table and writes 14.4 MB of outputs, 73.8 MB in all, ~22 us
// at 3.35 TB/s; K2 (bucket 256, L = 1,792) moves 66.7 MB, ~20 us. At the
// offline shape (B = 1,024, bucket 256) operations: 59.0 GFLOP, ~60 us at
// the bf16 tensor cores' dense rate, against 59.5 MB (~18 us). Beside the
// products, every one of the B * I padded scores needs a bias add, a
// compare and two selects on the CUDA cores (~1.9 G lane operations at
// the offline shape, ~63 us on 132 SMs): the epilogue is as costly as the
// products and has to overlap them. The products take ~0.22 ms on the
// CUDA cores in fp32 (67 TFLOP/s).
//
// Three routes, one function:
//
// bf16 TMA (`bucket_max_wgmma`), for tables whose rows are whole 16-byte
//   chunks (D a multiple of 8, up to 256) starting on a 16-byte boundary,
//   which a TMA map needs: Hopper's warp-specialised shape. One persistent
//   block an SM walks work units of 128 users x 64 lanes of one grid block
//   and member split. A producer warp keeps a ring of up to 12 member tiles
//   full by TMA (64 item rows x D, the hardware zero-filling rows past I
//   and columns past D, in 128-byte swizzled chunks of 64 columns) behind
//   full / empty mbarriers, so no block-wide barrier stalls the consumers.
//   Two consumer warpgroups take users 0-63 and 64-127 of the unit, each
//   `wgmma.m64n64k16` with the member tile as A (items as M) and its user
//   tile, staged once a unit, as B: a V tile lands in shared memory once
//   for 128 users. With items as M a thread holds 2 fixed lanes x 16 users
//   for every member, so the running (max, member) state (and K2's second
//   slot) stays in registers beside the fragment, and a member costs a
//   thread 2 bias loads (-1e30 past I, where the zero rows score 0: no pad
//   test in the epilogue). The accumulators are double-buffered: a
//   warpgroup issues member m+1's products, runs member m's epilogue, and
//   only then waits, so the CUDA cores' compares overlap the tensor cores'
//   products (and the other warpgroup's). `setmaxnreg` gives the consumers
//   232 registers for K2's state. The blocks take equal ranges of the
//   flattened (unit, member) steps, so every round is full to a step; a
//   unit cut between blocks is merged, in member order, by the block that
//   finishes its last part (a count a unit in a workspace the wrapper
//   keeps), so no merge pass follows.
//
// bf16 mma (`bucket_max_mma`), for every other bf16 table (D = 50, 60 or
//   100, views off a 16-byte boundary): the products run on the tensor
//   cores,
//   mma.sync m16n8k16 bf16 x bf16 -> f32 (bf16 products are exact in fp32;
//   only the summation order differs from a plain fp32 product). A block
//   owns 64 users x 64 lanes of one grid block j: 8 warps, each 16 users x
//   32 lanes (4 m16n8 tiles). The user tile is staged once in shared
//   memory; the member tiles (64 contiguous item rows each) stream through
//   a ring of S stages filled by cp.async (16-byte copies where rows and
//   table allow, else 8, 4, or 2-byte loads into the same layout), with
//   the bias slice beside each. D is zero-padded to Dp = ceil(D/16)*16 and
//   each shared row is padded by 16 bytes, so ldmatrix reads are free of
//   bank conflicts. In m16n8k16 a thread owns fixed (user, lane) pairs of
//   the accumulator (rows g, g+8; columns 2*(lane%4), +1), the same ones for
//   every member tile, so the running (max, member) state stays in
//   registers beside the fragment and the epilogue is the compare below,
//   fragment by fragment in member order. The blocks that share a V tile
//   (all user tiles of one j, lane half and member split) are adjacent in
//   launch order, so each V tile crosses HBM once and the other user tiles
//   find it in L2. Every member costs a block-wide barrier and the
//   epilogue runs after the products in the same warps, so this route
//   reaches ~7 % of the bf16 peak; it stays for the rows TMA cannot
//   stride.
//
// f32 (`bucket_max_f32_kernel`): the CUDA cores, fp32 FMAs. `pallas` must
//   return exact fp32 scores (the tensor cores' TF32 keeps ~3 digits), so
//   this route stays on them, and 2*B*I*D operations at 67 TFLOP/s bound
//   it (6.5 us at the CiteULike shape, 256 x 16,980 x 50); at small
//   buckets the [B, L] outputs' bytes come close (K1 at bucket 2 writes
//   17.6 MB, ~5 us). A block owns the same 64 users x 64 lanes, 256
//   threads of 4 users x 4 lanes each; each thread does a 4x4 outer
//   product per d from two float4 loads of the transposed tiles [D][68].
//   The tiles reach shared memory by cp.async: the user tile, then a ring
//   of S slots (`bucketed_topk.f32_plan`), each a member tile and its bias
//   slice. All of a tile's copies are in flight at once, and the next S-1
//   members load while one computes. The copies are 4 bytes wide, each
//   element straight into its transposed place: every fp32 view of the
//   table is 4-byte aligned, so one path serves all of them, a warp's 32
//   copies still read 128 contiguous bytes, and no second pass transposes.
//
// The other two routes split the member range [0, bucket) across n_split
// blocks when the grid would not fill the card; the blocks write partial
// states, and a second pass merges them in member order with the same rule
// (earlier split = lower indices, so the earliest-member tie rule
// survives). The TMA route merges its cut units with the same rule.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kLanes = 128;        // bucket stride of the strided layout
constexpr int kUsers = 64;         // users per block (both routes)
constexpr int kBlockLanes = 64;    // lanes per block (half a grid block)
constexpr int kThreads = 256;
constexpr int kStride = 64 + 4;    // f32 route: smem row stride (floats),
                                   // keeps the float4 loads 16-byte aligned
constexpr float kPadScore = -1e30f;
static_assert(kUsers == kBlockLanes, "one tile walk serves u and V tiles");

// Running top-1 / top-2 state of one (user, lane): the reference's rule.
template <bool TOP2>
__device__ __forceinline__ void update(float s, int a, float& v1, int& c1,
                                       float& v2, int& c2) {
  if (TOP2) {
    float lose_v = s;
    int lose_c = a;
    if (s > v1) {
      lose_v = v1;
      lose_c = c1;
      v1 = s;
      c1 = a;
    }
    if (lose_v > v2) {
      v2 = lose_v;
      c2 = lose_c;
    }
  } else if (s > v1) {
    v1 = s;
    c1 = a;
  }
}

// ------------------------------------------------------------ cp.async

constexpr int kMaxStages = 4;      // deepest ring of either route

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `Bytes` (16, 8 or 4) bytes; src_bytes 0 zero-fills the
// destination and reads nothing.
template <int Bytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if (Bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes) : "memory");
  else if (Bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (0 .. kMaxStages - 1) groups of this thread are in
// flight; wait_group takes an immediate.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// ------------------------------------------------------------- f32 route

// Shared memory: the user tile [D][kStride] floats, transposed, then
// `stages` ring slots, each a member tile [D][kStride] in the same layout
// followed by the member's bias slice of kBlockLanes floats. Rows past B or
// I and bias entries past I (or with no bias) are zero-filled by the copy.
template <bool TOP2>
__global__ void __launch_bounds__(kThreads)
bucket_max_f32_kernel(const float* __restrict__ u, const float* __restrict__ v,
                      const float* __restrict__ bias, int B, int I, int D,
                      int stages, int bucket, int n_split, int L,
                      float* __restrict__ out_v1, int* __restrict__ out_i1,
                      float* __restrict__ out_v2, int* __restrict__ out_i2) {
  extern __shared__ float4 smem4[];
  float* u_s = reinterpret_cast<float*>(smem4);  // [D][kStride]
  float* ring = u_s + D * kStride;               // stages x slot_floats
  const int slot_floats = D * kStride + kBlockLanes;

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
  const int n_tiles = max(0, a_end - a_begin);
  const long long t_first =
      j * item_block + (long long)a_begin * kLanes + lane_base;

  // A tile of 64 rows x D (kUsers == kBlockLanes): thread tid copies elements e = tid, tid + 256,
  // ... (row r, depth d), walked without dividing in the loop, each to its
  // transposed place d * kStride + r. Rows at or past `rows` read nothing.
  const int dr = kThreads / D, dd = kThreads % D;
  const int r_first = tid / D, d_first = tid - r_first * D;
  auto copy_tile = [&](uint32_t dst, const float* src, long long rows) {
    int r = r_first, d = d_first;
    for (int e = tid; e < kBlockLanes * D; e += kThreads) {
      const bool ok = r < rows;
      cp_async<4>(dst + 4 * (d * kStride + r), ok ? src + e : v, ok ? 4 : 0);
      r += dr;
      d += dd;
      if (d >= D) {
        d -= D;
        ++r;
      }
    }
  };
  auto load_tile = [&](int m) {           // member a_begin + m -> slot m % S
    const long long t0 = t_first + (long long)m * kLanes;
    const uint32_t dst = smem_addr(ring + (m % stages) * slot_floats);
    copy_tile(dst, v + t0 * D, I - t0);
    if (tid < kBlockLanes) {
      const bool ok = bias != nullptr && t0 + tid < I;
      cp_async<4>(dst + 4 * (D * kStride + tid), ok ? bias + t0 + tid : v,
                  ok ? 4 : 0);
    }
  };

  // Prologue: the user tile and members 0 .. S-1, one group per slot
  // (empty past the last member, so that every wait below counts the
  // same), the user tile in the first.
  copy_tile(smem_addr(u_s), u + (long long)user0 * D, B - user0);
  for (int m = 0; m < stages; ++m) {
    if (m < n_tiles) load_tile(m);
    cp_async_commit();
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

  for (int a = a_begin; a < a_end; ++a) {
    const int m = a - a_begin;
    const long long t0 = t_first + (long long)m * kLanes;
    const float* v_s = ring + (m % stages) * slot_floats;
    cp_async_wait(stages - 1);   // member m has landed (this thread's part)
    __syncthreads();             // ... everyone's

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

    const float* bs = v_s + D * kStride;   // zeros past I or without bias
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long t = t0 + tx * 4 + q;
      const bool real = t < I;
      const float bq = bs[tx * 4 + q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        update<TOP2>(real ? acc[i][q] + bq : kPadScore, a, v1[i][q],
                     c1[i][q], v2[i][q], c2[i][q]);
    }
    __syncthreads();   // every thread is done with the slot, bias included
    if (m + stages < n_tiles) load_tile(m + stages);
    cp_async_commit();
  }
  cp_async_wait(0);    // no copy may outlive the block (empty groups only)

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

// ------------------------------------------------------------ bf16 route

constexpr int kNT = 4;             // m16n8 tiles per warp: 32 lanes

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Shared memory: the user tile [kUsers][rs] bf16, then `stages` ring
// slots of [kBlockLanes][rs] bf16 rows, then `stages` bias slices of
// kBlockLanes floats. rs = 2*Dp + 16 bytes: an odd number of 16-byte
// chunks, so the 8 row addresses of an ldmatrix fall in 8 distinct bank
// groups.
//
// Grid: blockIdx.x = ((j * n_split + z) * 2 + h) * n_ut + ut, user tile ut
// fastest, so the n_ut blocks that read the same 64 V rows per member run
// side by side.
template <bool TOP2>
__global__ void __launch_bounds__(kThreads, 2)
bucket_max_mma(const __nv_bfloat16* __restrict__ u,
               const __nv_bfloat16* __restrict__ v,
               const float* __restrict__ bias, int B, int I, int D, int Dp,
               int vec, int stages, int bucket, int n_split, int L,
               float* __restrict__ out_v1, int* __restrict__ out_i1,
               float* __restrict__ out_v2, int* __restrict__ out_i2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = 2 * Dp + 16;                        // row stride, bytes
  const int tile_bytes = kBlockLanes * rs;
  unsigned char* u_s = smem;
  unsigned char* ring = smem + kUsers * rs;
  float* bias_s = reinterpret_cast<float*>(ring + stages * tile_bytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wu = warp & 3;      // users 16*wu .. +15 of the block
  const int wl = warp >> 2;     // lanes 32*wl .. +31 of the block
  const int g = lane >> 2, t4 = lane & 3;

  const int n_ut = (B + kUsers - 1) / kUsers;
  const int ut = blockIdx.x % n_ut;
  const int rest = blockIdx.x / n_ut;
  const int h = rest & 1;
  const int z = (rest >> 1) % n_split;
  const int j = (rest >> 1) / n_split;
  const int user0 = ut * kUsers;
  const int lane_base = h * kBlockLanes;
  const long long item_block = (long long)bucket * kLanes;
  const int a_per = (bucket + n_split - 1) / n_split;
  const int a_begin = z * a_per;
  const int a_end = min(bucket, a_begin + a_per);
  const int n_tiles = max(0, a_end - a_begin);
  const long long t_first =
      j * item_block + (long long)a_begin * kLanes + lane_base;

  // User tile [user][Dp] bf16, zeros past B and past D.
  {
    unsigned short* us = reinterpret_cast<unsigned short*>(u_s);
    const unsigned short* ug = reinterpret_cast<const unsigned short*>(u);
    for (int e = tid; e < kUsers * Dp; e += kThreads) {
      const int r = e / Dp, d = e - r * Dp;
      const int b = user0 + r;
      us[r * (rs / 2) + d] = (b < B && d < D) ? ug[(long long)b * D + d] : 0;
    }
  }
  // The ring's pad columns [D, Dp) stay zero: the copies write [0, D).
  if (Dp > D) {
    const int pad = Dp - D;
    for (int e = tid; e < stages * kBlockLanes * pad; e += kThreads) {
      const int row = e / pad, d = D + (e - row * pad);
      reinterpret_cast<unsigned short*>(ring + row * rs)[d] = 0;
    }
  }

  // Member tile copy: thread tid moves chunks c = tid, tid + 256, ... of
  // the tile's kBlockLanes * cpr chunks of `vec` bytes (row r = c / cpr,
  // chunk k = c % cpr), walked without dividing in the loop.
  const int row_bytes = 2 * D;
  const int cpr = row_bytes / vec;
  const int n_chunks = kBlockLanes * cpr;
  const int dr = kThreads / cpr, dk = kThreads % cpr;
  const int r_first = tid / cpr, k_first = tid - r_first * cpr;
  const char* vb = reinterpret_cast<const char*>(v);

  auto load_tile = [&](int i) {           // member a_begin + i -> slot i % S
    const long long t0 = t_first + (long long)i * kLanes;
    unsigned char* dst_tile = ring + (i % stages) * tile_bytes;
    const uint32_t dst0 = smem_addr(dst_tile);
    int r = r_first, k = k_first;
    for (int c = tid; c < n_chunks; c += kThreads) {
      const bool ok = t0 + r < I;
      const char* src = ok ? vb + (t0 + r) * row_bytes + k * vec : vb;
      const uint32_t dst = dst0 + r * rs + k * vec;
      if (vec == 16) {
        cp_async<16>(dst, src, ok ? 16 : 0);
      } else if (vec == 8) {
        cp_async<8>(dst, src, ok ? 8 : 0);
      } else if (vec == 4) {
        cp_async<4>(dst, src, ok ? 4 : 0);
      } else {        // rows or table only 2-byte aligned: plain loads
        *reinterpret_cast<unsigned short*>(dst_tile + r * rs + k * 2) =
            ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
      }
      r += dr;
      k += dk;
      if (k >= cpr) {
        k -= cpr;
        ++r;
      }
    }
    if (tid < kBlockLanes) {
      const bool ok = bias != nullptr && t0 + tid < I;
      cp_async<4>(smem_addr(bias_s + (i % stages) * kBlockLanes + tid),
                  ok ? static_cast<const void*>(bias + t0 + tid) : vb,
                  ok ? 4 : 0);
    }
  };

  float v1[kNT][4], v2[kNT][4];
  int c1[kNT][4], c2[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v1[n][q] = -CUDART_INF_F;
      v2[n][q] = -CUDART_INF_F;
      c1[n][q] = a_begin;
      c2[n][q] = a_begin;
    }

  // ldmatrix row addresses. A (users x d, row-major): lane l gives row
  // l % 16 at column (l / 16) * 8, so matrices 0..3 are a0..a3 of
  // m16n8k16. B (lanes x d, the "col" operand as stored): lane l gives
  // lane row (l / 16) * 8 + l % 8 at column ((l / 8) & 1) * 8, so one x4
  // load is (b0, b1) of two neighbouring n8 tiles.
  const uint32_t a_addr =
      smem_addr(u_s) + (16 * wu + (lane & 15)) * rs + (lane >> 4) * 16;
  const uint32_t b_off =
      (32 * wl + (lane >> 4) * 8 + (lane & 7)) * rs + ((lane >> 3) & 1) * 16;
  const uint32_t ring_addr = smem_addr(ring);
  const int k_steps = Dp / 16;

  // Prologue: stages - 1 tiles in flight (a group per slot, empty or not,
  // so that the group count of every iteration is the same).
  for (int i = 0; i < stages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait(stages - 2);   // tile i has landed (this thread's part)
    __syncthreads();             // ... everyone's; slot (i - 1) % S is free
    if (i + stages - 1 < n_tiles) load_tile(i + stages - 1);
    cp_async_commit();

    const int slot = i % stages;
    const uint32_t b_addr = ring_addr + slot * tile_bytes + b_off;
    float acc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;
    for (int ks = 0; ks < k_steps; ++ks) {
      uint32_t a0, a1, a2, a3;
      ldmatrix_x4(a_addr + ks * 32, a0, a1, a2, a3);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b_addr + np * 16 * rs + ks * 32, b0, b1, b2, b3);
        mma_bf16(acc[2 * np], a0, a1, a2, a3, b0, b1);
        mma_bf16(acc[2 * np + 1], a0, a1, a2, a3, b2, b3);
      }
    }

    // Epilogue: accumulator (n, q) is user 16*wu + g + 8*(q >> 1), lane
    // 32*wl + 8*n + 2*t4 + (q & 1) of the block.
    const int a = a_begin + i;
    const long long t0 = t_first + (long long)i * kLanes;
    const float* bs = bias_s + slot * kBlockLanes;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = 32 * wl + 8 * n + 2 * t4;
      const float2 bb = *reinterpret_cast<const float2*>(bs + col);
      const bool real0 = t0 + col < I, real1 = t0 + col + 1 < I;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool real = (q & 1) ? real1 : real0;
        const float s = real ? acc[n][q] + ((q & 1) ? bb.y : bb.x) : kPadScore;
        update<TOP2>(s, a, v1[n][q], c1[n][q], v2[n][q], c2[n][q]);
      }
    }
  }
  cp_async_wait(0);   // no copy may outlive the block (empty groups only)

  const long long plane = (long long)z * B * L;
  const long long base0 = j * item_block + lane_base;
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = user0 + 16 * wu + g + 8 * (q >> 1);
      if (b >= B) continue;
      const int col = 32 * wl + 8 * n + 2 * t4 + (q & 1);
      const long long o =
          plane + (long long)b * L + (long long)j * kLanes + lane_base + col;
      const long long base = base0 + col;
      out_v1[o] = v1[n][q];
      out_i1[o] = (int)(base + (long long)c1[n][q] * kLanes);
      if (TOP2) {
        out_v2[o] = v2[n][q];
        out_i2[o] = (int)(base + (long long)c2[n][q] * kLanes);
      }
    }
}

// ------------------------------------------- bf16 route: TMA and wgmma

constexpr int kTmaThreads = 384;   // consumer warpgroups 0, 1; producer 2
constexpr int kWgUsers = 64;       // users of one consumer warpgroup
constexpr int kUnitUsers = 128;    // users of one work unit (two groups)
constexpr int kChunk = 64;         // bf16 columns of one 128-byte row
constexpr int kChunkBytes = 64 * 128;   // [64 rows][128 B], swizzled
constexpr int kMaxTmaStages = 12;
constexpr int kEmptyArrivals = 8;  // one a consumer warp
static_assert(kWgUsers * 2 == kUnitUsers, "two consumer warpgroups");

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// Waits for the phase of `parity` to complete; a wait of more than ~2^32
// clocks (over a second) is a broken pipeline, and traps rather than hangs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (int n = 0;; ++n) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == 0) t0 = clock64();
    else if ((n & 1023) == 0 && clock64() - t0 > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// One box of the table's tensor map: columns c0 .. c0+63 of rows
// r0 .. r0+63 into [64][128 B] at dst, 128-byte swizzled; rows past I and
// columns past D read as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int r0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
        "r"(bar) : "memory");
}

// wgmma descriptor of a K-major operand in [rows][128 B] chunks with the
// 128-byte swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait
// that completes it.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Member tile (items) x user tile, k_steps steps of 16 columns, into d;
// the tiles by their descriptors. A step of 16 columns is 32 bytes along
// a chunk's rows, a chunk kChunkBytes further (descriptor units of 16 B).
__device__ __forceinline__ void mma_member(float (&d)[32], uint64_t a_desc,
                                           uint64_t b_desc, int k_steps) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int kk = 0; kk < k_steps; ++kk) {
    const uint32_t off = (kk >> 2) * (kChunkBytes >> 4) + (kk & 3) * 2;
    wgmma_64x64x16(d, a_desc + off, b_desc + off, kk > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Fragment register i of a thread holds item row r_i = 16*warp + g +
// 8*((i >> 1) & 1) of the lane half and user 8*(i >> 2) + 2*t4 + (i & 1)
// of its warpgroup: two items, so two bias values a member.
template <bool TOP2>
__device__ __forceinline__ void member_epilogue(const float (&acc)[32],
                                                float b0, float b1, int a,
                                                float (&v1)[32], int (&c1)[32],
                                                float (&v2)[32],
                                                int (&c2)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    update<TOP2>(acc[i] + (((i >> 1) & 1) ? b1 : b0), a, v1[i], c1[i], v2[i],
                 c2[i]);
}

// Which block owns member step p of the flattened work: block c takes
// steps [c * T / G, (c + 1) * T / G) of the T = units * bucket steps.
__device__ __forceinline__ int step_owner(long long p, long long T, int G) {
  return (int)(((p + 1) * G - 1) / T);
}

// The pair merge of split states (bucketed_topk.py:170-183): (a1, i1, a2,
// i2) is the earlier members' state, b the later's; the later wins only
// where strictly greater.
template <bool TOP2>
__device__ __forceinline__ void merge_state(float& a1, int& i1, float& a2,
                                            int& i2, float b1, int j1,
                                            float b2, int j2) {
  if (TOP2) {
    const bool take_b = b1 > a1;
    const float lose_v = take_b ? a1 : b1;
    const int lose_c = take_b ? i1 : j1;
    if (take_b) {
      a1 = b1;
      i1 = j1;
    }
    if (b2 > a2) {
      a2 = b2;
      i2 = j2;
    }
    if (lose_v > a2) {
      a2 = lose_v;
      i2 = lose_c;
    }
  } else if (b1 > a1) {
    a1 = b1;
    i1 = j1;
  }
}

// A work unit is (grid block j, lane half h, user group ug of 128):
// unit = (j * 2 + h) * n_ug + ug, so the units that read the same member
// tiles run side by side. Its `bucket` members are its steps; the grid's
// blocks take equal ranges of the units' steps in order (a persistent block
// an SM, rounds full to a step), so a unit may be cut between blocks. A
// block that holds only part of a unit writes its state to its workspace
// slot (2 * block for the part it starts inside a unit, + 1 for the part it
// ends inside one) and counts it in counts[2 * unit + wg], a count a
// thread; the part that completes the count merges the unit's parts in
// member order, writes the outputs and sets the count back to 0 for the
// next launch. Shared memory, from a 1024-byte boundary: the ring of
// `stages` member tiles (chunks x [64 rows][128 B], written by TMA), the two
// consumer warpgroups' user tiles in the same layout, then the full and
// empty barriers of each stage.
template <bool TOP2>
__global__ void __launch_bounds__(kTmaThreads, 1)
bucket_max_wgmma(const __grid_constant__ CUtensorMap v_map,
                 const __nv_bfloat16* __restrict__ u,
                 const float* __restrict__ bias, int B, int I, int D,
                 int u_vec, int chunks, int stages, int bucket, int L,
                 float* __restrict__ out_v1, int* __restrict__ out_i1,
                 float* __restrict__ out_v2, int* __restrict__ out_i2,
                 float* __restrict__ ws_v1, int* __restrict__ ws_i1,
                 float* __restrict__ ws_v2, int* __restrict__ ws_i2,
                 int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int tile_bytes = chunks * kChunkBytes;
  const uint32_t ring = base;
  const uint32_t u_tiles = ring + stages * tile_bytes;
  const uint32_t full = u_tiles + 2 * tile_bytes;
  const uint32_t empty = full + 8 * stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_ug = (B + kUnitUsers - 1) / kUnitUsers;
  const long long item_block = (long long)bucket * kLanes;
  const long long steps = (long long)(L / kLanes) * 2 * n_ug * bucket;
  const int G = gridDim.x;
  const long long first = steps * blockIdx.x / G;
  const long long last = steps * (blockIdx.x + 1) / G;

  if (warp >= 8) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long pos = first; pos < last;) {
        const int unit = (int)(pos / bucket);
        const int a_begin = (int)(pos - (long long)unit * bucket);
        const int a_end = (int)min((long long)bucket, a_begin + last - pos);
        pos += a_end - a_begin;
        const int rest = unit / n_ug;
        const int row0 = (int)((rest >> 1) * item_block) + a_begin * kLanes +
                         (rest & 1) * kBlockLanes;
        for (int m = 0; m < a_end - a_begin; ++m) {
          const uint32_t bar = full + 8 * stage;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(bar, tile_bytes);
          for (int c = 0; c < chunks; ++c)
            tma_load(ring + stage * tile_bytes + c * kChunkBytes, &v_map,
                     c * kChunk, row0 + m * kLanes, bar);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes users 64*wg .. +63 of each unit
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2;
    const int wt = tid & 127;
    const int lane = tid & 31;
    const int w4 = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t u_tile = u_tiles + wg * tile_bytes;
    const uint64_t a_desc0 = sw128_desc(ring);
    const uint64_t b_desc = sw128_desc(u_tile);
    const int k_steps = (D + 15) / 16;
    const int r0 = 16 * w4 + g;           // the thread's item rows r0, r0+8
    const unsigned short* ug16 = reinterpret_cast<const unsigned short*>(u);
    int s_full = 0, s_free = 0;           // next stage to take, to free
    uint32_t phase = 0;                   // of s_full
    float acc0[32], acc1[32];
    float v1[32], v2[32];
    int c1[32], c2[32];

    for (long long pos = first; pos < last;) {
      const int unit = (int)(pos / bucket);
      const int a_begin = (int)(pos - (long long)unit * bucket);
      const int a_end = (int)min((long long)bucket, a_begin + last - pos);
      pos += a_end - a_begin;
      const int n_tiles = a_end - a_begin;
      const int ug = unit % n_ug;
      const int rest = unit / n_ug;
      const int h = rest & 1;
      const int j = rest >> 1;
      const int user0 = ug * kUnitUsers + wg * kWgUsers;
      const long long t_row =
          j * item_block + (long long)a_begin * kLanes + h * kBlockLanes + r0;
      // The user tile: the last unit's products have all read it.
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      {
        unsigned char* us = smem + (u_tile - base);
        const int pieces = 8 * chunks;      // 16-byte pieces a row
        for (int e = wt; e < kWgUsers * pieces; e += 128) {
          const int r = e / pieces, p = e - r * pieces;
          const int b = user0 + r, d0 = 8 * p;
          uint4 x = make_uint4(0, 0, 0, 0);
          if (b < B && d0 < D) {
            const long long at = (long long)b * D + d0;
            if (u_vec) {
              x = *reinterpret_cast<const uint4*>(ug16 + at);
            } else {
              unsigned short h8[8];
#pragma unroll
              for (int q = 0; q < 8; ++q) h8[q] = ug16[at + q];
              x.x = h8[0] | ((uint32_t)h8[1] << 16);
              x.y = h8[2] | ((uint32_t)h8[3] << 16);
              x.z = h8[4] | ((uint32_t)h8[5] << 16);
              x.w = h8[6] | ((uint32_t)h8[7] << 16);
            }
          }
          const int c = p >> 3, k = p & 7;
          *reinterpret_cast<uint4*>(us + c * kChunkBytes + r * 128 +
                                    ((k ^ (r & 7)) << 4)) = x;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

#pragma unroll
      for (int i = 0; i < 32; ++i) {
        v1[i] = -CUDART_INF_F;
        v2[i] = -CUDART_INF_F;
        c1[i] = a_begin;
        c2[i] = a_begin;
      }
      // Bias of member m for the thread's rows r0 and r0 + 8: -1e30 past
      // I, where the zero-filled rows score 0, so every pad scores
      // kPadScore.
      const float* bp = bias ? bias + t_row : nullptr;
      const long long real = (long long)I - t_row;   // rows before I
      // The line of member m + 3 is asked into L1 now, so that the load
      // of a member finishes within one epilogue.
      auto bias_of = [&](int m, float& b0, float& b1) {
        const int o = m * kLanes;
        if (bp && o + 3 * kLanes < real)
          asm volatile("prefetch.global.L1 [%0];\n"
                       ::"l"(bp + o + 3 * kLanes));
        b0 = o < real ? (bp ? __ldg(bp + o) : 0.f) : kPadScore;
        b1 = o + 8 < real ? (bp ? __ldg(bp + o + 8) : 0.f) : kPadScore;
      };
      // Wait for the next member tile and start its products into d.
      auto issue = [&](float (&d)[32]) {
        mbar_wait(full + 8 * s_full, phase);
        mma_member(d, a_desc0 + s_full * (tile_bytes >> 4), b_desc,
                   k_steps);
        if (++s_full == stages) {
          s_full = 0;
          phase ^= 1;
        }
      };
      // Hand the oldest member tile back to the producer: this warp's
      // products on it are complete.
      auto release = [&]() {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s_free);
        if (++s_free == stages) s_free = 0;
      };

      // Products of member m + 1 run while member m's epilogue does; acc0
      // holds the even members, acc1 the odd. A member's bias is loaded
      // after its products are issued: the wgmma fence that starts the
      // next products waits for every load in flight.
      float b0 = 0.f, b1 = 0.f, nb0 = 0.f, nb1 = 0.f;
      if (bp)
        for (int q = 0; q < 3 && q * kLanes < real; ++q)
          asm volatile("prefetch.global.L1 [%0];\n" ::"l"(bp + q * kLanes));
      if (n_tiles > 0) {
        issue(acc0);
        bias_of(0, nb0, nb1);
      }
      int m = 0;
      for (; m + 2 < n_tiles; m += 2) {
        b0 = nb0;
        b1 = nb1;
        issue(acc1);
        bias_of(m + 1, nb0, nb1);
        wgmma_wait<1>();
        fence_acc(acc0);
        release();
        member_epilogue<TOP2>(acc0, b0, b1, a_begin + m, v1, c1, v2, c2);
        b0 = nb0;
        b1 = nb1;
        issue(acc0);
        bias_of(m + 2, nb0, nb1);
        wgmma_wait<1>();
        fence_acc(acc1);
        release();
        member_epilogue<TOP2>(acc1, b0, b1, a_begin + m + 1, v1, c1, v2, c2);
      }
      if (m + 1 < n_tiles) {               // two members left
        b0 = nb0;
        b1 = nb1;
        issue(acc1);
        bias_of(m + 1, nb0, nb1);
        wgmma_wait<1>();
        fence_acc(acc0);
        release();
        member_epilogue<TOP2>(acc0, b0, b1, a_begin + m, v1, c1, v2, c2);
        wgmma_wait<0>();
        fence_acc(acc1);
        release();
        member_epilogue<TOP2>(acc1, nb0, nb1, a_begin + m + 1, v1, c1, v2,
                              c2);
      } else if (m < n_tiles) {            // one
        wgmma_wait<0>();
        fence_acc(acc0);
        release();
        member_epilogue<TOP2>(acc0, nb0, nb1, a_begin + m, v1, c1, v2, c2);
      }

      // Outputs: (value, item id) of each of the thread's 32 entries.
      const long long col0 = (long long)j * kLanes + h * kBlockLanes;
      const long long id0 = j * item_block + h * kBlockLanes;
      auto write_out = [&](bool ids, bool store) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int b = user0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          const int r = r0 + 8 * ((i >> 1) & 1);
          const long long o = (long long)b * L + col0 + r;
          const int id1 =
              ids ? c1[i] : (int)(id0 + r + (long long)c1[i] * kLanes);
          const int id2 =
              ids ? c2[i] : (int)(id0 + r + (long long)c2[i] * kLanes);
          if (store && b < B) {
            out_v1[o] = v1[i];
            out_i1[o] = id1;
            if (TOP2) {
              out_v2[o] = v2[i];
              out_i2[o] = id2;
            }
          }
        }
      };
      if (n_tiles == bucket) {
        write_out(false, true);
      } else {
        // Part of a unit: to the workspace, [slot][entry i][256 threads].
        // Every thread counts itself, so the unit is done at 128 counts a
        // part; the warpgroup that brings it there merges. No register is
        // set on a path some threads skip (that would serialize wgmma).
        const long long u_step = (long long)unit * bucket;
        const long long slot = 2 * blockIdx.x + (a_begin > 0 ? 0 : 1);
        const long long w0 = slot * 32 * 256 + wg * 128 + wt;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = r0 + 8 * ((i >> 1) & 1);
          __stcg(ws_v1 + w0 + i * 256, v1[i]);
          __stcg(ws_i1 + w0 + i * 256,
                 (int)(id0 + r + (long long)c1[i] * kLanes));
          if (TOP2) {
            __stcg(ws_v2 + w0 + i * 256, v2[i]);
            __stcg(ws_i2 + w0 + i * 256,
                   (int)(id0 + r + (long long)c2[i] * kLanes));
          }
        }
        const int c_lo = step_owner(u_step, steps, G);
        const int c_hi = step_owner(u_step + bucket - 1, steps, G);
        __threadfence();
        const int seen = atomicAdd(counts + 2 * unit + wg, 1);
        uint32_t last;
        asm volatile(
            "{\n .reg .pred p, q;\n setp.eq.s32 q, %1, %2;\n"
            " bar.red.or.pred p, %3, 128, q;\n selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(last)
            : "r"(seen), "r"(128 * (c_hi - c_lo + 1) - 1), "r"(1 + wg)
            : "memory");
        __threadfence();
        // Merge the unit's parts in member order; only the last part's
        // warpgroup stores the result (the others' reads may be stale).
        for (int c = c_lo; c <= c_hi; ++c) {
          const long long sl = 2 * c + (steps * c / G > u_step ? 0 : 1);
          const long long w = sl * 32 * 256 + wg * 128 + wt;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float b1 = __ldcg(ws_v1 + w + i * 256);
            const int j1 = __ldcg(ws_i1 + w + i * 256);
            const float b2 = TOP2 ? __ldcg(ws_v2 + w + i * 256) : 0.f;
            const int j2 = TOP2 ? __ldcg(ws_i2 + w + i * 256) : 0;
            if (c == c_lo) {
              v1[i] = b1;
              c1[i] = j1;
              v2[i] = b2;
              c2[i] = j2;
            } else {
              merge_state<TOP2>(v1[i], c1[i], v2[i], c2[i], b1, j1, b2, j2);
            }
          }
        }
        write_out(true, last != 0);
        if (last != 0 && wt == 0) counts[2 * unit + wg] = 0;
      }
    }
  }
}

// ------------------------------------------------------------ merge pass

// Second pass: merge n_split partial [B, L] states in split order
// (`merge_state`).
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
    merge_state<TOP2>(a1, c1, a2, c2, pv1[o], pi1[o],
                      TOP2 ? pv2[o] : 0.f, TOP2 ? pi2[o] : 0);
  }
  v1[idx] = a1;
  i1[idx] = c1;
  if (TOP2) {
    v2[idx] = a2;
    i2[idx] = c2;
  }
}

// Widest copy (16, 8, 4 or 2 bytes) that every row start of v allows.
int copy_width(const void* v, int D) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(v) | (uintptr_t)(2 * D);
  for (int w = 16; w > 2; w >>= 1)
    if (bits % w == 0) return w;
  return 2;
}

template <bool TOP2>
cudaError_t launch(const void* u, const void* v, const float* bias,
                   int is_bf16, int B, int I, int D, int Dp, int stages,
                   int smem, int bucket, int n_split, int L, float* v1,
                   int* i1, float* v2, int* i2, float* pv1, int* pi1,
                   float* pv2, int* pi2, cudaStream_t stream) {
  const int n_j = L / kLanes;
  const int n_ut = (B + kUsers - 1) / kUsers;
  const bool split = n_split > 1;
  float* o_v1 = split ? pv1 : v1;
  int* o_i1 = split ? pi1 : i1;
  float* o_v2 = split ? pv2 : v2;
  int* o_i2 = split ? pi2 : i2;
  cudaError_t err;
  if (is_bf16) {
    if (Dp % 16 != 0 || Dp < D || stages < 2 || stages > kMaxStages)
      return cudaErrorInvalidValue;
    auto kernel = bucket_max_mma<TOP2>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)n_j * n_split * 2 * n_ut;
    kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(u),
        static_cast<const __nv_bfloat16*>(v), bias, B, I, D, Dp,
        copy_width(v, D), stages, bucket, n_split, L, o_v1, o_i1, o_v2, o_i2);
  } else {
    const long long tile = (long long)D * kStride * sizeof(float);
    if (stages < 1 || stages > kMaxStages ||
        smem < tile + stages * (tile + kBlockLanes * (long long)sizeof(float)))
      return cudaErrorInvalidValue;
    auto kernel = bucket_max_f32_kernel<TOP2>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(n_j * 2 * n_split, n_ut);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(u), static_cast<const float*>(v), bias, B,
        I, D, stages, bucket, n_split, L, o_v1, o_i1, o_v2, o_i2);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const long long n = (long long)B * L;
  merge_splits_kernel<TOP2><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      pv1, pi1, pv2, pi2, n_split, n, v1, i1, v2, i2);
  return cudaGetLastError();
}

template <bool TOP2>
cudaError_t launch_tma(const void* u, const float* bias, const CUtensorMap& map,
                       int B, int I, int D, int chunks, int stages, int smem,
                       int grid, int bucket, int L, float* v1, int* i1,
                       float* v2, int* i2, float* ws_v1, int* ws_i1,
                       float* ws_v2, int* ws_i2, int* counts,
                       cudaStream_t stream) {
  const long long steps =
      (long long)(L / kLanes) * 2 * ((B + kUnitUsers - 1) / kUnitUsers) *
      bucket;
  if (D % 8 != 0 || D > 4 * kChunk || chunks != (D + kChunk - 1) / kChunk ||
      stages < 2 || stages > kMaxTmaStages || grid < 1 || grid > steps)
    return cudaErrorInvalidValue;
  const long long need = 1023 + (long long)(stages + 2) * chunks * kChunkBytes
                         + 16 * stages;
  if (smem < need) return cudaErrorInvalidValue;
  auto kernel = bucket_max_wgmma<TOP2>;
  static int smem_set[64] = {};     // per instantiation and device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set[dev] = smem;
  }
  kernel<<<grid, kTmaThreads, smem, stream>>>(
      map, static_cast<const __nv_bfloat16*>(u), bias, B, I, D,
      reinterpret_cast<uintptr_t>(u) % 16 == 0, chunks, stages, bucket, L,
      v1, i1, v2, i2, ws_v1, ws_i1, ws_v2, ws_i2, counts);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// C entry point, bound with ctypes. u [B, D] and v [I, D] share one dtype
// (is_bf16 ? bf16 : f32), row-major; bias [I] f32 or null (zeros). Outputs
// [B, L] with L = 128 * ceil(I / (128 * bucket)); the top-2 outputs and the
// [n_split, B, L] partials may be null when unused. dp, stages and smem
// are the route's launch plan: padded depth, ring slots and dynamic shared
// memory bytes (`bucketed_topk.mma_plan` for bf16; `bucketed_topk.f32_plan`
// for f32, which ignores dp). Returns cudaGetLastError() after the
// launches (0 = success).
extern "C" int openrec_bucket_max(const void* u, const void* v,
                                  const float* bias, int is_bf16, int top2,
                                  int B, int I, int D, int bucket,
                                  int n_split, int L, int dp, int stages,
                                  int smem, float* v1, int* i1, float* v2,
                                  int* i2, float* pv1, int* pi1, float* pv2,
                                  int* pi2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return top2 ? launch<true>(u, v, bias, is_bf16, B, I, D, dp, stages, smem,
                             bucket, n_split, L, v1, i1, v2, i2, pv1, pi1,
                             pv2, pi2, s)
              : launch<false>(u, v, bias, is_bf16, B, I, D, dp, stages, smem,
                              bucket, n_split, L, v1, i1, v2, i2, pv1, pi1,
                              pv2, pi2, s);
}

// The bf16 table v [I, D] (16-byte aligned, D a multiple of 8, at most 256)
// as a TMA map of [64 rows][64 columns] boxes with the 128-byte swizzle;
// out-of-bounds rows and columns read as zeros. Writes the 128-byte map to
// `map` and returns 0, or the driver's error (-1: no driver entry point).
extern "C" int openrec_bucket_max_tma_map(const void* v, int I, int D,
                                          void* map) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap m;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)I};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {kChunk, 64};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      &m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(v), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)r;
  memcpy(map, &m, sizeof m);
  return 0;
}

// K1 / K2 on the TMA route: u [B, D] bf16, the table by its map
// (`openrec_bucket_max_tma_map`), bias [I] f32 or null; outputs as for
// openrec_bucket_max. chunks, stages, smem and grid are
// `bucketed_topk.tma_plan`'s; ws_* are 2 * grid slots of 32 * 256 entries
// each (ws_v2, ws_i2 null for K1) and counts 2 * units ints, zero before
// the first launch (each launch leaves them zero). Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int openrec_bucket_max_tma(const void* u, const float* bias,
                                      const void* map, int top2, int B, int I,
                                      int D, int bucket, int L, int chunks,
                                      int stages, int smem, int grid,
                                      float* v1, int* i1, float* v2, int* i2,
                                      float* ws_v1, int* ws_i1, float* ws_v2,
                                      int* ws_i2, int* counts, void* stream) {
  CUtensorMap m;
  memcpy(&m, map, sizeof m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return top2 ? launch_tma<true>(u, bias, m, B, I, D, chunks, stages, smem,
                                 grid, bucket, L, v1, i1, v2, i2, ws_v1,
                                 ws_i1, ws_v2, ws_i2, counts, s)
              : launch_tma<false>(u, bias, m, B, I, D, chunks, stages, smem,
                                  grid, bucket, L, v1, i1, v2, i2, ws_v1,
                                  ws_i1, ws_v2, ws_i2, counts, s);
}
