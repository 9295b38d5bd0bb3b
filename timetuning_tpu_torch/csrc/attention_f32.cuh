// Device code shared by the f32 variants of the two attention cores (the
// flash kernel, flash_attention.cu, and the whole-sequence kernel, mha.cu) at
// a head width of 64: CUDA-core FMAs in full f32 (no TF32, no split
// precision: an f32 model stays f32), expf, one block of 128 threads per
// 64-query tile of one (batch, head), keys walked in tiles of 64.
//
// What bounds these kernels is the FMA pipe (4 Sq Sk 64 operations against
// 67 TFLOP/s), and what keeps a plain tiled loop far from it is the number
// of shared-memory loads per FMA. So a thread owns 8 rows x 4 columns of a
// tile (of the scores, then of the output) and reads its operands as
// float4: 12 loads feed 128 FMAs. Thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty + 8 i; of the scores it owns keys tx + 16 j (K rows 272 bytes
// apart: 16 lanes' float4 reads take the two wavefronts they must), of the
// output head features 4 tx .. 4 tx + 3 (one float4 of a V row, a coalesced
// store). A score row lives in the 16 lanes of a half warp: the softmax's
// row reductions are four __shfl_xor_sync, the scores stay in registers,
// and only p crosses shared memory on its way to p @ v.
//
// K and V tiles arrive by cp.async (16 bytes a copy, rows past the end
// zero-filled) into two buffers: the next tile's copies are issued before
// the arithmetic of this one.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tt {
namespace f32attn {

constexpr int kDh = 64;
constexpr int kBQ = 64;              // queries per block
constexpr int kBK = 64;              // keys per tile
constexpr int kThreads = 128;
constexpr int kLd = kDh + 4;         // Q, K and P rows: 272 bytes
constexpr int kTile = kBK * kLd;     // floats of a Q, K or P tile
constexpr int kVTile = kBK * kDh;    // V rows are read along the row: no pad
constexpr float kNeg = -1e30f;

// rows [t0, t0 + 64) of a [S, 64] slice with row stride ss into dst (row
// stride ld), 16 bytes a copy, asynchronously; rows at or past S as zeros
__device__ __forceinline__ void load_tile_async(float* dst, int ld, const float* src,
                                                long long ss, int t0, int S, int tid) {
#pragma unroll
  for (int i = tid; i < 64 * (kDh / 4); i += kThreads) {
    const int r = i / (kDh / 4);
    const int c = (i % (kDh / 4)) * 4;
    const bool live = t0 + r < S;
    const float* g = src + (live ? (t0 + r) * ss + c : 0);
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * ld + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(g),
                 "r"(live ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// returns once at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// the same rows, loaded and stored by this thread at once (the Q tile)
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long ss, int t0, int S, int tid) {
  for (int i = tid; i < 64 * (kDh / 4); i += kThreads) {
    const int r = i / (kDh / 4);
    const int c = (i % (kDh / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < S) val = *reinterpret_cast<const float4*>(src + (t0 + r) * ss + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// s[i][j] = scale * dot(Q[ty + 8 i], K[tx + 16 j]); the scale after the product
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const float* Qs,
                                        const float* Ks, float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kDh; d += 4) {
    float4 a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 8 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += a[i].x * b[j].x;
        s[i][j] += a[i].y * b[j].y;
        s[i][j] += a[i].z * b[j].z;
        s[i][j] += a[i].w * b[j].w;
      }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] *= scale;
}

// keys at or beyond `valid` (this thread's column j is key k0 + tx + 16 j)
__device__ __forceinline__ void mask_keys(float (&s)[8][4], int k0, int valid, int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k0 + tx + 16 * j >= valid)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i][j] = kNeg;
}

// over the 16 lanes that hold a score row
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// this thread's p values into the P tile
__device__ __forceinline__ void store_p(float* Ps, const float (&p)[8][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Ps[(ty + 8 * i) * kLd + tx + 16 * j] = p[i][j];
}

// acc[i][c] += sum over the tile's first n_keys keys (a multiple of 4) of
// P[ty + 8 i][key] V[key][4 tx + c]; P rows are ld floats apart
__device__ __forceinline__ void pv_tile(float (&acc)[8][4], const float* Ps, int ld,
                                        const float* Vs, int n_keys, int ty, int tx) {
#pragma unroll 2
  for (int kk = 0; kk < n_keys; kk += 4) {
    float4 p[8], v[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      p[i] = *reinterpret_cast<const float4*>(Ps + (ty + 8 * i) * ld + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = *reinterpret_cast<const float4*>(Vs + (kk + u) * kDh + 4 * tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][0] += p[i].x * v[0].x;
      acc[i][1] += p[i].x * v[0].y;
      acc[i][2] += p[i].x * v[0].z;
      acc[i][3] += p[i].x * v[0].w;
      acc[i][0] += p[i].y * v[1].x;
      acc[i][1] += p[i].y * v[1].y;
      acc[i][2] += p[i].y * v[1].z;
      acc[i][3] += p[i].y * v[1].w;
      acc[i][0] += p[i].z * v[2].x;
      acc[i][1] += p[i].z * v[2].y;
      acc[i][2] += p[i].z * v[2].z;
      acc[i][3] += p[i].z * v[2].w;
      acc[i][0] += p[i].w * v[3].x;
      acc[i][1] += p[i].w * v[3].y;
      acc[i][2] += p[i].w * v[3].z;
      acc[i][3] += p[i].w * v[3].w;
    }
  }
}

// acc[i][:] / div[i] to rows q0 + ty + 8 i (below n_rows) of a [rows, 64]
// slice with row stride `stride`
__device__ __forceinline__ void store_rows(const float (&acc)[8][4], const float (&div)[8],
                                           float* dst, long long stride, int q0,
                                           int n_rows, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty + 8 * i;
    if (r < n_rows)
      *reinterpret_cast<float4*>(dst + r * stride + 4 * tx) =
          make_float4(acc[i][0] / div[i], acc[i][1] / div[i], acc[i][2] / div[i],
                      acc[i][3] / div[i]);
  }
}

}  // namespace f32attn
}  // namespace tt
