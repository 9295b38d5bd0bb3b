// Device code shared by the f32 variants of the two attention cores (the
// flash kernel, flash_attention.cu, and the whole-sequence kernel, mha.cu) at
// a head width Dh of 64 or 32 (a template parameter): CUDA-core FMAs in full
// f32 (no TF32, no split precision: an f32 model stays f32), expf, one block
// of 128 threads per 64-query tile of one (batch, head), keys walked in tiles
// of 64.
//
// What bounds these kernels is the FMA pipe (4 Sq Sk Dh operations against
// 67 TFLOP/s), and what keeps a plain tiled loop far from it is the number
// of shared-memory loads per FMA. So a thread owns 8 rows x 4 columns of the
// scores and 8 rows x Dh / 16 columns of the output, and reads its operands
// as float4 (float2 for a V row of a 32-wide head): at Dh = 64, 12 loads
// feed 128 FMAs. Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 8 i;
// of the scores it owns keys tx + 16 j (Q and K rows Dh + 4 floats apart:
// 16 lanes' float4 reads take the two wavefronts they must), of the output
// head features Dh / 16 tx .. + Dh / 16 - 1 (a coalesced store). A score row
// lives in the 16 lanes of a half warp: the softmax's row reductions are
// four __shfl_xor_sync, the scores stay in registers, and only p crosses
// shared memory on its way to p @ v, in rows of the 64 keys of a tile (+ 4
// floats) whatever Dh is.
//
// K and V tiles arrive by cp.async (16 bytes a copy, rows past the end
// zero-filled) into two buffers: the next tile's copies are issued before
// the arithmetic of this one.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tt {
namespace f32attn {

constexpr int kBQ = 64;              // queries per block
constexpr int kBK = 64;              // keys per tile
constexpr int kThreads = 128;
constexpr int kLdP = kBK + 4;        // P rows: 272 bytes
constexpr int kPTile = kBQ * kLdP;   // floats of the P tile
constexpr float kNeg = -1e30f;

// the tiles of a head width Dh: Q and K rows padded by 4 floats, V rows not
// (they are read along the row)
template <int Dh>
struct Tiles {
  static_assert(Dh == 32 || Dh == 64, "heads of 32 or 64 floats");
  static constexpr int kLd = Dh + 4;
  static constexpr int kTile = kBK * kLd;     // floats of a Q or K tile
  static constexpr int kVTile = kBK * Dh;     // floats of a V tile
  static constexpr int kCols = Dh / 16;       // output columns a thread
};

// a thread's C consecutive floats (16- or 8-byte aligned)
__device__ __forceinline__ void load_cols(float (&d)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  d[0] = t.x;
  d[1] = t.y;
  d[2] = t.z;
  d[3] = t.w;
}
__device__ __forceinline__ void load_cols(float (&d)[2], const float* p) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  d[0] = t.x;
  d[1] = t.y;
}
__device__ __forceinline__ void store_cols(float* p, const float (&d)[4], float div) {
  *reinterpret_cast<float4*>(p) =
      make_float4(d[0] / div, d[1] / div, d[2] / div, d[3] / div);
}
__device__ __forceinline__ void store_cols(float* p, const float (&d)[2], float div) {
  *reinterpret_cast<float2*>(p) = make_float2(d[0] / div, d[1] / div);
}

// rows [t0, t0 + 64) of a [S, Dh] slice with row stride ss into dst (row
// stride ld), 16 bytes a copy, asynchronously; rows at or past S as zeros
template <int Dh>
__device__ __forceinline__ void load_tile_async(float* dst, int ld, const float* src,
                                                long long ss, int t0, int S, int tid) {
#pragma unroll
  for (int i = tid; i < 64 * (Dh / 4); i += kThreads) {
    const int r = i / (Dh / 4);
    const int c = (i % (Dh / 4)) * 4;
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
template <int Dh>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long ss, int t0, int S, int tid) {
  for (int i = tid; i < 64 * (Dh / 4); i += kThreads) {
    const int r = i / (Dh / 4);
    const int c = (i % (Dh / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < S) val = *reinterpret_cast<const float4*>(src + (t0 + r) * ss + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// s[i][j] = scale * dot(Q[ty + 8 i], K[tx + 16 j]); the scale after the product
template <int Dh>
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const float* Qs,
                                        const float* Ks, float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  constexpr int kLd = Tiles<Dh>::kLd;
#pragma unroll 4
  for (int d = 0; d < Dh; d += 4) {
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
    for (int j = 0; j < 4; ++j) Ps[(ty + 8 * i) * kLdP + tx + 16 * j] = p[i][j];
}

// acc[i][c] += sum over the tile's first n_keys keys (a multiple of 4) of
// P[ty + 8 i][key] V[key][Dh / 16 tx + c]; P rows are ld floats apart
template <int Dh>
__device__ __forceinline__ void pv_tile(float (&acc)[8][Dh / 16], const float* Ps,
                                        int ld, const float* Vs, int n_keys, int ty,
                                        int tx) {
  constexpr int C = Dh / 16;
#pragma unroll 2
  for (int kk = 0; kk < n_keys; kk += 4) {
    float4 p[8];
    float v[4][C];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      p[i] = *reinterpret_cast<const float4*>(Ps + (ty + 8 * i) * ld + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) load_cols(v[u], Vs + (kk + u) * Dh + C * tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float pu[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] += pu[u] * v[u][c];
    }
  }
}

// acc[i][:] / div[i] to rows q0 + ty + 8 i (below n_rows) of a [rows, Dh]
// slice with row stride `stride`
template <int Dh>
__device__ __forceinline__ void store_rows(const float (&acc)[8][Dh / 16],
                                           const float (&div)[8], float* dst,
                                           long long stride, int q0, int n_rows,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty + 8 * i;
    if (r < n_rows) store_cols(dst + r * stride + Dh / 16 * tx, acc[i], div[i]);
  }
}

}  // namespace f32attn
}  // namespace tt
