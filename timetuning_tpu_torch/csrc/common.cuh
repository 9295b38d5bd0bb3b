// Device code shared by the hand-written Hopper kernels of the port:
// bf16 helpers, warp reductions and the tensor-core GEMM tile that the
// attention-block and MLP-block kernels are built from.
//
// The GEMM tile computes out[M, N] = epilogue(prologue(A)[M, K] @ W[N, K]^T)
// with W in PyTorch's Linear layout ([out, in], row-major). A block owns a
// 128x128 output tile; eight warps each own 64x32 of it as 4x2 WMMA
// 16x16x16 bf16 fragments with f32 accumulation. The K loop walks 32-wide
// tiles of A and W through two shared-memory buffers: each thread issues
// its global loads of the next tile before the products of the current one
// and stores them to the other buffer after, so load latency overlaps the
// tensor-core work (one barrier per K tile).
//
// Prologue (optional): LayerNorm of the A rows in f32, rounded to bf16
// before the product (the rounding point of the plain composition).
// Epilogues: + bias; + bias then exact-erf GELU; + bias + an f32 residual
// add. Every epilogue rounds to bf16 once, at the store.
//
// Preconditions (checked by launch_gemm): K % 32 == 0, N % 8 == 0, 16-byte
// aligned row starts (true for contiguous torch allocations when K and N
// are multiples of 8).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace tt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

constexpr int kGemmBM = 128;            // == kGemmBN: one tile shape for A and W
constexpr int kGemmBN = 128;
constexpr int kGemmBK = 32;
constexpr int kGemmThreads = 256;       // 8 warps: 2 (rows) x 4 (columns)
constexpr int kGemmLd = kGemmBK + 8;    // bf16 elements; 80-byte rows
constexpr int kGemmTile = kGemmBM * kGemmLd;
constexpr int kGemmChunks = kGemmBM * kGemmBK / 8 / kGemmThreads;  // uint4 per thread
constexpr int kGemmEpiLd = 16 + 4;      // f32 staging of one fragment
constexpr int kGemmSmem =
    2 * 2 * kGemmTile * (int)sizeof(bf16) +
    (kGemmThreads / 32) * 16 * kGemmEpiLd * (int)sizeof(float) +
    2 * kGemmBM * (int)sizeof(float);
constexpr float kLnEps = 1e-6f;         // the reference LayerNorm eps
constexpr int kLnChunks = 4;            // LN rows up to 4 * 32 * 8 = 1024 wide

namespace {

template <bool kLN, int kEpi>
__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_bf16_kernel(const bf16* __restrict__ A, const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, const bf16* __restrict__ W,
                 const float* __restrict__ bias, const bf16* __restrict__ R,
                 bf16* __restrict__ out, int M, int N, int K) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  bf16* As = reinterpret_cast<bf16*>(gemm_smem);           // [2][BM][Ld]
  bf16* Bs = As + 2 * kGemmTile;                           // [2][BN][Ld]
  float* Es = reinterpret_cast<float*>(Bs + 2 * kGemmTile);
  float* mu_s = Es + (kGemmThreads / 32) * 16 * kGemmEpiLd;
  float* rs_s = mu_s + kGemmBM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kGemmBM;
  const int n0 = blockIdx.x * kGemmBN;

  if (kLN) {
    // two-pass row statistics in f32, as the plain LayerNorm computes them;
    // a lane's share of the row (<= kLnChunks 16-byte chunks) is loaded at
    // once and kept in registers for the second pass
    for (int r = warp; r < kGemmBM; r += kGemmThreads / 32) {
      const int row = m0 + r;
      float mu = 0.f, rs = 0.f;
      if (row < M) {
        const uint4* xr = reinterpret_cast<const uint4*>(A + (size_t)row * K);
        uint4 xv[kLnChunks];
#pragma unroll
        for (int l = 0; l < kLnChunks; ++l)
          if ((l * 32 + lane) * 8 < K) xv[l] = xr[l * 32 + lane];
        float s = 0.f;
#pragma unroll
        for (int l = 0; l < kLnChunks; ++l)
          if ((l * 32 + lane) * 8 < K) {
            const bf16* e = reinterpret_cast<const bf16*>(&xv[l]);
#pragma unroll
            for (int j = 0; j < 8; ++j) s += __bfloat162float(e[j]);
          }
        mu = warp_sum(s) / K;
        float v = 0.f;
#pragma unroll
        for (int l = 0; l < kLnChunks; ++l)
          if ((l * 32 + lane) * 8 < K) {
            const bf16* e = reinterpret_cast<const bf16*>(&xv[l]);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float d = __bfloat162float(e[j]) - mu;
              v += d * d;
            }
          }
        rs = rsqrtf(warp_sum(v) / K + kLnEps);
      }
      if (lane == 0) {
        mu_s[r] = mu;
        rs_s[r] = rs;
      }
    }
    __syncthreads();
  }

  // this thread's share of one K tile: kGemmChunks 8-element chunks of A
  // and of W (rows past M or N are zero-filled)
  uint4 ra[kGemmChunks], rb[kGemmChunks];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kGemmChunks; ++l) {
      const int i = tid + l * kGemmThreads;
      const int r = i / (kGemmBK / 8);
      const int c = (i % (kGemmBK / 8)) * 8;
      ra[l] = make_uint4(0u, 0u, 0u, 0u);
      rb[l] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        ra[l] = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
      if (n0 + r < N)
        rb[l] = *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + c);
    }
  };
  auto store_tile = [&](int buf, int k0) {
#pragma unroll
    for (int l = 0; l < kGemmChunks; ++l) {
      const int i = tid + l * kGemmThreads;
      const int r = i / (kGemmBK / 8);
      const int c = (i % (kGemmBK / 8)) * 8;
      if (kLN) {
        bf16* e = reinterpret_cast<bf16*>(&ra[l]);
        const float mu = mu_s[r], rs = rs_s[r];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16((__bfloat162float(e[j]) - mu) * rs *
                                      ln_s[k0 + c + j] +
                                  ln_b[k0 + c + j]);
      }
      *reinterpret_cast<uint4*>(As + buf * kGemmTile + r * kGemmLd + c) = ra[l];
      *reinterpret_cast<uint4*>(Bs + buf * kGemmTile + r * kGemmLd + c) = rb[l];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;

  const int n_k = K / kGemmBK;
  load_tile(0);
  store_tile(0, 0);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_k) load_tile((kt + 1) * kGemmBK);
    const bf16* a_t = As + cur * kGemmTile;
    const bf16* b_t = Bs + cur * kGemmTile;
#pragma unroll
    for (int kk = 0; kk < kGemmBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], a_t + (wm + 16 * i) * kGemmLd + kk, kGemmLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], b_t + (wn + 16 * j) * kGemmLd + kk, kGemmLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < n_k) store_tile(cur ^ 1, (kt + 1) * kGemmBK);
    __syncthreads();
  }

  // epilogue, one 16x16 fragment at a time through this warp's staging
  float* es = Es + warp * 16 * kGemmEpiLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(es, acc[i][j], kGemmEpiLd, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = lane; e < 256; e += 32) {
        const int row = m0 + wm + 16 * i + e / 16;
        const int col = n0 + wn + 16 * j + e % 16;
        if (row < M && col < N) {
          float v = es[(e / 16) * kGemmEpiLd + e % 16] + bias[col];
          if (kEpi == kBiasGelu)
            v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
          if (kEpi == kBiasResidual) v += __bfloat162float(R[(size_t)row * N + col]);
          out[(size_t)row * N + col] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
}

}  // namespace

template <bool kLN, int kEpi>
inline cudaError_t launch_gemm(const bf16* A, const float* ln_s,
                               const float* ln_b, const bf16* W,
                               const float* bias, const bf16* R, bf16* out,
                               int M, int N, int K, cudaStream_t stream) {
  if (K % kGemmBK != 0 || N % 8 != 0 || M <= 0 || M > 65535 * kGemmBM ||
      (kLN && K > kLnChunks * 32 * 8))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(gemm_bf16_kernel<kLN, kEpi>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kGemmSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
  gemm_bf16_kernel<kLN, kEpi><<<grid, kGemmThreads, kGemmSmem, stream>>>(
      A, ln_s, ln_b, W, bias, R, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace tt
