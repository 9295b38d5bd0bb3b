// Whole-sequence multi-head softmax attention, forward:
//   o = softmax(q k^T * scale) v          per (batch, head)
// q, k, v, o [B, H, S, 64], all bf16 or all f32, S <= 1024, each with its
// own strides on B, H and S (the 64 head features contiguous), so the q, k, v
// views of a qkv projection are read in place and the output lands in the
// merged [B, S, H*64] layout.
//
// Replaces the TPU kernel timetuning_tpu/ops/attention.py:_mha_kernel (:53,
// reached through attention_pallas / _attention_fused), which holds the
// whole [S, S] score tile of a block of (batch, head) pairs in VMEM, with S
// padded to 128 lanes and the head width 64 padded to 128. None of that
// padding is carried over: the ragged S (197 tokens at ViT-S/16, 224 px) is
// masked inside the block and nothing is copied.
//
// Arithmetic, as the TPU kernel: s = dot(q, k) * scale in f32, the softmax
// normalised (p = exp(s - rowmax) / rowsum) BEFORE the second product, p
// rounded to v's dtype, p @ v accumulated in f32, o rounded once. This is
// not the flash form (acc * corr + p v with one division at the end): the
// rounding of p happens on normalised probabilities.
//
// What bounds it on the card: at the train step's shape (128 frames x 6
// heads, S = 197) the two products are ~7.6 GFLOP against ~77 MB of q, k, v
// and o in bf16, so device memory bounds it (bytes / 3.35 TB/s), not the
// tensor cores. The design is the simple one: one block per (64-query tile,
// head, batch) that walks the keys in 64-row tiles twice, first for each
// row's max and sum, then for p and p @ v; a [64, S] score strip never has
// to fit in shared memory, and S up to 1024 costs nothing extra. K is read
// twice and V once per query tile (4 query tiles at S = 197), which the L2
// cache serves; the kernel's time against its byte bound says what that
// costs.
//   bf16: WMMA 16x16x16 tensor-core products, f32 accumulation, 4 warps of
//   16 query rows; the same two-pass core as the attention-block kernel
//   (attention_block.cu), on strided [B, H, S, 64] views instead of a packed
//   qkv buffer.
//   f32: CUDA-core FMAs (no TF32, so an f32 model stays f32), 256 threads
//   each owning a 4x4 tile of scores and of the output.
// Dh is fixed at 64 (every ViT of the repo).
#include "common.cuh"

namespace {

using tt::bf16;

constexpr int kDh = 64;
constexpr int kQ = 64;         // queries per block
constexpr int kK = 64;         // keys per tile
constexpr float kNeg = -1e30f;

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// ---------------------------------------------------------------- bf16 --
constexpr int kBThreads = 128;  // 4 warps x 16 query rows
constexpr int kLd = kDh + 8;    // bf16 tile row (144 bytes)
constexpr int kSLd = kK + 4;    // f32 score row
constexpr int kBSmem =
    (2 * kQ + 2 * kK) * kLd * (int)sizeof(bf16) + kQ * kSLd * (int)sizeof(float);

__global__ void __launch_bounds__(kBThreads)
mha_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                float scale, Strides st) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kQ * kLd;
  bf16* Vs = Ks + kK * kLd;
  bf16* Ps = Vs + kK * kLd;
  float* Ss = reinterpret_cast<float*>(Ps + kQ * kLd);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* kp = k + b * st.kb + h * st.kh;
  const bf16* vp = v + b * st.vb + h * st.vh;

  // [64 rows x 64] starting at row t0 of a [S, 64] slice with row stride
  // ss; rows past S are zero-filled
  auto load_tile = [&](bf16* dst, const bf16* src, long long ss, int t0) {
    for (int i = tid; i < 64 * (kDh / 8); i += kBThreads) {
      const int r = i / (kDh / 8);
      const int c = (i % (kDh / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + r < S)
        val = *reinterpret_cast<const uint4*>(src + (t0 + r) * ss + c);
      *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
    }
  };

  // this warp's raw scores [16 x 64] = Q_w K^T into Ss
  auto scores = [&]() {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < kDh; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + warp * 16 * kLd + kk, kLd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + j * 16 * kLd + kk, kLd);
        wmma::mma_sync(acc[j], a, kf, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Ss + warp * 16 * kSLd + j * 16, acc[j], kSLd,
                              wmma::mem_row_major);
    __syncwarp();
  };

  load_tile(Qs, qp, st.qs, q0);

  // row-wise work: lane -> (row warp*16 + lane/2, 32 of the 64 tile columns)
  const int my_row = warp * 16 + (lane >> 1);
  const int half = (lane & 1) * 32;
  const float* srow = Ss + my_row * kSLd + half;
  const int n_tiles = (S + kK - 1) / kK;

  // pass 1: each row's max and softmax denominator
  float m_run = kNeg, l_run = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kK;
    __syncthreads();
    load_tile(Ks, kp, st.ks, k0);
    __syncthreads();
    scores();
    float mx = kNeg;
    for (int c = 0; c < 32; ++c)
      if (k0 + half + c < S) mx = fmaxf(mx, srow[c] * scale);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
    for (int c = 0; c < 32; ++c)
      if (k0 + half + c < S) sum += expf(srow[c] * scale - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * expf(m_run - m_new) + sum;
    m_run = m_new;
    __syncwarp();
  }

  // pass 2: p = exp(s - max) / sum rounded to bf16, o += p @ v
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(of[j], 0.f);
  bf16* prow = Ps + my_row * kLd + half;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kK;
    __syncthreads();
    load_tile(Ks, kp, st.ks, k0);
    load_tile(Vs, vp, st.vs, k0);
    __syncthreads();
    scores();
    for (int c = 0; c < 32; ++c) {
      const float p =
          (k0 + half + c < S) ? expf(srow[c] * scale - m_run) / l_run : 0.f;
      prow[c] = __float2bfloat16(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Ps + warp * 16 * kLd + kk, kLd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + kk * kLd + j * 16, kLd);
        wmma::mma_sync(of[j], a, vf, of[j]);
      }
    }
    __syncwarp();
  }

  // this warp's [16 x 64] output through its rows of the score tile
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(Ss + warp * 16 * kSLd + j * 16, of[j], kSLd,
                            wmma::mem_row_major);
  __syncwarp();
  const int row = q0 + my_row;
  if (row < S) {
    bf16* dst = o + b * st.ob + h * st.oh + row * st.os + half;
#pragma unroll
    for (int c = 0; c < 32; c += 8) {
      uint4 pk;
      bf16* e = reinterpret_cast<bf16*>(&pk);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(srow[c + j]);
      *reinterpret_cast<uint4*>(dst + c) = pk;
    }
  }
}

// ----------------------------------------------------------------- f32 --
constexpr int kFThreads = 256;  // 16 x 16 threads, a 4x4 tile each
constexpr int kQLd = kDh + 4;   // Q rows: two rows 4 banks apart
constexpr int kKLd = kDh + 1;   // K rows: 16 rows read at one column, no conflict
constexpr int kVLd = kDh;       // V rows: read along the row
constexpr int kPLd = kK + 1;
constexpr int kFSmem =
    (kQ * kQLd + kK * kKLd + kK * kVLd + kQ * kPLd) * (int)sizeof(float);

__global__ void __launch_bounds__(kFThreads)
mha_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int S,
               float scale, Strides st) {
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                  // [kQ][kQLd]
  float* Ks = Qs + kQ * kQLd;       // [kK][kKLd]
  float* Vs = Ks + kK * kKLd;       // [kK][kVLd]
  float* Ps = Vs + kK * kVLd;       // [kQ][kPLd] scores, then p

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;          // rows ty + 16 i
  const int tx = tid & 15;          // columns tx + 16 j
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;

  auto load_tile = [&](float* dst, int ld, const float* src, long long ss,
                       int t0) {
    for (int i = tid; i < 64 * (kDh / 4); i += kFThreads) {
      const int r = i / (kDh / 4);
      const int c = (i % (kDh / 4)) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t0 + r < S) val = *reinterpret_cast<const float4*>(src + (t0 + r) * ss + c);
      float* d = dst + r * ld + c;
      d[0] = val.x;
      d[1] = val.y;
      d[2] = val.z;
      d[3] = val.w;
    }
  };

  // the scaled scores of the staged key tile into Ps
  auto scores = [&]() {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kDh; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * kQLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * kKLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * kk[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * kPLd + tx + 16 * j] = s[i][j] * scale;
  };

  load_tile(Qs, kQLd, qp, st.qs, q0);

  // softmax roles: row sr, columns sc0 .. sc0 + 15 (4 neighbouring lanes a row)
  const int sr = tid >> 2;
  const int sc0 = (tid & 3) * 16;
  float* prow = Ps + sr * kPLd + sc0;
  const int n_tiles = (S + kK - 1) / kK;

  // pass 1: each row's max and softmax denominator
  float m_run = kNeg, l_run = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kK;
    __syncthreads();                      // the last tile's reads are done
    load_tile(Ks, kKLd, kp, st.ks, k0);
    __syncthreads();
    scores();
    __syncthreads();
    float mx = kNeg;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      if (k0 + sc0 + c < S) mx = fmaxf(mx, prow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      if (k0 + sc0 + c < S) sum += expf(prow[c] - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * expf(m_run - m_new) + sum;
    m_run = m_new;
  }

  // pass 2: p = exp(s - max) / sum, acc += p @ v
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kK;
    __syncthreads();
    load_tile(Ks, kKLd, kp, st.ks, k0);
    load_tile(Vs, kVLd, vp, st.vs, k0);
    __syncthreads();
    scores();
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 16; ++c)
      prow[c] = k0 + sc0 + c < S ? expf(prow[c] - m_run) / l_run : 0.f;
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      float p[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPLd + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[kk * kVLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += p[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    float* dst = o + b * st.ob + h * st.oh + (q0 + r) * st.os;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[tx + 16 * j] = acc[i][j];
  }
}

}  // namespace

// q, k, v, o: device pointers of bf16 (is_bf16 = 1) or f32 values; strides
// in elements. 1 <= S <= 1024.
extern "C" int tt_mha(const void* q, const void* k, const void* v, void* o,
                      int is_bf16, int B, int H, int S, long long qb,
                      long long qh, long long qs, long long kb, long long kh,
                      long long ks, long long vb, long long vh, long long vs,
                      long long ob, long long oh, long long os, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0 || S > 1024)
    return (int)cudaErrorInvalidValue;
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + kQ - 1) / kQ, H, B);
  const float scale = 1.f / sqrtf((float)kDh);
  cudaError_t e;
  if (is_bf16) {
    e = cudaFuncSetAttribute(mha_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kBSmem);
    if (e != cudaSuccess) return (int)e;
    mha_bf16_kernel<<<grid, kBThreads, kBSmem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), S, scale, st);
  } else {
    e = cudaFuncSetAttribute(mha_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmem);
    if (e != cudaSuccess) return (int)e;
    mha_f32_kernel<<<grid, kFThreads, kFSmem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, scale, st);
  }
  return (int)cudaGetLastError();
}
