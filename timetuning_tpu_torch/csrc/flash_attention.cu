// Exact softmax attention for long sequences, in the online-softmax (flash)
// form:
//   o = softmax(q k^T * scale, keys at or beyond kv_len masked) v
// q [B, H, Sq, 64], k and v [B, H, Sk, 64], o [B, H, Sq, 64], all bf16 or
// all f32, each with its own strides on B, H and S (the 64 head features
// contiguous), so the views that a qkv projection gives are read in place
// and the output is written straight into the merged [B, S, H*64] layout.
//
// Replaces both TPU kernels of timetuning_tpu/ops/flash_attention.py:
// _flash_kernel (:47, K/V of one head resident in VMEM, the key loop inside
// the program) and _flash_kernel_stream (:154, K/V streamed over a grid
// axis, the carry in scratch). A Hopper SM has 227 KB of shared memory, not
// VMEM's megabytes, so this kernel always streams K/V: one block per
// (64-query tile, head, batch), a loop over 64-key tiles staged in shared
// memory, the carry (m, l, acc) in registers.
//
// Per key tile, as the TPU kernels: s = dot(q, k) * scale (the scale after
// the f32 product), s = -1e30 at masked keys, m_new = max(m, rowmax s),
// p = exp(s - m_new), corr = exp(m - m_new), l = l * corr + rowsum p,
// acc = acc * corr + p @ v with p rounded to v's dtype and l summing the
// unrounded p; at the end o = acc / max(l, 1e-20), rounded once. Key tiles
// wholly past kv_len are skipped: there p = 0 and corr = 1, no change.
//
// What bounds it on the card: the two products, 4 * Sq * Sk * 64 FLOPs a
// head (2.5 GFLOP at S = 3,137, ViT-S/8 at 448) against 0.8 MB of q, k and v
// in bf16: far above the ridge, so product rate decides.
//   bf16: WMMA 16x16x16 tensor-core products with f32 accumulation (as the
//   attention-block kernel), 4 warps of 16 query rows. A lane owns one row
//   and 32 of its columns for the softmax and the rescale of acc, which it
//   keeps in registers; p @ v of each tile goes through the warp's rows of
//   the score tile in shared memory, then acc = acc * corr + (p @ v).
//   f32: CUDA-core FMAs in f32 (no TF32: the f32 path is held to the plain
//   f32 composition at f32 tolerance), 256 threads each owning a 4x4 tile of
//   scores and of acc, 4 threads a row for the softmax.
// Dh is fixed at 64 (every ViT-S/B configuration of the repo).
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
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
                  int Sk, int kv_len, float scale, Strides st) {
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
  auto load_tile = [&](bf16* dst, const bf16* src, long long ss, int t0, int S) {
    for (int i = tid; i < 64 * (kDh / 8); i += kBThreads) {
      const int r = i / (kDh / 8);
      const int c = (i % (kDh / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + r < S)
        val = *reinterpret_cast<const uint4*>(src + (t0 + r) * ss + c);
      *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
    }
  };

  load_tile(Qs, qp, st.qs, q0, Sq);

  // row-wise work: lane -> (row warp*16 + lane/2, 32 of the 64 tile columns)
  const int my_row = warp * 16 + (lane >> 1);
  const int half = (lane & 1) * 32;
  float* srow = Ss + my_row * kSLd + half;
  bf16* prow = Ps + my_row * kLd + half;
  float m_run = kNeg, l_run = 0.f;
  float acc[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.f;

  const int n_tiles = (kv_len + kK - 1) / kK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kK;
    __syncthreads();                      // the last tile's K/V reads are done
    load_tile(Ks, kp, st.ks, k0, Sk);
    load_tile(Vs, vp, st.vs, k0, Sk);
    __syncthreads();

    // this warp's raw scores [16 x 64] = Q_w K^T
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(sf[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < kDh; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + warp * 16 * kLd + kk, kLd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, Ks + j * 16 * kLd + kk, kLd);
          wmma::mma_sync(sf[j], a, kf, sf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Ss + warp * 16 * kSLd + j * 16, sf[j], kSLd,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of this lane's 32 columns
    float mx = kNeg;
#pragma unroll
    for (int c = 0; c < 32; ++c)
      if (k0 + half + c < kv_len) mx = fmaxf(mx, srow[c] * scale);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p =
          k0 + half + c < kv_len ? expf(srow[c] * scale - m_new) : 0.f;
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * corr + sum;
    m_run = m_new;
    __syncwarp();

    // p @ v for this warp's rows, through its rows of the score tile
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(pv[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < kK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Ps + warp * 16 * kLd + kk, kLd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, Vs + kk * kLd + j * 16, kLd);
          wmma::mma_sync(pv[j], a, vf, pv[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Ss + warp * 16 * kSLd + j * 16, pv[j], kSLd,
                                wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[c] = acc[c] * corr + srow[c];
    __syncwarp();
  }

  const int row = q0 + my_row;
  if (row < Sq) {
    const float l = fmaxf(l_run, 1e-20f);
    bf16* dst = o + b * st.ob + h * st.oh + row * st.os + half;
#pragma unroll
    for (int c = 0; c < 32; c += 8) {
      uint4 pk;
      bf16* e = reinterpret_cast<bf16*>(&pk);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(acc[c + j] / l);
      *reinterpret_cast<uint4*>(dst + c) = pk;
    }
  }
}

// ----------------------------------------------------------------- f32 --
constexpr int kFThreads = 256;  // 16 x 16 threads, a 4x4 tile each
constexpr int kQLd = kDh + 4;   // Q rows: float4 stores, two rows 4 banks apart
constexpr int kKLd = kDh + 1;   // K rows: 16 rows read at one column, no conflict
constexpr int kVLd = kDh;       // V rows: read along the row
constexpr int kPLd = kK + 1;
constexpr int kFSmem =
    (kQ * kQLd + kK * kKLd + kK * kVLd + kQ * kPLd + 2 * kQ) * (int)sizeof(float);

__global__ void __launch_bounds__(kFThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Sk, int kv_len, float scale, Strides st) {
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                  // [kQ][kQLd]
  float* Ks = Qs + kQ * kQLd;       // [kK][kKLd]
  float* Vs = Ks + kK * kKLd;       // [kK][kVLd]
  float* Ps = Vs + kK * kVLd;       // [kQ][kPLd] scores, then p
  float* corr_s = Ps + kQ * kPLd;   // [kQ]
  float* l_s = corr_s + kQ;         // [kQ]

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
                       int t0, int S) {
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

  load_tile(Qs, kQLd, qp, st.qs, q0, Sq);

  // softmax roles: row sr, columns sc0 .. sc0 + 15
  const int sr = tid >> 2;
  const int sc0 = (tid & 3) * 16;
  float m_run = kNeg, l_run = 0.f;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_tiles = (kv_len + kK - 1) / kK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kK;
    __syncthreads();                      // the last tile's reads are done
    load_tile(Ks, kKLd, kp, st.ks, k0, Sk);
    load_tile(Vs, kVLd, vp, st.vs, k0, Sk);
    __syncthreads();

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
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kPLd + tx + 16 * j] = s[i][j] * scale;
    __syncthreads();

    // online softmax, 4 threads a row (neighbouring lanes)
    {
      float* prow = Ps + sr * kPLd + sc0;
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 16; ++c)
        if (k0 + sc0 + c < kv_len) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float corr = expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = k0 + sc0 + c < kv_len ? expf(prow[c] - m_new) : 0.f;
        sum += p;
        prow[c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if ((tid & 3) == 0) corr_s[sr] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p @ v
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pv[i][j] = 0.f;
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
        for (int j = 0; j < 4; ++j) pv[i][j] += p[i] * vv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = corr_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] * cr + pv[i][j];
    }
  }

  if ((tid & 3) == 0) l_s[sr] = fmaxf(l_run, 1e-20f);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    float* dst = o + b * st.ob + h * st.oh + (q0 + r) * st.os;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[tx + 16 * j] = acc[i][j] / l_s[r];
  }
}

}  // namespace

// q, k, v, o: device pointers of bf16 (is_bf16 = 1) or f32 values; strides
// in elements. 1 <= kv_len <= Sk.
extern "C" int tt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int is_bf16, int B, int H, int Sq,
                                  int Sk, int kv_len, long long qb, long long qh,
                                  long long qs, long long kb, long long kh,
                                  long long ks, long long vb, long long vh,
                                  long long vs, long long ob, long long oh,
                                  long long os, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || Sq <= 0 || Sk <= 0 ||
      kv_len < 1 || kv_len > Sk)
    return (int)cudaErrorInvalidValue;
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Sq + kQ - 1) / kQ, H, B);
  const float scale = 1.f / sqrtf((float)kDh);
  cudaError_t e;
  if (is_bf16) {
    e = cudaFuncSetAttribute(flash_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kBSmem);
    if (e != cudaSuccess) return (int)e;
    flash_bf16_kernel<<<grid, kBThreads, kBSmem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, kv_len,
        scale, st);
  } else {
    e = cudaFuncSetAttribute(flash_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmem);
    if (e != cudaSuccess) return (int)e;
    flash_f32_kernel<<<grid, kFThreads, kFSmem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, kv_len,
        scale, st);
  }
  return (int)cudaGetLastError();
}
