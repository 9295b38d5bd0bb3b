// Attention residual branch of one ViT block, bf16 in and out:
//   out = x + proj(MHA(qkv(LN1(x))))
//
// Replaces the TPU kernel timetuning_tpu/ops/fused_block.py:_attn_kernel
// (reached through _attn_pallas / attention_block_branch).
//
// What bounds it on the card: the three products. At the eval shape
// (B=50 frames, S=197 tokens, D=384, 6 heads of 64) the QKV and proj GEMMs
// are ~18 GFLOP and the attention core ~2.4 GFLOP per block, against
// ~30 MB of activations: well above the bf16 ridge, so tensor-core rate
// and occupancy decide, not bytes.
//
// Design. The TPU kernel holds a whole [Gb*S, 3D] block in VMEM; a Hopper
// SM has 227 KB of shared memory, so the branch is three launches:
//   (a) LN1-prologue GEMM + bias -> qkv [B*S, 3D] bf16 (common.cuh);
//   (b) attention core: one block per (64-query tile, head, frame), keys in
//       64-row tiles, tensor-core QK^T and PV (WMMA bf16, f32 accumulate).
//       It runs two passes over the keys: the first finds each row's max and
//       softmax denominator, the second forms p = exp(s - max) / sum exactly
//       as the plain softmax does, rounds p to bf16 and accumulates p @ v.
//       The ragged S=197 edge is masked in the block: padded keys get p = 0
//       and their K/V rows are zero-filled.
//   (c) proj GEMM whose epilogue adds bias and the residual in f32.
// bf16 rounding points match the plain composition (attention_block_xla):
// LN output, qkv, p, the per-head output, and the final sum. Dh is fixed at
// 64 (every ViT-S/B configuration of the repo).
#include "common.cuh"

namespace {

using tt::bf16;

constexpr int kQ = 64;         // queries per block
constexpr int kKeys = 64;      // keys per tile
constexpr int kDh = 64;        // head width
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kLd = kDh + 8;   // bf16 tile row (144 bytes)
constexpr int kSLd = kKeys + 4;
constexpr int kSmemBytes =
    4 * kQ * kLd * (int)sizeof(bf16) + kQ * kSLd * (int)sizeof(float);

__global__ void __launch_bounds__(kThreads)
attn_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ merged,
                 int S, int D, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kQ * kLd;
  bf16* Vs = Ks + kKeys * kLd;
  bf16* Ps = Vs + kKeys * kLd;
  float* Ss = reinterpret_cast<float*>(Ps + kQ * kLd);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row_stride = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * S * row_stride;

  // [64 tokens x 64] head slice starting at token t0, column col; rows past
  // the sequence are zero-filled
  auto load_tile = [&](bf16* dst, int t0, int col) {
    for (int i = tid; i < 64 * (kDh / 8); i += kThreads) {
      const int r = i / (kDh / 8);
      const int c = (i % (kDh / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + r < S)
        v = *reinterpret_cast<const uint4*>(base + (size_t)(t0 + r) * row_stride +
                                            col + c);
      *reinterpret_cast<uint4*>(dst + r * kLd + c) = v;
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

  load_tile(Qs, q0, h * kDh);

  // row-wise work: lane -> (row warp*16 + lane/2, 32 of the 64 tile columns)
  const int my_row = warp * 16 + (lane >> 1);
  const int half = (lane & 1) * 32;
  const float* srow = Ss + my_row * kSLd + half;
  const int n_tiles = (S + kKeys - 1) / kKeys;

  // pass 1: running max and denominator
  float m_run = -INFINITY, l_run = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();
    load_tile(Ks, k0, D + h * kDh);
    __syncthreads();
    scores();
    float mx = -INFINITY;
    for (int c = 0; c < 32; ++c)
      if (k0 + half + c < S) mx = fmaxf(mx, srow[c] * scale);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);   // finite: key k0 is always valid
    float sum = 0.f;
    for (int c = 0; c < 32; ++c)
      if (k0 + half + c < S) sum += expf(srow[c] * scale - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * expf(m_run - m_new) + sum;
    m_run = m_new;
    __syncwarp();
  }

  // pass 2: p rounded to bf16, o += p @ v
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(o[j], 0.f);
  bf16* prow = Ps + my_row * kLd + half;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();
    load_tile(Ks, k0, D + h * kDh);
    load_tile(Vs, k0, 2 * D + h * kDh);
    __syncthreads();
    scores();
    for (int c = 0; c < 32; ++c) {
      const float p =
          (k0 + half + c < S) ? expf(srow[c] * scale - m_run) / l_run : 0.f;
      prow[c] = __float2bfloat16(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kKeys; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Ps + warp * 16 * kLd + kk, kLd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + kk * kLd + j * 16, kLd);
        wmma::mma_sync(o[j], a, vf, o[j]);
      }
    }
    __syncwarp();
  }

  // the head's output, rounded to bf16, into merged[b, token, h*64:]
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(Ss + warp * 16 * kSLd + j * 16, o[j], kSLd,
                            wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * kDh; i += 32) {
    const int r = i / kDh;
    const int c = i % kDh;
    const int tok = q0 + warp * 16 + r;
    if (tok < S)
      merged[((size_t)b * S + tok) * D + h * kDh + c] =
          __float2bfloat16(Ss[(warp * 16 + r) * kSLd + c]);
  }
}

}  // namespace

extern "C" int tt_attention_block(const void* x, const float* ln_s,
                                  const float* ln_b, const void* w_qkv,
                                  const float* b_qkv, const void* w_proj,
                                  const float* b_proj, void* qkv, void* merged,
                                  void* out, int B, int S, int D, int H,
                                  void* stream) {
  if (H <= 0 || D != H * kDh || S <= 0 || B <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  cudaError_t e = tt::launch_gemm<true, tt::kBias>(
      static_cast<const bf16*>(x), ln_s, ln_b, static_cast<const bf16*>(w_qkv),
      b_qkv, nullptr, static_cast<bf16*>(qkv), M, 3 * D, D, st);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(attn_core_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  attn_core_kernel<<<dim3((S + kQ - 1) / kQ, H, B), kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(merged), S, D,
      1.f / sqrtf((float)kDh));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)tt::launch_gemm<false, tt::kBiasResidual>(
      static_cast<const bf16*>(merged), nullptr, nullptr,
      static_cast<const bf16*>(w_proj), b_proj, static_cast<const bf16*>(x),
      static_cast<bf16*>(out), M, D, D, st);
}

extern "C" const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
