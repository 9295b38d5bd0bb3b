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
// tensor cores; at 8 x 6 x 1,024 the products and the softmax's
// exponentials (16 a clock an SM) do.
//   bf16, S <= 256 (one pass): a block is one warpgroup and owns one
//   (batch, head). One thread asks TMA for the head's whole Q, K and V
//   (128-byte swizzle, rows past S zero-filled), so each is read from device
//   memory once a head; two or three blocks share an SM, so one block's
//   loads run under another's arithmetic. (With fewer heads than two an SM
//   a block owns one query tile instead and K/V come again from L2.) For
//   each 64-row query tile in turn: the whole score strip [64, N] by wgmma
//   (m64nNk16, N = 64, 128, 208 or 256 keys, chosen by the caller's plan)
//   in registers, exact row max and sum by quad
//   shuffles, p normalised, rounded to bf16 and fed from registers as the A
//   operand of p @ v (m64n64k16, V MN-major). q k^T runs once and nothing
//   but Q, K and V is ever in shared memory, as the TPU kernel keeps its
//   strip in VMEM.
//   bf16, 256 < S <= 1,024 (two passes): a block owns 128 query rows of one
//   (batch, head), 64 a warpgroup; a producer warp asks TMA for Q, for K in
//   128-key chunks that stay resident in shared memory (128 KB at
//   S = 1,024), and for V through a ring of three tiles. Pass 1 walks K for
//   each row's max and sum (online), pass 2 walks the resident K again for
//   p = exp(s - max) / sum and p @ v with V streamed. A [64, 1,024] strip
//   does not fit a warpgroup's registers, so q k^T runs twice; K is fetched
//   once a block.
//   f32: CUDA-core FMAs (no TF32, so an f32 model stays f32) on the tiles
//   of attention_f32.cuh: a block of 128 threads owns 64 query rows, a
//   thread 8 rows x 4 columns of the scores and of the output with float4
//   operand reads; 64-key tiles arrive by cp.async into two buffers. Up to
//   256 tokens one pass: the block's [64, S] scores stay in shared memory
//   (52 KB at S = 197) and q k^T runs once; up to 1,024 two passes (K, then
//   K and V), the row statistics in registers.
// Dh is fixed at 64 (every ViT of the repo). The bf16 core is also the
// attention core of the attention-block kernel (attention_block.cu, through
// mha_core.cuh).
#include "attention_f32.cuh"
#include "attention_wgmma.cuh"
#include "common.cuh"
#include "mha_core.cuh"

namespace {

using tt::bf16;
namespace hp = tt::hopper;

constexpr int kDh = 64;
constexpr float kNeg = -1e30f;

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// ------------------------------------------------------ bf16, one pass --
constexpr int kOneMaxKeys = 256;          // the widest wgmma: the strip's limit
constexpr int kOneThreads = 128;          // one warpgroup

// shared memory of a block that owns q_rows query rows and a strip of `keys`
constexpr int one_pass_smem(int q_rows, int keys) {
  return (q_rows + 2 * keys) * hp::kRowBytes + 2 * 8 + 1024;
}

// N: the key count the strip is padded to; q_rows: the query rows a block
// owns, the rows of the Q box (64 a query tile)
template <int N>
__global__ void __launch_bounds__(kOneThreads, 2)
mha_one_pass_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                    int S, int q_rows, float scale_log2, long long ob, long long oh,
                    long long os) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + q_rows * hp::kRowBytes;
  const uint32_t v_s = k_s + N * hp::kRowBytes;
  const uint32_t bar_qk = v_s + N * hp::kRowBytes;
  const uint32_t bar_v = bar_qk + 8;

  const int b = blockIdx.y;
  const int h = blockIdx.x;
  const int q0 = blockIdx.z * q_rows;
  const int q_end = min(S, q0 + q_rows);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == 0) {
    hp::mbar_init(bar_qk, 1);
    hp::mbar_init(bar_v, 1);
    hp::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    // V on a barrier of its own: q k^T and the softmax start without it
    hp::mbar_arrive_expect_tx(bar_qk, (q_rows + N) * hp::kRowBytes);
    hp::tma_load(k_s, &map_k, bar_qk, 0, h, b);
    hp::tma_load(q_s, &map_q, bar_qk, q0, h, b);
    hp::mbar_arrive_expect_tx(bar_v, N * hp::kRowBytes);
    hp::tma_load(v_s, &map_v, bar_v, 0, h, b);
  }

  bf16* out = o + b * ob + h * oh;
  hp::mbar_wait(bar_qk, 0);
  for (int t = 0; q0 + t * 64 < q_end; ++t) {
    float sc[N / 2];
    hp::qk_product(sc, q_s + t * 64 * hp::kRowBytes, k_s);
    if (S < N) hp::mask_keys(sc, 0, S, lane);

    float mx0, mx1, sum0, sum1;
    hp::row_max(sc, mx0, mx1);
    hp::exp_rows(sc, scale_log2, mx0 * scale_log2, mx1 * scale_log2, sum0, sum1);
    sum0 = hp::quad_sum(sum0);
    sum1 = hp::quad_sum(sum1);
    uint32_t pa[N / 4];
    hp::pack_rows(sc, 1.f / sum0, 1.f / sum1, pa);

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    hp::mbar_wait(bar_v, 0);
    hp::pv_product<N / 16>(acc, pa, v_s, false);
    hp::store_rows(acc, 1.f, 1.f, out, os,
                   q0 + t * 64 + warp * 16 + (lane >> 2), S, lane);
  }
}

// ---------------------------------------------------- bf16, two passes --
constexpr int kTwoQ = 128;                // queries per block, 64 a warpgroup
constexpr int kTwoK = 128;                // keys per chunk
constexpr int kTwoMaxChunks = 8;          // S <= 1,024
constexpr int kTwoStages = 3;             // V tiles in flight
constexpr int kTwoConsumerWarps = 8;
constexpr int kTwoThreads = (kTwoConsumerWarps + 1) * 32;
constexpr int kTwoQBytes = kTwoQ * hp::kRowBytes;
constexpr int kTwoChunkBytes = kTwoK * hp::kRowBytes;
constexpr int kTwoBarOffset =
    kTwoQBytes + (kTwoMaxChunks + kTwoStages) * kTwoChunkBytes;
constexpr int kTwoBars = 1 + kTwoMaxChunks + 2 * kTwoStages;

__global__ void __launch_bounds__(kTwoThreads, 1)
mha_two_pass_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                    int S, float scale_log2, long long ob, long long oh,
                    long long os) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + kTwoQBytes;                      // [n_chunks] resident
  const uint32_t v_s = k_s + kTwoMaxChunks * kTwoChunkBytes;   // [kTwoStages] ring
  const uint32_t bar_q = base + kTwoBarOffset;
  const uint32_t bar_k = bar_q + 8;                            // [kTwoMaxChunks], used once
  const uint32_t bar_full = bar_k + 8 * kTwoMaxChunks;         // [kTwoStages]
  const uint32_t bar_empty = bar_full + 8 * kTwoStages;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kTwoQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_chunks = (S + kTwoK - 1) / kTwoK;

  if (tid == 0) {
    hp::mbar_init(bar_q, 1);
    for (int c = 0; c < kTwoMaxChunks; ++c) hp::mbar_init(bar_k + 8 * c, 1);
    for (int s = 0; s < kTwoStages; ++s) {
      hp::mbar_init(bar_full + 8 * s, 1);
      hp::mbar_init(bar_empty + 8 * s, kTwoConsumerWarps);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kTwoConsumerWarps) {
    if (lane == 0) {
      hp::mbar_arrive_expect_tx(bar_q, kTwoQBytes);
      hp::tma_load(q_s, &map_q, bar_q, q0, h, b);
      for (int c = 0; c < n_chunks; ++c) {
        hp::mbar_arrive_expect_tx(bar_k + 8 * c, kTwoChunkBytes);
        hp::tma_load(k_s + c * kTwoChunkBytes, &map_k, bar_k + 8 * c, c * kTwoK, h, b);
      }
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % kTwoStages;
        const uint32_t round = (c / kTwoStages) & 1;
        hp::mbar_wait(bar_empty + 8 * s, round ^ 1);   // passes at once in round 0
        hp::mbar_arrive_expect_tx(bar_full + 8 * s, kTwoChunkBytes);
        hp::tma_load(v_s + s * kTwoChunkBytes, &map_v, bar_full + 8 * s, c * kTwoK, h, b);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const uint32_t q_wg = q_s + wg * 64 * hp::kRowBytes;
  const bool ragged = S % kTwoK != 0;
  hp::mbar_wait(bar_q, 0);

  // pass 1: each row's max (log2 units) and softmax denominator
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    hp::mbar_wait(bar_k + 8 * c, 0);
    float sc[kTwoK / 2];
    hp::qk_product(sc, q_wg, k_s + c * kTwoChunkBytes);
    if (ragged && c == n_chunks - 1) hp::mask_keys(sc, c * kTwoK, S, lane);
    float mx0, mx1, sum0, sum1;
    hp::row_max(sc, mx0, mx1);
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    hp::exp_rows(sc, scale_log2, mn0, mn1, sum0, sum1);
    l0 = l0 * hp::fast_exp2(m0 - mn0) + sum0;
    l1 = l1 * hp::fast_exp2(m1 - mn1) + sum1;
    m0 = mn0;
    m1 = mn1;
  }
  const float inv0 = 1.f / hp::quad_sum(l0);
  const float inv1 = 1.f / hp::quad_sum(l1);

  // pass 2: p = exp(s - max) / sum rounded to bf16, acc += p @ v; K's
  // barriers have completed their only phase, so the waits pass at once
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kTwoStages;
    const uint32_t round = (c / kTwoStages) & 1;
    float sc[kTwoK / 2];
    hp::qk_product(sc, q_wg, k_s + c * kTwoChunkBytes);
    if (ragged && c == n_chunks - 1) hp::mask_keys(sc, c * kTwoK, S, lane);
    float sum0, sum1;
    hp::exp_rows(sc, scale_log2, m0, m1, sum0, sum1);
    uint32_t pa[kTwoK / 4];
    hp::pack_rows(sc, inv0, inv1, pa);
    hp::mbar_wait(bar_full + 8 * s, round);
    hp::pv_product<kTwoK / 16>(acc, pa, v_s + s * kTwoChunkBytes, true);
    if (lane == 0) hp::mbar_arrive(bar_empty + 8 * s);   // this warp's reads are done
  }
  hp::store_rows(acc, 1.f, 1.f, o + b * ob + h * oh, os,
                 q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2), S, lane);
}

template <int N>
cudaError_t launch_one_pass(const CUtensorMap& mq, const CUtensorMap& mk,
                            const CUtensorMap& mv, bf16* o, int B, int H, int S,
                            int q_rows, float scale_log2, long long ob,
                            long long oh, long long os, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      mha_one_pass_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      one_pass_smem(kOneMaxKeys, N));
  if (e != cudaSuccess) return e;
  mha_one_pass_kernel<N><<<dim3(H, B, (S + q_rows - 1) / q_rows), kOneThreads,
                           one_pass_smem(q_rows, N), s>>>(
      mq, mk, mv, o, S, q_rows, scale_log2, ob, oh, os);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 --
namespace f32 = tt::f32attn;
constexpr int kFSmem =
    (4 * f32::kTile + 2 * f32::kVTile) * (int)sizeof(float);   // Q, 2 K, P; 2 V

// S <= 256: one pass. The block's [64, S] strip of scaled scores stays in
// shared memory (rows of S rounded up to 4, plus 4: 52 KB at S = 197, two
// blocks an SM), so q k^T runs once: pass 1 writes the strip and finds each
// row's max; every thread then turns its own entries into exp(s - max),
// sums them, and divides them by the row's sum; p @ v reads the strip. K
// tiles, then V tiles, arrive through the same two buffers.
constexpr int kStripMaxKeys = 256;
__host__ __device__ constexpr int strip_ld(int S) { return (S + 3) / 4 * 4 + 4; }
constexpr int strip_smem(int S) {
  return (3 * f32::kTile + f32::kBQ * strip_ld(S)) * (int)sizeof(float);
}

__global__ void __launch_bounds__(f32::kThreads, 2)
mha_f32_strip_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int S,
                     float scale, Strides st) {
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                       // [64][kLd]
  float* KVs = Qs + f32::kTile;          // [2][64][kLd] for K, [64][64] of each for V
  float* Ss = KVs + 2 * f32::kTile;      // [64][ld]: scores, then p

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * f32::kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;               // rows ty + 8 i
  const int tx = tid & 15;               // keys tx + 16 j, head features 4 tx + c
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  const int n_tiles = (S + f32::kBK - 1) / f32::kBK;
  const int ld = strip_ld(S);
  const int cols = ld - 4;               // S rounded up to 4: the strip's live width

  f32::load_tile_async(KVs, f32::kLd, kp, st.ks, 0, S, tid);
  f32::async_commit();
  f32::load_tile(Qs, f32::kLd, qp, st.qs, q0, S, tid);

  // pass 1: the scaled scores into the strip (-1e30 at keys past S), and
  // this lane's share of each row's max
  float m_row[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m_row[i] = kNeg;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * f32::kBK;
    const int buf = kt & 1;
    f32::async_wait<0>();
    __syncthreads();                     // tile kt landed; the other buffer is free
    if (kt + 1 < n_tiles) {
      f32::load_tile_async(KVs + (buf ^ 1) * f32::kTile, f32::kLd, kp, st.ks,
                           k0 + f32::kBK, S, tid);
      f32::async_commit();
    }
    float s[8][4];
    f32::qk_tile(s, Qs, KVs + buf * f32::kTile, scale, ty, tx);
    if (k0 + f32::kBK > S) f32::mask_keys(s, k0, S, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx + 16 * j;
      if (c < cols)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          Ss[(ty + 8 * i) * ld + c] = s[i][j];
          m_row[i] = fmaxf(m_row[i], s[i][j]);
        }
    }
  }
  __syncthreads();                       // pass 1's reads of both K buffers are done
  f32::load_tile_async(KVs, f32::kDh, vp, st.vs, 0, S, tid);
  f32::async_commit();

  // this thread's own entries of the strip: exp(s - max), their sum, p
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float m = f32::row_max16(m_row[i]);
    float* row = Ss + (ty + 8 * i) * ld;
    float sum = 0.f;
    for (int c = tx; c < cols; c += 16) {
      const float e = expf(row[c] - m);  // masked: 0
      row[c] = e;
      sum += e;
    }
    const float l = f32::row_sum16(sum);
    for (int c = tx; c < cols; c += 16) row[c] = row[c] / l;
  }

  // pass 2: acc += p @ v over the strip
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * f32::kBK;
    const int buf = kt & 1;
    f32::async_wait<0>();
    __syncthreads();                     // V tile kt landed; p is whole (kt = 0)
    if (kt + 1 < n_tiles) {
      f32::load_tile_async(KVs + (buf ^ 1) * f32::kTile, f32::kDh, vp, st.vs,
                           k0 + f32::kBK, S, tid);
      f32::async_commit();
    }
    f32::pv_tile(acc, Ss + k0, ld, KVs + buf * f32::kTile, min(f32::kBK, cols - k0),
                 ty, tx);
  }

  float one[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) one[i] = 1.f;
  f32::store_rows(acc, one, o + b * st.ob + h * st.oh, st.os, q0, S, ty, tx);
}

// S <= 1,024: two passes
__global__ void __launch_bounds__(f32::kThreads, 2)
mha_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int S,
               float scale, Strides st) {
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                       // [64][kLd]
  float* Ks = Qs + f32::kTile;           // [2][64][kLd]
  float* Vs = Ks + 2 * f32::kTile;       // [2][64][64]
  float* Ps = Vs + 2 * f32::kVTile;      // [64][kLd]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * f32::kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;               // rows ty + 8 i
  const int tx = tid & 15;               // keys tx + 16 j, head features 4 tx + c
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  const int n_tiles = (S + f32::kBK - 1) / f32::kBK;

  f32::load_tile_async(Ks, f32::kLd, kp, st.ks, 0, S, tid);
  f32::async_commit();
  f32::load_tile(Qs, f32::kLd, qp, st.qs, q0, S, tid);

  // pass 1: each row's max and softmax denominator (this lane's share of it)
  float m_run[8], l_run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = kNeg;
    l_run[i] = 0.f;
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * f32::kBK;
    const int buf = kt & 1;
    f32::async_wait<0>();
    __syncthreads();                     // tile kt landed; the other buffer is free
    if (kt + 1 < n_tiles) {
      f32::load_tile_async(Ks + (buf ^ 1) * f32::kTile, f32::kLd, kp, st.ks,
                           k0 + f32::kBK, S, tid);
      f32::async_commit();
    }
    float s[8][4];
    f32::qk_tile(s, Qs, Ks + buf * f32::kTile, scale, ty, tx);
    if (k0 + f32::kBK > S) f32::mask_keys(s, k0, S, tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float mx = f32::row_max16(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);   // masked: 0
      l_run[i] = l_run[i] * expf(m_run[i] - m_new) + sum;
      m_run[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) l_run[i] = f32::row_sum16(l_run[i]);

  // pass 2: p = exp(s - max) / sum, acc += p @ v
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  __syncthreads();                       // pass 1's reads of both K buffers are done
  f32::load_tile_async(Ks, f32::kLd, kp, st.ks, 0, S, tid);
  f32::load_tile_async(Vs, f32::kDh, vp, st.vs, 0, S, tid);
  f32::async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * f32::kBK;
    const int buf = kt & 1;
    f32::async_wait<0>();
    __syncthreads();                     // and the last tile's reads of P are done
    if (kt + 1 < n_tiles) {
      f32::load_tile_async(Ks + (buf ^ 1) * f32::kTile, f32::kLd, kp, st.ks,
                           k0 + f32::kBK, S, tid);
      f32::load_tile_async(Vs + (buf ^ 1) * f32::kVTile, f32::kDh, vp, st.vs,
                           k0 + f32::kBK, S, tid);
      f32::async_commit();
    }
    float s[8][4];
    f32::qk_tile(s, Qs, Ks + buf * f32::kTile, scale, ty, tx);
    if (k0 + f32::kBK > S) f32::mask_keys(s, k0, S, tx);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = expf(s[i][j] - m_run[i]) / l_run[i];
    f32::store_p(Ps, s, ty, tx);
    __syncthreads();
    f32::pv_tile(acc, Ps, f32::kLd, Vs + buf * f32::kVTile, f32::kBK, ty, tx);
  }

  float one[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) one[i] = 1.f;
  f32::store_rows(acc, one, o + b * st.ob + h * st.oh, st.os, q0, S, ty, tx);
}

}  // namespace

// The bf16 core on strided [B, H, S, 64] views (strides in elements): the
// caller's plan (ops/attention.mha_plan) is checked here, for tt_mha below
// and for the attention-block kernel (attention_block.cu), which runs this
// core on the q, k, v thirds of its qkv rows.
cudaError_t tt::launch_mha_bf16(const void* q, const void* k, const void* v, void* o,
                                int B, int H, int S, int passes, int keys,
                                long long qb, long long qh, long long qs,
                                long long kb, long long kh, long long ks,
                                long long vb, long long vh, long long vs,
                                long long ob, long long oh, long long os,
                                cudaStream_t s) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0 || S > 1024)
    return cudaErrorInvalidValue;
  const float scale_log2 = 1.f / sqrtf((float)kDh) * hp::kLog2e;
  bf16* out = static_cast<bf16*>(o);
  const bool one = passes == 1;
  if (one ? (keys < S || (keys != 64 && keys != 128 && keys != 208 && keys != 256))
          : (passes != 2 || keys != (S + kTwoK - 1) / kTwoK * kTwoK))
    return cudaErrorInvalidValue;
  // one pass: a block owns all query tiles of its head, so K and V are
  // fetched once a head, or one tile, so that the heads' tiles spread over
  // the card (K and V then come again from L2: a tile costs ~1.3 of its
  // share of a head): whichever takes fewer waves of two blocks an SM.
  // 768 heads of 197 tokens stay whole; 300, and anything under two heads
  // an SM, go by tiles
  cudaError_t e;
  int sms = 0, device = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return e;
  const int q_tiles = (S + 63) / 64;
  const long long slots = 2LL * sms;
  const long long whole = ((long long)B * H + slots - 1) / slots * q_tiles * 10;
  const long long tiled = ((long long)B * H * q_tiles + slots - 1) / slots * 13;
  const int q_rows = !one ? kTwoQ : whole <= tiled ? q_tiles * 64 : 64;
  const int kv_rows = one ? keys : kTwoK;
  CUtensorMap mq, mk, mv;
  if ((e = hp::make_qkv_map(&mq, q, B, H, S, qb, qh, qs, q_rows)) != cudaSuccess ||
      (e = hp::make_qkv_map(&mk, k, B, H, S, kb, kh, ks, kv_rows)) != cudaSuccess ||
      (e = hp::make_qkv_map(&mv, v, B, H, S, vb, vh, vs, kv_rows)) != cudaSuccess)
    return e;
  if (one) {
    auto launch = keys == 64 ? launch_one_pass<64>
                  : keys == 128 ? launch_one_pass<128>
                  : keys == 208 ? launch_one_pass<208>
                                : launch_one_pass<256>;
    return launch(mq, mk, mv, out, B, H, S, q_rows, scale_log2, ob, oh, os, s);
  }
  constexpr int smem = kTwoBarOffset + kTwoBars * 8 + 1024;
  e = cudaFuncSetAttribute(mha_two_pass_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  mha_two_pass_kernel<<<dim3((S + kTwoQ - 1) / kTwoQ, H, B), kTwoThreads, smem, s>>>(
      mq, mk, mv, out, S, scale_log2, ob, oh, os);
  return cudaGetLastError();
}

// q, k, v, o: device pointers of bf16 (is_bf16 = 1) or f32 values; strides
// in elements. 1 <= S <= 1024. bf16: `passes` and `keys` are the caller's
// plan (ops/attention.mha_plan): one pass over a strip of keys = 64, 128,
// 208 or 256 >= S, or two passes over keys = S rounded up to 128-key chunks;
// the head features contiguous, every stride a multiple of 8 elements and
// every base 16-byte aligned (TMA). f32 takes the plan's passes: one keeps
// the scores of S <= 256 keys in shared memory, two recompute them.
extern "C" int tt_mha(const void* q, const void* k, const void* v, void* o,
                      int is_bf16, int B, int H, int S, int passes, int keys,
                      long long qb, long long qh, long long qs, long long kb,
                      long long kh, long long ks, long long vb, long long vh,
                      long long vs, long long ob, long long oh, long long os,
                      void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0 || S > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)tt::launch_mha_bf16(q, k, v, o, B, H, S, passes, keys, qb, qh, qs, kb,
                                    kh, ks, vb, vh, vs, ob, oh, os, s);
  if (passes != 2 && (passes != 1 || S > kStripMaxKeys))
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)kDh);
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  const auto kernel = passes == 1 ? mha_f32_strip_kernel : mha_f32_kernel;
  const int smem = passes == 1 ? strip_smem(S) : kFSmem;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      passes == 1 ? strip_smem(kStripMaxKeys) : kFSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + f32::kBQ - 1) / f32::kBQ, H, B);
  kernel<<<grid, f32::kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, scale, st);
  return (int)cudaGetLastError();
}
