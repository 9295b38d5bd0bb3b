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
// VMEM's megabytes, so this kernel always streams K/V through a ring of
// tiles in shared memory, the carry (m, l, acc) in registers.
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
// in bf16: far above the ridge, so product rate decides; and at a head width
// of 64 the Sq * Sk exponentials of the softmax (16 a clock an SM) take as
// long as the products at the tensor cores' peak.
//   bf16: a block owns 128 or 192 query rows of one (batch, head): two or
//   three consumer warpgroups of 64 rows each and a producer warpgroup that
//   gives its registers to them (setmaxnreg). One producer lane fills a
//   ring of four [128 keys, 64] K and V tiles by TMA (cp.async.bulk.tensor
//   on an mbarrier, 128-byte swizzle, rows past Sk zero-filled), ahead of
//   their use; each K/V tile serves every warpgroup. Three warpgroups keep
//   the tensor cores and the exponential units busier (9 % faster at 50 x 6
//   x 3,137 on an H100) but make fewer, larger blocks: the host takes
//   whichever needs fewer waves of the card's SMs. A consumer computes
//   s = q k^T by wgmma (m64n128k16, q and k from shared memory, s in
//   registers), the softmax in the accumulator's own register layout (row
//   reductions by quad shuffles, exp as exp2 with scale * log2 e folded into
//   one FMA, the key mask only in a ragged last tile), packs p to bf16 in
//   registers and feeds it as the A operand of the second wgmma (m64n64k16,
//   v MN-major from shared memory); acc stays in registers and is rescaled
//   there. Scores, p and acc never touch shared memory. The
//   warpgroups are not ordered against each other: while one is in its
//   softmax the others' products can run. (Forcing them to take turns with
//   named barriers, tile it's q k^T issued with tile it - 1's p @ v, was
//   measured 19 % slower at 50 x 6 x 3,137 on an H100 and is not kept.)
//   f32: CUDA-core FMAs in f32 (no TF32: the f32 path is held to the plain
//   f32 composition at f32 tolerance) on the tiles of attention_f32.cuh: a
//   block of 128 threads owns 64 query rows, a thread 8 rows x 4 columns of
//   the scores and of acc with float4 operand reads, the softmax in
//   registers over the 16 lanes of a row, K/V tiles of 64 keys by cp.async
//   into two buffers, the next tile's copies under this one's arithmetic.
// Dh is fixed at 64 (every ViT-S/B configuration of the repo).
#include "attention_f32.cuh"
#include "attention_wgmma.cuh"
#include "common.cuh"

namespace {

using tt::bf16;
namespace hp = tt::hopper;

constexpr int kDh = 64;
constexpr float kNeg = -1e30f;

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// ---------------------------------------------------------------- bf16 --
constexpr int kBK = 128;                 // keys per tile
constexpr int kStages = 4;               // K/V tiles in flight
constexpr int kTileBytes = kBK * hp::kRowBytes;

// kWG consumer warpgroups of 64 query rows each, and the producer's
template <int kWG>
struct FlashBlock {
  static constexpr int kBQ = 64 * kWG;                // queries per block
  static constexpr int kConsumerWarps = 4 * kWG;
  static constexpr int kThreads = (kWG + 1) * 128;
  static constexpr int kQBytes = kBQ * hp::kRowBytes;
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  // 1,024 bytes of slack: the tiles start at the next 1,024-byte boundary
  static constexpr int kSmem = kBarOffset + (1 + 2 * kStages) * 8 + 1024;
};

template <int kWG>
__global__ void __launch_bounds__(FlashBlock<kWG>::kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                  int Sq, int kv_len, float scale_log2, long long ob,
                  long long oh, long long os) {
  constexpr int kBQ = FlashBlock<kWG>::kBQ;
  constexpr int kConsumerWarps = FlashBlock<kWG>::kConsumerWarps;
  constexpr int kQBytes = FlashBlock<kWG>::kQBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + kQBytes;            // stage s: K then V
  const uint32_t bar_q = base + FlashBlock<kWG>::kBarOffset;
  const uint32_t bar_full = bar_q + 8;             // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = (kv_len + kBK - 1) / kBK;

  if (tid == 0) {
    hp::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(bar_full + 8 * s, 1);
      hp::mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer warpgroup: one lane keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == kConsumerWarps && lane == 0) {
      hp::mbar_arrive_expect_tx(bar_q, kQBytes);
      hp::tma_load(q_s, &map_q, bar_q, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t round = (it / kStages) & 1;
        hp::mbar_wait(bar_empty + 8 * s, round ^ 1);   // passes at once in round 0
        hp::mbar_arrive_expect_tx(bar_full + 8 * s, 2 * kTileBytes);
        hp::tma_load(kv_s + s * 2 * kTileBytes, &map_k, bar_full + 8 * s, it * kBK, h, b);
        hp::tma_load(kv_s + s * 2 * kTileBytes + kTileBytes, &map_v, bar_full + 8 * s,
                     it * kBK, h, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  if (kWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;");
  const int wg = warp >> 2;
  const int r0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);   // and r0 + 8
  const uint32_t q_wg = q_s + wg * 64 * hp::kRowBytes;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m0 = kNeg, m1 = kNeg;          // running row max, in log2 units
  float l0 = 0.f, l1 = 0.f;            // this lane's share of the row sums

  hp::mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t round = (it / kStages) & 1;
    const uint32_t k_s = kv_s + s * 2 * kTileBytes;
    hp::mbar_wait(bar_full + 8 * s, round);

    float sc[kBK / 2];
    hp::qk_product(sc, q_wg, k_s);
    if (it == n_tiles - 1 && kv_len % kBK != 0)
      hp::mask_keys(sc, it * kBK, kv_len, lane);

    float mx0, mx1, sum0, sum1;
    hp::row_max(sc, mx0, mx1);
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    const float corr0 = hp::fast_exp2(m0 - mn0);
    const float corr1 = hp::fast_exp2(m1 - mn1);
    hp::exp_rows(sc, scale_log2, mn0, mn1, sum0, sum1);
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[4 * j] *= corr0;
      acc[4 * j + 1] *= corr0;
      acc[4 * j + 2] *= corr1;
      acc[4 * j + 3] *= corr1;
    }
    uint32_t pa[kBK / 4];
    hp::pack_rows(sc, 1.f, 1.f, pa);
    hp::pv_product<kBK / 16>(acc, pa, k_s + kTileBytes, true);
    if (lane == 0) hp::mbar_arrive(bar_empty + 8 * s);   // this warp's reads are done
  }

  l0 = fmaxf(hp::quad_sum(l0), 1e-20f);
  l1 = fmaxf(hp::quad_sum(l1), 1e-20f);
  hp::store_rows(acc, l0, l1, o + b * ob + h * oh, os, r0, Sq, lane);
}

// ----------------------------------------------------------------- f32 --
namespace f32 = tt::f32attn;
constexpr int kFSmem =
    (4 * f32::kTile + 2 * f32::kVTile) * (int)sizeof(float);   // Q, 2 K, P; 2 V

__global__ void __launch_bounds__(f32::kThreads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Sk, int kv_len, float scale, Strides st) {
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

  f32::load_tile_async(Ks, f32::kLd, kp, st.ks, 0, Sk, tid);
  f32::load_tile_async(Vs, f32::kDh, vp, st.vs, 0, Sk, tid);
  f32::async_commit();
  f32::load_tile(Qs, f32::kLd, qp, st.qs, q0, Sq, tid);

  float m_run[8], l_run[8], acc[8][4];   // l_run: this lane's share of the row sum
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = kNeg;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (kv_len + f32::kBK - 1) / f32::kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * f32::kBK;
    const int buf = kt & 1;
    // tile kt has landed, and the last tile's reads of the other buffers
    // and of P are done: the next tile's copies go out under this one's work
    f32::async_wait<0>();
    __syncthreads();
    if (kt + 1 < n_tiles) {
      f32::load_tile_async(Ks + (buf ^ 1) * f32::kTile, f32::kLd, kp, st.ks,
                           k0 + f32::kBK, Sk, tid);
      f32::load_tile_async(Vs + (buf ^ 1) * f32::kVTile, f32::kDh, vp, st.vs,
                           k0 + f32::kBK, Sk, tid);
      f32::async_commit();
    }

    float s[8][4];
    f32::qk_tile(s, Qs, Ks + buf * f32::kTile, scale, ty, tx);
    if (k0 + f32::kBK > kv_len) f32::mask_keys(s, k0, kv_len, tx);

    // online softmax in registers; masked keys give exp(-1e30 - m) = 0
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float mx = f32::row_max16(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m_run[i], mx);
      const float corr = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= corr;
    }
    f32::store_p(Ps, s, ty, tx);
    __syncthreads();
    f32::pv_tile(acc, Ps, f32::kLd, Vs + buf * f32::kVTile, f32::kBK, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) l_run[i] = fmaxf(f32::row_sum16(l_run[i]), 1e-20f);
  f32::store_rows(acc, l_run, o + b * st.ob + h * st.oh, st.os, q0, Sq, ty, tx);
}

}  // namespace

// q, k, v, o: device pointers of bf16 (is_bf16 = 1) or f32 values; strides
// in elements. 1 <= kv_len <= Sk. bf16: the head features contiguous, every
// stride a multiple of 8 elements and every base 16-byte aligned (TMA).
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf((float)kDh);
  cudaError_t e;
  if (is_bf16) {
    CUtensorMap map_q, map_k, map_v;
    // three consumer warpgroups a block run a row ~9 % faster than two, in
    // blocks of 192 rows instead of 128: take the form whose waves over the
    // card's SMs cost less
    int sms = 0, device = 0;
    if ((e = cudaGetDevice(&device)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess)
      return (int)e;
    auto waves = [&](int rows) {
      return (((long long)(Sq + rows - 1) / rows * H * B + sms - 1) / sms) * rows;
    };
    const bool three = 0.91 * waves(192) < waves(128);
    const int q_rows = three ? 192 : 128;
    if ((e = hp::make_qkv_map(&map_q, q, B, H, Sq, qb, qh, qs, q_rows)) != cudaSuccess ||
        (e = hp::make_qkv_map(&map_k, k, B, H, Sk, kb, kh, ks, kBK)) != cudaSuccess ||
        (e = hp::make_qkv_map(&map_v, v, B, H, Sk, vb, vh, vs, kBK)) != cudaSuccess)
      return (int)e;
    const auto kernel = three ? flash_bf16_kernel<3> : flash_bf16_kernel<2>;
    const int smem = three ? FlashBlock<3>::kSmem : FlashBlock<2>::kSmem;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((Sq + q_rows - 1) / q_rows, H, B);
    kernel<<<grid, three ? FlashBlock<3>::kThreads : FlashBlock<2>::kThreads, smem, s>>>(
        map_q, map_k, map_v, static_cast<bf16*>(o), Sq, kv_len, scale * hp::kLog2e,
        ob, oh, os);
  } else {
    const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
    e = cudaFuncSetAttribute(flash_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((Sq + f32::kBQ - 1) / f32::kBQ, H, B);
    flash_f32_kernel<<<grid, f32::kThreads, kFSmem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, kv_len,
        scale, st);
  }
  return (int)cudaGetLastError();
}
