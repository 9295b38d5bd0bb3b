// Exact softmax attention for long sequences, in the online-softmax (flash)
// form:
//   o = softmax(q k^T * scale, keys at or beyond kv_len masked) v
// q [B, H, Sq, Dh], k and v [B, H, Sk, Dh], o [B, H, Sq, Dh], Dh 64 or 32,
// all bf16 or all f32, each with its own strides on B, H and S (the Dh head
// features contiguous), so the views that a qkv projection gives are read
// in place and the output is written straight into the merged [B, S, H*Dh]
// layout. The TPU kernels pad any Dh to 128 lanes (flash_attention.py:109,
// :221); here Dh is a template parameter of both forms.
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
//   the tensor cores and the exponential units busier (~11 % faster a row
//   on an H100) but make fewer, larger blocks: the host takes
//   whichever needs fewer waves of the card's SMs. A consumer computes
//   s = q k^T by wgmma (m64n128k16, q and k from shared memory, s in
//   registers), the softmax in the accumulator's own register layout (row
//   reductions by quad shuffles, exp as exp2 with scale * log2 e folded into
//   one FMA, the key mask only in a ragged last tile), packs p to bf16 in
//   registers and feeds it as the A operand of the second wgmma (m64n64k16,
//   v MN-major from shared memory); acc stays in registers and is rescaled
//   there. Scores, p and acc never touch shared memory.
//   Since the exponentials take as long as the products, the kernel is fast
//   only where the two overlap, and each warpgroup overlaps them itself, a
//   key tile behind in its products (software pipelining): tile 0's q k^T
//   and softmax first; then for each tile it, tile it's q k^T is issued,
//   acc is rescaled by tile it - 1's correction under it, tile it - 1's
//   p @ v is issued, wgmma.wait_group 1 lets the scores land, and tile it's
//   row max, exp2 and row sums run while p @ v is still on the tensor
//   cores; wait_group 0 then precedes the release of tile it - 1's K/V slot
//   (one tile later than a loop without the overlap: the ring of four
//   absorbs it) and the packing of tile it's p; the last tile's rescale and
//   p @ v close the loop. acc is rescaled and summed in the order of the
//   loop without the overlap (acc * corr + p v), so the output is the same
//   to the bit. Live a lane: 64 scores, 32 packed p, acc (32 at Dh 64): no
//   spills in either form. At 50 x 6 x 3,137 on an H100 the kernel takes
//   ~1.61 ms (47 % of its least; a loop without the overlap 1.73); without
//   any exp2 it would take ~1.36 ms, without q k^T ~1.34: the three
//   warpgroups of a block run their products and their softmax in step
//   with each other, so the tensor cores and the exponential units still
//   wait on each other across warpgroups. (Forcing the warpgroups to take
//   turns with named barriers, tile it's q k^T issued with tile it - 1's
//   p @ v across warpgroups, was measured 19 % slower at 50 x 6 x 3,137 in
//   a loop without this overlap and is not kept; on top of this loop,
//   turns in issuing the products measured 2-4 % faster, not kept either:
//   this kernel orders nothing across warpgroups.)
//   f32: CUDA-core FMAs in f32 (no TF32: the f32 path is held to the plain
//   f32 composition at f32 tolerance) on the tiles of attention_f32.cuh: a
//   block of 128 threads owns 64 query rows, a thread 8 rows x 4 columns of
//   the scores and of acc with float4 operand reads, the softmax in
//   registers over the 16 lanes of a row, K/V tiles of 64 keys by cp.async
//   into two buffers, the next tile's copies under this one's arithmetic.
// Heads of 32 (MoCo-v3 ViT-S/16's twelve, which reach this core above
// 1,024 tokens: ViT-S/16 above 512 px): bf16 as mha.cu's heads of 32,
// 64-byte rows in a 64-byte swizzle (attention_wgmma.cuh's head_desc<32>,
// make_qkv_map(..., 32)), two k16 steps of q k^T, p @ v as m64n32k16
// (wgmma_rs from registers) into a [64 x 32] accumulator of 16 registers a
// lane; every tile offset in shared memory a multiple of 1,024 bytes (the
// 64-byte swizzle needs 512). f32: the tiles of attention_f32.cuh at
// Dh = 32, a thread's output columns a float2.
#include "attention_f32.cuh"
#include "attention_wgmma.cuh"
#include "common.cuh"

namespace {

using tt::bf16;
namespace hp = tt::hopper;

constexpr float kNeg = -1e30f;

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// ---------------------------------------------------------------- bf16 --
constexpr int kBK = 128;                 // keys per tile
constexpr int kStages = 4;               // K/V tiles in flight

// kWG consumer warpgroups of 64 query rows each, and the producer's; rows
// of Dh bf16 (one swizzle atom a row)
template <int kWG, int Dh>
struct FlashBlock {
  static constexpr int kRowBytes = Dh * 2;
  static constexpr int kTileBytes = kBK * kRowBytes;  // a K or V tile
  static constexpr int kBQ = 64 * kWG;                // queries per block
  static constexpr int kConsumerWarps = 4 * kWG;
  static constexpr int kThreads = (kWG + 1) * 128;
  static constexpr int kQBytes = kBQ * kRowBytes;
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  // 1,024 bytes of slack: the tiles start at the next 1,024-byte boundary
  static constexpr int kSmem = kBarOffset + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kQBytes % 1024 == 0 && kTileBytes % 1024 == 0,
                "swizzled tiles start on 1,024-byte boundaries");
};

// One key tile's online softmax in the accumulator's layout, in place: s
// (raw scores) becomes p = 2^(s * scale_log2 - m_new), unrounded; the row
// maxima m move to m_new (log2 units), the row sums l to l * corr + rowsum p;
// corr = 2^(m_old - m_new) is what the caller rescales acc by.
template <int R>
__device__ __forceinline__ void online_softmax(float (&s)[R], float scale_log2, float& m0,
                                               float& m1, float& l0, float& l1,
                                               float& corr0, float& corr1) {
  float mx0, mx1, sum0, sum1;
  hp::row_max(s, mx0, mx1);
  const float mn0 = fmaxf(m0, mx0 * scale_log2);
  const float mn1 = fmaxf(m1, mx1 * scale_log2);
  corr0 = hp::fast_exp2(m0 - mn0);
  corr1 = hp::fast_exp2(m1 - mn1);
  hp::exp_rows(s, scale_log2, mn0, mn1, sum0, sum1);
  l0 = l0 * corr0 + sum0;
  l1 = l1 * corr1 + sum1;
  m0 = mn0;
  m1 = mn1;
}

// this lane's two rows of an accumulator times their corrections
template <int R>
__device__ __forceinline__ void rescale_rows(float (&acc)[R], float corr0, float corr1) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    acc[4 * j] *= corr0;
    acc[4 * j + 1] *= corr0;
    acc[4 * j + 2] *= corr1;
    acc[4 * j + 3] *= corr1;
  }
}

// one block an SM: 384 or 512 threads whose consumers take 232 or 160
// registers (setmaxnreg) leave no room for a second
template <int kWG, int Dh>
__global__ void __launch_bounds__(FlashBlock<kWG, Dh>::kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                  int Sq, int kv_len, float scale_log2, long long ob,
                  long long oh, long long os) {
  using Blk = FlashBlock<kWG, Dh>;
  constexpr int kBQ = Blk::kBQ;
  constexpr int kConsumerWarps = Blk::kConsumerWarps;
  constexpr int kQBytes = Blk::kQBytes;
  constexpr int kTileBytes = Blk::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + kQBytes;            // stage s: K then V
  const uint32_t bar_q = base + Blk::kBarOffset;
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
  const uint32_t q_wg = q_s + wg * 64 * Blk::kRowBytes;
  float acc[Dh / 2];
#pragma unroll
  for (int i = 0; i < Dh / 2; ++i) acc[i] = 0.f;
  float m0 = kNeg, m1 = kNeg;          // running row max, in log2 units
  float l0 = 0.f, l1 = 0.f;            // this lane's share of the row sums

  const bool ragged = kv_len % kBK != 0;
  float sc[kBK / 2];                   // scores, then p, of the newest tile
  uint32_t pa[kBK / 4];                // p of the tile before, bf16, p @ v's A
  float corr0, corr1;

  // prologue: tile 0's scores and softmax (acc is 0: its rescale by tile
  // 0's correction, in the loop, changes nothing)
  hp::mbar_wait(bar_q, 0);
  hp::mbar_wait(bar_full, 0);
  hp::qk_product<Dh>(sc, q_wg, kv_s);
  if (n_tiles == 1 && ragged) hp::mask_keys(sc, 0, kv_len, lane);
  online_softmax(sc, scale_log2, m0, m1, l0, l1, corr0, corr1);
  hp::pack_rows(sc, 1.f, 1.f, pa);

  // tile it's q k^T and tile it - 1's p @ v go out together, acc's rescale
  // by tile it - 1's correction between them; tile it's softmax runs while
  // p @ v is still on the tensor cores
  for (int it = 1; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int prev = (it - 1) % kStages;
    hp::mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
    hp::qk_issue<Dh>(sc, q_wg, kv_s + s * 2 * kTileBytes);
    rescale_rows(acc, corr0, corr1);
    hp::pv_issue<kBK / 16>(acc, pa, kv_s + prev * 2 * kTileBytes + kTileBytes);
    hp::wgmma_wait<1>();                 // q k^T has landed
    hp::pin(sc);
    if (it == n_tiles - 1 && ragged) hp::mask_keys(sc, it * kBK, kv_len, lane);
    online_softmax(sc, scale_log2, m0, m1, l0, l1, corr0, corr1);
    hp::pin(sc);
    hp::wgmma_wait<0>();                 // and p @ v
    hp::pin(acc);
    hp::pin(pa);
    if (lane == 0) hp::mbar_arrive(bar_empty + 8 * prev);   // this warp's reads are done
    hp::pack_rows(sc, 1.f, 1.f, pa);
  }

  // epilogue: the last tile's rescale and p @ v (its slot is never refilled)
  rescale_rows(acc, corr0, corr1);
  hp::pv_product<kBK / 16>(acc, pa,
                           kv_s + ((n_tiles - 1) % kStages) * 2 * kTileBytes + kTileBytes, true);

  l0 = fmaxf(hp::quad_sum(l0), 1e-20f);
  l1 = fmaxf(hp::quad_sum(l1), 1e-20f);
  hp::store_rows(acc, l0, l1, o + b * ob + h * oh, os, r0, Sq, lane);
}

// --------------------------------------------------------- bf16, Dh 128 --
// Heads of 128 (DINOv3 ViT-7B's 32): a row is 256 bytes, two 128-byte
// swizzle atoms, so every tile is held as two panels of 64 head features
// ([rows, 64], 128-byte swizzle, a panel of 128 rows 16 KB), each arriving
// by its own TMA box (make_qkv_map(..., 128), tma_load_at col 0 and 64), as
// the GEMM tile holds K in 64-wide panels. q k^T is m64n128k16 over eight
// k16 steps, four a panel; p v is two m64n64k16 a k16 step, one a V panel,
// into the accumulator's two halves (head features 0-63 and 64-127, 32
// registers each). Two consumer warpgroups (128 query rows): at 64 + 64 + 32
// registers of scores, output and packed p a thread a third would not fit
// (setmaxnreg 160). Shared memory: q 32 KB and three stages of K and V, 64
// KB a stage (224 KB of the 227). The softmax, the masking of a ragged
// last key tile and the store are the heads-of-64 kernel's; RoPE, where a
// model has it, was applied to q and k by the qkv product's epilogue
// (gemm_wgmma.cuh kBiasRope), so this kernel reads rotated heads. At 8 x 32
// heads x 3,141 tokens: 2.565 ms, 51 % of its least (PyTorch's SDPA 2.291;
// H100 80GB HBM3, 700 W): a warpgroup's products and softmax run one after
// another (the heads-of-64 form overlaps them).
struct FlashBlock128 {
  static constexpr int kWG = 2;
  static constexpr int kPanelRows = 64 * kWG;         // q rows of a block
  static constexpr int kQPanel = kPanelRows * 128;     // one q panel: 16 KB
  static constexpr int kTilePanel = kBK * 128;         // one K or V panel: 16 KB
  static constexpr int kTileBytes = 2 * kTilePanel;    // a K or V tile
  static constexpr int kStages = 3;
  static constexpr int kConsumerWarps = 4 * kWG;
  static constexpr int kThreads = (kWG + 1) * 128;
  static constexpr int kQBytes = 2 * kQPanel;
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  static constexpr int kSmem = kBarOffset + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
};

__global__ void __launch_bounds__(FlashBlock128::kThreads, 1)
flash_bf16_d128_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                       int Sq, int kv_len, float scale_log2, long long ob, long long oh,
                       long long os) {
  using Blk = FlashBlock128;
  constexpr int kStages = Blk::kStages;
  constexpr int kTileBytes = Blk::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                       // panel p: q_s + p kQPanel
  const uint32_t kv_s = base + Blk::kQBytes;       // stage s: K's two panels, then V's
  const uint32_t bar_q = base + Blk::kBarOffset;
  const uint32_t bar_full = bar_q + 8;             // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * Blk::kPanelRows;
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  const int n_tiles = (kv_len + kBK - 1) / kBK;

  if (tid == 0) {
    hp::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(bar_full + 8 * s, 1);
      hp::mbar_init(bar_empty + 8 * s, Blk::kConsumerWarps);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= Blk::kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == Blk::kConsumerWarps && lane == 0) {
      hp::mbar_arrive_expect_tx(bar_q, Blk::kQBytes);
      hp::tma_load_at(q_s, &map_q, bar_q, 0, q0, h, b);
      hp::tma_load_at(q_s + Blk::kQPanel, &map_q, bar_q, 64, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t round = (it / kStages) & 1;
        hp::mbar_wait(bar_empty + 8 * s, round ^ 1);
        hp::mbar_arrive_expect_tx(bar_full + 8 * s, 2 * kTileBytes);
        const uint32_t st = kv_s + s * 2 * kTileBytes;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          hp::tma_load_at(st + p * Blk::kTilePanel, &map_k, bar_full + 8 * s, 64 * p,
                          it * kBK, h, b);
          hp::tma_load_at(st + kTileBytes + p * Blk::kTilePanel, &map_v, bar_full + 8 * s,
                          64 * p, it * kBK, h, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = warp >> 2;
  const int r0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);   // and r0 + 8
  const uint32_t q_wg = q_s + wg * 64 * hp::kRowBytes;
  float lo[32], hi[32];                // output features 0-63 and 64-127
#pragma unroll
  for (int i = 0; i < 32; ++i) lo[i] = hi[i] = 0.f;
  float m0 = kNeg, m1 = kNeg;
  float l0 = 0.f, l1 = 0.f;

  hp::mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t round = (it / kStages) & 1;
    const uint32_t k_s = kv_s + s * 2 * kTileBytes;
    const uint32_t v_s = k_s + kTileBytes;
    hp::mbar_wait(bar_full + 8 * s, round);

    float sc[kBK / 2];
    hp::pin(sc);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t p = kk >> 2;
      hp::wgmma_ss(sc, hp::smem_desc(q_wg + p * Blk::kQPanel) + (kk & 3) * hp::kDescKStep,
                   hp::smem_desc(k_s + p * Blk::kTilePanel) + (kk & 3) * hp::kDescKStep,
                   kk > 0);
    }
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::pin(sc);
    if (it == n_tiles - 1 && kv_len % kBK != 0) hp::mask_keys(sc, it * kBK, kv_len, lane);

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
      lo[4 * j] *= corr0, lo[4 * j + 1] *= corr0, lo[4 * j + 2] *= corr1, lo[4 * j + 3] *= corr1;
      hi[4 * j] *= corr0, hi[4 * j + 1] *= corr0, hi[4 * j + 2] *= corr1, hi[4 * j + 3] *= corr1;
    }
    uint32_t pa[kBK / 4];
    hp::pack_rows(sc, 1.f, 1.f, pa);
    const uint64_t vd0 = hp::smem_desc(v_s), vd1 = hp::smem_desc(v_s + Blk::kTilePanel);
    hp::pin(pa);
    hp::pin(lo);
    hp::pin(hi);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      hp::wgmma_rs(lo, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                   vd0 + kk * hp::kDescRowStep, 1);
      hp::wgmma_rs(hi, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                   vd1 + kk * hp::kDescRowStep, 1);
    }
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::pin(lo);
    hp::pin(hi);
    hp::pin(pa);
    if (lane == 0) hp::mbar_arrive(bar_empty + 8 * s);
  }

  l0 = fmaxf(hp::quad_sum(l0), 1e-20f);
  l1 = fmaxf(hp::quad_sum(l1), 1e-20f);
  bf16* dst = o + b * ob + h * oh;
  hp::store_rows(lo, l0, l1, dst, os, r0, Sq, lane);
  hp::store_rows(hi, l0, l1, dst + 64, os, r0, Sq, lane);
}

// ----------------------------------------------------------------- f32 --
namespace f32 = tt::f32attn;
template <int Dh>
constexpr int f32_smem() {   // Q, 2 K, 2 V, P
  return (3 * f32::Tiles<Dh>::kTile + 2 * f32::Tiles<Dh>::kVTile + f32::kPTile) *
         (int)sizeof(float);
}

// two blocks an SM (87 KB of shared memory a block at Dh = 64)
template <int Dh>
__global__ void __launch_bounds__(f32::kThreads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Sk, int kv_len, float scale, Strides st) {
  using T = f32::Tiles<Dh>;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                       // [64][kLd]
  float* Ks = Qs + T::kTile;             // [2][64][kLd]
  float* Vs = Ks + 2 * T::kTile;         // [2][64][Dh]
  float* Ps = Vs + 2 * T::kVTile;        // [64][kLdP]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * f32::kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;               // rows ty + 8 i
  const int tx = tid & 15;               // keys tx + 16 j, head features Dh / 16 tx + c
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;

  f32::load_tile_async<Dh>(Ks, T::kLd, kp, st.ks, 0, Sk, tid);
  f32::load_tile_async<Dh>(Vs, Dh, vp, st.vs, 0, Sk, tid);
  f32::async_commit();
  f32::load_tile<Dh>(Qs, T::kLd, qp, st.qs, q0, Sq, tid);

  float m_run[8], l_run[8], acc[8][T::kCols];   // l_run: this lane's share of the row sum
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = kNeg;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < T::kCols; ++c) acc[i][c] = 0.f;
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
      f32::load_tile_async<Dh>(Ks + (buf ^ 1) * T::kTile, T::kLd, kp, st.ks,
                               k0 + f32::kBK, Sk, tid);
      f32::load_tile_async<Dh>(Vs + (buf ^ 1) * T::kVTile, Dh, vp, st.vs,
                               k0 + f32::kBK, Sk, tid);
      f32::async_commit();
    }

    float s[8][4];
    f32::qk_tile<Dh>(s, Qs, Ks + buf * T::kTile, scale, ty, tx);
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
      for (int c = 0; c < T::kCols; ++c) acc[i][c] *= corr;
    }
    f32::store_p(Ps, s, ty, tx);
    __syncthreads();
    f32::pv_tile<Dh>(acc, Ps, f32::kLdP, Vs + buf * T::kVTile, f32::kBK, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) l_run[i] = fmaxf(f32::row_sum16(l_run[i]), 1e-20f);
  f32::store_rows<Dh>(acc, l_run, o + b * st.ob + h * st.oh, st.os, q0, Sq, ty, tx);
}

template <int kWG, int Dh>
cudaError_t launch_bf16_form(const CUtensorMap& mq, const CUtensorMap& mk,
                             const CUtensorMap& mv, bf16* o, int B, int H, int Sq,
                             int kv_len, float scale_log2, long long ob, long long oh,
                             long long os, cudaStream_t s) {
  using Blk = FlashBlock<kWG, Dh>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel<kWG, Dh>, cudaFuncAttributeMaxDynamicSharedMemorySize, Blk::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + Blk::kBQ - 1) / Blk::kBQ, H, B);
  flash_bf16_kernel<kWG, Dh><<<grid, Blk::kThreads, Blk::kSmem, s>>>(
      mq, mk, mv, o, Sq, kv_len, scale_log2, ob, oh, os);
  return cudaGetLastError();
}

cudaError_t launch_bf16_d128(const CUtensorMap& mq, const CUtensorMap& mk,
                             const CUtensorMap& mv, bf16* o, int B, int H, int Sq,
                             int kv_len, float scale_log2, long long ob, long long oh,
                             long long os, cudaStream_t s) {
  using Blk = FlashBlock128;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_d128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Blk::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + Blk::kPanelRows - 1) / Blk::kPanelRows, H, B);
  flash_bf16_d128_kernel<<<grid, Blk::kThreads, Blk::kSmem, s>>>(
      mq, mk, mv, o, Sq, kv_len, scale_log2, ob, oh, os);
  return cudaGetLastError();
}

template <int Dh>
cudaError_t launch_f32(const float* q, const float* k, const float* v, float* o,
                       int B, int H, int Sq, int Sk, int kv_len, float scale,
                       const Strides& st, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_f32_kernel<Dh>, cudaFuncAttributeMaxDynamicSharedMemorySize, f32_smem<Dh>());
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + f32::kBQ - 1) / f32::kBQ, H, B);
  flash_f32_kernel<Dh><<<grid, f32::kThreads, f32_smem<Dh>(), s>>>(
      q, k, v, o, Sq, Sk, kv_len, scale, st);
  return cudaGetLastError();
}

// bf16 at Dh 64 or 32 in the form of `wg` consumer warpgroups (2 or 3)
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int Sq, int Sk, int kv_len, int Dh, int wg, float scale_log2,
                        const Strides& st, cudaStream_t s) {
  CUtensorMap map_q, map_k, map_v;
  cudaError_t e;
  if ((e = hp::make_qkv_map(&map_q, q, B, H, Sq, st.qb, st.qh, st.qs, 64 * wg, Dh)) !=
          cudaSuccess ||
      (e = hp::make_qkv_map(&map_k, k, B, H, Sk, st.kb, st.kh, st.ks, kBK, Dh)) !=
          cudaSuccess ||
      (e = hp::make_qkv_map(&map_v, v, B, H, Sk, st.vb, st.vh, st.vs, kBK, Dh)) !=
          cudaSuccess)
    return e;
  const auto launch = wg == 3 ? (Dh == 64 ? launch_bf16_form<3, 64> : launch_bf16_form<3, 32>)
                              : (Dh == 64 ? launch_bf16_form<2, 64> : launch_bf16_form<2, 32>);
  return launch(map_q, map_k, map_v, static_cast<bf16*>(o), B, H, Sq, kv_len, scale_log2,
                st.ob, st.oh, st.os, s);
}

bool valid_shape(int B, int H, int Sq, int Sk, int kv_len) {
  return B > 0 && B <= 65535 && H > 0 && H <= 65535 && Sq > 0 && Sk > 0 && kv_len >= 1 &&
         kv_len <= Sk;
}

}  // namespace

// q, k, v, o: device pointers of bf16 (is_bf16 = 1) or f32 values; strides
// in elements; Dh 64 or 32, or 128 in bf16. 1 <= kv_len <= Sk. bf16: the
// head features contiguous, every stride a multiple of 8 elements and every
// base 16-byte aligned (TMA).
extern "C" int tt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int is_bf16, int B, int H, int Sq,
                                  int Sk, int kv_len, int Dh, long long qb,
                                  long long qh, long long qs, long long kb,
                                  long long kh, long long ks, long long vb,
                                  long long vh, long long vs, long long ob,
                                  long long oh, long long os, void* stream) {
  if (!valid_shape(B, H, Sq, Sk, kv_len) ||
      (Dh != 32 && Dh != 64 && !(Dh == 128 && is_bf16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf((float)Dh);
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaError_t e;
  if (Dh == 128) {
    CUtensorMap map_q, map_k, map_v;
    if ((e = hp::make_qkv_map(&map_q, q, B, H, Sq, qb, qh, qs, FlashBlock128::kPanelRows,
                              128)) != cudaSuccess ||
        (e = hp::make_qkv_map(&map_k, k, B, H, Sk, kb, kh, ks, kBK, 128)) != cudaSuccess ||
        (e = hp::make_qkv_map(&map_v, v, B, H, Sk, vb, vh, vs, kBK, 128)) != cudaSuccess)
      return (int)e;
    return (int)launch_bf16_d128(map_q, map_k, map_v, static_cast<bf16*>(o), B, H, Sq, kv_len,
                                 scale * hp::kLog2e, ob, oh, os, s);
  }
  if (is_bf16) {
    // three consumer warpgroups a block run a row ~11 % faster than two
    // (0.86-0.96 of two's time a row-wave, 0.89 in the mean, at 25 and 50 x
    // 6 x 3,137 and 25 x 24 x 1,029 on an H100), in blocks of 192 rows
    // instead of 128: take the form whose waves over the card's SMs cost less
    int sms = 0, device = 0;
    if ((e = cudaGetDevice(&device)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess)
      return (int)e;
    auto waves = [&](int rows) {
      return (((long long)(Sq + rows - 1) / rows * H * B + sms - 1) / sms) * rows;
    };
    const int wg = 0.89 * waves(192) < waves(128) ? 3 : 2;
    return (int)launch_bf16(q, k, v, o, B, H, Sq, Sk, kv_len, Dh, wg, scale * hp::kLog2e, st,
                            s);
  }
  return (int)(Dh == 64 ? launch_f32<64> : launch_f32<32>)(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), B, H, Sq, Sk, kv_len, scale,
      st, s);
}

// The bf16 core at Dh 64 or 32 in the form of `warpgroups` consumer
// warpgroups a block (2 or 3) whatever the shape, for the card's checks and
// the timing tools; arguments as tt_flash_attention's, all bf16.
extern "C" int tt_flash_attention_form(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int Sq, int Sk, int kv_len, int Dh,
                                       int warpgroups, long long qb, long long qh,
                                       long long qs, long long kb, long long kh,
                                       long long ks, long long vb, long long vh,
                                       long long vs, long long ob, long long oh,
                                       long long os, void* stream) {
  if (!valid_shape(B, H, Sq, Sk, kv_len) || (Dh != 32 && Dh != 64) ||
      (warpgroups != 2 && warpgroups != 3))
    return (int)cudaErrorInvalidValue;
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  return (int)launch_bf16(q, k, v, o, B, H, Sq, Sk, kv_len, Dh, warpgroups,
                          1.f / sqrtf((float)Dh) * hp::kLog2e, st,
                          static_cast<cudaStream_t>(stream));
}
