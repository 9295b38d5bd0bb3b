// Exact softmax attention for long sequences, in the online-softmax (flash)
// form:
//   o = softmax(q k^T * scale, keys at or beyond kv_len masked) v
// q [B, H, Sq, Dh], k and v [B, H, Sk, Dh], o [B, H, Sq, Dh], Dh 64 or 32,
// all bf16 or all f32, each with its own strides on B, H and S (the Dh head
// features contiguous), so the views that a qkv projection gives are read
// in place and the output is written straight into the merged [B, S, H*Dh]
// layout. The TPU kernels pad any Dh to 128 lanes (flash_attention.py:109,
// :221); here Dh is a template parameter of both forms. Heads of 128 (DINOv3)
// and SAM's heads of 80 with its relative-position bias have bf16 forms of
// their own, below.
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

// ------------------------------------------- bf16, Dh 80, rel-pos bias --
// SAM ViT-H's heads of 80 with its decomposed relative-position bias: each
// sequence is a K x K grid of tokens in raster order (a 14 x 14 window of a
// windowed block, the whole 64 x 64 grid of a global one), and the score of
// query (qh, qw) against key (kh, kw) is
//   (q scale) . k + q . Rh[qh - kh + K - 1] + q . Rw[qw - kw + K - 1]
// with the unscaled q. The two bias terms are tables of the query and one
// key coordinate: T[r, kh] and T[r, K + kw], [S, 2 K] a (sequence, head),
// made before the core by relpos_table_kernel (times log2 e) and added to
// each score in the core's log2 units, s = fma(q . k, scale log2 e, T[r, kh]
// + T[r, K + kw]), before the row's max: no [S, S] bias is ever made.
//
// A row of 80 bf16 (160 bytes) is wider than one 128-byte swizzle atom, so
// q, K and V tiles are held as two panels, each from its own TMA box: head
// features 0-63 in 128-byte rows (128-byte swizzle, the heads-of-64
// layout) and 64-95 in 64-byte rows (64-byte swizzle, the heads-of-32
// layout), whose features 80-95 lie past the head and arrive as zeros. q k^T
// is m64n128k16 over five k16 steps: four on the first panel, the first of
// the second's two (features 64-79; the zeros are not multiplied); p v is
// m64n64k16 on the first panel and m64n32k16 on the second, whose columns
// 16-31 (the zero features) are never stored: a sixth of p v's products is
// padding. Two consumer warpgroups (128 query rows) as the heads-of-128
// form, without its overlap of softmax and products; three stages of K and
// V at 48 KB a stage.
//
// One launch covers every sequence and head of a block. Only SAM's global
// grid, K = 64, takes this form (its windows take the resident form below).
// A global block's 4,096 queries take 32 blocks of 128 rows and its keys 32
// tiles; SAM masks no key. Outputs go straight to the merged [frames, G * G,
// H * 80] rows of the grid (RelposOut, the global case). A 128-key tile is
// two grid rows, so a lane's key columns (kw) are the same in every tile and
// their T values sit in registers.
struct FlashBlock80 {
  static constexpr int kSide = 64;                     // the grid's side K
  static constexpr int kWG = 2;
  static constexpr int kRows = 64 * kWG;               // q rows of a block
  static constexpr int kPanelA = kBK * 128;            // a K or V tile's features 0-63
  static constexpr int kPanelB = kBK * 64;             // and 64-95
  static constexpr int kTileBytes = kPanelA + kPanelB;
  static constexpr int kQA = kRows * 128;
  static constexpr int kQBytes = kQA + kRows * 64;
  static constexpr int kStages = 3;
  static constexpr int kConsumerWarps = 4 * kWG;
  static constexpr int kThreads = (kWG + 1) * 128;
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  static constexpr int kSmem = kBarOffset + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
  static_assert(kQA % 1024 == 0 && kPanelA % 1024 == 0 && kTileBytes % 1024 == 0,
                "swizzled panels start on 1,024-byte boundaries");
};

// Where the core's output row r of sequence n goes (elements from o; the
// head's offset apart), or -1: a global sequence is one frame's grid in
// raster order; a windowed one is window n % (nw * nw) of frame n / (nw *
// nw), nw = ceil(grid / window), and its rows past the grid are the padding.
struct RelposOut {
  int grid;
  int window;      // 0: global
  long long ob, os;

  __device__ __forceinline__ long long row(int n, int r, int S) const {
    if (r >= S) return -1;
    if (window == 0) return n * ob + r * os;
    const int nw = (grid + window - 1) / window;
    const int f = n / (nw * nw), w = n - f * nw * nw;
    const int y = (w / nw) * window + r / window, x = (w % nw) * window + r % window;
    if (y >= grid || x >= grid) return -1;
    return f * ob + ((long long)y * grid + x) * os;
  }
};

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// T[n, h, r, :] (f32 [S, 2 K], times log2 e) for every row r of every
// (sequence n, head h): T[r, kh] = q_r . Rh[qh - kh + K - 1] and T[r, K + kw] =
// q_r . Rw[qw - kw + K - 1], (qh, qw) = (r / K, r % K), q_r the unscaled bf16
// query, Rh and Rw bf16 [2 K - 1, 80]. A warp takes 16 rows: all of a row's
// 2 (2 K - 1) products q_r . R[i] on mma.sync m16n8k16 (f32 accumulation),
// each of which is the one T entry it lands on, or none, written into the
// block's tile in shared memory; a block of four warps takes 64 rows of one
// (sequence, head), whose [64, 2 K] tile is contiguous in T and leaves in
// 16-byte stores.
__global__ void __launch_bounds__(128)
relpos_table_kernel(const bf16* __restrict__ q, long long qb, long long qh, long long qs,
                    const bf16* __restrict__ rh, const bf16* __restrict__ rw,
                    float* __restrict__ T, int H, int S, int K) {
  extern __shared__ float tile[];      // [64, 2 K]
  const int n = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * 64;
  const int r0 = b0 + warp * 16;
  const int g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = ra + 8;
  const bf16* qp = q + n * qb + h * qh;
  uint32_t a[5][4];
#pragma unroll
  for (int ks = 0; ks < 5; ++ks) {
    const int c = ks * 16 + 2 * t;
    a[ks][0] = ra < S ? ld_u32(qp + ra * qs + c) : 0u;
    a[ks][1] = rb < S ? ld_u32(qp + rb * qs + c) : 0u;
    a[ks][2] = ra < S ? ld_u32(qp + ra * qs + c + 8) : 0u;
    a[ks][3] = rb < S ? ld_u32(qp + rb * qs + c + 8) : 0u;
  }
  const int n_idx = 2 * K - 1, w2 = 2 * K;
#pragma unroll 1
  for (int tab = 0; tab < 2; ++tab) {
    const bf16* R = tab ? rw : rh;
#pragma unroll 1
    for (int i0 = 0; i0 < n_idx; i0 += 8) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const int ib = i0 + g;
#pragma unroll
      for (int ks = 0; ks < 5; ++ks) {
        const uint32_t b0_ = ib < n_idx ? ld_u32(R + ib * 80 + ks * 16 + 2 * t) : 0u;
        const uint32_t b1_ = ib < n_idx ? ld_u32(R + ib * 80 + ks * 16 + 8 + 2 * t) : 0u;
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[ks][0]), "r"(a[ks][1]), "r"(a[ks][2]), "r"(a[ks][3]), "r"(b0_),
              "r"(b1_));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? ra : rb;
        const int i = i0 + 2 * t + (e & 1);
        if (i >= n_idx) continue;
        const int k = (tab ? r % K : r / K) + K - 1 - i;
        if (k >= 0 && k < K) tile[(r - b0) * w2 + tab * K + k] = c[e] * hp::kLog2e;
      }
    }
  }
  __syncthreads();
  // the block's rows of T are one contiguous run: 16-byte stores (2 K is
  // even, and a multiple of 4 at K 14 and 64)
  const int rows = min(64, S - b0);
  float* out = T + (((long long)n * H + h) * S + b0) * w2;
  if (w2 % 4 == 0) {
    for (int j = threadIdx.x; j < rows * w2 / 4; j += 128)
      reinterpret_cast<float4*>(out)[j] = reinterpret_cast<const float4*>(tile)[j];
  } else {
    for (int j = threadIdx.x; j < rows * w2; j += 128) out[j] = tile[j];
  }
}

__global__ void __launch_bounds__(FlashBlock80::kThreads, 1)
flash_relpos_kernel(const __grid_constant__ CUtensorMap map_qa,
                    const __grid_constant__ CUtensorMap map_qb,
                    const __grid_constant__ CUtensorMap map_ka,
                    const __grid_constant__ CUtensorMap map_kb,
                    const __grid_constant__ CUtensorMap map_va,
                    const __grid_constant__ CUtensorMap map_vb, const float* __restrict__ T,
                    bf16* __restrict__ o, int H, float scale_log2, long long oh,
                    const RelposOut dst) {
  using Blk = FlashBlock80;
  constexpr int K = Blk::kSide, S = K * K;
  static_assert(S % kBK == 0, "no ragged key tile");
  constexpr int kStages = Blk::kStages;
  constexpr int kTileBytes = Blk::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                       // features 0-63, then 64-95
  const uint32_t kv_s = base + Blk::kQBytes;       // stage s: K's two panels, then V's
  const uint32_t bar_q = base + Blk::kBarOffset;
  const uint32_t bar_full = bar_q + 8;             // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int n = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * Blk::kRows;
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  const int n_tiles = (S + kBK - 1) / kBK;

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
      hp::tma_load_at(q_s, &map_qa, bar_q, 0, q0, h, n);
      hp::tma_load_at(q_s + Blk::kQA, &map_qb, bar_q, 64, q0, h, n);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t round = (it / kStages) & 1;
        hp::mbar_wait(bar_empty + 8 * s, round ^ 1);
        hp::mbar_arrive_expect_tx(bar_full + 8 * s, 2 * kTileBytes);
        const uint32_t st = kv_s + s * 2 * kTileBytes;
        hp::tma_load_at(st, &map_ka, bar_full + 8 * s, 0, it * kBK, h, n);
        hp::tma_load_at(st + Blk::kPanelA, &map_kb, bar_full + 8 * s, 64, it * kBK, h, n);
        hp::tma_load_at(st + kTileBytes, &map_va, bar_full + 8 * s, 0, it * kBK, h, n);
        hp::tma_load_at(st + kTileBytes + Blk::kPanelA, &map_vb, bar_full + 8 * s, 64,
                        it * kBK, h, n);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = warp >> 2;
  const int r0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);   // and r0 + 8
  const uint32_t q_a = q_s + wg * 64 * 128;
  const uint32_t q_b = q_s + Blk::kQA + wg * 64 * 64;
  // this lane's two rows of the tables (rows past S read the last: never stored)
  const float* ta = T + (((long long)n * H + h) * S + min(r0, S - 1)) * 2 * K;
  const float* tb = T + (((long long)n * H + h) * S + min(r0 + 8, S - 1)) * 2 * K;
  float wa[16], wb[16];                // T[r, K + kw] of this lane's columns
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    wa[2 * j] = ta[K + c], wa[2 * j + 1] = ta[K + c + 1];
    wb[2 * j] = tb[K + c], wb[2 * j + 1] = tb[K + c + 1];
  }
  float oa[32], ob[16];                // output features 0-63 and 64-95
#pragma unroll
  for (int i = 0; i < 32; ++i) oa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) ob[i] = 0.f;
  float m0 = kNeg, m1 = kNeg;
  float l0 = 0.f, l1 = 0.f;

  hp::mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t k_s = kv_s + s * 2 * kTileBytes;
    const uint32_t v_s = k_s + kTileBytes;
    hp::mbar_wait(bar_full + 8 * s, (it / kStages) & 1);

    float sc[kBK / 2];
    hp::pin(sc);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::wgmma_ss(sc, hp::smem_desc(q_a) + kk * hp::kDescKStep,
                   hp::smem_desc(k_s) + kk * hp::kDescKStep, kk > 0);
    hp::wgmma_ss(sc, hp::head_desc<32>(q_b), hp::head_desc<32>(k_s + Blk::kPanelA), 1);
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::pin(sc);

    // the bias, in log2 units, then the scaled score
    const float ha0 = ta[2 * it], ha1 = ta[2 * it + 1];
    const float hb0 = tb[2 * it], hb1 = tb[2 * it + 1];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int w = 2 * (j & 7);
      const float ha = j < 8 ? ha0 : ha1, hb = j < 8 ? hb0 : hb1;
      sc[4 * j] = fmaf(sc[4 * j], scale_log2, ha + wa[w]);
      sc[4 * j + 1] = fmaf(sc[4 * j + 1], scale_log2, ha + wa[w + 1]);
      sc[4 * j + 2] = fmaf(sc[4 * j + 2], scale_log2, hb + wb[w]);
      sc[4 * j + 3] = fmaf(sc[4 * j + 3], scale_log2, hb + wb[w + 1]);
    }

    float mx0, mx1, sum0, sum1;
    hp::row_max(sc, mx0, mx1);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = hp::fast_exp2(m0 - mn0), corr1 = hp::fast_exp2(m1 - mn1);
    hp::exp_rows(sc, 1.f, mn0, mn1, sum0, sum1);
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
    rescale_rows(oa, corr0, corr1);
    rescale_rows(ob, corr0, corr1);
    uint32_t pa[kBK / 4];
    hp::pack_rows(sc, 1.f, 1.f, pa);
    const uint64_t va = hp::smem_desc(v_s), vb = hp::head_desc<32>(v_s + Blk::kPanelA);
    hp::pin(pa);
    hp::pin(oa);
    hp::pin(ob);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      hp::wgmma_rs(oa, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                   va + kk * hp::kDescRowStep, 1);
      hp::wgmma_rs(ob, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                   vb + kk * hp::head_row_step<32>(), 1);
    }
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::pin(oa);
    hp::pin(ob);
    hp::pin(pa);
    if (lane == 0) hp::mbar_arrive(bar_empty + 8 * s);
  }

  l0 = fmaxf(hp::quad_sum(l0), 1e-20f);
  l1 = fmaxf(hp::quad_sum(l1), 1e-20f);
  const long long da = dst.row(n, r0, S), db = dst.row(n, r0 + 8, S);
  bf16* oh_ = o + h * oh;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (da >= 0)
      *reinterpret_cast<uint32_t*>(oh_ + da + 8 * j + c0) =
          hp::pack_bf16(oa[4 * j] / l0, oa[4 * j + 1] / l0);
    if (db >= 0)
      *reinterpret_cast<uint32_t*>(oh_ + db + 8 * j + c0) =
          hp::pack_bf16(oa[4 * j + 2] / l1, oa[4 * j + 3] / l1);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (da >= 0)
      *reinterpret_cast<uint32_t*>(oh_ + da + 64 + 8 * j + c0) =
          hp::pack_bf16(ob[4 * j] / l0, ob[4 * j + 1] / l0);
    if (db >= 0)
      *reinterpret_cast<uint32_t*>(oh_ + db + 64 + 8 * j + c0) =
          hp::pack_bf16(ob[4 * j + 2] / l1, ob[4 * j + 3] / l1);
  }
}

cudaError_t launch_relpos(const CUtensorMap (&m)[6], const float* T, bf16* o, int N, int H,
                          float scale_log2, long long oh, const RelposOut& dst,
                          cudaStream_t s) {
  using Blk = FlashBlock80;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_relpos_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Blk::kSmem);
  if (e != cudaSuccess) return e;
  constexpr int S = Blk::kSide * Blk::kSide;
  const dim3 grid((S + Blk::kRows - 1) / Blk::kRows, H, N);
  flash_relpos_kernel<<<grid, Blk::kThreads, Blk::kSmem, s>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], T, o, H, scale_log2, oh, dst);
  return cudaGetLastError();
}

// ------------------------------ bf16, Dh 80, rel-pos bias, windows resident --
// The heads-of-80 core over short sequences, S = K * K <= 256 tokens (K <= 16:
// SAM's 14 x 14 windows), one (sequence, head) pair at a time with its whole
// q, K and V in shared memory. The form above, run over windows, spent a
// 168 KB block on a window's 128 query rows and two key tiles: 6,400 blocks
// of one an SM at 8 x 25 windows x 16 heads, each paying its loads' latency
// bare, K and V loaded twice a window, and the bias tables a second launch
// and an f32 round trip through device memory. Here:
//
// * A persistent grid, one block an SM, walks pairs b, b + G, ... (pair p
//   is sequence p / H, head p % H, so the card reads whole qkv rows). Two
//   (q, K) stages and one V stage are filled by TMA, the next pair's q and K
//   while this pair's products run and its V while the next pair's first
//   scores run (thread 0 issues each load at the end of a pair, once every
//   warp has freed the slot); the block's two warpgroups take the pair's
//   64-row query slabs in turn (0, 2 and 1, 3).
// * Heads of 80 are two panels: features 0-63 in 128-byte rows (128-byte
//   swizzle) and 64-79 in 32-byte rows (32-byte swizzle), so a row is 160
//   bytes and no zero feature is multiplied. q is held in raster order, its
//   rows padded to a multiple of 8 (the last slab starts at the last 64 rows
//   and stores only those after the slab before); K and V in 16 slots a
//   grid row, slot 16 kh + kw, by a 5-D map ([80, kw, kh, head, sequence])
//   whose bounds give zeros at kw >= K and kh >= K. So a score column's key
//   row kh is known at compile time and its kw is one of four values a lane.
//   Only those empty slots are masked: SAM masks no key of a window, its
//   padded positions (q, k and v the qkv bias) among them.
// * All keys are one score tile: q k^T m64n224k16 over five k16 steps, the
//   softmax once over the whole row with its exact max, p rounded to bf16,
//   p v m64n64k16 + m64n16k16 over 14 key steps. At K 15-16 (256 slots) the
//   keys are two tiles of 128 with the usual rescale: 128 score registers
//   beside the rest would spill.
// * The bias tables are made in the block: the layer's Rh and Rw, [2 K - 1,
//   80] bf16 each and shared by the heads, are loaded once a block as rows
//   0-31 and 32-63 of a [64, 80] operand; each slab's q . Rh and q . Rw come
//   from one m64n64k16 product over the resident q (f32 accumulation),
//   issued with q k^T and landed first, and each warp writes its own 16 rows
//   (times log2 e) to a tile of its own in shared memory, from which each
//   score adds Th[r, qh - kh + K - 1] + Tw[r, qw - kw + K - 1] as
//   fma(q . k, scale log2 e, Th + Tw): the form above's arithmetic. No table
//   scratch, no second launch.
// * Each warp stages its 16 output rows in its table tile and stores whole
//   160-byte head rows, 16 bytes a lane: 4-byte stores from the accumulator
//   layout write every sector in halves and took 0.31 ms a launch, not 0.23.
// Shared memory at K <= 14: two (q, K) stages of 67 KB, V 35 KB, the tables
// 10 KB, eight warps' tiles 34 KB (214 KB); at K 15-16 one (q, K) stage.
// At 8 x 25 windows x 16 heads on an H100 (80GB HBM3, 700 W): 0.229-0.233
// ms, tables included (the form above 0.68 with its tables); without its
// loads after the first pair 0.222-0.225: the SM's own work (exponentials,
// products, the bias) bounds it, not the bytes (least 0.110 ms).

__host__ __device__ constexpr int align1k(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// kKR: key grid rows held, 14 (K <= 14) or 16
template <int kKR>
struct WindowBlock {
  static constexpr int kKeys = 16 * kKR;                        // key slots 16 kh + kw
  static constexpr int kQRows = kKR * kKR < 64 ? 64 : (kKR * kKR + 7) / 8 * 8;
  static constexpr int kStages = kKR <= 14 ? 2 : 1;             // (q, K) stages
  static constexpr int kQA = kQRows * 128;                      // q's panel A
  static constexpr int kKA = kKeys * 128;                       // K's (at kQA)
  static constexpr int kQB = kQA + kKA;                         // q's panel B
  static constexpr int kKB = kQB + align1k(kQRows * 32);        // K's
  static constexpr int kStageBytes = kKB + align1k(kKeys * 32);
  static constexpr int kV = kStages * kStageBytes;              // V: panel A, then B at kKA
  static constexpr int kR = kV + kKA + align1k(kKeys * 32);     // Rh, Rw: panel A, then B
  static constexpr int kRB = 64 * 128;
  static constexpr int kT = kR + kRB + 64 * 32;                 // the warps' table tiles
  static constexpr int kTStride = 68;                           // floats a tile row
  static constexpr int kTWarp = 16 * kTStride * 4;              // also 16 output rows of 176 B
  static constexpr int kBar = kT + 8 * kTWarp;
  // two warpgroups and no producer of their own: registers are allocated
  // to warps four at a time, so a ninth warp (or a third warpgroup for
  // setmaxnreg) would cap the compile at 168 a thread and serialise the
  // n224 wgmma for want of them; at 256 threads the cap is 255
  static constexpr int kThreads = 2 * 128;
  static constexpr int kSmem = kBar + 8 * (2 * kStages + 3) + 1024;
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
  static_assert(kQA % 1024 == 0 && kKA % 1024 == 0 && kStageBytes % 1024 == 0,
                "swizzled panels start on 1,024-byte boundaries");
  static_assert(16 * 176 <= kTWarp && kTWarp % 16 == 0, "a warp's output rows fit its tile");
};

// one box of a 5-D map at (c0 .. c4) into shared memory at dst, counted on bar
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// The descriptor of a tile of 16-feature bf16 rows (32 bytes, one 32-byte
// swizzle atom) at a 256-byte aligned shared address: a group of eight rows
// is 256 bytes; a k16 step along an MN-major operand is 16 rows, 512 bytes
// (+32). K-major, the 16 features are one k16 step.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (16ull << 16) | (16ull << 32) |
         (3ull << 62);
}
constexpr uint64_t kSw32RowStep = 32;

// d[112] (+)= A[64 x 16] B[224 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[112], uint64_t a_desc, uint64_t b_desc,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111},"
      " %112, %113, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d[8] (+)= A[64 x 16] B[16 x 16], A from registers (a warp's 16 x 16
// fragment), B MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b_desc), "r"(accumulate));
}

// q k^T over a score tile: the whole window (n224, here) or half of it at
// K 15-16 (n128, attention_wgmma.cuh)
__device__ __forceinline__ void scores_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  hp::wgmma_ss(d, a, b, acc);
}
__device__ __forceinline__ void scores_ss(float (&d)[112], uint64_t a, uint64_t b, int acc) {
  wgmma_ss(d, a, b, acc);
}

template <int kKR>
__global__ void __launch_bounds__(WindowBlock<kKR>::kThreads, 1)
flash_relpos_kernel_windows(const __grid_constant__ CUtensorMap map_qa,
                            const __grid_constant__ CUtensorMap map_qb,
                            const __grid_constant__ CUtensorMap map_ka,
                            const __grid_constant__ CUtensorMap map_kb,
                            const __grid_constant__ CUtensorMap map_va,
                            const __grid_constant__ CUtensorMap map_vb,
                            const __grid_constant__ CUtensorMap map_rha,
                            const __grid_constant__ CUtensorMap map_rhb,
                            const __grid_constant__ CUtensorMap map_rwa,
                            const __grid_constant__ CUtensorMap map_rwb, bf16* __restrict__ o,
                            int N, int H, int S, int K, float scale_log2, long long oh,
                            const RelposOut dst) {
  using Blk = WindowBlock<kKR>;
  constexpr int kStages = Blk::kStages;
  // key slots a score tile: all of them at K <= 14 (n224), half at 15-16
  // (n128 twice, 128 score registers being too many beside the rest)
  constexpr int kChunks = kKR <= 14 ? 1 : 2;
  constexpr int kChunkKeys = Blk::kKeys / kChunks;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hp::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t v_s = base + Blk::kV;
  const uint32_t r_s = base + Blk::kR;
  const uint32_t bar_r = base + Blk::kBar;
  const uint32_t bar_v_full = bar_r + 8, bar_v_empty = bar_r + 16;
  const uint32_t bar_full = bar_r + 24;                  // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  const long long pairs = (long long)N * H;
  // block b takes pairs b, b + G, ...: the card works on a few whole
  // sequences at a time, every head of their qkv rows
  const int n_pairs = (int)((pairs - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const int q_rows = max(64, (S + 7) / 8 * 8);           // q's box: rows past S are zeros
  const int n_slabs = (S + 63) / 64;

  if (tid == 0) {
    hp::mbar_init(bar_r, 1);
    hp::mbar_init(bar_v_full, 1);
    hp::mbar_init(bar_v_empty, 8);                       // every warp
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(bar_full + 8 * s, 1);
      hp::mbar_init(bar_empty + 8 * s, 8);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  // this block's pair i: (sequence, head)
  auto pair = [&](int i) {
    const long long p = blockIdx.x + (long long)i * gridDim.x;
    return make_int2((int)(p / H), (int)(p % H));
  };
  // thread 0 loads: the tables once, and each pair's q and K into its stage
  // and its V, each as soon as every warp has freed the slot (end of a pair)
  auto load_qk = [&](int i) {
    const int n = pair(i).x, h = pair(i).y;
    const int st = i % kStages;
    const uint32_t stage = base + st * Blk::kStageBytes, full = bar_full + 8 * st;
    hp::mbar_arrive_expect_tx(full, (q_rows + Blk::kKeys) * 160);
    hp::tma_load_at(stage, &map_qa, full, 0, 0, h, n);
    hp::tma_load_at(stage + Blk::kQB, &map_qb, full, 64, 0, h, n);
    tma_load_5d(stage + Blk::kQA, &map_ka, full, 0, 0, 0, h, n);
    tma_load_5d(stage + Blk::kKB, &map_kb, full, 64, 0, 0, h, n);
  };
  auto load_v = [&](int i) {
    const int n = pair(i).x, h = pair(i).y;
    hp::mbar_arrive_expect_tx(bar_v_full, Blk::kKeys * 160);
    tma_load_5d(v_s, &map_va, bar_v_full, 0, 0, 0, h, n);
    tma_load_5d(v_s + Blk::kKA, &map_vb, bar_v_full, 64, 0, 0, h, n);
  };
  if (tid == 0) {
    hp::mbar_arrive_expect_tx(bar_r, 64 * 160);
    hp::tma_load_at(r_s, &map_rha, bar_r, 0, 0, 0, 0);
    hp::tma_load_at(r_s + 32 * 128, &map_rwa, bar_r, 0, 0, 0, 0);
    hp::tma_load_at(r_s + Blk::kRB, &map_rhb, bar_r, 64, 0, 0, 0);
    hp::tma_load_at(r_s + Blk::kRB + 32 * 32, &map_rwb, bar_r, 64, 0, 0, 0);
    for (int i = 0; i < kStages && i < n_pairs; ++i) load_qk(i);
    load_v(0);
  }
  __syncwarp();

  // warpgroup wg takes slabs wg, wg + 2 of each pair; each warp its 16 rows
  // of a slab, a lane rows g and g + 8 of them
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  float* tile = reinterpret_cast<float*>(smem_raw + (base - raw) + Blk::kT) +
                warp * (Blk::kTWarp / 4);
  float* t0 = tile + g * Blk::kTStride;                  // this lane's two rows
  float* t1 = t0 + 8 * Blk::kTStride;
  // this lane's key columns in a grid row of 16 slots: kw = 8 jj + 2 t + e
  bool kw_ok[4];
  int kw_at[4];                                          // kw, clamped to a real column
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int kw = 8 * (c >> 1) + 2 * t + (c & 1);
    kw_ok[c] = kw < K;
    kw_at[c] = min(kw, K - 1);
  }
  hp::mbar_wait(bar_r, 0);

  for (int i = 0; i < n_pairs; ++i) {
    const int n = pair(i).x, h = pair(i).y;
    const int st = i % kStages;
    const uint32_t stage = base + st * Blk::kStageBytes;
    const uint32_t qa = stage, ka = stage + Blk::kQA, qb = stage + Blk::kQB, kb = stage + Blk::kKB;
    bf16* oh_ = o + h * oh;
    // the sequence's frame and its top-left cell in the grid (window 0: the
    // frame's whole grid)
    const int nw = dst.window ? (dst.grid + K - 1) / K : 1;
    const int f = n / (nw * nw), w = n - f * nw * nw;
    const int y0 = (w / nw) * K, x0 = (w - (w / nw) * nw) * K;
    const long long f_off = f * dst.ob;
    hp::mbar_wait(bar_full + 8 * st, (i / kStages) & 1);
    bool v_ready = false;

    for (int s = wg; s < n_slabs; s += 2) {
      const bool last = s + 2 >= n_slabs;               // this warpgroup's last slab of the pair
      const int q0 = s < n_slabs - 1 ? 64 * s : q_rows - 64;
      // this lane's rows (padded rows read a real row's coordinates: never stored)
      const int r0 = q0 + (warp & 3) * 16 + g, r1 = r0 + 8;
      const int qh0 = min(r0, S - 1) / K, qw0 = min(r0, S - 1) - qh0 * K;
      const int qh1 = min(r1, S - 1) / K, qw1 = min(r1, S - 1) - qh1 * K;
      float w0[4], w1[4];                               // Tw of this lane's four kw
      float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;   // row max (log2 units), row sums
      float oa[32], ob[8];                              // output features 0-63 and 64-79
      // the tables, issued first, land while the first score tile runs; no
      // wgmma, nor a write to its registers, sits in a branch (ptxas would
      // serialise them)
      float tt[32];                                     // q . Rh (columns 0-31), q . Rw (32-63)
      hp::pin(tt);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_ss(tt, hp::smem_desc(qa + q0 * 128) + kk * hp::kDescKStep,
                     hp::smem_desc(r_s) + kk * hp::kDescKStep, kk > 0);
      hp::wgmma_ss(tt, desc_sw32(qb + q0 * 32), desc_sw32(r_s + Blk::kRB), 1);
      hp::wgmma_commit();
#pragma unroll 1
      for (int ch = 0; ch < kChunks; ++ch) {
        float sc[kChunkKeys / 2];
        hp::pin(sc);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          scores_ss(sc, hp::smem_desc(qa + q0 * 128) + kk * hp::kDescKStep,
                    hp::smem_desc(ka + ch * kChunkKeys * 128) + kk * hp::kDescKStep, kk > 0);
        scores_ss(sc, desc_sw32(qb + q0 * 32), desc_sw32(kb + ch * kChunkKeys * 32), 1);
        hp::wgmma_commit();
        hp::wgmma_wait<1>();                            // the tables have landed
        if (ch == 0) {
          hp::pin(tt);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = 8 * j + 2 * t;
            *reinterpret_cast<float2*>(t0 + c) = make_float2(tt[4 * j] * hp::kLog2e,
                                                             tt[4 * j + 1] * hp::kLog2e);
            *reinterpret_cast<float2*>(t1 + c) = make_float2(tt[4 * j + 2] * hp::kLog2e,
                                                             tt[4 * j + 3] * hp::kLog2e);
          }
          __syncwarp();
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            w0[c] = t0[32 + qw0 + K - 1 - kw_at[c]];
            w1[c] = t1[32 + qw1 + K - 1 - kw_at[c]];
          }
        }
        hp::wgmma_wait<0>();                            // and the scores
        hp::pin(sc);
        if (last && ch == kChunks - 1 && lane == 0)
          hp::mbar_arrive(bar_empty + 8 * st);          // q and K read

        // the bias, in log2 units, then the scaled score; slots past the
        // window's rows and columns to -1e30
#pragma unroll
        for (int j2 = 0; j2 < kChunkKeys / 16; ++j2) {
          const int kh = ch * (kChunkKeys / 16) + j2;
          float h0 = 0.f, h1 = 0.f;
          const bool row_ok = kh < K;
          if (row_ok) {
            h0 = t0[qh0 + K - 1 - kh];
            h1 = t1[qh1 + K - 1 - kh];
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int x = 4 * (2 * j2 + (c >> 1)) + (c & 1);
            const bool ok = row_ok && kw_ok[c];
            sc[x] = ok ? fmaf(sc[x], scale_log2, h0 + w0[c]) : kNeg;
            sc[x + 2] = ok ? fmaf(sc[x + 2], scale_log2, h1 + w1[c]) : kNeg;
          }
        }
        // the softmax: one tile, the row's exact max; two, the second
        // rescales the first's sums and output (the first tile's correction
        // is 0, and its p v does not accumulate)
        float mx0, mx1, s0, s1;
        hp::row_max(sc, mx0, mx1);
        mx0 = fmaxf(m0, mx0);
        mx1 = fmaxf(m1, mx1);
        hp::exp_rows(sc, 1.f, mx0, mx1, s0, s1);
        if constexpr (kChunks > 1) {
          const float corr0 = hp::fast_exp2(m0 - mx0), corr1 = hp::fast_exp2(m1 - mx1);
          l0 = l0 * corr0 + s0;
          l1 = l1 * corr1 + s1;
          rescale_rows(oa, corr0, corr1);
          rescale_rows(ob, corr0, corr1);
        } else {
          l0 = s0;
          l1 = s1;
        }
        m0 = mx0;
        m1 = mx1;
        uint32_t pa[kChunkKeys / 4];
        hp::pack_rows(sc, 1.f, 1.f, pa);

        if (!v_ready) {
          hp::mbar_wait(bar_v_full, i & 1);
          v_ready = true;
        }
        const uint64_t va = hp::smem_desc(v_s + ch * kChunkKeys * 128);
        const uint64_t vb = desc_sw32(v_s + Blk::kKA + ch * kChunkKeys * 32);
        hp::pin(pa);
        hp::pin(oa);
        hp::pin(ob);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunkKeys / 16; ++kk) {
          hp::wgmma_rs(oa, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                       va + kk * hp::kDescRowStep, ch > 0 || kk > 0);
          wgmma_rs(ob, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                   vb + kk * kSw32RowStep, ch > 0 || kk > 0);
        }
        hp::wgmma_commit();
        hp::wgmma_wait_all();
        hp::pin(oa);
        hp::pin(ob);
        hp::pin(pa);
      }
      if (last && lane == 0) hp::mbar_arrive(bar_v_empty);

      // rows from 64 s on (the last slab starts earlier) into the grid's rows:
      // each warp stages its 16 rows in its table tile (free once the bias is
      // added; 176-byte rows, no bank conflict) and stores whole 160-byte
      // head rows, 16 bytes a lane, so every sector is written whole
      const float i0 = 1.f / fmaxf(hp::quad_sum(l0), 1e-20f);
      const float i1 = 1.f / fmaxf(hp::quad_sum(l1), 1e-20f);
      uint32_t* rows = reinterpret_cast<uint32_t*>(tile);    // [16][44] words
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 10; ++j) {
        const float* a = j < 8 ? oa + 4 * j : ob + 4 * (j - 8);
        rows[g * 44 + 4 * j + t] = hp::pack_bf16(a[0] * i0, a[1] * i0);
        rows[(g + 8) * 44 + 4 * j + t] = hp::pack_bf16(a[2] * i1, a[3] * i1);
      }
      __syncwarp();
      const long long da = r0 >= 64 * s && r0 < S && y0 + qh0 < dst.grid && x0 + qw0 < dst.grid
                               ? f_off + ((long long)(y0 + qh0) * dst.grid + x0 + qw0) * dst.os
                               : -1;
      const long long db = r1 >= 64 * s && r1 < S && y0 + qh1 < dst.grid && x0 + qw1 < dst.grid
                               ? f_off + ((long long)(y0 + qh1) * dst.grid + x0 + qw1) * dst.os
                               : -1;
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        const int k = lane + 32 * m;                    // row k / 10, its 16 bytes k % 10
        const int row = k / 10, c = k - 10 * (k / 10);
        const long long a = __shfl_sync(0xffffffffu, da, 4 * (row & 7));
        const long long b = __shfl_sync(0xffffffffu, db, 4 * (row & 7));
        const long long off = row < 8 ? a : b;
        if (off >= 0)
          *reinterpret_cast<uint4*>(oh_ + off + 8 * c) =
              *reinterpret_cast<const uint4*>(rows + row * 44 + 4 * c);
      }
      __syncwarp();
    }
    if (wg >= n_slabs) {                                // no slab of this pair: free it all the same
      if (lane == 0) hp::mbar_arrive(bar_empty + 8 * st);
      hp::mbar_wait(bar_v_full, i & 1);
      if (lane == 0) hp::mbar_arrive(bar_v_empty);
    }
    if (tid == 0) {
      // every warp is done with this pair's V, then (earlier) its q and K
      if (i + 1 < n_pairs) {
        hp::mbar_wait(bar_v_empty, i & 1);
        load_v(i + 1);
      }
      if (i + kStages < n_pairs) {
        hp::mbar_wait(bar_empty + 8 * st, (i / kStages) & 1);
        load_qk(i + kStages);
      }
    }
    __syncwarp();
  }
}

// A tensor map over `rank` (4 or 5) dimensions of bf16, dims[0] the head's
// contiguous features, strides in elements for dims 1.. (each a multiple of
// 8, the base 16-byte aligned), whose box box[] is [64, ...] 128-byte
// swizzled or [16, ...] 32-byte swizzled (box[0] features from a load's
// first coordinate; those past dims[0], and rows past any bound, arrive as
// zeros).
cudaError_t make_panel_map(CUtensorMap* map, const void* base, int rank,
                           const long long* dims, const long long* strides,
                           const int* box) {
  const hp::EncodeTiled encode = hp::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (box[0] != 64 && box[0] != 16) return cudaErrorInvalidValue;
  cuuint64_t d[5], st[4];
  cuuint32_t b[5], elem[5];
  for (int i = 0; i < rank; ++i) {
    if (dims[i] < 1 || box[i] < 1 || box[i] > 256) return cudaErrorInvalidValue;
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
    elem[i] = 1;
  }
  for (int i = 0; i < rank - 1; ++i) {
    // a dimension of one element never uses its stride: give it a valid one
    const long long s = dims[i + 1] > 1 ? strides[i] : strides[0];
    if (s <= 0 || s % 8 != 0) return cudaErrorInvalidValue;
    st[i] = (cuuint64_t)s * 2;
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), d, st, b, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The resident form's launch: q as [80, S, H, N] in boxes of q_rows rows,
// K and V as [80, K (kw), K (kh), H, N] in boxes of 16 x kKR slots, Rh and
// Rw as [80, 2 K - 1] in boxes of 32 rows; each in its two panels. A grid of
// min(SMs, pairs) blocks.
template <int kKR>
cudaError_t launch_windows(const void* q, const void* k, const void* v, const void* rh,
                           const void* rw, bf16* o, int N, int H, int S, int K,
                           const long long (&sb)[3], const long long (&sh)[3],
                           const long long (&ss)[3], float scale_log2, long long oh,
                           const RelposOut& dst, cudaStream_t s) {
  using Blk = WindowBlock<kKR>;
  CUtensorMap m[10];
  cudaError_t e;
  const int q_rows = max(64, (S + 7) / 8 * 8);
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    for (int p = 0; p < 2; ++p) {
      const int cols = p == 0 ? 64 : 16;
      if (i == 0) {
        const long long dims[4] = {80, S, H, N}, st[3] = {ss[0], sh[0], sb[0]};
        const int box[4] = {cols, q_rows, 1, 1};
        e = make_panel_map(&m[p], src[0], 4, dims, st, box);
      } else {
        const long long dims[5] = {80, K, K, H, N};
        const long long st[4] = {ss[i], K * ss[i], sh[i], sb[i]};
        const int box[5] = {cols, 16, kKR, 1, 1};
        e = make_panel_map(&m[2 * i + p], src[i], 5, dims, st, box);
      }
      if (e != cudaSuccess) return e;
    }
  }
  const void* tab[2] = {rh, rw};
  for (int i = 0; i < 2; ++i)
    for (int p = 0; p < 2; ++p) {
      const long long dims[4] = {80, 2 * K - 1, 1, 1}, st[3] = {80, 80, 80};
      const int box[4] = {p == 0 ? 64 : 16, 32, 1, 1};
      if ((e = make_panel_map(&m[6 + 2 * i + p], tab[i], 4, dims, st, box)) != cudaSuccess)
        return e;
    }
  int sms = 0, device = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(flash_relpos_kernel_windows<kKR>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, Blk::kSmem)) !=
          cudaSuccess)
    return e;
  const int grid = (long long)N * H < sms ? N * H : sms;
  flash_relpos_kernel_windows<kKR><<<grid, Blk::kThreads, Blk::kSmem, s>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8], m[9], o, N, H, S, K, scale_log2,
      oh, dst);
  return cudaGetLastError();
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

// SAM's attention with the decomposed relative-position bias at heads of 80,
// bf16: q, k, v [N, H, S, 80] strided views (the qkv rows of N sequences of
// S = K * K tokens), rh, rw the block's bf16 tables [2 K - 1, 80], o the
// merged output rows [frames, grid * grid, H * 80] with strides ob (a frame)
// and os (a row), oh (a head: 80). window 0: each sequence is a frame's grid
// (K = grid); else K = window and the sequences are the windows of the grid
// padded to a multiple of the window, frame by frame, their padded rows not
// written. The caller picks the form by `tables`: null, the resident form
// (flash_relpos_kernel_windows, one launch, its tables made in the block),
// which takes K <= 16 (S <= 256, SAM's windows); else an f32 scratch [N, H,
// S, 2 K] for K = 64 (SAM's global grid), two launches, the tables
// (relpos_table_kernel) and then the core (flash_relpos_kernel). Any other
// K, or a form that does not take K, is refused.
extern "C" int tt_flash_relpos(const void* q, const void* k, const void* v, const void* rh,
                               const void* rw, float* tables, void* o, int N, int H, int S,
                               int K, int grid, int window, long long qb, long long qh,
                               long long qs, long long kb, long long kh, long long ks,
                               long long vb, long long vh, long long vs, long long ob,
                               long long oh, long long os, void* stream) {
  if (!valid_shape(N, H, S, S, S) || K < 1 || K > 64 || S != K * K || grid < 1 ||
      (window == 0 ? K != grid : (K != window || window > grid)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RelposOut dst{grid, window, ob, os};
  const float scale_log2 = hp::kLog2e / sqrtf(80.f);
  if (tables == nullptr) {
    if (K > 16) return (int)cudaErrorInvalidValue;
    const long long sb[3] = {qb, kb, vb}, sh[3] = {qh, kh, vh}, ss[3] = {qs, ks, vs};
    return (int)(K <= 14 ? launch_windows<14> : launch_windows<16>)(
        q, k, v, rh, rw, static_cast<bf16*>(o), N, H, S, K, sb, sh, ss, scale_log2, oh, dst,
        s);
  }
  if (K != FlashBlock80::kSide) return (int)cudaErrorInvalidValue;
  const dim3 tgrid((S + 63) / 64, H, N);
  relpos_table_kernel<<<tgrid, 128, 64 * 2 * K * sizeof(float), s>>>(
      static_cast<const bf16*>(q), qb, qh, qs, static_cast<const bf16*>(rh),
      static_cast<const bf16*>(rw), tables, H, S, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap m[6];
  const void* src[3] = {q, k, v};
  const long long sb[3] = {qb, kb, vb}, sh[3] = {qh, kh, vh}, ss[3] = {qs, ks, vs};
  for (int i = 0; i < 3; ++i) {
    const int rows = i == 0 ? FlashBlock80::kRows : kBK;
    if ((e = hp::make_head_map(&m[2 * i], src[i], N, H, S, sb[i], sh[i], ss[i], rows, 80,
                               64)) != cudaSuccess ||
        (e = hp::make_head_map(&m[2 * i + 1], src[i], N, H, S, sb[i], sh[i], ss[i], rows, 80,
                               32)) != cudaSuccess)
      return (int)e;
  }
  return (int)launch_relpos(m, tables, static_cast<bf16*>(o), N, H, scale_log2, oh, dst, s);
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
