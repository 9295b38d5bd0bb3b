// Label propagation through a clip: for each target frame t = 1..T-1,
//   aff   = exp(<f_t, ctx> / temperature) * neighbourhood mask   (f32)
//   kth   = k-th largest of each query's affinity row (duplicates count)
//   aff   = where(aff >= kth, aff, 0) / (row sum + 1e-12)
//   seg_t = segs(ctx) . aff^T
// with the context = frame 0 plus the most recent n_slots propagated frames.
//
// Replaces the TPU kernel timetuning_tpu/ops/propagation_pallas.py:_kernel
// (reached through propagate_labels_batch_pallas).
//
// The TPU kernel carries its context FIFO in scratch across grid steps,
// which relies on the TPU grid running in order. CUDA blocks run in no
// order, so the FIFO is replaced by what it is: a window over earlier
// outputs. At target frame t the live context is frame 0 plus frames
// max(1, t - n_slots) .. t-1, whose features are feats[b, j] and whose maps
// are out[b, j - 1]. Dead context slots of the reference (zero affinity) are
// absent: they only add zeros to a row, and the k-th largest value is then
// the same.
//
// The work: the affinity products, 2 D flops for each (query, key in its
// window) pair of each live context frame (4.2e11 at the ViT-S/8 448 eval
// group: 2 x 25 frames x 3,136 patches, radius 12, D 384), whose features
// (bf16, 2.4 MB a frame) are read from L2 once for every tile of queries
// whose window box holds them; then each affinity is masked and compared
// with its row's running top-k. What bounds it on an H100 (700 W) at that
// group, bf16: not the products (alone 0.86 ms of the kernel's ~2.5) but
// the epilogue beside them, the window mask and the chunk test (+0.24) and
// the top-k lists (+1.1): per value a few instructions on four warps of a
// scheduler, which the other warpgroup's products hide only in part. f32
// takes three TF32 products and twice the key bytes (5.6 ms alone).
//
// Design. Only seg_t depends on earlier steps; the affinity rows, their
// top-k and their normalisation depend on the features alone. So the work
// is two kernels:
//   (a) prop_rows_kernel, ONE launch over (query tile, t, clip): a block owns
//       an 8 x 8 square of query patches of one target frame. The keys it
//       scores in each live context frame are the box that holds its
//       queries' windows (tile_plan in ops/propagation_cuda.py mirrors
//       make_plan): 32 x 32 keys at 56 x 56 patches and radius 12, the whole
//       14 x 14 frame at 196 patches. The box comes in chunks of whole box
//       rows, at most 128 keys, each as D / 64 TMA boxes [keys, 64 features]
//       (a 4-D tensor map over [frames, h, w, D], 128-byte swizzle; keys off
//       the grid arrive as zeros) through a ring in shared memory, filled by
//       one lane of a producer warpgroup. Two consumer warpgroups take the
//       chunks in turns, so one's epilogue runs under the other's products.
//       Products: wgmma m64n128 with f32 accumulators, in the features' own
//       type. bf16: the query tile is resident in shared memory as A, and a
//       bf16 x bf16 product is exact in f32, so the sums are the plain
//       version's in another order. f32: the 3xTF32 split, hi = tf32(x),
//       lo = tf32(x - hi) (made by the wrapper), a.b ~ hi.hi + hi.lo + lo.hi
//       by wgmma tf32, with the query chunks streamed beside the keys.
//       Epilogue, straight out of the accumulators (a row lives on a quad of
//       lanes): keys outside the query's window, off the grid or past the
//       chunk are masked (a zero-filled key would give exp(0) = 1), and each
//       lane keeps, for each of its two rows, a sorted list of the kList
//       largest affinities exp(acc / temperature) it has seen (the division
//       as the plain version does it on the card) with their keys,
//       duplicates as separate entries. A row's values go through its list
//       only when the exponential of the chunk's largest product reaches the
//       lane's threshold (exp is monotone; only then are the row's
//       exponentials taken), and a value enters only if it reaches it too:
//       the larger of the lane's own k-th value and the largest k-th value of
//       its quad (refreshed after every chunk), both lower bounds of the
//       row's k-th value. Every kept entry of the row is >= each lane's own k-th
//       value, so the union of the lists holds the kept set, unless a value
//       that fell out of a full list reaches the row's k-th value (each lane
//       keeps the largest that fell out). At the row's end the second
//       warpgroup's lists join the first's through shared memory, the quad
//       finds the k-th value of the union (k passes of quad max and count,
//       as ops/propagation.kth_largest_value), and writes the kept entries
//       compact: (frame * N + key patch, weight) pairs and a count, kRoom =
//       16 at most. A row whose kept set does not fit (exact ties at the
//       k-th value beyond kRoom or beyond a lane's list, or k > kList) is
//       flagged: count -1 and its (clip, patch) on the frame's overflow
//       list, counted. f32 inputs: a split value is the plain one's to ~1e-6
//       of itself, so the lists admit values down to kSlack below the
//       threshold and the values within kBand of the k-th are computed again
//       as the plain version does (finish_row).
//   (b) prop_seg_kernel, one launch per t on one stream: seg_t over the
//       compact rows (a lane a query, a warp a label channel at a time,
//       gathering each kept key's channels from frame 0's map or from an
//       earlier output). Blocks past the compact ones (kDenseBlocks at
//       most) take the frame's overflow rows: the exact dense pass of the
//       first design, one block a row, its window of each live frame scored
//       by f32 FMAs (a thread a key) into shared memory where the row fits
//       (3,125 values at 56 x 56 and radius 12), else into the block's own
//       slot of a scratch in device memory (25,088 at radius 0 with 7
//       recent frames: any length), its k-th value by masked-max passes of
//       the whole block (until it is found), its seg from those. A tile plan whose box is
//       wider than a chunk (a grid over kKeys patches wide with no
//       neighbourhood, or a radius over 60) sends every row to this pass,
//       as k > kList does.
// Rows hold kRoom entries (128 bytes) instead of the first design's dense
// window rows (3,125 floats at 56 x 56, radius 12): 19 MB of scratch a
// group instead of 1.9 GB, plus the dense pass's kDenseBlocks rows (6.6 MB
// there), and nothing else of a row goes to memory.
//
// TT_PROP_PHASES (tools/time_propagation.py --split) stops (a) after the
// products (1), after the mask and the chunk test (2) or after the top-k
// lists (3), and makes (b) return at once; 4, the default, is the kernel.
#include <type_traits>

#include "attention_wgmma.cuh"
#include "common.cuh"

#ifndef TT_PROP_PHASES
#define TT_PROP_PHASES 4
#endif

namespace {

namespace hp = tt::hopper;
using tt::bf16;

constexpr int kTile = 8;                 // query tile: kTile x kTile patches
constexpr int kKeys = 128;               // keys a chunk: the wgmma's N
constexpr int kList = 8;                 // values a lane keeps for each of its rows
constexpr int kRoom = 16;                // kept entries a compact row holds
constexpr int kThreads = 384;            // two consumer warpgroups + the producer's
constexpr int kRowBytes = 128;           // a swizzle row: 64 bf16 or 32 f32 features
constexpr int kQBytes = 64 * kRowBytes;  // a feature chunk of the query tile
constexpr int kKBytes = kKeys * kRowBytes;
constexpr int kMergeBytes = 128 * (2 * kList * 8 + 8);   // warpgroup 1's lists
constexpr int kTableBytes = kKeys * 4;   // column of a chunk -> key (row, x)
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxStages = 8;
constexpr int kSegThreads = 256;
constexpr int kSegQ = 32;                // queries a compact seg block
constexpr int kDenseKeys = kSegThreads;  // keys a tile of the dense pass
constexpr int kDenseBlocks = 264;        // blocks a seg launch gives its overflow rows
                                         // (two an SM of an H100)
constexpr int kBarMerge = 1;             // named barriers of the two consumer groups:
constexpr int kBarTurn = 2;              // the lists handed over; 2 + wg: wg's turn
// f32 (TF32 split): list values within kBand of a row's k-th value are
// computed again; the lists admit values down to kSlack below a threshold
constexpr float kBand = 1e-5f;
constexpr float kSlack = 2e-5f;

// The tile plan: query tiles, the key box of a tile (box_h x box_w patches)
// and its chunks (chunk_rows box rows each, at most kKeys keys).
struct Plan {
  int tiles_y, tiles_x, box_h, box_w, chunk_rows, chunks;
};

Plan make_plan(int h, int w, int radius) {
  Plan p;
  p.tiles_y = (h + kTile - 1) / kTile;
  p.tiles_x = (w + kTile - 1) / kTile;
  const long side = kTile + 2L * radius;
  p.box_w = radius > 0 && side < w ? (int)side : w;
  p.box_h = radius > 0 && side < h ? (int)side : h;
  p.chunk_rows = p.box_w <= kKeys ? (kKeys / p.box_w < p.box_h ? kKeys / p.box_w : p.box_h) : 0;
  p.chunks = p.chunk_rows > 0 ? (p.box_h + p.chunk_rows - 1) / p.chunk_rows : 0;
  return p;
}

struct Geometry {
  int B, T, N, h, w, D, n_slots, radius, topk;
  int box_h, box_w, chunk_rows, chunks, tiles_x;
};

// The exact dense pass: its blocks a seg launch (at most kDenseBlocks), the
// length of a row, each live frame's window side x side or, when the window
// covers the grid or there is no neighbourhood, its whole frame, and where
// the row lives: in shared memory behind the block's tiles where it fits,
// else in device memory (ops/propagation_cuda.dense_plan mirrors it). win:
// the window's side, 0 for the whole frame.
struct DensePlan {
  int blocks, win;
  long row_len;
  bool in_smem;
  long smem;
};

DensePlan make_dense_plan(int B, int T, int N, int D, int n_slots, int radius) {
  const long side = 2L * radius + 1;
  DensePlan d;
  d.win = radius > 0 && side * side < N ? (int)side : 0;
  d.blocks = (long)B * N < kDenseBlocks ? B * N : kDenseBlocks;
  const int live_max = 1 + (n_slots < T - 2 ? n_slots : T - 2);
  d.row_len = (long)live_max * (d.win > 0 ? d.win * d.win : N);
  // the key tile and its keys, the query, the block's partial maxima, sums
  // and counts, then the row (values and keys)
  const long fixed = 4L * (kDenseKeys * 34 + D + 3 * (kSegThreads / 32));
  d.in_smem = fixed + 8 * d.row_len <= kMaxSmem;
  d.smem = d.in_smem ? fixed + 8 * d.row_len : fixed;
  return d;
}

// the block's largest v (every thread gets it); red: kSegThreads / 32 floats
__device__ __forceinline__ float block_max(float v, float* red) {
  v = tt::warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < kSegThreads / 32; ++i) m = fmaxf(m, red[i]);
  __syncthreads();                                 // red is free again
  return m;
}

// the block's sum of v, the warps' sums added in order
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* red) {
  if constexpr (std::is_integral_v<V>) v = tt::warp_sum_int(v);
  else v = tt::warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  V m = red[0];
#pragma unroll
  for (int i = 1; i < kSegThreads / 32; ++i) m += red[i];
  __syncthreads();
  return m;
}

__device__ __forceinline__ int live_frames(int t, int n_slots) {
  return 1 + min(n_slots, t - 1);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int quad_sum_int(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// one box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into shared
// memory at dst, its bytes counted on bar (what lies off the tensor arrives
// as zeros)
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// d[64] (+)= A[64 x 8] B[128 x 8]^T in tf32, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a_desc,
                                           uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// v (> 0, >= thr) into the descending list top / key of one row: it goes
// after the values it equals, the smallest falls out. thr becomes the larger
// of itself and the list's k-th value; dropped, the largest value that fell
// out of the list so far (0 while it was not full). The lane's share of the
// kept set is whole unless dropped reaches the row's k-th value.
__device__ __forceinline__ void insert(float (&top)[kList], int (&key)[kList], float& thr,
                                       float& dropped, float v, int k_id, int topk) {
  dropped = fmaxf(dropped, fminf(v, top[kList - 1]));
#pragma unroll
  for (int i = kList - 1; i > 0; --i) {
    const bool up = v > top[i - 1];                 // v goes above top[i - 1]
    const bool here = !up && v > top[i];            // v lands at i
    top[i] = up ? top[i - 1] : (here ? v : top[i]);
    key[i] = up ? key[i - 1] : (here ? k_id : key[i]);
  }
  if (v > top[0]) {
    top[0] = v;
    key[0] = k_id;
  }
  float kth = top[0];
#pragma unroll
  for (int i = 1; i < kList; ++i) kth = i == topk - 1 ? top[i] : kth;
  thr = fmaxf(thr, kth);
}

// the products of chunk c into acc: D / 64 (bf16) or D / 32 (f32) stages of
// the ring, each released once the wgmmas that read it are done. The two
// consumer groups wait for the ring by turns (the named barrier kBarTurn +
// wg): a group starts waiting for its chunk's stages only once the other
// has waited for all of its own, so no stage's barrier is ever more than one
// phase ahead of a waiter and its parity names the phase. Once its waits
// are issued a group hands the turn over (hand_over: the other has a chunk
// left), and its products run under the other's epilogue.
template <bool kSplit>
__device__ __forceinline__ void chunk_products(float (&acc)[64], int c, int nd, int stages,
                                               uint32_t ring, uint32_t q_s, uint32_t bar_full,
                                               uint32_t bar_empty, int lane, int wg,
                                               bool hand_over) {
  constexpr int kStageBytes = kSplit ? 2 * (kQBytes + kKBytes) : kKBytes;
  int it = c * nd;
  int prev = -1;
  hp::named_bar_sync(kBarTurn + wg, 256);
  hp::pin(acc);
  hp::wgmma_fence();
  for (int d = 0; d < nd; ++d, ++it) {
    const int s = it % stages;
    hp::mbar_wait(bar_full + 8 * s, (it / stages) & 1);
    const uint32_t st = ring + s * kStageBytes;
    if constexpr (kSplit) {
      // [q hi][q lo][k hi][k lo]; the small terms first
      const uint64_t qh = hp::smem_desc(st), ql = hp::smem_desc(st + kQBytes);
      const uint64_t kh = hp::smem_desc(st + 2 * kQBytes);
      const uint64_t kl = hp::smem_desc(st + 2 * kQBytes + kKBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t step = kk * hp::kDescKStep;
        wgmma_tf32(acc, ql + step, kh + step, d > 0 || kk > 0);
        wgmma_tf32(acc, qh + step, kl + step, 1);
        wgmma_tf32(acc, qh + step, kh + step, 1);
      }
    } else {
      const uint64_t qd = hp::smem_desc(q_s + d * kQBytes), kd = hp::smem_desc(st);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_ss(acc, qd + kk * hp::kDescKStep, kd + kk * hp::kDescKStep, d > 0 || kk > 0);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<1>();                           // the stage before has been read
    if (prev >= 0 && lane == 0) hp::mbar_arrive(bar_empty + 8 * prev);
    prev = s;
  }
  if (hand_over) hp::named_bar_arrive(kBarTurn + (wg ^ 1), 256);
  hp::wgmma_wait_all();
  if (lane == 0) hp::mbar_arrive(bar_empty + 8 * prev);
  hp::pin(acc);
}

// compact row `row` (clip b's patch q of target frame t: bq = b N + q) goes
// to the exact dense pass of frame t's seg launch; BN = B N
__device__ __forceinline__ void flag_row(size_t row, int bq, int t, int BN, int* counts,
                                         int* ovf_rows, int* ovf_count) {
  counts[row] = -1;
  ovf_rows[(size_t)(t - 1) * BN + atomicAdd(ovf_count + t - 1, 1)] = bq;
}

// the k-th largest of the quad's candidates, duplicates counted (k passes of
// quad max and count, as ops/propagation.kth_largest_value); 0 if they hold
// fewer than k positive values
__device__ __forceinline__ float quad_kth(const float (&cand)[2 * kList], int topk) {
  float bound = INFINITY, kth = 0.f;
  int need = topk;
  bool done = false;
  for (int it = 0; it < topk; ++it) {
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < 2 * kList; ++i) mx = cand[i] < bound ? fmaxf(mx, cand[i]) : mx;
    mx = hp::quad_max(mx);
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < 2 * kList; ++i) cnt += cand[i] == mx && cand[i] < bound;
    cnt = quad_sum_int(cnt);
    if (!done && mx > 0.f && need <= cnt) {
      kth = mx;
      done = true;
    }
    need -= cnt;
    bound = mx;
  }
  return kth;
}

// What the kernel knows of the row it finishes besides its lists: where its
// features lie (split only: f32 query row fq, clip's features fclip), and
// where its compact row goes (flag_row's row, bq, t, BN).
struct RowEnd {
  const float* fq;
  const float* fclip;
  bool valid;                                      // the row is on the grid
  size_t row;
  int bq;
};

// The end of the lane's row H in warpgroup 0: the k-th largest of the quad's
// lists and of their partners' (warpgroup 1's lanes with the same rows,
// p_top / p_key in shared memory, 128 apart), duplicates counted, 0 if they
// hold fewer than k positive values (then every one is kept); the kept
// entries with their weights into the row's compact slots, each lane after
// the entries of the quad's lanes before it. The union holds the whole kept
// set unless a lane dropped a value at or above that k-th value (then it is
// the k-th of a part of the row, at most the row's, and the drop is seen):
// such a row, and one whose kept set does not fit, is flagged. H is known at
// compile time, so the lists stay in registers.
template <bool kSplit, int H>
__device__ __forceinline__ void finish_row(const float (&top)[2][kList],
                                           const int (&key)[2][kList], float dropped,
                                           const float* p_top, const int* p_key,
                                           float p_dropped, const Geometry& g,
                                           const RowEnd& r, int t, float inv_t, int lane,
                                           int2* entries, int* counts, int* ovf_rows,
                                           int* ovf_count) {
  float cand[2 * kList];
  int ck[2 * kList];
#pragma unroll
  for (int i = 0; i < kList; ++i) {
    cand[i] = top[H][i];
    ck[i] = key[H][i];
    cand[kList + i] = p_top[i * 128];
    ck[kList + i] = p_key[i * 128];
  }
  float kth = quad_kth(cand, g.topk);
  // f32 through the TF32 split: a value is the plain version's to ~1e-6 of
  // itself, which may order two values within that of each other otherwise,
  // or make a tie of them. The lists then admit values down to kSlack below
  // the threshold, so every value within kBand of the k-th is in a list or
  // was dropped from one; a dropped one there sends the row to the exact
  // dense pass, and the values of the lists within kBand of the k-th (two or
  // more) are computed again as the plain version does (one FMA chain over
  // the features in order, then exp(s * (1 / T))).
  const float lo = kSplit ? kth * (1.f - kBand) : kth;
  const float lost = hp::quad_max(fmaxf(dropped, p_dropped));
  bool overflow = lost > 0.f && lost >= lo;
  if (kSplit) {
    const float hi = kth * (1.f + kBand);
    int n_band = 0;
#pragma unroll
    for (int i = 0; i < 2 * kList; ++i) n_band += cand[i] >= lo && cand[i] <= hi;
    n_band = quad_sum_int(n_band);
    const bool again = kth > 0.f && n_band >= 2 && !overflow;
    if (__any_sync(0xffffffffu, again)) {
#pragma unroll
      for (int i = 0; i < 2 * kList; ++i)
        if (again && cand[i] >= lo && cand[i] <= hi) {
          const float* fk = r.fclip + (size_t)ck[i] * g.D;
          float dot = 0.f;
          for (int d = 0; d < g.D; ++d) dot = fmaf(r.fq[d], fk[d], dot);
          cand[i] = expf(dot * inv_t);
        }
      kth = quad_kth(cand, g.topk);
    }
  }
  int n = 0;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 2 * kList; ++i)
    if (cand[i] > 0.f && cand[i] >= kth) {
      ++n;
      sum += cand[i];
    }
  const int total = quad_sum_int(n);
  const float denom = hp::quad_sum(sum) + 1e-12f;
  overflow = overflow || total > kRoom;
  int at = n;
  const int q4 = lane & 3;
  int up = __shfl_up_sync(0xffffffffu, at, 1, 4);
  if (q4 >= 1) at += up;
  up = __shfl_up_sync(0xffffffffu, at, 2, 4);
  if (q4 >= 2) at += up;
  at -= n;
  if (r.valid) {
    if (overflow) {
      if (q4 == 0) flag_row(r.row, r.bq, t, g.B * g.N, counts, ovf_rows, ovf_count);
    } else {
      int2* dst = entries + r.row * kRoom;
#pragma unroll
      for (int i = 0; i < 2 * kList; ++i)
        if (cand[i] > 0.f && cand[i] >= kth)
          dst[at++] = make_int2(ck[i], __float_as_int(cand[i] / denom));
      if (q4 == 0) counts[r.row] = total;
    }
  }
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
prop_rows_kernel(const __grid_constant__ CUtensorMap map_q,     // bf16, or f32 hi
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_q_lo,  // f32 lo (split only)
                 const __grid_constant__ CUtensorMap map_k_lo,
                 const float* __restrict__ feats32,              // f32 features (split only)
                 int2* __restrict__ entries, int* __restrict__ counts,
                 int* __restrict__ ovf_rows, int* __restrict__ ovf_count, Geometry g,
                 int stages, float temperature) {
  constexpr int kStageBytes = kSplit ? 2 * (kQBytes + kKBytes) : kKBytes;
  constexpr int kFeat = kSplit ? 32 : 64;          // features a swizzle row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - hp::smem_u32(smem_raw));
  const int nd = g.D / kFeat;
  const uint32_t q_s = base;                       // bf16: the resident query tile
  const uint32_t ring = base + (kSplit ? 0 : nd * kQBytes);
  const uint32_t merge_s = ring + stages * kStageBytes;
  float* m_top = reinterpret_cast<float*>(smem + (merge_s - base));   // [2][kList][128]
  int* m_key = reinterpret_cast<int*>(m_top + 2 * kList * 128);     // [2][kList][128]
  float* m_drop = reinterpret_cast<float*>(m_key + 2 * kList * 128);   // [2][128]
  int* table = reinterpret_cast<int*>(m_drop + 2 * 128);              // [kKeys]
  const uint32_t bar_q = merge_s + kMergeBytes + kTableBytes;
  const uint32_t bar_full = bar_q + 8;             // [stages]
  const uint32_t bar_empty = bar_full + 8 * stages;

  const int tid = threadIdx.x;
  // broadcast from lane 0: the compiler then takes the warp index, and every
  // loop bound made from it, for uniform across the warp (a wgmma under a
  // branch it takes for divergent is serialised)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  const int b = blockIdx.z;
  const int t = blockIdx.y + 1;
  const int qy0 = (blockIdx.x / g.tiles_x) * kTile;
  const int qx0 = (blockIdx.x % g.tiles_x) * kTile;
  const int n_live = live_frames(t, g.n_slots);
  const int first_recent = t - (n_live - 1);
  const int n_chunks = n_live * g.chunks;
  // the tile's key box: its queries' windows, clipped to the grid
  const int x0 = g.box_w == g.w ? 0 : min(max(qx0 - g.radius, 0), g.w - g.box_w);
  const int y0 = g.box_h == g.h ? 0 : min(max(qy0 - g.radius, 0), g.h - g.box_h);

  if (g.topk > kList || g.chunks == 0) {
    // a lane's list cannot hold its share of the top k, or the box is wider
    // than a chunk: every row dense
    if (tid < kTile * kTile && qy0 + tid / kTile < g.h && qx0 + tid % kTile < g.w) {
      const int q = (qy0 + tid / kTile) * g.w + qx0 + tid % kTile;
      flag_row(((size_t)b * (g.T - 1) + t - 1) * g.N + q, b * g.N + q, t, g.B * g.N, counts,
               ovf_rows, ovf_count);
    }
    return;
  }

  if (tid == 0) {
    hp::mbar_init(bar_q, 1);
    for (int s = 0; s < stages; ++s) {
      hp::mbar_init(bar_full + 8 * s, 1);
      hp::mbar_init(bar_empty + 8 * s, 4);         // the warps of one consumer group
    }
    hp::mbar_init_fence();
  }
  // column c of a chunk: box row c / box_w (high half), patch x (low half);
  // columns past the chunk's keys get a row no grid has
  const int chunk_keys = g.chunk_rows * g.box_w;
  for (int c = tid; c < kKeys; c += kThreads)
    table[c] = c < chunk_keys ? ((c / g.box_w) << 16) | (x0 + c % g.box_w) : 0x7fff << 16;
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: one lane keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 8 && lane == 0) {
      const int q_frame = b * g.T + t;
      if constexpr (!kSplit) {
        hp::mbar_arrive_expect_tx(bar_q, nd * kQBytes);
        for (int d = 0; d < nd; ++d)
          tma_load_4d(q_s + d * kQBytes, &map_q, bar_q, d * kFeat, qx0, qy0, q_frame);
      }
      const uint32_t key_bytes = chunk_keys * kRowBytes;
      int it = 0;
      for (int c = 0; c < n_chunks; ++c) {
        const int live = c / g.chunks;
        const int k_frame = b * g.T + (live == 0 ? 0 : first_recent + live - 1);
        const int ky = y0 + (c % g.chunks) * g.chunk_rows;
        for (int d = 0; d < nd; ++d, ++it) {
          const int s = it % stages;
          hp::mbar_wait(bar_empty + 8 * s, ((it / stages) & 1) ^ 1);   // round 0 passes
          const uint32_t st = ring + s * kStageBytes;
          const uint32_t full = bar_full + 8 * s;
          if constexpr (kSplit) {
            hp::mbar_arrive_expect_tx(full, 2 * (kQBytes + key_bytes));
            tma_load_4d(st, &map_q, full, d * kFeat, qx0, qy0, q_frame);
            tma_load_4d(st + kQBytes, &map_q_lo, full, d * kFeat, qx0, qy0, q_frame);
            tma_load_4d(st + 2 * kQBytes, &map_k, full, d * kFeat, x0, ky, k_frame);
            tma_load_4d(st + 2 * kQBytes + kKBytes, &map_k_lo, full, d * kFeat, x0, ky,
                        k_frame);
          } else {
            hp::mbar_arrive_expect_tx(full, key_bytes);
            tma_load_4d(st, &map_k, full, d * kFeat, x0, ky, k_frame);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes chunks wg, wg + 2, ...; lane owns tile
  // rows r0 = 16 (warp % 4) + lane / 4 and r0 + 8, i.e. patches (qy, qx)
  // and (qy + 1, qx)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = warp >> 2;
  const int qy = qy0 + 2 * (warp & 3);
  const int qx = qx0 + (lane >> 2);
  const int rad = g.radius > 0 ? g.radius : 1 << 20;
  const float inv_t = 1.f / temperature;
  // a value enters a row's list if > 0 and >= admit(thr) (thr itself, or
  // kSlack below it for the split); a row off the grid (its query
  // zero-filled: every affinity 1) takes none
  const float least = __int_as_float(1);
  const auto admit = [least](float thr) {
    return kSplit ? fmaxf(thr * (1.f - kSlack), least) : thr;
  };
  float top[2][kList];
  int key[2][kList];
  float thr[2] = {qy < g.h && qx < g.w ? least : INFINITY,
                  qy + 1 < g.h && qx < g.w ? least : INFINITY};
  float dropped[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < kList; ++i) {
      top[h][i] = 0.f;
      key[h][i] = -1;
    }
#if TT_PROP_PHASES < 4
  float keep = 0.f;                                // TT_PROP_PHASES 2 only
#endif
  float acc[64];
  if (!kSplit) hp::mbar_wait(bar_q, 0);
  if (wg == 1) hp::named_bar_arrive(kBarTurn, 256);     // group 0 waits first
  for (int c = wg; c < n_chunks; c += 2) {
    chunk_products<kSplit>(acc, c, nd, stages, ring, q_s, bar_full, bar_empty, lane, wg,
                           c + 1 < n_chunks);
#if TT_PROP_PHASES >= 2
    // masked keys (outside the query's window, off the grid, past the
    // chunk) -inf in place of their products
    const int ky0 = y0 + (c % g.chunks) * g.chunk_rows;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      // columns 8 j + 2 (lane % 4) + e of rows r0 (acc[4 j + e]) and r0 + 8
      const int2 tk = *reinterpret_cast<const int2*>(table + 8 * j + 2 * (lane & 3));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pk = e ? tk.y : tk.x;
        const int ky = ky0 + (pk >> 16);
        const bool x_in = abs((pk & 0xffff) - qx) <= rad && ky < g.h;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool in = x_in && abs(ky - qy - h) <= rad;
          acc[4 * j + 2 * h + e] = in ? acc[4 * j + 2 * h + e] : -INFINITY;
        }
      }
    }
    // a row's values go through its list only if the chunk's largest
    // affinity reaches the row's threshold (after the first chunks, rarely):
    // exp is monotone, so that is exp of the largest product; only then are
    // the row's affinities exp(s / T) made in place of its products (0 where
    // masked), with the division as the plain version does it on the card
    // (PyTorch multiplies by the reciprocal of a host scalar divisor)
    const int f_base = (c / g.chunks == 0 ? 0 : first_recent + c / g.chunks - 1) * g.N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      mx = expf(mx * inv_t);
#if TT_PROP_PHASES == 2
      keep += mx;
#else
      if (__any_sync(0xffffffffu, mx >= admit(thr[h]))) {
#pragma unroll
        for (int i = 0; i < kKeys / 4; ++i) {
          float& a = acc[4 * (i >> 1) + 2 * h + (i & 1)];
          a = expf(a * inv_t);
        }
        // first a lower bound of the row's k-th value from this chunk alone:
        // the k-th largest of the quad lanes' two largest values, at most the
        // chunk's k-th largest; few values of the chunk reach it
        float m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int i = 0; i < kKeys / 4; ++i) {
          const float v = acc[4 * (i >> 1) + 2 * h + (i & 1)];
          m2 = fmaxf(m2, fminf(v, m1));
          m1 = fmaxf(m1, v);
        }
        float bound = INFINITY, kb = 0.f;
        int need = g.topk;
        bool done = false;
        for (int it = 0; it < g.topk; ++it) {
          const float mq =
              hp::quad_max(fmaxf(m1 < bound ? m1 : 0.f, m2 < bound ? m2 : 0.f));
          const int cnt = quad_sum_int((int)(m1 == mq && m1 < bound) +
                                       (int)(m2 == mq && m2 < bound));
          if (!done && mq > 0.f && need <= cnt) {
            kb = mq;
            done = true;
          }
          need -= cnt;
          bound = mq;
        }
        thr[h] = fmaxf(thr[h], kb);
        // the lane's candidates, a bit for each of its kKeys / 4 columns
        // (column i: acc[4 (i / 2) + 2 h + i % 2]); the warp takes them in
        // rounds, each lane its next one, so a round costs one insert however
        // the candidates lie across the lanes
        uint32_t cand = 0;
#pragma unroll
        for (int i = 0; i < kKeys / 4; ++i)
          cand |= (uint32_t)(acc[4 * (i >> 1) + 2 * h + (i & 1)] >= admit(thr[h])) << i;
        while (__any_sync(0xffffffffu, cand != 0)) {
          const int p = __ffs(cand) - 1;
          float v = 0.f;
#pragma unroll
          for (int i = 0; i < kKeys / 4; ++i) v = p == i ? acc[4 * (i >> 1) + 2 * h + (i & 1)] : v;
          if (cand != 0 && v >= admit(thr[h])) {
            const int pk = table[8 * (p >> 1) + 2 * (lane & 3) + (p & 1)];
            insert(top[h], key[h], thr[h], dropped[h], v,
                   f_base + (ky0 + (pk >> 16)) * g.w + (pk & 0xffff), g.topk);
          }
          cand &= cand - 1;
        }
      }
      // the row's k-th value is at least each lane's own
      thr[h] = hp::quad_max(thr[h]);
#endif
    }
#endif
  }
#if TT_PROP_PHASES < 4
  if (keep + thr[0] + top[1][0] + acc[0] == 1234.5f) counts[0] = 0;   // keeps the work
  return;
#endif

  // warpgroup 1 hands its lists over; warpgroup 0 merges and writes
  const int me = tid & 127;
  if (wg == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kList; ++i) {
        m_top[(h * kList + i) * 128 + me] = top[h][i];
        m_key[(h * kList + i) * 128 + me] = key[h][i];
      }
    m_drop[me] = dropped[0];
    m_drop[128 + me] = dropped[1];
    __threadfence_block();
    hp::named_bar_arrive(kBarMerge, 256);
    return;
  }
  hp::named_bar_sync(kBarMerge, 256);
  const size_t row0 = ((size_t)b * (g.T - 1) + t - 1) * g.N;
  const int q = qy * g.w + qx;
  const float* fclip = kSplit ? feats32 + (size_t)b * g.T * g.N * g.D : nullptr;
  const float* fq = kSplit ? fclip + ((size_t)t * g.N + q) * g.D : nullptr;
  finish_row<kSplit, 0>(top, key, dropped[0], m_top + me, m_key + me, m_drop[me], g,
                        RowEnd{fq, fclip, qy < g.h && qx < g.w, row0 + q, b * g.N + q}, t,
                        inv_t, lane, entries, counts, ovf_rows, ovf_count);
  finish_row<kSplit, 1>(top, key, dropped[1], m_top + kList * 128 + me,
                        m_key + kList * 128 + me, m_drop[128 + me], g,
                        RowEnd{fq + (kSplit ? (size_t)g.w * g.D : 0), fclip,
                               qy + 1 < g.h && qx < g.w, row0 + q + g.w, b * g.N + q + g.w},
                        t, inv_t, lane, entries, counts, ovf_rows, ovf_count);
}

template <typename TIn>
__global__ void __launch_bounds__(kSegThreads, 1)
prop_seg_kernel(const int2* __restrict__ entries, const int* __restrict__ counts,
                const int* __restrict__ ovf_rows, const int* __restrict__ ovf_count,
                const TIn* __restrict__ feats, const float* __restrict__ seg0,
                float* __restrict__ out, float* dense_rows, Geometry g, int K, int t,
                int win, int rows_in_smem, float temperature) {
#if TT_PROP_PHASES < 4
  return;
#endif
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_live = live_frames(t, g.n_slots);
  const int first_recent = t - (n_live - 1);
  const int q_blocks = (g.N + kSegQ - 1) / kSegQ;
  const size_t KN = (size_t)K * g.N;
  const float inv_t = 1.f / temperature;           // as the plain version on the card

  if (blockIdx.x < g.B * q_blocks) {
    // a compact row a lane; the block's 8 warps take the channels in turns
    const int b = blockIdx.x / q_blocks;
    const int q = (blockIdx.x % q_blocks) * kSegQ + lane;
    if (q >= g.N) return;
    const size_t row = ((size_t)b * (g.T - 1) + t - 1) * g.N + q;
    const int n = counts[row];
    if (n < 0) return;                             // an overflow row: the blocks below
    // entry i: its weight and its patch's offset in the clip's frame 0 maps
    // (bit i of from0) or in its earlier outputs (int offsets: the entry
    // point bounds (T - 1) K N)
    const float* seg_b = seg0 + (size_t)b * KN;
    float* out_b = out + (size_t)b * (g.T - 1) * KN;
    int off[kRoom];
    float wt[kRoom];
    uint32_t from0 = 0;
#pragma unroll
    for (int i = 0; i < kRoom; ++i) {
      off[i] = 0;
      wt[i] = 0.f;
      if (i < n) {
        const int2 e = entries[row * kRoom + i];
        const int j = e.x / g.N;
        const int p = e.x - j * g.N;
        from0 |= (uint32_t)(j == 0) << i;
        off[i] = j == 0 ? p : (j - 1) * (int)KN + p;
        wt[i] = __int_as_float(e.y);
      }
    }
    float* dst = out_b + (size_t)(t - 1) * KN + q;
    for (int k = warp; k < K; k += kSegThreads / 32) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kRoom; ++i)
        if (i < n) acc += wt[i] * ((from0 >> i) & 1u ? seg_b : out_b)[off[i] + (size_t)k * g.N];
      dst[(size_t)k * g.N] = acc;
    }
    return;
  }

  // the exact dense pass, one block an overflow row of this frame: the row
  // of the first design (each live frame's window, or its whole frame) with
  // its arithmetic: a thread a key, kDenseKeys keys x 32 features a tile in
  // shared memory, one FMA chain over the features in order, then
  // exp(s * (1 / T)) as the plain version on the card. The row's values and
  // keys go behind the tiles in shared memory, or to the block's slot of
  // dense_rows (2 x the longest row, in L2) where they do not fit
  extern __shared__ float dsm[];
  const int slots = win > 0 ? win * win : g.N;
  const int row_len = n_live * slots;
  const long row_max = (long)live_frames(g.T - 1, g.n_slots) * slots;
  float* ks = dsm;                                 // [kDenseKeys][33]
  int* tile_key = reinterpret_cast<int*>(ks + kDenseKeys * 33);   // [kDenseKeys]
  float* qf = reinterpret_cast<float*>(tile_key + kDenseKeys);    // [D]
  float* red = qf + g.D;                           // [8] maxima, [8] sums
  int* red_n = reinterpret_cast<int*>(red + 2 * (kSegThreads / 32));   // [8] counts
  const int first = blockIdx.x - g.B * q_blocks;
  const int stride = gridDim.x - g.B * q_blocks;
  float* rowv = rows_in_smem ? reinterpret_cast<float*>(red_n + kSegThreads / 32)
                             : dense_rows + 2 * row_max * first;   // [row_len]
  int* rowk = reinterpret_cast<int*>(rowv + row_max);   // frame * N + patch, or -1
  const int n_over = ovf_count[t - 1];
  for (int i = first; i < n_over; i += stride) {
    const int bq = ovf_rows[(size_t)(t - 1) * g.B * g.N + i];
    const int b = bq / g.N;
    const int q = bq - b * g.N;
    const int qy = q / g.w, qx = q % g.w;
    const TIn* fb = feats + (size_t)b * g.T * g.N * g.D;
    __syncthreads();                               // the last row is done with
    for (int d = threadIdx.x; d < g.D; d += kSegThreads)
      qf[d] = to_float(fb[((size_t)t * g.N + q) * g.D + d]);
    __syncthreads();
    for (int s0 = 0; s0 < row_len; s0 += kDenseKeys) {
      // this thread's slot of the tile: its key (frame * N + patch) and the
      // key's features, or -1 off the grid, outside the window, past the row
      {
        const int s = s0 + threadIdx.x;
        const int c = s / slots;
        const int sl = s - c * slots;
        const int frame = c == 0 ? 0 : first_recent + c - 1;
        const int ky = win > 0 ? qy + sl / win - g.radius : sl / g.w;
        const int kx = win > 0 ? qx + sl % win - g.radius : sl % g.w;
        const bool in = s < row_len && ky >= 0 && ky < g.h && kx >= 0 && kx < g.w &&
                        (g.radius <= 0 || (abs(ky - qy) <= g.radius && abs(kx - qx) <= g.radius));
        tile_key[threadIdx.x] = in ? frame * g.N + ky * g.w + kx : -1;
      }
      float dot = 0.f;
      for (int d0 = 0; d0 < g.D; d0 += 32) {
        __syncthreads();                           // the keys are known, the last tile read
        // a warp a key at a time, its lanes the 32 features: kBatch loads
        // issued before the first is stored, so the tile costs four trips to
        // L2, not one a load
        constexpr int kBatch = 8;
#pragma unroll
        for (int m0 = 0; m0 < kDenseKeys * 32 / kSegThreads; m0 += kBatch) {
          float v[kBatch];
#pragma unroll
          for (int m = 0; m < kBatch; ++m) {
            const int k_id = tile_key[warp + kSegThreads / 32 * (m0 + m)];
            v[m] = k_id >= 0 ? to_float(fb[(size_t)k_id * g.D + d0 + lane]) : 0.f;
          }
#pragma unroll
          for (int m = 0; m < kBatch; ++m) ks[(warp + kSegThreads / 32 * (m0 + m)) * 33 + lane] = v[m];
        }
        __syncthreads();
#pragma unroll 8
        for (int dd = 0; dd < 32; ++dd) dot += qf[d0 + dd] * ks[threadIdx.x * 33 + dd];
      }
      if (s0 + (int)threadIdx.x < row_len) {
        const int k_id = tile_key[threadIdx.x];
        rowv[s0 + threadIdx.x] = k_id >= 0 ? expf(dot * inv_t) : 0.f;
        rowk[s0 + threadIdx.x] = k_id;
      }
      __syncthreads();                             // tile_key is read
    }
    __syncthreads();
    // k-th largest value, duplicates counted (ops/propagation.kth_largest_value),
    // by the whole block: the largest value under the last, and how many
    // hold it, until k are counted (at once when the row's maximum ties k
    // times)
    float bound = INFINITY, kth = 0.f;
    for (int need = g.topk, it = 0; it < g.topk && need > 0; ++it) {
      float mx = -INFINITY;
      for (int j = threadIdx.x; j < row_len; j += kSegThreads)
        if (rowv[j] < bound) mx = fmaxf(mx, rowv[j]);
      mx = block_max(mx, red);
      int cnt = 0;
      for (int j = threadIdx.x; j < row_len; j += kSegThreads) cnt += rowv[j] == mx;
      need -= block_sum(cnt, red_n);
      if (need <= 0) kth = mx;
      bound = mx;
    }
    float s = 0.f;
    for (int j = threadIdx.x; j < row_len; j += kSegThreads)
      if (rowv[j] >= kth) s += rowv[j];
    const float denom = block_sum(s, red + kSegThreads / 32) + 1e-12f;
    // the row's weights in place of its affinities: kept ones / denom, the
    // rest 0
    for (int j = threadIdx.x; j < row_len; j += kSegThreads) {
      const float v = rowv[j];
      rowv[j] = v >= kth && v != 0.f ? v / denom : 0.f;
    }
    __syncthreads();
    for (int k = warp; k < K; k += kSegThreads / 32) {
      float part = 0.f;
#pragma unroll 2
      for (int j = lane; j < row_len; j += 32) {
        const float wv = rowv[j];
        if (wv != 0.f) {
          const int fj = rowk[j] / g.N;
          // frame fj's maps: frame 0's given, later ones earlier outputs
          const float* m =
              fj == 0 ? seg0 + b * KN : out + ((size_t)b * (g.T - 1) + fj - 1) * KN;
          part += m[(size_t)k * g.N + rowk[j] - fj * g.N] * wv;
        }
      }
      part = tt::warp_sum(part);
      if (lane == 0) out[((size_t)b * (g.T - 1) + t - 1) * KN + (size_t)k * g.N + q] = part;
    }
  }
}

// A 4-D tensor map over the features [frames, h, w, D] (bf16 or f32, D * size a
// multiple of 128 bytes) whose box is [1, rows, cols, one swizzle row of
// features], 128-byte swizzled.
cudaError_t make_feature_map(CUtensorMap* map, const void* base, bool is_bf16, int frames,
                             int h, int w, int D, int rows, int cols) {
  const hp::EncodeTiled encode = hp::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t es = is_bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)frames};
  const cuuint64_t strides[3] = {D * es, (cuuint64_t)w * D * es, (cuuint64_t)h * w * D * es};
  const cuuint32_t box[4] = {(cuuint32_t)(kRowBytes / es), (cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
      const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool kSplit>
cudaError_t launch_rows(const void* q_hi, const void* q_lo, const float* feats32,
                        int2* entries, int* counts,
                        int* ovf_rows, int* ovf_count, const Geometry& g, const Plan& p,
                        float temperature, cudaStream_t st) {
  constexpr int kStageBytes = kSplit ? 2 * (kQBytes + kKBytes) : kKBytes;
  const int nd = g.D / (kSplit ? 32 : 64);
  const int fixed = 1024 + (kSplit ? 0 : nd * kQBytes) + kMergeBytes + kTableBytes;
  int stages = (kMaxSmem - fixed - 8 * (1 + 2 * kMaxStages)) / kStageBytes;
  stages = stages < kMaxStages ? stages : kMaxStages;
  if (stages < 2) return cudaErrorInvalidValue;
  const int smem = fixed + stages * kStageBytes + 8 * (1 + 2 * stages);
  // no maps when every row goes dense (the kernel then reads none)
  CUtensorMap maps[4] = {};
  const int frames = g.B * g.T;
  cudaError_t e;
  if (p.chunk_rows > 0 && g.topk <= kList) {
    if ((e = make_feature_map(&maps[0], q_hi, !kSplit, frames, g.h, g.w, g.D, kTile,
                              kTile)) != cudaSuccess ||
        (e = make_feature_map(&maps[1], q_hi, !kSplit, frames, g.h, g.w, g.D, p.chunk_rows,
                              p.box_w)) != cudaSuccess)
      return e;
    maps[2] = maps[0];
    maps[3] = maps[1];
    if (kSplit &&
        ((e = make_feature_map(&maps[2], q_lo, false, frames, g.h, g.w, g.D, kTile, kTile)) !=
             cudaSuccess ||
         (e = make_feature_map(&maps[3], q_lo, false, frames, g.h, g.w, g.D, p.chunk_rows,
                               p.box_w)) != cudaSuccess))
      return e;
  }
  const auto kernel = prop_rows_kernel<kSplit>;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return e;
  kernel<<<dim3(p.tiles_y * p.tiles_x, g.T - 1, g.B), kThreads, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], feats32, entries, counts, ovf_rows, ovf_count, g,
      stages,
      temperature);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch_seg(const int2* entries, const int* counts, const int* ovf_rows,
                       const int* ovf_count, const TIn* feats, const float* seg0,
                       float* out, float* dense_rows, const Geometry& g, const DensePlan& d,
                       int K, float temperature, cudaStream_t st) {
  if (d.smem > kMaxSmem || (!d.in_smem && dense_rows == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t e;
  const auto kernel = prop_seg_kernel<TIn>;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)d.smem)) != cudaSuccess)
    return e;
  const int q_blocks = (g.N + kSegQ - 1) / kSegQ;
  // blocks for the overflow rows, beside the compact ones; they return at
  // once when the frame has none (most frames: a row overflows on exact or
  // near ties alone)
  for (int t = 1; t < g.T; ++t) {
    kernel<<<g.B * q_blocks + d.blocks, kSegThreads, d.smem, st>>>(
        entries, counts, ovf_rows, ovf_count, feats, seg0, out, dense_rows, g, K, t, d.win,
        (int)d.in_smem, temperature);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// The tile plan of an h x w patch grid at this radius: out[6] = tiles_y,
// tiles_x, box_h, box_w, chunk_rows, chunks (ops/propagation_cuda.tile_plan).
extern "C" int tt_propagate_plan(int h, int w, int radius, int* out) {
  if (h <= 0 || w <= 0 || radius < 0) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(h, w, radius);
  out[0] = p.tiles_y;
  out[1] = p.tiles_x;
  out[2] = p.box_h;
  out[3] = p.box_w;
  out[4] = p.chunk_rows;
  out[5] = p.chunks;
  return 0;
}

// feats: [B, T, h, w, D] L2-normalised features, bf16 (is_bf16) or f32; for
// f32 also their TF32 split hi, lo (same layout); seg0 [B, K, N] f32, out
// [B, T-1, K, N] f32. Scratch: entries [B, T-1, N, 16] int2, counts
// [B, T-1, N] int32, ovf_rows [T-1, B * N] int32, ovf_count [T-1] int32 (the
// overflow rows of each target frame, zeroed here), dense_rows
// [dense_blocks, 2 * row_len] f32 (the dense pass's rows where they do not
// fit shared memory; else unread, may be null). box_h, box_w, chunk_rows,
// dense_blocks, row_len: the caller's plans, checked against make_plan and
// make_dense_plan.
extern "C" int tt_propagate_labels(const void* feats, const void* hi, const void* lo,
                                   const float* seg0, float* out, void* entries,
                                   int* counts, int* ovf_rows, int* ovf_count,
                                   float* dense_rows, int is_bf16, int B, int T, int h,
                                   int w, int D, int K, int n_slots, int radius, int topk,
                                   int box_h, int box_w, int chunk_rows, int dense_blocks,
                                   int row_len, float temperature, void* stream) {
  if (B <= 0 || B > 65535 || T < 2 || T > 65536 || h <= 0 || w <= 0 || K <= 0 ||
      n_slots < 1 || topk < 1 || radius < 0 || D <= 0 || D % (is_bf16 ? 64 : 32) != 0 ||
      (long)T * h * w >= (1L << 31) || (long)B * h * w >= (1L << 31) ||
      (long)(T - 1) * K * h * w >= (1L << 31) ||
      (!is_bf16 && (hi == nullptr || lo == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(h, w, radius);
  const DensePlan dp = make_dense_plan(B, T, h * w, D, n_slots, radius);
  if (p.box_h != box_h || p.box_w != box_w || p.chunk_rows != chunk_rows ||
      dp.blocks != dense_blocks || dp.row_len != row_len)
    return (int)cudaErrorInvalidValue;
  const Geometry g{B, T, h * w, h, w, D, n_slots, radius, topk,
                   p.box_h, p.box_w, p.chunk_rows, p.chunks, p.tiles_x};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(ovf_count, 0, sizeof(int) * (T - 1), st);
  if (e != cudaSuccess) return (int)e;
  int2* ent = static_cast<int2*>(entries);
  if (is_bf16) {
    if ((e = launch_rows<false>(feats, nullptr, nullptr, ent, counts, ovf_rows, ovf_count, g, p,
                                temperature, st)) != cudaSuccess)
      return (int)e;
    e = launch_seg(ent, counts, ovf_rows, ovf_count, static_cast<const bf16*>(feats), seg0,
                   out, dense_rows, g, dp, K, temperature, st);
  } else {
    if ((e = launch_rows<true>(hi, lo, static_cast<const float*>(feats), ent, counts, ovf_rows,
                               ovf_count, g, p, temperature,
                               st)) != cudaSuccess)
      return (int)e;
    e = launch_seg(ent, counts, ovf_rows, ovf_count, static_cast<const float*>(feats), seg0,
                   out, dense_rows, g, dp, K, temperature, st);
  }
  return (int)e;
}
