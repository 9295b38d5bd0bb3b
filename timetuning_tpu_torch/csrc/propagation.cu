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
// What bounds it on the card: the affinity product, C*N*D multiply-adds per
// query row (5*196*384 = 376K at the eval shape), done in f32 on the CUDA
// cores because exp(x / 0.1) amplifies any product error tenfold (TF32 or
// bf16 tensor cores would move the top-k set). Then k masked-max passes over
// each 980-float row, and the seg product over the kept entries.
//
// Design. The TPU kernel carries its context FIFO in scratch across grid
// steps, which relies on the TPU grid running in order. CUDA blocks run in
// no order, so the FIFO is replaced by what it is: a window over earlier
// outputs. At target frame t the live context is frame 0 plus frames
// max(1, t - n_slots) .. t-1, whose features are feats[b, j] and whose maps
// are out[b, j - 1]. Dead context slots of the reference (zero affinity) are
// simply absent: they only add zeros to a row, and the k-th largest value is
// then the same.
//
// Only seg_t depends on earlier steps; the affinity rows, their top-k
// threshold and their normalisation depend on the features alone. So the
// work is two kernels:
//   (a) prop_affinity_kernel, ONE launch over (8-query tile, t, clip): the
//       affinity rows of every target frame at once (1,200 blocks at the
//       S/16 eval shape, against 50 if each step ran alone), top-k and
//       normalisation, written as rows P[b, t-1, q, live * slots] to a
//       scratch buffer;
//   (b) prop_seg_kernel, one launch per t on one stream: seg_t = segs . P_t^T
//       over the kept (nonzero) entries, reading maps that earlier launches
//       wrote.
// In (a) a block owns 8 query rows; it stages 256 keys x 32 features per
// shared-memory tile, one key per thread against all 8 queries, and keeps
// the 8 rows for the top-k, one warp per row. In (b) a warp owns one query
// row.
//
// Row layout. With radius r > 0 every key outside the (2r+1)^2 window of
// its query has affinity exactly 0, while exp(cos / 0.1) > 0 inside it. So
// when the window is smaller than the frame, a row stores only the window
// of each live context frame, slot (dy, dx) for key (qy+dy-r, qx+dx-r);
// slots off the grid hold 0. The k-th largest value and the kept set are
// those of the dense row: if the window holds at least k positive entries
// the threshold is one of them, and if it holds fewer the threshold is 0 in
// both layouts and every entry is kept. At 56x56 patches (ViT-S/8 at 448),
// r = 12: 5 x 625 floats a row instead of 5 x 3,136, and the scratch is
// 0.94 GB a clip instead of 4.7 GB. The block scores only the keys in the
// bounding box of its 8 queries' windows. With r = 0, or a window no
// smaller than the frame, a row holds all N keys of each context frame.
// The 8 rows stay in shared memory when they fit there (227 KB); otherwise
// the block builds them in place in the scratch rows of global memory.
#include "common.cuh"

namespace {

constexpr int kQ = 8;          // query rows per block (one warp each)
constexpr int kThreads = 256;
constexpr int kKeys = 256;     // key rows per shared-memory tile
constexpr int kDc = 32;        // feature columns per tile
constexpr int kKsLd = kDc + 1;
constexpr int kLoads = kKeys * kDc / 4 / kThreads;   // float4 loads per tile
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kSegK = 8;       // label channels per pass of the seg step

// live context frames at target frame t, and the first recent one
__device__ __forceinline__ int live_frames(int t, int n_slots) {
  return 1 + min(n_slots, t - 1);
}

__global__ void __launch_bounds__(kThreads)
prop_affinity_kernel(const float* __restrict__ feats, float* __restrict__ P,
                     int T, int N, int D, int row_max, int n_slots, int grid_w,
                     int radius, int win, int rows_in_smem, int topk,
                     float temperature) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                       // [D][kQ] target rows, transposed
  float* Ks = Qt + (size_t)D * kQ;      // [kKeys][kKsLd]

  const int b = blockIdx.z;
  const int t = blockIdx.y + 1;
  const int q0 = blockIdx.x * kQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_rows = min(kQ, N - q0);
  const int n_live = live_frames(t, n_slots);
  const int first_recent = t - (n_live - 1);
  const int slots = win > 0 ? win * win : N;     // per context frame
  const int row_len = n_live * slots;
  const float* fb = feats + (size_t)b * T * N * D;
  float* Pt = P + ((size_t)b * (T - 1) + t - 1) * N * row_max;
  // this block's rows, kQ of them, row_max floats apart
  float* rows = rows_in_smem ? Ks + kKeys * kKsLd : Pt + (size_t)q0 * row_max;

  for (int i = tid; i < n_rows * row_len; i += kThreads)
    rows[(size_t)(i / row_len) * row_max + i % row_len] = 0.f;
  for (int i = tid; i < kQ * D; i += kThreads) {
    const int q = i / D;
    const int d = i % D;
    Qt[d * kQ + q] = q < n_rows ? fb[((size_t)t * N + q0 + q) * D + d] : 0.f;
  }

  // the keys to score: the bounding box of the block's query windows
  const int grid_h = N / grid_w;
  int y0 = 0, y1 = grid_h - 1, x0 = 0, x1 = grid_w - 1;
  if (radius > 0) {
    const int qa = q0, qb = q0 + n_rows - 1;
    y0 = max(0, qa / grid_w - radius);
    y1 = min(grid_h - 1, qb / grid_w + radius);
    if (qa / grid_w == qb / grid_w) {
      x0 = max(0, qa % grid_w - radius);
      x1 = min(grid_w - 1, qb % grid_w + radius);
    }
  }
  const int bw = x1 - x0 + 1;
  const int n_box = (y1 - y0 + 1) * bw;

  for (int c = 0; c < n_live; ++c) {
    const int frame = c == 0 ? 0 : first_recent + c - 1;
    const float* kb = fb + (size_t)frame * N * D;
    for (int m0 = 0; m0 < n_box; m0 += kKeys) {
      float acc[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) acc[q] = 0.f;
      for (int d0 = 0; d0 < D; d0 += kDc) {
        // the tile as kLoads float4 loads per thread, all issued before the
        // first store so their latencies overlap
        float4 ld[kLoads];
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          const int i = tid + l * kThreads;
          const int kbox = m0 + i / (kDc / 4);
          ld[l] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (kbox < n_box) {
            const int m = (y0 + kbox / bw) * grid_w + x0 + kbox % bw;
            ld[l] = *reinterpret_cast<const float4*>(
                kb + (size_t)m * D + d0 + (i % (kDc / 4)) * 4);
          }
        }
        __syncthreads();
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          const int i = tid + l * kThreads;
          float* dst = Ks + (i / (kDc / 4)) * kKsLd + (i % (kDc / 4)) * 4;
          dst[0] = ld[l].x;
          dst[1] = ld[l].y;
          dst[2] = ld[l].z;
          dst[3] = ld[l].w;
        }
        __syncthreads();
        const float* kr = Ks + tid * kKsLd;
#pragma unroll 8
        for (int dd = 0; dd < kDc; ++dd) {
          const float kv = kr[dd];
          const float4 qa = *reinterpret_cast<const float4*>(Qt + (d0 + dd) * kQ);
          const float4 qb =
              *reinterpret_cast<const float4*>(Qt + (d0 + dd) * kQ + 4);
          acc[0] += qa.x * kv;
          acc[1] += qa.y * kv;
          acc[2] += qa.z * kv;
          acc[3] += qa.w * kv;
          acc[4] += qb.x * kv;
          acc[5] += qb.y * kv;
          acc[6] += qb.z * kv;
          acc[7] += qb.w * kv;
        }
      }
      const int kbox = m0 + tid;
      if (kbox < n_box) {
        const int my = y0 + kbox / bw;
        const int mx = x0 + kbox % bw;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          if (q >= n_rows) break;
          const int qy = (q0 + q) / grid_w;
          const int qx = (q0 + q) % grid_w;
          if (radius > 0 && (abs(qy - my) > radius || abs(qx - mx) > radius))
            continue;
          const int slot = win > 0 ? (my - qy + radius) * win + (mx - qx + radius)
                                   : my * grid_w + mx;
          rows[(size_t)q * row_max + c * slots + slot] = expf(acc[q] / temperature);
        }
      }
    }
  }
  __syncthreads();

  if (warp >= n_rows) return;
  const int qi = q0 + warp;
  const float* row = rows + (size_t)warp * row_max;

  // k-th largest value, duplicates counted (ops/propagation.kth_largest_value)
  float bound = INFINITY, kth = 0.f;
  int need = topk;
  bool done = false;
  for (int it = 0; it < topk; ++it) {
    float mx = -INFINITY;
    for (int j = lane; j < row_len; j += 32) {
      const float v = row[j];
      if (v < bound) mx = fmaxf(mx, v);
    }
    mx = tt::warp_max(mx);
    int cnt = 0;
    for (int j = lane; j < row_len; j += 32) {
      const float v = row[j];
      cnt += (v == mx && v < bound) ? 1 : 0;
    }
    cnt = tt::warp_sum_int(cnt);
    if (!done && need <= cnt) {
      kth = mx;
      done = true;
    }
    need -= cnt;
    bound = mx;
  }

  float s = 0.f;
  for (int j = lane; j < row_len; j += 32) {
    const float v = row[j];
    if (v >= kth) s += v;
  }
  const float denom = tt::warp_sum(s) + 1e-12f;
  // in place when the rows live in global memory (each lane rewrites only
  // the entries it read)
  float* prow = Pt + (size_t)qi * row_max;
  for (int j = lane; j < row_len; j += 32) {
    const float v = row[j];
    prow[j] = v >= kth ? v / denom : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
prop_seg_kernel(const float* __restrict__ P, const float* __restrict__ seg0,
                float* __restrict__ out, int T, int N, int K, int t,
                int row_max, int n_slots, int grid_w, int radius, int win) {
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kQ + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (qi >= N) return;
  const int n_live = live_frames(t, n_slots);
  const int first_recent = t - (n_live - 1);
  const int slots = win > 0 ? win * win : N;
  const int row_len = n_live * slots;
  // key of window slot s: (qy + s / win - r, qx + s % win - r)
  const int base = (qi / grid_w - radius) * grid_w + qi % grid_w - radius;
  const float* prow = P + (((size_t)b * (T - 1) + t - 1) * N + qi) * row_max;
  float* ob = out + (size_t)b * (T - 1) * K * N;
  const float* s0 = seg0 + (size_t)b * K * N;
  // up to kSegK label channels per pass over the row
  for (int k0 = 0; k0 < K; k0 += kSegK) {
    const int nk = min(kSegK, K - k0);
    float part[kSegK];
#pragma unroll
    for (int k = 0; k < kSegK; ++k) part[k] = 0.f;
    for (int j = lane; j < row_len; j += 32) {
      const float p = prow[j];
      if (p != 0.f) {
        const int c = j / slots;
        const int sl = j - c * slots;
        const int m = win > 0 ? base + (sl / win) * grid_w + sl % win : sl;
        const float* sv = c == 0
                              ? s0 + (size_t)k0 * N + m
                              : ob + ((size_t)(first_recent + c - 2) * K + k0) * N + m;
#pragma unroll
        for (int k = 0; k < kSegK; ++k)
          if (k < nk) part[k] += sv[(size_t)k * N] * p;
      }
    }
#pragma unroll
    for (int k = 0; k < kSegK; ++k) {
      const float v = tt::warp_sum(part[k]);
      if (lane == 0 && k < nk) ob[((size_t)(t - 1) * K + k0 + k) * N + qi] = v;
    }
  }
}

}  // namespace

// The floats of one scratch row: live context frames x slots per frame.
extern "C" int tt_propagate_row_floats(int T, int N, int n_slots, int radius) {
  const int live_max = 1 + (n_slots < T - 2 ? n_slots : T - 2);
  const long side = 2L * radius + 1;
  const long slots = radius > 0 && side * side < N ? side * side : N;
  return (int)(live_max * slots);
}

// scratch: [B, T-1, N, row_max] f32, row_max = tt_propagate_row_floats(...)
extern "C" int tt_propagate_labels(const float* feats, const float* seg0,
                                   float* scratch, float* out, int B, int T,
                                   int N, int D, int K, int n_slots, int grid_w,
                                   int radius, int topk, int row_max,
                                   float temperature, void* stream) {
  if (B <= 0 || B > 65535 || T < 2 || T > 65536 || N <= 0 || K <= 0 ||
      D % kDc != 0 || n_slots < 1 || grid_w <= 0 || N % grid_w != 0 ||
      topk < 1 || radius < 0 ||
      row_max != tt_propagate_row_floats(T, N, n_slots, radius))
    return (int)cudaErrorInvalidValue;
  const long side = 2L * radius + 1;
  const int win = radius > 0 && side * side < N ? (int)side : 0;
  const size_t smem_base = sizeof(float) * ((size_t)D * kQ + (size_t)kKeys * kKsLd);
  const size_t smem_rows = sizeof(float) * (size_t)kQ * row_max;
  const int rows_in_smem = smem_base + smem_rows <= kMaxSmem;
  const size_t smem = smem_base + (rows_in_smem ? smem_rows : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      prop_affinity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q_tiles = (N + kQ - 1) / kQ;
  prop_affinity_kernel<<<dim3(q_tiles, T - 1, B), kThreads, smem, st>>>(
      feats, scratch, T, N, D, row_max, n_slots, grid_w, radius, win,
      rows_in_smem, topk, temperature);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int t = 1; t < T; ++t) {
    prop_seg_kernel<<<dim3(q_tiles, B), kThreads, 0, st>>>(
        scratch, seg0, out, T, N, K, t, row_max, n_slots, grid_w, radius, win);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
