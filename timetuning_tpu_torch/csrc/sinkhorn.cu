// Sinkhorn-Knopp of one transport matrix, all iterations in one launch, in
// the diagonal-scaling form of ops/sinkhorn.sinkhorn with no process group:
//   Q = Q * valid / (sum Q + 1e-12)
//   c = 1 / (B * world_size + 1e-12), or 1 / (sum valid + 1e-12)
//   n_iters x { u = a * (Q b);  a = u > 0 ? a * (1/K) / (u + 1e-12) : 0
//               col = b * (Q^T a);  b = col > 0 ? b * c / (col + 1e-12) : 0 }
//   col = b * (Q^T a);  out[B, K] = (Q * a b^T / (col + 1e-12))^T
// Q is never rewritten: an iteration is a sweep over the resident matrix
// that reads it, with a zero marginal pinned to 0 (the materialising loop
// of the TPU kernel divides by 1e-12 there; elsewhere the two agree within
// rounding, as timetuning_tpu/ops/sinkhorn.py:75-84 notes). Two entries:
// Q [K, B], or the step's scores [B, K] row-major with exp(s / epsilon)
// taken as they load (torch's scores / epsilon, then exp).
//
// Replaces the TPU kernel timetuning_tpu/ops/sinkhorn_pallas.py:_kernel (:51)
// and its dynamic-marginal twin kern_dyn (:91), which keep the whole matrix
// resident in 16 MB of VMEM; the train step dispatches it on the card when
// no process group spans the batch (ops/sinkhorn.sinkhorn_assignment).
//
// What bounds it on the card: neither bytes (5 MB at [200, 6,272], read once
// into shared memory) nor operations, but the chain of n_iters reductions of
// a [K] vector across the blocks that hold the matrix. The design cuts the
// latency of each link:
//   - One block an SM: a block keeps its slab of `cols` columns, [cols, K]
//     with K contiguous (a sample's scores), in shared memory for the whole
//     run, loaded once. A matrix too large for the SMs' shared memory
//     together keeps its slabs in `out`, which the 50 MB L2 holds, and is
//     overwritten in place by the result.
//   - One sweep an iteration: a warp owns a column (its K values spread over
//     the lanes, KPL a lane, four columns in flight), reduces Q^T a across
//     the lanes, updates the column's b and adds Q[:, j] b_j into the lane's
//     partial row sums for the next iteration, from the same registers. The
//     last sweep writes the output instead. (K above 256: 32 rows a lane,
//     one column in flight, the lane's partials in shared memory.)
//   - Row partials summed in two levels, in a fixed order (results do not
//     depend on block timing): the 16 warps' partials in shared memory; the
//     blocks of a thread block cluster of 8 through distributed shared
//     memory, each member summing a slice of the rows over its cluster;
//     then one [K + 1] vector a cluster in device memory, one grid-wide
//     barrier (a counter in device memory; the launch is cooperative, so
//     every block is resident), and every block sums the clusters' vectors.
//     Slot K carries the valid count on the first reduction, and the total
//     mass is the sum of the first row sums: Q is scaled through a (a starts
//     at 1 / (total + 1e-12)), never rewritten.
// ops/sinkhorn_cuda.sinkhorn_plan mirrors the plan (tt_sinkhorn_plan); a
// matrix that no plan places is refused, never run another way.
//
// TT_SINK_PHASES (tools/time_small_kernels.py --split): 1 = the load and the
// store alone, 2 = + the n_iters grid barriers with no partials, 3 = + the
// partials summed across the warps, the cluster and the grid (no sweep over
// the slab), 4 = the kernel.
#include <cooperative_groups.h>

#include "common.cuh"

#ifndef TT_SINK_PHASES
#define TT_SINK_PHASES 4
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
constexpr int kUnroll = 4;             // columns a warp has in flight (KPL 8,
                                       // slab in shared memory)
constexpr int kMinCols = 16;
constexpr float kEps = 1e-12f;
constexpr int kMaxSmem = 232448;       // bytes a block may use on sm_90

struct Layout {                         // float offsets into dynamic smem
  int red, pb, a, b, slab, floats;
};

// mirrored by ops/sinkhorn_cuda.sinkhorn_plan (smem_bytes)
__host__ __device__ inline Layout layout(int K, int cols, int in_smem) {
  Layout l;
  const int K1 = K + 1;
  l.red = 0;                            // [kWarps][K + 1] the warps' partials
  l.pb = l.red + kWarps * K1;           // [K + 1] the block's, then the sums
  l.a = l.pb + K1;                      // [K] row scaling
  l.b = l.a + K;                        // [cols] column scaling
  l.slab = l.b + cols;                  // [cols][K | 1]
  l.floats = l.slab + (in_smem ? cols * (K | 1) : 0);
  return l;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// every block of the grid arrives once per call; `gen` counts the calls
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    const unsigned target = gridDim.x * (gen + 1);
    while (ld_acquire(counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// sum over the block of one value a thread, the same order in every block
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = tt::warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

enum Sweep { kPartials, kIterate, kLast, kOutputOnly };

template <int KPL, bool kScores, bool kSmemSlab>
__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_kernel(const float* __restrict__ src, const float* __restrict__ valid,
                float* out, float* part, int K, int B, int cols, int n_iters,
                float epsilon, float c_marginal) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K1 = K + 1;
  const Layout L = layout(K, cols, kSmemSlab);
  float* red = sm + L.red;
  float* pb = sm + L.pb;
  float* a = sm + L.a;
  float* b = sm + L.b;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * cols;
  const int ncol = max(0, min(cols, B - col0));
  const int ld = kSmemSlab ? (K | 1) : K;
  float* slab = kSmemSlab ? sm + L.slab : out + (size_t)col0 * K;
  const int n_cl = gridDim.x / kCluster;
  const int cid = blockIdx.x / kCluster;
  const unsigned rank = cluster.block_rank();
  unsigned* counter = reinterpret_cast<unsigned*>(part + 2 * (size_t)n_cl * K1);

  // the slab, [ncol][K]: exp(s / epsilon) of the scores rows, or Q's
  // columns; times the validity mask
  float nval = 0.f;
  if constexpr (kScores) {
    for (int i = tid; i < ncol * K; i += kThreads) {
      const int j = i / K, k = i - j * K;
      float v = expf(src[(size_t)col0 * K + i] / epsilon);
      if (valid != nullptr) v *= valid[col0 + j];
      slab[j * ld + k] = v;
    }
  } else {
    for (int i = tid; i < ncol * K; i += kThreads) {
      const int k = i / ncol, j = i - k * ncol;
      float v = src[(size_t)k * B + col0 + j];
      if (valid != nullptr) v *= valid[col0 + j];
      slab[j * ld + k] = v;
    }
  }
  if (valid != nullptr)
    for (int j = tid; j < ncol; j += kThreads) nval += valid[col0 + j];
  for (int j = tid; j < ncol; j += kThreads) b[j] = 1.f;
  nval = block_sum(nval, red);          // syncs: the slab is in place

  // column j's value at row lane + 32 i (0 past K)
  auto load_slab = [&](const float* col, int i) -> float {
    const int k = lane + 32 * i;
    if (k >= K) return 0.f;
    return kSmemSlab ? col[k] : __ldcg(col + k);
  };

  // the row scaling of row lane + 32 i: in registers for 8 rows a lane,
  // read from shared memory for 32 (the registers go to the columns)
  constexpr int kAvRegs = KPL <= 8 ? KPL : 1;
  float av[kAvRegs] = {};
  auto a_of = [&](int i) -> float {
    if constexpr (KPL <= 8) {
      return av[i];
    } else {
      const int k = lane + 32 * i;
      return k < K ? a[k] : 0.f;
    }
  };

  // one sweep over the block's columns; the partials land in pb (+ slot K)
  float c = c_marginal;
  auto sweep = [&](Sweep mode, float slot_k) {
    // the lane's partial row sums: registers for 8 rows a lane, its own
    // slots of the warp's row of red for 32 (the registers go to the column)
    constexpr int kPRegs = KPL <= 8 ? KPL : 1;
    float p[kPRegs] = {};
    float* pw = red + warp * K1;
    if constexpr (KPL > 8) {
#pragma unroll
      for (int i = 0; i < KPL; ++i)
        if (lane + 32 * i < K) pw[lane + 32 * i] = 0.f;
    }
    auto p_add = [&](int i, float q, float bj) {
      if constexpr (KPL <= 8) {
        p[i] = fmaf(q, bj, p[i]);
      } else {
        if (lane + 32 * i < K) pw[lane + 32 * i] = fmaf(q, bj, pw[lane + 32 * i]);
      }
    };
    if (TT_SINK_PHASES == 3 && (mode == kPartials || mode == kIterate)) {
#pragma unroll
      for (int i = 0; i < KPL; ++i) p_add(i, ncol > 0 ? 1.f : 0.f, 1.f);
    } else {
      // columns in flight: four with 8 rows a lane in shared memory, two
      // when the slab's addresses are device memory's, one with 32 rows
      constexpr int U = KPL > 8 ? 1 : kSmemSlab ? kUnroll : 2;
      for (int j0 = warp; j0 < ncol; j0 += kWarps * U) {
        // U columns at once, no branch between them: their loads, sums and
        // shuffles interleave
        float sv[U][KPL], bj[U], x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * kWarps;
          const bool live = j < ncol;
          const float* col = slab + (size_t)(live ? j : 0) * ld;
#pragma unroll
          for (int i = 0; i < KPL; ++i) sv[u][i] = live ? load_slab(col, i) : 0.f;
          bj[u] = live ? b[j] : 0.f;
          x[u] = 0.f;
        }
        if (mode != kPartials) {
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int i = 0; i < KPL; ++i) x[u] = fmaf(sv[u][i], a_of(i), x[u]);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int u = 0; u < U; ++u) x[u] += __shfl_xor_sync(0xffffffffu, x[u], o);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * kWarps;
          if (mode == kIterate || mode == kLast) {
            const float col = bj[u] * x[u];
            bj[u] = col > 0.f ? bj[u] * (c / (col + kEps)) : 0.f;
            if (lane == 0 && j < ncol) b[j] = bj[u];
          }
          if (mode == kLast || mode == kOutputOnly) {
            if (j < ncol) {
              const float scale = bj[u] / (bj[u] * x[u] + kEps);
              float* o = out + (size_t)(col0 + j) * K;
#pragma unroll
              for (int i = 0; i < KPL; ++i) {
                const int k = lane + 32 * i;
                if (k < K) o[k] = sv[u][i] * a_of(i) * scale;
              }
            }
          } else {
#pragma unroll
            for (int i = 0; i < KPL; ++i) p_add(i, sv[u][i], bj[u]);
          }
        }
      }
    }
    if (mode == kLast || mode == kOutputOnly) return;
    if constexpr (KPL <= 8) {
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int k = lane + 32 * i;
        if (k < K) pw[k] = p[i];
      }
    }
    __syncthreads();
    for (int k = tid; k < K; k += kThreads) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += red[w * K1 + k];
      pb[k] = v;
    }
    if (tid == 0) pb[K] = slot_k;
  };

  // pb summed over the grid into pb: the cluster's blocks through
  // distributed shared memory (member `rank` sums rows of its slice), one
  // vector a cluster in device memory, a grid barrier, the clusters' vectors
  // summed in order
  auto reduce = [&](int gen) {
    float* cp = part + (size_t)(gen & 1) * n_cl * K1;
    cluster.sync();
    const int per = (K1 + kCluster - 1) / kCluster;
    const int k0 = (int)rank * per, k1 = min(K1, k0 + per);
    for (int k = k0 + tid; k < k1; k += kThreads) {
      float part_r[kCluster];           // every load in flight, then the sum
#pragma unroll
      for (int r = 0; r < kCluster; ++r) part_r[r] = cluster.map_shared_rank(pb, r)[k];
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) v += part_r[r];
      cp[(size_t)cid * K1 + k] = v;
    }
    grid_barrier(counter, gen);
    for (int k = tid; k < K1; k += kThreads) {
      float v = 0.f;
      for (int q0 = 0; q0 < n_cl; q0 += 16) {     // 16 loads in flight, then the sum
        float part_q[16];
#pragma unroll
        for (int q = 0; q < 16; ++q)
          part_q[q] = q0 + q < n_cl ? __ldcg(cp + (size_t)(q0 + q) * K1 + k) : 0.f;
#pragma unroll
        for (int q = 0; q < 16; ++q) v += part_q[q];
      }
      pb[k] = v;
    }
    __syncthreads();
  };

  auto load_a = [&]() {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAvRegs; ++i) {
      const int k = lane + 32 * i;
      av[i] = k < K ? a[k] : 0.f;
    }
  };

#if TT_SINK_PHASES == 1
  for (int k = tid; k < K; k += kThreads) a[k] = 1.f;
  load_a();
  sweep(kOutputOnly, 0.f);
  return;
#elif TT_SINK_PHASES == 2
  for (int g = 0; g < max(n_iters, 1); ++g) grid_barrier(counter, g);
  for (int k = tid; k < K; k += kThreads) a[k] = 1.f;
  load_a();
  sweep(kOutputOnly, 0.f);
  return;
#endif

  // row sums (b = 1) and the valid count; the total mass; the marginal
  sweep(kPartials, nval);
  reduce(0);
  float t = 0.f;
  for (int k = lane; k < K; k += 32) t += pb[k];
  t = tt::warp_sum(t);                  // every warp, every block: one order
  if (valid != nullptr) c = 1.f / (pb[K] + kEps);
  const float r = 1.f / (float)K;
  const float a0 = 1.f / (t + kEps);
  __syncthreads();
  for (int k = tid; k < K; k += kThreads) a[k] = a0;
  for (int it = 0; it < n_iters; ++it) {
    if (it > 0) reduce(it);
    for (int k = tid; k < K; k += kThreads) {
      const float u = a[k] * pb[k];
      a[k] = u > 0.f ? a[k] * (r / (u + kEps)) : 0.f;
    }
    load_a();
    sweep(it + 1 == n_iters ? kLast : kIterate, 0.f);
  }
  if (n_iters == 0) {
    load_a();
    sweep(kOutputOnly, 0.f);
  }
}

template <int KPL, bool kScores, bool kSmemSlab>
void* kernel_ptr() {
  return reinterpret_cast<void*>(sinkhorn_kernel<KPL, kScores, kSmemSlab>);
}

void* pick(int K, bool scores, bool smem_slab) {
  if (K <= 256)
    return scores ? (smem_slab ? kernel_ptr<8, true, true>() : kernel_ptr<8, true, false>())
                  : (smem_slab ? kernel_ptr<8, false, true>() : kernel_ptr<8, false, false>());
  return scores ? (smem_slab ? kernel_ptr<32, true, true>() : kernel_ptr<32, true, false>())
                : (smem_slab ? kernel_ptr<32, false, true>() : kernel_ptr<32, false, false>());
}

struct Plan {
  int cols, in_smem, blocks, clusters_max, smem;
};

// the slab width and block count for a [K, B] matrix on the current device:
// as many clusters of 8 as can be resident with one block an SM, each block
// at least kMinCols columns; the slabs in shared memory where they fit, else
// in `out`
// the most clusters of 8 resident with one block an SM, by device and by
// KPL form (0: not asked yet); the kernels' shared-memory limit is raised
// when it is first asked
int max_clusters[64][2];

cudaError_t clusters_resident(int K, int* n) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  int& cached = max_clusters[dev][K <= 256 ? 0 : 1];
  if (cached > 0) {
    *n = cached;
    return cudaSuccess;
  }
  for (int s = 0; s < 2; ++s)
    for (int sm = 0; sm < 2; ++sm) {
      e = cudaFuncSetAttribute(pick(K, s, sm),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return e;
    }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = kCluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kMaxSmem;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n_cl = 0;
  e = cudaOccupancyMaxActiveClusters(&n_cl, pick(K, true, true), &cfg);
  if (e != cudaSuccess) return e;
  if (n_cl < 1) return cudaErrorLaunchOutOfResources;
  *n = cached = n_cl;
  return cudaSuccess;
}

cudaError_t make_plan(int K, int B, Plan* p) {
  if (K <= 0 || K > 1024 || B <= 0 || (long long)K * B > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  int n_cl = 0;
  const cudaError_t e = clusters_resident(K, &n_cl);
  if (e != cudaSuccess) return e;
  const int cap = n_cl * kCluster;
  const int cols = max(kMinCols, (B + cap - 1) / cap);
  int in_smem = (long long)layout(K, cols, 1).floats * 4 <= kMaxSmem;
  const long long bytes = (long long)layout(K, cols, in_smem).floats * 4;
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  const int blocks = ((B + cols - 1) / cols + kCluster - 1) / kCluster * kCluster;
  *p = Plan{cols, in_smem, blocks, n_cl, (int)bytes};
  return cudaSuccess;
}

}  // namespace

// plan_out[6]: columns a block, 1 if the slabs live in shared memory, blocks,
// clusters of 8, the most clusters resident, dynamic shared-memory bytes.
// The caller sizes `part` (2 x clusters x (K + 1) floats and one zeroed
// barrier word) from it.
extern "C" int tt_sinkhorn_plan(int K, int B, int* plan_out) {
  Plan p;
  const cudaError_t e = make_plan(K, B, &p);
  if (e != cudaSuccess) return (int)e;
  plan_out[0] = p.cols, plan_out[1] = p.in_smem, plan_out[2] = p.blocks;
  plan_out[3] = p.blocks / kCluster, plan_out[4] = p.clusters_max;
  plan_out[5] = p.smem;
  return 0;
}

// src: Q [K, B] (from_scores 0) or scores [B, K] (1), f32 contiguous; valid
// [B] f32 or null; out [B, K] f32; part as tt_sinkhorn_plan says, its last
// word zero. c_marginal is the column marginal without a mask.
extern "C" int tt_sinkhorn(const float* src, const float* valid, float* out,
                           float* part, int K, int B, int n_iters,
                           int from_scores, float epsilon, float c_marginal,
                           void* stream) {
  if (n_iters < 0 || (from_scores && !(epsilon > 0.f)))
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = make_plan(K, B, &p);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = kCluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = at;
  cfg.numAttrs = 2;
  void* args[] = {&src, &valid, &out, &part, &K, &B, &p.cols, &n_iters,
                  &epsilon, &c_marginal};
  e = cudaLaunchKernelExC(&cfg, pick(K, from_scores != 0, p.in_smem != 0), args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K11 across ranks: the same Sinkhorn when a process group spans the batch
// (ops/sinkhorn.sinkhorn with a group). Only the [K] row sums (and, once, the
// total mass and the valid count) are summed over the ranks, and no
// collective can run inside a launch, so the iteration is a chain of short
// launches on the stream with an all-reduce of one [K + 1] vector between
// them (ops/sinkhorn_cuda.sinkhorn_assignment_dp_cuda):
//   kDpLoad     Q0 = exp(s / epsilon) * valid of the scores into `out`,
//               b = 1, and the rank's row sums of Q0 with the valid count in
//               slot K, into `red`
//   all-reduce  red
//   kDpIter     a from red (iteration 0: the total mass and the marginal c
//               from red), one sweep over the rank's columns: Q0^T a, the
//               new b, and the next row sums into `red`
//   all-reduce  red                                    (n_iters - 1 times)
//   kDpLast     the last iteration's sweep writes the result over Q0 in
//               `out` instead of row sums (kDpOut: n_iters = 0)
// so 1 + max(n_iters, 1) launches and max(n_iters, 1) all-reduces. a is
// scaled by 1 / (total + 1e-12) as in the one-launch form, Q0 is never
// rewritten until the result replaces it. The rank's matrix (5 MB at
// [6,272, 200]) stays in the 50 MB L2 between launches and is reread from
// there once an iteration (__ldcg). A block owns `cols` columns, a warp one
// column at a time (its K values spread over the lanes); the block's row
// partials are summed over its warps in shared memory, written to `part`,
// and the last block to finish (a ticket counter) sums the blocks' partials
// in block order into `red`: no grid barrier, and the sums do not depend on
// block timing.
namespace {

constexpr int kDpThreads = 256;
constexpr int kDpWarps = kDpThreads / 32;

enum DpMode { kDpLoad = 0, kDpIter = 1, kDpLast = 2, kDpOut = 3 };

template <int KPL>
__global__ void __launch_bounds__(kDpThreads)
sinkhorn_dp_kernel(const float* __restrict__ src, const float* __restrict__ valid,
                   float* out, float* part, float* red, float* avec, float* scal,
                   float* bvec, unsigned* counter, int K, int B, int cols, int it,
                   int mode, float epsilon, float c_marginal) {
  extern __shared__ __align__(16) float sm[];
  __shared__ bool is_last;
  const int K1 = K + 1;
  float* wpart = sm;                    // [kDpWarps][K + 1]
  float* a_s = sm + kDpWarps * K1;      // [K]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * cols;
  const int ncol = max(0, min(cols, B - col0));

  // this launch's row scaling a and column marginal c
  float av[KPL];
  float c = c_marginal;
  if (mode != kDpLoad) {
    float a0 = 0.f;
    if (it == 0) {
      float t = 0.f;                    // every warp sums in one order
      for (int k = lane; k < K; k += 32) t += red[k];
      t = tt::warp_sum(t);
      a0 = 1.f / (t + kEps);
      if (valid != nullptr) c = 1.f / (red[K] + kEps);
      if (blockIdx.x == 0 && tid == 0) scal[0] = c;
    } else {
      c = scal[0];
    }
    const float r = 1.f / (float)K;
    for (int k = tid; k < K; k += kDpThreads) {
      float a_new = a0;
      if (mode != kDpOut) {
        const float a_prev = it == 0 ? a0 : avec[(it & 1) * K + k];
        const float u = a_prev * red[k];
        a_new = u > 0.f ? a_prev * (r / (u + kEps)) : 0.f;
      }
      a_s[k] = a_new;
      if (blockIdx.x == 0) avec[((it + 1) & 1) * K + k] = a_new;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int k = lane + 32 * i;
      av[i] = k < K ? a_s[k] : 0.f;
    }
  }

  float p[KPL];
#pragma unroll
  for (int i = 0; i < KPL; ++i) p[i] = 0.f;
  float nval = 0.f;
  for (int j = warp; j < ncol; j += kDpWarps) {
    const int g = col0 + j;
    float* col = out + (size_t)g * K;
    float q[KPL];
    float bj = 1.f;
    if (mode == kDpLoad) {
      const float m = valid != nullptr ? valid[g] : 1.f;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int k = lane + 32 * i;
        float v = 0.f;
        if (k < K) {
          v = expf(src[(size_t)g * K + k] / epsilon) * m;
          col[k] = v;
        }
        q[i] = v;
      }
      nval += m;
      if (lane == 0) bvec[g] = 1.f;
    } else {
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int k = lane + 32 * i;
        q[i] = k < K ? __ldcg(col + k) : 0.f;
      }
      if (mode != kDpOut) bj = bvec[g];
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < KPL; ++i) x = fmaf(q[i], av[i], x);
      x = tt::warp_sum(x);
      if (mode != kDpOut) {
        const float cs = bj * x;
        bj = cs > 0.f ? bj * (c / (cs + kEps)) : 0.f;
        if (lane == 0) bvec[g] = bj;
      }
      if (mode == kDpLast || mode == kDpOut) {
        const float scale = bj / (bj * x + kEps);
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          const int k = lane + 32 * i;
          if (k < K) col[k] = q[i] * av[i] * scale;
        }
        continue;
      }
    }
#pragma unroll
    for (int i = 0; i < KPL; ++i) p[i] = fmaf(q[i], bj, p[i]);
  }
  if (mode == kDpLast || mode == kDpOut) return;

  // the block's row partials (slot K: the valid count of the load)
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + 32 * i;
    if (k < K) wpart[warp * K1 + k] = p[i];
  }
  if (lane == 0) wpart[warp * K1 + K] = (mode == kDpLoad && valid != nullptr) ? nval : 0.f;
  __syncthreads();
  for (int k = tid; k < K1; k += kDpThreads) {
    float v = 0.f;
    for (int w = 0; w < kDpWarps; ++w) v += wpart[w * K1 + k];
    part[(size_t)blockIdx.x * K1 + k] = v;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int nb = gridDim.x;
  for (int k = tid; k < K1; k += kDpThreads) {
    float v = 0.f;
    for (int q0 = 0; q0 < nb; q0 += 8) {          // 8 loads in flight, then the sum
      float pq[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        pq[q] = q0 + q < nb ? __ldcg(part + (size_t)(q0 + q) * K1 + k) : 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) v += pq[q];
    }
    red[k] = v;
  }
  if (tid == 0) *counter = 0u;          // ready for the next launch
}

template <int KPL>
void* dp_ptr() {
  return reinterpret_cast<void*>(sinkhorn_dp_kernel<KPL>);
}

}  // namespace

// One launch of the cross-rank chain (mode: 0 load, 1 iterate, 2 last
// iterate, 3 output with no iteration) at iteration `it`. src: scores [B, K]
// f32 contiguous; valid [B] or null; out [B, K]
// (Q0 from the load on, the result after the last launch); part [blocks,
// K + 1]; red [K + 1] (all-reduced by the caller between launches); avec
// [2, K]; scal [1]; bvec [B]; counter one zeroed word. blocks x cols must
// cover B with no empty block (ops/sinkhorn_cuda.sinkhorn_dp_plan).
extern "C" int tt_sinkhorn_dp(const float* src, const float* valid, float* out,
                              float* part, float* red, float* avec, float* scal,
                              float* bvec, unsigned* counter, int K, int B,
                              int cols, int blocks, int it, int mode,
                              float epsilon, float c_marginal, void* stream) {
  if (K <= 0 || K > 1024 || B <= 0 || cols <= 0 || blocks <= 0 ||
      (long long)cols * (blocks - 1) >= B || (long long)cols * blocks < B ||
      it < 0 || mode < kDpLoad || mode > kDpOut || !(epsilon > 0.f) ||
      (long long)K * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  void* fn = K > 256 ? dp_ptr<32>() : dp_ptr<8>();
  const size_t smem = (size_t)(kDpWarps * (K + 1) + K) * sizeof(float);
  void* args[] = {&src, &valid, &out, &part, &red, &avec, &scal, &bvec, &counter,
                  &K, &B, &cols, &it, &mode, &epsilon, &c_marginal};
  cudaError_t e = cudaLaunchKernel(fn, dim3(blocks), dim3(kDpThreads), args, smem,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
