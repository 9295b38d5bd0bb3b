// Sinkhorn-Knopp normalisation of one [K, B] f32 transport matrix, all
// iterations in one launch, in the materialising form:
//   Q = Q * valid / (sum Q + 1e-12)
//   n_iters x { Q *= (1/K) / (rowsum + 1e-12);  Q *= c / (colsum + 1e-12) }
//   Q /= colsum + 1e-12;   out[B, K] = Q^T
// with c = 1/B, or 1 / (sum valid + 1e-12) when a validity mask is given.
//
// Replaces the TPU kernel timetuning_tpu/ops/sinkhorn_pallas.py:_kernel (:51)
// and its dynamic-marginal twin kern_dyn (:91), both over _iterate_inplace
// (:33), which keep the whole matrix resident in 16 MB of VMEM. It keeps
// that kernel's arithmetic: every scaled matrix is materialised and rounded,
// and a zero marginal divides by 1e-12 (it is not pinned as the
// diagonal-scaling form of ops/sinkhorn.py pins it).
//
// What bounds it on the card: the bytes are tiny (read and write K*B*4:
// 5 MB at [200, 6272], 20 MB at [200, 25088], a few microseconds at 3.35
// TB/s) and the work per element is a handful of FMAs, so the time is set by
// the dependency chain: each iteration's row sums span the whole matrix.
// An SM's 227 KB of shared memory cannot hold the matrix, so "resident"
// means spread over the SMs: a block owns a slab of Bc columns, [K, Bc], in
// its shared memory for the whole run. Column sums are then local to a
// block; row sums need one [K] vector summed over all blocks per iteration.
// The blocks write their partial row sums to device memory, pass a grid-wide
// barrier (a cooperative launch, so all blocks are co-resident), and each
// block adds the partials up in a fixed order: the result does not depend on
// block timing. Partials alternate between two buffers, so one barrier an
// iteration is enough: 1 + n_iters barriers in all. The transposed [B, K]
// result is written straight from the slab.
//
// A matrix too large for the SMs' shared memory together (or a K whose
// narrowest slab does not fit) runs the same kernel with its slabs in a
// device-memory work buffer (which the 50 MB L2 mostly holds): the block
// then owns ceil(B / blocks) columns of that buffer.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-12f;
constexpr int kMaxSmem = 232448;       // bytes a block may use on sm_90

__host__ __device__ inline int fixed_floats(int K) {
  // fr [K rounded up to 32] | column partials [kThreads] | reduction [32]
  return (K + 31) / 32 * 32 + kThreads + 32;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = tt::warp_sum(v);
  __syncthreads();                     // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// sum of n floats at p, the same value in every lane, in a fixed order
__device__ __forceinline__ float warp_strided_sum(const float* p, int n) {
  float s = 0.f;
  for (int i = threadIdx.x & 31; i < n; i += 32) s += p[i];
  return tt::warp_sum(s);
}

__global__ void __launch_bounds__(kThreads)
sinkhorn_kernel(const float* __restrict__ Q, const float* __restrict__ valid,
                float* __restrict__ out, float* work, float* part, int K, int B,
                int Bc, int n_iters, int use_smem) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float sm[];
  float* fr = sm;                               // row factors
  float* colpart = fr + (K + 31) / 32 * 32;     // [G][CW]
  float* red = colpart + kThreads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nblk = gridDim.x, blk = blockIdx.x;
  const int col0 = blk * Bc;
  const int ncol = min(Bc, B - col0);
  float* slab = use_smem ? red + 32 : work + col0;
  const int ld = use_smem ? Bc + 1 : B;
  // partial sums in device memory: two [K, nblk] row-sum buffers, then the
  // blocks' total mass and valid counts
  float* part_tot = part + 2 * (size_t)K * nblk;
  float* part_val = part_tot + nblk;

  // column-pass roles: CW column lanes x G row groups
  int CW = 32;
  while (CW < ncol && CW < kThreads) CW <<= 1;
  const int G = kThreads / CW;
  const int jl = tid % CW, g = tid / CW;

  // load the slab (masked), sum its mass and its valid count
  float mass = 0.f, nval = 0.f;
  for (int idx = tid; idx < K * ncol; idx += kThreads) {
    const int k = idx / ncol, j = idx - k * ncol;
    float v = Q[(size_t)k * B + col0 + j];
    if (valid != nullptr) v *= valid[col0 + j];
    slab[k * ld + j] = v;
    mass += v;
  }
  if (valid != nullptr)
    for (int j = tid; j < ncol; j += kThreads) nval += valid[col0 + j];
  mass = block_sum(mass, red);
  nval = block_sum(nval, red);
  if (tid == 0) {
    part_tot[blk] = mass;
    part_val[blk] = nval;
  }
  grid.sync();
  const float total = warp_strided_sum(part_tot, nblk);
  const float c = valid != nullptr
                      ? 1.f / (warp_strided_sum(part_val, nblk) + kEps)
                      : 1.f / (float)B;
  const float r = 1.f / (float)K;
  const float denom = total + kEps;
  for (int idx = tid; idx < K * ncol; idx += kThreads) {
    const int k = idx / ncol, j = idx - k * ncol;
    slab[k * ld + j] /= denom;
  }
  __syncthreads();

  // this block's partial row sums into buffer `buf`
  auto row_pass = [&](int buf) {
    float* dst = part + (size_t)buf * K * nblk;
    for (int k = warp; k < K; k += kWarps) {
      float s = 0.f;
      for (int j = lane; j < ncol; j += 32) s += slab[k * ld + j];
      s = tt::warp_sum(s);
      if (lane == 0) dst[(size_t)k * nblk + blk] = s;
    }
  };

  // rows scaled by fr (iterations) or left alone (the last normalisation),
  // then every column scaled to the marginal c, or to 1 when `last`
  auto column_pass = [&](bool last) {
    for (int j0 = 0; j0 < ncol; j0 += CW) {
      const int j = j0 + jl;
      const bool active = j < ncol;
      float s = 0.f;
      if (active) {
        if (last) {
          for (int k = g; k < K; k += G) s += slab[k * ld + j];
        } else {
          for (int k = g; k < K; k += G) {
            const float v = slab[k * ld + j] * fr[k];
            slab[k * ld + j] = v;
            s += v;
          }
        }
      }
      colpart[g * CW + jl] = s;
      __syncthreads();
      float col = 0.f;
      for (int gg = 0; gg < G; ++gg) col += colpart[gg * CW + jl];
      if (active) {
        if (last) {
          const float d = col + kEps;
          for (int k = g; k < K; k += G) slab[k * ld + j] /= d;
        } else {
          const float f = c / (col + kEps);
          for (int k = g; k < K; k += G) slab[k * ld + j] *= f;
        }
      }
      __syncthreads();
    }
  };

  if (n_iters > 0) {
    row_pass(0);
    grid.sync();
  }
  for (int it = 0; it < n_iters; ++it) {
    const float* src = part + (size_t)(it & 1) * K * nblk;
    for (int k = warp; k < K; k += kWarps) {
      const float u = warp_strided_sum(src + (size_t)k * nblk, nblk);
      if (lane == 0) fr[k] = r / (u + kEps);
    }
    __syncthreads();
    column_pass(false);
    if (it + 1 < n_iters) {
      row_pass((it + 1) & 1);
      grid.sync();
    }
  }
  column_pass(true);

  // out[B, K]: the slab transposed, K fastest
  for (int idx = tid; idx < K * ncol; idx += kThreads) {
    const int j = idx / K, k = idx - j * K;
    out[(size_t)(col0 + j) * K + k] = slab[k * ld + j];
  }
}

// the slab width and block count for a [K, B] matrix on the current device:
// the narrowest shared-memory slab whose blocks are all co-resident, else
// slabs in the device-memory work buffer
cudaError_t plan(int K, int B, int* Bc, int* use_smem, int* nblk, int* smem) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(sinkhorn_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return e;
  for (int bc = 32; bc <= 256; bc *= 2) {
    const long long bytes = ((long long)fixed_floats(K) + (long long)K * (bc + 1)) * 4;
    if (bytes > kMaxSmem) break;
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, sinkhorn_kernel,
                                                      kThreads, (size_t)bytes);
    if (e != cudaSuccess) return e;
    const int n = (B + bc - 1) / bc;
    if ((long long)occ * sms >= n) {
      *Bc = bc, *use_smem = 1, *nblk = n, *smem = (int)bytes;
      return cudaSuccess;
    }
  }
  const int bytes = fixed_floats(K) * 4;
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, sinkhorn_kernel,
                                                    kThreads, (size_t)bytes);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorLaunchOutOfResources;
  const int cap = occ * sms;
  const int bc = ((B + cap - 1) / cap + 31) / 32 * 32;
  *Bc = bc, *use_smem = 0, *nblk = (B + bc - 1) / bc, *smem = bytes;
  return cudaSuccess;
}

}  // namespace

// plan_out[3]: slab width Bc, 1 if the slabs live in shared memory, number
// of blocks. The caller sizes `part` ((2 K + 2) * blocks floats) and, for
// slabs in device memory, `work` (K * B floats) from it.
extern "C" int tt_sinkhorn_plan(int K, int B, int* plan_out) {
  if (K <= 0 || B <= 0 || (long long)K * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int smem = 0;
  return (int)plan(K, B, &plan_out[0], &plan_out[1], &plan_out[2], &smem);
}

// Q [K, B] f32 contiguous, valid [B] f32 or null, out [B, K] f32.
extern "C" int tt_sinkhorn(const float* Q, const float* valid, float* out,
                           float* work, float* part, int K, int B, int n_iters,
                           void* stream) {
  if (K <= 0 || B <= 0 || (long long)K * B > 0x7fffffffLL || n_iters < 0)
    return (int)cudaErrorInvalidValue;
  int Bc = 0, use_smem = 0, nblk = 0, smem = 0;
  cudaError_t e = plan(K, B, &Bc, &use_smem, &nblk, &smem);
  if (e != cudaSuccess) return (int)e;
  if (!use_smem && work == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {&Q, &valid, &out, &work, &part, &K, &B, &Bc, &n_iters, &use_smem};
  e = cudaLaunchCooperativeKernel((void*)sinkhorn_kernel, dim3(nblk),
                                  dim3(kThreads), args, (size_t)smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
