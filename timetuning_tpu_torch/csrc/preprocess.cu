// Eval preprocess: uint8 frames [F, H, W, 3] -> antialiased bilinear
// downscale to S x S, /255 and (x - mean) / std folded in, bf16 out
// [F, S, S, 3].
//
// Replaces the TPU kernel timetuning_tpu/ops/preprocess_pallas.py:_kernel
// (reached through eval_preprocess_pallas).
//
// What bounds it on the card: bytes. 50 frames of 480x854 are 61.5 MB of
// uint8 against 15.1 MB of bf16 out at 224 (60.2 MB at 448), and a few
// multiply-adds per input byte; the least time is the bytes over the memory
// rate. After the bytes, the W pass's instructions come next: each input
// byte is turned into a float and multiplied once per output pixel whose
// taps hold it (~1.6 times at 854 -> 224).
//
// Design. The resize is separable and its weight matrices (the exact f32
// _resize_weights of jax.image.resize's antialiased triangle kernel, built
// on the host) are banded; the host passes each band as (start, taps).
// A block owns a band of R output rows of one frame (R, and the rest of the
// plan, from ops/preprocess_cuda.band_plan, checked here). The input rows of
// the band are one contiguous byte range of the frame, which the block
// streams once, RC rows a chunk, through a ring of kStages staging buffers
// in shared memory with 16-byte cp.async copies (kStages - 1 chunks in
// flight); bytes are read twice only in the halo between two bands.
//   - W pass first, on each chunk as it lands: a thread takes an output
//     pixel and walks the chunk's rows; for each it reads the pixel's
//     3 x WT bytes as aligned 32-bit words (funnel-shifted into place),
//     turns each byte into a float with a byte permute and one add, and
//     writes the pixel's 3 channels into a ring of NR resampled rows [3S]
//     f32. The W taps and starts sit in shared memory, padded to WT with
//     zeros, read as float4 once a chunk.
//   - H pass as soon as an output row's input rows are all in the ring: a
//     thread builds 8 consecutive output values (16 bytes) from the ring
//     (whose rows hold each 8 values as two float4 128 floats apart, so a
//     warp's reads are contiguous and free of bank conflicts) with
//     the row's H taps (/255 folded in), applies 1/std and -mean/std of each
//     value's channel, rounds once to bf16 and stores the 16 bytes whole.
//     An output row (1,344 bytes at 224) leaves as contiguous 16-byte stores;
//     only a band's first and last 8-value group may be partial, where the
//     output's 16-byte groups straddle two bands (scalar stores there).
// The ring holds RC + h_taps - 1 + (largest step of the band starts) rows:
// enough for every output row still pending, including the one whose last
// partial group waits for the next chunk (ops/preprocess_cuda.band_plan
// derives it, tests/test_torch_small_plans.py replays the schedule).
// The TPU kernel's int8-MXU trick (bytes XOR 0x80 into an int8 matmul)
// answered Mosaic's lack of a u8->bf16 cast and is not carried: tensor cores
// buy nothing at a few multiply-adds a byte.
//
// What paces it (tools/time_small_kernels.py --split): not the device's
// bytes alone. The loads take ~40 % of the kernel; the W and the H pass
// add about as much each and do not hide under the loads: a block's chunk
// steps go barrier to barrier, and the passes' shared-memory reads (the
// byte words at ~11-byte lane strides, h_taps floats a value) and their
// latency set their time.
//
// TT_PRE_PHASES (tools/time_small_kernels.py --split): 1 = the staged loads
// alone (one word of each item summed into a register, nothing stored),
// 2 = + the W pass into the ring, 3 = + the H pass (values computed, not
// stored), 4 = the kernel.
#include "common.cuh"

#ifndef TT_PRE_PHASES
#define TT_PRE_PHASES 4
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;        // 64 registers a thread
constexpr int kStages = 4;             // staging buffers of RC input rows
constexpr int kMaxSmem = 232448;       // bytes a block may use on sm_90

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// the W taps' stride in shared memory: the kernel's template bucket, or the
// taps themselves for the generic form (0)
__host__ inline int w_bucket(int w_taps) {
  return w_taps <= 4 ? 4 : w_taps <= 8 ? 8 : w_taps <= 16 ? 16 : 0;
}

struct Layout {                         // byte offsets into dynamic smem
  int stage_bytes, ring, ws, ww, hs, hslot, hw, total;
};

// mirrored by ops/preprocess_cuda.band_plan (smem_bytes)
__host__ __device__ inline Layout layout(int W, int S, int R, int RC, int NR,
                                         int h_taps, int wt_stride) {
  Layout l;
  l.stage_bytes = round_up(RC * W * 3 + 15, 16);
  l.ring = kStages * l.stage_bytes;
  l.ws = l.ring + NR * round_up(3 * S, 256) * 4;
  l.ww = l.ws + round_up(S * 4, 16);
  l.hs = l.ww + round_up(S * wt_stride * 4, 16);
  l.hslot = l.hs + round_up(R * 4, 16);
  l.hw = l.hslot + round_up(R * 4, 16);
  l.total = l.hw + round_up(R * h_taps * 4, 16);
  return l;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// where value v of a resampled row sits in its ring row: in each run of 256
// values, the first halves of the 32 groups of 8 values, then the second
// halves, so the H pass's float4 reads of a warp are contiguous
__device__ __forceinline__ int ring_pos(int v) {
  return (v & ~255) + (v & 4) * 32 + ((v >> 3) & 31) * 4 + (v & 3);
}

// channel c of a per-channel triple, by selects (no indexed local array)
__device__ __forceinline__ float chan(float3 t, int c) {
  return c == 0 ? t.x : (c == 1 ? t.y : t.z);
}

// 8 sums of one row from value v on: x / std - mean / std by channel
__device__ __forceinline__ void normalise8(float (&vals)[8], int c0, float3 sc, float3 bi) {
  const int c1 = c0 == 2 ? 0 : c0 + 1, c2 = c0 == 0 ? 2 : c0 - 1;
  const float s0 = chan(sc, c0), s1 = chan(sc, c1), s2 = chan(sc, c2);
  const float b0 = chan(bi, c0), b1 = chan(bi, c1), b2 = chan(bi, c2);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    vals[q] = fmaf(vals[q], q % 3 == 0 ? s0 : q % 3 == 1 ? s1 : s2,
                   q % 3 == 0 ? b0 : q % 3 == 1 ? b1 : b2);
}

// 8 floats rounded once to bf16, as 16 bytes
__device__ __forceinline__ uint4 pack8(const float (&vals)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(vals[2 * q], vals[2 * q + 1]);
    w[q] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// byte j of a word as a float: 2^23 + b built by a byte permute, minus 2^23
__device__ __forceinline__ float byte_f(uint32_t word, int j) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 | j)) - 8388608.f;
}

template <int WT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
preprocess_kernel(const uint8_t* __restrict__ frames,
                  const int* __restrict__ h_start, const float* __restrict__ h_w,
                  int h_taps, const int* __restrict__ w_start,
                  const float* __restrict__ w_w, int w_taps, float m0, float m1,
                  float m2, float is0, float is1, float is2,
                  tt::bf16* __restrict__ out, int F, int H, int W, int S,
                  int R, int bands, int RC, int NR) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wt_stride = WT > 0 ? WT : w_taps;
  const Layout L = layout(W, S, R, RC, NR, h_taps, wt_stride);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  int* ws = reinterpret_cast<int*>(smem + L.ws);
  float* ww = reinterpret_cast<float*>(smem + L.ww);
  int* hs = reinterpret_cast<int*>(smem + L.hs);
  int* hslot = reinterpret_cast<int*>(smem + L.hslot);   // ring slot of hs
  float* hw = reinterpret_cast<float*>(smem + L.hw);

  const int tid = threadIdx.x;
  const int f = blockIdx.x / bands;
  const int y0 = (blockIdx.x - f * bands) * R;
  const int y1 = min(S, y0 + R);
  const int W3 = W * 3, S3 = 3 * S, ldr = round_up(S3, 256);
  const long long total = (long long)F * H * W3;
  const long long frame0 = (long long)f * H * W3;

  // the band's tables: W taps padded to the bucket with zeros, H taps / 255
  for (int i = tid; i < S; i += kThreads) ws[i] = w_start[i];
  for (int i = tid; i < S * wt_stride; i += kThreads) {
    const int x = i / wt_stride, k = i - x * wt_stride;
    ww[i] = k < w_taps ? w_w[(size_t)x * w_taps + k] : 0.f;
  }
  const int r_lo = h_start[y0];
  for (int i = tid; i < y1 - y0; i += kThreads) {
    hs[i] = h_start[y0 + i];
    hslot[i] = (h_start[y0 + i] - r_lo) % NR;
  }
  for (int i = tid; i < (y1 - y0) * h_taps; i += kThreads)
    hw[i] = h_w[(size_t)y0 * h_taps + i] * (1.f / 255.f);
  const int r_hi = h_start[y1 - 1] + h_taps;
  const int n_chunks = (r_hi - r_lo + RC - 1) / RC;

  // chunk c: input rows [r_lo + c RC, ...) as 16-byte pieces from the
  // aligned-down start; the last piece of the tensor reads only its bytes
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int ra = r_lo + c * RC, rb = min(r_hi, ra + RC);
      const long long a = frame0 + (long long)ra * W3;
      const long long a16 = a & ~15LL;
      const int n16 = (int)((frame0 + (long long)rb * W3 - a16 + 15) >> 4);
      unsigned char* dst = smem + (c % kStages) * L.stage_bytes;
      for (int i = tid; i < n16; i += kThreads) {
        const long long o = a16 + 16LL * i;
        cp_async16(dst + 16 * i, frames + o, (int)min(16LL, total - o));
      }
    }
    cp_async_commit();
  };

  const float3 sc = make_float3(is0, is1, is2);
  const float3 bi = make_float3(-m0 * is0, -m1 * is1, -m2 * is2);
  const long long out0 = (long long)f * S * S3;     // this frame's first value
  long long e_done = out0 + (long long)y0 * S3;     // next value to write
  const long long e_end = out0 + (long long)y1 * S3;
  int y_ready = y0, y_done = y0;
#if TT_PRE_PHASES == 1
  uint32_t touch = 0;
#endif

  for (int c = 0; c < kStages - 1; ++c) issue(c);
  __syncthreads();                      // tables in place
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                    // chunk c landed; step c - 1 done
    issue(c + kStages - 1);
    const int ra = r_lo + c * RC, rb = min(r_hi, ra + RC);
    const unsigned char* st = smem + (c % kStages) * L.stage_bytes;
    const int off0 = (int)((frame0 + (long long)ra * W3) & 15);

    // W pass: a thread takes an output pixel, its taps read once, through
    // every row of this chunk
    const int slot0 = (ra - r_lo) % NR;
    for (int x = tid; x < S; x += kThreads) {
      const int px = ws[x] * 3;
      const float* wx = ww + x * wt_stride;
      float wk[WT > 0 ? WT : 1];
      if constexpr (WT > 0) {
#pragma unroll
        for (int q = 0; q < WT; q += 4) {
          const float4 v = *reinterpret_cast<const float4*>(wx + q);
          wk[q] = v.x, wk[q + 1] = v.y, wk[q + 2] = v.z, wk[q + 3] = v.w;
        }
      }
      for (int r = 0; r < rb - ra; ++r) {
        const int p = off0 + r * W3 + px;
        const int slot = slot0 + r < NR ? slot0 + r : slot0 + r - NR;
#if TT_PRE_PHASES == 1
        touch += *reinterpret_cast<const uint32_t*>(st + (p & ~3));
        continue;
#endif
        float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
        if constexpr (WT > 0) {
          constexpr int NA = 3 * WT / 4;            // aligned words of 3 WT bytes
          const uint32_t* wp = reinterpret_cast<const uint32_t*>(st + (p & ~3));
          const int sh = (p & 3) * 8;
          uint32_t raw[NA + 1];
#pragma unroll
          for (int q = 0; q <= NA; ++q) raw[q] = wp[q];
          uint32_t a[NA];
#pragma unroll
          for (int q = 0; q < NA; ++q) a[q] = __funnelshift_r(raw[q], raw[q + 1], sh);
#pragma unroll
          for (int k = 0; k < WT; ++k) {
            acc0 = fmaf(wk[k], byte_f(a[(3 * k) >> 2], (3 * k) & 3), acc0);
            acc1 = fmaf(wk[k], byte_f(a[(3 * k + 1) >> 2], (3 * k + 1) & 3), acc1);
            acc2 = fmaf(wk[k], byte_f(a[(3 * k + 2) >> 2], (3 * k + 2) & 3), acc2);
          }
        } else {
          for (int k = 0; k < w_taps; ++k) {
            const float wv = wx[k];
            acc0 = fmaf(wv, (float)st[p + 3 * k], acc0);
            acc1 = fmaf(wv, (float)st[p + 3 * k + 1], acc1);
            acc2 = fmaf(wv, (float)st[p + 3 * k + 2], acc2);
          }
        }
        float* dst = ring + slot * ldr;
        dst[ring_pos(3 * x)] = acc0;
        dst[ring_pos(3 * x + 1)] = acc1;
        dst[ring_pos(3 * x + 2)] = acc2;
      }
    }
    __syncthreads();
#if TT_PRE_PHASES >= 3
    // H pass: every value of the output rows whose input rows have all
    // arrived, as 16-byte groups of 8 values
    while (y_ready < y1 && hs[y_ready - y0] + h_taps <= rb) ++y_ready;
    if (S3 % 8 == 0) {
      // a group never crosses a row: whole rows, taps outer, values inner
      const int g8 = S3 / 8;
      for (int rr = tid / g8, gi = tid - (tid / g8) * g8; rr < y_ready - y_done;) {
        const int row = y_done - y0 + rr, v = gi * 8;
        tt::bf16* dst = out + out0 + (long long)(y_done + rr) * S3 + v;
        gi += kThreads;
        while (gi >= g8) gi -= g8, ++rr;
        float vals[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) vals[q] = 0.f;
        int slot = hslot[row];
        const int at = (v & ~255) + ((v >> 3) & 31) * 4;    // ring_pos(v)
        for (int k = 0; k < h_taps; ++k) {
          const float wv = hw[row * h_taps + k];
          const float* src = ring + slot * ldr + at;
          const float4 lo = *reinterpret_cast<const float4*>(src);
          const float4 hi = *reinterpret_cast<const float4*>(src + 128);
          vals[0] = fmaf(wv, lo.x, vals[0]), vals[1] = fmaf(wv, lo.y, vals[1]);
          vals[2] = fmaf(wv, lo.z, vals[2]), vals[3] = fmaf(wv, lo.w, vals[3]);
          vals[4] = fmaf(wv, hi.x, vals[4]), vals[5] = fmaf(wv, hi.y, vals[5]);
          vals[6] = fmaf(wv, hi.z, vals[6]), vals[7] = fmaf(wv, hi.w, vals[7]);
          if (++slot == NR) slot = 0;
        }
        normalise8(vals, v % 3, sc, bi);
#if TT_PRE_PHASES == 3
        if (vals[0] != -1e30f) continue;
#endif
        *reinterpret_cast<uint4*>(dst) = pack8(vals);
      }
      y_done = y_ready;
    } else {
      // groups across rows and bands: value by value; the last partial
      // group waits for the next chunk unless the band ends
      const long long e_ready = out0 + (long long)y_ready * S3;
      const long long e_hi = y_ready == y1 ? e_end : (e_ready & ~7LL);
      for (long long g = (e_done >> 3) + tid; g * 8 < e_hi; g += kThreads) {
        const long long ga = max(g * 8, e_done), gb = min(g * 8 + 8, e_hi);
        float vals[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const long long e = g * 8 + q;
          vals[q] = 0.f;
          if (e >= ga && e < gb) {
            const int le = (int)(e - out0);
            const int yy = le / S3, vv = le - yy * S3;
            const int row = yy - y0;
            int slot = hslot[row];
            float acc = 0.f;
            for (int k = 0; k < h_taps; ++k) {
              acc = fmaf(hw[row * h_taps + k], ring[slot * ldr + ring_pos(vv)], acc);
              if (++slot == NR) slot = 0;
            }
            vals[q] = fmaf(acc, chan(sc, vv % 3), chan(bi, vv % 3));
          }
        }
#if TT_PRE_PHASES == 3
        if (vals[0] != -1e30f) continue;
#endif
        if (ga == g * 8 && gb == g * 8 + 8) {
          *reinterpret_cast<uint4*>(out + g * 8) = pack8(vals);
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (g * 8 + q >= ga && g * 8 + q < gb) out[g * 8 + q] = __float2bfloat16(vals[q]);
        }
      }
      e_done = max(e_done, e_hi);
    }
#endif
  }
#if TT_PRE_PHASES == 1
  if (touch == 0x12345678u) out[0] = __float2bfloat16(0.f);
#endif
  cp_async_wait<0>();
}

}  // namespace

// R output rows a band, RC input rows a chunk, NR rows in the ring and the
// dynamic shared memory bytes come from ops/preprocess_cuda.band_plan; they
// are checked here against the same layout, and a plan that does not fit
// is refused (cudaErrorInvalidValue), never run another way.
extern "C" int tt_eval_preprocess(const void* frames, const int* h_start,
                                  const float* h_w, int h_taps,
                                  const int* w_start, const float* w_w,
                                  int w_taps, float m0, float m1, float m2,
                                  float is0, float is1, float is2, void* out,
                                  int F, int H, int W, int S, int R, int RC,
                                  int NR, int smem, void* stream) {
  if (F <= 0 || S <= 0 || S > H || S > W || h_taps <= 0 || w_taps <= 0 ||
      h_taps > H || w_taps > W || R <= 0 || RC <= 0 || NR < RC + h_taps - 1 ||
      (reinterpret_cast<uintptr_t>(frames) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int wt = w_bucket(w_taps);
  const Layout l = layout(W, S, R, RC, NR, h_taps, wt > 0 ? wt : w_taps);
  if (l.total != smem || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int bands = (S + R - 1) / R;
  if ((long long)F * bands > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  void (*kern)(const uint8_t*, const int*, const float*, int, const int*,
               const float*, int, float, float, float, float, float, float,
               tt::bf16*, int, int, int, int, int, int, int, int) =
      wt == 4 ? preprocess_kernel<4> : wt == 8 ? preprocess_kernel<8>
      : wt == 16 ? preprocess_kernel<16> : preprocess_kernel<0>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<F * bands, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), h_start, h_w, h_taps, w_start, w_w,
      w_taps, m0, m1, m2, is0, is1, is2, static_cast<tt::bf16*>(out), F, H, W,
      S, R, bands, RC, NR);
  return (int)cudaGetLastError();
}
