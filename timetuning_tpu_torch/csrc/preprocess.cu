// Eval preprocess: uint8 frames [F, H, W, 3] -> antialiased bilinear
// downscale to S x S, /255 and (x - mean) / std folded in, bf16 out
// [F, S, S, 3].
//
// Replaces the TPU kernel timetuning_tpu/ops/preprocess_pallas.py:_kernel
// (reached through eval_preprocess_pallas).
//
// What bounds it on the card: bytes. A 480x854 frame is 1.23 MB of uint8
// read once, against ~10 multiply-adds per output value; the kernel is far
// below the ridge, so the aim is to read each input byte from device memory
// about once and never write a full-resolution intermediate.
//
// Design. The resize is separable and its weight matrices (the exact f32
// _resize_weights of jax.image.resize's antialiased triangle kernel, built
// on the host) are banded: ~5 taps per output row at 480 -> 224. The host
// passes each band as (start, taps[n_out, n_taps]). One block owns one
// output row of one frame: it applies the H-pass taps to the few input rows
// in its band, reading the interleaved HWC bytes directly, keeps the
// resampled row [W*3] in f32 shared memory, then applies the W-pass taps per
// output pixel and channel, normalizes and rounds to bf16 once. The TPU
// kernel's int8-MXU trick (bytes XOR 0x80 into an int8 matmul) answered
// Mosaic's lack of a u8->bf16 cast and is not carried: CUDA reads bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
preprocess_kernel(const uint8_t* __restrict__ frames,
                  const int* __restrict__ h_start, const float* __restrict__ h_w,
                  int h_taps, const int* __restrict__ w_start,
                  const float* __restrict__ w_w, int w_taps, float m0, float m1,
                  float m2, float is0, float is1, float is2,
                  tt::bf16* __restrict__ out, int H, int W, int S) {
  extern __shared__ float resampled[];   // [W * 3]
  const int f = blockIdx.y;
  const int y = blockIdx.x;
  const int w3 = W * 3;
  const uint8_t* src = frames + (size_t)f * H * w3 + (size_t)h_start[y] * w3;
  const float* hw = h_w + (size_t)y * h_taps;
  for (int i = threadIdx.x; i < w3; i += kThreads) {
    float v = 0.f;
    for (int k = 0; k < h_taps; ++k) v += hw[k] * (float)src[(size_t)k * w3 + i];
    resampled[i] = v;
  }
  __syncthreads();
  tt::bf16* dst = out + ((size_t)f * S + y) * S * 3;
  for (int o = threadIdx.x; o < S * 3; o += kThreads) {
    const int x = o / 3;
    const int c = o - 3 * x;
    const float* ww = w_w + (size_t)x * w_taps;
    const float* r = resampled + w_start[x] * 3 + c;
    float v = 0.f;
    for (int k = 0; k < w_taps; ++k) v += ww[k] * r[3 * k];
    const float mean = c == 0 ? m0 : (c == 1 ? m1 : m2);
    const float inv_std = c == 0 ? is0 : (c == 1 ? is1 : is2);
    dst[o] = __float2bfloat16((v * (1.f / 255.f) - mean) * inv_std);
  }
}

}  // namespace

extern "C" int tt_eval_preprocess(const void* frames, const int* h_start,
                                  const float* h_w, int h_taps,
                                  const int* w_start, const float* w_w,
                                  int w_taps, float m0, float m1, float m2,
                                  float is0, float is1, float is2, void* out,
                                  int F, int H, int W, int S, void* stream) {
  if (F <= 0 || F > 65535 || S <= 0 || S > H || S > W || h_taps <= 0 ||
      w_taps <= 0 || h_taps > H || w_taps > W)
    return (int)cudaErrorInvalidValue;
  const int smem = W * 3 * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      preprocess_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  preprocess_kernel<<<dim3(S, F), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), h_start, h_w, h_taps, w_start, w_w,
      w_taps, m0, m1, m2, is0, is1, is2, static_cast<tt::bf16*>(out), H, W, S);
  return (int)cudaGetLastError();
}
