// The row kernels of the long-token (> 1024 tokens) ViT block, bf16 in and
// out, over the flattened token rows [M = B*S, K]:
//   tt_ln_dense:        out = LN(x) @ W + b          (LN1 + qkv)
//   tt_dense_residual:  out = x + (y @ W + b)        (proj + residual)
//
// Replace the TPU kernels timetuning_tpu/ops/fused_block.py:_ln_dense_kernel
// (:298, via _ln_dense_pallas) and _dense_residual_kernel (:308, via
// _dense_residual_pallas). The third row kernel, _mlp_rows_kernel (:282),
// is tt_mlp_block of csrc/mlp_block.cu, which is row-tiled already.
//
// What bounds them on the card. tt_ln_dense over the qkv rows of 50 frames
// of ViT-S/8 at 448 (M = 156,850, K = 384, N = 1,152) is 138.8 GFLOP (0.140
// ms at the bf16 peak) against 482 MB (0.144 ms at 3.35 TB/s): both at once,
// so the products have to run near the tensor cores' rate while x streams in
// once and the 361 MB of qkv stream out. tt_dense_residual (N = 384) is
// 46 GFLOP against 362 MB: its bytes bound it.
//
// Design. The TPU kernels tile the rows so that VMEM use is constant in S;
// the GEMM tile of gemm_wgmma.cuh is row-tiled by construction, so each
// kernel is one launch of it. In tt_ln_dense a block keeps its 128 rows of x,
// normalised (f32 statistics from the bf16 row, rounded to bf16 before the
// product), resident in shared memory in wgmma's layout and walks every
// 128-column tile of the output over them: x is read from device memory
// once and normalised once a row block, as the TPU kernel does; W tiles
// arrive by TMA through a ring. In tt_dense_residual y streams through the
// ring with W. The two consumer warpgroups take the tiles in turns, so one's
// bias / residual / rounding / stores run under the other's products; the
// output leaves through swizzled boxes in shared memory and TMA stores,
// whole 128-byte lines at a time, and the residual tile comes in the same
// way, summed in f32 and rounded once, as the TPU kernel's
// (x.f32 + out).astype.
#include "gemm_wgmma.cuh"

// n_slices: the caller's plan (ops/fused_block.gemm_plan), checked by
// launch_gemm.
extern "C" int tt_ln_dense(const void* x, const float* ln_s, const float* ln_b,
                           const void* w, const float* b, void* out, int M,
                           int N, int K, int n_slices, void* stream) {
  using tt::bf16;
  return (int)tt::launch_gemm<true, tt::kBias>(
      static_cast<const bf16*>(x), ln_s, ln_b, static_cast<const bf16*>(w), b,
      nullptr, static_cast<bf16*>(out), M, N, K, n_slices,
      static_cast<cudaStream_t>(stream));
}

// LN + dense over rows wider than the prologue holds (K > 1,024: DINOv2
// ViT-g's LN1 + qkv at K = 1,536): the LayerNorm pass into `normed` (a bf16
// [M, K] scratch), then the streamed tile with the bias epilogue. No TPU
// kernel: the JAX package has no model this wide.
extern "C" int tt_ln_wide_dense(const void* x, const float* ln_s, const float* ln_b,
                                const void* w, const float* b, void* normed, void* out,
                                int M, int N, int K, int n_slices, void* stream) {
  using tt::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = tt::launch_ln_wide(static_cast<const bf16*>(x), ln_s, ln_b,
                                           static_cast<bf16*>(normed), M, K, tt::kLnEps, st);
  if (e != cudaSuccess) return (int)e;
  return (int)tt::launch_gemm<false, tt::kBias>(
      static_cast<const bf16*>(normed), nullptr, nullptr, static_cast<const bf16*>(w), b,
      nullptr, static_cast<bf16*>(out), M, N, K, n_slices, st);
}

// LN + qkv + RoPE (DINOv3 ViT-7B's LN1 + qkv at K = 4,096, heads of 128):
// the LayerNorm pass into `normed`, then the streamed tile with the RoPE
// epilogue (gemm_wgmma.cuh kBiasRope): q and k of the tokens from `prefix`
// on of each `seq` rows rotated by the f32 tables cos, sin [seq - prefix,
// 128] in f32 before the one rounding, v and the prefix as the bias epilogue
// leaves them. N = 3 K. No TPU kernel: the JAX package has no RoPE model.
extern "C" int tt_ln_rope_dense(const void* x, const float* ln_s, const float* ln_b,
                                const void* w, const float* b, const float* cos,
                                const float* sin, void* normed, void* out, int M, int N, int K,
                                int seq, int prefix, int n_slices, float eps, void* stream) {
  using tt::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = tt::launch_ln_wide(static_cast<const bf16*>(x), ln_s, ln_b,
                                           static_cast<bf16*>(normed), M, K, eps, st);
  if (e != cudaSuccess) return (int)e;
  tt::RopeArgs rope;
  rope.cos = cos, rope.sin = sin, rope.seq = seq, rope.prefix = prefix;
  rope.rot_cols = 2 * (N / 3);
  return (int)tt::launch_gemm_rope(static_cast<const bf16*>(normed), static_cast<const bf16*>(w),
                                   b, static_cast<bf16*>(out), M, N, K, n_slices, rope, st);
}

// LN1 + qkv of SAM's windowed blocks: the LayerNorm pass into window order
// (`normed`, bf16 [frames nw^2 win^2, K], the padded rows zeros: SAM pads
// LN1's output) out of x [frames, grid^2, K], then the streamed tile with the
// bias epilogue over every window row (a padded row's qkv is the bias). No
// TPU kernel: the JAX package has no windowed model.
extern "C" int tt_ln_window_dense(const void* x, const float* ln_s, const float* ln_b,
                                  const void* w, const float* b, void* normed, void* out,
                                  int frames, int grid, int window, int N, int K,
                                  int n_slices, void* stream) {
  using tt::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = tt::launch_ln_window(static_cast<const bf16*>(x), ln_s, ln_b,
                                             static_cast<bf16*>(normed), frames, grid, window,
                                             K, st);
  if (e != cudaSuccess) return (int)e;
  const int nw = (grid + window - 1) / window;
  return (int)tt::launch_gemm<false, tt::kBias>(
      static_cast<const bf16*>(normed), nullptr, nullptr, static_cast<const bf16*>(w), b,
      nullptr, static_cast<bf16*>(out), frames * nw * nw * window * window, N, K, n_slices, st);
}

extern "C" int tt_dense_residual(const void* y, const void* x, const void* w,
                                 const float* b, void* out, int M, int N, int K,
                                 int n_slices, void* stream) {
  using tt::bf16;
  return (int)tt::launch_gemm<false, tt::kBiasResidual>(
      static_cast<const bf16*>(y), nullptr, nullptr, static_cast<const bf16*>(w),
      b, static_cast<const bf16*>(x), static_cast<bf16*>(out), M, N, K, n_slices,
      static_cast<cudaStream_t>(stream));
}

// How the tile lays out the product [M, K] x [K, N] on a card of sms
// multiprocessors (ln: with the LayerNorm prologue; epi: 0 bias, 1 bias +
// GELU, 2 bias + residual, 3 SwiGLU, N the product's columns, 4 RoPE): out[0] = the
// rows of a block, out[1] = the ring's stages, out[2] = its dynamic shared
// memory in bytes, out[3] = the output columns of a unit of work, out[4] =
// the form (tt::gemm::Form). For the tests that hold
// ops/fused_block.gemm_plan to it.
extern "C" int tt_gemm_route(int ln, int epi, int M, int N, int K, int sms, int* out) {
  const tt::gemm::Route r = tt::gemm::route(ln != 0, epi, M, N, K, sms);
  out[0] = r.block_rows, out[1] = r.stages, out[2] = r.smem;
  out[3] = r.unit_cols, out[4] = r.form;
  return 0;
}
