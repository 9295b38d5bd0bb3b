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
// What bounds them on the card: the product, 2*M*K*N FLOPs (21.7 GFLOP for
// the qkv rows of 50 frames of ViT-S/8 at 448: M = 156,850, K = 384,
// N = 1,152) against M*(K+N)*2 bytes of activations: above the bf16 ridge,
// so tensor-core rate decides.
//
// Design. The TPU kernels tile the rows so that VMEM use is constant in S;
// the GEMM tile of common.cuh (128x128 outputs a block, WMMA bf16 with f32
// accumulation, LN prologue, f32 epilogue) is row-tiled by construction, so
// each kernel is one launch of it: LN prologue + bias epilogue, or bias +
// f32 residual epilogue (one rounding, as the TPU kernel's
// (x.f32 + out).astype).
#include "common.cuh"

extern "C" int tt_ln_dense(const void* x, const float* ln_s, const float* ln_b,
                           const void* w, const float* b, void* out, int M,
                           int N, int K, void* stream) {
  using tt::bf16;
  return (int)tt::launch_gemm<true, tt::kBias>(
      static_cast<const bf16*>(x), ln_s, ln_b, static_cast<const bf16*>(w), b,
      nullptr, static_cast<bf16*>(out), M, N, K,
      static_cast<cudaStream_t>(stream));
}

extern "C" int tt_dense_residual(const void* y, const void* x, const void* w,
                                 const float* b, void* out, int M, int N, int K,
                                 void* stream) {
  using tt::bf16;
  return (int)tt::launch_gemm<false, tt::kBiasResidual>(
      static_cast<const bf16*>(y), nullptr, nullptr, static_cast<const bf16*>(w),
      b, static_cast<const bf16*>(x), static_cast<bf16*>(out), M, N, K,
      static_cast<cudaStream_t>(stream));
}
