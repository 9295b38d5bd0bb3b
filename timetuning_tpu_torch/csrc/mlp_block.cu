// MLP residual branch of one ViT block, bf16 in and out:
//   out = x + fc2(GELU_erf(fc1(LN2(x))))
//
// Replaces the TPU kernel timetuning_tpu/ops/fused_block.py:_mlp_kernel
// (reached through _mlp_pallas / mlp_block_branch).
//
// What bounds it on the card: the two GEMMs, ~37 GFLOP per block at the
// eval shape (B*S = 9850 rows, D=384, hidden 1536) against ~8 MB of
// activations in and out plus a 30 MB bf16 hidden: far above the bf16
// ridge, so tensor-core rate decides.
//
// Design. The TPU kernel keeps the f32 hidden of a whole row block in VMEM.
// Here the branch is two launches of the tensor-core GEMM tile
// (gemm_wgmma.cuh: wgmma, W by TMA): LN2 prologue + fc1 + bias + exact erff
// GELU over a resident normalised row block, rounded to a bf16 hidden
// [B*S, 4D] (the plain composition rounds the hidden to bf16 at the same
// point), then fc2 + bias + the residual add in f32 with the hidden and W
// streamed over K = 4D. The TPU kernel's Abramowitz-Stegun erf existed only
// because Mosaic has no erf; CUDA's erff is used as is. The tile was
// designed for the qkv and proj products (K = 384); the GELU's erff over the
// hidden runs in the epilogue, under the other warpgroup's products only.
#include "gemm_wgmma.cuh"

// slices_fc1, slices_fc2: the two GEMMs' plans (ops/fused_block.gemm_plan).
extern "C" int tt_mlp_block(const void* x, const float* ln_s, const float* ln_b,
                            const void* w1, const float* b1, const void* w2,
                            const float* b2, void* hidden, void* out, int M,
                            int D, int Hd, int slices_fc1, int slices_fc2,
                            void* stream) {
  using tt::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = tt::launch_gemm<true, tt::kBiasGelu>(
      static_cast<const bf16*>(x), ln_s, ln_b, static_cast<const bf16*>(w1), b1,
      nullptr, static_cast<bf16*>(hidden), M, Hd, D, slices_fc1, st);
  if (e != cudaSuccess) return (int)e;
  return (int)tt::launch_gemm<false, tt::kBiasResidual>(
      static_cast<const bf16*>(hidden), nullptr, nullptr,
      static_cast<const bf16*>(w2), b2, static_cast<const bf16*>(x),
      static_cast<bf16*>(out), M, D, Hd, slices_fc2, st);
}
