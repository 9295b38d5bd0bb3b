// MLP residual branch of one ViT block, bf16 in and out:
//   out = x + fc2(GELU_erf(fc1(LN2(x))))
//
// Replaces the TPU kernels timetuning_tpu/ops/fused_block.py:_mlp_kernel
// (:158, reached through _mlp_pallas / mlp_block_branch: kernel 2) and
// _mlp_rows_kernel (:282, the same over the row chunks of sequences above
// 1,024 tokens: kernel 9).
//
// What bounds it on the card: the two GEMMs. At kernel 2's eval shape (B*S =
// 9,850 rows, D = 384, hidden 1,536) 23 GFLOP against ~8 MB of activations
// in and out plus a 30 MB bf16 hidden; at kernel 9's (156,850 rows of a
// ViT-S/8 448 group) 370 GFLOP against 240 MB plus a 482 MB hidden that is
// written once and read once: 0.37 ms by the operations, 0.40 ms for the two
// launches by their own bounds (fc1 0.19 by either; fc2 0.19 by operations,
// 0.22 by bytes). The operations decide, as long as the hidden's way out and
// back runs under the products.
//
// Design. The TPU kernel keeps the f32 hidden of a whole row block in VMEM.
// Here the branch is two launches of the tensor-core GEMM tile
// (gemm_wgmma.cuh: wgmma, W by TMA). First LN2 prologue + fc1 + bias + GELU
// over a resident normalised row block, the warpgroups by turns, rounded to
// a bf16 hidden [B*S, 4D] (the plain composition rounds the hidden to bf16
// at the same point). The GELU is the tile's one-range form (gelu_many: one
// polynomial, one ex2, no branch, exact to 3e-7), which runs under the
// other warpgroup's products where CUDA's two-range erff took twice their
// time; the TPU kernel's Abramowitz-Stegun erf existed only because Mosaic
// has no erf. Then fc2 + bias + the residual add in f32 with the hidden and
// W streamed over K = 4D: in the tile's wide form where the row blocks fill
// the card (the hidden read once: 0.36 against 0.41 ms at kernel 9's rows),
// by turns with a slice a column tile below that (kernel 2's 77 row blocks:
// 0.031 against 0.036 ms). Keeping the hidden on chip was counted and not
// built: two accumulators (the hidden chunk's and the output rows' [64 x
// 384]) do not fit a thread's registers at 128-row blocks, 64-row blocks read
// all of W1 and W2 (2.4 MB) for 36,864 clocks of products, 64 bytes a clock
// an SM, which is more than L2 delivers, and what it would save already runs
// under the products of the two launches.
#include "gemm_wgmma.cuh"

// The two launches apart (the timing tools and the card's check of the bf16
// hidden call them; the model calls tt_mlp_block). slices: the product's plan
// (ops/fused_block.gemm_plan).
extern "C" int tt_mlp_fc1(const void* x, const float* ln_s, const float* ln_b,
                          const void* w1, const float* b1, void* hidden, int M,
                          int D, int Hd, int slices, void* stream) {
  using tt::bf16;
  return (int)tt::launch_gemm<true, tt::kBiasGelu>(
      static_cast<const bf16*>(x), ln_s, ln_b, static_cast<const bf16*>(w1), b1,
      nullptr, static_cast<bf16*>(hidden), M, Hd, D, slices,
      static_cast<cudaStream_t>(stream));
}

extern "C" int tt_mlp_fc2(const void* hidden, const void* x, const void* w2,
                          const float* b2, void* out, int M, int D, int Hd,
                          int slices, void* stream) {
  using tt::bf16;
  return (int)tt::launch_gemm<false, tt::kBiasResidual>(
      static_cast<const bf16*>(hidden), nullptr, nullptr,
      static_cast<const bf16*>(w2), b2, static_cast<const bf16*>(x),
      static_cast<bf16*>(out), M, D, Hd, slices, static_cast<cudaStream_t>(stream));
}

// slices_fc1, slices_fc2: the two GEMMs' plans (ops/fused_block.gemm_plan).
extern "C" int tt_mlp_block(const void* x, const float* ln_s, const float* ln_b,
                            const void* w1, const float* b1, const void* w2,
                            const float* b2, void* hidden, void* out, int M,
                            int D, int Hd, int slices_fc1, int slices_fc2,
                            void* stream) {
  const int e = tt_mlp_fc1(x, ln_s, ln_b, w1, b1, hidden, M, D, Hd, slices_fc1, stream);
  if (e != 0) return e;
  return tt_mlp_fc2(hidden, x, w2, b2, out, M, D, Hd, slices_fc2, stream);
}

// DINOv2's SwiGLU MLP branch (no TPU kernel: the JAX package has no such
// model): out = x + w3(silu(a) * b), [a | b] = w12(LN2(x)) + b12, over the
// token rows. Three launches: the LayerNorm pass into `normed` (bf16 [M, D]),
// the tile's SwiGLU form writing the bf16 hidden [M, Hd] (w12 [2 Hd, D] read
// as 64 rows of each half a tile: the [M, 2 Hd] pre-activation is never
// written), then w3 + b3 + the residual in f32 as fc2; both products are
// wide where their row blocks fill the card. What bounds it: at DINOv2
// ViT-g's 25 x 1,029 rows the two products (647 + 324 GFLOP, 0.98 ms at the
// bf16 peak) against ~0.5 GB moved; the LayerNorm pass (158 MB) is bound by its bytes.
// slices_w12, slices_w3: the products' plans (ops/fused_block.gemm_plan, the
// first over 2 Hd columns).
extern "C" int tt_swiglu_mlp(const void* x, const float* ln_s, const float* ln_b,
                             const void* w12, const float* b12, const void* w3,
                             const float* b3, void* normed, void* hidden, void* out, int M,
                             int D, int Hd, int slices_w12, int slices_w3, void* stream) {
  using tt::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = tt::launch_ln_wide(static_cast<const bf16*>(x), ln_s, ln_b,
                                     static_cast<bf16*>(normed), M, D, st);
  if (e != cudaSuccess) return (int)e;
  e = tt::launch_gemm<false, tt::kBiasSwiglu>(
      static_cast<const bf16*>(normed), nullptr, nullptr, static_cast<const bf16*>(w12), b12,
      nullptr, static_cast<bf16*>(hidden), M, Hd, D, slices_w12, st);
  if (e != cudaSuccess) return (int)e;
  return tt_mlp_fc2(hidden, x, w3, b3, out, M, D, Hd, slices_w3, stream);
}
