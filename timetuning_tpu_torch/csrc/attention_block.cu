// Attention residual branch of one ViT block, bf16 in and out:
//   out = x + proj(MHA(qkv(LN1(x))))
//
// Replaces the TPU kernel timetuning_tpu/ops/fused_block.py:_attn_kernel
// (:83, reached through _attn_pallas / attention_block_branch).
//
// What bounds it on the card: the three products. At the eval shape
// (B = 50 frames, S = 197 tokens, D = 384, 6 heads of 64) the qkv and proj
// GEMMs are 11.6 GFLOP and the attention core 3.0 GFLOP a block (0.0148 ms at
// the bf16 peak) against ~16 MB of x and out and 30 MB of qkv and merged
// rows that stay in the L2 cache: tensor-core rate decides, and at 77 row
// blocks of 128 on 132 SMs so does how the work is cut into waves; at the
// train step's 128 frames the qkv rows (58 MB) no longer fit the cache.
//
// Design. The TPU kernel holds a whole [Gb*S, 3D] block in VMEM; a frame's
// qkv rows (197 x 1,152 bf16 = 454 KB) do not fit a Hopper SM's 227 KB of
// shared memory, so the branch is three launches:
//   (a) the GEMM tile of gemm_wgmma.cuh with its LN1 prologue + bias
//       -> qkv [B*S, 3D] bf16 (the ln_dense kernel of rows_block.cu);
//   (b) the whole-sequence attention core of mha.cu (wgmma, the score strip
//       in registers, Q, K and V by TMA), which reads q, k and v in place as
//       strided views of the qkv rows (batch stride S*3D, head stride Dh, row
//       stride 3D) and writes merged [B*S, D]: one pass up to 256 tokens, two
//       up to 1,024, by the caller's plan (ops/attention.mha_plan), the same
//       code and the same plan check as kernel 10;
//   (c) the same GEMM tile with bias + residual summed in f32.
// bf16 rounding points match the plain composition (attention_block_xla):
// LN output, qkv, the normalised p, the per-head output, and the final sum.
// Dh = D / H is 64 (DINO, MSN, iBOT, LeoPART, ViT-B) or 32 (MoCo-v3 ViT-S/16:
// 12 heads of 32); the TPU kernel takes any Dh.
#include "gemm_wgmma.cuh"
#include "mha_core.cuh"

// slices_qkv, slices_proj: the two GEMMs' plans (ops/fused_block.gemm_plan);
// passes, keys: the core's (ops/attention.mha_plan). Each is checked where it
// is used.
extern "C" int tt_attention_block(const void* x, const float* ln_s,
                                  const float* ln_b, const void* w_qkv,
                                  const float* b_qkv, const void* w_proj,
                                  const float* b_proj, void* qkv, void* merged,
                                  void* out, int B, int S, int D, int H,
                                  int slices_qkv, int slices_proj, int passes,
                                  int keys, void* stream) {
  using tt::bf16;
  if (H <= 0 || D % H != 0 || (D / H != 64 && D / H != 32) || S <= 0 || B <= 0 ||
      (long long)B * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int Dh = D / H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  cudaError_t e = tt::launch_gemm<true, tt::kBias>(
      static_cast<const bf16*>(x), ln_s, ln_b, static_cast<const bf16*>(w_qkv),
      b_qkv, nullptr, static_cast<bf16*>(qkv), M, 3 * D, D, slices_qkv, st);
  if (e != cudaSuccess) return (int)e;
  const bf16* q = static_cast<const bf16*>(qkv);
  const long long sb = (long long)S * 3 * D, ss = 3 * D;
  e = tt::launch_mha_bf16(q, q + D, q + 2 * D, merged, B, H, S, Dh, passes, keys, sb,
                          Dh, ss, sb, Dh, ss, sb, Dh, ss, (long long)S * D, Dh, D, st);
  if (e != cudaSuccess) return (int)e;
  return (int)tt::launch_gemm<false, tt::kBiasResidual>(
      static_cast<const bf16*>(merged), nullptr, nullptr,
      static_cast<const bf16*>(w_proj), b_proj, static_cast<const bf16*>(x),
      static_cast<bf16*>(out), M, D, D, slices_proj, st);
}

extern "C" const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
