// The host launcher of the whole-sequence attention core in bf16 (defined in
// mha.cu beside its kernels), declared here for the other kernel that runs
// it: the attention block (attention_block.cu). One core, one plan check.
#pragma once

#include <cuda_runtime.h>

namespace tt {

// o = softmax(q k^T / sqrt(Dh)) v per (batch, head) on strided [B, H, S, Dh]
// bf16 views, Dh = 64 or 32, strides in elements (the Dh head features
// contiguous, every stride a multiple of 8, every base 16-byte aligned).
// 1 <= S <= 1,024; `passes`, `keys`: ops/attention.mha_plan(S), checked.
// Launches on `stream`.
cudaError_t launch_mha_bf16(const void* q, const void* k, const void* v, void* o,
                            int B, int H, int S, int Dh, int passes, int keys, long long qb,
                            long long qh, long long qs, long long kb, long long kh,
                            long long ks, long long vb, long long vh, long long vs,
                            long long ob, long long oh, long long os,
                            cudaStream_t stream);

}  // namespace tt
