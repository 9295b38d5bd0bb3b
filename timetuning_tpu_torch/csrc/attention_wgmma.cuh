// Device and host code shared by the kernels that run on Hopper's warpgroup
// tensor-core instructions: the flash kernel (flash_attention.cu) and the
// whole-sequence kernel (mha.cu), both in bf16 at a head width of 64, and the
// GEMM tile of the block kernels (gemm_wgmma.cuh), whose K steps are 64 wide.
//
// What is here:
//   * mbarrier, named-barrier and TMA (cp.async.bulk.tensor) wrappers, loads
//     and stores, and the host functions that encode a 4-D tensor map over a
//     strided [B, H, S, Dh] bf16 view (Dh 64 or 32) and a 2-D one over a [rows, cols] matrix
//     in boxes 64 columns wide (cuTensorMapEncodeTiled, found through
//     cudaGetDriverEntryPoint: the library links no libcuda);
//   * the shared-memory matrix descriptor of wgmma for the one layout all
//     three kernels use: rows of 64 bf16 (128 bytes, one 128-byte swizzle
//     atom), eight rows a 1,024-byte group, exactly what TMA writes with
//     CU_TENSOR_MAP_SWIZZLE_128B into a 1,024-byte aligned tile. A K tile
//     [keys, 64] read this way is K-major for q k^T, as are the GEMM tile's
//     A and W panels; a V tile [keys, 64] is MN-major for p v (the transpose
//     bit of the instruction). The whole-sequence core (mha.cu) also takes
//     heads of 32: rows of 32 bf16 are 64 bytes, one 64-byte swizzle atom,
//     eight rows a 512-byte group (CU_TENSOR_MAP_SWIZZLE_64B, layout type 2
//     of the descriptor): head_desc<Dh> gives either;
//   * wgmma.mma_async wrappers (m64nNk16, f32 accumulators in registers):
//     A and B from shared memory at N = 64, 128, 208 and 256,
//     A from registers for p v at N = 64 or 32 head features;
//   * the softmax pieces in the accumulator's own register layout.
//
// Register layout of a [64 x N] accumulator (one warpgroup): warp w of the
// group owns rows 16 w .. 16 w + 15; lane l owns rows 16 w + l / 4 and that
// + 8; d[4 j + 0, 1] are columns 8 j + 2 (l % 4) + 0, 1 of the first row and
// d[4 j + 2, 3] the same columns of the second. A row therefore lives in the
// 4 lanes of a quad: row reductions are two __shfl_xor_sync (1, 2). The
// accumulator fragment of the two 8-column blocks 2 k and 2 k + 1, packed to
// bf16 pairs, is the A fragment of k16 step k of the next product, so p goes
// from the softmax to p v without leaving registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tt {
namespace hopper {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kHeadDim = 64;
constexpr int kRowBytes = kHeadDim * 2;        // one bf16 row: a swizzle atom

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --------------------------------------------------------- mbarrier, TMA --
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

// after the inits of one thread, before the block's barrier: the inits
// become visible to the other threads and to the TMA unit
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of the map at (col, row, head, batch) into shared memory at dst
// (col: the box's first head feature, 64 for the second half of a head of
// 128, else 0); the bytes of the whole box (rows past the tensor's end arrive
// as zeros) are counted on bar
__device__ __forceinline__ void tma_load_at(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row, int head,
                                            int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head, int batch) {
  tma_load_at(dst, map, bar, 0, row, head, batch);
}

// one box of a 2-D map (make_2d_map) at (col, row): global to shared memory
// on bar, and shared memory to global (the part of the box past the tensor's
// edge is not written) as part of this thread's current bulk group
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src,
                                             int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(row)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// returns once at most kPending of this thread's committed bulk groups still
// read their shared memory; a thread waits for 0 before it exits
template <int kPending>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending) : "memory");
}

// ----------------------------------------------------------------- wgmma --
// The descriptor of a tile of 128-byte rows at a 1,024-byte aligned shared
// address (or a whole number of k16 steps into one): start address, stride
// byte offset 1,024 (one group of eight rows; the leading byte offset, which
// neither use of this layout reads, is set alike), 128-byte swizzle. A k16 step further along a K-major
// operand is 32 bytes (+2 in the descriptor); along an MN-major one it is 16
// rows, 2,048 bytes (+128).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (64ull << 16) |
         (64ull << 32) | (1ull << 62);
}
constexpr uint64_t kDescKStep = 2;        // K-major operand, one k16 step
constexpr uint64_t kDescRowStep = 128;    // MN-major operand, one k16 step

// The descriptor of a tile of Dh-wide bf16 rows (Dh = 64: smem_desc above;
// Dh = 32: 64-byte rows, 64-byte swizzle, a group of eight rows 512 bytes,
// the tile 512-byte aligned). A k16 step along a K-major operand is 32
// bytes either way; along an MN-major one 16 rows, 32 Dh bytes.
template <int Dh>
__device__ __forceinline__ uint64_t head_desc(uint32_t addr) {
  static_assert(Dh == 32 || Dh == 64, "heads of 32 or 64 bf16");
  constexpr uint64_t group = 8 * Dh * 2 / 16;     // eight rows, 16-byte units
  constexpr uint64_t layout = Dh == 64 ? 1 : 2;   // 128- or 64-byte swizzle
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (group << 16) |
         (group << 32) | (layout << 62);
}
template <int Dh>
__host__ __device__ constexpr uint64_t head_row_step() { return 16 * Dh * 2 / 16; }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// returns once at most kPending of this warpgroup's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// ------------------------------------------------- barriers among warps --
// Named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads: a
// sync waits until that many threads have arrived, an arrive does not wait.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// after plain stores to shared memory that a wgmma or a TMA store will read
// (the asynchronous proxy), before the barrier that hands them over
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// pins registers that a wgmma in flight reads or writes: the compiler keeps
// what comes before on one side of it and what comes after on the other
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[16] (+)= A[64 x 16] B[16 x 32], A from registers (a warp's 16 x 16
// fragment), B MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b_desc), "r"(accumulate));
}

// d[32] (+)= A[64 x 16] B[16 x 64], A from registers (a warp's 16 x 16
// fragment), B MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b_desc), "r"(accumulate));
}

// d[32] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a_desc,
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d[64] (+)= A[64 x 16] B[128 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a_desc,
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d[104] (+)= A[64 x 16] B[208 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[104], uint64_t a_desc,
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103},"
      " %104, %105, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d[128] (+)= A[64 x 16] B[256 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t a_desc,
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d[N / 2] = Q[64 x Dh] K[N x Dh]^T: Dh / 16 k16 steps, committed and awaited
template <int Dh = kHeadDim, int R>
__device__ __forceinline__ void qk_product(float (&d)[R], uint32_t q_addr,
                                           uint32_t k_addr) {
  const uint64_t qd = head_desc<Dh>(q_addr), kd = head_desc<Dh>(k_addr);
  pin(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Dh / 16; ++kk)
    wgmma_ss(d, qd + kk * kDescKStep, kd + kk * kDescKStep, kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  pin(d);
}

// o[64 x Dh] (+)= P[64 x 16 KS] V[16 KS x Dh] with P in registers (pa, four
// a k16 step) and V at v_addr; Dh = 2 R (64 or 32); committed and awaited
template <int KS, int R>
__device__ __forceinline__ void pv_product(float (&o)[R], uint32_t (&pa)[4 * KS],
                                           uint32_t v_addr, bool accumulate) {
  constexpr int Dh = 2 * R;
  const uint64_t vd = head_desc<Dh>(v_addr);
  pin(pa);
  pin(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
             vd + kk * head_row_step<Dh>(), accumulate || kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  pin(o);
  pin(pa);
}

// The two products above, issued and committed as one group each but not
// awaited, for a loop that runs a softmax while they are in flight: the
// caller waits (wgmma_wait<n>: groups complete in the order committed) and
// then pins the registers the group wrote or read before it touches them.
template <int Dh = kHeadDim, int R>
__device__ __forceinline__ void qk_issue(float (&d)[R], uint32_t q_addr, uint32_t k_addr) {
  const uint64_t qd = head_desc<Dh>(q_addr), kd = head_desc<Dh>(k_addr);
  pin(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Dh / 16; ++kk)
    wgmma_ss(d, qd + kk * kDescKStep, kd + kk * kDescKStep, kk > 0);
  wgmma_commit();
}

// o[64 x Dh] += P V as pv_product, issued and committed, not awaited
template <int KS, int R>
__device__ __forceinline__ void pv_issue(float (&o)[R], uint32_t (&pa)[4 * KS],
                                         uint32_t v_addr) {
  constexpr int Dh = 2 * R;
  const uint64_t vd = head_desc<Dh>(v_addr);
  pin(pa);
  pin(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
             vd + kk * head_row_step<Dh>(), 1);
  wgmma_commit();
}

// --------------------------------------------------------------- softmax --
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// keys at or beyond `valid` (column c of the tile is key col0 + c) to -1e30
template <int R>
__device__ __forceinline__ void mask_keys(float (&s)[R], int col0, int valid, int lane) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int c = col0 + 8 * j + 2 * (lane & 3);
    if (c >= valid) s[4 * j] = s[4 * j + 2] = kNeg;
    if (c + 1 >= valid) s[4 * j + 1] = s[4 * j + 3] = kNeg;
  }
}

// the largest raw score of this lane's two rows, over the row's whole quad
template <int R>
__device__ __forceinline__ void row_max(const float (&s)[R], float& mx0, float& mx1) {
  mx0 = fmaxf(s[0], s[1]);
  mx1 = fmaxf(s[2], s[3]);
#pragma unroll
  for (int j = 1; j < R / 4; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
}

// s <- 2^(s * scale_log2 - m) in place (m0, m1 in log2 units: the row's
// raw max times scale_log2 = scale * log2 e, so this is exp(s * scale - max));
// returns this lane's share of the two row sums
template <int R>
__device__ __forceinline__ void exp_rows(float (&s)[R], float scale_log2, float m0,
                                         float m1, float& sum0, float& sum1) {
  sum0 = sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    s[4 * j] = fast_exp2(fmaf(s[4 * j], scale_log2, -m0));
    s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], scale_log2, -m0));
    s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], scale_log2, -m1));
    s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], scale_log2, -m1));
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
}

// p * (f0, f1 by row) rounded to bf16, as the A fragments of R / 8 k16 steps
template <int R>
__device__ __forceinline__ void pack_rows(const float (&p)[R], float f0, float f1,
                                          uint32_t (&pa)[R / 2]) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    pa[2 * j] = pack_bf16(p[4 * j] * f0, p[4 * j + 1] * f0);
    pa[2 * j + 1] = pack_bf16(p[4 * j + 2] * f1, p[4 * j + 3] * f1);
  }
}

// o (this lane's two rows of a [64 x 2 R] accumulator, each value divided by
// its row's d0 or d1) to rows r0 and r0 + 8 of a [rows, 2 R] bf16 slice with
// row stride `stride`; rows at or beyond n_rows are not written
template <int R>
__device__ __forceinline__ void store_rows(const float (&o)[R], float d0, float d1,
                                           __nv_bfloat16* dst, long long stride,
                                           int r0, int n_rows, int lane) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    if (r0 < n_rows)
      *reinterpret_cast<uint32_t*>(dst + r0 * stride + c) =
          pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(dst + (r0 + 8) * stride + c) =
          pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

// ------------------------------------------------------------------ host --
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
    CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or nullptr
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<EncodeTiled>(fn);
  }();
  return encode;
}

// A tensor map over a [B, H, S, Dh] bf16 view with strides sb, sh, ss (in
// elements; the Dh head features contiguous, every stride a multiple of 8
// and the base 16-byte aligned) whose box is [box_rows, Dh] of one (batch,
// head): Dh = 64 128-byte swizzled, Dh = 32 64-byte swizzled (one row a
// swizzle atom either way, as head_desc<Dh> reads it). Dh = 128: a box is
// [box_rows, 64], one half of the head features (tma_load_at's col 0 or 64),
// 128-byte swizzled. Returns cudaSuccess or an error.
inline cudaError_t make_qkv_map(CUtensorMap* map, const void* base, int B, int H,
                                int S, long long sb, long long sh, long long ss,
                                int box_rows, int head_dim = kHeadDim) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (box_rows < 1 || box_rows > 256 || ss <= 0 || (H > 1 && sh <= 0) ||
      (B > 1 && sb <= 0) || (head_dim != 64 && head_dim != 32 && head_dim != 128))
    return cudaErrorInvalidValue;
  const int box_cols = head_dim == 128 ? 64 : head_dim;
  // a dimension of one element never uses its stride: give it a valid one
  const cuuint64_t row = static_cast<cuuint64_t>(ss) * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, H > 1 ? (cuuint64_t)sh * 2 : row,
                                 B > 1 ? (cuuint64_t)sb * 2 : row};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor map over a row-major [rows, cols] bf16 matrix (cols a multiple of
// 8, the base 16-byte aligned) whose box is [box_rows, 64 columns], 128-byte
// swizzled: a load zero-fills what lies past the matrix, a store skips it.
inline cudaError_t make_2d_map(CUtensorMap* map, const void* base, long long rows,
                               long long cols, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (box_rows < 1 || box_rows > 256 || rows < 1 || cols < 8 || cols % 8 != 0)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {kHeadDim, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
      box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace tt
