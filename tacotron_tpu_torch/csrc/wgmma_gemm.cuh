// Hopper GEMM core shared by gl_fused.cu (K1) and griffin_lim.cu (K3):
// warp-specialised, TMA-fed, wgmma-computed block tiles of BM x BN with f32
// accumulators in registers, for kernels that bring their own epilogue.
//
// Block: two consumer warpgroups (threads 0-255), each owning 64 rows of the
// 128-row tile, and one producer warp (threads 256-287) whose first thread
// issues every copy.  A ring of STAGES shared-memory stages holds one
// BM x BK tile of A and one BN x BK tile of B each; a stage is filled by two
// TMA loads (cp.async.bulk.tensor, 128-byte swizzle) that complete on the
// stage's "full" mbarrier, and handed back to the producer through its
// "empty" mbarrier once both warpgroups' wgmma have read it.
//
// Operands are K-major: A is a row-major [rows, K] matrix and B is held as
// the row-major [N, K] matrix of B^T, so each tile row is BK = 64 contiguous
// bf16 (128 bytes, one swizzle row).  The consumers issue
// wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulate) four times per stage,
// keep one commit group in flight, and release the stage whose group
// completed.  Rows of A or B past the matrix edge arrive as zeros (TMA's
// out-of-bounds fill), so no load is masked.
//
// A kernel describes its K loop as one or two segments (each an A map, a B
// map, their tile rows and a count of BK-deep stages); the producer walks
// them in order and the consumers accumulate each into a register array of
// their choice (consume()).  Tensor maps are encoded on the host per call
// (make_map) and passed as const __grid_constant__ CUtensorMap kernel
// parameters.  cuTensorMapEncodeTiled is a driver-API function: it is
// reached through the runtime's cudaGetDriverEntryPoint(ByVersion), so the
// libraries link against no driver library (cuda.h is included for its
// types only).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace wg {

constexpr int BM = 128;                  // rows of a block tile
constexpr int BK = 64;                   // depth of one stage (128 bytes)
constexpr int CONSUMERS = 2;             // consumer warpgroups, 64 rows each
constexpr int PRODUCER = CONSUMERS * 128;  // the thread that issues copies
constexpr int THREADS = PRODUCER + 32;   // plus the producer warp

// Shared-memory ring of STAGES stages, each an A tile then a B tile, then
// the 2 x STAGES mbarriers.  Tile bases are 1024-byte aligned, as the
// 128-byte swizzle requires.
template <int BN, int STAGES>
struct Ring {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
  static_assert(B_BYTES % 1024 == 0, "B tile must keep the 1024 alignment");
  uint32_t base;
  __device__ uint32_t a(int s) const { return base + s * STAGE_BYTES; }
  __device__ uint32_t b(int s) const { return a(s) + A_BYTES; }
  __device__ uint32_t full(int s) const {
    return base + STAGES * STAGE_BYTES + 8 * s;
  }
  __device__ uint32_t empty(int s) const { return full(STAGES + s); }
};

// One K loop: A rows [a_row, a_row + BM) and B^T rows [b_row, b_row + BN),
// `k_tiles` stages of BK from depth 0.
struct Segment {
  const CUtensorMap* a;
  const CUtensorMap* b;
  int a_row, b_row, k_tiles;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
// A wait that outlasts 2^26 polls (far beyond any copy or product of these
// kernels) traps, so a pipeline fault ends the launch with an error instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: the box at (inner coordinate c0, row c1) of `map` into shared memory
// at `dst`; its bytes complete the transaction count of `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// start address, leading offset 16 bytes (unused by this layout), stride
// 1024 bytes between 8-row groups, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions (they are not memory operations).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "l"(da), "l"(db), "r"(1));
}

// The ring in the kernel's dynamic shared memory, with its barriers
// initialised; every thread of the block calls it once, before any role
// branch.
template <int BN, int STAGES>
__device__ __forceinline__ Ring<BN, STAGES> make_ring(unsigned char* smem) {
  Ring<BN, STAGES> ring;
  ring.base = (smem_addr(smem) + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), CONSUMERS * 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// Producer (one thread): every stage of the segments in order.
template <int BN, int STAGES>
__device__ __forceinline__ void produce(const Ring<BN, STAGES>& ring,
                                        const Segment* segs, int n_segs) {
  int it = 0;
  for (int g = 0; g < n_segs; ++g) {
    const Segment& seg = segs[g];
    for (int k = 0; k < seg.k_tiles; ++k, ++it) {
      const int s = it % STAGES;
      mbar_wait(ring.empty(s), ((it / STAGES) & 1) ^ 1);
      mbar_expect_tx(ring.full(s), Ring<BN, STAGES>::STAGE_BYTES);
      tma_load(ring.a(s), seg.a, k * BK, seg.a_row, ring.full(s));
      tma_load(ring.b(s), seg.b, k * BK, seg.b_row, ring.full(s));
    }
  }
}

// Consumer warpgroups: acc (this warpgroup's 64 x BN tile, in wgmma's
// register layout) += the next k_tiles stages of the ring.  `it` counts the
// stages consumed so far across segments.
template <int BN, int STAGES>
__device__ __forceinline__ void consume(float (&acc)[BN / 2],
                                        const Ring<BN, STAGES>& ring,
                                        int k_tiles, int& it) {
  const uint32_t a_rows = (threadIdx.x / 128) * 64 * BK * 2;
  const bool signal = threadIdx.x % 32 == 0;
  int prev = -1;
  for (int k = 0; k < k_tiles; ++k, ++it) {
    const int s = it % STAGES;
    mbar_wait(ring.full(s), (it / STAGES) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = desc_sw128(ring.a(s) + a_rows + kk * 32);
      const uint64_t db = desc_sw128(ring.b(s) + kk * 32);
      if constexpr (BN == 128)
        wgmma_m64n128(acc, da, db);
      else
        wgmma_m64n64(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    if (prev >= 0 && signal) mbar_arrive(ring.empty(prev));
    prev = s;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (prev >= 0 && signal) mbar_arrive(ring.empty(prev));
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.0f;
}

// wgmma's accumulator layout: for even k, registers k and k+1 of a thread
// hold row acc_row(k), columns acc_col(k) and acc_col(k) + 1 of its
// warpgroup's 64-row tile; acc_row is relative to the block's BM rows.
__device__ __forceinline__ int acc_row(int k) {
  const int t = threadIdx.x % 128;
  return (threadIdx.x / 128) * 64 + (t / 32) * 16 + (t % 32) / 4 +
         8 * ((k / 2) % 2);
}
__device__ __forceinline__ int acc_col(int k) {
  return 2 * (threadIdx.x % 4) + 8 * (k / 4);
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Error code a C entry point returns when a tensor map cannot be encoded:
// MAP_ERROR + the CUresult (kept apart from cudaError_t values).
constexpr int MAP_ERROR = 100000;

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a row-major bf16 [rows, cols] matrix read in boxes of
// box_rows x BK with 128-byte swizzle; reads past the edges are zero.
// Returns 0 or MAP_ERROR + the driver's error.
inline int make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                    int box_rows) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return MAP_ERROR + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_ERROR + static_cast<int>(r);
}

// Sets the kernel's dynamic shared-memory limit and returns the error, if
// any (the launch that follows is checked by the caller).
template <class Kernel>
inline int allow_smem(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace wg
