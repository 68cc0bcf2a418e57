// WMMA bf16 tile helpers shared by the GEMM kernels of gl_fused.cu and
// griffin_lim.cu: a 64 x 64 block tile over 32-deep shared-memory stages,
// computed by 4 warps in a 2 x 2 grid of 32 x 32 warp tiles, with f32
// accumulation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // rows of a block tile
constexpr int BN = 64;        // columns of a block tile
constexpr int BK = 32;        // depth of one shared-memory stage
constexpr int THREADS = 128;  // 4 warps in a 2x2 grid, 32x32 each
constexpr int LDA = BK + 8;   // bf16 pitch of [rows][depth] tiles
constexpr int LDB = BN + 8;   // bf16 pitch of [depth][cols] tiles
constexpr int LDC = BN + 4;   // f32 pitch of the epilogue tiles

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;

// BM x BK tile of a row-major [rows, K] matrix at (m0, k0); rows past
// `rows` are zero.
__device__ __forceinline__ void load_rows_tile(bf16 (*s)[LDA],
                                               const bf16* __restrict__ a,
                                               int rows, int K, int m0,
                                               int k0) {
  for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    const int row = m0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows)
      val = *reinterpret_cast<const uint4*>(a + static_cast<long>(row) * K +
                                            k0 + c);
    *reinterpret_cast<uint4*>(&s[r][c]) = val;
  }
}

// BK x BN tile of a row-major [K, N] matrix at (k0, n0).
__device__ __forceinline__ void load_depth_tile(bf16 (*s)[LDB],
                                                const bf16* __restrict__ b,
                                                int N, int k0, int n0) {
  for (int i = threadIdx.x; i < BK * BN / 8; i += THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    *reinterpret_cast<uint4*>(&s[r][c]) = *reinterpret_cast<const uint4*>(
        b + static_cast<long>(k0 + r) * N + n0 + c);
  }
}

// BN x BK tile of a row-major [n, K] matrix at (n0, k0): the transposed
// operand of the inverse GEMM, read along its contiguous axis.
__device__ __forceinline__ void load_trans_tile(bf16 (*s)[LDA],
                                                const bf16* __restrict__ e,
                                                int K, int n0, int k0) {
  for (int i = threadIdx.x; i < BN * BK / 8; i += THREADS) {
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    *reinterpret_cast<uint4*>(&s[r][c]) = *reinterpret_cast<const uint4*>(
        e + static_cast<long>(n0 + r) * K + k0 + c);
  }
}

__device__ __forceinline__ void fill_zero(Acc (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

__device__ __forceinline__ void store_tile(float (*s)[LDC],
                                           Acc (&acc)[2][2], int wm,
                                           int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&s[wm * 32 + i * 16][wn * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
}

// acc += X[m0:m0+BM, :K] @ E[n0:n0+BN, :K]^T
__device__ __forceinline__ void accumulate_trans(
    Acc (&acc)[2][2], const bf16* __restrict__ x, const bf16* __restrict__ e,
    int rows, int K, int m0, int n0, bf16 (*sA)[LDA], bf16 (*sB)[LDA],
    int wm, int wn) {
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_rows_tile(sA, x, rows, K, m0, k0);
    load_trans_tile(sB, e, K, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &sA[wm * 32 + i * 16][kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &sB[wn * 32 + j * 16][kk], LDA);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// acc += sA[warp rows, :BK] @ sB[:BK, warp cols], with B held [depth][cols].
__device__ __forceinline__ void mma_stage(Acc (&acc)[2][2], bf16 (*sA)[LDA],
                                          bf16 (*sB)[LDB], int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    FragA a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], &sA[wm * 32 + i * 16][kk], LDA);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(b[j], &sB[kk][wn * 32 + j * 16], LDB);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

}  // namespace
