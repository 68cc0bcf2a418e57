// The Griffin-Lim spectral step on [rows, n_fft] frames, as two kernels.
//
// Replaces the TPU kernel tacotron_tpu/ops/pallas/griffin_lim.py::_kernel
// (driven by spectral_step), the inner step of the "pallas" Griffin-Lim
// engine.  It computes
//
//   re, im   = bf16(frames) @ DFT_RE, bf16(frames) @ DFT_IM    (f32 sums)
//   sre, sim = bf16(mag * re * rsqrt(max(re^2 + im^2, 1e-16))), same for im
//   out      = sre @ IDFT_RE + sim @ IDFT_IM                  (f32 sums)
//
// with the dense DFT matrices in bf16, the bins padded from F = n_fft/2 + 1
// to Fp and the time axis from n_fft to Np (multiples of the 64-column
// tile); padded matrix entries are zero and padded bins get zero magnitude,
// so the padding contributes nothing.
//
// Bound on the H100: tensor-core operations.  At 800 rows and n_fft 2048 the
// four products are ~13.4 GFLOP against ~33 MB of frames, magnitudes, bf16
// matrices and output.
//
// Design: the TPU kernel keeps a [256-row, n_fft] f32 output block resident
// in vector memory and sweeps the frequency tiles over it, so the spectra
// never leave the core; on Hopper that block is 2 MB, far above a block's
// 227 KB of shared memory.  The step is split at its two GEMMs instead:
// (1) the forward GEMM, which rounds the f32 frames to bf16 as it stages
// them and computes the re and im tiles of the same bins in one block, with
// the phase projection as its epilogue, writing bf16 sre/sim; (2) the
// inverse GEMM, which sums both products into one f32 accumulator.  The
// TPU kernel rounds sre/sim to bf16 too, so the split changes only the f32
// summation order.  Both GEMMs are the plain WMMA tiles of wmma_tiles.cuh
// (shared with gl_fused.cu).  A single fused kernel, with a few rows' f32
// accumulator in shared memory, is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "wmma_tiles.cuh"

namespace {

// the forward kernel's staging tiles and its two f32 epilogue tiles share
// the same bytes; the inverse kernel's four staging tiles and its one
// epilogue tile likewise
constexpr int FWD_SMEM = 2 * BM * LDC * 4;
constexpr int INV_STAGE = 2 * BM * LDA * 2 + 2 * BK * LDB * 2;
constexpr int INV_SMEM = INV_STAGE > BM * LDC * 4 ? INV_STAGE : BM * LDC * 4;

// BM x BK tile of a row-major f32 [rows, K] matrix at (m0, k0), rounded to
// bf16; entries past `rows` or `K` are zero.  Consecutive threads read
// consecutive columns.
__device__ __forceinline__ void load_rows_tile_f32(bf16 (*s)[LDA],
                                                   const float* __restrict__ a,
                                                   int rows, int K, int m0,
                                                   int k0) {
  for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
    const int r = i / BK, c = i % BK;
    const int row = m0 + r, col = k0 + c;
    float val = 0.0f;
    if (row < rows && col < K) val = a[static_cast<long>(row) * K + col];
    s[r][c] = __float2bfloat16(val);
  }
}

}  // namespace

// (1) forward DFT of a 64-row x 64-bin tile, re and im, and the projection.
// grid = (row tiles, Fp / BN).
__global__ void __launch_bounds__(THREADS) gl_spectral_dft_kernel(
    const float* __restrict__ frames, const float* __restrict__ mag,
    const bf16* __restrict__ dre, const bf16* __restrict__ dim,
    bf16* __restrict__ sre, bf16* __restrict__ sim, int rows, int n_fft,
    int F, int Np, int Fp) {
  __shared__ __align__(128) unsigned char smem[FWD_SMEM];
  bf16(*sA)[LDA] = reinterpret_cast<bf16(*)[LDA]>(smem);
  bf16(*sBr)[LDB] = reinterpret_cast<bf16(*)[LDB]>(smem + BM * LDA * 2);
  bf16(*sBi)[LDB] =
      reinterpret_cast<bf16(*)[LDB]>(smem + BM * LDA * 2 + BK * LDB * 2);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;

  Acc acc_re[2][2], acc_im[2][2];
  fill_zero(acc_re);
  fill_zero(acc_im);
  for (int k0 = 0; k0 < Np; k0 += BK) {
    load_rows_tile_f32(sA, frames, rows, n_fft, m0, k0);
    load_depth_tile(sBr, dre, Fp, k0, n0);
    load_depth_tile(sBi, dim, Fp, k0, n0);
    __syncthreads();
    mma_stage(acc_re, sA, sBr, wm, wn);
    mma_stage(acc_im, sA, sBi, wm, wn);
    __syncthreads();
  }

  float(*sCr)[LDC] = reinterpret_cast<float(*)[LDC]>(smem);
  float(*sCi)[LDC] = reinterpret_cast<float(*)[LDC]>(smem + BM * LDC * 4);
  store_tile(sCr, acc_re, wm, wn);
  store_tile(sCi, acc_im, wm, wn);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int row = m0 + r, bin = n0 + c;
    if (row >= rows) continue;
    const float re = sCr[r][c], im = sCi[r][c];
    const float m = bin < F ? mag[static_cast<long>(row) * F + bin] : 0.0f;
    const float inv = rsqrtf(fmaxf(re * re + im * im, 1e-16f));
    const long o = static_cast<long>(row) * Fp + bin;
    sre[o] = __float2bfloat16(m * re * inv);
    sim[o] = __float2bfloat16(m * im * inv);
  }
}

// (2) inverse DFT of a 64-row x 64-sample tile: sre @ IDFT_RE + sim @
// IDFT_IM in one f32 accumulator.  grid = (row tiles, Np / BN).
__global__ void __launch_bounds__(THREADS) gl_spectral_idft_kernel(
    const bf16* __restrict__ sre, const bf16* __restrict__ sim,
    const bf16* __restrict__ ire, const bf16* __restrict__ iim,
    float* __restrict__ out, int rows, int n_fft, int Np, int Fp) {
  __shared__ __align__(128) unsigned char smem[INV_SMEM];
  bf16(*sAr)[LDA] = reinterpret_cast<bf16(*)[LDA]>(smem);
  bf16(*sAi)[LDA] = reinterpret_cast<bf16(*)[LDA]>(smem + BM * LDA * 2);
  bf16(*sBr)[LDB] = reinterpret_cast<bf16(*)[LDB]>(smem + 2 * BM * LDA * 2);
  bf16(*sBi)[LDB] = reinterpret_cast<bf16(*)[LDB]>(smem + 2 * BM * LDA * 2 +
                                                   BK * LDB * 2);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;

  Acc acc[2][2];
  fill_zero(acc);
  for (int k0 = 0; k0 < Fp; k0 += BK) {
    load_rows_tile(sAr, sre, rows, Fp, m0, k0);
    load_rows_tile(sAi, sim, rows, Fp, m0, k0);
    load_depth_tile(sBr, ire, Np, k0, n0);
    load_depth_tile(sBi, iim, Np, k0, n0);
    __syncthreads();
    mma_stage(acc, sAr, sBr, wm, wn);
    mma_stage(acc, sAi, sBi, wm, wn);
    __syncthreads();
  }

  float(*sC)[LDC] = reinterpret_cast<float(*)[LDC]>(smem);
  store_tile(sC, acc, wm, wn);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int row = m0 + r, n = n0 + c;
    if (row < rows && n < n_fft)
      out[static_cast<long>(row) * n_fft + n] = sC[r][c];
  }
}

// Both kernels on `stream`; sre/sim [rows, Fp] bf16 are the caller's
// scratch.  Returns the first launch error, or 0.
extern "C" int gl_spectral_step(const void* frames, const void* mag,
                                const void* dre, const void* dim,
                                const void* ire, const void* iim, void* sre,
                                void* sim, void* out, int rows, int n_fft,
                                int F, int Np, int Fp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned row_tiles = static_cast<unsigned>((rows + BM - 1) / BM);
  gl_spectral_dft_kernel<<<dim3(row_tiles, Fp / BN), THREADS, 0, s>>>(
      static_cast<const float*>(frames), static_cast<const float*>(mag),
      static_cast<const bf16*>(dre), static_cast<const bf16*>(dim),
      static_cast<bf16*>(sre), static_cast<bf16*>(sim), rows, n_fft, F, Np,
      Fp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gl_spectral_idft_kernel<<<dim3(row_tiles, Np / BN), THREADS, 0, s>>>(
      static_cast<const bf16*>(sre), static_cast<const bf16*>(sim),
      static_cast<const bf16*>(ire), static_cast<const bf16*>(iim),
      static_cast<float*>(out), rows, n_fft, Np, Fp);
  return static_cast<int>(cudaGetLastError());
}
