// One Griffin-Lim iteration over the carried full-length signal, as a chain
// of four kernels.
//
// Replaces the TPU kernel tacotron_tpu/ops/pallas/gl_fused.py::_gl_iter_kernel
// (driven by gl_iteration), the default Griffin-Lim engine on the serving
// path.  Per batch item and iteration it computes
//
//   frames  = window * signal[t*hop : t*hop + n_fft]         (rounded to bf16)
//   u, v    = x1 + x2, x1 - x2 over the frame halves          (bf16)
//   X_even  = u @ [e_r | e_i],  X_odd = v @ [o_r | o_i]       (bf16 in, f32 acc)
//   X      *= mag_s * rsqrt(max(|X|^2, 1e-16))                (rounded to bf16)
//   u2, v2  = X_even @ [e_r | e_i]^T, X_odd @ [o_r | o_i]^T   (bf16 in, f32 acc)
//   frames' = [u2 + v2 | u2 - v2] * window
//   signal' = overlap-add(frames') * inv_norm                 (full length)
//
// where mag_s are the target magnitudes with the inverse DFT's Hermitian
// weights folded in, and padded frame rows and padded bins carry zero
// magnitude, so they contribute nothing.
//
// Bound on the H100: tensor-core operations.  At B=4, T=200, n_fft 2048 the
// eight products are ~6.7 GFLOP per iteration against ~10 MB of inputs and
// outputs, well above the card's ~295 bf16 flops/byte balance point.
//
// Design: one item's frame stack (>= 800 KB in bf16) and the four DFT
// matrices (4.7 MB) are far beyond a block's 227 KB of shared memory, so the
// TPU kernel's one-block-per-item form does not carry over.  The iteration
// is split at its two GEMMs: (1) framing + u/v split, (2) forward GEMM with
// the phase projection as a block-local epilogue (each block owns the re and
// im tiles of the same bins), (3) inverse GEMM summing both products of each
// half, with the [u2+v2 | u2-v2] * window epilogue, (4) overlap-add and
// normalization through the device function shared with ola.cu.  The GEMMs
// are plain WMMA 16x16x16 bf16 tiles from shared memory (64x64 block tile,
// 4 warps): simple and right first.  The chain moves its intermediates
// (u/v, projected spectra, frames) through device memory, ~27 MB per
// iteration at B=4, T=200; fusing them away and moving to wgmma/TMA are the
// next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "ola_device.cuh"
#include "wmma_tiles.cuh"

namespace {
constexpr int SMEM_BYTES = 2 * BM * LDC * 4;  // the epilogue's two tiles
}  // namespace

// (1) framing, analysis window, bf16 rounding and the u/v half split.
// sig [B, sig_len] f32 -> u, v [B*Ta, M] bf16.  One thread per (row, m).
__global__ void __launch_bounds__(256) gl_frame_uv_kernel(
    const float* __restrict__ sig, const float* __restrict__ window,
    bf16* __restrict__ u, bf16* __restrict__ v, int Ta, int sig_len,
    int hop, int M) {
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long>(Ta) * M) return;
  const int b = blockIdx.y;
  const int t = static_cast<int>(idx / M), m = static_cast<int>(idx % M);
  const float* s = sig + static_cast<long>(b) * sig_len +
                   static_cast<long>(t) * hop;
  const float x1 = __bfloat162float(__float2bfloat16(s[m] * window[m]));
  const float x2 =
      __bfloat162float(__float2bfloat16(s[m + M] * window[m + M]));
  const long o = (static_cast<long>(b) * Ta + t) * M + m;
  u[o] = __float2bfloat16(x1 + x2);
  v[o] = __float2bfloat16(x1 - x2);
}

// (2) forward DFT of the even bins from u and the odd bins from v, with the
// phase projection in the epilogue.  grid.y walks the even bin tiles, then
// the odd ones; each block computes the re and im tiles of its bins.
__global__ void __launch_bounds__(THREADS) gl_dft_project_kernel(
    const bf16* __restrict__ u, const bf16* __restrict__ v,
    const bf16* __restrict__ e_r, const bf16* __restrict__ e_i,
    const bf16* __restrict__ o_r, const bf16* __restrict__ o_i,
    const float* __restrict__ mag_e, const float* __restrict__ mag_o,
    bf16* __restrict__ xe_r, bf16* __restrict__ xe_i,
    bf16* __restrict__ xo_r, bf16* __restrict__ xo_i, int rows, int M,
    int NE, int NO) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16(*sA)[LDA] = reinterpret_cast<bf16(*)[LDA]>(smem);
  bf16(*sBr)[LDB] = reinterpret_cast<bf16(*)[LDB]>(smem + BM * LDA * 2);
  bf16(*sBi)[LDB] =
      reinterpret_cast<bf16(*)[LDB]>(smem + BM * LDA * 2 + BK * LDB * 2);

  const int tiles_e = NE / BN;
  const bool odd = static_cast<int>(blockIdx.y) >= tiles_e;
  const int n0 = (odd ? blockIdx.y - tiles_e : blockIdx.y) * BN;
  const int N = odd ? NO : NE;
  const bf16* a_src = odd ? v : u;
  const bf16* b_re = odd ? o_r : e_r;
  const bf16* b_im = odd ? o_i : e_i;
  const float* mag = odd ? mag_o : mag_e;
  bf16* out_re = odd ? xo_r : xe_r;
  bf16* out_im = odd ? xo_i : xe_i;
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;

  Acc acc_re[2][2], acc_im[2][2];
  fill_zero(acc_re);
  fill_zero(acc_im);
  for (int k0 = 0; k0 < M; k0 += BK) {
    load_rows_tile(sA, a_src, rows, M, m0, k0);
    load_depth_tile(sBr, b_re, N, k0, n0);
    load_depth_tile(sBi, b_im, N, k0, n0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          br[2], bi[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &sA[wm * 32 + i * 16][kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(br[j], &sBr[kk][wn * 32 + j * 16], LDB);
        wmma::load_matrix_sync(bi[j], &sBi[kk][wn * 32 + j * 16], LDB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(acc_re[i][j], a[i], br[j], acc_re[i][j]);
          wmma::mma_sync(acc_im[i][j], a[i], bi[j], acc_im[i][j]);
        }
    }
    __syncthreads();
  }

  float(*sCr)[LDC] = reinterpret_cast<float(*)[LDC]>(smem);
  float(*sCi)[LDC] = reinterpret_cast<float(*)[LDC]>(smem + BM * LDC * 4);
  store_tile(sCr, acc_re, wm, wn);
  store_tile(sCi, acc_im, wm, wn);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int row = m0 + r;
    if (row >= rows) continue;
    const float re = sCr[r][c], im = sCi[r][c];
    const long o = static_cast<long>(row) * N + n0 + c;
    const float s = mag[o] * rsqrtf(fmaxf(re * re + im * im, 1e-16f));
    out_re[o] = __float2bfloat16(re * s);
    out_im[o] = __float2bfloat16(im * s);
  }
}

// (3) inverse DFT against the same matrices transposed, both products of
// each half summed in f32, and the [u2+v2 | u2-v2] * window epilogue.
// frames [rows, 2M] f32.  grid = (row tiles, M / BN).
__global__ void __launch_bounds__(THREADS) gl_idft_window_kernel(
    const bf16* __restrict__ xe_r, const bf16* __restrict__ xe_i,
    const bf16* __restrict__ xo_r, const bf16* __restrict__ xo_i,
    const bf16* __restrict__ e_r, const bf16* __restrict__ e_i,
    const bf16* __restrict__ o_r, const bf16* __restrict__ o_i,
    const float* __restrict__ window, float* __restrict__ frames, int rows,
    int M, int NE, int NO) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16(*sA)[LDA] = reinterpret_cast<bf16(*)[LDA]>(smem);
  bf16(*sB)[LDA] = reinterpret_cast<bf16(*)[LDA]>(smem + BM * LDA * 2);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;

  Acc acc_u[2][2], acc_v[2][2];
  fill_zero(acc_u);
  fill_zero(acc_v);
  accumulate_trans(acc_u, xe_r, e_r, rows, NE, m0, n0, sA, sB, wm, wn);
  accumulate_trans(acc_u, xe_i, e_i, rows, NE, m0, n0, sA, sB, wm, wn);
  accumulate_trans(acc_v, xo_r, o_r, rows, NO, m0, n0, sA, sB, wm, wn);
  accumulate_trans(acc_v, xo_i, o_i, rows, NO, m0, n0, sA, sB, wm, wn);

  float(*sU)[LDC] = reinterpret_cast<float(*)[LDC]>(smem);
  float(*sV)[LDC] = reinterpret_cast<float(*)[LDC]>(smem + BM * LDC * 4);
  store_tile(sU, acc_u, wm, wn);
  store_tile(sV, acc_v, wm, wn);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int row = m0 + r;
    if (row >= rows) continue;
    const int n = n0 + c;
    const float u2 = sU[r][c], v2 = sV[r][c];
    float* f = frames + static_cast<long>(row) * 2 * M;
    f[n] = (u2 + v2) * window[n];
    f[M + n] = (u2 - v2) * window[M + n];
  }
}

// (4) full-length overlap-add of the new frames times 1/window-sumsquare.
// frames [B, Ta, n_fft] -> signal [B, sig_len].  One thread per sample.
__global__ void __launch_bounds__(256) gl_ola_norm_kernel(
    const float* __restrict__ frames, const float* __restrict__ inv_norm,
    float* __restrict__ out, int Ta, int n_fft, int hop, int K,
    int sig_len) {
  const long p = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= sig_len) return;
  const int b = blockIdx.y;
  const float acc = ola_sample<false>(
      frames + static_cast<long>(b) * Ta * n_fft, nullptr, p, Ta, n_fft, hop,
      K);
  out[static_cast<long>(b) * sig_len + p] = acc * inv_norm[p];
}

extern "C" int gl_frame_uv(const void* sig, const void* window, void* u,
                           void* v, int B, int Ta, int sig_len, int hop,
                           int M, void* stream) {
  const dim3 grid(static_cast<unsigned>((static_cast<long>(Ta) * M + 255) /
                                        256),
                  B);
  gl_frame_uv_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig), static_cast<const float*>(window),
      static_cast<bf16*>(u), static_cast<bf16*>(v), Ta, sig_len, hop, M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gl_dft_project(const void* u, const void* v, const void* e_r,
                              const void* e_i, const void* o_r,
                              const void* o_i, const void* mag_e,
                              const void* mag_o, void* xe_r, void* xe_i,
                              void* xo_r, void* xo_i, int rows, int M,
                              int NE, int NO, void* stream) {
  const dim3 grid((rows + BM - 1) / BM, NE / BN + NO / BN);
  gl_dft_project_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(u), static_cast<const bf16*>(v),
      static_cast<const bf16*>(e_r), static_cast<const bf16*>(e_i),
      static_cast<const bf16*>(o_r), static_cast<const bf16*>(o_i),
      static_cast<const float*>(mag_e), static_cast<const float*>(mag_o),
      static_cast<bf16*>(xe_r), static_cast<bf16*>(xe_i),
      static_cast<bf16*>(xo_r), static_cast<bf16*>(xo_i), rows, M, NE, NO);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gl_idft_window(const void* xe_r, const void* xe_i,
                              const void* xo_r, const void* xo_i,
                              const void* e_r, const void* e_i,
                              const void* o_r, const void* o_i,
                              const void* window, void* frames, int rows,
                              int M, int NE, int NO, void* stream) {
  const dim3 grid((rows + BM - 1) / BM, M / BN);
  gl_idft_window_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xe_r), static_cast<const bf16*>(xe_i),
      static_cast<const bf16*>(xo_r), static_cast<const bf16*>(xo_i),
      static_cast<const bf16*>(e_r), static_cast<const bf16*>(e_i),
      static_cast<const bf16*>(o_r), static_cast<const bf16*>(o_i),
      static_cast<const float*>(window), static_cast<float*>(frames), rows,
      M, NE, NO);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gl_ola_norm(const void* frames, const void* inv_norm,
                           void* out, int B, int Ta, int n_fft, int hop,
                           int sig_len, void* stream) {
  const int K = (n_fft + hop - 1) / hop;
  const dim3 grid((sig_len + 255) / 256, B);
  gl_ola_norm_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(inv_norm),
      static_cast<float*>(out), Ta, n_fft, hop, K, sig_len);
  return static_cast<int>(cudaGetLastError());
}
