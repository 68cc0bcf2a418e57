// The Griffin-Lim spectral step on [rows, n_fft] frames, as three kernels
// behind one C call.
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
// to Fp and the time axis from n_fft to Np (multiples of 64); padded matrix
// entries are zero and padded bins get zero magnitude, so the padding
// contributes nothing.
//
// Bound on the H100: tensor-core operations.  At 800 rows and n_fft 2048 the
// four products are ~13.4 GFLOP against ~33 MB of frames, magnitudes, bf16
// matrices and output.
//
// Design: the TPU kernel keeps a [256-row, n_fft] f32 output block resident
// in vector memory and sweeps the frequency tiles over it, so the spectra
// never leave the core; on Hopper that block is 2 MB, far above a block's
// 227 KB of shared memory.  The step is split at its two GEMMs instead, both
// on the warp-specialised TMA + wgmma core of wgmma_gemm.cuh:
//  (1) a 16-byte pass rounds the f32 frames to bf16 once, into [rows, Np]
//      (zero past n_fft), so the forward GEMM's A operand comes in by TMA;
//  (2) the forward GEMM over the interleaved matrix [Np, 2 Fp] (per 64-bin
//      tile, 64 DFT_RE columns then 64 DFT_IM columns; held transposed,
//      K-major): one m64n128 wgmma yields the re and im of the same bins in
//      one thread's registers (columns c and c + 64), so the projection runs
//      there and the interleaved bf16 spectra [rows, 2 Fp] are stored once;
//  (3) the inverse GEMM, one accumulator over a K loop of 2 Fp against the
//      inverse matrices stacked to match the interleaved spectra.
// The TPU kernel rounds sre/sim to bf16 too, so the split changes only the
// f32 summation order.  Tiles are 128 x 128: at 800 rows and n_fft 2048,
// 7 x 17 = 119 blocks for (2) and 7 x 16 = 112 for (3), one wave each on
// 132 SMs.  Each tile reloads its operands from L2 (~250 MB per step at 800
// rows), which is what bounds the GEMMs now.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_gemm.cuh"

namespace {

constexpr int BN = 128, STAGES = 5;
typedef wg::Ring<BN, STAGES> StepRing;

}  // namespace

// (1) frames [rows, n_fft] f32 -> fb [rows, Np] bf16, zero past n_fft.  One
// thread per 8 columns; `vec` when rows of the frames are 16-byte aligned.
__global__ void __launch_bounds__(256) gl_spectral_cast_kernel(
    const float* __restrict__ frames, bf16* __restrict__ fb, int rows,
    int n_fft, int Np, bool vec) {
  const int per_row = Np / 8;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long>(rows) * per_row) return;
  const long row = idx / per_row;
  const int c = static_cast<int>(idx % per_row) * 8;
  const float* f = frames + row * n_fft + c;
  float x[8];
  if (vec && c + 8 <= n_fft) {
    const float4 a = *reinterpret_cast<const float4*>(f);
    const float4 b = *reinterpret_cast<const float4*>(f + 4);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = c + i < n_fft ? f[i] : 0.0f;
  }
  __align__(16) __nv_bfloat162 o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(fb + row * Np + c) =
      *reinterpret_cast<const uint4*>(o);
}

// (2) forward DFT of a 128-row x 64-bin tile, re and im, and the projection.
// grid = (row tiles, Fp / 64).  spec [rows, 2 Fp] bf16, interleaved.
__global__ void __launch_bounds__(wg::THREADS, 1) gl_spectral_dft_kernel(
    const __grid_constant__ CUtensorMap map_fb,
    const __grid_constant__ CUtensorMap map_fwd,
    const float* __restrict__ mag, bf16* __restrict__ spec, int rows, int F,
    int Np, int Fp) {
  extern __shared__ unsigned char smem[];
  const StepRing ring = wg::make_ring<BN, STAGES>(smem);
  const int m0 = blockIdx.x * wg::BM, nt = blockIdx.y;
  if (threadIdx.x >= wg::PRODUCER) {
    if (threadIdx.x == wg::PRODUCER) {
      const wg::Segment seg{&map_fb, &map_fwd, m0, nt * BN, Np / wg::BK};
      wg::produce(ring, &seg, 1);
    }
    return;
  }
  float acc[BN / 2];
  wg::zero(acc);
  int it = 0;
  wg::consume(acc, ring, Np / wg::BK, it);

  // registers k, k+1 hold the re of bins b, b+1; k+32, k+33 their im
#pragma unroll
  for (int k = 0; k < BN / 4; k += 2) {
    const int row = m0 + wg::acc_row(k);
    if (row >= rows) continue;
    const int c = wg::acc_col(k), bin = nt * 64 + c;
    const float* mrow = mag + static_cast<long>(row) * F;
    const float ma = bin < F ? mrow[bin] : 0.0f;
    const float mb = bin + 1 < F ? mrow[bin + 1] : 0.0f;
    const float re0 = acc[k], re1 = acc[k + 1];
    const float im0 = acc[k + 32], im1 = acc[k + 33];
    const float i0 = rsqrtf(fmaxf(re0 * re0 + im0 * im0, 1e-16f));
    const float i1 = rsqrtf(fmaxf(re1 * re1 + im1 * im1, 1e-16f));
    bf16* o = spec + static_cast<long>(row) * 2 * Fp + nt * BN + c;
    *reinterpret_cast<__nv_bfloat162*>(o) =
        __floats2bfloat162_rn(ma * re0 * i0, mb * re1 * i1);
    *reinterpret_cast<__nv_bfloat162*>(o + 64) =
        __floats2bfloat162_rn(ma * im0 * i0, mb * im1 * i1);
  }
}

// (3) inverse DFT of a 128-row x 128-sample tile: spec @ the stacked
// inverse matrices, one f32 accumulator.  grid = (row tiles, Np / 128,
// rounded up).
__global__ void __launch_bounds__(wg::THREADS, 1) gl_spectral_idft_kernel(
    const __grid_constant__ CUtensorMap map_spec,
    const __grid_constant__ CUtensorMap map_inv, float* __restrict__ out,
    int rows, int n_fft, int Fp) {
  extern __shared__ unsigned char smem[];
  const StepRing ring = wg::make_ring<BN, STAGES>(smem);
  const int m0 = blockIdx.x * wg::BM, n0 = blockIdx.y * BN;
  if (threadIdx.x >= wg::PRODUCER) {
    if (threadIdx.x == wg::PRODUCER) {
      const wg::Segment seg{&map_spec, &map_inv, m0, n0, 2 * Fp / wg::BK};
      wg::produce(ring, &seg, 1);
    }
    return;
  }
  float acc[BN / 2];
  wg::zero(acc);
  int it = 0;
  wg::consume(acc, ring, 2 * Fp / wg::BK, it);

  const bool pairs = n_fft % 2 == 0;
#pragma unroll
  for (int k = 0; k < BN / 2; k += 2) {
    const int row = m0 + wg::acc_row(k);
    const int n = n0 + wg::acc_col(k);
    if (row >= rows || n >= n_fft) continue;
    float* o = out + static_cast<long>(row) * n_fft + n;
    if (pairs) {
      *reinterpret_cast<float2*>(o) = make_float2(acc[k], acc[k + 1]);
    } else {
      o[0] = acc[k];
      if (n + 1 < n_fft) o[1] = acc[k + 1];
    }
  }
}

// All three kernels on `stream`.  fwd_t [2 Fp, Np]: the interleaved forward
// matrix, transposed (K-major B).  inv_t [Np, 2 Fp]: the stacked inverse
// matrices, transposed.  fb [rows, Np] and spec [rows, 2 Fp] bf16 are the
// caller's scratch.  Returns the first launch error, wg::MAP_ERROR + the
// driver's error when a tensor map cannot be encoded, or 0.
extern "C" int gl_spectral_step(const void* frames, const void* mag,
                                const void* fwd_t, const void* inv_t,
                                void* fb, void* spec, void* out, int rows,
                                int n_fft, int F, int Np, int Fp,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap m_fb, m_fwd, m_spec, m_inv;
  int err;
  if ((err = wg::make_map(&m_fb, fb, rows, Np, wg::BM)) ||
      (err = wg::make_map(&m_fwd, fwd_t, 2 * Fp, Np, BN)) ||
      (err = wg::make_map(&m_spec, spec, rows, 2 * Fp, wg::BM)) ||
      (err = wg::make_map(&m_inv, inv_t, Np, 2 * Fp, BN)) ||
      (err = wg::allow_smem(gl_spectral_dft_kernel, StepRing::SMEM_BYTES)) ||
      (err = wg::allow_smem(gl_spectral_idft_kernel, StepRing::SMEM_BYTES)))
    return err;

  const bool vec = n_fft % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(frames) % 16 == 0;
  const long cast_threads = static_cast<long>(rows) * (Np / 8);
  gl_spectral_cast_kernel<<<static_cast<unsigned>((cast_threads + 255) / 256),
                            256, 0, s>>>(static_cast<const float*>(frames),
                                         static_cast<bf16*>(fb), rows, n_fft,
                                         Np, vec);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  const unsigned row_tiles =
      static_cast<unsigned>((rows + wg::BM - 1) / wg::BM);
  gl_spectral_dft_kernel<<<dim3(row_tiles, Fp / 64), wg::THREADS,
                           StepRing::SMEM_BYTES, s>>>(
      m_fb, m_fwd, static_cast<const float*>(mag), static_cast<bf16*>(spec),
      rows, F, Np, Fp);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  gl_spectral_idft_kernel<<<dim3(row_tiles, (Np + BN - 1) / BN), wg::THREADS,
                            StepRing::SMEM_BYTES, s>>>(
      m_spec, m_inv, static_cast<float*>(out), rows, n_fft, Fp);
  return static_cast<int>(cudaGetLastError());
}
