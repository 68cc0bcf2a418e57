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
// Design: one item's frame stack (>= 800 KB in bf16) and the DFT matrices
// (4.4 MB in bf16) are far beyond a block's 227 KB of shared memory, so the
// TPU kernel's one-block-per-item form does not carry over.  The iteration is
// split at its two GEMMs, both on the warp-specialised TMA + wgmma core of
// wgmma_gemm.cuh:
//  (1) framing + u/v split, 16-byte loads and stores;
//  (2) forward GEMM over the interleaved matrices [M, 2 NE] / [M, 2 NO]
//      (per 64-bin tile, 64 cosine columns then 64 sine columns; held
//      transposed, K-major, for the B operand).  One m64n128 wgmma yields the
//      re and im of the same 64 bins, and wgmma's accumulator layout gives a
//      thread column c and column c + 64 of the same row, so the phase
//      projection runs in registers and the interleaved bf16 spectra are
//      stored once;
//  (3) inverse GEMM: each block keeps the u2 and the v2 accumulator of the
//      same 64 output columns, each one K loop over the interleaved spectra
//      against the interleaved matrix (its rows are the B^T rows here), with
//      the [u2+v2 | u2-v2] * window epilogue;
//  (4) overlap-add and normalization, 16-byte loads and stores.
// Tiles: 128 rows x 128 columns for (2), 128 x 64 for (3).  At B=4, T=200
// (800 rows) that is 7 x 17 = 119 blocks for (2) and 7 x 16 = 112 for (3),
// one wave each on 132 SMs.  The chain still moves its intermediates (u/v,
// spectra, frames: ~13 MB written and read back per iteration at B=4,
// T=200) through device memory, and each 128-row tile reloads its operands
// from L2 (~150 MB per iteration), which is what bounds the GEMMs now.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ola_device.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr int FWD_BN = 128, FWD_STAGES = 5;
constexpr int INV_BN = 64, INV_STAGES = 6;
typedef wg::Ring<FWD_BN, FWD_STAGES> FwdRing;
typedef wg::Ring<INV_BN, INV_STAGES> InvRing;

__device__ __forceinline__ void load8(const float* p, float (&x)[8],
                                      bool vec) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = p[i];
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// (1) framing, analysis window, bf16 rounding and the u/v half split.
// sig [B, sig_len] f32 -> u, v [B*Ta, M] bf16.  One thread per 8 columns;
// `vec` when every 8-sample run is 16-byte aligned (hop and sig_len
// multiples of 4).
__global__ void __launch_bounds__(256) gl_frame_uv_kernel(
    const float* __restrict__ sig, const float* __restrict__ window,
    bf16* __restrict__ u, bf16* __restrict__ v, int Ta, int sig_len,
    int hop, int M, bool vec) {
  const int per_row = M / 8;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long>(Ta) * per_row) return;
  const int b = blockIdx.y;
  const int t = static_cast<int>(idx / per_row);
  const int m = static_cast<int>(idx % per_row) * 8;
  const float* s = sig + static_cast<long>(b) * sig_len +
                   static_cast<long>(t) * hop;
  float s1[8], s2[8], w1[8], w2[8];
  load8(s + m, s1, vec);
  load8(s + M + m, s2, vec);
  load8(window + m, w1, vec);
  load8(window + M + m, w2, vec);
  __align__(16) __nv_bfloat162 uo[4], vo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a0 = round_bf16(s1[2 * i] * w1[2 * i]);
    const float a1 = round_bf16(s1[2 * i + 1] * w1[2 * i + 1]);
    const float b0 = round_bf16(s2[2 * i] * w2[2 * i]);
    const float b1 = round_bf16(s2[2 * i + 1] * w2[2 * i + 1]);
    uo[i] = __floats2bfloat162_rn(a0 + b0, a1 + b1);
    vo[i] = __floats2bfloat162_rn(a0 - b0, a1 - b1);
  }
  const long o = (static_cast<long>(b) * Ta + t) * M + m;
  *reinterpret_cast<uint4*>(u + o) = *reinterpret_cast<const uint4*>(uo);
  *reinterpret_cast<uint4*>(v + o) = *reinterpret_cast<const uint4*>(vo);
}

// (2) forward DFT of the even bins from u and the odd bins from v, with the
// phase projection on the accumulators.  grid = (row tiles, NE/64 + NO/64):
// y walks the even bin tiles, then the odd ones.  x [rows, 2 N] bf16,
// interleaved as the matrices.
__global__ void __launch_bounds__(wg::THREADS, 1) gl_dft_project_kernel(
    const __grid_constant__ CUtensorMap map_u,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_we,
    const __grid_constant__ CUtensorMap map_wo,
    const float* __restrict__ mag_e, const float* __restrict__ mag_o,
    bf16* __restrict__ xe, bf16* __restrict__ xo, int rows, int M, int NE,
    int NO) {
  extern __shared__ unsigned char smem[];
  const FwdRing ring = wg::make_ring<FWD_BN, FWD_STAGES>(smem);
  const int tiles_e = NE / 64;
  const bool odd = static_cast<int>(blockIdx.y) >= tiles_e;
  const int nt = odd ? blockIdx.y - tiles_e : blockIdx.y;
  const int m0 = blockIdx.x * wg::BM;
  if (threadIdx.x >= wg::PRODUCER) {
    if (threadIdx.x == wg::PRODUCER) {
      const wg::Segment seg{odd ? &map_v : &map_u, odd ? &map_wo : &map_we,
                            m0, nt * FWD_BN, M / wg::BK};
      wg::produce(ring, &seg, 1);
    }
    return;
  }
  float acc[FWD_BN / 2];
  wg::zero(acc);
  int it = 0;
  wg::consume(acc, ring, M / wg::BK, it);

  const int N = odd ? NO : NE;
  const float* mag = odd ? mag_o : mag_e;
  bf16* out = odd ? xo : xe;
  // registers k, k+1 hold the re of bins c, c+1; k+32, k+33 their im
#pragma unroll
  for (int k = 0; k < FWD_BN / 4; k += 2) {
    const int row = m0 + wg::acc_row(k);
    if (row >= rows) continue;
    const int c = wg::acc_col(k);
    const float2 m = *reinterpret_cast<const float2*>(
        mag + static_cast<long>(row) * N + nt * 64 + c);
    const float re0 = acc[k], re1 = acc[k + 1];
    const float im0 = acc[k + 32], im1 = acc[k + 33];
    const float s0 = m.x * rsqrtf(fmaxf(re0 * re0 + im0 * im0, 1e-16f));
    const float s1 = m.y * rsqrtf(fmaxf(re1 * re1 + im1 * im1, 1e-16f));
    bf16* o = out + static_cast<long>(row) * 2 * N + nt * FWD_BN + c;
    *reinterpret_cast<__nv_bfloat162*>(o) =
        __floats2bfloat162_rn(re0 * s0, re1 * s1);
    *reinterpret_cast<__nv_bfloat162*>(o + 64) =
        __floats2bfloat162_rn(im0 * s0, im1 * s1);
  }
}

// (3) inverse DFT: u2 = xe @ we^T and v2 = xo @ wo^T for 64 output columns,
// then frames [rows, 2M] f32 = [u2 + v2 | u2 - v2] * window.
// grid = (row tiles, M / 64).
__global__ void __launch_bounds__(wg::THREADS, 1) gl_idft_window_kernel(
    const __grid_constant__ CUtensorMap map_xe,
    const __grid_constant__ CUtensorMap map_xo,
    const __grid_constant__ CUtensorMap map_we,
    const __grid_constant__ CUtensorMap map_wo,
    const float* __restrict__ window, float* __restrict__ frames, int rows,
    int M, int NE, int NO) {
  extern __shared__ unsigned char smem[];
  const InvRing ring = wg::make_ring<INV_BN, INV_STAGES>(smem);
  const int m0 = blockIdx.x * wg::BM, n0 = blockIdx.y * INV_BN;
  if (threadIdx.x >= wg::PRODUCER) {
    if (threadIdx.x == wg::PRODUCER) {
      const wg::Segment segs[2] = {
          {&map_xe, &map_we, m0, n0, 2 * NE / wg::BK},
          {&map_xo, &map_wo, m0, n0, 2 * NO / wg::BK}};
      wg::produce(ring, segs, 2);
    }
    return;
  }
  float u2[INV_BN / 2], v2[INV_BN / 2];
  wg::zero(u2);
  wg::zero(v2);
  int it = 0;
  wg::consume(u2, ring, 2 * NE / wg::BK, it);
  wg::consume(v2, ring, 2 * NO / wg::BK, it);

#pragma unroll
  for (int k = 0; k < INV_BN / 2; k += 2) {
    const int row = m0 + wg::acc_row(k);
    if (row >= rows) continue;
    const int n = n0 + wg::acc_col(k);
    const float2 wl = *reinterpret_cast<const float2*>(window + n);
    const float2 wh = *reinterpret_cast<const float2*>(window + M + n);
    float* f = frames + static_cast<long>(row) * 2 * M;
    *reinterpret_cast<float2*>(f + n) = make_float2(
        (u2[k] + v2[k]) * wl.x, (u2[k + 1] + v2[k + 1]) * wl.y);
    *reinterpret_cast<float2*>(f + M + n) = make_float2(
        (u2[k] - v2[k]) * wh.x, (u2[k + 1] - v2[k + 1]) * wh.y);
  }
}

// (4) full-length overlap-add of the new frames times 1/window-sumsquare.
// frames [B, Ta, n_fft] -> signal [B, sig_len].  One thread per 4 samples
// (sig_len is a multiple of 8); `vec` when hop and n_fft are multiples of 4,
// so the 4 samples lie in one hop block and one aligned run of each frame.
__global__ void __launch_bounds__(256) gl_ola_norm_kernel(
    const float* __restrict__ frames, const float* __restrict__ inv_norm,
    float* __restrict__ out, int Ta, int n_fft, int hop, int K, int sig_len,
    bool vec) {
  const long q = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long p = 4 * q;
  if (p >= sig_len) return;
  const int b = blockIdx.y;
  const float* fb = frames + static_cast<long>(b) * Ta * n_fft;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec) {
    // the order of ola_sample: chunk j of frame p/hop - j, j ascending
    const long blk = p / hop;
    for (int j = 0; j < K; ++j) {
      const long t = blk - j;
      if (t < 0) break;
      const int c = static_cast<int>(p - t * hop);
      if (c >= n_fft) break;
      if (t >= Ta) continue;
      const float4 f = *reinterpret_cast<const float4*>(fb + t * n_fft + c);
      acc.x += f.x, acc.y += f.y, acc.z += f.z, acc.w += f.w;
    }
  } else {
    acc.x = ola_sample<false>(fb, nullptr, p, Ta, n_fft, hop, K);
    acc.y = ola_sample<false>(fb, nullptr, p + 1, Ta, n_fft, hop, K);
    acc.z = ola_sample<false>(fb, nullptr, p + 2, Ta, n_fft, hop, K);
    acc.w = ola_sample<false>(fb, nullptr, p + 3, Ta, n_fft, hop, K);
  }
  const float4 inv = *reinterpret_cast<const float4*>(inv_norm + p);
  *reinterpret_cast<float4*>(out + static_cast<long>(b) * sig_len + p) =
      make_float4(acc.x * inv.x, acc.y * inv.y, acc.z * inv.z, acc.w * inv.w);
}

// Every entry point returns cudaGetLastError() after its launch, or
// wg::MAP_ERROR + the driver's error when a tensor map cannot be encoded.

extern "C" int gl_frame_uv(const void* sig, const void* window, void* u,
                           void* v, int B, int Ta, int sig_len, int hop,
                           int M, void* stream) {
  const bool vec = hop % 4 == 0 && sig_len % 4 == 0 && aligned16(sig) &&
                   aligned16(window);
  const dim3 grid(
      static_cast<unsigned>((static_cast<long>(Ta) * (M / 8) + 255) / 256),
      B);
  gl_frame_uv_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig), static_cast<const float*>(window),
      static_cast<bf16*>(u), static_cast<bf16*>(v), Ta, sig_len, hop, M, vec);
  return static_cast<int>(cudaGetLastError());
}

// we_t [2 NE, M] and wo_t [2 NO, M]: the interleaved forward matrices,
// transposed (K-major B operands).
extern "C" int gl_dft_project(const void* u, const void* v, const void* we_t,
                              const void* wo_t, const void* mag_e,
                              const void* mag_o, void* xe, void* xo, int rows,
                              int M, int NE, int NO, void* stream) {
  CUtensorMap mu, mv, me, mo;
  int err;
  if ((err = wg::make_map(&mu, u, rows, M, wg::BM)) ||
      (err = wg::make_map(&mv, v, rows, M, wg::BM)) ||
      (err = wg::make_map(&me, we_t, 2 * NE, M, FWD_BN)) ||
      (err = wg::make_map(&mo, wo_t, 2 * NO, M, FWD_BN)) ||
      (err = wg::allow_smem(gl_dft_project_kernel, FwdRing::SMEM_BYTES)))
    return err;
  const dim3 grid((rows + wg::BM - 1) / wg::BM, NE / 64 + NO / 64);
  gl_dft_project_kernel<<<grid, wg::THREADS, FwdRing::SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      mu, mv, me, mo, static_cast<const float*>(mag_e),
      static_cast<const float*>(mag_o), static_cast<bf16*>(xe),
      static_cast<bf16*>(xo), rows, M, NE, NO);
  return static_cast<int>(cudaGetLastError());
}

// we [M, 2 NE] and wo [M, 2 NO]: the interleaved forward matrices, whose
// rows are the inverse GEMM's B^T rows.
extern "C" int gl_idft_window(const void* xe, const void* xo, const void* we,
                              const void* wo, const void* window,
                              void* frames, int rows, int M, int NE, int NO,
                              void* stream) {
  CUtensorMap mxe, mxo, me, mo;
  int err;
  if ((err = wg::make_map(&mxe, xe, rows, 2 * NE, wg::BM)) ||
      (err = wg::make_map(&mxo, xo, rows, 2 * NO, wg::BM)) ||
      (err = wg::make_map(&me, we, M, 2 * NE, INV_BN)) ||
      (err = wg::make_map(&mo, wo, M, 2 * NO, INV_BN)) ||
      (err = wg::allow_smem(gl_idft_window_kernel, InvRing::SMEM_BYTES)))
    return err;
  const dim3 grid((rows + wg::BM - 1) / wg::BM, M / INV_BN);
  gl_idft_window_kernel<<<grid, wg::THREADS, InvRing::SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      mxe, mxo, me, mo, static_cast<const float*>(window),
      static_cast<float*>(frames), rows, M, NE, NO);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gl_ola_norm(const void* frames, const void* inv_norm,
                           void* out, int B, int Ta, int n_fft, int hop,
                           int sig_len, void* stream) {
  const int K = (n_fft + hop - 1) / hop;
  const bool vec = hop % 4 == 0 && n_fft % 4 == 0 && aligned16(frames);
  const dim3 grid((sig_len / 4 + 255) / 256, B);
  gl_ola_norm_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(inv_norm),
      static_cast<float*>(out), Ta, n_fft, hop, K, sig_len, vec);
  return static_cast<int>(cudaGetLastError());
}
