// Windowed, normalized, centered overlap-add: frames [B, T, n_fft] f32 ->
// signal [B, num_samples] f32.
//
// Replaces the TPU kernel tacotron_tpu/ops/pallas/ola.py::_ola_kernel
// (driven by overlap_add_batched), the overlap-add inside the matmul_half
// Griffin-Lim engine.
//
// Bound on the H100: memory.  Every frame sample is read once and every
// output sample written once, with two flops per frame sample, far below the
// card's ~20 flops/byte f32 balance point.
//
// Design: one thread per output sample (b, s) of the centered signal.  The
// thread sums window[c] * frames[b, t, c] over the <= K frames t that cover
// it and divides by the overlap-added squared window.  Neighbouring threads
// hold neighbouring samples, so for each t a warp reads 32 consecutive frame
// samples (coalesced), and each frame sample is read by exactly one thread.
// The centering slice is folded into the index: no intermediate is written.
// Unlike the TPU kernel, which tiles signal blocks and falls back to XLA for
// stacks shorter than its tile, this kernel takes every T.
#include <cuda_runtime.h>

#include "ola_device.cuh"

__global__ void __launch_bounds__(256) ola_centered_kernel(
    const float* __restrict__ frames, const float* __restrict__ window,
    const float* __restrict__ norm, float* __restrict__ out, int T,
    int n_fft, int hop, int K, int num_samples) {
  const long s = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= num_samples) return;
  const int b = blockIdx.y;
  const long p = s + n_fft / 2;
  const float acc = ola_sample<true>(
      frames + static_cast<long>(b) * T * n_fft, window, p, T, n_fft, hop, K);
  out[static_cast<long>(b) * num_samples + s] = acc / norm[p];
}

extern "C" int ola_centered(const void* frames, const void* window,
                            const void* norm, void* out, int B, int T,
                            int n_fft, int hop, int num_samples,
                            void* stream) {
  const int K = (n_fft + hop - 1) / hop;
  const dim3 grid((num_samples + 255) / 256, B);
  ola_centered_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(window),
      static_cast<const float*>(norm), static_cast<float*>(out), T, n_fft,
      hop, K, num_samples);
  return static_cast<int>(cudaGetLastError());
}
