// Overlap-add of one output sample, for the last stage of the Griffin-Lim
// iteration (gl_fused.cu).
//
// Sample p of the full overlap-added signal sums sample (p - t*hop) of every
// frame t that covers it.  Hop block b = p / hop collects chunk j of frame
// b - j for j = 0..K-1 (K = ceil(n_fft / hop)), in that order, which is the
// order of the shifted-add formulation the JAX package uses.
#pragma once

template <bool kWindow>
__device__ __forceinline__ float ola_sample(
    const float* __restrict__ frames,  // [T, n_fft] frames of one item
    const float* __restrict__ window,  // [n_fft] synthesis window (kWindow)
    long p, int T, int n_fft, int hop, int K) {
  const long b = p / hop;
  float acc = 0.0f;
  for (int j = 0; j < K; ++j) {
    const long t = b - j;
    if (t < 0) break;
    const int c = static_cast<int>(p - t * hop);
    if (c >= n_fft) break;  // c grows with j
    if (t >= T) continue;
    const float f = frames[t * n_fft + c];
    acc += kWindow ? f * window[c] : f;
  }
  return acc;
}
