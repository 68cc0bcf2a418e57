// Windowed, normalized, centered overlap-add: frames [B, T, n_fft] f32 ->
// signal [B, num_samples] f32.
//
// Replaces the TPU kernel tacotron_tpu/ops/pallas/ola.py::_ola_kernel
// (driven by overlap_add_batched), the overlap-add inside the matmul_half
// and pallas Griffin-Lim engines.
//
// Bound on the H100: memory.  Every frame sample is read once and every
// output sample written once, with two flops per frame sample, far below the
// card's ~20 flops/byte f32 balance point.
//
// Design: the TPU kernel's signal blocks.  Sample p of the full signal lies
// in hop block b = p / hop, at offset w = p % hop, and sums chunk j of frame
// b - j (its sample w + j * hop) for j = 0..K-1, K = ceil(n_fft / hop), in
// ascending j, the order of the plain version's shifted adds.  A thread
// takes V consecutive samples of one hop block (V = 4 where hop, n_fft,
// n_fft / 2 and num_samples are multiples of 4: 16-byte loads and stores;
// else 2 or 1), so its K frame reads are V-wide too, at addresses that step
// by n_fft - hop.  Its hop block comes from one 32-bit division.  It starts
// the frame loads of up to 8 chunks at once, with no branch: a chunk outside
// the stack reads the item's first sample and is left out of the sum.  The
// window's V values for each chunk come through the SM's read-only cache (a
// block-wide staging in shared memory costs a load round trip and a barrier
// in a kernel that makes one round of loads, and measured slower on the
// H100); each output group reads its V norm values once and divides by
// them, as the plain version does.  The centering slice is folded into the
// index: no intermediate is written.  Unlike the TPU kernel, which tiles
// signal blocks and falls back to XLA for stacks shorter than its tile, this
// kernel takes every T.  ops/kernels/ola.py::ola_plan chooses V and the
// tile.
#include <cuda_runtime.h>

namespace {

constexpr int OLA_THREADS = 256;
constexpr int OLA_TILE = OLA_THREADS;   // groups per block, one per thread
constexpr int OLA_CHUNKS = 8;           // loads in flight

template <int V>
struct Vec;
template <>
struct Vec<1> {
  float v[1];
  __device__ static Vec load(const float* p) { return {{*p}}; }
  __device__ void store(float* p) const { *p = v[0]; }
};
template <>
struct Vec<2> {
  float v[2];
  __device__ static Vec load(const float* p) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    return {{x.x, x.y}};
  }
  __device__ void store(float* p) const {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <>
struct Vec<4> {
  float v[4];
  __device__ static Vec load(const float* p) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    return {{x.x, x.y, x.z, x.w}};
  }
  __device__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

}  // namespace

// grid = (ceil(n_hb * hop / V / OLA_TILE), B).  Hop blocks hb_first ..
// hb_first + n_hb - 1 hold the output samples; group g of an item is hop
// block hb_first + g / (hop / V), offset (g % (hop / V)) * V.
template <int V>
__global__ void __launch_bounds__(OLA_THREADS) ola_centered_blocks_kernel(
    const float* __restrict__ frames, const float* __restrict__ window,
    const float* __restrict__ norm, float* __restrict__ out, int T,
    int n_fft, int hop, int K, int num_samples, int hb_first) {
  const int gp = hop / V;   // groups per hop block
  const int g = blockIdx.x * OLA_TILE + threadIdx.x;
  const int hb_off = g / gp;
  const int w = (g - hb_off * gp) * V, hb = hb_first + hb_off;
  const int p = hb * hop + w;               // first sample of the full signal
  const int s = p - n_fft / 2;              // ... of the centered output
  if (s < 0 || s >= num_samples) return;
  const float* fb = frames + static_cast<long>(blockIdx.y) * T * n_fft;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;
  for (int j0 = 0; j0 < K; j0 += OLA_CHUNKS) {
    Vec<V> f[OLA_CHUNKS];
    int col[OLA_CHUNKS];
#pragma unroll
    for (int jj = 0; jj < OLA_CHUNKS; ++jj) {
      const int j = j0 + jj, t = hb - j, c = w + j * hop;
      const bool take = j < K && t >= 0 && t < T && c < n_fft;
      col[jj] = take ? c : -1;
      f[jj] = Vec<V>::load(fb + (take ? t * n_fft + c : 0));
    }
#pragma unroll
    for (int jj = 0; jj < OLA_CHUNKS; ++jj) {
      if (col[jj] < 0) continue;
      const Vec<V> wv = Vec<V>::load(window + col[jj]);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] += __fmul_rn(f[jj].v[e], wv.v[e]);
    }
  }
  const Vec<V> nv = Vec<V>::load(norm + p);
  Vec<V> r;
#pragma unroll
  for (int e = 0; e < V; ++e) r.v[e] = acc[e] / nv.v[e];
  r.store(out + static_cast<long>(blockIdx.y) * num_samples + s);
}

namespace {

template <int V>
cudaError_t launch(const float* frames, const float* window,
                   const float* norm, float* out, int B, int T, int n_fft,
                   int hop, int num_samples, cudaStream_t s) {
  const int K = (n_fft + hop - 1) / hop;
  const int half = n_fft / 2;
  const int hb_first = half / hop;
  const int n_hb = (half + num_samples - 1) / hop - hb_first + 1;
  const long groups = static_cast<long>(n_hb) * (hop / V);
  const dim3 grid(static_cast<unsigned>((groups + OLA_TILE - 1) / OLA_TILE),
                  B);
  ola_centered_blocks_kernel<V><<<grid, OLA_THREADS, 0, s>>>(
      frames, window, norm, out, T, n_fft, hop, K, num_samples, hb_first);
  return cudaGetLastError();
}

}  // namespace

// vec and tile come from ops/kernels/ola.py::ola_plan; a plan this build
// cannot take (a vector width that does not divide hop, n_fft, n_fft / 2
// and num_samples, or another tile) returns cudaErrorInvalidValue.
extern "C" int ola_centered(const void* frames, const void* window,
                            const void* norm, void* out, int B, int T,
                            int n_fft, int hop, int num_samples, int vec,
                            int tile, void* stream) {
  if (tile != OLA_TILE || num_samples < 1 ||
      (vec != 1 && vec != 2 && vec != 4) || hop % vec != 0 ||
      n_fft % vec != 0 || (n_fft / 2) % vec != 0 || num_samples % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* f = static_cast<const float*>(frames);
  const float* w = static_cast<const float*>(window);
  const float* nm = static_cast<const float*>(norm);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec == 4   ? launch<4>(f, w, nm, o, B, T, n_fft, hop, num_samples, s)
      : vec == 2 ? launch<2>(f, w, nm, o, B, T, n_fft, hop, num_samples, s)
                 : launch<1>(f, w, nm, o, B, T, n_fft, hop, num_samples, s);
  return static_cast<int>(err);
}
