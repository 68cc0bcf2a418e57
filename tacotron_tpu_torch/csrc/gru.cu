// A TF1-convention GRU over a whole sequence, with a per-step mask:
// x [T, N, D] f32, h0 [N, H], wg [D+H, 2H], bg [2H], wc [D+H, H], bc [H],
// mask [T, N] -> out [T, N, H] f32.  Per step:
//
//   [r, u] = sigmoid(x_t @ wg[:D] + h @ wg[D:] + bg)
//   c      = tanh(x_t @ wc[:D] + (r * h) @ wc[D:] + bc)
//   h_new  = u * h + (1 - u) * c
//   out_t  = h_new * m_t,   h = h * (1 - m_t) + h_new * m_t
//
// Replaces the TPU kernel tacotron_tpu/ops/pallas/gru.py::_gru_kernel (driven
// by _gru_pallas_raw / gru_sequence).  Everything is f32, on the CUDA cores
// (no TF32).
//
// Bound on the H100: f32 operations, 2 * T * N * (D + H) * 3H flops against
// the weights, inputs and outputs read and written once; but the T steps are
// sequential and each needs the whole previous h, so a latency floor of T
// dependent steps lies under any design.
//
// Design: the TPU kernel keeps both weight matrices resident in vector
// memory for all T steps.  In f32 they are 384 KB per direction at D=H=128
// and 1.5 MB at D=H=256, above a block's 227 KB of shared memory, so here
// they are read through the 50 MB L2 instead.  (1) gru_input_proj_kernel
// computes the input halves of both products for every step at once (a
// tiled f32 GEMM over T*N rows, bias included), so the time loop reads only
// the recurrent halves.  (2) gru_recurrent_kernel runs one block per row n:
// the block loops over T, keeps h, r*h and the gates in shared memory, and
// splits each product's columns over its threads (and, where a product has
// fewer columns than threads, its depth too, summed through shared memory),
// with block-wide barriers between the gate and candidate products.  Holding
// 1/8 of the weight columns in the shared memory of each block of an 8-block
// cluster, exchanging h through distributed shared memory, is later work.
#include <cuda_runtime.h>

namespace {

constexpr int PROJ_TILE = 64;     // output tile of the projection GEMM
constexpr int PROJ_DEPTH = 16;    // depth of one staged slice
constexpr int PROJ_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int REC_THREADS = 1024;

}  // namespace

// (1) out[M, C] = x[M, D] @ w[0:D, 0:C] + b, with w row-major of width C.
// grid = (ceil(M / 64), ceil(C / 64)).
__global__ void __launch_bounds__(PROJ_THREADS) gru_input_proj_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ out, int M, int D,
    int C) {
  __shared__ float sX[PROJ_DEPTH][PROJ_TILE + 1];
  __shared__ float sW[PROJ_DEPTH][PROJ_TILE];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * PROJ_TILE, c0 = blockIdx.y * PROJ_TILE;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += PROJ_DEPTH) {
    for (int i = threadIdx.x; i < PROJ_TILE * PROJ_DEPTH; i += PROJ_THREADS) {
      const int m = i / PROJ_DEPTH, k = i % PROJ_DEPTH;
      const int row = m0 + m, col = k0 + k;
      sX[k][m] = (row < M && col < D) ? x[static_cast<long>(row) * D + col]
                                      : 0.0f;
    }
    for (int i = threadIdx.x; i < PROJ_TILE * PROJ_DEPTH; i += PROJ_THREADS) {
      const int k = i / PROJ_TILE, c = i % PROJ_TILE;
      const int kr = k0 + k, col = c0 + c;
      sW[k][c] = (kr < D && col < C) ? w[static_cast<long>(kr) * C + col]
                                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PROJ_DEPTH; ++k) {
      float a[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sX[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = sW[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * v[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx * 4 + j;
      if (col < C) out[static_cast<long>(row) * C + col] = acc[i][j] + b[col];
    }
  }
}

// part[s * C + j] = sum over k in slice s of v[k] * w[k * C + j], for the
// C columns and nsl depth slices of a [K, C] row-major matrix; thread t
// takes column t % C of slice t / C (and further columns when C exceeds the
// block).  Ends with a barrier.
__device__ __forceinline__ void partial_matvec(const float* v,
                                               const float* __restrict__ w,
                                               int K, int C, int nsl,
                                               float* part) {
  const int span = (K + nsl - 1) / nsl;
  for (int j = threadIdx.x; j < C * nsl; j += blockDim.x) {
    const int col = j % C, sl = j / C;
    const int k_lo = sl * span, k_hi = min(K, k_lo + span);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int k = k_lo;
    for (; k + 8 <= k_hi; k += 8) {
      float wv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        wv[u] = __ldg(w + static_cast<long>(k + u) * C + col);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u & 3] += v[k + u] * wv[u];
    }
    for (; k < k_hi; ++k)
      acc[0] += v[k] * __ldg(w + static_cast<long>(k) * C + col);
    part[j] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  __syncthreads();
}

__device__ __forceinline__ float slices_sum(const float* part, int j, int C,
                                            int nsl) {
  float s = 0.0f;
  for (int sl = 0; sl < nsl; ++sl) s += part[sl * C + j];
  return s;
}

// (2) the recurrence of row n = blockIdx.x.  gx [T, N, 2H] and cx [T, N, H]
// hold the input halves with the biases; wgh [H, 2H] and wch [H, H] are the
// recurrent halves.  Shared memory: h, h', r*h [H] each, gates [2H], and the
// partial sums [max(blockDim, 2H) * ...] of partial_matvec.
__global__ void __launch_bounds__(REC_THREADS) gru_recurrent_kernel(
    const float* __restrict__ gx, const float* __restrict__ cx,
    const float* __restrict__ h0, const float* __restrict__ wgh,
    const float* __restrict__ wch, const float* __restrict__ mask,
    float* __restrict__ out, int T, int N, int H, int nsl_g, int nsl_c) {
  extern __shared__ float smem[];
  float* h = smem;
  float* h_next = h + H;
  float* rh = h_next + H;
  float* gate = rh + H;
  float* part = gate + 2 * H;
  const int n = blockIdx.x;
  for (int j = threadIdx.x; j < H; j += blockDim.x)
    h[j] = h0[static_cast<long>(n) * H + j];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const long row = static_cast<long>(t) * N + n;
    partial_matvec(h, wgh, H, 2 * H, nsl_g, part);
    for (int j = threadIdx.x; j < 2 * H; j += blockDim.x) {
      const float s = gx[row * 2 * H + j] + slices_sum(part, j, 2 * H, nsl_g);
      gate[j] = 1.0f / (1.0f + expf(-s));
    }
    __syncthreads();
    for (int j = threadIdx.x; j < H; j += blockDim.x) rh[j] = gate[j] * h[j];
    __syncthreads();
    partial_matvec(rh, wch, H, H, nsl_c, part);
    const float m = mask[row];
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float c = tanhf(cx[row * H + j] + slices_sum(part, j, H, nsl_c));
      const float u = gate[H + j];
      const float h_new = u * h[j] + (1.0f - u) * c;
      out[row * H + j] = h_new * m;
      h_next[j] = h[j] * (1.0f - m) + h_new * m;
    }
    __syncthreads();
    float* tmp = h;
    h = h_next;
    h_next = tmp;
  }
}

// The projections and the recurrence on `stream`; gx [T, N, 2H] and cx
// [T, N, H] are the caller's scratch.  Returns the first launch error, or 0.
extern "C" int gru_forward(const void* x, const void* h0, const void* wg,
                           const void* bg, const void* wc, const void* bc,
                           const void* mask, void* gx, void* cx, void* out,
                           int T, int N, int D, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = T * N;
  const unsigned row_tiles = static_cast<unsigned>((M + PROJ_TILE - 1) /
                                                   PROJ_TILE);
  const float* wgf = static_cast<const float*>(wg);
  const float* wcf = static_cast<const float*>(wc);
  gru_input_proj_kernel<<<dim3(row_tiles, (2 * H + PROJ_TILE - 1) / PROJ_TILE),
                          PROJ_THREADS, 0, s>>>(
      static_cast<const float*>(x), wgf, static_cast<const float*>(bg),
      static_cast<float*>(gx), M, D, 2 * H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_input_proj_kernel<<<dim3(row_tiles, (H + PROJ_TILE - 1) / PROJ_TILE),
                          PROJ_THREADS, 0, s>>>(
      static_cast<const float*>(x), wcf, static_cast<const float*>(bc),
      static_cast<float*>(cx), M, D, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // depth slices: as many as fill the block, each column once per slice
  const int nsl_g = 2 * H >= REC_THREADS ? 1 : REC_THREADS / (2 * H);
  const int nsl_c = H >= REC_THREADS ? 1 : REC_THREADS / H;
  const int part = max(nsl_g * 2 * H, nsl_c * H);
  const size_t smem = static_cast<size_t>(5 * H + part) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gru_recurrent_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gru_recurrent_kernel<<<N, REC_THREADS, smem, s>>>(
      static_cast<const float*>(gx), static_cast<const float*>(cx),
      static_cast<const float*>(h0), wgf + static_cast<long>(D) * 2 * H,
      wcf + static_cast<long>(D) * H, static_cast<const float*>(mask),
      static_cast<float*>(out), T, N, H, nsl_g, nsl_c);
  return static_cast<int>(cudaGetLastError());
}
