// A TF1-convention GRU over a whole sequence, with a per-step mask:
// x [T, N, D] f32, h0 [N, H] f32, wg [D+H, 2H], bg [2H], wc [D+H, H], bc [H],
// mask [T, N] -> out [T, N, H] f32, where wg, bg, wc, bc and the mask are
// each f32 or bf16, as the TPU kernel takes them.  Per step:
//
//   [r, u] = sigmoid(x_t @ wg[:D] + h @ wg[D:] + bg)
//   c      = tanh(x_t @ wc[:D] + (r * h) @ wc[D:] + bc)
//   h_new  = u * h + (1 - u) * c
//   out_t  = h_new * m_t,   h = h * (1 - m_t) + h_new * m_t
//
// Replaces the TPU kernel tacotron_tpu/ops/pallas/gru.py::_gru_kernel (driven
// by _gru_pallas_raw / gru_sequence).  The arithmetic is f32, on the CUDA
// cores (no TF32): a bf16 operand is converted to f32 as it is loaded, which
// is exact, as the TPU kernel's products with preferred_element_type=f32 are.
// The element type of each bf16-capable operand is a bit of the C calls'
// `dtypes` (kOperand* below), read through a Src in every kernel, so the
// cluster kernel keeps its 32 instances (16 depths x products on and off)
// for every combination of types.
//
// Bound on the H100: f32 operations, 2 * T * N * (D + H) * 3H flops against
// the weights, inputs and outputs read and written once (0.0094 ms at the
// post-net's T=200, N=4, D=H=256).  Under any design lies a latency floor:
// the T steps are sequential, each needs the whole previous h, and r * h
// must be complete before the candidate product, so a step is two
// exchanges of state between the SMs that hold the weights.
//
// Design: the TPU kernel keeps both weight matrices resident in vector memory
// for all T steps.  Here (1) gru_input_proj_kernel computes the input halves
// of both products for every step at once, in one launch (a tiled f32 GEMM
// over T*N rows, bias included), off the dependent chain, so the time loop
// only needs the recurrent halves wg[D:] [H, 2H] and wc[D:] [H, H] (768 KB at
// H=256, more than one block's 227 KB of shared memory).  (2)
// gru_cluster_kernel, the persistent recurrence: a thread-block cluster of C
// blocks (one per 16 units, at most 16, the H100's largest cluster) serves a
// group of up to 4 batch rows.  Block k owns hidden units [k*Hs, (k+1)*Hs)
// and gathers their r, u and candidate columns of the recurrent halves into
// its shared memory once, before the time loop; no weight byte is read from
// L2 after that, and every row of the group shares each weight read.  Each
// block holds the whole state of its rows (h double-buffered, r*h) and, per
// step, computes its units' gates from h, sends r*h of its units to every
// block of the cluster, waits until all H units' r*h have arrived, computes
// its units' candidates and new state, stores out[t], sends h to every
// block, and waits for all of h.  The exchanges are st.async writes into the
// other blocks' shared memory, each counted off the receiver's transaction
// barrier (mbarrier), so a block waits on its own barrier: a cluster-wide
// barrier.cluster, whose release carries a GPU-scope fence, takes 0.85 us
// per exchange of 8 blocks against 0.34 us, and 1.05 against 0.50 us of 16
// (csrc/bench/cluster_exchange.cu on an H100 SXM at 700 W).  A warp takes
// four weight columns at a time for all four rows: its lanes split the depth
// (16-byte shared-memory reads of four columns at one depth), a butterfly of
// 16 shuffles leaves each lane pair one of the 16 sums, and the eight lanes
// that gather a unit's four rows send them, 16 bytes, to eight blocks at
// once.  The step's inputs (gx, cx, the mask) are loaded two steps ahead.
// (3) Where H is so large that a block's columns do not fit (H > 512 with
// 16 blocks), gru_recurrent_kernel streams the recurrent halves from L2
// every step, one block per row: the route ops/kernels/gru.py::cluster_plan
// picks from the shapes.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int PROJ_TILE = 64;     // output tile of the projection GEMM
constexpr int PROJ_DEPTH = 32;    // depth of one staged slice
constexpr int PROJ_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int REC_THREADS = 1024;  // streaming route

// cluster route
constexpr int CL_THREADS = 256;
constexpr int CL_WARPS = CL_THREADS / 32;
constexpr int CL_ROWS = 4;        // batch rows a cluster serves at most
constexpr int CL_MAX_BLOCKS = 16;  // the H100's largest cluster
constexpr int CL_MAX_KI = 16;     // depth chunks of 32: H <= 512
constexpr int CL_MAX_QW1 = 4;     // gate quads per warp (Hs <= 64)
constexpr int CL_MAX_QW2 = 2;     // candidate quads per warp

// bits of the C calls' `dtypes`: the operand is bf16 where its bit is set
constexpr int kOperandWg = 1, kOperandBg = 2, kOperandWc = 4, kOperandBc = 8,
              kOperandMask = 16;

}  // namespace

// An operand of f32 or bf16 elements: s[i] loads element i as f32.
struct Src {
  const void* p;
  int bf16;
  __device__ __forceinline__ float operator[](long i) const {
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                : static_cast<const float*>(p)[i];
  }
  // the operand from element i on
  __host__ __device__ Src from(long i) const {
    return {static_cast<const char*>(p) + i * (bf16 ? 2 : 4), bf16};
  }
};

// (1) Both input halves in one launch: gx[M, 2H] = x[M, D] @ wg[0:D] + bg
// and cx[M, H] = x @ wc[0:D] + bc, with wg and wc row-major of widths 2H
// and H.  grid = (ceil(M / 64), ceil(2H / 64) + ceil(H / 64)): the first
// column tiles are gx's, the rest cx's.
__global__ void __launch_bounds__(PROJ_THREADS) gru_input_proj_kernel(
    const float* __restrict__ x, Src wg, Src bg, Src wc, Src bc,
    float* __restrict__ gx, float* __restrict__ cx, int M, int D, int H) {
  __shared__ float sX[PROJ_DEPTH][PROJ_TILE + 1];
  __shared__ float sW[PROJ_DEPTH][PROJ_TILE];
  const int g_tiles = (2 * H + PROJ_TILE - 1) / PROJ_TILE;
  const bool gates = static_cast<int>(blockIdx.y) < g_tiles;
  const Src w = gates ? wg : wc;
  const Src b = gates ? bg : bc;
  float* out = gates ? gx : cx;
  const int C = gates ? 2 * H : H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * PROJ_TILE;
  const int c0 = (gates ? blockIdx.y : blockIdx.y - g_tiles) * PROJ_TILE;
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

// ---------------------------------------------------------------------------
// (2) the cluster route

__device__ __forceinline__ float component(float4 v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// p ? a : b on values, in one selp: the compiler cannot turn it into a
// select of addresses, which would move the operands' array to local memory
__device__ __forceinline__ float pick(bool p, float a, float b) {
  float out;
  asm("{\n.reg .pred q;\nsetp.ne.u32 q, %3, 0;\nselp.f32 %0, %1, %2, q;\n}\n"
      : "=f"(out)
      : "f"(a), "f"(b), "r"(static_cast<unsigned>(p)));
  return out;
}

// One step of the butterfly over 2 * HALF values a lane holds: the lane
// whose bit 2 * HALF is clear keeps the lower half and adds its partner's
// lower half, the other keeps and adds the upper half.
template <int HALF>
__device__ __forceinline__ void fold(float (&acc)[16], int lane) {
  const bool up = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = pick(up, acc[i], acc[i + HALF]);
    const float keep = pick(up, acc[i + HALF], acc[i]);
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

// The 16 sums s[r][c] = sum_k v[k][r] * w[k][c] of four rows r and four
// columns c over the depth HK = 32 * KI, for one warp: lane l reads depth
// l + 32 i of the four columns (wq [HK] float4, one column per component)
// and holds v at those depths in v4[i].  A butterfly over the lanes then
// leaves sum r * 4 + c = (l >> 1) in lanes l and l ^ 1.
template <int KI>
__device__ __forceinline__ float quad_dot(const float4* __restrict__ wq,
                                          const float4 (&v4)[KI], int lane) {
  float acc[16];
#pragma unroll
  for (int o = 0; o < 16; ++o) acc[o] = 0.0f;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const float4 w = wq[lane + 32 * i];
    const float wv[4] = {w.x, w.y, w.z, w.w};
    const float hv[4] = {v4[i].x, v4[i].y, v4[i].z, v4[i].w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r * 4 + c] = fmaf(hv[r], wv[c], acc[r * 4 + c]);
  }
  fold<8>(acc, lane);
  fold<4>(acc, lane);
  fold<2>(acc, lane);
  fold<1>(acc, lane);
  return acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 1);
}

// Distributed shared memory through transaction barriers: st.async writes a
// word into (a block of the cluster's) shared memory and counts its bytes
// off that block's mbarrier (wg::mbar_* of wgmma_gemm.cuh), so a block
// learns that all the words of a step have arrived by waiting on its own
// barrier, with no cluster-wide barrier and no memory fence.
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_async(unsigned addr, float4 v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// The four rows of column lane & 3 of a quad (lane 2 c + 8 r holds row r of
// column c), gathered into every lane, so that the eight lanes of a column
// can send it to eight blocks at once: every lane must take part.
__device__ __forceinline__ float4 gather_rows(float v, int lane) {
  const int src = 2 * (lane & 3);
  return make_float4(__shfl_sync(0xffffffffu, v, src),
                     __shfl_sync(0xffffffffu, v, src + 8),
                     __shfl_sync(0xffffffffu, v, src + 16),
                     __shfl_sync(0xffffffffu, v, src + 24));
}

// The columns a cluster block owns of the recurrent halves (units
// [u0, u0 + own) of r, u and the candidate), over the depth HK, into its
// shared memory in f32 (the `w` layout of gru_cluster_kernel), read once.
// Where both are f32, H and hs multiples of 4 and the weights 16-byte
// aligned, four units of one depth are one 16-byte load and one float4 of
// the layout; else (bf16 weights among them) warp w takes depths w, w + 8,
// ..., its lanes the columns of each part, converting each element.  Out
// of line: the kernel's 32 instances call one copy.
__device__ __noinline__ void gather_columns(float4* w4, Src wgh, Src wch,
                                            int H, int HK, int hs,
                                            int hs_pad, int u0, int own) {
  const int qr = hs_pad / 4;
  if (!wgh.bf16 && !wch.bf16 && (H & 3) == 0 && (hs & 3) == 0 &&
      ((reinterpret_cast<unsigned long>(wgh.p) |
        reinterpret_cast<unsigned long>(wch.p)) & 15) == 0) {
    const float* wgf = static_cast<const float*>(wgh.p);
    const float* wcf = static_cast<const float*>(wch.p);
    const int quads = 3 * qr;
#pragma unroll 4
    for (int i = threadIdx.x; i < HK * quads; i += CL_THREADS) {
      const int k = i / quads, qq = i - k * quads;
      const int part = qq / qr, c = (qq - part * qr) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (k < H && c < own)
        v = *reinterpret_cast<const float4*>(
            part == 2
                ? wcf + static_cast<long>(k) * H + u0 + c
                : wgf + static_cast<long>(k) * 2 * H + part * H + u0 + c);
      w4[qq * HK + k] = v;
    }
    return;
  }
  float* wf = reinterpret_cast<float*>(w4);
#pragma unroll 4
  for (int k = threadIdx.x / 32; k < HK; k += CL_WARPS) {
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      for (int c = threadIdx.x % 32; c < hs_pad; c += 32) {
        const int unit = u0 + c;
        float v = 0.0f;
        if (k < H && c < own)
          v = part == 2
                  ? wch[static_cast<long>(k) * H + unit]
                  : wgh[static_cast<long>(k) * 2 * H + part * H + unit];
        wf[((part * qr + c / 4) * HK + k) * 4 + (c & 3)] = v;
      }
    }
  }
}

// grid = (C, ceil(N / rows)), clusters of C blocks along x.  gx [T, N, 2H]
// and cx [T, N, H] hold the input halves with the biases; wgh [H, 2H] and
// wch [H, H] are the recurrent halves in the caller's layout.  Block k owns
// units [k * hs, min(H, (k + 1) * hs)), at least one; hs_pad = hs rounded up
// to 4, HK = H rounded up to 32 (= 32 * KI).  Shared memory, in float4:
//   w    [3 * hs_pad / 4][HK]  r, u and candidate columns, four per float4
//   h    [2][HK]               state of the group's rows, one per component
//   rh   [HK]                  r * h
//   gate [hs_pad]              the block's u gates
// and two transaction barriers: bar[0] completes once a step's r * h of all
// H units and the block's own u gates have arrived (16 (H + own) bytes),
// bar[1] once the step's new h of all H units has (16 H bytes).  A block
// sends step t + 1's words only after its bar[1] has seen every block's
// step-t state, which no block sends before its own bar[0] of step t has
// completed, so the words of two steps never meet at one barrier phase, and
// every buffer is read before anyone may overwrite it.
// kProducts = false compiles the products out (the sums are 0): what is
// left is the schedule's latency floor, the waits, the distributed
// shared-memory writes, the gate inputs and the output stores.
template <int KI, bool kProducts>
__global__ void __launch_bounds__(CL_THREADS, 1) gru_cluster_kernel(
    const float* __restrict__ gx, const float* __restrict__ cx,
    const float* __restrict__ h0, Src wgh, Src wch, Src mask,
    float* __restrict__ out, int T, int N, int H, int hs, int hs_pad,
    int rows) {
  constexpr int HK = 32 * KI;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int u0 = rank * hs;
  const int own = min(H, u0 + hs) - u0;
  const int n0 = blockIdx.y * rows;
  const int qr = hs_pad / 4;   // quads of r columns (and of u, and of c)
  const int q1 = 2 * qr;       // gate quads: r then u

  __shared__ __align__(8) unsigned long long bar[2];
  extern __shared__ float4 smem4[];
  float4* w4 = smem4;
  float4* hbuf = w4 + 3 * qr * HK;
  float4* rh = hbuf + 2 * HK;
  float4* gate = rh + HK;
  const unsigned bar_rh = wg::smem_addr(&bar[0]);
  const unsigned bar_h = wg::smem_addr(&bar[1]);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (threadIdx.x == 0) {
    wg::mbar_init(bar_rh, 1);
    wg::mbar_init(bar_h, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  gather_columns(w4, wgh, wch, H, HK, hs, hs_pad, u0, own);
  for (int k = threadIdx.x; k < HK; k += CL_THREADS) {
    float h[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + r;
      h[r] = (k < H && r < rows && n < N)
                 ? h0[static_cast<long>(n) * H + k] : 0.0f;
    }
    hbuf[k] = make_float4(h[0], h[1], h[2], h[3]);
    hbuf[HK + k] = zero4;
    rh[k] = zero4;
  }
  for (int i = threadIdx.x; i < hs_pad; i += CL_THREADS) gate[i] = zero4;
  // every block of the cluster is running and initialised, its barriers
  // too, before any block writes into another's shared memory
  cluster.sync();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = lane >> 3;          // the row of this lane's sum
  const int c = (lane >> 1) & 3;    // its column within the quad
  const int n = n0 + r;
  const bool row_ok = r < rows && n < N;
  // after gather_rows, lane l sends column lane & 3 to blocks l >> 2,
  // (l >> 2) + 8, ...
  const int send_c = lane & 3, send_to = lane >> 2;
  const unsigned rh_u32 = wg::smem_addr(rh);
  const unsigned gate_u32 = wg::smem_addr(gate);
  const unsigned hbuf_u32 = wg::smem_addr(hbuf);

  // The inputs of this lane's sums (gx and cx of its unit and row, the
  // row's mask), loaded two steps ahead: in[0] holds step t, in[1] step t+1.
  // Each comes from one column of [T, N, *], at a fixed stride per step.
  struct StepInputs {
    float g[CL_MAX_QW1], c[CL_MAX_QW2], m;
  } in[2];
  const float* g_src[CL_MAX_QW1];
  const float* c_src[CL_MAX_QW2];
#pragma unroll
  for (int j = 0; j < CL_MAX_QW1; ++j) {
    const int q = warp + j * CL_WARPS;
    const int part = q / qr, cl = (q - part * qr) * 4 + c;
    g_src[j] = (row_ok && q < q1 && cl < own)
                   ? gx + static_cast<long>(n) * 2 * H + part * H + u0 + cl
                   : nullptr;
  }
#pragma unroll
  for (int j = 0; j < CL_MAX_QW2; ++j) {
    const int cl = (warp + j * CL_WARPS) * 4 + c;
    c_src[j] = (row_ok && cl < own) ? cx + static_cast<long>(n) * H + u0 + cl
                                    : nullptr;
  }
  auto load_inputs = [&](int t, StepInputs& dst) {
    const bool ok = t < T;
#pragma unroll
    for (int j = 0; j < CL_MAX_QW1; ++j)
      dst.g[j] = (ok && g_src[j]) ? g_src[j][static_cast<long>(t) * N * 2 * H]
                                  : 0.0f;
#pragma unroll
    for (int j = 0; j < CL_MAX_QW2; ++j)
      dst.c[j] = (ok && c_src[j]) ? c_src[j][static_cast<long>(t) * N * H]
                                  : 0.0f;
    dst.m = (ok && row_ok) ? mask[static_cast<long>(t) * N + n] : 0.0f;
  };
  load_inputs(0, in[0]);
  load_inputs(1, in[1]);

  for (int t = 0; t < T; ++t) {
    const int parity = t & 1;
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(bar_rh, 16 * (H + own));
      wg::mbar_expect_tx(bar_h, 16 * H);
    }
    const float4* hc = hbuf + parity * HK;
    const unsigned h_next_u32 = hbuf_u32 + (parity ^ 1) * HK * 16;
    const StepInputs cur = in[0];
    in[0] = in[1];
    load_inputs(t + 2, in[1]);

    // gates of the block's units: r * h into every block, u into this one
    float4 v4[KI];
    if (kProducts && warp < q1) {
#pragma unroll
      for (int i = 0; i < KI; ++i) v4[i] = hc[lane + 32 * i];
    }
#pragma unroll
    for (int j = 0; j < CL_MAX_QW1; ++j) {
      const int q = warp + j * CL_WARPS;
      if (q >= q1) break;
      const float s = kProducts ? quad_dot<KI>(w4 + q * HK, v4, lane) : 0.0f;
      const int part = q / qr, cl = (q - part * qr) * 4 + c;
      const float g = 1.0f / (1.0f + expf(-(s + cur.g[j])));
      const int sl = (q - part * qr) * 4 + send_c;   // the column sent
      if (part == 0) {
        const float4 v = gather_rows(
            cl < own ? g * component(hc[u0 + cl], r) : 0.0f, lane);
        if (sl < own)
          for (int to = send_to; to < n_blocks; to += 8)
            st_async(map_rank(rh_u32 + (u0 + sl) * 16, to), v,
                     map_rank(bar_rh, to));
      } else {
        const float4 v = gather_rows(g, lane);
        if (sl < own && send_to == 0)
          st_async(map_rank(gate_u32 + sl * 16, rank), v,
                   map_rank(bar_rh, rank));
      }
    }
    wg::mbar_wait(bar_rh, parity);

    // candidates and new state of the block's units: h into every block
    if (kProducts && warp < qr) {
#pragma unroll
      for (int i = 0; i < KI; ++i) v4[i] = rh[lane + 32 * i];
    }
#pragma unroll
    for (int j = 0; j < CL_MAX_QW2; ++j) {
      const int q = warp + j * CL_WARPS;
      if (q >= qr) break;
      const float s =
          kProducts ? quad_dot<KI>(w4 + (q1 + q) * HK, v4, lane) : 0.0f;
      const int cl = q * 4 + c;
      const bool valid = cl < own;
      const int unit = u0 + (valid ? cl : 0);
      const float cand = tanhf(s + cur.c[j]);
      const float u = reinterpret_cast<const float*>(gate)[cl * 4 + r];
      const float h_old = component(hc[unit], r);
      const float h_new = u * h_old + (1.0f - u) * cand;
      if ((lane & 1) == 0 && valid && row_ok)
        out[(static_cast<long>(t) * N + n) * H + unit] = h_new * cur.m;
      const float4 v =
          gather_rows(h_old * (1.0f - cur.m) + h_new * cur.m, lane);
      const int sl = q * 4 + send_c;
      if (sl < own)
        for (int to = send_to; to < n_blocks; to += 8)
          st_async(map_rank(h_next_u32 + (u0 + sl) * 16, to), v,
                   map_rank(bar_h, to));
    }
    wg::mbar_wait(bar_h, parity);
  }
  // no block leaves while another may still address its shared memory
  cluster.sync();
}

// ---------------------------------------------------------------------------
// (3) the streaming route

// part[s * C + j] = sum over k in slice s of v[k] * w[k * C + j], for the
// C columns and nsl depth slices of a [K, C] row-major matrix; thread t
// takes column t % C of slice t / C (and further columns when C exceeds the
// block).  Ends with a barrier.
__device__ __forceinline__ void partial_matvec(const float* v, Src w, int K,
                                               int C, int nsl, float* part) {
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
        wv[u] = w[static_cast<long>(k + u) * C + col];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u & 3] += v[k + u] * wv[u];
    }
    for (; k < k_hi; ++k)
      acc[0] += v[k] * w[static_cast<long>(k) * C + col];
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

// The recurrence of row n = blockIdx.x, reading the recurrent halves
// wgh [H, 2H] and wch [H, H] through L2 every step.  Shared memory: h, h',
// r*h [H] each, gates [2H], and the partial sums of partial_matvec.
__global__ void __launch_bounds__(REC_THREADS) gru_recurrent_kernel(
    const float* __restrict__ gx, const float* __restrict__ cx,
    const float* __restrict__ h0, Src wgh, Src wch, Src mask,
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

// ---------------------------------------------------------------------------
// C entry points.  Each launches on `stream` and returns the first launch
// error, or 0.  `dtypes` holds a kOperand* bit for each of wg, bg, wc, bc
// and the mask that is bf16 (0: all f32).

// The input halves of every step: gx [T, N, 2H] = x @ wg[:D] + bg and
// cx [T, N, H] = x @ wc[:D] + bc (the caller's scratch), in one launch.
extern "C" int gru_projection(const void* x, const void* wg, const void* bg,
                              const void* wc, const void* bc, void* gx,
                              void* cx, int T, int N, int D, int H,
                              int dtypes, void* stream) {
  const int M = T * N;
  const dim3 grid((M + PROJ_TILE - 1) / PROJ_TILE,
                  (2 * H + PROJ_TILE - 1) / PROJ_TILE +
                      (H + PROJ_TILE - 1) / PROJ_TILE);
  gru_input_proj_kernel<<<grid, PROJ_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), Src{wg, (dtypes & kOperandWg) != 0},
      Src{bg, (dtypes & kOperandBg) != 0}, Src{wc, (dtypes & kOperandWc) != 0},
      Src{bc, (dtypes & kOperandBc) != 0}, static_cast<float*>(gx),
      static_cast<float*>(cx), M, D, H);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <int KI, bool kProducts>
cudaError_t launch_cluster(const float* gx, const float* cx, const float* h0,
                           Src wgh, Src wch, Src mask, float* out, int T,
                           int N, int H, int blocks, int hs, int rows,
                           int smem, cudaStream_t s) {
  auto kernel = gru_cluster_kernel<KI, kProducts>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (blocks > 8) {   // above the portable cluster size
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, (N + rows - 1) / rows);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int hs_pad = (hs + 3) / 4 * 4;
  return cudaLaunchKernelEx(&cfg, kernel, gx, cx, h0, wgh, wch, mask, out, T,
                            N, H, hs, hs_pad, rows);
}

template <bool kProducts>
cudaError_t dispatch_cluster(int ki, const float* gx, const float* cx,
                             const float* h0, Src wgh, Src wch, Src mask,
                             float* out, int T, int N, int H, int blocks,
                             int hs, int rows, int smem, cudaStream_t s) {
#define GRU_CLUSTER_CASE(K)                                                 \
  case K:                                                                   \
    return launch_cluster<K, kProducts>(gx, cx, h0, wgh, wch, mask, out, T, \
                                        N, H, blocks, hs, rows, smem, s);
  switch (ki) {
    GRU_CLUSTER_CASE(1)
    GRU_CLUSTER_CASE(2)
    GRU_CLUSTER_CASE(3)
    GRU_CLUSTER_CASE(4)
    GRU_CLUSTER_CASE(5)
    GRU_CLUSTER_CASE(6)
    GRU_CLUSTER_CASE(7)
    GRU_CLUSTER_CASE(8)
    GRU_CLUSTER_CASE(9)
    GRU_CLUSTER_CASE(10)
    GRU_CLUSTER_CASE(11)
    GRU_CLUSTER_CASE(12)
    GRU_CLUSTER_CASE(13)
    GRU_CLUSTER_CASE(14)
    GRU_CLUSTER_CASE(15)
    GRU_CLUSTER_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef GRU_CLUSTER_CASE
}

}  // namespace

// The recurrence over gx and cx, on the route the caller's plan names
// (ops/kernels/gru.py::cluster_plan): `blocks` > 0 is the cluster route with
// that many blocks per cluster, `hs` units per block, `rows` batch rows per
// cluster and `smem` bytes of dynamic shared memory per block; `blocks` == 0
// is the streaming route.  products == 0 (cluster route only) runs the
// schedule with the products compiled out.  A plan the kernels cannot take
// returns cudaErrorInvalidValue.
extern "C" int gru_recurrence(const void* gx, const void* cx, const void* h0,
                              const void* wg, const void* wc,
                              const void* mask, void* out, int T, int N,
                              int D, int H, int blocks, int hs, int rows,
                              int smem, int products, int dtypes,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the recurrent halves: rows D.. of wg and wc
  const Src wgh = Src{wg, (dtypes & kOperandWg) != 0}.from(
      static_cast<long>(D) * 2 * H);
  const Src wch = Src{wc, (dtypes & kOperandWc) != 0}.from(
      static_cast<long>(D) * H);
  const Src maskv{mask, (dtypes & kOperandMask) != 0};
  const float* gxf = static_cast<const float*>(gx);
  const float* cxf = static_cast<const float*>(cx);
  const float* h0f = static_cast<const float*>(h0);
  float* outf = static_cast<float*>(out);
  if (blocks > 0) {
    const int ki = (H + 31) / 32;
    const int hs_pad = (hs + 3) / 4 * 4;
    const int need = 4 * (3 * hs_pad * 32 * ki + 12 * 32 * ki + 4 * hs_pad);
    if (blocks > CL_MAX_BLOCKS || hs < 1 || blocks * hs < H ||
        (blocks - 1) * hs >= H ||
        hs_pad / 4 > CL_WARPS * CL_MAX_QW2 || rows < 1 || rows > CL_ROWS ||
        ki > CL_MAX_KI || smem < need)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        products ? dispatch_cluster<true>(ki, gxf, cxf, h0f, wgh, wch, maskv,
                                          outf, T, N, H, blocks, hs, rows,
                                          smem, s)
                 : dispatch_cluster<false>(ki, gxf, cxf, h0f, wgh, wch, maskv,
                                           outf, T, N, H, blocks, hs, rows,
                                           smem, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (!products) return static_cast<int>(cudaErrorInvalidValue);
  // depth slices: as many as fill the block, each column once per slice
  const int nsl_g = 2 * H >= REC_THREADS ? 1 : REC_THREADS / (2 * H);
  const int nsl_c = H >= REC_THREADS ? 1 : REC_THREADS / H;
  const int part = max(nsl_g * 2 * H, nsl_c * H);
  const size_t bytes = static_cast<size_t>(5 * H + part) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gru_recurrent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gru_recurrent_kernel<<<N, REC_THREADS, bytes, s>>>(
      gxf, cxf, h0f, wgh, wch, maskv, outf, T, N, H, nsl_g, nsl_c);
  return static_cast<int>(cudaGetLastError());
}
