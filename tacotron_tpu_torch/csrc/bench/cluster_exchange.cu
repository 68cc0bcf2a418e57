// What one exchange of state between the blocks of a thread-block cluster
// costs on this card: the step of csrc/gru.cu's cluster route in which every
// block sends its units' values (one 16-byte word per unit, 32 units) to
// every block and waits for all of them.  Four ways, each 2 x 200 exchanges
// in one launch, clusters of 1 to 16 blocks of 256 threads:
//
//   st.async + mbarrier   st.async words counted off the receiver's
//                         transaction barrier, a wait on one's own barrier
//                         (what csrc/gru.cu does)
//   st + cluster.sync     plain stores into the other blocks' shared memory,
//                         then barrier.cluster arrive (release) and wait
//                         (acquire)
//   st + relaxed barrier  the same with a relaxed arrive: no ordering of the
//                         stores, a lower bound and not a correct exchange
//   __syncthreads only    no exchange, the loop's own cost
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o cluster_exchange tacotron_tpu_torch/csrc/bench/cluster_exchange.cu
//   ./cluster_exchange
//
// Prints the device time per launch (CUDA events over 10 launches after 3)
// and per exchange.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdio>

#include "../wgmma_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int UNITS = 32;     // units a block sends per exchange
constexpr int STEPS = 400;    // exchanges per launch
constexpr int SMEM = 118784;  // one block per SM, as csrc/gru.cu launches

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

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) exchange(float* sink) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ __align__(8) unsigned long long bar;
  __shared__ float4 buf[16 * UNITS];
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const unsigned bar_u32 = wg::smem_addr(&bar), buf_u32 = wg::smem_addr(buf);
  if (threadIdx.x == 0) {
    wg::mbar_init(bar_u32, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < 16 * UNITS; i += THREADS)
    buf[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  cluster.sync();
  // thread t sends unit t % 32 of this block to blocks t / 32, t / 32 + 8
  const int unit = rank * UNITS + threadIdx.x % UNITS;
  float acc = 0.0f;
  for (int t = 0; t < STEPS; ++t) {
    const float4 v = make_float4(t, acc, 1.0f, 2.0f);
    if (MODE == 0) {
      if (threadIdx.x == 0)
        wg::mbar_expect_tx(bar_u32, n_blocks * UNITS * 16);
      for (int to = threadIdx.x / UNITS; to < n_blocks; to += THREADS / UNITS)
        st_async(map_rank(buf_u32 + unit * 16, to), v,
                 map_rank(bar_u32, to));
      wg::mbar_wait(bar_u32, t & 1);
    } else if (MODE == 1 || MODE == 2) {
      for (int to = threadIdx.x / UNITS; to < n_blocks; to += THREADS / UNITS)
        *cluster.map_shared_rank(buf + unit, to) = v;
      if (MODE == 1) {
        cluster.sync();
      } else {
        asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      }
    } else {
      __syncthreads();
    }
    acc += buf[(threadIdx.x * 7 + t) % (n_blocks * UNITS)].x;
  }
  cluster.sync();
  sink[(blockIdx.x * THREADS + threadIdx.x) % (16 * THREADS)] = acc;
}

template <int MODE>
float run(int blocks, float* sink) {
  cudaFuncSetAttribute(exchange<MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaFuncSetAttribute(exchange<MODE>,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  for (int i = 0; i < 3; ++i) cudaLaunchKernelEx(&cfg, exchange<MODE>, sink);
  cudaEventRecord(start);
  for (int i = 0; i < 10; ++i) cudaLaunchKernelEx(&cfg, exchange<MODE>, sink);
  cudaEventRecord(end);
  cudaEventSynchronize(end);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, start, end);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    std::printf("error: %s\n", cudaGetErrorString(err));
    return -1.0f;
  }
  return ms / 10;
}

}  // namespace

int main() {
  float* sink;
  cudaMalloc(&sink, 16 * THREADS * sizeof(float));
  const char* names[] = {"st.async + mbarrier", "st + cluster.sync",
                         "st + relaxed barrier", "__syncthreads only"};
  for (int blocks : {1, 2, 4, 8, 16}) {
    const float ms[] = {run<0>(blocks, sink), run<1>(blocks, sink),
                        run<2>(blocks, sink), run<3>(blocks, sink)};
    for (int m = 0; m < 4; ++m)
      std::printf("cluster of %2d  %-22s %.4f ms per launch, %.3f us per "
                  "exchange\n",
                  blocks, names[m], ms[m], ms[m] * 1e3 / STEPS);
  }
  cudaFree(sink);
  return 0;
}
