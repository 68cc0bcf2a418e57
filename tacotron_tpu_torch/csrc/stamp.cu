// Device clock stamps: one thread writes %globaltimer (ns, the same for
// every SM) into one int64 slot, in stream order.
//
// Replaces no TPU kernel.  A captured synthesis chunk
// (synth/synthesizer.py::Synthesizer._vocode_chunk) stamps its start, the
// end of its decode and the end of its vocoder into a 3-slot output, which
// a replay writes and the caller's per-chunk clone keeps: the device time
// of the two phases without a sync, and without an event that the next
// replay of the same graph would overwrite.
//
// Bound: launch latency; one thread, one 8-byte store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<int64_t>(t);
}

__global__ void globaltimer_stamp(int64_t* slot) { *slot = globaltimer(); }

}  // namespace

extern "C" int stamp(void* slot, void* stream) {
  globaltimer_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(slot));
  return static_cast<int>(cudaGetLastError());
}
