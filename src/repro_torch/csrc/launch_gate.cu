// A launch gate: holds a stream until the host has enqueued what follows.
//
// Not a port of a TPU kernel.  A pair of timing events around work the
// host is still enqueueing times the host: on a card left idle, the
// stream runs the start event at once and then waits for each launch (on
// an H100, 103-586 us between events around a batched entry whose kernel
// runs 19-20 us: tools/launch_span.py).  gate_kernel, queued before the
// start event, spins until the host writes its ticket to a word of pinned
// host memory, after the last launch of the batch is queued; the events
// and kernels behind it then run back to back and time the card alone.
//
// It never hangs the stream: past timeout_ns it writes its ticket to
// `late` and returns, and the host drops that batch's time (something
// under the gate waited for the card, or the host stalled).  The flag and
// `late` are two words of pinned host memory; cudaHostGetDevicePointer
// maps them for the card.  Polls are 256 ns apart: a poll crosses PCIe.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void gate_kernel(const volatile unsigned* flag, unsigned ticket,
                            unsigned long long timeout_ns,
                            volatile unsigned* late) {
  const unsigned long long t0 = global_ns();
  // tickets wrap: compare their difference as a signed number
  while ((int)(*flag - ticket) < 0) {
    if (global_ns() - t0 > timeout_ns) {
      *late = ticket;
      __threadfence_system();
      return;
    }
    __nanosleep(256);
  }
}

}  // namespace

extern "C" const char* launch_gate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Queue the gate on `stream`: it passes once words[0] - ticket >= 0, or
// writes ticket to words[1] after timeout_ns.  `words` is pinned host
// memory.
extern "C" int launch_gate_hold(void* words, unsigned ticket,
                                unsigned long long timeout_ns, void* stream) {
  void* dwords = nullptr;
  cudaError_t e = cudaHostGetDevicePointer(&dwords, words, 0);
  if (e != cudaSuccess) return (int)e;
  const volatile unsigned* flag = (const volatile unsigned*)dwords;
  gate_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      flag, ticket, timeout_ns, (volatile unsigned*)dwords + 1);
  return (int)cudaGetLastError();
}
