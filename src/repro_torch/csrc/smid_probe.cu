// A probe of where blocks run: each block writes the id of the SM it ran
// on (%smid).  A check, not a port: it replaces no TPU kernel and has no
// plain version.  chip_smoke.py launches it inside each GMI's green context
// (core/gmi.py) to hold every GMI's SMs within its slot and disjoint from
// the others'.  Each block spins `spin` clock cycles first, so that a
// launch of a few thousand blocks reaches every SM it may use.  Bound by
// the spin and launch latency, not by bytes or operations.
#include <cuda_runtime.h>

namespace {

__global__ void smid_probe_kernel(int* out, long long spin) {
  if (threadIdx.x != 0) return;
  unsigned int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  const long long t0 = clock64();
  while (clock64() - t0 < spin) {
  }
  out[blockIdx.x] = (int)id;
}

}  // namespace

// out: `blocks` int32, the SM id of each block.  Returns a cudaError_t.
extern "C" int smid_probe_launch(int* out, int blocks, long long spin,
                                 void* stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  smid_probe_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>(out, spin);
  return (int)cudaGetLastError();
}
