// An empty kernel launched the way K1 and K2 are (one block on the given
// stream, through the C interface), so that a measurement can tell a
// kernel's own time from the cost of launching anything at all.

#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int lrr_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
