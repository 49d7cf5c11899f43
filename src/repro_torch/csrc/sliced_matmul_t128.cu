// K1 / K4 kernels for 128x128 crossbar tiles (one source per tile size,
// so nvcc builds the three in parallel).  See sliced_matmul.cuh.
#include "sliced_matmul.cuh"

namespace dpe {
cudaError_t launch_tile128(const Args& A, bool staged, const Params& P, cudaStream_t s) {
  return detail::launch_tile<128>(A, staged, P, s);
}
}  // namespace dpe
