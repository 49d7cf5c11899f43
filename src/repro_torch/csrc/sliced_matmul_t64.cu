// K1 / K4 kernels for 64x64 crossbar tiles (one source per tile size,
// so nvcc builds the three in parallel).  See sliced_matmul.cuh.
#include "sliced_matmul.cuh"

namespace dpe {
cudaError_t launch_tile64(const Args& A, bool staged, const Params& P, cudaStream_t s) {
  return detail::launch_tile<64>(A, staged, P, s);
}
}  // namespace dpe
