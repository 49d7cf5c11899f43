// K1 / K4 kernels for 32x32 crossbar tiles (one source per tile size,
// so nvcc builds the three in parallel).  See sliced_matmul.cuh.
#include "sliced_matmul.cuh"

namespace dpe {
int launch_tile32(const Args& A, bool staged, const Plan& L, const Params& P, cudaStream_t s) {
  return detail::launch_tile<32>(A, staged, L, P, s);
}
}  // namespace dpe
