// C entries of K1 (fused) and K4 (staged) and the K-block sum.  The
// kernels are in sliced_matmul.cuh; see there for the design.
#include "sliced_matmul.cuh"

namespace {

using dpe::MAX_S;

__global__ void sum_k_blocks(const float* __restrict__ part, float* __restrict__ out,
                             int nk, size_t mn) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  float s = 0.f;
  for (int kb = 0; kb < nk; ++kb) s = __fadd_rn(s, part[(size_t)kb * mn + idx]);
  out[idx] = s;
}

dpe::Params unpack(const int* ip, const float* fp) {
  dpe::Params P;
  P.sx_n = ip[0]; P.sw_n = ip[1]; P.bits = ip[2]; P.fp_kind = ip[3];
  P.qmin = ip[4]; P.qmax = ip[5]; P.radc = ip[6]; P.adc_mode = ip[7];
  for (int i = 0; i < MAX_S; ++i) {
    P.lsb[i] = ip[8 + i];
    P.width[i] = ip[8 + MAX_S + i];
    P.dac_on[i] = ip[8 + 2 * MAX_S + i];
    P.dstep[i] = fp[2 + i];
    for (int j = 0; j < MAX_S; ++j) {
      P.sig[i][j] = fp[2 + MAX_S + i * MAX_S + j];
      P.fullscale[i][j] = fp[2 + MAX_S + MAX_S * MAX_S + i * MAX_S + j];
    }
  }
  P.levels = fp[0];
  P.radc_m1 = fp[1];
  return P;
}

int run(const dpe::Args& A, bool staged, int tile, const dpe::Params& P, float* out,
        cudaStream_t stream) {
  if (P.sw_n < 1 || P.sw_n > MAX_S) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  switch (tile) {
    case 32: e = dpe::launch_tile32(A, staged, P, stream); break;
    case 64: e = dpe::launch_tile64(A, staged, P, stream); break;
    case 128: e = dpe::launch_tile128(A, staged, P, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  const size_t mn = (size_t)A.M * A.Np;
  const int threads = 256;
  sum_k_blocks<<<(unsigned)((mn + threads - 1) / threads), threads, 0, stream>>>(
      A.part, out, A.Kp / tile, mn);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: raw x (M, K), leading dimension ldx.
extern "C" int fused_sliced_matmul_launch(const float* x, int ldx, int M, int K,
                                          const float* ws, const float* sw, float* part,
                                          float* out, int Kp, int Np, int tile, int bm,
                                          const int* ip, const float* fp,
                                          cudaStream_t stream) {
  dpe::Args A{x, ldx, K, nullptr, nullptr, ws, sw, part, M, Kp, Np, bm};
  return run(A, false, tile, unpack(ip, fp), out, stream);
}

// K4: pre-sliced xs (Sx, M, Kp) and scales sx (M, nk); M a multiple of bm.
extern "C" int staged_sliced_matmul_launch(const float* xs, const float* sx, int M,
                                           const float* ws, const float* sw, float* part,
                                           float* out, int Kp, int Np, int tile, int bm,
                                           const int* ip, const float* fp,
                                           cudaStream_t stream) {
  dpe::Args A{nullptr, 0, 0, xs, sx, ws, sw, part, M, Kp, Np, bm};
  return run(A, true, tile, unpack(ip, fp), out, stream);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
