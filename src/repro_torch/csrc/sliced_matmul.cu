// C entries of K1 (fused) and K4 (staged).  The kernel is in
// sliced_matmul.cuh (one source per crossbar tile size); see there for
// the design.  The launch geometry comes from the caller
// (kernels/sliced_matmul.py::plan_k1) and is checked, not chosen, here.
#include "sliced_matmul.cuh"

namespace {

using dpe::MAX_S;

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

dpe::Plan unpack_plan(const int* lp) {
  return dpe::Plan{lp[0], lp[1], lp[2], lp[3], lp[4], lp[5], lp[6],  lp[7],
                   lp[8], lp[9], lp[10], lp[11], lp[12], lp[13], lp[14]};
}

int run(const dpe::Args& A, bool staged, int tile, const int* ip, const float* fp,
        const int* lp, cudaStream_t stream) {
  const dpe::Params P = unpack(ip, fp);
  if (P.sw_n < 1 || P.sw_n > MAX_S) return (int)cudaErrorInvalidValue;
  const dpe::Plan L = unpack_plan(lp);
  switch (tile) {
    case 32: return dpe::launch_tile32(A, staged, L, P, stream);
    case 64: return dpe::launch_tile64(A, staged, L, P, stream);
    case 128: return dpe::launch_tile128(A, staged, L, P, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K1: raw x (E, M, K), leading dimension ldx, on an expert stack of E
// weights ws (E, Sw, Kp, Np), sw (E, nk, nn) -> out (E, M, Np) in one
// launch; each expert runs as K1 on it alone, with its own `tk_stride`
// tickets and `sc_stride` scratch floats (one weight: E = 1).  Every
// slice value is multiplied by `drift` (1: the stored values).
extern "C" int fused_sliced_matmul_launch(const float* x, int ldx, int M, int K, int E,
                                          const float* ws, const float* sw, float* part,
                                          float* out, int* tickets, int tk_stride,
                                          float* scratch, long long sc_stride, int Kp, int Np,
                                          int tile, const int* ip, const float* fp,
                                          const int* lp, float drift, cudaStream_t stream) {
  dpe::Args A{x, ldx, K, nullptr, nullptr, ws, sw, part, out, tickets, scratch, M, Kp, Np, drift,
              E, tk_stride, sc_stride};
  return run(A, false, tile, ip, fp, lp, stream);
}

// K4: pre-sliced xs (Sx, M, Kp) and scales sx (M, nk); M a multiple of bm.
extern "C" int staged_sliced_matmul_launch(const float* xs, const float* sx, int M,
                                           const float* ws, const float* sw, float* part,
                                           float* out, int* tickets, float* scratch, int Kp,
                                           int Np, int tile, const int* ip, const float* fp,
                                           const int* lp, cudaStream_t stream) {
  dpe::Args A{nullptr, 0, 0, xs, sx, ws, sw, part, out, tickets, scratch, M, Kp, Np, 1.f};
  return run(A, true, tile, ip, fp, lp, stream);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
