// K1: fused faithful DPE matmul for Hopper (sm_90a).
//
// Replaces repro/kernels/sliced_matmul.py::fused_sliced_matmul_pallas
// (pallas_call :352; _fused_kernel :246, _prep_input_tile :208, _adc :69).
//
// Grid (nn, nk, row units); a block owns the 128 bit-lines (columns) of
// one n-block for one K-block and runs GROUPS groups of 128 threads:
// thread (g, c) owns column c for the weight slices jw = g, g + GROUPS,
// ...  A row unit is BM rows ("dynamic_row" / "fullscale") or one
// logical 128-row tile ("dynamic", whose ADC range spans the tile; it is
// walked twice: range, then quantise).
//   1. prep: per row, absmax over the 128 inputs of the K-block (group
//      reduction), block scale, round-half-even quantise and clip,
//      two's-complement slices, DAC -> shared memory [k][slice][row].
//   2. per weight slice: each thread streams its weight column once and
//      accumulates all Sx x BM slice-pair dots in registers as one chain
//      of fused multiply-adds over k = 0..127 in order (the plain
//      version replays this chain exactly).
//   3. per pair: ADC range (max over the group's 128 columns for
//      dynamic_row), step = ymax/(radc-1), q = rint(p/step)*step, kept in
//      shared memory.
//   4. recombine in the reference order (input slice major):
//      acc += sig[i][jw]*q, then (acc*sx)*sw -> per-K-block partial.
// A second kernel adds the nk partials in K order starting from 0.0,
// which is the reference's sequential accumulator.
// Bound: decode reads 16 B of programmed slices per weight (bytes); the
// slice groups keep four weight streams in flight per column so a block
// is not one dependent chain of loads.  Prefill chunks are bound by f32
// FMAs.  See kernels/sliced_matmul.py.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;           // bk = bn = 128
constexpr int GROUPS = 4;           // slice groups of TILE threads
constexpr int THREADS = GROUPS * TILE;
constexpr int GWARPS = TILE / 32;   // warps per group
constexpr int NWARP = THREADS / 32;
constexpr int MAX_S = 8;

struct Params {
  int sx_n, sw_n, bits, fp_kind, qmin, qmax, radc, adc_mode;
  int lsb[MAX_S], width[MAX_S], dac_on[MAX_S];
  float levels, radc_m1;
  float dstep[MAX_S];
  float sig[MAX_S][MAX_S];
  float fullscale[MAX_S][MAX_S];
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max over the TILE threads of each group, for each of V per-thread
// values -> out[group * V + i].  Every thread of the block calls it.
template <int V>
__device__ __forceinline__ void group_max(const float (&v)[V], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float m = warp_max(v[i]);
    if (lane == 0) red[warp * V + i] = m;
  }
  __syncthreads();
  const int g = threadIdx.x / TILE, t = threadIdx.x % TILE;
  if (t < V) {
    float m = red[(g * GWARPS) * V + t];
#pragma unroll
    for (int w = 1; w < GWARPS; ++w) m = fmaxf(m, red[(g * GWARPS + w) * V + t]);
    out[g * V + t] = m;
  }
  __syncthreads();
}

// In-kernel prepare_input for rows sub..sub+nr-1 of K-block k0.  Every
// group computes it; group 0 writes the slices and scales.
template <int SX, int BM>
__device__ void prep_rows(const float* __restrict__ x, int ldx, int K, int sub,
                          int nr, int k0, const Params& P, float* xsT,
                          float* sxs, float* red, float* vred) {
  const int c = threadIdx.x % TILE;
  const bool writer = threadIdx.x < TILE;
  const int kk = k0 + c;
  float xv[BM], a[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    xv[r] = (r < nr && kk < K) ? x[(size_t)(sub + r) * ldx + kk] : 0.f;
    a[r] = fabsf(xv[r]);
  }
  group_max<BM>(a, red, vred);
  const int mask = (1 << P.bits) - 1;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const float am = fmaxf(vred[r], 1e-30f);
    const float s = P.fp_kind ? exp2f(floorf(log2f(am)) - (float)(P.bits - 2))
                              : __fdiv_rn(am, P.levels);
    float qf = rintf(__fdiv_rn(xv[r], s));
    qf = fminf(fmaxf(qf, (float)P.qmin), (float)P.qmax);
    const int u = ((int)qf) & mask;  // two's-complement wrap into B bits
#pragma unroll
    for (int i = 0; i < SX; ++i) {
      float v = (float)((u >> P.lsb[i]) & ((1 << P.width[i]) - 1));
      if (P.dac_on[i]) v = __fmul_rn(rintf(__fdiv_rn(v, P.dstep[i])), P.dstep[i]);
      if (writer) xsT[(c * SX + i) * BM + r] = v;
    }
    if (threadIdx.x == 0) sxs[r] = s;
  }
  __syncthreads();
}

template <int SX, int BM>
__global__ void __launch_bounds__(THREADS)
fused_sliced_matmul_kernel(const float* __restrict__ x, int ldx, int M, int K,
                           const float* __restrict__ ws,
                           const float* __restrict__ sw,
                           float* __restrict__ part, int Kp, int Np,
                           int rows_per_unit, Params P) {
  extern __shared__ float smem[];
  const int SW = P.sw_n;
  float* xsT = smem;                        // [TILE][SX][BM]
  float* qbuf = xsT + TILE * SX * BM;       // [SX*SW][BM][TILE]
  float* red = qbuf + SX * SW * BM * TILE;  // [NWARP][SX*BM]
  float* vred = red + NWARP * SX * BM;      // [GROUPS][SX*BM]
  float* tmax = vred + GROUPS * SX * BM;    // [SX*SW]
  float* sxs = tmax + SX * SW;              // [BM]

  const int c = threadIdx.x % TILE, g = threadIdx.x / TILE;
  const int j = blockIdx.x, kb = blockIdx.y;
  const int nn = Np / TILE;
  const int n = j * TILE + c;
  const int k0 = kb * TILE;
  const int row0 = blockIdx.z * rows_per_unit;
  const int row1 = min(row0 + rows_per_unit, M);
  const float swv = sw[kb * nn + j];
  const bool quant = P.radc > 1;
  const bool tile_range = quant && P.adc_mode == 0;
  // slice rounds: round t gives group g the slice jw = t * GROUPS + g
  const int rounds = (SW + GROUPS - 1) / GROUPS;

  if (tile_range) {
    // rows past M are the reference's zero padding rows: their partial
    // sums are exactly 0 and take part in the tile's range
    for (int t = threadIdx.x; t < SX * SW; t += THREADS) tmax[t] = (row0 + TILE > M) ? 0.f : -INFINITY;
  }
  __syncthreads();

  for (int pass = tile_range ? 0 : 1; pass < 2; ++pass) {
    for (int sub = row0; sub < row1; sub += BM) {
      const int nr = min(BM, row1 - sub);
      prep_rows<SX, BM>(x, ldx, K, sub, nr, k0, P, xsT, sxs, red, vred);
      for (int t = 0; t < rounds; ++t) {
        const int jw = t * GROUPS + g;
        const bool live = jw < SW;  // a group past the last slice idles
        float p[SX][BM];
#pragma unroll
        for (int i = 0; i < SX; ++i)
#pragma unroll
          for (int r = 0; r < BM; ++r) p[i][r] = 0.f;
        if (live) {
          const float* wcol = ws + ((size_t)jw * Kp + k0) * Np + n;
#pragma unroll 16
          for (int k = 0; k < TILE; ++k) {
            const float w = __ldg(wcol + (size_t)k * Np);
            const float* xk = xsT + k * SX * BM;
#pragma unroll
            for (int i = 0; i < SX; ++i)
#pragma unroll
              for (int r = 0; r < BM; ++r) p[i][r] = fmaf(xk[i * BM + r], w, p[i][r]);
          }
        }
        if (pass == 0) {
          // range pass: max over this sub-chunk's real rows and columns
          float mloc[SX];
#pragma unroll
          for (int i = 0; i < SX; ++i) {
            mloc[i] = -INFINITY;
#pragma unroll
            for (int r = 0; r < BM; ++r)
              if (r < nr) mloc[i] = fmaxf(mloc[i], p[i][r]);
          }
          group_max<SX>(mloc, red, vred);
          if (live && c < SX) tmax[c * SW + jw] = fmaxf(tmax[c * SW + jw], vred[g * SX + c]);
          __syncthreads();
          continue;
        }
        if (quant && P.adc_mode == 1) {
          float flat[SX * BM];
#pragma unroll
          for (int i = 0; i < SX; ++i)
#pragma unroll
            for (int r = 0; r < BM; ++r) flat[i * BM + r] = p[i][r];
          group_max<SX * BM>(flat, red, vred);
        }
        if (live) {
#pragma unroll
          for (int i = 0; i < SX; ++i) {
#pragma unroll
            for (int r = 0; r < BM; ++r) {
              float q = p[i][r];
              if (quant) {
                const float ymax = P.adc_mode == 1   ? vred[g * SX * BM + i * BM + r]
                                   : P.adc_mode == 0 ? tmax[i * SW + jw]
                                                     : P.fullscale[i][jw];
                const float step = __fdiv_rn(fmaxf(ymax, 1e-30f), P.radc_m1);
                q = __fmul_rn(rintf(__fdiv_rn(q, step)), step);
              }
              qbuf[((i * SW + jw) * BM + r) * TILE + c] = q;
            }
          }
        }
        __syncthreads();  // vred is reused by the next round's reduction
      }
      if (pass == 1 && g == 0) {
        for (int r = 0; r < nr; ++r) {
          float acc = 0.f;
          for (int i = 0; i < SX; ++i)
            for (int jw = 0; jw < SW; ++jw)
              acc = __fadd_rn(acc, __fmul_rn(P.sig[i][jw], qbuf[((i * SW + jw) * BM + r) * TILE + c]));
          part[((size_t)kb * M + sub + r) * Np + n] = __fmul_rn(__fmul_rn(acc, sxs[r]), swv);
        }
      }
      __syncthreads();  // xsT / sxs / qbuf are rewritten by the next sub-chunk
    }
  }
}

__global__ void sum_k_blocks(const float* __restrict__ part, float* __restrict__ out,
                             int nk, size_t mn) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  float s = 0.f;
  for (int kb = 0; kb < nk; ++kb) s = __fadd_rn(s, part[(size_t)kb * mn + idx]);
  out[idx] = s;
}

template <int SX, int BM>
cudaError_t launch(const float* x, int ldx, int M, int K, const float* ws,
                   const float* sw, float* part, int Kp, int Np, const Params& P,
                   cudaStream_t stream) {
  const int rows_per_unit = (P.radc > 1 && P.adc_mode == 0) ? TILE : BM;
  const size_t smem = sizeof(float) * ((size_t)TILE * SX * BM + (size_t)SX * P.sw_n * BM * TILE +
                                       NWARP * SX * BM + GROUPS * SX * BM + SX * P.sw_n + BM);
  auto kern = fused_sliced_matmul_kernel<SX, BM>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(Np / TILE, Kp / TILE, (M + rows_per_unit - 1) / rows_per_unit);
  kern<<<grid, THREADS, smem, stream>>>(x, ldx, M, K, ws, sw, part, Kp, Np, rows_per_unit, P);
  return cudaGetLastError();
}

template <int BM>
cudaError_t dispatch_sx(int sx, const float* x, int ldx, int M, int K, const float* ws,
                        const float* sw, float* part, int Kp, int Np, const Params& P,
                        cudaStream_t s) {
  switch (sx) {
    case 1: return launch<1, BM>(x, ldx, M, K, ws, sw, part, Kp, Np, P, s);
    case 2: return launch<2, BM>(x, ldx, M, K, ws, sw, part, Kp, Np, P, s);
    case 3: return launch<3, BM>(x, ldx, M, K, ws, sw, part, Kp, Np, P, s);
    case 4: return launch<4, BM>(x, ldx, M, K, ws, sw, part, Kp, Np, P, s);
    case 5: return launch<5, BM>(x, ldx, M, K, ws, sw, part, Kp, Np, P, s);
    case 6: return launch<6, BM>(x, ldx, M, K, ws, sw, part, Kp, Np, P, s);
    case 8: return launch<8, BM>(x, ldx, M, K, ws, sw, part, Kp, Np, P, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fused_sliced_matmul_launch(const float* x, int ldx, int M, int K,
                                          const float* ws, const float* sw, float* part,
                                          float* out, int Kp, int Np, const int* ip,
                                          const float* fp, cudaStream_t stream) {
  Params P;
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
  if (P.sw_n < 1 || P.sw_n > MAX_S) return (int)cudaErrorInvalidValue;
  cudaError_t e = (M <= 4)
      ? dispatch_sx<4>(P.sx_n, x, ldx, M, K, ws, sw, part, Kp, Np, P, stream)
      : dispatch_sx<8>(P.sx_n, x, ldx, M, K, ws, sw, part, Kp, Np, P, stream);
  if (e != cudaSuccess) return (int)e;
  const size_t mn = (size_t)M * Np;
  const int threads = 256;
  sum_k_blocks<<<(unsigned)((mn + threads - 1) / threads), threads, 0, stream>>>(part, out, Kp / TILE, mn);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
