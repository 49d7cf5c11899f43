// K1 and K4: the faithful DPE matmul for Hopper (sm_90a), one device
// code for both.
//
// K1 replaces repro/kernels/sliced_matmul.py::fused_sliced_matmul_pallas
// (pallas_call :352; _fused_kernel :246, _prep_input_tile :208, _adc :69):
// it prepares the raw input in the kernel.  K4 replaces
// sliced_matmul_pallas (pallas_call :185; _kernel :90): it reads inputs
// already sliced and DAC'd (xs, sx).  Everything after the input stage
// is the same code.
//
// The crossbar tile T = bk = bn (32, 64 or 128) is a template parameter.
// Grid (nn, nk, row units); a block owns the T bit-lines (columns) of
// one n-block for one K-block and runs GROUPS groups of T threads:
// thread (g, c) owns column c for the weight slices jw = g, g + GROUPS,
// ...  A row unit is BM rows ("dynamic_row" / "fullscale") or one
// logical bm-row tile ("dynamic", whose ADC range spans the tile; it is
// walked twice: range, then quantise).
//   1. input stage, BM rows at a time, into shared memory [k][slice][row]:
//      K1: per row, absmax over the T inputs of the K-block (group
//      reduction), block scale, round-half-even quantise and clip,
//      two's-complement slices, DAC; K4: copy xs and sx.
//   2. per weight slice: each thread streams its weight column once and
//      accumulates all Sx x BM slice-pair dots in registers as one chain
//      of fused multiply-adds over k = 0..T-1 in order (the plain
//      version replays this chain exactly).
//   3. per pair: ADC range (max over the group's T columns for
//      dynamic_row), step = ymax/(radc-1), q = rint(p/step)*step, kept in
//      shared memory.
//   4. recombine in the reference order (input slice major):
//      acc += sig[i][jw]*q, then (acc*sx)*sw -> per-K-block partial.
// A second kernel adds the nk partials in K order starting from 0.0,
// which is the reference's sequential accumulator.
// BM is 8 rows, or 4 when M <= 4 or when Sx*Sw > 36: the quantised pair
// buffer holds Sx*Sw*BM*T floats, and 8x8 slice pairs at BM = 8 and
// T = 128 would need 300 KB of the 227 KB a block may have.
// Bound: decode reads 16 B of programmed slices per weight (bytes); the
// slice groups keep four weight streams in flight per column so a block
// is not one dependent chain of loads.  Prefill chunks and the staged
// Table 2 product are bound by f32 FMAs.  See kernels/sliced_matmul.py.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dpe {

constexpr int GROUPS = 4;  // slice groups of T threads
constexpr int MAX_S = 8;

struct Params {
  int sx_n, sw_n, bits, fp_kind, qmin, qmax, radc, adc_mode;
  int lsb[MAX_S], width[MAX_S], dac_on[MAX_S];
  float levels, radc_m1;
  float dstep[MAX_S];
  float sig[MAX_S][MAX_S];
  float fullscale[MAX_S][MAX_S];
};

// Operands of one call.  K1 reads x (M, K) with leading dimension ldx;
// K4 reads xs (Sx, M, Kp) and sx (M, nk) (then M is a multiple of bm).
struct Args {
  const float* x;
  int ldx, K;
  const float* xs;
  const float* sx;
  const float* ws;  // (Sw, Kp, Np)
  const float* sw;  // (nk, nn)
  float* part;      // (nk, M, Np)
  int M, Kp, Np;
  int bm;           // rows of the "dynamic" range tile
};

// One tile size's kernels (defined in sliced_matmul_t<T>.cu).
cudaError_t launch_tile32(const Args& A, bool staged, const Params& P, cudaStream_t s);
cudaError_t launch_tile64(const Args& A, bool staged, const Params& P, cudaStream_t s);
cudaError_t launch_tile128(const Args& A, bool staged, const Params& P, cudaStream_t s);

namespace detail {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max over the T threads of each group, for each of V per-thread
// values -> out[group * V + i].  Every thread of the block calls it.
template <int T, int V>
__device__ __forceinline__ void group_max(const float (&v)[V], float* red, float* out) {
  constexpr int GWARPS = T / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float m = warp_max(v[i]);
    if (lane == 0) red[warp * V + i] = m;
  }
  __syncthreads();
  const int g = threadIdx.x / T, t = threadIdx.x % T;
  for (int u = t; u < V; u += T) {
    float m = red[(g * GWARPS) * V + u];
#pragma unroll
    for (int w = 1; w < GWARPS; ++w) m = fmaxf(m, red[(g * GWARPS + w) * V + u]);
    out[g * V + u] = m;
  }
  __syncthreads();
}

// Input stage for rows sub..sub+nr-1 of K-block kb -> xsT [T][SX][BM]
// and sxs [BM].  K1 prepares the raw input (every group computes the
// reductions, group 0 writes); K4 copies the staged slices.
template <int T, int SX, int BM>
__device__ void input_rows(const Args& A, bool staged, int sub, int nr, int kb,
                           const Params& P, float* xsT, float* sxs, float* red,
                           float* vred) {
  const int c = threadIdx.x % T;
  const bool writer = threadIdx.x < T;
  const int kk = kb * T + c;
  if (staged) {
    if (writer) {
      const int nk = A.Kp / T;
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int i = 0; i < SX; ++i)
          xsT[(c * SX + i) * BM + r] =
              r < nr ? A.xs[((size_t)i * A.M + sub + r) * A.Kp + kk] : 0.f;
      if (c < BM) sxs[c] = c < nr ? A.sx[(size_t)(sub + c) * nk + kb] : 0.f;
    }
    __syncthreads();
    return;
  }
  float xv[BM], a[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    xv[r] = (r < nr && kk < A.K) ? A.x[(size_t)(sub + r) * A.ldx + kk] : 0.f;
    a[r] = fabsf(xv[r]);
  }
  group_max<T, BM>(a, red, vred);
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

template <int T, int SX, int BM>
__global__ void __launch_bounds__(GROUPS * T)
sliced_matmul_kernel(Args A, bool staged, int rows_per_unit, Params P) {
  constexpr int THREADS = GROUPS * T;
  constexpr int NWARP = THREADS / 32;
  extern __shared__ float smem[];
  const int SW = P.sw_n;
  float* xsT = smem;                        // [T][SX][BM]
  float* qbuf = xsT + T * SX * BM;          // [SX*SW][BM][T]
  float* red = qbuf + SX * SW * BM * T;     // [NWARP][SX*BM]
  float* vred = red + NWARP * SX * BM;      // [GROUPS][SX*BM]
  float* tmax = vred + GROUPS * SX * BM;    // [SX*SW]
  float* sxs = tmax + SX * SW;              // [BM]

  const int c = threadIdx.x % T, g = threadIdx.x / T;
  const int j = blockIdx.x, kb = blockIdx.y;
  const int M = A.M, Kp = A.Kp, Np = A.Np;
  const int nn = Np / T;
  const int n = j * T + c;
  const int k0 = kb * T;
  const int row0 = blockIdx.z * rows_per_unit;
  const int row1 = min(row0 + rows_per_unit, M);
  const float swv = A.sw[kb * nn + j];
  const bool quant = P.radc > 1;
  const bool tile_range = quant && P.adc_mode == 0;
  // slice rounds: round t gives group g the slice jw = t * GROUPS + g
  const int rounds = (SW + GROUPS - 1) / GROUPS;

  if (tile_range) {
    // rows past M are the reference's zero padding rows: their partial
    // sums are exactly 0 and take part in the tile's range
    for (int t = threadIdx.x; t < SX * SW; t += THREADS)
      tmax[t] = (row0 + rows_per_unit > M) ? 0.f : -INFINITY;
  }
  __syncthreads();

  for (int pass = tile_range ? 0 : 1; pass < 2; ++pass) {
    for (int sub = row0; sub < row1; sub += BM) {
      const int nr = min(BM, row1 - sub);
      input_rows<T, SX, BM>(A, staged, sub, nr, kb, P, xsT, sxs, red, vred);
      for (int t = 0; t < rounds; ++t) {
        const int jw = t * GROUPS + g;
        const bool live = jw < SW;  // a group past the last slice idles
        float p[SX][BM];
#pragma unroll
        for (int i = 0; i < SX; ++i)
#pragma unroll
          for (int r = 0; r < BM; ++r) p[i][r] = 0.f;
        if (live) {
          const float* wcol = A.ws + ((size_t)jw * Kp + k0) * Np + n;
#pragma unroll 16
          for (int k = 0; k < T; ++k) {
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
          group_max<T, SX>(mloc, red, vred);
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
          group_max<T, SX * BM>(flat, red, vred);
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
              qbuf[((i * SW + jw) * BM + r) * T + c] = q;
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
              acc = __fadd_rn(acc, __fmul_rn(P.sig[i][jw], qbuf[((i * SW + jw) * BM + r) * T + c]));
          A.part[((size_t)kb * M + sub + r) * Np + n] = __fmul_rn(__fmul_rn(acc, sxs[r]), swv);
        }
      }
      __syncthreads();  // xsT / sxs / qbuf are rewritten by the next sub-chunk
    }
  }
}

template <int T, int SX, int BM>
cudaError_t launch(const Args& A, bool staged, const Params& P, cudaStream_t stream) {
  constexpr int THREADS = GROUPS * T;
  const int rows_per_unit = (P.radc > 1 && P.adc_mode == 0) ? A.bm : BM;
  const size_t smem = sizeof(float) * ((size_t)T * SX * BM + (size_t)SX * P.sw_n * BM * T +
                                       (THREADS / 32) * SX * BM + GROUPS * SX * BM +
                                       SX * P.sw_n + BM);
  auto kern = sliced_matmul_kernel<T, SX, BM>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(A.Np / T, A.Kp / T, (A.M + rows_per_unit - 1) / rows_per_unit);
  kern<<<grid, THREADS, smem, stream>>>(A, staged, rows_per_unit, P);
  return cudaGetLastError();
}

template <int T, int BM>
cudaError_t dispatch_sx(const Args& A, bool staged, const Params& P, cudaStream_t s) {
  switch (P.sx_n) {
    case 3: return launch<T, 3, BM>(A, staged, P, s);
    case 4: return launch<T, 4, BM>(A, staged, P, s);
    case 5: return launch<T, 5, BM>(A, staged, P, s);
    case 6: return launch<T, 6, BM>(A, staged, P, s);
    case 8: return launch<T, 8, BM>(A, staged, P, s);
    default: return cudaErrorInvalidValue;
  }
}

// BM = 8 rows per sub-chunk unless the call has at most 4 rows or the
// slice pairs are too many for the pair buffer at 8 rows.
template <int T>
cudaError_t launch_tile(const Args& A, bool staged, const Params& P, cudaStream_t s) {
  const bool wide = A.M > 4 && P.sx_n * P.sw_n <= 36;
  return wide ? dispatch_sx<T, 8>(A, staged, P, s) : dispatch_sx<T, 4>(A, staged, P, s);
}

}  // namespace detail
}  // namespace dpe
