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
// What binds the design: the kernel equals its plain version
// (kernels/ref.py) bit for bit, because the ADC turns summation-order
// ulps into whole codes.  Every slice-pair partial sum is one fmaf chain
// over the crossbar rows k = 0..T-1 from 0.0; the ADC is
// rint(p / step) * step with an IEEE division; the recombination runs
// input slice major with __fadd_rn / __fmul_rn; the K-blocks are added
// in K order from 0.0.  Noisy slices are not integers, so the chains
// stay on the CUDA cores (f32 FMAs).  Everything else is free.
//
// Bound on an H100: a decode call (M <= 4) reads 16 B of int8 slices per
// weight and is bytes-bound; a prefill chunk (M = 32) and the staged
// Table 2 product do Sx*Sw*2 f32 operations per weight and row and are
// bound by the CUDA cores' f32 rate.  One launch per call.  The design:
//
//   * Work unit: a crossbar tile (n-block j, K-block kb) is split over
//     Sw x S_c CTAs: CTA (slab, jw) owns weight slice jw of column slab
//     `slab` (C = T / S_c bit-lines).  S_c = 2 where Sw*2 <= 8 and the
//     call has more than 4 rows on 128-wide tiles or would have fewer
//     than 264 CTAs (two per SM) without; the planner in
//     kernels/sliced_matmul.py chooses the geometry and the C entry only
//     checks it.
//   * Weight stream: one thread issues the slab as four 2-D TMA boxes of
//     T/4 rows, each completing on its own mbarrier, so the chains start
//     on the first box while the rest is in flight; no thread issues a
//     per-weight load instruction.
//   * Chains: thread (column warp, row warp, lane) owns CW adjacent
//     columns x RW rows (2 at decode, else 4) x Sx input slices and reads
//     per k one CW-wide weight vector and RW*Sx prepared inputs as 16-byte
//     broadcasts, so FMAs dominate the instruction mix.  A CTA holds a
//     row unit of MR rows (the whole call up to 32 rows; a whole
//     `dynamic` tile where it fits) and loops over row units with its
//     weights resident: every weight is read from device memory once.
//   * Input stage: each CTA prepares its rows' inputs for its K-block
//     once per unit (K1: absmax, scale, round, two's-complement slices,
//     DAC; K4: copy xs, sx) into [k][row][slice] with a padded row
//     stride, while the weights are in flight.
//   * Decode (M <= 4, `gx`): the CTAs of a tile write their pair sums to
//     device memory (6 % more bytes at M = 2) and exit; the last to
//     arrive (an atomic ticket) stages the tile's pairs in its shared
//     memory, takes the ranges, quantises and recombines them, so a CTA
//     that streams weights never waits on a barrier of another CTA.
//   * Otherwise the Sw x S_c CTAs of a tile form a THREAD BLOCK CLUSTER:
//     `dynamic_row` maxima (over the tile's T bit-lines) and one-pass
//     `dynamic` maxima (over the unit's rows too) are exchanged between
//     the slab CTAs through distributed shared memory (a max is
//     order-free, so exact); then CTA jw of a slab recombines its share
//     of the outputs, reading its peers' quantised pairs through DSMEM.
//     A `dynamic` tile larger than a unit takes two launches: a range
//     pass writes each CTA's maxima to device memory, a quantise pass
//     reads the max over the tile's units.  Rows past M count as 0
//     toward a padded tile's range.
//   * K-block sum: with nk > 1 K-blocks the recombined partials go to
//     device memory; the last of the nk CTAs of an output block (an
//     atomic ticket) adds them in K order from 0.0 and resets the ticket.
//   * Expert stack (the reference's vmap of the fused kernel over an MoE
//     layer's experts, models/moe.py:112-122): one launch for E experts,
//     grid y over (expert, K-block); a CTA offsets x, sw, out and its
//     partials, tickets and scratch by its expert and then runs as a call
//     on that expert alone (a `dynamic` range tile never spans two
//     experts), so each expert's output is bit-equal to K1 on it alone.
//     One tensor map covers the stack's E*Sw*Kp rows.
//
// What holds it back (PERF.md; chip_smoke.py and tools/k1_table.py
// measure it): every CTA is a chain of latencies (the TMA boxes arrive
// microseconds after issue under load, then the chains, then the epilogue
// in the tile's last CTA), and shared memory caps the CTAs in flight per
// SM.  At decode the MLP and vocab-head projections reach a third to two
// thirds of their bytes bound and the single-wave attention projections
// are all latency; in a prefill chunk the cluster barriers and each CTA's
// epilogue keep the chains near a quarter of the f32 rate.
#pragma once
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace dpe {

namespace cg = cooperative_groups;

constexpr int MAX_S = 8;
constexpr int MAX_THREADS = 512;
constexpr int GX_THREADS = 128;  // threads of a decode-exchange CTA

struct Params {
  int sx_n, sw_n, bits, fp_kind, qmin, qmax, radc, adc_mode;
  int lsb[MAX_S], width[MAX_S], dac_on[MAX_S];
  float levels, radc_m1;
  float dstep[MAX_S];
  float sig[MAX_S][MAX_S];
  float fullscale[MAX_S][MAX_S];
};

// Operands of one call.  K1 reads x (M, K) with leading dimension ldx;
// K4 reads xs (Sx, M, Kp) and sx (M, nk).
struct Args {
  const float* x;
  int ldx, K;
  const float* xs;
  const float* sx;
  const float* ws;  // (Sw, Kp, Np)
  const float* sw;  // (nk, nn)
  float* part;      // (nk, M, Np) K-block partials, nk > 1
  float* out;       // (M, Np)
  int* tickets;     // (Z, nn, csize), zero between calls
  float* scratch;   // range-pass maxima (units, nk, nn, csize, Sx), or the
                    // decode pairs (nk, nn, Sx, MR, Sw, T)
  int M, Kp, Np;
  float drift;      // conductance decay: each slice value times it as loaded
  // An expert stack (E > 1): x (E, M, K), ws (E, Sw, Kp, Np), sw (E, nk,
  // nn), out (E, M, Np); grid y runs over (expert, K-block), and each
  // expert has its own partials, `tk_stride` tickets and `sc_stride`
  // scratch floats.
  int experts = 1;
  int tk_stride = 0;
  long long sc_stride = 0;
};

// Launch geometry, computed by kernels/sliced_matmul.py::plan_k1.
struct Plan {
  int sc;       // column slabs a tile: C = T / sc bit-lines a CTA
  int cw;       // adjacent columns a thread
  int rw;       // rows a thread
  int nwr;      // row warps: MR = rw * nwr rows a unit
  int mr;       // rows a unit
  int xs;       // row stride (floats) of the prepared-input buffer
  int units;    // row units of the call
  int upt;      // units a range tile
  int bmr;      // rows a range tile (`dynamic`: bm; else MR)
  int upc;      // units a CTA
  int z;        // grid z (groups of units)
  int two_pass; // 1: range pass, then quantise pass
  int smem;     // dynamic shared memory bytes
  int threads;  // threads a CTA
  int gx;       // 1: decode exchange through device memory (no cluster)
};

int launch_tile32(const Args& A, bool staged, const Plan& L, const Params& P, cudaStream_t s);
int launch_tile64(const Args& A, bool staged, const Plan& L, const Params& P, cudaStream_t s);
int launch_tile128(const Args& A, bool staged, const Plan& L, const Params& P, cudaStream_t s);

namespace detail {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// A slab quarter's transaction barrier: one arrival (the thread that
// issues the copy) plus the copy's bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// TMA: the (rows x C) box at (column x0, row y0) of the weight tensor map
// into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(float* dst, const CUtensorMap* map, int x0, int y0,
                                            uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(y0),
        "r"(smem_u32(bar))
      : "memory");
}

// cluster.sync() in two halves, so a CTA's own work can run in between
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Every thread's writes are out; one thread takes a ticket of `count`
// arrivals.  True in every thread of the last arrival's CTA, which
// resets the ticket for the next call and sees every arrival's writes.
__device__ __forceinline__ bool last_arrival(int* ticket, int count, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int last = atomicAdd(ticket, 1) == count - 1;
    if (last) *ticket = 0;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// The K-block sum of one output: nk partials `stride` apart, added in K
// order from 0.0 (loads issued eight at a time).
__device__ __forceinline__ float ksum(const float* part, size_t stride, int nk) {
  float s = 0.f;
  for (int k0 = 0; k0 < nk; k0 += 8) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = k0 + q < nk ? __ldcg(part + (size_t)(k0 + q) * stride) : 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (k0 + q < nk) s = __fadd_rn(s, v[q]);
  }
  return s;
}

// A contiguous share [lo, hi) of n items for part p of np.
struct Share {
  int lo, hi;
};
__device__ __forceinline__ Share share(int n, int np, int p) {
  const int each = (n + np - 1) / np;
  return Share{min(n, p * each), min(n, (p + 1) * each)};
}

// Rows [lo, lo + n) of row unit u (n may be 0 past M), and its range tile.
struct Unit {
  int lo, n, tile;
};
__device__ __forceinline__ Unit unit_rows(const Plan& L, int M, int u) {
  const int t = u / L.upt, s = u % L.upt;
  const int lo = t * L.bmr + s * L.mr;
  const int hi = min(min(lo + L.mr, (t + 1) * L.bmr), M);
  return Unit{lo, max(0, hi - lo), t};
}

// Input stage of one unit: X[k * xs + r * SX + i] for the unit's MR rows
// (zero past its real rows) and sxs[r].  K1 prepares the raw input, K4
// copies the staged slices.  A warp takes RB consecutive rows at a time
// (their loads issued together); its lanes the k.
template <int T, int SX>
__device__ void input_stage(const Args& A, bool staged, const Plan& L, const Params& P, int kb,
                            const Unit& U, float* X, float* sxs) {
  constexpr int KL = T / 32;
  constexpr int RB = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int nk = A.Kp / T;
  if (staged) {
    constexpr int RBS = KL * SX >= 16 ? 1 : (KL * SX >= 8 ? 2 : 4);
    for (int rb = warp * RBS; rb < L.mr; rb += nwarps * RBS) {
      float v[RBS][KL][SX];
#pragma unroll
      for (int b = 0; b < RBS; ++b) {
        const bool live = rb + b < U.n;
        const size_t row = (size_t)U.lo + rb + b;
#pragma unroll
        for (int t = 0; t < KL; ++t)
#pragma unroll
          for (int i = 0; i < SX; ++i)
            v[b][t][i] = live ? A.xs[((size_t)i * A.M + row) * A.Kp + kb * T + t * 32 + lane] : 0.f;
      }
#pragma unroll
      for (int b = 0; b < RBS; ++b) {
        const int r = rb + b;
        if (r >= L.mr) break;
#pragma unroll
        for (int t = 0; t < KL; ++t)
#pragma unroll
          for (int i = 0; i < SX; ++i) X[(t * 32 + lane) * L.xs + r * SX + i] = v[b][t][i];
        if (lane == 0) sxs[r] = r < U.n ? A.sx[(size_t)(U.lo + r) * nk + kb] : 0.f;
      }
    }
    return;
  }
  const int mask = (1 << P.bits) - 1;
  for (int rb = warp * RB; rb < L.mr; rb += nwarps * RB) {
    float xv[RB][KL];
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const bool live = rb + b < U.n;
      const size_t row = (size_t)U.lo + rb + b;
#pragma unroll
      for (int t = 0; t < KL; ++t) {
        const int kk = kb * T + t * 32 + lane;
        xv[b][t] = live && kk < A.K ? A.x[row * A.ldx + kk] : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int r = rb + b;
      if (r >= L.mr) break;
      float am = 0.f;
#pragma unroll
      for (int t = 0; t < KL; ++t) am = fmaxf(am, fabsf(xv[b][t]));
      am = fmaxf(warp_max(am), 1e-30f);
      const float s = P.fp_kind ? exp2f(floorf(log2f(am)) - (float)(P.bits - 2))
                                : __fdiv_rn(am, P.levels);
#pragma unroll
      for (int t = 0; t < KL; ++t) {
        float qf = rintf(__fdiv_rn(xv[b][t], s));
        qf = fminf(fmaxf(qf, (float)P.qmin), (float)P.qmax);
        const int u = ((int)qf) & mask;  // two's-complement wrap into B bits
        float* dst = X + (t * 32 + lane) * L.xs + r * SX;
#pragma unroll
        for (int i = 0; i < SX; ++i) {
          float e = (float)((u >> P.lsb[i]) & ((1 << P.width[i]) - 1));
          if (P.dac_on[i]) e = __fmul_rn(rintf(__fdiv_rn(e, P.dstep[i])), P.dstep[i]);
          dst[i] = e;
        }
      }
      // rows past the unit's real rows are zero (their slices are 0)
      if (lane == 0) sxs[r] = r < U.n ? s : 0.f;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_vec(float (&d)[N], const float* s) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const float4 q = *reinterpret_cast<const float4*>(s + e);
      d[e] = q.x; d[e + 1] = q.y; d[e + 2] = q.z; d[e + 3] = q.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 2) {
      const float2 q = *reinterpret_cast<const float2*>(s + e);
      d[e] = q.x; d[e + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) d[e] = s[e];
  }
}

template <int T, int SX, int CW, int RW>
__global__ void __launch_bounds__(MAX_THREADS)
sliced_matmul_kernel(const __grid_constant__ CUtensorMap wmap, Args A, bool staged, Plan L, Params P,
                     int phase) {
  // phase: 0 range pass, 1 quantise pass after it, 2 the one pass
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int SW = P.sw_n;
  const int csize = SW * L.sc;
  const int C = T / L.sc;
  const int nwc = C / (32 * CW);
  const int MR = L.mr;
  float* W = smem;                       // [T][C] weight slab
  float* X = W + T * C;                  // [T][xs] prepared inputs; then Q [SX][MR][C]
  float* pmax = X + T * L.xs;            // [nwc][SX][MR] warp maxima
  float* ymax = pmax + nwc * SX * MR;    // [SX][MR] ranges
  float* sxs = ymax + SX * MR;           // [MR] input scales, then a flag and the barriers
  int* flag = reinterpret_cast<int*>(sxs + MR);
  // four slab barriers, 8-byte aligned after the flag
  uint64_t* wbar = reinterpret_cast<uint64_t*>((reinterpret_cast<uintptr_t>(flag + 1) + 7) & ~uintptr_t(7));
  float* Q = X;
  // k steps unrolled: the decode tile hoists four steps' loads, the
  // 64-accumulator tile two (registers)
  constexpr int UNROLL = RW * SX * CW > 32 ? 2 : 4;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cwp = warp % nwc, rwp = warp / nwc;  // column warp, row warp
  // the decode exchange may have more warps than chains: the others help
  // with the input stage and the tile's epilogue
  const bool chain_warp = warp < nwc * L.nwr;
  const int rank = blockIdx.x % csize;  // the cluster rank where clusters are used
  const int jw = rank % SW, slab = rank / SW;
  const int M = A.M, Kp = A.Kp, Np = A.Np;
  const int nn = Np / T, nk = Kp / T;
  const int j = blockIdx.x / csize, kb = blockIdx.y % nk, z = blockIdx.z;
  const int e = blockIdx.y / nk;  // the expert of a stack (0 for one weight)
  if (e) {  // this expert's operands and workspace: it runs as a call of its own
    A.x += (size_t)e * M * A.ldx;
    A.sw += (size_t)e * nk * nn;
    A.out += (size_t)e * M * Np;
    if (A.part) A.part += (size_t)e * nk * M * Np;
    A.tickets += (size_t)e * A.tk_stride;
    if (A.scratch) A.scratch += (size_t)e * A.sc_stride;
  }
  const int col0 = (cwp * 32 + lane) * CW;  // first of this thread's columns in the slab
  const int r0 = rwp * RW;                  // first of this thread's rows in the unit
  const bool quant = P.radc > 1;
  const int mode = quant ? P.adc_mode : 2;  // 0 dynamic, 1 dynamic_row, 2 static range
  const bool exchange = phase != 1 && mode != 2;
  const int u0 = z * L.upc, u1 = min(u0 + L.upc, L.units);
  if (unit_rows(L, M, u0).n == 0) return;  // an empty tail unit (whole cluster alike)

  // the weight slab by TMA, in four boxes of T/4 rows, each on its own
  // barrier so the chains start on the first while the rest is in flight
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < 4; ++g) mbar_init(&wbar[g]);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      tma_load_2d(W + g * (T / 4) * C, &wmap, j * T + slab * C,
                  (e * SW + jw) * Kp + kb * T + g * (T / 4),
                  &wbar[g], (uint32_t)(sizeof(float) * (T / 4) * C));
  }
  const float swv = A.sw[kb * nn + j];

  bool first = true, pending = false;
  for (int u = u0; u < u1; ++u) {
    const Unit U = unit_rows(L, M, u);
    if (U.n == 0) break;
    if (pending) cluster_wait();  // the peers are done with the last unit's Q
    pending = false;
    input_stage<T, SX>(A, staged, L, P, kb, U, X, sxs);
    if (phase == 1 && tid < SX) {
      // the tile's range from the range pass: every unit of the tile,
      // every slab; rows past M are zero rows of a padded tile
      const int t_lo = U.tile * L.bmr;
      const int t_rows = min(t_lo + L.bmr, M) - t_lo;
      const int t_units = (t_rows + MR - 1) / MR;
      float m = (U.tile + 1) * L.bmr > M ? 0.f : -INFINITY;
      for (int s = 0; s < t_units; ++s)
        for (int sl = 0; sl < L.sc; ++sl)
          m = fmaxf(m, A.scratch[((((size_t)(U.tile * L.upt + s) * nk + kb) * nn + j) * csize +
                               sl * SW + jw) * SX + tid]);
      ymax[tid * MR] = m;
    }
    __syncthreads();

    // chains: p[i][r][c] = sum_k x[k][r][i] * w[k][c], one fmaf chain each
    float p[SX][RW][CW];
#pragma unroll
    for (int i = 0; i < SX; ++i)
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int c = 0; c < CW; ++c) p[i][r][c] = 0.f;
    // a drifted call (drift != 1) rounds each slice value times the
    // factor once as it is loaded, outside the chain (no contraction);
    // drift == 1 runs the chains on the stored values
    auto chains = [&](auto drifted) {
#pragma unroll 1
      for (int g = 0; g < (chain_warp ? 4 : 0); ++g) {
        if (first) mbar_wait(&wbar[g], 0);
        const float* wk = W + g * (T / 4) * C + col0;
        const float* xk = X + g * (T / 4) * L.xs + r0 * SX;
#pragma unroll UNROLL
        for (int k = 0; k < T / 4; ++k) {
          float w[CW];
          load_vec<CW>(w, wk + k * C);
          if constexpr (decltype(drifted)::value) {
#pragma unroll
            for (int c = 0; c < CW; ++c) w[c] = __fmul_rn(w[c], A.drift);
          }
          float xv[RW * SX];
          load_vec<RW * SX>(xv, xk + k * L.xs);
#pragma unroll
          for (int r = 0; r < RW; ++r)
#pragma unroll
            for (int i = 0; i < SX; ++i)
#pragma unroll
              for (int c = 0; c < CW; ++c) p[i][r][c] = fmaf(xv[r * SX + i], w[c], p[i][r][c]);
        }
      }
    };
    if (A.drift == 1.f) chains(std::false_type{});
    else chains(std::true_type{});
    first = false;

    if (L.gx) {
      // decode: the pairs go to device memory and the tile's last CTA
      // ranges, quantises and recombines them all (no cluster)
      const int tix = (z * nk + kb) * nn + j;
      const int TP = SX * MR * SW * T;  // pair values of a tile, [SX][MR][SW][T]
      float* G = A.scratch + (size_t)tix * TP;
      if (chain_warp) {
#pragma unroll
        for (int i = 0; i < SX; ++i)
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            float* dst = G + ((size_t)(i * MR + r0 + r) * SW + jw) * T + slab * C + col0;
            if constexpr (CW == 2) {
              *reinterpret_cast<float2*>(dst) = make_float2(p[i][r][0], p[i][r][1]);
            } else {
#pragma unroll
              for (int c = 0; c < CW; ++c) dst[c] = p[i][r][c];
            }
          }
      }
      if (!last_arrival(A.tickets + tix, csize, flag)) return;
      float* S = W;  // the slab is consumed: the tile's pairs
      for (int e0 = tid * 4; e0 < TP; e0 += blockDim.x * 16) {
        float4 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = e0 + q * blockDim.x * 4;
          if (e < TP) v[q] = __ldcg(reinterpret_cast<const float4*>(G + e));
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = e0 + q * blockDim.x * 4;
          if (e < TP) *reinterpret_cast<float4*>(S + e) = v[q];
        }
      }
      float* yg = X;                   // ranges [SX][MR][SW]
      float* st = X + SX * MR * SW;    // ADC steps [SX][MR][SW]
      __syncthreads();
      if (quant) {
        if (mode != 2) {
          for (int q = warp; q < SX * MR * SW; q += blockDim.x >> 5) {
            float m = -INFINITY;
            for (int c = lane; c < T; c += 32) m = fmaxf(m, S[q * T + c]);
            m = warp_max(m);
            if (lane == 0) yg[q] = m;
          }
          __syncthreads();
          if (mode == 0 && tid < SX * SW) {
            // `dynamic`: over the unit's rows too (one unit holds the
            // whole range tile); a padded tile's zero rows count as 0
            const int i = tid / SW, w = tid % SW;
            float m = (U.tile + 1) * L.bmr > M ? 0.f : -INFINITY;
            for (int r = 0; r < U.n; ++r) m = fmaxf(m, yg[(i * MR + r) * SW + w]);
            yg[i * MR * SW + w] = m;
          }
          __syncthreads();
        }
        for (int q = tid; q < SX * MR * SW; q += blockDim.x) {
          const int w = q % SW, i = q / (MR * SW);
          const float ym = mode == 1 ? yg[q] : mode == 0 ? yg[i * MR * SW + w] : P.fullscale[i][w];
          st[q] = __fdiv_rn(fmaxf(ym, 1e-30f), P.radc_m1);
        }
        __syncthreads();
        for (int e = tid; e < TP; e += blockDim.x) {
          const float step = st[e / T];
          S[e] = __fmul_rn(rintf(__fdiv_rn(S[e], step)), step);
        }
        __syncthreads();
      }
      for (int e = tid; e < U.n * T; e += blockDim.x) {
        const int r = e / T, c = e % T;
        float acc = 0.f;
        for (int i = 0; i < SX; ++i)
          for (int w = 0; w < SW; ++w)
            acc = __fadd_rn(acc, __fmul_rn(P.sig[i][w], S[((i * MR + r) * SW + w) * T + c]));
        const float val = __fmul_rn(__fmul_rn(acc, sxs[r]), swv);
        const size_t o = (size_t)(U.lo + r) * Np + (size_t)j * T + c;
        if (nk == 1) A.out[o] = val; else A.part[(size_t)kb * M * Np + o] = val;
      }
      if (nk == 1) return;
      if (!last_arrival(A.tickets + (size_t)gridDim.z * nk * nn + (size_t)z * nn + j, nk, flag))
        return;
      for (int e = tid; e < U.n * T; e += blockDim.x) {
        const size_t o = (size_t)(U.lo + e / T) * Np + (size_t)j * T + e % T;
        A.out[o] = ksum(A.part + o, (size_t)M * Np, nk);
      }
      return;
    }

    if (exchange || phase == 0) {
      // max over this warp's columns for each (slice, row)
#pragma unroll
      for (int i = 0; i < SX; ++i)
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          float m = p[i][r][0];
#pragma unroll
          for (int c = 1; c < CW; ++c) m = fmaxf(m, p[i][r][c]);
          m = warp_max(m);
          if (lane == 0) pmax[(cwp * SX + i) * MR + r0 + r] = m;
        }
    }
    if (phase == 0) {
      // range pass: this CTA's max over the unit's rows and its columns
      __syncthreads();
      if (tid < SX) {
        float m = -INFINITY;
        for (int cw = 0; cw < nwc; ++cw)
          for (int r = 0; r < U.n; ++r) m = fmaxf(m, pmax[(cw * SX + tid) * MR + r]);
        A.scratch[((((size_t)u * nk + kb) * nn + j) * csize + rank) * SX + tid] = m;
      }
      __syncthreads();  // pmax and X are rewritten by the next unit
      continue;
    }
    if (exchange) {
      // the ranges: max over the tile's bit-lines (every slab's CTA)
      if (L.sc > 1) cluster.sync(); else __syncthreads();
      for (int e = tid; e < SX * MR; e += blockDim.x) {
        const int i = e / MR, r = e % MR;
        float m = -INFINITY;
        for (int sl = 0; sl < L.sc; ++sl) {
          const float* src = sl == slab ? pmax : cluster.map_shared_rank(pmax, sl * SW + jw);
          for (int cw = 0; cw < nwc; ++cw) m = fmaxf(m, src[(cw * SX + i) * MR + r]);
        }
        ymax[e] = m;
      }
      __syncthreads();
      if (mode == 0) {
        // one-pass `dynamic`: over the unit's real rows too (the unit is
        // the whole range tile); a padded tile's zero rows count as 0
        if (tid < SX) {
          float m = (U.tile + 1) * L.bmr > M ? 0.f : -INFINITY;
          for (int r = 0; r < U.n; ++r) m = fmaxf(m, ymax[tid * MR + r]);
          ymax[tid * MR] = m;
        }
        __syncthreads();
      }
    } else {
      __syncthreads();  // every warp is done reading X before Q overwrites it
    }

    // ADC: q = rint(p / step) * step, into Q [SX][MR][C]
#pragma unroll
    for (int i = 0; i < SX; ++i)
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        float step = 0.f;
        if (quant) {
          const float ym = mode == 1 ? ymax[i * MR + r0 + r]
                           : mode == 0 ? ymax[i * MR]
                                       : P.fullscale[i][jw];
          step = __fdiv_rn(fmaxf(ym, 1e-30f), P.radc_m1);
        }
        float q[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c)
          q[c] = quant ? __fmul_rn(rintf(__fdiv_rn(p[i][r][c], step)), step) : p[i][r][c];
        float* dst = Q + (i * MR + r0 + r) * C + col0;
        if constexpr (CW == 2) {
          *reinterpret_cast<float2*>(dst) = make_float2(q[0], q[1]);
        } else {
#pragma unroll
          for (int c = 0; c < CW; ++c) dst[c] = q[c];
        }
      }
    if (csize > 1) cluster.sync(); else __syncthreads();

    // recombination in reference order (input slice major, then weight
    // slice); CTA jw of the slab takes its share of the unit's outputs
    {
      const float* qs[MAX_S];
#pragma unroll
      for (int w = 0; w < MAX_S; ++w)
        qs[w] = w >= SW || w == jw ? Q : cluster.map_shared_rank(Q, slab * SW + w);
      const Share sh = share(U.n * C, SW, jw);
      for (int e = sh.lo + tid; e < sh.hi; e += blockDim.x) {
        const int r = e / C, c = e % C;
        float v[SX][MAX_S];
#pragma unroll
        for (int i = 0; i < SX; ++i)
#pragma unroll
          for (int w = 0; w < MAX_S; ++w)
            v[i][w] = w < SW ? qs[w][(i * MR + r) * C + c] : 0.f;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < SX; ++i)
#pragma unroll
          for (int w = 0; w < MAX_S; ++w)
            if (w < SW) acc = __fadd_rn(acc, __fmul_rn(P.sig[i][w], v[i][w]));
        const float val = __fmul_rn(__fmul_rn(acc, sxs[r]), swv);
        const size_t o = (size_t)(U.lo + r) * Np + (size_t)j * T + slab * C + c;
        if (nk == 1) A.out[o] = val; else A.part[(size_t)kb * M * Np + o] = val;
      }
    }
    // peers read this CTA's Q until they arrive; it is rewritten (next
    // unit) or freed (exit) only after the wait
    if (csize > 1) cluster_arrive(); else __syncthreads();
    pending = csize > 1;
  }
  if (phase == 0 || nk == 1) {
    if (pending) cluster_wait();
    return;
  }

  // K-block sum: the last of the nk CTAs adds the partials in K order
  if (last_arrival(A.tickets + ((size_t)z * nn + j) * csize + rank, nk, flag)) {
    for (int u = u0; u < u1; ++u) {
      const Unit U = unit_rows(L, M, u);
      const Share sh = share(U.n * C, SW, jw);
      for (int e = sh.lo + tid; e < sh.hi; e += blockDim.x) {
        const size_t o = (size_t)(U.lo + e / C) * Np + (size_t)j * T + slab * C + e % C;
        A.out[o] = ksum(A.part + o, (size_t)M * Np, nk);
      }
    }
  }
  if (pending) cluster_wait();
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no libcuda
// at link time).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The weight slices (Sw, Kp, Np) -- of an expert stack (E, Sw, Kp, Np) --
// as one 2-D tensor (E*Sw*Kp rows of Np) in boxes of (T/4 rows x C
// columns): a host-side encoding, no device work.  Programmed weights
// stay put, so the encodings are kept in a small cache keyed on the
// tensor and box (the encoding costs host time per call).  A stack has
// one map: per-expert views lie a multiple of 64 KiB apart and would all
// fall in one slot.
inline int weight_map(CUtensorMap* map, const Args& A, int T, int C, int sw_n) {
  struct Key {
    const float* ws;
    int np, rows, c, t;
  };
  constexpr int SLOTS = 256;
  static Key keys[SLOTS];
  static CUtensorMap maps[SLOTS];
  static std::mutex lock;
  const Key key{A.ws, A.Np, A.experts * sw_n * A.Kp, C, T};
  const int slot = (int)((reinterpret_cast<uintptr_t>(A.ws) >> 8) % SLOTS);
  {
    std::lock_guard<std::mutex> g(lock);
    const Key& k = keys[slot];
    if (k.ws == key.ws && k.np == key.np && k.rows == key.rows && k.c == key.c && k.t == key.t) {
      *map = maps[slot];
      return 0;
    }
  }
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)A.Np, (cuuint64_t)key.rows};
  const cuuint64_t strides[1] = {(cuuint64_t)A.Np * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)C, (cuuint32_t)(T / 4)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(A.ws), dims,
                            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidPitchValue;
  std::lock_guard<std::mutex> g(lock);
  keys[slot] = key;
  maps[slot] = *map;
  return 0;
}

template <int T, int SX, int CW, int RW>
int launch(const Args& A, bool staged, const Plan& L, const Params& P, cudaStream_t stream) {
  auto kern = sliced_matmul_kernel<T, SX, CW, RW>;
  // the shared-memory limit persists per device: raise it once (the call
  // costs host time on every launch otherwise)
  static bool raised[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !raised[dev]) {
    int most = 0;
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) raised[dev] = true;
  }
  CUtensorMap wmap;
  const int rc = weight_map(&wmap, A, T, T / L.sc, P.sw_n);
  if (rc) return rc;
  const int csize = P.sw_n * L.sc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(A.Np / T * csize), (unsigned)(A.Kp / T * A.experts),
                     (unsigned)L.z);
  cfg.blockDim = dim3((unsigned)L.threads);
  cfg.dynamicSmemBytes = (size_t)L.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.gx ? 1u : (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (L.gx) {  // decode: no cluster
    kern<<<cfg.gridDim, cfg.blockDim, cfg.dynamicSmemBytes, stream>>>(wmap, A, staged, L, P, 2);
    return (int)cudaGetLastError();
  }
  for (int phase = L.two_pass ? 0 : 2; phase < 3; phase = phase == 0 ? 1 : 3) {
    e = cudaLaunchKernelEx(&cfg, kern, wmap, A, staged, L, P, phase);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

template <int T, int CW>
int dispatch_sx(const Args& A, bool staged, const Plan& L, const Params& P, cudaStream_t s) {
  // rows a thread: 2 (up to 4 rows a call), else 4
  const bool small = L.rw == 2;
  switch (P.sx_n) {
    case 3: return small ? launch<T, 3, CW, 2>(A, staged, L, P, s) : launch<T, 3, CW, 4>(A, staged, L, P, s);
    case 4: return small ? launch<T, 4, CW, 2>(A, staged, L, P, s) : launch<T, 4, CW, 4>(A, staged, L, P, s);
    case 5: return small ? launch<T, 5, CW, 2>(A, staged, L, P, s) : launch<T, 5, CW, 4>(A, staged, L, P, s);
    case 6: return small ? launch<T, 6, CW, 2>(A, staged, L, P, s) : launch<T, 6, CW, 4>(A, staged, L, P, s);
    case 8: return small ? launch<T, 8, CW, 2>(A, staged, L, P, s) : launch<T, 8, CW, 4>(A, staged, L, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The plan's geometry against what this tile's kernels are built for.
template <int T>
bool plan_ok(const Args& A, const Plan& L, const Params& P) {
  const int csize = P.sw_n * L.sc;
  if (L.sc < 1 || T % L.sc || csize > 8) return false;
  const int C = T / L.sc;
  if (L.cw != (C == 32 ? 1 : 2) || C % (32 * L.cw)) return false;
  if (L.rw != 2 && L.rw != 4) return false;
  const int nwc = C / (32 * L.cw);
  const int chain_threads = 32 * nwc * L.nwr;
  if (L.nwr < 1 || L.mr != L.rw * L.nwr ||
      L.threads != (L.gx && chain_threads < GX_THREADS ? GX_THREADS : chain_threads) ||
      L.threads > MAX_THREADS || L.xs < L.mr * P.sx_n || L.xs % 4)
    return false;
  if (A.experts < 1 || (long)A.Kp / T * A.experts > 65535) return false;
  if (L.units < 1 || L.upt < 1 || L.upc < 1 || L.z < 1 || (long)L.upc * L.z < L.units) return false;
  // a one-pass `dynamic` unit is a whole range tile
  const bool dyn = P.radc > 1 && P.adc_mode == 0;
  if (dyn && !L.two_pass && (L.upt != 1 || (L.bmr < A.M ? L.bmr : A.M) > L.mr)) return false;
  if (!dyn && (L.two_pass || L.upt != 1 || L.bmr != L.mr)) return false;
  // the decode exchange: one unit, the tile's pairs fit the slab's place
  if (L.gx && (L.units != 1 || L.two_pass || P.sx_n * L.mr * P.sw_n > C)) return false;
  return L.smem > 0;
}

template <int T>
int launch_tile(const Args& A, bool staged, const Plan& L, const Params& P, cudaStream_t s) {
  if (!plan_ok<T>(A, L, P)) return (int)cudaErrorInvalidValue;
  // 32-column slabs take one column a thread, wider slabs two
  if constexpr (T == 32) return dispatch_sx<T, 1>(A, staged, L, P, s);
  else if constexpr (T == 64) return L.cw == 1 ? dispatch_sx<T, 1>(A, staged, L, P, s)
                                               : dispatch_sx<T, 2>(A, staged, L, P, s);
  else return dispatch_sx<T, 2>(A, staged, L, P, s);
}

}  // namespace detail
}  // namespace dpe
