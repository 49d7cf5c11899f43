// Programming noise for Hopper (sm_90a): one thread per crossbar cell
// runs the whole round trip of core/device.py::noisy_slice_values --
// slice value -> conductance -> log-normal programming -> slice value --
// with the reference's random bits and XLA's float32 arithmetic.
//
// Per cell i of a slice plane (flat index, C order):
//   bits = threefry2x32(key, (i >> 32, i & 0xffffffff)), xor of the two
//          words (jax.random under jax_threefry_partitionable);
//   u    = max(lo, f * (1 - lo) + lo), f from the top 23 bits, lo the
//          float32 just above -1 (jax.random.uniform on (-1, 1));
//   z    = sqrt(2) * erf_inv(u) (Giles' polynomial, as XLA lowers it);
//   g    = lgs + v * dg;  mu = log(max(g, 1e-30)) - sigma^2/2;
//   out  = (exp(mu + sigma * z) - lgs) / dg,
// with log / log1p / exp the Cephes polynomials XLA evaluates.  Every
// multiply-add that XLA fuses is fmaf, and every other operation is an
// _rn intrinsic, which nvcc never contracts into a fused multiply-add:
// the kernel then equals its plain version (core/xmath.py, core/prng.py)
// bit for bit.  The constants are the plain version's float32 values,
// written as hex literals.
//
// Bound: 4 B read and 4 B written per cell; about 200 integer and float
// operations per cell, so on an H100 the kernel is bound by operations
// at qwen2-0.5b's slice planes (see kernels/program_noise.py).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k1, uint32_t k2, uint64_t i) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x1 = (uint32_t)(i >> 32) + ks[0];
  uint32_t x2 = (uint32_t)(i & 0xffffffffu) + ks[1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl(x2, rot[r % 2][j]);
      x2 ^= x1;
    }
    x1 += ks[(r + 1) % 3];
    x2 += ks[(r + 2) % 3] + (uint32_t)(r + 1);
  }
  return x1 ^ x2;
}

// Cephes logf, positive normal y (xmath.log)
__device__ __forceinline__ float xla_log(float y) {
  const int bits = __float_as_int(y);
  const float m = __int_as_float((bits & ~0x7F800000) | 0x3F000000);
  const bool small = m < 0x1.6a09e6p-1f;
  const float e = __fsub_rn(__fadd_rn((float)((bits >> 23) - 0x7F), 1.0f), small ? 1.0f : 0.0f);
  float x = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  const float y0 = fmaf(fmaf(x, 0x1.204376p-4f, -0x1.d7a370p-4f), x, 0x1.de4a34p-4f);
  const float y1 = fmaf(fmaf(x, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), x, -0x1.555ca0p-3f);
  const float y2 = fmaf(fmaf(x, 0x1.999d58p-3f, -0x1.fffff8p-3f), x, 0x1.555554p-2f);
  float p = fmaf(fmaf(y0, x3, y1), x3, y2);
  p = fmaf(p, x3, __fmul_rn(e, -0x1.bd0106p-13f));
  x = __fadd_rn(fmaf(x2, -0.5f, x), p);
  return fmaf(e, 0.693359375f, x);
}

// Cephes expf (xmath.exp)
__device__ __forceinline__ float xla_exp(float x) {
  x = fminf(fmaxf(x, -0x1.5f3334p+6f), 0x1.633334p+6f);
  const float n = fminf(fmaxf(floorf(fmaf(x, 0x1.715476p+0f, 0.5f)), -127.f), 127.f);
  float r = fmaf(n, -0.693359375f, x);
  r = fmaf(n, 0x1.bd0106p-13f, r);
  float p = fmaf(r, 0x1.a0d2cep-13f, 0x1.6e879cp-10f);
  p = fmaf(p, r, 0x1.111210p-7f);
  p = fmaf(p, r, 0x1.555382p-5f);
  p = fmaf(p, r, 0x1.555554p-3f);
  p = fmaf(p, r, 0.5f);
  p = __fadd_rn(fmaf(p, __fmul_rn(r, r), r), 1.0f);
  return __fmul_rn(p, __int_as_float(((int)n + 127) << 23));
}

// Cephes log1p, y > -1 (xmath.log1p)
__device__ __forceinline__ float xla_log1p(float y) {
  if (!(fabsf(y) < 0x1.a8279ap-2f)) return xla_log(__fadd_rn(y, 1.0f));
  const float num[7] = {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f, 0x1.de9738p+4f,
                        0x1.e798ecp+5f, 0x1.c8e75ap+5f, 0x1.40a202p+4f};
  const float den[7] = {0x1.000000p+0f, 0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f,
                        0x1.351946p+8f, 0x1.b0db14p+7f, 0x1.e0f304p+5f};
  float pn = 0.f, pd = 0.f;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    pn = fmaf(pn, y, num[i]);
    pd = fmaf(pd, y, den[i]);
  }
  const float r = __fdiv_rn(pn, pd);
  const float y2 = __fmul_rn(y, y);
  return __fadd_rn(y, fmaf(y2, -0.5f, __fmul_rn(__fmul_rn(y, y2), r)));
}

// Giles' single-precision erf_inv, x in (-1, 1) (xmath.erf_inv)
__device__ __forceinline__ float xla_erf_inv(float x) {
  const float lt5[9] = {0x1.e2cb10p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f,
                        -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a810p-10f,
                        -0x1.11c9dep-8f, 0x1.f91ec6p-3f, 0x1.805c5ep+0f};
  const float ge5[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
                        -0x1.e17bcep-9f, 0x1.7824f6p-8f, -0x1.f38baep-8f,
                        0x1.354afcp-7f, 0x1.006db6p+0f, 0x1.6a9efcp+1f};
  float w = -xla_log1p(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fmaf(p, w, lt ? lt5[i] : ge5[i]);
  return __fmul_rn(p, x);
}

__global__ void program_noise_kernel(const float* __restrict__ v, float* __restrict__ out,
                                     uint64_t n, uint32_t k1, uint32_t k2, float lgs,
                                     float dg, float half_s2, float sigma) {
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    // jax.random.normal: uniform on (lo, 1), then sqrt(2) * erf_inv
    const uint32_t bits = threefry_bits(k1, k2, i);
    const float f = __fsub_rn(__int_as_float((int)((bits >> 9) | 0x3F800000u)), 1.0f);
    const float lo = -0x1.fffffep-1f;
    const float u = fmaxf(lo, fmaf(f, 2.0f, lo));  // 1 - lo rounds to 2 in float32
    const float z = __fmul_rn(0x1.6a09e6p+0f, xla_erf_inv(u));
    // slice -> conductance -> log-normal programming -> slice
    const float g = __fadd_rn(__fmul_rn(v[i], dg), lgs);
    const float mu = __fsub_rn(xla_log(fmaxf(g, 1e-30f)), half_s2);
    const float gp = xla_exp(__fadd_rn(mu, __fmul_rn(sigma, z)));
    out[i] = __fdiv_rn(__fsub_rn(gp, lgs), dg);
  }
}

}  // namespace

// v, out: n float32 cells of one slice plane; (k1, k2) the slice's key.
extern "C" int program_noise_launch(const float* v, float* out, long long n, unsigned k1,
                                    unsigned k2, float lgs, float dg, float half_s2,
                                    float sigma, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 132LL * 64 ? want : 132LL * 64);
  program_noise_kernel<<<blocks, threads, 0, stream>>>(v, out, (uint64_t)n, k1, k2, lgs, dg,
                                                       half_s2, sigma);
  return (int)cudaGetLastError();
}
