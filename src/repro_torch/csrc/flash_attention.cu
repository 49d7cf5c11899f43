// K5: flash attention for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas
// (pallas_call :129; body _kernel :34).  One block per (query tile of bq
// rows, batch-head); thread t owns query row q0 + t and keeps its query
// row, its f32 accumulator, running max m and normaliser l in
// registers.  The block walks the key tiles of bk rows that any of its
// rows may see (causal: up to the tile's last row; window: from its
// first row's window start), with the K and V tile in shared memory as
// f32 (bf16 inputs are upcast on load, as the reference does).  Per key
// tile, the reference's online softmax: scores s = (q . k) * scale,
// masked to -1e30 (k_pos < skv, k_pos <= q_pos when causal, k_pos >
// q_pos - window), m' = max(m, max s), alpha = exp(m - m'),
// p = exp(s - m'), l = l*alpha + sum p, acc = acc*alpha + p V.  The
// output is acc / max(l, 1e-30) in the input dtype.  Key tiles that are
// masked for every row of the block are skipped: the reference's terms
// from them are multiplied by exp(-1e30 - m) = 0 once a live key
// arrives, or add exp(-1e30 - m) = 0 after the last one, so skipping
// them changes no bit.  The scores of a tile sit in shared memory
// ([bk][bq], one column per thread) between the max and the exp pass.
// Bound: at qwen2-0.5b width (14 heads, head_dim 64, S = 1024, causal)
// the work is ~1.9 GFLOP (28 us at 67 TFLOP/s f32) over 14.7 MB (4.4 us):
// operations.  This first kernel runs the dot products as scalar f32
// FMAs on the CUDA cores, one query row per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_BQ = 128;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, int DH>
__global__ void __launch_bounds__(MAX_BQ)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int sq, int skv, int bk, int causal, int window,
             float scale) {
  extern __shared__ float smem[];
  const int bq = blockDim.x;
  float* ks = smem;            // [bk][DH]
  float* vs = ks + bk * DH;    // [bk][DH]
  float* ss = vs + bk * DH;    // [bk][bq]
  const int t = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int qpos = q0 + t;

  float qr[DH], acc[DH];
  const T* qrow = q + ((size_t)bh * sq + qpos) * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = qpos < sq ? load(qrow + d) : 0.f;  // the reference's zero pad rows
    acc[d] = 0.f;
  }
  float m = NEG, l = 0.f;

  int hi = (skv + bk - 1) / bk;
  if (causal) hi = min(hi, (q0 + bq - 1) / bk + 1);
  const int lo = window > 0 ? max(0, q0 - window + 1) / bk : 0;
  const T* kh = k + (size_t)bh * skv * DH;
  const T* vh = v + (size_t)bh * skv * DH;

  for (int kt = lo; kt < hi; ++kt) {
    const int kbase = kt * bk;
    __syncthreads();  // the previous tile is no longer read
    for (int idx = t; idx < bk * DH; idx += bq) {
      const int kp = kbase + idx / DH;
      const size_t off = (size_t)kp * DH + idx % DH;
      ks[idx] = kp < skv ? load(kh + off) : 0.f;
      vs[idx] = kp < skv ? load(vh + off) : 0.f;
    }
    __syncthreads();
    float mt = NEG;
    for (int j = 0; j < bk; ++j) {
      const float* kr = ks + j * DH;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(qr[d], kr[d], s);
      s = s * scale;
      const int kp = kbase + j;
      bool live = kp < skv;
      if (causal) live = live && kp <= qpos;
      if (window > 0) live = live && kp > qpos - window;
      s = live ? s : NEG;
      ss[j * bq + t] = s;
      mt = fmaxf(mt, s);
    }
    const float mn = fmaxf(m, mt);
    const float alpha = expf(m - mn);
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
    float lsum = 0.f;
    for (int j = 0; j < bk; ++j) {
      const float p = expf(ss[j * bq + t] - mn);
      lsum += p;
      const float* vr = vs + j * DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
    }
    l = l * alpha + lsum;
    m = mn;
  }
  if (qpos < sq) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + ((size_t)bh * sq + qpos) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) store(orow + d, acc[d] / den);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                   int skv, int bq, int bk, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * bk * DH + (size_t)bk * bq);
  auto kern = flash_kernel<T, DH>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sq + bq - 1) / bq, bh);
  kern<<<grid, bq, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, bk,
                                   causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o, int bh,
                        int sq, int skv, int bq, int bk, int causal, int window, float scale,
                        cudaStream_t s) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, o, bh, sq, skv, bq, bk, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, bh, sq, skv, bq, bk, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, bh, sq, skv, bq, bk, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (bh, sq, dh), k / v (bh, skv, dh), o like q; float32 or bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int bh, int sq, int skv, int dh, int bq, int bk,
                                      int causal, int window, float scale, int bf16,
                                      cudaStream_t stream) {
  if (bq < 1 || bq > MAX_BQ || bk < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = bf16 ? dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, bh, sq, skv, bq, bk, causal,
                                                    window, scale, stream)
                       : dispatch_dh<float>(dh, q, k, v, o, bh, sq, skv, bq, bk, causal, window,
                                            scale, stream);
  return (int)e;
}
