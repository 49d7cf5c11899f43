// K2 / K3: paged attention for Hopper (sm_90a).
//
// K2 replaces repro/kernels/paged_attention.py::paged_decode_attention
//    (pallas_call :152, body _decode_kernel :44): one query token per slot.
// K3 replaces repro/kernels/paged_attention.py::paged_chunk_attention
//    (-> _paged_chunk_call, pallas_call :280, body _chunk_kernel :161): C
//    queries of one slot at positions start..start+C-1.
//
// One block of 128 threads per (query row, query head).  It walks the
// slot's block table itself and reads only the keys the mask can admit —
// positions lo..hi, all inside logical blocks 0..lim — so block 0 (the
// trash block) and unmapped table entries are never read past the limit,
// and the masked tail the reference computes as exp(-1e30 - m) = 0 is
// skipped exactly.
//   scores: a thread per key, an fma chain over head_dim;
//     K2 casts q to the pool dtype first (attention_decode), K3 keeps the
//     promoted dtype of q·k and rounds the dot to bf16 when both operands
//     are bf16 (_gqa_scores carries no preferred_element_type);
//   softmax: m = max, p = exp(s - m), l = sum p in key order, w = p / l
//     cast to the pool dtype (the reference's order);
//   PV: a thread per dim, an fma chain over the keys in order,
//     output in the pool dtype.
// Every chain runs in the order the plain versions replay, so kernel and
// plain version agree to the bit (kernels/paged_attention.py).
// Bound: bytes of the live K/V prefix (tiny next to the DPE weights); the
// in-order chains make these calls latency-bound instead (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARP = THREADS / 32;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide max of one value per thread.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = red[0];
    for (int w = 1; w < NWARP; ++w) r = fmaxf(r, red[w]);
    red[NWARP] = r;
  }
  __syncthreads();
  const float r = red[NWARP];
  __syncthreads();
  return r;
}

// Attention of one query head over keys lo..hi.  Each sum is one
// float32 fused multiply-add chain (or add chain) in order, which the
// plain versions replay bit for bit.
template <typename TQ, typename TKV>
__device__ void attend(const TQ* __restrict__ q_head, const TKV* __restrict__ pool_k,
                       const TKV* __restrict__ pool_v, const int* __restrict__ table,
                       int bs, int KV, int hd, int kvh, int lo, int hi, int S, float scale,
                       bool cast_q, bool round_scores, TKV* __restrict__ out_head,
                       float* smem) {
  float* qs = smem;              // [hd]
  float* sc = qs + hd;           // [S]: scores, then softmax weights
  float* red = sc + S;           // [NWARP + 1]
  float* lsum = red + NWARP + 1; // [1]
  int* rows = (int*)(lsum + 1);  // [S]: pool row of each key lo..hi
  const int tid = threadIdx.x;
  const int L = hi - lo + 1;
  for (int d = tid; d < hd; d += THREADS) {
    float v = to_f(q_head[d]);
    if (cast_q) v = to_f(from_f<TKV>(v));
    qs[d] = v;
  }
  for (int t = tid; t < L; t += THREADS) {
    const int key = lo + t;
    rows[t] = table[key / bs] * bs + key % bs;
  }
  __syncthreads();
  if (L <= 0) {  // no admissible key (only a discarded pad query row)
    for (int d = tid; d < hd; d += THREADS) out_head[d] = from_f<TKV>(0.f);
    return;
  }
  // scores: a thread per key, q.k as an fma chain over d
  for (int t = tid; t < L; t += THREADS) {
    const TKV* krow = pool_k + ((size_t)rows[t] * KV + kvh) * hd;
    float dot = 0.f;
    for (int d = 0; d < hd; ++d) dot = fmaf(qs[d], to_f(krow[d]), dot);
    if (round_scores) dot = to_f(from_f<__nv_bfloat16>(dot));
    sc[t] = __fmul_rn(dot, scale);
  }
  __syncthreads();
  // softmax: exact max, p = exp(s - m), the sum in key order by one
  // thread, then p / l in the value dtype
  float m = -INFINITY;
  for (int t = tid; t < L; t += THREADS) m = fmaxf(m, sc[t]);
  m = block_max(m, red);
  for (int t = tid; t < L; t += THREADS) sc[t] = expf(__fadd_rn(sc[t], -m));
  __syncthreads();
  if (tid == 0) {
    float l = 0.f;
    for (int t = 0; t < L; ++t) l = __fadd_rn(l, sc[t]);
    *lsum = l;
  }
  __syncthreads();
  const float l = *lsum;
  for (int t = tid; t < L; t += THREADS) sc[t] = to_f(from_f<TKV>(__fdiv_rn(sc[t], l)));
  __syncthreads();
  // PV: a thread per dim, an fma chain over the keys in order
  for (int d = tid; d < hd; d += THREADS) {
    const TKV* vcol = pool_v + (size_t)kvh * hd + d;
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < L; ++t) acc = fmaf(sc[t], to_f(vcol[(size_t)rows[t] * KV * hd]), acc);
    out_head[d] = from_f<TKV>(acc);
  }
}

// grid (B, H): slot b, query head h
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
                    const TKV* __restrict__ pool_v, const int* __restrict__ bt,
                    const int* __restrict__ pos, TKV* __restrict__ out, int nb, int bs,
                    int KV, int H, int hd, int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, S = nb * bs;
  const int p = pos[b];
  const int hi = min(p, S - 1);  // keys ki <= pos
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  const size_t row = (size_t)b * H + h;
  attend<TQ, TKV>(q + row * hd, pool_k, pool_v, bt + (size_t)b * nb, bs, KV, hd, h / (H / KV),
                  lo, hi, S, scale, /*cast_q=*/true, /*round_scores=*/false, out + row * hd, smem);
}

// grid (C, H): chunk query c, query head h
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_chunk_kernel(const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
                   const TKV* __restrict__ pool_v, const int* __restrict__ bt_row,
                   int start, int lim, TKV* __restrict__ out, int nb, int bs, int KV,
                   int H, int hd, int window, float scale, int round_scores) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, h = blockIdx.y, S = nb * bs;
  const int qi = start + c;
  const int hi = min(qi, (lim + 1) * bs - 1);  // causal ki <= qi, blocks 0..lim
  const int lo = window > 0 ? max(0, qi - window + 1) : 0;
  const size_t row = (size_t)c * H + h;
  attend<TQ, TKV>(q + row * hd, pool_k, pool_v, bt_row, bs, KV, hd, h / (H / KV), lo, hi, S,
                  scale, /*cast_q=*/false, round_scores != 0, out + row * hd, smem);
}

size_t smem_bytes(int hd, int S) {
  return sizeof(float) * ((size_t)hd + 2 * (size_t)S + NWARP + 2);
}

template <typename K>
cudaError_t prepare(K kern, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

template <typename TQ, typename TKV>
cudaError_t decode(const void* q, const void* pk, const void* pv, const int* bt, const int* pos,
                   void* out, int B, int nb, int bs, int KV, int H, int hd, int window,
                   float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(hd, nb * bs);
  auto kern = paged_decode_kernel<TQ, TKV>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(B, H), THREADS, smem, s>>>((const TQ*)q, (const TKV*)pk, (const TKV*)pv, bt, pos,
                                          (TKV*)out, nb, bs, KV, H, hd, window, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t chunk(const void* q, const void* pk, const void* pv, const int* bt, int start,
                  int lim, void* out, int C, int nb, int bs, int KV, int H, int hd, int window,
                  float scale, int round_scores, cudaStream_t s) {
  const size_t smem = smem_bytes(hd, nb * bs);
  auto kern = paged_chunk_kernel<TQ, TKV>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(C, H), THREADS, smem, s>>>((const TQ*)q, (const TKV*)pk, (const TKV*)pv, bt, start,
                                          lim, (TKV*)out, nb, bs, KV, H, hd, window, scale,
                                          round_scores);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, int q_bf16, const void* pk, const void* pv,
                                   int kv_bf16, const int* bt, const int* pos, void* out, int B,
                                   int nb, int bs, int KV, int H, int hd, int window, float scale,
                                   cudaStream_t s) {
  typedef __nv_bfloat16 bf;
  cudaError_t e;
  if (q_bf16 && kv_bf16) e = decode<bf, bf>(q, pk, pv, bt, pos, out, B, nb, bs, KV, H, hd, window, scale, s);
  else if (q_bf16) e = decode<bf, float>(q, pk, pv, bt, pos, out, B, nb, bs, KV, H, hd, window, scale, s);
  else if (kv_bf16) e = decode<float, bf>(q, pk, pv, bt, pos, out, B, nb, bs, KV, H, hd, window, scale, s);
  else e = decode<float, float>(q, pk, pv, bt, pos, out, B, nb, bs, KV, H, hd, window, scale, s);
  return (int)e;
}

extern "C" int paged_chunk_launch(const void* q, int q_bf16, const void* pk, const void* pv,
                                  int kv_bf16, const int* bt_row, int start, int lim, void* out,
                                  int C, int nb, int bs, int KV, int H, int hd, int window,
                                  float scale, cudaStream_t s) {
  typedef __nv_bfloat16 bf;
  const int rs = q_bf16 && kv_bf16;
  cudaError_t e;
  if (q_bf16 && kv_bf16) e = chunk<bf, bf>(q, pk, pv, bt_row, start, lim, out, C, nb, bs, KV, H, hd, window, scale, rs, s);
  else if (q_bf16) e = chunk<bf, float>(q, pk, pv, bt_row, start, lim, out, C, nb, bs, KV, H, hd, window, scale, rs, s);
  else if (kv_bf16) e = chunk<float, bf>(q, pk, pv, bt_row, start, lim, out, C, nb, bs, KV, H, hd, window, scale, rs, s);
  else e = chunk<float, float>(q, pk, pv, bt_row, start, lim, out, C, nb, bs, KV, H, hd, window, scale, rs, s);
  return (int)e;
}
