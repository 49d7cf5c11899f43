// K5: flash attention for Hopper (sm_90a), on the tensor cores.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas
// (pallas_call :129; body _kernel :34).  The function is the reference's:
// scores s = (q . k) * scale in float32, masked to -1e30 (k_pos < skv,
// k_pos <= q_pos when causal, k_pos > q_pos - window), the online softmax
// m' = max(m, max s), alpha = exp(m - m'), p = exp(s - m'),
// l = l*alpha + sum p, acc = acc*alpha + p V, and the output
// acc / max(l, 1e-30) in the input dtype.
//
// Layout: one block of 4 warps per (64-row query tile, batch-head); warp
// w owns query rows 16w..16w+15 of the tile as the A operand of
// mma.sync (m16n8k8 tf32, or m16n8k16 bf16), so scores, running max,
// normaliser and accumulator stay in registers in the MMA fragment
// layout; row max and row sum go through quad shuffles.  The softmax runs
// in base 2 (scores times scale * log2 e, ex2.approx), which is the same
// function to within float32 rounding; masks are applied only on tiles
// that cross a mask edge.  A block's time is its chain of key tiles, so
// the first round of blocks (one per SM) takes the causal query tiles
// heaviest first and the second round lightest first: the two blocks an
// SM holds then carry about equal work.  Key / value tiles of 64 rows are
// double-buffered in shared memory and filled with 16-byte cp.async, so
// the next tile's copy overlaps this tile's math; rows past skv are
// zero-filled by the copy itself.  Key tiles that are masked for every
// row of the block are skipped: the reference's terms from them are
// multiplied by exp(-1e30 - m) = 0 once a live key arrives, or add
// exp(-1e30 - m) = 0 after the last one, so skipping them changes nothing.
//
// Precision: the reference upcasts to float32 and keeps p in float32.
//   float32 q, k: 3xTF32, each operand split as hi = tf32(x) (rounded),
//     lo = x - hi (read by the tensor core to tf32); q.k = hi.hi + hi.lo +
//     lo.hi accumulated in f32 (lo.lo is below float32's rounding).
//   bf16 q, k: one m16n8k16 bf16 product; bf16 x bf16 is exact in f32.
//   P V: p split into tf32 hi + lo; a float32 V is split too (three
//     products), a bf16 V is exact in tf32 (two products).  p is never
//     rounded to bf16.
// No single-pass TF32 product is taken anywhere.
//
// Bound: at qwen2-0.5b width (14 heads, head_dim 64, S = 1024, causal)
// the work is 1.88 GFLOP of attention, which 3xTF32 makes 3 x 1.88 GFLOP
// on the tensor cores (11.4 us at 495 TFLOP/s TF32), over 14.7 MB
// (4.4 us at 3.35 TB/s): operations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG = -1e30f;
constexpr int BQ = 64;  // query rows per block: 4 warps x 16
constexpr int BK = 64;  // keys per tile
constexpr int THREADS = 128;

typedef __nv_bfloat16 bf16;

// shared-memory row stride in elements: 16 B of padding keeps every
// fragment load below free of bank conflicts and every row 16-B aligned
template <typename T, int DH>
__host__ __device__ constexpr int row_stride() { return DH + 16 / (int)sizeof(T); }

template <typename T, int DH>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)(BQ + 4 * BK) * row_stride<T, DH>();  // Q, 2 x K, 2 x V
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; copies nothing and zero-fills when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo: hi is x rounded to tf32 (to nearest, ties away: half a
// tf32 ulp added to the magnitude bits, then the 13 low bits cleared) and
// lo = x - hi exactly; the tensor core reads lo's top 19 bits, within
// 2^-21 |x| of x - hi.  Three instructions (cvt.rna.tf32 takes four by
// itself on sm_90); x is finite here.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 2^x on the special-function unit; results below 2^-126 flush to zero
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The A fragments of one warp's 16 query rows: float32 values (split
// into tf32 hi / lo where they are used) or packed bf16 pairs.
template <typename T, int DH>
struct QFrag;

template <int DH>
struct QFrag<float, DH> {
  uint32_t hi[DH / 8][4], lo[DH / 8][4];  // split once, used on every key tile
  __device__ void load(const float* qs, int ld, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      const float* r0 = qs + g * ld + kk * 8 + t;
      const float* r8 = r0 + 8 * ld;
      split(r0[0], hi[kk][0], lo[kk][0]);
      split(r8[0], hi[kk][1], lo[kk][1]);
      split(r0[4], hi[kk][2], lo[kk][2]);
      split(r8[4], hi[kk][3], lo[kk][3]);
    }
  }
  // s (16 x 64 keys of this tile) = q k^T, 3xTF32
  __device__ void scores(const float* ks, int ld, int g, int t, float (&s)[8][4]) const {
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* kr = ks + (nt * 8 + g) * ld + kk * 8 + t;
        uint32_t bh0, bl0, bh1, bl1;
        split(kr[0], bh0, bl0);
        split(kr[4], bh1, bl1);
        mma_tf32(s[nt], lo[kk], bh0, bh1);
        mma_tf32(s[nt], hi[kk], bl0, bl1);
        mma_tf32(s[nt], hi[kk], bh0, bh1);
      }
    }
  }
};

template <int DH>
struct QFrag<bf16, DH> {
  uint32_t a[DH / 16][4];
  __device__ void load(const bf16* qs, int ld, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const bf16* r0 = qs + g * ld + kk * 16 + 2 * t;
      const bf16* r8 = r0 + 8 * ld;
      a[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
      a[kk][1] = *reinterpret_cast<const uint32_t*>(r8);
      a[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
      a[kk][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
    }
  }
  __device__ void scores(const bf16* ks, int ld, int g, int t, float (&s)[8][4]) const {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* kr = ks + (nt * 8 + g) * ld + kk * 16 + 2 * t;
        mma_bf16(s[nt], a[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
  }
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int sq, int skv, int causal, int window, float scale,
             int nsm) {
  constexpr int LD = row_stride<T, DH>();
  constexpr int CH = 16 / (int)sizeof(T);  // elements per 16-B copy
  constexpr int ROWCH = DH / CH;           // 16-B copies per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* ks = qs + BQ * LD;                    // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;                // [2][BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // MMA fragment row group, thread in group
  // block ranks in launch order: the first nsm (one per SM) take the query
  // tiles heaviest first, the rest lightest first, so that an SM's second
  // block is light where its first is heavy
  const int nblocks = gridDim.x * gridDim.y;
  int rank = blockIdx.y * gridDim.x + blockIdx.x;
  if (rank >= nsm) rank = nblocks - 1 - (rank - nsm);
  const int bh = rank % gridDim.x;
  const int q0 = (gridDim.y - 1 - rank / gridDim.x) * BQ;
  const int row0 = q0 + warp * 16 + g;                // rows row0 and row0 + 8
  const float scale2 = scale * 1.4426950408889634f;   // scale * log2(e)

  int hi = (skv + BK - 1) / BK;
  if (causal) hi = min(hi, (q0 + BQ - 1) / BK + 1);
  const int lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const T* qh = q + (size_t)bh * sq * DH;
  const T* kh = k + (size_t)bh * skv * DH;
  const T* vh = v + (size_t)bh * skv * DH;

  // rows r0..r0+63 of a (rows, DH) matrix into dst; rows >= rows are zero.
  // Thread tid copies chunk tid % ROWCH of rows tid / ROWCH + u * THREADS / ROWCH.
  static_assert(64 * ROWCH % THREADS == 0, "whole copy rounds");
  const int crow = tid / ROWCH, ccol = (tid % ROWCH) * CH;
  auto load_tile = [&](T* dst, const T* src, int r0, int rows) {
#pragma unroll
    for (int u = 0; u < 64 * ROWCH / THREADS; ++u) {
      const int r = crow + u * (THREADS / ROWCH);
      const bool in = r0 + r < rows;
      cp_async16(dst + r * LD + ccol, in ? src + (size_t)(r0 + r) * DH + ccol : src, in);
    }
  };
  auto load_kv = [&](int kt) {
    const int buf = (kt - lo) & 1;
    load_tile(ks + buf * BK * LD, kh, kt * BK, skv);
    load_tile(vs + buf * BK * LD, vh, kt * BK, skv);
  };

  load_tile(qs, qh, q0, sq);  // the reference's zero pad rows past sq
  if (lo < hi) load_kv(lo);
  cp_commit();

  QFrag<T, DH> qf;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // rows row0, row0 + 8
  float acc[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    if (kt + 1 < hi) {
      load_kv(kt + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (kt == lo) qf.load(qs + warp * 16 * LD, LD, g, t);
    const T* kb = ks + ((kt - lo) & 1) * BK * LD;
    const T* vb = vs + ((kt - lo) & 1) * BK * LD;

    // scores: s[nt][i] is (row0 + 8*(i >> 1), key kt*BK + nt*8 + 2t + (i & 1))
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    qf.scores(kb, LD, g, t, s);

    // the softmax in base 2: x = s * scale * log2(e), p = exp2(x - m),
    // which is the reference's exp(s * scale - m) with m in log2 units;
    // masks only on tiles that cross a mask edge for some row of the block
    const bool edge = (kt + 1) * BK > skv || (causal && kt * BK + BK - 1 > q0) ||
                      (window > 0 && kt * BK <= q0 + BQ - 1 - window);
    float mt[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * scale2;
        if (edge) {
          const int qpos = row0 + 8 * (i >> 1);
          const int kpos = kt * BK + nt * 8 + 2 * t + (i & 1);
          bool live = kpos < skv;
          if (causal) live = live && kpos <= qpos;
          if (window > 0) live = live && kpos > qpos - window;
          x = live ? x : NEG;
        }
        s[nt][i] = x;
        mt[i >> 1] = fmaxf(mt[i >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float mn = fmaxf(m[r], mt[r]);
      alpha[r] = exp2_ftz(m[r] - mn);
      m[r] = mn;
    }
    float ls[2] = {0.f, 0.f};  // this thread's part of the row sums
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2_ftz(s[nt][i] - m[i >> 1]);
        s[nt][i] = p;
        ls[i >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nd][i] *= alpha[i >> 1];

    // acc += p V.  The C fragment of keys 8j..8j+7 is the A fragment of
    // k-step j once the step's keys are taken in the order 0,2,4,6,1,3,5,7:
    // a = {p(g, 2t), p(g+8, 2t), p(g, 2t+1), p(g+8, 2t+1)}, and B row t
    // (t + 4) is V row 8j + 2t (8j + 2t + 1).
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ph[4], pl[4];
      split(s[j][0], ph[0], pl[0]);
      split(s[j][2], ph[1], pl[1]);
      split(s[j][1], ph[2], pl[2]);
      split(s[j][3], ph[3], pl[3]);
      const T* v0 = vb + (8 * j + 2 * t) * LD + g;
      const T* v1 = v0 + LD;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        if constexpr (std::is_same<T, float>::value) {
          uint32_t bh0, bl0, bh1, bl1;
          split(v0[nd * 8], bh0, bl0);
          split(v1[nd * 8], bh1, bl1);
          mma_tf32(acc[nd], pl, bh0, bh1);
          mma_tf32(acc[nd], ph, bl0, bl1);
          mma_tf32(acc[nd], ph, bh0, bh1);
        } else {  // a bf16 value is exact in tf32
          const uint32_t b0 = __float_as_uint(to_f(v0[nd * 8]));
          const uint32_t b1 = __float_as_uint(to_f(v1[nd * 8]));
          mma_tf32(acc[nd], pl, b0, b1);
          mma_tf32(acc[nd], ph, b0, b1);
        }
      }
    }
    __syncthreads();  // this tile's buffers are refilled next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    if (qpos >= sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = o + ((size_t)bh * sq + qpos) * DH + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
      store2(orow + nd * 8, acc[nd][2 * r] / den, acc[nd][2 * r + 1] / den);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                   int skv, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DH>();
  auto kern = flash_kernel<T, DH>;
  // per device, set once: the shared-memory limit and the SM count
  static int nsms[64];
  int dev = 0, nsm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && nsms[dev] > 0) {
    nsm = nsms[dev];
  } else {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (dev < 64) nsms[dev] = nsm;
  }
  dim3 grid(bh, (sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv,
                                        causal, window, scale, nsm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o, int bh,
                        int sq, int skv, int causal, int window, float scale, cudaStream_t s) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, o, bh, sq, skv, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, bh, sq, skv, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, bh, sq, skv, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (bh, sq, dh), k / v (bh, skv, dh), o like q; float32 or bfloat16, all
// 16-byte aligned.  The tiles are fixed: bq = bk = 64.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int bh, int sq, int skv, int dh, int bq, int bk,
                                      int causal, int window, float scale, int bf16_in,
                                      cudaStream_t stream) {
  if (bq != BQ || bk != BK || sq > 65535 * BQ) return (int)cudaErrorInvalidValue;
  cudaError_t e = bf16_in
      ? dispatch_dh<bf16>(dh, q, k, v, o, bh, sq, skv, causal, window, scale, stream)
      : dispatch_dh<float>(dh, q, k, v, o, bh, sq, skv, causal, window, scale, stream);
  return (int)e;
}
