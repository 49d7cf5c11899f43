// K2 / K3: paged attention for Hopper (sm_90a).
//
// K2 replaces repro/kernels/paged_attention.py::paged_decode_attention
//    (pallas_call :152, body _decode_kernel :44): one query token per slot.
// K3 replaces repro/kernels/paged_attention.py::paged_chunk_attention
//    (-> _paged_chunk_call, pallas_call :280, body _chunk_kernel :161): C
//    queries of one slot at positions start..start+C-1.
//
// Both walk the slot's block table themselves and read only the keys the
// mask can admit (positions lo..hi, all inside the logical blocks up to
// the limit), so block 0 (the trash block) and unmapped table entries
// are never read, and the masked tail the reference computes as
// exp(-1e30 - m) = 0 is skipped exactly.  Every sum is one float32 chain
// in the order the plain versions replay (kernels/paged_attention.py),
// so kernel and plain version agree to the bit:
//   scores: q.k as an fmaf chain over head_dim in order, times the scale;
//     K2 casts q to the pool dtype first (attention_decode), K3 keeps the
//     promoted dtype of q.k and rounds the dot to bf16 when both operands
//     are bf16 (_gqa_scores carries no preferred_element_type);
//   softmax: m = max, p = exp(s - m), l = sum p in key order, w = p / l
//     cast to the pool dtype (the reference's order);
//   PV: an fmaf chain over the keys in order, output in the pool dtype.
//
// K3 (paged_chunk_kernel, attend): one block of 128 threads per (query
// row, query head); a thread per key for the scores, one thread sums the
// softmax, a thread per dim runs the P.V chain, reading K / V from
// global memory.
//
// K2 (paged_decode_kernel) serves a whole GQA group: one block of 256
// threads per (slot, KV head) computes all G = H / KV query heads, so
// each K / V row is read once per group.  It streams the live prefix in
// tiles of whole pool blocks (64 keys), following the block table (its
// live entries staged in shared memory), with coalesced cp.async copies
// (16 B where a head's row is a multiple of 16 B) into a ring of four
// tiles, three in flight: first the K tiles, whose G x L scores stay in
// shared memory, then the exact two-pass softmax, then the V tiles.  The
// chains above run side by side: per K tile a thread takes one key and
// two query heads (two score chains sharing each k load, unrolled over
// head_dim 18, 32, 64 and 128; any other head_dim takes a run-time loop
// in the same order); the G sums of l run in G threads; per V tile a
// thread takes one dim and up to two heads, so one V load feeds both P.V
// chains, which it carries across the tiles in registers.  Shared memory
// holds the G x S scores and four tiles, which bounds the context (the
// wrapper raises past it).
// Bound: bytes of the live K/V prefix (tiny next to the DPE weights); the
// in-order chains make these calls latency-bound instead (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// K2: one block per (slot, KV head), all G query heads of the group
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_CHAINS = 2;       // P.V chains (query heads) a thread carries per pass
constexpr int DEC_STAGE_KEYS = 64;  // keys per staged tile, in whole pool blocks
constexpr int DEC_NBUF = 4;         // staged tiles in shared memory, DEC_NBUF - 1 in flight
constexpr size_t MAX_SMEM = 232448; // what one block may use on an H100

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// K2's shared memory: the group's q (float), the [G][lp] scores, the G
// normalisers, the slot's nb block-table entries, then DEC_NBUF staged
// tiles of stage_keys rows with stride ld.  Vector tiles keep the pool
// dtype and pad each row by 16 B; the others hold float32 rows of odd
// stride.  kernels/paged_attention.py repeats this layout to refuse a
// context that does not fit.
struct DecodeLayout {
  int lp, stage_keys, ld;
  size_t sc, ls, tab, tiles, tile_bytes, total;
};

__host__ __device__ inline DecodeLayout decode_layout(int G, int hd, int nb, int bs, bool vec,
                                                      int kv_bytes) {
  const int S = nb * bs;
  DecodeLayout d;
  d.lp = (S + 31) / 32 * 32 + 4;  // = 4 mod 32: G rows read side by side hit distinct banks
  d.stage_keys = (bs < DEC_STAGE_KEYS ? DEC_STAGE_KEYS / bs : 1) * bs;
  d.ld = vec ? hd + 16 / kv_bytes : (hd | 1);
  const int tile_elt = vec ? kv_bytes : 4;
  d.sc = align16(sizeof(float) * (size_t)G * hd);
  d.ls = d.sc + sizeof(float) * (size_t)G * d.lp;
  d.tab = d.ls + sizeof(float) * (size_t)G;
  d.tiles = align16(d.tab + sizeof(int) * (size_t)nb);
  d.tile_bytes = align16((size_t)d.stage_keys * d.ld * tile_elt);
  d.total = d.tiles + DEC_NBUF * d.tile_bytes;
  return d;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}


// Up to NH q . k chains side by side: heads h[0..NH) against one key row
// (the k loads are shared, and the chains' latencies overlap).  Each is
// one fmaf chain over d in order; q from shared float32, k from a shared
// tile row (16-B vector loads on vector tiles).
template <int NH, int HD, bool VEC, typename TT>
__device__ __forceinline__ void dot_heads(const float* __restrict__ qs, const int (&h)[NH],
                                          const TT* __restrict__ kr, int hd, float (&dot)[NH]) {
#pragma unroll
  for (int j = 0; j < NH; ++j) dot[j] = 0.f;
  if constexpr (VEC && std::is_same<TT, float>::value) {
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const float4 q4 = *reinterpret_cast<const float4*>(qs + h[j] * HD + d);
        dot[j] = fmaf(q4.x, k4.x, dot[j]);
        dot[j] = fmaf(q4.y, k4.y, dot[j]);
        dot[j] = fmaf(q4.z, k4.z, dot[j]);
        dot[j] = fmaf(q4.w, k4.w, dot[j]);
      }
    }
  } else if constexpr (VEC) {  // bf16 tile: 8 values per 16-B load
#pragma unroll
    for (int d = 0; d < HD; d += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 kf = __bfloat1622float2(k2[i]);
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const float2 q2 = *reinterpret_cast<const float2*>(qs + h[j] * HD + d + 2 * i);
          dot[j] = fmaf(q2.x, kf.x, dot[j]);
          dot[j] = fmaf(q2.y, kf.y, dot[j]);
        }
      }
    }
  } else if constexpr (HD > 0) {
#pragma unroll
    for (int d = 0; d < HD; ++d)
#pragma unroll
      for (int j = 0; j < NH; ++j) dot[j] = fmaf(qs[h[j] * HD + d], kr[d], dot[j]);
  } else {
    for (int d = 0; d < hd; ++d)
#pragma unroll
      for (int j = 0; j < NH; ++j) dot[j] = fmaf(qs[h[j] * hd + d], kr[d], dot[j]);
  }
}

// grid (B, KV): slot b, KV head kvh, query heads kvh*G .. kvh*G + G - 1.
// HD > 0 fixes head_dim at compile time; VEC tiles need HD * sizeof(TKV)
// to be a multiple of 16 B and both pools 16-B aligned.  head_dim <=
// DEC_THREADS.
template <typename TKV, int HD, bool VEC>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_kernel(const void* __restrict__ q, int q_bf16, const TKV* __restrict__ pool_k,
                    const TKV* __restrict__ pool_v, const int* __restrict__ bt,
                    const int* __restrict__ pos, TKV* __restrict__ out, int nb, int bs, int KV,
                    int H, int hd_rt, int window, float scale) {
  typedef typename std::conditional<VEC, TKV, float>::type TT;  // tile element
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = HD > 0 ? HD : hd_rt;
  const int G = H / KV, S = nb * bs;
  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const DecodeLayout lay = decode_layout(G, hd, nb, bs, VEC, (int)sizeof(TKV));
  float* qs = reinterpret_cast<float*>(smem_raw);             // [G][hd]
  float* sc = reinterpret_cast<float*>(smem_raw + lay.sc);    // [G][lp]: s, then p, then w
  float* ls = reinterpret_cast<float*>(smem_raw + lay.ls);    // [G]
  int* tab = reinterpret_cast<int*>(smem_raw + lay.tab);      // the live table entries
  const int lp = lay.lp, ld = lay.ld;

  const size_t head0 = (size_t)b * H + (size_t)kvh * G;  // the group's first query head
  const int nq = G * hd;
  for (int c = tid; c < nq; c += DEC_THREADS) {  // q cast to the pool dtype
    const float v = q_bf16 ? to_f(reinterpret_cast<const __nv_bfloat16*>(q)[head0 * hd + c])
                           : reinterpret_cast<const float*>(q)[head0 * hd + c];
    qs[c] = to_f(from_f<TKV>(v));
  }
  const int p = pos[b];
  const int hi = min(p, S - 1);  // keys ki <= pos
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  const int L = hi - lo + 1;
  TKV* outg = out + head0 * hd;
  if (L <= 0) {
    for (int c = tid; c < nq; c += DEC_THREADS) outg[c] = from_f<TKV>(0.f);
    return;
  }
  // key k's score of head h sits at sc[h * lp + k - base]: indices are
  // congruent to keys mod 4, so 4 keys from a multiple of 4 are one float4
  const int base = lo & ~3, off = lo - base;

  // tiles: the K tiles 0..nst-1, then the V tiles once per pass of chains
  const int sb = lay.stage_keys / bs;  // pool blocks per tile
  const int jlo = lo / bs, jhi = hi / bs;
  for (int j = tid; j <= jhi - jlo; j += DEC_THREADS) tab[j] = bt[(size_t)b * nb + jlo + j];
  __syncthreads();
  const int nst = (jhi - jlo) / sb + 1;
  // P.V: thread (group gi, dim d) carries the chains of heads gi, gi +
  // ngroups, ... (DEC_CHAINS of them per pass), so one V load feeds them all
  const int ngroups = DEC_THREADS / hd;
  const int gi = tid / hd, dd = tid - gi * hd;
  const int cmax = (G + ngroups - 1) / ngroups;
  const int npass = (cmax + DEC_CHAINS - 1) / DEC_CHAINS;
  const int ntiles = nst * (1 + npass);

  auto tile_at = [&](int i) {
    return reinterpret_cast<TT*>(smem_raw + lay.tiles + (i % DEC_NBUF) * lay.tile_bytes);
  };
  // copy tile i: its pool blocks one after the other, never past jhi
  auto issue = [&](int i) {
    const bool is_v = i >= nst;
    const int st = is_v ? (i - nst) % nst : i;
    const TKV* pool = is_v ? pool_v : pool_k;
    TT* dst = tile_at(i);
    const int j0 = st * sb;  // into tab, which starts at block jlo
    const int nblk = min(sb, jhi - jlo - j0 + 1);
    for (int jj = 0; jj < nblk; ++jj) {
      const TKV* src = pool + ((size_t)tab[j0 + jj] * bs * KV + kvh) * hd;
      TT* d = dst + jj * bs * ld;
      if constexpr (VEC) {  // 16-B copies
        constexpr int CH = 16 / (int)sizeof(TKV);
        constexpr int ROWCH = HD / CH;
        for (int e = tid; e < bs * ROWCH; e += DEC_THREADS) {
          const int r = e / ROWCH, c = (e % ROWCH) * CH;
          cp_async16(d + r * ld + c, src + (size_t)r * KV * HD + c);
        }
      } else {  // float32 rows: 4-B copies; bf16 rows: converted loads
        for (int e = tid; e < bs * hd; e += DEC_THREADS) {
          const int r = e / hd, c = e - r * hd;
          if constexpr (std::is_same<TKV, float>::value)
            cp_async4(d + r * ld + c, src + (size_t)r * KV * hd + c);
          else
            d[r * ld + c] = to_f(src[(size_t)r * KV * hd + c]);
        }
      }
    }
  };

  // the exact two-pass softmax over the scores of keys lo..hi
  auto softmax = [&]() {
    const int warp = tid >> 5, lane = tid & 31;
    for (int h = warp; h < G; h += DEC_WARPS) {
      float* row = sc + h * lp + off;
      float m = -INFINITY;
#pragma unroll 4
      for (int t = lane; t < L; t += 32) m = fmaxf(m, row[t]);
      m = warp_max(m);
#pragma unroll 4
      for (int t = lane; t < L; t += 32) row[t] = expf(__fadd_rn(row[t], -m));
    }
    __syncthreads();
    for (int h = tid; h < G; h += DEC_THREADS) {  // l in key order, G chains side by side
      const float* row = sc + h * lp;
      float l = 0.f;
      int t = off;
      const int end = off + L;
      for (; t < end && (t & 3); ++t) l = __fadd_rn(l, row[t]);
      for (; t + 32 <= end; t += 32) {  // 32 operands loaded ahead of their adds
        float4 p4[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) p4[u] = *reinterpret_cast<const float4*>(row + t + 4 * u);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          l = __fadd_rn(l, p4[u].x);
          l = __fadd_rn(l, p4[u].y);
          l = __fadd_rn(l, p4[u].z);
          l = __fadd_rn(l, p4[u].w);
        }
      }
      for (; t < end; ++t) l = __fadd_rn(l, row[t]);
      ls[h] = l;
    }
    __syncthreads();
    for (int h = warp; h < G; h += DEC_WARPS) {
      const float l = ls[h];
      float* row = sc + h * lp + off;
#pragma unroll 4
      for (int t = lane; t < L; t += 32) row[t] = to_f(from_f<TKV>(__fdiv_rn(row[t], l)));
    }
    __syncthreads();
  };

  // a chain past the last head reads head 0's weights and writes nothing,
  // so that every thread runs the same branch-free chains
  float acc[DEC_CHAINS];
  const float* wrow[DEC_CHAINS];  // the chain's weights, indexed by key - base
  bool live[DEC_CHAINS];
  for (int i = 0; i < DEC_NBUF - 1; ++i) {
    if (i < ntiles) issue(i);
    cp_commit();  // empty groups keep the count uniform
  }
  for (int i = 0; i < ntiles; ++i) {
    if (i + DEC_NBUF - 1 < ntiles) issue(i + DEC_NBUF - 1);  // into the buffer tile i-1 left
    cp_commit();
    cp_wait<DEC_NBUF - 1>();  // tile i has landed
    __syncthreads();
    const TT* tile = tile_at(i);
    const bool is_v = i >= nst;
    const int st = is_v ? (i - nst) % nst : i;
    const int kbase = (jlo + st * sb) * bs;
    const int klo = max(kbase, lo), khi = min(kbase + lay.stage_keys - 1, hi);
    const int nk = khi - klo + 1;
    if (!is_v) {
      // scores: per work item one key and two query heads
      constexpr int NH = 2;
      const int pairs = (G + NH - 1) / NH;
      for (int c = tid; c < pairs * nk; c += DEC_THREADS) {
        const int pr = c / nk, key = klo + (c - pr * nk);
        int h[NH];
#pragma unroll
        for (int j = 0; j < NH; ++j) h[j] = min(pr * NH + j, G - 1);  // repeats past G
        float dot[NH];
        dot_heads<NH, HD, VEC>(qs, h, tile + (key - kbase) * ld, hd, dot);
#pragma unroll
        for (int j = 0; j < NH; ++j) sc[h[j] * lp + key - base] = __fmul_rn(dot[j], scale);
      }
    } else {
      if (i == nst) softmax();
      const int pass = (i - nst) / nst;
      if (st == 0) {
#pragma unroll
        for (int j = 0; j < DEC_CHAINS; ++j) {
          const int h = gi + ngroups * (pass * DEC_CHAINS + j);
          live[j] = gi < ngroups && h < G;
          acc[j] = 0.f;
          wrow[j] = sc + (live[j] ? h : 0) * lp;
        }
      }
      // P.V: each chain over this tile's keys in order; the weights of 8
      // keys (two float4 each) and their V values loaded ahead of the fmaf
      const TT* vcol = tile + dd;  // vcol[(key - kbase) * ld]: V[key][dd]
      int key = klo;
      for (; key <= khi && (key & 3); ++key) {
        const float v = to_f(vcol[(key - kbase) * ld]);
#pragma unroll
        for (int j = 0; j < DEC_CHAINS; ++j) acc[j] = fmaf(wrow[j][key - base], v, acc[j]);
      }
      for (; key + 8 <= khi + 1; key += 8) {
        float v8[8];
        float4 w4[DEC_CHAINS][2];
#pragma unroll
        for (int u = 0; u < 8; ++u) v8[u] = to_f(vcol[(key + u - kbase) * ld]);
#pragma unroll
        for (int j = 0; j < DEC_CHAINS; ++j) {
          w4[j][0] = *reinterpret_cast<const float4*>(wrow[j] + key - base);
          w4[j][1] = *reinterpret_cast<const float4*>(wrow[j] + key - base + 4);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int j = 0; j < DEC_CHAINS; ++j) {
            acc[j] = fmaf(w4[j][u].x, v8[4 * u], acc[j]);
            acc[j] = fmaf(w4[j][u].y, v8[4 * u + 1], acc[j]);
            acc[j] = fmaf(w4[j][u].z, v8[4 * u + 2], acc[j]);
            acc[j] = fmaf(w4[j][u].w, v8[4 * u + 3], acc[j]);
          }
      }
      for (; key <= khi; ++key) {
        const float v = to_f(vcol[(key - kbase) * ld]);
#pragma unroll
        for (int j = 0; j < DEC_CHAINS; ++j) acc[j] = fmaf(wrow[j][key - base], v, acc[j]);
      }
      if (st == nst - 1) {
#pragma unroll
        for (int j = 0; j < DEC_CHAINS; ++j)
          if (live[j]) outg[(gi + ngroups * (pass * DEC_CHAINS + j)) * hd + dd] = from_f<TKV>(acc[j]);
      }
    }
    __syncthreads();  // tile i's buffer is refilled next iteration
  }
  cp_wait<0>();  // only empty groups can be pending here
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

template <typename TKV, int HD, bool VEC>
cudaError_t decode_hd(const void* q, int q_bf16, const void* pk, const void* pv, const int* bt,
                      const int* pos, void* out, int B, int nb, int bs, int KV, int H, int hd,
                      int window, float scale, cudaStream_t s) {
  const DecodeLayout lay = decode_layout(H / KV, hd, nb, bs, VEC, (int)sizeof(TKV));
  if (lay.total > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = paged_decode_kernel<TKV, HD, VEC>;
  // the shared-memory limit persists per device: raise it once per size,
  // not on every decode step (the call costs host time)
  static size_t raised[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || raised[dev] < lay.total) {
    e = prepare(kern, lay.total);
    if (e != cudaSuccess) return e;
    if (dev < 64) raised[dev] = lay.total;
  }
  kern<<<dim3(B, KV), DEC_THREADS, lay.total, s>>>(q, q_bf16, (const TKV*)pk, (const TKV*)pv, bt,
                                                   pos, (TKV*)out, nb, bs, KV, H, hd, window,
                                                   scale);
  return cudaGetLastError();
}

// head_dim 32 / 64 / 128 on 16-B aligned pools: vector tiles; 18 (the
// smoke config) unrolled; any other head_dim the run-time loop
template <typename TKV>
cudaError_t decode(const void* q, int q_bf16, const void* pk, const void* pv, const int* bt,
                   const int* pos, void* out, int B, int nb, int bs, int KV, int H, int hd,
                   int window, float scale, cudaStream_t s) {
  if (hd < 1 || hd > DEC_THREADS) return cudaErrorInvalidValue;
  const bool aligned = (uintptr_t)pk % 16 == 0 && (uintptr_t)pv % 16 == 0;
#define K2_ARGS q, q_bf16, pk, pv, bt, pos, out, B, nb, bs, KV, H, hd, window, scale, s
  if (aligned && hd == 32) return decode_hd<TKV, 32, true>(K2_ARGS);
  if (aligned && hd == 64) return decode_hd<TKV, 64, true>(K2_ARGS);
  if (aligned && hd == 128) return decode_hd<TKV, 128, true>(K2_ARGS);
  if (hd == 18) return decode_hd<TKV, 18, false>(K2_ARGS);
  return decode_hd<TKV, 0, false>(K2_ARGS);
#undef K2_ARGS
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
  cudaError_t e = kv_bf16
      ? decode<__nv_bfloat16>(q, q_bf16, pk, pv, bt, pos, out, B, nb, bs, KV, H, hd, window, scale, s)
      : decode<float>(q, q_bf16, pk, pv, bt, pos, out, B, nb, bs, KV, H, hd, window, scale, s);
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
