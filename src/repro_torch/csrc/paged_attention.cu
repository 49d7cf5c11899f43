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
// One design serves both (attend_group): a block of 256 threads computes
// all G = H / KV query heads of one KV head for one query row -- a slot's
// token (K2, grid (B, KV)) or one row of the chunk (K3, grid (C, KV),
// row c at position start + c) -- so each K / V row is read once per
// group and row, not once per query head.  It streams the live prefix in
// tiles of whole pool blocks (64 keys), following the block table (its
// live entries staged in shared memory), with coalesced cp.async copies
// (16 B where a head's row is a multiple of 16 B) into a ring of four
// tiles, three in flight.  The chains run side by side: per K tile a
// thread takes one key and two query heads (two score chains sharing
// each k load, unrolled over head_dim 18, 32, 64 and 128; any other
// head_dim takes a run-time loop in the same order); the G sums of l run
// in G threads; per V tile a thread takes one dim and up to two heads, so
// one V load feeds both P.V chains, which it carries across the tiles in
// registers.
//
// Shared memory holds the group's q, the tile ring, and a region for
// scores and live block-table entries, sized per launch by the table a
// block may walk (K2: the table width; K3: blocks 0..lim): every score
// of that table where it fits, else all that the tiles leave of the 227
// KB a block may use.  A short table thus keeps a small footprint (two
// blocks an SM at the served shapes) and a long one gets the whole
// region.  Each block then decides on the device, from its own live
// length, how to use it.  Where the G x L scores and the live table
// entries fit the region (at qwen2-0.5b's G = 7, head_dim 64, float32:
// every block of a table up to 354 blocks, and L up to 5,668 keys in a
// wider one), the block keeps every score and runs the exact two-pass softmax on them: K
// tiles, softmax, V tiles.  Past that it keeps one tile of scores and
// recomputes them, with the same chains, in three passes over the K
// tiles -- the max, then the sum of p, then the weights, each followed
// by the tile's V -- so the result is the same to the bit, and the
// context is bounded only by the table entries the region can stage
// (39,764 blocks at qwen2-0.5b's heads).
// Bound: bytes of the live K/V prefix (tiny next to the DPE weights); the
// in-order chains make these calls latency-bound instead (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// A loop bound the compiler cannot see through.  A warp-per-head running
// max written as this kernel's lane-strided loops (t = lane; t < n;
// t += 32) read past n on the card (lanes 0-3 a pass more) with the bound
// visible, with or without an unroll pragma, and never with the bound
// behind this move (tools/warp_max_variants.py, nvcc 12.8); the loops
// below keep their bound behind it.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("mov.b32 %0, %1;" : "=r"(v) : "r"(v));
  return v;
}

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHAINS = 2;       // P.V chains (query heads) a thread carries per pass
constexpr int STAGE_KEYS = 64;  // keys per staged tile, in whole pool blocks
constexpr int NBUF = 4;         // staged tiles in shared memory, NBUF - 1 in flight
constexpr size_t MAX_SMEM = 232448; // what one block may use on an H100

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Row stride of a score row holding n keys: at least n, = 4 mod 32, so G
// rows read side by side hit distinct banks.
__host__ __device__ inline int score_stride(int n) { return (n + 27) / 32 * 32 + 4; }

// The shared memory of one block: the group's q (float), the G
// normalisers and maxima, the region (scores and the live block-table
// entries), then NBUF staged tiles of stage_keys rows with stride ld.
// Vector tiles keep the pool dtype and pad each row by 16 B; the others
// hold float32 rows of odd stride.  The region holds all G score rows of
// an nb-block table and its entries where they fit in what the tiles
// leave of MAX_SMEM (room), else room; it always holds one tile's scores
// and the entries.  kernels/paged_attention.py::group_layout repeats
// this layout.
struct Layout {
  int stage_keys, ld, tkp;  // tkp: row stride of one tile's scores
  size_t ls, mx, region, room, region_bytes, tile_sc_bytes, tiles, tile_bytes, total;
  bool ok;  // room holds one tile's scores and the nb entries
};

__host__ __device__ inline Layout group_layout(int G, int hd, int bs, bool vec, int kv_bytes,
                                               int nb) {
  Layout d;
  d.stage_keys = (bs < STAGE_KEYS ? STAGE_KEYS / bs : 1) * bs;
  d.ld = vec ? hd + 16 / kv_bytes : (hd | 1);
  d.tkp = score_stride(d.stage_keys + 3);  // keys of a tile from its base rounded down to 4
  const int tile_elt = vec ? kv_bytes : 4;
  d.tile_bytes = align16((size_t)d.stage_keys * d.ld * tile_elt);
  d.tile_sc_bytes = align16(sizeof(float) * (size_t)G * d.tkp);
  d.ls = align16(sizeof(float) * (size_t)G * hd);
  d.mx = d.ls + sizeof(float) * (size_t)G;
  d.region = align16(d.mx + sizeof(float) * (size_t)G);
  const size_t fixed = d.region + NBUF * d.tile_bytes;
  d.room = fixed < MAX_SMEM ? (MAX_SMEM - fixed) & ~(size_t)15 : 0;
  const size_t entries = align16(sizeof(int) * (size_t)nb);
  const size_t least = d.tile_sc_bytes + entries;
  const size_t all = align16(sizeof(float) * (size_t)G * score_stride(nb * bs)) + entries;
  d.ok = least <= d.room;
  d.region_bytes = d.ok ? (all < d.room ? (all > least ? all : least) : d.room) : 0;
  d.tiles = d.region + d.region_bytes;
  d.total = d.tiles + NBUF * d.tile_bytes;
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

struct Params {
  const void* q;          // K2 (B, H, hd), K3 (C, H, hd); float32 or bf16
  const void* pk;         // pools (n_blocks, bs, KV, hd)
  const void* pv;
  const int* bt;          // K2 (B, nb) tables, K3 the slot's (nb,) row
  const int* pos;         // K2 (B,) positions
  void* out;              // like q, in the pool dtype
  int q_bf16, nb, bs, KV, H, hd, window;
  int start, lim;         // K3: the chunk's first position, its last block
  int round_scores;       // K3: q and the pools both bf16
  float scale;
};

// What a tile of the ring holds, and what the block does with it.
enum TileKind { K_SCORES, K_MAX, K_SUM, K_WEIGHTS, V_TILE };

// One query row's group over keys lo..hi.  KEEP: every score stays in
// the region ([G][lp] from key `base`); otherwise one tile's scores do
// ([G][tkp] from the tile's first key rounded down to 4) and are
// recomputed per pass.
template <typename TKV, int HD, bool VEC, bool CHUNK, bool KEEP>
__device__ __forceinline__ void run_group(const Params& a, const Layout& lay, int hd, int G,
                                          int kvh, int lo, int hi, const int* __restrict__ btrow,
                                          TKV* __restrict__ outg) {
  typedef typename std::conditional<VEC, TKV, float>::type TT;  // tile element
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, bs = a.bs, KV = a.KV, ld = lay.ld;
  const float* qs = reinterpret_cast<const float*>(smem_raw);  // [G][hd]
  float* ls = reinterpret_cast<float*>(smem_raw + lay.ls);      // [G]
  float* mx = reinterpret_cast<float*>(smem_raw + lay.mx);      // [G]
  unsigned char* region = smem_raw + lay.region;
  const TKV* pool_k = reinterpret_cast<const TKV*>(a.pk);
  const TKV* pool_v = reinterpret_cast<const TKV*>(a.pv);
  const int L = hi - lo + 1;
  // key k's score of head h sits at sc[h * sld + k - (tile base)]:
  // indices are congruent to keys mod 4, so 4 keys from a multiple of 4
  // are one float4
  const int base = lo & ~3, off = lo - base;
  const int sld = KEEP ? score_stride(off + L) : lay.tkp;
  float* sc = reinterpret_cast<float*>(region);
  int* tab = reinterpret_cast<int*>(
      region + (KEEP ? align16(sizeof(float) * (size_t)G * sld) : lay.tile_sc_bytes));

  const int sb = lay.stage_keys / bs;  // pool blocks per tile
  const int jlo = lo / bs, jhi = hi / bs;
  for (int j = tid; j <= jhi - jlo; j += THREADS) tab[j] = btrow[jlo + j];
  if constexpr (!KEEP) {
    for (int h = tid; h < G; h += THREADS) {
      mx[h] = -INFINITY;
      ls[h] = 0.f;
    }
  }
  __syncthreads();
  const int nst = (jhi - jlo) / sb + 1;
  // P.V: thread (group gi, dim d) carries the chains of heads gi, gi +
  // ngroups, ... (CHAINS of them per pass), so one V load feeds them all
  const int ngroups = THREADS / hd;
  const int gi = tid / hd, dd = tid - gi * hd;
  const int cmax = (G + ngroups - 1) / ngroups;
  const int npass = (cmax + CHAINS - 1) / CHAINS;
  // KEEP: the K tiles, then the V tiles once per pass of chains.
  // Otherwise: the K tiles for the max, again for the sum, then per pass
  // of chains the K and the V of each tile in turn.
  const int ntiles = KEEP ? nst * (1 + npass) : 2 * nst * (1 + npass);
  auto kind_of = [&](int i, int& st, int& pass) -> TileKind {
    if constexpr (KEEP) {
      if (i < nst) {
        st = i;
        pass = 0;
        return K_SCORES;
      }
      st = (i - nst) % nst;
      pass = (i - nst) / nst;
      return V_TILE;
    } else {
      if (i < 2 * nst) {
        st = i % nst;
        pass = 0;
        return i < nst ? K_MAX : K_SUM;
      }
      const int j = i - 2 * nst;
      pass = j / (2 * nst);
      st = (j % (2 * nst)) / 2;
      return (j & 1) ? V_TILE : K_WEIGHTS;
    }
  };

  auto tile_at = [&](int i) {
    return reinterpret_cast<TT*>(smem_raw + lay.tiles + (i % NBUF) * lay.tile_bytes);
  };
  // copy tile i: its pool blocks one after the other, never past jhi
  auto issue = [&](int i) {
    int st, pass;
    const TKV* pool = kind_of(i, st, pass) == V_TILE ? pool_v : pool_k;
    TT* dst = tile_at(i);
    const int j0 = st * sb;  // into tab, which starts at block jlo
    const int nblk = min(sb, jhi - jlo - j0 + 1);
    for (int jj = 0; jj < nblk; ++jj) {
      const TKV* src = pool + ((size_t)tab[j0 + jj] * bs * KV + kvh) * hd;
      TT* d = dst + jj * bs * ld;
      if constexpr (VEC) {  // 16-B copies
        constexpr int CH = 16 / (int)sizeof(TKV);
        constexpr int ROWCH = HD / CH;
        for (int e = tid; e < bs * ROWCH; e += THREADS) {
          const int r = e / ROWCH, c = (e % ROWCH) * CH;
          cp_async16(d + r * ld + c, src + (size_t)r * KV * HD + c);
        }
      } else {  // float32 rows: 4-B copies; bf16 rows: converted loads
        for (int e = tid; e < bs * hd; e += THREADS) {
          const int r = e / hd, c = e - r * hd;
          if constexpr (std::is_same<TKV, float>::value)
            cp_async4(d + r * ld + c, src + (size_t)r * KV * hd + c);
          else
            d[r * ld + c] = to_f(src[(size_t)r * KV * hd + c]);
        }
      }
    }
  };

  // KEEP: the exact two-pass softmax over the scores of keys lo..hi
  auto softmax = [&]() {
    const int warp = tid >> 5, lane = tid & 31;
    const int n = opaque(L);
    for (int h = warp; h < G; h += WARPS) {
      float* row = sc + h * sld + off;
      float m = -INFINITY;
#pragma unroll 4
      for (int t = lane; t < n; t += 32) m = fmaxf(m, row[t]);
      m = warp_max(m);
#pragma unroll 4
      for (int t = lane; t < n; t += 32) row[t] = expf(__fadd_rn(row[t], -m));
    }
    __syncthreads();
    for (int h = tid; h < G; h += THREADS) {  // l in key order, G chains side by side
      const float* row = sc + h * sld;
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
    for (int h = warp; h < G; h += WARPS) {
      const float l = ls[h];
      float* row = sc + h * sld + off;
#pragma unroll 4
      for (int t = lane; t < n; t += 32) row[t] = to_f(from_f<TKV>(__fdiv_rn(row[t], l)));
    }
    __syncthreads();
  };

  // a chain past the last head reads head 0's weights and writes nothing,
  // so that every thread runs the same branch-free chains
  float acc[CHAINS];
  const float* wrow[CHAINS];  // the chain's weights, indexed by key - wb
  bool live[CHAINS];
  for (int i = 0; i < NBUF - 1; ++i) {
    if (i < ntiles) issue(i);
    cp_commit();  // empty groups keep the count uniform
  }
  for (int i = 0; i < ntiles; ++i) {
    if (i + NBUF - 1 < ntiles) issue(i + NBUF - 1);  // into the buffer tile i-1 left
    cp_commit();
    cp_wait<NBUF - 1>();  // tile i has landed
    __syncthreads();
    const TT* tile = tile_at(i);
    int st, pass;
    const TileKind kind = kind_of(i, st, pass);
    const int kbase = (jlo + st * sb) * bs;
    const int klo = max(kbase, lo), khi = min(kbase + lay.stage_keys - 1, hi);
    const int nk = khi - klo + 1;
    const int wb = KEEP ? base : (kbase & ~3);  // key of index 0 in a score row
    if (kind != V_TILE) {
      // scores: per work item one key and two query heads
      constexpr int NH = 2;
      const int pairs = (G + NH - 1) / NH;
      for (int c = tid; c < pairs * nk; c += THREADS) {
        const int pr = c / nk, key = klo + (c - pr * nk);
        int h[NH];
#pragma unroll
        for (int j = 0; j < NH; ++j) h[j] = min(pr * NH + j, G - 1);  // repeats past G
        float dot[NH];
        dot_heads<NH, HD, VEC>(qs, h, tile + (key - kbase) * ld, hd, dot);
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          float s = dot[j];
          if constexpr (CHUNK)
            if (a.round_scores) s = to_f(from_f<__nv_bfloat16>(s));
          sc[h[j] * sld + key - wb] = __fmul_rn(s, a.scale);
        }
      }
      if constexpr (!KEEP) {
        __syncthreads();
        if (kind == K_MAX) {  // the running max of each head, a thread per head
          for (int h = tid; h < G; h += THREADS) {
            const float* row = sc + h * sld + klo - wb;
            float m = mx[h];
#pragma unroll 8
            for (int t = 0; t < nk; ++t) m = fmaxf(m, row[t]);
            mx[h] = m;
          }
        } else {  // p = exp(s - m); the sum pass adds it, the weight pass divides
          for (int c = tid; c < G * nk; c += THREADS) {
            const int h = c / nk;
            float* s = sc + h * sld + klo - wb + (c - h * nk);
            const float p = expf(__fadd_rn(*s, -mx[h]));
            *s = kind == K_SUM ? p : to_f(from_f<TKV>(__fdiv_rn(p, ls[h])));
          }
          if (kind == K_SUM) {
            __syncthreads();
            for (int h = tid; h < G; h += THREADS) {  // l in key order, carried across tiles
              const float* row = sc + h * sld + klo - wb;
              float l = ls[h];
#pragma unroll 8
              for (int t = 0; t < nk; ++t) l = __fadd_rn(l, row[t]);
              ls[h] = l;
            }
          }
        }
      }
    } else {
      if (KEEP && i == nst) softmax();
      if (st == 0) {
#pragma unroll
        for (int j = 0; j < CHAINS; ++j) {
          const int h = gi + ngroups * (pass * CHAINS + j);
          live[j] = gi < ngroups && h < G;
          acc[j] = 0.f;
          wrow[j] = sc + (live[j] ? h : 0) * sld;
        }
      }
      // P.V: each chain over this tile's keys in order; the weights of 8
      // keys (two float4 each) and their V values loaded ahead of the fmaf
      const TT* vcol = tile + dd;  // vcol[(key - kbase) * ld]: V[key][dd]
      int key = klo;
      for (; key <= khi && (key & 3); ++key) {
        const float v = to_f(vcol[(key - kbase) * ld]);
#pragma unroll
        for (int j = 0; j < CHAINS; ++j) acc[j] = fmaf(wrow[j][key - wb], v, acc[j]);
      }
      for (; key + 8 <= khi + 1; key += 8) {
        float v8[8];
        float4 w4[CHAINS][2];
#pragma unroll
        for (int u = 0; u < 8; ++u) v8[u] = to_f(vcol[(key + u - kbase) * ld]);
#pragma unroll
        for (int j = 0; j < CHAINS; ++j) {
          w4[j][0] = *reinterpret_cast<const float4*>(wrow[j] + key - wb);
          w4[j][1] = *reinterpret_cast<const float4*>(wrow[j] + key - wb + 4);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int j = 0; j < CHAINS; ++j) {
            acc[j] = fmaf(w4[j][u].x, v8[4 * u], acc[j]);
            acc[j] = fmaf(w4[j][u].y, v8[4 * u + 1], acc[j]);
            acc[j] = fmaf(w4[j][u].z, v8[4 * u + 2], acc[j]);
            acc[j] = fmaf(w4[j][u].w, v8[4 * u + 3], acc[j]);
          }
      }
      for (; key <= khi; ++key) {
        const float v = to_f(vcol[(key - kbase) * ld]);
#pragma unroll
        for (int j = 0; j < CHAINS; ++j) acc[j] = fmaf(wrow[j][key - wb], v, acc[j]);
      }
      if (st == nst - 1) {
#pragma unroll
        for (int j = 0; j < CHAINS; ++j)
          if (live[j]) outg[(gi + ngroups * (pass * CHAINS + j)) * hd + dd] = from_f<TKV>(acc[j]);
      }
    }
    __syncthreads();  // tile i's buffer is refilled next iteration
  }
  cp_wait<0>();  // only empty groups can be pending here
}

// grid (rows, KV): query row blockIdx.x (K2: slot b at pos[b]; K3: chunk
// row c at start + c), KV head kvh, query heads kvh*G .. kvh*G + G - 1.
// HD > 0 fixes head_dim at compile time; VEC tiles need HD * sizeof(TKV)
// to be a multiple of 16 B and both pools 16-B aligned.  head_dim <=
// THREADS.
template <typename TKV, int HD, bool VEC, bool CHUNK>
__device__ __forceinline__ void attend_group(const Params& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = HD > 0 ? HD : a.hd;
  const int G = a.H / a.KV, bs = a.bs;
  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const Layout lay = group_layout(G, hd, bs, VEC, (int)sizeof(TKV), CHUNK ? a.lim + 1 : a.nb);
  float* qs = reinterpret_cast<float*>(smem_raw);  // [G][hd]
  const size_t head0 = (size_t)b * a.H + (size_t)kvh * G;  // the group's first query head
  const int nq = G * hd;
  for (int c = tid; c < nq; c += THREADS) {
    float v = a.q_bf16 ? to_f(reinterpret_cast<const __nv_bfloat16*>(a.q)[head0 * hd + c])
                       : reinterpret_cast<const float*>(a.q)[head0 * hd + c];
    if constexpr (!CHUNK) v = to_f(from_f<TKV>(v));  // K2: q cast to the pool dtype
    qs[c] = v;
  }
  const int p = CHUNK ? a.start + b : a.pos[b];
  // keys ki <= p inside the mapped blocks (K3: blocks 0..lim, so a pad row
  // past the chunk's valid tokens stops at the end of block lim)
  const int hi = min(p, (CHUNK ? a.lim + 1 : a.nb) * bs - 1);
  const int lo = a.window > 0 ? max(0, p - a.window + 1) : 0;
  TKV* outg = reinterpret_cast<TKV*>(a.out) + head0 * hd;
  if (hi < lo) {  // no admissible key (only a discarded pad query row)
    for (int c = tid; c < nq; c += THREADS) outg[c] = from_f<TKV>(0.f);
    return;
  }
  const int* btrow = a.bt + (CHUNK ? 0 : (size_t)b * a.nb);
  const int off = lo & 3, L = hi - lo + 1, nlive = hi / bs - lo / bs + 1;
  const bool keep = align16(sizeof(float) * (size_t)G * score_stride(off + L)) +
                        sizeof(int) * (size_t)nlive <= lay.region_bytes;
  if (keep)
    run_group<TKV, HD, VEC, CHUNK, true>(a, lay, hd, G, kvh, lo, hi, btrow, outg);
  else
    run_group<TKV, HD, VEC, CHUNK, false>(a, lay, hd, G, kvh, lo, hi, btrow, outg);
}

template <typename TKV, int HD, bool VEC>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(const Params a) {
  attend_group<TKV, HD, VEC, false>(a);
}

template <typename TKV, int HD, bool VEC>
__global__ void __launch_bounds__(THREADS) paged_chunk_kernel(const Params a) {
  attend_group<TKV, HD, VEC, true>(a);
}

template <typename TKV, int HD, bool VEC, bool CHUNK>
cudaError_t launch_hd(const Params& a, int rows, cudaStream_t s) {
  // the blocks walk the table's nb entries (K2) or blocks 0..lim (K3)
  const Layout lay = group_layout(a.H / a.KV, a.hd, a.bs, VEC, (int)sizeof(TKV),
                                  CHUNK ? a.lim + 1 : a.nb);
  if (!lay.ok) return cudaErrorInvalidValue;
  auto kern = CHUNK ? &paged_chunk_kernel<TKV, HD, VEC> : &paged_decode_kernel<TKV, HD, VEC>;
  // the shared-memory limit persists per device: raise it to the most a
  // block may use once, not on every launch (the call costs host time)
  static bool raised[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !raised[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 64) raised[dev] = true;
  }
  kern<<<dim3(rows, a.KV), THREADS, lay.total, s>>>(a);
  return cudaGetLastError();
}

// head_dim 32 / 64 / 128 on 16-B aligned pools: vector tiles; 18 (the
// smoke config) unrolled; any other head_dim the run-time loop
template <typename TKV, bool CHUNK>
cudaError_t launch(const Params& a, int rows, cudaStream_t s) {
  if (a.hd < 1 || a.hd > THREADS || a.H % a.KV) return cudaErrorInvalidValue;
  const bool aligned = (uintptr_t)a.pk % 16 == 0 && (uintptr_t)a.pv % 16 == 0;
  if (aligned && a.hd == 32) return launch_hd<TKV, 32, true, CHUNK>(a, rows, s);
  if (aligned && a.hd == 64) return launch_hd<TKV, 64, true, CHUNK>(a, rows, s);
  if (aligned && a.hd == 128) return launch_hd<TKV, 128, true, CHUNK>(a, rows, s);
  if (a.hd == 18) return launch_hd<TKV, 18, false, CHUNK>(a, rows, s);
  return launch_hd<TKV, 0, false, CHUNK>(a, rows, s);
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, int q_bf16, const void* pk, const void* pv,
                                   int kv_bf16, const int* bt, const int* pos, void* out, int B,
                                   int nb, int bs, int KV, int H, int hd, int window, float scale,
                                   cudaStream_t s) {
  const Params a{q, pk, pv, bt, pos, out, q_bf16, nb, bs, KV, H, hd, window, 0, 0, 0, scale};
  return (int)(kv_bf16 ? launch<__nv_bfloat16, false>(a, B, s) : launch<float, false>(a, B, s));
}

extern "C" int paged_chunk_launch(const void* q, int q_bf16, const void* pk, const void* pv,
                                  int kv_bf16, const int* bt_row, int start, int lim, void* out,
                                  int C, int nb, int bs, int KV, int H, int hd, int window,
                                  float scale, cudaStream_t s) {
  const Params a{q,  pk, pv, bt_row, nullptr, out,   q_bf16, nb,
                 bs, KV, H,  hd,     window,  start, lim,    q_bf16 && kv_bf16, scale};
  return (int)(kv_bf16 ? launch<__nv_bfloat16, true>(a, C, s) : launch<float, true>(a, C, s));
}
