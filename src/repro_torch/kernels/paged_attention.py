"""K2 / K3 — paged attention over the serving block pool: CUDA kernels
and their plain versions.

K2 replaces ``repro/kernels/paged_attention.py::paged_decode_attention``
(``pallas_call`` :152, body ``_decode_kernel`` :44): one-token GQA for
every slot over its mapped blocks ``0..pos//bs``; f32 scores times
``hd**-0.5``, mask ``ki <= pos`` (and the window), max / exp / sum,
``p/l`` cast to the pool dtype, then PV; output in the pool dtype.

K3 replaces ``repro/kernels/paged_attention.py::paged_chunk_attention``
(``_paged_chunk_call``, ``pallas_call`` :280, body ``_chunk_kernel``
:161): C queries of one slot at ``start..start+C-1`` over blocks
``0..(start+n_valid-1)//bs`` under the causal ``ki <= qi`` mask (and the
window); rows ``>= n_valid`` are pad queries whose output callers drop.

Plain versions: ``_paged_gather`` into logical order, then
``attention_decode`` / ``attention_dense`` — the reference's dense-gather
path, which reads the whole ``(B, nb*bs)`` view and masks its tail.
They replay the kernels' arithmetic: each q·k dot and each P·V sum is
one float32 fused multiply-add chain in order (head dimension, keys),
the softmax sum runs over the keys in order, and masked keys enter as
exact zeros.  Kernel and plain version therefore agree to the bit on
the card, which the served path needs: the faithful engine quantises
every activation, so a last-bit difference in attention can move a
quantiser code and grow through 24 layers.

Kernels (``csrc/paged_attention.cu``) walk the block table themselves
and read only the keys the mask admits, so the trash block and unmapped
tail are never read; scores sit in shared memory, so the exact two-pass
softmax of the reference is kept (no online rescaling). K2 runs one
block per (slot, KV head) for the whole GQA group: K and then V stream
through shared memory in tiles of whole pool blocks (``cp.async``, a
ring of four tiles, three in flight), one chain per (head, key) for the
scores, one per head for the softmax sum, one per (head, dim) for P·V.
K3 runs one block per (query row, query head): a thread per key computes
a score, one thread sums the softmax, a thread per dim runs the P·V
chain. Bound on an H100: the bytes of the live K/V prefix (3.35 TB/s);
at serving sizes that is well under a microsecond, and these calls are
bound by the latency of their in-order chains (PERF.md). Shared memory
holds K2's ``G x nb*bs`` scores (G = H / KV) and K3's ``nb*bs`` scores
and key rows, which caps one slot's context: for K2 at 5,664 positions
with qwen2-0.5b's heads (G = 7, head_dim 64, float32, block size 16) and
38,208 with one query head per KV head (same head_dim, dtype and block
size); for K3 at about 29,000. The wrappers raise past it
(:func:`decode_smem_bytes`).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .build import LaunchCounter, check, library
from .ref import fma

__all__ = [
    "TRASH_BLOCK",
    "attention_decode",
    "attention_dense",
    "_paged_gather",
    "paged_decode_attention_ref",
    "paged_chunk_attention_ref",
    "paged_decode_attention_cuda",
    "paged_chunk_attention_cuda",
    "decode_counter",
    "chunk_counter",
]

TRASH_BLOCK = 0
_NEG = -1e30
_SMEM_LIMIT = 227 * 1024
decode_counter = LaunchCounter("paged_decode_attention")
chunk_counter = LaunchCounter("paged_chunk_attention")


def _dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_d a[..., d] * b[..., d]`` over the last axis as the kernels
    compute it: one float32 fused multiply-add chain over d in order."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]),
                      dtype=torch.float32, device=a.device)
    for d in range(a.shape[-1]):
        acc = fma(a[..., d], b[..., d], acc)
    return acc


def _softmax(s: torch.Tensor, out_dtype) -> torch.Tensor:
    """``p / sum(p)`` with ``p = exp(s - max s)`` over the last axis, the
    sum taken in key order from zero (masked keys add exact zeros), the
    result cast to ``out_dtype``."""
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = torch.zeros_like(p[..., :1])
    for t in range(p.shape[-1]):
        l = l + p[..., t:t + 1]
    return (p / l).to(out_dtype)


def _weighted_sum(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``sum_t w[..., t] * v[..., t, :]`` as one fused multiply-add chain
    over the keys in order (masked keys carry w = 0 and change nothing)."""
    acc = torch.zeros(w.shape[:-1] + v.shape[-1:], dtype=torch.float32, device=w.device)
    for t in range(w.shape[-1]):
        acc = fma(w[..., t, None], v[..., t, :], acc)
    return acc


def _paged_gather(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Slot-major logical view of the block pool: pool (n_blocks, bs, KV,
    hd), block_tables (B, nb) -> (B, nb*bs, KV, hd)."""
    b, nb = block_tables.shape
    g = pool[block_tables.long()]
    return g.reshape(b, nb * pool.shape[1], *pool.shape[2:])


def attention_decode(q1, k_cache, v_cache, pos, *, window=0):
    """One-token attention against a logical-order cache.  q1 (B, H, dh);
    caches (B, S, KV, dh); pos (B,) the new token's index (keys
    ``<= pos`` are valid).  Output (B, H, dh) in the cache dtype.  q is
    cast to the cache dtype and its scores are float32."""
    b, h, dh = q1.shape
    kvh = k_cache.shape[2]
    g = h // kvh
    qg = q1.reshape(b, kvh, g, 1, dh).to(k_cache.dtype).float()
    kt = k_cache.permute(0, 2, 1, 3)[:, :, None].float()  # (B, KV, 1, S, dh)
    s = _dots(qg, kt) * _scale(dh)  # (B, KV, G, S)
    ki = torch.arange(k_cache.shape[1], device=q1.device)[None, :]
    mask = ki <= pos[:, None]
    if window > 0:
        mask &= ki > pos[:, None] - window
    s = torch.where(mask[:, None, None, :], s, _NEG)
    w = _softmax(s, v_cache.dtype).float()
    out = _weighted_sum(w, v_cache.permute(0, 2, 1, 3)[:, :, None].float())
    return out.to(v_cache.dtype).reshape(b, h, dh)


def _causal_mask(sq, skv, q_off, window, device):
    qi = q_off + torch.arange(sq, device=device)[:, None]
    ki = torch.arange(skv, device=device)[None, :]
    m = ki <= qi
    if window > 0:
        m &= ki > qi - window
    return m


def attention_dense(q, k, v, *, q_off=0, window=0, causal=True):
    """Full score-matrix GQA attention (short sequences).  q (B, Sq, H,
    dh), k / v (B, Skv, KV, dh) -> (B, Sq, H, dh).  The scores take the
    promoted dtype of q and k (bf16 when both are), as the reference's
    ``_gqa_scores``; the output takes the promoted dtype of v."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, dh).permute(0, 2, 3, 1, 4)[:, :, :, :, None].float()
    kt = k.permute(0, 2, 1, 3)[:, :, None, None].float()  # (B, KV, 1, 1, Skv, dh)
    s = _dots(qg, kt).to(torch.promote_types(q.dtype, k.dtype)).float() * _scale(dh)
    if causal:
        mask = _causal_mask(sq, k.shape[1], q_off, window, q.device)
        s = torch.where(mask[None, None, None], s, _NEG)
    w = _softmax(s, v.dtype).float()  # (B, KV, G, Sq, Skv)
    out = _weighted_sum(w, v.permute(0, 2, 1, 3)[:, :, None, None].float())
    out = out.to(v.dtype)  # (B, KV, G, Sq, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


def _scale(dh: int) -> float:
    return float(np.float32(dh**-0.5))


def paged_decode_attention_ref(q, pool_k, pool_v, block_tables, pos, *, window=0):
    """Plain K2: gather the whole logical view, then ``attention_decode``."""
    return attention_decode(
        q, _paged_gather(pool_k, block_tables), _paged_gather(pool_v, block_tables),
        pos, window=window,
    )


def paged_chunk_attention_ref(q, pool_k, pool_v, bt_row, start, n_valid, *, window=0):
    """Plain K3: gather the slot's logical view, then ``attention_dense``
    with the query offset ``start`` (``n_valid`` only bounds the kernel's
    block walk; pad query rows are discarded by callers)."""
    return attention_dense(
        q, _paged_gather(pool_k, bt_row[None]), _paged_gather(pool_v, bt_row[None]),
        q_off=int(start), window=window,
    )


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "paged_decode_launch": [_P, _I, _P, _P, _I, _P, _P, _P] + [_I] * 7 + [_F, _P],
    "paged_chunk_launch": [_P, _I, _P, _P, _I, _P, _I, _I, _P] + [_I] * 7 + [_F, _P],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(library(), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name]
    return fn


def _check_pools(who, q, pool_k, pool_v):
    def need(cond, msg):
        if not cond:
            raise ValueError(f"{who}: {msg}")

    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        need(t.is_cuda, f"{name} must be a CUDA tensor")
        need(t.dtype in (torch.float32, torch.bfloat16), f"{name} must be float32 or bfloat16")
        need(t.is_contiguous(), f"{name} must be contiguous")
        need(t.device == q.device, f"{name} is on another device")
    need(pool_k.dtype == pool_v.dtype, "pool_k / pool_v dtypes differ")
    need(pool_k.dim() == 4 and pool_k.shape == pool_v.shape, "pools must be (n_blocks, bs, KV, hd)")
    h, hd = q.shape[-2], q.shape[-1]
    kv = pool_k.shape[2]
    need(pool_k.shape[3] == hd, "head_dim of q and pools differ")
    need(h % kv == 0, f"{h} query heads not a multiple of {kv} KV heads")
    return need


def decode_smem_bytes(g, hd, nb, bs, vec, kv_bytes):
    """Shared memory of one K2 block (``decode_layout`` in the CUDA
    source): the group's q, ``g`` rows of scores over ``nb * bs`` keys,
    ``g`` normalisers, ``nb`` block-table entries and four tiles of whole
    pool blocks (64 keys, or one block when ``bs`` is larger), in the pool
    dtype with 16 B of row padding (``vec``) or in float32 with an odd row
    stride."""
    def a16(n):
        return -(-n // 16) * 16
    lp = -(-(nb * bs) // 32) * 32 + 4
    stage_keys = (64 // bs if bs < 64 else 1) * bs
    ld, elt = (hd + 16 // kv_bytes, kv_bytes) if vec else (hd | 1, 4)
    tiles = a16(a16(4 * g * hd) + 4 * g * lp + 4 * g + 4 * nb)
    return tiles + 4 * a16(stage_keys * ld * elt)


def paged_decode_attention_cuda(q, pool_k, pool_v, block_tables, pos, *, window=0):
    """Launch K2: q (B, H, hd); pools (n_blocks, bs, KV, hd); block_tables
    (B, nb) int32; pos (B,) int32 -> (B, H, hd) in the pool dtype."""
    need = _check_pools("paged_decode_attention_cuda", q, pool_k, pool_v)
    need(q.dim() == 3, "q must be (B, H, hd)")
    b, h, hd = q.shape
    for name, t in (("block_tables", block_tables), ("pos", pos)):
        need(t.is_cuda and t.device == q.device, f"{name} must be on q's device")
        need(t.dtype == torch.int32 and t.is_contiguous(), f"{name} must be contiguous int32")
    need(block_tables.dim() == 2 and block_tables.shape[0] == b, "block_tables must be (B, nb)")
    need(tuple(pos.shape) == (b,), "pos must be (B,)")
    _, bs, kv, _ = pool_k.shape
    nb = block_tables.shape[1]
    need(hd <= 256, f"head_dim {hd} over 256 (one thread per dim in the P·V chains)")
    vec = hd in (32, 64, 128) and pool_k.data_ptr() % 16 == 0 and pool_v.data_ptr() % 16 == 0
    smem = decode_smem_bytes(h // kv, hd, nb, bs, vec, pool_k.element_size())
    need(smem <= _SMEM_LIMIT, f"context {nb * bs} too long: {h // kv} heads' scores and the "
         f"staged tiles take {smem} B of shared memory, over {_SMEM_LIMIT}")
    out = torch.empty((b, h, hd), dtype=pool_k.dtype, device=q.device)
    if b == 0:
        return out
    fn = _entry("paged_decode_launch")
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), int(q.dtype == torch.bfloat16), pool_k.data_ptr(),
            pool_v.data_ptr(), int(pool_k.dtype == torch.bfloat16),
            block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
            b, nb, bs, kv, h, hd, int(window), float(np.float32(hd**-0.5)),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    check(rc, "paged_decode_attention")
    decode_counter.count += 1
    return out


def paged_chunk_attention_cuda(q, pool_k, pool_v, bt_row, start, n_valid, *, window=0):
    """Launch K3: q (1, C, H, hd); pools (n_blocks, bs, KV, hd); bt_row
    (nb,) int32; start / n_valid ints -> (1, C, H, hd) in the pool dtype."""
    need = _check_pools("paged_chunk_attention_cuda", q, pool_k, pool_v)
    need(q.dim() == 4 and q.shape[0] == 1, "q must be (1, C, H, hd)")
    _, c, h, hd = q.shape
    need(bt_row.is_cuda and bt_row.device == q.device, "bt_row must be on q's device")
    need(bt_row.dtype == torch.int32 and bt_row.dim() == 1 and bt_row.is_contiguous(),
         "bt_row must be contiguous int32 (nb,)")
    _, bs, kv, _ = pool_k.shape
    nb = bt_row.shape[0]
    start, n_valid = int(start), int(n_valid)
    lim = min(max(start + n_valid - 1, 0) // bs, nb - 1)
    smem = 4 * (hd + 2 * nb * bs + 6)
    need(smem <= _SMEM_LIMIT, f"context {nb * bs} too long for the shared-memory scores")
    out = torch.empty((1, c, h, hd), dtype=pool_k.dtype, device=q.device)
    if c == 0:
        return out
    fn = _entry("paged_chunk_launch")
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), int(q.dtype == torch.bfloat16), pool_k.data_ptr(),
            pool_v.data_ptr(), int(pool_k.dtype == torch.bfloat16), bt_row.data_ptr(),
            start, lim, out.data_ptr(), c, nb, bs, kv, h, hd, int(window),
            float(np.float32(hd**-0.5)), torch.cuda.current_stream(q.device).cuda_stream,
        )
    check(rc, "paged_chunk_attention")
    chunk_counter.count += 1
    return out
