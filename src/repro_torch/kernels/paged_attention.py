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
each step rounded once as ``fmaf`` rounds (``core.xmath.fma``; rounding
the float64 sum to float32 instead goes wrong about once in 2**29
steps, which at a 32K context is about once a call), the softmax sum
runs over the keys in order, and masked keys enter as exact zeros.  Kernel and plain version therefore agree to the bit on
the card, which the served path needs: the faithful engine quantises
every activation, so a last-bit difference in attention can move a
quantiser code and grow through 24 layers.

Kernels (``csrc/paged_attention.cu``) walk the block table themselves
and read only the keys the mask admits, so the trash block and unmapped
tail are never read, and they keep the exact two-pass softmax of the
reference (no online rescaling). One design serves both: a block of 256
threads computes the whole GQA group (G = H / KV query heads) of one KV
head for one query row -- a slot's token (K2, grid ``(B, KV)``) or one
row of the chunk (K3, grid ``(C, KV)``) -- so each K / V row is read
once per group and row. K and then V stream through shared memory in
tiles of whole pool blocks (``cp.async``, a ring of four tiles, three in
flight), one chain per (head, key) for the scores, one per head for the
softmax sum, one per (head, dim) for P·V. Bound on an H100: the bytes of
the live K/V prefix (3.35 TB/s); at serving sizes that is well under a
microsecond, and these calls are bound by the latency of their in-order
chains (PERF.md).

Shared memory holds the group's q, a ring of four K / V tiles, and a
region for scores and live table entries sized per launch by the table
a block walks (:func:`group_layout`: K2 the table width, K3 blocks
``0..lim``): every score of that table where it fits, else all that the
tiles leave of the 227 KB a block may use, so short tables keep a small
footprint (two blocks an SM at the served shapes).  Each block decides
on the device, from its own live length, how to use the region: where
its ``G x L`` scores and live table entries fit (L up to 5,668 keys with
qwen2-0.5b's heads, G = 7, head_dim 64, float32, block size 16; 6,852 in
bf16), it keeps every score; past that it keeps one tile of scores and
recomputes them with the same chains in three passes (max, sum,
weights), which gives the same bits. So neither kernel caps the context:
what remains is head_dim <= 256 (one thread per dim in the P·V chains),
a layout whose four tiles fit one block (where the tiles are float32
rows of odd stride, i.e. head_dim other than 32, 64 and 128: head_dim up
to 219 with G = 7), and a table of at most :func:`max_table_blocks`
entries (39,764 blocks, 636,224 positions, at qwen2-0.5b's heads in
float32); the wrappers raise past any of them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.xmath import fma

from .build import LaunchCounter, check, library

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
decode_counter = LaunchCounter("paged_decode_attention")
chunk_counter = LaunchCounter("paged_chunk_attention")


def _dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_d a[..., d] * b[..., d]`` over the last axis as the kernels
    compute it: one float32 fused multiply-add chain over d in order,
    each step rounded once."""
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


MAX_SMEM = 232_448  # what one block may use on an H100
THREADS = 256  # per block; one thread per dim in the P·V chains
STAGE_KEYS = 64  # keys per staged tile, in whole pool blocks
NBUF = 4  # staged tiles


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def score_stride(n: int) -> int:
    """Row stride of a score row of ``n`` keys: at least ``n``, = 4 mod
    32 (``score_stride`` in the CUDA source)."""
    return (n + 27) // 32 * 32 + 4


class GroupLayout(NamedTuple):
    """Shared memory of one K2 / K3 block (``group_layout`` in the CUDA
    source): the group's q in float32, G normalisers and maxima, then the
    region (scores and live block-table entries), then ``NBUF`` tiles of
    ``stage_keys`` pool rows with stride ``ld`` (the pool dtype with 16 B
    of row padding on vector tiles, else float32 with an odd stride).
    ``room`` is what the tiles leave of ``MAX_SMEM``.  The region holds
    every score row of the table a block walks (``nb`` entries) and the
    entries where they fit in ``room``, else it takes ``room``; ``ok`` is
    False where ``room`` cannot hold one tile's scores and the entries."""

    stage_keys: int
    ld: int
    tkp: int
    tile_bytes: int
    tile_sc_bytes: int
    region: int
    room: int
    region_bytes: int
    total: int
    ok: bool


def group_layout(g: int, hd: int, bs: int, vec: bool, kv_bytes: int, nb: int) -> GroupLayout:
    stage_keys = (STAGE_KEYS // bs if bs < STAGE_KEYS else 1) * bs
    ld, elt = (hd + 16 // kv_bytes, kv_bytes) if vec else (hd | 1, 4)
    tkp = score_stride(stage_keys + 3)
    tile_bytes = _a16(stage_keys * ld * elt)
    tile_sc_bytes = _a16(4 * g * tkp)
    region = _a16(_a16(4 * g * hd) + 8 * g)
    fixed = region + NBUF * tile_bytes
    room = max(MAX_SMEM - fixed, 0) // 16 * 16
    entries = _a16(4 * nb)
    least = tile_sc_bytes + entries
    ok = least <= room
    region_bytes = max(least, min(_a16(4 * g * score_stride(nb * bs)) + entries, room)) if ok else 0
    return GroupLayout(stage_keys, ld, tkp, tile_bytes, tile_sc_bytes, region, room,
                       region_bytes, region + region_bytes + NBUF * tile_bytes, ok)


def _vec(hd: int, pool_k: torch.Tensor, pool_v: torch.Tensor) -> bool:
    """Vector tiles: head_dim 32 / 64 / 128 on 16-B aligned pools."""
    return hd in (32, 64, 128) and pool_k.data_ptr() % 16 == 0 and pool_v.data_ptr() % 16 == 0


def max_table_blocks(lay: GroupLayout) -> int:
    """Widest block table a block can stage beside one tile's scores."""
    return max(0, (lay.room - lay.tile_sc_bytes) // 4)


def _check_layout(need, g, hd, bs, nb, vec, kv_bytes):
    need(hd <= THREADS, f"head_dim {hd} over {THREADS} (one thread per dim in the P·V chains)")
    lay = group_layout(g, hd, bs, vec, kv_bytes, 1)
    need(lay.ok, f"{g} query heads of head_dim {hd} with block size {bs} do not fit one "
         f"block's shared memory")
    need(nb <= max_table_blocks(lay),
         f"block table of {nb} entries over the {max_table_blocks(lay)} a block can stage")


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
    _check_layout(need, h // kv, hd, bs, nb, _vec(hd, pool_k, pool_v), pool_k.element_size())
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
    _check_layout(need, h // kv, hd, bs, nb, _vec(hd, pool_k, pool_v), pool_k.element_size())
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
