"""Attention for the paged serving paths (port of the paged parts of
``repro/models/attention.py``).

The K/V of every attention layer live in one block POOL
``(n_blocks, block_size, KV, hd)`` shared by all serving slots and
addressed through per-slot block tables.  Physical block 0 is the trash
block: unallocated table entries point at it, pad and idle writes land
in it, and every read of it is masked before the softmax.

The attention itself goes through :mod:`repro_torch.kernels.ops` — the
paged CUDA kernels on a CUDA tensor, the dense-gather plain versions
(``_paged_gather`` + ``attention_decode`` / ``attention_dense``) on the
CPU.  Where the reference returns a new pool (JAX arrays are immutable
and its serving steps donate the arena), the port writes the pool IN
PLACE with ``index_put_`` and returns the same tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as _kops
from repro_torch.kernels.paged_attention import (
    TRASH_BLOCK,
    _paged_gather,
    attention_decode,
    attention_dense,
)

from repro_torch.core.prng import split

from .common import apply_rope, dense, make_dense_params, pget, rms_norm, rope

__all__ = [
    "TRASH_BLOCK",
    "init_attn_params",
    "decode_attention_block",
    "chunk_attention_block",
    "verify_attention_block",
    "attention_decode",
    "attention_dense",
    "_paged_gather",
    "_paged_token_write",
    "_paged_multi_write",
]


def init_attn_params(key, cfg, dtype=torch.float32, device="cuda"):
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    ks = split(key, 6)
    p = {
        "q_proj": make_dense_params(ks[0], d, nh * hd, cfg.qkv_bias, dtype, device),
        "k_proj": make_dense_params(ks[1], d, nkv * hd, cfg.qkv_bias, dtype, device),
        "v_proj": make_dense_params(ks[2], d, nkv * hd, cfg.qkv_bias, dtype, device),
        "o_proj": make_dense_params(ks[3], nh * hd, d, False, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((hd,), dtype=dtype, device=device)}
        p["k_norm"] = {"scale": torch.ones((hd,), dtype=dtype, device=device)}
    return p


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _paged_token_write(pool, block_tables, pos, val, active):
    """Write one token's K or V per slot into the pool at logical ``pos``
    (in place).  val: (B, KV, hd) in the pool dtype.  Rows with
    ``active`` False go to the trash block, so an idle lane whose stale
    table aliases re-allocated blocks never mutates live KV."""
    bsz = pool.shape[1]
    nb = block_tables.shape[1]
    idx = torch.clamp(pos // bsz, max=nb - 1).long()[:, None]
    blk = torch.gather(block_tables, 1, idx)[:, 0]
    if active is not None:
        blk = torch.where(active, blk, torch.full_like(blk, TRASH_BLOCK))
    pool[blk.long(), (pos % bsz).long()] = val
    return pool


def decode_attention_block(
    p, x1, cfg, *, policy, rng, cache_k, cache_v, pos, name, prepared=None,
    active=None, block_tables=None, kernels=True,
):
    """One-token attention block against the paged pool.

    x1: (B, d); pos: (B,) index of the new token; cache_k/v are the
    layer's pools and ``block_tables`` (B, nb) maps slots to blocks.  The
    token's K/V are written first (inactive rows to the trash block),
    then the query attends over the slot's prefix.  Returns
    (y, cache_k, cache_v) with the pools updated in place.
    """
    if block_tables is None:
        raise NotImplementedError("repro_torch serves the paged KV cache only")
    b, d = x1.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(policy=policy, rng=rng, kernels=kernels)
    q = dense(p["q_proj"], x1, name=f"{name}.q", prepared=pget(prepared, "q_proj"), **kw)
    q = q.reshape(b, nh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"])
    k1 = dense(p["k_proj"], x1, name=f"{name}.k", prepared=pget(prepared, "k_proj"), **kw)
    v1 = dense(p["v_proj"], x1, name=f"{name}.v", prepared=pget(prepared, "v_proj"), **kw)
    k1 = k1.reshape(b, nkv, hd)
    v1 = v1.reshape(b, nkv, hd)
    if cfg.qk_norm:
        k1 = rms_norm(k1, p["k_norm"]["scale"])
    if cfg.rope_theta > 0:
        cos, sin = rope(pos, hd, cfg.rope_theta)  # (B, half)
        q = apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
        k1 = apply_rope(k1[:, None], cos[:, None], sin[:, None])[:, 0]
    _paged_token_write(cache_k, block_tables, pos, k1.to(cache_k.dtype), active)
    _paged_token_write(cache_v, block_tables, pos, v1.to(cache_v.dtype), active)
    out = _kops.paged_decode_attention(
        q, cache_k, cache_v, block_tables, pos, window=cfg.swa_window, kernels=kernels,
    )
    y = dense(p["o_proj"], out.reshape(b, nh * hd), name=f"{name}.o",
              prepared=pget(prepared, "o_proj"), **kw)
    return y, cache_k, cache_v


def chunk_attention_block(
    p, x, cfg, *, policy, rng, pool_k, pool_v, bt_row, start, n_valid,
    positions, name, prepared=None, kernels=True,
):
    """Attention block for one CHUNK of a prompt against the paged pool
    (chunked prefill).  x: (1, C, d) right-padded past ``n_valid``;
    ``start``: logical position of the chunk's first token; ``bt_row``:
    (nb,) this slot's block table.  The chunk's K/V are written into the
    slot's blocks first (pad tokens to the trash block), then the queries
    attend over the prefix plus this chunk under the causal mask.
    Returns (y, pool_k, pool_v) with the pools updated in place."""
    b, c, d = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(policy=policy, rng=rng, kernels=kernels)
    q = dense(p["q_proj"], x, name=f"{name}.q", prepared=pget(prepared, "q_proj"), **kw)
    k = dense(p["k_proj"], x, name=f"{name}.k", prepared=pget(prepared, "k_proj"), **kw)
    v = dense(p["v_proj"], x, name=f"{name}.v", prepared=pget(prepared, "v_proj"), **kw)
    q = _split_heads(q, nh, hd)
    k = _split_heads(k, nkv, hd)
    v = _split_heads(v, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"])
        k = rms_norm(k, p["k_norm"]["scale"])
    if cfg.rope_theta > 0:
        cos, sin = rope(positions, hd, cfg.rope_theta)  # (1, C, half)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    bsz = pool_k.shape[1]
    ar = torch.arange(c, device=x.device)
    lp = start + ar
    blk = bt_row[torch.clamp(lp // bsz, 0, bt_row.shape[0] - 1)]
    blk = torch.where(ar < n_valid, blk, torch.full_like(blk, TRASH_BLOCK)).long()
    off = lp % bsz
    pool_k[blk, off] = k[0].to(pool_k.dtype)
    pool_v[blk, off] = v[0].to(pool_v.dtype)
    out = _kops.paged_chunk_attention(
        q, pool_k, pool_v, bt_row, start, n_valid, window=cfg.swa_window, kernels=kernels,
    )
    y = dense(p["o_proj"], out.reshape(b, c, nh * hd), name=f"{name}.o",
              prepared=pget(prepared, "o_proj"), **kw)
    return y, pool_k, pool_v


def _paged_multi_write(pool, block_tables, pos, vals, active):
    """Write C consecutive tokens' K or V per slot into the pool (in
    place): vals (B, C, KV, hd) in the pool dtype, token ``c`` of slot
    ``b`` at logical position ``pos[b] + c``.  Rows with ``active``
    False and positions past the slot's table go to the trash block, so
    a verify chunk only writes blocks its slot owns, at positions from
    its own frontier on."""
    c = vals.shape[1]
    bsz = pool.shape[1]
    nb = block_tables.shape[1]
    lp = pos[:, None] + torch.arange(c, device=pos.device, dtype=pos.dtype)[None]
    blk = torch.gather(block_tables, 1, torch.clamp(lp // bsz, 0, nb - 1).long())
    ok = lp < nb * bsz
    if active is not None:
        ok = ok & active[:, None]
    blk = torch.where(ok, blk, torch.full_like(blk, TRASH_BLOCK))
    pool[blk.long(), (lp % bsz).long()] = vals
    return pool


def verify_attention_block(
    p, x, cfg, *, policy, rng, pool_k, pool_v, block_tables, pos, name,
    prepared=None, active=None, kernels=True,
):
    """Attention block of one SPECULATIVE VERIFY chunk against the paged
    pool.  x: (B, C, d) — per slot the last emitted token and C-1 draft
    proposals at positions ``pos[b] .. pos[b]+C-1``.  All C positions'
    K/V are written first (inactive lanes and positions past the table
    to the trash block); then row (b, c) attends through the paged
    decode attention (K2 on the card) as a query of its own at position
    ``pos[b] + c`` in slot b's table.  Every row is therefore, by
    construction, the decode a plain step at that position runs: the
    same projections (row-independent), RoPE positions and K2 chains.
    A row past the table's capacity reads the table's last position;
    its logits are never used.  Returns (y, pool_k, pool_v), the pools
    updated in place."""
    b, c, d = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(policy=policy, rng=rng, kernels=kernels)
    q = dense(p["q_proj"], x, name=f"{name}.q", prepared=pget(prepared, "q_proj"), **kw)
    k = dense(p["k_proj"], x, name=f"{name}.k", prepared=pget(prepared, "k_proj"), **kw)
    v = dense(p["v_proj"], x, name=f"{name}.v", prepared=pget(prepared, "v_proj"), **kw)
    q = _split_heads(q, nh, hd)
    k = _split_heads(k, nkv, hd)
    v = _split_heads(v, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"])
        k = rms_norm(k, p["k_norm"]["scale"])
    positions = pos[:, None] + torch.arange(c, device=pos.device, dtype=pos.dtype)[None]
    if cfg.rope_theta > 0:
        cos, sin = rope(positions, hd, cfg.rope_theta)  # (B, C, half)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    _paged_multi_write(pool_k, block_tables, pos, k.to(pool_k.dtype), active)
    _paged_multi_write(pool_v, block_tables, pos, v.to(pool_v.dtype), active)
    cap = block_tables.shape[1] * pool_k.shape[1]
    rows_pos = torch.clamp(positions, max=cap - 1).reshape(-1).to(torch.int32).contiguous()
    rows_bt = torch.repeat_interleave(block_tables, c, dim=0).contiguous()
    out = _kops.paged_decode_attention(
        q.reshape(b * c, nh, hd), pool_k, pool_v, rows_bt, rows_pos,
        window=cfg.swa_window, kernels=kernels,
    )
    y = dense(p["o_proj"], out.reshape(b, c, nh * hd), name=f"{name}.o",
              prepared=pget(prepared, "o_proj"), **kw)
    return y, pool_k, pool_v
