"""Attention: GQA + RoPE + qk-norm + sliding window over a dense or a
paged KV cache (port of ``repro/models/attention.py``).

Dense paths (``forward`` / ``greedy_generate``), plain PyTorch as the
reference's are plain jnp, outside any kernel:

* :func:`attention_dense` — the full score matrix (up to 1,024 keys);
* :func:`attention_chunked` — online softmax over 512-key chunks, with
  the triangular causal schedule (``"tri"``) of the prefill;
* :func:`attention_decode` — one new token against a ``(B, S, KV, hd)``
  cache row per slot, operands in the cache dtype, float32 scores.

Their products are ``torch.einsum`` in the reference's dtypes; the
softmax ``exp(s - max) / sum`` takes XLA's float32 ``exp`` and its
summation order (:mod:`repro_torch.core.xmath`), so only a product's
summation order can part from the reference, which the tests bound.

Paged paths (the ``ServeLoop``): the K/V of every attention layer live in
one block POOL ``(n_blocks, block_size, KV, hd)`` shared by all serving
slots and addressed through per-slot block tables.  Physical block 0 is
the trash block: unallocated table entries point at it, pad and idle
writes land in it, and every read of it is masked before the softmax.
Their attention goes through :mod:`repro_torch.kernels.ops` — the paged
CUDA kernels (K2, K3) on a CUDA tensor, the dense-gather plain versions
on the CPU.

Where the reference returns a new cache (JAX arrays are immutable and
its serving steps donate the arena), the port writes the cache IN PLACE
with ``index_put_`` and returns the same tensor.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import xmath
from repro_torch.kernels import ops as _kops
from repro_torch.kernels.paged_attention import TRASH_BLOCK, _paged_gather

from repro_torch.core.prng import split

from .common import apply_rope, dense, make_dense_params, pget, rms_norm, rope

__all__ = [
    "TRASH_BLOCK",
    "init_attn_params",
    "attention_block",
    "decode_attention_block",
    "chunk_attention_block",
    "verify_attention_block",
    "init_kv_cache",
    "attention_dense",
    "attention_chunked",
    "attention_decode",
    "_paged_gather",
    "_paged_token_write",
    "_paged_multi_write",
]

_NEG = -1e30


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


def _scale(dh: int) -> float:
    """``dh**-0.5`` as the float32 the reference multiplies by."""
    return float(np.float32(dh**-0.5))


def _gqa_scores(q, k):
    """q (B, Sq, H, dh), k (B, Skv, KV, dh) -> scores (B, KV, H/KV, Sq, Skv)
    in the operands' dtype."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    return torch.einsum("bqkgd,bskd->bkgqs", q.reshape(b, sq, kv, h // kv, dh), k)


def _gqa_out(probs, v):
    """probs (B, KV, G, Sq, Skv), v (B, Skv, KV, dh) -> (B, Sq, KV*G, dh)."""
    b, kv, g, sq, _ = probs.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, kv * g, out.shape[-1])


def _causal_mask(sq, skv, q_off, window, device):
    qi = q_off + torch.arange(sq, device=device)[:, None]
    ki = torch.arange(skv, device=device)[None, :]
    m = ki <= qi
    if window > 0:
        m &= ki > qi - window
    return m


def _softmax(s):
    """``jax.nn.softmax`` over the last axis: ``exp(s - max) / sum``."""
    e = xmath.exp(s - s.amax(dim=-1, keepdim=True))
    return e / xmath.sum_last(e)[..., None]


def attention_dense(q, k, v, *, q_off=0, window=0, causal=True):
    """Full score-matrix GQA attention: q (B, Sq, H, dh), k / v (B, Skv,
    KV, dh) -> (B, Sq, H, dh) in v's dtype.  Scores in the q·k dtype,
    then float32 times ``dh**-0.5``; the probabilities are cast to v's
    dtype before P·V."""
    s = _gqa_scores(q, k).to(torch.float32) * _scale(q.shape[-1])
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_off, window, q.device)
        s = torch.where(mask[None, None, None], s, _NEG)
    return _gqa_out(_softmax(s).to(v.dtype), v)


def attention_chunked(q, k, v, *, window=0, causal=True, q_chunk=0, kv_chunk=512,
                      schedule="masked"):
    """Online-softmax attention, scanning ``kv_chunk``-key chunks per
    ``q_chunk``-query chunk (the reference's ``lax.scan`` as a loop).
    ``q_chunk=0`` adapts the chunk so there are at most 32 query chunks.
    ``schedule="tri"`` (causal self-attention, at most 32 query chunks)
    lets query chunk ``i`` scan key chunks ``0..i`` only; otherwise every
    key chunk is scanned under the mask.  Running max, sum and
    accumulator in float32; output in v's dtype."""
    b, sq, h, dh = q.shape
    if q_chunk == 0:
        q_chunk = max(512, -(-sq // 32))
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = _scale(dh)
    nq, nk = -(-sq // q_chunk), -(-skv // kv_chunk)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * q_chunk - sq))
    kb = F.pad(k, (0, 0, 0, 0, 0, nk * kv_chunk - skv)).reshape(b, nk, kv_chunk, kvh, dh)
    vb = F.pad(v, (0, 0, 0, 0, 0, nk * kv_chunk - skv)).reshape(b, nk, kv_chunk, kvh, dh)
    tri = schedule == "tri" and causal and sq == skv and nq <= 32
    dev = q.device
    outs = []
    for qi in range(nq):
        qg = qp[:, qi * q_chunk:(qi + 1) * q_chunk].reshape(b, q_chunk, kvh, g, dh)
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)[:, None]
        m_run = torch.full((b, kvh, g, q_chunk), _NEG, dtype=torch.float32, device=dev)
        l_run = torch.zeros((b, kvh, g, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, g, q_chunk, dh), dtype=torch.float32, device=dev)
        for ki in range(min(qi + 1, nk) if tri else nk):
            s = torch.einsum("bqkgd,bskd->bkgqs", qg, kb[:, ki]).to(torch.float32) * scale
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)[None, :]
            mask = k_pos < skv
            if causal:
                mask = mask & (k_pos <= q_pos)
            if window > 0:
                mask = mask & (k_pos > q_pos - window)
            s = torch.where(mask[None, None, None], s, _NEG)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            alpha = xmath.exp(m_run - m_new)
            p = xmath.exp(s - m_new[..., None])
            l_run = l_run * alpha + xmath.sum_last(p)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vb[:, ki].to(torch.float32))
            m_run = m_new
        out = acc / torch.clamp_min(l_run, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, dh))
    return torch.cat(outs, dim=1)[:, :sq].to(v.dtype)


def attention_decode(q1, k_cache, v_cache, pos, *, window=0):
    """One-token attention against a dense cache: q1 (B, H, dh); caches
    (B, S, KV, dh); pos (B,) the new token's index (keys ``<= pos`` are
    valid, the cache already holds the token).  q is cast to the cache
    dtype and the scores accumulate in float32; ``p / l`` is cast to the
    value dtype before P·V.  Output (B, H, dh) in the cache dtype."""
    b, h, dh = q1.shape
    kvh = k_cache.shape[2]
    qg = q1.reshape(b, kvh, h // kvh, dh).to(k_cache.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                     k_cache.to(torch.float32)) * _scale(dh)
    ki = torch.arange(k_cache.shape[1], device=q1.device)[None, :]
    mask = ki <= pos[:, None]
    if window > 0:
        mask &= ki > pos[:, None] - window
    s = torch.where(mask[:, None, None, :], s, _NEG)
    w = _softmax(s).to(v_cache.dtype)
    return torch.einsum("bkgs,bskd->bkgd", w, v_cache).reshape(b, h, dh)


def init_kv_cache(cfg, batch, max_len, dtype=torch.bfloat16, layers=None, device="cuda"):
    """Zero dense K / V caches ``(layers, batch, max_len, KV, hd)``."""
    n = layers if layers is not None else cfg.n_layers
    shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_block(p, x, cfg, *, policy, rng, positions, name, dense_threshold=1024,
                    attn_schedule="masked", prepared=None, kernels=True):
    """Causal self-attention block on a sequence (train / prefill): x (B,
    S, d) -> (y, (k, v)), the roped K / V for the serving cache.  Up to
    ``dense_threshold`` keys the score matrix is formed whole, above it
    :func:`attention_chunked` runs with ``attn_schedule``.  (The
    reference's cross-attention input ``kv_in`` and non-causal encoder
    blocks belong to the encoder-decoder family, not ported.)"""
    b, s, d = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(policy=policy, rng=rng, kernels=kernels)
    q = dense(p["q_proj"], x, name=f"{name}.q", prepared=pget(prepared, "q_proj"), **kw)
    k = dense(p["k_proj"], x, name=f"{name}.k", prepared=pget(prepared, "k_proj"), **kw)
    v = dense(p["v_proj"], x, name=f"{name}.v", prepared=pget(prepared, "v_proj"), **kw)
    q, k, v = _split_heads(q, nh, hd), _split_heads(k, nkv, hd), _split_heads(v, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"])
        k = rms_norm(k, p["k_norm"]["scale"])
    if cfg.rope_theta > 0:
        cos, sin = rope(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if s <= dense_threshold:
        out = attention_dense(q, k, v, window=cfg.swa_window)
    else:
        out = attention_chunked(q, k, v, window=cfg.swa_window, schedule=attn_schedule)
    y = dense(p["o_proj"], out.reshape(b, s, nh * hd), name=f"{name}.o",
              prepared=pget(prepared, "o_proj"), **kw)
    return y, (k, v)


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


def _dense_token_write(cache, pos, val, active):
    """Write one token's K or V per slot into a dense cache (B, S, KV,
    hd) at ``pos`` (in place; the index clamped to the row, as
    ``lax.dynamic_update_slice`` clamps it).  Rows with ``active`` False
    re-write the value stored there."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = torch.clamp(pos, max=cache.shape[1] - 1).long()
    if active is not None:
        val = torch.where(active[:, None, None], val, cache[rows, at])
    cache[rows, at] = val
    return cache


def decode_attention_block(
    p, x1, cfg, *, policy, rng, cache_k, cache_v, pos, name, prepared=None,
    active=None, block_tables=None, kernels=True,
):
    """One-token attention block against the cache, dense or paged.

    x1: (B, d); pos: (B,) index of the new token.  Dense
    (``block_tables=None``): cache_k/v are the layer's (B, S, KV, hd)
    rows; rows where ``active`` is False re-write the value already
    stored at ``pos`` (a per-row no-op), and the query attends through
    :func:`attention_decode`.  Paged: cache_k/v are the layer's pools and
    ``block_tables`` (B, nb) maps slots to blocks; inactive rows write to
    the trash block, and the query attends through K2.  The token's K/V
    are written first.  Returns (y, cache_k, cache_v), the cache updated
    in place.
    """
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
    if block_tables is None:
        _dense_token_write(cache_k, pos, k1.to(cache_k.dtype), active)
        _dense_token_write(cache_v, pos, v1.to(cache_v.dtype), active)
        out = attention_decode(q, cache_k, cache_v, pos, window=cfg.swa_window)
    else:
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
