"""Model entry points of the serving slice: init, the paged KV cache, the
decode step and the chunked-prefill step (port of the dense-decoder parts
of ``repro/models/model.py``).

The reference scans each segment of identical layers with ``lax.scan``;
here that is a Python loop over the stacked layers.  The ``lax.cond``
that skips the vocab head on non-final prefill chunks is a host ``if``.
The cache is updated in place (the reference donates it).  The layer
key chain is the reference's: ``fold_in(fold_in(rng, segment), layer)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.layers import DIGITAL, MemPolicy
from repro_torch.core.prng import PRNGKey, fold_in, split

from .common import (
    dense,
    layer_slice,
    make_dense_params,
    make_norm_params,
    norm,
    pget,
    stack_layers,
    uniform_init,
)
from .config import ArchConfig
from .transformer import block_chunk, block_decode, block_verify, init_block_params

__all__ = [
    "segments",
    "init_params",
    "init_paged_cache",
    "copy_paged_block",
    "decode_step",
    "decode_verify_step",
    "prefill_chunk_step",
]


def segments(cfg: ArchConfig) -> list[tuple[int, int, int]]:
    """[(start_layer, n_steps, template_layer_idx), ...] — contiguous runs
    of structurally identical layers."""
    sigs = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    segs, start = [], 0
    for i in range(1, cfg.n_layers + 1):
        if i == cfg.n_layers or sigs[i] != sigs[start]:
            segs.append((start, i - start, start))
            start = i
    return segs


def init_params(cfg: ArchConfig, key=0, dtype=torch.float32, device="cuda"):
    """Random parameters in the reference's layout (per-segment leaves
    stacked over layers), bit for bit the reference's ``init_params``:
    the same threefry key tree (``split(key, 8)``, then per segment
    ``split(fold_in(keys[2], si), steps)``) and the same uniform draws,
    made on ``device``.  ``key`` is a :mod:`~repro_torch.core.prng` key
    or a seed that stands for ``PRNGKey(seed)``."""
    if isinstance(key, int):
        key = PRNGKey(key)
    keys = split(key, 8)
    d, v = cfg.d_model, cfg.vocab
    params = {
        "embed": {"w": uniform_init(keys[0], (v, d), scale=0.02, dtype=dtype,
                                    device=device)},
        "final_norm": make_norm_params(d, cfg.norm, dtype, device),
        "lm_head": make_dense_params(keys[1], d, v, False, dtype, device),
        "blocks": {},
    }
    for si, (start, steps, tmpl) in enumerate(segments(cfg)):
        seg_keys = split(fold_in(keys[2], si), steps)
        params["blocks"][f"seg{si}"] = stack_layers(
            lambda i: init_block_params(seg_keys[i], cfg, tmpl, dtype, device),
            steps,
        )
    return params


def init_paged_cache(
    cfg: ArchConfig,
    slots: int,
    max_len: int,
    block_size: int,
    n_blocks: int,
    dtype=torch.bfloat16,
    device="cuda",
):
    """Allocate the PAGED serving cache: per attention layer one block
    pool ``(n_blocks, block_size, KV, hd)`` shared by all slots, per-slot
    ``block_tables`` ``(slots, ceil(max_len/block_size))`` (int32) and
    ``pos`` (int32).  Block 0 is the reserved trash block."""
    kinds = {cfg.layer_kind(i)[0] for i in range(cfg.n_layers)}
    if kinds != {"attn"} or cfg.encoder is not None:
        raise NotImplementedError(
            "paged KV cache requires homogeneous all-attention layers"
        )
    if n_blocks < 2:
        raise ValueError("n_blocks must be >= 2 (block 0 is the trash block)")
    nb_per_slot = -(-max_len // block_size)
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    cache = {
        "pos": torch.zeros((slots,), dtype=torch.int32, device=device),
        "block_tables": torch.zeros((slots, nb_per_slot), dtype=torch.int32, device=device),
        "blocks": {},
    }
    for si, (start, steps, tmpl) in enumerate(segments(cfg)):
        shape = (steps, n_blocks, block_size, kvh, hd)
        cache["blocks"][f"seg{si}"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
    return cache


def copy_paged_block(cache: dict, src: int, dst: int) -> dict:
    """Clone physical block ``src``'s K/V rows into block ``dst`` in every
    layer's pool (the copy-on-write step of prefix sharing), in place."""
    for seg in cache["blocks"].values():
        for pool in seg.values():
            pool[:, dst] = pool[:, src]
    return cache


def _layers(params, cfg, cache, programmed, rng):
    """Yield ``(params, programmed, kv_state, rng, template_idx)`` of
    every layer in order (the reference's scan over stacked segments);
    ``kv_state`` holds views of the layer's pools."""
    prog_blocks = pget(programmed, "blocks")
    for si, (start, steps, tmpl) in enumerate(segments(cfg)):
        seg_p = params["blocks"][f"seg{si}"]
        seg_c = cache["blocks"][f"seg{si}"]
        prog_seg = pget(prog_blocks, f"seg{si}")
        rng_s = fold_in(rng, si)
        for idx in range(steps):
            prog_l = None if prog_seg is None else layer_slice(prog_seg, idx)
            state = {"k": seg_c["k"][idx], "v": seg_c["v"][idx]}
            yield layer_slice(seg_p, idx), prog_l, state, fold_in(rng_s, idx), tmpl


def decode_step(
    params,
    cfg: ArchConfig,
    cache: dict,
    tokens: torch.Tensor,  # (B,) next token ids
    *,
    policy: MemPolicy = DIGITAL,
    rng=None,
    compute_dtype=torch.bfloat16,
    programmed=None,
    active: torch.Tensor | None = None,
    kernels: bool = True,
):
    """One serving step: consume ``tokens``, return (logits (B, V) f32,
    cache).  Rows where ``active`` is False neither advance ``pos`` nor
    touch live KV.  The paged cache is updated in place."""
    rng = PRNGKey(0) if rng is None else rng
    block_tables = cache.get("block_tables")
    if block_tables is None:
        raise NotImplementedError("repro_torch serves the paged KV cache only")
    x1 = params["embed"]["w"].to(compute_dtype)[tokens.long()]
    pos = cache["pos"]
    inc = 1 if active is None else active.to(torch.int32)
    for p_l, prog_l, state, rng_l, tmpl in _layers(params, cfg, cache, programmed, rng):
        x1, _ = block_decode(
            p_l, x1, cfg, tmpl, policy=policy, rng=rng_l, pos=pos, state=state,
            prepared=prog_l, active=active, block_tables=block_tables,
            kernels=kernels,
        )
    x1 = norm(x1, params["final_norm"], cfg.norm)
    logits = dense(
        params["lm_head"], x1, name="lm_head", policy=policy, rng=rng,
        prepared=pget(programmed, "lm_head"), kernels=kernels,
    ).to(torch.float32)
    cache["pos"] = pos + inc
    return logits, cache


def prefill_chunk_step(
    params,
    cfg: ArchConfig,
    cache: dict,
    tokens: torch.Tensor,  # (C,) one chunk of one prompt, right-padded
    slot: int,
    start: int,
    n_valid: int,
    final: bool | None = None,
    *,
    policy: MemPolicy = DIGITAL,
    rng=None,
    compute_dtype=torch.bfloat16,
    programmed=None,
    kernels: bool = True,
):
    """One CHUNKED-PREFILL step against the paged cache: run ``tokens``
    through every layer, writing K/V into slot ``slot``'s blocks at
    ``start .. start+n_valid-1``, and return ``(logits (1, V), cache)``
    at the chunk's last real token.  When ``final`` is False the final
    norm and the vocab head are skipped and zeros are returned.
    ``cache["pos"][slot]`` becomes ``start + n_valid``."""
    rng = PRNGKey(0) if rng is None else rng
    c = tokens.shape[0]
    x = params["embed"]["w"].to(compute_dtype)[tokens.long()][None]  # (1, C, d)
    positions = (start + torch.arange(c, device=tokens.device))[None]
    bt_row = cache["block_tables"][slot]
    for p_l, prog_l, state, rng_l, tmpl in _layers(params, cfg, cache, programmed, rng):
        x, _ = block_chunk(
            p_l, x, cfg, tmpl, policy=policy, rng=rng_l, state=state,
            bt_row=bt_row, start=start, n_valid=n_valid, positions=positions,
            prepared=prog_l, kernels=kernels,
        )
    pos = cache["pos"].clone()
    pos[slot] = start + n_valid
    cache["pos"] = pos
    if final is not None and not final:
        return torch.zeros((1, cfg.vocab), dtype=torch.float32, device=x.device), cache
    last = x[:, n_valid - 1]  # (1, d) pre-norm hidden of the last real token
    h = norm(last, params["final_norm"], cfg.norm)
    logits = dense(
        params["lm_head"], h, name="lm_head", policy=policy, rng=rng,
        prepared=pget(programmed, "lm_head"), kernels=kernels,
    ).to(torch.float32)
    return logits, cache


def decode_verify_step(
    params,
    cfg: ArchConfig,
    cache: dict,
    tokens: torch.Tensor,  # (B, C) last emitted token + C-1 draft proposals
    *,
    policy: MemPolicy = DIGITAL,
    rng=None,
    compute_dtype=torch.bfloat16,
    programmed=None,
    active: torch.Tensor | None = None,
    kernels: bool = True,
):
    """The batched multi-token VERIFY forward of speculative decoding:
    every slot's C candidate tokens through the layer stack at once;
    returns per-position logits (B, C, V) float32 and the cache with all
    C positions' K/V written but ``pos`` NOT advanced (the caller commits
    the accepted frontier).  Row (b, c) is the logits a decode step at
    ``pos[b] + c`` gives on the same accepted prefix."""
    rng = PRNGKey(0) if rng is None else rng
    block_tables = cache.get("block_tables")
    if block_tables is None:
        raise NotImplementedError("decode_verify_step requires the paged cache")
    x = params["embed"]["w"].to(compute_dtype)[tokens.long()]  # (B, C, d)
    pos = cache["pos"]
    for p_l, prog_l, state, rng_l, tmpl in _layers(params, cfg, cache, programmed, rng):
        x, _ = block_verify(
            p_l, x, cfg, tmpl, policy=policy, rng=rng_l, pos=pos, state=state,
            block_tables=block_tables, prepared=prog_l, active=active, kernels=kernels,
        )
    x = norm(x, params["final_norm"], cfg.norm)
    logits = dense(
        params["lm_head"], x, name="lm_head", policy=policy, rng=rng,
        prepared=pget(programmed, "lm_head"), kernels=kernels,
    ).to(torch.float32)
    return logits, cache
