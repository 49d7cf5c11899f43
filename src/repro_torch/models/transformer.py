"""Decoder blocks for the paged serving steps (port of the attention-layer
parts of ``repro/models/transformer.py``).

Only homogeneous all-attention decoders are ported: MoE, SSM and hybrid
layers raise ``NotImplementedError``.  Layer names (``L.attn.*``) and the
per-layer key are the reference's, so programmed-state lookup and
programming-noise keys agree with :mod:`.programmed`.
"""
from __future__ import annotations

import torch

from repro_torch.core.prng import split

from .attention import (
    chunk_attention_block,
    decode_attention_block,
    init_attn_params,
    verify_attention_block,
)
from .common import activation, dense, make_dense_params, make_norm_params, norm, pget

__all__ = ["init_block_params", "block_decode", "block_chunk", "block_verify"]


def _attn_only(cfg, layer_idx: int) -> None:
    kind, has_moe = cfg.layer_kind(layer_idx)
    if kind != "attn" or has_moe or cfg.family == "hybrid":
        raise NotImplementedError(
            "repro_torch ports homogeneous all-attention dense decoders only"
        )


def init_block_params(key, cfg, layer_idx, dtype=torch.float32, device="cuda"):
    """Params of one dense attention layer (the reference's key tree:
    ``k1, k2 = split(key)``, attention from ``k1``, the MLP from
    ``split(k2, 3)``)."""
    _attn_only(cfg, layer_idx)
    d = cfg.d_model
    k1, k2 = split(key)
    ks = split(k2, 3)
    return {
        "norm1": make_norm_params(d, cfg.norm, dtype, device),
        "norm2": make_norm_params(d, cfg.norm, dtype, device),
        "attn": init_attn_params(k1, cfg, dtype, device),
        "mlp": {
            "wi": make_dense_params(ks[0], d, cfg.d_ff, False, dtype, device),
            "wg": make_dense_params(ks[1], d, cfg.d_ff, False, dtype, device),
            "wo": make_dense_params(ks[2], cfg.d_ff, d, False, dtype, device),
        },
    }


def _ffn_forward(p, x, cfg, *, policy, rng, name, prepared=None, kernels=True):
    if "moe" in p:
        raise NotImplementedError("MoE layers are not ported to repro_torch yet")
    mlp = p["mlp"]
    prog = pget(prepared, "mlp")
    kw = dict(policy=policy, rng=rng, kernels=kernels)
    h = dense(mlp["wi"], x, name=f"{name}.mlp.wi", prepared=pget(prog, "wi"), **kw)
    g = dense(mlp["wg"], x, name=f"{name}.mlp.wg", prepared=pget(prog, "wg"), **kw)
    h = activation(g, cfg.act) * h
    return dense(mlp["wo"], h, name=f"{name}.mlp.wo", prepared=pget(prog, "wo"), **kw)


def block_decode(p, x1, cfg, template_idx, *, policy, rng, pos, state,
                 prepared=None, active=None, block_tables=None, kernels=True):
    """One attention layer of a decode step: x1 (B, d) -> (x1, state);
    the layer's KV pools in ``state`` are updated in place."""
    _attn_only(cfg, template_idx)
    name = "L.attn"
    h = norm(x1, p["norm1"], cfg.norm)
    y, ck, cv = decode_attention_block(
        p["attn"], h, cfg, policy=policy, rng=rng, cache_k=state["k"],
        cache_v=state["v"], pos=pos, name=name, prepared=pget(prepared, "attn"),
        active=active, block_tables=block_tables, kernels=kernels,
    )
    x1 = x1 + y
    h = norm(x1, p["norm2"], cfg.norm)
    x1 = x1 + _ffn_forward(
        p, h[:, None, :], cfg, policy=policy, rng=rng, name=name,
        prepared=prepared, kernels=kernels,
    )[:, 0]
    return x1, {"k": ck, "v": cv}


def block_chunk(p, x, cfg, template_idx, *, policy, rng, state, bt_row, start,
                n_valid, positions, prepared=None, kernels=True):
    """One attention layer of CHUNKED PREFILL: a prompt chunk x (1, C, d),
    its K/V written into the slot's blocks of the layer's pools."""
    _attn_only(cfg, template_idx)
    name = "L.attn"
    h = norm(x, p["norm1"], cfg.norm)
    y, pk, pv = chunk_attention_block(
        p["attn"], h, cfg, policy=policy, rng=rng, pool_k=state["k"],
        pool_v=state["v"], bt_row=bt_row, start=start, n_valid=n_valid,
        positions=positions, name=name, prepared=pget(prepared, "attn"),
        kernels=kernels,
    )
    x = x + y
    h = norm(x, p["norm2"], cfg.norm)
    x = x + _ffn_forward(
        p, h, cfg, policy=policy, rng=rng, name=name, prepared=prepared,
        kernels=kernels,
    )
    return x, {"k": pk, "v": pv}


def block_verify(p, x, cfg, template_idx, *, policy, rng, pos, state, block_tables,
                 prepared=None, active=None, kernels=True):
    """One attention layer of a SPECULATIVE VERIFY chunk: x (B, C, d), the
    layer's pools in ``state`` updated in place.  Layer names and keys
    are :func:`block_decode`'s, and the residual / FFN stack is
    row-independent, so row (b, c) is the decode at ``pos[b] + c``."""
    _attn_only(cfg, template_idx)
    name = "L.attn"
    h = norm(x, p["norm1"], cfg.norm)
    y, pk, pv = verify_attention_block(
        p["attn"], h, cfg, policy=policy, rng=rng, pool_k=state["k"], pool_v=state["v"],
        block_tables=block_tables, pos=pos, name=name, prepared=pget(prepared, "attn"),
        active=active, kernels=kernels,
    )
    x = x + y
    h = norm(x, p["norm2"], cfg.norm)
    x = x + _ffn_forward(
        p, h, cfg, policy=policy, rng=rng, name=name, prepared=prepared, kernels=kernels,
    )
    return x, {"k": pk, "v": pv}
