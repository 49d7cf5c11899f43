"""Decoder blocks (port of the homogeneous-stack parts of
``repro/models/transformer.py``): a layer on a whole sequence
(:func:`block_forward`, train / prefill), one decode step against a
dense or a paged cache (:func:`block_decode`), a chunk of chunked
prefill and a speculative verify chunk against the paged pool.

Two layer kinds are ported: the dense attention layer and the RWKV6
time-mix layer of the ``ssm`` family (its recurrent state in place of
K / V; chunked prefill and speculative verify refuse it, as the
reference's do).  An attention layer's FFN is the gated MLP or, in the
``dense`` / ``moe`` families' MoE layers, the token-choice top-k MoE
(:mod:`.moe`) on every block path.  Mamba and hybrid layers raise
``NotImplementedError``.  Layer names (``L.attn.*``, ``L.ssm.*``) and the
per-layer key are the reference's, so programmed-state lookup and
programming-noise keys agree with :mod:`.programmed`.
"""
from __future__ import annotations

import torch

from repro_torch.core.prng import split

from .attention import (
    attention_block,
    chunk_attention_block,
    decode_attention_block,
    init_attn_params,
    verify_attention_block,
)
from .common import activation, dense, make_dense_params, make_norm_params, norm, pget
from .moe import init_moe_params, moe_block
from .ssm import init_rwkv6_params, rwkv6_block, rwkv6_decode

__all__ = ["init_block_params", "block_forward", "block_decode", "block_chunk", "block_verify",
           "layer_kind"]


def layer_kind(cfg, layer_idx: int) -> str:
    """The ported kind of a layer, ``"attn"`` or ``"ssm"`` (RWKV6); raises
    for the kinds not ported (hybrid groups, Mamba)."""
    kind, _ = cfg.layer_kind(layer_idx)
    if cfg.family == "hybrid":
        raise NotImplementedError("hybrid layers are not ported to repro_torch yet")
    if kind == "ssm" and cfg.ssm.kind != "rwkv6":
        raise NotImplementedError(f"{cfg.ssm.kind} layers are not ported to repro_torch yet")
    return kind


def _attn_only(cfg, layer_idx: int, what: str) -> None:
    """Chunked prefill and speculative verify: attention layers only (a
    recurrent carry cannot replay a right-padded chunk or roll back
    rejected drafts)."""
    if layer_kind(cfg, layer_idx) != "attn":
        raise NotImplementedError(f"{what} requires homogeneous all-attention layers")


def init_block_params(key, cfg, layer_idx, dtype=torch.float32, device="cuda"):
    """Params of one layer (the reference's key tree: ``k1, k2 =
    split(key)``, attention or the RWKV6 time-mix from ``k1``; from
    ``k2`` the MoE of an MoE layer, else the MLP from ``split(k2, 3)``)."""
    kind = layer_kind(cfg, layer_idx)
    d = cfg.d_model
    k1, k2 = split(key)
    mixer = (init_attn_params(k1, cfg, dtype, device) if kind == "attn"
             else init_rwkv6_params(k1, cfg, dtype, device))
    p = {
        "norm1": make_norm_params(d, cfg.norm, dtype, device),
        "norm2": make_norm_params(d, cfg.norm, dtype, device),
        kind: mixer,
    }
    if cfg.layer_kind(layer_idx)[1]:
        p["moe"] = init_moe_params(k2, cfg, dtype, device)
        return p
    ks = split(k2, 3)
    p["mlp"] = {
        "wi": make_dense_params(ks[0], d, cfg.d_ff, False, dtype, device),
        "wg": make_dense_params(ks[1], d, cfg.d_ff, False, dtype, device),
        "wo": make_dense_params(ks[2], cfg.d_ff, d, False, dtype, device),
    }
    return p


def _ffn_forward(p, x, cfg, *, policy, rng, name, prepared=None, kernels=True):
    """The layer's FFN on x (B, S, d): the MoE of an MoE layer, else the
    gated MLP."""
    if "moe" in p:
        return moe_block(p["moe"], x, cfg, policy=policy, rng=rng, name=name,
                         prepared=pget(prepared, "moe"), kernels=kernels)
    mlp = p["mlp"]
    prog = pget(prepared, "mlp")
    kw = dict(policy=policy, rng=rng, kernels=kernels)
    h = dense(mlp["wi"], x, name=f"{name}.mlp.wi", prepared=pget(prog, "wi"), **kw)
    g = dense(mlp["wg"], x, name=f"{name}.mlp.wg", prepared=pget(prog, "wg"), **kw)
    h = activation(g, cfg.act) * h
    return dense(mlp["wo"], h, name=f"{name}.mlp.wo", prepared=pget(prog, "wo"), **kw)


def block_forward(p, x, cfg, template_idx, *, policy, rng, positions,
                  attn_schedule="masked", prepared=None, kernels=True):
    """One layer on a full sequence x (B, S, d) (the reference's
    ``block_forward`` with its ``_layer_forward``): returns (x, state),
    the layer's serving state: its roped K / V (``{"k", "v"}``) or its
    RWKV6 state after the last token (``{"s", "x_prev"}``)."""
    kind = layer_kind(cfg, template_idx)
    name = f"L.{kind}"
    h = norm(x, p["norm1"], cfg.norm)
    if kind == "attn":
        y, (k, v) = attention_block(
            p["attn"], h, cfg, policy=policy, rng=rng, positions=positions, name=name,
            attn_schedule=attn_schedule, prepared=pget(prepared, "attn"), kernels=kernels,
        )
        state = {"k": k, "v": v}
    else:
        y, (s, x_last) = rwkv6_block(p["ssm"], h, cfg, policy=policy, rng=rng, name=name,
                                     prepared=pget(prepared, "ssm"), kernels=kernels)
        state = {"s": s, "x_prev": x_last}
    x = x + y
    h = norm(x, p["norm2"], cfg.norm)
    x = x + _ffn_forward(p, h, cfg, policy=policy, rng=rng, name=name, prepared=prepared,
                         kernels=kernels)
    return x, state


def _freeze_inactive(active, new, old):
    """``new``, with ``old`` kept on the rows where ``active`` is False (an
    idle row must not evolve its recurrent state)."""
    if active is None:
        return new
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def block_decode(p, x1, cfg, template_idx, *, policy, rng, pos, state,
                 prepared=None, active=None, block_tables=None, kernels=True):
    """One layer of a decode step: x1 (B, d) -> (x1, state); the layer's
    dense K / V rows or paged pools, or its RWKV6 ``s`` and ``x_prev``,
    in ``state`` are updated in place (rows where ``active`` is False
    keep their recurrent state)."""
    kind = layer_kind(cfg, template_idx)
    name = f"L.{kind}"
    h = norm(x1, p["norm1"], cfg.norm)
    if kind == "attn":
        y, ck, cv = decode_attention_block(
            p["attn"], h, cfg, policy=policy, rng=rng, cache_k=state["k"],
            cache_v=state["v"], pos=pos, name=name, prepared=pget(prepared, "attn"),
            active=active, block_tables=block_tables, kernels=kernels,
        )
        new_state = {"k": ck, "v": cv}
    else:
        y, s, x_last = rwkv6_decode(
            p["ssm"], h, cfg, policy=policy, rng=rng, name=name, state=state["s"],
            x_prev=state["x_prev"], prepared=pget(prepared, "ssm"), kernels=kernels,
        )
        state["s"].copy_(_freeze_inactive(active, s, state["s"]))
        state["x_prev"].copy_(_freeze_inactive(active, x_last, state["x_prev"]))
        new_state = state
    x1 = x1 + y
    h = norm(x1, p["norm2"], cfg.norm)
    x1 = x1 + _ffn_forward(
        p, h[:, None, :], cfg, policy=policy, rng=rng, name=name,
        prepared=prepared, kernels=kernels,
    )[:, 0]
    return x1, new_state


def block_chunk(p, x, cfg, template_idx, *, policy, rng, state, bt_row, start,
                n_valid, positions, prepared=None, kernels=True):
    """One attention layer of CHUNKED PREFILL: a prompt chunk x (1, C, d),
    its K/V written into the slot's blocks of the layer's pools."""
    _attn_only(cfg, template_idx, "chunked prefill")
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
    _attn_only(cfg, template_idx, "speculative verify")
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
