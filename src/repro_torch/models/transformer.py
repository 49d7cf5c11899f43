"""Decoder blocks (port of ``repro/models/transformer.py``): a layer or a
hybrid group on a whole sequence (:func:`block_forward`, train /
prefill), one decode step against a dense or a paged cache
(:func:`block_decode`), a chunk of chunked prefill and a speculative
verify chunk against the paged pool.

Layer kinds: the dense attention layer, the RWKV6 time-mix layer of the
``ssm`` family and the Mamba layer of the ``hybrid`` family (their
recurrent state in place of K / V; chunked prefill and speculative
verify refuse both, as the reference's do).  A hybrid model (jamba) steps
a whole period group at a time (:func:`group_size` layers, params and
state under ``l0`` .. ``l{g-1}``), every layer of a group with the
group's key, as the reference's.  A layer's FFN is the gated MLP or, in
MoE layers, the token-choice top-k MoE (:mod:`.moe`) on every block path.
Layer names (``L.attn.*``, ``L.ssm.*``, no layer index) and the per-layer
key are the reference's, so programmed-state lookup and programming-noise
keys agree with :mod:`.programmed`.
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
from .ssm import (
    init_mamba_params,
    init_rwkv6_params,
    mamba_block,
    mamba_decode,
    rwkv6_block,
    rwkv6_decode,
)

__all__ = ["init_block_params", "block_forward", "block_decode", "block_chunk", "block_verify",
           "group_size", "n_groups"]


def group_size(cfg) -> int:
    """Layers one step covers: a hybrid's period, else 1."""
    return cfg.hybrid_period if cfg.family == "hybrid" else 1


def n_groups(cfg) -> int:
    g = group_size(cfg)
    if cfg.n_layers % g:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole groups of {g}")
    return cfg.n_layers // g


def _attn_only(cfg, layer_idx: int, what: str) -> None:
    """Chunked prefill and speculative verify: homogeneous attention layers
    only (a recurrent carry cannot replay a right-padded chunk or roll
    back rejected drafts)."""
    if group_size(cfg) != 1 or cfg.layer_kind(layer_idx)[0] != "attn":
        raise NotImplementedError(f"{what} requires homogeneous all-attention layers")


def init_block_params(key, cfg, group_idx, dtype=torch.float32, device="cuda"):
    """Params of one step: a layer, or a hybrid group ``{"l{j}": layer}``
    from ``split(key, g)``."""
    g = group_size(cfg)
    if g == 1:
        return _init_one_layer(key, cfg, group_idx, dtype, device)
    ks = split(key, g)
    return {f"l{j}": _init_one_layer(ks[j], cfg, group_idx * g + j, dtype, device)
            for j in range(g)}


def _init_one_layer(key, cfg, layer_idx, dtype, device):
    """Params of one layer (the reference's key tree: ``k1, k2 =
    split(key)``, attention, the RWKV6 time-mix or the Mamba block from
    ``k1``; from ``k2`` the MoE of an MoE layer, else the MLP from
    ``split(k2, 3)``)."""
    kind, has_moe = cfg.layer_kind(layer_idx)
    d = cfg.d_model
    k1, k2 = split(key)
    if kind == "attn":
        mixer = init_attn_params(k1, cfg, dtype, device)
    elif cfg.ssm.kind == "rwkv6":
        mixer = init_rwkv6_params(k1, cfg, dtype, device)
    else:
        mixer = init_mamba_params(k1, cfg, dtype, device)
    p = {
        "norm1": make_norm_params(d, cfg.norm, dtype, device),
        "norm2": make_norm_params(d, cfg.norm, dtype, device),
        kind: mixer,
    }
    if has_moe:
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


def _layer_forward(p, x, cfg, layer_idx, *, policy, rng, positions, attn_schedule,
                   prepared, kernels):
    """One layer on a full sequence x (B, S, d): returns (x, state), the
    layer's serving state: its roped K / V (``{"k", "v"}``), its RWKV6
    state (``{"s", "x_prev"}``) or its Mamba state (``{"h", "conv"}``)
    after the last token."""
    kind, _ = cfg.layer_kind(layer_idx)
    name = f"L.{kind}"
    kw = dict(policy=policy, rng=rng, kernels=kernels)
    h = norm(x, p["norm1"], cfg.norm)
    if kind == "attn":
        y, (k, v) = attention_block(
            p["attn"], h, cfg, positions=positions, name=name, attn_schedule=attn_schedule,
            prepared=pget(prepared, "attn"), **kw,
        )
        state = {"k": k, "v": v}
    elif cfg.ssm.kind == "rwkv6":
        y, (s, x_last) = rwkv6_block(p["ssm"], h, cfg, name=name,
                                     prepared=pget(prepared, "ssm"), **kw)
        state = {"s": s, "x_prev": x_last}
    else:
        y, (s, conv) = mamba_block(p["ssm"], h, cfg, name=name,
                                   prepared=pget(prepared, "ssm"), **kw)
        state = {"h": s, "conv": conv}
    x = x + y
    h = norm(x, p["norm2"], cfg.norm)
    x = x + _ffn_forward(p, h, cfg, name=name, prepared=prepared, **kw)
    return x, state


def block_forward(p, x, cfg, template_idx, *, policy, rng, positions,
                  attn_schedule="masked", prepared=None, kernels=True):
    """One step on a full sequence x (B, S, d) (the reference's
    ``block_forward``): a layer, returning (x, its state); or a hybrid
    group, every layer with ``rng``, returning (x, ``{"l{j}": state}``)."""
    kw = dict(policy=policy, rng=rng, positions=positions, attn_schedule=attn_schedule,
              kernels=kernels)
    g = group_size(cfg)
    if g == 1:
        return _layer_forward(p, x, cfg, template_idx, prepared=prepared, **kw)
    states = {}
    for j in range(g):
        x, states[f"l{j}"] = _layer_forward(p[f"l{j}"], x, cfg, j,
                                            prepared=pget(prepared, f"l{j}"), **kw)
    return x, states


def _freeze_inactive(active, new, old):
    """``new``, with ``old`` kept on the rows where ``active`` is False (an
    idle row must not evolve its recurrent state)."""
    if active is None:
        return new
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _layer_decode(p, x1, cfg, layer_idx, *, policy, rng, pos, state, prepared, active,
                  block_tables, kernels):
    """One layer of a decode step: x1 (B, d) -> x1; the layer's dense K / V
    rows or paged pools, its RWKV6 ``s`` and ``x_prev`` or its Mamba ``h``
    and ``conv`` in ``state`` are updated in place (rows where ``active``
    is False keep their recurrent state)."""
    kind, _ = cfg.layer_kind(layer_idx)
    name = f"L.{kind}"
    kw = dict(policy=policy, rng=rng, kernels=kernels)
    h = norm(x1, p["norm1"], cfg.norm)
    if kind == "attn":
        y, _, _ = decode_attention_block(
            p["attn"], h, cfg, cache_k=state["k"], cache_v=state["v"], pos=pos, name=name,
            prepared=pget(prepared, "attn"), active=active, block_tables=block_tables, **kw,
        )
    else:
        if cfg.ssm.kind == "rwkv6":
            y, *new = rwkv6_decode(p["ssm"], h, cfg, name=name, state=state["s"],
                                   x_prev=state["x_prev"], prepared=pget(prepared, "ssm"), **kw)
            keys = ("s", "x_prev")
        else:
            y, *new = mamba_decode(p["ssm"], h, cfg, name=name, state=state["h"],
                                   conv_cache=state["conv"], prepared=pget(prepared, "ssm"),
                                   **kw)
            keys = ("h", "conv")
        for key, t in zip(keys, new):
            state[key].copy_(_freeze_inactive(active, t, state[key]))
    x1 = x1 + y
    h = norm(x1, p["norm2"], cfg.norm)
    return x1 + _ffn_forward(p, h[:, None, :], cfg, name=name, prepared=prepared, **kw)[:, 0]


def block_decode(p, x1, cfg, template_idx, *, policy, rng, pos, state,
                 prepared=None, active=None, block_tables=None, kernels=True):
    """One step of a decode step: x1 (B, d) -> (x1, state), a layer or a
    hybrid group (every layer with ``rng``); the step's state — a layer's,
    or ``{"l{j}": state}`` — is updated in place."""
    kw = dict(policy=policy, rng=rng, pos=pos, active=active, block_tables=block_tables,
              kernels=kernels)
    g = group_size(cfg)
    if g == 1:
        return _layer_decode(p, x1, cfg, template_idx, state=state, prepared=prepared,
                             **kw), state
    for j in range(g):
        x1 = _layer_decode(p[f"l{j}"], x1, cfg, j, state=state[f"l{j}"],
                           prepared=pget(prepared, f"l{j}"), **kw)
    return x1, state


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
