"""Model entry points: init, ``forward`` (train / prefill), the dense and
the paged KV caches, the decode step (dense or paged), the chunked
prefill step and the speculative verify step (port of the
decoder parts of ``repro/models/model.py``): dense attention decoders,
their MoE layers (the ``moe`` family), the RWKV6 ``ssm`` family and the
``hybrid`` jamba (Mamba and attention layers in period groups, MoE on
some), whose dense cache holds each recurrent layer's state instead of
K / V.

The reference scans each segment of identical layers with ``lax.scan``
(rematerialised per step in ``forward`` and per chunk in ``loss_fn``);
here that is a Python loop over the stacked layers, and ``remat`` wraps
each layer and each loss chunk in a non-reentrant
``torch.utils.checkpoint`` that recomputes the whole region in the
backward pass (hardware layers program their weights again there, with
the same keys, as the reference's recompute does).  The ``lax.cond``
that skips the vocab head on non-final prefill chunks is a host ``if``.
Caches are updated in place (the reference donates them).  The layer
key chain is the reference's:
``fold_in(fold_in(rng, segment), step)``, a hybrid's step being a whole
group.  Vision prefixes and encoders raise ``NotImplementedError``; the
paged cache, chunked prefill and speculative verify take homogeneous
attention layers (with or without MoE) only, as the reference's.
:func:`loss_fn` (the trainer) takes attention layers with the MLP only:
RWKV6, Mamba and MoE layers serve but are not ported to training yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.core import xmath
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
    take_rows,
    uniform_init,
    unstack_layers,
)
from .config import ArchConfig
from .ssm import init_mamba_state, init_rwkv6_state
from .transformer import (
    block_chunk,
    block_decode,
    block_forward,
    block_verify,
    group_size,
    init_block_params,
    n_groups,
)

__all__ = [
    "segments",
    "init_params",
    "forward",
    "init_cache",
    "init_paged_cache",
    "copy_paged_block",
    "decode_step",
    "decode_verify_step",
    "prefill_chunk_step",
    "loss_fn",
]


def segments(cfg: ArchConfig) -> list[tuple[int, int, int]]:
    """[(start, n_steps, template_layer_idx), ...] — contiguous runs of
    structurally identical layers; a hybrid is one segment of its groups."""
    if cfg.family == "hybrid":
        return [(0, n_groups(cfg), 0)]
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


def _embed_inputs(params, cfg, batch, compute_dtype):
    if cfg.vision_prefix or "patch_embeds" in batch:
        raise NotImplementedError("vision prefixes are not ported to repro_torch yet")
    return take_rows(params["embed"]["w"].to(compute_dtype), batch["tokens"])


def _remat(fn, *args):
    """``fn(*args)`` under a non-reentrant checkpoint that recomputes the
    whole of ``fn`` in the backward pass (no early stop: every hardware
    layer of the region programs and runs again, as in the reference's
    ``nothing_saveable`` recompute)."""
    with _ckpt.set_checkpoint_early_stop(False):
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def forward(
    params,
    cfg: ArchConfig,
    batch: dict,
    *,
    policy: MemPolicy = DIGITAL,
    rng=None,
    mode: str = "train",
    compute_dtype=torch.bfloat16,
    remat: bool = True,
    programmed=None,
    kernels: bool = True,
):
    """Hidden states (B, S, d) after the final norm of ``batch["tokens"]``
    (B, S); with ``mode == "prefill"`` also the per-segment serving
    states stacked over the segment's steps: ``{"seg{i}": {"k", "v"}}``,
    each (steps, B, S, KV, hd), for attention layers, ``{"s", "x_prev"}``
    ((steps, B, H, N, N) and (steps, B, d)) for RWKV6 layers, ``{"h",
    "conv"}`` ((steps, B, d_in, N) float32 and (steps, B, K-1, d_in)) for
    Mamba layers, and ``{"l{j}": ...}`` of these for a hybrid's groups.
    ``programmed`` is weight-stationary state from
    :func:`repro_torch.models.programmed.program_params` (no layer
    re-programs); without it every hardware layer programs its weight
    on the fly from its key.  Attention uses the ``"tri"`` causal
    schedule past 1,024 keys, as the reference's ``forward``.  With
    ``remat`` (``mode="train"``, gradients on) each layer is recomputed
    in the backward pass instead of keeping its activations."""
    rng = PRNGKey(0) if rng is None else rng
    if cfg.encoder is not None:
        raise NotImplementedError("encoder-decoder models are not ported to repro_torch yet")
    x = _embed_inputs(params, cfg, batch, compute_dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    prog_blocks = pget(programmed, "blocks")
    remat = remat and mode == "train" and torch.is_grad_enabled()
    all_states = {}
    for si, (start, steps, tmpl) in enumerate(segments(cfg)):
        seg_p = params["blocks"][f"seg{si}"]
        layers = unstack_layers(seg_p, steps)
        prog_seg = pget(prog_blocks, f"seg{si}")
        rng_s = fold_in(rng, si)
        states = []
        for idx in range(steps):
            kw = dict(policy=policy, rng=fold_in(rng_s, idx), positions=positions,
                      attn_schedule="tri", kernels=kernels,
                      prepared=None if prog_seg is None else layer_slice(prog_seg, idx))
            if remat:
                x = _remat(lambda x, p_l=layers[idx], kw=kw:
                           block_forward(p_l, x, cfg, tmpl, **kw)[0], x)
                continue
            x, st = block_forward(layers[idx], x, cfg, tmpl, **kw)
            if mode == "prefill":
                states.append(st)
        all_states[f"seg{si}"] = _stack_states(states) if mode == "prefill" else None
    x = norm(x, params["final_norm"], cfg.norm)
    if mode == "prefill":
        return x, all_states
    return x


def loss_fn(
    params,
    cfg: ArchConfig,
    batch: dict,
    *,
    policy: MemPolicy = DIGITAL,
    rng=None,
    compute_dtype=torch.bfloat16,
    remat: bool = True,
    loss_chunk: int = 256,
    kernels: bool = True,
):
    """Mean next-token cross entropy of ``batch`` (``tokens``, ``labels``
    (B, S); labels < 0 are masked), a 0-d float32 tensor.  The sequence
    is cut into ``loss_chunk``-token chunks (the last padded with masked
    labels); each chunk runs the vocab head (programmed per chunk from
    ``rng``, as the reference's), :func:`~repro_torch.core.xmath.logsumexp`
    and the picked logit, and with ``remat`` is recomputed in the
    backward pass.  The sum over chunks and the count run in order from
    zero, then ``tot / max(cnt, 1)``.  Raises ``NotImplementedError`` for
    RWKV6, Mamba and MoE layers (their gradients are not held against the
    reference's)."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    if any(kind == "ssm" for kind, _ in kinds):
        raise NotImplementedError("training ssm layers is not ported to repro_torch yet")
    if any(has_moe for _, has_moe in kinds):
        raise NotImplementedError("training MoE layers is not ported to repro_torch yet")
    x = forward(
        params, cfg, batch, policy=policy, rng=rng, mode="train",
        compute_dtype=compute_dtype, remat=remat, kernels=kernels,
    )
    labels = batch["labels"]
    b, s, d = x.shape
    ck = min(loss_chunk, s)
    if s % ck:  # pad to a whole number of chunks; padded labels masked
        pad = ck - s % ck
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        s += pad
    head = params["lm_head"]["w"]
    rng = PRNGKey(0) if rng is None else rng

    def chunk(xs, ls):
        logits = dense({"w": head}, xs, name="lm_head", policy=policy, rng=rng,
                       kernels=kernels).to(torch.float32)
        lse = xmath.logsumexp(logits)
        picked = torch.gather(logits, -1, ls.clamp_min(0).long()[..., None])[..., 0]
        mask = (ls >= 0).to(torch.float32)
        return torch.sum((lse - picked) * mask), torch.sum(mask)

    remat = remat and torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s // ck):
        xs, ls = x[:, i * ck:(i + 1) * ck], labels[:, i * ck:(i + 1) * ck]
        t, c = _remat(chunk, xs, ls) if remat else chunk(xs, ls)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp_min(cnt, 1.0)


def _stack_states(states: list):
    """Per-step state trees (nested dicts of tensors) stacked over the
    steps."""
    if isinstance(states[0], dict):
        return {k: _stack_states([st[k] for st in states]) for k in states[0]}
    return torch.stack(states)


def _layer_cache(cfg, layer_idx, steps, batch, max_len, dtype, device):
    """A layer's dense serving state stacked over ``steps``: K / V of an
    attention layer, the RWKV6 state ``s`` (float32) and ``x_prev``, or
    the Mamba state ``h`` (float32) and ``conv`` (``x_prev`` and ``conv``
    in ``dtype``)."""
    if cfg.layer_kind(layer_idx)[0] == "ssm":
        init = init_rwkv6_state if cfg.ssm.kind == "rwkv6" else init_mamba_state
        return init(cfg, batch, steps, dtype, device)
    shape = (steps, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _seg_cache(cfg, tmpl, steps, batch, max_len, dtype, device):
    """One segment's dense serving state stacked over its steps: a layer's
    (:func:`_layer_cache`), or a hybrid group's ``{"l{j}": ...}``."""
    g = group_size(cfg)
    if g == 1:
        return _layer_cache(cfg, tmpl, steps, batch, max_len, dtype, device)
    return {f"l{j}": _layer_cache(cfg, j, steps, batch, max_len, dtype, device)
            for j in range(g)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """The DENSE serving cache: ``pos`` (batch,) int32 and per segment
    ``{"k", "v"}`` of shape (steps, batch, max_len, KV, hd), or for
    recurrent layers their state whatever ``max_len`` (RWKV6 ``{"s",
    "x_prev"}``, Mamba ``{"h", "conv"}``; a hybrid's ``{"l{j}": ...}``)."""
    if cfg.encoder is not None:
        raise NotImplementedError("encoder-decoder models are not ported to repro_torch yet")
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device), "blocks": {}}
    for si, (start, steps, tmpl) in enumerate(segments(cfg)):
        cache["blocks"][f"seg{si}"] = _seg_cache(cfg, tmpl, steps, batch, max_len, dtype, device)
    return cache


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
    """Yield ``(params, programmed, state, rng, template_idx)`` of every
    step in order (the reference's scan over stacked segments; a hybrid's
    step is a group); ``state`` holds views of the dense K / V rows or
    pools, or of the recurrent state."""
    prog_blocks = pget(programmed, "blocks")
    for si, (start, steps, tmpl) in enumerate(segments(cfg)):
        seg_p = params["blocks"][f"seg{si}"]
        seg_c = cache["blocks"][f"seg{si}"]
        prog_seg = pget(prog_blocks, f"seg{si}")
        rng_s = fold_in(rng, si)
        for idx in range(steps):
            prog_l = None if prog_seg is None else layer_slice(prog_seg, idx)
            state = layer_slice(seg_c, idx)
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
    touch live KV or recurrent state.  The cache — the dense
    :func:`init_cache` tree or the paged :func:`init_paged_cache` tree,
    told apart by its ``block_tables`` — is updated in place."""
    rng = PRNGKey(0) if rng is None else rng
    block_tables = cache.get("block_tables")
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
