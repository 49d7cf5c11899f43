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
group.  A vision model (phi-3-vision) takes ``batch["patch_embeds"]``
ahead of its token embeddings.  The encoder-decoder whisper runs its
encoder over ``batch["frames"]`` (the stubbed frontend's embeddings plus
sinusoidal positions, :func:`_sinusoid`), then its decoder layers, each a
causal self-attention block and a cross-attention over the encoder's
output, with the reference's keys: ``fold_in(rng, 1000 + i)`` /
``fold_in(rng, 2000 + i)`` for encoder layer ``i``'s attention / MLP and
``fold_in(rng, i)`` for decoder layer ``i`` and its cross-attention;
its dense cache carries ``cross_kv``, the encoder's K / V of every
decoder layer.  The paged cache, chunked prefill and speculative verify
take homogeneous decoder-only attention layers (with or without MoE)
only, as the reference's.  :func:`loss_fn` (the trainer) takes every
family: dense, RWKV6, Mamba and the hybrid's groups, MoE, the
encoder-decoder (with ``remat`` each encoder layer and each decoder
layer with its cross-attention checkpointed, as the reference's
``enc_step`` / ``dec_step``) and the vision prefix (its positions
masked out of the loss).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core import xmath
from repro_torch.core.layers import DIGITAL, MemPolicy
from repro_torch.core.prng import PRNGKey, fold_in, split

from .attention import attention_block, decode_attention_block, init_attn_params
from .common import (
    dense,
    layer_slice,
    make_dense_params,
    make_norm_params,
    norm,
    pget,
    remat_call,
    stack_layers,
    take_rows,
    uniform_init,
    unstack_layers,
)
from .config import ArchConfig
from .ssm import init_mamba_state, init_rwkv6_state
from .transformer import (
    _ffn_forward,
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
    if cfg.encoder is not None:
        params["encoder"] = _init_encoder(keys[3], cfg, dtype, device)
        params["cross"] = _init_cross_stack(keys[4], cfg, dtype, device)
    return params


def _init_encoder(key, cfg, dtype, device):
    """The encoder's layers (decoder layer 0's structure) from the first
    ``n_layers`` keys of ``split(key, n_layers + 1)``, and its final
    norm."""
    ks = split(key, cfg.encoder.n_layers + 1)
    return {
        "blocks": stack_layers(lambda i: init_block_params(ks[i], cfg, 0, dtype, device),
                               cfg.encoder.n_layers),
        "final_norm": make_norm_params(cfg.d_model, cfg.norm, dtype, device),
    }


def _init_cross_stack(key, cfg, dtype, device):
    """Every decoder layer's cross-attention (its projections and its
    norm), stacked, from ``split(key, n_layers)``."""
    ks = split(key, cfg.n_layers)

    def one(i):
        p = init_attn_params(ks[i], cfg, dtype, device)
        p["norm"] = make_norm_params(cfg.d_model, cfg.norm, dtype, device)
        return p

    return stack_layers(one, cfg.n_layers)


def _embed_inputs(params, cfg, batch, compute_dtype):
    """The token embeddings (B, S, d), behind a vision model's
    ``batch["patch_embeds"]`` (B, P, d) cast to ``compute_dtype``."""
    x = take_rows(params["embed"]["w"].to(compute_dtype), batch["tokens"])
    if cfg.vision_prefix and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(compute_dtype), x], dim=1)
    return x


@functools.lru_cache(maxsize=16)
def _sinusoid_table(n: int, d: int, device: torch.device) -> torch.Tensor:
    """The sinusoid table (n, d) float32 on ``device``: row ``p`` is
    ``[sin(p * f), cos(p * f)]`` over the ``d // 2`` frequencies ``f =
    exp(-log(10000) * j / (d // 2))``, each value the reference's bits
    (XLA's ``log`` / ``exp`` and the C library's ``sinf`` / ``cosf``,
    :mod:`~repro_torch.core.xmath`), computed on the host (~1 us an
    element) once per length, width and device."""
    half = d // 2
    neg_log = -xmath.log(torch.tensor([10000.0]))
    freq = xmath.exp(neg_log * torch.arange(half, dtype=torch.float32) / float(half))
    ang = torch.arange(n, dtype=torch.float32)[:, None] * freq
    return torch.cat([xmath.sin(ang), xmath.cos(ang)], dim=-1).to(device)


def _sinusoid(positions: torch.Tensor, d: int, n: int) -> torch.Tensor:
    """The reference's ``_sinusoid``: sinusoidal embeddings (..., d)
    float32 of integer ``positions`` (any shape), each below ``n`` (the
    frames, the prompt or the cache; read on the host, the positions
    would wait for the device), gathered from :func:`_sinusoid_table`."""
    return _sinusoid_table(n, d, positions.device)[positions.long()]


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
    remat = remat and mode == "train" and torch.is_grad_enabled()
    if cfg.encoder is not None:
        return _encdec_forward(params, cfg, batch, policy=policy, rng=rng, mode=mode,
                               compute_dtype=compute_dtype, remat=remat,
                               programmed=programmed, kernels=kernels)
    x = _embed_inputs(params, cfg, batch, compute_dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    prog_blocks = pget(programmed, "blocks")
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
                x = remat_call(lambda x, p_l=layers[idx], kw=kw:
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
    (B, S); labels < 0 are masked; a vision model's ``patch_embeds``
    positions take the label -1 in front, as the reference's), a 0-d
    float32 tensor.  The sequence
    is cut into ``loss_chunk``-token chunks (the last padded with masked
    labels); each chunk runs the vocab head (programmed per chunk from
    ``rng``, as the reference's), :func:`~repro_torch.core.xmath.logsumexp`
    and the picked logit, and with ``remat`` is recomputed in the
    backward pass.  The sum over chunks and the count run in order from
    zero, then ``tot / max(cnt, 1)``.  Trains every family (an MoE
    layer's expert stacks straight-through, one programming of a stack a
    product)."""
    x = forward(
        params, cfg, batch, policy=policy, rng=rng, mode="train",
        compute_dtype=compute_dtype, remat=remat, kernels=kernels,
    )
    labels = batch["labels"]
    if cfg.vision_prefix and "patch_embeds" in batch:
        labels = F.pad(labels, (cfg.vision_prefix, 0), value=-1)
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
        t, c = remat_call(chunk, xs, ls) if remat else chunk(xs, ls)
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
    "x_prev"}``, Mamba ``{"h", "conv"}``; a hybrid's ``{"l{j}": ...}``).
    An encoder-decoder's cache also holds ``cross_kv``: ``{"k", "v"}``,
    each (n_layers, batch, n_frames, KV, hd), zeros until a prefill fills
    them."""
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device), "blocks": {}}
    for si, (start, steps, tmpl) in enumerate(segments(cfg)):
        cache["blocks"][f"seg{si}"] = _seg_cache(cfg, tmpl, steps, batch, max_len, dtype, device)
    if cfg.encoder is not None:
        shape = (cfg.n_layers, batch, cfg.encoder.n_frames, cfg.n_kv_heads, cfg.head_dim)
        cache["cross_kv"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                             "v": torch.zeros(shape, dtype=dtype, device=device)}
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
    told apart by its ``block_tables`` — is updated in place.  An
    encoder-decoder's step attends over the cache's ``cross_kv`` too
    (dense cache only)."""
    rng = PRNGKey(0) if rng is None else rng
    if cfg.encoder is not None:
        return _encdec_decode(params, cfg, cache, tokens, policy=policy, rng=rng,
                              compute_dtype=compute_dtype, programmed=programmed,
                              active=active, kernels=kernels)
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


def _encoder_layer(p, x, cfg, *, policy, rng, idx, positions, prepared=None, kernels=True):
    """Encoder layer ``idx`` on x (B, F, d): the non-causal self-attention
    block (``enc.attn.*``, key ``fold_in(rng, 1000 + idx)``), then the MLP
    (``enc.mlp.*``, key ``fold_in(rng, 2000 + idx)``), each behind its
    norm and added to x."""
    h = norm(x, p["norm1"], cfg.norm)
    y, _ = attention_block(p["attn"], h, cfg, policy=policy, rng=fold_in(rng, 1000 + idx),
                           positions=positions, name="enc.attn", causal=False,
                           prepared=pget(prepared, "attn"), kernels=kernels)
    x = x + y
    h = norm(x, p["norm2"], cfg.norm)
    return x + _ffn_forward(p, h, cfg, policy=policy, rng=fold_in(rng, 2000 + idx), name="enc",
                            prepared=prepared, kernels=kernels)


def _encdec_forward(params, cfg, batch, *, policy, rng, mode, compute_dtype, remat, programmed,
                    kernels):
    """The whisper encoder-decoder on ``batch["frames"]`` (B, F, d) and
    ``batch["tokens"]`` (B, S): the encoder's non-causal layers over the
    frames plus their sinusoid, its final norm, then each decoder layer
    (causal self-attention block, then cross-attention over the encoder's
    output, whose K / V it projects) over the tokens' embeddings plus
    theirs.  Returns the decoder's hidden states after the final norm;
    with ``mode == "prefill"`` also ``{"seg0": {"k", "v"}, "cross_kv":
    {"k", "v"}}``, the self-attention K / V (n_layers, B, S, KV, hd) and
    the cross-attention's (n_layers, B, F, KV, hd).  With ``remat`` each
    encoder layer and each decoder layer (its self-attention block and
    its cross-attention, K / V projections included) is recomputed in the
    backward pass."""
    frames = batch["frames"].to(compute_dtype)
    b, f, d = frames.shape
    dev = frames.device
    nkv, hd = cfg.n_kv_heads, cfg.head_dim
    pos_e = torch.arange(f, device=dev).expand(b, f)
    x = frames + _sinusoid(pos_e, d, f).to(compute_dtype)
    nenc = cfg.encoder.n_layers
    prog_enc = pget(pget(programmed, "encoder"), "blocks")
    for idx, p_l in enumerate(unstack_layers(params["encoder"]["blocks"], nenc)):
        kw = dict(policy=policy, rng=rng, idx=idx, positions=pos_e, kernels=kernels,
                  prepared=None if prog_enc is None else layer_slice(prog_enc, idx))
        if remat:
            x = remat_call(lambda x, p_l=p_l, kw=kw: _encoder_layer(p_l, x, cfg, **kw), x)
        else:
            x = _encoder_layer(p_l, x, cfg, **kw)
    enc_out = norm(x, params["encoder"]["final_norm"], cfg.norm)

    tokens = batch["tokens"]
    bt, s = tokens.shape
    xd = take_rows(params["embed"]["w"].to(compute_dtype), tokens)
    pos_d = torch.arange(s, device=dev).expand(bt, s)
    xd = xd + _sinusoid(pos_d, d, s).to(compute_dtype)
    prog_seg0 = pget(pget(programmed, "blocks"), "seg0")
    prog_cross = pget(programmed, "cross")
    n = cfg.n_layers
    layers = zip(unstack_layers(params["blocks"]["seg0"], n), unstack_layers(params["cross"], n))
    states, cross_k, cross_v = [], [], []

    def dec_layer(xd, enc_out, p_l, p_x, rng_l, prog_l, prog_x):
        """Decoder layer: self-attention block, then the cross-attention."""
        xd, st = block_forward(p_l, xd, cfg, 0, policy=policy, rng=rng_l, positions=pos_d,
                               prepared=prog_l, kernels=kernels)
        kw = dict(policy=policy, rng=rng_l, kernels=kernels)
        h = norm(xd, p_x["norm"], cfg.norm)
        kx = dense(p_x["k_proj"], enc_out, name="dec.cross.k",
                   prepared=pget(prog_x, "k_proj"), **kw).reshape(b, f, nkv, hd)
        vx = dense(p_x["v_proj"], enc_out, name="dec.cross.v",
                   prepared=pget(prog_x, "v_proj"), **kw).reshape(b, f, nkv, hd)
        y, _ = attention_block(p_x, h, cfg, positions=pos_d, name="dec.cross", kv_in=(kx, vx),
                               causal=False, prepared=prog_x, **kw)
        return xd + y, st, kx, vx

    for idx, (p_l, p_x) in enumerate(layers):
        args = (p_l, p_x, fold_in(rng, idx),
                None if prog_seg0 is None else layer_slice(prog_seg0, idx),
                None if prog_cross is None else layer_slice(prog_cross, idx))
        if remat:
            xd = remat_call(lambda xd, e, args=args: dec_layer(xd, e, *args)[0], xd, enc_out)
            continue
        xd, st, kx, vx = dec_layer(xd, enc_out, *args)
        if mode == "prefill":
            states.append(st)
            cross_k.append(kx)
            cross_v.append(vx)
    xd = norm(xd, params["final_norm"], cfg.norm)
    if mode == "prefill":
        return xd, {"seg0": _stack_states(states),
                    "cross_kv": {"k": torch.stack(cross_k), "v": torch.stack(cross_v)}}
    return xd


def _encdec_decode(params, cfg, cache, tokens, *, policy, rng, compute_dtype, programmed,
                   active, kernels):
    """One decode step of the whisper decoder over the dense cache: the
    token's embedding plus its position's sinusoid, then per decoder layer
    the self-attention block (its K / V written into the cache) and the
    cross-attention over ``cache["cross_kv"]``, every frame a key; the
    head.  Returns (logits (B, V) float32, cache), ``pos`` advanced where
    ``active``."""
    x1 = params["embed"]["w"].to(compute_dtype)[tokens.long()]
    pos = cache["pos"]
    seg_c = cache["blocks"]["seg0"]
    x1 = x1 + _sinusoid(pos, cfg.d_model, seg_c["k"].shape[2]).to(compute_dtype)
    inc = 1 if active is None else active.to(torch.int32)
    enc_pos = torch.full_like(pos, cfg.encoder.n_frames - 1)
    prog_seg0 = pget(pget(programmed, "blocks"), "seg0")
    prog_cross = pget(programmed, "cross")
    for idx in range(cfg.n_layers):
        rng_l = fold_in(rng, idx)
        x1, _ = block_decode(
            layer_slice(params["blocks"]["seg0"], idx), x1, cfg, 0, policy=policy, rng=rng_l,
            pos=pos, state=layer_slice(seg_c, idx), active=active, kernels=kernels,
            prepared=None if prog_seg0 is None else layer_slice(prog_seg0, idx),
        )
        p_x = layer_slice(params["cross"], idx)
        y, _, _ = decode_attention_block(
            p_x, norm(x1, p_x["norm"], cfg.norm), cfg, policy=policy, rng=rng_l,
            cache_k=cache["cross_kv"]["k"][idx], cache_v=cache["cross_kv"]["v"][idx],
            pos=enc_pos, name="dec.cross", cross=True, kernels=kernels,
            prepared=None if prog_cross is None else layer_slice(prog_cross, idx),
        )
        x1 = x1 + y
    x1 = norm(x1, params["final_norm"], cfg.norm)
    logits = dense(
        params["lm_head"], x1, name="lm_head", policy=policy, rng=rng,
        prepared=pget(programmed, "lm_head"), kernels=kernels,
    ).to(torch.float32)
    cache["pos"] = pos + inc
    return logits, cache
