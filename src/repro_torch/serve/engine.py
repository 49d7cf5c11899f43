"""Serving steps and the lockstep generation loop (port of
``repro/serve/engine.py``): the dense lockstep prefill
(:func:`make_prefill_step`) and the single-request bucket-padded
prefill (:func:`make_slot_prefill`), chunked prefill against the paged
arena, the slot-parallel decode step (dense or paged cache), the
speculative verify step, and :func:`greedy_generate`.

Programming noise is static across steps (devices are programmed once
for inference): the base key is ``PRNGKey(0)``.  PyTorch runs eagerly,
so the step makers return plain closures (no jit).  Each step takes the
device-clock time ``t_now`` (None: no drift evaluation) and publishes it
to the programmed layers through :func:`~repro_torch.core.drift.drift_clock`.
``kernels=False`` is the explicit plain-version override.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.drift import drift_clock
from repro_torch.core.layers import DIGITAL, MemPolicy
from repro_torch.core.prng import PRNGKey
from repro_torch.models.common import dense, pget, tree_map
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import decode_step, decode_verify_step, forward, prefill_chunk_step
from repro_torch.models.programmed import program_params

from .sampling import request_keys, sample_rows

__all__ = [
    "make_prefill_step",
    "make_slot_prefill",
    "make_chunk_prefill",
    "make_decode_step",
    "make_verify_step",
    "greedy_generate",
]


def _head_logits(params, hidden, *, policy, rng, programmed, kernels=True):
    """The (possibly analog) vocab head every prefill and decode path
    shares, float32 logits."""
    return dense(params["lm_head"], hidden, name="lm_head", policy=policy, rng=rng,
                 prepared=pget(programmed, "lm_head"), kernels=kernels).to(torch.float32)


def _cache_from_prefill(states, batch, s_prefill, max_len, dtype, device):
    """The dense serving cache from the prefill's per-layer states: K / V
    cast to ``dtype`` and zero-padded along the length axis to
    ``max_len``; recurrent (RWKV6, Mamba) states pass through as they
    are; an encoder-decoder's ``cross_kv`` (the encoder's K / V of every
    decoder layer) is cast to ``dtype``.  A ``max_len`` shorter than the
    prefill raises ``ValueError`` where there are K / V to pad, as the
    reference's ``jnp.pad`` does (a negative pad would crop them)."""
    def pad(tree):
        return {k: pad(x) if isinstance(x, dict) else pad_kv(x) if k in ("k", "v") else x
                for k, x in tree.items()}

    def pad_kv(x):
        if max_len < x.shape[2]:
            raise ValueError(f"max_len {max_len} is shorter than the prefill's {x.shape[2]} "
                             "positions")
        return torch.nn.functional.pad(x.to(dtype), (0, 0, 0, 0, 0, max_len - x.shape[2]))

    states = dict(states)
    cross = states.pop("cross_kv", None)
    cache = {"pos": torch.full((batch,), s_prefill, dtype=torch.int32, device=device),
             "blocks": pad(states)}
    if cross is not None:
        cache["cross_kv"] = {k: x.to(dtype) for k, x in cross.items()}
    return cache


def make_prefill_step(
    cfg: ArchConfig,
    policy: MemPolicy | None = None,
    *,
    max_len: int | None = None,
    compute_dtype=torch.bfloat16,
    cache_dtype=torch.bfloat16,
    remat: bool = True,
    kernels: bool = True,
):
    """Lockstep-batch prefill: the returned function runs a whole batch's
    prompts through :func:`~repro_torch.models.model.forward` and returns
    the first-token logits (through the same vocab head as every decode
    step) and the DENSE serving cache padded to ``max_len`` (default: the
    prompt length)."""
    policy = policy or DIGITAL
    rng = PRNGKey(0)

    def prefill_step(params, batch, programmed=None, t_now=None):
        with drift_clock(t_now):
            hidden, states = forward(
                params, cfg, batch, policy=policy, rng=rng, mode="prefill",
                compute_dtype=compute_dtype, remat=remat, programmed=programmed,
                kernels=kernels,
            )
            logits = _head_logits(params, hidden[:, -1], policy=policy, rng=rng,
                                  programmed=programmed, kernels=kernels)
        b, s = hidden.shape[0], hidden.shape[1]
        return logits, _cache_from_prefill(states, b, s, max_len or s, cache_dtype,
                                           hidden.device)

    return prefill_step


def make_slot_prefill(
    cfg: ArchConfig,
    policy: MemPolicy | None = None,
    *,
    compute_dtype=torch.bfloat16,
    cache_dtype=torch.bfloat16,
    remat: bool = True,
    kernels: bool = True,
):
    """Single-request bucket-padded prefill (dense layout): the returned
    function takes ``tokens`` (1, bucket) right-padded and ``prompt_len``
    and returns the logits at the last real token and the per-layer
    states at bucket length in ``cache_dtype``.  Attention is causal and
    the input pipeline quantises per row, so the padding does not reach
    the real positions."""
    policy = policy or DIGITAL
    rng = PRNGKey(0)

    def slot_prefill(params, tokens, prompt_len, programmed=None, t_now=None):
        with drift_clock(t_now):
            hidden, states = forward(
                params, cfg, {"tokens": tokens}, policy=policy, rng=rng, mode="prefill",
                compute_dtype=compute_dtype, remat=remat, programmed=programmed,
                kernels=kernels,
            )
            logits = _head_logits(params, hidden[:, int(prompt_len) - 1], policy=policy,
                                  rng=rng, programmed=programmed, kernels=kernels)
        return logits, tree_map(lambda x: x.to(cache_dtype), states)

    return slot_prefill


def make_chunk_prefill(
    cfg: ArchConfig,
    policy: MemPolicy | None = None,
    *,
    compute_dtype=torch.bfloat16,
    kernels: bool = True,
):
    """Chunked prefill against the paged arena: the returned function
    runs ONE right-padded chunk of ONE request's prompt, writes its K/V
    into the slot's blocks and returns (logits at the chunk's last real
    token — zeros unless ``final`` — , cache)."""
    policy = policy or DIGITAL
    rng = PRNGKey(0)

    def chunk_fn(params, cache, tokens, slot, start, n_valid, final, programmed=None,
                 t_now=None):
        with drift_clock(t_now):
            return prefill_chunk_step(
                params, cfg, cache, tokens, slot, start, n_valid, final,
                policy=policy, rng=rng, compute_dtype=compute_dtype,
                programmed=programmed, kernels=kernels,
            )

    return chunk_fn


def make_decode_step(
    cfg: ArchConfig,
    policy: MemPolicy | None = None,
    *,
    compute_dtype=torch.bfloat16,
    kernels: bool = True,
):
    """Slot-parallel decode step over the paged cache; per-row
    computations are independent, so a row-independent policy decodes a
    request the same way alone or next to strangers."""
    policy = policy or DIGITAL
    rng = PRNGKey(0)

    def decode_fn(params, cache, tokens, programmed=None, active=None, t_now=None):
        with drift_clock(t_now):
            return decode_step(
                params, cfg, cache, tokens, policy=policy, rng=rng,
                compute_dtype=compute_dtype, programmed=programmed, active=active,
                kernels=kernels,
            )

    return decode_fn


def make_verify_step(
    cfg: ArchConfig,
    policy: MemPolicy | None = None,
    *,
    compute_dtype=torch.bfloat16,
    kernels: bool = True,
):
    """Speculative-verification step over the paged cache: ``tokens``
    (B, C) — per slot the last emitted token and C-1 draft proposals —
    give per-position logits (B, C, V) and the cache with all C
    positions' K/V written, ``pos`` not advanced.  Row (b, c) is the
    logits of a decode at ``pos + c`` on the same accepted prefix."""
    policy = policy or DIGITAL
    rng = PRNGKey(0)

    def verify_fn(params, cache, tokens, programmed=None, active=None, t_now=None):
        with drift_clock(t_now):
            return decode_verify_step(
                params, cfg, cache, tokens, policy=policy, rng=rng,
                compute_dtype=compute_dtype, programmed=programmed, active=active,
                kernels=kernels,
            )

    return verify_fn


def greedy_generate(
    params,
    cfg: ArchConfig,
    prompt_tokens: torch.Tensor,
    n_steps: int,
    *,
    policy: MemPolicy | None = None,
    max_len: int | None = None,
    compute_dtype=torch.bfloat16,
    extra_batch: dict | None = None,
    programmed=None,
    weight_stationary: bool = True,
    jit_steps: bool = True,
    mesh=None,
    t_now=None,
    sampling=None,
    kernels: bool = True,
    collect_logits: bool = False,
):
    """Batched lockstep decoding of ``prompt_tokens`` (B, S) for
    ``n_steps`` tokens after the first: returns the (B, n_steps + 1)
    int32 tokens, and with ``collect_logits`` also their (B, n_steps + 1,
    V) float32 logits.

    The model is programmed once (``weight_stationary=True``, key
    ``PRNGKey(0)``, the steps' static serving key) unless ``programmed``
    is given; ``weight_stationary=False`` programs every call on the fly
    from the same keys, which gives the same bits.  The dense cache
    (``max_len`` default ``S + n_steps + 1``) is updated in place.
    ``t_now`` (device-clock seconds) ages drifting programmed state.
    ``sampling`` (a :class:`~repro_torch.serve.sampling.SamplingParams`)
    draws token ``i`` of every row with ``fold_in(PRNGKey(seed), i)``
    instead of the argmax; ``temperature=0`` is the argmax.  ``jit_steps``
    is accepted and does nothing (eager PyTorch); ``mesh`` is not
    ported."""
    if mesh is not None:
        raise NotImplementedError("greedy_generate(mesh=) is not ported to repro_torch yet")
    b, s = prompt_tokens.shape
    ml = max_len or (s + n_steps + 1)
    batch = {"tokens": prompt_tokens}
    if extra_batch:
        batch.update(extra_batch)
    if programmed is None and weight_stationary and policy is not None:
        programmed = program_params(params, cfg, policy, PRNGKey(0), kernels=kernels)
    prefill = make_prefill_step(
        cfg, policy, max_len=ml, compute_dtype=compute_dtype,
        cache_dtype=torch.float32 if compute_dtype == torch.float32 else torch.bfloat16,
        kernels=kernels,
    )
    decode = make_decode_step(cfg, policy, compute_dtype=compute_dtype, kernels=kernels)
    if sampling is None:
        def pick(logits, i):
            return torch.argmax(logits, dim=-1)
    else:
        keys = request_keys(sampling.seed, n_steps + 1)

        def pick(logits, i):
            return sample_rows(np.repeat(keys[i][None], b, axis=0), logits,
                               [sampling.temperature] * b, [sampling.top_k] * b,
                               [sampling.top_p] * b)
    logits, cache = prefill(params, batch, programmed, t_now)
    rows = [logits]
    out = []
    tok = pick(logits, 0)
    for i in range(n_steps):
        out.append(tok)
        logits, cache = decode(params, cache, tok, programmed, None, t_now)
        rows.append(logits)
        tok = pick(logits, i + 1)
    out.append(tok)
    tokens = torch.stack(out, dim=1).to(torch.int32)
    if collect_logits:
        return tokens, torch.stack(rows, dim=1)
    return tokens
