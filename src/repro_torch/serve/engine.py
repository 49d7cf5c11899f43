"""Serving steps: chunked prefill, the slot-parallel decode step and the
speculative verify step (port of ``make_chunk_prefill`` /
``make_decode_step`` / ``make_verify_step`` of ``repro/serve/engine.py``).

Programming noise is static across steps (devices are programmed once
for inference): the base key is ``PRNGKey(0)``.  PyTorch runs eagerly,
so the step makers return plain closures (no jit).  Each step takes the
device-clock time ``t_now`` (None: no drift evaluation) and publishes it
to the programmed layers through :func:`~repro_torch.core.drift.drift_clock`.
``kernels=False`` is the explicit plain-version override.
"""
from __future__ import annotations

import torch

from repro_torch.core.drift import drift_clock
from repro_torch.core.layers import DIGITAL, MemPolicy
from repro_torch.core.prng import PRNGKey
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import decode_step, decode_verify_step, prefill_chunk_step

__all__ = ["make_chunk_prefill", "make_decode_step", "make_verify_step"]


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
