"""Serving steps: chunked prefill and the slot-parallel decode step
(port of ``make_chunk_prefill`` / ``make_decode_step`` of
``repro/serve/engine.py``).

Programming noise is static across steps (devices are programmed once
for inference): the base key is ``PRNGKey(0)``.  PyTorch runs eagerly,
so the step makers return plain closures (no jit).  ``kernels=False``
is the explicit plain-version override.
"""
from __future__ import annotations

import torch

from repro_torch.core.layers import DIGITAL, MemPolicy
from repro_torch.core.prng import PRNGKey
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import decode_step, prefill_chunk_step

__all__ = ["make_chunk_prefill", "make_decode_step"]


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

    def chunk_fn(params, cache, tokens, slot, start, n_valid, final, programmed=None):
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

    def decode_fn(params, cache, tokens, programmed=None, active=None):
        return decode_step(
            params, cfg, cache, tokens, policy=policy, rng=rng,
            compute_dtype=compute_dtype, programmed=programmed, active=active,
            kernels=kernels,
        )

    return decode_fn
