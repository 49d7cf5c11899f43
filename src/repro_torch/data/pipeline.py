"""Deterministic synthetic data (port of ``repro/data/pipeline.py``):
tokens are a function of ``(seed, step)`` through threefry, drawn with
the reference's keys (:mod:`repro_torch.core.prng`), so the port's batch
is the reference's bit for bit.

Each field draws with ``fold_in(fold_in(PRNGKey(seed), step), hash(name)
& 0x7FFF)``, as the reference does.  Python salts ``str`` hashes per
process, so a field's key, and with it the batch, is the same only
within one process (or with ``PYTHONHASHSEED`` fixed): the reference's
"restart-safe" claim holds only so.  ``batch_specs`` and
``host_local_batch`` are mesh-bound (ROADMAP item A7).
"""
from __future__ import annotations

import torch

from repro_torch.core.prng import PRNGKey, fold_in, normal, randint
from repro_torch.models.config import ArchConfig

__all__ = ["batch_shapes", "synthetic_batch"]


def _text_len(cfg: ArchConfig, seq: int) -> int:
    if cfg.vision_prefix:
        return seq - cfg.vision_prefix
    return seq


def batch_shapes(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """``{name: (shape, dtype)}`` of a training batch."""
    s = _text_len(cfg, seq)
    shapes = {
        "tokens": ((batch, s), torch.int32),
        "labels": ((batch, s), torch.int32),
    }
    if cfg.vision_prefix:
        shapes["patch_embeds"] = ((batch, cfg.vision_prefix, cfg.d_model), torch.bfloat16)
    if cfg.encoder is not None:
        shapes["frames"] = ((batch, cfg.encoder.n_frames, cfg.d_model), torch.bfloat16)
    return shapes


def synthetic_batch(cfg: ArchConfig, batch: int, seq: int, step: int, seed=0,
                    device="cuda") -> dict:
    """The full global batch of ``step`` on ``device``: uniform tokens in
    ``[0, vocab)`` and their next-token shift as labels (the last label
    wraps to the row's first token)."""
    key = fold_in(PRNGKey(seed), step)
    out = {}
    for name, (shape, dt) in batch_shapes(cfg, batch, seq).items():
        k = fold_in(key, hash(name) & 0x7FFF)
        if dt == torch.int32:
            out[name] = randint(k, shape, 0, cfg.vocab, device=device)
        else:
            out[name] = (normal(k, shape, device=device) * 0.02).to(dt)
    out["labels"] = torch.cat([out["tokens"][:, 1:], out["tokens"][:, :1]], dim=1)
    return out
