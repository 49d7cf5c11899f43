"""Integer PRNG keys for seeding ``torch.Generator`` s.

The reference threads ``jax.random`` keys through ``fold_in`` chains
(segment, layer index, ``crc32(layer name)``, slice index).  The port
keeps the same chain over plain Python integers: :func:`fold_in` mixes
one integer into a key with blake2b, so a key is a pure function of the
seed and every folded datum, independent of device, process or call
order.  The bits differ from JAX's threefry (porting threefry is
ROADMAP A6); only the noise *model* is held against the reference.
"""
from __future__ import annotations

import hashlib

import torch

__all__ = ["PRNGKey", "fold_in", "generator"]

_MASK63 = (1 << 63) - 1


def PRNGKey(seed: int) -> int:
    """Base key for an integer seed."""
    return fold_in(0x5EED, int(seed))


def fold_in(key: int, data: int) -> int:
    """A new key derived from ``key`` and the integer ``data``."""
    raw = int(key).to_bytes(8, "little", signed=False) + int(data).to_bytes(
        8, "little", signed=True
    )
    return int.from_bytes(
        hashlib.blake2b(raw, digest_size=8).digest(), "little"
    ) & _MASK63


def generator(key: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``key``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(key) & _MASK63)
    return g
