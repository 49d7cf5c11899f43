"""JAX's threefry-2x32 keys and random bits (port of ``jax.random`` under
``jax_threefry_partitionable``, which ``repro/core/device.py`` switches on).

A key is host data: a numpy ``uint32`` array of shape ``(2,)``, exactly
the contents of the reference's ``jax.random.PRNGKey`` key.  Key
arithmetic (:func:`PRNGKey`, :func:`fold_in`, :func:`split`) runs on the
host in exact integer arithmetic and gives the reference's keys bit for
bit.  Bulk draws (:func:`random_bits`, :func:`uniform`, :func:`normal`,
:func:`randint`, :func:`permutation`) run on the device of the caller's choice, on
``int64`` tensors holding 32-bit values, in chunks of ``_CHUNK``
elements, so a draw for a 136 M-element weight never holds more than a
few chunk-sized temporaries.

``random_bits``, ``uniform``, ``normal``, ``gumbel`` and ``randint`` equal
JAX's bit for bit (``tests/test_torch_prng.py``, ``tests/test_torch_sampling.py``):
``normal`` is ``sqrt(2) * erf_inv(u)`` with XLA's float32 ``erf_inv``
and ``gumbel`` is ``-log(-log(u))`` with its ``log`` (:mod:`.xmath`).  Every step is an
integer or an IEEE float32 / float64 operation, so the card draws the
same bits as the CPU.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .xmath import erf_inv, fma, log

__all__ = [
    "PRNGKey",
    "fold_in",
    "split",
    "random_bits",
    "uniform",
    "normal",
    "gumbel",
    "categorical",
    "randint",
    "permutation",
    "choice",
]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_CHUNK = 1 << 24  # elements drawn per pass on the device



def _threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, of the counter pairs ``(x1, x2)`` under
    the key ``(k1, k2)``.  Works on Python ints, numpy ``uint64`` arrays
    and torch ``int64`` tensors holding 32-bit values (every step is
    masked back to 32 bits)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _M32
            x2 = x2 ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + (ks[(i + 2) % 3] + i + 1)) & _M32
    return x1, x2


def _as_key(key) -> tuple[int, int]:
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise ValueError(f"a key is a uint32 array of shape (2,), got {k.dtype} {k.shape}")
    return int(k[0]), int(k[1])


def _key(a: int, b: int) -> np.ndarray:
    return np.array([a, b], dtype=np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the words ``(0, seed mod 2**32)``."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**32:
        raise ValueError(f"seed {seed} is outside the 32-bit range")
    return _key(0, seed & _M32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)``."""
    data = int(data)
    if not 0 <= data <= _M32:
        raise ValueError(f"fold_in data {data} is not a uint32")
    k1, k2 = _as_key(key)
    a, b = _threefry2x32(k1, k2, 0, data)
    return _key(a, b)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (partitionable): key ``i`` is the hash of the
    counter pair ``(0, i)``.  Returns ``(num, 2)`` uint32."""
    k1, k2 = _as_key(key)
    lo = np.arange(num, dtype=np.uint64)
    a, b = _threefry2x32(k1, k2, np.zeros_like(lo), lo)
    return np.stack([a, b], axis=1).astype(np.uint32)


def _chunks(n: int):
    for c0 in range(0, n, _CHUNK):
        yield c0, min(n, c0 + _CHUNK)


def _bits(k1: int, k2: int, c0: int, c1: int, device) -> torch.Tensor:
    """32-bit draws for the flat positions ``c0..c1-1`` (int64 holding
    uint32 values): the partitionable layout hashes the position's
    64-bit index split into (high, low) words and xors the two outputs."""
    count = torch.arange(c0, c1, dtype=torch.int64, device=device)
    a, b = _threefry2x32(k1, k2, count >> 32, count & _M32)
    return a ^ b


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor."""
    k1, k2 = _as_key(key)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.int64, device=device)
    for c0, c1 in _chunks(n):
        out[c0:c1] = _bits(k1, k2, c0, c1, device)
    return out.reshape(shape)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 in [0, 1) from 32 random bits: the top 23 bits as
    the mantissa of a float in [1, 2), minus one."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _uniform_chunk(bits, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``max(lo, f * (hi - lo) + lo)`` with the multiply-add fused, as
    XLA contracts it (float64 holds the float32 product exactly)."""
    return torch.maximum(lo, fma(_unit_floats(bits), hi - lo, lo))


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    k1, k2 = _as_key(key)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    lo = torch.tensor(np.float32(minval), device=device)
    hi = torch.tensor(np.float32(maxval), device=device)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for c0, c1 in _chunks(n):
        out[c0:c1] = _uniform_chunk(_bits(k1, k2, c0, c1, device), lo, hi)
    return out.reshape(shape)


def normal(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``:
    ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on ``(-1, 1)``."""
    k1, k2 = _as_key(key)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    lo = torch.tensor(np.nextafter(np.float32(-1), np.float32(0)), device=device)
    hi = torch.tensor(np.float32(1), device=device)
    sqrt2 = torch.tensor(np.float32(np.sqrt(2)), device=device)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for c0, c1 in _chunks(n):
        u = _uniform_chunk(_bits(k1, k2, c0, c1, device), lo, hi)
        out[c0:c1] = sqrt2 * erf_inv(u)
    return out.reshape(shape)


_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (its default ``"low"``
    mode): ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)`` and
    XLA's float32 ``log``."""
    u = uniform(key, shape, minval=_TINY, maxval=1.0, device=device)
    return -log(-log(u))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    first index of ``max(logits + gumbel(key, logits.shape))``."""
    g = gumbel(key, logits.shape, device=logits.device)
    return torch.argmax(g + logits.float(), dim=-1)


def randint(key, shape, minval: int, maxval: int, device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    32-bit draws from ``split(key)``, ``higher`` and ``lower``; with
    ``span = maxval - minval`` (1 where ``maxval <= minval``) and
    ``mult = (2**16 mod span)**2 mod 2**32 mod span``, the value is
    ``minval + ((higher mod span) * mult + lower mod span) mod 2**32 mod
    span``, every step in uint32 arithmetic as JAX's ``_randint``."""
    lo_v, hi_v = int(minval), int(maxval)
    i32 = np.iinfo(np.int32)
    if not (i32.min <= lo_v <= i32.max and i32.min <= hi_v <= i32.max):
        raise ValueError(f"randint bounds [{lo_v}, {hi_v}) leave the int32 range")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape, device), random_bits(k2, shape, device)
    span = (hi_v - lo_v) & _M32 if hi_v > lo_v else 1
    mult = ((2**16 % span) ** 2 & _M32) % span
    off = (((higher % span) * mult + lower % span) & _M32) % span
    return (off + lo_v).to(torch.int32)


def permutation(key, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` sorted by fresh
    32-bit keys, ``ceil(3 ln n / ln(2**32 - 1))`` times, each round with
    the second key of a split (the sort is stable, as XLA's is)."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_M32)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,), device), stable=True).indices
        x = x[order]
    return x


def choice(key, n: int, shape, replace: bool = False, device="cpu") -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=False)``: the first
    ``prod(shape)`` entries of :func:`permutation`."""
    if replace:
        raise NotImplementedError("choice with replacement is not ported")
    shape = tuple(int(s) for s in shape)
    k = math.prod(shape)
    if k > n:
        raise ValueError(f"cannot take {k} samples from {n} without replacement")
    return permutation(key, n, device)[:k].reshape(shape)
