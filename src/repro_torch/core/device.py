"""Memristor device model — MemIntelli §3.2, Eq. (1), Fig. 3 (port of
``repro/core/device.py``).

Conductances are log-normal with coefficient of variation
``cv = std(G)/mean(G)``: ``sigma = sqrt(ln(cv^2 + 1))`` and the
mean-preserving ``mu = ln(E[G]) - sigma^2/2``.  A b-bit slice value maps
linearly onto ``[LGS, HGS]``; programming noise is one multiplicative
log-normal sample per cell.  The normal draws come from a seeded
``torch.Generator`` (:mod:`repro_torch.core.rng`), so programming is a
pure function of ``(w, cfg, key)`` but does not reproduce JAX's bits.
"""
from __future__ import annotations

import math

import torch

from .quant import div
from .rng import generator

__all__ = [
    "slice_to_conductance",
    "conductance_to_slice",
    "lognormal_program",
    "noisy_slice_values",
]


def slice_to_conductance(v: torch.Tensor, bits: int, hgs: float, lgs: float):
    """Linear map of an unsigned b-bit slice value onto [LGS, HGS]."""
    dg = (hgs - lgs) / (2.0**bits - 1.0)
    return lgs + v.to(torch.float32) * dg


def conductance_to_slice(g: torch.Tensor, bits: int, hgs: float, lgs: float):
    """Inverse of :func:`slice_to_conductance` (float-valued: carries the
    analog error into the digital domain)."""
    dg = (hgs - lgs) / (2.0**bits - 1.0)
    return div(g - lgs, dg)


def lognormal_program(key: int, g: torch.Tensor, cv: float) -> torch.Tensor:
    """Sample programmed conductances around target ``g`` with
    coefficient of variation ``cv`` (Eq. 1, mean-preserving)."""
    if cv <= 0.0:
        return g
    sigma = math.sqrt(math.log(cv * cv + 1.0))
    mu = torch.log(torch.clamp_min(g, 1e-30)) - 0.5 * sigma * sigma
    z = torch.randn(
        g.shape, generator=generator(key, g.device), dtype=torch.float32,
        device=g.device,
    )
    return torch.exp(mu + sigma * z)


def noisy_slice_values(
    key: int, v: torch.Tensor, bits: int, hgs: float, lgs: float, cv: float
) -> torch.Tensor:
    """Programming-noise round trip: slice ints -> conductances ->
    log-normal programming -> float slice values."""
    if cv <= 0.0:
        return v.to(torch.float32)
    g = slice_to_conductance(v, bits, hgs, lgs)
    return conductance_to_slice(lognormal_program(key, g, cv), bits, hgs, lgs)
