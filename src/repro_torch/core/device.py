"""Memristor device model — MemIntelli §3.2, Eq. (1), Fig. 3 (port of
``repro/core/device.py``).

Conductances are log-normal with coefficient of variation
``cv = std(G)/mean(G)``: ``sigma = sqrt(ln(cv^2 + 1))`` and the
mean-preserving ``mu = ln(E[G]) - sigma^2/2``.  A b-bit slice value maps
linearly onto ``[LGS, HGS]``; programming noise is one multiplicative
log-normal sample per cell.  The normal draws are the reference's
``jax.random.normal`` bits (:mod:`repro_torch.core.prng`), drawn on the
weight's device, and ``log`` / ``exp`` are XLA's (:mod:`.xmath`) in the
reference's float32 expression order, so programming is a pure function
of ``(w, cfg, key)`` and equals the reference's eager programming bit
for bit.  :func:`noisy_slice_values` is the plain version of K6
(``kernels/program_noise.py``), which runs the same round trip in one
kernel on the card; ``core.dpe`` programs through
``kernels.ops.program_noise``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import xmath
from .prng import normal
from .quant import div

__all__ = [
    "slice_to_conductance",
    "conductance_to_slice",
    "lognormal_program",
    "lognormal_sigma",
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


@functools.lru_cache(maxsize=None)
def lognormal_sigma(cv: float) -> tuple[float, float]:
    """``(sigma**2 / 2, sigma)`` for the coefficient of variation ``cv``,
    float32 values as the reference computes them (XLA's ``log`` of the
    float32 ``cv**2 + 1``, a correctly rounded square root, the products
    in float32), on the host, once per ``cv``."""
    s2 = xmath.log(torch.tensor(np.float32(cv * cv + 1.0)))
    sigma = torch.sqrt(s2.double()).float()  # correctly rounded, as XLA's
    half_s2 = (0.5 * sigma) * sigma
    return float(half_s2), float(sigma)


def lognormal_program(key, g: torch.Tensor, cv: float) -> torch.Tensor:
    """Sample programmed conductances around target ``g`` with
    coefficient of variation ``cv`` (Eq. 1, mean-preserving); ``key`` is
    a :mod:`repro_torch.core.prng` key."""
    if cv <= 0.0:
        return g
    half_s2, sigma = lognormal_sigma(float(cv))
    mu = xmath.log(torch.clamp_min(g, 1e-30)) - half_s2
    z = normal(key, g.shape, device=g.device)
    return xmath.exp(mu + sigma * z)


def noisy_slice_values(
    key, v: torch.Tensor, bits: int, hgs: float, lgs: float, cv: float
) -> torch.Tensor:
    """Programming-noise round trip: slice ints -> conductances ->
    log-normal programming -> float slice values."""
    if cv <= 0.0:
        return v.to(torch.float32)
    g = slice_to_conductance(v, bits, hgs, lgs)
    return conductance_to_slice(lognormal_program(key, g, cv), bits, hgs, lgs)
