"""Conductance drift: time-parameterised decay of programmed state (port
of ``repro/core/drift.py``).

A cell programmed to ``G0`` at ``t_prog`` reads back at ``t`` as

    G(t) - LGS = (G0 - LGS) * (1 + dt/t0) ** (-nu)        (power law)
    G(t) - LGS = (G0 - LGS) * exp(-dt/tau)                (exponential)

Both decay the programmable window, so in slice units drift is one
multiplicative factor on the stored slice values (faithful) or on the
folded effective weight (fast).  ``factor(dt <= 0)`` is exactly 1.0, and
``drift=None`` never touches the apply path (the bitwise-off contract).

The factor is a host float32 scalar with the reference's bits as its
serving steps compute it under ``jit``: XLA turns the division by the
constant ``t0`` / ``tau`` into a product with its float32 reciprocal
(fused into the add for the power law), evaluates ``exp`` with its own
polynomial (:func:`repro_torch.core.xmath.exp`) and ``pow`` with the C
library's ``powf`` (what ``torch.pow`` of a CPU scalar calls).

The serve loop samples one device-clock time per iteration and publishes
it with :func:`drift_clock` (a context variable), so the ``dense()``
call sites never thread a ``t_now`` argument; :func:`drift_now` reads it.
"""
from __future__ import annotations

import contextvars
import functools
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from . import xmath

__all__ = ["DriftModel", "drift_clock", "drift_now"]


@dataclass(frozen=True)
class DriftModel:
    """Time-parameterised conductance decay (frozen and hashable, so a
    ``DPEConfig`` carrying one stays hashable).

    kind: ``"power"`` — ``(1 + dt/t0) ** -nu`` (``nu`` the drift
          coefficient, ``t0`` the normalisation time in device-clock
          seconds); ``"exp"`` — ``exp(-dt/tau)``.
    """

    kind: str = "power"
    nu: float = 0.05
    t0: float = 1.0
    tau: float = 1.0

    def __post_init__(self):
        if self.kind not in ("power", "exp"):
            raise ValueError(f"bad drift kind {self.kind!r}")
        if self.kind == "power" and (self.nu < 0.0 or self.t0 <= 0.0):
            raise ValueError("power drift needs nu >= 0 and t0 > 0")
        if self.kind == "exp" and self.tau <= 0.0:
            raise ValueError("exp drift needs tau > 0")

    def factor(self, dt) -> np.float32:
        """Decay of the programmable window after ``dt`` seconds, a
        float32 scalar; exactly 1.0 at ``dt <= 0``."""
        return _factor(self, float(max(np.float32(dt), np.float32(0.0))))


@functools.lru_cache(maxsize=4096)
def _factor(model: DriftModel, dt: float) -> np.float32:
    """:meth:`DriftModel.factor` of a float32 age (cached: every
    projection of a serving step reads the same one)."""
    one = np.float32(1.0)
    d = torch.tensor(np.float32(dt))
    if model.kind == "power":
        base = xmath.fma(d, torch.tensor(one / np.float32(model.t0)), torch.tensor(one))
        f = torch.pow(base, torch.tensor(np.float32(-model.nu)))
    else:
        f = xmath.exp(-d * torch.tensor(one / np.float32(model.tau)))
    return np.float32(f.item())


_NOW: contextvars.ContextVar = contextvars.ContextVar("drift_now", default=None)


@contextmanager
def drift_clock(t_now):
    """Publish the device-clock time for drift evaluation within the
    block (``None`` is a no-op)."""
    if t_now is None:
        yield
        return
    token = _NOW.set(np.float32(t_now))
    try:
        yield
    finally:
        _NOW.reset(token)


def drift_now():
    """The published device-clock time, or ``None`` outside any
    :func:`drift_clock` block."""
    return _NOW.get()
