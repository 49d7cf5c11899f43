"""Hardware layers — MemIntelli §3.4, Fig. 8 (port of
``repro/core/layers.py``, inference only).

``mem_linear`` is the paper's ``LinearMem``: the product runs through the
simulated DPE (or digitally) and the bias is added digitally.
``MemPolicy`` resolves every layer name to its own ``DPEConfig`` (or
``None`` → digital): layer-wise mixed precision.  The straight-through
``autograd.Function`` of the training path is not ported yet.
"""
from __future__ import annotations

import re
import zlib
from dataclasses import dataclass, field

import torch

from .dpe import FoldedWeight, PreparedWeight, dpe_apply, dpe_matmul
from .engine import DPEConfig
from .rng import fold_in

__all__ = ["mem_matmul_prepared", "mem_linear", "MemPolicy", "layer_key", "DIGITAL"]


def mem_matmul_prepared(
    x: torch.Tensor,
    prog: PreparedWeight | FoldedWeight,
    n: int,
    cfg: DPEConfig,
    kernels: bool = True,
) -> torch.Tensor:
    """Weight-stationary ``x @ w`` through programmed crossbar state,
    returned in ``x``'s dtype."""
    return dpe_apply(x, prog, n, cfg, kernels).to(x.dtype)


def mem_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None,
    cfg: DPEConfig | None,
    key: int,
    prepared: PreparedWeight | FoldedWeight | None = None,
    kernels: bool = True,
) -> torch.Tensor:
    """Hardware matmul + (digital) bias.  ``prepared`` skips the per-call
    weight pipeline; without it the weight is programmed on the fly with
    ``key`` (inference semantics, no gradient)."""
    if cfg is None or cfg.mode == "digital":
        y = x @ w.to(x.dtype)
    elif prepared is not None:
        y = mem_matmul_prepared(x, prepared, w.shape[1], cfg, kernels)
    else:
        y = dpe_matmul(x, w, cfg, key, kernels).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def layer_key(base: int, name: str) -> int:
    """Deterministic per-layer key (stable across processes)."""
    return fold_in(base, zlib.crc32(name.encode()) & 0x7FFFFFFF)


@dataclass(frozen=True)
class MemPolicy:
    """Layer-wise precision policy (paper Fig. 9): ``default`` for every
    hardware layer, ``overrides`` an ordered ``(regex, DPEConfig | None)``
    tuple — first match wins, ``None`` = digital."""

    default: DPEConfig | None = None
    overrides: tuple[tuple[str, DPEConfig | None], ...] = field(
        default_factory=tuple
    )

    def config_for(self, name: str) -> DPEConfig | None:
        for pattern, cfg in self.overrides:
            if re.search(pattern, name):
                return cfg
        return self.default

    @property
    def enabled(self) -> bool:
        if self.default is not None and self.default.mode != "digital":
            return True
        return any(
            c is not None and c.mode != "digital" for _, c in self.overrides
        )

    def configs(self):
        """Every DPEConfig the policy can resolve to (None included)."""
        return (self.default,) + tuple(c for _, c in self.overrides)


DIGITAL = MemPolicy(default=None)
