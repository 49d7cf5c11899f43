"""Hardware layers — MemIntelli §3.4, Fig. 8 (port of
``repro/core/layers.py``).

``mem_matmul`` is the paper's "hardware function": the forward pass runs
through the simulated DPE, the backward pass applies the incoming error
to the full-precision operands (straight-through estimator), so a model
trains through it.  ``mem_linear`` is the paper's ``LinearMem``: the
product runs through the simulated DPE (or digitally) and the bias is
added digitally.  ``MemPolicy`` resolves every layer name to its own
``DPEConfig`` (or ``None`` → digital): layer-wise mixed precision.
"""
from __future__ import annotations

import re
import zlib
from dataclasses import dataclass, field

import torch

from .dpe import FoldedWeight, PreparedWeight, dpe_apply, dpe_matmul
from .engine import DPEConfig
from .prng import fold_in

__all__ = [
    "mem_matmul",
    "mem_matmul_prepared",
    "mem_linear",
    "MemPolicy",
    "layer_key",
    "DIGITAL",
]


class _MemMatmul(torch.autograd.Function):
    """Forward through the DPE; straight-through backward (reference
    ``layers.py::_bwd``): ``gx = g @ w.T`` in g's dtype, cast to x's;
    ``gw = x.T @ g`` in float32 over the flattened leading dims, cast to
    w's dtype; no gradient for the key or the configuration."""

    @staticmethod
    def forward(ctx, x, w, key, cfg, kernels):
        ctx.save_for_backward(x, w)
        return dpe_matmul(x, w, cfg, key, kernels).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = (g @ w.t().to(g.dtype)).to(x.dtype)
        k = x.shape[-1]
        gw = x.reshape(-1, k).t().float() @ g.reshape(-1, g.shape[-1]).float()
        return gx, gw.to(w.dtype), None, None, None


def mem_matmul(x: torch.Tensor, w: torch.Tensor, key, cfg: DPEConfig,
               kernels: bool = True) -> torch.Tensor:
    """Simulated-hardware ``x @ w`` (``(..., K) @ (K, N)``) with the
    straight-through backward; ``key`` drives programming noise.
    Returns ``x``'s dtype."""
    return _MemMatmul.apply(x, w, key, cfg, kernels)


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
    key,
    prepared: PreparedWeight | FoldedWeight | None = None,
    kernels: bool = True,
) -> torch.Tensor:
    """Hardware matmul + (digital) bias.  ``prepared`` skips the per-call
    weight pipeline; without it the weight is programmed on the fly with
    ``key`` through :func:`mem_matmul` (straight-through gradients)."""
    if cfg is None or cfg.mode == "digital":
        y = x @ w.to(x.dtype)
    elif prepared is not None:
        y = mem_matmul_prepared(x, prepared, w.shape[1], cfg, kernels)
    else:
        y = mem_matmul(x, w, key, cfg, kernels)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def layer_key(base, name: str):
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
