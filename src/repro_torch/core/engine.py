"""Dot-Product-Engine configuration — MemIntelli Table 2 defaults (port of
``repro/core/engine.py``).

``DPEConfig`` is frozen and hashable and is stored per layer, which is
what makes layer-wise mixed precision work.  ``drift`` (a
:class:`~repro_torch.core.drift.DriftModel`, or ``None``) ages the
programmed state by the device clock the serve loop publishes.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

from .presets import INT8
from .slicing import SliceSpec

__all__ = ["DPEConfig"]


@dataclass(frozen=True)
class DPEConfig:
    """Hardware + precision configuration of one dot-product engine.

    Defaults are the paper's Table 2 (HGS=1e-5 S, LGS=1e-7 S, 16 levels,
    cv=5%, 8-bit DAC, 10-bit ADC, 64x64 arrays).  Field meanings are the
    reference's; ``backend``:

    * ``"xla"`` (the default, as in the reference) — the reference's
      vectorized engine: a ``"dynamic"`` ADC range spans every row of
      the call.  Faithful layers compute it with the fused sliced matmul
      (:func:`repro_torch.kernels.ops.fused_sliced_matmul`: the CUDA
      kernel on a CUDA tensor, its plain version on the CPU) with one
      row tile that covers the whole call, which is the same function;
    * ``"auto"`` / ``"pallas"`` — the reference's kernel path: the same
      fused sliced matmul, with the ``"dynamic"`` range over each
      128-row tile (the two differ only past 128 rows);
    * ``"circuit"`` — the IR-drop circuit model, not ported yet.
    """

    hgs: float = 1e-5
    lgs: float = 1e-7
    g_levels: int = 16
    var: float = 0.05
    rdac: int = 256
    radc: int = 1024
    array_size: tuple[int, int] = (64, 64)
    input_spec: SliceSpec = INT8
    weight_spec: SliceSpec = INT8
    mode: str = "faithful"
    adc_mode: str = "dynamic"
    noise_mode: str = "program"
    backend: str = "xla"
    store_dtype: str = "f32"
    drift: Any = None

    def __post_init__(self):
        if self.mode not in ("faithful", "fast", "digital"):
            raise ValueError(f"bad mode {self.mode!r}")
        if self.adc_mode not in ("dynamic", "dynamic_row", "fullscale"):
            raise ValueError(f"bad adc_mode {self.adc_mode!r}")
        if self.noise_mode not in ("program", "off"):
            raise ValueError(f"bad noise_mode {self.noise_mode!r}")
        if self.backend not in ("xla", "pallas", "circuit", "auto"):
            raise ValueError(f"bad backend {self.backend!r}")
        if self.store_dtype not in ("f32", "bf16"):
            raise ValueError(f"bad store_dtype {self.store_dtype!r}")
        for spec in (self.input_spec, self.weight_spec):
            if 2 ** max(spec.bits) > self.g_levels and self.mode != "digital":
                raise ValueError(
                    f"slice width {max(spec.bits)}b needs "
                    f"{2 ** max(spec.bits)} conductance levels but device "
                    f"has g_levels={self.g_levels}"
                )
        if self.hgs <= self.lgs:
            raise ValueError("need HGS > LGS")

    @property
    def cv(self) -> float:
        return 0.0 if self.noise_mode == "off" else self.var

    @property
    def row_independent(self) -> bool:
        """True when one input row's output never depends on the other
        rows of the same call (everything but faithful ``"dynamic"``)."""
        return self.mode != "faithful" or self.adc_mode != "dynamic"

    def replace(self, **kw) -> "DPEConfig":
        return replace(self, **kw)

