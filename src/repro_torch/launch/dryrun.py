"""The serving policies of the launchers (port of
``repro/launch/dryrun.py::make_policy``).

Only :func:`make_policy` is ported: the rest of ``dryrun`` (lowering
every architecture and shape on the production meshes, memory and
roofline reports) is ROADMAP item A7.
"""
from __future__ import annotations

from repro_torch.core import DPEConfig, MemPolicy, spec

__all__ = ["make_policy"]


def make_policy(mode: str) -> MemPolicy:
    """``digital``: no hardware layer.  ``mem_fast`` / ``mem_faithful``:
    every projection on int8 x int8 slices over 128x128 crossbar tiles,
    a bf16 store, the backend ``auto`` (the fused sliced matmul with the
    ``dynamic`` ADC ranging over 128-row tiles) and the default
    ``dynamic`` ADC; a MoE ``router`` stays digital."""
    if mode == "digital":
        return MemPolicy(default=None)
    cfg = DPEConfig(
        input_spec=spec("int8"),
        weight_spec=spec("int8"),
        array_size=(128, 128),
        mode="fast" if mode == "mem_fast" else "faithful",
        store_dtype="bf16",
        backend="auto",
    )
    return MemPolicy(default=cfg, overrides=(("router", None),))
