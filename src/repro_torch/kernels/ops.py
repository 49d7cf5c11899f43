"""The port's one kernel dispatch point.

Every kernel of the serving path is reached through a function here:

* a tensor on a CUDA device goes to the hand-written kernel (which
  launches or raises — it never falls back);
* a tensor on the CPU goes to the kernel's plain PyTorch version;
* ``kernels=False`` is the explicit plain-version override (the A/B
  comparison of ``chip_smoke.py``); there is no global switch and no
  environment variable.

``COUNTERS`` are the launch counters of the three kernel wrappers.
"""
from __future__ import annotations

import torch

from repro_torch.core.slicing import SliceSpec

from . import paged_attention as _pa
from . import sliced_matmul as _sm

__all__ = [
    "fused_sliced_matmul",
    "paged_decode_attention",
    "paged_chunk_attention",
    "COUNTERS",
    "reset_counters",
]

COUNTERS = {
    c.name: c for c in (_sm.counter, _pa.decode_counter, _pa.chunk_counter)
}


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


def _use_kernel(t: torch.Tensor, kernels: bool) -> bool:
    if t.device.type == "cuda":
        return bool(kernels)
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def fused_sliced_matmul(
    x: torch.Tensor,
    ws: torch.Tensor,
    sw: torch.Tensor,
    *,
    input_spec: SliceSpec,
    weight_spec: SliceSpec,
    array_size: tuple[int, int],
    rdac: int,
    radc: int,
    adc_mode: str,
    kernels: bool = True,
) -> torch.Tensor:
    """Fused faithful DPE matmul (K1): raw x (M, K) -> (M, Np) float32."""
    kw = dict(
        input_spec=input_spec, weight_spec=weight_spec, array_size=array_size,
        rdac=rdac, radc=radc, adc_mode=adc_mode,
    )
    if _use_kernel(x, kernels):
        return _sm.fused_sliced_matmul_cuda(x.contiguous(), ws, sw, **kw)
    return _sm.fused_sliced_matmul_ref(x, ws, sw, **kw)


def paged_decode_attention(q, pool_k, pool_v, block_tables, pos, *, window=0, kernels=True):
    """Paged one-token attention (K2)."""
    if _use_kernel(q, kernels):
        return _pa.paged_decode_attention_cuda(
            q.contiguous(), pool_k, pool_v, block_tables, pos, window=window
        )
    return _pa.paged_decode_attention_ref(q, pool_k, pool_v, block_tables, pos, window=window)


def paged_chunk_attention(q, pool_k, pool_v, bt_row, start, n_valid, *, window=0, kernels=True):
    """Paged chunk-prefill attention (K3)."""
    if _use_kernel(q, kernels):
        return _pa.paged_chunk_attention_cuda(
            q.contiguous(), pool_k, pool_v, bt_row, start, n_valid, window=window
        )
    return _pa.paged_chunk_attention_ref(q, pool_k, pool_v, bt_row, start, n_valid, window=window)
