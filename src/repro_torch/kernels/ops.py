"""The port's one kernel dispatch point.

Every kernel of the port is reached through a function here:

* a tensor on a CUDA device goes to the hand-written kernel (which
  launches or raises — it never falls back);
* a tensor on the CPU goes to the kernel's plain PyTorch version;
* ``kernels=False`` is the explicit plain-version override (the A/B
  comparison of ``chip_smoke.py``); there is no global switch and no
  environment variable.

``COUNTERS`` are the launch counters of the kernel wrappers (K1-K6, and
K1 on an expert stack apart).
"""
from __future__ import annotations

import torch

from repro_torch.core.slicing import SliceSpec

from . import flash_attention as _fa
from . import paged_attention as _pa
from . import program_noise as _pn
from . import sliced_matmul as _sm
from .ref import sliced_matmul_ref

__all__ = [
    "fused_sliced_matmul",
    "sliced_matmul",
    "paged_decode_attention",
    "paged_chunk_attention",
    "flash_attention",
    "program_noise",
    "COUNTERS",
    "reset_counters",
]

COUNTERS = {
    c.name: c
    for c in (_sm.counter, _sm.stack_counter, _pa.decode_counter, _pa.chunk_counter,
              _sm.staged_counter, _fa.counter, _pn.counter)
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
    bm: int = 128,
    drift: float = 1.0,
    kernels: bool = True,
) -> torch.Tensor:
    """Fused faithful DPE matmul (K1): raw x (M, K) -> (M, Np) float32;
    ``bm`` rows share a ``dynamic`` ADC range; the slices are read times
    the float32 conductance ``drift`` factor.  On an expert stack, x
    (E, M, K), slices (E, Sw, Kp, Np) and scales (E, nk, nn) -> (E, M, Np),
    it is one launch, each expert as the call on it alone."""
    kw = dict(
        input_spec=input_spec, weight_spec=weight_spec, array_size=array_size,
        rdac=rdac, radc=radc, adc_mode=adc_mode, bm=bm, drift=drift,
    )
    if _use_kernel(x, kernels):
        return _sm.fused_sliced_matmul_cuda(x.contiguous(), ws, sw, **kw)
    return _sm.fused_sliced_matmul_ref(x, ws, sw, **kw)


def sliced_matmul(
    xs: torch.Tensor,
    sx: torch.Tensor,
    ws: torch.Tensor,
    sw: torch.Tensor,
    *,
    input_spec: SliceSpec,
    weight_spec: SliceSpec,
    array_size: tuple[int, int],
    radc: int,
    adc_mode: str,
    bm: int = 128,
    kernels: bool = True,
) -> torch.Tensor:
    """Staged faithful DPE matmul (K4) on operands sliced by
    ``core.dpe.prepare_input``: xs (Sx, M, Kp), sx (M, nk) -> (M, Np)
    float32.  M is padded with zero rows to a multiple of ``bm`` and the
    padding sliced off, as the reference wrapper does."""
    m = xs.shape[1]
    pad = (-m) % bm
    if pad:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, pad))
        sx = torch.nn.functional.pad(sx, (0, 0, 0, pad))
    kw = dict(
        input_spec=input_spec, weight_spec=weight_spec, array_size=array_size,
        radc=radc, adc_mode=adc_mode, bm=bm,
    )
    if _use_kernel(xs, kernels):
        y = _sm.staged_sliced_matmul_cuda(xs.contiguous(), sx.contiguous(), ws, sw, **kw)
    else:
        y = sliced_matmul_ref(xs, sx, ws, sw, **kw)
    return y[:m] if pad else y


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


def flash_attention(q, k, v, *, causal=True, window=0, bq=64, bk=64, kernels=True):
    """Flash attention (K5): q (BH, Sq, dh), k / v (BH, Skv, dh), float32
    or bfloat16 -> (BH, Sq, dh) in q's dtype.  ``bq`` / ``bk`` are the
    kernel's query and key tiles, 64 rows each (the plain version takes
    no tiles)."""
    if _use_kernel(q, kernels):
        return _fa.flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, bq=bq, bk=bk,
        )
    return _fa.flash_attention_ref(q, k, v, causal=causal, window=window)


def program_noise(key, v, *, bits, hgs, lgs, cv, kernels=True):
    """Programming noise of one slice plane (K6): float32 slice values
    ``v`` of a ``bits``-wide slice -> noisy slice values, drawn with the
    :mod:`~repro_torch.core.prng` key ``key``."""
    if cv <= 0.0:
        return v.to(torch.float32)
    if _use_kernel(v, kernels):
        return _pn.program_noise_cuda(key, v.to(torch.float32).contiguous(), bits, hgs, lgs, cv)
    return _pn.program_noise_ref(key, v, bits, hgs, lgs, cv)
