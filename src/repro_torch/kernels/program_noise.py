"""K6 — programming noise: CUDA kernel and plain version.

The programming of a noisy crossbar slice plane, the round trip
``slice value -> conductance -> log-normal sample -> slice value`` of
``core/device.py::noisy_slice_values``, in one kernel
(``csrc/program_noise.cu``).  It replaces no Pallas kernel: the
reference runs ``repro/core/device.py::lognormal_program`` (:62-69) and
``jax.random.normal`` as XLA-fused code.  The plain version is
``noisy_slice_values`` itself, which draws the reference's threefry bits
(:mod:`repro_torch.core.prng`) and evaluates XLA's ``log`` / ``exp`` /
``erf_inv`` polynomials (:mod:`repro_torch.core.xmath`) as a few dozen
whole-plane PyTorch operations; the kernel runs the same operations per
cell in registers with native ``fmaf`` and equals it bit for bit.

Bound on an H100: 8 B of traffic per cell (the slice value in, the noisy
value out) and about 200 32-bit integer and float operations per cell
(20 threefry rounds, the log1p / erf_inv / log / exp polynomials), so
operations at the CUDA cores' rate: about 3 ns per thousand cells.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.device import lognormal_sigma, noisy_slice_values
from repro_torch.core.prng import _as_key

from .build import LaunchCounter, check, library

__all__ = ["program_noise_ref", "program_noise_cuda", "noise_scalars", "counter"]

counter = LaunchCounter("program_noise")
program_noise_ref = noisy_slice_values


@functools.lru_cache(maxsize=None)
def noise_scalars(bits: int, hgs: float, lgs: float, cv: float):
    """The float32 scalars of one slice width's round trip, as the plain
    version uses them: ``(lgs, dg, sigma**2/2, sigma)``."""
    dg = np.float32((hgs - lgs) / (2.0**bits - 1.0))
    half_s2, sigma = lognormal_sigma(float(cv))
    return np.float32(lgs), dg, np.float32(half_s2), np.float32(sigma)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = library().program_noise_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # v, out, n
        ctypes.c_uint, ctypes.c_uint,  # key words
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,  # lgs, dg, s2/2, sigma
        ctypes.c_void_p,  # stream
    ]
    return fn


def program_noise_cuda(key, v: torch.Tensor, bits: int, hgs: float, lgs: float,
                       cv: float) -> torch.Tensor:
    """Launch K6 on the card: ``v`` a contiguous float32 CUDA tensor of
    slice values, ``key`` the slice's :mod:`~repro_torch.core.prng` key,
    ``cv > 0``.  Returns the noisy slice values, same shape."""
    who = "program_noise_cuda"
    if not v.is_cuda or v.dtype != torch.float32 or not v.is_contiguous():
        raise ValueError(f"{who}: v must be a contiguous float32 CUDA tensor")
    if cv <= 0.0:
        raise ValueError(f"{who}: cv={cv} draws no noise")
    k1, k2 = _as_key(key)
    lgs32, dg, half_s2, sigma = noise_scalars(bits, hgs, lgs, cv)
    out = torch.empty_like(v)
    if v.numel() == 0:
        return out
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = _entry()(v.data_ptr(), out.data_ptr(), v.numel(), k1, k2, float(lgs32),
                      float(dg), float(half_s2), float(sigma), stream)
    check(rc, who)
    counter.count += 1
    return out
