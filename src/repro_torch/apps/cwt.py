"""Fig. 14: continuous wavelet transform (Morlet) on the DPE (port of
``repro/apps/cwt.py``).

The paper organises the Morlet kernels as a matrix so the sliding
convolutions become one matrix multiplication; the complex kernel's real
and imaginary parts are quantised to signed INT4 and mapped separately
(Fig. 14c); the power spectrum integrates both branches (Fig. 14d).  The
El-Niño NINO3 series is replaced by the reference's synthetic
multi-scale signal (two chirping tones + noise).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps import cli_device
from repro_torch.core import DPEConfig, dpe_matmul, relative_error, spec
from repro_torch.core.prng import PRNGKey


def synthetic_signal(n: int = 512, seed: int = 0, device="cuda"):
    t = np.arange(n) / n
    rng = np.random.default_rng(seed)
    sig = (
        np.sin(2 * np.pi * 12 * t)
        + 0.6 * np.sin(2 * np.pi * (30 + 15 * t) * t)
        + 0.2 * rng.standard_normal(n)
    )
    return torch.tensor(sig, dtype=torch.float32, device=device)


def morlet_bank(n: int, scales, w0: float = 6.0, device="cuda"):
    """Rows: one Morlet wavelet per scale, length n (circular layout)."""
    ts = np.arange(n) - n // 2
    real, imag = [], []
    for s in scales:
        u = ts / s
        env = np.exp(-0.5 * u**2) / np.sqrt(s)
        real.append(env * np.cos(w0 * u))
        imag.append(env * np.sin(w0 * u))
    f32 = lambda a: torch.tensor(np.stack(a), dtype=torch.float32, device=device)  # noqa: E731
    return f32(real), f32(imag)


def cwt_power(sig, real_k, imag_k, matmul):
    """Sliding convolution as matmul: windows (T, n_k) @ kernels.T."""
    n = sig.shape[0]
    nk = real_k.shape[1]
    pad = torch.nn.functional.pad(sig, (nk // 2, nk - nk // 2))
    windows = torch.stack([pad[i:i + nk] for i in range(0, n, 4)])  # stride 4
    re = matmul(windows, real_k.T)
    im = matmul(windows, imag_k.T)
    return re**2 + im**2


def run(n: int = 512, n_scales: int = 24, var: float = 0.05, device: str = "cuda",
        kernels: bool = True):
    sig = synthetic_signal(n, device=device)
    scales = np.geomspace(4, 64, n_scales)
    rk, ik = morlet_bank(96, scales, device=device)
    sp = spec("int4")
    cfg = DPEConfig(
        input_spec=spec("int8"),  # input precision per Table 2 defaults
        weight_spec=sp,  # kernels quantised to signed INT4 (paper)
        var=var,
        noise_mode="program" if var > 0 else "off",
    )
    key = PRNGKey(3)

    def hw(a, b):
        return dpe_matmul(a, b, cfg, key, kernels)

    p_hw = cwt_power(sig, rk, ik, hw)
    p_sw = cwt_power(sig, rk, ik, lambda a, b: a @ b)
    return {
        "power_re": float(relative_error(p_hw, p_sw)),
        "peak_scale_match": bool(
            torch.argmax(p_sw.mean(0)) == torch.argmax(p_hw.mean(0))
        ),
    }


if __name__ == "__main__":
    out = run(device=cli_device())
    print(f"power-spectrum RE vs ideal: {out['power_re']:.4f}")
    print(f"dominant scale matches: {out['peak_scale_match']}")
