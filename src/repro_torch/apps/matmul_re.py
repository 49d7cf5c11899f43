"""Fig. 11: variable-precision matmul relative error, 128x128 data
(port of ``repro/apps/matmul_re.py``).

Formats: INT8, FP32, BF16, FlexPoint16+5 (paper's four panels), through
the faithful engine with Table-2 hardware parameters.
"""
from __future__ import annotations

from repro_torch.apps import cli_device
from repro_torch.core import DPEConfig, dpe_matmul, relative_error, spec
from repro_torch.core.prng import PRNGKey, normal

FORMATS = ("int8", "fp32", "bf16", "flex16_5")


def run(n: int = 128, seed: int = 0, var: float = 0.05, radc: int = 1024,
        device: str = "cuda", kernels: bool = True):
    x = normal(PRNGKey(seed), (n, n), device)
    w = normal(PRNGKey(seed + 1), (n, n), device)
    ideal = x @ w
    out = {}
    for name in FORMATS:
        sp = spec(name)
        cfg = DPEConfig(
            input_spec=sp, weight_spec=sp, var=var, radc=radc,
            noise_mode="program" if var > 0 else "off",
        )
        y = dpe_matmul(x, w, cfg, PRNGKey(seed + 2), kernels)
        out[name] = float(relative_error(y, ideal))
    return out


if __name__ == "__main__":
    for k, v in run(device=cli_device()).items():
        print(f"{k}: RE = {v:.4e}")
