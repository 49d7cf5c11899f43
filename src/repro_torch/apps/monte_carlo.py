"""Fig. 12: Monte-Carlo non-ideality analysis (port of
``repro/apps/monte_carlo.py``).

Sweeps conductance variation x block size for (a) quantisation (INT) and
(b) pre-alignment (FP) at equal effective bit width, N cycles each.
Expected findings: RE grows with var and block size; quantisation <
pre-alignment.
"""
from __future__ import annotations

import numpy as np

from repro_torch.apps import cli_device
from repro_torch.core import DPEConfig, dpe_matmul, relative_error, spec
from repro_torch.core.prng import PRNGKey, normal


def run(
    n: int = 128,
    cycles: int = 20,
    variations=(0.0, 0.02, 0.05, 0.1),
    blocks=(32, 64, 128),
    eff_bits: str = "int8",
    device: str = "cuda",
    kernels: bool = True,
):
    x = normal(PRNGKey(0), (n, n), device)
    w = normal(PRNGKey(1), (n, n), device)
    ideal = x @ w
    int_spec = spec(eff_bits)
    fp_spec = int_spec.with_kind("fp")
    results = {}
    for kind, sp in (("quant", int_spec), ("prealign", fp_spec)):
        for var in variations:
            for bs in blocks:
                cfg = DPEConfig(
                    input_spec=sp,
                    weight_spec=sp,
                    var=var,
                    noise_mode="program" if var > 0 else "off",
                    array_size=(bs, bs),
                )
                res = []
                for c in range(cycles if var > 0 else 1):
                    y = dpe_matmul(x, w, cfg, PRNGKey(100 + c), kernels)
                    res.append(float(relative_error(y, ideal)))
                results[(kind, var, bs)] = (
                    float(np.mean(res)),
                    float(np.std(res)),
                )
    return results


if __name__ == "__main__":
    for (kind, var, bs), (mu, sd) in run(device=cli_device()).items():
        print(f"{kind:9s} var={var:<5} block={bs:<4} RE={mu:.4e} +- {sd:.1e}")
