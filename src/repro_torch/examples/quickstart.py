"""Quickstart: simulate a matmul on memristive hardware (port of
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu]

The inputs are the reference's draws (``normal(PRNGKey(0), (128, 256))``
and ``normal(PRNGKey(1), (256, 128))``, programming noise keyed by
``PRNGKey(42)``), made on the chosen device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import (
    DPEConfig,
    dpe_apply,
    dpe_matmul,
    program_weight,
    relative_error,
    spec,
)
from repro_torch.core.prng import PRNGKey, normal


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = ap.parse_args(argv).device
    # 1. the hardware and precision (paper Table 2 defaults): 1e-5..1e-7 S
    #    window, 16 levels, 5% programming noise, 8-bit DAC, 10-bit ADC,
    #    64x64 crossbar tiles, INT8 bit-slicing (1,1,2,4)
    cfg = DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"))
    x = normal(PRNGKey(0), (128, 256), device=dev)
    w = normal(PRNGKey(1), (256, 128), device=dev)
    ideal = x @ w
    # 2. the simulated analog matmul, programming noise keyed
    y = dpe_matmul(x, w, cfg, PRNGKey(42))
    print("relative error vs ideal:", float(relative_error(y, ideal)))
    # 3. layer-wise mixed precision: FP16 on this layer only
    cfg16 = cfg.replace(input_spec=spec("fp16"), weight_spec=spec("fp16"))
    y16 = dpe_matmul(x, w, cfg16, PRNGKey(42))
    print("fp16 relative error:     ", float(relative_error(y16, ideal)))
    # 4. beyond-paper fast mode: the same statistics, one GEMM
    yf = dpe_matmul(x, w, cfg.replace(mode="fast"), PRNGKey(42))
    print("fast-mode relative error:", float(relative_error(yf, ideal)))
    # 5. weight-stationary serving: program the crossbars ONCE, then reuse
    #    the resident state for many reads -- the same bits as programming
    #    with the same key on every call
    pw = program_weight(w, cfg, PRNGKey(42))
    y_a = dpe_apply(x, pw, w.shape[1], cfg)
    dpe_apply(0.5 * x, pw, w.shape[1], cfg)  # a second read, no re-programming
    print("programmed-once == inline:", bool(torch.equal(y_a, y)))
    return {"relative_error": float(relative_error(y, ideal)),
            "fp16_relative_error": float(relative_error(y16, ideal)),
            "fast_relative_error": float(relative_error(yf, ideal)),
            "programmed_once_equals_inline": bool(torch.equal(y_a, y))}


if __name__ == "__main__":
    main()
