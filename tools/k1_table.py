#!/usr/bin/env python3
"""K1 per served projection, from one checkout of the port: CTAs launched,
kernel launches per call, device time, bound and share of the bound.

    python3 tools/k1_table.py CHECKOUT LABEL

At qwen2-0.5b's shapes (int8 x int8, 128x128 tiles, ``dynamic_row`` ADC,
programming noise on) and M = 2 (a decode step at 2 slots) and M = 32 (a
prefill chunk), with ``chip_smoke.py``'s timer (CUDA events, L2 flushed,
median of 5) and bound.  The checkout's own ``chip_smoke.py`` and
``repro_torch`` are used, so two commits compare within one call:

    git archive <parent> | tar -x -C build/parent
    python3 tools/k1_table.py build/parent parent; python3 tools/k1_table.py . change
"""
from __future__ import annotations

import os
import sys


def blocks_of(sm, m, kp, np_, spec_in, spec_w, tile):
    """CTAs one call launches and kernel launches per call."""
    if hasattr(sm, "plan_k1"):
        p = sm.plan_k1(m, kp, np_, tile, spec_in.n_slices, spec_w.n_slices, "dynamic_row", 128)
        return p.ctas, p.launches
    # the first design: grid (Np/T, Kp/T, ceil(M/BM)), BM 4 up to 4 rows
    # else 8, then a second kernel for the K-block sum
    bm = 4 if m <= 4 else 8
    return (np_ // tile) * (kp // tile) * (-(-m // bm)), 2


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    label = sys.argv[2] if len(sys.argv) > 2 else root
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    import chip_smoke
    from repro_torch.configs import get
    from repro_torch.core.dpe import prepare_weight
    from repro_torch.core.prng import PRNGKey
    from repro_torch.kernels import build
    from repro_torch.kernels import sliced_matmul as sm

    if not torch.cuda.is_available():
        print("k1_table: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    card = chip_smoke.card_line()
    timer = chip_smoke.Timer()
    qcfg = get("qwen2-0.5b")
    dcfg = chip_smoke.faithful_policy().default
    kw = dict(input_spec=dcfg.input_spec, weight_spec=dcfg.weight_spec,
              array_size=dcfg.array_size, rdac=dcfg.rdac, radc=dcfg.radc,
              adc_mode="dynamic_row")
    d, f, v = qcfg.d_model, qcfg.d_ff, qcfg.vocab
    nh, nkv, hd = qcfg.n_heads, qcfg.n_kv_heads, qcfg.head_dim
    shapes = {"q/o": (d, nh * hd), "k/v": (d, nkv * hd), "wi/wg": (d, f), "wo": (f, d),
              "lm_head": (d, v)}
    per_step = {"q/o": 2 * qcfg.n_layers, "k/v": 2 * qcfg.n_layers,
                "wi/wg": 2 * qcfg.n_layers, "wo": qcfg.n_layers, "lm_head": 1}
    pairs = dcfg.input_spec.n_slices * dcfg.weight_spec.n_slices
    tile = dcfg.array_size[0]
    g = torch.Generator(device="cuda").manual_seed(11)
    total = {2: [0.0, 0.0], 32: [0.0, 0.0]}
    print(f"{label}: K1 per projection  [{card}]")
    print("| projection | K x N | M | CTAs | launches/call | ms | bound ms | share of bound | per step |")
    for name, (k, n) in shapes.items():
        w = torch.randn((k, n), generator=g, device="cuda") * k**-0.5
        pw = prepare_weight(w, dcfg.replace(noise_mode="program"), key=PRNGKey(1234))
        _, kp, np_ = pw.slices.shape
        for m in (2, 32):
            count = per_step[name] if (m == 2 or name != "lm_head") else 0
            x = torch.randn((m, k), generator=g, device="cuda")
            t = timer(lambda: sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, **kw))
            nbytes = 4 * (pw.slices.numel() + pw.scale.numel() + x.numel() + m * np_)
            b, by = chip_smoke.bound_ms(nbytes, 2 * pairs * m * kp * np_)
            ctas, launches = blocks_of(sm, m, kp, np_, dcfg.input_spec, dcfg.weight_spec, tile)
            total[m][0] += count * t
            total[m][1] += count * b
            print(f"| {name} | {k} x {n} | {m} | {ctas} | {launches} | {t:.4f} | {b:.4f} ({by}) "
                  f"| {b / t:.1%} | x{count} |")
        del pw, w
        torch.cuda.empty_cache()
    for m, what in ((2, "decode step"), (32, "prefill chunk (non-final)")):
        t, b = total[m]
        print(f"{label}: K1 {what}: {t:.3f} ms, bound {b:.3f} ms, share {b / t:.1%}  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
