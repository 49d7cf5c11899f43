#!/usr/bin/env python3
"""Serve qwen2-0.5b on the card from one checkout of the port and print
the served path's ITL, TTFT and throughput, to compare two commits.

    python3 tools/serve_ab.py CHECKOUT LABEL

It runs what ``chip_smoke.py``'s serve phase runs (the ``mem_faithful``
policy with ``dynamic_row`` ADC, 2 slots, chunk 32, block size 16,
float32; 4 requests of 16/40/64/27 prompt tokens and 8 new tokens each)
without the plain-version run, three times after one warm-up request,
then once more under ``torch.profiler`` for the card's idle share.
The served path is bound by the host, whose clock varies from run to run
and from machine to machine, so compare two checkouts only within one
call on one card, in turns:

    git archive <parent> | tar -x -C build/parent
    for c in build/parent . . build/parent; do python3 tools/serve_ab.py $c $c; done
"""
from __future__ import annotations

import os
import statistics
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    label = sys.argv[2] if len(sys.argv) > 2 else root
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.configs import get
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeConfig, ServeLoop

    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    qcfg = get("qwen2-0.5b")
    params = init_params(qcfg, seed=0, device="cuda")
    sc = ServeConfig(policy=chip_smoke.faithful_policy(), slots=2, max_len=128, prefill_chunk=32,
                     block_size=16, compute_dtype=torch.float32, device="cuda",
                     collect_logits=True)
    loop = ServeLoop(params, qcfg, sc)
    rng = np.random.default_rng(0)
    loop.run([Request(100, rng.integers(0, qcfg.vocab, 20).astype(np.int32), 2)])
    reqs = [Request(i, rng.integers(0, qcfg.vocab, n).astype(np.int32), 8)
            for i, n in enumerate([16, 40, 64, 27])]
    card = chip_smoke.card_line()
    walls = []
    for r in range(3):
        torch.cuda.synchronize()
        rep = loop.run(reqs)
        torch.cuda.synchronize()
        walls.append(rep.wall_s)
        print(f"{label} run {r}: ITL mean {rep.itl_percentiles()['mean'] * 1e3:.1f} ms, "
              f"TTFT mean {rep.ttft_percentiles()['mean'] * 1e3:.1f} ms, "
              f"{rep.tok_per_s:.2f} tok/s, wall {rep.wall_s:.3f} s  [{card}]")
    # the card's busy time over the same requests, once more under the
    # profiler (which slows the host, so its own wall time is not used)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop.run(reqs)
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)) / 1e3
    wall_ms = statistics.median(walls) * 1e3
    print(f"{label}: device busy {busy_ms:.1f} ms of the median wall {wall_ms:.1f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
