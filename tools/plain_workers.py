#!/usr/bin/env python3
"""Time ``train_mlp``'s plain-version runs on the card in one process and
in several worker processes sharing it, to size ``chip_smoke.py``'s pool
for the apps' plain runs.

    python3 tools/plain_workers.py [STEPS]

The three noisy formats (int4, int8, fp16) run ``STEPS`` steps each
(default 12) with ``kernels=False``: first one after the other in this
process, then each in a worker process of a pool of three, then twice
each in a pool of six.  Each line gives the wall time (the pool's
start-up included) and each worker's own time, and whether every
worker's result equals the one-process run.  A plain run is bound by the
host's launches, so processes that share the card add up to more than
one's rate, not to as many times it.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

FORMATS = ("int4", "int8", "fp16")


def work(fmt, steps):
    import torch

    from repro_torch.apps import train_mlp

    t0 = time.monotonic()
    out = train_mlp.run(formats=(fmt,), steps=steps, kernels=False)
    torch.cuda.synchronize()
    return fmt, time.monotonic() - t0, out


def same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def main() -> int:
    import torch

    from repro_torch.apps import train_mlp

    if not torch.cuda.is_available():
        print("plain_workers: no CUDA device available", file=sys.stderr)
        return 2
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    train_mlp.run(formats=FORMATS[:1], steps=1, kernels=False)  # warm-up
    t0 = time.monotonic()
    one = train_mlp.run(formats=FORMATS, steps=steps, kernels=False)
    torch.cuda.synchronize()
    print(f"one process, {len(FORMATS)} formats x {steps} steps: "
          f"{time.monotonic() - t0:.2f} s", flush=True)
    ctx = mp.get_context("spawn")
    for n in (3, 6):
        jobs = [(f, steps) for f in FORMATS] * (n // len(FORMATS))
        t0 = time.monotonic()
        with ctx.Pool(n) as pool:
            out = pool.starmap(work, jobs)
        wall = time.monotonic() - t0
        ok = all(same(one[f], r[f]) for f, _, r in out)
        print(f"{n} processes, {len(jobs)} runs: wall {wall:.2f} s; each "
              f"{[round(o[1], 2) for o in out]} s; equal to one process: {ok}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
