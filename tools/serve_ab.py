#!/usr/bin/env python3
"""Serve qwen2-0.5b on the card from one checkout of the port and print
the served path's ITL, TTFT and throughput, and optionally K2 / K3's
times, to compare two commits.

    python3 tools/serve_ab.py CHECKOUT LABEL [--max_len N [N ...]] [--kernels]

It runs what ``chip_smoke.py``'s serve phase runs (the ``mem_faithful``
policy with ``dynamic_row`` ADC, 2 slots, chunk 32, block size 16,
float32; 4 requests of 16/40/64/27 prompt tokens and 8 new tokens each)
without the plain-version run: one server per ``--max_len`` (default
128; the block tables are ``max_len / 16`` entries wide), each warmed
by one request, then three runs of each server in turns, then once more
per server under ``torch.profiler`` for the card's idle share.

``--kernels`` first times K2 and K3 with the checkout's own kernels and
``chip_smoke.Timer`` (CUDA events, L2 flushed before each launch, median
of 20) at qwen2-0.5b's heads (14 query heads over 2 KV heads, head_dim
64, block size 16, float32): K2 for 4 slots at random positions below
256 in a 16-block table (the served shape) and for 128 slots (a grid of
256 blocks, past one wave of 132 SMs), K3 for a 32-row chunk at start
37.  The inputs come from fixed seeds, so every checkout times the same
work.

The served path is bound by the host, whose clock varies from run to run
and from machine to machine, so compare two checkouts only within one
call on one card, in turns:

    git archive <parent> | tar -x -C build/parent
    for c in build/parent . . build/parent; do python3 tools/serve_ab.py $c $c --kernels; done
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys


def time_kernels(label, card):
    import torch

    import chip_smoke
    from repro_torch.kernels import paged_attention as pa

    h, kv, hd, bs, nb, c = 14, 2, 64, 16, 16, 32
    g = torch.Generator(device="cuda").manual_seed(7)
    timer = chip_smoke.Timer()
    tiny = torch.empty(1, device="cuda")
    line = [f"timer floor {timer(lambda: tiny.zero_(), iters=20):.4f} ms"]
    for b in (4, 128):
        n_blocks = 1 + b * nb
        pk = torch.randn((n_blocks, bs, kv, hd), generator=g, device="cuda")
        pv = torch.randn((n_blocks, bs, kv, hd), generator=g, device="cuda")
        perm = torch.randperm(n_blocks - 1, generator=g, device="cuda").to(torch.int32) + 1
        bt = perm[: b * nb].reshape(b, nb).contiguous()
        pos = torch.randint(0, nb * bs, (b,), generator=g, device="cuda").to(torch.int32)
        for i in range(b):
            bt[i, int(pos[i]) // bs + 1:] = 0
        q = torch.randn((b, h, hd), generator=g, device="cuda")
        t2 = timer(lambda: pa.paged_decode_attention_cuda(q, pk, pv, bt, pos), iters=20)
        line.append(f"K2 (B={b}) {t2:.4f} ms")
        if b == 4:
            qc = torch.randn((1, c, h, hd), generator=g, device="cuda")
            row = perm[:nb].contiguous()
            t3 = timer(lambda: pa.paged_chunk_attention_cuda(qc, pk, pv, row, 37, c), iters=20)
            line.append(f"K3 (C={c}, start 37) {t3:.4f} ms")
    print(f"{label}: " + "  ".join(line) + f"  [{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout")
    ap.add_argument("label", nargs="?")
    ap.add_argument("--max_len", type=int, nargs="+", default=[128])
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.checkout)
    label = args.label or root
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
    card = chip_smoke.card_line()
    if args.kernels:
        time_kernels(label, card)
    qcfg = get("qwen2-0.5b")
    params = init_params(qcfg, 0, device="cuda")
    sc = ServeConfig(policy=chip_smoke.faithful_policy(), slots=2, max_len=args.max_len[0],
                     prefill_chunk=32, block_size=16, compute_dtype=torch.float32,
                     device="cuda", collect_logits=True)
    loops = [ServeLoop(params, qcfg, sc)]
    for n in args.max_len[1:]:
        loops.append(ServeLoop(params, qcfg, sc.replace(max_len=n),
                               programmed=loops[0].programmed))
    rng = np.random.default_rng(0)
    warm = Request(100, rng.integers(0, qcfg.vocab, 20).astype(np.int32), 2)
    for loop in loops:
        loop.run([warm])
    reqs = [Request(i, rng.integers(0, qcfg.vocab, n).astype(np.int32), 8)
            for i, n in enumerate([16, 40, 64, 27])]
    walls = {n: [] for n in args.max_len}
    for r in range(3):
        for n, loop in zip(args.max_len, loops):
            torch.cuda.synchronize()
            rep = loop.run(reqs)
            torch.cuda.synchronize()
            walls[n].append(rep.wall_s)
            print(f"{label} max_len {n} run {r}: ITL mean {rep.itl_percentiles()['mean'] * 1e3:.1f}"
                  f" ms, TTFT mean {rep.ttft_percentiles()['mean'] * 1e3:.1f} ms, "
                  f"{rep.tok_per_s:.2f} tok/s, wall {rep.wall_s:.3f} s  [{card}]", flush=True)
    # the card's busy time over the same requests, once more under the
    # profiler (which slows the host, so its own wall time is not used)
    for n, loop in zip(args.max_len, loops):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loop.run(reqs)
            torch.cuda.synchronize()
        busy_ms = sum(e.self_device_time_total for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)) / 1e3
        wall_ms = statistics.median(walls[n]) * 1e3
        print(f"{label} max_len {n}: device busy {busy_ms:.1f} ms of the median wall "
              f"{wall_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
