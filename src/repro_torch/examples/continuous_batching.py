"""Continuous batching over program-once crossbar state (port of
``examples/continuous_batching.py``).

Streams variable-length requests through the ``ServeLoop`` slot table —
one shared programmed state serves every request, K/V live in a paged
block-pool arena — and checks the engine's promise: each request's
tokens are the tokens solo greedy decoding gives for its prompt alone
("batched == solo").  Then chunked prefill (a long prompt admitted in
16-token chunks between decode steps, so the short requests around it
get their first token early) and priority-class admission (one
interactive request behind a flood of batch requests: strict FIFO
serves it last, the class-aware scheduler first; the same tokens either
way).

    python -m repro_torch.examples.continuous_batching [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec
from repro_torch.core.prng import PRNGKey
from repro_torch.models import init_params
from repro_torch.serve import Request, ServeConfig, ServeLoop, greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.continuous_batching")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = ap.parse_args(argv).device
    cfg = get_smoke("qwen2-0.5b")
    params = init_params(cfg, PRNGKey(0), device=dev)
    policy = MemPolicy(default=DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"),
                                         mode="fast"))
    rng = np.random.default_rng(0)
    lens = [5, 11, 3, 8, 14, 6]
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in lens]
    loop = ServeLoop(params, cfg, ServeConfig(policy=policy, slots=3, max_len=48,
                                              compute_dtype=torch.float32, device=dev))
    report = loop.run([Request(rid=i, tokens=p, max_new_tokens=12)
                       for i, p in enumerate(prompts)])
    print(f"served {len(prompts)} requests through 3 slots: {report.tok_per_s:.0f} tok/s, "
          f"occupancy {report.occupancy:.2f}, paged arena {report.kv_blocks} blocks")
    matches = []
    for res in report.results[:2]:
        solo = greedy_generate(
            params, cfg, torch.from_numpy(prompts[res.rid])[None].to(dev), 11, policy=policy,
            compute_dtype=torch.float32, programmed=loop.programmed, max_len=48,
        )
        match = res.tokens == solo[0].tolist()
        matches.append(match)
        print(f"request {res.rid} (prompt len {res.prompt_len}): {res.tokens[:8]}... "
              f"batched == solo: {match}")

    # --- chunked prefill: a long prompt never stalls its neighbours ---
    long_prompt = rng.integers(0, cfg.vocab, size=96).astype(np.int32)
    shorts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (4, 7, 5)]
    chunked = ServeLoop(params, cfg, ServeConfig(
        policy=policy, slots=4, max_len=112, prefill_chunk=16, block_size=16,
        compute_dtype=torch.float32, device=dev), programmed=loop.programmed)
    reqs = [Request(rid=0, tokens=long_prompt, max_new_tokens=8)] + [
        Request(rid=i + 1, tokens=p, max_new_tokens=8) for i, p in enumerate(shorts)]
    rep = chunked.run(reqs)
    short_ttft = [r.ttft_s for r in rep.results[1:]]
    print(f"chunked prefill (96-token prompt in 16-token chunks + 3 shorts): worst short TTFT "
          f"{1e3 * max(short_ttft):.1f} ms, long TTFT {1e3 * rep.results[0].ttft_s:.1f} ms, "
          f"{rep.kv_blocks_reused} blocks reused")
    solo_long = greedy_generate(params, cfg, torch.from_numpy(long_prompt)[None].to(dev), 7,
                                policy=policy, compute_dtype=torch.float32,
                                programmed=loop.programmed, max_len=112)
    long_match = rep.results[0].tokens == solo_long[0].tolist()
    matches.append(long_match)
    print("long prompt, chunked batched == solo:", long_match)

    # --- priority classes: a batch flood cannot starve interactive ---
    flood = [dict(rid=i, tokens=p, max_new_tokens=12, priority="batch")
             for i, p in enumerate(prompts[:5])]
    vip = dict(rid=5, tokens=prompts[5], max_new_tokens=12, priority="interactive")
    vip_tokens = []
    for label, skip in (("strict FIFO", 0), ("scheduled ", 8)):
        one_lane = ServeLoop(params, cfg, ServeConfig(
            policy=policy, slots=1, max_len=48, max_queue_skip=skip, collect_trace=True,
            compute_dtype=torch.float32, device=dev), programmed=loop.programmed)
        r = one_lane.run([Request(**q) for q in flood] + [Request(**vip)])
        admitted = [rid for t in r.trace for rid in t["admitted"]]
        vip_res = r.results[5]
        vip_tokens.append(vip_res.tokens)
        print(f"{label} (max_queue_skip={skip}): admitted order {admitted}, interactive TTFT "
              f"{1e3 * vip_res.ttft_s:.1f} ms, tokens[:4] {vip_res.tokens[:4]}")
    return matches, vip_tokens


if __name__ == "__main__":
    main()
