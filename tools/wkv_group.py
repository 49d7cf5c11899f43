#!/usr/bin/env python3
"""Time rwkv6-1.6b's 4,096-token prefill on the card with the chunked WKV
form's state-free terms computed one chunk at a time (group 1, the
reference's loop) and ``ssm.WKV_GROUP`` chunks at a time.

    python3 tools/wkv_group.py [LAYERS]

One prompt of 4,096 tokens, batch 1, under ``digital`` at full width and
LAYERS layers (default 24, the published depth): the projections are
plain float32 products, so what the group changes is the WKV form's own
work.  The prefill runs with the default group (a warm-up), with group
1, and with the default group again; each line gives its wall time.
The last lines say whether the two runs with the default group give
bit-equal logits and recurrent states (the script fails if not), and how
far group 1's are from them (max rel; the batched products of a group
may take other summation orders on a card).
"""
from __future__ import annotations

import functools
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

PROMPT = 4096


def main() -> int:
    import torch

    from repro_torch.configs import get
    from repro_torch.core.prng import PRNGKey, randint
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.models import init_params, ssm
    from repro_torch.models.common import tree_leaves
    from repro_torch.serve.engine import make_prefill_step

    if not torch.cuda.is_available():
        print("wkv_group: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    cfg = get("rwkv6-1.6b").replace(n_layers=layers)
    params = init_params(cfg, PRNGKey(0), device="cuda")
    prompt = randint(PRNGKey(1), (1, PROMPT), 0, cfg.vocab, device="cuda")
    prefill = make_prefill_step(cfg, make_policy("digital"), compute_dtype=torch.float32,
                                cache_dtype=torch.float32)
    chunked = ssm._wkv_chunked
    outs = []
    for group in (ssm.WKV_GROUP, 1, ssm.WKV_GROUP):
        ssm._wkv_chunked = functools.partial(chunked, group=group)
        try:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            logits, cache = prefill(params, {"tokens": prompt}, None)
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
        finally:
            ssm._wkv_chunked = chunked
        outs.append([logits] + tree_leaves(cache["blocks"]))
        print(f"rwkv6-1.6b at {layers} layers, digital prefill of {PROMPT} tokens, WKV group "
              f"{group}: {dt * 1e3:.1f} ms  [{card}]")
    ref, one, again = outs
    same = all(torch.equal(a, b) for a, b in zip(ref, again))
    print(f"default group twice: logits and recurrent states bit-equal: {same}")
    rel = [float(((a - b).abs().max() / b.abs().max()).item()) for a, b in zip(one, ref)]
    print(f"group 1 against the default group: bit-equal "
          f"{all(torch.equal(a, b) for a, b in zip(one, ref))}; max rel: logits {rel[0]:.3e}, "
          f"recurrent states {max(rel[1:]):.3e}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
