"""Serve a small LM through simulated memristive hardware, the
weight-stationary way (port of ``examples/serve_memristive_lm.py``):
program every crossbar ONCE with ``program_params``, then decode
greedily against the resident state, and compare digital and analog
tokens.

    python -m repro_torch.examples.serve_memristive_lm [--device cpu]

Like the reference example it serves rwkv6-1.6b's smoke config
(``rwkv6-smoke``: attention-free, an O(1) decode state).  Passing the
programmed state is bitwise the same as letting ``greedy_generate``
program each call with the same key; digital-vs-analog disagreement is
the physics (programming noise moving near-tie logits).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec
from repro_torch.core.prng import PRNGKey, randint
from repro_torch.models import init_params, program_params, programmed_byte_size
from repro_torch.serve import greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_memristive_lm")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = ap.parse_args(argv).device
    cfg = get_smoke("rwkv6-1.6b")  # attention-free: O(1) decode state
    params = init_params(cfg, PRNGKey(0), device=dev)
    prompts = randint(PRNGKey(1), (4, 12), 0, cfg.vocab, device=dev)
    digital = greedy_generate(params, cfg, prompts, 12, compute_dtype=torch.float32)
    analog_policy = MemPolicy(
        default=DPEConfig(input_spec=spec("fp16"), weight_spec=spec("fp16"), mode="fast",
                          var=0.02),
        overrides=(("lm_head", None),),
    )
    # program the whole model once; PRNGKey(0) is the static serving key
    # of the prefill and decode steps
    programmed = program_params(params, cfg, analog_policy, PRNGKey(0))
    mb = programmed_byte_size(programmed) / 1e6
    print(f"programmed {mb:.1f} MB of crossbar state (resident, reused for every token)")
    analog = greedy_generate(params, cfg, prompts, 12, policy=analog_policy,
                             compute_dtype=torch.float32, programmed=programmed)
    agree = float((digital == analog).float().mean())
    print("digital tokens:", digital[0].tolist())
    print("analog  tokens:", analog[0].tolist())
    print(f"token agreement across batch: {agree:.2%} (analog noise perturbs near-tie logits)")
    return digital, analog


if __name__ == "__main__":
    main()
