"""Train a small LM on simulated memristive hardware for a few hundred
steps and watch the loss fall (port of ``examples/hw_training.py``; the
paper's Fig. 16 lifted to transformers)::

    python -m repro_torch.examples.hw_training [--steps 300] [--device cpu]

h2o-danube's smoke config (vocab cut to 256) trains with INT8 ``fast``
hardware layers everywhere except the logits head, which stays digital
(the paper's Fig. 9b hybrid), through the straight-through estimator;
AdamW with a cosine schedule, 16 synthetic batches in turn.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models import init_params
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import init_train_state, make_train_step


def main(argv=None):
    """Returns the losses of every step (host floats)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.hw_training")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")

    cfg = get_smoke("h2o-danube-1.8b").replace(vocab=256)
    # the paper's technique, layer-wise: INT8 analog everywhere except
    # the logits head (precision-sensitive -> digital; Fig. 9b hybrid)
    policy = MemPolicy(
        default=DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"), mode="fast"),
        overrides=(("lm_head", None),),
    )
    opt = adamw(lr=cosine_schedule(1e-3, warmup=20, total=args.steps))
    step = make_train_step(cfg, opt, policy, compute_dtype=torch.float32, loss_chunk=64)
    state = init_train_state(init_params(cfg, 0, device=args.device), opt)
    losses = []
    for i in range(args.steps):
        batch = synthetic_batch(cfg, args.batch, args.seq, step=i % 16, device=args.device)
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i % 25 == 0:
            print(f"step {i:4d}  loss {losses[-1]:.4f}")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} on analog hardware")
    return losses


if __name__ == "__main__":
    main()
