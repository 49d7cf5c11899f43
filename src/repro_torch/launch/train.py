"""End-to-end training launcher of the port (port of
``repro/launch/train.py``): architecture configs, the memory policy (the
paper's technique), synthetic data, AdamW with a cosine schedule, async
checkpoints with resume, and the straggler monitor::

    python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \\
        --steps 20 --batch 8 --seq 128 --policy mem_fast --ckpt /tmp/ckpt \\
        --device cpu

The flags are the reference's, plus:

* ``--device {cuda,cpu}`` (default ``cuda``): where the model lives and
  trains; ``cuda`` without a card raises, it never falls back;
* ``--kernels {auto,off,on}``, the serve launcher's flag on purpose (one
  vocabulary for both launchers): ``auto`` launches the CUDA kernels on
  the card and runs their plain versions on the CPU; ``off`` runs the
  plain versions on either; ``on`` insists on the kernels, so it acts as
  ``auto`` on the card and raises on the CPU;
* ``--layers N`` cuts the model to N layers (widths unchanged);
* ``--remat {on,off}`` (default ``on``, the reference's): recompute each
  layer and each loss chunk in the backward pass.

The step donates its state (the optimiser updates the parameters and
moments in place), and on the card the launcher prints the peak device
memory before its last line.

Without ``--smoke`` the model is the architecture at its published
widths, with random weights from ``PRNGKey(0)`` as the reference draws
them; the batches are ``synthetic_batch(cfg, batch, seq, step)``.  The
step runs float32 with loss chunks of 64 tokens, as the reference's.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs as arch_configs
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint, wait_for_saves
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.distributed.ft import StepMonitor
from repro_torch.launch.dryrun import make_policy
from repro_torch.models import init_params
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import init_train_state, make_train_step

__all__ = ["config_of", "main", "parse_args", "run"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--policy", default="digital",
                    choices=["digital", "mem_fast", "mem_faithful"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt_every", type=int, default=10)
    ap.add_argument("--log_every", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model lives and trains (cuda raises without a card)")
    ap.add_argument("--kernels", default="auto", choices=("auto", "off", "on"),
                    help="auto: CUDA kernels on the card, plain versions on the CPU; off: "
                         "plain versions everywhere; on: the kernels, raising on the CPU")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to its first N layers (widths unchanged)")
    ap.add_argument("--remat", default="on", choices=("on", "off"),
                    help="recompute each layer and loss chunk in the backward pass")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags from ``argv`` (default ``sys.argv[1:]``)."""
    return _parser().parse_args(argv)


def config_of(args: argparse.Namespace):
    """The architecture ``args`` name: ``--arch``, reduced by ``--smoke``,
    cut to ``--layers``."""
    cfg = arch_configs.get_smoke(args.arch) if args.smoke else arch_configs.get(args.arch)
    return cfg if args.layers is None else cfg.replace(n_layers=args.layers)


def run(cfg, args: argparse.Namespace, *, return_state: bool = False,
        report: dict | None = None):
    """Train ``cfg`` as the flags ``args`` say (:func:`parse_args`; the
    model flags ``--arch``, ``--smoke`` and ``--layers`` aside).  Returns
    what :func:`main` returns."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    if args.kernels == "on" and args.device != "cuda":
        raise ValueError("--kernels on needs --device cuda: the kernels run on the card only")
    dev = args.device
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    policy = make_policy(args.policy)
    opt = adamw(lr=cosine_schedule(args.lr, warmup=5, total=args.steps))
    step_fn = make_train_step(
        cfg, opt, policy, microbatches=args.microbatches, compute_dtype=torch.float32,
        loss_chunk=64, remat=args.remat == "on", kernels=args.kernels != "off", donate=True,
    )

    start_step = 0
    state = init_train_state(init_params(cfg, 0, device=dev), opt)
    if args.ckpt and latest_step(args.ckpt) is not None:
        state, start_step = restore_checkpoint(args.ckpt, state, device=dev)
        print(f"resumed from step {start_step}")

    monitor = StepMonitor()
    history = []
    if report is not None:
        report.update(loss=[], grad_norm=[], step_s=[])
    for step in range(start_step, args.steps):
        batch = synthetic_batch(cfg, args.batch, args.seq, step, device=dev)
        monitor.start()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # synchronises: the step's time covers the card's work
        stats = monitor.stop(step)
        history.append(loss)
        if report is not None:
            report["loss"].append(loss)
            report["grad_norm"].append(float(metrics["grad_norm"]))
            report["step_s"].append(stats["step_time"])
        if step % args.log_every == 0:
            flag = " STRAGGLER" if stats["straggler"] else ""
            print(
                f"step {step:5d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):8.3f} "
                f"dt {stats['step_time'] * 1e3:7.1f}ms{flag}"
            )
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, step + 1, state)
    if args.ckpt:
        save_checkpoint(args.ckpt, args.steps, state)
        wait_for_saves()
    if monitor.slow_steps:
        print(f"stragglers observed: {monitor.slow_steps}")
    if dev == "cuda":
        print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if history:
        print(f"final loss: {history[-1]:.4f} (start {history[0]:.4f})")
    return (history, state) if return_state else history


def main(argv=None, *, return_state: bool = False, report: dict | None = None):
    """Run the trainer with ``argv`` (default ``sys.argv[1:]``).  Returns
    the per-step losses (host floats), as the reference does; with
    ``return_state`` also the final train state: ``(history, state)``.
    A ``report`` dict receives each step's ``loss``, ``grad_norm`` and
    host time ``step_s`` (lists)."""
    args = parse_args(argv)
    return run(config_of(args), args, return_state=return_state, report=report)


if __name__ == "__main__":
    main()
