"""Training step (port of ``repro/train/step.py``): the value and the
gradient of the (memory-policy-aware) loss by autograd, optional
gradient accumulation over microbatches, optional int8 error-feedback
gradient compression, then the optimiser update.

The step is a function of ``(state, batch)`` that returns a new state;
the old one is not modified unless the step donates it (``donate``: the
optimiser writes the new parameters and moments into the old tensors,
as the reference's ``donate_argnums`` lets XLA do).  Programming noise is drawn anew every
step from ``fold_in(PRNGKey(seed), step)``: every hardware layer
re-programs its weights after each update (paper §3.4), through the
straight-through estimator of :mod:`repro_torch.core.layers`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.layers import MemPolicy
from repro_torch.core.prng import PRNGKey, fold_in
from repro_torch.models import loss_fn
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.config import ArchConfig
from repro_torch.optim import Optimizer
from repro_torch.optim.optimizers import global_norm

__all__ = ["TrainState", "make_train_step", "init_train_state"]

TrainState = dict  # {"params", "opt", "step"[, "ef"]}


def init_train_state(params, optimizer: Optimizer) -> TrainState:
    """``{"params", "opt", "step"}`` with ``step`` a 0-d int32 tensor on
    the parameters' device."""
    dev = tree_leaves(params)[0].device
    return {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _split_microbatches(batch, n):
    """Each field (B, ...) as ``n`` microbatches of B / n rows, in order."""
    def split(x):
        b = x.shape[0]
        assert b % n == 0, (b, n)
        return x.reshape(n, b // n, *x.shape[1:])

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_train_step(
    cfg: ArchConfig,
    optimizer: Optimizer,
    policy: MemPolicy | None = None,
    *,
    compute_dtype=torch.bfloat16,
    remat: bool = True,
    loss_chunk: int = 512,
    microbatches: int = 1,
    grad_compression=None,  # Optional[GradCompression]
    seed: int = 0,
    kernels: bool = True,
    donate: bool = False,
):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``.

    With ``microbatches`` above 1 the batch is split in order and the
    losses and gradients are summed from float32 zeros, then multiplied
    by the float32 ``1 / microbatches`` (XLA's form of the reference's
    division by the constant).  ``kernels=False`` runs the plain versions
    of the kernels on a card.  With ``donate`` the new parameters and
    optimiser state are written into ``state``'s tensors (one copy of
    them on the card instead of two during the update); it needs an
    optimiser that updates in place (``optimizer.inplace``: AdamW)."""
    if donate and not optimizer.inplace:
        raise ValueError("donate needs an optimiser that updates in place (adamw)")
    policy = policy if policy is not None else MemPolicy(default=None)
    base_rng = PRNGKey(seed)

    def value_and_grad(params, mb, step: int):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = loss_fn(
            p, cfg, mb, policy=policy, rng=fold_in(base_rng, step),
            compute_dtype=compute_dtype, remat=remat, loss_chunk=loss_chunk, kernels=kernels,
        )
        flat = tree_leaves(p)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.detach(), tree_unflatten(params, [
            torch.zeros_like(t) if g is None else g for t, g in zip(flat, grads)])

    def train_step(state: TrainState, batch: dict):
        params, step = state["params"], state["step"]
        s = int(step)
        if microbatches == 1:
            loss, grads = value_and_grad(params, batch, s)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=step.device)
            grads = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                                   device=t.device), params)
            for mb in _split_microbatches(batch, microbatches):
                l, g = value_and_grad(params, mb, s)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            inv = torch.tensor(np.float32(np.float32(1.0) / np.float32(microbatches)),
                               device=step.device)
            loss = loss * inv
            grads = tree_map(lambda g: g * inv.to(g.dtype), grads)
        if grad_compression is not None:
            grads, state = grad_compression.apply(grads, state)
        args = (grads, state["opt"], params, step)
        new_params, new_opt = (optimizer.update(*args, inplace=True) if donate
                               else optimizer.update(*args))
        new_state = dict(state)
        new_state.update(params=new_params, opt=new_opt, step=step + 1)
        return new_state, {"loss": loss, "grad_norm": global_norm(grads)}

    return train_step
