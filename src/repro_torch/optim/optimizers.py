"""Optimisers (port of ``repro/optim/optimizers.py``): the functional
API ``update(grads, state, params, step) -> (params, state)`` over the
port's nested parameter dicts.

* ``adamw``     — float32 moments; the launcher's optimiser.
* ``adafactor`` — factored second moment, no first moment.
* ``sgd``       — momentum SGD.

Leaves are visited in JAX's order (dict keys sorted at every level,
:func:`repro_torch.models.common.tree_leaves`), so a sum over leaves,
such as the global gradient norm, adds in the reference's order.  The arithmetic is what XLA compiles the reference's
jitted update to on the CPU, so one update gives the reference's bits:

* a multiply that feeds an add is one fused multiply-add
  (:func:`repro_torch.core.xmath.fma`);
* AdamW's ``m / (1 - b1**t) / (sqrt(vh) + eps)`` is one division by
  ``(1 - b1**t) * (sqrt(vh) + eps)`` (XLA's algebraic simplifier merges
  the two divisions);
* ``b**t``, ``t**-decay`` and the schedule's ``cos`` are XLA's float32
  ``pow`` / ``cos`` (:func:`~repro_torch.core.xmath.pow`,
  :func:`~repro_torch.core.xmath.cos`), on host scalars: the step is
  read from the device once an update.

A reduction over a whole leaf (the global norm, Adafactor's means and
update RMS) adds through :func:`~repro_torch.core.xmath.sum_last`, in an
order fixed by the shape alone: the same bits on the CPU and on a card.
For a 1-D leaf that is XLA's order; over a 2-D leaf XLA adds in 2-D
windows, which the port does not replay (a few ulps of the sum).
``rsqrt`` is the correctly rounded one (XLA's is within one ulp).

Memory: the float64 replays of a fused multiply-add hold several
float64 copies of their operands, 6.4 GB each on an 805 M-element expert
stack.  AdamW's update is elementwise, so it runs a leaf in slabs of
``SLAB`` elements of the flattened leaf (the same bits), and clipping
scales each slab of a gradient as it is read instead of copying the
gradients.  AdamW's ``update(..., inplace=True)`` writes the new
parameters and moments into the old tensors (the reference's buffer
donation), so a step holds one copy of them: a model whose parameters,
gradients and two moments fill most of the card trains.  Adafactor and
SGD return new tensors only (``Optimizer.inplace`` is false).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import xmath
from repro_torch.core.xmath import fma
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "Optimizer",
    "adamw",
    "adafactor",
    "sgd",
    "cosine_schedule",
    "clip_by_global_norm",
    "global_norm",
]

_F = np.float32
SLAB = 1 << 25  # elements of a leaf that AdamW's update computes at once


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple]
    # update(grads, state, params, step) -> (new_params, new_state); where
    # ``inplace`` is true, update(..., inplace=True) writes the results into
    # (and returns them as) params and state
    inplace: bool = False


def _map(fn, *trees) -> list:
    """``fn`` over the matching tensor leaves of ``trees``, in JAX's
    order: the list of its results."""
    return [fn(*leaves) for leaves in zip(*(tree_leaves(t) for t in trees))]


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar as a 0-d tensor on ``like``'s device."""
    return torch.tensor(_F(v), device=like.device)


def _sum_all(x: torch.Tensor) -> torch.Tensor:
    """Sum of every element, in :func:`xmath.sum_last`'s order over the
    flattened tensor."""
    return xmath.sum_last(x.reshape(-1))


def _mean_last(x: torch.Tensor) -> torch.Tensor:
    return xmath.sum_last(x) / _scalar(x.shape[-1], x)


def cosine_schedule(base_lr, warmup, total, min_frac=0.1):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac * base_lr`` at ``total``; ``lr(step)`` is a
    float32 scalar, the reference's bits as XLA compiles it: each
    division by a constant becomes a product with the constant's float32
    reciprocal (folded into ``base_lr`` for the warm-up), and
    ``min_frac + half * c`` is one fused multiply-add."""
    base, mf = _F(base_lr), _F(min_frac)
    half = _F((1 - min_frac) * 0.5)
    warm = _F(base * _F(_F(1.0) / _F(max(warmup, 1))))
    inv_span = _F(_F(1.0) / _F(max(total - warmup, 1)))

    def lr(step):
        s = _F(int(step))
        if s < _F(warmup):
            return _F(s * warm)
        prog = _F(min(max(_F(_F(s - _F(warmup)) * inv_span), _F(0.0)), _F(1.0)))
        c = _F(xmath.cos(_F(prog * _F(np.pi))) + _F(1.0))
        inner = _F(fma(torch.tensor(c), half, mf).item())
        return _F(inner * base)

    return lr


def global_norm(grads) -> torch.Tensor:
    """The L2 norm of all leaves: each leaf's sum of squares in float32
    (:func:`_sum_all`), summed over the leaves in JAX's order from 0."""
    total = 0
    for g in tree_leaves(grads):
        g = g.to(torch.float32)
        total = total + _sum_all(g * g)
    return xmath.sqrt(total)


def _clip_scale(grads, max_norm) -> torch.Tensor:
    """``min(1, max_norm / max(norm, 1e-12))`` of the global norm."""
    norm = global_norm(grads)
    return torch.minimum(
        torch.ones_like(norm), _scalar(max_norm, norm) / torch.clamp_min(norm, _F(1e-12)))


def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``;
    returns ``(grads, norm)``.  The scale multiplies in each gradient's
    own dtype."""
    norm = global_norm(grads)
    scale = torch.minimum(
        torch.ones_like(norm), _scalar(max_norm, norm) / torch.clamp_min(norm, _F(1e-12)))
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _lr(lr):
    return lr if callable(lr) else (lambda _: _F(lr))


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01, clip=1.0):
    lr_fn = _lr(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step, inplace: bool = False):
        scale = _clip_scale(grads, clip) if clip else None
        s = int(step)
        t = _F(_F(s) + _F(1.0))
        lr_t, bc1 = _F(lr_fn(s)), _F(_F(1.0) - xmath.pow(b1, t))
        bc2 = _F(_F(1.0) - xmath.pow(b2, t))

        def slab(g, m, v, p):
            k = lambda v: _scalar(v, g)  # noqa: E731
            if scale is not None:
                g = g * scale.to(g.dtype)
            g = g.to(torch.float32)
            pf = p.to(torch.float32)
            m = fma(m, k(b1), k(1 - b1) * g)
            v = fma(v, k(b2), (k(1 - b2) * g) * g)
            q = m / (k(bc1) * (xmath.sqrt(v / k(bc2)) + k(eps)))
            u = fma(pf, k(weight_decay), q)
            return fma(u, k(-lr_t), pf).to(p.dtype), m, v

        def upd(g, m, v, p):
            outs = (p, m, v) if inplace else tuple(
                torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (p, m, v))
            flat = [t.reshape(-1) for t in (g, m, v, p)]
            dst = [t.view(-1) for t in outs]
            for a in range(0, p.numel(), SLAB):
                for d, r in zip(dst, slab(*(t[a:a + SLAB] for t in flat))):
                    d[a:a + SLAB].copy_(r)
            return outs

        out = _map(upd, grads, state["m"], state["v"], params)
        pick = lambda i: tree_unflatten(params, [o[i] for o in out])  # noqa: E731
        return pick(0), {"m": pick(1), "v": pick(2)}

    return Optimizer(init=init, update=update, inplace=True)


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip=1.0, min_dim=128):
    """Factored second-moment optimiser (Shazeer & Stern, 2018): matrices
    with both of their last two dims at least ``min_dim`` keep row and
    column factors only; no first moment."""
    lr_fn = _lr(lr)

    def _factored(p):
        return p.dim() >= 2 and p.shape[-1] >= min_dim and p.shape[-2] >= min_dim

    def init(params):
        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)  # noqa: E731
            if _factored(p):
                return {"r": z(p.shape[:-1]), "c": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return {"f": tree_map(one, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        if clip:
            grads, _ = clip_by_global_norm(grads, clip)
        s = int(step)
        t = _F(_F(s) + _F(1.0))
        beta = _F(_F(1.0) - xmath.pow(t, -decay))
        lr_t = _F(lr_fn(s))

        def upd(g, st, p):
            k = lambda v: _scalar(v, g)  # noqa: E731
            g = g.to(torch.float32)
            g2 = fma(g, g, k(eps))
            if "r" in st:
                r = fma(st["r"], k(beta), k(1 - beta) * _mean_last(g2))
                c = fma(st["c"], k(beta), k(1 - beta) * _mean_last(g2.transpose(-1, -2)))
                rc = r / torch.clamp_min(_mean_last(r)[..., None], _F(eps))
                v = rc[..., None] * c[..., None, :]
                new = {"r": r, "c": c}
            else:
                v = fma(st["v"], k(beta), k(1 - beta) * g2)
                new = {"v": v}
            u = g * xmath.rsqrt(v + k(eps))
            rms = xmath.sqrt(_sum_all(u * u) / k(u.numel()) + k(eps))
            u = u / torch.clamp_min(rms, _F(1.0))
            return fma(u, k(-lr_t), p.to(torch.float32)).to(p.dtype), new

        # driven by the parameters' structure: each leaf's state is a dict
        out = tree_map(lambda p, g, st: upd(g, st, p), params, grads, state["f"])
        return (tree_map(lambda _, o: o[0], params, out),
                {"f": tree_map(lambda _, o: o[1], params, out)})

    return Optimizer(init=init, update=update)


def sgd(lr=1e-2, momentum=0.9, clip=0.0):
    lr_fn = _lr(lr)

    def init(params):
        return {"m": tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        if clip:
            grads, _ = clip_by_global_norm(grads, clip)
        lr_t = _F(lr_fn(int(step)))

        def upd(g, m, p):
            m = fma(m, _scalar(momentum, g), g.to(torch.float32))
            return fma(m, _scalar(-lr_t, g), p.to(torch.float32)).to(p.dtype), m

        out = _map(upd, grads, state["m"], params)
        pick = lambda i: tree_unflatten(params, [o[i] for o in out])  # noqa: E731
        return pick(0), {"m": pick(1)}

    return Optimizer(init=init, update=update)
