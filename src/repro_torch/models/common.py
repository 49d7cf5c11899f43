"""Shared model components: norms, RoPE, activations, the dense wrapper,
and the small tree helpers the port uses for nested parameter dicts
(port of ``repro/models/common.py``).

``dense`` is the single entry point for every projection: it consults
the ``MemPolicy`` so any matmul can run on the simulated memristive DPE
or digitally.  Parameters and programmed state are nested dicts whose
per-segment leaves are stacked over layers (leading ``steps`` axis),
exactly the reference's pytree layout.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.core import xmath
from repro_torch.core.layers import MemPolicy, layer_key, mem_linear
from repro_torch.core.quant import div
from repro_torch.core.prng import uniform

__all__ = [
    "dense",
    "pget",
    "rms_norm",
    "layer_norm",
    "norm",
    "activation",
    "gelu",
    "rope",
    "apply_rope",
    "make_dense_params",
    "make_norm_params",
    "uniform_init",
    "tree_map",
    "tree_leaves",
    "tree_unflatten",
    "layer_slice",
    "unstack_layers",
    "take_rows",
    "stack_layers",
    "remat_call",
]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor leaf of nested dicts / NamedTuples,
    with the matching leaves of ``rest`` (trees of the same structure) as
    further arguments.  Dict keys are visited in JAX's order (sorted);
    other leaves, e.g. ``None`` or a float timestamp, pass through."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *vs) for vs in zip(tree, *rest)))
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tree


def tree_leaves(tree, *, paths: bool = False) -> list:
    """The tensor leaves in :func:`tree_map`'s order (JAX's order for
    nested dicts); with ``paths``, ``(path, leaf)`` pairs, a path being
    JAX's ``"a/b/c"`` string of the keys that lead to the leaf (``.name``
    for a NamedTuple field)."""
    out = []
    _walk(tree, (), out, paths)
    return out


def _walk(t, prefix, out, paths):
    """:func:`tree_leaves`' recursion (a module function: a nested one
    that calls itself is a reference cycle, which would hold the leaves
    until the garbage collector runs)."""
    if isinstance(t, dict):
        for k in sorted(t):
            _walk(t[k], prefix + (str(k),), out, paths)
    elif isinstance(t, tuple) and hasattr(t, "_fields"):
        for name, v in zip(t._fields, t):
            _walk(v, prefix + ("." + name,), out, paths)
    elif isinstance(t, torch.Tensor):
        out.append(("/".join(prefix), t) if paths else t)


def tree_unflatten(structure, leaves: list):
    """``structure`` with its tensor leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), structure)


def layer_slice(tree, idx: int):
    """Layer ``idx`` of a stacked segment (views, no copy)."""
    return tree_map(lambda t: t[idx], tree)


def unstack_layers(tree, steps: int) -> list:
    """The ``steps`` layers of a stacked segment as a list of trees
    (``unbind`` views: their gradients stack back into the stacked
    leaves in one copy, where per-layer ``t[idx]`` views would each
    scatter into a zero tensor of the whole stack)."""
    if isinstance(tree, dict):
        parts = {k: unstack_layers(v, steps) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(steps)]
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    return [tree] * steps


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, ids):
        ctx.save_for_backward(ids)
        ctx.rows = w.shape[0]
        return w[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        d = g.shape[-1]
        flat, gf = ids.reshape(-1), g.reshape(-1, d)
        order = torch.argsort(flat, stable=True)
        uniq, counts = torch.unique_consecutive(flat[order], return_counts=True)
        group = torch.repeat_interleave(torch.arange(uniq.numel(), device=g.device), counts)
        rank = torch.arange(flat.numel(), device=g.device) - (torch.cumsum(counts, 0) - counts)[group]
        lanes = torch.zeros((uniq.numel(), int(counts.max()), d), dtype=g.dtype, device=g.device)
        lanes[group, rank] = gf[order]
        acc = torch.zeros((uniq.numel(), d), dtype=g.dtype, device=g.device)
        for j in range(lanes.shape[1]):
            acc = acc + lanes[:, j]
        out = torch.zeros((ctx.rows, d), dtype=g.dtype, device=g.device)
        out[uniq] = acc
        return out, None


def take_rows(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``w[ids]`` (``jnp.take(w, ids, axis=0)``) whose gradient sums the
    rows of a repeated id in the order of their positions, from zero: the
    order of XLA's CPU scatter-add, and the same bits on a card (where
    the gradient of an indexing op adds with atomics, in no fixed
    order)."""
    return _TakeRows.apply(w, ids.long())


def stack_layers(make_layer, steps: int):
    """Build a stacked segment from ``make_layer(idx)`` without holding
    more than one layer's temporaries: the first layer fixes the
    structure, every layer is copied into preallocated stacked leaves.
    One step is a view of its layer (no copy: the layer is never held
    twice)."""
    first = make_layer(0)
    if steps == 1:
        return tree_map(lambda t: t.unsqueeze(0), first)
    stacked = tree_map(
        lambda t: torch.empty((steps,) + tuple(t.shape), dtype=t.dtype, device=t.device),
        first,
    )

    def put(dst, src, idx):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], idx)
        elif isinstance(dst, tuple) and hasattr(dst, "_fields"):
            for a, b in zip(dst, src):
                put(a, b, idx)
        elif isinstance(dst, torch.Tensor):
            dst[idx].copy_(src)

    put(stacked, first, 0)
    del first
    for idx in range(1, steps):
        put(stacked, make_layer(idx), idx)
    return stacked


def remat_call(fn, *args):
    """``fn(*args)`` under a non-reentrant checkpoint that recomputes the
    whole of ``fn`` in the backward pass (no early stop: every hardware
    layer of the region programs and runs again, as in the reference's
    ``nothing_saveable`` recompute)."""
    with _ckpt.set_checkpoint_early_stop(False):
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def pget(prepared: dict | None, key: str):
    """Fetch one entry of a programmed-state subtree that may be absent."""
    if prepared is None:
        return None
    return prepared.get(key)


def dense(
    params: dict,
    x: torch.Tensor,
    *,
    name: str,
    policy: MemPolicy,
    rng,
    prepared=None,
    kernels: bool = True,
) -> torch.Tensor:
    """Linear layer routed through the mem policy.  ``params`` holds
    {"w": (K, N)[, "b": (N,)]}; ``name`` is the logical layer name the
    policy matches on; ``rng`` keys programming noise; ``prepared`` is
    this layer's programmed state; ``kernels=False`` forces the plain
    versions of the kernels."""
    cfg = policy.config_for(name)
    return mem_linear(
        x, params["w"], params.get("b"), cfg, layer_key(rng, name),
        prepared=prepared, kernels=kernels,
    )


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis (kept), summed in an order that depends on
    that axis alone: halves added pairwise while the width is even, the
    rest in order.  A CUDA reduction picks its order by the number of
    rows (from 8 rows of 896 on), and a row must give the same bits in a
    decode step (slots rows) and in a speculative verify (slots x C)."""
    n = d = x.shape[-1]
    while n % 2 == 0:
        n //= 2
        x = x[..., :n] + x[..., n:]
    s = x[..., :1]
    for j in range(1, n):
        s = s + x[..., j:j + 1]
    return div(s, d)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(row_mean(x * x) + eps)
    return (x * scale.to(torch.float32)).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = row_mean(x)
    var = row_mean((x - mu) ** 2)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


def norm(x, p, kind: str):
    if kind == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))
_GELU_C = float(np.float32(0.044715))
# XLA folds the two constants of the cube's gradient into one
_GELU_C3 = float(np.float32(np.float32(_SQRT_2_OVER_PI) * np.float32(_GELU_C)))


class _Gelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        inner = xmath.fma(xmath.integer_pow(x, 3), _GELU_C, x, wait=False)
        t = xmath.tanh(inner * _SQRT_2_OVER_PI)
        ctx.save_for_backward(x, t)
        return x * ((t + 1.0) * 0.5)

    @staticmethod
    def backward(ctx, g):
        x, t = ctx.saved_tensors
        g = xmath.ftz(g)
        half = (t + 1.0) * 0.5
        a = ((x * g) * 0.5) * (1.0 - t)
        a = xmath.fma(a, t, a, wait=False)  # tanh's rule
        gx = xmath.fma(g, half, a * _SQRT_2_OVER_PI, wait=False)
        return xmath.ftz(xmath.fma(a * _GELU_C3, (x * x) * 3.0, gx, wait=False))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (``approximate=True``, its default) as XLA's CPU code
    computes it: ``x * ((1 + tanh(sqrt(2/pi) * (x + 0.044715 x**3))) *
    0.5)`` with ``x**3 = (x * x) * x``, the ``0.044715 x**3 + x`` one fused
    multiply-add and XLA's ``tanh`` (:func:`~repro_torch.core.xmath.tanh`).
    Bit for bit the jitted reference on float32.  Its gradient is JAX's
    (the rules of ``integer_pow``, the fused multiply-add and ``tanh``),
    as XLA compiles and simplifies it, bit for bit: with ``a`` the ``tanh``
    rule's ``t + t*tanh`` of ``t = (x*g*0.5) * (1 - tanh)``, ``g *
    ((1 + tanh) * 0.5) + a * sqrt(2/pi)``, then ``+ (a * c) * (x*x * 3)``,
    each sum one fused multiply-add and ``c`` the float32 product of the
    two constants."""
    return _Gelu.apply(x)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return gelu(x)
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def rope(positions: torch.Tensor, head_dim: int, theta: float):
    """Rotary embedding tables (cos, sin) for given positions (any shape)."""
    half = head_dim // 2
    neg_log = -torch.log(torch.tensor(theta, dtype=torch.float32, device=positions.device))
    freqs = torch.exp(
        div(neg_log * torch.arange(0, half, dtype=torch.float32, device=positions.device), half)
    )
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def uniform_init(key, shape, scale=None, dtype=torch.float32, device="cuda"):
    """``jax.random.uniform(key, shape, float32, -scale, scale)`` drawn on
    ``device`` (:func:`repro_torch.core.prng.uniform`, the reference's
    bits), default scale ``sqrt(3 / fan_in)``."""
    if dtype != torch.float32:
        raise NotImplementedError("initial weights are drawn in float32 only")
    fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
    if scale is None:
        scale = (3.0 / fan_in) ** 0.5
    return uniform(key, shape, -scale, scale, device=device)


def make_dense_params(key, k, n, bias=False, dtype=torch.float32, device="cuda"):
    p = {"w": uniform_init(key, (k, n), dtype=dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def make_norm_params(d, kind: str, dtype=torch.float32, device="cuda"):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p
