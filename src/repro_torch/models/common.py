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

import math

import torch
import torch.nn.functional as F

from repro_torch.core.layers import MemPolicy, layer_key, mem_linear
from repro_torch.core.quant import div
from repro_torch.core.prng import fold_in

__all__ = [
    "dense",
    "pget",
    "rms_norm",
    "layer_norm",
    "norm",
    "activation",
    "rope",
    "apply_rope",
    "make_dense_params",
    "make_norm_params",
    "uniform_init",
    "tree_map",
    "tree_leaves",
    "layer_slice",
    "stack_layers",
]


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of nested dicts / NamedTuples
    (other leaves, e.g. ``None`` or a float timestamp, pass through)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def tree_leaves(tree) -> list:
    out = []
    tree_map(lambda t: out.append(t), tree)
    return out


def layer_slice(tree, idx: int):
    """Layer ``idx`` of a stacked segment (views, no copy)."""
    return tree_map(lambda t: t[idx], tree)


def stack_layers(make_layer, steps: int):
    """Build a stacked segment from ``make_layer(idx)`` without holding
    more than one layer's temporaries: the first layer fixes the
    structure, every layer is copied into preallocated stacked leaves."""
    first = make_layer(0)
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


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.to(torch.float32)).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


def norm(x, p, kind: str):
    if kind == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
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


def _generator(key, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with the key's 64 bits
    (initial weights need not be the reference's bits: tests carry the
    parameters across)."""
    hi, lo = (int(v) for v in key)
    g = torch.Generator(device=device)
    g.manual_seed(((hi << 32) | lo) & ((1 << 63) - 1))
    return g


def uniform_init(key, shape, scale=None, dtype=torch.float32, device="cuda"):
    """U(-scale, scale), default scale sqrt(3 / fan_in), from a generator
    on ``device`` seeded by the prng ``key``."""
    fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
    if scale is None:
        scale = math.sqrt(3.0 / fan_in)
    u = torch.rand(tuple(shape), generator=_generator(key, device), dtype=torch.float32,
                   device=device)
    return (u * (2.0 * scale) - scale).to(dtype)


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


def init_key(key, *path: int):
    """Key for one initialised tensor, folded down ``path``."""
    for p in path:
        key = fold_in(key, p)
    return key
