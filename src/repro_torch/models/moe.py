"""Token-choice top-k Mixture-of-Experts with capacity-bounded dispatch
(port of ``repro/models/moe.py``).

Dispatch is per batch row (sort-based, GShard / Switch style): each
row's ``S`` tokens route to ``top_k`` experts, each expert taking at most
``C = moe_capacity(S)`` of a row's choices; overflowing choices are
dropped (their combine weight is zero) and unfilled buffer slots hold the
row's zero padding token, which the experts compute as the reference's
do.  So a row's output depends on its own tokens only, but on where a
chunk boundary cuts them (``C`` depends on ``S``).

Under a hardware policy the expert projections run on programmed expert
stacks, one stacked product per projection: a faithful stack is one
launch of K1 over every expert (:func:`repro_torch.core.dpe.dpe_matmul_prepared`).
The per-expert keys are the reference's: ``fold_in(layer_key(rng,
f"{name}.experts"), i)`` with ``i`` in ``[0, E)`` for ``wi``, ``[E, 2E)``
for ``wg`` and ``[2E, 3E)`` for ``wo``.  Without programmed state each
stack is programmed on the fly from those keys just before its product
and dropped after it (:func:`repro_torch.core.layers.mem_matmul_stack`,
straight-through gradients per expert: the trainer's path).

Gradients are the reference's rules: the router's softmax as XLA
compiles ``jax.nn.softmax``'s, the top-k values scattered back to the
chosen experts, the dispatch gather's transpose summing a token's slots
in slot order (deterministic on a card too), the combine's fused
multiply-adds ``g * wk`` to the values and ``g * vals`` (summed over the
width in XLA's order) to the weights.

Arithmetic held to the reference's: the router's softmax replays XLA's
CPU ``exp`` and sum; ``top_k`` breaks ties towards the lower expert index
(``jax.lax.top_k``'s order, a stable descending sort here); the combine
adds the k choices in order as XLA's CPU backend compiles ``y + vals *
wk`` in float32: the first product fused into the sum with the second
(rounded), then one fused multiply-add a choice (bitwise on exact
products, ``tests/test_torch_moe.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core import xmath
from repro_torch.core.dpe import program_stack
from repro_torch.core.layers import layer_key, mem_matmul_prepared, mem_matmul_stack
from repro_torch.core.prng import split

from .common import activation, dense, make_dense_params, pget, uniform_init

__all__ = ["init_moe_params", "moe_block", "moe_capacity", "program_experts"]

_PROJ = ("wi", "wg", "wo")  # in the order of their key offsets 0, E, 2E


def moe_capacity(cfg_moe, tokens_per_row: int) -> int:
    """Per-expert capacity of a row of ``tokens_per_row`` tokens: the
    float product truncated by ``int``, rounded up to a multiple of 8,
    at least 8."""
    c = int(tokens_per_row * cfg_moe.top_k / cfg_moe.n_experts * cfg_moe.capacity_factor)
    return max(8, -(-c // 8) * 8)


def init_moe_params(key, cfg, dtype=torch.float32, device="cuda"):
    """The router (d, E) and the expert stacks ``wi`` / ``wg`` (E, d, f)
    and ``wo`` (E, f, d) from ``split(key, 4)``, as the reference draws
    them (its ``uniform_init`` takes ``fan_in = shape[0]``, which is E
    for a stack)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.n_experts
    ks = split(key, 4)
    return {
        "router": make_dense_params(ks[0], d, e, False, dtype, device),
        "experts": {
            "wi": uniform_init(ks[1], (e, d, f), dtype=dtype, device=device),
            "wg": uniform_init(ks[2], (e, d, f), dtype=dtype, device=device),
            "wo": uniform_init(ks[3], (e, f, d), dtype=dtype, device=device),
        },
    }


def program_experts(experts: dict, cfg, key, t_prog=None, kernels: bool = True) -> dict:
    """Program the three expert stacks under ``cfg`` (faithful or fast)
    with the reference's per-expert keys ``fold_in(key, j * E + i)``
    (:func:`~repro_torch.core.dpe.program_stack`)."""
    e = experts["wi"].shape[0]
    return {name: program_stack(experts[name], cfg, key, j * e, t_prog, kernels)
            for j, name in enumerate(_PROJ)}


def _dispatch_indices(eidx: torch.Tensor, n_experts: int, capacity: int):
    """Per-row dispatch bookkeeping of ``eidx`` (..., T, k), the expert
    chosen by each (token, choice); every leading index is a row of its
    own.  Returns int64 ``(buf_token_idx (..., E*C), slot (..., T*k),
    valid (..., T*k), token (..., T*k))``: the token each buffer slot
    holds (T, the padding token, where none), each choice's slot and
    whether it fit, and its token."""
    lead = eidx.shape[:-2]
    t, k = eidx.shape[-2:]
    dev = eidx.device
    flat = eidx.reshape(-1, t * k).long()
    rows = flat.shape[0]
    order = torch.argsort(flat, dim=1, stable=True)
    sorted_e = torch.gather(flat, 1, order)
    counts = torch.zeros((rows, n_experts), dtype=torch.int64, device=dev).scatter_add_(
        1, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=1) - counts  # exclusive cumsum
    pos = torch.arange(t * k, device=dev) - torch.gather(starts, 1, sorted_e)
    valid_sorted = pos < capacity
    slot_sorted = sorted_e * capacity + torch.clamp_max(pos, capacity - 1)
    token_sorted = order // k
    # scatter slot -> token; overflowing choices go to one extra column
    # that is dropped (the reference's out-of-range index, mode="drop")
    buf = torch.full((rows, n_experts * capacity + 1), t, dtype=torch.int64, device=dev)
    buf.scatter_(1, torch.where(valid_sorted, slot_sorted, n_experts * capacity), token_sorted)
    buf = buf[:, :-1]
    # invert the sort for the per-choice combine
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(t * k, device=dev).expand(rows, t * k).contiguous())
    slot = torch.gather(slot_sorted, 1, inv)
    valid = torch.gather(valid_sorted, 1, inv)
    token = (torch.arange(t * k, device=dev) // k).expand(rows, t * k)
    return tuple(a.reshape(*lead, a.shape[-1]) for a in (buf, slot, valid, token))


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties taken
    lower index first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class _Dispatch(torch.autograd.Function):
    """The gather of a row's tokens into its expert buffers, ``buf[b, j] =
    xpad[b, buf_idx[b, j]]`` (x with the zero padding token appended).
    Backward: a token's gradient sums the buffer slots of its valid
    choices from zero in slot order, as XLA's CPU scatter-add (the
    gather's transpose) does; the same bits on a card, where a scatter-add
    adds with atomics, in no fixed order."""

    @staticmethod
    def forward(ctx, x, buf_idx, slot, valid, k):
        b, s, d = x.shape
        ctx.save_for_backward(slot, valid)
        ctx.k = k
        xpad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
        return torch.gather(xpad, 1, buf_idx[..., None].expand(b, buf_idx.shape[1], d))

    @staticmethod
    def backward(ctx, g):
        slot, valid = ctx.saved_tensors
        b, _, d = g.shape
        k = ctx.k
        s = slot.shape[1] // k
        slot_k, valid_k = slot.reshape(b, s, k), valid.reshape(b, s, k)
        order = torch.argsort(torch.where(valid_k, slot_k, g.shape[1]), dim=-1, stable=True)
        slot_k, valid_k = torch.gather(slot_k, 2, order), torch.gather(valid_k, 2, order)
        gx = g.new_zeros((b, s, d))
        for kk in range(k):
            vals = torch.gather(g, 1, slot_k[:, :, kk, None].expand(b, s, d))
            gx = gx + torch.where(valid_k[:, :, kk, None], vals, torch.zeros_like(vals))
        return gx, None, None, None, None


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis in float32 with XLA's CPU
    ``exp`` and summation order, and its gradient as XLA compiles JAX's
    rule (:func:`~repro_torch.core.xmath.softmax`)."""
    return xmath.softmax(x)


def moe_block(p, x, cfg, *, policy, rng, name, prepared=None, kernels=True):
    """x (B, S, d) -> (B, S, d) in x's dtype: router, top-k, per-row
    dispatch into (B, E, C, d), the experts' gated FFN, the combine."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    cap = moe_capacity(m, s)
    gates = dense(p["router"], x, name=f"{name}.router", policy=policy, rng=rng,
                  prepared=pget(prepared, "router"), kernels=kernels)
    top_p, top_e = _top_k(_softmax(gates.to(torch.float32)), k)  # (B, S, k)
    top_p = top_p / torch.clamp_min(xmath.sum_last(top_p), 1e-9)[..., None]

    buf_idx, slot, valid, _ = _dispatch_indices(top_e, e, cap)
    buf = _Dispatch.apply(x, buf_idx, slot, valid, k).reshape(b, e, cap, d)
    ex = p["experts"]
    mem_cfg = policy.config_for(f"{name}.experts")
    if mem_cfg is not None and mem_cfg.mode != "digital":
        prog = pget(prepared, "experts")
        bufe = buf.transpose(0, 1).reshape(e, b * cap, d)
        if prog is None:  # per-call: each stack programmed from its keys, straight-through
            key = layer_key(rng, f"{name}.experts")
            h = mem_matmul_stack(bufe, ex["wi"], key, mem_cfg, 0, kernels)
            g = mem_matmul_stack(bufe, ex["wg"], key, mem_cfg, e, kernels)
            h = activation(g, cfg.act) * h
            out = mem_matmul_stack(h, ex["wo"], key, mem_cfg, 2 * e, kernels)
        else:
            f = ex["wi"].shape[2]
            h = mem_matmul_prepared(bufe, prog["wi"], f, mem_cfg, kernels)
            g = mem_matmul_prepared(bufe, prog["wg"], f, mem_cfg, kernels)
            h = activation(g, cfg.act) * h
            out = mem_matmul_prepared(h, prog["wo"], d, mem_cfg, kernels)
        out = out.reshape(e, b, cap, d).transpose(0, 1)
    else:
        h = torch.einsum("becd,edf->becf", buf, ex["wi"].to(buf.dtype))
        g = torch.einsum("becd,edf->becf", buf, ex["wg"].to(buf.dtype))
        h = activation(g, cfg.act) * h
        out = torch.einsum("becf,efd->becd", h, ex["wo"].to(buf.dtype))
    out = out.reshape(b, e * cap, d)

    # combine, looping over the k choices in order
    wts = top_p.to(out.dtype)
    slot_k = slot.reshape(b, s, k)
    valid_k = valid.reshape(b, s, k).to(out.dtype)
    terms = []
    y = None
    for kk in range(k):
        vals = torch.gather(out, 1, slot_k[:, :, kk, None].expand(b, s, d))
        wk = (wts[:, :, kk] * valid_k[:, :, kk])[:, :, None]
        if out.dtype != torch.float32:
            y = vals * wk if y is None else y + vals * wk
        elif kk == 0:
            terms = (vals, wk)
        elif kk == 1:  # the first sum fuses the first product into the second's
            y = xmath.fma(*terms, vals * wk, wait=False)
        else:
            y = xmath.fma(vals, wk, y, wait=False)
    if y is None:  # top_k == 1 in float32
        y = terms[0] * terms[1]
    return y.to(x.dtype)
