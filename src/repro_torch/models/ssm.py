"""RWKV6 (Finch) time-mix: the recurrent block of the ``ssm`` family
(port of the RWKV6 half of ``repro/models/ssm.py``; Mamba is not
ported yet).

Per head h with key / value dims (N, N), arXiv:2404.05892:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t,   o_t = r_t (S_t + u k_t^T v_t)

with the data-dependent decay ``w_t = exp(-exp(w0 + lora(x_t)))`` and
token-shift input mixing.  The projections (r, k, v, g and the output)
route through the mem-policy-aware :func:`~.common.dense`; the WKV
recurrence stays digital, as in the reference: plain PyTorch, the same
on the CPU and on a card (the reference computes it with ``lax.scan``
and einsums, outside any Pallas kernel).

The decay replays XLA's CPU arithmetic where it feeds an exponent:
``tanh``, ``exp`` and ``log`` are :mod:`~repro_torch.core.xmath`'s,
the chunked form's cumulative sum is XLA's order
(:func:`~repro_torch.core.xmath.cumsum_last` on the chunk axis), and
results below the float32 normal range are flushed to zero as XLA's CPU
code flushes them (:func:`~repro_torch.core.xmath.ftz`).  The einsums
keep torch's summation orders, the group norm takes the port's pairwise
row mean and the correctly rounded ``rsqrt`` (XLA's CPU one is an ulp
off on ~14 % of inputs); the tests state the tolerance that costs
(``tests/test_torch_rwkv6.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core import xmath
from repro_torch.core.prng import split

from .common import dense, make_dense_params, pget, row_mean, uniform_init

__all__ = [
    "init_rwkv6_params",
    "rwkv6_block",
    "rwkv6_decode",
    "init_rwkv6_state",
]

WKV_CHUNK = 32  # tokens per chunk of the chunk-parallel form
CHUNKED_FROM = 64  # sequences this long or longer take the chunked form
WKV_GROUP = 16  # chunks whose state-free terms the chunked form computes at once


def _rwkv_dims(cfg):
    hd = cfg.ssm.head_dim
    return cfg.d_model // hd, hd


def init_rwkv6_params(key, cfg, dtype=torch.float32, device="cuda"):
    """The time-mix params, the reference's draws bit for bit
    (``split(key, 12)``; the channel-mix MLP lives in the block)."""
    d = cfg.d_model
    nh, hd = _rwkv_dims(cfg)
    lora = max(32, d // 32)
    ks = split(key, 12)
    kw = dict(dtype=dtype, device=device)
    return {
        "mu": uniform_init(ks[0], (5, d), scale=0.5, **kw),
        "r_proj": make_dense_params(ks[1], d, d, False, **kw),
        "k_proj_ssm": make_dense_params(ks[2], d, d, False, **kw),
        "v_proj_ssm": make_dense_params(ks[3], d, d, False, **kw),
        "g_proj": make_dense_params(ks[4], d, d, False, **kw),
        "w0": uniform_init(ks[5], (d,), scale=1.0, **kw),
        "w_lora_a": uniform_init(ks[6], (d, lora), **kw),
        "w_lora_b": uniform_init(ks[7], (lora, d), scale=0.01, **kw),
        "u": uniform_init(ks[8], (nh, hd), scale=0.5, **kw),
        "ln_x": {"scale": torch.ones((d,), **kw), "bias": torch.zeros((d,), **kw)},
        "wkv_out": make_dense_params(ks[9], d, d, False, **kw),
    }


def _rwkv6_mix(p, x, x_prev):
    """Token-shift mixing: the inputs of (w, k, v, r, g), each ``x + (x_prev
    - x) * mu[i]``."""
    dx = x_prev - x
    mu = p["mu"].to(x.dtype)
    return tuple(x + dx * mu[i] for i in range(5))


def _exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``exp``, its subnormal results flushed to zero."""
    return xmath.ftz(xmath.exp(x))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA's CPU code computes it: ``x * (1 / (1 +
    exp(-x)))``, each result flushed to zero below the normal range."""
    return xmath.ftz(x * xmath.ftz(torch.ones_like(x) / (1.0 + _exp(-x))))


def _wkv_scan(r, k, v, w, u, state):
    """The WKV6 recurrence one token at a time.  r / k / v / w (B, S, H, N),
    u (H, N), state (B, H, N, N) [key x value]; returns (out (B, S, H, N),
    the new state).  The decode path, and the oracle of the chunked
    form."""
    w = xmath.ftz(w)
    bonus = u[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, N, N)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + bonus * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


def _wkv_chunked(r, k, v, w, u, state, chunk: int = WKV_CHUNK, group: int = WKV_GROUP):
    """The chunk-parallel WKV6 form: per chunk of C tokens, with LW the
    inclusive cumulative sum of the log-decays,

        out_t = (r_t * e^{LW_{t-1}}) S_0
              + sum_{s<t} [sum_n r_tn k_sn e^{LW_{t-1,n} - LW_{s,n}}] v_s
              + (r_t . (u * k_t)) v_t
        S_C   = e^{LW_C} * S_0 + sum_s (k_s * e^{LW_C - LW_s})^T v_s

    Every exponent is <= 0 (the pairwise ones masked to -inf before the
    ``exp``), so the form holds for any decay; the last chunk is padded
    with zeros and decays of 1.0, decays are clamped to 1e-37 before the
    ``log``.  The terms that do not read the state are computed for
    ``group`` chunks at a time (the pairwise exponents of a group of 16
    chunks of one row at rwkv6-1.6b's heads take 128 MiB), the state is
    carried chunk by chunk: the reference's arithmetic per chunk, in
    fewer launches (on the CPU bit-equal to one chunk at a time; on a
    card the batched products may take other summation orders, and a
    4,096-token prefill takes a third of the time: ``tools/wkv_group.py``).
    Same arguments and results as :func:`_wkv_scan`."""
    b, s, h, n = r.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        zp = lambda a, value=0.0: torch.nn.functional.pad(  # noqa: E731
            a, (0, 0, 0, 0, 0, pad), value=value)
        r, k, v, w = zp(r), zp(k), zp(v), zp(w, 1.0)
    nc = r.shape[1] // c
    tri = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)  # s <= t - 1
    mask = tri[None, None, :, :, None, None]
    bonus = u[None, None, None]
    outs = []
    for g0 in range(0, nc, group):
        m = min(group, nc - g0)
        rt, kt, vt, wt = (a[:, g0 * c:(g0 + m) * c].reshape(b, m, c, h, n)
                          for a in (r, k, v, w))  # (B, G, C, H, N)
        logw = xmath.log(torch.clamp_min(wt, 1e-37))
        lw = xmath.cumsum_last(logw.movedim(2, -1)).movedim(-1, 2)  # inclusive
        lw_prev = lw - logw
        r_dec = rt * _exp(lw_prev)
        d = lw_prev[:, :, :, None] - lw[:, :, None]  # (B, G, C_t, C_s, H, N)
        e = _exp(torch.where(mask, d, torch.full_like(d, float("-inf"))))
        a_intra = torch.einsum("bgthn,bgshn,bgtshn->bgths", rt, kt, e)
        del d, e
        intra = torch.einsum("bgths,bgshv->bgthv", a_intra, vt)
        diag = torch.einsum("bgthn,bgthn->bgth", rt, bonus * kt)[..., None] * vt
        lw_end = lw[:, :, -1:]
        kv = torch.einsum("bgshn,bgshv->bghnv", kt * _exp(lw_end - lw), vt)
        decay = _exp(lw_end[:, :, 0])[..., None]  # (B, G, H, N, 1)
        for j in range(m):
            out = torch.einsum("bthn,bhnv->bthv", r_dec[:, j], state)
            outs.append((out + intra[:, j]) + diag[:, j])
            state = decay[:, j] * state + kv[:, j]
    return torch.cat(outs, dim=1)[:, :s], state


def rwkv6_block(p, x, cfg, *, policy, rng, name, state=None, x_prev=None, prepared=None,
                kernels=True):
    """Full-sequence RWKV6 time-mix of x (B, S, d); ``state`` (B, H, N, N)
    and ``x_prev`` (B, d) carry a previous segment (zeros without them).
    Returns (y, (state, x_last)).  Sequences of 64 tokens or more take
    the chunked form, shorter ones the scan, as the reference's."""
    b, s, d = x.shape
    nh, hd = _rwkv_dims(cfg)
    first = (torch.zeros((b, 1, d), dtype=x.dtype, device=x.device) if x_prev is None
             else x_prev[:, None, :])
    x_shift = torch.cat([first, x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _rwkv6_mix(p, x, x_shift)
    kw = dict(policy=policy, rng=rng, kernels=kernels)
    r = dense(p["r_proj"], xr, name=f"{name}.r", prepared=pget(prepared, "r_proj"), **kw)
    k = dense(p["k_proj_ssm"], xk, name=f"{name}.k", prepared=pget(prepared, "k_proj_ssm"),
              **kw)
    v = dense(p["v_proj_ssm"], xv, name=f"{name}.v", prepared=pget(prepared, "v_proj_ssm"),
              **kw)
    g = _silu(dense(p["g_proj"], xg, name=f"{name}.g", prepared=pget(prepared, "g_proj"),
                    **kw))
    # the data-dependent decay
    wlo = xmath.tanh(xw.to(torch.float32) @ p["w_lora_a"]) @ p["w_lora_b"]
    w = _exp(-_exp(p["w0"].to(torch.float32) + wlo))
    shp = (b, s, nh, hd)
    r4, k4, v4, w4 = (a.reshape(shp).to(torch.float32) for a in (r, k, v, w))
    if state is None:
        state = torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=x.device)
    wkv = _wkv_chunked if s >= CHUNKED_FROM else _wkv_scan
    out, state = wkv(r4, k4, v4, w4, p["u"].to(torch.float32), state)
    # per-head group norm
    mu = row_mean(out)
    var = row_mean((out - mu) ** 2)
    out = ((out - mu) * xmath.rsqrt(var + 1e-5)).reshape(b, s, d)
    out = out * p["ln_x"]["scale"] + p["ln_x"]["bias"]
    out = out.to(x.dtype) * g
    y = dense(p["wkv_out"], out, name=f"{name}.o", prepared=pget(prepared, "wkv_out"), **kw)
    return y, (state, x[:, -1, :])


def init_rwkv6_state(cfg, batch, layers, dtype=torch.float32, device="cuda"):
    """Zero recurrent state of ``layers`` layers: ``s`` (layers, B, H, N, N)
    float32 and ``x_prev`` (layers, B, d) in ``dtype``."""
    nh, hd = _rwkv_dims(cfg)
    return {
        "s": torch.zeros((layers, batch, nh, hd, hd), dtype=torch.float32, device=device),
        "x_prev": torch.zeros((layers, batch, cfg.d_model), dtype=dtype, device=device),
    }


def rwkv6_decode(p, x1, cfg, *, policy, rng, name, state, x_prev, prepared=None,
                 kernels=True):
    """One token x1 (B, d) against ``state`` (B, H, N, N) and ``x_prev``
    (B, d).  Returns (y1, new state, new x_prev)."""
    y, (state, x_last) = rwkv6_block(
        p, x1[:, None, :], cfg, policy=policy, rng=rng, name=name, state=state,
        x_prev=x_prev, prepared=prepared, kernels=kernels,
    )
    return y[:, 0], state, x_last
