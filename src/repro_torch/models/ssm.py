"""State-space blocks (port of ``repro/models/ssm.py``): the RWKV6
(Finch) time-mix of the ``ssm`` family and the Mamba (S6) selective scan
of the hybrid jamba.

RWKV6, per head h with key / value dims (N, N), arXiv:2404.05892:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t,   o_t = r_t (S_t + u k_t^T v_t)

with the data-dependent decay ``w_t = exp(-exp(w0 + lora(x_t)))`` and
token-shift input mixing.  Mamba, arXiv:2312.00752: x -> ``in_proj`` ->
causal depthwise conv -> SiLU -> the selective SSM

    h_t = exp(dt_t a) * h_{t-1} + (dt_t x_t) B_t,   y_t = h_t . C_t + D x_t

(dt, B, C data-dependent through ``x_proj`` and ``dt_proj``, ``a`` learned)
-> gated by SiLU(``in_proj_z`` x) -> ``out_proj``.  The projections route
through the mem-policy-aware :func:`~.common.dense`; both recurrences stay
digital, as in the reference: plain PyTorch, the same on the CPU and on a
card (the reference computes them with ``lax.scan`` and einsums, outside
any Pallas kernel).

The transcendentals replay XLA's CPU arithmetic: RWKV6's ``tanh``,
``exp`` and ``log``, Mamba's ``softplus`` (``logaddexp(x, 0)``: ``max(x,
0) + log1p(exp(-|x|))``), ``exp`` and SiLU are
:mod:`~repro_torch.core.xmath`'s, results below the float32 normal range
flushed to zero as XLA's CPU code flushes them
(:func:`~repro_torch.core.xmath.ftz`); the chunked WKV form's cumulative
sum is XLA's order (:func:`~repro_torch.core.xmath.cumsum_last` on the
chunk axis).  The einsums keep torch's summation orders and the products
torch's roundings (XLA's CPU code fuses a multiply into the add that
takes it), RWKV6's group norm takes the port's pairwise row mean and the
correctly rounded ``rsqrt`` (XLA's CPU one is an ulp off on ~14 % of
inputs); the tests state the tolerance that costs
(``tests/test_torch_rwkv6.py``, ``tests/test_torch_mamba.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core import xmath
from repro_torch.core.prng import split

from .common import dense, make_dense_params, pget, remat_call, row_mean, uniform_init

__all__ = [
    "init_rwkv6_params",
    "rwkv6_block",
    "rwkv6_decode",
    "init_rwkv6_state",
    "init_mamba_params",
    "mamba_block",
    "mamba_decode",
    "init_mamba_state",
]

WKV_CHUNK = 32  # tokens per chunk of the chunk-parallel form
CHUNKED_FROM = 64  # sequences this long or longer take the chunked form
WKV_GROUP = 16  # chunks whose state-free terms the chunked form computes at once
SCAN_CHUNK = 256  # tokens whose decays and inputs the Mamba scan computes at once


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
    exp(-x)))``, each result flushed to zero below the normal range, and
    its gradient as XLA compiles JAX's (:func:`~repro_torch.core.xmath.silu`
    over :func:`~repro_torch.core.xmath.logistic`)."""
    return xmath.silu(x)


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
    Under autograd each group is checkpointed, as the reference
    checkpoints each chunk: the backward pass recomputes a group's
    pairwise exponents instead of keeping every group's (the same
    bits).  Same arguments and results as :func:`_wkv_scan`."""
    b, s, h, n = r.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        zp = lambda a, value=0.0: torch.nn.functional.pad(  # noqa: E731
            a, (0, 0, 0, 0, 0, pad), value=value)
        r, k, v, w = zp(r), zp(k), zp(v), zp(w, 1.0)
    nc = r.shape[1] // c
    outs = []
    for g0 in range(0, nc, group):
        m = min(group, nc - g0)
        part = [a[:, g0 * c:(g0 + m) * c].reshape(b, m, c, h, n) for a in (r, k, v, w)]
        if torch.is_grad_enabled():
            out, state = remat_call(_wkv_group, *part, u, state)
        else:
            out, state = _wkv_group(*part, u, state)
        outs.append(out)
    return torch.cat(outs, dim=1)[:, :s], state


def _wkv_group(rt, kt, vt, wt, u, state):
    """One group of :func:`_wkv_chunked`: rt / kt / vt / wt (B, G, C, H, N),
    the state carried in; returns (out (B, G*C, H, N), the state after the
    group)."""
    c = rt.shape[2]
    tri = torch.ones((c, c), dtype=torch.bool, device=rt.device).tril(-1)  # s <= t - 1
    mask = tri[None, None, :, :, None, None]
    bonus = u[None, None, None]
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
    outs = []
    for j in range(rt.shape[1]):
        out = torch.einsum("bthn,bhnv->bthv", r_dec[:, j], state)
        outs.append((out + intra[:, j]) + diag[:, j])
        state = decay[:, j] * state + kv[:, j]
    return torch.cat(outs, dim=1), state


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


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def _mamba_dims(cfg):
    """(d_inner, dt_rank, d_state, d_conv); ``dt_rank`` 0 is
    ``ceil(d_model / 16)``."""
    s = cfg.ssm
    return s.expand * cfg.d_model, s.dt_rank or -(-cfg.d_model // 16), s.d_state, s.d_conv


def init_mamba_params(key, cfg, dtype=torch.float32, device="cuda"):
    """The Mamba block's params, the reference's draws bit for bit
    (``split(key, 8)``); ``a_log = log(1 .. d_state)`` by XLA's ``log``."""
    d = cfg.d_model
    d_in, dt_rank, d_state, d_conv = _mamba_dims(cfg)
    ks = split(key, 8)
    kw = dict(dtype=dtype, device=device)
    a = torch.arange(1, d_state + 1, dtype=torch.float32, device=device).repeat(d_in, 1)
    return {
        "in_proj": make_dense_params(ks[0], d, d_in, False, **kw),
        "in_proj_z": make_dense_params(ks[1], d, d_in, False, **kw),
        "conv": {"w": uniform_init(ks[2], (d_conv, d_in), **kw),
                 "b": torch.zeros((d_in,), **kw)},
        "x_proj": make_dense_params(ks[3], d_in, dt_rank + 2 * d_state, False, **kw),
        "dt_proj": make_dense_params(ks[4], dt_rank, d_in, True, **kw),
        "a_log": xmath.log(a),
        "d_skip": torch.ones((d_in,), **kw),
        "out_proj": make_dense_params(ks[5], d_in, d, False, **kw),
    }


def _causal_conv(x, w, b, cache=None):
    """Depthwise causal conv of x (B, S, C) by w (K, C), in ``x.dtype``:
    the K products of each tap added in order, then ``+ b``.  ``cache``
    (B, K-1, C) holds the previous inputs (zeros without it).  Returns
    (out, the last K-1 inputs)."""
    k = w.shape[0]
    w = w.to(x.dtype)
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
           if cache is None else cache.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = xp[:, :s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b.to(x.dtype), (xp[:, -(k - 1):] if k > 1 else None)


class _Scan(torch.autograd.Function):
    """One chunk of the selective scan: ``da``, ``dbx`` (B, C, d_in, N),
    ``cmat`` (B, C, N), ``h0`` (B, d_in, N) to the readouts ``ys`` (B, C,
    d_in) and the last state.  The forward writes every state of ``h =
    da[:, t] * h + dbx[:, t]`` in place; the backward is the reverse scan: with
    ``gh_t = C_t g_y_t + da_{t+1} gh_{t+1}`` (``gh`` of the last state
    entering at the end), ``g_da_t = gh_t h_{t-1}``, ``g_dbx_t = gh_t``,
    ``g_C_t = h_t . g_y_t`` and ``g_h0 = da_0 gh_0``."""

    @staticmethod
    def forward(ctx, da, dbx, cmat, h0):
        hs, h = torch.empty_like(da), h0
        for t in range(da.shape[1]):
            h = torch.add(da[:, t] * h, dbx[:, t], out=hs[:, t])
        ctx.save_for_backward(da, cmat, h0, hs)
        return torch.einsum("bcdn,bcn->bcd", hs, cmat), hs[:, -1].clone()

    @staticmethod
    def backward(ctx, g_ys, g_h):
        da, cmat, h0, hs = ctx.saved_tensors
        g_c = torch.einsum("bcdn,bcd->bcn", hs, g_ys)
        g_da = torch.empty_like(da)
        g_dbx = torch.empty_like(da)
        gh = torch.zeros_like(h0) if g_h is None else g_h
        for t in range(da.shape[1] - 1, -1, -1):
            gh = torch.add(gh, g_ys[:, t, :, None] * cmat[:, t, None, :], out=g_dbx[:, t])
            torch.mul(gh, hs[:, t - 1] if t else h0, out=g_da[:, t])
            gh = da[:, t] * gh
        return g_da, g_dbx, g_c, gh


def _selective_scan(xc, dt, bmat, cmat, a, h):
    """The selective scan a token at a time: xc, dt (B, S, d_in), bmat,
    cmat (B, S, N), a (d_in, N), h (B, d_in, N), all float32.  Per token
    ``h = exp(dt a) * h + (dt x) B`` and ``y = h . C``; the decays and
    inputs of ``SCAN_CHUNK`` tokens are computed at once, the readouts of
    their states in one product.  Each chunk's recurrence is one
    :class:`_Scan` (its reverse scan the backward); the decays and inputs
    stay under autograd (``exp``'s rule).  Returns (y (B, S,
    d_in), the last h)."""
    s = xc.shape[1]
    ys = []
    for c0 in range(0, s, SCAN_CHUNK):
        c1 = min(c0 + SCAN_CHUNK, s)
        dtc = dt[:, c0:c1, :, None]
        da = _exp(dtc * a)  # (B, C, d_in, N)
        dbx = (dtc * xc[:, c0:c1, :, None]) * bmat[:, c0:c1, None, :]
        y, h = _Scan.apply(da, dbx, cmat[:, c0:c1], h)
        ys.append(y)
        del da, dbx
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)), h


def mamba_block(p, x, cfg, *, policy, rng, name, state=None, conv_cache=None, prepared=None,
                kernels=True):
    """Full-sequence Mamba block of x (B, S, d); ``state`` (B, d_in, N)
    float32 and ``conv_cache`` (B, K-1, d_in) carry a previous segment
    (zeros without them).  Returns (y, (state, conv window in
    ``x.dtype``))."""
    b, s, d = x.shape
    d_in, dt_rank, d_state, d_conv = _mamba_dims(cfg)
    kw = dict(policy=policy, rng=rng, kernels=kernels)
    xin = dense(p["in_proj"], x, name=f"{name}.in", prepared=pget(prepared, "in_proj"), **kw)
    z = dense(p["in_proj_z"], x, name=f"{name}.z", prepared=pget(prepared, "in_proj_z"), **kw)
    xc, new_conv = _causal_conv(xin, p["conv"]["w"], p["conv"]["b"], conv_cache)
    xc = _silu(xc)
    xdbc = dense(p["x_proj"], xc, name=f"{name}.xp", prepared=pget(prepared, "x_proj"), **kw)
    bmat = xdbc[..., dt_rank:dt_rank + d_state].to(torch.float32)
    cmat = xdbc[..., dt_rank + d_state:].to(torch.float32)
    dt = dense(p["dt_proj"], xdbc[..., :dt_rank], name=f"{name}.dt",
               prepared=pget(prepared, "dt_proj"), **kw)
    dt = xmath.softplus(dt.to(torch.float32))
    a = -_exp(p["a_log"])
    if state is None:
        state = torch.zeros((b, d_in, d_state), dtype=torch.float32, device=x.device)
    xf = xc.to(torch.float32)
    y, state = _selective_scan(xf, dt, bmat, cmat, a, state)
    y = (y + xf * p["d_skip"]).to(x.dtype) * _silu(z)
    out = dense(p["out_proj"], y, name=f"{name}.out", prepared=pget(prepared, "out_proj"), **kw)
    if new_conv is None:
        new_conv = torch.zeros((b, d_conv - 1, d_in), dtype=x.dtype, device=x.device)
    return out, (state, new_conv)


def init_mamba_state(cfg, batch, layers, dtype=torch.bfloat16, device="cuda"):
    """Zero Mamba state of ``layers`` layers: ``h`` (layers, B, d_in, N)
    float32 and the conv window ``conv`` (layers, B, K-1, d_in) in
    ``dtype``."""
    d_in, _, d_state, d_conv = _mamba_dims(cfg)
    return {
        "h": torch.zeros((layers, batch, d_in, d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((layers, batch, d_conv - 1, d_in), dtype=dtype, device=device),
    }


def mamba_decode(p, x1, cfg, *, policy, rng, name, state, conv_cache, prepared=None,
                 kernels=True):
    """One token x1 (B, d) against ``state`` (B, d_in, N) and ``conv_cache``
    (B, K-1, d_in).  Returns (y1, new state, new conv window)."""
    y, (state, conv_cache) = mamba_block(
        p, x1[:, None, :], cfg, policy=policy, rng=rng, name=name, state=state,
        conv_cache=conv_cache, prepared=prepared, kernels=kernels,
    )
    return y[:, 0], state, conv_cache
