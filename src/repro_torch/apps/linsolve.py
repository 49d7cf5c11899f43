"""Fig. 13: solving the word-line circuit equation with conjugate
gradients, the coefficient matrix mapped on the DPE in pre-aligned FP32
(block 32x32 per the paper); port of ``repro/apps/linsolve.py``.

The banded system comes from the word-line equivalent circuit (Fig. 13a):
node i couples to its neighbours through the wire conductance gw and to
the bit line through the device conductance G_i:

    -gw*V[i-1] + (2gw + G_i)*V[i] - gw*V[i+1] = gw*Vin*[i==0]

The "hardware solver" computes every CG matrix-vector product through the
simulated DPE; the "software solver" uses exact matmuls.  All linear
algebra is float32 on the run's device.  The solvers' dot products, norms
and matrix-vector products add in the order in which XLA's CPU backend
adds the reference's (:func:`_dot`, :func:`_norm`, :func:`_matvec`):
iterative refinement stopped at the analog noise floor amplifies a
different float32 rounding there into a relative change of about 1e-3
in the final error.  ``solve`` and ``cond`` are ``torch.linalg``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps import cli_device
from repro_torch.core import DPEConfig, dpe_matmul, spec
from repro_torch.core.prng import PRNGKey
from repro_torch.core.xmath import fma


def wordline_system(n: int = 64, r_wire: float = 2.93, seed: int = 0, device="cuda"):
    gw = 1.0 / r_wire
    rng = np.random.default_rng(seed)
    g = rng.uniform(1e-7, 1e-5, n)
    a = np.zeros((n, n))
    for i in range(n):
        a[i, i] = 2 * gw + g[i] if i < n - 1 else gw + g[i]
        if i > 0:
            a[i, i - 1] = -gw
        if i < n - 1:
            a[i, i + 1] = -gw
    b = np.zeros(n)
    b[0] = gw * 0.2  # 0.2 V drive
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return f32(a), f32(b)


def _dot(u, v):
    """``jnp.dot`` of two vectors as XLA's CPU backend computes it: the
    rounded products added from the first to the last."""
    p = u * v
    s = p[0]
    for i in range(1, p.shape[0]):
        s = s + p[i]
    return s


def _norm(v):
    """``jnp.linalg.norm`` of a vector as XLA's CPU backend computes it:
    one fused multiply-add per element from the first to the last, then
    a correctly rounded square root."""
    s = torch.zeros((), dtype=v.dtype, device=v.device)
    for i in range(v.shape[0]):
        s = fma(v[i], v[i], s)
    return torch.sqrt(s.double()).float()


def _matvec(a, v):
    """``a @ v`` as XLA's CPU backend computes it: each row's rounded
    products added pairwise (neighbours first, an odd one out carried)."""
    p = a * v[None, :]
    while p.shape[1] > 1:
        head = p[:, 0:p.shape[1] - 1:2] + p[:, 1::2]
        p = torch.cat([head, p[:, -1:]], dim=1) if p.shape[1] % 2 else head
    return p[:, 0]


def cg_solve(a, b, matvec, iters: int = 60):
    """Jacobi-preconditioned CG with an injectable (possibly analog)
    matvec and analog-noise safeguards (restart when the noisy curvature
    p·Ap goes non-positive).  Returns the solution + residual history."""
    dinv = 1.0 / torch.diag(a)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = dinv * r
    p = z
    rz = _dot(r, z)
    hist = []
    bnorm = torch.clamp_min(_norm(b), 1e-30)
    for _ in range(iters):
        ap = matvec(p)
        curv = _dot(p, ap)
        # analog noise can make the quadratic model locally non-convex:
        # fall back to a (preconditioned) steepest-descent restart
        safe = curv > 1e-30
        alpha = torch.where(safe, rz / torch.where(safe, curv, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = dinv * r
        rz_new = _dot(r, z)
        hist.append(float(_norm(r) / bnorm))
        beta = torch.where(safe, rz_new / torch.clamp_min(rz, 1e-30), 0.0)
        p = z + beta * p
        rz = rz_new
    return x, hist


def refine_solve(a, b, matvec, outers: int = 12, inners: int = 8):
    """Mixed-precision iterative refinement: exact digital residuals
    outside, rough analog CG inside."""
    x = torch.zeros_like(b)
    hist = []
    bnorm = torch.clamp_min(_norm(b), 1e-30)
    for _ in range(outers):
        r = b - _matvec(a, x)  # digital exact residual
        d, _ = cg_solve(a, r, matvec, inners)  # analog inner solve
        x = x + d
        hist.append(float(_norm(b - _matvec(a, x)) / bnorm))
    return x, hist


def run(n: int = 8, var: float = 0.05, device: str = "cuda", kernels: bool = True):
    """Paper Fig. 13 regime: a short word line."""
    a, b = wordline_system(n, device=device)
    sp = spec("fp32")
    cfg = DPEConfig(
        input_spec=sp, weight_spec=sp, var=var, array_size=(32, 32),
        noise_mode="program" if var > 0 else "off",
    )
    key = PRNGKey(7)

    def hw_matvec(v):
        return dpe_matmul(v[None, :], a, cfg, key, kernels)[0]

    x_sw, hist_sw = cg_solve(a, b, lambda v: _matvec(a, v), 24)
    x_hw, hist_hw = refine_solve(a, b, hw_matvec, outers=12, inners=8)
    exact = torch.linalg.solve(a, b)
    rel = lambda u, ref: float(_norm(u - ref) / _norm(ref))  # noqa: E731
    return {
        "cond": float(torch.linalg.cond(a)),
        "sw_residuals": hist_sw,
        "hw_residuals": hist_hw,
        "sw_iters": 24,
        "hw_matvecs": 12 * 8,  # paper: hardware needs more iterations
        "sw_err": rel(x_sw, exact),
        "hw_err": rel(x_hw, exact),
        "solution_overlap": float(
            _norm(x_hw - x_sw) / torch.clamp_min(_norm(x_sw), 1e-30)
        ),
    }


if __name__ == "__main__":
    out = run(device=cli_device())
    print(f"cond(A) = {out['cond']:.0f}")
    print(f"software CG  ({out['sw_iters']} matvecs) residual: "
          f"{out['sw_residuals'][-1]:.3e}  err {out['sw_err']:.3e}")
    print(f"hardware ref ({out['hw_matvecs']} matvecs) residual: "
          f"{out['hw_residuals'][-1]:.3e}  err {out['hw_err']:.3e}")
    print(f"solution overlap (hw vs sw): {out['solution_overlap']:.3e}")
