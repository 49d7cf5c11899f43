"""Crossbar circuit model with wire resistance (IR-drop) — MemIntelli
§3.2, paper Fig. 4 (port of ``repro/core/crossbar.py``).

An R x C crossbar: cell (i, j) is a memristor of conductance ``G[i, j]``
between word-line node ``Vw[i, j]`` and bit-line node ``Vb[i, j]``;
neighbouring nodes on a line are joined by the wire conductance
``gw = 1 / r_wire``.  Inputs drive the word lines from the left through
one wire segment; bit lines are sensed at the bottom through one segment
into a virtual ground.  Without wire resistance the column currents are
the ideal ``I = G^T V``; with it, IR-drop attenuates them.

:func:`solve_crossbar` is the reference's cross-iteration solve: every
word line, then every bit line, as independent tridiagonal systems
(Thomas algorithm, :func:`_thomas`) with the other side held fixed, a
relaxed fixed point of ``iters`` sweeps.  Every function works on
batches: leading dimensions of ``g`` and ``v_in`` broadcast, which is how
the circuit backend of :mod:`.dpe` solves all its tiles and input rows
at once (the reference ``vmap``-s the same solve).  The Thomas sweeps are
sequential loops over a line's nodes, float32 as the reference's
``lax.scan``; there is no kernel for them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "CrossbarResult",
    "ideal_currents",
    "solve_crossbar",
    "exact_node_voltages",
    "kcl_residual",
]


class CrossbarResult(NamedTuple):
    vw: torch.Tensor  # (..., R, C) word-line node voltages
    vb: torch.Tensor  # (..., R, C) bit-line node voltages
    i_out: torch.Tensor  # (..., C) sensed column currents
    residual: torch.Tensor  # (...) final relative KCL residual


def ideal_currents(g: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
    """Ohm / Kirchhoff ideal dot product (no wire resistance):
    ``G^T V``."""
    return g.transpose(-1, -2) @ v_in


def _thomas(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor):
    """Solve a batch of tridiagonal systems (Thomas algorithm), the
    reference's forward sweep and back substitution in its order.  All
    inputs (..., n) (broadcast); ``dl[..., 0]`` and ``du[..., -1]`` are
    ignored.  Returns (..., n)."""
    dl, d, du, b = torch.broadcast_tensors(dl, d, du, b)
    n = d.shape[-1]
    cp = torch.empty_like(d)
    dp = torch.empty_like(d)
    cp_prev = torch.zeros_like(d[..., 0])
    dp_prev = torch.zeros_like(d[..., 0])
    for t in range(n):
        denom = d[..., t] - dl[..., t] * cp_prev
        cp_prev = du[..., t] / denom
        dp_prev = (b[..., t] - dl[..., t] * dp_prev) / denom
        cp[..., t] = cp_prev
        dp[..., t] = dp_prev
    x = torch.empty_like(d)
    x_next = torch.zeros_like(d[..., 0])
    for t in range(n - 1, -1, -1):
        x_next = dp[..., t] - cp[..., t] * x_next
        x[..., t] = x_next
    return x


def _off_diagonals(g: torch.Tensor, gw: torch.Tensor):
    """The (..., n) lower / upper diagonals ``-gw`` of one line's system,
    with the ends that have no neighbour set to zero."""
    dl = torch.full_like(g, 0.0) - gw
    dl[..., 0] = 0.0
    du = torch.full_like(g, 0.0) - gw
    du[..., -1] = 0.0
    return dl, du


def _solve_wordlines(g, v_in, gw, vb):
    """One word-line half-step: solve Vw along each row given Vb.  Node j
    of row i: ``-gw Vw[j-1] + (2gw + G) Vw[j] - gw Vw[j+1] = G Vb[j]``;
    j = 0 adds the source through one wire segment, j = C-1 has no right
    neighbour."""
    d = 2.0 * gw + g
    d[..., -1] -= gw
    dl, du = _off_diagonals(g, gw)
    b = g * vb
    b[..., 0] += gw * v_in
    return _thomas(dl, d, du, b)


def _solve_bitlines(g, gw, vw):
    """One bit-line half-step: solve Vb down each column given Vw.  Node
    i of column j: ``-gw Vb[i-1] + (2gw + G) Vb[i] - gw Vb[i+1] = G Vw[i]``;
    i = 0 has no upper neighbour, i = R-1 is grounded through a wire."""
    gt = g.transpose(-1, -2)  # (..., C, R): batch over the columns
    d = 2.0 * gw + gt
    d[..., 0] -= gw
    dl, du = _off_diagonals(gt, gw)
    b = gt * vw.transpose(-1, -2)
    return _thomas(dl, d, du, b).transpose(-1, -2)


def kcl_residual(g, v_in, gw, vw, vb) -> torch.Tensor:
    """Relative KCL residual over all nodes (the convergence metric):
    the largest current imbalance of a word- or bit-line node over the
    largest cell current ``max |G V_in|``."""
    r, c = g.shape[-2:]
    left = torch.cat([v_in[..., :, None].expand(*vw.shape[:-1], 1), vw[..., :, :-1]], dim=-1)
    right = torch.cat([vw[..., :, 1:], vw[..., :, -1:]], dim=-1)
    n_right = torch.cat([torch.ones((r, c - 1), dtype=g.dtype, device=g.device),
                         torch.zeros((r, 1), dtype=g.dtype, device=g.device)], dim=1)
    res_w = gw * (left - vw) + gw * n_right * (right - vw) - g * (vw - vb)
    up = torch.cat([vb[..., :1, :], vb[..., :-1, :]], dim=-2)
    n_up = torch.cat([torch.zeros((1, c), dtype=g.dtype, device=g.device),
                      torch.ones((r - 1, c), dtype=g.dtype, device=g.device)], dim=0)
    down = torch.cat([vb[..., 1:, :], torch.zeros_like(vb[..., :1, :])], dim=-2)
    res_b = gw * n_up * (up - vb) + gw * (down - vb) + g * (vw - vb)
    scale = torch.clamp_min((g * v_in[..., :, None]).abs().amax(dim=(-2, -1)), 1e-30)
    worst = torch.maximum(res_w.abs().amax(dim=(-2, -1)), res_b.abs().amax(dim=(-2, -1)))
    return worst / scale


def solve_crossbar(
    g: torch.Tensor,
    v_in: torch.Tensor,
    r_wire: float = 2.93,
    iters: int = 20,
    relax: float = 0.6,
) -> CrossbarResult:
    """Cross-iteration fixed-point solve of the crossbar nodal equations.

    g: (..., R, C) device conductances (S); v_in: (..., R) word-line drive
    voltages (V), leading dimensions broadcast; ``r_wire``: wire
    resistance per segment (Ω, the paper's 2.93); ``iters``: sweeps (the
    paper: at most 20 at 1024x1024); ``relax``: each sweep is
    extrapolated, ``x + relax * (x - x_prev)``.  Returns the node
    voltages, the sensed currents ``gw * Vb[R-1, :]`` and the final
    relative KCL residual, float32."""
    v_in = v_in.to(torch.float32)
    g, _ = torch.broadcast_tensors(g.to(torch.float32), v_in[..., :, None])
    v_in = v_in.expand(g.shape[:-1])
    gw = torch.tensor(np.float32(1.0 / r_wire), device=g.device)
    beta = torch.tensor(np.float32(relax), device=g.device)
    vw = v_in[..., :, None].expand(g.shape).clone()
    vb = torch.zeros_like(g)
    for _ in range(iters):
        vw1 = _solve_wordlines(g, v_in, gw, vb)
        vb1 = _solve_bitlines(g, gw, vw1)
        vw, vb = vw1 + beta * (vw1 - vw), vb1 + beta * (vb1 - vb)
    i_out = gw * vb[..., -1, :]
    return CrossbarResult(vw=vw, vb=vb, i_out=i_out, residual=kcl_residual(g, v_in, gw, vw, vb))


def exact_node_voltages(g, v_in, r_wire: float = 2.93):
    """Dense exact nodal solve in float64 (the oracle of the tests; the
    paper validates against LTspice), O((RC)^3): small arrays only.
    ``g`` (R, C), ``v_in`` (R,), tensors or arrays.  Returns (vw, vb,
    i_out) as numpy arrays."""
    g = np.asarray(torch.as_tensor(g).cpu(), dtype=np.float64)
    v_in = np.asarray(torch.as_tensor(v_in).cpu(), dtype=np.float64)
    r, c = g.shape
    gw = 1.0 / r_wire
    n = r * c
    a = np.zeros((2 * n, 2 * n))
    rhs = np.zeros(2 * n)
    for i in range(r):
        for j in range(c):
            w, bi = i * c + j, n + i * c + j
            # word-line node (i, j)
            a[w, w] += g[i, j] + gw
            a[w, bi] -= g[i, j]
            if j == 0:
                rhs[w] += gw * v_in[i]
            else:
                a[w, w - 1] -= gw
            if j < c - 1:
                a[w, w] += gw
                a[w, w + 1] -= gw
            # bit-line node (i, j): the segment below leads to the next
            # node, or at i = R-1 to the ground
            a[bi, bi] += g[i, j] + gw
            a[bi, w] -= g[i, j]
            if i > 0:
                a[bi, bi] += gw
                a[bi, bi - c] -= gw
            if i < r - 1:
                a[bi, bi + c] -= gw
    sol = np.linalg.solve(a, rhs)
    vw = sol[:n].reshape(r, c)
    vb = sol[n:].reshape(r, c)
    return vw, vb, gw * vb[-1, :]
