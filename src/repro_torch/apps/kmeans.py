"""Fig. 15: K-means clustering with the Euclidean distance computed on
the crossbar via the dot-product expansion of [21] (port of
``repro/apps/kmeans.py``):

    (x - y)^2 ≈ -2 x·y_i + y_i^2
    dist_i = [x, -1/2, ..., -1/2] · [y_i, y_i^2/n, ..., y_i^2/n]

with n = 10 tail elements (paper's setting).  Data precision INT8 with
slice method (1,1,2,4); one centre updated per iteration (paper).  IRIS
is replaced by the reference's statistically matched synthetic
3-cluster, 4-feature, 150-sample set.

The default ``DPEConfig`` (backend ``xla``, as in the reference) ranges
the ``dynamic`` ADC over all 150 rows of a call, as the reference's
vectorized engine does; on the card the 150 rows go through K1 as one
row tile.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.apps import cli_device
from repro_torch.core import DPEConfig, dpe_matmul, spec
from repro_torch.core.prng import PRNGKey, choice
from repro_torch.core.quant import div

N_TAIL = 10


def iris_like(seed: int = 0, device="cuda"):
    rng = np.random.default_rng(seed)
    means = np.array(
        [
            [5.0, 3.4, 1.5, 0.2],   # well-separated cluster
            [5.9, 2.8, 4.3, 1.3],   # overlapping pair
            [6.6, 3.0, 5.6, 2.0],
        ]
    )
    stds = np.array(
        [
            [0.35, 0.38, 0.17, 0.10],
            [0.52, 0.31, 0.47, 0.20],
            [0.64, 0.32, 0.55, 0.27],
        ]
    )
    xs, ys = [], []
    for k in range(3):
        xs.append(means[k] + stds[k] * rng.standard_normal((50, 4)))
        ys.append(np.full(50, k))
    x = np.concatenate(xs).astype(np.float32)
    return torch.from_numpy(x).to(device), np.concatenate(ys)


def _expand_x(x):
    tail = torch.full((x.shape[0], N_TAIL), -0.5, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail], dim=1)


def _expand_c(c):
    sq = div((c * c).sum(dim=1, keepdim=True), N_TAIL)
    return torch.cat([c, sq.repeat(1, N_TAIL)], dim=1)


def kmeans(x, k, matmul, iters: int = 30, seed: int = 0):
    idx = choice(PRNGKey(seed), x.shape[0], (k,), device=x.device)
    centers = x[idx]
    xe = _expand_x(x)
    for it in range(iters):
        # negative half-distance scores: larger == closer
        scores = matmul(xe, _expand_c(centers).T)
        assign = torch.argmax(scores, dim=1)
        # paper: one centre updated per iteration
        j = it % k
        mask = (assign == j)[:, None].to(x.dtype)
        denom = torch.clamp_min(mask.sum(), 1.0)
        centers = centers.clone()
        centers[j] = (x * mask).sum(0) / denom
    scores = matmul(xe, _expand_c(centers).T)
    return centers, torch.argmax(scores, dim=1)


def _agree(a, b, k=3):
    """Cluster agreement up to label permutation."""
    best = 0.0
    a = np.asarray(a)
    b = np.asarray(b)
    for perm in itertools.permutations(range(k)):
        m = np.array([perm[v] for v in a])
        best = max(best, float((m == b).mean()))
    return best


def run(var: float = 0.05, iters: int = 30, device: str = "cuda", kernels: bool = True):
    x, labels = iris_like(device=device)
    # standardise features: centred data puts the inter-cluster score
    # gaps well above the per-block quantisation floor
    x = (x - x.mean(0)) / x.std(0, correction=0)
    sp = spec("int8")  # (1,1,2,4) per the paper
    cfg = DPEConfig(
        input_spec=sp, weight_spec=sp, var=var,
        noise_mode="program" if var > 0 else "off",
    )
    key = PRNGKey(11)

    def hw(a, b):
        return dpe_matmul(a, b, cfg, key, kernels)

    _, hw_assign = kmeans(x, 3, hw, iters)
    _, sw_assign = kmeans(x, 3, lambda a, b: a @ b, iters)
    hw_assign, sw_assign = hw_assign.cpu().numpy(), sw_assign.cpu().numpy()
    return {
        "hw_vs_sw_agreement": _agree(hw_assign, sw_assign),
        "hw_vs_truth": _agree(hw_assign, labels),
        "sw_vs_truth": _agree(sw_assign, labels),
        "hw_assign": hw_assign,
        "sw_assign": sw_assign,
    }


if __name__ == "__main__":
    out = run(device=cli_device())
    for k in ("hw_vs_sw_agreement", "hw_vs_truth", "sw_vs_truth"):
        print(f"{k}: {out[k]:.3f}")
