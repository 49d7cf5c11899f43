"""Temperature / top-k / top-p sampling with per-request seeds (port of
``repro/serve/sampling.py``).

* **Keys depend only on (seed, emission index)**: token ``i`` of a
  request draws with ``fold_in(PRNGKey(seed), i)`` whatever slot or
  packing it lands in, so sampled tokens keep the batched == solo
  contract of greedy ones.
* **Sampling is row-local**: every step is a sort, a scan or an
  elementwise op along the vocab axis of one row.
* **temperature == 0 is exactly greedy**: the row's ``argmax``, the key
  unused.

The filters are the reference's: top-k keeps every logit at or above the
k-th largest (ties survive), the temperature divides, top-p keeps the
smallest prefix of the sorted softmax whose mass before it is below
``top_p``, then ``categorical`` draws.  The softmax's ``exp``, its sum
and the top-p ``cumsum`` replay XLA's CPU arithmetic and summation order
(:mod:`repro_torch.core.xmath`), so a cutoff at a boundary falls where
the reference's falls; the draw is :func:`repro_torch.core.prng.categorical`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import xmath
from repro_torch.core.prng import PRNGKey, fold_in, gumbel

__all__ = ["SamplingParams", "GREEDY", "request_keys", "sample_row", "sample_rows"]


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (fields as in the reference):
    ``temperature`` (0.0 = greedy), ``top_k`` (0 = off; ties at the k-th
    value survive), ``top_p`` (1.0 = off) and ``seed`` (token ``i``
    draws with ``fold_in(PRNGKey(seed), i)``)."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0 (got {self.temperature}); 0 collapses to greedy"
            )
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (got {self.top_k}); 0 disables the filter")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1] (got {self.top_p}); 1.0 disables the filter"
            )


#: the greedy degenerate case: argmax, key ignored
GREEDY = SamplingParams(temperature=0.0)


def request_keys(seed: int, n: int) -> np.ndarray:
    """Keys of a request's first ``n`` emissions, ``(n, 2)`` uint32: row
    ``i`` is ``fold_in(PRNGKey(seed), i)``."""
    base = PRNGKey(seed)
    return np.stack([fold_in(base, i) for i in range(n)]).reshape(n, 2).astype(np.uint32)


def sample_rows(keys, logits: torch.Tensor, temps, top_ks, top_ps) -> torch.Tensor:
    """Sample one token from each row of ``logits`` (B, V): ``keys``
    (B, 2) uint32, the knobs (B,) each (host arrays).  Returns (B,)
    int64 on the logits' device."""
    logits = logits.float()
    b, v = logits.shape
    dev = logits.device
    temps = np.asarray(temps, np.float32).reshape(b)
    top_ks = np.asarray(top_ks, np.int64).reshape(b)
    greedy = torch.argmax(logits, dim=-1)
    hot = np.flatnonzero(temps > 0)
    if hot.size == 0:
        return greedy
    rows = torch.from_numpy(hot).to(dev)
    lg = logits[rows]
    desc = torch.sort(lg, dim=-1, descending=True).values
    k_eff = np.where(top_ks[hot] > 0, np.clip(top_ks[hot], 1, v), v)
    kth = desc.gather(1, torch.from_numpy(k_eff - 1).to(dev)[:, None])
    masked = torch.where(lg >= kth, lg, torch.full_like(lg, -torch.inf))
    scaled = masked / torch.from_numpy(temps[hot]).to(dev)[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    unnorm = xmath.exp(srt - srt[:, :1])
    probs = unnorm / xmath.sum_last(unnorm)[:, None]
    csum = xmath.cumsum_last(probs)
    tp = torch.from_numpy(np.asarray(top_ps, np.float32).reshape(b)[hot]).to(dev)
    keep = (csum - probs) < tp[:, None]
    cutoff = torch.where(keep, srt, torch.full_like(srt, torch.inf)).amin(dim=-1, keepdim=True)
    scaled = torch.where(scaled >= cutoff, scaled, torch.full_like(scaled, -torch.inf))
    keys = np.asarray(keys, np.uint32).reshape(b, 2)
    noise = torch.stack([gumbel(keys[r], (v,), device=dev) for r in hot])
    out = greedy.clone()
    out[rows] = torch.argmax(noise + scaled, dim=-1)
    return out


def sample_row(key, logits: torch.Tensor, temperature, top_k, top_p) -> int:
    """Sample ONE token from one ``(V,)`` logit row (the first token of a
    request, from its prefill logits)."""
    tok = sample_rows(np.asarray(key, np.uint32)[None], logits[None], [temperature],
                      [top_k], [top_p])
    return int(tok[0])
