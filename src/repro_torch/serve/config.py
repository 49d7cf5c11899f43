"""The serving configuration surface (port of ``repro/serve/config.py``).

``ServeLoop(params, cfg, ServeConfig(...))`` is the surface.  Beyond the
reference's knobs the port has ``device`` (where the arena lives and
programming runs; ``"cuda"`` unless the caller asks for the CPU) and
``kernels`` (``False`` is the explicit plain-version override).  The
mesh is not ported: ``mesh`` raises ``NotImplementedError`` when set.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.layers import MemPolicy

__all__ = ["ServeConfig"]


@dataclass(frozen=True)
class ServeConfig:
    """Every knob of one :class:`~repro_torch.serve.batching.ServeLoop`
    (field meanings as in the reference's ``ServeConfig``):

      slots, max_len, prefill_chunk (None = one bucket-padded chunk),
      block_size, kv_blocks (None = slots full lanes + the trash block),
      buckets, prefix_cache — scheduling and memory;
      interactive_weight, max_queue_skip — priority-class admission;
      policy, compute_dtype, weight_stationary, allow_coupled_numerics —
      numerics; collect_logits, collect_trace — observability;
      device — where the arena lives and programming runs;
      kernels — False runs the kernels' plain versions even on the card;
      refresh_every, clock — device-clock seconds between re-programs
      (None = never) and the zero-argument device clock that ages drift
      and drives the refresh (None = wall time since ``run()`` started);
      spec_k, draft_policy — draft tokens a slot proposes each round (0 =
      plain decoding) and the draft engine's policy (None = digital).
    """

    policy: MemPolicy | None = None
    slots: int = 4
    max_len: int = 256
    prefill_chunk: int | None = None
    block_size: int = 16
    kv_blocks: int | None = None
    buckets: tuple[int, ...] | None = None
    compute_dtype: Any = torch.bfloat16
    weight_stationary: bool = True
    collect_logits: bool = False
    collect_trace: bool = False
    allow_coupled_numerics: bool = False
    prefix_cache: bool = True
    interactive_weight: int = 4
    max_queue_skip: int = 8
    device: str = "cuda"
    kernels: bool = True
    mesh: Any = None
    refresh_every: float | None = None
    clock: Callable[[], float] | None = None
    spec_k: int = 0
    draft_policy: MemPolicy | None = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError("ServeConfig.mesh is not ported to repro_torch yet")
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        if self.max_len < 1:
            raise ValueError("max_len must be >= 1")
        if self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1 (got {self.block_size}): the "
                "paged KV arena stores at least one token row per block"
            )
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 or None (got {self.prefill_chunk})"
            )
        if self.kv_blocks is not None and self.kv_blocks < 2:
            raise ValueError(
                f"kv_blocks must be >= 2 (got {self.kv_blocks}): physical "
                "block 0 is the reserved trash block"
            )
        if self.interactive_weight < 1:
            raise ValueError(
                f"interactive_weight must be >= 1 (got {self.interactive_weight})"
            )
        if self.max_queue_skip < 0:
            raise ValueError(
                f"max_queue_skip must be >= 0 (got {self.max_queue_skip}); "
                "0 = strict submit-order FIFO admission"
            )
        if self.refresh_every is not None and self.refresh_every <= 0:
            raise ValueError("refresh_every must be > 0 seconds (or None)")
        if self.spec_k < 0:
            raise ValueError(
                f"spec_k must be >= 0 (got {self.spec_k}); 0 disables speculative decoding"
            )
        if self.spec_k >= self.max_len:
            raise ValueError(
                f"spec_k ({self.spec_k}) must be < max_len ({self.max_len}): a verify "
                "chunk cannot exceed the per-slot KV budget"
            )
        if self.draft_policy is not None and self.spec_k == 0:
            raise ValueError(
                "draft_policy without spec_k > 0 does nothing: set spec_k to enable "
                "speculative decoding"
            )
        if self.buckets is not None:
            buckets = tuple(self.buckets)
            if not buckets:
                raise ValueError("buckets must be non-empty (or None)")
            if any(not isinstance(b, int) or isinstance(b, bool) or b < 1 for b in buckets):
                raise ValueError(f"buckets must be positive ints (got {buckets!r})")
            if any(a >= b for a, b in zip(buckets, buckets[1:])):
                raise ValueError(f"buckets must be strictly increasing (got {buckets})")
            if buckets[-1] > self.max_len:
                raise ValueError(
                    f"largest bucket ({buckets[-1]}) exceeds max_len ({self.max_len})"
                )
            object.__setattr__(self, "buckets", buckets)

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)
