"""Gradient compression: int8 quantisation with error feedback (port of
``repro/distributed/compression.py::GradCompression``).

``GradCompression`` models the numerics of a compressed data-parallel
all-reduce inside ``make_train_step``: each gradient leaf is quantised
to int8 per block of ``block`` values (absmax scale) and dequantised,
and the quantisation residual is kept in a bfloat16 error-feedback
buffer that is added back the next step (EF-SGD).  The arithmetic is
the reference's as XLA compiles it: the division of the absmax by 127
is a product with the float32 reciprocal ``1/127``, then ``round``
(half to even) of the block over its scale, clipped to [-127, 127]; the
residual ``corrected - q * scale`` is one fused multiply-add.

``compressed_psum`` (the collective itself) needs a mesh and is ROADMAP
item A7.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.xmath import fma
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten

__all__ = ["GradCompression"]

_INV127 = np.float32(np.float32(1.0) / np.float32(127.0))


def _blocks(g: torch.Tensor, block: int):
    """``g`` flattened, zero-padded to whole blocks of ``block`` (float32)
    -> (int8 codes as float32, per-block scales), both (n_blocks, ...)."""
    flat = g.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block).to(torch.float32)
    scale = blocks.abs().amax(dim=1, keepdim=True) * torch.tensor(_INV127, device=g.device)
    scale = torch.clamp_min(scale, np.float32(1e-30))
    return blocks, torch.clamp(torch.round(blocks / scale), -127.0, 127.0), scale


def _unblock(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return b.reshape(-1)[: like.numel()].reshape(like.shape)


def _quant_dequant(g: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Per-block int8 quantise-dequantise of ``g`` (any shape), in its
    dtype."""
    _, q, scale = _blocks(g, block)
    return _unblock(q * scale, g).to(g.dtype)


@dataclass(frozen=True)
class GradCompression:
    block: int = 256

    def init(self, params):
        """Zero bfloat16 error-feedback buffers shaped like ``params``."""
        return tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device), params)

    def apply(self, grads, state):
        """Returns (dequantised grads, the train state with its ``ef``
        buffers updated); ``state`` holds ``ef`` from :meth:`init`."""

        def one(g, e):
            corrected = g.to(torch.float32) + e.to(torch.float32)
            blocks, q, scale = _blocks(corrected, self.block)
            # corrected - q * scale, the product fused into the subtraction
            new_e = _unblock(fma(q, -scale, blocks), corrected).to(e.dtype)
            return _unblock(q * scale, corrected).to(g.dtype), new_e

        out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(state["ef"]))]
        new_state = dict(state)
        new_state["ef"] = tree_unflatten(state["ef"], [o[1] for o in out])
        return tree_unflatten(grads, [o[0] for o in out]), new_state
