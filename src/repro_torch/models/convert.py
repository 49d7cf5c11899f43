"""Turn nested dicts of numpy arrays into the port's params and
programmed state.

This is how the parity tests hand the reference's weights and
programmed crossbar state to the port: the test side flattens JAX
arrays to numpy, and the port never sees JAX.  Programmed nodes are
recognised by their fields: a named tuple with ``slices``/``scale``
becomes :class:`~repro_torch.core.dpe.PreparedWeight`, one with
``w_eff`` a :class:`~repro_torch.core.dpe.FoldedWeight`.  bfloat16 arrays
(numpy's ``ml_dtypes`` extension type) keep their bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dpe import FoldedWeight, PreparedWeight

__all__ = ["to_tensor", "params_from_numpy", "programmed_from_numpy"]


def to_tensor(a, device="cuda") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device="cuda"):
    """Nested dicts of arrays -> nested dicts of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return to_tensor(tree, device)


def programmed_from_numpy(tree, device="cuda"):
    """A programmed tree (named-tuple nodes with array leaves) -> the
    port's ``PreparedWeight`` / ``FoldedWeight`` tree on ``device``.  A
    timestamp (one per stacked layer in the reference, all equal) becomes
    the node's float ``t_prog``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: programmed_from_numpy(v, device) for k, v in tree.items()}
    fields = getattr(tree, "_fields", ())
    t_prog = getattr(tree, "t_prog", None)
    if t_prog is not None:
        stamps = np.unique(np.asarray(t_prog, np.float32))
        if stamps.size != 1:
            raise ValueError(f"programmed layers carry different timestamps {stamps}")
        t_prog = float(stamps[0])
    if "slices" in fields:
        return PreparedWeight(to_tensor(tree.slices, device), to_tensor(tree.scale, device),
                              t_prog)
    if "w_eff" in fields:
        return FoldedWeight(to_tensor(tree.w_eff, device), t_prog)
    raise TypeError(f"not a programmed node: {type(tree).__name__}")
