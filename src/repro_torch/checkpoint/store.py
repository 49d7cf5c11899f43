"""Fault-tolerant checkpointing: async, atomic, keep-last-k (port of
``repro/checkpoint/store.py``), in the reference's on-disk format, so a
checkpoint written by either package restores in the other:
``<dir>/step_<N>/process_0.npz`` holds ``leaf_<i>`` per leaf, and
``meta.json`` the step, the leaves' paths (JAX's ``"a/b/c"`` strings:
dict keys sorted at every level), shapes and dtypes.

* **Async** — the leaves are copied to host memory before the writer
  thread starts (a copy, also of CPU tensors, whose ``numpy()`` would
  share memory with a tensor the optimiser then updates in place), and
  the thread serialises the copy.
* **Atomic** — writes go to ``step_N.tmp<thread>`` and are published
  with one ``os.rename``.
* **Keep-last-k** — older checkpoints are removed after publishing.

bfloat16 leaves are written as the reference writes them (numpy keeps
their two bytes as ``|V2``) and read back by their bytes.
``restore_checkpoint`` places the leaves on ``device`` (the reference's
``shardings=`` needs a mesh, ROADMAP item A7).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "wait_for_saves"]

_PENDING: list[threading.Thread] = []


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (bfloat16 as its raw two bytes, ``|V2``)."""
    bf16 = t.dtype == torch.bfloat16
    t = t.detach().view(torch.int16) if bf16 else t.detach()
    a = t.cpu().numpy()
    if t.device.type == "cpu":
        a = a.copy()  # numpy() shares a CPU tensor's memory; cpu() of a card's is a copy
    return a.view("V2") if bf16 else a


def wait_for_saves():
    """Block until all async checkpoint writes have published."""
    for t in list(_PENDING):
        t.join()
        _PENDING.remove(t)


def save_checkpoint(ckpt_dir, step: int, state, *, async_save: bool = True, keep: int = 3):
    """Snapshot ``state`` (nested dicts of tensors) and persist it as
    ``<dir>/step_<N>/``."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    pairs = tree_leaves(state, paths=True)
    paths, leaves = [p for p, _ in pairs], [t for _, t in pairs]
    host = [_to_host(t) for t in leaves]  # the only synchronous part
    meta = {
        "step": int(step),
        "paths": paths,
        "shapes": [list(a.shape) for a in host],
        "dtypes": ["bfloat16" if t.dtype == torch.bfloat16 else str(a.dtype)
                   for t, a in zip(leaves, host)],
        "process_count": 1,
    }

    def _write():
        tmp = ckpt_dir / f"step_{step}.tmp{threading.get_ident()}"
        final = ckpt_dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / "process_0.npz", **{f"leaf_{i}": a for i, a in enumerate(host)})
        (tmp / "meta.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        steps = sorted(
            int(p.name.split("_")[1])
            for p in ckpt_dir.glob("step_*")
            if ".tmp" not in p.name
        )
        for s in steps[:-keep]:
            shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        _PENDING.append(t)
    else:
        _write()


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*") if ".tmp" not in p.name]
    return max(steps) if steps else None


def _from_host(a: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        raw = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(dtype=like.dtype, device=device)


def restore_checkpoint(ckpt_dir, state_template, *, step: int | None = None, device=None):
    """Restore into the template's structure and dtypes, on ``device``
    (default: each template leaf's device).  Returns ``(state, step)``."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    meta = json.loads((d / "meta.json").read_text())
    data = np.load(d / "process_0.npz")
    pairs = tree_leaves(state_template, paths=True)
    paths, leaves = [p for p, _ in pairs], [t for _, t in pairs]
    if paths != meta["paths"]:
        raise ValueError(f"checkpoint tree mismatch: {set(paths) ^ set(meta['paths'])}")
    out = [
        _from_host(data[f"leaf_{i}"], t, t.device if device is None else device)
        for i, t in enumerate(leaves)
    ]
    return tree_unflatten(state_template, out), step
