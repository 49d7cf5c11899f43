"""K5 — flash attention: CUDA kernel and plain version.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``
(``pallas_call`` :129, body ``_kernel`` :34): online-softmax attention of
q (BH, Sq, dh) over k / v (BH, Skv, dh) with the causal mask
``k_pos <= q_pos``, the sliding window ``k_pos > q_pos - window`` and
the padded tail ``k_pos < Skv``; scores, running max, normaliser and
accumulator in float32 (bf16 inputs upcast), masked scores set to the
reference's ``-1e30``, the output ``acc / max(l, 1e-30)`` in q's dtype.
The reference has no caller of this kernel besides its test; the port
reaches it through ``kernels.ops.flash_attention``.

Kernel (``csrc/flash_attention.cu``): one block per (query tile of
``bq`` rows, batch-head), one thread per query row; the block walks the
key tiles of ``bk`` rows its rows may see, K and V tiles in shared
memory; wholly masked key tiles are skipped (their terms are exact zeros
in the reference's sum).  Bound on an H100 at qwen2-0.5b width (14
heads, head_dim 64, S = 1024, causal): 1.9 GFLOP of f32 work (28 µs)
over 14.7 MB (4.4 µs), so operations; this first kernel runs scalar f32
FMAs on the CUDA cores.

Plain version: the straightforward masked float32 softmax
(:func:`flash_attention_ref`), one exact max / exp / sum per row; it
agrees with the online form to float32 rounding.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .build import LaunchCounter, check, library

__all__ = ["flash_attention_ref", "flash_attention_cuda", "counter", "HEAD_DIMS", "TILES"]

_NEG = -1e30
HEAD_DIMS = (32, 64, 128)
TILES = (32, 64, 128)
counter = LaunchCounter("flash_attention")


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """Masked softmax attention in float32, output in q's dtype."""
    sq, dh = q.shape[1], q.shape[2]
    skv = k.shape[1]
    s = (q.float() @ k.float().transpose(1, 2)) * dh**-0.5
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= ki > qi - window
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = (p @ v.float()) / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = library().flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v o
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bh sq skv dh
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bq bk causal window
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,  # scale bf16 stream
    ]
    return fn


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def flash_attention_cuda(q, k, v, *, causal=True, window=0, bq=128, bk=128):
    """Launch K5 on the card: q (BH, Sq, dh), k / v (BH, Skv, dh), all
    float32 or all bfloat16, contiguous -> (BH, Sq, dh) in q's dtype.
    Raises on anything the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _need(t.is_cuda, f"{name} must be a CUDA tensor")
        _need(t.dtype == q.dtype, f"{name} is {t.dtype}, q is {q.dtype}")
        _need(t.is_contiguous(), f"{name} must be contiguous")
        _need(t.device == q.device, f"{name} is on another device")
        _need(t.dim() == 3, f"{name} must be (BH, S, dh)")
    _need(q.dtype in (torch.float32, torch.bfloat16), f"dtype {q.dtype} is not f32 or bf16")
    bh, sq, dh = q.shape
    _need(k.shape == v.shape and k.shape[0] == bh and k.shape[2] == dh,
          f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    _need(dh in HEAD_DIMS, f"head_dim {dh} is not one of {HEAD_DIMS}")
    _need(bq in TILES and bk in TILES, f"bq={bq} / bk={bk} not in {TILES}")
    skv = k.shape[1]
    out = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq, skv, dh,
            bq, bk, int(causal), int(window), float(np.float32(dh**-0.5)),
            int(q.dtype == torch.bfloat16), stream,
        )
    check(rc, "flash_attention")
    counter.count += 1
    return out
