#!/usr/bin/env python3
"""What K2 / K3 spend recomputing scores past their shared-memory budget,
at qwen2-0.5b's heads.

    python3 tools/paged_recompute.py

Where a block's scores do not fit shared memory, K2 / K3 compute them
three times (the max, the sum, the weights).  A workspace in device
memory would compute them once and copy them back twice.  This tool
copies ``src/repro_torch`` and ``chip_smoke.py`` into
``build/paged_recompute/`` (gitignored) and changes the copy's
``csrc/paged_attention.cu`` so that the passes after the max compute no
scores (they reuse what the buffer holds, so the copy's results are
wrong): its time is what the recomputing kernel would take if the scores
came for free, a lower bound on a workspace variant, which would also
write them once and copy them back twice.  Both are timed in turns
(repository, copy, repository, copy), each in its own process, with
``chip_smoke.Timer`` (CUDA events, L2 flushed, median of 10): K3 for a
32-row chunk at start 6,000 and 32,736, K2 for 4 slots at pos 6,143 and
32,767, float32, a 2,048-block table.  The repository's kernel is not
touched.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
COPY = os.path.join(ROOT, "build", "paged_recompute")
SCORE_LOOP = "      for (int c = tid; c < pairs * nk; c += THREADS) {\n"
NO_RECOMPUTE = ("      for (int c = tid; c < ((KEEP || kind == K_MAX) ? pairs * nk : 0);"
                " c += THREADS) {\n")


def make_copy() -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(COPY, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), COPY)
    cu = os.path.join(COPY, "src", "repro_torch", "csrc", "paged_attention.cu")
    src = open(cu).read()
    if src.count(SCORE_LOOP) != 1:
        raise RuntimeError("the score loop of csrc/paged_attention.cu was not found once")
    with open(cu, "w") as fh:
        fh.write(src.replace(SCORE_LOOP, NO_RECOMPUTE))


def time_one(root: str, label: str) -> None:
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    import chip_smoke
    import repro_torch.core  # noqa: F401  (import order of the package)
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa

    build.library()
    h, kv, hd, bs, c, nb = 14, 2, 64, 16, 32, 2048
    g = torch.Generator(device="cuda").manual_seed(3)
    pk = torch.randn((nb + 1, bs, kv, hd), generator=g, device="cuda")
    pv = torch.randn((nb + 1, bs, kv, hd), generator=g, device="cuda")
    bt = (torch.randperm(nb, generator=g, device="cuda") + 1).to(torch.int32)
    q = torch.randn((1, c, h, hd), generator=g, device="cuda")
    qd = torch.randn((4, h, hd), generator=g, device="cuda")
    btd = torch.stack([bt] * 4).contiguous()
    timer = chip_smoke.Timer()
    out = []
    for start in (6000, 32736):
        t = timer(lambda: pa.paged_chunk_attention_cuda(q, pk, pv, bt, start, c), iters=10)
        out.append(f"K3 start {start}: {t:.4f} ms")
    for p in (6143, 32767):
        pos = torch.full((4,), p, dtype=torch.int32, device="cuda")
        t = timer(lambda: pa.paged_decode_attention_cuda(qd, pk, pv, btd, pos), iters=10)
        out.append(f"K2 B=4 pos {p}: {t:.4f} ms")
    print(f"{label}: " + "; ".join(out) + f"  [{chip_smoke.card_line()}]", flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--time":
        time_one(sys.argv[2], sys.argv[3])
        return 0
    make_copy()
    for root, label in ((ROOT, "recomputed"), (COPY, "scores free"),
                        (ROOT, "recomputed"), (COPY, "scores free")):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--time", root, label],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
