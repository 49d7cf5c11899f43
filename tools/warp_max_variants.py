#!/usr/bin/env python3
"""Tell apart the code and the compiler in the warp-per-head running-max
fault of K2 / K3's recompute path.

    python3 tools/warp_max_variants.py

K2 / K3 take the running max of each head over a tile of scores, on the
path that recomputes the scores past the shared-memory budget, with a
thread per head.  A warp per head — lanes strided over the tile's keys
under ``#pragma unroll 4``, then ``warp_max`` — gave other heads' maxima
on the card.  This tool copies ``src/repro_torch`` three times into
``build/warp_max/`` (gitignored), puts a warp-per-head max into each
copy's ``csrc/paged_attention.cu``:

* ``warp``: the failing form, ``for (t = lane; t < nk; t += 32)`` under
  ``#pragma unroll 4``;
* ``no_unroll``: the same loop without the pragma;
* ``hoisted``: the same loop with its bound copied into a register the
  compiler cannot see through (an ``asm volatile`` move),

builds each (one process each, in parallel), and holds K2 at pos 6,143
and 32,767 and K3 at starts 6,000 and 32,736 (the recompute path, qwen2-
0.5b's heads, float32 and bf16, window 0 and 24, a 2,048-block table)
against the plain versions bit for bit.  The SASS of each build's K2
kernels goes to ``chiprun_out/warp_max/<variant>.sass``.  The
repository's kernels are not touched.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
COPIES = os.path.join(ROOT, "build", "warp_max")
OUT = os.path.join(ROOT, "chiprun_out", "warp_max")

THREAD_MAX = """          for (int h = tid; h < G; h += THREADS) {
            const float* row = sc + h * sld + klo - wb;
            float m = mx[h];
#pragma unroll 8
            for (int t = 0; t < nk; ++t) m = fmaxf(m, row[t]);
            mx[h] = m;
          }
"""
WARP_MAX = """          const int warp = tid >> 5, lane = tid & 31;
          for (int h = warp; h < G; h += WARPS) {
            const float* row = sc + h * sld + klo - wb;
            float m = -INFINITY;
            BOUND
            PRAGMA
            for (int t = lane; t < n; t += 32) m = fmaxf(m, row[t]);
            m = warp_max(m);
            if (lane == 0) mx[h] = fmaxf(mx[h], m);
          }
"""
VARIANTS = {
    "warp": ("const int n = nk;", "#pragma unroll 4"),
    "no_unroll": ("const int n = nk;", ""),
    "hoisted": ('int n; asm volatile("mov.b32 %0, %1;" : "=r"(n) : "r"(nk));',
                "#pragma unroll 4"),
}


def make_copy(name: str) -> str:
    dst = os.path.join(COPIES, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"), os.path.join(dst, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(dst, "src", "repro_torch", "csrc", "paged_attention.cu")
    src = open(cu).read()
    if src.count(THREAD_MAX) != 1:
        raise RuntimeError("the thread-per-head max of csrc/paged_attention.cu was not found once")
    bound, pragma = VARIANTS[name]
    with open(cu, "w") as fh:
        fh.write(src.replace(THREAD_MAX, WARP_MAX.replace("BOUND", bound).replace("PRAGMA", pragma)))
    return dst


def check(root: str, name: str) -> None:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    import repro_torch.core  # noqa: F401  (import order of the package)
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa

    lib = build.library()
    h, kv, hd, bs, nb = 14, 2, 64, 16, 2048
    bad, n = [], 0
    for dtype in (torch.float32, torch.bfloat16):
        for window in (0, 24):
            g = torch.Generator(device="cuda").manual_seed(11 + window)
            pk = torch.randn((nb + 1, bs, kv, hd), generator=g, device="cuda").to(dtype)
            pv = torch.randn((nb + 1, bs, kv, hd), generator=g, device="cuda").to(dtype)
            bt = (torch.randperm(nb, generator=g, device="cuda") + 1).to(torch.int32)
            btd = torch.stack([bt] * 4).contiguous()
            q = torch.randn((4, h, hd), generator=g, device="cuda").to(dtype)
            qc = torch.randn((1, 32, h, hd), generator=g, device="cuda").to(dtype)
            for p in (6143, 32767):
                pos = torch.full((4,), p, dtype=torch.int32, device="cuda")
                y = pa.paged_decode_attention_cuda(q, pk, pv, btd, pos, window=window)
                yp = pa.paged_decode_attention_ref(q, pk, pv, btd, pos, window=window)
                n += 1
                if not torch.equal(y, yp):
                    bad.append(f"K2 pos {p} {dtype} window {window}")
            for start in (6000, 32736):
                y = pa.paged_chunk_attention_cuda(qc, pk, pv, bt, start, 32, window=window)
                yp = pa.paged_chunk_attention_ref(qc, pk, pv, bt, start, 32, window=window)
                n += 1
                if not torch.equal(y, yp):
                    bad.append(f"K3 start {start} {dtype} window {window}")
    print(f"{name}: {n - len(bad)} of {n} recompute-path calls bit-equal to the plain "
          f"versions; differing: {bad or 'none'}", flush=True)
    sass = subprocess.run(["cuobjdump", "-sass", lib._name], capture_output=True, text=True).stdout
    keep, out = False, []
    for line in sass.splitlines():
        if line.strip().startswith("Function :"):
            keep = "paged_decode" in line
        if keep:
            out.append(line)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"{name}.sass"), "w") as fh:
        fh.write("\n".join(out))


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--check":
        check(sys.argv[2], sys.argv[3])
        return 0
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--check",
                               make_copy(name), name]) for name in VARIANTS]
    return max(p.wait() for p in procs)


if __name__ == "__main__":
    sys.exit(main())
