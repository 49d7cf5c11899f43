#!/usr/bin/env python3
"""Count K6's machine instructions per cell, by pipe, from the built
kernel library, and the least time they take at the card's issue rate.

    python3 tools/k6_sass.py [CELLS]

``cuobjdump -sass`` of the library that ``repro_torch.kernels.build``
builds (``csrc/program_noise.cu``) gives ``program_noise_kernel``'s SASS.
One iteration of its grid-stride loop programs one cell, so the loop
body -- from the target of the backward branch to that branch -- is the
cell's work.  A warp runs both sides of a branch whenever its 32 cells
disagree, which for log1p's branch (|u| >= 0.644: 36 % of cells) is
every warp, so every instruction of the body counts; the division's and
square root's out-of-line slow paths (operands that are not normal
floats) lie outside the body and are not counted.

The instructions are split by pipe (sm_90):

* FP32: FFMA, FADD, FMUL (128 a cycle per SM);
* integer: the ALU's integer, logical, shift, select and compare
  instructions, IMAD included (64 a cycle per SM, half the FP32 rate);
* the rest: moves, conversions, MUFU, memory, branches.

An SM issues at most 4 warp-instructions a cycle (one per scheduler),
128 thread-instructions, so the compiled loop takes at least
max(total / 128, integer / 64) SM cycles a cell; over 132 SMs at the SM
clock that ``nvidia-smi`` reports (``clocks.max.sm``) this gives
:func:`bound_ms`.  It counts both sides of every branch, the control
flow and the loop and address arithmetic, so it measures the compiled
code, overhead included, not the work: ``chip_smoke.py`` takes K6's
bound from the operations a cell needs (``K6_CELL``) and prints this
count beside it.  Needs ``cuobjdump`` (the CUDA toolkit, beside
``nvcc``).
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from collections import Counter

FP32 = {"FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I"}
INTEGER = {"IADD3", "IADD", "VIADD", "IMAD", "IMAD32I", "IMNMX", "VIMNMX", "IABS", "ISETP",
           "LOP3", "LOP32I", "SHF", "SHL", "SHR", "LEA", "PRMT", "SEL", "FSEL", "FSETP",
           "FMNMX", "PLOP3", "P2R", "R2P", "FLO", "POPC", "BREV"}
SMS = 132
ISSUE_PER_SM = 4 * 32  # thread-instructions a cycle: four schedulers, a warp each
INT_PER_SM = 64  # the integer pipe's rate, half of FP32's

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?\s*([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)\s*$")


def _cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("cuobjdump"), os.path.join(home, "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def kernel_sass(lib: str, name: str = "program_noise_kernel") -> str:
    """The SASS text of the one function whose mangled name holds ``name``."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], check=True, capture_output=True,
                         text=True).stdout
    parts = re.split(r"\n\s*(?=Function : )", out)
    hits = [p for p in parts if p.startswith("Function : ") and name in p.splitlines()[0]]
    if len(hits) != 1:
        raise RuntimeError(f"{len(hits)} functions named like {name} in {lib}")
    return hits[0]


def loop_body(sass: str):
    """Opcodes of the grid-stride loop's body, from the backward branch's
    target to the branch, without the division's and square root's slow
    paths: each is the block a forward conditional branch skips that
    holds a ``CALL`` (the innermost such block around each call)."""
    insns = []  # (address, opcode, predicated, branch target or None)
    for line in sass.splitlines():
        m = _INSN.search(line)
        if m:
            t = _TARGET.search(m.group(5)) if m.group(3) in ("BRA", "CALL") else None
            insns.append((int(m.group(1), 16), m.group(3), bool(m.group(2)),
                          int(t.group(1), 16) if t else None))
    # the loop: the one branch back (the trap after EXIT branches to itself)
    back = [(t, a) for a, op, _, t in insns if op == "BRA" and t is not None and t < a]
    if len(back) != 1:
        raise RuntimeError(f"expected one backward branch (the grid-stride loop), found {back}")
    lo, hi = back[0]
    body = [x for x in insns if lo <= x[0] <= hi]
    skips = [(a, t) for a, op, pred, t in body if op == "BRA" and pred and t is not None and t > a]
    slow = set()
    for a, op, _, _ in body:
        if op == "CALL":
            inner = min((r for r in skips if r[0] < a < r[1]), key=lambda r: r[1] - r[0])
            slow.add(inner)
    keep = [op for a, op, _, _ in body if not any(s < a < t for s, t in slow)]
    return keep, len(body) - len(keep)


def count(body) -> dict:
    ops = Counter(body)
    fp = sum(n for op, n in ops.items() if op in FP32)
    it = sum(n for op, n in ops.items() if op in INTEGER)
    total = sum(ops.values())
    return dict(total=total, fp32=fp, integer=it, rest=total - fp - it, by_opcode=dict(ops))


def sm_cycles_per_cell(c: dict) -> float:
    return max(c["total"] / ISSUE_PER_SM, c["integer"] / INT_PER_SM)


def bound_ms(c: dict, cells: int, clock_mhz: float) -> float:
    return cells * sm_cycles_per_cell(c) / (SMS * clock_mhz * 1e6) * 1e3


def max_sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True).stdout
    return float(out.split()[0])


def k6_count(lib: str | None = None) -> dict:
    if lib is None:
        from repro_torch.kernels import build
        lib = str(build.build())
    body, slow = loop_body(kernel_sass(lib))
    return dict(count(body), slow_paths=slow)


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch.core  # noqa: F401  (import order of the package)

    c = k6_count()
    cells = int(sys.argv[1]) if len(sys.argv) > 1 else 896 * 152064  # the vocab head's plane
    clk = max_sm_clock_mhz()
    print(f"program_noise_kernel, one loop iteration = one cell: {c['total']} instructions "
          f"({c['slow_paths']} more in the slow paths, not counted): FP32 pipe {c['fp32']}, "
          f"integer pipe {c['integer']}, rest {c['rest']}")
    print("by opcode:", ", ".join(f"{k} {v}" for k, v in sorted(c["by_opcode"].items(),
                                                                 key=lambda kv: -kv[1])))
    print(f"issue bound {c['total'] / ISSUE_PER_SM:.3f}, integer bound "
          f"{c['integer'] / INT_PER_SM:.3f} SM cycles a cell; {cells} cells at {clk:.0f} MHz on "
          f"{SMS} SMs: {bound_ms(c, cells, clk):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
