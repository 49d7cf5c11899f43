#!/usr/bin/env python3
"""Where a K1 CTA spends its life, phase by phase, at qwen2-0.5b's shapes.

    python3 tools/k1_phases.py

Copies ``src/repro_torch`` into ``build/k1_phases/`` (gitignored), adds
to that copy's ``csrc/sliced_matmul.cuh`` a few stores that record, for
thread 0 of every CTA, ``clock64()`` at the boundaries of its phases and
``%globaltimer`` at its start and end, builds the copy and runs one K1
call per shape (int8 x int8, 128x128 tiles, ``dynamic_row``, noise on):
decode (M = 2, the tile's pair sums handed to its last CTA) and prefill
(M = 32, a cluster per tile).  The stamps go to the call's device
scratch, past what the kernel uses.  It prints the median microseconds
of each phase over the CTAs (and, at decode, over the tiles' last CTAs)
and checks the instrumented call's output against the plain version.
The repository's own kernel is not touched.
"""
from __future__ import annotations

import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
COPY = os.path.join(ROOT, "build", "k1_phases")

# stamp i of thread 0 of this CTA; slots 9 and 10 hold %globaltimer at the
# start (stamp 0) and the end (stamp 8), slot 11 the SM
STAMP = (
    "\n  if (tid == 0 && phase == 2) {{ unsigned long long* ts_ ="
    " reinterpret_cast<unsigned long long*>(A.scratch + (L.gx ? (size_t)gridDim.z * (A.Kp / T)"
    " * (A.Np / T) * SX * L.mr * P.sw_n * T : 0)) + ((size_t)blockIdx.x + gridDim.x *"
    " ((size_t)blockIdx.y + gridDim.y * blockIdx.z)) * 16; ts_[{i}] = clock64();"
    " if ({i} == 0 || {i} == 8) {{ unsigned long long g_;"
    " asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_)); ts_[9 + ({i} == 8)] = g_;"
    " unsigned sm_; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm_)); ts_[11] = sm_; }} }}\n"
)
# (anchor in sliced_matmul.cuh, stamp, stamp after the anchor?)
ANCHORS = (
    ("  if (unit_rows(L, M, u0).n == 0) return;  // an empty tail unit (whole cluster alike)\n",
     0, True),
    ("  const float swv = A.sw[kb * nn + j];\n", 1, True),
    ("    input_stage<T, SX>(A, staged, L, P, kb, U, X, sxs);\n", 2, True),
    ("    first = false;\n", 3, True),
    # decode: pairs stored, the tile's ticket, staging / ranges / ADC,
    # recombination, the K-block ticket and sum
    ("      if (!last_arrival(A.tickets + tix, csize, flag)) return;\n", 4, False),
    ("      if (!last_arrival(A.tickets + tix, csize, flag)) return;\n", 5, True),
    ("      for (int e = tid; e < U.n * T; e += blockDim.x) {\n        const int r = e / T, c = e % T;\n",
     6, False),
    ("      if (nk == 1) return;\n      if (!last_arrival(A.tickets + (size_t)gridDim.z", 7, False),
    ("        A.out[o] = ksum(A.part + o, (size_t)M * Np, nk);\n      }\n      return;\n", 8, False),
    # cluster: ranges exchanged, ADC, barrier and recombination, K-block sum
    ("    // ADC: q = rint(p / step) * step, into Q", 12, False),
    ("    if (csize > 1) cluster.sync(); else __syncthreads();\n\n    // recombination", 13, False),
    ("    // peers read this CTA's Q until they arrive", 14, False),
    ("  // K-block sum: the last of the nk CTAs adds the partials in K order\n", 15, False),
    ("  if (pending) cluster_wait();\n}\n", 8, False),
)
PHASES = {
    True: ([0, 1, 2, 3, 4, 5, 6, 7, 8],
           ["issue", "input", "chains", "store pairs", "tile ticket", "stage+range+ADC",
            "recombine", "K ticket+sum"]),
    False: ([0, 1, 2, 3, 12, 13, 14, 15, 8],
            ["issue", "input", "chains", "range exchange", "ADC", "barrier+recombine",
             "arrive..", "K ticket+sum"]),
}


def instrumented_copy() -> str:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(COPY, "src", "repro_torch"))
    path = os.path.join(COPY, "src", "repro_torch", "csrc", "sliced_matmul.cuh")
    with open(path) as fh:
        src = fh.read()
    for anchor, i, after in ANCHORS:
        if anchor not in src:
            raise SystemExit(f"k1_phases: anchor for stamp {i} not found: {anchor!r}")
        stamp = STAMP.format(i=i)
        src = src.replace(anchor, anchor + stamp if after else stamp + anchor, 1)
    with open(path, "w") as fh:
        fh.write(src)
    return os.path.join(COPY, "src")


def main() -> int:
    sys.path.insert(0, instrumented_copy())
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke
    import repro_torch.core  # noqa: F401  (import order of the port's modules)
    from repro_torch.core.dpe import prepare_weight
    from repro_torch.core.prng import PRNGKey
    from repro_torch.kernels import build
    from repro_torch.kernels import sliced_matmul as sm

    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device available", file=sys.stderr)
        return 2
    build.library()
    card = chip_smoke.card_line()
    dcfg = chip_smoke.faithful_policy().default
    kw = dict(input_spec=dcfg.input_spec, weight_spec=dcfg.weight_spec,
              array_size=dcfg.array_size, rdac=dcfg.rdac, radc=dcfg.radc,
              adc_mode="dynamic_row")
    g = torch.Generator(device="cuda").manual_seed(1)
    for label, k, n, m in (("q/o", 896, 896, 2), ("wi/wg", 896, 4864, 2),
                           ("lm_head", 896, 151936, 2), ("q/o", 896, 896, 32),
                           ("wi/wg", 896, 4864, 32)):
        w = torch.randn((k, n), generator=g, device="cuda") * k**-0.5
        pw = prepare_weight(w, dcfg.replace(noise_mode="program"), key=PRNGKey(3))
        x = torch.randn((m, k), generator=g, device="cuda")
        _, kp, np_ = pw.slices.shape
        plan = sm.plan_k1(m, kp, np_, 128, 4, 4, "dynamic_row", 128, dcfg.radc)
        nblk = plan.nn * plan.csize * plan.nk * plan.z
        off = plan.scratch_floats // 2  # int64 slots past the kernel's scratch
        ts = torch.zeros(off + nblk * 16, dtype=torch.int64, device="cuda")
        out = torch.empty((m, np_), device="cuda")
        part = torch.empty((plan.nk, m, np_), device="cuda")
        tickets = torch.zeros(plan.tickets, dtype=torch.int32, device="cuda")
        params = sm._spec_arrays(dcfg.input_spec, dcfg.weight_spec, dcfg.rdac, dcfg.radc,
                                 "dynamic_row", 128)
        fn = sm._entry("fused_sliced_matmul_launch")
        for _ in range(3):  # the last call's stamps are read
            rc = fn(x.data_ptr(), k, m, k, 1, pw.slices.data_ptr(), pw.scale.data_ptr(),
                    part.data_ptr(), out.data_ptr(), tickets.data_ptr(), plan.tickets,
                    ts.data_ptr(), plan.scratch_floats, kp, np_, 128, params[0], params[1],
                    plan.ints_ptr, 1.0, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"k1_phases: CUDA error {rc}")
            torch.cuda.synchronize()
        if not torch.equal(out, sm.fused_sliced_matmul_ref(x, pw.slices, pw.scale, **kw)):
            raise SystemExit(f"k1_phases: {label} M={m} differs from the plain version")
        t = ts[off:].view(nblk, 16).cpu().numpy().astype(np.int64)
        idx, names = PHASES[bool(plan.gx)]
        last = t[:, 8] > 0 if plan.gx else np.zeros(nblk, bool)
        end = np.where(last, t[:, 8], t[:, 4]) if plan.gx else t[:, 8]
        timed = (t[:, 8] > 0) & (t[:, 10] > t[:, 9])
        cyc_per_ns = float(np.median((t[timed, 8] - t[timed, 0]) / (t[timed, 10] - t[timed, 9])))
        life = (end - t[:, 0]) / cyc_per_ns / 1e3
        d = np.clip(np.diff(t[:, idx], axis=1), 0, None) / cyc_per_ns / 1e3
        print(f"{label} M={m}: {nblk} CTAs ({'decode, pairs to the last CTA' if plan.gx else 'cluster'}), "
              f"CTA life median {np.median(life):.2f} us  [{card}]")
        rows = [("every CTA", ~last if plan.gx else np.ones(nblk, bool))]
        if plan.gx:
            rows.append(("tiles' last CTAs", last))
        for what, sel in rows:
            print(f"  {what} ({int(sel.sum())}), median us: "
                  + ", ".join(f"{nm} {np.median(d[sel, i]):.2f}" for i, nm in enumerate(names)
                              if what != "every CTA" or not plan.gx or i < 4))
        del pw, w
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
