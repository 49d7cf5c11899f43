#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. the card: name and power limit from ``nvidia-smi``, torch / CUDA
   versions;
2. build every kernel from ``src/repro_torch/csrc`` with ``nvcc`` for
   ``sm_90a`` (the compiler's register / spill report goes to
   ``chiprun_out/chip_smoke/build.log``), meanwhile running the seven
   apps' plain versions on the card (``plain_apps``, held in phase 6);
3. hold each kernel against its plain PyTorch version on the card and
   time both (CUDA events, L2 flushed before each launch), beside the
   least time the card could take: K1 bit for bit at qwen2-0.5b's
   projections (with a drift factor of 0.93 too, and each row of a call
   of 2, 8 or 10 rows bit-equal to the row alone), then at 32x32, 64x64
   and 128x128 tiles and for the fp32,
   flex16_5, int8 x int4 and bf16 presets, and ``dpe_matmul`` with the
   paper's default ``DPEConfig()``; K2 / K3 bit for bit at qwen2-0.5b's
   head layout, in float32 and bf16, with and without a window, with
   SDPA's time over the gathered view beside them: K3 for 32-row chunks
   at start 0 and 37, at 4,064 (a 4K prompt's last chunk) and at 32,736
   (a 32K prompt's last chunk, in a 2,048-block table), K2 for 4 slots
   in a 16-block and a 2,048-block table at short positions and at pos
   6,143 and 32,767 (batched == solo), each timed in float32 beside the
   bound and the timer floor; K4, the staged engine
   (``prepare_input`` then ``ops.sliced_matmul``) at the paper's Table 2
   shape, bit-equal to its plain version, within 8 ulp of K1 and, at
   bm 64, at the reference's recorded error (``BENCH_dpe.json``); K5 at
   the reference test's shapes and at qwen2-0.5b width, within 2e-5
   (float32) and rel-Fro 2e-2 (bf16), with SDPA's time beside it in both
   dtypes and its bound at the TF32 tensor-core rate of its 3xTF32
   products; K6, the programming noise, bit for bit on a slice plane of
   every served weight shape, its bound from the operations a cell
   needs, counted by pipe at the card's issue rates (``K6_CELL``), with
   the compiled loop's SASS count beside it (``tools/k6_sass.py``);
4. draw qwen2-smoke's initial weights on the card (bit-equal to the
   CPU draw, which is the reference's) and qwen2-0.5b's at full width
   (timed); serve qwen2-0.5b at full width (24 layers, random weights
   from a seed) through ``ServeLoop`` with the ``mem_faithful`` policy
   (``dynamic_row`` ADC), programmed on the card (K6 must have launched
   once per slice plane of every weight): every request must
   complete, every kernel must have launched on the main path, and every
   request's tokens and every logit row (prefill and decode) must match
   the same run with the kernels' plain versions
   (``ServeConfig(kernels=False)``), which holds K2 and the decode-width
   K1 at the served shapes; then the same requests run once more under
   ``torch.profiler`` to split the card's busy time by kernel and give
   its idle share against the first run's wall time; then the same
   requests through a ``ServeLoop`` with ``max_len`` 32,768
   (qwen2-0.5b's context; block tables of 2,048 entries), whose tokens
   and logits must equal the ``max_len`` 128 run's bit for bit, and one
   request of 6,016 prompt tokens and 8 new ones (``max_len`` 8,192)
   served with prefill chunks of 32 and of 64, whose tokens must agree;
   then the same model serves the requests sampled (temperature 0.8,
   top-k 50, top-p 0.95, seed = rid) with one more at temperature 0 —
   bit-equal to the plain versions, the same tokens through 1 slot, the
   greedy tokens at temperature 0 —; speculatively (``spec_k`` 4) with
   a draft equal to the target (acceptance exactly 1) and with a digital
   draft, greedy and sampled, every token and logit row bit-equal to the
   plain decoding and the launches by the formula; and under a drifting
   policy (power law, nu 0.05) with an injected clock and refreshes under
   live traffic (K6 once a slice plane per refresh, requests admitted
   before a swap bit-equal to the run without refresh, the plain
   versions bit-equal, drift off equal to the greedy run); then the
   serve launcher, ``repro_torch.launch.serve.main``, at qwen2-0.5b's
   full width (``launch``): the default mode (``make_policy
   ("mem_faithful")``, batch 4, prompt 16, 16 new tokens) through the
   dense ``greedy_generate`` (K1 and K6 launched, by the formula; its
   tok/s and ITL), the same at 2 layers with ``--kernels on`` and
   ``off`` and with ``--per_call`` (tokens and every logit row
   bit-equal), ``--requests 8 --slots 4 --gen 8`` through the
   ``ServeLoop`` (K1, K2, K3 launched, every request finished), and one
   1,536-token prompt under ``digital`` through the dense path
   (``attention_chunked``) and the ``ServeLoop`` (equal tokens,
   first-token logits within max rel 1e-4); and K1 on one call of 1,536
   rows at a q projection's shape, bit-equal to its plain version
   (``check_k1_long``); then rwkv6-1.6b (the attention-free RWKV6
   ``ssm`` family, ``rwkv6``): at rwkv6-smoke the card's initial weights
   and launcher tokens (digital, ``mem_faithful``) equal to the CPU's;
   at full width and depth the launcher's default mode ``--arch
   rwkv6-1.6b --policy mem_faithful`` through the dense
   ``greedy_generate`` (K1 193 x 17 and K6 772 launches, no K2 / K3; its
   programming, prefill, ITL, idle share and K1 a step), one 4,096-token
   prompt under ``mem_faithful`` (prefill, ITL, peak memory, K1 193 x 5),
   a 100-token prompt under ``digital`` through the chunked WKV form
   against the same prompt fed token by token (equal tokens,
   first-token logits within max rel 1e-4), and the default mode at 2
   layers with ``--kernels on`` against ``off`` and ``--per_call``
   (tokens and every logit row bit-equal); ``--only rwkv6`` runs this
   phase alone after the build;
5. the trainer (``train``): ``repro_torch.launch.train.main`` at
   qwen2-0.5b's full width and depth under ``make_policy
   ("mem_faithful")``, batch 8 x 128 tokens, loss chunks of 64, remat
   on, float32, AdamW with the cosine schedule, 3 steps: every loss and
   grad norm finite, K1 and K6 launched by the formula (per step one
   programming and one K1 a projection and a loss chunk, twice with
   remat), its step time and tokens/s, one more step profiled (idle
   share against the host time of steps 1 and 2, K1 and K6 device ms a
   step), and, at 2 of the 24 layers (full width, batch 8 x 128, remat
   on), a resumed run (2 steps with ``--ckpt``, then to step 3)
   bit-equal to an uninterrupted one; K1 at the trainer's calls, each
   projection shape at 1,024 rows and the vocab head at 512 rows (its
   plain version over three slabs of 2,048 columns), bit-equal to its
   plain version (``check_k1_train``);
   at 2 of the 24 layers (batch 2 x 16, 2 steps) the kernels against
   their plain versions and remat on against off, every loss, grad
   norm, parameter and moment bit for bit (``train_plain``); one
   ``adamw`` and one ``adafactor`` update of a full-width layer on the
   card bit-equal to the CPU's, and the embedding gather's gradient
   (``take_rows``, 1,024 ids over 37 rows) too (``check_optim``); and
   ``repro_torch.examples.hw_training`` for 100 steps, whose loss must
   fall (``hw_training``).  ``python3 chip_smoke.py --only train``, an
   aid while developing the trainer (the smoke test proper takes no
   arguments), builds the kernels and runs these phases alone;
6. run the seven paper applications (``repro_torch.apps``) at their
   reference defaults (the default ``DPEConfig`` backend ``xla``: the
   ``dynamic`` ADC range spans a whole call, K-means' 150 rows
   included), once with the kernels and once with their plain versions:
   the results must be equal, and K1 must have launched in each of the
   five faithful ones.  The plain runs need no kernel, so they run on
   the card while ``nvcc`` builds the kernels (``plain_apps``);
7. the circuit backend (``DPEConfig(backend="circuit")``, the IR-drop
   crossbar solve) on the card against the same call on the CPU, rel-Fro
   <= 1e-6, with its wall time and device launches (``check_circuit``).

The line before the card line is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")

# published peaks of one H100 SXM (NVIDIA data sheet; 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # CUDA cores, no tensor cores
TF32_FLOP_PER_S = 495e12  # tensor cores, dense
BF16_FLOP_PER_S = 989e12  # tensor cores, dense


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float, rate: float = F32_FLOP_PER_S):
    """The least time for moving ``nbytes`` and doing ``flops`` at
    ``rate`` operations per second, and which of the two bounds it."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


class Timer:
    """Device time of a call over a few runs, L2 flushed before each one.
    A spin of about 6 ms on the card keeps it busy while the host issues
    the call, so a kernel's time holds no host overhead even when the
    host thread is held up for a few milliseconds; a plain version that
    issues more than that from the host is timed with it.  A call
    returns the median of the runs (which drops a run where the host was
    held up longer) and leaves their mean in ``self.mean``."""

    def __init__(self):
        self.flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
        self.mean = float("nan")

    def __call__(self, fn, iters=5, warmup=1) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(10_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        self.mean = statistics.fmean(times)
        return statistics.median(times)


def rel_max(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def rel_fro(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp_min(1e-300))


def faithful_policy():
    from repro_torch.core import INT8, DPEConfig, MemPolicy

    # launch/dryrun.py::make_policy("mem_faithful"), remapped to
    # dynamic_row ADC as launch/serve.py does for continuous batching
    cfg = DPEConfig(
        input_spec=INT8, weight_spec=INT8, array_size=(128, 128), mode="faithful",
        store_dtype="bf16", backend="auto", adc_mode="dynamic_row",
    )
    return MemPolicy(default=cfg, overrides=(("router", None),))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

DRIFT_F = 0.93  # a drift factor other than 1 (power law nu = 0.05 after ~3.3 s)
# the ADC modes each projection is held in bit for bit: the served mode
# (dynamic_row) and fullscale at every width; dynamic, whose plain
# version pads a call to 128 rows, at M <= 4 on every projection but the
# vocab head (the once-rounding plain K1 takes 7.4 s for the vocab head
# at 32 rows on an H100 at 700 W); the vocab head never runs 32 rows
ADC_SWEEP = {"q/o": ("dynamic", "dynamic_row", "fullscale"),
             "k/v": ("dynamic", "dynamic_row", "fullscale"),
             "wi/wg": ("dynamic", "dynamic_row", "fullscale"),
             "wo": ("dynamic", "dynamic_row", "fullscale"),
             "lm_head": ("dynamic_row", "fullscale"),
             "M=32": ("dynamic_row", "fullscale")}
SPEC_ROWS = 10  # a speculative verify of 2 slots x (spec_k = 4) + 1 positions


def check_k1(timer, qcfg, summary):
    """K1 at every served projection against its plain version, bit for
    bit (the ADC modes of ``ADC_SWEEP``, noise off and on, M = 1, 2, 4 and
    32 — the vocab head at M <= 4 —; with the drift factor 0.93 at M = 1,
    2 and 10); each row of a call at M = 2, 8 and 10 bit-equal to the row
    alone (``dynamic_row``); timed at the decode (M = 2, drift factor 1
    and 0.93) and prefill (M = 32) shapes."""
    from repro_torch.core.dpe import prepare_weight
    from repro_torch.core.prng import PRNGKey
    from repro_torch.kernels import sliced_matmul as sm

    dcfg = faithful_policy().default
    kw = dict(input_spec=dcfg.input_spec, weight_spec=dcfg.weight_spec,
              array_size=dcfg.array_size, rdac=dcfg.rdac, radc=dcfg.radc)
    d, f, v = qcfg.d_model, qcfg.d_ff, qcfg.vocab
    nh, nkv, hd = qcfg.n_heads, qcfg.n_kv_heads, qcfg.head_dim
    shapes = {"q/o": (d, nh * hd), "k/v": (d, nkv * hd), "wi/wg": (d, f),
              "wo": (f, d), "lm_head": (d, v)}
    per_step = {"q/o": 2 * qcfg.n_layers, "k/v": 2 * qcfg.n_layers,
                "wi/wg": 2 * qcfg.n_layers, "wo": qcfg.n_layers, "lm_head": 1}
    g = torch.Generator(device="cuda").manual_seed(11)
    n_checks = 0
    acc0 = {"ms": 0.0, "mean_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    decode, drifted, prefill = dict(acc0), dict(acc0), dict(acc0)
    for label, (k, n) in shapes.items():
        w = torch.randn((k, n), generator=g, device="cuda") * k**-0.5
        for noise in ("off", "program"):
            pw = prepare_weight(w, dcfg.replace(noise_mode=noise), key=PRNGKey(1234))
            for m in (1, 2, 4) + ((32,) if label != "lm_head" else ()):
                x = torch.randn((m, k), generator=g, device="cuda")
                for adc in ADC_SWEEP[label if m < 32 else "M=32"]:
                    y = sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, adc_mode=adc, **kw)
                    yp = sm.fused_sliced_matmul_ref(x, pw.slices, pw.scale, adc_mode=adc, **kw)
                    torch.cuda.synchronize()
                    if not bool(torch.isfinite(y).all()) or not torch.equal(y, yp):
                        raise AssertionError(f"K1 {label} M={m} {adc} noise={noise}: max diff "
                                             f"{float((y - yp).abs().max())} to the plain version")
                    n_checks += 1
            if noise == "program":
                x = torch.randn((SPEC_ROWS, k), generator=g, device="cuda")
                run = lambda xx, **o: sm.fused_sliced_matmul_cuda(  # noqa: E731
                    xx.contiguous(), pw.slices, pw.scale, adc_mode="dynamic_row", **kw, **o)
                alone = torch.cat([run(x[i:i + 1]) for i in range(SPEC_ROWS)])
                for m in (2, 8, SPEC_ROWS):
                    if not torch.equal(run(x[:m]), alone[:m]):
                        raise AssertionError(f"K1 {label}: rows at M={m} differ from M=1")
                for m in (1, 2, SPEC_ROWS):
                    y = run(x[:m], drift=DRIFT_F)
                    yp = sm.fused_sliced_matmul_ref(x[:m], pw.slices, pw.scale,
                                                    adc_mode="dynamic_row", drift=DRIFT_F, **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(y, yp):
                        raise AssertionError(f"K1 {label} M={m} drift {DRIFT_F}: max diff "
                                             f"{float((y - yp).abs().max())} to the plain version")
                    n_checks += 1
                sw, ss = pw.slices, pw.scale
                kp, np_ = sw.shape[1], sw.shape[2]
                for mm, f_, acc, count in ((2, 1.0, decode, per_step[label]),
                                           (2, DRIFT_F, drifted, per_step[label]),
                                           (32, 1.0, prefill,
                                            per_step[label] if label != "lm_head" else 0)):
                    if count == 0:  # the vocab head never runs a 32-row chunk
                        continue
                    x = torch.randn((mm, k), generator=g, device="cuda")
                    run = lambda: sm.fused_sliced_matmul_cuda(  # noqa: E731
                        x, sw, ss, adc_mode="dynamic_row", drift=f_, **kw)
                    plain = lambda: sm.fused_sliced_matmul_ref(  # noqa: E731
                        x, sw, ss, adc_mode="dynamic_row", drift=f_, **kw)
                    t = timer(run)
                    t_mean = timer.mean
                    tp = timer(plain, iters=2) if f_ == 1.0 else float("nan")
                    nbytes = 4 * (sw.numel() + ss.numel() + x.numel() + mm * np_)
                    pairs = dcfg.input_spec.n_slices * dcfg.weight_spec.n_slices
                    flops = 2 * pairs * mm * kp * np_
                    b, by = bound_ms(nbytes, flops)
                    plan = sm.plan_k1(mm, kp, np_, dcfg.array_size[0], dcfg.input_spec.n_slices,
                                      dcfg.weight_spec.n_slices, "dynamic_row", 128, dcfg.radc)
                    print(f"K1 time {label:7s} M={mm:2d} drift {f_}: {plan.ctas} CTAs in "
                          f"{plan.launches} launch(es), kernel {t:.4f} ms (mean {t_mean:.4f})  "
                          f"plain {tp:.4f} ms  bound {b:.4f} ms ({by}), {b / t:.1%} of it  "
                          f"x{count} per {'decode step' if mm == 2 else 'prefill chunk'}")
                    acc["ms"] += count * t
                    acc["mean_ms"] += count * t_mean
                    acc["plain_ms"] += count * tp
                    acc["bytes"] += count * nbytes
                    acc["flops"] += count * flops
            del pw
        del w
        torch.cuda.empty_cache()
    print(f"K1 bit-equal to its plain version at every served projection ({n_checks} checks, "
          f"drift factor {DRIFT_F} included); rows independent of M = 1, 2, 8, {SPEC_ROWS}")
    for name, acc in (("decode step (M=2, 169 calls)", decode),
                      (f"decode step (M=2, 169 calls, drift {DRIFT_F})", drifted),
                      ("prefill chunk (M=32, 168 calls, non-final)", prefill)):
        b, by = bound_ms(acc["bytes"], acc["flops"])
        print(f"K1 {name}: kernel {acc['ms']:.3f} ms (sum of medians; sum of means "
              f"{acc['mean_ms']:.3f} ms)  plain {acc['plain_ms']:.3f} ms  "
              f"bound {b:.3f} ms ({by}, {acc['bytes'] / 1e9:.2f} GB, "
              f"{acc['flops'] / 1e12:.3f} TFLOP)")
        acc["bound"], acc["by"] = b, by
    summary["fused_sliced_matmul"] = dict(
        max_abs_err=0.0, ms=decode["ms"], plain_ms=decode["plain_ms"],
        bound_ms=decode["bound"], bound_by=decode["by"], library_ms=None,
    )


def _pools(g, n_blocks, bs, kv, hd, dtype):
    mk = lambda: torch.randn((n_blocks, bs, kv, hd), generator=g, device="cuda").to(dtype)
    return mk(), mk()


def _gathered(pa, pool, bt, grp):
    """SDPA's K or V: the logical view of the table(s), one copy per query head."""
    bt2 = bt if bt.dim() == 2 else bt[None]
    return pa._paged_gather(pool, bt2).permute(0, 2, 1, 3).repeat_interleave(grp, dim=1)


def check_k2_k3(timer, qcfg, summary, card, floor):
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa

    h, kv, hd = qcfg.n_heads, qcfg.n_kv_heads, qcfg.head_dim
    bs, nb, b = 16, 16, 4
    n_blocks = 1 + b * nb
    g = torch.Generator(device="cuda").manual_seed(7)
    worst = {"paged_decode_attention": 0.0, "paged_chunk_attention": 0.0}
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        pk, pv = _pools(g, n_blocks, bs, kv, hd, dtype)
        perm = torch.randperm(n_blocks - 1, generator=g, device="cuda").to(torch.int32) + 1
        bt = perm[: b * nb].reshape(b, nb).contiguous()
        pos = torch.randint(0, nb * bs, (b,), generator=g, device="cuda").to(torch.int32)
        # unmapped tail entries point at the trash block
        for i in range(b):
            bt[i, int(pos[i]) // bs + 1:] = 0
        q = torch.randn((b, h, hd), generator=g, device="cuda")
        for window in (0, 24):
            y = pa.paged_decode_attention_cuda(q, pk, pv, bt, pos, window=window)
            yp = pa.paged_decode_attention_ref(q, pk, pv, bt, pos, window=window)
            torch.cuda.synchronize()
            err = float((y.float() - yp.float()).abs().max())
            worst["paged_decode_attention"] = max(worst["paged_decode_attention"], err)
            print(f"K2 B={b} {str(dtype):14s} window={window:2d} pos={pos.tolist()} "
                  f"max abs err={err:.2e} bit-equal={torch.equal(y, yp)}")
            if not torch.equal(y, yp):
                raise AssertionError(f"K2 {dtype} window={window}: differs by {err}")
        if dtype == torch.float32:
            el = 4
            n_keys = int((pos + 1).sum())
            nbytes = el * (2 * n_keys * kv * hd + 2 * q.numel()) + 4 * (bt.numel() + b)
            flops = 4 * h * hd * n_keys
            kg, vg = _gathered(pa, pk, bt, h // kv), _gathered(pa, pv, bt, h // kv)
            mask = (torch.arange(nb * bs, device="cuda")[None, :] <= pos[:, None].long())
            timing["paged_decode_attention"] = dict(
                ms=timer(lambda: pa.paged_decode_attention_cuda(q, pk, pv, bt, pos), iters=20),
                plain_ms=timer(lambda: pa.paged_decode_attention_ref(q, pk, pv, bt, pos), iters=20),
                library_ms=timer(lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kg, vg, attn_mask=mask[:, None, None]),
                    iters=20),
                bound=bound_ms(nbytes, flops),
            )
        c = 32
        bt_row = bt[0].clone()
        bt_row[:] = perm[:nb]
        qc = torch.randn((1, c, h, hd), generator=g, device="cuda")
        for start in (0, 37):
            for window in (0, 24):
                y = pa.paged_chunk_attention_cuda(qc, pk, pv, bt_row, start, c, window=window)
                yp = pa.paged_chunk_attention_ref(qc, pk, pv, bt_row, start, c, window=window)
                torch.cuda.synchronize()
                err = float((y.float() - yp.float()).abs().max())
                worst["paged_chunk_attention"] = max(worst["paged_chunk_attention"], err)
                print(f"K3 C={c} start={start:2d} {str(dtype):14s} window={window:2d} "
                      f"max abs err={err:.2e} bit-equal={torch.equal(y, yp)}")
                if not torch.equal(y, yp):
                    raise AssertionError(f"K3 start={start} {dtype} window={window}: differs by {err}")
        if dtype == torch.float32:
            start = 37
            n_keys = sum(start + i + 1 for i in range(c))
            nbytes = 4 * (2 * (start + c) * kv * hd + 2 * qc.numel() + nb)
            flops = 4 * h * hd * n_keys
            kg, vg = _gathered(pa, pk, bt_row, h // kv), _gathered(pa, pv, bt_row, h // kv)
            qi = start + torch.arange(c, device="cuda")[:, None]
            cmask = torch.arange(nb * bs, device="cuda")[None, :] <= qi
            timing["paged_chunk_attention"] = dict(
                ms=timer(lambda: pa.paged_chunk_attention_cuda(qc, pk, pv, bt_row, start, c), iters=20),
                plain_ms=timer(lambda: pa.paged_chunk_attention_ref(qc, pk, pv, bt_row, start, c),
                               iters=20),
                library_ms=timer(lambda: F.scaled_dot_product_attention(
                    qc.permute(0, 2, 1, 3), kg, vg, attn_mask=cmask), iters=20),
                bound=bound_ms(nbytes, flops),
            )
    # K2's fixed cost and its cost per key: every slot at pos 0, then at
    # the last position (float32, the check's pools and tables)
    pk, pv = _pools(g, n_blocks, bs, kv, hd, torch.float32)
    bt_full = (torch.randperm(n_blocks - 1, generator=g, device="cuda").to(torch.int32)
               + 1)[: b * nb].reshape(b, nb).contiguous()
    q = torch.randn((b, h, hd), generator=g, device="cuda")
    ends = {}
    for p in (0, nb * bs - 1):
        pos = torch.full((b,), p, dtype=torch.int32, device="cuda")
        ends[p] = timer(lambda: pa.paged_decode_attention_cuda(q, pk, pv, bt_full, pos), iters=20)
    per_key = (ends[nb * bs - 1] - ends[0]) / (nb * bs - 1)
    print(f"K2 at pos 0: {ends[0]:.4f} ms; at pos {nb * bs - 1}: {ends[nb * bs - 1]:.4f} ms "
          f"({per_key * 1e6:.1f} ns per key)  [{card}]")
    for name, t in timing.items():
        b, by = t["bound"]
        print(f"{name}: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
              f"SDPA over the gathered view {t['library_ms']:.4f} ms  bound {b:.5f} ms ({by})  "
              f"timer floor {floor:.4f} ms  [{card}]")
        summary[name] = dict(max_abs_err=worst[name], ms=t["ms"], plain_ms=t["plain_ms"],
                             bound_ms=b, bound_by=by, library_ms=t["library_ms"])


def check_k2_k3_long(timer, qcfg, summary, card, floor):
    """K3 and K2 past the served shapes, at qwen2-0.5b's heads: K3's last
    chunk of a 4K prompt (start 4,064) in a 256-block table and of a 32K
    prompt (start 32,736) in a 2,048-block table; K2 for 4 slots in a
    2,048-block table at short positions (every score kept, as at 16
    blocks) and at pos 6,143 and 32,767 (scores recomputed per pass),
    batched == solo; f32 and bf16, window 0 and 24 (window 0 alone past
    the 4K chunk: the once-rounding plain versions take seconds a call
    there), bit for bit.  Times in f32 beside the plain version, SDPA
    over the gathered view, the bound and the timer floor."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa

    h, kv, hd = qcfg.n_heads, qcfg.n_kv_heads, qcfg.head_dim
    grp, bs, c = h // kv, 16, 32
    g = torch.Generator(device="cuda").manual_seed(15)
    worst = summary["paged_chunk_attention"]
    worst2 = summary["paged_decode_attention"]
    t0 = time.monotonic()
    for nb, starts in ((256, (4064,)), (2048, (32736,))):
        for dtype in (torch.float32, torch.bfloat16):
            pk, pv = _pools(g, nb + 1, bs, kv, hd, dtype)
            bt_row = (torch.randperm(nb, generator=g, device="cuda") + 1).to(torch.int32)
            qc = torch.randn((1, c, h, hd), generator=g, device="cuda").to(dtype)
            for start in starts:
                for window in (0, 24) if start < 30000 else (0,):
                    y = pa.paged_chunk_attention_cuda(qc, pk, pv, bt_row, start, c, window=window)
                    yp = pa.paged_chunk_attention_ref(qc, pk, pv, bt_row, start, c, window=window)
                    torch.cuda.synchronize()
                    err = float((y.float() - yp.float()).abs().max())
                    worst["max_abs_err"] = max(worst["max_abs_err"], err)
                    print(f"K3 C={c} start={start} table={nb} blocks {str(dtype):14s} "
                          f"window={window:2d} max abs err={err:.2e} bit-equal={torch.equal(y, yp)}")
                    if not torch.equal(y, yp):
                        raise AssertionError(f"K3 start={start} {dtype} window={window}: {err}")
            if dtype == torch.float32:
                for start in starts:
                    _time_k3(timer, pa, F, pk, pv, bt_row, qc, start, grp, card, floor)
            del pk, pv
            torch.cuda.empty_cache()
    # K2: 4 slots in a 2,048-block table
    nb, b = 2048, 4
    for dtype in (torch.float32, torch.bfloat16):
        pk, pv = _pools(g, nb + 1, bs, kv, hd, dtype)
        q = torch.randn((b, h, hd), generator=g, device="cuda")
        for label, plist in (("short", None), ("long", [6143, 32767, 6143 - 77, 32767 - 1000])):
            pos = (torch.randint(0, 256, (b,), generator=g, device="cuda") if plist is None
                   else torch.tensor(plist, device="cuda")).to(torch.int32)
            bt = torch.stack([torch.randperm(nb, generator=g, device="cuda") + 1
                              for _ in range(b)]).to(torch.int32)
            for i in range(b):  # unmapped tail entries point at the trash block
                bt[i, int(pos[i]) // bs + 1:] = 0
            bt = bt.contiguous()
            for window in (0, 24) if plist is None else (0,):
                y = pa.paged_decode_attention_cuda(q, pk, pv, bt, pos, window=window)
                yp = pa.paged_decode_attention_ref(q, pk, pv, bt, pos, window=window)
                solo = torch.cat([pa.paged_decode_attention_cuda(
                    q[i:i + 1].contiguous(), pk, pv, bt[i:i + 1].contiguous(),
                    pos[i:i + 1].contiguous(), window=window) for i in range(b)])
                torch.cuda.synchronize()
                err = float((y.float() - yp.float()).abs().max())
                worst2["max_abs_err"] = max(worst2["max_abs_err"], err)
                print(f"K2 B={b} table={nb} blocks {str(dtype):14s} window={window:2d} "
                      f"pos={pos.tolist()} max abs err={err:.2e} bit-equal={torch.equal(y, yp)} "
                      f"batched == solo: {torch.equal(y, solo)}")
                if not (torch.equal(y, yp) and torch.equal(y, solo)):
                    raise AssertionError(f"K2 {label} {dtype} window={window}: {err}")
        if dtype == torch.float32:
            _time_k2_wide(timer, pa, F, pk, pv, q, grp, card, floor)
        del pk, pv
        torch.cuda.empty_cache()
    print(f"long-context K2 / K3 checks: {time.monotonic() - t0:.1f} s")


def _time_k3(timer, pa, F, pk, pv, bt_row, qc, start, grp, card, floor):
    c, h, hd, kv = qc.shape[1], qc.shape[2], qc.shape[3], pk.shape[2]
    n_keys = sum(start + i + 1 for i in range(c))
    nbytes = 4 * (2 * (start + c) * kv * hd + 2 * qc.numel() + bt_row.numel())
    b, by = bound_ms(nbytes, 4 * h * hd * n_keys)
    kg, vg = _gathered(pa, pk, bt_row, grp), _gathered(pa, pv, bt_row, grp)
    qi = start + torch.arange(c, device="cuda")[:, None]
    cmask = torch.arange(kg.shape[2], device="cuda")[None, :] <= qi
    t = timer(lambda: pa.paged_chunk_attention_cuda(qc, pk, pv, bt_row, start, c), iters=20)
    # the plain version at a 32K context is held against the kernel above
    # but not timed: its once-rounding chains take seconds a call
    tp = float("nan") if start > 30000 else timer(
        lambda: pa.paged_chunk_attention_ref(qc, pk, pv, bt_row, start, c),
        iters=2 if start > 1000 else 5)
    tl = timer(lambda: F.scaled_dot_product_attention(qc.permute(0, 2, 1, 3), kg, vg,
                                                      attn_mask=cmask), iters=20)
    print(f"K3 time C={c} start={start} table={bt_row.numel()} blocks f32: kernel {t:.4f} ms  "
          f"plain {tp:.4f} ms  SDPA over the gathered view {tl:.4f} ms  bound {b:.5f} ms ({by})  "
          f"timer floor {floor:.4f} ms  [{card}]")


def _time_k2_wide(timer, pa, F, pk, pv, q, grp, card, floor):
    """K2 at the served shape (4 slots, random positions below 256) in a
    2,048-block table, and with every slot at pos 32,767."""
    nb, bs, b = 2048, 16, q.shape[0]
    g = torch.Generator(device="cuda").manual_seed(16)
    for label, pos in (("served positions", torch.randint(0, 256, (b,), generator=g,
                                                          device="cuda")),
                       ("pos 32767", torch.full((b,), 32767, device="cuda"))):
        pos = pos.to(torch.int32)
        bt = torch.stack([torch.randperm(nb, generator=g, device="cuda") + 1
                          for _ in range(b)]).to(torch.int32)
        for i in range(b):
            bt[i, int(pos[i]) // bs + 1:] = 0
        bt = bt.contiguous()
        n_keys = int((pos + 1).sum())
        nbytes = 4 * (2 * n_keys * pk.shape[2] * pk.shape[3] + 2 * q.numel()) + 4 * (bt.numel() + b)
        bnd, by = bound_ms(nbytes, 4 * q.shape[1] * q.shape[2] * n_keys)
        t = timer(lambda: pa.paged_decode_attention_cuda(q, pk, pv, bt, pos), iters=20)
        kg, vg = _gathered(pa, pk, bt, grp), _gathered(pa, pv, bt, grp)
        mask = torch.arange(nb * bs, device="cuda")[None, :] <= pos[:, None].long()
        tl = timer(lambda: F.scaled_dot_product_attention(q[:, :, None], kg, vg,
                                                          attn_mask=mask[:, None, None]), iters=20)
        print(f"K2 time B={b} table={nb} blocks, {label} {pos.tolist()}: kernel {t:.4f} ms  "
              f"SDPA over the gathered view {tl:.4f} ms  bound {bnd:.5f} ms ({by})  "
              f"timer floor {floor:.4f} ms  [{card}]")
        del kg, vg


# ---------------------------------------------------------------------------
# phase 4: serve qwen2-0.5b through ServeLoop
# ---------------------------------------------------------------------------

def serve(qcfg, card, counters):
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, programmed_byte_size
    from repro_torch.serve import Request, ServeConfig, ServeLoop

    def drawn(tree):  # the weights ("w"); norm scales and biases are constants
        return sum(drawn(v) if isinstance(v, dict) else (v.numel() if k == "w" else 0)
                   for k, v in tree.items())

    t0 = time.monotonic()
    params = init_params(qcfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_draws = drawn(params)
    print(f"init params (threefry, the reference's key tree): {n_draws / 1e6:.1f} M uniforms "
          f"drawn on the card in {time.monotonic() - t0:.2f} s  [{card}]")
    sc = ServeConfig(
        policy=faithful_policy(), slots=2, max_len=128, prefill_chunk=32,
        block_size=16, compute_dtype=torch.float32, device="cuda",
        collect_logits=True,
    )
    ops.reset_counters()
    t0 = time.monotonic()
    loop = ServeLoop(params, qcfg, sc)
    torch.cuda.synchronize()
    t_prog = time.monotonic() - t0
    mb = programmed_byte_size(loop.programmed) / 1e6
    noisy = ops.COUNTERS["program_noise"].count
    expect = K6_PER_PROGRAMMING(qcfg, sc.policy)
    print(f"programmed {mb:.1f} MB of crossbar state on the card in {t_prog:.2f} s "
          f"({noisy} K6 launches, expected {expect})  [{card}]")
    if noisy != expect:
        raise AssertionError(f"programming: {noisy} K6 launches, expected {expect}")
    counters["program_noise"] = noisy
    rng = np.random.default_rng(0)
    warm = [Request(100, rng.integers(0, qcfg.vocab, 20).astype(np.int32), 2)]
    loop.run(warm)
    torch.cuda.synchronize()
    lens = [16, 40, 64, 27]
    reqs = [Request(i, rng.integers(0, qcfg.vocab, n).astype(np.int32), 8)
            for i, n in enumerate(lens)]
    ops.reset_counters()
    rep = loop.run(reqs)
    torch.cuda.synchronize()
    launches = served_launches()
    check_finished(rep, "serve")
    expect = {
        "fused_sliced_matmul": 168 * rep.prefill_chunks_run + len(reqs) + 169 * rep.decode_steps,
        "paged_decode_attention": qcfg.n_layers * rep.decode_steps,
        "paged_chunk_attention": qcfg.n_layers * rep.prefill_chunks_run,
    }
    check_launches("serve", launches, expect, rep)
    counters.update(launches)
    print(f"serve qwen2-0.5b mem_faithful dynamic_row, 24 layers, 2 slots, 4 requests "
          f"x 8 tokens: {rate_line(rep)}  [{card}]")
    print("tokens:", [r.tokens for r in rep.results])

    # every row: the first comes from the final prefill chunk (K1, K3),
    # the rest from decode steps (K1 at M = live slots, K2)
    _, prep = check_plain("serve", params, qcfg, sc, loop.programmed, reqs)
    print(f"plain-version run ({CUT_LAYERS} layers): {prep.tok_per_s:.3f} tok/s, wall "
          f"{prep.wall_s:.2f} s  [{card}]")
    device_busy(loop, reqs, rep, card)
    serve_long(params, qcfg, sc, loop, reqs, rep, card)
    return params, sc, loop, reqs, rep


def K6_PER_PROGRAMMING(qcfg, policy):
    """K6 launches of one programming pass: one a slice plane of the 7
    faithful weights of every layer and the vocab head."""
    return (7 * qcfg.n_layers + 1) * policy.default.weight_spec.n_slices


def served_launches() -> dict:
    from repro_torch.kernels import ops

    return {name: ops.COUNTERS[name].count for name in
            ("fused_sliced_matmul", "paged_decode_attention", "paged_chunk_attention")}


def check_launches(phase, launches, expect, rep):
    print(f"{phase}: launches {launches}; expected {expect} ({rep.prefill_chunks_run} prefill "
          f"chunks, {rep.decode_steps} decode steps or rounds)")
    for name, n in launches.items():
        if n <= 0 or n != expect[name]:
            raise AssertionError(f"{phase}: {name} {n} launches, expected {expect[name]}")


def check_finished(rep, phase, n_tokens=8):
    for r in rep.results:
        if r.finish_reason != "length" or len(r.tokens) != n_tokens:
            raise AssertionError(f"{phase}: request {r.rid}: {r.finish_reason} {r.tokens}")
        if not all(np.isfinite(row).all() for row in r.logits):
            raise AssertionError(f"{phase}: request {r.rid}: non-finite logits")


def check_bitwise(what, rep_a, rep_b, rids=None):
    """Equal tokens and every logit row bit for bit, request by request."""
    for a, b in zip(rep_a.results, rep_b.results):
        if rids is not None and a.rid not in rids:
            continue
        same = (a.tokens == b.tokens and len(a.logits) == len(b.logits)
                and all(np.array_equal(x, y) for x, y in zip(a.logits, b.logits)))
        if not same:
            raise AssertionError(f"{what}: request {a.rid}: tokens {a.tokens} vs {b.tokens}, "
                                 "or other logits")
    n = sum(len(r.logits) for r in rep_a.results if rids is None or r.rid in rids)
    print(f"{what}: tokens and all {n} logit rows bit-equal")


CUT_LAYERS = 2  # the depth of the kernels-against-plain comparisons of the serving phases


def cut_depth(qcfg, params, programmed):
    """qwen2-0.5b at full width cut to its first ``CUT_LAYERS`` layers (views of
    the stacked leaves; layer i keeps the full model's key chain, so the
    programmed state of the cut is the full state's first layers).  The
    plain versions of a full-depth served run take 204 s with the plain
    K1 rounding once (an H100 at 700 W), so the serving phases hold the
    kernels against them at this depth."""
    from repro_torch.models.common import tree_map

    n = CUT_LAYERS

    def first(tree):
        return {**tree, "blocks": {k: tree_map(lambda t: t[:n], v)
                                   for k, v in tree["blocks"].items()}}

    return qcfg.replace(n_layers=n), first(params), first(programmed)


def check_plain(what, params, qcfg, sc, programmed, reqs, clock=None):
    """A run of the kernels and one of their plain versions on the model
    cut to ``CUT_LAYERS`` layers (each with a fresh ``clock()``, if given):
    equal tokens, every logit row bit-equal."""
    from repro_torch.serve import ServeLoop

    ccfg, cparams, cprog = cut_depth(qcfg, params, programmed)
    runs = []
    for kernels in (True, False):
        run_sc = sc.replace(kernels=kernels, **({"clock": clock()} if clock else {}))
        runs.append(ServeLoop(cparams, ccfg, run_sc, programmed=cprog).run(reqs))
    torch.cuda.synchronize()
    check_bitwise(f"{what}, kernels against their plain versions ({CUT_LAYERS} layers)", *runs)
    return runs


def rate_line(rep) -> str:
    ttft, itl = rep.ttft_percentiles(), rep.itl_percentiles()
    return (f"{rep.tok_per_s:.2f} tok/s, wall {rep.wall_s:.2f} s, TTFT mean "
            f"{ttft['mean'] * 1e3:.1f} ms p50 {ttft['p50'] * 1e3:.1f} ms, ITL mean "
            f"{itl['mean'] * 1e3:.1f} ms p50 {itl['p50'] * 1e3:.1f} ms")


def serve_long(params, qcfg, sc, loop, reqs, rep, card):
    """qwen2-0.5b's whole context (32,768 tokens, arXiv:2407.10671): the
    served requests once more through a ``ServeLoop`` with ``max_len``
    32,768 (block tables of 2,048 entries) on the same programmed state,
    whose tokens and logits must equal the ``max_len`` 128 run's bit for
    bit; then one request of 6,016 prompt tokens and 8 new ones at
    ``max_len`` 8,192, so that every decode step's K2 reads more than the
    5,664 positions the old K2 could hold, served with prefill chunks of
    32 and of 64 (kernels only): equal tokens."""
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, ServeLoop

    wide = ServeLoop(params, qcfg, sc.replace(max_len=32768), programmed=loop.programmed)
    ops.reset_counters()
    wrep = wide.run(reqs)
    torch.cuda.synchronize()
    for a, b in zip(rep.results, wrep.results):
        same = (a.tokens == b.tokens and len(a.logits) == len(b.logits)
                and all(np.array_equal(x, y) for x, y in zip(a.logits, b.logits)))
        if not same:
            raise AssertionError(f"request {a.rid}: max_len 32768 gives {b.tokens}, "
                                 f"max_len 128 {a.tokens}, or other logits")
    print(f"max_len 32768 (tables of {wide.blocks_per_slot} blocks): tokens and all "
          f"{sum(len(r.logits) for r in wrep.results)} logit rows bit-equal to max_len 128; "
          f"launches {ops.COUNTERS['paged_decode_attention'].count} K2, "
          f"{ops.COUNTERS['paged_chunk_attention'].count} K3; ITL mean "
          f"{wrep.itl_percentiles()['mean'] * 1e3:.1f} ms (max_len 128: "
          f"{rep.itl_percentiles()['mean'] * 1e3:.1f} ms)  [{card}]")
    del wide
    torch.cuda.empty_cache()

    prompt = np.random.default_rng(6016).integers(0, qcfg.vocab, 6016).astype(np.int32)
    tokens = {}
    for chunk in (32, 64):
        lp = ServeLoop(params, qcfg, sc.replace(slots=1, max_len=8192, prefill_chunk=chunk),
                       programmed=loop.programmed)
        ops.reset_counters()
        lrep = lp.run([Request(0, prompt, 8)])
        torch.cuda.synchronize()
        r = lrep.results[0]
        k2 = ops.COUNTERS["paged_decode_attention"].count
        k3 = ops.COUNTERS["paged_chunk_attention"].count
        if r.finish_reason != "length" or len(r.tokens) != 8:
            raise AssertionError(f"long request, chunk {chunk}: {r.finish_reason} {r.tokens}")
        if not all(np.isfinite(row).all() for row in r.logits):
            raise AssertionError(f"long request, chunk {chunk}: non-finite logits")
        if (lrep.decode_steps != 7 or k2 != qcfg.n_layers * lrep.decode_steps
                or k3 != qcfg.n_layers * lrep.prefill_chunks_run):
            raise AssertionError(f"long request, chunk {chunk}: {lrep.decode_steps} decode "
                                 f"steps, {k2} K2 and {k3} K3 launches")
        tokens[chunk] = r.tokens
        print(f"long request (6016 prompt tokens, 8 new, max_len 8192), prefill chunk {chunk}: "
              f"{lrep.prefill_chunks_run} chunks, {lrep.decode_steps} decode steps at positions "
              f"6016-6022 ({k2} K2, {k3} K3 launches), TTFT {r.ttft_s * 1e3:.0f} ms, ITL mean "
              f"{lrep.itl_percentiles()['mean'] * 1e3:.1f} ms, wall {lrep.wall_s:.2f} s; "
              f"tokens {r.tokens}  [{card}]")
        del lp
        torch.cuda.empty_cache()
    if tokens[32] != tokens[64]:
        raise AssertionError(f"long request: chunk 32 gives {tokens[32]}, chunk 64 {tokens[64]}")


# ---------------------------------------------------------------------------
# phase 4b: sampled, speculative and drifting serving on the same model
# ---------------------------------------------------------------------------

SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
SPEC_K = 4


def check_init(card):
    """The initial weights drawn on the card are the CPU draw's bits at
    qwen2-smoke (the CPU draw is the reference's, tests/test_torch_model.py)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_params
    from repro_torch.models.common import tree_leaves

    cfg = get_smoke("qwen2-0.5b")
    for seed in (0, 3):
        a = tree_leaves(init_params(cfg, seed, device="cuda"))
        b = tree_leaves(init_params(cfg, seed, device="cpu"))
        if len(a) != len(b) or not all(torch.equal(x.cpu(), y) for x, y in zip(a, b)):
            raise AssertionError(f"init_params(qwen2-smoke, {seed}): the card's draw differs")
    print(f"init_params at qwen2-smoke, seeds 0 and 3: the card's draw bit-equal to the CPU's  "
          f"[{card}]")


def sampled_requests(reqs):
    """The served requests, each sampled with its rid as the seed, and one
    more at temperature 0 (request 0's prompt)."""
    from repro_torch.serve import Request, SamplingParams

    out = [Request(r.rid, r.tokens, r.max_new_tokens,
                   sampling=SamplingParams(seed=r.rid, **SAMPLED)) for r in reqs]
    out.append(Request(len(reqs), reqs[0].tokens, reqs[0].max_new_tokens,
                       sampling=SamplingParams(temperature=0.0, seed=99)))
    return out


def serve_sampled(params, qcfg, sc, loop, reqs, rep, card):
    """The served requests sampled (temperature 0.8, top-k 50, top-p 0.95,
    seed = rid) plus one at temperature 0, through 2 slots: equal tokens
    and bit-equal logits with the plain versions, the same tokens through
    1 slot, and the temperature-0 request gives the greedy run's tokens."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeLoop

    sreqs = sampled_requests(reqs)
    ops.reset_counters()
    srep = loop.run(sreqs)
    torch.cuda.synchronize()
    launches = served_launches()
    check_finished(srep, "serve_sampled")
    check_launches("serve_sampled", launches, {
        "fused_sliced_matmul": 168 * srep.prefill_chunks_run + len(sreqs) + 169 * srep.decode_steps,
        "paged_decode_attention": qcfg.n_layers * srep.decode_steps,
        "paged_chunk_attention": qcfg.n_layers * srep.prefill_chunks_run,
    }, srep)
    print(f"serve_sampled (4 sampled requests + 1 at temperature 0, 2 slots): {rate_line(srep)}"
          f"  [{card}]")
    print("sampled tokens:", [r.tokens for r in srep.results])
    if srep.results[-1].tokens != rep.results[0].tokens or not all(
            np.array_equal(x, y) for x, y in zip(srep.results[-1].logits, rep.results[0].logits)):
        raise AssertionError("temperature 0 does not give the greedy tokens and logits")
    check_plain("serve_sampled", params, qcfg, sc, loop.programmed, sreqs)
    solo = ServeLoop(params, qcfg, sc.replace(slots=1), programmed=loop.programmed)
    one = solo.run(sreqs)
    for a, b in zip(srep.results, one.results):
        if a.tokens != b.tokens:
            raise AssertionError(f"serve_sampled: request {a.rid}: 2 slots {a.tokens}, "
                                 f"1 slot {b.tokens}")
    print("serve_sampled: 2 slots and 1 slot give the same tokens; the temperature-0 request "
          "the greedy tokens and logits bit for bit")
    return sreqs, srep


def serve_spec(params, qcfg, sc, loop, reqs, rep, sreqs, srep, card):
    """``spec_k`` = 4 with the draft the target itself (same policy and
    noise key: acceptance exactly 1) and with the default digital draft,
    for the greedy and the sampled requests: tokens and every logit row
    bit-equal to the plain (non-speculative) runs, launches by the
    formula."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeLoop

    for draft in ("target", "digital"):
        spec = ServeLoop(params, qcfg, sc.replace(
            spec_k=SPEC_K, draft_policy=sc.policy if draft == "target" else None),
            programmed=loop.programmed)
        faithful_draft = draft == "target"
        for label, rq, base in (("greedy", reqs, rep), ("sampled", sreqs, srep)):
            ops.reset_counters()
            got = spec.run(rq)
            torch.cuda.synchronize()
            launches = served_launches()
            # the draft prefills every prompt whole (no prefix cache)
            n_chunks = sum(-(-len(r.tokens) // sc.prefill_chunk) for r in rq)
            rounds = got.decode_steps
            expect = {
                "fused_sliced_matmul": 168 * got.prefill_chunks_run + len(rq)
                + (168 * n_chunks if faithful_draft else 0)
                + rounds * (169 + (SPEC_K + 1) * 169 * faithful_draft),
                "paged_decode_attention": qcfg.n_layers * rounds * (SPEC_K + 2),
                "paged_chunk_attention": qcfg.n_layers * (got.prefill_chunks_run + n_chunks),
            }
            check_launches(f"serve_spec {draft} draft, {label}", launches, expect, got)
            check_bitwise(f"serve_spec {draft} draft, {label}, against the plain decoding",
                          got, base)
            acc = got.acceptance_rate
            print(f"serve_spec spec_k={SPEC_K}, {draft} draft, {label}: acceptance {acc:.4f} "
                  f"({got.tokens_accepted} of {got.tokens_drafted}), {rounds} rounds, "
                  f"{rate_line(got)}  [{card}]")
            if faithful_draft and acc != 1.0:
                raise AssertionError(f"a draft equal to the target accepted {acc}, not 1")
            if draft == "digital" and label == "greedy":
                device_busy(spec, reqs, got, card)
        del spec
        torch.cuda.empty_cache()


class StepClock:
    """A device clock that advances ``step`` seconds each time it is read
    (the loop reads it once at the start of a run and once an iteration)."""

    def __init__(self, step: float):
        self.step, self.t = step, 0.0

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def serve_drift(params, qcfg, sc, loop, reqs, rep, card):
    """A power-law drift (nu 0.05, t0 1 s) under a clock that advances 1 s
    an iteration, with a refresh every 6 s: at least one refresh under
    live traffic, K6 once a slice plane per refresh, requests admitted
    before a swap bit-equal to the same loop without refresh, the plain
    versions bit-equal, and with the drift model off the greedy serve
    phase's tokens and logits."""
    from repro_torch.core import DriftModel, MemPolicy
    from repro_torch.core.prng import PRNGKey, fold_in
    from repro_torch.kernels import ops
    from repro_torch.models import program_params
    from repro_torch.serve import ServeLoop

    pol = MemPolicy(default=sc.policy.default.replace(drift=DriftModel(nu=0.05, t0=1.0)),
                    overrides=sc.policy.overrides)
    dsc = sc.replace(policy=pol, refresh_every=6.0, clock=StepClock(1.0))
    drifting = ServeLoop(params, qcfg, dsc, programmed=loop.programmed)
    ops.reset_counters()
    drep = drifting.run(reqs)
    torch.cuda.synchronize()
    k6 = ops.COUNTERS["program_noise"].count
    launches = served_launches()
    check_finished(drep, "serve_drift")
    swaps = drep.reprogram_swaps
    per = K6_PER_PROGRAMMING(qcfg, pol)
    print(f"serve_drift: {swaps} refreshes under live traffic, {k6} K6 launches (expected "
          f"{per} per refresh), launches {launches}; {rate_line(drep)}  [{card}]")
    if swaps < 1 or k6 != per * swaps:
        raise AssertionError(f"serve_drift: {swaps} refreshes and {k6} K6 launches")
    t0 = time.monotonic()
    program_params(params, qcfg, pol, fold_in(PRNGKey(0), 1), t_prog=1.0)
    torch.cuda.synchronize()
    print(f"serve_drift: programming time per refresh {time.monotonic() - t0:.3f} s  [{card}]")
    # the same clock without refresh: every request admitted on generation
    # 0 in the refreshing run is bitwise the same there
    still = ServeLoop(params, qcfg, dsc.replace(refresh_every=None, clock=StepClock(1.0)),
                      programmed=loop.programmed).run(reqs)
    gen0 = [a.rid for a, b in zip(drep.results, still.results) if a.admit_time is not None
            and a.generation == 0]
    check_bitwise(f"serve_drift, requests {gen0} admitted on generation 0, against no refresh",
                  drep, still, rids=set(gen0))
    later = [a.rid for a in drep.results if a.generation > 0]
    print(f"serve_drift: requests {later} admitted on a later generation; no request changed "
          "generation mid-stream (a lane keeps its admission generation)")
    if not later:
        raise AssertionError("serve_drift: no request was admitted after a refresh")
    check_plain("serve_drift", params, qcfg, dsc, loop.programmed, reqs,
                clock=lambda: StepClock(1.0))
    off = ServeLoop(params, qcfg, sc.replace(clock=StepClock(1.0)),
                    programmed=loop.programmed).run(reqs)
    check_bitwise("serve_drift with the drift model off, against the serve phase", off, rep)
    aged = [a for a, b in zip(drep.results, rep.results) if a.tokens != b.tokens]
    print(f"serve_drift: {len(aged)} of {len(reqs)} requests emit other tokens than the fresh "
          "state's")


# ---------------------------------------------------------------------------
# phase 4c: the serve launcher (dense greedy_generate and the ServeLoop)
# ---------------------------------------------------------------------------

# launch/serve.py's defaults at qwen2-0.5b's full width, the main path
LAUNCH = ["--policy", "mem_faithful", "--batch", "4", "--prompt_len", "16", "--gen", "16"]
LONG_PROMPT = 1536  # a dense prefill through attention_chunked (past 1,024 keys)


def path_launches() -> dict:
    from repro_torch.kernels import ops

    return {name: ops.COUNTERS[name].count for name in
            ("fused_sliced_matmul", "paged_decode_attention", "paged_chunk_attention",
             "program_noise")}


def _need_launched(phase, launched, names):
    for name in names:
        if launched[name] <= 0:
            raise AssertionError(f"{phase}: {name} never launched ({launched})")


def dense_rate(params, qcfg, card):
    """The default mode's generation (``make_policy("mem_faithful")``,
    batch 4, prompt 16, 16 new tokens; the launcher's weights and
    prompts), timed on the host clock around work that ends in a
    synchronize: the prefill alone and the whole run, each the second of
    two; ITL = (whole - prefill) / 16."""
    from repro_torch.core.prng import PRNGKey, randint
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.models import program_params
    from repro_torch.serve import greedy_generate

    pol = make_policy("mem_faithful")
    prog = program_params(params, qcfg, pol, PRNGKey(0))
    prompts = randint(PRNGKey(1), (4, 16), 0, qcfg.vocab, device="cuda")

    def generate(n):
        return greedy_generate(params, qcfg, prompts, n, policy=pol,
                               compute_dtype=torch.float32, programmed=prog)

    times = {0: [], 16: []}
    for n in (0, 16, 0, 16, 0, 16):
        t0 = time.monotonic()
        generate(n)
        torch.cuda.synchronize()
        times[n].append(time.monotonic() - t0)
    pre, whole = times[0][1], times[16][1]
    itl = (whole - pre) / 16
    print(f"dense greedy_generate, qwen2-0.5b mem_faithful (dynamic ADC), batch 4: prefill of "
          f"64 rows {pre * 1e3:.1f} ms, 16 new tokens in {whole * 1e3:.1f} ms: "
          f"{4 * 16 / whole:.2f} tok/s, ITL {itl * 1e3:.1f} ms (the third run: "
          f"{(times[16][2] - times[0][2]) / 16 * 1e3:.1f} ms)  [{card}]")
    print_busy("the dense default mode (the prefill and 16 decode steps)",
               device_groups(lambda: generate(16)), whole * 1e3, card)


def launch(params, qcfg, card, counters):
    """``repro_torch.launch.serve.main`` at qwen2-0.5b's full width: the
    default mode (``greedy_generate``, K1 and K6 launched); the same at
    ``CUT_LAYERS`` layers with ``--kernels on`` and ``off`` (tokens and
    every logit row bit-equal) and with ``--per_call`` (bit-equal to the
    programmed run); ``--requests 8 --slots 4 --gen 8`` (K1, K2, K3
    launched, every request finished); one 1,536-token prompt under
    ``digital``, dense (``attention_chunked``) against the ``ServeLoop``
    (K2 / K3): equal tokens, first-token logits within max rel 1e-4."""
    from repro_torch.core.prng import PRNGKey, randint
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import Request, ServeConfig, ServeLoop

    ops.reset_counters()
    tokens = launcher.main(LAUNCH)
    torch.cuda.synchronize()
    launched = path_launches()
    expect_k1 = 169 * 17  # the prefill and 16 decode steps: 7 projections x 24 layers + the head
    expect_k6 = K6_PER_PROGRAMMING(qcfg, faithful_policy())
    print(f"launch default mode: launches {launched}; expected K1 {expect_k1}, K6 {expect_k6}")
    if (launched["fused_sliced_matmul"] != expect_k1 or launched["program_noise"] != expect_k6
            or launched["paged_decode_attention"] or launched["paged_chunk_attention"]):
        raise AssertionError(f"launch default mode: launches {launched}")
    if tokens.shape != (4, 17) or not bool(((tokens >= 0) & (tokens < qcfg.vocab)).all()):
        raise AssertionError(f"launch default mode: tokens {tokens}")
    for name, n in launched.items():
        counters[name] = counters.get(name, 0) + n
    dense_rate(params, qcfg, card)

    cut = LAUNCH + ["--layers", str(CUT_LAYERS)]
    ops.reset_counters()
    on = launcher.main(cut + ["--kernels", "on"], collect_logits=True)
    k1_on = ops.COUNTERS["fused_sliced_matmul"].count
    t0 = time.monotonic()
    off = launcher.main(cut + ["--kernels", "off"], collect_logits=True)
    torch.cuda.synchronize()
    t_off = time.monotonic() - t0
    if k1_on <= 0 or ops.COUNTERS["fused_sliced_matmul"].count != k1_on:
        raise AssertionError("launch: --kernels on launched no K1, or --kernels off launched one")
    per_call = launcher.main(cut + ["--per_call"], collect_logits=True)
    torch.cuda.synchronize()
    for label, other in (("--kernels off", off), ("--per_call", per_call)):
        if not (torch.equal(on[0], other[0]) and torch.equal(on[1], other[1])):
            raise AssertionError(f"launch at {CUT_LAYERS} layers: {label} differs from the "
                                 "programmed run with the kernels")
        print(f"launch at {CUT_LAYERS} layers: {label} gives the tokens and all "
              f"{on[1].shape[0] * on[1].shape[1]} logit rows of the programmed run with the "
              "kernels, bit for bit")
    print(f"launch at {CUT_LAYERS} layers with the plain versions: {t_off:.1f} s  [{card}]")

    ops.reset_counters()
    rep = launcher.main(["--policy", "mem_faithful", "--requests", "8", "--slots", "4",
                         "--gen", "8"])
    torch.cuda.synchronize()
    launched = path_launches()
    print(f"launch --requests 8 --slots 4: launches {launched}; {rate_line(rep)}  [{card}]")
    _need_launched("launch --requests", launched,
                   ("fused_sliced_matmul", "paged_decode_attention", "paged_chunk_attention"))
    for r in rep.results:
        if r.finish_reason != "length" or len(r.tokens) != 8:
            raise AssertionError(f"launch --requests: request {r.rid}: {r.finish_reason}")
    for name, n in launched.items():
        counters[name] = counters.get(name, 0) + n

    # one long prompt, digital: the dense path against the paged one
    n_new = 8
    t0 = time.monotonic()
    dense_tok, dense_logits = launcher.main(
        ["--policy", "digital", "--batch", "1", "--prompt_len", str(LONG_PROMPT),
         "--gen", str(n_new)], collect_logits=True)
    torch.cuda.synchronize()
    t_dense = time.monotonic() - t0
    prompt = randint(PRNGKey(1), (1, LONG_PROMPT), 0, qcfg.vocab).numpy()[0]
    loop = ServeLoop(params, qcfg, ServeConfig(
        slots=1, max_len=LONG_PROMPT + n_new + 1, prefill_chunk=32, block_size=16,
        compute_dtype=torch.float32, device="cuda", collect_logits=True))
    ops.reset_counters()
    t0 = time.monotonic()
    res = loop.run([Request(0, prompt, n_new + 1)]).results[0]
    torch.cuda.synchronize()
    t_paged = time.monotonic() - t0
    k2, k3 = ops.COUNTERS["paged_decode_attention"].count, ops.COUNTERS["paged_chunk_attention"].count
    first = torch.from_numpy(res.logits[0]).cuda()
    rel = rel_max(dense_logits[0, 0], first)
    print(f"long prompt ({LONG_PROMPT} tokens, {n_new} new, digital): dense greedy_generate "
          f"{t_dense:.2f} s, ServeLoop {t_paged:.2f} s ({k2} K2, {k3} K3 launches); tokens "
          f"{dense_tok[0].tolist()} vs {res.tokens}; first-token logits max rel {rel:.3e}  "
          f"[{card}]")
    if dense_tok[0].tolist() != res.tokens or not rel <= 1e-4 or k2 <= 0 or k3 <= 0:
        raise AssertionError("long prompt: the dense and the paged paths disagree")


def check_k1_long(timer, card):
    """K1 on one call of ``LONG_PROMPT`` rows at a ``mem_faithful`` q
    projection's shape (896 -> 896, ``dynamic`` ADC over 128-row tiles),
    bit-equal to its plain version; the kernel timed (CUDA events), the
    plain version once (host clock, synchronized)."""
    from repro_torch.core.dpe import prepare_weight
    from repro_torch.core.prng import PRNGKey
    from repro_torch.kernels import sliced_matmul as sm
    from repro_torch.launch.dryrun import make_policy

    cfg = make_policy("mem_faithful").default
    g = torch.Generator(device="cuda").manual_seed(15)
    pw = prepare_weight(torch.randn((896, 896), generator=g, device="cuda") * 896**-0.5, cfg,
                        PRNGKey(15))
    x = torch.randn((LONG_PROMPT, 896), generator=g, device="cuda")
    kw = _k1_kw(cfg)
    y = sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, **kw)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    yp = sm.fused_sliced_matmul_ref(x, pw.slices, pw.scale, **kw)
    torch.cuda.synchronize()
    t_plain = (time.monotonic() - t0) * 1e3
    if not bool(torch.isfinite(y).all()) or not torch.equal(y, yp):
        raise AssertionError(f"K1 at M={LONG_PROMPT}: max diff {float((y - yp).abs().max())} "
                             "to its plain version")
    t = timer(lambda: sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, **kw))
    _, kp, np_ = pw.slices.shape
    nbytes = 4 * (pw.slices.numel() + pw.scale.numel() + x.numel() + LONG_PROMPT * np_)
    flops = 2 * cfg.input_spec.n_slices * cfg.weight_spec.n_slices * LONG_PROMPT * kp * np_
    b, by = bound_ms(nbytes, flops)
    print(f"K1 at M={LONG_PROMPT} (q projection 896x896, dynamic ADC, 128-row tiles) bit-equal "
          f"to its plain version: kernel {t:.4f} ms, plain {t_plain:.1f} ms, bound {b:.4f} ms "
          f"({by}), {b / t:.1%} of it  [{card}]")
    return dict(ms=t, plain_ms=t_plain, bound_ms=b, bound_by=by)


# ---------------------------------------------------------------------------
# phase 4d: rwkv6-1.6b (the RWKV6 ssm family) through the dense greedy path
# ---------------------------------------------------------------------------

RWKV_LAUNCH = ["--arch", "rwkv6-1.6b", "--policy", "mem_faithful", "--batch", "4",
               "--prompt_len", "16", "--gen", "16"]
RWKV_K1_STEP = 8 * 24 + 1  # r, k, v, g, o and the MLP's wi, wg, wo in 24 layers + the head
RWKV_PROMPT = 100  # a digital prefill through the chunked WKV form: 4 chunks, the last padded
RWKV_LONG = 4096  # one long prompt: the O(1) recurrent state at 4,096 tokens
RWKV_LONG_NEW = 4  # decode steps after a prefill (greedy_generate's n_steps)
RWKV_PROFILED = 4  # decode steps of the profiled generation (the idle share, K1 a step)


def rwkv6(card, counters):
    """rwkv6-1.6b at its published widths and depth through
    ``repro_torch.launch.serve`` and the dense ``greedy_generate``: the
    launcher's default mode (``make_policy("mem_faithful")``, batch 4,
    prompt 16, 16 new; K1 and K6 by the formula, no K2 / K3) with its
    programming, prefill, ITL and idle share; the same at ``CUT_LAYERS``
    layers with ``--kernels on`` and ``off`` and with ``--per_call``
    (tokens and every logit row bit-equal); a ``RWKV_PROMPT``-token
    prompt under ``digital`` (the chunked WKV form) against the same
    prompt fed token by token through ``decode_step`` (the scan): equal
    tokens, first-token logits within max rel 1e-4; one ``RWKV_LONG``-
    token prompt under ``mem_faithful`` (its prefill ms, ITL, peak memory
    and K1 launches); and rwkv6-smoke on the card against the CPU (the
    initial weights bit for bit, digital and faithful tokens equal)."""
    from repro_torch.configs import get, get_smoke
    from repro_torch.core.prng import PRNGKey, randint
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.models import (
        decode_step, init_cache, init_params, program_params, programmed_byte_size)
    from repro_torch.models.common import tree_leaves
    from repro_torch.serve import greedy_generate
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    cfg = get("rwkv6-1.6b")
    scfg = get_smoke("rwkv6-1.6b")
    a, b = (tree_leaves(init_params(scfg, 0, device=d)) for d in ("cuda", "cpu"))
    if len(a) != len(b) or not all(torch.equal(x.cpu(), y) for x, y in zip(a, b)):
        raise AssertionError("init_params(rwkv6-smoke): the card's draw differs from the CPU's")
    for pol in ("digital", "mem_faithful"):
        args = ["--arch", "rwkv6-1.6b", "--smoke", "--policy", pol, "--batch", "2",
                "--prompt_len", "8", "--gen", "4"]
        on_card, on_cpu = launcher.main(args), launcher.main(args + ["--device", "cpu"])
        if not torch.equal(on_card.cpu(), on_cpu):
            raise AssertionError(f"rwkv6-smoke {pol}: the card's tokens {on_card.tolist()} "
                                 f"differ from the CPU's {on_cpu.tolist()}")
    print(f"rwkv6-smoke on the card: initial weights bit-equal to the CPU's; digital and "
          f"mem_faithful launcher tokens equal to the CPU's  [{card}]")

    # the launcher's default mode at full width and depth
    ops.reset_counters()
    tokens = launcher.main(RWKV_LAUNCH)
    torch.cuda.synchronize()
    launched = path_launches()
    expect_k1 = RWKV_K1_STEP * 17  # the prefill and 16 decode steps
    expect_k6 = RWKV_K1_STEP * make_policy("mem_faithful").default.weight_spec.n_slices
    print(f"rwkv6 launch default mode: launches {launched}; expected K1 {expect_k1}, "
          f"K6 {expect_k6}")
    if (launched["fused_sliced_matmul"] != expect_k1 or launched["program_noise"] != expect_k6
            or launched["paged_decode_attention"] or launched["paged_chunk_attention"]):
        raise AssertionError(f"rwkv6 launch default mode: launches {launched}")
    if tokens.shape != (4, 17) or not bool(((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"rwkv6 launch default mode: tokens {tokens}")
    for name, n in launched.items():
        counters[name] = counters.get(name, 0) + n
    del tokens
    torch.cuda.empty_cache()

    # the same generation, timed (the launcher's run warmed it up): the
    # programming, the prefill alone, the prefill with RWKV_PROFILED and
    # with 16 decode steps; then the first two profiled
    t0 = time.monotonic()
    params = init_params(cfg, PRNGKey(0), device="cuda")
    torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    pol = make_policy("mem_faithful")
    t0 = time.monotonic()
    prog = program_params(params, cfg, pol, PRNGKey(0))
    torch.cuda.synchronize()
    t_prog = time.monotonic() - t0
    print(f"rwkv6-1.6b: init params {t_init:.2f} s; programmed "
          f"{programmed_byte_size(prog) / 1e6:.1f} MB of crossbar state in {t_prog:.2f} s  "
          f"[{card}]")
    prompts = randint(PRNGKey(1), (4, 16), 0, cfg.vocab, device="cuda")

    def generate(n):
        return greedy_generate(params, cfg, prompts, n, policy=pol,
                               compute_dtype=torch.float32, programmed=prog)

    wall = {}
    for n in (0, RWKV_PROFILED, 16):
        t0 = time.monotonic()
        generate(n)
        torch.cuda.synchronize()
        wall[n] = time.monotonic() - t0
    pre, whole = wall[0], wall[16]
    print(f"rwkv6 dense greedy_generate, mem_faithful (dynamic ADC), batch 4: prefill of 64 "
          f"rows {pre * 1e3:.1f} ms, 16 new tokens in {whole * 1e3:.1f} ms: "
          f"{4 * 16 / whole:.2f} tok/s, ITL {(whole - pre) / 16 * 1e3:.1f} ms  [{card}]")
    g_pre = device_groups(lambda: generate(0))
    g_all = device_groups(lambda: generate(RWKV_PROFILED))
    print_busy(f"rwkv6's default mode (the prefill and {RWKV_PROFILED} decode steps)", g_all,
               wall[RWKV_PROFILED] * 1e3, card, k1_calls=RWKV_K1_STEP * (RWKV_PROFILED + 1))
    if g_pre and g_all:
        def k1_other(g):
            return (g.get("K1", (0.0, 0))[0],
                    sum(n for k, (_, n) in g.items() if k.startswith("other")))

        (k1_p, n_p), (k1_a, n_a) = k1_other(g_pre), k1_other(g_all)
        print(f"  the prefill: K1 {k1_p:.3f} ms device, {n_p} other launches; a decode step: "
              f"K1 {(k1_a - k1_p) / RWKV_PROFILED:.3f} ms device, "
              f"{(n_a - n_p) / RWKV_PROFILED:.0f} other launches  [{card}]")

    # one long prompt: the prefill, then RWKV_LONG_NEW decode steps
    long_prompt = randint(PRNGKey(1), (1, RWKV_LONG), 0, cfg.vocab, device="cuda")
    prefill = make_prefill_step(cfg, pol, compute_dtype=torch.float32,
                                cache_dtype=torch.float32)
    decode = make_decode_step(cfg, pol, compute_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counters()
    t0 = time.monotonic()
    logits, cache = prefill(params, {"tokens": long_prompt}, prog)
    torch.cuda.synchronize()
    t_pre = time.monotonic() - t0
    out = [torch.argmax(logits, dim=-1)]
    t0 = time.monotonic()
    for _ in range(RWKV_LONG_NEW):
        logits, cache = decode(params, cache, out[-1], prog)
        out.append(torch.argmax(logits, dim=-1))
    torch.cuda.synchronize()
    itl = (time.monotonic() - t0) / RWKV_LONG_NEW
    k1 = ops.COUNTERS["fused_sliced_matmul"].count
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"rwkv6 long prompt ({RWKV_LONG} tokens, batch 1, mem_faithful, {RWKV_LONG_NEW} new): "
          f"prefill {t_pre * 1e3:.1f} ms, ITL {itl * 1e3:.1f} ms, peak device memory "
          f"{peak:.2f} GiB, K1 {k1} launches (expected {RWKV_K1_STEP * (RWKV_LONG_NEW + 1)}), "
          f"tokens {torch.stack(out, 1)[0].tolist()}  [{card}]")
    if k1 != RWKV_K1_STEP * (RWKV_LONG_NEW + 1) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("rwkv6 long prompt: K1 launches or non-finite logits")
    counters["fused_sliced_matmul"] += k1
    del prog, cache, logits
    torch.cuda.empty_cache()

    # a digital prompt through the chunked form against token-by-token decoding
    prompt = randint(PRNGKey(2), (1, RWKV_PROMPT), 0, cfg.vocab, device="cuda")
    t0 = time.monotonic()
    dense_tok, dense_logits = greedy_generate(params, cfg, prompt, RWKV_LONG_NEW,
                                              compute_dtype=torch.float32, collect_logits=True)
    torch.cuda.synchronize()
    t_chunked = time.monotonic() - t0
    cache = init_cache(cfg, 1, 1, dtype=torch.float32, device="cuda")
    t0 = time.monotonic()
    for i in range(RWKV_PROMPT):
        step, cache = decode_step(params, cfg, cache, prompt[:, i], compute_dtype=torch.float32)
    first, out = step, [torch.argmax(step, dim=-1)]
    for _ in range(RWKV_LONG_NEW):
        step, cache = decode_step(params, cfg, cache, out[-1], compute_dtype=torch.float32)
        out.append(torch.argmax(step, dim=-1))
    torch.cuda.synchronize()
    t_scan = time.monotonic() - t0
    scan_tok = torch.stack(out, 1).to(torch.int32)
    rel = rel_max(dense_logits[0, 0], first[0])
    print(f"rwkv6 {RWKV_PROMPT}-token prompt, digital, {RWKV_LONG_NEW} new: chunked prefill "
          f"{t_chunked:.2f} s, token by token {t_scan:.2f} s; tokens {dense_tok[0].tolist()} vs "
          f"{scan_tok[0].tolist()}; first-token logits max rel {rel:.3e}  [{card}]")
    if not torch.equal(dense_tok, scan_tok) or not rel <= 1e-4:
        raise AssertionError("rwkv6: the chunked prefill and token-by-token decoding disagree")
    del params, cache
    torch.cuda.empty_cache()

    # kernels against their plain versions, per-call against programmed:
    # the default mode at CUT_LAYERS layers (full width, the head included)
    cut = RWKV_LAUNCH + ["--layers", str(CUT_LAYERS)]
    ops.reset_counters()
    on = launcher.main(cut + ["--kernels", "on"], collect_logits=True)
    k1_on = ops.COUNTERS["fused_sliced_matmul"].count
    t0 = time.monotonic()
    off = launcher.main(cut + ["--kernels", "off"], collect_logits=True)
    torch.cuda.synchronize()
    t_off = time.monotonic() - t0
    if (k1_on != (8 * CUT_LAYERS + 1) * 17
            or ops.COUNTERS["fused_sliced_matmul"].count != k1_on):
        raise AssertionError("rwkv6: --kernels on launched other than the formula's K1, or "
                             "--kernels off launched one")
    per_call = launcher.main(cut + ["--per_call"], collect_logits=True)
    torch.cuda.synchronize()
    for label, other in (("--kernels off", off), ("--per_call", per_call)):
        if not (torch.equal(on[0], other[0]) and torch.equal(on[1], other[1])):
            raise AssertionError(f"rwkv6 at {CUT_LAYERS} layers: {label} differs from the "
                                 "programmed run with the kernels")
        print(f"rwkv6 at {CUT_LAYERS} layers: {label} gives the tokens and all "
              f"{on[1].shape[0] * on[1].shape[1]} logit rows of the programmed run with the "
              "kernels, bit for bit")
    print(f"rwkv6 at {CUT_LAYERS} layers with the plain versions: {t_off:.1f} s  [{card}]")


def check_circuit(card):
    """The circuit backend on the card (``DPEConfig(backend="circuit")``,
    M 4, K = N = 64, 32x32 arrays, noise keyed) against the same call on
    the CPU: rel-Fro <= 1e-6; its wall time and device launches."""
    from repro_torch.core import DPEConfig, dpe_matmul
    from repro_torch.core.prng import PRNGKey

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, 64)) * 0.1).astype(np.float32))
    cfg = DPEConfig(array_size=(32, 32), backend="circuit")
    want = dpe_matmul(x, w, cfg, PRNGKey(1))
    xc, wc = x.cuda(), w.cuda()
    dpe_matmul(xc, wc, cfg, PRNGKey(1))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = dpe_matmul(xc, wc, cfg, PRNGKey(1))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    groups = device_groups(lambda: dpe_matmul(xc, wc, cfg, PRNGKey(1)))
    launches = sum(n for _, n in groups.values())
    busy = sum(ms for ms, _ in groups.values())
    err = rel_fro(got.cpu(), want)
    print(f"circuit dpe_matmul (M 4, K = N = 64, 32x32 arrays, 20 sweeps): card vs CPU rel-Fro "
          f"{err:.3e}; {wall * 1e3:.1f} ms wall, {launches} device launches, {busy:.1f} ms "
          f"device busy  [{card}]")
    if not bool(torch.isfinite(got).all()) or not err <= 1e-6:
        raise AssertionError(f"circuit backend: the card differs from the CPU by {err}")


# ---------------------------------------------------------------------------
# phase 3b: K1 at every crossbar tile and preset; the paper's default DPE
# ---------------------------------------------------------------------------

ADC_MODES = ("dynamic", "dynamic_row", "fullscale")


def _k1_kw(cfg, bm=128):
    return dict(input_spec=cfg.input_spec, weight_spec=cfg.weight_spec,
                array_size=cfg.array_size, rdac=cfg.rdac, radc=cfg.radc,
                adc_mode=cfg.adc_mode, bm=bm)


def _k1_bitwise(label, x, pw, cfg) -> float:
    """K1 against its plain version on the same operands: bit-equal."""
    from repro_torch.kernels import sliced_matmul as sm

    y = sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, **_k1_kw(cfg))
    yp = sm.fused_sliced_matmul_ref(x, pw.slices, pw.scale, **_k1_kw(cfg))
    torch.cuda.synchronize()
    if not bool(torch.isfinite(y).all()):
        raise AssertionError(f"K1 {label}: non-finite output")
    err = float((y - yp).abs().max())
    if not torch.equal(y, yp):
        raise AssertionError(f"K1 {label}: differs from its plain version by {err}")
    return err


def _k1_time(timer, label, x, pw, cfg, card):
    from repro_torch.kernels import sliced_matmul as sm

    kw = _k1_kw(cfg)
    t = timer(lambda: sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, **kw))
    tp = timer(lambda: sm.fused_sliced_matmul_ref(x, pw.slices, pw.scale, **kw), iters=2)
    m = x.shape[0]
    _, kp, np_ = pw.slices.shape
    nbytes = 4 * (pw.slices.numel() + pw.scale.numel() + x.numel() + m * np_)
    flops = 2 * cfg.input_spec.n_slices * cfg.weight_spec.n_slices * m * kp * np_
    b, by = bound_ms(nbytes, flops)
    print(f"K1 time {label}: kernel {t:.4f} ms  plain {tp:.4f} ms  bound {b:.5f} ms ({by})  [{card}]")
    return dict(label=label, ms=t, plain_ms=tp, bound_ms=b, bound_by=by)


def check_k1_tiles(timer, summary, card):
    from repro_torch.core import DPEConfig, dpe_matmul, relative_error, spec
    from repro_torch.core.dpe import prepare_weight
    from repro_torch.core.prng import PRNGKey, normal
    from repro_torch.kernels import sliced_matmul as sm

    worst, n = 0.0, 0
    for tile in (32, 64, 128):
        w = normal(PRNGKey(tile), (300, 200), "cuda") * 300**-0.5
        for noise in ("off", "program"):
            for adc in ADC_MODES:
                cfg = DPEConfig(array_size=(tile, tile), adc_mode=adc, noise_mode=noise)
                pw = prepare_weight(w, cfg, PRNGKey(1))
                for m in (1, 130):
                    x = normal(PRNGKey(m), (m, 300), "cuda")
                    worst = max(worst, _k1_bitwise(f"{tile}x{tile} {adc} noise={noise} M={m}",
                                                   x, pw, cfg))
                    n += 1
    print(f"K1 bit-equal to its plain version at 32x32, 64x64 and 128x128 tiles, all ADC "
          f"modes, noise off and on, M = 1 and 130 ({n} checks)")
    n = 0
    for names in (("fp32", "fp32"), ("flex16_5", "flex16_5"), ("int8", "int4"), ("bf16", "bf16")):
        cfg = DPEConfig(input_spec=spec(names[0]), weight_spec=spec(names[1]))
        pw = prepare_weight(normal(PRNGKey(5), (130, 70), "cuda"), cfg, PRNGKey(6))
        for m in (1, 128):
            x = normal(PRNGKey(7 + m), (m, 130), "cuda")
            worst = max(worst, _k1_bitwise(f"{names[0]} x {names[1]} M={m}", x, pw, cfg))
            n += 1
    print(f"K1 bit-equal to its plain version for fp32, flex16_5, int8 x int4 and bf16 at "
          f"M = 1 and 128 ({n} checks)")

    # the paper's default engine: DPEConfig() is Table 2 (int8, 64x64, dynamic)
    cfg = DPEConfig()
    x = normal(PRNGKey(0), (128, 128), "cuda")
    w = normal(PRNGKey(1), (128, 128), "cuda")
    before = sm.counter.count
    y = dpe_matmul(x, w, cfg, PRNGKey(2))
    launched = sm.counter.count - before
    yp = dpe_matmul(x, w, cfg, PRNGKey(2), kernels=False)
    torch.cuda.synchronize()
    if launched != 1 or not torch.equal(y, yp):
        raise AssertionError(f"dpe_matmul(x, w, DPEConfig()): {launched} K1 launches, "
                             f"max diff to plain {float((y - yp).abs().max())}")
    print(f"dpe_matmul(x, w, DPEConfig()) on the card: K1 at 64x64 tiles, bit-equal to the "
          f"plain version, RE vs x @ w {float(relative_error(y, x @ w)):.6e}")

    rows = []
    for label, names, tile, m, k in (("int8 64x64 M=128 K=N=128 (matmul_re)", "int8", 64, 128, 128),
                                     ("fp32 64x64 M=128 K=N=128 (matmul_re)", "fp32", 64, 128, 128),
                                     ("fp32 32x32 M=1 K=N=8 (linsolve)", "fp32", 32, 1, 8)):
        cfg = DPEConfig(input_spec=spec(names), weight_spec=spec(names), array_size=(tile, tile))
        pw = prepare_weight(normal(PRNGKey(3), (k, k), "cuda"), cfg, PRNGKey(4))
        rows.append(_k1_time(timer, label, normal(PRNGKey(8), (m, k), "cuda"), pw, cfg, card))
    summary["fused_sliced_matmul"]["max_abs_err"] = max(
        summary["fused_sliced_matmul"]["max_abs_err"], worst)
    summary["k1_tiles"] = rows


# ---------------------------------------------------------------------------
# phase 3c: K4, the staged engine, at the paper's Table 2 shape
# ---------------------------------------------------------------------------

def check_k4(timer, summary, card):
    """``prepare_input`` then ``ops.sliced_matmul`` at (M, K, N) = (128,
    1024, 1024), int8, Table 2 hardware (64x64 arrays, radc 1024, var
    0.05), the data of ``benchmarks/run.py``'s DPE section."""
    from repro_torch.core import INT8, DPEConfig, relative_error
    from repro_torch.core.dpe import prepare_input, prepare_weight
    from repro_torch.core.prng import PRNGKey, normal
    from repro_torch.kernels import ops
    from repro_torch.kernels import sliced_matmul as sm

    m, k, n = 128, 1024, 1024
    cfg = DPEConfig(input_spec=INT8, weight_spec=INT8)
    x = normal(PRNGKey(0), (m, k), "cuda")
    w = normal(PRNGKey(1), (k, n), "cuda")
    pw = prepare_weight(w, cfg, PRNGKey(2))
    ideal = x @ w
    worst = 0.0
    for bm in (64, 128):
        for adc in ADC_MODES:
            kw = dict(input_spec=INT8, weight_spec=INT8, array_size=cfg.array_size,
                      radc=cfg.radc, adc_mode=adc, bm=bm)
            xs, sx = prepare_input(x, cfg)
            y4 = ops.sliced_matmul(xs, sx, pw.slices, pw.scale, **kw)
            yp = ops.sliced_matmul(xs, sx, pw.slices, pw.scale, kernels=False, **kw)
            y1 = ops.fused_sliced_matmul(x, pw.slices, pw.scale, rdac=cfg.rdac, **kw)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(y4).all()):
                raise AssertionError(f"K4 bm={bm} {adc}: non-finite output")
            err = float((y4 - yp).abs().max())
            worst = max(worst, err)
            if not torch.equal(y4, yp):
                raise AssertionError(f"K4 bm={bm} {adc}: differs from its plain version by {err}")
            ulp = float(yp.abs().max()) * 2.0**-23
            d = float((y4 - y1).abs().max())
            print(f"K4 bm={bm:3d} {adc:11s}: bit-equal to plain; vs K1 max diff {d / ulp:.2f} ulp "
                  f"of max|y| (bitwise {torch.equal(y4, y1)}); RE vs x @ w "
                  f"{float(relative_error(y4, ideal)):.6e}")
            if d > 8 * ulp:
                raise AssertionError(f"K4 bm={bm} {adc}: {d / ulp:.1f} ulp from K1")
    # the main path of the staged engine: benchmarks/run.py's Pallas row
    kw = dict(input_spec=INT8, weight_spec=INT8, array_size=cfg.array_size, radc=cfg.radc,
              adc_mode="dynamic", bm=64)
    ops.reset_counters()
    xs, sx = prepare_input(x, cfg)
    y = ops.sliced_matmul(xs, sx, pw.slices, pw.scale, **kw)
    torch.cuda.synchronize()
    launches = ops.COUNTERS["sliced_matmul"].count
    if launches <= 0:
        raise AssertionError("K4 was not launched on the staged path")
    re = float(relative_error(y, ideal))
    with open(os.path.join(HERE, "BENCH_dpe.json")) as fh:
        re_ref = json.load(fh)["engines"]["pallas_interpret"]["rel_err_vs_fp32"]
    gap = abs(re - re_ref) / re_ref
    print(f"staged engine (Table 2, bm 64, dynamic): RE vs x @ w {re:.8f}; the reference's "
          f"Pallas kernel in BENCH_dpe.json {re_ref:.8f} (rel {gap:.2e})")
    if not gap <= 1e-3:
        raise AssertionError(f"staged engine RE {re} vs the reference's {re_ref}")
    t = timer(lambda: sm.staged_sliced_matmul_cuda(xs, sx, pw.slices, pw.scale, **kw))
    tp = timer(lambda: ops.sliced_matmul(xs, sx, pw.slices, pw.scale, kernels=False, **kw),
               iters=2)
    nbytes = 4 * (xs.numel() + sx.numel() + pw.slices.numel() + pw.scale.numel() + m * n)
    flops = 2 * 16 * m * xs.shape[2] * pw.slices.shape[2]
    b, by = bound_ms(nbytes, flops)
    print(f"K4 time (Table 2, bm 64, dynamic): kernel {t:.4f} ms  plain {tp:.4f} ms  "
          f"bound {b:.4f} ms ({by}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)  [{card}]")
    summary["sliced_matmul"] = dict(max_abs_err=worst, ms=t, plain_ms=tp, bound_ms=b,
                                    bound_by=by, library_ms=None, launches=launches)


# ---------------------------------------------------------------------------
# phase 3d: K5, flash attention
# ---------------------------------------------------------------------------

def check_k5(timer, qcfg, summary, card):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    worst_bf16 = [0.0]  # rel-Fro
    n = 0

    def hold(label, q, k, v, causal, window, **tiles):
        y = fa.flash_attention_cuda(q, k, v, causal=causal, window=window, **tiles)
        yp = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if y.dtype != q.dtype or not bool(torch.isfinite(y.float()).all()):
            raise AssertionError(f"K5 {label}: dtype {y.dtype} or non-finite output")
        err = float((y.float() - yp.float()).abs().max())
        if q.dtype == torch.float32:
            ok = err <= 2e-5
        else:
            worst_bf16[0] = max(worst_bf16[0], rel_fro(y, yp))
            ok = rel_fro(y, yp) < 2e-2
        if not ok:
            raise AssertionError(f"K5 {label}: max abs err {err}, rel-Fro {rel_fro(y, yp)}")
        return err

    # the shapes of tests/test_flash_kernel.py (b, h, kv heads, Sq, Skv, dh)
    for b, h, _, sq, skv, dh in ((1, 2, 2, 128, 128, 32), (2, 4, 2, 256, 256, 64),
                                 (1, 2, 2, 200, 200, 32), (1, 2, 1, 128, 256, 32)):
        for causal in (True, False):
            if causal and sq != skv:
                continue
            for window in (0, 64):
                for dtype in (torch.float32, torch.bfloat16):
                    q = torch.randn((b * h, sq, dh), generator=g, device="cuda").to(dtype)
                    k = torch.randn((b * h, skv, dh), generator=g, device="cuda").to(dtype)
                    v = torch.randn((b * h, skv, dh), generator=g, device="cuda").to(dtype)
                    err = hold(f"{(b, h, sq, skv, dh)} causal={causal} window={window} {dtype}",
                               q, k, v, causal, window, bq=64, bk=64)
                    if dtype == torch.float32:
                        worst = max(worst, err)
                    n += 1
    print(f"K5 within 2e-5 (f32) / rel-Fro 2e-2 (bf16) of its plain version at the reference "
          f"test's shapes, causal and not, window 0 and 64 ({n} checks)")
    # qwen2-0.5b width: 14 heads, head_dim 64, one 1024-token sequence, causal
    bh, s, dh = qcfg.n_heads, 1024, qcfg.head_dim
    q, k, v = (torch.randn((bh, s, dh), generator=g, device="cuda") for _ in range(3))
    for dtype in (torch.float32, torch.bfloat16):
        err = hold(f"qwen2-0.5b width {dtype}", q.to(dtype), k.to(dtype), v.to(dtype), True, 0)
        if dtype == torch.float32:
            worst = max(worst, err)
    ops.reset_counters()
    y = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = ops.COUNTERS["flash_attention"].count
    if launches <= 0 or tuple(y.shape) != (bh, s, dh):
        raise AssertionError(f"K5: {launches} launches, output {tuple(y.shape)}")
    t = timer(lambda: fa.flash_attention_cuda(q, k, v, causal=True), iters=10)
    tp = timer(lambda: fa.flash_attention_ref(q, k, v, causal=True), iters=10)
    tl = timer(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], is_causal=True),
               iters=10)
    # without the mask: twice the work, and each block walks all 16 key
    # tiles, as the heaviest causal block does
    tn = timer(lambda: fa.flash_attention_cuda(q, k, v, causal=False), iters=10)
    qb, kb, vb = (a.to(torch.bfloat16) for a in (q, k, v))
    tb = timer(lambda: fa.flash_attention_cuda(qb, kb, vb, causal=True), iters=10)
    tlb = timer(lambda: F.scaled_dot_product_attention(qb[None], kb[None], vb[None],
                                                       is_causal=True), iters=10)
    pairs = s * (s + 1) // 2
    flops = 4 * dh * pairs * bh  # q.k and p.v, half each
    nbytes = 4 * 4 * bh * s * dh
    # float32: 3xTF32, three tensor-core products for each of q.k and p.v
    b, by = bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)
    # bf16: q.k one bf16 product, p.v two TF32 products (p hi and lo)
    bb = max(nbytes / 2 / HBM_BYTES_PER_S,
             flops / 2 / BF16_FLOP_PER_S + flops / TF32_FLOP_PER_S) * 1e3
    print(f"K5 errors against the plain version: f32 max abs {worst:.2e} (limit 2e-5), bf16 "
          f"rel-Fro {worst_bf16[0]:.2e} (limit 2e-2), over {n + 2} checks")
    print(f"K5 time (qwen2-0.5b width: {bh} heads, head_dim {dh}, S={s}, causal, f32): kernel "
          f"{t:.4f} ms  plain {tp:.4f} ms  SDPA {tl:.4f} ms  bound {b:.4f} ms ({by}, 3 x "
          f"{flops / 1e9:.2f} GFLOP at the TF32 rate, {nbytes / 1e6:.1f} MB)  [{card}]")
    print(f"K5 time (same, bf16): kernel {tb:.4f} ms  SDPA {tlb:.4f} ms  bound {bb:.4f} ms "
          f"(operations)  [{card}]")
    print(f"K5 time (same, f32, not causal): kernel {tn:.4f} ms  [{card}]")
    summary["flash_attention"] = dict(max_abs_err=worst, ms=t, plain_ms=tp, bound_ms=b,
                                      bound_by=by, library_ms=tl, launches=launches)


# ---------------------------------------------------------------------------
# phase 3e: K6, programming noise
# ---------------------------------------------------------------------------

# K6's work per cell, counted from csrc/program_noise.cu as the sm_90
# instructions each operation needs: one per add, multiply, fused
# multiply-add, compare, min / max, select, shift, rotate (a funnel
# shift) or logic op; an IEEE division a reciprocal, five FFMA and a
# check; a square root a reciprocal root and four FFMA.  Key arithmetic
# that is the same for every cell, loop and address arithmetic and
# branches are not counted.  Per stage (FP32 pipe: FFMA / FADD / FMUL;
# ALU: integer, logic, shifts, float compares, min / max, selects; XU:
# MUFU, conversions, the division's check; load / store), with the
# branch stages weighted by the share of this run's cells that take them.
K6_CELL = {
    "threefry2x32": (0, 73, 0, 0),  # counter words in 2, 20 x (add, rotate, xor), 10 key adds, xor
    "uniform": (2, 3, 0, 0),  # shift, or, 1 - f, fma, max
    "erf_inv, w < 5": (11, 2, 0, 0),  # -u*u, 2 compares, w - 2.5, 8 fma, * u
    "log1p, |y| < 0.4146": (22, 0, 2, 0),  # 2 x 6 fma, division, 5
    "log1p, else": (20, 6, 1, 0),  # y + 1, then log
    "erf_inv, w >= 5": (4, 0, 1, 0),  # the square root, beyond the w < 5 side
    "g, log, mu": (22, 7, 1, 1),  # load, v * dg + lgs, max, log (19 FP32, 6 ALU, I2F), - s2/2
    "exp, out": (21, 6, 4, 1),  # sqrt(2) * e, sigma * z + mu, exp (12 FP32, 6 ALU, FRND, F2I),
    #                              gp - lgs, division, store
}
# thread-instructions per SM per cycle on sm_90 (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0)
K6_PIPE_RATE = (128, 64, 16, 32)
ISSUE_PER_SM = 128  # four schedulers, one warp-instruction each a cycle


def k6_cell_ops(f_log: float, f_tail: float):
    """Instructions per cell by pipe, the branches weighted by ``f_log``
    (cells with |u*u| >= 0.4146, whose log1p takes the log) and
    ``f_tail`` (cells with w >= 5, erf_inv's tail)."""
    weight = {"log1p, |y| < 0.4146": 1.0 - f_log, "log1p, else": f_log,
              "erf_inv, w >= 5": f_tail}
    return [sum(weight.get(k, 1.0) * v[i] for k, v in K6_CELL.items()) for i in range(4)]


def k6_branch_shares(key, shape):
    """The shares of this run's cells that take log1p's log side and
    erf_inv's tail, from the uniforms the kernel draws for ``key``."""
    from repro_torch.core import prng, xmath
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = prng.uniform(key, shape, lo, 1.0, device="cuda").flatten()
    y = u * -u
    far = y[y.abs() >= float.fromhex("0x1.a8279ap-2")]
    w = -xmath.log1p(far[far < -0.9])  # w >= 5 needs |y| > 0.993
    n = u.numel()
    return far.numel() / n, int((w >= 5.0).sum()) / n


def check_k6(timer, qcfg, summary, card):
    """K6 bit for bit against its plain version on one slice plane of
    each served weight shape, for each slice width of INT8 (1, 1, 2, 4
    bits); timed on the vocab head's plane (136 M cells)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import k6_sass

    from repro_torch.core.prng import PRNGKey
    from repro_torch.kernels import program_noise as pn

    d, f, v = qcfg.d_model, qcfg.d_ff, qcfg.vocab
    nh, nkv, hd = qcfg.n_heads, qcfg.n_kv_heads, qcfg.head_dim
    pad = lambda n: -(-n // 128) * 128  # noqa: E731  (whole 128x128 tiles)
    shapes = {"q/o": (d, nh * hd), "k/v": (d, pad(nkv * hd)), "wi/wg": (d, pad(f)),
              "wo": (pad(f), d), "lm_head": (d, pad(v))}
    g = torch.Generator(device="cuda").manual_seed(6)
    kw = dict(hgs=1e-5, lgs=1e-7, cv=0.05)
    n, worst = 0, 0.0
    for label, (k, nn) in shapes.items():
        for bits in (1, 2, 4):
            cells = torch.randint(0, 2**bits, (k, nn), generator=g, device="cuda").float()
            key = PRNGKey(100 * bits + n)
            y = pn.program_noise_cuda(key, cells, bits, **kw)
            yp = pn.program_noise_ref(key, cells, bits, **kw)
            torch.cuda.synchronize()
            worst = max(worst, float((y - yp).abs().max()))
            if not bool(torch.isfinite(y).all()) or not torch.equal(y, yp):
                raise AssertionError(f"K6 {label} {bits}-bit: differs from its plain version "
                                     f"by {float((y - yp).abs().max())}")
            n += 1
            del yp
        if label != "lm_head":
            del cells
            torch.cuda.empty_cache()
    print(f"K6 bit-equal to its plain version on a slice plane of every served weight shape, "
          f"1-, 2- and 4-bit slices ({n} checks)")
    key = PRNGKey(7)
    t = timer(lambda: pn.program_noise_cuda(key, cells, 4, **kw), iters=5)
    tp = timer(lambda: pn.program_noise_ref(key, cells, 4, **kw), iters=2)
    # the bound: the bytes, or the operations a cell needs at each pipe's
    # rate, whichever pipe (or the issue of all of them) takes longest
    nbytes = 8 * cells.numel()
    f_log, f_tail = k6_branch_shares(key, cells.shape)
    ops_ = k6_cell_ops(f_log, f_tail)
    cyc = max([sum(ops_) / ISSUE_PER_SM] + [n / r for n, r in zip(ops_, K6_PIPE_RATE)])
    clk = k6_sass.max_sm_clock_mhz()
    t_ops = cells.numel() * cyc / (k6_sass.SMS * clk * 1e6) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b, by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    sass = k6_sass.k6_count()
    print(f"K6 work per cell: {sum(ops_):.2f} instructions (FP32 {ops_[0]:.2f}, ALU "
          f"{ops_[1]:.2f}, XU {ops_[2]:.2f}, load / store {ops_[3]:.2f}; log1p's log side "
          f"{f_log:.4f} of cells, erf_inv's tail {f_tail:.6f}): {cyc:.3f} SM cycles a cell "
          f"(issue {sum(ops_) / ISSUE_PER_SM:.3f}, ALU at half rate {ops_[1] / 64:.3f}); SM "
          f"clock {clk:.0f} MHz.  The compiled loop body: {sass['total']} SASS instructions "
          f"(FP32 pipe {sass['fp32']}, integer {sass['integer']}, rest {sass['rest']}), "
          f"{k6_sass.bound_ms(sass, cells.numel(), clk):.4f} ms at the issue rate")
    print(f"K6 time (the vocab head's slice plane, {cells.numel() / 1e6:.1f} M cells): kernel "
          f"{t:.4f} ms  plain {tp:.4f} ms  bound {b:.4f} ms ({by}; operations {t_ops:.4f} ms, "
          f"bytes {nbytes / 1e9:.2f} GB {t_bytes:.4f} ms), {b / t:.1%} of it  [{card}]")
    summary["program_noise"] = dict(max_abs_err=worst, ms=t, plain_ms=tp, bound_ms=b,
                                    bound_by=by, library_ms=None)
    del cells
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4d: the trainer, qwen2-0.5b trained through repro_torch.launch.train
# ---------------------------------------------------------------------------

# the launcher at qwen2-0.5b's full width, make_policy("mem_faithful"),
# 3 steps of batch 8 x 128 tokens (loss chunks of 64, remat on, float32)
TRAIN = ["--policy", "mem_faithful", "--steps", "3", "--batch", "8", "--seq", "128"]
TRAIN_TOKENS = 8 * 128
# the kernels-against-plain comparison: 2 of the 24 layers, batch 2 x 16
TRAIN_CUT = ["--policy", "mem_faithful", "--layers", str(CUT_LAYERS), "--batch", "2", "--seq",
             "16", "--steps", "2"]
LOSS_CHUNK = 64  # launch/train.py's
CKPT_DIR = os.path.join(HERE, "build", "chip_smoke_ckpt")


def train_launches(n_layers, steps, seq, remat=True, n_slices=None):
    """(K1, K6) launches of ``steps`` faithful train steps: per step one
    programming and one K1 a projection (7 a layer) and a loss chunk
    (the vocab head), all twice with remat (the recompute); a
    programming is one K6 launch a slice plane."""
    from repro_torch.launch.dryrun import make_policy

    if n_slices is None:
        n_slices = make_policy("mem_faithful").default.weight_spec.n_slices
    chunks = -(-seq // min(LOSS_CHUNK, seq))
    k1 = (7 * n_layers + chunks) * (2 if remat else 1) * steps
    return k1, k1 * n_slices


def _leaves_equal(a, b) -> bool:
    from repro_torch.models.common import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def _train_counts():
    from repro_torch.kernels import ops

    return ops.COUNTERS["fused_sliced_matmul"].count, ops.COUNTERS["program_noise"].count


def train(qcfg, card, counters):
    """``repro_torch.launch.train.main`` at qwen2-0.5b's full width and
    depth under ``mem_faithful``: 3 steps (each loss and grad norm finite,
    K1 and K6 launched by the formula), one more step profiled (idle
    share, K1 / K6 device ms a step); then, at ``CUT_LAYERS`` layers
    (full width, the same batch, loss chunks and remat), a resumed run
    (2 steps with ``--ckpt``, then to step 3) bit-equal to 3 steps
    without a break."""
    import shutil

    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as trainer
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import make_train_step

    ops.reset_counters()
    rep: dict = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    hist, state = trainer.main(TRAIN, return_state=True, report=rep)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    k1, k6 = _train_counts()
    want = train_launches(qcfg.n_layers, 3, 128)
    for i, (loss, gn, dt) in enumerate(zip(rep["loss"], rep["grad_norm"], rep["step_s"])):
        print(f"train qwen2-0.5b mem_faithful step {i}: loss {loss:.6f}, grad norm {gn:.6f}, "
              f"{dt * 1e3:.1f} ms, {TRAIN_TOKENS / dt:.1f} tokens/s  [{card}]")
    print(f"train: 3 steps in {wall:.1f} s with the launcher's set-up; K1 {k1} launches, K6 {k6} "
          f"(expected {want[0]}, {want[1]}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB  [{card}]")
    if (k1, k6) != want:
        raise AssertionError(f"train: launches K1 {k1}, K6 {k6}, expected {want}")
    if not all(np.isfinite(rep["loss"] + rep["grad_norm"])):
        raise AssertionError(f"train: non-finite loss or grad norm {rep}")
    counters["fused_sliced_matmul"] = counters.get("fused_sliced_matmul", 0) + k1
    counters["program_noise"] = counters.get("program_noise", 0) + k6

    # one more step (step 3) profiled; its work is that of steps 1 and 2,
    # whose host times stand for its wall time
    opt = adamw(lr=cosine_schedule(3e-4, warmup=5, total=3))
    step_fn = make_train_step(qcfg, opt, make_policy("mem_faithful"),
                              compute_dtype=torch.float32, loss_chunk=LOSS_CHUNK)
    batch = synthetic_batch(qcfg, 8, 128, 3, device="cuda")
    step_ms = statistics.mean(rep["step_s"][1:]) * 1e3
    groups = device_groups(lambda: step_fn(state, batch))
    if groups:
        busy = sum(ms for ms, _ in groups.values())
        k6_ms = sum(ms for g, (ms, _) in groups.items() if "program_noise" in g)
        k6_n = sum(n for g, (_, n) in groups.items() if "program_noise" in g)
        k1_ms, k1_n = groups.get("K1", (0.0, 0))
        print(f"train step (qwen2-0.5b, 1,024 tokens): {step_ms:.1f} ms wall (steps 1 and 2), "
              f"device busy {busy:.1f} ms, idle share {1 - busy / step_ms:.3f}; K1 {k1_ms:.1f} "
              f"ms in {k1_n} kernel launches, K6 {k6_ms:.1f} ms in {k6_n} launches a step  "
              f"[{card}]")
        other = sorted(((ms, n, g) for g, (ms, n) in groups.items()
                        if g.startswith("other") and "program_noise" not in g), reverse=True)
        print(f"  other device work: {sum(o[0] for o in other):.1f} ms in "
              f"{sum(o[1] for o in other)} launches; largest:")
        for ms, n, g in other[:6]:
            print(f"    {ms:.2f} ms in {n} launches  {g[7:]}")
    else:
        print("train step: device time not measured (the profiler saw no device events)")

    del state
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    whole = TRAIN + ["--layers", str(CUT_LAYERS)]
    two = [a if a != "3" else "2" for a in TRAIN] + ["--layers", str(CUT_LAYERS)]
    hist, state = trainer.main(whole, return_state=True)
    t0 = time.monotonic()
    first = trainer.main(two + ["--ckpt", CKPT_DIR])
    t1 = time.monotonic()
    rest, resumed = trainer.main(whole + ["--ckpt", CKPT_DIR], return_state=True)
    t2 = time.monotonic()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    same = first + rest == hist and _leaves_equal(resumed, state)
    print(f"train resume at {CUT_LAYERS} layers (full width, batch 8 x 128): 2 steps, "
          f"checkpoint, resumed to step 3: losses {first + rest} vs {hist}; the final state "
          f"bit-equal to the uninterrupted run: {same}; the runs {t1 - t0:.1f} s and "
          f"{t2 - t1:.1f} s with the launcher's set-up and checkpoints (each saves one)  "
          f"[{card}]")
    if not same:
        raise AssertionError("train: the resumed run differs from the uninterrupted one")


def train_plain(card):
    """The trainer at ``CUT_LAYERS`` layers of qwen2-0.5b (full width),
    batch 2 x 16, 2 steps: with the kernels and remat off, with their
    plain versions (``--kernels off``), and with the kernels and remat
    on: every loss and grad norm, parameter and moment bit-equal."""
    from repro_torch.launch import train as trainer

    runs = {}
    for label, extra in (("kernels", ["--remat", "off"]),
                         ("plain", ["--remat", "off", "--kernels", "off"]),
                         ("remat", ["--remat", "on"])):
        rep: dict = {}
        before = _train_counts()
        t0 = time.monotonic()
        _, st = trainer.main(TRAIN_CUT + extra, return_state=True, report=rep)
        torch.cuda.synchronize()
        n = tuple(a - b for a, b in zip(_train_counts(), before))
        runs[label] = (rep, st, n, time.monotonic() - t0)
        print(f"train at {CUT_LAYERS} layers, {label}: losses {rep['loss']}, grad norms "
              f"{rep['grad_norm']}; K1 / K6 launches {n}; {runs[label][3]:.1f} s  [{card}]")
    if runs["plain"][2] != (0, 0):
        raise AssertionError("train: --kernels off launched a kernel")
    for label, remat in (("kernels", False), ("remat", True)):
        want = train_launches(CUT_LAYERS, 2, 16, remat=remat)
        if runs[label][2] != want:
            raise AssertionError(f"train {label}: launches {runs[label][2]}, expected {want}")
    for a, b in (("kernels", "plain"), ("kernels", "remat")):
        ra, sa = runs[a][:2]
        rb, sb = runs[b][:2]
        if ra["loss"] != rb["loss"] or ra["grad_norm"] != rb["grad_norm"] or \
                not _leaves_equal(sa, sb):
            raise AssertionError(f"train at {CUT_LAYERS} layers: {a} and {b} differ")
        print(f"train at {CUT_LAYERS} layers: {a} and {b} give every loss, grad norm, parameter "
              "and moment bit for bit")


HEAD_SLAB = 2048  # columns of the vocab head held against its plain version, per slab


def check_k1_train(timer, qcfg, card):
    """K1 at the trainer's calls under ``mem_faithful`` (``dynamic`` ADC
    over 128-row tiles), bit-equal to its plain version: each projection
    shape of qwen2-0.5b at 1,024 rows (batch 8 x 128 tokens), and the
    vocab head at 512 rows (batch 8 x a loss chunk of 64).  The head's
    kernel runs over the whole head; its plain version over three slabs of
    ``HEAD_SLAB`` whole crossbar columns (the first, the middle and the
    last), whose columns it gives alone in the same bits (the ``dynamic``
    range spans one crossbar's columns): the whole head's plain version
    would take minutes, estimated here from the slabs' time."""
    from repro_torch.core.dpe import prepare_weight
    from repro_torch.core.prng import PRNGKey
    from repro_torch.kernels import sliced_matmul as sm
    from repro_torch.launch.dryrun import make_policy

    cfg = make_policy("mem_faithful").default
    kw = _k1_kw(cfg)
    bn = cfg.array_size[1]
    d, kv = qcfg.d_model, qcfg.n_kv_heads * qcfg.head_dim
    shapes = (("q, o", d, d), ("k, v", d, kv), ("gate, up", d, qcfg.d_ff),
              ("down", qcfg.d_ff, d), ("vocab head", d, qcfg.vocab))
    g = torch.Generator(device="cuda").manual_seed(18)
    for i, (label, k, n) in enumerate(shapes):
        m = 8 * LOSS_CHUNK if label == "vocab head" else TRAIN_TOKENS
        pw = prepare_weight(torch.randn((k, n), generator=g, device="cuda") * k**-0.5, cfg,
                            PRNGKey(18 + i))
        x = torch.randn((m, k), generator=g, device="cuda")
        y = sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, **kw)
        _, kp, np_ = pw.slices.shape
        if label == "vocab head":
            mid = (np_ // bn // 2) * bn
            cols = [(0, HEAD_SLAB), (mid, mid + HEAD_SLAB), (np_ - HEAD_SLAB, np_)]
        else:
            cols = [(0, np_)]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        same = True
        for c0, c1 in cols:
            yp = sm.fused_sliced_matmul_ref(x, pw.slices[:, :, c0:c1].contiguous(),
                                            pw.scale[:, c0 // bn:c1 // bn].contiguous(), **kw)
            same = same and torch.equal(y[:, c0:c1], yp)
        torch.cuda.synchronize()
        t_plain = (time.monotonic() - t0) * 1e3
        if not bool(torch.isfinite(y).all()) or not same:
            raise AssertionError(f"K1 {label} at M={m}: differs from its plain version")
        t = timer(lambda: sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, **kw))
        nbytes = 4 * (pw.slices.numel() + pw.scale.numel() + x.numel() + m * np_)
        flops = 2 * cfg.input_spec.n_slices * cfg.weight_spec.n_slices * m * kp * np_
        b, by = bound_ms(nbytes, flops)
        done = sum(c1 - c0 for c0, c1 in cols)
        plain = (f"plain {t_plain:.1f} ms" if done == np_ else
                 f"plain {t_plain:.1f} ms over {done:,} of its {np_:,} columns (the whole head "
                 f"estimated {t_plain * np_ / done / 1e3:.0f} s)")
        print(f"K1 {label} ({k} -> {n}) at M={m} bit-equal to its plain version: kernel "
              f"{t:.4f} ms, {plain}, bound {b:.4f} ms ({by}), {b / t:.1%} of it  [{card}]")
        del pw, x, y


def check_optim(qcfg, card):
    """One ``adamw`` and one ``adafactor`` update of a qwen2-0.5b layer's
    parameters (full width) on the card, bit-equal to the same update on
    the CPU; and the embedding gather's gradient (``take_rows``) with 1,024
    ids over 37 rows, every one repeated, bit-equal to the CPU's."""
    from repro_torch.core.prng import PRNGKey, fold_in, normal
    from repro_torch.models import init_params
    from repro_torch.optim import adafactor, adamw, cosine_schedule
    from repro_torch.models.common import take_rows, tree_leaves, tree_map

    params = init_params(qcfg.replace(n_layers=1), 0, device="cuda")["blocks"]
    it = iter(range(10**6))
    grads = tree_map(lambda t: normal(fold_in(PRNGKey(7), next(it)), t.shape, device="cuda")
                     * 1e-2, params)
    cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    n = sum(t.numel() for t in tree_leaves(params))
    for name, opt in (("adamw", adamw(lr=cosine_schedule(3e-4, warmup=5, total=3))),
                      ("adafactor", adafactor(lr=1e-2))):
        step = torch.tensor(5, dtype=torch.int32)
        t0 = time.monotonic()
        pc, sc = opt.update(grads, opt.init(params), params, step.cuda())
        torch.cuda.synchronize()
        t_card = time.monotonic() - t0
        t0 = time.monotonic()
        pp, sp = opt.update(cpu(grads), opt.init(cpu(params)), cpu(params), step)
        t_cpu = time.monotonic() - t0
        same = _leaves_equal(pc, pp) and _leaves_equal(sc, sp)
        print(f"optimizer {name}: one update of {n / 1e6:.1f} M parameters on the card "
              f"({t_card * 1e3:.1f} ms) bit-equal to the CPU's ({t_cpu:.1f} s): {same}  [{card}]")
        if not same:
            raise AssertionError(f"optimizer {name}: the card's update differs from the CPU's")

    # the embedding gather's gradient: repeated ids sum in position order
    gen = torch.Generator().manual_seed(18)
    w = torch.randn((37, qcfg.d_model), generator=gen)
    ids = torch.randint(0, 37, (8, 128), generator=gen)
    gy = torch.randn((8, 128, qcfg.d_model), generator=gen)
    grads = []
    for dev in ("cuda", "cpu"):
        t = w.to(dev).requires_grad_(True)
        take_rows(t, ids.to(dev)).backward(gy.to(dev))
        grads.append(t.grad.cpu())
    same = torch.equal(*grads)
    print(f"take_rows gradient (1,024 ids over 37 rows, {qcfg.d_model} wide): the card's "
          f"bit-equal to the CPU's: {same}")
    if not same:
        raise AssertionError("take_rows: the card's gradient differs from the CPU's")


def hw_training(card):
    """``repro_torch.examples.hw_training`` at its smoke size on the card,
    100 steps: the loss must fall."""
    from repro_torch.examples import hw_training as example

    before = _train_counts()
    t0 = time.monotonic()
    losses = example.main(["--steps", "100"])
    torch.cuda.synchronize()
    n = tuple(a - b for a, b in zip(_train_counts(), before))
    print(f"hw_training (h2o-danube smoke, int8 fast, lm_head digital): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} in 100 steps, {time.monotonic() - t0:.1f} s; K1 / K6 launches "
          f"{n}  [{card}]")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0] and n[1] > 0):
        raise AssertionError("hw_training: the loss did not fall, or K6 never launched")


# ---------------------------------------------------------------------------
# phase 5: the paper's applications
# ---------------------------------------------------------------------------

APPS = ("matmul_re", "monte_carlo", "linsolve", "kmeans", "cwt", "train_mlp", "inference_sweep")
FAITHFUL_APPS = ("matmul_re", "monte_carlo", "linsolve", "kmeans", "cwt")


def _scalars(out, prefix=""):
    """The scalar leaves of an app's result (lists and arrays left out)."""
    if isinstance(out, dict):
        for key, val in out.items():
            yield from _scalars(val, f"{prefix}{key}/")
    elif isinstance(out, tuple):
        for i, val in enumerate(out):
            yield from _scalars(val, f"{prefix}{i}/")
    elif isinstance(out, (bool, int, float)):
        yield prefix[:-1], out


def _same(a, b) -> bool:
    """Equal results: every scalar bit-equal, every list and array equal."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[key], b[key]) for key in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return type(a) is type(b) and a == b


def plain_apps() -> dict:
    """The seven apps at their defaults with their plain versions on the
    card (``kernels=False``): ``{name: (result, wall s)}``.  No kernel is
    needed, so ``main`` runs this while ``nvcc`` builds them; fails if a
    kernel launched."""
    import importlib

    from repro_torch.kernels import ops

    ops.reset_counters()
    plain = {}
    for name in APPS:
        mod = importlib.import_module(f"repro_torch.apps.{name}")
        t0 = time.monotonic()
        out = mod.run(device="cuda", kernels=False)
        torch.cuda.synchronize()
        plain[name] = (out, time.monotonic() - t0)
    if any(c.count for c in ops.COUNTERS.values()):
        raise AssertionError("the apps' kernels=False runs launched a kernel")
    return plain


def run_apps(card, plain_runs):
    """The seven apps at their defaults with the kernels, each result held
    against its plain run from :func:`plain_apps`."""
    import importlib

    from repro_torch.kernels import ops

    for name in APPS:
        mod = importlib.import_module(f"repro_torch.apps.{name}")
        ops.reset_counters()
        t0 = time.monotonic()
        out = mod.run(device="cuda")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        k1 = ops.COUNTERS["fused_sliced_matmul"].count
        k6 = ops.COUNTERS["program_noise"].count
        plain, wall_plain = plain_runs[name]
        items = list(_scalars(out))
        head = ", ".join(f"{key}={val:.6g}" if isinstance(val, float) else f"{key}={val}"
                         for key, val in items[:12])
        more = f" ... ({len(items)} scalars)" if len(items) > 12 else ""
        print(f"app {name}: {head}{more}")
        print(f"app {name}: {wall:.2f} s with the kernels ({k1} K1, {k6} K6 launches), "
              f"{wall_plain:.2f} s with the plain versions; results equal: "
              f"{_same(out, plain)}  [{card}]")
        if not _same(out, plain):
            raise AssertionError(f"app {name}: kernels and plain versions disagree")
        if name in FAITHFUL_APPS and k1 <= 0:
            raise AssertionError(f"app {name}: K1 never launched")


KERNEL_OF = (("sliced_matmul_kernel", "K1"), ("paged_decode_kernel", "K2"),
             ("paged_chunk_kernel", "K3"))


def device_groups(fn) -> dict:
    """Device time (ms) and launches of ``fn()`` per kernel group (K1-K3
    by name, every other kernel, copy and fill as ``"other: <name>"``),
    from ``torch.profiler``'s device events; empty where the profiler saw
    none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity only, read from the profiler's raw records: building
    # its Python event tree takes a minute for a run of 200,000 launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or getattr(e, "is_user_annotation", bool)():
            continue
        name = e.name()
        g = next((k for pat, k in KERNEL_OF if pat in name), "other: " + name[:60])
        ms, n = groups.get(g, (0.0, 0))
        groups[g] = (ms + e.duration_ns() / 1e6, n + 1)
    return groups


def print_busy(what, groups, wall_ms, card, k1_calls=None):
    """Busy time over ``wall_ms`` (a timed run of the same work), K1-K3's
    share and the largest other device work."""
    if not groups:
        print(f"device time of {what}: not measured (the profiler saw no device events)")
        return
    busy = sum(ms for ms, _ in groups.values())
    print(f"device time of {what}: busy {busy:.1f} ms of {wall_ms:.1f} ms wall, "
          f"idle share {1 - busy / wall_ms:.3f}  [{card}]")
    other = sorted(((ms, n, g) for g, (ms, n) in groups.items() if g.startswith("other")),
                   reverse=True)
    for g in ("K1", "K2", "K3"):
        ms, n = groups.get(g, (0.0, 0))
        print(f"  {g}: {ms:.2f} ms device in {n} kernel launches")
    if k1_calls is not None:
        n = groups.get("K1", (0.0, 0))[1]
        print(f"  K1: {k1_calls} calls, {n / max(k1_calls, 1):.2f} kernel launches per call")
    print(f"  other device work: {sum(o[0] for o in other):.2f} ms in "
          f"{sum(o[1] for o in other)} launches; largest:")
    for ms, n, g in other[:6]:
        print(f"    {ms:.2f} ms in {n} launches  {g[7:]}")


def device_busy(loop, reqs, rep, card):
    """Where the served path's time goes: the requests of ``rep`` (the
    timed run) run once more under ``torch.profiler``, whose device events
    (kernels, copies, fills) are summed per group.  The profiled run is
    not timed (the profiler slows the host side); the device work is the
    same in both runs, so busy / ``rep.wall_s`` is the device's busy
    share."""
    from repro_torch.kernels import ops

    ops.reset_counters()
    groups = device_groups(lambda: loop.run(reqs))
    print_busy(f"the served path ({rep.prefill_chunks_run} prefill chunks, {rep.decode_steps} "
               "decode steps)", groups, rep.wall_s * 1e3, card,
               k1_calls=ops.COUNTERS["fused_sliced_matmul"].count)


def train_phases(timed, timer, qcfg, card, counters):
    timed("train", train, qcfg, card, counters)
    torch.cuda.empty_cache()
    timed("check_k1_train", check_k1_train, timer, qcfg, card)
    torch.cuda.empty_cache()
    timed("train_plain", train_plain, card)
    timed("check_optim", check_optim, qcfg, card)
    timed("hw_training", hw_training, card)
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--only", choices=("train", "rwkv6"), default=None,
                    help="build the kernels and run this phase alone (no kernels line, no "
                         "final line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs import get
    from repro_torch.kernels import build

    # the reference's float32 products are full float32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        print(f"phase {name}: {time.monotonic() - t0:.1f} s")
        return out

    def build_kernels():
        t0 = time.monotonic()
        build.library()
        return time.monotonic() - t0

    # the apps' plain runs need no kernel: they take the card while nvcc builds
    with ThreadPoolExecutor(1) as pool:
        built = pool.submit(build_kernels)
        plain_runs = timed("plain_apps", plain_apps) if args.only is None else None
        print(f"built kernels with nvcc in {built.result():.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "build.log"), "w") as fh:
        fh.write(build.build_log())

    qcfg = get("qwen2-0.5b")
    timer = Timer()
    tiny = torch.empty(1, device="cuda")
    floor = timer(lambda: tiny.zero_(), iters=20)
    print(f"timer floor (one 4-byte fill kernel): {floor:.4f} ms  [{card}]")
    summary: dict = {}
    counters: dict = {}

    if args.only == "train":
        train_phases(timed, timer, qcfg, card, counters)
        return 0
    if args.only == "rwkv6":
        timed("rwkv6", rwkv6, card, counters)
        return 0
    timed("check_k1", check_k1, timer, qcfg, summary)
    timed("check_k1_tiles", check_k1_tiles, timer, summary, card)
    timed("check_k2_k3", check_k2_k3, timer, qcfg, summary, card, floor)
    timed("check_k2_k3_long", check_k2_k3_long, timer, qcfg, summary, card, floor)
    timed("check_k4", check_k4, timer, summary, card)
    timed("check_k5", check_k5, timer, qcfg, summary, card)
    timed("check_k6", check_k6, timer, qcfg, summary, card)
    timed("check_init", check_init, card)
    params, sc, loop, reqs, rep = timed("serve", serve, qcfg, card, counters)
    sreqs, srep = timed("serve_sampled", serve_sampled, params, qcfg, sc, loop, reqs, rep, card)
    timed("serve_spec", serve_spec, params, qcfg, sc, loop, reqs, rep, sreqs, srep, card)
    timed("serve_drift", serve_drift, params, qcfg, sc, loop, reqs, rep, card)
    del loop
    torch.cuda.empty_cache()
    timed("launch", launch, params, qcfg, card, counters)
    summary["k1_long"] = timed("check_k1_long", check_k1_long, timer, card)
    del params
    torch.cuda.empty_cache()
    timed("rwkv6", rwkv6, card, counters)
    train_phases(timed, timer, qcfg, card, counters)
    counters["sliced_matmul"] = summary["sliced_matmul"]["launches"]
    counters["flash_attention"] = summary["flash_attention"]["launches"]
    timed("run_apps", run_apps, card, plain_runs)
    timed("check_circuit", check_circuit, card)

    sources = {
        "fused_sliced_matmul": ("src/repro_torch/csrc/sliced_matmul.cuh",
                                "src/repro/kernels/sliced_matmul.py:352"),
        "paged_decode_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:152"),
        "paged_chunk_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                  "src/repro/kernels/paged_attention.py:280"),
        "sliced_matmul": ("src/repro_torch/csrc/sliced_matmul.cuh",
                          "src/repro/kernels/sliced_matmul.py:185"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:129"),
        # no Pallas kernel: the reference's XLA-fused lognormal_program
        "program_noise": ("src/repro_torch/csrc/program_noise.cu",
                          "src/repro/core/device.py:62"),
    }
    kernels = []
    for name, (src, repl) in sources.items():
        s = summary[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=repl, launches=counters[name],
            max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
            bound_ms=s["bound_ms"], bound_by=s["bound_by"], library_ms=s["library_ms"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
