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
   apps' plain versions on the card (``plain_apps``, held in phase 6)
   and, on a stream of their own, the plain K1 at the train phases'
   calls (``k1_plain_ahead``, held in phase 5);
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
   (timed); serve qwen2-0.5b at full width (4 of its 24 layers,
   ``SERVE_LAYERS``, random weights
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
   request of 6,016 prompt tokens and 8 new ones (``max_len`` 8,192) at 2
   of the 24 layers served with prefill chunks of 32 and of 64, whose
   tokens must agree;
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
   full width, ``SERVE_LAYERS`` layers (``launch``): the default mode (``make_policy
   ("mem_faithful")``, batch 4, prompt 16, 16 new tokens) through the
   dense ``greedy_generate`` (K1 and K6 launched, by the formula; its
   tok/s and ITL), the same at 1 layer with ``--kernels on`` and
   ``off`` (4 new tokens) and at 2 layers with ``--per_call`` (tokens and
   every logit row bit-equal), and at ``SERVE_LAYERS`` layers
   ``--requests 8 --slots 4 --gen 8`` through the
   ``ServeLoop`` (K1, K2, K3 launched, every request finished) and one
   1,536-token prompt under ``digital`` through the dense path
   (``attention_chunked``) and the ``ServeLoop`` (equal tokens,
   first-token logits within max rel 1e-4); and K1 on one call of 1,536
   rows at a q projection's shape, bit-equal to its plain version
   (``check_k1_long``); then rwkv6-1.6b (the attention-free RWKV6
   ``ssm`` family, ``rwkv6``): at rwkv6-smoke the card's initial weights
   and launcher tokens (digital, ``mem_faithful``) equal to the CPU's;
   at full width, 4 of its 24 layers (``RWKV_LAYERS``), the launcher's
   default mode ``--arch rwkv6-1.6b --policy mem_faithful`` through the
   dense ``greedy_generate`` (K1 33 x 17 and K6 132 launches, no K2 / K3; its
   programming, prefill, ITL, idle share and K1 a step), one 4,096-token
   prompt under ``mem_faithful`` at 2 of the 24 layers (prefill, ITL,
   peak memory, K1 17 x 5),
   a 100-token prompt under ``digital`` through the chunked WKV form
   against the same prompt fed token by token at 2 of the 24 layers
   (equal tokens, first-token logits within max rel 1e-4), and the
   default mode at 1 layer with ``--kernels on`` against ``off`` (4 new
   tokens) and at 2 layers against ``--per_call`` (tokens and every
   logit row bit-equal); ``--only rwkv6`` runs this phase alone after the build; then qwen3-moe-235b-a22b (the
   token-choice top-8 MoE over 128 experts, ``moe``): at qwen3-moe-smoke
   widths the launcher's default mode and ``--requests`` with the kernels
   bit-equal to their plain versions, K2 / K3 at its head layout (16
   query heads a KV head, head_dim 128) bit-equal and timed, and at full
   width, its first layer of 94 under ``make_policy("mem_faithful")``
   (49.75 GB programmed): the dense ``greedy_generate`` timed and
   profiled (init, programming, peak memory, TTFT, ITL, tok/s, idle
   share, K1 a decode step against its bound), K1 over the programmed
   expert stack in one launch bit-equal to K1 on every expert alone and,
   on a sub-stack, to its plain version, a 3,072-token prompt at batch 4
   whose stacked K1 calls (24.2 GB of K-block partials at ``wi``) run in
   row groups, the grouped ``wi`` on 4 experts bit-equal to K1 on each
   alone (TTFT, ITL, peak memory, the groups), then the launcher's default
   mode (K1, the stacked K1 and K6 by the formula) and ``--requests 8
   --slots 4 --gen 8``; ``--only moe`` runs this phase alone after the
   build; then jamba-v0.1-52b (Mamba and attention in period groups,
   ``jamba``): jamba-smoke, its MoE layers included, in the launcher's
   default mode with the kernels bit-equal to their plain versions and
   ``--requests`` refused; at full width one period of 8 layers with the
   dense MLP in every layer (the published period's MoE layers need ~208
   GB of slices) through the dense ``greedy_generate`` (K1 and K6 by the
   formula; init, programming, TTFT, ITL, idle share, eager launches and
   K1 a decode step against its bound), one 1,024-token prompt (K1's and
   the selective scan's share of the prefill) and K1 at each distinct
   projection shape of the path (Mamba, attention, MLP, head) on its
   programmed state bit-equal to its plain version; ``--only jamba`` runs this
   phase alone after the build; then whisper-tiny's encoder-decoder and
   phi-3-vision-4.2b's patch prefix (``encdec``): whisper-tiny at full
   width and depth (4 encoder and 4 decoder layers, 1,500 frames) through
   the launcher's default mode (K1 and K6 by the formula) and the same
   generation timed and profiled (init, programming, TTFT, ITL, tok/s,
   idle share, peak memory, K1 in the prefill and a decode step against
   their bounds, eager launches); phi-3-vision at full width cut to 4 of
   its 32 layers, 576 patch embeddings ahead of 16 prompt tokens, batch
   2, 8 new, ``max_len`` 601, likewise; K1 at every distinct (K, N) of
   both paths (the ragged 51,865- and 32,064-column heads included, and
   whisper's encoder shapes at its 6,000 rows) bit-equal to its plain
   version; whisper-smoke and phi3-vision-smoke in
   the launcher's default mode with the kernels against ``--kernels off``,
   tokens and logits bit-equal; ``--only encdec`` runs this phase alone
   after the build;
5. the trainer (``train``): ``repro_torch.launch.train.main`` at
   qwen2-0.5b's full width, 4 of its 24 layers (``TRAIN_LAYERS``), under
   ``make_policy
   ("mem_faithful")``, batch 8 x 128 tokens, loss chunks of 64, remat
   on, float32, AdamW with the cosine schedule, 3 steps: every loss and
   grad norm finite, K1 and K6 launched by the formula (per step one
   programming and one K1 a projection and a loss chunk, twice with
   remat), its step time and tokens/s, one more step profiled (idle
   share against the host time of steps 1 and 2, K1 and K6 device ms a
   step), and, at 2 of the 24 layers (full width, batch 8 x 128, remat
   on), a resumed run (2 steps with ``--ckpt``, then to step 3)
   bit-equal to an uninterrupted one; K1 at the trainer's calls, each
   projection shape at 1,024 rows and the vocab head at 512 rows (the
   plain version over each weight's last 256-column slab, the kernel's
   call whole), bit-equal to its plain version (``check_k1_train``,
   :func:`check_k1_calls`);
   at 1 of the 24 layers (batch 2 x 16, 2 steps) the kernels against
   their plain versions and remat on against off, every loss, grad
   norm, parameter and moment bit for bit (``train_plain``); one
   ``adamw`` and one ``adafactor`` update of a full-width layer on the
   card bit-equal to the CPU's, and the embedding gather's gradient
   (``take_rows``, 1,024 ids over 37 rows) too (``check_optim``); and
   ``repro_torch.examples.hw_training`` for 100 steps, whose loss must
   fall (``hw_training``).  ``python3 chip_smoke.py --only train``, an
   aid while developing the trainer (the smoke test proper takes no
   arguments), builds the kernels and runs these phases alone; then the
   same launcher trains rwkv6-1.6b at full width, 4 of its 24 layers
   (``rwkv6_train``: ``mem_faithful``, batch 4 x 128, the chunked WKV
   form, 3 steps, each loss and grad norm finite, K1 and K6 by the
   formula, step time, tokens/s, peak memory, one step profiled for the
   idle share and K1 against its bound (launching what a timed step
   did); K1 at every distinct (K, N, M) of the step, the projections at
   512 rows and the head at 256, bit-equal to its plain version; at 1
   layer, batch 1 x 64, 2 steps, the kernels against their plain
   versions and remat on against off, every loss, grad norm, parameter
   and moment bit for bit) and
   qwen3-moe-235b-a22b's first layer at full width (``moe_train``: the
   memory reckoning of parameters, gradients, AdamW's moments and one
   programmed stack printed first; batch 2 x 128, 2 steps, AdamW in
   place, K1, the stacked K1 (one launch a stack a forward pass) and K6
   by the formula, the same prints; the stacked K1 at the phase's shapes
   on 4 experts of ``wi`` and ``wo`` and K1 at the attention's shapes at
   256 rows and the head's at 128 bit-equal to its plain version;
   qwen3-moe-smoke's kernels against their plain versions and remat on
   against off, bit for bit); ``--only rwkv6_train`` and ``--only
   moe_train`` run each alone after the build; then jamba-v0.1-52b's
   full-width period (one period of 8 layers, the dense MLP in each)
   through the train launcher's loop (``jamba_train``: the memory reckoning,
   batch 2 x 128, 3 steps, AdamW in place, the same prints, K1 at every
   distinct (K, N, M) of the step bit-equal to its plain version over
   its last 256-column slab, ``TRAIN_SLAB``, with the call's launch plan
   printed; jamba-smoke, its MoE layers included, through the launcher,
   the kernels against their plain versions and remat on against off),
   whisper-tiny at full width and depth (4 x 128 decoder tokens over
   1,500 frames a row, 3 steps) and phi-3-vision-4.2b at full width cut
   to 4 of its 32 layers (2 x (576 patches + 64 tokens), 2 steps)
   through the launcher (``encdec_train``: likewise, K1 at the calls
   ``encdec`` does not hold), and qwen3-4b and qwen1.5-32b served at full
   width, 1 layer, through the serve launcher's default mode and the
   same generation profiled (``dense_configs``: K1 and K6 by the
   formula, tok/s, K1 a decode step against its bound); ``--only
   jamba_train``, ``--only encdec_train`` and ``--only dense_configs``
   run each alone after the build;
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

import gc
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
        "fused_sliced_matmul": 7 * qcfg.n_layers * rep.prefill_chunks_run + len(reqs)
        + (7 * qcfg.n_layers + 1) * rep.decode_steps,
        "paged_decode_attention": qcfg.n_layers * rep.decode_steps,
        "paged_chunk_attention": qcfg.n_layers * rep.prefill_chunks_run,
    }
    check_launches("serve", launches, expect, rep)
    counters.update(launches)
    print(f"serve qwen2-0.5b mem_faithful dynamic_row, {qcfg.n_layers} of 24 layers, 2 slots, "
          f"4 requests "
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


# the depth of the kernels-against-plain comparisons of the serving, launch, rwkv6 and
# trainer phases: one layer keeps every projection shape and the head, and each layer
# more adds a layer of the plain versions to each of the four phases
CUT_LAYERS = 1
# decode steps of the 1-layer kernels-against-plain runs of the launcher (each
# plain step runs the vocab head's plain K1)
CUT_GEN = 4
# the depth of the long-prompt checks (the 6,016-token request, rwkv6's
# 4,096-token prompt): they test positions and chunkings, not depth
LONG_LAYERS = 2
# the depth of the checks that run the kernels alone (``--per_call`` against the
# programmed run, the trainer's checkpoint resume): a second layer has keys of its own
CHECK_LAYERS = 2
# the depth of qwen2-0.5b's ServeLoop phases (serve, serve_sampled, serve_spec,
# serve_drift) and of the launcher's runs at full width: a depth cut for the script's
# time limit (the ServeLoop phases took ~141 s at 24 layers on an H100 80GB HBM3, 700 W)
SERVE_LAYERS = 4


def cut_depth(cfg, params, programmed=None, n=CUT_LAYERS):
    """A one-segment model (qwen2-0.5b, rwkv6-1.6b) at full width cut to its
    first ``n`` layers (views of the stacked leaves; layer i keeps the full
    model's key chain, so the programmed state of the cut is the full
    state's first layers).  The plain versions of a full-depth served run
    take 204 s with the plain K1 rounding once (an H100 at 700 W), so the
    serving phases hold the kernels against them at ``CUT_LAYERS``."""
    from repro_torch.models.common import tree_map

    def first(tree):
        return {**tree, "blocks": {k: tree_map(lambda t: t[:n], v)
                                   for k, v in tree["blocks"].items()}}

    cut = None if programmed is None else first(programmed)
    return cfg.replace(n_layers=n), first(params), cut


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
    ``max_len`` 8,192 at ``LONG_LAYERS`` layers, so that every decode
    step's K2 reads more than the 5,664 positions the old K2 could hold,
    served with prefill chunks of 32 and of 64 (kernels only): equal
    tokens."""
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
    lcfg, lparams, lprog = cut_depth(qcfg, params, loop.programmed, n=LONG_LAYERS)
    tokens = {}
    for chunk in (32, 64):
        lp = ServeLoop(lparams, lcfg, sc.replace(slots=1, max_len=8192, prefill_chunk=chunk),
                       programmed=lprog)
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
        if (lrep.decode_steps != 7 or k2 != lcfg.n_layers * lrep.decode_steps
                or k3 != lcfg.n_layers * lrep.prefill_chunks_run):
            raise AssertionError(f"long request, chunk {chunk}: {lrep.decode_steps} decode "
                                 f"steps, {k2} K2 and {k3} K3 launches")
        tokens[chunk] = r.tokens
        print(f"long request at {LONG_LAYERS} layers (6016 prompt tokens, 8 new, max_len 8192), "
              f"prefill chunk {chunk}: "
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
        "fused_sliced_matmul": 7 * qcfg.n_layers * srep.prefill_chunks_run + len(sreqs)
        + (7 * qcfg.n_layers + 1) * srep.decode_steps,
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
            chunk, step = 7 * qcfg.n_layers, 7 * qcfg.n_layers + 1  # K1 calls
            expect = {
                "fused_sliced_matmul": chunk * got.prefill_chunks_run + len(rq)
                + (chunk * n_chunks if faithful_draft else 0)
                + rounds * (step + (SPEC_K + 1) * step * faithful_draft),
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
            ("fused_sliced_matmul", "fused_sliced_matmul_stack", "paged_decode_attention",
             "paged_chunk_attention", "program_noise")}


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
    print(f"dense greedy_generate, qwen2-0.5b ({qcfg.n_layers} layers) mem_faithful (dynamic "
          f"ADC), batch 4: prefill of "
          f"64 rows {pre * 1e3:.1f} ms, 16 new tokens in {whole * 1e3:.1f} ms: "
          f"{4 * 16 / whole:.2f} tok/s, ITL {itl * 1e3:.1f} ms (the third run: "
          f"{(times[16][2] - times[0][2]) / 16 * 1e3:.1f} ms)  [{card}]")
    print_busy("the dense default mode (the prefill and 16 decode steps)",
               device_groups(lambda: generate(16)), whole * 1e3, card)


def launch(qcfg, card, counters):
    """``repro_torch.launch.serve.main`` at qwen2-0.5b's full width,
    ``SERVE_LAYERS`` layers: the default mode (``greedy_generate``, K1 and
    K6 launched; then timed and profiled, :func:`dense_rate`); the same at
    ``CUT_LAYERS`` layers with ``--kernels on`` and ``off`` (tokens and
    every logit row bit-equal) and at ``CHECK_LAYERS`` with ``--per_call``
    (bit-equal to the programmed run); ``--requests 8 --slots 4 --gen 8``
    (K1, K2, K3 launched, every request finished) and one 1,536-token
    prompt under ``digital``, dense (``attention_chunked``) against the
    ``ServeLoop`` (K2 / K3): equal tokens, first-token logits within max
    rel 1e-4."""
    from repro_torch.core.prng import PRNGKey, randint
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeConfig, ServeLoop

    qcfg = qcfg.replace(n_layers=SERVE_LAYERS)
    ops.reset_counters()
    tokens = launcher.main(LAUNCH + ["--layers", str(SERVE_LAYERS)])
    torch.cuda.synchronize()
    launched = path_launches()
    # the prefill and 16 decode steps: 7 projections a layer and the head
    expect_k1 = (7 * qcfg.n_layers + 1) * 17
    expect_k6 = K6_PER_PROGRAMMING(qcfg, faithful_policy())
    print(f"launch default mode at {qcfg.n_layers} layers: launches {launched}; expected K1 "
          f"{expect_k1}, K6 {expect_k6}")
    if (launched["fused_sliced_matmul"] != expect_k1 or launched["program_noise"] != expect_k6
            or launched["paged_decode_attention"] or launched["paged_chunk_attention"]):
        raise AssertionError(f"launch default mode: launches {launched}")
    if tokens.shape != (4, 17) or not bool(((tokens >= 0) & (tokens < qcfg.vocab)).all()):
        raise AssertionError(f"launch default mode: tokens {tokens}")
    for name, n in launched.items():
        counters[name] = counters.get(name, 0) + n
    params = init_params(qcfg, 0, device="cuda")  # the launcher's weights
    dense_rate(params, qcfg, card)

    cut = LAUNCH + ["--layers", str(CUT_LAYERS), "--gen", str(CUT_GEN)]
    ops.reset_counters()
    on = launcher.main(cut + ["--kernels", "on"], collect_logits=True)
    k1_on = ops.COUNTERS["fused_sliced_matmul"].count
    t0 = time.monotonic()
    off = launcher.main(cut + ["--kernels", "off"], collect_logits=True)
    torch.cuda.synchronize()
    t_off = time.monotonic() - t0
    if k1_on <= 0 or ops.COUNTERS["fused_sliced_matmul"].count != k1_on:
        raise AssertionError("launch: --kernels on launched no K1, or --kernels off launched one")
    two = LAUNCH + ["--layers", str(CHECK_LAYERS)]
    on2 = launcher.main(two + ["--kernels", "on"], collect_logits=True)
    per_call = launcher.main(two + ["--per_call"], collect_logits=True)
    torch.cuda.synchronize()
    for label, ref, other, depth in (("--kernels off", on, off, CUT_LAYERS),
                                     ("--per_call", on2, per_call, CHECK_LAYERS)):
        if not (torch.equal(ref[0], other[0]) and torch.equal(ref[1], other[1])):
            raise AssertionError(f"launch at {depth} layers: {label} differs from the "
                                 "programmed run with the kernels")
        print(f"launch at {depth} layers: {label} gives the tokens and all "
              f"{ref[1].shape[0] * ref[1].shape[1]} logit rows of the programmed run with the "
              "kernels, bit for bit")
    print(f"launch at {CUT_LAYERS} layers with the plain versions: {t_off:.1f} s  [{card}]")

    ops.reset_counters()
    rep = launcher.main(["--policy", "mem_faithful", "--requests", "8", "--slots", "4",
                         "--gen", "8", "--layers", str(SERVE_LAYERS)])
    torch.cuda.synchronize()
    launched = path_launches()
    print(f"launch --requests 8 --slots 4 at {SERVE_LAYERS} layers: launches {launched}; "
          f"{rate_line(rep)}  [{card}]")
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
         "--gen", str(n_new), "--layers", str(SERVE_LAYERS)], collect_logits=True)
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
    print(f"long prompt at {SERVE_LAYERS} layers ({LONG_PROMPT} tokens, {n_new} new, digital): "
          f"dense greedy_generate "
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
# the served run's depth (of 24, full width): a depth cut for the script's time limit
# (the phase took ~55 s at 24 layers on an H100 80GB HBM3, 700 W)
RWKV_LAYERS = 4
RWKV_K1_STEP = 8 * RWKV_LAYERS + 1  # r, k, v, g, o and the MLP's wi, wg, wo a layer + the head
RWKV_PROMPT = 100  # a digital prefill through the chunked WKV form: 4 chunks, the last padded
# the depth of that prompt's check against token-by-token decoding, whose 104 decode
# steps take ~0.27 s each at the full 24 layers
RWKV_SCAN_LAYERS = 2
RWKV_LONG = 4096  # one long prompt: the O(1) recurrent state at 4,096 tokens
RWKV_LONG_NEW = 4  # decode steps after a prefill (greedy_generate's n_steps)
RWKV_PROFILED = 4  # decode steps of the profiled generation (the idle share, K1 a step)


def rwkv6(card, counters):
    """rwkv6-1.6b at its published widths, ``RWKV_LAYERS`` of its 24
    layers, through ``repro_torch.launch.serve`` and the dense
    ``greedy_generate``: the
    launcher's default mode (``make_policy("mem_faithful")``, batch 4,
    prompt 16, 16 new; K1 and K6 by the formula, no K2 / K3) with its
    programming, prefill, ITL and idle share; the same at ``CUT_LAYERS``
    layers with ``--kernels on`` and ``off`` and at ``CHECK_LAYERS`` with
    ``--per_call`` (tokens and every logit row bit-equal); a ``RWKV_PROMPT``-token
    prompt under ``digital`` (the chunked WKV form) against the same
    prompt fed token by token through ``decode_step`` (the scan): equal
    tokens, first-token logits within max rel 1e-4, at ``RWKV_SCAN_LAYERS``
    layers (full width, the head included); one ``RWKV_LONG``-
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

    # the launcher's default mode at full width, RWKV_LAYERS layers
    cfg = cfg.replace(n_layers=RWKV_LAYERS)
    ops.reset_counters()
    tokens = launcher.main(RWKV_LAUNCH + ["--layers", str(RWKV_LAYERS)])
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

    # one long prompt at LONG_LAYERS layers: the prefill, then
    # RWKV_LONG_NEW decode steps
    long_prompt = randint(PRNGKey(1), (1, RWKV_LONG), 0, cfg.vocab, device="cuda")
    lcfg, lparams, lprog = cut_depth(cfg, params, prog, n=LONG_LAYERS)
    prefill = make_prefill_step(lcfg, pol, compute_dtype=torch.float32,
                                cache_dtype=torch.float32)
    decode = make_decode_step(lcfg, pol, compute_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counters()
    t0 = time.monotonic()
    logits, cache = prefill(lparams, {"tokens": long_prompt}, lprog)
    torch.cuda.synchronize()
    t_pre = time.monotonic() - t0
    out = [torch.argmax(logits, dim=-1)]
    t0 = time.monotonic()
    for _ in range(RWKV_LONG_NEW):
        logits, cache = decode(lparams, cache, out[-1], lprog)
        out.append(torch.argmax(logits, dim=-1))
    torch.cuda.synchronize()
    itl = (time.monotonic() - t0) / RWKV_LONG_NEW
    k1 = ops.COUNTERS["fused_sliced_matmul"].count
    want_k1 = (8 * LONG_LAYERS + 1) * (RWKV_LONG_NEW + 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"rwkv6 long prompt at {LONG_LAYERS} layers ({RWKV_LONG} tokens, batch 1, "
          f"mem_faithful, {RWKV_LONG_NEW} new): prefill {t_pre * 1e3:.1f} ms, ITL "
          f"{itl * 1e3:.1f} ms, peak device memory {peak:.2f} GiB, K1 {k1} launches (expected "
          f"{want_k1}), tokens {torch.stack(out, 1)[0].tolist()}  [{card}]")
    if k1 != want_k1 or not bool(torch.isfinite(logits).all()):
        raise AssertionError("rwkv6 long prompt: K1 launches or non-finite logits")
    counters["fused_sliced_matmul"] += k1
    del prog, lprog, lparams, cache, logits
    torch.cuda.empty_cache()

    # a digital prompt through the chunked form against token-by-token decoding
    prompt = randint(PRNGKey(2), (1, RWKV_PROMPT), 0, cfg.vocab, device="cuda")
    ccfg, cparams, _ = cut_depth(cfg, params, n=RWKV_SCAN_LAYERS)
    t0 = time.monotonic()
    dense_tok, dense_logits = greedy_generate(cparams, ccfg, prompt, RWKV_LONG_NEW,
                                              compute_dtype=torch.float32, collect_logits=True)
    torch.cuda.synchronize()
    t_chunked = time.monotonic() - t0
    cache = init_cache(ccfg, 1, 1, dtype=torch.float32, device="cuda")
    t0 = time.monotonic()
    for i in range(RWKV_PROMPT):
        step, cache = decode_step(cparams, ccfg, cache, prompt[:, i], compute_dtype=torch.float32)
    first, out = step, [torch.argmax(step, dim=-1)]
    for _ in range(RWKV_LONG_NEW):
        step, cache = decode_step(cparams, ccfg, cache, out[-1], compute_dtype=torch.float32)
        out.append(torch.argmax(step, dim=-1))
    torch.cuda.synchronize()
    t_scan = time.monotonic() - t0
    scan_tok = torch.stack(out, 1).to(torch.int32)
    rel = rel_max(dense_logits[0, 0], first[0])
    print(f"rwkv6 at {RWKV_SCAN_LAYERS} layers, a {RWKV_PROMPT}-token prompt, digital, "
          f"{RWKV_LONG_NEW} new: chunked prefill "
          f"{t_chunked:.2f} s, token by token {t_scan:.2f} s; tokens {dense_tok[0].tolist()} vs "
          f"{scan_tok[0].tolist()}; first-token logits max rel {rel:.3e}  [{card}]")
    if not torch.equal(dense_tok, scan_tok) or not rel <= 1e-4:
        raise AssertionError("rwkv6: the chunked prefill and token-by-token decoding disagree")
    del params, cparams, cache
    torch.cuda.empty_cache()

    # kernels against their plain versions, per-call against programmed:
    # the default mode at CUT_LAYERS layers (full width, the head included)
    cut = RWKV_LAUNCH + ["--layers", str(CUT_LAYERS), "--gen", str(CUT_GEN)]
    ops.reset_counters()
    on = launcher.main(cut + ["--kernels", "on"], collect_logits=True)
    k1_on = ops.COUNTERS["fused_sliced_matmul"].count
    t0 = time.monotonic()
    off = launcher.main(cut + ["--kernels", "off"], collect_logits=True)
    torch.cuda.synchronize()
    t_off = time.monotonic() - t0
    if (k1_on != (8 * CUT_LAYERS + 1) * (CUT_GEN + 1)
            or ops.COUNTERS["fused_sliced_matmul"].count != k1_on):
        raise AssertionError("rwkv6: --kernels on launched other than the formula's K1, or "
                             "--kernels off launched one")
    two = RWKV_LAUNCH + ["--layers", str(CHECK_LAYERS)]
    on2 = launcher.main(two + ["--kernels", "on"], collect_logits=True)
    per_call = launcher.main(two + ["--per_call"], collect_logits=True)
    torch.cuda.synchronize()
    for label, ref, other, depth in (("--kernels off", on, off, CUT_LAYERS),
                                     ("--per_call", on2, per_call, CHECK_LAYERS)):
        if not (torch.equal(ref[0], other[0]) and torch.equal(ref[1], other[1])):
            raise AssertionError(f"rwkv6 at {depth} layers: {label} differs from the "
                                 "programmed run with the kernels")
        print(f"rwkv6 at {depth} layers: {label} gives the tokens and all "
              f"{ref[1].shape[0] * ref[1].shape[1]} logit rows of the programmed run with the "
              "kernels, bit for bit")
    print(f"rwkv6 at {CUT_LAYERS} layers with the plain versions: {t_off:.1f} s  [{card}]")


# ---------------------------------------------------------------------------
# the MoE family: qwen3-moe-235b-a22b at full width, its first layer
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-235b-a22b"
# one of its 94 layers: the layer's 2,416 M expert weights, 71 M attention
# weights and the 622 M-weight vocab head, 49.75 GB programmed (16 B a
# weight) beside 14.93 GB of float32 params, fill the card
MOE_LAUNCH = ["--arch", MOE_ARCH, "--layers", "1", "--policy", "mem_faithful", "--batch", "4",
              "--prompt_len", "16", "--gen", "16"]
MOE_REQUESTS = ["--arch", MOE_ARCH, "--layers", "1", "--policy", "mem_faithful", "--requests",
                "8", "--slots", "4", "--gen", "8"]
MOE_SMOKE = ["--arch", MOE_ARCH, "--smoke", "--policy", "mem_faithful"]
MOE_PROFILED = 4  # decode steps of the profiled generation
MOE_SUB = (0, 37, 64, 127)  # the experts of the sub-stack held against the plain K1


def stack_bound(hit: int, rows: int, e: int, m: int, k: int, n: int, padded: bool = False):
    """K1's bound for one call on an expert stack of ``e`` experts of
    (k, n) weights, ``m`` buffer rows an expert (int8 x int8: 16 slice
    pairs, 32 operations a row-weight, 16 B of slices a weight): the
    slices of the ``hit`` experts that hold a routed row, the whole input
    and output once, and the operations of the ``rows`` routed rows (a
    zero padding row gives exact zeros with no work, as the plain version
    skips an expert with none).  ``padded`` counts every buffer row and
    expert instead, as the kernel computes them."""
    if padded:
        hit, rows = e, e * m
    return bound_ms(16 * hit * k * n + 4 * e * m * (k + n), 32 * rows * k * n)


def moe_step_bound(cfg, batch: int, calls, padded: bool = False):
    """K1's bound for one decode step of ``batch`` rows: the attention
    projections and the vocab head on ``batch`` rows, each bound by its
    bytes or its operations, and the step's expert-stack ``calls``
    (experts hit, routed rows, E, M, K, N) by :func:`stack_bound`.
    Returns the sum, that of the expert stacks and that of the rest."""
    d, v = cfg.d_model, cfg.vocab
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    rest = sum(bound_ms(16 * k * n + 4 * batch * (k + n), 32 * batch * k * n)[0]
               for k, n in ((d, qd), (d, kvd), (d, kvd), (qd, d), (d, v)))
    experts = sum(stack_bound(*c, padded=padded)[0] for c in calls)
    return experts + rest, experts, rest


def stack_calls(fn) -> list:
    """Run ``fn()`` with K1's calls on expert stacks recorded, in order:
    (experts with a routed row, routed rows, E, M, K, N) of each.  Each
    record waits for the card: not for a timed run."""
    from repro_torch.kernels import sliced_matmul as sm

    seen, inner = [], sm.fused_sliced_matmul_cuda

    def record(x, ws, sw, **kw):
        if x.dim() == 3:
            hit = x.ne(0).any(dim=2)
            seen.append((int(hit.any(dim=1).sum()), int(hit.sum()), *x.shape, ws.shape[-1]))
        return inner(x, ws, sw, **kw)

    sm.fused_sliced_matmul_cuda = record
    try:
        fn()
    finally:
        sm.fused_sliced_matmul_cuda = inner
    return seen


def check_stack(timer, prog_experts, cfg, card, summary):
    """K1 over a full-width expert stack (qwen3-moe's ``wi``, 128 experts
    of 4,096 x 1,536, M = 32 rows an expert as at a decode step of batch 4:
    live rows first, the rest the zero padding row): one launch bit-equal
    to the single-weight K1 on every expert alone (``dynamic`` over 128-row
    tiles, the default mode's, and ``dynamic_row``, the ``ServeLoop``'s),
    and on a sub-stack of ``MOE_SUB`` experts of ``wi`` and ``wo``
    bit-equal to the plain version; the stacked call and the 128 single
    calls timed, the stacked call and the plain version on the sub-stack
    timed.  Its bound counts the routed rows (:func:`stack_bound`)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sliced_matmul as sm
    from repro_torch.launch.dryrun import make_policy

    dcfg = make_policy("mem_faithful").default
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    m = 32
    g = torch.Generator(device="cuda").manual_seed(21)

    def inputs(experts, k):
        x = torch.zeros((experts, m, k), device="cuda")
        for i in range(experts):
            live = 1 + (7 * i) % 6  # 1-6 routed rows, then padding
            x[i, :live] = torch.randn((live, k), generator=g, device="cuda")
        return x

    wi = prog_experts["wi"]
    slices, scale = wi.slices[0], wi.scale[0]  # the one layer
    x = inputs(e, d)
    for adc in ("dynamic", "dynamic_row"):
        kw = dict(input_spec=dcfg.input_spec, weight_spec=dcfg.weight_spec,
                  array_size=dcfg.array_size, rdac=dcfg.rdac, radc=dcfg.radc, adc_mode=adc,
                  bm=128)
        y = ops.fused_sliced_matmul(x, slices, scale, **kw)
        for i in range(e):
            one = sm.fused_sliced_matmul_cuda(x[i], slices[i], scale[i], **kw)
            if not torch.equal(y[i], one):
                raise AssertionError(f"stacked K1 {adc}: expert {i} differs from K1 alone by "
                                     f"{float((y[i] - one).abs().max())}")
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"stacked K1 {adc}: non-finite output")
    print(f"stacked K1 (wi, {e} experts of {d} x {f}, M = {m} an expert, dynamic and "
          f"dynamic_row): each expert bit-equal to K1 on it alone")
    kw = dict(input_spec=dcfg.input_spec, weight_spec=dcfg.weight_spec,
              array_size=dcfg.array_size, rdac=dcfg.rdac, radc=dcfg.radc, adc_mode="dynamic",
              bm=128)
    t_stack = timer(lambda: ops.fused_sliced_matmul(x, slices, scale, **kw))
    t_loop = timer(lambda: [sm.fused_sliced_matmul_cuda(x[i], slices[i], scale[i], **kw)
                            for i in range(e)])
    hit = x.ne(0).any(dim=2)
    rows, live = int(hit.sum()), int(hit.any(dim=1).sum())
    b, by = stack_bound(live, rows, e, m, d, f)
    pb, pby = stack_bound(live, rows, e, m, d, f, padded=True)
    plan = sm.plan_k1(m, d, f, dcfg.array_size[0], 4, 4, "dynamic", 128, dcfg.radc)
    print(f"stacked K1 wi ({e} x {plan.ctas} CTAs, one launch): {t_stack:.3f} ms; {e} single "
          f"launches {t_loop:.3f} ms; bound {b:.3f} ms ({by}; the {rows} routed rows of "
          f"{e * m}, {live} experts hit), {b / t_stack:.1%} of it; the bound of every buffer row "
          f"as the kernel computes them {pb:.3f} ms ({pby})  [{card}]")

    idx = torch.tensor(MOE_SUB, device="cuda")
    plain_ms = sub_ms = 0.0
    for name, k in (("wi", d), ("wo", f)):
        pw = prog_experts[name]
        ss, sc = pw.slices[0][idx], pw.scale[0][idx]
        xs = inputs(len(MOE_SUB), k)
        y = ops.fused_sliced_matmul(xs, ss, sc, **kw)
        t0 = time.monotonic()
        yp = ops.fused_sliced_matmul(xs, ss, sc, kernels=False, **kw)
        torch.cuda.synchronize()
        t_plain = (time.monotonic() - t0) * 1e3
        if not torch.equal(y, yp):
            raise AssertionError(f"stacked K1 {name} sub-stack: differs from the plain version by "
                                 f"{float((y - yp).abs().max())}")
        t_sub = timer(lambda: ops.fused_sliced_matmul(xs, ss, sc, **kw))
        if name == "wi":
            plain_ms, sub_ms = t_plain, t_sub
        print(f"stacked K1 {name} on experts {MOE_SUB} (M = {m}, padding rows included): "
              f"bit-equal to the plain version; kernel {t_sub:.3f} ms, plain {t_plain:.1f} ms "
              f"on these inputs  [{card}]")
        del ss, sc
    # `ms` and `bound_ms` are of the 128-expert call; `plain_ms` and
    # `sub_ms` of the same MOE_SUB sub-stack of `wi`
    summary["fused_sliced_matmul_stack"] = dict(
        max_abs_err=0.0, ms=t_stack, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        library_ms=None, extra=dict(plain_experts=len(MOE_SUB), sub_ms=sub_ms,
                                    bound_ms_padded=pb))


MOE_LONG = 3072  # a prompt whose stacked K1 partials (24.2 GB at wi) exceed what is free
MOE_LONG_NEW = 4


def moe_long_prompt(params, prog, cfg, pol, card):
    """A ``MOE_LONG``-token prompt at batch 4 through the dense path's
    prefill and decode steps (``MOE_LONG_NEW`` new tokens) beside the
    programmed layer: the stacked K1's K-block partials of 4 B x E x nk x
    M x N (960 buffer rows an expert) do not fit what is free, so its
    calls run in row groups of whole 128-row ``dynamic`` tiles
    (``kernels/sliced_matmul.py::row_groups``).  Prints TTFT, peak memory
    and the groups; holds the prefill's stacked ``wi`` call on
    ``MOE_SUB``'s experts against K1 on each of them alone, bit for bit."""
    from repro_torch.core.prng import PRNGKey, randint
    from repro_torch.kernels import sliced_matmul as sm
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    seen, inner = [], sm.fused_sliced_matmul_cuda
    idx = torch.tensor(MOE_SUB, device="cuda")

    def record(x, ws, sw, **kw):
        before = sm.stack_counter.count
        out = inner(x, ws, sw, **kw)
        if x.dim() == 3:
            if not seen:  # the prefill's wi: MOE_SUB's experts, kept for the check
                seen.append((x[idx].clone(), ws[idx], sw[idx], out[idx].clone(), kw))
            seen.append((tuple(x.shape), sm.stack_counter.count - before))  # one launch a group
        return out

    prompts = randint(PRNGKey(3), (4, MOE_LONG), 0, cfg.vocab, device="cuda")
    prefill = make_prefill_step(cfg, pol, max_len=MOE_LONG + MOE_LONG_NEW + 1,
                                compute_dtype=torch.float32, cache_dtype=torch.float32)
    decode = make_decode_step(cfg, pol, compute_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    sm.fused_sliced_matmul_cuda = record
    try:
        t0 = time.monotonic()
        logits, cache = prefill(params, {"tokens": prompts}, prog)
        toks = [torch.argmax(logits, dim=-1)]
        torch.cuda.synchronize()
        ttft = time.monotonic() - t0
        for _ in range(MOE_LONG_NEW):
            logits, cache = decode(params, cache, toks[-1], prog)
            toks.append(torch.argmax(logits, dim=-1))
        torch.cuda.synchronize()
        itl = (time.monotonic() - t0 - ttft) / MOE_LONG_NEW
    finally:
        sm.fused_sliced_matmul_cuda = inner
    out = torch.stack(toks, dim=1)
    del cache, logits
    if out.shape != (4, MOE_LONG_NEW + 1) or not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"{MOE_ARCH} {MOE_LONG}-token prompt: tokens {out}")
    x, ws, sw, y, kw = seen[0]
    stacked = seen[1:4]  # the prefill's wi, wg, wo
    groups = [g for _, g in stacked]
    print(f"{MOE_ARCH} {MOE_LONG}-token prompt, batch 4, mem_faithful, {MOE_LONG_NEW} new: TTFT "
          f"{ttft * 1e3:.1f} ms, ITL {itl * 1e3:.1f} ms; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the prefill's "
          f"stacked K1 calls (wi/wg/wo, {stacked[0][0][0]} experts x {stacked[0][0][1]} buffer "
          f"rows) in {'/'.join(map(str, groups))} row groups; tokens "
          f"{out[0].tolist()}  [{card}]")
    if groups[0] < 2:
        raise AssertionError(f"{MOE_ARCH} {MOE_LONG}-token prompt: the stacked wi ran in one "
                             "group; the check needs a call past the free memory's half")
    for i, e in enumerate(MOE_SUB):
        alone = inner(x[i], ws[i], sw[i], **kw)
        if not torch.equal(alone, y[i]):
            raise AssertionError(f"{MOE_ARCH} {MOE_LONG}-token prompt: the grouped stacked wi's "
                                 f"expert {e} differs from K1 on it alone by "
                                 f"{float((alone - y[i]).abs().max())}")
    print(f"  the grouped stacked wi call ({x.shape[1]} rows an expert): experts {MOE_SUB} "
          "bit-equal to K1 on each alone")
    del seen, x, ws, sw, y, out
    sm._workspace.clear()  # the kept workspace of the prompt's calls: freed for the phases after
    torch.cuda.empty_cache()


def moe(timer, card, counters, summary, floor):
    """qwen3-moe-235b-a22b, its token-choice top-8 MoE over 128 experts:
    at qwen3-moe-smoke widths the launcher's default mode and ``--requests``
    with the kernels bit-equal to their plain versions (tokens and every
    logit row); K2 / K3 at its head layout (64 query heads over 4 KV heads
    of 128) bit-equal to their plain versions and timed; at full width,
    its first layer of 94 (``--layers 1``), under ``make_policy
    ("mem_faithful")``: the dense ``greedy_generate`` (batch 4, prompt 16,
    16 new) timed and profiled (init, programming, bytes, peak memory,
    TTFT, ITL, tok/s, idle share, K1 device ms a decode step against its
    bound), a ``MOE_LONG``-token prompt whose stacked K1 runs in row
    groups (``moe_long_prompt``), the stacked K1 on the programmed expert
    stacks against the single K1 and the plain version (``check_stack``),
    then the
    launcher's default mode (K1 5 x 17, the stacked K1 3 x 17, K6 by the
    formula) and ``--requests 8 --slots 4 --gen 8`` (K1, the stacked K1,
    K2, K3 launched, every request finished)."""
    from repro_torch.configs import get
    from repro_torch.core.prng import PRNGKey, randint
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.models import init_params, program_params, programmed_byte_size
    from repro_torch.models.common import tree_leaves
    from repro_torch.serve import greedy_generate

    cfg = get(MOE_ARCH).replace(n_layers=1)
    # the MoE path with the kernels against their plain versions, smoke widths
    small = MOE_SMOKE + ["--batch", "2", "--prompt_len", "8", "--gen", "4"]
    ops.reset_counters()
    on = launcher.main(small + ["--kernels", "on"], collect_logits=True)
    n_stack = ops.COUNTERS["fused_sliced_matmul_stack"].count
    off = launcher.main(small + ["--kernels", "off"], collect_logits=True)
    if (n_stack != 3 * 2 * 5 or ops.COUNTERS["fused_sliced_matmul_stack"].count != n_stack
            or not (torch.equal(on[0], off[0]) and torch.equal(on[1], off[1]))):
        raise AssertionError(f"qwen3-moe-smoke default mode: kernels {on[0].tolist()} against "
                             f"plain {off[0].tolist()}, {n_stack} stacked launches")
    reqs = MOE_SMOKE + ["--requests", "4", "--slots", "2", "--gen", "4", "--prompt_len", "12",
                        "--prefill_chunk", "8"]
    rep_on = launcher.main(reqs + ["--kernels", "on"], collect_logits=True)
    rep_off = launcher.main(reqs + ["--kernels", "off"], collect_logits=True)
    for a, b in zip(rep_on.results, rep_off.results):
        same = all(np.array_equal(p, q) for p, q in zip(a.logits, b.logits))
        if a.tokens != b.tokens or not same:
            raise AssertionError(f"qwen3-moe-smoke --requests: request {a.rid} differs from the "
                                 "plain versions")
    print(f"qwen3-moe-smoke with the kernels: the default mode's tokens and "
          f"{on[1].shape[0] * on[1].shape[1]} logit rows, and --requests' tokens and logits of "
          f"{len(rep_on.results)} requests, bit-equal to the plain versions  [{card}]")
    del on, off, rep_on, rep_off

    print(f"K2 / K3 at {MOE_ARCH}'s heads ({cfg.n_heads} query heads over {cfg.n_kv_heads} KV "
          f"heads of {cfg.head_dim}):")
    check_k2_k3(timer, cfg, {}, card, floor)

    # full width, its first layer: the generation timed and profiled
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = init_params(cfg, PRNGKey(0), device="cuda")
    torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    pol = make_policy("mem_faithful")
    t0 = time.monotonic()
    prog = program_params(params, cfg, pol, PRNGKey(0))
    torch.cuda.synchronize()
    t_prog = time.monotonic() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{MOE_ARCH} (1 of 94 layers): init {n_params / 1e6:.1f} M params in {t_init:.2f} s; "
          f"programmed {programmed_byte_size(prog) / 1e6:.1f} MB of crossbar state in "
          f"{t_prog:.2f} s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB  [{card}]")
    prompts = randint(PRNGKey(1), (4, 16), 0, cfg.vocab, device="cuda")

    def generate(n):
        return greedy_generate(params, cfg, prompts, n, policy=pol,
                               compute_dtype=torch.float32, programmed=prog)

    generate(1)  # warm-up
    wall = {}
    for n in (0, MOE_PROFILED, 16):
        t0 = time.monotonic()
        out = generate(n)
        torch.cuda.synchronize()
        wall[n] = time.monotonic() - t0
    if out.shape != (4, 17) or not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"{MOE_ARCH}: tokens {out}")
    pre, whole = wall[0], wall[16]
    print(f"{MOE_ARCH} dense greedy_generate, mem_faithful (dynamic ADC), batch 4, prompt 16: "
          f"TTFT (prefill of 64 rows and the first token) {pre * 1e3:.1f} ms, 16 new tokens in "
          f"{whole * 1e3:.1f} ms: {4 * 16 / whole:.2f} tok/s, ITL {(whole - pre) / 16 * 1e3:.1f} "
          f"ms; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    g_pre = device_groups(lambda: generate(0))
    g_all = device_groups(lambda: generate(MOE_PROFILED))
    print_busy(f"{MOE_ARCH}'s generation (the prefill and {MOE_PROFILED} decode steps)", g_all,
               wall[MOE_PROFILED] * 1e3, card, k1_calls=8 * (MOE_PROFILED + 1))
    # the bound of a decode step counts the rows routed in this run's steps
    calls = stack_calls(lambda: generate(MOE_PROFILED))
    if len(calls) != 3 * (1 + MOE_PROFILED):
        raise AssertionError(f"{MOE_ARCH}: {len(calls)} stacked K1 calls in the prefill and "
                             f"{MOE_PROFILED} decode steps")
    steps = [calls[3 * i:3 * i + 3] for i in range(1, 1 + MOE_PROFILED)]
    b_all, b_exp, b_rest = (sum(x) / MOE_PROFILED for x in zip(
        *(moe_step_bound(cfg, 4, c) for c in steps)))
    p_all, p_exp, _ = moe_step_bound(cfg, 4, steps[0], padded=True)
    hits = ", ".join("/".join(str(c[0]) for c in st) for st in steps)
    rows = ", ".join("/".join(str(c[1]) for c in st) for st in steps)
    print(f"  decode steps' expert stacks (wi/wg/wo, {steps[0][0][2]} experts x "
          f"{steps[0][0][3]} buffer rows): experts hit {hits}; routed rows {rows}")
    if g_pre and g_all:
        k1_pre = g_pre.get("K1", (0.0, 0))[0]
        k1 = (g_all.get("K1", (0.0, 0))[0] - k1_pre) / MOE_PROFILED
        print(f"  K1 in the prefill (64 rows; the experts' buffers 32 rows each): {k1_pre:.3f} ms "
              "device")
        print(f"  K1 a decode step: {k1:.3f} ms device against its bound {b_all:.3f} ms "
              f"(the routed rows: experts {b_exp:.3f} ms, attention and head {b_rest:.3f} ms), "
              f"{b_all / k1:.1%} of it; the bound of every buffer row as the kernel computes "
              f"them {p_all:.3f} ms (experts {p_exp:.3f} ms)  [{card}]")
    else:
        print(f"  K1 a decode step: not measured; its bound {b_all:.3f} ms (every buffer row: "
              f"{p_all:.3f} ms)")
    moe_long_prompt(params, prog, cfg, pol, card)
    check_stack(timer, prog["blocks"]["seg0"]["moe"]["experts"], cfg, card, summary)
    del params, prog, out
    torch.cuda.empty_cache()

    # the launcher: its default mode, then --requests
    ops.reset_counters()
    tokens = launcher.main(MOE_LAUNCH)
    torch.cuda.synchronize()
    launched = path_launches()
    k6 = (5 + 3 * cfg.moe.n_experts) * pol.default.weight_spec.n_slices
    print(f"{MOE_ARCH} launch default mode: launches {launched}; expected K1 {5 * 17}, stacked "
          f"K1 {3 * 17}, K6 {k6}")
    if (launched["fused_sliced_matmul"] != 5 * 17
            or launched["fused_sliced_matmul_stack"] != 3 * 17
            or launched["program_noise"] != k6 or launched["paged_decode_attention"]
            or launched["paged_chunk_attention"]):
        raise AssertionError(f"{MOE_ARCH} launch default mode: launches {launched}")
    if tokens.shape != (4, 17) or not bool(((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"{MOE_ARCH} launch default mode: tokens {tokens}")
    for name, n in launched.items():
        counters[name] = counters.get(name, 0) + n
    del tokens
    torch.cuda.empty_cache()
    ops.reset_counters()
    rep = launcher.main(MOE_REQUESTS)
    torch.cuda.synchronize()
    launched = path_launches()
    print(f"{MOE_ARCH} launch --requests 8 --slots 4: launches {launched}; {rate_line(rep)}  "
          f"[{card}]")
    _need_launched(f"{MOE_ARCH} --requests", launched,
                   ("fused_sliced_matmul", "fused_sliced_matmul_stack", "paged_decode_attention",
                    "paged_chunk_attention"))
    for r in rep.results:
        if r.finish_reason != "length" or len(r.tokens) != 8:
            raise AssertionError(f"{MOE_ARCH} --requests: request {r.rid}: {r.finish_reason}")
    for name, n in launched.items():
        counters[name] = counters.get(name, 0) + n
    del rep
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the hybrid jamba-v0.1-52b: Mamba and attention in period groups
# ---------------------------------------------------------------------------

JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_SMOKE = ["--arch", JAMBA_ARCH, "--smoke", "--policy", "mem_faithful", "--batch", "2",
               "--prompt_len", "8", "--gen", "2"]
JAMBA_PROFILED = 4  # decode steps of the timed and profiled generation
JAMBA_LONG = 1024  # one long faithful prompt at batch 1
JAMBA_LONG_NEW = 8
K1_CHECK_64 = 40_000_000  # weights up to which K1 is also checked at M = 64 (plain ~0.11 s/M)
# row-weights up to which K1 is also checked at the largest M the path calls it with (the
# plain K1 ~2 ns a row-weight: ~7 s at whisper's encoder MLP, 6,000 x 1,536 x 384)
K1_CHECK_ROWS = 4_000_000_000


def jamba_full(cfg):
    """The full-width period one H100 holds: one period of 8 layers (the
    reference asserts whole periods) with jamba's dense MLP in every layer
    (``hybrid_moe_idx=()``): the published period's four MoE layers of 16
    experts take ~208 GB of faithful slices."""
    return cfg.replace(n_layers=cfg.hybrid_period, hybrid_moe_idx=())


def jamba_shapes(cfg) -> list:
    """(K, N) of every single-weight K1 call of one forward: per period
    the Mamba projections (in, z, x, dt, out) of its Mamba layers, the
    attention's q / k / v / o, the MLP of its non-MoE layers; the head."""
    from repro_torch.models.ssm import _mamba_dims

    d, ff = cfg.d_model, cfg.d_ff
    d_in, r, n, _ = _mamba_dims(cfg)
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = []
    for i in range(cfg.n_layers):
        kind, moe = cfg.layer_kind(i)
        shapes += ([(d, qd), (d, kvd), (d, kvd), (qd, d)] if kind == "attn" else
                   [(d, d_in), (d, d_in), (d_in, r + 2 * n), (r, d_in), (d_in, d)])
        shapes += [] if moe else [(d, ff), (d, ff), (ff, d)]
    return shapes + [(d, cfg.vocab)]


def jamba(timer, card, counters):
    """jamba-v0.1-52b's hybrid period through ``repro_torch.launch.serve``
    and the dense ``greedy_generate``: (a) jamba-smoke, its MoE layers
    included, in the launcher's default mode under ``mem_faithful`` with
    the kernels against ``--kernels off`` (tokens and every logit row
    bit-equal; K1 and the stacked K1 by the formula) and ``--requests``
    refused; (b) at full width, one period with the dense MLP
    (:func:`jamba_full`), batch 4, prompt 16, 16 new (K1 and K6 by the
    formula): init, programming, then ``JAMBA_PROFILED`` new timed and
    profiled (:func:`_generation`); (c) one ``JAMBA_LONG``-token faithful
    prompt at batch 1: the prefill, and K1's and the selective scan's
    share of it; (d) K1 at each distinct (K, N) of the path
    (:func:`jamba_shapes`) bit-equal to its plain version
    (:func:`check_k1_sites`)."""
    from repro_torch.configs import get, get_smoke
    from repro_torch.core.prng import PRNGKey, randint
    from repro_torch.kernels import ops
    from repro_torch.kernels import sliced_matmul as sm
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.models import init_params, program_params, programmed_byte_size, ssm
    from repro_torch.models.common import tree_leaves
    from repro_torch.serve import greedy_generate
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    # (a) jamba-smoke, kernels against plain, in the launcher's default mode
    t0 = time.monotonic()
    scfg = get_smoke(JAMBA_ARCH)
    ops.reset_counters()
    on = launcher.main(JAMBA_SMOKE + ["--kernels", "on"], collect_logits=True)
    n_k1, n_st = (ops.COUNTERS[k].count for k in ("fused_sliced_matmul",
                                                   "fused_sliced_matmul_stack"))
    off = launcher.main(JAMBA_SMOKE + ["--kernels", "off"], collect_logits=True)
    fwd = 2 + 1  # the prefill and 2 decode steps
    n_moe = sum(scfg.layer_kind(i)[1] for i in range(scfg.n_layers))
    if (n_k1 != len(jamba_shapes(scfg)) * fwd or n_st != 3 * n_moe * fwd
            or ops.COUNTERS["fused_sliced_matmul"].count != n_k1
            or ops.COUNTERS["fused_sliced_matmul_stack"].count != n_st):
        raise AssertionError(f"jamba-smoke: K1 {n_k1}, stacked K1 {n_st} launches (expected "
                             f"{len(jamba_shapes(scfg)) * fwd}, {3 * n_moe * fwd}; --kernels "
                             "off launches none)")
    if not (torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])):
        raise AssertionError(f"jamba-smoke: kernels {on[0].tolist()} against plain "
                             f"{off[0].tolist()}")
    try:
        launcher.main(JAMBA_SMOKE + ["--requests", "2"])
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise AssertionError("jamba-smoke: --requests did not refuse a hybrid")
    print(f"jamba-smoke (mem_faithful, its {n_moe} MoE layers included) in the launcher's "
          f"default mode: tokens and {on[1].shape[0] * on[1].shape[1]} logit rows bit-equal to "
          f"--kernels off; K1 {n_k1}, stacked K1 {n_st} launches; --requests refused "
          f"({refused!r}); {time.monotonic() - t0:.1f} s  [{card}]")
    del on, off

    # (b) full width: one period with the dense MLP
    cfg = jamba_full(get(JAMBA_ARCH))
    print(f"{JAMBA_ARCH} at full width (d_model {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, Mamba d_inner "
          f"{ssm._mamba_dims(cfg)[0]}, vocab {cfg.vocab}), cut: {cfg.n_layers} of 32 layers (one "
          "period; the reference takes whole periods) and the dense MLP in place of the 16 "
          "experts of the period's 4 MoE layers (hybrid_moe_idx=(): the published period's "
          "~208 GB of faithful slices exceed one H100)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = init_params(cfg, PRNGKey(0), device="cuda")
    torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    pol = make_policy("mem_faithful")
    shapes = jamba_shapes(cfg)
    ops.reset_counters()
    t0 = time.monotonic()
    prog = program_params(params, cfg, pol, PRNGKey(0))
    torch.cuda.synchronize()
    t_prog = time.monotonic() - t0
    launched = path_launches()  # programming: K6 once a slice plane of every weight
    prompts = randint(PRNGKey(1), (4, 16), 0, cfg.vocab, device="cuda")

    def generate(n):
        return greedy_generate(params, cfg, prompts, n, policy=pol,
                               compute_dtype=torch.float32, programmed=prog)

    generate(1)  # warm-up
    ops.reset_counters()
    out = generate(16)  # the main path's run: its launches are counted
    torch.cuda.synchronize()
    for name, n in path_launches().items():
        launched[name] += n
    k6 = len(shapes) * pol.default.weight_spec.n_slices
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{JAMBA_ARCH} (one period): init {n_params / 1e6:.1f} M params in {t_init:.2f} s; "
          f"programmed {programmed_byte_size(prog) / 1e6:.1f} MB of crossbar state in "
          f"{t_prog:.2f} s; launches of the programming and the generation {launched} "
          f"(expected K1 {len(shapes)} x 17, K6 {k6})  [{card}]")
    if (launched["fused_sliced_matmul"] != len(shapes) * 17 or launched["program_noise"] != k6
            or launched["fused_sliced_matmul_stack"] or launched["paged_decode_attention"]
            or launched["paged_chunk_attention"]):
        raise AssertionError(f"{JAMBA_ARCH}: launches {launched}")
    if out.shape != (4, 17) or not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"{JAMBA_ARCH}: tokens {out}")
    for name, n in launched.items():
        counters[name] = counters.get(name, 0) + n
    head = [(cfg.d_model, cfg.vocab, 4)]  # on each sequence's last row
    calls_pre = [(k, n, 4 * 16) for k, n in shapes[:-1]] + head
    calls_step = [(k, n, 4) for k, n in shapes]
    _generation(JAMBA_ARCH, generate, calls_pre, calls_step, JAMBA_PROFILED, card)

    # (c) one long faithful prompt: the prefill, K1's and the scan's share
    scan_inner, k1_inner = ssm._selective_scan, sm.fused_sliced_matmul_cuda
    spans = {"scan": [], "K1": []}
    first_scan = []

    def timed_call(label, fn):
        def call(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            spans[label].append((s, e))
            if label == "scan" and not first_scan:
                first_scan.append(tuple(t.clone() for t in a))
            return out
        return call

    long_prompt = randint(PRNGKey(2), (1, JAMBA_LONG), 0, cfg.vocab, device="cuda")
    prefill = make_prefill_step(cfg, pol, compute_dtype=torch.float32, cache_dtype=torch.float32)
    decode = make_decode_step(cfg, pol, compute_dtype=torch.float32)
    ssm._selective_scan = timed_call("scan", scan_inner)
    sm.fused_sliced_matmul_cuda = timed_call("K1", k1_inner)
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, cache = prefill(params, {"tokens": long_prompt}, prog)
        torch.cuda.synchronize()
        t_pre = time.monotonic() - t0
    finally:
        ssm._selective_scan, sm.fused_sliced_matmul_cuda = scan_inner, k1_inner
    k1_ms = sum(s.elapsed_time(e) for s, e in spans["K1"])
    scan_ms = sum(s.elapsed_time(e) for s, e in spans["scan"])
    toks = [torch.argmax(logits, dim=-1)]
    t0 = time.monotonic()
    for _ in range(JAMBA_LONG_NEW):
        logits, cache = decode(params, cache, toks[-1], prog)
        toks.append(torch.argmax(logits, dim=-1))
    torch.cuda.synchronize()
    itl = (time.monotonic() - t0) / JAMBA_LONG_NEW
    scan_groups = device_groups(lambda: scan_inner(*first_scan[0]))
    n_scan = sum(n for _, n in scan_groups.values())
    # every projection on the prompt's rows, the head on its last
    b_pre = k1_bound([(k, n, JAMBA_LONG) for k, n in shapes[:-1]]
                     + [(cfg.d_model, cfg.vocab, 1)])[0]
    print(f"{JAMBA_ARCH} {JAMBA_LONG}-token prompt, batch 1, mem_faithful, {JAMBA_LONG_NEW} "
          f"new: prefill {t_pre * 1e3:.1f} ms, of it K1 {k1_ms:.1f} ms device in "
          f"{len(spans['K1'])} calls ({k1_ms / (t_pre * 1e3):.1%}; bound {b_pre:.1f} ms, "
          f"operations) and the selective scan {scan_ms:.1f} ms on the card's clock over "
          f"{len(spans['scan'])} calls ({scan_ms / (t_pre * 1e3):.1%}; {n_scan} launches a "
          f"call); ITL {itl * 1e3:.1f} ms; tokens {torch.stack(toks, 1)[0].tolist()}  [{card}]")
    if not bool(torch.isfinite(logits).all()) or len(spans["scan"]) != 7:
        raise AssertionError(f"{JAMBA_ARCH} long prompt: non-finite logits or "
                             f"{len(spans['scan'])} scans")
    del cache, logits, first_scan, spans

    # (d) K1 at each projection shape of the path, on its programmed state, against plain
    check_k1_sites(timer, JAMBA_ARCH, params, prog, calls_pre, pol.default, card)
    del params, prog
    torch.cuda.empty_cache()


WHISPER = "whisper-tiny"
PHI3V = "phi-3-vision-4.2b"
WHISPER_LAUNCH = ["--arch", WHISPER, "--policy", "mem_faithful", "--batch", "4", "--prompt_len",
                  "16", "--gen", "16"]
# of 32: the whole model's 59.6 GB of slices and 15.3 GB of params fill the card; 4
# keeps the script in its time limit
PHI3V_LAYERS = 4
PHI3V_BATCH, PHI3V_PROMPT, PHI3V_NEW = 2, 16, 8
ENCDEC_SMOKE = ["--smoke", "--policy", "mem_faithful", "--batch", "2", "--prompt_len", "8",
                "--gen", "2"]


def encdec_calls(cfg, rows: int, frame_rows: int = 0) -> list:
    """(K, N, M) of every K1 call of one forward of ``rows`` decoder rows
    but the head (the caller's: on each sequence's last row): with
    ``frame_rows`` (a prefill) per encoder layer q / k / v / o and the MLP
    over those rows; per decoder layer q / k / v / o, the MLP and an
    encoder-decoder's cross-attention (q and o over the decoder's rows;
    with ``frame_rows``, k and v over the frames)."""
    d, ff = cfg.d_model, cfg.d_ff
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    attn = [(d, qd), (d, kvd), (d, kvd), (qd, d)]
    mlp = [(d, ff), (d, ff), (ff, d)]
    calls = []
    if cfg.encoder is not None and frame_rows:
        calls += [(k, n, frame_rows) for k, n in attn + mlp] * cfg.encoder.n_layers
    for _ in range(cfg.n_layers):
        calls += [(k, n, rows) for k, n in attn + mlp]
        if cfg.encoder is not None:
            calls += [(d, qd, rows), (qd, d, rows)]
            calls += [(d, kvd, frame_rows), (d, kvd, frame_rows)] if frame_rows else []
    return calls


def k1_bound(calls) -> tuple:
    """K1's bound over ``calls`` of (K, N, M): each call its slices (16 B a
    weight, the columns padded to whole 128-wide tiles, as programmed),
    its input and output, or its 32 operations a row-weight, whichever
    is longer; summed.  Returns (ms, GB of slices, what bounds most)."""
    ms, by_ops, gb = 0.0, 0.0, 0.0
    for k, n, m in calls:
        np_ = -(-n // 128) * 128
        t, by = bound_ms(16 * k * np_ + 4 * m * (k + n), 32 * m * k * n)
        ms += t
        by_ops += t if by == "operations" else 0.0
        gb += 16 * k * np_ / 1e9
    return ms, gb, "operations" if by_ops > ms / 2 else "bytes"


def _walk_sites(sites: dict, p, q, path: str):
    """Add to ``sites`` each programmed projection of ``q`` (``p``'s
    params) whose shape it lacks: ``(K, N) -> (path, params, programmed)``."""
    from repro_torch.core.dpe import PreparedWeight

    if isinstance(q, PreparedWeight):
        sites.setdefault(tuple(p["w"].shape), (path, p, q))
    elif isinstance(q, dict):
        for key, sub in q.items():
            _walk_sites(sites, p[key], sub, f"{path}.{key}" if path else key)


def _prepared_sites(params, prog) -> dict:
    """(K, N) -> one programmed projection of that shape, ``(name, params,
    programmed)``, the first layer of every stacked segment and the head."""
    from repro_torch.models.common import layer_slice

    sites: dict = {}
    for path in (("encoder", "blocks"), ("blocks", "seg0"), ("cross",)):
        p, q = params, prog
        for key in path:
            p, q = (p or {}).get(key), (q or {}).get(key)
        if q is not None:
            _walk_sites(sites, layer_slice(p, 0), layer_slice(q, 0), ".".join(path))
    _walk_sites(sites, params["lm_head"], prog["lm_head"], "lm_head")
    return sites


def check_k1_sites(timer, arch, params, prog, calls, dcfg, card):
    """K1 at each distinct (K, N) of ``calls`` (K, N, M) on the programmed
    state of one projection of that shape, M = 4, 64 (up to
    ``K1_CHECK_64`` weights) and the largest M of the calls (up to
    ``K1_CHECK_ROWS`` row-weights: more than one 128-row tile takes the
    ``dynamic`` ADC's range and quantise launches, the last tile ragged
    where 128 does not divide M), bit-equal to its plain version; timed
    beside its bound."""
    from repro_torch.core.layers import mem_linear

    sites = _prepared_sites(params, prog)
    shapes = {(k, n) for k, n, _ in calls}
    if set(sites) != shapes:
        raise AssertionError(f"{arch}: checked shapes {sorted(sites)} against the path's "
                             f"{sorted(shapes)}")
    g = torch.Generator(device="cuda").manual_seed(37)
    for (k, n), (name, p, q) in sorted(sites.items()):
        most = max(m for kk, nn, m in calls if (kk, nn) == (k, n))
        rows = [4] + ([64] if k * n <= K1_CHECK_64 else [])
        rows += [most] if most > 64 and k * n * most <= K1_CHECK_ROWS else []
        for m in rows:
            x = torch.randn((m, k), generator=g, device="cuda")
            run = lambda kernels: mem_linear(x, p["w"], p.get("b"), dcfg, None,  # noqa: E731
                                             prepared=q, kernels=kernels)
            y = run(True)
            t1 = time.monotonic()
            yp = run(False)
            torch.cuda.synchronize()
            t_plain = (time.monotonic() - t1) * 1e3
            if y.shape != (m, n) or not torch.equal(y, yp):
                raise AssertionError(f"{arch} K1 at {name} M={m}: differs from the plain "
                                     f"version by {float((y - yp).abs().max())}")
            ms = timer(lambda: run(True))
            b, _, by = k1_bound([(k, n, m)])
            ragged = f", N padded to {-(-n // 128) * 128}" if n % 128 else ""
            print(f"K1 at {arch}'s {name} ({k} x {n}{ragged}, {-(-k // 128)} K-blocks), M = {m}: "
                  f"bit-equal to the plain version; {ms:.3f} ms (bound {b:.3f} ms, {by}), plain "
                  f"{t_plain:.1f} ms  [{card}]")


def k1_event_ms(fn) -> list:
    """``fn()`` with each K1 call timed by CUDA events: its calls' device
    ms (no profiler, which can lose events)."""
    from repro_torch.kernels import sliced_matmul as sm

    inner, spans = sm.fused_sliced_matmul_cuda, []

    def call(*a, **kw):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = inner(*a, **kw)
        e.record()
        spans.append((s, e))
        return out

    sm.fused_sliced_matmul_cuda = call
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        sm.fused_sliced_matmul_cuda = inner
    return [s.elapsed_time(e) for s, e in spans]


def _generation(label, generate, calls_pre, calls_step, n_new, card):
    """Time ``generate(n)`` (``greedy_generate`` of n new tokens, after a
    warm-up): TTFT from ``n = 0``, the whole run, tok/s and ITL from ``n =
    n_new``; the idle share of the profiled ``n = n_new`` run against the
    timed run's wall; K1's device ms in the prefill (``n = 0``) and a
    decode step (the difference over ``n_new``) by CUDA events
    (:func:`k1_event_ms`) against their bounds.  ``calls_pre`` /
    ``calls_step``: (K, N, M) of every K1 call of the prefill / a step."""
    wall = {}
    for n in (0, n_new):
        t0 = time.monotonic()
        generate(n)
        torch.cuda.synchronize()
        wall[n] = time.monotonic() - t0
    pre, whole = wall[0], wall[n_new]
    b_pre, _, by_pre = k1_bound(calls_pre)
    b_step, gb, by_step = k1_bound(calls_step)
    batch = calls_step[-1][2]
    print(f"{label} dense greedy_generate, mem_faithful (dynamic ADC), batch {batch}: TTFT "
          f"{pre * 1e3:.1f} ms, {n_new} new tokens in {whole * 1e3:.1f} ms: "
          f"{batch * n_new / whole:.2f} tok/s, ITL {(whole - pre) / n_new * 1e3:.1f} ms; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    g_all = device_groups(lambda: generate(n_new))
    print_busy(f"{label}'s generation (the prefill and {n_new} decode steps)", g_all,
               whole * 1e3, card, k1_calls=len(calls_pre) + n_new * len(calls_step))
    ev_pre = k1_event_ms(lambda: generate(0))
    ev_all = k1_event_ms(lambda: generate(n_new))
    if len(ev_pre) != len(calls_pre) or len(ev_all) != len(calls_pre) + n_new * len(calls_step):
        raise AssertionError(f"{label}: {len(ev_pre)} and {len(ev_all)} K1 calls, expected "
                             f"{len(calls_pre)} and {len(calls_pre) + n_new * len(calls_step)}")
    k1_pre = sum(ev_pre)
    k1_step = (sum(ev_all) - k1_pre) / n_new
    print(f"  K1 by CUDA events: the prefill {k1_pre:.3f} ms in {len(ev_pre)} calls against its "
          f"bound {b_pre:.3f} ms ({by_pre}), {b_pre / max(k1_pre, 1e-9):.1%} of it; a decode "
          f"step {k1_step:.3f} ms in {len(calls_step)} calls against its bound {b_step:.3f} ms "
          f"({gb:.2f} GB of slices, {by_step}), {b_step / max(k1_step, 1e-9):.1%} of it  [{card}]")


def encdec(timer, card, counters):
    """whisper-tiny's encoder-decoder and phi-3-vision-4.2b's patch prefix
    through the dense greedy path under ``make_policy("mem_faithful")``,
    random weights from seed 0: (a) whisper-tiny at full width and depth
    (4 encoder and 4 decoder layers, 1,500 frames) through the launcher's
    default mode, batch 4, prompt 16, 16 new (K1 and K6 by the formula),
    then the same generation timed and profiled; (b) phi-3-vision at full
    width, cut to ``PHI3V_LAYERS`` of its 32 layers, its 576 patch
    embeddings ahead of 16 prompt tokens, batch 2, 8 new, ``max_len``
    601, timed and profiled (K1 and K6 by the formula); (c) K1 at each
    distinct (K, N) of both paths (the 51,865- and 32,064-column heads,
    padded to whole 128-column tiles, included; whisper's encoder shapes
    also at its 6,000 rows) bit-equal to its plain version
    (:func:`check_k1_sites`); (d) whisper-smoke and phi3-vision-smoke through the
    launcher's default mode with ``--kernels on`` against ``off``,
    tokens and every logit row bit-equal."""
    from repro_torch.configs import get, get_smoke
    from repro_torch.core.prng import PRNGKey, randint
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.models import init_params, program_params, programmed_byte_size
    from repro_torch.models.common import tree_leaves
    from repro_torch.serve import greedy_generate

    pol = make_policy("mem_faithful")
    n_slices = pol.default.weight_spec.n_slices

    # (a) whisper-tiny at full width and depth, the launcher's default mode
    cfg = get(WHISPER)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counters()
    out = launcher.main(WHISPER_LAUNCH)
    torch.cuda.synchronize()
    launched = path_launches()
    frames = 4 * cfg.encoder.n_frames
    calls_pre, calls_step = encdec_calls(cfg, 4 * 16, frames), encdec_calls(cfg, 4)
    n_weights = len(calls_pre) + 1
    expect_k1, expect_k6 = n_weights + 16 * (len(calls_step) + 1), n_weights * n_slices
    print(f"{WHISPER} launcher default mode: launches {launched}; expected K1 {expect_k1} "
          f"({n_weights} in the prefill, {len(calls_step) + 1} a decode step), K6 {expect_k6}  "
          f"[{card}]")
    if (launched["fused_sliced_matmul"] != expect_k1 or launched["program_noise"] != expect_k6
            or launched["fused_sliced_matmul_stack"] or launched["paged_decode_attention"]
            or launched["paged_chunk_attention"]):
        raise AssertionError(f"{WHISPER}: launches {launched}")
    if out.shape != (4, 17) or not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"{WHISPER}: tokens {out}")
    for name, n in launched.items():
        counters[name] = counters.get(name, 0) + n
    t0 = time.monotonic()
    params = init_params(cfg, PRNGKey(0), device="cuda")
    torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    t0 = time.monotonic()
    prog = program_params(params, cfg, pol, PRNGKey(0))
    torch.cuda.synchronize()
    t_prog = time.monotonic() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{WHISPER} (d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, {cfg.encoder.n_layers} encoder and {cfg.n_layers} decoder layers, "
          f"{cfg.encoder.n_frames} frames, vocab {cfg.vocab}): init {n_params / 1e6:.2f} M params "
          f"in {t_init:.2f} s; programmed {programmed_byte_size(prog) / 1e6:.1f} MB of crossbar "
          f"state in {t_prog:.2f} s  [{card}]")
    prompts = randint(PRNGKey(1), (4, 16), 0, cfg.vocab, device="cuda")
    extra = launcher.side_inputs(cfg, 4, "cuda")

    def generate(n):
        return greedy_generate(params, cfg, prompts, n, policy=pol, compute_dtype=torch.float32,
                               extra_batch=extra, programmed=prog)

    if not torch.equal(generate(16), out):  # and the warm-up
        raise AssertionError(f"{WHISPER}: greedy_generate differs from the launcher's tokens")
    head = [(cfg.d_model, cfg.vocab, 4)]
    _generation(WHISPER, generate, calls_pre + head, calls_step + head, 16, card)
    check_k1_sites(timer, WHISPER, params, prog, calls_pre + head, pol.default, card)
    del params, prog, extra, generate

    # (b) phi-3-vision at full width, PHI3V_LAYERS of its 32 layers
    cfg = get(PHI3V).replace(n_layers=PHI3V_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = init_params(cfg, PRNGKey(0), device="cuda")
    torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    ops.reset_counters()
    t0 = time.monotonic()
    prog = program_params(params, cfg, pol, PRNGKey(0))
    torch.cuda.synchronize()
    t_prog = time.monotonic() - t0
    launched = path_launches()  # programming: K6 once a slice plane of every weight
    b, s, new = PHI3V_BATCH, PHI3V_PROMPT, PHI3V_NEW
    rows = b * (cfg.vision_prefix + s)
    calls_pre, calls_step = encdec_calls(cfg, rows), encdec_calls(cfg, b)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{PHI3V} at full width (d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.vision_prefix} patch "
          f"embeddings), cut: {cfg.n_layers} of 32 layers (the whole model's ~59.6 GB of slices "
          f"and ~15.3 GB of params leave no room on one card): init {n_params / 1e6:.1f} M params "
          f"in {t_init:.2f} s; programmed {programmed_byte_size(prog) / 1e6:.1f} MB of crossbar "
          f"state in {t_prog:.2f} s  [{card}]")
    prompts = randint(PRNGKey(1), (b, s), 0, cfg.vocab, device="cuda")
    extra = launcher.side_inputs(cfg, b, "cuda")
    max_len = cfg.vision_prefix + s + new + 1

    def generate(n):
        return greedy_generate(params, cfg, prompts, n, policy=pol, max_len=max_len,
                               compute_dtype=torch.float32, extra_batch=extra, programmed=prog)

    ops.reset_counters()
    t0 = time.monotonic()
    out = generate(new)  # the main path's run: its launches are counted
    torch.cuda.synchronize()
    t_first = time.monotonic() - t0
    for name, n in path_launches().items():
        launched[name] += n
    n_weights = len(calls_pre) + 1
    expect_k1, expect_k6 = n_weights * (new + 1), n_weights * n_slices
    print(f"{PHI3V}: the first generation ({new} new, kernels' first calls) in {t_first:.2f} s; "
          f"launches of the programming and the generation {launched}; expected K1 {expect_k1}, "
          f"K6 {expect_k6}  [{card}]")
    if (launched["fused_sliced_matmul"] != expect_k1 or launched["program_noise"] != expect_k6
            or launched["fused_sliced_matmul_stack"] or launched["paged_decode_attention"]
            or launched["paged_chunk_attention"]):
        raise AssertionError(f"{PHI3V}: launches {launched}")
    if out.shape != (b, new + 1) or not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"{PHI3V}: tokens {out}")
    for name, n in launched.items():
        counters[name] = counters.get(name, 0) + n
    head = [(cfg.d_model, cfg.vocab, b)]
    _generation(PHI3V, generate, calls_pre + head, calls_step + head, new, card)
    check_k1_sites(timer, PHI3V, params, prog, calls_pre + head, pol.default, card)
    del params, prog, extra, generate
    torch.cuda.empty_cache()

    # (d) the smoke configs through the launcher: the kernels against plain
    for arch in (WHISPER, PHI3V):
        scfg = get_smoke(arch)
        ops.reset_counters()
        on = launcher.main(["--arch", arch] + ENCDEC_SMOKE + ["--kernels", "on"],
                           collect_logits=True)
        n_k1 = ops.COUNTERS["fused_sliced_matmul"].count
        off = launcher.main(["--arch", arch] + ENCDEC_SMOKE + ["--kernels", "off"],
                            collect_logits=True)
        fr = 2 * scfg.encoder.n_frames if scfg.encoder is not None else 0
        rows = 2 * (8 + scfg.vision_prefix)
        want = (len(encdec_calls(scfg, rows, fr)) + 1) + 2 * (len(encdec_calls(scfg, 2)) + 1)
        if n_k1 != want or ops.COUNTERS["fused_sliced_matmul"].count != n_k1:
            raise AssertionError(f"{arch} smoke: K1 {n_k1} launches (expected {want}; "
                                 "--kernels off launches none)")
        if not (torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])):
            raise AssertionError(f"{arch} smoke: kernels {on[0].tolist()} against plain "
                                 f"{off[0].tolist()}")
        print(f"{scfg.name} (mem_faithful) in the launcher's default mode: tokens and "
              f"{on[1].shape[0] * on[1].shape[1]} logit rows bit-equal to --kernels off; K1 "
              f"{n_k1} launches  [{card}]")


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
# (the depth: 4 of 24 layers, a cut for the script's time limit; the phase took ~57 s
# at 24 layers on an H100 80GB HBM3, 700 W)
TRAIN_LAYERS = 4
TRAIN = ["--policy", "mem_faithful", "--steps", "3", "--batch", "8", "--seq", "128",
         "--layers", str(TRAIN_LAYERS)]
# the kernels-against-plain comparison: 1 of the 24 layers, batch 2 x 16
TRAIN_CUT = ["--policy", "mem_faithful", "--layers", str(CUT_LAYERS), "--batch", "2", "--seq",
             "16", "--steps", "2"]
LOSS_CHUNK = 64  # launch/train.py's
CKPT_DIR = os.path.join(HERE, "build", "chip_smoke_ckpt")


def train_launches(n_layers, steps, seq, remat=True, n_slices=None, per_layer=7, stacks=0,
                   experts=0):
    """(K1, K6, stacked K1) launches of ``steps`` faithful train steps: per
    step one programming and one K1 a projection (``per_layer`` a layer:
    qwen2's 7, rwkv6's 8, an MoE layer's 4 attention projections) and a
    loss chunk (the vocab head), one stacked K1 a stack of ``experts``
    (``stacks`` a layer), all twice with remat (the recompute); a
    programming is one K6 launch a slice plane of each weight, each
    expert's."""
    from repro_torch.launch.dryrun import make_policy

    if n_slices is None:
        n_slices = make_policy("mem_faithful").default.weight_spec.n_slices
    chunks = -(-seq // min(LOSS_CHUNK, seq))
    passes = (2 if remat else 1) * steps
    k1 = (per_layer * n_layers + chunks) * passes
    st = stacks * n_layers * passes
    return k1, (k1 + st * experts) * n_slices, st


def _leaves_equal(a, b) -> bool:
    from repro_torch.models.common import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def _train_counts():
    """(K1, K6, stacked K1) launches so far."""
    from repro_torch.kernels import ops

    return tuple(ops.COUNTERS[name].count for name in
                 ("fused_sliced_matmul", "program_noise", "fused_sliced_matmul_stack"))


def train(qcfg, card, counters):
    """``repro_torch.launch.train.main`` at qwen2-0.5b's full width,
    ``TRAIN_LAYERS`` of its 24 layers, under ``mem_faithful``: 3 steps
    (each loss and grad norm finite,
    K1 and K6 launched by the formula), one more step profiled (idle
    share, K1 a step against its bound, K6); then, at ``CHECK_LAYERS``
    layers (full width, the same batch, loss chunks and remat), a resumed
    run (2 steps with ``--ckpt``, then to step 3) bit-equal to 3 steps
    without a break."""
    import shutil

    from repro_torch.launch import train as trainer

    want = train_launches(TRAIN_LAYERS, 3, 128)
    rep, state = train_run(f"qwen2-0.5b, {TRAIN_LAYERS} layers, mem_faithful (8 x 128)", TRAIN,
                           want, card, counters)
    train_profile(f"qwen2-0.5b, {TRAIN_LAYERS} layers (1,024 tokens)",
                  qcfg.replace(n_layers=TRAIN_LAYERS), TRAIN, rep, state, want, card)

    del state
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    whole = TRAIN + ["--layers", str(CHECK_LAYERS)]
    two = [a if a != "3" else "2" for a in TRAIN] + ["--layers", str(CHECK_LAYERS)]
    hist, state = trainer.main(whole, return_state=True)
    t0 = time.monotonic()
    first = trainer.main(two + ["--ckpt", CKPT_DIR])
    t1 = time.monotonic()
    rest, resumed = trainer.main(whole + ["--ckpt", CKPT_DIR], return_state=True)
    t2 = time.monotonic()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    same = first + rest == hist and _leaves_equal(resumed, state)
    print(f"train resume at {CHECK_LAYERS} layers (full width, batch 8 x 128): 2 steps, "
          f"checkpoint, resumed to step 3: losses {first + rest} vs {hist}; the final state "
          f"bit-equal to the uninterrupted run: {same}; the runs {t1 - t0:.1f} s and "
          f"{t2 - t1:.1f} s with the launcher's set-up and checkpoints (each saves one)  "
          f"[{card}]")
    if not same:
        raise AssertionError("train: the resumed run differs from the uninterrupted one")


def train_plain(card, args=TRAIN_CUT, label=f"qwen2-0.5b at {CUT_LAYERS} layers",
                expect=lambda remat: train_launches(CUT_LAYERS, 2, 16, remat=remat)):
    """The trainer on ``args`` (by default ``CUT_LAYERS`` layers of
    qwen2-0.5b at full width, batch 2 x 16, 2 steps): with the kernels
    and remat off, with their plain versions (``--kernels off``), and
    with the kernels and remat on: every loss and grad norm, parameter
    and moment bit-equal, the launches ``expect(remat)`` (K1, K6,
    stacked K1)."""
    from repro_torch.kernels import sliced_matmul as sm
    from repro_torch.launch import train as trainer

    gc.collect()
    kept = sum(t.numel() * t.element_size() for pair in sm._workspace.values() for t in pair
               if t is not None)
    print(f"train {label}: device memory held before the runs "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, of it K1's kept workspace "
          f"{kept / 2**30:.2f} GiB (each run's peak below includes it)")
    runs = {}
    for run, extra in (("kernels", ["--remat", "off"]),
                       ("plain", ["--remat", "off", "--kernels", "off"]),
                       ("remat", ["--remat", "on"])):
        rep: dict = {}
        before = _train_counts()
        t0 = time.monotonic()
        _, st = trainer.main(args + extra, return_state=True, report=rep)
        torch.cuda.synchronize()
        n = tuple(a - b for a, b in zip(_train_counts(), before))
        runs[run] = (rep, st, n, time.monotonic() - t0)
        print(f"train {label}, {run}: losses {rep['loss']}, grad norms {rep['grad_norm']}; "
              f"K1 / K6 / stacked K1 launches {n}; {runs[run][3]:.1f} s  [{card}]")
    if any(runs["plain"][2]):
        raise AssertionError(f"train {label}: --kernels off launched a kernel")
    for run, remat in (("kernels", False), ("remat", True)):
        want = expect(remat)
        if runs[run][2] != want:
            raise AssertionError(f"train {label} {run}: launches {runs[run][2]}, expected {want}")
    for a, b in (("kernels", "plain"), ("kernels", "remat")):
        ra, sa = runs[a][:2]
        rb, sb = runs[b][:2]
        if ra["loss"] != rb["loss"] or ra["grad_norm"] != rb["grad_norm"] or \
                not _leaves_equal(sa, sb):
            raise AssertionError(f"train {label}: {a} and {b} differ")
        print(f"train {label}: {a} and {b} give every loss, grad norm, parameter and moment "
              "bit for bit")


HEAD_SLAB = 2048  # columns of a vocab head held against its plain version, per slab
K1_SEED = 18


def _train_proj(cfg) -> list:
    """(K, N) of K1's projections in one layer of ``cfg``'s trainer, in
    call order: RWKV6's r, k, v, g and output or attention's q, k, v, o;
    then the gated MLP's (none in an MoE layer: its experts are stacks)."""
    d = cfg.d_model
    kind, moe = cfg.layer_kind(0)
    if kind == "ssm":
        mix = [(d, d)] * 5
    else:
        qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        mix = [(d, qd), (d, kvd), (d, kvd), (qd, d)]
    return mix + ([] if moe else [(d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)])


def train_cfg(phase):
    """The configuration ``phase``'s trainer runs (:data:`TRAIN_K1`)."""
    from repro_torch.configs import get

    arch, args = TRAIN_K1[phase][:2]
    cfg = get(arch)
    if arch == JAMBA_ARCH:
        return jamba_full(cfg)
    return cfg.replace(n_layers=_arg(args, "--layers")) if "--layers" in args else cfg


def train_k1_cases(phase) -> list:
    """The distinct (K, N, M) of K1's calls in one train step of
    ``phase`` (:data:`TRAIN_K1`), in call order, but those at rows an
    earlier phase holds."""
    _, args, held, _ = TRAIN_K1[phase]
    return [c for c in dict.fromkeys(_step_calls(train_cfg(phase), args))
            if c[2] not in held]


def _k1_pieces(n: int, phase: str):
    """Column pieces of an N-wide weight of ``phase``'s step, each
    programmed with a key of its own, and the pieces held against the
    plain version.  A phase with a slab width in :data:`TRAIN_K1` holds
    the last of its slab-wide pieces (whole crossbar columns, ragged where
    the slab does not divide N); the others hold one piece, whole, up to 8
    ``HEAD_SLAB`` columns (every projection), and a vocab head in slabs of
    ``HEAD_SLAB`` whole crossbar columns, of which the first, the middle
    and the last are held (a slab's plain version gives its columns of
    the whole in the same bits: ``dynamic`` ranges and block scales span
    one crossbar's columns)."""
    slab = TRAIN_K1[phase][3]
    if slab:
        pieces = [(c, min(c + slab, n)) for c in range(0, n, slab)]
        return pieces, [len(pieces) - 1]
    if n <= 8 * HEAD_SLAB:
        return [(0, n)], [0]
    pieces = [(c, min(c + HEAD_SLAB, n)) for c in range(0, n, HEAD_SLAB)]
    return pieces, [0, len(pieces) // 2, len(pieces) - 1]


def _k1_operands(seed: int, k: int, m: int, cols, pieces, kernels: bool):
    """x (m, k) and the programmed pieces ``pieces`` (indices into the
    column pieces ``cols``, :func:`_k1_pieces`) of a weight with k rows
    under ``mem_faithful``, all drawn on the card from ``seed`` (piece j
    from its own generator and ``fold_in(PRNGKey(seed), j)``), programmed
    by K6 or (``kernels=False``) its plain version, which agree bit for
    bit."""
    from repro_torch.core.dpe import prepare_weight
    from repro_torch.core.prng import PRNGKey, fold_in
    from repro_torch.launch.dryrun import make_policy

    cfg = make_policy("mem_faithful").default
    x = torch.randn((m, k), generator=torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda")
    out = []
    for j in pieces:
        c0, c1 = cols[j]
        g = torch.Generator(device="cuda").manual_seed(1000 * seed + j)
        w = torch.randn((k, c1 - c0), generator=g, device="cuda") * k**-0.5
        out.append(prepare_weight(w, cfg, fold_in(PRNGKey(seed), j), kernels=kernels))
    return x, out


def k1_train_plain(phase) -> list:
    """The plain K1 (and K6) at each of ``phase``'s cases
    (:func:`train_k1_cases`), on its held pieces: per case (the pieces'
    outputs on the host, ms).  Needs no kernel."""
    from repro_torch.kernels import sliced_matmul as sm
    from repro_torch.launch.dryrun import make_policy

    kw = _k1_kw(make_policy("mem_faithful").default)
    res = []
    for i, (k, n, m) in enumerate(train_k1_cases(phase)):
        t0 = time.monotonic()
        cols, held = _k1_pieces(n, phase)
        x, pws = _k1_operands(K1_SEED + i, k, m, cols, held, kernels=False)
        ys = [sm.fused_sliced_matmul_ref(x, pw.slices, pw.scale, **kw).cpu() for pw in pws]
        res.append((ys, (time.monotonic() - t0) * 1e3))
        del x, pws
    return res


def k1_plain_ahead(phases) -> dict:
    """:func:`k1_train_plain` of each of ``phases`` on a stream of its own
    (while the apps' plain runs and ``nvcc`` take the card and the host)."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        out = {phase: k1_train_plain(phase) for phase in phases}
    stream.synchronize()
    return out


def check_k1_calls(timer, phase, label, card, plain=None):
    """K1 at every distinct (K, N, M) of ``phase``'s train step (its
    projections on the batch's rows, the vocab head on a loss chunk's),
    under ``mem_faithful`` (``dynamic`` ADC over 128-row tiles), bit-equal
    to its plain version (``plain``: :func:`k1_train_plain`'s, computed
    here if not given), then timed beside its bound.  The kernel runs on
    the whole weight, its pieces (:func:`_k1_pieces`) programmed by K6;
    the plain version on the held pieces.  The kernel's call has the
    step's padded width, so its launch plan (printed) is the step's call's,
    and it runs as one group of rows, as the step's."""
    from repro_torch.kernels import sliced_matmul as sm
    from repro_torch.launch.dryrun import make_policy

    cfg = make_policy("mem_faithful").default
    kw = _k1_kw(cfg)
    cases = train_k1_cases(phase)
    ahead = plain is not None
    plain = plain if ahead else k1_train_plain(phase)
    for i, ((k, n, m), (yps, t_plain)) in enumerate(zip(cases, plain)):
        pieces, held = _k1_pieces(n, phase)
        x, pws = _k1_operands(K1_SEED + i, k, m, pieces, range(len(pieces)), kernels=True)
        ws = torch.cat([pw.slices for pw in pws], dim=-1)
        sw = torch.cat([pw.scale for pw in pws], dim=-1)
        del pws
        kp, np_ = ws.shape[-2:]
        plan = sm.plan_k1(m, kp, np_, 128, cfg.input_spec.n_slices, cfg.weight_spec.n_slices,
                          "dynamic", 128, cfg.radc)
        if np_ != -(-n // 128) * 128:
            raise AssertionError(f"K1 {k} -> {n} ({label}): the held call is {np_} wide, the "
                                 f"step's {-(-n // 128) * 128}")
        before = sm.counter.count
        y = sm.fused_sliced_matmul_cuda(x, ws, sw, **kw)
        if sm.counter.count - before != 1:
            raise AssertionError(f"K1 {k} -> {n} at M={m} ({label}): the call ran in "
                                 f"{sm.counter.count - before} row groups, the step's in one")
        # each piece is padded to whole crossbars: its columns of y start at its own offset
        starts = np.cumsum([0] + [-(-(c1 - c0) // 128) * 128 for c0, c1 in pieces])
        same = bool(torch.isfinite(y).all())
        for j, yp in zip(held, yps):
            same = same and torch.equal(y[:, starts[j]:starts[j] + yp.shape[1]].cpu(), yp)
        if not same:
            raise AssertionError(f"K1 {k} -> {n} at M={m} ({label}): differs from its plain "
                                 "version")
        t = timer(lambda: sm.fused_sliced_matmul_cuda(x, ws, sw, **kw))
        _, kp, np_ = ws.shape
        nbytes = 4 * (ws.numel() + sw.numel() + x.numel() + m * np_)
        b, by = bound_ms(nbytes, 2 * cfg.input_spec.n_slices * cfg.weight_spec.n_slices
                         * m * kp * np_)
        done = sum(yp.shape[1] for yp in yps)
        beside = ", beside the apps' plain runs" if ahead else ""
        plain_s = f"plain {t_plain:.1f} ms (its programming included{beside})"
        if done < np_:
            plain_s += (f" over {done:,} of its {np_:,} columns (slabs from "
                        f"{', '.join(str(pieces[j][0]) for j in held)})")
        print(f"K1 {k} -> {n} at M={m} ({label}) bit-equal to its plain version: kernel "
              f"{t:.4f} ms, {plain_s}, bound {b:.4f} ms ({by}), {b / t:.1%} of it; plan: "
              f"{plan.nk} x {plan.nn} tiles, column split {plan.sc}, {plan.units} row units "
              f"over grid z {plan.z}, two-pass {plan.two_pass}, {plan.launches} launches, one "
              f"row group  [{card}]")
        del x, ws, sw, y
    print(f"K1 at every distinct (K, N, M) of the {label} train step ({len(cases)}) bit-equal "
          "to its plain version")


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
          f"{losses[-1]:.4f} in 100 steps, {time.monotonic() - t0:.1f} s; K1 / K6 / stacked K1 "
          f"launches {n}  [{card}]")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0] and n[1] > 0):
        raise AssertionError("hw_training: the loss did not fall, or K6 never launched")


# ---------------------------------------------------------------------------
# phase 5: the paper's applications
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# training rwkv6-1.6b and qwen3-moe-235b-a22b's first layer
# ---------------------------------------------------------------------------

# 4 of its 24 layers, a cut for the script's time limit (the phase took ~117 s at 24
# layers on an H100 80GB HBM3, 700 W, ~53 s of it the 1-layer plain check)
RWKV_TRAIN_LAYERS = 4
RWKV_TRAIN = ["--arch", "rwkv6-1.6b", "--policy", "mem_faithful", "--steps", "3", "--batch",
              "4", "--seq", "128", "--layers", str(RWKV_TRAIN_LAYERS)]
# the kernels against their plain versions: 1 layer, one row of 64 tokens (the chunked
# WKV form), 2 steps (the second programs the updated weights): the plain K1 takes ~26 s
# a step, the vocab head most, twice that at 2 x 64; K1's two-pass calls of whole
# 128-row tiles are held at the full step's shapes, 256 and 512 rows
RWKV_TRAIN_CUT = ["--arch", "rwkv6-1.6b", "--policy", "mem_faithful", "--layers",
                  str(CUT_LAYERS), "--batch", "1", "--seq", "64", "--steps", "2"]
MOE_TRAIN = ["--arch", MOE_ARCH, "--layers", "1", "--policy", "mem_faithful", "--steps", "2",
             "--batch", "2", "--seq", "128"]
MOE_TRAIN_SMOKE = ["--arch", MOE_ARCH, "--smoke", "--policy", "mem_faithful", "--steps", "2",
                   "--batch", "2", "--seq", "16"]
MOE_STACK_CHECK = 4  # experts of a stack whose K1 the plain version checks


def _arg(args, flag) -> int:
    return int(args[args.index(flag) + 1])


def train_run(label, args, expect, card, counters, cfg=None) -> tuple:
    """``repro_torch.launch.train.main(args)`` on the card (with ``cfg``,
    the launcher's loop, ``run``, on that configuration): each step's
    loss, grad norm, time and tokens/s printed, every loss and grad norm
    finite, the launches ``expect`` (K1, K6, stacked K1) and the peak
    device memory.  Returns (report, final state)."""
    from repro_torch.launch import train as trainer

    rep: dict = {}
    before = _train_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    flags = trainer.parse_args(args)
    _, state = trainer.run(cfg or trainer.config_of(flags), flags, return_state=True, report=rep)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n = tuple(a - b for a, b in zip(_train_counts(), before))
    tokens = _arg(args, "--batch") * _arg(args, "--seq")
    for i, (loss, gn, dt) in enumerate(zip(rep["loss"], rep["grad_norm"], rep["step_s"])):
        print(f"train {label} step {i}: loss {loss:.6f}, grad norm {gn:.6f}, {dt * 1e3:.1f} ms, "
              f"{tokens / dt:.1f} tokens/s  [{card}]")
    print(f"train {label}: {len(rep['loss'])} steps in {wall:.1f} s with the launcher's set-up; "
          f"K1 / K6 / stacked K1 launches {n} (expected {expect}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    if n != expect:
        raise AssertionError(f"train {label}: launches {n}, expected {expect}")
    if not all(np.isfinite(rep["loss"] + rep["grad_norm"])):
        raise AssertionError(f"train {label}: non-finite loss or grad norm {rep}")
    for name, k in zip(("fused_sliced_matmul", "program_noise", "fused_sliced_matmul_stack"), n):
        counters[name] = counters.get(name, 0) + k
    return rep, state


def train_profile(label, cfg, args, rep, state, expect, card):
    """One more step of ``args``' trainer on ``state``, profiled: the
    device busy time against the host time of the timed steps after the
    first (the idle share), and K1's device ms a step against its bound
    over the step's calls (:func:`_step_calls`; with expert stacks, also
    the stacked K1 calls recorded in this step, by :func:`stack_bound`).
    The step must launch what each timed step of the run did (``expect``,
    the run's (K1, K6, stacked K1) launches: no row groups); the
    profiler's K1 kernel launches are printed beside the calls' plans (a
    two-pass call launches twice)."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.sliced_matmul import plan_k1
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import make_train_step

    steps = _arg(args, "--steps")
    policy = make_policy("mem_faithful")
    opt = adamw(lr=cosine_schedule(3e-4, warmup=5, total=steps))
    step_fn = make_train_step(cfg, opt, policy, compute_dtype=torch.float32,
                              loss_chunk=LOSS_CHUNK, donate=True)
    batch = synthetic_batch(cfg, _arg(args, "--batch"), _arg(args, "--seq"), steps,
                            device="cuda")
    step_ms = statistics.mean(rep["step_s"][1:]) * 1e3
    calls = _step_calls(cfg, args)
    moe = cfg.layer_kind(0)[1]
    want = tuple(c // steps for c in expect)
    out: dict = {}
    before = _train_counts()
    seen = stack_calls(lambda: out.update(g=device_groups(lambda: step_fn(state, batch))))
    n = tuple(a - b for a, b in zip(_train_counts(), before))
    if n != want:
        raise AssertionError(f"train {label}: the profiled step launched {n} (K1, K6, stacked "
                             f"K1), a timed step {want}")
    groups = out["g"]
    b, gb, by = k1_bound(calls)
    b += sum(stack_bound(*c)[0] for c in seen)
    dcfg = policy.default
    plan = lambda m, k, n: plan_k1(m, -(-k // 128) * 128, -(-n // 128) * 128, 128,  # noqa: E731
                                   dcfg.input_spec.n_slices, dcfg.weight_spec.n_slices,
                                   "dynamic", 128, dcfg.radc).launches
    kernels = sum(plan(m, k, n) for k, n, m in calls) + sum(plan(*c[3:]) for c in seen)
    if not groups:
        print(f"train {label} step: device time not measured (the profiler saw no device events)")
        return
    busy = sum(ms for ms, _ in groups.values())
    k1_ms, k1_n = groups.get("K1", (0.0, 0))
    k6_ms = sum(ms for g, (ms, _) in groups.items() if "program_noise" in g)
    print(f"train {label} step: {step_ms:.1f} ms wall (the steps after the first), device busy "
          f"{busy:.1f} ms, idle share {1 - busy / step_ms:.3f}; K1 {k1_ms:.1f} ms in {k1_n} "
          f"kernel launches (its {n[0]} calls{f' and {n[2]} stacked calls' if moe else ''}, "
          f"as a timed step's, plan {kernels} launches: two-pass calls launch twice), bound "
          f"{b:.1f} ms ({by}{'; stacks by their routed rows' if moe else ''}), "
          f"{b / max(k1_ms, 1e-9):.1%} of it; K6 {k6_ms:.1f} ms  [{card}]")
    other = sorted(((ms, n, g) for g, (ms, n) in groups.items()
                    if g.startswith("other") and "program_noise" not in g), reverse=True)
    print(f"  other device work: {sum(o[0] for o in other):.1f} ms in "
          f"{sum(o[1] for o in other)} launches; largest:")
    for ms, n, g in other[:5]:
        print(f"    {ms:.2f} ms in {n} launches  {g[7:]}")


def _step_calls(cfg, args) -> list:
    """(K, N, M) of K1's calls in one remat train step of ``args``: every
    projection on the batch's rows (an encoder's on its frames', a hybrid
    period's in its layers' order, :func:`jamba_shapes`; a vision model's
    rows are its patches and tokens, ``--seq``), the vocab head on each
    loss chunk's, each twice (the forward and the recompute)."""
    b, s = _arg(args, "--batch"), _arg(args, "--seq")
    ck = min(LOSS_CHUNK, s)
    if cfg.encoder is not None or cfg.vision_prefix:
        calls = encdec_calls(cfg, b * s, b * cfg.encoder.n_frames if cfg.encoder else 0)
    elif cfg.family == "hybrid":
        calls = [(k, n, b * s) for k, n in jamba_shapes(cfg)[:-1]]
    else:
        calls = [(k, n, b * s) for k, n in _train_proj(cfg)] * cfg.n_layers
    calls += [(cfg.d_model, cfg.vocab, b * ck)] * -(-s // ck)
    return calls * 2


def rwkv6_train(timer, card, counters, k1_plain=None):
    """``repro_torch.launch.train.main`` at rwkv6-1.6b's full width,
    ``RWKV_TRAIN_LAYERS`` of its 24 layers, under ``mem_faithful``: batch
    4 x 128 tokens (the chunked WKV
    form, 4 chunks a row), loss chunks of 64, remat on, float32, AdamW, 3
    steps (each loss and grad norm finite, K1 and K6 by the formula, the
    step time, tokens/s and peak memory), one more step profiled (idle
    share, K1 a step against its bound); K1 at every distinct (K, N, M)
    of the step bit-equal to its plain version (:func:`check_k1_calls`,
    ``k1_plain`` its plain side if computed ahead); then at
    ``CUT_LAYERS`` layers (batch 1 x 64, 2 steps) the kernels against
    their plain versions and remat on against off, bit for bit."""
    from repro_torch.configs import get

    cfg = get("rwkv6-1.6b").replace(n_layers=RWKV_TRAIN_LAYERS)
    want = train_launches(cfg.n_layers, 3, 128, per_layer=8)
    rep, state = train_run(f"rwkv6-1.6b, {cfg.n_layers} layers, mem_faithful (4 x 128)",
                           RWKV_TRAIN, want, card, counters)
    train_profile(f"rwkv6-1.6b, {cfg.n_layers} layers (512 tokens)", cfg, RWKV_TRAIN, rep, state,
                  want, card)
    del state
    torch.cuda.empty_cache()
    check_k1_calls(timer, "rwkv6_train", "rwkv6-1.6b", card, k1_plain)
    torch.cuda.empty_cache()
    train_plain(card, RWKV_TRAIN_CUT, f"rwkv6-1.6b at {CUT_LAYERS} layers (1 x 64)",
                lambda remat: train_launches(CUT_LAYERS, 2, 64, remat=remat, per_layer=8))


def moe_reckoning(cfg) -> tuple:
    """The device memory a faithful AdamW step of ``cfg`` needs at least:
    float32 parameters, gradients and AdamW's two moments (16 B a
    parameter, the update in place), plus the largest programmed weight
    alive at once (one expert stack, programmed just before its product,
    or the vocab head; 16 B a weight of its padded columns).  Returns
    (GB needed, the line that says so)."""
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    pad = lambda n: -(-n // 128) * 128  # noqa: E731
    n = cfg.param_count()
    state = 16 * n / 1e9
    stack = 16 * e * max(d * pad(f), f * pad(d)) / 1e9
    head = 16 * d * pad(cfg.vocab) / 1e9
    need = state + max(stack, head)
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    return need, total, (f"moe_train reckoning: {n / 1e6:,.1f} M parameters; parameters, "
                         f"gradients and AdamW's moments {state:.1f} GB; one programmed expert "
                         f"stack {stack:.1f} GB, the programmed head {head:.1f} GB; at least "
                         f"{need:.1f} GB of the card's {total:.1f} GB")


def moe_train(timer, card, counters, k1_plain=None):
    """qwen3-moe-235b-a22b's first layer at full width (128 experts of
    1,536, top 8) through ``repro_torch.launch.train.main`` under
    ``mem_faithful``, batch 2 x 128, 2 steps, AdamW (the reckoning of
    :func:`moe_reckoning` printed first): each loss and grad norm finite,
    K1, the stacked K1 (one launch a stack a forward pass) and K6 by the
    formula, step time, tokens/s, peak memory; one more step profiled
    (idle share, K1 a step against its bound, the stacks' by their
    routed rows); the stacked K1 at this phase's shapes on
    ``MOE_STACK_CHECK`` experts of ``wi`` and ``wo`` bit-equal to its
    plain version; K1 at every other distinct (K, N, M) of the step
    (attention at 256 rows, the head at 128) bit-equal to its plain
    version (:func:`check_k1_calls`, ``k1_plain`` its plain side if
    computed ahead); qwen3-moe-smoke for 2 steps with the kernels against
    their plain versions and remat on against off, bit for bit."""
    from repro_torch.configs import get, get_smoke
    from repro_torch.core.dpe import program_stack
    from repro_torch.core.prng import PRNGKey
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import make_policy

    cfg = get(MOE_ARCH).replace(n_layers=1)
    need, total, line = moe_reckoning(cfg)
    print(line)
    if need > 0.9 * total:
        raise AssertionError("moe_train: AdamW's state does not fit the card")
    e = cfg.moe.n_experts
    want = train_launches(1, 2, 128, per_layer=4, stacks=3, experts=e)
    rep, state = train_run("qwen3-moe-235b-a22b, 1 layer, mem_faithful (2 x 128)", MOE_TRAIN,
                           want, card, counters)
    train_profile("qwen3-moe, 1 layer (256 tokens)", cfg, MOE_TRAIN, rep, state, want, card)

    # the stacked K1 at this phase's shapes (M = 2 rows x capacity 16 an expert)
    dcfg = make_policy("mem_faithful").default
    kw = dict(input_spec=dcfg.input_spec, weight_spec=dcfg.weight_spec,
              array_size=dcfg.array_size, rdac=dcfg.rdac, radc=dcfg.radc, adc_mode="dynamic",
              bm=128)
    g = torch.Generator(device="cuda").manual_seed(23)
    experts = state["params"]["blocks"]["seg0"]["moe"]["experts"]
    m = 2 * 16
    for name in ("wi", "wo"):
        w = experts[name][0, :MOE_STACK_CHECK]
        pw = program_stack(w, dcfg, PRNGKey(23))
        x = torch.randn((MOE_STACK_CHECK, m, w.shape[1]), generator=g, device="cuda")
        x[:, m // 2:] = 0.0  # capacity padding rows
        y = ops.fused_sliced_matmul(x, pw.slices, pw.scale, **kw)
        t0 = time.monotonic()
        yp = ops.fused_sliced_matmul(x, pw.slices, pw.scale, kernels=False, **kw)
        torch.cuda.synchronize()
        t_plain = (time.monotonic() - t0) * 1e3
        if not torch.equal(y, yp) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"moe_train: the stacked K1 at {name} differs from its plain "
                                 "version")
        t = timer(lambda: ops.fused_sliced_matmul(x, pw.slices, pw.scale, **kw))
        print(f"stacked K1 {name} ({MOE_STACK_CHECK} experts of {tuple(w.shape[1:])}, M = {m} an "
              f"expert) bit-equal to its plain version: kernel {t:.3f} ms, plain "
              f"{t_plain:.1f} ms  [{card}]")
        del w, pw, x, y, yp  # w, a view, would keep its whole stack alive
    del state, experts
    torch.cuda.empty_cache()
    check_k1_calls(timer, "moe_train", "qwen3-moe-235b-a22b, 1 layer", card, k1_plain)
    torch.cuda.empty_cache()
    scfg = get_smoke(MOE_ARCH)
    train_plain(card, MOE_TRAIN_SMOKE, "qwen3-moe-smoke (2 x 16)",
                lambda remat: train_launches(scfg.n_layers, 2, 16, remat=remat, per_layer=4,
                                             stacks=3, experts=scfg.moe.n_experts))


# ---------------------------------------------------------------------------
# training jamba's period, whisper-tiny and phi-3-vision's patch prefix
# ---------------------------------------------------------------------------

# jamba's full-width period (jamba_full), 2 x 128 tokens, 3 steps, through the train
# launcher's loop (its flags have no switch for the dense MLP)
JAMBA_TRAIN = ["--arch", JAMBA_ARCH, "--policy", "mem_faithful", "--steps", "3", "--batch", "2",
               "--seq", "128"]
JAMBA_TRAIN_SMOKE = ["--arch", JAMBA_ARCH, "--smoke", "--policy", "mem_faithful", "--steps", "2",
                     "--batch", "2", "--seq", "16"]
WHISPER_TRAIN = ["--arch", WHISPER, "--policy", "mem_faithful", "--steps", "3", "--batch", "4",
                 "--seq", "128"]
# --seq counts the 576 patch positions ahead of the 64 tokens
PHI3V_TRAIN = ["--arch", PHI3V, "--layers", str(PHI3V_LAYERS), "--policy", "mem_faithful",
               "--steps", "2", "--batch", "2", "--seq", str(576 + 64)]
# the train phases whose K1 calls are held against the plain version: (arch, trainer args,
# rows whose calls an earlier phase holds, slab): jamba's, whisper's and phi3's train
# phases hold each weight over its last TRAIN_SLAB columns (ragged in a ragged head), the
# others whole projections and three HEAD_SLAB slabs of a head (_k1_pieces); the plain K1
# takes ~2 ns a row-weight on an H100, whole projections of jamba's period alone ~110 s
TRAIN_SLAB = 256
TRAIN_K1 = {"train": ("qwen2-0.5b", TRAIN, (), None),
            "rwkv6_train": ("rwkv6-1.6b", RWKV_TRAIN, (), None),
            "moe_train": (MOE_ARCH, MOE_TRAIN, (), None),
            "jamba_train": (JAMBA_ARCH, JAMBA_TRAIN, (), TRAIN_SLAB),
            # the encoder's and the cross K / V's 6,000 frame rows: encdec holds them
            "whisper_train": (WHISPER, WHISPER_TRAIN, (4 * 1500,), TRAIN_SLAB),
            "phi3v_train": (PHI3V, PHI3V_TRAIN, (), TRAIN_SLAB)}


def step_launches(cfg, args, remat=True) -> tuple:
    """(K1, K6, stacked K1) launches of ``args``' faithful train steps on
    ``cfg``: a K1 call and one programming a projection and a loss chunk
    (:func:`_step_calls`), three stacked K1 calls an MoE layer, twice with
    remat; a programming is one K6 launch a slice plane of each weight,
    each expert's."""
    from repro_torch.launch.dryrun import make_policy

    n_slices = make_policy("mem_faithful").default.weight_spec.n_slices
    passes = (2 if remat else 1) * _arg(args, "--steps")
    k1 = len(_step_calls(cfg, args)) // 2 * passes
    n_moe = sum(cfg.layer_kind(i)[1] for i in range(cfg.n_layers))
    st = 3 * n_moe * passes
    return k1, (k1 + st * (cfg.moe.n_experts if n_moe else 0)) * n_slices, st


def train_reckoning(label, cfg, args):
    """The device memory a faithful AdamW step of ``cfg`` needs at least,
    printed before its run: 16 B a parameter (float32 parameters,
    gradients and AdamW's two moments, the update in place) and the
    largest programmed weight of the step (16 B a weight of its padded
    columns, one alive at a time); fails past 90 % of the card."""
    pad = lambda n: -(-n // 128) * 128  # noqa: E731
    n = cfg.param_count()
    state = 16 * n / 1e9
    big = max(16 * k * pad(nn) for k, nn, _ in _step_calls(cfg, args)) / 1e9
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"{label} reckoning: {n / 1e6:,.1f} M parameters; parameters, gradients and AdamW's "
          f"moments {state:.1f} GB; the largest programmed weight {big:.1f} GB; at least "
          f"{state + big:.1f} GB of the card's {total:.1f} GB")
    if state + big > 0.9 * total:
        raise AssertionError(f"{label}: AdamW's state does not fit the card")


def jamba_train(timer, card, counters, k1_plain=None):
    """jamba-v0.1-52b's full-width period (:func:`jamba_full`: 7 Mamba
    layers and one attention layer, the dense MLP in each) trained under
    ``mem_faithful`` through the train launcher's loop
    (``repro_torch.launch.train.run``): the memory reckoning, batch 2 x
    128, 3 steps (each loss and grad norm finite, K1 and K6 by the
    formula, step time, tokens/s, peak memory),
    one more step profiled (idle share, K1 and K6 a step, K1 against its
    bound); K1 at every distinct (K, N, M) of the step bit-equal to its
    plain version over one ``TRAIN_SLAB``-wide slab a weight
    (:func:`check_k1_calls`); jamba-smoke, its MoE layers included,
    through the launcher for 2 steps of 2 x 16 with the kernels against
    their plain versions and remat on against off, bit for bit."""
    from repro_torch.configs import get_smoke

    cfg = train_cfg("jamba_train")
    label = f"{JAMBA_ARCH}, one period (dense MLP)"
    train_reckoning(f"jamba_train ({label})", cfg, JAMBA_TRAIN)
    want = step_launches(cfg, JAMBA_TRAIN)
    rep, state = train_run(f"{label}, mem_faithful (2 x 128)", JAMBA_TRAIN, want, card, counters,
                           cfg=cfg)
    train_profile(f"{label} (256 tokens)", cfg, JAMBA_TRAIN, rep, state, want, card)
    del state
    torch.cuda.empty_cache()
    check_k1_calls(timer, "jamba_train", label, card, k1_plain)
    torch.cuda.empty_cache()
    scfg = get_smoke(JAMBA_ARCH)
    train_plain(card, JAMBA_TRAIN_SMOKE, "jamba-smoke (2 x 16)",
                lambda remat: step_launches(scfg, JAMBA_TRAIN_SMOKE, remat))


def encdec_train(timer, card, counters, k1_plain=None):
    """whisper-tiny at full width and depth (4 x 128 decoder tokens over
    1,500 stubbed frames a row, 3 steps) and phi-3-vision-4.2b at full
    width cut to ``PHI3V_LAYERS`` layers (2 x (576 patches + 64 tokens), 2
    steps) trained through ``repro_torch.launch.train.main`` under
    ``mem_faithful`` (AdamW, remat, loss chunks of 64): per model the
    memory reckoning, each loss and grad norm finite, K1 and K6 by the
    formula, step time, tokens/s, peak memory, one more step profiled,
    and K1 at every distinct (K, N, M) of its step that ``encdec`` does
    not hold bit-equal to its plain version (:func:`check_k1_calls`, one
    ``TRAIN_SLAB``-wide slab a weight)."""
    runs = (("whisper_train", WHISPER_TRAIN, f"{WHISPER} (4 x 128 over 1,500 frames)"),
            ("phi3v_train", PHI3V_TRAIN, f"{PHI3V}, {PHI3V_LAYERS} layers (2 x (576 + 64))"))
    for phase, args, label in runs:
        cfg = train_cfg(phase)
        train_reckoning(f"{phase} ({label})", cfg, args)
        want = step_launches(cfg, args)
        rep, state = train_run(f"{label}, mem_faithful", args, want, card, counters)
        train_profile(label, cfg, args, rep, state, want, card)
        del state
        torch.cuda.empty_cache()
        check_k1_calls(timer, phase, label, card, (k1_plain or {}).get(phase))
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the last two dense configs served: qwen3-4b and qwen1.5-32b
# ---------------------------------------------------------------------------

DENSE_CONFIGS = ("qwen3-4b", "qwen1.5-32b")
# full width, 1 layer: qwen3-4b's 36 layers take ~64 GB of slices beside 17.6 GB of
# parameters, qwen1.5-32b's 8.4 GB of slices a layer
DENSE_SERVE = ["--layers", "1", "--policy", "mem_faithful", "--batch", "2", "--prompt_len", "8",
               "--gen", "4"]


def dense_configs(card, counters):
    """qwen3-4b (``qk_norm``, head_dim 128) and qwen1.5-32b (40 heads,
    ``qkv_bias``) at full width, cut to 1 layer, through
    ``repro_torch.launch.serve``'s default mode (batch 2, prompt 8, 4
    new; K1 and K6 by the formula, tokens in the vocab); then the same
    generation timed and profiled (:func:`_generation`: tok/s, ITL, idle
    share, K1 in the prefill and a decode step against its bound)."""
    from repro_torch.configs import get
    from repro_torch.core.prng import PRNGKey, randint
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.models import init_params, program_params, programmed_byte_size
    from repro_torch.serve import greedy_generate

    pol = make_policy("mem_faithful")
    for arch in DENSE_CONFIGS:
        cfg = get(arch).replace(n_layers=1)
        ops.reset_counters()
        tokens = launcher.main(["--arch", arch] + DENSE_SERVE)
        torch.cuda.synchronize()
        launched = path_launches()
        want_k1, want_k6 = 8 * 5, K6_PER_PROGRAMMING(cfg, pol)  # the prefill and 4 steps
        print(f"{arch}, 1 layer, launcher default mode: launches {launched}; expected K1 "
              f"{want_k1}, K6 {want_k6}  [{card}]")
        if (launched["fused_sliced_matmul"] != want_k1 or launched["program_noise"] != want_k6
                or launched["fused_sliced_matmul_stack"] or launched["paged_decode_attention"]
                or launched["paged_chunk_attention"]):
            raise AssertionError(f"{arch}: launches {launched}")
        if tokens.shape != (2, 5) or not bool(((tokens >= 0) & (tokens < cfg.vocab)).all()):
            raise AssertionError(f"{arch}: tokens {tokens}")
        for name, n in launched.items():
            counters[name] = counters.get(name, 0) + n
        del tokens
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, PRNGKey(0), device="cuda")
        prog = program_params(params, cfg, pol, PRNGKey(0))
        prompts = randint(PRNGKey(1), (2, 8), 0, cfg.vocab, device="cuda")
        print(f"{arch}, 1 layer: programmed {programmed_byte_size(prog) / 1e6:.1f} MB")

        def generate(n, params=params, prog=prog, cfg=cfg, prompts=prompts):
            return greedy_generate(params, cfg, prompts, n, policy=pol,
                                   compute_dtype=torch.float32, programmed=prog)

        generate(1)  # warm-up
        proj = [(k, n) for k, n, _ in encdec_calls(cfg, 1)]
        head = (cfg.d_model, cfg.vocab, 2)
        calls_step = [(k, n, 2) for k, n in proj] + [head]
        _generation(f"{arch}, 1 layer", generate, [(k, n, 16) for k, n in proj] + [head],
                    calls_step, 4, card)
        del params, prog, generate
        gc.collect()
        torch.cuda.empty_cache()


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


def train_phases(timed, timer, qcfg, card, counters, k1_plain=None):
    timed("train", train, qcfg, card, counters)
    torch.cuda.empty_cache()
    timed("check_k1_train", check_k1_calls, timer, "train", "qwen2-0.5b", card, k1_plain)
    torch.cuda.empty_cache()
    timed("train_plain", train_plain, card)
    timed("check_optim", check_optim, qcfg, card)
    timed("hw_training", hw_training, card)
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--only", choices=("train", "rwkv6", "moe", "jamba", "encdec", "rwkv6_train",
                                       "moe_train", "jamba_train", "encdec_train",
                                       "dense_configs"), default=None,
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

    # the apps' plain runs and the train phases' plain K1 need no kernel: they take
    # the card while nvcc builds.  The threads share modules: import them first, one
    # thread at a time (two threads importing one package see it half made)
    import importlib

    for name in ("repro_torch.core.dpe", "repro_torch.kernels.ops", "repro_torch.launch.dryrun",
                 *(f"repro_torch.apps.{app}" for app in APPS)):
        importlib.import_module(name)
    with ThreadPoolExecutor(2) as pool:
        built = pool.submit(build_kernels)
        t0 = time.monotonic()
        ahead = pool.submit(k1_plain_ahead, TRAIN_K1) if args.only is None else None
        plain_runs = timed("plain_apps", plain_apps) if args.only is None else None
        print(f"built kernels with nvcc in {built.result():.1f} s")
        k1_plain = ahead.result() if ahead else {}
        if ahead:
            print(f"the train phases' plain K1 at their calls, beside the apps' plain runs: "
                  f"done {time.monotonic() - t0:.1f} s after the start")
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
    if args.only == "moe":
        timed("moe", moe, timer, card, counters, summary, floor)
        return 0
    if args.only == "jamba":
        timed("jamba", jamba, timer, card, counters)
        return 0
    if args.only == "encdec":
        timed("encdec", encdec, timer, card, counters)
        return 0
    if args.only == "rwkv6_train":
        timed("rwkv6_train", rwkv6_train, timer, card, counters)
        return 0
    if args.only == "moe_train":
        timed("moe_train", moe_train, timer, card, counters)
        return 0
    if args.only == "jamba_train":
        timed("jamba_train", jamba_train, timer, card, counters)
        return 0
    if args.only == "encdec_train":
        timed("encdec_train", encdec_train, timer, card, counters)
        return 0
    if args.only == "dense_configs":
        timed("dense_configs", dense_configs, card, counters)
        return 0
    timed("check_k1", check_k1, timer, qcfg, summary)
    timed("check_k1_tiles", check_k1_tiles, timer, summary, card)
    timed("check_k2_k3", check_k2_k3, timer, qcfg, summary, card, floor)
    timed("check_k2_k3_long", check_k2_k3_long, timer, qcfg, summary, card, floor)
    timed("check_k4", check_k4, timer, summary, card)
    timed("check_k5", check_k5, timer, qcfg, summary, card)
    timed("check_k6", check_k6, timer, qcfg, summary, card)
    timed("check_init", check_init, card)
    scfg = qcfg.replace(n_layers=SERVE_LAYERS)
    params, sc, loop, reqs, rep = timed("serve", serve, scfg, card, counters)
    sreqs, srep = timed("serve_sampled", serve_sampled, params, scfg, sc, loop, reqs, rep, card)
    timed("serve_spec", serve_spec, params, scfg, sc, loop, reqs, rep, sreqs, srep, card)
    timed("serve_drift", serve_drift, params, scfg, sc, loop, reqs, rep, card)
    del loop
    torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    timed("launch", launch, qcfg, card, counters)
    summary["k1_long"] = timed("check_k1_long", check_k1_long, timer, card)
    torch.cuda.empty_cache()
    timed("rwkv6", rwkv6, card, counters)
    torch.cuda.empty_cache()
    timed("moe", moe, timer, card, counters, summary, floor)
    torch.cuda.empty_cache()
    timed("jamba", jamba, timer, card, counters)
    torch.cuda.empty_cache()
    timed("encdec", encdec, timer, card, counters)
    torch.cuda.empty_cache()
    train_phases(timed, timer, qcfg, card, counters, k1_plain.get("train"))
    timed("rwkv6_train", rwkv6_train, timer, card, counters, k1_plain.get("rwkv6_train"))
    torch.cuda.empty_cache()
    timed("moe_train", moe_train, timer, card, counters, k1_plain.get("moe_train"))
    torch.cuda.empty_cache()
    timed("jamba_train", jamba_train, timer, card, counters, k1_plain.get("jamba_train"))
    torch.cuda.empty_cache()
    timed("encdec_train", encdec_train, timer, card, counters, k1_plain)
    torch.cuda.empty_cache()
    timed("dense_configs", dense_configs, card, counters)
    torch.cuda.empty_cache()
    counters["sliced_matmul"] = summary["sliced_matmul"]["launches"]
    counters["flash_attention"] = summary["flash_attention"]["launches"]
    timed("run_apps", run_apps, card, plain_runs)
    timed("check_circuit", check_circuit, card)

    sources = {
        "fused_sliced_matmul": ("src/repro_torch/csrc/sliced_matmul.cuh",
                                "src/repro/kernels/sliced_matmul.py:352"),
        # the reference vmaps the fused kernel over the experts (models/moe.py:112-122)
        "fused_sliced_matmul_stack": ("src/repro_torch/csrc/sliced_matmul.cuh",
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
            **s.get("extra", {}),
        ))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
