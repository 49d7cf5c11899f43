#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. the card: name and power limit from ``nvidia-smi``, torch / CUDA
   versions;
2. build every kernel from ``src/repro_torch/csrc`` with ``nvcc`` for
   ``sm_90a`` (the compiler's register / spill report goes to
   ``chiprun_out/chip_smoke/build.log``);
3. hold each kernel against its plain PyTorch version on the card and
   time both (CUDA events, L2 flushed before each launch), beside the
   least time the card could take: K1 at qwen2-0.5b shapes, then bit
   for bit at 32x32, 64x64 and 128x128 tiles and for the fp32,
   flex16_5, int8 x int4 and bf16 presets, and ``dpe_matmul`` with the
   paper's default ``DPEConfig()``; K2 / K3; K4, the staged engine
   (``prepare_input`` then ``ops.sliced_matmul``) at the paper's Table 2
   shape, bit-equal to its plain version, within 8 ulp of K1 and, at
   bm 64, at the reference's recorded error (``BENCH_dpe.json``); K5 at
   the reference test's shapes and at qwen2-0.5b width, with SDPA's time
   beside it; K6, the programming noise, bit for bit on a slice plane of
   every served weight shape;
4. serve qwen2-0.5b at full width (24 layers, random weights from a
   seed) through ``ServeLoop`` with the ``mem_faithful`` policy
   (``dynamic_row`` ADC), programmed on the card (K6 must have launched
   once per slice plane of every weight): every request must
   complete, every kernel must have launched on the main path, and every
   request's tokens and every logit row (prefill and decode) must match
   the same run with the kernels' plain versions
   (``ServeConfig(kernels=False)``), which holds K2 and the decode-width
   K1 at the served shapes; then the same requests run once more under
   ``torch.profiler`` to split the card's busy time by kernel and give
   its idle share against the first run's wall time;
5. run the seven paper applications (``repro_torch.apps``) at their
   reference defaults (the default ``DPEConfig`` backend ``xla``: the
   ``dynamic`` ADC range spans a whole call, K-means' 150 rows
   included), once with the kernels and once with their plain versions:
   the results must be equal, and K1 must have launched in each of the
   five faithful ones.

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

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")

# published peaks of one H100 SXM (NVIDIA data sheet; 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
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

def check_k1(timer, qcfg, summary):
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
    worst = 0.0
    decode = {"ms": 0.0, "mean_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    prefill = {"ms": 0.0, "mean_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    for label, (k, n) in shapes.items():
        w = torch.randn((k, n), generator=g, device="cuda") * k**-0.5
        for noise in ("off", "program"):
            pw = prepare_weight(w, dcfg.replace(noise_mode=noise), key=PRNGKey(1234))
            for m in (1, 2, 4, 32):
                x = torch.randn((m, k), generator=g, device="cuda")
                for adc in ("dynamic", "dynamic_row", "fullscale"):
                    y = sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, adc_mode=adc, **kw)
                    yp = sm.fused_sliced_matmul_ref(x, pw.slices, pw.scale, adc_mode=adc, **kw)
                    torch.cuda.synchronize()
                    if not bool(torch.isfinite(y).all()):
                        raise AssertionError(f"K1 {label} M={m} {adc}: non-finite output")
                    worst = max(worst, float((y - yp).abs().max()))
                    if noise == "off":
                        err = rel_max(y, yp)
                        ok = err <= 1e-6
                    else:
                        err = rel_fro(y, yp)
                        ok = err <= 1e-4
                    # outputs off by more than 1e-6 of the largest: each is
                    # at least one ADC code read differently
                    differ = int(((y - yp).abs() > 1e-6 * yp.abs().max()).sum())
                    print(f"K1 {label:7s} K={k} N={n} M={m:2d} noise={noise:7s} "
                          f"{adc:11s} err={err:.2e} outputs_with_flipped_codes={differ}")
                    if not ok:
                        raise AssertionError(f"K1 {label} M={m} {adc} noise={noise}: {err}")
            if noise == "program":
                sw, ss = pw.slices, pw.scale
                kp, np_ = sw.shape[1], sw.shape[2]
                for mm, acc, count in ((2, decode, per_step[label]),
                                       (32, prefill, per_step[label] if label != "lm_head" else 0)):
                    x = torch.randn((mm, k), generator=g, device="cuda")
                    run = lambda: sm.fused_sliced_matmul_cuda(x, sw, ss, adc_mode="dynamic_row", **kw)
                    plain = lambda: sm.fused_sliced_matmul_ref(x, sw, ss, adc_mode="dynamic_row", **kw)
                    t = timer(run)
                    t_mean = timer.mean
                    tp = timer(plain, iters=2)
                    nbytes = 4 * (sw.numel() + ss.numel() + x.numel() + mm * np_)
                    pairs = dcfg.input_spec.n_slices * dcfg.weight_spec.n_slices
                    flops = 2 * pairs * mm * kp * np_
                    b, by = bound_ms(nbytes, flops)
                    print(f"K1 time {label:7s} M={mm:2d}: kernel {t:.4f} ms (mean {t_mean:.4f})  "
                          f"plain {tp:.4f} ms  "
                          f"bound {b:.4f} ms ({by})  x{count} per "
                          f"{'decode step' if mm == 2 else 'prefill chunk'}")
                    acc["ms"] += count * t
                    acc["mean_ms"] += count * t_mean
                    acc["plain_ms"] += count * tp
                    acc["bytes"] += count * nbytes
                    acc["flops"] += count * flops
            del pw
        del w
        torch.cuda.empty_cache()
    for name, acc in (("decode step (M=2, 169 launches)", decode),
                      ("prefill chunk (M=32, 168 launches, non-final)", prefill)):
        b, by = bound_ms(acc["bytes"], acc["flops"])
        print(f"K1 {name}: kernel {acc['ms']:.3f} ms (sum of medians; sum of means "
              f"{acc['mean_ms']:.3f} ms)  plain {acc['plain_ms']:.3f} ms  "
              f"bound {b:.3f} ms ({by}, {acc['bytes'] / 1e9:.2f} GB, "
              f"{acc['flops'] / 1e12:.3f} TFLOP)")
        acc["bound"], acc["by"] = b, by
    summary["fused_sliced_matmul"] = dict(
        max_abs_err=worst, ms=decode["ms"], plain_ms=decode["plain_ms"],
        bound_ms=decode["bound"], bound_by=decode["by"], library_ms=None,
    )


def _pools(g, n_blocks, bs, kv, hd, dtype):
    mk = lambda: torch.randn((n_blocks, bs, kv, hd), generator=g, device="cuda").to(dtype)
    return mk(), mk()


def check_k2_k3(timer, qcfg, summary):
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa

    h, kv, hd = qcfg.n_heads, qcfg.n_kv_heads, qcfg.head_dim
    bs, nb, b = 16, 16, 4
    n_blocks = 1 + b * nb
    g = torch.Generator(device="cuda").manual_seed(7)
    worst = {"paged_decode_attention": 0.0, "paged_chunk_attention": 0.0}
    timing = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
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
            err = rel_max(y, yp)
            worst["paged_decode_attention"] = max(
                worst["paged_decode_attention"], float((y.float() - yp.float()).abs().max()))
            print(f"K2 B={b} {str(dtype):14s} window={window:2d} pos={pos.tolist()} err={err:.2e}")
            if not err <= tol:
                raise AssertionError(f"K2 {dtype} window={window}: {err}")
        if dtype == torch.float32:
            el = 4
            n_keys = int((pos + 1).sum())
            nbytes = el * (2 * n_keys * kv * hd + 2 * q.numel()) + 4 * (bt.numel() + b)
            flops = 4 * h * hd * n_keys
            grp = h // kv
            kg = pa._paged_gather(pk, bt).permute(0, 2, 1, 3).repeat_interleave(grp, dim=1)
            vg = pa._paged_gather(pv, bt).permute(0, 2, 1, 3).repeat_interleave(grp, dim=1)
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
                err = rel_max(y, yp)
                worst["paged_chunk_attention"] = max(
                    worst["paged_chunk_attention"], float((y.float() - yp.float()).abs().max()))
                print(f"K3 C={c} start={start:2d} {str(dtype):14s} window={window:2d} err={err:.2e}")
                if not err <= tol:
                    raise AssertionError(f"K3 start={start} {dtype} window={window}: {err}")
        if dtype == torch.float32:
            start = 37
            n_keys = sum(start + i + 1 for i in range(c))
            nbytes = 4 * (2 * (start + c) * kv * hd + 2 * qc.numel() + nb)
            flops = 4 * h * hd * n_keys
            grp = h // kv
            kg = pa._paged_gather(pk, bt_row[None]).permute(0, 2, 1, 3).repeat_interleave(grp, dim=1)
            vg = pa._paged_gather(pv, bt_row[None]).permute(0, 2, 1, 3).repeat_interleave(grp, dim=1)
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
    for name, t in timing.items():
        b, by = t["bound"]
        print(f"{name}: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
              f"SDPA over the gathered view {t['library_ms']:.4f} ms  bound {b:.5f} ms ({by})")
        summary[name] = dict(max_abs_err=worst[name], ms=t["ms"], plain_ms=t["plain_ms"],
                             bound_ms=b, bound_by=by, library_ms=t["library_ms"])


# ---------------------------------------------------------------------------
# phase 4: serve qwen2-0.5b through ServeLoop
# ---------------------------------------------------------------------------

def serve(qcfg, card, counters):
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, programmed_byte_size
    from repro_torch.serve import Request, ServeConfig, ServeLoop

    t0 = time.monotonic()
    params = init_params(qcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"init params: {time.monotonic() - t0:.1f} s")
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
    # 7 faithful weights per layer and the vocab head, one launch per slice
    expect = (7 * qcfg.n_layers + 1) * sc.policy.default.weight_spec.n_slices
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
    served = ("fused_sliced_matmul", "paged_decode_attention", "paged_chunk_attention")
    launches = {name: ops.COUNTERS[name].count for name in served}
    for r in rep.results:
        if r.finish_reason != "length" or len(r.tokens) != 8:
            raise AssertionError(f"request {r.rid}: {r.finish_reason} {len(r.tokens)} tokens")
        if not all(np.isfinite(row).all() for row in r.logits):
            raise AssertionError(f"request {r.rid}: non-finite logits")
    n_final = len(reqs)
    expect = {
        "fused_sliced_matmul": 168 * rep.prefill_chunks_run + n_final + 169 * rep.decode_steps,
        "paged_decode_attention": qcfg.n_layers * rep.decode_steps,
        "paged_chunk_attention": qcfg.n_layers * rep.prefill_chunks_run,
    }
    print(f"launches on the main path: {launches}; expected {expect} "
          f"({rep.prefill_chunks_run} prefill chunks, {rep.decode_steps} decode steps)")
    for name, n in launches.items():
        if n <= 0 or n != expect[name]:
            raise AssertionError(f"{name}: {n} launches, expected {expect[name]}")
    counters.update(launches)
    ttft = rep.ttft_percentiles()
    itl = rep.itl_percentiles()
    print(f"serve qwen2-0.5b mem_faithful dynamic_row, 24 layers, 2 slots, 4 requests "
          f"x 8 tokens: {rep.tok_per_s:.2f} tok/s, wall {rep.wall_s:.2f} s, "
          f"TTFT mean {ttft['mean'] * 1e3:.1f} ms p50 {ttft['p50'] * 1e3:.1f} ms, "
          f"ITL mean {itl['mean'] * 1e3:.1f} ms  [{card}]")
    print("tokens:", [r.tokens for r in rep.results])

    plain = ServeLoop(params, qcfg, sc.replace(kernels=False), programmed=loop.programmed)
    prep = plain.run(reqs)
    torch.cuda.synchronize()
    # every row: the first comes from the final prefill chunk (K1, K3),
    # the rest from decode steps (K1 at M = live slots, K2)
    for a, b in zip(rep.results, prep.results):
        if len(a.logits) != len(b.logits):
            raise AssertionError(f"request {a.rid}: {len(a.logits)} vs {len(b.logits)} logit rows")
        errs = [rel_fro(torch.from_numpy(ra), torch.from_numpy(rb))
                for ra, rb in zip(a.logits, b.logits)]
        print(f"request {a.rid}: logits kernels vs plain rel-Fro first {errs[0]:.2e}, "
              f"max over {len(errs)} rows {max(errs):.2e}; tokens equal: {a.tokens == b.tokens}")
        if not max(errs) <= 1e-3:
            raise AssertionError(f"request {a.rid}: logits differ, rel-Fro {errs}")
        if a.tokens != b.tokens:
            raise AssertionError(f"request {a.rid}: tokens {a.tokens} vs plain {b.tokens}")
    print(f"plain-version run: {prep.tok_per_s:.2f} tok/s, wall {prep.wall_s:.2f} s  [{card}]")
    device_busy(loop, reqs, rep, card)


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
    pairs = s * (s + 1) // 2
    flops = 4 * dh * pairs * bh
    nbytes = 4 * 4 * bh * s * dh
    b, by = bound_ms(nbytes, flops)
    print(f"K5 time (qwen2-0.5b width: {bh} heads, head_dim {dh}, S={s}, causal, f32): kernel "
          f"{t:.4f} ms  plain {tp:.4f} ms  SDPA {tl:.4f} ms  bound {b:.4f} ms ({by}, "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)  [{card}]")
    summary["flash_attention"] = dict(max_abs_err=worst, ms=t, plain_ms=tp, bound_ms=b,
                                      bound_by=by, library_ms=tl, launches=launches)


# ---------------------------------------------------------------------------
# phase 3e: K6, programming noise
# ---------------------------------------------------------------------------

# operations per cell, counted from csrc/program_noise.cu (a fused
# multiply-add counts two): threefry2x32 about 80 32-bit integer
# operations; uniform 6, erf_inv with its log1p 56, the conductance map
# 3, log 32, exp 30, the way back 3; every one at the float32 rate
OPS_PER_NOISE_CELL = 80 + 6 + 56 + 3 + 32 + 30 + 3


def check_k6(timer, qcfg, summary, card):
    """K6 bit for bit against its plain version on one slice plane of
    each served weight shape, for each slice width of INT8 (1, 1, 2, 4
    bits); timed on the vocab head's plane (136 M cells)."""
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
    nbytes = 8 * cells.numel()
    ops_ = OPS_PER_NOISE_CELL * cells.numel()
    b, by = bound_ms(nbytes, ops_)
    print(f"K6 time (the vocab head's slice plane, {cells.numel() / 1e6:.1f} M cells): kernel "
          f"{t:.4f} ms  plain {tp:.4f} ms  bound {b:.4f} ms ({by}, {nbytes / 1e9:.2f} GB, "
          f"{ops_ / 1e9:.1f} G operations)  [{card}]")
    summary["program_noise"] = dict(max_abs_err=worst, ms=t, plain_ms=tp, bound_ms=b,
                                    bound_by=by, library_ms=None)
    del cells
    torch.cuda.empty_cache()


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


def run_apps(card):
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
        t0 = time.monotonic()
        plain = mod.run(device="cuda", kernels=False)
        torch.cuda.synchronize()
        wall_plain = time.monotonic() - t0
        if ops.COUNTERS["fused_sliced_matmul"].count != k1 or ops.COUNTERS["program_noise"].count != k6:
            raise AssertionError(f"app {name}: the kernels=False run launched a kernel")
        items = list(_scalars(out))
        head = ", ".join(f"{key}={val:.6g}" if isinstance(val, float) else f"{key}={val}"
                         for key, val in items[:12])
        more = f" ... ({len(items)} scalars)" if len(items) > 12 else ""
        print(f"app {name}: {head}{more}")
        print(f"app {name}: {wall:.2f} s with the kernels ({k1} K1, {k6} K6 launches), "
              f"{wall_plain:.2f} s "
              f"with the plain versions; results equal: {_same(out, plain)}  [{card}]")
        if not _same(out, plain):
            raise AssertionError(f"app {name}: kernels and plain versions disagree")
        if name in FAITHFUL_APPS and k1 <= 0:
            raise AssertionError(f"app {name}: K1 never launched")


KERNEL_OF = (("sliced_matmul_kernel", "K1"), ("sum_k_blocks", "K1"),
             ("paged_decode_kernel", "K2"), ("paged_chunk_kernel", "K3"))


def device_busy(loop, reqs, rep, card):
    """Where the served path's time goes: the requests of ``rep`` (the
    timed run) run once more under ``torch.profiler``, whose device events
    (kernels, copies, fills) are summed per group.  The profiled run is
    not timed (the profiler slows the host side); the device work is the
    same in both runs, so busy / ``rep.wall_s`` is the device's busy
    share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall_ms = rep.wall_s * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop.run(reqs)
        torch.cuda.synchronize()
    groups: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        g = next((k for pat, k in KERNEL_OF if pat in e.name), "other: " + e.name[:60])
        ms, n = groups.get(g, (0.0, 0))
        groups[g] = (ms + e.self_device_time_total / 1e3, n + 1)
    if not groups:
        print("device time of the served path: not measured (the profiler saw no device events)")
        return
    busy = sum(ms for ms, _ in groups.values())
    print(f"device time of the served path ({rep.prefill_chunks_run} prefill chunks, "
          f"{rep.decode_steps} decode steps): busy {busy:.1f} ms of {wall_ms:.1f} ms wall, "
          f"idle share {1 - busy / wall_ms:.3f}  [{card}]")
    other = sorted(((ms, n, g) for g, (ms, n) in groups.items() if g.startswith("other")),
                   reverse=True)
    for g in ("K1", "K2", "K3"):
        ms, n = groups.get(g, (0.0, 0))
        print(f"  {g}: {ms:.2f} ms device in {n} kernel launches")
    print(f"  other device work: {sum(o[0] for o in other):.2f} ms in "
          f"{sum(o[1] for o in other)} launches; largest:")
    for ms, n, g in other[:6]:
        print(f"    {ms:.2f} ms in {n} launches  {g[7:]}")


def main() -> int:
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

    t0 = time.monotonic()
    build.library()
    print(f"built kernels with nvcc in {time.monotonic() - t0:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "build.log"), "w") as fh:
        fh.write(build.build_log())

    qcfg = get("qwen2-0.5b")
    timer = Timer()
    summary: dict = {}
    check_k1(timer, qcfg, summary)
    check_k1_tiles(timer, summary, card)
    check_k2_k3(timer, qcfg, summary)
    check_k4(timer, summary, card)
    check_k5(timer, qcfg, summary, card)
    check_k6(timer, qcfg, summary, card)
    counters: dict = {}
    serve(qcfg, card, counters)
    counters["sliced_matmul"] = summary["sliced_matmul"]["launches"]
    counters["flash_attention"] = summary["flash_attention"]["launches"]
    run_apps(card)

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
