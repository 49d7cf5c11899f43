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
3. hold each kernel against its plain PyTorch version on the card at
   qwen2-0.5b shapes and time both (CUDA events, L2 flushed before each
   launch), beside the least time the card could take;
4. serve qwen2-0.5b at full width (24 layers, random weights from a
   seed) through ``ServeLoop`` with the ``mem_faithful`` policy
   (``dynamic_row`` ADC), programmed on the card: every request must
   complete, every kernel must have launched on the main path, and every
   request's tokens and every logit row (prefill and decode) must match
   the same run with the kernels' plain versions
   (``ServeConfig(kernels=False)``), which holds K2 and the decode-width
   K1 at the served shapes; then the same requests run once more under
   ``torch.profiler`` to split the card's busy time by kernel and give
   its idle share against the first run's wall time.

The line before the card line is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
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
    """Mean device time of a call, L2 flushed before each one.  A spin
    of about a millisecond on the card keeps it busy while the host
    issues the call, so a kernel's time holds no host overhead; a plain
    version that issues more than that from the host is timed with it."""

    def __init__(self):
        self.flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=5, warmup=1) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            total += s.elapsed_time(e)
        return total / iters


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
    decode = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    prefill = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    for label, (k, n) in shapes.items():
        w = torch.randn((k, n), generator=g, device="cuda") * k**-0.5
        for noise in ("off", "program"):
            pw = prepare_weight(w, dcfg.replace(noise_mode=noise), key=1234)
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
                    t, tp = timer(run), timer(plain, iters=2)
                    nbytes = 4 * (sw.numel() + ss.numel() + x.numel() + mm * np_)
                    pairs = dcfg.input_spec.n_slices * dcfg.weight_spec.n_slices
                    flops = 2 * pairs * mm * kp * np_
                    b, by = bound_ms(nbytes, flops)
                    print(f"K1 time {label:7s} M={mm:2d}: kernel {t:.4f} ms  plain {tp:.4f} ms  "
                          f"bound {b:.4f} ms ({by})  x{count} per "
                          f"{'decode step' if mm == 2 else 'prefill chunk'}")
                    acc["ms"] += count * t
                    acc["plain_ms"] += count * tp
                    acc["bytes"] += count * nbytes
                    acc["flops"] += count * flops
            del pw
        del w
        torch.cuda.empty_cache()
    for name, acc in (("decode step (M=2, 169 launches)", decode),
                      ("prefill chunk (M=32, 168 launches, non-final)", prefill)):
        b, by = bound_ms(acc["bytes"], acc["flops"])
        print(f"K1 {name}: kernel {acc['ms']:.3f} ms  plain {acc['plain_ms']:.3f} ms  "
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
    t0 = time.monotonic()
    loop = ServeLoop(params, qcfg, sc)
    torch.cuda.synchronize()
    mb = programmed_byte_size(loop.programmed) / 1e6
    print(f"programmed {mb:.1f} MB of crossbar state on the card in "
          f"{time.monotonic() - t0:.1f} s  [{card}]")
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
    launches = {name: c.count for name, c in ops.COUNTERS.items()}
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


KERNEL_OF = (("fused_sliced_matmul_kernel", "K1"), ("sum_k_blocks", "K1"),
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
    check_k2_k3(timer, qcfg, summary)
    counters: dict = {}
    serve(qcfg, card, counters)

    sources = {
        "fused_sliced_matmul": ("src/repro_torch/csrc/sliced_matmul.cu",
                                "src/repro/kernels/sliced_matmul.py:352"),
        "paged_decode_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:152"),
        "paged_chunk_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                  "src/repro/kernels/paged_attention.py:280"),
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
