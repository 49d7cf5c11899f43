"""Serve launcher of the port: batched greedy generation through the
(optionally memristive) model (port of ``repro/launch/serve.py``).

Weight-stationary by default: the model is programmed once with
``program_params`` and every step reuses the resident crossbar state;
``--per_call`` programs every call on the fly from the same keys::

    python -m repro_torch.launch.serve --smoke --policy mem_faithful \\
        --batch 2 --prompt_len 8 --gen 4 --device cpu

With ``--requests N`` the launcher serves N variable-length requests
through the continuous-batching ``ServeLoop`` (``--slots K`` over a paged
KV arena) and reports TTFT and inter-token latency::

    python -m repro_torch.launch.serve --smoke --policy mem_fast \\
        --requests 8 --slots 4 --gen 8 --device cpu

The flags are the reference's, except:

* ``--device {cuda,cpu}`` (default ``cuda``): where the model lives and
  runs; ``cuda`` without a card raises, it never falls back to the CPU;
* ``--kernels {auto,off,on}``: ``auto`` launches the CUDA kernels on the
  card and runs their plain versions on the CPU; ``off`` runs the plain
  versions on either; ``on`` insists on the kernels and raises on the
  CPU (the reference's ``interpret`` has no counterpart);
* ``--layers N`` cuts the model to N layers (widths unchanged);
* ``--shard_model`` above 1 raises: meshes are not ported.

Without ``--smoke`` the model is ``--arch`` (default qwen2-0.5b) at its
published widths, with random weights drawn from ``PRNGKey(0)`` as the
reference draws them; the prompts are ``randint(PRNGKey(1), (batch,
prompt_len), 0, vocab)``, the reference's draw.  ``--arch`` takes the
ported configurations: qwen2-0.5b, h2o-danube-1.8b, the MoE models
qwen3-moe-235b-a22b and kimi-k2-1t-a32b (token-choice top-8 experts in
every layer; one layer of qwen3-moe fills an H100 at its published
widths), rwkv6-1.6b, the attention-free RWKV6, and jamba-v0.1-52b, the
hybrid of Mamba and attention layers in periods of 8 (``--layers`` takes
whole periods; one published period, MoE included, needs ~208 GB of
faithful slices, more than one H100), whose recurrent state the
lockstep mode carries in its dense cache::

    python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b --layers 1 \
        --policy mem_faithful
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --policy mem_faithful
    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --smoke --policy mem_faithful

The encoder-decoder whisper-tiny and the vision model phi-3-vision-4.2b
take the reference's side inputs, drawn as the reference draws them:
``0.02 * normal(PRNGKey(3), (batch, n_frames, d_model))`` frame
embeddings and ``0.02 * normal(PRNGKey(2), (batch, vision_prefix,
d_model))`` patch embeddings.  A vision model's dense cache holds its
patch prefix too: the launcher passes ``max_len = vision_prefix +
prompt_len + gen + 1`` (the reference's launcher passes none and
``greedy_generate``'s default, ``prompt_len + gen + 1``, is shorter than
the prefill, so it raises)::

    python -m repro_torch.launch.serve --arch whisper-tiny --policy mem_faithful
    python -m repro_torch.launch.serve --arch phi-3-vision-4.2b --layers 16 \
        --policy mem_faithful

With ``--requests`` rwkv6, jamba, whisper and phi-3-vision raise
``NotImplementedError``, as the reference does: the continuous-batching
engine takes all-attention decoders without side inputs (the MoE ones
included) only.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace as dc_replace

import numpy as np
import torch

from repro_torch import configs as arch_configs
from repro_torch.core import DriftModel
from repro_torch.core.prng import PRNGKey, normal, randint
from repro_torch.launch.dryrun import make_policy
from repro_torch.models import init_params, program_params, programmed_byte_size
from repro_torch.serve import Request, SamplingParams, ServeConfig, ServeLoop, greedy_generate

__all__ = ["main"]


def _onoff(ap, name, default, help):
    ap.add_argument(name, nargs="?", const="on", default=default, choices=("on", "off"),
                    help=help)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2-0.5b")
    _onoff(ap, "--smoke", "off", "tiny smoke-sized architecture")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--policy", default="digital",
                    choices=["digital", "mem_fast", "mem_faithful"])
    _onoff(ap, "--per_call", "off",
           "re-program every call instead of programming once")
    ap.add_argument("--shard_model", type=int, default=None,
                    help="not ported: a value above 1 raises")
    ap.add_argument("--requests", type=int, default=0,
                    help="serve N variable-length requests through the continuous-batching "
                         "engine instead of one lockstep batch")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode-slot count of the continuous-batching engine")
    ap.add_argument("--arrival", default="all", choices=["all", "poisson"],
                    help="request arrival process: all at t=0, or Poisson with --rate")
    ap.add_argument("--rate", type=float, default=50.0, help="Poisson arrival rate (requests/s)")
    ap.add_argument("--max_len", type=int, default=None,
                    help="KV arena length per slot (default: fitted to the workload)")
    ap.add_argument("--prefill_chunk", type=int, default=32,
                    help="prefill chunk length in tokens (0 = one bucket-padded chunk "
                         "per prompt)")
    ap.add_argument("--block_size", type=int, default=16,
                    help="paged KV arena block size in tokens")
    ap.add_argument("--kv_blocks", type=int, default=None,
                    help="total paged-arena blocks (default: slots x ceil(max_len/block_size) "
                         "+ trash block)")
    ap.add_argument("--priority_mix", type=float, default=0.0,
                    help="fraction of requests tagged priority='interactive'")
    ap.add_argument("--interactive_weight", type=int, default=4,
                    help="consecutive interactive admissions before one batch request goes "
                         "first under contention")
    ap.add_argument("--max_queue_skip", type=int, default=8,
                    help="aging bound: max later-submitted requests admitted ahead of a "
                         "waiting one (0 = strict FIFO)")
    ap.add_argument("--prefix_cache", nargs="?", const="on", default="on", choices=("on", "off"),
                    help="refcounted prefix block cache ('off': plain free-list allocator)")
    ap.add_argument("--shared_prefix", type=int, default=0,
                    help="prepend a common N-token preamble to every request's prompt")
    ap.add_argument("--sample", type=float, default=0.0,
                    help="sampling temperature of the served requests (0 = greedy); request "
                         "i draws with fold_in(PRNGKey(sample_seed + i), emission index)")
    ap.add_argument("--top_k", type=int, default=0, help="top-k truncation (0 = off)")
    ap.add_argument("--top_p", type=float, default=1.0, help="nucleus truncation (1.0 = off)")
    ap.add_argument("--sample_seed", type=int, default=0,
                    help="base of the per-request sampling seeds")
    ap.add_argument("--spec_k", type=int, default=0,
                    help="speculative decoding: draft tokens proposed per slot per round "
                         "(0 = off)")
    ap.add_argument("--draft_policy", default="digital",
                    choices=["digital", "mem_fast", "mem_faithful"],
                    help="numerics of the speculative draft engine")
    ap.add_argument("--kernels", default="auto", choices=("auto", "off", "on"),
                    help="auto: CUDA kernels on the card, plain versions on the CPU; off: "
                         "plain versions everywhere; on: the kernels, raising on the CPU")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model lives and runs (cuda raises without a card)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to its first N layers (widths unchanged)")
    ap.add_argument("--refresh_every", type=float, default=None,
                    help="device-clock seconds between background crossbar re-programs")
    _onoff(ap, "--drift", "off", "power-law conductance drift on the programmed state")
    ap.add_argument("--drift_nu", type=float, default=0.05, help="power-law drift exponent nu")
    ap.add_argument("--drift_t0", type=float, default=1.0,
                    help="power-law drift reference time t0 (seconds)")
    return ap


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def main(argv=None, *, collect_logits: bool = False):
    """Run the launcher with ``argv`` (default ``sys.argv[1:]``).  Returns
    the (batch, gen + 1) int32 token tensor of the lockstep mode, or the
    ``ServeReport`` of the ``--requests`` mode, as the reference does.
    ``collect_logits`` also keeps every logit row: the lockstep mode then
    returns ``(tokens, logits)``, the report carries them per request."""
    args = _parser().parse_args(argv)
    args.smoke = args.smoke == "on"
    args.per_call = args.per_call == "on"
    if args.shard_model and args.shard_model > 1:
        raise NotImplementedError("--shard_model: meshes are not ported to repro_torch yet")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    if args.kernels == "on" and args.device != "cuda":
        raise ValueError("--kernels on needs --device cuda: the kernels run on the card only")
    kernels = args.kernels != "off"
    dev = args.device
    cfg = arch_configs.get_smoke(args.arch) if args.smoke else arch_configs.get(args.arch)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    policy = make_policy(args.policy)
    if args.requests:
        policy = _row_independent(policy)
    if args.drift == "on":
        policy = _with_drift(policy, args.drift_nu, args.drift_t0)
    params = init_params(cfg, PRNGKey(0), device=dev)
    prompts = randint(PRNGKey(1), (args.batch, args.prompt_len), 0, cfg.vocab, device=dev)
    extra, max_len = side_inputs(cfg, args.batch, dev), None
    if cfg.vision_prefix:
        max_len = cfg.vision_prefix + args.prompt_len + args.gen + 1
    programmed = None
    if not args.per_call and policy.enabled:
        t0 = time.time()
        programmed = program_params(params, cfg, policy, PRNGKey(0), kernels=kernels)
        _sync(dev)
        mb = programmed_byte_size(programmed) / 1e6
        print(f"programmed {mb:.1f} MB of crossbar state in {time.time() - t0:.2f}s")
    if args.requests:
        return _serve_continuous(args, cfg, policy, params, programmed, kernels, collect_logits)
    t0 = time.time()
    out = greedy_generate(
        params, cfg, prompts, args.gen, policy=policy, max_len=max_len,
        compute_dtype=torch.float32, extra_batch=extra or None, programmed=programmed,
        weight_stationary=not args.per_call, kernels=kernels, collect_logits=collect_logits,
    )
    _sync(dev)
    dt = time.time() - t0
    tokens = out[0] if collect_logits else out
    mode = "per-call" if args.per_call else "programmed"
    print(f"generated {tuple(tokens.shape)} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s, {mode})")
    print("sample:", tokens[0][:16].tolist())
    return out


def side_inputs(cfg, batch: int, device) -> dict:
    """The reference launcher's side inputs of ``cfg``: a vision model's
    ``patch_embeds`` (batch, vision_prefix, d) from ``PRNGKey(2)``, an
    encoder-decoder's ``frames`` (batch, n_frames, d) from ``PRNGKey(3)``,
    each ``0.02 * normal``, float32 on ``device``; empty for the rest."""
    extra = {}
    if cfg.vision_prefix:
        extra["patch_embeds"] = 0.02 * normal(
            PRNGKey(2), (batch, cfg.vision_prefix, cfg.d_model), device=device)
    if cfg.encoder is not None:
        extra["frames"] = 0.02 * normal(
            PRNGKey(3), (batch, cfg.encoder.n_frames, cfg.d_model), device=device)
    return extra


def _row_independent(policy):
    """Continuous batching needs row-independent numerics: remap every
    faithful ``adc_mode="dynamic"`` config to ``"dynamic_row"`` before
    the model is programmed."""
    def fix(c):
        if c is not None and not c.row_independent:
            print(f"[serve] {c.mode} adc_mode=dynamic -> dynamic_row "
                  "(continuous batching needs row-independent numerics)")
            return c.replace(adc_mode="dynamic_row")
        return c

    return dc_replace(policy, default=fix(policy.default),
                      overrides=tuple((pat, fix(c)) for pat, c in policy.overrides))


def _with_drift(policy, nu, t0):
    """Attach a power-law conductance :class:`DriftModel` to every DPE
    config of the policy."""
    drift = DriftModel(kind="power", nu=nu, t0=t0)

    def fix(c):
        return None if c is None else c.replace(drift=drift)

    return dc_replace(policy, default=fix(policy.default),
                      overrides=tuple((pat, fix(c)) for pat, c in policy.overrides))


def _serve_continuous(args, cfg, policy, params, programmed, kernels, collect_logits):
    """Continuous-batching mode: N variable-length requests through a
    K-slot table over one shared programmed state; a warm-up pass first,
    then the timed run and its report."""
    rng = np.random.default_rng(0)
    lens = rng.integers(max(1, args.prompt_len // 2), args.prompt_len + 1, size=args.requests)
    arrivals = np.zeros(args.requests)
    if args.arrival == "poisson":
        arrivals = np.cumsum(rng.exponential(1.0 / args.rate, size=args.requests))
    preamble = rng.integers(0, cfg.vocab, size=args.shared_prefix).astype(np.int32)
    max_len = args.max_len or int(lens.max() + args.shared_prefix + args.gen + 1)
    draft_policy = None
    if args.spec_k and args.draft_policy != "digital":
        draft_policy = _row_independent(make_policy(args.draft_policy))
    loop = ServeLoop(
        params, cfg, ServeConfig(
            policy=policy, slots=args.slots, max_len=max_len,
            prefill_chunk=args.prefill_chunk or None, block_size=args.block_size,
            kv_blocks=args.kv_blocks or None, compute_dtype=torch.float32,
            weight_stationary=not args.per_call, prefix_cache=args.prefix_cache == "on",
            interactive_weight=args.interactive_weight, max_queue_skip=args.max_queue_skip,
            refresh_every=args.refresh_every, spec_k=args.spec_k, draft_policy=draft_policy,
            device=args.device, kernels=kernels, collect_logits=collect_logits,
        ), programmed=programmed,
    )
    # the first ceil(mix * N) requests of a random permutation are interactive
    interactive = set(
        rng.permutation(args.requests)[: int(np.ceil(args.priority_mix * args.requests))]
        .tolist()
    )

    def sampling(i):
        if args.sample <= 0:
            return None
        return SamplingParams(temperature=args.sample, top_k=args.top_k, top_p=args.top_p,
                              seed=args.sample_seed + i)

    reqs = [
        Request(
            rid=i,
            tokens=np.concatenate([
                preamble, rng.integers(0, cfg.vocab, size=int(lens[i])).astype(np.int32)]),
            max_new_tokens=args.gen,
            submit_time=float(arrivals[i]),
            priority="interactive" if i in interactive else "batch",
            sampling=sampling(i),
        )
        for i in range(args.requests)
    ]
    # warm-up pass over the same prompts, so the report shows the
    # steady-state engine
    loop.run([Request(rid=-1 - r.rid, tokens=r.tokens, max_new_tokens=2) for r in reqs])
    report = loop.run(reqs)
    mode = "per-call" if args.per_call else "programmed"
    print(f"served {args.requests} requests through {args.slots} slots in "
          f"{report.wall_s:.2f}s: {report.tok_per_s:.1f} tok/s aggregate "
          f"({report.decode_steps} decode steps, occupancy {report.occupancy:.2f}, {mode})")
    lat = report.latency_percentiles()
    print("per-request latency s: "
          f"mean={lat['mean']:.3f} p50={lat['p50']:.3f} p95={lat['p95']:.3f} "
          f"max={lat['max']:.3f}")
    ttft = report.ttft_percentiles()
    print("time-to-first-token s: "
          f"mean={ttft['mean']:.3f} p50={ttft['p50']:.3f} p95={ttft['p95']:.3f} "
          f"max={ttft['max']:.3f}")
    if interactive:
        for cls in ("interactive", "batch"):
            t = report.ttft_percentiles(cls)
            i = report.itl_percentiles(cls)
            if not t:
                continue
            itl_part = f" itl_p50={i['p50']:.4f}" if i else ""
            print(f"  {cls:>11}: {len(report.completed(cls))} reqs, "
                  f"ttft p50={t['p50']:.3f} p95={t['p95']:.3f}" + itl_part)
        print(f"scheduler: {report.scheduler_skips} skips, {report.aged_admissions} aged "
              f"admissions (weight {args.interactive_weight}, skip bound "
              f"{args.max_queue_skip})")
    itl = report.itl_percentiles()
    if itl:
        print("inter-token latency s: "
              f"mean={itl['mean']:.4f} p50={itl['p50']:.4f} p95={itl['p95']:.4f}")
    print(f"paged arena: {report.kv_blocks} blocks x {loop.block_size} tokens, "
          f"{report.kv_blocks_reused} reused, {report.admission_deferrals} admission deferrals")
    print(f"prefix cache [{args.prefix_cache}]: {report.prefix_cache_hits} block hits / "
          f"{report.prefix_cache_misses} misses, {report.prefix_cache_cow_copies} COW copies, "
          f"{report.prefix_cache_evictions} evictions, {report.prefill_chunks_run} prefill "
          "chunks run")
    if args.refresh_every is not None:
        print(f"crossbar refresh: {report.reprogram_swaps} generation swaps (every "
              f"{args.refresh_every:g}s of device time)")
    if args.spec_k:
        acc = report.acceptance_rate
        per_req = [r.acceptance for r in report.completed() if r.acceptance is not None]
        print(f"speculative k={args.spec_k} [{args.draft_policy} draft]: "
              f"{report.tokens_accepted}/{report.tokens_drafted} drafts accepted"
              + (f" ({acc:.3f})" if acc is not None else "")
              + (f", per-request acceptance p50={float(np.median(per_req)):.3f}"
                 if per_req else ""))
    print("counters:", report.counters())
    print("sample:", report.results[0].tokens[:16])
    return report


if __name__ == "__main__":
    main()
