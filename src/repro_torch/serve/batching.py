"""Continuous-batching serving engine over program-once crossbar state
(port of ``repro/serve/batching.py``).

* :class:`RequestQueue` is the priority-class admission scheduler
  (``"interactive"`` | ``"batch"``, weighted round-robin, an aging bound
  ``max_queue_skip``, a cache-aware pool-feasible pick) — host-side
  Python, ported as is.
* :class:`ServeLoop` owns ``slots`` decode lanes backed by a PAGED KV
  arena (one block pool per attention layer, indexed through per-slot
  block tables) and the programmed model.  Each iteration (0) samples
  the device clock once (drift ages the programmed state by it; a due
  refresh programs generation N+1 with fresh noise while generation N
  keeps serving), (1) admits ready requests into free lanes through the
  refcounted :class:`~repro_torch.serve.prefix_cache.PrefixCache`, (2)
  advances every prefilling lane by ONE prompt chunk (and its draft
  prefill, with speculation), and (3) runs one slot-parallel decode step
  — or one speculative round — per live generation over the active
  lanes, retiring finished requests and freeing their blocks.

Requests decode greedily or sample (``Request.sampling``: token ``i``
draws with ``fold_in(PRNGKey(seed), i)``, whatever slot it lands in).
With ``spec_k > 0`` a draft engine folded from the same params proposes
``spec_k`` tokens a lane and the target verifies them in one multi-token
forward; a draft is accepted only while it equals the token the target
itself emits, so the emitted tokens are the plain trajectory's and only
throughput moves.  A lane keeps the programmed generation it was
admitted under until it retires; the draft is never re-programmed.

Differences from the reference: PyTorch runs eagerly, so there is no
jit cache and the spec round is a Python loop of draft decodes and one
verify; the arena is updated IN PLACE (``index_put_``) where the
reference donates it; meshes are not ported.

Equivalence contract: every per-row computation is row-independent and
the paged layout and chunking are pure data movement, so a request
emits the same tokens alone or packed next to strangers; faithful
``adc_mode="dynamic"`` (batch-coupled) policies are rejected.
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.layers import MemPolicy
from repro_torch.core.prng import PRNGKey, fold_in
from repro_torch.models import program_params
from repro_torch.models.common import tree_leaves
from repro_torch.models.model import copy_paged_block, init_paged_cache

from .config import ServeConfig
from .engine import make_chunk_prefill, make_decode_step, make_verify_step
from .prefix_cache import PrefixCache
from .sampling import SamplingParams, request_keys, sample_row, sample_rows

__all__ = [
    "Request",
    "RequestResult",
    "RequestQueue",
    "SamplingParams",
    "ServeConfig",
    "ServeLoop",
    "ServeReport",
    "default_buckets",
]

#: the scheduler's priority classes, in selection-preference order
PRIORITY_CLASSES = ("interactive", "batch")


@dataclass
class Request:
    """One generation request.  ``max_new_tokens`` counts every emitted
    token including the one from the prefill logits; ``submit_time`` is
    seconds relative to ``ServeLoop.run`` start; ``priority`` is the
    admission class.  ``sampling`` (a :class:`SamplingParams`, None for
    greedy) draws token ``i`` with ``fold_in(PRNGKey(seed), i)``."""

    rid: int
    tokens: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    eos_id: int | None = None
    submit_time: float = 0.0
    priority: str = "batch"  # "interactive" | "batch"
    sampling: SamplingParams | None = None


@dataclass
class RequestResult:
    """Per-request outcome; timing fields are host wall-clock seconds
    relative to ``ServeLoop.run`` start (``None`` for refused requests,
    whose reason is in ``error``).  Beyond the reference's fields,
    ``generation`` is the programmed generation the request was admitted
    under and ran on to the end."""

    rid: int
    prompt_len: int
    tokens: list[int]
    finish_reason: str  # "eos" | "length" | "refused"
    submit_time: float
    admit_time: float | None
    first_token_time: float | None
    finish_time: float | None
    decode_steps: int
    logits: list[np.ndarray] | None = None  # only when collect_logits
    cached_prompt_tokens: int = 0
    prefill_chunks: int = 0
    priority: str = "batch"
    error: str | None = None
    tokens_drafted: int = 0  # draft proposals the target examined
    tokens_accepted: int = 0  # of those, accepted (== the target's token)
    generation: int = 0  # the programmed generation the request ran on

    @property
    def acceptance(self) -> float | None:
        """Accepted / examined draft proposals (None without a round)."""
        if self.tokens_drafted == 0:
            return None
        return self.tokens_accepted / self.tokens_drafted

    @property
    def latency_s(self) -> float | None:
        if self.finish_time is None:
            return None
        return self.finish_time - self.submit_time

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def itl_s(self) -> float | None:
        if self.first_token_time is None or self.finish_time is None:
            return None
        n = len(self.tokens) - 1
        if n <= 0:
            return 0.0
        return (self.finish_time - self.first_token_time) / n


def _percentiles(vals) -> dict:
    vals = sorted(v for v in vals if v is not None)
    if not vals:
        return {}
    pick = lambda q: vals[min(len(vals) - 1, int(q * len(vals)))]
    return {"mean": sum(vals) / len(vals), "p50": pick(0.50), "p95": pick(0.95), "max": vals[-1]}


@dataclass
class ServeReport:
    """Aggregate outcome of one ``ServeLoop.run`` (counters as in the
    reference's ``ServeReport``)."""

    results: list[RequestResult]
    wall_s: float
    decode_steps: int
    generated_tokens: int
    occupancy: float  # mean active slots per decode step / total slots
    kv_blocks: int = 0
    kv_blocks_reused: int = 0
    prefix_cache_hits: int = 0
    prefix_cache_misses: int = 0
    prefix_cache_evictions: int = 0
    prefix_cache_cow_copies: int = 0
    admission_deferrals: int = 0
    scheduler_skips: int = 0
    aged_admissions: int = 0
    prefill_chunks_run: int = 0
    reprogram_swaps: int = 0
    tokens_drafted: int = 0
    tokens_accepted: int = 0
    trace: list | None = None

    COUNTER_FIELDS = (
        "decode_steps",
        "generated_tokens",
        "kv_blocks",
        "kv_blocks_reused",
        "prefix_cache_hits",
        "prefix_cache_misses",
        "prefix_cache_evictions",
        "prefix_cache_cow_copies",
        "admission_deferrals",
        "scheduler_skips",
        "aged_admissions",
        "prefill_chunks_run",
        "reprogram_swaps",
        "tokens_drafted",
        "tokens_accepted",
    )

    @property
    def acceptance_rate(self) -> float | None:
        """Accepted / examined draft proposals over the run (None when no
        speculative round ran); exactly 1.0 for a draft whose numerics
        are the target's."""
        if self.tokens_drafted == 0:
            return None
        return self.tokens_accepted / self.tokens_drafted

    def counters(self) -> dict:
        return {k: int(getattr(self, k)) for k in self.COUNTER_FIELDS}

    @property
    def tok_per_s(self) -> float:
        return self.generated_tokens / max(self.wall_s, 1e-9)

    def completed(self, priority: str | None = None) -> list[RequestResult]:
        return [
            r for r in self.results
            if r.finish_reason != "refused" and (priority is None or r.priority == priority)
        ]

    def latency_percentiles(self, priority: str | None = None) -> dict:
        return _percentiles(r.latency_s for r in self.completed(priority))

    def ttft_percentiles(self, priority: str | None = None) -> dict:
        return _percentiles(r.ttft_s for r in self.completed(priority))

    def itl_percentiles(self, priority: str | None = None) -> dict:
        return _percentiles(r.itl_s for r in self.completed(priority) if len(r.tokens) > 1)


@dataclass
class _QueueEntry:
    order: tuple
    request: Request
    skips: int = 0


class RequestQueue:
    """Priority-class admission scheduler (the reference's rules, in
    order): (1) the aging bound — at most ``max_queue_skip``
    later-submitted requests are ever admitted ahead of a ready one;
    (2) weighted class selection — interactive preferred for at most
    ``interactive_weight`` consecutive admissions under contention;
    (3) a cache-aware, pool-feasible pick within the class.  Scheduling
    decides only WHEN a request is admitted, never what it decodes to."""

    def __init__(self, interactive_weight: int = 4, max_queue_skip: int = 8):
        if interactive_weight < 1:
            raise ValueError("interactive_weight must be >= 1")
        if max_queue_skip < 0:
            raise ValueError("max_queue_skip must be >= 0")
        self.interactive_weight = int(interactive_weight)
        self.max_queue_skip = int(max_queue_skip)
        self._pending: dict[str, list] = {c: [] for c in PRIORITY_CLASSES}
        self._ready: dict[str, list] = {c: [] for c in PRIORITY_CLASSES}
        self._seq = 0
        self._credit = 0
        self.skips = 0
        self.aged_admissions = 0
        self.deferrals = 0

    def submit(self, request: Request) -> None:
        if request.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"request {request.rid}: priority must be one of "
                f"{PRIORITY_CLASSES} (got {request.priority!r})"
            )
        heapq.heappush(
            self._pending[request.priority], (request.submit_time, self._seq, request)
        )
        self._seq += 1

    def __len__(self) -> int:
        return sum(len(h) for h in self._pending.values()) + sum(
            len(d) for d in self._ready.values()
        )

    def next_arrival(self) -> float | None:
        ts = [h[0][0] for h in self._pending.values() if h]
        return min(ts) if ts else None

    def _release(self, now: float) -> None:
        for c in PRIORITY_CLASSES:
            h = self._pending[c]
            while h and h[0][0] <= now:
                t, seq, r = heapq.heappop(h)
                self._ready[c].append(_QueueEntry(order=(t, seq), request=r))

    def has_ready(self, now: float) -> bool:
        self._release(now)
        return any(self._ready.values())

    def select(self, now: float, try_admit, probe=None):
        """One admission attempt: ``(request, handle)`` or None (one
        deferral event when ready requests existed but none fit)."""
        self._release(now)
        ready_all = [e for c in PRIORITY_CLASSES for e in self._ready[c]]
        if not ready_all:
            return None
        contended = all(self._ready[c] for c in PRIORITY_CLASSES)
        aged = [e for e in ready_all if e.skips >= self.max_queue_skip]
        if aged:
            head = min(aged, key=lambda e: e.order)
            cands = sorted((e for e in ready_all if e.order <= head.order), key=lambda e: e.order)
        else:
            cands = []
            for cls in self._class_order(contended):
                window = self._ready[cls][: self.max_queue_skip + 1]
                if probe is not None and len(window) > 1:
                    window = sorted(window, key=lambda e: -probe(e.request))
                cands.extend(window)
        for e in cands:
            handle = try_admit(e.request)
            if handle is not None:
                return self._admit(e, contended), handle
        self.deferrals += 1
        return None

    def _class_order(self, contended: bool) -> tuple:
        if contended:
            if self._credit < self.interactive_weight:
                return ("interactive", "batch")
            return ("batch", "interactive")
        return tuple(c for c in PRIORITY_CLASSES if self._ready[c])

    def _admit(self, e: _QueueEntry, contended: bool) -> Request:
        cls = e.request.priority
        self._ready[cls].remove(e)
        if self.max_queue_skip > 0 and e.skips >= self.max_queue_skip:
            self.aged_admissions += 1
        for c in PRIORITY_CLASSES:
            for e2 in self._ready[c]:
                if e2.order < e.order:
                    e2.skips += 1
                    self.skips += 1
        if contended:
            if cls == "interactive":
                self._credit = min(self._credit + 1, self.interactive_weight)
            else:
                self._credit = 0
        return e.request


def default_buckets(max_len: int) -> tuple[int, ...]:
    """Prompt-length pad buckets: powers of two capped at ``max_len``."""
    out, b = [], 8
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


@dataclass
class _SlotState:
    request: Request
    admit_time: float
    plan: object  # prefix_cache.AdmitPlan — owns the block references
    # the programmed generation the lane was admitted under: every chunk
    # and decode step of the request runs against it (no swap mid-request)
    programmed: object = None
    gen: int = 0
    prefill_pos: int = 0
    first_token_time: float = 0.0
    out: list = field(default_factory=list)
    logits: list | None = None
    decode_steps: int = 0
    prefill_chunks: int = 0
    finish_reason: str | None = None
    # sampling: keys[i] draws emission i (temp 0.0 = greedy argmax)
    keys: np.ndarray | None = None
    temp: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    # speculation: the draft's prefill frontier and the acceptance counts
    draft_pos: int = 0
    tokens_drafted: int = 0
    tokens_accepted: int = 0


def _coupled(policy: MemPolicy) -> list:
    """The patterns of ``policy`` whose ADC range couples batch rows."""
    return [
        pat
        for pat, c in (("default", policy.default),) + tuple(policy.overrides)
        if c is not None and not c.row_independent
    ]


def _drifts(policy: MemPolicy) -> bool:
    return any(c is not None and c.drift is not None for c in policy.configs())


class ServeLoop:
    """Continuous-batching decoding against programmed state; per
    iteration: the device clock and refresh, admit, one prefill chunk per
    prefilling lane, one decode step or speculative round per live
    generation over the active lanes (see the module docstring).

    ``params`` must already live on ``config.device``; the model is
    programmed there at construction (weight-stationary), unless a
    generation-0 ``programmed`` tree is passed in."""

    def __init__(self, params, cfg, config: ServeConfig | None = None, *, programmed=None):
        config = config or ServeConfig()
        self.config = config
        if cfg.encoder is not None or cfg.vision_prefix:
            raise NotImplementedError(
                f"continuous batching needs per-request side inputs for {cfg.family} models"
            )
        kinds = {cfg.layer_kind(i)[0] for i in range(cfg.n_layers)}
        if kinds != {"attn"}:
            raise NotImplementedError(
                f"continuous batching requires all-attention layers (got {sorted(kinds)})"
            )
        self.policy = config.policy or MemPolicy(default=None)
        self.spec_k = int(config.spec_k)
        self.draft_policy = config.draft_policy or MemPolicy(default=None)
        if not config.allow_coupled_numerics:
            coupled = _coupled(self.policy)
            if coupled:
                raise ValueError(
                    "policy couples batch rows through the ADC range (faithful "
                    f"adc_mode='dynamic' at {coupled}): a request would decode "
                    "differently next to strangers.  Use adc_mode='dynamic_row' "
                    "or 'fullscale', or pass allow_coupled_numerics=True."
                )
            coupled = _coupled(self.draft_policy) if self.spec_k else []
            if coupled:
                raise ValueError(
                    "draft_policy couples batch rows through the ADC range "
                    f"(faithful adc_mode='dynamic' at {coupled}): draft proposals "
                    "(hence acceptance) would depend on slot neighbours.  Use "
                    "adc_mode='dynamic_row' or 'fullscale', or pass "
                    "allow_coupled_numerics=True."
                )
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        for t in tree_leaves(params):
            if t.device != self.device:
                raise ValueError(
                    f"params live on {t.device}, ServeConfig.device is {self.device}"
                )
        self.params = params
        self.cfg = cfg
        self.slots = int(config.slots)
        self.max_len = int(config.max_len)
        self.block_size = int(config.block_size)
        self.blocks_per_slot = -(-self.max_len // self.block_size)
        self.kv_blocks = int(
            config.kv_blocks
            if config.kv_blocks is not None
            else self.slots * self.blocks_per_slot + 1
        )
        self.prefill_chunk = config.prefill_chunk
        self.buckets = tuple(sorted(config.buckets or default_buckets(self.max_len)))
        if self.buckets[-1] > self.max_len:
            raise ValueError("buckets must not exceed max_len")
        self.compute_dtype = config.compute_dtype
        self.cache_dtype = (
            torch.float32 if config.compute_dtype == torch.float32 else torch.bfloat16
        )
        self.collect_logits = config.collect_logits
        self.collect_trace = config.collect_trace
        self.kernels = config.kernels
        if programmed is None and config.weight_stationary and self.policy.enabled:
            # PRNGKey(0) = the static serving key of the step makers
            programmed = program_params(params, cfg, self.policy, PRNGKey(0),
                                        kernels=self.kernels)
        # the draft's state is pinned at generation 0: drafts only steer
        # throughput, so a refresh never re-programs them
        self.draft_programmed = None
        if self.spec_k and config.weight_stationary and self.draft_policy.enabled:
            self.draft_programmed = program_params(
                params, cfg, self.draft_policy, PRNGKey(0), kernels=self.kernels)
        self.programmed = programmed
        steps = dict(compute_dtype=self.compute_dtype, kernels=self.kernels)
        self._chunk = make_chunk_prefill(cfg, self.policy, **steps)
        self._decode = make_decode_step(cfg, self.policy, **steps)
        if self.spec_k:
            self._draft_chunk = make_chunk_prefill(cfg, self.draft_policy, **steps)
            self._draft_decode = make_decode_step(cfg, self.draft_policy, **steps)
            self._verify = make_verify_step(cfg, self.policy, **steps)
        self.prefix_cache = bool(config.prefix_cache)
        self._blocks = PrefixCache(self.kv_blocks, self.block_size, enabled=self.prefix_cache)
        self.interactive_weight = int(config.interactive_weight)
        self.max_queue_skip = int(config.max_queue_skip)
        # programmed-state generations: self.programmed is the current
        # one; the counter persists across run() calls (device state)
        self.refresh_every = config.refresh_every
        self.clock = config.clock
        self.generation = 0
        if self.refresh_every is not None and self.programmed is None:
            raise ValueError(
                "refresh_every needs weight-stationary programmed state (a hardware "
                "policy with weight_stationary=True): there is nothing to re-program"
            )
        # without any drift model no clock value reaches the steps, so
        # they run exactly the drift-free arithmetic
        self._drift_on = _drifts(self.policy) or bool(self.spec_k and _drifts(self.draft_policy))

    # -- helpers ------------------------------------------------------------

    def _blocks_needed(self, r: Request) -> int:
        # KV positions written: prompt 0..plen-1, decode up to plen+max_new-2
        return -(-(len(r.tokens) + r.max_new_tokens - 1) // self.block_size)

    def _bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(f"prompt_len {prompt_len} > max bucket")

    def _refusal(self, r: Request) -> str | None:
        if len(r.tokens) > self.buckets[-1]:
            return (
                f"prompt_len({len(r.tokens)}) exceeds the largest prefill "
                f"bucket ({self.buckets[-1]})"
            )
        return None

    def _validate(self, r: Request) -> None:
        n = len(r.tokens)
        if r.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"request {r.rid}: priority must be one of {PRIORITY_CLASSES} "
                f"(got {r.priority!r})"
            )
        if n < 1:
            raise ValueError(f"request {r.rid}: empty prompt")
        if r.max_new_tokens < 1:
            raise ValueError(f"request {r.rid}: max_new_tokens < 1")
        if n + r.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {r.rid}: prompt_len({n}) + max_new({r.max_new_tokens}) "
                f"exceeds max_len({self.max_len})"
            )
        if self._blocks_needed(r) > self.kv_blocks - 1:
            raise ValueError(
                f"request {r.rid}: needs {self._blocks_needed(r)} KV blocks but "
                f"the pool holds {self.kv_blocks - 1}"
            )

    def _emit(self, st: _SlotState, tok: int, logit_row) -> bool:
        """Record one token; True when the request just finished."""
        st.out.append(tok)
        if st.logits is not None:
            st.logits.append(logit_row)
        r = st.request
        if r.eos_id is not None and tok == r.eos_id:
            st.finish_reason = "eos"
        elif len(st.out) >= r.max_new_tokens:
            st.finish_reason = "length"
        return st.finish_reason is not None

    def _result(self, st: _SlotState, now: float) -> RequestResult:
        return RequestResult(
            rid=st.request.rid,
            prompt_len=len(st.request.tokens),
            tokens=st.out,
            finish_reason=st.finish_reason,
            submit_time=st.request.submit_time,
            admit_time=st.admit_time,
            first_token_time=st.first_token_time,
            finish_time=now,
            decode_steps=st.decode_steps,
            logits=st.logits,
            cached_prompt_tokens=st.plan.cached_len,
            prefill_chunks=st.prefill_chunks,
            priority=st.request.priority,
            tokens_drafted=st.tokens_drafted,
            tokens_accepted=st.tokens_accepted,
            generation=st.gen,
        )

    def _refused_result(self, r: Request, msg: str) -> RequestResult:
        return RequestResult(
            rid=r.rid, prompt_len=len(r.tokens), tokens=[], finish_reason="refused",
            submit_time=r.submit_time, admit_time=None, first_token_time=None,
            finish_time=None, decode_steps=0, priority=r.priority, error=msg,
        )

    def _chunk_tokens(self, r: Request, start: int):
        """(tokens, n_valid) of the prompt chunk starting at ``start``."""
        plen = len(r.tokens)
        clen = self.prefill_chunk or self._bucket_for(plen - start)
        nv = min(clen, plen - start)
        toks = np.zeros((clen,), np.int32)
        toks[:nv] = np.asarray(r.tokens[start:start + nv], np.int32)
        return torch.from_numpy(toks).to(self.device), nv

    def _spec_round(self, cache, draft_cache, tokens, pos_t, pos_d, prog, mask, t_now,
                    keys_d, keys_v, temps, top_ks, top_ps):
        """One speculative round: commit both caches' accepted frontiers
        (``pos_t`` / ``pos_d``), ``spec_k`` draft decodes each drawing
        with the key of its emission, one more draft decode that writes
        the last proposal's K/V, then the target's verify of all C =
        spec_k + 1 positions.  Returns the target's logits (K, C, V), the
        tokens it emits at each position (K, C) — drawn with the keys the
        plain path would use — and the proposed tokens (K, C)."""
        dev = self.device
        k_sl, c = len(tokens), self.spec_k + 1
        cache["pos"] = torch.from_numpy(pos_t).to(dev)
        draft_cache["pos"] = torch.from_numpy(pos_d).to(dev)
        active = torch.from_numpy(mask).to(dev)
        toks = torch.from_numpy(tokens).to(dev).long()
        cols = [toks]
        for j in range(self.spec_k):
            logits, draft_cache = self._draft_decode(
                self.params, draft_cache, toks, self.draft_programmed, active, t_now)
            toks = sample_rows(keys_d[j], logits, temps, top_ks, top_ps)
            cols.append(toks)
        _, draft_cache = self._draft_decode(
            self.params, draft_cache, toks, self.draft_programmed, active, t_now)
        tokens_c = torch.stack(cols, dim=1)
        logits, cache = self._verify(self.params, cache, tokens_c, prog, active, t_now)
        rep = lambda a: np.repeat(np.asarray(a), c)  # noqa: E731
        toks_v = sample_rows(keys_v.reshape(k_sl * c, 2), logits.reshape(k_sl * c, -1),
                             rep(temps), rep(top_ks), rep(top_ps)).reshape(k_sl, c)
        return logits, toks_v, tokens_c

    # -- the loop -----------------------------------------------------------

    def run(self, requests) -> ServeReport:
        """Serve ``requests`` to completion; results come back in
        submission order.  A prompt longer than the largest pad bucket is
        refused per request; a request over ``max_len`` or the whole pool
        raises."""
        requests = list(requests)
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("request rids must be unique")
        refused: dict[int, RequestResult] = {}
        live = []
        for r in requests:
            msg = self._refusal(r)
            if msg is not None:
                refused[r.rid] = self._refused_result(r, msg)
                continue
            self._validate(r)
            live.append(r)
        report = self._run(live)
        if refused:
            by_rid = {res.rid: res for res in report.results}
            by_rid.update(refused)
            report.results = [by_rid[r.rid] for r in requests]
        return report

    def _run(self, requests) -> ServeReport:
        queue = RequestQueue(
            interactive_weight=self.interactive_weight, max_queue_skip=self.max_queue_skip
        )
        for r in requests:
            queue.submit(r)
        self._blocks.reset()
        K = self.slots
        dev = self.device
        cache = init_paged_cache(
            self.cfg, K, self.max_len, self.block_size, self.kv_blocks,
            self.cache_dtype, device=dev,
        )
        run_sampled = any(r.sampling is not None for r in requests)
        spec = self.spec_k > 0
        C = self.spec_k + 1
        draft_cache = None
        if spec:
            # the draft's own arena, statically partitioned: slot k owns
            # blocks 1 + k*nbps .. (k+1)*nbps (block 0 stays trash)
            draft_cache = init_paged_cache(
                self.cfg, K, self.max_len, self.block_size,
                K * self.blocks_per_slot + 1, self.cache_dtype, device=dev,
            )
        slot_state: list[_SlotState | None] = [None] * K
        next_tok = np.zeros((K,), np.int32)
        active = np.zeros((K,), bool)
        # the sampling knobs of each slot's occupant (temp 0 = greedy)
        slot_temp = np.zeros((K,), np.float32)
        slot_topk = np.zeros((K,), np.int32)
        slot_topp = np.ones((K,), np.float32)
        results: dict[int, RequestResult] = {}
        total_chunks = swaps = 0
        trace: list | None = [] if self.collect_trace else None
        t0 = time.monotonic()
        decode_steps = generated = occupancy = 0

        def now() -> float:
            return time.monotonic() - t0

        # the DEVICE clock ages drift and drives refresh (injectable for
        # tests); latency metrics always use the wall clock above
        dev_clock = self.clock or now
        # one start-of-run sample whether or not refresh is armed, so the
        # clock sequence (and the drift it ages) is the same either way
        t_start = dev_clock()
        next_refresh = None if self.refresh_every is None else t_start + self.refresh_every
        probe = (
            (lambda rq: self._blocks.resident_prefix_len(rq.tokens))
            if self.prefix_cache else None
        )

        def retire(k: int) -> None:
            st = slot_state[k]
            results[st.request.rid] = self._result(st, now())
            self._blocks.release(st.plan)
            slot_state[k] = None
            active[k] = False

        def gen_masks():
            """(mask, programmed) of each live generation's active lanes."""
            gens = sorted({slot_state[k].gen for k in range(K) if active[k]})
            for g in gens:
                mask = np.array([bool(active[k]) and slot_state[k].gen == g for k in range(K)])
                yield mask, slot_state[int(np.flatnonzero(mask)[0])].programmed

        while len(results) < len(requests):
            # 0. one device-clock sample per iteration: every step of the
            # iteration ages drift to it, and a due refresh programs
            # generation N+1 (fresh noise fold_in(key0, N+1), t_prog =
            # now) once the lanes of an older generation have drained —
            # at most two generations are live
            t_dev = dev_clock()
            t_arg = float(np.float32(t_dev)) if self._drift_on else None
            if next_refresh is not None and t_dev >= next_refresh:
                draining = any(st is not None and st.gen != self.generation
                               for st in slot_state)
                if not draining:
                    self.generation += 1
                    self.programmed = program_params(
                        self.params, self.cfg, self.policy,
                        fold_in(PRNGKey(0), self.generation), t_prog=t_dev,
                        kernels=self.kernels,
                    )
                    swaps += 1
                    next_refresh = t_dev + self.refresh_every

            # 1. admit: the scheduler binds ready requests to free lanes,
            # eagerly allocating each pick's full KV block need
            def_before = queue.deferrals
            admitted_now: list[int] = []
            for k in range(K):
                if slot_state[k] is not None:
                    continue
                sel = queue.select(
                    now(),
                    lambda rq: self._blocks.admit(rq.tokens, self._blocks_needed(rq)),
                    probe=probe,
                )
                if sel is None:
                    break
                r, plan = sel
                admitted_now.append(r.rid)
                bt_row = np.zeros((self.blocks_per_slot,), np.int32)
                bt_row[: len(plan.blocks)] = plan.blocks
                cache["block_tables"][k] = torch.from_numpy(bt_row).to(dev)
                cache["pos"][k] = 0
                if plan.cow is not None:
                    # clone the shared block this lane is about to write into
                    copy_paged_block(cache, *plan.cow)
                sp = r.sampling
                n_keys = r.max_new_tokens + self.spec_k + 1
                if sp is not None and sp.temperature > 0:
                    keys = request_keys(sp.seed, n_keys)
                    temp, tk, tp = float(sp.temperature), int(sp.top_k), float(sp.top_p)
                else:  # greedy: the keys never reach a draw
                    keys = np.zeros((n_keys, 2), np.uint32)
                    temp, tk, tp = 0.0, 0, 1.0
                slot_temp[k], slot_topk[k], slot_topp[k] = temp, tk, tp
                slot_state[k] = _SlotState(
                    request=r, admit_time=now(), plan=plan,
                    programmed=self.programmed, gen=self.generation,
                    prefill_pos=plan.resume_pos,
                    logits=[] if self.collect_logits else None,
                    keys=keys, temp=temp, top_k=tk, top_p=tp,
                )
                active[k] = False
                if spec:
                    # the draft prefills the whole prompt from 0 in its own
                    # block range (its arena shares nothing)
                    draft_cache["block_tables"][k] = torch.arange(
                        1 + k * self.blocks_per_slot, 1 + (k + 1) * self.blocks_per_slot,
                        dtype=torch.int32, device=dev)
                    draft_cache["pos"][k] = 0

            # 2. one prefill chunk per still-prefilling lane (and one draft
            # chunk with speculation); the lane decodes once both engines
            # hold the prompt, its first token from the target's last chunk
            chunks_run = draft_chunks = 0
            for k in range(K):
                st = slot_state[k]
                if st is None or active[k]:
                    continue
                r = st.request
                plen = len(r.tokens)
                if st.prefill_pos < plen:
                    start = st.prefill_pos
                    toks, nv = self._chunk_tokens(r, start)
                    final = start + nv >= plen
                    logits, cache = self._chunk(
                        self.params, cache, toks, k, start, nv, final, st.programmed, t_arg,
                    )
                    st.prefill_pos = start + nv
                    st.prefill_chunks += 1
                    chunks_run += 1
                    self._blocks.register_progress(st.plan, st.prefill_pos)
                    if final:  # the final chunk's logits give the first token
                        row = logits[0]
                        if st.temp > 0:  # emission 0 draws with keys[0]
                            t_first = sample_row(st.keys[0], row, st.temp, st.top_k, st.top_p)
                        else:
                            t_first = int(torch.argmax(row))
                        st.first_token_time = now()
                        generated += 1
                        if self._emit(st, t_first,
                                      row.cpu().numpy() if self.collect_logits else None):
                            retire(k)
                            continue
                        next_tok[k] = t_first
                if spec and st.draft_pos < plen:
                    # final=False: the draft needs no prefill logits
                    toks, nv = self._chunk_tokens(r, st.draft_pos)
                    _, draft_cache = self._draft_chunk(
                        self.params, draft_cache, toks, k, st.draft_pos, nv, False,
                        self.draft_programmed, t_arg,
                    )
                    st.draft_pos += nv
                    draft_chunks += 1
                if st.prefill_pos >= plen and (not spec or st.draft_pos >= plen) and st.out:
                    active[k] = True

            # 3. one decode step (or speculative round) per live generation
            # over its active lanes (complementary masks: a masked-out
            # lane writes only the trash block, so the calls compose)
            decoded = int(active.sum())
            if decoded and not spec:
                toks_np = np.zeros((K,), np.int64)
                logits_np = None
                keys_now = np.zeros((K, 2), np.uint32)
                if run_sampled:  # emission index of this step's token = len(out)
                    for k in range(K):
                        if active[k]:
                            keys_now[k] = slot_state[k].keys[len(slot_state[k].out)]
                for mask, prog in gen_masks():
                    logits, cache = self._decode(
                        self.params, cache, torch.from_numpy(next_tok).to(dev), prog,
                        torch.from_numpy(mask).to(dev), t_arg,
                    )
                    if run_sampled:
                        toks = sample_rows(keys_now, logits, slot_temp * mask, slot_topk,
                                           slot_topp)
                    else:
                        toks = torch.argmax(logits, dim=-1)
                    decode_steps += 1
                    occupancy += int(mask.sum())
                    toks_np[mask] = toks.cpu().numpy()[mask]
                    if self.collect_logits:
                        l_np = logits.cpu().numpy()
                        logits_np = np.zeros_like(l_np) if logits_np is None else logits_np
                        logits_np[mask] = l_np[mask]
                for k in range(K):
                    if not active[k]:
                        continue
                    st = slot_state[k]
                    st.decode_steps += 1
                    generated += 1
                    t = int(toks_np[k])
                    if self._emit(st, t, logits_np[k] if logits_np is not None else None):
                        retire(k)
                    else:
                        next_tok[k] = t
            elif decoded:
                # speculative rounds: the target's token at each verified
                # position is what gets emitted; acceptance only decides
                # how many of the round's columns are usable
                for mask, prog in gen_masks():
                    keys_d = np.zeros((self.spec_k, K, 2), np.uint32)
                    keys_v = np.zeros((K, C, 2), np.uint32)
                    for k in np.flatnonzero(mask):
                        st = slot_state[k]
                        e0 = len(st.out)
                        keys_d[:, k] = st.keys[e0:e0 + self.spec_k]
                        keys_v[k] = st.keys[e0:e0 + C]
                    # the accepted frontier going into the round: active =
                    # one past the last emitted token's KV, prefilling = the
                    # chunk frontier, free = parked at 0
                    pos_t = np.zeros((K,), np.int32)
                    pos_d = np.zeros((K,), np.int32)
                    for k in range(K):
                        st = slot_state[k]
                        if st is None:
                            continue
                        if active[k]:
                            pos_t[k] = pos_d[k] = len(st.request.tokens) + len(st.out) - 1
                        else:
                            pos_t[k], pos_d[k] = st.prefill_pos, st.draft_pos
                    logits, toks_v, tokens_c = self._spec_round(
                        cache, draft_cache, next_tok, pos_t, pos_d, prog, mask, t_arg,
                        keys_d, keys_v, slot_temp * mask, slot_topk, slot_topp,
                    )
                    decode_steps += 1
                    occupancy += int(mask.sum())
                    toks_v = toks_v.cpu().numpy()
                    tokens_c = tokens_c.cpu().numpy()
                    l_np = logits.cpu().numpy() if self.collect_logits else None
                    for k in np.flatnonzero(mask):
                        st = slot_state[k]
                        st.decode_steps += 1
                        fin = False
                        for c in range(C):
                            tok_t = int(toks_v[k, c])
                            generated += 1
                            fin = self._emit(st, tok_t, l_np[k, c] if l_np is not None else None)
                            if fin or c == C - 1:
                                break
                            # column c+1 is valid iff its input (the draft)
                            # is the token the target just emitted
                            st.tokens_drafted += 1
                            if int(tokens_c[k, c + 1]) != tok_t:
                                break
                            st.tokens_accepted += 1
                        if fin:
                            retire(k)
                        else:
                            next_tok[k] = st.out[-1]
            total_chunks += chunks_run
            if trace is not None:
                trace.append({
                    "chunks": chunks_run,
                    "decoded": decoded,
                    "admitted": admitted_now,
                    "deferred": queue.deferrals - def_before,
                })
            if decoded == 0 and chunks_run == 0 and draft_chunks == 0:
                if len(results) == len(requests):
                    break
                if queue.has_ready(now()):
                    continue  # pool-starved; a retirement frees blocks
                nxt = queue.next_arrival()
                if nxt is None:  # pragma: no cover - defensive
                    break
                wait = nxt - now()
                if wait > 0:
                    time.sleep(min(wait, 0.05))

        wall = now()
        ordered = [results[r.rid] for r in requests]
        alloc = self._blocks
        return ServeReport(
            results=ordered,
            wall_s=wall,
            decode_steps=decode_steps,
            generated_tokens=generated,
            occupancy=(occupancy / (decode_steps * K) if decode_steps else 0.0),
            kv_blocks=self.kv_blocks,
            kv_blocks_reused=alloc.blocks_reused,
            prefix_cache_hits=alloc.hits,
            prefix_cache_misses=alloc.misses,
            prefix_cache_evictions=alloc.evictions,
            prefix_cache_cow_copies=alloc.cow_copies,
            admission_deferrals=queue.deferrals,
            scheduler_skips=queue.skips,
            aged_admissions=queue.aged_admissions,
            prefill_chunks_run=total_chunks,
            reprogram_swaps=swaps,
            tokens_drafted=sum(res.tokens_drafted for res in ordered),
            tokens_accepted=sum(res.tokens_accepted for res in ordered),
            trace=trace,
        )
