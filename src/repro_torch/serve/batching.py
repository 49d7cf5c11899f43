"""Continuous-batching serving engine over program-once crossbar state
(port of ``repro/serve/batching.py``, greedy decoding only).

* :class:`RequestQueue` is the priority-class admission scheduler
  (``"interactive"`` | ``"batch"``, weighted round-robin, an aging bound
  ``max_queue_skip``, a cache-aware pool-feasible pick) — host-side
  Python, ported as is.
* :class:`ServeLoop` owns ``slots`` decode lanes backed by a PAGED KV
  arena (one block pool per attention layer, indexed through per-slot
  block tables) and ONE programmed model.  Each iteration (1) admits
  ready requests into free lanes through the refcounted
  :class:`~repro_torch.serve.prefix_cache.PrefixCache` (resident prompt
  prefixes are mapped, a shared block about to be written is copied
  first), (2) advances every prefilling lane by ONE prompt chunk, and
  (3) runs one slot-parallel decode step over the active lanes, retiring
  finished requests (EOS / max-token) and freeing their blocks.

Differences from the reference: PyTorch runs eagerly, so there is no
jit cache; the arena is updated IN PLACE (``index_put_``) where the
reference donates it to its jitted steps; sampling, speculative
decoding, generation refresh and meshes are not ported
(``Request.sampling`` and the matching ``ServeConfig`` knobs raise
``NotImplementedError``).

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
from repro_torch.core.rng import PRNGKey
from repro_torch.models import program_params
from repro_torch.models.common import tree_leaves
from repro_torch.models.model import copy_paged_block, init_paged_cache

from .config import ServeConfig
from .engine import make_chunk_prefill, make_decode_step
from .prefix_cache import PrefixCache

__all__ = [
    "Request",
    "RequestResult",
    "RequestQueue",
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
    admission class.  ``sampling`` must stay None (greedy): sampled
    decoding waits for the threefry port (ROADMAP A6)."""

    rid: int
    tokens: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    eos_id: int | None = None
    submit_time: float = 0.0
    priority: str = "batch"  # "interactive" | "batch"
    sampling: object = None

    def __post_init__(self):
        if self.sampling is not None:
            raise NotImplementedError(
                "sampled decoding is not ported to repro_torch yet (greedy only)"
            )


@dataclass
class RequestResult:
    """Per-request outcome; timing fields are host wall-clock seconds
    relative to ``ServeLoop.run`` start (``None`` for refused requests,
    whose reason is in ``error``)."""

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
    )

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
    prefill_pos: int = 0
    first_token_time: float = 0.0
    out: list = field(default_factory=list)
    logits: list | None = None
    decode_steps: int = 0
    prefill_chunks: int = 0
    finish_reason: str | None = None


class ServeLoop:
    """Continuous-batching greedy decoding against shared programmed
    state; per iteration: admit, one prefill chunk per prefilling lane,
    one decode step over the active lanes (see the module docstring).

    ``params`` must already live on ``config.device``; the model is
    programmed there at construction (weight-stationary), unless a
    ``programmed`` tree is passed in."""

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
        if not config.allow_coupled_numerics:
            coupled = [
                pat
                for pat, c in (("default", self.policy.default),) + tuple(self.policy.overrides)
                if c is not None and not c.row_independent
            ]
            if coupled:
                raise ValueError(
                    "policy couples batch rows through the ADC range (faithful "
                    f"adc_mode='dynamic' at {coupled}): a request would decode "
                    "differently next to strangers.  Use adc_mode='dynamic_row' "
                    "or 'fullscale', or pass allow_coupled_numerics=True."
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
        if programmed is None and config.weight_stationary and self.policy.enabled:
            # PRNGKey(0) = the static serving key of the step makers
            programmed = program_params(params, cfg, self.policy, PRNGKey(0))
        self.programmed = programmed
        self._chunk = make_chunk_prefill(
            cfg, self.policy, compute_dtype=self.compute_dtype, kernels=config.kernels
        )
        self._decode = make_decode_step(
            cfg, self.policy, compute_dtype=self.compute_dtype, kernels=config.kernels
        )
        self.prefix_cache = bool(config.prefix_cache)
        self._blocks = PrefixCache(self.kv_blocks, self.block_size, enabled=self.prefix_cache)
        self.interactive_weight = int(config.interactive_weight)
        self.max_queue_skip = int(config.max_queue_skip)

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
        )

    def _refused_result(self, r: Request, msg: str) -> RequestResult:
        return RequestResult(
            rid=r.rid, prompt_len=len(r.tokens), tokens=[], finish_reason="refused",
            submit_time=r.submit_time, admit_time=None, first_token_time=None,
            finish_time=None, decode_steps=0, priority=r.priority, error=msg,
        )

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
        slot_state: list[_SlotState | None] = [None] * K
        next_tok = np.zeros((K,), np.int32)
        active = np.zeros((K,), bool)
        results: dict[int, RequestResult] = {}
        total_chunks = 0
        trace: list | None = [] if self.collect_trace else None
        t0 = time.monotonic()
        decode_steps = generated = occupancy = 0

        def now() -> float:
            return time.monotonic() - t0

        probe = (
            (lambda rq: self._blocks.resident_prefix_len(rq.tokens))
            if self.prefix_cache else None
        )
        while len(results) < len(requests):
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
                slot_state[k] = _SlotState(
                    request=r, admit_time=now(), plan=plan, prefill_pos=plan.resume_pos,
                    logits=[] if self.collect_logits else None,
                )
                active[k] = False

            # 2. one prefill chunk per still-prefilling lane
            chunks_run = 0
            for k in range(K):
                st = slot_state[k]
                if st is None or active[k]:
                    continue
                r = st.request
                plen = len(r.tokens)
                start = st.prefill_pos
                clen = self.prefill_chunk or self._bucket_for(plen - start)
                nv = min(clen, plen - start)
                toks = np.zeros((clen,), np.int32)
                toks[:nv] = np.asarray(r.tokens[start:start + nv], np.int32)
                final = start + nv >= plen
                logits, cache = self._chunk(
                    self.params, cache, torch.from_numpy(toks).to(dev), k, start, nv,
                    final, self.programmed,
                )
                st.prefill_pos = start + nv
                st.prefill_chunks += 1
                chunks_run += 1
                self._blocks.register_progress(st.plan, st.prefill_pos)
                if final:  # the final chunk's logits give the first token
                    row = logits[0]
                    t_first = int(torch.argmax(row))
                    st.first_token_time = now()
                    generated += 1
                    if self._emit(st, t_first, row.cpu().numpy() if self.collect_logits else None):
                        results[r.rid] = self._result(st, now())
                        self._blocks.release(st.plan)
                        slot_state[k] = None
                        continue
                    next_tok[k] = t_first
                    active[k] = True

            # 3. slot-parallel decode over the active lanes
            decoded = int(active.sum())
            if decoded:
                logits, cache = self._decode(
                    self.params, cache, torch.from_numpy(next_tok).to(dev),
                    self.programmed, torch.from_numpy(active.copy()).to(dev),
                )
                toks_np = torch.argmax(logits, dim=-1).cpu().numpy()
                logits_np = logits.cpu().numpy() if self.collect_logits else None
                decode_steps += 1
                occupancy += decoded
                for k in range(K):
                    if not active[k]:
                        continue
                    st = slot_state[k]
                    st.decode_steps += 1
                    generated += 1
                    t = int(toks_np[k])
                    row = logits_np[k] if logits_np is not None else None
                    if self._emit(st, t, row):
                        results[st.request.rid] = self._result(st, now())
                        self._blocks.release(st.plan)
                        slot_state[k] = None
                        active[k] = False
                    else:
                        next_tok[k] = t
            total_chunks += chunks_run
            if trace is not None:
                trace.append({
                    "chunks": chunks_run,
                    "decoded": decoded,
                    "admitted": admitted_now,
                    "deferred": queue.deferrals - def_before,
                })
            if decoded == 0 and chunks_run == 0:
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
            trace=trace,
        )
