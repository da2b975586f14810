"""Batched serving engine: continuous batching over fixed decode slots (the
port of ``repro/serving/engine.py``'s ``ServeEngine``, the subset this slice
runs).

  * ``max_slots`` sequences share one ``Model.decode_step`` per tick over a
    KV backend: the contiguous fp8 cache (``kv=DenseKV()``, the default, as
    in the reference) or the paged fp8 pool (``kv=PagedKV(...)``). Every
    tick decodes one token for every active slot; inactive slots feed token
    0 at position 0 (dense: into their own row, which the next request
    overwrites; paged: into the scratch page, attending nothing).
  * **continuous batching**: slots free as sequences finish and are refilled
    from the scheduler's queue mid-flight.
  * **token-mode prefill** (the paper's own): prompt tokens stream through
    ``decode_step`` one per tick, so prefill and decode are one path.
  * **admission and preemption**: under ``PagedKV`` a request is admitted
    when the pool holds its prompt's pages; when the pool runs dry
    mid-decode the scheduler names a victim, whose pages are released and
    which re-enters the queue with its generated tokens as prompt. Under
    ``DenseKV`` pages cost nothing and capacity is unbounded, so a request
    is admissible whenever a slot is free and nothing is preempted for
    pages.
  * **multi-tenant adapters** (``adapters=`` an
    :class:`~repro_torch.serving.adapters.AdapterServing`): a request may
    name an ``adapter_id``, a frozen ternary QLoRA fine-tune from the
    registry. Resident adapters sit in device stacks; each tick sends one
    per-slot ``adapter_idx`` vector (0 = no adapter) into
    ``Model.decode_step``, whose targeted projections add each row's LoRA
    term through the batched-LoRA kernel. Admission prefers requests whose
    adapter is already resident (never against priority or deadline order),
    and the SRAM-budget cache pins an adapter while a request of it is in
    flight; preemption and completion unpin.
  * **sampling** per slot from the request's ``SamplingParams``: greedy,
    temperature, top-k and top-p; seeded requests draw from a
    ``torch.Generator`` keyed by (seed, tokens generated), so they reproduce
    within the port regardless of co-scheduled traffic (not the reference's
    threefry bits).

Not in this slice (the reference has them): batched and chunked prefill,
the prefix cache, speculative decoding, cancel and deadline expiry, tiered
memory (and with it adapter prefetch), tracing and the split-tick async
pipeline.
Deadlines still order the queue (EDF within a priority class).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import Model
from repro_torch.serving.adapters import AdapterServing
from repro_torch.serving.api import RequestSpec, SamplingParams
from repro_torch.serving.gateway.scheduler import Scheduler
from repro_torch.serving.kv import DenseKV, KVBackend

NEG_INF = -1e30


@dataclasses.dataclass
class Request:
    """A submitted request: its frozen `RequestSpec`/`SamplingParams` plus
    the engine's mutable bookkeeping. ``deadline_s`` is the absolute
    wall-clock deadline, derived once from ``spec.deadline_ms``."""
    uid: int
    prompt: List[int]
    spec: RequestSpec = dataclasses.field(default_factory=RequestSpec)
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    deadline_s: Optional[float] = None
    max_new_tokens: int = -1             # mutable budget (clamped to max_len)
    state: str = "queued"  # queued|running|preempted|done|rejected
    output: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_last: float = 0.0
    t_done: float = 0.0
    n_preempts: int = 0
    prefill_ticks: int = 0          # decode ticks spent consuming the prompt
    _seq: int = 0                   # scheduler arrival order

    def __post_init__(self):
        if self.max_new_tokens < 0:
            self.max_new_tokens = self.spec.max_new_tokens
        if (self.deadline_s is None and self.spec.deadline_ms is not None
                and self.t_submit):
            self.deadline_s = self.t_submit + self.spec.deadline_ms / 1e3

    @property
    def temperature(self) -> float:
        return self.sampling.temperature

    @property
    def top_k(self) -> int:
        return self.sampling.top_k

    @property
    def top_p(self) -> float:
        return self.sampling.top_p

    @property
    def seed(self) -> Optional[int]:
        return self.sampling.seed

    @property
    def eos_id(self) -> Optional[int]:
        return self.spec.eos_id

    @property
    def priority(self) -> int:
        return self.spec.priority

    @property
    def adapter_id(self) -> Optional[str]:
        return self.spec.adapter_id

    @property
    def ttft_s(self) -> float:
        return self.t_first - self.t_submit

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass
class EngineStats:
    ticks: int = 0
    tokens_out: int = 0
    completed: int = 0
    preemptions: int = 0
    wall_s: float = 0.0

    @property
    def tps(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s else 0.0


class ServeEngine:
    def __init__(self, model: Model, params, *, max_slots: int = 8,
                 max_len: int = 1024, seed: int = 0,
                 kv: Optional[KVBackend] = None,
                 scheduler: Optional[Scheduler] = None,
                 adapters: Optional[AdapterServing] = None):
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.adapters = adapters
        # the params the decode runs on: with adapters, the base params plus
        # views of the runtime's device stacks (uploads write them in place)
        self._run_params = (params if adapters is None
                            else adapters.install(params))
        self.device = model.device
        self.max_slots = max_slots
        self.max_len = max_len
        # unseeded stochastic draws; seeded requests get their own stream
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.scheduler = scheduler if scheduler is not None else Scheduler()
        self.kv = kv if kv is not None else DenseKV()
        self.kv.bind(model, max_slots, max_len)
        self.pool = self.kv.pool
        self.pos = np.zeros((max_slots,), np.int32)       # next write position
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self.pending_prompt: List[List[int]] = [[] for _ in range(max_slots)]
        self.slot_adapter = np.zeros((max_slots,), np.int32)  # device slot (0=none)
        # version-resolved cache key each slot pinned (released exactly)
        self.slot_adapter_key: List[Optional[str]] = [None] * max_slots
        self.stats = EngineStats()
        self._uid = 0

    # -- sampling ----------------------------------------------------------------
    def _sample_fn(self, logits: torch.Tensor, temperature: np.ndarray,
                   top_k: np.ndarray, top_p: np.ndarray, seeds: np.ndarray,
                   has_seed: np.ndarray, steps: np.ndarray) -> torch.Tensor:
        """Per-slot sampling over logits (B, V). The vectors are (B,) host
        arrays: temperature (0 = greedy), top_k (0 = full softmax), top_p
        (1.0 = off), and per-request seeds with their step counts. Rows pick
        by Gumbel-max over the masked, temperature-scaled logits."""
        greedy = torch.argmax(logits, dim=-1)
        if not np.any(temperature > 0.0):
            return greedy
        dev = logits.device
        vocab = logits.shape[-1]
        top_k_t = torch.from_numpy(top_k.astype(np.int64)).to(dev)
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        k_idx = torch.clamp(top_k_t - 1, 0, vocab - 1)
        thresh = torch.gather(sorted_desc, 1, k_idx[:, None])
        masked = torch.where((top_k_t[:, None] > 0) & (logits < thresh),
                             NEG_INF, logits)
        temp = torch.from_numpy(temperature.astype(np.float32)).to(dev)
        final = masked / torch.clamp(temp[:, None], min=1e-6)
        if np.any(top_p < 1.0):
            # keep the smallest prefix of the sorted distribution whose
            # cumulative probability reaches top_p; ties at the cutoff stay
            top_p_t = torch.from_numpy(top_p.astype(np.float32)).to(dev)
            sorted_scaled = torch.sort(final, dim=-1, descending=True).values
            probs = torch.softmax(sorted_scaled, dim=-1)
            csum = torch.cumsum(probs, dim=-1)
            keep = (csum - probs) < top_p_t[:, None]   # prefix-exclusive mass
            n_keep = torch.clamp(keep.sum(dim=-1), min=1)
            cutoff = torch.gather(sorted_scaled, 1, (n_keep - 1)[:, None])
            final = torch.where((top_p_t < 1.0)[:, None] & (final < cutoff),
                                NEG_INF, final)
        u = torch.rand(final.shape, generator=self.gen, device=dev)
        for i in np.flatnonzero(has_seed):
            g = torch.Generator(device=dev).manual_seed(
                ((int(seeds[i]) % 2**32) << 32) | int(steps[i]))
            u[i] = torch.rand((vocab,), generator=g, device=dev)
        gumbel = -torch.log(-torch.log(u))
        sampled = torch.argmax(final + gumbel, dim=-1)
        use_greedy = torch.from_numpy(temperature <= 0.0).to(dev)
        return torch.where(use_greedy, greedy, sampled)

    # -- public API ---------------------------------------------------------------
    def submit(self, prompt: List[int], spec: Optional[RequestSpec] = None,
               sampling: Optional[SamplingParams] = None) -> Request:
        """Enqueue a request. One naming an ``adapter_id`` that this engine
        could never serve (no adapter runtime, an unknown tenant, or an
        adapter larger than the whole budget) is rejected."""
        if not prompt:
            raise ValueError("a prompt needs at least one token")
        self._uid += 1
        req = Request(self._uid, list(prompt), spec=spec or RequestSpec(),
                      sampling=sampling or SamplingParams(),
                      t_submit=time.time())
        if req.adapter_id is not None and not (
                self.adapters is not None
                and self.adapters.servable(req.adapter_id)):
            req.state = "rejected"
        elif not self.scheduler.push(req):
            req.state = "rejected"
        return req

    def run_until_drained(self, max_ticks: int = 100_000) -> EngineStats:
        t0 = time.time()
        while (len(self.scheduler) or any(r is not None for r in self.slot_req)) \
                and self.stats.ticks < max_ticks:
            before = self.stats.ticks
            self.tick()
            if self.stats.ticks == before \
                    and not any(r is not None for r in self.slot_req):
                # nothing running and nothing admissible (a queued request
                # larger than the page pool): no tick will change that
                break
        self.stats.wall_s += time.time() - t0
        return self.stats

    # -- admission -----------------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _active_pairs(self) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slot_req) if r is not None]

    def _clamped_feed(self, req: Request) -> Tuple[List[int], int]:
        """(feed, remaining_new) after the max_len clamp: a request replays
        its prompt plus any output earned before a preemption; the budget is
        clamped first (at most max_len - 1 new tokens), then the prompt keeps
        its tail."""
        feed = list(req.prompt) + list(req.output)
        remaining_new = max(1, req.max_new_tokens - len(req.output))
        if len(feed) + remaining_new > self.max_len:
            remaining_new = min(remaining_new, self.max_len - 1)
            feed = feed[-(self.max_len - remaining_new):]
        return feed, remaining_new

    def _pages_needed(self, req: Request) -> int:
        """Free pages required to *start* the request (prompt + 1 token)."""
        feed, _ = self._clamped_feed(req)
        return self.kv.pages_for(len(feed) + 1)

    def _pages_lifetime(self, req: Request) -> int:
        """Pages the request holds at its final context length."""
        feed, remaining_new = self._clamped_feed(req)
        return self.kv.pages_for(min(len(feed) + remaining_new, self.max_len))

    def _adapter_warm(self, req: Request) -> bool:
        """Affinity predicate: serving ``req`` costs no adapter load (no
        adapter, or already resident)."""
        return (self.adapters is None or req.adapter_id is None
                or self.adapters.is_resident(req.adapter_id))

    def _adapter_ready(self, req: Request) -> bool:
        """Could ``req``'s adapter be made resident now (evicting only
        unpinned adapters)?"""
        return self.adapters is None or self.adapters.can_serve(req.adapter_id)

    def _can_admit(self, req: Request) -> bool:
        # every budget byte pinned by in-flight adapters: wait for a slot to
        # drain and unpin one
        if not self._adapter_ready(req):
            return False
        # a request whose final context exceeds the whole pool would only
        # fail mid-flight — it stays queued instead
        if self._pages_lifetime(req) > self.kv.capacity_pages:
            return False
        return self.kv.pages_free >= self._pages_needed(req)

    def _admit(self) -> None:
        now = time.time()
        for slot in self._free_slots():
            if not len(self.scheduler):
                break
            req = self.scheduler.pop_next(self._can_admit,
                                          prefer=self._adapter_warm)
            if req is None and self.kv.supports_paging:
                req = self._admit_under_pressure()
            if req is None:
                break
            self._place(slot, req, now)

    def _admit_under_pressure(self) -> Optional[Request]:
        """Nothing fits the pool: preempt lower-priority slots for the most
        urgent queued request, but only if the reclaimed pages make it
        admissible (otherwise the victim is re-admitted next tick and no
        progress is made)."""
        head = self.scheduler.peek(
            lambda r: self._pages_lifetime(r) <= self.kv.capacity_pages
            and self._adapter_ready(r))
        if head is None:
            return None
        needed = self._pages_needed(head)
        if not self._can_admit(head):
            budget = self.kv.pages_free
            pairs = self._active_pairs()
            victims: List[int] = []
            while budget < needed:
                slot = self.scheduler.pick_victim(
                    pairs, below_priority=head.priority)
                if slot is None:
                    return None
                budget += self.kv.slot_pages(slot)
                victims.append(slot)
                pairs = [(i, r) for i, r in pairs if i != slot]
            for slot in victims:
                self._preempt(slot)
        return self.scheduler.pop_next(self._can_admit,
                                       prefer=self._adapter_warm)

    def _place(self, slot: int, req: Request, now: float) -> None:
        req.state = "running"
        req.t_admit = now
        if self.adapters is not None and req.adapter_id is not None:
            # load (evicting LRU unpinned if needed) and pin for the slot's
            # life; the pin is version-resolved, so a re-register while the
            # request streams does not move its weights
            dev_slot, key = self.adapters.acquire_versioned(req.adapter_id)
            self.slot_adapter[slot] = dev_slot
            self.slot_adapter_key[slot] = key
        feed, remaining_new = self._clamped_feed(req)
        req.max_new_tokens = len(req.output) + remaining_new
        self.slot_req[slot] = req
        self.pos[slot] = 0
        # eager reservation of the prompt's pages plus the first output
        # token, so admission sees the true footprint of placed requests
        self.kv.reserve(slot, len(feed) + 1)
        self.pending_prompt[slot] = list(feed)

    # -- capacity / preemption ------------------------------------------------------
    def _ensure_capacity(self, active: List[int]) -> List[int]:
        """Guarantee every active slot can write its next token, preempting
        victims (pages released, request re-queued) when the pool is short."""
        while True:
            need = sum(max(0, self.kv.pages_for(int(self.pos[i]) + 1)
                           - self.kv.slot_pages(i)) for i in active)
            if need <= self.kv.pages_free:
                return active
            pairs = self._active_pairs()
            victim = self.scheduler.pick_victim(pairs)
            if victim is None or len(pairs) <= 1:
                raise MemoryError(
                    "page pool exhausted: a single request's context exceeds "
                    "pool capacity (grow n_pages)")
            self._preempt(victim)
            active = [i for i in active if i != victim]

    def _preempt(self, slot: int) -> None:
        req = self.slot_req[slot]
        req.state = "preempted"
        req.n_preempts += 1
        self.stats.preemptions += 1
        self._release_slot(slot)
        self.scheduler.requeue(req)

    def _release_slot(self, slot: int) -> None:
        if self.slot_adapter_key[slot] is not None:
            self.adapters.release_key(self.slot_adapter_key[slot])
            self.slot_adapter_key[slot] = None
        self.slot_adapter[slot] = 0
        self.kv.release(slot)
        self.slot_req[slot] = None
        self.pending_prompt[slot] = []
        self.pos[slot] = 0

    # -- decode ---------------------------------------------------------------------
    def _sampling_vectors(self, active: List[int]):
        temps = np.zeros((self.max_slots,), np.float32)
        topks = np.zeros((self.max_slots,), np.int32)
        topps = np.ones((self.max_slots,), np.float32)
        seeds = np.zeros((self.max_slots,), np.int64)
        has_seed = np.zeros((self.max_slots,), bool)
        steps = np.zeros((self.max_slots,), np.int64)
        for i in active:
            req = self.slot_req[i]
            temps[i] = req.temperature
            topks[i] = req.top_k
            topps[i] = req.top_p
            if req.seed is not None:
                seeds[i] = req.seed
                has_seed[i] = True
            steps[i] = len(req.output)
        return temps, topks, topps, seeds, has_seed, steps

    def _fed_token(self, i: int) -> int:
        """The token slot ``i`` consumes this tick: its next pending prompt
        token, else its last emitted one."""
        if self.pending_prompt[i]:
            return self.pending_prompt[i][0]
        return self.slot_req[i].output[-1]

    def _emit_token(self, i: int, req: Request, tok: int, now: float) -> None:
        if not req.output:
            req.t_first = now
        req.output.append(tok)
        req.t_last = now
        self.stats.tokens_out += 1
        if (len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)
                or int(self.pos[i]) >= self.max_len):
            req.t_done = now
            req.state = "done"
            self.stats.completed += 1
            self._release_slot(i)

    def tick(self) -> None:
        """Admit, then one decode step for the whole slot batch: every
        active slot feeds one token (a prompt token while its prompt lasts)
        and those past their prompt emit the sampled one."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        active = self._ensure_capacity(active)
        tokens = np.zeros((self.max_slots,), np.int32)
        for i in active:
            tokens[i] = self._fed_token(i)
        state = self.kv.decode_state(active, self.pos)
        dev = self.device
        # one per-slot adapter index vector per tick; None keeps the tick
        # exactly the engine without adapters
        aidx = (None if self.adapters is None
                else torch.from_numpy(self.slot_adapter.copy()).to(dev))
        logits, new_state = self.model.decode_step(
            self._run_params, state, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(self.pos.copy()).to(dev), aidx)
        self.kv.commit(new_state, active, self.pos)
        nxt = self._sample_fn(logits, *self._sampling_vectors(active)).tolist()
        self.stats.ticks += 1
        now = time.time()
        for i in active:
            req = self.slot_req[i]
            self.pos[i] += 1
            if self.pending_prompt[i]:
                self.pending_prompt[i].pop(0)
                req.prefill_ticks += 1
                if self.pending_prompt[i]:
                    continue       # still consuming the prompt: no emission
            self._emit_token(i, req, int(nxt[i]), now)
