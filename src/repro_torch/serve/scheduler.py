"""Continuous-batching scheduler: admission queue + iteration-level plans.

One scheduler iteration mixes *decode steps* (one token per running
request) and *prefill chunks* (up to ``chunk`` prompt tokens of one
request) under a shared per-iteration token budget — the Orca/vLLM
iteration-level scheduling model, sized down to this repo's CPU smoke
scale.  Admission *order* and eviction *victim choice* are delegated to a
pluggable :class:`~repro_torch.serve.policy.SchedPolicy`; the default
:class:`~repro_torch.serve.policy.FifoPolicy` is strict FIFO with head-of-line
blocking — a request is only admitted when the paged allocator can hold
its whole prompt, and the queue head is never skipped in favour of a
smaller later request.  Whatever the policy, the scheduler walks the
policy's admission order and stops at the first failed reservation, so
head-of-line blocking applies to the *policy's* head of line.

Admission *reserves*: ``_admit`` allocates the entire prompt's pages
(all-or-nothing ``ensure_prompt``, attaching cached prefix pages for
free) at admission time, and decode allocation runs *before* admission in
``schedule()`` — so a request can never be admitted and then evicted by
the same iteration's decode steps (the admitted request holds the highest
``admission_seq`` and would otherwise be the preferred victim,
admit->evict churn that inflates ``n_preemptions``).  Prefix-cached
prompt pages fast-forward the request's KV frontier (``computed``) past
content another request already materialised — clamped one token short of
the prompt end, so the final prefill chunk always runs and produces the
first-token logits.

Preemption: when a decode step needs a fresh KV page and the pool is
exhausted, the policy's chosen victim (FIFO: the most-recently-admitted
running request) is evicted and re-enters the *front* of the waiting
queue, keeping its original FIFO rank.  Before any running request is
victimised, the optional ``idle_evict_hook`` gets a chance to release
idle-session KV holds (conversation turns parked between user messages)
— idle sessions are always preferred victims over live requests.  With a host spill tier configured (``allocator.spill_pages >
0``) eviction is **swap-out**: the victim's pages snapshot to host slots
and its KV frontier (``computed``) is preserved, so resume is a
host->device restore instead of recompute.  Without the tier — or when
the tier itself is full — eviction falls back to the recompute policy:
pages are freed, ``computed`` drops to 0, and on resume the engine
re-prefills the prompt and *replays* the already-generated tokens
through the decode path, which reproduces the original computation
exactly (see ``engine.PagedEngine``).

Scheduling invariants the engine and tests rely on:

* **Reservation is all-or-nothing** — ``_admit`` only admits the queue
  head when the allocator can hold its *entire* prompt (or, for a
  spilled head, restore its entire snapshot); a request never holds a
  partial reservation.
* **Admit-then-evict cannot happen within one iteration** — decode
  allocations run before admission, and prefill ensures on reserved
  prompts never allocate, so a request admitted by ``schedule()`` still
  holds its pages (and has drained its COW copies) when any later
  iteration preempts it.  Spill snapshots therefore always read
  fully-materialised pool bytes.
* **Preemption preserves FIFO rank** — a resumed request keeps its
  original ``admission_seq``, so it cannot be victimised by requests it
  used to outrank.

Bucket-aware plans: when constructed with ``row_buckets`` (the engine
passes ``row_buckets(max_batch)`` when decode-row bucketing is on), the
plan records the power-of-two row bucket the engine will pad the decode
batch to (``plan.decode_bucket``) and tops the batch up to that boundary
with budget-deferred decoding requests — the padded slots are computed
either way, so they might as well carry real tokens.  Top-up never
preempts.

Arrivals come from :class:`PoissonArrivals` (open-loop load generator) or
:class:`TraceArrivals` (replay a recorded workload); both yield
``(arrival_tick, prompt_len, max_new_tokens)`` tuples.
"""

from __future__ import annotations

import copy
import enum
from collections import deque
from dataclasses import dataclass, field

import math

import numpy as np

from .kv_allocator import KVBlockAllocator
from .policy import SchedPolicy, make_policy


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"


@dataclass
class Request:
    """One serving request and its full lifecycle accounting.

    ``computed`` is the KV frontier: the number of positions whose K/V
    pages are materialised.  Positions ``[0, len(prompt))`` are filled by
    prefill chunks; positions beyond that by decode steps.  After a
    recompute preemption ``computed`` drops to 0 and climbs back through
    the same chunk schedule, then through decode *replay* of the tokens
    already in ``out_tokens``; after a swap-out preemption (host spill
    tier) ``computed`` is preserved and resume restores the snapshot
    instead.
    """

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival: float = 0.0
    state: RequestState = RequestState.WAITING
    out_tokens: list = field(default_factory=list)
    computed: int = 0
    admitted_at: float = -1.0
    admission_seq: int = -1
    first_token_at: float = -1.0
    finished_at: float = -1.0
    n_preemptions: int = 0
    cached_tokens: int = 0          # prompt tokens skipped, last admission
    last_logits: np.ndarray | None = None
    spilled: bool = False           # snapshot lives in the host spill tier
    resumed_at: float = -1.0        # last re-admission after a preemption
    resume_gaps: list = field(default_factory=list)  # resume -> next token
    last_token_at: float = -1.0     # most recent emitted-token tick
    token_ticks: list = field(default_factory=list)  # tick per emitted token
    # -- front-door attributes (policy + workload layer) --
    tenant: str = "default"         # fairness accounting unit
    priority: int = 0               # class, lower = more important
    session: int = -1               # conversation id; -1 = single-shot
    turn: int = 1                   # 1-based turn within the session
    slo_ttft: float | None = None   # TTFT deadline in scheduler ticks
    slo_tpot: float | None = None   # mean inter-token deadline, ticks

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def seq(self) -> np.ndarray:
        """prompt + generated tokens: the token at each KV position."""
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens, dtype=np.int64)]
        )

    @property
    def total_len(self) -> int:
        return self.prompt_len + len(self.out_tokens)

    @property
    def in_prefill(self) -> bool:
        return self.computed < self.prompt_len

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens

    def latency(self) -> float | None:
        """End-to-end latency in scheduler ticks; None until finished.

        The guards on all three latency accessors matter for percentile
        honesty: the timestamps initialise to ``-1.0`` sentinels, so an
        unguarded accessor on an unfinished request returns a *negative*
        duration that silently drags percentiles taken over
        ``requests.values()`` toward zero."""
        if self.finished_at < 0:
            return None
        return self.finished_at - self.arrival

    def ttft(self) -> float | None:
        """Time to first token; None until the first token exists."""
        if self.first_token_at < 0:
            return None
        return self.first_token_at - self.arrival

    def tpot(self) -> float | None:
        """Mean inter-token gap after the first token (time per output
        token, the decode-stream latency metric); None until a second
        token exists — a one-token request has no inter-token gap."""
        if (self.first_token_at < 0 or self.last_token_at < 0
                or len(self.out_tokens) < 2):
            return None
        return ((self.last_token_at - self.first_token_at)
                / (len(self.out_tokens) - 1))

    def slo_attained(self) -> bool | None:
        """Did this request meet every deadline it carries?  ``None``
        when it carries none (excluded from attainment denominators).
        A TTFT deadline with no first token yet counts as missed —
        unfinished starved requests must drag attainment down, not
        vanish from it."""
        if self.slo_ttft is None and self.slo_tpot is None:
            return None
        ok = True
        if self.slo_ttft is not None:
            t = self.ttft()
            ok = ok and (t is not None and t <= self.slo_ttft)
        if self.slo_tpot is not None:
            g = self.tpot()
            ok = ok and (g is None or g <= self.slo_tpot)
        return ok


@dataclass
class PrefillJob:
    req: Request
    start: int
    n_tokens: int


@dataclass
class IterationPlan:
    decode: list = field(default_factory=list)      # [Request]
    prefill: list = field(default_factory=list)     # [PrefillJob]
    decode_bucket: int = 0    # padded decode rows (0 = engine default)
    runahead_budget: int = 0  # decode-stream staging copies this iteration
    speculative: bool = False  # built by schedule_speculative: shadow
    #                            requests, no real allocations — must pass
    #                            through Scheduler.commit before dispatch
    for_now: float = -1.0     # the tick the plan was built for

    @property
    def n_tokens(self) -> int:
        return len(self.decode) + sum(j.n_tokens for j in self.prefill)

    def signature(self) -> tuple:
        """Order-sensitive identity of the schedule decision: what the
        plan would dispatch, by rid — the unit ``Scheduler.commit``
        compares a speculative draft against the authoritative plan."""
        return (tuple(r.rid for r in self.decode),
                tuple((j.req.rid, j.start, j.n_tokens)
                      for j in self.prefill),
                self.decode_bucket, self.runahead_budget)


def row_buckets(max_rows: int) -> tuple[int, ...]:
    """Power-of-two decode-row buckets up to ``max_rows``: the fixed batch
    shapes a bucketing engine pads ragged batches to.  O(log R_max)
    buckets -> O(log R_max) decode traces over any workload."""
    if max_rows <= 0:
        raise ValueError(f"max_rows must be >= 1, got {max_rows}: a "
                         "degenerate bucket list would pad every decode "
                         "batch to zero rows")
    out = []
    b = 1
    while b < max_rows:
        out.append(b)
        b <<= 1
    out.append(max_rows)
    return tuple(out)


def bucket_for(n_rows: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket holding ``n_rows`` (the padded batch shape).

    ``n_rows`` above the largest bucket is an error, never a clamp: the
    bucket is the padded batch shape the engine allocates, so silently
    returning ``buckets[-1]`` would let a plan carry more decode rows
    than the padded batch has slots (rows dropped at pad time)."""
    for b in buckets:
        if n_rows <= b:
            return b
    raise ValueError(f"n_rows={n_rows} exceeds the largest row bucket "
                     f"{buckets[-1]}: the padded batch cannot hold the "
                     "planned decode rows")


class PoissonArrivals:
    """Open-loop Poisson arrival process in scheduler-tick time.

    ``rate`` is the expected number of request arrivals per iteration;
    prompt and generation lengths are drawn uniformly from the given
    ranges.  Deterministic under ``seed``.
    """

    def __init__(self, n_requests: int, rate: float = 0.5,
                 prompt_len: tuple = (8, 32), gen_len: tuple = (4, 16),
                 seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / rate, size=n_requests)
        t = np.cumsum(gaps)
        self.schedule = [
            (float(t[i]),
             int(rng.integers(prompt_len[0], prompt_len[1] + 1)),
             int(rng.integers(gen_len[0], gen_len[1] + 1)))
            for i in range(n_requests)
        ]

    def __iter__(self):
        return iter(self.schedule)


class TraceArrivals:
    """Replay an explicit ``(tick, prompt_len, max_new)`` workload.

    The schedule is validated up front — non-empty, finite values,
    non-decreasing arrival times, positive lengths — and a violation
    raises ``ValueError`` naming the offending entry, instead of
    silently yielding garbage the engine only trips over many
    iterations later (or worse, never: a NaN tick just sorts
    somewhere)."""

    def __init__(self, schedule) -> None:
        rows = [(float(t), int(p), int(g)) for t, p, g in schedule]
        if not rows:
            raise ValueError("TraceArrivals: empty schedule — a trace "
                             "must contain at least one arrival")
        prev = None
        for i, (t, p, g) in enumerate(rows):
            if not math.isfinite(t):
                raise ValueError(f"TraceArrivals: non-finite arrival "
                                 f"tick {t!r} at entry {i}")
            if prev is not None and t < prev:
                raise ValueError(
                    f"TraceArrivals: arrival times must be "
                    f"non-decreasing, but entry {i} ({t}) precedes "
                    f"entry {i - 1} ({prev})")
            if p <= 0 or g <= 0:
                raise ValueError(
                    f"TraceArrivals: entry {i} has prompt_len={p}, "
                    f"max_new={g}; both must be >= 1")
            prev = t
        self.schedule = rows

    def __iter__(self):
        return iter(self.schedule)


class Scheduler:
    """Iteration-level scheduler over one :class:`KVBlockAllocator`."""

    def __init__(self, allocator: KVBlockAllocator, max_batch: int = 8,
                 chunk: int = 16, token_budget: int = 32,
                 max_running: int = 0,
                 row_buckets: tuple[int, ...] = (),
                 runahead_pages: int = 0,
                 policy: SchedPolicy | str | None = None) -> None:
        self.allocator = allocator
        # admission order + eviction victims are the policy's decisions;
        # the default FifoPolicy reproduces the pre-policy scheduler
        # verbatim.  The policy is deep-copied with the scheduler by
        # schedule_speculative, so its decisions replay identically in
        # draft and commit (the decision-replay contract).
        self.policy = make_policy(policy or "fifo")
        # optional engine callback: release one idle-session KV hold and
        # return True, or False when nothing is held.  Consulted before
        # any running request is victimised and before admission gives
        # up — idle conversations yield to live traffic.  Excluded from
        # speculative deep copies (a draft must not move real pages).
        self.idle_evict_hook = None
        self.max_batch = max_batch
        self.chunk = chunk
        self.token_budget = max(token_budget, 1)
        self.max_running = max_running or max_batch
        # runahead_pages: staging copies granted to the *decode stream*
        # per iteration it runs; 0 disables (the plan then never grants
        # a budget).  The grant is per-stream and independent of
        # co-scheduled prefill — see schedule() for the rationale.
        self.runahead_pages = runahead_pages
        # bucket-aware planning: when the engine pads decode batches to
        # power-of-two buckets, the padded slots cost the same padded
        # call whether they carry NULL rows or real requests — so the
        # plan tops the decode batch up to the bucket boundary with
        # eligible rows the token budget alone would have deferred
        self.row_buckets = tuple(row_buckets)
        self.waiting: deque[Request] = deque()
        self.running: list[Request] = []
        self._admission_seq = 0
        self._now = 0.0                   # tick of the schedule() in flight
        self.n_preemptions = 0
        self.n_swap_outs = 0              # preemptions served by spill
        self.n_swap_ins = 0               # resumes served by restore
        self.prefill_tokens_skipped = 0   # prefix-cache fast-forwards
        # double-buffered plan accounting (the pipelined executor's
        # schedule_speculative/commit cycle)
        self.plan_commits = 0             # speculative plans committed
        self.plan_reuse = 0               # drafts that matched commit
        self.plan_repairs = 0             # drafts with dead rids dropped

    # -- queue interface -----------------------------------------------------

    def add(self, req: Request) -> None:
        req.state = RequestState.WAITING
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- internals -----------------------------------------------------------

    def _preempt(self, victim: Request) -> None:
        # swap-out when the spill tier can take the snapshot, recompute
        # otherwise (tier disabled, or short on slots right now)
        if self.allocator.spill_pages \
                and self.allocator.spill_request(victim.rid):
            victim.spilled = True       # computed preserved: swap resume
            self.n_swap_outs += 1
        else:
            self.allocator.free_request(victim.rid)
            victim.computed = 0
        victim.state = RequestState.PREEMPTED
        victim.n_preemptions += 1
        self.n_preemptions += 1
        self.running.remove(victim)
        # front of the queue: preempted requests keep FIFO priority
        self.waiting.appendleft(victim)

    def _ensure_with_preemption(self, req: Request, n_tokens: int) -> bool:
        """Allocate pages for ``req`` up to ``n_tokens`` positions,
        evicting the policy's chosen victims if the pool is full.
        Idle-session KV holds are released first (always-preferred
        victims); then the policy picks among running requests.  Returns
        False if ``req`` itself had to be preempted (the policy found no
        acceptable victim and deferred the requester)."""
        while not self.allocator.ensure(req.rid, n_tokens):
            # idle conversations yield before any live request does
            if self.idle_evict_hook is not None and self.idle_evict_hook():
                continue
            victim = self.policy.choose_victim(self.running, req,
                                               self._now, self)
            if victim is not None and victim is not req \
                    and any(victim is r for r in self.running):
                self._preempt(victim)
                continue
            # no acceptable victim: preempt the requester itself (defer)
            self._preempt(req)
            return False
        return True

    def _try_reserve(self, head: Request) -> bool:
        """One admission attempt for ``head``: all-or-nothing swap-in or
        prompt reservation.  Pure mechanism — no queue mutation."""
        if head.spilled:
            # swap-resume: restore the snapshot onto fresh HBM pages
            # (all-or-nothing, like a fresh reservation) and keep the
            # preserved KV frontier — no re-prefill, no replay
            if not self.allocator.resume_spilled(
                    head.rid, max(head.prompt_len, head.computed)):
                return False
            head.spilled = False
            self.n_swap_ins += 1
            return True
        # reserve the whole prompt now (all-or-nothing, cached prefix
        # pages attach for free): an admitted request can never lose its
        # prompt pages to this iteration's other allocations
        ok, cached = self.allocator.ensure_prompt(head.rid, head.prompt)
        if not ok:
            return False
        # fast-forward past prefix-cached pages, keeping the last prompt
        # token to recompute: its prefill produces the first-token
        # logits (its page was COW'd on a full hit)
        head.computed = min(cached, head.prompt_len - 1)
        head.cached_tokens = head.computed
        self.prefill_tokens_skipped += head.computed
        return True

    def _admit(self, now: float) -> list[Request]:
        admitted = []
        if not self.waiting:
            return admitted
        # the policy ranks the whole queue once per pass; nothing else
        # mutates ``waiting`` during admission, so the snapshot is exact
        for head in self.policy.admit_order(list(self.waiting), now):
            if len(self.running) >= self.max_running:
                break
            while not self._try_reserve(head):
                # idle-session KV yields its pages before admission
                # blocks on them
                if self.idle_evict_hook is None \
                        or not self.idle_evict_hook():
                    # head-of-line blocking on the *policy's* order: the
                    # ranked head is never skipped for a smaller request
                    return admitted
            self.waiting.remove(head)
            head.state = RequestState.RUNNING
            self.policy.on_admit(head, now)
            if head.n_preemptions > 0:
                # resume-TTFT clock for both policies: the engine appends
                # (token time - resumed_at) to resume_gaps at the next
                # emitted token
                head.resumed_at = now
            # a resumed (previously preempted) request keeps its original
            # admission_seq so it cannot be victimised by requests it
            # used to outrank
            if head.admission_seq < 0:
                head.admitted_at = now
                head.admission_seq = self._admission_seq
                self._admission_seq += 1
            self.running.append(head)
            admitted.append(head)
        return admitted

    # -- the per-iteration plan ----------------------------------------------

    def schedule(self, now: float = 0.0) -> IterationPlan:
        """Build one iteration's mixed prefill/decode plan.

        Decode steps are scheduled first (latency priority — and so their
        page allocations precede admission), then new admissions (whole
        prompts reserved), then prefill chunks — all under
        ``token_budget`` scheduled tokens and ``max_batch`` decode rows
        per iteration.
        """
        plan = IterationPlan()
        self._now = now         # victim scoring reads the current tick
        budget = self.token_budget

        # decode / replay steps: requests past their prompt frontier.
        # These run BEFORE admission so a decode page grab can never
        # victimise a request admitted in this very iteration.
        for req in sorted(self.running, key=lambda r: r.admission_seq):
            if req not in self.running or req.in_prefill or budget <= 0:
                continue
            if len(plan.decode) >= self.max_batch:
                break
            if not self._ensure_with_preemption(req, req.computed + 1):
                continue        # deferred: req preempted itself
            plan.decode.append(req)
            budget -= 1

        self._admit(now)

        # prefill chunks for running requests still materialising
        # prompts (their pages are already reserved from admission, so
        # the ensure below is a no-op safety net, never an eviction)
        for req in sorted(self.running, key=lambda r: r.admission_seq):
            if req not in self.running or not req.in_prefill or budget <= 0:
                continue
            n = min(self.chunk, req.prompt_len - req.computed, budget)
            if not self._ensure_with_preemption(req, req.computed + n):
                continue        # deferred: req preempted itself
            plan.prefill.append(PrefillJob(req, req.computed, n))
            budget -= n

        # a prefill allocation may have evicted a request planned above
        plan.decode = [r for r in plan.decode if r in self.running]
        plan.prefill = [j for j in plan.prefill if j.req in self.running]
        if self.row_buckets and plan.decode:
            self._fill_bucket(plan)
            plan.decode_bucket = bucket_for(len(plan.decode),
                                            self.row_buckets)
        # runahead staging budget is *per stream*: the decode stream is
        # granted the full ``runahead_pages`` whenever it runs, zero when
        # nothing decodes (no selection to predict for).  Prefill no
        # longer halves the grant — under the pipelined executor prefill
        # chunks dispatch on their own stream, so a co-scheduled long
        # prompt does not contend with the decode stream's staging
        # window the way the pre-disaggregation serial loop did.
        if self.runahead_pages > 0 and plan.decode:
            plan.runahead_budget = self.runahead_pages
        plan.for_now = now
        return plan

    def _fill_bucket(self, plan: IterationPlan) -> None:
        """Top the decode batch up to its bucket boundary.

        The engine pads the batch to ``bucket_for(len(decode))`` rows
        either way, so slots the token budget deferred are free compute:
        fill them with eligible decoding requests instead of NULL rows.
        ``plan.n_tokens`` may then exceed ``token_budget`` — by design,
        those tokens ride in already-paid-for padding.  Top-up never
        preempts (plain ``ensure``): a free slot is not worth an
        eviction."""
        bucket = bucket_for(len(plan.decode), self.row_buckets)
        planned = {r.rid for r in plan.decode}
        for req in sorted(self.running, key=lambda r: r.admission_seq):
            if len(plan.decode) >= bucket:
                break
            if req.rid in planned or req.in_prefill:
                continue
            if not self.allocator.ensure(req.rid, req.computed + 1):
                continue
            plan.decode.append(req)

    # -- double-buffered plans (pipelined executor) --------------------------

    def schedule_speculative(self, now: float,
                             in_flight: IterationPlan | None = None
                             ) -> IterationPlan:
        """Build iteration ``now``'s plan as a *draft*, without mutating
        any real scheduler or allocator state.

        This is the overlap-window half of the double buffer: the
        pipelined executor calls it while the device is still executing
        the ``in_flight`` plan's prefill/decode streams, so the host
        builds plan N+1 under step N.  The draft is computed on a deep
        shadow copy of the scheduler (allocator included; immutable
        request arrays are shared, never copied), after replaying the
        *count evolution* the in-flight step will commit — every decode
        row's frontier advances one position, frontier rows emit a
        token, prefill completions emit their first token, and requests
        that reach their token budget finish and free their pages.
        Scheduling decisions depend only on token counts and page-pool
        state, never on sampled token values, so when no new request
        arrives between draft and commit the draft is exact.

        Call this *after* the in-flight plan's prefill chunks have been
        dispatched (their ``computed`` advance happens at dispatch) and
        before the step's sample/commit boundary.  The returned plan
        references shadow requests and holds no real allocations — it
        must go through :meth:`commit` before anything dispatches it.
        """
        # share the immutable per-request arrays: prompts are never
        # mutated and last_logits only rebound, so the shadow can alias
        # them instead of copying megabytes per draft
        memo: dict = {}
        for req in list(self.running) + list(self.waiting):
            memo[id(req.prompt)] = req.prompt
            if req.last_logits is not None:
                memo[id(req.last_logits)] = req.last_logits
        # the idle-evict hook is an engine-bound callback: detach it
        # around the copy so (a) deepcopy never recurses into the
        # engine, and (b) the shadow cannot release real session holds
        # while drafting.  A draft admission that would have needed an
        # idle eviction simply blocks; commit() performs the real
        # eviction and repairs the plan.
        hook, self.idle_evict_hook = self.idle_evict_hook, None
        try:
            shadow = copy.deepcopy(self, memo)
        finally:
            self.idle_evict_hook = hook
        if in_flight is not None:
            by_rid = {r.rid: r for r in shadow.running}
            # decode stream: each row's frontier advances; frontier rows
            # emit (token value irrelevant to scheduling), finished rows
            # release their pages exactly as the commit will
            for row in in_flight.decode:
                r = by_rid.get(row.rid)
                if r is None:
                    continue
                frontier = r.computed == r.total_len - 1
                r.computed += 1
                if frontier:
                    r.out_tokens.append(0)
                    if r.done:
                        shadow.finish(r, now)
            # prefill stream: ``computed`` already advanced at dispatch
            # time (mirroring the engine), so only the completion
            # emission remains to simulate
            for job in in_flight.prefill:
                r = by_rid.get(job.req.rid)
                if r is None or r.computed < r.prompt_len or r.out_tokens:
                    continue
                r.out_tokens.append(0)
                if r.done:
                    shadow.finish(r, now)
        plan = shadow.schedule(now)
        plan.speculative = True
        return plan

    def commit(self, plan: IterationPlan | None,
               now: float) -> IterationPlan:
        """Revalidate a speculative draft against post-step state and
        return the authoritative plan for iteration ``now``.

        Revalidation drops draft rows whose request is no longer
        running, finished, was preempted, or whose KV frontier moved
        under the draft (a stale prefill start) — a speculative plan can
        therefore never dispatch a dead rid or address an
        un-materialised page.  The apply pass then runs the real
        :meth:`schedule` (performing the draft's allocations,
        admissions and preemptions against live state — the one place
        pages actually move), and the committed plan is *by
        construction* the plan the synchronous loop would have built,
        which is what keeps the async executor's schedule, tokens and
        logits bitwise-identical to the sync oracle.  The draft-vs-
        commit match rate is tracked in ``plan_reuse``/``plan_commits``
        (speculation quality; exact whenever no new arrival landed
        between draft and commit).
        """
        draft_sig = None
        if plan is not None and plan.speculative and plan.for_now == now:
            self.plan_commits += 1
            live = {r.rid: r for r in self.running}
            kept_d, kept_p = [], []
            for r in plan.decode:
                real = live.get(r.rid)
                if (real is not None and not real.in_prefill
                        and not real.done):
                    kept_d.append(r)
            for j in plan.prefill:
                real = live.get(j.req.rid)
                if (real is not None and real.in_prefill
                        and j.start == real.computed):
                    kept_p.append(j)
            if len(kept_d) != len(plan.decode) \
                    or len(kept_p) != len(plan.prefill):
                self.plan_repairs += 1
            plan.decode, plan.prefill = kept_d, kept_p
            draft_sig = plan.signature()
        committed = self.schedule(now)
        if draft_sig is not None and draft_sig == committed.signature():
            self.plan_reuse += 1
        return committed

    def finish(self, req: Request, now: float) -> None:
        req.state = RequestState.FINISHED
        req.finished_at = now
        self.allocator.free_request(req.rid)
        if req in self.running:
            self.running.remove(req)
