"""Pluggable scheduling policies: who gets admitted, who gets evicted.

The :class:`~repro_torch.serve.scheduler.Scheduler` owns the *mechanism* of
iteration-level scheduling — reservation, token budgets, plan assembly,
the speculative/commit double buffer — and delegates exactly two
*decisions* to a policy object:

* ``admit_order(waiting, now)`` — the order in which waiting requests
  are offered admission.  The scheduler walks the order and stops at the
  first request whose reservation fails (head-of-line blocking **on the
  policy's order**), so the policy controls who the head of line *is*
  but not the all-or-nothing reservation contract.
* ``choose_victim(running, requester, now, sched)`` — which running
  request to evict when ``requester`` needs a page and the pool is
  full.  Returning ``None`` means "no acceptable victim": the scheduler
  then preempts (defers) the requester itself.

``on_admit(req, now)`` is the bookkeeping hook: the scheduler calls it
once per *actual* admission so stateful policies (tenant deficit
counters) charge only for service that really happened — ``admit_order``
itself must be a **pure read** of policy + request state.

Decision-replay contract (the speculative scheduler): policies live as
an attribute of the scheduler, so ``schedule_speculative`` deep-copies
them along with the queues.  A draft built on the shadow and the real
``commit`` therefore start from identical policy state, and as long as
decisions are deterministic functions of request/queue/counter state
(never wall clock, never RNG, never sampled token values) the draft
replays exactly — which is what keeps the pipelined executor's double-buffered plans
valid under any policy.  Stateful policies must also deep-copy cleanly:
keep counters in plain dicts keyed by tenant strings, never hold
references to engine-side objects.

Policies:

* :class:`FifoPolicy` — the pre-refactor behaviour, verbatim: strict
  FIFO admission with head-of-line blocking, preempt-youngest eviction
  (the running request with the highest ``admission_seq`` that is
  younger than the requester).  This is the default and the parity
  oracle: with it, tokens and logits are bitwise-identical to the
  hardwired scheduler on every bench.
* :class:`PriorityPolicy` — strict priority classes (lower ``priority``
  value = more important), FIFO within a class; eviction victimises the
  lowest class first, youngest within the class, and never a request
  that outranks the requester.
* :class:`SloFairPolicy` — per-tenant deficit-round-robin admission
  (fair-queueing by cumulative service counters) and SLO-aware
  eviction: the victim is the running request whose eviction least
  harms aggregate SLO attainment, scored from per-request TTFT/TPOT
  deadlines and the known swap-vs-recompute resume cost of the spill
  tier.
"""

from __future__ import annotations

import math


class SchedPolicy:
    """Admission-order + eviction-victim decisions for the scheduler.

    Subclasses override the three hooks; state (if any) must deep-copy
    cleanly and decisions must be deterministic — see the module
    docstring for the decision-replay contract.
    """

    name = "base"

    def admit_order(self, waiting, now):
        """Return the waiting requests in admission-offer order.

        Must be a **pure** function of policy + request state (no
        mutation: the speculative scheduler and the engine's fetch-back
        probe call this without admitting anyone), and must return every
        waiting request exactly once — completeness is what rules out
        starvation-by-omission for any policy.
        """
        raise NotImplementedError

    def choose_victim(self, running, requester, now, sched=None):
        """Pick the running request to evict so ``requester`` can
        allocate, or ``None`` to defer the requester instead."""
        raise NotImplementedError

    def on_admit(self, req, now):
        """Bookkeeping callback: ``req`` was actually admitted."""


class FifoPolicy(SchedPolicy):
    """Strict FIFO admission, preempt-youngest eviction (the
    pre-refactor scheduler's hardwired behaviour, verbatim)."""

    name = "fifo"

    def admit_order(self, waiting, now):
        return list(waiting)

    def choose_victim(self, running, requester, now, sched=None):
        victims = [r for r in running
                   if r is not requester
                   and r.admission_seq > requester.admission_seq]
        if not victims:
            return None
        return max(victims, key=lambda r: r.admission_seq)


class PriorityPolicy(SchedPolicy):
    """Strict priority classes; FIFO within a class.

    ``Request.priority`` is the class (lower value = more important;
    the default 0 is the highest class).  Admission offers classes in
    order, FIFO within each (stable sort).  Eviction victimises the
    request with the *worst* ``(priority, admission_seq)`` rank, and
    only if that rank is strictly worse than the requester's — a
    request is never evicted for one it outranks, which is the same
    no-inversion guard FIFO gets from ``admission_seq`` alone.
    """

    name = "priority"

    @staticmethod
    def _rank(r):
        return (r.priority, r.admission_seq)

    def admit_order(self, waiting, now):
        return sorted(waiting, key=lambda r: r.priority)

    def choose_victim(self, running, requester, now, sched=None):
        victims = [r for r in running
                   if r is not requester
                   and self._rank(r) > self._rank(requester)]
        if not victims:
            return None
        return max(victims, key=self._rank)


class SloFairPolicy(SchedPolicy):
    """Per-tenant deficit-round-robin admission + SLO-aware eviction.

    Admission is deficit round robin over tenants with *token* costs
    (classic DRR charges bytes; prompts are the serve-side analogue):
    ``served`` holds one cumulative service counter per tenant (the
    deficit bookkeeping — tenant *t*'s deficit versus *u* is
    ``served[u] - served[t]``), and each queued request gets the virtual
    start tag ``served[tenant] + cost of the tenant's queued requests
    ahead of it``.  Ordering by start tag interleaves tenants in
    proportion to what they have already consumed, so one tenant's burst
    of *long* prompts cannot head-of-line block another tenant's cheap
    interactive requests (the count-based variant would actually favour
    the bursty tenant: few huge requests look "under-served" per
    request), while requests within a tenant stay FIFO.  Counters are
    charged in :meth:`on_admit` only — one charge per actual admission,
    so ``sum(served.values())`` always equals the summed cost of all
    admissions (the conservation invariant the property tests audit)
    and ``admit_order`` stays pure.

    Eviction minimises aggregate SLO harm.  Each candidate is scored
    ``harm = resume_cost x urgency``: ``resume_cost`` is the known
    swap-vs-recompute cost of bringing the victim back (restore ticks
    when the spill tier has slots for its pages, re-prefill + decode
    replay ticks otherwise), and ``urgency`` grows as the candidate's
    TTFT/TPOT deadline slack shrinks.  Requests with no SLO — or whose
    SLO is already lost — are nearly free to evict.  The victim is the
    minimum-harm candidate, and only if evicting it harms less than
    deferring the requester itself; otherwise ``None`` (defer).
    """

    name = "slo_fair"

    # urgency multipliers for the no-deadline / already-lost cases: tiny
    # but nonzero, so resume cost still breaks ties among "free" victims
    NO_SLO_URGENCY = 0.1
    LOST_URGENCY = 0.2

    def __init__(self):
        self.served: dict[str, int] = {}

    @staticmethod
    def _cost(r) -> int:
        """Admission cost in tokens: the prompt the prefill must chew
        through (decode length is unknown at admission time)."""
        return max(int(r.prompt_len), 1)

    def admit_order(self, waiting, now):
        acc: dict[str, int] = {}
        keyed = []
        for i, r in enumerate(waiting):
            start = self.served.get(r.tenant, 0) + acc.get(r.tenant, 0)
            acc[r.tenant] = acc.get(r.tenant, 0) + self._cost(r)
            keyed.append((start, i, r))
        keyed.sort(key=lambda e: (e[0], e[1]))
        return [r for _, _, r in keyed]

    def on_admit(self, req, now):
        self.served[req.tenant] = (self.served.get(req.tenant, 0)
                                   + self._cost(req))

    # -- eviction-harm model -------------------------------------------------

    def _resume_cost(self, r, sched) -> float:
        """Modeled ticks to bring ``r`` back after eviction."""
        if sched is None:
            return 1.0
        al = sched.allocator
        pages = al.owned(r.rid)
        if al.spill_pages > 0 and al.spill_slots_free >= pages:
            # swap-out/swap-in: one drained restore pass; per-page copy
            # cost is small against a re-prefill
            return 1.0 + 0.125 * pages
        # recompute: re-prefill the materialised prompt in chunks, then
        # replay every already-generated token through decode
        chunks = math.ceil(min(r.computed, r.prompt_len)
                           / max(sched.chunk, 1))
        return 1.0 + chunks + len(r.out_tokens)

    def _harm(self, r, now, sched) -> float:
        resume = self._resume_cost(r, sched)
        if r.first_token_at < 0:
            # pre-first-token: eviction lands squarely on TTFT
            if r.slo_ttft is None:
                return resume * self.NO_SLO_URGENCY
            slack = (r.arrival + r.slo_ttft) - now
        else:
            # decoding: eviction stalls the token stream, harming TPOT
            if r.slo_tpot is None:
                return resume * self.NO_SLO_URGENCY
            remaining = max(r.max_new_tokens - len(r.out_tokens), 1)
            gaps = max(len(r.out_tokens) - 1, 0) + remaining
            # ticks of stall absorbable before the finished request's
            # mean inter-token gap exceeds its TPOT deadline
            slack = (r.slo_tpot * gaps
                     - (now - r.first_token_at) - remaining)
        if slack <= 0:
            return resume * self.LOST_URGENCY
        return resume * (1.0 + resume / slack)

    def choose_victim(self, running, requester, now, sched=None):
        cands = [r for r in running if r is not requester]
        if not cands:
            return None
        # min harm; ties broken youngest-first (FIFO-like churn order)
        victim = min(cands,
                     key=lambda r: (self._harm(r, now, sched),
                                    -r.admission_seq))
        if self._harm(victim, now, sched) < self._harm(requester, now,
                                                       sched):
            return victim
        return None


POLICIES = {
    "fifo": FifoPolicy,
    "priority": PriorityPolicy,
    "slo_fair": SloFairPolicy,
}


def make_policy(policy) -> SchedPolicy:
    """Resolve a policy spec: an instance passes through, a name
    constructs from :data:`POLICIES`."""
    if isinstance(policy, SchedPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {policy!r}: "
            f"expected one of {sorted(POLICIES)} or a SchedPolicy "
            "instance") from None
